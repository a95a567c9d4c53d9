"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers and the result's ``breakdown`` take.

The kernel families are chip_smoke.py's classifier, copied: each device
kernel is named by the first key its lower-cased name contains.
"""

from __future__ import annotations

FAMILIES = (
    ("flash_kv_cache_window_kernel", "K6 cache decode, window"),
    ("flash_kv_cache_kernel", "K5 cache decode"),
    ("kv_cache_combine_kernel", "K5/K6 split combine"),
    ("na_fwd_kernel", "K10 NA forward"), ("na_bwd_dq_kernel", "K11 NA dQ"), ("na_bwd_dkv_kernel", "K12 NA dK/dV"),
    ("flash_attention_fwd_kernel", "K1 flash attention forward"),
    ("flash_attention_jvp_kernel", "K9 forward mode"),
    ("flash_attention_bwd_dq", "K7 flash attention dQ"),
    ("flash_attention_bwd_dkv", "K8 flash attention dK/dV"),
    ("conv3d_causal", "K2 causal conv"),
    ("nccl", "NCCL collectives"),
    ("nvjet", "GEMM (cuBLAS)"), ("gemm", "GEMM (cuBLAS)"), ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"),
    ("multi_tensor_apply", "foreach (AdamW)"),
    ("memcpy", "memcpy / memset"), ("memset", "memcpy / memset"),
    ("reduce", "reductions"), ("copy", "copies and casts"), ("elementwise", "elementwise"),
)
# PyTorch's own pointwise chain: what pointwise_ms reads
POINTWISE = ("elementwise", "copies and casts", "reductions")


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def reduce(prof) -> dict:
    """Device seconds by family, the busy seconds (the union of kernel
    intervals of each device the trace holds, averaged over those devices;
    ``devices`` says how many), the device ops that took most time and the
    longest gaps in which no traced device ran a kernel, each named by the
    innermost host op running across its middle. Reads the profiler's raw
    events (no event tree is built)."""
    import numpy as np
    import torch

    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        span = (e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((span, e.name(), e.device_index()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((span, e.name()))
    families: dict[str, float] = {}
    for (a, b), name, _ in kernels:
        fam = family(name)
        families[fam] = families.get(fam, 0.0) + (b - a)
    devices = sorted({d for _, _, d in kernels})
    per_device = [sum(b - a for a, b in _merge([s for s, _, dd in kernels if dd == d])) for d in devices]
    busy = _merge([span for span, _, _ in kernels])
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:10]
    starts = np.array([a for (a, _), _ in host])
    ends = np.array([b for (_, b), _ in host])
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        covering = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = host[covering[np.argmin(ends[covering] - starts[covering])]][1] if covering.size else "no host op"
        idle.append([name, length])
    return {
        "families": families,
        "busy_s": sum(per_device) / max(len(devices), 1),
        "devices": len(devices),
        "device_ops": [[f, s] for f, s in sorted(families.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": idle,
    }
