"""Time the fused forward-mode flash attention (K9) under ``torch.func.jvp``.

Counterpart of the JAX repository's scripts/fa_jvp_tpu.py: ``torch.func.jvp``
of ``flash_attention_fwdmode`` at B1 S8320 H16 D128 in bf16 (the primal by
K1, the tangent by K9, ops/flash_attention_jvp.py), the primal and tangent
of a slice (1,664 tokens, 2 heads) checked against the plain version in
fp32, then 20 timed calls.

    python -m cosmos_predict2_tpu_torch.scripts.fa_jvp [--seq 8320] [--heads 16] [--iters 20] [--device cuda]

Runs on the card unless ``--device cpu`` is given; there the op takes its
plain version (use a small ``--seq`` and ``--heads``) and the times are the
host's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_fwdmode, flash_attention_jvp_plain

CHECK_TOKENS, CHECK_HEADS = 1664, 2


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: str = "cuda", seq: int = 8320, heads: int = 16, iters: int = 20, seed: int = 0) -> dict:
    """One jvp call, one on the checked slice and ``iters`` timed calls;
    returns the slice's errors (max-abs and relative L2), the mean ms per
    call and the rate over K9's 12 B H S^2 D FLOPs."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dq, dk, dv = (torch.randn((1, seq, heads, 128), generator=gen, device=device).to(torch.bfloat16)
                           for _ in range(6))
    fn = lambda: torch.func.jvp(flash_attention_fwdmode, (q, k, v), (dq, dk, dv))  # noqa: E731
    o, do = fn()
    _sync(device)
    if not (torch.isfinite(o.float()).all() and torch.isfinite(do.float()).all()):
        raise AssertionError("fa_jvp: non-finite output")

    # a slice against the plain version in fp32 (of the same bf16 values)
    sl = [t[:, :CHECK_TOKENS, :CHECK_HEADS].contiguous() for t in (q, k, v, dq, dk, dv)]
    got_o, got_do = torch.func.jvp(flash_attention_fwdmode, tuple(sl[:3]), tuple(sl[3:]))
    want_o, want_do = flash_attention_jvp_plain(*(t.float() for t in sl))
    o_err = float((got_o.float() - want_o).abs().max())
    do_err = float((got_do.float() - want_do).abs().max())
    o_rel = float((got_o.float() - want_o).norm() / want_o.norm())
    do_rel = float((got_do.float() - want_do).norm() / want_do.norm())

    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / iters
        name = torch.cuda.get_device_name(device)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        name = "cpu"
    flops = 12 * heads * seq * seq * 128
    result = {"device": name, "seq": seq, "heads": heads, "o_err": o_err, "do_err": do_err, "o_rel_l2": o_rel,
              "do_rel_l2": do_rel, "ms": ms, "tflops": flops / (ms * 1e-3) / 1e12}
    print(f"[fa_jvp] slice of {sl[0].shape[1]} tokens x {sl[0].shape[2]} heads vs the fp32 plain version: o max-abs "
          f"{o_err:.3e} rel_l2 {o_rel:.3e}, do max-abs {do_err:.3e} rel_l2 {do_rel:.3e}; jvp (K1 + K9) B1 S{seq} "
          f"H{heads} on {name}: {ms:.3f} ms ({result['tflops']:.1f} TFLOP/s over K9's 12 B H S^2 D)", flush=True)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=8320)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.device, args.seq, args.heads, args.iters)


if __name__ == "__main__":
    main()
