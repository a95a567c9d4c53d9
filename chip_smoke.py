#!/usr/bin/env python3
"""Drive the PyTorch port's Video2World serving and training paths (dense, sparse, DMD2), its streaming and forward-mode paths, once on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed with its wall time:

1. environment: refuses to run without CUDA; prints the card's name and
   power limit (nvidia-smi) and the torch, CUDA and nvcc versions;
2. build: compiles the hand-written kernels (cosmos_predict2_tpu_torch/csrc)
   with nvcc for sm_90a; prints the registers, shared memory and spills of
   the warp-specialised kernels (K2 at each of its wgmma widths, K1, K5,
   K6, K7, K8, K9, K10, K11, K12 and the second passes of K5/K6 and K8)
   from ptxas's report and fails on a spill or on a launch register count
   other than the one their setmaxnreg budget balances at (168);
3. kernels: each kernel against its plain PyTorch version (fp32, TF32 off)
   on bf16 inputs at the main paths' shapes, with max-abs and relative-L2
   error, a second call that must give the same bits (K1, K2, K5-K12),
   CUDA-event times, the card's bound for the same work (for
   K10-K12 also the pairs their walk computes, the time those take at the
   bf16 peak and the kernel's rate on them; for K2 its plan, rate and share
   of the bf16 peak at each stage of the smoke geometry's VAE and the 720p
   decoder's shapes) and, as a yardstick the port
   never calls, one PyTorch call computing the same
   function (scaled_dot_product_attention forward / backward, conv3d;
   K7 + K8 against SDPA's backward, which computes dq, dk and dv in one
   call, at self- and cross-attention, a frame group, 720p and ragged tails
   on K8's split route, each called twice to show the bits repeat;
   for neighborhood attention SDPA with the boolean window mask, or
   flex_attention with a block mask from the same predicate at 720p);
   K10, K11 and K12 at the sparse config's window at the smoke geometry, at
   720p, at 480p (padded) and on a dilated 720p layer; K5 and K6 (the cache
   decode, dense and row-windowed) at the interactive path's 352x640 block
   at full and early fill, with 2-frame blocks, at 720p and on a prime row
   count (23 x 40), K5 also with NaN past the fill and with its split-KV
   plan's splits printed, with SDPA over the filled cache (K6: with the
   boolean window mask) as the yardstick; K9 (fused forward mode) at B1 S8320 and
   S5760 H16, on a kv tail with frame_group 256 and with dv-only tangents,
   against its plain version by heads, beside K1 at the same shape and
   torch.func.jvp of SDPA (the first backend that takes it);
4a. forward mode: flash_attention_fwdmode under torch.func.jvp and under
   forward_ad at B1 S5760 H16 launches one K1 and one K9 each and matches
   the plain version; scripts/fa_jvp.py's run at B1 S8320 H16;
4. small reference: a narrow pipeline (2 blocks, VAE dim 64), dense and
   with a sparse block, and with the distilled dmd2 sampler (4 steps), on
   the card against the same weights run in fp32 on the CPU through the
   plain versions;
5. serving slice: the full-width 2B DiT and full-width Wan2.1 VAE on seeded
   random weights serve a Text2World, an Image2World and a Video2World
   request (93 frames at 192x320, 35 UniPC steps, CFG guidance 7) through
   Video2WorldInference; checks the outputs and that K1 ran 2 x 28 times per
   DiT forward and K2 ran; then profiles one batched-CFG DiT forward and
   one streaming VAE encode and decode of a request's clip;
   the same for one Video2World request on the sparse 2B DiT
   (predict2_video2world_2b_sparse: 7 dense blocks, 21 neighborhood
   attention), with K1 35 and K10 21 times per DiT forward; then one dmd2
   request through the Inference API on the 2B DMD2 student (image input,
   4 TrigFlow steps at batch 1, no CFG): exactly 224 K1 and K2, no K9;
6. small training reference: one training step of a narrow DiT (2 blocks,
   dense and with a sparse block), and a DMD2 student step and critic step
   of narrow nets, in bf16 on the card against the same weights and draws
   in fp32 on the CPU: losses and gradients;
7. training slice: training/train.py's ``launch`` trains the full-width 2B
   DiT (93 frames at 192x320, 2B text width, batch 1, EMA on) for one
   warm-up step, a few timed steps and one step under torch.profiler
   (device time by kernel) on mock data encoded by the VAE; checks finite
   losses, a finite gradient on every parameter at step 1, that parameters
   and EMA moved, and the launches per step (K1 4 x 28, K7 and K8 2 x 28)
   and K2 in the data phase; then the sparse 2B DiT for one warm-up, two
   timed and one profiled step, with K1 70, K10 42, K7 35, K8 35, K11 21
   and K12 21 launches per step; then DMD2 distillation of the 2B student
   (training/distill_trainer.py: student, frozen teacher and fake-score
   nets in fp32, 93 frames at 192x320, batch 1, block remat, 4 critic
   steps and 1 student step): finite losses, each phase changes only its
   net, K1 56 n + 112 (critic) or 56 n + 168 (student) with K7 and K8 56
   per step for the drawn n sampler steps, no K9; step times and peak
   memory;
8. small interactive reference: a narrow causal DiT (2 blocks) streams in
   bf16 on the card through K5 and then K6 against the same weights, inputs
   and noise in fp32 on the CPU through the plain versions;
9. interactive slice: the full-width causal 2B DiT (built as
   scripts/interactive_latency.py builds it, seeded random weights) streams
   20 blocks of one latent frame at 352x640 after one prefilled frame
   (cache 16 + 1 frames, 4 steps, the window slides 5 times) through
   StreamingInference.generate, dense (K5) and with 7 of 22 rows (K6);
   checks the outputs, the cache length after every block, the exact
   launches (28 + 2,800 K5 or K6 and as many K1) and that the peak memory
   holds one copy of the cache; profiles one steady-state block step; runs
   the script's ``measure`` once for its result line.

Then it prints the kernels' JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Relative L2 error allowed between a kernel and its plain version: bf16
# inputs and a bf16 output (one rounding, ~4e-3 relative), fp32 sums taken
# in another order.
KERNEL_REL_L2 = 1e-2
# Relative L2 error allowed between the small pipeline in bf16 on the card
# and in fp32 on the CPU: bf16 rounding through 2 DiT blocks, 2 UniPC steps
# and the VAE gives 0.026 on the CPU (bf16 vs fp32, same weights); 3x margin.
PIPELINE_REL_L2 = 8e-2
# The small training step in bf16 on the card against fp32 on the CPU. On
# the CPU, bf16 against fp32 (same weights, 4 draws) gives a loss within
# 5.8e-4 relative, all gradients within 6.0e-3 relative L2 together and
# every parameter's within 1.3e-2; about 3x margin on each.
TRAIN_LOSS_REL = 2e-3
TRAIN_GRAD_REL_L2 = 2e-2
TRAIN_GRAD_TENSOR_REL_L2 = 4e-2
# The small causal stream in bf16 on the card against fp32 on the CPU. On the
# CPU, bf16 against fp32 (same weights, inputs and noise; 5 blocks of 4 steps
# with the loop's bf16 caches on both sides) gives a relative L2 of 3.35e-3
# dense and 3.39e-3 with the window; about 3x margin.
STREAM_REL_L2 = 1e-2
NUM_BLOCKS = 28
SIZE = (192, 320)
NUM_FRAMES = 93
NUM_STEPS = 35
GUIDANCE = 7.0
TRAIN_TIMED_STEPS = 3  # after one warm-up step; one more step runs under torch.profiler
SPARSE_TRAIN_TIMED_STEPS = 2
DENSE_EXPERIMENT = "predict2_video2world_2b_rectified_flow"
SPARSE_EXPERIMENT = "predict2_video2world_2b_sparse"
DMD2_EXPERIMENT = "dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional"
DISTILL_ITERS = 5  # student_update_freq 5: 4 critic steps, then 1 student step
DISTILL_PROFILE_STEP = 3  # the third iteration (a critic step) runs under torch.profiler
# what the phases write (an input image, a text embedding, the dmd2 video): inside the checkout, git-ignored
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"
# the geometry the sparse config's window is tuned at (its natten_base_size)
NA_BASE = (-1, 44, 80)
# the interactive slice: 352x640 (latent 44 x 80, 22 x 40 tokens), a cache of
# 16 frames plus the block, 4 steps, one prefilled frame, 20 streamed blocks;
# the row window of the K6 run: 7 of 22 rows
INTERACTIVE_HW = (44, 80)
INTERACTIVE_CACHE_FRAMES = 16
INTERACTIVE_STEPS = 4
INTERACTIVE_BLOCKS = 20
INTERACTIVE_WINDOW = 7
# published dense peaks of one H100 SXM at 700 W, for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def errors(out, ref) -> tuple[float, float]:
    d = out.float() - ref.float()
    return float(d.abs().max()), float(d.norm() / ref.float().norm().clamp_min(1e-30))


def cuda_ms(fn, warmup: int = 1, iters: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def yardstick_ms(fn, warmup: int = 1, iters: int = 3):
    """cuda_ms of a library call that is only a yardstick: when it cannot run
    (out of memory, no kernel for the case), the reason instead of a time."""
    import torch

    try:
        return cuda_ms(fn, warmup, iters)
    except Exception as e:
        torch.cuda.empty_cache()
        return f"none: {type(e).__name__}: {str(e).strip().splitlines()[0][:100]}"


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    at the bf16 tensor-core peak and the bytes at the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def visible_pairs(sq: int, skv: int, frame_group: int) -> int:
    """(query, key) pairs the mask leaves visible: the work the data needs."""
    if frame_group <= 0:
        return sq * skv
    return int(np.minimum(skv, (np.arange(sq) // frame_group + 1) * frame_group).sum())


def environment() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    from cosmos_predict2_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True).stdout.strip().splitlines()
    log(f"gpu: {smi}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  nvcc: {nvcc[-1] if nvcc else '?'}")
    return smi


# the warp-specialised kernels: setmaxnreg moves the producer warpgroup to
# 24 registers and the two consumer warpgroups to 240, which balances only
# if the 384-thread CTA starts at 168 (else the consumers wait forever)
SETMAXNREG_LAUNCH_REGISTERS = 168


def kernel_resources() -> dict:
    """The warp-specialised kernels' registers, shared memory and spills from
    the build's ptxas report (build/cosmos_torch_kernels/build.log); fails
    on a spill or on a setmaxnreg kernel not at 168 registers at launch."""
    from cosmos_predict2_tpu_torch import _build

    from cosmos_predict2_tpu_torch.ops.conv3d import WIDTHS

    report, lib = _build.ptxas_report(), _build.library()
    fwd_smem = lib.cosmos_flash_attention_fwd_smem_bytes(0)
    # K2: one instantiation per wgmma width
    conv = [(f"K2 n{n}", f"conv3d_causal_kernelILi{n}E", lib.cosmos_conv3d_causal_smem_bytes(n), True) for n in WIDTHS]
    out = {}
    for label, key, dynamic, setmaxnreg in (
        *conv,
        ("K1", "flash_attention_fwd_kernel", fwd_smem, True),
        ("K5", "flash_kv_cache_kernel", fwd_smem, True),
        ("K6", "flash_kv_cache_window_kernel", lib.cosmos_flash_attention_fwd_smem_bytes(1), True),
        ("K5/K6 combine of split partials", "kv_cache_combine_kernel", 0, False),
        ("K7", "flash_attention_bwd_dq_kernel", lib.cosmos_flash_attention_bwd_smem_bytes(0), True),
        ("K8", "flash_attention_bwd_dkv_kernel", lib.cosmos_flash_attention_bwd_smem_bytes(1), True),
        ("K8 sum of split partials", "flash_attention_bwd_dkv_reduce_kernel", 0, False),
        ("K9", "flash_attention_jvp_kernel", lib.cosmos_flash_attention_jvp_smem_bytes(), True),
        ("K10", "na_fwd_kernel", lib.cosmos_na_smem_bytes(0), True),
        ("K11", "na_bwd_dq_kernel", lib.cosmos_na_smem_bytes(2), True),
        ("K12", "na_bwd_dkv_kernel", lib.cosmos_na_smem_bytes(1), True),
    ):
        found = [v for name, v in report.items() if key in name]
        if len(found) != 1:
            raise AssertionError(f"ptxas report: {len(found)} entries for {key}")
        r = dict(found[0], dynamic_smem_bytes=dynamic)
        log(f"  {label:30s} {r.get('registers')} registers a thread at launch, {r.get('smem_bytes', 0)} bytes static and "
            f"{dynamic} bytes dynamic shared memory, stack {r.get('stack_bytes')} bytes, spill stores "
            f"{r.get('spill_stores')} loads {r.get('spill_loads')} bytes")
        if r.get("spill_stores") or r.get("spill_loads"):
            raise AssertionError(f"{label} ({key}) spills registers: {r}")
        if setmaxnreg and r.get("registers") != SETMAXNREG_LAUNCH_REGISTERS:
            raise AssertionError(f"{label} ({key}) starts at {r.get('registers')} registers, not "
                                 f"{SETMAXNREG_LAUNCH_REGISTERS}: its setmaxnreg budget would not balance")
        out[label] = r
    # ptxas's performance advisories (for example wgmma products it had to serialise)
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Performance Loss" in line:
            log(f"  ptxas: {line.strip()}")
    return out


def check_kernels(results: dict) -> None:
    import torch

    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv3d_causal_plain, conv_plan, conv_weight_taps
    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        attention_delta,
        dkv_split_plan,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def fmt(x):
        return x if isinstance(x, str) else "-" if x is None else f"{x:9.3f} ms"

    def record(kernel, label, max_abs, rel, ms, plain_ms, library_ms, bnd, **extra):
        ok = rel <= KERNEL_REL_L2
        log(f"  {kernel:24s} {label:44s} max_abs {max_abs:.3e} rel_l2 {rel:.3e} kernel {ms:9.3f} ms "
            f"plain {fmt(plain_ms)} library {fmt(library_ms)} bound {bnd[0]:.3f} ms ({bnd[1]}) "
            f"{'ok' if ok else 'FAIL'}" + "".join(f" {k} {v}" for k, v in extra.items()))
        entry = results.setdefault(kernel, {"max_abs_err": 0.0, "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        entry["cases"].append({"case": label, "max_abs": max_abs, "rel_l2": rel, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms, "bound_ms": bnd[0], "bound_by": bnd[1], **extra})
        if not ok:
            failures.append(f"{kernel} {label}: rel_l2 {rel:.3e} > {KERNEL_REL_L2}")

    def sdpa_mask(Sq, Skv, fg):
        if fg <= 0:
            return None
        return (torch.arange(Skv, device=dev)[None, :] // fg) <= (torch.arange(Sq, device=dev)[:, None] // fg)

    # ---- K1: flash attention forward ----
    # (label, B, Sq, Skv, H, frame_group, query rows held against the plain version)
    attn_cases = [
        ("self  B2 S5760 H16 (smoke geometry)", 2, 5760, 5760, 16, 0, None),
        ("cross B2 Sq5760 Skv512 H16", 2, 5760, 512, 16, 0, None),
        ("self  B1 S5760 H16 frame_group=240", 1, 5760, 5760, 16, 240, None),
        ("self  B2 S84480 H16 (720p, 1024 rows)", 2, 84480, 84480, 16, 0, 1024),
        ("cross B2 Sq84480 Skv512 H16 (720p, 1024 rows)", 2, 84480, 512, 16, 0, 1024),
    ]
    for label, B, Sq, Skv, H, fg, rows in attn_cases:
        q = torch.randn((B, Sq, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Skv, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Skv, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, frame_group=fg)
        # no atomics: a second call gives the same bits
        repeat = flash_attention_fwd(q, k, v, frame_group=fg)
        torch.cuda.synchronize()
        if not (torch.equal(out, repeat[0]) and torch.equal(lse, repeat[1])):
            failures.append(f"flash_attention_fwd {label}: two calls differ")
        del repeat
        if not bool(torch.isfinite(out.float()).all()):
            failures.append(f"flash_attention_fwd {label}: non-finite output")
        if rows is None:
            ref, ref_lse = flash_attention_plain(q, k, v, fg)
            got, got_lse = out, lse
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, fg))
        else:
            # the plain version would need B*H*Sq*Skv fp32 logits (~0.9 TB);
            # hold rows spread over the sequence (incl. the ragged last tile)
            idx = torch.linspace(0, Sq - 1, rows, device=dev).round().long()
            qs = q[:, idx].contiguous()
            ref, ref_lse = flash_attention_plain(qs, k, v, 0)
            got, got_lse = out[:, idx], lse[:, :, idx]
            plain_ms = f"{cuda_ms(lambda: flash_attention_plain(qs, k, v, 0), 0, 1):.3f} ms for {rows} rows"
        max_abs, rel = errors(got, ref)
        lse_abs, _ = errors(got_lse, ref_lse)
        log(f"  {'':24s} lse max_abs {lse_abs:.3e}")
        if not lse_abs < 1e-2:
            failures.append(f"flash_attention_fwd {label}: lse max_abs {lse_abs:.3e}")
        del ref, ref_lse, got, got_lse
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, frame_group=fg))
        qt, kt, vt, mask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), sdpa_mask(Sq, Skv, fg)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
        bnd = bound(4 * B * H * visible_pairs(Sq, Skv, fg) * 128, nbytes)
        record("flash_attention_fwd", label, max_abs, rel, ms, plain_ms, library_ms, bnd)
        del q, k, v, out, lse, qt, kt, vt, mask
        torch.cuda.empty_cache()

    # ---- K7 (dQ) and K8 (dK, dV): flash attention backward, batch 1 as in training ----
    # (label, Sq, Skv, frame_group, query rows held against the plain version)
    bwd_cases = [
        ("self  B1 S5760 H16 (smoke geometry)", 5760, 5760, 0, None),
        ("cross B1 Sq5760 Skv512 H16", 5760, 512, 0, None),
        ("self  B1 S5760 H16 frame_group=240", 5760, 5760, 240, None),
        ("self  B1 S84480 H16 (720p, dQ on 1024 rows)", 84480, 84480, 0, 1024),
        ("tail  B1 Sq5800 Skv333 H16 (ragged tiles, K8 split)", 5800, 333, 0, None),
    ]
    B, H = 1, 16
    for label, Sq, Skv, fg, rows in bwd_cases:
        q, do = (torch.randn((B, Sq, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Skv, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        out, lse = flash_attention_fwd(q, k, v, frame_group=fg)
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, fg)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, fg)
        # no atomics: a second call gives the same bits
        repeat = (flash_attention_bwd_dq(q, k, v, do, lse, delta, fg), *flash_attention_bwd_dkv(q, k, v, do, lse, delta, fg))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), repeat)):
            failures.append(f"flash attention backward {label}: two calls differ")
        del repeat
        if rows is None:
            ref = flash_attention_bwd_plain(q, k, v, out, lse, do, fg)
            errs = [errors(g, r) for g, r in zip((dq, dk, dv), ref)]
            plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, fg), 0, 1)
            del ref
        else:
            # dQ of a row needs only that row's q, dO, out and lse: hold
            # rows spread over the sequence; dK/dV are timed only
            idx = torch.linspace(0, Sq - 1, rows, device=dev).round().long()
            sub = lambda t: t[:, idx].contiguous()
            ref_dq = flash_attention_bwd_plain(sub(q), k, v, sub(out), lse[:, :, idx].contiguous(), sub(do), 0)[0]
            errs = [errors(dq[:, idx], ref_dq)]
            plain_ms = "not measurable whole (logits of 0.46 TB)"
            del ref_dq
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
        if not finite:
            failures.append(f"flash attention backward {label}: non-finite gradients")
        ms_dq = cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, fg), 1, 3 if rows is None else 1)
        ms_dkv = cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, fg), 1, 3 if rows is None else 1)
        # yardstick: scaled_dot_product_attention's autograd backward (dq, dk, dv in one call)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        sd_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask(Sq, Skv, fg))
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(sd_out, leaves, dot, retain_graph=True), 1,
                             3 if rows is None else 1)
        del leaves, sd_out, dot
        pairs = visible_pairs(Sq, Skv, fg)
        io = 2 * q.numel() + 2 * do.numel() + 2 * k.numel() + 2 * v.numel() + 4 * lse.numel() + 4 * delta.numel()
        bnd_dq = bound(6 * B * H * pairs * 128, io + 2 * q.numel())
        bnd_dkv = bound(8 * B * H * pairs * 128, io + 2 * k.numel() + 2 * v.numel())
        # K7 + K8 against SDPA's backward, which computes dq, dk and dv in one call
        ratio = (ms_dq + ms_dkv) / library_ms
        splits = dkv_split_plan(Sq, Skv, H, B, fg, torch.cuda.get_device_properties(dev).multi_processor_count).splits
        record("flash_attention_bwd_dq", label, *errs[0], ms_dq, plain_ms, library_ms, bnd_dq, pair_over_library=ratio)
        if rows is None:
            dk_err = max(errs[1][0], errs[2][0]), max(errs[1][1], errs[2][1])
            record("flash_attention_bwd_dkv", label, *dk_err, ms_dkv, plain_ms, library_ms, bnd_dkv, splits=splits)
        else:
            log(f"  {'flash_attention_bwd_dkv':24s} {label:44s} timed only: kernel {ms_dkv:9.3f} ms "
                f"library (dq+dk+dv) {library_ms:9.3f} ms bound {bnd_dkv[0]:.3f} ms ({bnd_dkv[1]})")
            results["flash_attention_bwd_dkv"]["cases"].append(
                {"case": label, "ms": ms_dkv, "library_ms": library_ms, "bound_ms": bnd_dkv[0], "bound_by": bnd_dkv[1],
                 "splits": splits})
        log(f"  {'K7 + K8':24s} {label:44s} {ms_dq + ms_dkv:9.3f} ms against SDPA's backward {library_ms:9.3f} ms: "
            f"{ratio:.2f}x (K8 splits {splits})")
        del q, k, v, do, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()

    # ---- K2: causal 3x3x3 conv ----
    # (label, T_out, H, W, Cin, Cout): one case per stage of the smoke
    # geometry's streaming encode (4-frame chunks) and decode (2-latent-frame
    # chunks), then the 720p decoder shapes
    conv_cases = [
        ("enc T4 192x320 96->96 (smoke)", 4, 192, 320, 96, 96),
        ("enc T4 96x160 96->192 (smoke)", 4, 96, 160, 96, 192),
        ("enc T2 48x80 192->384 (smoke)", 2, 48, 80, 192, 384),
        ("enc T1 24x40 384->384 (smoke)", 1, 24, 40, 384, 384),
        ("dec T2 24x40 384->384 (smoke)", 2, 24, 40, 384, 384),
        ("dec T4 48x80 192->384 (smoke)", 4, 48, 80, 192, 384),
        ("dec T8 96x160 192->192 (smoke)", 8, 96, 160, 192, 192),
        ("dec T8 192x320 96->96 (smoke)", 8, 192, 320, 96, 96),
        ("dec T2 176x320 384->384 (720p)", 2, 176, 320, 384, 384),
        ("dec T4 352x640 192->192 (720p)", 4, 352, 640, 192, 192),
        ("dec T4 704x1280 96->96 (720p)", 4, 704, 1280, 96, 96),
    ]
    for label, T, H, W, cin, cout in conv_cases:
        x = torch.randn((1, T + 2, H, W, cin), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5).to(torch.bfloat16)
        b = torch.randn((cout,), generator=gen, device=dev)
        w_taps = conv_weight_taps(w)  # made once per conv, as the streaming VAE keeps it
        out = conv3d_causal(x, w, b, w_taps=w_taps)
        # no atomics: a second call gives the same bits
        if not torch.equal(out, conv3d_causal(x, w, b, w_taps=w_taps)):
            failures.append(f"conv3d_causal {label}: two calls differ")
        torch.cuda.synchronize()
        ref = conv3d_causal_plain(x, w, b, out_dtype=torch.float32)
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: conv3d_causal(x, w, b, w_taps=w_taps))
        plain_ms = cuda_ms(lambda: conv3d_causal_plain(x, w, b))
        # yardstick: cuDNN's conv3d on the same causally padded input (NDHWC
        # viewed as channels-last NCDHW), spatial zero padding 1
        xc, wc, bc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous(), b.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: F.conv3d(xc, wc, bc, padding=(0, 1, 1)))
        flops = 2 * T * H * W * 27 * cin * cout
        bnd = bound(flops, 2 * x.numel() + 2 * w.numel() + 4 * b.numel() + 2 * out.numel())
        plan = conv_plan(H, W, cin, cout)
        record("conv3d_causal", label, max_abs, rel, ms, plain_ms, library_ms, bnd,
               tflops=round(flops / ms / 1e9, 1), share_of_peak=round(flops / ms / 1e9 / PEAK_BF16_FLOPS * 1e12, 3),
               plan=f"{plan.box_h}x{plan.box_w} n{plan.n}x{plan.n_split}")
        del x, w, w_taps, b, out, ref, xc, wc, bc
        torch.cuda.empty_cache()

    check_na_kernels(gen, record, failures)
    check_cache_kernels(gen, record, failures)
    check_jvp_kernel(gen, record, failures)
    if failures:
        raise AssertionError("kernel checks failed:\n  " + "\n  ".join(failures))


def flex_yardstick(q, k, v, do, size, window, stride, dilation):
    """flex_attention with a block mask from the neighborhood predicate on
    token-major (B, H, S, D) tensors: (forward ms, backward ms), or the
    reason there is none."""
    import torch

    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import na_mask

    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        S = q.shape[2]
        block_mask = torch.compile(create_block_mask)(
            lambda b, h, qi, ki: na_mask(qi, ki, size, window, stride, dilation), None, None, S, S, device=q.device)
        flex = torch.compile(flex_attention)
        fwd_ms = cuda_ms(lambda: flex(q, k, v, block_mask=block_mask))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        # the compiled backward does not keep its graph for a second call: time
        # forward + backward and take the forward away
        both_ms = cuda_ms(lambda: torch.autograd.grad(flex(*leaves, block_mask=block_mask), leaves, do))
        return fwd_ms, both_ms - fwd_ms
    except Exception as e:  # a yardstick only: the reason goes into the row
        torch.cuda.empty_cache()
        reason = f"none: flex_attention did not run ({type(e).__name__}: {str(e).strip().splitlines()[0][:100]})"
        return reason, reason


def check_na_kernels(gen, record, failures) -> None:
    """K10, K11 and K12 against their plain versions on the tiled layout, 16
    heads, forward at the case's batch and backward at batch 1."""
    import torch
    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops import neighborhood_attention as na

    dev = torch.device("cuda")
    # (name, (T, H, W), window, stride, dilation, forward batch, library route):
    # the 2B sparse config's window adapted to the smoke geometry (batch 2 as
    # in batched CFG) and at 720p; the 480p grid (H and W padded to the
    # tiles; strides 3 and 5); layer 0 of the 14B comb02 list (dilated) at 720p
    cases = [
        ("smoke", (24, 12, 20), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 2, "sdpa"),
        ("720p", (24, 44, 80), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 1, "flex"),
        ("480p padded", (24, 30, 52), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 1, "sdpa"),
        ("720p comb02 dilated", (24, 44, 80), (-1, 4, 16), (1, 1, 1), (1, 11, 5), 1, "flex"),
    ]
    H = 16
    for name, grid, window, stride, dilation, bf, route in cases:
        size = na.VideoSize(*grid)
        w, s, d = na.adaptive_na_parameters(window, stride, grid, NA_BASE, dilation)
        ew, es = na.effective_params(size, w, s, d)
        plan = na.build_plan(size, ew, es, d)
        S = grid[0] * grid[1] * grid[2]
        label = f"{name} {grid[0]}x{grid[1]}x{grid[2]} w{w} s{s}" + (f" d{d}" if d != (1, 1, 1) else "")
        pairs = na.visible_pairs(size, ew)
        walked = na.walk_computed_pairs(plan)
        extra = {"visible_pairs": pairs, "s_pad": plan.s_pad}

        def on_computed(kernel, flops_per_pair, batch, ms):
            """The kernel's own work: the pairs its walk computes, the time they
            take at the bf16 peak, and the kernel's rate on them."""
            n = walked[kernel]
            flops = flops_per_pair * batch * H * n * 128
            return {"computed_pairs": n, "computed_at_peak_ms": round(flops / PEAK_BF16_FLOPS * 1e3, 3),
                    "tflops_on_computed": round(flops / ms / 1e9, 1)}
        real = na.permute_in(torch.ones((1, S, 1, 1), device=dev), plan)[0, 0, :, 0] > 0
        mask = None
        if route == "sdpa":
            idx = torch.arange(S, device=dev)
            mask = na.na_mask(idx[:, None], idx[None, :], size, w, s, d)

        # ---- K10 forward ----
        bshd = [torch.randn((bf, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
        q, k, v = (na.permute_in(x, plan) for x in bshd)
        out, lse = na.na_fwd(q, k, v, plan, ew, es)
        # no atomics: a second call gives the same bits
        repeat = na.na_fwd(q, k, v, plan, ew, es)
        torch.cuda.synchronize()
        if not (torch.equal(out, repeat[0]) and torch.equal(lse, repeat[1])):
            failures.append(f"na_fwd {label}: two calls differ")
        del repeat
        ref, ref_lse = na.na_fwd_plain(q, k, v, plan, ew, es)
        max_abs, rel = errors(out, ref)
        lse_abs, _ = errors(lse[:, :, real], ref_lse[:, :, real])
        log(f"  {'':24s} lse max_abs {lse_abs:.3e} (real rows); pad rows of out all zero: "
            f"{bool((out[:, :, ~real] == 0).all())}")
        if not lse_abs < 1e-2:
            failures.append(f"na_fwd {label}: lse max_abs {lse_abs:.3e}")
        del ref, ref_lse
        plain_ms = cuda_ms(lambda: na.na_fwd_plain(q, k, v, plan, ew, es), 0, 1)
        ms = cuda_ms(lambda: na.na_fwd(q, k, v, plan, ew, es))
        layout_ms = cuda_ms(lambda: ([na.permute_in(x, plan) for x in bshd], na.permute_out(out, plan)))
        qh, kh, vh = (x.transpose(1, 2) for x in bshd)
        if route == "sdpa":
            library_fwd = yardstick_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
        else:  # batch 1: the backward's yardstick comes from the same call
            doh = torch.randn(qh.shape, generator=gen, device=dev).to(torch.bfloat16)
            library_fwd, library_bwd = flex_yardstick(qh, kh, vh, doh, size, w, s, d)
            del doh
        # the bound's bytes count the S real tokens: pad slots of the tiled
        # layout are neither keys nor queries, and their zero rows are the
        # layout's own (s_pad beside the bound shows that overhead)
        nbytes = 2 * 4 * bf * H * S * 128 + 4 * bf * H * S
        record("na_fwd", label, max_abs, rel, ms, plain_ms, library_fwd, bound(4 * bf * H * pairs * 128, nbytes),
               layout_ms=round(layout_ms, 3), **extra, **on_computed("na_fwd", 4, bf, ms))
        del bshd, q, k, v, out, lse, qh, kh, vh
        torch.cuda.empty_cache()

        # ---- K11 dQ and K12 dK/dV, batch 1 ----
        bshd = [torch.randn((1, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4)]
        q, k, v, do = (na.permute_in(x, plan) for x in bshd)
        out, lse = na.na_fwd(q, k, v, plan, ew, es)
        delta = na.na_delta(out, do)
        dq = na.na_bwd_dq(q, k, v, do, lse, delta, plan, ew, es)
        dk, dv = na.na_bwd_dkv(q, k, v, do, lse, delta, plan, ew, es)
        repeat = (na.na_bwd_dq(q, k, v, do, lse, delta, plan, ew, es), *na.na_bwd_dkv(q, k, v, do, lse, delta, plan, ew, es))
        torch.cuda.synchronize()
        for name, got, again in (("na_bwd_dq", dq, repeat[0]), ("na_bwd_dkv", dk, repeat[1]), ("na_bwd_dkv", dv, repeat[2])):
            if not torch.equal(got, again):
                failures.append(f"{name} {label}: two calls differ")
        del repeat
        ref = na.na_bwd_plain(q, k, v, out, lse, do, plan, ew, es)
        errs = [errors(g, r) for g, r in zip((dq, dk, dv), ref)]
        del ref
        if not all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv)):
            failures.append(f"neighborhood attention backward {label}: non-finite gradients")
        plain_ms = cuda_ms(lambda: na.na_bwd_plain(q, k, v, out, lse, do, plan, ew, es), 0, 1)
        ms_dq = cuda_ms(lambda: na.na_bwd_dq(q, k, v, do, lse, delta, plan, ew, es))
        ms_dkv = cuda_ms(lambda: na.na_bwd_dkv(q, k, v, do, lse, delta, plan, ew, es))
        if route == "sdpa":
            # yardstick: scaled_dot_product_attention's autograd backward with the mask (dq, dk, dv in one call)
            leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in bshd[:3]]
            dot = bshd[3].transpose(1, 2)
            library_bwd = library_fwd  # the reason, where the forward did not run
            if isinstance(library_fwd, float):
                sd_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
                library_bwd = yardstick_ms(lambda: torch.autograd.grad(sd_out, leaves, dot, retain_graph=True))
                del sd_out
            del leaves, dot
        # q, k, v and dO read, lse and delta read, over the S real tokens
        grad_bytes = 2 * H * S * 128
        io = 4 * grad_bytes + 2 * 4 * H * S
        record("na_bwd_dq", label, *errs[0], ms_dq, plain_ms, library_bwd, bound(6 * H * pairs * 128, io + grad_bytes),
               **extra, **on_computed("na_bwd_dq", 6, 1, ms_dq))
        dkv_err = max(errs[1][0], errs[2][0]), max(errs[1][1], errs[2][1])
        record("na_bwd_dkv", label, *dkv_err, ms_dkv, plain_ms, library_bwd,
               bound(8 * H * pairs * 128, io + 2 * grad_bytes), **extra, **on_computed("na_bwd_dkv", 8, 1, ms_dkv))
        del bshd, q, k, v, do, out, lse, delta, dq, dk, dv, mask
        torch.cuda.empty_cache()


def check_cache_kernels(gen, record, failures) -> None:
    """K5 and K6 against their plain versions at the interactive path's
    shapes: batch 1, 16 heads, q one block of whole frames, head-major
    buffers with +-1e3 past the fill (it must not reach the output); K5
    once more with NaN past the fill, which a mask alone does not keep out
    (0 x NaN is NaN)."""
    import torch
    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        flash_attention_kv_cache,
        flash_attention_kv_cache_window,
        kv_cache_plain,
        kv_cache_split_plan,
        kv_cache_window_plain,
        kv_window_split_plan,
        window_rows_bounds,
        window_walk_pairs,
    )

    dev = torch.device("cuda")
    H = 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # (name, token grid gh x gw, frames per block, filled frames, buffer frames, window rows; None: K5 only)
    cases = [
        ("352x640 steady", 22, 40, 1, 17, 17, INTERACTIVE_WINDOW),
        ("352x640 early", 22, 40, 1, 4, 17, INTERACTIVE_WINDOW),
        ("352x640 nb2", 22, 40, 2, 18, 18, INTERACTIVE_WINDOW),
        ("720p", 44, 80, 1, 9, 9, 2 * INTERACTIVE_WINDOW),
        ("prime gh 23x40", 23, 40, 1, 17, 17, INTERACTIVE_WINDOW),
        ("352x640 NaN past a ragged fill", 22, 40, 1, 12, 17, None),
    ]
    for name, gh, gw, nb, filled, frames, wh in cases:
        Fr = gh * gw
        Sq, fill = nb * Fr, filled * Fr
        if wh is None:
            fill -= 77  # the frontier inside a kv tile
        label = f"{name} Sq{Sq} fill {fill}"
        q = torch.randn((1, Sq, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        kb, vb = (torch.randn((1, H, frames * Fr, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        kb[:, :, fill:] = 1e3 if wh is not None else float("nan")
        vb[:, :, fill:] = -1e3 if wh is not None else float("nan")
        # each input read once (q and the filled cache), the output written once
        nbytes = 2 * 2 * q.numel() + 2 * 2 * H * fill * 128
        qh, kh, vh = q.transpose(1, 2), kb[:, :, :fill], vb[:, :, :fill]

        out = flash_attention_kv_cache(q, kb, vb, fill)
        repeat = flash_attention_kv_cache(q, kb, vb, fill)  # the split route's combine is in split order
        torch.cuda.synchronize()
        if not torch.equal(out, repeat):
            failures.append(f"flash_attention_kv_cache {label}: two calls differ")
        max_abs, rel = errors(out, kv_cache_plain(q, kb, vb, fill))
        if not bool(torch.isfinite(out.float()).all()):
            failures.append(f"flash_attention_kv_cache {label}: non-finite output")
        ms_k5 = cuda_ms(lambda: flash_attention_kv_cache(q, kb, vb, fill), 2, 10)
        plain_ms = cuda_ms(lambda: kv_cache_plain(q, kb, vb, fill), 0, 1)
        library_ms = yardstick_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 2, 10)
        record("flash_attention_kv_cache", label, max_abs, rel, ms_k5, plain_ms, library_ms,
               bound(4 * H * Sq * fill * 128, nbytes), splits=kv_cache_split_plan(Sq, fill, H, 1, sms).splits)
        del out, repeat
        if wh is None:
            del q, kb, vb, qh, kh, vh
            torch.cuda.empty_cache()
            continue

        label_w = f"{label} rows {min(wh, gh)}/{gh}"
        out = flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh)
        repeat = flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh)  # the split route's combine in order
        torch.cuda.synchronize()
        if not torch.equal(out, repeat):
            failures.append(f"flash_attention_kv_cache_window {label_w}: two calls differ")
        del repeat
        max_abs, rel = errors(out, kv_cache_window_plain(q, kb, vb, fill, (gh, gw), wh))
        if not bool(torch.isfinite(out.float()).all()):
            failures.append(f"flash_attention_kv_cache_window {label_w}: non-finite output")
        ms = cuda_ms(lambda: flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh), 2, 10)
        plain_ms = cuda_ms(lambda: kv_cache_window_plain(q, kb, vb, fill, (gh, gw), wh), 0, 1)
        lo, hi = window_rows_bounds(torch.arange(Sq, device=dev), (gh, gw), wh)
        yk = (torch.arange(fill, device=dev) % Fr) // gw
        mask = (yk[None, :] >= lo[:, None]) & (yk[None, :] < hi[:, None])
        library_ms = yardstick_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), 2, 10)
        pairs = window_walk_pairs(Sq, fill, (gh, gw), wh)  # per head: visible, loaded and computed by K6's walk
        record("flash_attention_kv_cache_window", label_w, max_abs, rel, ms, plain_ms, library_ms,
               bound(4 * H * pairs["visible"] * 128, nbytes), visible_pairs=pairs["visible"],
               loaded_pairs=pairs["loaded"], computed_pairs=pairs["computed"],
               splits=kv_window_split_plan(Sq, fill, (gh, gw), wh, H, 1, sms), k5_ms=round(ms_k5, 4),
               k5_computed_pairs=-(-Sq // 128) * 128 * -(-fill // 128) * 128)
        del q, kb, vb, qh, kh, vh, out, lo, hi, yk, mask
        torch.cuda.empty_cache()


# the narrow nets' sparse block: block 0 of 2 (n_dense_blocks=1 keeps block 1
# dense), window 3 x 3 with stride 2 along W on the small pipeline's 4 x 4 and
# the small training step's 8 x 12 token grid
SMALL_SPARSE = dict(n_dense_blocks=1, natten_window=(-1, 3, 3), natten_stride=(1, 1, 2), natten_base_size=None)


def small_reference(sparse: bool, sampler: str = "unipc") -> None:
    """A narrow pipeline on the card (bf16, kernels) against the same weights
    in fp32 on the CPU (plain versions): 2 UniPC steps, or the 4 steps of
    the distilled sampler with ``sampler="dmd2"``."""
    import torch

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference, image_to_input
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    from cosmos_predict2_tpu_torch import _build

    cfg = make_config(SPARSE_EXPERIMENT if sparse else DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(
        cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
        crossattn_proj_in_channels=64, crossattn_emb_channels=128, **(SMALL_SPARSE if sparse else {}),
    )
    mc = dataclasses.replace(cfg.model, net=net_cfg, state_t=3)
    vc = dataclasses.replace(cfg.tokenizer, dim=64)
    net = build_dit(net_cfg, "cuda", seed=10)
    vae = build_vae(vc, "cuda", seed=11)
    pipe = Video2WorldInference(InferenceSetup(model_config=mc, vae_config=vc, size_override=(64, 64)), net, vae)
    net32 = build_dit(dataclasses.replace(net_cfg, dtype=torch.float32), "cpu", seed=0)
    net32.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    vae32 = build_vae(dataclasses.replace(vc, dtype=torch.float32), "cpu", seed=0)
    vae32.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    pipe32 = Video2WorldInference(
        InferenceSetup(model_config=dataclasses.replace(mc, net=net32.cfg), vae_config=vae32.config, size_override=(64, 64)),
        net32, vae32,
    )
    rng = np.random.default_rng(0)
    video = image_to_input(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), pipe.num_video_frames)
    emb = rng.standard_normal((1, 16, 64)).astype(np.float32)
    steps = 4 if sampler == "dmd2" else 2
    _build.reset_launch_counts()
    got = pipe.generate_vid2world(video, emb, num_steps=steps, num_conditional_frames=1, sampler=sampler)
    counts = _build.launch_counts()
    ref = pipe32.generate_vid2world(video, emb, num_steps=steps, num_conditional_frames=1, sampler=sampler)
    max_abs = float(np.abs(got - ref).max())
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"  {'sparse' if sparse else 'dense'} {sampler}: card bf16 vs cpu fp32: shape {got.shape} max_abs "
        f"{max_abs:.3e} rel_l2 {rel:.3e} (limit {PIPELINE_REL_L2}); launches {counts}")
    if sparse and counts["na_fwd"] == 0:
        raise AssertionError("the small sparse pipeline never ran K10")
    if sampler == "dmd2" and counts["flash_attention_fwd"] != steps * 4:  # batch 1, 2 blocks: 4 attention calls
        raise AssertionError(f"the small dmd2 pipeline launched {counts}, want K1 {steps * 4} times")
    if not (got.shape == ref.shape == (9, 64, 64, 3) and np.isfinite(got).all() and rel <= PIPELINE_REL_L2):
        raise AssertionError(f"small pipeline disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")


def serve_slice(experiment: str, names: tuple[str, ...]) -> dict:
    """Full-width requests of ``experiment`` (those of ``names``); checks the
    outputs and the launches per DiT forward."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import (
        InferenceSetup, Video2WorldInference, image_to_input, video_to_input,
    )
    from cosmos_predict2_tpu_torch.networks.dit import block_layout, build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config(experiment)
    if cfg.model.net.num_blocks != NUM_BLOCKS or cfg.model.net.model_channels != 2048:
        raise AssertionError("the slice must run the full-width 2B DiT")
    n_sparse = sum(p is not None for p in block_layout(cfg.model.net))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_dit(cfg.model.net, "cuda", seed=0)
    vae = build_vae(cfg.tokenizer, "cuda", seed=1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  2B DiT {n_params / 1e9:.3f} B params, VAE dim {cfg.tokenizer.dim}: built in {time.perf_counter() - t0:.1f} s")
    setup = InferenceSetup(model_config=cfg.model, vae_config=cfg.tokenizer, size_override=SIZE)
    pipe = Video2WorldInference(setup, net, vae)
    H, W = SIZE
    T = pipe.num_video_frames
    rng = np.random.default_rng(0)
    requests = [
        ("text2world", np.zeros((1, 3, T, H, W), dtype=np.uint8), 0),
        ("image2world", image_to_input(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), T), 1),
        ("video2world", video_to_input(rng.integers(0, 256, (9, H, W, 3), dtype=np.uint8), T, 2), 2),
    ]
    requests = [r for r in requests if r[0] in names]
    embs = [rng.standard_normal((1, 512, cfg.model.net.crossattn_proj_in_channels)).astype(np.float32) for _ in requests]

    _build.reset_launch_counts()
    outputs = []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for (name, video, k), emb in zip(requests, embs):
        t = time.perf_counter()
        frames = pipe.generate_vid2world(
            video, emb, guidance=GUIDANCE, num_steps=NUM_STEPS, num_conditional_frames=k, seed=1, pixel_format="uint8"
        )
        tm = dict(pipe.last_timings, request_s=time.perf_counter() - t)
        log(f"  {name:12s} k={k} steps={NUM_STEPS} request {tm['request_s']:.2f} s: vae_encode {tm['vae_encode_s']:.2f} s, "
            f"denoise {tm['denoise_s']:.2f} s ({tm['denoise_step_s'] * 1e3:.1f} ms/step), vae_decode {tm['vae_decode_s']:.2f} s")
        outputs.append((name, frames))
    serve_s = time.perf_counter() - t_all
    counts = _build.launch_counts()
    log(f"  launches during the slice: {counts}")

    for name, frames in outputs:
        if frames.shape != (NUM_FRAMES, H, W, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"{name}: output {frames.shape} {frames.dtype}, want ({NUM_FRAMES}, {H}, {W}, 3) uint8")
        if frames.std() == 0:
            raise AssertionError(f"{name}: output is constant")
    forwards = NUM_STEPS * len(requests)  # one batched-CFG DiT forward per UniPC step
    # per forward: K1 for every cross-attention and dense self-attention, K10 for the sparse ones
    want = {"flash_attention_fwd": (2 * NUM_BLOCKS - n_sparse) * forwards, "na_fwd": n_sparse * forwards}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"attention launches {({k: counts[k] for k in want})}, want {want} "
                             f"({forwards} forwards, {n_sparse} sparse blocks)")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran on the main path")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # a denoise step's device work: one batched-CFG DiT forward under torch.profiler
    x = torch.randn((2, cfg.model.state_ch, (T - 1) // 4 + 1, H // 8, W // 8), device="cuda")
    ctx = torch.from_numpy(np.concatenate([embs[0], np.zeros_like(embs[0])])).cuda()
    ts = torch.full((2, 1), 500.0, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        net(x, ts, ctx)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()  # inside the profiler: its start and teardown are not the forward's
            net(x, ts, ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    log(f"  one batched-CFG DiT forward of {experiment} (batch 2, 5,760 tokens):")
    profile = device_time_table(prof, wall)
    vae_profile = None
    if len(requests) > 1:  # the dense slice: a request's VAE work (K2's share), encode and decode of one clip
        from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming

        clip = torch.from_numpy(requests[1][1]).cuda().permute(0, 2, 3, 4, 1)
        with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            z = encode_streaming(vae, clip, pixel_format="uint8")
            decode_streaming(vae, z, chunk_latent_frames=setup.decode_chunk_latent_frames, pixel_format="uint8")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        log(f"  one streaming VAE encode and decode of a request's clip ({T} frames, {H}x{W}):")
        vae_profile = device_time_table(prof, wall)
    return {"counts": counts, "serve_s": serve_s, "peak_gb": peak_gb, "profile": profile, "vae_profile": vae_profile}


def small_train_step(device: str, dtype, sparse: bool, state_dict=None):
    """One training step of a narrow DiT (2B experiment, 2 blocks of 256
    channels, head_dim 128; with ``sparse`` block 0 is neighborhood
    attention) with fixed weights, inputs and draws; returns (loss, {name:
    grad fp32 on the CPU}, state_dict)."""
    import torch

    from cosmos_predict2_tpu_torch.conditioning.conditioner import apply_train_dropout, make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit

    cfg = make_config(SPARSE_EXPERIMENT if sparse else DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(
        cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
        crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype, **(SMALL_SPARSE if sparse else {}),
    )
    net = build_dit(net_cfg, device, seed=10, trainable=True)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    model = Video2WorldModel(dataclasses.replace(cfg.model, net=net_cfg, state_t=4), net)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 24)).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)).to(device)
    draws = model.sample_train_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(device)
    cond = apply_train_dropout(make_condition(emb).replace(gt_frames=x0), draws.text_keep, draws.use_video)
    loss, _ = model.training_step(x0, cond, draws)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in net.named_parameters()}
    return float(loss.detach()), grads, {k: v.cpu() for k, v in net.state_dict().items()}


def small_train_reference(sparse: bool) -> None:
    """The small training step in bf16 on the card (K1, K7, K8; K10, K11,
    K12 with ``sparse``) against the same weights and draws in fp32 on the
    CPU (plain versions)."""
    import torch

    from cosmos_predict2_tpu_torch import _build

    _build.reset_launch_counts()
    loss, grads, sd = small_train_step("cuda", torch.bfloat16, sparse)
    counts = _build.launch_counts()
    ref_loss, ref_grads, _ = small_train_step("cpu", torch.float32, sparse, sd)
    num = sum(float((grads[n] - g).norm()) ** 2 for n, g in ref_grads.items()) ** 0.5
    den = sum(float(g.norm()) ** 2 for g in ref_grads.values()) ** 0.5
    worst = max((float((grads[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in ref_grads.items())
    loss_rel = abs(loss / ref_loss - 1)
    log(f"  card bf16 loss {loss:.6f} vs cpu fp32 {ref_loss:.6f}: rel {loss_rel:.3e} (limit {TRAIN_LOSS_REL}); "
        f"gradients rel_l2 {num / den:.3e} (limit {TRAIN_GRAD_REL_L2}), worst parameter {worst[0]:.3e} {worst[1]} "
        f"(limit {TRAIN_GRAD_TENSOR_REL_L2}); launches {counts}")
    # backward: one per attention call of the 2 blocks, 1 of them sparse with `sparse`
    want = {"flash_attention_bwd_dq": 3, "flash_attention_bwd_dkv": 3, "na_bwd_dq": 1, "na_bwd_dkv": 1} if sparse \
        else {"flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4, "na_bwd_dq": 0, "na_bwd_dkv": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the small training step's backward launches {counts}, want {want}")
    if not (all(torch.isfinite(g).all() for g in grads.values()) and loss_rel <= TRAIN_LOSS_REL
            and num / den <= TRAIN_GRAD_REL_L2 and worst[0] <= TRAIN_GRAD_TENSOR_REL_L2):
        raise AssertionError("the small training step on the card disagrees with its fp32 CPU reference")


def kernel_family(name: str) -> str:
    for key, family in (("flash_kv_cache_window_kernel", "K6 cache decode, window"),
                        ("flash_kv_cache_kernel", "K5 cache decode"),
                        ("kv_cache_combine_kernel", "K5/K6 split combine"),
                        ("na_fwd_kernel", "K10 NA forward"), ("na_bwd_dq_kernel", "K11 NA dQ"),
                        ("na_bwd_dkv_kernel", "K12 NA dK/dV"), ("flash_attention_fwd_kernel", "K1 flash attention forward"),
                        ("flash_attention_jvp_kernel", "K9 forward mode"),
                        ("flash_attention_bwd_dq", "K7 flash attention dQ"),
                        ("flash_attention_bwd_dkv", "K8 flash attention dK/dV"),
                        ("conv3d_causal", "K2 causal conv"), ("nvjet", "GEMM (cuBLAS)"), ("gemm", "GEMM (cuBLAS)"),
                        ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"),
                        ("multi_tensor_apply", "foreach (AdamW)"), ("memcpy", "memcpy / memset"),
                        ("memset", "memcpy / memset"), ("reduce", "reductions"), ("copy", "copies and casts"),
                        ("elementwise", "elementwise")):
        if key in name.lower():
            return family
    return "other"


def device_time_table(prof, wall_s: float) -> dict:
    """Device kernel time of a profiled window by family and by kernel."""
    import torch

    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        # device kernels only: user annotations (e.g. Optimizer.step) span kernels already counted
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_kernels += 1
    total = sum(by_name.values())
    families: dict[str, float] = {}
    for name, ms in by_name.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + ms
    log(f"  profiled step: {wall_s * 1e3:.1f} ms on the host clock, {total:.1f} ms of device kernels "
        f"(device busy {total / (wall_s * 1e3):.1%} of the step) in {n_kernels} launches")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"    {fam:28s} {ms:9.1f} ms {ms / total:6.1%}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    top kernel {ms:9.1f} ms  {name[:110]}")
    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import LAYOUT_RANGE

    # the device time of the kernels launched inside the NA layout ranges (permute_in / permute_out copies)
    layout_ms = sum(e.device_time_total for e in prof.events()
                    if e.name == LAYOUT_RANGE and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    if layout_ms:
        log(f"    of which NA layout copies (permute_in / permute_out) {layout_ms:9.1f} ms {layout_ms / total:6.1%}")
    return {"device_ms": total, "wall_ms": wall_s * 1e3, "families": families, "na_layout_ms": layout_ms,
            "launches": n_kernels}


class TrainProbe:
    """Training callback of the slice: per-step launches, losses and
    timings; a finite gradient on every parameter at step 1; a few
    parameters and their EMA kept from the start to check that both move;
    torch.profiler around the step numbered ``profile_step``."""

    WATCH = ("x_embedder.proj.1.weight", "blocks.0.self_attn.q_proj.weight", "blocks.27.mlp.layer2.weight",
             "final_layer.linear.weight")

    def __init__(self, profile_step: int):
        self.steps, self.start, self.profile_step, self.profile = [], {}, profile_step, None

    def on_train_start(self, trainer, state):
        self.start = {n: (state.params[n].detach().clone(), state.ema_params[n].clone()) for n in self.WATCH}

    def on_training_step_start(self, trainer, state, batch, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        self.counts0 = _build.launch_counts()
        if iteration + 1 == self.profile_step:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        counts = {k: v - self.counts0[k] for k, v in _build.launch_counts().items()}
        if iteration == self.profile_step:
            self._prof.__exit__(None, None, None)
            self.profile = device_time_table(self._prof, trainer.last_timings["step_s"])
        if iteration == 1:
            bad = [n for n, p in state.params.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            if bad:
                raise AssertionError(f"{len(bad)} parameters without a finite gradient at step 1, e.g. {bad[:3]}")
            log(f"  step 1: all {len(state.params)} trainable parameters have a finite gradient")
        self.steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                           "counts": counts, **trainer.last_timings})
        st = self.steps[-1]
        log(f"  step {iteration}: loss {st['loss']:.4f} grad_norm {st['grad_norm']:.3e} step {st['step_s']:.3f} s "
            f"(data+vae {st['data_s']:.3f} s, fwd+bwd {st['forward_backward_s']:.3f} s, "
            f"optimizer+ema {st['optimizer_s']:.3f} s) launches {counts}")

    # the other hooks of trainer.Callback, written out: this file imports the
    # port only inside functions, so that it fails cleanly where the port is absent
    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...

    def moved(self, state) -> tuple[bool, bool]:
        import torch

        params = all(not torch.equal(state.params[n], p0) for n, (p0, _) in self.start.items())
        ema = all(not torch.equal(state.ema_params[n], e0) for n, (_, e0) in self.start.items())
        return params, ema


def train_slice(experiment: str, timed_steps: int) -> dict:
    """training/train.py's launch on a full-width 2B experiment: one warm-up
    step, ``timed_steps`` timed steps and one profiled step."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import block_layout
    from cosmos_predict2_tpu_torch.training.train import launch

    H, W = SIZE
    steps = 1 + timed_steps + 1
    cfg = make_config(experiment, [
        f"data_train.num_frames={NUM_FRAMES}", f"data_train.height={H}", f"data_train.width={W}",
        "data_train.text_dim=100352", "data_train.batch_size=1",
        f"trainer.max_iter={steps}", "trainer.save_iter=0", "trainer.logging_iter=1", "trainer.ema_enabled=True",
    ])
    net = cfg.model.net
    if (net.num_blocks, net.model_channels, net.crossattn_proj_in_channels) != (NUM_BLOCKS, 2048, 100352):
        raise AssertionError("the training slice must run the full-width 2B DiT")
    probe = TrainProbe(profile_step=steps)
    gc.collect()  # an earlier slice's trainer may sit in a reference cycle
    torch.cuda.empty_cache()
    log(f"  device memory in use before the launch: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = launch(cfg, device="cuda", callbacks=[probe])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  launches during the training slice: {counts}")

    if len(probe.steps) != steps or state.step != steps:
        raise AssertionError(f"trained {state.step} steps, want {steps}")
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in probe.steps):
        raise AssertionError(f"non-finite losses: {[s['loss'] for s in probe.steps]}")
    # per step, with block remat (forward and recompute): K1 for every cross-
    # and dense self-attention and K10 for the sparse ones, twice; K7/K8 and
    # K11/K12 once per attention call of each kind
    n_sparse = sum(p is not None for p in block_layout(net))
    n_dense_calls = 2 * NUM_BLOCKS - n_sparse
    want = {"flash_attention_fwd": 2 * n_dense_calls, "flash_attention_bwd_dq": n_dense_calls,
            "flash_attention_bwd_dkv": n_dense_calls, "na_fwd": 2 * n_sparse, "na_bwd_dq": n_sparse,
            "na_bwd_dkv": n_sparse}
    for i, s in enumerate(probe.steps):
        got = {k: s["counts"][k] for k in want}
        if got != want:
            raise AssertionError(f"step {i + 1} launched {got}, want {want}")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran in the training slice's VAE encode")
    params_moved, ema_moved = probe.moved(state)
    if not (params_moved and ema_moved):
        raise AssertionError(f"parameters moved: {params_moved}, EMA moved: {ema_moved}")
    timed = probe.steps[1:1 + timed_steps]
    mean = lambda key: sum(s[key] for s in timed) / len(timed)
    tokens = (1 + (NUM_FRAMES - 1) // 4) * (H // 16) * (W // 16)
    out = {"counts": counts, "total_s": total_s, "peak_gb": peak_gb, "tokens_per_step": tokens,
           "profile": probe.profile, **{k: mean(k) for k in ("step_s", "data_s", "forward_backward_s", "optimizer_s")}}
    iteration_s = out["data_s"] + out["step_s"]
    log(f"  {experiment}: {timed_steps} timed steps after a warm-up: iteration {iteration_s:.3f} s = data+vae "
        f"{out['data_s']:.3f} s (host mock data, H2D, VAE encode) + train step {out['step_s']:.3f} s (fwd+bwd "
        f"{out['forward_backward_s']:.3f} + optimizer+ema {out['optimizer_s']:.3f}); {tokens} tokens/step: "
        f"{tokens / out['step_s']:.0f} tokens/s over the train step, {tokens / iteration_s:.0f} over the iteration; "
        f"peak device memory {peak_gb:.2f} GiB; whole launch {total_s:.1f} s")
    return out


def small_stream(device: str, dtype, window: int, state_dict=None):
    """A narrow causal DiT (the tiny preset's 2 blocks of 3 heads of 128)
    streams 5 one-frame blocks of 4 steps after one prefilled frame at a 16 x
    24 latent (8 x 12 tokens), cache 3 + 1 frames (the window slides 3
    times), with fixed inputs and noise. Returns (latents fp32 on the CPU,
    launches, state_dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.scripts.interactive_latency import NET_TINY, build_stream

    stream = build_stream(dataclasses.replace(NET_TINY, dtype=dtype), 1, 3, 4, window, device, seed=20)
    if state_dict is not None:
        stream.model.net.load_state_dict(state_dict)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy((rng.standard_normal((1, 8, 1024)) * 0.05).astype(np.float32)).to(device)
    init = torch.from_numpy(rng.standard_normal((1, 16, 1, 16, 24)).astype(np.float32)).to(device)
    draw = lambda step, shape: torch.from_numpy(np.random.default_rng(100 + step).standard_normal(shape).astype(np.float32))
    _build.reset_launch_counts()
    out = stream.generate(make_condition(emb), init, 6, (16, 24), draw=draw)
    counts = _build.launch_counts()
    return out.float().cpu(), counts, {k: v.cpu() for k, v in stream.model.net.state_dict().items()}


def small_stream_reference() -> None:
    """The small causal stream in bf16 on the card (K5, then K6 with 3 of 8
    rows) against the same weights, inputs and noise in fp32 on the CPU."""
    import torch

    for window in (-1, 3):
        got, counts, sd = small_stream("cuda", torch.bfloat16, window)
        ref, _, _ = small_stream("cpu", torch.float32, window, sd)
        max_abs, rel = errors(got, ref)
        cached = "flash_attention_kv_cache_window" if window > 0 else "flash_attention_kv_cache"
        log(f"  window {window}: card bf16 vs cpu fp32: shape {tuple(got.shape)} max_abs {max_abs:.3e} rel_l2 "
            f"{rel:.3e} (limit {STREAM_REL_L2}); launches {counts}")
        # per DiT forward: 2 cached self-attentions and 2 cross-attentions; 1 prefill + 5 x (4 steps + 1 commit)
        want = 2 * (1 + 5 * 5)
        if (counts[cached], counts["flash_attention_fwd"]) != (want, want):
            raise AssertionError(f"the small stream launched {counts}, want {cached} and K1 {want} times each")
        if not (got.shape == (1, 16, 6, 16, 24) and torch.isfinite(got).all() and rel <= STREAM_REL_L2):
            raise AssertionError(f"the small stream disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")


def interactive_slice(window: int, run_measure: bool) -> dict:
    """StreamingInference.generate with the full-width causal 2B DiT at
    352x640: one prefilled frame, INTERACTIVE_BLOCKS streamed one-frame
    blocks; checks, timings, peak memory and one profiled block step."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.scripts import interactive_latency as il

    h, w = INTERACTIVE_HW
    tpf = (h // 2) * (w // 2)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stream = il.build_stream(il.NET_2B, 1, INTERACTIVE_CACHE_FRAMES, INTERACTIVE_STEPS, window, "cuda", seed=0)
    net = stream.model.config.net
    if (net.num_blocks, net.model_channels, net.num_heads, net.head_dim) != (NUM_BLOCKS, 2048, 16, 128):
        raise AssertionError("the interactive slice must run the full-width causal 2B DiT")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    log(f"  causal 2B DiT built in {time.perf_counter() - t0:.1f} s: {weights / 2**30:.2f} GiB of weights "
        f"(matmul weights bf16, AdaLN fp32); window {window if window > 0 else 'dense'}")
    cond = il.text_condition(stream, "cuda")
    init = torch.randn((1, 16, 1, h, w), generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    s_max = (INTERACTIVE_CACHE_FRAMES + 1) * tpf
    cache_bytes = NUM_BLOCKS * 2 * 16 * s_max * 128 * 2
    laps, lens, state = [], [], {}

    def on_block(step, x, caches):
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps.append(now - state["t"])
        state["t"], state["caches"] = now, caches
        lens.append(sorted({c["len"] for c in caches}))

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    state["t"] = t_all = time.perf_counter()
    out = stream.generate(cond, init, 1 + INTERACTIVE_BLOCKS, (h, w),
                          generator=torch.Generator(device="cuda").manual_seed(3), on_block=on_block)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_all
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base

    cached = "flash_attention_kv_cache_window" if window > 0 else "flash_attention_kv_cache"
    other = "flash_attention_kv_cache" if window > 0 else "flash_attention_kv_cache_window"
    want = NUM_BLOCKS + INTERACTIVE_BLOCKS * (INTERACTIVE_STEPS + 1) * NUM_BLOCKS
    got = (counts[cached], counts["flash_attention_fwd"], counts[other])
    if got != (want, want, 0):
        raise AssertionError(f"launches {cached}, K1, {other}: {got}, want ({want}, {want}, 0)")
    if out.shape != (1, 16, 1 + INTERACTIVE_BLOCKS, h, w) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"streamed latents {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    want_lens = [[min(1 + s, INTERACTIVE_CACHE_FRAMES) * tpf] for s in range(1, INTERACTIVE_BLOCKS + 1)]
    if lens != want_lens:
        raise AssertionError(f"cache lengths after each block {lens}, want {want_lens}")
    slides = sum(1 + s > INTERACTIVE_CACHE_FRAMES for s in range(1, INTERACTIVE_BLOCKS + 1))
    if peak - weights > 1.25 * cache_bytes:
        raise AssertionError(f"peak {peak / 2**30:.2f} GiB over {weights / 2**30:.2f} GiB of weights: more than one "
                             f"copy of the {cache_bytes / 2**30:.2f} GiB cache")
    p50 = float(np.median(laps[1:]))  # laps[0] holds the prefill and the first block's warm-up
    log(f"  streamed {INTERACTIVE_BLOCKS} blocks in {total_s:.2f} s ({slides} slides); first block with the prefill "
        f"{laps[0] * 1e3:.1f} ms; p50 block latency {p50 * 1e3:.1f} ms (min {min(laps[1:]) * 1e3:.1f}, max "
        f"{max(laps[1:]) * 1e3:.1f}) -> {1 / p50:.2f} latent frames/s = {4 / p50:.1f} pixel fps; launches {cached} "
        f"{counts[cached]}, K1 {counts['flash_attention_fwd']}; peak device memory {peak / 2**30:.2f} GiB over the "
        f"start = weights {weights / 2**30:.2f} + cache {cache_bytes / 2**30:.2f} GiB (bf16, 28 x k/v (1, 16, "
        f"{s_max}, 128)) + {(peak - weights - cache_bytes) / 2**30:.2f} GiB")

    # steady-state block steps (the cache full: 16 frames + the block): the
    # host's time to queue one (nothing in it waits for the card) against
    # the time until the card has run it; then one under torch.profiler
    caches = state.pop("caches")
    noise = torch.randn((1, 16, 1, h, w), device="cuda")
    queued, done = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stream.generate_block(noise, cond, caches, 1 + INTERACTIVE_BLOCKS)
        queued.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t)
    queued_s, done_s = float(np.median(queued)), float(np.median(done))
    log(f"  block step at full cache: queued by the host in {queued_s * 1e3:.1f} ms, run by the card "
        f"{done_s * 1e3:.1f} ms after its start (medians of 3)")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        stream.generate_block(noise, cond, caches, 1 + INTERACTIVE_BLOCKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    log(f"  one block step at full cache ({INTERACTIVE_STEPS} denoise forwards + 1 commit):")
    profile = device_time_table(prof, wall)
    del stream, caches, cond, out, prof
    result = {"counts": counts, "p50_s": p50, "latent_fps": 1 / p50, "pixel_fps": 4 / p50, "laps": laps,
              "queued_s": queued_s, "done_s": done_s,
              "total_s": total_s, "peak_gb": peak / 2**30, "weights_gb": weights / 2**30,
              "cache_gb": cache_bytes / 2**30, "profile": profile}
    if run_measure:
        gc.collect()
        torch.cuda.empty_cache()
        result["measure"] = il.measure(INTERACTIVE_HW, 8, INTERACTIVE_CACHE_FRAMES,
                                       cache_window_rows=window, device="cuda")
    return result


# ------------------------- K9: fused forward mode -------------------------


def jvp_plain_by_heads(q, k, v, dq, dk, dv, fg, heads_per_chunk: int = 4):
    """K9's plain version, a few heads at a time: whole, it would hold five
    (B, H, S, S) fp32 tensors (~22 GB at S8320 H16)."""
    import torch

    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp_plain

    outs = [flash_attention_jvp_plain(*(t[:, :, h:h + heads_per_chunk].contiguous() for t in (q, k, v, dq, dk, dv)), fg)
            for h in range(0, q.shape[2], heads_per_chunk)]
    return torch.cat([o for o, _ in outs], dim=2), torch.cat([d for _, d in outs], dim=2)


def sdpa_jvp_yardstick(q, k, v, dq, dk, dv, mask):
    """torch.func.jvp of scaled_dot_product_attention (BHSD views), the
    first backend that takes it: (ms or the reasons, backend name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    prim = tuple(t.transpose(1, 2) for t in (q, k, v))
    tang = tuple(t.transpose(1, 2) for t in (dq, dk, dv))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask)  # noqa: E731
    fn = lambda: torch.func.jvp(sdpa, prim, tang)  # noqa: E731
    reasons = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        with sdpa_kernel(backend):
            ms = yardstick_ms(fn)
        if not isinstance(ms, str):
            return ms, backend.name
        reasons.append(f"{backend.name} {ms}")
    return "; ".join(reasons), None


def check_jvp_kernel(gen, record, failures) -> None:
    """K9 against its plain version (fp32, by heads) at four
    cases; beside it K1 at the same shape and the SDPA jvp yardstick."""
    import torch

    from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd
    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp

    dev = torch.device("cuda")
    # (label, S, frame_group, inputs with a tangent); case 3 has a kv tail (1000 = 15 x 64 + 40)
    cases = [
        ("B1 S8320 H16 (fa_jvp shape)", 8320, 0, "qkv"),
        ("B1 S5760 H16 (smoke self-attention)", 5760, 0, "qkv"),
        ("B1 S1000 H16 frame_group=256 (kv tail)", 1000, 256, "qkv"),
        ("B1 S5760 H16 dv only", 5760, 0, "v"),
    ]
    B, H = 1, 16
    for label, S, fg, tangents in cases:
        q, k, v = (torch.randn((B, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        dq, dk, dv = (torch.randn((B, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) if name in tangents
                      else torch.zeros_like(x) for name, x in zip("qkv", (q, k, v)))
        o, do = flash_attention_jvp(q, k, v, dq, dk, dv, fg)
        # no atomics: a second call gives the same bits
        repeat = flash_attention_jvp(q, k, v, dq, dk, dv, fg)
        torch.cuda.synchronize()
        if not (torch.equal(o, repeat[0]) and torch.equal(do, repeat[1])):
            failures.append(f"flash_attention_jvp {label}: two calls differ")
        del repeat
        ref_o, ref_do = jvp_plain_by_heads(q, k, v, dq, dk, dv, fg)
        (o_abs, o_rel), (do_abs, do_rel) = errors(o, ref_o), errors(do, ref_do)
        del ref_o, ref_do
        plain_ms = cuda_ms(lambda: jvp_plain_by_heads(q, k, v, dq, dk, dv, fg), 0, 1)
        ms = cuda_ms(lambda: flash_attention_jvp(q, k, v, dq, dk, dv, fg), 1, 5)
        k1_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, frame_group=fg), 1, 5)
        mask = None
        if fg > 0:
            mask = (torch.arange(S, device=dev)[None, :] // fg) <= (torch.arange(S, device=dev)[:, None] // fg)
        library_ms, backend = sdpa_jvp_yardstick(q, k, v, dq, dk, dv, mask)
        bnd = bound(12 * B * H * visible_pairs(S, S, fg) * 128, 2 * 8 * q.numel())
        record("flash_attention_jvp", label, max(o_abs, do_abs), max(o_rel, do_rel), ms, plain_ms, library_ms, bnd,
               o_rel_l2=f"{o_rel:.3e}", do_rel_l2=f"{do_rel:.3e}", k1_ms=k1_ms, library_backend=backend)
        if not bool(torch.isfinite(do.float()).all()):
            failures.append(f"flash_attention_jvp {label}: non-finite tangent")
        del q, k, v, dq, dk, dv, o, do, mask
        torch.cuda.empty_cache()


def fwdmode_slice() -> dict:
    """The op under both forward-mode APIs on card tensors at the smoke
    self-attention shape: one K1 and one K9 each, against the plain version."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_fwdmode

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, dq, dk, dv = (torch.randn((1, 5760, 16, 128), generator=gen, device="cuda").to(torch.bfloat16)
                           for _ in range(6))
    ref_o, ref_do = jvp_plain_by_heads(q, k, v, dq, dk, dv, 0)
    _build.reset_launch_counts()
    results = {}
    for api in ("torch.func.jvp", "forward_ad"):
        before = _build.launch_counts()
        if api == "torch.func.jvp":
            o, do = torch.func.jvp(flash_attention_fwdmode, (q, k, v), (dq, dk, dv))
        else:
            with fwAD.dual_level():
                o, do = fwAD.unpack_dual(flash_attention_fwdmode(*(fwAD.make_dual(p, t)
                                                                   for p, t in zip((q, k, v), (dq, dk, dv)))))
        torch.cuda.synchronize()
        after = _build.launch_counts()
        got = {n: after[n] - before[n] for n in ("flash_attention_fwd", "flash_attention_jvp")}
        (_, o_rel), (_, do_rel) = errors(o, ref_o), errors(do, ref_do)
        log(f"  {api}: launches {got}; o rel_l2 {o_rel:.3e}, do rel_l2 {do_rel:.3e} (limit {KERNEL_REL_L2})")
        if got != {"flash_attention_fwd": 1, "flash_attention_jvp": 1}:
            raise AssertionError(f"{api} of flash_attention_fwdmode launched {got}, want one K1 and one K9")
        if not (o_rel <= KERNEL_REL_L2 and do_rel <= KERNEL_REL_L2):
            raise AssertionError(f"{api} of flash_attention_fwdmode disagrees with the plain version")
        results[api] = {"o_rel_l2": o_rel, "do_rel_l2": do_rel}
    return {"counts": _build.launch_counts(), **results}


def fa_jvp_slice() -> dict:
    """scripts/fa_jvp.py's run as a user calls it: B1 S8320 H16, 1 + 1 + 20
    jvp calls (the checked call, the slice, the timed ones)."""
    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.scripts import fa_jvp

    _build.reset_launch_counts()
    result = fa_jvp.run("cuda")
    counts = _build.launch_counts()
    want = 1 + 1 + 20
    if (counts["flash_attention_fwd"], counts["flash_attention_jvp"]) != (want, want):
        raise AssertionError(f"fa_jvp launched {counts}, want K1 and K9 {want} times each")
    if not (result["o_rel_l2"] <= KERNEL_REL_L2 and result["do_rel_l2"] <= KERNEL_REL_L2):
        raise AssertionError(f"fa_jvp's slice disagrees with the fp32 plain version: {result}")
    return {"counts": counts, **result}


# ------------------------------- DMD2 serving -------------------------------


def dmd2_serve_slice() -> dict:
    """One DMD2 request through the Inference API on the full-width 2B
    student (seeded random weights): an image-conditioned Video2World
    request, 93 frames at 192x320, 4 TrigFlow steps, batch 1, no CFG."""
    import torch
    from PIL import Image

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config(DMD2_EXPERIMENT)
    mc = cfg.model
    if (mc.net.num_blocks, mc.net.model_channels, mc.sampling_num_steps) != (NUM_BLOCKS, 2048, 4):
        raise AssertionError("the DMD2 slice must run the full-width 2B student with 4 steps")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = build_dit(mc.net, "cuda", seed=0)
    vae = build_vae(cfg.tokenizer, "cuda", seed=1)
    pipe = Video2WorldInference(InferenceSetup(model_config=mc, vae_config=cfg.tokenizer, size_override=SIZE), net, vae)
    out_dir = OUT_DIR / "dmd2"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    H, W = SIZE
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(out_dir / "input.png")
    np.save(out_dir / "prompt.npy", rng.standard_normal((1, 512, mc.net.crossattn_proj_in_channels)).astype(np.float32))
    request = InferenceArguments(name="dmd2_request", prompt="p", input_path=str(out_dir / "input.png"),
                                 num_steps=mc.sampling_num_steps, sampler="dmd2", seed=1,
                                 text_embedding_path=str(out_dir / "prompt.npy"))
    frames = []
    generate = pipe.generate_vid2world
    pipe.generate_vid2world = lambda *a, **kw: frames.append(generate(*a, **kw)) or frames[-1]  # keep the frames

    api = Inference(pipe, output_dir=str(out_dir), keep_going=False)
    export_s = []
    finish = api._finish

    def timed_finish(*a):  # the media export (mp4, or a gif where no video codec is installed)
        t = time.perf_counter()
        path = finish(*a)
        export_s.append(time.perf_counter() - t)
        return path

    api._finish = timed_finish
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (path,) = api.generate([request])
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    tm = pipe.last_timings
    want = 4 * 2 * NUM_BLOCKS  # 4 forwards of batch 1, 28 self- and 28 cross-attentions each
    pipeline_s = tm["vae_encode_s"] + tm["denoise_s"] + tm["vae_decode_s"]
    log(f"  dmd2 request ({mc.sampling_num_steps} steps, no CFG): {request_s:.2f} s through Inference = pipeline "
        f"{pipeline_s:.2f} s (vae_encode {tm['vae_encode_s']:.2f} s, denoise {tm['denoise_s']:.2f} s = "
        f"{tm['denoise_step_s'] * 1e3:.1f} ms/step, vae_decode {tm['vae_decode_s']:.2f} s) + export "
        f"{export_s[0]:.2f} s ({path}) + input and text {request_s - pipeline_s - export_s[0]:.2f} s; "
        f"launches {counts}")
    if counts["flash_attention_fwd"] != want or counts["conv3d_causal"] == 0:
        raise AssertionError(f"the dmd2 request launched {counts}, want K1 {want} times and K2")
    if counts["flash_attention_jvp"] != 0:
        raise AssertionError("the dmd2 request launched K9")
    (video,) = frames
    if video.shape != (NUM_FRAMES, H, W, 3) or video.dtype != np.uint8 or video.std() == 0:
        raise AssertionError(f"dmd2 output {video.shape} {video.dtype}, std {video.std()}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # a denoise step's device work: one DiT forward at batch 1 (no CFG) under torch.profiler
    x = torch.randn((1, mc.state_ch, (NUM_FRAMES - 1) // 4 + 1, H // 8, W // 8), device="cuda")
    ctx = torch.from_numpy(np.load(out_dir / "prompt.npy")).cuda()
    ts = torch.full((1, x.shape[2]), 500.0, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        net(x, ts, ctx)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            net(x, ts, ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    log("  one DiT forward of the dmd2 student (batch 1, 5,760 tokens):")
    profile = device_time_table(prof, wall)
    del pipe, net, vae, api
    return {"counts": counts, "request_s": request_s, "pipeline_s": pipeline_s, "export_s": export_s[0], **tm,
            "peak_gb": peak_gb, "profile": profile}


# ----------------------------- DMD2 distillation -----------------------------


def small_distill_steps(device: str, dtype, state_dicts=None):
    """A student step and a critic step of a narrow DMD2 distillation (2B
    experiment, 2 blocks of 256 channels, head_dim 128; 2 sampler steps)
    with fixed weights, inputs and draws. Returns ({phase: (loss, {name:
    grad fp32 on the CPU})}, launches per phase, state dicts)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import get_condition_uncondition, make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, DistillationModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit

    cfg = make_config(DMD2_EXPERIMENT)
    net_cfg = dataclasses.replace(cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                                  crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype)
    nets = [build_dit(net_cfg, device, seed=10 + i, trainable=i != 1) for i in range(3)]  # student, teacher, fake
    if state_dicts is not None:
        for net, sd in zip(nets, state_dicts):
            net.load_state_dict(sd)
    student, teacher, fake = nets
    dm = DistillationModel(DistillationConfig(model=dataclasses.replace(cfg.model, net=net_cfg, state_t=4)))
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 24)).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)).to(device)
    cond, uncond = get_condition_uncondition(make_condition(emb).replace(gt_frames=x0).set_video_condition(x0, 1))
    draws = dm.sample_distill_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(device)
    out, counts = {}, {}
    for phase, net in (("student", student), ("critic", fake)):
        _build.reset_launch_counts()
        if phase == "student":
            loss, _ = dm.training_step_generator(student, teacher, fake, x0, cond, uncond, 2, draws)
        else:
            loss, _ = dm.training_step_critic(student, fake, x0, cond, 2, draws)
        loss.backward()
        counts[phase] = _build.launch_counts()
        out[phase] = (float(loss.detach()), {n: p.grad.float().cpu() for n, p in net.named_parameters()})
        net.zero_grad(set_to_none=True)
    return out, counts, [{k: v.cpu() for k, v in n.state_dict().items()} for n in nets]


def small_distill_reference() -> None:
    """The small distillation steps in bf16 on the card (K1, K7, K8) against
    the same weights and draws in fp32 on the CPU, under the training bounds."""
    import torch

    got, counts, sds = small_distill_steps("cuda", torch.bfloat16)
    ref, _, _ = small_distill_steps("cpu", torch.float32, sds)
    for phase in ("student", "critic"):
        (loss, grads), (ref_loss, ref_grads) = got[phase], ref[phase]
        num = sum(float((grads[n] - g).norm()) ** 2 for n, g in ref_grads.items()) ** 0.5
        den = sum(float(g.norm()) ** 2 for g in ref_grads.values()) ** 0.5
        worst = max((float((grads[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in ref_grads.items())
        loss_rel = abs(loss / ref_loss - 1)
        log(f"  {phase}: card bf16 loss {loss:.6f} vs cpu fp32 {ref_loss:.6f}: rel {loss_rel:.3e} (limit "
            f"{TRAIN_LOSS_REL}); gradients rel_l2 {num / den:.3e} (limit {TRAIN_GRAD_REL_L2}), worst parameter "
            f"{worst[0]:.3e} {worst[1]} (limit {TRAIN_GRAD_TENSOR_REL_L2}); launches {counts[phase]}")
        # 2 blocks: 4 attention calls per forward; 2 sampler steps (the student's last recomputed under
        # remat) or 2 sampler steps and the fake-score forward (recomputed); the student phase adds
        # the fake-score and teacher forwards
        k1 = 4 * (2 + 1) + (8 if phase == "student" else 4)
        want = {"flash_attention_fwd": k1, "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4,
                "flash_attention_jvp": 0}
        if {k: counts[phase][k] for k in want} != want:
            raise AssertionError(f"the small {phase} step launched {counts[phase]}, want {want}")
        if not (all(torch.isfinite(g).all() for g in grads.values()) and loss_rel <= TRAIN_LOSS_REL
                and num / den <= TRAIN_GRAD_REL_L2 and worst[0] <= TRAIN_GRAD_TENSOR_REL_L2):
            raise AssertionError(f"the small {phase} step on the card disagrees with its fp32 CPU reference")


class DistillProbe:
    """Distillation callback: per iteration the phase, n, loss, timings,
    launches, peak memory and which nets' watched parameters changed;
    torch.profiler around the iteration numbered ``profile_step``."""

    WATCH = TrainProbe.WATCH
    NETS = ("student", "teacher", "fake_score")

    def __init__(self, profile_step: int):
        self.steps, self.profile_step, self.profile = [], profile_step, None

    def snapshot(self, state):
        out = {}
        for net in self.NETS:
            params = dict(getattr(state, net).named_parameters())
            out[net] = {n: params[n].detach().clone() for n in self.WATCH}
        return out

    def on_train_start(self, trainer, state): ...

    def on_training_step_start(self, trainer, state, batch, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        self.before = self.snapshot(state)
        self.counts0 = _build.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        if iteration + 1 == self.profile_step:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        counts = {k: v - self.counts0[k] for k, v in _build.launch_counts().items()}
        if iteration == self.profile_step:
            self._prof.__exit__(None, None, None)
            log(f"  iteration {iteration} ({metrics['phase']}, n={metrics['n_steps']}) under torch.profiler:")
            self.profile = device_time_table(self._prof, trainer.last_timings["step_s"])
        after = self.snapshot(state)
        changed = sorted(net for net in self.NETS
                         if any(not torch.equal(after[net][n], self.before[net][n]) for n in self.WATCH))
        st = {"phase": metrics["phase"], "n_steps": metrics["n_steps"], "loss": float(metrics["loss"]),
              "grad_norm": float(metrics["grad_norm"]), "counts": counts, "changed": changed,
              "peak_gb": torch.cuda.max_memory_allocated() / 2**30, **trainer.last_timings}
        self.steps.append(st)
        log(f"  iteration {iteration} [{st['phase']}, n={st['n_steps']}]: loss {st['loss']:.4f} grad_norm "
            f"{st['grad_norm']:.3e} step {st['step_s']:.3f} s (fwd+bwd {st['forward_backward_s']:.3f}, optimizer "
            f"{st['optimizer_s']:.3f}); peak {st['peak_gb']:.2f} GiB; changed {changed}; launches {counts}")

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...


def distill_slice() -> dict:
    """DMD2 distillation of the full-width 2B student: student, frozen
    teacher and fake-score nets (seeded random weights, fp32), mock data at
    93 frames 192x320 encoded by the VAE, batch 1, block remat, 5 iterations
    (student_update_freq 5: 4 critic steps, then 1 student step)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, DistillationModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.distill_trainer import DistillationTrainer, DistillTrainerConfig
    from cosmos_predict2_tpu_torch.training.train import mock_latent_batches

    H, W = SIZE
    cfg = make_config(DMD2_EXPERIMENT, [
        f"data_train.num_frames={NUM_FRAMES}", f"data_train.height={H}", f"data_train.width={W}",
        "data_train.text_dim=100352", "data_train.batch_size=1",
    ])
    net_cfg = cfg.model.net
    if (net_cfg.num_blocks, net_cfg.model_channels, net_cfg.remat) != (NUM_BLOCKS, 2048, "block"):
        raise AssertionError("the distillation slice must run the full-width 2B DiT with block remat")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    log(f"  device memory in use before the slice: {base / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    student, teacher, fake = (build_dit(net_cfg, "cuda", seed=i, trainable=i != 1) for i in range(3))
    vae = build_vae(cfg.tokenizer, "cuda", seed=3)
    model = DistillationModel(DistillationConfig(model=cfg.model, student_update_freq=5))
    probe = DistillProbe(profile_step=DISTILL_PROFILE_STEP)
    trainer = DistillationTrainer(DistillTrainerConfig(max_iter=DISTILL_ITERS, logging_iter=1), model,
                                  callbacks=[probe])
    state = trainer.init_state(student, teacher, fake)
    torch.cuda.synchronize()
    nets_gb = (torch.cuda.memory_allocated() - base) / 2**30
    log(f"  three 2B DiTs (fp32) and the VAE built in {time.perf_counter() - t0:.1f} s: {nets_gb:.2f} GiB")

    def batches():
        for x0, cond in mock_latent_batches(cfg.data_train, vae, torch.device("cuda")):
            yield x0, cond.set_video_condition(x0, 1)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state, batches())
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    steps = probe.steps
    phases = [s["phase"] for s in steps]
    if phases != ["critic"] * 4 + ["student"] or state.step != DISTILL_ITERS:
        raise AssertionError(f"phases {phases}, want 4 critic steps and 1 student step")
    host = np.random.RandomState(0)
    if [s["n_steps"] for s in steps] != [int(host.randint(0, 4)) + 1 for _ in range(DISTILL_ITERS)]:
        raise AssertionError("the sampler steps are not the host RandomState(0)'s draws")
    for i, s in enumerate(steps):
        if not (np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"iteration {i}: non-finite loss or gradient norm")
        if s["changed"] != (["student"] if s["phase"] == "student" else ["fake_score"]):
            raise AssertionError(f"iteration {i} ({s['phase']}) changed {s['changed']}")
        n = s["n_steps"]
        # per DiT forward 56 K1 (28 self, 28 cross); the graph-recording forward once more for remat;
        # the student phase adds the fake-score and teacher forwards
        k1 = 2 * NUM_BLOCKS * (n + 1) + (2 * 2 * NUM_BLOCKS if s["phase"] == "student" else 2 * NUM_BLOCKS)
        want = {"flash_attention_fwd": k1, "flash_attention_bwd_dq": 2 * NUM_BLOCKS,
                "flash_attention_bwd_dkv": 2 * NUM_BLOCKS, "flash_attention_jvp": 0}
        if {k: s["counts"][k] for k in want} != want:
            raise AssertionError(f"iteration {i} ({s['phase']}, n={n}) launched {s['counts']}, want {want}")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran in the distillation slice's VAE encode")
    peak_gb = max(s["peak_gb"] for s in steps)
    by_phase = {}
    for phase in ("critic", "student"):
        mine = [s for s in steps if s["phase"] == phase]
        by_phase[phase] = {"step_s": [s["step_s"] for s in mine], "n_steps": [s["n_steps"] for s in mine],
                           "peak_gb": max(s["peak_gb"] for s in mine)}
    log(f"  {DISTILL_ITERS} iterations in {total_s:.1f} s (with the host's mock data and VAE encode); peak device "
        f"memory {peak_gb:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; by phase "
        f"{by_phase}")
    del state, trainer, student, teacher, fake, vae
    return {"counts": counts, "steps": steps, "peak_gb": peak_gb, "nets_gb": nets_gb, "total_s": total_s,
            "by_phase": by_phase, "profile": probe.profile}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help; no options
    t_start = time.perf_counter()

    with Phase("environment"):
        smi = environment()
    import torch

    # the plain references compute in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cosmos_predict2_tpu_torch import _build

    with Phase("build"):
        t = time.perf_counter()
        _build.library()
        log(f"  kernels built and loaded in {time.perf_counter() - t:.2f} s: {_build.library_path()}")
        kernel_resources()
    results: dict = {}
    with Phase("kernels vs plain versions"):
        check_kernels(results)
    with Phase("forward mode: flash_attention_fwdmode under torch.func.jvp and forward_ad (K1 + K9)"):
        fm = fwdmode_slice()
    with Phase("forward mode: scripts/fa_jvp.py at B1 S8320 H16"):
        fj = fa_jvp_slice()
    with Phase("small reference: card bf16 vs cpu fp32, dense and sparse, and the dmd2 sampler"):
        small_reference(sparse=False)
        small_reference(sparse=True)
        small_reference(sparse=False, sampler="dmd2")
    with Phase("serving slice: text2world, image2world, video2world"):
        sl = serve_slice(DENSE_EXPERIMENT, ("text2world", "image2world", "video2world"))
    log(f"  served 3 requests in {sl['serve_s']:.2f} s; peak device memory {sl['peak_gb']:.2f} GiB")
    with Phase("sparse serving slice: video2world on the sparse 2B DiT"):
        ssl = serve_slice(SPARSE_EXPERIMENT, ("video2world",))
    log(f"  served 1 request in {ssl['serve_s']:.2f} s; peak device memory {ssl['peak_gb']:.2f} GiB")
    with Phase("dmd2 serving slice: one 4-step request through Inference on the 2B student"):
        dsl = dmd2_serve_slice()
    log(f"  served 1 dmd2 request in {dsl['request_s']:.2f} s; peak device memory {dsl['peak_gb']:.2f} GiB")
    with Phase("small training reference: card bf16 vs cpu fp32, dense and sparse, and a DMD2 student and critic step"):
        small_train_reference(sparse=False)
        small_train_reference(sparse=True)
        small_distill_reference()
    with Phase("training slice: 2B DiT through training/train.py launch"):
        tr = train_slice(DENSE_EXPERIMENT, TRAIN_TIMED_STEPS)
    with Phase("sparse training slice: sparse 2B DiT through training/train.py launch"):
        stl = train_slice(SPARSE_EXPERIMENT, SPARSE_TRAIN_TIMED_STEPS)
    with Phase("distillation slice: DMD2 on the 2B student, teacher and fake-score nets"):
        dtl = distill_slice()
    with Phase("small interactive reference: card bf16 vs cpu fp32, K5 and K6"):
        small_stream_reference()
    with Phase("interactive slice: causal 2B DiT streaming at 352x640, dense cache (K5)"):
        it = interactive_slice(-1, run_measure=True)
    with Phase(f"interactive slice: causal 2B DiT streaming at 352x640, {INTERACTIVE_WINDOW}-row window (K6)"):
        itw = interactive_slice(INTERACTIVE_WINDOW, run_measure=False)
    paths = {"serve": sl, "train": tr, "sparse_serve": ssl, "sparse_train": stl, "interactive": it,
             "interactive_window": itw, "fwdmode": fm, "fa_jvp": fj, "dmd2_serve": dsl, "distill": dtl}
    path_kernels = {
        "serve": ("flash_attention_fwd", "conv3d_causal"),
        "train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal"),
        "sparse_serve": ("flash_attention_fwd", "na_fwd", "conv3d_causal"),
        "sparse_train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "na_fwd",
                         "na_bwd_dq", "na_bwd_dkv", "conv3d_causal"),
        "interactive": ("flash_attention_fwd", "flash_attention_kv_cache"),
        "interactive_window": ("flash_attention_fwd", "flash_attention_kv_cache_window"),
        "fwdmode": ("flash_attention_fwd", "flash_attention_jvp"),
        "fa_jvp": ("flash_attention_fwd", "flash_attention_jvp"),
        "dmd2_serve": ("flash_attention_fwd", "conv3d_causal"),
        "distill": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal"),
    }
    for path, names in path_kernels.items():
        idle = [n for n in names if paths[path]["counts"][n] == 0]
        if idle:
            raise AssertionError(f"the {path} path never launched {idle}")
    reference = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cosmos_predict2_tpu"))
    if reference:
        raise AssertionError(f"the port's paths imported JAX or the JAX package: {reference}")

    # the main-shape cases whose times go into the JSON line; launches are
    # the sparse training slice's (it runs the seven earlier kernels) and,
    # for K5 and K6, the interactive slices', with each path's counts beside them
    na_smoke = next(c["case"] for c in results["na_fwd"]["cases"] if c["case"].startswith("smoke"))
    main_case = {
        "flash_attention_fwd": "self  B2 S5760 H16 (smoke geometry)",
        "flash_attention_bwd_dq": "self  B1 S5760 H16 (smoke geometry)",
        "flash_attention_bwd_dkv": "self  B1 S5760 H16 (smoke geometry)",
        "conv3d_causal": "dec T8 192x320 96->96 (smoke)",
        "na_fwd": na_smoke,
        "na_bwd_dq": na_smoke,
        "na_bwd_dkv": na_smoke,
        "flash_attention_kv_cache": next(c["case"] for c in results["flash_attention_kv_cache"]["cases"]
                                         if c["case"].startswith("352x640 steady")),
        "flash_attention_kv_cache_window": next(c["case"] for c in results["flash_attention_kv_cache_window"]["cases"]
                                                if c["case"].startswith("352x640 steady")),
        "flash_attention_jvp": "B1 S8320 H16 (fa_jvp shape)",
    }
    source = {
        "flash_attention_fwd": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                "cosmos_predict2_tpu/ops/flash_attention.py:91"),
        "flash_attention_bwd_dq": ("cosmos_predict2_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "cosmos_predict2_tpu/ops/flash_attention.py:586"),
        "flash_attention_bwd_dkv": ("cosmos_predict2_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "cosmos_predict2_tpu/ops/flash_attention.py:632"),
        "conv3d_causal": ("cosmos_predict2_tpu_torch/csrc/conv3d_causal.cu", "cosmos_predict2_tpu/ops/conv3d.py:284"),
        "na_fwd": ("cosmos_predict2_tpu_torch/csrc/neighborhood_attention.cu",
                   "cosmos_predict2_tpu/ops/neighborhood_attention.py:377"),
        "na_bwd_dq": ("cosmos_predict2_tpu_torch/csrc/neighborhood_attention.cu",
                      "cosmos_predict2_tpu/ops/neighborhood_attention.py:425"),
        "na_bwd_dkv": ("cosmos_predict2_tpu_torch/csrc/neighborhood_attention.cu",
                       "cosmos_predict2_tpu/ops/neighborhood_attention.py:461"),
        "flash_attention_kv_cache": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                     "cosmos_predict2_tpu/ops/flash_attention.py:211"),
        "flash_attention_kv_cache_window": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                            "cosmos_predict2_tpu/ops/flash_attention.py:375"),
        "flash_attention_jvp": ("cosmos_predict2_tpu_torch/csrc/flash_attention_jvp.cu",
                                "cosmos_predict2_tpu/ops/flash_attention_jvp.py:45"),
    }
    launch_path = {"flash_attention_kv_cache": it, "flash_attention_kv_cache_window": itw, "flash_attention_jvp": fj}
    kernels = []
    for name, (src, replaces) in source.items():
        case = next(c for c in results[name]["cases"] if c["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launch_path.get(name, stl)["counts"][name],
            "launches_by_path": {path: out["counts"][name] for path, out in paths.items()},
            "max_abs_err": results[name]["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            # a yardstick that could not run gives null and its reason
            "library_ms": case["library_ms"] if isinstance(case["library_ms"], float) else None,
            **({} if isinstance(case["library_ms"], float) else {"library_note": case["library_ms"]}),
            **({"library_backend": case["library_backend"]} if "library_backend" in case else {}),
        })
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
