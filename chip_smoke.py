#!/usr/bin/env python3
"""Drive the PyTorch port's Video2World serving path once on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed with its wall time:

1. environment: refuses to run without CUDA; prints the card's name and
   power limit (nvidia-smi) and the torch, CUDA and nvcc versions;
2. build: compiles the hand-written kernels (cosmos_predict2_tpu_torch/csrc)
   with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version (fp32, TF32 off)
   on bf16 inputs at the main path's shapes, with max-abs and relative-L2
   error and CUDA-event times;
4. small reference: a narrow pipeline (2 blocks, VAE dim 64) on the card
   against the same weights run in fp32 on the CPU through the plain
   versions;
5. slice: the full-width 2B DiT and full-width Wan2.1 VAE on seeded random
   weights serve a Text2World, an Image2World and a Video2World request
   (93 frames at 192x320, 35 UniPC steps, CFG guidance 7) through
   Video2WorldInference; checks the outputs and that both kernels ran, and
   that flash attention ran 2 x 28 times per DiT forward.

Then it prints the kernels' JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# Relative L2 error allowed between a kernel and its plain version: bf16
# inputs and a bf16 output (one rounding, ~4e-3 relative), fp32 sums taken
# in another order.
KERNEL_REL_L2 = 1e-2
# Relative L2 error allowed between the small pipeline in bf16 on the card
# and in fp32 on the CPU: bf16 rounding through 2 DiT blocks, 2 UniPC steps
# and the VAE gives 0.026 on the CPU (bf16 vs fp32, same weights); 3x margin.
PIPELINE_REL_L2 = 8e-2
NUM_BLOCKS = 28
SIZE = (192, 320)
NUM_FRAMES = 93
NUM_STEPS = 35
GUIDANCE = 7.0


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


def check_kernels(results: dict) -> None:
    import torch

    from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv3d_causal_plain
    from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []

    def record(kernel, label, max_abs, rel, ms, plain_ms):
        ok = rel <= KERNEL_REL_L2
        log(f"  {kernel:20s} {label:44s} max_abs {max_abs:.3e} rel_l2 {rel:.3e} kernel {ms:9.3f} ms "
            f"plain {plain_ms if isinstance(plain_ms, str) else f'{plain_ms:9.3f} ms'} {'ok' if ok else 'FAIL'}")
        entry = results.setdefault(kernel, {"max_abs_err": 0.0, "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        entry["cases"].append({"case": label, "max_abs": max_abs, "rel_l2": rel, "ms": ms, "plain_ms": plain_ms})
        if not ok:
            failures.append(f"{kernel} {label}: rel_l2 {rel:.3e} > {KERNEL_REL_L2}")

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
        torch.cuda.synchronize()
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
        log(f"  {'':20s} lse max_abs {lse_abs:.3e}")
        if not lse_abs < 1e-2:
            failures.append(f"flash_attention_fwd {label}: lse max_abs {lse_abs:.3e}")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, frame_group=fg))
        record("flash_attention_fwd", label, max_abs, rel, ms, plain_ms)
        del q, k, v, out, lse, ref, ref_lse, got, got_lse
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
        out = conv3d_causal(x, w, b)
        torch.cuda.synchronize()
        ref = conv3d_causal_plain(x, w, b, out_dtype=torch.float32)
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: conv3d_causal(x, w, b))
        plain_ms = cuda_ms(lambda: conv3d_causal_plain(x, w, b))
        record("conv3d_causal", label, max_abs, rel, ms, plain_ms)
        del x, w, b, out, ref
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel checks failed:\n  " + "\n  ".join(failures))


def small_reference() -> None:
    """A narrow pipeline on the card (bf16, kernels) against the same weights
    in fp32 on the CPU (plain versions)."""
    import torch

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference, image_to_input
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config("predict2_video2world_2b_rectified_flow")
    net_cfg = dataclasses.replace(
        cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
        crossattn_proj_in_channels=64, crossattn_emb_channels=128,
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
    got = pipe.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=1)
    ref = pipe32.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=1)
    max_abs = float(np.abs(got - ref).max())
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"  card bf16 vs cpu fp32: shape {got.shape} max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit {PIPELINE_REL_L2})")
    if not (got.shape == ref.shape == (9, 64, 64, 3) and np.isfinite(got).all() and rel <= PIPELINE_REL_L2):
        raise AssertionError(f"small pipeline disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")


def serve_slice() -> dict:
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import (
        InferenceSetup, Video2WorldInference, image_to_input, video_to_input,
    )
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config("predict2_video2world_2b_rectified_flow")
    if cfg.model.net.num_blocks != NUM_BLOCKS or cfg.model.net.model_channels != 2048:
        raise AssertionError("the slice must run the full-width 2B DiT")
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
    if counts["flash_attention_fwd"] != 2 * NUM_BLOCKS * forwards:
        raise AssertionError(f"flash_attention_fwd ran {counts['flash_attention_fwd']} times, "
                             f"want 2 x {NUM_BLOCKS} x {forwards}")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran on the main path")
    return {"counts": counts, "serve_s": serve_s, "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help; no options

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
    results: dict = {}
    with Phase("kernels vs plain versions"):
        check_kernels(results)
    with Phase("small reference: card bf16 vs cpu fp32"):
        small_reference()
    with Phase("slice: serve text2world, image2world, video2world"):
        sl = serve_slice()
    counts = sl["counts"]
    log(f"  served 3 requests in {sl['serve_s']:.2f} s; peak device memory {sl['peak_gb']:.2f} GiB")
    reference = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cosmos_predict2_tpu"))
    if reference:
        raise AssertionError(f"the port's path imported JAX or the JAX package: {reference}")

    # the smoke-geometry cases whose times go into the JSON line
    main_case = {"flash_attention_fwd": "self  B2 S5760 H16 (smoke geometry)", "conv3d_causal": "dec T8 192x320 96->96 (smoke)"}
    source = {
        "flash_attention_fwd": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                "cosmos_predict2_tpu/ops/flash_attention.py:91"),
        "conv3d_causal": ("cosmos_predict2_tpu_torch/csrc/conv3d_causal.cu", "cosmos_predict2_tpu/ops/conv3d.py:284"),
    }
    kernels = []
    for name, (src, replaces) in source.items():
        case = next(c for c in results[name]["cases"] if c["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": counts[name],
            "max_abs_err": results[name]["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
