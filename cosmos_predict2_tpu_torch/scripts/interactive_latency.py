"""Interactive (KV-cache streaming) block latency of the causal 2B DiT.

Counterpart of the JAX repository's scripts/interactive_latency.py
(``measure``, ``main``): the per-frame-block latency of the causal KV-cache
streaming generator (models/interactive.py ``StreamingInference``) with the
4-step student at the 2B widths (2048 channels, 28 blocks, 16 heads of
128), on seeded random weights. One latent frame is 4 pixel frames at 16
fps, so real time means at least 4 latent frames per second.

    python -m cosmos_predict2_tpu_torch.scripts.interactive_latency [--hw 44 80] [--blocks 8]
        [--cache-frames 16] [--frames-per-block 1] [--cache-window 7] [--tiny] [--device cuda]

``--cache-window`` > 0 takes the row-windowed cache decode (K6) with that
many visible key rows per query; otherwise the dense cache decode (K5).
``--tiny`` takes a narrow net (the widths of the JAX package's ``test``
preset, fp32). The script runs on the card unless ``--device cpu`` is
given; the context-parallel options of the JAX script wait for the port's
multi-GPU work.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models.interactive import (
    CausalVideo2WorldModel,
    StreamingConfig,
    StreamingInference,
    causal_model_config,
)
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, build_dit, cast_matmul_weights

# the causal 2B DiT of the JAX script's measure (widths of predict2_interactive_2b_causal)
NET_2B = DiTConfig(
    model_channels=2048,
    num_heads=16,
    num_blocks=28,
    use_adaln_lora=True,
    rope_h_extrapolation_ratio=3.0,
    rope_w_extrapolation_ratio=3.0,
    rope_enable_fps_modulation=False,
    dtype=torch.bfloat16,
    remat="none",
    temporal_causal=True,
)
# the widths of the JAX package's DiT "test" preset
NET_TINY = DiTConfig(
    model_channels=384, num_heads=3, num_blocks=2, adaln_lora_dim=32, temporal_causal=True, dtype=torch.float32,
    remat="none",
)
TEXT_LEN = 512


def build_stream(
    net_cfg: DiTConfig, frames_per_block: int, cache_frames: int, num_steps: int, cache_window_rows: int,
    device: torch.device | str, seed: int = 0,
) -> StreamingInference:
    """The causal model on seeded random weights (its matmul weights stored
    in the net's dtype) inside a StreamingInference."""
    if cache_window_rows > 0:
        net_cfg = dataclasses.replace(net_cfg, cache_na_window_rows=cache_window_rows)
    cfg = causal_model_config(net_cfg, num_frame_per_block=frames_per_block)
    net = cast_matmul_weights(build_dit(cfg.net, device, seed=seed))
    scfg = StreamingConfig(num_frame_per_block=frames_per_block, cache_frame_size=cache_frames, num_steps=num_steps)
    return StreamingInference(scfg, CausalVideo2WorldModel(cfg, net))


def text_condition(stream: StreamingInference, device: torch.device | str):
    """A constant 512-token text embedding (as the JAX script's)."""
    dim = stream.model.config.net.crossattn_emb_channels
    return make_condition(torch.full((1, TEXT_LEN, dim), 0.01, device=device).to(stream.model.config.net.dtype))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(
    hw: tuple[int, int] = (44, 80),
    blocks: int = 8,
    cache_frames: int = 16,
    net_cfg: DiTConfig | None = None,
    num_steps: int = 4,
    frames_per_block: int = 1,
    cache_window_rows: int = -1,
    device: torch.device | str = "cuda",
) -> dict:
    """Stream 1 + ``blocks`` frame blocks into an empty cache (no slide, as
    the JAX script) and time the last ``blocks`` of them on the host clock
    after a device sync. Returns {"p50_s", "latent_fps", "pixel_fps",
    "laps", "device"}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("interactive_latency: no CUDA device (pass --device cpu to run on the CPU)")
    net_cfg = net_cfg or NET_2B
    h, w = hw
    nb = frames_per_block
    if (blocks + 1) * nb > cache_frames + nb:
        raise ValueError(f"{blocks + 1} blocks of {nb} frames overflow a {cache_frames} + {nb}-frame cache")
    print(f"[stream] causal net ({net_cfg.model_channels} ch, {net_cfg.num_blocks} blocks), "
          f"latent frame {h}x{w}, cache {cache_frames} + {nb} frames ...", flush=True)
    stream = build_stream(net_cfg, nb, cache_frames, num_steps, cache_window_rows, device)
    cond = text_condition(stream, device)
    caches = stream.model.init_kv_caches(1, cache_frames + nb, h, w, device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (1, stream.model.config.state_ch, nb, h, w)

    t0 = time.perf_counter()
    x, caches = stream.generate_block(torch.randn(shape, generator=gen, device=device), cond, caches, 0)
    sync(device)
    print(f"[stream] first block (warm-up included): {time.perf_counter() - t0:.1f} s", flush=True)
    laps = []
    for i in range(blocks):
        noise = torch.randn(shape, generator=gen, device=device)
        sync(device)
        t0 = time.perf_counter()
        x, caches = stream.generate_block(noise, cond, caches, (i + 1) * nb)
        sync(device)
        laps.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("the streamed block is not finite")
    p50 = float(np.median(laps))
    lfps = nb / p50
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    window = f" window {cache_window_rows} rows" if cache_window_rows > 0 else ""
    print(
        f"[stream] RESULT latent {h}x{w} nb={nb} cache={cache_frames}{window} on {name}: p50 block latency "
        f"{p50 * 1e3:.1f} ms -> {lfps:.2f} latent frames/s = {4 * lfps:.1f} pixel fps "
        f"(real-time 16 fps needs 4 latent f/s: {'YES' if 4 * lfps >= 16 else 'no'})",
        flush=True,
    )
    return {"p50_s": p50, "latent_fps": lfps, "pixel_fps": 4 * lfps, "laps": laps, "device": name}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(44, 80),
                    help="latent h w: 44 80 = 352x640, 88 160 = 720p (use --cache-frames <= 8), 32 32 = 256x256")
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--cache-frames", type=int, default=16)
    ap.add_argument("--frames-per-block", type=int, default=1)
    ap.add_argument("--cache-window", type=int, default=-1,
                    help="visible key rows per query in every cached frame (e.g. 7 at 352x640); -1: dense")
    ap.add_argument("--tiny", action="store_true", help="a narrow net (the JAX test preset's widths, fp32)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return measure(
        tuple(args.hw), args.blocks, args.cache_frames, net_cfg=NET_TINY if args.tiny else None,
        frames_per_block=args.frames_per_block, cache_window_rows=args.cache_window, device=args.device,
    )


if __name__ == "__main__":
    main()
