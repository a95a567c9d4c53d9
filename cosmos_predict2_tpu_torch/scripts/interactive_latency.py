"""Interactive (KV-cache streaming) block latency of the causal 2B DiT.

Counterpart of the JAX repository's scripts/interactive_latency.py
(``measure``, ``main``): the per-frame-block latency of the causal KV-cache
streaming generator (models/interactive.py ``StreamingInference``) with the
4-step student at the 2B widths (2048 channels, 28 blocks, 16 heads of
128), on seeded random weights. One latent frame is 4 pixel frames at 16
fps, so real time means at least 4 latent frames per second.

    python -m cosmos_predict2_tpu_torch.scripts.interactive_latency [--hw 44 80] [--blocks 8]
        [--cache-frames 16] [--frames-per-block 1] [--cache-window 7] [--tiny] [--device cuda]
    torchrun --nproc-per-node 4 -m cosmos_predict2_tpu_torch.scripts.interactive_latency --cp 4 [...]
    python -m cosmos_predict2_tpu_torch.scripts.interactive_latency --cp-proxy --hw 88 160 --cache-frames 8

``--cache-window`` > 0 takes the row-windowed cache decode (K6) with that
many visible key rows per query; otherwise the dense cache decode (K5).
``--tiny`` takes a narrow net (the widths of the JAX package's ``test``
preset, fp32; with ``--cp`` or ``--cp-proxy``, 256 channels in 4 heads,
so that the heads split). The script runs on the card unless ``--device cpu`` is
given (then over gloo with ``--cp``).

``--cp N`` streams context-parallel over the N ranks torchrun starts (one
device each; parallel/launch.py::init_distributed, a mesh of cp = N): every
rank runs the same loop on the same noise, each block's tokens shard over
the ranks and each rank holds a head shard of every cache
(parallel/cp.py::ulysses_kv_cache_attention). ``--cp-proxy`` measures on
one card the pieces of the cp = k block step (:func:`cp_proxy_ladder`, the
JAX script's): the block at (h, w / k) and the head-sharded cache decode
at H / k heads; the all-to-all term is reckoned from its bytes at
``--a2a-gbytes-per-s``, a named bandwidth, never a measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, build_dit, cast_matmul_weights, set_context_parallel
from cosmos_predict2_tpu_torch.ops.flash_attention import kv_cache_attention

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
# with --cp: 4 heads of 64, as the JAX package's CP tests widen the test preset
NET_TINY_CP = dataclasses.replace(NET_TINY, model_channels=256, num_heads=4)
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
    cp_group=None,
    verbose: bool = True,
) -> dict:
    """Stream 1 + ``blocks`` frame blocks into an empty cache (no slide, as
    the JAX script) and time the last ``blocks`` of them on the host clock
    after a device sync. ``cp_group``: stream context-parallel over that
    process group (every rank calls this). Returns {"p50_s", "latent_fps",
    "pixel_fps", "laps", "device"}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("interactive_latency: no CUDA device (pass --device cpu to run on the CPU)")
    say = print if verbose else (lambda *a, **k: None)
    net_cfg = net_cfg or NET_2B
    h, w = hw
    nb = frames_per_block
    if (blocks + 1) * nb > cache_frames + nb:
        raise ValueError(f"{blocks + 1} blocks of {nb} frames overflow a {cache_frames} + {nb}-frame cache")
    say(f"[stream] causal net ({net_cfg.model_channels} ch, {net_cfg.num_blocks} blocks), "
        f"latent frame {h}x{w}, cache {cache_frames} + {nb} frames ...", flush=True)
    stream = build_stream(net_cfg, nb, cache_frames, num_steps, cache_window_rows, device)
    set_context_parallel(stream.model.net, cp_group)
    cond = text_condition(stream, device)
    caches = stream.model.init_kv_caches(1, cache_frames + nb, h, w, device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (1, stream.model.config.state_ch, nb, h, w)

    t0 = time.perf_counter()
    x, caches = stream.generate_block(torch.randn(shape, generator=gen, device=device), cond, caches, 0)
    sync(device)
    say(f"[stream] first block (warm-up included): {time.perf_counter() - t0:.1f} s", flush=True)
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
    if cp_group is not None:
        window += f" cp={torch.distributed.get_world_size(cp_group)}"
    say(
        f"[stream] RESULT latent {h}x{w} nb={nb} cache={cache_frames}{window} on {name}: p50 block latency "
        f"{p50 * 1e3:.1f} ms -> {lfps:.2f} latent frames/s = {4 * lfps:.1f} pixel fps "
        f"(real-time 16 fps needs 4 latent f/s: {'YES' if 4 * lfps >= 16 else 'no'})",
        flush=True,
    )
    return {"p50_s": p50, "latent_fps": lfps, "pixel_fps": 4 * lfps, "laps": laps, "device": name}


def attention_probe_s(s_q: int, heads: int, s_max: int, fill: int, device: torch.device, d: int = 128,
                      reps: int = 5) -> float:
    """Least time of the cache decode (K5 on the card) of q (1, s_q, heads,
    d) over head-major buffers (1, heads, s_max, d) filled to ``fill``: the
    per-rank attention of the head-sharded decode at heads = H / k. Host
    clock after a device sync, as :func:`measure`."""
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((1, s_q, heads, d), generator=gen, device=device).to(torch.bfloat16)
    kb, vb = (torch.randn((1, heads, s_max, d), generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    kv_cache_attention(q, kb, vb, fill)
    laps = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        kv_cache_attention(q, kb, vb, fill)
        sync(device)
        laps.append(time.perf_counter() - t0)
    return min(laps)


def cp_proxy_ladder(
    hw: tuple[int, int] = (88, 160),
    cache_frames: int = 8,
    blocks: int = 4,
    num_steps: int = 4,
    ks: tuple[int, ...] = (2, 4, 8),
    a2a_gbytes_per_s: float = 450.0,
    net_cfg: DiTConfig | None = None,
    device: torch.device | str = "cuda",
    verbose: bool = True,
) -> list[dict]:
    """The cp = k block step of the streaming decode, from pieces measured
    on one device (the JAX script's ``cp_proxy_ladder``). Under
    ``ulysses_kv_cache_attention`` a rank's program is (a) the DiT's work
    outside self-attention on S_blk / k tokens, (b) the cache decode of the
    whole block with H / k heads, (c) the all-to-alls of the new block.
    (a) is the block step measured at (h, w / k) less its own attention
    (16 heads over a cache of 1 / k the tokens), (b) is measured, (c) is
    reckoned: per layer and forward 3 scatters and 1 gather of the block
    (bf16), each rank moving (k - 1) / k of its share, at
    ``a2a_gbytes_per_s`` (450: the H100 SXM's NVLink per direction, a
    named figure). A block step runs num_steps + 1 forwards (the denoise
    and the commit; the JAX ladder counts num_steps). Rows: {"cp",
    "block_s", "attn_s", "nonattn_s", "a2a_s", "pixel_fps", "measured"}."""
    device = torch.device(device)
    say = print if verbose else (lambda *a, **k: None)
    cfg = net_cfg or NET_2B
    h, w = hw
    heads, d, layers = cfg.num_heads, cfg.head_dim, cfg.num_blocks
    s_blk = (h // cfg.patch_spatial) * (w // cfg.patch_spatial)
    n_attn = layers * (num_steps + 1)
    s_max = fill = (cache_frames + 1) * s_blk  # steady state: the buffer full

    base = measure(hw, blocks=blocks, cache_frames=cache_frames, net_cfg=cfg, num_steps=num_steps, device=device,
                   verbose=False)
    t_attn_1 = attention_probe_s(s_blk, heads, s_max, fill, device, d) * n_attn
    rows = [{"cp": 1, "block_s": base["p50_s"], "attn_s": t_attn_1, "nonattn_s": base["p50_s"] - t_attn_1,
             "a2a_s": 0.0, "pixel_fps": base["pixel_fps"], "measured": "all"}]
    say(f"[cp-proxy] cp=1: block {base['p50_s'] * 1e3:.1f} ms (attention {t_attn_1 * 1e3:.1f} ms)", flush=True)
    for k in ks:
        if w % (cfg.patch_spatial * k) or heads % k:
            raise ValueError(f"cp-proxy: cp={k} needs w={w} divisible by {cfg.patch_spatial * k} and {heads} heads "
                             f"by {k}")
        scaled = measure((h, w // k), blocks=blocks, cache_frames=cache_frames, net_cfg=cfg, num_steps=num_steps,
                         device=device, verbose=False)
        t_attn_scaled = attention_probe_s(s_blk // k, heads, s_max // k, fill // k, device, d) * n_attn
        t_attn_shard = attention_probe_s(s_blk, heads // k, s_max, fill, device, d) * n_attn
        a2a_bytes = 4 * (s_blk // k) * heads * d * 2 * (k - 1) / k * n_attn
        t_a2a = a2a_bytes / (a2a_gbytes_per_s * 1e9)
        nonattn = scaled["p50_s"] - t_attn_scaled
        t_k = nonattn + t_attn_shard + t_a2a
        rows.append({"cp": k, "block_s": t_k, "attn_s": t_attn_shard, "nonattn_s": nonattn, "a2a_s": t_a2a,
                     "pixel_fps": 4.0 / t_k, "measured": f"compute (a2a reckoned at {a2a_gbytes_per_s} GB/s)"})
        say(f"[cp-proxy] cp={k}: block {t_k * 1e3:.1f} ms = outside attention {nonattn * 1e3:.1f} + attention "
            f"{t_attn_shard * 1e3:.1f} + all-to-all {t_a2a * 1e3:.2f} ms -> {4.0 / t_k:.1f} pixel fps", flush=True)
    return rows


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
    ap.add_argument("--cp", type=int, default=1,
                    help="context-parallel degree: run under torchrun --nproc-per-node N (one device a rank)")
    ap.add_argument("--cp-proxy", action="store_true",
                    help="measure the cp=2/4/8 ladder's pieces on one device (cp_proxy_ladder)")
    ap.add_argument("--ks", type=int, nargs="+", default=(2, 4, 8), help="the cp degrees of --cp-proxy")
    ap.add_argument("--a2a-gbytes-per-s", type=float, default=450.0,
                    help="the all-to-all bandwidth --cp-proxy reckons with (a named figure, not measured)")
    args = ap.parse_args(argv)
    net_cfg = (NET_TINY_CP if args.cp > 1 or args.cp_proxy else NET_TINY) if args.tiny else None
    if args.cp_proxy:
        rows = cp_proxy_ladder(tuple(args.hw), cache_frames=args.cache_frames, blocks=args.blocks, ks=tuple(args.ks),
                               a2a_gbytes_per_s=args.a2a_gbytes_per_s, net_cfg=net_cfg, device=args.device)
        print(json.dumps(rows))
        return {"cp_proxy": rows}
    device, group = torch.device(args.device), None
    if args.cp > 1:
        from cosmos_predict2_tpu_torch.parallel.launch import init_distributed, shutdown_distributed
        from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh

        info = init_distributed(device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        group = make_mesh(cp=args.cp, device_type=device.type).get_group("cp")
    try:
        return measure(
            tuple(args.hw), args.blocks, args.cache_frames, net_cfg=net_cfg, frames_per_block=args.frames_per_block,
            cache_window_rows=args.cache_window, device=device, cp_group=group,
            verbose=group is None or info["process_index"] == 0,
        )
    finally:
        if group is not None:
            shutdown_distributed()


if __name__ == "__main__":
    main()
