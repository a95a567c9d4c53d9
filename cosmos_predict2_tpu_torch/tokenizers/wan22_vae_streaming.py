"""Streaming (cache-carrying) Wan2.2 VAE encode/decode with O(chunk) memory.

Counterpart of cosmos_predict2_tpu/tokenizers/wan22_vae_streaming.py, on
the Wan2.1 stream's primitives (tokenizers/wan_vae_streaming.py): each
causal 3x3x3 conv carries its last 2 input frames, the stride-2 temporal
downsample 1, the temporal upsample 2; every 3x3x3 conv that passes
``_use_kernel_conv`` goes through K2 (ops/conv3d.conv3d_causal) on the card.
Encode in pixel chunks [1, 4, 4, ...], decode one latent frame at a time;
the tests hold both against JAX's whole-clip ``Wan22VAE.encode`` /
``decode``. K2 takes one sample at a time, so each entry point runs the
batch's samples one after another.

The macro blocks' shortcuts need no state: avg_down_3d front-pads T to a
multiple of 2, which only a first chunk of odd length needs and which
gives the full clip's (0 + f0) / 2 first output; dup_up_3d drops its first
frame on the stream's first chunk only, as the conv path's frame 0
bypasses the temporal upsample.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from cosmos_predict2_tpu_torch.tokenizers.wan22_vae import (
    WAN22_LATENT_MEAN,
    WAN22_LATENT_STD,
    Wan22VAE,
    Wan22VAEConfig,
    avg_down_3d,
    decoder_dims,
    dup_up_3d,
    encoder_dims,
    patchify,
    stage_temporal,
    unpatchify,
)
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import upsample2x_conv3x3
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import (
    CACHE_T,
    StreamState,
    _attn_block,
    _conv2d,
    _conv3d,
    _norm,
    _per_sample,
    _stream_conv,
    _stream_resblock,
    _zeros_cache,
)


def _latent_stats(device):
    mean = torch.tensor(WAN22_LATENT_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(WAN22_LATENT_STD, dtype=torch.float32, device=device)
    return mean, std


# ------------------------------- encoder -------------------------------


def init_encoder_state(cfg: Wan22VAEConfig, batch: int, height: int, width: int, dtype, device) -> StreamState:
    dims = encoder_dims(cfg)
    zc = lambda h, w, c, frames=CACHE_T: _zeros_cache(batch, h, w, c, dtype, device, frames)  # noqa: E731
    h, w = height // cfg.patch_size, width // cfg.patch_size
    caches: dict[str, Any] = {"conv1": zc(h, w, 3 * cfg.patch_size**2)}
    for s, (in_d, out_d) in enumerate(zip(dims[:-1], dims[1:])):
        d = in_d
        for j in range(cfg.num_res_blocks):
            caches[f"down_{s}.res_{j}.c1"] = zc(h, w, d)
            caches[f"down_{s}.res_{j}.c2"] = zc(h, w, out_d)
            d = out_d
        if s != len(cfg.dim_mult) - 1:
            h, w = h // 2, w // 2
            if stage_temporal(cfg, s, False):
                caches[f"down_{s}.t"] = zc(h, w, out_d, 1)
    for key in ("mid_res1", "mid_res2"):
        caches[f"{key}.c1"] = zc(h, w, dims[-1])
        caches[f"{key}.c2"] = zc(h, w, dims[-1])
    caches["head"] = zc(h, w, dims[-1])
    return StreamState(caches=caches, first=True)


def encoder_chunk(vae: Wan22VAE, x_chunk: torch.Tensor, state: StreamState):
    """x (B, T, H, W, 3) -> latents (B, t, H/16, W/16, 48): the stream's
    first chunk 1 frame (t = 1), each later one 4k (t = k)."""
    cfg = vae.config
    enc = vae.encoder
    dt = cfg.dtype
    caches = dict(state.caches)
    first = state.first
    dims = encoder_dims(cfg)

    x = patchify(x_chunk, cfg.patch_size)
    x, caches["conv1"] = _stream_conv(enc.conv1, x, caches["conv1"], dt)
    for s, stage in enumerate(enc.downsamples):
        temporal = stage_temporal(cfg, s, False)
        down = s != len(cfg.dim_mult) - 1
        shortcut = avg_down_3d(x, dims[s + 1], factor_t=2 if temporal else 1, factor_s=2 if down else 1)
        h = x
        for j in range(cfg.num_res_blocks):
            h = _stream_resblock(stage.downsamples[j], h, caches, f"down_{s}.res_{j}", dt)
        if down:
            rs = stage.downsamples[cfg.num_res_blocks]
            h = _conv2d(rs.resample[1], h, stride=(2, 2), padding=((0, 1), (0, 1)), dtype=dt)
            if temporal:
                key = f"down_{s}.t"
                if first:  # frame 0 bypasses the stride-2 temporal conv
                    caches[key] = h
                else:
                    hin = torch.cat([caches[key].to(h.dtype), h], dim=1)
                    caches[key] = hin[:, -1:]
                    h = _conv3d(rs.time_conv, hin, stride=(2, 1, 1), spatial_pad=0, dtype=dt)
        x = h + shortcut.to(h.dtype)
    mid_res1, mid_attn, mid_res2 = enc.middle
    x = _stream_resblock(mid_res1, x, caches, "mid_res1", dt)
    x = _attn_block(mid_attn, x, dt)
    x = _stream_resblock(mid_res2, x, caches, "mid_res2", dt)
    y = F.silu(_norm(enc.head[0], x))
    y, caches["head"] = _stream_conv(enc.head[2], y, caches["head"], dt)
    out = _conv3d(vae.conv1, y, spatial_pad=0, dtype=dt)
    mean, std = _latent_stats(out.device)
    z = ((out[..., : cfg.z_dim].float() - mean) / std).to(x_chunk.dtype)
    return z, StreamState(caches=caches, first=False)


@torch.no_grad()
def encode_streaming(vae: Wan22VAE, x: torch.Tensor, chunk_frames: int = 4) -> torch.Tensor:
    """(B, 1 + 4k, H, W, 3) pixels in [-1, 1] -> (B, 1 + k, H/16, W/16, 48)
    normalized latents, in chunks [1, chunk_frames, ...]."""
    if chunk_frames % 4:
        raise ValueError(f"chunk_frames must be a multiple of 4, got {chunk_frames}")
    cfg = vae.config

    def one(xb):
        _, T, H, W, _ = xb.shape
        z, state = encoder_chunk(vae, xb[:, :1], init_encoder_state(cfg, 1, H, W, cfg.dtype, xb.device))
        outs = [z]
        for pos in range(1, T, chunk_frames):
            z, state = encoder_chunk(vae, xb[:, pos: pos + chunk_frames], state)
            outs.append(z)
        return torch.cat(outs, dim=1)

    return _per_sample(one, x)


# ------------------------------- decoder -------------------------------


def init_decoder_state(cfg: Wan22VAEConfig, batch: int, latent_h: int, latent_w: int, dtype, device) -> StreamState:
    dims = decoder_dims(cfg)
    zc = lambda h, w, c: _zeros_cache(batch, h, w, c, dtype, device)  # noqa: E731
    h, w = latent_h, latent_w
    caches: dict[str, Any] = {"conv1": zc(h, w, cfg.z_dim)}
    for key in ("mid_res1", "mid_res2"):
        caches[f"{key}.c1"] = zc(h, w, dims[0])
        caches[f"{key}.c2"] = zc(h, w, dims[0])
    for s, (in_d, out_d) in enumerate(zip(dims[:-1], dims[1:])):
        d = in_d
        for j in range(cfg.num_res_blocks + 1):
            caches[f"up_{s}.res_{j}.c1"] = zc(h, w, d)
            caches[f"up_{s}.res_{j}.c2"] = zc(h, w, out_d)
            d = out_d
        if s != len(cfg.dim_mult) - 1:
            if stage_temporal(cfg, s, True):
                caches[f"up_{s}.t"] = zc(h, w, out_d)
            h, w = h * 2, w * 2
    caches["head"] = zc(h, w, dims[-1])
    return StreamState(caches=caches, first=True)


def decoder_chunk(vae: Wan22VAE, z_chunk: torch.Tensor, state: StreamState):
    """z (B, k, h, w, 48) -> pixels (unclipped [-1, 1]): 1 + 4(k - 1) frames
    for the stream's first chunk, 4k for each later one."""
    cfg = vae.config
    dec = vae.decoder
    dt = cfg.dtype
    caches = dict(state.caches)
    first = state.first
    dims = decoder_dims(cfg)

    mean, std = _latent_stats(z_chunk.device)
    zin = (z_chunk.float() * std + mean).to(dt)
    x = _conv3d(vae.conv2, zin, spatial_pad=0, dtype=dt)
    x, caches["conv1"] = _stream_conv(dec.conv1, x, caches["conv1"], dt)
    mid_res1, mid_attn, mid_res2 = dec.middle
    x = _stream_resblock(mid_res1, x, caches, "mid_res1", dt)
    x = _attn_block(mid_attn, x, dt)
    x = _stream_resblock(mid_res2, x, caches, "mid_res2", dt)

    for s, stage in enumerate(dec.upsamples):
        temporal = stage_temporal(cfg, s, True)
        h = x
        for j in range(cfg.num_res_blocks + 1):
            h = _stream_resblock(stage.upsamples[j], h, caches, f"up_{s}.res_{j}", dt)
        if s == len(cfg.dim_mult) - 1:
            x = h
            continue
        rs = stage.upsamples[cfg.num_res_blocks + 1]
        if temporal:
            # "Rep": the stream's frame 0 bypasses the doubling conv
            head, rest = (h[:, :1], h[:, 1:]) if first else (h[:, :0], h)
            if rest.shape[1]:
                B, T, Hh, Ww, C = rest.shape
                key = f"up_{s}.t"
                hin = torch.cat([caches[key].to(h.dtype), rest], dim=1)
                caches[key] = hin[:, -CACHE_T:]
                zt = _conv3d(rs.time_conv, hin, spatial_pad=0, dtype=dt).reshape(B, T, Hh, Ww, 2, C)
                # channels [0, C) -> even output frame, [C, 2C) -> odd frame
                h = torch.cat([head, zt.permute(0, 1, 4, 2, 3, 5).reshape(B, 2 * T, Hh, Ww, C)], dim=1)
        conv = rs.resample[1]
        h = upsample2x_conv3x3(conv.weight, conv.bias, h, dt)
        shortcut = dup_up_3d(x, dims[s + 1], factor_t=2 if temporal else 1, factor_s=2, first_chunk=first)
        x = h + shortcut.to(h.dtype)

    y = F.silu(_norm(dec.head[0], x))
    y, caches["head"] = _stream_conv(dec.head[2], y, caches["head"], dt)
    return unpatchify(y, cfg.patch_size), StreamState(caches=caches, first=False)


@torch.no_grad()
def decode_streaming(vae: Wan22VAE, z: torch.Tensor, chunk_latent_frames: int = 1) -> torch.Tensor:
    """(B, t, h, w, 48) latents -> (B, 1 + 4(t - 1), 16h, 16w, 3) pixels in
    [-1, 1] (unclipped), the VAE's dtype: the first chunk one latent frame,
    then chunks of ``chunk_latent_frames``."""
    cfg = vae.config

    def one(zb):
        _, t, h, w, _ = zb.shape
        px, state = decoder_chunk(vae, zb[:, :1], init_decoder_state(cfg, 1, h, w, cfg.dtype, zb.device))
        outs = [px]
        for pos in range(1, t, chunk_latent_frames):
            px, state = decoder_chunk(vae, zb[:, pos: pos + chunk_latent_frames], state)
            outs.append(px)
        return torch.cat(outs, dim=1)

    return _per_sample(one, z)

