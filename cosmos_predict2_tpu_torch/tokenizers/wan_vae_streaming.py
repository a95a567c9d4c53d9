"""Streaming (cache-carrying) Wan VAE encode/decode with O(chunk) memory.

Counterpart of cosmos_predict2_tpu/tokenizers/wan_vae_streaming.py: encode
in pixel chunks [1, 4, 4, ...], decode in latent chunks [1, k, k, ...]; each
causal 3x3x3 conv carries its last 2 input frames across chunks, the
stride-2 temporal downsample carries 1 frame, the temporal upsample carries
2 ("Rep": the first latent frame bypasses it and leaves zero history).
Streaming is exact for any chunk size. Activations are channels-last
(B, T, H, W, C).

The causal 3x3x3 convs with at least 64 channels on both sides go through
ops/conv3d.conv3d_causal (the Hopper kernel on a CUDA tensor), one sample
of a batch at a time (the kernel takes batch 1); thin convs
(the RGB input conv, the latent-side convs, the heads), 1x1x1, (3,1,1) and
2D convs are plain torch. uint8 input is normalized on the device; uint8
output is quantized on the device.

Spatially sharded (``grid``, a parallel/halo_conv.py::SpatialGrid: H over
one process group, W over another): every function takes and returns this
rank's (H / gh, W / gw) slab. Each causal 3x3x3 conv takes a 1-row and
1-column halo from its neighbours (zeros at the clip's border) and runs on
the halo'd slab: the kernel (which pads H and W by 1 itself) then crops the
border, a plain conv runs VALID. The stride-2 downsampling convs take the
right and bottom halo only, the upsampling conv a 1-pixel halo before the
upsample (cropped by 2 after it); 1x1x1 and temporal convs and the norms are
local; the middle attention block all-gathers the frame for its keys and
values. The per-rank frame caches hold the rank's slab and stay local.
The JAX package gets the same function from GSPMD (tests/test_vae_sharded.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv_weight_taps
from cosmos_predict2_tpu_torch.ops.normalization import channel_l2_norm
from cosmos_predict2_tpu_torch.parallel.halo_conv import SpatialGrid, halo_hw
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import (
    WAN_LATENT_MEAN,
    WAN_LATENT_STD,
    WanVAE,
    WanVAEConfig,
    decoder_dims,
    encoder_dims,
    upsample2x_conv3x3,
)

CACHE_T = 2
# Causal 3x3x3 convs take the kernel when min(Cin, Cout) >= this (thin
# convs waste the tensor-core tile) and both widths are multiples of 16 (the
# kernel's requirement), so nothing this gate sends to the kernel raises.
_KERNEL_MIN_CH = 64


def _use_kernel_conv(xin: torch.Tensor, conv: nn.Conv3d) -> bool:
    cout, cin = conv.weight.shape[:2]
    return (
        tuple(conv.weight.shape[2:]) == (3, 3, 3)
        and xin.shape[0] == 1
        and min(cin, cout) >= _KERNEL_MIN_CH
        and cin % 16 == 0
        and cout % 16 == 0
    )


# ----------------------------- primitive ops -----------------------------


def _conv3d(conv: nn.Conv3d, x: torch.Tensor, stride=(1, 1, 1), spatial_pad: int = 1, dtype=torch.bfloat16):
    """Conv3d on channels-last x, valid in time, computed and returned in dtype."""
    xc = x.to(dtype).permute(0, 4, 1, 2, 3)
    out = F.conv3d(xc, conv.weight.to(dtype), None, stride=stride, padding=(0, spatial_pad, spatial_pad))
    return out.permute(0, 2, 3, 4, 1) + conv.bias.to(dtype)


def _conv2d(conv: nn.Conv2d, x: torch.Tensor, stride=(1, 1), padding=((1, 1), (1, 1)), dtype=torch.bfloat16):
    """Per-frame Conv2d on channels-last (B, T, H, W, C)."""
    B, T = x.shape[:2]
    xf = x.reshape((B * T,) + x.shape[2:]).to(dtype).permute(0, 3, 1, 2)
    (top, bottom), (left, right) = padding
    xf = F.pad(xf, (left, right, top, bottom))
    out = F.conv2d(xf, conv.weight.to(dtype), None, stride=stride).permute(0, 2, 3, 1) + conv.bias.to(dtype)
    return out.reshape((B, T) + out.shape[1:])


def _norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return channel_l2_norm(x, norm.gamma.reshape(-1))


def kernel_weight(conv: nn.Conv3d, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv's weight as conv3d_causal takes it: a DHWIO view and the
    kernel's (27, Cout, Cin) layout. The layout is made once and kept on the
    module; an in-place change of the weight (its ``_version``), a new
    tensor or another dtype makes it anew."""
    w = conv.weight.detach().to(dtype).permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO view
    key = (conv.weight.data_ptr(), conv.weight._version, conv.weight.device, dtype)
    cached = conv.__dict__.get("_kernel_weight")
    if cached is None or cached[0] != key:
        cached = (key, conv_weight_taps(w))
        conv.__dict__["_kernel_weight"] = cached
    return w, cached[1]


def _stream_conv(conv: nn.Conv3d, x: torch.Tensor, cache: torch.Tensor, dtype: torch.dtype,
                 grid: SpatialGrid | None = None):
    """Causal k_t = 3 conv with a 2-frame input cache (zeros at stream start)."""
    xin = torch.cat([cache.to(x.dtype), x], dim=1)
    xh = xin if grid is None else halo_hw(xin, grid, 1, 1)
    if _use_kernel_conv(xin[:1], conv):  # a batch goes through the kernel one sample at a time
        w, w_taps = kernel_weight(conv, dtype)
        out = _per_sample(lambda xb: conv3d_causal(xb.to(dtype).contiguous(), w, conv.bias, out_dtype=dtype,
                                                   w_taps=w_taps), xh)
        if grid is not None:
            out = out[:, :, 1:-1, 1:-1]
    else:
        out = _conv3d(conv, xh, spatial_pad=1 if grid is None else 0, dtype=dtype)
    return out, xin[:, -CACHE_T:]


def _zeros_cache(batch, h, w, c, dtype, device, frames=CACHE_T):
    return torch.zeros((batch, frames, h, w, c), dtype=dtype, device=device)


# ----------------------------- res / attn -----------------------------


def _stream_resblock(blk: nn.Module, x: torch.Tensor, caches: dict, key: str, dtype: torch.dtype,
                     grid: SpatialGrid | None = None):
    norm1, _, conv1, norm2, _, _, conv2 = blk.residual
    h = x
    if isinstance(blk.shortcut, nn.Conv3d):
        h = _conv3d(blk.shortcut, x, spatial_pad=0, dtype=dtype)
    y = F.silu(_norm(norm1, x))
    y, caches[f"{key}.c1"] = _stream_conv(conv1, y, caches[f"{key}.c1"], dtype, grid)
    y = F.silu(_norm(norm2, y))
    y, caches[f"{key}.c2"] = _stream_conv(conv2, y, caches[f"{key}.c2"], dtype, grid)
    return y + h


def _attn_block(blk: nn.Module, x: torch.Tensor, dtype: torch.dtype, grid: SpatialGrid | None = None):
    B, T, H, W, C = x.shape
    y = _norm(blk.norm, x)
    no_pad = ((0, 0), (0, 0))
    qkv = _conv2d(blk.to_qkv, y, padding=no_pad, dtype=dtype).reshape(B * T, H * W, 3 * C)
    q, k, v = qkv.chunk(3, dim=-1)
    if grid is not None:  # the slab's queries against the whole frame's keys and values
        whole = _conv2d(blk.to_qkv, grid.gather(y), padding=no_pad, dtype=dtype)
        _, k, v = whole.reshape(B * T, -1, 3 * C).chunk(3, dim=-1)
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) / (C**0.5)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqk,bkc->bqc", probs.to(v.dtype).float(), v.float())
    out = out.to(x.dtype).reshape(B, T, H, W, C)
    return x + _conv2d(blk.proj, out, padding=no_pad, dtype=dtype)


def _latent_stats(device):
    mean = torch.tensor(WAN_LATENT_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(WAN_LATENT_STD, dtype=torch.float32, device=device)
    return mean, std


# ------------------------------- encoder -------------------------------


@dataclasses.dataclass
class StreamState:
    caches: dict[str, Any]
    first: bool  # is the next chunk the stream's first?


def init_encoder_state(cfg: WanVAEConfig, batch: int, height: int, width: int, dtype, device) -> StreamState:
    dims = encoder_dims(cfg)
    zc = lambda h, w, c, frames=CACHE_T: _zeros_cache(batch, h, w, c, dtype, device, frames)
    caches: dict[str, Any] = {"conv1": zc(height, width, 3)}
    h, w = height, width
    li = 0
    for s, (in_d, o_d) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            caches[f"down_{li}.c1"] = zc(h, w, in_d)
            caches[f"down_{li}.c2"] = zc(h, w, o_d)
            in_d = o_d
            li += 1
        if s != len(cfg.dim_mult) - 1:
            h, w = h // 2, w // 2
            if cfg.temporal_downsample[s]:
                caches[f"down_{li}.t"] = zc(h, w, o_d, 1)
            li += 1
    for key in ("mid_res1", "mid_res2"):
        caches[f"{key}.c1"] = zc(h, w, dims[-1])
        caches[f"{key}.c2"] = zc(h, w, dims[-1])
    caches["head"] = zc(h, w, dims[-1])
    return StreamState(caches=caches, first=True)


def encoder_chunk(vae: WanVAE, x_chunk: torch.Tensor, state: StreamState, grid: SpatialGrid | None = None):
    """One encode chunk: x (B, T, H, W, 3) -> latents (B, t, h, w, 16): the
    stream's first chunk 1 + 4k frames (t = 1 + k; the whole clip is the
    one-shot encode), each later one 4k frames (t = k). With ``grid``, this
    rank's slabs in and out."""
    cfg = vae.config
    enc = vae.encoder
    dt = cfg.dtype
    caches = dict(state.caches)
    first = state.first

    x, caches["conv1"] = _stream_conv(enc.conv1, x_chunk, caches["conv1"], dt, grid)
    for li, layer in enumerate(enc.downsamples):
        if hasattr(layer, "residual"):
            x = _stream_resblock(layer, x, caches, f"down_{li}", dt, grid)
            continue
        if grid is None:
            x = _conv2d(layer.resample[1], x, stride=(2, 2), padding=((0, 1), (0, 1)), dtype=dt)
        else:  # the bottom and right halo stand for the zero pad
            x = _conv2d(layer.resample[1], halo_hw(x, grid, 0, 1), stride=(2, 2), padding=((0, 0), (0, 0)), dtype=dt)
        if layer.mode == "downsample3d":
            if first:
                # frame 0 bypasses the stride-2 temporal conv; output j >= 1
                # of a longer first chunk sees frames (2j-2, 2j-1, 2j)
                caches[f"down_{li}.t"] = x[:, -1:]
                if x.shape[1] > 1:
                    z = _conv3d(layer.time_conv, x, stride=(2, 1, 1), spatial_pad=0, dtype=dt)
                    x = torch.cat([x[:, :1], z], dim=1)
            else:
                xin = torch.cat([caches[f"down_{li}.t"].to(x.dtype), x], dim=1)
                caches[f"down_{li}.t"] = xin[:, -1:]
                x = _conv3d(layer.time_conv, xin, stride=(2, 1, 1), spatial_pad=0, dtype=dt)
    mid_res1, mid_attn, mid_res2 = enc.middle
    x = _stream_resblock(mid_res1, x, caches, "mid_res1", dt, grid)
    x = _attn_block(mid_attn, x, dt, grid)
    x = _stream_resblock(mid_res2, x, caches, "mid_res2", dt, grid)
    y = F.silu(_norm(enc.head[0], x))
    y, caches["head"] = _stream_conv(enc.head[2], y, caches["head"], dt, grid)
    out = _conv3d(vae.conv1, y, spatial_pad=0, dtype=dt)
    mean, std = _latent_stats(out.device)
    z = ((out[..., : cfg.z_dim].float() - mean) / std).to(x_chunk.dtype)
    return z, StreamState(caches=caches, first=False)


@torch.no_grad()
def encode_streaming(vae: WanVAE, x: torch.Tensor, chunk_frames: int = 4, pixel_format: str = "float",
                     grid: SpatialGrid | None = None) -> torch.Tensor:
    """(B, 1 + 4k, H, W, 3) pixels -> (B, 1 + k, H/8, W/8, 16) normalized
    latents in the VAE dtype. ``pixel_format="uint8"`` takes raw uint8
    pixels and normalizes each chunk on the device (x / 127.5 - 1 in the
    VAE dtype); "float" takes pixels in [-1, 1]. With ``grid``, this rank's
    (H / gh, W / gw) slab in and its latent slab out."""
    if chunk_frames % 4:
        raise ValueError(f"chunk_frames must be a multiple of 4, got {chunk_frames}")
    if pixel_format == "uint8":
        if x.dtype != torch.uint8:
            raise TypeError(f"pixel_format='uint8' expects uint8 pixels, got {x.dtype}")
    elif pixel_format == "float":
        if not x.dtype.is_floating_point:
            raise TypeError(f"pixel_format='float' expects float pixels in [-1, 1], got {x.dtype}; "
                            "pass pixel_format='uint8' for raw uint8 clips")
    else:
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    cfg = vae.config

    def prep(chunk):
        return chunk.to(cfg.dtype) / 127.5 - 1.0 if pixel_format == "uint8" else chunk

    B, T, H, W, _ = x.shape
    state = init_encoder_state(cfg, B, H, W, cfg.dtype, x.device)
    z, state = encoder_chunk(vae, prep(x[:, :1]), state, grid)
    outs = [z]
    for pos in range(1, T, chunk_frames):
        z, state = encoder_chunk(vae, prep(x[:, pos : pos + chunk_frames]), state, grid)
        outs.append(z)
    return torch.cat(outs, dim=1)


# ------------------------------- decoder -------------------------------


def init_decoder_state(cfg: WanVAEConfig, batch: int, latent_h: int, latent_w: int, dtype, device) -> StreamState:
    dims = decoder_dims(cfg)
    temporal_upsample = cfg.temporal_downsample[::-1]
    zc = lambda h, w, c: _zeros_cache(batch, h, w, c, dtype, device)
    h, w = latent_h, latent_w
    caches: dict[str, Any] = {"conv1": zc(h, w, cfg.z_dim)}
    for key in ("mid_res1", "mid_res2"):
        caches[f"{key}.c1"] = zc(h, w, dims[0])
        caches[f"{key}.c2"] = zc(h, w, dims[0])
    li = 0
    for s, (i_d, o_d) in enumerate(zip(dims[:-1], dims[1:])):
        in_d = i_d // 2 if s in (1, 2, 3) else i_d
        for _ in range(cfg.num_res_blocks + 1):
            caches[f"up_{li}.c1"] = zc(h, w, in_d)
            caches[f"up_{li}.c2"] = zc(h, w, o_d)
            in_d = o_d
            li += 1
        if s != len(cfg.dim_mult) - 1:
            if temporal_upsample[s]:
                caches[f"up_{li}.t"] = zc(h, w, o_d)
            h, w = h * 2, w * 2
            li += 1
    caches["head"] = zc(h, w, dims[-1])
    return StreamState(caches=caches, first=True)


def decoder_chunk(vae: WanVAE, z_chunk: torch.Tensor, state: StreamState, grid: SpatialGrid | None = None):
    """One decode chunk: z (B, k, h, w, 16) -> pixels in [-1, 1] (unclipped),
    1 + 4(k - 1) frames for the stream's first chunk (the whole clip is the
    one-shot decode), 4k for each later one. With ``grid``, this rank's
    slabs in and out."""
    cfg = vae.config
    dec = vae.decoder
    dt = cfg.dtype
    caches = dict(state.caches)
    first = state.first

    mean, std = _latent_stats(z_chunk.device)
    zin = (z_chunk.float() * std + mean).to(dt)
    x = _conv3d(vae.conv2, zin, spatial_pad=0, dtype=dt)
    x, caches["conv1"] = _stream_conv(dec.conv1, x, caches["conv1"], dt, grid)
    mid_res1, mid_attn, mid_res2 = dec.middle
    x = _stream_resblock(mid_res1, x, caches, "mid_res1", dt, grid)
    x = _attn_block(mid_attn, x, dt, grid)
    x = _stream_resblock(mid_res2, x, caches, "mid_res2", dt, grid)

    for li, layer in enumerate(dec.upsamples):
        if hasattr(layer, "residual"):
            x = _stream_resblock(layer, x, caches, f"up_{li}", dt, grid)
            continue
        if layer.mode == "upsample3d":
            # "Rep": the stream's frame 0 bypasses the doubling conv and
            # leaves zero history; every later frame doubles
            head, rest = (x[:, :1], x[:, 1:]) if first else (x[:, :0], x)
            if rest.shape[1]:
                B, T, Hh, Ww, C = rest.shape
                xin = torch.cat([caches[f"up_{li}.t"].to(x.dtype), rest], dim=1)
                caches[f"up_{li}.t"] = xin[:, -CACHE_T:]
                zt = _conv3d(layer.time_conv, xin, spatial_pad=0, dtype=dt).reshape(B, T, Hh, Ww, 2, C)
                # channels [0, C) -> even output frame, [C, 2C) -> odd frame
                x = torch.cat([head, zt.permute(0, 1, 4, 2, 3, 5).reshape(B, 2 * T, Hh, Ww, C)], dim=1)
        conv = layer.resample[1]
        if grid is None:
            x = upsample2x_conv3x3(conv.weight, conv.bias, x, dt)
        else:  # a 1-pixel halo before the upsample, 2 cropped after it
            x = upsample2x_conv3x3(conv.weight, conv.bias, halo_hw(x, grid, 1, 1), dt)[:, :, 2:-2, 2:-2]

    y = F.silu(_norm(dec.head[0], x))
    y, caches["head"] = _stream_conv(dec.head[2], y, caches["head"], dt, grid)
    return y, StreamState(caches=caches, first=False)


def quantize_u8(px: torch.Tensor) -> torch.Tensor:
    """[-1, 1] pixels -> uint8 [0, 255] (clip, round half to even)."""
    return torch.round((px.float().clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def truncate_u8(px: torch.Tensor) -> torch.Tensor:
    """[-1, 1] pixels -> uint8 as the JAX package's post-trained variants'
    requests convert them: (x + 1) * 127.5 clipped to [0, 255], then
    truncated (not rounded)."""
    return ((px.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


@torch.no_grad()
def decode_streaming(
    vae: WanVAE, z: torch.Tensor, chunk_latent_frames: int = 2, pixel_format: str = "float",
    grid: SpatialGrid | None = None,
) -> torch.Tensor:
    """(B, t, h, w, 16) latents -> (B, 1 + 4(t-1), 8h, 8w, 3) pixels on z's
    device: VAE-dtype values in [-1, 1] (unclipped) for "float", or uint8
    quantized on the device for "uint8". The first chunk is one latent
    frame, then chunks of ``chunk_latent_frames``. With ``grid``, this
    rank's latent slab in and its pixel slab out."""
    if pixel_format not in ("float", "uint8"):
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    cfg = vae.config
    post = quantize_u8 if pixel_format == "uint8" else (lambda a: a)
    B, t, h, w, _ = z.shape
    state = init_decoder_state(cfg, B, h, w, cfg.dtype, z.device)
    px, state = decoder_chunk(vae, z[:, :1], state, grid)
    outs = [post(px)]
    for pos in range(1, t, chunk_latent_frames):
        px, state = decoder_chunk(vae, z[:, pos : pos + chunk_latent_frames], state, grid)
        outs.append(post(px))
    return torch.cat(outs, dim=1)


# ------------------------------- one-shot -------------------------------


def _per_sample(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over x's samples one at a time: the kernel takes batch 1."""
    if x.shape[0] == 1:
        return fn(x)
    return torch.cat([fn(x[b : b + 1]) for b in range(x.shape[0])], dim=0)


def _check_kernel_convs(vae: WanVAE, x: torch.Tensor) -> None:
    """On a CUDA tensor every 3x3x3 conv at least 64 channels wide must go
    through the kernel: the one-shot route raises rather than run them
    through cuDNN or the plain version."""
    if not x.is_cuda:
        return
    for name, conv in vae.named_modules():
        if not (isinstance(conv, nn.Conv3d) and tuple(conv.weight.shape[2:]) == (3, 3, 3)):
            continue
        cout, cin = conv.weight.shape[:2]
        if min(cin, cout) >= _KERNEL_MIN_CH and not _use_kernel_conv(x[:1], conv):
            raise ValueError(f"one-shot VAE: conv {name} ({cin} -> {cout}) cannot take the conv3d_causal kernel")


@torch.no_grad()
def encode_oneshot(vae: WanVAE, x: torch.Tensor, pixel_format: str = "float",
                   grid: SpatialGrid | None = None) -> torch.Tensor:
    """The whole clip (B, 1 + 4k, H, W, 3) through the encoder at once: the
    stream's first chunk with every cache at zero, so each causal 3x3x3
    conv sees two zero frames before frame 0 (JAX's ``WanVAE.encode``
    front padding). -> (B, 1 + k, H/8, W/8, 16) normalized latents in the
    VAE dtype. ``pixel_format`` and ``grid`` as :func:`encode_streaming`."""
    cfg = vae.config
    if pixel_format == "uint8":
        if x.dtype != torch.uint8:
            raise TypeError(f"pixel_format='uint8' expects uint8 pixels, got {x.dtype}")
        x = x.to(cfg.dtype) / 127.5 - 1.0
    elif pixel_format != "float":
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    if (x.shape[1] - 1) % 4:
        raise ValueError(f"one-shot encode takes 1 + 4k frames, got {x.shape[1]}")
    _check_kernel_convs(vae, x)

    def one(xb):
        _, _, H, W, _ = xb.shape
        return encoder_chunk(vae, xb, init_encoder_state(cfg, 1, H, W, cfg.dtype, xb.device), grid)[0]

    return _per_sample(one, x)


@torch.no_grad()
def decode_oneshot(vae: WanVAE, z: torch.Tensor, pixel_format: str = "float",
                   grid: SpatialGrid | None = None) -> torch.Tensor:
    """The whole latent clip (B, t, h, w, 16) through the decoder at once
    (JAX's ``WanVAE.decode``) -> (B, 1 + 4(t-1), 8h, 8w, 3) pixels as
    :func:`decode_streaming` gives them (``grid`` as there)."""
    if pixel_format not in ("float", "uint8"):
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    cfg = vae.config
    _check_kernel_convs(vae, z)

    def one(zb):
        _, _, h, w, _ = zb.shape
        px = decoder_chunk(vae, zb, init_decoder_state(cfg, 1, h, w, cfg.dtype, zb.device), grid)[0]
        return quantize_u8(px) if pixel_format == "uint8" else px

    return _per_sample(one, z)
