"""Wan2.1 causal 3D-conv video VAE: config, latent statistics, parameters.

Counterpart of cosmos_predict2_tpu/tokenizers/wan_vae.py. The modules here
hold the parameters, named and shaped as the reference torch checkpoint
(``encoder.downsamples.{i}.residual.2.weight`` is a Conv3d OIDHW weight,
``...residual.0.gamma`` an RMS_norm gamma of shape (C, 1, 1, 1)), so
utils/checkpoint_convert.py::convert_vae_state_dict maps ``state_dict()``
straight onto the JAX parameter tree. The forward passes are the streaming
functions of tokenizers/wan_vae_streaming.py (which also apply the causal
time padding, through the stream's frame cache); they run channels-last
(B, T, H, W, C) like the reference; the one-shot full-clip forward waits for
a later port.

8x spatial / 4x temporal compression, 16 latent channels, per-channel
latent normalization, latent frames = 1 + (pixel_frames - 1) // 4.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# Per-channel latent statistics hardcoded in the reference.
WAN_LATENT_MEAN = np.array(
    [-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
     0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921],
    dtype=np.float32,
)
WAN_LATENT_STD = np.array(
    [2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
     3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160],
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: tuple[bool, ...] = (False, True, True)
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_compression(self) -> int:
        return 8

    @property
    def temporal_compression(self) -> int:
        return 4


class RMS_norm(nn.Module):  # noqa: N801 - the reference's class name
    """L2 normalize over channels * sqrt(C) * gamma; gamma (C, 1, 1, 1), or
    (C, 1, 1) for the per-frame attention block (``images=True``)."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones((dim, 1, 1) if images else (dim, 1, 1, 1)))


class ResidualBlock(nn.Module):
    """residual = [RMS, SiLU, Conv3x3x3, RMS, SiLU, Dropout, Conv3x3x3];
    shortcut = 1x1x1 conv when the width changes."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.residual = nn.Sequential(
            RMS_norm(in_dim), nn.SiLU(), nn.Conv3d(in_dim, out_dim, 3),
            RMS_norm(out_dim), nn.SiLU(), nn.Dropout(0.0), nn.Conv3d(out_dim, out_dim, 3),
        )
        self.shortcut = nn.Conv3d(in_dim, out_dim, 1) if in_dim != out_dim else nn.Identity()


class AttentionBlock(nn.Module):
    """Single-head per-frame spatial self-attention."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMS_norm(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)


class Resample(nn.Module):
    """Spatial (and temporal) up/down sampling. ``resample`` keeps the
    reference's (Upsample | ZeroPad2d, Conv2d) indices."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.mode = mode
        if mode in ("upsample2d", "upsample3d"):
            self.resample = nn.Sequential(nn.Upsample(scale_factor=2.0, mode="nearest-exact"), nn.Conv2d(dim, dim // 2, 3, padding=1))
            if mode == "upsample3d":
                self.time_conv = nn.Conv3d(dim, 2 * dim, (3, 1, 1))
        elif mode in ("downsample2d", "downsample3d"):
            self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)), nn.Conv2d(dim, dim, 3, stride=2))
            if mode == "downsample3d":
                self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1))
        else:
            raise ValueError(f"unknown resample mode {mode}")


def encoder_dims(cfg: WanVAEConfig) -> list[int]:
    return [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]


def decoder_dims(cfg: WanVAEConfig) -> list[int]:
    mult = tuple(cfg.dim_mult)
    return [cfg.dim * u for u in (mult[-1],) + mult[::-1]]


class Encoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = encoder_dims(cfg)
        self.conv1 = nn.Conv3d(3, dims[0], 3)
        layers = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(cfg.num_res_blocks):
                layers.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(cfg.dim_mult) - 1:
                layers.append(Resample(out_dim, "downsample3d" if cfg.temporal_downsample[i] else "downsample2d"))
        self.downsamples = nn.ModuleList(layers)
        self.middle = nn.ModuleList([ResidualBlock(dims[-1], dims[-1]), AttentionBlock(dims[-1]), ResidualBlock(dims[-1], dims[-1])])
        self.head = nn.Sequential(RMS_norm(dims[-1]), nn.SiLU(), nn.Conv3d(dims[-1], 2 * cfg.z_dim, 3))


class Decoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = decoder_dims(cfg)
        temporal_upsample = cfg.temporal_downsample[::-1]
        self.conv1 = nn.Conv3d(cfg.z_dim, dims[0], 3)
        self.middle = nn.ModuleList([ResidualBlock(dims[0], dims[0]), AttentionBlock(dims[0]), ResidualBlock(dims[0], dims[0])])
        layers = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i in (1, 2, 3):
                in_dim = in_dim // 2
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(cfg.dim_mult) - 1:
                layers.append(Resample(out_dim, "upsample3d" if temporal_upsample[i] else "upsample2d"))
        self.upsamples = nn.ModuleList(layers)
        self.head = nn.Sequential(RMS_norm(dims[-1]), nn.SiLU(), nn.Conv3d(dims[-1], 3, 3))


class WanVAE(nn.Module):
    """Encoder, decoder and the outer 1x1x1 convs; run it with
    wan_vae_streaming.encode_streaming / decode_streaming."""

    def __init__(self, config: WanVAEConfig = WanVAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder3d(config)
        self.decoder = Decoder3d(config)
        self.conv1 = nn.Conv3d(2 * config.z_dim, 2 * config.z_dim, 1)
        self.conv2 = nn.Conv3d(config.z_dim, config.z_dim, 1)


@torch.no_grad()
def init_vae_weights(vae: WanVAE, generator: torch.Generator) -> WanVAE:
    """Seeded random weights: conv weights ~ normal with std 1/sqrt(fan_in)
    (fan-in preserving), biases 0, norm gammas 1. The generator must live on
    the parameters' device."""
    for module in vae.modules():
        if isinstance(module, (nn.Conv2d, nn.Conv3d)):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            module.bias.zero_()
        elif isinstance(module, RMS_norm):
            module.gamma.fill_(1.0)
    return vae


def build_vae(cfg: WanVAEConfig, device: torch.device | str, seed: int) -> WanVAE:
    """A WanVAE with seeded random fp32 weights, made on ``device``."""
    with torch.device("meta"):
        vae = WanVAE(cfg)
    vae = vae.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_vae_weights(vae, gen).eval().requires_grad_(False)


def upsample2x_conv3x3(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """3x3 conv (pad 1) of a nearest-2x upsample of x, without building the
    upsample: each output phase (di, dj) reads a 2x2 source patch, so the
    conv splits into four 2x2 convs with tap-summed weights (4/9 the MACs)
    and a pixel interleave. weight: (Cout, Cin, 3, 3) OIHW; x: (B, T, H, W,
    Cin) -> (B, T, 2H, 2W, Cout). Tap sums in fp32, cast once to ``dtype``.
    """
    B, T, H, W, C = x.shape
    wf = weight.float()  # (O, I, kh, kw)
    xf = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2).to(dtype)
    rows = {0: (wf[:, :, 0], wf[:, :, 1] + wf[:, :, 2]), 1: (wf[:, :, 0] + wf[:, :, 1], wf[:, :, 2])}
    Co = weight.shape[0]
    phases = []
    for di in (0, 1):
        wr = torch.stack(rows[di], dim=2)  # (O, I, 2, 3)
        cols = []
        for dj in (0, 1):
            if dj == 0:
                k = torch.stack([wr[..., 0], wr[..., 1] + wr[..., 2]], dim=-1)
            else:
                k = torch.stack([wr[..., 0] + wr[..., 1], wr[..., 2]], dim=-1)
            # rows padded (1 - di, di), columns (1 - dj, dj)
            xp = F.pad(xf, (1 - dj, dj, 1 - di, di))
            cols.append(F.conv2d(xp, k.to(dtype)).permute(0, 2, 3, 1))  # (BT, H, W, Co)
        phases.append(torch.cat(cols, dim=-1).reshape(B * T, H, 2 * W, Co))
    y = torch.stack(phases, dim=2).reshape(B, T, 2 * H, 2 * W, Co)
    return y + bias.to(dtype)
