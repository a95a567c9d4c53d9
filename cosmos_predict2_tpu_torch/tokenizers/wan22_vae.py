"""The Wan2.2 causal video VAE: config, latent statistics, parameters and the
parameter-free resampling shortcuts.

Counterpart of cosmos_predict2_tpu/tokenizers/wan22_vae.py. Against Wan2.1
(tokenizers/wan_vae.py): the pixels are 2x2 patchified first (3 -> 12
channels), so the latent is 4x smaller in time and 16x in space; the
encoder is 160 wide, the decoder 256, the latent 48 channels with 48-wide
statistics; each down / up stage is a residual macro block whose shortcut
across the whole stage is the parameter-free :func:`avg_down_3d` or
:func:`dup_up_3d`, and the upsampling conv keeps its width.

The modules hold the parameters under the reference checkpoint's names
(``encoder.downsamples.{s}.downsamples.{j}.residual.2.weight``,
``decoder.upsamples.{s}.upsamples.{j}...``, OIDHW conv weights, RMS_norm
gammas (C, 1, 1, 1)); the forward passes are the functions of
tokenizers/wan22_vae_streaming.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn

from cosmos_predict2_tpu_torch.tokenizers.wan_vae import AttentionBlock, RMS_norm, Resample, ResidualBlock

WAN22_LATENT_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.157, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.123,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.052, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
], dtype=np.float32)
WAN22_LATENT_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.499, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.06, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Wan22VAEConfig:
    dim: int = 160
    dec_dim: int = 256
    z_dim: int = 48
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: tuple[bool, ...] = (False, True, True)
    patch_size: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def spatial_compression(self) -> int:
        return 8 * self.patch_size

    @property
    def temporal_compression(self) -> int:
        return 4


def encoder_dims(cfg: Wan22VAEConfig) -> list[int]:
    return [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]


def decoder_dims(cfg: Wan22VAEConfig) -> list[int]:
    mult = tuple(cfg.dim_mult)
    return [cfg.dec_dim * u for u in (mult[-1],) + mult[::-1]]


def stage_temporal(cfg: Wan22VAEConfig, s: int, decoder: bool) -> bool:
    flags = cfg.temporal_downsample[::-1] if decoder else cfg.temporal_downsample
    return flags[s] if s < len(flags) else False


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, H/p, W/p, C p p), channel c p p + r p + q
    (q the row within the patch, r the column): the reference's '(c r q)'."""
    B, T, H, W, C = x.shape
    x = x.reshape(B, T, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 6, 5, 3)
    return x.reshape(B, T, H // p, W // p, C * p * p)


def unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    B, T, H, W, K = x.shape
    x = x.reshape(B, T, H, W, K // (p * p), p, p).permute(0, 1, 2, 6, 3, 5, 4)
    return x.reshape(B, T, H * p, W * p, K // (p * p))


def avg_down_3d(x: torch.Tensor, out_channels: int, factor_t: int, factor_s: int) -> torch.Tensor:
    """AvgDown3D, channels last: zero front pad of T to a multiple of
    factor_t, (t, h, w) folded into the channels in the reference's (c, ft,
    fh, fw) order, then the mean over groups of channels."""
    B, T, H, W, C = x.shape
    pad_t = (-T) % factor_t
    if pad_t:
        x = torch.cat([x.new_zeros((B, pad_t, H, W, C)), x], dim=1)
        T += pad_t
    factor = factor_t * factor_s * factor_s
    x = x.reshape(B, T // factor_t, factor_t, H // factor_s, factor_s, W // factor_s, factor_s, C)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(B, T // factor_t, H // factor_s, W // factor_s, C * factor)
    return x.reshape(x.shape[:-1] + (out_channels, C * factor // out_channels)).mean(dim=-1)


def dup_up_3d(x: torch.Tensor, out_channels: int, factor_t: int, factor_s: int, first_chunk: bool) -> torch.Tensor:
    """DupUp3D: each channel repeated, then unfolded into (t, h, w); the
    stream's first chunk drops its first factor_t - 1 frames."""
    B, T, H, W, C = x.shape
    factor = factor_t * factor_s * factor_s
    x = x.repeat_interleave(out_channels * factor // C, dim=-1)
    x = x.reshape(B, T, H, W, out_channels, factor_t, factor_s, factor_s).permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(B, T * factor_t, H * factor_s, W * factor_s, out_channels)
    return x[:, factor_t - 1:] if first_chunk and factor_t > 1 else x


class DownResidualBlock(nn.Module):
    """``downsamples`` = the res blocks and, but for the last stage, the
    down Resample; the stage's input + avg_down_3d shortcut."""

    def __init__(self, in_dim: int, out_dim: int, mult: int, temporal: bool, down: bool):
        super().__init__()
        layers = [ResidualBlock(in_dim if i == 0 else out_dim, out_dim) for i in range(mult)]
        if down:
            layers.append(Resample(out_dim, "downsample3d" if temporal else "downsample2d"))
        self.downsamples = nn.ModuleList(layers)


class UpResidualBlock(nn.Module):
    """``upsamples`` = the res blocks and, but for the last stage, the up
    Resample (keeping the width) with a dup_up_3d shortcut."""

    def __init__(self, in_dim: int, out_dim: int, mult: int, temporal: bool, up: bool):
        super().__init__()
        layers = [ResidualBlock(in_dim if i == 0 else out_dim, out_dim) for i in range(mult)]
        if up:
            layers.append(Resample(out_dim, "upsample3d" if temporal else "upsample2d", up_out_dim=out_dim))
        self.upsamples = nn.ModuleList(layers)


class Encoder3d(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig):
        super().__init__()
        dims = encoder_dims(cfg)
        n = len(cfg.dim_mult)
        self.conv1 = nn.Conv3d(3 * cfg.patch_size**2, dims[0], 3)
        self.downsamples = nn.ModuleList(
            DownResidualBlock(i_d, o_d, cfg.num_res_blocks, stage_temporal(cfg, s, False), s != n - 1)
            for s, (i_d, o_d) in enumerate(zip(dims[:-1], dims[1:])))
        self.middle = nn.ModuleList([ResidualBlock(dims[-1], dims[-1]), AttentionBlock(dims[-1]),
                                     ResidualBlock(dims[-1], dims[-1])])
        self.head = nn.Sequential(RMS_norm(dims[-1]), nn.SiLU(), nn.Conv3d(dims[-1], 2 * cfg.z_dim, 3))


class Decoder3d(nn.Module):
    def __init__(self, cfg: Wan22VAEConfig):
        super().__init__()
        dims = decoder_dims(cfg)
        n = len(cfg.dim_mult)
        self.conv1 = nn.Conv3d(cfg.z_dim, dims[0], 3)
        self.middle = nn.ModuleList([ResidualBlock(dims[0], dims[0]), AttentionBlock(dims[0]),
                                     ResidualBlock(dims[0], dims[0])])
        self.upsamples = nn.ModuleList(
            UpResidualBlock(i_d, o_d, cfg.num_res_blocks + 1, stage_temporal(cfg, s, True), s != n - 1)
            for s, (i_d, o_d) in enumerate(zip(dims[:-1], dims[1:])))
        self.head = nn.Sequential(RMS_norm(dims[-1]), nn.SiLU(), nn.Conv3d(dims[-1], 3 * cfg.patch_size**2, 3))


class Wan22VAE(nn.Module):
    """Encoder, decoder and the outer 1x1x1 convs: the parameters only.
    tokenizers/wan22_vae_streaming.py runs them: (B, 1 + 4k, H, W, 3)
    pixels in [-1, 1] -> (B, 1 + k, H/16, W/16, 48) normalized latents and
    back."""

    def __init__(self, config: Wan22VAEConfig = Wan22VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder3d(config)
        self.decoder = Decoder3d(config)
        self.conv1 = nn.Conv3d(2 * config.z_dim, 2 * config.z_dim, 1)
        self.conv2 = nn.Conv3d(config.z_dim, config.z_dim, 1)


@torch.no_grad()
def init_vae_weights(vae: Wan22VAE, generator: torch.Generator) -> Wan22VAE:
    """Seeded random weights, as tokenizers/wan_vae.py's: conv weights ~
    normal with std 1/sqrt(fan_in), biases 0, gammas 1."""
    for module in vae.modules():
        if isinstance(module, (nn.Conv2d, nn.Conv3d)):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.weight[0].numel()), generator=generator)
            module.bias.zero_()
        elif isinstance(module, RMS_norm):
            module.gamma.fill_(1.0)
    return vae


def build_vae(cfg: Wan22VAEConfig, device: torch.device | str, seed: int) -> Wan22VAE:
    """A Wan22VAE with seeded random fp32 weights, made on ``device``."""
    with torch.device("meta"):
        vae = Wan22VAE(cfg)
    vae = vae.to_empty(device=device)
    return init_vae_weights(vae, torch.Generator(device=device).manual_seed(seed)).eval().requires_grad_(False)
