"""The CLIP ViT-H/14 vision tower (open-clip XLM-Roberta CLIP) for Wan i2v.

Counterpart of cosmos_predict2_tpu/text_encoders/clip_vision.py: Wan2.1 i2v
encodes the first video frame with the visual tower of
``open-clip-xlm-roberta-large-vit-huge-14`` and feeds the 257-token hidden
state (the class token and 16 x 16 patches, 1,280 wide) to the WanModel's
image cross-attention (networks/wan_dit.py). As the reference's
``use_31_block``, the conditioning path runs the first 31 of the 32 blocks
and returns the raw hidden state (no final LayerNorm, no head), so the
tower holds only those blocks; a checkpoint's last block, ``post_norm``
and ``head`` are left unread. Submodules carry the reference's names under
``visual.`` (``patch_embedding``, ``cls_embedding``, ``pos_embedding``,
``pre_norm``, ``transformer.{i}.{norm1,attn.to_qkv,attn.proj,norm2,mlp.0,mlp.2}``).

Numerics follow the JAX package: matmuls in ``cfg.dtype`` (bf16), the
attention logits taken in that dtype and then softmaxed in fp32, LayerNorms
in fp32. :func:`preprocess_clip` resizes with the JAX package's bicubic
(``jax.image.resize(method="cubic")``: the Keys kernel, a = -0.5, widened
when downsampling), computed as two matrices built on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_predict2_tpu_torch.text_encoders.common import build_tower, dense, gelu, layer_norm

# the OpenAI CLIP normalisation (reference clip.py:438-439)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """The ViT-H/14 visual tower (reference clip.py:453-478)."""

    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32  # the checkpoint's; the tower runs num_layers - 1
    pre_norm: bool = True
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Block(nn.Module):
    """Pre-LN transformer block, exact-GELU MLP."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim
        self.norm1 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.attn = _Attention(D)
        self.norm2 = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.mlp = nn.Sequential(nn.Linear(D, int(D * cfg.mlp_ratio)), nn.GELU(), nn.Linear(int(D * cfg.mlp_ratio), D))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, D = x.shape
        H = cfg.num_heads
        q, k, v = dense(self.attn.to_qkv, layer_norm(x, self.norm1), dt).view(B, S, 3, H, D // H).unbind(2)
        # the JAX tower's einsums run in the compute dtype: logits rounded
        # there, then softmaxed in fp32
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D // H)
        probs = logits.softmax(dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D)
        x = x + dense(self.attn.proj, o, dt)
        h = dense(self.mlp[0], layer_norm(x, self.norm2), dt)
        return x + dense(self.mlp[2], gelu(h, approximate=False), dt)


class CLIPVisionTower(nn.Module):
    """The reference XLMRobertaCLIP's ``visual`` as Wan's conditioner runs
    it: normalized pixels (B, H, W, 3) -> the hidden state after the first
    ``num_layers - 1`` blocks, (B, 1 + num_patches, dim)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        D, p = cfg.dim, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, D, p, stride=p, bias=not cfg.pre_norm)
        self.cls_embedding = nn.Parameter(torch.empty(1, 1, D))
        self.pos_embedding = nn.Parameter(torch.empty(1, cfg.num_patches + 1, D))
        if cfg.pre_norm:
            self.pre_norm = nn.LayerNorm(D, eps=cfg.norm_eps)
        self.transformer = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers - 1))

    def forward(self, pixels_B_H_W_C: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B = pixels_B_H_W_C.shape[0]
        conv = self.patch_embedding
        x = F.conv2d(pixels_B_H_W_C.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, gh gw, D), row-major patches
        if conv.bias is not None:  # as dense: the bias added after the rounding
            x = x + conv.bias.to(dt)
        x = torch.cat([self.cls_embedding.to(dt).expand(B, 1, cfg.dim), x], dim=1) + self.pos_embedding.to(dt)
        if cfg.pre_norm:
            x = layer_norm(x, self.pre_norm)
        for block in self.transformer:
            x = block(x)
        return x


def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize(...,
    method="cubic")`` along one axis (JAX's ``compute_weight_mat``: the Keys
    cubic kernel, a = -0.5, scaled by in / out when downsampling, each
    column normalised)."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0),
                 ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0))
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def preprocess_clip(frames_pm1: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] frames (B, H, W, 3) -> CLIP-normalized (B, size, size, 3) fp32:
    the JAX package's bicubic resize, then (x / 2 + 1/2 - mean) / std."""
    B, H, W, C = frames_pm1.shape
    x = frames_pm1.float()
    dev = x.device
    if H != image_size:
        x = torch.einsum("bhwc,ho->bowc", x, torch.from_numpy(cubic_resize_matrix(H, image_size)).to(dev))
    if W != image_size:
        x = torch.einsum("bhwc,wo->bhoc", x, torch.from_numpy(cubic_resize_matrix(W, image_size)).to(dev))
    x = x * 0.5 + 0.5
    return (x - torch.from_numpy(CLIP_MEAN).to(dev)) / torch.from_numpy(CLIP_STD).to(dev)


@torch.no_grad()
def encode_first_frame(tower: CLIPVisionTower, video_pm1_B_T_H_W_C: torch.Tensor) -> torch.Tensor:
    """Wan i2v conditioning: frame 0 through the tower -> (B, 257, 1280)."""
    return tower(preprocess_clip(video_pm1_B_T_H_W_C[:, 0], tower.cfg.image_size))


def build_clip_vision(cfg: CLIPVisionConfig = CLIPVisionConfig(), device: torch.device | str = "cuda",
                      seed: Optional[int] = 0) -> CLIPVisionTower:
    """The tower built on the meta device, its Linear and patch weights
    stored in ``cfg.dtype``, materialised (and with ``seed`` drawn) on ``device``."""
    return build_tower(lambda: CLIPVisionTower(cfg), device, cfg.dtype, seed,
                       extra=lambda m: [m.patch_embedding.weight])
