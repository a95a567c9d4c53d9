"""The SigLIP vision tower (so400m/patch14-384): the guardrails' frame embedder.

Counterpart of cosmos_predict2_tpu/text_encoders/siglip_vision.py. The
reference's video content safety filter embeds sampled frames with
``google/siglip-so400m-patch14-384`` and feeds the pooled 1,152-wide
features to its 7-class classifier. Architecture (HF
``SiglipVisionModel``): a patch conv with bias and no class token, learned
position embeddings, pre-LN blocks with tanh-GELU MLPs, a final LayerNorm,
then a MAP head (a learned probe token attending every patch, LayerNorm and
a residual MLP) returning the probe's state. Submodules carry HF's names
under ``vision_model.`` (``embeddings.patch_embedding``,
``embeddings.position_embedding``,
``encoder.layers.{i}.{layer_norm1,self_attn.{q,k,v,out}_proj,layer_norm2,mlp.fc1,mlp.fc2}``,
``post_layernorm``, ``head.{probe,attention.in_proj_weight,attention.in_proj_bias,
attention.out_proj,layernorm,mlp.fc1,mlp.fc2}``).

Numerics follow the JAX package: matmuls in ``cfg.dtype`` (bf16), attention
logits and P V summed in fp32, LayerNorms in fp32. The tower is wired into
no path yet (the guardrails, ROADMAP A16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_predict2_tpu_torch.text_encoders.common import attention, build_tower, dense, gelu, layer_norm

# SigLIP rescales to [-1, 1] (mean = std = 0.5)
SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    """so400m/patch14-384, HF's config."""

    image_size: int = 384
    patch_size: int = 14
    dim: int = 1152
    mlp_dim: int = 4304
    num_heads: int = 16
    num_layers: int = 27
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, Sq, D) x (B, Skv, D) -> (B, Sq, D) in q's dtype; fp32 softmax."""
    B, Sq, D = q.shape
    hd = D // num_heads
    split = lambda t: t.view(B, t.shape[1], num_heads, hd)  # noqa: E731
    return attention(split(q), split(k), split(v), scale=1.0 / math.sqrt(hd)).reshape(B, Sq, D)


class _MLP(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.dim, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return dense(self.fc2, gelu(dense(self.fc1, x, dt), approximate=True), dt)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v_proj, self.out_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.self_attn = _SelfAttention(cfg.dim)
        self.layer_norm2 = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt, a = self.cfg, self.cfg.dtype, self.self_attn
        h = layer_norm(x, self.layer_norm1)
        o = _mha(dense(a.q_proj, h, dt), dense(a.k_proj, h, dt), dense(a.v_proj, h, dt), cfg.num_heads)
        x = x + dense(a.out_proj, o, dt)
        return x + self.mlp(layer_norm(x, self.layer_norm2), dt)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.dim)


class _Encoder(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_layers))


class _HeadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (q, k, v packed in ``in_proj``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class _MAPHead(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, cfg.dim))
        self.attention = _HeadAttention(cfg.dim)
        self.layernorm = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.mlp = _MLP(cfg)


class SigLIPVisionTower(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig = SigLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.head = _MAPHead(cfg)

    def forward(self, pixels_B_H_W_C: torch.Tensor) -> torch.Tensor:
        """Normalized pixels (B, H, W, 3) -> pooled features (B, dim) fp32."""
        cfg, dt = self.cfg, self.cfg.dtype
        B = pixels_B_H_W_C.shape[0]
        conv = self.embeddings.patch_embedding
        x = F.conv2d(pixels_B_H_W_C.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2) + conv.bias.to(dt)  # as dense: the bias added after the rounding
        x = x + self.embeddings.position_embedding.weight.to(dt)
        for layer in self.encoder.layers:
            x = layer(x)
        x = layer_norm(x, self.post_layernorm)
        head, d = self.head, cfg.dim
        w, b = head.attention.in_proj_weight, head.attention.in_proj_bias
        proj = lambda t, i: F.linear(t.to(dt), w[i * d:(i + 1) * d].to(dt)) + b[i * d:(i + 1) * d].to(dt)  # noqa: E731
        probe = head.probe.to(dt).expand(B, 1, d)
        h = dense(head.attention.out_proj, _mha(proj(probe, 0), proj(x, 1), proj(x, 2), cfg.num_heads), dt)
        h = h + head.mlp(layer_norm(h, head.layernorm), dt)
        return h[:, 0].float()


def preprocess_siglip(frames_u8: np.ndarray, image_size: int = 384,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """(N, H, W, 3) uint8 -> bilinear-resized, [-1, 1] normalized (N, S, S, 3)
    fp32 on ``device`` (utils/io.py::resize_frames, the JAX package's resize)."""
    from cosmos_predict2_tpu_torch.utils.io import resize_frames

    resized = resize_frames(frames_u8, image_size, image_size).astype(np.float32) / 255.0
    return torch.from_numpy((resized - SIGLIP_MEAN) / SIGLIP_STD).to(device)


def make_frame_embedder(tower: SigLIPVisionTower):
    """The ``embed_frames`` callable a video safety filter takes: uint8
    frames -> (N, dim) float32 NumPy, the tower on its device."""
    dev = tower.post_layernorm.weight.device

    @torch.no_grad()
    def embed(frames_u8: np.ndarray) -> np.ndarray:
        return tower(preprocess_siglip(frames_u8, tower.cfg.image_size, dev)).cpu().numpy()

    return embed


def build_siglip_vision(cfg: SigLIPVisionConfig = SigLIPVisionConfig(), device: torch.device | str = "cuda",
                        seed: Optional[int] = 0) -> SigLIPVisionTower:
    """The tower built on the meta device, its Linear, patch and packed head
    weights stored in ``cfg.dtype``, materialised (and with ``seed`` drawn)
    on ``device``."""
    return build_tower(lambda: SigLIPVisionTower(cfg), device, cfg.dtype, seed,
                       extra=lambda m: [m.embeddings.patch_embedding.weight, m.head.attention.in_proj_weight])
