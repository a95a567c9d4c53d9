"""XLM-Roberta-Large (the Wan2.1 i2v CLIP's text tower) in PyTorch.

Counterpart of cosmos_predict2_tpu/text_encoders/xlm_roberta.py: a post-norm
transformer encoder whose learned positions come from the cumulative sum
over the non-pad tokens (HF XLM-R's scheme), type-0 embeddings and an
additive pad mask; :class:`XLMRobertaWithHead` mean-pools the non-pad tokens
and projects through Linear -> GELU -> Linear (bias-free) into the CLIP
joint space. Inference only, so no dropout. Submodules carry the
reference's names (``token_embedding``, ``type_embedding``,
``pos_embedding``, ``norm``, ``blocks.{i}.attn.{q,k,v,o}``,
``blocks.{i}.norm{1,2}``, ``blocks.{i}.ffn.{0,2}``, ``head.{0,2}``). The
embeddings are summed in fp32 before the cast to ``cfg.dtype``, as the JAX
package does, so they stay fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from cosmos_predict2_tpu_torch.text_encoders.common import attention, build_tower, dense, gelu, layer_norm


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5
    out_dim: int = 1024  # the head's projection (the CLIP joint width)
    dtype: torch.dtype = torch.float32

    @classmethod
    def large(cls) -> "XLMRobertaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "XLMRobertaConfig":
        return cls(vocab_size=64, max_seq_len=32, dim=32, num_heads=4, num_layers=2, out_dim=16)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: XLMRobertaConfig):
        super().__init__()
        self.cfg = cfg
        self.q, self.k, self.v, self.o = (nn.Linear(cfg.dim, cfg.dim) for _ in range(4))

    def forward(self, x: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, C = x.shape
        n = cfg.num_heads
        q, k, v = (dense(p, x, dt).view(B, S, n, C // n) for p in (self.q, self.k, self.v))
        out = attention(q, k, v, scale=1.0 / math.sqrt(C // n), bias=mask_add)
        return dense(self.o, out.reshape(B, S, C), dt)


class _Block(nn.Module):
    def __init__(self, cfg: XLMRobertaConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = _SelfAttention(cfg)
        self.norm1 = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, 4 * cfg.dim), nn.GELU(), nn.Linear(4 * cfg.dim, cfg.dim))

    def forward(self, x: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        ffn = lambda h: dense(self.ffn[2], gelu(dense(self.ffn[0], h, dt), approximate=False), dt)  # noqa: E731
        if self.cfg.post_norm:
            x = layer_norm(x + self.attn(x, mask_add), self.norm1)
            return layer_norm(x + ffn(x), self.norm2)
        x = x + self.attn(layer_norm(x, self.norm1), mask_add)
        return x + ffn(layer_norm(x, self.norm2))


class XLMRoberta(nn.Module):
    """ids (B, S) -> the final hidden states (B, S, dim)."""

    def __init__(self, cfg: XLMRobertaConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.type_embedding = nn.Embedding(cfg.type_size, cfg.dim)
        self.pos_embedding = nn.Embedding(cfg.max_seq_len, cfg.dim)
        self.norm = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers))

    def encode(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask = (ids != cfg.pad_id).long()
        positions = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
        x = self.token_embedding(ids) + self.type_embedding(torch.zeros_like(ids)) + self.pos_embedding(positions)
        x = x.to(cfg.dtype)
        if cfg.post_norm:
            x = layer_norm(x, self.norm)
        mask_add = torch.where(mask[:, None, None, :] > 0, 0.0, float("-inf"))
        for block in self.blocks:
            x = block(x, mask_add)
        return x if cfg.post_norm else layer_norm(x, self.norm)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.encode(ids)


class XLMRobertaWithHead(XLMRoberta):
    """XLM-R, the mean over the non-pad tokens and the bias-free MLP head."""

    def __init__(self, cfg: XLMRobertaConfig):
        super().__init__(cfg)
        mid = (cfg.dim + cfg.out_dim) // 2
        self.head = nn.Sequential(nn.Linear(cfg.dim, mid, bias=False), nn.GELU(),
                                  nn.Linear(mid, cfg.out_dim, bias=False))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.encode(ids)
        mask = (ids != self.cfg.pad_id).to(x.dtype)[..., None]
        pooled = (x * mask).sum(dim=1) / mask.sum(dim=1)
        return dense(self.head[2], gelu(dense(self.head[0], pooled, dt), approximate=False), dt)


def build_xlm_roberta(cfg: XLMRobertaConfig = XLMRobertaConfig(), device: torch.device | str = "cuda",
                      seed: Optional[int] = 0, with_head: bool = False) -> XLMRoberta:
    """The encoder (with the head) built on the meta device, Linear weights
    stored in ``cfg.dtype``, materialised (and with ``seed`` drawn) on ``device``."""
    return build_tower(lambda: (XLMRobertaWithHead if with_head else XLMRoberta)(cfg), device, cfg.dtype, seed)
