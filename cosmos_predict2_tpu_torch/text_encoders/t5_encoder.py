"""The T5 / umT5 encoder in PyTorch: the offline text-embedding towers.

Counterpart of cosmos_predict2_tpu/text_encoders/t5_encoder.py, for both
reference checkpoints:

* T5-11B (the Cosmos ``t5_text_embeddings``): T5 v1.0, a ReLU feed-forward,
  the relative attention bias of layer 0 shared by every layer;
* umT5-XXL (the Wan text tower): the mT5 / v1.1 family, a gated-GELU
  feed-forward, a bias table in every layer.

As HF's ``T5EncoderModel`` / ``UMT5EncoderModel``: the norms are scale-only
RMS, the attention logits are NOT scaled by 1/sqrt(d) (T5 folds the scale
into its initialisation), and the relative position bias is bucketed
(bidirectional: half the buckets per direction, the first half of those
exact offsets, the rest log-spaced up to ``max_distance``). Padding is
masked additively in attention and zeroed in the output, like the
reference's masked fill. Submodules carry HF's names (``shared``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}``,
``...relative_attention_bias``, ``encoder.block.{i}.layer.{0,1}.layer_norm``,
``encoder.block.{i}.layer.1.DenseReluDense.{wi | wi_0, wi_1, wo}``,
``encoder.final_layer_norm``).

:meth:`T5Config.t5_11b` has the published google-t5/t5-11b widths (d_kv 128,
d_ff 65,536: 4.865e9 encoder parameters). The JAX package's preset keeps
the class defaults d_kv 64, d_ff 16,384 (1.64e9 parameters; ROADMAP C7);
no JAX path builds it, and the port does not carry it over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cosmos_predict2_tpu_torch.networks.dit import RMSNorm
from cosmos_predict2_tpu_torch.text_encoders.common import attention, build_tower, dense, gelu


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 128
    d_ff: int = 65536
    num_layers: int = 24
    num_heads: int = 128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated_act: bool = False  # False: ReLU wi / wo (v1.0); True: GELU wi_0 / wi_1 (v1.1, umT5)
    per_layer_rel_bias: bool = False  # umT5: each layer owns a bias table
    dtype: torch.dtype = torch.float32

    @classmethod
    def t5_11b(cls) -> "T5Config":
        """The google-t5/t5-11b encoder at its published widths (the Cosmos
        t5_text_embeddings tower)."""
        return cls()

    @classmethod
    def umt5_xxl(cls) -> "T5Config":
        """The google/umt5-xxl encoder (the Wan2.x text tower)."""
        return cls(vocab_size=256384, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
                   gated_act=True, per_layer_rel_bias=True)

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        base = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf(cls, c: dict, dtype: torch.dtype = torch.float32) -> "T5Config":
        """From an HF ``config.json`` (t5 or umt5)."""
        return cls(vocab_size=c["vocab_size"], d_model=c["d_model"], d_kv=c["d_kv"], d_ff=c["d_ff"],
                   num_layers=c["num_layers"], num_heads=c["num_heads"],
                   relative_attention_num_buckets=c.get("relative_attention_num_buckets", 32),
                   relative_attention_max_distance=c.get("relative_attention_max_distance", 128),
                   layer_norm_epsilon=c.get("layer_norm_epsilon", 1e-6),
                   gated_act="gated" in c.get("feed_forward_proj", "relu"),
                   per_layer_rel_bias=c.get("model_type") == "umt5", dtype=dtype)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket ids, (qlen, klen) int32 (HF
    ``T5Attention._relative_position_bucket``), on the host."""
    ctx = np.arange(qlen, dtype=np.int64)[:, None]
    mem = np.arange(klen, dtype=np.int64)[None, :]
    rel = mem - ctx  # the key's position relative to the query's
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact)
                         * (nb - max_exact)).astype(np.int64)
    out += np.where(rel < max_exact, rel, np.minimum(large, nb - 1))
    return out.astype(np.int32)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_rel_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)

    def position_bias(self, buckets: torch.Tensor) -> torch.Tensor:
        """This layer's table at the (S, S) bucket ids: (1, H, S, S) fp32."""
        return self.relative_attention_bias.weight.float()[buckets].permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.d_kv
        q, k, v = (dense(p, x, dt).view(B, S, H, D) for p in (self.q, self.k, self.v))
        out = attention(q, k, v, bias=pos_bias + pad_mask)  # T5: no 1/sqrt(d) scaling
        return dense(self.o, out.reshape(B, S, H * D), dt)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        if cfg.gated_act:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        if self.cfg.gated_act:
            h = gelu(dense(self.wi_0, x, dt), approximate=True) * dense(self.wi_1, x, dt)
        else:
            h = F.relu(dense(self.wi, x, dt))
        return dense(self.wo, h, dt)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_rel_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5FFN(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, has_rel_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_rel_bias), _FFLayer(cfg)])


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(_Block(cfg, cfg.per_layer_rel_bias or i == 0) for i in range(cfg.num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """input_ids (B, S) and attention_mask (B, S) -> the last hidden state
    (B, S, d_model) fp32, zero at the padding positions."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.shared(input_ids).to(cfg.dtype)
        mask = attention_mask.float()
        pad_mask = ((1.0 - mask) * -1e9)[:, None, None, :]
        S = x.shape[1]
        # the bucket ids once on the host, for every layer that owns a table
        buckets = torch.from_numpy(relative_position_buckets(
            S, S, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)).long().to(x.device)
        pos_bias = None
        for block in self.encoder.block:
            attn, ff = block.layer
            if hasattr(attn.SelfAttention, "relative_attention_bias"):
                pos_bias = attn.SelfAttention.position_bias(buckets)
            x = x + attn.SelfAttention(attn.layer_norm(x), pos_bias, pad_mask)
            x = x + ff.DenseReluDense(ff.layer_norm(x))
        return self.encoder.final_layer_norm(x).float() * mask[..., None]


def build_t5_encoder(cfg: T5Config, device: torch.device | str = "cuda", seed: Optional[int] = 0) -> T5Encoder:
    """The encoder built on the meta device, its Linear weights and token
    embeddings stored in ``cfg.dtype`` (the bias tables stay fp32, as the
    JAX package's), materialised (and with ``seed`` drawn: the embeddings
    and bias tables normal(1), as the JAX package's initialisers) on
    ``device``."""
    return build_tower(lambda: T5Encoder(cfg), device, cfg.dtype, seed, extra=lambda m: [m.shared.weight],
                       embed_std=1.0)
