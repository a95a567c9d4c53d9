"""The Qwen2.5(-VL) language model (text path) in PyTorch: the Cosmos-Reason1
text encoder's backbone, and the guard models' decoder.

Counterpart of cosmos_predict2_tpu/text_encoders/qwen.py. 7B: hidden 3584,
28 layers, 28 query heads over 4 KV heads (GQA), head dim 128, SwiGLU 18944,
RMSNorm eps 1e-6, RoPE theta 1e6, q/k/v biases, vocab 152064. For text
prompts Qwen2.5-VL's M-RoPE is 1-D RoPE (all three position components are
the token index). Submodules carry the HuggingFace names (``embed_tokens``,
``layers.{i}.self_attn.{q,k,v,o}_proj``, ``.q_norm`` / ``.k_norm`` on Qwen3,
``layers.{i}.mlp.{gate,up,down}_proj``, ``layers.{i}.input_layernorm``,
``layers.{i}.post_attention_layernorm``, ``norm``; the guard adds
``lm_head``), so an HF state dict loads through
utils/checkpoint_convert.py once its prefix is stripped.

Numerics follow the JAX package: matmuls in ``cfg.dtype`` (bf16 at full
width; the weights may be stored in it, :func:`build_qwen_lm`), norms in
fp32, RoPE in fp32, attention logits and P V summed in fp32 with the
probabilities cast to bf16, an additive -1e30 causal mask and no pad mask
(right padding is harmless only because the mask is causal).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cosmos_predict2_tpu_torch.networks.dit import RMSNorm
from cosmos_predict2_tpu_torch.text_encoders.common import attention, build_tower, dense, silu


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    dtype: torch.dtype = torch.bfloat16
    # the Qwen3 family's deltas: per-head q/k RMSNorm, no attention biases,
    # input and output embeddings tied on the small checkpoints
    attention_bias: bool = True
    qk_norm: bool = False
    tie_word_embeddings: bool = False

    @classmethod
    def qwen2_5_vl_7b(cls) -> "QwenConfig":
        return cls()

    @classmethod
    def qwen3guard_0_6b(cls) -> "QwenConfig":
        """Qwen/Qwen3Guard-Gen-0.6B, the reference's prompt guard."""
        return cls(vocab_size=151936, hidden_size=1024, intermediate_size=3072, num_hidden_layers=28,
                   num_attention_heads=16, num_key_value_heads=8, head_dim=128, rope_theta=1e6,
                   attention_bias=False, qk_norm=True, tie_word_embeddings=True)

    @classmethod
    def llama_guard_3_8b(cls) -> "QwenConfig":
        """meta-llama/Llama-Guard-3-8B, the reference's other guard: the same
        decoder with no attention biases, no q/k norm and an untied head."""
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8, head_dim=128, rope_theta=500000.0,
                   attention_bias=False, qk_norm=False, tie_word_embeddings=False)

    @classmethod
    def tiny(cls) -> "QwenConfig":
        return cls(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16, dtype=torch.float32)

    @classmethod
    def tiny3(cls) -> "QwenConfig":
        """The tiny config with the Qwen3 deltas (q/k norm, no biases, tied head)."""
        return dataclasses.replace(cls.tiny(), attention_bias=False, qk_norm=True, tie_word_embeddings=True)


def rope_1d_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(S,) integer positions -> (S, head_dim) fp32 angles, NeoX half-rotation
    layout; the frequencies in float64 on the host, as the JAX package's."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)[: head_dim // 2] / head_dim))
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(positions.device)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([ang, ang], dim=-1)


def apply_rope_1d(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (S, D): the rotation in fp32, cast back."""
    d = x.shape[-1]
    cos, sin = angles.cos()[None, :, None, :], angles.sin()[None, :, None, :]
    xf = x.float()
    rotated = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, nq * hd, bias=cfg.attention_bias)
        self.k_proj = nn.Linear(cfg.hidden_size, nkv * hd, bias=cfg.attention_bias)
        self.v_proj = nn.Linear(cfg.hidden_size, nkv * hd, bias=cfg.attention_bias)
        self.o_proj = nn.Linear(nq * hd, cfg.hidden_size, bias=False)
        if cfg.qk_norm:  # Qwen3: per-head RMSNorm over head_dim, before RoPE
            self.q_norm = RMSNorm(hd, cfg.rms_norm_eps)
            self.k_norm = RMSNorm(hd, cfg.rms_norm_eps)

    def forward(self, x: torch.Tensor, angles: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, _ = x.shape
        nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        # this rank's heads under tensor parallelism (parallel/mesh.py::parallelize): nq / tp and nkv / tp
        q = dense(self.q_proj, x, dt).view(B, S, -1, hd)
        k = dense(self.k_proj, x, dt).view(B, S, -1, hd)
        v = dense(self.v_proj, x, dt).view(B, S, -1, hd)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rope_1d(q, angles), apply_rope_1d(k, angles)
        rep = nq // nkv  # GQA: each kv head serves `rep` consecutive query heads
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        out = attention(q, k, v, scale=1.0 / math.sqrt(hd), bias=causal_mask)
        return dense(self.o_proj, out.reshape(B, S, -1), dt)


class QwenMLP(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return dense(self.down_proj, silu(dense(self.gate_proj, x, dt)) * dense(self.up_proj, x, dt), dt)


class QwenDecoderLayer(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = QwenAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = QwenMLP(cfg)

    def forward(self, x: torch.Tensor, angles: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), angles, causal_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class QwenLM(nn.Module):
    """The decoder, returning every hidden state (the embeddings and each
    layer's output, pre-final-norm as HF's ``output_hidden_states``)."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(QwenDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, vision_embeds: Optional[torch.Tensor] = None,
                vision_mask: Optional[torch.Tensor] = None, return_normed: bool = False):
        """(B, S) ids -> [S + 1 states (B, S, hidden)]; with ``return_normed``
        also the final-norm last state (what an LM head reads). Multimodal
        prompts: ``vision_embeds`` (B, S, hidden) replace the token
        embeddings where the boolean ``vision_mask`` (B, S) is set (the HF
        Qwen2.5-VL ``inputs_embeds`` splice)."""
        cfg = self.cfg
        S = input_ids.shape[1]
        x = self.embed_tokens(input_ids).to(cfg.dtype)
        if vision_embeds is not None:
            x = torch.where(vision_mask[..., None].to(x.device), vision_embeds.to(x.device, cfg.dtype), x)
        angles = rope_1d_angles(torch.arange(S, device=x.device), cfg.head_dim, cfg.rope_theta)
        causal_mask = torch.full((S, S), -1e30, device=x.device).triu(1)[None, None]
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, angles, causal_mask)
            hidden_states.append(x)
        if return_normed:
            return hidden_states, self.norm(x)
        return hidden_states


def mean_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps) over the last axis in fp32, std unbiased
    (n - 1), as torch.std and the JAX package's."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return (xf - mean) / (var.sqrt() + eps)


def pool_hidden_states(hidden_states: Sequence[torch.Tensor], strategy: str = "full_concat",
                       n_layers_per_group: int = 5) -> torch.Tensor:
    """Cosmos-Reason1 pooling: ``hidden_states[1:]`` (the token embeddings
    skipped), each mean-normalized over its channels, then concatenated
    (FULL_CONCAT, 28 x 3584 = 100,352 channels at 7B), averaged, or averaged
    in groups of ``n_layers_per_group`` and concatenated. fp32."""
    normalized = [mean_normalize(h) for h in hidden_states[1:]]
    if strategy == "full_concat":
        return torch.cat(normalized, dim=-1)
    if strategy == "mean_pooling":
        return torch.stack(normalized).mean(dim=0)
    if strategy == "pool_every_n_layers_and_concat":
        groups = [torch.stack(normalized[i: i + n_layers_per_group]).mean(dim=0)
                  for i in range(0, len(normalized), n_layers_per_group)]
        return torch.cat(groups, dim=-1)
    raise ValueError(f"Invalid embedding_concat_strategy: {strategy}")


class LMHead(nn.Module):
    """The LM head's (vocab, hidden) ``weight``, kept and applied in fp32 (as
    the JAX package's), so not a Linear that a tower stores in bf16."""

    def __init__(self, hidden: int, vocab: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, hidden))


class QwenGuardLM(nn.Module):
    """The decoder and an LM head: next-token logits (fp32) at one position.
    The guard classifiers' backbone (Qwen3Guard, LlamaGuard3); the keys are
    HF's ``*ForCausalLM`` ones (``model.*``, ``lm_head.weight``), a tied
    checkpoint's head filled from ``embed_tokens`` by the loader."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.model = QwenLM(cfg)
        self.lm_head = LMHead(cfg.hidden_size, cfg.vocab_size)

    def forward(self, input_ids: torch.Tensor, position: Optional[int] = None) -> torch.Tensor:
        """(B, S) ids -> (B, vocab) logits at ``position`` (default: the last).
        Tokens past ``position`` cannot reach it through the causal mask, so
        greedy decoding fills a fixed buffer and reads ``cur_len - 1``."""
        _, normed = self.model(input_ids, return_normed=True)
        h = normed[:, -1] if position is None else normed[:, int(position)]
        return h.float() @ self.lm_head.weight.float().T


def greedy_generate(apply_fn: Callable[[torch.Tensor, int], torch.Tensor], prompt_ids: Sequence[int],
                    max_new_tokens: int = 128, eos_ids: tuple[int, ...] = (), buffer_len: int = 512,
                    device: torch.device | str = "cuda") -> list[int]:
    """Greedy decoding on a fixed (1, ``buffer_len``) id buffer on ``device``
    (``apply_fn(ids, position) -> (1, vocab)``): the prompt's last
    ``buffer_len - max_new_tokens`` ids, then one token a call until an
    ``eos_ids`` token or the buffer's end."""
    ids = list(prompt_ids)[-(buffer_len - max_new_tokens):]
    start = len(ids)
    buf = torch.zeros((1, buffer_len), dtype=torch.long, device=device)
    buf[0, :start] = torch.tensor(ids, dtype=torch.long)
    out: list[int] = []
    for step in range(max_new_tokens):
        nxt = int(apply_fn(buf, start + step - 1)[0].argmax())
        out.append(nxt)
        if nxt in eos_ids or start + step >= buffer_len - 1:
            break
        buf[0, start + step] = nxt
    return out


def build_qwen_lm(cfg: QwenConfig, device: torch.device | str, seed: Optional[int] = 0, guard: bool = False):
    """A frozen QwenLM (or QwenGuardLM) built on the meta device, its
    Linear weights and token embeddings stored in ``cfg.dtype`` (the 7B LM
    is 14.1 GB so in bf16, 28.3 GB in fp32), materialised on ``device``;
    ``seed`` draws seeded random weights there (embeddings normal(0.02)),
    ``None`` leaves them for a checkpoint."""
    make = (lambda: QwenGuardLM(cfg)) if guard else (lambda: QwenLM(cfg))
    embeds = (lambda m: [m.model.embed_tokens.weight]) if guard else (lambda m: [m.embed_tokens.weight])
    return build_tower(make, device, cfg.dtype, seed, extra=embeds)
