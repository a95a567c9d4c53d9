"""Attention dispatch and the plain fp32-softmax attention.

Counterpart of cosmos_predict2_tpu/ops/attention.py. All functions use the
BSHD layout (batch, seq, heads, head_dim). The dispatch is by device, not
by sequence length: :func:`dot_product_attention` goes through the
differentiable flash attention (ops/flash_attention.py::FlashAttention),
which launches the hand-written kernels on CUDA tensors (K1 forward, K7/K8
backward) and takes their plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from cosmos_predict2_tpu_torch.ops.flash_attention import FlashAttention, attention_logits


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_group: int = 0
) -> torch.Tensor:
    """Plain attention with fp32 logits and softmax. q,k,v: (B, S, H, D) ->
    (B, Sq, H, D) in q's dtype; ``frame_group`` > 0 applies the frame-block
    causal mask."""
    probs = torch.softmax(attention_logits(q, k, frame_group), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_group: int = 0
) -> torch.Tensor:
    """q,k,v: (B, S, H, D) -> (B, Sq, H, D), differentiable. CUDA tensors
    launch the flash kernels (bf16, D = 128; anything else raises); CPU
    tensors take their plain versions."""
    return FlashAttention.apply(q, k, v, frame_group)
