"""Attention dispatch and the plain fp32-softmax attention.

Counterpart of cosmos_predict2_tpu/ops/attention.py. All functions use the
BSHD layout (batch, seq, heads, head_dim). The dispatch is by device, not
by sequence length: :func:`dot_product_attention` calls the flash-attention
wrapper (ops/flash_attention.py), which launches the hand-written kernel on
a CUDA tensor and takes its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from cosmos_predict2_tpu_torch.ops.flash_attention import attention_logits, flash_attention_fwd


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
    """q,k,v: (B, S, H, D) -> (B, Sq, H, D). CUDA tensors launch the flash
    kernel (bf16, D = 128; anything else raises); CPU tensors take its
    plain version."""
    return flash_attention_fwd(q, k, v, frame_group=frame_group)[0]
