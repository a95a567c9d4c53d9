"""Flash-attention forward: the Hopper kernel (csrc/flash_attention_fwd.cu)
and its plain PyTorch version.

Counterpart of cosmos_predict2_tpu/ops/flash_attention.py::flash_attention
(forward: ``_fwd`` / ``_fwd_kernel``). BSHD in and out; the kernel also
returns the row logsumexp (B, H, Sq) in fp32 that a backward would need.
The TPU version's block auto-pick, padding and BHSD transposes stay behind:
the CUDA kernel indexes BSHD directly and masks the ragged tails itself.
"""

from __future__ import annotations

import torch

from cosmos_predict2_tpu_torch import _build

HEAD_DIM = 128
NEG_INF = -1e30


def attention_logits(q: torch.Tensor, k: torch.Tensor, frame_group: int = 0) -> torch.Tensor:
    """Scaled fp32 logits (B, H, Sq, Skv); with ``frame_group`` > 0 key i is
    visible to query j iff i // frame_group <= j // frame_group (masked
    logits take the finite NEG_INF, as in the kernel)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    if frame_group > 0:
        row = torch.arange(q.shape[1], device=q.device)[:, None] // frame_group
        col = torch.arange(k.shape[1], device=q.device)[None, :] // frame_group
        logits = logits.masked_fill(col > row, NEG_INF)
    return logits


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_group: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: fp32 logits and softmax with
    the same masks, P rounded to v's dtype for P @ V (as the kernel does).
    Returns (out in q's dtype, lse (B, H, Sq) fp32)."""
    logits = attention_logits(q, k, frame_group)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_group: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, 128), k/v (B, Skv, H, 128) -> (out (B, Sq, H, 128), lse
    (B, H, Sq) fp32). ``frame_group`` > 0: key i visible to query j iff
    i // frame_group <= j // frame_group.

    CPU tensors take :func:`flash_attention_plain`. CUDA tensors launch the
    kernel, which takes contiguous bf16 tensors with head_dim 128 on one
    device and raises on anything else.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, frame_group)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head_dim must be {HEAD_DIM}, got {D}")
    if k.shape != (B, Skv, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: {name} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous and 16-byte aligned")
    if frame_group < 0:
        raise ValueError(f"flash_attention_fwd: frame_group must be >= 0, got {frame_group}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if Sq == 0 or B == 0:
        return out, lse
    if Skv == 0:
        raise ValueError("flash_attention_fwd: empty key sequence")
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Skv, H, frame_group, 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
