"""Flash attention, forward and backward: the Hopper kernels
(csrc/flash_attention_fwd.cu: K1; csrc/flash_attention_bwd.cu: K7 dQ and K8
dK/dV), their plain PyTorch versions and the autograd Function over them.

Counterpart of cosmos_predict2_tpu/ops/flash_attention.py::flash_attention
(``_fwd`` / ``_fwd_kernel``, ``_bwd`` / ``_dq_kernel`` / ``_dkv_kernel``,
tied together by ``jax.custom_vjp``). BSHD in and out; the forward also
returns the row logsumexp (B, H, Sq) in fp32, which :class:`FlashAttention`
saves with q, k, v and the output for the backward, as the JAX custom VJP
does. The TPU version's block auto-pick, padding and BHSD transposes stay
behind: the CUDA kernels index BSHD directly and mask the ragged tails
themselves.
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


def _probs_ds(q, k, v, do, lse, delta, frame_group):
    """P and dS (B, H, Sq, Skv) fp32 from the saved forward and delta =
    rowsum(dO * O) (B, H, Sq), with the kernels' rounding of dS to q's dtype
    before dS K and dS^T Q."""
    probs = torch.exp(attention_logits(q, k, frame_group) - lse[..., None])  # masked logits give exactly 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return probs, (probs * (dp - delta[..., None])).to(q.dtype).float()


def _dq_plain(ds, q, k):
    """K7's function in plain PyTorch, from dS."""
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * (1.0 / q.shape[-1] ** 0.5)).to(q.dtype)


def _dkv_plain(probs, ds, q, k, v, do):
    """K8's function in plain PyTorch, from P and dS, with P rounded to v's
    dtype before P^T dO as the kernel does."""
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(v.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * (1.0 / q.shape[-1] ** 0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, Sq, H, D) -> (B, H, Sq)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    frame_group: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) of
    attention at (q, k, v) for the output gradient ``do``, from the forward's
    ``out`` and ``lse``."""
    probs, ds = _probs_ds(q, k, v, do, lse, attention_delta(out, do), frame_group)
    return (_dq_plain(ds, q, k), *_dkv_plain(probs, ds, q, k, v, do))


def _check_bwd_args(name, q, k, v, do, lse, delta, frame_group):
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if D != HEAD_DIM:
        raise ValueError(f"{name}: head_dim must be {HEAD_DIM}, got {D}")
    if k.shape != (B, Skv, H, D) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} do {tuple(do.shape)}")
    for tname, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {tname} must be bfloat16, got {t.dtype}")
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {tname} must be fp32 {(B, H, Sq)}, got {t.dtype} {tuple(t.shape)}")
    for tname, t in (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")
    if frame_group < 0:
        raise ValueError(f"{name}: frame_group must be >= 0, got {frame_group}")
    if Skv == 0 and Sq > 0 and B > 0:
        raise ValueError(f"{name}: empty key sequence")


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    frame_group: int = 0,
) -> torch.Tensor:
    """dq (B, Sq, H, 128) of attention from the output gradient ``do``
    (B, Sq, H, 128), the forward's ``lse`` and ``delta`` = rowsum(dO * O),
    both (B, H, Sq) fp32.

    CPU tensors take the plain version. CUDA tensors launch K7, which takes
    contiguous bf16 q, k, v, do with head_dim 128 and raises on anything else.
    """
    if not q.is_cuda:
        return _dq_plain(_probs_ds(q, k, v, do, lse, delta, frame_group)[1], q, k)
    _check_bwd_args("flash_attention_bwd_dq", q, k, v, do, lse, delta, frame_group)
    B, Sq, H, D = q.shape
    dq = torch.empty_like(q)
    if Sq == 0 or B == 0:
        return dq
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, Sq, k.shape[1], H, frame_group, 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    frame_group: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Skv, H, 128), with the arguments of
    :func:`flash_attention_bwd_dq`. CPU tensors take the plain version; CUDA
    tensors launch K8 and raise on what it does not take."""
    if not q.is_cuda:
        return _dkv_plain(*_probs_ds(q, k, v, do, lse, delta, frame_group), q, k, v, do)
    _check_bwd_args("flash_attention_bwd_dkv", q, k, v, do, lse, delta, frame_group)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if Skv == 0 or B == 0:
        return dk, dv
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Sq, Skv, H, frame_group, 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward by :func:`flash_attention_fwd`
    (K1), backward by :func:`flash_attention_bwd_dq` (K7) and
    :func:`flash_attention_bwd_dkv` (K8) on the card, by the plain versions
    on the CPU. ``FlashAttention.apply(q, k, v, frame_group)``."""

    @staticmethod
    def forward(ctx, q, k, v, frame_group: int = 0):
        out, lse = flash_attention_fwd(q, k, v, frame_group=frame_group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.frame_group = frame_group
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(out, do)  # in fp32 outside the kernels, as the JAX _bwd does
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.frame_group)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.frame_group)
        return dq, dk, dv, None
