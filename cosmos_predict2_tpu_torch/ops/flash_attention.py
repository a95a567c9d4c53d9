"""Flash attention, forward and backward, and the KV-cache decode: the
Hopper kernels (csrc/flash_attention_fwd.cu: K1; csrc/flash_attention_bwd.cu:
K7 dQ and K8 dK/dV; csrc/flash_attention_kv_cache.cu: K5 cache decode and K6
row-windowed cache decode), their plain PyTorch versions and the autograd
Function over the first three.

Counterpart of cosmos_predict2_tpu/ops/flash_attention.py::flash_attention
(``_fwd`` / ``_fwd_kernel``, ``_bwd`` / ``_dq_kernel`` / ``_dkv_kernel``,
tied together by ``jax.custom_vjp``). BSHD in and out; the forward also
returns the row logsumexp (B, H, Sq) in fp32, which :class:`FlashAttention`
saves with q, k, v and the output for the backward, as the JAX custom VJP
does. The TPU version's block auto-pick, padding and BHSD transposes stay
behind: the CUDA kernels index BSHD directly and mask the ragged tails
themselves.

The cache decode (counterparts of ``flash_attention_kv_cache`` and
``flash_attention_kv_cache_window``) takes BSHD queries of a new block and
HEAD-MAJOR (B, H, S_max, 128) ring buffers filled to ``kv_valid`` (a host
int), as in the JAX package, and returns only the output. It has no
backward here: the JAX package's VJP recomputes through the plain
reference, and only self-forcing training (not ported) needs it.
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


# ------------------------- kv-cache decode (K5, K6) -------------------------


def _check_cache(name, q, k_buf, v_buf, kv_valid):
    """Shapes and fill level, checked on every device."""
    B, Sq, H, D = q.shape
    if k_buf.ndim != 4 or k_buf.shape[:2] != (B, H) or k_buf.shape[3] != D or v_buf.shape != k_buf.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} needs head-major (B, H, S_max, D) buffers, "
                         f"got k {tuple(k_buf.shape)} v {tuple(v_buf.shape)}")
    if not 0 < kv_valid <= k_buf.shape[2]:
        raise ValueError(f"{name}: kv_valid {kv_valid} outside [1, S_max={k_buf.shape[2]}]")


def kv_cache_plain(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int) -> torch.Tensor:
    """K5's function in plain PyTorch (JAX ``_kv_cache_reference``): fp32
    logits and softmax over the first ``kv_valid`` buffer positions, P
    rounded to v's dtype for P @ V, output in q's dtype. Positions past
    ``kv_valid`` would take exp(-1e30 - m) = 0 in the JAX reference, so they
    are left out here."""
    _check_cache("kv_cache_plain", q, k_buf, v_buf, kv_valid)
    k, v = k_buf[:, :, :kv_valid], v_buf[:, :, :kv_valid]
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bqhd", probs.to(v.dtype).float(), v.float()).to(q.dtype)


def window_rows_bounds(rows: torch.Tensor, grid_hw: tuple[int, int], window_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For token indices ``rows`` of a block of whole frames (row-major
    (frame, row, col) on a gh x gw grid), the first and one-past-last
    visible key ROW of each cached frame: ``wh = min(window_rows, gh)`` rows
    starting at clip(y - (wh - 1) // 2, 0, gh - wh) (JAX ``_window_start``)."""
    gh, gw = grid_hw
    wh = min(window_rows, gh)
    start = ((rows % (gh * gw)) // gw - (wh - 1) // 2).clamp(0, gh - wh)
    return start, start + wh


def _check_window(name, q, k_buf, kv_valid, grid_hw, window_rows):
    """The frame-granular contract of the cache window, on every device:
    Sq, S_max and kv_valid whole frames of gh * gw tokens (the TPU kernel
    gave NaN for a kv_valid that is not, flash_attention.py:391)."""
    gh, gw = grid_hw
    F = gh * gw
    if gh < 1 or gw < 1 or window_rows < 1:
        raise ValueError(f"{name}: grid {grid_hw} and window_rows {window_rows} must be positive")
    for what, n in (("Sq", q.shape[1]), ("S_max", k_buf.shape[2]), ("kv_valid", kv_valid)):
        if n % F:
            raise ValueError(f"{name}: {what}={n} is not a whole number of {gh}x{gw}-token frames")


def kv_cache_window_plain(
    q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int, grid_hw: tuple[int, int],
    window_rows: int,
) -> torch.Tensor:
    """K6's function in plain PyTorch (JAX ``_kv_cache_window_reference``):
    query row y sees, in every filled frame, the full-width key rows of its
    clamped window; otherwise as :func:`kv_cache_plain`."""
    _check_cache("kv_cache_window_plain", q, k_buf, v_buf, kv_valid)
    _check_window("kv_cache_window_plain", q, k_buf, kv_valid, grid_hw, window_rows)
    gh, gw = grid_hw
    k, v = k_buf[:, :, :kv_valid], v_buf[:, :, :kv_valid]
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    lo, hi = window_rows_bounds(torch.arange(q.shape[1], device=q.device), grid_hw, window_rows)
    yk = (torch.arange(kv_valid, device=q.device) % (gh * gw)) // gw
    visible = (yk[None, :] >= lo[:, None]) & (yk[None, :] < hi[:, None])
    probs = torch.softmax(logits.masked_fill(~visible, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bqhd", probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_cache_cuda(name, q, k_buf, v_buf):
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: head_dim must be {HEAD_DIM}, got {q.shape[-1]}")
    for tname, t in (("q", q), ("k_buf", k_buf), ("v_buf", v_buf)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {tname} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")


def flash_attention_kv_cache(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int) -> torch.Tensor:
    """Streaming-decode attention of the new block's queries q (B, Sq, H,
    128) over the first ``kv_valid`` positions of the head-major ring
    buffers k_buf / v_buf (B, H, S_max, 128); the block sees itself whole.

    CPU tensors take :func:`kv_cache_plain`. CUDA tensors launch K5, which
    takes contiguous bf16 tensors and raises on anything else.
    """
    if not q.is_cuda:
        return kv_cache_plain(q, k_buf, v_buf, kv_valid)
    _check_cache("flash_attention_kv_cache", q, k_buf, v_buf, kv_valid)
    _check_cache_cuda("flash_attention_kv_cache", q, k_buf, v_buf)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    if Sq == 0 or B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_kv_cache(
            q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(),
            B, Sq, k_buf.shape[2], H, kv_valid, 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_kv_cache")
    flash_attention_kv_cache.launches += 1
    return out


flash_attention_kv_cache.launches = 0


def flash_attention_kv_cache_window(
    q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int, grid_hw: tuple[int, int],
    window_rows: int,
) -> torch.Tensor:
    """Row-windowed streaming-decode attention: q (B, Sq, H, 128) holds
    whole frames of the (gh, gw) = ``grid_hw`` token grid, row-major; the
    head-major buffers hold whole frames too, ``kv_valid`` of their tokens
    filled. Query row y sees, in every filled frame, the full-width key rows
    [s, s + wh) with wh = min(window_rows, gh) and s = clip(y - (wh - 1) //
    2, 0, gh - wh). Raises ValueError on either device for an Sq, S_max or
    kv_valid that is not a whole number of frames.

    CPU tensors take :func:`kv_cache_window_plain`. CUDA tensors launch K6,
    which takes contiguous bf16 tensors and raises on anything else.
    """
    if not q.is_cuda:
        return kv_cache_window_plain(q, k_buf, v_buf, kv_valid, grid_hw, window_rows)
    _check_cache("flash_attention_kv_cache_window", q, k_buf, v_buf, kv_valid)
    _check_window("flash_attention_kv_cache_window", q, k_buf, kv_valid, grid_hw, window_rows)
    _check_cache_cuda("flash_attention_kv_cache_window", q, k_buf, v_buf)
    B, Sq, H, D = q.shape
    gh, gw = grid_hw
    out = torch.empty_like(q)
    if Sq == 0 or B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_kv_cache_window(
            q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(),
            B, Sq, k_buf.shape[2], H, kv_valid, gh, gw, min(window_rows, gh), 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_kv_cache_window")
    flash_attention_kv_cache_window.launches += 1
    return out


flash_attention_kv_cache_window.launches = 0
