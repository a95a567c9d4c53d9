"""Flash attention with a fused forward-mode derivative: the Hopper kernel
(csrc/flash_attention_jvp.cu: K9), its plain PyTorch version and the
forward-mode autograd Function.

Counterpart of cosmos_predict2_tpu/ops/flash_attention_jvp.py
(``_jvp_kernel`` / ``_jvp_bhsd``, tied to ``flash_attention_fwdmode`` by
``jax.custom_jvp``). With s = scale q k^T, p = softmax(s), o = p v and the
input tangents (dq, dk, dv):

    ds = scale (dq k^T + q dk^T)
    do = [sum_j p_j ds_j v_j + sum_j p_j dv_j] / l - (r / l) o,   r = sum_j p_j ds_j

which one online-softmax pass over the KV tiles accumulates beside the
primal output. BSHD in and out, as the JAX wrapper; the TPU version's BHSD
transposes, block auto-pick and padding stay behind (K9 indexes BSHD and
masks the kv tail itself).

One difference from the JAX package: under ``torch.func.jvp`` (or
``torch.autograd.forward_ad``) :class:`FlashAttentionFwdMode` runs its
``forward`` (K1, the primal) and then its ``jvp`` (K9, whose primal output
is dropped), so the port launches K1 and K9 once each where JAX's
custom_jvp launches K9 alone. PyTorch's Function computes the primal
before it asks for the tangent.
"""

from __future__ import annotations

import torch

from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import HEAD_DIM, attention_logits, flash_attention_fwd


def flash_attention_jvp_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
    frame_group: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's function in plain PyTorch, BSHD: (o, do) in q's dtype.

    fp32 logits and tangent logits with the same masks (masked logits take
    the finite -1e30, so P = 0 there and P ds = 0); P and P ds rounded to
    v's dtype before their products with V, P to dv's before P dV (as the
    kernel does); ``do = acc_t / l - (r / l) o`` with ``o`` the fp32
    quotient, not the rounded output (JAX flash_attention_jvp.py:111-116).
    """
    s = attention_logits(q, k, frame_group)
    scale = 1.0 / q.shape[-1] ** 0.5
    ds = (torch.einsum("bqhd,bkhd->bhqk", dq.float(), k.float())
          + torch.einsum("bqhd,bkhd->bhqk", q.float(), dk.float())) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    l = p.sum(-1)
    pds = p * ds
    del ds
    r = pds.sum(-1)
    pv = lambda a, t: torch.einsum("bhqk,bkhd->bhqd", a.to(t.dtype).float(), t.float())  # noqa: E731
    acc_t = pv(pds, v)
    del pds
    acc_t += pv(p, dv)
    o = pv(p, v) / l[..., None]
    do = acc_t / l[..., None] - (r / l)[..., None] * o
    bshd = lambda t: t.transpose(1, 2).to(q.dtype)  # noqa: E731
    return bshd(o), bshd(do)


def flash_attention_jvp(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
    frame_group: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, do) of attention at (q, k, v) along the tangents (dq, dk, dv):
    q, dq (B, Sq, H, 128), k, v, dk, dv (B, Skv, H, 128); ``frame_group`` >
    0: key i visible to query j iff i // frame_group <= j // frame_group.
    The tangents are cast to their primal's dtype first (JAX
    flash_attention_jvp.py:191-194).

    CPU tensors take :func:`flash_attention_jvp_plain`. CUDA tensors launch
    K9, which takes contiguous bf16 tensors with head_dim 128 on one device
    and raises on anything else.
    """
    dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if not q.is_cuda:
        return flash_attention_jvp_plain(q, k, v, dq, dk, dv, frame_group)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention_jvp: head_dim must be {HEAD_DIM}, got {D}")
    if k.shape != (B, Skv, H, D) or v.shape != k.shape or dk.shape != k.shape or dv.shape != k.shape \
            or dq.shape != q.shape:
        raise ValueError(f"flash_attention_jvp: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"dq {tuple(dq.shape)} dk {tuple(dk.shape)} dv {tuple(dv.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dq", dq), ("dk", dk), ("dv", dv)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_jvp: {name} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention_jvp: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_jvp: {name} must be contiguous and 16-byte aligned")
    if frame_group < 0:
        raise ValueError(f"flash_attention_jvp: frame_group must be >= 0, got {frame_group}")
    out, dout = torch.empty_like(q), torch.empty_like(q)
    if Sq == 0 or B == 0:
        return out, dout
    if Skv == 0:
        raise ValueError("flash_attention_jvp: empty key sequence")
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_attention_jvp(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), out.data_ptr(),
            dout.data_ptr(), B, Sq, Skv, H, frame_group, 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_jvp")
    flash_attention_jvp.launches += 1
    return out, dout


flash_attention_jvp.launches = 0


class FlashAttentionFwdMode(torch.autograd.Function):
    """Flash attention with a forward-mode derivative: ``forward`` runs
    :func:`flash_attention_fwd` (K1), as the JAX primal runs
    ``flash_attention``; ``jvp`` runs :func:`flash_attention_jvp` (K9) and
    returns its tangent ``do``. A tangent that is None (an input without
    one) counts as zeros, as JAX's SymbolicZero does. Both
    ``torch.func.jvp`` and ``torch.autograd.forward_ad`` reach ``jvp``.

    It has no ``backward``: as in the JAX package, reverse mode goes
    through :class:`~cosmos_predict2_tpu_torch.ops.flash_attention.FlashAttention`
    (K7, K8), and a backward through this Function raises.
    ``FlashAttentionFwdMode.apply(q, k, v, frame_group)``.
    """

    @staticmethod
    def forward(q, k, v, frame_group: int = 0):
        return flash_attention_fwd(q, k, v, frame_group=frame_group)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, frame_group = inputs
        ctx.save_for_forward(q, k, v)
        ctx.frame_group = frame_group

    @staticmethod
    def jvp(ctx, dq, dk, dv, _):
        # Under torch.func.jvp the saved primals and the tangents arrive
        # wrapped by functorch (no storage, so no data pointer for K9), and
        # every op made while its layer is active wraps its result again:
        # unwrap them and run K9 with functorch's dispatch off. The plain
        # tangent returned is taken as the tangent of the single jvp level;
        # nested transforms (vmap of jvp, jvp of jvp) are not supported.
        with torch._C._DisableFuncTorch():
            q, k, v = (_unwrapped(t) for t in ctx.saved_tensors)
            dq, dk, dv = (torch.zeros_like(p) if t is None else _unwrapped(t).contiguous()
                          for p, t in zip((q, k, v), (dq, dk, dv)))
            return flash_attention_jvp(q, k, v, dq, dk, dv, ctx.frame_group)[1]


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor under torch.func's wrappers."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def flash_attention_fwdmode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, frame_group: int = 0) -> torch.Tensor:
    """Flash attention in BSHD for networks under ``torch.func.jvp`` /
    ``forward_ad``: the primal is K1's output, the tangent K9's."""
    return FlashAttentionFwdMode.apply(q, k, v, frame_group)
