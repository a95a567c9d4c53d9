"""Ring attention: sequence-parallel attention by point-to-point K/V hops.

Counterpart of cosmos_predict2_tpu/parallel/ring_attention.py, the second
context-parallel strategy beside Ulysses (parallel/cp.py). Each rank keeps
its queries; the K/V shards travel around the ring, one hop per step, and
each incoming block is folded into a running (out, lse) in fp32. Ring moves
K/V once around the ring (c - 1 hops) and takes any cp degree; Ulysses
moves q, k, v and the output through all-to-alls and needs c to divide the
heads.

Design: the JAX package's per-block body is a plain einsum with an online
softmax (``_block_attn``), and its backward is autodiff of that ring. Here
each block is K1 (ops/flash_attention.py::flash_attention_fwd), which
returns the block's normalized output and its row logsumexp; the blocks
merge by their lse. The next hop is posted (``batch_isend_irecv``) before
the current block's kernel and waited on after it, so the transfer can
overlap the compute.

The backward (:class:`RingAttention`) runs the ring again with the global
row lse the forward merged and delta = rowsum(dO * O), computed once: at
each step the rank adds K7's dq of its queries against the visiting block
to an fp32 dq, and K8's dK / dV of that block to fp32 accumulators that
travel with the block's K/V; after c steps one more hop brings each rank
its own dK / dV. K7 and K8 take lse and delta as inputs, so each block is
one call of each with the global lse, unchanged; they round each block's
dq, dk and dv to bf16, and the c partials are summed in fp32 and cast once
(at cp 4 on 84,480 tokens, 2.7e-3 relative L2 from K7 / K8 on the whole
sequence: chip_smoke.py phase 21(b), held at 1e-2; the plain route in fp32
agrees with the JAX package's ring to 2e-5, tests/test_torch_ring_attention.py).
The K/V hop is posted before the block's kernels and waited after them;
the dK / dV hop is posted after K8 and waited after the next block's K7.

``frame_group`` (token i sees token j iff j // fg <= i // fg, global
indices) works per block, forward and backward: a source shard before mine
is fully visible (the kernels with no mask), my own shard takes their local
mask, a later shard is skipped (its tensors still travel on). That needs
S_local % frame_group == 0; on a CUDA tensor anything else raises
ValueError. The plain versions (CPU tensors) apply the elementwise mask
with global offsets and take every case.
"""

from __future__ import annotations

import torch

from cosmos_predict2_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _dkv_plain,
    _dq_plain,
    attention_delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    saved_or_computed,
)
from cosmos_predict2_tpu_torch.parallel import comm


def block_logits(q: torch.Tensor, k: torch.Tensor, q0: int, k0: int, frame_group: int) -> torch.Tensor:
    """Scaled fp32 logits (B, H, Sq, Skv) of q rows (tokens q0 + i) against
    k rows (tokens k0 + j), masked to -inf by the frame-group rule over
    those global indices."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    if frame_group > 0:
        row = (q0 + torch.arange(q.shape[1], device=q.device))[:, None] // frame_group
        col = (k0 + torch.arange(k.shape[1], device=q.device))[None, :] // frame_group
        logits = logits.masked_fill(col > row, float("-inf"))
    return logits


def block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int, k0: int, frame_group: int):
    """One K/V block in plain PyTorch with the global-offset mask. Returns
    (out in q's dtype, lse (B, H, Sq) fp32); a fully masked row gets lse
    -inf."""
    logits = block_logits(q, k, q0, k0, frame_group)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse.clamp(min=NEG_INF)[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def block_grads_plain(q, k, v, do, lse, delta, q0: int, k0: int, frame_group: int):
    """K7's and K8's functions on one block in plain PyTorch, with the
    global-offset mask and the global row ``lse``: (dq, dk, dv) of the
    block, each rounded to its input's dtype as the kernels round it."""
    probs = torch.exp(block_logits(q, k, q0, k0, frame_group) - lse[..., None])  # masked logits give exactly 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (probs * (dp - delta[..., None])).to(q.dtype).float()
    return (_dq_plain(ds, q, k), *_dkv_plain(probs, ds, q, k, v, do))


def merge(acc, block):
    """Fold a block's (out, lse) into the running (out fp32, lse fp32)."""
    out, lse = acc
    o_i, lse_i = block
    new = torch.logaddexp(lse, lse_i)
    a = torch.exp(lse - new).nan_to_num(0.0).transpose(1, 2)[..., None]  # (B, Sq, H, 1)
    b = torch.exp(lse_i - new).nan_to_num(0.0).transpose(1, 2)[..., None]
    return out * a + o_i.float() * b, new


def _visible(src: int, r: int, frame_group: int) -> int | None:
    """The kernels' frame group for rank r's queries against source shard
    ``src``: 0 (unmasked) or ``frame_group`` (its own shard), None when
    every key comes after every query."""
    if frame_group <= 0 or src < r:
        return 0
    return frame_group if src == r else None


def ring_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, frame_group: int):
    """The ring's forward: (out in q's dtype, global row lse (B, H, S_local) fp32)."""
    c, r = comm.group_size(group), comm.group_rank(group)
    B, Sl, H, D = q.shape
    acc = (torch.zeros((B, Sl, H, D), dtype=torch.float32, device=q.device),
           torch.full((B, H, Sl), float("-inf"), dtype=torch.float32, device=q.device))
    kv = torch.stack([k, v]).contiguous()
    nxt, prv = (r + 1) % c, (r - 1) % c
    for step in range(c):
        src = (r - step) % c
        requests, incoming = [], None
        if step < c - 1:
            incoming = torch.empty_like(kv)
            requests = comm.exchange([(kv, nxt)], [(incoming, prv)], group)
        if not q.is_cuda:
            acc = merge(acc, block_plain(q, kv[0], kv[1], r * Sl, src * Sl, frame_group))
        elif (fg := _visible(src, r, frame_group)) is not None:
            acc = merge(acc, flash_attention_fwd(q, kv[0], kv[1], frame_group=fg))
        comm.wait(requests)
        if incoming is not None:
            kv = incoming
    out, lse = acc
    return out.to(q.dtype), lse


def ring_backward(q, k, v, out, lse, do, group, frame_group: int):
    """(dq, dk, dv) of the ring at this rank's (q, k, v) for its output
    gradient ``do``, from the forward's ``out`` and global ``lse``."""
    c, r = comm.group_size(group), comm.group_rank(group)
    B, Sl, H, D = q.shape
    do = do.contiguous()
    delta = attention_delta(out, do)
    dq = torch.zeros((B, Sl, H, D), dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2, B, Sl, H, D), dtype=torch.float32, device=q.device)  # of the visiting shard
    kv = torch.stack([k, v]).contiguous()
    nxt, prv = (r + 1) % c, (r - 1) % c
    pending, dkv_in = [], None  # the dK / dV hop in flight
    for step in range(c):
        src = (r - step) % c
        requests, incoming = [], None
        if step < c - 1:
            incoming = torch.empty_like(kv)
            requests = comm.exchange([(kv, nxt)], [(incoming, prv)], group)
        grads = None  # this block's (dq, dk, dv), or None for a block every query skips
        if not q.is_cuda:
            grads = block_grads_plain(q, kv[0], kv[1], do, lse, delta, r * Sl, src * Sl, frame_group)
        elif (fg := _visible(src, r, frame_group)) is not None:
            grads = (flash_attention_bwd_dq(q, kv[0], kv[1], do, lse, delta, fg),)
        if grads is not None:
            dq += grads[0].float()
        comm.wait(pending)
        if dkv_in is not None:
            dkv = dkv_in
        if grads is not None:
            dk_b, dv_b = grads[1:] if not q.is_cuda else flash_attention_bwd_dkv(q, kv[0], kv[1], do, lse, delta, fg)
            dkv[0] += dk_b.float()
            dkv[1] += dv_b.float()
        if c > 1:  # on to the next rank; after the last step, home to the shard's own rank
            dkv_in = torch.empty_like(dkv)
            pending = comm.exchange([(dkv, nxt)], [(dkv_in, prv)], group)
        comm.wait(requests)
        if incoming is not None:
            kv = incoming
    comm.wait(pending)
    if dkv_in is not None:
        dkv = dkv_in
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingAttention(torch.autograd.Function):
    """:func:`ring_attention` under autograd: the forward saves the local
    q, k, v, the merged output and the global lse; the backward is
    :func:`ring_backward`. Under the DiT's selective remat the forward's
    (out, lse) are kept and handed back to the block's recompute, which
    then runs no ring. ``RingAttention.apply(q, k, v, group, frame_group)``."""

    @staticmethod
    def forward(ctx, q, k, v, group, frame_group: int):
        out, lse = saved_or_computed(lambda: ring_forward(q, k, v, group, frame_group), like=q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.frame_group = group, frame_group
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, do, ctx.group, ctx.frame_group)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, frame_group: int = 0) -> torch.Tensor:
    """Sequence-parallel self-attention. q, k, v: this rank's (B, S_local,
    H, D) share of the sequence (rank order is token order) -> its share of
    the output, in q's dtype. Differentiable."""
    B, Sl, H, D = q.shape
    if k.shape != (B, Sl, H, D) or v.shape != k.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.is_cuda and frame_group > 0 and Sl % frame_group:
        raise ValueError(f"ring_attention: frame_group {frame_group} must divide the local sequence {Sl} on the "
                         "card (block-level masks)")
    return RingAttention.apply(q, k, v, group, frame_group)
