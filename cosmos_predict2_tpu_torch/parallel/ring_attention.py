"""Ring attention: sequence-parallel attention by point-to-point K/V hops.

Counterpart of cosmos_predict2_tpu/parallel/ring_attention.py, the second
context-parallel strategy beside Ulysses (parallel/cp.py). Each rank keeps
its queries; the K/V shards travel around the ring, one hop per step, and
each incoming block is folded into a running (out, lse) in fp32. Ring moves
K/V once around the ring (c - 1 hops) and takes any cp degree; Ulysses
moves q, k, v and the output through all-to-alls and needs c to divide the
heads.

Design: the JAX package's per-block body is a plain einsum with an online
softmax (``_block_attn``). Here each block is K1
(ops/flash_attention.py::flash_attention_fwd), which returns the block's
normalized output and its row logsumexp; the blocks merge by their lse. The
next hop is posted (``batch_isend_irecv``) before the current block's
kernel and waited on after it, so the transfer can overlap the compute.

``frame_group`` (token i sees token j iff j // fg <= i // fg, global
indices) works per block: a source shard before mine is fully visible (K1
with no mask), my own shard takes K1's local mask, a later shard is skipped
(its K/V still travel on). That needs S_local % frame_group == 0; on a CUDA
tensor anything else raises ValueError. The plain version (CPU tensors)
applies the elementwise mask with global offsets and takes every case.

Forward only: under autograd it raises (the ring's backward, K7 / K8 with
the global lse and dK / dV travelling with the ring, is not written yet).
"""

from __future__ import annotations

import torch

from cosmos_predict2_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_fwd
from cosmos_predict2_tpu_torch.parallel import comm


def block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int, k0: int, frame_group: int):
    """One K/V block in plain PyTorch with the global-offset mask: q rows
    are tokens q0 + i, k rows tokens k0 + j. Returns (out in q's dtype,
    lse (B, H, Sq) fp32); a fully masked row gets lse -inf."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    if frame_group > 0:
        row = (q0 + torch.arange(q.shape[1], device=q.device))[:, None] // frame_group
        col = (k0 + torch.arange(k.shape[1], device=q.device))[None, :] // frame_group
        logits = logits.masked_fill(col > row, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse.clamp(min=NEG_INF)[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def merge(acc, block):
    """Fold a block's (out, lse) into the running (out fp32, lse fp32)."""
    out, lse = acc
    o_i, lse_i = block
    new = torch.logaddexp(lse, lse_i)
    a = torch.exp(lse - new).nan_to_num(0.0).transpose(1, 2)[..., None]  # (B, Sq, H, 1)
    b = torch.exp(lse_i - new).nan_to_num(0.0).transpose(1, 2)[..., None]
    return out * a + o_i.float() * b, new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, frame_group: int = 0) -> torch.Tensor:
    """Sequence-parallel self-attention. q, k, v: this rank's (B, S_local,
    H, D) share of the sequence (rank order is token order) -> its share of
    the output, in q's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("ring_attention: forward only (the ring's backward is not written yet)")
    c, r = comm.group_size(group), comm.group_rank(group)
    B, Sl, H, D = q.shape
    if k.shape != (B, Sl, H, D) or v.shape != k.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.is_cuda and frame_group > 0 and Sl % frame_group:
        raise ValueError(f"ring_attention: frame_group {frame_group} must divide the local sequence {Sl} on the "
                         "card (block-level masks)")
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
        elif frame_group <= 0 or src < r:
            acc = merge(acc, flash_attention_fwd(q, kv[0], kv[1]))
        elif src == r:
            acc = merge(acc, flash_attention_fwd(q, kv[0], kv[1], frame_group=frame_group))
        comm.wait(requests)
        if incoming is not None:
            kv = incoming
    out, _ = acc
    return out.to(q.dtype)
