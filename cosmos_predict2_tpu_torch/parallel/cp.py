"""Context parallelism: Ulysses all-to-all attention over a process group.

Counterpart of cosmos_predict2_tpu/parallel/cp.py (the reference's
a2a_cp.py:45-226, NCCL ``all_to_all_single`` around flash attention). Layout
(B, S, H, D). Entering attention each rank of the cp group holds S/c of the
sequence and all H heads; the first all-to-all regroups to the full S and
H/c heads, the local kernel runs on the whole sequence, and the second
all-to-all restores (S/c, H). The collectives are the autograd-aware ones
(parallel/comm.py), so a gradient flows back through them.

The local op is K1 (ops/flash_attention.py::flash_attention_fwd, through the
differentiable ``dot_product_attention``) with ``frame_group`` passed
through, or with ``na`` set K10 (ops/neighborhood_attention.py) on the
gathered sequence with H/c heads: the reference's ``NattenA2AAttnOp``. The
JAX package's ``sparse_switch`` (a traced dense / sparse choice under its
``scan_uniform`` block scan, a TPU compile workaround) has no counterpart:
the port runs its blocks unrolled, each with its own attention.

:func:`ulysses_kv_cache_attention` is the streaming decode under CP: the
ring buffers are head-sharded (B, H/c, S_max, D) and never move; only the
new block crosses ranks, and each rank runs K5 (or K6 with a row window)
over its heads' cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from cosmos_predict2_tpu_torch.ops.attention import dot_product_attention
from cosmos_predict2_tpu_torch.ops.neighborhood_attention import neighborhood_attention
from cosmos_predict2_tpu_torch.parallel import comm


def _check_divisible(name: str, seq: int, heads: int, c: int) -> None:
    if seq % c or heads % c:
        raise ValueError(f"{name}: tokens ({seq}) and heads ({heads}) must both divide the cp={c} degree for the "
                         "all-to-alls")


def scatter_heads(t: torch.Tensor, group) -> torch.Tensor:
    """(B, S/c, H, D) on each rank -> (B, S, H/c, D): this rank's heads of
    the whole sequence."""
    c = comm.group_size(group)
    B, s, H, D = t.shape
    chunks = t.reshape(B, s, c, H // c, D).permute(2, 0, 1, 3, 4)  # chunk j: heads of rank j
    got = comm.all_to_all(chunks, group)  # chunk j: rank j's tokens of my heads
    return got.permute(1, 0, 2, 3, 4).reshape(B, c * s, H // c, D)


def gather_heads(t: torch.Tensor, group) -> torch.Tensor:
    """(B, S, H/c, D) -> (B, S/c, H, D): the inverse of :func:`scatter_heads`."""
    c = comm.group_size(group)
    B, S, h, D = t.shape
    chunks = t.reshape(B, c, S // c, h, D).transpose(0, 1)  # chunk j: rank j's tokens
    got = comm.all_to_all(chunks, group)  # chunk j: my tokens of rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // c, c * h, D)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, frame_group: int = 0, na: Optional[tuple] = None,
) -> torch.Tensor:
    """Sequence-parallel self-attention. q, k, v: this rank's (B, S/c, H, D)
    share of the sequence (rank order is token order) -> its share of the
    output. ``frame_group`` > 0: frame-block causal over global token
    indices. ``na`` = (video_size, window, stride, dilation) of the whole
    sequence: neighborhood attention instead. Raises unless c divides the
    heads and the sequence."""
    c = comm.group_size(group)
    _check_divisible("ulysses_attention", c * q.shape[1], q.shape[2], c)
    ql, kl, vl = (scatter_heads(t, group).contiguous() for t in (q, k, v))
    if na is not None:
        out = neighborhood_attention(ql, kl, vl, *na)
    else:
        out = dot_product_attention(ql, kl, vl, frame_group=frame_group)
    return gather_heads(out, group)


def ulysses_kv_cache_attention(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, kv_cache: dict, group,
    cache_window: Optional[tuple] = None,
) -> tuple[torch.Tensor, dict]:
    """Sequence-parallel streaming decode. q / k_new / v_new: this rank's
    (B, S_blk/c, H, D) share of the new block's tokens; ``kv_cache``: this
    rank's head shard of the ring buffers, (B, H/c, S_max, D) k / v, and the
    filled length ``len`` (the same on every rank). After the head scatter
    each rank holds the whole block's queries for its heads, so it writes
    the block's k / v into its buffers at [len, len + S_blk) in place and
    runs the cache decode (networks/dit.py::cached_attention: K5, or K6 with
    ``cache_window`` = ((gh, gw), rows), whose row window applies per head
    shard unchanged). Returns (its share of the output, the cache with
    ``len`` advanced)."""
    from cosmos_predict2_tpu_torch.networks.dit import cached_attention

    c = comm.group_size(group)
    _check_divisible("ulysses_kv_cache_attention", c * q.shape[1], q.shape[2], c)
    if kv_cache["k"].shape[1] * c != q.shape[2]:
        raise ValueError(f"ulysses_kv_cache_attention: the cache holds {kv_cache['k'].shape[1]} heads, a head shard "
                         f"of {q.shape[2]} over cp={c} is {q.shape[2] // c}")
    ql, kl, vl = (scatter_heads(t, group).contiguous() for t in (q, k_new, v_new))
    out, new_cache = cached_attention(ql, kl, vl, kv_cache, cache_window)
    return gather_heads(out, group), new_cache
