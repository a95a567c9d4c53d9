"""Flash attention, forward and backward, and the KV-cache decode: the
Hopper kernels (csrc/flash_attention_fwd.cu: K1, K5 cache decode and K6
row-windowed cache decode; csrc/flash_attention_bwd.cu: K7 dQ and K8
dK/dV), their plain PyTorch versions and the autograd Function over K1, K7
and K8.

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
int), as in the JAX package, and returns only the output. Its gradient
(:class:`KvCacheAttention`, :func:`kv_cache_vjp`) is the JAX package's VJP:
a recompute through the plain masked reference, with no backward kernel
(the JAX package has none for K5 or K6); self-forcing training takes it.

:class:`SavedAttention` carries the DiT's "selective" activation
checkpointing: within one block's checkpointed run it keeps each attention
forward's (out, lse) and hands them back, in order, when the backward
recomputes the block, so that the recompute launches no attention forward
(K1, or K10 in a sparse block). It is the counterpart of the JAX package's
policy ``save_only_these_names("attn_out")``; PyTorch's own selective
checkpoint policies see only dispatcher ops, not a kernel launched through
ctypes inside an autograd Function.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import functools
import heapq
from typing import Callable

import torch

from cosmos_predict2_tpu_torch import _build

HEAD_DIM = 128
NEG_INF = -1e30
# K8's tiles: kv rows per CTA, q rows per step; a split of a kv tile's q range
# covers at least DKV_MIN_SPLIT_TILES steps, so that loading K and V and
# writing the fp32 partials stay small beside its products
DKV_BLOCK_KV = 128
DKV_BLOCK_Q = 64
DKV_MIN_SPLIT_TILES = 4
# K5's tiles: q rows per CTA, kv rows per step. Its split plan's cost model,
# in the time of one kv step of a CTA (~1.8 us on the H100: 0.215 ms for
# the 117 steps of the interactive steady state): a CTA's fixed cost (the q
# tile's load, the ring's fill, the epilogue), and the bytes the card moves
# in that time at ~3 TB/s (the split route writes and reads back fp32
# partials)
KV_BLOCK_Q = 128
KV_BLOCK_KV = 128
KV_SPLIT_CTA_STEPS = 1.0
KV_SPLIT_BYTES_PER_STEP = 5.7e6
KV_MAX_SPLITS = 8
# K6's tiles: q rows per CTA (two consumer warpgroups of WINDOW_WG_ROWS),
# kv rows per step (kBlockQ, kWindowBlockKV in csrc/flash_attention_fwd.cu);
# its split plan's range (scripts/kv_window_variants.py sweeps 1-4)
WINDOW_BLOCK_Q = 128
WINDOW_BLOCK_KV = 128
WINDOW_WG_ROWS = 64
WINDOW_MAX_SPLITS = 4


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


@dataclasses.dataclass(frozen=True)
class DkvPlan:
    """How K8 covers the q range of each of its 128-row kv tiles: in
    ``splits`` CTAs, each over a run of 64-row q tiles (see
    :func:`dkv_split_plan`)."""

    sq: int
    skv: int
    frame_group: int
    splits: int

    @property
    def kv_tiles(self) -> int:
        return -(-self.skv // DKV_BLOCK_KV)

    def q_ranges(self, kv_tile: int) -> list[tuple[int, int]]:
        """The q rows [begin, end) of each split of ``kv_tile``, in split
        order: the q tiles from the first one holding a query that sees the
        tile's first key (frame_group > 0; else from 0) to the end, cut into
        ``splits`` runs of ceil(n / splits) tiles, the last ones short or
        empty. The kernel computes the same runs (dkv_q_chunk in
        csrc/flash_attention_bwd.cu)."""
        q_tiles = -(-self.sq // DKV_BLOCK_Q)
        first = 0
        if self.frame_group > 0:
            first = (kv_tile * DKV_BLOCK_KV // self.frame_group) * self.frame_group // DKV_BLOCK_Q
        per = -(-max(q_tiles - first, 0) // self.splits)
        ranges = []
        for split in range(self.splits):
            begin = min(first + split * per, q_tiles)
            end = min(begin + per, q_tiles)
            ranges.append((min(begin * DKV_BLOCK_Q, self.sq), min(end * DKV_BLOCK_Q, self.sq)))
        return ranges


def dkv_split_plan(sq: int, skv: int, heads: int, batch: int, frame_group: int, sms: int) -> DkvPlan:
    """K8's plan: one CTA per (kv tile, head, batch) fills the card when
    there are at least ``sms`` of them (one 384-thread CTA per SM). Fewer
    (cross-attention to 512 text tokens: 4 x 16 at batch 1) split each kv
    tile's q range over up to sms // CTAs CTAs, each covering at least
    DKV_MIN_SPLIT_TILES q tiles; their fp32 partials are summed in split
    order by a second pass."""
    ctas = -(-skv // DKV_BLOCK_KV) * heads * batch
    splits = 1
    if 0 < ctas < sms:
        splits = max(1, min(sms // ctas, -(-sq // DKV_BLOCK_Q) // DKV_MIN_SPLIT_TILES))
    return DkvPlan(sq, skv, frame_group, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    frame_group: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Skv, H, 128), with the arguments of
    :func:`flash_attention_bwd_dq`. CPU tensors take the plain version; CUDA
    tensors launch K8 and raise on what it does not take. On a grid under
    one wave (:func:`dkv_split_plan`) K8 writes fp32 partials into scratch
    allocated here and a second kernel sums them; that is one launch."""
    if not q.is_cuda:
        return _dkv_plain(*_probs_ds(q, k, v, do, lse, delta, frame_group), q, k, v, do)
    _check_bwd_args("flash_attention_bwd_dkv", q, k, v, do, lse, delta, frame_group)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if Skv == 0 or B == 0:
        return dk, dv
    splits = dkv_split_plan(Sq, Skv, H, B, frame_group, _sm_count(q.device)).splits
    partial_k = partial_v = None
    if splits > 1:
        partial_k, partial_v = (torch.empty((splits, *k.shape), dtype=torch.float32, device=k.device) for _ in range(2))
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if partial_k is None else partial_k.data_ptr(),
            None if partial_v is None else partial_v.data_ptr(), B, Sq, Skv, H, frame_group, splits, 1.0 / D**0.5,
            stream,
        )
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# (store, replaying) of the checkpointed block being run in this thread, if any
_SAVED_ATTENTION: contextvars.ContextVar = contextvars.ContextVar("saved_attention", default=None)


class SavedAttention:
    """The attention results of one checkpointed block: ``contexts()`` gives
    the (forward, recompute) pair that ``torch.utils.checkpoint``'s
    ``context_fn`` takes. Under the first, :func:`saved_or_computed` computes
    and keeps each result; under the second it hands them back in the same
    order, computing nothing, and lets go of each. A second recompute of the
    block (a second backward through it) finds nothing kept and raises, as
    PyTorch's own selective checkpointing does."""

    def __init__(self):
        self.results: collections.deque = collections.deque()
        self.kept = 0

    def contexts(self):
        return _SavedAttentionContext(self, False), _SavedAttentionContext(self, True)


class _SavedAttentionContext:
    """Makes a :class:`SavedAttention` the active one; may be entered again
    (the checkpoint enters its recompute context at every recompute)."""

    def __init__(self, store: SavedAttention, replaying: bool):
        self.active, self.tokens = (store, replaying), []

    def __enter__(self):
        self.tokens.append(_SAVED_ATTENTION.set(self.active))

    def __exit__(self, *exc):
        _SAVED_ATTENTION.reset(self.tokens.pop())


def saved_or_computed(compute: Callable[[], tuple], like: torch.Tensor) -> tuple:
    """``compute()``, kept by the active :class:`SavedAttention` in a
    block's forward and taken back from it in the block's recompute; plain
    ``compute()`` outside a selective block. The result's first tensor has
    the shape, dtype and device of ``like``; a replayed one that does not,
    or a replay past what the forward kept, raises."""
    active = _SAVED_ATTENTION.get()
    if active is None:
        return compute()
    store, replaying = active
    if not replaying:
        result = compute()
        store.results.append(tuple(t.detach() for t in result))
        store.kept += 1
        return result
    if not store.results:
        raise RuntimeError(
            f"selective remat: a recompute of the block asked for more attention results than the {store.kept} its "
            "forward kept; a block under selective remat is backpropagated through once (a second backward with "
            "retain_graph=True is refused, as PyTorch's own selective checkpointing refuses it)")
    result = store.results.popleft()
    out = result[0]
    if (out.shape, out.dtype, out.device) != (like.shape, like.dtype, like.device):
        raise RuntimeError(
            f"selective remat: the recompute's attention call {store.kept - len(store.results)} of the block wants a "
            f"result like {tuple(like.shape)} {like.dtype} on {like.device}, the forward kept {tuple(out.shape)} "
            f"{out.dtype} on {out.device}: the recompute does not call attention in the forward's order")
    return result


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward by :func:`flash_attention_fwd`
    (K1), backward by :func:`flash_attention_bwd_dq` (K7) and
    :func:`flash_attention_bwd_dkv` (K8) on the card, by the plain versions
    on the CPU. ``FlashAttention.apply(q, k, v, frame_group)``."""

    @staticmethod
    def forward(ctx, q, k, v, frame_group: int = 0):
        out, lse = saved_or_computed(lambda: flash_attention_fwd(q, k, v, frame_group=frame_group), like=q)
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


@dataclasses.dataclass(frozen=True)
class KvCachePlan:
    """How K5 covers the fill: its 128-row kv tiles cut into ``splits`` runs
    (see :func:`kv_cache_split_plan`), one CTA per (q tile, head, batch,
    run)."""

    kv_valid: int
    splits: int

    @property
    def kv_tiles(self) -> int:
        return -(-self.kv_valid // KV_BLOCK_KV)

    def tile_runs(self) -> list[tuple[int, int]]:
        """The kv tiles [begin, end) of each run, in split order: run s
        covers [s T // splits, (s + 1) T // splits) of the T tiles, as the
        kernel computes them (csrc/flash_attention_fwd.cu)."""
        T = self.kv_tiles
        return [(s * T // self.splits, (s + 1) * T // self.splits) for s in range(self.splits)]

    def kv_ranges(self) -> list[tuple[int, int]]:
        """The cache rows [begin, end) of each run, the last cut at the fill."""
        return [(b * KV_BLOCK_KV, min(e * KV_BLOCK_KV, self.kv_valid)) for b, e in self.tile_runs()]


@functools.lru_cache(maxsize=None)
def kv_cache_split_plan(sq: int, kv_valid: int, heads: int, batch: int, sms: int) -> KvCachePlan:
    """K5's split-KV plan (flash-decoding). One CTA per (128 q rows, head,
    batch) walks all T kv tiles of the fill; with ``splits`` runs there are
    that many times the CTAs (one 384-thread CTA per SM), each walking
    about T / splits tiles, plus a second pass over fp32 partials. The plan
    takes the splits (at most T and KV_MAX_SPLITS) of least estimated time:
    waves x (tiles per run + a CTA's fixed cost) + the partials' traffic,
    ties to fewer splits. At the interactive path's 112 CTAs a run is one
    wave whatever the split, so one split; a query block of one or two q
    tiles over a long cache splits."""
    ctas = -(-sq // KV_BLOCK_Q) * heads * batch
    tiles = -(-kv_valid // KV_BLOCK_KV)
    partial_bytes = batch * sq * heads * (HEAD_DIM + 1) * 4 * 2  # each split's partials, written and read back

    def cost(splits: int) -> float:
        steps = -(-ctas * splits // sms) * (-(-tiles // splits) + KV_SPLIT_CTA_STEPS)
        return steps + (splits * partial_bytes / KV_SPLIT_BYTES_PER_STEP if splits > 1 else 0.0)

    splits = min(range(1, min(tiles, KV_MAX_SPLITS) + 1), key=lambda s: (cost(s), s))
    return KvCachePlan(kv_valid, splits)


def kv_cache_split_plain(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int,
                         plan: KvCachePlan) -> torch.Tensor:
    """K5's split route in plain PyTorch: for each run of ``plan`` the
    normalised partial output (P rounded to v's dtype, as in
    :func:`kv_cache_plain`) and its lse in fp32, then the second pass: their
    lse-weighted sum shifted by the max lse, in split order; output in q's
    dtype."""
    _check_cache("kv_cache_split_plain", q, k_buf, v_buf, kv_valid)
    outs, lses = [], []
    for begin, end in plan.kv_ranges():
        k, v = k_buf[:, :, begin:end], v_buf[:, :, begin:end]
        logits = torch.einsum("bqhd,bhkd->bqhk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.exp(logits - lse[..., None])
        outs.append(torch.einsum("bqhk,bhkd->bqhd", probs.to(v.dtype).float(), v.float()))
        lses.append(lse)
    m = torch.stack(lses).max(dim=0).values
    out, wsum = torch.zeros_like(outs[0]), torch.zeros_like(m)
    for o_s, lse_s in zip(outs, lses):
        w = torch.exp(lse_s - m)
        out = out + w[..., None] * o_s
        wsum = wsum + w
    return (out / wsum[..., None]).to(q.dtype)


def window_rows_bounds(rows: torch.Tensor, grid_hw: tuple[int, int], window_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For token indices ``rows`` of a block of whole frames (row-major
    (frame, row, col) on a gh x gw grid), the first and one-past-last
    visible key ROW of each cached frame: ``wh = min(window_rows, gh)`` rows
    starting at clip(y - (wh - 1) // 2, 0, gh - wh) (JAX ``_window_start``)."""
    gh, gw = grid_hw
    wh = min(window_rows, gh)
    start = ((rows % (gh * gw)) // gw - (wh - 1) // 2).clamp(0, gh - wh)
    return start, start + wh


def window_union(first: int, rows: int, sq: int, grid_hw: tuple[int, int], window_rows: int) -> tuple[int, int]:
    """The tokens [lo, hi), from a frame's start, that the query rows
    [first, min(first + rows, sq)) see in each cached frame: the union of
    their row windows, contiguous because the window's start is monotone in
    the row; every row of the frame for a run of rows that crosses a frame;
    (0, 0) for no rows. K6 computes the same (window_union in
    csrc/flash_attention_fwd.cu)."""
    gh, gw = grid_hw
    wh, F = min(window_rows, gh), gh * gw
    last = min(first + rows, sq) - 1
    if last < first:
        return 0, 0
    y_min, y_max = ((first % F) // gw, (last % F) // gw) if first // F == last // F else (0, gh - 1)
    start = lambda y: min(max(y - (wh - 1) // 2, 0), gh - wh)  # noqa: E731
    return start(y_min) * gw, (start(y_max) + wh) * gw


@dataclasses.dataclass(frozen=True)
class WindowTile:
    """One kv tile of K6's walk: its first cache row, that row's position
    from the start of its frame, and a bit per consumer warpgroup (64 q
    rows) that computes it."""

    row: int
    local: int
    wg_bits: int


def kv_window_walk(sq: int, kv_valid: int, grid_hw: tuple[int, int], window_rows: int,
                   block_q: int = WINDOW_BLOCK_Q, block_kv: int = WINDOW_BLOCK_KV) -> list[list[WindowTile]]:
    """K6's walk, as the kernel computes it in closed form (window_walk in
    csrc/flash_attention_fwd.cu), for each ``block_q``-row q tile: in each of
    the kv_valid // (gh gw) filled frames in turn, the CTA's window union
    cut into ``block_kv``-row tiles from its start (the last one may run
    past the union, into other rows or the next frame, which the mask
    removes). Its producer loads every tile; a consumer warpgroup computes
    a tile that meets its own rows' union and releases the others."""
    gh, gw = grid_hw
    F = gh * gw
    walk = []
    for q0 in range(0, sq, block_q):
        lo, hi = window_union(q0, block_q, sq, grid_hw, window_rows)
        wg_unions = [window_union(q0 + w * WINDOW_WG_ROWS, WINDOW_WG_ROWS, sq, grid_hw, window_rows)
                     for w in range(block_q // WINDOW_WG_ROWS)]
        tiles = []
        for f in range(kv_valid // F):
            for local in range(lo, hi, block_kv):
                bits = sum(1 << w for w, (a, b) in enumerate(wg_unions) if local < b and local + block_kv > a)
                tiles.append(WindowTile(f * F + local, local, bits))
        walk.append(tiles)
    return walk


def window_walk_pairs(sq: int, kv_valid: int, grid_hw: tuple[int, int], window_rows: int,
                      block_q: int = WINDOW_BLOCK_Q, block_kv: int = WINDOW_BLOCK_KV) -> dict[str, int]:
    """Per (batch, head): the (query, key) pairs the window makes visible,
    those K6's walk loads (block_q x block_kv per tile) and those its
    consumer warpgroups compute (64 x block_kv per warpgroup and tile)."""
    gh, gw = grid_hw
    walk = kv_window_walk(sq, kv_valid, grid_hw, window_rows, block_q, block_kv)
    return {
        "visible": sq * min(window_rows, gh) * gw * (kv_valid // (gh * gw)),
        "loaded": sum(len(tiles) for tiles in walk) * block_q * block_kv,
        "computed": sum(bin(t.wg_bits).count("1") for tiles in walk for t in tiles) * WINDOW_WG_ROWS * block_kv,
    }


@functools.lru_cache(maxsize=None)
def kv_window_split_plan(sq: int, kv_valid: int, grid_hw: tuple[int, int], window_rows: int, heads: int,
                         batch: int, sms: int) -> int:
    """K6's split count: its frame walk cut into that many runs of whole
    frames (run s covers frames [s F // splits, (s + 1) F // splits) of the
    F filled), one CTA per (q tile, head, batch, run), their fp32 partials
    combined by K5's second pass. A CTA's cost, in kv steps, is its run's
    frames times its q tile's tiles per frame (:func:`kv_window_walk`; q
    tiles that cross a frame walk whole frames) plus K5's
    KV_SPLIT_CTA_STEPS; the CTAs go in launch order to whichever SM frees
    first (one 384-thread CTA per SM). The plan takes the splits (at most
    WINDOW_MAX_SPLITS and F) of least makespan plus the partials' traffic
    (as K5's plan counts it), ties to fewer: one at the interactive steady
    state (112 CTAs, one wave), more where the grid's last wave leaves SMs
    idle (two-frame blocks, 720p)."""
    gh, gw = grid_hw
    frames = kv_valid // (gh * gw)
    per_frame = [len(tiles) // frames for tiles in kv_window_walk(sq, kv_valid, grid_hw, window_rows)]
    partial_bytes = batch * sq * heads * (HEAD_DIM + 1) * 4 * 2  # each split's partials, written and read back

    def cost(splits: int) -> float:
        free = [0.0] * sms  # when each SM is next free
        for _ in range(batch):
            for s in range(splits):
                run = (s + 1) * frames // splits - s * frames // splits
                for _ in range(heads):
                    for n in per_frame:
                        heapq.heapreplace(free, free[0] + run * n + KV_SPLIT_CTA_STEPS)
        return max(free) + (splits * partial_bytes / KV_SPLIT_BYTES_PER_STEP if splits > 1 else 0.0)

    return min(range(1, min(frames, WINDOW_MAX_SPLITS) + 1), key=lambda s: (cost(s), s))


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
    takes contiguous bf16 tensors and raises on anything else. When
    :func:`kv_cache_split_plan` splits the fill, K5 writes fp32 partials
    into one scratch tensor allocated here and a second kernel combines
    them; that is one launch.
    """
    if not q.is_cuda:
        return kv_cache_plain(q, k_buf, v_buf, kv_valid)
    _check_cache("flash_attention_kv_cache", q, k_buf, v_buf, kv_valid)
    _check_cache_cuda("flash_attention_kv_cache", q, k_buf, v_buf)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    if Sq == 0 or B == 0:
        return out
    splits = kv_cache_split_plan(Sq, kv_valid, H, B, _sm_count(q.device)).splits
    partial_o = partial_lse = None
    if splits > 1:
        rows = splits * B * Sq * H
        scratch = torch.empty(rows * (D + 1), dtype=torch.float32, device=q.device)
        partial_o, partial_lse = scratch[: rows * D], scratch[rows * D:]
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_kv_cache(
            q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(),
            None if partial_o is None else partial_o.data_ptr(), None if partial_lse is None else partial_lse.data_ptr(),
            B, Sq, k_buf.shape[2], H, kv_valid, splits, 1.0 / D**0.5, stream,
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
    which takes contiguous bf16 tensors and raises on anything else. When
    :func:`kv_window_split_plan` splits the frames, K6 writes fp32 partials
    into one scratch tensor allocated here and K5's second kernel combines
    them; that is one launch.
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
    splits = kv_window_split_plan(Sq, kv_valid, (gh, gw), window_rows, H, B, _sm_count(q.device))
    partial_o = partial_lse = None
    if splits > 1:
        rows = splits * B * Sq * H
        scratch = torch.empty(rows * (D + 1), dtype=torch.float32, device=q.device)
        partial_o, partial_lse = scratch[: rows * D], scratch[rows * D:]
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cosmos_flash_kv_cache_window(
            q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(),
            None if partial_o is None else partial_o.data_ptr(), None if partial_lse is None else partial_lse.data_ptr(),
            B, Sq, k_buf.shape[2], H, kv_valid, gh, gw, min(window_rows, gh), splits, 1.0 / D**0.5, stream,
        )
    _build.check(err, "flash_attention_kv_cache_window")
    flash_attention_kv_cache_window.launches += 1
    return out


flash_attention_kv_cache_window.launches = 0


# ------------------------- the cache decode under autograd -------------------------


def kv_cache_vjp(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int, do: torch.Tensor,
                 cache_window: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk_buf, dv_buf) of the cache decode at the cotangent ``do``: the
    JAX package's VJP (``_flash_kv_cache_bwd``, ``_flash_kv_cache_window_bwd``),
    autograd through the plain masked reference, :func:`kv_cache_plain` or,
    with ``cache_window`` = (grid_hw, window_rows), :func:`kv_cache_window_plain`
    (whose whole-frame check holds here too). Buffer rows past ``kv_valid``
    get zeros. Each call adds one to ``kv_cache_vjp.recomputes``."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k_buf, v_buf))
        if cache_window is None:
            out = kv_cache_plain(qd, kd, vd, kv_valid)
        else:
            out = kv_cache_window_plain(qd, kd, vd, kv_valid, *cache_window)
        grads = torch.autograd.grad(out, (qd, kd, vd), do)
    kv_cache_vjp.recomputes += 1
    return grads


kv_cache_vjp.recomputes = 0


def kv_cache_attention(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, kv_valid: int,
                       cache_window: tuple | None = None) -> torch.Tensor:
    """The cache decode, :func:`flash_attention_kv_cache` (K5) or with
    ``cache_window`` = (grid_hw, window_rows) :func:`flash_attention_kv_cache_window`
    (K6)."""
    if cache_window is None:
        return flash_attention_kv_cache(q, k_buf, v_buf, kv_valid)
    return flash_attention_kv_cache_window(q, k_buf, v_buf, kv_valid, *cache_window)


class KvCacheAttention(torch.autograd.Function):
    """Differentiable cache decode: the forward is :func:`kv_cache_attention`
    (K5 / K6 on the card, their plain versions on the CPU), the backward
    :func:`kv_cache_vjp`. It saves q and both buffers, so autograd refuses a
    backward after a buffer was written in place.
    ``KvCacheAttention.apply(q, k_buf, v_buf, kv_valid, cache_window)``."""

    @staticmethod
    def forward(ctx, q, k_buf, v_buf, kv_valid: int, cache_window: tuple | None = None):
        ctx.save_for_backward(q, k_buf, v_buf)
        ctx.kv_valid, ctx.cache_window = kv_valid, cache_window
        return kv_cache_attention(q, k_buf, v_buf, kv_valid, cache_window)

    @staticmethod
    def backward(ctx, do):
        q, k_buf, v_buf = ctx.saved_tensors
        return (*kv_cache_vjp(q, k_buf, v_buf, ctx.kv_valid, do, ctx.cache_window), None, None)
