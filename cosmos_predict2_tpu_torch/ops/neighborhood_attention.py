"""3D neighborhood (sparse local) attention: the Hopper kernels
(csrc/neighborhood_attention.cu: K10 forward, K11 dQ, K12 dK/dV), their
plain PyTorch versions, the host-side plan and the autograd Function over
them.

Counterpart of cosmos_predict2_tpu/ops/neighborhood_attention.py. Each
video token (t, h, w) attends the keys inside a per-axis window centred on
the query and clamped at the borders (window -1: the whole axis), with the
GNA stride (queries of a stride group share their representative's window)
and DiNA dilation (attention inside each interleaved sub-grid).

The host side is the JAX package's, copied (NumPy and PyTorch layout
code): tokens are permuted into spatial-tile-major order, the (H, W) grid
cut into 4 x 16 tiles and laid out as (tile_h, tile_w, t, intra_h,
intra_w), so a 64-row tile is one t-slice of one spatial tile and its
coordinates are bit math on the row index; ``build_plan`` lists, for each
``block``-row q block, the kv blocks that can hold a key of its window
(``table``, ``counts``) and the exact transpose of that list for the dK/dV
pass (``tableT``, ``countsT``). From those the port builds the walks the
kernels follow (``fwd_walk`` for K10 and K11, ``dkv_walk`` for K12: the
128-row tiles each CTA loads after the t test). Dilation is a class-major reorder of the axis
that turns dilated attention into blocked attention (window == stride ==
sub-grid length), so the kernels take window and stride only.

Public entry: :func:`neighborhood_attention` on BSHD tensors. CUDA tensors
run K10 in the forward and K11 and K12 in the backward; CPU tensors take
the plain versions, which walk the same plan. A geometry whose dilation the
kernels cannot express raises ``NotImplementedError`` on either device (the
JAX package sends small cases of it to its dense masked reference).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import saved_or_computed

HEAD_DIM = 128
NEG_INF = -1e30
L_MIN = 1e-20  # row sums are clamped here, so fully masked (pad) rows stay finite
# torch.profiler range around the layout copies (permute_in / permute_out) of each call
LAYOUT_RANGE = "neighborhood_attention.layout"

# spatial tile of the permuted layout; 4 * 16 = 64 = 2^6 tokens per t-slice
TILE_H = 4
TILE_W = 16
PER_T = TILE_H * TILE_W


class VideoSize(NamedTuple):
    T: int
    H: int
    W: int


# ---------------------------------------------------------------------------
# window math and the dense mask
# ---------------------------------------------------------------------------


def _rep(ci, stride: int):
    """GNA stride: the queries of a stride group share the window of the
    group's representative (its centre)."""
    if stride <= 1:
        return ci
    return (ci // stride) * stride + (stride - 1) // 2


def _axis_window_ok(ci, cj, length: int, window: int, stride: int = 1, dilation: int = 1):
    """NA membership along one axis with clamped window centres (None: the
    whole axis). ``dilation`` > 1 evaluates the clamped window on the
    sub-grid of positions with equal index mod ``dilation``."""
    if dilation > 1:
        cls_i = ci % dilation
        same = cls_i == (cj % dilation)
        sub_len = (length - cls_i + dilation - 1) // dilation
        if window < 0 or window >= (length + dilation - 1) // dilation:
            return same
        r_lo = (window - 1) // 2
        r_hi = window - 1 - r_lo
        center = torch.minimum(torch.clamp(_rep(ci // dilation, stride), min=r_lo), sub_len - 1 - r_hi)
        cj_sub = cj // dilation
        return same & (cj_sub >= center - r_lo) & (cj_sub <= center + r_hi)
    if window < 0 or window >= length:
        return None
    r_lo = (window - 1) // 2
    r_hi = window - 1 - r_lo
    center = torch.clamp(_rep(ci, stride), r_lo, length - 1 - r_hi)
    return (cj >= center - r_lo) & (cj <= center + r_hi)


def _decompose(idx, size: VideoSize):
    hw = size.H * size.W
    return idx // hw, (idx % hw) // size.W, idx % size.W


def na_mask(rows, cols, size: VideoSize, window, stride=(1, 1, 1), dilation=(1, 1, 1)):
    """Visibility of key ``cols`` to query ``rows`` (token-major indices,
    broadcast against each other); None when every pair is visible."""
    rt, rh, rw = _decompose(rows, size)
    ct, ch, cw = _decompose(cols, size)
    mask = None
    for ci, cj, length, w, st, dl in (
        (rt, ct, size.T, window[0], stride[0], dilation[0]),
        (rh, ch, size.H, window[1], stride[1], dilation[1]),
        (rw, cw, size.W, window[2], stride[2], dilation[2]),
    ):
        ok = _axis_window_ok(ci, cj, length, w, st, dl)
        if ok is not None:
            mask = ok if mask is None else mask & ok
    return mask


def _nearest_divisor(length: int, d: int) -> int:
    """Largest divisor of ``length`` that is <= d (d >= 1)."""
    d = max(1, min(d, length))
    while length % d:
        d -= 1
    return d


def adaptive_na_parameters(window, stride, input_shape, base_size, dilation=(1, 1, 1)):
    """Scale the window, stride and dilation tuned at ``base_size`` to the
    input's (T, H, W): (-1, 12, 24) at base (T, 44, 80) becomes (-1, 6, 12)
    at a 22 x 40 grid. Window <= 1 or base <= 0 entries mean the whole axis."""
    window = tuple(w if w > 1 else x for x, w in zip(input_shape, window))
    if base_size is not None:
        base = tuple(b if b > 0 else x for x, b in zip(input_shape, base_size))
        scale = tuple(x / b for x, b in zip(input_shape, base))
        window = tuple(min(max(2, round(w * s)), x) for w, s, x in zip(window, scale, input_shape))
        stride = tuple(min(max(1, round(st * s)), w) for w, s, st in zip(window, scale, stride))
        max_dil = tuple(x // w for x, w in zip(input_shape, window))
        dilation = tuple(min(max(1, round(d * s)), md) for d, s, md in zip(dilation, scale, max_dil))
        dilation = tuple(_nearest_divisor(x, dl) for x, dl in zip(input_shape, dilation))
    assert all(w >= st for w, st in zip(window, stride)), (window, stride)
    assert all(x >= w * d for x, w, d in zip(input_shape, window, dilation)), (window, dilation)
    return tuple(window), tuple(stride), tuple(dilation)


def effective_params(size: VideoSize, window, stride, dilation):
    """Window and stride on the class-major reordered axes. A dilation that
    divides its axis, with a window covering the whole sub-grid, is blocked
    attention there (window == stride == sub-grid length); anything else
    raises NotImplementedError."""
    ew, es = [], []
    for L, w_, st_, dl in zip(size, window, stride, dilation):
        if dl <= 1:
            ew.append(w_)
            es.append(st_)
            continue
        if L % dl != 0:
            raise NotImplementedError(f"dilation {dl} must divide axis length {L}")
        sub = L // dl
        if 0 <= w_ < sub:
            raise NotImplementedError(f"dilated window {w_} < sub-grid {sub}: the kernels take a full sub-grid window")
        ew.append(sub)
        es.append(sub)
    return tuple(ew), tuple(es)


def visible_pairs(video_size, window) -> int:
    """(query, key) pairs inside the windows for an effective window: every
    real query sees the same number of keys (clamped windows)."""
    per_query = 1
    for L, w in zip(video_size, window):
        per_query *= w if 0 <= w < L else L
    return int(np.prod(video_size)) * per_query


# ---------------------------------------------------------------------------
# the plan (host side)
# ---------------------------------------------------------------------------


class NAPlan(NamedTuple):
    size: VideoSize  # true (T, H, W)
    dilation: tuple
    t_pad: int  # T padded to a multiple of bt
    nth: int  # spatial tile grid (H axis)
    ntw: int  # spatial tile grid (W axis)
    bt: int  # t-slices per block
    block: int  # rows of a q / kv block (64 * bt)
    s_pad: int
    coords: np.ndarray  # (n_blocks, 3) int32: (t0, h0, w0) of each block
    table: np.ndarray  # (n_blocks, max_cnt) kv block ids per q block, padded with the last id
    counts: np.ndarray  # (n_blocks,)
    tableT: np.ndarray  # (n_blocks, max_cntT) q block ids per kv block (exact transpose)
    countsT: np.ndarray  # (n_blocks,)
    window: tuple  # the effective window and stride the tables were built for
    stride: tuple
    walk: np.ndarray  # (S_pad / 128, max_len) K10's schedule (fwd_walk)
    walk_counts: np.ndarray  # (S_pad / 128,)
    walkT: np.ndarray  # (S_pad / 128, max_lenT) K12's schedule (dkv_walk)
    walkT_counts: np.ndarray  # (S_pad / 128,)
    device_tables: dict  # str(device) -> coords and the walks as int32 tensors there (plan_tensors)


def _axis_overlap(w: int, length: int, q_lo: int, q_hi: int, k_lo: int, k_hi: int, stride: int = 1) -> bool:
    """Can a key in [k_lo, k_hi] fall in the clamped window of a query in
    [q_lo, q_hi]? (exact: the stride representative is monotonic)"""
    if stride > 1:
        q_lo = (q_lo // stride) * stride + (stride - 1) // 2
        q_hi = (q_hi // stride) * stride + (stride - 1) // 2
    r_lo = (w - 1) // 2
    r_hi = w - 1 - r_lo
    lo = max(min(q_lo, length - 1 - r_hi), r_lo) - r_lo
    hi = min(max(q_hi, r_lo), length - 1 - r_hi) + r_hi
    return k_hi >= lo and k_lo <= hi


@functools.lru_cache(maxsize=32)
def build_plan(size: VideoSize, window: tuple, stride: tuple, dilation: tuple, block_cap: int = 512) -> NAPlan:
    """The block tables of one geometry (``window`` and ``stride`` are the
    effective ones). Cached by geometry, as the JAX package's ``_build_plan``."""
    T, H, W = size
    nth = -(-H // TILE_H)
    ntw = -(-W // TILE_W)
    # an even number of t-slices per block, T padded to a multiple of it:
    # the least padding, then the larger block
    cap_bt = max(2, min(8, max(block_cap, PER_T) // PER_T))
    bt = min(range(2, cap_bt + 1, 2), key=lambda b_: (-(-T // b_) * b_, -b_))
    t_pad = -(-T // bt) * bt
    block = PER_T * bt
    sb = PER_T * t_pad  # superblock: one spatial tile, all (padded) frames
    s_pad = nth * ntw * sb
    nblk = s_pad // block
    per_sb = sb // block

    m = np.arange(nblk)
    sb_idx = m // per_sb
    coords = np.stack([(m % per_sb) * bt, (sb_idx // ntw) * TILE_H, (sb_idx % ntw) * TILE_W], axis=1).astype(np.int32)

    wt, wh, ww = window
    st_t, st_h, st_w = stride
    rows: list[list[int]] = []
    for i in range(nblk):
        qt0, qh0, qw0 = (int(x) for x in coords[i])
        if qt0 >= T or qh0 >= H or qw0 >= W:  # a block of pad slots only: no work
            rows.append([])
            continue
        qt1, qh1, qw1 = min(qt0 + bt, T) - 1, min(qh0 + TILE_H, H) - 1, min(qw0 + TILE_W, W) - 1
        keep: list[int] = []
        for j in range(nblk):
            kt0, kh0, kw0 = (int(x) for x in coords[j])
            if kt0 >= T or kh0 >= H or kw0 >= W:
                continue
            ok = True
            if 0 <= wt < T:
                ok = _axis_overlap(wt, T, qt0, qt1, kt0, min(kt0 + bt, T) - 1, st_t)
            if ok and 0 <= wh < H:
                ok = _axis_overlap(wh, H, qh0, qh1, kh0, min(kh0 + TILE_H, H) - 1, st_h)
            if ok and 0 <= ww < W:
                ok = _axis_overlap(ww, W, qw0, qw1, kw0, min(kw0 + TILE_W, W) - 1, st_w)
            if ok:
                keep.append(j)
        rows.append(keep)

    def pack(row_lists):
        cnt = np.asarray([len(r) for r in row_lists], dtype=np.int32)
        tab = np.zeros((len(row_lists), max(int(cnt.max()), 1)), dtype=np.int32)
        for i_, r in enumerate(row_lists):
            tab[i_, : len(r)] = r
            tab[i_, len(r):] = r[-1] if r else 0
        return tab, cnt

    table, counts = pack(rows)
    rows_t: list[list[int]] = [[] for _ in range(nblk)]
    for i, r in enumerate(rows):
        for j in r:
            rows_t[j].append(i)
    table_t, counts_t = pack(rows_t)
    t_vis = _t_visibility(T, t_pad, wt, st_t)
    walk, walk_counts = _pack_walk(fwd_walk(coords, table, counts, bt, t_vis))
    walk_t, walk_t_counts = _pack_walk(dkv_walk(coords, table_t, counts_t, bt, t_vis))
    return NAPlan(
        VideoSize(T, H, W), tuple(dilation), t_pad, nth, ntw, bt, block, s_pad, coords, table, counts, table_t,
        counts_t, tuple(window), tuple(stride), walk, walk_counts, walk_t, walk_t_counts, {},
    )


# ---------------------------------------------------------------------------
# the kernels' walks (host side): which tiles each CTA of K10 and K12 loads
# ---------------------------------------------------------------------------

TILE_ROWS = 2 * PER_T  # rows of a K10 q tile or a K12 kv tile: two t-slices of one block (bt is even)


def _t_visibility(T: int, t_pad: int, window: int, stride: int) -> np.ndarray:
    """(t_pad, t_pad) bool: frame ``j`` lies in the t-window of frame ``i``,
    both real frames (pad frames are neither queries nor keys)."""
    t = torch.arange(t_pad)
    vis = (t < T)[:, None] & (t < T)[None, :]
    ok = _axis_window_ok(t[:, None], t[None, :], T, window, stride)
    return (vis if ok is None else vis & ok).numpy()


def fwd_walk(coords: np.ndarray, table: np.ndarray, counts: np.ndarray, bt: int,
             t_vis: np.ndarray) -> list[np.ndarray]:
    """K10's schedule. For each 128-row q tile x (t-slices 2u and 2u + 1 of
    block x // (bt / 2), u = x % (bt / 2)), in table order, the 128-row kv
    tiles of its table row's blocks that some row of the tile sees on the t
    axis: entries ``kv_tile << 4 | bits``, bit 2 wg + half set where the q
    tile's t-slice wg sees the kv tile's t-slice half (``t_vis``, from
    :func:`_t_visibility`). The h and w axes are left to the kernel's mask."""
    half = bt // 2
    walks = []
    for x in range(coords.shape[0] * half):
        qblk, u = divmod(x, half)
        tq = int(coords[qblk, 0]) + 2 * u
        ids = table[qblk, : counts[qblk]].astype(np.int64)
        kv_tiles = (ids[:, None] * half + np.arange(half)[None, :]).reshape(-1)  # table order, then t
        tk = coords[ids, 0][:, None] + 2 * np.arange(half)[None, :]
        bits = np.zeros(tk.shape, dtype=np.int64)
        for wg in range(2):
            for h in range(2):
                bits |= t_vis[tq + wg, tk + h].astype(np.int64) << (2 * wg + h)
        bits = bits.reshape(-1)
        walks.append((kv_tiles[bits != 0] << 4) | bits[bits != 0])
    return walks


def dkv_walk(coords: np.ndarray, table_t: np.ndarray, counts_t: np.ndarray, bt: int,
             t_vis: np.ndarray) -> list[np.ndarray]:
    """K12's schedule. For each 128-row kv tile x (t-slices 2u and 2u + 1 of
    block x // (bt / 2)), in transposed-table order, the 64-row q t-slices
    of its ``tableT`` row's blocks whose t-window holds one of the tile's
    t-slices: entries ``q_slice << 2 | bits``, bit wg set where the kv tile's
    t-slice wg lies in the window (the query's window, since clamped NA is
    not symmetric)."""
    half = bt // 2
    walks = []
    for x in range(coords.shape[0] * half):
        kblk, u = divmod(x, half)
        tk = int(coords[kblk, 0]) + 2 * u
        ids = table_t[kblk, : counts_t[kblk]].astype(np.int64)
        q_slices = (ids[:, None] * bt + np.arange(bt)[None, :]).reshape(-1)
        tq = (coords[ids, 0][:, None] + np.arange(bt)[None, :]).reshape(-1)
        bits = t_vis[tq, tk].astype(np.int64) | t_vis[tq, tk + 1].astype(np.int64) << 1
        walks.append((q_slices[bits != 0] << 2) | bits[bits != 0])
    return walks


def _pack_walk(walks: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    counts = np.asarray([len(w) for w in walks], dtype=np.int32)
    packed = np.zeros((len(walks), max(int(counts.max()), 1)), dtype=np.int32)
    for i, w in enumerate(walks):
        packed[i, : len(w)] = w
    return packed, counts


def walk_computed_pairs(plan: NAPlan) -> dict[str, int]:
    """(query, key) pairs per (batch, head) that K10, K11 and K12 compute
    on their walks: K10 64 x 128 per (consumer warpgroup, kv tile) it sees,
    K11 64 x 64 per (warpgroup, kv half) it sees, K12 64 x 64 per
    (warpgroup, q t-slice)."""
    fwd = [plan.walk[x, :n] for x, n in enumerate(plan.walk_counts)]
    tiles = sum(int(((e & 3) != 0).sum() + ((e & 12) != 0).sum()) for e in fwd)
    halves = sum(int(sum(((e >> bit) & 1).sum() for bit in range(4))) for e in fwd)
    dkv = sum(int((plan.walkT[x, :n] & 1).sum() + ((plan.walkT[x, :n] >> 1) & 1).sum())
              for x, n in enumerate(plan.walkT_counts))
    return {"na_fwd": tiles * 64 * TILE_ROWS, "na_bwd_dq": halves * 64 * 64, "na_bwd_dkv": dkv * 64 * 64}


def plan_tensors(plan: NAPlan, device: torch.device) -> dict[str, torch.Tensor]:
    """What the kernels read of the plan (the block coordinates and the
    walks) as int32 tensors on ``device``, uploaded once per (plan, device),
    since plans are cached by geometry: a per-call host-to-device copy would
    run at every sparse block."""
    key = str(device)
    if key not in plan.device_tables:
        plan.device_tables[key] = {
            name: torch.from_numpy(np.ascontiguousarray(getattr(plan, name))).to(device)
            for name in ("coords", "walk", "walk_counts", "walkT", "walkT_counts")
        }
    return plan.device_tables[key]


# ---------------------------------------------------------------------------
# layout: BSHD token-major <-> (B, heads, S_pad, D) tiled
# ---------------------------------------------------------------------------


def _dilation_reorder(x, axis: int, dl: int, inverse: bool = False):
    """Class-major reorder of one axis (i = m * dl + c  <->  n = c * sub + m)."""
    if dl <= 1:
        return x
    L = x.shape[axis]
    sub = L // dl
    shape = x.shape[:axis] + ((dl, sub) if inverse else (sub, dl)) + x.shape[axis + 1:]
    x = x.reshape(shape).transpose(axis, axis + 1)
    return x.reshape(x.shape[:axis] + (L,) + x.shape[axis + 2:])


def permute_in(x: torch.Tensor, plan: NAPlan) -> torch.Tensor:
    """(B, S, heads, D) token-major -> contiguous (B, heads, S_pad, D) tiled
    layout; pad slots are zero (the kernels mask them by coordinates)."""
    B, _, Hh, D = x.shape
    T, H, W = plan.size
    x = x.reshape(B, T, H, W, Hh, D)
    for axis, dl in zip((1, 2, 3), plan.dilation):
        x = _dilation_reorder(x, axis, dl)
    padded = x.new_zeros((B, plan.t_pad, plan.nth * TILE_H, plan.ntw * TILE_W, Hh, D))
    padded[:, :T, :H, :W] = x
    x = padded.reshape(B, plan.t_pad, plan.nth, TILE_H, plan.ntw, TILE_W, Hh, D)
    x = x.permute(0, 6, 2, 4, 1, 3, 5, 7)  # (B, heads, tile_h, tile_w, t, ih, iw, D)
    return x.reshape(B, Hh, plan.s_pad, D).contiguous()  # a view where the grid is one tile: the kernels need rows


def permute_out(xt: torch.Tensor, plan: NAPlan) -> torch.Tensor:
    """(B, heads, S_pad, D) tiled -> (B, S, heads, D) token-major, the exact
    inverse of :func:`permute_in` (pad slots dropped)."""
    B, Hh, _, D = xt.shape
    T, H, W = plan.size
    x = xt.reshape(B, Hh, plan.nth, plan.ntw, plan.t_pad, TILE_H, TILE_W, D)
    x = x.permute(0, 4, 2, 5, 3, 6, 1, 7)  # (B, t, tile_h, ih, tile_w, iw, heads, D)
    x = x.reshape(B, plan.t_pad, plan.nth * TILE_H, plan.ntw * TILE_W, Hh, D)[:, :T, :H, :W]
    for axis, dl in zip((1, 2, 3), plan.dilation):
        x = _dilation_reorder(x, axis, dl, inverse=True)
    return x.reshape(B, T * H * W, Hh, D)


# ---------------------------------------------------------------------------
# plain versions: the kernels' functions, one q block at a time over the plan
# ---------------------------------------------------------------------------


def _block_coords(plan: NAPlan, blocks: np.ndarray, device) -> tuple[torch.Tensor, ...]:
    """(t, h, w) of every row of ``blocks`` (block ids), (len(blocks) * block,)."""
    intra = torch.arange(plan.block, device=device)
    base = torch.from_numpy(plan.coords[blocks].astype(np.int64)).to(device)  # (n, 3)
    return tuple((base[:, a:a + 1] + off[None, :]).reshape(-1)
                 for a, off in enumerate((intra >> 6, (intra & 63) >> 4, intra & 15)))


def _pair_mask(plan: NAPlan, qblk: int, kv_blocks: np.ndarray, window, stride, device) -> torch.Tensor:
    """(block, n * block) visibility of the kv blocks' rows to q block
    ``qblk``'s rows: pad slots are neither keys nor queries."""
    T, H, W = plan.size
    tq, hq, wq = _block_coords(plan, np.asarray([qblk]), device)
    tk, hk, wk = _block_coords(plan, kv_blocks, device)
    mask = ((tq < T) & (hq < H) & (wq < W))[:, None] & ((tk < T) & (hk < H) & (wk < W))[None, :]
    for ci, cj, length, w_, st_ in ((tq, tk, T, window[0], stride[0]), (hq, hk, H, window[1], stride[1]),
                                    (wq, wk, W, window[2], stride[2])):
        ok = _axis_window_ok(ci[:, None], cj[None, :], length, w_, st_)
        if ok is not None:
            mask = mask & ok
    return mask


def _gather(xt: torch.Tensor, plan: NAPlan, blocks: np.ndarray) -> torch.Tensor:
    """Rows of ``blocks`` of a (B, heads, S_pad, D) tensor, in fp32."""
    B, Hh, _, D = xt.shape
    idx = torch.from_numpy(blocks.astype(np.int64)).to(xt.device)
    return xt.reshape(B, Hh, -1, plan.block, D).index_select(2, idx).reshape(B, Hh, -1, D).float()


def na_fwd_plain(qt, kt, vt, plan: NAPlan, window, stride) -> tuple[torch.Tensor, torch.Tensor]:
    """K10's function in plain PyTorch on the tiled layout: for each q block,
    masked attention over the kv blocks of its table row, fp32 logits and
    softmax, P rounded to v's dtype for P V, row sums clamped at 1e-20.
    Returns (out in q's dtype, lse (B, heads, S_pad) fp32)."""
    B, Hh, S_pad, D = qt.shape
    blk = plan.block
    scale = 1.0 / D**0.5
    out = torch.zeros_like(qt)
    lse = torch.full((B, Hh, S_pad), NEG_INF + float(np.log(L_MIN)), dtype=torch.float32, device=qt.device)
    for i in range(S_pad // blk):
        ids = plan.table[i, : plan.counts[i]]
        if ids.size == 0:
            continue
        rows = slice(i * blk, (i + 1) * blk)
        mask = _pair_mask(plan, i, ids, window, stride, qt.device)
        s = torch.matmul(qt[:, :, rows].float(), _gather(kt, plan, ids).transpose(-1, -2)) * scale
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = p.sum(-1, keepdim=True).clamp_min(L_MIN)
        o = torch.matmul(p.to(vt.dtype).float(), _gather(vt, plan, ids)) / l
        out[:, :, rows] = o.to(qt.dtype)
        lse[:, :, rows] = (m + torch.log(l))[..., 0]
    return out, lse


def _bwd_plain(qt, kt, vt, do_t, lse, delta, plan: NAPlan, window, stride, want_dq: bool, want_dkv: bool):
    """K11's and K12's functions in plain PyTorch: P from lse, dS = P (dP -
    delta) rounded to q's dtype, P rounded to v's dtype before P^T dO; dK and
    dV summed over q blocks in fp32 (index_add) and rounded at the end."""
    B, Hh, S_pad, D = qt.shape
    blk = plan.block
    nblk = S_pad // blk
    scale = 1.0 / D**0.5
    dq = torch.zeros_like(qt) if want_dq else None
    dk_acc = qt.new_zeros((B, Hh, nblk, blk, D), dtype=torch.float32) if want_dkv else None
    dv_acc = torch.zeros_like(dk_acc) if want_dkv else None
    for i in range(nblk):
        ids = plan.table[i, : plan.counts[i]]
        if ids.size == 0:
            continue
        rows = slice(i * blk, (i + 1) * blk)
        mask = _pair_mask(plan, i, ids, window, stride, qt.device)
        q_i, do_i = qt[:, :, rows].float(), do_t[:, :, rows].float()
        k_g, v_g = _gather(kt, plan, ids), _gather(vt, plan, ids)
        s = torch.matmul(q_i, k_g.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, rows, None]).masked_fill(~mask, 0.0)
        dp = torch.matmul(do_i, v_g.transpose(-1, -2))
        ds = (p * (dp - delta[:, :, rows, None])).to(qt.dtype).float()
        if want_dq:
            dq[:, :, rows] = (torch.matmul(ds, k_g) * scale).to(qt.dtype)
        if want_dkv:
            idx = torch.from_numpy(ids.astype(np.int64)).to(qt.device)
            dv_g = torch.matmul(p.to(vt.dtype).float().transpose(-1, -2), do_i)
            dk_g = torch.matmul(ds.transpose(-1, -2), q_i) * scale
            dv_acc.index_add_(2, idx, dv_g.reshape(B, Hh, -1, blk, D))
            dk_acc.index_add_(2, idx, dk_g.reshape(B, Hh, -1, blk, D))
    if not want_dkv:
        return dq, None, None
    return dq, dk_acc.reshape(kt.shape).to(kt.dtype), dv_acc.reshape(vt.shape).to(vt.dtype)


def na_delta(out_t: torch.Tensor, do_t: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, heads, S_pad, D) -> (B, heads, S_pad)."""
    return (do_t.float() * out_t.float()).sum(-1)


def na_bwd_plain(qt, kt, vt, out_t, lse, do_t, plan: NAPlan, window, stride):
    """(dq, dk, dv) on the tiled layout from the forward's out and lse."""
    return _bwd_plain(qt, kt, vt, do_t, lse, na_delta(out_t, do_t), plan, window, stride, True, True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, plan: NAPlan, window, stride, tensors: dict, rows: dict) -> None:
    q = tensors["q"]
    if q.dim() != 4 or q.shape[2] != plan.s_pad or q.shape[3] != HEAD_DIM:
        raise ValueError(f"{name}: q must be (B, heads, {plan.s_pad}, {HEAD_DIM}), got {tuple(q.shape)}")
    for tname, t in tensors.items():
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tname} {tuple(t.shape)} differs from q {tuple(q.shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {tname} must be bfloat16, got {t.dtype}")
    for tname, t in rows.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {tname} must be fp32 {tuple(q.shape[:3])}, got {t.dtype} {tuple(t.shape)}")
    for tname, t in {**tensors, **rows}.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")
    for L, w_, st_ in zip(plan.size, window, stride):
        if st_ < 1 or (0 <= w_ < L and st_ > w_):
            raise ValueError(f"{name}: stride {stride} must be in [1, window {window}]")
    if tuple(map(int, window)) != plan.window or tuple(map(int, stride)) != plan.stride:
        raise ValueError(f"{name}: window {window} and stride {stride} are not the plan's {plan.window}, {plan.stride}")


def _geometry(plan: NAPlan, window, stride) -> tuple[int, ...]:
    return (*plan.size, *(int(w) for w in window), *(int(s) for s in stride))


def na_fwd(qt, kt, vt, plan: NAPlan, window, stride) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of neighborhood attention on the tiled layout: qt, kt, vt
    (B, heads, S_pad, 128) from :func:`permute_in`; ``window`` and ``stride``
    the effective ones the plan was built for.

    CPU tensors take :func:`na_fwd_plain`. CUDA tensors launch K10 on the
    plan's walk (:func:`fwd_walk`), which takes contiguous bf16 tensors with
    head_dim 128 and the plan's window and stride, and raises on anything
    else."""
    if not qt.is_cuda:
        return na_fwd_plain(qt, kt, vt, plan, window, stride)
    _check("na_fwd", plan, window, stride, {"q": qt, "k": kt, "v": vt}, {})
    B, Hh, S_pad, D = qt.shape
    out = torch.empty_like(qt)
    lse = torch.empty((B, Hh, S_pad), dtype=torch.float32, device=qt.device)
    if B == 0 or Hh == 0:
        return out, lse
    tabs = plan_tensors(plan, qt.device)
    lib = _build.library()
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = lib.cosmos_na_fwd(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(), lse.data_ptr(),
            tabs["walk"].data_ptr(), tabs["walk_counts"].data_ptr(), tabs["coords"].data_ptr(),
            B, Hh, S_pad, plan.bt, plan.walk.shape[1], *_geometry(plan, window, stride), 1.0 / D**0.5, stream,
        )
    _build.check(err, "na_fwd")
    na_fwd.launches += 1
    return out, lse


na_fwd.launches = 0


def na_bwd_dq(qt, kt, vt, do_t, lse, delta, plan: NAPlan, window, stride) -> torch.Tensor:
    """dq (B, heads, S_pad, 128) from the output gradient ``do_t``, the
    forward's ``lse`` and ``delta`` = rowsum(dO * O), both (B, heads, S_pad)
    fp32. CPU tensors take the plain version; CUDA tensors launch K11 on
    K10's walk (:func:`fwd_walk`, each kv tile by 64-row halves) and raise
    on what it does not take."""
    if not qt.is_cuda:
        return _bwd_plain(qt, kt, vt, do_t, lse, delta, plan, window, stride, True, False)[0]
    _check("na_bwd_dq", plan, window, stride, {"q": qt, "k": kt, "v": vt, "do": do_t}, {"lse": lse, "delta": delta})
    B, Hh, S_pad, D = qt.shape
    dq = torch.empty_like(qt)
    if B == 0 or Hh == 0:
        return dq
    tabs = plan_tensors(plan, qt.device)
    lib = _build.library()
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = lib.cosmos_na_bwd_dq(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), do_t.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), tabs["walk"].data_ptr(), tabs["walk_counts"].data_ptr(), tabs["coords"].data_ptr(),
            B, Hh, S_pad, plan.bt, plan.walk.shape[1], *_geometry(plan, window, stride), 1.0 / D**0.5, stream,
        )
    _build.check(err, "na_bwd_dq")
    na_bwd_dq.launches += 1
    return dq


na_bwd_dq.launches = 0


def na_bwd_dkv(qt, kt, vt, do_t, lse, delta, plan: NAPlan, window, stride) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, heads, S_pad, 128), with the arguments of
    :func:`na_bwd_dq`; iterates the transposed table. CPU tensors take the
    plain version; CUDA tensors launch K12 on the plan's walk
    (:func:`dkv_walk`) and raise on what it does not take."""
    if not qt.is_cuda:
        return _bwd_plain(qt, kt, vt, do_t, lse, delta, plan, window, stride, False, True)[1:]
    _check("na_bwd_dkv", plan, window, stride, {"q": qt, "k": kt, "v": vt, "do": do_t}, {"lse": lse, "delta": delta})
    B, Hh, S_pad, D = qt.shape
    dk, dv = torch.empty_like(kt), torch.empty_like(vt)
    if B == 0 or Hh == 0:
        return dk, dv
    tabs = plan_tensors(plan, qt.device)
    lib = _build.library()
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = lib.cosmos_na_bwd_dkv(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), do_t.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), tabs["walkT"].data_ptr(), tabs["walkT_counts"].data_ptr(),
            tabs["coords"].data_ptr(), B, Hh, S_pad, plan.bt, plan.walkT.shape[1], *_geometry(plan, window, stride),
            1.0 / D**0.5, stream,
        )
    _build.check(err, "na_bwd_dkv")
    na_bwd_dkv.launches += 1
    return dk, dv


na_bwd_dkv.launches = 0


class NeighborhoodAttention(torch.autograd.Function):
    """Differentiable neighborhood attention on BSHD tensors: forward by
    :func:`na_fwd` (K10), backward by :func:`na_bwd_dq` (K11) and
    :func:`na_bwd_dkv` (K12) on the card, by the plain versions on the CPU.
    Saves the permuted q, k, v, out and lse, as the JAX ``_na_fwd_rule``.
    ``NeighborhoodAttention.apply(q, k, v, plan, window, stride)`` with the
    effective window and stride."""

    @staticmethod
    def forward(ctx, q, k, v, plan: NAPlan, window, stride):
        with torch.profiler.record_function(LAYOUT_RANGE):
            qt, kt, vt = (permute_in(t, plan) for t in (q, k, v))
        out_t, lse = saved_or_computed(lambda: na_fwd(qt, kt, vt, plan, window, stride), like=qt)
        ctx.save_for_backward(qt, kt, vt, out_t, lse)
        ctx.na = (plan, window, stride)
        with torch.profiler.record_function(LAYOUT_RANGE):
            return permute_out(out_t, plan)

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, out_t, lse = ctx.saved_tensors
        plan, window, stride = ctx.na
        with torch.profiler.record_function(LAYOUT_RANGE):
            do_t = permute_in(do, plan)  # pad rows of dO are zero
        delta = na_delta(out_t, do_t)  # in fp32 outside the kernels, as the JAX _na_bwd_rule does
        dq = na_bwd_dq(qt, kt, vt, do_t, lse, delta, plan, window, stride)
        dk, dv = na_bwd_dkv(qt, kt, vt, do_t, lse, delta, plan, window, stride)
        # pad slots carry no gradient: the inverse layout transform is the exact input gradient
        with torch.profiler.record_function(LAYOUT_RANGE):
            return permute_out(dq, plan), permute_out(dk, plan), permute_out(dv, plan), None, None, None


def neighborhood_attention(q, k, v, video_size, window, stride=(1, 1, 1), dilation=(1, 1, 1)) -> torch.Tensor:
    """3D neighborhood attention, differentiable. q, k, v: (B, S, heads, D)
    with S = T*H*W -> (B, S, heads, D). CUDA tensors run K10 (K11 and K12 in
    the backward): bf16, D = 128, anything else raises; CPU tensors take the
    plain versions. A dilation that ``effective_params`` refuses raises
    NotImplementedError on either device."""
    size = VideoSize(*video_size)
    assert q.shape[1] == size.T * size.H * size.W, (q.shape, size)
    for w_, st_ in zip(window, stride):
        assert st_ >= 1 and (w_ < 0 or st_ <= w_ or st_ <= 1), f"stride {stride} must be <= window {window}"
    eff_window, eff_stride = effective_params(size, tuple(window), tuple(stride), tuple(dilation))
    plan = build_plan(size, eff_window, eff_stride, tuple(dilation))
    return NeighborhoodAttention.apply(q, k, v, plan, eff_window, eff_stride)
