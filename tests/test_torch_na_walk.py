"""The walks K10, K11 and K12 follow on the card (ops/neighborhood_attention.py:
fwd_walk, dkv_walk), held on the CPU.

- Coverage, brute force: every (query, key) pair that the JAX package's
  dense mask ``_na_mask`` makes visible lies in a tile the walk lists, with
  the bit of the consumer warpgroup and kv half (K10) or warpgroup (K12)
  that computes it; every listed bit names a pair of real frames that see
  each other on the t axis (the JAX package's ``_axis_window_ok``).
- The kernels' order, in plain PyTorch: an online softmax per 64-row
  warpgroup over the walk's 128-column kv tiles, with the t-slice a bit
  leaves out masked whole (K10), dQ summed over the same walk by 64-row kv
  halves, a half whose bit is clear skipped (K11), and dK / dV summed over
  the walk's 64-row q t-slices (K12), all held against the port's plain
  versions (``na_fwd_plain``, ``na_bwd_plain``) and against JAX's
  ``neighborhood_attention`` and its VJP under
  ``pltpu.force_tpu_interpret_mode()``. Tolerances are
  tests/test_torch_neighborhood_attention.py's: fp32 on both sides, sums in
  another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops import neighborhood_attention as jna
from cosmos_predict2_tpu_torch.ops import neighborhood_attention as tna

FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
ROWS = tna.TILE_ROWS  # 128: a K10 q tile, a K12 kv tile
SLICE = tna.PER_T  # 64: one t-slice, one consumer warpgroup's rows

# (label, (T, H, W), effective window, effective stride, dilation):
# test_torch_neighborhood_attention.PLANS, then a t window with a t stride
# and an odd T, and an even t window over a T that bt = 2 pads
PLANS = [
    ("smoke 24x12x20, adapted", (24, 12, 20), (24, 3, 6), (1, 1, 2), (1, 1, 1)),
    ("720p 24x44x80", (24, 44, 80), (24, 12, 24), (1, 4, 8), (1, 1, 1)),
    ("720p comb02 layer 0, dilated", (24, 44, 80), (24, 4, 16), (1, 4, 16), (1, 11, 5)),
    ("padded H and W", (3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1)),
    ("T=5, non-pow2 block", (5, 4, 16), (-1, 2, 8), (1, 1, 1), (1, 1, 1)),
    ("single frame, both padded", (1, 7, 9), (-1, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("temporal window only", (4, 4, 16), (2, -1, -1), (1, 1, 1), (1, 1, 1)),
    ("one spatial tile", (3, 4, 4), (-1, 3, 3), (1, 1, 2), (1, 1, 1)),
    ("t window 3, t stride 2, T=7", (7, 4, 16), (3, -1, 5), (2, 1, 1), (1, 1, 1)),
    ("t window 4, T=9 padded to 10", (9, 5, 18), (4, 3, 7), (1, 1, 3), (1, 1, 1)),
]
MAX_TILES = 12  # tiles held per plan and walk; a plan with more is sampled evenly, ends included


def _plan(size, window, stride, dilation):
    return tna.build_plan(tna.VideoSize(*size), tuple(window), tuple(stride), tuple(dilation))


def _tokens(plan) -> np.ndarray:
    """Token index (token-major, before the dilation reorder) of each row of
    the tiled layout; -1 at pad slots."""
    S = int(np.prod(plan.size))
    idx = torch.arange(1, S + 1, dtype=torch.float64).reshape(1, S, 1, 1)
    return tna.permute_in(idx, plan)[0, 0, :, 0].numpy().astype(np.int64) - 1


def _visible(plan, window, stride, rows, cols) -> np.ndarray:
    """(len(rows), len(cols)) visibility of tiled rows by the JAX package's
    dense mask; pad slots are neither queries nor keys."""
    tok = _tokens(plan)
    r, c = tok[rows], tok[cols]
    mask = jna._na_mask(jnp.asarray(np.maximum(r, 0))[:, None], jnp.asarray(np.maximum(c, 0))[None, :],
                        jna.VideoSize(*plan.size), window, stride, plan.dilation)
    vis = (r >= 0)[:, None] & (c >= 0)[None, :]
    return vis if mask is None else vis & np.asarray(mask)


def _held_tiles(n: int) -> np.ndarray:
    return np.unique(np.linspace(0, n - 1, min(n, MAX_TILES)).round().astype(np.int64))


@pytest.mark.parametrize("label,size,window,stride,dilation", PLANS, ids=[p[0] for p in PLANS])
def test_fwd_walk_covers_every_visible_pair(label, size, window, stride, dilation):
    """For each held q tile: the bits (warpgroup, kv half) of every kv tile
    that holds a visible pair are set in the tile's walk entry."""
    plan = _plan(size, window, stride, dilation)
    n_tiles = plan.s_pad // ROWS
    assert plan.walk.shape[0] == n_tiles and plan.bt % 2 == 0
    for x in _held_tiles(n_tiles):
        vis = _visible(plan, window, stride, np.arange(x * ROWS, (x + 1) * ROWS), np.arange(plan.s_pad))
        seen = vis.reshape(2, SLICE, n_tiles, 2, SLICE).any(axis=(1, 4))  # (warpgroup, kv tile, half)
        need = (seen[0, :, 0] * 1 | seen[0, :, 1] * 2 | seen[1, :, 0] * 4 | seen[1, :, 1] * 8).astype(np.int64)
        listed = np.zeros(n_tiles, dtype=np.int64)
        entries = plan.walk[x, : plan.walk_counts[x]]
        listed[entries >> 4] = entries & 15
        assert len(np.unique(entries >> 4)) == len(entries), "a kv tile listed twice"
        missing = np.nonzero(need & ~listed)[0]
        assert missing.size == 0, f"q tile {x}: visible pairs in unlisted kv tiles / halves {missing[:8]}"


@pytest.mark.parametrize("label,size,window,stride,dilation", PLANS, ids=[p[0] for p in PLANS])
def test_dkv_walk_covers_every_visible_pair(label, size, window, stride, dilation):
    """For each held kv tile: the warpgroup bit of every 64-row q t-slice
    that sees one of the warpgroup's keys is set in the tile's walk entry."""
    plan = _plan(size, window, stride, dilation)
    n_tiles, n_slices = plan.s_pad // ROWS, plan.s_pad // SLICE
    assert plan.walkT.shape[0] == n_tiles
    for x in _held_tiles(n_tiles):
        vis = _visible(plan, window, stride, np.arange(plan.s_pad), np.arange(x * ROWS, (x + 1) * ROWS))
        seen = vis.reshape(n_slices, SLICE, 2, SLICE).any(axis=(1, 3))  # (q t-slice, warpgroup)
        need = (seen[:, 0] * 1 | seen[:, 1] * 2).astype(np.int64)
        listed = np.zeros(n_slices, dtype=np.int64)
        entries = plan.walkT[x, : plan.walkT_counts[x]]
        listed[entries >> 2] = entries & 3
        assert len(np.unique(entries >> 2)) == len(entries), "a q t-slice listed twice"
        missing = np.nonzero(need & ~listed)[0]
        assert missing.size == 0, f"kv tile {x}: visible pairs in unlisted q t-slices {missing[:8]}"


def _t_sees(plan, window, stride) -> np.ndarray:
    """(t_pad, t_pad): frame j holds a key of frame i's t-window, both real
    frames."""
    T, t = plan.size.T, np.arange(plan.t_pad)
    ok = jna._axis_window_ok(jnp.asarray(t)[:, None], jnp.asarray(t)[None, :], T, window[0], stride[0])
    vis = (t < T)[:, None] & (t < T)[None, :]
    return vis if ok is None else vis & np.asarray(ok)


@pytest.mark.parametrize("label,size,window,stride,dilation", PLANS, ids=[p[0] for p in PLANS])
def test_every_listed_bit_has_a_visible_frame_pair(label, size, window, stride, dilation):
    """Each bit of both walks is set exactly where its pair of frames see
    each other on the t axis, every entry has a bit and comes from the
    tile's table row: no tile is loaded for nothing at t granularity, and
    pad frames are never listed."""
    plan = _plan(size, window, stride, dilation)
    sees = _t_sees(plan, window, stride)
    half = plan.bt // 2
    t_of = lambda slices: plan.coords[slices // plan.bt, 0] + slices % plan.bt  # a 64-row t-slice's frame
    for x in range(plan.s_pad // ROWS):
        e = plan.walk[x, : plan.walk_counts[x]].astype(np.int64)
        kv_tile, bits = e >> 4, e & 15
        assert (bits != 0).all() and np.isin(kv_tile // half, plan.table[x // half, : plan.counts[x // half]]).all()
        for wg in range(2):
            for h in range(2):
                want = sees[t_of(np.int64(2 * x + wg)), t_of(2 * kv_tile + h)]
                np.testing.assert_array_equal(bits >> (2 * wg + h) & 1, want, err_msg=f"q tile {x}")
        e = plan.walkT[x, : plan.walkT_counts[x]].astype(np.int64)
        q_slice, bits = e >> 2, e & 3
        assert (bits != 0).all()
        assert np.isin(q_slice // plan.bt, plan.tableT[x // half, : plan.countsT[x // half]]).all()
        for wg in range(2):
            np.testing.assert_array_equal(bits >> wg & 1, sees[t_of(q_slice), t_of(np.int64(2 * x + wg))],
                                          err_msg=f"kv tile {x}")


def test_walk_computed_pairs_at_the_smoke_geometry():
    """At the sparse config's smoke geometry (bt 8, the t window the whole
    axis, T = t_pad) the 128-row walks (K11's by 64-row kv halves) compute
    the pairs the 64-row tiles did: 66,060,288 per (batch, head) against
    2,488,320 visible."""
    plan = _plan(*PLANS[0][1:])
    assert tna.walk_computed_pairs(plan) == {"na_fwd": 66_060_288, "na_bwd_dq": 66_060_288, "na_bwd_dkv": 66_060_288}
    assert tna.visible_pairs((24, 12, 20), (24, 3, 6)) == 2_488_320


# ---------------------------------------------------------------------------
# the kernels' order in plain PyTorch, against the plain versions and JAX
# ---------------------------------------------------------------------------


def fwd_by_walk(qt, kt, vt, plan, window, stride):
    """K10's function in its own order: per 128-row q tile and consumer
    warpgroup (64 rows), an online softmax over the kv tiles of the walk
    whose bits name the warpgroup, a t-slice whose bit is clear masked
    whole, the h/w mask of the dense reference, P rounded to v's dtype
    before P V, row sums clamped at 1e-20."""
    B, Hh, S_pad, D = qt.shape
    scale = 1.0 / D**0.5
    out = torch.zeros_like(qt)
    lse = torch.empty((B, Hh, S_pad), dtype=torch.float32)
    for x in range(S_pad // ROWS):
        for wg in range(2):
            rows = np.arange(x * ROWS + wg * SLICE, x * ROWS + (wg + 1) * SLICE)
            q = qt[:, :, rows].float()
            m = torch.full((B, Hh, SLICE, 1), tna.NEG_INF)
            l = torch.zeros((B, Hh, SLICE, 1))
            acc = torch.zeros((B, Hh, SLICE, D))
            for e in plan.walk[x, : plan.walk_counts[x]]:
                halves = int(e) >> (2 * wg) & 3
                if not halves:
                    continue
                cols = np.arange((int(e) >> 4) * ROWS, ((int(e) >> 4) + 1) * ROWS)
                mask = torch.from_numpy(_visible(plan, window, stride, rows, cols))
                mask &= torch.tensor([bool(halves & 1)] * SLICE + [bool(halves & 2)] * SLICE)[None, :]
                s = (q @ kt[:, :, cols].float().transpose(-1, -2) * scale).masked_fill(~mask, tna.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_new).masked_fill(~mask, 0.0)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(vt.dtype).float() @ vt[:, :, cols].float()
                m = m_new
            l = l.clamp_min(tna.L_MIN)
            out[:, :, rows] = (acc / l).to(qt.dtype)
            lse[:, :, rows] = (m + torch.log(l))[..., 0]
    return out, lse


def dkv_by_walk(qt, kt, vt, do_t, lse, delta, plan, window, stride):
    """K12's function in its own order: per 128-row kv tile and consumer
    warpgroup (64 keys), dK and dV summed over the walk's q t-slices whose
    bit names the warpgroup: P^T from lse (0 off the dense reference's
    window), dS^T = P^T (dP^T - delta) rounded to q's dtype, P^T to v's."""
    B, Hh, S_pad, D = qt.shape
    scale = 1.0 / D**0.5
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    for x in range(S_pad // ROWS):
        for wg in range(2):
            keys = np.arange(x * ROWS + wg * SLICE, x * ROWS + (wg + 1) * SLICE)
            k, v = kt[:, :, keys].float(), vt[:, :, keys].float()
            acc_k = torch.zeros((B, Hh, SLICE, D))
            acc_v = torch.zeros((B, Hh, SLICE, D))
            for e in plan.walkT[x, : plan.walkT_counts[x]]:
                if not int(e) >> wg & 1:
                    continue
                rows = np.arange((int(e) >> 2) * SLICE, ((int(e) >> 2) + 1) * SLICE)
                mask = torch.from_numpy(_visible(plan, window, stride, rows, keys)).transpose(0, 1)
                q, do = qt[:, :, rows].float(), do_t[:, :, rows].float()
                st = k @ q.transpose(-1, -2) * scale
                pt = torch.exp(st - lse[:, :, None, rows]).masked_fill(~mask, 0.0)
                dpt = v @ do.transpose(-1, -2)
                dst = (pt * (dpt - delta[:, :, None, rows])).to(qt.dtype).float()
                acc_v += pt.to(vt.dtype).float() @ do
                acc_k += dst @ q * scale
            dk[:, :, keys], dv[:, :, keys] = acc_k.to(kt.dtype), acc_v.to(vt.dtype)
    return dk, dv


def dq_by_walk(qt, kt, vt, do_t, lse, delta, plan, window, stride):
    """K11's function in its own order: per 128-row q tile and consumer
    warpgroup (64 rows), dQ summed over K10's walk taken by 64-row kv
    halves, a half whose bit does not name the warpgroup skipped: P from
    lse (0 off the dense reference's window), dS = P (dP - delta) rounded to
    q's dtype, dQ = scale dS K."""
    B, Hh, S_pad, D = qt.shape
    scale = 1.0 / D**0.5
    dq = torch.zeros_like(qt)
    for x in range(S_pad // ROWS):
        for wg in range(2):
            rows = np.arange(x * ROWS + wg * SLICE, x * ROWS + (wg + 1) * SLICE)
            q, do = qt[:, :, rows].float(), do_t[:, :, rows].float()
            acc = torch.zeros((B, Hh, SLICE, D))
            for e in plan.walk[x, : plan.walk_counts[x]]:
                for half in range(2):
                    if not int(e) >> (2 * wg + half) & 1:
                        continue
                    cols = np.arange((int(e) >> 4) * ROWS + half * SLICE, (int(e) >> 4) * ROWS + (half + 1) * SLICE)
                    mask = torch.from_numpy(_visible(plan, window, stride, rows, cols))
                    k, v = kt[:, :, cols].float(), vt[:, :, cols].float()
                    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse[:, :, rows, None]).masked_fill(~mask, 0.0)
                    ds = (p * (do @ v.transpose(-1, -2) - delta[:, :, rows, None])).to(qt.dtype).float()
                    acc += ds @ k * scale
            dq[:, :, rows] = acc.to(qt.dtype)
    return dq


# (label, (T, H, W), window, stride, dilation): the JAX kernel test's
# geometries, a t window with a t stride, and the padded single frame
WALK_CASES = [
    ("strided 4x8x16", (4, 8, 16), (-1, 4, 8), (1, 2, 4), (1, 1, 1)),
    ("padded 3x6x10", (3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1)),
    ("dilated 2x8x16", (2, 8, 16), (-1, 2, 4), (1, 1, 1), (1, 4, 4)),
    ("t window 3, t stride 2, 7x4x16", (7, 4, 16), (3, -1, 5), (2, 1, 1), (1, 1, 1)),
    ("single frame 1x7x9", (1, 7, 9), (-1, 3, 3), (1, 1, 1), (1, 1, 1)),
]


@pytest.fixture(scope="module", params=WALK_CASES, ids=[c[0] for c in WALK_CASES])
def walk_case(request):
    """Inputs on the tiled layout, the plan, and JAX's out and (dq, dk, dv)
    through the interpreted Pallas kernels, on token-major fp32 numpy data."""
    _, size, window, stride, dilation = request.param
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((1, int(np.prod(size)), 2, 128)).astype(np.float32) for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, b, c: jna.neighborhood_attention(a, b, c, jna.VideoSize(*size), window, stride=stride,
                                                       dilation=dilation),
            *map(jnp.asarray, (q, k, v)),
        )
        grads = vjp(jnp.asarray(do))
    ew, es = tna.effective_params(tna.VideoSize(*size), window, stride, dilation)
    plan = _plan(size, ew, es, dilation)
    tiled = [tna.permute_in(torch.from_numpy(x), plan) for x in (q, k, v, do)]
    return plan, ew, es, tiled, [np.asarray(x) for x in (out, *grads)]


def test_fwd_in_the_kernels_order_matches_plain_and_jax(walk_case):
    plan, ew, es, (qt, kt, vt, _), (want, *_) = walk_case
    out, lse = fwd_by_walk(qt, kt, vt, plan, ew, es)
    ref, ref_lse = tna.na_fwd_plain(qt, kt, vt, plan, ew, es)
    torch.testing.assert_close(out, ref, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=FWD_TOL, rtol=0)  # pad rows too: -1e30 on both
    np.testing.assert_allclose(tna.permute_out(out, plan).numpy(), want, atol=FWD_TOL, rtol=0)


def test_dkv_in_the_kernels_order_matches_plain_and_jax(walk_case):
    plan, ew, es, (qt, kt, vt, do_t), (_, _, want_dk, want_dv) = walk_case
    out, lse = tna.na_fwd_plain(qt, kt, vt, plan, ew, es)
    dk, dv = dkv_by_walk(qt, kt, vt, do_t, lse, tna.na_delta(out, do_t), plan, ew, es)
    _, ref_dk, ref_dv = tna.na_bwd_plain(qt, kt, vt, out, lse, do_t, plan, ew, es)
    for name, got, ref, want in (("k", dk, ref_dk, want_dk), ("v", dv, ref_dv, want_dv)):
        torch.testing.assert_close(got, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=name)
        np.testing.assert_allclose(tna.permute_out(got, plan).numpy(), want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_dq_in_the_kernels_order_matches_plain_and_jax(walk_case):
    plan, ew, es, (qt, kt, vt, do_t), (_, want_dq, _, _) = walk_case
    out, lse = tna.na_fwd_plain(qt, kt, vt, plan, ew, es)
    dq = dq_by_walk(qt, kt, vt, do_t, lse, tna.na_delta(out, do_t), plan, ew, es)
    ref_dq = tna.na_bwd_plain(qt, kt, vt, out, lse, do_t, plan, ew, es)[0]
    torch.testing.assert_close(dq, ref_dq, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(tna.permute_out(dq, plan).numpy(), want_dq, atol=GRAD_ATOL, rtol=GRAD_RTOL)
