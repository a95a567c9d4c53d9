"""The walk the row-windowed cache decode (K6) follows on the card
(ops/flash_attention.py: kv_window_walk, window_walk_pairs,
kv_window_split_plan), held on the CPU.

- Coverage, brute force: over the walk's tiles, the warpgroups that compute
  them and the kernel's mask (each row's window against the key's position
  from the start of the frame being walked), every (query, key) pair that
  the window makes visible is unmasked exactly once and no other pair is,
  at the JAX kernel test's windows, the reference-only windows of
  tests/test_torch_kv_cache.py and chip_smoke.py's five K6 cases.
- The pairs each tile choice loads, against the visible ones, at the cases
  the tile sizes were chosen on, and the pairs K6's warpgroups compute.
- The split plan: its choice at chip_smoke.py's cases, and runs of whole
  frames that cover the fill once.
- The kernel's order, in plain PyTorch: per 128-row q tile and 64-row
  consumer warpgroup, per run of frames, an online softmax over the walk's
  tiles with the kernel's mask and P rounded to v's dtype, each run's
  normalised output and lse combined in split order as K5's second pass
  does. fp32 against JAX's ``_kv_cache_window_reference`` and, at the JAX
  kernel test's windows, ``_flash_kv_cache_window_impl`` under
  ``pltpu.force_tpu_interpret_mode()``: 2e-5 absolute, as
  tests/test_torch_kv_cache.py (the same fp32 softmax in another order).
  bf16 against the port's ``kv_cache_window_plain``: relative L2 within
  1e-2, the card's gate for K6 against that plain version. Both round P to
  bf16, but at other points (here unnormalised, against the running max;
  there normalised), so each P carries its own bf16 rounding (~3e-3
  measured at these shapes, as K6 against the plain version on the card).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops import flash_attention as jfa
from cosmos_predict2_tpu_torch.ops import flash_attention as tfa
from test_torch_kv_cache import PALLAS_WINDOWS, REFERENCE_WINDOWS

ATOL = 2e-5
BF16_REL_L2 = 1e-2
Q, KV, WG = tfa.WINDOW_BLOCK_Q, tfa.WINDOW_BLOCK_KV, tfa.WINDOW_WG_ROWS

# chip_smoke.py's K6 cases: (label, gh, gw, frames per block, filled frames, window rows)
SMOKE_CASES = [
    ("352x640 steady", 22, 40, 1, 17, 7),
    ("352x640 early", 22, 40, 1, 4, 7),
    ("352x640 nb2", 22, 40, 2, 18, 7),
    ("720p", 44, 80, 1, 9, 14),
    ("prime gh 23x40", 23, 40, 1, 17, 7),
]
# (gh, gw, window rows, frames per block, filled frames) for the coverage check
COVERAGE = ([(gh, gw, wh, nb, 3) for gh, gw, wh, nb in PALLAS_WINDOWS + REFERENCE_WINDOWS]
            + [(gh, gw, wh, nb, 2) for _, gh, gw, nb, _, wh in SMOKE_CASES])


def _visible(sq, kv_valid, grid_hw, wh) -> np.ndarray:
    """(sq, kv_valid) bool: the window's dense mask, from the port's
    ``window_rows_bounds`` (held against JAX by tests/test_torch_kv_cache.py)."""
    gh, gw = grid_hw
    lo, hi = tfa.window_rows_bounds(torch.arange(sq), grid_hw, wh)
    yk = (np.arange(kv_valid) % (gh * gw)) // gw
    return (yk[None, :] >= lo.numpy()[:, None]) & (yk[None, :] < hi.numpy()[:, None])


def _row_windows(rows, sq, grid_hw, wh):
    """Each row's window [lo, hi) in tokens from a frame's start, as K6's
    consumers compute it (empty past sq)."""
    los, his = zip(*(tfa.window_union(int(r), 1, sq, grid_hw, wh) for r in rows))
    return np.array(los), np.array(his)


@pytest.mark.parametrize("gh,gw,wh,nb,filled", COVERAGE)
def test_walk_unmasks_every_visible_pair_once(gh, gw, wh, nb, filled):
    F = gh * gw
    sq, kv_valid = nb * F, filled * F
    seen = np.zeros((sq, kv_valid + KV), np.int32)  # keys past the fill: read as zeros, must stay masked
    for x, tiles in enumerate(tfa.kv_window_walk(sq, kv_valid, (gh, gw), wh)):
        for w in range(Q // WG):
            rows = np.arange(x * Q + w * WG, x * Q + (w + 1) * WG)
            lo, hi = _row_windows(rows, sq, (gh, gw), wh)
            for t in tiles:
                if not t.wg_bits >> w & 1:
                    continue
                local = t.local + np.arange(KV)
                unmasked = (local[None, :] >= lo[:, None]) & (local[None, :] < hi[:, None])
                keep = rows < sq
                seen[rows[keep], t.row:t.row + KV] += unmasked[keep]
    np.testing.assert_array_equal(seen[:, :kv_valid], _visible(sq, kv_valid, (gh, gw), wh).astype(np.int32))
    assert not seen[:, kv_valid:].any()


@pytest.mark.parametrize("gh,gw,wh,nb,filled", COVERAGE[:4])
def test_a_warpgroup_skips_only_tiles_none_of_its_rows_sees(gh, gw, wh, nb, filled):
    """A tile a warpgroup's bit leaves out holds no key any of its rows sees
    in that frame; the CTA loads every tile some warpgroup computes."""
    F = gh * gw
    sq = nb * F
    for x, tiles in enumerate(tfa.kv_window_walk(sq, filled * F, (gh, gw), wh)):
        for w in range(Q // WG):
            lo, hi = _row_windows(range(x * Q + w * WG, x * Q + (w + 1) * WG), sq, (gh, gw), wh)
            for t in tiles:
                sees = ((t.local + np.arange(KV))[None, :] >= lo[:, None]) & (
                    (t.local + np.arange(KV))[None, :] < hi[:, None])
                assert bool(t.wg_bits >> w & 1) == bool(sees.any())


# the pairs per (batch, head) that each tile choice loads, over the visible
# ones, to two decimals: (64 q / 64 kv, 128 / 64, 128 / 128)
LOADED_RATIOS = {
    "352x640 steady": (1.21, 1.46, 1.66),
    "352x640 nb2": (1.30, 1.61, 1.80),
    "720p": (1.05, 1.10, 1.13),
    "prime gh 23x40": (1.26, 1.59, 1.84),
}


@pytest.mark.parametrize("label,gh,gw,nb,filled,wh", [c for c in SMOKE_CASES if c[0] in LOADED_RATIOS])
def test_loaded_and_computed_pairs(label, gh, gw, nb, filled, wh):
    F = gh * gw
    ratios = []
    for bq, bk in ((64, 64), (128, 64), (128, 128)):
        pairs = tfa.window_walk_pairs(nb * F, filled * F, (gh, gw), wh, bq, bk)
        assert pairs["visible"] == nb * F * min(wh, gh) * gw * filled
        assert pairs["visible"] <= pairs["computed"] <= pairs["loaded"]
        ratios.append(round(pairs["loaded"] / pairs["visible"], 2))
    assert tuple(ratios) == LOADED_RATIOS[label]


def test_computed_pairs_at_the_steady_state():
    """K6's tiles at the interactive steady state: 1.66x the visible pairs
    loaded, 1.53x computed (a warpgroup skips the tiles its rows miss)."""
    assert tfa.window_walk_pairs(880, 17 * 880, (22, 40), 7) == {
        "visible": 4_188_800, "loaded": 6_963_200, "computed": 6_406_144}


@pytest.mark.parametrize("label,gh,gw,nb,filled,wh,want", [
    (*SMOKE_CASES[0], 1), (*SMOKE_CASES[1], 1), (*SMOKE_CASES[2], 4), (*SMOKE_CASES[3], 2), (*SMOKE_CASES[4], 1),
])
def test_split_plan_at_the_smoke_cases(label, gh, gw, nb, filled, wh, want):
    """The plan's choice at chip_smoke.py's cases on 132 SMs, B1 H16: the
    split count the card's 1-4 sweep found fastest (scripts/kv_window_variants.py)."""
    F = gh * gw
    assert tfa.kv_window_split_plan(nb * F, filled * F, (gh, gw), wh, 16, 1, 132) == want


@pytest.mark.parametrize("filled,splits", [(f, s) for f in (1, 4, 17) for s in range(1, 5) if s <= f])
def test_split_runs_cover_the_frames_once(filled, splits):
    """Run s of the kernel's split covers frames [s F // splits, (s + 1) F
    // splits): whole frames, in order, each once, no run empty while
    splits <= F (the plan takes at most one split per filled frame)."""
    runs = [(s * filled // splits, (s + 1) * filled // splits) for s in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == filled
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert all(e > b for b, e in runs)


# ---------------------------------------------------------------------------
# the kernel's order in plain PyTorch
# ---------------------------------------------------------------------------


def window_by_walk(q, kb, vb, kv_valid, grid_hw, wh, splits=1):
    """K6's function in its own order (see the module docstring); q (B, Sq,
    H, D), head-major buffers; rows past kv_valid read as zeros, as TMA
    gives them."""
    gh, gw = grid_hw
    F = gh * gw
    B, sq, H, D = q.shape
    frames = kv_valid // F
    scale = 1.0 / D**0.5
    kz, vz = (torch.cat([b[:, :, :kv_valid], b.new_zeros((B, H, KV, D))], dim=2) for b in (kb, vb))
    out = torch.zeros_like(q)
    walk = tfa.kv_window_walk(sq, kv_valid, grid_hw, wh)
    per_frame = [len(tiles) // frames for tiles in walk]
    for x, tiles in enumerate(walk):
        for w in range(Q // WG):
            rows = np.arange(x * Q + w * WG, x * Q + (w + 1) * WG)
            rows = rows[rows < sq]
            if not len(rows):
                continue
            lo, hi = (torch.from_numpy(a) for a in _row_windows(rows, sq, grid_hw, wh))
            qr = q[:, rows].permute(0, 2, 1, 3).float()  # (B, H, rows, D)
            parts = []
            for s in range(splits):
                m = torch.full((B, H, len(rows), 1), tfa.NEG_INF)
                l = torch.zeros((B, H, len(rows), 1))
                acc = torch.zeros((B, H, len(rows), D))
                run = tiles[s * frames // splits * per_frame[x]:(s + 1) * frames // splits * per_frame[x]]
                for t in run:
                    if not t.wg_bits >> w & 1:
                        continue
                    local = t.local + torch.arange(KV)
                    mask = (local[None, :] >= lo[:, None]) & (local[None, :] < hi[:, None])
                    k, v = kz[:, :, t.row:t.row + KV].float(), vz[:, :, t.row:t.row + KV]
                    s_ = (qr @ k.transpose(-1, -2) * scale).masked_fill(~mask, tfa.NEG_INF)
                    m_new = torch.maximum(m, s_.amax(-1, keepdim=True))
                    p = torch.exp(s_ - m_new).masked_fill(~mask, 0.0)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1, keepdim=True)
                    acc = acc * corr + p.to(vb.dtype).float() @ v.float()
                    m = m_new
                parts.append((acc / l, m + torch.log(l)))
            if splits == 1:
                o = parts[0][0]
            else:  # K5's second pass: the lse-weighted sum in split order, shifted by the max
                mx = torch.stack([lse for _, lse in parts]).amax(0)
                o, wsum = torch.zeros_like(parts[0][0]), torch.zeros_like(mx)
                for o_s, lse_s in parts:
                    weight = torch.exp(lse_s - mx)
                    o, wsum = o + weight * o_s, wsum + weight
                o = o / wsum
            out[:, rows] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _inputs(key, sq, s_max, fill, heads=2, d=128):
    """As tests/test_torch_kv_cache.py: q and head-major buffers with
    +-1e3 past the fill frontier, which must not reach the output."""
    rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
    q = rng.standard_normal((1, sq, heads, d)).astype(np.float32)
    kb = rng.standard_normal((1, heads, s_max, d)).astype(np.float32)
    vb = rng.standard_normal((1, heads, s_max, d)).astype(np.float32)
    kb[:, :, fill:] = 1e3
    vb[:, :, fill:] = -1e3
    return q, kb, vb


@pytest.mark.parametrize("gh,gw,wh,nb", PALLAS_WINDOWS)
@pytest.mark.parametrize("splits", [1, 3])
def test_kernel_order_matches_pallas_interpret(gh, gw, wh, nb, splits):
    F = gh * gw
    fill = 2 * F + nb * F
    q, kb, vb = _inputs(("k6 walk", gh, gw, wh, nb), nb * F, 4 * F, fill)
    with pltpu.force_tpu_interpret_mode():
        want = jfa._flash_kv_cache_window_impl(*map(jnp.asarray, (q, kb, vb)), jnp.int32(fill), (gh, gw), wh, 2)
    got = window_by_walk(*map(torch.from_numpy, (q, kb, vb)), fill, (gh, gw), wh, splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("gh,gw,wh,nb", REFERENCE_WINDOWS)
@pytest.mark.parametrize("splits", [1, 2])
def test_kernel_order_matches_jax_reference(gh, gw, wh, nb, splits):
    F = gh * gw
    fill = 3 * F
    q, kb, vb = _inputs(("k6 walk ref", gh, gw, wh, nb), nb * F, 4 * F, fill)
    want = jfa._kv_cache_window_reference(*map(jnp.asarray, (q, kb, vb)), jnp.int32(fill), (gh, gw), wh)
    got = window_by_walk(*map(torch.from_numpy, (q, kb, vb)), fill, (gh, gw), wh, splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("gh,gw,wh,nb,filled,splits", [(22, 40, 7, 1, 3, 1), (22, 40, 7, 2, 3, 3), (23, 40, 7, 1, 2, 2)])
def test_kernel_order_in_bf16_matches_plain(gh, gw, wh, nb, filled, splits):
    """At the 352x640 and prime grids, in bf16 with P rounded to bf16 on
    both sides; the two-frame block has q tiles that cross a frame."""
    F = gh * gw
    q, kb, vb = (torch.from_numpy(a).bfloat16() for a in _inputs(("k6 bf16", gh, nb), nb * F, (filled + 1) * F,
                                                                  filled * F))
    got = window_by_walk(q, kb, vb, filled * F, (gh, gw), wh, splits)
    want = tfa.kv_cache_window_plain(q, kb, vb, filled * F, (gh, gw), wh)
    assert float((got.float() - want.float()).norm() / want.float().norm()) < BF16_REL_L2
