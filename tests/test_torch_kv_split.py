"""K5's split-KV route (flash-decoding) on the CPU: the plan that cuts the
fill into runs of kv tiles, and a plain version of the route (per-run
partial output and lse, combined as the kernel's second pass combines them)
held against the port's plain version, the JAX package's reference and its
Pallas kernel in interpret mode (fp32, seeded numpy inputs, +-1e3 past the
fill).

Tolerance: 1e-6 absolute against the port's plain version (fp32 round-off
of the combine on O(1) outputs) and 2e-5 against JAX, as
tests/test_torch_kv_cache.py. The kernel's route on the card:
tests/test_torch_cuda.py.
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops import flash_attention as jfa
from cosmos_predict2_tpu_torch.ops.flash_attention import (
    KV_BLOCK_KV,
    KV_MAX_SPLITS,
    KvCachePlan,
    kv_cache_plain,
    kv_cache_split_plain,
    kv_cache_split_plan,
)

ATOL_JAX = 2e-5
ATOL_PLAIN = 1e-6
SMS = 132


def _inputs(key, sq, s_max, fill, heads=2, d=128):
    rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
    q = rng.standard_normal((1, sq, heads, d)).astype(np.float32)
    kb = rng.standard_normal((1, heads, s_max, d)).astype(np.float32)
    vb = rng.standard_normal((1, heads, s_max, d)).astype(np.float32)
    kb[:, :, fill:] = 1e3
    vb[:, :, fill:] = -1e3
    return q, kb, vb


def _check_runs(plan: KvCachePlan):
    """Every kv tile of [0, kv_valid) in exactly one run, in order, none empty."""
    runs = plan.tile_runs()
    assert len(runs) == plan.splits >= 1
    assert runs[0][0] == 0 and runs[-1][1] == plan.kv_tiles == -(-plan.kv_valid // KV_BLOCK_KV)
    assert all(b < e for b, e in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    rows = plan.kv_ranges()
    assert rows[0][0] == 0 and rows[-1][1] == plan.kv_valid
    assert all(b < e for b, e in rows) and all(rows[i][1] == rows[i + 1][0] for i in range(len(rows) - 1))


# (Sq, heads, batch): the interactive path's one- and two-frame blocks at
# 352x640 and a block of one 720p frame, and short blocks over the cache
# that leave the card mostly idle (the plan splits them)
SHAPES = [(880, 16, 1), (1760, 16, 1), (3520, 16, 1), (100, 4, 2), (48, 3, 1)]
# the interactive fills (4 and 17 frames of 880 tokens, 9 of 3,520), a
# ragged fill and a fill of one tile
FILLS = [880 * 4, 880 * 17, 31680, 301, 128]


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("sq,heads,batch", SHAPES)
def test_split_plan_covers_every_kv_tile_once(sq, heads, batch, fill):
    plan = kv_cache_split_plan(sq, fill, heads, batch, SMS)
    assert plan.kv_valid == fill and 1 <= plan.splits <= min(KV_MAX_SPLITS, plan.kv_tiles)
    _check_runs(plan)


@pytest.mark.parametrize("fill", FILLS)
def test_any_split_count_up_to_the_tiles_covers_the_fill(fill):
    tiles = -(-fill // KV_BLOCK_KV)
    for splits in range(1, min(tiles, 24) + 1):
        _check_runs(KvCachePlan(fill, splits))


def test_short_block_over_a_long_cache_splits():
    """One q tile per head over 17 frames: 8 CTAs on 132 SMs without a split."""
    assert kv_cache_split_plan(100, 880 * 17, 4, 2, SMS).splits > 1


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_route_matches_kv_cache_plain(splits):
    q, kb, vb = (torch.from_numpy(a) for a in _inputs(("split plain",), 100, 768, 601))
    got = kv_cache_split_plain(q, kb, vb, 601, KvCachePlan(601, splits))
    torch.testing.assert_close(got, kv_cache_plain(q, kb, vb, 601), rtol=0, atol=ATOL_PLAIN)


SQ, S_MAX, FILL = 64, 640, 600  # five kv tiles, the last one ragged


@functools.lru_cache(maxsize=None)
def _jax_outputs():
    """The JAX reference and the Pallas flash decode in interpret mode, once."""
    q, kb, vb = _inputs(("split jax",), SQ, S_MAX, FILL)
    args = tuple(map(jnp.asarray, (q, kb, vb)))
    ref = np.asarray(jfa._kv_cache_reference(*args, jnp.int32(FILL)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfa.flash_attention_kv_cache(*args, jnp.int32(FILL)))
    return (q, kb, vb), ref, pallas


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_route_matches_jax_reference_and_pallas_interpret(splits):
    (q, kb, vb), ref, pallas = _jax_outputs()
    got = kv_cache_split_plain(*map(torch.from_numpy, (q, kb, vb)), FILL, KvCachePlan(FILL, splits)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_JAX)
