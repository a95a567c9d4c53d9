"""The port's KV-cache decode (K5, K6: plain versions and CPU wrappers) held
against the JAX package's Pallas kernels in interpret mode and its masked
references (CPU, fp32, seeded numpy inputs).

Tolerance: 2e-5 absolute on O(1) outputs, as the JAX package's own tests of
these kernels use: the same fp32 softmax with another summation order. The
CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops import flash_attention as jfa
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops.flash_attention import (
    flash_attention_kv_cache,
    flash_attention_kv_cache_window,
    kv_cache_plain,
    kv_cache_window_plain,
)

ATOL = 2e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _inputs(key, sq, s_max, fill, heads=2, d=128):
    """q (1, sq, H, d) and head-major buffers (1, H, s_max, d) with +-1e3
    garbage past the fill frontier, which must not reach the output."""
    rng = _rng(*key)
    q = rng.standard_normal((1, sq, heads, d)).astype(np.float32)
    kb = rng.standard_normal((1, heads, s_max, d)).astype(np.float32)
    vb = rng.standard_normal((1, heads, s_max, d)).astype(np.float32)
    kb[:, :, fill:] = 1e3
    vb[:, :, fill:] = -1e3
    return q, kb, vb


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32), rtol=0, atol=atol)


def test_kv_cache_plain_matches_pallas_interpret():
    """K5's plain version == the JAX flash decode in interpret mode, at a
    fill level in the middle of a kv tile (as tests/test_ops.py runs it)."""
    q, kb, vb = _inputs(("k5",), 64, 512, 300)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_kv_cache(*map(jnp.asarray, (q, kb, vb)), jnp.int32(300))
    got = kv_cache_plain(*map(torch.from_numpy, (q, kb, vb)), 300)
    _close(got, want)


@pytest.mark.parametrize("sq,fill", [(48, 48), (100, 512), (7, 301)])
def test_kv_cache_plain_matches_jax_reference(sq, fill):
    """Against ``_kv_cache_reference`` at an empty-but-the-block cache, a full
    buffer and a ragged block."""
    q, kb, vb = _inputs(("k5 ref", sq, fill), sq, 512, fill)
    want = jfa._kv_cache_reference(*map(jnp.asarray, (q, kb, vb)), jnp.int32(fill))
    _close(kv_cache_plain(*map(torch.from_numpy, (q, kb, vb)), fill), want)


# (gh, gw, window rows, frames per block): the JAX kernel test's geometries
# (even gh banded, odd gh, a 2-frame block)
PALLAS_WINDOWS = [(6, 8, 3, 1), (5, 8, 2, 1), (6, 8, 3, 2)]


@pytest.mark.parametrize("gh,gw,wh,nb", PALLAS_WINDOWS)
def test_kv_cache_window_plain_matches_pallas_interpret(gh, gw, wh, nb):
    F = gh * gw
    fill = 2 * F + nb * F  # 2 cached frames + the appended block
    q, kb, vb = _inputs(("k6", gh, gw, wh, nb), nb * F, 4 * F, fill)
    with pltpu.force_tpu_interpret_mode():
        want = jfa._flash_kv_cache_window_impl(*map(jnp.asarray, (q, kb, vb)), jnp.int32(fill), (gh, gw), wh, 2)
    got = kv_cache_window_plain(*map(torch.from_numpy, (q, kb, vb)), fill, (gh, gw), wh)
    _close(got, want)


# geometries the TPU kernel does not take: a width that is no multiple of 8,
# a prime number of rows (its banding went dense there), a window wider
# than the grid, a 2-frame block on a prime grid
REFERENCE_WINDOWS = [(5, 6, 3, 1), (7, 8, 3, 1), (11, 4, 5, 1), (4, 4, 9, 1), (7, 5, 2, 2)]


@pytest.mark.parametrize("gh,gw,wh,nb", REFERENCE_WINDOWS)
def test_kv_cache_window_plain_matches_jax_reference(gh, gw, wh, nb):
    F = gh * gw
    fill = 3 * F
    q, kb, vb = _inputs(("k6 ref", gh, gw, wh, nb), nb * F, 4 * F, fill)
    want = jfa._kv_cache_window_reference(*map(jnp.asarray, (q, kb, vb)), jnp.int32(fill), (gh, gw), wh)
    got = kv_cache_window_plain(*map(torch.from_numpy, (q, kb, vb)), fill, (gh, gw), wh)
    _close(got, want)


def test_full_window_is_the_dense_cache_decode():
    gh, gw = 5, 6
    q, kb, vb = _inputs(("k6 full",), gh * gw, 3 * gh * gw, 2 * gh * gw)
    args = [torch.from_numpy(a) for a in (q, kb, vb)]
    torch.testing.assert_close(kv_cache_window_plain(*args, 2 * gh * gw, (gh, gw), gh),
                               kv_cache_plain(*args, 2 * gh * gw), rtol=0, atol=1e-6)


def test_cpu_wrappers_take_the_plain_versions():
    gh, gw = 6, 8
    q, kb, vb = (torch.from_numpy(a) for a in _inputs(("wrappers",), gh * gw, 3 * gh * gw, 2 * gh * gw))
    before = _build.launch_counts()
    assert torch.equal(flash_attention_kv_cache(q, kb, vb, 100), kv_cache_plain(q, kb, vb, 100))
    assert torch.equal(flash_attention_kv_cache_window(q, kb, vb, 2 * gh * gw, (gh, gw), 3),
                       kv_cache_window_plain(q, kb, vb, 2 * gh * gw, (gh, gw), 3))
    assert _build.launch_counts() == before


@pytest.mark.parametrize("fn", [flash_attention_kv_cache_window, kv_cache_window_plain])
def test_window_needs_whole_frames_on_cpu(fn):
    """A fill, block or buffer that is not a whole number of frames raises
    (the TPU kernel returned NaN for such a fill, flash_attention.py:391)."""
    gh, gw = 6, 8
    F = gh * gw
    q, kb, vb = (torch.from_numpy(a) for a in _inputs(("granular",), F, 3 * F, 2 * F))
    with pytest.raises(ValueError, match="kv_valid"):
        fn(q, kb, vb, 2 * F - 5, (gh, gw), 3)
    with pytest.raises(ValueError, match="Sq"):
        fn(q[:, :-1], kb, vb, 2 * F, (gh, gw), 3)
    with pytest.raises(ValueError, match="S_max"):
        fn(q, kb[:, :, :-8].contiguous(), vb[:, :, :-8].contiguous(), 2 * F, (gh, gw), 3)


@pytest.mark.parametrize("fill", [0, 513])
def test_fill_outside_the_buffer_raises(fill):
    q, kb, vb = (torch.from_numpy(a) for a in _inputs(("fill",), 8, 512, 512))
    with pytest.raises(ValueError, match="kv_valid"):
        flash_attention_kv_cache(q, kb, vb, fill)
    with pytest.raises(ValueError, match="head-major"):
        flash_attention_kv_cache(q, kb.transpose(1, 2), vb.transpose(1, 2), 100)
