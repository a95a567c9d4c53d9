"""The port's neighborhood attention held against the JAX package's.

The host side (plan, block tables and their transpose, coordinates, the
layout permutation, the adapted window parameters) must equal the JAX
package's exactly. The attention and its three gradients go through JAX's
``neighborhood_attention`` under ``pltpu.force_tpu_interpret_mode()``, so
its Pallas ``_na_fwd_kernel``, ``_na_dq_kernel`` and ``_na_dkv_kernel`` run
as the JAX package's own tests run them, and through the port's
``neighborhood_attention`` on CPU tensors (the plain versions behind the
K10, K11 and K12 wrappers), on the same numpy inputs in fp32. Tolerances are
the JAX package's own for its kernel: 2e-5 absolute on the output, 5e-4
absolute / 1e-3 relative on the gradients (measured <= 6e-7: fp32 on both
sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import keep_default_threads  # noqa: F401  (an autouse fixture: tolerances at fp32 noise)
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops import neighborhood_attention as jna
from cosmos_predict2_tpu_torch.ops import neighborhood_attention as tna

FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3

# (label, (T, H, W), effective window, effective stride, dilation)
PLANS = [
    ("smoke 24x12x20, adapted", (24, 12, 20), (24, 3, 6), (1, 1, 2), (1, 1, 1)),
    ("720p 24x44x80", (24, 44, 80), (24, 12, 24), (1, 4, 8), (1, 1, 1)),
    ("720p comb02 layer 0, dilated", (24, 44, 80), (24, 4, 16), (1, 4, 16), (1, 11, 5)),
    ("padded H and W", (3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1)),
    ("T=5, non-pow2 block", (5, 4, 16), (-1, 2, 8), (1, 1, 1), (1, 1, 1)),
    ("single frame, both padded", (1, 7, 9), (-1, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("temporal window only", (4, 4, 16), (2, -1, -1), (1, 1, 1), (1, 1, 1)),
    ("one spatial tile", (3, 4, 4), (-1, 3, 3), (1, 1, 2), (1, 1, 1)),  # the permutation alone is a view here
]


@pytest.mark.parametrize("label,size,window,stride,dilation", PLANS, ids=[p[0] for p in PLANS])
def test_plan_equals_jax(label, size, window, stride, dilation):
    want = jna._build_plan(jna.VideoSize(*size), window, stride, dilation, 512)
    got = tna.build_plan(tna.VideoSize(*size), window, stride, dilation)
    for name in ("t_pad", "nth", "ntw", "block", "s_pad"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("coords", "table", "counts", "tableT", "countsT"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got is tna.build_plan(tna.VideoSize(*size), window, stride, dilation)  # cached by geometry


def test_plan_tables_upload_once_per_device():
    plan = tna.build_plan(tna.VideoSize(3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1))
    first = tna.plan_tensors(plan, torch.device("cpu"))
    again = tna.plan_tensors(plan, torch.device("cpu"))
    assert all(first[k] is again[k] for k in first)
    np.testing.assert_array_equal(first["walkT"].numpy(), plan.walkT)


@pytest.mark.parametrize("label,size,window,stride,dilation", [PLANS[i] for i in (0, 2, 3, 5, 7)],
                         ids=[PLANS[i][0] for i in (0, 2, 3, 5, 7)])
def test_permutation_equals_jax_and_round_trips(label, size, window, stride, dilation):
    plan = tna.build_plan(tna.VideoSize(*size), window, stride, dilation)
    jplan = jna._build_plan(jna.VideoSize(*size), window, stride, dilation, 512)
    x = np.random.default_rng(0).standard_normal((1, int(np.prod(size)), 2, 4)).astype(np.float32)
    xt = tna.permute_in(torch.from_numpy(x), plan)
    assert xt.shape == (1, 2, plan.s_pad, 4) and xt.is_contiguous()
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jna._permute_in(jnp.asarray(x), jplan)))
    np.testing.assert_array_equal(tna.permute_out(xt, plan).numpy(), x)


@pytest.mark.parametrize("window,stride,shape,base,dilation", [
    ((-1, 12, 24), (1, 4, 8), (24, 12, 20), (-1, 44, 80), (1, 1, 1)),  # the smoke geometry
    ((-1, 12, 24), (1, 4, 8), (24, 44, 80), (-1, 44, 80), (1, 1, 1)),  # 720p: unchanged
    ((-1, 12, 24), (1, 4, 8), (24, 22, 40), (-1, 44, 80), (1, 1, 1)),
    ((-1, 12, 24), (1, 4, 8), (16, 30, 52), (-1, 44, 80), (1, 1, 1)),  # 480p: strides 3 and 5
    ((-1, 4, 16), (1, 1, 1), (24, 44, 80), (-1, 44, 80), (1, 11, 5)),  # comb02 layer 0
    ((-1, 4, 16), (1, 1, 1), (24, 22, 40), (-1, 44, 80), (1, 11, 5)),
    ((-1, 3, 3), (1, 1, 1), (4, 8, 8), None, (1, 1, 1)),
])
def test_adaptive_na_parameters_equal_jax(window, stride, shape, base, dilation):
    want = jna.adaptive_na_parameters(window, stride, shape, base, dilation)
    assert tna.adaptive_na_parameters(window, stride, shape, base, dilation) == tuple(map(tuple, want))


def test_effective_params_and_visible_pairs():
    size = tna.VideoSize(24, 44, 80)
    assert tna.effective_params(size, (24, 4, 16), (1, 1, 1), (1, 11, 5)) == jna._effective_params(
        jna.VideoSize(*size), (24, 4, 16), (1, 1, 1), (1, 11, 5))
    with pytest.raises(NotImplementedError):
        tna.effective_params(tna.VideoSize(2, 6, 8), (1, 3, 3), (1, 1, 1), (1, 4, 1))
    # every real query sees the same number of keys: the dense mask's count
    small, window, stride = tna.VideoSize(4, 8, 16), (-1, 4, 8), (1, 2, 4)
    idx = torch.arange(4 * 8 * 16)
    mask = tna.na_mask(idx[:, None], idx[None, :], small, window, stride)
    assert tna.visible_pairs(small, window) == int(mask.sum())
    assert tna.visible_pairs((24, 12, 20), (24, 3, 6)) == 5760 * 432  # 7.5% of the pairs at the smoke geometry


# (label, (T, H, W), window, stride, dilation): the JAX package's kernel test
# geometries, each with the gradient
KERNEL_CASES = [
    ("4x8x8 window 3x5x5", (4, 8, 8), (3, 5, 5), (1, 1, 1), (1, 1, 1)),
    ("padded 3x6x10", (3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1)),
    ("strided 4x8x16", (4, 8, 16), (-1, 4, 8), (1, 2, 4), (1, 1, 1)),
    ("dilated 2x8x16", (2, 8, 16), (-1, 2, 4), (1, 1, 1), (1, 4, 4)),
]


@pytest.fixture(scope="module", params=KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def kernel_case(request):
    """Inputs, and JAX's (out, dq, dk, dv) through the interpreted Pallas kernels."""
    _, size, window, stride, dilation = request.param
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((1, int(np.prod(size)), 2, 128)).astype(np.float32) for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, b, c: jna.neighborhood_attention(a, b, c, jna.VideoSize(*size), window, stride=stride,
                                                       dilation=dilation),
            *map(jnp.asarray, (q, k, v)),
        )
        grads = vjp(jnp.asarray(do))
    return request.param, (q, k, v, do), [np.asarray(x) for x in (out, *grads)]


def test_forward_matches_jax_kernel(kernel_case):
    (_, size, window, stride, dilation), (q, k, v, _), (want, *_) = kernel_case
    before = (tna.na_fwd.launches, tna.na_bwd_dq.launches, tna.na_bwd_dkv.launches)
    got = tna.neighborhood_attention(*map(torch.from_numpy, (q, k, v)), size, window, stride, dilation)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)
    assert (tna.na_fwd.launches, tna.na_bwd_dq.launches, tna.na_bwd_dkv.launches) == before  # CPU: no kernel


def test_gradients_match_jax_kernels(kernel_case):
    (_, size, window, stride, dilation), (q, k, v, do), (_, *want) = kernel_case
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tna.neighborhood_attention(*leaves, size, window, stride, dilation).backward(torch.from_numpy(do))
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_wrappers_on_cpu_take_the_plain_versions():
    """The CPU branches of the three wrappers give the plain versions'
    outputs; pad rows have out 0 and lse -1e30, so they stay finite."""
    size, window, stride = tna.VideoSize(3, 6, 10), (-1, 4, 6), (1, 1, 1)
    plan = tna.build_plan(size, window, stride, (1, 1, 1))
    rng = np.random.default_rng(2)
    qt, kt, vt, do_t = (tna.permute_in(torch.from_numpy(rng.standard_normal((1, 180, 2, 128)).astype(np.float32)), plan)
                        for _ in range(4))
    out, lse = tna.na_fwd(qt, kt, vt, plan, window, stride)
    ref_out, ref_lse = tna.na_fwd_plain(qt, kt, vt, plan, window, stride)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    pad = tna.permute_in(torch.ones((1, 180, 2, 1)), plan)[0, 0, :, 0] == 0
    assert pad.any() and torch.all(out[:, :, pad] == 0) and torch.all(lse[:, :, pad] == -1e30)
    delta = tna.na_delta(out, do_t)
    dq, dk, dv = tna.na_bwd_plain(qt, kt, vt, out, lse, do_t, plan, window, stride)
    assert torch.equal(tna.na_bwd_dq(qt, kt, vt, do_t, lse, delta, plan, window, stride), dq)
    for got, want in zip(tna.na_bwd_dkv(qt, kt, vt, do_t, lse, delta, plan, window, stride), (dk, dv)):
        assert torch.equal(got, want)
    assert torch.all(dk[:, :, pad] == 0) and torch.all(dq[:, :, pad] == 0)


@pytest.mark.parametrize("dilation,window", [((1, 4, 1), (1, 3, 3)), ((1, 2, 2), (1, 2, 4))],
                         ids=["dilation 4 on H=6", "window under the sub-grid"])
def test_unsupported_dilation_raises_on_cpu(dilation, window):
    """A dilation the kernels cannot express raises on the CPU as on the card
    (tests/test_torch_cuda.py): there is no dense-reference route."""
    x = torch.zeros((1, 96, 2, 128))
    with pytest.raises(NotImplementedError):
        tna.neighborhood_attention(x, x, x, (2, 6, 8), window, (1, 1, 1), dilation)
