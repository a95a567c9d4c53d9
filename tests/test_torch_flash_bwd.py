"""The port's flash-attention backward held against the JAX package's.

JAX's gradient is ``jax.vjp`` of ``flash_attention`` under
``pltpu.force_tpu_interpret_mode()``, so its Pallas ``_dq_kernel`` and
``_dkv_kernel`` run as the JAX package's own tests run Pallas. The same
numpy inputs (fp32) go through the port's ``flash_attention_bwd_plain``, the
``FlashAttention`` autograd Function and the CPU side of the kernel
wrappers. Tolerance 1e-5 absolute and relative: fp32 end to end, the two
sides differ only in summation order (measured <= 1.3e-6 on gradients of
magnitude ~1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from cosmos_predict2_tpu_torch.ops.attention import dot_product_attention, reference_attention
from cosmos_predict2_tpu_torch.ops.flash_attention import (
    DKV_BLOCK_KV,
    DKV_BLOCK_Q,
    FlashAttention,
    _dkv_plain,
    _probs_ds,
    attention_delta,
    dkv_split_plan,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
)

TOL = 1e-5
# (label, Sq, Skv, frame_group): ragged self-attention (200 is no multiple of
# any tile), cross-attention to 77 text tokens, the frame-block mask
CASES = [("ragged self", 200, 200, 0), ("cross Skv77", 200, 77, 0), ("frame_group 50", 200, 200, 50)]


def _inputs(sq, skv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, 2, 128)).astype(np.float32)
    k, v = (rng.standard_normal((1, skv, 2, 128)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((1, sq, 2, 128)).astype(np.float32)
    return q, k, v, do


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """Inputs and JAX's (out, dq, dk, dv), through the interpreted Pallas kernels."""
    _, sq, skv, fg = request.param
    q, k, v, do = _inputs(sq, skv)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, frame_group=fg), *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return (q, k, v, do, fg), [np.asarray(x) for x in (out, *grads)]


def test_bwd_plain_matches_jax_kernels(case):
    (q, k, v, do, fg), (want_out, *want) = case
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_fwd(tq, tk, tv, frame_group=fg)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL, atol=TOL)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, fg)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_autograd_function_matches_jax_kernels(case):
    (q, k, v, do, fg), (_, *want) = case
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    dot_product_attention(tq, tk, tv, frame_group=fg).backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_autograd_function_matches_torch_autograd_of_reference(case):
    (q, k, v, do, fg), _ = case
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    FlashAttention.apply(*a, fg).backward(torch.from_numpy(do))
    reference_attention(*b, frame_group=fg).backward(torch.from_numpy(do))
    for name, x, y in zip("qkv", a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_cpu_wrappers_take_the_plain_version(case):
    (q, k, v, do, fg), (_, *want) = case
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    out, lse = flash_attention_fwd(tq, tk, tv, frame_group=fg)
    delta = attention_delta(out, tdo)
    assert delta.shape == (1, 2, q.shape[1])
    dq = flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, fg)
    dk, dv = flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta, fg)
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=f"d{name}")
    # the counters count kernel launches only
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == before


def test_bf16_plain_backward_rounds_like_the_kernels():
    """In bf16 the plain backward (P and dS rounded to bf16, fp32 sums)
    stays within bf16 rounding of the fp32 gradients and returns bf16."""
    q, k, v, do = _inputs(96, 80, seed=3)
    t32 = [torch.from_numpy(a) for a in (q, k, v, do)]
    t16 = [a.bfloat16() for a in t32]
    out32, lse32 = flash_attention_fwd(*t32[:3])
    out16, lse16 = flash_attention_fwd(*t16[:3])
    g32 = flash_attention_bwd_plain(*t32[:3], out32, lse32, t32[3])
    g16 = flash_attention_bwd_plain(*t16[:3], out16, lse16, t16[3])
    for a, b in zip(g32, g16):
        assert b.dtype == torch.bfloat16 and torch.isfinite(b.float()).all()
        assert float((a - b.float()).norm() / a.norm()) < 2e-2


# K8's split plan: the main path's geometries (H16, B1, 132 SMs) and one head
# (fewer CTAs, so the q ranges split), at the frame groups of the tests and
# of the card checks
PLAN_CASES = [(sq, skv, heads, fg) for sq, skv in ((5760, 512), (5760, 5760), (84480, 84480))
              for heads in (16, 1) for fg in ((0,) if skv == 512 else (0, 50, 100, 240))]


@pytest.mark.parametrize("sq,skv,heads,fg", PLAN_CASES)
def test_dkv_split_plan_covers_every_visible_q_tile_once(sq, skv, heads, fg):
    plan = dkv_split_plan(sq, skv, heads, 1, fg, sms=132)
    assert plan.splits >= 1 and (plan.splits == 1) == (plan.kv_tiles * heads >= 132)
    q_tiles = -(-sq // DKV_BLOCK_Q)
    for t in range(plan.kv_tiles):
        ranges = plan.q_ranges(t)
        assert len(ranges) == plan.splits
        # the runs are consecutive, in split order, and end at the sequence's end
        assert ranges[-1][1] == sq or ranges[-1][0] == ranges[-1][1] == sq
        for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
            assert e0 == b1
        begin = ranges[0][0]
        assert begin % DKV_BLOCK_Q == 0 and all(b % DKV_BLOCK_Q == 0 or b == sq for b, _ in ranges)
        # every q tile holding a query that sees a key of this kv tile is inside
        first_visible = (t * DKV_BLOCK_KV // fg) * fg if fg > 0 else 0
        assert begin <= first_visible
        # and none before it: the tile before `begin` sees none of the kv tile
        assert begin == 0 or begin // DKV_BLOCK_Q == first_visible // DKV_BLOCK_Q
        assert sum(e - b for b, e in ranges) == sq - begin <= q_tiles * DKV_BLOCK_Q


@pytest.mark.parametrize("sq,skv,fg", [(600, 512, 0), (600, 600, 100), (520, 520, 240)])
def test_split_partials_sum_to_the_unsplit_gradients(sq, skv, fg):
    """The plain dK/dV summed over the plan's q ranges (in split order, per
    kv tile) equal the unsplit plain dK/dV within fp32 round-off (1e-5
    relative and absolute on O(1) values: two or three partial sums against
    one)."""
    q, k, v, do = map(torch.from_numpy, _inputs(sq, skv, seed=5))
    out, lse = flash_attention_fwd(q, k, v, frame_group=fg)
    probs, ds = _probs_ds(q, k, v, do, lse, attention_delta(out, do), fg)
    want_k, want_v = _dkv_plain(probs, ds, q, k, v, do)
    plan = dkv_split_plan(sq, skv, 1, 1, fg, sms=132)
    assert plan.splits > 1
    got_k, got_v = torch.zeros_like(want_k), torch.zeros_like(want_v)
    for t in range(plan.kv_tiles):
        kv = slice(t * DKV_BLOCK_KV, min((t + 1) * DKV_BLOCK_KV, skv))
        for b, e in plan.q_ranges(t):
            dk, dv = _dkv_plain(probs[..., b:e, kv], ds[..., b:e, kv], q[:, b:e], k[:, kv], v[:, kv], do[:, b:e])
            got_k[:, kv] += dk
            got_v[:, kv] += dv
    np.testing.assert_allclose(got_k.numpy(), want_k.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), rtol=1e-5, atol=1e-5)
