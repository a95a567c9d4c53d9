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
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from cosmos_predict2_tpu_torch.ops.attention import dot_product_attention, reference_attention
from cosmos_predict2_tpu_torch.ops.flash_attention import (
    FlashAttention,
    attention_delta,
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
