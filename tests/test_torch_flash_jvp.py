"""The port's fused forward-mode flash attention (ops/flash_attention_jvp.py)
held against the JAX package's K9 (CPU, fp32).

JAX's ``flash_attention_fwdmode`` runs its Pallas kernel under
``pltpu.force_tpu_interpret_mode()``, as tests/test_flash_jvp.py runs it,
at B1 S256 H2 D128; the port's plain version (what the wrapper takes on
the CPU) and ``FlashAttentionFwdMode`` under ``torch.func.jvp`` and
``torch.autograd.forward_ad`` get the same seeded numpy inputs.
Tolerances are JAX's own for its kernel against the einsum reference:
atol 3e-5 on o, 3e-4 on do (measured: <= 1.5e-7 and 3.6e-7, the same
online softmax in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.ops.flash_attention_jvp import flash_attention_fwdmode as jax_fwdmode
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops import flash_attention_jvp as fj
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_plain

# (S, frame_group, which inputs have a tangent): JAX's cases, the kv tail (S 200)
CASES = [(256, 0, "qkv"), (256, 256, "qkv"), (256, 0, "v"), (200, 0, "qkv"), (256, 64, "qk")]


def inputs(S, tangents, seed=0):
    rng = np.random.default_rng(seed)
    prim = [rng.standard_normal((1, S, 2, 128)).astype(np.float32) for _ in range(3)]
    tang = [rng.standard_normal((1, S, 2, 128)).astype(np.float32) if name in tangents
            else np.zeros((1, S, 2, 128), np.float32) for name in "qkv"]
    return prim, tang


def jax_jvp(prim, tang, frame_group):
    with pltpu.force_tpu_interpret_mode():
        o, do = jax.jvp(lambda *a: jax_fwdmode(*a, frame_group), tuple(map(jnp.asarray, prim)),
                        tuple(map(jnp.asarray, tang)))
    return np.asarray(o), np.asarray(do)


def close(o, do, want_o, want_do):
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=3e-5)
    np.testing.assert_allclose(do.detach().numpy(), want_do, atol=3e-4)


@pytest.mark.parametrize("S,frame_group,tangents", CASES)
def test_plain_version_matches_jax_kernel(S, frame_group, tangents):
    prim, tang = inputs(S, tangents)
    want = jax_jvp(prim, tang, frame_group)
    close(*fj.flash_attention_jvp_plain(*map(torch.from_numpy, prim + tang), frame_group), *want)


@pytest.mark.parametrize("S,frame_group,tangents", CASES[:2] + CASES[3:4])
def test_fwdmode_function_under_func_jvp_and_forward_ad(S, frame_group, tangents):
    """The Function's primal (K1's plain version) and tangent (K9's) under
    both forward-mode APIs; the CPU wrappers launch nothing."""
    prim, tang = inputs(S, tangents, seed=1)
    want = jax_jvp(prim, tang, frame_group)
    p, tg = [torch.from_numpy(a) for a in prim], [torch.from_numpy(a) for a in tang]
    before = _build.launch_counts()
    close(*torch.func.jvp(lambda q, k, v: fj.flash_attention_fwdmode(q, k, v, frame_group), tuple(p), tuple(tg)), *want)
    with fwAD.dual_level():
        out = fj.flash_attention_fwdmode(*(fwAD.make_dual(a, b) for a, b in zip(p, tg)), frame_group)
        close(*fwAD.unpack_dual(out), *want)
    assert _build.launch_counts() == before


def test_fwdmode_calls_the_forward_and_the_jvp_once(monkeypatch):
    """Under torch.func.jvp the Function runs flash_attention_fwd (K1's
    wrapper) once for the primal and flash_attention_jvp (K9's) once for
    the tangent; an input without a tangent reaches K9 as zeros."""
    calls = []
    fwd, jvp = fj.flash_attention_fwd, fj.flash_attention_jvp
    monkeypatch.setattr(fj, "flash_attention_fwd", lambda *a, **k: calls.append("fwd") or fwd(*a, **k))
    monkeypatch.setattr(fj, "flash_attention_jvp", lambda *a, **k: calls.append(("jvp", a[3:6])) or jvp(*a, **k))
    prim, tang = inputs(64, "v", seed=2)
    p = [torch.from_numpy(a) for a in prim]
    _, do = torch.func.jvp(lambda v: fj.flash_attention_fwdmode(p[0], p[1], v), (p[2],), (torch.from_numpy(tang[2]),))
    assert [c if isinstance(c, str) else c[0] for c in calls] == ["fwd", "jvp"]
    dq, dk, dv = calls[1][1]
    assert not dq.any() and not dk.any() and torch.equal(dv, torch.from_numpy(tang[2]))
    np.testing.assert_allclose(do.numpy(), jax_jvp(prim, tang, 0)[1], atol=3e-4)


def test_fwdmode_hands_k9_tensors_with_storage_under_func_jvp(monkeypatch):
    """K9's wrapper reads data pointers (of its inputs and of the outputs it
    allocates); under torch.func.jvp the Function's jvp must hand it plain
    tensors and run it outside functorch's dispatch, where every tensor has
    storage. Checked on the CPU by a stand-in that touches the pointers as
    the CUDA route does."""
    jvp = fj.flash_attention_jvp

    def touching(*args):
        for x in args[:6]:
            x.data_ptr()
        torch.empty_like(args[0]).data_ptr()
        return jvp(*args)

    monkeypatch.setattr(fj, "flash_attention_jvp", touching)
    prim, tang = inputs(64, "qkv", seed=5)
    _, do = torch.func.jvp(fj.flash_attention_fwdmode, tuple(map(torch.from_numpy, prim)),
                           tuple(map(torch.from_numpy, tang)))
    np.testing.assert_allclose(do.numpy(), jax_jvp(prim, tang, 0)[1], atol=3e-4)


def test_fwdmode_outside_jvp_is_flash_attention_and_has_no_backward():
    prim, _ = inputs(128, "", seed=3)
    p = [torch.from_numpy(a) for a in prim]
    out = fj.flash_attention_fwdmode(*p)
    torch.testing.assert_close(out, flash_attention_plain(*p)[0], rtol=0, atol=0)
    leaves = [a.clone().requires_grad_(True) for a in p]
    with pytest.raises(NotImplementedError):
        fj.flash_attention_fwdmode(*leaves).sum().backward()


def test_tangents_take_the_primal_dtype():
    """JAX casts each tangent to its primal's dtype (flash_attention_jvp.py:191-194)."""
    prim, tang = inputs(64, "qkv", seed=4)
    p = [torch.from_numpy(a).bfloat16() for a in prim]
    o, do = fj.flash_attention_jvp(*p, *map(torch.from_numpy, tang))
    ref = fj.flash_attention_jvp_plain(*p, *(torch.from_numpy(a).bfloat16() for a in tang))
    assert o.dtype == do.dtype == torch.bfloat16
    assert torch.equal(o, ref[0]) and torch.equal(do, ref[1])
