"""The port's ring attention (parallel/ring_attention.py) held against the JAX package's.

Eight gloo ranks (tests/torch_dist_util.py, one start for the file) run the
ring at cp 4 (the first four ranks' group) and cp 8, without and with a
frame group of 8 (test_ring_attention.py's cases: B2 S32 H4 D16), a frame
group that does not align with the shards (the plain version's global
mask), the tiny DiT forward with ``cp_strategy="ring"``
(test_ring_attention.py:72), and the ring's gradients (dq, dk, dv of
test_ring_attention.py:45's loss, B1 S32 H4 D8) at cp 2 and 4, without
and with a frame group of 8. The JAX side is its ``ring_attention`` (whose
gradient is autodiff of its ring) and its ring-CP net on the conftest's
virtual CPU mesh. Tolerances are JAX's: 2e-5 on attention and its
gradients, 2e-4 on the DiT. A communication-pattern test reads the byte
log of parallel/comm.py: the backward moves each K/V shard c - 1 hops and
its fp32 dK / dV c - 1 hops and one home, and no q.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.parallel.ring_attention import ring_attention as j_ring
from cosmos_predict2_tpu_torch.ops.attention import reference_attention
from cosmos_predict2_tpu_torch.parallel.ring_attention import block_plain, merge, ring_attention
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch
from torch_dist_util import run_ranks
from torch_variants_util import jit_init, port_config

ATTN_TOL = 2e-5
DIT_TOL = 2e-4
RING_CASES = [(4, 0), (8, 0), (4, 8), (4, 6)]  # (cp, frame_group); 6 does not divide the 8-token shards
GRAD_CASES = [(2, 0), (4, 0), (2, 8), (4, 8)]  # (cp, frame_group) of the gradient cases


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 32, 4, 16)).astype(np.float32) for _ in range(3))


def _j_ring(q, k, v, cp, frame_group):
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))
    spec = NamedSharding(mesh, P(None, "cp", None, None))
    with jax.set_mesh(mesh):
        qs, ks, vs = (jax.device_put(jnp.asarray(t), spec) for t in (q, k, v))
        return np.asarray(jax.jit(lambda a, b, c: j_ring(a, b, c, frame_group=frame_group))(qs, ks, vs))


def _grad_case(seed):
    """test_ring_attention.py:45's inputs: q, k, v (B1 S32 H4 D8) and the target."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, 32, 4, 8)).astype(np.float32) for _ in range(4))


def _j_ring_grads(q, k, v, tgt, cp, frame_group):
    """JAX's gradients of mean((ring_attention(q, k, v) - tgt)^2) on a cp mesh."""
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))
    spec = NamedSharding(mesh, P(None, "cp", None, None))
    with jax.set_mesh(mesh):
        qs, ks, vs, ts = (jax.device_put(jnp.asarray(t), spec) for t in (q, k, v, tgt))
        loss = lambda a, b, c: jnp.mean((j_ring(a, b, c, frame_group=frame_group) - ts) ** 2)
        return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(qs, ks, vs)]


def _dit_case():
    jcfg = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", model_channels=256, num_heads=4,
                               adaln_lora_dim=32, cp_strategy="ring")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 4, 8, 8)).astype(np.float32)
    ts = np.full((1,), 700.0, np.float32)
    ctx = rng.standard_normal((1, 8, 1024)).astype(np.float32) * 0.05
    params = jax.tree.map(np.asarray, jit_init(JDiT(jcfg).init, jax.random.PRNGKey(2), x, ts, ctx))
    return jcfg, params, x, ts, ctx


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jcfg, params, x, ts, ctx = _dit_case()
    tcfg = port_config(jcfg)
    sd = {n: t.numpy() for n, t in jax_dit_params_to_torch(params, tcfg).items()}
    cases = [("ring", dict(zip("qkv", _qkv(i)), cp=cp, frame_group=fg)) for i, (cp, fg) in enumerate(RING_CASES)]
    cases.append(("dit_forward", dict(cfg=tcfg, state_dict=sd, x=x, t=ts, ctx=ctx)))
    cases += [("ring_grads", dict(zip(("q", "k", "v", "tgt"), _grad_case(20 + i)), cp=cp, frame_group=fg))
              for i, (cp, fg) in enumerate(GRAD_CASES)]
    return run_ranks(tmp_path_factory.mktemp("ring"), 8, cases), (jcfg, params, x, ts, ctx)


@pytest.mark.parametrize("i", range(3), ids=[f"cp{cp}-fg{fg}" for cp, fg in RING_CASES[:3]])
def test_ring_matches_jax(ranks, i):
    cp, fg = RING_CASES[i]
    shares = ranks[0][i]
    assert all(s is None for s in shares[cp:])
    got = np.concatenate(shares[:cp], axis=1)
    q, k, v = _qkv(i)
    np.testing.assert_allclose(got, _j_ring(q, k, v, cp, fg), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_ring_misaligned_frame_group_plain(ranks):
    """A frame group that cuts across the shards: the plain version's
    elementwise mask over global offsets gives the whole-sequence causal
    attention (on the card this raises instead)."""
    cp, fg = RING_CASES[3]
    got = np.concatenate(ranks[0][3][:cp], axis=1)
    want = reference_attention(*map(torch.from_numpy, _qkv(3)), frame_group=fg).numpy()
    np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)


def test_dit_forward_with_ring_cp_matches_jax(ranks):
    """The tiny DiT with ring CP over 4 ranks against JAX's ring-CP net (test_ring_attention.py:72)."""
    jcfg, params, x, ts, ctx = ranks[1]
    net_cp = JDiT(dataclasses.replace(jcfg, cp_axis="cp"))
    mesh = Mesh(np.array(jax.devices()[:4]), ("cp",))
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, None, "cp")))
        want = np.asarray(jax.jit(lambda p, a: net_cp.apply(p, a, jnp.asarray(ts), jnp.asarray(ctx)))(params, xs))
    for got in ranks[0][4][:4]:
        np.testing.assert_allclose(got, want, atol=DIT_TOL, rtol=0)


def test_block_merge_equals_whole_attention():
    """Two K/V halves, each block's (out, lse) merged in fp32, equal one
    attention over both; a fully masked block merges away."""
    q, k, v = map(torch.from_numpy, _qkv(9))
    acc = (torch.zeros(q.shape), torch.full((2, 4, 32), float("-inf")))
    for k0 in (0, 16):
        acc = merge(acc, block_plain(q, k[:, k0:k0 + 16], v[:, k0:k0 + 16], 0, k0, 0))
    torch.testing.assert_close(acc[0], reference_attention(q, k, v), atol=ATTN_TOL, rtol=0)
    q8 = q[:, :8]  # the first frame group of 8 tokens
    acc = merge((torch.zeros(q8.shape), torch.full((2, 4, 8), float("-inf"))),
                block_plain(q8, k[:, :16], v[:, :16], 0, 0, 8))
    out, lse = block_plain(q8, k[:, 16:], v[:, 16:], 0, 16, 8)  # every key after every query
    assert torch.isneginf(lse).all() and torch.isfinite(out).all()
    merged = merge(acc, (out, lse))
    torch.testing.assert_close(merged[0], acc[0], atol=0, rtol=0)
    torch.testing.assert_close(merged[0], reference_attention(q8, k[:, :8], v[:, :8]), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("i", range(len(GRAD_CASES)), ids=[f"cp{cp}-fg{fg}" for cp, fg in GRAD_CASES])
def test_ring_gradients_match_jax(ranks, i):
    """dq, dk, dv of the ring's backward (the ring run again with the
    global lse, K7 / K8's plain versions per block, dK / dV travelling
    with the K/V shards) assembled in rank order, against the autodiff of
    JAX's ring (test_ring_attention.py:45) and the plain whole-sequence
    attention's gradient."""
    cp, fg = GRAD_CASES[i]
    shares = ranks[0][len(RING_CASES) + 1 + i]
    assert all(s is None for s in shares[cp:])
    got = [np.concatenate([s[j] for s in shares[:cp]], axis=1) for j in range(3)]
    q, k, v, tgt = _grad_case(20 + i)
    for g, w in zip(got, _j_ring_grads(q, k, v, tgt, cp, fg)):
        np.testing.assert_allclose(g, w, atol=ATTN_TOL, rtol=ATTN_TOL)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    ((reference_attention(tq, tk, tv, frame_group=fg) - torch.from_numpy(tgt)) ** 2).mean().backward()
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g, w.numpy(), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_ring_backward_communication_pattern(ranks):
    """The ring's hops, forward and backward, on every rank of the cp 4
    cases: the forward sends its K/V block c - 1 times; the backward sends
    it c - 1 times more, and its fp32 dK / dV c times (c - 1 hops around
    the ring and one home), each to the next rank; nothing else, so no q
    and no output moves."""
    for i, (cp, _) in enumerate(GRAD_CASES):
        for rank, share in enumerate(ranks[0][len(RING_CASES) + 1 + i][:cp]):
            fwd, bwd = share[3], share[4]
            block = (2, 1, 32 // cp, 4, 8)  # K and V stacked, or dK and dV
            assert [(r.kind, r.shape, r.peer) for r in fwd] == [("send", block, (rank + 1) % cp)] * (cp - 1)
            assert all((r.kind, r.shape, r.peer, r.dtype) == ("send", block, (rank + 1) % cp, torch.float32)
                       for r in bwd), bwd
            assert len(bwd) == (cp - 1) + cp
