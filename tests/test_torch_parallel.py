"""The port's context parallelism (parallel/) held against the JAX package's.

Four gloo ranks (tests/torch_dist_util.py: one start of four processes for
the whole file, a FileStore under tmp_path) run the port's CP routes on the
same seeded NumPy inputs and weights that go through the JAX package's
functions on the conftest's virtual CPU mesh: Ulysses dense, causal and with
neighborhood attention, the head-sharded streaming decode with and without
the row window, the tiny DiT forward (test_parallel.py:106), the mesh's
refusals, the streaming loop under CP, and the gradient of Ulysses, dense
and with neighborhood attention, against JAX's (test_parallel.py:62).
Tolerances are JAX's own: 2e-5 on attention, 1e-4 on its gradient, 2e-4
on the DiT. A communication-pattern test (the port's
counterpart of test_parallel.py:359) reads the byte log of
parallel/comm.py: the streaming decode moves only the new block through
four all-to-alls, never a cache tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.sharding import NamedSharding, PartitionSpec as P

from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.ops.attention import reference_attention
from cosmos_predict2_tpu.ops.flash_attention import _kv_cache_reference, _kv_cache_window_reference
from cosmos_predict2_tpu.parallel import mesh as jmesh
from cosmos_predict2_tpu.parallel.cp import ulysses_attention as j_ulysses
from cosmos_predict2_tpu.parallel.cp import ulysses_kv_cache_attention as j_ulysses_kv
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.parallel import mesh as tmesh
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch
from torch_dist_util import run_ranks
from torch_variants_util import jit_init, port_config

ATTN_TOL = 2e-5
GRAD_TOL = 1e-4
DIT_TOL = 2e-4
CP = 4


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(seed, shape):
    return tuple(_draw(seed + i, *shape) for i in range(3))


def _jmesh():
    return jmesh.make_mesh(1, 1, CP, 1, devices=jax.devices()[:CP])


def _j_ulysses(q, k, v, **kw):
    mesh = _jmesh()
    with jax.set_mesh(mesh):
        spec = NamedSharding(mesh, P(None, "cp", None, None))
        qs, ks, vs = (jax.device_put(jnp.asarray(t), spec) for t in (q, k, v))
        return np.asarray(jax.jit(lambda a, b, c: j_ulysses(a, b, c, axis_name="cp", **kw))(qs, ks, vs))


def _j_kv(q, k, v, k_buf, v_buf, fill, **kw):
    cache = {"k": jnp.asarray(k_buf), "v": jnp.asarray(v_buf), "len": jnp.int32(fill)}
    with jax.set_mesh(_jmesh()):
        out, new = jax.jit(lambda q, k, v, c: j_ulysses_kv(q, k, v, c, **kw))(q, k, v, cache)
    return np.asarray(out), np.asarray(new["k"]), np.asarray(new["v"]), int(new["len"])


# the cases, their JAX results and the port's, made once for the module
DENSE = _qkv(0, (2, 64, 8, 32))
NA_SIZE, NA_WINDOW = (4, 4, 4), (1, 3, 3)
NA = _qkv(10, (1, 64, 8, 32))
KV = dict(q=_draw(20, 1, 8, 4, 16), k=_draw(21, 1, 8, 4, 16), v=_draw(22, 1, 8, 4, 16),
          k_buf=_draw(23, 1, 4, 32, 16), v_buf=_draw(24, 1, 4, 32, 16), fill=12)
GH, GW = 4, 8
KVW = dict(q=_draw(30, 1, GH * GW, 4, 16), k=_draw(31, 1, GH * GW, 4, 16), v=_draw(32, 1, GH * GW, 4, 16),
           k_buf=_draw(33, 1, 4, 4 * GH * GW, 16), v_buf=_draw(34, 1, 4, 4 * GH * GW, 16), fill=2 * GH * GW)
GRAD_Q = _draw(70, 1, 32, 4, 16)  # test_parallel.py:62's shape
NA_GRAD_Q = _draw(71, 1, 64, 8, 32)
PATTERN = dict(q=_draw(40, 1, 8, 8, 16), k=_draw(41, 1, 8, 8, 16), v=_draw(42, 1, 8, 8, 16),
               k_buf=_draw(43, 1, 8, 32, 16), v_buf=_draw(44, 1, 8, 32, 16), fill=12)


def _dit_case():
    """test_parallel.py::test_dit_forward_with_cp's net and inputs."""
    jcfg = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", model_channels=256, num_heads=4,
                               adaln_lora_dim=32)
    x = _draw(50, 1, 16, 4, 8, 8)
    ts = np.full((1,), 700.0, np.float32)
    ctx = _draw(51, 1, 8, 1024) * 0.05
    params = jax.tree.map(np.asarray, jit_init(JDiT(jcfg).init, jax.random.PRNGKey(2), x, ts, ctx))
    return jcfg, params, x, ts, ctx


def _stream_case():
    """A causal net of 4 heads, one prefilled frame and 4 streamed one-frame blocks with a 2-frame window."""
    cfg = tdit.DiTConfig(model_channels=256, num_heads=4, num_blocks=2, adaln_lora_dim=32, crossattn_emb_channels=64,
                         dtype=torch.float32, remat="none", temporal_causal=True)
    sd = {n: t.numpy() for n, t in tdit.build_dit(cfg, "cpu", seed=7).state_dict().items()}
    kw = dict(emb=_draw(60, 1, 8, 64), init=_draw(61, 1, 16, 1, 8, 8),
              noise=[_draw(62 + i, 1, 16, 1, 8, 8) for i in range(4)], num_latent_frames=5, cache_frames=2,
              num_steps=2)
    return cfg, sd, kw


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of this file on four gloo ranks, in one start."""
    jcfg, params, x, ts, ctx = _dit_case()
    tcfg = port_config(jcfg)
    sd = {n: t.numpy() for n, t in jax_dit_params_to_torch(params, tcfg).items()}
    scfg, ssd, skw = _stream_case()
    window_cfg = dataclasses.replace(scfg, cache_na_window_rows=2)
    cases = {
        "dense": ("ulysses", dict(zip("qkv", DENSE))),
        "causal": ("ulysses", dict(zip("qkv", DENSE), frame_group=16)),
        "na": ("ulysses", dict(zip("qkv", NA), na=(NA_SIZE, NA_WINDOW, (1, 1, 1), (1, 1, 1)))),
        "kv": ("kv_cache", KV),
        "kv_window": ("kv_cache", dict(KVW, cache_window=((GH, GW), 2))),
        "pattern": ("kv_cache", PATTERN),
        "dit": ("dit_forward", dict(cfg=tcfg, state_dict=sd, x=x, t=ts, ctx=ctx)),
        "mesh": ("mesh_errors", {}),
        "stream": ("stream", dict(cfg=scfg, state_dict=ssd, **skw)),
        "stream_window": ("stream", dict(cfg=window_cfg, state_dict=ssd, **skw)),
        "grad": ("ulysses_grads", dict(q=GRAD_Q)),
        "na_grad": ("ulysses_grads", dict(q=NA_GRAD_Q, na=(NA_SIZE, NA_WINDOW, (1, 1, 1), (1, 1, 1)))),
    }
    results = run_ranks(tmp_path_factory.mktemp("cp"), CP, list(cases.values()))
    return dict(zip(cases, results)), (jcfg, params, x, ts, ctx), (scfg, window_cfg, ssd, skw)


def _assembled(shares, dim=1):
    return np.concatenate(shares, axis=dim)


def test_ulysses_matches_jax(ranks):
    got = _assembled(ranks[0]["dense"])
    np.testing.assert_allclose(got, _j_ulysses(*DENSE, backend="reference"), atol=ATTN_TOL, rtol=0)


def test_ulysses_frame_group_matches_jax(ranks):
    """Frame-block causal over global token indices (K1's frame_group on the gathered sequence)."""
    got = _assembled(ranks[0]["causal"])
    np.testing.assert_allclose(got, _j_ulysses(*DENSE, backend="reference", frame_group=16), atol=ATTN_TOL, rtol=0)


def test_ulysses_neighborhood_attention_matches_jax(ranks):
    """NA under CP (the reference's NattenA2AAttnOp): the all-to-all, then
    the window over the whole gathered sequence with H/c heads."""
    got = _assembled(ranks[0]["na"])
    np.testing.assert_allclose(got, _j_ulysses(*NA, na_video_size=NA_SIZE, na_window=NA_WINDOW), atol=ATTN_TOL,
                               rtol=0)


def _j_ulysses_grad(q, **kw):
    """JAX's d/dq of sum(ulysses_attention(q, q, q)^2) on its cp mesh (test_parallel.py:62)."""
    mesh = _jmesh()
    with jax.set_mesh(mesh):
        qs = jax.device_put(jnp.asarray(q), NamedSharding(mesh, P(None, "cp", None, None)))
        loss = lambda a: jnp.sum(j_ulysses(a, a, a, axis_name="cp", **kw) ** 2)
        return np.asarray(jax.jit(jax.grad(loss))(qs))


@pytest.mark.parametrize("case", ["grad", "na_grad"])
def test_ulysses_grads_match_jax(ranks, case):
    """The gradient through Ulysses (the all-to-alls' backward, then K7 / K8
    on the card, or K11 / K12 with neighborhood attention; their plain
    versions here): each rank's share of d/dq of the loss summed over the
    whole output against JAX's on its cp mesh; the NA case also against
    the single-device gradient of JAX's NA reference."""
    got = _assembled(ranks[0][case])
    if case == "grad":
        want = _j_ulysses_grad(GRAD_Q, backend="reference")
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=0)
        ref = jax.grad(lambda a: jnp.sum(reference_attention(a, a, a) ** 2))(jnp.asarray(GRAD_Q))
        np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_TOL, rtol=0)
        return
    from cosmos_predict2_tpu.ops.neighborhood_attention import VideoSize, neighborhood_attention_reference

    want = _j_ulysses_grad(NA_GRAD_Q, na_video_size=NA_SIZE, na_window=NA_WINDOW)
    np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=0)
    ref = jax.grad(lambda a: jnp.sum(neighborhood_attention_reference(a, a, a, VideoSize(*NA_SIZE), NA_WINDOW) ** 2))(
        jnp.asarray(NA_GRAD_Q))
    np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("case", ["kv", "kv_window"])
def test_ulysses_kv_cache_matches_jax(ranks, case):
    """The head-sharded streaming decode: every rank's share of the output
    and its head shard of the updated buffers against JAX's
    ulysses_kv_cache_attention (dense, and with the row window)."""
    data = KV if case == "kv" else KVW
    kw = {} if case == "kv" else dict(cache_grid=(GH, GW), cache_window_rows=2)
    want_out, want_k, want_v, want_len = _j_kv(*(data[n] for n in ("q", "k", "v", "k_buf", "v_buf", "fill")), **kw)
    shares = ranks[0][case]
    np.testing.assert_allclose(_assembled([s[0] for s in shares]), want_out, atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(_assembled([s[1] for s in shares]), want_k, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_assembled([s[2] for s in shares]), want_v, atol=1e-6, rtol=0)
    assert all(s[3] == want_len == data["fill"] + data["q"].shape[1] for s in shares)
    # against the single-device reference as JAX's own test holds it
    kb, vb = data["k_buf"].copy(), data["v_buf"].copy()
    n, s = data["fill"], data["q"].shape[1]
    kb[:, :, n:n + s], vb[:, :, n:n + s] = data["k"].transpose(0, 2, 1, 3), data["v"].transpose(0, 2, 1, 3)
    ref = (_kv_cache_reference(data["q"], kb, vb, jnp.int32(n + s)) if case == "kv" else
           _kv_cache_window_reference(data["q"], kb, vb, jnp.int32(n + s), (GH, GW), 2))
    np.testing.assert_allclose(_assembled([s[0] for s in shares]), np.asarray(ref), atol=ATTN_TOL, rtol=0)


def test_ulysses_kv_cache_communication_pattern(ranks):
    """The port's counterpart of test_parallel.py:359: the decode moves only
    the new block, through exactly 4 all-to-alls (q, k, v scattered, the
    output gathered) of the rank's block share, and no cache tensor enters
    any collective."""
    B, S, H, D = PATTERN["q"].shape
    cache_elems = PATTERN["k_buf"].size // CP  # a rank's head shard of one buffer
    for records in (s[4] for s in ranks[0]["pattern"]):
        assert [r.kind for r in records] == ["all_to_all"] * 4, records
        for r in records:
            elems = int(np.prod(r.shape))
            assert elems == B * S * H * D // CP < cache_elems, r
            assert PATTERN["k_buf"].shape[2] not in r.shape[2:], r  # no S_max axis


@pytest.mark.parametrize("strategy", ["ulysses"])
def test_dit_forward_with_cp_matches_jax(ranks, strategy):
    """The tiny DiT forward with CP over latent T, every rank's gathered
    output against JAX's net under its cp mesh (test_parallel.py:106), and
    the port's unsharded forward."""
    jcfg, params, x, ts, ctx = ranks[1]
    net_cp = JDiT(dataclasses.replace(jcfg, cp_axis="cp"))
    mesh = _jmesh()
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, None, "cp")))
        want = np.asarray(jax.jit(lambda p, a: net_cp.apply(p, a, jnp.asarray(ts), jnp.asarray(ctx)))(params, xs))
    for got in ranks[0]["dit"]:
        np.testing.assert_allclose(got, want, atol=DIT_TOL, rtol=0)
    tcfg = port_config(jcfg)
    net = tdit.MiniTrainDIT(tcfg)
    net.load_state_dict(jax_dit_params_to_torch(params, tcfg), strict=True)
    with torch.no_grad():
        local = net(*map(torch.from_numpy, (x, ts, ctx))).numpy()
    np.testing.assert_allclose(ranks[0]["dit"][0], local, atol=DIT_TOL, rtol=0)


@pytest.mark.parametrize("window", [False, True])
def test_streaming_under_cp_matches_one_rank(ranks, window):
    """StreamingInference.generate with the net context-parallel over 4
    ranks (one-frame blocks of a 4 x 4 token grid: each rank takes one token
    row; caches of 1 head each, the window sliding twice) against the same
    loop on one rank, which tests/test_torch_interactive.py holds against
    JAX; with a 2-row cache window too."""
    scfg, window_cfg, sd, kw = ranks[2]
    shares = ranks[0]["stream_window" if window else "stream"]
    cfg = window_cfg if window else scfg
    from torch_dist_util import stream

    want, heads = stream(cfg, sd, cp=False, **kw)
    assert heads == [4] * 4
    for got, rank_heads in shares:
        assert rank_heads == [1] * 4
        np.testing.assert_allclose(got, want, atol=DIT_TOL, rtol=0)


def test_mesh_refusals_match_jax(ranks):
    """make_mesh's pp and size errors, with JAX's messages; a 1x2x2x1 mesh's axes."""
    pp, size, ok = ranks[0]["mesh"][0]
    with pytest.raises(ValueError) as e:
        jmesh.make_mesh(1, 1, 1, 1, devices=jax.devices()[:1], pp=2)
    assert pp == str(e.value)
    with pytest.raises(ValueError) as e:
        jmesh.make_mesh(1, 1, 2, 1, devices=jax.devices()[:4])
    assert size == str(e.value)
    assert ok == (tmesh.MESH_AXES, 2, 2)
    with pytest.raises(ValueError, match="pipeline"):
        tmesh.make_mesh(pp=2, device_type="cpu")


def _port_linears():
    """Every 2D parameter of the port's tiny DiT, Wan DiT and Qwen LM: (name, shape)."""
    from cosmos_predict2_tpu_torch.networks import wan_dit
    from cosmos_predict2_tpu_torch.text_encoders import qwen

    nets = [tdit.MiniTrainDIT(tdit.DiTConfig(model_channels=64, num_heads=2, num_blocks=1, adaln_lora_dim=16,
                                             crossattn_emb_channels=32)),
            wan_dit.WanModel(dataclasses.replace(wan_dit.WAN_PRESETS["test"], text_dim=32, clip_dim=32)),
            qwen.QwenLM(qwen.QwenConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                        num_attention_heads=2, num_key_value_heads=1, head_dim=16))]
    return [(n, tuple(p.shape)) for net in nets for n, p in net.state_dict().items()]


def test_param_sharding_rules_match_jax_on_the_port_keys():
    """param_sharding_rules on the port's state-dict names and (out, in)
    weights gives JAX's rule on the same names (Flax's ``ffn_0`` / ``ffn_2``
    for the Wan MLP's ``ffn.0`` / ``ffn.2``) and the (in, out) kernel,
    transposed; and the rule of test_parallel.py:99's cases."""
    from jax.tree_util import DictKey

    items = _port_linears()
    assert len(items) > 40
    tp_seen = 0
    for name, shape in items:
        got = tmesh.param_sharding_rules(name, shape)
        jax_name = name.replace("ffn.0.", "ffn_0.").replace("ffn.2.", "ffn_2.")  # Flax's module names
        path = tuple(DictKey(k) for k in jax_name.split("."))
        if len(shape) == 2:
            want = tuple(jmesh.param_sharding_rules(path, np.zeros(shape[::-1], np.float32)))[::-1]
            tp_seen += "tp" in got
        else:
            want = tuple(jmesh.param_sharding_rules(path, np.zeros(shape, np.float32)))
        assert got == want, (name, shape, got, want)
    assert tp_seen >= 10
    assert tmesh.param_sharding_rules("blocks.0.self_attn.q_proj.weight", (64, 64)) == ("tp", "fsdp")
    assert tmesh.param_sharding_rules("blocks.0.mlp.layer2.weight", (64, 256)) == ("fsdp", "tp")
    assert tmesh.param_sharding_rules("t_embedding_norm.weight", (64,)) == ()


def test_token_slab_and_divisibility():
    """A slab is whole frames, or rows of one frame; anything else raises."""
    s = tmesh.token_slab((4, 4, 8), 4, 2)
    assert (s.local_grid, s.frames, s.tokens) == ((1, 4, 8), (2, 3), (64, 96))
    s = tmesh.token_slab((1, 4, 8), 4, 3)
    assert (s.local_grid, s.frames, s.tokens) == ((1, 1, 8), (0, 1), (24, 32))
    with pytest.raises(ValueError, match="split evenly"):
        tmesh.token_slab((3, 3, 8), 4, 0)
    with pytest.raises(ValueError, match="neither whole frames"):
        tmesh.token_slab((3, 4, 8), 2, 0)
    assert tmesh.divisible_cp(8, 4) and not tmesh.divisible_cp(6, 4)
    x = torch.arange(2 * 4 * 4 * 8).reshape(2, 4, 4, 8)
    assert torch.equal(tmesh.token_slab((4, 4, 8), 2, 1).take(x), x[:, 2:])
