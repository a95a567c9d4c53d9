"""The port's interactive path held against the JAX package: RoPE's frame
offset, the causal DiT (full forward and KV-cache decode, caches after
every call), the streaming loop with JAX's noise draws (caches after every
block, window slides included), the interactive experiment's config, the
entry point.

Tolerances: 1e-4 on the fp32 DiT outputs, as tests/test_torch_dit.py; 2e-4
absolute on the streamed latents and caches, as the JAX package's own
interactive tests use (the 2-step loop feeds each block's output into the
next block's cache, so the DiT's ~1e-6 relative differences add up).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.conditioning.conditioner import make_condition as j_make_condition
from cosmos_predict2_tpu.models import interactive as jint
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.ops import rope as j_rope
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models import interactive as tint
from cosmos_predict2_tpu_torch.models.distillation import DEFAULT_SAMPLING_TIMES, trigflow_scalings_rf
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.ops import rope as t_rope
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch

TOL = 1e-4
STREAM_ATOL = 2e-4
SHAPE = (1, 16, 4, 8, 8)  # 4 latent frames of 8 x 8: a 4 x 4 token grid


# ---------------------------------- rope ----------------------------------


@pytest.mark.parametrize("T,t_start,fps_mod", [(1, 5, True), (1, 5, False), (3, 7, True), (3, 7, False), (2, 0, True)])
def test_rope_t_start_matches_jax(T, t_start, fps_mod):
    """Absolute frame offsets, with and without fps modulation; as in JAX a
    one-frame table is never fps-modulated."""
    kw = dict(head_dim=128, h_extrapolation_ratio=3.0, w_extrapolation_ratio=3.0, enable_fps_modulation=fps_mod)
    fps = np.asarray([16.0], np.float32)
    got = t_rope.rope_angles_3d(t_rope.RopeSpec(**kw), T, 4, 5, fps=torch.from_numpy(fps), t_start=t_start)
    want = j_rope.rope_angles_3d(j_rope.RopeSpec(**kw), T, 4, 5, fps=jnp.asarray(fps), t_start=t_start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    if T == 1:  # fps never applies to one frame: the table is that of frame t_start
        plain = t_rope.rope_angles_3d(t_rope.RopeSpec(**kw), 1, 4, 5, t_start=t_start)
        assert torch.equal(got, plain)


def test_rope_makes_no_tensor_from_host_memory_per_call(monkeypatch):
    """The frequency tables are made once per device: a tensor made from
    host memory in every forward is a pageable copy, for which the host
    waits until the card is idle (found on the card: the streaming loop's
    forwards could not be queued ahead)."""
    spec = t_rope.RopeSpec(head_dim=128, h_extrapolation_ratio=3.0)
    first = t_rope.rope_angles_3d(spec, 1, 3, 4, t_start=2)
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: made.append(a) or real(*a, **k))
    again = t_rope.rope_angles_3d(spec, 1, 3, 4, t_start=2)
    assert made == [] and torch.equal(first, again)


# ---------------------------------- config ----------------------------------


def test_distillation_times_and_scalings_match_jax():
    from cosmos_predict2_tpu.models import distillation as jd
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig

    assert DEFAULT_SAMPLING_TIMES == jd.DEFAULT_SAMPLING_TIMES
    t = np.asarray(DEFAULT_SAMPLING_TIMES + (0.3,), np.float32)
    t64 = t.astype(np.float64)
    denom = np.cos(t64) + 0.7 * np.sin(t64)
    exact = (0.7 / denom, -0.7 * np.sin(t64) / denom, 0.7 / denom, 0.7 * np.sin(t64) / denom)
    got = trigflow_scalings_rf(torch.from_numpy(t), 0.7)
    for g, e, j in zip(got, exact, jd.trigflow_scalings_rf(jnp.asarray(t), 0.7)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), e.astype(np.float32))  # fp64, then rounded to fp32
        # JAX without jax_enable_x64 computes these in fp32: within 2 fp32 ulps
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2.5e-7, atol=0)
    names = {f.name for f in dataclasses.fields(DistillationConfig)} - {"model"}
    assert names == {f.name for f in dataclasses.fields(jd.DistillationConfig)} - {"model"}
    assert all(getattr(DistillationConfig(), n) == getattr(jd.DistillationConfig(), n) for n in names)


# --------------------------------- the DiT ---------------------------------


def _jax_model(nfpb=1, window=-1):
    net = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", cache_na_window_rows=window)
    return jint.CausalVideo2WorldModel(jint.causal_model_config(net, num_frame_per_block=nfpb, state_t=SHAPE[2]))


def _port_model(jmodel, params):
    jn = jmodel.config.net
    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype", "remat"}
    cfg = tdit.DiTConfig(dtype=torch.float32, remat="none", **{n: getattr(jn, n) for n in names})
    net = tdit.MiniTrainDIT(cfg).requires_grad_(False)
    net.load_state_dict(jax_dit_params_to_torch(params, cfg), strict=True)
    mc = tint.causal_model_config(cfg, num_frame_per_block=cfg.num_frame_per_block, state_t=SHAPE[2])
    return tint.CausalVideo2WorldModel(mc, net)


@pytest.fixture(scope="module")
def models():
    """The JAX causal model of tests/test_interactive.py (test preset, 3
    heads of 128, fp32) with seeded noise on every parameter, the port's
    model on the same weights, and one text condition for both."""
    jmodel = _jax_model()
    params = jax.jit(jmodel.init_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), SHAPE, 8)
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(l, np.float32) + 0.05 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves]
    params = jax.tree.unflatten(tdef, leaves)
    emb = (rng.standard_normal((1, 8, 1024)) * 0.05).astype(np.float32)
    return jmodel, params, _port_model(jmodel, params), emb


def test_causal_dit_matches_jax_and_is_causal(models):
    """The full block-causal forward (K1's frame_group on the plain path)
    against JAX; perturbing the last frame leaves the earlier ones alone."""
    jmodel, params, tmodel, emb = models
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    ts = np.full((1, SHAPE[2]), 500.0, np.float32)
    want = jmodel.net.apply(params, x, ts, emb)
    with torch.no_grad():
        got = tmodel.net(*map(torch.from_numpy, (x, ts, emb)))
        x2 = x.copy()
        x2[:, :, -1] *= -1
        got2 = tmodel.net(*map(torch.from_numpy, (x2, ts, emb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    torch.testing.assert_close(got2[:, :, :-1], got[:, :, :-1], rtol=0, atol=1e-5)
    assert float((got2[:, :, -1] - got[:, :, -1]).abs().max()) > 1e-4


@pytest.mark.parametrize("nfpb", [1, 2])
def test_cached_forward_matches_jax_and_full_forward(models, nfpb):
    """Decode in blocks of ``nfpb`` frames against the KV cache: outputs and
    the caches' k, v and len after every call equal JAX's forward_with_cache;
    the decoded stream equals the port's own full causal forward."""
    jmodel0, params, tmodel0, emb = models
    jmodel = _jax_model(nfpb) if nfpb > 1 else jmodel0
    tmodel = _port_model(jmodel, params) if nfpb > 1 else tmodel0
    B, C, T, H, W = SHAPE
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    jcond, tcond = j_make_condition(jnp.asarray(emb)), make_condition(torch.from_numpy(emb))
    jcaches = jmodel.init_kv_caches(B, T, H, W, dtype=jnp.float32)
    tcaches = tmodel.init_kv_caches(B, T, H, W, "cpu", dtype=torch.float32)
    jfwd = jax.jit(jmodel.forward_with_cache)
    outs = []
    for t0 in range(0, T, nfpb):
        block = x[:, :, t0:t0 + nfpb]
        ts = np.full((B, nfpb), 300.0, np.float32)
        jout, jcaches = jfwd(params, jnp.asarray(block), jnp.asarray(ts), jcond, jcaches, t0)
        tout, tcaches = tmodel.forward_with_cache(torch.from_numpy(block), torch.from_numpy(ts), tcond, tcaches, t0)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
        for jc, tc in zip(jcaches, tcaches):
            assert tc["len"] == int(jc["len"]) == (t0 + nfpb) * 16
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=TOL, atol=TOL)
        outs.append(tout)
    with torch.no_grad():
        full = tmodel.net(torch.from_numpy(x), torch.full((B, T), 300.0), torch.from_numpy(emb))
    torch.testing.assert_close(torch.cat(outs, dim=2), full, rtol=0, atol=STREAM_ATOL)


def test_denoise_forward_leaves_the_cache_length(models):
    """A forward whose caches are dropped (a denoise step) writes only past
    ``len``; the next forward overwrites those slots."""
    _, _, tmodel, emb = models
    cond = make_condition(torch.from_numpy(emb))
    caches = tmodel.init_kv_caches(1, 2, 8, 8, "cpu", dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 16, 1, 8, 8)).astype(np.float32))
    _, dropped = tmodel.forward_with_cache(x, torch.zeros((1, 1)), cond, caches, 0)
    assert [c["len"] for c in caches] == [0, 0] and [c["len"] for c in dropped] == [16, 16]
    out_a, kept = tmodel.forward_with_cache(-x, torch.zeros((1, 1)), cond, caches, 0)
    fresh = tmodel.init_kv_caches(1, 2, 8, 8, "cpu", dtype=torch.float32)
    out_b, ref = tmodel.forward_with_cache(-x, torch.zeros((1, 1)), cond, fresh, 0)
    assert torch.equal(out_a, out_b) and all(torch.equal(a["k"], b["k"]) for a, b in zip(kept, ref))


def test_causal_dit_with_sparse_blocks_raises():
    with pytest.raises(NotImplementedError):
        tdit.MiniTrainDIT(tdit.DiTConfig(model_channels=256, num_heads=2, num_blocks=2, temporal_causal=True,
                                         n_dense_blocks=1))


def test_cached_forward_under_autograd_raises(models):
    _, _, tmodel, emb = models
    net = tdit.MiniTrainDIT(tmodel.net.cfg)
    caches = tmodel.init_kv_caches(1, 1, 8, 8, "cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        net(torch.zeros((1, 16, 1, 8, 8)), torch.zeros((1, 1)), torch.from_numpy(emb), kv_caches=caches)


def test_shift_cache_window_is_a_roll_in_place():
    buf = torch.arange(2 * 3 * 10 * 4, dtype=torch.float32).reshape(2, 3, 10, 4)
    for drop in (1, 3, 4, 10):
        cache = {"k": buf.clone(), "v": -buf, "len": 10}
        k_ptr = cache["k"].data_ptr()
        out = tint.shift_cache_window(dict(cache, v=cache["v"].clone()), drop)
        assert out["len"] == 10 - drop and out["k"].data_ptr() == k_ptr
        np.testing.assert_array_equal(out["k"].numpy(), np.roll(buf.numpy(), -drop, axis=2))
        np.testing.assert_array_equal(out["v"].numpy(), np.roll(-buf.numpy(), -drop, axis=2))


def test_cast_matmul_weights_keeps_the_output(models):
    _, params, tmodel, emb = models
    cfg = dataclasses.replace(tmodel.net.cfg, dtype=torch.bfloat16)
    a, b = tdit.MiniTrainDIT(cfg), tdit.MiniTrainDIT(cfg)
    a.load_state_dict(tmodel.net.state_dict())
    b.load_state_dict(tmodel.net.state_dict())
    tdit.cast_matmul_weights(b)
    assert b.blocks[0].mlp.layer1.weight.dtype == torch.bfloat16
    assert b.blocks[0].adaln_modulation_mlp[1].weight.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32))
    with torch.no_grad():
        args = (x, torch.full((1, SHAPE[2]), 200.0), torch.from_numpy(emb))
        assert torch.equal(a(*args), b(*args))


# ------------------------------- streaming -------------------------------


def _capture_jax_caches(stream, records):
    """Wrap the JAX loop's compiled block step and window slide so that the
    caches after every block (and its slide) are kept as numpy copies."""
    block_fn, shift_fn = stream._jitted_block, stream._jitted_shift
    as_np = lambda caches: [{k: np.array(c[k], copy=True) for k in ("k", "v", "len")} for c in caches]

    def block(shape):
        fn = block_fn(shape)

        def run(*args):
            x, caches = fn(*args)
            records.append(as_np(caches))
            return x, caches
        return run

    def shift(drop):
        fn = shift_fn(drop)

        def run(caches):
            out = fn(caches)
            records[-1] = as_np(out)
            return out
        return run

    stream._jitted_block, stream._jitted_shift = block, shift


def _fp32_caches(model, dtype):
    """A shallow copy of ``model`` whose init_kv_caches makes fp32 buffers."""
    model = copy.copy(model)
    init = model.init_kv_caches
    model.init_kv_caches = lambda *args, **kw: init(*args, **kw, dtype=dtype)
    return model


@pytest.mark.parametrize("window", [-1, 4, 2])
def test_streaming_generate_matches_jax(models, window):
    """StreamingInference.generate, 2 steps, one prefilled frame and 6
    streamed blocks with a 3-frame window (it slides 4 times): the latents,
    and every block's caches (k, v, len) after its commit and slide, equal
    JAX's with JAX's noise draws. Window 4 rows on the 4 x 4 token grid is
    the dense cache; window 2 is not."""
    jmodel0, params, tmodel0, emb = models
    jmodel = _jax_model(window=window) if window > 0 else jmodel0
    tmodel = _port_model(jmodel, params) if window > 0 else tmodel0
    scfg = dict(num_frame_per_block=1, cache_frame_size=3, num_steps=2)
    jstream = jint.StreamingInference(jint.StreamingConfig(**scfg), jmodel)
    tstream = tint.StreamingInference(tint.StreamingConfig(**scfg), tmodel)
    # fp32 caches on both sides: the loops' default bf16 caches round P to
    # bf16 in both attentions, which turns ~1e-7 logit differences into
    # ~1e-3 steps (bf16 on the card against fp32: chip_smoke.py)
    jstream.model = _fp32_caches(jmodel, jnp.float32)
    tstream.model = _fp32_caches(tmodel, torch.float32)
    init = np.random.default_rng(6).standard_normal((1, 16, 1, 8, 8)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jax_records = []
    _capture_jax_caches(jstream, jax_records)
    want = jstream.generate(params, rng, j_make_condition(jnp.asarray(emb)), jnp.asarray(init), 7, (8, 8))

    def draw(step, shape):  # JAX's draw for block `step`
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.fold_in(rng, step), shape, jnp.float32)))

    records = []
    on_block = lambda step, x, caches: records.append([{k: c[k].clone() for k in ("k", "v")} | {"len": c["len"]}
                                                       for c in caches])
    before = _build.launch_counts()
    got = tstream.generate(make_condition(torch.from_numpy(emb)), torch.from_numpy(init), 7, (8, 8), draw=draw,
                           on_block=on_block)
    assert _build.launch_counts() == before
    assert got.shape == (1, 16, 7, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STREAM_ATOL)
    assert len(records) == len(jax_records) == 6
    for step, (tc_all, jc_all) in enumerate(zip(records, jax_records)):
        for tc, jc in zip(tc_all, jc_all):
            # filled frames: 1 prefilled + step + 1 blocks, at most 3 after a slide
            assert tc["len"] == int(jc["len"]) == 16 * min(step + 2, 3)
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(), jc[name], rtol=0, atol=STREAM_ATOL)
    if window > 0:
        dense = tint.StreamingInference(tint.StreamingConfig(**scfg), tmodel0)
        dense.model = _fp32_caches(tmodel0, torch.float32)
        dense = dense.generate(make_condition(torch.from_numpy(emb)), torch.from_numpy(init), 7, (8, 8), draw=draw)
        if window == 4:
            torch.testing.assert_close(got, dense, rtol=0, atol=1e-5)
        else:
            assert float((got - dense).abs().max()) > 1e-4  # the window engaged


def test_streaming_generate_draws_from_a_generator(models):
    _, _, tmodel, emb = models
    stream = tint.StreamingInference(tint.StreamingConfig(cache_frame_size=2, num_steps=1), tmodel)
    cond = make_condition(torch.from_numpy(emb))
    a, b = (stream.generate(cond, None, 3, (8, 8), generator=torch.Generator().manual_seed(0)) for _ in range(2))
    assert a.shape == (1, 16, 3, 8, 8) and torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="Generator"):
        stream.generate(cond, None, 1, (8, 8))


# --------------------------- config, entry point ---------------------------


def test_causal_params_convert_unchanged(models):
    """The causal DiT has the dense DiT's parameters: the JAX tree converts
    with jax_dit_params_to_torch and loads strictly (the fixture does), and
    the converted state dict is the dense DiT's."""
    jmodel, params, tmodel, _ = models
    dense = tdit.MiniTrainDIT(dataclasses.replace(tmodel.net.cfg, temporal_causal=False))
    sd = jax_dit_params_to_torch(params, tmodel.net.cfg)
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in dense.state_dict().items()}


def test_interactive_latency_entry_point_runs_on_cpu(capsys):
    from cosmos_predict2_tpu_torch.scripts import interactive_latency

    res = interactive_latency.main(["--tiny", "--device", "cpu", "--blocks", "2"])
    out = capsys.readouterr().out
    assert "[stream] RESULT latent 44x80 nb=1 cache=16 on cpu: p50 block latency" in out
    assert len(res["laps"]) == 2 and res["pixel_fps"] == 4 * res["latent_fps"] > 0
