"""Self-forcing DMD2 training (models/interactive.py::SelfForcingDMD2) held
against the JAX package on the CPU: the cache decode's gradient (K5 / K6
under autograd, ops/flash_attention.py::KvCacheAttention) against
``jax.vjp`` of JAX's ``flash_attention_kv_cache(_window)``; the rollout,
``generator_loss`` and ``critic_loss`` values and the student's and the
fake score's gradients against JAX's ``SelfForcingDMD2`` on
tests/test_interactive.py's setup (2 blocks of 2 steps, fake-score weights
x 1.05) with JAX's draws fed in; the commit under ``no_grad``; and the
guard of networks/dit.py::CachedAttention on the cache's prefix.

Tolerances: 2e-5 absolute on the cache decode's gradients, as
tests/test_torch_kv_cache.py holds the decode (fp32, another summation
order); 1e-4 relative on the losses and the fp32 DiT values, as
tests/test_torch_dit.py; 2e-4 absolute on the streamed (rolled-out)
latents, as tests/test_torch_interactive.py. Gradients are held to 1e-4
relative L2 per parameter and 2.5e-4 of each gradient's largest entry, as
tests/test_torch_training.py. The rollouts use fp32 caches on both sides
(the JAX rollout's caches are bf16 by default, which round P and turn the
two packages' 1e-7 logit differences into 1e-3 steps).
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from cosmos_predict2_tpu.conditioning.conditioner import make_condition as j_make_condition
from cosmos_predict2_tpu.models import interactive as jint
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.ops import flash_attention as jfa
from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models import interactive as tint
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.ops import flash_attention as tfa
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch
from torch_variants_util import jit_init, noisy_params

KV_ATOL = 2e-5
TOL = 1e-4
STREAM_ATOL = 2e-4
GRAD_REL_L2 = 1e-4
GRAD_MAX = 2.5e-4
SHAPE = (1, 16, 3, 8, 8)  # the JAX test's model shape: 3 latent frames of a 4 x 4 token grid
HW = (8, 8)
N_BLOCKS = 2


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# ------------------------- the cache decode's gradient -------------------------


def _decode_inputs(key, sq, s_max, heads=2, d=128):
    rng = _rng(*key)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(1, sq, heads, d), f(1, heads, s_max, d), f(1, heads, s_max, d), f(1, sq, heads, d)


@pytest.mark.parametrize("window", [None, ((4, 8), 3)], ids=["K5", "K6 window"])
@pytest.mark.parametrize("fill_frames", [2, 4])
def test_cache_decode_vjp_matches_jax(window, fill_frames):
    """dq, dk_buf and dv_buf of the decode (4 x 8-token frames, buffers of
    5 frames, whole-frame fills; with a 3-row window) against jax.vjp of
    JAX's custom-VJP cache attention (the Pallas forward interpreted, the
    masked reference's VJP)."""
    F = 32
    q, kb, vb, do = _decode_inputs(("vjp", window, fill_frames), F, 5 * F)
    fill = fill_frames * F
    if window is None:
        fn = lambda q_, k_, v_: jfa.flash_attention_kv_cache(q_, k_, v_, jnp.int32(fill))  # noqa: E731
    else:
        fn = lambda q_, k_, v_: jfa.flash_attention_kv_cache_window(q_, k_, v_, fill, *window)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want_out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, kb, vb)))
        want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, kb, vb))
    recomputes = tfa.kv_cache_vjp.recomputes
    out = tfa.KvCacheAttention.apply(qt, kt, vt, fill, window)
    out.backward(torch.from_numpy(do))
    assert tfa.kv_cache_vjp.recomputes == recomputes + 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=KV_ATOL)
    for name, got, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=KV_ATOL, err_msg=name)
    assert not kt.grad[:, :, fill:].any() and not vt.grad[:, :, fill:].any()


def test_cache_decode_backward_refuses_a_buffer_written_in_place():
    """The Function saves the buffers: a write between its forward and its
    backward is refused by autograd's version counter; the window variant
    keeps C2's guard (a fill that is not whole frames) in the backward."""
    q, kb, vb, do = _decode_inputs(("inplace",), 32, 160)
    qt, kt = torch.from_numpy(q).requires_grad_(), torch.from_numpy(kb)
    out = tfa.KvCacheAttention.apply(qt, kt, torch.from_numpy(vb), 64, None)
    kt[:, :, :1] = 0.0
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        out.backward(torch.from_numpy(do))
    with pytest.raises(ValueError, match="whole number"):
        tfa.kv_cache_vjp(qt.detach(), kt, torch.from_numpy(vb), 40, torch.from_numpy(do), ((4, 8), 3))


# ------------------------- the cached attention's guard -------------------------


def _cache(heads=2, s_max=96, d=128, fill=32, seed=0):
    rng = _rng("cache", seed)
    kb = torch.from_numpy(rng.standard_normal((1, heads, s_max, d)).astype(np.float32))
    vb = torch.from_numpy(rng.standard_normal((1, heads, s_max, d)).astype(np.float32))
    return {"k": kb, "v": vb, "len": fill}


def _block(seed, s=32, heads=2, d=128):
    rng = _rng("block", seed)
    return [torch.from_numpy(rng.standard_normal((1, s, heads, d)).astype(np.float32)).requires_grad_()
            for _ in range(3)]


def _reference_grads(cache, q, k, v, do):
    """The same attention with the prefix as a constant and k, v appended,
    by autograd through the plain version."""
    n = cache["len"]
    qd, kd, vd = (t.detach().clone().requires_grad_() for t in (q, k, v))
    kb = torch.cat([cache["k"][:, :, :n].clone(), kd.transpose(1, 2)], dim=2)
    vb = torch.cat([cache["v"][:, :, :n].clone(), vd.transpose(1, 2)], dim=2)
    out = tfa.kv_cache_plain(qd, kb, vb, kb.shape[2])
    out.backward(do)
    return out.detach(), (qd.grad, kd.grad, vd.grad)


def test_cached_attention_gradient_and_later_writes_at_the_fill():
    """Under autograd the cached attention's q, k, v gradients are those of
    attention over [prefix | k, v] with the prefix constant, after later
    writes at or above the fill (another denoise step's k/v, the commit,
    the next block); the buffers take none."""
    cache = _cache()
    q, k, v = _block(0)
    do = torch.from_numpy(_rng("do").standard_normal((1, 32, 2, 128)).astype(np.float32))
    want_out, want = _reference_grads(cache, q, k, v, do)
    out, new = tdit.cached_attention(q, k, v, cache, None)
    assert new["len"] == 64 and not new["k"].requires_grad
    with torch.no_grad():
        for seed in (1, 2):  # a second step and the commit rewrite [32, 64)
            tdit.cached_attention(*_block(seed), dict(cache), None)
        tdit.cached_attention(*_block(3), new, None)  # the next block writes [64, 96)
    out.backward(do)
    torch.testing.assert_close(out.detach(), want_out, rtol=0, atol=1e-6)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["window slide", "write below the fill", "foreign write"])
def test_cached_attention_backward_raises_when_the_prefix_changed(bad):
    """A window slide, a cached forward from a lower fill, or a write the
    cache did not log, between the forward and the backward: the prefix a
    graph reads may have changed, so the backward raises instead of giving
    a silently wrong gradient."""
    cache = _cache()
    q, k, v = _block(0)
    out, new = tdit.cached_attention(q, k, v, cache, None)
    with torch.no_grad():
        if bad == "window slide":
            tint.shift_cache_window(new, 32)
        elif bad == "write below the fill":
            tdit.cached_attention(*_block(1), dict(cache, len=0), None)
        else:
            cache["v"][:, :, 40:41] = 0.0
    match = "outside the cache's own writes" if bad == "foreign write" else "below the fill"
    with pytest.raises(RuntimeError, match=match):
        out.sum().backward()


# ------------------------------ SelfForcingDMD2 ------------------------------


class JModelF32(jint.CausalVideo2WorldModel):
    """JAX's causal model with fp32 KV caches (see the module docstring)."""

    def init_kv_caches(self, batch, max_latent_frames, latent_h, latent_w, dtype=jnp.float32):
        return super().init_kv_caches(batch, max_latent_frames, latent_h, latent_w, dtype=dtype)


class TModelF32(tint.CausalVideo2WorldModel):
    """The port's causal model with fp32 KV caches."""

    def init_kv_caches(self, batch, max_latent_frames, latent_h, latent_w, device, dtype=torch.float32):
        return super().init_kv_caches(batch, max_latent_frames, latent_h, latent_w, device, dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    """tests/test_interactive.py's causal model (test preset, fp32, one-frame
    blocks) on seeded noisy weights, the fake score's weights x 1.05, its
    2-step streaming config, and the port's student, teacher and fake-score
    nets on the same weights; JAX's draws for PRNGKey(0)."""
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
    jmodel = JModelF32(jint.causal_model_config(jnet, num_frame_per_block=1, state_t=SHAPE[2]))
    params = jax.tree.map(jnp.asarray, noisy_params(jit_init(jmodel.init_params, jax.random.PRNGKey(0), SHAPE, 8)))
    fake_params = jax.tree.map(lambda x: x * 1.05, params)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 8, 1024)) * 0.05)
    scfg = dict(num_frame_per_block=1, cache_frame_size=8, num_steps=2)
    jsf = jint.SelfForcingDMD2(jint.StreamingInference(jint.StreamingConfig(**scfg), jmodel))

    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype", "remat"}
    jcfg = jmodel.config.net  # the causal net
    tcfg = tdit.DiTConfig(dtype=torch.float32, remat="none", **{n: getattr(jcfg, n) for n in names})

    def net(p, trainable):
        m = tdit.MiniTrainDIT(tcfg)
        m.load_state_dict(jax_dit_params_to_torch(jax.tree.map(np.asarray, p), tcfg), strict=True)
        return m.requires_grad_(trainable)

    student, teacher, fake = net(params, True), net(params, False), net(fake_params, True)
    tmodel = TModelF32(tint.causal_model_config(tcfg, num_frame_per_block=1, state_t=SHAPE[2]), student)
    assert tmodel.config.net == tcfg and tcfg.temporal_causal
    tsf = tint.SelfForcingDMD2(tint.StreamingInference(tint.StreamingConfig(**scfg), tmodel))

    rng = jax.random.PRNGKey(0)
    rng_roll, rng_t, rng_d = jax.random.split(rng, 3)
    noise = np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(rng_roll, i), (1, 16, 1) + HW))
                            for i in range(N_BLOCKS)], axis=2)
    draws = tint.SelfForcingDraws(
        noise=torch.from_numpy(noise),
        time_D=torch.from_numpy(np.array(jsf.dm.draw_training_time_D(rng_t, 1))),
        D_eps=torch.from_numpy(np.asarray(jax.random.normal(rng_d, (1, 16, N_BLOCKS) + HW, dtype=jnp.float32))),
    )
    return dict(jsf=jsf, params=params, fake_params=fake_params, jcond=j_make_condition(jnp.asarray(emb)), rng=rng,
                tsf=tsf, student=student, teacher=teacher, fake=fake, cond=make_condition(torch.from_numpy(emb)),
                draws=draws, tcfg=tcfg)


def _assert_grads(net, jgrads, cfg):
    want = jax_dit_params_to_torch(jax.tree.map(np.asarray, jgrads), cfg)
    got = dict(net.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= GRAD_MAX * scale, (name, float((g - w).abs().max()), scale)
        assert float((g - w).norm()) <= GRAD_REL_L2 * max(float(w.norm()), 1e-12), name


def test_rollout_matches_jax(setup):
    """The student's 2-block rollout, each block's noise JAX's
    fold_in(rng_roll, block)."""
    s = setup
    want = s["jsf"].rollout(s["params"], jax.random.split(s["rng"], 3)[0], s["jcond"], N_BLOCKS, HW)
    with torch.no_grad():
        got = s["tsf"].rollout(s["cond"], N_BLOCKS, HW, s["draws"].noise)
    assert got.shape == (1, 16, N_BLOCKS) + HW
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STREAM_ATOL)


def test_generator_loss_and_student_gradients_match_jax(setup):
    """generator_loss and jax.grad of it over the student; the teacher and
    the fake score take no gradient; each block's denoise steps recompute
    the cached attention once per block and step in the backward."""
    s = setup
    jsf = s["jsf"]

    def gloss(p):
        return jsf.generator_loss(p, s["params"], s["fake_params"], s["rng"], s["jcond"], None,
                                  n_blocks=N_BLOCKS, latent_hw=HW)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(gloss))(s["params"])
    for net in (s["student"], s["teacher"], s["fake"]):
        net.zero_grad(set_to_none=True)
    recomputes = tfa.kv_cache_vjp.recomputes
    loss, metrics = s["tsf"].generator_loss(s["teacher"], s["fake"], s["cond"], None, N_BLOCKS, HW, s["draws"])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    assert float(metrics["self_forcing_dmd_loss"]) == float(loss.detach())
    blocks = len(s["student"].blocks)
    assert tfa.kv_cache_vjp.recomputes - recomputes == N_BLOCKS * 2 * blocks
    _assert_grads(s["student"], jgrads, s["tcfg"])
    assert all(p.grad is None for net in (s["teacher"], s["fake"]) for p in net.parameters())
    s["student"].zero_grad(set_to_none=True)


def test_critic_loss_and_fake_score_gradients_match_jax(setup):
    """critic_loss and jax.grad of it over the fake score; the rollout
    carries no gradient."""
    s = setup
    jsf = s["jsf"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsf.critic_loss(s["params"], p, s["rng"], s["jcond"], n_blocks=N_BLOCKS, latent_hw=HW)[0]
    ))(s["fake_params"])
    for net in (s["student"], s["teacher"], s["fake"]):
        net.zero_grad(set_to_none=True)
    recomputes = tfa.kv_cache_vjp.recomputes
    loss, _ = s["tsf"].critic_loss(s["fake"], s["cond"], N_BLOCKS, HW, s["draws"])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    assert tfa.kv_cache_vjp.recomputes == recomputes
    _assert_grads(s["fake"], jgrads, s["tcfg"])
    assert all(p.grad is None for net in (s["student"], s["teacher"]) for p in net.parameters())
    s["fake"].zero_grad(set_to_none=True)


def test_commit_under_no_grad_gives_the_gradients_of_a_commit_with_grad(setup, monkeypatch):
    """JAX differentiates through each block's commit, whose caches it then
    stop_gradients; the port commits under no_grad. A commit recorded under
    grad gives the same loss and the same student gradients, bit for bit."""
    s = setup
    stream = s["tsf"].streaming

    def run():
        s["student"].zero_grad(set_to_none=True)
        loss, _ = s["tsf"].generator_loss(s["teacher"], s["fake"], s["cond"], None, N_BLOCKS, HW, s["draws"])
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in s["student"].named_parameters()}

    loss0, grads0 = run()

    def prefill_with_grad(latents, condition, kv_caches, t_start=0):
        ts = torch.zeros(latents.shape[:1] + latents.shape[2:3])
        out, caches = stream.model.forward_with_cache(latents, ts, condition, kv_caches, t_start)
        assert out.requires_grad
        return caches

    monkeypatch.setattr(stream, "prefill", prefill_with_grad)
    loss1, grads1 = run()
    assert loss1 == loss0
    assert all(torch.equal(grads1[n], g) for n, g in grads0.items())
    s["student"].zero_grad(set_to_none=True)


def test_rollout_under_block_remat_gives_the_same_gradients(setup):
    """The cached forward under autograd with block remat (the 2B
    experiments' setting, which chip_smoke.py's full-width rollout runs):
    each block is recomputed in the backward, writing its k/v into the
    cache again; the loss and the student's gradients equal those kept
    whole (remat "none"), bit for bit."""
    s = setup
    cfg = dataclasses.replace(s["tcfg"], remat="block")
    student = tdit.MiniTrainDIT(cfg)
    student.load_state_dict(s["student"].state_dict())
    model = TModelF32(tint.causal_model_config(cfg, num_frame_per_block=1, state_t=SHAPE[2]), student)
    sf = tint.SelfForcingDMD2(tint.StreamingInference(s["tsf"].streaming.config, model))
    launches = []
    for net, run in ((s["student"], s["tsf"]), (student, sf)):
        net.zero_grad(set_to_none=True)
        recomputes = tfa.kv_cache_vjp.recomputes
        loss, _ = run.generator_loss(s["teacher"], s["fake"], s["cond"], None, N_BLOCKS, HW, s["draws"])
        loss.backward()
        launches.append((float(loss.detach()), tfa.kv_cache_vjp.recomputes - recomputes))
    assert launches[0] == launches[1]
    got = dict(student.named_parameters())
    assert all(torch.equal(got[n].grad, p.grad) for n, p in s["student"].named_parameters())
    s["student"].zero_grad(set_to_none=True)


def test_generator_loss_with_teacher_guidance_matches_jax(setup):
    """The teacher-CFG branch of generator_loss (teacher_guidance 2 against
    a zero-text uncondition) against JAX's, value only."""
    from cosmos_predict2_tpu.models.distillation import DistillationConfig as JDistillationConfig
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig

    s = setup
    scfg = dict(num_frame_per_block=1, cache_frame_size=8, num_steps=2)
    jstream = s["jsf"].streaming
    jsf = jint.SelfForcingDMD2(jint.StreamingInference(
        jint.StreamingConfig(distill=JDistillationConfig(teacher_guidance=2.0), **scfg), jstream.model))
    juncond = j_make_condition(jnp.zeros_like(s["jcond"].crossattn_emb))
    want, _ = jsf.generator_loss(s["params"], s["params"], s["fake_params"], s["rng"], s["jcond"], juncond,
                                 n_blocks=N_BLOCKS, latent_hw=HW)
    tsf = tint.SelfForcingDMD2(tint.StreamingInference(
        tint.StreamingConfig(distill=DistillationConfig(teacher_guidance=2.0), **scfg), s["tsf"].streaming.model))
    with torch.no_grad():
        got, _ = tsf.generator_loss(s["teacher"], s["fake"], s["cond"], make_condition(torch.zeros_like(
            s["cond"].crossattn_emb)), N_BLOCKS, HW, s["draws"])
        unguided, _ = s["tsf"].generator_loss(s["teacher"], s["fake"], s["cond"], None, N_BLOCKS, HW, s["draws"])
    assert float(got) == pytest.approx(float(want), rel=TOL)
    assert abs(float(got) / float(unguided) - 1) > 1e-3
