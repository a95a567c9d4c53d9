"""The port's DMD2 distillation (models/distillation.py), the DiT's feature
taps and the discriminator head held against the JAX package (CPU, fp32).

Same seeded weights (three perturbed parameter trees of the 2-block test
DiT, 3 heads of 128) and inputs on both sides; the random draws of a
training step are JAX's (``jax.random`` under the step key's splits),
handed to the port as ``DistillDraws``.

Tolerances, with their reasons: the scalings are computed in fp64 and
rounded to fp32 (bit-equal to NumPy's fp64; JAX without x64 computes in
fp32, within 2 fp32 ulps). Every net call takes c_noise * 1000 as its
timestep, so those ulps (~2.4e-4 of a timestep) reach the sinusoidal
embedding. Measured: one denoise agrees to <= 1.1e-5 relative L2 (x0 and
F; checked at 1e-4), the 4-step generate to 1.4e-5 (checked at 2e-4), a
training step's loss to <= 2.6e-6 relative (checked at 5e-5), and every
parameter's gradient to <= 8.6e-5 relative L2 and <= 1.2e-4 of the
gradient's largest entry (checked at 5e-4 and 1e-3: fp32 sums in another
order on top of the timestep ulps, through up to 4 sampler steps). The
head and the GAN losses agree to fp32 rounding (1e-5).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.models import distillation as jd
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.networks import discriminator as jdisc
from cosmos_predict2_tpu.networks.dit import PRESETS, MiniTrainDIT as JDiT
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.models import distillation as td
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks import discriminator as tdisc
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_discriminator_params_to_torch

SHAPE = (2, 16, 2, 8, 8)
TEXT = (2, 8, 1024)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def configs(scaling: str = "rectified_flow"):
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="block")
    names = {f.name for f in dataclasses.fields(DiTConfig)} - {"dtype"}
    tnet = DiTConfig(dtype=torch.float32, **{n: getattr(jnet, n) for n in names})
    jcfg = jd.DistillationConfig(model=JRFConfig(net=jnet, state_t=SHAPE[2]), scaling=scaling)
    tcfg = td.DistillationConfig(model=RFModelConfig(net=tnet, state_t=SHAPE[2]), scaling=scaling)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    """JAX's DistillationModel with student, teacher and fake-score trees
    (PRNGKey 0, 1, 2, every leaf perturbed so AdaLN's zero init does not
    hide a path), the port's nets on the same weights, and one video
    condition with one conditional frame for both."""
    jcfg, tcfg = configs()
    jdm = jd.DistillationModel(jcfg)
    rng = np.random.default_rng(0)
    trees = []
    for seed in range(3):
        params = jdm.base.init_params(jax.random.PRNGKey(seed), SHAPE, text_len=TEXT[1])
        leaves, tdef = jax.tree.flatten(params)
        trees.append(jax.tree.unflatten(tdef, [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
                                               for l in leaves]))
    nets = []
    for params in trees:
        net = MiniTrainDIT(tcfg.model.net)
        net.load_state_dict(jax_dit_params_to_torch(params, tcfg.model.net), strict=True)
        nets.append(net)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    emb = (rng.standard_normal(TEXT) * 0.05).astype(np.float32)
    jc = jcond.make_condition(jnp.asarray(emb)).replace(gt_frames=jnp.asarray(x0)).set_video_condition(jnp.asarray(x0), 1)
    tc = tcond.make_condition(t(emb)).replace(gt_frames=t(x0)).set_video_condition(t(x0), 1)
    jtrees = [jax.tree.map(jnp.asarray, p) for p in trees]
    return jdm, jtrees, td.DistillationModel(tcfg), nets, x0, jc, tc


# --------------------------------- scalings ---------------------------------


def test_edm_scalings_and_critic_times_match_jax():
    t32 = np.asarray([0.05, 0.3, 0.5, 1.0, math.atan(15.0)], np.float32)
    t64 = t32.astype(np.float64)
    exact = (np.cos(t64), np.sin(t64), np.ones_like(t64), 0.25 * np.log(np.tan(t64)))
    got = td.trigflow_scalings_edm(t(t32), 1.0)
    for g, e, j in zip(got, exact, jd.trigflow_scalings_edm(jnp.asarray(t32), 1.0)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), e.astype(np.float32))  # fp64, then rounded to fp32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2.5e-7, atol=3e-8)  # JAX: fp32
    jdm = jd.DistillationModel(jd.DistillationConfig())
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (6,), dtype=jnp.float32))
    want = np.asarray(jdm.draw_training_time_D(key, 6))
    got = td.DistillationModel(td.DistillationConfig()).training_time_D(t(u))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert [td.DistillationModel(td.DistillationConfig()).is_student_phase(i) for i in range(10)] == \
        [jdm.is_student_phase(i) for i in range(10)] == [False] * 4 + [True] + [False] * 4 + [True]


# --------------------------------- sampler ---------------------------------


@pytest.mark.parametrize("scaling", ["rectified_flow", "edm"])
def test_denoise_edm_matches_jax(setup, scaling):
    """x0 and F of one denoise with a conditional frame, per-sample times."""
    _, jtrees, _, nets, x0, jc, tc = setup
    jcfg, tcfg = configs(scaling)
    xt = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    times = np.asarray([0.4, 1.2], np.float32)
    jx0, jF = jd.DistillationModel(jcfg).denoise_edm(jtrees[0], jnp.asarray(xt), jnp.asarray(times), jc, return_F=True)
    with torch.no_grad():
        tx0, tF = td.DistillationModel(tcfg).denoise_edm(nets[0], t(xt), t(times), tc, return_F=True)
    assert rel(tx0, jx0) <= 1e-4 and rel(tF[:, :, 1:], np.asarray(jF)[:, :, 1:]) <= 1e-4
    np.testing.assert_array_equal(tx0[:, :, 0].numpy(), x0[:, :, 0])  # the conditional frame is the clean latent


def test_generate_matches_jax(setup):
    """The 4-step sampler with JAX's noise, one conditional frame."""
    jdm, jtrees, tdm, nets, x0, jc, tc = setup
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5), SHAPE))
    want = jdm.generate(jtrees[0], jnp.asarray(noise), jc, num_steps=4)
    got = tdm.generate(nets[0], t(noise), tc, num_steps=4)
    assert got.shape == SHAPE and torch.isfinite(got).all()
    assert rel(got, want) <= 2e-4
    np.testing.assert_allclose(got[:, :, 0].numpy(), x0[:, :, 0], atol=1e-6)


# --------------------------------- training ---------------------------------


def jax_draws(jdm, key, shape) -> td.DistillDraws:
    """The draws of JAX's training steps under ``key`` (its 3-way split)."""
    rng_t, rng_g, rng_d = jax.random.split(key, 3)
    return td.DistillDraws(
        time_D=t(jdm.draw_training_time_D(rng_t, shape[0])),
        G_eps=t(jax.random.normal(rng_g, shape, dtype=jnp.float32)),
        D_eps=t(jax.random.normal(rng_d, shape, dtype=jnp.float32)),
    )


def _grads_match(net, jgrads, cfg):
    want = jax_dit_params_to_torch(jax.tree.map(np.asarray, jgrads), cfg)
    got = dict(net.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g - w).abs().max()) <= 1e-3 * scale, (name, float((g - w).abs().max()), scale)
        assert float((g - w).norm()) <= 5e-4 * max(float(w.norm()), 1e-12), name


@pytest.mark.parametrize("n_steps", [1, 3])
def test_generator_step_loss_and_grads_match_jax(setup, n_steps):
    """The student's DMD loss and every student gradient against jax.grad,
    with JAX's draws; the teacher and the critic get no gradient."""
    jdm, (js, jt, jf), tdm, (student, teacher, fake), x0, jc, tc = setup
    key = jax.random.PRNGKey(11 + n_steps)
    ju = jcond.get_condition_uncondition(jc)[1]
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdm.training_step_generator(p, jt, jf, key, jnp.asarray(x0), jc, ju, n_steps), has_aux=True)(js)
    for net in (student, teacher, fake):
        net.zero_grad(set_to_none=True)
        net.requires_grad_(net is student)
    tu = tcond.get_condition_uncondition(tc)[1]
    loss, metrics = tdm.training_step_generator(student, teacher, fake, t(x0), tc, tu, n_steps,
                                                jax_draws(jdm, key, SHAPE))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=5e-5)
    assert set(metrics) == {"dmd_loss_generator", "grad_norm_dmd"}
    _grads_match(student, jgrads, student.cfg)
    assert all(p.grad is None for net in (teacher, fake) for p in net.parameters())
    student.zero_grad(set_to_none=True)


@pytest.mark.parametrize("n_steps", [2, 4])
def test_critic_step_loss_and_grads_match_jax(setup, n_steps):
    """The fake-score loss and every fake-score gradient against jax.grad,
    with JAX's draws; the student gets no gradient."""
    jdm, (js, _, jf), tdm, (student, _, fake), x0, jc, tc = setup
    key = jax.random.PRNGKey(21 + n_steps)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdm.training_step_critic(js, p, key, jnp.asarray(x0), jc, n_steps), has_aux=True)(jf)
    for net in (student, fake):
        net.zero_grad(set_to_none=True)
        net.requires_grad_(True)
    loss, metrics = tdm.training_step_critic(student, fake, t(x0), tc, n_steps, jax_draws(jdm, key, SHAPE))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=5e-5)
    assert set(metrics) == {"dmd_loss_critic"}
    _grads_match(fake, jgrads, fake.cfg)
    assert all(p.grad is None for p in student.parameters())
    for net in (student, fake):
        net.zero_grad(set_to_none=True)
        net.requires_grad_(False)


# ------------------------------ features and head ------------------------------


def test_dit_intermediate_features_match_jax(setup):
    """The DiT's feature taps: (output, [block outputs as (B, L, D)])."""
    jdm, jtrees, _, nets, _, _, _ = setup
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    ts = np.asarray([[100.0], [700.0]], np.float32)
    emb = (rng.standard_normal(TEXT) * 0.05).astype(np.float32)
    jout, jfeats = JDiT(jdm.config.model.net).apply(jtrees[0], jnp.asarray(x), jnp.asarray(ts), jnp.asarray(emb),
                                                    intermediate_feature_ids=(0, 1))
    with torch.no_grad():
        out, feats = nets[0](t(x), t(ts), t(emb), intermediate_feature_ids=(0, 1))
        plain = nets[0](t(x), t(ts), t(emb))
    assert torch.equal(out, plain)
    assert len(feats) == len(jfeats) == 2
    for f, jf_ in zip(feats, jfeats):
        assert f.shape == jf_.shape == (2, 2 * 4 * 4, 384)
        assert rel(f, jf_) <= 1e-5
    assert rel(out, jout) <= 1e-5


def test_discriminator_head_and_gan_losses_match_jax():
    rng = np.random.default_rng(9)
    feats = [rng.standard_normal((2, 12, 64)).astype(np.float32) for _ in range(3)]
    jhead = jdisc.DiscriminatorHead(hidden_dim=32)
    params = jhead.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    head = tdisc.DiscriminatorHead(feature_dim=64, num_features=3, hidden_dim=32)
    head.load_state_dict(jax_discriminator_params_to_torch(jax.tree.map(np.asarray, params)), strict=True)
    assert {n for n, _ in head.named_parameters()} == {
        f"{m}.{p}" for m in ("proj_0", "proj_1", "proj_2", "mix", "logit") for p in ("weight", "bias")}
    want = np.asarray(jhead.apply(params, [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = head([t(f) for f in feats])
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    real = np.asarray([[-30.0], [0.3], [40.0]], np.float32)
    fake = np.asarray([[2.0], [-0.7], [-50.0]], np.float32)
    np.testing.assert_allclose(tdisc.bce_with_logits(t(real), 1.0).numpy(), np.asarray(jdisc.bce_with_logits(real, 1.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tdisc.generator_gan_loss(t(fake))), float(jdisc.generator_gan_loss(fake)), rtol=1e-6)
    np.testing.assert_allclose(float(tdisc.discriminator_gan_loss(t(real), t(fake))),
                               float(jdisc.discriminator_gan_loss(real, fake)), rtol=1e-6)
    with pytest.raises(ValueError):
        head([t(f) for f in feats[:2]])
