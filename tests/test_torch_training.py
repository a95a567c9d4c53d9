"""The port's training slice held against the JAX package (CPU, fp32).

Same seeded numpy inputs and the same random draws on both sides: the JAX
draws (``jax.random``) are computed here and handed to the port as
``TrainDraws``, since torch's generators give other numbers.

Tolerances: the schedule tables are computed by the same float64 NumPy code
and must be bit-equal; the LR schedule agrees to 1e-6 relative and the EMA
decay to 1e-5 (the port computes them in float64, JAX in float32, whose
rounding of 1 - 1/(i+1) is raised to the power gamma + 1 ~ 7). One
training step of a 2-block DiT in fp32 agrees to <= 1.6e-6 relative on the
loss (checked at 1e-4) and, for every parameter, to <= 3.3e-5 relative L2
and <= 5.5e-5 of the gradient's largest entry (measured; fp32 sums over all
tokens taken in another order), checked at 1e-4 and 2.5e-4. The trainer
reproduces the JAX trainer's pinned golden losses at their own rel 1e-4.
Checkpoint resume is bit-exact.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_cpu_threads  # torch's CPU threads under xdist
from test_training import GOLDEN_LOSSES

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.data.mock import MockDataConfig as JMockDataConfig
from cosmos_predict2_tpu.data.mock import MockDataLoader as JMockDataLoader
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.schedulers.rectified_flow import RectifiedFlow as JRectifiedFlow
from cosmos_predict2_tpu.schedulers.rectified_flow import RectifiedFlowConfig as JRFlowConfig
from cosmos_predict2_tpu.training import ema as jema
from cosmos_predict2_tpu.training import optim as joptim
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.data.mock import MockDataConfig, MockDataLoader, normalize_video
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, TrainDraws, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT, build_dit
from cosmos_predict2_tpu_torch.schedulers.rectified_flow import RectifiedFlow, RectifiedFlowConfig
from cosmos_predict2_tpu_torch.training import ema as tema
from cosmos_predict2_tpu_torch.training import optim as toptim
from cosmos_predict2_tpu_torch.training.checkpointing import (
    Checkpointer,
    load_consolidated,
    load_ema_to_reg,
    save_consolidated,
)
from cosmos_predict2_tpu_torch.training.trainer import Callback, Trainer, TrainerConfig
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch
from torch_variants_util import jit_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT = (1, 16, 2, 4, 4)
TRAIN_OPT = dict(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------ schedules ------------------------------


@pytest.mark.parametrize("shift,dist", [(5.0, "logitnormal"), (3.0, "uniform"), (1.0, "uniform")])
def test_rectified_flow_matches_jax(shift, dist):
    j = JRectifiedFlow(JRFlowConfig(shift=shift, train_time_distribution=dist))
    p = RectifiedFlow(RectifiedFlowConfig(shift=shift, train_time_distribution=dist))
    np.testing.assert_array_equal(p.sigmas.numpy(), np.asarray(j.sigmas))
    np.testing.assert_array_equal(p.timesteps.numpy(), np.asarray(j.timesteps))
    u = np.asarray([0.0, 0.0004, 0.31, 0.5, 0.999, 0.99999], np.float32)
    for a, b in zip(p.discretize(t(u)), j.discretize(jnp.asarray(u))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(0)
    x0, x1 = rng.standard_normal((2, 2, 3, 4, 4)).astype(np.float32)
    sig = np.asarray([0.2, 0.9], np.float32)
    for a, b in zip(p.get_interpolation(t(x0), t(x1), t(sig)), j.get_interpolation(x0, x1, jnp.asarray(sig))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(p.high_sigma_candidates(980, 1000), np.nonzero(
        (np.asarray(j.timesteps) >= 980) & (np.asarray(j.timesteps) <= 1000))[0])
    u = p.sample_train_time(torch.Generator().manual_seed(0), 4096)
    assert u.shape == (4096,) and 0 <= float(u.min()) and float(u.max()) < 1


@pytest.mark.parametrize("cycles", [((10,), (1e-6,), (0.5,), (0.2,), (100,)),
                                    ((2, 5), (1e-6, 0.1), (0.5, 1.0), (0.2, 0.3), (10, 20))])
def test_lambda_linear_schedule_matches_jax(cycles):
    j, p = joptim.lambda_linear_schedule(*cycles), toptim.lambda_linear_schedule(*cycles)
    for step in [0, 1, 2, 5, 9, 10, 11, 29, 30, 31, 55, 100, 150]:
        assert p(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12), step


def test_power_ema_beta_matches_jax():
    for s in (0.1, 0.05):
        assert tema.power_ema_gamma(s) == jema.power_ema_gamma(s)
        for i in (0, 1, 2, 10, 1000):
            assert tema.power_ema_beta(i, s=s) == pytest.approx(float(jema.power_ema_beta(i, s=s)), rel=1e-5, abs=0)
    ema, new = [torch.ones(3)], [torch.zeros(3)]
    tema.ema_update(ema, new, 0.9)
    np.testing.assert_allclose(ema[0].numpy(), 0.9, rtol=1e-7)
    tema.ema_update(ema, [torch.full((3,), 5.0)], 0.0)  # beta 0: the EMA becomes the parameters exactly
    np.testing.assert_array_equal(ema[0].numpy(), 5.0)


@pytest.mark.parametrize("clip", [1.0, 1e3, None])
def test_optimizer_steps_match_optax(clip):
    """AdamW + LambdaLinear + clip_by_global_norm, 4 steps on a toy problem;
    clip 1.0 clips every step, 1e3 none."""
    cfg = dict(lr=0.01, weight_decay=0.1, warm_up_steps=(2,), f_start=(0.1,), f_max=(1.0,), f_min=(0.5,),
               cycle_lengths=(10,), grad_clip_norm=clip)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: 3 * rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(4)]
    jopt = joptim.make_optimizer(joptim.OptimizerConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    topt, sched = toptim.make_optimizer(toptim.OptimizerConfig(**cfg), tp.values())
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k])
        norm = toptim.global_norm([p.grad for p in tp.values()])
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        if clip is not None:
            toptim.clip_by_global_norm_([p.grad for p in tp.values()], norm, clip)
        topt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


# ------------------------------ data and conditioning ------------------------------


def test_mock_data_is_the_jax_mock_data():
    cfg = dict(batch_size=2, num_frames=5, height=16, width=24, text_len=8, text_dim=32, seed=3)
    a, b = MockDataLoader(MockDataConfig(**cfg)).get_batch(4), JMockDataLoader(JMockDataConfig(**cfg)).get_batch(4)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(normalize_video(a["video"]), normalize_video(b["video"]))


def test_per_sample_condition_and_train_dropout_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((3, 16, 4, 2, 2)).astype(np.float32)
    emb = rng.standard_normal((3, 5, 8)).astype(np.float32)
    k = np.asarray([0, 2, 3])
    keep, use = np.asarray([True, False, True]), np.asarray(False)
    j = jcond.make_condition(jnp.asarray(emb)).set_video_condition(jnp.asarray(gt), jnp.asarray(k))
    j = j.replace(crossattn_emb=j.crossattn_emb * jnp.asarray(keep)[:, None, None], use_video_condition=jnp.asarray(use))
    p = tcond.apply_train_dropout(tcond.make_condition(t(emb)).set_video_condition(t(gt), t(k)), t(keep), t(use))
    np.testing.assert_array_equal(p.condition_video_mask.numpy(), np.asarray(j.condition_video_mask))
    np.testing.assert_array_equal(p.crossattn_emb.numpy(), np.asarray(j.crossattn_emb))
    assert bool(p.use_video_condition) is False


# ------------------------------ one training step ------------------------------


def nets(remat: str):
    """PRESETS["test"] in fp32 for JAX, and the port's DiTConfig with its fields."""
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat=remat)
    names = {f.name for f in dataclasses.fields(DiTConfig)} - {"dtype"}
    return jnet, DiTConfig(dtype=torch.float32, **{n: getattr(jnet, n) for n in names})


def jax_draws(jmodel: JModel, seed: int, iteration: int, shape: tuple) -> tuple[TrainDraws, jax.Array]:
    """The JAX trainer's draws at this iteration (trainer.py:199-201 and
    training_step's splits) as the port's TrainDraws; also JAX's step key."""
    cfg = jmodel.config
    B = shape[0]
    rng_drop, rng_step = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), iteration))
    rng_text, rng_flag = jax.random.split(rng_drop)
    rng_eps, rng_t, rng_k, rng_hs = jax.random.split(rng_step, 4)
    draws = dict(
        text_keep=t(jax.random.bernoulli(rng_text, 1.0 - cfg.text_dropout_rate, (B,))),
        use_video=t(jax.random.bernoulli(rng_flag, 1.0 - cfg.video_cond_dropout_rate, ())),
        num_conditional_frames=t(jmodel.sample_num_conditional_frames(rng_k, B)).long(),
        eps=t(jax.random.normal(rng_eps, shape, dtype=jnp.float32)),
        u=t(jmodel.rectified_flow.sample_train_time(rng_t, B)),
    )
    if cfg.use_high_sigma_strategy:
        rng_mask, rng_pick = jax.random.split(rng_hs)
        ts = np.asarray(jmodel.rectified_flow.timesteps)
        cand = np.nonzero((ts >= cfg.high_sigma_timesteps_min) & (ts <= cfg.high_sigma_timesteps_max))[0]
        draws["high_sigma"] = t(jax.random.uniform(rng_mask, (B,)) < cfg.high_sigma_ratio)
        draws["high_sigma_index"] = t(cand[np.asarray(jax.random.randint(rng_pick, (B,), 0, cand.size))]).long()
    return TrainDraws(**draws), rng_step


# iterations whose JAX draws drop one text, mix per-sample k and (second
# case) pick high sigmas for both samples with the video flag dropped
def _training_step_matches_jax(jnet, tnet, over: dict, shape: tuple, iteration: int) -> None:
    """Loss and every parameter's gradient of one training step against
    jax.grad of JAX's training_step, on the same (perturbed) weights, inputs
    and draws."""
    jmodel = JModel(JRFConfig(net=jnet, **over))
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(shape).astype(np.float32)
    emb = rng.standard_normal((shape[0], 8, 1024)).astype(np.float32) * 0.1
    params = jit_init(jmodel.init_params, jax.random.PRNGKey(0), shape, text_len=8)
    leaves, tdef = jax.tree.flatten(params)
    params = jax.tree.unflatten(tdef, [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
                                       for l in leaves])  # AdaLN is zero at init: perturb so every path counts
    draws, rng_step = jax_draws(jmodel, seed=0, iteration=iteration, shape=shape)

    jc = jcond.make_condition(jnp.asarray(emb)).replace(gt_frames=jnp.asarray(x0))
    jc = jc.replace(crossattn_emb=jc.crossattn_emb * jnp.asarray(draws.text_keep.numpy())[:, None, None],
                    use_video_condition=jnp.asarray(draws.use_video.numpy()))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.training_step(p, rng_step, jnp.asarray(x0), jc), has_aux=True)(jax.tree.map(jnp.asarray, params))

    net = MiniTrainDIT(tnet)
    net.load_state_dict(jax_dit_params_to_torch(params, tnet), strict=True)
    model = Video2WorldModel(RFModelConfig(net=tnet, **over), net)
    tc = tcond.apply_train_dropout(tcond.make_condition(t(emb)).replace(gt_frames=t(x0)), draws.text_keep, draws.use_video)
    loss, metrics = model.training_step(t(x0), tc, draws)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4)
    assert metrics["per_instance_loss"].shape == (shape[0],)
    want = jax_dit_params_to_torch(jax.tree.map(np.asarray, jgrads), tnet)
    got = dict(net.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g - w).abs().max()) <= 2.5e-4 * scale, (name, float((g - w).abs().max()), scale)
        assert float((g - w).norm()) <= 1e-4 * max(float(w.norm()), 1e-12), name


# iterations whose JAX draws drop one text, mix per-sample k and (second
# case) pick high sigmas for both samples with the video flag dropped
@pytest.mark.parametrize("remat,high_sigma,iteration", [("block", False, 3), ("none", True, 34)])
def test_training_step_loss_and_grads_match_jax(remat, high_sigma, iteration):
    """Loss and every parameter's gradient of one training step, batch 2,
    with conditioning dropout, per-sample conditional frames and (second
    case) the high-sigma strategy, against jax.grad of JAX's training_step."""
    jnet, tnet = nets(remat)
    over = dict(state_t=2, use_high_sigma_strategy=high_sigma, high_sigma_ratio=0.5)
    _training_step_matches_jax(jnet, tnet, over, (2,) + LATENT[1:], iteration)


def test_sparse_training_step_loss_and_grads_match_jax():
    """The same with one dense and one sparse block (head_dim 128, block
    remat): the sparse block's window and stride scaled from a 16 x 24 grid
    to the latent's 8 x 12 tokens. The port's gradient goes through the
    NeighborhoodAttention Function (plain versions of K10, K11, K12), JAX's
    through autodiff of its CPU route."""
    sparse = dict(n_dense_blocks=1, natten_window=(-1, 6, 10), natten_stride=(1, 2, 4), natten_base_size=(-1, 16, 24))
    jnet, tnet = (dataclasses.replace(n, **sparse) for n in nets("block"))
    _training_step_matches_jax(jnet, tnet, dict(state_t=3), (1, 16, 3, 16, 24), iteration=3)


# ------------------------------ the trainer ------------------------------


def _batches(n, seed=0, device="cpu"):
    """tests/test_training.py's batches: mock text, random latents."""
    loader = MockDataLoader(MockDataConfig(batch_size=1, num_frames=2, height=16, width=16, seed=seed))
    for i in range(n):
        batch = loader.get_batch(i)
        latents = t(np.random.RandomState(i).randn(*LATENT).astype(np.float32)).to(device)
        emb = t(batch["t5_text_embeddings"][:, :8] * np.float32(0.02)).to(device)
        yield latents, tcond.make_condition(emb).replace(gt_frames=latents)


def _trainer(jparams=None, draw_fn=None, seed=0, **tk):
    _, tnet = nets("none")
    if jparams is None:
        net = build_dit(tnet, "cpu", seed=seed, trainable=True)
    else:
        net = MiniTrainDIT(tnet)
        net.load_state_dict(jax_dit_params_to_torch(jparams, tnet), strict=True)
    model = Video2WorldModel(RFModelConfig(net=tnet, state_t=2), net)
    tc = TrainerConfig(**{"max_iter": 3, "logging_iter": 1, "save_iter": 0, "seed": 0,
                          "optimizer": toptim.OptimizerConfig(**TRAIN_OPT), **tk})
    return Trainer(tc, model, draw_fn=draw_fn)


class Record(Callback):
    def __init__(self, fn):
        self.fn, self.items = fn, []

    def on_training_step_end(self, trainer, state, metrics, iteration):
        self.items.append(self.fn(state, metrics))


def test_trainer_reproduces_jax_golden_losses():
    """tests/test_training.py's trajectory (JAX init at PRNGKey(0), its mock
    batches, its optimizer) through the port's Trainer fed JAX's draws."""
    jnet, _ = nets("none")
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    jparams = jax.tree.map(np.asarray, jit_init(jmodel.init_params, jax.random.PRNGKey(0), LATENT, text_len=8))
    trainer = _trainer(jparams, draw_fn=lambda it, x0: jax_draws(jmodel, 0, it, tuple(x0.shape))[0])
    losses = Record(lambda state, m: float(m["loss"]))
    trainer.callbacks.callbacks.append(losses)
    state = trainer.train(trainer.init_state(), _batches(5))
    assert state.step == state.opt_step == 3
    np.testing.assert_allclose(losses.items, GOLDEN_LOSSES, rtol=1e-4)
    assert set(trainer.last_timings) == {"data_s", "forward_backward_s", "optimizer_s", "step_s"}
    assert trainer.stats.accum_video_sample_counter == 3


def test_trainer_is_freed_without_the_cycle_collector():
    """A Trainer holds no reference to itself (its default draws are not
    stored as a bound method), so dropping the last reference frees it and
    its model at once, not at the next garbage collection."""
    import gc
    import weakref

    trainer = _trainer()
    refs = weakref.ref(trainer), weakref.ref(trainer.model.net)
    gc.disable()
    try:
        del trainer
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_grad_accum_advances_ema_once_per_optimizer_step():
    trainer = _trainer(max_iter=4, grad_accum_iter=2)
    snap = Record(lambda state, m: ({n: p.detach().clone() for n, p in state.params.items()},
                                    {n: e.clone() for n, e in state.ema_params.items()}, state.opt_step))
    trainer.callbacks.callbacks.append(snap)
    state = trainer.init_state()
    ema0 = {n: e.clone() for n, e in state.ema_params.items()}
    trainer.train(state, _batches(6))
    (p1, e1, o1), (p2, e2, o2), (p3, e3, o3), (p4, e4, o4) = snap.items
    assert (o1, o2, o3, o4) == (0, 1, 1, 2)
    equal = lambda a, b: all(torch.equal(a[n], b[n]) for n in a)
    assert equal(e1, ema0) and equal(p1, ema0)  # micro-step 1: no update, EMA untouched
    assert not equal(p2, p1) and equal(e2, p2)  # first update: beta(0) = 0, the EMA snaps to the params
    assert equal(e3, e2) and equal(p3, p2)  # accumulating again
    assert not equal(e4, e3) and any(not torch.allclose(e4[n], p4[n]) for n in e4)  # beta in (0, 1)


def test_grad_accum_averages_micro_step_gradients():
    """Two micro-steps on the same batch and draws give the same update as
    one step on it: the accumulator holds the mean, not the sum."""
    fixed = lambda it, x0: jax_draws(JModel(JRFConfig(net=nets("none")[0], state_t=2)), 0, 0, tuple(x0.shape))[0]
    batch = next(_batches(1))
    one = _trainer(max_iter=1, draw_fn=fixed)
    two = _trainer(max_iter=2, grad_accum_iter=2, draw_fn=fixed)
    s1 = one.train(one.init_state(), [batch])
    s2 = two.train(two.init_state(), [batch, batch])
    for n, p in s1.params.items():
        torch.testing.assert_close(s2.params[n], p, rtol=1e-6, atol=1e-9)


def test_checkpoint_save_and_resume_is_exact(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    trainer = _trainer(max_iter=2, save_iter=1)
    trainer.checkpointer = ckpt
    state = trainer.train(trainer.init_state(), _batches(2))
    assert ckpt.latest_step() == 2 and sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2"]

    other = _trainer(max_iter=3, seed=7)  # other weights, restored from the checkpoint
    restored = ckpt.load(other.init_state())
    assert (restored.step, restored.opt_step) == (2, 2)
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p) and torch.equal(restored.ema_params[n], state.ema_params[n]), n
    assert restored.scheduler.get_last_lr() == state.scheduler.get_last_lr()

    # one more step on both: bit-identical
    batch = list(_batches(3))[2:]
    trainer.config = dataclasses.replace(trainer.config, max_iter=3, save_iter=0)
    trainer.checkpointer = None
    a = trainer.train(state, batch, start_iteration=2)
    b = other.train(restored, batch, start_iteration=2)
    for n, p in a.params.items():
        assert torch.equal(b.params[n], p), n
    for n, e in a.ema_params.items():
        assert torch.equal(b.ema_params[n], e), n


def test_consolidated_export_and_ema_swap(tmp_path):
    params = {"a": torch.arange(4.0), "b": torch.ones(2, 2)}
    save_consolidated(params, str(tmp_path / "model.pt"))
    back = load_consolidated({k: torch.zeros_like(v) for k, v in params.items()}, str(tmp_path / "model.pt"))
    assert all(torch.equal(back[k], v) for k, v in params.items())
    with pytest.raises(KeyError):
        load_consolidated({"a": params["a"]}, str(tmp_path / "model.pt"))
    sd = {"params": params, "ema_params": {k: v + 2 for k, v in params.items()}}
    out = load_ema_to_reg(sd, dtype=torch.bfloat16)
    assert float(out["params"]["b"][0, 0]) == 3.0 and out["params"]["b"].dtype == torch.bfloat16
    assert load_ema_to_reg({"params": params, "ema_params": None})["params"] is params


def test_validate_and_watchdog_run():
    trainer = _trainer(max_iter=2, validation_iter=1, timeout_period=600)
    state = trainer.train(trainer.init_state(), _batches(2), val_batches=list(_batches(2, seed=9)))
    assert state.step == 2
    avg = trainer.validate(state, list(_batches(2, seed=9)), 2)
    assert np.isfinite(avg) and avg == trainer.validate(state, list(_batches(2, seed=9)), 2)


# ------------------------------ configs and the entry point ------------------------------


def test_make_config_applies_dotlist_overrides():
    from cosmos_predict2_tpu.configs.defaults import make_config as jax_make_config
    from cosmos_predict2_tpu_torch.configs.defaults import make_config

    over = ["trainer.max_iter=7", "data_train.text_dim=100352", "trainer.optimizer.f_max=(0.25,)",
            "model.net.num_blocks=4", "trainer.ema_enabled=False"]
    p, j = make_config("error-free_mock_data_smoke", over), jax_make_config("error-free_mock_data_smoke", over)
    assert (p.trainer.max_iter, p.data_train.text_dim, p.trainer.optimizer.f_max, p.model.net.num_blocks) == (
        j.trainer.max_iter, j.data_train.text_dim, j.trainer.optimizer.f_max, j.model.net.num_blocks)
    assert p.trainer.ema_enabled is False
    with pytest.raises(AttributeError):
        make_config("error-free_mock_data_smoke", ["trainer.no_such_field=1"])


def test_train_cli_smoke_on_cpu():
    """2 iterations of error-free_mock_data_smoke through the entry point, on
    the CPU (COSMOS_SMOKE=1), at a reduced clip size."""
    env = torch_cpu_threads.subprocess_env(COSMOS_SMOKE="1")
    cmd = [sys.executable, "-m", "cosmos_predict2_tpu_torch.training.train", "--experiment=error-free_mock_data_smoke",
           "--device", "cpu", "data_train.num_frames=5", "data_train.height=32", "data_train.width=32",
           "data_train.text_len=16"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "trained 2 iterations"
    assert "Iteration 2: Loss:" in proc.stderr
