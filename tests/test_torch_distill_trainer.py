"""The port's DMD2 distillation trainer (training/distill_trainer.py) held
against the JAX package's DistillationTrainer (CPU, fp32).

Both trainers start from the same perturbed student, teacher and
fake-score trees of the 2-block test DiT, take the batches of
tests/test_distill_trainer.py (student every 2nd iteration, AdamW at lr
1e-3 after a 1-step warm-up) and run 6 iterations. The JAX side is its
trainer's own loop (``_student_step`` / ``_critic_step`` under
``fold_in(PRNGKey(seed), iteration)``, ``n`` from the host RandomState);
the port is fed those draws as ``DistillDraws``. Measured: the losses of
the 6 iterations agree to <= 8.2e-6 relative (checked at 1e-4: fp32 sums in
another order and the timestep ulps of tests/test_torch_distillation.py,
carried through 5 optimizer updates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.models import distillation as jd
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.training import distill_trainer as jdt
from cosmos_predict2_tpu.training.optim import OptimizerConfig as JOptimizerConfig
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.models import distillation as td
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT
from cosmos_predict2_tpu_torch.training import distill_trainer as tdt
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.training.trainer import Callback
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch

SHAPE = (1, 16, 2, 4, 4)
ITERS = 6
FREQ = 2
OPT = dict(lr=1e-3, warm_up_steps=(1,), cycle_lengths=(100,))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_batches():
    for i in range(ITERS):
        x0 = jax.random.normal(jax.random.PRNGKey(10 + i), SHAPE)
        emb = jax.random.normal(jax.random.PRNGKey(20 + i), (1, 8, 1024)) * 0.05
        yield x0, jcond.make_condition(emb).replace(gt_frames=x0).set_video_condition(x0, 1)


def port_batches():
    for x0, jc in jax_batches():
        x = t(x0)
        yield x, tcond.make_condition(t(jc.crossattn_emb)).replace(gt_frames=x).set_video_condition(x, 1)


def jax_draws(jdm, key) -> td.DistillDraws:
    rng_t, rng_g, rng_d = jax.random.split(key, 3)
    return td.DistillDraws(t(jdm.draw_training_time_D(rng_t, SHAPE[0])), t(jax.random.normal(rng_g, SHAPE)),
                           t(jax.random.normal(rng_d, SHAPE)))


class Record(Callback):
    """Per iteration: phase, n, loss, and which nets' parameters changed."""

    def __init__(self):
        self.items = []

    @staticmethod
    def snapshot(state):
        return {name: [p.detach().clone() for p in getattr(state, name).parameters()]
                for name in ("student", "teacher", "fake_score")}

    def on_training_step_start(self, trainer, state, batch, iteration):
        self.before = self.snapshot(state)

    def on_training_step_end(self, trainer, state, metrics, iteration):
        after = self.snapshot(state)
        changed = {n for n in after if any(not torch.equal(a, b) for a, b in zip(after[n], self.before[n]))}
        self.items.append((metrics["phase"], metrics["n_steps"], float(metrics["loss"]), changed))


@pytest.fixture(scope="module")
def runs():
    """The JAX trainer's (phase, n, loss) per iteration and the port's
    Record over the same 6 iterations."""
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
    names = {f.name for f in dataclasses.fields(DiTConfig)} - {"dtype", "remat"}
    tnet = DiTConfig(dtype=torch.float32, remat="block", **{n: getattr(jnet, n) for n in names})
    jdm = jd.DistillationModel(jd.DistillationConfig(model=JRFConfig(net=jnet, state_t=2), student_update_freq=FREQ))
    rng = np.random.default_rng(0)
    trees = []
    for seed in range(3):
        leaves, tdef = jax.tree.flatten(jdm.base.init_params(jax.random.PRNGKey(seed), SHAPE, text_len=8))
        trees.append(jax.tree.unflatten(tdef, [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
                                               for l in leaves]))

    jopt = JOptimizerConfig(**OPT)
    jtrainer = jdt.DistillationTrainer(jdt.DistillTrainerConfig(max_iter=ITERS, logging_iter=1, student_optimizer=jopt,
                                                                critic_optimizer=jopt), jdm)
    state = jtrainer.init_state(*(jax.tree.map(jnp.asarray, p) for p in trees))
    base, host = jax.random.PRNGKey(0), np.random.RandomState(0)
    want = []
    for i, (x0, cond) in enumerate(jax_batches()):  # DistillationTrainer.train's loop, keeping the metrics
        key, n = jax.random.fold_in(base, i), int(host.randint(0, 4)) + 1
        c, u = jcond.get_condition_uncondition(cond)
        if jdm.is_student_phase(i):
            state, m = jtrainer._student_step(state, x0, c, u, key, n_steps=n)
        else:
            state, m = jtrainer._critic_step(state, x0, c, key, n_steps=n)
        want.append(("student" if int(m["phase"]) == 0 else "critic", n, float(m["loss"])))

    nets = []
    for params in trees:
        net = MiniTrainDIT(tnet)
        net.load_state_dict(jax_dit_params_to_torch(params, tnet), strict=True)
        nets.append(net)
    tdm = td.DistillationModel(td.DistillationConfig(model=RFModelConfig(net=tnet, state_t=2), student_update_freq=FREQ))
    record = Record()
    trainer = tdt.DistillationTrainer(
        tdt.DistillTrainerConfig(max_iter=ITERS, logging_iter=1, student_optimizer=OptimizerConfig(**OPT),
                                 critic_optimizer=OptimizerConfig(**OPT)),
        tdm, callbacks=[record], draw_fn=lambda it, x0: jax_draws(jdm, jax.random.fold_in(base, it)))
    final = trainer.train(trainer.init_state(*nets), port_batches())
    assert final.step == ITERS
    return want, record.items, trainer


def test_phases_and_sampler_steps_alternate_as_in_jax(runs):
    want, got, _ = runs
    assert [(p, n) for p, n, *_ in got] == [(p, n) for p, n, _ in want]
    assert [p for p, *_ in got] == ["critic", "student"] * (ITERS // 2)
    host = np.random.RandomState(0)
    assert [n for _, n, *_ in got] == [int(host.randint(0, 4)) + 1 for _ in range(ITERS)]


def test_trainer_reproduces_jax_losses(runs):
    want, got, trainer = runs
    for i, ((_, _, loss, _), (_, _, jloss)) in enumerate(zip(got, want)):
        assert np.isfinite(loss) and loss == pytest.approx(jloss, rel=1e-4), (i, loss, jloss)
    assert set(trainer.last_timings) == {"forward_backward_s", "optimizer_s", "step_s"}


def test_each_phase_changes_only_its_net(runs):
    """A critic step changes only the fake-score net, a student step only
    the student; the teacher never changes."""
    _, got, _ = runs
    for phase, _, _, changed in got:
        assert changed == ({"student"} if phase == "student" else {"fake_score"}), (phase, changed)


def test_default_draws_are_seeded_per_iteration():
    tdm = td.DistillationModel(td.DistillationConfig())
    trainer = tdt.DistillationTrainer(tdt.DistillTrainerConfig(seed=3), tdm)
    x0 = torch.zeros(SHAPE)
    a, b, c = trainer.default_draws(4, x0), trainer.default_draws(4, x0), trainer.default_draws(5, x0)
    assert a.time_D.shape == (1, 1) and a.G_eps.shape == a.D_eps.shape == SHAPE
    assert torch.equal(a.G_eps, b.G_eps) and not torch.equal(a.G_eps, c.G_eps)
    assert 0 < float(a.time_D) < np.pi / 2
