"""DMD2 distillation trainer: alternating student and critic phases.

Counterpart of cosmos_predict2_tpu/training/distill_trainer.py (the
reference's distillation trainer and DistillationCoreMixin's per-net
optimizers and phase dispatch): the student updates on every
``student_update_freq``-th iteration, the fake-score critic on all others;
each net has its own AdamW (training/optim.py, with the global-norm clip
of the JAX chain) and LR schedule. The teacher stays frozen.

Per iteration, as the JAX trainer: the number of backward-simulation steps
``n = RandomState(seed).randint(0, len(times)) + 1`` is drawn on the host
from one stream that starts at the seed, so both packages draw the same
sequence; the step's other draws (:class:`DistillDraws`) come from
``draw_fn(iteration, x0)``, by default a CPU ``torch.Generator`` seeded
from ``(config.seed, iteration)`` and moved to the device. The nets train
with block remat as the DiT config says (``remat="block"``: the student's
last sampler step, or the critic's denoise, keeps only block inputs). A
phase's gradients are freed (set to None) after its update, so only the
active net holds gradients.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition, get_condition_uncondition
from cosmos_predict2_tpu_torch.models.distillation import DistillationModel, DistillDraws
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig, clip_by_global_norm_, global_norm, make_optimizer
from cosmos_predict2_tpu_torch.training.trainer import Callback, CallbackGroup

log = logging.getLogger("cosmos_predict2_tpu_torch")


@dataclasses.dataclass(frozen=True)
class DistillTrainerConfig:
    max_iter: int = 1000
    logging_iter: int = 10
    seed: int = 0
    student_optimizer: OptimizerConfig = OptimizerConfig(lr=1e-5)
    critic_optimizer: OptimizerConfig = OptimizerConfig(lr=1e-5)


@dataclasses.dataclass
class DistillTrainState:
    """The three nets (trained in place) and the two optimizers with their
    schedules; ``step`` counts the iterations taken."""

    step: int
    student: MiniTrainDIT
    teacher: MiniTrainDIT
    fake_score: MiniTrainDIT
    student_optimizer: torch.optim.Optimizer
    student_scheduler: torch.optim.lr_scheduler.LRScheduler
    critic_optimizer: torch.optim.Optimizer
    critic_scheduler: torch.optim.lr_scheduler.LRScheduler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DistillationTrainer:
    """Trains the student and the fake-score net of a DMD2 distillation.

    ``last_timings`` holds the split of the latest iteration, in seconds on
    the host clock, each ending in a device synchronize:
    ``forward_backward_s``, ``optimizer_s`` and ``step_s`` (both).
    """

    def __init__(
        self,
        config: DistillTrainerConfig,
        model: DistillationModel,
        callbacks: Optional[list[Callback]] = None,
        draw_fn: Optional[Callable[[int, torch.Tensor], DistillDraws]] = None,
    ):
        self.config = config
        self.model = model
        self.callbacks = CallbackGroup(callbacks)
        self.draw_fn = draw_fn
        self.last_timings: dict[str, float] = {}

    def default_draws(self, iteration: int, x0: torch.Tensor) -> DistillDraws:
        gen = torch.Generator().manual_seed(self.config.seed * 1_000_003 + iteration)
        return self.model.sample_distill_draws(gen, tuple(x0.shape))

    def init_state(self, student: MiniTrainDIT, teacher: MiniTrainDIT, fake_score: MiniTrainDIT) -> DistillTrainState:
        """Student and fake-score nets trainable, the teacher frozen; one
        optimizer and schedule per trained net."""
        cfg = self.config
        student.train().requires_grad_(True)
        fake_score.train().requires_grad_(True)
        teacher.eval().requires_grad_(False)
        s_opt, s_sched = make_optimizer(cfg.student_optimizer, student.parameters())
        c_opt, c_sched = make_optimizer(cfg.critic_optimizer, fake_score.parameters())
        return DistillTrainState(0, student, teacher, fake_score, s_opt, s_sched, c_opt, c_sched)

    # ----------------------------- one iteration -----------------------------

    def train_step(
        self, state: DistillTrainState, x0: torch.Tensor, condition: Video2WorldCondition, iteration: int, n_steps: int
    ) -> dict:
        """The phase of ``iteration`` with ``n_steps`` sampler steps; updates
        ``state`` in place and returns the metrics (``loss``, ``phase``,
        ``n_steps``, ``grad_norm`` and the phase's own)."""
        t0 = time.perf_counter()
        device = x0.device
        draws = (self.draw_fn or self.default_draws)(iteration, x0).to(device)
        cond, uncond = get_condition_uncondition(condition)
        student_phase = self.model.is_student_phase(iteration)
        if student_phase:
            net, opt, sched, opt_cfg = state.student, state.student_optimizer, state.student_scheduler, \
                self.config.student_optimizer
            loss, metrics = self.model.training_step_generator(
                state.student, state.teacher, state.fake_score, x0, cond, uncond, n_steps, draws)
        else:
            net, opt, sched, opt_cfg = state.fake_score, state.critic_optimizer, state.critic_scheduler, \
                self.config.critic_optimizer
            loss, metrics = self.model.training_step_critic(state.student, state.fake_score, x0, cond, n_steps, draws)
        loss.backward()
        params = [p for p in net.parameters() if p.requires_grad]
        missing = sum(p.grad is None for p in params)
        if missing:
            raise RuntimeError(f"{missing} trainable parameters received no gradient in the "
                               f"{'student' if student_phase else 'critic'} phase")
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        _sync(device)
        t1 = time.perf_counter()
        with torch.no_grad():
            if opt_cfg.grad_clip_norm is not None:
                clip_by_global_norm_(grads, norm, opt_cfg.grad_clip_norm)
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        _sync(device)
        t2 = time.perf_counter()
        self.last_timings = {"forward_backward_s": t1 - t0, "optimizer_s": t2 - t1, "step_s": t2 - t0}
        return {**metrics, "loss": loss.detach(), "grad_norm": norm, "n_steps": n_steps,
                "phase": "student" if student_phase else "critic"}

    # --------------------------------- loop ---------------------------------

    def train(
        self, state: DistillTrainState, batches: Iterable[tuple[torch.Tensor, Video2WorldCondition]]
    ) -> DistillTrainState:
        """Run the alternating phases over (latents, condition) batches
        until ``max_iter``; the condition carries its conditional frames."""
        cfg = self.config
        host_rng = np.random.RandomState(cfg.seed)
        n_times = len(self.model.config.selected_sampling_time)
        iteration = state.step
        self.callbacks.on_train_start(self, state)
        for x0, condition in batches:
            if iteration >= cfg.max_iter:
                break
            n_steps = int(host_rng.randint(0, n_times)) + 1
            self.callbacks.on_training_step_start(self, state, (x0, condition), iteration)
            metrics = self.train_step(state, x0, condition, iteration, n_steps)
            iteration += 1
            self.callbacks.on_training_step_end(self, state, metrics, iteration)
            if iteration % cfg.logging_iter == 0:
                log.info(f"Iteration {iteration} [{metrics['phase']}, {n_steps} steps]: "
                         f"Loss: {float(metrics['loss']):.4f}")
        self.callbacks.on_train_end(self, state)
        return state
