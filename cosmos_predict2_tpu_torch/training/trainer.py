"""Training loop.

Counterpart of cosmos_predict2_tpu/training/trainer.py: callbacks around
every phase, gradient accumulation, the power EMA after each optimizer step,
checkpoint save/resume, validation, per-step timings and a SIGALRM stall
watchdog. One step is: conditioning dropout, ``training_step`` forward,
backward, gradient norm, (accumulation,) clipping, AdamW, LR schedule, EMA.

The numbers follow the JAX trainer's optax chain: with ``grad_accum_iter``
k > 1 the micro-step gradients are averaged as ``optax.MultiSteps`` does
(running mean) and the optimizer, the schedule and the EMA advance once per
k micro-steps; the EMA decay is taken at the optimizer-step count before
the update, so the EMA equals the parameters after the first update.
``grad_norm`` is the global norm of each micro-step's raw gradients.

Random draws: each step's :class:`TrainDraws` come from ``draw_fn(iteration,
x0)``; the default draws them from a CPU ``torch.Generator`` seeded from
``(config.seed, iteration)``, so a resumed run draws what an unbroken one
would.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Callable, Iterable, Optional

import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition, apply_train_dropout
from cosmos_predict2_tpu_torch.models.video2world import TrainDraws, Video2WorldModel
from cosmos_predict2_tpu_torch.training.ema import ema_update, power_ema_beta
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig, clip_by_global_norm_, global_norm, make_optimizer

log = logging.getLogger("cosmos_predict2_tpu_torch")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_iter: int = 1000
    grad_accum_iter: int = 1
    logging_iter: int = 10
    save_iter: int = 200
    validation_iter: int = 0  # 0 = disabled
    seed: int = 0
    ema_enabled: bool = True
    ema_rate: float = 0.1  # power EMA "s"
    timeout_period: int = 0  # seconds; 0 disables the stall watchdog
    optimizer: OptimizerConfig = OptimizerConfig()


@dataclasses.dataclass
class TrainState:
    """The training state beside the module's parameters, which it holds by
    name (the live ``nn.Parameter`` objects of the net): micro-steps taken
    (``step``), optimizer updates applied (``opt_step``), the EMA tensors,
    the optimizer and schedule, and the running mean of the micro-step
    gradients under accumulation."""

    step: int
    params: dict[str, torch.nn.Parameter]
    ema_params: Optional[dict[str, torch.Tensor]]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    opt_step: int = 0
    grad_acc: Optional[dict[str, torch.Tensor]] = None

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "opt_step": self.opt_step,
            "params": {n: p.detach() for n, p in self.params.items()},
            "ema_params": self.ema_params,
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "grad_acc": self.grad_acc,
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore in place: the parameters and buffers keep their identity,
        so the optimizer keeps tracking them."""
        self.step, self.opt_step = int(sd["step"]), int(sd["opt_step"])
        for group in ("params", "ema_params", "grad_acc"):
            mine, theirs = getattr(self, group), sd[group]
            if (mine is None) != (theirs is None) or (mine is not None and mine.keys() != theirs.keys()):
                raise KeyError(f"checkpoint's {group} do not match this training state")
            for n, t in (mine or {}).items():
                t.copy_(theirs[n])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])


class Callback:
    """Hook interface (subset of imaginaire/utils/callback.py:46-440)."""

    def on_train_start(self, trainer, state): ...

    def on_training_step_start(self, trainer, state, batch, iteration): ...

    def on_training_step_end(self, trainer, state, metrics, iteration): ...

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...


class CallbackGroup(Callback):
    def __init__(self, callbacks: Optional[list[Callback]] = None):
        self.callbacks = callbacks or []

    def on_train_start(self, trainer, state):
        for cb in self.callbacks:
            cb.on_train_start(trainer, state)

    def on_training_step_start(self, trainer, state, batch, iteration):
        for cb in self.callbacks:
            cb.on_training_step_start(trainer, state, batch, iteration)

    def on_training_step_end(self, trainer, state, metrics, iteration):
        for cb in self.callbacks:
            cb.on_training_step_end(trainer, state, metrics, iteration)

    def on_save_checkpoint(self, trainer, state, iteration):
        for cb in self.callbacks:
            cb.on_save_checkpoint(trainer, state, iteration)

    def on_train_end(self, trainer, state):
        for cb in self.callbacks:
            cb.on_train_end(trainer, state)


class IterSpeedCallback(Callback):
    """Logs loss and iterations per second every ``every_n`` iterations."""

    def __init__(self, every_n: int = 10):
        self.every_n = every_n
        self._t0 = None

    def on_training_step_end(self, trainer, state, metrics, iteration):
        if iteration % self.every_n == 0:
            now = time.perf_counter()
            if self._t0 is not None:
                rate = self.every_n / (now - self._t0)
                log.info(f"Iteration {iteration}: Loss: {float(metrics['loss']):.4f} | {rate:.2f} it/s")
            else:
                log.info(f"Iteration {iteration}: Loss: {float(metrics['loss']):.4f}")
            self._t0 = now


@dataclasses.dataclass
class TrainingStats:
    """Sample counters (reference networks/model_weights_stats.py:34-64):
    image/video samples consumed, iterations and train-hours."""

    accum_video_sample_counter: int = 0
    accum_image_sample_counter: int = 0
    accum_iteration: int = 0
    accum_train_in_hours: float = 0.0

    def update(self, batch_size: int, num_frames: int, seconds: float) -> None:
        if num_frames <= 1:
            self.accum_image_sample_counter += batch_size
        else:
            self.accum_video_sample_counter += batch_size
        self.accum_iteration += 1
        self.accum_train_in_hours += seconds / 3600.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Trains ``model.net`` in place.

    ``last_timings`` holds the split of the latest step, in seconds on the
    host clock, each phase ending in a device synchronize: ``data_s`` (the
    batch iterator: data and VAE encode), ``forward_backward_s``,
    ``optimizer_s`` (norm, clipping, AdamW, schedule and EMA) and ``step_s``
    (the train step: the last two together, without ``data_s``).
    """

    def __init__(
        self,
        config: TrainerConfig,
        model: Video2WorldModel,
        callbacks: Optional[list[Callback]] = None,
        checkpointer=None,
        draw_fn: Optional[Callable[[int, torch.Tensor], TrainDraws]] = None,
    ):
        self.config = config
        self.model = model
        self.callbacks = CallbackGroup(callbacks if callbacks is not None else [IterSpeedCallback(config.logging_iter)])
        self.checkpointer = checkpointer
        self.stats = TrainingStats()
        self.draw_fn = draw_fn  # None: default_draws (not stored as a bound method: no Trainer -> Trainer cycle)
        self.device = next(model.net.parameters()).device
        self.last_timings: dict[str, float] = {}

    def default_draws(self, iteration: int, x0: torch.Tensor) -> TrainDraws:
        gen = torch.Generator().manual_seed(self.config.seed * 1_000_003 + iteration)
        return self.model.sample_train_draws(gen, tuple(x0.shape))

    # ------------------------------ state ------------------------------

    def init_state(self) -> TrainState:
        cfg = self.config
        params = {n: p for n, p in self.model.net.named_parameters() if p.requires_grad}
        if not params:
            raise ValueError("the net has no trainable parameters: build it with build_dit(..., trainable=True)")
        ema = {n: p.detach().clone().float() for n, p in params.items()} if cfg.ema_enabled else None
        optimizer, scheduler = make_optimizer(cfg.optimizer, params.values())
        acc = {n: torch.zeros_like(p) for n, p in params.items()} if cfg.grad_accum_iter > 1 else None
        return TrainState(step=0, params=params, ema_params=ema, optimizer=optimizer, scheduler=scheduler, grad_acc=acc)

    # ---------------------------- train step ----------------------------

    def train_step(self, state: TrainState, x0: torch.Tensor, condition: Video2WorldCondition, iteration: int) -> dict:
        """One micro-step; updates ``state`` in place and returns the metrics."""
        cfg = self.config
        t0 = time.perf_counter()
        draws = (self.draw_fn or self.default_draws)(iteration, x0).to(self.device)
        condition = apply_train_dropout(condition, draws.text_keep, draws.use_video)
        for p in state.params.values():
            p.grad = None
        loss, metrics = self.model.training_step(x0, condition, draws)
        loss.backward()
        missing = [n for n, p in state.params.items() if p.grad is None]
        if missing:
            raise RuntimeError(f"{len(missing)} trainable parameters received no gradient, e.g. {missing[:3]}")
        grads = [p.grad for p in state.params.values()]
        metrics["grad_norm"] = norm = global_norm(grads)
        _sync(self.device)
        t1 = time.perf_counter()

        k = cfg.grad_accum_iter
        update = True
        if k > 1:
            n_acc = state.step % k
            with torch.no_grad():
                for a, g in zip(state.grad_acc.values(), grads):
                    a.add_((g - a) / (n_acc + 1))  # optax.MultiSteps' running mean
                update = n_acc == k - 1
                if update:
                    for a, g in zip(state.grad_acc.values(), grads):
                        g.copy_(a)
                        a.zero_()
                    norm = global_norm(grads)  # of the averaged gradients
        if update:
            with torch.no_grad():
                if cfg.optimizer.grad_clip_norm is not None:
                    clip_by_global_norm_(grads, norm, cfg.optimizer.grad_clip_norm)
            state.optimizer.step()
            state.scheduler.step()
            if state.ema_params is not None:
                beta = power_ema_beta(state.opt_step, s=cfg.ema_rate)
                ema_update(state.ema_params.values(), state.params.values(), beta)
            state.opt_step += 1
        state.step += 1
        _sync(self.device)
        t2 = time.perf_counter()
        self.last_timings = {"forward_backward_s": t1 - t0, "optimizer_s": t2 - t1, "step_s": t2 - t0}
        return metrics

    # ----------------------------- validation -----------------------------

    @torch.no_grad()
    def validate(self, state: TrainState, val_batches, iteration: int) -> float:
        """Average loss over up to 8 batches, no dropout, fixed draws."""
        losses = []
        for i, (x0, condition) in enumerate(val_batches):
            if i >= 8:
                break
            gen = torch.Generator().manual_seed((self.config.seed + 777) * 1_000_003 + i)
            draws = self.model.sample_train_draws(gen, tuple(x0.shape)).to(self.device)
            _, metrics = self.model.training_step(x0, condition, draws)
            losses.append(float(metrics["loss"]))
        avg = float(sum(losses) / max(1, len(losses)))
        log.info(f"Validation at iteration {iteration}: loss {avg:.4f} over {len(losses)} batches")
        return avg

    # ------------------------------- loop -------------------------------

    def train(
        self,
        state: TrainState,
        batches: Iterable[tuple[torch.Tensor, Video2WorldCondition]],
        start_iteration: int = 0,
        val_batches: Optional[Iterable] = None,
    ) -> TrainState:
        """Run the loop over (latents, condition) batches until ``max_iter``."""
        cfg = self.config
        self.callbacks.on_train_start(self, state)
        previous_handler = None
        if cfg.timeout_period > 0:
            def _timeout(signum, frame):
                raise TimeoutError(f"training iteration exceeded {cfg.timeout_period}s")

            previous_handler = signal.signal(signal.SIGALRM, _timeout)

        iteration = start_iteration
        batch_iter = iter(batches)
        try:
            while iteration < cfg.max_iter:
                if cfg.timeout_period > 0:
                    signal.alarm(cfg.timeout_period)
                t0 = time.perf_counter()
                try:
                    x0, condition = next(batch_iter)
                except StopIteration:
                    break
                _sync(self.device)
                data_s = time.perf_counter() - t0
                self.callbacks.on_training_step_start(self, state, (x0, condition), iteration)
                metrics = self.train_step(state, x0, condition, iteration)
                self.last_timings["data_s"] = data_s
                self.stats.update(x0.shape[0], x0.shape[2], self.last_timings["step_s"])
                iteration += 1
                self.callbacks.on_training_step_end(self, state, metrics, iteration)
                if val_batches is not None and cfg.validation_iter > 0 and iteration % cfg.validation_iter == 0:
                    self.validate(state, val_batches, iteration)
                if self.checkpointer is not None and cfg.save_iter > 0 and iteration % cfg.save_iter == 0:
                    self.checkpointer.save(state, iteration)
                    self.callbacks.on_save_checkpoint(self, state, iteration)
        finally:
            if cfg.timeout_period > 0:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, previous_handler)
        if self.checkpointer is not None:
            self.checkpointer.save(state, iteration)
            self.checkpointer.wait()
        self.callbacks.on_train_end(self, state)
        return state
