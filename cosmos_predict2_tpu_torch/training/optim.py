"""Optimizer and learning-rate schedule of the trainer.

Counterpart of cosmos_predict2_tpu/training/optim.py. The JAX package runs
``optax.adamw`` in XLA with no Pallas kernel, so the port uses
``torch.optim.AdamW`` with the same update: decoupled weight decay,
bias-corrected moments, the rate ``lr * f(count)`` taken at the count before
the update (a ``LambdaLR`` stepped after each optimizer step gives the same
order). Gradient clipping is optax's ``clip_by_global_norm``: gradients are
scaled by ``max_norm / norm`` only when ``norm >= max_norm``.

``lambda_linear_schedule`` is imaginaire's ``LambdaLinearScheduler``:
per-cycle linear warm-up from f_start to f_max, then linear decay to f_min
over the cycle; the returned factor multiplies the base lr.

bf16 moments and host-offloaded moments (``moments_dtype``,
``moments_offload`` in the JAX package) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2 ** (-14.5)
    weight_decay: float = 0.001
    betas: tuple[float, float] = (0.9, 0.99)
    eps: float = 1e-8
    grad_clip_norm: float | None = 10.0
    # LambdaLinear schedule (per cycle)
    warm_up_steps: tuple[int, ...] = (2_000,)
    f_start: tuple[float, ...] = (1e-6,)
    f_max: tuple[float, ...] = (0.5,)
    f_min: tuple[float, ...] = (0.2,)
    cycle_lengths: tuple[int, ...] = (100_000,)


def lambda_linear_schedule(
    warm_up_steps: Sequence[int],
    f_start: Sequence[float],
    f_max: Sequence[float],
    f_min: Sequence[float],
    cycle_lengths: Sequence[int],
) -> Callable[[int], float]:
    """step -> lr factor; past the last cycle, f_min[-1]."""
    cum = np.cumsum([0] + list(cycle_lengths))

    def schedule(step: int) -> float:
        f = float(f_min[-1])
        # cycles back to front so that earlier cycles override
        for c in reversed(range(len(cycle_lengths))):
            n = step - int(cum[c])
            if not 0 <= n <= cycle_lengths[c]:
                continue
            if n < warm_up_steps[c]:
                f = (f_max[c] - f_start[c]) / max(warm_up_steps[c], 1) * n + f_start[c]
            else:
                f = f_min[c] + (f_max[c] - f_min[c]) * (cycle_lengths[c] - n) / (cycle_lengths[c] - warm_up_steps[c])
        return f

    return schedule


def make_optimizer(
    config: OptimizerConfig, params: Iterable[torch.nn.Parameter]
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``params`` and the LambdaLinear schedule on its rate; step
    the schedule once after every optimizer step."""
    opt = torch.optim.AdamW(
        params, lr=config.lr, betas=config.betas, eps=config.eps, weight_decay=config.weight_decay
    )
    schedule = lambda_linear_schedule(
        config.warm_up_steps, config.f_start, config.f_max, config.f_min, config.cycle_lengths
    )
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: grads scaled by max_norm / norm
    unless norm < max_norm, where ``norm`` is their :func:`global_norm`."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
