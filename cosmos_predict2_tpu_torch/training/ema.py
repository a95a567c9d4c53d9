"""EMA of the trained weights.

Counterpart of cosmos_predict2_tpu/training/ema.py. ``power_ema_beta`` is
the EDM2 power-EMA decay of the reference model
(text2world_model_rectified_flow.py:246-247,806-820):
  gamma = max real root of x^3 + 7x^2 + (16 - s^-2)x + (12 - s^-2)
  beta(i) = (1 - 1/(i+1)) ** (gamma + 1), and 0 for i < 1.
``ema_update`` updates the EMA tensors in place, by a lerp toward the
parameters (ema + (1 - beta) (p - ema)), where the JAX package builds a new
tree: the EMA of a 2B model is 8 GB in fp32, and an in-place update needs
no second copy.
"""

from __future__ import annotations

import functools
from typing import Iterable

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def power_ema_gamma(s: float) -> float:
    return float(np.roots([1, 7, 16 - s**-2, 12 - s**-2]).real.max())


def power_ema_beta(iteration: int, s: float = 0.1) -> float:
    """Per-iteration EMA decay."""
    if iteration < 1:
        return 0.0
    return (1.0 - 1.0 / (iteration + 1.0)) ** (power_ema_gamma(s) + 1.0)


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor], beta: float) -> None:
    """ema <- ema * beta + (1 - beta) * p, in place, one fused lerp over all
    tensors."""
    ema_params = list(ema_params)
    torch._foreach_lerp_(ema_params, [p.to(e.dtype) for e, p in zip(ema_params, params)], 1.0 - beta)
