"""Rectified-flow noise schedule: the sampling shift and the training-time schedule.

Counterpart of cosmos_predict2_tpu/schedulers/rectified_flow.py. Conventions
as there: ``x_0`` is noise, ``x_1`` clean data; ``x_t = x_0 t + x_1 (1 - t)``
with velocity target ``x_0 - x_1``; a train time ``u`` in [0, 1) maps to
``timesteps[floor(u N)]`` of the shifted discrete schedule. The tables are
computed in float64 NumPy by the same formula as the JAX package's and
stored as fp32 tensors. Random draws come from a ``torch.Generator`` the
caller passes, or are handed in whole (``apply_high_sigma``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """Resolution shift of flow-matching noise levels: s' = k*s/(1+(k-1)s)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class RectifiedFlowConfig:
    num_train_timesteps: int = 1000
    shift: float = 3.0
    train_time_distribution: str = "uniform"  # "uniform" | "logitnormal"
    train_time_weight: str = "uniform"


class RectifiedFlow:
    """Training-time rectified-flow schedule: base sigmas linspace(1, 1/N, N),
    then the shift map; ``timesteps = sigmas * N`` (descending)."""

    def __init__(self, config: RectifiedFlowConfig = RectifiedFlowConfig()):
        self.config = config
        n = config.num_train_timesteps
        sigmas = shift_sigmas(np.linspace(1.0, 1.0 / n, n), config.shift)
        self.sigmas = torch.tensor(sigmas, dtype=torch.float32)  # (N,) descending
        self.timesteps = torch.tensor(sigmas * n, dtype=torch.float32)  # (N,)

    def sample_train_time(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """u in [0, 1), shape (B,), drawn on the generator's device."""
        dist = self.config.train_time_distribution
        dev = generator.device
        if dist == "uniform":
            return torch.rand((batch_size,), generator=generator, device=dev)
        if dist == "logitnormal":
            return torch.sigmoid(torch.randn((batch_size,), generator=generator, device=dev))
        raise NotImplementedError(f"Time distribution '{dist}' is not implemented.")

    def discretize(self, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Continuous u in [0, 1) -> (timesteps, sigmas) at index floor(u N)."""
        n = self.config.num_train_timesteps
        idx = (u.float() * n).to(torch.int64).clamp(0, n - 1)
        return self.timesteps.to(u.device)[idx], self.sigmas.to(u.device)[idx]

    @staticmethod
    def get_interpolation(x_0: torch.Tensor, x_1: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x_t = x_0 t + x_1 (1 - t); dot x_t = x_0 - x_1. ``t`` is (B,) or
        broadcastable (B, 1, ...)."""
        t = t.reshape(t.shape[0], *([1] * (x_1.ndim - 1)))
        return x_0 * t + x_1 * (1.0 - t), x_0 - x_1

    def high_sigma_candidates(self, timesteps_min: int = 980, timesteps_max: int = 1000) -> np.ndarray:
        """Schedule indices whose timestep lies in [timesteps_min, timesteps_max]."""
        ts = self.timesteps.numpy()
        cand = np.nonzero((ts >= timesteps_min) & (ts <= timesteps_max))[0]
        if cand.size == 0:
            raise ValueError("No candidate timesteps found for high sigma strategy")
        return cand

    def apply_high_sigma(
        self, timesteps: torch.Tensor, sigmas: torch.Tensor, use_high: torch.Tensor, picks: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """High-sigma strategy: where ``use_high`` (B,) is set, replace the
        drawn timestep by the schedule's entry at index ``picks`` (B,), drawn
        from :meth:`high_sigma_candidates` (reference
        text2world_model_rectified_flow.py:375-390)."""
        dev = timesteps.device
        return (
            torch.where(use_high, self.timesteps.to(dev)[picks], timesteps),
            torch.where(use_high, self.sigmas.to(dev)[picks], sigmas),
        )

    def time_weight(self, t: torch.Tensor) -> torch.Tensor:
        if self.config.train_time_weight in ("uniform", "reweighting"):
            return torch.ones_like(t)
        raise NotImplementedError(f"Time weight '{self.config.train_time_weight}' is not implemented.")
