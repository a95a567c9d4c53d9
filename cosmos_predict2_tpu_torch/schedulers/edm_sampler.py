"""EDM (Karras) sampling with the "2ab" Adams-Bashforth multistep solver.

Counterpart of cosmos_predict2_tpu/schedulers/edm_sampler.py: Karras
rho-spaced sigmas, order-2 exponential-integrator steps (phi1 / phi2)
after an Euler first step, and the final clean denoise.
Every per-step coefficient depends only on the sigma schedule, so
:func:`make_coeffs` computes them in float64 NumPy (stored as float32, as
JAX stores them) and :func:`sample` is a host loop of elementwise updates
in fp32, like schedulers/unipc.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def karras_rev_ts(sigma_min: float = 0.002, sigma_max: float = 80.0, num_steps: int = 35, rho: float = 7.0) -> np.ndarray:
    """The descending Karras schedule, num_steps + 1 sigmas, float64."""
    idx = np.arange(num_steps + 1, dtype=np.float64)
    return (sigma_max ** (1 / rho) + idx / num_steps * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho


def _phi1(t: float) -> float:
    return math.expm1(t) / t if t != 0 else 1.0


def _phi2(t: float) -> float:
    return (_phi1(t) - 1.0) / t if t != 0 else 0.5


@dataclasses.dataclass(frozen=True)
class EDMCoeffs:
    """Per-step float32 tables: sigmas (n + 1,); the Euler step (step 0)
    x' = a_e x0 + b_e x; the 2ab step x' = exp_ndt x + b1dt x0 + b2dt
    x0_prev."""

    sigmas: np.ndarray
    a_e: np.ndarray
    b_e: np.ndarray
    exp_ndt: np.ndarray
    b1dt: np.ndarray
    b2dt: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.a_e.shape[0]


def make_coeffs(sigmas: np.ndarray) -> EDMCoeffs:
    n = len(sigmas) - 1
    a_e, b_e, exp_ndt, b1dt, b2dt = (np.zeros(n) for _ in range(5))
    lam = -np.log(sigmas)
    for i in range(n):
        s, t = sigmas[i], sigmas[i + 1]
        a_e[i] = (s - t) / s
        b_e[i] = t / s
        if i > 0:
            dt = lam[i + 1] - lam[i]
            c2 = (lam[i - 1] - lam[i]) / dt
            p1, p2 = _phi1(-dt), _phi2(-dt)
            exp_ndt[i] = math.exp(-dt)
            b1dt[i] = dt * (p1 - p2 / c2)
            b2dt[i] = dt * (p2 / c2)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return EDMCoeffs(f32(sigmas), f32(a_e), f32(b_e), f32(exp_ndt), f32(b1dt), f32(b2dt))


def sample(
    x0_fn: Callable[[torch.Tensor, float], torch.Tensor],
    x_sigma_max: torch.Tensor,
    num_steps: int = 35,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    sample_clean: bool = True,
) -> torch.Tensor:
    """The 2ab multistep sampler from ``x_sigma_max`` (noise * sigma_max):
    one ``x0_fn(x, sigma)`` per step (CFG composed inside), plus one more
    at the last sigma with ``sample_clean``. JAX's S_churn noise, which no
    caller turns on, is not ported."""
    c = make_coeffs(karras_rev_ts(sigma_min, sigma_max, num_steps, rho))
    s = lambda a: float(a)  # noqa: E731  fp32 table entry as an exact Python float
    x = x_sigma_max.float().clone()
    x0_prev = torch.zeros_like(x)
    for i in range(c.num_steps):
        x0 = x0_fn(x, s(c.sigmas[i])).float()
        if i == 0:
            x = s(c.a_e[i]) * x0 + s(c.b_e[i]) * x
        else:
            x = s(c.exp_ndt[i]) * x + s(c.b1dt[i]) * x0 + s(c.b2dt[i]) * x0_prev
        x0_prev = x0
    if sample_clean:
        x = x0_fn(x, s(c.sigmas[-1])).float()
    return x


def edm_scalings(sigma: torch.Tensor, sigma_data: float = 0.5):
    """EDM preconditioning: (c_skip, c_out, c_in, c_noise)."""
    c_skip = sigma_data**2 / (sigma**2 + sigma_data**2)
    c_out = sigma * sigma_data * torch.rsqrt(sigma**2 + sigma_data**2)
    c_in = torch.rsqrt(sigma**2 + sigma_data**2)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise
