"""Flow-matching UniPC multistep sampler (predict_x0, bh2, order 2).

Counterpart of cosmos_predict2_tpu/schedulers/unipc.py. Every scalar of the
predictor/corrector update depends only on the sigma schedule and the step
index, so :func:`set_timesteps` precomputes the coefficient tables in
float64 NumPy (stored as float32, as the reference stores them) and
:func:`sample` is a plain Python loop over steps whose update is a few
elementwise tensor ops in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from cosmos_predict2_tpu_torch.schedulers.rectified_flow import shift_sigmas


@dataclasses.dataclass(frozen=True)
class UniPCConfig:
    num_train_timesteps: int = 1000
    solver_order: int = 2
    solver_type: str = "bh2"  # "bh1" | "bh2"
    lower_order_final: bool = True
    predict_x0: bool = True
    disable_corrector: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class UniPCCoeffs:
    """Per-step tables, float32 NumPy, shapes (n,) or (n, order-1).

    corrector at step i (last_x = x_{i-1}, m[0] the newest previous x0):
      x_i <- c_ratio[i]*last_x - c_m0[i]*m[0]
             - sum_k c_hist[i,k]*(m[k+1]-m[0]) - c_d1t[i]*(x0_i - m[0])
    predictor (after x0_i is pushed, so m[0] = x0_i):
      x_{i+1} = p_ratio[i]*x_i - p_m0[i]*m[0] - sum_k p_hist[i,k]*(m[k+1]-m[0])
    """

    timesteps: np.ndarray  # (n,) model-facing timesteps (sigma * 1000, floored)
    sigmas: np.ndarray  # (n+1,) incl. the final 0
    use_corrector: np.ndarray  # (n,) bool
    c_ratio: np.ndarray
    c_m0: np.ndarray
    c_hist: np.ndarray
    c_d1t: np.ndarray
    p_ratio: np.ndarray
    p_m0: np.ndarray
    p_hist: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def karras_sigmas(num_steps: int, sigma_min: float = 0.01, sigma_max: float = 200.0, rho: float = 7.0) -> np.ndarray:
    """EDM Karras schedule mapped to flow sigma in (0, 1): s = k / (1 + k)."""
    steps = np.arange(num_steps + 1, dtype=np.float64) / num_steps
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sig = (max_inv_rho + steps * (min_inv_rho - max_inv_rho)) ** rho
    return sig / (1.0 + sig)


def set_timesteps(
    num_steps: int,
    shift: float = 5.0,
    use_karras_sigma: bool = False,
    config: UniPCConfig = UniPCConfig(),
) -> UniPCCoeffs:
    """Sigma schedule (linspace over [1 - 1/N, 0), shift map, final 0) and
    the UniPC coefficient tables; orders[i] = min(order, n - i, i + 1)."""
    n_train = config.num_train_timesteps
    if use_karras_sigma:
        sigmas = karras_sigmas(num_steps)
    else:
        sigmas = np.linspace(1.0 - 1.0 / n_train, 0.0, num_steps + 1)[:-1]
        sigmas = shift_sigmas(sigmas, shift)
    timesteps = np.floor(sigmas * n_train)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float64)
    n = len(timesteps)

    order = config.solver_order
    orders = np.empty(n, dtype=np.int64)
    for i in range(n):
        o = min(order, n - i) if config.lower_order_final else order
        orders[i] = min(o, i + 1)

    def lam(s: float) -> float:
        # lambda = log(alpha) - log(sigma), alpha = 1 - sigma; +-inf at the ends
        a = 1.0 - s
        if s <= 0.0:
            return math.inf
        if a <= 0.0:
            return -math.inf
        return math.log(a) - math.log(s)

    c_ratio, c_m0, c_d1t = np.zeros(n), np.zeros(n), np.zeros(n)
    p_ratio, p_m0 = np.zeros(n), np.zeros(n)
    c_hist = np.zeros((n, max(order - 1, 1)))
    p_hist = np.zeros((n, max(order - 1, 1)))
    use_corr = np.zeros(n, dtype=bool)

    def bh_terms(h: float, o: int):
        hh = -h if config.predict_x0 else h
        h_phi_1 = math.expm1(hh)
        B_h = hh if config.solver_type == "bh1" else math.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1.0
        b = []
        factorial_i = 1
        for k in range(1, o + 1):
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= k + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        return h_phi_1, B_h, np.asarray(b)

    for i in range(n):
        # corrector at step i (order = orders[i-1])
        if i > 0 and (i - 1) not in config.disable_corrector:
            o = int(orders[i - 1])
            sig_t, sig_s0 = sigmas[i], sigmas[i - 1]
            alpha_t = 1.0 - sig_t
            h = lam(sig_t) - lam(sig_s0)
            rks = [(lam(sigmas[i - (j + 1)]) - lam(sig_s0)) / h for j in range(1, o)] + [1.0]
            h_phi_1, B_h, b = bh_terms(h, o)
            R = np.stack([np.power(np.asarray(rks), k) for k in range(o)])
            rhos_c = np.asarray([0.5]) if o == 1 else np.linalg.solve(R, b)
            use_corr[i] = True
            c_ratio[i] = sig_t / sig_s0
            c_m0[i] = alpha_t * h_phi_1
            for j in range(1, o):
                c_hist[i, j - 1] = alpha_t * B_h * rhos_c[j - 1] / rks[j - 1]
            c_d1t[i] = alpha_t * B_h * rhos_c[-1]

        # predictor at step i (order = orders[i])
        o = int(orders[i])
        sig_t, sig_s0 = sigmas[i + 1], sigmas[i]
        alpha_t = 1.0 - sig_t
        h = lam(sig_t) - lam(sig_s0)
        rks = [(lam(sigmas[i - j]) - lam(sig_s0)) / h for j in range(1, o)] + [1.0]
        h_phi_1, B_h, b = bh_terms(h, o)
        R = np.stack([np.power(np.asarray(rks), k) for k in range(o)])
        if o == 2:
            rhos_p = np.asarray([0.5])
        elif o == 1:
            rhos_p = np.zeros(0)
        else:
            rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
        p_ratio[i] = sig_t / sig_s0
        p_m0[i] = alpha_t * h_phi_1
        for j in range(1, o):
            p_hist[i, j - 1] = alpha_t * B_h * rhos_p[j - 1] / rks[j - 1]

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return UniPCCoeffs(
        timesteps=f32(timesteps), sigmas=f32(sigmas), use_corrector=use_corr,
        c_ratio=f32(c_ratio), c_m0=f32(c_m0), c_hist=f32(c_hist), c_d1t=f32(c_d1t),
        p_ratio=f32(p_ratio), p_m0=f32(p_m0), p_hist=f32(p_hist),
    )


def sample(
    velocity_fn: Callable[[torch.Tensor, float], torch.Tensor],
    x_init: torch.Tensor,
    coeffs: UniPCCoeffs,
) -> torch.Tensor:
    """Run the UniPC loop from ``x_init`` (fp32): one ``velocity_fn(x, t)``
    per step, history and carries in fp32."""
    c = coeffs
    order_hist = max(c.c_hist.shape[1], 1)
    x = x_init.float().clone()
    last_x = torch.zeros_like(x)
    hist = [torch.zeros_like(x) for _ in range(order_hist + 1)]  # hist[0] newest
    s = lambda a: float(a)  # fp32 table entry as an exactly representable Python float
    for i in range(c.num_steps):
        v = velocity_fn(x, s(c.timesteps[i]))
        x0 = x - s(c.sigmas[i]) * v.float()
        if c.use_corrector[i]:
            m0 = hist[0]
            corr = s(c.c_ratio[i]) * last_x - s(c.c_m0[i]) * m0 - s(c.c_d1t[i]) * (x0 - m0)
            for k in range(order_hist):
                corr = corr - s(c.c_hist[i, k]) * (hist[k + 1] - m0)
            x = corr
        hist = [x0] + hist[:-1]
        x_next = s(c.p_ratio[i]) * x - s(c.p_m0[i]) * x0
        for k in range(order_hist):
            x_next = x_next - s(c.p_hist[i, k]) * (hist[k + 1] - x0)
        last_x, x = x, x_next
    return x
