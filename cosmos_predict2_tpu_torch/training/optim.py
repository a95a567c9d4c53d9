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

``moments_dtype="bfloat16"`` keeps both Adam moments in bf16
(:class:`AdamWBF16`, the JAX package's ``scale_by_adam_bf16`` chain): the
update is computed in fp32 and the moments are written back by unbiased
stochastic rounding, its bits drawn from a ``torch.Generator`` seeded by
``moments_seed``. It halves the optimizer state (8 -> 4 bytes per
parameter). Host-offloaded moments (``moments_offload``) are a TPU
workaround and are not ported.

Sharded parameters (DTensors of parallel/mesh.py::parallelize): AdamW
steps them as they are; AdamWBF16 updates each local shard (its update is
elementwise) and draws every parameter's noise whole, in the unsharded
order, and keeps its shard's part, so each element gets the draw it gets
on one device. :func:`global_norm` of sharded gradients is the whole
model's, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from cosmos_predict2_tpu_torch.parallel import comm
from cosmos_predict2_tpu_torch.parallel.mesh import DTensor, copies, local_tensor


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
    # Adam moments in "float32" (torch.optim.AdamW) or "bfloat16" (AdamWBF16)
    moments_dtype: str = "float32"
    moments_seed: int = 0

    def __post_init__(self):
        if self.moments_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"moments_dtype must be 'float32' or 'bfloat16', got {self.moments_dtype!r}")


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


def stochastic_round_to_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Unbiased fp32 -> bf16 rounding: E[result] == x over uniform noise.

    ``noise``: int32 uniform in [0, 2^16), shaped like ``x`` (the JAX
    version's ``bits & 0xFFFF``). bf16 is fp32 without its low 16 mantissa
    bits, so adding the noise to the bit pattern and dropping those bits
    rounds up with probability equal to the dropped fraction; sign and
    magnitude are apart, so negative values round without bias too, and a
    carry into the exponent is the right round-up to the next binade.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic_round_to_bf16 takes fp32, got {x.dtype}")
    rounded = (x.view(torch.int32) + noise) & -65536  # 0xFFFF0000 as int32
    return rounded.view(torch.float32).to(torch.bfloat16)


def rounding_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """int32 noise for :func:`stochastic_round_to_bf16`, drawn on the
    generator's device and moved to ``device``."""
    return torch.randint(0, 1 << 16, tuple(shape), generator=generator, device=generator.device,
                         dtype=torch.int32).to(device)


def local_noise(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """:func:`rounding_noise` for ``p``'s whole shape; of a sharded ``p``,
    the part that lies on its local shard (cut without communication)."""
    noise = rounding_noise(p.shape, generator, local_tensor(p).device)
    if not isinstance(p, DTensor):
        return noise
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(noise, p.device_mesh, p.placements, src_data_rank=None).to_local()


@torch.no_grad()
def scale_by_adam_bf16(
    grads: Sequence[torch.Tensor],
    exp_avgs: Sequence[torch.Tensor],
    exp_avg_sqs: Sequence[torch.Tensor],
    count: int,
    betas: tuple[float, float],
    eps: float,
    noise_mu: Sequence[torch.Tensor],
    noise_nu: Sequence[torch.Tensor],
) -> list[torch.Tensor]:
    """JAX's ``scale_by_adam_bf16`` update over lists of tensors: the bf16
    moments are read, updated in fp32 (b1 m + (1 - b1) g, b2 v + (1 - b2)
    g^2), written back in place by stochastic rounding with the given noise;
    returns the fp32 updates m_hat / (sqrt(v_hat) + eps). ``count`` is the
    step number after its increment (1 at the first step)."""
    b1, b2 = betas
    g32 = [g.float() for g in grads]
    mu = torch._foreach_add(torch._foreach_mul([m.float() for m in exp_avgs], b1), torch._foreach_mul(g32, 1.0 - b1))
    nu = torch._foreach_add(torch._foreach_mul([v.float() for v in exp_avg_sqs], b2),
                            torch._foreach_mul(torch._foreach_mul(g32, g32), 1.0 - b2))
    del g32
    # the bias corrections in fp32, as the JAX version computes them
    c1 = float(1.0 - np.float32(b1) ** np.float32(count))
    c2 = float(1.0 - np.float32(b2) ** np.float32(count))
    den = torch._foreach_add_(torch._foreach_sqrt(torch._foreach_div(nu, c2)), eps)
    updates = torch._foreach_div_(torch._foreach_div(mu, c1), den)
    del den
    for m, v, m32, v32, nm, nv in zip(exp_avgs, exp_avg_sqs, mu, nu, noise_mu, noise_nu):
        m.copy_(stochastic_round_to_bf16(m32, nm))
        v.copy_(stochastic_round_to_bf16(v32, nv))
    return updates


class AdamWBF16(torch.optim.Optimizer):
    """AdamW whose moments ``exp_avg`` and ``exp_avg_sq`` are bf16: the JAX
    package's chain ``scale_by_adam_bf16`` -> ``add_decayed_weights`` ->
    ``-lr`` (gradient clipping comes before, in the trainer). Per step and
    per chunk of at most ``CHUNK_ELEMENTS`` parameter elements (the fp32
    temporaries stay that small), the noise of the first moments, then of
    the second, is drawn from ``generator`` (by default one on the
    parameters' device seeded with ``seed``). The generator's state is part
    of the state dict, so a resumed run rounds as an unbroken one."""

    CHUNK_ELEMENTS = 1 << 27

    def __init__(self, params, lr: float, betas: tuple[float, float], eps: float, weight_decay: float, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        if generator is None:
            device = self.param_groups[0]["params"][0].device
            generator = torch.Generator(device).manual_seed(seed)
        self.generator = generator

    def _chunks(self, params: list) -> list[list]:
        chunks, size = [[]], 0
        for p in params:
            if chunks[-1] and size + p.numel() > self.CHUNK_ELEMENTS:
                chunks.append([])
                size = 0
            chunks[-1].append(p)
            size += p.numel()
        return chunks

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWBF16 takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            for chunk in self._chunks(params):
                states = [self.state[p] for p in chunk]
                for p, st in zip(chunk, states):
                    if not st:
                        st["step"] = 0
                        st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                        st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["step"] += 1
                noise_mu = [local_noise(p, self.generator) for p in chunk]
                noise_nu = [local_noise(p, self.generator) for p in chunk]
                local = [local_tensor(p) for p in chunk]
                updates = scale_by_adam_bf16([local_tensor(p.grad) for p in chunk],
                                             [local_tensor(st["exp_avg"]) for st in states],
                                             [local_tensor(st["exp_avg_sq"]) for st in states], states[0]["step"],
                                             group["betas"], group["eps"], noise_mu, noise_nu)
                del noise_mu, noise_nu
                if group["weight_decay"]:
                    torch._foreach_add_(updates, torch._foreach_mul(local, group["weight_decay"]))
                torch._foreach_add_(local, torch._foreach_mul(updates, -group["lr"]))

    def state_dict(self) -> dict:
        return {**super().state_dict(), "generator": self.generator.get_state()}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        if "generator" in state_dict:  # a name-keyed (mesh) state restores it apart (training/trainer.py::TrainState)
            self.generator.set_state(state_dict.pop("generator"))
        super().load_state_dict(state_dict)
        # torch.optim casts floating state to the parameter's dtype on load: back to bf16 (exact)
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = st[key].to(torch.bfloat16)


def make_optimizer(
    config: OptimizerConfig, params: Iterable[torch.nn.Parameter]
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``params`` (fp32 moments, or :class:`AdamWBF16` with
    ``moments_dtype="bfloat16"``) and the LambdaLinear schedule on its
    rate; step the schedule once after every optimizer step."""
    kwargs = dict(lr=config.lr, betas=config.betas, eps=config.eps, weight_decay=config.weight_decay)
    if config.moments_dtype == "bfloat16":
        opt = AdamWBF16(params, seed=config.moments_seed, **kwargs)
    else:
        opt = torch.optim.AdamW(params, **kwargs)
    schedule = lambda_linear_schedule(
        config.warm_up_steps, config.f_start, config.f_max, config.f_min, config.cycle_lengths
    )
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32, on their device. With
    sharded tensors (DTensors) among them it is the whole tensors' norm, the
    same on every rank: each local shard's sum of squares over the number
    of ranks that hold that shard (parallel/mesh.py::copies), summed over
    every rank."""
    tensors = list(tensors)
    norms = torch._foreach_norm([local_tensor(t).float() for t in tensors])
    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack([n.square() / copies(t) for n, t in zip(norms, tensors)]).sum()
    return comm.all_reduce(sq).sqrt()


def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: grads scaled by max_norm / norm
    unless norm < max_norm, where ``norm`` is their :func:`global_norm`."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([local_tensor(g) for g in grads], scale)
