"""DMD2 few-step distillation, TrigFlow parameterization: what the streaming
loop reads.

Counterpart of part of cosmos_predict2_tpu/models/distillation.py: the
4-step inference times [pi/2, atan 15, atan 5, atan 5/3], the rectified-flow
TrigFlow scalings and ``DistillationConfig``'s fields. The sampler and the
trainer (``DistillationModel``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig

DEFAULT_SAMPLING_TIMES = (math.pi / 2, math.atan(15.0), math.atan(5.0), math.atan(5.0 / 3.0))


def trigflow_scalings_rf(t: torch.Tensor, sigma_data: float = 1.0):
    """(c_skip, c_out, c_in, c_noise) of the reference's
    RectifiedFlow_sCMWrapper at TrigFlow time ``t``: computed in fp64, then
    cast to fp32, as the JAX package does."""
    t = t.double()
    denom = torch.cos(t) + sigma_data * torch.sin(t)
    c_skip = sigma_data / denom
    c_out = -sigma_data * torch.sin(t) / denom
    c_in = sigma_data / denom
    c_noise = sigma_data * torch.sin(t) / denom
    return c_skip.float(), c_out.float(), c_in.float(), c_noise.float()


@dataclasses.dataclass(frozen=True)
class DistillationConfig:
    model: RFModelConfig = RFModelConfig()
    selected_sampling_time: tuple[float, ...] = DEFAULT_SAMPLING_TIMES
    scaling: str = "rectified_flow"  # or "edm"
    sigma_data: float = 1.0
    sigma_conditional: float = 1e-4
    teacher_guidance: float = 0.0
    student_update_freq: int = 5
    loss_scale_sid: float = 1.0
    loss_scale_fake_score: float = 1.0
    timestep_shift: float = 5.0  # critic time sampling shift
    # timestep that the nets were trained with (RF nets take c_noise * 1000)
    c_noise_scale: float = 1000.0
