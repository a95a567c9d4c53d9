"""Rectified-flow Video2World / Text2World / Image2World sampling.

Counterpart of cosmos_predict2_tpu/models/video2world.py (inference part):

* ``denoise``: velocity prediction with FRAME_REPLACE conditioning — the
  first k latent frames of x_t are replaced by the clean latents and their
  predicted velocity by the ground-truth velocity (noise - x0).
* ``velocity_fn_from_condition``: CFG with conditional and unconditional
  branches batched into one forward at batch 2B.
* ``generate``: the UniPC loop, stepped from the host, one CFG forward per
  step.

Text2World is zero conditional frames; Image2World is one. ``training_step``
waits for the training port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import (
    Video2WorldCondition,
    get_condition_uncondition,
    get_condition_with_negative_prompt,
)
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT
from cosmos_predict2_tpu_torch.schedulers import unipc


@dataclasses.dataclass(frozen=True)
class RFModelConfig:
    net: DiTConfig = DiTConfig()
    state_ch: int = 16
    state_t: int = 24
    resolution: str = "720"
    denoise_replace_gt_frames: bool = True
    conditional_frame_timestep: float = -1.0
    # CFG composition: "v2w" => cond + g*(cond-uncond); "t2w" => uncond + g*(cond-uncond)
    cfg_mode: str = "v2w"
    sampling_num_steps: int = 35
    sampling_shift: float = 5.0
    use_karras_sigma_at_inference: bool = False


def _per_sample_flag(flag, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(flag, dtype=torch.bool, device=device).expand(batch)


class Video2WorldModel:
    """Sampling around a MiniTrainDIT module."""

    def __init__(self, config: RFModelConfig, net: MiniTrainDIT):
        self.config = config
        self.net = net

    @torch.no_grad()
    def denoise(
        self,
        noise: Optional[torch.Tensor],
        xt_B_C_T_H_W: torch.Tensor,
        timesteps_B_T: torch.Tensor,
        condition: Video2WorldCondition,
    ) -> torch.Tensor:
        """Velocity prediction (fp32) with FRAME_REPLACE conditioning."""
        cfg = self.config
        dtype = xt_B_C_T_H_W.dtype
        mask = None
        if condition.is_video and condition.condition_video_mask is not None:
            mask = condition.condition_video_mask.to(dtype)  # (B, 1, T, 1, 1)
            use_vc = torch.as_tensor(condition.use_video_condition, device=xt_B_C_T_H_W.device).to(dtype)
            if use_vc.ndim == 1:  # per-sample flag (batched CFG)
                use_vc = use_vc.reshape(-1, 1, 1, 1, 1)
            gt_in = condition.gt_frames.to(dtype) * use_vc
            xt_B_C_T_H_W = gt_in * mask + xt_B_C_T_H_W * (1.0 - mask)
            if cfg.conditional_frame_timestep >= 0:
                if timesteps_B_T.ndim == 1:
                    timesteps_B_T = timesteps_B_T[:, None]
                t_mask = mask[:, 0, :, 0, 0]  # (B, T)
                timesteps_B_T = timesteps_B_T.expand(t_mask.shape)
                timesteps_B_T = cfg.conditional_frame_timestep * t_mask + timesteps_B_T * (1.0 - t_mask)

        v_pred = self.net(
            xt_B_C_T_H_W, timesteps_B_T, condition.crossattn_emb, fps=condition.fps, padding_mask=condition.padding_mask
        ).float()

        if mask is not None and cfg.denoise_replace_gt_frames:
            gt_velocity = noise.float() - condition.gt_frames.float()
            maskf = mask.float()
            v_pred = gt_velocity * maskf + v_pred * (1.0 - maskf)
        return v_pred

    def velocity_fn_from_condition(
        self,
        condition: Video2WorldCondition,
        uncondition: Video2WorldCondition,
        guidance: float,
        noise: torch.Tensor,
    ) -> Callable[[torch.Tensor, float], torch.Tensor]:
        """CFG velocity with cond and uncond batched into one forward (2B)."""
        cfg = self.config
        B = noise.shape[0]

        def stack(a, b):
            if a is None or b is None:
                return a if a is not None else b
            return torch.cat([a, b], dim=0)

        batched = condition.replace(
            crossattn_emb=stack(condition.crossattn_emb, uncondition.crossattn_emb),
            fps=stack(condition.fps, uncondition.fps),
            padding_mask=stack(condition.padding_mask, uncondition.padding_mask),
            gt_frames=stack(condition.gt_frames, uncondition.gt_frames),
            condition_video_mask=stack(condition.condition_video_mask, uncondition.condition_video_mask),
            use_video_condition=torch.cat([
                _per_sample_flag(condition.use_video_condition, B, noise.device),
                _per_sample_flag(uncondition.use_video_condition, B, noise.device),
            ]),
        )
        noise2 = torch.cat([noise, noise], dim=0)

        def velocity_fn(x: torch.Tensor, t: float) -> torch.Tensor:
            ts = torch.full((2 * B, 1), t, dtype=torch.float32, device=x.device)
            v = self.denoise(noise2, torch.cat([x, x], dim=0), ts, batched)
            cond_v, uncond_v = v[:B], v[B:]
            if cfg.cfg_mode == "v2w":
                return cond_v + guidance * (cond_v - uncond_v)
            return uncond_v + guidance * (cond_v - uncond_v)

        return velocity_fn

    def generate(
        self,
        noise: torch.Tensor,
        condition: Video2WorldCondition,
        guidance: float = 7.0,
        num_steps: Optional[int] = None,
        shift: Optional[float] = None,
        num_conditional_frames: int = 1,
        negative_text_embeddings: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """UniPC sampling from ``noise`` (B, C, T, H, W) -> fp32 latents."""
        cfg = self.config
        num_steps = num_steps or cfg.sampling_num_steps
        shift = shift if shift is not None else cfg.sampling_shift
        coeffs = unipc.set_timesteps(num_steps, shift=shift, use_karras_sigma=cfg.use_karras_sigma_at_inference)
        if negative_text_embeddings is not None:
            condition, uncondition = get_condition_with_negative_prompt(condition, negative_text_embeddings)
        else:
            condition, uncondition = get_condition_uncondition(condition)
        if condition.is_video and condition.gt_frames is not None:
            condition = condition.edit_for_inference(True, num_conditional_frames)
            uncondition = uncondition.edit_for_inference(False, num_conditional_frames)
        velocity_fn = self.velocity_fn_from_condition(condition, uncondition, guidance, noise.float())
        return unipc.sample(velocity_fn, noise.float(), coeffs)
