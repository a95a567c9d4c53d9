"""Rectified-flow Video2World / Text2World / Image2World: training loss and sampling.

Counterpart of cosmos_predict2_tpu/models/video2world.py:

* ``denoise``: velocity prediction with FRAME_REPLACE conditioning — the
  first k latent frames of x_t are replaced by the clean latents and their
  predicted velocity by the ground-truth velocity (noise - x0).
* ``training_step``: sample k conditional frames and a train time,
  interpolate x_t = eps*t + x0*(1-t), predict the velocity, masked MSE.
  Every random draw of a step is one explicit :class:`TrainDraws` value
  (``sample_train_draws`` makes it from a ``torch.Generator``), so a caller
  can also hand in another source's draws.
* ``velocity_fn_from_condition``: CFG with conditional and unconditional
  branches batched into one forward at batch 2B.
* ``generate``: the UniPC loop, stepped from the host, one CFG forward per
  step.

Text2World is zero conditional frames; Image2World is one.
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
from cosmos_predict2_tpu_torch.schedulers.rectified_flow import RectifiedFlow, RectifiedFlowConfig


@dataclasses.dataclass(frozen=True)
class RFModelConfig:
    net: DiTConfig = DiTConfig()
    rectified_flow: RectifiedFlowConfig = RectifiedFlowConfig(shift=5.0, train_time_distribution="logitnormal")
    state_ch: int = 16
    state_t: int = 24
    resolution: str = "720"
    loss_scale: float = 10.0
    # conditional frames drawn per training sample: from
    # conditional_frames_probs ((k, p), ...) or else uniform in [min, max]
    min_num_conditional_frames: int = 0
    max_num_conditional_frames: int = 2
    conditional_frames_probs: Optional[tuple[tuple[int, float], ...]] = ((0, 0.5), (1, 0.25), (2, 0.25))
    denoise_replace_gt_frames: bool = True
    conditional_frame_timestep: float = -1.0
    # training-time conditioning dropout (text per sample, video flag per batch)
    text_dropout_rate: float = 0.2
    video_cond_dropout_rate: float = 0.2
    # CFG composition: "v2w" => cond + g*(cond-uncond); "t2w" => uncond + g*(cond-uncond)
    cfg_mode: str = "v2w"
    sampling_num_steps: int = 35
    sampling_shift: float = 5.0
    use_karras_sigma_at_inference: bool = False
    # high-sigma strategy: a fraction of training samples takes a timestep
    # drawn from [high_sigma_timesteps_min, high_sigma_timesteps_max]
    use_high_sigma_strategy: bool = False
    high_sigma_ratio: float = 0.05
    high_sigma_timesteps_min: int = 980
    high_sigma_timesteps_max: int = 1000


@dataclasses.dataclass(frozen=True)
class TrainDraws:
    """Every random draw of one training step.

    ``text_keep`` (B,) bool and ``use_video`` () bool are the conditioning
    dropout; ``num_conditional_frames`` (B,) int; ``eps`` the noise, shaped
    like the latents, fp32; ``u`` (B,) the train time in [0, 1);
    ``high_sigma`` (B,) bool and ``high_sigma_index`` (B,) int (schedule
    indices), set when the high-sigma strategy is on.
    """

    text_keep: torch.Tensor
    use_video: torch.Tensor
    num_conditional_frames: torch.Tensor
    eps: torch.Tensor
    u: torch.Tensor
    high_sigma: Optional[torch.Tensor] = None
    high_sigma_index: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainDraws":
        return TrainDraws(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _per_sample_flag(flag, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(flag, dtype=torch.bool, device=device).expand(batch)


class Video2WorldModel:
    """Training loss and sampling around a MiniTrainDIT module."""

    def __init__(self, config: RFModelConfig, net: MiniTrainDIT):
        self.config = config
        self.net = net
        self.rectified_flow = RectifiedFlow(config.rectified_flow)

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

    # --------------------------- training step ---------------------------

    def sample_num_conditional_frames(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Per-sample k (B,) int64 from conditional_frames_probs, or uniform
        in [min, max], drawn on the generator's device."""
        cfg = self.config
        dev = generator.device
        if cfg.conditional_frames_probs is not None:
            options = torch.tensor([k for k, _ in cfg.conditional_frames_probs], device=dev)
            probs = torch.tensor([p for _, p in cfg.conditional_frames_probs], device=dev)
            return options[torch.multinomial(probs, batch_size, replacement=True, generator=generator)]
        return torch.randint(cfg.min_num_conditional_frames, cfg.max_num_conditional_frames + 1, (batch_size,),
                             generator=generator, device=dev)

    def sample_train_draws(self, generator: torch.Generator, latent_shape: tuple[int, ...]) -> TrainDraws:
        """One training step's draws, on the generator's device."""
        cfg = self.config
        B, dev = latent_shape[0], generator.device
        rf = self.rectified_flow
        draws = dict(
            text_keep=torch.rand((B,), generator=generator, device=dev) < 1.0 - cfg.text_dropout_rate,
            use_video=torch.rand((), generator=generator, device=dev) < 1.0 - cfg.video_cond_dropout_rate,
            num_conditional_frames=self.sample_num_conditional_frames(generator, B),
            eps=torch.randn(latent_shape, generator=generator, device=dev),
            u=rf.sample_train_time(generator, B),
        )
        if cfg.use_high_sigma_strategy:
            cand = torch.as_tensor(rf.high_sigma_candidates(cfg.high_sigma_timesteps_min, cfg.high_sigma_timesteps_max),
                                   device=dev)
            draws["high_sigma"] = torch.rand((B,), generator=generator, device=dev) < cfg.high_sigma_ratio
            draws["high_sigma_index"] = cand[torch.randint(0, len(cand), (B,), generator=generator, device=dev)]
        return TrainDraws(**draws)

    def training_step(
        self, x0_B_C_T_H_W: torch.Tensor, condition: Video2WorldCondition, draws: TrainDraws
    ) -> tuple[torch.Tensor, dict]:
        """Loss for one batch of clean latents and its condition (conditioning
        dropout already applied by the caller, as in the reference trainer).
        Returns (loss, metrics) with ``loss``, ``sigma_mean`` and
        ``per_instance_loss`` detached."""
        cfg = self.config
        rf = self.rectified_flow
        if condition.is_video and condition.gt_frames is not None:
            condition = condition.set_video_condition(condition.gt_frames, draws.num_conditional_frames)
        timesteps, sigmas = rf.discretize(draws.u)
        if cfg.use_high_sigma_strategy:
            timesteps, sigmas = rf.apply_high_sigma(timesteps, sigmas, draws.high_sigma, draws.high_sigma_index)
        xt, v_target = rf.get_interpolation(draws.eps, x0_B_C_T_H_W.float(), sigmas)
        v_pred = self.denoise(draws.eps, xt, timesteps[:, None], condition)
        per_instance = torch.mean(torch.square(v_pred - v_target), dim=tuple(range(1, v_pred.ndim)))
        loss = torch.mean(rf.time_weight(timesteps) * per_instance) * cfg.loss_scale
        return loss, {"loss": loss.detach(), "sigma_mean": sigmas.mean(), "per_instance_loss": per_instance.detach()}

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

    @torch.no_grad()
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
