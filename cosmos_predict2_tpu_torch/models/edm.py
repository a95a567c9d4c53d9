"""The legacy EDM-parameterized Video2World model (before rectified flow).

Counterpart of cosmos_predict2_tpu/models/edm.py: EDM preconditioning
(c_skip, c_out, c_in, c_noise; c_noise times 1000, the net's timestep
convention) over the 2B DiT of models/video2world.py, with its
FRAME_REPLACE conditioning (clean latents in, and in the x0 out, on the
conditional frames), and CFG x0 sampling ``cond + g * (cond - uncond)``
through the Karras 2ab sampler (schedulers/edm_sampler.py). The two CFG
branches run as one forward at batch 2B. ``training_step`` is JAX's:
per-sample conditional frames drawn as the rectified-flow model draws them,
a log-normal sigma, the x0 MSE weighted by (sigma^2 + sd^2) / (sigma
sd)^2; its draws are explicit (:class:`EDMTrainDraws`), so that
training/trainer.py drives it; it draws no conditioning dropout, as JAX's.
"""

from __future__ import annotations

import dataclasses
import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition, get_condition_uncondition
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel, _per_sample_flag
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.schedulers import edm_sampler


@dataclasses.dataclass(frozen=True)
class EDMModelConfig:
    model: RFModelConfig = RFModelConfig()
    sigma_data: float = 0.5
    p_mean: float = -1.2  # log-normal training sigma
    p_std: float = 1.2
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    c_noise_scale: float = 1000.0


@dataclasses.dataclass(frozen=True)
class EDMTrainDraws:
    """An EDM training step's draws: ``num_conditional_frames`` (B,) int,
    ``sigma_n`` (B,) the standard normal of sigma = exp(p_mean + p_std n),
    and ``eps`` the noise, shaped like the latents, fp32."""

    num_conditional_frames: torch.Tensor
    sigma_n: torch.Tensor
    eps: torch.Tensor

    def to(self, device) -> "EDMTrainDraws":
        return EDMTrainDraws(self.num_conditional_frames.to(device), self.sigma_n.to(device), self.eps.to(device))


class EDMVideo2WorldModel:
    def __init__(self, config: EDMModelConfig, net: MiniTrainDIT):
        self.config = config
        self.net = net
        # the rectified-flow model over the same net draws the conditional frames, as in JAX
        self.base = Video2WorldModel(config.model, net)

    def trainable_parameters(self) -> dict[str, torch.nn.Parameter]:
        """The parameters a trainer updates, by name: the net's that require grad."""
        return self.base.trainable_parameters()

    def denoise(self, xt: torch.Tensor, sigma_B: torch.Tensor, condition: Video2WorldCondition) -> torch.Tensor:
        """x0 prediction (fp32) with EDM preconditioning and FRAME_REPLACE.
        ``condition.use_video_condition`` is a bool or a (B,) bool tensor."""
        cfg = self.config
        sigma = sigma_B.reshape(-1, 1, 1, 1, 1).float()
        c_skip, c_out, c_in, c_noise = edm_sampler.edm_scalings(sigma, cfg.sigma_data)
        xt = xt.float()
        net_in = xt * c_in
        mask = None
        if condition.is_video and condition.condition_video_mask is not None:
            mask = condition.condition_video_mask.float()
            use_vc = torch.as_tensor(condition.use_video_condition, device=xt.device).float()
            if use_vc.ndim == 1:
                use_vc = use_vc.reshape(-1, 1, 1, 1, 1)
            gt_in = condition.gt_frames.float() * use_vc
            net_in = gt_in * c_in * mask + net_in * (1.0 - mask)
        ts = c_noise[:, 0, 0, 0, 0].expand(xt.shape[0]) * cfg.c_noise_scale
        net_out = self.net(net_in.to(cfg.model.net.dtype), ts, condition.crossattn_emb, fps=condition.fps,
                           padding_mask=condition.padding_mask).float()
        x0 = c_skip * xt + c_out * net_out
        if mask is not None and cfg.model.denoise_replace_gt_frames:
            x0 = condition.gt_frames.float() * mask + x0 * (1.0 - mask)
        return x0

    def sample_train_draws(self, generator: torch.Generator, latent_shape: tuple[int, ...]) -> EDMTrainDraws:
        """One training step's draws, on the generator's device."""
        B, dev = latent_shape[0], generator.device
        return EDMTrainDraws(
            num_conditional_frames=self.base.sample_num_conditional_frames(generator, B),
            sigma_n=torch.randn((B,), generator=generator, device=dev),
            eps=torch.randn(latent_shape, generator=generator, device=dev),
        )

    def training_step(self, x0_B_C_T_H_W: torch.Tensor, condition: Video2WorldCondition,
                      draws: EDMTrainDraws) -> tuple[torch.Tensor, dict]:
        """The EDM loss of one batch (JAX ``training_step``). Returns (loss,
        metrics) with ``loss`` detached and ``sigma_mean``."""
        cfg = self.config
        if condition.is_video and condition.gt_frames is not None:
            condition = condition.set_video_condition(condition.gt_frames, draws.num_conditional_frames)
        sigma = torch.exp(cfg.p_mean + cfg.p_std * draws.sigma_n.float())
        x0 = x0_B_C_T_H_W.float()
        x0_pred = self.denoise(x0 + sigma.reshape(-1, 1, 1, 1, 1) * draws.eps, sigma, condition)
        sd = cfg.sigma_data
        weight = (sigma**2 + sd**2) / torch.square(sigma * sd)
        per_instance = torch.mean(torch.square(x0_pred - x0), dim=tuple(range(1, x0_pred.ndim)))
        loss = torch.mean(weight * per_instance)
        return loss, {"loss": loss.detach(), "sigma_mean": sigma.mean()}

    @torch.no_grad()
    def generate(
        self,
        noise: torch.Tensor,
        condition: Video2WorldCondition,
        guidance: float = 7.0,
        num_steps: int = 35,
        num_conditional_frames: int = 1,
    ) -> torch.Tensor:
        """The 2ab sampler from ``noise * sigma_max`` -> fp32 latents."""
        cfg = self.config
        condition, uncondition = get_condition_uncondition(condition)
        if condition.is_video and condition.gt_frames is not None:
            condition = condition.edit_for_inference(True, num_conditional_frames)
            uncondition = uncondition.edit_for_inference(False, num_conditional_frames)
        B = noise.shape[0]
        two = lambda a, b: None if a is None else torch.cat([a, b], dim=0)  # noqa: E731
        batched = condition.replace(
            crossattn_emb=two(condition.crossattn_emb, uncondition.crossattn_emb),
            fps=two(condition.fps, uncondition.fps),
            padding_mask=two(condition.padding_mask, uncondition.padding_mask),
            gt_frames=two(condition.gt_frames, uncondition.gt_frames),
            condition_video_mask=two(condition.condition_video_mask, uncondition.condition_video_mask),
            use_video_condition=torch.cat([_per_sample_flag(condition.use_video_condition, B, noise.device),
                                           _per_sample_flag(uncondition.use_video_condition, B, noise.device)]),
        )

        def x0_fn(x: torch.Tensor, sigma: float) -> torch.Tensor:
            sb = torch.full((2 * B,), sigma, dtype=torch.float32, device=x.device)
            x0 = self.denoise(torch.cat([x, x], dim=0), sb, batched)
            cond_x0, uncond_x0 = x0[:B], x0[B:]
            return cond_x0 + guidance * (cond_x0 - uncond_x0)

        return edm_sampler.sample(x0_fn, noise.float() * cfg.sigma_max, num_steps=num_steps, sigma_min=cfg.sigma_min,
                                  sigma_max=cfg.sigma_max, rho=cfg.rho)
