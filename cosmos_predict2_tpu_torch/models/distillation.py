"""DMD2 few-step distillation, TrigFlow parameterization: the 4-step
sampler and the two training phases.

Counterpart of cosmos_predict2_tpu/models/distillation.py (the reference's
distill/models/video2world_model_distill_dmd2.py losses and backward
simulation, modules/denoiser_scaling.py's TrigFlow scalings, and
generate_samples_from_batch_dmd2):

* three networks of one architecture: the student generator, the frozen
  teacher and the fake-score critic. JAX holds three parameter trees over
  one Flax module; here each is its own ``MiniTrainDIT``, and every method
  takes the net it runs.
* ``denoise_edm``: the x0 prediction under TrigFlow time, the conditional
  frames at time arctan(sigma_conditional / sigma_data) and replaced by
  the clean latents.
* ``backward_simulation``: the few-step sampler; x = x0_pred, re-noised to
  the next time with the same initial noise. Steps that carry no gradient
  run under ``torch.no_grad()`` (JAX's ``stop_gradient``: the same
  gradient, and no graph is kept).
* student phase: the DMD gradient trick (G - (G - grad).detach())^2 with
  the per-sample |G - teacher| normalization; critic phase: the fake-score
  denoising loss (G_x0 - fake_x0)^2 / sin(t)^2.
* the 4-step inference times [pi/2, atan 15, atan 5, atan 5/3].

Every random draw of a training step is one explicit :class:`DistillDraws`
value (``sample_distill_draws`` makes it from a ``torch.Generator``), so a
caller can hand in another source's draws, as the CPU tests hand in JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT

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


def trigflow_scalings_edm(t: torch.Tensor, sigma_data: float = 1.0):
    """The same for the reference's EDM_sCMWrapper: c_skip = sigma_data
    cos t, c_out = sigma_data sin t, c_in = 1, c_noise = log(sigma_data tan
    t) / 4; fp64, then fp32."""
    t = t.double()
    c_skip = sigma_data * torch.cos(t)
    c_out = sigma_data * torch.sin(t)
    c_in = torch.ones_like(t)
    c_noise = 0.25 * torch.log(torch.tan(t) * sigma_data)
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


@dataclasses.dataclass(frozen=True)
class DistillDraws:
    """Every random draw of one distillation step: ``time_D`` (B, 1) the
    critic's TrigFlow time, ``G_eps`` the generator's initial noise and
    ``D_eps`` the critic's re-noising noise, both shaped like the latents,
    fp32."""

    time_D: torch.Tensor
    G_eps: torch.Tensor
    D_eps: torch.Tensor

    def to(self, device) -> "DistillDraws":
        return DistillDraws(self.time_D.to(device), self.G_eps.to(device), self.D_eps.to(device))


class DistillationModel:
    """DMD2 sampler and losses over (student, teacher, fake-score) nets."""

    def __init__(self, config: DistillationConfig):
        self.config = config

    @property
    def scalings(self):
        return trigflow_scalings_rf if self.config.scaling == "rectified_flow" else trigflow_scalings_edm

    # ----------------------------- denoise -----------------------------

    def denoise_edm(
        self,
        net: MiniTrainDIT,
        xt_B_C_T_H_W: torch.Tensor,
        time_B_T: torch.Tensor,
        condition: Video2WorldCondition,
        return_F: bool = False,
    ):
        """x0 prediction (fp32) of ``net`` at TrigFlow time ``time_B_T``
        ((B,) or (B, T)); with ``return_F`` also the TrigFlow F prediction."""
        cfg = self.config
        sd = cfg.sigma_data
        xt = xt_B_C_T_H_W.float()
        if time_B_T.ndim == 1:
            time_B_T = time_B_T[:, None]
        time = time_B_T[:, None, :, None, None].float()

        mask = None
        if condition.is_video and condition.condition_video_mask is not None:
            mask = condition.condition_video_mask.float()
            t_cond = torch.atan(torch.tensor(cfg.sigma_conditional / sd, dtype=torch.float32, device=xt.device))
            time = t_cond * mask + time * (1.0 - mask)

        c_skip, c_out, c_in, c_noise = self.scalings(time, sd)
        net_in = xt * c_in
        if mask is not None:
            use_vc = torch.as_tensor(condition.use_video_condition, device=xt.device).float()
            if use_vc.ndim == 1:  # per-sample flag
                use_vc = use_vc.reshape(-1, 1, 1, 1, 1)
            gt_in = condition.gt_frames.float() / sd * use_vc
            net_in = gt_in * mask + net_in * (1.0 - mask)

        timesteps_B_T = c_noise[:, 0, :, 0, 0] * cfg.c_noise_scale
        net_out = net(
            net_in.to(net.cfg.dtype), timesteps_B_T, condition.crossattn_emb, fps=condition.fps,
            padding_mask=condition.padding_mask,
        ).float()

        x0 = c_skip * xt + c_out * net_out
        if mask is not None and cfg.model.denoise_replace_gt_frames:
            x0 = condition.gt_frames.float() * mask + x0 * (1.0 - mask)
        if return_F:
            return x0, (torch.cos(time) * xt - x0) / (torch.sin(time) * sd)
        return x0

    # --------------------------- few-step sampling ---------------------------

    def backward_simulation(
        self,
        student: MiniTrainDIT,
        condition: Video2WorldCondition,
        init_noise: torch.Tensor,
        n_steps: int,
        grad_on_last_step: bool = False,
    ) -> torch.Tensor:
        """Few-step TrigFlow sampler: x = x0_pred, re-noised to the next time
        with the same initial noise. With ``grad_on_last_step`` the last
        step records a graph; every other step runs under no_grad."""
        cfg = self.config
        t_steps = list(cfg.selected_sampling_time[:n_steps]) + [0.0]
        x = init_noise.float()
        B = x.shape[0]
        for count, (t_cur, t_next) in enumerate(zip(t_steps[:-1], t_steps[1:])):
            times = torch.full((B,), t_cur, dtype=torch.float32, device=x.device)
            with torch.set_grad_enabled(grad_on_last_step and count == n_steps - 1 and torch.is_grad_enabled()):
                x = self.denoise_edm(student, x, times, condition)
            if t_next > 1e-5:
                x = math.cos(t_next) * x / cfg.sigma_data + math.sin(t_next) * init_noise
        return x

    @torch.no_grad()
    def generate(
        self,
        student: MiniTrainDIT,
        noise: torch.Tensor,
        condition: Video2WorldCondition,
        num_steps: int = 4,
        num_conditional_frames: int = 1,
    ) -> torch.Tensor:
        """Distilled few-step inference (no CFG: guidance is distilled)."""
        if condition.is_video and condition.gt_frames is not None:
            condition = condition.edit_for_inference(True, num_conditional_frames)
        return torch.nan_to_num(self.backward_simulation(student, condition, noise, num_steps))

    # ------------------------------ training ------------------------------

    def training_time_D(self, u: torch.Tensor) -> torch.Tensor:
        """The critic's TrigFlow time (B, 1) from u ~ U[0, 1) (B,): sigma =
        shift u / (1 + (shift - 1) u), t = arctan(sigma / (1 - sigma))."""
        shift = self.config.timestep_shift
        sigma = shift * u / (1.0 + (shift - 1.0) * u)
        return torch.atan(sigma / (1.0 - sigma)).float()[:, None]

    def draw_training_time_D(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """:meth:`training_time_D` of uniform draws on the generator's device."""
        return self.training_time_D(torch.rand((batch_size,), generator=generator, device=generator.device))

    def sample_distill_draws(self, generator: torch.Generator, latent_shape: tuple[int, ...]) -> DistillDraws:
        """One step's draws, on the generator's device."""
        dev = generator.device
        return DistillDraws(
            time_D=self.draw_training_time_D(generator, latent_shape[0]),
            G_eps=torch.randn(latent_shape, generator=generator, device=dev),
            D_eps=torch.randn(latent_shape, generator=generator, device=dev),
        )

    def is_student_phase(self, iteration: int) -> bool:
        return (iteration + 1) % self.config.student_update_freq == 0

    def _critic_input(self, G_x0: torch.Tensor, draws: DistillDraws) -> torch.Tensor:
        D_time = draws.time_D[:, None, :, None, None]
        return G_x0 * torch.cos(D_time) / self.config.sigma_data + draws.D_eps * torch.sin(D_time)

    def training_step_generator(
        self,
        student: MiniTrainDIT,
        teacher: MiniTrainDIT,
        fake_score: MiniTrainDIT,
        x0_B_C_T_H_W: torch.Tensor,
        condition: Video2WorldCondition,
        uncondition: Optional[Video2WorldCondition],
        n_steps: int,
        draws: DistillDraws,
    ) -> tuple[torch.Tensor, dict]:
        """The student's DMD loss; its graph reaches the student's last
        backward-simulation step only. Returns (loss, metrics)."""
        cfg = self.config
        G_x0 = self.backward_simulation(student, condition, draws.G_eps, n_steps, grad_on_last_step=True)
        D_xt = self._critic_input(G_x0, draws)
        with torch.no_grad():
            D_xt_ = D_xt.detach()
            fake_x0 = self.denoise_edm(fake_score, D_xt_, draws.time_D, condition)
            teacher_x0 = self.denoise_edm(teacher, D_xt_, draws.time_D, condition)
            if cfg.teacher_guidance > 0.0 and uncondition is not None:
                teacher_x0_uncond = self.denoise_edm(teacher, D_xt_, draws.time_D, uncondition)
                teacher_x0 = teacher_x0 + cfg.teacher_guidance * (teacher_x0 - teacher_x0_uncond)
            weight = torch.mean(torch.abs(G_x0 - teacher_x0), dim=(1, 2, 3, 4), keepdim=True).clamp(min=1e-5)
            grad = (fake_x0 - teacher_x0) / weight
        loss_dmd = torch.nan_to_num(torch.square(G_x0 - (G_x0 - grad).detach()))
        loss = torch.mean(cfg.loss_scale_sid * torch.mean(loss_dmd, dim=(1, 2, 3, 4)))
        return loss, {"dmd_loss_generator": loss.detach(), "grad_norm_dmd": torch.mean(torch.abs(grad))}

    def training_step_critic(
        self,
        student: MiniTrainDIT,
        fake_score: MiniTrainDIT,
        x0_B_C_T_H_W: torch.Tensor,
        condition: Video2WorldCondition,
        n_steps: int,
        draws: DistillDraws,
    ) -> tuple[torch.Tensor, dict]:
        """The fake-score net's denoising loss on the student's samples
        (which carry no gradient). Returns (loss, metrics)."""
        cfg = self.config
        with torch.no_grad():
            G_x0 = self.backward_simulation(student, condition, draws.G_eps, n_steps)
        D_xt = self._critic_input(G_x0, draws)
        fake_x0 = self.denoise_edm(fake_score, D_xt, draws.time_D, condition)
        D_time = draws.time_D[:, None, :, None, None]
        per_sample = torch.mean(torch.square(G_x0 - fake_x0) / torch.square(torch.sin(D_time)), dim=(1, 2, 3, 4))
        loss = torch.mean(cfg.loss_scale_fake_score * per_sample)
        return loss, {"dmd_loss_critic": loss.detach()}
