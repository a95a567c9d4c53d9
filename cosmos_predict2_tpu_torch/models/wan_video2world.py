"""Wan2.1 Text2World / Image2World: the model over WanModel and its sampling.

Counterpart of cosmos_predict2_tpu/models/wan_video2world.py. Wan's i2v
conditioning replaces FRAME_REPLACE: the conditional frames enter as extra
input channels ``y = [mask x4 | masked latents]`` (20 channels for the
16-channel latent), and a CLIP image embedding (B, 257, 1280) feeds the
cross-attention's image branch: :func:`make_i2v_condition` encodes the
first pixel frame with the CLIP tower (text_encoders/clip_vision.py), as
JAX does, or takes the tokens precomputed.

``generate`` is UniPC at shift 5 with CFG against zero (or negative) text,
``uncond + g * (cond - uncond)``; the port runs the two branches as one
forward at batch 2B where JAX runs two. :func:`image2world` is the serving
path: the first frame and zeros through the Wan2.1 VAE encoder
(tokenizers/wan_vae_streaming.py, K2 on the card), the conditioned sampling,
and the decode. ``training_step`` is JAX's rectified-flow loss (logit-normal
train time at shift 5, the per-instance velocity MSE times ``loss_scale``)
with its draws explicit (:class:`WanTrainDraws`), so that
training/trainer.py drives it; it draws no conditioning dropout, as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cosmos_predict2_tpu_torch.networks.wan_dit import CLIP_TOKENS, WanConfig, WanModel
from cosmos_predict2_tpu_torch.schedulers import unipc
from cosmos_predict2_tpu_torch.schedulers.rectified_flow import RectifiedFlow, RectifiedFlowConfig


@dataclasses.dataclass(frozen=True)
class WanModelConfig:
    net: WanConfig = WanConfig()
    rectified_flow: RectifiedFlowConfig = RectifiedFlowConfig(shift=5.0, train_time_distribution="logitnormal")
    state_ch: int = 16
    state_t: int = 21  # Wan's 81 frames
    loss_scale: float = 1.0
    sampling_num_steps: int = 35
    sampling_shift: float = 5.0


@dataclasses.dataclass(frozen=True)
class WanCondition:
    """umT5 text, the CLIP image tokens, and the conditional latents with
    their (B, 1, T, 1, 1) frame mask for the i2v channels."""

    crossattn_emb: torch.Tensor  # (B, 512, 4096)
    clip_emb: Optional[torch.Tensor] = None  # (B, 257, 1280)
    gt_frames: Optional[torch.Tensor] = None  # (B, 16, T, h, w)
    condition_video_mask: Optional[torch.Tensor] = None  # (B, 1, T, 1, 1)
    padding_mask: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "WanCondition":
        return dataclasses.replace(self, **changes)


def make_i2v_condition(
    crossattn_emb: torch.Tensor,
    media_latents_B_C_T_H_W: torch.Tensor,
    clip_emb: Optional[torch.Tensor] = None,
    clip_tower=None,
    video_pm1_B_T_H_W_C: Optional[torch.Tensor] = None,
) -> WanCondition:
    """The i2v bundle (the reference's Wan2pt1CLIPEmb): with ``clip_tower``
    (text_encoders/clip_vision.CLIPVisionTower) and the pixel clip ([-1, 1],
    channels last) its first frame is CLIP-encoded, or the tokens come in
    as ``clip_emb``; either way latent frame 0 is conditional. Without them
    (text only) the CLIP context is zeros and no frame is."""
    B, _, T = media_latents_B_C_T_H_W.shape[:3]
    dev = media_latents_B_C_T_H_W.device
    if clip_tower is not None and video_pm1_B_T_H_W_C is not None:
        from cosmos_predict2_tpu_torch.text_encoders.clip_vision import encode_first_frame

        clip_emb = encode_first_frame(clip_tower, video_pm1_B_T_H_W_C)
    mask = torch.zeros((B, 1, T, 1, 1), device=dev)
    if clip_emb is None:
        clip_emb = torch.zeros((B, CLIP_TOKENS, 1280), device=dev)
    else:
        mask[:, :, :1] = 1.0
    return WanCondition(crossattn_emb=crossattn_emb, clip_emb=clip_emb, gt_frames=media_latents_B_C_T_H_W,
                        condition_video_mask=mask)


@dataclasses.dataclass(frozen=True)
class WanTrainDraws:
    """A Wan training step's draws: ``eps`` the noise, shaped like the
    latents, fp32, and ``u`` (B,) the train time in [0, 1)."""

    eps: torch.Tensor
    u: torch.Tensor

    def to(self, device) -> "WanTrainDraws":
        return WanTrainDraws(self.eps.to(device), self.u.to(device))


class WanVideo2WorldModel:
    """Training loss, denoising and sampling around a WanModel."""

    def __init__(self, config: WanModelConfig, net: WanModel):
        self.config = config
        self.net = net
        self.rectified_flow = RectifiedFlow(config.rectified_flow)

    def trainable_parameters(self) -> dict[str, torch.nn.Parameter]:
        """The parameters a trainer updates, by name: the net's that require grad."""
        return {n: p for n, p in self.net.named_parameters() if p.requires_grad}

    def _build_y(self, condition: WanCondition, latent_shape) -> Optional[torch.Tensor]:
        """The i2v input channels [mask x (extra - C) | masked latents], fp32."""
        if not self.config.net.i2v:
            return None
        B, C, T, H, W = latent_shape
        extra = self.config.net.in_dim - C
        dev = condition.crossattn_emb.device
        if condition.gt_frames is None or condition.condition_video_mask is None:
            return torch.zeros((B, extra, T, H, W), device=dev)
        mask = condition.condition_video_mask.float().expand(B, 1, T, H, W)
        return torch.cat([mask.expand(B, extra - C, T, H, W), condition.gt_frames.float() * mask], dim=1)

    def denoise(self, xt: torch.Tensor, timesteps_B: torch.Tensor, condition: WanCondition) -> torch.Tensor:
        """Velocity prediction, fp32."""
        y = self._build_y(condition, xt.shape)
        return self.net(
            xt.to(self.config.net.dtype), timesteps_B, condition.crossattn_emb, y_B_C_T_H_W=y,
            frame_cond_crossattn_emb=condition.clip_emb, padding_mask=condition.padding_mask,
        ).float()

    def sample_train_draws(self, generator: torch.Generator, latent_shape: tuple[int, ...]) -> WanTrainDraws:
        """One training step's draws, on the generator's device."""
        eps = torch.randn(latent_shape, generator=generator, device=generator.device)
        return WanTrainDraws(eps=eps, u=self.rectified_flow.sample_train_time(generator, latent_shape[0]))

    def training_step(self, x0_B_C_T_H_W: torch.Tensor, condition: WanCondition,
                      draws: WanTrainDraws) -> tuple[torch.Tensor, dict]:
        """The rectified-flow loss of one batch (JAX ``training_step``): x_t
        between the noise and the clean latents at the drawn time, the
        velocity MSE per instance, their mean times ``loss_scale``. Returns
        (loss, metrics) with ``loss`` detached."""
        rf = self.rectified_flow
        timesteps, sigmas = rf.discretize(draws.u)
        xt, v_target = rf.get_interpolation(draws.eps, x0_B_C_T_H_W.float(), sigmas)
        v_pred = self.denoise(xt, timesteps, condition)
        per_instance = torch.mean(torch.square(v_pred - v_target), dim=tuple(range(1, v_pred.ndim)))
        loss = torch.mean(per_instance) * self.config.loss_scale
        return loss, {"loss": loss.detach()}

    @torch.no_grad()
    def generate(
        self,
        noise: torch.Tensor,
        condition: WanCondition,
        guidance: float = 5.0,
        num_steps: Optional[int] = None,
        shift: Optional[float] = None,
        negative_text_embeddings: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """UniPC from ``noise`` (B, 16, T, h, w) -> fp32 latents; the
        unconditional branch takes zero text, or the negative prompt's."""
        cfg = self.config
        coeffs = unipc.set_timesteps(num_steps or cfg.sampling_num_steps, shift=shift or cfg.sampling_shift)
        uncond_text = (negative_text_embeddings if negative_text_embeddings is not None
                       else torch.zeros_like(condition.crossattn_emb))
        B = noise.shape[0]
        two = lambda t: None if t is None else torch.cat([t, t], dim=0)  # noqa: E731
        batched = condition.replace(
            crossattn_emb=torch.cat([condition.crossattn_emb, uncond_text.to(condition.crossattn_emb.dtype)], dim=0),
            clip_emb=two(condition.clip_emb), gt_frames=two(condition.gt_frames),
            condition_video_mask=two(condition.condition_video_mask), padding_mask=two(condition.padding_mask),
        )

        def velocity_fn(x: torch.Tensor, t: float) -> torch.Tensor:
            ts = torch.full((2 * B,), t, dtype=torch.float32, device=x.device)
            v = self.denoise(torch.cat([x, x], dim=0), ts, batched)
            cond_v, uncond_v = v[:B], v[B:]
            return uncond_v + guidance * (cond_v - uncond_v)

        return unipc.sample(velocity_fn, noise.float(), coeffs)


@torch.no_grad()
def encode_i2v_latents(vae, first_frame_B_H_W_C: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Wan's i2v conditioning video: the first frame ([-1, 1], channels
    last) followed by ``num_frames - 1`` zero frames, through the Wan2.1 VAE
    encoder (streaming; K2 on the card) -> (B, 16, T, h, w) fp32."""
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming

    B, H, W, C = first_frame_B_H_W_C.shape
    video = torch.zeros((B, num_frames, H, W, C), dtype=vae.config.dtype, device=first_frame_B_H_W_C.device)
    video[:, 0] = first_frame_B_H_W_C.to(vae.config.dtype)
    return encode_streaming(vae, video).float().permute(0, 4, 1, 2, 3)


@torch.no_grad()
def image2world(
    model: WanVideo2WorldModel,
    vae,
    first_frame_B_H_W_C: torch.Tensor,
    crossattn_emb: torch.Tensor,
    clip_emb: Optional[torch.Tensor],
    generator: torch.Generator,
    num_frames: int = 81,
    guidance: float = 5.0,
    num_steps: Optional[int] = None,
    clip_tower=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One i2v request: encode the conditioning video, sample, decode. The
    CLIP tokens: ``clip_emb``, or the first frame through ``clip_tower``.
    Returns (latents (B, 16, T, h, w) fp32, pixels (B, num_frames, H, W, 3)
    in [-1, 1], the VAE's dtype)."""
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming

    latents = encode_i2v_latents(vae, first_frame_B_H_W_C, num_frames)
    condition = make_i2v_condition(crossattn_emb, latents, clip_emb, clip_tower=clip_tower,
                                   video_pm1_B_T_H_W_C=first_frame_B_H_W_C[:, None])
    noise = torch.randn(latents.shape, generator=generator, device=generator.device).to(latents.device)
    out = model.generate(noise, condition, guidance=guidance, num_steps=num_steps)
    return out, decode_streaming(vae, out.permute(0, 2, 3, 4, 1).to(vae.config.dtype))
