"""Camera-conditioned Video2World (novel view, camera trajectory control).

Counterpart of cosmos_predict2_tpu/models/camera.py: the latent T axis
packs [output chunk 0 | input (conditioning) chunk | output chunk 1], the
real clip in the middle; the model fills the chunks around it for the
target cameras. The camera embeddings (Plücker rays per token,
utils/camera_math.py) are reordered the same way and enter every DiT block
through its ``cam_encoder`` (networks/dit.py, ``camera_dim``).

Against plain Video2World: the mask marks latent frames [k, 2k), the
middle chunk; both CFG branches keep the video condition; the guidance is
cond + g (cond - uncond). The frame-init and autoregressive variants only
change the mask and the packing.
"""

from __future__ import annotations

from typing import Optional

import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition
from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel


def reorder_camera_chunks(camera: torch.Tensor, n_chunks: int = 3) -> torch.Tensor:
    """Dataset order [cam_in, cam_out0, cam_out1, ...] along axis 1 -> model
    order [cam_out0, cam_in, cam_out1, ...]."""
    chunks = torch.chunk(camera, n_chunks, dim=1)
    return torch.cat([chunks[1], chunks[0], *chunks[2:]], dim=1)


def reorder_camera_chunks_ar(camera: torch.Tensor) -> torch.Tensor:
    """Autoregressive dataset order [c0, c1, c2, c3, src] -> model order
    [c0, c1, src, c2, c3]."""
    c = torch.chunk(camera, 5, dim=1)
    return torch.cat([c[0], c[1], c[4], c[2], c[3]], dim=1)


def _frame_mask(gt_frames: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """(T,) bool over latent frames -> the (B, 1, T, 1, 1) mask (zeros for T == 1)."""
    B, _, T = gt_frames.shape[:3]
    if T == 1:
        frames = torch.zeros_like(frames)
    return frames.to(gt_frames.dtype)[None, None, :, None, None].expand(B, 1, T, 1, 1)


class CameraVideo2WorldModel(Video2WorldModel):
    """Latents (B, C, 3 Tc, H, W) with the conditioning clip in the middle."""

    def camera_frames(self, T: int, k: int) -> torch.Tensor:
        """The conditioning latent frames: [k, 2k)."""
        idx = torch.arange(T)
        return (idx >= k) & (idx < 2 * k)

    def set_camera_condition(
        self, condition: Video2WorldCondition, gt_frames: torch.Tensor, num_conditional_frames: int, **mask_options
    ) -> Video2WorldCondition:
        """gt_frames, the variant's mask over :meth:`camera_frames` and the
        video condition on."""
        frames = self.camera_frames(gt_frames.shape[2], num_conditional_frames, **mask_options)
        mask = _frame_mask(gt_frames, frames.to(gt_frames.device))
        return condition.replace(gt_frames=gt_frames, condition_video_mask=mask, use_video_condition=True)

    @torch.no_grad()
    def generate(
        self,
        noise: torch.Tensor,
        condition: Video2WorldCondition,
        guidance: float = 1.5,
        num_steps: Optional[int] = None,
        shift: Optional[float] = None,
        num_conditional_frames: int = 1,
        negative_text_embeddings: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """UniPC with the camera mask on both CFG branches."""
        cond, uncond = self.cfg_pair(condition, negative_text_embeddings)
        cond = self.set_camera_condition(cond, condition.gt_frames, num_conditional_frames)
        uncond = self.set_camera_condition(uncond, condition.gt_frames, num_conditional_frames)
        return self.sample(noise, cond, uncond, guidance, num_steps, shift)

    def pack_inference_latents(self, cond_latents: torch.Tensor) -> torch.Tensor:
        """[zeros | the encoded conditioning clip | zeros] along T."""
        z = torch.zeros_like(cond_latents)
        return torch.cat([z, cond_latents, z], dim=2)


class CameraFrameinitVideo2WorldModel(CameraVideo2WorldModel):
    """The frame-init variant: the same packing; the mask anchors frame 0
    and the first k frames of the middle and last chunks."""

    def camera_frames(self, T: int, k: int) -> torch.Tensor:
        idx, c = torch.arange(T), T // 3
        return (idx == 0) | ((idx >= c) & (idx < c + k)) | ((idx >= 2 * c) & (idx < 2 * c + k))


class CameraARVideo2WorldModel(CameraVideo2WorldModel):
    """The autoregressive variant: latents pack [cond0 | cond1 | out | cond2
    | cond3]; the mask covers the first 2k and the last 2k frames, and with
    ``lvg=True`` (long-video rollouts) 6 more frames into the output chunk."""

    def camera_frames(self, T: int, k: int, lvg: bool = False) -> torch.Tensor:
        idx = torch.arange(T)
        m = (idx < 2 * k) | (idx >= T - 2 * k)
        if lvg:
            m = m | ((idx >= 2 * k) & (idx < 2 * k + 6))
        return m

    def pack_inference_latents(self, cond_chunks: list[torch.Tensor], out_shape_latents: torch.Tensor) -> torch.Tensor:
        """[cond0 | cond1 | zeros like the output | cond2 | cond3]."""
        c0, c1, c2, c3 = cond_chunks
        return torch.cat([c0, c1, torch.zeros_like(out_shape_latents), c2, c3], dim=2)
