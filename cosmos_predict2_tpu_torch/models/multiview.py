"""Auto-multiview Video2World (the 7-camera driving variant).

Counterpart of cosmos_predict2_tpu/models/multiview.py: the latent T axis
packs the views view-major, (V Tv); each view cross-attends its own
caption slice and takes the same RoPE table (networks/dit.py: ``n_views``,
``concat_view_embedding``); the condition marks the first k latent frames
of every view.

One departure from the JAX package: its ``generate`` rebuilds the mask
through ``edit_for_inference`` as frames [0, k) of the packed axis, which
conditions view 0 only. :meth:`MultiviewVid2VidModel.generate` keeps the
per-view mask of :meth:`~MultiviewVid2VidModel.set_multiview_condition`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig


def multiview_model_config(
    base_net: DiTConfig,
    n_views: int = 7,
    state_t: int = 8,
    concat_view_embedding: bool = True,
    view_condition_dim: int = 6,
    **model_kwargs,
) -> RFModelConfig:
    """The variant's RFModelConfig: ``state_t`` latent frames per view."""
    net = dataclasses.replace(
        base_net,
        n_views=n_views,
        concat_view_embedding=concat_view_embedding,
        view_condition_dim=view_condition_dim if concat_view_embedding else 0,
        concat_condition_mask=True,
    )
    return RFModelConfig(net=net, state_t=state_t * n_views, **model_kwargs)


class MultiviewVid2VidModel(Video2WorldModel):
    """Latents (B, C, V Tv, H, W); captions (B, V tokens_per_view, D)."""

    @property
    def n_views(self) -> int:
        return self.config.net.n_views

    def set_multiview_condition(
        self, condition: Video2WorldCondition, gt_frames: torch.Tensor, num_conditional_frames: int
    ) -> Video2WorldCondition:
        """gt_frames and the mask of the first k latent frames of every view."""
        B, _, VT = gt_frames.shape[:3]
        frame_in_view = torch.arange(VT, device=gt_frames.device) % (VT // self.n_views)
        mask = (frame_in_view < num_conditional_frames).to(gt_frames.dtype)
        return condition.replace(gt_frames=gt_frames, condition_video_mask=mask[None, None, :, None, None].expand(
            B, 1, VT, 1, 1))

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
        """UniPC with batched CFG, the first k frames of every view
        conditioned on both branches (the unconditional branch keeps the
        video condition, as Video2World's inference does)."""
        cond, uncond = self.cfg_pair(condition, negative_text_embeddings)
        if condition.gt_frames is not None:
            cond = self.set_multiview_condition(cond, condition.gt_frames, num_conditional_frames)
            uncond = self.set_multiview_condition(uncond, condition.gt_frames, num_conditional_frames)
            uncond = uncond.replace(use_video_condition=True)
        return self.sample(noise, cond, uncond, guidance, num_steps, shift)


def stack_views(per_view_latents: list[torch.Tensor]) -> torch.Tensor:
    """[V x (B, C, T, H, W)] -> (B, C, V T, H, W), view-major."""
    return torch.cat(per_view_latents, dim=2)


def unstack_views(latents: torch.Tensor, n_views: int) -> list[torch.Tensor]:
    return list(torch.chunk(latents, n_views, dim=2))


def view_grid(frames_per_view: list[np.ndarray], cols: int = 4) -> np.ndarray:
    """Per-view clips [(T, H, W, 3)] tiled row-major into one grid video."""
    V = len(frames_per_view)
    cols = min(cols, V)
    rows = (V + cols - 1) // cols
    T, H, W, C = frames_per_view[0].shape
    grid = np.zeros((T, rows * H, cols * W, C), dtype=frames_per_view[0].dtype)
    for i, clip in enumerate(frames_per_view):
        r, c = divmod(i, cols)
        grid[:, r * H : (r + 1) * H, c * W : (c + 1) * W] = clip
    return grid
