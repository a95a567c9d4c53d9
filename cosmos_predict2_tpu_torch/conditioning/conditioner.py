"""Conditioning: the Video2World condition and the CFG cond/uncond pairs.

Counterpart of cosmos_predict2_tpu/conditioning/conditioner.py, as a plain
dataclass of tensors:

* ``gt_frames`` (clean latents) with a (B, 1, T, 1, 1) ``condition_video_mask``
  marking the first k latent frames, and ``use_video_condition``;
* ``get_condition_uncondition``: the unconditional pass zeroes the text
  embedding and drops the video-condition flag;
* ``edit_for_inference``: at inference the unconditional branch keeps
  ``use_video_condition=True`` (no CFG on conditional frames);
* ``apply_train_dropout``: the training-time text and video-condition
  dropout, from draws the caller makes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


class DataType:
    IMAGE = "image"
    VIDEO = "video"


@dataclasses.dataclass(frozen=True)
class Video2WorldCondition:
    crossattn_emb: torch.Tensor  # (B, L, D_text)
    fps: Optional[torch.Tensor] = None  # (B,)
    padding_mask: Optional[torch.Tensor] = None  # (B, 1, H, W)
    data_type: str = DataType.VIDEO
    gt_frames: Optional[torch.Tensor] = None  # (B, C, T, H, W) clean latents
    condition_video_mask: Optional[torch.Tensor] = None  # (B, 1, T, 1, 1)
    # a Python bool (one flag for the batch) or a (B,) bool tensor
    use_video_condition: Union[bool, torch.Tensor, None] = None

    @property
    def is_video(self) -> bool:
        return self.data_type == DataType.VIDEO

    def replace(self, **changes) -> "Video2WorldCondition":
        return dataclasses.replace(self, **changes)

    def set_video_condition(
        self, gt_frames: torch.Tensor, num_conditional_frames: Union[int, torch.Tensor]
    ) -> "Video2WorldCondition":
        """gt_frames + the mask of latent frames [0, k); ``k`` is an int or a
        (B,) tensor of per-sample counts. All zeros for T == 1."""
        B, _, T, _, _ = gt_frames.shape
        if T == 1:
            mask = torch.zeros((B, 1, T, 1, 1), dtype=gt_frames.dtype, device=gt_frames.device)
        else:
            k = torch.as_tensor(num_conditional_frames, device=gt_frames.device).expand(B)
            frame_idx = torch.arange(T, device=gt_frames.device)
            mask = (frame_idx[None, :] < k[:, None]).to(gt_frames.dtype)  # (B, T)
            mask = mask[:, None, :, None, None]
        return self.replace(gt_frames=gt_frames, condition_video_mask=mask)

    def edit_for_inference(self, is_cfg_conditional: bool, num_conditional_frames: int) -> "Video2WorldCondition":
        cond = self.set_video_condition(self.gt_frames, num_conditional_frames)
        if not is_cfg_conditional:
            cond = cond.replace(use_video_condition=True)
        return cond


def make_condition(
    t5_text_embeddings: torch.Tensor,
    fps: Optional[torch.Tensor] = None,
    padding_mask: Optional[torch.Tensor] = None,
    data_type: str = DataType.VIDEO,
) -> Video2WorldCondition:
    return Video2WorldCondition(
        crossattn_emb=t5_text_embeddings,
        fps=fps,
        padding_mask=padding_mask,
        data_type=data_type,
        use_video_condition=True,
    )


def get_condition_uncondition(condition: Video2WorldCondition) -> tuple[Video2WorldCondition, Video2WorldCondition]:
    """CFG pair: cond (no dropout) and uncond (text zeroed, flag dropped)."""
    uncond = condition.replace(crossattn_emb=torch.zeros_like(condition.crossattn_emb), use_video_condition=False)
    return condition, uncond


def get_condition_with_negative_prompt(
    condition: Video2WorldCondition, negative_text_embeddings: torch.Tensor
) -> tuple[Video2WorldCondition, Video2WorldCondition]:
    """CFG pair whose unconditional branch uses the negative-prompt text."""
    uncond = condition.replace(crossattn_emb=negative_text_embeddings, use_video_condition=False)
    return condition, uncond


def apply_train_dropout(
    condition: Video2WorldCondition, text_keep: torch.Tensor, use_video: torch.Tensor
) -> Video2WorldCondition:
    """Training-time conditioning dropout from explicit draws: the text
    embedding of sample b is zeroed where ``text_keep[b]`` (B,) is False
    (TextAttr dropout), and ``use_video`` (one bool for the batch, as the
    reference's BooleanFlag) sets ``use_video_condition``."""
    emb = condition.crossattn_emb
    emb = emb * text_keep.to(device=emb.device, dtype=emb.dtype)[:, None, None]
    return condition.replace(crossattn_emb=emb, use_video_condition=use_video.to(emb.device))
