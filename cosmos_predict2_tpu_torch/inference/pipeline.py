"""Video2World inference pipeline, streaming-VAE route.

Counterpart of cosmos_predict2_tpu/inference/pipeline.py::Video2WorldInference
with ``streaming_vae=True``: uint8 clip -> streaming VAE encode -> UniPC with
batched CFG and FRAME_REPLACE conditioning (or, with ``sampler="dmd2"``, the
distilled 4-step TrigFlow sampler without CFG) -> streaming VAE decode.
Input prep follows the reference: an image becomes frame 0 of a zero video;
a video contributes its last 4(k-1)+1 frames, padded with its last frame.
Autoregressive mode waits for a later port.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cosmos_predict2_tpu_torch.conditioning.conditioner import DataType, make_condition
from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, DistillationModel
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming
from cosmos_predict2_tpu_torch.utils.io import get_resolution, read_image, read_video
from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")
_VIDEO_EXTS = (".mp4", ".webm", ".mkv", ".mov")


def resize_input(frames_thwc: np.ndarray, height: int, width: int) -> np.ndarray:
    """Aspect-preserving bilinear resize + center crop of uint8 (T, H, W, 3)."""
    t, h, w, _ = frames_thwc.shape
    scale = max(width / w, height / h)
    rh, rw = int(math.ceil(scale * h)), int(math.ceil(scale * w))
    x = torch.tensor(frames_thwc).permute(0, 3, 1, 2).float()
    resized = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False)
    resized = resized.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    top, left = (rh - height) // 2, (rw - width) // 2
    return resized[:, top : top + height, left : left + width]


def image_to_input(img_hw3: np.ndarray, num_video_frames: int) -> np.ndarray:
    """uint8 (H, W, 3) image -> (1, 3, T, H, W): frame 0 is the image, the rest zeros."""
    frames = np.zeros((num_video_frames,) + img_hw3.shape, dtype=np.uint8)
    frames[0] = img_hw3
    return frames.transpose(3, 0, 1, 2)[None]


def video_to_input(frames_thw3: np.ndarray, num_video_frames: int, num_latent_conditional_frames: int = 2) -> np.ndarray:
    """uint8 (T, H, W, 3) video -> (1, 3, T', H, W): its last 4(k-1)+1 frames,
    padded with the last frame to ``num_video_frames``."""
    if num_latent_conditional_frames not in (1, 2):
        raise ValueError(f"num_latent_conditional_frames must be 1 or 2, got {num_latent_conditional_frames}")
    k = 4 * (num_latent_conditional_frames - 1) + 1
    if frames_thw3.shape[0] < k:
        raise ValueError(f"video has {frames_thw3.shape[0]} frames, needs >= {k}")
    extracted = frames_thw3[-k:]
    if num_video_frames > k:
        full = np.concatenate([extracted, np.repeat(extracted[-1:], num_video_frames - k, axis=0)], axis=0)
    else:
        full = extracted[:num_video_frames]
    return full.transpose(3, 0, 1, 2)[None]


def read_and_process_image(path: str, height: int, width: int, num_video_frames: int) -> np.ndarray:
    return image_to_input(resize_input(read_image(path)[None], height, width)[0], num_video_frames)


def read_and_process_video(
    path: str, height: int, width: int, num_video_frames: int, num_latent_conditional_frames: int = 2
) -> np.ndarray:
    frames, _ = read_video(path)
    clip = video_to_input(frames, num_video_frames, num_latent_conditional_frames)[0].transpose(1, 2, 3, 0)
    return resize_input(clip, height, width).transpose(3, 0, 1, 2)[None]


@dataclasses.dataclass
class InferenceSetup:
    model_config: RFModelConfig
    vae_config: WanVAEConfig = WanVAEConfig()
    resolution: str = "480"
    aspect: str = "16,9"
    # explicit (height, width), divisible by 16 (VAE /8 x patch /2)
    size_override: Optional[tuple[int, int]] = None
    # latent frames per streaming-decode chunk after the first (exact for any size)
    decode_chunk_latent_frames: int = 2


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Video2WorldInference:
    """End-to-end Text2World / Image2World / Video2World generation.

    ``last_timings`` holds the split of the latest request, in seconds:
    ``vae_encode_s``, ``denoise_s``, ``denoise_step_s`` (per step),
    ``vae_decode_s``, each ending in a device synchronize.
    """

    def __init__(
        self,
        setup: InferenceSetup,
        net: MiniTrainDIT,
        vae: WanVAE,
        text_encoder: Optional[Callable[[list[str]], torch.Tensor]] = None,
    ):
        self.setup = setup
        self.net = net
        self.vae = vae
        self.model = Video2WorldModel(setup.model_config, net)
        self.distilled = DistillationModel(DistillationConfig(model=setup.model_config))
        self.text_encoder = text_encoder
        self.device = next(net.parameters()).device
        self.last_timings: dict[str, float] = {}

    @property
    def num_video_frames(self) -> int:
        return (self.setup.model_config.state_t - 1) * 4 + 1

    def video_size(self) -> tuple[int, int]:
        if self.setup.size_override is not None:
            return self.setup.size_override
        w, h = get_resolution(self.setup.resolution, self.setup.aspect)
        return h, w

    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        if self.text_encoder is None:
            raise ValueError("No text encoder attached: pass precomputed embeddings or construct with text_encoder=...")
        return self.text_encoder(prompts)

    def _as_device(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a).to(self.device)

    def _run_streaming(self, video_u8, text_emb, neg_text_emb, noise, guidance, num_steps, num_conditional_frames,
                       pixel_format="float", sampler="unipc") -> torch.Tensor:
        """Encode, sample, decode; ``sampler="dmd2"`` samples with the
        distilled few-step TrigFlow loop (``num_steps`` of its times, no
        CFG: the guidance and negative prompt are not used)."""
        times: dict[str, float] = {}
        t0 = time.perf_counter()
        clip = torch.tensor(video_u8).to(self.device).permute(0, 2, 3, 4, 1)
        latents = encode_streaming(self.vae, clip, pixel_format="uint8")
        gt_latents = latents.permute(0, 4, 1, 2, 3).float()
        _sync(self.device)
        t1 = time.perf_counter()
        condition = make_condition(self._as_device(text_emb), data_type=DataType.VIDEO).replace(gt_frames=gt_latents)
        if sampler == "dmd2":
            samples = self.distilled.generate(self.net, noise, condition, num_steps=num_steps,
                                              num_conditional_frames=num_conditional_frames)
        else:
            samples = self.model.generate(
                noise,
                condition,
                guidance=guidance,
                num_steps=num_steps,
                num_conditional_frames=num_conditional_frames,
                negative_text_embeddings=self._as_device(neg_text_emb),
            )
        if not torch.isfinite(samples).all():
            raise FloatingPointError("sampling produced non-finite latents")
        _sync(self.device)
        t2 = time.perf_counter()
        frames = decode_streaming(
            self.vae,
            samples.to(self.vae.config.dtype).permute(0, 2, 3, 4, 1),
            chunk_latent_frames=self.setup.decode_chunk_latent_frames,
            pixel_format=pixel_format,
        )
        _sync(self.device)
        t3 = time.perf_counter()
        steps = num_steps or self.setup.model_config.sampling_num_steps
        times.update(vae_encode_s=t1 - t0, denoise_s=t2 - t1, denoise_step_s=(t2 - t1) / steps, vae_decode_s=t3 - t2)
        self.last_timings = times
        return frames

    @torch.no_grad()
    def generate_vid2world(
        self,
        video_u8: np.ndarray,
        text_emb,
        neg_text_emb=None,
        guidance: float = 7.0,
        num_steps: int = 35,
        num_conditional_frames: int = 1,
        seed: int = 1,
        pixel_format: str = "float",
        sampler: str = "unipc",
    ) -> np.ndarray:
        """(1, 3, T, H, W) uint8 -> (T, H, W, 3) float in [-1, 1] (default)
        or uint8 [0, 255] with ``pixel_format="uint8"`` (quantized on the
        device). ``sampler``: "unipc" (CFG) or "dmd2" (the distilled
        few-step path: min(num_steps, 4) steps, no CFG)."""
        if pixel_format not in ("float", "uint8"):
            raise ValueError(f"unknown pixel_format {pixel_format!r}")
        if sampler not in ("unipc", "dmd2"):
            raise ValueError(f"unknown sampler {sampler!r}")
        mc = self.setup.model_config
        _, _, T, H, W = video_u8.shape
        noise = arch_invariant_rand((1, mc.state_ch, 1 + (T - 1) // 4, H // 8, W // 8), seed=seed, device=self.device)
        if sampler == "dmd2":
            num_steps = min(num_steps, len(self.distilled.config.selected_sampling_time))
        frames = self._run_streaming(
            video_u8, text_emb, neg_text_emb, noise, guidance, num_steps, num_conditional_frames, pixel_format, sampler
        )
        return self._to_pixel_format(frames)[0]

    @torch.no_grad()
    def generate_vid2world_batch(
        self,
        video_u8: np.ndarray,  # (B, 3, T, H, W) uint8
        text_emb,  # (B, L, D)
        neg_text_emb=None,
        guidance: float = 7.0,
        num_steps: int = 35,
        num_conditional_frames: int = 1,
        seeds: Optional[list[int]] = None,
        pixel_format: str = "float",
    ) -> np.ndarray:
        """N same-geometry requests in one sampling pass (CFG at batch 2N)
        -> (B, T, H, W, 3); per-sample seeds give the single-request noise."""
        B, _, T, H, W = video_u8.shape
        mc = self.setup.model_config
        seeds = seeds if seeds is not None else list(range(1, B + 1))
        if len(seeds) != B:
            raise ValueError(f"need {B} seeds, got {len(seeds)}")
        per = (1, mc.state_ch, 1 + (T - 1) // 4, H // 8, W // 8)
        noise = torch.cat([arch_invariant_rand(per, seed=s, device=self.device) for s in seeds], dim=0)
        frames = self._run_streaming(
            video_u8, text_emb, neg_text_emb, noise, guidance, num_steps, num_conditional_frames, pixel_format
        )
        return self._to_pixel_format(frames)

    @staticmethod
    def _to_pixel_format(frames: torch.Tensor) -> np.ndarray:
        """The decode's output on the host: uint8 as it is (quantized on the
        device), float pixels as fp32."""
        frames = frames.cpu()
        return frames.numpy() if frames.dtype == torch.uint8 else frames.float().numpy()
