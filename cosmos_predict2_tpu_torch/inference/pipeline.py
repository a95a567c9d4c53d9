"""Video2World inference pipeline, Text2Image and autoregressive long video.

Counterpart of cosmos_predict2_tpu/inference/pipeline.py: uint8 clip ->
VAE encode (streaming, or one-shot with ``streaming_vae=False``) -> UniPC
with batched CFG and FRAME_REPLACE conditioning (or, with
``sampler="dmd2"``, the distilled 4-step TrigFlow sampler without CFG) ->
VAE decode. Input prep follows the reference: an image becomes frame 0 of
a zero video; a video contributes its last 4(k-1)+1 frames, padded with its
last frame. ``generate_autoregressive`` slides a window of clips over a
long video; :class:`Text2ImageInference` samples one latent frame.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import DataType, make_condition
from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, DistillationModel
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import (
    decode_oneshot,
    decode_streaming,
    encode_oneshot,
    encode_streaming,
)
from cosmos_predict2_tpu_torch.utils.io import (
    get_image_resolution,
    get_resolution,
    read_image,
    read_video,
    resize_frames,
    save_img_or_video,
)
from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand

from cosmos_predict2_tpu_torch.utils import log

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")
_VIDEO_EXTS = (".mp4", ".webm", ".mkv", ".mov")


def resize_input(frames_thwc: np.ndarray, height: int, width: int) -> np.ndarray:
    """Aspect-preserving bilinear resize + center crop of uint8 (T, H, W, 3),
    the resize by the native media ops, as in the JAX package."""
    t, h, w, _ = frames_thwc.shape
    scale = max(width / w, height / h)
    rh, rw = int(math.ceil(scale * h)), int(math.ceil(scale * w))
    resized = resize_frames(frames_thwc, rh, rw)
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
    # True: the VAE streams in causal chunks with O(chunk) memory. False:
    # the one-shot route, the whole clip through the encoder and decoder at
    # once (WanVAE.encode / decode), which, as the JAX package's, normalizes
    # the clip and takes the samples in bf16 whatever the VAE's dtype (as
    # streaming does with the bf16 VAE of every released config). The JAX
    # package defaults to False (its CLI never sets it); the port defaults
    # to True, because a one-shot 93-frame 720p decode does not fit one card.
    streaming_vae: bool = True


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

    def _run(self, video_u8, text_emb, neg_text_emb, noise, guidance, num_steps, num_conditional_frames,
             pixel_format="float", sampler="unipc") -> torch.Tensor:
        """Encode, sample, decode, the VAE streaming or one-shot as
        ``setup.streaming_vae`` says; ``sampler="dmd2"`` samples with the
        distilled few-step TrigFlow loop (``num_steps`` of its times, no
        CFG: the guidance and negative prompt are not used)."""
        times: dict[str, float] = {}
        t0 = time.perf_counter()
        clip = torch.tensor(video_u8).to(self.device).permute(0, 2, 3, 4, 1)
        if self.setup.streaming_vae:
            latents = encode_streaming(self.vae, clip, pixel_format="uint8")
        else:
            # as JAX's one-shot route: the clip normalized in bf16 whatever the VAE's dtype
            latents = encode_oneshot(self.vae, clip.to(torch.bfloat16) / 127.5 - 1.0)
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
        if self.setup.streaming_vae:
            z = samples.to(self.vae.config.dtype).permute(0, 2, 3, 4, 1)
            frames = decode_streaming(self.vae, z, chunk_latent_frames=self.setup.decode_chunk_latent_frames,
                                      pixel_format=pixel_format)
        else:  # the samples in bf16, as JAX's one-shot route
            frames = decode_oneshot(self.vae, samples.to(torch.bfloat16).permute(0, 2, 3, 4, 1), pixel_format=pixel_format)
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
        frames = self._run(
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
        frames = self._run(
            video_u8, text_emb, neg_text_emb, noise, guidance, num_steps, num_conditional_frames, pixel_format
        )
        return self._to_pixel_format(frames)

    @staticmethod
    def _to_pixel_format(frames: torch.Tensor) -> np.ndarray:
        """The decode's output on the host: uint8 as it is (quantized on the
        device), float pixels as fp32."""
        frames = frames.cpu()
        return frames.numpy() if frames.dtype == torch.uint8 else frames.float().numpy()

    @staticmethod
    def _quantize(frames: np.ndarray) -> np.ndarray:
        """Host frames in either pixel format -> uint8, as JAX's
        ``_to_pixel_format(frames, "uint8")``: uint8 as it is, floats
        clipped to [-1, 1] and rounded."""
        if frames.dtype == np.uint8:
            return frames
        return np.round((np.clip(frames.astype(np.float32), -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)

    @torch.no_grad()
    def generate_autoregressive(
        self,
        video_u8: np.ndarray,  # (1, 3, T0, H, W): the initial conditioning frames
        text_emb,
        num_output_frames: int,
        chunk_size: Optional[int] = None,
        chunk_overlap: int = 1,
        num_conditional_frames: int = 1,
        guidance: float = 7.0,
        num_steps: int = 35,
        seed: int = 1,
        neg_text_emb=None,
        pixel_format: str = "float",
    ) -> np.ndarray:
        """Sliding-window long video, as JAX's ``generate_autoregressive``:
        generate a chunk, write its frames back into the uint8 input
        buffer, condition the next chunk on the overlap, advance.

        ``chunk_size``: pixel frames per chunk (the model's clip length by
        default); ``chunk_overlap``: latent frames shared by consecutive
        chunks, (chunk_overlap - 1) * 4 + 1 pixel frames. Chunk i draws its
        noise from ``seed + i`` and is conditioned on
        ``num_conditional_frames`` latent frames (chunk 0) or
        ``chunk_overlap`` (the rest). The written-back frames are quantized
        to uint8; the output keeps ``pixel_format``.
        -> (num_output_frames, H, W, 3).
        """
        chunk = chunk_size or self.num_video_frames
        _, _, t0, H, W = video_u8.shape
        overlap_px = (chunk_overlap - 1) * 4 + 1

        # size the buffer so every window is exactly ``chunk`` frames
        stride = chunk - overlap_px
        n_chunks = 1 + max(0, -(-(num_output_frames - chunk) // stride))
        buffer = np.zeros((1, 3, (n_chunks - 1) * stride + chunk, H, W), dtype=np.uint8)
        buffer[:, :, :t0] = video_u8
        out_frames: list[np.ndarray] = []

        start = 0
        chunk_idx = 0
        while len(out_frames) < num_output_frames:
            window = buffer[:, :, start : start + chunk]
            k = num_conditional_frames if chunk_idx == 0 else chunk_overlap
            frames = self.generate_vid2world(
                window,
                text_emb,
                neg_text_emb=neg_text_emb,
                guidance=guidance,
                num_steps=num_steps,
                num_conditional_frames=k,
                seed=seed + chunk_idx,
                pixel_format=pixel_format,
            )  # (chunk, H, W, 3) in the requested format
            frames_u8 = self._quantize(frames)
            # write the generated frames back into the buffer for re-conditioning
            end = min(start + chunk, buffer.shape[2])
            buffer[0, :, start:end] = frames_u8.transpose(3, 0, 1, 2)[:, : end - start]
            new = frames if chunk_idx == 0 else frames[overlap_px:]
            out_frames.extend(list(new))
            start += chunk - overlap_px
            chunk_idx += 1
            log.info(f"autoregressive chunk {chunk_idx}: {len(out_frames)}/{num_output_frames} frames")

        return np.stack(out_frames[:num_output_frames])


class Text2ImageInference:
    """Image mode, as JAX's ``Text2ImageInference``: one latent frame
    (``state_t=1``) through the same rectified-flow DiT, decoded to one
    image. The input is a gray frame that, with ``num_conditional_frames=0``
    (an all-zero condition mask), only sets the shapes; the condition's data
    type stays VIDEO, as in the JAX package."""

    def __init__(self, setup: InferenceSetup, net: MiniTrainDIT, vae: WanVAE, text_encoder=None):
        setup = dataclasses.replace(setup, model_config=dataclasses.replace(setup.model_config, state_t=1))
        self._v2w = Video2WorldInference(setup, net, vae, text_encoder=text_encoder)

    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        return self._v2w.encode_text(prompts)

    def image_size(self) -> tuple[int, int]:
        """(H, W): ``size_override``, else the image bucket of the setup's
        resolution and aspect."""
        setup = self._v2w.setup
        if setup.size_override is not None:
            return setup.size_override
        w, h = get_image_resolution(setup.resolution, setup.aspect)
        return h, w

    @torch.no_grad()
    def generate_image(self, text_emb, neg_text_emb=None, guidance: float = 7.0, num_steps: int = 35,
                       seed: int = 1) -> np.ndarray:
        """-> (H, W, 3) uint8 image."""
        H, W = self.image_size()
        video_u8 = np.full((1, 3, 1, H, W), 127, dtype=np.uint8)
        frames = self._v2w.generate_vid2world(
            video_u8, text_emb, neg_text_emb=neg_text_emb, guidance=guidance, num_steps=num_steps,
            num_conditional_frames=0, seed=seed,
        )  # (1, H, W, 3) in [-1, 1]
        return ((frames[0] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)

    def save_image(self, image_u8: np.ndarray, path: str) -> str:
        return save_img_or_video(image_u8[None], path)
