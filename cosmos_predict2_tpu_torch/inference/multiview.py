"""Multiview (7-camera) inference.

Counterpart of cosmos_predict2_tpu/inference/multiview.py: Text2World,
Image2World or Video2World over V views at once, each view cross-attending
its own copy of the caption, the outputs per view and as one grid video.

The VAE runs view by view at batch 1 on the streaming route (K2 on the
card), so the views' clips never sit on the card together; the denoise
packs all views view-major on the latent T axis (models/multiview.py). The
condition marks the first k latent frames of every view (the JAX package
conditions view 0 only, see models/multiview.py).

Under context parallelism (the net's cp group, networks/dit.py::
set_context_parallel) every rank of the group runs the same request on
the same inputs and seed, the denoise shards the packed tokens, and each
rank ends with the whole output; :meth:`MultiviewInference.write` writes
it on rank 0 only.
"""

from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from cosmos_predict2_tpu_torch.conditioning.conditioner import DataType, make_condition
from cosmos_predict2_tpu_torch.models.multiview import MultiviewVid2VidModel, stack_views, unstack_views, view_grid
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming, truncate_u8
from cosmos_predict2_tpu_torch.utils.io import save_img_or_video
from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand

from cosmos_predict2_tpu_torch.utils import log

# the 7-view driving rig's camera order
VIEW_NAMES = (
    "front_wide",
    "rear",
    "rear_left",
    "rear_right",
    "cross_left",
    "cross_right",
    "front_tele",
)


@dataclasses.dataclass
class MultiviewInferenceArguments:
    prompt: str
    inference_type: str = "text2world"  # text2world | image2world | video2world
    n_views: int = 7
    fps: int = 30
    num_steps: int = 35
    guidance: float = 7.0
    seed: int = 1
    # per-view input video paths keyed by VIEW_NAMES: unused for
    # text2world, the first frame for image2world, the first clip for
    # video2world
    view_paths: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def num_input_frames(self) -> int:
        return {"text2world": 0, "image2world": 1, "video2world": 2}[self.inference_type]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MultiviewInference:
    """``last_timings`` holds the split of the latest request, in seconds:
    ``vae_encode_s`` and ``vae_decode_s`` (lists, one per view) and
    ``denoise_s``, each ending in a device synchronize."""

    def __init__(
        self,
        model: MultiviewVid2VidModel,
        vae: WanVAE,
        text_encoder: Optional[Callable[[list[str]], torch.Tensor]] = None,
        height: int = 240,
        width: int = 416,
    ):
        self.model = model
        self.vae = vae
        self.text_encoder = text_encoder
        self.height, self.width = height, width
        self.device = next(model.net.parameters()).device
        self.last_timings: dict = {}

    @property
    def frames_per_view(self) -> int:
        tv = self.model.config.state_t // self.model.n_views
        return (tv - 1) * 4 + 1

    def encode_views(self, videos_u8: np.ndarray) -> tuple[torch.Tensor, list[float]]:
        """(V, T, H, W, 3) uint8 -> packed latents (1, C, V tv, h, w) fp32,
        one streaming encode per view; and each view's seconds."""
        latents, seconds = [], []
        for clip in videos_u8:
            t = perf_counter()
            x = torch.as_tensor(np.asarray(clip, np.float32)[None] / 127.5 - 1.0).to(self.device)
            z = encode_streaming(self.vae, x.to(self.vae.config.dtype))  # (1, tv, h, w, C)
            latents.append(z.permute(0, 4, 1, 2, 3).float())
            _sync(self.device)
            seconds.append(perf_counter() - t)
        return stack_views(latents), seconds

    def decode_views(self, samples: torch.Tensor) -> tuple[np.ndarray, list[float]]:
        """Packed latents -> (V, T, H, W, 3) uint8, one streaming decode per
        view of the samples rounded to bf16 (as the JAX package's request);
        and each view's seconds."""
        frames, seconds = [], []
        for z in unstack_views(samples, self.model.n_views):
            t = perf_counter()
            px = decode_streaming(self.vae, z.to(torch.bfloat16).permute(0, 2, 3, 4, 1))
            frames.append(truncate_u8(px[0]).cpu().numpy())
            _sync(self.device)
            seconds.append(perf_counter() - t)
        return np.stack(frames), seconds

    @torch.no_grad()
    def generate(self, args: MultiviewInferenceArguments, videos_u8: Optional[np.ndarray] = None):
        """``videos_u8`` (V, T0, H, W, 3) uint8 conditioning frames (None for
        text2world) -> (per-view frames (V, T, H, W, 3) uint8, grid (T, gh,
        gw, 3))."""
        V = args.n_views
        if V != self.model.n_views:
            raise ValueError(f"the request has {V} views, the model {self.model.n_views}")
        if self.text_encoder is None:
            raise ValueError("construct with text_encoder=... or precompute embeddings")
        T, H, W = self.frames_per_view, self.height, self.width
        buf = np.zeros((V, T, H, W, 3), dtype=np.uint8)
        if videos_u8 is not None:
            t0 = min(videos_u8.shape[1], T)
            buf[:, :t0] = videos_u8[:, :t0]
        gt_latents, encode_s = self.encode_views(buf)

        emb_single = torch.as_tensor(self.text_encoder([args.prompt])).float().to(self.device)  # (1, L, D)
        text_emb = emb_single.repeat(1, V, 1)  # each view gets its copy of the caption
        k = args.num_input_frames
        noise = arch_invariant_rand(tuple(gt_latents.shape), seed=args.seed, device=self.device)
        condition = make_condition(text_emb, data_type=DataType.VIDEO)
        condition = self.model.set_multiview_condition(condition, gt_latents, k)
        t = perf_counter()
        samples = self.model.generate(noise, condition, guidance=args.guidance, num_steps=args.num_steps,
                                      num_conditional_frames=k)
        if not torch.isfinite(samples).all():
            raise FloatingPointError("sampling produced non-finite latents")
        _sync(self.device)
        denoise_s = perf_counter() - t
        frames_u8, decode_s = self.decode_views(samples)
        self.last_timings = {"vae_encode_s": encode_s, "denoise_s": denoise_s, "vae_decode_s": decode_s}
        log.info(f"multiview generate: {V} views x {frames_u8.shape[1]} frames")
        return frames_u8, view_grid(list(frames_u8))

    @staticmethod
    def write(video_u8: np.ndarray, path: str, fps: int = 16) -> Optional[str]:
        """Write a request's video (its grid, or one view's frames) on the
        main process: rank 0 of a process group, or the one process.
        Returns the path written, None on the other ranks."""
        if dist.is_initialized() and dist.get_rank() != 0:
            return None
        return save_img_or_video(video_u8, path, fps=fps)
