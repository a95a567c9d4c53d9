"""Video tokenizer interface.

The port's counterpart of cosmos_predict2_tpu/tokenizers/interface.py,
after the reference's tokenizer interface and Wan wrapper
(cosmos_predict2/_src/predict2/tokenizers/interface.py:25-98 and
wan2pt1.py:961-1060 ``Wan2pt1VAEInterface``): latent / pixel frame
conversions, compression factors, chunk_duration, and the **second-stage**
latent normalization: image batches (t == 1) through (img_mean, img_std),
video batches through the per-latent-frame (video_mean[:, :, :t],
video_std[:, :, :t]); the identity unless statistics are given (the
reference's defaults are zeros and ones).

The codec is the port's WanVAE run on the whole clip at once
(``WanVAE.encode`` / ``decode``, the one-shot route, as JAX's interface
runs ``WanVAE.encode`` under jit), so on the card its 3x3x3 convolutions
are the conv3d_causal kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig


@dataclasses.dataclass
class VAEInterfaceConfig:
    vae: WanVAEConfig = dataclasses.field(default_factory=WanVAEConfig)
    chunk_duration: int = 81  # pixel frames per chunk (reference default)
    max_latent_frames: int = 50  # video_mean/std table length (reference 1,1,50,1,1)


class WanVAEInterface:
    """Model-facing tokenizer: (B, C, T, H, W) pixels <-> (B, 16, t, h, w)
    latents, over a built ``WanVAE`` (its weights, dtype and device)."""

    def __init__(
        self,
        config: VAEInterfaceConfig,
        vae: WanVAE,
        img_mean: Optional[np.ndarray] = None,
        img_std: Optional[np.ndarray] = None,
        video_mean: Optional[np.ndarray] = None,
        video_std: Optional[np.ndarray] = None,
    ):
        if vae.config != config.vae:
            raise ValueError(f"the VAE's config {vae.config} is not the interface's {config.vae}")
        self.config = config
        self.vae = vae
        device = next(vae.parameters()).device
        ch = config.vae.z_dim
        t = config.max_latent_frames
        stat = lambda a, default: torch.as_tensor(a if a is not None else default, dtype=torch.float32, device=device)
        self.img_mean = stat(img_mean, np.zeros((1, ch, 1, 1, 1)))
        self.img_std = stat(img_std, np.ones((1, ch, 1, 1, 1)))
        self.video_mean = stat(video_mean, np.zeros((1, 1, t, 1, 1)))
        self.video_std = stat(video_std, np.ones((1, 1, t, 1, 1)))

    # ------------------------- frame conversions -------------------------

    def get_latent_num_frames(self, num_pixel_frames: int) -> int:
        return 1 + (num_pixel_frames - 1) // 4

    def get_pixel_num_frames(self, num_latent_frames: int) -> int:
        return (num_latent_frames - 1) * 4 + 1

    @property
    def spatial_compression_factor(self) -> int:
        return 8

    @property
    def temporal_compression_factor(self) -> int:
        return 4

    @property
    def latent_ch(self) -> int:
        return self.config.vae.z_dim

    @property
    def pixel_chunk_duration(self) -> int:
        return self.config.chunk_duration

    @property
    def latent_chunk_duration(self) -> int:
        return self.get_latent_num_frames(self.config.chunk_duration)

    @property
    def name(self) -> str:
        return "wan2pt1_tokenizer"

    # ------------------------------ codec ------------------------------

    def _stats(self, t: int):
        if t == 1:
            return self.img_mean, self.img_std
        return self.video_mean[:, :, :t], self.video_std[:, :, :t]

    @torch.no_grad()
    def encode(self, state_B_C_T_H_W: torch.Tensor) -> torch.Tensor:
        """(B, 3, 1 + 4k, H, W) pixels in [-1, 1] -> (B, 16, 1 + k, H/8, W/8)
        fp32 latents, normalized by the second-stage statistics."""
        x = state_B_C_T_H_W.permute(0, 2, 3, 4, 1).to(self.vae.config.dtype)
        z = self.vae.encode(x).permute(0, 4, 1, 2, 3).float()  # (B, 16, t, h, w)
        mean, std = self._stats(z.shape[2])
        return (z - mean) / std

    @torch.no_grad()
    def decode(self, latent_B_C_T_H_W: torch.Tensor) -> torch.Tensor:
        """(B, 16, t, h, w) latents -> (B, 3, 1 + 4(t - 1), 8h, 8w) pixels in
        the VAE's dtype, in [-1, 1] (unclipped)."""
        mean, std = self._stats(latent_B_C_T_H_W.shape[2])
        z = latent_B_C_T_H_W.float() * std + mean
        return self.vae.decode(z.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
