"""3D video RoPE, numerics-matched to cosmos_predict2_tpu/ops/rope.py.

Per head_dim D the bands are dim_h = dim_w = D // 6 * 2 and
dim_t = D - 2 * dim_h; axis frequencies 1 / theta_a ** (arange(0, dim_a, 2)
/ dim_a) with theta_a = 10000 * ratio_a ** (dim_a / (dim_a - 2)). The angle
table is cat([t, h, w] bands) repeated twice (GPT-NeoX half rotation).
Temporal positions start at ``t_start`` (a streaming block's absolute
latent frame) and, with fps modulation on, are scaled by base_fps / fps
only when the table has more than one frame, as in the JAX package: a
one-frame streaming block is never fps-modulated.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RopeSpec:
    head_dim: int
    base_fps: float = 24.0
    h_extrapolation_ratio: float = 1.0
    w_extrapolation_ratio: float = 1.0
    t_extrapolation_ratio: float = 1.0
    enable_fps_modulation: bool = True

    @property
    def dim_h(self) -> int:
        return self.head_dim // 6 * 2

    @property
    def dim_t(self) -> int:
        return self.head_dim - 2 * self.dim_h


def _axis_freqs(dim: int, theta: float) -> np.ndarray:
    rng = np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim
    return 1.0 / (theta**rng)


@functools.lru_cache(maxsize=None)
def _axis_freqs_tensor(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The axis frequencies as an fp32 tensor on ``device``, made once. A
    tensor made from host memory on every forward is a pageable copy, for
    which the host waits until the card has finished all work queued before
    it: one forward could not be queued while the last one runs."""
    return torch.tensor(_axis_freqs(dim, theta), dtype=torch.float32, device=device)


def rope_angles_3d(
    spec: RopeSpec,
    T: int,
    H: int,
    W: int,
    fps: Optional[torch.Tensor] = None,
    device: torch.device | str | None = None,
    t_start: int = 0,
) -> torch.Tensor:
    """Angle table of shape (T*H*W, head_dim), fp32, for frames
    ``t_start .. t_start + T - 1``."""
    dim_h, dim_t = spec.dim_h, spec.dim_t
    h_theta = 10000.0 * spec.h_extrapolation_ratio ** (dim_h / (dim_h - 2))
    w_theta = 10000.0 * spec.w_extrapolation_ratio ** (dim_h / (dim_h - 2))
    t_theta = 10000.0 * spec.t_extrapolation_ratio ** (dim_t / (dim_t - 2))
    f32 = dict(dtype=torch.float32, device=device)
    dev = torch.device("cpu" if device is None else device)
    h_freqs = _axis_freqs_tensor(dim_h, h_theta, dev)
    w_freqs = _axis_freqs_tensor(dim_h, w_theta, dev)
    t_freqs = _axis_freqs_tensor(dim_t, t_theta, dev)

    t_pos = torch.arange(T, **f32) + float(t_start)
    if spec.enable_fps_modulation and fps is not None and T > 1:
        t_pos = t_pos / fps.reshape(()).to(**f32) * spec.base_fps
    h_pos = torch.arange(H, **f32)
    w_pos = torch.arange(W, **f32)

    emb_t = torch.outer(t_pos, t_freqs)  # (T, dim_t/2)
    emb_h = torch.outer(h_pos, h_freqs)  # (H, dim_h/2)
    emb_w = torch.outer(w_pos, w_freqs)  # (W, dim_h/2)
    half = torch.cat(
        [
            emb_t[:, None, None, :].expand(T, H, W, -1),
            emb_h[None, :, None, :].expand(T, H, W, -1),
            emb_w[None, None, :, :].expand(T, H, W, -1),
        ],
        dim=-1,
    )  # (T, H, W, head_dim/2)
    return torch.cat([half, half], dim=-1).reshape(T * H * W, spec.head_dim)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n_heads, D); angles: (S, D) fp32. rotate_half pairs
    element i with i + D/2; computed in fp32, cast back."""
    d = x.shape[-1]
    cos = angles.cos()[:, None, :]
    sin = angles.sin()[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2 :]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)
