"""Normalization ops, numerics-matched to cosmos_predict2_tpu/ops/normalization.py.

* :func:`rms_norm` — RMSNorm in fp32, cast back (q/k-norm, t-embedding norm).
* :func:`layer_norm` — affine-free LayerNorm in fp32, eps 1e-6.
* :func:`channel_l2_norm` — the Wan VAE "RMS_norm": L2-normalize over the
  channels (last axis, channels-last), times sqrt(C) * gamma.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in fp32, result cast back to x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm over the last axis, computed in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def channel_l2_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) * sqrt(C) * gamma over the last axis; gamma (C,)."""
    xf = x.float()
    norm = xf.square().sum(dim=-1, keepdim=True).sqrt()
    out = xf / norm.clamp_min(eps) * (x.shape[-1] ** 0.5)
    return out.to(x.dtype) * gamma.to(x.dtype)
