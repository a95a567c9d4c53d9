"""The port's modules written as reference-layout torch state dicts.

The port's counterpart of cosmos_predict2_tpu/utils/checkpoint_export.py.
The port's modules carry the reference checkpoint's names and layouts, so
an export is the module's ``state_dict()``: the DiT under a ``net.`` or
``net_ema.`` prefix (the consolidated training checkpoint's namespaces),
the Wan2.1 VAE as it is; the post-trained variants' parameters come out
under the reference's keys (``action_embedder_B_{D,3D}.fc{1,2}``,
``view_embeddings.weight``, ``blocks.{i}.cam_encoder.weight``) and the
cross-view attention's under JAX's module names. :func:`patterned_like` fills a shape template
(a state dict, on the ``meta`` device or not) with cheap deterministic
values that differ per tensor and along every axis, for synthetic
checkpoints at the true released shapes: the loader and the released-
weights verifier are checked end to end without a download.
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import torch


def export_dit_state_dict(net: torch.nn.Module, prefix: str = "") -> dict[str, torch.Tensor]:
    """The DiT's weights under ``prefix`` (``net_ema.`` for a released
    EMA checkpoint)."""
    return {prefix + k: v.detach() for k, v in net.state_dict().items()}


def export_vae_state_dict(vae: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The Wan2.1 VAE's weights, as the reference's tokenizer file holds them."""
    return {k: v.detach() for k, v in vae.state_dict().items()}


def patterned_like(
    template: Mapping[str, torch.Tensor], salt: int = 0, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """Tensors of ``template``'s shapes, in ``dtype`` on ``device``: a ramp
    along every axis (halving per axis), plus an offset that differs per
    tensor (its index and ``salt``), scaled by 1/sqrt(fan-in) for tensors
    of two or more axes so a net made of them stays finite. Catches
    transposes, swapped axes and swapped tensors; costs O(size) without
    random draws."""
    out = {}
    for i, (name, ref) in enumerate(template.items()):
        shape = tuple(ref.shape)
        x = torch.full(shape, ((i * 131 + salt) % 997 - 498) / 997.0, dtype=torch.float32, device=device)
        for ax, n in enumerate(shape):
            ramp = ((torch.arange(n, dtype=torch.float32, device=device) % 251) - 125.0) / 251.0
            x += ramp.reshape((n,) + (1,) * (len(shape) - ax - 1)) * (0.5**ax)
        if len(shape) >= 2:
            x /= math.sqrt(math.prod(shape[1:]))
        out[name] = x.to(dtype)
    return out


def save_torch_state_dict(sd: Mapping[str, torch.Tensor], path: str) -> str:
    """Write ``sd`` as a torch .pt that ``torch.load(weights_only=True)``
    reads (and maps); tensors are written from the host."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.save({k: v.detach().contiguous().cpu() for k, v in sd.items()}, path)
    return path
