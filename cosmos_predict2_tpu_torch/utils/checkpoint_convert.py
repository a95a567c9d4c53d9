"""Loading reference torch checkpoints, the port's copy of the part of
cosmos_predict2_tpu/utils/checkpoint_convert.py that it uses.

The port's modules carry the reference state-dict names and layouts, so a
checkpoint loads as it is: only the file reading and the ``net.`` /
``net_ema.`` prefix stripping are needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def strip_prefix(sd: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """The entries under ``prefix``, with the prefix removed from their keys."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a .pt/.pth/.safetensors state dict into fp32 NumPy arrays."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
