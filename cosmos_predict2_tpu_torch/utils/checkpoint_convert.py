"""Loading reference torch checkpoints, the port's copy of the part of
cosmos_predict2_tpu/utils/checkpoint_convert.py that it uses.

The port's modules carry the reference state-dict names and layouts, so a
checkpoint loads as it is: only the file reading, the ``net.`` /
``net_ema.`` prefix stripping and :func:`load_reference_state_dict` are
needed. Like the JAX package's converters, the last reads exactly the keys
the model has and ignores every other entry of the file.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

import numpy as np

log = logging.getLogger("cosmos_predict2_tpu_torch")


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


def load_reference_state_dict(module: Any, sd: Mapping[str, Any], what: str) -> None:
    """Load a reference checkpoint's entries into ``module`` (a
    ``torch.nn.Module``) as the JAX package's ``convert_dit_state_dict`` /
    ``convert_vae_state_dict`` read one: exactly the keys the module has.
    A key it lacks raises KeyError naming the keys; every other entry of
    ``sd`` (a TransformerEngine ``_extra_state``, a buffer the port does not
    keep) is ignored and logged by name; a wrong shape raises as
    ``load_state_dict`` does. Values are tensors or NumPy arrays."""
    import torch

    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} of the model's keys: {missing[:8]}")
    extra = [k for k in sd if k not in own]
    if extra:
        log.warning(f"{what}: ignoring {len(extra)} checkpoint entries the model does not have: {extra[:8]}")
    module.load_state_dict({k: sd[k] if isinstance(sd[k], torch.Tensor) else torch.from_numpy(np.asarray(sd[k]))
                            for k in own}, strict=True)
