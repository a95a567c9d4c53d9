"""JAX parameter trees -> state dicts of the port's modules.

The inverse of cosmos_predict2_tpu/utils/checkpoint_convert.py::
convert_dit_state_dict / convert_vae_state_dict: the port's modules carry
the reference torch checkpoint's names and layouts, so a parameter tree of
the JAX package (as NumPy arrays) becomes a ``state_dict`` that loads with
``strict=True``. Flax kernels (in, out) become Linear weights (out, in);
DHWIO conv weights become OIDHW, HWIO become OIHW; RMS_norm gammas regain
their (C, 1, 1, 1) shape, (C, 1, 1) in the attention blocks. The DMD2
discriminator head's ``Dense`` layers keep their names.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if "params" in tree else tree


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=a.dtype, copy=True))


# ------------------------------- DiT -------------------------------

_DIT_PREFIX = {"x_embedder": "x_embedder.proj.1", "t_embedder": "t_embedder.1", "crossattn_proj": "crossattn_proj.0"}


def _dit_key(path: tuple[str, ...]) -> str:
    parts: list[str] = []
    for i, seg in enumerate(path[:-1]):
        if i == 0 and seg in _DIT_PREFIX:
            parts.append(_DIT_PREFIX[seg])
        elif seg.startswith("blocks_"):
            parts.append("blocks." + seg[len("blocks_"):])
        elif seg in ("linear_1", "linear_2") and path[i - 1].startswith("adaln_modulation"):
            parts.append(seg[-1])  # Sequential(SiLU, Linear, Linear) indices 1, 2
        else:
            parts.append(seg)
    leaf = path[-1]
    return ".".join(parts + ["weight" if leaf == "kernel" else leaf])


def jax_dit_params_to_torch(params_np: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """JAX MiniTrainDIT params -> the port's MiniTrainDIT state dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, a in _flatten(_params(params_np)):
        sd[_dit_key(path)] = _tensor(a.T if path[-1] == "kernel" else a)
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    if n_blocks != cfg.num_blocks:
        raise ValueError(f"parameter tree has {n_blocks} blocks, config expects {cfg.num_blocks}")
    return sd


def jax_discriminator_params_to_torch(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX DiscriminatorHead params -> the port's DiscriminatorHead state
    dict: ``{name}.kernel`` (in, out) -> ``{name}.weight`` (out, in),
    ``{name}.bias`` as it is."""
    return {f"{path[0]}.{'weight' if path[1] == 'kernel' else path[1]}": _tensor(a.T if path[1] == "kernel" else a)
            for path, a in _flatten(_params(params_np))}


# ------------------------------- VAE -------------------------------

_RES = {"norm1": "residual.0", "conv1": "residual.2", "norm2": "residual.3", "conv2": "residual.6", "shortcut": "shortcut"}
_ATTN = {"norm": "norm", "to_qkv": "to_qkv", "proj": "proj"}
_RESAMPLE = {"conv": "resample.1", "time_conv": "time_conv"}


def _vae_module_prefix(path: tuple[str, ...], tree: Mapping[str, Any]) -> tuple[str, bool]:
    """Flax module path (without the leaf) -> (torch prefix, is the
    per-frame attention block)."""
    if len(path) == 1:  # top-level conv1 / conv2
        return path[0], False
    side, name = path[0], path[1]
    sub = path[2:]
    if name == "conv1":
        return f"{side}.conv1", False
    if name == "head_norm":
        return f"{side}.head.0", False
    if name == "head_conv":
        return f"{side}.head.2", False
    if name.startswith("mid_"):
        idx = {"mid_res1": 0, "mid_attn": 1, "mid_res2": 2}[name]
        table = _ATTN if name == "mid_attn" else _RES
        return f"{side}.middle.{idx}.{table[sub[0]]}", name == "mid_attn"
    stage, li = name.split("_")  # down_{li} / up_{li}
    group = "downsamples" if stage == "down" else "upsamples"
    table = _RES if "norm1" in tree[side][name] else _RESAMPLE
    return f"{side}.{group}.{li}.{table[sub[0]]}", False


def jax_vae_params_to_torch(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX WanVAE params -> the port's WanVAE state dict."""
    tree = _params(params_np)
    sd: dict[str, torch.Tensor] = {}
    for path, a in _flatten(tree):
        prefix, is_attn = _vae_module_prefix(path[:-1], tree)
        leaf = path[-1]
        if leaf == "gamma":
            a = a.reshape((-1, 1, 1) if is_attn else (-1, 1, 1, 1))
        elif leaf == "weight" and a.ndim == 5:  # DHWIO -> OIDHW
            a = np.transpose(a, (4, 3, 0, 1, 2))
        elif leaf == "weight" and a.ndim == 4:  # HWIO -> OIHW
            a = np.transpose(a, (3, 2, 0, 1))
        sd[f"{prefix}.{leaf}"] = _tensor(a)
    return sd
