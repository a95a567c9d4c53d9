"""Loading reference torch checkpoints, the port's copy of the part of
cosmos_predict2_tpu/utils/checkpoint_convert.py that it uses.

The port's modules carry the reference state-dict names and layouts, so a
checkpoint loads as it is: only the file reading, the ``net.`` /
``net_ema.`` prefix stripping and :func:`load_reference_state_dict` are
needed. Like the JAX package's converters, the last reads exactly the keys
the model has and ignores every other entry of the file, and takes a VAE
RMS_norm gamma flat, (C,), as well as (C, 1, 1[, 1]). The post-trained
variants' keys (``action_embedder_B_{D,3D}.fc{1,2}``, ``view_embeddings.weight``,
``blocks.{i}.cam_encoder.weight``) are the reference's, as JAX's converter
reads them; its converter maps no reference key for the cross-view
attention, so a checkpoint without ``blocks.{i}.cross_view_attn.*`` raises
KeyError naming them, as for any key it lacks. The Wan2.1 DiT and the
Wan2.2 VAE carry the reference's names too; their converters
(:func:`convert_wan_dit_state_dict`, :func:`convert_wan22_vae_state_dict`)
make the few changes the JAX package's make. The prompt encoders
(text_encoders/) carry HF's or the reference's names: their converters
pick the tower's prefix (Qwen's by where its layers sit, as the JAX
package's ``convert_qwen_hf_state_dict``) and fill what a checkpoint may
leave out (a tied LM head, T5's ``shared`` table); the vision towers and
XLM-R only sit under a prefix (``TOWER_PREFIXES``).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np

log = logging.getLogger("cosmos_predict2_tpu_torch")


def strip_prefix(sd: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """The entries under ``prefix``, with the prefix removed from their keys."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def read_state_dict(path: str) -> dict[str, Any]:
    """A .pt/.pth/.bin/.safetensors state dict as CPU tensors in the file's
    dtypes, memory-mapped where the format allows (a .pt written by
    ``torch.save``), so a multi-GB checkpoint is read into the module it
    loads into without a second host copy. A directory (an HF checkpoint)
    gives the union of its ``*.safetensors`` shards, else of its ``*.bin``,
    ``*.pt`` and ``*.pth`` files."""
    import torch

    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        shards = [n for n in names if n.endswith(".safetensors")] or \
            [n for n in names if n.endswith((".bin", ".pt", ".pth"))]
        if not shards:
            raise FileNotFoundError(f"no state dict file in {path}")
        sd: dict[str, Any] = {}
        for name in shards:
            sd.update(read_state_dict(os.path.join(path, name)))
        return sd
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path, device="cpu"))
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:  # a legacy (non-zip) file cannot be mapped
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


def pick_prefix(sd: Mapping[str, Any], prefixes: tuple[str, ...]) -> dict[str, Any]:
    """The entries under the first of ``prefixes`` that any key carries, with
    that prefix stripped (as the JAX ``convert_model_checkpoint`` picks
    ``net_ema.`` before ``net.``); a file under none of them as it is."""
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in sd):
            return strip_prefix(sd, prefix)
    return dict(sd)


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
    def value(k):
        v = sd[k] if isinstance(sd[k], torch.Tensor) else torch.from_numpy(np.asarray(sd[k]))
        if k.endswith(".gamma") and v.ndim == 1 and own[k].ndim > 1 and v.numel() == own[k].numel():
            v = v.reshape(own[k].shape)  # the JAX package's export writes RMS_norm gammas flat
        return v

    module.load_state_dict({k: value(k) for k in own}, strict=True)


# ----------------------------- Wan2.1 DiT -----------------------------


def convert_wan_dit_state_dict(
    sd: Mapping[str, Any], extra_in_channels: int = 1, patch_size: tuple[int, int, int] = (1, 2, 2)
) -> dict[str, Any]:
    """A reference ``WanModel`` state dict -> networks/wan_dit.WanModel's, the
    mapping of the JAX package's ``convert_wan_dit_state_dict``: every name
    is the reference's; the patch embedding (a Linear (dim, C kt kh kw), or
    the Conv3d (dim, C, kt, kh, kw) that flattens to it, (C, kt, kh, kw)-
    major) gains zero columns for the ``extra_in_channels`` input channels
    the port appends and the released weights were trained without (the
    padding-mask channel, ``WanConfig.concat_padding_mask``)."""
    import torch

    out = dict(sd)
    w = sd["patch_embedding.weight"]
    w = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))
    w = w.reshape(w.shape[0], -1)
    per_channel = int(np.prod(patch_size))
    if w.shape[1] % per_channel:
        raise ValueError(f"patch embedding has {w.shape[1]} inputs, not a multiple of prod(patch_size)={per_channel}")
    if extra_in_channels:
        w = torch.cat([w, w.new_zeros((w.shape[0], extra_in_channels * per_channel))], dim=1)
    out["patch_embedding.weight"] = w
    return out


# ----------------------------- Wan2.2 VAE -----------------------------


def convert_wan22_vae_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """A reference Wan2.2 VAE state dict -> tokenizers/wan22_vae.Wan22VAE's,
    the mapping of the JAX package's ``convert_wan22_vae_state_dict``: the
    names are the reference's (``encoder.downsamples.{s}.downsamples.{j}``,
    ``decoder.upsamples.{s}.upsamples.{j}``, the stage's resample after its
    res blocks; AvgDown3D and DupUp3D hold no parameters), so only the
    encoder, decoder and outer conv entries are kept; a flat RMS_norm gamma
    is reshaped when the state dict is loaded (:func:`load_reference_state_dict`)."""
    return {k: v for k, v in sd.items() if k.split(".")[0] in ("encoder", "decoder", "conv1", "conv2")}


# ----------------------------- prompt encoders -----------------------------
# HF (or reference) state dicts of the text_encoders/ towers. The towers
# carry the checkpoints' names, so a converter only finds the tower's prefix
# and fills what a checkpoint may leave out; the result goes through
# :func:`load_reference_state_dict`.


def qwen_lm_prefix(sd: Mapping[str, Any]) -> str:
    """Where the Qwen LM's layers sit: Qwen2.5-VL's ``model.language_model.``
    (transformers >= 4.52), a causal LM's ``model.``, or the top level, as
    the JAX package's ``convert_qwen_hf_state_dict`` looks for them."""
    for prefix in ("model.language_model.", "model.", ""):
        if any(k.startswith(f"{prefix}layers.0.") for k in sd):
            return prefix
    raise KeyError("could not locate transformer layers in state dict")


def convert_qwen_hf_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """An HF Qwen2 / Qwen2.5-VL / Qwen3 state dict -> text_encoders/qwen.QwenLM's."""
    prefix = qwen_lm_prefix(sd)
    return strip_prefix(sd, prefix) if prefix else dict(sd)


def qwen_hf_deltas(lm_sd: Mapping[str, Any]) -> dict[str, Any]:
    """What a converted LM state dict says of its config: the layer count,
    the q/k/v biases (Qwen2) and the per-head q/k norms (Qwen3)."""
    layers = {int(k.split(".")[1]) for k in lm_sd if k.startswith("layers.")}
    return {"num_hidden_layers": max(layers) + 1, "attention_bias": "layers.0.self_attn.q_proj.bias" in lm_sd,
            "qk_norm": "layers.0.self_attn.q_norm.weight" in lm_sd}


def convert_qwen_guard_hf_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """An HF causal-LM guard checkpoint (Qwen2 or Qwen3, e.g.
    Qwen/Qwen3Guard-Gen-0.6B) -> text_encoders/qwen.QwenGuardLM's: the LM under
    ``model.`` and ``lm_head.weight``, the checkpoint's own or, tied
    (``tie_word_embeddings``), the token embeddings."""
    lm = convert_qwen_hf_state_dict(sd)
    out = {f"model.{k}": v for k, v in lm.items()}
    out["lm_head.weight"] = sd["lm_head.weight"] if "lm_head.weight" in sd else lm["embed_tokens.weight"]
    return out


def convert_t5_hf_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """An HF T5EncoderModel / UMT5EncoderModel state dict -> t5_encoder.T5Encoder's:
    the token embeddings as ``shared.weight`` (or ``encoder.embed_tokens.weight``)."""
    out = dict(sd)
    if "shared.weight" not in out:
        if "encoder.embed_tokens.weight" not in out:
            raise KeyError("no token embedding in state dict")
        out["shared.weight"] = out["encoder.embed_tokens.weight"]
    return out


# Where each vision tower (and XLM-R) sits in its checkpoint, for
# ``load_reference_state_dict(module, pick_prefix(sd, TOWER_PREFIXES[kind]), what)``:
# the open-clip / Wan CLIP's ``visual.`` (its text tower's entries left out),
# a Qwen2.5-VL checkpoint's vision tower, an HF SiglipVisionModel (or
# SiglipModel), the reference XLMRoberta(WithHead) as the CLIP's ``textual.``
# tower; a file under none of them is read as it is.
TOWER_PREFIXES = {
    "clip_vision": ("visual.",),
    "qwen_vision": ("model.visual.", "visual."),
    "siglip_vision": ("vision_model.",),
    "xlm_roberta": ("textual.",),
}
