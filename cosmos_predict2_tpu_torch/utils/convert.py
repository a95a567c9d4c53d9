"""JAX parameter trees -> state dicts of the port's modules.

The inverse of cosmos_predict2_tpu/utils/checkpoint_convert.py::
convert_dit_state_dict / convert_vae_state_dict: the port's modules carry
the reference torch checkpoint's names and layouts, so a parameter tree of
the JAX package (as NumPy arrays) becomes a ``state_dict`` that loads with
``strict=True``. Flax kernels (in, out) become Linear weights (out, in);
DHWIO conv weights become OIDHW, HWIO become OIHW; RMS_norm gammas regain
their (C, 1, 1, 1) shape, (C, 1, 1) in the attention blocks. The DMD2
discriminator head's ``Dense`` layers keep their names. A LoRA adapter tree
becomes the adapters of training/lora.py by layer name. The post-trained
variants' parameters map as JAX's converter maps them
(``action_embedder_B_{D,3D}.fc{1,2}``, ``blocks.{i}.cam_encoder``, the
``view_embeddings`` table as ``view_embeddings.weight``); the cross-view
attention's keep JAX's module names (``blocks.{i}.cross_view_attn.*``,
``blocks.{i}.ln_cross_view_{scale,bias}``). The prompt encoders' trees
(text_encoders/) map onto the HF / reference names the port's towers carry.
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
    if path == ("view_embeddings",):  # a bare table in JAX, an nn.Embedding here
        return "view_embeddings.weight"
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


def jax_lora_params_to_torch(lora_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX's adapter tree (training/lora.py::init_lora_params: {"a": (in,
    r), "b": (r, out)} in place of each adapted Flax kernel, None elsewhere)
    -> the port's adapter parameters by name, ``{layer}.lora_A`` (r, in)
    and ``{layer}.lora_B`` (out, r), the layer named as its Linear."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: tuple[str, ...]) -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping) and set(v) == {"a", "b"}:
                layer = _dit_key(prefix + (k,)).removesuffix(".weight")
                out[f"{layer}.lora_A"] = _tensor(np.asarray(v["a"]).T)
                out[f"{layer}.lora_B"] = _tensor(np.asarray(v["b"]).T)
            elif isinstance(v, Mapping):
                walk(v, prefix + (k,))

    walk(_params(lora_np), ())
    return out


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


# ----------------------------- prompt encoders -----------------------------
# JAX text_encoders/ parameter trees -> the port's towers, whose modules carry
# the HF / reference names (the inverses of the JAX package's
# convert_*_state_dict converters).


def _linear(sd: dict, name: str, tree: Mapping[str, Any]) -> None:
    """A Flax Dense {"kernel" (in, out)[, "bias"]} as ``name.weight`` (out, in)[, ``name.bias``]."""
    sd[f"{name}.weight"] = _tensor(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{name}.bias"] = _tensor(np.asarray(tree["bias"]))


def _qwen_lm(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    sd = {f"{prefix}embed_tokens.weight": _tensor(np.asarray(tree["embed_tokens"])),
          f"{prefix}norm.weight": _tensor(np.asarray(tree["norm"]["weight"]))}
    for name, layer in tree.items():
        if not name.startswith("layers_"):
            continue
        lp = f"{prefix}layers.{name[len('layers_'):]}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{lp}.{norm}.weight"] = _tensor(np.asarray(layer[norm]["weight"]))
        for proj, sub in layer["self_attn"].items():
            if proj in ("q_norm", "k_norm"):
                sd[f"{lp}.self_attn.{proj}.weight"] = _tensor(np.asarray(sub["weight"]))
            else:
                _linear(sd, f"{lp}.self_attn.{proj}", sub)
        for proj, sub in layer["mlp"].items():
            _linear(sd, f"{lp}.mlp.{proj}", sub)
    return sd


def jax_qwen_params_to_torch(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX QwenLM params -> text_encoders/qwen.QwenLM's state dict, or JAX
    QwenGuardLM params ({"model", "lm_head" (hidden, vocab)}) -> QwenGuardLM's."""
    tree = _params(params_np)
    if "model" not in tree:
        return _qwen_lm(tree)
    sd = _qwen_lm(tree["model"], "model.")
    sd["lm_head.weight"] = _tensor(np.asarray(tree["lm_head"]).T)
    return sd


def jax_t5_params_to_torch(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX T5Encoder params -> text_encoders/t5_encoder.T5Encoder's state dict."""
    tree = _params(params_np)
    sd = {"shared.weight": _tensor(np.asarray(tree["embed_tokens"])),
          "encoder.final_layer_norm.weight": _tensor(np.asarray(tree["final_norm"]["weight"]))}
    layers = sorted(int(k.split("_")[1]) for k in tree if k.startswith("attn_"))
    for i in layers:
        lp = f"encoder.block.{i}.layer"
        attn = tree[f"attn_{i}"]
        for proj in ("q", "k", "v", "o"):
            _linear(sd, f"{lp}.0.SelfAttention.{proj}", attn[proj])
        if "relative_attention_bias" in attn:
            sd[f"{lp}.0.SelfAttention.relative_attention_bias.weight"] = _tensor(
                np.asarray(attn["relative_attention_bias"]))
        sd[f"{lp}.0.layer_norm.weight"] = _tensor(np.asarray(tree[f"ln_attn_{i}"]["weight"]))
        for proj, sub in tree[f"ffn_{i}"].items():
            _linear(sd, f"{lp}.1.DenseReluDense.{proj}", sub)
        sd[f"{lp}.1.layer_norm.weight"] = _tensor(np.asarray(tree[f"ln_ffn_{i}"]["weight"]))
    return sd


def jax_clip_vision_params_to_torch(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX CLIPVisionTower params (its default ``run_head=False`` tree) ->
    clip_vision.CLIPVisionTower's state dict (the patch conv HWIO -> OIHW)."""
    tree = _params(params_np)
    sd = {"patch_embedding.weight": _tensor(np.transpose(np.asarray(tree["patch_embedding"]["kernel"]), (3, 2, 0, 1)))}
    if "bias" in tree["patch_embedding"]:
        sd["patch_embedding.bias"] = _tensor(np.asarray(tree["patch_embedding"]["bias"]))
    for name in ("cls_embedding", "pos_embedding"):
        sd[name] = _tensor(np.asarray(tree[name]))
    if "pre_norm_w" in tree:
        sd["pre_norm.weight"] = _tensor(np.asarray(tree["pre_norm_w"]))
        sd["pre_norm.bias"] = _tensor(np.asarray(tree["pre_norm_b"]))
    for name, block in tree.items():
        if not name.startswith("block_"):
            continue
        bp = f"transformer.{name[len('block_'):]}"
        for ours, theirs in (("ln1", "norm1"), ("ln2", "norm2")):
            sd[f"{bp}.{theirs}.weight"] = _tensor(np.asarray(block[f"{ours}_w"]))
            sd[f"{bp}.{theirs}.bias"] = _tensor(np.asarray(block[f"{ours}_b"]))
        for ours, theirs in (("to_qkv", "attn.to_qkv"), ("attn_proj", "attn.proj"), ("mlp_fc1", "mlp.0"),
                             ("mlp_fc2", "mlp.2")):
            _linear(sd, f"{bp}.{theirs}", block[ours])
    return sd


def jax_qwen_vision_params_to_torch(params_np: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """JAX QwenVisionTower params -> qwen_vision.QwenVisionTower's state dict
    (the patch kernel (C tp P P, E) -> the Conv3d's (E, C, tp, P, P))."""
    tree = _params(params_np)
    tp, P = cfg.temporal_patch_size, cfg.patch_size
    kernel = np.asarray(tree["patch_embed"])
    sd = {"patch_embed.proj.weight": _tensor(kernel.T.reshape(kernel.shape[1], cfg.in_channels, tp, P, P)),
          "merger.ln_q.weight": _tensor(np.asarray(tree["ln_q"]))}
    _linear(sd, "merger.mlp.0", tree["mlp_0"])
    _linear(sd, "merger.mlp.2", tree["mlp_2"])
    for name, block in tree.items():
        if not name.startswith("blocks_"):
            continue
        bp = f"blocks.{name[len('blocks_'):]}"
        for norm in ("norm1", "norm2"):
            sd[f"{bp}.{norm}.weight"] = _tensor(np.asarray(block[norm]))
        for ours, theirs in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("gate_proj", "mlp.gate_proj"),
                             ("up_proj", "mlp.up_proj"), ("down_proj", "mlp.down_proj")):
            _linear(sd, f"{bp}.{theirs}", block[ours])
    return sd


def jax_siglip_params_to_torch(params_np: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """JAX SigLIPVisionTower params -> siglip_vision.SigLIPVisionTower's state
    dict (the patch Dense over (ph, pw, c) -> the conv's OIHW; the MAP head's
    q, k, v packed into ``in_proj``)."""
    tree = _params(params_np)
    p = cfg.patch_size
    kernel = np.asarray(tree["patch"]["kernel"])
    sd = {"embeddings.patch_embedding.weight": _tensor(np.transpose(kernel.reshape(p, p, 3, -1), (3, 2, 0, 1))),
          "embeddings.patch_embedding.bias": _tensor(np.asarray(tree["patch"]["bias"])),
          "embeddings.position_embedding.weight": _tensor(np.asarray(tree["pos_emb"])),
          "head.probe": _tensor(np.asarray(tree["probe"]))}
    for ours, theirs in (("post_ln", "post_layernorm"), ("head_ln", "head.layernorm")):
        sd[f"{theirs}.weight"] = _tensor(np.asarray(tree[f"{ours}_w"]))
        sd[f"{theirs}.bias"] = _tensor(np.asarray(tree[f"{ours}_b"]))
    heads = [tree[n] for n in ("head_q", "head_k", "head_v")]
    sd["head.attention.in_proj_weight"] = _tensor(np.concatenate([np.asarray(h["kernel"]).T for h in heads]))
    sd["head.attention.in_proj_bias"] = _tensor(np.concatenate([np.asarray(h["bias"]) for h in heads]))
    for ours, theirs in (("head_out", "head.attention.out_proj"), ("head_fc1", "head.mlp.fc1"),
                         ("head_fc2", "head.mlp.fc2")):
        _linear(sd, theirs, tree[ours])
    for name, block in tree.items():
        if not name.startswith("block_"):
            continue
        lp = f"encoder.layers.{name[len('block_'):]}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[f"{lp}.{theirs}.weight"] = _tensor(np.asarray(block[f"{ours}_w"]))
            sd[f"{lp}.{theirs}.bias"] = _tensor(np.asarray(block[f"{ours}_b"]))
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
                             ("out", "self_attn.out_proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _linear(sd, f"{lp}.{theirs}", block[ours])
    return sd


def jax_xlm_roberta_params_to_torch(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX XLMRoberta params, or XLMRobertaWithHead's ({"backbone", "head_0",
    "head_2"}) -> xlm_roberta.XLMRoberta(WithHead)'s state dict."""
    tree = _params(params_np)
    backbone = tree.get("backbone", tree)
    sd = {f"{name}.weight": _tensor(np.asarray(backbone[name]))
          for name in ("token_embedding", "type_embedding", "pos_embedding")}
    sd["norm.weight"] = _tensor(np.asarray(backbone["norm"]["weight"]))
    sd["norm.bias"] = _tensor(np.asarray(backbone["norm"]["bias"]))
    for name, block in backbone.items():
        if not name.startswith("blocks_"):
            continue
        bp = f"blocks.{name[len('blocks_'):]}"
        for proj in ("q", "k", "v", "o"):
            _linear(sd, f"{bp}.attn.{proj}", block["attn"][proj])
        for norm in ("norm1", "norm2"):
            sd[f"{bp}.{norm}.weight"] = _tensor(np.asarray(block[norm]["weight"]))
            sd[f"{bp}.{norm}.bias"] = _tensor(np.asarray(block[norm]["bias"]))
        _linear(sd, f"{bp}.ffn.0", block["ffn_0"])
        _linear(sd, f"{bp}.ffn.2", block["ffn_2"])
    if "head_0" in tree:
        _linear(sd, "head.0", tree["head_0"])
        _linear(sd, "head.2", tree["head_2"])
    return sd
