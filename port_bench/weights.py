"""Seeded weights and inputs of a cell, made on the device in a few large calls.

The benchmark, not the program, owns the weights: :func:`dit_spec` lists the
DiT's parameters by their checkpoint names (the upstream state-dict keys,
which the port keeps) from the configuration file alone, and
:func:`fill` writes one seed's values into any set of tensors with those
names: the program's own parameters, or the reference's fp32 copies. A
matrix or conv weight is drawn from N(0, 1 / fan_in) clipped at 3 standard
deviations and rounded to bf16, the type it is served in, so the program's
bf16 weights and the reference's fp32 copies hold the same numbers; the
AdaLN and timestep layers, which the port keeps in fp32, stay fp32. The
per-head q / k RMSNorm weights are 2 + N(0, 1/16) clipped at 3 standard
deviations, rounded to bf16 (the program multiplies by them in bf16): their
square sets the logits' spread, about 4 standard deviations, so attention
over 84,480 keys is peaked as a trained net's is, and not the near-uniform
average that unit weights give, in which the attention output all but
vanishes from the block. The timestep norm's weight is ones and biases are
zeros, as in the port's seeded init.

The draws come from one ``torch.Generator`` on the device, ``CHUNK``
normals a call, consumed leaf after leaf in the spec's order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 1 << 28  # normals per generator call (1 GiB of fp32)


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use (``tags``) of the run's ``--seed``."""
    return int(np.random.SeedSequence([seed % (1 << 64), *tags]).generate_state(2, np.uint64)[0] >> np.uint64(1))


def in_channels(cfg: dict) -> int:
    return cfg["in_channels"] + int(cfg["concat_condition_mask"]) + int(cfg["concat_padding_mask"])


def dit_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every DiT parameter; kind is ``matmul`` (bf16
    values), ``fp32``, ``qk_norm``, ``ones`` or ``zeros``."""
    d, lora = cfg["model_channels"], cfg["adaln_lora_dim"]
    hd = cfg["head_dim"]
    ff = int(d * cfg["mlp_ratio"])
    ctx = cfg["crossattn_emb_channels"]
    patch = in_channels(cfg) * cfg["patch_temporal"] * cfg["patch_spatial"] ** 2
    out = cfg["patch_spatial"] ** 2 * cfg["patch_temporal"] * cfg["out_channels"]
    spec = [("x_embedder.proj.1.weight", (d, patch), "matmul"),
            ("t_embedder.1.linear_1.weight", (d, d), "fp32"),
            ("t_embedder.1.linear_2.weight", (3 * d, d), "fp32"),
            ("t_embedding_norm.weight", (d,), "ones"),
            ("crossattn_proj.0.weight", (ctx, cfg["crossattn_proj_in_channels"]), "matmul"),
            ("crossattn_proj.0.bias", (ctx,), "zeros")]
    for i in range(cfg["num_blocks"]):
        p = f"blocks.{i}."
        for attn, kv_in in (("self_attn", d), ("cross_attn", ctx)):
            spec += [(f"{p}{attn}.q_proj.weight", (d, d), "matmul"),
                     (f"{p}{attn}.k_proj.weight", (d, kv_in), "matmul"),
                     (f"{p}{attn}.v_proj.weight", (d, kv_in), "matmul"),
                     (f"{p}{attn}.q_norm.weight", (hd,), "qk_norm"),
                     (f"{p}{attn}.k_norm.weight", (hd,), "qk_norm"),
                     (f"{p}{attn}.output_proj.weight", (d, d), "matmul")]
        spec += [(f"{p}mlp.layer1.weight", (ff, d), "matmul"), (f"{p}mlp.layer2.weight", (d, ff), "matmul")]
        for name in ("self_attn", "cross_attn", "mlp"):
            spec += [(f"{p}adaln_modulation_{name}.1.weight", (lora, d), "fp32"),
                     (f"{p}adaln_modulation_{name}.2.weight", (3 * d, lora), "fp32")]
    spec += [("final_layer.adaln_modulation.1.weight", (lora, d), "fp32"),
             ("final_layer.adaln_modulation.2.weight", (2 * d, lora), "fp32"),
             ("final_layer.linear.weight", (out, d), "matmul")]
    return spec


@torch.no_grad()
def fill(spec, dest: dict[str, torch.Tensor], seed: int) -> None:
    """Write the seed's values into ``dest`` (name -> tensor of the spec's
    shape, any float dtype, one device), leaf by leaf from a few large
    generator calls. Every leaf of the spec must be in ``dest``."""
    missing = [name for name, _, _ in spec if name not in dest]
    if missing:
        raise KeyError(f"{len(missing)} parameters have no destination, e.g. {missing[:3]}")
    device = next(iter(dest.values())).device
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    pool, used = torch.empty(0, device=device), 0
    remaining = sum(int(np.prod(shape)) for _, shape, kind in spec if kind not in ("ones", "zeros"))
    for name, shape, kind in spec:
        t = dest[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: destination {tuple(t.shape)}, spec {tuple(shape)}")
        if kind == "ones":
            t.fill_(1.0)
            continue
        if kind == "zeros":
            t.zero_()
            continue
        n = int(np.prod(shape))
        if used + n > pool.numel():
            pool = torch.randn(max(min(CHUNK, remaining), n), generator=gen, device=device)
            used = 0
        remaining -= n
        w = pool[used:used + n].view(shape).clamp(-3.0, 3.0)
        used += n
        w = 2.0 + 0.25 * w if kind == "qk_norm" else w * (1.0 / math.prod(shape[1:]) ** 0.5)
        if kind in ("matmul", "qk_norm"):
            w = w.to(torch.bfloat16)
        t.copy_(w)


def normal(shape, seed: int, tag: int, device) -> torch.Tensor:
    """One standard-normal fp32 input tensor of the run, from its own stream."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, tag))
    return torch.randn(shape, generator=gen, device=device)
