"""What the prompt encoders share: softmax attention in the JAX package's
numerics, Flax's ``nn.Dense``, an fp32 LayerNorm, and building a tower at
full width. Their RMSNorms are networks/dit.py's ``RMSNorm``.

* :func:`dense` is Flax's ``nn.Dense(dtype=...)``: input and weight cast to
  the compute dtype, the product rounded to it, then the bias (cast too)
  added in it. In bf16 that is two roundings where ``F.linear(x, w, b)``
  makes one; joining the bias to the product moved the towers' bf16
  hidden states from the JAX package's nearly as far as bf16 is from fp32.
* :func:`silu` and :func:`gelu` are ``jax.nn.silu`` and ``jax.nn.gelu``
  written out op by op in x's dtype, as XLA runs them (the logistic as
  1 / (1 + exp(-x)); the constants cast to x's dtype): in bf16 each step
  rounds, and ``F.silu`` / ``F.gelu``, which round once, differ from them
  by an ulp on ~40% of the elements.
* :func:`attention` is the JAX towers' ``einsum(..., preferred_element_type
  =float32)`` pair: the logits of the (compute-dtype) q and k summed in fp32,
  the softmax in fp32, the probabilities cast to v's dtype and P V summed in
  fp32. Products of bf16 values are exact in fp32, so upcasting q, k, P and
  v and multiplying in fp32 gives the same sums. None of these attentions
  fits K1's contract (causal GQA, a relative-position bias and no scaling, a
  pad mask, a segment mask, heads of 72 or 80), and none is long: the
  longest is 1,024 tokens, so they stay plain PyTorch, as the JAX package
  writes them.
* :func:`build_tower` makes a tower on the meta device, stores its matmul
  weights in the compute dtype and materialises it on ``device``; with a
  seed, :func:`init_weights` draws its weights there. A 7B tower never
  exists in fp32 on the host.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from cosmos_predict2_tpu_torch.networks.dit import RMSNorm
from cosmos_predict2_tpu_torch.parallel.mesh import tp_linear


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``nn.Dense(dtype=dtype)``: x W^T in ``dtype``, then + b in
    ``dtype``. A tensor-parallel layer (parallel/mesh.py::parallelize) runs
    through ``tp_linear`` on the local tensors."""
    weight, bias = layer.weight.to(dtype), None if layer.bias is None else layer.bias.to(dtype)
    if isinstance(weight, DTensor):
        return tp_linear(x.to(dtype), weight, bias)
    y = F.linear(x.to(dtype), weight)
    return y if bias is None else y + bias


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), the logistic as XLA expands it."""
    return x * torch.reciprocal(1 + torch.exp(-x))


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (no device tensor:
    making one per call is a host-to-device copy)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """``jax.nn.gelu``: with ``approximate`` the tanh form, else 0.5 x erfc(-x / sqrt(2))."""
    c = lambda v: _constant(v, x.dtype)  # noqa: E731  a constant in x's dtype
    if approximate:
        return x * (0.5 * (1.0 + torch.tanh(c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * (x * x))))))
    return (0.5 * x) * torch.erfc(-x * c(math.sqrt(0.5)))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Affine LayerNorm computed in fp32 (weights too), cast back to x.dtype."""
    out = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return out.to(x.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Skv, H, D) -> (B, Sq, H, D) in q's dtype.
    Logits summed in fp32, times ``scale`` (none: T5), plus the additive
    fp32 ``bias`` (broadcast to (B, H, Sq, Skv)); where the boolean ``mask``
    is False the logit is -1e30 (a segment mask); softmax in fp32;
    probabilities cast to v's dtype; P V summed in fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if scale is not None:
        logits = logits * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = logits.softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator, embed_std: float = 0.02,
                 param_std: float = 0.02) -> nn.Module:
    """Seeded random weights: Linear and conv weights truncated normal with
    std 1/sqrt(fan_in) (cut at 3 std), biases 0; embeddings normal with
    ``embed_std``; norm weights 1 and LayerNorm biases 0; any other parameter
    normal with ``param_std``. Each tensor is drawn in fp32 and rounded once
    to its stored dtype; the generator lives on the parameters' device."""

    def draw(p: torch.Tensor, fill: Callable[[torch.Tensor], None]) -> None:
        w = p if p.dtype == torch.float32 else torch.empty_like(p, dtype=torch.float32)
        fill(w)
        if w is not p:
            p.copy_(w)

    for m in module.modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            std = 1.0 / math.sqrt(m.weight[0].numel())
            draw(m.weight, lambda w: nn.init.trunc_normal_(w, 0.0, std, -3 * std, 3 * std, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            draw(m.weight, lambda w: w.normal_(0.0, embed_std, generator=generator))
        elif isinstance(m, (nn.LayerNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        else:
            for p in own.values():
                draw(p, lambda w: w.normal_(0.0, param_std, generator=generator))
    return module


def build_tower(make: Callable[[], nn.Module], device: torch.device | str, dtype: torch.dtype,
                seed: Optional[int] = None, extra: Callable[[nn.Module], Iterable[nn.Parameter]] = lambda m: (),
                **init) -> nn.Module:
    """``make()`` built on the meta device, its Linear weights (and
    ``extra(module)``) stored in ``dtype`` (the rounding ``dense`` would
    make on every call, made once), materialised on ``device``; with
    ``seed`` its weights drawn there by :func:`init_weights` (``init``: its
    standard deviations), else left unset for a checkpoint to fill. Frozen."""
    with torch.device("meta"):
        module = make()
    for p in [m.weight for m in module.modules() if isinstance(m, nn.Linear)] + list(extra(module)):
        p.data = p.data.to(dtype)
    module = module.to_empty(device=device)
    if seed is not None:
        init_weights(module, torch.Generator(device=device).manual_seed(seed), **init)
    return module.eval().requires_grad_(False)
