"""LoRA post-training (parameter-efficient fine-tuning).

Counterpart of cosmos_predict2_tpu/training/lora.py, after the reference's
peft ``add_lora`` (rank, alpha, targets q/k/v/output_proj and both MLP
layers, fp32 adapters). The JAX package merges W' = W + (alpha/r) A B into
the frozen base inside its jitted step; the port computes unmerged, as peft
does: each adapted Linear returns ``x W^T + (alpha/r) (x A^T) B^T`` through
the ``adapter`` it carries (networks/dit.py::linear), so the frozen base
gets no weight-gradient products and is never written. The trainer sees
only the adapters (:meth:`LoRAModelWrapper.trainable_parameters`), so its
optimizer, EMA and checkpoints hold them alone.

Layout: the port's Linear weight is (out, in); an adapter holds ``lora_A``
(r, in) and ``lora_B`` (out, r), named ``{layer}.lora_A`` / ``{layer}.lora_B``
(JAX's {"a": (in, r), "b": (r, out)} transposed; utils/convert.py carries
one into the other). :func:`merge_lora` writes merged weights for export
and serving.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "output_proj", "mlp/layer1", "mlp/layer2")


def _is_target(name: str, targets) -> bool:
    """JAX's rule (a Dense kernel whose Flax path contains a target) on the
    port's module name, whose dots stand for the Flax path's slashes."""
    path = name.replace(".", "/")
    return any(t in path for t in targets)


def target_layers(net: nn.Module, targets=DEFAULT_TARGETS) -> dict[str, nn.Linear]:
    """The Linear layers of ``net`` that LoRA adapts, by module name."""
    return {n: m for n, m in net.named_modules() if isinstance(m, nn.Linear) and _is_target(n, targets)}


class LoRAAdapter(nn.Module):
    """x -> (alpha/r) (x A^T) B^T in x's dtype; A ~ kaiming-uniform with
    bound sqrt(6 / fan_in) (peft's default), B = 0, both fp32."""

    def __init__(self, layer: nn.Linear, rank: int, alpha: float, generator: torch.Generator):
        super().__init__()
        bound = math.sqrt(6.0 / layer.in_features)
        dev = layer.weight.device
        self.scale = alpha / rank
        self.lora_A = nn.Parameter(
            torch.empty((rank, layer.in_features), device=dev).uniform_(-bound, bound, generator=generator))
        self.lora_B = nn.Parameter(torch.zeros((layer.out_features, rank), device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(F.linear(x, self.lora_A.to(x.dtype)), (self.lora_B * self.scale).to(x.dtype))


def merge_lora(params: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor], alpha: float = 4.0,
               rank: int = 4) -> dict[str, torch.Tensor]:
    """``params`` (a state dict of the net) with W' = W + (alpha / rank) B A
    on the adapted layers, summed in fp32 and stored in W's dtype; ``lora``
    holds ``{layer}.lora_A`` and ``{layer}.lora_B`` by name."""
    scale = alpha / rank
    merged = dict(params)
    for key, a in lora.items():
        if not key.endswith(".lora_A"):
            continue
        layer = key[: -len(".lora_A")]
        w = params[f"{layer}.weight"]
        delta = (lora[f"{layer}.lora_B"].float() @ a.float()) * scale
        merged[f"{layer}.weight"] = (w.float() + delta.to(w.device)).to(w.dtype)
    return merged


def count_lora_params(lora: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in lora.values())


class LoRAModelWrapper:
    """A Video2WorldModel whose trainable parameters are LoRA adapters.

    The wrapper freezes the model's net; :meth:`init_lora` draws the
    adapters from ``generator`` and hangs them on the target layers, which
    then add them in every forward. Pass the wrapper to the Trainer in the
    model's place: it trains, averages and checkpoints the adapters alone.
    """

    def __init__(self, model, rank: int = 4, alpha: float = 4.0, targets=DEFAULT_TARGETS):
        self.model = model
        self.net = model.net
        self.config = model.config
        self.rank = rank
        self.alpha = alpha
        self.targets = targets
        self.adapters: Optional[dict[str, LoRAAdapter]] = None
        self.net.requires_grad_(False)

    def init_lora(self, generator: torch.Generator) -> dict[str, nn.Parameter]:
        """Draw an adapter per target layer, in module order, and attach it;
        returns the adapters' parameters by name."""
        if self.adapters is not None:
            raise RuntimeError("the adapters are already attached")
        self.adapters = {}
        for name, layer in target_layers(self.net, self.targets).items():
            adapter = LoRAAdapter(layer, self.rank, self.alpha, generator)
            object.__setattr__(layer, "adapter", adapter)  # not a submodule: the net's state dict stays the base's
            self.adapters[name] = adapter
        return self.trainable_parameters()

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        if self.adapters is None:
            raise RuntimeError("call init_lora first")
        return {f"{name}.{p}": getattr(a, p) for name, a in self.adapters.items() for p in ("lora_A", "lora_B")}

    def merged(self) -> dict[str, torch.Tensor]:
        """The net's state dict with the adapters merged in."""
        return merge_lora(self.net.state_dict(), self.trainable_parameters(), alpha=self.alpha, rank=self.rank)

    def sample_train_draws(self, generator: torch.Generator, latent_shape: tuple[int, ...]):
        return self.model.sample_train_draws(generator, latent_shape)

    def training_step(self, x0, condition, draws):
        return self.model.training_step(x0, condition, draws)
