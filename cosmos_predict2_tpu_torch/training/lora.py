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

On a mesh (a net sharded by parallel/mesh.py::parallelize, as JAX's
``launch`` shards the base before it wraps it) every rank draws the whole
adapters from the same generator and keeps its part: each factor becomes a
DTensor on the net's (dp, fsdp x cp, tp) mesh, replicated over the data
axes and laid out over tp as its layer: a column-parallel layer's
``lora_B`` split over the out features (``lora_A`` whole), a row-parallel
layer's ``lora_A`` split over the in features (``lora_B`` whole, its
partial product joining the base's all-reduce: parallel/mesh.py::
tp_linear). The adapters compute on their local tensors, so after the
backward each rank holds its own share of every gradient;
:meth:`LoRAModelWrapper.reduce_gradients` averages them over dp x fsdp x
cp, as FSDP2 averages the base's, and sums a factor that is whole over tp
(each tp rank saw only its features) over tp. The optimizer, the EMA, the
global norm and the DCP checkpoints then take the factors as the base's
sharded parameters (:attr:`LoRAModelWrapper.state_module` keys them by
name); the base stays frozen and is not saved.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from cosmos_predict2_tpu_torch.parallel import comm
from cosmos_predict2_tpu_torch.parallel.mesh import local_tensor, tp_plan

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
        """x: the layer's input, or under tensor parallelism its local
        input (this rank's in features of a row-parallel layer)."""
        a, b = local_tensor(self.lora_A), local_tensor(self.lora_B)
        return F.linear(F.linear(x, a.to(x.dtype)), (b * self.scale).to(x.dtype))

    @torch.no_grad()
    def distribute(self, mesh, style: Optional[str]) -> None:
        """Lay the whole factors out on ``mesh`` (dp, fsdp_cp, tp) as this
        rank's parts, cut without communication: replicated over the data
        axes; over tp, by the layer's ``style`` ("col": ``lora_B`` on its
        out features, "row": ``lora_A`` on its in features, None: whole)."""
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        for name in ("lora_A", "lora_B"):
            split = {("col", "lora_B"): Shard(0), ("row", "lora_A"): Shard(1)}.get((style, name), Replicate())
            t = distribute_tensor(getattr(self, name).data, mesh, [Replicate(), Replicate(), split], src_data_rank=None)
            setattr(self, name, nn.Parameter(t))


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
    On a mesh, wrap the net after parallel/mesh.py::parallelize.
    """

    def __init__(self, model, rank: int = 4, alpha: float = 4.0, targets=DEFAULT_TARGETS):
        self.model = model
        self.net = model.net
        self.config = model.config
        self.rank = rank
        self.alpha = alpha
        self.targets = targets
        self.adapters: Optional[dict[str, LoRAAdapter]] = None
        self.state_module: Optional[nn.Module] = None
        self.net.requires_grad_(False)

    def init_lora(self, generator: torch.Generator) -> dict[str, nn.Parameter]:
        """Draw an adapter per target layer, in module order, and attach it;
        on a mesh, lay each out as its layer (:meth:`LoRAAdapter.distribute`).
        Returns the adapters' parameters by name."""
        if self.adapters is not None:
            raise RuntimeError("the adapters are already attached")
        mesh = getattr(self.net, "data_mesh", None)  # parallel/mesh.py::parallelize
        plan = tp_plan(self.net) if mesh is not None else {}
        self.adapters = {}
        self.state_module = nn.Module()
        for name, layer in target_layers(self.net, self.targets).items():
            adapter = LoRAAdapter(layer, self.rank, self.alpha, generator)
            if mesh is not None:
                adapter.distribute(mesh, plan.get(name))
            object.__setattr__(layer, "adapter", adapter)  # not a submodule: the net's state dict stays the base's
            self.adapters[name] = adapter
            *path, leaf = name.split(".")
            node = self.state_module
            for part in path:
                if part not in node._modules:
                    node.add_module(part, nn.Module())
                node = node._modules[part]
            node.add_module(leaf, adapter)  # the adapters by their layers' names: the trainer's mesh state keys
        return self.trainable_parameters()

    def reduce_gradients(self) -> None:
        """On a mesh, after the backward: each factor's gradient averaged
        over the dp x fsdp x cp ranks, and a factor whole over tp summed
        over tp first, each in place on its local tensor (two buckets). A
        no-op on one device."""
        mesh = getattr(self.net, "data_mesh", None)
        if mesh is None or not dist.is_initialized():
            return
        params = list(self.trainable_parameters().values())
        data = [mesh.get_group(axis) for axis in ("dp", "fsdp_cp") if mesh[axis].size() > 1]
        count = mesh["dp"].size() * mesh["fsdp_cp"].size()
        split = [p for p in params if p.placements[-1].is_shard()]
        whole = [p for p in params if not p.placements[-1].is_shard()]
        tp_whole = mesh["tp"].size() > 1
        for bucket, groups in ((split, data), (whole, [dist.group.WORLD] if tp_whole or data else [])):
            if not bucket or not groups:
                continue
            grads = [local_tensor(p.grad) for p in bucket]
            flat = torch.cat([g.reshape(-1) for g in grads])
            for group in groups:
                comm.all_reduce(flat, group)
            flat /= count
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

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
