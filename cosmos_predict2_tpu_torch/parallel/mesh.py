"""The device mesh, a rank's slab of the token grid, the sharding rules and
their application to a module.

Counterpart of cosmos_predict2_tpu/parallel/mesh.py on
``torch.distributed.device_mesh``: one mesh with the axes

    (dp, fsdp, cp, tp)

dp replicates, fsdp shards parameters (ZeRO-3), cp shards the video tokens
(parallel/cp.py, parallel/ring_attention.py) and tp the heads and the MLP's
hidden width. ``mesh.get_group("cp")`` is the process group a DiT runs its
context parallelism over (networks/dit.py::set_context_parallel).

:func:`parallelize` is the counterpart of the JAX package's
``shard_params``: tensor parallelism through DTensor, then FSDP2 over the
data axes. The hand-written kernels take plain tensors, so the modules
compute on local tensors: :func:`tp_linear` runs a tensor-parallel
projection as ``ColwiseParallel`` / ``RowwiseParallel`` run it and returns
the local output, :func:`tp_local` gives a replicated parameter's local
tensor.

:class:`TokenSlab` is a rank's contiguous share of a (T, H, W) token grid:
whole frames when the cp degree divides T (the latent T axis, as the JAX
package shards it), else whole rows of one frame (a streaming block of one
frame shards its tokens). :func:`param_sharding_rules` is the JAX package's
rule written for the port's state-dict names and torch's (out, in) weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from cosmos_predict2_tpu_torch.parallel import comm

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_CP = "cp"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_CP, AXIS_TP)


def make_mesh(dp: int = 1, fsdp: int = 1, cp: int = 1, tp: int = 1, device_type: str = "cuda", pp: int = 1):
    """The (dp, fsdp, cp, tp) DeviceMesh over the default process group's
    ranks. ``pp`` is validated == 1: no pipeline schedule exists (as in the
    JAX package and the reference). The product of the sizes must be the
    world size; one process with no group gets a group of itself."""
    if pp != 1:
        raise ValueError(
            f"pipeline_model_parallel_size={pp} requested, but no pipeline "
            "schedule exists (parity: the reference also only threads the "
            "knob); use fsdp/cp/tp axes instead"
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    total = dp * fsdp * cp * tp
    if total != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{cp}x{tp}={total} != {world} devices")
    if not dist.is_initialized():
        from cosmos_predict2_tpu_torch.parallel.launch import init_single_process

        init_single_process(device_type)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, fsdp, cp, tp), mesh_dim_names=MESH_AXES)


def single_device_mesh(device_type: str = "cuda"):
    return make_mesh(1, 1, 1, 1, device_type=device_type)


def divisible_cp(state_t: int, cp: int) -> bool:
    """Whether ``state_t`` latent frames split evenly over a cp degree
    (a mesh's ``mesh["cp"].size()``)."""
    return state_t % cp == 0


@dataclasses.dataclass(frozen=True)
class TokenSlab:
    """Rank ``rank`` of ``size``'s share of a (T, H, W) token grid, in
    row-major token order: ``rows`` consecutive rows of the T * H rows."""

    grid: tuple[int, int, int]
    size: int
    rank: int

    @property
    def rows(self) -> int:
        return self.grid[0] * self.grid[1] // self.size

    @property
    def frames(self) -> tuple[int, int]:
        """[first, last + 1) of the frames the slab touches."""
        H = self.grid[1]
        first = self.rank * self.rows
        return first // H, (first + self.rows - 1) // H + 1

    @property
    def local_grid(self) -> tuple[int, int, int]:
        """(frames, rows per frame, W) of the slab."""
        T, H, W = self.grid
        if self.rows % H == 0:
            return self.rows // H, H, W
        return 1, self.rows, W

    @property
    def tokens(self) -> tuple[int, int]:
        """[first, last + 1) of the slab's tokens."""
        W = self.grid[2]
        return self.rank * self.rows * W, (self.rank + 1) * self.rows * W

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The slab of x whose dims ``dim``, ``dim + 1`` and ``dim + 2`` are
        (T, H, W), shaped with the slab's local grid there."""
        T, H, W = self.grid
        shape = x.shape
        flat = x.reshape(shape[:dim] + (T * H,) + shape[dim + 2:])
        r0 = self.rank * self.rows
        return flat.narrow(dim, r0, self.rows).reshape(shape[:dim] + self.local_grid + shape[dim + 3:])

    def take_frames(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The frames the slab touches of x, whose dim ``dim`` is T (a size 1 broadcasts)."""
        if x.shape[dim] == 1:
            return x
        t0, t1 = self.frames
        return x.narrow(dim, t0, t1 - t0)

    def gather(self, x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
        """Every rank's slab of x (the local grid at ``dim``) back into the
        whole (T, H, W) grid there."""
        T, H, W = self.grid
        shape = x.shape
        rows = x.reshape(shape[:dim] + (self.rows, W) + shape[dim + 3:])
        whole = comm.all_gather(rows, group, dim)
        return whole.reshape(shape[:dim] + (T, H, W) + shape[dim + 3:])


def token_slab(grid: tuple[int, int, int], size: int, rank: int) -> TokenSlab:
    """The rank's :class:`TokenSlab`; raises unless the T * H rows split
    evenly into whole frames or into whole rows of single frames."""
    T, H, W = grid
    if (T * H) % size:
        raise ValueError(f"context parallelism over {size} ranks: the {T} x {H} token rows of the grid {grid} do not "
                         "split evenly")
    rows = T * H // size
    if rows % H and H % rows:
        raise ValueError(f"context parallelism over {size} ranks: a slab of {rows} token rows of the grid {grid} is "
                         "neither whole frames nor rows of one frame")
    return TokenSlab(tuple(grid), size, rank)


# the JAX package's name patterns, on the port's dotted state-dict names
_COL_KEYS = ("q_proj", "k_proj", "v_proj", "layer1", "gate_proj", "up_proj", ".ffn.0.", ".q.", ".k.", ".v.",
             ".k_img.", ".v_img.")
_ROW_KEYS = ("output_proj", "layer2", "o_proj", "down_proj", ".ffn.2.", ".o.")


def param_sharding_rules(name: str, shape: tuple[int, ...]) -> tuple[Optional[str], ...]:
    """FSDP (+TP) placement of a parameter: per dim, the mesh axis it is
    sharded over or None; () for a replicated one.

    The JAX package's rule (the DiT, the Wan DiT and the Qwen LM): scalars,
    biases and norm weights replicate; an attention or MLP projection is
    tensor-parallel over tp (column parallel q / k / v / MLP-in on its out
    features, row parallel out-projection / MLP-out on its in features) and
    fsdp-sharded on the other dim; any other weight is fsdp-sharded on its
    largest dim. A 2D weight here is torch's (out, in), the transpose of
    JAX's (in, out) kernel, so column parallel shards dim 0 here where JAX
    shards dim 1, and the largest dim is picked as JAX picks it on (in, out)
    (the in features on a tie).
    """
    joined = "." + name + "."
    ndim = len(shape)
    if ndim < 2:
        return ()
    if ndim > 2:
        spec = [None] * ndim
        spec[int(np.argmax(shape))] = AXIS_FSDP
        return tuple(spec)
    out_dim, in_dim = 0, 1
    if any(k in joined for k in _COL_KEYS):
        tp_dim = out_dim
    elif any(k in joined for k in _ROW_KEYS):
        tp_dim = in_dim
    else:
        spec = [None, None]
        spec[in_dim if shape[in_dim] >= shape[out_dim] else out_dim] = AXIS_FSDP
        return tuple(spec)
    spec = [None, None]
    spec[tp_dim] = AXIS_TP
    spec[1 - tp_dim] = AXIS_FSDP
    return tuple(spec)


def data_mesh(mesh):
    """The mesh FSDP2 and tensor parallelism share: (dp, fsdp x cp, tp) over
    the ranks of ``mesh``, named ("dp", "fsdp_cp", "tp"). The batch is
    sharded over (dp, fsdp) and the tokens over cp, so a parameter's
    gradient is reduced over all three; FSDP2's mean over the folded
    fsdp x cp dim and the replicated dp dim is that reduction."""
    from torch.distributed.device_mesh import init_device_mesh

    dp, fsdp, cp, tp = (mesh[a].size() for a in MESH_AXES)
    return init_device_mesh(mesh.device_type, (dp, fsdp * cp, tp), mesh_dim_names=("dp", "fsdp_cp", "tp"))


def tp_plan(module: nn.Module) -> dict[str, str]:
    """Linear name -> "col" or "row": the projections that
    :func:`param_sharding_rules` makes tensor-parallel."""
    plan = {}
    for name, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            spec = param_sharding_rules(f"{name}.weight", tuple(sub.weight.shape))
            if AXIS_TP in spec:
                plan[name] = "col" if spec.index(AXIS_TP) == 0 else "row"
    return plan


# the per-head norms of an attention whose q / k projections are column parallel
_HEAD_NORMS = ("q_norm", "k_norm")
# the Wan DiT's q / k norms over the whole width, by the projection whose features they scale
_WIDTH_NORMS = {"norm_q": "q", "norm_k": "k", "norm_k_img": "k_img"}


def parallelize(module: nn.Module, mesh) -> nn.Module:
    """Shard ``module`` over ``mesh`` by :func:`param_sharding_rules`, in
    place, and return it.

    1. With tp > 1, tensor parallelism over ``tp`` through DTensor:
       ``ColwiseParallel`` on the column keys and ``RowwiseParallel`` on
       the row keys (the modules run them through :func:`tp_linear`, with
       local outputs), and the per-head q / k norms of those attentions
       replicated over tp (:func:`tp_local`). The Wan DiT's q / k norms
       span the whole width: their weights are sharded over tp like the
       out features they scale, Shard(0) as the column-parallel q / k /
       k_img, and :func:`tp_rms_norm` sums the squares over tp. That
       placement keeps a rank's gradient its own slice (each element of
       the weight scales features of one rank only), where a replicated
       weight, as the JAX rule keeps every vector and as the per-head
       norms stay, would take a partial sum to reduce.
    2. FSDP2 ``fully_shard`` of each block (``module.blocks`` or
       ``module.layers``) and then of the whole module over (dp, fsdp x
       cp) (:func:`data_mesh`): HSDP, dp replicating; a 2-D weight is
       sharded on the dim the rule gives fsdp (Shard(0) where that dim does
       not split evenly, FSDP2 padding only dim 0), others on dim 0 (the
       JAX rule replicates vectors; FSDP2 shards every parameter).

    FSDP2 averages each gradient over the dp x fsdp x cp ranks. With the
    batch over (dp, fsdp) and each rank's loss its rows' mean, that is the
    global batch's gradient. Under cp each rank of a cp group takes the
    loss of the whole (gathered) output, and the exit all-gather's backward
    sums the cp ranks' gradients into each slab: every rank's gradient is
    cp times its slab's share, and the mean over cp gives the one-device
    gradient (networks/dit.py::set_context_parallel).
    """
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    flat = data_mesh(mesh)
    tp = flat["tp"]
    if tp.size() > 1:
        plan = tp_plan(module)
        parallelize_module(module, tp, {n: ColwiseParallel() if s == "col" else RowwiseParallel()
                                        for n, s in plan.items()})
        for name, sub in module.named_modules():
            prefix = f"{name}." if name else ""
            norms = {norm: [Shard(0)] for norm, proj in _WIDTH_NORMS.items() if plan.get(prefix + proj) == "col"}
            if plan.get(prefix + "q_proj") == "col":
                norms.update((norm, [Replicate()]) for norm in _HEAD_NORMS)
            for norm, placements in norms.items():
                layer = getattr(sub, norm, None)
                if layer is not None:
                    layer.weight = nn.Parameter(distribute_tensor(layer.weight.data, tp, placements),
                                                requires_grad=layer.weight.requires_grad)
    fsdp_size = flat["fsdp_cp"].size()
    names = {id(p): n for n, p in module.named_parameters()}

    def placement(param) -> Shard:
        spec = param_sharding_rules(names[id(param)], tuple(param.shape))
        if len(spec) == 2 and AXIS_FSDP in spec:
            dim = spec.index(AXIS_FSDP)
            if dim == 0 or param.shape[dim] % fsdp_size == 0:
                return Shard(dim)
        return Shard(0)

    dp_mesh = flat["dp", "fsdp_cp"]
    blocks = getattr(module, "blocks", None)
    if blocks is None:
        blocks = getattr(module, "layers", None)
    for block in blocks or ():
        fully_shard(block, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(module, mesh=dp_mesh, shard_placement_fn=placement)
    module.mesh = mesh  # the trainer reads it (training/trainer.py)
    module.data_mesh = flat  # LoRA adapters are laid out on it (training/lora.py)
    return module


def tp_linear(x: torch.Tensor, weight: DTensor, bias=None, adapter=None) -> torch.Tensor:
    """x W^T (+ b) for a tensor-parallel projection: ``weight`` (and
    ``bias``) as :func:`parallelize` left them, DTensors on the tp mesh; x
    and the result plain local tensors. Column parallel (weight Shard(0)):
    x is the whole input and the result this rank's output features; the
    backward sums x's gradient over tp. Row parallel (Shard(1)): x is this
    rank's input features and the result the whole output, summed over tp.
    ``ColwiseParallel`` and ``RowwiseParallel`` compute it so; the bias is
    added after the product, in the result's dtype.

    ``adapter`` (a LoRA adapter laid out as its layer, training/lora.py)
    maps the local x to its term of the local result: column parallel,
    this rank's output features, its share of x's gradient joining the
    product's in the one sum over tp; row parallel, a partial sum that
    joins the product's before the one all-reduce."""
    mesh = weight.device_mesh
    if weight.placements == (Shard(0),):
        xd = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        y = F.linear(xd, weight).to_local()
        if adapter is not None:
            y = y + adapter(xd.to_local(grad_placements=[Partial()]))
    elif weight.placements == (Shard(1),):
        y = F.linear(DTensor.from_local(x, mesh, [Shard(x.ndim - 1)], run_check=False), weight)
        if adapter is not None:
            y = y + DTensor.from_local(adapter(x), mesh, [Partial()], run_check=False)
        y = y.redistribute(mesh, [Replicate()]).to_local()
    else:
        raise ValueError(f"tp_linear: a weight with placements {weight.placements} is not column or row parallel")
    return y if bias is None else y + bias.to_local()


def tp_rms_norm(x: torch.Tensor, weight: DTensor, eps: float) -> torch.Tensor:
    """RMSNorm over a width sharded over tp (ops/normalization.py::rms_norm's
    numerics, fp32 inside): x holds this rank's features, ``weight`` is the
    norm's Shard(0) DTensor on the tp mesh (:func:`parallelize`). The fp32
    sums of squares are summed over tp (parallel/comm.py::sum_over_group,
    whose backward sums their gradients too) and divided by the whole
    width; x is scaled by this rank's slice of the weight, whose gradient
    is then its own slice."""
    if weight.placements != (Shard(0),):
        raise ValueError(f"tp_rms_norm: a weight with placements {weight.placements} is not sharded over tp")
    group = weight.device_mesh.get_group()
    xf = x.float()
    squares = comm.sum_over_group(xf.square().sum(dim=-1, keepdim=True), group)
    out = (xf * torch.rsqrt(squares / weight.shape[0] + eps)).to(x.dtype)
    return out * weight.to_local().to(x.dtype)


def tp_local(t: torch.Tensor) -> torch.Tensor:
    """A parameter as a plain tensor: itself, or the local tensor of a
    DTensor that :func:`parallelize` replicated over tp (a per-head q / k
    norm). Such a norm is applied to this rank's heads only, so its local
    gradient is a partial sum over tp; it is marked so (``Partial``), and
    FSDP2 sums it over tp before the reduce-scatter."""
    if not isinstance(t, DTensor):
        return t
    if t.placements != (Replicate(),):
        raise ValueError(f"tp_local: a parameter with placements {t.placements} is not replicated over tp")
    return t.to_local(grad_placements=[Partial()])


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A tensor, or a DTensor's local shard (its storage, for in-place updates)."""
    return t.to_local() if isinstance(t, DTensor) else t


def copies(t: torch.Tensor) -> int:
    """On how many ranks of the default group the local shard of ``t`` lies:
    a plain tensor on all of them; a DTensor on the world size over the
    number of distinct shards (the product of its sharded mesh dims)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not isinstance(t, DTensor):
        return world
    shards = 1
    for i, p in enumerate(t.placements):
        if not (p.is_replicate() or p.is_partial()):  # Shard, or FSDP2's _StridedShard over a tp shard
            shards *= t.device_mesh.size(i)
    return world // shards
