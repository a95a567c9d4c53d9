"""The device mesh, a rank's slab of the token grid, and the sharding rules.

Counterpart of cosmos_predict2_tpu/parallel/mesh.py on
``torch.distributed.device_mesh``: one mesh with the axes

    (dp, fsdp, cp, tp)

dp replicates, fsdp shards parameters (ZeRO-3), cp shards the video tokens
(parallel/cp.py, parallel/ring_attention.py) and tp the heads and the MLP's
hidden width. ``mesh.get_group("cp")`` is the process group a DiT runs its
context parallelism over (networks/dit.py::set_context_parallel).

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
