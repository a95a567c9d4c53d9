"""The collectives of the parallel routes, and a log of what enters each.

Every collective the port's CP and training-mesh code issues goes through
this module: ``all_to_all`` (Ulysses), ``all_gather`` (the net's exit, the
VAE's middle attention), ``exchange`` (point-to-point: the ring's K/V hops,
forward and backward, the backward's dK / dV hops, and the VAE's halos),
``all_reduce`` (the trainer's global gradient norm and loss, the LoRA
adapters' gradient buckets), ``sum_over_group`` (the Wan DiT's norm under
tensor parallelism: an all-reduce whose backward all-reduces). The
all-to-all is the autograd-aware one of ``torch.distributed.nn.functional``
and the all-gather this module's own, whose backward reduce-scatters, so a
gradient flows back through them. FSDP2's own all-gathers and
reduce-scatters of the parameters and gradients, and the DTensor
collectives of tensor parallelism (parallel/mesh.py::parallelize), stay
inside torch and are not logged.

:data:`COMM` counts, per kind, the calls and the bytes that enter them on
this rank (a point-to-point call counts the tensors it sends). Inside
``with COMM.recording() as records:`` each call also appends a
:class:`CommRecord`, which the communication-pattern tests read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.nn import functional as dist_fn

# newer torch marks these autograd collectives deprecated in favour of a private module
warnings.filterwarnings("ignore", message=r"torch\.distributed\.nn\.functional\.", category=FutureWarning)


@dataclasses.dataclass(frozen=True)
class CommRecord:
    kind: str  # "all_to_all", "all_gather", "send", "all_reduce", "reduce_scatter" (the gather's backward)
    shape: tuple[int, ...]
    dtype: torch.dtype
    nbytes: int
    peer: Optional[int] = None  # a send's destination, a rank of its group


class CommLog:
    def __init__(self):
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self._records: Optional[list] = None

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def add(self, kind: str, t: torch.Tensor, peer: Optional[int] = None) -> None:
        nbytes = t.numel() * t.element_size()
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        if self._records is not None:
            self._records.append(CommRecord(kind, tuple(t.shape), t.dtype, nbytes, peer))

    @contextlib.contextmanager
    def recording(self):
        outer, self._records = self._records, []
        try:
            yield self._records
        finally:
            self._records = outer


COMM = CommLog()


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks`` (c, ...): chunk j goes to rank j of ``group``; returns
    (c, ...) whose chunk j came from rank j. Differentiable."""
    chunks = chunks.contiguous()
    COMM.add("all_to_all", chunks)
    return dist_fn.all_to_all_single(torch.empty_like(chunks), chunks, group=group)


class _AllGather(torch.autograd.Function):
    """All-gather along a dim; its backward is the reduce-scatter of the
    output gradient: each rank gets the sum over the ranks of its part.
    (``torch.distributed.nn``'s all-gather emulates that off NCCL with
    scatters that take a subgroup's ranks for global ones.)"""

    @staticmethod
    def forward(ctx, t, group, dim: int):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(t) for _ in range(group_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        c = group_size(ctx.group)
        chunks = torch.stack(grad.chunk(c, dim=ctx.dim)).contiguous()  # chunk j: rank j's part
        COMM.add("reduce_scatter", chunks)
        out = torch.empty_like(chunks[0])
        if dist.get_backend(ctx.group) == "nccl":
            dist.reduce_scatter_tensor(out, chunks, group=ctx.group)
        else:  # gloo has no reduce-scatter: all-to-all, then the sum
            got = torch.empty_like(chunks)
            dist.all_to_all_single(got, chunks, group=ctx.group)
            torch.sum(got, dim=0, out=out)
        return out, None, None


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order.
    Differentiable: the backward reduce-scatters (logged
    ``reduce_scatter``)."""
    t = t.contiguous()
    COMM.add("all_gather", t)
    return _AllGather.apply(t, group, dim)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (default: every rank) in place and return
    it. Not differentiable."""
    COMM.add("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


class _SumOverGroup(torch.autograd.Function):
    """The sum of every rank's ``t``; the backward sums the output gradient
    over the group too: each rank's output feeds only its own share of the
    loss (a norm's sum of squares under tensor parallelism scales only this
    rank's features), so the input's gradient is the sum of the shares."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


def sum_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` summed over ``group`` (logged ``all_reduce``), out
    of place. Differentiable: the backward is the same all-reduce of the
    output gradient."""
    return _SumOverGroup.apply(t, group)


def exchange(sends: list[tuple[torch.Tensor, int]], recvs: list[tuple[torch.Tensor, int]], group) -> list:
    """Post point-to-point sends of (tensor, group rank) and receives into
    (buffer, group rank) as one batch; returns the requests to wait on.
    Every tensor must be contiguous and stay alive until they are done.
    Not differentiable."""
    ops = []
    for t, peer in sends + recvs:
        if not t.is_contiguous():
            raise ValueError(f"exchange: a {tuple(t.shape)} tensor is not contiguous")
    for t, peer in sends:
        COMM.add("send", t, peer)
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group))
    for buf, peer in recvs:
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    return dist.batch_isend_irecv(ops) if ops else []


def wait(requests: list) -> None:
    for req in requests:
        req.wait()
