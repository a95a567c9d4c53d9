"""Spatially sharded convolution by halo exchange, and the VAE's rank grid.

Counterpart of cosmos_predict2_tpu/parallel/halo_conv.py (the reference's
VAE plugins, wan2pt1_2d_plugins.py:139-728: ranks send boundary rows and
columns to their neighbours before each conv). The exchange is
point-to-point (parallel/comm.py::exchange); a rank at the edge of the grid
gets zeros, which is the zero padding the whole conv applies at the clip's
border. The conv itself is ``F.conv*`` with VALID padding on the sharded
axis, as JAX's is plain XLA, so each rank computes exactly its slice of the
whole output.

:class:`SpatialGrid` is the 2D rank grid of the sharded Wan VAE
(tokenizers/wan_vae_streaming.py): H over one process group, W over
another. :func:`halo_hw` gives a (B, T, H, W, C) slab its halo on both axes
(W first, then H over the widened rows, so the corners come along).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from cosmos_predict2_tpu_torch.parallel import comm


def halo_exchange(x: torch.Tensor, dim: int, lo: int, hi: int, group) -> torch.Tensor:
    """x with ``lo`` slices of the previous rank's end prepended and ``hi``
    of the next rank's start appended along ``dim``; zeros at the edges."""
    if lo == 0 and hi == 0:
        return x
    c, r = comm.group_size(group), comm.group_rank(group)
    dim = dim % x.ndim
    n = x.shape[dim]
    if lo > n or hi > n:
        raise ValueError(f"halo_exchange: halo ({lo}, {hi}) wider than the local size {n}")
    sends, recvs, parts = [], [], []
    if lo:
        left = x.new_zeros(x.shape[:dim] + (lo,) + x.shape[dim + 1:])
        if r > 0:
            recvs.append((left, r - 1))
        if r < c - 1:
            sends.append((x.narrow(dim, n - lo, lo).contiguous(), r + 1))
        parts.append(left)
    parts.append(x)
    if hi:
        right = x.new_zeros(x.shape[:dim] + (hi,) + x.shape[dim + 1:])
        if r < c - 1:
            recvs.append((right, r + 1))
        if r > 0:
            sends.append((x.narrow(dim, 0, hi).contiguous(), r - 1))
        parts.append(right)
    comm.wait(comm.exchange(sends, recvs, group))
    return torch.cat(parts, dim=dim)


def halo_exchange_w(x: torch.Tensor, left: int, right: int, group) -> torch.Tensor:
    """The JAX package's name: the halo on the W axis (axis -2 of (..., W, C))."""
    return halo_exchange(x, -2, left, right, group)


def conv_w_sharded(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    group,
    stride_w: int = 1,
    pad_w: tuple[int, int] = (1, 1),
    other_strides: tuple[int, ...] = (),
    other_pads: tuple[tuple[int, int], ...] = (),
) -> torch.Tensor:
    """A convolution of channels-last x (B, *spatial, W, C), this rank's
    share of W, with torch's weight (C_out, C_in, *k): the rank's share of
    the whole conv's output. ``pad_w`` = (lo, hi) is the whole conv's W
    padding; it needs hi == max(0, kw - stride_w - lo) (true of the VAE's
    SAME stride-1 and (0, 1)-padded stride-2 convs) and the local W
    divisible by ``stride_w``."""
    lo, hi = pad_w
    kw = weight.shape[-1]
    need_right = max(0, kw - stride_w - lo)
    if hi != need_right:
        raise ValueError(f"pad_w hi={hi} must equal kw-stride-lo={need_right} for halo sharding")
    n_spatial = x.ndim - 2
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[n_spatial]
    h = halo_exchange_w(x, lo, need_right, group)
    hc = h.movedim(-1, 1)  # channels first
    pads = []
    for p in reversed(tuple(other_pads) + ((0, 0),)):  # F.pad: last dim first
        pads += list(p)
    hc = F.pad(hc, pads)
    out = conv(hc, weight, bias, stride=tuple(other_strides) + (stride_w,))
    return out.movedim(1, -1)


def conv3d_w_sharded(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    group,
    strides: tuple[int, int, int] = (1, 1, 1),
    pads: tuple[tuple[int, int], ...] = ((1, 1), (1, 1), (1, 1)),
) -> torch.Tensor:
    """3D conv of (B, T, H, W, C) with W sharded; ``pads`` = ((t), (h), (w)) of the whole conv."""
    return conv_w_sharded(x, weight, bias, group, stride_w=strides[2], pad_w=pads[2], other_strides=strides[:2],
                          other_pads=pads[:2])


@dataclasses.dataclass(frozen=True)
class SpatialGrid:
    """A 2D rank grid over a (B, T, H, W, C) clip: H split over ``h_group``
    (rank order is row order), W over ``w_group``. Each rank holds its
    (H / gh, W / gw) slab."""

    h_group: object
    w_group: object

    @property
    def shape(self) -> tuple[int, int]:
        return comm.group_size(self.h_group), comm.group_size(self.w_group)

    @property
    def index(self) -> tuple[int, int]:
        return comm.group_rank(self.h_group), comm.group_rank(self.w_group)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a whole (B, T, H, W, C) clip."""
        (gh, gw), (ih, iw) = self.shape, self.index
        H, W = x.shape[2:4]
        if H % gh or W % gw:
            raise ValueError(f"SpatialGrid: {H}x{W} does not split over a {gh}x{gw} grid")
        return x[:, :, ih * (H // gh):(ih + 1) * (H // gh), iw * (W // gw):(iw + 1) * (W // gw)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slab back into the whole clip."""
        return comm.all_gather(comm.all_gather(x, self.w_group, 3), self.h_group, 2)


def halo_hw(x: torch.Tensor, grid: SpatialGrid, lo: int, hi: int) -> torch.Tensor:
    """(B, T, h, w, C) slab -> (B, T, lo + h + hi, lo + w + hi, C) with the
    neighbours' rows and columns (corners included), zeros at the clip's
    border."""
    x = halo_exchange(x, 3, lo, hi, grid.w_group)
    return halo_exchange(x, 2, lo, hi, grid.h_group)
