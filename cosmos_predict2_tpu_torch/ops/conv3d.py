"""Causal 3x3x3 conv: the Hopper implicit-GEMM kernel (csrc/conv3d_causal.cu),
its plain PyTorch version, the host's plan of the kernel's tiles and the
weights' tap-major layout.

Counterpart of cosmos_predict2_tpu/ops/conv3d.py::conv3d_causal_ring (and
its per-tap / K-folded siblings, which compute the same function). Contract:
x (1, T_out + 2, H, W, Cin) NDHWC with the stream's 2 cached frames
prepended, w (3, 3, 3, Cin, Cout) DHWIO, b (Cout,); valid in time, SAME-1 in
space, fp32 accumulation, + bias in fp32, out (1, T_out, H, W, Cout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cosmos_predict2_tpu_torch import _build

KT = 3
TAPS = 27
# the kernel's tiles: 128 output pixels (a BH x BW rectangle of one frame),
# input channels in chunks of 32, one wgmma of width N per N split
TILE_M = 128
CHUNK = 32
BOXES = ((8, 16), (16, 8))  # (BH, BW) rectangles the kernel takes
WIDTHS = (64, 80, 96, 128, 192, 256)  # the widths N the kernel is built for
MAX_WIDTH = WIDTHS[-1]


class ConvPlan(NamedTuple):
    box_h: int  # rows of the M rectangle
    box_w: int  # columns
    tiles_h: int
    tiles_w: int
    chunks: int  # 32-channel chunks of Cin (the last one zero-filled where Cin % 32 == 16)
    n: int  # wgmma width: output channels of one tile
    n_split: int  # tiles along Cout; n * n_split >= Cout


def conv_plan(H: int, W: int, Cin: int, Cout: int) -> ConvPlan:
    """The kernel's tiling of one conv: the box that pads the frame least
    (the wider one on a tie), Cin in 32-channel chunks, Cout in as few
    splits of at most 256 as it takes, each the least built width that
    holds its share."""
    def cover(box):
        bh, bw = box
        return -(-H // bh) * bh * (-(-W // bw) * bw), -bw

    box_h, box_w = min(BOXES, key=cover)
    n_split = -(-Cout // MAX_WIDTH)
    share = -(-Cout // (16 * n_split)) * 16
    n = min(w for w in WIDTHS if w >= share)
    return ConvPlan(box_h, box_w, -(-H // box_h), -(-W // box_w), -(-Cin // CHUNK), n, n_split)


def conv_weight_taps(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) DHWIO -> the kernel's (27, Cout, Cin) layout,
    contiguous: each tap's weights K-major (tap = 9 dt + 3 dh + dw)."""
    return w.reshape(TAPS, w.shape[3], w.shape[4]).transpose(1, 2).contiguous()


def conv3d_causal_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in fp32. On a GPU
    the caller decides TF32 (``torch.backends.cudnn.allow_tf32``)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float().permute(0, 4, 1, 2, 3)  # NCDHW view
    wf = w.float().permute(4, 3, 0, 1, 2)  # OIDHW
    out = F.conv3d(xf, wf, None, padding=(0, 1, 1))
    out = out.permute(0, 2, 3, 4, 1) + b.float()
    return out.to(out_dtype)


def conv3d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype=None,
                  w_taps: torch.Tensor | None = None) -> torch.Tensor:
    """x (1, T_out + 2, H, W, Cin), w (3, 3, 3, Cin, Cout), b (Cout,) ->
    (1, T_out, H, W, Cout). ``w_taps``: w in the kernel's layout
    (:func:`conv_weight_taps`), made once by a caller that keeps it (the
    streaming VAE does per conv); without it the kernel's call makes it.

    CPU tensors take :func:`conv3d_causal_plain`. CUDA tensors launch the
    kernel, which takes contiguous bf16 x and weights, B == 1, Cin and Cout
    multiples of 16 and a bf16 output, and raises on anything else.
    """
    if not x.is_cuda:
        return conv3d_causal_plain(x, w, b, out_dtype)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.ndim != 5 or x.shape[0] != 1:
        raise ValueError(f"conv3d_causal: x must be (1, T_in, H, W, Cin), got {tuple(x.shape)}")
    _, T_in, H, W, Cin = x.shape
    Cout = w.shape[-1]
    if w.shape != (KT, 3, 3, Cin, Cout) or b.shape != (Cout,):
        raise ValueError(f"conv3d_causal: w {tuple(w.shape)} / b {tuple(b.shape)} do not match Cin={Cin}")
    if T_in < KT:
        raise ValueError(f"conv3d_causal: T_in={T_in} < {KT}")
    if Cin % 16 or Cout % 16:
        raise ValueError(f"conv3d_causal: Cin={Cin} and Cout={Cout} must be multiples of 16")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError(f"conv3d_causal: needs bf16 x, w and output, got {x.dtype}, {w.dtype}, {out_dtype}")
    if w_taps is None:
        w_taps = conv_weight_taps(w)
    if w_taps.shape != (TAPS, Cout, Cin) or w_taps.dtype != torch.bfloat16:
        raise ValueError(f"conv3d_causal: w_taps must be bf16 {(TAPS, Cout, Cin)}, got {w_taps.dtype} "
                         f"{tuple(w_taps.shape)}")
    for name, t in (("x", x), ("w", w), ("w_taps", w_taps), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"conv3d_causal: {name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w_taps", w_taps)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3d_causal: {name} must be contiguous and 16-byte aligned")
    T_out = T_in - KT + 1
    out = torch.empty((1, T_out, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    bias = b.to(torch.float32).contiguous()
    plan = conv_plan(H, W, Cin, Cout)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cosmos_conv3d_causal(
            x.data_ptr(), w_taps.data_ptr(), bias.data_ptr(), out.data_ptr(), T_out, H, W, Cin, Cout, plan.box_w,
            plan.n, plan.n_split, stream,
        )
    _build.check(err, "conv3d_causal")
    conv3d_causal.launches += 1
    return out


conv3d_causal.launches = 0
