"""Causal 3x3x3 conv: the Hopper implicit-GEMM kernel (csrc/conv3d_causal.cu)
and its plain PyTorch version.

Counterpart of cosmos_predict2_tpu/ops/conv3d.py::conv3d_causal_ring (and
its per-tap / K-folded siblings, which compute the same function). Contract:
x (1, T_out + 2, H, W, Cin) NDHWC with the stream's 2 cached frames
prepended, w (3, 3, 3, Cin, Cout) DHWIO, b (Cout,); valid in time, SAME-1 in
space, fp32 accumulation, + bias in fp32, out (1, T_out, H, W, Cout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cosmos_predict2_tpu_torch import _build

KT = 3


def conv3d_causal_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in fp32. On a GPU
    the caller decides TF32 (``torch.backends.cudnn.allow_tf32``)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float().permute(0, 4, 1, 2, 3)  # NCDHW view
    wf = w.float().permute(4, 3, 0, 1, 2)  # OIDHW
    out = F.conv3d(xf, wf, None, padding=(0, 1, 1))
    out = out.permute(0, 2, 3, 4, 1) + b.float()
    return out.to(out_dtype)


def conv3d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (1, T_out + 2, H, W, Cin), w (3, 3, 3, Cin, Cout), b (Cout,) ->
    (1, T_out, H, W, Cout).

    CPU tensors take :func:`conv3d_causal_plain`. CUDA tensors launch the
    kernel, which takes contiguous bf16 x and w, B == 1, Cin and Cout
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
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"conv3d_causal: {name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3d_causal: {name} must be contiguous and 16-byte aligned")
    T_out = T_in - KT + 1
    bias = b.to(torch.float32).contiguous()
    out = torch.empty((1, T_out, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cosmos_conv3d_causal(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), T_out, H, W, Cin, Cout, stream
        )
    _build.check(err, "conv3d_causal")
    conv3d_causal.launches += 1
    return out


conv3d_causal.launches = 0
