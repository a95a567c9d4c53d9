"""K2, the causal conv kernel (csrc/conv3d_causal.cu), in its own order on the
CPU, and the VAE's cache of the kernel's weight layout.

- ``conv_plan``: the tiles it lays out cover every output pixel and channel
  exactly once, and its box, chunks and N split at chip_smoke.py's shapes.
- The kernel's order in plain PyTorch, driven by ``conv_plan``: per 128-pixel
  rectangle of one frame, per input frame dt and 32-channel chunk the halo'd
  slab (the rectangle and a pixel around it, zero-filled outside the frame
  as TMA fills it), per spatial tap (dh, dw) the A operand that slab holds at
  (dh, dw), fp32 sums, the bias, one rounding; held against the port's
  ``conv3d_causal_plain`` and the JAX package's ``conv3d_causal_ring`` in
  interpret mode (``conv3d_causal_taps_reference`` where W % 8 != 0: the
  Pallas kernel needs W % 8 == 0). fp32 on both sides: the sums differ only
  in order, so the tolerances are tests/test_torch_ops.py's.
- ``kernel_weight`` (tokenizers/wan_vae_streaming.py) equals the permute it
  replaces, is made once, and is made anew after an in-place change of the
  weight.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from cosmos_predict2_tpu_torch.ops.conv3d import (
    BOXES,
    CHUNK,
    TILE_M,
    WIDTHS,
    conv3d_causal_plain,
    conv_plan,
    conv_weight_taps,
)
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import kernel_weight

RTOL, ATOL = 1e-5, 2e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _tiles(plan, T_out):
    """(t, h0, w0, n0) of every tile, in the kernel's order (N split innermost)."""
    for t in range(T_out):
        for th in range(plan.tiles_h):
            for tw in range(plan.tiles_w):
                for ns in range(plan.n_split):
                    yield t, th * plan.box_h, tw * plan.box_w, ns * plan.n


def conv_in_the_kernels_order(x, w, b):
    """K2's function in its own order, driven by conv_plan: per tile, per
    input frame dt and 32-channel chunk the slab of (BH + 2) x (BW + 2)
    pixels at (h0 - 1, w0 - 1) (zeros outside the frame and past Cin), per
    spatial tap (dh, dw) A = the slab's BH x BW pixels at (dh, dw), B = the
    tap's (n, 32) weights (zeros past Cout and Cin), acc += A B^T in fp32;
    then + bias, rows inside the frame and columns below Cout only."""
    _, T_in, H, W, Cin = x.shape
    Cout = w.shape[-1]
    T_out = T_in - 2
    plan = conv_plan(H, W, Cin, Cout)
    cin_pad = plan.chunks * CHUNK
    # x with a zero frame of one pixel and zeros past the tiles' reach and past Cin
    xp = torch.zeros((T_in, plan.tiles_h * plan.box_h + 2, plan.tiles_w * plan.box_w + 2, cin_pad))
    xp[:, 1:H + 1, 1:W + 1, :Cin] = x[0].float()
    taps = torch.zeros((27, plan.n * plan.n_split, cin_pad))
    taps[:, :Cout, :Cin] = conv_weight_taps(w).float()
    out = torch.full((1, T_out, H, W, Cout), float("nan"))
    for t, h0, w0, n0 in _tiles(plan, T_out):
        acc = torch.zeros((TILE_M, plan.n))
        for dt in range(3):
            for c in range(plan.chunks):
                # xp is offset by the frame of one pixel: the slab's corner (h0 - 1, w0 - 1) is xp's (h0, w0)
                slab = xp[t + dt, h0:h0 + plan.box_h + 2, w0:w0 + plan.box_w + 2, c * CHUNK:(c + 1) * CHUNK]
                for dh in range(3):
                    for dw in range(3):
                        a = slab[dh:dh + plan.box_h, dw:dw + plan.box_w].reshape(TILE_M, CHUNK)
                        acc += a @ taps[9 * dt + 3 * dh + dw, n0:n0 + plan.n, c * CHUNK:(c + 1) * CHUNK].T
        acc = acc.reshape(plan.box_h, plan.box_w, plan.n)
        hh, ww, nn_ = min(plan.box_h, H - h0), min(plan.box_w, W - w0), min(plan.n, Cout - n0)
        out[0, t, h0:h0 + hh, w0:w0 + ww, n0:n0 + nn_] = acc[:hh, :ww, :nn_] + b[n0:n0 + nn_].float()
    return out


# chip_smoke.py's conv cases (H, W, Cin, Cout) and the plan each gets:
# (box_h, box_w, chunks, n, n_split)
SMOKE_PLANS = [
    ((192, 320, 96, 96), (8, 16, 3, 96, 1)),
    ((96, 160, 96, 192), (8, 16, 3, 192, 1)),
    ((48, 80, 192, 384), (8, 16, 6, 192, 2)),
    ((24, 40, 384, 384), (8, 16, 12, 192, 2)),
    ((96, 160, 192, 192), (8, 16, 6, 192, 1)),
    ((176, 320, 384, 384), (8, 16, 12, 192, 2)),
    ((704, 1280, 96, 96), (8, 16, 3, 96, 1)),
    ((48, 40, 96, 80), (16, 8, 3, 80, 1)),
]


@pytest.mark.parametrize("shape,want", SMOKE_PLANS, ids=[str(s) for s, _ in SMOKE_PLANS])
def test_conv_plan_at_the_main_shapes(shape, want):
    """The VAE's widths need no wasted column: 96, 192 and 2 x 192, and 80
    for the test shape; the box pads the frame least (16 x 8 where 40
    columns and 48 rows leave 8 x 16 a ragged column tile)."""
    plan = conv_plan(*shape)
    assert (plan.box_h, plan.box_w, plan.chunks, plan.n, plan.n_split) == want
    assert plan.n in WIDTHS and (plan.box_h, plan.box_w) in BOXES and plan.box_h * plan.box_w == TILE_M


@pytest.mark.parametrize("shape", [(1, 5, 20, 96, 384), (3, 17, 29, 48, 48), (2, 24, 40, 16, 272), (1, 1, 1, 16, 16)])
def test_conv_plan_tiles_cover_every_output_once(shape):
    T_out, H, W, Cin, Cout = shape
    plan = conv_plan(H, W, Cin, Cout)
    assert plan.n * plan.n_split >= Cout and plan.n <= 256 and plan.chunks * CHUNK >= Cin
    count = np.zeros((T_out, plan.tiles_h * plan.box_h, plan.tiles_w * plan.box_w, plan.n * plan.n_split), np.int64)
    for t, h0, w0, n0 in _tiles(plan, T_out):
        count[t, h0:h0 + plan.box_h, w0:w0 + plan.box_w, n0:n0 + plan.n] += 1
    assert (count[:, :H, :W, :Cout] == 1).all()


# (T_out, H, W, Cin, Cout): Cout 80 with W and H that no box divides (W 20,
# taps reference); Cin 96 in three chunks on a 9 x 16 frame (ring); Cout 384
# as 2 x 192 on a 5 x 8 frame smaller than a box (ring); Cin 48 (a
# half-zero chunk) on 16 x 8 boxes (ring)
ORDER_CASES = [(2, 10, 20, 32, 80), (1, 9, 16, 96, 96), (1, 5, 8, 96, 384), (2, 12, 8, 48, 64)]


@pytest.mark.parametrize("shape", ORDER_CASES, ids=[str(s) for s in ORDER_CASES])
def test_conv_in_the_kernels_order_matches_plain_and_jax(shape):
    from cosmos_predict2_tpu.ops.conv3d import conv3d_causal_ring, conv3d_causal_taps_reference

    T, H, W, cin, cout = shape
    rng = _rng("conv order", shape)
    x = rng.standard_normal((1, T + 2, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    got = conv_in_the_kernels_order(*map(torch.from_numpy, (x, w, b)))
    torch.testing.assert_close(got, conv3d_causal_plain(*map(torch.from_numpy, (x, w, b))), rtol=RTOL, atol=ATOL)
    if W % 8:
        want = conv3d_causal_taps_reference(*map(jnp.asarray, (x, w, b)), out_dtype=jnp.float32)
    else:
        want = conv3d_causal_ring(*map(jnp.asarray, (x, w, b)), out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_kernel_weight_is_the_permute_made_once_and_anew_after_a_change():
    conv = nn.Conv3d(32, 48, 3)
    w, taps = kernel_weight(conv, torch.bfloat16)
    dhwio = conv.weight.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0).contiguous()
    assert torch.equal(w, dhwio) and tuple(taps.shape) == (27, 48, 32)
    assert torch.equal(taps, dhwio.reshape(27, 32, 48).transpose(1, 2))
    assert kernel_weight(conv, torch.bfloat16)[1] is taps  # unchanged weight: the same tensor, not made again
    with torch.no_grad():
        conv.weight.add_(1.0)  # in place: same storage, a new version
    _, again = kernel_weight(conv, torch.bfloat16)
    assert again is not taps
    assert torch.equal(again, conv_weight_taps(conv.weight.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0)))
    conv.weight = nn.Parameter(torch.zeros_like(conv.weight))  # a new tensor
    assert kernel_weight(conv, torch.bfloat16)[1].abs().sum() == 0
    assert kernel_weight(conv, torch.float32)[1].dtype == torch.float32
