"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where only PyTorch is installed, with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
conftest.py sets JAX up). Tolerance: relative L2 1e-2 — bf16 inputs and a
bf16 output (one rounding), fp32 sums in another order.
"""

import pytest
import torch

from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv3d_causal_plain
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("sq,skv,frame_group", [(1000, 1000, 0), (333, 512, 0), (1024, 1024, 100)])
def test_flash_kernel_matches_plain_on_cuda(cuda, sq, skv, frame_group):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, s, 4, 128), generator=gen, device=cuda).bfloat16() for s in (sq, skv, skv))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, frame_group=frame_group)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, frame_group)
    # bf16 output (one rounding) and another fp32 summation order
    assert float((out.float() - ref.float()).norm() / ref.float().norm()) < 1e-2
    assert float((lse - ref_lse).abs().max()) < 1e-2


@pytest.mark.parametrize("shape", [(2, 24, 40, 384, 384), (3, 17, 29, 96, 192), (1, 8, 8, 64, 80)])
def test_conv_kernel_matches_plain_on_cuda(cuda, shape):
    T, H, W, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, T + 2, H, W, cin), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=cuda) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn((cout,), generator=gen, device=cuda)
    before = conv3d_causal.launches
    out = conv3d_causal(x, w, b)
    torch.cuda.synchronize()
    assert conv3d_causal.launches == before + 1
    ref = conv3d_causal_plain(x, w, b, out_dtype=torch.float32)
    assert float((out.float() - ref).norm() / ref.norm()) < 1e-2


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)  # head_dim 64
    with pytest.raises(TypeError):
        flash_attention_fwd(*(torch.zeros((1, 64, 2, 128), device=cuda),) * 3)  # fp32
    x = torch.zeros((1, 4, 8, 8, 24), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        conv3d_causal(x, torch.zeros((3, 3, 3, 24, 32), dtype=torch.bfloat16, device=cuda), torch.zeros(32, device=cuda))
