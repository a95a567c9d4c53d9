"""The hand-written CUDA kernels against their plain PyTorch versions, on the card,
the DiT's gradients through them (dense and sparse blocks), the causal
DiT's streaming loop through the cache-decode kernels K5 (one split and the
split-KV route, NaN past the fill) and K6, and the
fused forward-mode kernel K9 under torch.func.jvp and forward_ad.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where only PyTorch is installed, with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
conftest.py sets JAX up). Tolerance: relative L2 1e-2 — bf16 inputs and a
bf16 output (one rounding), fp32 sums in another order.
"""

import pytest
import torch

from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv3d_causal_plain, conv_weight_taps
from cosmos_predict2_tpu_torch.ops.flash_attention import (
    FlashAttention,
    attention_delta,
    dkv_split_plan,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_kv_cache,
    flash_attention_kv_cache_window,
    flash_attention_plain,
    kv_cache_plain,
    kv_cache_split_plan,
    kv_cache_window_plain,
)
from cosmos_predict2_tpu_torch.ops import neighborhood_attention as na
from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import (
    flash_attention_fwdmode,
    flash_attention_jvp,
    flash_attention_jvp_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# K1 cases (batch 2): ragged q and kv tails against the 128-row tiles (1000,
# 333, 77), q and kv below one tile (64 / 77, 1 / 512), frame groups that do
# not divide the tiles (100, 240 with a ragged Sq)
K1_CASES = [(1000, 1000, 0), (333, 512, 0), (1024, 1024, 100), (64, 77, 0), (1, 512, 0), (1000, 1000, 240)]


@pytest.mark.parametrize("sq,skv,frame_group", K1_CASES)
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
    # the last batch's rows of the last, ragged q tile on their own
    tail = slice(sq - sq % 128 if sq % 128 else sq - 128, sq)
    assert _rel(out[-1, tail], ref[-1, tail]) < 1e-2
    assert float((lse[-1, :, tail] - ref_lse[-1, :, tail]).abs().max()) < 1e-2


@pytest.mark.parametrize("sq,skv,frame_group", [(1000, 1000, 240), (333, 77, 0)])
def test_flash_kernel_is_deterministic_on_cuda(cuda, sq, skv, frame_group):
    """No atomics: two calls give bitwise-equal output and lse."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((2, s, 4, 128), generator=gen, device=cuda).bfloat16() for s in (sq, skv, skv))
    first, second = (flash_attention_fwd(q, k, v, frame_group=frame_group) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# K2 cases (T, H, W, Cin, Cout): N split 2 x 192 (Cout 384) on a small M
# (24 x 40: W not a multiple of the 16-wide box); H and W that no box
# divides (17 x 29) with Cin 96 in three 32-channel chunks; N = 80 on one
# tile smaller than the box; Cin 96 -> Cout 384 on 5 x 20 (two
# partial boxes); Cin 48 (a half-zero last chunk) -> Cout 48 (N = 64); the
# VAE decoder's 96 -> 96 on the 16 x 8 box (H 48, W 40)
CONV_CASES = [(2, 24, 40, 384, 384), (3, 17, 29, 96, 192), (1, 8, 8, 64, 80), (1, 5, 20, 96, 384),
              (2, 9, 12, 48, 48), (2, 48, 40, 96, 96)]


def _conv_inputs(cuda, T, H, W, cin, cout, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((1, T + 2, H, W, cin), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=cuda) / (27 * cin) ** 0.5).bfloat16()
    b = torch.randn((cout,), generator=gen, device=cuda)
    return x, w, b


@pytest.mark.parametrize("shape", CONV_CASES)
def test_conv_kernel_matches_plain_on_cuda(cuda, shape):
    x, w, b = _conv_inputs(cuda, *shape)
    before = conv3d_causal.launches
    out = conv3d_causal(x, w, b)
    torch.cuda.synchronize()
    assert conv3d_causal.launches == before + 1
    ref = conv3d_causal_plain(x, w, b, out_dtype=torch.float32)
    assert float((out.float() - ref).norm() / ref.norm()) < 1e-2


@pytest.mark.parametrize("shape", [(2, 17, 29, 96, 192), (1, 5, 20, 96, 384)])
def test_conv_kernel_is_deterministic_on_cuda(cuda, shape):
    """No atomics: two calls give the same bits, and the prepared tap-major
    weights give what the kernel's own preparation gives."""
    x, w, b = _conv_inputs(cuda, *shape, seed=1)
    first, second = conv3d_causal(x, w, b), conv3d_causal(x, w, b, w_taps=conv_weight_taps(w))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# K7 / K8 cases: ragged tails against the 64- and 128-row tiles (5800, 1000,
# 333, 200, 77), K8's split route (Skv 512 with Sq 2000: 32 CTAs at B2 H4),
# frame groups that do not divide the tiles (100, 240)
BWD_CASES = [(1000, 1000, 0), (333, 512, 0), (1024, 1024, 100), (200, 77, 0), (5800, 5800, 0), (1000, 333, 0),
             (2000, 512, 0), (1000, 1000, 240), (5800, 5800, 100)]


def _bwd_inputs(cuda, sq, skv, frame_group, seed=1):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn((2, sq, 4, 128), generator=gen, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn((2, skv, 4, 128), generator=gen, device=cuda).bfloat16() for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, frame_group=frame_group)
    return q, k, v, do, out, lse, attention_delta(out, do)


@pytest.mark.parametrize("sq,skv,frame_group", BWD_CASES)
def test_flash_bwd_kernels_match_plain_on_cuda(cuda, sq, skv, frame_group):
    q, k, v, do, out, lse, delta = _bwd_inputs(cuda, sq, skv, frame_group)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, frame_group)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, frame_group)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, frame_group)
    for name, got, want in zip("qkv", (dq, dk, dv), ref):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all(), name
        assert _rel(got, want) < 1e-2, name  # bf16 outputs, P and dS rounded to bf16 on both sides


@pytest.mark.parametrize("sq,skv,frame_group", [(2000, 512, 0), (5800, 5800, 100)])
def test_flash_bwd_kernels_are_deterministic_on_cuda(cuda, sq, skv, frame_group):
    """No atomics: two calls give bitwise-equal dq, dk and dv, on K8's split
    route (partials summed in split order) and on the frame mask."""
    q, k, v, do, out, lse, delta = _bwd_inputs(cuda, sq, skv, frame_group, seed=3)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (dkv_split_plan(sq, skv, 4, 2, frame_group, sms).splits > 1) == (skv == 512)
    first = (flash_attention_bwd_dq(q, k, v, do, lse, delta, frame_group),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, frame_group))
    second = (flash_attention_bwd_dq(q, k, v, do, lse, delta, frame_group),
              *flash_attention_bwd_dkv(q, k, v, do, lse, delta, frame_group))
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), name


def test_flash_attention_function_grads_on_cuda(cuda):
    """dot_product_attention's autograd on the card goes through K1, K7 and
    K8 and gives the plain version's gradients."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn((1, 300, 2, 128), generator=gen, device=cuda).bfloat16() for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counts = lambda: (flash_attention_fwd.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    before = counts()
    FlashAttention.apply(*leaves, 0).backward(do)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    out, lse = flash_attention_plain(q, k, v)
    for name, x, want in zip("qkv", leaves, flash_attention_bwd_plain(q, k, v, out, lse, do)):
        assert _rel(x.grad, want) < 1e-2, name


def test_dit_training_step_gradients_on_cuda(cuda):
    """One training step of a small bf16 DiT (head_dim 128) on the card with
    per-block remat: every parameter gets a finite gradient, and attention
    runs 4 forwards and 2 backwards per block."""
    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import apply_train_dropout, make_condition
    from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, build_dit

    cfg = DiTConfig(model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32, crossattn_emb_channels=128)
    net = build_dit(cfg, cuda, seed=0, trainable=True)
    model = Video2WorldModel(RFModelConfig(net=cfg, state_t=2), net)
    x0 = torch.randn((1, 16, 2, 16, 16), device=cuda)
    cond = make_condition(torch.randn((1, 24, 128), device=cuda)).replace(gt_frames=x0)
    draws = model.sample_train_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(cuda)
    _build.reset_launch_counts()
    loss, _ = model.training_step(x0, apply_train_dropout(cond, draws.text_keep, draws.use_video), draws)
    loss.backward()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]) == (8, 4, 4)
    for name, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)  # head_dim 64
    with pytest.raises(TypeError):
        flash_attention_fwd(*(torch.zeros((1, 64, 2, 128), device=cuda),) * 3)  # fp32
    x = torch.zeros((1, 4, 8, 8, 24), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        conv3d_causal(x, torch.zeros((3, 3, 3, 24, 32), dtype=torch.bfloat16, device=cuda), torch.zeros(32, device=cuda))
    x, w, b = _conv_inputs(cuda, 2, 8, 8, 32, 48)
    with pytest.raises(ValueError):
        conv3d_causal(x, w[..., :40].contiguous(), b[:40])  # Cout 40
    with pytest.raises(ValueError):
        conv3d_causal(torch.cat([x, x]), w, b)  # batch 2
    with pytest.raises(ValueError):
        conv3d_causal(x[:, :2].contiguous(), w, b)  # T_in 2 < 3
    with pytest.raises(TypeError):
        conv3d_causal(x.float(), w, b)  # fp32 x
    with pytest.raises(TypeError):
        conv3d_causal(x, w, b, out_dtype=torch.float32)  # fp32 output
    with pytest.raises(ValueError):
        conv3d_causal(x[..., ::2, :], w, b)  # strided x
    with pytest.raises(ValueError):
        conv3d_causal(x, w, b, w_taps=conv_weight_taps(w).transpose(1, 2).contiguous())  # taps (27, Cin, Cout)
    q = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_bwd_dq(q.float(), q, q, q, lse, lse)  # fp32 q
    with pytest.raises(ValueError):
        flash_attention_bwd_dkv(q, q, q, q, lse[:, :1], lse)  # lse of the wrong shape


# (T, H, W), window, stride, dilation: padded, strided, dilated, and the 2B
# sparse config's adapted window at the smoke geometry
NA_CASES = [
    ((3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1)),
    ((4, 8, 16), (-1, 4, 8), (1, 2, 4), (1, 1, 1)),
    ((2, 8, 16), (-1, 2, 4), (1, 1, 1), (1, 4, 4)),
    ((24, 12, 20), (24, 3, 6), (1, 1, 2), (1, 1, 1)),
]


def _na_inputs(cuda, size, window, stride, dilation, heads=4, seed=3):
    eff_w, eff_s = na.effective_params(na.VideoSize(*size), window, stride, dilation)
    plan = na.build_plan(na.VideoSize(*size), eff_w, eff_s, dilation)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    S = size[0] * size[1] * size[2]
    q, k, v, do = (na.permute_in(torch.randn((2, S, heads, 128), generator=gen, device=cuda).bfloat16(), plan)
                   for _ in range(4))
    return plan, eff_w, eff_s, (q, k, v, do)


@pytest.mark.parametrize("size,window,stride,dilation", NA_CASES)
def test_na_kernels_match_plain_on_cuda(cuda, size, window, stride, dilation):
    plan, w, st, (q, k, v, do) = _na_inputs(cuda, size, window, stride, dilation)
    counts = lambda: (na.na_fwd.launches, na.na_bwd_dq.launches, na.na_bwd_dkv.launches)
    before = counts()
    out, lse = na.na_fwd(q, k, v, plan, w, st)
    delta = na.na_delta(out, do)
    dq = na.na_bwd_dq(q, k, v, do, lse, delta, plan, w, st)
    dk, dv = na.na_bwd_dkv(q, k, v, do, lse, delta, plan, w, st)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    ref_out, ref_lse = na.na_fwd_plain(q, k, v, plan, w, st)
    real = na.permute_in(torch.ones((1, size[0] * size[1] * size[2], 1, 1), device=cuda), plan)[0, 0, :, 0] > 0
    assert _rel(out, ref_out) < 1e-2  # bf16 output (one rounding), fp32 sums in another order
    assert float((lse - ref_lse)[:, :, real].abs().max()) < 1e-2
    assert torch.all(out[:, :, ~real] == 0)  # pad rows: every key masked, row sum clamped
    for name, got, want in zip("qkv", (dq, dk, dv), na.na_bwd_plain(q, k, v, out, lse, do, plan, w, st)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all(), name
        assert _rel(got, want) < 1e-2, name  # P and dS rounded to bf16 on both sides


@pytest.mark.parametrize("size,window,stride,dilation", [NA_CASES[0], NA_CASES[3]])
def test_na_bwd_dq_kernel_is_deterministic_on_cuda(cuda, size, window, stride, dilation):
    """K11 has no atomics: two calls give the same bits."""
    plan, w, st, (q, k, v, do) = _na_inputs(cuda, size, window, stride, dilation, seed=6)
    out, lse = na.na_fwd(q, k, v, plan, w, st)
    delta = na.na_delta(out, do)
    first = na.na_bwd_dq(q, k, v, do, lse, delta, plan, w, st)
    second = na.na_bwd_dq(q, k, v, do, lse, delta, plan, w, st)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_neighborhood_attention_function_grads_on_cuda(cuda):
    """neighborhood_attention's autograd on the card goes through K10, K11
    and K12 and gives the plain versions' gradients."""
    size, window, stride = (4, 8, 16), (-1, 4, 8), (1, 2, 4)
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn((1, 512, 2, 128), generator=gen, device=cuda).bfloat16() for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counts = lambda: (na.na_fwd.launches, na.na_bwd_dq.launches, na.na_bwd_dkv.launches)
    before = counts()
    na.neighborhood_attention(*leaves, size, window, stride).backward(do)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    plan = na.build_plan(na.VideoSize(*size), window, stride, (1, 1, 1))
    qt, kt, vt, dot = (na.permute_in(x, plan) for x in (q, k, v, do))
    out, lse = na.na_fwd_plain(qt, kt, vt, plan, window, stride)
    for name, x, want in zip("qkv", leaves, na.na_bwd_plain(qt, kt, vt, out, lse, dot, plan, window, stride)):
        assert _rel(x.grad, na.permute_out(want, plan)) < 1e-2, name


def test_sparse_dit_training_step_gradients_on_cuda(cuda):
    """One training step of a small bf16 DiT with one dense and one sparse
    block: every parameter gets a finite gradient; per step K1 runs 2 x 3
    times (dense self-attention and both cross-attentions, forward and
    recompute), K10 2 times, K7, K8, K11 and K12 3, 3, 1 and 1 times."""
    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import apply_train_dropout, make_condition
    from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, build_dit

    cfg = DiTConfig(model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32, crossattn_emb_channels=128,
                    n_dense_blocks=1, natten_window=(-1, 3, 5), natten_stride=(1, 1, 2))
    net = build_dit(cfg, cuda, seed=0, trainable=True)
    model = Video2WorldModel(RFModelConfig(net=cfg, state_t=3), net)
    x0 = torch.randn((1, 16, 3, 16, 24), device=cuda)
    cond = make_condition(torch.randn((1, 24, 128), device=cuda)).replace(gt_frames=x0)
    draws = model.sample_train_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(cuda)
    _build.reset_launch_counts()
    loss, _ = model.training_step(x0, apply_train_dropout(cond, draws.text_keep, draws.use_video), draws)
    loss.backward()
    torch.cuda.synchronize()
    c = _build.launch_counts()
    assert (c["flash_attention_fwd"], c["na_fwd"], c["flash_attention_bwd_dq"], c["flash_attention_bwd_dkv"],
            c["na_bwd_dq"], c["na_bwd_dkv"]) == (6, 2, 3, 3, 1, 1)
    for name, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_na_kernels_raise_on_what_they_do_not_take(cuda):
    plan = na.build_plan(na.VideoSize(3, 6, 10), (-1, 4, 6), (1, 1, 1), (1, 1, 1))
    q = torch.zeros((1, 2, plan.s_pad, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        na.na_fwd(q.float(), q, q, plan, (-1, 4, 6), (1, 1, 1))  # fp32
    with pytest.raises(ValueError):
        na.na_fwd(q[..., :64].contiguous(), q, q, plan, (-1, 4, 6), (1, 1, 1))  # head_dim 64
    with pytest.raises(ValueError):
        na.na_fwd(q[:, :, :64].contiguous(), q, q, plan, (-1, 4, 6), (1, 1, 1))  # not the plan's S_pad
    lse = torch.zeros((1, 2, plan.s_pad), device=cuda)
    with pytest.raises(ValueError):
        na.na_bwd_dkv(q, q, q, q, lse[:, :1], lse, plan, (-1, 4, 6), (1, 1, 1))  # lse of the wrong shape
    with pytest.raises(ValueError):
        na.na_fwd(q, q, q, plan, (2, 4, 6), (1, 1, 1))  # not the window the plan's walks were built for
    x = torch.zeros((1, 96, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):
        na.neighborhood_attention(x, x, x, (2, 6, 8), (1, 3, 3), (1, 1, 1), (1, 4, 1))  # dilation 4 on H = 6


def _cache_inputs(cuda, sq, s_max, fill, heads=4, seed=5):
    """bf16 q (2, sq, H, 128) and head-major buffers (2, H, s_max, 128) with
    +-1e3 past the fill frontier, which must not reach the output."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((2, sq, heads, 128), generator=gen, device=cuda).bfloat16()
    kb, vb = (torch.randn((2, heads, s_max, 128), generator=gen, device=cuda).bfloat16() for _ in range(2))
    kb[:, :, fill:] = 1e3
    vb[:, :, fill:] = -1e3
    return q, kb, vb


# (Sq, S_max, fill): the 352x640 geometry's block at full and early fill, a
# ragged block and fill (3 splits), a fill of one tile, a short block over a
# long ragged fill (split-KV)
KV_CASES = [(880, 17 * 880, 17 * 880), (880, 17 * 880, 4 * 880), (100, 512, 301), (64, 1024, 64),
            (64, 17 * 880, 17 * 880 - 77)]


@pytest.mark.parametrize("sq,s_max,fill", KV_CASES)
def test_kv_cache_kernel_matches_plain_on_cuda(cuda, sq, s_max, fill):
    q, kb, vb = _cache_inputs(cuda, sq, s_max, fill)
    before = flash_attention_kv_cache.launches
    out = flash_attention_kv_cache(q, kb, vb, fill)
    torch.cuda.synchronize()
    assert flash_attention_kv_cache.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert _rel(out, kv_cache_plain(q, kb, vb, fill)) < 1e-2  # P rounded to bf16 on both sides


@pytest.mark.parametrize("sq,s_max,fill,heads,split", [(880, 17 * 880, 12 * 880 - 77, 16, False),
                                                       (64, 17 * 880, 17 * 880 - 77, 4, True)])
def test_kv_cache_kernel_keeps_nan_past_the_fill_out_on_cuda(cuda, sq, s_max, fill, heads, split):
    """Buffers that hold NaN past the fill (as torch.empty may): the output
    stays finite and matches, on one split and on the split route, and two
    calls give the same bits."""
    q, kb, vb = _cache_inputs(cuda, sq, s_max, fill, heads=heads)
    kb[:, :, fill:] = float("nan")
    vb[:, :, fill:] = float("nan")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (kv_cache_split_plan(sq, fill, heads, 2, sms).splits > 1) == split
    out, repeat = (flash_attention_kv_cache(q, kb, vb, fill) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, repeat)
    assert _rel(out, kv_cache_plain(q, kb, vb, fill)) < 1e-2


# (gh, gw, window rows, frames per block, filled frames, buffer frames): the
# path's 7-of-22 rows, a prime gh, a 2-frame block whose q tiles cross a
# frame, a window wider than the grid, a width that is no multiple of 8
WINDOW_CASES = [(22, 40, 7, 1, 5, 6), (23, 40, 7, 1, 4, 5), (6, 8, 3, 2, 3, 4), (5, 6, 9, 1, 2, 3), (7, 5, 2, 1, 3, 3)]


@pytest.mark.parametrize("gh,gw,wh,nb,filled,frames", WINDOW_CASES)
def test_kv_cache_window_kernel_matches_plain_on_cuda(cuda, gh, gw, wh, nb, filled, frames):
    F = gh * gw
    q, kb, vb = _cache_inputs(cuda, nb * F, frames * F, filled * F)
    before = flash_attention_kv_cache_window.launches
    out = flash_attention_kv_cache_window(q, kb, vb, filled * F, (gh, gw), wh)
    torch.cuda.synchronize()
    assert flash_attention_kv_cache_window.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert _rel(out, kv_cache_window_plain(q, kb, vb, filled * F, (gh, gw), wh)) < 1e-2


@pytest.mark.parametrize("gh,gw,wh,nb,filled,frames", [WINDOW_CASES[0], WINDOW_CASES[2]])
def test_kv_cache_window_kernel_keeps_nan_past_the_fill_out_on_cuda(cuda, gh, gw, wh, nb, filled, frames):
    """K6 over buffers that hold NaN past the fill: its tiles start at any
    row of a frame and run past the fill, where TMA reads zeros; finite,
    matching, and two calls give the same bits."""
    F = gh * gw
    q, kb, vb = _cache_inputs(cuda, nb * F, frames * F, filled * F)
    kb[:, :, filled * F:] = float("nan")
    vb[:, :, filled * F:] = float("nan")
    out, repeat = (flash_attention_kv_cache_window(q, kb, vb, filled * F, (gh, gw), wh) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, repeat)
    assert _rel(out, kv_cache_window_plain(q, kb, vb, filled * F, (gh, gw), wh)) < 1e-2


def test_kv_cache_kernels_raise_on_what_they_do_not_take(cuda):
    q, kb, vb = _cache_inputs(cuda, 48, 192, 96)
    with pytest.raises(TypeError):
        flash_attention_kv_cache(q.float(), kb, vb, 96)  # fp32
    with pytest.raises(ValueError):
        flash_attention_kv_cache(q[..., :64].contiguous(), kb[..., :64].contiguous(), vb[..., :64].contiguous(), 96)
    with pytest.raises(ValueError):
        flash_attention_kv_cache(q, kb[:, :, ::2], vb[:, :, ::2], 96)  # not contiguous
    with pytest.raises(ValueError):
        flash_attention_kv_cache(q, kb, vb, 193)  # past the buffer
    with pytest.raises(ValueError):
        flash_attention_kv_cache_window(q, kb, vb, 90, (6, 8), 3)  # not a whole number of frames
    with pytest.raises(TypeError):
        flash_attention_kv_cache_window(q, kb.float(), vb, 96, (6, 8), 3)


@pytest.mark.parametrize("window", [-1, 2])
def test_streaming_runs_through_the_cache_kernels_on_cuda(cuda, window):
    """A narrow causal DiT (2 blocks, 3 heads of 128) streams 3 blocks of
    one frame with a 2-frame window after one prefilled frame: 2 x (1 + 3 x
    (2 steps + 1 commit)) cached self-attentions, all K5 (or K6), and as
    many cross-attentions on K1; finite output."""
    import dataclasses

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.scripts.interactive_latency import NET_TINY, build_stream

    stream = build_stream(dataclasses.replace(NET_TINY, dtype=torch.bfloat16), 1, 2, 2, window, cuda)
    cond = make_condition(torch.randn((1, 8, 1024), device=cuda))
    init = torch.randn((1, 16, 1, 16, 16), device=cuda)
    _build.reset_launch_counts()
    out = stream.generate(cond, init, 4, (16, 16), generator=torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    c = _build.launch_counts()
    cached = "flash_attention_kv_cache_window" if window > 0 else "flash_attention_kv_cache"
    assert c[cached] == c["flash_attention_fwd"] == 2 * (1 + 3 * 3)
    assert out.shape == (1, 16, 4, 16, 16) and torch.isfinite(out).all()


# ------------------------- fused forward mode (K9) -------------------------


@pytest.mark.parametrize("sq,skv,frame_group,tangents", [
    (1000, 1000, 0, "qkv"), (333, 200, 0, "qkv"), (1024, 1024, 256, "qkv"), (512, 512, 0, "v"), (300, 300, 100, "qk"),
])
def test_jvp_kernel_matches_plain_on_cuda(cuda, sq, skv, frame_group, tangents):
    """K9's (o, do) against its plain version; skv 200 has a kv tail, "v"
    the dv-only tangents of time-derivative losses (dq = dk = 0)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, s, 4, 128), generator=gen, device=cuda).bfloat16() for s in (sq, skv, skv))
    dq, dk, dv = (torch.randn(x.shape, generator=gen, device=cuda).bfloat16() if name in tangents
                  else torch.zeros_like(x) for name, x in zip("qkv", (q, k, v)))
    before = flash_attention_jvp.launches
    o, do = flash_attention_jvp(q, k, v, dq, dk, dv, frame_group)
    torch.cuda.synchronize()
    assert flash_attention_jvp.launches == before + 1
    ref_o, ref_do = flash_attention_jvp_plain(q, k, v, dq, dk, dv, frame_group)
    assert torch.isfinite(do.float()).all()
    assert _rel(o, ref_o) < 1e-2 and _rel(do, ref_do) < 1e-2


def test_jvp_kernel_is_deterministic_on_cuda(cuda):
    """No atomics: two calls of K9 give the same bits (a kv tail and a frame
    group that splits the 64-row kv tiles)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = [torch.randn((1, 1000, 4, 128), generator=gen, device=cuda).bfloat16() for _ in range(6)]
    first, second = (flash_attention_jvp(*args, frame_group=100) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_fwdmode_launches_k1_and_k9_once_under_jvp_on_cuda(cuda):
    """torch.func.jvp and forward_ad each launch one K1 (the primal) and
    one K9 (the tangent), and match the plain version."""
    import torch.autograd.forward_ad as fwAD

    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, dq, dk, dv = (torch.randn((1, 640, 2, 128), generator=gen, device=cuda).bfloat16() for _ in range(6))
    ref_o, ref_do = flash_attention_jvp_plain(q, k, v, dq, dk, dv)
    counts = lambda: (flash_attention_fwd.launches, flash_attention_jvp.launches)  # noqa: E731
    before = counts()
    o, do = torch.func.jvp(flash_attention_fwdmode, (q, k, v), (dq, dk, dv))
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    assert _rel(o, ref_o) < 1e-2 and _rel(do, ref_do) < 1e-2
    with fwAD.dual_level():
        out = flash_attention_fwdmode(*(fwAD.make_dual(p, t) for p, t in zip((q, k, v), (dq, dk, dv))))
        o2, do2 = fwAD.unpack_dual(out)
        torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 2)
    assert _rel(o2, ref_o) < 1e-2 and _rel(do2, ref_do) < 1e-2


def test_jvp_kernel_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_jvp(*(torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=cuda),) * 6)  # head_dim 64
    with pytest.raises(TypeError):
        flash_attention_jvp(*(x.half(),) * 6)  # fp16 primals
    with pytest.raises(ValueError):
        flash_attention_jvp(x, x, x, x, x[:, :32], x)  # dk shaped unlike k
    with pytest.raises(ValueError):
        flash_attention_jvp(x, x, x, x, x, x.transpose(1, 2).contiguous().transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        flash_attention_jvp(x, x, x, x, x, x, frame_group=-1)
    o, do = flash_attention_jvp(x, x, x, x.float(), x.float(), x.float())  # tangents take the primal's dtype
    assert o.dtype == do.dtype == torch.bfloat16
