"""PyTorch port ops held against the JAX package (CPU, fp32, seeded numpy inputs).

Tolerances: single ops in fp32 compute the same math with another summation
order, so they agree to ~1e-6 relative; the bounds below (1e-5 relative,
2e-5 absolute on O(1) values) leave an order of magnitude of margin. The
Pallas kernels run in interpret mode, as the JAX package's own tests run
them. The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.ops import attention as j_attention
from cosmos_predict2_tpu.ops import normalization as j_norm
from cosmos_predict2_tpu.ops import rope as j_rope
from cosmos_predict2_tpu_torch import _build
from cosmos_predict2_tpu_torch.ops import attention as t_attention
from cosmos_predict2_tpu_torch.ops import normalization as t_norm
from cosmos_predict2_tpu_torch.ops import rope as t_rope
from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv3d_causal_plain
from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

RTOL, ATOL = 1e-5, 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol)


# ------------------------------ normalization ------------------------------


@pytest.mark.parametrize("op", ["rms_norm", "rms_norm_weight", "layer_norm", "channel_l2_norm"])
def test_normalization_matches_jax(op):
    rng = _rng("norm", op)
    x = rng.standard_normal((2, 5, 7, 64)).astype(np.float32) * 3 + 0.5
    w = rng.standard_normal((64,)).astype(np.float32)
    if op == "rms_norm":
        got, want = t_norm.rms_norm(torch.from_numpy(x)), j_norm.rms_norm(jnp.asarray(x))
    elif op == "rms_norm_weight":
        got = t_norm.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
        want = j_norm.rms_norm(jnp.asarray(x), jnp.asarray(w))
    elif op == "layer_norm":
        got, want = t_norm.layer_norm(torch.from_numpy(x)), j_norm.layer_norm(jnp.asarray(x))
    else:
        got = t_norm.channel_l2_norm(torch.from_numpy(x), torch.from_numpy(w))
        want = j_norm.channel_l2_norm(jnp.asarray(x), jnp.asarray(w), axis=-1)
    _close(got, want)


# ---------------------------------- rope ----------------------------------


@pytest.mark.parametrize("fps_mod", [False, True])
def test_rope_matches_jax(fps_mod):
    kw = dict(head_dim=128, h_extrapolation_ratio=3.0, w_extrapolation_ratio=3.0, t_extrapolation_ratio=1.0,
              enable_fps_modulation=fps_mod)
    T, H, W = 3, 4, 5
    fps = np.asarray([16.0], np.float32)
    got = t_rope.rope_angles_3d(t_rope.RopeSpec(**kw), T, H, W, fps=torch.from_numpy(fps))
    want = j_rope.rope_angles_3d(j_rope.RopeSpec(**kw), T, H, W, fps=jnp.asarray(fps))
    _close(got, want, rtol=1e-6, atol=1e-5)
    x = _rng("rope", fps_mod).standard_normal((2, T * H * W, 2, 128)).astype(np.float32)
    _close(t_rope.apply_rope(torch.from_numpy(x), got), j_rope.apply_rope(jnp.asarray(x), want))


# -------------------------------- attention --------------------------------


@pytest.mark.parametrize("frame_group", [0, 3])
def test_reference_attention_matches_jax(frame_group):
    rng = _rng("attn", frame_group)
    q, k, v = (rng.standard_normal((2, 12, 3, 16)).astype(np.float32) for _ in range(3))
    got = t_attention.reference_attention(*map(torch.from_numpy, (q, k, v)), frame_group=frame_group)
    want = j_attention.reference_attention(*map(jnp.asarray, (q, k, v)), frame_group=frame_group)
    _close(got, want)


@pytest.mark.parametrize("sq,skv,frame_group", [(256, 256, 0), (256, 200, 0), (256, 256, 64)])
def test_flash_plain_matches_pallas_interpret(sq, skv, frame_group):
    """The kernel's plain version == the JAX Pallas forward (out and lse),
    incl. a ragged kv tail and the frame-block mask."""
    from jax.experimental.pallas import tpu as pltpu

    from cosmos_predict2_tpu.ops.flash_attention import _fwd

    rng = _rng("flash", sq, skv, frame_group)
    q = rng.standard_normal((1, sq, 2, 128)).astype(np.float32)
    k = rng.standard_normal((1, skv, 2, 128)).astype(np.float32)
    v = rng.standard_normal((1, skv, 2, 128)).astype(np.float32)
    bhsd = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _fwd(bhsd(q), bhsd(k), bhsd(v), 128, 128, frame_group)
    got_out, got_lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), frame_group)
    _close(got_out, np.asarray(want_out).transpose(0, 2, 1, 3))
    _close(got_lse, want_lse)


def test_dispatch_takes_plain_version_on_cpu():
    """CPU tensors take the plain versions and launch (count) nothing."""
    rng = _rng("dispatch")
    q = torch.from_numpy(rng.standard_normal((1, 40, 2, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 16, 16)).astype(np.float32))
    b = torch.zeros(16)
    before = _build.launch_counts()
    torch.testing.assert_close(t_attention.dot_product_attention(q, q, q), t_attention.reference_attention(q, q, q))
    torch.testing.assert_close(flash_attention_fwd(q, q, q)[0], flash_attention_plain(q, q, q)[0])
    torch.testing.assert_close(conv3d_causal(x, w, b), conv3d_causal_plain(x, w, b))
    assert _build.launch_counts() == before


# ---------------------------------- conv ----------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 16, 16, 32), (1, 8, 8, 32, 16), (4, 6, 10, 48, 64)])
def test_conv_plain_matches_pallas_ring_interpret(shape):
    from cosmos_predict2_tpu.ops.conv3d import conv3d_causal_ring

    T, H, W, cin, cout = shape
    rng = _rng("conv", shape)
    x = rng.standard_normal((1, T + 2, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    got = conv3d_causal_plain(*map(torch.from_numpy, (x, w, b)))
    if W % 8:  # the Pallas kernel needs W % 8 == 0 (a TPU layout rule)
        from cosmos_predict2_tpu.ops.conv3d import conv3d_causal_taps_reference as ref_fn

        want = ref_fn(*map(jnp.asarray, (x, w, b)), out_dtype=jnp.float32)
    else:
        want = conv3d_causal_ring(*map(jnp.asarray, (x, w, b)), out_dtype=jnp.float32, interpret=True)
    assert tuple(got.shape) == (1, T, H, W, cout)
    _close(got, want)


# ---------------------------------- build ----------------------------------


def test_build_is_lazy_and_keyed_by_sources():
    """Importing the port needs no nvcc; the library name carries the
    source hash, so an edited kernel rebuilds."""
    h = _build.source_hash()
    assert len(h) == 16 and _build.library_path().name == f"libcosmos_torch_kernels_{h}.so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "cosmos_torch_kernels")
    assert set(_build.launch_counts()) == {
        "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_kv_cache",
        "flash_attention_kv_cache_window", "flash_attention_jvp", "conv3d_causal", "na_fwd", "na_bwd_dq", "na_bwd_dkv"}
    assert {"flash_attention_bwd.cu", "flash_attention_kv_cache.cu", "neighborhood_attention.cu",
            "flash_attention_jvp.cu"} <= set(_build.SOURCES)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules, and
    no source file of the port imports jax or flax. The serving path that
    chip_smoke.py drives loads nothing of the JAX package at all."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cosmos_predict2_tpu_torch.inference.pipeline, cosmos_predict2_tpu_torch.configs.defaults\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'cosmos_predict2_tpu')\n"
        "assert not ref, ref\n"
        "import cosmos_predict2_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'jaxlib')))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    for root, _, files in os.walk(os.path.join(REPO, "cosmos_predict2_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src and "from jax" not in src and "flax" not in src, f
