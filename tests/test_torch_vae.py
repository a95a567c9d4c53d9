"""The port's streaming Wan VAE held against the JAX package (CPU, fp32).

The JAX side runs its causal 3x3x3 convs through the Pallas ring kernel in
interpret mode (``conv_backend="ring_interpret"``, with the channel gate
``_PALLAS_MIN_CH`` lowered by monkeypatch so the dim-16 test VAE takes it);
the port's gate is lowered the same way so its conv wrapper (the plain
version on the CPU) carries those convs. Tolerance: 1e-4 relative /
absolute on O(1) values for a chain of ~30 fp32 convs and norms summed in
another order; uint8 outputs may differ by one level where a value sits on
a rounding boundary. Weight conversion is bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.tokenizers import wan_vae_streaming as jvs
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAEConfig as JVAEConfig
from cosmos_predict2_tpu.tokenizers.wan_vae import _upsample2x_conv3x3
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_vae_state_dict
from cosmos_predict2_tpu_torch.tokenizers import wan_vae_streaming as tvs
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig, build_vae, upsample2x_conv3x3
from cosmos_predict2_tpu_torch.utils.convert import jax_vae_params_to_torch

TOL = 1e-4
H = W = 32


@pytest.fixture(scope="module")
def vaes():
    """The same seeded weights in both packages (dim 16, fp32)."""
    jcfg = JVAEConfig(dim=16, dtype=jnp.float32)
    params = JVAE(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 5, H, W, 3), jnp.float32))
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(0)
    # perturb the zero-initialized biases too, so every term of each conv counts
    params = jax.tree.unflatten(tdef, [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves])
    vae = WanVAE(WanVAEConfig(dim=16, dtype=torch.float32))
    vae.load_state_dict(jax_vae_params_to_torch(params), strict=True)
    return jcfg, params, vae


@pytest.fixture
def kernel_gates(monkeypatch):
    monkeypatch.setattr(jvs, "_PALLAS_MIN_CH", 8)
    monkeypatch.setattr(tvs, "_KERNEL_MIN_CH", 16)


def _video(seed, frames=5):
    return np.random.default_rng(seed).integers(0, 256, (1, frames, H, W, 3), dtype=np.uint8)


@pytest.mark.parametrize("pixel_format", ["uint8", "float"])
def test_encode_streaming_matches_jax(vaes, kernel_gates, pixel_format):
    jcfg, params, vae = vaes
    x = _video(1)
    if pixel_format == "float":
        x = (x.astype(np.float32) / 127.5 - 1.0).astype(np.float32)
    want = jvs.encode_streaming(jcfg, params, jnp.asarray(x), conv_backend="ring_interpret", pixel_format=pixel_format)
    got = tvs.encode_streaming(vae, torch.from_numpy(x), pixel_format=pixel_format)
    assert tuple(got.shape) == want.shape == (1, 2, H // 8, W // 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pixel_format", ["float", "uint8"])
def test_decode_streaming_matches_jax(vaes, kernel_gates, pixel_format):
    jcfg, params, vae = vaes
    z = (np.random.default_rng(2).standard_normal((1, 2, H // 8, W // 8, 16)) * 0.5).astype(np.float32)
    want = np.asarray(jvs.decode_streaming(jcfg, params, jnp.asarray(z), chunk_latent_frames=1,
                                           conv_backend="ring_interpret", pixel_format=pixel_format))
    got = tvs.decode_streaming(vae, torch.from_numpy(z), chunk_latent_frames=1, pixel_format=pixel_format).numpy()
    assert got.shape == want.shape == (1, 5, H, W, 3) and got.dtype == want.dtype
    if pixel_format == "uint8":
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_streaming_is_exact_for_any_chunk_size(vaes):
    """Streaming carries the causal state exactly: every chunking of the
    latent stream decodes to the same pixels."""
    _, _, vae = vaes
    z = torch.from_numpy((np.random.default_rng(3).standard_normal((1, 4, 2, 2, 16)) * 0.5).astype(np.float32))
    outs = [tvs.decode_streaming(vae, z, chunk_latent_frames=c) for c in (1, 2, 3)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5, atol=1e-5)


def test_upsample2x_conv3x3_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2, 5, 6, 8)).astype(np.float32)
    w_hwio = rng.standard_normal((3, 3, 8, 12)).astype(np.float32) / 8
    b = rng.standard_normal((12,)).astype(np.float32)
    want = _upsample2x_conv3x3(jnp.asarray(w_hwio), jnp.asarray(b), jnp.asarray(x), jnp.float32)
    got = upsample2x_conv3x3(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                             torch.from_numpy(x), torch.float32)
    assert tuple(got.shape) == (1, 2, 10, 12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_vae_state_dict_round_trip_and_jax_tree(vaes):
    """port state_dict -> checkpoint_convert gives exactly the JAX VAE's
    parameter tree, and converting back loads strict and bit-exact."""
    _, jparams, _ = vaes
    cfg = WanVAEConfig(dim=16, dtype=torch.float32)
    vae = build_vae(cfg, "cpu", seed=5)
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    tree = convert_vae_state_dict(sd)
    assert jax.tree.map(lambda a: a.shape, tree) == jax.tree.map(lambda a: a.shape, jparams)
    back = WanVAE(cfg)
    back.load_state_dict(jax_vae_params_to_torch(tree), strict=True)
    for k, v in vae.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k


def test_conv_gate_sends_the_kernel_only_what_it_takes():
    """Every causal 3x3x3 conv of the full-width VAE is gated as the kernel's
    contract allows: the gate says yes only for B == 1, 3x3x3, both widths
    >= 64 and multiples of 16 (the thin RGB / latent / head convs stay plain)."""
    with torch.device("meta"):
        vae = WanVAE(WanVAEConfig())
    taken, plain = [], []
    for name, m in vae.named_modules():
        if isinstance(m, torch.nn.Conv3d) and tuple(m.weight.shape[2:]) == (3, 3, 3):
            cout, cin = m.weight.shape[:2]
            x = torch.empty((1, 3, 4, 4, cin), device="meta")
            (taken if tvs._use_kernel_conv(x, m) else plain).append((name, cin, cout))
    assert all(min(ci, co) >= 64 and ci % 16 == 0 and co % 16 == 0 for _, ci, co in taken)
    assert sorted(n for n, _, _ in plain) == ["decoder.conv1", "decoder.head.2", "encoder.conv1", "encoder.head.2"]
    assert len(taken) == 48  # 20 in the encoder, 28 in the decoder
    assert not tvs._use_kernel_conv(torch.empty((2, 3, 4, 4, 96), device="meta"), vae.encoder.downsamples[0].residual[2])
