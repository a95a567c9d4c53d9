"""The port's Wan2.2 VAE held against the JAX package (CPU, fp32): the
parameter-free pieces (patchify, AvgDown3D, DupUp3D), and the port's
stream through encoder and decoder, in chunks of several sizes, against
JAX's whole-clip ``Wan22VAE.encode`` / ``decode``.

One reference-named state dict (dim 8, dec_dim 8: the JAX tests' toy
size), drawn with NumPy from a seed, goes through both packages'
converters. Tolerances: the rearrangements are exact; the stream's
encode and decode agree with JAX's whole clip to ~1e-6 relative L2
(different conv groupings of the same fp32 sums), checked at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.tokenizers import wan22_vae as jw
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_wan22_vae_state_dict as jax_convert
from cosmos_predict2_tpu_torch.tokenizers import wan22_vae as tw
from cosmos_predict2_tpu_torch.tokenizers import wan22_vae_streaming as ts
from cosmos_predict2_tpu_torch.utils.checkpoint_convert import convert_wan22_vae_state_dict, load_reference_state_dict
from torch_variants_util import rel_l2

REL_L2 = 1e-5


@pytest.fixture(scope="module")
def pair():
    """JAX's config and parameters and the port's module, from one drawn
    reference state dict: gammas 1 + 0.05 N, biases 0.01 N, weights N /
    sqrt(fan-in); gammas written flat, as some exports do."""
    tcfg = tw.Wan22VAEConfig(dim=8, dec_dim=8, dtype=torch.float32)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in tw.Wan22VAE(tcfg).state_dict().items()}
    rng = np.random.default_rng(0)
    sd = {}
    for k, shape in shapes.items():
        noise = rng.standard_normal(shape).astype(np.float32)
        if k.endswith("gamma"):
            sd[k] = (1.0 + 0.05 * noise).reshape(-1)
        elif k.endswith("bias"):
            sd[k] = 0.01 * noise
        else:
            sd[k] = noise / np.sqrt(np.prod(shape[1:]))
    sd["model_extra.step"] = np.zeros(())  # an entry the model does not have
    jparams = jax.tree.map(jnp.asarray, jax_convert(sd))
    vae = tw.Wan22VAE(tcfg)
    load_reference_state_dict(vae, convert_wan22_vae_state_dict(sd), "Wan2.2 VAE")
    return jw.Wan22VAEConfig(dim=8, dec_dim=8, dtype=jnp.float32), jparams, vae.eval()


def test_patchify_and_resampling_shortcuts_equal_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 5, 8, 12, 6)).astype(np.float32)
    np.testing.assert_array_equal(tw.patchify(torch.from_numpy(x), 2).numpy(), np.asarray(jw.patchify(jnp.asarray(x), 2)))
    p = rng.standard_normal((1, 5, 4, 6, 12)).astype(np.float32)
    np.testing.assert_array_equal(tw.unpatchify(torch.from_numpy(p), 2).numpy(), np.asarray(jw.unpatchify(jnp.asarray(p), 2)))
    for ft, fs, out in ((2, 2, 12), (1, 2, 12), (1, 1, 6), (2, 2, 24)):
        np.testing.assert_allclose(tw.avg_down_3d(torch.from_numpy(x), out, ft, fs).numpy(),
                                   np.asarray(jw.avg_down_3d(jnp.asarray(x), out, ft, fs)), rtol=1e-6, atol=1e-6)
    for ft, first in ((2, True), (2, False), (1, True)):
        np.testing.assert_array_equal(tw.dup_up_3d(torch.from_numpy(x), 3, ft, 2, first).numpy(),
                                      np.asarray(jw.dup_up_3d(jnp.asarray(x), 3, ft, 2, first)))


def _jax_whole_clip(jcfg, jparams):
    """JAX's whole-clip ``Wan22VAE.encode`` and ``decode``, jitted."""
    jvae = jw.Wan22VAE(jcfg)
    encode = jax.jit(lambda p, a: jvae.apply(p, a, method=jw.Wan22VAE.encode))
    decode = jax.jit(lambda p, a: jvae.apply(p, a, method=jw.Wan22VAE.decode))
    return (lambda a: np.array(encode(jparams, jnp.asarray(a)))), (lambda a: np.array(decode(jparams, jnp.asarray(a))))


def test_whole_clip_encode_and_decode_match_jax(pair):
    """9 frames at 32 x 32 -> 3 x 2 x 2 x 48 latents and back, the port's
    stream in chunks [1, 8] and decoding [1, 2] latent frames (each after
    the first chunk in one piece), each half against JAX's whole-clip
    ``Wan22VAE.encode`` / ``decode`` on the same input."""
    jcfg, jparams, vae = pair
    encode, decode = _jax_whole_clip(jcfg, jparams)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    want_z = encode(x)
    z = ts.encode_streaming(vae, torch.from_numpy(x), chunk_frames=8)
    assert z.shape == (1, 3, 2, 2, 48)
    assert rel_l2(z, want_z) <= REL_L2
    px = ts.decode_streaming(vae, torch.from_numpy(want_z), chunk_latent_frames=2)
    assert px.shape == (1, 9, 32, 32, 3)
    assert rel_l2(px, decode(want_z)) <= REL_L2


@pytest.mark.parametrize("chunk", [4, 8])
def test_stream_matches_the_whole_clip(pair, chunk):
    """Encode in chunks [1, chunk, ...] and decode one latent frame at a
    time, batch 2 (one sample after the other), against JAX's whole
    clip."""
    jcfg, jparams, vae = pair
    encode, decode = _jax_whole_clip(jcfg, jparams)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 13, 32, 32, 3)).astype(np.float32)
    z_full = encode(x)
    z = ts.encode_streaming(vae, torch.from_numpy(x), chunk_frames=chunk)
    assert z.shape == (2, 4, 2, 2, 48) and rel_l2(z, z_full) <= REL_L2
    px = ts.decode_streaming(vae, torch.from_numpy(z_full), chunk_latent_frames=chunk // 4)
    assert px.shape == (2, 13, 32, 32, 3) and rel_l2(px, decode(z_full)) <= REL_L2


def test_converter_keeps_the_model_entries():
    sd = {"encoder.conv1.weight": 1, "decoder.head.2.bias": 2, "conv1.bias": 3, "conv2.weight": 4, "step": 5}
    assert convert_wan22_vae_state_dict(sd) == {k: v for k, v in sd.items() if k != "step"}
