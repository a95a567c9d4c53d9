"""The port's halo-exchange convs and spatially sharded Wan VAE held against the JAX package's.

Four gloo ranks (tests/torch_dist_util.py, one start for the file) run
parallel/halo_conv.py's W-sharded convs on test_halo_conv.py's cases (the
VAE's SAME stride-1 and (0, 1)-padded stride-2 3D convs, a 2D conv, and the
padding it refuses, with JAX's message), and the dim-16 Wan VAE's one-shot
and streaming encode and decode on a 2 x 2 rank grid (H over the mesh's
fsdp axis, W over cp: test_vae_sharded.py's layout) against JAX's
GSPMD-sharded runs on the conftest's virtual CPU mesh. Tolerances are JAX's
own: 1e-5 on the convs, 2e-4 on the VAE. The communication-pattern test
(the port's counterpart of test_vae_sharded.py:74) reads parallel/comm.py's
byte log: the sharded decode sends conv halos only, one row or one column
deep, and gathers nothing larger than a latent-resolution frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cosmos_predict2_tpu.parallel.halo_conv import conv3d_w_sharded as j_conv3d_w_sharded
from cosmos_predict2_tpu.parallel.mesh import make_mesh as j_make_mesh
from cosmos_predict2_tpu.tokenizers import wan_vae_streaming as jwvs
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
from torch_dist_util import run_ranks
from torch_variants_util import vae_pair

CONV_TOL = 1e-5
VAE_TOL = 2e-4
CONV3D = [((1, 1, 1), ((2, 0), (1, 1), (1, 1))), ((1, 1, 2), ((2, 0), (1, 1), (0, 1)))]


def _ref_conv(x, k, strides, pads):
    spatial = "DHW"[3 - (x.ndim - 2):]
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape, (f"N{spatial}C", f"{spatial}IO", f"N{spatial}C"))
    return np.asarray(jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), strides, pads,
                                                   dimension_numbers=dn))


def _conv_inputs():
    rng = np.random.default_rng(0)
    x3 = rng.standard_normal((1, 5, 8, 16, 6)).astype(np.float32)
    k3 = (rng.standard_normal((3, 3, 3, 6, 4)) * 0.1).astype(np.float32)
    x2 = rng.standard_normal((2, 8, 16, 3)).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, 3, 5)) * 0.1).astype(np.float32)
    return x3, k3, x2, k2


def _torch_weight(k):
    """JAX's (*k, I, O) kernel -> torch's (O, I, *k)."""
    return np.ascontiguousarray(np.moveaxis(k, (-1, -2), (0, 1)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x3, k3, x2, k2 = _conv_inputs()
    jcfg, jparams, vae = vae_pair(seed=1)
    sd = {n: t.numpy() for n, t in vae.state_dict().items()}
    rng = np.random.default_rng(2)
    clip = rng.uniform(-1, 1, (1, 5, 32, 64, 3)).astype(np.float32)
    z = rng.standard_normal((1, 3, 4, 8, 16)).astype(np.float32)
    cases = [("halo_conv", dict(x=x3, weight=_torch_weight(k3), bias=np.zeros(4, np.float32), strides=s, pads=p))
             for s, p in CONV3D]
    cases.append(("halo_conv", dict(x=x2, weight=_torch_weight(k2), bias=np.zeros(5, np.float32), strides=(1, 1),
                                    pads=((1, 1), (1, 1)))))
    cases.append(("halo_conv", dict(x=np.zeros((1, 4, 4, 8, 2), np.float32), weight=np.zeros((2, 2, 3, 3, 3),
                                    np.float32), bias=None, strides=(1, 1, 2), pads=((1, 1), (1, 1), (1, 1)))))
    cfg = vae.config
    cases += [("vae_sharded", dict(cfg=cfg, state_dict=sd, clip=clip, z=z, streaming=streaming))
              for streaming in (False, True)]
    return run_ranks(tmp_path_factory.mktemp("halo"), 4, cases), (jcfg, jparams, clip, z)


@pytest.mark.parametrize("i", range(2), ids=["stride1-same", "stride2-pad01"])
def test_conv3d_w_sharded_matches_jax(ranks, i):
    x3, k3, _, _ = _conv_inputs()
    strides, pads = CONV3D[i]
    got = np.concatenate(ranks[0][i], axis=3)
    mesh = Mesh(np.array(jax.devices()[:4]), ("cp",))
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x3), NamedSharding(mesh, P(None, None, None, "cp", None)))
        want = np.asarray(jax.jit(lambda a, b: j_conv3d_w_sharded(a, b, strides, pads))(xs, jnp.asarray(k3)))
    np.testing.assert_allclose(got, want, atol=CONV_TOL, rtol=0)
    np.testing.assert_allclose(got, _ref_conv(x3, k3, strides, pads), atol=CONV_TOL, rtol=0)


def test_conv2d_w_sharded_matches_jax(ranks):
    _, _, x2, k2 = _conv_inputs()
    got = np.concatenate(ranks[0][2], axis=2)
    np.testing.assert_allclose(got, _ref_conv(x2, k2, (1, 1), ((1, 1), (1, 1))), atol=CONV_TOL, rtol=0)


def test_bad_padding_rejected_as_jax(ranks):
    msgs = ranks[0][3]
    mesh = Mesh(np.array(jax.devices()[:4]), ("cp",))
    with jax.set_mesh(mesh), pytest.raises(ValueError, match="pad_w") as e:
        j_conv3d_w_sharded(jnp.zeros((1, 4, 4, 8, 2)), jnp.zeros((3, 3, 3, 2, 2)), (1, 1, 2),
                           ((1, 1), (1, 1), (1, 1)))
    assert msgs == [str(e.value)] * 4


def _jax_sharded(jcfg, jparams, clip, z, streaming):
    vae = JVAE(jcfg)
    mesh = j_make_mesh(1, 2, 2, 1, devices=jax.devices()[:4])
    spec = NamedSharding(mesh, P(None, None, "fsdp", "cp"))
    with jax.set_mesh(mesh):
        xs, zs = jax.device_put(jnp.asarray(clip), spec), jax.device_put(jnp.asarray(z), spec)
        if streaming:
            return np.asarray(jwvs.encode_streaming(jcfg, jparams, xs)), np.asarray(
                jwvs.decode_streaming(jcfg, jparams, zs))
        enc = jax.jit(lambda p, v: vae.apply(p, v, method=JVAE.encode))(jparams, xs)
        dec = jax.jit(lambda p, v: vae.apply(p, v, method=JVAE.decode))(jparams, zs)
        return np.asarray(enc), np.asarray(dec)


@pytest.mark.parametrize("streaming", [False, True], ids=["one-shot", "streaming"])
def test_spatially_sharded_vae_matches_jax(ranks, streaming):
    """Encode and decode on the 2 x 2 grid: every rank's gathered latents
    and pixels against JAX's GSPMD-sharded VAE."""
    jcfg, jparams, clip, z = ranks[1]
    want_z, want_px = _jax_sharded(jcfg, jparams, clip, z, streaming)
    for got_z, got_px, _ in ranks[0][4 + streaming]:
        np.testing.assert_allclose(got_z, want_z, atol=VAE_TOL, rtol=0)
        np.testing.assert_allclose(got_px, want_px, atol=VAE_TOL, rtol=0)


def test_sharded_streaming_decode_communication_pattern(ranks):
    """The sharded streaming decode sends conv halos, never whole slabs:
    each send is one row or one column deep, and every all-gather (the
    middle attention's keys and values) is latent-resolution, below half a
    decoded pixel chunk (test_vae_sharded.py:74's bound)."""
    _, _, clip, z = ranks[1]
    pixel_elems = 4 * clip.shape[2] * clip.shape[3] * 3
    for _, _, records in ranks[0][5]:
        kinds = {r.kind for r in records}
        assert kinds == {"send", "all_gather"}, kinds
        sends = [r for r in records if r.kind == "send"]
        assert len(sends) > 20
        for r in sends:
            assert 1 in r.shape[2:4], r  # a halo row (H extent 1) or column (W extent 1)
        for r in records:
            if r.kind == "all_gather":
                assert r.shape[2] * 2 <= z.shape[2] and r.shape[3] <= z.shape[3], r  # latent grid or smaller
                assert int(np.prod(r.shape)) < pixel_elems // 2, r
