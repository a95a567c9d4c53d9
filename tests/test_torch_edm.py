"""The port's EDM sampler and EDM Video2World model held against the JAX
package (CPU, fp32).

Tolerances: the Karras schedule and the 2ab coefficient tables come from
the same float64 NumPy code and must be bit-equal; the scalings agree to
fp32 rounding (1e-6); the host loop on a toy x0 function to 1e-6; the EDM
model's x0 prediction (a 2-block DiT, FRAME_REPLACE on one conditional
frame) to 1.1e-6 relative L2, checked at 1e-5, and 4 steps of CFG
sampling at guidance 2 from sigma 80 to 2.9e-6 - 3.1e-6, checked at 3e-5.
The JAX parameters are drawn with NumPy on the shapes of its init.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.conditioning.conditioner import make_condition as j_make_condition
from cosmos_predict2_tpu.models import edm as jedm
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.schedulers import edm_sampler as jes
from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models import edm as tedm
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.schedulers import edm_sampler as tes
from torch_variants_util import port_net, rel_l2, tiny_jax_config

SHAPE = (1, 16, 3, 8, 8)


@pytest.mark.parametrize("num_steps,sigma_min,sigma_max,rho", [(35, 0.002, 80.0, 7.0), (4, 0.002, 80.0, 7.0),
                                                               (10, 0.01, 20.0, 5.0)])
def test_schedule_and_coefficients_equal_jax(num_steps, sigma_min, sigma_max, rho):
    sig = tes.karras_rev_ts(sigma_min, sigma_max, num_steps, rho)
    np.testing.assert_array_equal(sig, jes.karras_rev_ts(sigma_min, sigma_max, num_steps, rho))
    t, j = tes.make_coeffs(sig), jes.make_coeffs(sig)
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name), np.asarray(getattr(j, f.name)), err_msg=f.name)
    s = np.asarray([0.002, 0.3, 1.0, 80.0], np.float32)
    for a, b in zip(tes.edm_scalings(torch.from_numpy(s), 0.5), jes.edm_scalings(jnp.asarray(s), 0.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_sample_loop_matches_jax():
    """The host loop == JAX's scan on a toy x0 function (Euler first step,
    2ab after, the clean denoise at the end)."""
    x = np.random.default_rng(0).standard_normal((1, 4, 2, 3, 3)).astype(np.float32) * 80.0
    a = np.linspace(0.2, 0.6, 4, dtype=np.float32).reshape(1, 4, 1, 1, 1)
    want = jes.sample(lambda x, s: x * a / (1.0 + s), jnp.asarray(x), num_steps=6)
    got = tes.sample(lambda x, s: x * torch.from_numpy(a) / (1.0 + s), torch.from_numpy(x), num_steps=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_jax_config()
    jmodel = jedm.EDMVideo2WorldModel(jedm.EDMModelConfig(model=JRFConfig(net=jcfg, state_t=SHAPE[2])))
    shapes = jax.eval_shape(functools.partial(jmodel.init_params, latent_shape=SHAPE, text_len=8), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return 1.0 + 0.05 * noise if getattr(path[-1], "key", "") != "bias" else 0.05 * noise
        return noise / np.sqrt(leaf.shape[0])

    params = jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(draw, shapes))
    net = port_net(params, jcfg)
    tmodel = tedm.EDMVideo2WorldModel(tedm.EDMModelConfig(model=RFModelConfig(net=net.cfg, state_t=SHAPE[2])), net)
    rng = np.random.default_rng(1)
    emb = (rng.standard_normal((1, 8, 64)) * 0.5).astype(np.float32)
    x0 = (rng.standard_normal(SHAPE) * 0.5).astype(np.float32)
    jcond = j_make_condition(jnp.asarray(emb)).replace(gt_frames=jnp.asarray(x0))
    tcond = make_condition(torch.from_numpy(emb)).replace(gt_frames=torch.from_numpy(x0))
    return jmodel, params, tmodel, jcond, tcond, x0


def test_denoise_matches_jax(models):
    """x0 prediction at three sigmas with one conditional frame: EDM
    scalings, c_noise x 1000, FRAME_REPLACE in and out."""
    jmodel, params, tmodel, jcond, tcond, x0 = models
    xt = np.random.default_rng(2).standard_normal((3,) + SHAPE[1:]).astype(np.float32) * 3.0
    sigma = np.asarray([0.05, 1.0, 30.0], np.float32)
    jc = jcond.replace(crossattn_emb=jnp.repeat(jcond.crossattn_emb, 3, 0),
                       gt_frames=jnp.repeat(jcond.gt_frames, 3, 0)).edit_for_inference(True, 1)
    tc = tcond.replace(crossattn_emb=tcond.crossattn_emb.repeat(3, 1, 1),
                       gt_frames=tcond.gt_frames.repeat(3, 1, 1, 1, 1)).edit_for_inference(True, 1)
    want = jax.jit(jmodel.denoise)(params, jnp.asarray(xt), jnp.asarray(sigma), jc)
    with torch.no_grad():
        got = tmodel.denoise(torch.from_numpy(xt), torch.from_numpy(sigma), tc)
    assert rel_l2(got, want) <= 1e-5
    torch.testing.assert_close(got[:, :, 0], torch.from_numpy(x0).expand(3, -1, -1, -1, -1)[:, :, 0], rtol=0, atol=0)


@pytest.mark.parametrize("k", [0, 1])
def test_generate_matches_jax(models, k):
    """Four 2ab steps from noise * 80 with CFG at guidance 2, k conditional
    frames; the conditional frame comes out pinned."""
    jmodel, params, tmodel, jcond, tcond, x0 = models
    noise = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    want = jmodel.generate(params, jnp.asarray(noise), jcond, guidance=2.0, num_steps=4, num_conditional_frames=k)
    got = tmodel.generate(torch.from_numpy(noise), tcond, guidance=2.0, num_steps=4, num_conditional_frames=k)
    assert got.shape == SHAPE and rel_l2(got, want) <= 3e-5
    if k:
        np.testing.assert_allclose(got[:, :, 0].numpy(), x0[:, :, 0], rtol=0, atol=1e-5)
