"""Shared helpers of the port's tests: the same tiny DiT in both packages, seeded
JAX parameters converted to the port, JAX's inits compiled, the VAE pair
and the relative-L2 measure."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cosmos_predict2_tpu.networks.dit import DiTConfig as JDiTConfig
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAEConfig as JVAEConfig
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_vae_params_to_torch

# fp32 on both sides: a DiT forward agrees to 1e-6 - 7e-6 relative L2
REL_L2 = 1e-5
# latents sampled with batched CFG: v = (1 + g) cond - g uncond carries each
# branch's rounding up to (1 + 2g) times (5 at the tests' g = 2), and two
# UniPC steps add theirs: 1.6e-5 measured on the test preset (384 channels)
REL_L2_SAMPLED = 5e-5


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def port_config(jcfg: JDiTConfig) -> tdit.DiTConfig:
    """The port's DiTConfig with every field of the JAX config, in fp32."""
    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype"}
    return tdit.DiTConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})


def tiny_jax_config(**over) -> JDiTConfig:
    base = dict(model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32, crossattn_emb_channels=64)
    base.update(over)
    return JDiTConfig(dtype=jnp.float32, remat="none", **base)


def noisy_params(params, seed: int = 0):
    """JAX's init (which zero-initialises the AdaLN outputs and the
    cross-view output projection) plus seeded noise on every leaf, so that
    every path of the forward contributes."""
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(
        tdef, [np.asarray(l, np.float32) + 0.05 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves])


def jit_init(init, *args, **kwargs):
    """``init(*args, **kwargs)`` (a Flax init) compiled as one program: the
    eager call's values bit for bit (checked on the dim-16 VAE and a
    2-block DiT) in about a third of its time on the CPU. Tuple and int
    arguments (shapes) are static."""
    static = tuple(i for i, a in enumerate(args) if isinstance(a, (tuple, int)))
    return jax.jit(functools.partial(init, **kwargs), static_argnums=static)(*args)


def seeded_jax_params(jcfg: JDiTConfig, x, t, ctx, seed: int = 0, **kw):
    return noisy_params(jit_init(JDiT(jcfg).init, jax.random.PRNGKey(seed), x, t, ctx, **kw), seed)


def port_net(params, jcfg: JDiTConfig) -> tdit.MiniTrainDIT:
    """The port's DiT holding JAX's parameters (strict load)."""
    cfg = port_config(jcfg)
    net = tdit.MiniTrainDIT(cfg)
    net.load_state_dict(jax_dit_params_to_torch(jax.tree.map(np.asarray, params), cfg), strict=True)
    return net.eval()


def vae_pair(seed: int = 1):
    """A dim-16 fp32 Wan VAE: JAX's config and seeded parameters, and the
    port's module holding them. The parameters are drawn with NumPy on
    JAX's parameter shapes (``jax.eval_shape`` of its init; the eager init
    takes ~45 s on one core): norm gammas 1, biases 0.01 N(0, 1), weights
    N(0, 1) / sqrt(fan-in)."""
    jcfg = JVAEConfig(dim=16, dtype=jnp.float32)
    shapes = jax.eval_shape(JVAE(jcfg).init, jax.random.PRNGKey(seed), jnp.zeros((1, 5, 16, 16, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "gamma":
            return np.ones(leaf.shape, np.float32)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return noise * 0.01 if name == "bias" else noise / np.sqrt(max(np.prod(leaf.shape[:-1]), 1))

    jparams = jax.tree_util.tree_map_with_path(draw, shapes)
    vae = WanVAE(WanVAEConfig(dim=16, dtype=torch.float32))
    vae.load_state_dict(jax_vae_params_to_torch(jax.tree.map(np.asarray, jparams)), strict=True)
    return jcfg, jparams, vae


# the serving tests' tiny pipeline: 32x32 frames, 48-wide text embeddings
SIZE = 32
CTX_IN = 48


def tiny_serving_setup():
    """One seeded tiny Video2World pipeline in both packages (a 2-block
    128-channel DiT, the dim-16 VAE, 32x32 frames, 5-frame clips, 2 steps):
    (JAX setup, JAX params, JAX VAE params, the port's setup, net, VAE)."""
    from cosmos_predict2_tpu.inference.pipeline import InferenceSetup as JSetup
    from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
    from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
    from cosmos_predict2_tpu_torch.inference import pipeline as tpipe
    from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig

    jnet = JDiTConfig(model_channels=128, num_heads=2, num_blocks=2, adaln_lora_dim=16, crossattn_emb_channels=64,
                      use_crossattn_projection=True, crossattn_proj_in_channels=CTX_IN, rope_h_extrapolation_ratio=3.0,
                      rope_w_extrapolation_ratio=3.0, rope_enable_fps_modulation=False, dtype=jnp.float32, remat="none")
    jsetup = JSetup(model_config=JRFConfig(net=jnet, state_t=2, sampling_num_steps=2),
                    vae_config=JVAEConfig(dim=16, dtype=jnp.float32), text_len=8, size_override=(SIZE, SIZE),
                    streaming_vae=True)
    params = jit_init(JModel(jsetup.model_config).init_params, jax.random.PRNGKey(0), (1, 16, 2, 4, 4), text_len=8)
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree.unflatten(tdef, [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves])
    vae_params = jit_init(JVAE(jsetup.vae_config).init, jax.random.PRNGKey(1), jnp.zeros((1, 5, SIZE, SIZE, 3)))

    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype"}
    tnet_cfg = tdit.DiTConfig(dtype=torch.float32, **{n: getattr(jnet, n) for n in names})
    net = tdit.MiniTrainDIT(tnet_cfg)
    net.load_state_dict(jax_dit_params_to_torch(params, tnet_cfg), strict=True)
    vae = WanVAE(WanVAEConfig(dim=16, dtype=torch.float32))
    vae.load_state_dict(jax_vae_params_to_torch(jax.tree.map(np.asarray, vae_params)), strict=True)
    setup = tpipe.InferenceSetup(model_config=RFModelConfig(net=tnet_cfg, state_t=2, sampling_num_steps=2),
                                 vae_config=vae.config, size_override=(SIZE, SIZE))
    return jsetup, jax.tree.map(jnp.asarray, params), vae_params, setup, net, vae
