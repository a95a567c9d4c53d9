"""The action-conditioned interactive path (the gr00t names) held against
the JAX package (CPU, fp32): the causal DiT with the action embedders in
the cached forward (with and without the condition-mask channel), and the
streaming loop carrying one action chunk through every prefill, denoise
and commit, with JAX's noise draws.

The JAX parameters are drawn with NumPy on the shapes of its init
(``jax.eval_shape``) and carried across with utils/convert.py.
Tolerances: those of tests/test_torch_interactive.py, 1e-4 on the cached
forward's outputs and caches and 2e-4 absolute on the streamed latents
(each block's output feeds the next block's cache).
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.conditioning.conditioner import make_condition as j_make_condition
from cosmos_predict2_tpu.models import interactive as jint
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models import interactive as tint
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch

TOL = 1e-4
STREAM_ATOL = 2e-4
SHAPE = (1, 16, 4, 8, 8)
ACTION_DIM = 7  # the registry's is 7 x 12 per step; fc1 takes num_action_per_chunk x action_dim inputs


def _models(concat_mask: bool):
    net = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", action_dim=ACTION_DIM,
                              concat_condition_mask=concat_mask)
    jmodel = jint.CausalVideo2WorldModel(jint.causal_model_config(net, num_frame_per_block=1, state_t=SHAPE[2]))
    shapes = jax.eval_shape(functools.partial(jmodel.init_params, latent_shape=SHAPE, text_len=8), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "bias":
            return 0.05 * noise
        if leaf.ndim == 1:
            return 1.0 + 0.05 * noise
        return noise / np.sqrt(leaf.shape[0])

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    jn = jmodel.config.net
    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype", "remat"}
    cfg = tdit.DiTConfig(dtype=torch.float32, remat="none", **{n: getattr(jn, n) for n in names})
    net = tdit.MiniTrainDIT(cfg).requires_grad_(False)
    net.load_state_dict(jax_dit_params_to_torch(params, cfg), strict=True)
    tmodel = tint.CausalVideo2WorldModel(tint.causal_model_config(cfg, num_frame_per_block=1, state_t=SHAPE[2]), net)
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel


@pytest.fixture(scope="module")
def models():
    return _models(False)


def _conditions(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((1, 8, 1024)) * 0.05).astype(np.float32)
    action = (scale * rng.standard_normal((1, 12, ACTION_DIM))).astype(np.float32)
    return (j_make_condition(jnp.asarray(emb)).replace(action=jnp.asarray(action)),
            make_condition(torch.from_numpy(emb)).replace(action=torch.from_numpy(action)))


@pytest.mark.parametrize("concat_mask", [False, True])
def test_cached_forward_with_actions_matches_jax(models, concat_mask):
    """One frame at a time against the KV cache: outputs and the caches'
    k, v and len after every call equal JAX's forward_with_cache; the
    action changes the output."""
    jmodel, params, tmodel = models if not concat_mask else _models(True)
    B, C, T, H, W = SHAPE
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    jcond, tcond = _conditions(1)
    jcaches = jmodel.init_kv_caches(B, T, H, W, dtype=jnp.float32)
    tcaches = tmodel.init_kv_caches(B, T, H, W, "cpu", dtype=torch.float32)
    jfwd = jax.jit(jmodel.forward_with_cache)
    for t0 in range(T):
        block = x[:, :, t0:t0 + 1]
        ts = np.full((B, 1), 300.0, np.float32)
        jout, jcaches = jfwd(params, jnp.asarray(block), jnp.asarray(ts), jcond, jcaches, t0)
        tout, tcaches = tmodel.forward_with_cache(torch.from_numpy(block), torch.from_numpy(ts), tcond, tcaches, t0)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
        for jc, tc in zip(jcaches, tcaches):
            assert tc["len"] == int(jc["len"]) == (t0 + 1) * 16
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=TOL, atol=TOL)
    zero = tcond.replace(action=torch.zeros_like(tcond.action))
    fresh = tmodel.init_kv_caches(B, T, H, W, "cpu", dtype=torch.float32)
    ts = torch.full((B, 1), 300.0)
    a, _ = tmodel.forward_with_cache(torch.from_numpy(x[:, :, :1]), ts, tcond, fresh, 0)
    b, _ = tmodel.forward_with_cache(torch.from_numpy(x[:, :, :1]), ts, zero, fresh, 0)
    assert float((a - b).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="no action"):
        tmodel.forward_with_cache(torch.from_numpy(x[:, :, :1]), ts, tcond.replace(action=None), fresh, 0)


def _fp32_caches(model, dtype):
    model = copy.copy(model)
    init = model.init_kv_caches
    model.init_kv_caches = lambda *args, **kw: init(*args, **kw, dtype=dtype)
    return model


def test_action_stream_matches_jax(models):
    """StreamingInference.generate with an action chunk: 2 steps, one
    prefilled frame and 4 streamed blocks with a 3-frame window (it
    slides), JAX's noise draws and fp32 caches on both sides; the stream
    with the action zeroed differs."""
    jmodel, params, tmodel = models
    scfg = dict(num_frame_per_block=1, cache_frame_size=3, num_steps=2)
    jstream = jint.StreamingInference(jint.StreamingConfig(**scfg), jmodel)
    tstream = tint.StreamingInference(tint.StreamingConfig(**scfg), tmodel)
    jstream.model = _fp32_caches(jmodel, jnp.float32)
    tstream.model = _fp32_caches(tmodel, torch.float32)
    init = np.random.default_rng(6).standard_normal((1, 16, 1, 8, 8)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jcond, tcond = _conditions(2)
    want = jstream.generate(params, rng, jcond, jnp.asarray(init), 5, (8, 8))

    def draw(step, shape):  # JAX's draw for block `step`
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.fold_in(rng, step), shape, jnp.float32)))

    got = tstream.generate(tcond, torch.from_numpy(init), 5, (8, 8), draw=draw)
    assert got.shape == (1, 16, 5, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STREAM_ATOL)
    zero = tstream.generate(tcond.replace(action=torch.zeros_like(tcond.action)), torch.from_numpy(init), 5, (8, 8),
                            draw=draw)
    assert float((got[:, :, 1:] - zero[:, :, 1:]).abs().max()) > 1e-3
