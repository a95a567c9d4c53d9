"""Reference checkpoints load into the port as the JAX package reads them.

The JAX CLI reads a DiT or VAE file through ``convert_model_checkpoint`` /
``convert_vae_state_dict``, which read only the keys they map: an extra
entry (a TransformerEngine ``_extra_state``, a buffer) is ignored, a missing
one raises. The port's CLI loads through ``load_reference_state_dict``,
held here to the same rules on a tiny DiT (2 blocks, 256 channels) and the
dim-16 VAE of the ``error-free_mock_data_smoke`` experiment, with state
dicts built from the JAX parameter trees by ``utils/convert.py``. Outputs
after a load with extra entries must equal the clean load's bit for bit.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.networks.dit import DiTConfig as JDiTConfig
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAEConfig as JVAEConfig
from cosmos_predict2_tpu_torch.configs.defaults import make_config
from cosmos_predict2_tpu_torch.inference.cli import _load_state_dict
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming
from cosmos_predict2_tpu_torch.utils.checkpoint_convert import load_reference_state_dict
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_vae_params_to_torch

EXTRA = {"dit": ["blocks.0.self_attn._extra_state", "pos_embedder.seq"],
         "vae": ["encoder.head.0._extra_state", "decoder.conv1.running_scale"]}


def _filled(shapes, seed):
    """A JAX parameter tree of the given shapes, filled from a seed (the
    loader reads values, not how they were initialised)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def _dit():
    base = dict(model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32, crossattn_emb_channels=64)
    jcfg = JDiTConfig(dtype=jnp.float32, remat="none", **base)
    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype"}
    tcfg = tdit.DiTConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    t = np.asarray([500.0], np.float32)
    ctx = rng.standard_normal((1, 7, 64)).astype(np.float32)
    params = _filled(jax.eval_shape(JDiT(jcfg).init, jax.random.PRNGKey(0), x, t, ctx), 0)
    sd = jax_dit_params_to_torch(params, tcfg)
    make = lambda: tdit.MiniTrainDIT(tcfg)
    run = lambda net: net(*map(torch.from_numpy, (x, t, ctx)), fps=torch.tensor([16.0]))
    return sd, make, run


def _vae():
    cfg = dataclasses.replace(make_config("error-free_mock_data_smoke").tokenizer, dtype=torch.float32)
    assert cfg.dim == 16
    params = _filled(jax.eval_shape(JVAE(JVAEConfig(dim=cfg.dim, dtype=jnp.float32)).init, jax.random.PRNGKey(1),
                                    jnp.zeros((1, 5, 16, 16, 3), jnp.float32)), 1)
    sd = jax_vae_params_to_torch(params)
    video = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32))
    return sd, lambda: WanVAE(cfg), lambda vae: encode_streaming(vae, video)


@pytest.fixture(scope="module", params=["dit", "vae"])
def model(request):
    """(name, state dict from the JAX tree, module factory, forward)."""
    sd, make, run = (_dit if request.param == "dit" else _vae)()
    return request.param, sd, make, run


def test_extra_entries_load_are_logged_and_change_nothing(model, caplog):
    name, sd, make, run = model
    clean = make()
    load_reference_state_dict(clean, sd, name)
    noisy = dict(sd)
    noisy[EXTRA[name][0]] = torch.zeros(16, dtype=torch.uint8)  # serialized extra state
    noisy[EXTRA[name][1]] = np.ones(3, np.float32)  # a buffer the port does not keep
    loaded = make()
    with caplog.at_level(logging.WARNING, logger="cosmos_predict2_tpu_torch"):
        load_reference_state_dict(loaded, noisy, name)
    assert "ignoring 2 checkpoint entries" in caplog.text
    for key in EXTRA[name]:
        assert key in caplog.text
    with torch.no_grad():
        assert torch.equal(run(loaded), run(clean))


def test_missing_key_raises_and_names_it(model):
    name, sd, make, _ = model
    key = sorted(sd)[len(sd) // 2]
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        load_reference_state_dict(make(), {k: v for k, v in sd.items() if k != key}, name)


def test_wrong_shape_raises(model):
    name, sd, make, _ = model
    key = next(k for k, v in sd.items() if v.ndim >= 2)
    bad = dict(sd)
    bad[key] = torch.zeros(tuple(sd[key].shape[:-1]) + (sd[key].shape[-1] + 1,))
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_reference_state_dict(make(), bad, name)


def test_cli_prefers_net_ema_over_net(tmp_path):
    """As JAX's convert_model_checkpoint: the ``net_ema.`` weights of a
    consolidated file win over ``net.``; either prefix is stripped; a file
    with neither loads as it is."""
    sd, make, run = _dit()
    stale = {k: torch.zeros_like(v) for k, v in sd.items()}
    path = tmp_path / "model.pt"
    torch.save({**{f"net.{k}": v for k, v in stale.items()}, **{f"net_ema.{k}": v for k, v in sd.items()}}, path)
    net = make()
    load_reference_state_dict(net, _load_state_dict(str(path), ("net_ema.", "net.")), "DiT checkpoint")
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    torch.save({f"net.{k}": v for k, v in sd.items()}, path)
    assert sorted(_load_state_dict(str(path), ("net_ema.", "net."))) == sorted(sd)
    torch.save(sd, path)
    assert sorted(_load_state_dict(str(path), ("net_ema.", "net."))) == sorted(sd)
