"""The port's T5 / umT5 encoder (text_encoders/t5_encoder.py), its offline
embedding wrapper (text_encoders/t5.py) and their loaders, held against the
JAX package on the CPU.

Tolerances: the bucket ids are integers and must be equal; the encoders
run fp32 on both sides and agree to ~1e-6 on outputs of unit scale,
checked at atol 3e-5 (the JAX package's own T5-vs-HF bound); the offline
wrapper runs its tower in bf16, as JAX's default backend does, so the two
packages' bf16 towers and the fp32 HF module agree at 2e-2 (the JAX
package's own bf16-vs-fp32 bound), and the zero fill past each length is
exact. In bf16, as build_t5_encoder stores it, the port's encoder rounds
where JAX's bf16 rounds: bit-equal outputs for both variants, checked at
2e-3 relative L2, while JAX's bf16 is 1.2e-2 to 1.5e-2 from its fp32.
"""

import dataclasses
import os

os.environ.setdefault("USE_TF", "0")  # transformers without its TensorFlow import (~10 s)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  torch's CPU threads under xdist
import transformers

from cosmos_predict2_tpu.text_encoders import t5 as jt5
from cosmos_predict2_tpu.text_encoders import t5_encoder as jt5e
from cosmos_predict2_tpu_torch.text_encoders import t5 as tt5
from cosmos_predict2_tpu_torch.text_encoders import t5_encoder as tt5e
from cosmos_predict2_tpu_torch.utils import checkpoint_convert as tconv
from cosmos_predict2_tpu_torch.utils.convert import jax_t5_params_to_torch
from torch_variants_util import jit_init, noisy_params, rel_l2

IDS = np.array([[3, 45, 12, 99, 7, 0, 0, 0], [5, 1, 250, 33, 21, 99, 4, 0]], dtype=np.int32)
BF16_REL_L2 = 2e-3
MASK = np.array([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 0]], dtype=np.int32)


@pytest.mark.parametrize("qlen,klen,buckets,max_distance", [(16, 16, 32, 128), (512, 512, 32, 128), (7, 300, 32, 128),
                                                             (300, 9, 16, 64), (200, 200, 64, 256)])
def test_relative_buckets_equal_jax(qlen, klen, buckets, max_distance):
    got = tt5e.relative_position_buckets(qlen, klen, buckets, max_distance)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jt5e.relative_position_buckets(qlen, klen, buckets, max_distance))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["t5_v1", "umt5"])
def test_encoder_matches_jax(variant, dtype):
    """T5 v1.0 (ReLU, the layer-0 bias table shared) and umT5 (gated GELU, a
    table per layer), with padding; in bf16 as build_t5_encoder stores it."""
    kw = dict(gated_act=True, per_layer_rel_bias=True) if variant == "umt5" else {}
    jcfg, tcfg = jt5e.T5Config.tiny(**kw), tt5e.T5Config.tiny(**kw)
    params = noisy_params(jit_init(jt5e.T5Encoder(jcfg).init, jax.random.PRNGKey(0), jnp.asarray(IDS),
                                   jnp.asarray(MASK)))
    enc = tt5e.T5Encoder(tcfg)
    sd = jax_t5_params_to_torch(params)
    enc.load_state_dict(sd, strict=True)
    n_tables = sum(k.endswith("relative_attention_bias.weight") for k in sd)
    assert n_tables == (tcfg.num_layers if variant == "umt5" else 1)
    want = np.asarray(jt5e.T5Encoder(jcfg).apply(jax.tree.map(jnp.asarray, params), jnp.asarray(IDS),
                                                 jnp.asarray(MASK)))
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(IDS).long(), torch.from_numpy(MASK).long()).numpy()
    assert got.shape == want.shape == (2, 8, 64)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    assert (got[MASK == 0] == 0).all() and (np.abs(got[MASK == 1]).sum(-1) > 0).all()
    if dtype == "bfloat16":
        enc16 = tt5e.build_t5_encoder(dataclasses.replace(tcfg, dtype=torch.bfloat16), "cpu", seed=None)
        enc16.load_state_dict(sd, strict=True)
        assert enc16.shared.weight.dtype == torch.bfloat16
        want16 = np.asarray(jt5e.T5Encoder(dataclasses.replace(jcfg, dtype=jnp.bfloat16)).apply(
            jax.tree.map(jnp.asarray, params), jnp.asarray(IDS), jnp.asarray(MASK)).astype(jnp.float32))
        with torch.no_grad():
            got16 = enc16(torch.from_numpy(IDS).long(), torch.from_numpy(MASK).long())
        assert rel_l2(got16.float().numpy(), want16) <= BF16_REL_L2 < rel_l2(want16, want) / 3


def _hf_t5(cfg, gated):
    torch.manual_seed(0)
    hf_cfg = transformers.T5Config(vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
                                   num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                                   feed_forward_proj="gated-gelu" if gated else "relu", is_encoder_decoder=False)
    return transformers.T5EncoderModel(hf_cfg).eval()


class FakeTok:
    """The JAX package's test tokenizer: one id per character, an end id, zero padding."""

    def __call__(self, prompts, **kw):
        n = kw.get("max_length", 8)
        ids = np.zeros((len(prompts), n), dtype=np.int64)
        mask = np.zeros((len(prompts), n), dtype=np.int64)
        for i, p in enumerate(prompts):
            toks = [ord(c) % 251 + 2 for c in p][: n - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("gated", [False, True])
def test_offline_encoder_matches_jax_and_zero_fills(gated, tmp_path, monkeypatch):
    """An HF checkpoint directory (config.json + model.safetensors) through
    the port's tower route (read without transformers' model classes) and its
    HF route, against JAX's two backends on the same module and tokenizer."""
    cfg = tt5e.T5Config.tiny()
    hf = _hf_t5(cfg, gated)
    hf.save_pretrained(tmp_path)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", staticmethod(lambda path: FakeTok()))
    monkeypatch.setattr(transformers.T5EncoderModel, "from_pretrained", staticmethod(lambda path, **kw: hf))
    prompts = ["a cat", "rain on a window at night"]  # the first pads, the second is cut
    jax_emb = jt5.OfflineT5Encoder("fake", max_length=8, backend="jax")(prompts)
    jax_hf = jt5.OfflineT5Encoder("fake", max_length=8, backend="torch")(prompts)
    tower = tt5.OfflineT5Encoder(str(tmp_path), max_length=8, device="cpu")
    got = tower(prompts)
    got_hf = tt5.OfflineT5Encoder(str(tmp_path), max_length=8, backend="torch")(prompts)
    assert tower._encoder.cfg.gated_act == gated and tower._encoder.cfg.dtype == torch.bfloat16
    assert got.shape == jax_emb.shape == (2, 8, cfg.d_model) and got.dtype == np.float32
    np.testing.assert_array_equal(got_hf, jax_hf)
    np.testing.assert_allclose(got, jax_emb, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, got_hf, atol=2e-2, rtol=2e-2)
    _, mask = tower.tokenize(prompts)
    assert (got[mask == 0] == 0).all() and (got_hf[mask == 0] == 0).all() and (mask == 0).any()


def test_t5_loader_takes_either_embedding_key():
    cfg = tt5e.T5Config.tiny()
    sd = {k: v for k, v in _hf_t5(cfg, False).state_dict().items() if k != "shared.weight"}
    enc = tt5e.T5Encoder(cfg)
    tconv.load_reference_state_dict(enc, tconv.convert_t5_hf_state_dict(sd), "T5")
    assert torch.equal(enc.shared.weight, sd["encoder.embed_tokens.weight"])
    with pytest.raises(KeyError, match="no token embedding"):
        tconv.convert_t5_hf_state_dict({k: v for k, v in sd.items() if k != "encoder.embed_tokens.weight"})


def test_save_and_load_embedding_round_trip(tmp_path):
    emb = np.random.default_rng(0).standard_normal((2, 6, 4)).astype(np.float32)
    paths = [str(tmp_path / "a.npy"), str(tmp_path / "b.npy")]
    tt5.save_embeddings(["x", "y"], lambda prompts: emb, paths)
    for i, path in enumerate(paths):
        for n in (4, 6, 9):
            np.testing.assert_array_equal(tt5.load_embedding(path, n), jt5.load_embedding(path, n))
        np.testing.assert_array_equal(tt5.load_embedding(path)[0], emb[i])


def _meta_params(cfg) -> int:
    with torch.device("meta"):
        return sum(p.numel() for p in tt5e.T5Encoder(cfg).parameters())


def test_t5_11b_has_the_published_widths_c7():
    """ROADMAP C7: the port's T5-11B preset is google-t5/t5-11b's encoder
    (d_kv 128, d_ff 65,536: 4.865e9 parameters counted on the meta device,
    4.83e9 of them in the 24 layers);
    the JAX package's preset keeps the class defaults d_kv 64, d_ff 16,384
    (1.64e9), pinned here as a recorded fault of the JAX package that the
    port does not carry."""
    cfg = tt5e.T5Config.t5_11b()
    assert (cfg.d_model, cfg.d_kv, cfg.d_ff, cfg.num_heads, cfg.num_layers) == (1024, 128, 65536, 128, 24)
    assert abs(_meta_params(cfg) - 4.865e9) < 0.001e9
    jcfg = jt5e.T5Config.t5_11b()
    assert (jcfg.d_kv, jcfg.d_ff) == (64, 16384)
    assert _meta_params(tt5e.T5Config(d_kv=64, d_ff=16384)) < 1.7e9


def test_umt5_xxl_matches_jax_preset():
    cfg, jcfg = tt5e.T5Config.umt5_xxl(), jt5e.T5Config.umt5_xxl()
    fields = ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads", "gated_act", "per_layer_rel_bias")
    assert all(getattr(cfg, f) == getattr(jcfg, f) for f in fields)
    assert abs(_meta_params(cfg) - 5.68e9) < 0.01e9
    hf = {"vocab_size": 256384, "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24, "num_heads": 64,
          "feed_forward_proj": "gated-gelu", "model_type": "umt5"}
    assert tt5e.T5Config.from_hf(hf) == cfg
