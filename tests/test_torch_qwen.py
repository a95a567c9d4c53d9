"""The port's Cosmos-Reason1 text encoder (text_encoders/qwen.py,
text_encoder.py), its HF loader and the inference CLI's ``--text-encoder``
route, held against the JAX package on the CPU.

Tolerances: fp32 on both sides. Every hidden state of the tiny LMs agrees
to ~1e-6 (checked at atol 1e-5); the pooled embeddings are mean-normalized
(unit scale), checked at 1e-5 too; guard logits at 1e-5, and the greedy
tokens must be equal. In bf16 (the card's dtype, the LM as build_qwen_lm
stores it) the port rounds where the JAX package's bf16 rounds: every
hidden state is bit-equal on ``tiny`` and within 7.2e-5 relative L2 on
``tiny3`` (one element of one state an ulp apart), checked at 2e-3, while
JAX's bf16 is 1.1e-2 to 1.6e-2 from its fp32. The whole slice (prompt -> fake tokenizer -> Reason1
-> 2 UniPC steps with batched CFG through a 2-block DiT -> VAE) is checked
at test_torch_pipeline.py's 2e-3 max-abs on [-1, 1] pixels.
"""

import functools
import json

import os

os.environ.setdefault("USE_TF", "0")  # transformers without its TensorFlow import (~10 s)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  torch's CPU threads under xdist
import transformers

from cosmos_predict2_tpu.text_encoders import qwen as jqwen
from cosmos_predict2_tpu.text_encoders import text_encoder as jte
from cosmos_predict2_tpu_torch.inference import cli as tcli
from cosmos_predict2_tpu_torch.text_encoders import qwen as tqwen
from cosmos_predict2_tpu_torch.text_encoders import text_encoder as tte
from cosmos_predict2_tpu_torch.utils import checkpoint_convert as tconv
from cosmos_predict2_tpu_torch.utils.convert import jax_qwen_params_to_torch
from torch_variants_util import jit_init, noisy_params, rel_l2

ATOL = 1e-5
BF16_REL_L2 = 2e-3
S = 12


def _jcfg(name):
    return getattr(jqwen.QwenConfig, name)()


def _tcfg(name):
    return getattr(tqwen.QwenConfig, name)()


def _ids(seed=0, batch=2, seq=S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _lm_params(name):
    """JAX QwenLM params: the init plus seeded noise, so the biases and norms matter."""
    return noisy_params(jit_init(jqwen.QwenLM(_jcfg(name)).init, jax.random.PRNGKey(0), jnp.asarray(_ids())))


@pytest.fixture(scope="module", params=["tiny", "tiny3"])
def lm_pair(request):
    """The JAX params and the port's QwenLM holding them."""
    name = request.param
    params = _lm_params(name)
    lm = tqwen.QwenLM(_tcfg(name))
    lm.load_state_dict(jax_qwen_params_to_torch(params), strict=True)
    return name, params, lm.eval()


def test_every_hidden_state_matches_jax(lm_pair):
    name, params, lm = lm_pair
    ids = _ids(1)
    want, want_normed = jqwen.QwenLM(_jcfg(name)).apply(params, jnp.asarray(ids), return_normed=True)
    with torch.no_grad():
        got, got_normed = lm(torch.from_numpy(ids).long(), return_normed=True)
    assert len(got) == len(want) == _tcfg(name).num_hidden_layers + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_normed.numpy(), np.asarray(want_normed), atol=ATOL, rtol=0)


def test_bf16_hidden_states_match_jax_bf16(lm_pair):
    """The LM in bf16 as build_qwen_lm makes it (Linear weights and token
    embeddings stored in bf16, norms fp32) against the JAX LM at dtype bf16
    on the same fp32 parameters: each state and the pooled embedding within
    BF16_REL_L2, which is under a fifth of JAX's own bf16-vs-fp32 gap, so a
    missing or extra rounding shows."""
    import dataclasses

    name, params, _ = lm_pair
    jcfg16 = dataclasses.replace(_jcfg(name), dtype=jnp.bfloat16)
    lm = tqwen.build_qwen_lm(dataclasses.replace(_tcfg(name), dtype=torch.bfloat16), "cpu", seed=None)
    lm.load_state_dict(jax_qwen_params_to_torch(params), strict=True)
    assert lm.embed_tokens.weight.dtype == lm.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
    ids = _ids(1)
    want = jqwen.QwenLM(jcfg16).apply(params, jnp.asarray(ids))
    want32 = jqwen.QwenLM(_jcfg(name)).apply(params, jnp.asarray(ids))
    with torch.no_grad():
        got = lm(torch.from_numpy(ids).long())
    for g, w, w32 in zip(got[1:], want[1:], want32[1:]):
        assert g.dtype == torch.bfloat16
        w, w32 = np.asarray(w.astype(jnp.float32)), np.asarray(w32)
        assert rel_l2(g.float().numpy(), w) <= BF16_REL_L2 < rel_l2(w, w32) / 5
    pooled = tqwen.pool_hidden_states(got)
    assert rel_l2(pooled.numpy(), np.asarray(jqwen.pool_hidden_states(want))) <= BF16_REL_L2


@pytest.mark.parametrize("strategy", ["full_concat", "mean_pooling", "pool_every_n_layers_and_concat"])
def test_pooling_matches_jax(lm_pair, strategy):
    name, params, lm = lm_pair
    ids = _ids(2)
    hs = jqwen.QwenLM(_jcfg(name)).apply(params, jnp.asarray(ids))
    want = jqwen.pool_hidden_states(hs, strategy, n_layers_per_group=1)
    with torch.no_grad():
        got = tqwen.pool_hidden_states(lm(torch.from_numpy(ids).long()), strategy, n_layers_per_group=1)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_mean_normalize_matches_jax_and_torch_std():
    x = np.random.default_rng(3).standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    got = tqwen.mean_normalize(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jqwen.mean_normalize(jnp.asarray(x))), atol=1e-6, rtol=0)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(got.numpy(), ((xt - xt.mean(-1, keepdim=True)) / (xt.std(-1, keepdim=True) + 1e-8))
                               .numpy(), atol=1e-6, rtol=0)


def test_encode_multimodal_with_a_vision_splice_matches_jax(lm_pair):
    name, params, lm = lm_pair
    ids = _ids(4)
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((2, S, 64)).astype(np.float32)
    mask = np.zeros((2, S), dtype=bool)
    mask[0, 2:6], mask[1, 5:9] = True, True
    jenc = jte.CosmosTextEncoder(jte.TextEncoderConfig(model=_jcfg(name)), params=params)
    want = jenc.encode_multimodal(jnp.asarray(ids), jnp.asarray(embeds), mask)
    tenc = tte.CosmosTextEncoder(tte.TextEncoderConfig(model=_tcfg(name)), lm)
    got = tenc.encode_multimodal(ids, torch.from_numpy(embeds), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the splice moves the result
    assert np.abs(got.numpy() - tenc.encode_tokens(ids).numpy()).max() > 1e-2


def test_guard_logits_and_greedy_tokens_match_jax():
    jcfg, tcfg = _jcfg("tiny3"), _tcfg("tiny3")
    ids = _ids(6, batch=1, seq=16)
    params = jax.tree.map(jnp.asarray, noisy_params(jit_init(jqwen.QwenGuardLM(jcfg).init, jax.random.PRNGKey(1),
                                                             jnp.asarray(ids)), 1))
    guard = tqwen.QwenGuardLM(tcfg)
    guard.load_state_dict(jax_qwen_params_to_torch(params), strict=True)
    jguard = jqwen.QwenGuardLM(jcfg)
    for pos in (None, 7):
        want = jguard.apply(params, jnp.asarray(ids), None if pos is None else jnp.asarray(pos))
        with torch.no_grad():
            got = guard(torch.from_numpy(ids).long(), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    prompt = ids[0, :9].tolist()
    apply = jax.jit(lambda b, p: jguard.apply(params, b, p))
    want = jqwen.greedy_generate(apply, prompt, max_new_tokens=6, buffer_len=24)
    with torch.no_grad():
        got = tqwen.greedy_generate(lambda b, p: guard(b, p), prompt, max_new_tokens=6, buffer_len=24, device="cpu")
    assert got == want and len(got) == 6


def _hf_state_dict(params, prefix: str, with_head: bool, jcfg) -> dict:
    """The JAX LM's weights under HF names (``{prefix}layers...``), as numpy."""
    sd = {f"{prefix}{k}": v.numpy() for k, v in jax_qwen_params_to_torch(params).items()}
    if with_head:
        # std 1/sqrt(hidden), as a trained head's scale: logits of order 1
        head = np.random.default_rng(9).standard_normal((jcfg.vocab_size, jcfg.hidden_size)) / np.sqrt(jcfg.hidden_size)
        sd["lm_head.weight"] = head.astype(np.float32)
    return sd


@pytest.mark.parametrize("prefix", ["model.language_model.", "model.", ""])
def test_hf_loader_under_each_prefix_matches_jax_converter(lm_pair, prefix):
    """The port's loader and JAX's convert_qwen_hf_state_dict read the same
    HF-keyed dict (with a vision tower's entries beside it) to the same outputs."""
    name, params, _ = lm_pair
    jcfg = _jcfg(name)
    sd = _hf_state_dict(params, prefix, with_head=False, jcfg=jcfg)
    sd["model.visual.blocks.0.norm1.weight" if prefix else "visual.blocks.0.norm1.weight"] = np.ones(4, np.float32)
    assert tconv.qwen_lm_prefix(sd) == prefix
    deltas = tconv.qwen_hf_deltas(tconv.convert_qwen_hf_state_dict(sd))
    assert deltas == {"num_hidden_layers": 2, "attention_bias": jcfg.attention_bias, "qk_norm": jcfg.qk_norm}
    lm = tqwen.QwenLM(_tcfg(name))
    hf = {k: torch.from_numpy(v) for k, v in sd.items()}
    tconv.load_reference_state_dict(lm, tconv.convert_qwen_hf_state_dict(hf), "Qwen LM")
    jparams = jax.tree.map(jnp.asarray, jte.convert_qwen_hf_state_dict(sd, jcfg.num_hidden_layers))
    ids = _ids(7)
    want = jqwen.pool_hidden_states(jqwen.QwenLM(jcfg).apply(jparams, jnp.asarray(ids)))
    with torch.no_grad():
        got = tqwen.pool_hidden_states(lm.eval()(torch.from_numpy(ids).long()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("tied", [True, False])
def test_guard_loader_tied_or_not_matches_jax_converter(tied):
    jcfg = _jcfg("tiny3") if tied else _jcfg("tiny")
    tcfg = _tcfg("tiny3") if tied else _tcfg("tiny")
    params = noisy_params(jit_init(jqwen.QwenLM(jcfg).init, jax.random.PRNGKey(2), jnp.asarray(_ids())), 2)
    sd = _hf_state_dict(params, "model.", with_head=not tied, jcfg=jcfg)
    jparams = jax.tree.map(jnp.asarray, jte.convert_qwen_guard_hf_state_dict(sd, jcfg.num_hidden_layers))
    guard = tqwen.QwenGuardLM(tcfg)
    tconv.load_reference_state_dict(
        guard, tconv.convert_qwen_guard_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}), "guard")
    if tied:
        assert torch.equal(guard.lm_head.weight, guard.model.embed_tokens.weight)
    ids = _ids(8, batch=1)
    want = jqwen.QwenGuardLM(jcfg).apply(jparams, jnp.asarray(ids))
    with torch.no_grad():
        got = guard.eval()(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


class FakeChatTokenizer:
    """A chat-template tokenizer stand-in: one id per character of each
    message, a separator between messages."""

    pad_token_id = 0

    def apply_chat_template(self, conversation, tokenize=True, add_generation_prompt=False):
        assert tokenize and not add_generation_prompt
        ids = []
        for message in conversation:
            ids += [3] + [ord(c) % 250 + 5 for c in message["content"]]
        return ids


@pytest.fixture
def fake_tokenizer(monkeypatch):
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", staticmethod(lambda path: FakeChatTokenizer()))


def test_tokenize_pads_and_truncates_to_512_as_jax(fake_tokenizer):
    prompts = ["a robot pours coffee", "x" * 700]
    tenc = tte.CosmosTextEncoder(tte.TextEncoderConfig(model=_tcfg("tiny"), tokenizer_path="fake"))
    jenc = jte.CosmosTextEncoder(jte.TextEncoderConfig(model=_jcfg("tiny"), tokenizer_path="fake"))
    got = tenc.tokenize(prompts)
    assert got.shape == (2, 512) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jenc.tokenize(prompts))
    n_first = 2 + len(tte.SYSTEM_PROMPT) + len(prompts[0])
    assert (got[0, n_first:] == 0).all() and (got[0, :n_first] != 0).all()  # padded
    assert (got[1] != 0).all()  # truncated


def test_tokenize_without_a_tokenizer_path_raises():
    tenc = tte.CosmosTextEncoder(tte.TextEncoderConfig(model=_tcfg("tiny")), tqwen.QwenLM(_tcfg("tiny")))
    with pytest.raises(ValueError, match="tokenizer_path not set"):
        tenc(["a prompt"])


# ------------------------------ the whole slice ------------------------------


def _reason1_dir(tmp_path, params, jcfg):
    """A tiny Reason1 checkpoint as HF ships one: config.json (Qwen2.5-VL's
    nested text_config) and the weights under model.language_model."""
    sd = {k: torch.from_numpy(v) for k, v in _hf_state_dict(params, "model.language_model.", False, jcfg).items()}
    torch.save(sd, tmp_path / "reason1.pt")
    text = {f: getattr(jcfg, f) for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                                          "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps",
                                          "rope_theta")}
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen2_5_vl", "text_config": text}))
    return str(tmp_path / "reason1.pt")


def test_slice_prompt_to_video_matches_jax(tmp_path, fake_tokenizer, monkeypatch):
    """Prompt -> Reason1 -> Video2World, the port against JAX on the same
    seeds. The port's text encoder comes from its CLI's ``build_pipeline``
    with ``--text-encoder`` and ``--tokenizer-path`` (COSMOS_SMOKE, the
    plumbing experiment, on the CPU); JAX's is built as its CLI builds it
    (cli.py:139-153; its build_pipeline takes the 7B config and an eager VAE
    init, too big and slow for a toy size). The two encoders then condition
    test_torch_pipeline.py's toy pipelines (the same weights and noise)
    through ``generate_vid2world``, with CFG against a negative prompt."""
    import test_torch_pipeline as tp

    from cosmos_predict2_tpu_torch.utils import flags

    jcfg = _jcfg("tiny")
    path = _reason1_dir(tmp_path, _lm_params("tiny"), jcfg)
    monkeypatch.setattr(flags, "SMOKE", True)
    args = tcli.parse_args(["--experiment=error-free_mock_data_smoke", "--text-encoder", path,
                            "--tokenizer-path", "fake", "--device", "cpu"])
    pipe_cli = tcli.build_pipeline(args)
    encoder = pipe_cli.text_encoder
    assert isinstance(encoder, tte.CosmosTextEncoder) and encoder.config.model.num_hidden_layers == 2
    assert encoder.config.model.dtype == torch.float32 and encoder.config.tokenizer_path == "fake"

    # JAX's CLI route for the same file (its 7B TextEncoderConfig swapped for the tiny one)
    from cosmos_predict2_tpu.utils.checkpoint_convert import load_torch_state_dict

    jsd = load_torch_state_dict(path)
    jenc = jte.CosmosTextEncoder(jte.TextEncoderConfig(model=jcfg, tokenizer_path="fake"),
                                 params=jax.tree.map(jnp.asarray, jte.convert_qwen_hf_state_dict(jsd, 2)))
    prompts = ["a robot arm stacks red cubes", "blurry, low quality"]
    emb_want = np.asarray(jenc(prompts))
    emb_got = encoder(prompts).numpy()
    assert emb_got.shape == emb_want.shape == (2, 512, 2 * jcfg.hidden_size)
    np.testing.assert_allclose(emb_got, emb_want, atol=ATOL, rtol=0)

    monkeypatch.setattr(tp, "CTX_IN", 2 * jcfg.hidden_size)
    jpipe, pipe = tp._pipelines((tp.SIZE, tp.SIZE))
    jpipe.text_encoder, pipe.text_encoder = jenc, encoder
    video = np.random.default_rng(11).integers(0, 256, (1, 3, 5, tp.SIZE, tp.SIZE), dtype=np.uint8)
    want = jpipe.generate_vid2world(video, jpipe.encode_text(prompts[:1]), neg_text_emb=jpipe.encode_text(prompts[1:]),
                                    num_steps=2, num_conditional_frames=1)
    got = pipe.generate_vid2world(video, pipe.encode_text(prompts[:1]), neg_text_emb=pipe.encode_text(prompts[1:]),
                                  num_steps=2, num_conditional_frames=1)
    assert got.shape == want.shape == (5, tp.SIZE, tp.SIZE, 3)
    assert np.abs(got - want).max() <= 2e-3


def test_cli_smoke_keeps_zero_embeddings_only_without_a_text_encoder(monkeypatch):
    from cosmos_predict2_tpu_torch.utils import flags

    monkeypatch.setattr(flags, "SMOKE", True)
    pipe = tcli.build_pipeline(tcli.parse_args(["--experiment=error-free_mock_data_smoke", "--device", "cpu"]))
    emb = pipe.encode_text(["a"])
    assert emb.shape == (1, 512, 1024) and not emb.any()  # the plumbing net takes 1024 text channels


def test_build_stores_matmul_weights_in_the_compute_dtype():
    """build_qwen_lm on the meta device: Linear weights and token embeddings
    in bf16, norms fp32, the guard's head fp32; the same seed draws the same
    weights, and the encoder's pooled embedding is finite."""
    import dataclasses

    cfg = dataclasses.replace(tqwen.QwenConfig.tiny3(), dtype=torch.bfloat16)
    guard = tqwen.build_qwen_lm(cfg, "cpu", seed=3, guard=True)
    lm = guard.model
    assert lm.embed_tokens.weight.dtype == torch.bfloat16 and lm.layers[0].mlp.up_proj.weight.dtype == torch.bfloat16
    assert lm.norm.weight.dtype == torch.float32 and lm.layers[0].self_attn.q_norm.weight.dtype == torch.float32
    assert guard.lm_head.weight.dtype == torch.float32 and not any(p.requires_grad for p in guard.parameters())
    again = tqwen.build_qwen_lm(cfg, "cpu", seed=3, guard=True)
    assert all(torch.equal(a, b) for a, b in zip(guard.state_dict().values(), again.state_dict().values()))
    enc = tte.build_text_encoder(tte.TextEncoderConfig(model=cfg, num_padding_tokens=16), "cpu", seed=4)
    emb = enc.encode_tokens(_ids(10, batch=1, seq=16))
    assert emb.shape == (1, 16, 2 * cfg.hidden_size) and emb.dtype == torch.float32 and bool(torch.isfinite(emb).all())
