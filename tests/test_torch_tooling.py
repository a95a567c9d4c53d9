"""The port's tooling against the JAX package's: the VAE interface
(tokenizers/interface.py) on a dim-16 VAE with JAX's weights carried across
by utils/convert.py, the model comparison (utils/model_comp.py), golden
activation dumps of a DiT at the JAX ``test`` preset's widths
(utils/golden_activations.py), the tone curve (utils/tone_curve.py) and the
VQA specs (utils/vqa_check.py). fp32 on both sides, on the CPU."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.tokenizers import interface as jinterface
from cosmos_predict2_tpu.utils import golden_activations as jgolden
from cosmos_predict2_tpu.utils import model_comp as jcomp
from cosmos_predict2_tpu.utils import tone_curve as jtone
from cosmos_predict2_tpu.utils import vqa_check as jvqa
from cosmos_predict2_tpu_torch.tokenizers import interface
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig
from cosmos_predict2_tpu_torch.utils import golden_activations, model_comp, tone_curve, vqa_check
from cosmos_predict2_tpu_torch.utils.convert import jax_vae_params_to_torch
from torch_variants_util import REL_L2, port_net, rel_l2, seeded_jax_params, vae_pair

# the dim-16 VAE in fp32, the port's one-shot route against JAX's jitted one:
# 1.1e-7 - 4.3e-7 relative L2 measured on these encodes, 8.4e-7 - 1.2e-6 on
# the decodes; the DiT's fp32 bound (REL_L2), about 8x the worst
VAE_REL_L2 = REL_L2


@pytest.fixture(scope="module")
def vaes():
    """JAX's interface and the port's over the same dim-16 weights, each
    without statistics and with seeded non-trivial ones."""
    jcfg, jparams, vae = vae_pair(seed=5)
    rng = np.random.default_rng(5)
    stats = dict(img_mean=rng.standard_normal((1, 16, 1, 1, 1)).astype(np.float32),
                 img_std=rng.uniform(0.5, 2.0, (1, 16, 1, 1, 1)).astype(np.float32),
                 video_mean=rng.standard_normal((1, 1, 50, 1, 1)).astype(np.float32),
                 video_std=rng.uniform(0.5, 2.0, (1, 1, 50, 1, 1)).astype(np.float32))
    out = {}
    for name, kw in (("plain", {}), ("stats", stats)):
        out[name] = (jinterface.WanVAEInterface(jinterface.VAEInterfaceConfig(vae=jcfg), jparams, **kw),
                     interface.WanVAEInterface(interface.VAEInterfaceConfig(vae=vae.config), vae, **kw))
    return out, jparams, vae


def test_vae_interface_properties_equal_jax(vaes):
    j, t = vaes[0]["plain"]
    for n in (1, 5, 9, 93):
        assert t.get_latent_num_frames(n) == j.get_latent_num_frames(n)
    for n in (1, 2, 24):
        assert t.get_pixel_num_frames(n) == j.get_pixel_num_frames(n)
    for name in ("spatial_compression_factor", "temporal_compression_factor", "latent_ch", "pixel_chunk_duration",
                 "latent_chunk_duration", "name"):
        assert getattr(t, name) == getattr(j, name), name
    assert (t.latent_chunk_duration, t.pixel_chunk_duration) == (21, 81)
    with pytest.raises(ValueError, match="interface's"):
        interface.WanVAEInterface(interface.VAEInterfaceConfig(vae=WanVAEConfig(dim=32)), t.vae)


@pytest.mark.parametrize("stats", ["plain", "stats"])
@pytest.mark.parametrize("frames", [1, 5])
def test_vae_interface_encode_decode_equal_jax(vaes, stats, frames):
    """encode and decode of (B, C, T, H, W) for t == 1 (image statistics) and
    t > 1 (per-latent-frame statistics), with and without statistics."""
    j, t = vaes[0][stats]
    rng = np.random.default_rng(frames)
    x = rng.uniform(-1, 1, (1, 3, frames, 16, 16)).astype(np.float32)
    want = np.asarray(j.encode(jnp.asarray(x)))
    got = t.encode(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 16, 1 + (frames - 1) // 4, 2, 2) and got.dtype == torch.float32
    assert rel_l2(got, want) <= VAE_REL_L2, rel_l2(got, want)
    z = rng.standard_normal(want.shape).astype(np.float32)
    px_want = np.asarray(j.decode(jnp.asarray(z)))
    px = t.decode(torch.from_numpy(z))
    assert px.shape == px_want.shape == (1, 3, frames, 16, 16)
    assert rel_l2(px, px_want) <= VAE_REL_L2, rel_l2(px, px_want)
    if stats == "stats":  # the statistics are applied: the plain interface's latents, normalized
        plain = vaes[0]["plain"][1].encode(torch.from_numpy(x))
        mean, std = t._stats(plain.shape[2])
        assert torch.allclose(got, (plain - mean) / std, rtol=1e-6, atol=1e-6)


def test_compare_models_thoroughly_on_converted_params(vaes):
    """The port's VAE state dict against JAX's tree carried across by
    utils/convert.py: no difference at atol 0; a changed, a missing and a
    reshaped leaf are reported as JAX's tool reports them."""
    _, jparams, vae = vaes
    sd = vae.state_dict()
    # (vae_pair draws some leaves in float64; the VAE holds them in fp32)
    converted = jax_vae_params_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams))
    assert model_comp.compare_models_thoroughly(sd, converted) == []
    changed = dict(converted)
    key = "encoder.conv1.weight"
    changed[key] = changed[key] + 0.5
    extra = {"x": torch.zeros(2)}
    diffs = model_comp.compare_models_thoroughly({**sd, **extra}, {k: v for k, v in changed.items() if k != "conv1.bias"}
                                                 | {"conv2.bias": torch.zeros(3)})
    assert {d.name for d in diffs} == {"x [MISSING IN B]", "conv1.bias [MISSING IN B]", "conv2.bias [SHAPE MISMATCH]",
                                       key}
    assert diffs[-1].name == key  # sorted worst first: the infinite entries lead
    d = next(d for d in diffs if d.name == key)
    ref = jcomp.TensorDifference.compare(sd[key].numpy(), changed[key].numpy(), key)
    assert (d.max_abs, d.max_rel, d.mean_abs) == (ref.max_abs, ref.max_rel, ref.mean_abs)
    # nested dicts flatten by dotted name, tensors and arrays alike
    nested = {"a": {"b": np.ones(3, np.float32)}, "c": torch.ones(2)}
    assert model_comp.compare_models_thoroughly(nested, {"a.b": torch.ones(3), "c": np.ones(2)}) == []


def test_tensor_difference_equals_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((4, 5)).astype(np.float32), rng.standard_normal((4, 5)).astype(np.float32)
    for x, y in ((a, b), (torch.from_numpy(a).bfloat16(), b), (a[:0], b[:0])):
        got = model_comp.TensorDifference.compare(x, y, "t")
        want = jcomp.TensorDifference.compare(np.asarray(torch.as_tensor(x).float()), y, "t")
        assert dataclasses.asdict(got) == dataclasses.asdict(want) and str(got) == str(want)


def test_golden_dumps_of_both_packages_agree(tmp_path):
    """A DiT at the JAX ``test`` preset's widths (384 channels, 3 heads, 2
    blocks), JAX's seeded weights carried across: the port's dump and JAX's
    hold the same keys, and each tensor agrees within the fp32 DiT bound."""
    jcfg = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    t = np.asarray([0.4], np.float32) * 1000
    ctx = (rng.standard_normal((1, 8, jcfg.crossattn_emb_channels)) * 0.5).astype(np.float32)
    params = seeded_jax_params(jcfg, x, t, ctx, seed=11)
    want = jgolden.dump_dit_activations(JDiT(jcfg), params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                        str(tmp_path / "jax.npz"))
    net = port_net(params, jcfg)
    got = golden_activations.dump_dit_activations(net, torch.from_numpy(x), torch.from_numpy(t),
                                                  torch.from_numpy(ctx), str(tmp_path / "port.npz"))
    assert sorted(got) == sorted(want) == ["block_00", "block_01", "input", "output"]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert rel_l2(got[k], want[k]) <= REL_L2, k
    diffs = golden_activations.compare_activation_dumps(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))
    ref = jgolden.compare_activation_dumps(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))
    assert [dataclasses.asdict(d) for d in diffs] == [dataclasses.asdict(d) for d in ref]
    assert {d.name for d in diffs} == set(want) and diffs[-1].name == "input" and diffs[-1].max_abs == 0
    np.savez(tmp_path / "short.npz", **{k: v for k, v in want.items() if k != "block_01"})
    missing = golden_activations.compare_activation_dumps(str(tmp_path / "port.npz"), str(tmp_path / "short.npz"))
    assert missing[0].name == "MISSING:block_01" and missing[0].max_abs == float("inf")


_TONE_RNG = np.random.default_rng(21)
_RGBA = np.concatenate([_TONE_RNG.uniform(0, 1, (48, 40, 3)), (_TONE_RNG.uniform(0, 1, (48, 40, 1)) > 0.3)],
                       axis=-1).astype(np.float32)
TONE_CASES = {
    "srgb_to_linear": lambda m: m.srgb_to_linear(_RGBA[..., :3]),
    "linear_to_srgb": lambda m: m.linear_to_srgb(_RGBA[..., :3] * 1.3 - 0.1),
    "luminance": lambda m: m.luminance(_RGBA[..., :3]),
    "commerce_tonemap": lambda m: m.commerce_tonemap(_RGBA[..., :3] * 4.0),
    "autoexposure": lambda m: m.autoexposure(_RGBA[..., :3], _RGBA[..., 3:4], key=0.2),
    "apply_tone_curve_array log commerce": lambda m: m.apply_tone_curve_array(_RGBA),
    "apply_tone_curve_array straight log": lambda m: m.apply_tone_curve_array(
        _RGBA, input_mapping="straight", output_mapping="log", ae_strength_below=0.5, ae_strength_above=0.7),
    "apply_tone_curve_array fixed exposure": lambda m: m.apply_tone_curve_array(_RGBA, auto=False,
                                                                               output_mapping="straight"),
    "replace_bg_color_u8": lambda m: m.replace_bg_color_u8((_RGBA[..., :3] * 255).astype(np.uint8),
                                                           (_RGBA[..., 3:] * 255).astype(np.uint8), (0, 0, 0),
                                                           (120, 200, 33)),
    "apply_tone_curve (PIL)": lambda m: [np.asarray(im) for im in m.apply_tone_curve(
        [__import__("PIL.Image").Image.fromarray((_RGBA * 255).astype(np.uint8))] * 2)[0]],
}


@pytest.mark.parametrize("case", list(TONE_CASES))
def test_tone_curve_equals_jax(case):
    got, want = TONE_CASES[case](tone_curve), TONE_CASES[case](jtone)
    for g, w in zip(got if isinstance(got, (tuple, list)) else [got], want if isinstance(want, (tuple, list)) else [want]):
        assert np.array_equal(np.asarray(g), np.asarray(w))


SPECS = sorted(str(p.relative_to(Path(__file__).parent)) for p in (Path(__file__).parent / "vqa_questions").rglob("*.yaml"))


@pytest.mark.parametrize("spec", SPECS)
def test_vqa_spec_reports_equal_jax(spec):
    """Every spec under tests/vqa_questions/ loads as JAX's does, and a stub
    answerer (the expected answer for every other question, a miss for the
    rest) gives JAX's report."""
    path = Path(__file__).parent / spec
    got, want = vqa_check.load_spec(path), jvqa.load_spec(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.vqa_checks
    checks = got.must_pass_checks + got.vqa_checks
    for flip in (0, 1):
        def answer(question):
            i = next(i for i, c in enumerate(checks) if c.question == question)
            return checks[i].answer + " " + " ".join(checks[i].contains) if i % 2 == flip else "I cannot tell"

        reports = [mod.run_spec(s, answer, min_vqa_score=0.4) for mod, s in ((vqa_check, got), (jvqa, want))]
        assert dataclasses.asdict(reports[0]) == dataclasses.asdict(reports[1])
        assert (reports[0].passed, reports[0].vqa_score) == (reports[1].passed, reports[1].vqa_score)
    assert vqa_check.answer_hits("A  Sharp\nImage", ["sharp image"]) and not vqa_check.answer_hits("blur", ["sharp"])
