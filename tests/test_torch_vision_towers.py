"""The port's vision towers and XLM-R (text_encoders/clip_vision.py,
siglip_vision.py, qwen_vision.py, xlm_roberta.py), their preprocessing and
Wan i2v's ``make_i2v_condition`` with the CLIP tower, held against the JAX
package on the CPU.

Tolerances: fp32 on both sides, narrow widths. The towers' outputs are of
order 1 and agree to ~1e-6, checked at atol 2e-5 (the JAX package's own
SigLIP-vs-HF bound); the host metadata (window permutation, segments,
rotary angles) and the patch order must be equal; the bicubic resize
agrees to fp32 rounding (1e-5 on [-1, 1] pixels, checked at 2e-5 after
CLIP's normalisation, which scales by up to 3.8). In bf16 (the card's
dtype, each tower as its build function stores it) the CLIP tower and
XLM-R round where the JAX package's bf16 rounds: their outputs are
bit-equal to JAX's bf16, checked at 2e-3 relative L2, while JAX's bf16 is
6.8e-3 to 9.8e-3 from its fp32; the activations (text_encoders/common.py)
are bit-equal to jax.nn's in bf16 but for subnormal outputs.
"""

import dataclasses
import os

os.environ.setdefault("USE_TF", "0")  # transformers' image processor: no TensorFlow import (~10 s)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  torch's CPU threads under xdist

from cosmos_predict2_tpu.models import wan_video2world as jwv
from cosmos_predict2_tpu.text_encoders import clip_vision as jclip
from cosmos_predict2_tpu.text_encoders import qwen_vision as jqv
from cosmos_predict2_tpu.text_encoders import siglip_vision as jsig
from cosmos_predict2_tpu.text_encoders import xlm_roberta as jxlm
from cosmos_predict2_tpu_torch.models import wan_video2world as twv
from cosmos_predict2_tpu_torch.text_encoders import clip_vision as tclip
from cosmos_predict2_tpu_torch.text_encoders import common as tcommon
from cosmos_predict2_tpu_torch.text_encoders import qwen_vision as tqv
from cosmos_predict2_tpu_torch.text_encoders import siglip_vision as tsig
from cosmos_predict2_tpu_torch.text_encoders import xlm_roberta as txlm
from cosmos_predict2_tpu_torch.utils import checkpoint_convert as tconv
from cosmos_predict2_tpu_torch.utils import convert as tconvert
from torch_variants_util import jit_init, noisy_params, rel_l2

ATOL = 2e-5
BF16_REL_L2 = 2e-3


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------- CLIP ----------------------------------

JCLIP = jclip.CLIPVisionConfig(image_size=28, patch_size=14, dim=16, num_heads=2, num_layers=3, dtype=jnp.float32)
TCLIP = tclip.CLIPVisionConfig(image_size=28, patch_size=14, dim=16, num_heads=2, num_layers=3, dtype=torch.float32)


def _clip_pair():
    pixels = jnp.zeros((1, 28, 28, 3))
    params = noisy_params(jit_init(jclip.CLIPVisionTower(JCLIP).init, jax.random.PRNGKey(0), pixels))
    tower = tclip.CLIPVisionTower(TCLIP)
    tower.load_state_dict(tconvert.jax_clip_vision_params_to_torch(params), strict=True)
    return _jnp(params), tower.eval()


def _bf16_check(got: torch.Tensor, want16, want32) -> None:
    """A bf16 output against JAX's bf16 within BF16_REL_L2, a bound under a
    third of JAX's own bf16-vs-fp32 gap, so a missing or extra rounding shows."""
    assert got.dtype == torch.bfloat16 or want16.dtype != jnp.bfloat16
    want16, want32 = np.asarray(want16.astype(jnp.float32)), np.asarray(want32)
    assert rel_l2(got.float().numpy(), want16) <= BF16_REL_L2 < rel_l2(want16, want32) / 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_tower_matches_jax(dtype):
    """The 31-of-32-block tower; in bf16 as build_clip_vision stores it."""
    params, tower = _clip_pair()
    assert len(tower.transformer) == 2  # use_31_block: the last block never runs
    pixels = np.random.default_rng(1).uniform(-2, 2, (2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jclip.CLIPVisionTower(JCLIP).apply(params, jnp.asarray(pixels)))
    if dtype == "bfloat16":
        tower16 = tclip.build_clip_vision(dataclasses.replace(TCLIP, dtype=torch.bfloat16), "cpu", seed=None)
        tower16.load_state_dict(tower.state_dict(), strict=True)
        assert tower16.patch_embedding.weight.dtype == tower16.transformer[0].mlp[0].weight.dtype == torch.bfloat16
        jtower16 = jclip.CLIPVisionTower(dataclasses.replace(JCLIP, dtype=jnp.bfloat16))
        want16 = jtower16.apply(params, jnp.asarray(pixels))
        with torch.no_grad():
            _bf16_check(tower16(torch.from_numpy(pixels)), want16, want)
        return
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (2, 5, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["silu", "gelu", "gelu_tanh"])
def test_activations_match_jax_in_bf16(fn):
    """text_encoders/common.py's silu and gelu, op by op as XLA runs jax.nn's:
    bit-equal in bf16 but for subnormal outputs, within fp32 rounding in fp32."""
    x = np.random.default_rng(9).standard_normal(50000).astype(np.float32) * 4
    ours = {"silu": tcommon.silu, "gelu": lambda t: tcommon.gelu(t, approximate=False),
            "gelu_tanh": lambda t: tcommon.gelu(t, approximate=True)}[fn]
    theirs = {"silu": jax.nn.silu, "gelu": lambda t: jax.nn.gelu(t, approximate=False),
              "gelu_tanh": lambda t: jax.nn.gelu(t, approximate=True)}[fn]
    got = ours(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, np.asarray(theirs(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)),
                               atol=1e-37, rtol=0)
    np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(), np.asarray(theirs(jnp.asarray(x))), atol=2e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("hw", [(50, 70), (20, 20), (28, 28), (28, 41)])
def test_preprocess_clip_matches_jax(hw):
    """JAX's bicubic resize (antialiased when it shrinks) and CLIP's normalisation."""
    frames = np.random.default_rng(2).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jclip.preprocess_clip(jnp.asarray(frames), 28))
    got = tclip.preprocess_clip(torch.from_numpy(frames), 28).numpy()
    assert got.shape == want.shape == (2, 28, 28, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_make_i2v_condition_with_the_tower_matches_jax():
    """The first pixel frame CLIP-encoded inside make_i2v_condition, the
    frame mask and the latents, against JAX's at tiny width."""
    params, tower = _clip_pair()
    rng = np.random.default_rng(3)
    video = rng.uniform(-1, 1, (2, 5, 32, 40, 3)).astype(np.float32)
    latents = rng.standard_normal((2, 16, 2, 4, 5)).astype(np.float32)
    text = rng.standard_normal((2, 8, 32)).astype(np.float32)
    want = jwv.make_i2v_condition(jnp.asarray(text), jnp.asarray(latents), jclip.CLIPVisionTower(JCLIP), params,
                                  jnp.asarray(video))
    got = twv.make_i2v_condition(torch.from_numpy(text), torch.from_numpy(latents), clip_tower=tower,
                                 video_pm1_B_T_H_W_C=torch.from_numpy(video))
    assert got.clip_emb.shape == want.clip_emb.shape == (2, 5, 16)
    np.testing.assert_allclose(got.clip_emb.numpy(), np.asarray(want.clip_emb), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.condition_video_mask.numpy(), np.asarray(want.condition_video_mask))
    np.testing.assert_array_equal(got.gt_frames.numpy(), latents)
    # the precomputed tokens take the same route
    same = twv.make_i2v_condition(torch.from_numpy(text), torch.from_numpy(latents), got.clip_emb)
    assert torch.equal(same.clip_emb, got.clip_emb) and torch.equal(same.condition_video_mask, got.condition_video_mask)


def test_clip_loader_reads_the_visual_entries():
    params, tower = _clip_pair()
    sd = {f"visual.{k}": v for k, v in tower.state_dict().items()}
    sd["textual.token_embedding.weight"] = torch.zeros(3, 4)
    other = tclip.CLIPVisionTower(TCLIP)
    tconv.load_reference_state_dict(other, tconv.pick_prefix(sd, tconv.TOWER_PREFIXES["clip_vision"]), "CLIP")
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(), tower.state_dict().values()))


# --------------------------------- SigLIP ---------------------------------

JSIG = jsig.SigLIPVisionConfig(image_size=28, patch_size=14, dim=64, mlp_dim=128, num_heads=2, num_layers=2,
                               dtype=jnp.float32)
TSIG = tsig.SigLIPVisionConfig(image_size=28, patch_size=14, dim=64, mlp_dim=128, num_heads=2, num_layers=2,
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def siglip_pair():
    params = noisy_params(jit_init(jsig.SigLIPVisionTower(JSIG).init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))))
    tower = tsig.SigLIPVisionTower(TSIG)
    tower.load_state_dict(tconvert.jax_siglip_params_to_torch(params, TSIG), strict=True)
    return _jnp(params), tower.eval()


def test_siglip_tower_matches_jax(siglip_pair):
    params, tower = siglip_pair
    pixels = np.random.default_rng(4).uniform(-1, 1, (3, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jsig.SigLIPVisionTower(JSIG).apply(params, jnp.asarray(pixels)))
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_preprocess_siglip_and_frame_embedder_match_jax(siglip_pair):
    params, tower = siglip_pair
    frames = np.random.default_rng(5).integers(0, 256, (3, 37, 45, 3), dtype=np.uint8)
    want = np.asarray(jsig.preprocess_siglip(frames, 28))
    got = tsig.preprocess_siglip(frames, 28, device="cpu").numpy()
    assert got.shape == want.shape == (3, 28, 28, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want_emb = jsig.make_frame_embedder(params, JSIG)(frames)
    got_emb = tsig.make_frame_embedder(tower)(frames)
    assert got_emb.shape == (3, 64) and got_emb.dtype == np.float32
    np.testing.assert_allclose(got_emb, want_emb, atol=ATOL, rtol=0)


def test_siglip_loader_reads_hf_keys(siglip_pair):
    _, tower = siglip_pair
    sd = {f"vision_model.{k}": v for k, v in tower.state_dict().items()}
    other = tsig.SigLIPVisionTower(TSIG)
    tconv.load_reference_state_dict(other, tconv.pick_prefix(sd, tconv.TOWER_PREFIXES["siglip_vision"]), "SigLIP")
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(), tower.state_dict().values()))


# ------------------------------ Qwen vision ------------------------------

GRID = np.array([[1, 8, 8], [2, 4, 8]])  # an image and a 4-frame clip


def test_window_index_round_trip_equals_jax():
    jcfg, tcfg = jqv.QwenVisionConfig.tiny(), tqv.QwenVisionConfig.tiny()
    grid = np.array([[1, 8, 8]])  # 4 x 4 merged cells, 2 x 2 windows of 2 x 2 cells
    window_index, seg_window, seg_full, patch_perm = tqv.get_window_index(tcfg, grid)
    assert sorted(window_index.tolist()) == list(range(16)) and sorted(patch_perm.tolist()) == list(range(64))
    assert (np.bincount(seg_window) == 16).all() and (seg_full == 0).all()
    for grid in (np.array([[1, 8, 8]]), GRID, np.array([[1, 6, 10]])):  # the last pads its windows
        for got, want in zip(tqv.get_window_index(tcfg, grid), jqv.get_window_index(jcfg, grid)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tqv.rot_pos_emb(tcfg, grid), jqv.rot_pos_emb(jcfg, grid))
    window_index = tqv.get_window_index(tcfg, GRID)[0]
    np.testing.assert_array_equal(window_index[np.argsort(window_index)], np.arange(len(window_index)))


def test_qwen_vision_tower_matches_jax():
    jcfg, tcfg = jqv.QwenVisionConfig.tiny(), tqv.QwenVisionConfig.tiny()
    S = int(np.prod(GRID, axis=1).sum())
    patches = np.random.default_rng(6).uniform(-1, 1, (S, tcfg.patch_dim)).astype(np.float32)
    jtower = jqv.QwenVisionTower(jcfg)
    angles = jqv.rot_pos_emb(jcfg, GRID)
    window_index, seg_window, seg_full, patch_perm = jqv.get_window_index(jcfg, GRID)
    inv = np.argsort(window_index)
    params = noisy_params(jit_init(jtower.init, jax.random.PRNGKey(0), jnp.asarray(patches), jnp.asarray(angles),
                                   jnp.asarray(seg_window), jnp.asarray(seg_full), jnp.asarray(patch_perm),
                                   jnp.asarray(inv)))
    want = np.asarray(jqv.encode_pixels(jtower, _jnp(params), patches, GRID))
    tower = tqv.QwenVisionTower(tcfg)
    tower.load_state_dict(tconvert.jax_qwen_vision_params_to_torch(params, tcfg), strict=True)
    got = tqv.encode_pixels(tower.eval(), patches, GRID).numpy()
    assert got.shape == want.shape == (S // 4, tcfg.out_hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    sd = {f"model.visual.{k}": v for k, v in tower.state_dict().items()}
    other = tqv.QwenVisionTower(tcfg)
    tconv.load_reference_state_dict(other, tconv.pick_prefix(sd, tconv.TOWER_PREFIXES["qwen_vision"]), "Qwen vision")
    np.testing.assert_array_equal(tqv.encode_pixels(other.eval(), patches, GRID).numpy(), got)


def test_patchify_matches_hf_processor():
    """Frames -> patches in HF's Qwen2-VL image processor's order (no resize
    or normalisation), as the vision tower's checkpoints were trained on."""
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import Qwen2VLImageProcessor

    frames = np.random.default_rng(7).uniform(-1, 1, (2, 3, 56, 84)).astype(np.float32)
    want, grid = Qwen2VLImageProcessor()._preprocess(
        list(frames), do_resize=False, do_rescale=False, do_normalize=False, do_convert_rgb=False,
        input_data_format="channels_first", data_format="channels_first", patch_size=14, temporal_patch_size=2,
        merge_size=2, resample=None, rescale_factor=1.0, image_mean=None, image_std=None)
    got, got_grid = tqv.patchify(torch.from_numpy(frames), tqv.QwenVisionConfig())
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got_grid[0]) == tuple(grid) == (1, 4, 6)


# --------------------------------- XLM-R ---------------------------------


@pytest.mark.parametrize("with_head", [False, True])
def test_xlm_roberta_matches_jax(with_head):
    jcfg, tcfg = jxlm.XLMRobertaConfig.tiny(), txlm.XLMRobertaConfig.tiny()
    ids = np.random.default_rng(8).integers(2, 64, (2, 10)).astype(np.int32)
    ids[0, 7:] = jcfg.pad_id  # right padding: positions from the non-pad cumulative sum
    ids[1, 4:6] = jcfg.pad_id
    jmod = (jxlm.XLMRobertaWithHead if with_head else jxlm.XLMRoberta)(jcfg)
    params = noisy_params(jit_init(jmod.init, jax.random.PRNGKey(0), jnp.asarray(ids)))
    want = np.asarray(jmod.apply(_jnp(params), jnp.asarray(ids)))
    model = (txlm.XLMRobertaWithHead if with_head else txlm.XLMRoberta)(tcfg)
    model.load_state_dict(tconvert.jax_xlm_roberta_params_to_torch(params), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == ((2, 16) if with_head else (2, 10, 32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    other = (txlm.XLMRobertaWithHead if with_head else txlm.XLMRoberta)(tcfg)
    sd = {f"textual.{k}": v for k, v in model.state_dict().items()}
    tconv.load_reference_state_dict(other, tconv.pick_prefix(sd, tconv.TOWER_PREFIXES["xlm_roberta"]), "XLM-R")
    with torch.no_grad():
        np.testing.assert_array_equal(other.eval()(torch.from_numpy(ids).long()).numpy(), got)
    # bf16, as build_xlm_roberta stores it, against JAX's bf16
    model16 = txlm.build_xlm_roberta(dataclasses.replace(tcfg, dtype=torch.bfloat16), "cpu", seed=None,
                                     with_head=with_head)
    model16.load_state_dict(model.state_dict(), strict=True)
    want16 = (jxlm.XLMRobertaWithHead if with_head else jxlm.XLMRoberta)(dataclasses.replace(jcfg, dtype=jnp.bfloat16))
    with torch.no_grad():
        _bf16_check(model16(torch.from_numpy(ids).long()), want16.apply(_jnp(params), jnp.asarray(ids)), want)
