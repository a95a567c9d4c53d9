"""The port's conditioning, UniPC sampler, model and whole Video2World slice
held against the JAX package (CPU, fp32), plus the port's API and CLI.

Tolerances: the UniPC tables are computed by the same float64 NumPy code
and must be bit-equal; the sampler loop on a toy velocity agrees to fp32
rounding (1e-6); the whole slice (streaming VAE encode, 2 UniPC steps with
batched CFG through a 2-block DiT, streaming decode) agrees to ~2e-5 on
[-1, 1] pixels, checked at 2e-3 max-abs; uint8 outputs may differ by one
level where a value sits on a rounding boundary. The distilled dmd2 slice
(2 to 4 TrigFlow steps, no CFG) agrees to <= 2.4e-5, checked at the same
2e-3.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.inference.pipeline import InferenceSetup as JSetup
from cosmos_predict2_tpu.inference.pipeline import Video2WorldInference as JPipe
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
from cosmos_predict2_tpu.networks.dit import DiTConfig as JDiTConfig
from cosmos_predict2_tpu.schedulers import unipc as junipc
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAEConfig as JVAEConfig
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.inference import pipeline as tpipe
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT
from cosmos_predict2_tpu_torch.networks.dit import block_layout as tdit_block_layout
from cosmos_predict2_tpu_torch.schedulers import unipc as tunipc
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_vae_params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
CTX_IN = 48


# ------------------------------ conditioning ------------------------------


@pytest.mark.parametrize("k", [0, 1, 2])
def test_condition_masks_match_jax(k):
    gt = np.random.default_rng(k).standard_normal((2, 16, 4, 2, 2)).astype(np.float32)
    emb = np.ones((2, 3, 8), np.float32)
    jc, ju = jcond.get_condition_uncondition(jcond.make_condition(jnp.asarray(emb)).replace(gt_frames=jnp.asarray(gt)))
    tc, tu = tcond.get_condition_uncondition(tcond.make_condition(torch.from_numpy(emb)).replace(gt_frames=torch.from_numpy(gt)))
    for (j, t, cfg_cond) in ((jc, tc, True), (ju, tu, False)):
        j, t = j.edit_for_inference(cfg_cond, k), t.edit_for_inference(cfg_cond, k)
        np.testing.assert_array_equal(t.condition_video_mask.numpy(), np.asarray(j.condition_video_mask))
        np.testing.assert_array_equal(t.crossattn_emb.numpy(), np.asarray(j.crossattn_emb))
        assert bool(t.use_video_condition) == bool(j.use_video_condition)


# --------------------------------- UniPC ---------------------------------


@pytest.mark.parametrize("num_steps,shift,karras", [(35, 5.0, False), (2, 5.0, False), (7, 3.0, False), (10, 5.0, True)])
def test_unipc_tables_equal_jax(num_steps, shift, karras):
    j = junipc.set_timesteps(num_steps, shift=shift, use_karras_sigma=karras)
    t = tunipc.set_timesteps(num_steps, shift=shift, use_karras_sigma=karras)
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name), np.asarray(getattr(j, f.name)), err_msg=f.name)


def test_unipc_sample_loop_matches_jax():
    """The host loop over steps == the reference's scan, on a toy velocity."""
    coeffs_j, coeffs_t = junipc.set_timesteps(6, shift=5.0), tunipc.set_timesteps(6, shift=5.0)
    x0 = np.random.default_rng(0).standard_normal((1, 4, 3, 2, 2)).astype(np.float32)
    a = np.linspace(-0.5, 0.5, 4, dtype=np.float32).reshape(1, 4, 1, 1, 1)
    want = junipc.sample(lambda x, t: x * a + t * 1e-3, jnp.asarray(x0), coeffs_j)
    got = tunipc.sample(lambda x, t: x * torch.from_numpy(a) + t * 1e-3, torch.from_numpy(x0), coeffs_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------ the whole slice ------------------------------


def _pipelines(size: tuple[int, int], **net_over):
    """JAX Video2WorldInference(streaming_vae=True) and the port's pipeline
    on the same (seeded) weights, converted with utils/convert.py."""
    jnet = JDiTConfig(model_channels=128, num_heads=2, num_blocks=2, adaln_lora_dim=16, crossattn_emb_channels=64,
                      use_crossattn_projection=True, crossattn_proj_in_channels=CTX_IN, rope_h_extrapolation_ratio=3.0,
                      rope_w_extrapolation_ratio=3.0, rope_enable_fps_modulation=False, dtype=jnp.float32, remat="none",
                      **net_over)
    jsetup = JSetup(model_config=JRFConfig(net=jnet, state_t=2, sampling_num_steps=2),
                    vae_config=JVAEConfig(dim=16, dtype=jnp.float32), text_len=8, size_override=size,
                    streaming_vae=True)
    params = JModel(jsetup.model_config).init_params(jax.random.PRNGKey(0), (1, 16, 2, 4, 4), text_len=8)
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree.unflatten(tdef, [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves])
    vae_params = JVAE(jsetup.vae_config).init(jax.random.PRNGKey(1), jnp.zeros((1, 5, SIZE, SIZE, 3)))
    jpipe = JPipe(jsetup, jax.tree.map(jnp.asarray, params), vae_params)

    names = {f.name for f in dataclasses.fields(DiTConfig)} - {"dtype"}
    tnet_cfg = DiTConfig(dtype=torch.float32, **{n: getattr(jnet, n) for n in names})
    net = MiniTrainDIT(tnet_cfg)
    net.load_state_dict(jax_dit_params_to_torch(params, tnet_cfg), strict=True)
    vae = WanVAE(WanVAEConfig(dim=16, dtype=torch.float32))
    vae.load_state_dict(jax_vae_params_to_torch(jax.tree.map(np.asarray, vae_params)), strict=True)
    setup = tpipe.InferenceSetup(model_config=RFModelConfig(net=tnet_cfg, state_t=2, sampling_num_steps=2),
                                 vae_config=vae.config, size_override=size)
    return jpipe, tpipe.Video2WorldInference(setup, net, vae)


@pytest.fixture(scope="module")
def pipes():
    return _pipelines((SIZE, SIZE))


def _request(seed):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (1, 3, 5, SIZE, SIZE), dtype=np.uint8)
    return video, rng.standard_normal((1, 8, CTX_IN)).astype(np.float32)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("pixel_format", ["float", "uint8"])
def test_slice_matches_jax_pipeline(pipes, k, pixel_format):
    """Text2World (k=0), Image2World (1), Video2World (2): same weights, same
    noise, 2 steps, through both packages' Video2WorldInference."""
    jpipe, pipe = pipes
    video, emb = _request(k)
    want = jpipe.generate_vid2world(video, jnp.asarray(emb), num_steps=2, num_conditional_frames=k,
                                    pixel_format=pixel_format)
    got = pipe.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=k, pixel_format=pixel_format)
    assert got.shape == want.shape == (5, SIZE, SIZE, 3) and got.dtype == want.dtype
    if pixel_format == "uint8":
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    else:
        assert np.abs(got - want).max() <= 2e-3
    assert set(pipe.last_timings) == {"vae_encode_s", "denoise_s", "denoise_step_s", "vae_decode_s"}


def test_batched_slice_with_negative_prompt_matches_jax(pipes):
    jpipe, pipe = pipes
    video, emb = _request(5)
    videos, embs = np.concatenate([video, video[:, :, ::-1]]), np.concatenate([emb, -emb])
    neg = np.full_like(embs, 0.1)
    want = jpipe.generate_vid2world_batch(videos, jnp.asarray(embs), neg_text_emb=jnp.asarray(neg), num_steps=2,
                                          num_conditional_frames=1, seeds=[3, 4])
    got = pipe.generate_vid2world_batch(videos, embs, neg_text_emb=neg, num_steps=2, num_conditional_frames=1,
                                        seeds=[3, 4])
    assert got.shape == want.shape == (2, 5, SIZE, SIZE, 3)
    assert np.abs(got - want).max() <= 2e-3


def test_sparse_slice_matches_jax_pipeline():
    """Video2World through a DiT with one sparse block (window 3 x 3 and
    stride 2 along W on the 4 x 6 token grid of 64 x 96 frames): both
    packages' pipelines, same weights and noise, 2 steps; tolerance as above."""
    jpipe, pipe = _pipelines((64, 96), n_dense_blocks=1, natten_window=(-1, 3, 3), natten_stride=(1, 1, 2))
    assert [p is not None for p in tdit_block_layout(pipe.net.cfg)] == [True, False]
    rng = np.random.default_rng(11)
    video = rng.integers(0, 256, (1, 3, 5, 64, 96), dtype=np.uint8)
    emb = rng.standard_normal((1, 8, CTX_IN)).astype(np.float32)
    want = jpipe.generate_vid2world(video, jnp.asarray(emb), num_steps=2, num_conditional_frames=2)
    got = pipe.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=2)
    assert got.shape == want.shape == (5, 64, 96, 3)
    assert np.abs(got - want).max() <= 2e-3


@pytest.mark.parametrize("k,num_steps", [(1, 4), (2, 9), (0, 2)])
def test_dmd2_slice_matches_jax_pipeline(pipes, k, num_steps):
    """The distilled path (JAX ``_run_dmd2``): the same student weights and
    noise, min(num_steps, 4) TrigFlow steps without CFG, streaming VAE
    encode and decode; tolerance as the UniPC slice's."""
    jpipe, pipe = pipes
    video, emb = _request(20 + k)
    want = jpipe.generate_vid2world(video, jnp.asarray(emb), num_steps=num_steps, num_conditional_frames=k,
                                    sampler="dmd2")
    got = pipe.generate_vid2world(video, emb, num_steps=num_steps, num_conditional_frames=k, sampler="dmd2")
    assert got.shape == want.shape == (5, SIZE, SIZE, 3)
    assert np.abs(got - want).max() <= 2e-3
    assert pipe.last_timings["denoise_step_s"] == pytest.approx(pipe.last_timings["denoise_s"] / min(num_steps, 4))


def test_input_prep_matches_jax(tmp_path):
    """Image -> frame 0 of a zero clip; video -> last 4(k-1)+1 frames padded
    with the last; files already at the target size pass unchanged."""
    from PIL import Image

    from cosmos_predict2_tpu.inference import pipeline as jp

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    frames = rng.integers(0, 256, (7, SIZE, SIZE, 3), dtype=np.uint8)
    np.save(tmp_path / "in.npy", frames)
    np.testing.assert_array_equal(tpipe.read_and_process_image(str(tmp_path / "in.png"), SIZE, SIZE, 9),
                                  jp.read_and_process_image(str(tmp_path / "in.png"), SIZE, SIZE, 9))
    for k in (1, 2):
        np.testing.assert_array_equal(tpipe.read_and_process_video(str(tmp_path / "in.npy"), SIZE, SIZE, 9, k),
                                      jp.read_and_process_video(str(tmp_path / "in.npy"), SIZE, SIZE, 9, k))
    np.testing.assert_array_equal(tpipe.image_to_input(img, 9), jp.read_and_process_image(str(tmp_path / "in.png"), SIZE, SIZE, 9))
    assert tpipe.resize_input(frames[:, :16, :], SIZE, SIZE).shape == (7, SIZE, SIZE, 3)


# ------------------------------- API and CLI -------------------------------


def test_inference_api_writes_samples(pipes, tmp_path):
    from PIL import Image

    from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments

    _, pipe = pipes
    video, emb = _request(9)
    np.save(tmp_path / "emb.npy", emb)
    Image.fromarray(video[0, :, 0].transpose(1, 2, 0)).save(tmp_path / "img.png")
    api = Inference(pipe, output_dir=str(tmp_path / "out"), keep_going=False)
    args = [InferenceArguments(name=f"s{i}", prompt="p", input_path=inp, num_steps=1, seed=i,
                               text_embedding_path=str(tmp_path / "emb.npy"))
            for i, inp in enumerate([None, str(tmp_path / "img.png")])]
    outputs = api.generate(args)
    assert len(outputs) == 2 and all(os.path.exists(p) for p in outputs)
    batch = api.generate_batch([dataclasses.replace(args[0], name="b0"), dataclasses.replace(args[0], name="b1", seed=7)])
    assert sorted(batch) == ["b0", "b1"] and all(os.path.exists(p) for p in batch.values())
    # the distilled sampler serves too: one request at a time, never through the batched UniPC pass
    (dmd2,) = api.generate([dataclasses.replace(args[1], name="d0", sampler="dmd2", num_steps=4)])
    assert os.path.exists(dmd2)
    batched = pipe.generate_vid2world_batch
    pipe.generate_vid2world_batch = lambda *a, **k: pytest.fail("a dmd2 batch went through the UniPC pass")
    try:
        pair = api.generate_batch([dataclasses.replace(args[0], name=f"d{i}", sampler="dmd2", seed=i) for i in (1, 2)])
    finally:
        pipe.generate_vid2world_batch = batched
    assert sorted(pair) == ["d1", "d2"] and all(os.path.exists(p) for p in pair.values())
    with pytest.raises(NotImplementedError):
        api.generate([dataclasses.replace(args[0], enable_autoregressive=True)])


def _cli_smoke(out_dir, *extra):
    env = dict(os.environ, COSMOS_SMOKE="1")
    cmd = [sys.executable, "-m", "cosmos_predict2_tpu_torch.inference.cli", "--experiment=error-free_mock_data_smoke",
           "--prompt", "a robot", "--output-dir", str(out_dir), "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out.startswith(str(out_dir)) and os.path.exists(out)


def test_cli_smoke_on_cpu(tmp_path):
    """The port's CLI end to end on the CPU: random weights, the plumbing
    config (1024-channel 2-block DiT, dim-16 VAE), COSMOS_SMOKE geometry."""
    _cli_smoke(tmp_path)


def test_cli_smoke_dmd2_on_cpu(tmp_path):
    """The same with ``--sampler dmd2``: the distilled path, 4 steps by default."""
    _cli_smoke(tmp_path, "--sampler", "dmd2")
