"""The port's other serving modes held against the JAX package (CPU, fp32):
autoregressive long video, Text2Image and the one-shot VAE route, plus the
API's and the CLI's routing to them.

One pair of pipelines is shared by the module: JAX's Video2WorldInference
and the port's on the same seeded weights (a 2-block 128-channel DiT, the
dim-16 VAE, 32x32 frames, 5-frame clips). Tolerances, as
tests/test_torch_pipeline.py's whole-slice parity: fp32 on both sides
agrees to ~2e-5 on [-1, 1] pixels per clip, checked at 2e-3 max-abs;
uint8 frames may differ by one level where a value sits on a rounding
boundary, so a written-back uint8 conditioning frame may too. The one-shot
VAE against JAX's ``WanVAE.encode`` / ``decode`` and against the port's
streaming route: ~2e-6 (fp32), checked at 1e-4; the one-shot pipeline's
bf16 roundings are set out at its test.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # torch's CPU threads under xdist

from cosmos_predict2_tpu.inference.pipeline import Text2ImageInference as JText2Image
from cosmos_predict2_tpu.inference.pipeline import Video2WorldInference as JPipe
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAEConfig as JVAEConfig
from cosmos_predict2_tpu_torch.inference import pipeline as tpipe
from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming
from torch_variants_util import CTX_IN, SIZE, tiny_serving_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    """(JAX setup, JAX params, JAX VAE params, the port's setup, net, VAE)."""
    return tiny_serving_setup()


@pytest.fixture(scope="module")
def pipes(built):
    jsetup, params, vae_params, setup, net, vae = built
    return JPipe(jsetup, params, vae_params), tpipe.Video2WorldInference(setup, net, vae)


def _emb(seed):
    return np.random.default_rng(seed).standard_normal((1, 8, CTX_IN)).astype(np.float32)


def _record_windows(pipe):
    """Wrap ``pipe.generate_vid2world`` to keep a copy of every window it
    is given (the uint8 buffer as each chunk saw it), its k and seed, and
    the frames it returned."""
    seen, inner = [], pipe.generate_vid2world

    def spy(window, *a, **kw):
        frames = inner(window, *a, **kw)
        seen.append((np.array(window), kw["num_conditional_frames"], kw["seed"], np.array(frames)))
        return frames

    pipe.generate_vid2world = spy
    return seen


# --------------------------- autoregressive ---------------------------


@pytest.mark.parametrize("chunk_size,chunk_overlap,num_output_frames,k,pixel_format",
                         [(5, 1, 13, 1, "float"), (9, 2, 13, 2, "uint8")])
def test_autoregressive_matches_jax(pipes, chunk_size, chunk_overlap, num_output_frames, k, pixel_format):
    """Three chunks, then two: the windows each chunk was given, the frames of
    every chunk and the long video. Chunk i draws seed + i and is
    conditioned on k, then chunk_overlap latent frames; its window starts
    on the previous chunk's last (chunk_overlap - 1) * 4 + 1 frames as
    written back to the uint8 buffer. A written-back frame may differ from
    JAX's by one level (1/127.5 in the next chunk's input); each chunk is
    therefore also held against JAX's pipeline on the port's own window."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(chunk_size)
    video = rng.integers(0, 256, (1, 3, chunk_size, SIZE, SIZE), dtype=np.uint8)
    emb = _emb(chunk_size)
    jwin, twin = _record_windows(jpipe), _record_windows(pipe)
    try:
        want = jpipe.generate_autoregressive(video, jnp.asarray(emb), num_output_frames, chunk_size=chunk_size,
                                             chunk_overlap=chunk_overlap, num_conditional_frames=k, num_steps=2,
                                             seed=4, pixel_format=pixel_format)
        got = pipe.generate_autoregressive(video, emb, num_output_frames, chunk_size=chunk_size,
                                           chunk_overlap=chunk_overlap, num_conditional_frames=k, num_steps=2,
                                           seed=4, pixel_format=pixel_format)
    finally:
        del jpipe.generate_vid2world, pipe.generate_vid2world
    assert got.shape == want.shape == (num_output_frames, SIZE, SIZE, 3) and got.dtype == want.dtype
    overlap_px = (chunk_overlap - 1) * 4 + 1
    stride = chunk_size - overlap_px
    n = 1 + -(-(num_output_frames - chunk_size) // stride)
    assert len(twin) == len(jwin) == n >= 2
    assert [(w.shape, kk, s) for w, kk, s, _ in twin] == [(w.shape, kk, s) for w, kk, s, _ in jwin]
    assert [kk for _, kk, _, _ in twin] == [k] + [chunk_overlap] * (n - 1)
    assert [s for _, _, s, _ in twin] == list(range(4, 4 + n))
    quantize = tpipe.Video2WorldInference._quantize
    for i, ((window, kk, seed, frames), (jwindow, *_)) in enumerate(zip(twin, jwin)):
        assert np.abs(window.astype(np.int16) - jwindow.astype(np.int16)).max() <= 1, f"window {i}"
        if i:  # starts on the previous chunk's last frames, as written back
            np.testing.assert_array_equal(window[0, :, :overlap_px].transpose(1, 2, 3, 0),
                                          quantize(twin[i - 1][3][stride:]))
        ref = jpipe.generate_vid2world(window, jnp.asarray(emb), num_steps=2, num_conditional_frames=kk, seed=seed,
                                       pixel_format=pixel_format)
        if pixel_format == "uint8":
            assert np.abs(frames.astype(np.int16) - ref.astype(np.int16)).max() <= 1, f"chunk {i}"
        else:
            assert np.abs(frames - ref).max() <= 2e-3, f"chunk {i}"
    # the long video: chunk 0 whole, then each chunk's frames past the overlap
    np.testing.assert_array_equal(got, np.concatenate([twin[0][3]] + [f[overlap_px:] for *_, f in twin[1:]])[:num_output_frames])
    if pixel_format == "uint8":
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    else:
        assert np.abs(got[:chunk_size] - want[:chunk_size]).max() <= 2e-3


# ------------------------------ Text2Image ------------------------------


def test_text2image_matches_jax(built):
    jsetup, params, vae_params, setup, net, vae = built
    jt2i, t2i = JText2Image(jsetup, params, vae_params), tpipe.Text2ImageInference(setup, net, vae)
    emb = _emb(30)
    want = jt2i.generate_image(jnp.asarray(emb), num_steps=2, seed=3)
    got = t2i.generate_image(emb, num_steps=2, seed=3)
    assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert t2i._v2w.setup.model_config.state_t == 1 and t2i._v2w.num_video_frames == 1


def test_image_buckets_match_jax():
    from cosmos_predict2_tpu.utils import io as jio
    from cosmos_predict2_tpu_torch.utils import io as tio

    assert tio.IMAGE_RES_SIZE_INFO == jio.IMAGE_RES_SIZE_INFO
    assert tio.get_image_resolution("720", "16,9") == (1280, 720)
    setup = tpipe.InferenceSetup(model_config=RFModelConfig(), resolution="720")
    with torch.device("meta"):
        t2i = tpipe.Text2ImageInference(setup, MiniTrainDIT(DiTConfig(num_blocks=1)), WanVAE(WanVAEConfig(dim=16)))
    assert t2i.image_size() == (720, 1280)


def test_gif_export_is_the_jax_packages_file(tmp_path):
    """Where no video codec is installed, a clip is written as a GIF: the
    port quantizes its frames on several threads and writes the same bytes
    as the JAX package's writer on the same frames."""
    from cosmos_predict2_tpu.utils import io as jio
    from cosmos_predict2_tpu_torch.utils import io as tio

    frames = np.random.default_rng(4).uniform(-1, 1, (5, 24, 40, 3)).astype(np.float32)
    got = tio.save_img_or_video(frames, str(tmp_path / "port.gif"))
    want = jio.save_img_or_video(frames, str(tmp_path / "jax.gif"))
    assert got.endswith(".gif") and open(got, "rb").read() == open(want, "rb").read()


# ------------------------------ one-shot VAE ------------------------------


def test_oneshot_vae_matches_jax_and_the_streaming_route(built):
    """Whole-clip encode and decode (a batch of 2, 9 frames, and one frame)
    against JAX's WanVAE.encode / decode and the port's streaming route."""
    _, _, vae_params, _, _, vae = built
    jv = JVAE(JVAEConfig(dim=16, dtype=jnp.float32))
    x = np.random.default_rng(5).uniform(-1, 1, (2, 9, SIZE, SIZE, 3)).astype(np.float32)
    zj = np.asarray(jv.apply(vae_params, jnp.asarray(x), method=JVAE.encode))
    pj = np.asarray(jv.apply(vae_params, jnp.asarray(zj), method=JVAE.decode))
    z, px = vae.encode(torch.from_numpy(x)), vae.decode(torch.from_numpy(zj))
    assert z.shape == zj.shape and np.abs(z.numpy() - zj).max() <= 1e-4
    assert px.shape == pj.shape == x.shape and np.abs(px.numpy() - pj).max() <= 1e-4
    for clip in (x, x[:1, :1]):  # the port's streaming route, and one frame
        z = vae.encode(torch.from_numpy(clip))
        assert np.abs(z.numpy() - encode_streaming(vae, torch.from_numpy(clip)).numpy()).max() <= 1e-4
        assert np.abs(vae.decode(z).numpy() - decode_streaming(vae, z).numpy()).max() <= 1e-4
    u8 = np.random.default_rng(6).integers(0, 256, (1, 5, SIZE, SIZE, 3), dtype=np.uint8)
    np.testing.assert_array_equal(vae.encode(torch.from_numpy(u8), pixel_format="uint8").numpy(),
                                  vae.encode(torch.from_numpy(u8).float() / 127.5 - 1.0).numpy())
    assert vae.decode(z, pixel_format="uint8").dtype == torch.uint8
    with pytest.raises(ValueError, match="1 \\+ 4k"):
        vae.encode(torch.zeros((1, 4, SIZE, SIZE, 3)))


def test_oneshot_vae_bf16_gap_on_cpu():
    """The full-width Wan2.1 VAE in bf16, one-shot against streaming on the
    same weights (17 frames at 64x64): the CPU gap that chip_smoke.py's
    one-shot bounds are 3x of (ONESHOT_LATENT_REL_L2, ONESHOT_FRAME_REL_L2);
    measured 6.7e-3 on the latents and 1.46e-2 on the frames."""
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_oneshot, encode_oneshot

    vae = build_vae(WanVAEConfig(), "cpu", seed=1)
    assert vae.config.dim == 96 and vae.config.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 17, 64, 64, 3), dtype=np.uint8))
    zs, zo = encode_streaming(vae, x, pixel_format="uint8"), encode_oneshot(vae, x, pixel_format="uint8")
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())  # noqa: E731
    latents, frames = rel(zo, zs), rel(decode_oneshot(vae, zs), decode_streaming(vae, zs, chunk_latent_frames=2))
    assert 0 < latents <= 2e-2 / 3 + 1e-4 and 0 < frames <= 4.5e-2 / 3 + 1e-4, (latents, frames)


@pytest.mark.parametrize("k", [0, 2])
def test_oneshot_pipeline_matches_jax_and_the_streaming_route(built, k):
    """``streaming_vae=False`` against JAX's default one-shot pipeline and
    against the port's streaming route, same weights and noise. The one-shot
    route, as JAX's, normalizes the clip and takes the samples in bf16
    whatever the VAE's dtype, so a sample near a bf16 rounding boundary may
    round one ulp apart between two fp32 runs that agree to ~1e-5, and the
    decoder spreads it: measured against JAX 7.4e-3 max-abs and 1.9e-3
    relative L2, against the fp32 streaming route (which does not round)
    1.7e-2 and 7.1e-3; checked at about 3x."""
    jsetup, params, vae_params, setup, net, vae = built
    jpipe = JPipe(dataclasses.replace(jsetup, streaming_vae=False), params, vae_params)
    oneshot = tpipe.Video2WorldInference(dataclasses.replace(setup, streaming_vae=False), net, vae)
    streaming = tpipe.Video2WorldInference(setup, net, vae)
    video = np.random.default_rng(7 + k).integers(0, 256, (1, 3, 5, SIZE, SIZE), dtype=np.uint8)
    emb = _emb(7 + k)
    want = jpipe.generate_vid2world(video, jnp.asarray(emb), num_steps=2, num_conditional_frames=k)
    got = oneshot.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=k)
    assert got.shape == want.shape == (5, SIZE, SIZE, 3)
    assert np.abs(got - want).max() <= 2.5e-2 and np.linalg.norm(got - want) / np.linalg.norm(want) <= 6e-3
    ref = streaming.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=k)
    assert np.abs(got - ref).max() <= 5e-2 and np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 2.1e-2


# ------------------------------- API and CLI -------------------------------


def test_api_routes_image_and_autoregressive_requests(pipes, tmp_path):
    from cosmos_predict2_tpu.inference.api import InferenceArguments as JArgs
    from cosmos_predict2_tpu_torch.configs.defaults import make_config

    # the JAX package's defaults, kept as they are: a 77-frame chunk is 20
    # latent frames, under the 2B model's state_t of 24
    defaults = InferenceArguments()
    assert (defaults.num_output_frames, defaults.chunk_size, defaults.chunk_overlap) == (77, 77, 1)
    jd = JArgs()
    assert (jd.num_output_frames, jd.chunk_size, jd.chunk_overlap) == (77, 77, 1)
    assert 1 + (defaults.chunk_size - 1) // 4 == 20 and make_config().model.state_t == 24

    _, pipe = pipes
    emb = _emb(40)
    np.save(tmp_path / "emb.npy", emb)
    api = Inference(pipe, output_dir=str(tmp_path / "out"), keep_going=False)
    base = InferenceArguments(name="img", prompt="p", num_steps=1, text_embedding_path=str(tmp_path / "emb.npy"))
    (png,) = api.generate([dataclasses.replace(base, mode="image")])
    assert png == str(tmp_path / "out" / "img.png")
    from PIL import Image

    assert np.asarray(Image.open(png)).shape == (SIZE, SIZE, 3)

    calls, inner = [], pipe.generate_autoregressive
    pipe.generate_autoregressive = lambda *a, **kw: calls.append(kw) or inner(*a, **kw)
    batched = pipe.generate_vid2world_batch
    pipe.generate_vid2world_batch = lambda *a, **kw: pytest.fail("an image or autoregressive batch went batched")
    try:
        ar = dataclasses.replace(base, name="ar", enable_autoregressive=True, chunk_size=5, num_output_frames=9)
        (path,) = api.generate([ar])
        assert calls[-1]["chunk_size"] == 5 and calls[-1]["num_output_frames"] == 9
        assert calls[-1]["pixel_format"] == "uint8" and calls[-1]["num_conditional_frames"] == 0
        assert os.path.exists(path)
        # default chunk_size: 77 reaches the pipeline as it is
        api.pipe.generate_autoregressive = lambda *a, **kw: calls.append(kw) or np.zeros((2, SIZE, SIZE, 3), np.uint8)
        api.generate([dataclasses.replace(base, name="ar77", enable_autoregressive=True)])
        assert (calls[-1]["chunk_size"], calls[-1]["chunk_overlap"], calls[-1]["num_output_frames"]) == (77, 1, 77)
        out = api.generate_batch([dataclasses.replace(base, name=f"i{i}", mode="image", seed=i) for i in (1, 2)])
        assert sorted(out) == ["i1", "i2"]
        out = api.generate_batch([dataclasses.replace(ar, name=f"a{i}", seed=i) for i in (1, 2)])
        assert sorted(out) == ["a1", "a2"]
    finally:
        pipe.generate_autoregressive, pipe.generate_vid2world_batch = inner, batched
    assert Inference.batch_key(dataclasses.replace(base, mode="image")) != Inference.batch_key(base)
    assert Inference.batch_key(ar) != Inference.batch_key(base)


def _cli_smoke(out_dir, *extra):
    env = torch_cpu_threads.subprocess_env(COSMOS_SMOKE="1")
    cmd = [sys.executable, "-m", "cosmos_predict2_tpu_torch.inference.cli", "--experiment=error-free_mock_data_smoke",
           "--prompt", "a robot", "--output-dir", str(out_dir), "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out.startswith(str(out_dir)) and os.path.exists(out)
    return out


def test_cli_text2image_one_shot_on_cpu(tmp_path):
    """``--mode text2image`` on the one-shot VAE route: one 192x320 png."""
    from PIL import Image

    out = _cli_smoke(tmp_path, "--mode", "text2image", "--no-vae-streaming")
    assert out == str(tmp_path / "sample.png") and np.asarray(Image.open(out)).shape == (192, 320, 3)


def test_cli_autoregressive_on_cpu(tmp_path):
    """``--autoregressive``: two 13-frame chunks sharing 2 latent frames (5
    pixel frames) give 21 frames."""
    from cosmos_predict2_tpu_torch.utils.io import read_video

    out = _cli_smoke(tmp_path, "--autoregressive", "--chunk-size", "13", "--chunk-overlap", "2",
                     "--num-output-frames", "21")
    assert read_video(out)[0].shape == (21, 192, 320, 3)
