"""The port's auto-multiview variant held against the JAX package (CPU).

Tolerances: view packing and the grid are equal; the DiT forward with view
embeddings, per-view RoPE, per-view cross-attention and cross-view
attention (fp32, 2 blocks) and CrossViewAttention alone agree to relative
L2 <= 1e-5; the VAE encode view by view (streaming) against JAX's batched
one-shot encode to <= 1e-5; the sampled latents (2 UniPC steps, batched
CFG at guidance 2) to <= 5e-5 (torch_variants_util.REL_L2_SAMPLED says
why).

The JAX package's ``MultiviewInference`` conditions view 0 only (its
``generate`` rebuilds the mask as frames [0, k) of the packed axis); the
port conditions the first k frames of every view. The denoise is held
against JAX's ``velocity_fn_from_condition`` and ``unipc.sample`` driven
with the per-view condition, and a test shows the JAX path's mask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.inference import multiview as jinf
from cosmos_predict2_tpu.models import multiview as jmv
from cosmos_predict2_tpu.networks.dit import CrossViewAttention as JCrossView
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.schedulers import unipc as junipc
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.inference import multiview as tinf
from cosmos_predict2_tpu_torch.models import multiview as tmv
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.utils.checkpoint_convert import load_reference_state_dict
from torch_variants_util import (
    REL_L2, REL_L2_SAMPLED, jit_init, noisy_params, port_net, rel_l2, seeded_jax_params, tiny_jax_config, vae_pair,
)

RING = ((1, 2), (0, 2), (0, 1))  # three views, each attending the other two


def test_view_packing_and_grid_match_jax():
    rng = np.random.default_rng(0)
    views = [rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32) for _ in range(3)]
    packed = tmv.stack_views([torch.from_numpy(v) for v in views])
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jmv.stack_views([jnp.asarray(v) for v in views])))
    for got, want in zip(tmv.unstack_views(packed, 3), jmv.unstack_views(jnp.asarray(packed.numpy()), 3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n in (2, 5, 7):
        clips = [rng.integers(0, 256, (2, 4, 6, 3), dtype=np.uint8) for _ in range(n)]
        np.testing.assert_array_equal(tmv.view_grid(clips), jmv.view_grid(clips))
        np.testing.assert_array_equal(tmv.view_grid(clips, cols=3), jmv.view_grid(clips, cols=3))
    assert tinf.VIEW_NAMES == jinf.VIEW_NAMES
    args = tinf.MultiviewInferenceArguments(prompt="p", inference_type="video2world")
    assert dataclasses.asdict(args) == dataclasses.asdict(jinf.MultiviewInferenceArguments(prompt="p",
                                                                                            inference_type="video2world"))
    assert args.num_input_frames == 2


# the DiT fields of each case
MV_CASES = {
    "view embedding, per-view rope and cross-attention": dict(concat_view_embedding=True, view_condition_dim=4),
    "cross-view attention, no view embedding": dict(enable_cross_view_attn=True, cross_view_attn_map=RING),
    "cross-view attention and view embedding": dict(concat_view_embedding=True, view_condition_dim=4,
                                                    enable_cross_view_attn=True, cross_view_attn_map=RING),
}


@pytest.mark.parametrize("case", list(MV_CASES))
def test_dit_forward_multiview_matches_jax(case):
    fields = MV_CASES[case]
    V, Tv = 3, 2
    jcfg = tiny_jax_config(n_views=V, concat_condition_mask=True, tokens_per_view=4, rope_enable_fps_modulation=False,
                           **fields)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, V * Tv, 8, 8)).astype(np.float32)
    t = np.asarray([200.0, 700.0], np.float32)
    ctx = rng.standard_normal((2, V * 4, 64)).astype(np.float32)
    mask = np.zeros((2, 1, V * Tv, 8, 8), np.float32)
    mask[:, :, ::Tv] = 1.0
    params = seeded_jax_params(jcfg, x, t, ctx, condition_mask=mask)
    want = JDiT(jcfg).apply(params, x, t, ctx, condition_mask=mask)
    net = port_net(params, jcfg)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (x, t, ctx)), condition_mask=torch.from_numpy(mask))
        # view v's output depends on view v's caption: swapping two captions changes it
        swapped = ctx.copy()
        swapped[:, 0:4], swapped[:, 4:8] = ctx[:, 4:8], ctx[:, 0:4]
        moved = net(*map(torch.from_numpy, (x, t, swapped)), condition_mask=torch.from_numpy(mask))
    assert got.shape == x.shape
    assert rel_l2(got.numpy(), want) <= REL_L2
    assert rel_l2(moved.numpy(), want) > 1e-3
    if fields.get("enable_cross_view_attn"):
        # a reference checkpoint has no cross-view keys (JAX's converter maps
        # none): the loader names them
        sd = {k: v for k, v in net.state_dict().items() if "cross_view" not in k}
        with pytest.raises(KeyError, match="cross_view"):
            load_reference_state_dict(tdit.MiniTrainDIT(net.cfg), sd, "DiT")


def test_dit_multiview_caption_must_hold_tokens_per_view_per_view():
    """The caption is split into views by tokens_per_view: one of another
    length is refused, not spread evenly over the views."""
    jcfg = tiny_jax_config(n_views=3, concat_condition_mask=True, tokens_per_view=4, rope_enable_fps_modulation=False)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 16, 6, 8, 8)).astype(np.float32)
    t = np.asarray([300.0], np.float32)
    ctx = rng.standard_normal((1, 12, 64)).astype(np.float32)
    net = port_net(seeded_jax_params(jcfg, x, t, ctx), jcfg)
    with torch.no_grad():
        assert net(*map(torch.from_numpy, (x, t, ctx))).shape == x.shape
        for bad in (ctx[:, :6], np.concatenate([ctx, ctx[:, :3]], axis=1)):  # 3 views of 2 or of 5 tokens
            with pytest.raises(ValueError, match="tokens_per_view"):
                net(*map(torch.from_numpy, (x, t, bad)))


def _cross_view_pair(seed=0, Tv=2):
    """JAX's CrossViewAttention (head dim 16, a chain map) with its
    zero-initialised output projection and the port's module holding the
    same parameters; and the same pair with a random output projection."""
    chain = ((1,), (0, 2), (1,))
    jm = JCrossView(dim=32, n_heads=2, head_dim=16, attn_map=chain, dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((1, 3, Tv, 2, 2, 32)).astype(np.float32)
    params = jit_init(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def port(p):
        m = tdit.CrossViewAttention(32, 2, 16, chain, torch.float32)
        sd = {}
        for name, leaf in p["params"].items():
            key, value = (("weight", leaf["kernel"].T) if "kernel" in leaf else ("weight", leaf["weight"]))
            sd[f"{name}.{key}"] = torch.from_numpy(np.array(value))
        m.load_state_dict(sd, strict=True)
        return m

    noisy = noisy_params(params, seed=3)
    return jm, x, (params, port(params)), (noisy, port(noisy))


def test_cross_view_attention_matches_jax():
    jm, x, (p0, m0), (p1, m1) = _cross_view_pair()
    with torch.no_grad():
        # zero-initialised output projection: the path starts as an identity residual
        assert float(m0(torch.from_numpy(x)).abs().max()) == 0.0 == float(jnp.abs(jm.apply(p0, x)).max())
        got = m1(torch.from_numpy(x)).numpy()
        assert rel_l2(got, jm.apply(p1, x)) <= REL_L2
        # view 0 attends view 1 only: moving view 2 leaves it, moves view 1
        x2 = x.copy()
        x2[:, 2] += 1.0
        out2 = m1(torch.from_numpy(x2)).numpy()
        np.testing.assert_array_equal(out2[:, 0], got[:, 0])
        assert np.abs(out2[:, 1] - got[:, 1]).max() > 1e-5
        # tokens attend their own frame only: moving frame 1 leaves frame 0
        x3 = x.copy()
        x3[:, 1, 1] += 1.0
        out3 = m1(torch.from_numpy(x3)).numpy()
        np.testing.assert_array_equal(out3[:, :, 0], got[:, :, 0])
        assert np.abs(out3[:, 0, 1] - got[:, 0, 1]).max() > 1e-5


@pytest.fixture(scope="module")
def two_views():
    """A 2-view multiview model (2 latent frames per view, 32x32, 2 steps)
    in both packages on the same weights, the dim-16 VAE pair and a request."""
    net = tiny_jax_config(model_channels=128, adaln_lora_dim=8, crossattn_emb_channels=1024, tokens_per_view=8)
    jcfg = jmv.multiview_model_config(net, n_views=2, state_t=2, sampling_num_steps=2)
    jmodel = jmv.MultiviewVid2VidModel(jcfg)
    params = noisy_params(jit_init(jmodel.init_params, jax.random.PRNGKey(0), (1, 16, 4, 4, 4), text_len=16))
    tnet = port_net(params, jcfg.net)
    tmodel = tmv.MultiviewVid2VidModel(tmv.multiview_model_config(
        dataclasses.replace(tnet.cfg, n_views=1, concat_view_embedding=False, concat_condition_mask=False),
        n_views=2, state_t=2, sampling_num_steps=2), tnet)
    assert tmodel.config.net == tnet.cfg
    jvae_cfg, jvae_params, vae = vae_pair()
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((1, 8, 1024)).astype(np.float32) * 0.05
    videos = rng.integers(0, 256, (2, 5, 32, 32, 3), dtype=np.uint8)
    jpipe = jinf.MultiviewInference(jmodel, jax.tree.map(jnp.asarray, params), jvae_params, jvae_cfg,
                                    text_encoder=lambda p: jnp.asarray(emb), height=32, width=32)
    tpipe = tinf.MultiviewInference(tmodel, vae, text_encoder=lambda p: torch.from_numpy(emb), height=32, width=32)
    return jmodel, jax.tree.map(jnp.asarray, params), jpipe, tpipe, emb, videos


def _jax_per_view_denoise(jmodel, params, gt, emb, noise, k, guidance=2.0):
    """JAX's velocity function and sampler, driven with the per-view
    condition on both branches (the unconditional one keeping the video
    condition, as edit_for_inference does)."""
    cond = jmodel.set_multiview_condition(jcond.make_condition(emb), gt, k)
    cond, uncond = jcond.get_condition_uncondition(cond)
    uncond = uncond.replace(use_video_condition=jnp.asarray(True))
    vf = jmodel.velocity_fn_from_condition(params, cond, uncond, guidance, noise)
    return junipc.sample(vf, noise, junipc.set_timesteps(2, shift=5.0))


def test_multiview_inference_matches_jax_per_view_denoise(two_views):
    jmodel, params, jpipe, tpipe, emb, videos = two_views
    assert tpipe.frames_per_view == jpipe.frames_per_view == 5
    buf = np.zeros((2, 5, 32, 32, 3), np.uint8)
    buf[:, :1] = videos[:, :1]
    gt_t, seconds = tpipe.encode_views(buf)
    gt_j = jpipe._encode_views(buf)
    assert gt_t.shape == (1, 16, 4, 4, 4) and len(seconds) == 2
    assert rel_l2(gt_t.numpy(), gt_j) <= REL_L2
    text = np.tile(emb, (1, 2, 1))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(5), (1, 16, 4, 4, 4)))
    want = _jax_per_view_denoise(jmodel, params, gt_j, jnp.asarray(text), jnp.asarray(noise), 1)
    cond = tcond.make_condition(torch.from_numpy(text)).replace(gt_frames=gt_t)
    got = tpipe.model.generate(torch.from_numpy(noise), cond, guidance=2.0, num_steps=2, num_conditional_frames=1)
    assert rel_l2(got.numpy(), want) <= REL_L2_SAMPLED

    args = tinf.MultiviewInferenceArguments(prompt="driving", inference_type="image2world", n_views=2, num_steps=2,
                                            guidance=2.0)
    frames, grid = tpipe.generate(args, videos)
    assert frames.shape == (2, 5, 32, 32, 3) and frames.dtype == np.uint8 and grid.shape == (5, 32, 64, 3)
    # the request is that encode, the port's per-view denoise from the seeded noise and the decode
    from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand

    samples = tpipe.model.generate(arch_invariant_rand((1, 16, 4, 4, 4), seed=args.seed), cond, guidance=2.0,
                                   num_steps=2, num_conditional_frames=1)
    np.testing.assert_array_equal(frames, tpipe.decode_views(samples)[0])
    np.testing.assert_array_equal(grid, tmv.view_grid(list(frames)))
    assert set(tpipe.last_timings) == {"vae_encode_s", "denoise_s", "vae_decode_s"}


def test_jax_generate_conditions_view_0_only_and_the_port_every_view(two_views):
    """JAX's MultiviewInference sets the per-view mask, then its generate
    rebuilds it as frames [0, k) of the packed V Tv axis: view 1 is left
    unconditioned. The port keeps the mask of every view."""
    jmodel, params, _, tpipe, emb, _ = two_views
    rng = np.random.default_rng(6)
    gt = rng.standard_normal((1, 16, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 4, 4, 4)).astype(np.float32)
    text = np.tile(emb, (1, 2, 1))
    jc = jmodel.set_multiview_condition(jcond.make_condition(jnp.asarray(text)), jnp.asarray(gt), 1)
    np.testing.assert_array_equal(np.asarray(jc.condition_video_mask)[0, 0, :, 0, 0], [1, 0, 1, 0])
    edited = jc.edit_for_inference(True, 1)  # what Video2WorldModel.generate does with it
    np.testing.assert_array_equal(np.asarray(edited.condition_video_mask)[0, 0, :, 0, 0], [1, 0, 0, 0])
    tc = tpipe.model.set_multiview_condition(tcond.make_condition(torch.from_numpy(text)), torch.from_numpy(gt), 1)
    np.testing.assert_array_equal(tc.condition_video_mask[0, 0, :, 0, 0].numpy(), [1, 0, 1, 0])

    j_out = np.asarray(jmodel.generate(params, jnp.asarray(noise), jc, guidance=2.0, num_steps=2,
                                       num_conditional_frames=1))
    t_out = tpipe.model.generate(torch.from_numpy(noise), tc, guidance=2.0, num_steps=2,
                                 num_conditional_frames=1).numpy()
    want = np.asarray(_jax_per_view_denoise(jmodel, params, jnp.asarray(gt), jnp.asarray(text),
                                            jnp.asarray(noise), 1))
    assert rel_l2(t_out, want) <= REL_L2_SAMPLED
    # view 0's frame 0 is conditioned on both sides; view 1's frame 0 (packed frame 2) only in the port
    for out in (j_out, t_out):
        assert rel_l2(out[:, :, 0], gt[:, :, 0]) < 1e-2
    assert rel_l2(t_out[:, :, 2], gt[:, :, 2]) < 1e-2
    assert rel_l2(j_out[:, :, 2], gt[:, :, 2]) > 0.5
