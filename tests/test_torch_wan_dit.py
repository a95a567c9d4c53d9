"""The port's Wan2.1 DiT and Wan Video2World model held against the JAX
package (CPU, fp32).

One reference-named state dict, drawn with NumPy from a seed, goes through
both packages' converters (JAX's ``convert_wan_dit_state_dict`` into its
parameter tree, the port's into its module), so the tests hold the
converters against each other as well as the forward passes.

Tolerances: the RoPE tables and rotation are computed by the same fp32
formulas and agree to 1e-6; the timestep sinusoid to 1e-4 (fp32 angles of
up to ~1000, where an ulp of the frequency moves an angle by ~6e-5); a
forward (t2v, i2v, 2 layers, dim 96) agrees to 1.1e-6 - 1.2e-6 relative
L2, checked at 1e-5; latents sampled with 3 UniPC steps and CFG at
guidance 5 (which carries each branch's rounding up to 11 times) agree to
2.0e-6, and the whole i2v slice with a VAE encode and decode to 2.4e-6,
both checked at 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.models import wan_video2world as jwv
from cosmos_predict2_tpu.networks import wan_dit as jwd
from cosmos_predict2_tpu.ops.rope import RopeSpec as JRopeSpec
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_wan_dit_state_dict as jax_convert
from cosmos_predict2_tpu_torch.models import wan_video2world as twv
from cosmos_predict2_tpu_torch.networks import wan_dit as twd
from cosmos_predict2_tpu_torch.utils.checkpoint_convert import convert_wan_dit_state_dict
from torch_variants_util import rel_l2

TEXT_DIM = 32
CLIP_DIM = 48
REL_L2 = 1e-5
REL_L2_SAMPLED = 2e-5


def _configs(model_type: str):
    jcfg = dataclasses.replace(jwd.WAN_PRESETS["test"], model_type=model_type, text_dim=TEXT_DIM, clip_dim=CLIP_DIM,
                               in_dim=36 if model_type == "i2v" else 16)
    names = {f.name for f in dataclasses.fields(twd.WanConfig)} - {"dtype"}
    return jcfg, twd.WanConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})


def reference_state_dict(cfg: twd.WanConfig, seed: int) -> dict:
    """A released-layout state dict (no padding-mask channel in the patch
    embedding) drawn with NumPy on the port module's shapes."""
    with torch.device("meta"):
        net = twd.WanModel(cfg)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        shape = tuple(v.shape)
        if k == "patch_embedding.weight":
            shape = (shape[0], cfg.in_dim * 4)
        noise = rng.standard_normal(shape).astype(np.float32)
        if k.endswith("modulation"):
            sd[k] = noise / np.sqrt(cfg.dim)
        elif k.endswith("bias"):
            sd[k] = 0.05 * noise
        elif len(shape) == 1:  # norm weights
            sd[k] = 1.0 + 0.05 * noise
        else:
            sd[k] = noise / np.sqrt(shape[1])
    return sd


def _pair(model_type: str, seed: int = 0):
    jcfg, tcfg = _configs(model_type)
    sd = reference_state_dict(tcfg, seed)
    jparams = jax.tree.map(jnp.asarray, jax_convert(sd, jcfg.num_layers, i2v=model_type == "i2v"))
    net = twd.WanModel(tcfg)
    net.load_state_dict(convert_wan_dit_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}), strict=True)
    return jcfg, jparams, net.eval()


@pytest.fixture(scope="module")
def i2v_pair():
    return _pair("i2v")


def _inputs(seed: int, B: int = 1, T: int = 2, H: int = 8, W: int = 8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, 16, T, H, W), y=f(B, 20, T, H, W), ctx=0.5 * f(B, 512, TEXT_DIM), clip=0.5 * f(B, 257, CLIP_DIM),
                t=np.full((B,), 731.0, np.float32))


def test_sinusoid_and_interleaved_rope_match_jax():
    pos = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    # the angles t * freq are fp32 products of up to ~1000: the two libraries'
    # pow differ by an ulp, which moves an angle by up to ~6e-5
    np.testing.assert_allclose(twd.sinusoidal_embedding_1d(256, torch.from_numpy(pos)).numpy(),
                               np.asarray(jwd.sinusoidal_embedding_1d(256, jnp.asarray(pos))), rtol=0, atol=1e-4)
    want = np.asarray(jwd.wan_rope_freqs(JRopeSpec(head_dim=128, enable_fps_modulation=False), 3, 4, 5))
    got = twd.wan_rope_freqs(128, 3, 4, 5, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(0).standard_normal((1, 60, 2, 128)).astype(np.float32)
    np.testing.assert_allclose(twd.rope_apply_interleaved(torch.from_numpy(x), got).numpy(),
                               np.asarray(jwd.rope_apply_interleaved(jnp.asarray(x), jnp.asarray(want))),
                               rtol=1e-6, atol=1e-6)


def test_converter_extends_the_patch_embedding_for_the_padding_channel():
    """The released patch embedding (dim, C*4), or the Conv3d it flattens
    from, gains 4 zero columns per appended channel, at the end."""
    w = torch.randn(96, 36, 1, 2, 2)
    out = convert_wan_dit_state_dict({"patch_embedding.weight": w, "head.head.bias": torch.ones(3)})
    assert out["patch_embedding.weight"].shape == (96, 37 * 4)
    assert torch.equal(out["patch_embedding.weight"][:, :144], w.reshape(96, 144))
    assert not out["patch_embedding.weight"][:, 144:].any() and torch.equal(out["head.head.bias"], torch.ones(3))
    with pytest.raises(ValueError, match="prod"):
        convert_wan_dit_state_dict({"patch_embedding.weight": torch.randn(96, 6)})


@pytest.mark.parametrize("model_type", ["t2v", "i2v"])
def test_wan_forward_matches_jax(model_type, i2v_pair):
    """The forward, t2v and i2v (the CLIP branch's 257 image tokens split
    off in front of the 512 text tokens), padding mask zero; B = 2 with
    the batch's two samples differing."""
    jcfg, jparams, net = i2v_pair if model_type == "i2v" else _pair("t2v", seed=1)
    a = _inputs(3, B=2)
    kw = dict(y_B_C_T_H_W=a["y"], frame_cond_crossattn_emb=a["clip"]) if model_type == "i2v" else {}
    want = jwd.WanModel(jcfg).apply(jparams, jnp.asarray(a["x"]), jnp.asarray(a["t"]) * jnp.array([1.0, 0.3]),
                                    jnp.asarray(a["ctx"]), **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = net(torch.from_numpy(a["x"]), torch.from_numpy(a["t"]) * torch.tensor([1.0, 0.3]),
                  torch.from_numpy(a["ctx"]), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (2, 16, 2, 8, 8) and got.dtype == torch.float32
    assert rel_l2(got, want) <= REL_L2


def test_wan_generate_matches_jax(i2v_pair):
    """Three UniPC steps at shift 5 with CFG (guidance 5) against zero text
    and against a negative prompt, frame 0 conditional through ``y``; the
    port batches the two branches."""
    jcfg, jparams, net = i2v_pair
    a = _inputs(4)
    jmodel = jwv.WanVideo2WorldModel(jwv.WanModelConfig(net=jcfg, state_t=2))
    mask = np.zeros((1, 1, 2, 1, 1), np.float32)
    mask[:, :, 0] = 1.0
    gt = a["x"] * 0.7
    jcond = jwv.WanCondition(crossattn_emb=jnp.asarray(a["ctx"]), clip_emb=jnp.asarray(a["clip"]),
                             gt_frames=jnp.asarray(gt), condition_video_mask=jnp.asarray(mask))
    noise = np.random.default_rng(5).standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    want = jmodel.generate(jparams, jnp.asarray(noise), jcond, guidance=5.0, num_steps=3)
    model = twv.WanVideo2WorldModel(twv.WanModelConfig(net=net.cfg, state_t=2), net)
    cond = twv.make_i2v_condition(torch.from_numpy(a["ctx"]), torch.from_numpy(gt), torch.from_numpy(a["clip"]))
    assert torch.equal(cond.condition_video_mask, torch.from_numpy(mask))
    got = model.generate(torch.from_numpy(noise), cond, guidance=5.0, num_steps=3)
    assert rel_l2(got, want) <= REL_L2_SAMPLED
    # a negative prompt's text in the unconditional branch
    neg = 0.3 * a["ctx"][:, ::-1].copy()
    want = jmodel.generate(jparams, jnp.asarray(noise), jcond, guidance=5.0, num_steps=3,
                           negative_text_embeddings=jnp.asarray(neg))
    got = model.generate(torch.from_numpy(noise), cond, guidance=5.0, num_steps=3,
                         negative_text_embeddings=torch.from_numpy(neg))
    assert rel_l2(got, want) <= REL_L2_SAMPLED
    # text only: no conditional frame, the CLIP context zeros
    cond0 = twv.make_i2v_condition(torch.from_numpy(a["ctx"]), torch.from_numpy(gt))
    assert not cond0.condition_video_mask.any() and cond0.clip_emb.shape == (1, 257, 1280)


def test_image2world_slice_matches_jax(i2v_pair):
    """The i2v request: the first frame and zeros through the Wan2.1 VAE
    encoder, 2 UniPC steps, the decode; against the same steps composed
    from the JAX package's streaming VAE and Wan model, on the same
    weights and noise."""
    from cosmos_predict2_tpu.tokenizers import wan_vae_streaming as jvs
    from torch_variants_util import vae_pair

    jcfg, jparams, net = i2v_pair
    vcfg, vparams, vae = vae_pair()
    a = _inputs(6)
    frame = np.random.default_rng(7).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    clip = a["clip"]
    gen = torch.Generator().manual_seed(9)
    model = twv.WanVideo2WorldModel(twv.WanModelConfig(net=net.cfg, state_t=2), net)
    latents, px = twv.image2world(model, vae, torch.from_numpy(frame), torch.from_numpy(a["ctx"]),
                                  torch.from_numpy(clip), gen, num_frames=5, guidance=5.0, num_steps=2)
    noise = torch.randn((1, 16, 2, 4, 4), generator=torch.Generator().manual_seed(9)).numpy()

    video = np.zeros((1, 5, 32, 32, 3), np.float32)
    video[:, 0] = frame
    jlat = np.asarray(jvs.encode_streaming(vcfg, vparams, jnp.asarray(video))).transpose(0, 4, 1, 2, 3)
    mask = np.zeros((1, 1, 2, 1, 1), np.float32)
    mask[:, :, 0] = 1.0
    jcond = jwv.WanCondition(crossattn_emb=jnp.asarray(a["ctx"]), clip_emb=jnp.asarray(clip),
                             gt_frames=jnp.asarray(jlat), condition_video_mask=jnp.asarray(mask))
    jmodel = jwv.WanVideo2WorldModel(jwv.WanModelConfig(net=jcfg, state_t=2))
    jout = jmodel.generate(jparams, jnp.asarray(noise), jcond, guidance=5.0, num_steps=2)
    jpx = jvs.decode_streaming(vcfg, vparams, jnp.transpose(jout, (0, 2, 3, 4, 1)))
    assert latents.shape == (1, 16, 2, 4, 4) and px.shape == (1, 5, 32, 32, 3)
    assert rel_l2(latents, jout) <= REL_L2_SAMPLED
    assert rel_l2(px, jpx) <= REL_L2_SAMPLED


def test_build_wan_stores_the_matmul_weights_in_the_compute_dtype():
    """Serving: the Linears multiplied in bf16 are stored in bf16; the time
    path, the head and the norms stay fp32; a seed draws the same weights
    as fp32 rounded once."""
    cfg = dataclasses.replace(twd.WAN_PRESETS["test"], dtype=torch.bfloat16, text_dim=TEXT_DIM, clip_dim=CLIP_DIM)
    net = twd.build_wan(cfg, "cpu", seed=3)
    assert net.blocks[0].self_attn.q.weight.dtype == torch.bfloat16 and net.img_emb.proj[1].weight.dtype == torch.bfloat16
    assert net.time_embedding[0].weight.dtype == torch.float32 and net.head.head.weight.dtype == torch.float32
    ref = twd.init_wan_weights(twd.WanModel(dataclasses.replace(cfg, dtype=torch.float32)), torch.Generator().manual_seed(3))
    assert torch.equal(net.blocks[1].ffn[0].weight, ref.blocks[1].ffn[0].weight.to(torch.bfloat16))
    assert not any(p.requires_grad for p in net.parameters())
