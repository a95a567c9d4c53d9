"""The port's action-conditioned variant held against the JAX package (CPU).

Tolerances: the NumPy helpers are copies and must agree bit for bit; the
DiT forward (fp32, 2 blocks, each action branch) agrees to relative L2 <=
1e-5, the sampled latents (2 UniPC steps, batched CFG at guidance 2) to
<= 5e-5 (torch_variants_util.REL_L2_SAMPLED says why); the request
through ActionConditionedInference (streaming VAE here, JAX's one-shot
VAE there, fp32) gives uint8 frames within one level of JAX's: both round
the samples to bf16 before the decode, and JAX's decode rounds the
denormalized latents to bf16 once more (it casts back to its input's
dtype), which the port's does only with a bf16 VAE, as every released
config has; with this fp32 VAE that moves the pixels by 2.6e-3 relative L2
and 10% of them by one level (0.2 levels on average allowed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.models import action_conditioned as jac
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.configs.defaults import make_config
from cosmos_predict2_tpu_torch.models import action_conditioned as tac
from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from torch_variants_util import (
    REL_L2, REL_L2_SAMPLED, jit_init, noisy_params, port_net, rel_l2, seeded_jax_params, tiny_jax_config, vae_pair,
)


def test_euler_quaternion_and_relative_actions_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        rpy = rng.uniform(-1.2, 1.2, 3)
        R = tac.euler2rotm(rpy)
        np.testing.assert_array_equal(R, jac.euler2rotm(rpy))
        np.testing.assert_allclose(tac.rotm2euler(R), rpy, atol=1e-12)
        np.testing.assert_array_equal(tac.rotm2euler(R), jac.rotm2euler(R))
        np.testing.assert_array_equal(tac.rotm2quat(R), jac.rotm2quat(R))
    lock = tac.euler2rotm(np.array([0.3, np.pi / 2, 0.1]))  # gimbal lock
    np.testing.assert_array_equal(tac.rotm2euler(lock), jac.rotm2euler(lock))
    arm = rng.standard_normal((13, 6)) * 0.1
    grip = rng.uniform(0, 1, 13)
    for quat in (False, True):
        got = tac.relative_actions_from_states(arm, grip, use_quat=quat)
        np.testing.assert_array_equal(got, jac.relative_actions_from_states(arm, grip, use_quat=quat))
        assert got.shape == (12, 8 if quat else 7)
    got = tac.get_action_sequence_from_states(arm, grip, fps_downsample_ratio=2, action_scaler=5.0, gripper_scale=2.0)
    want = jac.get_action_sequence_from_states(arm, grip, fps_downsample_ratio=2, action_scaler=5.0, gripper_scale=2.0)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 7)


# (action_per_latent_frame, action groups per clip, per-frame timesteps)
ACTION_CASES = {
    "chunk": (False, None, False),
    "per latent frame, frame 0 padded": (True, 2, True),
    "per latent frame, every frame": (True, 3, True),
}


@pytest.mark.parametrize("case", list(ACTION_CASES))
def test_dit_forward_with_actions_matches_jax(case):
    per_frame, groups, frame_t = ACTION_CASES[case]
    jcfg = tiny_jax_config(concat_condition_mask=True, action_dim=7, num_action_per_chunk=4,
                           action_per_latent_frame=per_frame, num_action_per_latent_frame=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    t = (rng.uniform(0, 1, (2, 3) if frame_t else (2,)) * 1000).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    n_act = groups * 2 if per_frame else 4
    action = rng.standard_normal((2, n_act, 7)).astype(np.float32)
    mask = (rng.uniform(size=(2, 1, 3, 1, 1)) < 0.5).astype(np.float32) * np.ones((2, 1, 3, 8, 8), np.float32)
    params = seeded_jax_params(jcfg, x, t, ctx, action=action, condition_mask=mask)
    want = JDiT(jcfg).apply(params, x, t, ctx, condition_mask=mask, action=action)
    net = port_net(params, jcfg)
    assert net.action_embedder_B_D.fc1.in_features == 7 * (2 if per_frame else 4)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (x, t, ctx)), condition_mask=torch.from_numpy(mask),
                  action=torch.from_numpy(action))
    assert rel_l2(got.numpy(), want) <= REL_L2
    with torch.no_grad():  # the actions move the output
        moved = net(*map(torch.from_numpy, (x, t, ctx)), condition_mask=torch.from_numpy(mask),
                    action=torch.from_numpy(action + 1.0))
    assert rel_l2(moved.numpy(), want) > 1e-3
    with pytest.raises(ValueError, match="no action"):
        net(*map(torch.from_numpy, (x, t, ctx)))


def test_registry_action_embedder_takes_84x12_inputs():
    """The registry name keeps JAX's contract: action_dim 7 x 12 = 84 with
    12 actions per chunk, so fc1 takes 1008 inputs, while a 13-frame clip's
    states give 12 actions of 7 (84 values): that input does not fit."""
    cfg = make_config("predict2_video2world_2b_action_conditioned").model.net
    with torch.device("meta"):
        net = MiniTrainDIT(cfg)
    assert (cfg.action_dim, cfg.num_action_per_chunk) == (84, 12)
    assert tuple(net.action_embedder_B_D.fc1.weight.shape) == (4 * 2048, 1008)
    actions = tac.get_action_sequence_from_states(np.zeros((13, 6)), np.zeros(13))
    assert actions.size == 84 != net.action_embedder_B_D.fc1.in_features


def _tiny_action_model():
    net = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
    jcfg = jac.action_conditioned_model_config(net, action_dim=7, num_action_per_chunk=4, state_t=2,
                                               sampling_num_steps=2)
    jmodel = jac.ActionConditionedVideo2WorldModel(jcfg)
    params = jit_init(jmodel.net.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 2, 4, 4)), jnp.zeros((1,)),
                             jnp.zeros((1, 8, 1024)), condition_mask=jnp.zeros((1, 1, 2, 4, 4)),
                             action=jnp.zeros((1, 4, 7)))
    params = noisy_params(params)
    tnet = port_net(params, jcfg.net)
    tcfg = tac.action_conditioned_model_config(tnet.cfg, action_dim=7, num_action_per_chunk=4, state_t=2,
                                               sampling_num_steps=2)
    return jmodel, jax.tree.map(jnp.asarray, params), Video2WorldModel(tcfg, tnet)


def test_generate_matches_jax():
    jmodel, params, tmodel = _tiny_action_model()
    rng = np.random.default_rng(2)
    gt = rng.standard_normal((1, 16, 2, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 2, 4, 4)).astype(np.float32)
    emb = rng.standard_normal((1, 8, 1024)).astype(np.float32) * 0.05
    action = rng.standard_normal((1, 4, 7)).astype(np.float32) * 0.1
    jc = jcond.make_condition(jnp.asarray(emb)).replace(gt_frames=jnp.asarray(gt), action=jnp.asarray(action))
    want = jmodel.generate(params, jnp.asarray(noise), jc, guidance=2.0, num_steps=2, num_conditional_frames=1)
    tc = tcond.make_condition(torch.from_numpy(emb)).replace(gt_frames=torch.from_numpy(gt),
                                                             action=torch.from_numpy(action))
    got = tmodel.generate(torch.from_numpy(noise), tc, guidance=2.0, num_steps=2, num_conditional_frames=1)
    assert rel_l2(got.numpy(), want) <= REL_L2_SAMPLED
    moved = tmodel.generate(torch.from_numpy(noise), tc.replace(action=tc.action + 1.0), guidance=2.0, num_steps=2,
                            num_conditional_frames=1)
    assert float((moved - got)[:, :, 1:].abs().max()) > 1e-4  # the actions steer the generated frame


def test_action_inference_matches_jax():
    jmodel, params, tmodel = _tiny_action_model()
    jvae_cfg, jvae_params, vae = vae_pair()
    from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE

    rng = np.random.default_rng(3)
    arm, grip = rng.standard_normal((9, 6)) * 0.01, rng.uniform(0, 1, 9)
    actions = tac.get_action_sequence_from_states(arm, grip, fps_downsample_ratio=2)
    video = np.zeros((1, 5, 32, 32, 3), np.uint8)
    video[:, 0] = rng.integers(0, 256, (32, 32, 3))
    emb = rng.standard_normal((1, 8, 1024)).astype(np.float32) * 0.05
    want = jac.ActionConditionedInference(jmodel, params, JVAE(jvae_cfg), jvae_params).generate(
        video, actions, jnp.asarray(emb), guidance=2.0, num_steps=2)
    pipe = tac.ActionConditionedInference(tmodel, vae)
    got = pipe.generate(video, actions, emb, guidance=2.0, num_steps=2)
    assert got.shape == want.shape == (5, 32, 32, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1 and diff.mean() <= 0.2
    assert set(pipe.last_timings) == {"vae_encode_s", "denoise_s", "vae_decode_s"}
