"""The port's camera-conditioned variant and camera math held against the
JAX package (CPU).

Tolerances: camera math in fp32 on both sides agrees to 1e-5 relative L2
per function (a matrix inverse, a cross product and a normalisation are
the longest chains; measured <= 3e-7); the masks and chunk reorders are
equal; the DiT forward with the camera input (fp32, 2 blocks) agrees to
relative L2 <= 1e-5 and the sampled latents (2 UniPC steps, batched CFG at
guidance 1.5) to <= 5e-5 (torch_variants_util.REL_L2_SAMPLED says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.models import camera as jcam
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.utils import camera_math as jcm
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.models import camera as tcam
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.utils import camera_math as tcm
from torch_variants_util import REL_L2, REL_L2_SAMPLED, port_net, rel_l2, seeded_jax_params, tiny_jax_config

CAM_TOL = 1e-5


def _poses(n=6, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jcm.quaternion_to_rotation_matrix(jnp.asarray(q, jnp.float32)))
    t = rng.normal(size=(n, 3, 1)).astype(np.float32)
    f = rng.uniform(80, 200, size=(n, 2))
    c = rng.uniform(20, 60, size=(n, 2))
    intr = np.stack([f[:, 0], f[:, 1], c[:, 0], c[:, 1]], axis=-1).astype(np.float32)
    return np.concatenate([R, t], axis=-1).astype(np.float32), q.astype(np.float32), intr


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert rel_l2(got, np.asarray(want)) <= CAM_TOL


def test_rays_and_plucker_rays_match_jax():
    poses, _, intr = _poses()
    K = np.array(jcm.intrinsic_params_to_matrices(jnp.asarray(intr)))
    Kt = tcm.intrinsic_params_to_matrices(torch.from_numpy(intr))
    _close(Kt, K)
    for size in ((4, 6), (44, 80)):
        _close(tcm.get_camera_rays(torch.from_numpy(poses), Kt, size), jcm.get_camera_rays(jnp.asarray(poses), K, size))
        got = tcm.get_plucker_rays(torch.from_numpy(poses), Kt, size)
        assert got.shape == (6, size[0] * size[1], 6)
        _close(got, jcm.get_plucker_rays(jnp.asarray(poses), K, size))


def test_pose_quaternion_and_render_helpers_match_jax():
    poses, q, intr = _poses()
    other, _, _ = _poses(seed=7)
    P, O = torch.from_numpy(poses), torch.from_numpy(other)
    K = np.array(jcm.intrinsic_params_to_matrices(jnp.asarray(intr)))
    _close(tcm.invert_pose(P), jcm.invert_pose(poses))
    _close(tcm.compose_poses([P, O]), jcm.compose_poses([poses, other]))
    _close(tcm.get_camera_center(P), jcm.get_camera_center(poses))
    _close(tcm.get_relative_poses_wrt_frame0(P[None]), jcm.get_relative_poses_wrt_frame0(jnp.asarray(poses)[None]))
    pts = np.random.default_rng(2).normal(size=(6, 10, 3)).astype(np.float32)
    _close(tcm.world2camera(torch.from_numpy(pts), P), jcm.world2camera(pts, poses))
    _close(tcm.camera2world(torch.from_numpy(pts), P), jcm.camera2world(pts, poses))
    _close(tcm.camera2image(torch.from_numpy(pts), torch.from_numpy(K)), jcm.camera2image(pts, K))
    _close(tcm.image2camera(torch.from_numpy(pts), torch.from_numpy(K)), jcm.image2camera(pts, K))
    _close(tcm.intrinsic_matrices_to_params(torch.from_numpy(K)), jcm.intrinsic_matrices_to_params(K))
    params = np.concatenate([q, poses[..., 3]], axis=-1)
    _close(tcm.extrinsic_params_to_matrices(torch.from_numpy(params)), jcm.extrinsic_params_to_matrices(params))
    _close(tcm.extrinsic_matrices_to_params(P), jcm.extrinsic_matrices_to_params(poses))
    Q, Q2 = torch.from_numpy(q), torch.from_numpy(q[::-1].copy())
    _close(tcm.quaternion_to_rotation_matrix(Q), jcm.quaternion_to_rotation_matrix(q))
    _close(tcm.quaternion_from_rotation_matrix(P[..., :3]), jcm.quaternion_from_rotation_matrix(poses[..., :3]))
    _close(tcm.quaternion_invert(Q), jcm.quaternion_invert(q))
    _close(tcm.quaternion_multiply(Q, Q2), jcm.quaternion_multiply(q, q[::-1].copy()))
    assert bool(tcm.check_valid_pose(P).all()) and bool(tcm.check_unit_quaternion(Q).all())
    np.testing.assert_array_equal(tcm.check_valid_pose(P * 2).numpy(), np.asarray(jcm.check_valid_pose(poses * 2)))

    rng = np.random.default_rng(3)
    center, rays = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    near, far = np.full((5, 1), 0.5, np.float32), np.full((5, 1), 3.0, np.float32)

    def field(xp):
        def nerf(points, dirs):
            return xp.tanh(points + dirs), xp.abs(points[..., :1]) * 2.0
        return nerf

    for solid in (False, True):
        want = jcm.volume_render_rays(field(jnp), center, rays, near, far, 8, solid_background=solid)
        got = tcm.volume_render_rays(field(torch), *map(torch.from_numpy, (center, rays, near, far)), 8,
                                     solid_background=solid)
        for g, w in zip(got, want):
            _close(g, w)
    with pytest.raises(ValueError, match="generator"):
        tcm.sample_dists(torch.from_numpy(near), torch.from_numpy(far), 4, stratified=True)


def test_reorders_and_masks_match_jax():
    cam = np.arange(30, dtype=np.float32).reshape(1, 30, 1) * np.ones((1, 30, 3), np.float32)
    np.testing.assert_array_equal(tcam.reorder_camera_chunks(torch.from_numpy(cam[:, :6])).numpy(),
                                  np.asarray(jcam.reorder_camera_chunks(jnp.asarray(cam[:, :6]))))
    np.testing.assert_array_equal(tcam.reorder_camera_chunks(torch.from_numpy(cam), 5).numpy(),
                                  np.asarray(jcam.reorder_camera_chunks(jnp.asarray(cam), 5)))
    np.testing.assert_array_equal(tcam.reorder_camera_chunks_ar(torch.from_numpy(cam[:, :10])).numpy(),
                                  np.asarray(jcam.reorder_camera_chunks_ar(jnp.asarray(cam[:, :10]))))
    jnet, tnet = tiny_jax_config(camera_dim=6), None
    emb = np.zeros((2, 4, 64), np.float32)
    for jcls, tcls in ((jcam.CameraVideo2WorldModel, tcam.CameraVideo2WorldModel),
                       (jcam.CameraFrameinitVideo2WorldModel, tcam.CameraFrameinitVideo2WorldModel),
                       (jcam.CameraARVideo2WorldModel, tcam.CameraARVideo2WorldModel)):
        jm = jcls(JRFConfig(net=jnet))
        tm = tcls(RFModelConfig(), tnet)
        for T in (1, 6, 9, 12, 15):
            gt = np.ones((2, 16, T, 2, 2), np.float32)
            for k in (1, 2):
                options = [{}, {"lvg": True}] if tcls is tcam.CameraARVideo2WorldModel else [{}]
                for opt in options:
                    j = jm.set_camera_condition(jcond.make_condition(jnp.asarray(emb)), jnp.asarray(gt), k, **opt)
                    t = tm.set_camera_condition(tcond.make_condition(torch.from_numpy(emb)), torch.from_numpy(gt), k,
                                                **opt)
                    np.testing.assert_array_equal(t.condition_video_mask.numpy(), np.asarray(j.condition_video_mask))
                    assert t.use_video_condition is True and bool(j.use_video_condition)
        lat = np.random.default_rng(0).normal(size=(1, 16, 2, 2, 2)).astype(np.float32)
        if tcls is tcam.CameraARVideo2WorldModel:
            chunks = [lat + i for i in range(4)]
            np.testing.assert_array_equal(
                tm.pack_inference_latents([torch.from_numpy(c) for c in chunks], torch.from_numpy(lat)).numpy(),
                np.asarray(jm.pack_inference_latents([jnp.asarray(c) for c in chunks], jnp.asarray(lat))))
        else:
            np.testing.assert_array_equal(tm.pack_inference_latents(torch.from_numpy(lat)).numpy(),
                                          np.asarray(jm.pack_inference_latents(jnp.asarray(lat))))


def _camera_models():
    """JAX's and the port's CameraVideo2WorldModel on the same weights (JAX
    initialised with ``camera=`` so that its cam_encoders exist)."""
    jcfg = tiny_jax_config(camera_dim=6)
    rng = np.random.default_rng(1)
    x = np.zeros((1, 16, 6, 8, 8), np.float32)
    cam = rng.standard_normal((1, 6, 4, 4, 6)).astype(np.float32)
    params = seeded_jax_params(jcfg, x, np.zeros((1,), np.float32), np.zeros((1, 4, 64), np.float32), camera=cam)
    net = port_net(params, jcfg)
    jm = jcam.CameraVideo2WorldModel(JRFConfig(net=jcfg, state_t=6, sampling_num_steps=2))
    tm = tcam.CameraVideo2WorldModel(RFModelConfig(net=net.cfg, state_t=6, sampling_num_steps=2), net)
    return jm, jax.tree.map(jnp.asarray, params), tm


def test_dit_forward_with_camera_matches_jax():
    jm, params, tm = _camera_models()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 6, 8, 8)).astype(np.float32)
    t = np.asarray([300.0, 800.0], np.float32)
    ctx = rng.standard_normal((2, 4, 64)).astype(np.float32)
    cam = rng.standard_normal((2, 6, 4, 4, 6)).astype(np.float32)
    want = JDiT(jm.config.net).apply(params, x, t, ctx, camera=cam)
    with torch.no_grad():
        got = tm.net(*map(torch.from_numpy, (x, t, ctx)), camera=torch.from_numpy(cam))
        # without a camera both skip the camera term
        got_none = tm.net(*map(torch.from_numpy, (x, t, ctx)))
    assert rel_l2(got.numpy(), want) <= REL_L2
    assert rel_l2(got_none.numpy(), JDiT(jm.config.net).apply(params, x, t, ctx)) <= REL_L2
    assert rel_l2(got_none.numpy(), want) > 1e-3


def test_camera_generate_matches_jax_and_follows_the_camera():
    jm, params, tm = _camera_models()
    rng = np.random.default_rng(3)
    text = rng.standard_normal((1, 4, 64)).astype(np.float32) * 0.05
    cond_latents = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    cam = rng.standard_normal((1, 6, 4, 4, 6)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 6, 8, 8)).astype(np.float32)
    gt_j = jm.pack_inference_latents(jnp.asarray(cond_latents))
    jc = jcond.make_condition(jnp.asarray(text)).replace(gt_frames=gt_j, camera=jnp.asarray(cam))
    want = jm.generate(params, jnp.asarray(noise), jc, guidance=1.5, num_conditional_frames=2)
    gt_t = tm.pack_inference_latents(torch.from_numpy(cond_latents))
    tc = tcond.make_condition(torch.from_numpy(text)).replace(gt_frames=gt_t, camera=torch.from_numpy(cam))
    got = tm.generate(torch.from_numpy(noise), tc, guidance=1.5, num_conditional_frames=2)
    assert got.shape == (1, 16, 6, 8, 8)
    assert rel_l2(got.numpy(), want) <= REL_L2_SAMPLED
    moved = tm.generate(torch.from_numpy(noise), tc.replace(camera=-3.0 * tc.camera), guidance=1.5,
                        num_conditional_frames=2)
    assert float((moved - got).abs().max()) > 1e-4
