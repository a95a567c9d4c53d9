"""Action-conditioned robot Video2World.

Counterpart of cosmos_predict2_tpu/models/action_conditioned.py: the DiT
takes the condition mask as an extra input channel and embeds the action
chunk into the timestep embedding and the AdaLN-LoRA term
(networks/dit.py: ``concat_condition_mask``, ``action_dim``); the robot's
absolute states (xyz, roll-pitch-yaw, gripper) become scaled relative
actions between consecutive frames. :class:`ActionConditionedInference`
serves a request: uint8 frames and actions -> streaming VAE encode (K2 on
the card) -> UniPC with batched CFG (K1) -> streaming decode (K2) -> uint8
frames.

The Euler and quaternion helpers are NumPy, copies of the JAX module's.
"""

from __future__ import annotations

import dataclasses
from time import perf_counter

import numpy as np
import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import DataType, make_condition
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE
from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming, truncate_u8
from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand


def euler2rotm(rpy: np.ndarray) -> np.ndarray:
    """Euler roll-pitch-yaw (R = Rz @ Ry @ Rx) -> 3x3."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def rotm2euler(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> roll-pitch-yaw (the inverse of :func:`euler2rotm`)."""
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-6:
        roll = np.arctan2(R[2, 1], R[2, 2])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-R[1, 2], R[1, 1])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = 0.0
    return np.array([roll, pitch, yaw])


def rotm2quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
        y = R[0, 1] / (2 * x) if x > 1e-8 else 0.0
        z = R[0, 2] / (2 * x) if x > 1e-8 else 0.0
    return np.array([w, x, y, z])


def relative_actions_from_states(
    arm_states: np.ndarray,
    gripper_states: np.ndarray,
    use_quat: bool = False,
    action_scaler: float = 20.0,
    gripper_scale: float = 1.0,
) -> np.ndarray:
    """Actions between consecutive states: arm (L, 6) xyz + rpy, gripper
    (L,) -> (L-1, 7), or (L-1, 8) with ``use_quat``. Each action is the
    translation in the previous frame, the relative rotation (3 Euler
    angles or a quaternion) and the gripper, scaled by ``action_scaler``
    (the gripper by ``gripper_scale``)."""
    L = arm_states.shape[0]
    dim = 8 if use_quat else 7
    actions = np.zeros((L - 1, dim))
    for k in range(1, L):
        prev_rotm = euler2rotm(arm_states[k - 1, 3:6])
        curr_rotm = euler2rotm(arm_states[k, 3:6])
        rel_xyz = prev_rotm.T @ (arm_states[k, 0:3] - arm_states[k - 1, 0:3])
        rel_rotm = prev_rotm.T @ curr_rotm
        actions[k - 1, 0:3] = rel_xyz
        if use_quat:
            actions[k - 1, 3:7] = rotm2quat(rel_rotm)
            actions[k - 1, 7] = gripper_states[k]
        else:
            actions[k - 1, 3:6] = rotm2euler(rel_rotm)
            actions[k - 1, 6] = gripper_states[k]
    scale = np.full(dim, action_scaler)
    scale[-1] = gripper_scale
    return actions * scale


def get_action_sequence_from_states(
    arm_states: np.ndarray,
    gripper_states: np.ndarray,
    fps_downsample_ratio: int = 1,
    use_quat: bool = False,
    action_scaler: float = 20.0,
    gripper_scale: float = 1.0,
) -> np.ndarray:
    """A clip's robot states -> its scaled relative actions, the state track
    first taken every ``fps_downsample_ratio`` frames."""
    r = fps_downsample_ratio
    return relative_actions_from_states(
        arm_states[::r], gripper_states[::r],
        use_quat=use_quat, action_scaler=action_scaler, gripper_scale=gripper_scale,
    )


def action_conditioned_model_config(
    base_net: DiTConfig, action_dim: int = 7, num_action_per_chunk: int = 12, **model_kwargs
) -> RFModelConfig:
    """The variant's RFModelConfig: the net gains the action embedders and
    the condition-mask input channel."""
    net = dataclasses.replace(
        base_net, concat_condition_mask=True, action_dim=action_dim, num_action_per_chunk=num_action_per_chunk
    )
    return RFModelConfig(net=net, **model_kwargs)


class ActionConditionedVideo2WorldModel(Video2WorldModel):
    """Video2World's training and sampling; the action rides in
    ``condition.action`` into the net's action embedders."""


class ActionConditionedInference:
    """Robot video prediction: the first frame(s) and an action sequence ->
    a clip, from a precomputed prompt embedding. ``vae`` streams at batch 1
    (K2 on the card). ``last_timings`` holds the split of the latest
    request, in seconds: ``vae_encode_s``, ``denoise_s``, ``vae_decode_s``."""

    def __init__(self, model: Video2WorldModel, vae: WanVAE):
        self.model = model
        self.vae = vae
        self.device = next(model.net.parameters()).device
        self.last_timings: dict[str, float] = {}

    @torch.no_grad()
    def generate(
        self,
        video_u8: np.ndarray,
        actions: np.ndarray,
        prompt_emb,
        guidance: float = 3.0,
        num_steps: int = 35,
        num_conditional_frames: int = 1,
        seed: int = 1,
    ) -> np.ndarray:
        """``video_u8`` (1, T, H, W, 3) uint8 (the conditioning frames, the
        rest zeros), ``actions`` (T_act, action_dim) or (1, T_act,
        action_dim), ``prompt_emb`` (1, L, D) -> (T, H, W, 3) uint8."""
        mc = self.model.config
        dev = self.device
        B, T, H, W, _ = video_u8.shape
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        t0 = perf_counter()
        video = torch.as_tensor(np.asarray(video_u8, np.float32) / 127.5 - 1.0).to(dev)
        gt = encode_streaming(self.vae, video.to(self.vae.config.dtype)).permute(0, 4, 1, 2, 3).float()
        sync()
        t1 = perf_counter()
        act = torch.as_tensor(np.asarray(actions, np.float32)).to(dev)
        act = act[None] if act.ndim == 2 else act
        condition = make_condition(torch.as_tensor(prompt_emb).float().to(dev), data_type=DataType.VIDEO)
        condition = condition.replace(gt_frames=gt, action=act)
        noise = arch_invariant_rand((B, mc.state_ch, 1 + (T - 1) // 4, H // 8, W // 8), seed=seed, device=dev)
        samples = self.model.generate(noise, condition, guidance=guidance, num_steps=num_steps,
                                      num_conditional_frames=num_conditional_frames)
        sync()
        t2 = perf_counter()
        # the samples rounded to bf16 before the decode, as the JAX package's request
        frames = decode_streaming(self.vae, samples.to(torch.bfloat16).permute(0, 2, 3, 4, 1))
        out = truncate_u8(frames[0]).cpu().numpy()
        sync()
        self.last_timings = {"vae_encode_s": t1 - t0, "denoise_s": t2 - t1, "vae_decode_s": perf_counter() - t2}
        return out

