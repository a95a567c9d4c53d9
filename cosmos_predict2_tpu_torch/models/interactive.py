"""Interactive (causal, real-time) world model with KV-cache streaming.

Counterpart of cosmos_predict2_tpu/models/interactive.py (the reference's
``CausalDIT`` and ``ActionStreamingInference``): the causal Video2World model
with its per-block KV caches, and the streaming loop that prefills the
conditioning frames, then for each frame block runs the few-step TrigFlow
denoise against the cache, commits the clean block's k/v and slides the
rolling window.

The caches are updated in place, not copied. JAX's update is functional and
its loop donates the buffers; here each self-attention writes the new
block's k/v into the head-major ring buffers at [len, len + s_new) and
returns caches with ``len`` advanced (networks/dit.py::cached_attention). A
denoise forward drops them, so its writes stay past ``len`` and are
overwritten by the commit, which keeps them. The window slide rolls each
buffer in place, one chunk at a time (``shift_cache_window``). So the loop
holds one copy of the cache (28 x 2 x (B, 16, S_max, 128) bf16: 3.43 GB at
352x640 with 16 + 1 frames). Self-forcing training (``SelfForcingDMD2``)
is not ported yet; the cached forward raises under autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from cosmos_predict2_tpu_torch.conditioning.conditioner import Video2WorldCondition
from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, trigflow_scalings_rf
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig


def causal_model_config(base_net: DiTConfig, num_frame_per_block: int = 1, **model_kwargs) -> RFModelConfig:
    net = dataclasses.replace(base_net, temporal_causal=True, num_frame_per_block=num_frame_per_block)
    return RFModelConfig(net=net, **model_kwargs)


class CausalVideo2WorldModel(Video2WorldModel):
    """Video2World with temporal block-causal attention and KV-cache decode."""

    def init_kv_caches(
        self, batch: int, max_latent_frames: int, latent_h: int, latent_w: int, device: torch.device | str,
        dtype: torch.dtype = torch.bfloat16,
    ) -> list[dict]:
        """One cache per block: zeroed head-major (B, H, S_max, D) k / v ring
        buffers on ``device`` and the filled length ``len`` (a host int)."""
        cfg = self.config.net
        s_max = max_latent_frames * (latent_h // cfg.patch_spatial) * (latent_w // cfg.patch_spatial)
        shape = (batch, cfg.num_heads, s_max, cfg.head_dim)
        return [
            {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device),
             "len": 0}
            for _ in range(cfg.num_blocks)
        ]

    def forward_with_cache(
        self, x_new_B_C_T_H_W: torch.Tensor, timesteps_B_T: torch.Tensor, condition: Video2WorldCondition,
        kv_caches: list, t_start: int,
    ) -> tuple[torch.Tensor, list]:
        """One forward of the new frame block against the cached context:
        (net output, caches with the block appended). Keeping the returned
        caches commits the block (prefill); dropping them leaves the old
        ``len`` (a denoise step)."""
        return self.net(
            x_new_B_C_T_H_W, timesteps_B_T, condition.crossattn_emb, fps=condition.fps,
            padding_mask=condition.padding_mask, kv_caches=kv_caches, t_start=t_start,
        )


def shift_cache_window(cache: dict, drop_tokens: int) -> dict:
    """Roll the ring buffers left by ``drop_tokens`` IN PLACE (the values of
    ``jnp.roll(buf, -drop_tokens, axis=2)``) and lower ``len`` by as much.

    ``Tensor.copy_`` refuses partially overlapping memory, so the buffer
    moves in chunks of ``drop_tokens`` positions, front to back, each chunk
    read before it is overwritten; only the dropped front is copied aside.
    """
    for name in ("k", "v"):
        buf = cache[name]
        S = buf.shape[2]
        if not 0 < drop_tokens <= S:
            raise ValueError(f"shift_cache_window: drop_tokens {drop_tokens} outside [1, {S}]")
        front = buf[:, :, :drop_tokens].clone()
        for s0 in range(0, S - drop_tokens, drop_tokens):
            n = min(drop_tokens, S - drop_tokens - s0)
            buf[:, :, s0:s0 + n].copy_(buf[:, :, s0 + drop_tokens:s0 + drop_tokens + n])
        buf[:, :, S - drop_tokens:].copy_(front)
    return {"k": cache["k"], "v": cache["v"], "len": cache["len"] - drop_tokens}


@dataclasses.dataclass
class StreamingConfig:
    distill: DistillationConfig = DistillationConfig()
    num_frame_per_block: int = 1
    cache_frame_size: int = 16  # rolling window, in latent frames
    num_steps: int = 4


class StreamingInference:
    """Frame-block streaming generation with the few-step distilled student:
    prefill the conditioning frames, then per block a few-step denoise
    against the cache, the commit of the clean block's k/v, and the window
    slide."""

    def __init__(self, config: StreamingConfig, model: CausalVideo2WorldModel):
        self.config = config
        self.model = model
        self.distill = dataclasses.replace(config.distill, model=model.config)

    @torch.no_grad()
    def prefill(self, latents_B_C_T_H_W: torch.Tensor, condition: Video2WorldCondition, kv_caches: list,
                t_start: int = 0) -> list:
        """Append clean frames' k/v to the caches (timestep 0 = clean)."""
        B, _, T = latents_B_C_T_H_W.shape[:3]
        ts = torch.zeros((B, T), dtype=torch.float32, device=latents_B_C_T_H_W.device)
        _, caches = self.model.forward_with_cache(
            latents_B_C_T_H_W.to(self.model.config.net.dtype), ts, condition, kv_caches, t_start
        )
        return caches

    @torch.no_grad()
    def generate_block(self, noise: torch.Tensor, condition: Video2WorldCondition, kv_caches: list,
                       t_start: int) -> tuple[torch.Tensor, list]:
        """Few-step TrigFlow denoise of one new frame block from ``noise``
        (B, C, nb, h, w) fp32, then the commit: (clean block fp32, caches)."""
        cfg = self.config
        x = noise
        t_steps = list(self.distill.selected_sampling_time[: cfg.num_steps]) + [0.0]
        B, nb = noise.shape[0], noise.shape[2]
        sd = self.distill.sigma_data
        for t_cur, t_next in zip(t_steps[:-1], t_steps[1:]):
            times = torch.full((B, 1, nb, 1, 1), t_cur, dtype=torch.float32, device=noise.device)
            c_skip, c_out, c_in, c_noise = trigflow_scalings_rf(times, sd)
            net_in = (x * c_in).to(self.model.config.net.dtype)
            net_out, _ = self.model.forward_with_cache(
                net_in, c_noise[:, 0, :, 0, 0] * 1000.0, condition, kv_caches, t_start
            )
            x = c_skip * x + c_out * net_out.float()
            if t_next > 1e-5:
                x = math.cos(t_next) * x / sd + math.sin(t_next) * noise
        return x, self.prefill(x, condition, kv_caches, t_start)

    @torch.no_grad()
    def generate(
        self,
        condition: Video2WorldCondition,
        init_latents: Optional[torch.Tensor],
        num_latent_frames: int,
        latent_shape_hw: tuple[int, int],
        state_ch: int = 16,
        generator: Optional[torch.Generator] = None,
        draw: Optional[Callable[[int, tuple], torch.Tensor]] = None,
        on_block: Optional[Callable[[int, torch.Tensor, list], None]] = None,
    ) -> torch.Tensor:
        """Stream ``num_latent_frames`` latent frames; returns (B, C, T, h, w)
        fp32. Block ``step``'s noise is ``draw(step, shape)``, by default a
        standard normal from ``generator``. ``on_block(step, x, caches)``
        sees each committed block after the window slide."""
        cfg = self.config
        net = self.model.config.net
        device = next(self.model.net.parameters()).device
        if draw is None:
            if generator is None:
                raise ValueError("generate needs a torch.Generator or a draw function for the noise")
            draw = lambda step, shape: torch.randn(shape, generator=generator, device=generator.device)
        B = condition.crossattn_emb.shape[0]
        h, w = latent_shape_hw
        tokens_per_frame = (h // net.patch_spatial) * (w // net.patch_spatial)
        nb = cfg.num_frame_per_block

        caches = self.model.init_kv_caches(B, cfg.cache_frame_size + nb, h, w, device)
        blocks = []
        n_init = 0
        if init_latents is not None:
            caches = self.prefill(init_latents, condition, caches, t_start=0)
            n_init = init_latents.shape[2]
            blocks.append(init_latents.float())
        t_pos = generated = n_init
        step = 0
        max_tokens = cfg.cache_frame_size * tokens_per_frame
        while generated < num_latent_frames:
            noise = draw(step, (B, state_ch, nb, h, w)).to(device=device, dtype=torch.float32)
            x, caches = self.generate_block(noise, condition, caches, t_pos)
            blocks.append(x)
            generated += nb
            t_pos += nb  # grows without bound: the RoPE position of the next block
            step += 1
            # slide the window when the cache is full
            if (step * nb + n_init) * tokens_per_frame > max_tokens:
                caches = [shift_cache_window(c, nb * tokens_per_frame) for c in caches]
            if on_block is not None:
                on_block(step, x, caches)
        return torch.cat(blocks, dim=2)[:, :, :num_latent_frames]
