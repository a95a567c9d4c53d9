"""Configs of the port, mirroring cosmos_predict2_tpu/configs/defaults.py.

The reference's config module imports ``jax.numpy`` for dtypes, so the port
defines its own: the flagship ``predict2_video2world_2b_rectified_flow``
experiment (2B DiT, Wan2.1 VAE) and ``error-free_mock_data_smoke`` (the
reference's plumbing config: 1024-channel 2-block DiT, dim-16 VAE). A CPU
test pins every field against the reference's ``make_config``.
"""

from __future__ import annotations

import dataclasses

from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig


@dataclasses.dataclass(frozen=True)
class Config:
    model: RFModelConfig = RFModelConfig()
    tokenizer: WanVAEConfig = WanVAEConfig()


NET_2B = DiTConfig(
    model_channels=2048,
    num_heads=16,
    num_blocks=28,
    use_adaln_lora=True,
    adaln_lora_dim=256,
)
NET_MINI = dataclasses.replace(NET_2B, model_channels=1024, num_heads=8, num_blocks=2)

EXPERIMENTS: dict[str, Config] = {
    "predict2_video2world_2b_rectified_flow": Config(
        model=RFModelConfig(
            net=dataclasses.replace(
                NET_2B,
                rope_h_extrapolation_ratio=3.0,
                rope_w_extrapolation_ratio=3.0,
                rope_t_extrapolation_ratio=1.0,
                rope_enable_fps_modulation=False,
                use_crossattn_projection=True,
                crossattn_proj_in_channels=100352,
                crossattn_emb_channels=1024,
            ),
            state_t=24,
            resolution="720",
        ),
        tokenizer=WanVAEConfig(),
    ),
    "error-free_mock_data_smoke": Config(
        model=RFModelConfig(net=NET_MINI, state_t=4, resolution="720"),
        tokenizer=WanVAEConfig(dim=16),
    ),
}


def make_config(experiment: str = "predict2_video2world_2b_rectified_flow") -> Config:
    if experiment not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {experiment!r}; the port has {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[experiment]
