"""Configs of the port, mirroring cosmos_predict2_tpu/configs/defaults.py.

The reference's config module imports ``jax.numpy`` for dtypes, so the port
defines its own: the flagship ``predict2_video2world_2b_rectified_flow``
experiment (2B DiT, Wan2.1 VAE, the fused-AdamW recipe), its sparse-attention
variant ``predict2_video2world_2b_sparse`` (the reference's sparse_2B.py
tuning: 7 dense blocks, the other 21 neighborhood attention with window
(-1, 12, 24) and stride (1, 4, 8) tuned at a 44 x 80 token grid), the
interactive ``predict2_interactive_2b_causal`` (the 2B DiT made temporally
block-causal, one latent frame per block, for KV-cache streaming; the
reference's interactive/networks/dit_causal.py), the DMD2 students
``dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional`` and its
``_w_discriminator`` variant (4 sampling steps over the 2B base) and
``error-free_mock_data_smoke`` (the reference's plumbing config:
1024-channel 2-block DiT, dim-16 VAE, 3 iterations on 13-frame 64x64 mock
clips). ``make_config`` takes the reference's ``key=value`` dotlist. A CPU
test pins every field against the reference's ``make_config``.
"""

from __future__ import annotations

import dataclasses

from cosmos_predict2_tpu_torch.configs.registry import compose
from cosmos_predict2_tpu_torch.data.mock import MockDataConfig
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig
from cosmos_predict2_tpu_torch.training.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class Config:
    trainer: TrainerConfig = TrainerConfig()
    model: RFModelConfig = RFModelConfig()
    tokenizer: WanVAEConfig = WanVAEConfig()
    data_train: MockDataConfig = MockDataConfig()


NET_2B = DiTConfig(
    model_channels=2048,
    num_heads=16,
    num_blocks=28,
    use_adaln_lora=True,
    adaln_lora_dim=256,
)
NET_MINI = dataclasses.replace(NET_2B, model_channels=1024, num_heads=8, num_blocks=2)

_VIDEO2WORLD_2B = Config(
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
)

EXPERIMENTS: dict[str, Config] = {
    "predict2_video2world_2b_rectified_flow": _VIDEO2WORLD_2B,
    "predict2_video2world_2b_sparse": compose(_VIDEO2WORLD_2B, {
        "model.net.n_dense_blocks": 7,
        "model.net.natten_window": (-1, 12, 24),
        "model.net.natten_stride": (1, 4, 8),
        "model.net.natten_base_size": (-1, 44, 80),
    }),
    "predict2_interactive_2b_causal": compose(_VIDEO2WORLD_2B, {
        "model.net.temporal_causal": True,
        "model.net.num_frame_per_block": 1,
    }),
    # DMD2 TrigFlow distillation (the reference's experiments_dmd2_trigflow.py):
    # the 4-step student over the 2B base; the _w_discriminator variant names
    # the run with the GAN head on DiT features (its recipe is the same here)
    "dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional": compose(_VIDEO2WORLD_2B, {
        "model.sampling_num_steps": 4,
    }),
    "error-free_mock_data_smoke": Config(
        trainer=TrainerConfig(max_iter=3, logging_iter=1),
        model=RFModelConfig(net=NET_MINI, state_t=4, resolution="720"),
        tokenizer=WanVAEConfig(dim=16),
        data_train=MockDataConfig(num_frames=13, height=64, width=64),
    ),
}


EXPERIMENTS["dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional_w_discriminator"] = EXPERIMENTS[
    "dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional"]


def make_config(experiment: str = "predict2_video2world_2b_rectified_flow", overrides: list[str] | None = None) -> Config:
    """The experiment's config with ``a.b.c=value`` overrides applied."""
    if experiment not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {experiment!r}; the port has {sorted(EXPERIMENTS)}")
    return compose(EXPERIMENTS[experiment], overrides)
