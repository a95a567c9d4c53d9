"""Config groups and experiments of the port, mirroring cosmos_predict2_tpu/configs/defaults.py.

The reference's config module imports ``jax.numpy`` for dtypes, so the port
defines its own groups (the 2B, 14B and mini nets, the rectified-flow model,
the fused-AdamW optimizer, the Wan2.1 and mock tokenizers, mock data and
the local folder of clips) and
the experiments whose nets it runs: the flagship
``predict2_video2world_2b_rectified_flow`` (2B DiT, Wan2.1 VAE), the 14B
base ``predict2_video2world_14b_rectified_flow`` (the same DiT at 5120
channels, 40 heads, 36 blocks), the sparse-attention
``predict2_video2world_2b_sparse`` (the reference's sparse_2B.py tuning: 7
dense blocks, the other 21 neighborhood attention with window (-1, 12, 24)
and stride (1, 4, 8) tuned at a 44 x 80 token grid), the 14B sparse pair
``predict2_video2world_14b_sparse`` (9 dense blocks, the rest as the 2B's)
and ``predict2_video2world_14b_sparse_comb02`` (per-layer windows, strides
and dilations), the interactive
``predict2_interactive_2b_causal`` (the 2B DiT made temporally
block-causal, one latent frame per block, for KV-cache streaming), the
post-trained variants' bases ``predict2_video2world_2b_action_conditioned``,
``predict2_video2world_2b_camera_conditioned`` and
``predict2_multiview_2b_7views``, and
``error-free_mock_data_smoke`` (the reference's plumbing config:
1024-channel 2-block DiT, dim-16 VAE, 3 iterations on 13-frame 64x64 mock
clips). The released experiment names (configs/released_experiments.py)
register last, over these. ``make_config`` takes the reference's
``key=value`` dotlist and its ``group=name`` tokens. A CPU test pins every
field against the reference's ``make_config``.
"""

from __future__ import annotations

import dataclasses

from cosmos_predict2_tpu_torch.configs.registry import (
    Experiment,
    compose,
    get_node,
    register,
    register_experiment,
    resolve_experiment,
)
from cosmos_predict2_tpu_torch.data.local_dataset import LocalVideoDatasetConfig
from cosmos_predict2_tpu_torch.data.mock import MockDataConfig
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig
from cosmos_predict2_tpu_torch.training.trainer import TrainerConfig


@dataclasses.dataclass(frozen=True)
class Config:
    trainer: TrainerConfig = TrainerConfig()
    model: RFModelConfig = RFModelConfig()
    tokenizer: WanVAEConfig = WanVAEConfig()
    data_train: MockDataConfig | LocalVideoDatasetConfig = MockDataConfig()
    # mesh axis sizes (parallel/mesh.py::make_mesh; dp from the remaining
    # devices). The trainer runs on one device until its mesh is ported:
    # training/train.py refuses sizes above 1. pp_size is validated == 1
    # (no pipeline schedule exists, as in the JAX package and the reference)
    fsdp_shard_size: int = 1
    cp_size: int = 1
    tp_size: int = 1
    pp_size: int = 1


# ------------------------------- groups -------------------------------

NET_2B = DiTConfig(
    model_channels=2048,
    num_heads=16,
    num_blocks=28,
    use_adaln_lora=True,
    adaln_lora_dim=256,
)
NET_14B = dataclasses.replace(NET_2B, model_channels=5120, num_heads=40, num_blocks=36)
NET_MINI = dataclasses.replace(NET_2B, model_channels=1024, num_heads=8, num_blocks=2)

register("net", "cosmos_v1_2B", NET_2B)
register("net", "cosmos_v1_14B", NET_14B)
register("net", "mini_net", NET_MINI)
# RFModelConfig's defaults are the reference group's recipe (shift 5
# logit-normal training times, loss scale 10, 0-2 conditional frames drawn
# with probabilities 0.5 / 0.25 / 0.25)
register("model", "fsdp_rectified_flow", RFModelConfig(net=NET_2B, state_t=24, resolution="720"))
register("optimizer", "fusedadamw", OptimizerConfig(lr=2 ** (-14.5), weight_decay=0.001))
register("tokenizer", "wan2pt1_tokenizer", WanVAEConfig())
register("tokenizer", "mock_tokenizer", WanVAEConfig(dim=16))
register("data_train", "mock", MockDataConfig())
# post-training on a local folder of clips (videos/ metas/ t5_xxl/)
register("data_train", "local_video", LocalVideoDatasetConfig())

# ----------------------------- experiments -----------------------------

register_experiment(
    Experiment(
        name="predict2_video2world_2b_rectified_flow",
        groups={"net": "cosmos_v1_2B", "model": "fsdp_rectified_flow", "optimizer": "fusedadamw"},
        overrides={
            "model.net.rope_h_extrapolation_ratio": 3.0,
            "model.net.rope_w_extrapolation_ratio": 3.0,
            "model.net.rope_t_extrapolation_ratio": 1.0,
            "model.net.rope_enable_fps_modulation": False,
            "model.net.use_crossattn_projection": True,
            "model.net.crossattn_proj_in_channels": 100352,
            "model.net.crossattn_emb_channels": 1024,
            "trainer.optimizer.lr": 2 ** (-14.5),
            "trainer.optimizer.f_max": (0.5,),
            "trainer.optimizer.f_min": (0.2,),
            "trainer.optimizer.warm_up_steps": (2000,),
            "trainer.optimizer.cycle_lengths": (100000,),
        },
    )
)

register_experiment(
    Experiment(
        name="predict2_video2world_14b_rectified_flow",
        base="predict2_video2world_2b_rectified_flow",
        groups={"net": "cosmos_v1_14B"},
    )
)

register_experiment(
    Experiment(
        name="predict2_video2world_2b_sparse",
        base="predict2_video2world_2b_rectified_flow",
        overrides={
            "model.net.n_dense_blocks": 7,
            "model.net.natten_window": (-1, 12, 24),
            "model.net.natten_stride": (1, 4, 8),
            "model.net.natten_base_size": (-1, 44, 80),
        },
    )
)

# the 14B sparse pair: 9 dense blocks spread over the 36 (the reference's
# sparse_14B.py), and comb02, one (window, stride, dilation, base_size)
# entry per layer (None: dense): layers 0-10 dilated windows over the whole
# sub-grid, 11-12 stride and dilation mixed, layer 27 dense, the rest
# strided windows of three sizes
register_experiment(
    Experiment(
        name="predict2_video2world_14b_sparse",
        base="predict2_video2world_14b_rectified_flow",
        overrides={
            "model.net.n_dense_blocks": 9,
            "model.net.natten_window": (-1, 12, 24),
            "model.net.natten_stride": (1, 4, 8),
            "model.net.natten_base_size": (-1, 44, 80),
        },
    )
)

_BASE_14B = (-1, 44, 80)
_COMB02_BIG = {24, 26, 28, 31, 32, 34}  # window (-1, 28, 56)
_COMB02_MID = {23, 25, 29, 30, 33, 35}  # window (-1, 20, 40)


def _comb02_layer(i: int):
    if i <= 10:
        return ((-1, 4, 16), (1, 1, 1), (1, 11, 5), _BASE_14B)
    if i <= 12:
        return ((-1, 12, 16), (1, 4, 1), (1, 1, 5), _BASE_14B)
    if i == 27:
        return None
    if i in _COMB02_BIG:
        return ((-1, 28, 56), (1, 4, 8), (1, 1, 1), _BASE_14B)
    if i in _COMB02_MID:
        return ((-1, 20, 40), (1, 4, 8), (1, 1, 1), _BASE_14B)
    return ((-1, 12, 24), (1, 4, 8), (1, 1, 1), _BASE_14B)


COMB02_NATTEN_PARAMETERS = tuple(_comb02_layer(i) for i in range(36))

register_experiment(
    Experiment(
        name="predict2_video2world_14b_sparse_comb02",
        base="predict2_video2world_14b_rectified_flow",
        overrides={"model.net.natten_parameters": COMB02_NATTEN_PARAMETERS},
    )
)

register_experiment(
    Experiment(
        name="predict2_interactive_2b_causal",
        base="predict2_video2world_2b_rectified_flow",
        overrides={
            "model.net.temporal_causal": True,
            "model.net.num_frame_per_block": 1,
        },
    )
)

# the post-trained 2B variants' base experiments: the action-conditioned
# robot model (13 frames, so 4 latent frames; the registry's action input is
# 7 x 12 values per step, as the JAX package's), the camera-conditioned one
# (Plücker rays, 6 values per token) and the 7-view driving model (8 latent
# frames per view)
register_experiment(
    Experiment(
        name="predict2_video2world_2b_action_conditioned",
        base="predict2_video2world_2b_rectified_flow",
        overrides={"model.net.action_dim": 7 * 12, "model.net.concat_condition_mask": True, "model.state_t": 4},
    )
)

register_experiment(
    Experiment(
        name="predict2_video2world_2b_camera_conditioned",
        base="predict2_video2world_2b_rectified_flow",
        overrides={"model.net.camera_dim": 6},
    )
)

register_experiment(
    Experiment(
        name="predict2_multiview_2b_7views",
        base="predict2_video2world_2b_rectified_flow",
        overrides={
            "model.net.n_views": 7,
            "model.net.concat_view_embedding": True,
            "model.net.view_condition_dim": 6,
            "model.net.concat_condition_mask": True,
            "model.state_t": 56,
        },
    )
)

register_experiment(
    Experiment(
        name="error-free_mock_data_smoke",
        groups={
            "net": "mini_net",
            "model": "fsdp_rectified_flow",
            "optimizer": "fusedadamw",
            "tokenizer": "mock_tokenizer",
        },
        overrides={
            "model.state_t": 4,
            "trainer.max_iter": 3,
            "trainer.logging_iter": 1,
            "data_train.num_frames": 13,
            "data_train.height": 64,
            "data_train.width": 64,
        },
    )
)

# the released experiment names, over the experiments above
import cosmos_predict2_tpu_torch.configs.released_experiments  # noqa: E402,F401

_GROUPS = ("net", "model", "optimizer", "tokenizer", "data_train")


def _select(cfg: Config, group: str, name: str) -> Config:
    node = get_node(group, name)
    if group == "net":
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, net=node))
    if group == "optimizer":
        return dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, optimizer=node))
    return dataclasses.replace(cfg, **{group: node})


def make_config(experiment: str = "predict2_video2world_2b_rectified_flow", overrides: list[str] | None = None) -> Config:
    """Defaults -> the experiment's group selections (the model group
    before the net it holds) and overrides -> the dotlist, where a dot-free
    ``group=name`` token selects a registry node."""
    cfg = Config()
    exp = resolve_experiment(experiment)
    for group in sorted(exp.groups, key=lambda g: g != "model"):
        cfg = _select(cfg, group, exp.groups[group])
    cfg = compose(cfg, exp.overrides)
    fields = []
    for o in overrides or []:
        key, _, value = o.partition("=")
        if key in _GROUPS:
            cfg = _select(cfg, key, value)
        else:
            fields.append(o)
    return compose(cfg, fields)
