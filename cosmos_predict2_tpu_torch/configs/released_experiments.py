"""Released-checkpoint experiment names, the port's copy of
cosmos_predict2_tpu/configs/released_experiments.py for the nets it runs.

Every checkpoint in the release DB (utils/checkpoint_db.py) records the
experiment that produced it, and the loader rebuilds its config from that
name (utils/model_loader.py). Registered here, over the experiments of
configs/defaults.py: the Index-26 2B base and its resume2, RF sampling of
an EDM-trained checkpoint, the Index-43 14B base, the sparse-resume family
(Index 200/201/202), the four Transfer2.5 control branches over the 2B
base, the two DMD2 TrigFlow distillation runs and the OSS post-training
recipes (cosmos-nemo-assets in full and with LoRA, and groot GR1 480p),
and the post-trained 2B variants' serving names (the four auto-multiview
"buttercup" runs, the two robot-multicamera runs and the bridge
action-conditioned run), and the two interactive gr00t GR1 action names
(the causal streaming net with the action embedders), and the variants'
two training recipes (bridge action-conditioned, Waymo multiview).

:data:`WAITING` would list the reference's names that need modules the
port lacks, with the roadmap item that brings each; it is empty.
"""

from __future__ import annotations

from cosmos_predict2_tpu_torch.configs.registry import Experiment, register_experiment

INDEX_26 = (
    "Stage-c_pt_4-reason_embeddings-v1p1-Index-26-Size-2B-Res-720-Fps-16"
    "-Note-T2V_high_sigma_loss_reweighted_1_1_rectified_flow_only"
)
# the resume that produced nvidia/Cosmos-Predict2.5-2B/base/pre-trained
INDEX_26_RESUME2 = INDEX_26 + "_resume2"

# ---------------------------------------------------------------------------
# 2B base family: the high-sigma strategy over the plain 2B RF recipe
# ---------------------------------------------------------------------------

_HIGH_SIGMA = {
    "model.use_high_sigma_strategy": True,
    "model.high_sigma_ratio": 0.05,
}

register_experiment(Experiment(name=INDEX_26, base="predict2_video2world_2b_rectified_flow",
                               overrides=dict(_HIGH_SIGMA)))
register_experiment(Experiment(name=INDEX_26_RESUME2, base=INDEX_26))

# RF sampling over an EDM-trained checkpoint: the conditional-frame
# timestep pinned, the Karras sigma schedule at inference
register_experiment(
    Experiment(
        name="Stage-c_pt_4-Index-2-Size-2B-Res-720-Fps-16-Note-rf_with_edm_ckpt",
        base="predict2_video2world_2b_rectified_flow",
        overrides={
            "model.conditional_frame_timestep": 0.1,
            "model.use_karras_sigma_at_inference": True,
        },
    )
)

# ---------------------------------------------------------------------------
# 14B base: the shift-5 RF run resumed with the high-sigma strategy on
# ---------------------------------------------------------------------------

register_experiment(
    Experiment(
        name=(
            "Stage-c_pt_4-reason_embeddings-v1p1-Index-43-Size-14B-Res-720-Fps-16"
            "_resume_from_reason1p1_rectified_flow_shift5_high_sigma"
        ),
        base="predict2_video2world_14b_rectified_flow",
        overrides=dict(_HIGH_SIGMA),
    )
)

# ---------------------------------------------------------------------------
# Sparse-attention resume family: the 2B sparse config with 7 / 6 / 4
# dense blocks
# ---------------------------------------------------------------------------

for _idx, _ndense in ((200, 7), (201, 6), (202, 4)):
    register_experiment(
        Experiment(
            name=f"Stage-c_pt_4-Index-{_idx}-Size-2B-Res-720-Fps-16-Note-HQ_V3_from_22_sparse-attn_{_ndense}dense",
            base="predict2_video2world_2b_sparse",
            overrides={"model.net.n_dense_blocks": _ndense},
        )
    )

# ---------------------------------------------------------------------------
# Transfer2.5 control branches (edge / seg / blur / depth), registered over
# the 2B base so that their checkpoints' names resolve
# ---------------------------------------------------------------------------

for _name in (
    "edge_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv3p1_20250714_64N_rectified_flow_mock_data",
    "seg_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv4p2_20250823_64N_rectified_flow",
    "vis_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv3p1_20250714_64N_rectified_flow",
    "depth_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv4p1_20250823_64N_rectified_flow",
):
    register_experiment(Experiment(name=_name, base="predict2_video2world_2b_rectified_flow"))

# ---------------------------------------------------------------------------
# DMD2 TrigFlow distillation: the 4-step student over the 2B base; the
# _w_discriminator variant names the run with the GAN head on DiT features
# (its recipe is the same here)
# ---------------------------------------------------------------------------

register_experiment(
    Experiment(
        name="dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional",
        base="predict2_video2world_2b_rectified_flow",
        overrides={"model.sampling_num_steps": 4},
    )
)
register_experiment(
    Experiment(
        name="dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional_w_discriminator",
        base="dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional",
    )
)

# ---------------------------------------------------------------------------
# OSS post-training recipes over the released 2B base: 93 frames at
# 704x1280, batch 1, 1000 iterations saved every 200; the full fine-tune and
# its LoRA variant
# ---------------------------------------------------------------------------

_POSTTRAIN = {
    "trainer.max_iter": 1000,
    "trainer.save_iter": 200,
    "data_train.num_frames": 93,
    "data_train.height": 704,
    "data_train.width": 1280,
    "data_train.batch_size": 1,
}

register_experiment(
    Experiment(name="predict2_video2world_training_2b_cosmos_nemo_assets", base=INDEX_26_RESUME2,
               overrides=dict(_POSTTRAIN))
)
# LoRA post-training (the reference's cosmos_nemo_assets_lora.py: rank 32,
# alpha 32, q/k/v/output_proj and both MLP layers)
register_experiment(
    Experiment(
        name="predict2_lora_training_2b_cosmos_nemo_assets",
        base="predict2_video2world_training_2b_cosmos_nemo_assets",
        overrides={"model.use_lora": True, "model.lora_rank": 32, "model.lora_alpha": 32.0},
    )
)
register_experiment(
    Experiment(
        name="predict2_video2world_training_2b_groot_gr1_480",
        base="predict2_video2world_training_2b_cosmos_nemo_assets",
        overrides={"data_train.height": 432, "data_train.width": 768},
    )
)

# ---------------------------------------------------------------------------
# The post-trained 2B variants. Auto multiview: 7 views of 29 frames (8
# latent frames each) at 720p, RoPE without fps modulation; the two
# Transfer2.5 multiview names take the same geometry. Robot multicamera:
# camera-conditioned Video2World at 720p. Action-conditioned: the bridge
# robot clips, 13 frames at 256x320 (4 latent frames).
# ---------------------------------------------------------------------------

_BUTTERCUP = {"model.net.rope_enable_fps_modulation": False, "model.state_t": 56}

register_experiment(
    Experiment(
        name=("buttercup_predict2p5_2b_7views_res720p_fps30_t8_from48kfps30mv_condprobs0442"
              "_joint_alpamayo1capnoviewprefix_allcapsviewprefix_29frames_nofps"),
        base="predict2_multiview_2b_7views",
        overrides=dict(_BUTTERCUP),
    )
)
# uniform training times, conditional frames down to 0
register_experiment(
    Experiment(
        name=("buttercup_predict2p5_2b_7views_res720p_fps30_t8_joint_alpamayo1capviewprefix"
              "_allcapsviewprefix_29frames_nofps_uniform_dropoutt0"),
        base="predict2_multiview_2b_7views",
        overrides={**_BUTTERCUP, "model.rectified_flow.train_time_distribution": "uniform",
                   "model.min_num_conditional_frames": 0},
    )
)
for _name in (
    "buttercup_transfer2p5_2b_mv_7views_res720p_fps10_t8_fromfinetuned12knofpsuniform"
    "_mads720pmulticaps29frames_world_scenario_nofps_uniform",
    "buttercup_transfer2p5_2b_mv_7views_res720p_fps10_t8_frombase5knofps"
    "_mads720pmulticaps29frames_world_scenario_resumefrom21k",
):
    register_experiment(Experiment(name=_name, base="predict2_multiview_2b_7views", overrides=dict(_BUTTERCUP)))

for _name in (
    "multicamera_video2video_rectified_flow_2b_res_720_fps16_s3_multicam_syncam",
    "multicamera_video2video_rectified_flow_2b_res_720_fps16_s3_agibot",
):
    register_experiment(Experiment(name=_name, base="predict2_video2world_2b_camera_conditioned"))

register_experiment(
    Experiment(
        name="cosmos_predict2p5_2B_reason_embeddings_action_conditioned_rectified_flow_bridge_13frame_256x320",
        base="predict2_video2world_2b_action_conditioned",
    )
)

# the interactive gr00t GR1 runs: the causal 2B streaming net with the
# action embedders, 13-frame blocks at 256x320 (4 latent frames), 7 x 12
# action values per step (the JAX registry's contract)
for _name in (
    "cosmos_predict2p5_2B_action_conditioned_gr00t_gr1_customized_13frame_sf_warmup",
    "cosmos_predict2p5_2B_action_gr00t_gr1_warmup",
):
    register_experiment(
        Experiment(name=_name, base="predict2_interactive_2b_causal",
                   overrides={"model.net.action_dim": 7 * 12, "model.state_t": 4})
    )

# ---------------------------------------------------------------------------
# The post-trained variants' training recipes, as the JAX package registers
# them. Neither package has a data flow from their clip layouts (robot state
# tracks, 7-view clips with per-view captions) to a condition: the action
# recipe's net refuses batches without actions at its first step (ROADMAP
# C8), and the multiview recipe trains on data whose latent frames and
# caption tokens divide among its 7 views.
# ---------------------------------------------------------------------------

register_experiment(
    Experiment(
        name="ac_reason_embeddings_rectified_flow_2b_256_320",
        base="predict2_video2world_2b_action_conditioned",
        overrides={"trainer.max_iter": 1000, "trainer.save_iter": 200, "data_train.num_frames": 13,
                   "data_train.height": 256, "data_train.width": 320, "data_train.batch_size": 1},
    )
)
register_experiment(
    Experiment(
        name="predict2_multiview_post_train_waymo",
        base="predict2_multiview_2b_7views",
        overrides={"trainer.max_iter": 1000, "trainer.save_iter": 200, "data_train.batch_size": 1},
    )
)

# The reference's names that wait for modules the port lacks, as (name,
# roadmap item that brings it): none.
WAITING: tuple[tuple[str, str], ...] = ()
