"""Checkpoint DB: the released model artifacts by uuid and name, resolved to local files.

The port's copy of cosmos_predict2_tpu/utils/checkpoint_db.py without its
downloader: each entry pins a uuid, a human name, metadata (resolution,
fps, variant), the experiment that produced it (configs/
released_experiments.py) and where it is published. ``get_checkpoint_path``
resolves a uuid or name to a local file, the entry's ``uri`` first and then
``$COSMOS_CHECKPOINT_DIR/<name>/<file>``, and otherwise raises
FileNotFoundError naming the path to place the file at. It fetches nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_DB: dict[str, "CheckpointEntry"] = {}


@dataclasses.dataclass(frozen=True)
class CheckpointEntry:
    uuid: str
    name: str
    experiment: str
    resolution: str = "720"
    fps: int = 16
    variant: str = "base"  # base | auto_multiview | robot_action | distilled | ...
    hf_repo: Optional[str] = None
    hf_filename: Optional[str] = None
    uri: Optional[str] = None
    notes: str = ""


def register_checkpoint(entry: CheckpointEntry) -> None:
    _DB[entry.uuid] = entry
    _DB[entry.name] = entry


def get_checkpoint_by_uuid(key: str) -> CheckpointEntry:
    """The entry of a uuid or a name (the last registered of that name)."""
    if key not in _DB:
        raise KeyError(f"unknown checkpoint '{key}'; known: {sorted(set(e.name for e in _DB.values()))}")
    return _DB[key]


def list_checkpoints() -> list[CheckpointEntry]:
    seen = {}
    for e in _DB.values():
        seen[e.uuid] = e
    return sorted(seen.values(), key=lambda e: e.name)


def get_checkpoint_path(key: str, cache_dir: Optional[str] = None) -> str:
    """The local file of a uuid or name: the entry's ``uri`` where that is
    an existing file, else ``<cache_dir>/<name>/<file>`` (``cache_dir``
    defaults to ``$COSMOS_CHECKPOINT_DIR``, then ~/.cache/cosmos_tpu; the
    file is the published file's name, model.pt where it has none). Raises
    FileNotFoundError naming that path when neither exists."""
    entry = get_checkpoint_by_uuid(key)
    if entry.uri and os.path.exists(entry.uri):
        return entry.uri
    cache_dir = cache_dir or os.environ.get("COSMOS_CHECKPOINT_DIR", os.path.expanduser("~/.cache/cosmos_tpu"))
    local = os.path.join(cache_dir, entry.name, entry.hf_filename or "model.pt")
    if os.path.exists(local):
        return local
    source = f" (published as {entry.hf_repo}/{entry.hf_filename or ''})" if entry.hf_repo else ""
    raise FileNotFoundError(f"checkpoint '{entry.name}' is not on this machine; place the file at {local}{source}")


def find_by_experiment(experiment: str) -> Optional[CheckpointEntry]:
    """The latest entry whose producing experiment matches."""
    for e in reversed(list(_DB.values())):
        if e.experiment == experiment:
            return e
    return None


# --------------------------- released models ---------------------------
# Every uuid, name, producing experiment and published location of the
# JAX package's table. Entries published only to an internal bucket carry
# its uri and no public file name.

_ENTRIES = [
    # (uuid, name, experiment, resolution, fps, variant, hf_repo, hf_filename, uri, notes)
    ("4dbf13c6-1d30-4b02-99d6-75780dd8b744", "google-t5/t5-11b", "-", "-", 0, "text_encoder",
     "google-t5/t5-11b", None, None, "T5-11B embeddings (legacy text path)"),
    ("a2944743-cf8d-427e-a6fc-b3c03d807064", "meta-llama/Llama-Guard-3-8B", "-", "-", 0, "guardrail",
     "meta-llama/Llama-Guard-3-8B", None, None, "prompt guard LLM"),
    ("9c7b7da4-2d95-45bb-9cb8-2eed954e9736", "nvidia/Cosmos-Guardrail1", "-", "-", 0, "guardrail",
     "nvidia/Cosmos-Guardrail1", None, None, "video content safety classifier + face blur"),
    ("7219c6c7-f878-4137-bbdb-76842ea85e70", "Qwen/Qwen2.5-VL-7B-Instruct", "-", "-", 0, "text_encoder",
     "nvidia/Cosmos-Reason1-7B", None, None, "reason1 text-encoder backbone + tokenizer"),
    ("685afcaa-4de2-42fe-b7b9-69f7a2dee4d8", "Wan2.1/vae", "-", "-", 0, "tokenizer",
     "nvidia/Cosmos-Predict2.5-2B", "tokenizer.pth", None, "causal video VAE weights"),
    ("cb3e3ffa-7b08-4c34-822d-61c7aa31a14f", "nvidia/Cosmos-Reason1.1-7B", "-", "-", 0, "text_encoder",
     "nvidia/Cosmos-Reason1-7B", None, None, "reason 1.1 SFT text encoder"),
    # ---- Predict2.5-2B ----
    ("d20b7120-df3e-4911-919d-db6e08bad31c", "nvidia/Cosmos-Predict2.5-2B/base/pre-trained",
     "Stage-c_pt_4-reason_embeddings-v1p1-Index-26-Size-2B-Res-720-Fps-16-Note-T2V_high_sigma_loss_reweighted_1_1_rectified_flow_only_resume2",
     "720p", 16, "base", "nvidia/Cosmos-Predict2.5-2B",
     "base/pre-trained/d20b7120-df3e-4911-919d-db6e08bad31c_ema_bf16.pt", None,
     "2B unified Text2World/Image2World/Video2World"),
    ("7bbc8d06-2bc9-448d-94ee-b48b4ab7189c", "nvidia/Cosmos-Predict2.5-2B/interactive",
     "cosmos_predict2p5_2B_action_conditioned_gr00t_gr1_customized_13frame_sf_warmup",
     "256", 4, "interactive", None, None,
     "s3://bucket/interactive/7bbc8d06-2bc9-448d-94ee-b48b4ab7189c", "self-forcing interactive (action input)"),
    ("bedc35da-1a54-4144-83db-6072c29b0fd9", "nvidia/Cosmos-Predict2.5-2B/interactive",
     "cosmos_predict2p5_2B_action_gr00t_gr1_warmup",
     "256", 4, "interactive", None, None,
     "s3://bucket/interactive/bedc35da-1a54-4144-83db-6072c29b0fd9", "interactive warmup (pre self-forcing)"),
    ("81edfebe-bd6a-4039-8c1d-737df1a790bf", "nvidia/Cosmos-Predict2.5-2B/base/post-trained",
     "Stage-c_pt_4-Index-2-Size-2B-Res-720-Fps-16-Note-rf_with_edm_ckpt",
     "720p", 16, "base", "nvidia/Cosmos-Predict2.5-2B",
     "base/post-trained/81edfebe-bd6a-4039-8c1d-737df1a790bf_ema_bf16.pt", None,
     "post-trained RF from EDM checkpoint"),
    ("524af350-2e43-496c-8590-3646ae1325da", "nvidia/Cosmos-Predict2.5-2B/auto/multiview",
     "buttercup_predict2p5_2b_7views_res720p_fps30_t8_joint_alpamayo1capviewprefix_allcapsviewprefix_29frames_nofps_uniform_dropoutt0",
     "720p", 30, "auto_multiview", None, None,
     "s3://bucket/auto/multiview/524af350-2e43-496c-8590-3646ae1325da", "7-view driving, view-prefixed captions"),
    ("6b9d7548-33bb-4517-b5e8-60caf47edba7", "nvidia/Cosmos-Predict2.5-2B/auto/multiview",
     "buttercup_predict2p5_2b_7views_res720p_fps30_t8_from48kfps30mv_condprobs0442_joint_alpamayo1capnoviewprefix_allcapsviewprefix_29frames_nofps",
     "720p", 30, "auto_multiview", "nvidia/Cosmos-Predict2.5-2B",
     "auto/multiview/6b9d7548-33bb-4517-b5e8-60caf47edba7_ema_bf16.pt", None,
     "7-view driving multiview (public release)"),
    ("0e8177cc-0db5-4cfd-a8a4-b820c772f4fc", "nvidia/Cosmos-Predict2.5-2B/robot/multiview",
     "multicamera_video2video_rectified_flow_2b_res_720_fps16_s3_multicam_syncam",
     "720p", 16, "robot_multiview", None, None,
     "s3://bucket/robot/multiview/0e8177cc-0db5-4cfd-a8a4-b820c772f4fc", "synchronized robot cameras"),
    ("7f6b99b7-7fac-4e74-8dbe-a394cb56ef99", "nvidia/Cosmos-Predict2.5-2B/robot/multiview-agibot",
     "multicamera_video2video_rectified_flow_2b_res_720_fps16_s3_agibot",
     "720p", 16, "robot_multiview", None, None,
     "s3://bucket/robot/multiview-agibot/7f6b99b7-7fac-4e74-8dbe-a394cb56ef99", "agibot robot multiview"),
    ("38c6c645-7d41-4560-8eeb-6f4ddc0e6574", "nvidia/Cosmos-Predict2.5-2B/robot/action-cond",
     "cosmos_predict2p5_2B_reason_embeddings_action_conditioned_rectified_flow_bridge_13frame_256x320",
     "256", 4, "robot_action", "nvidia/Cosmos-Predict2.5-2B",
     "robot/action-cond/38c6c645-7d41-4560-8eeb-6f4ddc0e6574_ema_bf16.pt", None,
     "action-conditioned bridge 13-frame"),
    ("24a3b7b8-6a3d-432d-b7d1-5d30b9229465", "nvidia/Cosmos-Predict2.5-2B/transfer2.5",
     "Stage-c_pt_4-reason_embeddings-v1p1-Index-26-Size-2B-Res-720-Fps-16-Note-T2V_high_sigma_loss_reweighted_1_1_rectified_flow_only",
     "720p", 16, "base", None, None,
     "s3://bucket/transfer2.5/24a3b7b8-6a3d-432d-b7d1-5d30b9229465", "transfer2.5 base (pre-resume)"),
    # ---- Predict2.5-14B ----
    ("54937b8c-29de-4f04-862c-e67b04ec41e8", "nvidia/Cosmos-Predict2.5-14B/base/pre-trained",
     "Stage-c_pt_4-reason_embeddings-v1p1-Index-43-Size-14B-Res-720-Fps-16_resume_from_reason1p1_rectified_flow_shift5_high_sigma",
     "720p", 16, "base", "nvidia/Cosmos-Predict2.5-14B",
     "base/pre-trained/54937b8c-29de-4f04-862c-e67b04ec41e8_ema_bf16.pt", None, "14B base"),
    # ---- Transfer2.5-2B control variants ----
    ("ecd0ba00-d598-4f94-aa09-e8627899c431", "nvidia/Cosmos-Transfer2.5-2B/general/edge",
     "edge_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv3p1_20250714_64N_rectified_flow_mock_data",
     "720p", 16, "transfer_edge", "nvidia/Cosmos-Transfer2.5-2B",
     "general/edge/ecd0ba00-d598-4f94-aa09-e8627899c431_ema_bf16.pt", None, "edge-control"),
    ("fcab44fe-6fe7-492e-b9c6-67ef8c1a52ab", "nvidia/Cosmos-Transfer2.5-2B/general/seg",
     "seg_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv4p2_20250823_64N_rectified_flow",
     "720p", 16, "transfer_seg", "nvidia/Cosmos-Transfer2.5-2B",
     "general/seg/fcab44fe-6fe7-492e-b9c6-67ef8c1a52ab_ema_bf16.pt", None, "segmentation-control"),
    ("20d9fd0b-af4c-4cca-ad0b-f9b45f0805f1", "nvidia/Cosmos-Transfer2.5-2B/general/blur",
     "vis_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv3p1_20250714_64N_rectified_flow",
     "720p", 16, "transfer_blur", "nvidia/Cosmos-Transfer2.5-2B",
     "general/blur/20d9fd0b-af4c-4cca-ad0b-f9b45f0805f1_ema_bf16.pt", None, "blur(vis)-control"),
    ("0f214f66-ae98-43cf-ab25-d65d09a7e68f", "nvidia/Cosmos-Transfer2.5-2B/general/depth",
     "depth_720p_t24_spaced_layer4_cr1pt1_sdev2_lowsigma0.05_nonuniform_hqv4p1_20250823_64N_rectified_flow",
     "720p", 16, "transfer_depth", "nvidia/Cosmos-Transfer2.5-2B",
     "general/depth/0f214f66-ae98-43cf-ab25-d65d09a7e68f_ema_bf16.pt", None, "depth-control"),
    ("4ecc66e9-df19-4aed-9802-0d11e057287a", "nvidia/Cosmos-Transfer2.5-2B/auto/multiview",
     "buttercup_transfer2p5_2b_mv_7views_res720p_fps10_t8_fromfinetuned12knofpsuniform_mads720pmulticaps29frames_world_scenario_nofps_uniform",
     "720p", 10, "transfer_multiview", None, None,
     "s3://bucket/auto/multiview/4ecc66e9-df19-4aed-9802-0d11e057287a", "transfer multiview (world scenario)"),
    ("b5ab002d-a120-4fbf-a7f9-04af8615710b", "nvidia/Cosmos-Transfer2.5-2B/auto/multiview",
     "buttercup_transfer2p5_2b_mv_7views_res720p_fps10_t8_frombase5knofps_mads720pmulticaps29frames_world_scenario_resumefrom21k",
     "720p", 10, "transfer_multiview", "nvidia/Cosmos-Transfer2.5-2B",
     "auto/multiview/b5ab002d-a120-4fbf-a7f9-04af8615710b_ema_bf16.pt", None,
     "transfer multiview (public release)"),
]

for _e in _ENTRIES:
    register_checkpoint(
        CheckpointEntry(
            uuid=_e[0], name=_e[1], experiment=_e[2], resolution=_e[3], fps=_e[4],
            variant=_e[5], hf_repo=_e[6], hf_filename=_e[7], uri=_e[8], notes=_e[9],
        )
    )
del _e
