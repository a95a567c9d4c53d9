"""Fixtures of the benchmark's CPU tests: a throwaway checkout root holding
tiny copies of the serving cells (2 blocks of 256 channels, 3 latent frames
of 8 x 12), so a whole run drives the port's plain paths in seconds.

    python3 -m pytest port_bench/tests -q
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"model_channels": 256, "num_blocks": 2, "num_heads": 2, "adaln_lora_dim": 32,
        "crossattn_proj_in_channels": 64, "crossattn_emb_channels": 96}
SPARSE = {"n_dense_blocks": 1, "natten_window": [-1, 2, 3], "natten_base_size": [-1, 4, 6], "natten_stride": [1, 2, 2]}
CELLS = {"v2w-2b-720p": "cosmos-predict2.5-2b", "v2w-2b-sparse-720p": "cosmos-predict2.5-2b-sparse"}
TRAIN_CELLS = {"posttrain-2b-gr1-480": "cosmos-predict2.5-2b"}


def tiny_config(name: str) -> dict:
    cfg = json.loads((REPO / "port_bench" / "configs" / f"{name}.json").read_text())
    cfg.update(TINY, state_t=3, text_tokens=8)
    over = [f"model.net.{k}={v}" for k, v in TINY.items()] + ["model.state_t=3"]
    if cfg["n_dense_blocks"] != -1:
        cfg.update(SPARSE)
        over += [f"model.net.{k}={json.dumps(v).replace(' ', '')}" for k, v in SPARSE.items()]
    cfg["overrides"] = over
    return cfg


def tiny_traffic() -> dict:
    tr = json.loads((REPO / "port_bench" / "traffic" / "v2w-720p-cfg.json").read_text())
    tr.update(frames=9, height=64, width=96, num_steps=4, check_rows=5)
    return tr


def tiny_train_traffic() -> dict:
    tr = json.loads((REPO / "port_bench" / "traffic" / "posttrain-gr1-480.json").read_text())
    tr.update(frames=9, height=64, width=96, pool_clips=3)
    tr["vae"]["dim"] = 16
    tr["overrides"] = ["tokenizer.dim=16", "data_train.num_frames=9", "data_train.height=64", "data_train.width=96"]
    return tr


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A checkout root whose BENCHMARK.json names the real cells, metrics
    and limits over tiny configurations and traffic."""
    for name in set(CELLS.values()) | set(TRAIN_CELLS.values()):
        assert name in {c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["configs"]}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True)
    shutil.copytree(REPO / "port_bench" / "metrics", pb / "metrics")
    for cell in bench["workloads"]:
        shutil.copy(REPO / "port_bench" / "limits" / f"{cell['name']}.json", pb / "limits")
    for c in bench["configs"]:
        (tmp_path / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    (pb / "traffic" / "v2w-720p-cfg.json").write_text(json.dumps(tiny_traffic()))
    (pb / "traffic" / "posttrain-gr1-480.json").write_text(json.dumps(tiny_train_traffic()))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
