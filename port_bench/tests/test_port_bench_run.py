"""A whole run on the CPU at a tiny size: the result's shape, the refusal
without CUDA, the check against JAX, cells found by name, and the faults
that must make ``correct`` false."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import REPO
from port_bench import run

SEED = 2**31 + 12345  # more than 32 signed bits hold


def tiny_run(root: Path, workload: str = "v2w-2b-720p", trace: bool = False) -> dict:
    return run.run(root, workload, SEED, 0.5, trace, device="cpu")


@pytest.mark.parametrize("workload", ["v2w-2b-720p", "posttrain-2b-gr1-480"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_shape(tiny_root, trace, workload):
    result = tiny_run(tiny_root, workload, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]}
    assert set(result["metrics"]) <= names
    e2e = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    if not trace:
        assert set(result["metrics"]) == e2e and len(e2e) == 2
    else:
        assert {"mfu.serve", "mfu.train"} & set(result["metrics"]) and "breakdown" in result
        assert {"busy_s", "window_s"} <= set(result["device"])
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"], name
    json.loads(json.dumps(result))


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "v2w-2b-720p", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files gives no result."""
    subprocess.run(["cp", "-r", str(REPO / "port_bench"), str(REPO / "BENCHMARK.json"), str(tmp_path)], check=True)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "v2w-2b-720p", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("names,found", [
    (["cosmos_predict2_tpu_torch", "cosmos_predict2_tpu_torch.ops.rope", "torch", "jaxtyping"], []),
    (["cosmos_predict2_tpu", "cosmos_predict2_tpu.ops"], ["cosmos_predict2_tpu", "cosmos_predict2_tpu.ops"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "numpy"], ["flax.linen", "jax", "jax.numpy",
                                                                       "jaxlib.xla_client"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert run.forbidden_modules(names) == found


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = ("import sys; from pathlib import Path; from port_bench import run; "
            f"r = run.run(Path({str(tiny_root)!r}), 'v2w-2b-sparse-720p', 7, 0.2, False, device='cpu'); "
            "print(run.forbidden_modules(), r['correct'])")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def test_cells_metrics_and_configs_are_found_by_name(tiny_root):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell as files and entries; no file already there is edited."""
    before = {p: p.read_bytes() for p in (tiny_root / "port_bench").rglob("*") if p.is_file()}
    pb = tiny_root / "port_bench"
    cfg = json.loads((pb / "configs" / "cosmos-predict2.5-2b.json").read_text())
    (pb / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "v2w-720p-cfg.json").read_text())
    (pb / "traffic" / "throwaway-mix.json").write_text(json.dumps(dict(tr, guidance=3.0)))
    (pb / "limits" / "throwaway-cell.json").write_text((pb / "limits" / "v2w-2b-720p.json").read_text())
    (pb / "metrics" / "steps_seen.serve.py").write_text("def read(r):\n    return float(r['units'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "file": "port_bench/configs/throwaway.json"})
    bench["workloads"].append({"name": "throwaway-cell", "config": "throwaway", "traffic": "throwaway-mix",
                               "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] == "denoise_step_s":
            m["workloads"].append("throwaway-cell")
    bench["per_layer"].append({"name": "steps_seen.serve", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "model step", "moves": "denoise_step_s",
                               "workloads": ["throwaway-cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = tiny_run(tiny_root, "throwaway-cell", trace=True)
    assert result["correct"] and result["metrics"]["steps_seen.serve"]["value"] == result["attempted"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_new_traffic_kind_is_a_new_module(tiny_root, monkeypatch):
    """A traffic kind names port_bench/<kind>.py, whose RUNNER drives it: a
    later change adds a kind as a file, with no edit to run.py."""
    import port_bench

    pb = tiny_root / "port_bench"
    (pb / "throwaway_kind.py").write_text(
        "from port_bench.serve import Serve\n\n\nclass Runner(Serve):\n    pass\n\n\nRUNNER = Runner\n")
    monkeypatch.setattr(port_bench, "__path__", [*port_bench.__path__, str(pb)])
    tr = json.loads((pb / "traffic" / "v2w-720p-cfg.json").read_text())
    (pb / "traffic" / "v2w-720p-cfg.json").write_text(json.dumps(dict(tr, kind="throwaway_kind")))
    assert run.kind_class("throwaway_kind").__name__ == "Runner"
    result = tiny_run(tiny_root, "v2w-2b-720p")
    assert result["correct"] is True and result["attempted"] >= 1
    sys.modules.pop("port_bench.throwaway_kind", None)


@pytest.mark.parametrize("kind,message", [("no_such_kind", "no runner"), ("../serve", "not a module name"),
                                          ("reference", "no RUNNER")])
def test_an_unknown_kind_is_refused(kind, message):
    with pytest.raises(run.RunError, match=message):
        run.kind_class(kind)


def test_refuses_more_chips_than_the_runner_drives(tiny_root):
    """A cell asking four chips of a runner that drives one is refused, not
    run as one process on one card."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = dict(next(w for w in bench["workloads"] if w["name"] == "v2w-2b-720p"), name="v2w-2b-720p-cp4", chips=4)
    bench["workloads"].append(cell)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "port_bench" / "limits" / "v2w-2b-720p-cp4.json").write_text(
        (tiny_root / "port_bench" / "limits" / "v2w-2b-720p.json").read_text())
    with pytest.raises(run.RunError, match="at most 1 chip"):
        tiny_run(tiny_root, "v2w-2b-720p-cp4")


class _Event:
    def __init__(self, device_type, name, start_ns, duration_ns, device_index=0):
        self._t, self._name, self._start, self._dur, self._dev = device_type, name, start_ns, duration_ns, device_index

    def is_user_annotation(self):
        return False

    def device_type(self):
        return self._t

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_index(self):
        return self._dev


def test_trace_busy_is_averaged_over_the_traced_devices():
    """Two devices, one busy 3 ms of kernels (two overlapping), the other 1 ms:
    busy_s is their mean, and the gaps are those in which no device ran."""
    from types import SimpleNamespace

    from port_bench import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ms = 1_000_000
    events = [_Event(cuda, "flash_attention_fwd_kernel", 0, 2 * ms, 0),
              _Event(cuda, "elementwise_kernel", 1 * ms, 2 * ms, 0),
              _Event(cuda, "nccl_kernel", 5 * ms, 1 * ms, 1),
              _Event(cpu, "aten::mm", 0, 10 * ms)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    out = trace.reduce(prof)
    assert out["devices"] == 2
    assert out["busy_s"] == pytest.approx((3e-3 + 1e-3) / 2)
    assert out["families"]["K1 flash attention forward"] == pytest.approx(2e-3)
    assert out["idle_gaps"] == [["aten::mm", pytest.approx(2e-3)]]
