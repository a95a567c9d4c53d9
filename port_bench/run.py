"""One run of one cell of the port's benchmark.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell, its configuration
(port_bench/configs/<config>.json), its traffic (port_bench/traffic/<mix>.json,
whose ``kind`` names the module port_bench/<kind>.py whose ``RUNNER`` drives
it) and its limits (port_bench/limits/<cell>.json) are found by name from
BENCHMARK.json; each per-layer metric is read by
port_bench/metrics/<metric>.py. A new kind of traffic is a new runner module:
no file here changes. A runner drives as many chips as its ``max_chips`` says
(more than 1 only where it starts the ranks itself); a cell asking more is
refused. A runner's ``counted`` is the work of all its chips, which the
``mfu`` readers divide by the chips and the peak; ``check_bytes`` is what its
check holds on the device through the window, left out of the program's peak.

Set-up (build, weights from the seed, one warm-up step) is timed from process
start; the window then runs ``--seconds`` of whole steps; once it has closed
the outputs are checked against the plain reference. The last line of
standard output is the result as one JSON object; the numbers compared and
their limits are the last lines of standard error and the result's last key.

A run refuses to start without as many CUDA devices as the cell asks for,
and prints no result if ``jax``, ``jaxlib``, ``flax`` or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# compared by whole top-level names: the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "cosmos_predict2_tpu")


class RunError(Exception):
    """A run that cannot start or cannot be judged; exit code ``code``."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_cell(root: Path, workload: str) -> dict:
    """Everything a cell names, found by name from ``root``/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "port_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "port_bench" / "limits" / f"{workload}.json").read_text())
    in_cell = lambda m: workload in m.get("workloads", [workload])
    return {"cell": cell, "config": cfg, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if in_cell(m)],
            "per_layer": [m for m in bench["per_layer"] if in_cell(m)]}


def load_reader(root: Path, metric: str):
    """port_bench/metrics/<metric>.py's ``read``."""
    path = root / "port_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind_class(kind: str):
    """port_bench/<kind>.py's ``RUNNER``: the class that drives a traffic kind."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind):
        raise RunError(f"traffic kind {kind!r} is not a module name")
    try:
        module = importlib.import_module(f"port_bench.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"port_bench.{kind}":
            raise
        raise RunError(f"no runner port_bench/{kind}.py for traffic kind {kind!r}") from None
    if not hasattr(module, "RUNNER"):
        raise RunError(f"port_bench/{kind}.py has no RUNNER")
    return module.RUNNER


def power_limit() -> float | None:
    """The card's power limit in W, as nvidia-smi reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number finite and within its limit."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise RunError(f"no limit for {missing}", code=3)
    checks = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items()}
    return all(math.isfinite(v) and v <= limits[name] for name, v in numbers.items()), checks


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str | None = None) -> dict:
    """One run; ``device`` None requires the cell's CUDA devices (tests pass
    ``"cpu"`` to drive the rest of a run at a tiny size)."""
    import torch

    spec = load_cell(root, workload)
    chips = spec["cell"]["chips"]
    runner_cls = kind_class(spec["traffic"]["kind"])
    if chips > runner_cls.max_chips:
        raise RunError(f"the runner of kind {spec['traffic']['kind']!r} drives at most {runner_cls.max_chips} "
                       f"chip(s); the cell asks {chips}")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} CUDA device(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        device = "cuda:0"
    runner = runner_cls(spec["config"], spec["traffic"], torch.device(device), seed)
    runner.warm_up()
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:  # the window's peak: set-up's passing buffers are not the program's footprint
        torch.cuda.reset_peak_memory_stats(device)
    profiler = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    setup_s = time.perf_counter() - T_START
    res = runner.window(seconds, profiler)
    # the program's own peak: the check's buffers, live all through the window, are the harness's
    check_bytes = runner.check_bytes()
    memory_peak = torch.cuda.max_memory_allocated(device) - check_bytes if on_cuda else 0
    reading = dict(res, kind=runner.kind, chips=chips, **runner.counted(res["units"]))
    breakdown = None
    if trace:
        from port_bench import trace as T

        reading["trace"] = T.reduce(profiler)
        breakdown = {"device_ops": reading["trace"]["device_ops"], "idle_gaps": reading["trace"]["idle_gaps"]}
    runner.free_program()
    correct, checks = judge(runner.check(), spec["limits"])
    correct = correct and res["failed"] == 0

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = load_reader(root, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, res["metric"]: res["window_s"] / max(res["units"], 1)}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu", "count": chips,
           "memory_peak_bytes": int(memory_peak), "memory_check_bytes": int(check_bytes)}
    if trace:
        dev.update(busy_s=reading["trace"]["busy_s"], window_s=res["window_s"])
    if on_cuda:
        dev["power_limit_w"] = power_limit()
    result = {"correct": bool(correct), "attempted": res["units"], "failed": res["failed"], "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    build = root / "build" / "port_bench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    out, sys.stdout = sys.stdout, sys.stderr  # the program's prints go to stderr; the result line alone to stdout
    try:
        result = run(root, args.workload, args.seed, args.seconds, bool(args.trace))
    except RunError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
