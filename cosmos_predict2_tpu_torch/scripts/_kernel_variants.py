"""What the kernel-variant timing scripts (flash_bwd_variants,
flash_fwd_variants, na_variants, conv_variants, kv_window_variants,
jvp_variants) share: a kernel source built with
constants changed into a library of its own, CUDA-event timing, another
checkout's kernels timed through its own wrappers, and the JSON summary
with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from cosmos_predict2_tpu_torch import _build


def cuda_ms(fn, iters: int) -> float:
    """Mean ms of ``iters`` calls of ``fn`` after one warm-up call, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_variant(source: str, name: str, patches: list[tuple[str, str]], kernel: str | tuple[str, ...],
                  launch_regs: int | None = None, allow_spill: bool = False) -> ctypes.CDLL:
    """``csrc/<source>`` with each (old, new) of ``patches`` replaced, compiled
    with the package's nvcc flags into a library of its own. Raises if a
    patch does not apply, nvcc fails, or a kernel whose name holds ``kernel``
    (or one of them) spills (unless ``allow_spill``: then its report is
    printed) or, with ``launch_regs``, launches at another register count."""
    src_dir = _build.BUILD_DIR / "variants" / Path(source).stem / name
    src_dir.mkdir(parents=True, exist_ok=True)
    for f in (source, *_build.HEADERS):
        shutil.copy(_build.CSRC_DIR / f, src_dir / f)
    src = src_dir / source
    text = src.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    src.write_text(text)
    lib_path = src_dir / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
    for line in log.splitlines():
        if "Performance Loss" in line:
            print(f"variant {name}: ptxas: {line.strip()}", flush=True)
    names = (kernel,) if isinstance(kernel, str) else kernel
    report = {k: r for k, r in _build.ptxas_report(log).items() if any(n in k for n in names)}
    spills = any(r.get("spill_stores") or r.get("spill_loads") for r in report.values())
    if spills and allow_spill:
        print(f"variant {name} spills: {report}", flush=True)
    if (spills and not allow_spill) or any(launch_regs and r.get("registers") != launch_regs for r in report.values()):
        raise RuntimeError(f"variant {name} spills or does not launch at {launch_regs} registers: {report}")
    return ctypes.CDLL(str(lib_path))


def time_baseline(script: str, directory: str) -> dict:
    """``script``'s time_tree() run against the checkout in ``directory``, in a
    subprocess that imports that checkout's package (its wrappers and its
    kernels) and this module from this tree."""
    code = ("import importlib.util, json, runpy, sys; sys.path.insert(0, '.'); "
            f"name = 'cosmos_predict2_tpu_torch.scripts._kernel_variants'; "
            f"spec = importlib.util.spec_from_file_location(name, {str(Path(__file__).resolve())!r}); "
            "mod = sys.modules[name] = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod); "
            f"print(json.dumps(runpy.run_path({str(Path(script).resolve())!r})['time_tree']()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=directory, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"baseline in {directory} failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def finish(summary: dict, out: str | None) -> None:
    """Add the card's name and power limit to ``summary``, print it as one
    JSON line and, with ``out``, write it there too."""
    summary["device"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                       capture_output=True, text=True).stdout.strip()
    print(json.dumps(summary))
    if out:
        Path(out).write_text(json.dumps(summary, indent=1))
