"""Profiling: a device trace over a window of iterations, a memory report
and section timers.

The port's counterpart of cosmos_predict2_tpu/utils/profiling.py, which
replaced the reference's torch.profiler + CUDA memory wrappers
(imaginaire/utils/profiling.py:36-120) with ``jax.profiler``; here they are
``torch.profiler`` again:

* ``maybe_enable_profiling(config, iteration, device)`` traces the host
  and, on a CUDA device, the card (CUPTI) while ``skip_first_n <= iteration
  < skip_first_n + first_n_iterations``, and writes a Chrome trace
  ``iteration_<N>.json`` into ``config.trace_dir`` (chrome://tracing or
  Perfetto read it);
* ``device_memory_report()`` the byte counters of ``torch.cuda.memory_stats``
  per device;
* ``TrainingTimer`` named section timers (reference ``misc.TrainingTimer``);
  given a CUDA device it synchronises it at each section's end, so that a
  section's time is the card's and not the launch queue's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import torch

from cosmos_predict2_tpu_torch.utils import log


@dataclasses.dataclass(frozen=True)
class ProfilingConfig:
    enabled: bool = False
    first_n_iterations: int = 5
    skip_first_n: int = 2
    trace_dir: str = "outputs/profile"


def _cuda_device(device: torch.device | str) -> torch.device | None:
    """The CUDA device ``device`` names, or None for the CPU; a CUDA device
    without CUDA raises (no quiet fallback to the host)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch finds no CUDA device; pass device='cpu' for "
                           "the host")
    return device


@contextlib.contextmanager
def maybe_enable_profiling(config: ProfilingConfig, iteration: int = 0, device: torch.device | str = "cuda"):
    """Trace this iteration when it lies in the configured window; yields
    whether it does. The trace covers the host (CPU activities) and, for a
    CUDA ``device``, the card's kernels."""
    active = config.enabled and config.skip_first_n <= iteration < config.skip_first_n + config.first_n_iterations
    prof = None
    if active:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if _cuda_device(device) is not None:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(config.trace_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    try:
        yield active
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(config.trace_dir, f"iteration_{iteration:06d}.json")
            prof.export_chrome_trace(path)
            log.info(f"profile trace written to {path}")


def device_memory_report() -> dict[int, dict]:
    """{device index: {counter: value}} for the counters of
    ``torch.cuda.memory_stats`` that count bytes; {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {i: {k: v for k, v in torch.cuda.memory_stats(i).items() if "bytes" in k}
            for i in range(torch.cuda.device_count())}


class TrainingTimer:
    """Named section timers (reference misc.TrainingTimer): accumulates
    wall time per section across iterations. On a CUDA ``device`` each
    section ends with a synchronise of that device."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = _cuda_device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        yield
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.totals[name] += time.perf_counter() - start
        self.counts[name] += 1

    def summary(self) -> dict[str, float]:
        return {k: self.totals[k] / max(1, self.counts[k]) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
