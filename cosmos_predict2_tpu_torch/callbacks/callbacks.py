"""Built-in training callbacks: observability, liveness, health.

Counterpart of cosmos_predict2_tpu/callbacks/callbacks.py (the reference's
callback suite, imaginaire/utils/callback.py and predict2/callbacks/):
EveryN and its heartbeat file, device memory, manual garbage collection,
gradient-norm logging, step-time straggler detection, metric logging (to
Weights & Biases when it is installed and keyed, else a jsonl file) and
periodic samples, and :func:`basic_callbacks`, the reference's "basic"
group, which a caller hands to training/trainer.py's ``Trainer``.

Device memory comes from ``torch.cuda``'s allocator statistics where the
JAX package reads each device's ``memory_stats()``; with no CUDA device
there is nothing to report, as JAX's CPU devices report nothing.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.training.trainer import Callback, IterSpeedCallback

log = logging.getLogger("cosmos_predict2_tpu_torch")


class EveryN(Callback):
    """Base class: fires ``every_n_impl`` every N training steps."""

    def __init__(self, every_n: int, step_size: int = 1):
        self.every_n = every_n
        self.step_size = step_size

    def on_training_step_end(self, trainer, state, metrics, iteration):
        if iteration % (self.every_n * self.step_size) == 0:
            self.every_n_impl(trainer, state, metrics, iteration)

    def every_n_impl(self, trainer, state, metrics, iteration):
        raise NotImplementedError


class HeartBeat(EveryN):
    """Writes a liveness file: the iteration and a timestamp."""

    def __init__(self, path: str = "outputs/heartbeat.json", every_n: int = 10):
        super().__init__(every_n)
        self.path = path

    def every_n_impl(self, trainer, state, metrics, iteration):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"iteration": iteration, "timestamp": time.time()}, f)


class DeviceMonitor(EveryN):
    """Logs each CUDA device's memory: allocated and the peak reserved
    against its capacity. Without CUDA it logs nothing."""

    def __init__(self, every_n: int = 100):
        super().__init__(every_n)

    def every_n_impl(self, trainer, state, metrics, iteration):
        if not torch.cuda.is_available():
            return
        for dev in range(torch.cuda.device_count()):
            used = torch.cuda.memory_allocated(dev) / 1e9
            peak = torch.cuda.max_memory_reserved(dev) / 1e9
            limit = torch.cuda.get_device_properties(dev).total_memory / 1e9
            log.info(f"[device {dev}] memory {used:.2f}/{limit:.2f} GB allocated, peak reserved {peak:.2f} GB")


class ManualGC(EveryN):
    """Turns the cycle collector off and collects every N steps, at the
    same step on every process."""

    def __init__(self, every_n: int = 1000):
        super().__init__(every_n)
        gc.disable()

    def every_n_impl(self, trainer, state, metrics, iteration):
        gc.collect()


class GradNormLogger(EveryN):
    def every_n_impl(self, trainer, state, metrics, iteration):
        if "grad_norm" in metrics:
            log.info(f"Iteration {iteration}: grad_norm {float(metrics['grad_norm']):.4f}")


class StragglerDetection(Callback):
    """Step-time straggler detection: the step's wall time against the
    trailing median of ``window`` steps. After ``threshold_count``
    consecutive steps slower than ``max_ratio`` x the median it raises
    (when ``enabled``), turning persistent slowness into a failure."""

    def __init__(self, window: int = 50, max_ratio: float = 2.0, threshold_count: int = 10, enabled: bool = True):
        self.window = deque(maxlen=window)
        self.max_ratio = max_ratio
        self.threshold_count = threshold_count
        self.enabled = enabled
        self._last = None
        self._count = 0

    def on_training_step_start(self, trainer, state, batch, iteration):
        self._last = time.perf_counter()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        if self._last is None:
            return
        dt = time.perf_counter() - self._last
        if len(self.window) >= 10:
            median = float(np.median(self.window))
            if dt > self.max_ratio * median:
                self._count += 1
                log.warning(f"slow step {iteration}: {dt:.2f}s vs median {median:.2f}s ({self._count})")
                if self.enabled and self._count >= self.threshold_count:
                    raise RuntimeError(
                        f"straggler detected: {self._count} consecutive steps > {self.max_ratio}x median"
                    )
            else:
                self._count = 0
        self.window.append(dt)


def _scalar(v) -> Optional[float]:
    """A metric's value as a float when it is a scalar, else None."""
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return float(a) if a.ndim == 0 else None


class WandbLogger(Callback):
    """Scalar metrics every N steps to Weights & Biases when ``wandb`` is
    installed and ``WANDB_API_KEY`` is set, else appended as one JSON line
    each to ``jsonl_path``."""

    def __init__(self, every_n: int = 10, jsonl_path: str = "outputs/metrics.jsonl", project: str = "cosmos_tpu"):
        self.every_n = every_n
        self.jsonl_path = jsonl_path
        self._wandb = None
        try:
            import wandb  # noqa

            if os.environ.get("WANDB_API_KEY"):
                self._wandb = wandb
                self._wandb.init(project=project)
        except ImportError:
            pass

    def on_training_step_end(self, trainer, state, metrics, iteration):
        if iteration % self.every_n != 0:
            return
        scalars = {k: s for k, s in ((k, _scalar(v)) for k, v in metrics.items()) if s is not None}
        scalars["iteration"] = iteration
        if self._wandb is not None:
            self._wandb.log(scalars, step=iteration)
        else:
            os.makedirs(os.path.dirname(os.path.abspath(self.jsonl_path)), exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(scalars) + "\n")


class EveryNDrawSample(EveryN):
    """Periodic samples during training: ``generate_fn(state, iteration)``
    gives frames (T, H, W, 3), float in [-1, 1] or uint8 (None skips), saved
    as ``out_dir/iter_{iteration:07d}`` (utils/io.py). :func:`pipeline_sample_fn`
    makes a ``generate_fn`` that samples through the inference pipeline."""

    def __init__(self, generate_fn: Callable, out_dir: str = "outputs/samples", every_n: int = 500):
        super().__init__(every_n)
        self.generate_fn = generate_fn
        self.out_dir = out_dir

    def every_n_impl(self, trainer, state, metrics, iteration):
        from cosmos_predict2_tpu_torch.utils.io import save_img_or_video

        frames = self.generate_fn(state, iteration)
        if frames is not None:
            path = save_img_or_video(np.asarray(frames), os.path.join(self.out_dir, f"iter_{iteration:07d}"), fps=16)
            log.info(f"sample at iteration {iteration} -> {path}")


def pipeline_sample_fn(pipeline, video_u8: np.ndarray, text_emb, **request) -> Callable:
    """A ``generate_fn`` for :class:`EveryNDrawSample`: one request through
    ``pipeline`` (inference/pipeline.py::Video2WorldInference built over the
    trained net, so it samples the current weights), ``generate_vid2world``
    on ``video_u8`` (1, 3, T, H, W) and ``text_emb`` with ``request``'s
    arguments (guidance, num_steps, seed ...)."""

    def generate(state, iteration):
        return pipeline.generate_vid2world(video_u8, text_emb, **request)

    return generate


def basic_callbacks(logging_iter: int = 10) -> list[Callback]:
    """The reference's "basic" callback group."""
    return [
        IterSpeedCallback(logging_iter),
        HeartBeat(every_n=max(1, logging_iter)),
        DeviceMonitor(every_n=100),
        StragglerDetection(enabled=False),
    ]
