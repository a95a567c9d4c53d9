"""The port's built-in training callbacks (callbacks/callbacks.py) against
the JAX package's: tests/test_aux.py's callback cases (straggler detection,
the heartbeat, ``basic_callbacks``), tests/test_training.py's validation and
periodic-sample run through the port's Trainer, and each callback's own
behaviour: the device monitor (nothing without CUDA, as JAX's CPU devices
report nothing), manual GC, gradient-norm logging, the metrics' jsonl
fallback (no wandb on either machine) and a sample through the inference
pipeline. No numeric tolerance: the checks are exact.
"""

import gc
import json
import logging
import os
import time

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.callbacks import callbacks as jcb
from cosmos_predict2_tpu_torch.callbacks import callbacks as cb
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.data.mock import MockDataConfig, MockDataLoader
from cosmos_predict2_tpu_torch.inference import pipeline as tpipe
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, build_dit
from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig, build_vae
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.training.trainer import IterSpeedCallback, Trainer, TrainerConfig

NET = DiTConfig(model_channels=128, num_heads=1, num_blocks=1, adaln_lora_dim=16, crossattn_emb_channels=64,
                dtype=torch.float32, remat="none")
LATENT = (1, 16, 2, 4, 4)


def _trainer(max_iter=2, **tk):
    """tests/test_training.py's _make_trainer on a one-block net."""
    model = Video2WorldModel(RFModelConfig(net=NET, state_t=2), build_dit(NET, "cpu", seed=0, trainable=True))
    tc = TrainerConfig(max_iter=max_iter, logging_iter=1, save_iter=0, seed=0,
                       optimizer=OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,)), **tk)
    return Trainer(tc, model)


def _batches(n, seed=0):
    """Mock text, random latents (tests/test_training.py's _batches)."""
    loader = MockDataLoader(MockDataConfig(batch_size=1, num_frames=2, height=16, width=16, seed=seed))
    for i in range(n):
        batch = loader.get_batch(i)
        latents = torch.from_numpy(np.random.RandomState(i).randn(*LATENT).astype(np.float32))
        emb = torch.from_numpy(batch["t5_text_embeddings"][:, :8] * np.float32(0.02))[..., :64]
        yield latents, tcond.make_condition(emb).replace(gt_frames=latents)


def test_same_callbacks_as_jax():
    """The port's module holds the JAX module's callbacks (its public names),
    and basic_callbacks is the same group of the same kinds."""
    public = lambda m: {n for n in vars(m) if not n.startswith("_") and callable(getattr(m, n))  # noqa: E731
                        and getattr(getattr(m, n), "__module__", "") == m.__name__}
    assert public(jcb) <= public(cb)
    assert [type(c).__name__ for c in cb.basic_callbacks()] == [type(c).__name__ for c in jcb.basic_callbacks()]
    assert len(cb.basic_callbacks()) == 4


def test_straggler_detection_raises():
    """tests/test_aux.py's case: after 12 fast steps, two slow ones in a
    row raise."""
    det = cb.StragglerDetection(max_ratio=1.5, threshold_count=2, enabled=True)
    for _ in range(12):
        det.on_training_step_start(None, None, None, 0)
        det.window.append(0.01)
    with pytest.raises(RuntimeError, match="straggler"):
        for _ in range(3):
            det.on_training_step_start(None, None, None, 0)
            time.sleep(0.05)
            det.on_training_step_end(None, None, {}, 0)


def test_straggler_detection_disabled_only_warns_and_resets(caplog):
    det = cb.StragglerDetection(max_ratio=1.5, threshold_count=2, enabled=False)
    det.window.extend([0.01] * 12)
    with caplog.at_level(logging.WARNING, logger="cosmos_predict2_tpu_torch"):
        for _ in range(3):
            det.on_training_step_start(None, None, None, 0)
            time.sleep(0.05)
            det.on_training_step_end(None, None, {}, 0)
    assert det._count == 3 and sum("slow step" in r.message for r in caplog.records) == 3
    det.window.clear()
    det.window.extend([1.0] * 12)
    det.on_training_step_start(None, None, None, 0)
    det.on_training_step_end(None, None, {}, 0)
    assert det._count == 0


def test_heartbeat_writes_iteration_and_time(tmp_path):
    hb = cb.HeartBeat(path=str(tmp_path / "hb.json"), every_n=2)
    hb.on_training_step_end(None, None, {}, 1)
    assert not os.path.exists(tmp_path / "hb.json")
    hb.on_training_step_end(None, None, {}, 2)
    beat = json.loads((tmp_path / "hb.json").read_text())
    assert beat["iteration"] == 2 and abs(beat["timestamp"] - time.time()) < 60


def test_device_monitor_reports_nothing_without_cuda(caplog, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.INFO, logger="cosmos_predict2_tpu_torch"):
        cb.DeviceMonitor(every_n=1).on_training_step_end(None, None, {}, 1)
    assert not caplog.records


def test_device_monitor_reads_each_cuda_device(caplog, monkeypatch):
    """On the card: torch.cuda.memory_allocated and max_memory_reserved
    against the device's memory (stood in for here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: (d + 1) * 1e9)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda d: 3e9)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: type("P", (), {"total_memory": 80e9})())
    with caplog.at_level(logging.INFO, logger="cosmos_predict2_tpu_torch"):
        cb.DeviceMonitor(every_n=5).on_training_step_end(None, None, {}, 5)
    assert [r.message for r in caplog.records] == [
        "[device 0] memory 1.00/80.00 GB allocated, peak reserved 3.00 GB",
        "[device 1] memory 2.00/80.00 GB allocated, peak reserved 3.00 GB"]


def test_manual_gc_disables_the_collector_and_collects_every_n(monkeypatch):
    collected = []
    monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or 0)
    try:
        m = cb.ManualGC(every_n=3)
        assert not gc.isenabled()
        for it in range(1, 7):
            m.on_training_step_end(None, None, {}, it)
        assert collected == [1, 1]
    finally:
        gc.enable()


def test_grad_norm_logger(caplog):
    with caplog.at_level(logging.INFO, logger="cosmos_predict2_tpu_torch"):
        cb.GradNormLogger(every_n=2).on_training_step_end(None, None, {"grad_norm": torch.tensor(1.5)}, 2)
        cb.GradNormLogger(every_n=2).on_training_step_end(None, None, {"grad_norm": torch.tensor(9.0)}, 3)
        cb.GradNormLogger(every_n=1).on_training_step_end(None, None, {"loss": 1.0}, 3)
    assert [r.message for r in caplog.records] == ["Iteration 2: grad_norm 1.5000"]


def test_metrics_fall_back_to_jsonl(tmp_path, monkeypatch):
    """Without wandb (neither machine has it) each Nth step's scalar
    metrics are appended as one JSON line; tensors and arrays that are not
    scalars are left out."""
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    path = tmp_path / "m" / "metrics.jsonl"
    logger = cb.WandbLogger(every_n=2, jsonl_path=str(path))
    assert logger._wandb is None
    for it in (1, 2, 4):
        logger.on_training_step_end(None, None, {"loss": torch.tensor(0.5 * it), "grad_norm": np.float32(2.0),
                                                 "per_instance_loss": torch.ones(2)}, it)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines == [{"loss": 1.0, "grad_norm": 2.0, "iteration": 2}, {"loss": 2.0, "grad_norm": 2.0, "iteration": 4}]


def test_validation_and_sample_callback(tmp_path):
    """tests/test_training.py's case through the port's Trainer: 2
    iterations with validation at 2 and a sample every iteration, saved as
    iter_* files."""
    trainer = _trainer(max_iter=2, validation_iter=2)
    sample = cb.EveryNDrawSample(lambda st, it: np.zeros((2, 8, 8, 3), dtype=np.float32), out_dir=str(tmp_path),
                                 every_n=1)
    trainer.callbacks.callbacks.append(sample)
    state = trainer.train(trainer.init_state(), _batches(2), val_batches=list(_batches(2, seed=9)))
    assert state.step == 2
    assert sorted(f.split(".")[0] for f in os.listdir(tmp_path)) == ["iter_0000001", "iter_0000002"]


def test_basic_callbacks_drive_the_trainer(tmp_path, monkeypatch):
    """basic_callbacks handed to the Trainer, as the JAX group is: the
    iteration log, the heartbeat (in the working directory's outputs/),
    the device monitor and the (disabled) straggler detection all run."""
    monkeypatch.chdir(tmp_path)
    model = _trainer().model
    trainer = Trainer(TrainerConfig(max_iter=2, logging_iter=1, save_iter=0,
                                    optimizer=OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,))),
                      model, callbacks=cb.basic_callbacks(logging_iter=1))
    assert isinstance(trainer.callbacks.callbacks[0], IterSpeedCallback)
    trainer.train(trainer.init_state(), _batches(2))
    assert json.loads((tmp_path / "outputs" / "heartbeat.json").read_text())["iteration"] == 2
    assert len(trainer.callbacks.callbacks[3].window) == 2


def test_every_n_draw_sample_through_the_pipeline(tmp_path):
    """pipeline_sample_fn: a request through Video2WorldInference built
    over the trained net (a one-block DiT and a dim-16 VAE on seeded
    weights), 2 steps at 32 x 32, written as the iteration's clip; the
    sample follows the weights the trainer changes."""
    trainer = _trainer(max_iter=2)
    vae = build_vae(WanVAEConfig(dim=16, dtype=torch.float32), "cpu", seed=1)
    setup = tpipe.InferenceSetup(model_config=RFModelConfig(net=NET, state_t=2, sampling_num_steps=2),
                                 vae_config=vae.config, size_override=(32, 32))
    pipe = tpipe.Video2WorldInference(setup, trainer.model.net, vae)
    video = np.random.default_rng(0).integers(0, 256, (1, 3, 5, 32, 32), dtype=np.uint8)
    emb = next(_batches(1))[1].crossattn_emb
    frames = []
    fn = cb.pipeline_sample_fn(pipe, video, emb, num_steps=2, guidance=2.0, seed=3)
    trainer.callbacks.callbacks.append(cb.EveryNDrawSample(lambda st, it: frames.append(fn(st, it)) or frames[-1],
                                                           out_dir=str(tmp_path), every_n=1))
    trainer.train(trainer.init_state(), _batches(2))
    assert [f.shape for f in frames] == [(5, 32, 32, 3)] * 2 and all(np.isfinite(f).all() for f in frames)
    assert not np.array_equal(frames[0], frames[1])
    assert sorted(f.split(".")[0] for f in os.listdir(tmp_path)) == ["iter_0000001", "iter_0000002"]
