"""The port's profiling and logging (utils/profiling.py, utils/log.py)
against the JAX package's: the profile window, a CPU trace written inside
it and nothing outside, the section timers on a frozen clock, the memory
report without CUDA (and its filtering with a stand-in), process-0
filtering of the log, and the modules whose JAX counterparts log through
utils.log doing so through the port's."""

import importlib
import json
import logging
import types

import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.utils import profiling as jprof
from cosmos_predict2_tpu_torch.utils import log, profiling


def test_profiling_config_and_window_equal_jax(monkeypatch, tmp_path):
    """Iterations 0-9: the port traces exactly where JAX's starts a trace."""
    import dataclasses

    assert dataclasses.asdict(profiling.ProfilingConfig()) == dataclasses.asdict(jprof.ProfilingConfig())
    started = []
    monkeypatch.setattr(jprof.jax.profiler, "start_trace", lambda d: started.append(d))
    monkeypatch.setattr(jprof.jax.profiler, "stop_trace", lambda: None)
    for enabled, skip, n in ((True, 2, 3), (True, 0, 1), (False, 0, 10)):
        cfg = dict(enabled=enabled, skip_first_n=skip, first_n_iterations=n, trace_dir=str(tmp_path / f"{skip}{n}"))
        port, ref = [], []
        for it in range(10):
            with profiling.maybe_enable_profiling(profiling.ProfilingConfig(**cfg), it, device="cpu") as active:
                port.append(active)
            with jprof.maybe_enable_profiling(jprof.ProfilingConfig(**cfg), it) as active:
                ref.append(active)
        assert port == ref and sum(port) == (n if enabled else 0)
    assert len(started) == 4


def test_cpu_trace_written_in_the_window_only(tmp_path):
    cfg = profiling.ProfilingConfig(enabled=True, skip_first_n=1, first_n_iterations=2, trace_dir=str(tmp_path))
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    for it in range(5):
        with profiling.maybe_enable_profiling(cfg, it, device="cpu"):
            (a @ a).sum()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["iteration_000001.json", "iteration_000002.json"]
    events = json.loads((tmp_path / "iteration_000001.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_cuda_device_without_cuda_raises(monkeypatch, tmp_path):
    """No quiet fallback: a CUDA device on a host without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = profiling.ProfilingConfig(enabled=True, skip_first_n=0, first_n_iterations=1, trace_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.maybe_enable_profiling(cfg, 0):
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.TrainingTimer()
    with profiling.maybe_enable_profiling(cfg, 5):  # outside the window nothing is asked of the device
        pass


class _Clock:
    """perf_counter stand-in: each reading advances by the next step."""

    def __init__(self, steps):
        self.now, self.steps = 0.0, iter(steps)

    def perf_counter(self):
        self.now += next(self.steps)
        return self.now


def test_training_timer_equals_jax(monkeypatch):
    steps = [0.0, 0.25, 1.0, 0.5, 2.0, 0.125, 3.0, 1.5] * 2
    port_clock, jax_clock = _Clock(steps), _Clock(steps)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=port_clock.perf_counter))
    monkeypatch.setattr(jprof, "time", types.SimpleNamespace(perf_counter=jax_clock.perf_counter))
    port, ref = profiling.TrainingTimer(device="cpu"), jprof.TrainingTimer()
    for timer in (port, ref):
        for name in ("data", "step", "data", "step"):
            with timer(name):
                pass
    assert port.summary() == ref.summary() == {"data": (0.25 + 0.125) / 2, "step": (0.5 + 1.5) / 2}
    assert dict(port.counts) == dict(ref.counts) == {"data": 2, "step": 2}
    port.reset()
    ref.reset()
    assert port.summary() == ref.summary() == {}


def test_device_memory_report(monkeypatch):
    assert not torch.cuda.is_available() and profiling.device_memory_report() == {}
    stats = {0: {"allocated_bytes.all.peak": 10, "num_alloc_retries": 2, "reserved_bytes.all.current": 30},
             1: {"allocated_bytes.all.peak": 5, "num_ooms": 0}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    assert profiling.device_memory_report() == {0: {"allocated_bytes.all.peak": 10, "reserved_bytes.all.current": 30},
                                                1: {"allocated_bytes.all.peak": 5}}


@pytest.mark.parametrize("rank", ["0", "1"])
def test_log_emits_on_process_0_unless_all_hosts(monkeypatch, caplog, rank):
    monkeypatch.setenv("RANK", rank)
    log.init()  # before caplog sets DEBUG: the first record would initialise at INFO
    with caplog.at_level(logging.DEBUG, logger="cosmos_predict2_tpu_torch"):
        log.info("only process 0")
        log.warning("every process", all_hosts=True)
        log.debug("debug on 0")
    got = [(r.levelname, r.getMessage(), r.filename) for r in caplog.records]
    everyone = [("WARNING", "every process", "test_torch_profiling.py")]
    if rank == "0":
        assert got == [("INFO", "only process 0", "test_torch_profiling.py"), *everyone,
                       ("DEBUG", "debug on 0", "test_torch_profiling.py")]
    else:
        assert got == everyone


def test_log_takes_the_process_group_rank(monkeypatch, caplog):
    import torch.distributed as dist

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    with caplog.at_level(logging.INFO, logger="cosmos_predict2_tpu_torch"):
        log.error("rank 3 is not process 0")
        log.critical("but this goes out", all_hosts=True)
    assert [r.getMessage() for r in caplog.records] == ["but this goes out"]


def test_log_prints_once_beside_a_root_handler(monkeypatch):
    """The logger's own stderr handler prints only while the root logger has
    no handler; after ``logging.basicConfig`` a record goes out once, by the
    root's."""
    log.init()
    (own,) = [h for h in logging.getLogger("cosmos_predict2_tpu_torch").handlers
              if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)]
    record = logging.LogRecord("cosmos_predict2_tpu_torch", logging.INFO, __file__, 1, "m", None, None)
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", [])
    assert own.filter(record)
    monkeypatch.setattr(root, "handlers", [logging.StreamHandler()])
    assert not own.filter(record)


# the port modules whose JAX counterparts log through cosmos_predict2_tpu.utils.log
LOGGING_MODULES = (
    "callbacks.callbacks", "data.augmentors", "data.loaders", "data.local_dataset", "data.native_tar",
    "inference.api", "inference.multiview", "inference.pipeline", "inference.serving", "text_encoders.t5",
    "text_encoders.text_encoder", "training.checkpointing", "training.distill_trainer", "training.trainer",
    "utils.blocklist", "utils.env_parsers", "utils.guardrails", "utils.native", "utils.profiling",
)


@pytest.mark.parametrize("name", LOGGING_MODULES)
def test_module_logs_through_the_port_log(name, monkeypatch):
    """The module's ``log`` is utils/log.py, so process-0 filtering holds
    for it; its JAX counterpart's is cosmos_predict2_tpu.utils.log."""
    port = importlib.import_module(f"cosmos_predict2_tpu_torch.{name}")
    ref = importlib.import_module(f"cosmos_predict2_tpu.{name}")
    assert port.log is log
    assert "cosmos_predict2_tpu.utils.log" in {getattr(v, "__name__", "") for v in vars(ref).values()} or \
        "from cosmos_predict2_tpu.utils import log" in open(ref.__file__).read()
