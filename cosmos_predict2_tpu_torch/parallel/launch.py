"""Process-group launch: the counterpart of cosmos_predict2_tpu/parallel/launch.py.

One process drives one device. ``init_distributed`` reads torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or the JAX package's names ``COORDINATOR_ADDRESS``
(``host:port``), ``NUM_PROCESSES`` and ``PROCESS_ID``, and joins the
default process group: NCCL on ``cuda`` (after ``torch.cuda.set_device``
of the local rank), gloo only when the caller passes ``device="cpu"``.
NCCL never falls back to gloo. Without these variables the run is one
process with no process group, as JAX's auto-init leaves a single-host run;
a mesh that asks for more than one device then raises in
parallel/mesh.py::make_mesh.

    torchrun --nproc-per-node 4 -m cosmos_predict2_tpu_torch.scripts.interactive_latency --cp 4
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from cosmos_predict2_tpu_torch.utils import log


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def backend_for(device: torch.device | str) -> str:
    """NCCL for a CUDA device, gloo for the CPU; nothing else."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def init_distributed(
    device: torch.device | str = "cuda",
    init_method: Optional[str] = None,
    timeout_s: float = 600.0,
) -> dict:
    """Join the default process group from the environment; returns
    :func:`world_info`. A no-op when the group exists already, or when
    neither a world size nor ``init_method`` is given (one process).

    ``init_method`` overrides the address (for example ``file:///path`` for
    a FileStore); the rank and world size still come from the environment.
    """
    if dist.is_initialized():
        return world_info()
    world = _env_int("WORLD_SIZE", "NUM_PROCESSES")
    rank = _env_int("RANK", "PROCESS_ID")
    if world is None and init_method is None:
        log.info("single-process run: no WORLD_SIZE / NUM_PROCESSES in the environment")
        return world_info()
    if world is None or rank is None:
        raise ValueError(f"init_distributed: need both a rank and a world size, got rank={rank} world={world}")
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device 'cuda' asked for NCCL, but CUDA is not available")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(rank % torch.cuda.device_count() if local is None else local)
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        coordinator = os.environ.get("COORDINATOR_ADDRESS")
        if addr is None and coordinator:
            addr, _, port = coordinator.rpartition(":")
        if not addr or not port:
            raise ValueError("init_distributed: set MASTER_ADDR and MASTER_PORT (or COORDINATOR_ADDRESS=host:port)")
        init_method = f"tcp://{addr}:{port}"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    info = world_info()
    log.info(f"distributed ({backend}): process {info['process_index']}/{info['process_count']}, "
             f"{info['global_devices']} devices")
    return info


def init_single_process(device: torch.device | str) -> None:
    """A process group of this one process (an in-memory store), for a
    mesh of one device; the backend as :func:`init_distributed` picks it."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_info() -> dict:
    """The JAX package's keys: this process's index and the process count,
    and its devices (one per process) and the devices of the job."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return {"process_index": rank, "process_count": world, "local_devices": 1, "global_devices": world}
