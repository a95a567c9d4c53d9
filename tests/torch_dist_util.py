"""Rank workers of the port's context-parallel tests: N gloo processes.

Imports torch (and the port) only. :func:`run_ranks` writes a list of cases
(a worker's name and its keyword arguments: numpy arrays, configs, state
dicts) under a test's ``tmp_path``, starts ``world`` processes of this file
and returns, per case, the list of what each rank's worker returned. The
processes join one gloo group through a FileStore under ``tmp_path`` (no
ports), through the port's own ``parallel/launch.py::init_distributed``, and
run every case in order, so a test batches its cases into one start of
about 4 s.

Each worker takes whole inputs, cuts its rank's share itself (as a caller
of the port's CP routes does) and returns its rank's share of the result;
the tests assemble the shares in rank order.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def run_ranks(tmp_path: Path, world: int, cases: list[tuple[str, dict]], timeout: float = 300.0) -> list[list]:
    """Run ``cases`` on ``world`` gloo ranks; returns [case][rank] results.
    Raises with a rank's output when one fails."""
    work = Path(tmp_path) / f"ranks_{world}"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(cases, work / "cases.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, __file__, str(work), str(rank), str(world)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {world} exited with {p.returncode}:\n{out[-6000:]}")
    per_rank = [torch.load(work / f"result_{rank}.pt", weights_only=False) for rank in range(world)]
    return [[per_rank[rank][i] for rank in range(world)] for i in range(len(cases))]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _cp_group(cp: int):
    """A cp group of the first ``cp`` ranks (None on the others)."""
    import torch.distributed as dist

    if cp == dist.get_world_size():
        from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(1, 1, cp, 1, device_type="cpu").get_group("cp")
    group = dist.new_group(list(range(cp)))
    return group if dist.get_rank() < cp else None


def _shard(a, group, dim: int = 1) -> torch.Tensor:
    """This rank's equal share of ``a`` along ``dim`` (rank order is index order)."""
    import torch.distributed as dist

    return _t(a).chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


# ----------------------------------- workers -----------------------------------


def ulysses(q, k, v, frame_group=0, na=None):
    from cosmos_predict2_tpu_torch.parallel.cp import ulysses_attention

    g = _cp_group(4)
    return _np(ulysses_attention(_shard(q, g), _shard(k, g), _shard(v, g), g, frame_group=frame_group, na=na))


def kv_cache(q, k, v, k_buf, v_buf, fill, cache_window=None, record=False):
    """The head-sharded decode; returns (out share, k / v buffer shards, len, the comm records)."""
    from cosmos_predict2_tpu_torch.parallel.comm import COMM
    from cosmos_predict2_tpu_torch.parallel.cp import ulysses_kv_cache_attention

    g = _cp_group(4)
    cache = {"k": _shard(k_buf, g), "v": _shard(v_buf, g), "len": fill}
    with COMM.recording() as records:
        out, new = ulysses_kv_cache_attention(_shard(q, g), _shard(k, g), _shard(v, g), cache, g, cache_window)
    return _np(out), _np(new["k"]), _np(new["v"]), new["len"], list(records)


def ring(q, k, v, cp, frame_group=0):
    from cosmos_predict2_tpu_torch.parallel.ring_attention import ring_attention

    g = _cp_group(cp)
    if g is None:
        return None
    return _np(ring_attention(_shard(q, g), _shard(k, g), _shard(v, g), g, frame_group=frame_group))


def dit_forward(cfg, state_dict, x, t, ctx, fps=None):
    """The DiT forward under context parallelism over all ranks; every rank
    returns the whole (gathered) output."""
    from cosmos_predict2_tpu_torch.networks import dit

    net = dit.MiniTrainDIT(cfg)
    net.load_state_dict({n: _t(a) for n, a in state_dict.items()}, strict=True)
    dit.set_context_parallel(net, _cp_group(4))
    with torch.no_grad():
        return _np(net(_t(x), _t(t), _t(ctx), fps=None if fps is None else _t(fps)))


def stream(cfg, state_dict, emb, init, noise, num_latent_frames, cache_frames, num_steps, cp=True):
    """StreamingInference.generate of the causal net (fp32 caches) with the
    block noises ``noise`` [step] -> the latents, context-parallel over all
    ranks (each rank holds a head shard of every cache) or on one rank."""
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.models import interactive as tint
    from cosmos_predict2_tpu_torch.networks import dit

    net = dit.MiniTrainDIT(cfg)
    net.load_state_dict({n: _t(a) for n, a in state_dict.items()}, strict=True)
    if cp:
        dit.set_context_parallel(net, _cp_group(4))
    model = tint.CausalVideo2WorldModel(tint.causal_model_config(cfg), net)
    init_caches = model.init_kv_caches
    model.init_kv_caches = lambda *a, **kw: init_caches(*a, **kw, dtype=torch.float32)
    s = tint.StreamingInference(tint.StreamingConfig(cache_frame_size=cache_frames, num_steps=num_steps), model)
    heads = []
    out = s.generate(make_condition(_t(emb)), _t(init), num_latent_frames, init.shape[-2:],
                     draw=lambda step, shape: _t(noise[step]),
                     on_block=lambda step, x, caches: heads.append(caches[0]["k"].shape[1]))
    return _np(out), heads


def mesh_errors():
    """make_mesh's refusals, as (exception type, message)."""
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh

    got = []
    for kw in (dict(cp=4, pp=2), dict(cp=2)):
        try:
            make_mesh(device_type="cpu", **kw)
            got.append(None)
        except ValueError as e:
            got.append(str(e))
    mesh = make_mesh(1, 2, 2, 1, device_type="cpu")
    got.append((mesh.mesh_dim_names, mesh["cp"].size(), mesh["fsdp"].size()))
    return got


def halo_conv(x, weight, bias, strides, pads, cp=4):
    """conv3d_w_sharded (or 2D: len(strides) == 2) on W over cp ranks; the share of the output, or the
    error's message."""
    from cosmos_predict2_tpu_torch.parallel.halo_conv import conv_w_sharded

    g = _cp_group(cp)
    xs = _shard(x, g, dim=x.ndim - 2)
    try:
        out = conv_w_sharded(xs, _t(weight), None if bias is None else _t(bias), g, stride_w=strides[-1], pad_w=pads[-1],
                             other_strides=strides[:-1], other_pads=pads[:-1])
    except ValueError as e:
        return str(e)
    return _np(out)


def _vae(cfg, state_dict):
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE

    vae = WanVAE(cfg)
    vae.load_state_dict({n: _t(a) for n, a in state_dict.items()}, strict=True)
    return vae.eval()


def _grid():
    from cosmos_predict2_tpu_torch.parallel.halo_conv import SpatialGrid
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 2, 2, 1, device_type="cpu")
    return SpatialGrid(mesh.get_group("fsdp"), mesh.get_group("cp"))


def vae_sharded(cfg, state_dict, clip, z, streaming: bool, record=False):
    """The 2x2-sharded encode of ``clip`` and decode of ``z`` (H over fsdp,
    W over cp), one-shot or streaming; each gathered whole, and the
    decode's comm records."""
    from cosmos_predict2_tpu_torch.parallel.comm import COMM
    from cosmos_predict2_tpu_torch.tokenizers import wan_vae_streaming as wvs

    vae, grid = _vae(cfg, state_dict), _grid()
    enc = wvs.encode_streaming if streaming else wvs.encode_oneshot
    dec = wvs.decode_streaming if streaming else wvs.decode_oneshot
    got_z = grid.gather(enc(vae, grid.take(_t(clip)).contiguous(), grid=grid))
    with COMM.recording() as records:
        px = dec(vae, grid.take(_t(z)).contiguous(), grid=grid)
    return _np(got_z), _np(grid.gather(px)), list(records)


def _main(work: str, rank: int, world: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from cosmos_predict2_tpu_torch.parallel.launch import init_distributed, shutdown_distributed

    work = Path(work)
    init_distributed(device="cpu", init_method=f"file://{work / 'store'}")
    cases = torch.load(work / "cases.pt", weights_only=False)
    results = [globals()[name](**kwargs) for name, kwargs in cases]
    torch.save(results, work / f"result_{rank}.pt")
    shutdown_distributed()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
