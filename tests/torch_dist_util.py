"""Rank workers of the port's context-parallel and training-mesh tests: N gloo processes.

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
    return start_ranks(tmp_path, world, cases).results(timeout)


class Ranks:
    """``world`` started rank processes; :meth:`results` waits for them."""

    def __init__(self, work: Path, procs: list):
        self.work, self.procs, self._results = work, procs, None

    def results(self, timeout: float = 300.0) -> list[list]:
        if self._results is not None:
            return self._results
        logs = []
        try:
            for p in self.procs:  # one pipe at a time: a rank writes far less than a pipe holds
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(rank, p.returncode, out) for rank, (p, out) in enumerate(zip(self.procs, logs)) if p.returncode != 0]
        world = len(self.procs)
        if failed:  # every failed rank's tail: the first to fail need not be rank 0
            raise RuntimeError("\n".join(f"rank {rank} of {world} exited with {rc}:\n{out[-4000:]}"
                                         for rank, rc, out in failed))
        per_rank = [torch.load(self.work / f"result_{rank}.pt", weights_only=False) for rank in range(world)]
        n = len(per_rank[0])
        self._results = [[per_rank[rank][i] for rank in range(world)] for i in range(n)]
        return self._results


class NamedRanks:
    """Started ranks whose cases have names: ``ranks[name]`` waits for the
    processes at the first look and gives that case's per-rank results."""

    def __init__(self, names: list[str], ranks: Ranks):
        self.names, self.ranks = names, ranks

    def __getitem__(self, name: str) -> list:
        return dict(zip(self.names, self.ranks.results()))[name]


def start_ranks(tmp_path: Path, world: int, cases: list[tuple[str, dict]]) -> Ranks:
    """Start ``world`` gloo rank processes on ``cases`` and return at once;
    the caller may compute meanwhile and then wait in ``.results()``."""
    work = Path(tmp_path) / f"ranks_{world}"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(cases, work / "cases.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, __file__, str(work), str(rank), str(world)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    return Ranks(work, procs)


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


def _loss_backward(out: torch.Tensor, tgt=None, scale: float = 1.0) -> None:
    """Backward of this rank's share of a loss summed over the ranks."""
    loss = (out.pow(2) if tgt is None else (out - tgt).pow(2)).sum() * scale
    loss.backward()


def ring_grads(q, k, v, tgt, cp, frame_group=0):
    """(dq, dk, dv) shares of mean((ring(q, k, v) - tgt)^2) over the whole
    sequence on the first ``cp`` ranks, and the ring's sends in the forward
    and in the backward (None on the other ranks)."""
    from cosmos_predict2_tpu_torch.parallel.comm import COMM
    from cosmos_predict2_tpu_torch.parallel.ring_attention import ring_attention

    g = _cp_group(cp)
    if g is None:
        return None
    qs, ks, vs = (_shard(t, g).requires_grad_(True) for t in (q, k, v))
    with COMM.recording() as fwd:
        out = ring_attention(qs, ks, vs, g, frame_group=frame_group)
    with COMM.recording() as bwd:
        _loss_backward(out, _shard(tgt, g), 1.0 / tgt.size)
    return _np(qs.grad), _np(ks.grad), _np(vs.grad), list(fwd), list(bwd)


def ulysses_grads(q, frame_group=0, na=None):
    """The share of d/dq of sum(ulysses(q, q, q)^2) over the whole sequence,
    on 4 ranks (test_parallel.py:62's loss), dense or with ``na``."""
    from cosmos_predict2_tpu_torch.parallel.cp import ulysses_attention

    g = _cp_group(4)
    qs = _shard(q, g).requires_grad_(True)
    _loss_backward(ulysses_attention(qs, qs, qs, g, frame_group=frame_group, na=na))
    return _np(qs.grad)


def _full(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return _np(t.full_tensor() if isinstance(t, DTensor) else t)


def _mesh_model(cfg, state_dict, sizes, strategy="ulysses", trainable=True, state_t=2):
    """The tiny DiT holding ``state_dict``, trainable (or frozen),
    context-parallel over cp and sharded by parallelize on a (dp, fsdp, cp,
    tp) mesh of every rank, in a Video2WorldModel (of ``state_t`` latent
    frames); and the mesh."""
    import dataclasses

    from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
    from cosmos_predict2_tpu_torch.networks import dit
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize

    mesh = make_mesh(*sizes, device_type="cpu")
    cfg = dataclasses.replace(cfg, cp_strategy=strategy)
    net = dit.MiniTrainDIT(cfg)
    net.load_state_dict({n: _t(a) for n, a in state_dict.items()}, strict=True)
    net.train().requires_grad_(trainable)
    if mesh["cp"].size() > 1:
        dit.set_context_parallel(net, mesh.get_group("cp"))
    parallelize(net, mesh)
    return Video2WorldModel(RFModelConfig(net=cfg, state_t=state_t), net), mesh


def _rank_batches(batches, mesh):
    """(latents, condition) of this rank's rows of each (latents, text) global batch."""
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.training.trainer import data_shard

    index, count = data_shard(mesh)
    for latents, emb in batches:
        b = latents.shape[0] // count
        x0 = _t(latents[index * b:(index + 1) * b])
        yield x0, make_condition(_t(emb[index * b:(index + 1) * b])).replace(gt_frames=x0)


def _draws(d: dict):
    from cosmos_predict2_tpu_torch.models.video2world import TrainDraws

    return TrainDraws(**{n: None if a is None else _t(a) for n, a in d.items()})


class _Record:
    """A trainer callback keeping each step's global loss and grad norm."""

    def __init__(self):
        self.losses, self.norms = [], []

    def on_train_start(self, *a): ...

    def on_training_step_start(self, *a): ...

    def on_save_checkpoint(self, *a): ...

    def on_train_end(self, *a): ...

    def on_training_step_end(self, trainer, state, metrics, iteration):
        self.losses.append(float(metrics["loss"]))
        self.norms.append(float(metrics["grad_norm"]))


def mesh_train(cfg, state_dict, batches, draws, sizes, strategy="ulysses", optimizer=None, ckpt=None, state_t=2):
    """Trainer steps of the tiny DiT (one per batch, with EMA) on a mesh of
    ``sizes`` (dp, fsdp, cp, tp), fed the global draws ``draws[i]``: the
    per-step losses and grad norms, and on rank 0 the final parameters and
    EMA gathered whole. ``ckpt``: a directory to save the final state to."""
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    model, mesh = _mesh_model(cfg, state_dict, sizes, strategy, state_t=state_t)
    opt = optimizer or OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,))
    tc = TrainerConfig(max_iter=len(batches), logging_iter=100, save_iter=0, seed=0, ema_enabled=True, optimizer=opt)
    rec = _Record()
    trainer = Trainer(tc, model, callbacks=[rec], draw_fn=lambda it, x0: _draws(draws[it]))
    state = trainer.train(trainer.init_state(), _rank_batches(batches, mesh))
    if ckpt is not None:
        Checkpointer(ckpt).save(state, state.step)
    params = {n: _full(p) for n, p in state.params.items()}
    ema = {n: _full(p) for n, p in state.ema_params.items()}
    import torch.distributed as dist

    first = dist.get_rank() == 0
    return rec.losses, rec.norms, params if first else None, ema if first else None


def _optimizer_state_full(state) -> dict:
    """The optimizer's moments gathered whole, by parameter name."""
    names = {id(p): n for n, p in state.params.items()}
    return {f"{names[id(p)]}.{k}": _full(v) for p, st in state.optimizer.state.items() for k, v in st.items()
            if isinstance(v, torch.Tensor) and v.ndim > 0}


def dcp_roundtrip(cfg, state_dict, batches, draws, ckpt, save_sizes, load_sizes, optimizer=None):
    """Train one step on a mesh of ``save_sizes`` and save (DCP); then on a
    new mesh of ``load_sizes`` a fresh state (other weights) restored from
    it. Returns (saved, restored): each the state's step, parameters, EMA
    and optimizer moments gathered whole."""
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    opt = optimizer or OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,))
    tc = TrainerConfig(max_iter=1, logging_iter=100, save_iter=0, seed=0, ema_enabled=True, optimizer=opt)

    def snapshot(state):
        return {"step": state.step, "opt_step": state.opt_step,
                "params": {n: _full(p) for n, p in state.params.items()},
                "ema": {n: _full(p) for n, p in state.ema_params.items()},
                "moments": _optimizer_state_full(state), "lr": state.optimizer.param_groups[0]["lr"]}

    model, mesh = _mesh_model(cfg, state_dict, save_sizes)
    trainer = Trainer(tc, model, callbacks=[], draw_fn=lambda it, x0: _draws(draws[it]))
    state = trainer.train(trainer.init_state(), _rank_batches(batches[:1], mesh))
    Checkpointer(ckpt).save(state, state.step)
    saved = snapshot(state)
    other = {n: a + 1.0 for n, a in state_dict.items()}
    model2, _ = _mesh_model(cfg, other, load_sizes)
    trainer2 = Trainer(tc, model2, callbacks=[])
    ckpt2 = Checkpointer(ckpt)
    state2 = ckpt2.load(trainer2.init_state())
    return saved, snapshot(state2), ckpt2.latest_step()


def qwen_forward(cfg, state_dict, ids, sizes):
    """The Qwen LM's hidden states on a mesh of ``sizes``, sharded by
    parallelize, and the placements of its first layer's parameters (mesh
    dim names, placements)."""
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenLM

    lm = QwenLM(cfg)
    lm.load_state_dict({n: _t(a) for n, a in state_dict.items()}, strict=True)
    parallelize(lm, make_mesh(*sizes, device_type="cpu"))
    placements = {n: (p.device_mesh.mesh_dim_names, tuple(f"{type(x).__name__}({getattr(x, 'dim', '')})"
                                                           for x in p.placements))
                  for n, p in lm.named_parameters() if n.startswith("layers.0.")}
    with torch.no_grad():
        return [_np(h) for h in lm(torch.from_numpy(ids))], placements


def _set_whole(p: torch.Tensor, whole) -> None:
    """Write the whole tensor ``whole`` into ``p``: a plain tensor, or this
    rank's part of a DTensor (cut without communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    with torch.no_grad():
        if isinstance(p, DTensor):
            p.to_local().copy_(distribute_tensor(_t(whole), p.device_mesh, p.placements, src_data_rank=None).to_local())
        else:
            p.copy_(_t(whole))


def mesh_lora_train(cfg, state_dict, lora, batches, draws, sizes, strategy="ulysses", rank=4, alpha=8.0):
    """LoRA over the frozen tiny DiT on a mesh of ``sizes``: the net sharded
    by parallelize, then wrapped, the adapters set to ``lora`` (whole, by
    name) and trained one step per batch with EMA, fed the global draws.
    Returns the losses and grad norms, the adapters' placements, whether
    the base is bit-equal to ``state_dict`` after the steps, and on rank 0
    the adapters and their EMA gathered whole."""
    import torch.distributed as dist

    from cosmos_predict2_tpu_torch.training.lora import LoRAModelWrapper
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    model, mesh = _mesh_model(cfg, state_dict, sizes, strategy, trainable=False)
    wrapper = LoRAModelWrapper(model, rank=rank, alpha=alpha)
    adapters = wrapper.init_lora(torch.Generator().manual_seed(0))
    for name, p in adapters.items():
        _set_whole(p, lora[name])
    tc = TrainerConfig(max_iter=len(batches), logging_iter=100, save_iter=0, seed=0, ema_enabled=True,
                       optimizer=OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,)))
    rec = _Record()
    trainer = Trainer(tc, wrapper, callbacks=[rec], draw_fn=lambda it, x0: _draws(draws[it]))
    state = trainer.train(trainer.init_state(), _rank_batches(batches, mesh))
    base = all(np.array_equal(_full(p), state_dict[n]) for n, p in wrapper.net.named_parameters())
    placements = {n: tuple(str(x) for x in p.placements) for n, p in adapters.items() if n.startswith("blocks.0.")}
    params = {n: _full(p) for n, p in state.params.items()}  # every rank: full_tensor is a collective
    ema = {n: _full(p) for n, p in state.ema_params.items()}
    first = dist.get_rank() == 0
    return rec.losses, rec.norms, placements, base, params if first else None, ema if first else None


def mesh_lora_resume(cfg, state_dict, lora, batches, draws, sizes, ckpt, optimizer=None, rank=4, alpha=8.0):
    """LoRA on a mesh of ``sizes``: one step, a DCP save, then the rest of
    ``batches`` on the unbroken state and, on a fresh wrapper (the base
    and adapters drawn anew) restored from the save, the same steps.
    Returns, each gathered whole: the saved state's keys, and per run
    (unbroken, resumed) its losses after the save, adapters and EMA."""
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.lora import LoRAModelWrapper
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    opt = optimizer or OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,))
    tc = TrainerConfig(max_iter=len(batches), logging_iter=100, save_iter=0, seed=0, ema_enabled=True, optimizer=opt)

    def trainer_for(adapters_from):
        model, mesh = _mesh_model(cfg, state_dict, sizes, trainable=False)
        wrapper = LoRAModelWrapper(model, rank=rank, alpha=alpha)
        for name, p in wrapper.init_lora(torch.Generator().manual_seed(1)).items():
            if adapters_from is not None:
                _set_whole(p, adapters_from[name])
        rec = _Record()
        return Trainer(tc, wrapper, callbacks=[rec], draw_fn=lambda it, x0: _draws(draws[it])), rec, mesh

    import dataclasses

    trainer, rec, mesh = trainer_for(lora)
    trainer.config = dataclasses.replace(tc, max_iter=1)
    state = trainer.train(trainer.init_state(), _rank_batches(batches[:1], mesh))
    Checkpointer(ckpt).save(state, state.step)
    saved = sorted(state.state_dict())
    trainer.config = tc
    state = trainer.train(state, list(_rank_batches(batches, mesh))[1:], start_iteration=1)
    fresh, fresh_rec, _ = trainer_for(None)
    resumed = Checkpointer(ckpt).load(fresh.init_state())
    resumed = fresh.train(resumed, list(_rank_batches(batches, mesh))[1:], start_iteration=resumed.step)
    runs = []
    for st, losses in ((state, rec.losses[1:]), (resumed, fresh_rec.losses)):
        runs.append((losses, {n: _full(p) for n, p in st.params.items()},
                     {n: _full(p) for n, p in st.ema_params.items()}, st.step, st.opt_step))
    return saved, runs


def _wan_net(cfg, state_dict, sizes=None):
    """The Wan DiT holding ``state_dict`` (reference names, through the
    converter), sharded by parallelize on a mesh of ``sizes`` when given."""
    from cosmos_predict2_tpu_torch.networks.wan_dit import WanModel
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import convert_wan_dit_state_dict

    net = WanModel(cfg)
    net.load_state_dict(convert_wan_dit_state_dict({k: _t(v) for k, v in state_dict.items()}), strict=True)
    if sizes is not None:
        parallelize(net, make_mesh(*sizes, device_type="cpu"))
    return net


def wan_tp_forward(cfg, state_dict, inputs, sizes):
    """The Wan DiT (i2v) sharded by parallelize on a mesh of ``sizes``, its
    forward on the whole inputs (every rank), and the placements of its
    first block's q / norm_q / o / ffn weights."""
    net = _wan_net(cfg, state_dict, sizes)
    placements = {n: tuple(str(x) for x in p.placements) for n, p in net.named_parameters()
                  if n.startswith("blocks.0.") and n.endswith("weight")}
    with torch.no_grad():
        out = net(_t(inputs["x"]), _t(inputs["t"]), _t(inputs["ctx"]), y_B_C_T_H_W=_t(inputs["y"]),
                  frame_cond_crossattn_emb=_t(inputs["clip"]))
    return _np(out), placements


def _wan_model(cfg, state_dict, sizes=None):
    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel

    net = _wan_net(cfg, state_dict, sizes).train()
    return WanVideo2WorldModel(WanModelConfig(net=cfg, state_t=2), net)


def _wan_batches(batches, index: int = 0, count: int = 1):
    """(x0, i2v condition) of this rank's rows of each (x0, text, clip) global batch."""
    from cosmos_predict2_tpu_torch.models.wan_video2world import make_i2v_condition

    for x0, ctx, clip in batches:
        b = x0.shape[0] // count
        rows = slice(index * b, (index + 1) * b)
        x = _t(x0[rows])
        yield x, make_i2v_condition(_t(ctx[rows]), x, _t(clip[rows]))


def wan_train(cfg, state_dict, batches, sizes=None):
    """Trainer steps (one per batch, with EMA, the trainer's own draws) of
    the Wan Video2World model, sharded on a mesh of ``sizes`` or on one
    device: losses, grad norms, and on rank 0 the parameters gathered
    whole."""
    import torch.distributed as dist

    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig, data_shard

    model = _wan_model(cfg, state_dict, sizes)
    tc = TrainerConfig(max_iter=len(batches), logging_iter=100, save_iter=0, seed=0, ema_enabled=True,
                       optimizer=OptimizerConfig(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,)))
    rec = _Record()
    trainer = Trainer(tc, model, callbacks=[rec])
    mesh = getattr(model.net, "mesh", None)
    state = trainer.train(trainer.init_state(), _wan_batches(batches, *data_shard(mesh)))
    params = {n: _full(p) for n, p in state.params.items()}
    first = not dist.is_initialized() or dist.get_rank() == 0
    return rec.losses, rec.norms, params if first else None


def launch_run(overrides, ckpt_dir=None, resume_overrides=None):
    """training/train.py::launch of the mock-data smoke experiment with
    ``overrides`` on the CPU, its DiT computing in fp32 (the experiment's
    is bf16, whose matmuls round row blocks of other sizes otherwise): the
    global losses. ``resume_overrides``: then launch again from
    ``ckpt_dir`` with those, and append its losses."""
    import dataclasses

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.training.train import launch
    from cosmos_predict2_tpu_torch.training.trainer import Callback

    losses = []

    class Record(Callback):
        def on_training_step_end(self, trainer, state, metrics, iteration):
            losses.append(float(metrics["loss"]))

    for ov in [overrides] + ([resume_overrides] if resume_overrides else []):
        config = make_config("error-free_mock_data_smoke", ov)
        model = dataclasses.replace(config.model, net=dataclasses.replace(config.model.net, dtype=torch.float32))
        launch(dataclasses.replace(config, model=model), ckpt_dir=ckpt_dir, device="cpu", callbacks=[Record()])
    return losses


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

