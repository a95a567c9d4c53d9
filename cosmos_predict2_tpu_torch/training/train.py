"""Training entry point of the PyTorch port.

    python -m cosmos_predict2_tpu_torch.training.train \\
        --experiment=predict2_video2world_2b_rectified_flow [--dryrun] [--ckpt_dir DIR] [--device cpu] key=value ...

Post-training on a folder of one's own clips (docs/post_training.md), with
LoRA or in full:

    python -m cosmos_predict2_tpu_torch.training.train \\
        --experiment=predict2_lora_training_2b_cosmos_nemo_assets data_train=local_video data_train.root=DIR

On a mesh, one process per device (NCCL on the card, gloo with --device cpu):

    torchrun --nproc-per-node 4 -m cosmos_predict2_tpu_torch.training.train \
        --experiment=predict2_video2world_2b_rectified_flow fsdp_shard_size=2 cp_size=2

Counterpart of cosmos_predict2_tpu/training/train.py: the composed config;
the (dp, fsdp, cp, tp) mesh over the process group (:func:`dp_size`:
dp is what the world size leaves, shrunk until the global batch divides
over dp x fsdp); a DiT with seeded random weights, trained in full or, with
``model.use_lora``, frozen under LoRA adapters (training/lora.py) that are
then all the trainer updates, averages and checkpoints; on a mesh the net
is context-parallel over cp (networks/dit.py::set_context_parallel) and
sharded by parallel/mesh.py::parallelize; the Wan2.1 VAE on seeded random
weights; batches from the data config's type (mock clips, or
data/local_dataset.py's folder with ``data_train=local_video``), each
rank's rows of the global batch encoded through the exact streaming VAE
encode (no gradient); and the trainer, resumed from the latest checkpoint
of ``--ckpt_dir`` when there is one. Runs on CUDA unless ``--device cpu``
is given. COSMOS_SMOKE=1 shrinks the run to 2 iterations without
checkpoints. One process with every mesh size 1 and no process group takes
the one-device route (no sharding); under torchrun, a group even of one
process, the mesh route. ``pp_size`` > 1 raises as in
parallel/mesh.py::make_mesh. LoRA on a mesh follows JAX's order: the
frozen net is sharded first, then wrapped, and every rank draws the
adapters from the same generator (training/lora.py):

    torchrun --nproc-per-node 4 -m cosmos_predict2_tpu_torch.training.train \
        --experiment=predict2_lora_training_2b_cosmos_nemo_assets data_train=local_video data_train.root=DIR \
        fsdp_shard_size=2 tp_size=2
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Optional

import torch
import torch.distributed as dist


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="cosmos_predict2_tpu_torch trainer")
    parser.add_argument("--experiment", type=str, default="predict2_video2world_2b_rectified_flow")
    parser.add_argument("--dryrun", action="store_true", help="validate the config and exit")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="torch device; the CPU only when asked for (cpu)")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides key=value")
    return parser.parse_args(argv)


def make_loader(data_config):
    """The loader for the data config's type: the local folder of clips or
    mock data (the JAX package's dispatch)."""
    from cosmos_predict2_tpu_torch.data.local_dataset import LocalVideoDataset, LocalVideoDatasetConfig
    from cosmos_predict2_tpu_torch.data.mock import MockDataLoader

    if isinstance(data_config, LocalVideoDatasetConfig):
        return LocalVideoDataset(data_config)
    return MockDataLoader(data_config)


def dp_size(world: int, batch: int, fsdp: int, cp: int, tp: int) -> int:
    """dp of the training mesh, as the JAX package's ``launch`` picks it:
    the world size over fsdp x cp x tp, shrunk until the global ``batch``
    splits over dp x fsdp (its message when it cannot). Here every process
    drives one device of the mesh, so a dp that leaves processes out
    raises."""
    shard = fsdp * cp * tp
    dp = max(1, world // shard)
    while dp > 1 and batch % (dp * fsdp) != 0:
        dp -= 1
    if batch % (dp * fsdp) != 0:
        raise ValueError(f"batch_size {batch} not divisible by dp*fsdp = {dp * fsdp}")
    if dp * shard != world:
        raise ValueError(f"mesh dp={dp} x fsdp={fsdp} x cp={cp} x tp={tp} = {dp * shard} devices, but {world} "
                         f"processes: launch {dp * shard}, or a batch size that splits over more")
    return dp


def latent_batches(loader, vae, device: torch.device, rows: tuple[int, int] = (0, 1)):
    """Endless (latents (B, C, T, H, W) fp32, condition) batches: the
    loader's clips encoded by the exact streaming VAE encode under no_grad,
    with their text embeddings and fps. ``rows`` = (index, count): this
    rank's share of each global batch, the index-th of count equal row
    shards (trainer.py::data_shard)."""
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming

    index, count = rows
    for batch in loader:
        if count > 1:
            b = batch["video"].shape[0] // count
            batch = {k: v[index * b:(index + 1) * b] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}
        clip = torch.from_numpy(batch["video"]).to(device).permute(0, 2, 3, 4, 1)  # (B, T, H, W, 3) uint8
        with torch.no_grad():
            latents = encode_streaming(vae, clip, pixel_format="uint8")
        latents = latents.permute(0, 4, 1, 2, 3).float()  # (B, C, T, H, W)
        cond = make_condition(
            torch.from_numpy(batch["t5_text_embeddings"]).to(device), fps=torch.from_numpy(batch["fps"]).to(device)
        ).replace(gt_frames=latents)
        yield latents, cond


def launch(config, ckpt_dir: Optional[str] = None, device: str = "cuda", callbacks: Optional[list] = None):
    """Train ``config`` on ``device``; returns the final TrainState. Extra
    ``callbacks`` run after the trainer's own logging callback."""
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit, set_context_parallel
    from cosmos_predict2_tpu_torch.parallel.launch import init_distributed
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.lora import LoRAModelWrapper, count_lora_params
    from cosmos_predict2_tpu_torch.training.trainer import IterSpeedCallback, Trainer, data_shard
    from cosmos_predict2_tpu_torch.utils import log
    from cosmos_predict2_tpu_torch.utils.flags import SMOKE

    device = torch.device(device)
    if config.pp_size != 1:
        make_mesh(pp=config.pp_size, device_type=device.type)  # raises: no pipeline schedule
    fsdp, cp, tp = config.fsdp_shard_size, config.cp_size, config.tp_size
    world = init_distributed(device=device)["process_count"]
    mesh = None
    if dist.is_initialized() or fsdp * cp * tp > 1:
        dp = dp_size(world, config.data_train.batch_size, fsdp, cp, tp)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # init_distributed set this rank's card
        mesh = make_mesh(dp, fsdp, cp, tp, device_type=device.type)
        log.info(f"mesh: dp={dp} fsdp={fsdp} cp={cp} tp={tp}")
    trainer_cfg = config.trainer
    if SMOKE:
        trainer_cfg = dataclasses.replace(trainer_cfg, max_iter=2, logging_iter=1, save_iter=0)

    model_cfg = config.model
    net = build_dit(model_cfg.net, device, seed=trainer_cfg.seed, trainable=not model_cfg.use_lora)
    if mesh is not None:
        if cp > 1:
            set_context_parallel(net, mesh.get_group("cp"))
        parallelize(net, mesh)
    model = Video2WorldModel(model_cfg, net)
    if model_cfg.use_lora:
        # the base stays frozen; the adapters are the trainable (and checkpointed) state
        model = LoRAModelWrapper(model, rank=model_cfg.lora_rank, alpha=model_cfg.lora_alpha,
                                 targets=model_cfg.lora_targets)
        adapters = model.init_lora(torch.Generator(device).manual_seed(trainer_cfg.seed + 2))
        log.info(f"LoRA rank {model_cfg.lora_rank}: {count_lora_params(adapters):,} trainable params on {device}")
    else:
        log.info(f"DiT {sum(p.numel() for p in net.parameters()) / 1e9:.3f} B trainable params on {device}")
    vae = build_vae(config.tokenizer, device, seed=trainer_cfg.seed + 1)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    trainer = Trainer(trainer_cfg, model, callbacks=[IterSpeedCallback(trainer_cfg.logging_iter), *(callbacks or [])],
                      checkpointer=ckpt)
    state = trainer.init_state()
    start_iteration = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.load(state)
        start_iteration = state.step
        log.info(f"resumed from iteration {start_iteration}")

    batches = latent_batches(make_loader(config.data_train), vae, device, rows=data_shard(mesh))
    return trainer.train(state, batches, start_iteration=start_iteration)


def main(argv=None, callbacks: Optional[list] = None) -> int:
    """The command line; ``callbacks`` go to :func:`launch`."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s|%(levelname)s] %(message)s")
    from cosmos_predict2_tpu_torch.configs.defaults import make_config

    config = make_config(args.experiment, args.overrides)
    if args.dryrun:
        from cosmos_predict2_tpu_torch.utils import log

        log.info(f"config OK:\n{config}")
        return 0
    from cosmos_predict2_tpu_torch.parallel.launch import shutdown_distributed

    try:
        state = launch(config, ckpt_dir=args.ckpt_dir, device=args.device, callbacks=callbacks)
    finally:
        shutdown_distributed()
    print(f"trained {state.step} iterations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
