"""Training entry point of the PyTorch port.

    python -m cosmos_predict2_tpu_torch.training.train \\
        --experiment=predict2_video2world_2b_rectified_flow [--dryrun] [--ckpt_dir DIR] [--device cpu] key=value ...

Post-training on a folder of one's own clips (docs/post_training.md), with
LoRA or in full:

    python -m cosmos_predict2_tpu_torch.training.train \\
        --experiment=predict2_lora_training_2b_cosmos_nemo_assets data_train=local_video data_train.root=DIR

Counterpart of cosmos_predict2_tpu/training/train.py on one device: the
composed config; a DiT with seeded random weights, trained in full or, with
``model.use_lora``, frozen under LoRA adapters (training/lora.py) that are
then all the trainer updates, averages and checkpoints; the Wan2.1 VAE on
seeded random weights; batches from the data config's type (mock clips, or
data/local_dataset.py's folder with ``data_train=local_video``), each
encoded through the exact streaming VAE encode (no gradient); and the
trainer, resumed from the latest checkpoint of ``--ckpt_dir`` when there is
one. Runs on CUDA unless ``--device cpu`` is given. COSMOS_SMOKE=1 shrinks
the run to 2 iterations without checkpoints. The mesh (fsdp, cp, tp) is not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import Optional

import torch


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


def latent_batches(loader, vae, device: torch.device):
    """Endless (latents (B, C, T, H, W) fp32, condition) batches: the
    loader's clips encoded by the exact streaming VAE encode under no_grad,
    with their text embeddings and fps."""
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming

    for batch in loader:
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
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.lora import LoRAModelWrapper, count_lora_params
    from cosmos_predict2_tpu_torch.training.trainer import IterSpeedCallback, Trainer
    from cosmos_predict2_tpu_torch.utils import log
    from cosmos_predict2_tpu_torch.utils.flags import SMOKE

    device = torch.device(device)
    trainer_cfg = config.trainer
    if SMOKE:
        trainer_cfg = dataclasses.replace(trainer_cfg, max_iter=2, logging_iter=1, save_iter=0)

    model_cfg = config.model
    net = build_dit(model_cfg.net, device, seed=trainer_cfg.seed, trainable=not model_cfg.use_lora)
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

    batches = latent_batches(make_loader(config.data_train), vae, device)
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
    state = launch(config, ckpt_dir=args.ckpt_dir, device=args.device, callbacks=callbacks)
    print(f"trained {state.step} iterations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
