"""Training entry point of the PyTorch port.

    python -m cosmos_predict2_tpu_torch.training.train \\
        --experiment=predict2_video2world_2b_rectified_flow [--dryrun] [--ckpt_dir DIR] [--device cpu] key=value ...

Counterpart of cosmos_predict2_tpu/training/train.py on one device: the
composed config, a DiT with seeded random weights trained in full, the
Wan2.1 VAE on seeded random weights, mock data encoded batch by batch
through the exact streaming VAE encode (no gradient), and the trainer,
resumed from the latest checkpoint of ``--ckpt_dir`` when there is one.
Runs on CUDA unless ``--device cpu`` is given. COSMOS_SMOKE=1 shrinks the
run to 2 iterations without checkpoints. The mesh (fsdp, cp, tp), LoRA and
the local-folder dataset are not ported.
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


def mock_latent_batches(data_config, vae, device: torch.device):
    """Endless (latents (B, C, T, H, W) fp32, condition) batches: mock
    clips of ``data_config`` encoded by the exact streaming VAE encode
    under no_grad, with their text embeddings and fps."""
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.data.mock import MockDataLoader
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming

    for batch in MockDataLoader(data_config):
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
    from cosmos_predict2_tpu_torch.training.trainer import IterSpeedCallback, Trainer
    from cosmos_predict2_tpu_torch.utils.flags import SMOKE

    log = logging.getLogger("cosmos_predict2_tpu_torch")
    device = torch.device(device)
    trainer_cfg = config.trainer
    if SMOKE:
        trainer_cfg = dataclasses.replace(trainer_cfg, max_iter=2, logging_iter=1, save_iter=0)

    net = build_dit(config.model.net, device, seed=trainer_cfg.seed, trainable=True)
    model = Video2WorldModel(config.model, net)
    vae = build_vae(config.tokenizer, device, seed=trainer_cfg.seed + 1)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    trainer = Trainer(trainer_cfg, model, callbacks=[IterSpeedCallback(trainer_cfg.logging_iter), *(callbacks or [])],
                      checkpointer=ckpt)
    log.info(f"DiT {sum(p.numel() for p in net.parameters()) / 1e9:.3f} B trainable params on {device}")
    state = trainer.init_state()
    start_iteration = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.load(state)
        start_iteration = state.step
        log.info(f"resumed from iteration {start_iteration}")

    return trainer.train(state, mock_latent_batches(config.data_train, vae, device), start_iteration=start_iteration)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s|%(levelname)s] %(message)s")
    from cosmos_predict2_tpu_torch.configs.defaults import make_config

    config = make_config(args.experiment, args.overrides)
    if args.dryrun:
        logging.getLogger("cosmos_predict2_tpu_torch").info(f"config OK:\n{config}")
        return 0
    state = launch(config, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"trained {state.step} iterations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
