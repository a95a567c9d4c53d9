"""Inference CLI of the PyTorch port (counterpart of cosmos_predict2_tpu/inference/cli.py).

    python -m cosmos_predict2_tpu_torch.inference.cli \
        --experiment=predict2_video2world_2b_rectified_flow \
        --checkpoint=model.pt --vae=Wan2.1_VAE.pth \
        --text-embedding-path=prompt.npy --input=input.jpg [--batch samples.json] [--sampler dmd2] [--device cpu]

Weights: a reference torch state dict (``.pt``/``.pth``/``.safetensors``,
loaded with ``strict=True``), or seeded random weights when none is given.
COSMOS_SMOKE=1 uses random weights, 1 step, the 192x320 geometry and zero
text embeddings for plumbing checks.
"""

from __future__ import annotations

import argparse
import logging
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cosmos_predict2_tpu_torch inference")
    p.add_argument("--experiment", default="predict2_video2world_2b_rectified_flow")
    p.add_argument("--checkpoint", default=None, help="DiT torch state dict (.pt/.pth/.safetensors)")
    p.add_argument("--vae", default=None, help="Wan2.1_VAE.pth torch state dict")
    p.add_argument("--prompt", default="")
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--input", dest="input_path", default=None)
    p.add_argument("--batch", default=None, help="json/jsonl batch of samples")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--guidance", type=float, default=7.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resolution", default="480")
    p.add_argument("--num-conditional-frames", type=int, default=1)
    p.add_argument("--text-embedding-path", default=None, help=".npy precomputed embedding")
    p.add_argument("--sampler", choices=["unipc", "dmd2"], default="unipc",
                   help="dmd2 = few-step distilled path (no CFG; needs distilled weights)")
    p.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for (cpu)")
    return p.parse_args(argv)


def _load_state_dict(path: str, prefixes: tuple[str, ...] = ()) -> dict:
    import torch

    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import load_torch_state_dict, strip_prefix

    sd = load_torch_state_dict(path)
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in sd):
            sd = strip_prefix(sd, prefix)
            break
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def build_pipeline(args):
    """Video2WorldInference from the experiment config, with checkpoint
    weights (``strict=True``) or seeded random weights."""
    import torch

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.utils.flags import SMOKE

    log = logging.getLogger("cosmos_predict2_tpu_torch")
    device = torch.device(args.device)
    config = make_config(args.experiment)
    model_cfg = config.model
    setup = InferenceSetup(
        model_config=model_cfg,
        vae_config=config.tokenizer,
        resolution=args.resolution,
        size_override=(192, 320) if SMOKE else None,
    )
    net = build_dit(model_cfg.net, device, seed=0)
    if args.checkpoint and not SMOKE:
        net.load_state_dict(_load_state_dict(args.checkpoint, ("net_ema.", "net.")), strict=True)
    else:
        log.warning("no checkpoint given (or SMOKE): using random DiT weights")
    vae = build_vae(config.tokenizer, device, seed=1)
    if args.vae and not SMOKE:
        vae.load_state_dict(_load_state_dict(args.vae), strict=True)
    else:
        log.warning("no VAE checkpoint given (or SMOKE): using random VAE weights")

    text_encoder = None
    if SMOKE:
        net_cfg = model_cfg.net
        ctx_dim = net_cfg.crossattn_proj_in_channels if net_cfg.use_crossattn_projection else net_cfg.crossattn_emb_channels
        text_encoder = lambda prompts: torch.zeros((len(prompts), 512, ctx_dim))
    return Video2WorldInference(setup, net, vae, text_encoder=text_encoder)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s|%(levelname)s] %(message)s")
    from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments
    from cosmos_predict2_tpu_torch.utils.flags import SMOKE

    api = Inference(build_pipeline(args), output_dir=args.output_dir)
    if args.batch:
        samples = InferenceArguments.from_file(args.batch)
    else:
        samples = [
            InferenceArguments(
                name="sample",
                prompt=args.prompt,
                negative_prompt=args.negative_prompt,
                input_path=args.input_path,
                num_steps=args.num_steps or ((1 if SMOKE else 35) if args.sampler == "unipc" else 4),
                guidance=args.guidance,
                seed=args.seed,
                num_conditional_frames=args.num_conditional_frames,
                text_embedding_path=args.text_embedding_path,
                sampler=args.sampler,
            )
        ]
    outputs = api.generate(samples)
    print("\n".join(outputs))
    return 0 if outputs else 1


if __name__ == "__main__":
    sys.exit(main())
