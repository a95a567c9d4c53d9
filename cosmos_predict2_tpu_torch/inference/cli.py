"""Inference CLI of the PyTorch port (counterpart of cosmos_predict2_tpu/inference/cli.py).

    python -m cosmos_predict2_tpu_torch.inference.cli \
        --experiment=predict2_video2world_2b_rectified_flow \
        --checkpoint=model.pt --vae=Wan2.1_VAE.pth \
        --text-embedding-path=prompt.npy --input=input.jpg [--batch samples.json] [--sampler dmd2] \
        [--text-encoder=reason1.safetensors --tokenizer-path=tokenizer_dir] \
        [--mode text2image] [--autoregressive --num-output-frames 181 --chunk-size 93 --chunk-overlap 2] \
        [--no-vae-streaming] [--disable-guardrails] [--device cpu]

``--experiment`` takes any registered name (configs/defaults.py,
configs/released_experiments.py); ``--checkpoint`` and ``--vae`` take a
file, a checkpoint-DB name or a uuid (utils/checkpoint_db.py; nothing is
downloaded). Weights load through utils/model_loader.py: every key the
model has must be there with its shape, other entries are ignored and
logged; with no checkpoint, seeded random weights. The VAE streams by
default; ``--no-vae-streaming`` takes the one-shot route, the JAX CLI's
default. ``--text-encoder`` takes a Cosmos-Reason1 (Qwen2.5-VL) state
dict, a file or a directory of shards with HF's keys, and attaches it as
the pipeline's text encoder (text_encoders/text_encoder.py::
load_text_encoder: bf16 on a card, fp32 on the CPU); prompts are then
tokenized by ``transformers`` from ``--tokenizer-path``, and a prompt
without a tokenizer path raises.
The prompt passes the text guardrail (utils/guardrails.py: the default
blocklist) first, as in the JAX CLI: a blocked prompt writes nothing and
exits 1 (``--disable-guardrails`` turns it off).
COSMOS_SMOKE=1 uses random weights, 1 step, the 192x320 geometry, no
guardrail and, when no ``--text-encoder`` is given, zero text embeddings
for plumbing checks.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cosmos_predict2_tpu_torch inference")
    p.add_argument("--experiment", default="predict2_video2world_2b_rectified_flow")
    p.add_argument("--checkpoint", default=None, help="DiT torch state dict (.pt/.pth/.safetensors)")
    p.add_argument("--vae", default=None, help="Wan2.1_VAE.pth torch state dict")
    p.add_argument("--text-encoder", default=None, help="Cosmos-Reason1 (Qwen2.5-VL) weights: a file or a directory")
    p.add_argument("--tokenizer-path", default=None, help="HF tokenizer directory for the text encoder")
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
    p.add_argument("--mode", choices=["video", "text2image"], default="video",
                   help="text2image: one generated image, written as <output-dir>/sample.png")
    p.add_argument("--autoregressive", action="store_true",
                   help="long video: chunks of --chunk-size frames sharing --chunk-overlap latent frames")
    p.add_argument("--num-output-frames", type=int, default=77)
    p.add_argument("--chunk-size", type=int, default=77)
    p.add_argument("--chunk-overlap", type=int, default=1)
    p.add_argument("--no-vae-streaming", action="store_true",
                   help="the one-shot VAE route: the whole clip through the encoder and decoder at once")
    p.add_argument("--disable-guardrails", action="store_true", help="no text guardrail (the blocklist)")
    p.add_argument("--device", default="cuda", help="torch device; the CPU only when asked for (cpu)")
    return p.parse_args(argv)


def build_pipeline(args):
    """utils/model_loader.py's pipeline for the arguments, with the
    ``--text-encoder`` attached; under COSMOS_SMOKE with random weights, the
    192x320 geometry and, without ``--text-encoder``, zero text embeddings."""
    import torch

    from cosmos_predict2_tpu_torch.utils.flags import SMOKE
    from cosmos_predict2_tpu_torch.utils.model_loader import load_model_from_checkpoint

    pipe, config = load_model_from_checkpoint(
        args.experiment,
        checkpoint_path=None if SMOKE else args.checkpoint,
        vae_path=None if SMOKE else args.vae,
        resolution=args.resolution,
        size_override=(192, 320) if SMOKE else None,
        device=args.device,
    )
    pipe.setup = dataclasses.replace(pipe.setup, streaming_vae=not args.no_vae_streaming)
    if args.text_encoder:
        from cosmos_predict2_tpu_torch.text_encoders.text_encoder import load_text_encoder

        pipe.text_encoder = load_text_encoder(args.text_encoder, tokenizer_path=args.tokenizer_path,
                                              device=args.device)
    elif SMOKE:
        net_cfg = config.model.net
        ctx_dim = net_cfg.crossattn_proj_in_channels if net_cfg.use_crossattn_projection else net_cfg.crossattn_emb_channels
        pipe.text_encoder = lambda prompts: torch.zeros((len(prompts), 512, ctx_dim))
    return pipe


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s|%(levelname)s] %(message)s")
    from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments
    from cosmos_predict2_tpu_torch.utils.flags import SMOKE
    from cosmos_predict2_tpu_torch.utils.guardrails import create_text_guardrail_runner

    guard = None if (args.disable_guardrails or SMOKE) else create_text_guardrail_runner()
    if args.mode == "text2image" and guard is not None and not guard(args.prompt):
        print("prompt rejected by guardrail")
        return 1
    api = Inference(build_pipeline(args), output_dir=args.output_dir, text_guardrail=guard)
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
                enable_autoregressive=args.autoregressive,
                num_output_frames=args.num_output_frames,
                chunk_size=args.chunk_size,
                chunk_overlap=args.chunk_overlap,
                text_embedding_path=args.text_embedding_path,
                mode="image" if args.mode == "text2image" else "video",
                sampler=args.sampler,
            )
        ]
    outputs = api.generate(samples)
    print("\n".join(outputs))
    return 0 if outputs else 1


if __name__ == "__main__":
    sys.exit(main())
