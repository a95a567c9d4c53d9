"""Released-weights verifier of the port: read -> key and shape contract -> generate -> PSNR, one command.

The counterpart of the repo-root scripts/verify_released_weights.py, with
the same arguments, defaults, chain and JSON line. The day released
weights are on the machine, one command runs the whole chain and reports
PSNR against a stored golden:

    # bless a golden from a trusted run:
    python -m cosmos_predict2_tpu_torch.scripts.verify_released_weights --dit model_ema_bf16.pt \\
        --vae Wan2.1_VAE.pth --golden goldens/2b_base.npz --write-golden
    # verify:
    python -m cosmos_predict2_tpu_torch.scripts.verify_released_weights --dit model_ema_bf16.pt \\
        --vae Wan2.1_VAE.pth --golden goldens/2b_base.npz --psnr-min 35

``--checkpoint`` resolves the DiT through the checkpoint DB instead of
``--dit``. It runs on the card; ``--cpu`` is the only way onto the CPU.
The generation is the JAX script's: ``--steps`` UniPC steps with CFG from
arch-invariant noise (seed ``--seed``) and a 512-token arch-invariant text
embedding (seed ``--seed`` + 1), no conditional frames, then the one-shot
VAE decode when ``--vae`` is given (else the latents are compared). A
golden written by either script is read by the other.

Prints one JSON line: {"ok": bool, "psnr_db": float, ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

DEFAULT_EXPERIMENT = (
    "Stage-c_pt_4-reason_embeddings-v1p1-Index-26-Size-2B-Res-720-Fps-16"
    "-Note-T2V_high_sigma_loss_reweighted_1_1_rectified_flow_only_resume2"
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="released-weights verification")
    p.add_argument("--dit", default=None, help="consolidated DiT .pt (net/net_ema namespaces)")
    p.add_argument("--vae", default=None, help="Wan VAE .pth")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint-DB uuid/name; resolves --dit via the DB when omitted")
    p.add_argument("--experiment", default=DEFAULT_EXPERIMENT)
    p.add_argument("--golden", default=None, help=".npz with blessed output pixels")
    p.add_argument("--write-golden", action="store_true")
    p.add_argument("--psnr-min", type=float, default=35.0)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--guidance", type=float, default=7.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the CUDA card)")
    return p.parse_args(argv)


def contract_errors(own: dict, sd: dict) -> list[str]:
    """The model's keys the checkpoint lacks and the shapes that differ
    (entries the model does not have are ignored, as the loader ignores
    them)."""
    errs = []
    for k in sorted(own):
        if k not in sd:
            errs.append(f"missing in checkpoint: {k} {tuple(own[k].shape)}")
        elif tuple(own[k].shape) != tuple(sd[k].shape) and not (k.endswith(".gamma") and sd[k].numel() == own[k].numel()):
            errs.append(f"shape mismatch {k}: model {tuple(own[k].shape)} vs ckpt {tuple(sd[k].shape)}")
    return errs


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT, build_serving_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import load_reference_state_dict, pick_prefix, read_state_dict
    from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand
    from cosmos_predict2_tpu_torch.utils.model_loader import resolve_checkpoint

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        print(json.dumps({"ok": False, "error": "no CUDA device; pass --cpu to run on the CPU"}))
        return 2

    dit_path = args.dit
    if dit_path is None:
        if args.checkpoint is None:
            print(json.dumps({"ok": False, "error": "need --dit or --checkpoint"}))
            return 2
        dit_path = resolve_checkpoint(args.checkpoint)

    cfg = make_config(args.experiment)
    lt = 1 + (args.frames - 1) // 4
    latent_shape = (1, cfg.model.state_ch, lt, args.height // 8, args.width // 8)

    # 1. read the checkpoint's DiT namespace (memory-mapped)
    sd = pick_prefix(read_state_dict(dit_path), ("net.",) if args.no_ema else ("net_ema.", "net."))

    # 2. the key and shape contract against the model at its true shapes
    with torch.device("meta"):
        own = MiniTrainDIT(cfg.model.net).state_dict()
    errs = contract_errors(own, sd)
    if errs:
        print("\n".join(errs[:40]), file=sys.stderr)
        print(json.dumps({"ok": False, "error": f"{len(errs)} converter contract violations"}))
        return 1

    # 3. deterministic generation from arch-invariant noise and text
    net = build_serving_dit(cfg.model.net, device, seed=None)
    load_reference_state_dict(net, sd, f"DiT checkpoint {dit_path}")
    del sd
    model = Video2WorldModel(cfg.model, net)
    noise = arch_invariant_rand(latent_shape, args.seed, device=device)
    net_cfg = cfg.model.net
    ctx_dim = net_cfg.crossattn_proj_in_channels if net_cfg.use_crossattn_projection else net_cfg.crossattn_emb_channels
    text_emb = arch_invariant_rand((1, 512, ctx_dim), args.seed + 1, device=device)
    condition = make_condition(text_emb, fps=torch.full((1,), 16.0, device=device))
    with torch.no_grad():
        latents = model.generate(noise, condition, guidance=args.guidance, num_steps=args.steps,
                                 num_conditional_frames=0)

        # 4. the one-shot VAE decode (without --vae the latents are compared)
        if args.vae:
            vae = build_vae(cfg.tokenizer, device, seed=1)
            load_reference_state_dict(vae, read_state_dict(args.vae), f"VAE checkpoint {args.vae}")
            pixels = vae.decode(latents.to(cfg.tokenizer.dtype).permute(0, 2, 3, 4, 1))
            out = pixels.float().cpu().numpy()
        else:
            out = latents.float().cpu().numpy()

    meta = dict(
        experiment=args.experiment, steps=args.steps, frames=args.frames,
        height=args.height, width=args.width, seed=args.seed, guidance=args.guidance,
        decoded=bool(args.vae),
    )

    if args.write_golden:
        if not args.golden:
            print(json.dumps({"ok": False, "error": "--write-golden requires --golden PATH"}))
            return 2
        os.makedirs(os.path.dirname(os.path.abspath(args.golden)), exist_ok=True)
        np.savez_compressed(args.golden, pixels=out, meta=json.dumps(meta))
        print(json.dumps({"ok": True, "golden_written": args.golden, **meta}))
        return 0

    if not args.golden:
        print(json.dumps({"ok": True, "note": "no golden given; conversion+generation ran clean",
                          "out_mean": float(out.mean()), "out_std": float(out.std()), **meta}))
        return 0

    blessed = np.load(args.golden, allow_pickle=False)
    ref = blessed["pixels"].astype(np.float32)
    if ref.shape != out.shape:
        print(json.dumps({"ok": False, "error": f"golden shape {ref.shape} vs output {out.shape}"}))
        return 1
    mse = float(np.mean((ref - out) ** 2))
    # pixel range is [-1, 1] -> peak-to-peak 2
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(4.0 / mse)
    ok = psnr >= args.psnr_min
    print(json.dumps({"ok": bool(ok), "psnr_db": round(psnr, 2), "psnr_min": args.psnr_min, **meta}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
