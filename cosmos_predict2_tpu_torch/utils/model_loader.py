"""Experiment + checkpoint -> a ready Video2World pipeline (the library API).

The port's counterpart of cosmos_predict2_tpu/utils/model_loader.py:
rebuild the config from the experiment's name (configs/), build the DiT
and the VAE on the device, load the checkpoint's weights (EMA first) and
return the pipeline with its config. inference/cli.py is a thin shell over
it.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

log = logging.getLogger("cosmos_predict2_tpu_torch")


def resolve_checkpoint(checkpoint: str) -> str:
    """A checkpoint given as a file path, a checkpoint-DB name or a uuid ->
    its local file. Raises FileNotFoundError with the path to place a DB
    checkpoint at; nothing is downloaded."""
    from cosmos_predict2_tpu_torch.utils.checkpoint_db import get_checkpoint_by_uuid, get_checkpoint_path

    if os.path.exists(checkpoint):
        return checkpoint
    try:
        get_checkpoint_by_uuid(checkpoint)
    except KeyError:
        raise FileNotFoundError(f"checkpoint '{checkpoint}' is neither a file nor a checkpoint-DB name or uuid") from None
    return get_checkpoint_path(checkpoint)


def load_model_from_checkpoint(
    experiment: str,
    checkpoint_path: Optional[str] = None,
    vae_path: Optional[str] = None,
    resolution: str = "480",
    load_ema_to_reg: bool = True,
    size_override: Optional[tuple[int, int]] = None,
    device: torch.device | str = "cuda",
):
    """-> (Video2WorldInference, Config).

    ``checkpoint_path``: a consolidated DiT state dict (.pt/.pth/
    .safetensors; a file, a checkpoint-DB name or a uuid), read memory-
    mapped straight into the built net; its ``net_ema.`` weights are taken
    before ``net.`` (``load_ema_to_reg=False``: ``net.`` only), a file under
    neither prefix as it is. ``vae_path``: the Wan2.1 VAE state dict.
    ``None`` gives seeded random weights (DiT seed 0, VAE seed 1). The DiT's
    matmul weights are stored in its compute dtype
    (networks/dit.py::build_serving_dit), the rest and the VAE in fp32.
    """
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference
    from cosmos_predict2_tpu_torch.networks.dit import build_serving_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import (
        load_reference_state_dict,
        pick_prefix,
        read_state_dict,
    )

    device = torch.device(device)
    config = make_config(experiment)
    net = build_serving_dit(config.model.net, device, seed=None if checkpoint_path else 0)
    if checkpoint_path:
        path = resolve_checkpoint(checkpoint_path)
        prefixes = ("net_ema.", "net.") if load_ema_to_reg else ("net.",)
        load_reference_state_dict(net, pick_prefix(read_state_dict(path), prefixes), f"DiT checkpoint {path}")
    else:
        log.warning("no DiT checkpoint given: using seeded random DiT weights")
    vae = build_vae(config.tokenizer, device, seed=1)
    if vae_path:
        load_reference_state_dict(vae, read_state_dict(resolve_checkpoint(vae_path)), f"VAE checkpoint {vae_path}")
    else:
        log.warning("no VAE checkpoint given: using seeded random VAE weights")
    setup = InferenceSetup(model_config=config.model, vae_config=config.tokenizer, resolution=resolution,
                           size_override=size_override)
    return Video2WorldInference(setup, net, vae), config
