"""Golden-activation dump harness for layer-output parity checks.

The port's counterpart of cosmos_predict2_tpu/utils/golden_activations.py,
the tool for weight-import validation: run the DiT on a fixed input
capturing every block's hidden state, save them to an npz, and diff two
dumps (this port against the JAX package, the card against the CPU, or
against activations exported from the reference with the same converted
weights). The npz keys are the JAX package's: ``block_NN`` (B, L, D) per
block, ``output`` and ``input``, all fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_predict2_tpu_torch.utils.model_comp import TensorDifference


@torch.no_grad()
def dump_dit_activations(net, x, timesteps, crossattn_emb, path: str, **net_kwargs) -> dict:
    """Run ``MiniTrainDIT`` capturing all per-block hidden states and the
    output; writes an npz at ``path`` and returns the arrays. The inputs are
    tensors on the net's device (arrays are moved there)."""
    device = next(net.parameters()).device
    x, timesteps, crossattn_emb = (torch.as_tensor(a, device=device) for a in (x, timesteps, crossattn_emb))
    n_blocks = net.cfg.num_blocks
    out, intermediates = net(x, timesteps, crossattn_emb, intermediate_feature_ids=tuple(range(n_blocks)),
                             **net_kwargs)
    host = lambda t: t.detach().to("cpu", torch.float32).numpy()
    arrays = {f"block_{i:02d}": host(a) for i, a in enumerate(intermediates)}
    arrays["output"] = host(out)
    arrays["input"] = host(x)
    np.savez_compressed(path, **arrays)
    return arrays


def compare_activation_dumps(path_a: str, path_b: str) -> list[TensorDifference]:
    """Per-tensor max-abs/rel diff between two dumps, sorted worst-first; a
    key in one dump only is listed as ``MISSING:<key>``."""
    with np.load(path_a) as a, np.load(path_b) as b:
        keys = sorted(set(a.files) & set(b.files))
        missing = set(a.files) ^ set(b.files)
        diffs = [TensorDifference.compare(a[k], b[k], name=k) for k in keys]
    for k in missing:
        diffs.append(TensorDifference(name=f"MISSING:{k}", max_abs=float("inf"), max_rel=float("inf"),
                                      mean_abs=float("inf")))
    return sorted(diffs, key=lambda d: -d.max_abs)
