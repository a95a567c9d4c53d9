"""GAN discriminator head on DiT intermediate features (the DMD2 option).

Counterpart of cosmos_predict2_tpu/networks/discriminator.py (the
reference's distill/networks/discriminator.py): a small head over the
fake-score net's intermediate block activations (``MiniTrainDIT(...,
intermediate_feature_ids=...)``) that emits one realness logit per sample,
and the binary cross-entropy losses of the GAN terms. As in the JAX
package, the DMD2 losses of models/distillation.py do not call it.

Each ``nn.Linear`` carries the name of its JAX ``Dense`` layer (``proj_{i}``,
``mix``, ``logit``), so utils/convert.py maps the JAX parameter tree onto
this module's state dict.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class DiscriminatorHead(nn.Module):
    """Per-feature Linear -> SiLU -> mean over tokens, the pooled features
    concatenated -> Linear -> SiLU -> Linear to one logit. ``features``:
    ``num_features`` tensors (B, L, ``feature_dim``) -> (B, 1). Parameters
    are fp32; the products run in ``dtype``, as the JAX ``Dense(dtype=...)``."""

    def __init__(self, feature_dim: int, num_features: int, hidden_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_features = num_features
        for i in range(num_features):
            self.add_module(f"proj_{i}", nn.Linear(feature_dim, hidden_dim))
        self.mix = nn.Linear(num_features * hidden_dim, hidden_dim)
        self.logit = nn.Linear(hidden_dim, 1)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, features: list[torch.Tensor]) -> torch.Tensor:
        if len(features) != self.num_features:
            raise ValueError(f"DiscriminatorHead takes {self.num_features} features, got {len(features)}")
        pooled = [F.silu(self._dense(getattr(self, f"proj_{i}"), f)).mean(dim=1) for i, f in enumerate(features)]
        h = F.silu(self._dense(self.mix, torch.cat(pooled, dim=-1)))
        return self._dense(self.logit, h)


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically stable binary cross-entropy against a constant target."""
    return torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))


def generator_gan_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """BCE(fake, 1): push the generator toward 'real'."""
    return torch.mean(torch.nan_to_num(bce_with_logits(logits_fake, 1.0)))


def discriminator_gan_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """BCE(real, 1) + BCE(fake, 0)."""
    return torch.mean(torch.nan_to_num(bce_with_logits(logits_real, 1.0) + bce_with_logits(logits_fake, 0.0)))
