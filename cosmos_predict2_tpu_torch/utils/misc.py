"""Seeded noise, as cosmos_predict2_tpu/utils/misc.py::arch_invariant_rand.

Noise is drawn on the host with torch's CPU generator, so a seed gives
bit-identical noise on every device and in both packages, then moved to
the target device.
"""

from __future__ import annotations

import torch


def arch_invariant_rand(shape: tuple[int, ...], seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Seeded standard-normal fp32 noise, drawn on the CPU, placed on ``device``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=gen, dtype=torch.float32).to(device)
