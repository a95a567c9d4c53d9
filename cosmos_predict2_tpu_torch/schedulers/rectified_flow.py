"""Rectified-flow noise schedule: the part sampling needs.

Counterpart of cosmos_predict2_tpu/schedulers/rectified_flow.py::shift_sigmas.
The training-time schedule (sampling train times, interpolation) waits for
the training port.
"""

from __future__ import annotations

import numpy as np


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """Resolution shift of flow-matching noise levels: s' = k*s/(1+(k-1)s)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
