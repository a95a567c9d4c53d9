"""Environment feature flags, the port's copy of cosmos_predict2_tpu/utils/flags.py.

``COSMOS_SMOKE`` shrinks runs for plumbing checks (1 sampling step, 2
training iterations, random weights).
"""

from __future__ import annotations

import os


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


SMOKE: bool = _env_flag("COSMOS_SMOKE")
