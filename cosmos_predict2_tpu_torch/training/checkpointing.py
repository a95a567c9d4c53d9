"""Checkpoints of the training state, on ``torch.save`` / ``torch.load``.

Counterpart of cosmos_predict2_tpu/training/checkpointing.py, with the same
"latest step" contract as its Orbax manager: one directory per saved step,
named by the step, under the checkpoint directory; ``latest_step`` is the
highest complete one; the oldest are removed beyond ``max_to_keep``. A step
is written to a temporary directory and renamed into place, so a
half-written step is never taken for the latest. Saves are synchronous
(``wait`` returns at once).

``save_consolidated`` / ``load_consolidated`` write and read one file of
(possibly EMA) parameters by name, for inference; ``load_ema_to_reg`` puts
a checkpoint's EMA weights in its parameters' place.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Mapping, Optional

import torch

log = logging.getLogger("cosmos_predict2_tpu_torch")

_STATE_FILE = "state.pt"


class Checkpointer:
    """Step checkpoints of a :class:`~cosmos_predict2_tpu_torch.training.trainer.TrainState`."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, _STATE_FILE))
        )

    def save(self, state, step: int) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save(state.state_dict(), os.path.join(tmp, _STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        log.info(f"Saved checkpoint at iteration {step} -> {self.directory}")

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def read(self, step: Optional[int] = None) -> dict:
        """The saved state dict of ``step`` (default: the latest), on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), _STATE_FILE), map_location="cpu", weights_only=True)

    def load(self, state, step: Optional[int] = None):
        """Restore ``state`` in place from ``step`` (default: the latest) and return it."""
        sd = self.read(step)
        state.load_state_dict(sd)
        log.info(f"Restored checkpoint from iteration {sd['step']}")
        return state


def save_consolidated(params: Mapping[str, torch.Tensor], path: str) -> None:
    """One-file export of parameters by name (fp32 or as given), on the CPU."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)
    log.info(f"Exported consolidated params -> {path}")


def load_consolidated(template: Mapping[str, torch.Tensor], path: str) -> dict[str, torch.Tensor]:
    """Read a :func:`save_consolidated` file; its names and shapes must be the template's."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if sd.keys() != template.keys():
        raise KeyError(f"{path}: names differ from the template's ({len(sd)} vs {len(template)})")
    for k, v in template.items():
        if sd[k].shape != v.shape:
            raise ValueError(f"{path}: {k} has shape {tuple(sd[k].shape)}, the template {tuple(v.shape)}")
    return sd


def load_ema_to_reg(state_dict: dict, dtype: Optional[torch.dtype] = None) -> dict:
    """A checkpoint's state dict with its EMA weights (cast to ``dtype`` if
    given) in place of its parameters; as it is when it has no EMA."""
    ema = state_dict.get("ema_params")
    if ema is None:
        return state_dict
    params = {k: v.to(dtype) if dtype is not None else v for k, v in ema.items()}
    return {**state_dict, "params": params}
