"""Model comparison / debugging helpers.

The port's counterpart of cosmos_predict2_tpu/utils/model_comp.py, after the
reference's debug tooling: ``compare_models_thoroughly``
(predict2/utils/model_comp.py:19, weight-diff reporting between two models)
and ``TensorDifference`` (predict2/utils/test_helper.py:26-60, max-abs / rel
numeric comparison). The trees are the port's state dicts, or any nested
dicts of tensors or arrays; leaves are keyed by their dotted names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


@dataclasses.dataclass
class TensorDifference:
    name: str
    max_abs: float
    max_rel: float
    mean_abs: float

    @staticmethod
    def compare(a, b, name: str = "") -> "TensorDifference":
        a, b = _numpy(a), _numpy(b)
        diff = np.abs(a - b)
        denom = np.maximum(np.abs(b), 1e-12)
        return TensorDifference(
            name=name,
            max_abs=float(diff.max()) if diff.size else 0.0,
            max_rel=float((diff / denom).max()) if diff.size else 0.0,
            mean_abs=float(diff.mean()) if diff.size else 0.0,
        )

    def __str__(self):
        return f"{self.name}: max_abs={self.max_abs:.3e} max_rel={self.max_rel:.3e} mean_abs={self.mean_abs:.3e}"


def flatten_state(tree: Mapping[str, Any], prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(dotted name, leaf) pairs of nested dicts, in insertion order."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from flatten_state(v, name + ".")
        else:
            yield name, v


def compare_models_thoroughly(params_a: Mapping[str, Any], params_b: Mapping[str, Any],
                              atol: float = 0.0) -> list[TensorDifference]:
    """Leaf-by-leaf diff of two state dicts (nested dicts flattened by dotted
    name); the leaves that differ by more than ``atol``, missing ones and
    shape mismatches, sorted by max_abs, worst first."""
    flat_b = dict(flatten_state(params_b))
    diffs = []
    for key, leaf in flatten_state(params_a):
        if key not in flat_b:
            diffs.append(TensorDifference(key + " [MISSING IN B]", float("inf"), float("inf"), float("inf")))
            continue
        other = flat_b.pop(key)
        if tuple(leaf.shape) != tuple(other.shape):
            diffs.append(TensorDifference(key + " [SHAPE MISMATCH]", float("inf"), float("inf"), float("inf")))
            continue
        d = TensorDifference.compare(leaf, other, key)
        if d.max_abs > atol:
            diffs.append(d)
    for key in flat_b:
        diffs.append(TensorDifference(key + " [MISSING IN A]", float("inf"), float("inf"), float("inf")))
    return sorted(diffs, key=lambda d: -d.max_abs)
