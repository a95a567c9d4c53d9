"""Config registry: named groups, experiments and dotlist overrides.

The port's copy (stdlib only) of cosmos_predict2_tpu/configs/registry.py's
group and experiment layer and its ``compose``:

* ``register(group, name, node)`` stores a named config node per group
  (net / model / optimizer / tokenizer / data_train);
* an :class:`Experiment` is a dict of {group: name} selections and a dict
  of ``a.b.c`` overrides, registered under its own name, optionally over a
  ``base`` experiment whose selections and overrides it inherits and
  extends (chains of any depth);
* ``compose`` applies ``a.b.c=value`` overrides to a nested frozen
  dataclass, a string value from the command line taking the field's type
  by ``ast.literal_eval``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any

_REGISTRY: dict[str, dict[str, Any]] = {}
_EXPERIMENTS: dict[str, "Experiment"] = {}


@dataclasses.dataclass
class Experiment:
    """A named recipe: group selections + dotlist overrides."""

    name: str
    groups: dict[str, str] = dataclasses.field(default_factory=dict)
    overrides: dict[str, Any] = dataclasses.field(default_factory=dict)
    base: str | None = None  # inherit another experiment


def register(group: str, name: str, node: Any) -> None:
    _REGISTRY.setdefault(group, {})[name] = node


def get_node(group: str, name: str) -> Any:
    try:
        return _REGISTRY[group][name]
    except KeyError:
        known = sorted(_REGISTRY.get(group, {}))
        raise KeyError(f"no '{name}' in group '{group}'; known: {known}") from None


def register_experiment(exp: Experiment) -> None:
    _EXPERIMENTS[exp.name] = exp


def list_experiments() -> list[str]:
    return sorted(_EXPERIMENTS)


def resolve_experiment(name: str) -> Experiment:
    """The experiment with its base chain folded in: the base's selections
    and overrides, then its own on top."""
    if name not in _EXPERIMENTS:
        raise KeyError(f"unknown experiment '{name}'; known: {list_experiments()}")
    exp = _EXPERIMENTS[name]
    if exp.base is None:
        return exp
    parent = resolve_experiment(exp.base)
    return Experiment(name=exp.name, groups={**parent.groups, **exp.groups},
                      overrides={**parent.overrides, **exp.overrides})


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_override(node: Any, dotted: str, value: Any) -> Any:
    """Return a copy of a (nested) dataclass with field a.b.c replaced."""
    head, _, rest = dotted.partition(".")
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot override '{dotted}' on {type(node)}")
    if not hasattr(node, head):
        raise AttributeError(f"{type(node).__name__} has no field '{head}'")
    if rest:
        new_value = apply_override(getattr(node, head), rest, value)
    else:
        current = getattr(node, head)
        new_value = value
        # coerce strings from CLI dotlists to the field's current type
        if isinstance(value, str) and not isinstance(current, str):
            new_value = _parse_value(value)
    return dataclasses.replace(node, **{head: new_value})


def compose(base: Any, overrides: list[str] | dict[str, Any] | None = None) -> Any:
    """Apply 'a.b.c=value' dotlist (or dict) overrides to a dataclass tree."""
    if overrides is None:
        return base
    items = overrides.items() if isinstance(overrides, dict) else (o.split("=", 1) for o in overrides)
    node = base
    for key, value in items:
        node = apply_override(node, key.strip(), value)
    return node
