"""Dotlist overrides on the config tree.

The port's copy (stdlib only) of cosmos_predict2_tpu/configs/registry.py's
``_parse_value``, ``apply_override`` and ``compose``: ``a.b.c=value``
replaces one field of a nested frozen dataclass, a string value from the
command line taking the field's type by ``ast.literal_eval``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any


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
