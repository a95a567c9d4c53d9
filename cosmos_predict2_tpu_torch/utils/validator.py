"""Descriptor-based parameter validation for the serving and env-parsing layers.

The port's copy of cosmos_predict2_tpu/utils/validator.py (the reference
validator library, cosmos_predict2/_src/imaginaire/utils/validator.py:35-514):
typed descriptors (Bool/Int/Float/String/Path/OneOf/MultipleOf/InputImage/
InputVideo) declared as class attributes, validating on assignment,
raising on unset mandatory access, and exporting a JSON schema for UIs. It
backs the HTTP job schema (inference/serving.py) and the env parsers
(utils/env_parsers.py).

Pure Python (no torch) by design: this is a host/API layer.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Iterable, Optional

# Sentinel: no default provided => the parameter is mandatory.
_UNSET = object()


class Validator(ABC):
    """Descriptor: ``class P: x = Int(min=0)`` validates ``p.x = v`` on set
    (reference validator.py:35-65)."""

    def __init__(self, default: Any = _UNSET, hidden: bool = False, tooltip: Optional[str] = None):
        self.default = default
        self.hidden = hidden
        self.tooltip = tooltip

    def __set_name__(self, owner, name):
        self.public_name = name
        self.private_name = "_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        value = getattr(obj, self.private_name, self.default)
        if value is _UNSET:
            raise ValueError(
                f"Parameter '{self.private_name.lstrip('_')}' is mandatory but has not been set."
            )
        return value

    def __set__(self, obj, value):
        setattr(obj, self.private_name, self.validate(value))

    @abstractmethod
    def validate(self, value):
        ...

    def json(self) -> dict:
        return {"type": type(self).__name__, "default": None if self.default is _UNSET else self.default,
                "tooltip": self.tooltip}


class Bool(Validator):
    def validate(self, value):
        if isinstance(value, bool):
            return value
        if isinstance(value, int):
            return value != 0
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1"):
                return True
            if low in ("false", "0"):
                return False
            raise ValueError(f"Expected {value!r} to be one of ['True', 'False', '1', '0']")
        raise TypeError(f"Expected {value!r} to be a bool")


class Int(Validator):
    def __init__(self, default=_UNSET, min=None, max=None, step: int = 1, hidden=False, tooltip=None):
        super().__init__(default, hidden, tooltip)
        self.min, self.max, self.step = min, max, step

    def validate(self, value):
        if isinstance(value, str):
            value = int(value)
        if isinstance(value, bool) or not isinstance(value, int):
            raise TypeError(f"Expected {value!r} to be an int")
        if self.min is not None and value < self.min:
            raise ValueError(f"Expected {value!r} to be at least {self.min!r}")
        if self.max is not None and value > self.max:
            raise ValueError(f"Expected {value!r} to be no more than {self.max!r}")
        return value

    def json(self):
        return {**super().json(), "min": self.min, "max": self.max, "step": self.step}


class Float(Validator):
    def __init__(self, default=_UNSET, min=None, max=None, step: float = 0.5, hidden=False, tooltip=None):
        super().__init__(default, hidden, tooltip)
        self.min, self.max, self.step = min, max, step

    def validate(self, value):
        if isinstance(value, str):
            value = float(value)
        elif isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        if not isinstance(value, float):
            raise TypeError(f"Expected {value!r} to be a float")
        if self.min is not None and value < self.min:
            raise ValueError(f"Expected {value!r} to be at least {self.min!r}")
        if self.max is not None and value > self.max:
            raise ValueError(f"Expected {value!r} to be no more than {self.max!r}")
        return value

    def json(self):
        return {**super().json(), "min": self.min, "max": self.max, "step": self.step}


class String(Validator):
    def __init__(self, default=_UNSET, max_len: Optional[int] = None, allow_empty: bool = True,
                 hidden=False, tooltip=None):
        super().__init__(default, hidden, tooltip)
        self.max_len = max_len
        self.allow_empty = allow_empty

    def validate(self, value):
        if not isinstance(value, str):
            raise TypeError(f"Expected {value!r} to be a str")
        if not self.allow_empty and not value:
            raise ValueError(f"{self.private_name}: empty string not allowed")
        if self.max_len is not None and len(value) > self.max_len:
            raise ValueError(f"{self.private_name}: longer than {self.max_len} chars")
        return value


class Path(Validator):
    """An existing filesystem path (or None)."""

    def validate(self, value):
        if value is None:
            return value
        if not isinstance(value, str):
            raise TypeError(f"{self.private_name}: expected {value!r} to be a str")
        if not os.path.exists(value):
            raise ValueError(f"{self.private_name}: expected {value!r} to be a valid path")
        return value


class OneOf(Validator):
    def __init__(self, default=_UNSET, options: Optional[Iterable] = None, type_cast=None,
                 hidden=False, tooltip=None):
        super().__init__(default, hidden, tooltip)
        self.options = set(options) if options is not None else set()
        self.type_cast = type_cast

    def validate(self, value):
        if self.type_cast:
            try:
                value = self.type_cast(value)
            except ValueError:
                raise ValueError(f"Expected {value!r} to be castable to {self.type_cast!r}")
        if value not in self.options:
            raise ValueError(f"Expected {value!r} to be one of {sorted(map(str, self.options))!r}")
        return value

    def json(self):
        return {**super().json(), "values": sorted(self.options, key=str)}


class MultipleOf(Validator):
    def __init__(self, default=_UNSET, multiple_of: int = 1, type_cast=None, hidden=False, tooltip=None):
        if type(multiple_of) is not int:
            raise ValueError(f"Expected {multiple_of!r} to be an int")
        super().__init__(default, hidden, tooltip)
        self.multiple_of = multiple_of
        self.type_cast = type_cast

    def validate(self, value):
        if self.type_cast:
            value = self.type_cast(value)
        if value % self.multiple_of != 0:
            raise ValueError(f"Expected {value!r} to be a multiple of {self.multiple_of!r}")
        return value

    def json(self):
        return {**super().json(), "multiple_of": self.multiple_of}


class _MediaPath(Path):
    formats: tuple[str, ...] = ()

    def validate(self, value):
        value = super().validate(value)
        if value is not None:
            ext = os.path.splitext(value)[1].lower().lstrip(".")
            if ext not in self.formats:
                raise ValueError(f"Unsupported format .{ext}; expected one of {self.formats}")
        return value


class InputImage(_MediaPath):
    formats = ("jpeg", "jpg", "png", "bmp", "gif", "webp")


class InputVideo(_MediaPath):
    formats = ("mp4", "webm", "mkv", "mov", "avi")


class ValidatedParams:
    """Base for parameter bundles declared with Validator descriptors.

    * ``from_dict`` constructs + validates from a request payload,
      rejecting unknown keys (unless the class sets ``allow_extra``).
    * ``to_dict`` returns current (validated) values.
    * ``schema`` exports the UI-facing JSON description, omitting hidden
      params (the reference's probe() contract).
    """

    allow_extra = False

    @classmethod
    def _validators(cls) -> dict[str, Validator]:
        out: dict[str, Validator] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Validator):
                    out[k] = v
        return out

    @classmethod
    def from_dict(cls, payload: dict):
        self = cls()
        fields = cls._validators()
        for key, value in payload.items():
            if key not in fields:
                if cls.allow_extra:
                    continue
                raise ValueError(f"Unknown parameter {key!r}; expected one of {sorted(fields)}")
            if fields[key].hidden:
                raise ValueError(f"Parameter {key!r} is hidden and cannot be set")
            setattr(self, key, value)
        # touch every field so missing mandatory params raise now, not later
        for key in fields:
            getattr(self, key)
        return self

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._validators()}

    @classmethod
    def schema(cls) -> dict:
        return {k: v.json() for k, v in cls._validators().items() if not v.hidden}
