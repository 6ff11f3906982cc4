"""Typed dataclass-from-dict builder. Counterpart of ``vitef_tpu/utils/typed.py``
(:1-145), copied.

:func:`build_with_type_check` instantiates a dataclass from a nested dict,
converting list/tuple/dict/Union/Literal and primitive values to the
fields' types, and warns on (or, ``strict``, raises for) unknown fields.
Every ``*Config`` of the command lines is built through it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Literal, Union, get_args, get_origin, get_type_hints

logger = logging.getLogger(__name__)


def _convert(value: Any, hint: Any) -> Any:
    """Convert ``value`` to match type ``hint`` recursively."""
    if hint is Any or hint is dataclasses.MISSING:
        return value

    import types

    origin = get_origin(hint)

    if origin is Union or origin is types.UnionType:  # typing.Union and PEP-604 `X | Y`
        args = get_args(hint)
        if value is None and type(None) in args:
            return None
        errors = []
        for arg in args:
            if arg is type(None):
                continue
            try:
                return _convert(value, arg)
            except (TypeError, ValueError) as e:  # try next member
                errors.append(e)
        raise TypeError(f"value {value!r} matches no member of {hint}: {errors}")

    if origin is Literal:
        if value not in get_args(hint):
            raise ValueError(f"value {value!r} not in allowed literals {get_args(hint)}")
        return value

    if origin in (list, tuple):
        args = get_args(hint)
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"expected sequence for {hint}, got {type(value)}")
        if origin is tuple and args and args[-1] is not Ellipsis:
            return tuple(_convert(v, a) for v, a in zip(value, args))
        elem = args[0] if args else Any
        out = [_convert(v, elem) for v in value]
        return tuple(out) if origin is tuple else out

    if origin is dict:
        args = get_args(hint)
        kt, vt = args if args else (Any, Any)
        if not isinstance(value, dict):
            raise TypeError(f"expected dict for {hint}, got {type(value)}")
        return {_convert(k, kt): _convert(v, vt) for k, v in value.items()}

    if dataclasses.is_dataclass(hint) and isinstance(hint, type):
        if isinstance(value, hint):
            return value
        if not isinstance(value, dict):
            raise TypeError(f"expected dict to build {hint.__name__}, got {type(value)}")
        return build_with_type_check(hint, value)

    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        raise TypeError(f"cannot interpret {value!r} as bool")

    if hint in (int, float, str):
        if isinstance(value, hint):
            return value
        if hint is float and isinstance(value, int):
            return float(value)
        if hint is int and isinstance(value, float) and value.is_integer():
            return int(value)
        if hint is str and isinstance(value, (int, float)):
            return str(value)
        if isinstance(value, str):
            return hint(value)
        raise TypeError(f"cannot convert {value!r} to {hint}")

    if isinstance(hint, type) and isinstance(value, hint):
        return value
    if isinstance(hint, type):
        try:
            return hint(value)
        except Exception as e:
            raise TypeError(f"cannot construct {hint} from {value!r}") from e
    return value


def build_with_type_check(cls: type, data: dict[str, Any] | None, strict: bool = False):
    """Instantiate dataclass ``cls`` from nested dict ``data`` with type coercion.

    Unknown fields warn (or raise if ``strict``). Nested dataclass fields are
    built recursively.
    """
    if data is None:
        data = {}
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    hints = get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            msg = f"unknown field {key!r} for {cls.__name__} (ignored)"
            if strict:
                raise TypeError(msg)
            logger.warning(msg)
            continue
        kwargs[key] = _convert(value, hints.get(key, Any))
    return cls(**kwargs)


def asdict_filtered(obj) -> dict:
    """dataclasses.asdict that converts Paths and tuples to json-friendly types."""
    import pathlib

    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, pathlib.Path):
            return str(v)
        return v

    return conv(obj)
