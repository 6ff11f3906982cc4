"""A fire-like command dispatcher. Counterpart of ``make_cli`` in
``vitef_tpu/utils/cli.py`` (:95-129).

``python -m mod run --arg value`` calls ``run(arg=value)``. A value is read
as a Python literal when it is one (``40``, ``0.8``, ``"[464, 3280]"``,
``False``, ``3,1,4``), else as a YAML 1.1 core scalar for the words
``true``/``false``/``yes``/``no``/``on``/``off``/``null``/``~``, else as the
string itself, as the JAX package reads flags with PyYAML. The port needs no
PyYAML: the machine with the card has none.
"""

from __future__ import annotations

import ast
import sys
from typing import Any, Callable

# PyYAML's resolver for these scalars: lower, Capitalised or UPPER case.
_WORDS = {form: value
          for word, value in (("true", True), ("yes", True), ("on", True), ("false", False),
                              ("no", False), ("off", False), ("null", None))
          for form in (word, word.capitalize(), word.upper())}
_WORDS.update({"~": None, "": None})


def _coerce_flag_value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return _WORDS.get(raw.strip(), raw)


def make_cli(commands: dict[str, Callable], argv: list[str] | None = None) -> Any:
    """Minimal python-fire equivalent: ``prog <command> --key value ...``."""
    if argv is None:
        argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("commands:", ", ".join(commands))
        return None
    name, rest = argv[0], argv[1:]
    if name not in commands:
        raise SystemExit(f"unknown command {name!r}; available: {list(commands)}")
    kwargs: dict[str, Any] = {}
    i = 0
    while i < len(rest):
        arg = rest[i]
        if not arg.startswith("--"):
            raise SystemExit(f"expected --key [value], got {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, _, raw = key.partition("=")
            kwargs[key] = _coerce_flag_value(raw)
            i += 1
        elif i + 1 < len(rest) and not rest[i + 1].startswith("--"):
            kwargs[key] = _coerce_flag_value(rest[i + 1])
            i += 2
        else:
            kwargs[key] = True
            i += 1
    return commands[name](**kwargs)
