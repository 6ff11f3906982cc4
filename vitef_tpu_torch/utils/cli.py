"""Command-line configs and a fire-like dispatcher. Counterpart of
``vitef_tpu/utils/cli.py`` (``_parse_value``, ``from_cli``,
``load_config_from_cli`` :24-92, ``make_cli`` :95-129).

- ``load_config_from_cli(ConfigCls, argv)``: the dataclass's defaults, then
  the YAML file of ``config=<path>``, then dotted ``a.b=value`` overrides,
  built into a typed ``ConfigCls`` (:func:`~vitef_tpu_torch.utils.typed.build_with_type_check`).
- ``make_cli({"run": fn})``: ``python -m mod run --arg value`` calls
  ``fn(arg=value)``.

The JAX package reads YAML with PyYAML, which the machine with the card
does not have. The port reads the subset of YAML that ``apps/vit/configs``
uses, by its own code, and gives what ``yaml.safe_load`` gives there under
YAML 1.1: a file is a block mapping of ``key: value`` lines and comments; a
value is a plain scalar, a quoted string or a one-line flow sequence
(``[3, 224, 224]``, ``[]``). Plain scalars resolve as YAML 1.1 does: ints
with underscores and octal, hex and binary forms (``10_000`` is 10000),
floats only with a dot (``1e-2`` stays the string ``"1e-2"``, which the
typed builder makes a float), ``true``/``yes``/``on`` and ``false``/``no``/
``off`` and ``null``/``~`` in lower, Capitalised and UPPER case. Anything
outside the subset raises ValueError: nested or indented blocks, block
sequences, flow mappings, anchors, tags, multi-line scalars, timestamps and
sexagesimal numbers. A command-line value that is a leading-zero digit
string (``checkpoint_step=0000001000``) stays a string, as in the JAX
package, where YAML would read it as an octal int.
"""

from __future__ import annotations

import ast
import math
import re
import sys
from typing import Any, Callable

# PyYAML's resolver for these scalars: lower, Capitalised or UPPER case.
_WORDS = {form: value
          for word, value in (("true", True), ("yes", True), ("on", True), ("false", False),
                              ("no", False), ("off", False), ("null", None))
          for form in (word, word.capitalize(), word.upper())}
_WORDS.update({"~": None, "": None})

# YAML 1.1's implicit int and float forms (PyYAML's resolver).
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF, _NAN = re.compile(r"[-+]?\.(?:inf|Inf|INF)"), re.compile(r"\.(?:nan|NaN|NAN)")
# Forms the subset does not read: sexagesimal numbers, timestamps, '=' and '<<'.
_UNREAD = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?|"
                     r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?|=|<<")
_LEADING_ZERO_INT = re.compile(r"0\d+")
_INDICATORS = "&*!|>%@`]},"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _resolve_plain(text: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers."""
    if text in _WORDS:
        return _WORDS[text]
    if _UNREAD.fullmatch(text):
        raise ValueError(f"YAML scalar {text!r} is outside the subset this reader takes")
    if _INT.fullmatch(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits != "0" and digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    return text


def _quoted(s: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at ``s[i]`` and the index past its closing quote."""
    quote, i, out = s[i], i + 1, []
    while i < len(s):
        c = s[i]
        if c == quote:
            if quote == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and quote == '"':
            code = s[i + 1:i + 2]
            if code not in _ESCAPES:
                raise ValueError(f"escape \\{code} in {s!r} is outside the YAML subset")
            out.append(_ESCAPES[code])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"unclosed quote in YAML value {s!r}")


def _skip_blank(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t":
        i += 1
    return i


def _flow_item(s: str, i: int) -> tuple[Any, int]:
    """One item of a flow sequence starting at ``s[i]`` and the index past it."""
    c = s[i]
    if c == "[":
        return _flow_sequence(s, i)
    if c in "'\"":
        return _quoted(s, i)
    if c in "{#" + _INDICATORS or (c in "-?:" and s[i + 1:i + 2] in ("", " ", ",", "]")):
        raise ValueError(f"YAML flow item at {s[i:]!r} is outside the subset")
    j = i
    while j < len(s) and s[j] not in ",[]{}" and not (s[j] == "#" and s[j - 1] in " \t") \
            and not (s[j] == ":" and s[j + 1:j + 2] in ("", " ", ",", "[", "]", "{", "}")):
        j += 1
    if j < len(s) and s[j] in ":{":
        raise ValueError(f"YAML flow mapping in {s!r} is outside the subset")
    return _resolve_plain(s[i:j].rstrip(" \t")), j


def _flow_sequence(s: str, i: int) -> tuple[list, int]:
    """The flow sequence starting at ``s[i] == "["`` and the index past its ``]``."""
    items, i = [], i + 1
    while True:
        i = _skip_blank(s, i)
        if i < len(s) and s[i] == "]":
            return items, i + 1
        if i >= len(s) or s[i] == ",":
            raise ValueError(f"YAML flow sequence {s!r} is unclosed or has an empty item")
        item, i = _flow_item(s, i)
        items.append(item)
        i = _skip_blank(s, i)
        if i < len(s) and s[i] == ",":
            i += 1
        elif i >= len(s) or s[i] != "]":
            raise ValueError(f"YAML flow sequence {s!r} is unclosed or malformed")


def _node(text: str) -> Any:
    """The value of one node written on one line (after a key's ``: ``, or a
    whole command-line value): a flow sequence, a quoted or a plain scalar,
    with an optional trailing comment."""
    if "\n" in text or "\r" in text:
        raise ValueError(f"multi-line YAML value {text!r} is outside the subset")
    s = text.strip(" \t")
    if not s or s.startswith("#"):
        return None
    c = s[0]
    if c in "[\"'":
        value, i = _flow_sequence(s, 0) if c == "[" else _quoted(s, 0)
        rest = s[i:].strip(" \t")
        if rest and not (rest.startswith("#") and s[i] in " \t"):
            raise ValueError(f"YAML value {text!r} has text after its end")
        return value
    if c in "{" + _INDICATORS or (c in "-?:" and s[1:2] in ("", " ", "\t")):
        raise ValueError(f"YAML value {text!r} is outside the subset")
    plain = re.split(r"[ \t]#", s, maxsplit=1)[0].rstrip(" \t")
    if re.search(r":(?:[ \t]|$)", plain):
        raise ValueError(f"YAML mapping in value {text!r} is outside the subset")
    return _resolve_plain(plain)


def parse_yaml_mapping(text: str) -> dict:
    """A YAML document of top-level ``key: value`` lines, blank lines and
    comments as ``yaml.safe_load`` reads it (an empty document gives {});
    a later duplicate key wins, as in PyYAML."""
    out: dict = {}
    for number, line in enumerate(text.splitlines(), 1):
        stripped = line.strip(" \t")
        if not stripped or stripped.startswith("#"):
            continue
        if line[0] in " \t" or stripped.startswith(("---", "...")) or stripped[0] in "-?[{\"'" \
                + _INDICATORS:
            raise ValueError(f"line {number} {line!r}: only top-level 'key: value' lines "
                             "are read")
        match = re.search(r":(?:[ \t]|$)", line)
        if match is None:
            raise ValueError(f"line {number} {line!r} is not a 'key: value' line")
        key = _resolve_plain(line[:match.start()].rstrip(" \t"))
        out[key] = _node(line[match.end():])
    return out


def _parse_value(raw: str) -> Any:
    """A command-line value read as a one-line YAML node; a leading-zero
    digit string stays a string (YAML 1.1 would read
    ``checkpoint_step=0000001000`` as the octal int 512)."""
    if _LEADING_ZERO_INT.fullmatch(raw):
        return raw
    return _node(raw)


def _set_dotted(d: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
        if not isinstance(cur, dict):
            raise TypeError(f"cannot override {dotted}: {k} is not a mapping")
    cur[keys[-1]] = value


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def from_cli(argv: list[str] | None = None) -> dict:
    """``key=value`` arguments (``sys.argv[1:]`` by default) as a nested dict;
    a dotted key makes nested dicts."""
    if argv is None:
        argv = sys.argv[1:]
    out: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value argument, got {arg!r}")
        key, _, raw = arg.partition("=")
        _set_dotted(out, key, _parse_value(raw))
    return out


def load_config_from_cli(config_cls: type, argv: list[str] | None = None):
    """Defaults <- the YAML file of ``config=<path>`` <- dotted overrides, as
    a typed ``config_cls``."""
    from .typed import build_with_type_check

    cli = from_cli(argv)
    file_cfg: dict = {}
    cfg_path = cli.pop("config", None)
    if cfg_path:
        with open(cfg_path) as f:
            file_cfg = parse_yaml_mapping(f.read())
    return build_with_type_check(config_cls, _deep_merge(file_cfg, cli))


def _coerce_flag_value(raw: str) -> Any:
    """A flag's value: a Python literal when it is one (``40``, ``0.8``,
    ``"[464, 3280]"``, ``False``, ``3,1,4``), else a YAML 1.1 word
    (``true``/``no``/``null``/``~``...), else the string itself."""
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
