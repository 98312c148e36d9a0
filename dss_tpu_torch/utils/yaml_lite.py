"""The YAML subset the repo's configs use, read and written without PyYAML.

Reading follows YAML 1.1 as `yaml.safe_load` resolves it, for:

- block mappings nested by indentation, and block sequences of scalars
  (also the "indentless" `key:\\n- item` form that `yaml.safe_dump` writes);
- `#` comments, on their own line or after a value;
- plain scalars resolved as PyYAML resolves them: null (`null`, `~`, empty),
  bool (`true`, `yes`, `on`, … in three cases), int (decimal, `0x`, `0b`,
  leading-zero octal, `:` sexagesimal, `_` separators) and float (only with
  a dot, `.inf` or `.nan`: `1e-3` stays a string, as in PyYAML); everything
  else is a string, absolute paths included;
- single- and double-quoted strings (always strings);
- flow sequences and flow mappings (`[500, 800]`, `{}`), nested.

Anything else (anchors, tags, block scalars, multi-line plain scalars,
timestamps, documents) raises ValueError instead of being misread.

`dump` writes block mappings with sorted keys and flow sequences, and
quotes every string that would otherwise read back as another type.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (resolver.py), for plain scalars only.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]"
                        r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?"
                        r"(?::[0-9][0-9])?))?)?)$")
_TRUE = ("yes", "true", "on")
# Characters that may not start a plain scalar, or that make one ambiguous.
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _sexagesimal(digits: str, conv) -> Any:
    parts = [conv(p) for p in digits.split(":")]
    value, base = 0, 1
    for p in reversed(parts):
        value += p * base
        base *= 60
    return value


def _to_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    if s[0] in "+-":
        s = s[1:]
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    if ":" in s:
        return sign * _sexagesimal(s, int)
    return sign * int(s)


def _to_float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    if s[0] in "+-":
        s = s[1:]
    if s == ".inf":
        return sign * math.inf
    if s == ".nan":
        return math.nan
    if ":" in s:
        return sign * _sexagesimal(s, float)
    return sign * float(s)


def _resolve_plain(s: str) -> Any:
    """A plain scalar's value, as yaml.safe_load types it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in _TRUE
    if _INT.match(s):
        return _to_int(s)
    if _FLOAT.match(s):
        return _to_float(s)
    if _TIMESTAMP.match(s):
        raise ValueError(f"yaml_lite: timestamps are not supported: {s!r}")
    if s[0] in "&*!|>%@`" or s.startswith("<<"):
        raise ValueError(f"yaml_lite: unsupported YAML syntax: {s!r}")
    return s


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a `#` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[{,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _unquote(s: str) -> str:
    if s[0] == "'":
        if len(s) < 2 or s[-1] != "'":
            raise ValueError(f"yaml_lite: unterminated string {s!r}")
        return s[1:-1].replace("''", "'")
    if len(s) < 2 or s[-1] != '"':
        raise ValueError(f"yaml_lite: unterminated string {s!r}")
    try:
        return json.loads(s)
    except json.JSONDecodeError as e:
        raise ValueError(f"yaml_lite: unsupported escape in {s!r}") from e


def _scalar(s: str) -> Any:
    s = s.strip()
    if s and s[0] in "'\"":
        return _unquote(s)
    if s and s[0] in "[{":
        value, end = _flow(s, 0)
        if s[end:].strip():
            raise ValueError(f"yaml_lite: text after a flow collection: {s!r}")
        return value
    return _resolve_plain(s)


def _flow(s: str, i: int) -> Tuple[Any, int]:
    """Parse the flow collection starting at s[i] ('[' or '{'); returns
    (value, index after its closing bracket)."""
    close = "]" if s[i] == "[" else "}"
    items: List[str] = []
    i += 1
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i >= len(s):
            raise ValueError(f"yaml_lite: unterminated flow collection {s!r}")
        if s[i] == close:
            i += 1
            break
        # one entry: up to a ',' or the closing bracket outside quotes and
        # nested collections
        start, quote, depth = i, None, 0
        while i < len(s):
            ch = s[i]
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"" and (i == start or s[i - 1] in " \t:"):
                quote = ch
            elif ch in "[{":
                depth += 1
            elif depth:
                depth -= ch in "]}"
            elif ch in ",]}":
                break
            i += 1
        items.append(s[start:i].strip())
        if i < len(s) and s[i] == ",":
            i += 1
    if close == "]":
        return [_scalar(x) for x in items], i
    out = {}
    for x in items:
        k, v = _split_key(x)
        if v is None:
            raise ValueError(f"yaml_lite: a flow mapping entry must be "
                             f"`key: value`: {s!r}")
        out[_scalar(k)] = _scalar(v)
    return out, i


def _split_key(content: str):
    """(key, rest) for `key: rest` / `key:`, or (content, None) when the
    line is not a mapping entry.  The separator is the first ':' followed by
    a space or the end, outside quotes."""
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] in " \t"):
            return content[:i].strip(), content[i + 1:].strip()
    return content, None


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("yaml_lite: tabs may not indent YAML")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        content = line.lstrip(" ")
        if content in ("---", "...") or content.startswith("%"):
            raise ValueError(f"yaml_lite: documents and directives are not "
                             f"supported: {content!r}")
        out.append((len(line) - len(content), content))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        item = lines[i][1][1:].strip()
        if _split_key(item)[1] is not None or _is_item(item):
            raise ValueError(f"yaml_lite: only scalars may be block sequence "
                             f"items: {item!r}")
        out.append(_scalar(item))
        i += 1
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"yaml_lite: unexpected indentation at "
                         f"{lines[i][1]!r}")
    return out, i


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        key, rest = _split_key(content)
        if rest is None:
            raise ValueError(f"yaml_lite: expected `key: value`, got "
                             f"{content!r} (multi-line scalars are not "
                             f"supported)")
        key = _scalar(key)
        if key in out:
            raise ValueError(f"yaml_lite: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        elif (i < len(lines) and lines[i][0] == indent
              and _is_item(lines[i][1])):
            out[key], i = _sequence(lines, i, indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"yaml_lite: unexpected indentation at "
                         f"{lines[i][1]!r}")
    return out, i


def loads(text: str) -> Any:
    """The value of one YAML document; None for an empty one."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1])[1] is None \
            and not _is_item(lines[0][1]):
        return _scalar(lines[0][1])
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"yaml_lite: unexpected indentation at "
                         f"{lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _dump_str(s: str, flow: bool) -> str:
    plain_ok = (
        s
        and s == s.strip()
        and s[0] not in _INDICATORS
        and not (flow and any(c in s for c in ",[]{}"))
        and ": " not in s and " #" not in s and not s.endswith(":")
        and s.isprintable()
    )
    if plain_ok:
        try:
            if _resolve_plain(s) == s:
                return s
        except ValueError:
            pass  # reads as an unsupported type: quote it
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    return json.dumps(s)


def _dump_scalar(v: Any, flow: bool = False) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        # PyYAML's rule: an exponent without a dot would read as a string
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        return _dump_str(v, flow)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x, True) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_scalar(k, True)}: {_dump_scalar(x, True)}"
                               for k, x in sorted(v.items(), key=_key)) + "}"
    raise TypeError(f"yaml_lite cannot write {type(v).__name__}: {v!r}")


def _key(item):
    return str(item[0])


def dumps(data: Any) -> str:
    """YAML text that yaml.safe_load (and loads) reads back as `data`:
    nested dicts as block mappings with sorted keys, lists as flow
    sequences."""
    if not isinstance(data, dict):
        return _dump_scalar(data) + "\n"
    out: List[str] = []

    def emit(d: dict, indent: int):
        for k, v in sorted(d.items(), key=_key):
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(" " * indent + key + ":")
                emit(v, indent + 2)
            else:
                out.append(" " * indent + key + ": " + _dump_scalar(v))

    emit(data, 0)
    return "\n".join(out) + "\n"


def dump(data: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(data))
