"""A reader and writer for the YAML subset that run directories hold.

The machine with the card has no ``yaml`` package, so the port reads and
writes its run files itself. Two kinds of file exist:

* ``train_config.yaml`` (``Config.save``): a mapping of mappings whose
  values are int, float, bool or str scalars;
* ``inference_params.yaml`` (``Dataset.save_inference_params``): a
  ``%YAML 1.2`` directive, ``---``, flat keys, and flow lists of numbers
  such as ``intrinsic: [..]``.

:func:`loads` parses block mappings nested by indentation, plain, single-
and double-quoted scalars, flow lists of scalars, comments, one
``%YAML`` directive and the ``---`` / ``...`` markers. It resolves plain
scalars as ``yaml.safe_load`` does (YAML 1.1: ``true``/``yes``/``on`` are
booleans, a float needs a dot, ``~``/``null`` are None). With
``block_sequences=True`` it also reads block sequences of scalars under
a key, as ``yaml.safe_dump`` writes the lists of a ROS
``camera_info.yaml``; run files never hold them. Anything else (anchors
and aliases, tags, block sequences otherwise, nested or flow mappings,
multi-line strings, tabs) raises ``ValueError`` naming the line.

:func:`dumps` writes the same text as ``yaml.safe_dump(data,
sort_keys=False)`` for such data, so ``yaml.safe_load`` reads it back
into the same values.
"""

from __future__ import annotations

import math
import re
from typing import Any

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
# PyYAML's YAML 1.1 implicit resolvers for decimal int and float
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# octal, hex, binary and sexagesimal numbers, which YAML 1.1 also resolves
_OTHER_NUMBER = re.compile(r"[-+]?0[0-9_]+$|[-+]?0[xXbBoO]"
                           r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
# plain strings the writer leaves unquoted: they start with a letter or
# underscore and hold nothing YAML gives a meaning
_SAFE_STR = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*$")
_KEY = re.compile(r"([A-Za-z0-9_][A-Za-z0-9_.-]*):(?:\s+(.*))?$")


def _fail(lineno: int, line: str, why: str):
    raise ValueError(f"line {lineno}: {why}: {line.strip()!r}")


def _resolve_plain(tok: str) -> Any:
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return -math.inf if tok.startswith("-") else math.inf
    if _NAN.match(tok):
        return math.nan
    return tok


def _scalar(tok: str, lineno: int, line: str) -> Any:
    """One scalar token (comment already removed, stripped)."""
    if not tok:
        return None
    if tok[0] == "'":
        if len(tok) < 2 or tok[-1] != "'":
            _fail(lineno, line, "unterminated quoted string")
        body = tok[1:-1]
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            _fail(lineno, line, "stray quote in a quoted string")
        return body.replace("''", "'")
    if tok[0] == '"':
        if len(tok) < 2 or tok[-1] != '"':
            _fail(lineno, line, "unterminated quoted string")
        body = tok[1:-1]
        if "\\" in body or '"' in body:
            _fail(lineno, line, "escapes in double-quoted strings are not "
                  "supported")
        return body
    if tok[0] in "&*!|>[]{}@`%" or tok.startswith(("- ", "? ")) \
            or tok == "-":
        _fail(lineno, line, "unsupported YAML construct (anchors, aliases, "
              "tags, block sequences, multi-line strings, flow mappings)")
    if ": " in tok or " #" in tok:
        _fail(lineno, line, "unsupported plain scalar")
    if _OTHER_NUMBER.match(tok):
        _fail(lineno, line, "unsupported number form")
    return _resolve_plain(tok)


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment; quotes are respected."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _value(text: str, lineno: int, line: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            _fail(lineno, line, "a flow list must close on its line")
        inner = text[1:-1].strip()
        if any(ch in inner for ch in "[]{}"):
            _fail(lineno, line, "nested flow collections are not supported")
        if not inner:
            return []
        items = [t.strip() for t in inner.split(",")]
        if items[-1] == "":
            items.pop()
        if any(t == "" for t in items):
            _fail(lineno, line, "empty item in a flow list")
        return [_scalar(t, lineno, line) for t in items]
    return _scalar(text, lineno, line)


def loads(text: str, block_sequences: bool = False) -> Any:
    """Parse ``text`` (see the module docstring for the subset)."""
    root: dict[str, Any] = {}
    # (indent, mapping) from the outermost in; a key without a value opens
    # a mapping whose indent is set by its first child line
    stack: list[tuple[int, dict]] = [(0, root)]
    pending: tuple[int, dict, str] | None = None
    seq: tuple[int, list] | None = None      # the open block sequence
    started = ended = False
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _fail(lineno, raw, "tabs in indentation")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.startswith("%"):
            if started or not re.match(r"%YAML 1\.[12]$", body):
                _fail(lineno, raw, "unsupported directive")
            continue
        if ended or (body == "---" and (started or root)):
            _fail(lineno, raw, "more than one document")
        if body in ("---", "..."):
            started = True
            ended = body == "..."
            continue
        started = True
        indent = len(body) - len(body.lstrip(" "))
        item = body.strip()
        if block_sequences and (item == "-" or item.startswith("- ")):
            # a block sequence of scalars under the pending key, at its
            # indent or deeper (``yaml.safe_dump`` writes lists so)
            if pending is not None and indent >= pending[0]:
                seq = (indent, [])
                pending[1][pending[2]] = seq[1]
                pending = None
            elif seq is None or indent != seq[0]:
                _fail(lineno, raw, "a block sequence item outside a key")
            seq[1].append(_scalar(item[1:].strip(), lineno, raw))
            continue
        seq = None
        m = _KEY.match(item)
        if m is None:
            _fail(lineno, raw, "expected 'key: value'")
        if pending is not None:
            p_indent, p_parent, p_key = pending
            if indent > p_indent:
                child: dict[str, Any] = {}
                p_parent[p_key] = child
                stack.append((indent, child))
            else:
                p_parent[p_key] = None
            pending = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            _fail(lineno, raw, "indentation does not match any open mapping")
        mapping = stack[-1][1]
        key, rest = m.group(1), m.group(2)
        if key in mapping:
            _fail(lineno, raw, f"duplicate key {key!r}")
        if rest is None or not rest.strip():
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _value(rest, lineno, raw)
    return root


def load(path, block_sequences: bool = False) -> Any:
    with open(path) as f:
        return loads(f.read(), block_sequences)


def _format_scalar(v: Any, float_format: str | None) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        if float_format is not None:
            return float_format.format(v)
        # PyYAML's represent_float: repr, and a dot before any exponent
        # (YAML 1.1 reads 1e-06 as a string)
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _SAFE_STR.match(v) and isinstance(_resolve_plain(v), str):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write a {type(v).__name__} ({v!r})")


def dumps(data: dict[str, Any], float_format: str | None = None,
          header: str = "") -> str:
    """Text of a mapping whose values are scalars, lists of scalars
    (written as flow lists) or mappings of the same. ``float_format``
    (e.g. ``"{:.6f}"``) formats finite floats instead of ``repr``;
    ``header`` is written first (e.g. ``"%YAML 1.2\\n---\\n"``)."""
    lines: list[str] = []

    def emit(mapping: dict[str, Any], indent: int) -> None:
        for key, v in mapping.items():
            if not isinstance(key, str) or not _SAFE_STR.match(key):
                raise ValueError(f"cannot write the key {key!r}")
            pad = " " * indent
            if isinstance(v, dict):
                if not v:
                    raise ValueError(f"cannot write the empty mapping {key!r}")
                lines.append(f"{pad}{key}:")
                emit(v, indent + 2)
            elif isinstance(v, (list, tuple)):
                items = ", ".join(_format_scalar(x, float_format)
                                  for x in v)
                lines.append(f"{pad}{key}: [{items}]")
            else:
                lines.append(f"{pad}{key}: "
                             f"{_format_scalar(v, float_format)}")

    emit(data, 0)
    return header + "\n".join(lines) + "\n"


def dump(data: dict[str, Any], path, **kwargs) -> None:
    with open(path, "w") as f:
        f.write(dumps(data, **kwargs))
