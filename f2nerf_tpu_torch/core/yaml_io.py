"""A reader and writer for the YAML subset that run directories hold.

The machine with the card has no ``yaml`` package, so the port reads and
writes its run files itself. Two kinds of file exist:

* ``train_config.yaml`` (``Config.save``): a mapping of mappings whose
  values are int, float, bool or str scalars;
* ``inference_params.yaml`` (``Dataset.save_inference_params``): a
  ``%YAML 1.2`` directive, ``---``, flat keys, and flow lists of numbers
  such as ``intrinsic: [..]``.

The data-prep tools also read ROS calibration and camera files and read
and write Autoware parameter files, whose top key is ``/**``.

:func:`loads` parses block mappings nested by indentation, plain, single-
and double-quoted scalars, flow lists and flow mappings of scalars (on
one line or continued over several, as hand-edited calibration files
write a camera matrix), comments, one ``%YAML`` directive and the
``---`` / ``...`` markers. It resolves plain scalars as
``yaml.safe_load`` does (YAML 1.1: ``true``/``yes``/``on`` are booleans,
a float needs a dot, ``~``/``null`` are None). With
``block_sequences=True`` it also reads block sequences of scalars or
flow collections under a key, as ``yaml.safe_dump`` writes the lists of
a ROS ``camera_info.yaml``; run files never hold them. Anything else
(anchors and aliases, tags, block sequences otherwise, nested flow
collections, multi-line strings, duplicate keys, tabs) raises
``ValueError`` naming the line.

Keys are plain (a letter, digit, ``_`` or ``/`` first, then those and
``.``, ``*``, ``-``) or quoted.

:func:`dumps` writes the same text as ``yaml.safe_dump(data,
sort_keys=False)`` for run files, so ``yaml.safe_load`` reads it back
into the same values; a key or string that a plain scalar cannot carry is
single-quoted, and lists are written as flow lists.
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
# plain strings the writer leaves unquoted: they start with a letter, an
# underscore or a slash and hold nothing YAML gives a meaning (ROS
# parameter files start with the key ``/**``)
_SAFE_STR = re.compile(r"[A-Za-z_/][A-Za-z0-9_./*-]*$")
# a key: single- or double-quoted, or plain
_KEY = re.compile(r"""('(?:[^']|'')*'|"[^"\\]*"|"""
                  r"[A-Za-z0-9_/][A-Za-z0-9_./*-]*):(?:\s+(.*))?$")


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
              "tags, block sequences, multi-line strings, nested flow "
              "collections)")
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


def _flow_scan(text: str) -> tuple[int, bool, bool, list[int]]:
    """(bracket depth, nested, quote open, the commas of the outermost
    collection) at the end of ``text``, counting brackets and commas
    outside quotes; ``nested``: a bracket opened inside another."""
    depth, nested, quote, commas = 0, False, None, []
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,{\n"):
            quote = ch
        elif ch in "[{":
            nested |= depth > 0
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 1:
            commas.append(i)
    return depth, nested, quote is not None, commas


def _value(text: str, lineno: int, line: str) -> Any:
    """A scalar, or a flow list or flow mapping of scalars (its lines
    joined by newlines)."""
    text = text.strip()
    if text[:1] not in ("[", "{"):
        return _scalar(text, lineno, line)
    close = "]" if text[0] == "[" else "}"
    depth, nested, quote, commas = _flow_scan(text)
    if nested:
        _fail(lineno, line, "nested flow collections are not supported")
    if depth != 0 or quote or not text.endswith(close):
        _fail(lineno, line, "text after a flow collection" if depth == 0
              and not quote else "a flow collection does not close")
    cuts = [0, *commas, len(text) - 1]
    items = [text[i + 1:j].strip() for i, j in zip(cuts, cuts[1:])]
    if items[-1] == "":             # a trailing comma, or an empty body
        items.pop()
    if any(t == "" for t in items):
        _fail(lineno, line, "empty item in a flow collection")
    if any("\n" in t for t in items):
        _fail(lineno, line, "multi-line strings are not supported")
    if close == "]":
        return [_scalar(t, lineno, line) for t in items]
    mapping: dict[str, Any] = {}
    for item in items:
        m = _KEY.match(item)
        if m is None:
            _fail(lineno, line, "expected 'key: value' in a flow mapping")
        key = _key(m.group(1))
        if key in mapping:
            _fail(lineno, line, f"duplicate key {key!r}")
        mapping[key] = _scalar((m.group(2) or "").strip(), lineno, line)
    return mapping


def _key(tok: str) -> str:
    if tok[0] == "'":
        return tok[1:-1].replace("''", "'")
    if tok[0] == '"':
        return tok[1:-1]
    return tok


def _flow_text(first: str, lines: list[str], at: int, lineno: int
               ) -> tuple[str, int]:
    """A value that opens a flow collection on line ``lineno``, with the
    lines after it (from index ``at``) that continue it, as PyYAML reads
    them: (the text, lines joined by newlines, the index after it)."""
    text = first.strip()
    if text[:1] not in ("[", "{"):
        return text, at
    while True:
        depth, _, quote, _ = _flow_scan(text)
        if quote:
            _fail(lineno, lines[at - 1], "multi-line strings are not "
                  "supported")
        if depth <= 0:
            return text, at
        if at == len(lines):
            _fail(lineno, lines[lineno - 1], "a flow collection does not "
                  "close")
        raw = lines[at]
        at += 1
        body = _strip_comment(raw).strip()
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _fail(at, raw, "tabs in indentation")
        if body:
            text += "\n" + body


def loads(text: str, block_sequences: bool = False) -> Any:
    """Parse ``text`` (see the module docstring for the subset)."""
    root: dict[str, Any] = {}
    # (indent, mapping) from the outermost in; a key without a value opens
    # a mapping whose indent is set by its first child line
    stack: list[tuple[int, dict]] = [(0, root)]
    pending: tuple[int, dict, str] | None = None
    seq: tuple[int, list] | None = None      # the open block sequence
    started = ended = False
    lines = text.splitlines()
    at = 0
    while at < len(lines):
        raw = lines[at]
        at += 1
        lineno = at
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
            # a block sequence of scalars or flow collections under the
            # pending key, at its indent or deeper (``yaml.safe_dump``
            # writes lists so)
            if pending is not None and indent >= pending[0]:
                seq = (indent, [])
                pending[1][pending[2]] = seq[1]
                pending = None
            elif seq is None or indent != seq[0]:
                _fail(lineno, raw, "a block sequence item outside a key")
            value, at = _flow_text(item[1:], lines, at, lineno)
            seq[1].append(_value(value, lineno, raw))
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
        key, rest = _key(m.group(1)), m.group(2)
        if key in mapping:
            _fail(lineno, raw, f"duplicate key {key!r}")
        if rest is None or not rest.strip():
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            value, at = _flow_text(rest, lines, at, lineno)
            mapping[key] = _value(value, lineno, raw)
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
            if not isinstance(key, str) or "\n" in key:
                raise ValueError(f"cannot write the key {key!r}")
            pad = " " * indent
            name = _format_scalar(key, None)
            if isinstance(v, dict):
                if not v:
                    raise ValueError(f"cannot write the empty mapping {key!r}")
                lines.append(f"{pad}{name}:")
                emit(v, indent + 2)
            elif isinstance(v, (list, tuple)):
                items = ", ".join(_format_scalar(x, float_format)
                                  for x in v)
                lines.append(f"{pad}{name}: [{items}]")
            else:
                lines.append(f"{pad}{name}: "
                             f"{_format_scalar(v, float_format)}")

    emit(data, 0)
    return header + "\n".join(lines) + "\n"


def dump(data: dict[str, Any], path, **kwargs) -> None:
    with open(path, "w") as f:
        f.write(dumps(data, **kwargs))
