"""A parser for the subset of YAML the repository's configuration uses.

PyYAML is not installed on the machine with the card, so the presets under
`conf/` and the CLI's `key=value` overrides go through this module. It
returns what `yaml.safe_load` returns for:

- block mappings (`key: value`, `key:` followed by a deeper block or by a
  block list at the key's own indentation) and block lists (`- value`);
- flow lists of scalars (`[HISS]`, `[1, 2]`, `[]`);
- plain, single-quoted and double-quoted scalars, with comments (`#` at the
  start of a line or after whitespace);
- YAML 1.1 typing as PyYAML's resolver does it: `true`/`false` (and
  `yes`/`no`/`on`/`off` in their three spellings), `null`/`~`/empty, ints
  (decimal, `0b`, `0x`, leading-zero octal, `_` separators), floats with a
  dot (an exponent needs its sign: `3.0e-05` is a float, `2e-4` stays a
  string), `.inf` and `.nan`.

Anything outside the subset (flow mappings, nested flow lists, anchors,
tags, block scalars, documents markers, timestamps, mappings inside a
block list, tabs) raises `YamlError` naming the line.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

__all__ = ["YamlError", "loads", "load_file"]


class YamlError(ValueError):
    """Input outside the supported subset, or malformed."""


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = ("yes", "true", "on")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_INDICATORS = "&*!|>%@`{}?"


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    digits = [cast(part) for part in text.lstrip("+-").split(":")]
    value, base = 0, 1
    digits.reverse()
    for d in digits:
        value += d * base
        base *= 60
    return sign * value


def _to_int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _to_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _plain(text: str, line: int) -> Any:
    """A plain scalar, typed as PyYAML's resolver types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    if _TIMESTAMP.match(text):
        raise YamlError(f"line {line}: timestamps are outside the supported subset: {text!r}")
    if text[0] in _INDICATORS or text.startswith(("- ", "? ", ": ")) or text in ("-", "?"):
        raise YamlError(f"line {line}: unsupported YAML construct: {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlError(f"line {line}: unexpected mapping or comment in a scalar: {text!r}")
    return text


def _quoted(text: str, pos: int, line: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[pos]; returns (value, end)."""
    quote = text[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            e = text[i + 1: i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = text[i + 2: i + 2 + n]
                if len(code) != n or not all(h in "0123456789abcdefABCDEF" for h in code):
                    raise YamlError(f"line {line}: bad escape in {text!r}")
                out.append(chr(int(code, 16)))
                i += 2 + n
                continue
            raise YamlError(f"line {line}: unknown escape \\{e} in {text!r}")
        out.append(c)
        i += 1
    raise YamlError(f"line {line}: unterminated quoted scalar: {text!r}")


def _strip_comment(text: str, line: int) -> str:
    """`text` without its trailing comment (a `#` at the start or after
    whitespace, outside quotes), right-stripped."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[,:-"):
            _, i = _quoted(text, i, line)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _flow_list(text: str, line: int) -> list:
    if not text.endswith("]"):
        raise YamlError(f"line {line}: unterminated flow list: {text!r}")
    body = text[1:-1].strip()
    items: List[Any] = []
    if not body:
        return items
    i = 0
    while True:
        while i < len(body) and body[i] == " ":
            i += 1
        if i < len(body) and body[i] in "'\"":
            value, i = _quoted(body, i, line)
            items.append(value)
            rest = body[i:].lstrip()
            if rest and not rest.startswith(","):
                raise YamlError(f"line {line}: junk after a quoted item in {text!r}")
            i = len(body) - len(rest)
        else:
            j = body.find(",", i)
            item = (body[i:] if j < 0 else body[i:j]).strip()
            if not item or item[0] in "[{" or ": " in item or item.endswith(":"):
                raise YamlError(f"line {line}: unsupported flow list item in {text!r}")
            items.append(_plain(item, line))
            i = len(body) if j < 0 else j
        if i >= len(body):
            return items
        i += 1  # the comma
        if not body[i:].strip():
            return items  # a trailing comma, as PyYAML allows


def _value(text: str, line: int) -> Any:
    """An inline value: a quoted scalar, a flow list or a plain scalar."""
    if not text:
        return None
    if text[0] in "'\"":
        value, end = _quoted(text, 0, line)
        if text[end:].strip():
            raise YamlError(f"line {line}: junk after a quoted scalar: {text!r}")
        return value
    if text[0] == "[":
        return _flow_list(text, line)
    return _plain(text, line)


def _split_key(text: str, line: int):
    """(key, rest) when `text` is a mapping entry, else None."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, line)
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:].strip()
        return None
    m = re.match(r"^([^\s#'\"\[\]{},][^#]*?)\s*:(?:\s+|$)", text)
    if m is None or text[0] == "-" and text[1:2] in (" ", ""):
        return None
    key = _plain(m.group(1), line)
    return key, text[m.end():].strip()


class _Lines:
    def __init__(self, text: str):
        self.items: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for number, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
                raise YamlError(f"line {number}: tabs in indentation")
            content = _strip_comment(raw.strip(), number)
            if not content:
                continue
            if content in ("---", "...") or content.startswith(("%", "--- ", "... ")):
                raise YamlError(f"line {number}: document markers and directives are "
                                "outside the supported subset")
            self.items.append((number, len(raw) - len(raw.lstrip(" ")), content))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else None


def _block(lines: _Lines, indent: int) -> Any:
    """The block node whose entries sit at `indent`."""
    number, _, content = lines.peek()
    if content == "-" or content.startswith("- "):
        return _block_list(lines, indent)
    if _split_key(content, number) is not None:
        return _block_mapping(lines, indent)
    lines.pos += 1
    nxt = lines.peek()
    if nxt is not None and nxt[1] >= indent:
        raise YamlError(f"line {nxt[0]}: multi-line scalars are outside the supported subset")
    return _value(content, number)


def _block_list(lines: _Lines, indent: int) -> list:
    out = []
    while True:
        cur = lines.peek()
        if cur is None or cur[1] < indent:
            return out
        number, ind, content = cur
        if ind > indent:
            raise YamlError(f"line {number}: bad indentation")
        if not (content == "-" or content.startswith("- ")):
            return out
        lines.pos += 1
        item = content[1:].strip()
        if not item:
            raise YamlError(f"line {number}: nested blocks in a list are outside the "
                            "supported subset")
        if _split_key(item, number) is not None or item == "-" or item.startswith("- "):
            raise YamlError(f"line {number}: mappings and lists inside a block list are "
                            "outside the supported subset")
        out.append(_value(item, number))


def _block_mapping(lines: _Lines, indent: int) -> dict:
    out = {}
    while True:
        cur = lines.peek()
        if cur is None or cur[1] < indent:
            return out
        number, ind, content = cur
        if ind > indent:
            raise YamlError(f"line {number}: bad indentation")
        entry = _split_key(content, number)
        if entry is None:
            if content == "-" or content.startswith("- "):
                return out  # a list at the parent key's indentation ends here
            raise YamlError(f"line {number}: expected `key: value`, got {content!r}")
        key, rest = entry
        if isinstance(key, (list, dict)):
            raise YamlError(f"line {number}: unhashable key")
        lines.pos += 1
        if rest:
            out[key] = _value(rest, number)
            continue
        nxt = lines.peek()
        if nxt is not None and (nxt[1] > indent or nxt[1] == indent and (
                nxt[2] == "-" or nxt[2].startswith("- "))):
            out[key] = _block(lines, nxt[1])
        else:
            out[key] = None


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    lines = _Lines(text)
    first = lines.peek()
    if first is None:
        return None
    node = _block(lines, first[1])
    rest = lines.peek()
    if rest is not None:
        raise YamlError(f"line {rest[0]}: unexpected content {rest[2]!r}")
    return node


def load_file(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
