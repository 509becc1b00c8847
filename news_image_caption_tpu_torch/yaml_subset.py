"""A reader for the YAML the repository's configs are written in.

The port needs no YAML package: `safe_load(text)` reads the subset that
`configs/**/*.yaml` use and resolves each scalar as PyYAML's
`yaml.safe_load` resolves it (YAML 1.1). Anything outside the subset
raises `YamlSubsetError`; the reader never guesses. The subset:

- block mappings by indentation (spaces only): `key: value`, and `key:`
  followed by a more indented block (or by nothing: null);
- flow mappings `{a: 1, b: [2, 3]}` and flow lists `[1, 2]`, nested and
  spanning lines;
- `#` comments, at the start of a line or after whitespace;
- plain scalars: null (`~`, `null`, nothing), bool (`true`, `yes`, `on`,
  `False`, ...), int (decimal, `0x`, `0b`, a leading 0 for octal,
  underscores), float (with a dot, `.inf`, `.nan`; `1e-6` has no dot and
  stays a string, as in YAML 1.1), else a string.

Not read: quoted scalars, block sequences (`- item`), block scalars
(`|`, `>`), anchors, aliases, tags, directives, document markers,
complex keys, plain scalars over several lines, sexagesimal numbers,
timestamps, merge keys and duplicate keys.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
# PyYAML's implicit resolvers (resolver.py), sexagesimal forms apart.
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_UNREAD = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                     |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*
                     |<<|=)$""", re.X)
_INDICATORS = set("[]{},#&*!|>'\"%@`")
_FLOW_STOP = set(",[]{}")


class YamlSubsetError(ValueError):
    pass


def _error(line: int, msg: str) -> YamlSubsetError:
    return YamlSubsetError(f"line {line}: {msg}")


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    return sign * float(value)


def scalar(text: str, line: int = 0) -> Any:
    """A plain scalar as `yaml.safe_load` resolves it."""
    if text in _NULL:
        return None
    if text[0] in _INDICATORS or (text[0] in "-?:" and (
            len(text) == 1 or text[1] == " ")):
        raise _error(line, f"{text!r} is outside the YAML subset")
    if ": " in text or text.endswith(":") or " #" in text:
        raise _error(line, f"{text!r} is outside the YAML subset")
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _UNREAD.match(text):
        raise _error(line, f"{text!r} (sexagesimal, timestamp or merge) "
                           "is outside the YAML subset")
    return text


def _strip_comment(text: str) -> str:
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


class _Flow:
    """Recursive descent over one flow collection (may span lines)."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def plain(self, in_map_key: bool) -> Any:
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in _FLOW_STOP:
                break
            if ch == ":" and (self.i + 1 == len(self.s)
                              or self.s[self.i + 1] in " ,]}"):
                if not in_map_key:
                    raise _error(self.line, "a mapping inside a flow list "
                                            "is outside the YAML subset")
                break
            self.i += 1
        return scalar(self.s[start:self.i].strip(), self.line)

    def value(self) -> Any:
        ch = self.peek()
        if ch == "{":
            return self.mapping()
        if ch == "[":
            return self.sequence()
        if ch in ("", ",", "]", "}"):
            return None
        return self.plain(in_map_key=False)

    def mapping(self) -> Dict:
        self.i += 1
        out: Dict = {}
        while self.peek() != "}":
            if self.peek() in ("", "{", "["):
                raise _error(self.line, "unclosed or complex flow mapping")
            key = self.plain(in_map_key=True)
            if key in out:
                raise _error(self.line, f"duplicate key {key!r}")
            value = None
            if self.peek() == ":":
                self.i += 1
                value = self.value()
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise _error(self.line, "expected ',' or '}' in a flow "
                                        "mapping")
        self.i += 1
        return out

    def sequence(self) -> List:
        self.i += 1
        out: List = []
        while self.peek() != "]":
            if self.peek() in ("", ","):
                raise _error(self.line, "unclosed flow list or empty entry")
            out.append(self.value())
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise _error(self.line, "expected ',' or ']' in a flow list")
        self.i += 1
        return out


_KEY = re.compile(r"^(.*?):(?: +(.*))?$")


def _depth(text: str) -> int:
    return (text.count("{") + text.count("[")
            - text.count("}") - text.count("]"))


def _lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of every line that holds more
    than a comment."""
    out = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        content = body.lstrip(" ")
        if content[0] == "\t":
            raise _error(no, "a tab in the indentation")
        if content.startswith(("---", "...", "%")):
            raise _error(no, "directives and document markers are outside "
                             "the YAML subset")
        out.append((len(body) - len(content), content, no))
    return out


def _block(lines, i: int, indent: int) -> Tuple[Dict, int]:
    out: Dict = {}
    while i < len(lines):
        ind, text, no = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise _error(no, "unexpected indentation")
        if text[0] in "-?" and (len(text) == 1 or text[1] == " "):
            raise _error(no, "block sequences and complex keys are outside "
                             "the YAML subset")
        m = _KEY.match(text)
        if m is None:
            raise _error(no, f"expected 'key: value', got {text!r}")
        key = scalar(m.group(1).strip(), no)
        if key in out:
            raise _error(no, f"duplicate key {key!r}")
        rest = (m.group(2) or "").strip()
        i += 1
        nested = i < len(lines) and lines[i][0] > indent
        if not rest:
            if nested:
                out[key], i = _block(lines, i, lines[i][0])
            else:
                out[key] = None
        elif rest[0] in "{[":
            # No quoted scalars: every bracket is structure, so the
            # collection ends on the line where the brackets balance.
            text = rest
            while (_depth(text) > 0 and i < len(lines)
                   and lines[i][0] > indent):
                text += " " + lines[i][1]
                i += 1
            parser = _Flow(text, no)
            out[key] = parser.value()
            if parser.peek():
                raise _error(no, f"text after a flow collection: "
                                 f"{parser.s[parser.i:]!r}")
        else:
            out[key] = scalar(rest, no)
            if nested:
                raise _error(lines[i][2], "a plain scalar over several "
                                          "lines is outside the YAML subset")
    return out, i


def safe_load(text: str) -> Any:
    """The document in `text`: a mapping, or None when it is empty."""
    lines = _lines(text)
    if not lines:
        return None
    out, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise _error(lines[i][2], "unexpected indentation")
    return out
