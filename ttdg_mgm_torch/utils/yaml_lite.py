"""A reader for the YAML subset the configuration files use, with no PyYAML.

``safe_load(text)`` returns what ``yaml.safe_load`` returns on:

* block mappings (``KEY: value``, nested by indentation) and block
  sequences of scalars or flow collections (``- item``);
* flow lists and mappings, nested and spread over several lines
  (``SIZES: [[32], [64]]``);
* double- and single-quoted scalars and plain scalars;
* comments (``#`` at the start of a line or after white space).

Plain scalars resolve as YAML 1.1 does in ``yaml.SafeLoader``: the
resolvers' regular expressions and constructors below are PyYAML's
(``yaml/resolver.py``, ``yaml/constructor.py``), so ``1e-4`` stays a string
(a float needs a dot), ``yes``/``off`` are booleans, ``~`` and the empty
scalar are ``None``, ``0x1f`` and ``0o``-less ``017`` are integers, and
``2024-01-31`` is a date.  Anchors, aliases, tags, block scalars (``|``,
``>``) and multi-document streams raise :class:`YAMLError`.
"""

from __future__ import annotations

import datetime
import re

__all__ = ["YAMLError", "safe_load"]


class YAMLError(ValueError):
    pass


_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)
                    -(?P<day>[0-9][0-9]?)
                    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?)
                    :(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
                    (?:\.(?P<fraction>[0-9]*))?
                    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_DATE_ONLY = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast):
    out, base = 0, 1
    for part in reversed(value.split(":")):
        out += cast(part) * base
        base *= 60
    return out


def _int(value: str) -> int:
    value = value.replace("_", "")
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
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _timestamp(m: re.Match):
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if m["fraction"]:
        fraction = int(m["fraction"][:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                             int(m["second"]), fraction, tzinfo=tz)


def resolve_plain(s: str):
    """A plain scalar's value under ``yaml.SafeLoader``'s implicit resolvers."""
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _FLOAT.match(s):
        return _float(s)
    if _INT.match(s):
        return _int(s)
    if _NULL.match(s):
        return None
    m = _TIMESTAMP.match(s)
    if m and (m["hour"] or _DATE_ONLY.match(s)):
        return _timestamp(m)
    if s == "<<" or s == "=":
        raise YAMLError(f"unsupported scalar {s!r}")
    return s


# -- flow context ------------------------------------------------------------------

class _Flow:
    """Recursive-descent parser of one flow node (a scalar, ``[...]`` or
    ``{...}``) in ``text`` from ``pos``."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def error(self, msg: str):
        raise YAMLError(f"{msg} at column {self.pos} of {self.text!r}")

    def skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def peek(self) -> str:
        self.skip()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def node(self, in_flow: bool):
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c == '"':
            return self.double()
        if c == "'":
            return self.single()
        return self.plain(in_flow)

    def seq(self):
        self.pos += 1
        out = []
        while True:
            c = self.peek()
            if c == "]":
                self.pos += 1
                return out
            if c == ",":
                self.error("empty entry in a flow sequence")
            item = self.node(True)
            if self.peek() == ":":
                self.pos += 1
                item = {item: self.node(True)}
            out.append(item)
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "]":
                self.error("expected ',' or ']'")

    def mapping(self):
        self.pos += 1
        out = {}
        while True:
            c = self.peek()
            if c == "}":
                self.pos += 1
                return out
            key = self.node(True)
            if self.peek() == ":":
                self.pos += 1
                value = None if self.peek() in ",}" else self.node(True)
            else:
                value = None
            out[key] = value
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "}":
                self.error("expected ',' or '}'")

    def double(self) -> str:
        t, i, out = self.text, self.pos + 1, []
        while i < len(t) and t[i] != '"':
            if t[i] == "\\":
                i += 1
                if i >= len(t):
                    break
                c = t[i]
                if c in _ESCAPES:
                    out.append(_ESCAPES[c])
                elif c in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[c]
                    out.append(chr(int(t[i + 1:i + 1 + n], 16)))
                    i += n
                else:
                    self.pos = i
                    self.error(f"unknown escape \\{c}")
            else:
                out.append(t[i])
            i += 1
        if i >= len(t):
            self.error("unterminated double-quoted scalar")
        self.pos = i + 1
        return "".join(out)

    def single(self) -> str:
        t, i, out = self.text, self.pos + 1, []
        while i < len(t):
            if t[i] == "'":
                if t[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return "".join(out)
            out.append(t[i])
            i += 1
        self.error("unterminated single-quoted scalar")

    def plain(self, in_flow: bool):
        t, start = self.text, self.pos
        if t[start:start + 1] in tuple("&*!|>%@`"):
            self.error(f"unsupported indicator {t[start]!r}")
        i = start
        while i < len(t):
            c = t[i]
            if in_flow and c in ",[]{}":
                break
            if c == ":" and (i + 1 == len(t) or t[i + 1] in " \t" or (in_flow and t[i + 1] in ",[]{}")):
                break
            i += 1
        self.pos = i
        return resolve_plain(t[start:i].strip())


def _flow_value(text: str):
    p = _Flow(text)
    value = p.node(False)
    if p.peek():
        p.error("trailing characters")
    return value


# -- block context -----------------------------------------------------------------

def _scan(line: str):
    """``line`` without its comment, and the flow brackets it leaves open;
    quotes are tracked where a quoted scalar may start (after white space or
    a flow indicator)."""
    depth, quote, prev = 0, None, " "
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and prev in " \t[{,:-":
            quote = c
        elif c == "#" and prev in " \t":
            return line[:i].rstrip(), depth
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        prev = c
    return line.rstrip(), depth


def _lines(text: str):
    """``(indent, content)`` of the logical lines: comments and blank lines
    dropped, a flow collection spread over several lines joined into one."""
    out, depth = [], 0
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLError("tabs in indentation")
        content, opened = _scan(raw)
        if not content.strip():
            continue
        if content.strip() in ("---", "..."):
            raise YAMLError("document markers are not supported")
        if depth > 0:
            out[-1] = (out[-1][0], out[-1][1] + " " + content.strip())
        else:
            stripped = content.lstrip()
            out.append((len(content) - len(stripped), stripped))
        depth += opened
    if depth > 0:
        raise YAMLError("unclosed flow collection")
    return out


def _split_key(content: str):
    """``(key, rest)`` when ``content`` is a mapping entry, else None."""
    if content[0] in "[{":
        return None
    p = _Flow(content)
    if content[0] in "'\"":
        key = p.double() if content[0] == '"' else p.single()
        if p.peek() != ":":
            return None
    else:
        m = re.search(r":(?:[ \t]|$)", content)
        if m is None:
            return None
        i = m.start()
        key = resolve_plain(content[:i].strip())
        p.pos = i
    p.pos += 1
    return key, content[p.pos:].strip()


def _block(lines, i: int, indent: int):
    """The block node whose lines start at ``lines[i]`` with ``indent``;
    returns ``(value, next index)``."""
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].strip()
            i += 1
            if rest:
                if _split_key(rest) is not None:
                    raise YAMLError("mappings inside block sequences are not supported")
                out.append(_flow_value(rest))
            elif i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
                out.append(value)
            else:
                out.append(None)
        return out, i
    if _split_key(content) is None:
        if i + 1 < len(lines) and lines[i + 1][0] >= indent:
            raise YAMLError(f"multi-line plain scalars are not supported: {content!r}")
        return _flow_value(content), i + 1
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise YAMLError(f"expected a mapping entry, got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _flow_value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def safe_load(text: str):
    """The document in ``text``, as ``yaml.safe_load`` reads it."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YAMLError(f"unexpected line {lines[i][1]!r}")
    return value
