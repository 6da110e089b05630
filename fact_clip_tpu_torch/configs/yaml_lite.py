"""A reader for the YAML subset of the repository's config files.

The card's machine has no PyYAML, so the port reads ``fact_clip_tpu/configs/
*.yaml`` (and the values of ``--set``) with this module.  It covers what those
files use: block mappings by indentation, block lists (``- item``, also at
the indentation of their key), flow lists ``[a, b]`` on one line, ``#``
comments, plain, single- and double-quoted scalars.  Plain scalars resolve
exactly as PyYAML's YAML 1.1 resolver (``yaml.safe_load``) resolves them:
``yes`` / ``on`` / ``true`` are True, ``~`` / ``null`` / an empty value are
None, ``0x10`` is 16, ``012`` is octal 10, ``1_000`` is 1000, ``1:30`` is 90,
``1.5e-4`` is a float but ``1e-4`` (no dot) and ``1.5e4`` (no exponent sign)
are strings, and ``None`` is the string ``"None"``.

Anything else (anchors, aliases, tags, block scalars, flow mappings,
multi-line scalars, document markers, timestamps) raises ``YamlError``.
"""

from __future__ import annotations

import re


class YamlError(ValueError):
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
_NULL = ("", "~", "null", "Null", "NULL")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}
# a plain scalar cannot start with these (PyYAML's scanner, check_plain)
_NOT_PLAIN = set(",[]{}#&*!|>'\"%@`")


def _sexagesimal(value: str, cast):
    out, base = cast(0), 1
    for part in reversed(value.split(":")):
        out += cast(part) * base
        base *= 60
    return out


def _yaml_int(value: str) -> int:
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


def _yaml_float(value: str) -> float:
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


def resolve_plain(text: str):
    """A plain (unquoted) scalar -> the value PyYAML's resolver gives it."""
    if text in _NULL:
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _yaml_float(text)
    if _INT.match(text):
        return _yaml_int(text)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise YamlError(f"unsupported YAML scalar {text!r} (timestamps, merge keys)")
    return text


def _quoted(s: str, i: int):
    """The quoted scalar starting at s[i] -> (value, index after the closing quote)."""
    q, out, i = s[i], [], i + 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
        elif c == '"':
            return "".join(out), i + 1
        elif c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX:
                n = _HEX[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise YamlError(f"bad escape in {s!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise YamlError(f"bad escape \\{e} in {s!r}")
        out.append(c)
        i += 1
    raise YamlError(f"unclosed quote in {s!r} (multi-line scalars are not supported)")


def _rest_is_comment(s: str, i: int) -> None:
    """After a quoted scalar or a flow list only blanks and a comment may follow."""
    rest = s[i:]
    tail = rest.lstrip(" \t")
    if tail and not (tail.startswith("#") and len(tail) < len(rest)):
        raise YamlError(f"unexpected text after a value: {s!r}")


def _plain_end(s: str, i: int, flow: bool) -> int:
    """End of the plain scalar starting at s[i]: a ' #' comment, ': ' or, in a
    flow list, one of ',[]{}'."""
    j = i
    while j < len(s):
        c = s[j]
        if c == "#" and j > i and s[j - 1] in " \t":
            break
        if c == ":" and (j + 1 == len(s) or s[j + 1] in " \t" or (flow and s[j + 1] in ",[]{}")):
            raise YamlError(f"a mapping is not allowed here: {s!r}")
        if flow and c in ",[]{}":
            break
        j += 1
    return j


def _check_plain_start(s: str, i: int) -> None:
    c, nxt = s[i], s[i + 1:i + 2]
    if c in _NOT_PLAIN or (c in "-?:" and nxt in ("", " ", "\t")):
        raise YamlError(f"unsupported YAML construct at {s[i:]!r}")


def _flow_list(s: str, i: int):
    """The flow list starting at s[i] == '[' -> (list, index after ']')."""
    out, i = [], i + 1
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i == len(s):
            raise YamlError(f"unclosed flow list in {s!r} (multi-line flow lists are not "
                            "supported)")
        if s[i] == "]":
            return out, i + 1
        if s[i] in "\"'":
            v, i = _quoted(s, i)
        elif s[i] == "[":
            v, i = _flow_list(s, i)
        elif s[i] == ",":
            raise YamlError(f"empty flow list entry in {s!r}")
        else:
            _check_plain_start(s, i)
            j = _plain_end(s, i, flow=True)
            if j < len(s) and s[j] in "{}#":
                raise YamlError(f"unsupported YAML construct in {s!r}")
            v, i = resolve_plain(s[i:j].rstrip()), j
        out.append(v)
        while i < len(s) and s[i] in " \t":
            i += 1
        if i < len(s) and s[i] == ",":
            i += 1
        elif i < len(s) and s[i] != "]":
            raise YamlError(f"expected ',' or ']' in {s!r}")


def _inline(s: str):
    """The value that fills the rest of a line (stripped, non-empty, no
    mapping key): quoted, a flow list or a plain scalar with its comment."""
    if s[0] in "\"'":
        v, i = _quoted(s, 0)
        _rest_is_comment(s, i)
        return v
    if s[0] == "[":
        v, i = _flow_list(s, 0)
        _rest_is_comment(s, i)
        return v
    _check_plain_start(s, 0)
    return resolve_plain(s[:_plain_end(s, 0, flow=False)].rstrip())


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent, text, no):
        self.indent, self.text, self.no = indent, text, no


def _lines(text: str) -> list:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t":
            raise YamlError(f"line {no}: tabs in indentation")
        if raw.startswith(("---", "...", "%")):
            raise YamlError(f"line {no}: document markers and directives are not supported")
        out.append(_Line(len(raw) - len(body), body.rstrip(), no))
    return out


def _split_key(s: str):
    """'key: rest' -> (key, rest) or None when the line holds no mapping key."""
    if s[0] in "\"'":
        key, i = _quoted(s, 0)
        if s[i:i + 1] == ":" and (i + 1 == len(s) or s[i + 1] in " \t"):
            return key, s[i + 1:].strip()
        return None
    if s[0] in _NOT_PLAIN or (s[0] in "-?:" and s[1:2] in ("", " ", "\t")):
        return None
    j = 0
    while j < len(s):
        if s[j] == "#" and j > 0 and s[j - 1] in " \t":
            return None
        if s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " \t"):
            return resolve_plain(s[:j].rstrip()), s[j + 1:].strip()
        j += 1
    return None


def _is_item(s: str) -> bool:
    return s == "-" or s.startswith("- ")


class _Parser:
    def __init__(self, lines):
        self.lines, self.i = lines, 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int):
        line = self.peek()
        if _is_item(line.text):
            return self.sequence(indent)
        if _split_key(line.text) is not None:
            return self.mapping(indent)
        self.i += 1
        nxt = self.peek()
        if nxt is not None and nxt.indent >= indent:
            raise YamlError(f"line {nxt.no}: multi-line plain scalars are not supported")
        return _inline(line.text)

    def _child(self, indent: int):
        """The value of a key or item whose line ends after its indicator:
        the block indented below it, or None."""
        nxt = self.peek()
        return self.node(nxt.indent) if nxt is not None and nxt.indent > indent else None

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self.peek()) is not None and line.indent == indent:
            kv = _split_key(line.text)
            if kv is None:
                raise YamlError(f"line {line.no}: expected a mapping key, got {line.text!r}")
            key, rest = kv
            self.i += 1
            if rest and not rest.startswith("#"):
                out[key] = _inline(rest)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YamlError(f"line {nxt.no}: multi-line plain scalars are not supported")
                continue
            nxt = self.peek()
            if nxt is not None and nxt.indent == indent and _is_item(nxt.text):
                out[key] = self.sequence(indent)  # a list at its key's indentation
            else:
                out[key] = self._child(indent)
        line = self.peek()
        if line is not None and line.indent > indent:
            raise YamlError(f"line {line.no}: bad indentation")
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self.peek()) is not None and line.indent == indent and _is_item(line.text):
            rest = line.text[1:].strip()
            self.i += 1
            if rest and not rest.startswith("#"):
                if _is_item(rest) or _split_key(rest) is not None:
                    raise YamlError(f"line {line.no}: nested collections in a list item "
                                    "are not supported")
                out.append(_inline(rest))
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YamlError(f"line {nxt.no}: multi-line plain scalars are not supported")
            else:
                out.append(self._child(indent))
        return out


def safe_load(text: str):
    """The document in ``text`` -> dict / list / scalar, as ``yaml.safe_load``
    gives it for the supported subset."""
    lines = _lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    out = p.node(lines[0].indent)
    if p.peek() is not None:
        raise YamlError(f"line {p.peek().no}: bad indentation")
    return out


def load_file(path: str):
    with open(path, "r") as f:
        return safe_load(f.read())
