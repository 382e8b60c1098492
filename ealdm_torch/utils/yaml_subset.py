"""A reader for the YAML the repo's configs are written in (the card's
machine has no YAML package).

`loads(text)` gives what PyYAML's `yaml.safe_load(text)` gives for:

- block mappings and block sequences (also a sequence at its key's
  indentation, and mappings that start on a sequence's dash line);
- flow sequences and flow mappings, nested, on one line or continued on
  deeper lines;
- plain scalars under YAML 1.1's implicit types, as PyYAML resolves them:
  null (`~`, `null`, empty), bool (`yes`/`no`/`on`/`off`/`true`/`false` in
  three cases), int (decimal, `0b`, `0x`, a leading-0 octal, base 60),
  float (`1.0e-05` and `1.e-6` are floats, `5e-4` is a string: the exponent
  needs a dot in the mantissa and a sign), timestamps (`datetime.date` or
  `datetime.datetime`);
- single- and double-quoted scalars (never resolved), with their escapes;
- `#` comments, a leading `---` and a trailing `...`.

Anchors, aliases, tags, block scalars (`|`, `>`), merge keys (`<<`),
complex keys and several documents raise `YAMLSubsetError`, as does what
PyYAML refuses (a plain scalar with `: ` in it, a tab in the indentation,
a reserved indicator).
"""
from __future__ import annotations

import datetime
import re
from typing import Any, List, Tuple


class YAMLSubsetError(ValueError):
    """The text is not YAML, or uses what this reader does not take."""


# PyYAML's implicit resolvers (`yaml/resolver.py`), each with the first
# characters it is tried for, in PyYAML's order
_RESOLVERS = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X), "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X), "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X),
     "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)
_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


def _int(v: str) -> int:
    v = v.replace("_", "")
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
        out, base = 0, 1
        for part in reversed(v.split(":")):
            out += int(part) * base
            base *= 60
        return sign * out
    return sign * int(v)


def _float(v: str) -> float:
    v = v.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        out, base = 0.0, 1
        for part in reversed(v.split(":")):
            out += float(part) * base
            base *= 60
        return sign * out
    return sign * float(v)


def _timestamp(v: str):
    m = _TIMESTAMP.match(v).groupdict()
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return datetime.date(year, month, day)
    fraction = int((m["fraction"] or "")[:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                             int(m["second"]), fraction, tzinfo=tz)


def resolve_plain(v: str) -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolvers."""
    for kind, regex, first in _RESOLVERS:
        if (v[:1] in first if v else kind == "null") and regex.match(v):
            if kind == "bool":
                return v.lower() in ("yes", "true", "on")
            if kind == "float":
                return _float(v)
            if kind == "int":
                return _int(v)
            if kind == "null":
                return None
            if kind == "timestamp":
                return _timestamp(v)
            raise YAMLSubsetError(f"{v!r}: {kind} keys and values are not taken")
    return v


# ----------------------------------------------------------------- lines
def _strip_comment(line: str, lineno: int) -> str:
    """The line without its comment (a # at the start or after a blank,
    outside quotes) and trailing blanks."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of each line that holds content."""
    out = []
    started = False
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw, n)
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith("\t"):
            raise YAMLSubsetError(f"line {n}: a tab in the indentation")
        if indent == 0 and (body == "---" or body.startswith("--- ")):
            if started or out:
                raise YAMLSubsetError(f"line {n}: more than one document")
            started = True
            body = body[3:].strip()
            if not body:
                continue
        if indent == 0 and body == "...":
            break
        if indent == 0 and body.startswith("%"):
            raise YAMLSubsetError(f"line {n}: directives are not taken")
        out.append((indent, body.rstrip(), n))
    return out


# ---------------------------------------------------------------- scalars
def _double_quoted(s: str, i: int) -> Tuple[str, int]:
    """The double-quoted scalar starting at s[i] == '"': (value, index past it)."""
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise YAMLSubsetError(f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise YAMLSubsetError(f"unknown escape \\{e}")
        else:
            out.append(c)
            i += 1
    raise YAMLSubsetError("unclosed double-quoted scalar")


def _single_quoted(s: str, i: int) -> Tuple[str, int]:
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YAMLSubsetError("unclosed single-quoted scalar")


def _check_plain_start(s: str) -> None:
    c = s[:1]
    if c in ("&", "*", "!"):
        raise YAMLSubsetError(f"{s!r}: anchors, aliases and tags are not taken")
    if c in ("|", ">"):
        raise YAMLSubsetError(f"{s!r}: block scalars are not taken")
    if c in ("@", "`", "%"):
        raise YAMLSubsetError(f"{s!r}: a plain scalar cannot start with {c!r}")
    if c in ("?",) and (len(s) == 1 or s[1] == " "):
        raise YAMLSubsetError(f"{s!r}: complex keys are not taken")


# ------------------------------------------------------------------ flow
def _skip(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t":
        i += 1
    return i


def _flow_plain(s: str, i: int) -> Tuple[str, int]:
    """A plain scalar in a flow collection: up to , [ ] { }, or a ':' that a
    blank or a flow indicator follows."""
    start = i
    while i < len(s):
        c = s[i]
        if c in _FLOW_END:
            break
        if c == ":" and (i + 1 == len(s) or s[i + 1] in " \t" + _FLOW_END):
            break
        if c == "#" and s[i - 1] in " \t":
            break
        i += 1
    return s[start:i].strip(), i


def _flow_node(s: str, i: int) -> Tuple[Any, int]:
    i = _skip(s, i)
    if i >= len(s):
        raise YAMLSubsetError("a flow collection ends early")
    c = s[i]
    if c == "[":
        return _flow_seq(s, i)
    if c == "{":
        return _flow_map(s, i)
    if c == '"':
        return _double_quoted(s, i)
    if c == "'":
        return _single_quoted(s, i)
    v, j = _flow_plain(s, i)
    if not v:
        raise YAMLSubsetError(f"an empty entry in a flow collection: {s!r}")
    _check_plain_start(v)
    return resolve_plain(v), j


def _flow_key(s: str, i: int) -> Tuple[Any, bool, int]:
    """(key, whether it was quoted, index past it)."""
    i = _skip(s, i)
    if s[i:i + 1] in ("[", "{"):
        raise YAMLSubsetError("complex keys are not taken")
    if s[i:i + 1] in ('"', "'"):
        k, j = (_double_quoted if s[i] == '"' else _single_quoted)(s, i)
        return k, True, j
    v, j = _flow_plain(s, i)
    _check_plain_start(v)
    return v, False, j


def _flow_seq(s: str, i: int) -> Tuple[list, int]:
    out: list = []
    i = _skip(s, i + 1)
    while True:
        if s[i:i + 1] == "]":
            return out, i + 1
        # an entry `k: v` is a one-pair mapping
        j = i
        if s[j:j + 1] not in ("[", "{"):
            key, quoted, j = _flow_key(s, i)
            j = _skip(s, j)
            if s[j:j + 1] == ":":
                val, j = _flow_value_after_colon(s, j + 1)
                out.append({key if quoted else resolve_plain(key): val})
                i = j
            else:
                val, i = _flow_node(s, i)
                out.append(val)
        else:
            val, i = _flow_node(s, i)
            out.append(val)
        i = _skip(s, i)
        if s[i:i + 1] == ",":
            i = _skip(s, i + 1)
        elif s[i:i + 1] != "]":
            raise YAMLSubsetError(f"expected ',' or ']' in {s!r}")


def _flow_value_after_colon(s: str, i: int) -> Tuple[Any, int]:
    i = _skip(s, i)
    if i >= len(s) or s[i] in ",]}":
        return None, i
    return _flow_node(s, i)


def _flow_map(s: str, i: int) -> Tuple[dict, int]:
    out: dict = {}
    i = _skip(s, i + 1)
    while True:
        if s[i:i + 1] == "}":
            return out, i + 1
        key, quoted, i = _flow_key(s, i)
        key = key if quoted else resolve_plain(key)
        i = _skip(s, i)
        if s[i:i + 1] == ":":
            val, i = _flow_value_after_colon(s, i + 1)
        else:
            val = None
        if key == "<<" and not quoted:
            raise YAMLSubsetError("merge keys are not taken")
        out[key] = val
        i = _skip(s, i)
        if s[i:i + 1] == ",":
            i = _skip(s, i + 1)
        elif s[i:i + 1] != "}":
            raise YAMLSubsetError(f"expected ',' or '}}' in {s!r}")


def _inline(s: str) -> Any:
    """The value written after `key:` or `- ` (continuation lines joined)."""
    if s[0] in "[{\"'":
        val, i = _flow_node(s, 0)
        if _skip(s, i) != len(s):
            raise YAMLSubsetError(f"text after a value: {s!r}")
        return val
    _check_plain_start(s)
    if ": " in s or s.endswith(":"):
        raise YAMLSubsetError(f"mapping values are not allowed here: {s!r}")
    if s[0] in "]}":
        raise YAMLSubsetError(f"unexpected {s[0]!r}: {s!r}")
    return resolve_plain(s)


# ----------------------------------------------------------------- block
def _split_key(body: str):
    """(key, quoted, rest) of a block mapping entry `key: rest`, or None."""
    if body[:1] in ('"', "'"):
        try:
            key, i = (_double_quoted if body[0] == '"' else _single_quoted)(body, 0)
        except YAMLSubsetError:
            return None
        i = _skip(body, i)
        if body[i:i + 1] == ":" and (i + 1 == len(body) or body[i + 1] in " \t"):
            return key, True, body[i + 1:].strip()
        return None
    if body[:1] in ("[", "{", "-") and (body[:1] != "-" or body[1:2] in ("", " ")):
        return None
    depth = 0
    for i, c in enumerate(body):
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth <= 0 and (i + 1 == len(body) or body[i + 1] in " \t"):
            key = body[:i].rstrip()
            _check_plain_start(key)
            return key, False, body[i + 1:].strip()
    return None


def _is_seq(body: str) -> bool:
    return body == "-" or body.startswith("- ")


class _Parser:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def node(self, indent: int) -> Any:
        ind, body, n = self.lines[self.i]
        if ind != indent:
            raise YAMLSubsetError(f"line {n}: bad indentation")
        if _is_seq(body):
            return self.seq(indent)
        if _split_key(body) is not None:
            return self.mapping(indent)
        return _inline(self.continued(indent - 1))

    def continued(self, indent: int) -> str:
        """The current line's content joined with the deeper lines after it
        (a plain or flow value continued on later lines)."""
        parts = [self.lines[self.i][1]]
        self.i += 1
        while self.i < len(self.lines) and self.lines[self.i][0] > indent:
            parts.append(self.lines[self.i][1])
            self.i += 1
        return " ".join(parts)

    def value(self, indent: int, rest: str, seq_ok: bool) -> Any:
        """The value of an entry at `indent` whose own line holds `rest`."""
        if rest:
            # the entry's text, continued on deeper lines
            self.lines[self.i] = (indent, rest, self.lines[self.i][2])
            return _inline(self.continued(indent))
        self.i += 1
        if self.i < len(self.lines):
            ind, body, _ = self.lines[self.i]
            if ind > indent:
                return self.node(ind)
            if seq_ok and ind == indent and _is_seq(body):
                return self.seq(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, body, n = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {n}: bad indentation")
            split = _split_key(body)
            if split is None:
                raise YAMLSubsetError(f"line {n}: expected `key: value`, not {body!r}")
            key, quoted, rest = split
            if not quoted and key == "<<":
                raise YAMLSubsetError(f"line {n}: merge keys are not taken")
            out[key if quoted else resolve_plain(key)] = self.value(indent, rest, True)
        return out

    def seq(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, body, n = self.lines[self.i]
            if ind < indent or (ind == indent and not _is_seq(body)):
                break
            if ind > indent:
                raise YAMLSubsetError(f"line {n}: bad indentation")
            rest = body[1:].lstrip(" ")
            if not rest:
                out.append(self.value(indent, "", False))
                continue
            # the item starts on the dash's line: parse it as a node there
            col = indent + len(body) - len(rest)
            self.lines[self.i] = (col, rest, n)
            if _is_seq(rest) or _split_key(rest) is not None:
                out.append(self.node(col))
            else:
                out.append(_inline(self.continued(indent)))
        return out


def loads(text: str) -> Any:
    """The value of a YAML document, as `yaml.safe_load` gives it."""
    lines = _lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    out = p.node(lines[0][0])
    if p.i != len(lines):
        raise YAMLSubsetError(f"line {lines[p.i][2]}: text after the document's end")
    return out


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
