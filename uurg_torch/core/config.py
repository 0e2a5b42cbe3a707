"""Config system: YAML -> nested attribute namespace.

Port of ``uurg_tpu/core/config.py`` (same ``Config`` semantics, so the
reference YAML schemas such as ``configs/cifar10_sfron.yml`` load unchanged).
The port reads YAML with its own reader (:func:`load_yaml`), on every
device, so that it needs no PyYAML: the part of YAML the configs and the run
directories' ``logs/config.yaml`` use, resolved exactly as PyYAML's
``safe_load`` resolves it (the JAX package reads the same files with PyYAML).
Anything outside that part raises ``ValueError`` naming the file and line.
"""
from __future__ import annotations

import copy
import math
import re
from typing import Any, Mapping, NamedTuple


class Config:
    """Nested attribute/dict-style config namespace.

    Supports ``cfg.model.ch`` and ``cfg["model"]["ch"]``, ``.get()`` with a
    default, and round-trips to plain dicts.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        # guard against recursion during deepcopy/pickle before _data exists
        if name.startswith("__") or name == "_data":
            raise AttributeError(name)
        try:
            data = object.__getattribute__(self, "_data")
        except AttributeError:
            raise AttributeError(name) from None
        try:
            return data[name]
        except KeyError:
            raise AttributeError(f"Config has no field {name!r}; "
                                 f"known: {sorted(data)}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self._data.items()}

    def replace(self, **updates) -> "Config":
        new = copy.deepcopy(self)
        for k, v in updates.items():
            new[k] = v
        return new

    def merged(self, other: "Config | Mapping") -> "Config":
        """Deep-merge ``other`` over self, returning a new Config."""
        base = self.to_dict()
        upd = other.to_dict() if isinstance(other, Config) else dict(other)
        return Config(_deep_merge(base, upd))

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        return NotImplemented


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _deep_merge(base: dict, upd: dict) -> dict:
    out = dict(base)
    for k, v in upd.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a YAML config file (reference schema compatible)."""
    cfg = Config(load_yaml(path))
    if overrides:
        cfg = cfg.merged(Config(dict(overrides)))
    return cfg


# -- YAML --------------------------------------------------------------------
#
# PyYAML's implicit resolvers for plain scalars (yaml/resolver.py, YAML 1.1),
# in its order: (tag, regex, the first characters it is tried for; "" is the
# empty scalar). The first that matches decides the type, so "1e-05" (no
# dot) stays a string and yes/no/on/off are booleans.
_RESOLVERS = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X), tuple("yYnNtTfFoO")),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X), tuple("-+0123456789.")),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X),
     tuple("-+0123456789")),
    ("merge", re.compile(r"^(?:<<)$"), ("<",)),
    ("null", re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X), ("~", "n", "N", "")),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X),
     tuple("0123456789")),
    ("value", re.compile(r"^(?:=)$"), ("=",)),
)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
# the escapes of a double-quoted scalar (YAML 1.1, as PyYAML reads them)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that may not start a plain scalar (PyYAML's scanner), and the
# node properties and block scalars this reader refuses, by name
_INDICATORS = set(",[]{}#&*!|>'\"%@`")
_REFUSED = {"&": "anchors", "*": "aliases", "!": "tags",
            "|": "block scalars", ">": "block scalars", "%": "directives",
            "@": "reserved indicators", "`": "reserved indicators"}


def resolve_plain(value: str) -> str:
    """The tag PyYAML's safe_load gives the plain scalar ``value``: "str",
    or one of the implicit resolvers' ("bool", "float", "int", "null",
    "merge", "timestamp", "value")."""
    first = value[:1]
    for tag, regex, firsts in _RESOLVERS:
        if first in firsts and regex.match(value):
            return tag
    return "str"


def _sexagesimal(value: str, kind):
    total, base = kind(0), 1
    for part in reversed(value.split(":")):
        total += kind(part) * base
        base *= 60
    return total


def _construct_int(value: str) -> int:
    # yaml/constructor.py SafeConstructor.construct_yaml_int
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


def _construct_float(value: str) -> float:
    # yaml/constructor.py SafeConstructor.construct_yaml_float
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Line(NamedTuple):
    no: int                 # 1-based line number in the file
    indent: int
    text: str               # the content after the indentation


class _Reader:
    """Block mappings and sequences by indentation, flow sequences and
    mappings on one line, quoted and plain scalars on one line, comments."""

    def __init__(self, text: str, path: str):
        self.path = path
        self.lines = []
        for no, raw in enumerate(text.lstrip("\ufeff").split("\n"), 1):
            raw = raw.rstrip("\r")
            body = raw.lstrip(" ")
            if not body.strip() or body.startswith("#"):
                continue
            if body[0] == "\t":
                self.fail(no, "a tab in the indentation")
            if body.rstrip() in ("---", "...") or body.startswith("--- "):
                self.fail(no, "document markers (one document a file, "
                              "without markers)")
            self.lines.append(_Line(no, len(raw) - len(body), body.rstrip()))

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.path}:{no}: {what} (the port's YAML reader "
                         f"takes block mappings and sequences, one-line flow "
                         f"collections and one-line scalars)")

    def read(self):
        if not self.lines:
            return None
        value, pos = self.block(0, self.lines[0].indent, -1)
        if pos < len(self.lines):
            self.fail(self.lines[pos].no, "a line indented less than the "
                                          "document's first")
        return value

    # -- blocks ---------------------------------------------------------

    @staticmethod
    def is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def block(self, pos: int, indent: int, parent: int):
        line = self.lines[pos]
        if self.is_item(line.text):
            return self.sequence(pos, indent)
        scan = _Scan(line.text, self, line.no)
        if scan.key() is None:
            # a lone scalar or flow collection: the whole document
            value = scan.node_to_end()
            if parent >= 0 or pos + 1 < len(self.lines):
                self.fail(line.no, "a value where a key or an item is "
                                   "expected")
            return value, pos + 1
        return self.mapping(pos, indent)

    def nested(self, pos: int, indent: int, allow_items: bool):
        """The value of a key or item whose line ended after its indicator:
        a more indented block, an indentless sequence (a key's), or null."""
        if pos < len(self.lines):
            nxt = self.lines[pos]
            if nxt.indent > indent:
                return self.block(pos, nxt.indent, indent)
            if allow_items and nxt.indent == indent and self.is_item(nxt.text):
                return self.sequence(pos, indent)
        return None, pos

    def check_end_of_node(self, pos: int, indent: int) -> None:
        if pos < len(self.lines) and self.lines[pos].indent > indent:
            self.fail(self.lines[pos].no, "a more indented line after a "
                                          "scalar (multi-line scalars are "
                                          "not taken)")

    def mapping(self, pos: int, indent: int):
        out = {}
        while pos < len(self.lines):
            line = self.lines[pos]
            if line.indent < indent:
                break
            if line.indent > indent:
                self.fail(line.no, "unexpected indentation")
            if self.is_item(line.text):
                self.fail(line.no, "a sequence item where a key is expected")
            scan = _Scan(line.text, self, line.no)
            key = scan.key()
            if key is None:
                self.fail(line.no, "a line without a key in a mapping")
            key = key[0]
            if key in out:
                self.fail(line.no, f"duplicate key {key!r}")
            if scan.at_end():
                value, pos = self.nested(pos + 1, indent, True)
            else:
                value = scan.node_to_end()
                pos += 1
                self.check_end_of_node(pos, indent)
            out[key] = value
        return out, pos

    def sequence(self, pos: int, indent: int):
        out = []
        while pos < len(self.lines):
            line = self.lines[pos]
            if line.indent != indent or not self.is_item(line.text):
                if line.indent > indent:
                    self.fail(line.no, "unexpected indentation")
                break
            rest = line.text[1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                value, pos = self.nested(pos + 1, indent, False)
            elif self.is_item(body) or _Scan(body, self, line.no).key():
                # a compact nested sequence or mapping: its lines start at
                # the column of the item's content
                column = indent + 1 + len(rest) - len(body)
                self.lines[pos] = _Line(line.no, column, body)
                value, pos = self.block(pos, column, indent)
            else:
                value = _Scan(body, self, line.no).node_to_end()
                pos += 1
                self.check_end_of_node(pos, indent)
            out.append(value)
        return out, pos


class _Scan:
    """One line's content from position ``i``: keys, scalars, flow
    collections."""

    def __init__(self, s: str, reader: _Reader, no: int):
        self.s, self.i, self.reader, self.no = s, 0, reader, no

    def fail(self, what: str):
        self.reader.fail(self.no, what)

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def at_end(self) -> bool:
        """Only spaces and a comment are left."""
        self.ws()
        if self.i == len(self.s):
            return True
        return self.s[self.i] == "#" and (self.i == 0 or
                                          self.s[self.i - 1] in " \t")

    def key(self):
        """(key,) if the line is ``key: ...`` (position after the colon),
        else None (position unchanged)."""
        start = self.i
        c = self.s[self.i:self.i + 1]
        if c in ("'", '"'):
            key = self.quoted()
            self.ws()
            if self.s[self.i:self.i + 1] == ":" and (
                    self.i + 1 == len(self.s) or self.s[self.i + 1] in " \t"):
                self.i += 1
                return (key,)
            self.i = start
            return None
        if c == "?" and self.s[1:2] in ("", " "):
            self.fail("complex keys ('?')")
        if c in ("[", "{"):
            return None
        self.check_plain_start()
        end = self.plain_end(flow=False)
        if end < len(self.s) and self.s[end] == ":":
            raw = self.s[self.i:end].rstrip()
            if not raw:
                self.fail("an empty key")
            self.i = end + 1
            key = self.plain(raw)
            try:
                hash(key)
            except TypeError:
                self.fail("a key that is not a scalar")
            return (key,)
        return None

    def node_to_end(self):
        """A whole node up to the end of the line (or its comment)."""
        value = self.node(flow=False)
        if not self.at_end():
            if self.s[self.i] == ":":
                self.fail("a mapping value where a scalar is expected")
            self.fail(f"unexpected {self.s[self.i:]!r} after a value")
        return value

    def node(self, flow: bool):
        self.ws()
        if self.i >= len(self.s):
            if flow:
                self.fail("a flow collection that does not close on its "
                          "line")
            return None
        c = self.s[self.i]
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        if c in ("'", '"'):
            return self.quoted()
        self.check_plain_start()
        end = self.plain_end(flow)
        raw = self.s[self.i:end].rstrip()
        self.i = end
        return self.plain(raw)

    def check_plain_start(self) -> None:
        c = self.s[self.i]
        if c in _REFUSED:
            self.fail(f"{_REFUSED[c]} ({c!r})")
        if c in _INDICATORS or (c in "-?:" and self.s[self.i + 1:self.i + 2]
                                in ("", " ", "\t")):
            self.fail(f"a plain scalar may not start with {c!r}")

    def plain_end(self, flow: bool) -> int:
        """Where the plain scalar from ``i`` ends: before ': ' (or ':' at
        the end, or before a flow indicator in a flow collection), ' #',
        and in a flow collection before ',', '[', ']', '{', '}'."""
        s, j = self.s, self.i
        stops = ",[]{}" if flow else ""
        while j < len(s):
            c = s[j]
            if c == ":" and (j + 1 == len(s) or s[j + 1] in " \t" + stops):
                break
            if c == "#" and j > self.i and s[j - 1] in " \t":
                break
            if c in stops:
                break
            j += 1
        return j

    def plain(self, raw: str):
        tag = resolve_plain(raw)
        if tag == "str":
            return raw
        if tag == "bool":
            return _BOOLS[raw.lower()]
        if tag == "int":
            return _construct_int(raw)
        if tag == "float":
            return _construct_float(raw)
        if tag == "null":
            return None
        self.fail(f"{raw!r} resolves to YAML's {tag} type, which the port's "
                  f"reader does not take")

    def quoted(self) -> str:
        q = self.s[self.i]
        j, out = self.i + 1, []
        while True:
            if j >= len(self.s):
                self.fail("a quoted scalar that does not close on its line")
            c = self.s[j]
            if q == "'":
                if c == "'":
                    if self.s[j + 1:j + 2] == "'":
                        out.append("'")
                        j += 2
                        continue
                    break
                out.append(c)
                j += 1
                continue
            if c == '"':
                break
            if c == "\\":
                e = self.s[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[j + 2:j + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"a bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                    continue
                self.fail(f"an unknown escape \\{e}" if e else
                          "a line break inside a double-quoted scalar")
            out.append(c)
            j += 1
        self.i = j + 1
        return "".join(out)

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            if self.s[self.i:self.i + 1] == ",":
                self.fail("an empty entry in a flow sequence")
            out.append(self.node(flow=True))
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c == ":":
                self.fail("a mapping inside a flow sequence")
            elif c != "]":
                self.fail("a flow sequence that does not close on its line"
                          if not c else f"unexpected {c!r} in a flow sequence")

    def flow_mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node(flow=True)
            try:
                hash(key)
            except TypeError:
                self.fail("a key that is not a scalar")
            if key in out:
                self.fail(f"duplicate key {key!r}")
            self.ws()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self.ws()
                if self.s[self.i:self.i + 1] not in (",", "}"):
                    value = self.node(flow=True)
            out[key] = value
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                self.fail("a flow mapping that does not close on its line"
                          if not c else f"unexpected {c!r} in a flow mapping")


def parse_yaml(text: str, path: str = "<string>"):
    """The value ``yaml.safe_load(text)`` gives, for the YAML this reader
    takes; ``ValueError`` naming ``path`` and the line for anything else."""
    return _Reader(text, path).read()


def load_yaml(path: str):
    """:func:`parse_yaml` of the file at ``path``."""
    with open(path, encoding="utf-8") as f:
        return parse_yaml(f.read(), path)
