"""A YAML subset reader and writer, so the port needs no PyYAML.

The subset is what the config tree, the CLI overrides and a run's
``.hydra/config.yaml`` use:

- block mappings and block sequences (indented, or indentless under a key,
  as ``yaml.safe_dump`` writes them), and a compact mapping inside a
  sequence item (``- key: value``);
- flow sequences and flow mappings (``[a, b]``, ``{k: v}``), nested or of
  scalars, which may span lines;
- plain, single-quoted and double-quoted scalars, multi-line ones folded as
  YAML folds them, and ``#`` comments;
- YAML 1.1 scalar resolution as PyYAML's ``SafeLoader`` does it (null,
  bool, int in all its bases, float). With ``omegaconf_floats=True``,
  scientific notation without a dot (``2e-4``) is a float too, as the
  config engine's loader makes it (OmegaConf's rule).

Everything else (anchors, aliases, tags, block scalars ``|``/``>``,
complex keys, directives, timestamps, merge keys) raises
:class:`YAMLSubsetError` instead of being guessed at.

:func:`dump` writes block style that this reader and ``yaml.safe_load``
both read back equal: floats always carry a dot or an exponent sign as
PyYAML writes them, and any string that would resolve to another type is
quoted.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "dump", "flow", "load", "resolve_plain"]


class YAMLSubsetError(ValueError):
    """Input outside the supported YAML subset (or malformed)."""


# ---------------------------------------------------------------------------
# scalar resolution (PyYAML's resolver.py regexes, YAML 1.1)
# ---------------------------------------------------------------------------

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
# the config engine's extra float rule (OmegaConf's): a dot is optional
_FLOAT_OMEGACONF = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)


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
        value = 0
        for part in v.split(":"):
            value = value * 60 + int(part)
        return sign * value
    return sign * int(v)


def _to_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        value = 0.0
        for part in v.split(":"):
            value = value * 60 + float(part)
        return sign * value
    return sign * float(v)


def resolve_plain(text: str, omegaconf_floats: bool = False) -> Any:
    """The value of a plain (unquoted) scalar, resolved as PyYAML's
    ``SafeLoader`` does (with the config engine's float rule when asked)."""
    first = text[:1]
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if first in "-+0123456789." and _FLOAT.match(text):
        return _to_float(text)
    if first in "-+0123456789" and _INT.match(text):
        return _to_int(text)
    if text == "<<" or text == "=":
        raise YAMLSubsetError(f"merge and value keys are outside the YAML subset: {text!r}")
    if _NULL.match(text):
        return None
    if first in "0123456789" and _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamps are outside the YAML subset: {text!r}")
    if omegaconf_floats and first in "-+0123456789." and _FLOAT_OMEGACONF.match(text):
        return _to_float(text)
    return text


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": " ", "P": " ",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _fold(lines: List[str], escaped_breaks: bool = False) -> str:
    """YAML line folding of a multi-line scalar's raw lines: whitespace at
    each break is dropped, a single break becomes a space and each empty
    line a newline; the last line (the closing quote's) keeps its trailing
    whitespace. With ``escaped_breaks`` (double quotes) a break after an
    odd run of backslashes joins the lines with nothing between."""
    out = lines[0]
    pending = 0
    last = len(lines) - 1
    for n, line in enumerate(lines[1:], 1):
        stripped = line.lstrip(" \t") if n == last else line.strip(" \t")
        if escaped_breaks and not pending and (len(out) - len(out.rstrip("\\"))) % 2 == 1:
            out = out[:-1] + stripped
            continue
        if not stripped and n != last:
            pending += 1
            continue
        out = out.rstrip(" \t") + ("\n" * pending if pending else " ") + stripped
        pending = 0
    return out


class _Reader:
    def __init__(self, text: str, omegaconf_floats: bool):
        if "\t" in text and re.search(r"^[ ]*\t", text, re.M):
            raise YAMLSubsetError("tabs in indentation are not YAML")
        self.lines = text.split("\n")
        self.floats = omegaconf_floats
        self.i = 0

    # -- line helpers -------------------------------------------------------

    @staticmethod
    def _indent(line: str) -> int:
        return len(line) - len(line.lstrip(" "))

    def _skip_blank(self) -> None:
        while self.i < len(self.lines):
            s = self.lines[self.i].strip()
            if s and not s.startswith("#"):
                return
            self.i += 1

    def _peek(self) -> Optional[Tuple[int, str]]:
        self._skip_blank()
        if self.i >= len(self.lines):
            return None
        line = self.lines[self.i]
        return self._indent(line), line.strip()

    def _error(self, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"line {self.i + 1}: {msg}")

    # -- documents ----------------------------------------------------------

    def document(self) -> Any:
        head = self._peek()
        if head is None:
            return None
        if head[1].startswith("%"):
            raise self._error("directives are outside the YAML subset")
        if head[1] == "---":
            self.i += 1
            head = self._peek()
            if head is None:
                return None
        value = self.block(head[0])
        tail = self._peek()
        if tail is not None and tail[1] not in ("...",):
            raise self._error(f"unexpected content {tail[1]!r}")
        return value

    # -- block nodes --------------------------------------------------------

    def _is_seq_item(self, content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def block(self, indent: int) -> Any:
        """The block node whose first line (the next non-blank one) starts
        at column ``indent``."""
        head = self._peek()
        col, content = head
        if self._is_seq_item(content):
            return self.sequence(col)
        if self._key_split(content) is not None:
            return self.mapping(col)
        start = self.i
        value = self.inline(self.lines[self.i][col:], col - 1)
        if start == self.i:
            self.i += 1
        return value

    def sequence(self, indent: int) -> List[Any]:
        out = []
        while True:
            head = self._peek()
            if head is None or head[0] != indent or not self._is_seq_item(head[1]):
                return out
            line = self.lines[self.i]
            rest = line[indent + 1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                self.i += 1
                nxt = self._peek()
                if nxt is not None and nxt[0] > indent:
                    out.append(self.block(nxt[0]))
                else:
                    out.append(None)
                continue
            # blank the dash: the item is the node that starts at its content
            col = len(line) - len(body)
            self.lines[self.i] = " " * col + body
            out.append(self.block(col))

    def _key_split(self, content: str) -> Optional[Tuple[Any, str]]:
        """``(key, rest)`` when ``content`` is a ``key: rest`` line."""
        if content.startswith("? "):
            raise self._error("complex keys are outside the YAML subset")
        if content[:1] in ("'", '"'):
            end = self._quoted_end(content, 0)
            if end is None:
                return None
            after = content[end:]
            if after.startswith(":") and (len(after) == 1 or after[1] in " \t"):
                return self._quoted_value(content[:end]), after[1:].lstrip(" ")
            return None
        if content[:1] in "[{&*!|>%@`":
            return None
        m = re.search(r":(?:[ \t]|$)", content)
        if m is None:
            return None
        key = content[: m.start()].rstrip()
        if " #" in key or "\t#" in key:
            return None
        return resolve_plain(key, self.floats), content[m.end():].lstrip(" ")

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            head = self._peek()
            if head is None or head[0] != indent:
                return out
            split = self._key_split(head[1])
            if split is None:
                raise self._error(f"expected a 'key: value' line, got {head[1]!r}")
            key, rest = split
            if isinstance(key, (dict, list)):
                raise self._error("collection keys are outside the YAML subset")
            if not rest or rest.startswith("#"):
                self.i += 1
                nxt = self._peek()
                if nxt is not None and nxt[0] > indent:
                    out[key] = self.block(nxt[0])
                elif nxt is not None and nxt[0] == indent and self._is_seq_item(nxt[1]):
                    out[key] = self.sequence(indent)  # indentless sequence
                else:
                    out[key] = None
                continue
            line = self.lines[self.i]
            start = self.i
            out[key] = self.inline(line[len(line) - len(rest):], indent)
            if self.i == start:
                self.i += 1

    # -- inline values (the rest of a line, possibly continued) -------------

    def inline(self, text: str, parent_indent: int) -> Any:
        """The value starting at ``text`` (the tail of line ``self.i``);
        leaves ``self.i`` on the last line it consumed, or past it."""
        c = text[:1]
        if c in "&*!":
            raise self._error("anchors, aliases and tags are outside the YAML subset")
        if c in "|>":
            raise self._error("block scalars are outside the YAML subset")
        if c in "@`%":
            raise self._error(f"a plain scalar cannot start with {c!r}")
        if c in "[{":
            raw = self._gather_flow(text)
            value, pos = self._flow(raw, 0)
            tail = raw[pos:].strip()
            if tail and not tail.startswith("#"):
                raise self._error(f"unexpected {tail!r} after a flow collection")
            return value
        if c in "'\"":
            raw = self._gather_quoted(text)
            end = self._quoted_end(raw, 0)
            tail = raw[end:].strip()
            if tail and not tail.startswith("#"):
                raise self._error(f"unexpected {tail!r} after a quoted scalar")
            return self._quoted_value(raw[:end])
        # plain scalar: this line's text up to a comment, then continuation
        # lines indented deeper than the parent
        parts = [self._strip_comment(text)]
        self.i += 1
        while self.i < len(self.lines):
            line = self.lines[self.i]
            s = line.strip()
            if s.startswith("#") or line in ("...", "---"):
                break
            if s and self._indent(line) <= parent_indent:
                break
            if s and (self._key_split(s) is not None or self._is_seq_item(s)):
                raise self._error("a mapping or sequence cannot continue a plain scalar")
            parts.append(self._strip_comment(line))
            self.i += 1
        while len(parts) > 1 and not parts[-1].strip():
            parts.pop()
            self.i -= 1
        value = _fold(parts) if len(parts) > 1 else parts[0].strip()
        return resolve_plain(value.strip(), self.floats)

    @staticmethod
    def _strip_comment(text: str) -> str:
        m = re.search(r"(^|[ \t])#", text)
        return (text[: m.start()] if m else text).rstrip()

    def _gather_quoted(self, text: str) -> str:
        raw = text
        while self._quoted_end(raw, 0) is None:
            self.i += 1
            if self.i >= len(self.lines):
                raise self._error("unterminated quoted scalar")
            raw += "\n" + self.lines[self.i]
        self.i += 1
        return raw

    def _gather_flow(self, text: str) -> str:
        raw = text
        while not self._flow_closed(raw):
            self.i += 1
            if self.i >= len(self.lines):
                raise self._error("unterminated flow collection")
            raw += "\n" + self._strip_comment(self.lines[self.i])
        self.i += 1
        return raw

    @staticmethod
    def _flow_closed(raw: str) -> bool:
        depth, i = 0, 0
        while i < len(raw):
            ch = raw[i]
            if ch in "'\"":
                end = _Reader._quoted_end(raw, i)
                if end is None:
                    return False
                i = end
                continue
            if ch == "#" and (i == 0 or raw[i - 1] in " \t\n"):
                nl = raw.find("\n", i)
                if nl < 0:
                    return depth == 0
                i = nl
                continue
            if ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
                if depth == 0:
                    return True
            i += 1
        return False

    @staticmethod
    def _quoted_end(raw: str, start: int) -> Optional[int]:
        """Index just past the closing quote of the scalar opening at
        ``start``, or None when it does not close in ``raw``."""
        q = raw[start]
        i = start + 1
        while i < len(raw):
            ch = raw[i]
            if q == "'" and ch == "'":
                if raw[i + 1: i + 2] == "'":
                    i += 2
                    continue
                return i + 1
            if q == '"':
                if ch == "\\":
                    i += 2
                    continue
                if ch == '"':
                    return i + 1
            i += 1
        return None

    def _quoted_value(self, raw: str) -> str:
        q, body = raw[0], raw[1:-1]
        if q == "'":
            lines = body.split("\n")
            return _fold(lines).replace("''", "'") if len(lines) > 1 else body.replace("''", "'")
        # double-quoted: fold breaks (an escaped break joins without a space), then escapes
        lines = body.split("\n")
        text = _fold(lines, escaped_breaks=True) if len(lines) > 1 else body
        out, i = [], 0
        while i < len(text):
            ch = text[i]
            if ch != "\\":
                out.append(ch)
                i += 1
                continue
            e = text[i + 1: i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                out.append(chr(int(text[i + 2: i + 2 + n], 16)))
                i += 2 + n
            else:
                raise self._error(f"unknown escape \\{e}")
        return "".join(out)

    # -- flow collections ---------------------------------------------------

    def _flow(self, raw: str, pos: int) -> Tuple[Any, int]:
        pos = self._flow_ws(raw, pos)
        ch = raw[pos]
        if ch == "[":
            items, pos = [], pos + 1
            while True:
                pos = self._flow_ws(raw, pos)
                if raw[pos] == "]":
                    return items, pos + 1
                value, pos = self._flow(raw, pos)
                items.append(value)
                pos = self._flow_ws(raw, pos)
                if raw[pos] == ",":
                    pos += 1
                elif raw[pos] != "]":
                    raise self._error(f"expected ',' or ']' in a flow sequence, got {raw[pos]!r}")
        if ch == "{":
            out, pos = {}, pos + 1
            while True:
                pos = self._flow_ws(raw, pos)
                if raw[pos] == "}":
                    return out, pos + 1
                key, pos = self._flow(raw, pos)
                pos = self._flow_ws(raw, pos)
                if raw[pos] != ":":
                    raise self._error("expected ':' in a flow mapping")
                value, pos = self._flow(raw, pos + 1)
                out[key] = value
                pos = self._flow_ws(raw, pos)
                if raw[pos] == ",":
                    pos += 1
                elif raw[pos] != "}":
                    raise self._error(f"expected ',' or '}}' in a flow mapping, got {raw[pos]!r}")
        if ch in "'\"":
            end = self._quoted_end(raw, pos)
            return self._quoted_value(raw[pos:end]), end
        if ch in "&*!|>@`%":
            raise self._error(f"{ch!r} is outside the YAML subset")
        m = re.compile(r"(?:[^,\[\]{}:#\n]|:(?![ \t\n,\[\]{}])|(?<! )#)+").match(raw, pos)
        if m is None:
            return None, pos  # an empty node (e.g. `{a: }`)
        return resolve_plain(m.group(0).strip(), self.floats), m.end()

    @staticmethod
    def _flow_ws(raw: str, pos: int) -> int:
        while pos < len(raw):
            if raw[pos] in " \t\n":
                pos += 1
            elif raw[pos] == "#" and (pos == 0 or raw[pos - 1] in " \t\n"):
                nl = raw.find("\n", pos)
                pos = len(raw) if nl < 0 else nl
            else:
                break
        if pos >= len(raw):
            raise YAMLSubsetError("unterminated flow collection")
        return pos


def load(text: str, omegaconf_floats: bool = False) -> Any:
    """Parse one YAML document of the subset into dicts, lists and scalars
    (``yaml.safe_load``'s result for the same text)."""
    return _Reader(text.replace("\r\n", "\n"), omegaconf_floats).document()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./$()+^][^\x00-\x1f\x7f:#]*$")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        plain = (
            _PLAIN_SAFE.match(value) is not None
            and value == value.strip()
            and "{" not in value[:1]
            and " #" not in value
            and not value.endswith(":")
        )
        if plain:
            try:
                plain = resolve_plain(value, omegaconf_floats=True) == value and resolve_plain(value) == value
            except YAMLSubsetError:
                plain = False
        return value if plain else json.dumps(value, ensure_ascii=False)
    raise YAMLSubsetError(f"cannot write a {type(value).__name__} as YAML")


def _dump(node: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            key = _scalar(k)
            if isinstance(v, (dict, list, tuple)) and len(v):
                out.append(f"{pad}{key}:")
                _dump(v, indent + 2, out)
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list, tuple)) and len(v):
                sub: List[str] = []
                _dump(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip(' ')}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(v)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dump(data: Any) -> str:
    """Block-style YAML for nested dicts/lists of scalars, readable back to
    equal data by :func:`load` and by ``yaml.safe_load``."""
    if isinstance(data, (dict, list, tuple)) and len(data):
        out: List[str] = []
        _dump(data, 0, out)
        return "\n".join(out) + "\n"
    return _inline(data) + "\n"


def flow(value: Any) -> str:
    """One-line flow YAML of ``value`` (a CLI override's right-hand side)."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {flow(v)}" for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(flow(v) for v in value) + "]"
    return _scalar(value)
