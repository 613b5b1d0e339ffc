"""ParseHeader-compatible ``key = value`` config parser (pure Python).

Accepts the same grammar as the reference's flex/bison ParseHeader
subproject (``subprojects/ParseHeader/src/phScanner.ll``, ``phParser.yy``):

* ``#`` comments to end of line; ``##`` on its own at line start toggles a
  multi-line comment block
* backslash line continuation
* statements ``name = value [value ...]`` (one per line)
* values: integers, C/Fortran floats (``1e21``, ``1D+3``, ``1.5+3``),
  ``true``/``false``, single- or double-quoted strings, bare identifiers
* ``include "file"`` directive (nested)
* the header may prefix a binary file and is terminated by ``\\x02\\n``
  (so parameters can live at the top of output data files)

Typed assignment follows the reference's symbol-table semantics
(``phDriver.cc:207-379``): registered variables carry a type and a
MUST_DEFINE/DONT_CARE flag; integer literals coerce to float targets but not
vice versa; ``checkinit`` errors on undefined MUST_DEFINE keys.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

MUST_DEFINE = True
DONT_CARE = False

HEADER_TERMINATOR = b"\x02\n"


class ParseError(ValueError):
    pass


class PHType(Enum):
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    STRING = "string"
    INT_VECTOR = "int_vector"
    DOUBLE_VECTOR = "double_vector"


# Token regexes, mirroring the lexer's float/int/id/string definitions.
_QUOTED = r"\"[^\n\"]*\"|'[^\n']*'"
_MANT1 = r"(?:[0-9]+\.[0-9]*|[0-9]*\.[0-9]+)"
_EXP1 = r"(?:(?:[DdEe]?[+-]|[DdEe][+-]?)[0-9]+)"
_EXP2 = r"(?:[DdEe][+-]?[0-9]+)"
_FLOAT = rf"[+-]?{_MANT1}{_EXP1}?|[+-]?[0-9]+{_EXP2}"
_INT = r"[+-]?[0-9]+"
_ID = r"[a-zA-Z_.$][a-zA-Z_.$0-9]*"

_TOKEN_RE = re.compile(
    rf"(?P<ws>[ \t]+)"
    rf"|(?P<string>{_QUOTED})"
    rf"|(?P<float>{_FLOAT})"
    rf"|(?P<int>{_INT})"
    rf"|(?P<id>{_ID})"
    rf"|(?P<eq>=)"
    rf"|(?P<comma>,)"
)


@dataclass
class _Entry:
    name: str
    type: PHType
    must_define: bool
    defined: bool = False
    value: object = None


def _parse_float(text: str) -> float:
    """Parse incl. Fortran ``D`` exponents and bare ``1.5+3`` style."""
    t = text.replace("D", "e").replace("d", "e")
    try:
        return float(t)
    except ValueError:
        # mantissa directly followed by a signed exponent: 1.5+3 == 1.5e3
        m = re.fullmatch(r"([+-]?(?:[0-9]+\.[0-9]*|[0-9]*\.[0-9]+))([+-][0-9]+)", t)
        if not m:
            raise ParseError(f"bad float literal: {text!r}") from None
        return float(m.group(1) + "e" + m.group(2))


def _tokenize_line(line: str, where: str):
    """Yield (kind, value) tokens for one logical line."""
    pos = 0
    while pos < len(line):
        m = _TOKEN_RE.match(line, pos)
        if not m:
            raise ParseError(f"{where}: cannot tokenize at {line[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws" or kind == "comma":
            continue
        text = m.group()
        if kind == "string":
            yield "string", text[1:-1]
        elif kind == "float":
            yield "number", _parse_float(text)
        elif kind == "int":
            yield "number", int(text)
        elif kind == "id":
            if text == "true":
                yield "number", 1
            elif text == "false":
                yield "number", 0
            else:
                yield "id", text
        else:
            yield kind, text


def _logical_lines(text: str):
    """Split into logical lines: strip comments, join continuations."""
    in_block_comment = False
    pending = ""
    for raw in text.split("\n"):
        stripped = raw.lstrip()
        if stripped.startswith("##"):
            in_block_comment = not in_block_comment
            continue
        if in_block_comment:
            continue
        # remove trailing comment (quotes cannot contain '#' per the lexer's
        # quoted-string rule? they can -- so respect quotes)
        out = []
        quote = None
        for ch in raw:
            if quote:
                out.append(ch)
                if ch == quote:
                    quote = None
            elif ch in "\"'":
                quote = ch
                out.append(ch)
            elif ch == "#":
                break
            else:
                out.append(ch)
        line = "".join(out)
        if re.search(r"\\[ \t]*$", line):
            pending += re.sub(r"\\[ \t]*$", "", line)
            continue
        line = pending + line
        pending = ""
        if line.strip():
            yield line
    if pending.strip():
        yield pending


class ParseHeader:
    """Typed symbol-table config parser matching the reference semantics."""

    def __init__(self):
        self._symbols: dict[str, _Entry] = {}

    # -- registration ------------------------------------------------------
    def install(self, name: str, type: PHType, flag: bool, default=None):
        e = _Entry(name, type, flag, value=default)
        self._symbols[name] = e

    # -- access ------------------------------------------------------------
    def __getitem__(self, name):
        return self._symbols[name].value

    def defined(self, name) -> bool:
        return self._symbols[name].defined

    # -- parsing -----------------------------------------------------------
    def read_header(self, path) -> int:
        """Parse the header of ``path`` (text or binary-with-header file).

        Returns the header length in bytes (offset of first binary byte),
        so callers can continue reading binary data after the header, like
        the reference's HeaderStream.
        """
        data = Path(path).read_bytes()
        idx = data.find(HEADER_TERMINATOR)
        header = data if idx < 0 else data[:idx]
        self.parse_string(header.decode("utf-8", errors="replace"), base=Path(path).parent)
        self.check_must_defines(str(path))
        return len(header) + 2 if idx >= 0 else len(data)

    def parse_string(self, text: str, base: Path | None = None):
        for line in _logical_lines(text):
            self._statement(line, base or Path("."))

    def _statement(self, line: str, base: Path):
        toks = list(_tokenize_line(line, line.strip()[:40]))
        if not toks:
            return
        kind, name = toks[0]
        if kind == "id" and name == "include":
            if len(toks) != 2 or toks[1][0] not in ("string", "id"):
                raise ParseError(f"bad include directive: {line!r}")
            inc = Path(toks[1][1])
            if not inc.is_absolute():
                inc = base / inc
            self.parse_string(inc.read_text(), base=inc.parent)
            return
        if kind != "id" or len(toks) < 3 or toks[1] != ("eq", "="):
            raise ParseError(f"syntax error, expecting 'identifier = value': {line!r}")
        values = [(k, v) for k, v in toks[2:]]
        self._assign(name, values, line)

    def _assign(self, name, values, line):
        ent = self._symbols.get(name)
        if ent is None:
            # Unregistered keys are ignored (reference warns via DEBUGOUT and
            # continues), so parameter files can carry extra simulation keys.
            return
        def num(v, want_int):
            k, val = v
            if k != "number":
                raise ParseError(f"type mismatch for {name}: {line!r}")
            if want_int:
                if isinstance(val, float):
                    raise ParseError(
                        f"attempt to store a float in an int variable {name}: {line!r}"
                    )
                return int(val)
            return float(val)

        if ent.type in (PHType.INT, PHType.LONG, PHType.DOUBLE, PHType.STRING):
            if len(values) != 1:
                raise ParseError(f"scalar {name} given {len(values)} values: {line!r}")
            k, v = values[0]
            if ent.type == PHType.STRING:
                if k not in ("string", "id"):
                    raise ParseError(f"type mismatch for string {name}: {line!r}")
                ent.value = str(v)
            else:
                ent.value = num(values[0], ent.type in (PHType.INT, PHType.LONG))
        elif ent.type == PHType.INT_VECTOR:
            ent.value = [num(v, True) for v in values]
        elif ent.type == PHType.DOUBLE_VECTOR:
            ent.value = [num(v, False) for v in values]
        ent.defined = True

    def check_must_defines(self, where: str):
        missing = [
            e.name
            for e in self._symbols.values()
            if e.must_define and not e.defined
        ]
        if missing:
            raise ParseError(
                f"{where}: required parameter(s) not defined: {', '.join(missing)}"
            )
