"""Tokenizer for the rule expression language.

The language is the CEL subset documented by the reference at
docs/rules.md ("a subset of the Common Expression Language (CEL) with all
the inconsistencies and 'surprising' things trimmed off"). The reference
consumes it through the external `bel` crate; we implement the language
from the documented surface (docs/rules.md:37-76) rather than from that
crate's internals.

Token set: identifiers, int/float/string literals, `true`/`false`, the
operators `|| && ! == != < <= > >= + - * / %`, and the punctuation
`( ) [ ] { } , . :`. The `in` operator is intentionally NOT a token: the
reference rejects it at validation time (rules/rules.rs:69-71), so we
reject it at lex/parse time with the same user-facing message.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from .errors import CompileError

# Token kinds
IDENT = "IDENT"
INT = "INT"
FLOAT = "FLOAT"
STRING = "STRING"
BOOL = "BOOL"
OP = "OP"  # operators and punctuation; value holds the exact lexeme
EOF = "EOF"

_PUNCT2 = ("||", "&&", "==", "!=", "<=", ">=")
_PUNCT1 = "!<>+-*/%()[]{},.:"

_KEYWORDS = {"true", "false"}
# Reserved words we refuse outright. `in` mirrors the reference's explicit
# rejection (rules/rules.rs:69-71: "unknown operator: in"); `null` is part
# of full CEL but not of the documented bel type list (docs/rules.md:40-48).
_RESERVED = {"in", "null"}

_ESCAPES = {
    "n": "\n",
    "r": "\r",
    "t": "\t",
    "\\": "\\",
    '"': '"',
    "'": "'",
    "0": "\0",
}


@dataclass(frozen=True)
class Token:
    kind: str
    value: object  # str for IDENT/OP/STRING, int/float for numbers, bool
    pos: int  # byte offset of the first character, for error messages

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Token({self.kind}, {self.value!r}, @{self.pos})"


def tokenize(src: str) -> list[Token]:
    """Tokenize `src`, raising CompileError on any invalid input.

    The reference treats an empty expression as invalid
    (rules/rules.rs:56-58); we defer that check to the parser so that the
    lexer stays a pure function of characters.
    """
    return list(_tokens(src))


def _tokens(src: str) -> Iterator[Token]:
    i = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and src.startswith("//", i):
            # Line comments, CEL-style.
            j = src.find("\n", i)
            i = n if j == -1 else j + 1
            continue
        start = i
        two = src[i : i + 2]
        if two in _PUNCT2:
            yield Token(OP, two, start)
            i += 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            tok, i = _lex_number(src, i)
            yield tok
            continue
        if c in _PUNCT1:
            yield Token(OP, c, start)
            i += 1
            continue
        if c in "\"'":
            tok, i = _lex_string(src, i)
            yield tok
            continue
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word in _RESERVED:
                raise CompileError(f"unknown operator: {word}", start)
            if word in _KEYWORDS:
                yield Token(BOOL, word == "true", start)
            else:
                yield Token(IDENT, word, start)
            i = j
            continue
        raise CompileError(f"unexpected character {c!r}", i)
    yield Token(EOF, None, n)


def _lex_number(src: str, i: int) -> tuple[Token, int]:
    start = i
    n = len(src)
    if src.startswith("0x", i) or src.startswith("0X", i):
        j = i + 2
        while j < n and src[j] in "0123456789abcdefABCDEF":
            j += 1
        if j == i + 2:
            raise CompileError("invalid hex literal", start)
        return Token(INT, int(src[start:j], 16), start), j
    j = i
    is_float = False
    while j < n and src[j].isdigit():
        j += 1
    if j < n and src[j] == "." and j + 1 < n and src[j + 1].isdigit():
        is_float = True
        j += 1
        while j < n and src[j].isdigit():
            j += 1
    if j < n and src[j] in "eE":
        k = j + 1
        if k < n and src[k] in "+-":
            k += 1
        if k < n and src[k].isdigit():
            is_float = True
            j = k
            while j < n and src[j].isdigit():
                j += 1
    text = src[start:j]
    if is_float:
        return Token(FLOAT, float(text), start), j
    return Token(INT, int(text), start), j


_HEX = set("0123456789abcdefABCDEF")


def _lex_string(src: str, i: int) -> tuple[Token, int]:
    """Lex a string literal into the framework's canonical byte view.

    String values are sequences of BYTES presented as latin-1 strings
    (one char per byte, bijective — see expr/values.py). Source
    characters encode as their UTF-8 bytes (so a literal "café" compares
    equal to the UTF-8 wire bytes of café, matching the Rust reference's
    &str semantics, and "é".length() == 2 like Rust's str::len);
    `\\xhh` injects the raw byte hh; `\\uXXXX` injects the codepoint's
    UTF-8 bytes.
    """
    quote = src[i]
    start = i
    i += 1
    n = len(src)
    out = bytearray()
    while i < n:
        c = src[i]
        if c == quote:
            return Token(STRING, bytes(out).decode("latin-1"), start), i + 1
        if c == "\\":
            if i + 1 >= n:
                break
            esc = src[i + 1]
            if esc in _ESCAPES:
                out += _ESCAPES[esc].encode("utf-8")
                i += 2
                continue
            if esc == "x" and i + 3 < n:
                hex_digits = src[i + 2 : i + 4]
                if len(hex_digits) != 2 or not set(hex_digits) <= _HEX:
                    raise CompileError("invalid \\x escape", i)
                out.append(int(hex_digits, 16))
                i += 4
                continue
            if esc == "u" and i + 5 < n:
                hex_digits = src[i + 2 : i + 6]
                if len(hex_digits) != 4 or not set(hex_digits) <= _HEX:
                    raise CompileError("invalid \\u escape", i)
                cp = int(hex_digits, 16)
                if 0xD800 <= cp <= 0xDFFF:
                    raise CompileError("invalid \\u escape: surrogate", i)
                out += chr(cp).encode("utf-8")
                i += 6
                continue
            # Unknown escapes are preserved literally (like Python / YAML
            # single-quoted strings): rule expressions embed regexes
            # ("union\s+select"), and forcing double-backslashes there is
            # exactly the kind of surprise this language trims off.
            out += b"\\"
            out += esc.encode("utf-8")
            i += 2
            continue
        out += c.encode("utf-8")
        i += 1
    raise CompileError("unterminated string literal", start)
