"""Recursive-descent (Pratt) parser for the rule expression language.

Grammar (CEL subset per reference docs/rules.md, `in` excluded per
rules/rules.rs:69-71):

    expr        := or
    or          := and ("||" and)*
    and         := rel ("&&" rel)*
    rel         := add (("=="|"!="|"<"|"<="|">"|">=") add)?   // non-assoc
    add         := mul (("+"|"-") mul)*
    mul         := unary (("*"|"/"|"%") unary)*
    unary       := ("!"|"-")* postfix
    postfix     := primary ("." IDENT ("(" args ")")? | "[" expr "]"
                           | "(" args ")" )*
    primary     := literal | IDENT | "(" expr ")" | array | map
    array       := "[" (expr ("," expr)*)? "]"
    map         := "{" (expr ":" expr ("," expr ":" expr)*)? "}"

Relations are intentionally non-associative (`a < b < c` is a parse
error): that is one of CEL's "surprising things" the reference's language
trims off (docs/rules.md:37).
"""

from __future__ import annotations

from . import ast
from .errors import CompileError
from .lexer import BOOL, EOF, FLOAT, IDENT, INT, OP, STRING, Token, tokenize
from .values import I64_MAX, I64_MIN

_REL_OPS = ("==", "!=", "<", "<=", ">", ">=")


def parse(src: str) -> ast.Node:
    """Parse `src` into an AST. Raises CompileError on invalid input.

    Empty expressions are invalid, matching the reference's
    validate_expression (rules/rules.rs:56-58).
    """
    if not src or not src.strip():
        raise CompileError("expression is empty")
    root = _Parser(tokenize(src)).parse()
    for node in ast.walk(root):
        # Int literals must fit i64 (negative literals were constant-folded
        # in _unary, so I64_MIN is representable).
        if (
            isinstance(node, ast.Literal)
            and isinstance(node.value, int)
            and not isinstance(node.value, bool)
            and not (I64_MIN <= node.value <= I64_MAX)
        ):
            raise CompileError("integer literal out of i64 range", node.pos)
    return root


class _Parser:
    def __init__(self, tokens: list[Token]):
        self._toks = tokens
        self._i = 0

    # -- token helpers -----------------------------------------------------
    @property
    def _cur(self) -> Token:
        return self._toks[self._i]

    def _advance(self) -> Token:
        tok = self._toks[self._i]
        if tok.kind != EOF:
            self._i += 1
        return tok

    def _at_op(self, *ops: str) -> bool:
        return self._cur.kind == OP and self._cur.value in ops

    def _eat_op(self, op: str) -> Token:
        if not self._at_op(op):
            raise CompileError(f"expected {op!r}", self._cur.pos)
        return self._advance()

    # -- grammar -----------------------------------------------------------
    def parse(self) -> ast.Node:
        node = self._or()
        if self._cur.kind != EOF:
            raise CompileError(
                f"unexpected trailing input {self._cur.value!r}", self._cur.pos
            )
        return node

    def _or(self) -> ast.Node:
        node = self._and()
        while self._at_op("||"):
            pos = self._advance().pos
            node = ast.Logical(pos=pos, op="||", left=node, right=self._and())
        return node

    def _and(self) -> ast.Node:
        node = self._rel()
        while self._at_op("&&"):
            pos = self._advance().pos
            node = ast.Logical(pos=pos, op="&&", left=node, right=self._rel())
        return node

    def _rel(self) -> ast.Node:
        node = self._add()
        if self._at_op(*_REL_OPS):
            op_tok = self._advance()
            right = self._add()
            node = ast.Binary(pos=op_tok.pos, op=op_tok.value, left=node, right=right)
            if self._at_op(*_REL_OPS):
                raise CompileError(
                    "comparison operators are non-associative", self._cur.pos
                )
        return node

    def _add(self) -> ast.Node:
        node = self._mul()
        while self._at_op("+", "-"):
            op_tok = self._advance()
            node = ast.Binary(
                pos=op_tok.pos, op=op_tok.value, left=node, right=self._mul()
            )
        return node

    def _mul(self) -> ast.Node:
        node = self._unary()
        while self._at_op("*", "/", "%"):
            op_tok = self._advance()
            node = ast.Binary(
                pos=op_tok.pos, op=op_tok.value, left=node, right=self._unary()
            )
        return node

    def _unary(self) -> ast.Node:
        if self._at_op("!", "-"):
            op_tok = self._advance()
            operand = self._unary()
            if (
                op_tok.value == "-"
                and isinstance(operand, ast.Literal)
                and isinstance(operand.value, (int, float))
                and not isinstance(operand.value, bool)
            ):
                # Constant-fold negative numeric literals so that i64::MIN
                # is writable (checked_i64(-(2**63)) would otherwise be
                # unreachable from the grammar).
                return ast.Literal(pos=op_tok.pos, value=-operand.value)
            return ast.Unary(pos=op_tok.pos, op=op_tok.value, operand=operand)
        return self._postfix()

    def _postfix(self) -> ast.Node:
        node = self._primary()
        while True:
            if self._at_op("."):
                self._advance()
                if self._cur.kind != IDENT:
                    raise CompileError("expected identifier after '.'", self._cur.pos)
                name_tok = self._advance()
                if self._at_op("("):
                    args = self._args()
                    node = ast.Call(
                        pos=name_tok.pos, recv=node, func=name_tok.value, args=args
                    )
                else:
                    node = ast.Member(pos=name_tok.pos, obj=node, attr=name_tok.value)
            elif self._at_op("["):
                pos = self._advance().pos
                key = self._or()
                self._eat_op("]")
                node = ast.Index(pos=pos, obj=node, key=key)
            elif self._at_op("(") and isinstance(node, ast.Ident):
                # Bare function call: length(x). Only identifiers are
                # callable; `(a)(b)` is a parse error.
                args = self._args()
                node = ast.Call(pos=node.pos, recv=None, func=node.name, args=args)
            else:
                return node

    def _args(self) -> tuple[ast.Node, ...]:
        self._eat_op("(")
        args: list[ast.Node] = []
        if not self._at_op(")"):
            args.append(self._or())
            while self._at_op(","):
                self._advance()
                args.append(self._or())
        self._eat_op(")")
        return tuple(args)

    def _primary(self) -> ast.Node:
        tok = self._cur
        if tok.kind in (INT, FLOAT, STRING, BOOL):
            self._advance()
            return ast.Literal(pos=tok.pos, value=tok.value)
        if tok.kind == IDENT:
            self._advance()
            return ast.Ident(pos=tok.pos, name=tok.value)
        if self._at_op("("):
            self._advance()
            node = self._or()
            self._eat_op(")")
            return node
        if self._at_op("["):
            pos = self._advance().pos
            items: list[ast.Node] = []
            if not self._at_op("]"):
                items.append(self._or())
                while self._at_op(","):
                    self._advance()
                    items.append(self._or())
            self._eat_op("]")
            return ast.ArrayLit(pos=pos, items=tuple(items))
        if self._at_op("{"):
            pos = self._advance().pos
            entries: list[tuple[ast.Node, ast.Node]] = []
            if not self._at_op("}"):
                entries.append(self._map_entry())
                while self._at_op(","):
                    self._advance()
                    entries.append(self._map_entry())
            self._eat_op("}")
            return ast.MapLit(pos=pos, entries=tuple(entries))
        if tok.kind == EOF:
            raise CompileError("unexpected end of input", tok.pos)
        raise CompileError(f"unexpected token {tok.value!r}", tok.pos)

    def _map_entry(self) -> tuple[ast.Node, ast.Node]:
        key = self._or()
        self._eat_op(":")
        value = self._or()
        return key, value
