"""Compiled-expression API mirroring the reference's rules-crate boundary.

The reference exposes `rules::compile_expression(&str) -> bel::Program`
(rules/rules.rs:45-53), `program.execute(&Context) -> Result<Value>`
(pingoo/rules.rs:39) and `program.references().functions()`
(rules/rules.rs:65-68, used by validate_expression). This module is that
boundary for the TPU framework: everything above it (config loading, rule
matching, the TPU compiler) works with `Program` objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ast as _ast
from .errors import CompileError, EvalError
from .interp import _FREE_FUNCS, _METHODS, Context, evaluate
from .parser import parse


@dataclass(frozen=True)
class References:
    """Identifiers a program references — compile-time introspection used
    for validation (reference rules/rules.rs:60-71)."""

    functions: frozenset[str] = field(default_factory=frozenset)
    variables: frozenset[str] = field(default_factory=frozenset)


class Program:
    """A compiled expression."""

    __slots__ = ("source", "root", "_refs")

    def __init__(self, source: str, root: _ast.Node):
        self.source = source
        self.root = root
        funcs: set[str] = set()
        vars_: set[str] = set()
        for node in _ast.walk(root):
            if isinstance(node, _ast.Call):
                funcs.add(node.func)
            elif isinstance(node, _ast.Ident):
                vars_.add(node.name)
        self._refs = References(frozenset(funcs), frozenset(vars_))

    @staticmethod
    def compile(source: str) -> "Program":
        return Program(source, parse(source))

    def execute(self, ctx: Context) -> object:
        """Evaluate and return the result value. Raises EvalError."""
        return evaluate(self.root, ctx)

    def references(self) -> References:
        return self._refs

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Program({self.source!r})"


# Single source of truth for the callable surface is the interpreter.
_KNOWN_FUNCTIONS = _METHODS | _FREE_FUNCS
_KNOWN_VARIABLES = {"http_request", "client", "lists"}


def compile_expression(expression: str) -> Program:
    """Compile, raising CompileError on invalid input.

    Reference parity: rules/rules.rs:45-53 (parser panic/-error ->
    ExpressionIsNotValid).
    """
    return Program.compile(expression)


def validate_expression(expression: str) -> None:
    """Validate an expression for use in rules/routes.

    Reference parity: rules/rules.rs:55-77 — empty expressions and the
    `in` operator are rejected (the lexer already refuses `in`); unknown
    functions and variables are additionally rejected here since, unlike
    the reference's TODO (:73), we know the full variable surface.
    """
    program = Program.compile(expression)  # rejects empty input in parse()
    refs = program.references()
    for func in sorted(refs.functions):
        if func not in _KNOWN_FUNCTIONS:
            raise CompileError(f"unknown function: {func}")
    for var in sorted(refs.variables):
        if var not in _KNOWN_VARIABLES:
            raise CompileError(f"unknown variable: {var}")


def execute_as_bool(program: Program, ctx: Context) -> bool:
    """Run a program for rule matching: the result matches only if it is
    exactly `true` (reference pingoo/rules.rs:47 compares against
    `true.into()`); evaluation errors are no-match (pingoo/rules.rs:41-44).
    """
    try:
        result = program.execute(ctx)
    except EvalError:
        return False
    return result is True
