"""The rule expression language: a bel-compatible CEL subset.

Public surface mirrors the reference's rules-crate boundary
(rules/rules.rs, pingoo/rules.rs): compile_expression / validate_expression
/ Program / Context, plus the value types (Ip, Regex) and error split
(CompileError at config load, EvalError -> no-match at runtime).
"""

from .errors import CompileError, EvalError, ExprError
from .interp import Context, evaluate
from .parser import parse
from .program import (
    Program,
    References,
    compile_expression,
    execute_as_bool,
    validate_expression,
)
from .values import Ip, Regex, type_name

__all__ = [
    "CompileError",
    "Context",
    "EvalError",
    "ExprError",
    "Ip",
    "Program",
    "References",
    "Regex",
    "compile_expression",
    "evaluate",
    "execute_as_bool",
    "parse",
    "type_name",
    "validate_expression",
]
