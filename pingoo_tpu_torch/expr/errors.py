"""Errors for the expression language.

Mirrors the reference's error split: compile-time errors surface at config
load (reference: rules/rules.rs:45-53 `compile_expression` returns
`ExpressionIsNotValid`), while runtime evaluation errors make the rule
evaluate to no-match with a warning (reference: pingoo/rules.rs:41-44).
"""


class ExprError(Exception):
    """Base class for all expression-language errors."""


class CompileError(ExprError):
    """Raised while lexing/parsing/type-checking an expression.

    Reference parity: rules/rules.rs:45-53 — any parser failure (including
    panics, which the reference catches with catch_unwind) becomes an
    'Expression is not valid' config error.
    """

    def __init__(self, message: str, pos: int = -1):
        self.pos = pos
        if pos >= 0:
            message = f"{message} (at offset {pos})"
        super().__init__(message)


class EvalError(ExprError):
    """Raised while evaluating an expression against a context.

    Callers that implement rule matching must treat this as no-match
    (fail-open), matching pingoo/rules.rs:41-44.
    """
