"""Rule compiler: AST -> predicate IR -> device tables.

Submodules import lazily: ops/ modules import compiler.nfa at module
scope, so eagerly importing plan here (which imports ops back) would
cycle.
"""

from .lowering import DEFAULT_FIELD_SPECS, LowerError

__all__ = [
    "DEFAULT_FIELD_SPECS",
    "LowerError",
    "RulesetPlan",
    "compile_ruleset",
    "tables_from_reference",
]


def __getattr__(name):
    if name in ("RulesetPlan", "compile_ruleset", "tables_from_reference"):
        from . import plan

        return getattr(plan, name)
    raise AttributeError(name)
