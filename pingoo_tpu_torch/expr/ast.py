"""AST node definitions for the rule expression language.

Nodes are small frozen dataclasses. Every node carries its source offset
(`pos`) so both compile-time and runtime diagnostics can point back into
the expression text, and so the TPU compiler can name host-fallback sites
precisely.

The node set covers the documented bel surface (reference docs/rules.md:
types Bool/String/Int/Float/Ip/Regex/Array/Map; functions contains/length/
starts_with/ends_with; operators of the CEL subset) plus `matches` for
regex predicates (the Regex type at docs/rules.md:47 is otherwise
unreachable from the documented grammar).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class Node:
    pos: int = field(default=-1, compare=False)


@dataclass(frozen=True)
class Literal(Node):
    """Int, Float, String, or Bool literal."""

    value: object = None


@dataclass(frozen=True)
class Ident(Node):
    name: str = ""


@dataclass(frozen=True)
class Member(Node):
    """`obj.field` — member access (e.g. http_request.path)."""

    obj: Node = None
    attr: str = ""


@dataclass(frozen=True)
class Index(Node):
    """`obj[key]` — map/array indexing (e.g. lists["blocked_ips"])."""

    obj: Node = None
    key: Node = None


@dataclass(frozen=True)
class Call(Node):
    """`recv.method(args...)` method call, or bare `func(args...)` when
    recv is None (we accept `length(x)` as well as `x.length()`)."""

    recv: Node | None = None
    func: str = ""
    args: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class Unary(Node):
    """`!x` or `-x`."""

    op: str = ""
    operand: Node = None


@dataclass(frozen=True)
class Binary(Node):
    """Arithmetic / comparison: + - * / % == != < <= > >=."""

    op: str = ""
    left: Node = None
    right: Node = None


@dataclass(frozen=True)
class Logical(Node):
    """`&&` / `||` with short-circuit semantics."""

    op: str = ""
    left: Node = None
    right: Node = None


@dataclass(frozen=True)
class ArrayLit(Node):
    items: Tuple[Node, ...] = ()


@dataclass(frozen=True)
class MapLit(Node):
    entries: Tuple[Tuple[Node, Node], ...] = ()


def walk(node: Node):
    """Yield `node` and all descendants, pre-order."""
    yield node
    if isinstance(node, Member):
        yield from walk(node.obj)
    elif isinstance(node, Index):
        yield from walk(node.obj)
        yield from walk(node.key)
    elif isinstance(node, Call):
        if node.recv is not None:
            yield from walk(node.recv)
        for a in node.args:
            yield from walk(a)
    elif isinstance(node, Unary):
        yield from walk(node.operand)
    elif isinstance(node, (Binary, Logical)):
        yield from walk(node.left)
        yield from walk(node.right)
    elif isinstance(node, ArrayLit):
        for it in node.items:
            yield from walk(it)
    elif isinstance(node, MapLit):
        for k, v in node.entries:
            yield from walk(k)
            yield from walk(v)
