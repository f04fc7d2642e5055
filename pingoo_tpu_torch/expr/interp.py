"""Tree-walk interpreter: the CPU engine and device-parity oracle.

This is the reference semantics for the whole framework. The rule compiler
(compiler/) must produce bit-exact verdicts against this
interpreter — that is the FP/FN-parity target in BASELINE.md — so every
semantic choice here is written down:

  * Logical && / || short-circuit strictly left-to-right. An error in the
    left operand is an error; an error in the right operand only matters
    if the left operand did not already decide the result.
  * Runtime errors (type mismatch, missing map key, index out of bounds,
    div-by-zero, integer overflow) raise EvalError; rule matching treats
    that as no-match (reference pingoo/rules.rs:41-44 logs and returns
    false).
  * Int is checked signed 64-bit; Int/Int division truncates toward zero
    and % takes the dividend's sign (Rust i64 semantics, since the
    reference language is implemented in Rust).
  * Numeric comparisons allow Int/Float cross-type; equality across other
    type pairs is an error (not `false`): the least surprising reading of
    docs/rules.md:37's "surprising things trimmed off".
  * String length / ordering are byte-wise over UTF-8 (Rust `str`
    semantics), which also matches the byte-tensor view the TPU engine
    has of every string.
  * Ip == String parses the string as an ip; Array<Ip>.contains(ip) is
    CIDR-aware containment (docs/rules.md:110).
"""

from __future__ import annotations

import math
from typing import Mapping

from . import ast
from .errors import EvalError
from .values import Ip, Regex, checked_i64, type_name


class Context:
    """Variable bindings for one evaluation.

    Mirrors the reference's `bel::Context` surface: `add_variable`
    (http_listener.rs:242-247 adds `http_request` and `client`) and
    `add_variable_from_value` (http_listener.rs:249 adds `lists`).
    """

    __slots__ = ("variables",)

    def __init__(self, variables: Mapping[str, object] | None = None):
        self.variables: dict[str, object] = dict(variables or {})

    def add_variable(self, name: str, value: object) -> None:
        self.variables[name] = value


def evaluate(node: ast.Node, ctx: Context) -> object:
    """Evaluate `node` against `ctx`. Raises EvalError on runtime errors."""
    return _eval(node, ctx)


def _eval(node: ast.Node, ctx: Context) -> object:
    if isinstance(node, ast.Literal):
        return node.value
    if isinstance(node, ast.Ident):
        try:
            return ctx.variables[node.name]
        except KeyError:
            raise EvalError(f"unknown variable {node.name!r}") from None
    if isinstance(node, ast.Member):
        obj = _eval(node.obj, ctx)
        if isinstance(obj, dict):
            try:
                return obj[node.attr]
            except KeyError:
                raise EvalError(f"unknown field {node.attr!r}") from None
        raise EvalError(f"cannot access field {node.attr!r} on {type_name(obj)}")
    if isinstance(node, ast.Index):
        return _index(_eval(node.obj, ctx), _eval(node.key, ctx))
    if isinstance(node, ast.Call):
        return _call(node, ctx)
    if isinstance(node, ast.Unary):
        return _unary(node, ctx)
    if isinstance(node, ast.Logical):
        return _logical(node, ctx)
    if isinstance(node, ast.Binary):
        return _binary(node.op, _eval(node.left, ctx), _eval(node.right, ctx))
    if isinstance(node, ast.ArrayLit):
        return [_eval(it, ctx) for it in node.items]
    if isinstance(node, ast.MapLit):
        out = {}
        for k, v in node.entries:
            key = _eval(k, ctx)
            if not isinstance(key, (str, int)) or isinstance(key, bool):
                raise EvalError(f"invalid map key type {type_name(key)}")
            out[key] = _eval(v, ctx)
        return out
    raise EvalError(f"cannot evaluate {type(node).__name__}")


def _index(obj: object, key: object) -> object:
    if isinstance(obj, dict):
        if isinstance(key, bool) or not isinstance(key, (str, int)):
            raise EvalError(f"invalid map key type {type_name(key)}")
        try:
            return obj[key]
        except KeyError:
            raise EvalError(f"map key not found: {key!r}") from None
    if isinstance(obj, list):
        if isinstance(key, bool) or not isinstance(key, int):
            raise EvalError("array index must be Int")
        if key < 0 or key >= len(obj):
            raise EvalError(f"array index {key} out of bounds")
        return obj[key]
    raise EvalError(f"cannot index {type_name(obj)}")


def _logical(node: ast.Logical, ctx: Context) -> bool:
    left = _eval(node.left, ctx)
    if not isinstance(left, bool):
        raise EvalError(f"{node.op} requires Bool, got {type_name(left)}")
    if node.op == "||" and left:
        return True
    if node.op == "&&" and not left:
        return False
    right = _eval(node.right, ctx)
    if not isinstance(right, bool):
        raise EvalError(f"{node.op} requires Bool, got {type_name(right)}")
    return right


def _unary(node: ast.Unary, ctx: Context) -> object:
    val = _eval(node.operand, ctx)
    if node.op == "!":
        if not isinstance(val, bool):
            raise EvalError(f"! requires Bool, got {type_name(val)}")
        return not val
    if node.op == "-":
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            raise EvalError(f"unary - requires Int or Float, got {type_name(val)}")
        if isinstance(val, int):
            return checked_i64(-val)
        return -val
    raise EvalError(f"unknown unary operator {node.op}")


def _is_num(v: object) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _binary(op: str, left: object, right: object) -> object:
    if op in ("==", "!="):
        eq = _equals(left, right)
        return eq if op == "==" else not eq
    if op in ("<", "<=", ">", ">="):
        return _ordered(op, left, right)
    return _arith(op, left, right)


def _equals(left: object, right: object) -> bool:
    if isinstance(left, bool) or isinstance(right, bool):
        if isinstance(left, bool) and isinstance(right, bool):
            return left is right
        raise EvalError(
            f"cannot compare {type_name(left)} with {type_name(right)}"
        )
    if _is_num(left) and _is_num(right):
        return float(left) == float(right) if type(left) is not type(right) else left == right
    if isinstance(left, str) and isinstance(right, str):
        return left == right
    if isinstance(left, Ip) or isinstance(right, Ip):
        return _ip_equals(left, right)
    if isinstance(left, list) and isinstance(right, list):
        if len(left) != len(right):
            return False
        return all(_equals(a, b) for a, b in zip(left, right))
    if isinstance(left, dict) and isinstance(right, dict):
        if left.keys() != right.keys():
            return False
        return all(_equals(left[k], right[k]) for k in left)
    raise EvalError(f"cannot compare {type_name(left)} with {type_name(right)}")


def _ip_equals(left: object, right: object) -> bool:
    lip = _as_ip(left)
    rip = _as_ip(right)
    return lip == rip


def _as_ip(value: object) -> Ip:
    if isinstance(value, Ip):
        return value
    if isinstance(value, str):
        return Ip(value)  # raises EvalError on bad text
    raise EvalError(f"cannot convert {type_name(value)} to Ip")


def _ordered(op: str, left: object, right: object) -> bool:
    if _is_num(left) and _is_num(right):
        pass
    elif isinstance(left, str) and isinstance(right, str):
        # Codepoint ordering == byte ordering under the latin-1 byte view
        # (see _length); nothing to convert.
        pass
    else:
        raise EvalError(f"cannot order {type_name(left)} and {type_name(right)}")
    if op == "<":
        return left < right
    if op == "<=":
        return left <= right
    if op == ">":
        return left > right
    return left >= right


def _arith(op: str, left: object, right: object) -> object:
    if op == "+" and isinstance(left, str) and isinstance(right, str):
        return left + right
    if op == "+" and isinstance(left, list) and isinstance(right, list):
        return left + right
    if not (_is_num(left) and _is_num(right)):
        raise EvalError(
            f"operator {op} requires numeric operands, got "
            f"{type_name(left)} and {type_name(right)}"
        )
    both_int = isinstance(left, int) and isinstance(right, int)
    if op == "+":
        return checked_i64(left + right) if both_int else float(left) + float(right)
    if op == "-":
        return checked_i64(left - right) if both_int else float(left) - float(right)
    if op == "*":
        return checked_i64(left * right) if both_int else float(left) * float(right)
    if op == "/":
        if both_int:
            if right == 0:
                raise EvalError("division by zero")
            # Rust i64 division truncates toward zero.
            return checked_i64(_trunc_div(left, right))
        lf, rf = float(left), float(right)
        if rf == 0.0:
            # IEEE float semantics (Rust f64): inf/nan, not an error.
            if lf == 0.0 or math.isnan(lf):
                return math.nan
            return math.inf * math.copysign(1.0, lf) * math.copysign(1.0, rf)
        return lf / rf
    if op == "%":
        if both_int:
            if right == 0:
                raise EvalError("division by zero")
            # Rust % takes the dividend's sign.
            return checked_i64(left - _trunc_div(left, right) * right)
        lf, rf = float(left), float(right)
        if rf == 0.0 or math.isinf(lf) or math.isnan(lf) or math.isnan(rf):
            # IEEE remainder edge cases (Rust f64: inf % x == NaN, x % 0.0
            # == NaN); math.fmod would raise ValueError on an inf dividend.
            return math.nan
        return math.fmod(lf, rf)
    raise EvalError(f"unknown operator {op}")


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# -- functions ---------------------------------------------------------------

_METHODS = {"contains", "length", "starts_with", "ends_with", "matches"}
_FREE_FUNCS = {"length"}


def _call(node: ast.Call, ctx: Context) -> object:
    if node.recv is None:
        if node.func not in _FREE_FUNCS:
            raise EvalError(f"unknown function {node.func!r}")
        if len(node.args) != 1:
            raise EvalError(f"{node.func}() takes exactly 1 argument")
        return _length(_eval(node.args[0], ctx))
    if node.func not in _METHODS:
        raise EvalError(f"unknown function {node.func!r}")
    recv = _eval(node.recv, ctx)
    args = [_eval(a, ctx) for a in node.args]
    if node.func == "length":
        if args:
            raise EvalError("length() takes no arguments")
        return _length(recv)
    if len(args) != 1:
        raise EvalError(f"{node.func}() takes exactly 1 argument")
    arg = args[0]
    if node.func == "contains":
        return _contains(recv, arg)
    if node.func == "starts_with":
        _want_strings(node.func, recv, arg)
        return recv.startswith(arg)
    if node.func == "ends_with":
        _want_strings(node.func, recv, arg)
        return recv.endswith(arg)
    if node.func == "matches":
        if not isinstance(recv, str):
            raise EvalError(f"matches() requires String receiver, got {type_name(recv)}")
        if isinstance(arg, Regex):
            return arg.search(recv)
        if isinstance(arg, str):
            return Regex.cached(arg).search(recv)
        raise EvalError(f"matches() requires String or Regex argument, got {type_name(arg)}")
    raise EvalError(f"unknown function {node.func!r}")  # pragma: no cover


def _length(value: object) -> int:
    if isinstance(value, str):
        # Byte length under the framework's canonical string view: host
        # code materializes request strings by latin-1-decoding the raw
        # bytes (bijective), so char count == byte count. This matches
        # the device engine, which only ever sees byte tensors.
        return len(value)
    if isinstance(value, (list, dict)):
        return len(value)
    raise EvalError(f"length() requires String, Array or Map, got {type_name(value)}")


def _want_strings(func: str, recv: object, arg: object) -> None:
    if not isinstance(recv, str) or not isinstance(arg, str):
        raise EvalError(
            f"{func}() requires String receiver and argument, got "
            f"{type_name(recv)} and {type_name(arg)}"
        )


def _contains(recv: object, arg: object) -> bool:
    if isinstance(recv, str):
        if not isinstance(arg, str):
            raise EvalError(f"String.contains() requires String, got {type_name(arg)}")
        return arg in recv
    if isinstance(recv, list):
        if any(isinstance(item, Ip) for item in recv) or isinstance(arg, Ip):
            target = _as_ip(arg)
            return any(_as_ip(item).contains(target) for item in recv)
        for item in recv:
            try:
                if _equals(item, arg):
                    return True
            except EvalError:
                continue
        return False
    raise EvalError(f"contains() requires String or Array receiver, got {type_name(recv)}")
