"""Rule AST -> device predicate IR.

Lowers each compiled rule expression (expr/ast.py) into:

  * a set of deduplicated *leaf predicates* executed batched on device —
    string matches (eq/prefix/suffix via ops/match_ops.py, contains/regex
    via the NFA bank), ip/CIDR membership, int-set membership, numeric
    comparisons over request columns; and
  * a boolean IR tree combining leaf results with error lanes that
    reproduce the interpreter's exact error semantics: `&&`/`||`
    short-circuit left-to-right, every other operator evaluates both
    sides, and a top-level error means no-match (fail-open, reference
    pingoo/rules.rs:41-44).

Anything outside the device subset raises LowerError and the whole rule
falls back to host interpretation (the parity oracle) — never silently
approximated. Subtrees referencing only `lists` are constant-folded with
the interpreter at compile time.

Value-category model during lowering:
  LBool(ir)      — boolean IR tree
  LNum(numexpr)  — int64 scalar expression over request columns
  LStrField(f)   — a request byte field (path/url/host/method/user_agent/
                   country)
  LStrLit(s)     — compile-time string
  LIp            — the client ip column
  LList(...)     — a statically-resolved list (config lists or literals)
  LErr           — subtree that always errors at runtime (missing list
                   key, type mismatch): usable, but poisons via err lane
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..expr import ast
from ..expr.errors import EvalError
from ..expr.interp import Context, evaluate
from ..expr.values import I64_MAX, I64_MIN, Ip
from . import repat

# Request byte fields and their device capacities (bytes). The reference
# caps UA at 256 (empty + 403 on overflow, http_listener.rs:159,196-198)
# and host at 256 (EMPTY on overflow, get_host http_listener.rs:284-296,
# http_utils.rs:20-21) but matches the FULL path/url. The listener
# reproduces the UA/host caps before encoding, so those fields never
# overflow; path/url/method get generous device capacities and any
# request whose field still exceeds its capacity is re-evaluated on the
# host interpreter over the UNTRUNCATED strings (engine/service.py), so
# on the Python plane padding a URL can never bypass a content rule.
# (The native ring plane carries the same 2048-byte caps in its slots;
# overflow rows ship their FULL url/path through the ring's spill area
# and are re-evaluated untruncated by the sidecar — native_ring.py
# _interpret_overflow_row — so both planes match full strings.)
DEFAULT_FIELD_SPECS = {
    "host": 256,
    "url": 2048,
    "path": 2048,
    "method": 16,
    "user_agent": 256,
    "country": 2,
}
NUM_COLUMNS = ("asn", "remote_port")
MAX_INLINE_STR_LIST = 1024
MAX_SMALL_CIDR_LIST = 2048


class LowerError(Exception):
    """Expression is outside the device subset -> host-interpreted rule."""


def _lit_bytes(value: str) -> bytes | None:
    """Literal -> canonical bytes (latin-1 view, expr/values.py). None if
    the literal contains chars > 0xFF, which can never match byte data."""
    try:
        return value.encode("latin-1")
    except UnicodeEncodeError:
        return None


# -- boolean IR --------------------------------------------------------------


@dataclass(frozen=True)
class BConst:
    value: bool


@dataclass(frozen=True)
class BErrConst:
    """Always-error subtree (e.g. missing list key, type mismatch)."""


@dataclass(frozen=True)
class BLeaf:
    leaf_id: int


@dataclass(frozen=True)
class BNot:
    x: "BoolIR"


@dataclass(frozen=True)
class BAnd:
    left: "BoolIR"
    right: "BoolIR"


@dataclass(frozen=True)
class BOr:
    left: "BoolIR"
    right: "BoolIR"


@dataclass(frozen=True)
class BEqBool:
    """Bool == Bool (both sides evaluated; no short-circuit)."""

    left: "BoolIR"
    right: "BoolIR"
    negate: bool


BoolIR = object  # union of the above


# -- numeric IR --------------------------------------------------------------


@dataclass(frozen=True)
class NConst:
    value: int


@dataclass(frozen=True)
class NCol:
    name: str  # 'asn' | 'remote_port'


@dataclass(frozen=True)
class NLen:
    field: str


@dataclass(frozen=True)
class NBin:
    op: str  # + - * / %
    left: "NumIR"
    right: "NumIR"


@dataclass(frozen=True)
class NNeg:
    x: "NumIR"


NumIR = object


# -- leaf predicates ---------------------------------------------------------


@dataclass(frozen=True)
class StrPred:
    """eq / prefix / suffix over a byte field."""

    kind: str  # 'eq' | 'prefix' | 'suffix'
    field: str
    pattern: bytes
    ci: bool = False


@dataclass(frozen=True)
class NfaPred:
    """contains-literal or regex over a byte field."""

    field: str
    kind: str  # 'contains' | 'regex'
    pattern: str  # literal text or regex source
    ci: bool = False


@dataclass(frozen=True)
class IpPred:
    """client.ip vs one literal address/CIDR."""

    words: tuple[int, int, int, int]
    prefix: int


@dataclass(frozen=True)
class IpListPred:
    """client.ip in a CIDR list (config list or inline array)."""

    entries: tuple[str, ...]  # canonical text forms


@dataclass(frozen=True)
class IntListPred:
    """NumExpr value in a sorted int set."""

    values: tuple[int, ...]
    probe: object  # NumIR


@dataclass(frozen=True)
class StrListPred:
    """Byte field equals any of N strings (exact match set)."""

    field: str
    entries: tuple[bytes, ...]


@dataclass(frozen=True)
class NumCmp:
    """Numeric comparison leaf: lhs <op> rhs over int64 lanes."""

    op: str  # '==' '!=' '<' '<=' '>' '>='
    left: object  # NumIR
    right: object  # NumIR


LeafPred = object  # union


def nfa_leaf_patterns(leaf: "NfaPred") -> list["repat.LinearPattern"]:
    """The linear-pattern alternatives one NFA leaf scans (match = any).

    Single source of truth for the plan's bank assembly AND the
    prefilter factor pass (compiler/plan.py): both must see the exact
    same alternatives or the candidate sets could drift from the scanned
    patterns. Raises repat.Unsupported only for regex leaves that never
    passed lowering (callers hold already-lowered leaves)."""
    if leaf.kind == "contains":
        return [repat.literal_pattern(leaf.pattern.encode("latin-1"),
                                      case_insensitive=leaf.ci)]
    return repat.compile_regex(leaf.pattern)


class LeafRegistry:
    """Deduplicating allocator of leaf predicate ids."""

    def __init__(self) -> None:
        self.leaves: list[LeafPred] = []
        self._index: dict[LeafPred, int] = {}

    def add(self, leaf: LeafPred) -> int:
        idx = self._index.get(leaf)
        if idx is None:
            idx = len(self.leaves)
            self.leaves.append(leaf)
            self._index[leaf] = idx
        return idx

    def mark(self) -> int:
        return len(self.leaves)

    def rollback(self, mark: int) -> None:
        """Drop leaves registered after `mark` — used when a rule fails to
        lower mid-way, so its partial leaves don't bloat device tables.
        Leaves shared with earlier rules predate the mark and survive."""
        for leaf in self.leaves[mark:]:
            del self._index[leaf]
        del self.leaves[mark:]


# -- lowered value categories ------------------------------------------------


@dataclass(frozen=True)
class LBool:
    ir: object


@dataclass(frozen=True)
class LNum:
    ir: object


@dataclass(frozen=True)
class LStrField:
    field: str


@dataclass(frozen=True)
class LStrLit:
    value: str


@dataclass(frozen=True)
class LIp:
    pass


@dataclass(frozen=True)
class LList:
    values: tuple  # resolved items
    elem: str  # 'String' | 'Int' | 'Ip' | 'mixed'


@dataclass(frozen=True)
class LErr:
    """Always-raises subtree."""


class Lowerer:
    def __init__(self, lists: dict[str, list], registry: LeafRegistry,
                 field_specs: Optional[dict[str, int]] = None):
        self.lists = lists
        self.reg = registry
        self.field_specs = field_specs or DEFAULT_FIELD_SPECS
        self._fold_ctx = Context({"lists": lists})

    # -- public --------------------------------------------------------------

    def lower_rule(self, root: ast.Node) -> object:
        """Lower a rule expression to BoolIR. Raises LowerError."""
        self._rule_scan_bits = 0  # per-RULE NFA footprint accumulator
        val = self.lower(root)
        return self._as_bool(val)

    def _charge_scan_bits(self, bits: int) -> None:
        """Count NFA state bits against the per-rule cap — across ALL of
        the rule's matches()/contains() predicates, so one rule can't
        blow up the bank's lane count through many medium literals."""
        from .nfa import MAX_RULE_SCAN_BITS

        self._rule_scan_bits = getattr(self, "_rule_scan_bits", 0) + bits
        if self._rule_scan_bits > MAX_RULE_SCAN_BITS:
            raise LowerError("rule NFA footprint exceeds the per-rule bit cap")

    # -- helpers -------------------------------------------------------------

    def _as_bool(self, val: object) -> object:
        if isinstance(val, LBool):
            return val.ir
        if isinstance(val, LErr):
            return BErrConst()
        # Rule result must be exactly `true` (pingoo/rules.rs:47); any
        # other type is a constant no-match, not an error.
        return BConst(False)

    def _try_fold(self, node: ast.Node) -> object | None:
        """Constant-fold subtrees that reference at most `lists`."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Ident) and sub.name != "lists":
                return None
        try:
            value = evaluate(node, self._fold_ctx)
        except EvalError:
            return LErr()
        return self._value_to_lowered(value)

    def _value_to_lowered(self, value: object) -> object:
        if isinstance(value, bool):
            return LBool(BConst(value))
        if isinstance(value, int):
            return LNum(NConst(value))
        if isinstance(value, str):
            return LStrLit(value)
        if isinstance(value, float):
            raise LowerError("float values are host-evaluated")
        if isinstance(value, Ip):
            raise LowerError("bare ip constant")
        if isinstance(value, list):
            return self._list_to_lowered(value)
        raise LowerError(f"constant of unsupported type {type(value).__name__}")

    def _list_to_lowered(self, items: list) -> LList:
        if all(isinstance(i, str) for i in items):
            return LList(tuple(items), "String")
        if all(isinstance(i, int) and not isinstance(i, bool) for i in items):
            return LList(tuple(items), "Int")
        if all(isinstance(i, Ip) for i in items):
            return LList(tuple(items), "Ip")
        return LList(tuple(items), "mixed")

    # -- dispatch ------------------------------------------------------------

    def lower(self, node: ast.Node) -> object:
        folded = self._try_fold(node)
        if folded is not None:
            return folded
        if isinstance(node, ast.Member):
            return self._lower_member(node)
        if isinstance(node, ast.Index):
            return self._lower_index(node)
        if isinstance(node, ast.Call):
            return self._lower_call(node)
        if isinstance(node, ast.Unary):
            return self._lower_unary(node)
        if isinstance(node, ast.Logical):
            return self._lower_logical(node)
        if isinstance(node, ast.Binary):
            return self._lower_binary(node)
        if isinstance(node, ast.Ident):
            # A bare struct variable has no device value category.
            raise LowerError(f"bare variable {node.name!r}")
        raise LowerError(f"unsupported node {type(node).__name__}")

    def _lower_member(self, node: ast.Member) -> object:
        if isinstance(node.obj, ast.Ident):
            base = node.obj.name
            if base == "http_request":
                if node.attr in ("host", "url", "path", "method", "user_agent"):
                    return LStrField(node.attr)
                return LErr()  # unknown field -> runtime error in interp
            if base == "client":
                if node.attr == "ip":
                    return LIp()
                if node.attr == "country":
                    return LStrField("country")
                if node.attr in NUM_COLUMNS:
                    return LNum(NCol(node.attr))
                return LErr()
        raise LowerError("unsupported member access")

    def _lower_index(self, node: ast.Index) -> object:
        # lists["name"] — static resolution; other indexing is host-only.
        if (
            isinstance(node.obj, ast.Ident)
            and node.obj.name == "lists"
            and isinstance(node.key, ast.Literal)
            and isinstance(node.key.value, str)
        ):
            name = node.key.value
            if name not in self.lists:
                return LErr()  # missing key raises at runtime -> err lane
            return self._list_to_lowered(self.lists[name])
        raise LowerError("unsupported indexing")

    # -- calls ---------------------------------------------------------------

    def _lower_call(self, node: ast.Call) -> object:
        if node.recv is None:
            if node.func == "length" and len(node.args) == 1:
                return self._lower_length(self.lower(node.args[0]))
            raise LowerError(f"unsupported function {node.func}")
        recv = self.lower(node.recv)
        if node.func == "length" and not node.args:
            return self._lower_length(recv)
        if len(node.args) != 1:
            return LErr()  # arity error raises in interp
        arg = self.lower(node.args[0])

        if node.func in ("starts_with", "ends_with"):
            if isinstance(recv, LStrField) and isinstance(arg, LStrLit):
                pat = _lit_bytes(arg.value)
                if pat is None:
                    return LBool(BConst(False))  # >0xFF chars never match
                kind = "prefix" if node.func == "starts_with" else "suffix"
                leaf = self.reg.add(
                    StrPred(kind=kind, field=recv.field, pattern=pat))
                return LBool(BLeaf(leaf))
            if isinstance(recv, LErr) or isinstance(arg, LErr):
                return LErr()
            if isinstance(recv, LStrLit) and isinstance(arg, LStrLit):
                # handled by folding; only reachable with odd shapes
                raise LowerError("static starts_with not folded")
            if not isinstance(recv, (LStrField, LStrLit)) or not isinstance(
                    arg, (LStrField, LStrLit)):
                return LErr()  # type error in interp
            raise LowerError(f"{node.func} with dynamic argument")

        if node.func == "contains":
            return self._lower_contains(recv, arg)

        if node.func == "matches":
            if isinstance(recv, LStrField) and isinstance(arg, LStrLit):
                try:
                    alts = repat.compile_regex(arg.value)
                    from .nfa import MAX_SCAN_BITS, scan_bits_needed

                    total = 0
                    for lp in alts:
                        need = scan_bits_needed(lp)
                        total += need
                        if need > MAX_SCAN_BITS:
                            raise repat.Unsupported(
                                "expanded pattern exceeds the multi-word cap")
                except repat.Unsupported as exc:
                    raise LowerError(f"regex outside device subset: {exc}")
                except Exception:
                    return LErr()  # invalid regex raises EvalError in interp
                self._charge_scan_bits(total)
                leaf = self.reg.add(
                    NfaPred(field=recv.field, kind="regex", pattern=arg.value))
                return LBool(BLeaf(leaf))
            if isinstance(recv, LErr) or isinstance(arg, LErr):
                return LErr()
            if not isinstance(recv, (LStrField, LStrLit)):
                return LErr()
            raise LowerError("matches with dynamic pattern")

        return LErr()  # unknown function raises in interp

    def _lower_length(self, recv: object) -> object:
        if isinstance(recv, LStrField):
            return LNum(NLen(recv.field))
        if isinstance(recv, LErr):
            return LErr()
        if isinstance(recv, LList):
            return LNum(NConst(len(recv.values)))
        if isinstance(recv, LStrLit):
            # Char count == byte count under the latin-1 canonical view
            # (expr/interp.py _length).
            return LNum(NConst(len(recv.value)))
        return LErr()  # length() of num/bool/ip raises in interp

    def _lower_contains(self, recv: object, arg: object) -> object:
        if isinstance(recv, LErr) or isinstance(arg, LErr):
            return LErr()
        if isinstance(recv, LStrField):
            if isinstance(arg, LStrLit):
                lit = _lit_bytes(arg.value)
                if lit is None:
                    return LBool(BConst(False))  # >0xFF chars never match
                from .nfa import MAX_SCAN_BITS

                if len(lit) + 2 > MAX_SCAN_BITS:  # guard + positions + sticky
                    raise LowerError("contains literal too long for NFA span")
                self._charge_scan_bits(len(lit) + 2)
                leaf = self.reg.add(
                    NfaPred(field=recv.field, kind="contains", pattern=arg.value))
                return LBool(BLeaf(leaf))
            if isinstance(arg, (LNum, LBool, LIp, LList)):
                return LErr()  # String.contains(non-string) raises
            raise LowerError("contains with dynamic argument")
        if isinstance(recv, LList):
            return self._lower_list_contains(recv, arg)
        if isinstance(recv, (LNum, LBool, LIp)):
            return LErr()  # contains() on non-string/array raises
        raise LowerError("contains on dynamic receiver")

    def _lower_list_contains(self, recv: LList, arg: object) -> object:
        has_ip = recv.elem == "Ip" or any(isinstance(v, Ip) for v in recv.values)
        if isinstance(arg, LIp):
            # CIDR-aware membership (interp _contains: any ip item or ip
            # arg -> items converted lazily via _as_ip). The interpreter's
            # any() short-circuits: entries BEFORE the first bad one can
            # still produce True; reaching the bad entry raises. Model
            # that as (prefix-list hit) || <error>.
            entries = []
            bad_tail = False
            for item in recv.values:
                if isinstance(item, Ip):
                    entries.append(str(item))
                    continue
                if isinstance(item, str):
                    try:
                        entries.append(str(Ip(item)))
                        continue
                    except EvalError:
                        pass
                bad_tail = True
                break
            if bad_tail and not entries:
                return LErr()
            leaf = self.reg.add(IpListPred(entries=tuple(entries)))
            ir: object = BLeaf(leaf)
            if bad_tail:
                ir = BOr(ir, BErrConst())
            return LBool(ir)
        if has_ip:
            # Ip list with non-ip arg: interp converts arg via _as_ip —
            # LStrLit handled by folding; anything else errs or is host.
            if isinstance(arg, (LNum, LBool)):
                return LErr()
            raise LowerError("ip list with dynamic non-ip argument")
        if recv.elem == "Int":
            if isinstance(arg, LNum):
                leaf = self.reg.add(
                    IntListPred(values=tuple(recv.values), probe=arg.ir))
                return LBool(BLeaf(leaf))
            if isinstance(arg, (LBool, LStrLit, LStrField)):
                # equality across types never matches, never errors
                # (interp _contains swallows per-item EvalError).
                return LBool(BConst(False))
            raise LowerError("int list with unsupported argument")
        if recv.elem == "String":
            if isinstance(arg, LStrField):
                if len(recv.values) > MAX_INLINE_STR_LIST:
                    raise LowerError("string list too large for device eq table")
                # Entries with >0xFF chars can never equal a byte field.
                entries = tuple(
                    b for b in (_lit_bytes(v) for v in recv.values) if b is not None
                )
                leaf = self.reg.add(StrListPred(field=arg.field, entries=entries))
                return LBool(BLeaf(leaf))
            if isinstance(arg, (LNum, LBool)):
                return LBool(BConst(False))
            raise LowerError("string list with unsupported argument")
        if not recv.values:
            if isinstance(arg, (LNum, LStrField, LStrLit, LBool)):
                return LBool(BConst(False))
            raise LowerError("empty list with unsupported argument")
        raise LowerError("mixed-type list")

    # -- operators -----------------------------------------------------------

    def _lower_unary(self, node: ast.Unary) -> object:
        val = self.lower(node.operand)
        if node.op == "!":
            if isinstance(val, LBool):
                return LBool(BNot(val.ir))
            if isinstance(val, LErr):
                return LErr()
            return LErr()  # !non-bool raises
        if node.op == "-":
            if isinstance(val, LNum):
                return LNum(NNeg(val.ir))
            if isinstance(val, LErr):
                return LErr()
            return LErr()
        raise LowerError(f"unary {node.op}")

    def _lower_logical(self, node: ast.Logical) -> object:
        left = self.lower(node.left)
        right = self.lower(node.right)
        lb = self._operand_bool(left)
        rb = self._operand_bool(right)
        if node.op == "&&":
            return LBool(BAnd(lb, rb))
        return LBool(BOr(lb, rb))

    def _operand_bool(self, val: object) -> object:
        """Logical operand: non-bool operands error at runtime (interp
        _logical), which the err lane models as a constant error."""
        if isinstance(val, LBool):
            return val.ir
        return BErrConst()

    def _lower_binary(self, node: ast.Binary) -> object:
        op = node.op
        left = self.lower(node.left)
        right = self.lower(node.right)
        if op in ("==", "!="):
            return self._lower_eq(op, left, right)
        if op in ("<", "<=", ">", ">="):
            if isinstance(left, LNum) and isinstance(right, LNum):
                leaf = self.reg.add(NumCmp(op=op, left=left.ir, right=right.ir))
                return LBool(BLeaf(leaf))
            if isinstance(left, (LStrField, LStrLit)) and isinstance(
                    right, (LStrField, LStrLit)):
                raise LowerError("string ordering is host-evaluated")
            return LErr()  # cross-type ordering raises
        # arithmetic
        if isinstance(left, LNum) and isinstance(right, LNum):
            return LNum(NBin(op=op, left=left.ir, right=right.ir))
        if isinstance(left, LErr) or isinstance(right, LErr):
            return LErr()
        if isinstance(left, (LStrField, LStrLit)) and isinstance(
                right, (LStrField, LStrLit)) and op == "+":
            raise LowerError("string concatenation is host-evaluated")
        return LErr()  # type errors raise

    def _lower_eq(self, op: str, left: object, right: object) -> object:
        negate = op == "!="
        # Normalize literal-on-left.
        if isinstance(left, (LStrLit, LNum)) and isinstance(
                right, (LStrField, LIp)):
            left, right = right, left

        if isinstance(left, LErr) or isinstance(right, LErr):
            return LErr()
        if isinstance(left, LStrField) and isinstance(right, LStrLit):
            pat = _lit_bytes(right.value)
            if pat is None:
                return LBool(BConst(negate))  # >0xFF chars never equal a field
            leaf = self.reg.add(StrPred(kind="eq", field=left.field, pattern=pat))
            ir: object = BLeaf(leaf)
            return LBool(BNot(ir) if negate else ir)
        if isinstance(left, LIp) and isinstance(right, LStrLit):
            try:
                ip = Ip(right.value)
            except EvalError:
                return LErr()  # bad ip text raises at runtime
            if ip.is_network:
                # Interp equality is strict: an address never equals a
                # network value (expr/values.py Ip.__eq__) — containment
                # is spelled contains(), not ==.
                return LBool(BConst(negate))
            from ..ops.cidr import ip_to_words  # local import to avoid cycle

            words, prefix = ip_to_words(ip)
            leaf = self.reg.add(IpPred(words=tuple(int(w) for w in words),
                                       prefix=prefix))
            ir = BLeaf(leaf)
            return LBool(BNot(ir) if negate else ir)
        if isinstance(left, LNum) and isinstance(right, LNum):
            leaf = self.reg.add(NumCmp(op=op, left=left.ir, right=right.ir))
            return LBool(BLeaf(leaf))
        if isinstance(left, LBool) and isinstance(right, LBool):
            return LBool(BEqBool(left=left.ir, right=right.ir, negate=negate))
        if isinstance(left, LStrField) and isinstance(right, LStrField):
            raise LowerError("field-to-field comparison is host-evaluated")
        if isinstance(left, LIp) and isinstance(right, LIp):
            raise LowerError("ip-to-ip comparison is host-evaluated")
        # Cross-type equality raises in the interpreter.
        return LErr()
