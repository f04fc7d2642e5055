"""Regex subset -> linear NFA pattern programs for bit-parallel execution.

The TPU verdict engine executes regex/contains predicates as extended
Shift-And (bit-parallel Glushkov over *linear* patterns): a pattern is a
sequence of byte-class positions, each with a quantifier ONE / OPT (x?) /
STAR (x*) / PLUS (x+), plus start/end anchors. This covers the WAF staples
(literals, classes, ., \\d\\w\\s, quantifiers, bounded repeats, small
alternations) with pure uint32 VPU ops on device; anything outside the
subset (nested quantified groups, backrefs, lookaround, wide expansions)
is reported Unsupported and the owning rule falls back to host
interpretation — mirroring the fail-safe split in SURVEY.md §7 "Hard
parts" ("fallback to host for pathological patterns").

Byte semantics: patterns compile against UTF-8 bytes, consistent with the
interpreter's bytes-mode `re` (expr/values.py Regex) and with the byte
tensors the engine scans. `.` matches any byte except \\n. The ASCII-only
perl classes match Rust regex's (?-u) / RE2 bytes behavior.

Alternation handling: a top-level alternation compiles to multiple linear
patterns OR-ed at the predicate level; group alternations of single
chars/classes merge into one byte class; short multi-char group
alternations expand by cross product (capped).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable

# Positions per linear pattern. Multi-word packing (compiler/nfa.py
# pack_span) spreads one pattern over up to MAX_SCAN_BITS/32 uint32
# words with cross-word carry, so patterns are no longer capped at one
# word; the binding limit is nfa.MAX_SCAN_BITS on the EXPANDED footprint
# (checked at lowering), this is just a sanity bound before expansion.
MAX_POSITIONS = 126  # 1 guard + 126 positions + 1 sticky = 128 bits
MAX_CROSS_PRODUCT = 48  # cap on alternation expansion (alternatives/rule)
MAX_REPEAT_EXPANSION = 96


class Unsupported(Exception):
    """Pattern is outside the bit-parallel subset -> host fallback."""


class Quant(enum.Enum):
    ONE = "one"
    OPT = "opt"  # x?
    STAR = "star"  # x*
    PLUS = "plus"  # x+


@dataclass(frozen=True)
class Pos:
    """One pattern position: a byte class + quantifier."""

    bytes: frozenset[int]
    quant: Quant = Quant.ONE


@dataclass
class LinearPattern:
    """A linear NFA: positions consumed left to right.

    boundary_start/_end implement leading/trailing \\b (the CRS staple
    `\\bunion\\b`): a leading \\b admits a match only when the byte before
    the first consumed position has the opposite word-ness of that
    position's class; a trailing \\b requires the byte after the last
    consumed position (or end of input) to flip word-ness. Mid-pattern
    \\b stays Unsupported (host fallback).
    """

    positions: list[Pos] = field(default_factory=list)
    anchor_start: bool = False
    anchor_end: bool = False
    # Absolute end-of-input anchor (\z / \Z, and the lowering of a
    # mid-pattern $ whose suffix consumed the trailing newline): accepts
    # at the final byte only, WITHOUT $'s before-trailing-\n tolerance.
    anchor_end_abs: bool = False
    boundary_start: bool = False
    boundary_end: bool = False
    never_match: bool = False  # statically unsatisfiable (e.g. a\bb)

    @property
    def min_len(self) -> int:
        return sum(1 for p in self.positions if p.quant in (Quant.ONE, Quant.PLUS))

    @property
    def matches_empty(self) -> bool:
        return self.min_len == 0


def literal_pattern(text: bytes, case_insensitive: bool = False) -> LinearPattern:
    """A plain substring pattern (for `contains`/`starts_with`/... lowering)."""
    positions = []
    for b in text:
        positions.append(Pos(bytes=_fold_byte(b) if case_insensitive else frozenset([b])))
    if len(positions) > MAX_POSITIONS:
        raise Unsupported(f"literal longer than {MAX_POSITIONS} bytes")
    return LinearPattern(positions=positions)


def compile_regex(pattern: str) -> list[LinearPattern]:
    """Compile a regex into alternative linear patterns (match = any).

    Raises Unsupported for constructs outside the subset.
    """
    try:
        data = pattern.encode("latin-1")  # canonical byte view (expr/values.py)
    except UnicodeEncodeError:
        raise Unsupported("pattern contains non-byte characters")
    ci = False
    # Leading inline flags: (?i) / (?s) / (?i:...) not handled beyond (?i)(?s).
    while True:
        if data.startswith(b"(?i)"):
            ci = True
            data = data[4:]
        elif data.startswith(b"(?s)"):
            # We treat `.` as not matching \n; (?s) changes that.
            raise Unsupported("(?s) dotall flag")
        elif data.startswith(b"(?is)") or data.startswith(b"(?si)"):
            raise Unsupported("(?s) dotall flag")
        else:
            break
    parser = _Parser(data, ci)
    alts = parser.parse_alternation(top=True)
    if parser.i < len(parser.data):
        raise Unsupported(f"unexpected {chr(parser.data[parser.i])!r}")
    expanded: list[list[_Item]] = []
    for alt in alts:
        expanded.extend(_expand_alts(alt, at_start=True))
    if len(expanded) > MAX_CROSS_PRODUCT:
        raise Unsupported("too many alternation branches")
    # Anchor/boundary lowering pre-passes (each may fan one alternative
    # out into several, or statically eliminate it):
    #   mid-pattern $  -> end-anchored alternatives (see _lower_mid_dollar)
    #   \b next to an optional position -> case-split on its presence
    final: list[list[_Item]] = []
    for items in expanded:
        for v in _lower_mid_dollar(items):
            final.extend(_split_boundary_optionals(v))
    if len(final) > MAX_CROSS_PRODUCT:
        raise Unsupported("too many alternation branches")
    out = []
    for alt in final:
        lp = _to_linear(alt)
        if len(lp.positions) > MAX_POSITIONS:
            raise Unsupported(f"pattern expands to >{MAX_POSITIONS} positions")
        out.append(lp)
    if not out:
        # Every alternative was statically unsatisfiable.
        out.append(LinearPattern(never_match=True))
    return out


def _expand_alts(items: list[_Item],
                 at_start: bool = False) -> list[list[_Item]]:
    """Cross-product expansion of group alternations into flat sequences.

    `at_start` is True when nothing in the overall pattern can precede
    `items` (compile_regex's top-level call; propagated through groups
    while the accumulated prefix is still empty). It licenses the repeat
    truncation below.
    """
    seqs: list[list[_Item]] = [[]]
    for item in items:
        start_here = at_start and all(len(s) == 0 for s in seqs)
        if item.alts is not None:
            branches: list[list[_Item]] = []
            for alt in item.alts:
                branches.extend(_expand_alts(alt, start_here))
            new_seqs = []
            for seq in seqs:
                for branch in branches:
                    new_seqs.append(seq + branch)
            seqs = new_seqs
        elif item.seq is not None and (item.min_rep, item.max_rep) == (1, 1):
            inner = _expand_alts(item.seq, start_here)
            new_seqs = []
            for seq in seqs:
                for branch in inner:
                    new_seqs.append(seq + branch)
            seqs = new_seqs
        elif item.seq is not None:
            # Quantified multi-position group Y{lo,hi} -> alternation of
            # exact repetition counts. With NOTHING before it in an
            # unanchored search pattern, Y{lo,hi}X is match-equivalent to
            # Y{lo}X (any occurrence of Y{k}X, k >= lo, contains a
            # Y{lo}X occurrence over its last lo repetitions), so the
            # fan-out collapses to one branch — the lowering that keeps
            # CRS-style `(\.\./){3,12}etc/...` on device.
            lo, hi = item.min_rep, item.max_rep
            if start_here:
                hi = lo
            if hi == -1:
                raise Unsupported("unbounded repeat of multi-char group")
            if hi - lo + 1 > MAX_CROSS_PRODUCT or hi > MAX_REPEAT_EXPANSION:
                raise Unsupported("repeat expansion too large")
            branches = []
            for k in range(lo, hi + 1):
                branches.extend(_expand_alts(list(item.seq) * k, start_here))
            new_seqs = []
            for seq in seqs:
                for branch in branches:
                    new_seqs.append(seq + branch)
            seqs = new_seqs
        else:
            seqs = [seq + [item] for seq in seqs]
        if len(seqs) > MAX_CROSS_PRODUCT:
            raise Unsupported("too many alternation branches")
    return seqs


def _item_nullable(item: "_Item") -> bool:
    """Can this position item consume zero bytes?"""
    if item.pos is None:
        return False
    if (item.min_rep, item.max_rep) == (1, 1):
        return item.pos.quant in (Quant.OPT, Quant.STAR)
    return item.min_rep == 0


def _item_can_consume_one(item: "_Item") -> bool:
    """Can this position item consume exactly one byte?"""
    if item.pos is None:
        return False
    if (item.min_rep, item.max_rep) == (1, 1):
        return True  # ONE/OPT/STAR/PLUS all admit a single repetition
    return item.min_rep <= 1 and (item.max_rep == -1 or item.max_rep >= 1)


def _lower_mid_dollar(items: list["_Item"]) -> list[list["_Item"]]:
    """Lower a mid-pattern `$` into end-anchored alternatives.

    `$` asserts (Python-re bytes semantics, the parity oracle) that the
    current position is end-of-input or just before one trailing '\\n'.
    For X $ Y that leaves exactly two ways Y can succeed:

      * at end-of-input — Y must match empty        -> alternative X$
      * before the trailing newline — Y must consume exactly that '\\n'
        (and nothing else)                          -> alternative X'\\n'
        anchored at ABSOLUTE end (no further \\n tolerance: a$\\n must
        not match "a\\n\\n")

    Returns [] when neither applies (the pattern is unsatisfiable) and
    [items] unchanged when there is no mid-pattern $ or the suffix has
    shapes we leave to host fallback.
    """
    idx = None
    for i, it in enumerate(items):
        if it.anchor == "$" and i != len(items) - 1:
            idx = i
            break
    if idx is None:
        return [items]
    x_items = items[:idx]
    y_items = items[idx + 1:]
    if any(it.anchor in ("^", "b", "A", "Z") for it in y_items):
        return [items]  # _to_linear reports these Unsupported
    y_pos = [it for it in y_items if it.pos is not None]
    alts: list[list[_Item]] = []
    if all(_item_nullable(it) for it in y_pos):
        # Further $ items in Y hold trivially at either end position.
        alts.append(x_items + [_Item(anchor="$")])
    else:
        for j, it in enumerate(y_items):
            if it.pos is None or 0x0A not in it.pos.bytes or \
                    not _item_can_consume_one(it):
                continue
            rest = [k for k in y_items[:j] + y_items[j + 1:]
                    if k.pos is not None]
            if all(_item_nullable(k) for k in rest):
                alts.append(x_items +
                            [_Item(pos=Pos(bytes=frozenset([0x0A]))),
                             _Item(anchor="Z")])
                break
    return alts


def _leading_edge_optional(item: "_Item") -> bool:
    # An item's first expanded position is optional exactly when the
    # item can consume zero bytes.
    return _item_nullable(item)


def _trailing_edge_optional(item: "_Item") -> bool:
    if (item.min_rep, item.max_rep) == (1, 1):
        return item.pos.quant in (Quant.OPT, Quant.STAR)
    return item.max_rep != -1 and item.max_rep > item.min_rep


def _split_leading(item: "_Item") -> list[list["_Item"]]:
    """Case-split an optional-leading-edge item: absent | present."""
    if (item.min_rep, item.max_rep) == (1, 1):
        q = Quant.ONE if item.pos.quant == Quant.OPT else Quant.PLUS
        return [[], [_Item(pos=Pos(bytes=item.pos.bytes, quant=q))]]
    # {0,hi} -> absent | {1,hi}
    return [[], [_Item(pos=item.pos, min_rep=1, max_rep=item.max_rep)]]


def _split_trailing(item: "_Item") -> list[list["_Item"]]:
    """Case-split an optional-trailing-edge item into exact counts."""
    if (item.min_rep, item.max_rep) == (1, 1):
        q = Quant.ONE if item.pos.quant == Quant.OPT else Quant.PLUS
        return [[], [_Item(pos=Pos(bytes=item.pos.bytes, quant=q))]]
    return [([_Item(pos=item.pos, min_rep=k, max_rep=k)] if k else [])
            for k in range(item.min_rep, item.max_rep + 1)]


def _split_boundary_optionals(items: list["_Item"]) -> list[list["_Item"]]:
    """Case-split positions with an optional edge adjacent to a \\b.

    A \\b's truth depends on the word-ness of its immediate neighbors;
    when a neighbor position may be skipped the neighbor identity is
    dynamic, which the static mid-\\b lowering in _to_linear can't
    express. Splitting on the optional's presence makes every branch
    statically decidable: select\\b\\s*\\( becomes select\\( | select\\s+\\(.
    """
    for i, it in enumerate(items):
        if it.anchor != "b":
            continue
        nxt = items[i + 1] if i + 1 < len(items) else None
        prv = items[i - 1] if i > 0 else None
        repl: list[list[_Item]] | None = None
        lo_i = hi_i = i
        if nxt is not None and nxt.pos is not None and \
                _leading_edge_optional(nxt):
            repl = _split_leading(nxt)
            lo_i, hi_i = i + 1, i + 2
        elif prv is not None and prv.pos is not None and \
                _trailing_edge_optional(prv):
            repl = _split_trailing(prv)
            lo_i, hi_i = i - 1, i
        if repl is not None:
            out: list[list[_Item]] = []
            for r in repl:
                out.extend(_split_boundary_optionals(
                    items[:lo_i] + r + items[hi_i:]))
                if len(out) > MAX_CROSS_PRODUCT:
                    raise Unsupported("too many alternation branches")
            return out
    return [items]


# -- internal IR before linearization ---------------------------------------
# An "item" is (Pos | marker) with quantifier applied during linearization.
# Alternatives are lists of items; _Seq holds expanded sequences.


@dataclass
class _Item:
    pos: Pos | None = None  # single position
    seq: list["_Item"] | None = None  # inlined group sequence
    alts: list[list["_Item"]] | None = None  # group alternation branches
    min_rep: int = 1
    max_rep: int = 1  # -1 = unbounded
    anchor: str | None = None  # "^" or "$"


def _to_linear(items: list[_Item]) -> LinearPattern:
    lp = LinearPattern()
    flat = _flatten(items)
    pending_mid = False
    for idx, item in enumerate(flat):
        if item.anchor in ("^", "A"):
            if idx != 0:
                raise Unsupported("^ not at pattern start")
            lp.anchor_start = True
            continue
        if item.anchor == "$":
            # Mid-pattern $ is lowered by _lower_mid_dollar before this
            # pass; reaching here mid-pattern means an unhandled suffix
            # shape (e.g. \b after $) -> host fallback.
            if idx != len(flat) - 1:
                raise Unsupported("$ not at pattern end")
            lp.anchor_end = True
            continue
        if item.anchor == "Z":
            if idx != len(flat) - 1:
                raise Unsupported("\\z not at pattern end")
            lp.anchor_end_abs = True
            continue
        if item.anchor == "b":
            # \b is "leading" before any position (e.g. ^\bfoo) and
            # "trailing" when only anchors follow (e.g. foo\b$).
            if not lp.positions:
                lp.boundary_start = True
                continue
            if all(it.anchor is not None for it in flat[idx + 1:]):
                lp.boundary_end = True
                continue
            pending_mid = True
            continue
        assert item.pos is not None
        new_positions = _expand_quant(item)
        if pending_mid and new_positions:
            # Mid-pattern \b between uniform-wordness neighbors is
            # statically decidable: opposite word-ness -> the boundary
            # always holds (drop it); same word-ness -> unsatisfiable.
            prev = lp.positions[-1]
            nxt = new_positions[0]
            if prev.quant in (Quant.OPT, Quant.STAR) or nxt.quant in (
                    Quant.OPT, Quant.STAR):
                raise Unsupported("\\b next to optional position")
            if not (_uniform_wordness(prev.bytes)
                    and _uniform_wordness(nxt.bytes)):
                raise Unsupported("\\b between mixed word/non-word classes")
            prev_word = next(iter(prev.bytes)) in _WORD
            next_word = next(iter(nxt.bytes)) in _WORD
            if prev_word == next_word:
                lp.never_match = True
            pending_mid = False
        lp.positions.extend(new_positions)
        if len(lp.positions) > MAX_POSITIONS:
            raise Unsupported(f"pattern expands to >{MAX_POSITIONS} positions")
    if pending_mid:
        raise Unsupported("dangling \\b")
    _validate_boundaries(lp)
    return lp


def _validate_boundaries(lp: LinearPattern) -> None:
    """Boundary patterns need unambiguous word-ness at the edges, and
    edge positions must be required (a skippable edge changes which
    class sits at the boundary)."""
    if not (lp.boundary_start or lp.boundary_end):
        return
    if not lp.positions:
        raise Unsupported("bare \\b")
    if lp.boundary_start:
        first = lp.positions[0]
        if first.quant != Quant.ONE and first.quant != Quant.PLUS:
            raise Unsupported("\\b before optional position")
        if not _uniform_wordness(first.bytes):
            raise Unsupported("\\b before mixed word/non-word class")
    if lp.boundary_end:
        last = lp.positions[-1]
        if last.quant != Quant.ONE and last.quant != Quant.PLUS:
            raise Unsupported("\\b after optional position")
        if not _uniform_wordness(last.bytes):
            raise Unsupported("\\b after mixed word/non-word class")


def is_word_byte(b: int) -> bool:
    return b in _WORD


def _uniform_wordness(cls: frozenset[int]) -> bool:
    kinds = {b in _WORD for b in cls}
    return len(kinds) == 1


def _flatten(items: list[_Item]) -> list[_Item]:
    out: list[_Item] = []
    for item in items:
        if item.alts is not None:
            # Alternations survive only under quantified groups; those are
            # rewritten to alternation in _parse_quant_group, so reaching
            # here means a shape we can't linearize.
            raise Unsupported("alternation inside quantified group")
        if item.seq is not None:
            # _expand_alts inlined all (1,1) groups; a quantified group
            # here was already rewritten to an alternation.
            assert (item.min_rep, item.max_rep) == (1, 1)
            out.extend(_flatten(item.seq))
        else:
            out.append(item)
    return out


def _expand_quant(item: _Item) -> list[Pos]:
    """Expand a single-position item with {min,max} into positions."""
    pos = item.pos
    assert pos is not None
    lo, hi = item.min_rep, item.max_rep
    if (lo, hi) == (1, 1):
        return [pos]
    # {m,n} repeats only attach to unquantified positions (parser invariant).
    assert pos.quant == Quant.ONE
    base = Pos(bytes=pos.bytes)
    out: list[Pos] = []
    if hi == -1:
        # x{n,} -> n-1 required + one PLUS (or STAR for n==0).
        if lo == 0:
            out.append(Pos(bytes=pos.bytes, quant=Quant.STAR))
        else:
            out.extend([base] * (lo - 1))
            out.append(Pos(bytes=pos.bytes, quant=Quant.PLUS))
    else:
        if hi < lo:
            raise Unsupported("bad repeat range")
        if hi > MAX_REPEAT_EXPANSION:
            raise Unsupported("repeat expansion too large")
        out.extend([base] * lo)
        out.extend([Pos(bytes=pos.bytes, quant=Quant.OPT)] * (hi - lo))
    return out


# -- parser ------------------------------------------------------------------

_ANY = frozenset(range(256)) - frozenset([0x0A])  # '.' excludes \n
_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = (
    frozenset(range(0x30, 0x3A))
    | frozenset(range(0x41, 0x5B))
    | frozenset(range(0x61, 0x7B))
    | frozenset([0x5F])
)
_SPACE = frozenset([0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20])
_ALL = frozenset(range(256))


MAX_WINDOW_POSITIONS = 24  # conv kernel width cap for window lowering


def to_window(lp: LinearPattern):
    """Try to express a linear pattern as a fixed-length window pattern
    for the MXU correlation matcher (ops/window_match.py). Returns a
    WindowPattern or None.

    Eligible: unanchored, no word boundaries, and — after stripping
    leading/trailing optional runs, which is exact under search
    semantics (an unanchored pattern matches iff its mandatory core
    does; optional edges can always consume nothing) — every position
    is mandatory and single-byte (or an upper/lower fold pair, or a
    truly-any byte class). Classes like `.` (everything but \\n) or
    ranges stay on the NFA path: the zero-weight window position would
    accept bytes the class excludes.
    """
    from ..ops.window_match import ANY, FOLD, RAW, WindowPattern

    if (lp.never_match or lp.anchor_start or lp.anchor_end
            or lp.anchor_end_abs or lp.boundary_start or lp.boundary_end):
        return None
    positions = list(lp.positions)
    out: list[tuple[int, int]] = []
    lo = 0
    hi = len(positions)
    while lo < hi and positions[lo].quant in (Quant.OPT, Quant.STAR):
        lo += 1
    while hi > lo and positions[hi - 1].quant in (Quant.OPT, Quant.STAR):
        hi -= 1
    for k in range(lo, hi):
        pos = positions[k]
        quant = pos.quant
        if quant == Quant.PLUS and (k == lo or k == hi - 1):
            quant = Quant.ONE  # edge x+ keeps one mandatory x; the
            # repetition extends the match without gating it
        if quant != Quant.ONE:
            return None
        cls = pos.bytes
        if len(cls) == 1:
            out.append((RAW, next(iter(cls))))
        elif len(cls) == 256:
            out.append((ANY, 0))
        elif len(cls) == 2:
            a, b = sorted(cls)
            if b == a + 0x20 and 0x41 <= a <= 0x5A:
                out.append((FOLD, b))  # store the lowercase byte
            else:
                return None
        else:
            return None
    if len(out) > MAX_WINDOW_POSITIONS:
        return None
    return WindowPattern(positions=tuple(out))


def _fold_byte(b: int) -> frozenset[int]:
    if 0x41 <= b <= 0x5A:
        return frozenset([b, b + 0x20])
    if 0x61 <= b <= 0x7A:
        return frozenset([b, b - 0x20])
    return frozenset([b])


def _fold_class(cls: frozenset[int]) -> frozenset[int]:
    out = set(cls)
    for b in cls:
        out |= _fold_byte(b)
    return frozenset(out)


class _Parser:
    def __init__(self, data: bytes, ci: bool):
        self.data = data
        self.i = 0
        self.ci = ci

    def parse_alternation(self, top: bool = False) -> list[list[_Item]]:
        """Returns list of alternative item sequences."""
        alts: list[list[_Item]] = [[]]
        while self.i < len(self.data):
            c = self.data[self.i]
            if c == ord("|"):
                self.i += 1
                alts.append([])
                continue
            if c == ord(")"):
                if top:
                    raise Unsupported("unbalanced )")
                break
            item = self.parse_item()
            if item is not None:
                alts[-1].append(item)
        if len(alts) > MAX_CROSS_PRODUCT:
            raise Unsupported("too many alternation branches")
        return alts

    def parse_item(self) -> _Item | None:
        c = self.data[self.i]
        if c == ord("^"):
            self.i += 1
            return _Item(anchor="^")
        if c == ord("$"):
            self.i += 1
            return _Item(anchor="$")
        if self.data[self.i : self.i + 2] == rb"\b":
            self.i += 2
            return _Item(anchor="b")
        if self.data[self.i : self.i + 2] == rb"\A":
            self.i += 2
            return _Item(anchor="A")
        if self.data[self.i : self.i + 2] == rb"\Z":
            # Python-re \Z: absolute end of input (no trailing-\n grace).
            # \z stays Unsupported — it is a re.error in the oracle.
            self.i += 2
            return _Item(anchor="Z")
        if c == ord("("):
            return self._parse_group()
        atom = self._parse_atom()
        return self._parse_quant(atom)

    def _parse_group(self) -> _Item:
        assert self.data[self.i] == ord("(")
        self.i += 1
        if self.data[self.i : self.i + 2] == b"?:":
            self.i += 2
        elif self.data[self.i : self.i + 1] == b"?":
            raise Unsupported("special group (?...)")
        alts = self.parse_alternation()
        if self.i >= len(self.data) or self.data[self.i] != ord(")"):
            raise Unsupported("unbalanced (")
        self.i += 1
        if len(alts) == 1:
            item = _Item(seq=alts[0])
        else:
            merged = _merge_single_char_alts(alts)
            if merged is not None:
                item = _Item(pos=merged)
            else:
                # Multi-char alternation inside a group: expanded by cross
                # product in _expand_alts (unquantified groups only).
                item = _Item(alts=alts)
        return self._parse_quant_group(item)

    def _parse_quant_group(self, item: _Item) -> _Item:
        quant = self._peek_quant()
        if quant is None:
            return item
        lo, hi, lazy = quant
        if lazy:
            raise Unsupported("lazy quantifier")
        # A group that merged to one byte class ((a|b)+) or holds a single
        # position ((x){2,4}) quantifies that position directly.
        single = item.pos if item.pos is not None else None
        if single is None and item.seq is not None and len(item.seq) == 1 \
                and item.seq[0].pos is not None \
                and item.seq[0].pos.quant == Quant.ONE \
                and (item.seq[0].min_rep, item.seq[0].max_rep) == (1, 1):
            single = item.seq[0].pos
        if single is not None and single.quant == Quant.ONE:
            if (lo, hi) == (0, 1):
                return _Item(pos=Pos(bytes=single.bytes, quant=Quant.OPT))
            if (lo, hi) == (0, -1):
                return _Item(pos=Pos(bytes=single.bytes, quant=Quant.STAR))
            if (lo, hi) == (1, -1):
                return _Item(pos=Pos(bytes=single.bytes, quant=Quant.PLUS))
            return _Item(pos=single, min_rep=lo, max_rep=hi)
        # Multi-position group X{lo,hi}: per-position quantifiers cannot
        # express "skip the whole group" ((abc)? as a?b?c? would wrongly
        # match "ac"). Keep it as a quantified sequence; _expand_alts
        # rewrites it to an alternation of exact repetition counts
        # (X{0,2} -> ( | X | XX )) with positional context — a repeat
        # with nothing before it truncates to {lo} by search equivalence.
        body = item.seq if item.seq is not None else [_Item(alts=item.alts)]
        return _Item(seq=body, min_rep=lo, max_rep=hi)

    def _parse_quant(self, pos: Pos) -> _Item:
        quant = self._peek_quant()
        if quant is None:
            return _Item(pos=pos)
        lo, hi, lazy = quant
        if lazy:
            raise Unsupported("lazy quantifier")
        if (lo, hi) == (0, 1):
            return _Item(pos=Pos(bytes=pos.bytes, quant=Quant.OPT))
        if (lo, hi) == (0, -1):
            return _Item(pos=Pos(bytes=pos.bytes, quant=Quant.STAR))
        if (lo, hi) == (1, -1):
            return _Item(pos=Pos(bytes=pos.bytes, quant=Quant.PLUS))
        return _Item(pos=pos, min_rep=lo, max_rep=hi)

    def _peek_quant(self) -> tuple[int, int, bool] | None:
        if self.i >= len(self.data):
            return None
        c = self.data[self.i]
        lo: int
        hi: int
        if c == ord("?"):
            self.i += 1
            lo, hi = 0, 1
        elif c == ord("*"):
            self.i += 1
            lo, hi = 0, -1
        elif c == ord("+"):
            self.i += 1
            lo, hi = 1, -1
        elif c == ord("{"):
            j = self.data.find(b"}", self.i)
            if j == -1:
                raise Unsupported("unbalanced {")
            body = self.data[self.i + 1 : j]
            try:
                if b"," in body:
                    lo_s, hi_s = body.split(b",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s.strip() else -1
                else:
                    lo = hi = int(body)
            except ValueError:
                raise Unsupported(f"bad repeat {body!r}")
            self.i = j + 1
        else:
            return None
        lazy = False
        if self.i < len(self.data) and self.data[self.i] == ord("?"):
            lazy = True
            self.i += 1
        if self.i < len(self.data) and self.data[self.i] in b"?*+{":
            raise Unsupported("stacked quantifiers")
        return lo, hi, lazy

    def _parse_atom(self) -> Pos:
        c = self.data[self.i]
        if c == ord("."):
            self.i += 1
            return Pos(bytes=_ANY)
        if c == ord("["):
            return self._parse_class()
        if c == ord("\\"):
            cls = self._parse_escape()
            return Pos(bytes=_fold_class(cls) if self.ci else cls)
        if c in b"*+?{":
            raise Unsupported("quantifier with nothing to repeat")
        self.i += 1
        return Pos(bytes=_fold_byte(c) if self.ci else frozenset([c]))

    def _parse_escape(self) -> frozenset[int]:
        assert self.data[self.i] == ord("\\")
        self.i += 1
        if self.i >= len(self.data):
            raise Unsupported("trailing backslash")
        c = self.data[self.i]
        self.i += 1
        simple = {
            ord("d"): _DIGITS,
            ord("D"): _ALL - _DIGITS,
            ord("w"): _WORD,
            ord("W"): _ALL - _WORD,
            ord("s"): _SPACE,
            ord("S"): _ALL - _SPACE,
            ord("n"): frozenset([0x0A]),
            ord("r"): frozenset([0x0D]),
            ord("t"): frozenset([0x09]),
            ord("f"): frozenset([0x0C]),
            ord("v"): frozenset([0x0B]),
            ord("0"): frozenset([0x00]),
        }
        if c in simple:
            return simple[c]
        if c == ord("x"):
            digits = self.data[self.i : self.i + 2]
            # int(.., 16) would accept '+1'/'-1'/' 1'; require hex digits
            # so invalid escapes reject like the re/Rust oracles do.
            if len(digits) != 2 or not all(d in b"0123456789abcdefABCDEF"
                                           for d in digits):
                raise Unsupported("bad \\x escape")
            self.i += 2
            return frozenset([int(digits, 16)])
        if c == ord("b"):
            # Only reachable from class context ([\b] is backspace in re);
            # top-level \b is handled as a boundary item in parse_item.
            return frozenset([0x08])
        if c in b"BAZz":
            raise Unsupported(f"\\{chr(c)} boundary assertion")
        if c in b"123456789":
            raise Unsupported("backreference")
        # Any other letter escape is invalid in the oracle (Python re:
        # "bad escape") or has semantics we don't implement — never treat
        # it as a literal, or device and host would diverge.
        if (0x41 <= c <= 0x5A) or (0x61 <= c <= 0x7A):
            raise Unsupported(f"escape \\{chr(c)}")
        # Escaped punctuation: literal byte.
        return frozenset([c])

    def _parse_class(self) -> Pos:
        assert self.data[self.i] == ord("[")
        self.i += 1
        negate = False
        if self.i < len(self.data) and self.data[self.i] == ord("^"):
            negate = True
            self.i += 1
        members: set[int] = set()
        first = True
        while self.i < len(self.data):
            c = self.data[self.i]
            if c == ord("]") and not first:
                self.i += 1
                cls = frozenset(members)
                # Fold BEFORE negation: (?i)[^a] excludes both cases; folding
                # after negation would re-add the excluded letters.
                if self.ci:
                    cls = _fold_class(cls)
                if negate:
                    cls = _ALL - cls
                return Pos(bytes=cls)
            first = False
            if c == ord("\\"):
                sub = self._parse_escape()
                if len(sub) == 1 and self._peek_range():
                    members |= self._finish_range(next(iter(sub)))
                else:
                    members |= sub
                continue
            if c == ord("[") and self.data[self.i : self.i + 2] == b"[:":
                raise Unsupported("POSIX class")
            self.i += 1
            if self._peek_range():
                members |= self._finish_range(c)
            else:
                members.add(c)
        raise Unsupported("unbalanced [")

    def _peek_range(self) -> bool:
        return (
            self.i + 1 < len(self.data)
            and self.data[self.i] == ord("-")
            and self.data[self.i + 1] != ord("]")
        )

    def _finish_range(self, lo: int) -> set[int]:
        self.i += 1  # consume '-'
        c = self.data[self.i]
        if c == ord("\\"):
            sub = self._parse_escape()
            if len(sub) != 1:
                raise Unsupported("class range with multi-byte escape")
            hi = next(iter(sub))
        else:
            hi = c
            self.i += 1
        if hi < lo:
            raise Unsupported("reversed class range")
        return set(range(lo, hi + 1))


def _merge_single_char_alts(alts: list[list[_Item]]) -> Pos | None:
    """(a|b|c) where each branch is one unquantified position -> one class."""
    members: set[int] = set()
    for alt in alts:
        if len(alt) != 1:
            return None
        item = alt[0]
        if item.pos is None or item.min_rep != 1 or item.max_rep != 1:
            return None
        if item.pos.quant != Quant.ONE:
            return None
        members |= item.pos.bytes
    return Pos(bytes=frozenset(members))


# -- necessary literal-factor extraction (prefilter cascade) ------------------
#
# The verdict cascade (docs/PREFILTER.md) gates the serial NFA
# scan banks behind a cheap packed shift-AND pass over *necessary
# factors*: for each pattern, a sequence of byte classes that must
# appear CONSECUTIVELY in any input the pattern matches. If the factor
# is absent from a request's field bytes, the pattern cannot match —
# the prefilter may therefore PRUNE (skip/compact the exact scan) but
# never decide, which is the whole soundness argument. Patterns with no
# sufficiently selective factor are reported None and the caller marks
# them always-scan (their bank keeps running unconditionally).
#
# Which windows of a linear pattern are necessary consecutive runs?
# Position p consumes k_p bytes of class C_p with k_p == 1 for ONE,
# k_p >= 1 for PLUS, k_p >= 0 for OPT/STAR. A window [i..j] therefore
# yields a guaranteed consecutive occurrence of C_i..C_j exactly when
# every INTERIOR position is ONE (one byte each) and the EDGES are ONE
# or PLUS (take the last byte of the left PLUS run / the first byte of
# the right PLUS run). OPT/STAR anywhere in the window breaks the
# guarantee (the position may be absent). Anchors and \b constraints
# only restrict matches further, so they never invalidate a factor.

FACTOR_MAX_LEN = 12  # positions per factor (packed into uint32 lanes)
FACTOR_MAX_CLASS = 16  # byte-class size cap per factor position
# Selectivity floor: product of 256/|class| over the window must reach
# the equivalent of two exact bytes, or the factor would fire on nearly
# every request (a 1-byte factor like "/" gates nothing and still costs
# table bits).
FACTOR_MIN_SCORE = 256.0 ** 2


def _factor_windows(positions: list[Pos]) -> list[list[Pos]]:
    """Maximal candidate windows: runs of ONE/PLUS positions, cut so
    PLUS appears only at window edges (see the rule above)."""
    segs: list[list[Pos]] = []
    cur: list[Pos] = []
    for p in positions:
        if p.quant in (Quant.ONE, Quant.PLUS):
            cur.append(p)
        elif cur:
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    windows: list[list[Pos]] = []
    for seg in segs:
        start = 0
        for i, p in enumerate(seg):
            if p.quant == Quant.PLUS and i > start:
                windows.append(seg[start:i + 1])  # PLUS as right edge
                start = i
        windows.append(seg[start:])
    return windows


def _best_subwindow(win: list[Pos]):
    """Most selective contiguous subwindow of length <= FACTOR_MAX_LEN:
    (score, length, classes) or None when no position qualifies."""
    best = None
    n = len(win)
    for i in range(n):
        score = 1.0
        for j in range(i, min(i + FACTOR_MAX_LEN, n)):
            cls = win[j].bytes
            if len(cls) > FACTOR_MAX_CLASS:
                break
            score *= 256.0 / len(cls)
            cand = (score, j - i + 1,
                    tuple(p.bytes for p in win[i:j + 1]))
            if best is None or (cand[0], cand[1]) > (best[0], best[1]):
                best = cand
    return best


def necessary_factor(
        lp: LinearPattern) -> tuple[frozenset[int], ...] | None:
    """The pattern's best necessary factor: a tuple of byte classes that
    appears consecutively in EVERY input the pattern matches, chosen to
    maximize selectivity (product of 256/|class|). Returns None when the
    pattern may match without any such run — never_match (no matches to
    gate), min_len == 0 (may match empty input), or no window clearing
    the FACTOR_MIN_SCORE selectivity floor."""
    if lp.never_match or lp.min_len == 0:
        return None
    best = None
    for win in _factor_windows(lp.positions):
        cand = _best_subwindow(win)
        if cand is not None and (
                best is None or (cand[0], cand[1]) > (best[0], best[1])):
            best = cand
    if best is None or best[0] < FACTOR_MIN_SCORE:
        return None
    return best[2]


def factor_present(factor: tuple[frozenset[int], ...], data: bytes) -> bool:
    """Naive host-side factor containment (the prefilter oracle used by
    differential tests; the device kernel is ops/prefilter.py)."""
    m = len(factor)
    if m == 0:
        return True
    for i in range(len(data) - m + 1):
        if all(data[i + j] in factor[j] for j in range(m)):
            return True
    return False


# -- footprint extension (halo enablement) ------------------------------------
#
# The halo-parallel scans (ops/nfa_scan.halo_split_scan within a device,
# parallel/ring.halo_nfa_scan across devices) require BOUNDED automaton
# memory: every self-loop must be a sticky accept accumulator, which a
# true x* / x+ self-loop (Quant.STAR / Quant.PLUS rep bit) is not. This
# pass trades the unbounded loop for an EXTENDED bounded footprint: each
# repeat run is rewritten into an optional run long enough that, over
# the engine's truncated field view (every input the scan ever sees is
# at most `max_len` bytes), no match is lost — so the rewrite is exact
# by construction, not an approximation. The price is width: a run can
# need up to max_len - min_len optional positions, so the pass only
# succeeds for patterns/fields where that fits the device caps; callers
# (compiler/plan.py's halo partitioner) treat None as "keep the rep
# form and exclude from halo".


def has_unbounded_rep(lp: LinearPattern) -> bool:
    """True when the pattern carries a real (non-sticky) self-loop."""
    return any(p.quant in (Quant.STAR, Quant.PLUS) for p in lp.positions)


def extend_footprint(lp: LinearPattern, max_len: int) -> LinearPattern | None:
    """Rewrite every x*/x+ into a bounded optional run, exact for inputs
    of length <= max_len (the field's device byte cap).

    x+ becomes x x{0,r} (or x{0,r} x when the position must stay the
    pattern's last for a trailing \b); x* becomes x{0,r}; r is
    max_len - min_len, the longest any single run can be inside a
    max_len-byte window with the pattern's other required positions
    still present. Returns None when the expansion exceeds
    MAX_POSITIONS or a boundary constraint cannot be preserved.
    """
    if lp.never_match or not has_unbounded_rep(lp):
        return lp
    r = max(max_len - lp.min_len, 0)
    out: list[Pos] = []
    last_i = len(lp.positions) - 1
    for i, p in enumerate(lp.positions):
        if p.quant == Quant.STAR:
            if (i == 0 and lp.boundary_start) or \
                    (i == last_i and lp.boundary_end):
                return None  # parser rejects these; stay conservative
            out.extend(Pos(bytes=p.bytes, quant=Quant.OPT) for _ in range(r))
        elif p.quant == Quant.PLUS:
            opts = [Pos(bytes=p.bytes, quant=Quant.OPT) for _ in range(r)]
            if i == last_i and lp.boundary_end:
                if i == 0 and lp.boundary_start and r > 0:
                    # one position that must stay both first and last:
                    # no placement satisfies both boundary checks
                    return None
                out.extend(opts)
                out.append(Pos(bytes=p.bytes, quant=Quant.ONE))
            else:
                out.append(Pos(bytes=p.bytes, quant=Quant.ONE))
                out.extend(opts)
        else:
            out.append(p)
    if len(out) > MAX_POSITIONS:
        return None
    ext = LinearPattern(
        positions=out,
        anchor_start=lp.anchor_start,
        anchor_end=lp.anchor_end,
        anchor_end_abs=lp.anchor_end_abs,
        boundary_start=lp.boundary_start,
        boundary_end=lp.boundary_end,
        never_match=lp.never_match,
    )
    return ext
