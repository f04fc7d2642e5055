"""Bit-parallel NFA banks: packing linear patterns into uint32 lanes.

An `NfaBank` holds every contains/regex predicate that scans one request
field (path, url, host, user_agent, ...). Patterns are packed into uint32
words — one guard bit + one bit per position — and executed as extended
Shift-And (Glushkov over linear patterns) with pure bitwise ops:

    inj  = INIT_unanchored | (t == 0 ? INIT_anchored : 0)
    adv  = (S << 1) | inj | word_carry(S)   # bit31 -> bit0 of next word
    adv |= ((adv & OPT) + OPT) ^ OPT        # skip optional runs (carry trick)
    pre  = adv | (S & REP)                  # self-loops for x* / x+
    S'   = pre & B[c]                       # byte-class transition

The optional-skip identity: within a run of consecutive OPT bits, adding
(adv & OPT) to OPT carries through the run; XOR with OPT recovers every
position from the first active bit through one past the run's end —
exactly the Glushkov epsilon-skip closure for linear patterns.

Multi-word patterns (> ~31 positions after expansion — the OWASP-CRS
long literals and bounded-repeat classes): a pattern spanning k uint32
words gets a DEDICATED run of consecutive words. Advancement crosses
word boundaries through `carry_mask` (bit31 of word w feeds bit0 of
word w+1 where enabled), and the optional-skip closure crosses through
its add-carry: a run reaching bit31 overflows the uint32 add, detected
as `sum < OPT`, and re-injected at bit0 of the next word before another
propagation pass. The number of passes is static per bank
(1 + max word boundaries any optional run crosses).

This module builds the (numpy) tables; ops/nfa_scan.py executes them in
JAX; `simulate` is the pure-Python oracle used by differential tests
(pattern semantics are verified three ways: Python `re` (bytes mode) ==
`simulate` == the bit-parallel scan).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .repat import LinearPattern, Pos, Quant, Unsupported

WORD_BITS = 32
# Device-residency cap for one pattern's expanded footprint (guards +
# positions + sticky bits across all alternatives). 128 bits = a 4-word
# span; anything larger is Unsupported -> host-interpreted rule.
MAX_SCAN_BITS = 128
# Cap on ONE RULE's total footprint across all its alternatives (wide
# alternations split across slots): 24 words worth of state. Keeps a
# single pathological rule from doubling the whole bank's lane count.
MAX_RULE_SCAN_BITS = 768


def _skippable(p: Pos) -> bool:
    return p.quant in (Quant.OPT, Quant.STAR)


def _repeatable(p: Pos) -> bool:
    return p.quant in (Quant.STAR, Quant.PLUS)


def _is_word(c: int) -> bool:
    from .repat import is_word_byte

    return is_word_byte(c)


def simulate(lp: LinearPattern, data: bytes) -> bool:
    """Pure-Python Glushkov simulation of one linear pattern (oracle).

    `$` semantics follow Python `re` in bytes mode (the interpreter's
    engine, expr/values.py): it accepts at the end of input AND just
    before one trailing newline. Leading/trailing \\b gate injection and
    delay acceptance by one byte (confirmed by the next byte's word-ness
    or end of input).
    """
    if lp.never_match:
        return False
    m = len(lp.positions)
    if m == 0 or lp.min_len == 0:
        if not (lp.anchor_start and (lp.anchor_end or lp.anchor_end_abs)):
            return True
        # ^...$ with nothing required: empty input, or (non-abs $ only)
        # empty before a lone trailing newline, or fall through to the
        # NFA (m>0).
        if len(data) == 0 or (data == b"\n" and not lp.anchor_end_abs):
            return True
        if m == 0:
            return False
    first_word = _is_word(next(iter(lp.positions[0].bytes))) if m else False
    last_word = _is_word(next(iter(lp.positions[-1].bytes))) if m else False
    if (lp.anchor_end or lp.anchor_end_abs) and lp.boundary_end \
            and not last_word:
        return False  # boundary can never hold at end-of-input
    last_set = _last_set(lp)
    active: set[int] = set()
    matched = False
    pend = False  # boundary_end accept awaiting confirmation
    prev_word = False  # start of input counts as non-word
    ends_nl = len(data) > 0 and data[-1] == 0x0A
    for t, c in enumerate(data):
        cur_word = _is_word(c)
        if lp.boundary_end and not (lp.anchor_end or lp.anchor_end_abs) \
                and pend and cur_word != last_word:
            matched = True
        inject = (t == 0) or not lp.anchor_start
        if lp.boundary_start and inject:
            inject = prev_word != first_word
        nxt: set[int] = set()
        candidates: set[int] = set()
        if inject:
            candidates |= _closure_from(lp, 0)
        for i in active:
            if _repeatable(lp.positions[i]):
                candidates.add(i)
            if i + 1 < m:
                candidates |= _closure_from(lp, i + 1)
        for i in candidates:
            if c in lp.positions[i].bytes:
                nxt.add(i)
        active = nxt
        hit = bool(active & last_set)
        if lp.boundary_end:
            pend = hit
        elif not (lp.anchor_end or lp.anchor_end_abs) and hit:
            matched = True
        if lp.anchor_end and ends_nl and t == len(data) - 2 and hit:
            matched = True  # accept just before the trailing newline
        prev_word = cur_word
    if lp.boundary_end and not lp.anchor_end:
        # End of input confirms a pending accept when the last consumed
        # char is a word char (EOS is the non-word side). For \b\Z the
        # fixed `matched` above stays False, so only the final-position
        # pend (+ word-ness, guaranteed by the early-out) accepts.
        return matched or (pend and last_word)
    if lp.anchor_end_abs:
        # Absolute end: accept only from the final state (no trailing-\n
        # tolerance, so `matched` never fires for abs patterns).
        return bool(active & last_set)
    if lp.anchor_end:
        return matched or bool(active & last_set)
    return matched


def _closure_from(lp: LinearPattern, start: int) -> set[int]:
    """Positions reachable as 'next consumed' entering at `start`:
    start itself plus everything past a run of skippable positions."""
    out = set()
    i = start
    m = len(lp.positions)
    while i < m:
        out.add(i)
        if _skippable(lp.positions[i]):
            i += 1
        else:
            break
    return out


def _last_set(lp: LinearPattern) -> set[int]:
    """Accept positions: i such that every later position is skippable."""
    out = set()
    for i in range(len(lp.positions) - 1, -1, -1):
        out.add(i)
        if not _skippable(lp.positions[i]):
            break
    return out


@dataclass(frozen=True)
class PatternSlot:
    """Where one input pattern lives in the bank + accept metadata.

    With sticky-accept compilation every accept is read from the FINAL
    scan state: `hit = any((S_final[word] & mask) != 0 for word, mask in
    accepts)`, plus the always/empty flags. There is no float/end
    distinction at scan time — `$`, trailing newlines, and \\b variants
    were compiled into extra positions/alternatives (see
    _expand_scan_patterns). Single-word patterns have exactly one
    (word, mask) pair; multi-word patterns may accept in several words
    (one pair per word their accept positions touch).
    """

    accepts: tuple[tuple[int, int], ...]  # (word, accept_mask) pairs
    always_match: bool
    empty_ok: bool  # additionally accept empty input (lengths == 0)


@dataclass
class NfaBank:
    """Packed bit-parallel tables for one field's pattern group.

    The scan algebra is minimal — a single carried state word vector:

        inj  = t == 0 ? init_anchored | init_unanchored : init_unanchored
        adv  = (S << 1) | inj
        adv |= ((adv & OPT) + OPT) ^ OPT     # skip optional runs
        S'   = (adv | (S & REP)) & B[c]      # self-loops + byte classes

    Accept state is *inside* S: each floating subpattern has a sticky
    bit (byte class = ALL, REP self-loop) fed by its last position, so a
    match anywhere survives to the end of the scan; `$` compiles into an
    extra accept position (and an optional-\\n alternative for Python
    re's trailing-newline semantics); \\b compiles into prepended/
    appended word-class positions and/or anchored alternatives. One
    HBM-resident carry instead of four makes the lax.scan loop ~3x
    cheaper (each carry round-trips HBM per step under XLA).
    """

    num_words: int = 0
    byte_table: np.ndarray = field(
        default_factory=lambda: np.zeros((256, 0), dtype=np.uint32)
    )  # [256, W]
    init_anchored: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32)
    )  # [W] injected at t==0 only
    init_unanchored: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32)
    )  # [W] injected every step
    opt: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint32))
    rep: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint32))
    # carry_mask[w] == 1 -> word w continues word w-1's pattern: bit31 of
    # w-1 advances into bit0 of w, and opt-closure escapes re-inject there.
    carry_mask: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32))
    # Bits that are sticky ACCEPT accumulators (self-looping on every
    # byte). rep & ~sticky == 0 means the automaton has bounded memory
    # (state at t depends only on the last `max_footprint` bytes), which
    # enables the halo-parallel sequence scan (parallel/ring.py).
    sticky_mask: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint32))
    # Static number of opt-propagation passes the scan needs
    # (1 + max word boundaries any optional run crosses).
    prop_passes: int = 1
    # Largest single-pattern footprint in bits (>= its byte memory).
    max_footprint: int = 0
    # Per-word: True for words allocated to a multi-word span (single-
    # word patterns may still share a span's LAST word's free tail).
    dedicated: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=bool))
    slots: list[PatternSlot] = field(default_factory=list)

    @property
    def num_patterns(self) -> int:
        return len(self.slots)

    @property
    def has_carry(self) -> bool:
        return bool(self.carry_mask.any())


@dataclass(frozen=True)
class _ScanPattern:
    """One compiled alternative: positions + static accept positions."""

    positions: tuple[Pos, ...]
    accept: frozenset[int]  # relative indices accepting at final state
    sticky: bool  # add a sticky accept bit after the last position
    anchored: bool


from .repat import _WORD as _WORDSET  # noqa: E402

_NONWORD = frozenset(range(256)) - _WORDSET
_NEWLINE = frozenset([0x0A])


def _expand_scan_patterns(lp: LinearPattern) -> list[_ScanPattern]:
    """Compile anchors/boundaries into plain scan alternatives.

    `X$` -> positions X + required '\n' with accepts at last_set(X) (abs
    end) and at the \n position (end just before a trailing newline).
    Trailing \b -> an appended opposite-word-class position (+ the
    absolute-end accept when the last class is word). Leading \b -> a
    prepended opposite-word-class required position, plus an anchored
    alternative for matches at position 0.
    """
    from .repat import Quant, is_word_byte

    base = tuple(lp.positions)
    m = len(base)
    base_last = frozenset(_last_set(lp))

    if (lp.anchor_end or lp.anchor_end_abs) and lp.boundary_end and m \
            and not is_word_byte(next(iter(base[-1].bytes))):
        # \b$ / \b\Z with a non-word last class: the boundary can never
        # hold at end-of-input (simulate() has the same early-out).
        return []

    variants: list[tuple[tuple[Pos, ...], frozenset[int], bool]] = []
    if lp.anchor_end_abs:
        # Absolute end (\Z / mid-$ lowering): accept only from the final
        # scan state — no appended-\n alternative, no sticky bit.
        variants.append((base, base_last, False))
    elif lp.anchor_end:
        pos = base + (Pos(bytes=_NEWLINE),)
        variants.append((pos, base_last | {m}, False))
    elif lp.boundary_end:
        last_word = is_word_byte(next(iter(base[-1].bytes)))
        if last_word:
            pos = base + (Pos(bytes=_NONWORD),)
            variants.append((pos, base_last | {m}, True))
        else:
            pos = base + (Pos(bytes=_WORDSET),)
            variants.append((pos, frozenset({m}), True))
    else:
        variants.append((base, base_last, True))

    out: list[_ScanPattern] = []
    for pos, accept, sticky in variants:
        if lp.boundary_start:
            first_word = is_word_byte(next(iter(base[0].bytes)))
            if not lp.anchor_start:
                prefix_cls = _NONWORD if first_word else _WORDSET
                shifted = frozenset(i + 1 for i in accept)
                out.append(_ScanPattern(
                    positions=(Pos(bytes=prefix_cls),) + pos,
                    accept=shifted, sticky=sticky, anchored=False))
            if first_word:
                # Boundary holds at position 0 (start is the non-word
                # side) -> anchored alternative. Non-word first class can
                # never have a boundary at position 0.
                out.append(_ScanPattern(positions=pos, accept=accept,
                                        sticky=sticky, anchored=True))
        else:
            out.append(_ScanPattern(positions=pos, accept=accept,
                                    sticky=sticky,
                                    anchored=lp.anchor_start))
    return out


def scan_bits_needed(lp: LinearPattern) -> int:
    """Bits one input pattern occupies after expansion (guards + sticky
    included). Must be <= MAX_SCAN_BITS for device residency."""
    if lp.never_match:
        return 0
    if lp.min_len == 0 and not (
            lp.anchor_start and (lp.anchor_end or lp.anchor_end_abs)):
        return 0  # always-match: no device state
    total = 0
    for sp in _expand_scan_patterns(lp):
        total += 1 + len(sp.positions) + (1 if sp.sticky else 0)
    return total


def pattern_footprint(lp: LinearPattern) -> int:
    """Largest single-alternative footprint (guard + positions + sticky)
    after expansion — an upper bound on the byte memory the halo scans
    must warm up for this pattern. 0 for never/always patterns (they
    carry no device state)."""
    if lp.never_match:
        return 0
    ends = lp.anchor_end or lp.anchor_end_abs
    if lp.min_len == 0 and not (lp.anchor_start and ends):
        return 0
    subs = _expand_scan_patterns(lp)
    if not subs:
        return 0
    return max(2 + len(s.positions) + (1 if s.sticky else 0) for s in subs)


class _BankBuilder:
    """Mutable word-table state shared by both packing paths."""

    def __init__(self) -> None:
        self.used: list[int] = []
        self.byte_rows: list[dict[int, int]] = []
        self.init_a: list[int] = []
        self.init_u: list[int] = []
        self.opt: list[int] = []
        self.rep: list[int] = []
        self.sticky: list[int] = []
        self.carry: list[bool] = []
        self.dedicated: list[bool] = []
        self.max_passes = 1
        self.max_footprint = 0

    def add_word(self, carry: bool, dedicated: bool) -> int:
        self.used.append(0)
        self.byte_rows.append({})
        self.init_a.append(0)
        self.init_u.append(0)
        self.opt.append(0)
        self.rep.append(0)
        self.sticky.append(0)
        self.carry.append(carry)
        self.dedicated.append(dedicated)
        return len(self.used) - 1

    # -- single-word path (first-fit sharing, the common case) ---------------

    def pack_shared(self, subs: list[_ScanPattern], need: int) -> PatternSlot:
        # First-fit over shared words AND the free tails of dedicated
        # span words: a span's final word rarely ends at bit 31, and the
        # tail bits above it are safe to share — the guard bit absorbs
        # the shift out of the span's top position, and any escape out
        # of the tail's bit 31 only lands where carry is enabled, which
        # the word AFTER a span's last word never is. The load-bearing
        # invariant: a non-final span word is always exactly full
        # (pack_span's place() only opens a new word at used == 32), so
        # any dedicated word with free bits IS its span's last word —
        # asserted below so a packing refactor that breaks it fails
        # loudly instead of corrupting shared patterns.
        w = -1
        for idx, used in enumerate(self.used):
            if used + need <= WORD_BITS:
                if self.dedicated[idx]:
                    assert not (idx + 1 < len(self.carry)
                                and self.carry[idx + 1]), \
                        "tail-sharing a non-final span word"
                w = idx
                break
        if w == -1:
            w = self.add_word(carry=False, dedicated=False)
        accept_mask = 0
        for sub in subs:
            base = self.used[w] + 1  # skip the guard bit
            bit = lambda i: 1 << (base + i)  # noqa: E731
            for i, pos in enumerate(sub.positions):
                for b in pos.bytes:
                    self.byte_rows[w][b] = self.byte_rows[w].get(b, 0) | bit(i)
                if _skippable(pos):
                    self.opt[w] |= bit(i)
                if _repeatable(pos):
                    self.rep[w] |= bit(i)
            if sub.anchored:
                self.init_a[w] |= bit(0)
            else:
                self.init_u[w] |= bit(0)
            for i in sub.accept:
                accept_mask |= bit(i)
            n = len(sub.positions)
            if sub.sticky:
                # Sticky accept bit: matches any byte, self-loops, fed by
                # the last position's shift/opt-propagation.
                for b in range(256):
                    self.byte_rows[w][b] = self.byte_rows[w].get(b, 0) | bit(n)
                self.rep[w] |= bit(n)
                self.sticky[w] |= bit(n)
                accept_mask |= bit(n)
                n += 1
            self.used[w] += 1 + n
            self.max_footprint = max(self.max_footprint, 1 + n)
        return PatternSlot(accepts=((w, accept_mask),),
                           always_match=False, empty_ok=False)

    # -- multi-word path (dedicated span, cross-word carry) ------------------

    def pack_span(self, subs: list[_ScanPattern]) -> PatternSlot:
        first_w = self.add_word(carry=False, dedicated=True)
        cur = [first_w]  # boxed current word

        def gbit(w: int, b: int) -> int:
            return (w - first_w) * WORD_BITS + b

        def place() -> tuple[int, int]:
            if self.used[cur[0]] == WORD_BITS:
                cur[0] = self.add_word(carry=True, dedicated=True)
            b = self.used[cur[0]]
            self.used[cur[0]] += 1
            return cur[0], b

        accepts: dict[int, int] = {}
        for sub in subs:
            place()  # guard bit: absorbs shift-in from the previous region
            run_start: int | None = None  # global bit of current opt run

            def close_run(end_g: int) -> None:
                nonlocal run_start
                if run_start is not None:
                    # The epsilon closure from an active bit at run_start
                    # reaches end_g (one past the run); each word boundary
                    # in between needs one extra propagation pass.
                    crossings = end_g // WORD_BITS - run_start // WORD_BITS
                    self.max_passes = max(self.max_passes, 1 + crossings)
                    run_start = None

            placed: list[tuple[int, int]] = []
            first = True
            for pos in sub.positions:
                w, b = place()
                for byte in pos.bytes:
                    self.byte_rows[w][byte] = (
                        self.byte_rows[w].get(byte, 0) | (1 << b))
                if _skippable(pos):
                    self.opt[w] |= 1 << b
                    if run_start is None:
                        run_start = gbit(w, b)
                else:
                    close_run(gbit(w, b))
                if _repeatable(pos):
                    self.rep[w] |= 1 << b
                if first:
                    if sub.anchored:
                        self.init_a[w] |= 1 << b
                    else:
                        self.init_u[w] |= 1 << b
                    first = False
                placed.append((w, b))
            # A trailing optional run's closure must still reach one past
            # the last position (the sticky bit, when present).
            close_run(gbit(*placed[-1]) + 1)
            if sub.sticky:
                w, b = place()
                for byte in range(256):
                    self.byte_rows[w][byte] = (
                        self.byte_rows[w].get(byte, 0) | (1 << b))
                self.rep[w] |= 1 << b
                self.sticky[w] |= 1 << b
                accepts[w] = accepts.get(w, 0) | (1 << b)
            for i in sub.accept:
                w, b = placed[i]
                accepts[w] = accepts.get(w, 0) | (1 << b)
            self.max_footprint = max(
                self.max_footprint,
                2 + len(sub.positions) + (1 if sub.sticky else 0))
        return PatternSlot(
            accepts=tuple(sorted(accepts.items())),
            always_match=False, empty_ok=False)


def build_bank(patterns: list[LinearPattern]) -> NfaBank:
    """Pack linear patterns into an NfaBank.

    Patterns fitting one uint32 word (<= 32 bits after expansion) share
    words first-fit, all alternatives contiguous in the same word.
    Larger patterns (up to MAX_SCAN_BITS) get a dedicated span of
    consecutive words with cross-word carry (see module docstring).
    """
    from dataclasses import replace

    from .repat import Unsupported

    bank = NfaBank()
    packer = _BankBuilder()

    for lp in patterns:
        m = len(lp.positions)
        ends = lp.anchor_end or lp.anchor_end_abs
        always = lp.min_len == 0 and not (lp.anchor_start and ends)
        empty_ok = lp.min_len == 0 and lp.anchor_start and ends
        no_match = PatternSlot(accepts=(), always_match=False, empty_ok=False)
        if lp.never_match:
            bank.slots.append(no_match)
            continue
        if always or (m == 0 and not (lp.anchor_start and lp.anchor_end)):
            bank.slots.append(replace(no_match, always_match=True))
            continue

        subs = _expand_scan_patterns(lp)
        need = sum(1 + len(s.positions) + (1 if s.sticky else 0)
                   for s in subs)
        if not subs or need == 0:
            # e.g. ^\b with non-word first class only: unsatisfiable.
            bank.slots.append(replace(no_match, empty_ok=empty_ok))
            continue
        if need > MAX_SCAN_BITS:
            raise Unsupported(f"pattern needs {need} bits > {MAX_SCAN_BITS}")
        if need <= WORD_BITS:
            slot = packer.pack_shared(subs, need)
        else:
            slot = packer.pack_span(subs)
        bank.slots.append(replace(slot, empty_ok=empty_ok))

    W = len(packer.used)
    bank.num_words = W
    table = np.zeros((256, W), dtype=np.uint32)
    for w in range(W):
        for b, mask in packer.byte_rows[w].items():
            table[b, w] = mask
    bank.byte_table = table
    bank.init_anchored = np.array(packer.init_a, dtype=np.uint32)
    bank.init_unanchored = np.array(packer.init_u, dtype=np.uint32)
    bank.opt = np.array(packer.opt, dtype=np.uint32)
    bank.rep = np.array(packer.rep, dtype=np.uint32)
    bank.carry_mask = np.array(packer.carry, dtype=np.uint32)
    bank.sticky_mask = np.array(packer.sticky, dtype=np.uint32)
    bank.prop_passes = packer.max_passes
    bank.max_footprint = packer.max_footprint
    bank.dedicated = np.array(packer.dedicated, dtype=bool)
    return bank


# ---------------------------------------------------------------------------
# Bitsplit-DFA lowering: subset-construct a bank's position
# NFA into byte-indexed transition tables so the scan becomes one
# [S, C]-row gather per byte instead of the dependent one-hot matmul
# chain. Optional approximate state merging (quotient by bounded-depth
# bisimulation signatures) shrinks the NFA *before* determinization;
# merging only ever ADDS behavior (byte classes, successors, accepts
# are unioned), so an approximate DFA over-approximates every slot:
# candidates ⊇ matches, and the engine rechecks candidates against the
# exact NFA (engine/verdict.py), mirroring prefilter prune-only
# soundness. docs/DFA.md documents the pipeline.
# ---------------------------------------------------------------------------

DFA_STATE_BUDGET = 4096  # default PINGOO_DFA_STATES (clamped <= 65536)
DFA_MERGE_DEPTHS = (8, 4, 2)  # default PINGOO_DFA_MERGE ladder


@dataclass
class DfaBank:
    """Byte-indexed DFA tables for one field's pattern group.

    Execution (ops/bitsplit_dfa.py):

        H    |= step_accept[state]          # while t < len (sticky fire)
        state = trans[state, byte_cls[c]]   # while t < len
        ...
        H |= end_accept[state_final]        # absolute-end accepts
        hit[p] = (H[slot p's word] & slot mask) | always | (empty_ok & len==0)

    State 0 is the dedicated start state (it alone carries the t==0
    anchored injection) and is never a transition target; the empty
    subset is interned separately as the dead/idle state. Sticky accept
    accumulators are factored OUT of the subset state (they would
    otherwise multiply reachable subsets by 2^latched) and fired into
    the H accumulator via `step_accept` instead — `step_accept[Q]` is
    the slot mask whose sticky bit the NEXT consumed byte would light
    from subset Q, which is byte-independent because sticky bits match
    every byte.
    """

    trans: np.ndarray        # [S, C] int32 (state, byte class) -> state
    byte_cls: np.ndarray     # [256] int32 byte -> class id
    step_accept: np.ndarray  # [S, Wh] uint32 sticky fire, read pre-step
    end_accept: np.ndarray   # [S, Wh] uint32 read at the final state
    slot_always: np.ndarray  # [P] bool
    slot_empty_ok: np.ndarray  # [P] bool
    num_states: int = 0
    num_classes: int = 0
    num_slots: int = 0
    num_words: int = 0       # Wh = ceil(P / 32) accept words
    exact: bool = True       # False -> over-approximation (recheck hits)
    merge_depth: int = 0     # signature depth that produced the tables


class _PosNfa:
    """Flattened position NFA over one bank's expanded alternatives.

    Non-sticky positions only; `succ[q]` / `inj_*` are bitmask ints over
    positions, `fire*` / `end[q]` are bitmask ints over pattern slots.
    """

    def __init__(self) -> None:
        self.bytes: list[frozenset[int]] = []
        self.rep: list[bool] = []
        self.succ: list[int] = []   # successors of q (shift + opt closure)
        self.fire: list[int] = []   # slots whose sticky bit succ(q) feeds
        self.end: list[int] = []    # slots accepting when q is active at end
        self.inj_u = 0              # injected every step
        self.inj_a = 0              # injected at t == 0 only
        self.fire_u = 0             # sticky slots fed by per-step injection
        self.fire_a = 0


def _add_sub(nfa: _PosNfa, sub: _ScanPattern, slot: int) -> None:
    n = len(sub.positions)
    slot_bit = 1 << slot
    base = len(nfa.bytes)

    def closure(start: int) -> tuple[int, int]:
        """(position mask, sticky-slot mask) reachable entering `start`:
        start plus everything past a run of skippable positions; walking
        past the last position reaches the sticky accumulator."""
        mask = 0
        i = start
        while i < n:
            mask |= 1 << (base + i)
            if not _skippable(sub.positions[i]):
                return mask, 0
            i += 1
        return mask, (slot_bit if sub.sticky else 0)

    for i, pos in enumerate(sub.positions):
        nfa.bytes.append(pos.bytes)
        nfa.rep.append(_repeatable(pos))
        smask, sfire = closure(i + 1)
        if _repeatable(pos):
            smask |= 1 << (base + i)
        nfa.succ.append(smask)
        nfa.fire.append(sfire)
        nfa.end.append(slot_bit if i in sub.accept else 0)
    imask, ifire = closure(0)
    if sub.anchored:
        nfa.inj_a |= imask
        nfa.fire_a |= ifire
    else:
        nfa.inj_u |= imask
        nfa.fire_u |= ifire


def _bank_position_nfa(
    patterns: list[LinearPattern],
) -> tuple[_PosNfa, np.ndarray, np.ndarray]:
    """Build the global position NFA + slot flag lanes for one bank.

    Slot classification replicates build_bank() bit for bit so DFA slot
    indices line up with the NfaBank's PatternSlot list.
    """
    P = len(patterns)
    slot_always = np.zeros(P, dtype=bool)
    slot_empty_ok = np.zeros(P, dtype=bool)
    nfa = _PosNfa()
    for p, lp in enumerate(patterns):
        m = len(lp.positions)
        ends = lp.anchor_end or lp.anchor_end_abs
        always = lp.min_len == 0 and not (lp.anchor_start and ends)
        empty_ok = lp.min_len == 0 and lp.anchor_start and ends
        if lp.never_match:
            continue
        if always or (m == 0 and not (lp.anchor_start and lp.anchor_end)):
            slot_always[p] = True
            continue
        subs = _expand_scan_patterns(lp)
        need = sum(1 + len(s.positions) + (1 if s.sticky else 0)
                   for s in subs)
        slot_empty_ok[p] = empty_ok
        if not subs or need == 0:
            continue
        for sub in subs:
            _add_sub(nfa, sub, p)
    return nfa, slot_always, slot_empty_ok


def _bits(mask: int):
    while mask:
        lsb = mask & -mask
        yield lsb.bit_length() - 1
        mask ^= lsb


def _merge_positions(nfa: _PosNfa, depth: int) -> tuple[_PosNfa, bool]:
    """Quotient the position NFA by depth-`depth` signature classes.

    Two positions share a class when their local attributes (self-loop,
    accept/sticky slot masks, injection membership — NOT the byte set,
    which is what gets over-approximated) agree and their successor
    CLASS sets agree through `depth` refinement rounds — a bounded-depth
    bisimulation. Distinctions propagate backward from accepting
    positions, so depth k keeps roughly the last k positions before
    each accept exact and merges (byte-unions) everything upstream: the
    suffix-window approximation of the approximate-NFA blueprint. The
    quotient unions every attribute over each class, so it simulates
    the original: any accepting run maps to an accepting run of the
    quotient, i.e. the merged automaton over-approximates every slot.
    Returns (quotient, merged?) where merged is False when the
    partition is trivial (exact)."""
    N = len(nfa.bytes)
    sigs: list = [
        (nfa.rep[q], nfa.end[q], nfa.fire[q],
         bool((nfa.inj_u >> q) & 1), bool((nfa.inj_a >> q) & 1))
        for q in range(N)
    ]
    canon: dict = {}
    ids = [canon.setdefault(s, len(canon)) for s in sigs]
    for _ in range(depth):
        canon = {}
        nxt = [
            canon.setdefault(
                (ids[q], frozenset(ids[i] for i in _bits(nfa.succ[q]))),
                len(canon))
            for q in range(N)
        ]
        if nxt == ids:
            break
        ids = nxt
    K = len(set(ids))
    if K == N:
        return nfa, False
    # Renumber classes densely in first-member order (deterministic).
    remap: dict[int, int] = {}
    for q in range(N):
        remap.setdefault(ids[q], len(remap))
    ids = [remap[i] for i in ids]

    def map_mask(mask: int) -> int:
        out = 0
        for q in _bits(mask):
            out |= 1 << ids[q]
        return out

    q_nfa = _PosNfa()
    q_nfa.bytes = [frozenset() for _ in range(K)]
    q_nfa.rep = [False] * K
    q_nfa.succ = [0] * K
    q_nfa.fire = [0] * K
    q_nfa.end = [0] * K
    for q in range(N):
        k = ids[q]
        q_nfa.bytes[k] = q_nfa.bytes[k] | nfa.bytes[q]
        q_nfa.rep[k] = q_nfa.rep[k] or nfa.rep[q]
        q_nfa.succ[k] |= map_mask(nfa.succ[q])
        q_nfa.fire[k] |= nfa.fire[q]
        q_nfa.end[k] |= nfa.end[q]
    q_nfa.inj_u = map_mask(nfa.inj_u)
    q_nfa.inj_a = map_mask(nfa.inj_a)
    q_nfa.fire_u = nfa.fire_u
    q_nfa.fire_a = nfa.fire_a
    return q_nfa, True


def _slot_words(mask: int, Wh: int) -> list[int]:
    return [(mask >> (32 * w)) & 0xFFFFFFFF for w in range(Wh)]


def _determinize(
    nfa: _PosNfa, num_slots: int, budget: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """Budget-bounded subset construction -> (trans, byte_cls,
    step_accept, end_accept) or None when the subset count exceeds
    `budget`."""
    N = len(nfa.bytes)
    # Byte -> class compression over position membership columns (the
    # ops/nfa_scan class_compress idiom, on bitmask ints).
    col = [0] * 256
    for q, bs in enumerate(nfa.bytes):
        bit = 1 << q
        for b in bs:
            col[b] |= bit
    cls_of: dict[int, int] = {}
    cls_masks: list[int] = []
    byte_cls = np.zeros(256, dtype=np.int32)
    for b in range(256):
        cid = cls_of.get(col[b])
        if cid is None:
            cid = len(cls_masks)
            cls_of[col[b]] = cid
            cls_masks.append(col[b])
        byte_cls[b] = cid
    C = len(cls_masks)

    # masks[0] is the start state (empty subset + anchored injection);
    # interned subsets start at id 1, so a re-reached empty subset gets
    # its own dead/idle id and never resurrects the t==0 injection.
    masks: list[int] = [0]
    ids: dict[int, int] = {}
    trans_rows: list[list[int]] = []
    fires: list[int] = []
    ends: list[int] = []

    def intern(mask: int) -> int:
        sid = ids.get(mask)
        if sid is None:
            sid = len(masks)
            ids[mask] = sid
            masks.append(mask)
        return sid

    sid = 0
    while sid < len(masks):
        if sid == 0:
            cand = nfa.inj_u | nfa.inj_a
            fire = nfa.fire_u | nfa.fire_a
            end = 0
        else:
            cand = nfa.inj_u
            fire = nfa.fire_u
            end = 0
            for q in _bits(masks[sid]):
                cand |= nfa.succ[q]
                fire |= nfa.fire[q]
                end |= nfa.end[q]
        # One AND per class against the per-state candidate mask: the
        # construction is O(S * (|Q| + C)), not O(S * C * |Q|).
        row = [intern(cand & cm) for cm in cls_masks]
        if len(masks) > budget:
            return None
        trans_rows.append(row)
        fires.append(fire)
        ends.append(end)
        sid += 1

    S = len(masks)
    Wh = max(1, -(-num_slots // 32))
    trans = np.asarray(trans_rows, dtype=np.int32).reshape(S, C)
    step_accept = np.asarray(
        [_slot_words(f, Wh) for f in fires], dtype=np.uint32)
    end_accept = np.asarray(
        [_slot_words(e, Wh) for e in ends], dtype=np.uint32)
    return trans, byte_cls, step_accept, end_accept


def _dfa_state_budget(state_budget: int | None) -> int:
    import os

    if state_budget is None:
        try:
            state_budget = int(
                os.environ.get("PINGOO_DFA_STATES", DFA_STATE_BUDGET))
        except ValueError:
            state_budget = DFA_STATE_BUDGET
    # 65536 keeps state ids exact through the Pallas f32 one-hot path.
    return max(2, min(int(state_budget), 65536))


def _dfa_merge_depths(merge_depths) -> tuple[int, ...]:
    import os

    if merge_depths is None:
        env = os.environ.get("PINGOO_DFA_MERGE")
        if env is None:
            return DFA_MERGE_DEPTHS
        try:
            return tuple(int(x) for x in env.split(",") if x.strip())
        except ValueError:
            return DFA_MERGE_DEPTHS
    return tuple(merge_depths)


def lower_bank_to_dfa(
    patterns: list[LinearPattern],
    state_budget: int | None = None,
    merge_depths: tuple[int, ...] | None = None,
) -> DfaBank | None:
    """Lower one bank's patterns to a bitsplit DFA, or None on blow-up.

    Tries the exact subset construction first; when it exceeds the
    state budget, retries after approximate merging at each depth in
    `merge_depths` (finer first — deeper signatures merge less). Every
    failure falls through; None means the caller keeps the NFA tables.
    """
    budget = _dfa_state_budget(state_budget)
    depths = _dfa_merge_depths(merge_depths)
    nfa, slot_always, slot_empty_ok = _bank_position_nfa(patterns)
    if not nfa.bytes:
        return None  # no device-state patterns: nothing to lower
    P = len(patterns)
    attempts: list[tuple[_PosNfa, bool, int]] = [(nfa, True, 0)]
    for d in depths:
        merged, did = _merge_positions(nfa, d)
        if did:
            attempts.append((merged, False, d))
    for cand_nfa, exact, depth in attempts:
        res = _determinize(cand_nfa, P, budget)
        if res is None:
            continue
        trans, byte_cls, step_accept, end_accept = res
        return DfaBank(
            trans=trans, byte_cls=byte_cls, step_accept=step_accept,
            end_accept=end_accept, slot_always=slot_always,
            slot_empty_ok=slot_empty_ok, num_states=trans.shape[0],
            num_classes=trans.shape[1], num_slots=P,
            num_words=step_accept.shape[1], exact=exact,
            merge_depth=depth)
    return None


def scan_chunk_numpy(bank: NfaBank, data: np.ndarray, lengths: np.ndarray,
                     state: np.ndarray | None = None,
                     t_offset: int = 0) -> np.ndarray:
    """Chunk-carry reference scan: resume the bitwise algebra from a
    carried state word vector.

    `lengths` are GLOBAL row lengths and `t_offset` is the global
    position of data[:, 0]; the anchored injection fires only at global
    t == 0, so feeding a row through consecutive chunks while threading
    `state` must equal one contiguous scan. That seam-invariance is what
    the torn-literal obligation (compiler/obligations.py, `make prove`)
    checks for every compiled body/plan bank.
    """
    B, L = data.shape
    W = bank.num_words
    has_carry = bank.has_carry
    carry_mask = bank.carry_mask
    opt = bank.opt
    if state is None:
        S = np.zeros((B, W), dtype=np.uint32)
    else:
        S = state.astype(np.uint32).copy()
    for tl in range(L):
        t = t_offset + tl
        c = data[:, tl].astype(np.int64)
        bc = bank.byte_table[c]  # [B, W]
        inj = bank.init_unanchored[None, :]
        if t == 0:
            inj = inj | bank.init_anchored[None, :]
        adv = ((S << np.uint32(1)) | inj).astype(np.uint32)
        if has_carry:
            # bit31 of word w-1 advances into bit0 of word w.
            carry = np.zeros_like(S)
            carry[:, 1:] = (S[:, :-1] >> np.uint32(31)) & np.uint32(1)
            adv |= carry & carry_mask
        for p in range(bank.prop_passes):
            x = ((adv & opt) + opt).astype(np.uint32)  # wraps on escape
            adv |= x ^ opt
            if has_carry and p + 1 < bank.prop_passes:
                # Closure escaped past bit31 (add overflow) -> re-inject
                # at bit0 of the next span word and propagate again.
                esc = (x < opt).astype(np.uint32)
                esc_in = np.zeros_like(S)
                esc_in[:, 1:] = esc[:, :-1]
                adv |= esc_in & carry_mask
        S_new = ((adv | (S & bank.rep)) & bc).astype(np.uint32)
        S = np.where((t < lengths)[:, None], S_new, S)
    return S


def extract_numpy(bank: NfaBank, state: np.ndarray,
                  lengths: np.ndarray) -> np.ndarray:
    """Slot extraction from a final scan state: [B, W] -> [B, P] bool."""
    B = state.shape[0]
    W = bank.num_words
    out = np.zeros((B, bank.num_patterns), dtype=bool)
    empty = lengths == 0
    for p, slot in enumerate(bank.slots):
        if slot.always_match:
            out[:, p] = True
            continue
        hit = np.zeros(B, dtype=bool)
        for w, mask in slot.accepts:
            if W and mask:
                hit |= (state[:, w] & np.uint32(mask)) != 0
        if slot.empty_ok:
            hit |= empty
        out[:, p] = hit
    return out


def scan_numpy(bank: NfaBank, data: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reference bitwise scan in numpy (same algebra as the JAX op).

    data: [B, L] uint8, lengths: [B] -> matched [B, P] bool.
    """
    return extract_numpy(
        bank, scan_chunk_numpy(bank, data, lengths), lengths)
