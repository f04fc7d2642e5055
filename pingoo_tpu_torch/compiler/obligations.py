"""Machine-checked lowering obligations (the JAX package's
`compiler/obligations.py`, with the port's tables).

Every throughput lever the compiler pulls (the Stage-A necessary-factor
prefilter, the possibly approximate bitsplit-DFA lowering, the compact
staging caps, the footprint-extension rewrite, the streaming body
scanner's cross-window carry) is sound only under a side condition.
This module turns each side condition into a compile-time proof
obligation over the LOWERED artifacts (the tables that ship) and
serializes the discharged obligations as a `plan_proof` block that
rides the artifact cache (compiler/cache.py): a cache hit is also a
proof hit, and a failed obligation refuses the plan at compile time.

Obligation catalog (names are stable, and the JAX package's):

  bank-reconstruction   the leaf bindings' slot spans tile each bank, so
                        the per-slot source patterns are recoverable
                        deterministically (everything below keys off it)
  prefilter-necessity   per factor-gated slot: EVERY accepting run of
                        the source pattern's position NFA completes the
                        assigned factor (product reachability over
                        (position, shift-AND factor state)); PF_NEVER
                        slots are dead in the position NFA
  prefilter-consistency codes in range, bank_masks/bank_gated agree with
                        the codes, halo sub-bank codes agree with the
                        slot permutation
  dfa-containment       the lowered DFA tables over-approximate the
                        position NFA: a union-mask product fixpoint over
                        the SHIPPED transition table proves every
                        co-reachable NFA fire/end slot is contained in
                        step_accept/end_accept
  dfa-exactness         tables marked exact=True (the engine then skips
                        the NFA recheck) really are the exact subset
                        construction: single-valued subset masks per
                        state and fire/end EQUALITY
  staging-caps          per-field dependent byte depth recomputed by an
                        independent walker over the leaf/host IR matches
                        plan.staging_required, and the quantized caps
                        bound it
  footprint-extension   extended banks: the stored tables equal the
                        rebuild from a structurally certified rewrite
                        (each unbounded rep replaced by exactly
                        max(field_cap - min_len, 0) optionals of the
                        same byte class; everything else untouched)
  body-*                body-plan obligations (prove_body_plan): tables/
                        footprint reconstruction, lazy-gate implications,
                        factor necessity, DFA exactness, and the
                        torn-literal carry closure: every seam position
                        through every match literal, chunked scan with
                        carried state == contiguous scan
                        (compiler/nfa.scan_chunk_numpy)

The checkers are independent implementations: they share the
position-NFA construction with the compiler (slot alignment must be
bit-exact) but never reuse the lowering's own reasoning.

The plan's tables are tensors, on the card for a serving plan. The
checkers read them through host copies in the JAX package's dtypes
(`_host_table`) and never move them.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field as dc_field
from types import SimpleNamespace
from typing import Any

import numpy as np

from ..ops._tables import TensorTable
from . import repat
from .nfa import (NfaBank, _bank_position_nfa, _bits, _expand_scan_patterns,
                  build_bank, extract_numpy, pattern_footprint,
                  scan_chunk_numpy, scan_numpy)
from .plan import (PF_ALWAYS, PF_NEVER, RulesetPlan, STAGING_RUNGS,
                   quantize_stage_cap)
from .repat import LinearPattern, Pos, Quant

PROOF_FORMAT = 1

# Safety valve for the product reachability checks: a pathological
# pattern x factor pair could blow up the explored state count; past the
# cap the obligation records `skipped` (NOT proved — the detail says
# why) instead of stalling compilation.  No current ruleset comes close.
PRODUCT_STATE_CAP = 500_000


# ---------------------------------------------------------------------------
# proof records


@dataclass
class Obligation:
    """One discharged (or failed / skipped) proof obligation."""

    name: str
    subject: str
    status: str  # 'proved' | 'failed' | 'skipped'
    detail: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "subject": self.subject,
                "status": self.status, "detail": self.detail}


@dataclass
class PlanProof:
    """The full obligation ledger for one compiled plan."""

    fingerprint: str = ""
    obligations: list[Obligation] = dc_field(default_factory=list)
    wall_s: float = 0.0
    format: int = PROOF_FORMAT

    @property
    def ok(self) -> bool:
        return all(o.status != "failed" for o in self.obligations)

    def failures(self) -> list[Obligation]:
        return [o for o in self.obligations if o.status == "failed"]

    def counts(self) -> dict[str, int]:
        out = {"proved": 0, "failed": 0, "skipped": 0}
        for o in self.obligations:
            out[o.status] = out.get(o.status, 0) + 1
        return out

    def to_dict(self) -> dict:
        body = {
            "format": self.format,
            "fingerprint": self.fingerprint,
            "ok": self.ok,
            "obligations": [o.to_dict() for o in self.obligations],
            "wall_s": round(self.wall_s, 6),
        }
        body["digest"] = proof_digest(body)
        return body

    @classmethod
    def from_dict(cls, d: dict) -> "PlanProof":
        obs = [Obligation(**o) for o in d.get("obligations", ())]
        return cls(fingerprint=d.get("fingerprint", ""), obligations=obs,
                   wall_s=float(d.get("wall_s", 0.0)),
                   format=int(d.get("format", 0)))


def proof_digest(body: dict) -> str:
    """Tamper-evident digest over the canonical proof body (the cache
    loader re-derives it; a mismatch forces a re-prove)."""
    canon = {k: v for k, v in body.items() if k not in ("digest", "wall_s")}
    blob = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def proof_block_valid(block: Any, fingerprint: str) -> bool:
    """Is a deserialized plan_proof block a usable proof for
    `fingerprint`?  (format + fingerprint + ok + digest must all hold.)"""
    if not isinstance(block, dict):
        return False
    if block.get("format") != PROOF_FORMAT:
        return False
    if fingerprint and block.get("fingerprint") != fingerprint:
        return False
    if not block.get("ok"):
        return False
    try:
        return proof_digest(block) == block.get("digest")
    except Exception:
        return False


class ObligationError(RuntimeError):
    """A compiled plan failed a soundness obligation; the plan is
    refused (never cached, never served)."""

    def __init__(self, proof: PlanProof):
        self.proof = proof
        lines = [f"{o.name}[{o.subject}]: {o.detail}"
                 for o in proof.failures()]
        super().__init__(
            "plan refused — %d failed obligation(s):\n  %s"
            % (len(lines), "\n  ".join(lines)))


# ---------------------------------------------------------------------------
# pattern reconstruction


def bank_source_patterns(plan: RulesetPlan) -> tuple[dict, list]:
    """np_tables bank key -> per-slot source LinearPatterns.

    Plans do not store the compiled LinearPatterns; they are recovered
    by replaying the deterministic leaf -> alternatives lowering
    (compiler/lowering.nfa_leaf_patterns) in leaf order and checking
    each binding's span tiles its bank exactly.  NFA banks keep every
    alternative (never_match included — slot indices must line up);
    window banks keep the live alternatives only, mirroring the
    assembler's win_srcs."""
    from .lowering import nfa_leaf_patterns

    banks: dict[str, list] = {}
    failures: list[Obligation] = []
    for leaf_id in sorted(plan.bindings):
        b = plan.bindings[leaf_id]
        if b.kind not in ("nfa", "window"):
            continue
        alts = nfa_leaf_patterns(plan.leaves[leaf_id])
        if b.kind == "window":
            alts = [lp for lp in alts if not lp.never_match]
        slots = banks.setdefault(b.table_key, [])
        if b.span != (len(slots), len(slots) + len(alts)):
            failures.append(Obligation(
                "bank-reconstruction", b.table_key, "failed",
                f"leaf {leaf_id} span {b.span} != replayed "
                f"({len(slots)}, {len(slots) + len(alts)})"))
            slots.extend(alts)  # keep going; later slots stay aligned
        else:
            slots.extend(alts)
    return banks, failures


# ---------------------------------------------------------------------------
# obligation: prefilter necessity


def _factor_byte_masks(factor: tuple) -> list[int]:
    """fm[b] = bitmask of factor positions byte b can occupy."""
    fm = [0] * 256
    for i, cls in enumerate(factor):
        bit = 1 << i
        for byte in cls:
            fm[byte] |= bit
    return fm


def check_factor_necessity(lp: LinearPattern,
                           factor: tuple | None) -> str | None:
    """Prove `lp matches a field  =>  factor occurs in the field`.

    Explores the product of the pattern's expanded position NFA (one
    accepting run = one sequence of consumed positions) with the
    factor's shift-AND matcher: a reachable accepting event whose factor
    state never completed is a counterexample.  With factor=None the
    claim is `lp` has no accepting run at all (PF_NEVER).

    Sound because anchors/boundaries are pre-compiled into consumed
    positions by _expand_scan_patterns and the consumed word is a
    substring of the field, so a factor completed inside the run occurs
    in the field.  Returns None (proved), a counterexample description,
    or the literal "<capped>" when the product exceeded
    PRODUCT_STATE_CAP.
    """
    if factor is not None and lp.min_len == 0:
        return "pattern admits an empty match; no factor can be necessary"
    subs = _expand_scan_patterns(lp) if not lp.never_match else []
    if factor is None and lp.never_match:
        return None  # parser-proved dead; the bank check covers lowering
    fm = _factor_byte_masks(factor) if factor is not None else None
    done_bit = 1 << (len(factor) - 1) if factor is not None else 0

    for si, sub in enumerate(subs):
        positions = sub.positions
        n = len(positions)
        skippable = [p.quant in (Quant.OPT, Quant.STAR) for p in positions]
        repeat = [p.quant in (Quant.STAR, Quant.PLUS) for p in positions]

        def closure(start: int) -> tuple[int, bool]:
            mask, i = 0, start
            while i < n:
                mask |= 1 << i
                if not skippable[i]:
                    return mask, False
                i += 1
            return mask, sub.sticky

        succ, fire = [], []
        for i in range(n):
            smask, sfire = closure(i + 1)
            if repeat[i]:
                smask |= 1 << i
            succ.append(smask)
            fire.append(sfire)
        start_mask, start_fire = closure(0)
        if start_fire or (n == 0 and sub.accept):
            return (f"alternative {si} accepts with zero consumed bytes"
                    if factor is not None else
                    f"alternative {si} has a zero-byte accepting run")

        if factor is None:
            seen: set = set(_bits(start_mask))
            stack = list(seen)
            while stack:
                q = stack.pop()
                if fire[q] or q in sub.accept:
                    return f"alternative {si} has an accepting run (pos {q})"
                for q2 in _bits(succ[q]):
                    if q2 not in seen:
                        seen.add(q2)
                        stack.append(q2)
            continue

        # product BFS: (position just consumed, factor progress bits).
        # A state whose factor already completed is pruned — no
        # violation can grow out of it.  Bytes within a position's class
        # are deduped by their factor-mask behavior.
        states: set = set()
        stack2 = []
        for q in _bits(start_mask):
            for fmb in {fm[b] for b in positions[q].bytes}:
                f = 1 & fmb
                if f & done_bit:
                    continue
                if (q, f) not in states:
                    states.add((q, f))
                    stack2.append((q, f))
        while stack2:
            q, f = stack2.pop()
            if fire[q] or q in sub.accept:
                return (f"alternative {si}: accepting run reaches pos {q} "
                        f"with factor incomplete (progress {f:#x})")
            for q2 in _bits(succ[q]):
                for fmb in {fm[b] for b in positions[q2].bytes}:
                    f2 = ((f << 1) | 1) & fmb
                    if f2 & done_bit:
                        continue
                    st = (q2, f2)
                    if st not in states:
                        states.add(st)
                        stack2.append(st)
                        if len(states) > PRODUCT_STATE_CAP:
                            return "<capped>"
    return None


def _invert_slot_perm(perm: tuple) -> list[int]:
    order = [0] * len(perm)
    for p, col in enumerate(perm):
        order[col] = p
    return order


def check_prefilter(plan: RulesetPlan, banks: dict) -> list[Obligation]:
    """Discharge prefilter-necessity + prefilter-consistency for every
    bank registered in plan.prefilter.slot_codes."""
    out: list[Obligation] = []
    pf = plan.prefilter
    if pf is None or not pf.slot_codes:
        return out

    # Halo sub-banks carry the same codes as their parent bank filtered
    # through the slot permutation; necessity is proved once on the
    # parent and the sub-bank codes are checked for consistency.
    sub_parent: dict[str, tuple[str, int]] = {}
    for key, entry in plan.scan_plans.items():
        if entry.split and entry.slot_perm is not None:
            sub_parent[entry.split[0]] = (key, 0)
            sub_parent[entry.split[1]] = (key, 1)

    for key, codes in sorted(pf.slot_codes.items()):
        field = pf.bank_field.get(key, "")
        ff = pf.fields.get(field)
        if key in sub_parent:
            parent, which = sub_parent[key]
            entry = plan.scan_plans[parent]
            order = _invert_slot_perm(entry.slot_perm)
            n_short = len(pf.slot_codes.get(entry.split[0], ()))
            idx = order[:n_short] if which == 0 else order[n_short:]
            parent_codes = pf.slot_codes.get(parent, ())
            want = tuple(parent_codes[i] for i in idx)
            if tuple(codes) != want:
                out.append(Obligation(
                    "prefilter-consistency", key, "failed",
                    "sub-bank codes disagree with parent through slot_perm"))
            else:
                out.append(Obligation(
                    "prefilter-consistency", key, "proved",
                    f"{len(codes)} slot codes == parent[{parent}] via perm"))
            continue

        patterns = banks.get(key)
        if patterns is None or len(patterns) != len(codes):
            out.append(Obligation(
                "prefilter-necessity", key, "failed",
                f"bank has {len(codes)} codes but "
                f"{'no' if patterns is None else len(patterns)} "
                "reconstructed slots"))
            continue
        if ff is None:
            out.append(Obligation(
                "prefilter-consistency", key, "failed",
                f"no factor inventory for field {field!r}"))
            continue

        nfa_dead = None  # lazily built position NFA for PF_NEVER checks
        proved = capped = 0
        bad: list[str] = []
        for p, code in enumerate(codes):
            lp = patterns[p]
            if code == PF_ALWAYS:
                continue
            if code == PF_NEVER:
                if nfa_dead is None:
                    nfa_dead = _bank_position_nfa(patterns)
                nfa, slot_always, slot_empty_ok = nfa_dead
                bit = 1 << p
                live = (slot_always[p] or slot_empty_ok[p]
                        or (nfa.fire_u | nfa.fire_a) & bit
                        or any((f | e) & bit
                               for f, e in zip(nfa.fire, nfa.end)))
                if live:
                    bad.append(f"slot {p}: PF_NEVER but live in the "
                               "position NFA")
                else:
                    proved += 1
                continue
            if not 0 <= code < len(ff.factors):
                bad.append(f"slot {p}: factor code {code} out of range")
                continue
            note = check_factor_necessity(lp, ff.factors[code])
            if note == "<capped>":
                capped += 1
            elif note is not None:
                bad.append(f"slot {p} (factor {code}): {note}")
            else:
                proved += 1
        if bad:
            out.append(Obligation("prefilter-necessity", key, "failed",
                                  "; ".join(bad[:4])))
        else:
            status = "skipped" if capped else "proved"
            out.append(Obligation(
                "prefilter-necessity", key, status,
                f"{proved} gated slot(s) proved"
                + (f", {capped} capped" if capped else "")))

        # consistency: gating flag + factor mask agree with the codes.
        problems = []
        want_gated = all(c != PF_ALWAYS for c in codes)
        if bool(pf.bank_gated.get(key)) != want_gated:
            problems.append(
                f"bank_gated={pf.bank_gated.get(key)} but codes say "
                f"{want_gated}")
        mask = pf.bank_masks.get(key)
        if mask is not None:
            got = np.asarray(mask).astype(bool)
            want = np.zeros(ff.num_factors, dtype=bool)
            for c in codes:
                if c >= 0:
                    want[c] = True
            if got.shape != want.shape or not np.array_equal(got, want):
                problems.append("bank_masks disagrees with slot codes")
        out.append(Obligation(
            "prefilter-consistency", key,
            "failed" if problems else "proved",
            "; ".join(problems) if problems else
            f"gated={want_gated}, factor mask consistent"))
    return out


# ---------------------------------------------------------------------------
# obligation: DFA containment / exactness


def _host_table(table: Any) -> Any:
    """A table's static fields and its arrays as host numpy copies in
    the JAX package's dtypes (uint32 words as uint32); the table itself
    stays on its device. Anything else passes through."""
    if isinstance(table, TensorTable):
        return SimpleNamespace(**table.meta(), **table.numpy_arrays())
    return table


def _words_to_int(row: np.ndarray) -> int:
    v = 0
    for w, x in enumerate(row):
        v |= int(x) << (32 * w)
    return v


def check_dfa_containment(patterns: list, tables: Any) -> list[str]:
    """Prove the shipped DfaTables over-approximate (and, when marked
    exact, equal) the bank's position NFA.

    Walks a product fixpoint: R[d] = union bitmask of NFA positions
    co-reachable with DFA state d, driven by the SHIPPED int32
    transition table.  Because the scan algebra's fire/end extraction is
    union-linear in the position set, checking fire(R[d]) against
    step_accept[d] (and end(R[d]) against end_accept[d]) is exact for
    containment: no false alarms, no missed violations.  For
    exact-marked tables (the engine skips the NFA recheck for those) a
    second pass additionally requires every state's incoming subset mask
    to be single-valued and the accept lanes to be EQUAL.
    """
    tables = _host_table(tables)
    nfa, slot_always, slot_empty_ok = _bank_position_nfa(patterns)
    S = int(tables.num_states)
    C = int(tables.num_classes)
    trans = np.asarray(tables.trans_flat).astype(np.int64).reshape(S, C)
    byte_cls = np.asarray(tables.byte_cls).astype(np.int64)
    step_int = [_words_to_int(r) for r in np.asarray(tables.step_accept)]
    end_int = [_words_to_int(r) for r in np.asarray(tables.end_accept)]
    fails: list[str] = []

    if not np.array_equal(np.asarray(tables.slot_always).astype(bool),
                          slot_always):
        fails.append("slot_always lane disagrees with the position NFA")
    if not np.array_equal(np.asarray(tables.slot_empty_ok).astype(bool),
                          slot_empty_ok):
        fails.append("slot_empty_ok lane disagrees with the position NFA")

    if np.any(trans == 0):
        fails.append("start state 0 is a transition target")
        return fails

    col = [0] * 256
    for q, bs in enumerate(nfa.bytes):
        for b in bs:
            col[b] |= 1 << q
    union_col = [0] * C
    for b in range(256):
        union_col[int(byte_cls[b])] |= col[b]

    def cand_of(d: int, mask: int) -> int:
        if d == 0:
            return nfa.inj_u | nfa.inj_a
        c = nfa.inj_u
        for q in _bits(mask):
            c |= nfa.succ[q]
        return c

    def fire_of(d: int, mask: int) -> int:
        if d == 0:
            return nfa.fire_u | nfa.fire_a
        f = nfa.fire_u
        for q in _bits(mask):
            f |= nfa.fire[q]
        return f

    def end_of(d: int, mask: int) -> int:
        if d == 0:
            return 0
        e = 0
        for q in _bits(mask):
            e |= nfa.end[q]
        return e

    R = [0] * S
    work = {0}
    reached = {0}
    while work:
        d = work.pop()
        cand = cand_of(d, R[d])
        row = trans[d]
        for c in range(C):
            m = cand & union_col[c]
            d2 = int(row[c])
            if not 0 < d2 < S:
                fails.append(f"transition ({d},{c}) -> {d2} out of range")
                return fails
            reached.add(d2)
            if m & ~R[d2]:
                R[d2] |= m
                work.add(d2)

    for d in range(S):
        fire = fire_of(d, R[d])
        end = end_of(d, R[d])
        if fire & ~step_int[d]:
            fails.append(
                f"state {d}: NFA fire slots {fire & ~step_int[d]:#x} "
                "missing from step_accept")
        if end & ~end_int[d]:
            fails.append(
                f"state {d}: NFA end slots {end & ~end_int[d]:#x} "
                "missing from end_accept")
        if len(fails) > 8:
            return fails

    if bool(getattr(tables, "exact", False)):
        # single-valuedness: every edge's subset mask must equal the
        # target's accumulated mask, else two distinct subsets merged.
        for d in range(S):
            cand = cand_of(d, R[d])
            row = trans[d]
            for c in range(C):
                m = cand & union_col[c]
                d2 = int(row[c])
                if m != R[d2]:
                    fails.append(
                        f"exact=True but state {d2} merges distinct "
                        f"subset masks (edge {d}--{c}-->)")
                    return fails
        for d in range(S):
            if fire_of(d, R[d]) != step_int[d]:
                fails.append(
                    f"exact=True but step_accept[{d}] over-fires")
                return fails
            if end_of(d, R[d]) != end_int[d]:
                fails.append(
                    f"exact=True but end_accept[{d}] over-fires")
                return fails
    return fails


def check_plan_dfas(plan: RulesetPlan, banks: dict) -> list[Obligation]:
    """Containment/exactness for every DFA lowering the plan ships."""
    out: list[Obligation] = []
    targets: list[tuple[str, str]] = []
    for key, entry in plan.scan_plans.items():
        if entry.dfa_key:
            targets.append((key, entry.dfa_key))
    for win_key, dfa_key in getattr(plan, "win_dfa", {}).items():
        targets.append((win_key, dfa_key))
    for src_key, dfa_key in sorted(targets):
        patterns = banks.get(src_key)
        tables = plan.np_tables.get(dfa_key)
        if patterns is None or tables is None:
            out.append(Obligation(
                "dfa-containment", dfa_key, "failed",
                f"missing {'patterns' if patterns is None else 'tables'} "
                f"for {src_key}"))
            continue
        fails = check_dfa_containment(patterns, tables)
        exact = bool(getattr(tables, "exact", False))
        name = "dfa-exactness" if exact else "dfa-containment"
        if fails:
            out.append(Obligation(name, dfa_key, "failed",
                                  "; ".join(fails[:4])))
        else:
            out.append(Obligation(
                name, dfa_key, "proved",
                f"{int(tables.num_states)} states x "
                f"{int(tables.num_classes)} classes vs "
                f"{len(patterns)} slots"
                + (", subset masks single-valued" if exact else "")))
    return out


# ---------------------------------------------------------------------------
# obligation: staging caps


def check_staging(plan: RulesetPlan) -> list[Obligation]:
    """Independent recompute of the per-field dependent byte depth.

    Mirrors the staging semantics (compact staging, engine/batch.py)
    with a fresh walker — eq |pat|+1, prefix |pat|, suffix/NFA/length()
    pin to spec, host rules pin every referenced string field — and
    diffs the result against plan.staging_required / staging_caps."""
    from .lowering import (IntListPred, NBin, NfaPred, NLen, NNeg, NumCmp,
                           StrListPred, StrPred)

    specs = plan.field_specs
    required = {f: 0 for f in specs}

    def bump(f: str, depth: int) -> None:
        # raw dependent depth, NOT clamped to the spec: staging_required
        # records what the leaves ask for; only the cap quantization
        # clamps (a raw depth past the spec pins the whole field).
        if f in required:
            required[f] = max(required[f], int(depth))

    def len_fields(ir) -> list[str]:
        found, stack = [], [ir]
        while stack:
            node = stack.pop()
            if isinstance(node, NLen):
                found.append(node.field)
            elif isinstance(node, NBin):
                stack.extend((node.left, node.right))
            elif isinstance(node, NNeg):
                stack.append(node.x)
        return found

    for leaf in plan.leaves:
        if isinstance(leaf, StrPred):
            if leaf.kind == "eq":
                bump(leaf.field, len(leaf.pattern) + 1)
            elif leaf.kind == "prefix":
                bump(leaf.field, len(leaf.pattern))
            else:
                bump(leaf.field, specs.get(leaf.field, 0))
        elif isinstance(leaf, StrListPred):
            bump(leaf.field,
                 max((len(e) for e in leaf.entries), default=0) + 1)
        elif isinstance(leaf, NfaPred):
            bump(leaf.field, specs.get(leaf.field, 0))
        elif isinstance(leaf, NumCmp):
            for f in len_fields(leaf.left) + len_fields(leaf.right):
                bump(f, specs.get(f, 0))
        elif isinstance(leaf, IntListPred):
            for f in len_fields(leaf.probe):
                bump(f, specs.get(f, 0))

    from ..expr import ast as east

    for rule in plan.rules:
        if rule.host and rule.program is not None:
            for node in east.walk(rule.program.root):
                if isinstance(node, east.Member) \
                        and isinstance(node.obj, east.Ident):
                    if node.obj.name == "http_request" \
                            and node.attr in specs:
                        bump(node.attr, specs[node.attr])
                    elif node.obj.name == "client" \
                            and node.attr == "country":
                        bump("country", specs.get("country", 0))

    out: list[Obligation] = []
    stored_req = dict(getattr(plan, "staging_required", {}) or {})
    stored_caps = dict(getattr(plan, "staging_caps", {}) or {})
    diffs = [f"{f}: stored {stored_req.get(f)} != recomputed {required[f]}"
             for f in specs
             if int(stored_req.get(f, -1)) != required[f]]
    if diffs:
        out.append(Obligation("staging-caps", "required", "failed",
                              "; ".join(diffs[:6])))
    else:
        out.append(Obligation(
            "staging-caps", "required", "proved",
            f"{len(specs)} field depths match the independent walker"))

    bad = []
    for f, spec in specs.items():
        cap = int(stored_caps.get(f, -1))
        need = required[f]
        if cap < min(need, int(spec)) or cap > int(spec):
            bad.append(f"{f}: cap {cap} outside [{min(need, spec)}, {spec}]")
        elif cap != quantize_stage_cap(need, int(spec)):
            bad.append(f"{f}: cap {cap} != quantize({need}, {spec})")
        elif cap != int(spec) and cap not in STAGING_RUNGS:
            bad.append(f"{f}: cap {cap} is not a staging rung")
    out.append(Obligation(
        "staging-caps", "caps", "failed" if bad else "proved",
        "; ".join(bad[:6]) if bad else
        "every cap bounds the recomputed depth and sits on a rung"))
    return out


# ---------------------------------------------------------------------------
# obligation: footprint extension


_TABLE_FIELDS = ("byte_table", "init_anchored", "init_unanchored", "opt",
                 "rep", "carry_mask", "sticky", "accept_word", "accept_mask",
                 "slot_always", "slot_empty_ok")


def _tables_equal(a: Any, b: Any) -> str | None:
    a, b = _host_table(a), _host_table(b)
    for name in _TABLE_FIELDS:
        if not (hasattr(a, name) and hasattr(b, name)):
            continue
        x = np.asarray(getattr(a, name))
        y = np.asarray(getattr(b, name))
        if x.shape != y.shape or not np.array_equal(x, y):
            return name
    return None


def certify_extension(orig: LinearPattern, ext: LinearPattern,
                      field_cap: int) -> str | None:
    """Structural certificate that `ext` is the sound bounded rewrite of
    `orig` over inputs of length <= field_cap: every unbounded repeat is
    replaced by exactly r = max(field_cap - min_len, 0) optionals of the
    SAME byte class (PLUS keeps its one required position), everything
    else — classes, order, anchors, boundaries — is untouched.  Any run
    in a field of <= field_cap bytes spends at most r bytes in one
    repeat, so match semantics are preserved exactly."""
    r = max(int(field_cap) - orig.min_len, 0)
    for flag in ("anchor_start", "anchor_end", "anchor_end_abs",
                 "boundary_start", "boundary_end", "never_match"):
        if getattr(orig, flag) != getattr(ext, flag):
            return f"flag {flag} changed"
    out = list(ext.positions)
    j = 0
    last_i = len(orig.positions) - 1
    for i, p in enumerate(orig.positions):
        if p.quant == Quant.STAR:
            want = [Pos(bytes=p.bytes, quant=Quant.OPT)] * r
        elif p.quant == Quant.PLUS:
            one = Pos(bytes=p.bytes, quant=Quant.ONE)
            opts = [Pos(bytes=p.bytes, quant=Quant.OPT)] * r
            want = (opts + [one]) if (i == last_i and orig.boundary_end) \
                else ([one] + opts)
        else:
            want = [p]
        got = out[j:j + len(want)]
        if got != want:
            return (f"position {i} ({p.quant.name}) rewrite mismatch "
                    f"(expected {len(want)} positions with r={r})")
        j += len(want)
    if j != len(out):
        return f"{len(out) - j} trailing positions not justified"
    if repat.has_unbounded_rep(ext):
        return "rewrite still has an unbounded repeat"
    return None


def check_footprint_extension(plan: RulesetPlan,
                              banks: dict) -> list[Obligation]:
    out: list[Obligation] = []
    for key, entry in sorted(plan.scan_plans.items()):
        if not entry.extended:
            continue
        field = key[len("nfa_"):]
        field_cap = int(plan.field_specs.get(field, 2048))
        patterns = banks.get(key)
        tables = plan.np_tables.get(key)
        if patterns is None or tables is None:
            out.append(Obligation("footprint-extension", key, "failed",
                                  "missing patterns/tables"))
            continue
        cands, note = [], None
        for p, lp in enumerate(patterns):
            cand = repat.extend_footprint(lp, field_cap) \
                if repat.has_unbounded_rep(lp) else lp
            if cand is None:
                note = f"slot {p}: extension impossible yet bank extended"
                break
            if cand is not lp:
                note = certify_extension(lp, cand, field_cap)
                if note is not None:
                    note = f"slot {p}: {note}"
                    break
            cands.append(cand)
        if note is None:
            rebuilt = build_bank(cands)
            from ..ops.nfa_scan import bank_to_tables

            ref = bank_to_tables(rebuilt)
            bad = _tables_equal(tables, ref)
            if bad is not None:
                note = f"shipped tables diverge from certified rebuild " \
                       f"({bad})"
            elif not bool(getattr(tables, "halo_ok", False)):
                note = "extended bank is not halo_ok"
        out.append(Obligation(
            "footprint-extension", key,
            "failed" if note else "proved",
            note or f"{len(patterns)} slot(s) certified at cap {field_cap}"))
    return out


# ---------------------------------------------------------------------------
# obligation: body-plan carry closure


def _witness_bytes(lp: LinearPattern) -> bytes:
    return bytes(min(p.bytes) for p in lp.positions
                 if p.quant in (Quant.ONE, Quant.PLUS))


def check_carry_closure(bank: NfaBank, patterns: list) -> list[str]:
    """Torn-literal closure: for every pattern's witness payload and
    EVERY seam position, scanning chunk1 then chunk2 with the carried
    state equals one contiguous scan (compiler/nfa.scan_chunk_numpy).
    This proves the carry ALGEBRA is seam-invariant on the shipped bank;
    device/numpy agreement is covered by the differential tests."""
    fails: list[str] = []
    for p, lp in enumerate(patterns):
        if lp.never_match or not lp.positions:
            continue
        wit = _witness_bytes(lp)
        pre = b"" if (lp.anchor_start or lp.boundary_start) else b"()"
        post = b"" if (lp.anchor_end or lp.anchor_end_abs
                       or lp.boundary_end) else b"()"
        payload = pre + wit + post
        if not payload:
            continue
        L = len(payload)
        data = np.frombuffer(payload, dtype=np.uint8)[None, :].copy()
        lengths = np.array([L], dtype=np.int32)
        ref = scan_numpy(bank, data, lengths)
        plain = (not lp.anchor_end and not lp.anchor_end_abs
                 and not lp.boundary_end and not lp.boundary_start
                 and lp.min_len > 0)
        if plain and not bool(ref[0, p]):
            fails.append(f"slot {p}: witness payload does not match "
                         "contiguously (closure check not exercised)")
            continue
        for k in range(1, L):
            S = scan_chunk_numpy(bank, data[:, :k], lengths)
            S = scan_chunk_numpy(bank, data[:, k:], lengths, S, t_offset=k)
            got = extract_numpy(bank, S, lengths)
            if not np.array_equal(got, ref):
                fails.append(
                    f"slot {p}: seam at byte {k} diverges from the "
                    "contiguous scan")
                break
    return fails


# ---------------------------------------------------------------------------
# entry points


def prove_plan(plan: RulesetPlan, fingerprint: str = "") -> PlanProof:
    """Discharge every ruleset-plan obligation; never raises — callers
    decide whether a failure refuses the plan (compiler/cache.py does)."""
    t0 = time.perf_counter()
    proof = PlanProof(fingerprint=fingerprint)
    banks, failures = bank_source_patterns(plan)
    if failures:
        proof.obligations.extend(failures)
    else:
        proof.obligations.append(Obligation(
            "bank-reconstruction", "*", "proved",
            f"{len(banks)} bank(s), spans tile exactly"))
    proof.obligations.extend(check_prefilter(plan, banks))
    proof.obligations.extend(check_plan_dfas(plan, banks))
    proof.obligations.extend(check_staging(plan))
    proof.obligations.extend(check_footprint_extension(plan, banks))
    proof.wall_s = time.perf_counter() - t0
    return proof


def prove_body_plan(bplan: Any) -> PlanProof:
    """Discharge the streaming body-plan obligations (engine/bodyscan)."""
    t0 = time.perf_counter()
    proof = PlanProof(fingerprint="body")
    obs = proof.obligations

    patterns: list[LinearPattern] = []
    slot_rule_ok = True
    for rule in bplan.rules:
        if rule.kind == "literal":
            alts = [repat.literal_pattern(rule.pattern.encode("latin-1"),
                                          rule.case_insensitive)]
        else:
            pat = rule.pattern
            if rule.case_insensitive and not pat.startswith("(?i)"):
                pat = "(?i)" + pat
            alts = repat.compile_regex(pat)
        patterns.extend(alts)
    if len(patterns) != len(bplan.slot_rule):
        slot_rule_ok = False
    obs.append(Obligation(
        "body-reconstruction", "rules",
        "proved" if slot_rule_ok else "failed",
        f"{len(patterns)} slots from {len(bplan.rules)} rule(s)"
        if slot_rule_ok else
        f"replay gives {len(patterns)} slots, plan has "
        f"{len(bplan.slot_rule)}"))
    if not slot_rule_ok:
        proof.wall_s = time.perf_counter() - t0
        return proof

    bank = build_bank(patterns)
    from ..ops.nfa_scan import bank_to_tables

    bad = _tables_equal(bplan.tables, bank_to_tables(bank))
    obs.append(Obligation(
        "body-tables", "bank", "failed" if bad else "proved",
        f"shipped tables diverge from rebuild ({bad})" if bad else
        f"{bank.num_patterns} slot(s), {bank.num_words} word(s)"))

    foot = max((pattern_footprint(lp) for lp in patterns
                if not lp.never_match), default=0)
    cap_ok = (int(bplan.tail_cap) == int(bplan.tables.max_footprint)
              and int(bplan.tail_cap) >= 0
              and int(bank.max_footprint) == int(bplan.tables.max_footprint)
              and foot <= max(int(bplan.tail_cap), 0) + 31)
    obs.append(Obligation(
        "body-tail-cap", "tail_cap", "proved" if cap_ok else "failed",
        f"tail_cap {bplan.tail_cap} == bank footprint "
        f"{bank.max_footprint} >= pattern bits" if cap_ok else
        f"tail_cap {bplan.tail_cap} vs tables "
        f"{bplan.tables.max_footprint} vs recomputed {bank.max_footprint}"))

    factors = [repat.necessary_factor(lp) for lp in patterns]
    all_factored = all(f is not None for f in factors)
    if bplan.lazy_ok:
        ok = (bool(getattr(bplan.tables, "halo_ok", False))
              and bplan.pf_tables is not None and all_factored
              and 0 < int(bplan.tail_cap) <= int(bplan.window))
        obs.append(Obligation(
            "body-lazy-gate", "lazy_ok", "proved" if ok else "failed",
            "halo_ok, factors present, 0 < tail_cap <= window" if ok else
            "lazy_ok=True without its preconditions"))
        bad_factors = []
        for lp, f in zip(patterns, factors):
            if f is None:
                continue
            note = check_factor_necessity(lp, f)
            if note not in (None, "<capped>"):
                bad_factors.append(note)
        obs.append(Obligation(
            "body-factor-necessity", "pf",
            "failed" if bad_factors else "proved",
            "; ".join(bad_factors[:4]) if bad_factors else
            f"{sum(1 for f in factors if f is not None)} factor(s) proved"))
    else:
        obs.append(Obligation("body-lazy-gate", "lazy_ok", "skipped",
                              "lazy path disabled for this plan"))

    if bplan.dfa_tables is not None:
        if not bool(getattr(bplan.dfa_tables, "exact", False)):
            obs.append(Obligation(
                "body-dfa", "dfa", "failed",
                "body DFA shipped without exact=True (the streaming "
                "scanner has no NFA recheck)"))
        else:
            fails = check_dfa_containment(patterns, bplan.dfa_tables)
            obs.append(Obligation(
                "body-dfa", "dfa", "failed" if fails else "proved",
                "; ".join(fails[:4]) if fails else
                f"exact over {int(bplan.dfa_tables.num_states)} states"))

    fails = check_carry_closure(bank, patterns)
    obs.append(Obligation(
        "body-carry-closure", "seams", "failed" if fails else "proved",
        "; ".join(fails[:4]) if fails else
        "every seam through every witness equals the contiguous scan"))

    proof.wall_s = time.perf_counter() - t0
    return proof


def require(proof: PlanProof) -> PlanProof:
    """Raise ObligationError when the proof has failures."""
    if not proof.ok:
        raise ObligationError(proof)
    return proof
