"""Streaming request-body inspection.

Real CRS rules overwhelmingly target POST bodies. The native plane's
`BodyFramer` ships each request body as bounded *windows* on the ring's
body ring, and the Python listener slices a buffered body into the same
windows. This module threads per-flow NFA/DFA/prefilter carry state
across those windows, so that a payload split at ANY window boundary
matches bit for bit as the contiguous scan does. It is the counterpart
of the JAX package's `engine/bodyscan.py`, with the same names, knobs
and semantics.

Data model
----------
A *flow* is one request body, identified by its ring ticket (native
plane) or a transient id (Python listener). Windows are at most
`PINGOO_BODY_WINDOW` bytes, each tagged (flow_id, win_seq, final).
`BodyScanner.scan_windows` batches one window per flow per round
through the chunk-carry scans, which send CUDA tensors to the
hand-written kernels (csrc/) and CPU tensors to their plain versions:

  * `ops/nfa_scan.scan_chunk`: [B, W] state carry, per-row `t_offset`;
  * `ops/bitsplit_dfa.dfa_scan_chunk` + `dfa_finalize`: (state, H)
    carry, absolute-end accepts deferred to the FINAL window;
  * `ops/prefilter.prefilter_scan_chunk`: (S, H) shift-AND carry; S
    holds in-progress factor positions, so a literal straddling a
    window boundary completes exactly on the carry-in.

Carries stay per flow on the host as uint32 numpy words. They travel to
the device as int32 tensors holding the same bits (a view, never a value
cast), so a word with bit 31 set round-trips unchanged. A round brings
data back twice: the prefilter's carries with its per-row hit (which
decides lazy starts), then the scanned carries; the flows that finish in
a round read their verdict bits in one more batched call.

Lazy starts (the prefilter cascade, streamed)
---------------------------------------------
When every pattern in the bank has a necessary factor AND the bank is
`halo_ok` with `max_footprint <= tail_cap`, the NFA scan is deferred
per flow until the prefilter reports a completed factor (no factor by
position q => no match ends <= q, because a necessary factor is
contained in every match). The flow keeps the last `tail_cap` body
bytes; on its first factor hit the NFA starts from the ZERO state at
`offset - len(tail)` (per-row `t_offset`): live runs at the window head
span at most `max_footprint` bytes, all of them in the retained tail,
and an accept fired during warm-up is a real match. Flows that never
hit a factor never run the NFA and finalize to all-zero verdict bits.
DFA mode always carries from byte 0.

Verdict composition
-------------------
Body rules are conceptually APPENDED to the metadata ruleset, so the
two-lane action encoding of engine/verdict.action_lanes reproduces
here: `unverified` = first matched acting body rule's first action
(0 none / 1 block / 2 captcha), `verified_block` = any matched body
rule with Block anywhere. `merge_actions` composes a metadata verdict
byte with a body verdict under exactly those semantics.

Everything is gated behind PINGOO_BODY_INSPECT=off|on, `off` (the
default) leaving the metadata verdict as it is.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..compiler import repat
from ..compiler.nfa import build_bank, lower_bank_to_dfa
from ..device import check_env, resolve_device
from ..obs.window import WINDOW, TimingWindow
from ..ops.bitsplit_dfa import dfa_finalize, dfa_scan_chunk, dfa_to_tables
from ..ops.nfa_scan import bank_to_tables, extract_slots, scan_chunk
from ..ops.prefilter import (bank_to_prefilter_tables, build_prefilter_bank,
                             prefilter_extract, prefilter_scan_chunk)

log = logging.getLogger(__name__)

# -- knobs --------------------------------------------------------------------

ACTION_NONE = 0
ACTION_BLOCK = 1
ACTION_CAPTCHA = 2

#: Verdict-byte layout shared with the ring (pingoo_ring.h): bits 0-1
#: unverified action, bit 2 verified-block, bits 3-7 route.
_UNVERIFIED_MASK = 0x3
_VERIFIED_BLOCK_BIT = 0x4
_ROUTE_MASK = 0xF8


def body_inspect_enabled() -> bool:
    return os.environ.get("PINGOO_BODY_INSPECT", "off") == "on"


def body_window_bytes() -> int:
    return int(os.environ.get("PINGOO_BODY_WINDOW", "4096"))


def body_max_flows() -> int:
    return int(os.environ.get("PINGOO_BODY_MAX_FLOWS", "1024"))


def body_flow_ttl_ms() -> int:
    return int(os.environ.get("PINGOO_BODY_FLOW_TTL_MS", "5000"))


# -- rules --------------------------------------------------------------------


@dataclass(frozen=True)
class BodyRule:
    """One body rule: a literal or regex over the raw body bytes with a
    rule-config-style action list ("block" / "captcha")."""

    name: str
    pattern: str
    kind: str = "literal"  # literal | regex
    case_insensitive: bool = False
    actions: tuple[str, ...] = ("block",)


#: Seed ruleset: CRS-staple payload classes (SQLi / XSS / traversal /
#: RCE probes), literal patterns only, so every rule has a necessary
#: factor and the lazy prefilter cascade stays armed by default.
DEFAULT_BODY_RULES: tuple[BodyRule, ...] = (
    BodyRule("body-sqli-union", "union select", "literal", True, ("block",)),
    BodyRule("body-sqli-tautology", "' or '1'='1", "literal", True,
             ("block",)),
    BodyRule("body-xss-script", "<script", "literal", True, ("block",)),
    BodyRule("body-traversal", "../../", "literal", False, ("block",)),
    BodyRule("body-lfi-passwd", "/etc/passwd", "literal", False, ("block",)),
    BodyRule("body-suspect-eval", "eval(", "literal", True, ("captcha",)),
)


def load_body_rules() -> tuple[BodyRule, ...]:
    """PINGOO_BODY_RULES names a JSON rule file; absent -> the seed set."""
    path = os.environ.get("PINGOO_BODY_RULES")
    if not path:
        return DEFAULT_BODY_RULES
    with open(path, "rb") as f:
        raw = json.load(f)
    return tuple(BodyRule(
        name=r["name"], pattern=r["pattern"], kind=r.get("kind", "literal"),
        case_insensitive=bool(r.get("case_insensitive", False)),
        actions=tuple(r.get("actions", ["block"]))) for r in raw)


# -- compiled plan ------------------------------------------------------------


@dataclass
class BodyPlan:
    """Compiled body ruleset: one NFA bank (optionally an exact DFA
    lowering and a prefilter bank) on `device`, plus the slot -> rule
    map."""

    rules: tuple[BodyRule, ...]
    tables: object            # ops.nfa_scan.NfaTables
    slot_rule: np.ndarray     # [P] int32 rule index per pattern slot
    rule_first: np.ndarray    # [R] int32 first action (0/1/2)
    rule_has_block: np.ndarray  # [R] bool Block anywhere in actions
    dfa_tables: object = None  # ops.bitsplit_dfa.DfaTables | None (exact)
    pf_tables: object = None   # ops.prefilter.PrefilterTables | None
    lazy_ok: bool = False
    tail_cap: int = 0
    window: int = 4096
    oracle_res: tuple = ()     # [R] compiled `re` patterns (host oracle)
    device: torch.device = torch.device("cpu")


def compile_body_plan(rules: tuple[BodyRule, ...] | None = None,
                      window: int | None = None, device=None) -> BodyPlan:
    """Compile `rules` (default: `load_body_rules()`) into tables on
    `device` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    rules = tuple(rules) if rules is not None else load_body_rules()
    window = window if window is not None else body_window_bytes()
    patterns = []
    slot_rule: list[int] = []
    oracle_res = []
    for ri, rule in enumerate(rules):
        if rule.kind == "literal":
            lps = [repat.literal_pattern(
                rule.pattern.encode("latin-1"), rule.case_insensitive)]
            esc = re.escape(rule.pattern.encode("latin-1"))
            flags = re.I if rule.case_insensitive else 0
            oracle_res.append(re.compile(esc, flags | re.S))
        else:
            pat = rule.pattern
            if rule.case_insensitive and not pat.startswith("(?i)"):
                pat = "(?i)" + pat
            lps = repat.compile_regex(pat)
            # The canonical byte view of expr/values.py: latin-1,
            # unanchored search, DOTALL off as in `re` itself.
            oracle_res.append(re.compile(pat.encode("latin-1")))
        for lp in lps:
            patterns.append(lp)
            slot_rule.append(ri)
    tables = bank_to_tables(build_bank(patterns))

    dfa_tables = None
    dfa_bank = lower_bank_to_dfa(patterns)
    if dfa_bank is not None and dfa_bank.exact:
        # Approximate lowerings are excluded: their exact-NFA recheck
        # re-scans flagged rows from byte 0, which a streaming scanner
        # no longer has.
        dfa_tables = dfa_to_tables(dfa_bank).to(dev)

    pf_tables = None
    factors = [repat.necessary_factor(lp) for lp in patterns]
    all_factored = all(f is not None for f in factors)
    if all_factored and factors:
        # Factor f gates slot f.
        pf_tables = bank_to_prefilter_tables(
            build_prefilter_bank(factors)).to(dev)
    tail_cap = int(tables.max_footprint)
    lazy_ok = bool(tables.halo_ok and all_factored and pf_tables is not None
                   and 0 < tail_cap <= window)
    rule_first = np.zeros(len(rules), dtype=np.int32)
    rule_has_block = np.zeros(len(rules), dtype=bool)
    for ri, rule in enumerate(rules):
        if rule.actions:
            rule_first[ri] = (ACTION_BLOCK if rule.actions[0] == "block"
                              else ACTION_CAPTCHA)
            rule_has_block[ri] = "block" in rule.actions
    return BodyPlan(
        rules=rules, tables=tables.to(dev),
        slot_rule=np.asarray(slot_rule, dtype=np.int32),
        rule_first=rule_first, rule_has_block=rule_has_block,
        dfa_tables=dfa_tables, pf_tables=pf_tables,
        lazy_ok=lazy_ok, tail_cap=tail_cap, window=window,
        oracle_res=tuple(oracle_res), device=dev)


def body_tables_from_reference(ref_plan, device) -> BodyPlan:
    """A JAX-package `BodyPlan` (its tables, rules and slot map) -> the
    port's `BodyPlan` on `device`: the tables matched by type and field
    name (`compiler.plan.tables_from_reference`), the rules copied field
    by field."""
    from ..compiler.plan import _carry_table

    dev = resolve_device(device)

    def carry(t):
        return None if t is None else _carry_table(t).to(dev)

    return BodyPlan(
        rules=tuple(BodyRule(r.name, r.pattern, r.kind, r.case_insensitive,
                             tuple(r.actions)) for r in ref_plan.rules),
        tables=carry(ref_plan.tables),
        slot_rule=np.asarray(ref_plan.slot_rule, dtype=np.int32),
        rule_first=np.asarray(ref_plan.rule_first, dtype=np.int32),
        rule_has_block=np.asarray(ref_plan.rule_has_block, dtype=bool),
        dfa_tables=carry(ref_plan.dfa_tables),
        pf_tables=carry(ref_plan.pf_tables),
        lazy_ok=bool(ref_plan.lazy_ok), tail_cap=int(ref_plan.tail_cap),
        window=int(ref_plan.window), oracle_res=tuple(ref_plan.oracle_res),
        device=dev)


def resolve_scan_mode(plan: BodyPlan) -> str:
    """PINGOO_BODY_SCAN=auto|nfa|dfa -> the mode that will actually run
    (auto prefers the exact DFA lowering when it exists)."""
    mode = os.environ.get("PINGOO_BODY_SCAN", "auto")
    if mode == "dfa" and plan.dfa_tables is None:
        log.warning("PINGOO_BODY_SCAN=dfa but no exact lowering; using nfa")
        mode = "nfa"
    if mode == "auto":
        mode = "dfa" if plan.dfa_tables is not None else "nfa"
    return mode


# -- host oracle --------------------------------------------------------------


def body_lanes_oracle(plan: BodyPlan,
                      payload: bytes) -> tuple[int, bool, tuple[str, ...]]:
    """Interpreter oracle over the CONTIGUOUS payload: Python `re` on
    the raw bytes, folded through the two-lane action loop. Returns
    (unverified, verified_block, matched rule names)."""
    matched = [bool(cre.search(payload)) for cre in plan.oracle_res]
    unverified = ACTION_NONE
    for ri, hit in enumerate(matched):
        if hit and plan.rule_first[ri] != 0:
            unverified = int(plan.rule_first[ri])
            break
    verified_block = any(
        hit and plan.rule_has_block[ri] for ri, hit in enumerate(matched))
    names = tuple(plan.rules[ri].name for ri, hit in enumerate(matched)
                  if hit)
    return unverified, verified_block, names


def merge_actions(meta_action: int, body_unverified: int,
                  body_verified_block: bool) -> int:
    """Compose a metadata verdict byte with a body verdict under the
    rules-appended semantics: metadata rules run first, so its nonzero
    unverified lane wins the first-action race; verified-block is an
    any-rule OR; route bits ride the metadata verdict unchanged."""
    meta_unverified = meta_action & _UNVERIFIED_MASK
    unverified = meta_unverified if meta_unverified else (
        body_unverified & _UNVERIFIED_MASK)
    verified = (meta_action & _VERIFIED_BLOCK_BIT) or (
        _VERIFIED_BLOCK_BIT if body_verified_block else 0)
    return (meta_action & _ROUTE_MASK) | verified | unverified


def split_payload(payload: bytes, window: int) -> list[bytes]:
    """Slice a buffered payload into scan windows (the same windows the
    native plane ships)."""
    if not payload:
        return [b""]
    return [payload[i:i + window] for i in range(0, len(payload), window)]


# -- flow table ---------------------------------------------------------------


@dataclass
class FlowState:
    """Per-flow carry between windows: uint32 words on the host, sent to
    the plan's device for each round's batched scan."""

    flow_id: int
    offset: int = 0            # body bytes consumed so far
    next_seq: int = 0          # expected win_seq
    started: bool = True       # NFA/DFA carry live (False = lazy idle)
    nfa_state: Optional[np.ndarray] = None   # [W] uint32
    dfa_state: int = 0
    dfa_h: Optional[np.ndarray] = None       # [Wh] uint32
    pf_s: Optional[np.ndarray] = None        # [Wp] uint32
    pf_h: Optional[np.ndarray] = None        # [Wp] uint32
    tail: bytes = b""          # last tail_cap bytes (lazy warm-up)
    last_touch_ms: int = 0
    degraded: bool = False     # evicted / out-of-order -> metadata-only


@dataclass
class BodyWindow:
    """One ring body slot, de-framed payload bytes only."""

    flow_id: int
    win_seq: int
    data: bytes
    final: bool = False
    abort: bool = False


@dataclass
class BodyVerdict:
    flow_id: int
    unverified: int = ACTION_NONE
    verified_block: bool = False
    matched: tuple[str, ...] = ()
    degraded: bool = False

    def action_byte(self) -> int:
        return ((self.unverified & _UNVERIFIED_MASK)
                | (_VERIFIED_BLOCK_BIT if self.verified_block else 0))


@dataclass
class BodyStats:
    windows_total: int = 0
    bytes_total: int = 0
    flows_started: int = 0
    flows_finished: int = 0
    degrade_total: int = 0      # flows degraded to metadata-only
    lazy_skips: int = 0         # window batches that skipped the NFA/DFA
    carry_depth: int = 0        # max windows carried by any live flow
    # degrade_total split by reason: evict | ttl | gap.
    degrade_reasons: dict = field(default_factory=dict)


class BodyScanner:
    """Per-flow streaming matcher on the plan's device. NOT thread-safe;
    each plane owns one (the sidecar drain loop, the Python listener's
    event loop).

    `device=None` means the CUDA card and raises without one; a plan
    given must live on that device. A scan error propagates.

    `stage_ms` keeps, for each stage, a `TimingWindow` of the last
    STAGE_ROUNDS rounds (plus their exact count and sum): the ms a round
    spent packing windows and carries (and sending them to the
    device), in the prefilter pass and in the NFA/DFA pass (each up to
    its carries back on the host), and finishing flows."""

    STAGE_ROUNDS = WINDOW

    def __init__(self, plan: Optional[BodyPlan] = None,
                 max_flows: Optional[int] = None,
                 mode: Optional[str] = None,
                 flow_ttl_ms: Optional[int] = None,
                 now_ms: Optional[Callable[[], int]] = None,
                 device=None):
        dev = resolve_device(device)
        check_env()
        self.plan = plan if plan is not None else compile_body_plan(
            device=dev)
        if self.plan.device.type != dev.type:
            raise ValueError(f"body plan tables live on {self.plan.device}, "
                             f"the scanner was asked to run on {dev}")
        self.mode = mode if mode is not None else resolve_scan_mode(self.plan)
        self.max_flows = max_flows if max_flows is not None \
            else body_max_flows()
        self.flow_ttl_ms = flow_ttl_ms if flow_ttl_ms is not None \
            else body_flow_ttl_ms()
        self.lazy = self.plan.lazy_ok and self.mode == "nfa" \
            and os.environ.get("PINGOO_BODY_LAZY", "auto") != "off"
        self.flows: dict[int, FlowState] = {}
        self.stats = BodyStats()
        if now_ms is None:
            now_ms = lambda: int(time.monotonic() * 1000)  # noqa: E731
        self._now_ms = now_ms
        self.stage_ms = {k: TimingWindow(self.STAGE_ROUNDS)
                         for k in ("pack", "prefilter", "scan", "finish")}
        self._carry_hist = None  # set by attach_metrics
        self._collector = None
        self._registry = None

    # -- observability (obs/schema.py BODY_METRICS) ---------------------------

    def attach_metrics(self, plane: str, registry=None) -> None:
        """Export this scanner's BODY_METRICS under {plane=}, as the JAX
        package's scanner does: the counters and the flows gauge are
        read from `stats` by a registry collector at scrape time (no
        cost per window); the carry-depth histogram observes each
        finished flow."""
        if registry is None:
            from ..obs.registry import REGISTRY as registry  # noqa: N813
        from ..obs.schema import BODY_METRICS

        windows = registry.counter(
            "pingoo_body_windows_total",
            BODY_METRICS["pingoo_body_windows_total"],
            labels={"plane": plane})
        nbytes = registry.counter(
            "pingoo_body_bytes_total", BODY_METRICS["pingoo_body_bytes_total"],
            labels={"plane": plane})
        flows = registry.gauge(
            "pingoo_body_flows_active",
            BODY_METRICS["pingoo_body_flows_active"],
            labels={"plane": plane})
        self._carry_hist = registry.histogram(
            "pingoo_body_carry_depth", BODY_METRICS["pingoo_body_carry_depth"],
            buckets=(1, 2, 4, 8, 16, 64, 256), labels={"plane": plane})

        def _collect():
            windows.set_total(self.stats.windows_total)
            nbytes.set_total(self.stats.bytes_total)
            flows.set(self.flows_active)
            for reason, n in self.stats.degrade_reasons.items():
                registry.counter(
                    "pingoo_body_degrade_total",
                    BODY_METRICS["pingoo_body_degrade_total"],
                    labels={"plane": plane, "reason": reason},
                ).set_total(n)

        registry.register_collector(_collect)
        self._collector = _collect
        self._registry = registry

    def detach_metrics(self) -> None:
        if self._registry is not None and self._collector is not None:
            self._registry.unregister_collector(self._collector)
        self._collector = self._registry = None

    # -- flow lifecycle -------------------------------------------------------

    def _admit(self, flow_id: int) -> FlowState:
        fs = self.flows.get(flow_id)
        if fs is not None:
            return fs
        if len(self.flows) >= self.max_flows:
            # Table full: evict the stalest flow to metadata-only so the
            # NEW flow gets inspected (fresh traffic outranks stragglers).
            victim = min(self.flows.values(), key=lambda f: f.last_touch_ms)
            self._degrade(victim, "evict")
            del self.flows[victim.flow_id]
        fs = FlowState(flow_id=flow_id, started=not self.lazy,
                       last_touch_ms=self._now_ms())
        self.flows[flow_id] = fs
        self.stats.flows_started += 1
        return fs

    def _degrade(self, fs: FlowState, reason: str = "gap") -> None:
        if not fs.degraded:
            fs.degraded = True
            self.stats.degrade_total += 1
            self.stats.degrade_reasons[reason] = \
                self.stats.degrade_reasons.get(reason, 0) + 1

    def evict_stale(self) -> int:
        """Drop flows idle past the TTL (client stalled mid-body); the
        data plane fails them open when the verdict never arrives."""
        now = self._now_ms()
        dead = [fid for fid, fs in self.flows.items()
                if now - fs.last_touch_ms > self.flow_ttl_ms]
        for fid in dead:
            self._degrade(self.flows[fid], "ttl")
            del self.flows[fid]
        return len(dead)

    def abort_flow(self, flow_id: int) -> None:
        self.flows.pop(flow_id, None)

    @property
    def flows_active(self) -> int:
        return len(self.flows)

    # -- batched window scan --------------------------------------------------

    def scan_windows(self, windows: list[BodyWindow]) -> list[BodyVerdict]:
        """Advance every flow by its pending windows (batched one window
        per flow per round, in win_seq order) and return a BodyVerdict
        for each flow whose FINAL window was seen. Oversized windows are
        re-sliced here; the carry makes sub-window boundaries invisible
        to the match."""
        now = self._now_ms()
        pending: dict[int, list[tuple[FlowState, bytes, bool]]] = {}
        for w in sorted(windows, key=lambda w: (w.flow_id, w.win_seq)):
            fs = self._admit(w.flow_id)
            fs.last_touch_ms = now
            if w.abort:
                self.abort_flow(w.flow_id)
                pending.pop(w.flow_id, None)
                continue
            if w.win_seq != fs.next_seq:
                # Ring order is per-flow FIFO by construction; a gap
                # means slots were dropped: fail the flow open.
                log.warning("body flow %d: window gap (want %d got %d)",
                            w.flow_id, fs.next_seq, w.win_seq)
                self._degrade(fs, "gap")
            fs.next_seq = w.win_seq + 1
            self.stats.windows_total += 1
            pieces = (split_payload(w.data, self.plan.window)
                      if len(w.data) > self.plan.window else [w.data])
            for j, piece in enumerate(pieces):
                pending.setdefault(w.flow_id, []).append(
                    (fs, piece, w.final and j == len(pieces) - 1))
        verdicts: list[BodyVerdict] = []
        while pending:
            round_ws = []
            for fid in list(pending):
                round_ws.append(pending[fid].pop(0))
                if not pending[fid]:
                    del pending[fid]
            verdicts.extend(self._scan_round(round_ws))
        return verdicts

    def scan_buffered(self, payload: bytes,
                      flow_id: int = -1) -> BodyVerdict:
        """Python-listener path: slice an already-buffered body into the
        SAME windows the native plane ships and run them through the
        same chunk-carry scan."""
        chunks = split_payload(payload, self.plan.window)
        out: list[BodyVerdict] = []
        for i, chunk in enumerate(chunks):
            out = self.scan_windows([BodyWindow(
                flow_id=flow_id, win_seq=i, data=chunk,
                final=(i == len(chunks) - 1))])
        assert out, "final window must produce a verdict"
        return out[0]

    # -- internals ------------------------------------------------------------

    def _scan_round(self, ws: list) -> list[BodyVerdict]:
        """One batched round: at most one (flow, piece, final) each."""
        plan = self.plan
        dev = plan.device
        clock = time.monotonic
        t0 = clock()
        pack = pf_ms = scan_ms = 0.0
        live: list[tuple[FlowState, bytes, bool]] = []
        verdicts: list[BodyVerdict] = []
        for fs, piece, final in ws:
            if fs.degraded:
                fs.offset += len(piece)
                if final:
                    verdicts.extend(self._finish([fs], degraded=True))
                continue
            live.append((fs, piece, final))
            self.stats.bytes_total += len(piece)

        scan_rows = [(fs, piece) for fs, piece, _ in live if len(piece) > 0]
        if scan_rows:
            n = len(scan_rows)
            depth = max(fs.next_seq for fs, _ in scan_rows)
            self.stats.carry_depth = max(self.stats.carry_depth, depth)
            # Fixed row width, rows padded to a power of two: the padded
            # rows have length 0 and leave their carry as it is.
            width = plan.tail_cap + plan.window if self.lazy else plan.window
            npad = _pow2(n)
            data = np.zeros((npad, width), dtype=np.uint8)
            t_off = np.zeros(npad, dtype=np.int32)
            lens = np.zeros(npad, dtype=np.int32)
            inputs = None  # (data, lens, t_off) on the device

            hit_any = None
            if plan.pf_tables is not None:
                # Pass A: prefilter carry over the window bytes only.
                wp = plan.pf_tables.num_words
                for i, (fs, piece) in enumerate(scan_rows):
                    if fs.pf_s is None:
                        fs.pf_s = np.zeros(wp, dtype=np.uint32)
                        fs.pf_h = np.zeros(wp, dtype=np.uint32)
                    data[i, :len(piece)] = np.frombuffer(piece, np.uint8)
                    t_off[i] = fs.offset
                    lens[i] = fs.offset + len(piece)
                inputs = _on(dev, data, lens, t_off)
                S = _stack([fs.pf_s for fs, _ in scan_rows], npad)
                Hp = _stack([fs.pf_h for fs, _ in scan_rows], npad)
                S, Hp = _on(dev, S, Hp)
                t1 = clock()
                S, Hp = prefilter_scan_chunk(plan.pf_tables, *inputs[:2], S,
                                             Hp, inputs[2])
                hit = prefilter_extract(plan.pf_tables, Hp).any(dim=1)
                S, Hp, hit_any = _to_host(S, Hp, hit)
                hit_any = hit_any.astype(bool)
                for i, (fs, piece) in enumerate(scan_rows):
                    fs.pf_s, fs.pf_h = S[i].copy(), Hp[i].copy()
                pack, pf_ms, t0 = t1 - t0, clock() - t1, clock()

            starting: set[int] = set()
            if self.lazy:
                for i, (fs, piece) in enumerate(scan_rows):
                    if not fs.started and hit_any[i]:
                        starting.add(i)

            active = [(i, fs, piece) for i, (fs, piece) in
                      enumerate(scan_rows) if fs.started or i in starting]
            if active:
                # Without lazy starts every row is active and pass A's
                # rows are this pass's rows: they are on the device.
                if self.lazy or inputs is None:
                    data[:] = 0
                    for i, fs, piece in active:
                        pay = np.frombuffer(piece, np.uint8)
                        if i in starting:
                            # Lazy warm-up: a zero-state scan over the
                            # retained tail reproduces the true carry.
                            tail = np.frombuffer(fs.tail, np.uint8)
                            data[i, :len(tail)] = tail
                            data[i, len(tail):len(tail) + len(pay)] = pay
                            t_off[i] = fs.offset - len(tail)
                        else:
                            data[i, :len(pay)] = pay
                            t_off[i] = fs.offset
                        lens[i] = fs.offset + len(pay)
                    inputs = _on(dev, data, lens, t_off)
                rows = [i for i, _, _ in active]
                if self.mode == "dfa":
                    st = np.zeros(npad, dtype=np.int32)
                    for i, fs, _ in active:
                        st[i] = fs.dfa_state
                    Hd = _stack([_dfa_h(fs, plan) for _, fs, _ in active],
                                npad, rows=rows)
                    st, Hd = _on(dev, st, Hd)
                    t1 = clock()
                    st, Hd = _to_host(*dfa_scan_chunk(
                        plan.dfa_tables, *inputs[:2], st, Hd, inputs[2]))
                    for i, fs, piece in active:
                        fs.started = True
                        fs.dfa_state, fs.dfa_h = int(st[i]), Hd[i].copy()
                else:
                    W = plan.tables.num_words
                    for _, fs, _ in active:
                        if fs.nfa_state is None:
                            fs.nfa_state = np.zeros(W, dtype=np.uint32)
                    stv = _on(dev, _stack([fs.nfa_state for _, fs, _ in
                                           active], npad, rows=rows))
                    t1 = clock()
                    (stv,) = _to_host(scan_chunk(plan.tables, *inputs[:2],
                                                 stv, inputs[2]))
                    for i, fs, piece in active:
                        fs.started = True
                        fs.nfa_state = stv[i].copy()
                pack += t1 - t0
                scan_ms, t0 = clock() - t1, clock()
            else:
                self.stats.lazy_skips += 1

        finals = []
        for fs, piece, final in live:
            fs.offset += len(piece)
            if self.lazy and not fs.started and plan.tail_cap > 0:
                fs.tail = (fs.tail + piece)[-plan.tail_cap:]
            if final:
                finals.append(fs)
        verdicts.extend(self._finish(finals))
        for key, ms in (("pack", pack), ("prefilter", pf_ms),
                        ("scan", scan_ms), ("finish", clock() - t0)):
            self.stage_ms[key].append(ms * 1e3)
        return verdicts

    def _finish(self, flows: list[FlowState],
                degraded: bool = False) -> list[BodyVerdict]:
        """Verdicts of finished flows, in order. The flows whose final
        state must be read go through one batched call on the device."""
        plan = self.plan
        out: list[Optional[BodyVerdict]] = []
        read: list[int] = []
        for j, fs in enumerate(flows):
            self.flows.pop(fs.flow_id, None)
            self.stats.flows_finished += 1
            if self._carry_hist is not None:
                self._carry_hist.observe(float(max(1, fs.next_seq)))
            if degraded or fs.degraded:
                out.append(BodyVerdict(fs.flow_id, degraded=True))
            elif not fs.started:
                # Lazy flow with no completed factor: no match, by the
                # necessary-factor argument (and no empty/always lanes:
                # lazy_ok requires every pattern to carry a factor).
                out.append(self._lanes(fs.flow_id, np.zeros(
                    plan.slot_rule.shape[0], dtype=bool)))
            else:
                out.append(None)
                read.append(j)
        if read:
            hits = self._final_hits([flows[j] for j in read])
            for j, h in zip(read, hits):
                out[j] = self._lanes(flows[j].flow_id, h)
        return out

    def _final_hits(self, flows: list[FlowState]) -> np.ndarray:
        """[n, P] slot hits of flows at their end (absolute-end accepts
        applied), from their carries."""
        plan = self.plan
        dev = plan.device
        lens = _on(dev, np.array([fs.offset for fs in flows], np.int32))
        if self.mode == "dfa":
            st = np.array([fs.dfa_state for fs in flows], dtype=np.int32)
            H = np.stack([_dfa_h(fs, plan) for fs in flows])
            hits = dfa_finalize(plan.dfa_tables, _on(dev, st), _on(dev, H),
                                lens)
        else:
            # An empty body was never scanned: the zero state.
            zero = np.zeros(plan.tables.num_words, dtype=np.uint32)
            st = np.stack([zero if fs.nfa_state is None else fs.nfa_state
                           for fs in flows])
            hits = extract_slots(plan.tables, _on(dev, st), lens)
        return hits.cpu().numpy()

    def _lanes(self, flow_id: int, slot_hits: np.ndarray) -> BodyVerdict:
        plan = self.plan
        R = plan.rule_first.shape[0]
        rule_hit = np.zeros(R, dtype=bool)
        np.logical_or.at(rule_hit, plan.slot_rule, slot_hits)
        unverified = ACTION_NONE
        for ri in range(R):
            if rule_hit[ri] and plan.rule_first[ri] != 0:
                unverified = int(plan.rule_first[ri])
                break
        verified_block = bool((rule_hit & plan.rule_has_block).any())
        names = tuple(plan.rules[ri].name for ri in range(R)
                      if rule_hit[ri])
        return BodyVerdict(flow_id, unverified, verified_block, names)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _stack(vecs: list[np.ndarray], npad: int,
           rows=None) -> np.ndarray:
    """Scatter per-flow carry vectors into a padded [npad, w] batch."""
    out = np.zeros((npad, vecs[0].shape[0]), dtype=vecs[0].dtype)
    if rows is None:
        rows = range(len(vecs))
    for j, i in enumerate(rows):
        out[i] = vecs[j]
    return out


def _dfa_h(fs: FlowState, plan: BodyPlan) -> np.ndarray:
    if fs.dfa_h is None:
        fs.dfa_h = np.zeros(plan.dfa_tables.num_words, dtype=np.uint32)
    return fs.dfa_h


def _on(dev: torch.device, *arrays: np.ndarray):
    """Host arrays -> tensors on `dev`; uint32 words go as int32 tensors
    holding the same bits (a view, not a value cast)."""
    out = tuple(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(dev)
        for a in arrays)
    return out if len(out) > 1 else out[0]


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Device tensors of [B] or [B, w] int32/bool -> numpy, through one
    device-to-host copy (the one sync). [B, w] carries come back as
    uint32 words, [B] ones in their own dtype."""
    cols = [t.reshape(t.shape[0], -1).to(torch.int32) for t in tensors]
    host = torch.cat(cols, dim=1).cpu().numpy() if len(cols) > 1 \
        else cols[0].cpu().numpy()
    out, at = [], 0
    for t, c in zip(tensors, cols):
        part = host[:, at:at + c.shape[1]]
        at += c.shape[1]
        if t.dim() == 1:
            out.append(part[:, 0].astype(np.int32 if t.dtype == torch.int32
                                         else np.uint8))
        else:
            out.append(np.ascontiguousarray(part).view(np.uint32))
    return out
