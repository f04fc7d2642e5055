"""Ruleset plan: table assembly for the batched verdict.

`compile_ruleset` takes validated rules (config/schema.py RuleConfig)
plus loaded lists and produces a `RulesetPlan`:

  * every device-lowerable rule becomes a BoolIR over deduplicated leaf
    predicates (compiler/lowering.py);
  * leaves are grouped into per-field pattern tables (ops/match_ops.py),
    per-field NFA banks and their bitsplit-DFA lowerings, window banks,
    the Stage-A literal prefilter, and CIDR/int membership tables;
  * rules outside the subset keep their compiled Program and are
    interpreted on the host over the same truncated request view;
  * `derive_staging_caps` records, per field, how deep the scanners
    read, which compact staging stages (engine/batch.py).

The tables, the scan-plan records and the prefilter metadata are the
JAX package's, key for key and field for field; here every table is a
dataclass of tensors placed on the plan's device. `tables_from_reference`
carries a JAX-package plan's tables across (by field name, without
importing that package), so both can compute on identical tables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dc_field, replace as dc_replace
from typing import Any, Optional

import numpy as np
import torch

from ..config.schema import Action, RuleConfig
from ..device import check_env, resolve_device
from ..expr import Program
from ..expr import ast as expr_ast
from ..expr.values import Ip
from ..ops import bitsplit_dfa, cidr, match_ops, nfa_scan, prefilter, \
    window_match
from ..ops._tables import U32_WIDE, TensorTable, arr
from ..ops.bitsplit_dfa import dfa_to_tables
from ..ops.cidr import (build_cidr_table, build_int_set, build_v4_buckets,
                        prefix_masks)
from ..ops.match_ops import build_pattern_table, build_suffix_table
from ..ops.nfa_scan import bank_to_tables
from ..ops.prefilter import bank_to_prefilter_tables, build_prefilter_bank
from ..ops.window_match import build_window_table
from . import repat
from .lowering import (
    DEFAULT_FIELD_SPECS,
    IntListPred,
    IpListPred,
    IpPred,
    LeafRegistry,
    Lowerer,
    LowerError,
    NBin,
    NfaPred,
    NLen,
    NNeg,
    NumCmp,
    StrListPred,
    StrPred,
    nfa_leaf_patterns,
)
from .nfa import build_bank

# -- scan strategy records ----------------------------------------------------
#
# The JAX package selects, per bank, a scan strategy from a per-iteration
# cost model; the record rides the plan, and `reselect_scan_strategies`
# re-selects from measured costs. The port keeps the same records (and so
# the same decisions). On a CUDA tensor every NFA bank runs the one CUDA
# kernel whatever the kind says; the pair flag picks its stepping (and
# the halo rule's base iterations), and `dfa_auto` whether PINGOO_DFA=auto
# runs the lowered DFA. Every route is exact: the choices change no bits.
# The kind "pallas" names the fused-kernel strategy, always available
# here.

# Relative cost of one scan-loop iteration per strategy kind: the JAX
# package's placeholders, replaced by measured values through
# `reselect_scan_strategies`.
DEFAULT_STEP_COSTS = {
    "scan": 1.0,
    "pair": 1.3,
    "pallas": 0.25,
    "pallas_pair": 0.35,
    "dfa": 0.15,
}

DFA_KIND = "dfa"


def _kind_cost(c: dict, kind: str, default: float = 1.0) -> float:
    """The cost of `kind` in a (possibly partial) cost dict, else its
    DEFAULT_STEP_COSTS entry, else `default`."""
    v = c.get(kind)
    if v is None:
        v = DEFAULT_STEP_COSTS.get(kind, default)
    return float(v)


@dataclass(frozen=True)
class ScanStrategy:
    """One bank's scan strategy record: kind ("scan" or "pallas"), pair
    stepping, the halo split factor to attempt (halo_k), where the
    choice came from ("default", "measured" or "env"), and its modelled
    per-iteration cost."""

    kind: str = "scan"
    pair: bool = False
    halo_k: int = 1
    source: str = "default"
    cost: float = 0.0


@dataclass(frozen=True)
class NfaScanPlan:
    """Plan-time decisions for one field's NFA bank. `dfa_key` names the
    bank's bitsplit-DFA tables when it lowered within the state budget;
    `dfa_auto` records whether the cost model prefers the DFA (what
    PINGOO_DFA=auto follows).

    Under PINGOO_NFA_SPLIT=1 a bank that is not halo-compatible may be
    partitioned: `split` names the two sub-bank keys ("<key>@short",
    halo-splittable, and "<key>@rest", the residual) and `slot_perm[p]`
    is the column of logical slot p in concat(short_hits, rest_hits);
    the whole-bank table stays at `key`."""

    key: str
    strategy: ScanStrategy
    split: tuple[str, str] | None = None
    short_strategy: ScanStrategy | None = None
    rest_strategy: ScanStrategy | None = None
    slot_perm: tuple[int, ...] | None = None
    extended: bool = False
    dfa_key: str | None = None
    dfa_strategy: ScanStrategy | None = None
    dfa_auto: bool = False


def select_scan_strategy(tables, costs: dict | None = None,
                         source: str = "default") -> ScanStrategy:
    """Cheapest (kind, pair) under a per-iteration cost model; pair
    variants count half the iterations. The fused-kernel kinds are
    always available here (the port always has its kernel)."""
    c = dict(costs or {})
    cands = [("scan", False, _kind_cost(c, "scan")),
             ("scan", True, _kind_cost(c, "pair") / 2),
             ("pallas", False, _kind_cost(c, "pallas")),
             ("pallas", True, _kind_cost(c, "pallas_pair") / 2)]
    kind, pair, cost = min(cands, key=lambda x: x[2])
    return ScanStrategy(kind=kind, pair=pair,
                        halo_k=8 if tables.halo_ok else 1, source=source,
                        cost=cost)


def select_dfa_strategy(costs: dict | None = None,
                        source: str = "default") -> ScanStrategy:
    """The record of a lowered bank's DFA route (one byte per iteration,
    no pair variant)."""
    return ScanStrategy(kind=DFA_KIND, pair=False, halo_k=1, source=source,
                        cost=_kind_cost(costs or {}, DFA_KIND))


def reselect_scan_strategies(plan: "RulesetPlan",
                             costs: dict | None = None,
                             source: str = "measured") -> None:
    """Re-run the selection of every bank's records with `costs` (the
    measured per-iteration costs) and update the plan in place, `dfa_auto`
    re-ranked against the new non-DFA best. Persist the result with
    compiler.cache.update_cached_plan."""
    for key, entry in list(plan.scan_plans.items()):
        strategy = select_scan_strategy(
            plan.np_tables[key], costs, source=source)
        kwargs = {"strategy": strategy}
        if entry.split:
            kwargs["short_strategy"] = select_scan_strategy(
                plan.np_tables[entry.split[0]], costs, source=source)
            kwargs["rest_strategy"] = select_scan_strategy(
                plan.np_tables[entry.split[1]], costs, source=source)
        if entry.dfa_key is not None:
            dfa_strategy = select_dfa_strategy(costs, source=source)
            kwargs["dfa_strategy"] = dfa_strategy
            kwargs["dfa_auto"] = dfa_strategy.cost < strategy.cost
        plan.scan_plans[key] = dc_replace(entry, **kwargs)


def _dfa_lower_enabled() -> bool:
    """PINGOO_DFA_LOWER=0: build no DFA tables at all."""
    return os.environ.get("PINGOO_DFA_LOWER", "1") != "0"


def _halo_fp_budget() -> int:
    """PINGOO_HALO_FP_BUDGET: the largest footprint a pattern of a
    partition's @short sub-bank may have (default 16)."""
    return int(os.environ.get("PINGOO_HALO_FP_BUDGET", "16"))


def _split_enabled() -> bool:
    """PINGOO_NFA_SPLIT: partition banks that are not halo-compatible
    into @short/@rest sub-banks (off unless set to other than 0)."""
    return os.environ.get("PINGOO_NFA_SPLIT", "0") != "0"


def split_config_token() -> str:
    """The plan-shaping knobs, hashed into the artifact cache's
    fingerprint (compiler/cache.py): plans built under other split or
    DFA-lowering settings have other tables."""
    from .nfa import _dfa_merge_depths, _dfa_state_budget

    dfa = (f"dfa={int(_dfa_lower_enabled())}"
           f":s={_dfa_state_budget(None)}"
           f":m={','.join(str(d) for d in _dfa_merge_depths(None))}")
    return f"nfa_split={int(_split_enabled())}:fp={_halo_fp_budget()}:{dfa}"


def _halo_partition(patterns, field_len: int):
    """Footprint extension and partition of one field's patterns, as in
    the JAX package: a pattern that is rep-free, or bounds under
    repat.extend_footprint (exact over the field's byte cap), with a
    footprint within the halo budget joins the `short` set in its bounded
    form; the rest keep their original form. Returns (short_idx,
    rest_idx, short_pats, rest_pats), or None when either set is empty."""
    from .nfa import MAX_SCAN_BITS, pattern_footprint, scan_bits_needed

    budget = _halo_fp_budget()
    short_idx, rest_idx = [], []
    short_pats, rest_pats = [], []
    for i, lp in enumerate(patterns):
        cand = lp
        if repat.has_unbounded_rep(lp):
            cand = repat.extend_footprint(lp, field_len)
        ok = cand is not None and not repat.has_unbounded_rep(cand)
        if ok:
            try:
                ok = (pattern_footprint(cand) <= budget
                      and scan_bits_needed(cand) <= MAX_SCAN_BITS)
            except repat.Unsupported:
                ok = False
        if ok:
            short_idx.append(i)
            short_pats.append(cand)
        else:
            rest_idx.append(i)
            rest_pats.append(lp)
    if not short_idx or not rest_idx:
        return None
    return short_idx, rest_idx, short_pats, rest_pats


# -- literal-prefilter cascade (Stage A metadata) -----------------------------

PF_ALWAYS = -1  # slot has no extractable factor: its bank always scans
PF_NEVER = -2  # slot never matches: contributes nothing to candidates


@dataclass
class FieldFactors:
    """One byte field's deduplicated factor inventory."""

    field: str
    table_key: str  # np_tables key of the PrefilterTables ("pf_<field>")
    num_factors: int
    factors: tuple[tuple[frozenset, ...], ...]


@dataclass
class PrefilterPlan:
    """Static Stage-A metadata: per field its factor table; per bank its
    field, factor mask, whether every slot is factor-gated, and the
    per-slot factor codes."""

    fields: dict[str, FieldFactors] = dc_field(default_factory=dict)
    bank_field: dict[str, str] = dc_field(default_factory=dict)
    bank_masks: dict[str, Any] = dc_field(default_factory=dict)
    bank_gated: dict[str, bool] = dc_field(default_factory=dict)
    slot_codes: dict[str, tuple] = dc_field(default_factory=dict)
    default_mode: str = "banks"


def _plan_field_prefilter(plan: "RulesetPlan", field: str,
                          bank_slots: dict[str, list],
                          split_idx=None) -> None:
    """Extract + pack one field's factors; register per-bank masks, and
    with `split_idx` those of the NFA bank's @short/@rest sub-banks (the
    subsets of its slot codes), so that Stage B gates each on its own."""
    pf = plan.prefilter
    if pf is None or not bank_slots:
        return
    factors: list = []
    index: dict = {}

    def code_of(lp) -> int:
        if lp.never_match:
            return PF_NEVER
        fac = repat.necessary_factor(lp)
        if fac is None:
            return PF_ALWAYS
        idx = index.get(fac)
        if idx is None:
            idx = len(factors)
            index[fac] = idx
            factors.append(fac)
        return idx

    bank_codes = {bkey: [code_of(lp) for lp in pats]
                  for bkey, pats in bank_slots.items()}
    if not factors:
        return
    table_key = f"pf_{field}"
    plan.np_tables[table_key] = bank_to_prefilter_tables(
        build_prefilter_bank(factors))
    pf.fields[field] = FieldFactors(
        field=field, table_key=table_key, num_factors=len(factors),
        factors=tuple(factors))
    def register(bkey: str, codes) -> None:
        codes = tuple(codes)
        mask = np.zeros(len(factors), dtype=bool)
        for c in codes:
            if c >= 0:
                mask[c] = True
        pf.bank_field[bkey] = field
        pf.bank_masks[bkey] = mask
        pf.bank_gated[bkey] = all(c != PF_ALWAYS for c in codes)
        pf.slot_codes[bkey] = codes

    for bkey, codes in bank_codes.items():
        register(bkey, codes)
    if split_idx is not None:
        nfa_codes = bank_codes[f"nfa_{field}"]
        register(f"nfa_{field}@short", [nfa_codes[i] for i in split_idx[0]])
        register(f"nfa_{field}@rest", [nfa_codes[i] for i in split_idx[1]])


@dataclass
class PlannedRule:
    name: str
    actions: tuple[Action, ...]
    index: int  # original rule order (first-match semantics)
    ir: Optional[object]  # BoolIR when device-lowered
    program: Optional[Program]  # for host fallback / no-expression rules
    host: bool  # True -> interpret on host
    always: bool = False  # rule with no expression matches everything


@dataclass
class LeafBinding:
    """Where a leaf's [B] result comes from at eval time."""

    kind: str
    field: str = ""
    group: str = ""  # 'eq' | 'prefix' | 'suffix'
    col: int = -1
    span: tuple[int, int] = (0, 0)  # NFA slot range / eq-col range
    table_key: str = ""
    pred: Any = None  # NumCmp / IntListPred probe IR


@dataclass(frozen=True)
class IpPredTable(TensorTable):
    """The single-address/CIDR predicates (`client.ip == "..."`), one
    row each — the JAX package's "ip_preds" dict of arrays."""

    nets: torch.Tensor = arr(U32_WIDE)  # [N, 4] pre-masked words
    masks: torch.Tensor = arr(U32_WIDE)  # [N, 4]


@dataclass
class RulesetPlan:
    field_specs: dict[str, int]
    rules: list[PlannedRule]
    leaves: list[object]
    bindings: dict[int, LeafBinding]
    # Table objects by the JAX package's keys, their tensors on `device`.
    np_tables: dict[str, Any] = dc_field(default_factory=dict)
    stats: dict[str, int] = dc_field(default_factory=dict)
    route_index: dict[str, int] = dc_field(default_factory=dict)
    scan_plans: dict[str, NfaScanPlan] = dc_field(default_factory=dict)
    prefilter: Optional[PrefilterPlan] = None
    dfa_default_mode: str = "auto"
    # Lowered window banks: "win_<field>" -> "dfa_win_<field>".
    win_dfa: dict[str, str] = dc_field(default_factory=dict)
    # Compact staging: per field, the deepest byte any scanner depends
    # on, and that depth on the rung ladder (`derive_staging_caps`).
    staging_required: dict[str, int] = dc_field(default_factory=dict)
    staging_caps: dict[str, int] = dc_field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    def to(self, device) -> "RulesetPlan":
        """Move every table to `device` (in place); returns the plan."""
        self.device = resolve_device(device)
        self.np_tables = {k: v.to(self.device)
                          for k, v in self.np_tables.items()}
        return self

    @property
    def device_rule_indices(self) -> list[int]:
        return [r.index for r in self.rules if not r.host]

    @property
    def host_rules(self) -> list[PlannedRule]:
        return [r for r in self.rules if r.host]

    @property
    def rule_names(self) -> tuple[str, ...]:
        """Rule names in their original index order, route pseudo-rules
        included (hashed into `obs.perf.plan_fingerprint`)."""
        return tuple(r.name for r in self.rules)


def compile_ruleset(
    rules: list[RuleConfig],
    lists: dict[str, list],
    field_specs: Optional[dict[str, int]] = None,
    routes: Optional[list[tuple[str, Optional[Program]]]] = None,
    device=None,
) -> RulesetPlan:
    """Compile WAF rules (+ optional service `route:` predicates, which
    become extra actionless pseudo-rule columns) into one plan whose
    tables live on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    check_env()
    field_specs = dict(field_specs or DEFAULT_FIELD_SPECS)
    registry = LeafRegistry()
    lowerer = Lowerer(lists, registry, field_specs)

    def lower_one(name: str, actions, idx: int,
                  program: Optional[Program]) -> PlannedRule:
        if program is None:
            # No expression -> always matches.
            return PlannedRule(name=name, actions=actions, index=idx,
                               ir=None, program=None, host=False, always=True)
        mark = registry.mark()
        try:
            ir = lowerer.lower_rule(program.root)
            return PlannedRule(name=name, actions=actions, index=idx,
                               ir=ir, program=program, host=False)
        except LowerError:
            registry.rollback(mark)  # don't ship a host rule's partial leaves
            return PlannedRule(name=name, actions=actions, index=idx,
                               ir=None, program=program, host=True)

    planned: list[PlannedRule] = []
    for idx, rule in enumerate(rules):
        planned.append(lower_one(rule.name, rule.actions, idx,
                                 rule.expression))
    route_index: dict[str, int] = {}
    for name, program in routes or []:
        idx = len(planned)
        route_index[name] = idx
        planned.append(lower_one(f"route:{name}", (), idx, program))

    plan = RulesetPlan(
        field_specs=field_specs,
        rules=planned,
        leaves=registry.leaves,
        bindings={},
        route_index=route_index,
        prefilter=PrefilterPlan(),
    )
    _assemble_tables(plan)
    if plan.prefilter is not None and not plan.prefilter.fields:
        plan.prefilter = None  # nothing extractable: Stage A is a no-op
    real = planned[: len(rules)]
    pseudo = planned[len(rules):]
    pf = plan.prefilter
    plan.stats = {
        "rules": len(real),
        "device_rules": sum(1 for r in real if not r.host),
        "host_rules": sum(1 for r in real if r.host),
        "routes": len(pseudo),
        "host_routes": sum(1 for r in pseudo if r.host),
        "leaves": len(registry.leaves),
        "prefilter_factors": (sum(f.num_factors for f in pf.fields.values())
                              if pf else 0),
        "prefilter_gated_banks": (sum(1 for g in pf.bank_gated.values() if g)
                                  if pf else 0),
        "dfa_banks": sum(1 for e in plan.scan_plans.values() if e.dfa_key)
        + len(plan.win_dfa),
        "dfa_states_total": sum(
            plan.np_tables[e.dfa_key].num_states
            for e in plan.scan_plans.values() if e.dfa_key)
        + sum(plan.np_tables[k].num_states for k in plan.win_dfa.values()),
    }
    derive_staging_caps(plan)
    return plan.to(dev)


# -- compact staging caps -------------------------------------------------------
#
# Most rulesets read only a short prefix of most fields. The pass below
# derives, per field, the deepest byte a compiled scanner depends on;
# PINGOO_STAGING=compact stages only that prefix, quantized up this rung
# ladder so plans whose caps land on the same rungs share one layout
# (and, on the card, one set of megastep graph shapes).
STAGING_RUNGS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def quantize_stage_cap(depth: int, spec: int) -> int:
    """The smallest rung >= depth, clamped to the field's spec (a
    2-byte country code is never padded out to 16)."""
    for rung in STAGING_RUNGS:
        if rung >= depth:
            return min(rung, spec)
    return spec


def _num_ir_len_fields(ir) -> set[str]:
    """The fields whose length() an arithmetic IR reads (NLen nodes)."""
    out: set[str] = set()
    stack = [ir]
    while stack:
        node = stack.pop()
        if isinstance(node, NLen):
            out.add(node.field)
        elif isinstance(node, NBin):
            stack.append(node.left)
            stack.append(node.right)
        elif isinstance(node, NNeg):
            stack.append(node.x)
    return out


def derive_staging_caps(plan: RulesetPlan) -> None:
    """Set plan.staging_required (per field, the deepest byte any
    compiled scanner reads) and plan.staging_caps (that depth on
    STAGING_RUNGS, clamped to the spec), as the JAX package does.

    The staged view may only drop bytes no scanner reads:

      * eq needs |pattern| + 1 bytes: the device compares the true
        lengths, and the extra byte keeps an interpreter context built
        from staged bytes exact (a value cut at |pattern| + 1 or more
        is still longer than the pattern);
      * prefix needs |pattern| bytes;
      * suffix reads the end of the true string: the full spec;
      * contains/regex (NFA, DFA and window banks, and the Stage-A
        prefilter over them) scan the whole field: the full spec;
      * length() in device arithmetic pins its field, so that contexts
        built from staged bytes agree with the device's true lengths;
      * host rules and host routes run on contexts built from the
        staged bytes, so every string field they name is pinned.

    A row whose true length passes a cap set below the required depth
    (PINGOO_STAGING_DEPTH) is flagged by the encoder and re-interpreted
    from its untruncated source."""
    specs = plan.field_specs
    required: dict[str, int] = {f: 0 for f in specs}

    def need(field: str, depth: int) -> None:
        if field in required:
            required[field] = max(required[field], int(depth))

    def pin(field: str) -> None:
        if field in required:
            required[field] = int(specs[field])

    for leaf in plan.leaves:
        if isinstance(leaf, StrPred):
            if leaf.kind == "eq":
                need(leaf.field, len(leaf.pattern) + 1)
            elif leaf.kind == "prefix":
                need(leaf.field, len(leaf.pattern))
            else:
                pin(leaf.field)
        elif isinstance(leaf, StrListPred):
            need(leaf.field, max((len(e) for e in leaf.entries),
                                 default=0) + 1)
        elif isinstance(leaf, NfaPred):
            pin(leaf.field)
        elif isinstance(leaf, NumCmp):
            for f in _num_ir_len_fields(leaf.left) \
                    | _num_ir_len_fields(leaf.right):
                pin(f)
        elif isinstance(leaf, IntListPred):
            for f in _num_ir_len_fields(leaf.probe):
                pin(f)
    for rule in plan.rules:
        if not rule.host or rule.program is None:
            continue
        for node in expr_ast.walk(rule.program.root):
            if not isinstance(node, expr_ast.Member) \
                    or not isinstance(node.obj, expr_ast.Ident):
                continue
            if node.obj.name == "http_request" and node.attr in specs:
                pin(node.attr)
            elif node.obj.name == "client" and node.attr == "country":
                pin("country")
    plan.staging_required = dict(required)
    plan.staging_caps = {f: quantize_stage_cap(required[f], spec)
                         for f, spec in specs.items()}


def _assemble_tables(plan: RulesetPlan) -> None:
    str_groups: dict[tuple[str, str], list[tuple[int, StrPred]]] = {}
    nfa_groups: dict[str, list[tuple[int, NfaPred]]] = {}
    ip_preds: list[tuple[int, IpPred]] = []

    for leaf_id, leaf in enumerate(plan.leaves):
        if isinstance(leaf, StrPred):
            str_groups.setdefault((leaf.field, leaf.kind), []).append(
                (leaf_id, leaf))
        elif isinstance(leaf, NfaPred):
            nfa_groups.setdefault(leaf.field, []).append((leaf_id, leaf))
        elif isinstance(leaf, IpPred):
            ip_preds.append((leaf_id, leaf))
        elif isinstance(leaf, StrListPred):
            key = f"strlist_{leaf_id}"
            plan.np_tables[key] = build_pattern_table(
                [(e, False) for e in leaf.entries]
                or [(b"\x00nevermatch", False)])
            plan.bindings[leaf_id] = LeafBinding(
                kind="str_list", field=leaf.field, table_key=key,
                span=(0, len(leaf.entries)))
        elif isinstance(leaf, IpListPred):
            entries = [Ip(e) for e in leaf.entries]
            key = f"iplist_{leaf_id}"
            if len(entries) <= 2048:
                plan.np_tables[key] = build_cidr_table(entries)
                plan.bindings[leaf_id] = LeafBinding(
                    kind="ip_list_small", table_key=key)
            else:
                plan.np_tables[key] = build_v4_buckets(entries)
                plan.bindings[leaf_id] = LeafBinding(
                    kind="ip_list_large", table_key=key)
        elif isinstance(leaf, IntListPred):
            key = f"intlist_{leaf_id}"
            plan.np_tables[key] = build_int_set(list(leaf.values))
            plan.bindings[leaf_id] = LeafBinding(
                kind="int_list", table_key=key, pred=leaf.probe)
        elif isinstance(leaf, NumCmp):
            plan.bindings[leaf_id] = LeafBinding(kind="num_cmp", pred=leaf)
        else:
            raise AssertionError(f"unbound leaf {leaf!r}")

    for (field, kind), entries in str_groups.items():
        key = f"{kind}_{field}"
        pats = [(leaf.pattern, leaf.ci) for _, leaf in entries]
        if kind == "suffix":
            plan.np_tables[key] = build_suffix_table(pats)
        else:
            plan.np_tables[key] = build_pattern_table(pats)
        for col, (leaf_id, _) in enumerate(entries):
            plan.bindings[leaf_id] = LeafBinding(
                kind="str", field=field, group=kind, col=col, table_key=key)

    for field, entries in nfa_groups.items():
        patterns = []
        win_patterns: list = []
        win_srcs: list = []  # window slots' source LinearPatterns
        for leaf_id, leaf in entries:
            alts = nfa_leaf_patterns(leaf)
            # Fixed-shape literal-ish leaves skip the serial NFA scan:
            # every alternative must lower to a window pattern.
            live = [lp for lp in alts if not lp.never_match]
            wins = [repat.to_window(lp) for lp in live]
            if wins and all(w is not None for w in wins):
                start = len(win_patterns)
                win_patterns.extend(wins)
                win_srcs.extend(live)
                plan.bindings[leaf_id] = LeafBinding(
                    kind="window", field=field,
                    span=(start, len(win_patterns)),
                    table_key=f"win_{field}")
                continue
            start = len(patterns)
            patterns.extend(alts)
            plan.bindings[leaf_id] = LeafBinding(
                kind="nfa", field=field, span=(start, len(patterns)),
                table_key=f"nfa_{field}")
        split_idx = None
        if patterns:
            split_idx = _plan_nfa_bank(plan, field, patterns)
        if win_patterns:
            plan.np_tables[f"win_{field}"] = build_window_table(win_patterns)
            # The window slots' sources also lower to a bitsplit DFA; the
            # conv table stays as the exact path and the recheck.
            if _dfa_lower_enabled():
                from .nfa import lower_bank_to_dfa

                win_dfa_bank = lower_bank_to_dfa(win_srcs)
                if win_dfa_bank is not None:
                    plan.np_tables[f"dfa_win_{field}"] = \
                        dfa_to_tables(win_dfa_bank)
                    plan.win_dfa[f"win_{field}"] = f"dfa_win_{field}"
        # One Stage-A factor table per field feeds both of its banks.
        bank_slots: dict[str, list] = {}
        if patterns:
            bank_slots[f"nfa_{field}"] = patterns
        if win_patterns:
            bank_slots[f"win_{field}"] = win_srcs
        _plan_field_prefilter(plan, field, bank_slots, split_idx)

    if ip_preds:
        nets = np.zeros((len(ip_preds), 4), dtype=np.uint32)
        masks = np.zeros((len(ip_preds), 4), dtype=np.uint32)
        for col, (leaf_id, leaf) in enumerate(ip_preds):
            m = prefix_masks(leaf.prefix)
            nets[col] = np.array(leaf.words, dtype=np.uint32) & m
            masks[col] = m
            plan.bindings[leaf_id] = LeafBinding(kind="ip_one", col=col,
                                                 table_key="ip_preds")
        plan.np_tables["ip_preds"] = IpPredTable.from_numpy(nets=nets,
                                                            masks=masks)


def _plan_nfa_bank(plan: RulesetPlan, field: str, patterns: list):
    """Build one field's NFA tables, its DFA lowering and scan record;
    returns the halo partition's (short_idx, rest_idx) slot subsets, or
    None when the bank is not partitioned.

    When a bank is not halo-compatible as built, every unbounded
    repetition is rewritten by repat.extend_footprint (exact over the
    field's byte cap); if that makes the whole bank halo-compatible the
    rewritten bank replaces it, as in the JAX package. Otherwise, under
    PINGOO_NFA_SPLIT=1, the patterns whose bounded footprint fits the
    halo budget form an `@short` sub-bank and the rest an `@rest` one
    (`_halo_partition`); the whole-bank table stays at `key`. A split
    bank runs its sub-banks' NFA scans, never the DFA (the hits are
    recombined per slot)."""
    from .nfa import MAX_SCAN_BITS, scan_bits_needed

    key = f"nfa_{field}"
    field_len = plan.field_specs.get(field, 2048)
    tables = bank_to_tables(build_bank(patterns))
    extended = False
    if not tables.halo_ok:
        cands = []
        for lp in patterns:
            cand = repat.extend_footprint(lp, field_len) \
                if repat.has_unbounded_rep(lp) else lp
            if cand is None or repat.has_unbounded_rep(cand):
                cands = None
                break
            try:
                if scan_bits_needed(cand) > MAX_SCAN_BITS:
                    cands = None
                    break
            except repat.Unsupported:
                cands = None
                break
            cands.append(cand)
        if cands is not None:
            ext_tables = bank_to_tables(build_bank(cands))
            if ext_tables.halo_ok:
                tables = ext_tables
                extended = True
    plan.np_tables[key] = tables

    # The ORIGINAL patterns lower to the DFA: a footprint rewrite above
    # is match-equivalent over the field's byte cap.
    dfa_key = None
    dfa_strategy = None
    dfa_auto = False
    if _dfa_lower_enabled():
        from .nfa import lower_bank_to_dfa

        dfa_bank = lower_bank_to_dfa(patterns)
        if dfa_bank is not None:
            dfa_key = f"dfa_{field}"
            plan.np_tables[dfa_key] = dfa_to_tables(dfa_bank)
            dfa_strategy = select_dfa_strategy()
    split = None
    short_strategy = rest_strategy = None
    slot_perm = None
    split_idx = None
    if _split_enabled() and not tables.halo_ok:
        parts = _halo_partition(patterns, field_len)
        if parts is not None:
            short_idx, rest_idx, short_pats, rest_pats = parts
            split_idx = (short_idx, rest_idx)
            short_tables = bank_to_tables(build_bank(short_pats))
            rest_tables = bank_to_tables(build_bank(rest_pats))
            plan.np_tables[f"{key}@short"] = short_tables
            plan.np_tables[f"{key}@rest"] = rest_tables
            perm = [0] * len(patterns)
            for col, p in enumerate(short_idx + rest_idx):
                perm[p] = col
            slot_perm = tuple(perm)
            split = (f"{key}@short", f"{key}@rest")
            short_strategy = select_scan_strategy(short_tables)
            rest_strategy = select_scan_strategy(rest_tables)
    strategy = select_scan_strategy(tables)
    if dfa_strategy is not None:
        dfa_auto = dfa_strategy.cost < strategy.cost
    plan.scan_plans[key] = NfaScanPlan(
        key=key,
        strategy=strategy,
        split=split,
        short_strategy=short_strategy,
        rest_strategy=rest_strategy,
        slot_perm=slot_perm,
        extended=extended,
        dfa_key=dfa_key,
        dfa_strategy=dfa_strategy,
        dfa_auto=dfa_auto,
    )
    return split_idx


# -- tables carried across from a JAX-package plan ----------------------------

_TABLE_TYPES = {
    "NfaTables": nfa_scan.NfaTables,
    "DfaTables": bitsplit_dfa.DfaTables,
    "PrefilterTables": prefilter.PrefilterTables,
    "PatternTable": match_ops.PatternTable,
    "WindowTable": window_match.WindowTable,
    "CidrTable": cidr.CidrTable,
    "V4PrefixBuckets": cidr.V4PrefixBuckets,
    "IntBitset": cidr.IntBitset,
    "SortedIntSet": cidr.SortedIntSet,
}


def _carry_table(value):
    """One reference table object -> the port's table of the same name,
    field by field (arrays through numpy, metadata as it is)."""
    if isinstance(value, dict):  # the "ip_preds" dict of arrays
        return IpPredTable.from_numpy(
            **{k: np.asarray(v) for k, v in value.items()})
    cls = _TABLE_TYPES.get(type(value).__name__)
    if cls is None:
        raise TypeError(f"no port table for {type(value).__name__}")
    kw = {}
    array_names = {f.name for f in cls.array_fields()}
    for name in (f.name for f in cls.__dataclass_fields__.values()):
        v = getattr(value, name)
        if name in array_names and v is not None:
            nested = type(v).__name__ in _TABLE_TYPES
            v = _carry_table(v) if nested else np.asarray(v)
        kw[name] = v
    return cls.from_numpy(**kw)


def tables_from_reference(np_tables: dict, device) -> dict[str, Any]:
    """A JAX-package plan's `np_tables` (dataclasses / NamedTuples of
    arrays, and the "ip_preds" dict) -> the port's tables on `device`,
    matched by type and field name."""
    dev = resolve_device(device)
    return {key: _carry_table(val).to(dev) for key, val in np_tables.items()}
