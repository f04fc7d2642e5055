"""The batched verdict: one batch of requests -> the per-rule match matrix.

`make_verdict_fn(plan)` returns a function of (tables, batch arrays) ->
[B, R_device] bool, evaluated on the plan's device:

  * Stage A: the literal prefilter over every field, one call
    (ops/prefilter.py; one kernel launch on the card);
  * Stage B: a bank whose every slot is factor-gated is skipped when no
    request of the batch holds any of its factors. The JAX package makes
    this choice per bank on the device (`lax.cond`); here the batch takes
    ONE host decision for all its banks together: every bank's
    "any candidate" flag comes back in one transfer;
  * contains/regex banks run their bitsplit DFA where the mode takes it
    (an approximate DFA only gates: its candidate rows are rechecked by
    the exact NFA scan, and the rest take the skip result), else the
    bit-parallel NFA scan; fixed-shape literal banks run the window
    correlator (or, on the CPU under `auto`, their DFA);
  * byte compares, CIDR/int-set lookups and int64 numeric leaves with
    the interpreter's error semantics (div-by-zero and overflow);
  * the boolean IR with the interpreter's error-lane algebra.

`make_lane_fn` reduces the matrix on the device to first-match action
lanes; `merge_lanes` folds in the host-interpreted rules.

Environment: PINGOO_DFA=off|auto|force and PINGOO_PREFILTER=off|banks,
read per call as in the JAX package; knobs of unported features raise
(device.check_env).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.lowering import (
    BAnd,
    BConst,
    BEqBool,
    BErrConst,
    BLeaf,
    BNot,
    BOr,
    NBin,
    NCol,
    NConst,
    NLen,
    NNeg,
    NumCmp,
)
from ..compiler.plan import NfaScanPlan, RulesetPlan, ScanStrategy
from ..config.schema import Action
from ..device import check_env
from ..expr import execute_as_bool
from ..ops.bitsplit_dfa import dfa_row_candidates, dfa_scan, dfa_skip_hits
from ..ops.cidr import (cidr_contains, int_set_contains, ip_one_matrix,
                        v4_buckets_contains)
from ..ops.match_ops import eq_match, prefix_match, suffix_match
from ..ops.nfa_scan import extract_slots, init_scan_state, scan_chunk
from ..ops.prefilter import prefilter_scan_fields
from ..ops.window_match import window_hits
from .batch import batch_tensors

I64_MIN = -(2**63)
LANE_NONE = np.int32(2**30)  # "no rule": sorts after every real index


def _resolve_pf_mode(plan: RulesetPlan) -> str:
    pf = plan.prefilter
    if pf is None or not pf.fields:
        return "off"
    mode = os.environ.get("PINGOO_PREFILTER", "") or pf.default_mode
    return mode if mode in ("off", "banks") else "banks"


def _resolve_dfa_mode(plan: RulesetPlan) -> str:
    mode = os.environ.get("PINGOO_DFA", "") or plan.dfa_default_mode
    return mode if mode in ("off", "auto", "force") else "auto"


def _dfa_bank_active(plan: RulesetPlan, entry: NfaScanPlan, mode: str) -> bool:
    """Does this NFA bank run its lowered DFA under `mode`? (`auto`
    follows the plan's cost-model choice, and, as in the JAX package,
    yields to a PINGOO_SCAN_STRATEGY pin.)"""
    if mode == "off" or not entry.dfa_key \
            or entry.dfa_key not in plan.np_tables:
        return False
    if mode == "force":
        return True
    return bool(entry.dfa_auto) and not os.environ.get("PINGOO_SCAN_STRATEGY")


def _dfa_win_active(plan: RulesetPlan, key: str, mode: str) -> bool:
    """Does window bank `key` run its lowered DFA? The window correlator
    has no serial chain, so `auto` takes the DFA only where per-row work
    dominates — the CPU — as the JAX package does; `force` everywhere."""
    dkey = plan.win_dfa.get(key)
    if not dkey or dkey not in plan.np_tables or mode == "off":
        return False
    return mode == "force" or plan.device.type == "cpu"


# -- numeric IR evaluation ---------------------------------------------------


def _eval_num(ir, arrays, B, dev):
    """-> (val int64 [B], err bool [B]) with Rust-i64 error semantics."""
    if isinstance(ir, NConst):
        return (torch.full((B,), ir.value, dtype=torch.int64, device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev))
    if isinstance(ir, NCol):
        return (arrays[ir.name].to(torch.int64),
                torch.zeros((B,), dtype=torch.bool, device=dev))
    if isinstance(ir, NLen):
        return (arrays[f"{ir.field}_len"].to(torch.int64),
                torch.zeros((B,), dtype=torch.bool, device=dev))
    if isinstance(ir, NNeg):
        v, e = _eval_num(ir.x, arrays, B, dev)
        return -v, e | (v == I64_MIN)
    if isinstance(ir, NBin):
        lv, le = _eval_num(ir.left, arrays, B, dev)
        rv, re_ = _eval_num(ir.right, arrays, B, dev)
        err = le | re_
        one = torch.ones_like(lv)
        if ir.op == "+":
            s = lv + rv  # wraps; overflow flagged below
            return s, err | (((lv ^ s) & (rv ^ s)) < 0)
        if ir.op == "-":
            s = lv - rv
            return s, err | (((lv ^ rv) & (lv ^ s)) < 0)
        if ir.op == "*":
            s = lv * rv
            # s / lv != rv flags overflow; lv == -1 is left out of that
            # division (I64_MIN / -1 would trap) and covered exactly by
            # the explicit rv == I64_MIN test, as in the JAX package.
            small = (lv == 0) | (lv == -1)
            l_safe = torch.where(small, one, lv)
            of = ~small & (torch.div(s, l_safe, rounding_mode="trunc") != rv)
            of = of | ((lv == -1) & (rv == I64_MIN))
            of = of | ((rv == -1) & (lv == I64_MIN))
            return s, err | of
        if ir.op in ("/", "%"):
            zero = rv == 0
            min_neg1 = (lv == I64_MIN) & (rv == -1)
            r_safe = torch.where(zero | min_neg1, one, rv)
            if ir.op == "/":
                return (torch.div(lv, r_safe, rounding_mode="trunc"),
                        err | zero | min_neg1)
            # I64_MIN % -1 == 0 in the interpreter: only /0 errors.
            val = torch.where(min_neg1, torch.zeros_like(lv),
                              torch.fmod(lv, r_safe))
            return val, err | zero
        raise AssertionError(ir.op)
    raise AssertionError(f"bad num ir {ir!r}")


_CMP = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


# -- leaf evaluation ---------------------------------------------------------


def _const(consts: dict, key, build):
    """Per-plan device constants, built once per verdict function."""
    if key not in consts:
        consts[key] = build()
    return consts[key]


def _span_leaf_matrix(hits: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """[B, P] slot hits -> [B, n_leaves]: leaf j is the OR of slots
    [lo_j, hi_j), read as a difference of one prefix count."""
    cs = F.pad(hits.to(torch.int32).cumsum(dim=1, dtype=torch.int32), (1, 0))
    return (cs.index_select(1, hi) - cs.index_select(1, lo)) > 0


def _eval_leaves(plan: RulesetPlan, tables, arrays, B, consts: dict):
    """Every leaf's ([B] val, [B] err), with shared group ops."""
    dev = plan.device
    results: dict[int, tuple] = {}
    no_err = torch.zeros((B,), dtype=torch.bool, device=dev)
    pf = plan.prefilter
    pf_mode = _resolve_pf_mode(plan)
    dfa_mode = _resolve_dfa_mode(plan)

    def field_data(field):
        return arrays[f"{field}_bytes"], arrays[f"{field}_len"]

    # -- Stage A: every field's prefilter scan in one call ------------------
    pf_hits: dict[str, torch.Tensor] = {}
    if pf is not None and pf_mode == "banks":
        names = list(pf.fields)
        pf_hits = dict(zip(names, prefilter_scan_fields(
            [tables[pf.fields[f].table_key] for f in names],
            [arrays[f"{f}_bytes"] for f in names],
            [arrays[f"{f}_len"] for f in names])))

    def bank_candidates(key):
        """[B] candidate rows of bank `key`, or None when it is ungated."""
        if pf is None or pf_mode == "off":
            return None
        if not pf.bank_gated.get(key) or key not in pf.bank_masks:
            return None
        field = pf.bank_field[key]
        if field not in pf.fields:
            return None
        mask = pf.bank_masks[key]
        if not mask.any():
            # Only never-match slots: statically no candidates.
            return torch.zeros((B,), dtype=torch.bool, device=dev)
        mask_t = _const(consts, ("pf_mask", key),
                        lambda: torch.from_numpy(mask).to(dev))
        return torch.any(pf_hits[field] & mask_t[None, :], dim=1)

    nfa_groups: dict[str, tuple[str, list]] = {}
    win_groups: dict[str, tuple[str, list]] = {}
    for leaf_id, binding in plan.bindings.items():
        if binding.kind == "nfa":
            nfa_groups.setdefault(binding.table_key,
                                  (binding.field, []))[1].append(
                (leaf_id, binding.span))
        elif binding.kind == "window":
            win_groups.setdefault(binding.table_key,
                                  (binding.field, []))[1].append(
                (leaf_id, binding.span))

    # -- Stage B: one host decision for every gated bank --------------------
    cands = {key: bank_candidates(key)
             for key in list(nfa_groups) + list(win_groups)}
    gated = [k for k, c in cands.items() if c is not None]
    run: dict[str, bool] = {}
    if gated:
        flags = torch.stack([cands[k].any() for k in gated]).tolist()
        run = dict(zip(gated, flags))

    def gated_scan(key, data, lens, scan_rows, base_fn):
        if cands.get(key) is None:
            return scan_rows(data, lens)
        return scan_rows(data, lens) if run[key] else base_fn()

    def compact_rows(scan_rows, base_fn, data, lens, cand):
        """Scan only the candidate rows and scatter their hits over the
        skip base. The JAX package gathers them into a power-of-two
        bucket chosen by a `lax.switch` ladder (so some non-candidates
        ride along); `nonzero` here gathers exactly the candidates. The
        bits are identical either way: a non-candidate row's exact scan
        IS the skip base."""
        idx = torch.nonzero(cand).squeeze(1)
        n = idx.numel()
        if n == 0:
            return base_fn()
        if n == data.shape[0]:
            return scan_rows(data, lens)
        hits = scan_rows(data.index_select(0, idx), lens.index_select(0, idx))
        out = base_fn().clone()
        out[idx] = hits
        return out

    def bank_hits(bank, strat: ScanStrategy, data, lens):
        state = scan_chunk(bank, data, lens,
                           init_scan_state(data.shape[0], bank.opt.shape[0],
                                           dev), 0, pair=strat.pair)
        return extract_slots(bank, state, lens)

    def bank_skip_result(bank, lens):
        """A skipped bank's exact result: the zero state's always-match
        and empty-input lanes."""
        state = torch.zeros((lens.shape[0], bank.opt.shape[0]),
                            dtype=torch.int32, device=dev)
        return extract_slots(bank, state, lens)

    def dfa_cascade_hits(key, dtab, data, lens, recheck_rows, recheck_base):
        """One lowered bank's [B, P] hits through its DFA: an exact DFA
        replaces the bank's scan; an approximate one gates it, and its
        candidate rows (also Stage-A candidates) take the exact scan."""
        hits = gated_scan(key, data, lens,
                          lambda d, l: dfa_scan(dtab, d, l),
                          lambda: dfa_skip_hits(dtab, lens))
        if dtab.exact:
            return hits
        cand = dfa_row_candidates(dtab, hits, lens)
        if cands.get(key) is not None:
            cand = cand & cands[key]
        return compact_rows(recheck_rows, recheck_base, data, lens, cand)

    def nfa_bank_result(key, field):
        data, lens = field_data(field)
        bank = tables[key]
        entry = plan.scan_plans[key]
        strat = entry.strategy
        if _dfa_bank_active(plan, entry, dfa_mode) \
                and tables[entry.dfa_key].num_slots \
                == bank.accept_member.shape[1]:
            return dfa_cascade_hits(
                key, tables[entry.dfa_key], data, lens,
                lambda d, l: bank_hits(bank, strat, d, l),
                lambda: bank_skip_result(bank, lens))
        return gated_scan(key, data, lens,
                          lambda d, l: bank_hits(bank, strat, d, l),
                          lambda: bank_skip_result(bank, lens))

    def window_result(key, field):
        data, lens = field_data(field)
        table = tables[key]
        P = table.kernel.shape[0]
        win_rows = lambda d, l: window_hits(table, d, l)  # noqa: E731
        win_base = lambda: torch.zeros((data.shape[0], P),  # noqa: E731
                                       dtype=torch.bool, device=dev)
        dkey = plan.win_dfa.get(key)
        if dkey and _dfa_win_active(plan, key, dfa_mode) \
                and tables[dkey].num_slots == P:
            return dfa_cascade_hits(key, tables[dkey], data, lens,
                                    win_rows, win_base)
        return gated_scan(key, data, lens, win_rows, win_base)

    leaf_col: dict[int, tuple[torch.Tensor, int]] = {}
    for groups, result in ((nfa_groups, nfa_bank_result),
                           (win_groups, window_result)):
        for key, (field, members) in groups.items():
            lo, hi = _const(consts, ("spans", key), lambda members=members: (
                torch.tensor([s[0] for _, s in members], device=dev),
                torch.tensor([s[1] for _, s in members], device=dev)))
            mat = _span_leaf_matrix(result(key, field), lo, hi)
            for j, (leaf_id, _) in enumerate(members):
                leaf_col[leaf_id] = (mat, j)

    group_cols: dict[str, torch.Tensor] = {}
    ip_one = None
    for leaf_id, binding in plan.bindings.items():
        k = binding.kind
        if k in ("nfa", "window"):
            mat, j = leaf_col[leaf_id]
            results[leaf_id] = (mat[:, j], no_err)
        elif k == "str":
            key = binding.table_key
            if key not in group_cols:
                match = {"eq": eq_match, "prefix": prefix_match}.get(
                    binding.group, suffix_match)
                group_cols[key] = match(*field_data(binding.field),
                                        tables[key])
            results[leaf_id] = (group_cols[key][:, binding.col], no_err)
        elif k == "str_list":
            lo, hi = binding.span
            if hi == lo:  # all entries were non-byte strings
                results[leaf_id] = (torch.zeros_like(no_err), no_err)
            else:
                eqs = eq_match(*field_data(binding.field),
                               tables[binding.table_key])
                results[leaf_id] = (eqs[:, lo:hi].any(dim=1), no_err)
        elif k == "ip_one":
            if ip_one is None:
                t = tables["ip_preds"]
                ip_one = ip_one_matrix(t.nets, t.masks, arrays["ip"])
            results[leaf_id] = (ip_one[:, binding.col], no_err)
        elif k == "ip_list_small":
            results[leaf_id] = (
                cidr_contains(tables[binding.table_key], arrays["ip"]),
                no_err)
        elif k == "ip_list_large":
            results[leaf_id] = (
                v4_buckets_contains(tables[binding.table_key], arrays["ip"]),
                no_err)
        elif k == "int_list":
            pv, pe = _eval_num(binding.pred, arrays, B, dev)
            results[leaf_id] = (
                int_set_contains(tables[binding.table_key], pv), pe)
        elif k == "num_cmp":
            cmp: NumCmp = binding.pred
            lv, le = _eval_num(cmp.left, arrays, B, dev)
            rv, re_ = _eval_num(cmp.right, arrays, B, dev)
            results[leaf_id] = (_CMP[cmp.op](lv, rv), le | re_)
        else:
            raise AssertionError(k)
    return results


# -- boolean IR evaluation ---------------------------------------------------


def _eval_bool(ir, leaves, B, dev):
    """-> (val [B], err [B]) reproducing interpreter error semantics:
    && / || short-circuit left-to-right; == evaluates both sides."""
    if isinstance(ir, BConst):
        return (torch.full((B,), bool(ir.value), dtype=torch.bool,
                           device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev))
    if isinstance(ir, BErrConst):
        return (torch.zeros((B,), dtype=torch.bool, device=dev),
                torch.ones((B,), dtype=torch.bool, device=dev))
    if isinstance(ir, BLeaf):
        return leaves[ir.leaf_id]
    if isinstance(ir, BNot):
        v, e = _eval_bool(ir.x, leaves, B, dev)
        return ~v, e
    if isinstance(ir, BAnd):
        lv, le = _eval_bool(ir.left, leaves, B, dev)
        rv, re_ = _eval_bool(ir.right, leaves, B, dev)
        return lv & rv, le | (lv & re_)
    if isinstance(ir, BOr):
        lv, le = _eval_bool(ir.left, leaves, B, dev)
        rv, re_ = _eval_bool(ir.right, leaves, B, dev)
        return lv | rv, le | (~lv & re_)
    if isinstance(ir, BEqBool):
        lv, le = _eval_bool(ir.left, leaves, B, dev)
        rv, re_ = _eval_bool(ir.right, leaves, B, dev)
        val = lv == rv
        if ir.negate:
            val = ~val
        return val, le | re_
    raise AssertionError(f"bad bool ir {ir!r}")


# -- public API --------------------------------------------------------------


def _matched_cols(plan: RulesetPlan, tables, arrays, consts: dict):
    """(tables, device arrays) -> [B, R_dev] bool in device_rule_indices
    order. Single-leaf rules read their column straight out of the
    stacked leaf matrix; compound rules evaluate their boolean tree
    (error -> no-match either way)."""
    dev = plan.device
    device_rules = [r for r in plan.rules if not r.host]
    n_leaves = len(plan.leaves)
    B = arrays["asn"].shape[0]
    leaves = _eval_leaves(plan, tables, arrays, B, consts)
    eff: list = [None] * n_leaves
    for leaf_id, (v, e) in leaves.items():
        eff[leaf_id] = v & ~e
    base = eff + [
        torch.ones((B,), dtype=torch.bool, device=dev),  # const true
        torch.zeros((B,), dtype=torch.bool, device=dev),  # const false
    ]
    extra_cols = []
    rule_col: list[int] = []
    for rule in device_rules:
        if rule.always:
            rule_col.append(n_leaves)
        elif isinstance(rule.ir, BLeaf):
            rule_col.append(rule.ir.leaf_id)
        elif isinstance(rule.ir, BConst):
            rule_col.append(n_leaves if rule.ir.value else n_leaves + 1)
        elif isinstance(rule.ir, BErrConst):
            rule_col.append(n_leaves + 1)
        else:
            v, e = _eval_bool(rule.ir, leaves, B, dev)
            rule_col.append(len(base) + len(extra_cols))
            extra_cols.append(v & ~e)
    if not rule_col:
        return torch.zeros((B, 0), dtype=torch.bool, device=dev)
    allmat = torch.stack(base + extra_cols, dim=1)  # [B, NL + 2 + extra]
    idx = _const(consts, "rule_cols",
                 lambda: torch.tensor(rule_col, dtype=torch.long, device=dev))
    return allmat.index_select(1, idx)


def make_verdict_fn(plan: RulesetPlan):
    """(tables, arrays) -> [B, R_dev] bool tensor on the plan's device.
    `arrays` is a batch's arrays dict (numpy or tensors)."""
    consts: dict = {}

    def verdict(tables, arrays):
        check_env()
        return _matched_cols(plan, tables, batch_tensors(arrays, plan.device),
                             consts)

    return verdict


def make_lane_fn(plan: RulesetPlan, services: list[str] | None = None,
                 service_groups: list[list[str]] | None = None,
                 with_rule_hits: bool = False):
    """Device action-lane reduction: (tables, arrays, n_valid=None) ->
    [3 + max(G, 1), B] int32 rows (first_act_idx, first_act_kind,
    first_block_idx, route lane(s)) in original rule-index space, plus
    the [C] per-column hit counts when `with_rule_hits`."""
    if service_groups is not None and services is not None:
        raise ValueError("pass services or service_groups, not both")
    groups = (service_groups if service_groups is not None
              else ([services] if services else []))
    return _make_lane_body(plan, groups, with_rule_hits)


def _make_lane_body(plan: RulesetPlan, groups: list[list[str]],
                    with_rule_hits: bool):
    dev = plan.device
    device_rules = [r for r in plan.rules if not r.host]
    orig_idx = np.array([r.index for r in device_rules], dtype=np.int32)
    first_kind = np.array(
        [(1 if r.actions[0] == Action.BLOCK else 2) if r.actions else 0
         for r in device_rules], dtype=np.int32)
    has_act = first_kind != 0
    has_block = np.array([Action.BLOCK in r.actions for r in device_rules],
                         dtype=bool)
    col_of_rule = {r.index: j for j, r in enumerate(device_rules)}
    group_routes: list[list[tuple[int, int]]] = []
    for grp in groups:
        dev_route: list[tuple[int, int]] = []
        for order, name in enumerate(grp):
            ridx = plan.route_index.get(name)
            if ridx is not None and ridx in col_of_rule:
                dev_route.append((order, col_of_rule[ridx]))
        group_routes.append(dev_route)

    idx_row = torch.from_numpy(orig_idx).to(dev)[None, :]
    has_act_row = torch.from_numpy(has_act).to(dev)[None, :]
    first_kind_vec = torch.from_numpy(first_kind).to(dev)
    has_block_row = torch.from_numpy(has_block).to(dev)[None, :]
    group_consts = [
        (torch.tensor([c for _, c in r], dtype=torch.long, device=dev),
         torch.tensor([o for o, _ in r], dtype=torch.int32, device=dev))
        if r else None
        for r in group_routes]
    none_val = int(LANE_NONE)
    consts: dict = {}

    def lanes(tables, arrays, n_valid=None):
        check_env()
        arrays = batch_tensors(arrays, plan.device)
        matched = _matched_cols(plan, tables, arrays, consts)  # [B, C]
        B = arrays["asn"].shape[0]

        def pack(stack):
            if not with_rule_hits:
                return stack
            m = matched
            if n_valid is not None:
                m = m & (torch.arange(B, device=dev) < n_valid)[:, None]
            return stack, m.sum(dim=0, dtype=torch.int32)

        none = torch.full((B,), none_val, dtype=torch.int32, device=dev)
        n_route = max(len(groups), 1)
        if matched.shape[1] == 0:
            return pack(torch.stack(
                [none, torch.zeros_like(none), none] + [none] * n_route))
        act_idx = torch.where(matched & has_act_row, idx_row, none_val)
        first_act_idx = act_idx.min(dim=1).values
        arg = act_idx.argmin(dim=1)
        kind = torch.where(first_act_idx < none_val, first_kind_vec[arg],
                           torch.zeros_like(first_act_idx))
        blk_idx = torch.where(matched & has_block_row, idx_row, none_val)
        first_block_idx = blk_idx.min(dim=1).values
        route_lanes = []
        for consts_g in group_consts:
            if consts_g is None:
                route_lanes.append(none)
                continue
            cols, orders = consts_g
            rm = matched.index_select(1, cols)
            route_lanes.append(torch.where(rm, orders[None, :], none_val)
                               .min(dim=1).values.to(torch.int32))
        if not route_lanes:
            route_lanes.append(none)
        return pack(torch.stack([first_act_idx, kind, first_block_idx]
                                + route_lanes).to(torch.int32))

    return lanes


# -- host side: interpreted rules, lanes, actions -----------------------------


def host_rule_lanes(plan: RulesetPlan, batch, lists):
    """Host-interpreted rules' contribution to the action lanes (same
    triple as make_lane_fn, original-index space)."""
    host_rules = plan.host_rules
    B = batch.size
    first_act = np.full(B, LANE_NONE, dtype=np.int32)
    kind = np.zeros(B, dtype=np.int32)
    first_block = np.full(B, LANE_NONE, dtype=np.int32)
    if not host_rules:
        return first_act, kind, first_block
    from .batch import batch_to_contexts

    contexts = batch_to_contexts(batch, lists)
    for rule in host_rules:
        r_kind = ((1 if rule.actions[0] == Action.BLOCK else 2)
                  if rule.actions else 0)
        r_block = Action.BLOCK in rule.actions
        if not r_kind and not r_block:
            continue
        for i, ctx in enumerate(contexts):
            if rule.index >= first_act[i] and (not r_block
                                               or rule.index >= first_block[i]):
                continue  # cannot improve either lane for this request
            try:
                m = execute_as_bool(rule.program, ctx)
            except Exception:
                m = False
            if not m:
                continue
            if r_kind and rule.index < first_act[i]:
                first_act[i] = rule.index
                kind[i] = r_kind
            if r_block and rule.index < first_block[i]:
                first_block[i] = rule.index
    return first_act, kind, first_block


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def merge_lanes(dev_lanes, host_lanes) -> tuple[np.ndarray, np.ndarray]:
    """Combine device + host lane triples into the per-request action
    pair (unverified 0/1/2, verified_block bool), reproducing first-match
    order across both rule populations."""
    stacked = _host_array(dev_lanes)
    d_act, d_kind, d_blk = stacked[0], stacked[1], stacked[2]
    h_act, h_kind, h_blk = host_lanes
    host_wins = h_act < d_act
    act_idx = np.where(host_wins, h_act, d_act)
    kind = np.where(host_wins, h_kind, d_kind)
    unverified = np.where(act_idx < LANE_NONE, kind, 0).astype(np.int32)
    verified_block = np.minimum(d_blk, h_blk) < LANE_NONE
    return unverified, verified_block


def _host_matrix(plan, batch, lists) -> np.ndarray:
    """[B, R] bool with only the host-interpreted rules' columns filled."""
    out = np.zeros((batch.size, len(plan.rules)), dtype=bool)
    host_rules = plan.host_rules
    if host_rules:
        from .batch import batch_to_contexts

        contexts = batch_to_contexts(batch, lists)
        for rule in host_rules:
            col = out[:, rule.index]
            for i, ctx in enumerate(contexts):
                col[i] = execute_as_bool(rule.program, ctx)
    return out


def finish_batch(plan, dev, batch, lists) -> np.ndarray:
    """Combine a device verdict with the host-interpreted rules. `dev`
    may be a tensor still being computed on the card: the host rules run
    first and `_host_array` then syncs once, so they overlap the device
    work (as in the JAX package)."""
    out = _host_matrix(plan, batch, lists)
    dev = _host_array(dev)
    for col, idx in enumerate(plan.device_rule_indices):
        out[:, idx] = dev[:, col]
    return out


def evaluate_batch(plan, verdict_fn, tables, batch, lists) -> np.ndarray:
    """Full match matrix [B, R] in original rule order (device + host)."""
    return finish_batch(plan, verdict_fn(tables, batch.arrays), batch, lists)


def interpret_rules_row(plan: RulesetPlan, ctx) -> np.ndarray:
    """One request's full match row via the host interpreter (the parity
    oracle): always-rules match, errors fail open."""
    row = np.zeros(len(plan.rules), dtype=bool)
    for rule in plan.rules:
        if rule.always:
            row[rule.index] = True
            continue
        try:
            row[rule.index] = execute_as_bool(rule.program, ctx)
        except Exception:
            row[rule.index] = False
    return row


def action_lanes(plan: RulesetPlan,
                 matched: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-request action decision as two lanes: `unverified` (0 none /
    1 block / 2 captcha: the first matched rule with actions decides by
    its first action) and `verified_block` (any matched rule carries a
    Block action: a captcha-verified client skips Captcha actions)."""
    rule_first = np.zeros(len(plan.rules), dtype=np.int32)
    rule_has_block = np.zeros(len(plan.rules), dtype=bool)
    for r in plan.rules:
        if r.actions:
            rule_first[r.index] = 1 if r.actions[0] == Action.BLOCK else 2
            rule_has_block[r.index] = Action.BLOCK in r.actions
    acting = matched & (rule_first != 0)[None, :]
    any_hit = acting.any(axis=1)
    first = np.argmax(acting, axis=1)
    unverified = np.where(any_hit, rule_first[first], 0).astype(np.int32)
    verified_block = (matched & rule_has_block[None, :]).any(axis=1)
    return unverified, verified_block


def first_action(plan: RulesetPlan, matched: np.ndarray) -> np.ndarray:
    """The unverified-client lane of `action_lanes`."""
    return action_lanes(plan, matched)[0]
