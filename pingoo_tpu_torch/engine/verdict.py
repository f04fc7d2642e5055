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

`make_megastep_fn` is the megastep (PINGOO_MEGASTEP=force): one program
over K stacked batch slices, each through the same body with Stage B
taken on the device (no host sync, so that engine/graphs.py can capture
the whole window as one CUDA graph).

The Stage-A aux vector (`_stage_a_aux`, the JAX package's layout) is
reduced on the device from the prefilter kernel's hits: per batch
beside the matrix and Stage A's issue ms in the planes' served
programs (`make_verdict_program`, `make_lane_program`), per slice as
the megastep's [K, aux_len] output. It feeds the planes'
`pingoo_prefilter_candidate_rate` and `pingoo_scan_banks_skipped_total`.

Compact staging: a batch's packed buffer (engine/batch.py
`PackedLayout`) is decoded on the device (`unpack_staged`) into the
arrays full staging gives, which the Python plane hands to
`make_verdict_program` and `make_packed_lane_program` to the lane body,
so full and compact staging share every predicate by construction.

The halo split: a halo-compatible NFA bank (or the @short sub-bank of a
bank the plan partitioned under PINGOO_NFA_SPLIT=1) runs as k chunks of
its rows (ops/nfa_scan.halo_split_scan) wherever the JAX package's rule
takes that route at the width the batch was staged at: k =
halo_split_k(bank, L, max_k=halo_k) > 1 and L / k + H below the base
stepping's count of steps.

Environment: PINGOO_DFA=off|auto|force and PINGOO_PREFILTER=off|banks|
compact, read per call as in the JAX package (PINGOO_PREFILTER_LEVELS,
the depth of the JAX package's row ladder, is accepted and means nothing
here: compact gathers exactly its candidates); PINGOO_SCAN_STRATEGY (a
pin of every bank's strategy record: scan, pair, pallas, pallas_pair,
pallas_single keep the plan's halo_k; halo keeps the kind and sets
halo_k to 8) and PINGOO_HALO_SPLIT (a halo_k of 1 attempts k up to 8),
read per call too, where the JAX package reads the latter at import;
PINGOO_MEGASTEP and PINGOO_MEGASTEP_K, read where the planes decide;
knobs of unported features raise (device.check_env).
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

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
from ..ops.nfa_scan import (extract_slots, halo_split_k, halo_split_scan,
                            init_scan_state, scan_chunk)
from ..ops.prefilter import prefilter_scan_fields
from ..ops.window_match import window_hits
from .batch import PackedLayout, batch_tensors, packed_tensor

I64_MIN = -(2**63)
LANE_NONE = np.int32(2**30)  # "no rule": sorts after every real index


def _resolve_pf_mode(plan: RulesetPlan) -> str:
    pf = plan.prefilter
    if pf is None or not pf.fields:
        return "off"
    mode = os.environ.get("PINGOO_PREFILTER", "") or pf.default_mode
    return mode if mode in ("off", "banks", "compact") else "banks"


def _resolve_dfa_mode(plan: RulesetPlan) -> str:
    mode = os.environ.get("PINGOO_DFA", "") or plan.dfa_default_mode
    return mode if mode in ("off", "auto", "force") else "auto"


# PINGOO_SCAN_STRATEGY pins: value -> (kind, pair), as in the JAX package.
# On the card every kind runs the one CUDA kernel; the record still
# decides the halo split's rule (the pair flag halves the base steps).
_ENV_STRATEGIES = {
    "scan": ("scan", False),
    "pair": ("scan", True),
    "pallas": ("pallas", True),
    "pallas_pair": ("pallas", True),
    "pallas_single": ("pallas", False),
}


def _resolve_strategy(strat: ScanStrategy) -> ScanStrategy:
    """A bank's strategy record under PINGOO_SCAN_STRATEGY: unset keeps
    the plan's; `halo` keeps the kind and pair flag and attempts k up to
    8; another pin sets the kind and pair flag and keeps the plan's
    halo_k. An unknown value raises."""
    env = os.environ.get("PINGOO_SCAN_STRATEGY", "")
    if not env:
        return strat
    if env == "halo":
        return ScanStrategy(kind=strat.kind, pair=strat.pair, halo_k=8,
                            source="env")
    if env not in _ENV_STRATEGIES:
        raise ValueError(f"PINGOO_SCAN_STRATEGY={env} is none of halo, "
                         f"{', '.join(_ENV_STRATEGIES)}")
    kind, pair = _ENV_STRATEGIES[env]
    return ScanStrategy(kind=kind, pair=pair, halo_k=strat.halo_k,
                        source="env")


def _halo_split_forced() -> bool:
    """PINGOO_HALO_SPLIT: a bank whose strategy has halo_k 1 attempts
    the halo split up to k = 8 all the same."""
    return os.environ.get("PINGOO_HALO_SPLIT", "0") not in ("", "0")


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


def dfa_dispatch_counts(plan: RulesetPlan) -> tuple[str, int, int]:
    """(resolved PINGOO_DFA mode, banks running their lowered DFA,
    approximate ones among them that recheck through the NFA), as the
    JAX package counts them: the ladder's dfa rung demotes only a plan
    that runs a DFA."""
    mode = _resolve_dfa_mode(plan)
    banks = recheck = 0
    keys = [e.dfa_key for e in plan.scan_plans.values()
            if _dfa_bank_active(plan, e, mode)]
    keys += [plan.win_dfa[k] for k in plan.win_dfa
             if _dfa_win_active(plan, k, mode)]
    for dkey in keys:
        banks += 1
        recheck += not plan.np_tables[dkey].exact
    return mode, banks, recheck


def prefilter_aux_banks(plan: RulesetPlan) -> tuple[tuple, tuple]:
    """The Stage-A aux vector's bank inventory, the JAX package's
    (`_make_prefilter_body`): `gated`, every cascade-gated bank the
    evaluator scans (NFA banks split-aware, then the window banks), and
    `masked`, those of them with a non-empty factor mask, in the order
    of the aux vector's per-bank lanes."""
    pf = plan.prefilter
    if pf is None or not pf.fields:
        return (), ()
    scanned: list = []
    for key, entry in plan.scan_plans.items():
        scanned.extend(entry.split if entry.split else (key,))
    scanned.extend(k for k in pf.bank_masks if k.startswith("win_"))
    gated = tuple(k for k in scanned
                  if pf.bank_gated.get(k) and k in pf.bank_masks
                  and pf.bank_field.get(k) in pf.fields)
    return gated, tuple(k for k in gated if pf.bank_masks[k].any())


def prefilter_aux_len(plan: RulesetPlan) -> int:
    """Lanes of the Stage-A aux vector under the resolved PINGOO_PREFILTER
    mode: 2 + 2 * masked banks, 0 when the prefilter is off."""
    if _resolve_pf_mode(plan) == "off":
        return 0
    return 2 + 2 * len(prefilter_aux_banks(plan)[1])


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


def _stage_a_aux(plan: RulesetPlan, consts: dict, candidates, dev):
    """The Stage-A aux vector, int32 on the device, the JAX package's
    layout: [candidate rows over the masked banks, banks skipped,
    *per masked bank its candidate rows, *per masked bank 1 if skipped],
    where a gated bank with an empty mask always counts as skipped.
    Reduced from the prefilter kernel's hits (through `candidates`,
    Stage B's [B] masks) with a few device ops and no host sync."""
    gated, masked = _const(consts, "aux_banks",
                           lambda: prefilter_aux_banks(plan))
    never = len(gated) - len(masked)
    if not masked:
        return _const(consts, "aux_never", lambda: torch.tensor(
            [0, never], dtype=torch.int32, device=dev))
    counts = torch.stack([candidates(k).sum(dtype=torch.int32)
                          for k in masked])
    skips = (counts == 0).to(torch.int32)
    head = torch.stack([counts.sum(dtype=torch.int32),
                        skips.sum(dtype=torch.int32) + never])
    return torch.cat([head, counts, skips])


def _eval_leaves(plan: RulesetPlan, tables, arrays, B, consts: dict,
                 sync_free: bool = False):
    """(every leaf's ([B] val, [B] err), with shared group ops; the
    batch's Stage-A aux vector (`_stage_a_aux`); the host's issue ms of
    Stage A), the last two None with the prefilter off.

    `sync_free` takes Stage B on the device, with no host sync: each
    gated bank scans its candidate rows only (`gathered_rows`), as the
    JAX package's compact mode does, where the per-batch path decides
    for all banks at once on the host: under `banks` from each bank's
    "any candidate" flag, under `compact` from each bank's candidate
    count (`compact_rows` then gathers exactly the candidates)."""
    dev = plan.device
    results: dict[int, tuple] = {}
    no_err = torch.zeros((B,), dtype=torch.bool, device=dev)
    pf = plan.prefilter
    pf_mode = _resolve_pf_mode(plan)
    dfa_mode = _resolve_dfa_mode(plan)
    halo_forced = _halo_split_forced()

    def field_data(field):
        return arrays[f"{field}_bytes"], arrays[f"{field}_len"]

    # -- Stage A: every field's prefilter scan in one call ------------------
    pf_hits: dict[str, torch.Tensor] = {}
    stage_a_ms = None
    if pf is not None and pf_mode != "off":
        names = list(pf.fields)
        t0 = time.monotonic()
        pf_hits = dict(zip(names, prefilter_scan_fields(
            [tables[pf.fields[f].table_key] for f in names],
            [arrays[f"{f}_bytes"] for f in names],
            [arrays[f"{f}_len"] for f in names])))
        stage_a_ms = (time.monotonic() - t0) * 1e3

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
    # A split NFA bank is gated as its two sub-banks, each on its own mask.
    scan_keys = []
    for key in nfa_groups:
        split = plan.scan_plans[key].split
        scan_keys.extend(split if split is not None else (key,))
    cands = {key: bank_candidates(key)
             for key in scan_keys + list(win_groups)}
    gated = [k for k, c in cands.items() if c is not None]
    aux = None if not pf_hits else _stage_a_aux(
        plan, consts, lambda k: cands[k] if k in cands
        else bank_candidates(k), dev)
    run: dict[str, bool] = {}
    counts: dict[str, int] = {}
    if gated and not sync_free:
        if pf_mode == "compact":
            counts = dict(zip(gated, torch.stack(
                [cands[k].sum() for k in gated]).tolist()))
        else:
            flags = torch.stack([cands[k].any() for k in gated]).tolist()
            run = dict(zip(gated, flags))

    def gated_scan(key, data, lens, scan_rows, base_fn):
        if cands.get(key) is None:
            return scan_rows(data, lens)
        if sync_free:
            return gathered_rows(scan_rows, base_fn, data, lens, cands[key])
        if pf_mode == "compact":
            return compact_rows(scan_rows, base_fn, data, lens, cands[key],
                                counts[key])
        return scan_rows(data, lens) if run[key] else base_fn()

    def gathered_rows(scan_rows, base_fn, data, lens, cand):
        """`compact_rows` with no host sync, the counterpart of the JAX
        package's `lax.cond`/`lax.switch`: the candidate rows, in order,
        fill the front of a fixed [B] row index (`pos` is each one's
        place), the rest of it scans at length 0, which costs the
        kernels almost nothing (each walks a row only to its length),
        and each candidate takes its hits back from its place. The bits
        are `compact_rows`' for the same reason."""
        n = data.shape[0]
        rows = torch.arange(n, device=dev)
        pos = cand.to(torch.int64).cumsum(0) - 1
        idx = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        idx.scatter_(0, torch.where(cand, pos, n), rows)
        idx = idx[:n]
        live = rows <= pos[-1:]
        hits = scan_rows(data.index_select(0, idx),
                         torch.where(live, lens.index_select(0, idx), 0))
        back = hits.index_select(0, pos.clamp(min=0))
        return torch.where(cand[:, None], back, base_fn())

    def compact_rows(scan_rows, base_fn, data, lens, cand, count=None):
        """Scan only the candidate rows and scatter their hits over the
        skip base. The JAX package gathers them into a power-of-two
        bucket chosen by a `lax.switch` ladder (so some non-candidates
        ride along); here exactly the candidates are gathered: by
        `nonzero`, or, where the host already holds their `count`
        (Stage B's decision under compact), as the first `count` rows
        of a stable sort that puts them first, with no sync. The bits
        are identical either way: a non-candidate row's exact scan IS
        the skip base."""
        if count is None:
            idx = torch.nonzero(cand).squeeze(1)
            count = idx.numel()
        elif 0 < count < data.shape[0]:
            idx = torch.argsort((~cand).to(torch.int32), stable=True)[:count]
        if count == 0:
            return base_fn()
        if count == data.shape[0]:
            return scan_rows(data, lens)
        hits = scan_rows(data.index_select(0, idx), lens.index_select(0, idx))
        out = base_fn().clone()
        out[idx] = hits
        return out

    def bank_hits(bank, strat: ScanStrategy, data, lens):
        """One bank's [B, P] hits: the halo split where the JAX package's
        rule takes it at this width (the record's pair flag sets the base
        step count, though the CUDA kernel steps one column at a time
        either way), else one scan of the whole rows."""
        L = data.shape[1]
        k_cap = strat.halo_k if strat.halo_k > 1 else (8 if halo_forced
                                                        else 1)
        if k_cap > 1:
            k = halo_split_k(bank, L, max_k=k_cap)
            base_iters = (L + 1) // 2 if strat.pair else L
            if k > 1 and L // k + int(bank.max_footprint) < base_iters:
                return halo_split_scan(bank, data, lens, k, pair=strat.pair)
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
        if sync_free:
            return gathered_rows(recheck_rows, recheck_base, data, lens,
                                 cand)
        return compact_rows(recheck_rows, recheck_base, data, lens, cand)

    def bank_scan(bank, strat, lens):
        """(scan_rows, base_fn) of one NFA bank under `strat`."""
        return (lambda d, l: bank_hits(bank, strat, d, l),
                lambda: bank_skip_result(bank, lens))

    def nfa_bank_result(key, field):
        data, lens = field_data(field)
        bank = tables[key]
        entry = plan.scan_plans[key]
        if entry.split is not None:
            # The @short and @rest sub-banks, each under its own strategy,
            # Stage-B mask and skip result, then the slots back in order.
            # (The JAX package's legacy HALO_SPLIT branch of its
            # non-field PINGOO_SCAN_PACK modes has no counterpart: the
            # port refuses those modes, device.check_env.)
            hits = [gated_scan(sub, data, lens,
                               *bank_scan(tables[sub], _resolve_strategy(st),
                                          lens))
                    for sub, st in zip(entry.split, (entry.short_strategy,
                                                     entry.rest_strategy))]
            perm = _const(consts, ("slot_perm", key), lambda: torch.tensor(
                entry.slot_perm, dtype=torch.long, device=dev))
            return torch.cat(hits, dim=1).index_select(1, perm)
        scan = bank_scan(bank, _resolve_strategy(entry.strategy), lens)
        if _dfa_bank_active(plan, entry, dfa_mode) \
                and tables[entry.dfa_key].num_slots \
                == bank.accept_member.shape[1]:
            return dfa_cascade_hits(key, tables[entry.dfa_key], data, lens,
                                    *scan)
        return gated_scan(key, data, lens, *scan)

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
    return results, aux, stage_a_ms


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


def _matched_cols(plan: RulesetPlan, tables, arrays, consts: dict,
                  sync_free: bool = False):
    """(tables, device arrays) -> ([B, R_dev] bool in device_rule_indices
    order, the Stage-A aux vector, Stage A's issue ms; the last two None
    with the prefilter off). Single-leaf rules read their column
    straight out of the stacked leaf matrix; compound rules evaluate
    their boolean tree (error -> no-match either way)."""
    dev = plan.device
    device_rules = [r for r in plan.rules if not r.host]
    n_leaves = len(plan.leaves)
    B = arrays["asn"].shape[0]
    leaves, aux, stage_a_ms = _eval_leaves(plan, tables, arrays, B, consts,
                                           sync_free)
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
        return (torch.zeros((B, 0), dtype=torch.bool, device=dev), aux,
                stage_a_ms)
    allmat = torch.stack(base + extra_cols, dim=1)  # [B, NL + 2 + extra]
    idx = _const(consts, "rule_cols",
                 lambda: torch.tensor(rule_col, dtype=torch.long, device=dev))
    return allmat.index_select(1, idx), aux, stage_a_ms


def make_verdict_program(plan: RulesetPlan):
    """The Python plane's served program: (tables, arrays) -> ([B, R_dev]
    bool tensor on the plan's device, the Stage-A aux vector, Stage A's
    issue ms; the last two None with the prefilter off). `arrays` is a
    batch's arrays dict (numpy or tensors)."""
    consts: dict = {}

    def verdict(tables, arrays):
        check_env()
        return _matched_cols(plan, tables, batch_tensors(arrays, plan.device),
                             consts)

    return verdict


def make_verdict_fn(plan: RulesetPlan):
    """(tables, arrays) -> [B, R_dev] bool tensor on the plan's device:
    `make_verdict_program`'s matrix alone (the JAX package's signature)."""
    program = make_verdict_program(plan)

    def verdict(tables, arrays):
        return program(tables, arrays)[0]

    return verdict


def unpack_staged(packed: torch.Tensor, layout: PackedLayout) -> dict:
    """Decode one packed staging buffer on its device: [B, width] uint8
    -> the arrays `batch_tensors` gives under full staging. Each string
    field is made contiguous once here (the NFA and DFA launchers take
    unit-stride rows, and would copy a strided view at every bank call);
    the u16 little-endian lengths become lo + 256 * hi in int32; the 16
    big-endian IP bytes the [B, 4] int64 words of uint32 values; asn and
    remote_port are the int64 of their 8 little-endian bytes."""
    arrays = {}
    for name, off, w in layout.fields:
        arrays[f"{name}_bytes"] = packed[:, off:off + w].contiguous()
    l0 = layout.lens[0][1]
    nf = len(layout.lens)
    lb = packed[:, l0:l0 + 2 * nf].to(torch.int32).view(-1, nf, 2)
    lens = lb[:, :, 0] + 256 * lb[:, :, 1]
    for i, (name, _) in enumerate(layout.lens):
        arrays[f"{name}_len"] = lens[:, i]
    ipb = packed[:, layout.ip_off:layout.ip_off + 16].to(torch.int64) \
        .view(-1, 4, 4)
    arrays["ip"] = ((ipb[:, :, 0] << 24) | (ipb[:, :, 1] << 16)
                    | (ipb[:, :, 2] << 8) | ipb[:, :, 3])
    for key, off in (("asn", layout.asn_off),
                     ("remote_port", layout.port_off)):
        # A bitcast of the bytes: exact for every int64, negatives too.
        arrays[key] = packed[:, off:off + 8].contiguous() \
            .view(torch.int64)[:, 0]
    return arrays


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
    body = _make_lane_body(plan, groups, with_rule_hits)

    def lanes(tables, arrays, n_valid=None):
        return body(tables, arrays, n_valid=n_valid)[0]

    return lanes


def make_lane_program(plan: RulesetPlan,
                      service_groups: list[list[str]] | None = None):
    """The sidecar's served program: (tables, arrays, n_valid=None) ->
    (`make_lane_fn`'s lanes, the Stage-A aux vector, Stage A's issue ms;
    the last two None with the prefilter off)."""
    return _make_lane_body(plan, service_groups or [], False)


def make_packed_lane_program(plan: RulesetPlan,
                             service_groups: list[list[str]] | None = None):
    """`make_lane_program` under compact staging: (tables, packed,
    layout, n_valid=None) -> the same triple, through `unpack_staged`
    and the same body."""
    lanes = _make_lane_body(plan, service_groups or [], False)

    def lanes_packed(tables, packed, layout, n_valid=None):
        return lanes(tables, unpack_staged(
            packed_tensor(packed, plan.device), layout), n_valid=n_valid)

    return lanes_packed


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

    def lanes(tables, arrays, n_valid=None, sync_free=False):
        """-> (the lanes, with the [C] hit counts when `with_rule_hits`;
        the Stage-A aux vector; Stage A's issue ms)."""
        check_env()
        arrays = batch_tensors(arrays, plan.device)
        matched, aux, stage_a_ms = _matched_cols(plan, tables, arrays, consts,
                                                 sync_free)  # [B, C]
        B = arrays["asn"].shape[0]

        def pack(stack):
            if with_rule_hits:
                m = matched
                if n_valid is not None:
                    m = m & (torch.arange(B, device=dev) < n_valid)[:, None]
                stack = stack, m.sum(dim=0, dtype=torch.int32)
            return stack, aux, stage_a_ms

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


# -- the megastep: K batch slices in one program ------------------------------
#
# PINGOO_MEGASTEP (read where the planes decide, as in the JAX package):
#   off   — per-batch dispatch, the parity oracle (the default);
#   force — every batch goes through a megastep window (K may be 1);
#   auto  — a window only with a backlog queued behind the batch, K
#           sized against the oldest row's deadline slack by the
#           scheduler's cost model (sched/scheduler.py size_megastep_k).
# PINGOO_MEGASTEP_K caps K (default 4). Short slices are masked by a
# per-slice n_valid word, never re-shaped; a per-slice ruleset epoch word
# passes through the program untouched. On the card the window is one
# CUDA graph replay (engine/graphs.py); on the CPU the same body runs
# eagerly over the kernels' plain versions.

MEGASTEP_K_DEFAULT = 4


def _resolve_megastep_mode() -> str:
    """PINGOO_MEGASTEP: off | auto | force, anything else off."""
    mode = os.environ.get("PINGOO_MEGASTEP", "off")
    return mode if mode in ("off", "auto", "force") else "off"


def megastep_k_cap(default: int = MEGASTEP_K_DEFAULT) -> int:
    """PINGOO_MEGASTEP_K: the largest K one window may cover (`default`
    when it is unset or not an integer)."""
    try:
        return max(1, int(os.environ.get("PINGOO_MEGASTEP_K", str(default))))
    except ValueError:
        return default


def megastep_k_ladder(k_max: int) -> list[int]:
    """The pow2 K rungs [1, 2, 4, ...] up to k_max: each rung is one
    program shape (one CUDA graph per window shape on the card)."""
    rungs = [1]
    while rungs[-1] * 2 <= max(1, k_max):
        rungs.append(rungs[-1] * 2)
    return rungs


class MegastepProgram(NamedTuple):
    """`make_megastep_fn`'s bundle: the K-slice body and what its
    callers need to read its outputs."""

    # (tables, stacked, n_valid, epoch) -> (out, rule_hits, echo, pf_aux)
    fn: Any
    kind: str  # "lanes" (sidecar) | "matrix" (Python plane)
    with_rule_hits: bool
    # The plan the body reads: its DFA mode, which the ladder's dfa rung
    # changes, decides which kernels a captured graph launches.
    plan: Any = None

    def dfa_mode(self) -> str:
        return "" if self.plan is None else _resolve_dfa_mode(self.plan)


def make_megastep_fn(plan: RulesetPlan, kind: str = "lanes",
                     service_groups: list[list[str]] | None = None,
                     with_rule_hits: bool = False) -> MegastepProgram:
    """The megastep: (tables, stacked, n_valid, epoch) -> (out,
    rule_hits, epoch_echo, pf_aux) over K batch slices.

      stacked  {name: [K, B, ...] tensor}: K slices padded to one row
               count (DeviceInputQueue, engine/batch.py);
      n_valid  [K] int32: the live rows of each slice;
      epoch    [K] int32: each slice's ruleset epoch, echoed back.

    `kind="lanes"` gives [K, 3 + max(G, 1), B] int32 action lanes
    (`make_lane_fn`'s body per slice), `kind="matrix"` the [K, B, C]
    bool match matrix (`make_verdict_fn`'s); rule_hits is [K, C] int32
    (C = 0 without `with_rule_hits`), epoch_echo [K], pf_aux [K,
    aux_len] int32: each slice's Stage-A aux vector (`_stage_a_aux`;
    [K, 2] zeros with the prefilter off), the JAX package's third
    output, last here. Each slice runs the per-batch body with Stage B
    on the device (`sync_free`), which gives the per-batch path's bits
    and, row for row, its aux vector. Every output is there on every
    call, so a graph captured of the body replays all four."""
    if kind not in ("lanes", "matrix"):
        raise ValueError(f"bad megastep kind {kind!r}")
    dev = plan.device
    lane_body = (_make_lane_body(plan, service_groups or [], with_rule_hits)
                 if kind == "lanes" else None)
    n_hit_cols = (len([r for r in plan.rules if not r.host])
                  if with_rule_hits else 0)
    consts: dict = {}

    def megastep(tables, stacked, n_valid, epoch):
        check_env()
        outs, hits, auxes = [], [], []
        for j in range(n_valid.shape[0]):
            arrays = {name: t[j] for name, t in stacked.items()}
            h = None
            if kind == "lanes":
                out, aux, _ = lane_body(tables, arrays, n_valid=n_valid[j],
                                        sync_free=True)
                if with_rule_hits:
                    out, h = out
            else:
                out, aux, _ = _matched_cols(plan, tables, arrays, consts,
                                            sync_free=True)
            outs.append(out)
            hits.append(h if h is not None else torch.zeros(
                (n_hit_cols,), dtype=torch.int32, device=dev))
            auxes.append(aux if aux is not None else torch.zeros(
                (2,), dtype=torch.int32, device=dev))
        aux = torch.stack(auxes)
        return torch.stack(outs), torch.stack(hits), epoch.clone(), aux

    return MegastepProgram(fn=megastep, kind=kind,
                           with_rule_hits=with_rule_hits, plan=plan)


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


class HostResult:
    """A device result whose copy to the host was queued when its batch
    was issued: a pinned host tensor filled by a non-blocking copy, and
    a CUDA event recorded after that copy. `wait()` waits on this event
    alone, so a batch completes as soon as its own result is on the
    host, while later batches' kernels queued behind it run on."""

    __slots__ = ("host", "event")

    def __init__(self, dev: torch.Tensor):
        self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        self.host.copy_(dev, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


def to_host_async(dev):
    """Queue a device result's copy to the host at the end of its issue:
    a `HostResult` for a CUDA tensor; a CPU tensor is already there and
    passes through (the plain path)."""
    if isinstance(dev, torch.Tensor) and dev.device.type == "cuda":
        return HostResult(dev)
    return dev


def _host_array(x) -> np.ndarray:
    if isinstance(x, HostResult):
        return x.wait()
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


def _waited(dev, on_device_wait=None) -> np.ndarray:
    """`_host_array(dev)`, handing the ms it waited to `on_device_wait`."""
    t0 = time.monotonic()
    out = _host_array(dev)
    if on_device_wait is not None:
        on_device_wait((time.monotonic() - t0) * 1e3)
    return out


def finish_batch(plan, dev, batch, lists, on_device_wait=None) -> np.ndarray:
    """Combine a device verdict with the host-interpreted rules. `dev`
    may be a tensor still being computed on the card, or its
    `HostResult`: the host rules run first and `_host_array` then waits
    once, so they overlap the device work (as in the JAX package).
    `on_device_wait` takes that wait's ms."""
    out = _host_matrix(plan, batch, lists)
    dev = _waited(dev, on_device_wait)
    for col, idx in enumerate(plan.device_rule_indices):
        out[:, idx] = dev[:, col]
    return out


def finish_megastep(plan, dev, slices, batch, lists,
                    on_device_wait=None) -> np.ndarray:
    """`finish_batch` for the Python plane's megastep: `dev` is the
    [K, Bs, C] matrix of a kind="matrix" window (or its `HostResult`)
    and `slices` gives each slice j its (row offset, n_valid) span of
    `batch`. Host rules first, then one wait; padding rows past a
    slice's n_valid are never read."""
    out = _host_matrix(plan, batch, lists)
    dev = _waited(dev, on_device_wait)
    cols = plan.device_rule_indices
    for j, (off, nv) in enumerate(slices):
        out[off:off + nv, cols] = dev[j, :nv]
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
