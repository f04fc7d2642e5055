"""Compiled-ruleset artifact cache (the JAX package's `compiler/cache.py`).

A restart skips recompiling a large ruleset (regex parsing, NFA
packing, DFA lowering, bitsets over long lists): `compile_ruleset_cached`
keys a pickled `RulesetPlan` by a fingerprint of the rule sources,
actions, routes, list contents, field specs, the plan-shaping knobs
(`split_config_token`) and the format. The cache directory is private to
the server; an artifact loads only when its fingerprint matches, so a
stale, corrupt or foreign file is ignored.

An artifact stores the plan's tables on the CPU, and a hit places them
on the requested device. The fingerprint follows the JAX package's
recipe under this package's own format tag, so one cache directory can
hold both packages' artifacts without either overwriting the other's.

Every artifact carries a `plan_proof` block, the discharged soundness
obligations of compiler/obligations.py, digest-sealed. A hit with a
valid proof is also a proof hit; a missing or tampered block forces a
re-prove of the loaded plan, and a plan that fails its obligations is
refused (ObligationError), never cached or served. PINGOO_PROVE=off
skips proving.
"""

from __future__ import annotations

import copy
import hashlib
import os
import pickle
from typing import Optional

import torch

from ..config.schema import RuleConfig
from ..device import resolve_device
from ..expr.values import Ip
from .obligations import PlanProof, proof_block_valid, prove_plan, require
from .plan import RulesetPlan, compile_ruleset, split_config_token

# The JAX package's format version, under this package's tag: bump the
# version when the plan or table layout changes.
FORMAT_VERSION = 12
FORMAT_TAG = f"pingoo_tpu_torch/{FORMAT_VERSION}"


def _prove_enabled() -> bool:
    return os.environ.get("PINGOO_PROVE", "on").lower() not in (
        "off", "0", "no", "false")


def ruleset_fingerprint(rules: list[RuleConfig], lists: dict,
                        field_specs=None, routes=None,
                        tenant: str = "") -> str:
    from .lowering import DEFAULT_FIELD_SPECS

    h = hashlib.sha256()
    h.update(FORMAT_TAG.encode())
    if tenant:
        # Identical rulesets of different tenants stay distinct
        # artifacts; an empty tenant hashes nothing.
        h.update(b"\x04tenant:" + tenant.encode() + b"\x05")
    # The plan-shaping knobs change the tables, so they are part of
    # the identity.
    h.update(split_config_token().encode())
    h.update(repr(sorted((field_specs or DEFAULT_FIELD_SPECS).items())).encode())
    for rule in rules:
        h.update(rule.name.encode())
        h.update((rule.expression.source if rule.expression else "").encode())
        h.update(",".join(a.value for a in rule.actions).encode())
        h.update(b"\x00")
    for name, program in routes or []:
        h.update(b"\x02" + name.encode() + b"\x03")
        h.update((program.source if program else "").encode())
        h.update(b"\x00")
    for name in sorted(lists):
        h.update(name.encode())
        for item in lists[name]:
            if isinstance(item, Ip):
                h.update(str(item).encode())
            else:
                h.update(repr(item).encode())
            h.update(b"\x01")
    return h.hexdigest()


def _artifact_path(cache_dir: str, fingerprint: str) -> str:
    return os.path.join(cache_dir, f"ruleset-{fingerprint[:32]}.plan")


def compile_ruleset_cached(
    rules: list[RuleConfig],
    lists: dict,
    cache_dir: Optional[str] = None,
    field_specs=None,
    routes=None,
    tenant: str = "",
    device=None,
) -> RulesetPlan:
    """compile_ruleset with a transparent on-disk artifact cache; the
    plan's tables on `device` (default: the CUDA card).

    The cached path is also the proved path: a fresh compile discharges
    the obligations before the artifact is written (a failure raises
    ObligationError), and a hit re-proves only when the stored
    plan_proof block is missing or fails its digest or fingerprint."""
    dev = resolve_device(device)
    if cache_dir is None:
        return compile_ruleset(rules, lists, field_specs, routes=routes,
                               device=dev)
    fingerprint = ruleset_fingerprint(rules, lists, field_specs,
                                      routes=routes, tenant=tenant)
    path = _artifact_path(cache_dir, fingerprint)
    plan, proof_block = _load(path, fingerprint)
    if plan is not None:
        if _prove_enabled() and not proof_block_valid(proof_block,
                                                      fingerprint):
            # A tampered or absent proof: re-prove the loaded plan (the
            # same plan gives the verdicts a fresh compile would).
            proof = require(prove_plan(plan, fingerprint))
            _save(path, fingerprint, plan, proof)
        return plan.to(dev)
    plan = compile_ruleset(rules, lists, field_specs, routes=routes,
                           device=dev)
    proof = None
    if _prove_enabled():
        proof = require(prove_plan(plan, fingerprint))
    _save(path, fingerprint, plan, proof)
    return plan


def update_cached_plan(
    rules: list[RuleConfig],
    lists: dict,
    plan: RulesetPlan,
    cache_dir: str,
    field_specs=None,
    routes=None,
    tenant: str = "",
) -> str:
    """Re-persist a (mutated) plan under its ruleset fingerprint, re-proved
    first so that a stored proof always covers the stored plan; returns
    the artifact's path."""
    fingerprint = ruleset_fingerprint(rules, lists, field_specs,
                                      routes=routes, tenant=tenant)
    path = _artifact_path(cache_dir, fingerprint)
    proof = None
    if _prove_enabled():
        proof = require(prove_plan(plan, fingerprint))
    _save(path, fingerprint, plan, proof)
    return path


def _save(path: str, fingerprint: str, plan: RulesetPlan,
          proof: Optional[PlanProof] = None) -> None:
    """Write the artifact atomically, its tables on the CPU (a copy of
    the plan: the caller's tables stay on their device). Best effort: an
    unwritable cache is no error."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cpu = torch.device("cpu")
        stored = copy.copy(plan)
        stored.np_tables = {k: v.to(cpu) for k, v in plan.np_tables.items()}
        stored.device = cpu
        doc = {"fingerprint": fingerprint, "plan": stored}
        if proof is not None:
            doc["plan_proof"] = proof.to_dict()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(doc, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except (OSError, pickle.PicklingError):
        pass


def _load(path: str,
          fingerprint: str) -> tuple[Optional[RulesetPlan], Optional[dict]]:
    """(plan with CPU tables, proof block), or (None, None) for a missing,
    unreadable, foreign or mismatched artifact."""
    try:
        with open(path, "rb") as f:
            doc = pickle.load(f)
        if doc.get("fingerprint") != fingerprint:
            return None, None
        plan = doc.get("plan")
        if not isinstance(plan, RulesetPlan):
            return None, None
        return plan, doc.get("plan_proof")
    except Exception:
        return None, None
