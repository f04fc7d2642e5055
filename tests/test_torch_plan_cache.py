"""The compiled-ruleset artifact cache (compiler/cache.py) and the
lowering obligations (compiler/obligations.py) in the port: the
counterparts of tests/test_plan_cache.py and of the plan- and
proof-block parts of tests/test_obligations.py, against the JAX
package.

  * The cache: a hit skips the compiler and gives the fresh compile's
    tables and verdicts; the fingerprint is sensitive to rules, lists,
    tenant, field specs and the plan-shaping knobs, and differs from the
    JAX package's (both packages' artifacts sit side by side in one
    directory, each loading its own); a corrupt artifact is ignored; an
    artifact's tables are on the CPU and the caller's plan is not moved.
  * The proof block: a valid block skips the re-prove, a tampered or
    absent one forces it, it pins its fingerprint, PINGOO_PROVE=off
    skips proving, and a failed obligation refuses the plan.
  * The obligations: `prove_plan` and `prove_body_plan` give the JAX
    package's names, subjects, results and details on the same rules
    (the 80-rule corpus with lists, with and without PINGOO_NFA_SPLIT,
    and both body rule sets), and a narrowed staging cap is refused.

CPU only.
"""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

from pingoo_tpu.compiler import cache as ref_cache
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.compiler import obligations as ref_ob
from pingoo_tpu.engine import bodyscan as ref_bs
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu_torch.compiler import cache as cache_mod
from pingoo_tpu_torch.compiler import obligations as ob
from pingoo_tpu_torch.compiler import plan as plan_mod
from pingoo_tpu_torch.compiler.cache import (compile_ruleset_cached,
                                             ruleset_fingerprint,
                                             update_cached_plan)
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine import bodyscan as bs
from pingoo_tpu_torch.engine.batch import (RequestBatch, bucket_arrays,
                                           encode_requests)
from pingoo_tpu_torch.engine.verdict import finish_batch, make_verdict_fn
from pingoo_tpu_torch.expr import Ip, compile_expression
from pingoo_tpu_torch.utils.crs import (LFI_RCE_CORES, SQLI_CORES, XSS_CORES,
                                        generate_ruleset, generate_traffic)

torch.set_num_threads(1)

CLEARED_ENV = ("PINGOO_PROVE", "PINGOO_NFA_SPLIT", "PINGOO_HALO_FP_BUDGET",
               "PINGOO_DFA_LOWER", "PINGOO_STAGING", "PINGOO_STAGING_DEPTH",
               "PINGOO_BODY_RULES", "PINGOO_BODY_WINDOW")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def tables_of(plan) -> dict:
    return {k: v.numpy_arrays() for k, v in plan.np_tables.items()}


def assert_tables_equal(a, b):
    ta, tb = tables_of(a), tables_of(b)
    assert sorted(ta) == sorted(tb)
    for key in ta:
        assert sorted(ta[key]) == sorted(tb[key]), key
        for name, arr in ta[key].items():
            np.testing.assert_array_equal(arr, tb[key][name],
                                          err_msg=f"{key}.{name}")
    for key in a.np_tables:
        assert a.np_tables[key].meta() == b.np_tables[key].meta(), key


def matched(plan, lists, reqs):
    arrays = bucket_arrays(encode_requests(reqs, plan.field_specs).arrays)
    return finish_batch(plan, make_verdict_fn(plan)(plan.np_tables, arrays),
                        RequestBatch(size=len(reqs), arrays=arrays), lists)


def count_calls(monkeypatch, name):
    real = getattr(cache_mod, name)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(cache_mod, name, counted)
    return calls


def rule(src, name="r"):
    return RuleConfig(name=name, actions=(Action.BLOCK,),
                      expression=compile_expression(src))


# -- the cache ------------------------------------------------------------------


def test_cache_roundtrip_same_tables_and_verdicts(tmp_path, monkeypatch):
    rules, lists = generate_ruleset(80, with_lists=True, list_sizes=(64, 16))
    cache = str(tmp_path / "cache")
    plan1 = compile_ruleset_cached(rules, lists, cache_dir=cache,
                                   device="cpu")
    calls = count_calls(monkeypatch, "compile_ruleset")
    plan2 = compile_ruleset_cached(rules, lists, cache_dir=cache,
                                   device="cpu")
    assert calls == []  # the artifact's hit skipped the compiler
    assert plan2 is not plan1 and plan2.device.type == "cpu"
    fresh = compile_ruleset(rules, lists, device="cpu")
    assert_tables_equal(plan2, fresh)
    assert plan2.stats == fresh.stats
    assert plan2.staging_caps == fresh.staging_caps
    reqs = generate_traffic(32, lists=lists, seed=9)
    np.testing.assert_array_equal(matched(plan1, lists, reqs),
                                  matched(plan2, lists, reqs))
    np.testing.assert_array_equal(matched(plan2, lists, reqs),
                                  matched(fresh, lists, reqs))


def test_artifact_holds_cpu_tables_and_leaves_the_plan(tmp_path):
    rules, lists = generate_ruleset(10, with_lists=False)
    plan = compile_ruleset(rules, lists, device="cpu")
    before = {k: id(v) for k, v in plan.np_tables.items()}
    path = update_cached_plan(rules, lists, plan, str(tmp_path))
    assert {k: id(v) for k, v in plan.np_tables.items()} == before
    with open(path, "rb") as f:
        doc = pickle.load(f)
    stored = doc["plan"]
    assert stored is not plan and stored.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in stored.np_tables.values())
    assert doc["fingerprint"] == ruleset_fingerprint(rules, lists)
    assert doc["plan_proof"]["ok"] is True
    assert_tables_equal(stored, plan)


def test_fingerprint_sensitivity(monkeypatch):
    r1 = [rule('http_request.path == "/a"')]
    r2 = [rule('http_request.path == "/b"')]
    l1 = {"ips": [Ip("10.0.0.0/8")]}
    l2 = {"ips": [Ip("10.0.0.0/9")]}
    base = ruleset_fingerprint(r1, l1)
    assert base == ruleset_fingerprint(r1, l1)
    assert base != ruleset_fingerprint(r2, l1)
    assert base != ruleset_fingerprint(r1, l2)
    assert base != ruleset_fingerprint(r1, l1, tenant="acme")
    assert base != ruleset_fingerprint(r1, l1, field_specs={"path": 64})
    monkeypatch.setenv("PINGOO_NFA_SPLIT", "1")
    assert base != ruleset_fingerprint(r1, l1)


def test_split_config_token_equals_the_reference(monkeypatch):
    from pingoo_tpu.compiler.plan import split_config_token as ref_token

    for env in ({}, {"PINGOO_NFA_SPLIT": "1"},
                {"PINGOO_HALO_FP_BUDGET": "9", "PINGOO_DFA_LOWER": "0"}):
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        assert plan_mod.split_config_token() == ref_token()


def test_packages_keep_their_own_artifacts(tmp_path):
    """One directory, both packages: the port's fingerprint is not the
    JAX package's for the same rules, so neither overwrites the other's
    artifact, and each hit loads its own package's plan."""
    cache = str(tmp_path)
    ref_rules, ref_lists = ref_generate_ruleset(10, with_lists=False)
    rules, lists = generate_ruleset(10, with_lists=False)
    ref_fp = ref_cache.ruleset_fingerprint(ref_rules, ref_lists)
    assert ruleset_fingerprint(rules, lists) != ref_fp
    ref_cache.compile_ruleset_cached(ref_rules, ref_lists, cache_dir=cache)
    compile_ruleset_cached(rules, lists, cache_dir=cache, device="cpu")
    assert len(os.listdir(cache)) == 2
    again = compile_ruleset_cached(rules, lists, cache_dir=cache,
                                   device="cpu")
    assert isinstance(again, plan_mod.RulesetPlan)
    ref_again = ref_cache.compile_ruleset_cached(ref_rules, ref_lists,
                                                 cache_dir=cache)
    assert not isinstance(ref_again, plan_mod.RulesetPlan)


def test_corrupt_artifact_ignored(tmp_path):
    rules, lists = generate_ruleset(10, with_lists=False)
    cache = str(tmp_path / "cache")
    plan1 = compile_ruleset_cached(rules, lists, cache_dir=cache,
                                   device="cpu")
    for name in os.listdir(cache):
        with open(os.path.join(cache, name), "wb") as f:
            f.write(b"garbage")
    plan2 = compile_ruleset_cached(rules, lists, cache_dir=cache,
                                   device="cpu")
    assert plan2.stats == plan1.stats
    assert_tables_equal(plan2, plan1)


def test_no_cache_dir_compiles(monkeypatch):
    rules, lists = generate_ruleset(10, with_lists=False)
    calls = count_calls(monkeypatch, "compile_ruleset")
    proves = count_calls(monkeypatch, "prove_plan")
    compile_ruleset_cached(rules, lists, device="cpu")
    assert calls == [1] and proves == []


# -- the proof block ------------------------------------------------------------


def one_artifact(cache):
    path = os.path.join(cache, os.listdir(cache)[0])
    with open(path, "rb") as f:
        return path, pickle.load(f)


def test_valid_proof_block_skips_reprove(tmp_path, monkeypatch):
    rules, lists = generate_ruleset(10, with_lists=False)
    cache = str(tmp_path)
    calls = count_calls(monkeypatch, "prove_plan")
    compile_ruleset_cached(rules, lists, cache_dir=cache, device="cpu")
    assert len(calls) == 1
    compile_ruleset_cached(rules, lists, cache_dir=cache, device="cpu")
    assert len(calls) == 1


@pytest.mark.parametrize("damage", ["tampered", "absent"])
def test_damaged_proof_block_forces_reprove(tmp_path, monkeypatch, damage):
    rules, lists = generate_ruleset(10, with_lists=False)
    cache = str(tmp_path)
    compile_ruleset_cached(rules, lists, cache_dir=cache, device="cpu")
    path, doc = one_artifact(cache)
    assert doc["plan_proof"]["ok"] is True
    if damage == "tampered":
        doc["plan_proof"]["obligations"][0]["name"] = "tampered"
    else:
        del doc["plan_proof"]
    with open(path, "wb") as f:
        pickle.dump(doc, f)
    calls = count_calls(monkeypatch, "prove_plan")
    compile_ruleset_cached(rules, lists, cache_dir=cache, device="cpu")
    assert len(calls) == 1
    # The re-proved block was written back: the next hit is clean.
    compile_ruleset_cached(rules, lists, cache_dir=cache, device="cpu")
    assert len(calls) == 1
    assert ob.proof_block_valid(one_artifact(cache)[1]["plan_proof"],
                                doc["fingerprint"])


def test_proof_block_pins_fingerprint(tmp_path):
    rules, lists = generate_ruleset(10, with_lists=False)
    compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path),
                           device="cpu")
    _, doc = one_artifact(str(tmp_path))
    block, fp = doc["plan_proof"], doc["fingerprint"]
    assert ob.proof_block_valid(block, fp)
    assert not ob.proof_block_valid(block, "deadbeef" + fp[8:])
    assert not ob.proof_block_valid(None, fp)


def test_prove_off_skips_proving(tmp_path, monkeypatch):
    monkeypatch.setenv("PINGOO_PROVE", "off")
    rules, lists = generate_ruleset(10, with_lists=False)
    calls = count_calls(monkeypatch, "prove_plan")
    compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path),
                           device="cpu")
    compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path),
                           device="cpu")
    assert calls == []
    assert "plan_proof" not in one_artifact(str(tmp_path))[1]


def test_failed_obligation_refuses_the_plan(tmp_path, monkeypatch):
    rules, lists = generate_ruleset(10, with_lists=False)

    def failing(plan, fingerprint=""):
        return ob.PlanProof(fingerprint=fingerprint, obligations=[
            ob.Obligation("staging-caps", "caps", "failed", "narrowed")])

    monkeypatch.setattr(cache_mod, "prove_plan", failing)
    with pytest.raises(ob.ObligationError, match="staging-caps"):
        compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path),
                               device="cpu")
    assert os.listdir(str(tmp_path)) == []


def test_proof_block_round_trip_and_tampering():
    proof = ob.PlanProof(fingerprint="fp", obligations=[
        ob.Obligation("staging-caps", "caps", "proved", "detail")])
    block = proof.to_dict()
    assert ob.proof_block_valid(block, "fp") and ob.proof_block_valid(block,
                                                                      "")
    assert ob.PlanProof.from_dict(block).to_dict() == block
    assert block["digest"] == ref_ob.PlanProof.from_dict(block).to_dict()[
        "digest"]
    assert not ob.proof_block_valid(dict(block, digest="0" * 64), "fp")
    assert not ob.proof_block_valid(dict(block, format=0), "fp")
    assert not ob.proof_block_valid(block, "other")
    failed = ob.PlanProof(fingerprint="fp", obligations=[
        ob.Obligation("staging-caps", "caps", "failed", "detail")])
    assert not ob.proof_block_valid(failed.to_dict(), "fp")
    with pytest.raises(ob.ObligationError) as ei:
        ob.require(failed)
    assert ei.value.proof.counts()["failed"] == 1


# -- the obligations against the JAX package -------------------------------------


def ledger(proof):
    return [(o.name, o.subject, o.status, o.detail) for o in proof.obligations]


@pytest.mark.parametrize("split", [None, "1"])
def test_prove_plan_equals_the_reference(monkeypatch, split):
    if split:
        monkeypatch.setenv("PINGOO_NFA_SPLIT", split)
    ref_rules, ref_lists = ref_generate_ruleset(80, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(80, with_lists=True, list_sizes=(64, 16))
    ref = ref_compile(ref_rules, ref_lists)
    port = compile_ruleset(rules, lists, device="cpu")
    want = ref_ob.prove_plan(ref, fingerprint="fp80")
    got = ob.prove_plan(port, fingerprint="fp80")
    assert got.ok and want.ok
    assert ledger(got) == ledger(want)
    names = {o.name for o in got.obligations}
    assert {"bank-reconstruction", "prefilter-necessity",
            "dfa-containment", "staging-caps"} <= names
    if split:
        assert any(e.split for e in port.scan_plans.values())
    assert got.to_dict()["digest"] == want.to_dict()["digest"]


@pytest.mark.parametrize("name", ["seed", "crs"])
def test_prove_body_plan_equals_the_reference(name):
    def rules(mod):
        if name == "seed":
            return mod.DEFAULT_BODY_RULES
        return tuple(mod.BodyRule(f"crs-{i}", p, "regex", False, ("block",))
                     for i, p in enumerate(SQLI_CORES + XSS_CORES
                                           + LFI_RCE_CORES))

    window = 64 if name == "seed" else 128
    want = ref_ob.prove_body_plan(ref_bs.compile_body_plan(rules(ref_bs),
                                                           window=window))
    got = ob.prove_body_plan(bs.compile_body_plan(rules(bs), window=window,
                                                  device="cpu"))
    assert ledger(got) == ledger(want)
    assert got.ok
    assert {"body-carry-closure", "body-tables"} <= {
        o.name for o in got.obligations}


def test_narrowed_staging_cap_refused():
    rules, lists = generate_ruleset(20, with_lists=False)
    plan = compile_ruleset(rules, lists, device="cpu")
    m = copy.copy(plan)
    m.staging_caps = dict(plan.staging_caps)
    f = next(iter(plan.field_specs))
    m.staging_caps[f] = int(plan.field_specs[f]) + 1  # past the spec
    failed = [o for o in ob.check_staging(m) if o.status == "failed"]
    assert failed and f in failed[0].detail
    with pytest.raises(ob.ObligationError):
        ob.require(ob.prove_plan(m))


def test_host_copies_keep_the_reference_dtypes():
    """The checkers read uint32 words as uint32 (a word with bit 31 set
    is a large positive integer), through copies of the tables."""
    rules, lists = generate_ruleset(40, with_lists=False)
    plan = compile_ruleset(rules, lists, device="cpu")
    dfa = next(plan.np_tables[e.dfa_key] for e in plan.scan_plans.values()
               if e.dfa_key)
    host = ob._host_table(dfa)
    assert host.step_accept.dtype == np.uint32
    assert host.num_states == dfa.num_states and host.exact == dfa.exact
    assert ob._host_table(host) is host
