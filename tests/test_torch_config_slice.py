"""The slice from a deployment's files to verdicts, in both packages.

The CRS-style corpus is written as a pingoo deployment (`utils/crs.
deployment`): a pingoo.yml holding most of the rules, a `rules/` folder
holding the rest, the lists as CSV files, and two services with `route:`
predicates. Both packages load it (`load_and_validate`, `load_lists`)
and compile it with the services' routes; the port must give:

  * the same Config and lists as the JAX package, and the corpus itself;
  * the same tables, array for array;
  * the same verdict matrix and lanes on 256 requests at seed 7, bit
    for bit;
  * the same `explain()` payload, key for key, as the JAX package's
    VerdictService (PINGOO_PIPELINE=off, PINGOO_PROVENANCE=0), with
    `stats.snapshot()` of the same keys and counts, and a
    `pipeline_snapshot()` of the same keys.
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml

import pingoo_tpu.config as ref_config
import pingoo_tpu.lists as ref_lists_mod
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import RequestTuple as RefRequestTuple
from pingoo_tpu.engine.batch import bucket_arrays as ref_bucket_arrays
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.engine.service import VerdictService as RefVerdictService
from pingoo_tpu_torch import config as port_config
from pingoo_tpu_torch import lists as port_lists_mod
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine import verdict
from pingoo_tpu_torch.engine.batch import tuple_to_context
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.obs.registry import MetricRegistry
from pingoo_tpu_torch.utils.crs import (deployment, generate_ruleset,
                                        generate_traffic)
from test_torch_config import plain
from test_torch_tables import assert_same_arrays, ref_arrays, ref_meta
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

N_RULES = 500
IN_FOLDER = 150  # the last rules go to rules/corpus.yml
REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_PROVENANCE": "0",
           "PINGOO_SCHED_MODE": "fixed", "PINGOO_MEGASTEP": "off"}


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    root = tmp_path_factory.mktemp("deployment")
    rules, lists = generate_ruleset(N_RULES)
    raw = deployment(rules, lists, str(root))
    names = list(raw["rules"])
    folder = {n: raw["rules"].pop(n) for n in names[-IN_FOLDER:]}
    (root / "rules").mkdir()
    (root / "rules" / "corpus.yml").write_text(
        yaml.safe_dump(folder, sort_keys=False))
    (root / "pingoo.yml").write_text(yaml.safe_dump(raw, sort_keys=False))
    out = {"rules": rules, "lists": lists}
    for name, cfg_mod, lists_mod, compile_ in (
            ("ref", ref_config, ref_lists_mod, ref_compile),
            ("port", port_config, port_lists_mod, compile_ruleset)):
        cfg = cfg_mod.load_and_validate(str(root / "pingoo.yml"))
        loaded = lists_mod.load_lists(cfg.lists)
        routes = [(s.name, s.route) for s in cfg.services]
        kw = {"device": "cpu"} if name == "port" else {}
        out[name] = (cfg, loaded, compile_(cfg.rules, loaded, routes=routes,
                                           **kw))
    return out


def test_config_and_lists_equal_the_jax_packages_and_the_corpus(slice_):
    ref_cfg, ref_lists, _ = slice_["ref"]
    cfg, lists, _ = slice_["port"]
    assert plain(cfg) == plain(ref_cfg)
    assert plain(lists) == plain(ref_lists)
    assert [(r.name, r.expression.source, r.actions) for r in cfg.rules] \
        == [(r.name, r.expression.source, r.actions)
            for r in slice_["rules"]]
    assert {k: [str(v) for v in vals] for k, vals in lists.items()} \
        == {k: [str(v) for v in vals]
            for k, vals in slice_["lists"].items()}
    assert [s.name for s in cfg.services] == ["api", "assets"]
    assert all(s.route is not None for s in cfg.services)


def test_tables_equal_the_jax_packages(slice_):
    ref = slice_["ref"][2]
    port = slice_["port"][2]
    assert list(port.np_tables) == list(ref.np_tables)
    for key, val in ref.np_tables.items():
        assert_same_arrays(key, ref_arrays(val),
                           port.np_tables[key].numpy_arrays())
        assert port.np_tables[key].meta() == ref_meta(val), key
    assert port.route_index == ref.route_index
    assert set(port.route_index) == {"api", "assets"}
    assert [(r.name, r.index, r.host, r.always) for r in port.rules] \
        == [(r.name, r.index, r.host, r.always) for r in ref.rules]


def traffic(slice_, n=256, seed=7):
    return generate_traffic(n, attack_fraction=0.3, seed=seed,
                            lists=slice_["port"][1])


def as_ref(reqs):
    return [RefRequestTuple(**dataclasses.asdict(r)) for r in reqs]


def test_verdicts_equal_the_jax_packages(slice_):
    ref = slice_["ref"][2]
    _, lists, port = slice_["port"]
    reqs = traffic(slice_)
    arrays = ref_bucket_arrays(ref_encode(as_ref(reqs)).arrays)
    tables = ref.device_tables()
    want = np.asarray(ref_verdict.make_verdict_fn(ref)(tables, arrays))
    want_lanes = np.asarray(ref_verdict.make_lane_fn(ref)(tables, arrays))
    got = verdict.make_verdict_fn(port)(port.np_tables, arrays).numpy()
    got_lanes = verdict.make_lane_fn(port)(port.np_tables, arrays).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_lanes, want_lanes)
    # Attacks, list hits and both routes are all in the stream.
    by_name = {r.name: r.index for r in port.rules}
    lists_cols = [i for n, i in by_name.items() if n.startswith("list_")]
    assert got[:, lists_cols].any()
    for name, idx in port.route_index.items():
        col = got[:, idx]
        assert col.any(), name
    # Every column, route columns included, is the interpreter's.
    svc = VerdictService(port, lists, device="cpu")
    matched = np.stack([v.matched for v in svc.evaluate_batch(reqs)])
    oracle = np.stack([verdict.interpret_rules_row(
        port, tuple_to_context(r, lists)) for r in reqs])
    np.testing.assert_array_equal(matched, oracle)
    np.testing.assert_array_equal(matched, got[:len(reqs)])


def explain_picks(slice_):
    """Attacks, list hits and clean requests of the stream."""
    _, lists, port = slice_["port"]
    reqs = traffic(slice_)
    rows = np.stack([verdict.interpret_rules_row(
        port, tuple_to_context(r, lists)) for r in reqs])
    by_name = {r.name: r.index for r in port.rules}
    lists_cols = [i for n, i in by_name.items() if n.startswith("list_")]
    rule_cols = [r.index for r in port.rules if not r.name.startswith(
        "route:")]
    hits = np.nonzero(rows[:, lists_cols].any(axis=1))[0][:2]
    attacks = np.nonzero(rows[:, rule_cols].any(axis=1))[0][:3]
    clean = np.nonzero(~rows[:, rule_cols].any(axis=1))[0][:3]
    return [reqs[i] for i in dict.fromkeys([*hits, *attacks, *clean])]


def test_explain_and_snapshots_equal_the_jax_packages(slice_, loop_runner,
                                                      monkeypatch):
    for k, v in REF_ENV.items():
        monkeypatch.setenv(k, v)
    ref = slice_["ref"]
    _, lists, port = slice_["port"]
    picks = explain_picks(slice_)
    assert len(picks) >= 6
    ref_svc = RefVerdictService(ref[2], ref[1], max_wait_us=100)
    svc = VerdictService(port, lists, max_wait_us=100, device="cpu",
                         registry=MetricRegistry())

    async def flow(service, reqs):
        await service.start()
        try:
            out = []
            for r in reqs:  # one request a batch, in both services
                out.append(await service.explain(r))
            return out
        finally:
            await service.stop()

    want = loop_runner.run(flow(ref_svc, as_ref(picks)), timeout=300)
    got = loop_runner.run(flow(svc, picks), timeout=300)
    assert got == want
    assert all(e["parity"]["consistent"] for e in got)
    assert any(e["action"] == 1 for e in got)
    assert any(e["action"] == 0 for e in got)
    assert any(any(n.startswith("list_") for n in e["matched_rules"])
               for e in got)
    snap, ref_snap = svc.stats.snapshot(), ref_svc.stats.snapshot()
    # The JAX package's keys, and the swap counters and the scheduler's
    # and the ladder's snapshots, which the JAX package keeps on its
    # metric registry.
    assert set(snap) == set(ref_snap) | {"hotswap", "sched", "ladder"}
    assert snap["hotswap"] == {"epoch": 0, "swaps": snap["hotswap"]["swaps"]}
    for key in ("batches", "requests", "mean_occupancy"):
        assert snap[key] == ref_snap[key], key
    assert snap["batches"] == len(picks)
    # Every stage of the port's own registry saw each batch once, but
    # provenance, which the port does not run.
    assert {k: w["count"] for k, w in snap["stages"].items()} == {
        k: 0 if k == "provenance" else len(picks) for k in snap["stages"]}
    pipe, ref_pipe = svc.pipeline_snapshot(), ref_svc.pipeline_snapshot()
    assert set(pipe) == set(ref_pipe)
    assert set(pipe["megastep"]) == set(ref_pipe["megastep"])
    assert set(pipe["stage_occupancy"]) == set(ref_pipe["stage_occupancy"])
    assert (pipe["mode"], pipe["depth"], pipe["batches"]) \
        == ("off", 1, {"off": len(picks)})
