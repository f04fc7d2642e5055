"""The port's metrics against the JAX package's, on the CPU.

  * The same sequence of counter, gauge and histogram calls into both
    packages' `MetricRegistry` renders byte-identical Prometheus text
    and equal JSON and stage snapshots (one seeded sequence per seed of
    the reference's).
  * Every dict and tuple of the two `obs/schema.py` files is equal.
  * The same batches, one of them with duplicate tuples, go through
    each package's Python listener (`HttpListener.handle_request`) and
    its `VerdictService`, under PINGOO_PREFILTER=banks and =compact:
    equal statuses and verdicts, and equal `dedup_hits`, requests,
    `pingoo_requests_total`, `pingoo_prefilter_candidate_rate`,
    `pingoo_scan_banks_skipped_total`, `pingoo_dfa_banks_total{mode}`,
    `pingoo_dfa_recheck_total`, `pingoo_staged_bytes_total{mode}` and
    wait-histogram counts. The JAX package's instruments live on its
    process-wide REGISTRY, so its side is read as deltas; the port's
    service gets a registry of its own.
  * Both planes' boot inventories of the compile ledger's and the cost
    ledger's series (names, label sets, values) are the JAX package's.
  * The megastep's Stage-A aux output: each slice's row is the
    per-batch aux vector of that slice's rows, so summed over the
    slices it is the per-batch vectors' sum, and its candidate lanes
    are those of the whole batch run per batch.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

import pingoo_tpu.obs.schema as ref_schema
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.engine.service import VerdictService as RefService
from pingoo_tpu.host.captcha import CaptchaManager as RefCaptcha
from pingoo_tpu.host.httpd import HttpListener as RefListener
from pingoo_tpu.host.httpd import Request as RefRequest
from pingoo_tpu.obs.registry import REGISTRY as REF_REGISTRY
from pingoo_tpu.obs.registry import MetricRegistry as RefRegistry
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine import verdict
from pingoo_tpu_torch.engine.batch import (RequestBatch, bucket_arrays,
                                           encode_requests, pad_batch)
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.host.captcha import CaptchaManager
from pingoo_tpu_torch.host.httpd import HttpListener, Request
from pingoo_tpu_torch.obs import schema
from pingoo_tpu_torch.obs.registry import MetricRegistry, lint_prometheus_text
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)


# -- the registry -------------------------------------------------------------


def drive_registry(reg, seed: int) -> None:
    """A seeded sequence of every kind of call on `reg`."""
    rng = random.Random(seed)
    names = ["pingoo_a_total", "pingoo_b_total", "x:y_total"]
    gauges = ["pingoo_depth", "pingoo_rate"]
    hists = [("pingoo_wait_ms", (1, 2, 5, 10, 50, 100, 1000)),
             ("pingoo_stage_ms", (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 50.0,
                                  100.0, 1000.0)),
             ("pingoo_verdict_stage_ms", (0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
                                          50.0, 100.0, 1000.0))]
    labelsets = [None, {"plane": "python"}, {"plane": "sidecar"},
                 {"plane": "python", "stage": "encode"},
                 {"plane": "sidecar", "stage": "resolve"},
                 {"plane": "native", "path": 'a"b\\c\nd'}]
    for _ in range(300):
        op = rng.randrange(7)
        lab = rng.choice(labelsets)
        if op == 0:
            reg.counter(rng.choice(names), "a counter",
                        labels=lab).inc(rng.randrange(1, 5))
        elif op == 1:
            reg.counter(rng.choice(names), "", labels=lab).set_total(
                rng.randrange(10**6))
        elif op == 2:
            g = reg.gauge(rng.choice(gauges), "a gauge", labels=lab)
            g.set(rng.choice([rng.randrange(100), rng.random(),
                              float("inf"), -rng.random() * 1e-7, True]))
        elif op == 3:
            g = reg.gauge(rng.choice(gauges), "a gauge", labels=lab)
            (g.inc if rng.random() < 0.5 else g.dec)(rng.choice([1, 0.5]))
        else:
            name, bounds = rng.choice(hists)
            h = reg.histogram(name, "a histogram", buckets=bounds,
                              labels=lab)
            if op == 4:
                h.observe(rng.choice([rng.random() * 20,
                                      rng.randrange(2000),
                                      float(rng.choice(bounds))]))
            elif op == 5:
                h.observe_n(rng.random() * 100, rng.randrange(1, 9))
            else:
                counts = [rng.randrange(50) for _ in range(len(bounds) + 1)]
                h.set_bucket_counts(counts, total_sum=None
                                    if rng.random() < 0.5
                                    else rng.random() * 1e4)


@pytest.mark.parametrize("seed", SEEDS)
def test_registries_render_alike(seed):
    ref, port = RefRegistry(), MetricRegistry()
    drive_registry(ref, seed)
    drive_registry(port, seed)
    text = port.prometheus_text()
    assert text.encode() == ref.prometheus_text().encode()
    assert lint_prometheus_text(text) == []
    assert port.json_snapshot() == ref.json_snapshot()
    assert port.stage_snapshot() == ref.stage_snapshot()


@pytest.mark.parametrize("name", sorted(
    n for n in dir(ref_schema) if n.isupper()))
def test_schema_dicts_equal(name):
    assert getattr(schema, name) == getattr(ref_schema, name)


def test_schema_inventories_equal():
    assert sorted(n for n in dir(schema) if n.isupper()) == \
        sorted(n for n in dir(ref_schema) if n.isupper())
    assert schema.all_metric_names() == ref_schema.all_metric_names()


# -- the Python plane, end to end ---------------------------------------------

ENV = {"PINGOO_PIPELINE": "on", "PINGOO_SCHED_MODE": "fixed",
       "PINGOO_MEGASTEP": "off", "PINGOO_PROVENANCE": "0",
       "PINGOO_STAGING": "full"}
CLEAR = ("PINGOO_DFA", "PINGOO_MESH", "PINGOO_PARITY_SAMPLE", "PINGOO_CHAOS",
         "PINGOO_COST_LEDGER", "PINGOO_BODY_INSPECT", "PINGOO_SCAN_STRATEGY",
         "PINGOO_NFA_SPLIT", "PINGOO_HALO_SPLIT", "PINGOO_MEGASTEP_K",
         "PINGOO_PIPELINE_DEPTH", "PINGOO_SCHED_FAILOPEN",
         "PINGOO_DEADLINE_MS", "PINGOO_STAGING_DEPTH", "PINGOO_PERF_LEDGER",
         "PINGOO_TIMELINE_SAMPLE")
N_RULES = 40
LISTENER = "metrics-parity"
# The series compared, by JSON key: (metric, label key), the JAX
# package's names on both sides.
SERIES = [
    ("pingoo_requests_total", f"listener={LISTENER},plane=python"),
    ("pingoo_blocked_total", f"listener={LISTENER},plane=python"),
    ("pingoo_captcha_total", f"listener={LISTENER},plane=python"),
    ("pingoo_scan_banks_skipped_total", "plane=python"),
    ("pingoo_dfa_banks_total", "mode=auto,plane=python"),
    ("pingoo_dfa_banks_total", "mode=force,plane=python"),
    ("pingoo_dfa_recheck_total", "plane=python"),
    ("pingoo_staged_bytes_total", "mode=full,plane=python"),
    ("pingoo_staged_bytes_total", "mode=compact,plane=python"),
]


def batches_of(reqs, rng):
    """Three batches, the second holding duplicates of its own tuples
    (and of the first batch's, which dedup leaves alone: it works within
    one batch)."""
    first, second, third = reqs[:16], list(reqs[16:28]), reqs[28:48]
    second += [second[i] for i in (0, 0, 3, 5)] + [first[2]]
    rng.shuffle(second)
    return [first, second, third]


def series(snap, name, key):
    v = snap.get(name, {})
    return v.get(key, 0) if isinstance(v, dict) else v


def wait_count(snap):
    h = snap.get(schema.SHARED_WAIT_HISTOGRAM, {}).get("plane=python")
    return 0 if h is None else h["count"]


async def drive(listener, service, request_cls, batches, registry):
    """Each batch through `listener` at once, so that it rides one
    collector batch. Returns the responses and, from after the
    service's start (the JAX package's start() serves a warm-up batch,
    the port's does not) to the end, the service's snapshot and the
    registry's JSON snapshot."""
    await service.start()
    try:
        before = service.stats.snapshot(), registry.json_snapshot()
        out = []
        for batch in batches:
            resps = await asyncio.gather(*[
                listener.handle_request(request_cls(
                    method=r.method, target=r.url, path=r.path,
                    headers=[("host", r.host), ("user-agent", r.user_agent)]),
                    (r.ip, 40000))
                for r in batch])
            out.append([(r.status, bytes(r.body)) for r in resps])
        return out, before, (service.stats.snapshot(),
                             registry.json_snapshot())
    finally:
        await service.stop()


def delta(after, before, name, key):
    return series(after, name, key) - series(before, name, key)


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("pf_mode", ["banks", "compact"])
def test_python_plane_counts_equal_the_jax_packages(
        seed, pf_mode, monkeypatch, tmp_path):
    for name in CLEAR:
        monkeypatch.delenv(name, raising=False)
    for name, value in {**ENV, "PINGOO_PREFILTER": pf_mode}.items():
        monkeypatch.setenv(name, value)
    # Both packages' cost ledgers under tmp_path, never at the repo root.
    monkeypatch.setenv("PINGOO_COST_LEDGER", str(tmp_path / "costs.json"))
    rules, lists = generate_ruleset(N_RULES, seed=seed, list_sizes=(64, 16))
    ref_rules, ref_lists = ref_generate_ruleset(N_RULES, seed=seed,
                                                list_sizes=(64, 16))
    assert [r.name for r in rules] == [r.name for r in ref_rules]
    plan = compile_ruleset(rules, lists, device="cpu")
    ref_plan = ref_compile(ref_rules, ref_lists)
    reqs = generate_traffic(48, attack_fraction=0.5, seed=seed, lists=lists)
    ref_reqs = ref_generate_traffic(48, attack_fraction=0.5, seed=seed,
                                    lists=ref_lists)
    assert [(r.url, r.user_agent, r.ip) for r in reqs] == \
        [(r.url, r.user_agent, r.ip) for r in ref_reqs]
    batches = batches_of(reqs, random.Random(seed))
    ref_batches = batches_of(ref_reqs, random.Random(seed))
    dups = sum(len(b) - len({(r.method, r.path, r.url, r.host, r.user_agent,
                               r.ip) for r in b}) for b in batches)
    assert dups >= 4

    registry = MetricRegistry()
    service = VerdictService(plan, lists, max_batch=64, max_wait_us=0,
                             device="cpu", registry=registry)
    listener = HttpListener(LISTENER, "127.0.0.1", 0, [], service, lists,
                            plan.rules,
                            CaptchaManager(jwks_path=str(tmp_path / "a.json")))
    ref_service = RefService(ref_plan, ref_lists, max_batch=64,
                             max_wait_us=0)
    ref_listener = RefListener(LISTENER, "127.0.0.1", 0, [], ref_service,
                               ref_lists, ref_plan.rules,
                               RefCaptcha(jwks_path=str(tmp_path / "b.json")))
    try:
        got, (s0, m0), (s1, m1) = asyncio.run(
            drive(listener, service, Request, batches, registry))
        want, (r0, n0), (r1, n1) = asyncio.run(
            drive(ref_listener, ref_service, RefRequest, ref_batches,
                  REF_REGISTRY))
    finally:
        REF_REGISTRY.unregister_collector(ref_listener._export_metrics)
        asyncio.run(listener.close())
    assert got == want
    for key in ("batches", "requests", "dedup_hits", "scan_banks_skipped",
                "dfa_banks", "dfa_rechecks"):
        assert s1[key] - s0[key] == r1[key] - r0[key], key
    assert s1["prefilter_candidate_rate"] == r1["prefilter_candidate_rate"]
    assert (s1["batches"], s1["requests"], s1["dedup_hits"]) == (
        3, sum(map(len, batches)), dups)
    for name, key in SERIES:
        assert delta(m1, m0, name, key) == delta(n1, n0, name, key), \
            (name, key)
    assert delta(m1, m0, "pingoo_requests_total",
                 f"listener={LISTENER},plane=python") == s1["requests"]
    assert series(m1, "pingoo_prefilter_candidate_rate", "plane=python") \
        == series(n1, "pingoo_prefilter_candidate_rate", "plane=python")
    assert wait_count(m1) - wait_count(m0) == \
        wait_count(n1) - wait_count(n0) == s1["requests"]
    assert s1["scan_banks_skipped"] and s1["dfa_banks"]
    assert delta(m1, m0, "pingoo_staged_bytes_total",
                 "mode=full,plane=python") > 0
    assert lint_prometheus_text(registry.prometheus_text()) == []


# -- the ledgers' boot inventory ----------------------------------------------

LEDGER_SERIES = ("pingoo_compile_total", "pingoo_compile_ms",
                 "pingoo_compile_unexpected_total",
                 "pingoo_costmodel_reload_total")


def ledger_series(snap, plane):
    """{(metric, label key): value} of the ledgers' series of `plane` in
    a registry's JSON snapshot (a histogram by its count)."""
    out = {}
    for name in LEDGER_SERIES:
        for key, v in snap.get(name, {}).items():
            if f"plane={plane}" in key.split(","):
                out[(name, key)] = v["count"] if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("plane", ["python", "sidecar"])
def test_ledgers_boot_inventory_equals_the_jax_packages(plane, monkeypatch,
                                                        tmp_path):
    """A plane's boot creates the compile ledger's series (every fn and
    kind, at zero) and the cost ledger's reload series (one count of
    `missing` here), with the JAX package's names, labels and values."""
    for name in CLEAR:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PINGOO_PROVENANCE", "0")
    monkeypatch.setenv("PINGOO_COST_LEDGER", str(tmp_path / "none.json"))
    rules, lists = generate_ruleset(N_RULES, seed=7, list_sizes=(64, 16))
    ref_rules, ref_lists = ref_generate_ruleset(N_RULES, seed=7,
                                                list_sizes=(64, 16))
    plan = compile_ruleset(rules, lists, device="cpu")
    ref_plan = ref_compile(ref_rules, ref_lists)
    registry = MetricRegistry()
    before = ledger_series(REF_REGISTRY.json_snapshot(), plane)
    if plane == "python":
        VerdictService(plan, lists, device="cpu", registry=registry)
        RefService(ref_plan, ref_lists, use_device=False)
    else:
        from pingoo_tpu import native_ring as ref_nr
        from pingoo_tpu_torch import native_ring as nr

        rings = [nr.Ring(str(tmp_path / "port"), capacity=64, create=True),
                 ref_nr.Ring(str(tmp_path / "ref"), capacity=64,
                             create=True)]
        try:
            nr.RingSidecar(rings[0], plan, lists, device="cpu",
                           registry=registry)
            ref_nr.RingSidecar(rings[1], ref_plan, ref_lists)
        finally:
            for ring in rings:
                ring.close()
    got = ledger_series(registry.json_snapshot(), plane)
    after = ledger_series(REF_REGISTRY.json_snapshot(), plane)
    assert got == {k: v - before.get(k, 0) for k, v in after.items()}
    assert sorted(v for v in got.values()) == [0] * (len(got) - 1) + [1]
    assert got[("pingoo_costmodel_reload_total",
                f"plane={plane},result=missing")] == 1
    assert len(got) == 5 * 2 + 5 + 4
    assert lint_prometheus_text(registry.prometheus_text()) == []


# -- the megastep's aux output ------------------------------------------------


@pytest.fixture(scope="module")
def small_plan():
    rules, lists = generate_ruleset(N_RULES, seed=7, list_sizes=(64, 16))
    return compile_ruleset(rules, lists, device="cpu"), lists


@pytest.mark.parametrize("kind", ["matrix", "lanes"])
@pytest.mark.parametrize("seed", SEEDS)
def test_megastep_aux_sums_to_the_per_batch_aux(small_plan, kind, seed,
                                                monkeypatch):
    for name in ("PINGOO_PREFILTER", "PINGOO_DFA", "PINGOO_SCAN_STRATEGY"):
        monkeypatch.delenv(name, raising=False)
    plan, lists = small_plan
    K, rows = 4, 8
    reqs = generate_traffic(K * rows, attack_fraction=0.5, seed=seed,
                            lists=lists)
    batch = encode_requests(reqs, plan.field_specs)
    fast = pad_batch(RequestBatch(size=len(reqs),
                                  arrays=bucket_arrays(batch.arrays)),
                     K * rows)
    arrays = {k: torch.as_tensor(np.ascontiguousarray(v))
              for k, v in fast.arrays.items()}
    stacked = {k: v.reshape(K, rows, *v.shape[1:]) for k, v in arrays.items()}
    nv = torch.full((K,), rows, dtype=torch.int32)
    ep = torch.zeros((K,), dtype=torch.int32)
    mega = verdict.make_megastep_fn(plan, kind=kind)
    out = mega.fn(plan.np_tables, stacked, nv, ep)
    aux = out[3].numpy()
    L = verdict.prefilter_aux_len(plan)
    assert L > 2 and aux.shape == (K, L) and aux.dtype == np.int32
    verdict_fn = verdict.make_verdict_program(plan)
    per_slice = np.stack([
        verdict_fn(plan.np_tables,
                   {k: v[j] for k, v in stacked.items()})[1].numpy()
        for j in range(K)])
    np.testing.assert_array_equal(aux, per_slice)
    whole_matrix, whole, _ = verdict_fn(plan.np_tables, arrays)
    whole = whole.numpy()
    gated, masked = verdict.prefilter_aux_banks(plan)
    m = len(masked)
    summed = aux.sum(axis=0)
    # Candidate rows add up over the slices; a bank is skipped per slice.
    assert summed[0] == whole[0]
    np.testing.assert_array_equal(summed[2:2 + m], whole[2:2 + m])
    assert whole[1] == (len(gated) - m) + int((whole[2:2 + m] == 0).sum())
    np.testing.assert_array_equal(whole[2 + m:], whole[2:2 + m] == 0)
    # And the slices' verdicts are the per-batch path's.
    if kind == "matrix":
        np.testing.assert_array_equal(
            out[0].reshape(K * rows, -1).numpy(), whole_matrix.numpy())
