"""The PyTorch port's verdict path against the JAX package, end to end.

  * The 500-rule CRS-style plan at B=128, five traffic seeds with 30%
    attacks: the port's [B, R] match matrix and [3 + G, B] action lanes
    equal the JAX package's make_verdict_fn / make_lane_fn output, and
    the interpreter (`execute_as_bool`) on every (rule, request).
  * PINGOO_DFA=off|auto|force x PINGOO_PREFILTER=off|banks on a 60-rule
    corpus: both packages agree in every mode.
  * The parity rule set with host-interpreted rules and service routes:
    lanes, host lanes and merged actions agree.
  * VerdictService.evaluate on device="cpu" answers with the reference's
    Verdict fields and values, also under the knob values the port runs
    as the JAX package does (PINGOO_PIPELINE=off, a strategy pin).

All on CPU tensors (the kernels' plain versions); the tolerance is zero.
"""

import asyncio
import dataclasses
import random

import numpy as np
import pytest
import torch

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import bucket_arrays as ref_bucket_arrays
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.engine.service import Verdict as RefVerdict
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine import verdict
from pingoo_tpu_torch.engine.batch import (RequestBatch, RequestTuple,
                                           batch_to_contexts, encode_requests)
from pingoo_tpu_torch.engine.service import Verdict, VerdictService
from pingoo_tpu_torch.expr import Ip, compile_expression, execute_as_bool
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
from test_parity import HOST_FALLBACK_SOURCES, LISTS, RULE_SOURCES, \
    random_requests

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
MODES = [(d, p) for d in ("off", "auto", "force") for p in ("off", "banks")]


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


@pytest.fixture(scope="module")
def crs500():
    ref_rules, ref_lists = ref_generate_ruleset(500)
    rules, lists = generate_ruleset(500)
    ref = ref_compile(ref_rules, ref_lists)
    port = compile_ruleset(rules, lists, device="cpu")
    return (ref, ref.device_tables(), ref_verdict.make_verdict_fn(ref),
            ref_verdict.make_lane_fn(ref), port, rules, lists, ref_lists)


@pytest.mark.parametrize("seed", SEEDS)
def test_crs500_matrix_and_lanes(crs500, seed):
    ref, ref_tables, ref_vfn, ref_lfn, port, rules, lists, ref_lists = crs500
    reqs = ref_generate_traffic(128, attack_fraction=0.3, seed=seed,
                                lists=ref_lists)
    arrays = ref_bucket_arrays(ref_encode(reqs).arrays)
    want = np.asarray(ref_vfn(ref_tables, arrays))
    want_lanes = np.asarray(ref_lfn(ref_tables, arrays))
    got = verdict.make_verdict_fn(port)(port.np_tables, arrays).numpy()
    got_lanes = verdict.make_lane_fn(port)(port.np_tables, arrays).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_lanes, want_lanes)
    assert got.any(), "the attack traffic must match some rules"
    # ... and the interpreter, over the bytes the device saw.
    batch = RequestBatch(size=128, arrays=arrays)
    matched = verdict.finish_batch(port, got, batch, lists)
    contexts = batch_to_contexts(batch, lists)
    for r, rule in enumerate(rules):
        for i, ctx in enumerate(contexts):
            assert bool(matched[i, r]) == execute_as_bool(
                rule.expression, ctx), (rule.name, i)


def corpus60():
    ref_rules, ref_lists = ref_generate_ruleset(
        60, with_lists=True, list_sizes=(128, 32), seed=2026)
    rules, lists = generate_ruleset(60, with_lists=True,
                                    list_sizes=(128, 32), seed=2026)
    return (ref_compile(ref_rules, ref_lists),
            compile_ruleset(rules, lists, device="cpu"), ref_lists, lists)


@pytest.fixture(scope="module")
def small():
    return corpus60()


@pytest.mark.parametrize("dfa_mode,pf_mode", MODES)
def test_mode_sweep(small, monkeypatch, dfa_mode, pf_mode):
    ref, port, ref_lists, _ = small
    monkeypatch.setenv("PINGOO_DFA", dfa_mode)
    monkeypatch.setenv("PINGOO_PREFILTER", pf_mode)
    reqs = ref_generate_traffic(96, attack_fraction=0.4, seed=31337,
                                lists=ref_lists)
    arrays = ref_bucket_arrays(ref_encode(reqs).arrays)
    want = np.asarray(ref_verdict.make_verdict_fn(ref)(ref.device_tables(),
                                                       arrays))
    got = verdict.make_verdict_fn(port)(port.np_tables, arrays).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any()


ROUTES = [("api", 'http_request.path.starts_with("/api")'),
          ("admin", 'http_request.path == "/admin"'),
          ("hosty", 'http_request.path < http_request.url'),
          ("all", None)]


def test_parity_rules_host_lanes_and_routes():
    sources = RULE_SOURCES + HOST_FALLBACK_SOURCES
    acts = [(RefAction.BLOCK,), (RefAction.CAPTCHA,),
            (RefAction.CAPTCHA, RefAction.BLOCK), ()]
    port_acts = [tuple(Action(a.value) for a in act) for act in acts]
    ref_rules = [RefRuleConfig(name=f"r{i}",
                               expression=ref_compile_expression(s),
                               actions=acts[i % 4])
                 for i, s in enumerate(sources)]
    rules = [RuleConfig(name=f"r{i}", expression=compile_expression(s),
                        actions=port_acts[i % 4])
             for i, s in enumerate(sources)]
    lists = {k: [Ip(str(v)) if hasattr(v, "contains") else v for v in vals]
             for k, vals in LISTS.items()}
    ref = ref_compile(ref_rules, LISTS, routes=[
        (n, ref_compile_expression(s) if s else None) for n, s in ROUTES])
    port = compile_ruleset(rules, lists, device="cpu", routes=[
        (n, compile_expression(s) if s else None) for n, s in ROUTES])
    assert port.host_rules and port.route_index == ref.route_index
    reqs = random_requests(random.Random(99), 80)
    batch = ref_encode(reqs)
    groups = [["api", "admin", "all"], ["hosty", "admin"]]
    want, want_hits = (np.asarray(x) for x in ref_verdict.make_lane_fn(
        ref, service_groups=groups, with_rule_hits=True)(
        ref.device_tables(), batch.arrays, n_valid=71))
    got, got_hits = (x.numpy() for x in verdict.make_lane_fn(
        port, service_groups=groups, with_rule_hits=True)(
        port.np_tables, batch.arrays, n_valid=71))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_hits, want_hits)
    pbatch = encode_requests(as_port(reqs))
    want_host = ref_verdict.host_rule_lanes(ref, batch, LISTS)
    got_host = verdict.host_rule_lanes(port, pbatch, lists)
    for w, g in zip(want_host, got_host):
        np.testing.assert_array_equal(g, w)
    for w, g in zip(ref_verdict.merge_lanes(want, want_host),
                    verdict.merge_lanes(got, got_host)):
        np.testing.assert_array_equal(g, w)
    want_m = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(), batch,
        LISTS)
    got_m = verdict.evaluate_batch(port, verdict.make_verdict_fn(port),
                                   port.np_tables, pbatch, lists)
    np.testing.assert_array_equal(got_m, want_m)
    for w, g in zip(ref_verdict.action_lanes(ref, want_m),
                    verdict.action_lanes(port, got_m)):
        np.testing.assert_array_equal(g, w)


def test_service_evaluate_on_cpu(small):
    from pingoo_tpu.engine.batch import tuple_to_context as ref_context

    ref, port, ref_lists, lists = small
    reqs = ref_generate_traffic(40, attack_fraction=0.5, seed=7,
                                lists=ref_lists)
    reqs[3].url = "/x?" + "a" * 3000 + "union select"  # overflows 2048
    want = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(reqs), ref_lists)
    # An overflowing row is re-interpreted over its untruncated strings.
    want[3] = ref_verdict.interpret_rules_row(
        ref, ref_context(reqs[3], ref_lists))
    want_act, want_vb = ref_verdict.action_lanes(ref, want)

    async def run():
        service = VerdictService(port, lists, max_batch=16, max_wait_us=2000,
                                 device="cpu")
        await service.start()
        try:
            return await asyncio.gather(
                *(service.evaluate(r) for r in as_port(reqs)))
        finally:
            await service.stop()

    verdicts = asyncio.run(run())
    assert [f.name for f in dataclasses.fields(Verdict)] == \
        [f.name for f in dataclasses.fields(RefVerdict)]
    for i, v in enumerate(verdicts):
        np.testing.assert_array_equal(v.matched, want[i])
        assert v.action == want_act[i]
        assert v.verified_block == want_vb[i]
    assert any(v.block for v in verdicts)


def test_service_timing_stays_bounded(small, monkeypatch):
    """Past the window's bound VerdictService keeps WINDOW timings of each
    kind, while its counts and its snapshot's counts stay exact: memory
    and the snapshot's cost do not grow with uptime."""
    _, port, _, lists = small
    monkeypatch.setattr(VerdictService, "WINDOW", 4)
    reqs = generate_traffic(40, attack_fraction=0.5, seed=7, lists=lists)

    async def run():
        service = VerdictService(port, lists, max_batch=4, max_wait_us=0,
                                 device="cpu")
        await service.start()
        try:
            for k in range(0, len(reqs), 4):  # ten batches of four
                await asyncio.gather(*map(service.evaluate, reqs[k:k + 4]))
        finally:
            await service.stop()
        return service

    service = asyncio.run(run())
    stats = service.stats
    windows = {"wait": stats.wait, "batch": stats.batch, **stats.stages}
    for name, window in windows.items():
        assert len(window) == 4, name
    assert stats.wait.count == 40
    assert all(w.count == 10 for w in [stats.batch, *stats.stages.values()])
    snap = stats.snapshot()
    assert (snap["batches"], snap["requests"], snap["mean_occupancy"]) \
        == (10, 40, 4.0)
    assert {k: v["count"] for k, v in snap["stages"].items()} \
        == {"encode": 10, "verdict": 10, "finish": 10}
    assert snap["verdict_p99_ms"] >= snap["verdict_p50_ms"] > 0
    assert service.pipeline_snapshot()["batches"] == {"off": 10}


@pytest.mark.parametrize("name,value", [("PINGOO_PIPELINE", "off"),
                                        ("PINGOO_SCAN_STRATEGY", "pair")])
def test_ported_knob_values_serve(small, monkeypatch, name, value):
    """Knob values the port runs as the JAX package does still serve,
    bit-equal to it."""
    ref, port, ref_lists, lists = small
    monkeypatch.setenv(name, value)
    reqs = ref_generate_traffic(48, attack_fraction=0.4, seed=7,
                                lists=ref_lists)
    want = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(reqs), ref_lists)
    service = VerdictService(port, lists, max_batch=64, device="cpu")
    got = np.stack([v.matched for v in service.evaluate_batch(as_port(reqs))])
    np.testing.assert_array_equal(got, want)
    assert got.any()


def numeric_sources(rng):
    """test_parity's fuzzed arithmetic rules plus i64 edge cases:
    overflow in + - * and negation, I64_MIN / -1, % -1, and / 0."""
    cols = ["client.asn", "client.remote_port", "http_request.path.length()"]
    sources = []
    for _ in range(25):
        lhs = rng.choice(cols)
        if rng.random() < 0.7:
            lhs = f"({lhs} {rng.choice('+-*/%')} {rng.randint(-3, 3)})"
        sources.append(f"{lhs} {rng.choice(['==', '!=', '<', '<=', '>', '>='])}"
                       f" {rng.randint(-100, 70000)}")
    i64_min = "(client.asn - 9223372036854775807 - 1)"
    return sources + [
        "client.asn * 9223372036854775807 > 0",
        "client.asn / 0 == 1",
        "client.asn % 0 == 0",
        "-9223372036854775808 - client.asn < 0",
        "client.remote_port - 9223372036854775807 - 9 < 0",
        f"{i64_min} / -1 < 0",
        f"{i64_min} % -1 == 0",
        f"-{i64_min} < 0",
        f"(client.asn - 1) * {i64_min} < 0",
        f"{i64_min} * (client.asn - 1) < 0",
        "client.remote_port * client.remote_port * client.remote_port"
        " * client.remote_port * client.remote_port > 0",
    ]


def boolean_sources(rng):
    """test_parity's fuzzed boolean compositions, error lanes included."""
    atoms = ['http_request.path.starts_with("/a")',
             'http_request.path.contains("min")', 'client.asn == 64500',
             'client.country == "RU"',
             'lists["blocked_asns"].contains(client.asn)',
             'lists["missing"].contains(client.asn)',
             'http_request.method == "POST"', "true", "false", "1 / 0 == 1"]

    def gen(depth):
        if depth == 0 or rng.random() < 0.35:
            return rng.choice(atoms)
        a, b = gen(depth - 1), gen(depth - 1)
        node = f"({a} {rng.choice(['&&', '||'])} {b})"
        if rng.random() < 0.25:
            node = "!" + node
        if rng.random() < 0.12:
            node = f"({node} == {gen(depth - 1)})"
        return node

    return [gen(3) for _ in range(40)]


@pytest.mark.parametrize("make_sources,seed", [(numeric_sources, 45),
                                               (boolean_sources, 46)])
def test_fuzzed_rules_match_reference(make_sources, seed):
    rng = random.Random(seed)
    sources = make_sources(rng)
    reqs = random_requests(rng, 48)
    ref_rules = [RefRuleConfig(name=f"r{i}",
                               expression=ref_compile_expression(s),
                               actions=(RefAction.BLOCK,))
                 for i, s in enumerate(sources)]
    rules = [RuleConfig(name=f"r{i}", expression=compile_expression(s),
                        actions=(Action.BLOCK,))
             for i, s in enumerate(sources)]
    lists = {k: [Ip(str(v)) if hasattr(v, "contains") else v for v in vals]
             for k, vals in LISTS.items()}
    ref = ref_compile(ref_rules, LISTS)
    port = compile_ruleset(rules, lists, device="cpu")
    assert port.stats["host_rules"] == ref.stats["host_rules"]
    want = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(reqs), LISTS)
    batch = encode_requests(as_port(reqs))
    got = verdict.evaluate_batch(port, verdict.make_verdict_fn(port),
                                 port.np_tables, batch, lists)
    np.testing.assert_array_equal(got, want)
    for i, ctx in enumerate(batch_to_contexts(batch, lists)):
        for r, rule in enumerate(rules):
            assert bool(got[i, r]) == execute_as_bool(rule.expression, ctx), \
                (sources[r], i)
