"""The port's admission scheduler (sched/scheduler.py) and the Python
plane's use of it, against the JAX package.

  * `SchedulerConfig.from_env` reads the same environments into the same
    config.
  * `CostModel` and `Scheduler` take the same decisions as the JAX
    package's on seeded sequences of observations and clocks, with the
    same explicit seed: every estimate, the wait budget, the launch and
    fail-open tests, K sizing, snapshot and restore.
  * VerdictService under `continuous` and `fixed` gives the verdicts of
    the JAX package's per-batch verdict function and the interpreter's;
    a tight deadline
    moves the miss counters; `allow` answers exactly the late rows with
    action 0 and the rest as the oracle does; `interpret` gives the
    oracle's verdicts; a stage budget overrun names its stage; the
    megastep's `off`, `auto` and `force` give the same bits, `auto`
    engaging windows of K > 1 under a deadline that leaves slack.

CPU only, small plans; exact equality throughout.
"""

import asyncio
import dataclasses
import json
import random
import time
import types

import numpy as np
import pytest
import torch

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import bucket_arrays as ref_bucket_arrays
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.obs.registry import MetricRegistry
from pingoo_tpu.sched import scheduler as ref_sched
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine import service as service_mod
from pingoo_tpu_torch.engine.batch import RequestTuple, tuple_to_context
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.engine.verdict import action_lanes, interpret_rules_row
from pingoo_tpu_torch.sched import scheduler as sched
from pingoo_tpu_torch.utils.crs import generate_ruleset
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
SCHED_ENV = ("PINGOO_SCHED_MODE", "PINGOO_DEADLINE_MS",
             "PINGOO_SCHED_FAILOPEN", "PINGOO_SCHED_SEED_MS",
             "PINGOO_MEGASTEP", "PINGOO_MEGASTEP_K", "PINGOO_PIPELINE",
             "PINGOO_PIPELINE_DEPTH", "PINGOO_SCHED_PIPELINE", "PINGOO_DFA",
             "PINGOO_PREFILTER", "PINGOO_STAGING", "PINGOO_CHAOS",
             "PINGOO_MESH", "PINGOO_PROVENANCE", "PINGOO_COST_LEDGER")


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for name in SCHED_ENV:
        monkeypatch.delenv(name, raising=False)
    # Every cost ledger under tmp_path, never at the repo root.
    monkeypatch.setenv("PINGOO_COST_LEDGER", str(tmp_path / "costs.json"))


# -- SchedulerConfig.from_env ---------------------------------------------------

ENVS = [
    {},
    {"PINGOO_SCHED_MODE": "fixed"},
    {"PINGOO_SCHED_MODE": "continuous", "PINGOO_DEADLINE_MS": "5"},
    {"PINGOO_SCHED_MODE": "deadline"},
    {"PINGOO_DEADLINE_MS": "not-a-number"},
    {"PINGOO_DEADLINE_MS": "0.25", "PINGOO_SCHED_FAILOPEN": "allow"},
    {"PINGOO_SCHED_FAILOPEN": "interpret"},
    {"PINGOO_SCHED_FAILOPEN": "drop", "PINGOO_SCHED_MODE": ""},
    {"PINGOO_DEADLINE_MS": "1e3", "PINGOO_SCHED_FAILOPEN": "serve"},
]


@pytest.mark.parametrize("env", ENVS, ids=[json.dumps(e) for e in ENVS])
@pytest.mark.parametrize("max_batch", [1, 1024, 2048])
def test_config_from_env_equals_the_reference(monkeypatch, env, max_batch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = sched.SchedulerConfig.from_env(max_batch)
    want = ref_sched.SchedulerConfig.from_env(max_batch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_seed_comes_from_the_environment_or_the_card(monkeypatch):
    """PINGOO_SCHED_SEED_MS wins, as in the JAX package; without it the
    seed is the port's own measured default (no bench history)."""
    assert sched.CostModel().seed_ms == sched.DEFAULT_SEED_MS
    monkeypatch.setenv("PINGOO_SCHED_SEED_MS", "3.5")
    assert sched.CostModel().seed_ms == 3.5
    assert sched.CostModel().seed_ms == ref_sched.CostModel().seed_ms
    monkeypatch.setenv("PINGOO_SCHED_SEED_MS", "bogus")
    assert sched.CostModel().seed_ms == sched.DEFAULT_SEED_MS
    assert sched.CostModel(seed_ms=0.0).seed_ms == 1e-3


# -- CostModel and Scheduler ----------------------------------------------------------


def both_schedulers(max_batch, deadline_ms, seed_ms, mode="continuous",
                    failopen="serve"):
    cfg = dict(mode=mode, deadline_ms=deadline_ms, failopen=failopen,
               max_batch=max_batch)
    port = sched.Scheduler(
        sched.SchedulerConfig(**cfg), plane="python",
        cost_model=sched.CostModel(max_batch=max_batch, seed_ms=seed_ms))
    ref = ref_sched.Scheduler(
        ref_sched.SchedulerConfig(**cfg), plane="python",
        cost_model=ref_sched.CostModel(max_batch=max_batch, seed_ms=seed_ms),
        registry=MetricRegistry())
    return port, ref


def queries(s, rng, now, ladder):
    """Every decision of one scheduler at one clock reading."""
    out = []
    for _ in range(6):
        n = rng.randint(1, 2 * s.config.max_batch)
        admit = now - rng.uniform(0.0, 0.01)
        out += [s.cost.estimate(n),
                s.cost.estimate_stage(rng.choice(
                    ("encode", "dispatch", "compute", "other")), n),
                s.cost.estimate_megastep(rng.randint(0, 9), n),
                s.cost.estimate_dispatch(n, rng.choice(
                    (None, 0, rng.randint(1, 1 << 22)))),
                s.wait_budget_s(n, admit, now),
                s.should_launch(n, admit, now),
                s.unmeetable(admit, now, n),
                s.size_megastep_k(ladder, n, admit, now)]
    return out


def observe(s, rng, step):
    """Seeded observations, replayed on both schedulers alike."""
    kind = step % 5
    n = rng.randint(1, 2 * s.config.max_batch)
    ms = rng.choice((-1.0, 0.0, rng.uniform(0.01, 40.0)))
    if kind == 0:
        s.observe_cost(n, ms)
    elif kind == 1:
        s.observe_stage_cost(rng.choice(("encode", "dispatch", "compute",
                                         "resolve")), n, ms)
    elif kind == 2:
        s.observe_megastep_cost(rng.randint(0, 8), n, ms)
    elif kind == 3:
        s.observe_dispatch_bytes(rng.choice((0, rng.randint(1, 1 << 22))),
                                 ms)
    else:
        s.note_launch(n, rng.randint(0, 50))
        s.note_resolved(0.0, rng.uniform(0.0, 0.01))
        s.note_misses(rng.randint(-1, 3))
        s.note_failopen(rng.randint(0, 2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_batch,deadline_ms,seed_ms", [
    (1024, 2.0, 25.0), (64, 50.0, 1.5), (2048, 20.0, 0.4), (1, 5.0, 3.0)])
def test_cost_model_and_scheduler_equal_the_reference(seed, max_batch,
                                                      deadline_ms, seed_ms):
    port, ref = both_schedulers(max_batch, deadline_ms, seed_ms)
    rng_p, rng_r = random.Random(seed), random.Random(seed)
    ladder = [1, 2, 4, 8]
    now = 100.0
    for step in range(240):
        observe(port, rng_p, step)
        observe(ref, rng_r, step)
        now += 0.001 * (step % 7)
        if step % 12 == 0:
            assert queries(port, rng_p, now, ladder) \
                == queries(ref, rng_r, now, ladder), step
    assert port.snapshot() == ref.snapshot()
    # restore() from a JSON round trip of the snapshot, both ways.
    snap = json.loads(json.dumps(ref.cost.snapshot()))
    fresh_p = sched.CostModel(max_batch=max_batch, seed_ms=1.0)
    fresh_r = ref_sched.CostModel(max_batch=max_batch, seed_ms=1.0)
    assert fresh_p.restore(snap) == fresh_r.restore(snap)
    assert fresh_p.snapshot() == fresh_r.snapshot() == port.cost.snapshot()
    for bad in (None, [], {"ewma_ms": {"x": 1}}, {"megastep_ewma_ms": {
            "4by512": 1.0}}, {"stage_ewma_ms": {"warp": {"8": 1}}}):
        assert sched.CostModel(seed_ms=1.0).restore(bad) \
            == ref_sched.CostModel(seed_ms=1.0).restore(bad)


def test_size_megastep_k_fits_deadline_slack():
    """The JAX package's own case (tests/test_pipeline.py)."""
    port, ref = both_schedulers(128, 50.0, 1.5)
    for s in (port, ref):
        for _ in range(40):
            s.cost.observe_stage("dispatch", 128, 2.0)
            s.cost.observe_stage("compute", 128, 10.0)
    now = 100.0
    for s in (port, ref):
        assert s.size_megastep_k([1, 2, 4, 8], 128, now, now) == 4
        assert s.size_megastep_k([1, 2, 4, 8], 128, now - 0.025, now) == 2
        assert s.size_megastep_k([1, 2, 4, 8], 128, now - 10.0, now) == 1


# -- VerdictService -------------------------------------------------------------------


@pytest.fixture(scope="module")
def crs40():
    ref_rules, ref_lists = ref_generate_ruleset(40, list_sizes=(64, 16),
                                                seed=7)
    rules, lists = generate_ruleset(40, list_sizes=(64, 16), seed=7)
    return (ref_compile(ref_rules, ref_lists), ref_lists,
            compile_ruleset(rules, lists, device="cpu"), lists)


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


def stream(ref_lists, seed, n=96):
    return ref_generate_traffic(n, attack_fraction=0.5, seed=seed,
                                lists=ref_lists)


def oracle(plan, lists, reqs):
    return np.stack([interpret_rules_row(plan, tuple_to_context(r, lists))
                     for r in reqs])


def serve_all(service, reqs):
    async def run():
        await service.start()
        try:
            return await asyncio.gather(*map(service.evaluate, reqs))
        finally:
            await service.stop()
    return asyncio.run(run())


_REF_VERDICTS: dict = {}


def reference_verdicts(ref, ref_lists, seed, rows=16):
    """(action, verified_block) per request of `stream(seed)` from the
    JAX package's per-batch verdict function and action lanes, in
    batches of `rows`. Its VerdictService is not the reference here: its
    staging encoder hands out buffer sets in turn, so a batch that is
    still in flight when three later ones have been encoded reads the
    third one's rows (ROADMAP.md, fault 3)."""
    if seed not in _REF_VERDICTS:
        reqs = stream(ref_lists, seed)
        fn = ref_verdict.make_verdict_fn(ref)
        tables = ref.device_tables()
        out = []
        for i in range(0, len(reqs), rows):
            batch = ref_encode(reqs[i:i + rows], ref.field_specs)
            dev = fn(tables, ref_bucket_arrays(batch.arrays))
            matched = ref_verdict.finish_batch(ref, dev, batch, ref_lists)
            acts, vblk = ref_verdict.action_lanes(ref, matched)
            out += [(int(a), bool(v)) for a, v in zip(acts, vblk)]
        _REF_VERDICTS[seed] = out
    return _REF_VERDICTS[seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", ["continuous", "fixed"])
def test_service_modes_equal_the_reference_and_the_oracle(crs40, monkeypatch,
                                                          seed, mode):
    ref, ref_lists, port, lists = crs40
    monkeypatch.setenv("PINGOO_SCHED_MODE", mode)
    reqs = as_port(stream(ref_lists, seed))
    want = oracle(port, lists, reqs)
    service = VerdictService(port, lists, max_batch=16, device="cpu")
    got = serve_all(service, reqs)
    np.testing.assert_array_equal(np.stack([v.matched for v in got]), want)
    assert [(v.action, v.verified_block) for v in got] \
        == reference_verdicts(ref, ref_lists, seed)
    assert any(v.block for v in got) and not any(v.degraded for v in got)
    snap = service.stats.snapshot()["sched"]
    assert snap["mode"] == mode
    assert snap["launches"] == service.stats.batches >= len(reqs) // 16
    assert snap["failopens"] == 0
    assert all(snap["admission"][k]["count"] == n for k, n in (
        ("queue_wait", len(reqs)), ("batch_assembly", len(reqs)),
        ("sched", service.stats.batches)))


def test_continuous_holds_while_slack_covers_the_estimate(crs40,
                                                          monkeypatch):
    """A deadline that leaves slack: the collector keeps assembling past
    the first pop (requests arriving 5 ms apart join one batch), and the
    cost model learns the batches' walls."""
    _, _, port, lists = crs40
    monkeypatch.setenv("PINGOO_DEADLINE_MS", "2000")
    monkeypatch.setenv("PINGOO_SCHED_SEED_MS", "1")
    reqs = as_port(stream(None, SEEDS[1], n=8))
    service = VerdictService(port, lists, max_batch=8, device="cpu")

    async def run():
        await service.start()
        try:
            futs = []
            for r in reqs:
                futs.append(asyncio.ensure_future(service.evaluate(r)))
                await asyncio.sleep(0.005)
            return await asyncio.gather(*futs)
        finally:
            await service.stop()

    got = asyncio.run(run())
    np.testing.assert_array_equal(np.stack([v.matched for v in got]),
                                  oracle(port, lists, reqs))
    assert service.stats.batches == 1 and service.stats.requests == 8
    snap = service.stats.snapshot()["sched"]
    assert snap["admission"]["sched"]["p99_ms"] >= 30.0
    assert snap["deadline_misses"] == 0
    assert snap["cost_model"]["ewma_ms"] and \
        set(snap["cost_model"]["stage_ewma_ms"]) == {"encode", "dispatch",
                                                     "compute"}


def test_tight_deadline_moves_the_miss_counters(crs40, monkeypatch):
    """Full batches (a partial one would be held while its slack lasts):
    every request misses a 1 µs deadline, none a minute's."""
    _, _, port, lists = crs40
    reqs = as_port(stream(None, SEEDS[2], n=48))
    for deadline, expect_all in (("0.001", True), ("60000", False)):
        monkeypatch.setenv("PINGOO_DEADLINE_MS", deadline)
        service = VerdictService(port, lists, max_batch=16, device="cpu")
        serve_all(service, reqs)
        misses = service.stats.snapshot()["sched"]["deadline_misses"]
        assert misses == (len(reqs) if expect_all else 0), deadline


@pytest.mark.parametrize("seed", SEEDS)
def test_allow_fails_open_exactly_the_late_rows(crs40, monkeypatch, seed):
    """`allow` answers the rows no launch can serve in time (here those
    whose entry time lies seconds back) with action 0 (degraded), each
    once and counted; every other row is the oracle's."""
    _, _, port, lists = crs40
    monkeypatch.setenv("PINGOO_SCHED_FAILOPEN", "allow")
    monkeypatch.setenv("PINGOO_DEADLINE_MS", "1000")
    monkeypatch.setenv("PINGOO_SCHED_SEED_MS", "1")
    reqs = as_port(stream(None, seed, n=48))
    want = oracle(port, lists, reqs)
    rng = random.Random(seed)
    late = [rng.random() < 0.4 for _ in reqs]
    service = VerdictService(port, lists, max_batch=16, device="cpu")

    async def run():
        await service.start()
        try:
            loop = asyncio.get_running_loop()
            futs = []
            for r, old in zip(reqs, late):
                fut = loop.create_future()
                t_enq = time.monotonic() - (5.0 if old else 0.0)
                await service._queue.put((r, fut, t_enq))
                futs.append(fut)
            return await asyncio.gather(*futs)
        finally:
            await service.stop()

    got = asyncio.run(run())
    assert [v.degraded for v in got] == late
    assert service.stats.snapshot()["sched"]["failopens"] == sum(late) > 0
    assert service.stats.requests == len(reqs) - sum(late)
    for v, row in zip(got, want):
        if v.degraded:
            assert v.action == 0 and not v.matched.any()
        else:
            np.testing.assert_array_equal(v.matched, row)


def test_interpret_gives_the_oracle(crs40, monkeypatch):
    """An impossible deadline under `interpret`: every request fails open
    through the host interpreter, with the oracle's verdicts."""
    _, _, port, lists = crs40
    monkeypatch.setenv("PINGOO_SCHED_FAILOPEN", "interpret")
    monkeypatch.setenv("PINGOO_DEADLINE_MS", "0.000001")
    reqs = as_port(stream(None, SEEDS[3], n=40))
    want = oracle(port, lists, reqs)
    service = VerdictService(port, lists, max_batch=16, device="cpu")
    got = serve_all(service, reqs)
    np.testing.assert_array_equal(np.stack([v.matched for v in got]), want)
    actions, vblk = action_lanes(port, want)
    assert [(v.action, v.verified_block) for v in got] \
        == list(zip(actions.tolist(), vblk.tolist()))
    assert not any(v.degraded for v in got)
    snap = service.stats.snapshot()["sched"]
    assert snap["failopens"] == len(reqs)
    assert service.stats.batches == 0  # nothing rode the device


def test_stage_budget_overrun_names_its_stage(crs40, monkeypatch):
    """The JAX package's case (tests/test_pipeline.py)."""
    _, _, port, lists = crs40
    monkeypatch.setenv("PINGOO_PIPELINE", "on")
    monkeypatch.setenv("PINGOO_DEADLINE_MS", "2.0")
    monkeypatch.setenv("PINGOO_SCHED_FAILOPEN", "serve")
    VerdictService(port, lists, max_batch=16, device="cpu") \
        ._check_stage_budget("encode", time.monotonic() - 5.0)
    monkeypatch.setenv("PINGOO_SCHED_FAILOPEN", "allow")
    svc = VerdictService(port, lists, max_batch=16, device="cpu")
    # The service's clock stands still: a batch launched `now` has spent
    # none of the 2 ms deadline, however long the host takes to get here.
    now = time.monotonic()
    monkeypatch.setattr(service_mod, "time",
                        types.SimpleNamespace(monotonic=lambda: now))
    with pytest.raises(service_mod._StageBudgetExceeded) as exc:
        svc._check_stage_budget("encode", now - 5.0)
    assert exc.value.stage == "encode" and "encode" in str(exc.value)
    assert exc.value.elapsed_ms > 1000
    svc._check_stage_budget("encode", now)
    svc._check_stage_budget("compute", now - 5.0)
    svc._check_stage_budget("encode", None)
    with pytest.raises(service_mod._StageBudgetExceeded, match="dispatch"):
        svc._check_stage_budget("dispatch", now - 5.0)
    assert service_mod.PIPELINE_STAGE_BUDGET \
        == {"encode": 0.45, "dispatch": 0.75}


def test_megastep_off_auto_force_bit_identical(crs40, monkeypatch):
    """The JAX package's case (tests/test_pipeline.py): `off` is the
    oracle; `force` and `auto` give its bits; under a deadline that
    leaves slack `auto` engages windows of K > 1 with a backlog queued,
    and learns their walls."""
    _, _, port, lists = crs40
    reqs = as_port(stream(None, SEEDS[4], n=160))
    monkeypatch.setenv("PINGOO_PIPELINE_DEPTH", "3")
    monkeypatch.setenv("PINGOO_MEGASTEP_K", "4")
    monkeypatch.setenv("PINGOO_DEADLINE_MS", "60000")
    out = {}
    for mode in ("off", "force", "auto"):
        monkeypatch.setenv("PINGOO_MEGASTEP", mode)
        service = VerdictService(port, lists, max_batch=16, device="cpu")
        got = serve_all(service, reqs)
        out[mode] = (np.stack([v.matched for v in got]),
                     [(v.action, v.verified_block) for v in got],
                     service.pipeline_snapshot()["megastep"],
                     service.stats.snapshot()["sched"]["cost_model"])
        assert service.mega_echo_mismatch == 0
    for mode in ("force", "auto"):
        np.testing.assert_array_equal(out[mode][0], out["off"][0])
        assert out[mode][1] == out["off"][1]
    np.testing.assert_array_equal(out["off"][0], oracle(port, lists, reqs))
    assert out["off"][2]["slices"] == 0
    auto = out["auto"][2]
    assert auto["windows"] > 0 and auto["slices"] > auto["windows"]
    assert auto["slices_by_mode"].get("auto", 0) == auto["slices"]
    assert out["auto"][3]["megastep_first_ms"]


@pytest.mark.parametrize("spec", ["1x1x1", "2x2x2", " 4X1x1 ", "1x1", "2x2",
                                  "0x1x1", "ax1x1", "", "1x1x1x1"])
def test_mesh_spec_parses_as_the_reference(spec):
    """A server validates PINGOO_MESH at boot with the JAX package's
    grammar (sched.parse_mesh_spec); device.check_env refuses a mesh of
    more than one device (port queue item 9b)."""
    from pingoo_tpu.parallel.mesh import parse_mesh_spec as ref_parse
    from pingoo_tpu_torch.sched import parse_mesh_spec

    try:
        want = ref_parse(spec)
    except ValueError as exc:
        with pytest.raises(ValueError, match="bad mesh spec"):
            parse_mesh_spec(spec)
        assert "bad mesh spec" in str(exc)
        return
    assert parse_mesh_spec(spec) == want
