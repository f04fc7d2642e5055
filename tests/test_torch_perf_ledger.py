"""The port's compile ledger (obs/perf.py), its durable cost ledger
(sched/scheduler.py) and the measured re-selection of scan strategies
(compiler/plan.py), against the JAX package on the CPU.

  * The cost-model and compile-ledger cases of tests/test_perf_ledger.py,
    each run through both packages on the same inputs: snapshots,
    reload results, counters, events and the Prometheus text are equal.
  * A ledger either package saves loads `ok` in the other's
    `load_cost_ledger`, with equal EWMAs.
  * `plan_fingerprint` is equal across the packages for the 500-rule
    corpus (seeds default and 5) and for a routed ruleset, and differs
    where a rule is dropped or routes are added (not where only the
    expressions differ: the JAX package's recipe hashes rule names).
  * `reselect_scan_strategies` on the CRS plan gives the JAX package's
    scan plans for the cost dicts of its own tests, and the artifact
    cache keeps the measured choice.
  * What counts as a compile here: a graph capture (faked CUDA calls on
    the CPU) and an nvcc build (a stub compiler) reach the ledger as
    `megastep` and `verdict` cold and warm events, with the key's rows,
    K and widths, and the sidecar's construction-time build as its
    `lanes` cold event; a hit in the build cache is none. With the
    ledger off the planes' programs are the unwrapped callables.
  * Both planes reload their costs (`ok`, `stale`, `missing`) and save
    them at `stop()` only where PINGOO_COST_LEDGER points.

Every ledger lives under tmp_path. CPU only; exact equality.
"""

import asyncio
import contextlib
import dataclasses
import json
import os
import stat
import threading

import pytest
import torch

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.compiler import plan as ref_plan_mod
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.obs import perf as ref_perf
from pingoo_tpu.obs.registry import MetricRegistry as RefRegistry
from pingoo_tpu.sched import scheduler as ref_sched
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu_torch import native_ring
from pingoo_tpu_torch.compiler import plan as plan_mod
from pingoo_tpu_torch.compiler.cache import (compile_ruleset_cached,
                                             update_cached_plan)
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine import graphs
from pingoo_tpu_torch.engine.batch import STRING_FIELDS
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.engine.verdict import MegastepProgram
from pingoo_tpu_torch.expr import compile_expression
from pingoo_tpu_torch.obs import perf
from pingoo_tpu_torch.obs.registry import MetricRegistry, lint_prometheus_text
from pingoo_tpu_torch.ops import _build
from pingoo_tpu_torch.sched import scheduler as sched
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

LEDGER_ENV = ("PINGOO_PERF_LEDGER", "PINGOO_COMPILE_SURFACE",
              "PINGOO_PERF_LEDGER_N", "PINGOO_SCHED_SEED_MS",
              "PINGOO_MEGASTEP", "PINGOO_PIPELINE", "PINGOO_SCHED_MODE",
              "PINGOO_PROVENANCE", "PINGOO_DEADLINE_MS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in LEDGER_ENV:
        monkeypatch.delenv(name, raising=False)
    perf.reset_compile_ledger_for_tests()
    yield
    perf.reset_compile_ledger_for_tests()


# -- the cost model's persistence ---------------------------------------------


def seeded_cost(mod):
    """A CostModel of package `mod` with every EWMA family observed
    (tests/test_perf_ledger.py's sequence)."""
    cost = mod.CostModel(max_batch=256, seed_ms=4.0)
    cost.observe(16, 3.25)
    cost.observe(64, 9.5)
    cost.observe_stage("encode", 16, 0.8)
    cost.observe_stage("dispatch", 16, 0.4)
    cost.observe_stage("compute", 64, 6.0)
    cost.observe_megastep(4, 16, 2.5)  # the first: kept apart
    cost.observe_megastep(4, 16, 1.5)  # the second: the EWMA
    cost.observe_dispatch_bytes(48 * 1024, 0.9)
    return cost


def test_snapshot_restore_round_trip():
    port, ref = seeded_cost(sched), seeded_cost(ref_sched)
    assert port.snapshot() == ref.snapshot()
    snap = json.loads(json.dumps(port.snapshot()))
    fresh, ref_fresh = sched.CostModel(max_batch=256), \
        ref_sched.CostModel(max_batch=256)
    assert fresh.restore(snap) is ref_fresh.restore(snap) is True
    assert fresh.snapshot() == ref_fresh.snapshot() == port.snapshot()
    for stage in ("encode", "dispatch", "compute"):
        assert fresh.estimate_stage(stage, 16) \
            == ref_fresh.estimate_stage(stage, 16) \
            == port.estimate_stage(stage, 16)
    assert fresh.estimate_megastep(4, 16) == port.estimate_megastep(4, 16)
    assert fresh._mega_first == port._mega_first == ref_fresh._mega_first


def test_restore_rejects_garbage():
    for mod in (sched, ref_sched):
        fresh = mod.CostModel(seed_ms=1.0)
        assert fresh.restore("not a dict") is False
        assert fresh.restore({}) is False
        assert fresh.restore({"ewma_ms": {"16": 2.0, "what": 1.0},
                              "stage_ewma_ms": {"bogus_stage": {"8": 1.0}},
                              "megastep_ewma_ms": {"nonsense": 3.0}}) is True
        assert fresh._ewma == {16: 2.0}
        assert fresh._stage_ewma == {}


def ledger_doc(path):
    """A saved ledger without its timestamps."""
    with open(path) as f:
        doc = json.load(f)
    for entry in doc["entries"].values():
        entry.pop("ts")
    return doc


def test_ledger_save_load_round_trip(tmp_path):
    docs, counts = [], []
    for mod, reg in ((sched, MetricRegistry()), (ref_sched, RefRegistry())):
        path = str(tmp_path / f"{mod.__name__}.json")
        cost = seeded_cost(mod)
        assert mod.save_cost_ledger(cost, backend="cpu", fingerprint="fp01",
                                    plane="python", path=path) is True
        fresh = mod.CostModel(max_batch=256)
        assert mod.load_cost_ledger(fresh, backend="cpu", fingerprint="fp01",
                                    plane="python", path=path,
                                    registry=reg) == "ok"
        assert fresh.snapshot() == cost.snapshot()
        docs.append(ledger_doc(path))
        counts.append(reg.counter("pingoo_costmodel_reload_total", labels={
            "plane": "python", "result": "ok"}).value)
    assert docs[0] == docs[1]
    assert counts == [1, 1]


def test_stale_fingerprint_discarded_and_counted(tmp_path):
    texts = []
    for mod, reg in ((sched, MetricRegistry()), (ref_sched, RefRegistry())):
        path = str(tmp_path / f"{mod.__name__}.json")
        mod.save_cost_ledger(seeded_cost(mod), backend="cpu",
                             fingerprint="fp01", plane="python", path=path)
        fresh = mod.CostModel(max_batch=256)
        assert mod.load_cost_ledger(fresh, backend="cpu",
                                    fingerprint="OTHER", plane="python",
                                    path=path, registry=reg) == "stale"
        assert fresh._ewma == {}
        texts.append(reg.prometheus_text())
    assert texts[0] == texts[1]
    assert 'result="stale"} 1' in texts[0] and 'result="ok"} 0' in texts[0]


def test_missing_and_version_mismatch(tmp_path):
    for mod, reg in ((sched, MetricRegistry()), (ref_sched, RefRegistry())):
        path = str(tmp_path / f"{mod.__name__}.json")
        fresh = mod.CostModel()
        results = [mod.load_cost_ledger(fresh, backend="cpu",
                                        fingerprint="fp", plane="python",
                                        path=path, registry=reg)]
        with open(path, "w") as f:
            json.dump({"version": 999, "entries": {}}, f)
        results.append(mod.load_cost_ledger(
            fresh, backend="cpu", fingerprint="fp", plane="python",
            path=path, registry=reg))
        with open(path, "w") as f:
            f.write("{broken json")
        results.append(mod.load_cost_ledger(
            fresh, backend="cpu", fingerprint="fp", plane="python",
            path=path, registry=reg))
        assert results == ["missing", "stale", "error"], mod
        assert mod.load_cost_ledger(fresh, backend="cpu", fingerprint="fp",
                                    plane="python", path=None,
                                    registry=reg) != "disabled"


@pytest.mark.parametrize("value,want", [
    (None, "COST_LEDGER.json"), ("", "COST_LEDGER.json"),
    ("on", "COST_LEDGER.json"), ("1", "COST_LEDGER.json"),
    ("off", None), ("0", None), ("false", None), ("none", None),
    ("/x/costs.json", "/x/costs.json")])
def test_cost_ledger_path_gate(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("PINGOO_COST_LEDGER", raising=False)
    else:
        monkeypatch.setenv("PINGOO_COST_LEDGER", value)
    assert sched.cost_ledger_path() == ref_sched.cost_ledger_path() == want


def test_merge_preserves_other_plane_entries(tmp_path):
    for mod in (sched, ref_sched):
        path = str(tmp_path / f"{mod.__name__}.json")
        for plane in ("python", "sidecar"):
            mod.save_cost_ledger(seeded_cost(mod), backend="cpu",
                                 fingerprint="fp", plane=plane, path=path)
        assert set(ledger_doc(path)["entries"]) == {"cpu|python",
                                                    "cpu|sidecar"}


@pytest.mark.parametrize("saver,loader", [(sched, ref_sched),
                                          (ref_sched, sched)])
def test_ledgers_cross_load(tmp_path, saver, loader):
    """The file format is one: what either package saves the other
    reloads, EWMAs and all."""
    path = str(tmp_path / "costs.json")
    cost = seeded_cost(saver)
    assert saver.save_cost_ledger(cost, backend="cuda", fingerprint="fp9",
                                  plane="sidecar", path=path)
    fresh = loader.CostModel(max_batch=256)
    reg = MetricRegistry() if loader is sched else RefRegistry()
    assert loader.load_cost_ledger(fresh, backend="cuda", fingerprint="fp9",
                                   plane="sidecar", path=path,
                                   registry=reg) == "ok"
    assert fresh.snapshot() == cost.snapshot()
    assert loader.load_cost_ledger(fresh, backend="cpu", fingerprint="fp9",
                                   plane="sidecar", path=path,
                                   registry=reg) == "missing"


# -- the compile ledger -----------------------------------------------------------


class FakeJit:
    """A jit-shaped callable whose executable cache grows on chosen
    calls (the JAX package's compile probe)."""

    def __init__(self, grow_on=()):
        self.cache = 0
        self.calls = 0
        self.grow_on = set(grow_on)

    def __call__(self, *args):
        self.calls += 1
        if self.calls in self.grow_on:
            self.cache += 1
        return self.calls

    def _cache_size(self):
        return self.cache


class FakeProgram:
    """A served program whose chosen calls run an nvcc build (the
    thread's build count moves, as ops/_build.build moves it)."""

    def __init__(self, build_on=()):
        self.calls = 0
        self.build_on = set(build_on)

    def __call__(self, *args):
        self.calls += 1
        if self.calls in self.build_on:
            perf.note_build()
        return self.calls


def events_without_time(ledger):
    return [{k: v for k, v in e.items() if k not in ("ts", "wall_ms")}
            for e in ledger.snapshot()["events"]]


def test_cold_then_warm_events(tmp_path):
    """The same compile pattern (calls 1 and 3) through both ledgers:
    equal totals, kinds and events, and the JSONL file line for line."""
    ledgers = {}
    for name, mod, reg, fn in (
            ("port", perf, MetricRegistry(), FakeProgram({1, 3})),
            ("ref", ref_perf, RefRegistry(), FakeJit({1, 3}))):
        ledger = mod.CompileLedger(path=str(tmp_path / f"{name}.jsonl"),
                                   registry=reg)
        wrapped = mod.instrument_jit(fn, "verdict", plane="python",
                                     fingerprint="fp", ledger=ledger)
        assert wrapped is not fn
        for _ in range(4):
            wrapped(torch.zeros((8, 3)) if name == "port" else None)
        ledgers[name] = (ledger, reg)
    port, ref = ledgers["port"][0], ledgers["ref"][0]
    snap = port.snapshot()
    assert snap["totals"] == ref.snapshot()["totals"] == {
        "python/verdict/cold": 1, "python/verdict/warm": 1}
    assert [e["kind"] for e in snap["events"]] == ["cold", "warm"]
    with open(port.path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines == snap["events"]
    assert len(lines) == snap["compiles_total"] == 2
    assert all(ln["fingerprint"] == "fp" for ln in lines)
    assert lines[0]["batch_bucket"] == 8 and lines[0]["shapes"] == [[8, 3]]
    assert ledgers["port"][1].counter("pingoo_compile_total", labels={
        "plane": "python", "fn": "verdict", "kind": "warm"}).value == 1


def test_disabled_returns_fn_unchanged():
    for mod, reg in ((perf, MetricRegistry()), (ref_perf, RefRegistry())):
        ledger = mod.CompileLedger(path=None, registry=reg)
        fn = FakeJit()
        assert mod.instrument_jit(fn, "verdict", plane="python",
                                  ledger=ledger) is fn
        assert mod.instrument_jit(None, "verdict", plane="python",
                                  ledger=ledger) is None
        prog = MegastepProgram(fn=fn, kind="lanes", with_rule_hits=False)
        assert perf.instrument_megastep(
            prog, plane="sidecar", ledger=perf.CompileLedger()) is prog


def test_wrapper_delegates_attributes(tmp_path):
    ledger = perf.CompileLedger(path=str(tmp_path / "l.jsonl"),
                                registry=MetricRegistry())
    fn = perf.instrument_jit(FakeJit(), "lanes", plane="sidecar",
                             ledger=ledger)
    assert fn._cache_size() == 0
    prog = MegastepProgram(fn=FakeJit(), kind="lanes", with_rule_hits=False)
    mega = perf.instrument_megastep(prog, plane="sidecar", ledger=ledger)
    assert mega.kind == "lanes" and mega.fn is prog.fn
    assert mega.dfa_mode() == ""


@pytest.mark.parametrize("shapes", [
    [(64, 128), (64, 16), (8, 64, 4)], [], [(4,), (16, 2)],
    [(2, 32, 8), (2, 32, 8), (4, 5, 6), (32, 1)]])
def test_shape_context(shapes):
    assert perf._shape_context(shapes) == ref_perf._shape_context(shapes)


@pytest.mark.parametrize("value", [None, "0", "off", "false", "1", "on",
                                   "true", "/tmp/x.jsonl", " 0 "])
def test_path_gate(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("PINGOO_PERF_LEDGER", raising=False)
    else:
        monkeypatch.setenv("PINGOO_PERF_LEDGER", value)
    assert perf.perf_ledger_path() == ref_perf.perf_ledger_path()


def test_surface_flags_unexpected_events(tmp_path, monkeypatch):
    """An event outside the surface file is flagged and counted, as in
    the JAX package, axis by axis."""
    surface = {"planes": ["sidecar"], "fns": ["megastep", "lanes"],
               "kinds": ["cold", "warm"], "batch_buckets": [256, 1024],
               "k_rungs": [1, 2, 4]}
    path = tmp_path / "surface.json"
    path.write_text(json.dumps(surface))
    monkeypatch.setenv("PINGOO_COMPILE_SURFACE", str(path))
    got = []
    for mod, reg in ((perf, MetricRegistry()), (ref_perf, RefRegistry())):
        ledger = mod.CompileLedger(path=None, registry=reg)
        for plane, fn, bucket, k in (("sidecar", "megastep", 256, 4),
                                     ("sidecar", "megastep", 512, 4),
                                     ("sidecar", "megastep", 256, 8),
                                     ("python", "verdict", 256, None),
                                     ("sidecar", "score", None, None)):
            ledger.note(plane=plane, fn=fn, kind="warm", wall_ms=1.0,
                        batch_bucket=bucket, k=k)
        snap = ledger.snapshot()
        assert snap["surface_loaded"] is True
        got.append(([e.get("unexpected") for e in snap["events"]],
                    snap["unexpected_total"], reg.prometheus_text()))
    assert got[0] == got[1]
    assert got[0][0] == [None, "batch_bucket=512", "k=8", "plane='python'",
                         "fn='score'"]
    assert perf.load_compile_surface(str(tmp_path / "none.json")) is None


def test_perf_series_lint_clean():
    """The boot inventory of both ledgers' series renders as the JAX
    package's and lints clean."""
    texts = []
    for mod, smod, reg in ((perf, sched, MetricRegistry()),
                           (ref_perf, ref_sched, RefRegistry())):
        ledger = mod.CompileLedger(path=None, registry=reg)
        ledger.ensure_instruments("python")
        ledger.ensure_instruments("sidecar")
        smod.load_cost_ledger(smod.CostModel(seed_ms=1.0), backend="cpu",
                              fingerprint="", plane="python",
                              path=os.devnull, registry=reg)
        texts.append(reg.prometheus_text())
    assert texts[0] == texts[1]
    assert lint_prometheus_text(texts[0]) == []
    for name in ("pingoo_compile_total", "pingoo_compile_ms",
                 "pingoo_costmodel_reload_total"):
        assert name in texts[0]


# -- what counts as a compile here -------------------------------------------------


class FakeStream:
    def wait_stream(self, other):
        pass


class FakeGraph:
    replays = 0

    def replay(self):
        FakeGraph.replays += 1


class FakeQueue:
    """The three calls MegastepRunner makes of a DeviceInputQueue, at a
    chosen window shape."""

    def __init__(self, rows, widths):
        self.rows, self.widths = rows, widths

    def window_shape(self, buf_id, k_ship):
        shape = {"asn": (k_ship, self.rows)}
        for f, w in zip(STRING_FIELDS, self.widths):
            shape[f"{f}_bytes"] = (k_ship, self.rows, w)
        return shape

    def empty_inputs(self, buf_id, k_ship, device):
        return torch.zeros(1), {"n_valid": torch.zeros(k_ship),
                                "epoch": torch.zeros(k_ship),
                                "asn": torch.zeros((k_ship, self.rows))}

    def ship(self, buf_id, k_used, k_ship, flat):
        pass


@pytest.fixture
def fake_capture(monkeypatch):
    """torch.cuda's capture calls, faked so that a runner on a "cuda"
    device captures on the CPU: the body runs eagerly twice (warm-up and
    capture) and a replay counts."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream=None, capture_error_mode=None:
                        contextlib.nullcontext())


def test_graph_captures_are_megastep_events(tmp_path, fake_capture):
    ledger = perf.CompileLedger(path=str(tmp_path / "l.jsonl"),
                                registry=MetricRegistry())
    calls = []

    def body(tables, stacked, n_valid, epoch):
        calls.append(stacked["asn"].shape)
        return stacked["asn"], None, epoch, None

    prog = MegastepProgram(fn=body, kind="lanes", with_rule_hits=False)
    runner = graphs.MegastepRunner(
        perf.instrument_megastep(prog, plane="sidecar", fingerprint="fp",
                                 ledger=ledger), {}, torch.device("cuda"))
    wide = FakeQueue(256, (64, 2048, 1024, 16, 512, 2))
    narrow = FakeQueue(64, (32, 128, 64, 16, 128, 2))
    runner.run(wide, 0, 3, 4)   # capture: cold
    runner.run(wide, 0, 4, 4)   # replay: no event
    runner.run(narrow, 0, 1, 1)  # a new key: warm
    runner.run(wide, 0, 2, 2)   # a new K: warm
    assert len(calls) == 6 and runner.captures == 3 and runner.replays == 4
    assert events_without_time(ledger) == [
        {"plane": "sidecar", "fn": "megastep", "kind": kind,
         "batch_bucket": rows, "k": k,
         "widths": sorted([f, w] for f, w in zip(STRING_FIELDS, widths)),
         "fingerprint": "fp", "shapes": []}
        for kind, rows, k, widths in (
            ("cold", 256, 4, wide.widths), ("warm", 64, 1, narrow.widths),
            ("warm", 256, 2, wide.widths))]
    assert ledger.snapshot()["totals"] == {"sidecar/megastep/cold": 1,
                                           "sidecar/megastep/warm": 2}
    assert all(e["wall_ms"] >= 0 for e in ledger.snapshot()["events"])
    # The same runner over the bare program captures with no event.
    bare = graphs.MegastepRunner(prog, {}, torch.device("cuda"))
    bare.run(wide, 0, 1, 4)
    assert bare.captures == 1 and ledger.snapshot()["compiles_total"] == 3


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A compiler stand-in that writes its `-o` file, and a build
    directory under tmp_path: ops/_build.build runs it as it runs nvcc."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                      "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                      "  shift\ndone\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def test_nvcc_builds_are_events_of_the_program_that_ran_them(
        tmp_path, stub_nvcc):
    ledger = perf.CompileLedger(path=str(tmp_path / "l.jsonl"),
                                registry=MetricRegistry())
    built = []

    def program(tables, arrays, names):
        built.append(_build.build(names))
        return arrays

    fn = perf.instrument_jit(program, "verdict", plane="python",
                             fingerprint="fp", widths=(("url", 64),),
                             ledger=ledger)
    arrays = {"url_bytes": torch.zeros((32, 64)), "ip": torch.zeros((32, 4))}
    perf.set_dispatch_context(batch=32)
    fn({}, arrays, ["prefilter"])            # a build: cold
    fn({}, arrays, ["prefilter"])            # a hit in _build/: none
    perf.set_dispatch_context(batch=64)
    fn({}, arrays, ["nfa_scan", "prefilter"])  # one more build: warm
    assert sorted(p.name.split("-")[0] for p in stub_nvcc.iterdir()) \
        == ["libnfa_scan", "libprefilter"]
    assert [set(b) for b in built] == [{"prefilter"}, {"prefilter"},
                                       {"nfa_scan"}]
    assert events_without_time(ledger) == [
        {"plane": "python", "fn": "verdict", "kind": kind,
         "batch_bucket": rows, "k": None, "widths": [["url", 64]],
         "fingerprint": "fp", "shapes": [[32, 64], [32, 4]]}
        for kind, rows in (("cold", 32), ("warm", 64))]
    # A build outside any instrumented program is no event.
    _build.build(["bitsplit_dfa"])
    assert ledger.snapshot()["compiles_total"] == 2


@pytest.mark.parametrize("ledger_on", [False, True])
def test_sidecar_build_is_its_lanes_cold_event(tmp_path, stub_nvcc,
                                               ledger_on):
    """The sidecar's construction-time build (`record_build`): a build
    that ran nvcc is one `lanes` cold event with the build's wall; a hit
    in _build/ is none, and so is everything with the ledger off."""
    ledger = perf.CompileLedger(
        path=str(tmp_path / "l.jsonl") if ledger_on else None,
        registry=MetricRegistry())

    def build():
        return perf.record_build(lambda: _build.build(["prefilter"]),
                                 plane="sidecar", fn="lanes",
                                 fingerprint="fp", widths=(("path", 32),),
                                 ledger=ledger)

    assert set(build()) == {"prefilter"}
    assert build() == {"prefilter": 0.0}
    assert [p.name.split("-")[0] for p in stub_nvcc.iterdir()] \
        == ["libprefilter"]
    want = [{"plane": "sidecar", "fn": "lanes", "kind": "cold",
             "batch_bucket": None, "k": None, "widths": [["path", 32]],
             "fingerprint": "fp", "shapes": []}] if ledger_on else []
    assert events_without_time(ledger) == want
    assert ledger.snapshot()["totals"] == (
        {"sidecar/lanes/cold": 1} if ledger_on else {})


def small_plan(n=20, seed=3):
    rules, lists = generate_ruleset(n, with_lists=False, seed=seed)
    return compile_ruleset(rules, lists, device="cpu"), lists


@pytest.mark.parametrize("ledger_on", [False, True])
def test_planes_wrap_their_programs_only_when_the_ledger_is_on(
        tmp_path, monkeypatch, ledger_on):
    monkeypatch.setenv("PINGOO_MEGASTEP", "force")
    if ledger_on:
        monkeypatch.setenv("PINGOO_PERF_LEDGER",
                           str(tmp_path / "perf.jsonl"))
    plan, lists = small_plan()
    svc = VerdictService(plan, lists, max_batch=16, device="cpu",
                         registry=MetricRegistry())
    ring = native_ring.Ring(str(tmp_path / "ring"), capacity=64,
                            create=True)
    try:
        sidecar = native_ring.RingSidecar(ring, plan, lists, max_batch=16,
                                          device="cpu",
                                          registry=MetricRegistry())
        runners = [svc._mega_runner.program, sidecar._mega_runner.program]
        # The sidecar's lane program is never wrapped: it builds nothing
        # on a served call (its build runs at construction).
        assert not isinstance(sidecar._lane_fn, perf._InstrumentedProgram)
        if ledger_on:
            fn = svc._verdict_fn
            assert isinstance(fn, perf._InstrumentedProgram)
            assert (fn._plane, fn._name) == ("python", "verdict")
            assert all(isinstance(r, perf._InstrumentedMegastep)
                       for r in runners)
        else:
            assert not isinstance(svc._verdict_fn,
                                  perf._InstrumentedProgram)
            assert all(type(r) is MegastepProgram for r in runners)
        assert perf.get_compile_ledger().enabled is ledger_on
    finally:
        ring.close()


# -- the cost ledger on both planes ---------------------------------------------


def serve(service, reqs):
    async def run():
        await service.start()
        try:
            return await asyncio.gather(*map(service.evaluate, reqs))
        finally:
            await service.stop()
    return asyncio.run(run())


def test_python_plane_reloads_and_saves_only_where_pointed(
        tmp_path, monkeypatch, cost_ledger_per_test):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    plan, lists = small_plan()
    reqs = generate_traffic(48, attack_fraction=0.5, seed=11)
    first = VerdictService(plan, lists, max_batch=16, device="cpu",
                           registry=MetricRegistry())
    assert first.cost_ledger_result == "missing"
    serve(first, reqs)
    saved = first.sched.cost.snapshot()
    assert saved["ewma_ms"]
    entry = json.loads(cost_ledger_per_test.read_text())["entries"][
        "cpu|python"]
    assert entry["fingerprint"] == perf.plan_fingerprint(plan)
    assert entry["backend"] == "cpu" and entry["plane"] == "python"
    again = VerdictService(plan, lists, max_batch=16, device="cpu",
                           registry=MetricRegistry())
    assert again.cost_ledger_result == "ok"
    assert again.sched.cost.snapshot() == saved
    other, other_lists = small_plan(24, seed=5)
    assert VerdictService(other, other_lists, device="cpu",
                          registry=MetricRegistry()).cost_ledger_result \
        == "stale"
    assert first.persist_cost_ledger() is True
    assert list(cwd.iterdir()) == []
    monkeypatch.setenv("PINGOO_COST_LEDGER", "off")
    off = VerdictService(plan, lists, device="cpu",
                         registry=MetricRegistry())
    assert off.cost_ledger_result == "disabled"
    assert off.persist_cost_ledger() is False


def test_sidecar_reloads_and_saves_only_where_pointed(
        tmp_path, monkeypatch, cost_ledger_per_test):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    plan, lists = small_plan()
    reqs = generate_traffic(64, attack_fraction=0.5, seed=12)
    snapshots = []
    for step in range(2):
        ring = native_ring.Ring(str(tmp_path / f"ring{step}"),
                                capacity=128, create=True)
        try:
            sidecar = native_ring.RingSidecar(
                ring, plan, lists, max_batch=64, device="cpu",
                registry=MetricRegistry())
            assert sidecar.cost_ledger_result == ("missing", "ok")[step]
            if step:
                assert sidecar.sched.cost.snapshot() == snapshots[0]
            t = threading.Thread(target=sidecar.run, daemon=True)
            t.start()
            native_ring.drive_stream(ring, native_ring.pack_requests(reqs))
            sidecar.stop()
            t.join(30)
            snapshots.append(sidecar.sched.cost.snapshot())
        finally:
            ring.close()
    assert snapshots[0]["ewma_ms"]
    doc = json.loads(cost_ledger_per_test.read_text())
    assert set(doc["entries"]) == {"cpu|sidecar"}
    assert doc["entries"]["cpu|sidecar"]["cost"] == json.loads(
        json.dumps(snapshots[1]))
    assert list(cwd.iterdir()) == []


# -- plan fingerprints and the measured re-selection -------------------------------


@pytest.mark.parametrize("seed", [None, 5])
def test_plan_fingerprint_equals_the_reference(seed):
    kw = {} if seed is None else {"seed": seed}
    rules, lists = generate_ruleset(500, **kw)
    ref_rules, ref_lists = ref_generate_ruleset(500, **kw)
    port = compile_ruleset(rules, lists, device="cpu")
    ref = ref_compile(ref_rules, ref_lists)
    assert port.rule_names == ref.rule_names and len(port.rule_names) == 500
    assert perf.plan_fingerprint(port) == ref_perf.plan_fingerprint(ref)
    assert perf.staging_widths(port) == ref_perf.staging_widths(ref)
    # The recipe hashes rule names, staging caps, the DFA default and the
    # field specs, not the rules' expressions: the seed-5 corpus has the
    # same 500 names and caps, so it shares the default corpus's
    # fingerprint (and its cost-ledger entry). A corpus that drops a rule
    # does not.
    default_rules, default_lists = generate_ruleset(500)
    default = perf.plan_fingerprint(compile_ruleset(
        default_rules, default_lists, device="cpu"))
    assert perf.plan_fingerprint(port) == default
    assert perf.plan_fingerprint(compile_ruleset(
        rules[:-1], lists, device="cpu")) != default


def test_routed_plan_fingerprint_equals_the_reference():
    routes = {"api": 'http_request.path.starts_with("/api")',
              "assets": 'http_request.path.ends_with(".css")'}
    rules, lists = generate_ruleset(30, with_lists=False, seed=4)
    ref_rules, ref_lists = ref_generate_ruleset(30, with_lists=False, seed=4)
    port = compile_ruleset(rules, lists, device="cpu", routes=[
        (n, compile_expression(e)) for n, e in routes.items()])
    ref = ref_compile(ref_rules, ref_lists, routes=[
        (n, ref_compile_expression(e)) for n, e in routes.items()])
    assert port.rule_names[-2:] == ("route:api", "route:assets")
    assert port.rule_names == ref.rule_names
    assert perf.plan_fingerprint(port) == ref_perf.plan_fingerprint(ref)
    unrouted = compile_ruleset(rules, lists, device="cpu")
    assert perf.plan_fingerprint(unrouted) != perf.plan_fingerprint(port)


@pytest.fixture(scope="module")
def crs120():
    rules, lists = generate_ruleset(120, with_lists=True,
                                    list_sizes=(256, 64))
    ref_rules, ref_lists = ref_generate_ruleset(120, with_lists=True,
                                                list_sizes=(256, 64))
    return rules, lists, ref_compile(ref_rules, ref_lists)


COST_DICTS = [
    None,
    {"scan": 3.0, "pair": 2.0, "pallas": 1.0, "pallas_pair": 0.9},
    {"scan": 1.0, "pair": 5.0, "pallas": 5.0, "pallas_pair": 5.0},
    {"scan": 1.0},
    {"scan": 1.0, "pair": 1.3, "pallas": 0.1, "pallas_pair": 0.35,
     "dfa": 0.4},
]


@pytest.mark.parametrize("costs", COST_DICTS, ids=json.dumps)
def test_reselect_equals_the_reference(crs120, costs):
    import copy

    rules, lists, ref = crs120
    port = compile_ruleset(rules, lists, device="cpu")
    ref = copy.deepcopy(ref)
    plan_mod.reselect_scan_strategies(port, costs)
    ref_plan_mod.reselect_scan_strategies(ref, costs)
    assert list(port.scan_plans) == list(ref.scan_plans)
    assert any(e.dfa_key for e in port.scan_plans.values())
    for key, want in ref.scan_plans.items():
        assert dataclasses.asdict(port.scan_plans[key]) \
            == dataclasses.asdict(want), key
        assert port.scan_plans[key].strategy.source == "measured"


def test_cache_round_trip_keeps_the_measured_choice(tmp_path, crs120):
    rules, lists, _ = crs120
    cache_dir = str(tmp_path / "cache")
    plan1 = compile_ruleset_cached(rules, lists, cache_dir=cache_dir,
                                   device="cpu")
    assert all(e.strategy.source == "default"
               for e in plan1.scan_plans.values())
    costs = {"scan": 1.0, "pair": 5.0, "pallas": 5.0, "pallas_pair": 5.0,
             "dfa": 2.0}
    plan_mod.reselect_scan_strategies(plan1, costs)
    assert not any(e.dfa_auto for e in plan1.scan_plans.values())
    update_cached_plan(rules, lists, plan1, cache_dir)
    plan2 = compile_ruleset_cached(rules, lists, cache_dir=cache_dir,
                                   device="cpu")
    assert plan2.scan_plans == plan1.scan_plans
    assert all(e.strategy.source == "measured"
               and (e.strategy.kind, e.strategy.pair) == ("scan", False)
               for e in plan2.scan_plans.values())


def test_kind_cost_falls_back_as_the_reference():
    for c, kind, default in (({"scan": 2.0}, "scan", 1.0),
                             ({"scan": 2.0}, "dfa", 1.0),
                             ({"scan": 2.0}, "some_future_kind", 7.0),
                             ({}, "pallas_pair", 1.0)):
        assert plan_mod._kind_cost(c, kind, default) \
            == ref_plan_mod._kind_cost(c, kind, default)
    assert plan_mod.DEFAULT_STEP_COSTS == ref_plan_mod.DEFAULT_STEP_COSTS
