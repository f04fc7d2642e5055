"""The port's telemetry layer (pingoo_tpu_torch/obs): the JAX package's
tests/test_obs.py `TestRegistry`, `TestSchemaParity` and
`TestServiceStages`, run against the port's registry, schema, sources
and ServiceStats.

  * TestRegistry: counters, gauges, histograms (external bucket
    mirrors too), the Prometheus text and its lint, collectors, the
    per-stage snapshot.
  * TestSchemaParity: every plane of the port uses the inventory's
    names. The native plane's exposition is C++ string literals, so the
    port's copy of httpd.cc is its schema; the checks of the JAX
    package's metrics-schema audit that concern this slice run inline
    against the port's sources.
  * TestServiceStages: ServiceStats' keys and its bounded memory.
  * The sidecar's collector: the exported `pingoo_ring_*` values are
    `ring_telemetry()`, and a scrape after `stop()` reads no ring.

No card and no JAX: these import only the port.
"""

import threading
from pathlib import Path

import pytest

from pingoo_tpu_torch.obs import schema
from pingoo_tpu_torch.obs.registry import (
    LATENCY_BUCKETS_MS,
    WAIT_BUCKETS_MS,
    MetricRegistry,
    lint_prometheus_text,
)
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

PKG = Path(__file__).resolve().parent.parent / "pingoo_tpu_torch"


class TestRegistry:
    def test_counter_gauge_roundtrip(self):
        reg = MetricRegistry()
        c = reg.counter("t_total", "help")
        c.inc()
        c.inc(4)
        assert c.value == 5
        # get-or-create: same (name, labels) -> same instrument
        assert reg.counter("t_total") is c
        g = reg.gauge("t_depth", "help", labels={"plane": "x"})
        g.set(7)
        g.dec()
        assert g.value == 6
        assert reg.gauge("t_depth", labels={"plane": "y"}) is not g

    def test_histogram_buckets_and_percentiles(self):
        reg = MetricRegistry()
        h = reg.histogram("t_ms", "help", buckets=WAIT_BUCKETS_MS)
        for v in (0.4, 1.5, 1.5, 7, 60, 5000):
            h.observe(v)
        assert h.count == 6
        snap = h.snapshot()
        assert snap["buckets"]["1"] == 1
        assert snap["buckets"]["2"] == 3
        assert snap["buckets"]["+Inf"] == 6
        assert h.percentile(0.5) == 2.0  # bucket-upper-bound estimate
        # +inf observations report the largest finite bound
        assert h.percentile(1.0) == 1000.0

    def test_histogram_external_bucket_mirror(self):
        reg = MetricRegistry()
        h = reg.histogram("t_wait_ms", "", buckets=WAIT_BUCKETS_MS)
        h.set_bucket_counts([2, 1, 0, 0, 0, 0, 0, 1], total_sum=2000.0)
        assert h.count == 4
        assert h.sum == 2000.0
        assert h.percentile(0.5) == 1.0
        with pytest.raises(ValueError):
            h.set_bucket_counts([1, 2, 3])  # wrong arity

    def test_prometheus_text_lints_clean(self):
        reg = MetricRegistry()
        reg.counter("pingoo_requests_total", "requests",
                    labels={"plane": "python", "listener": "l0"}).inc(3)
        reg.gauge("pingoo_ring_depth", "depth",
                  labels={"plane": "native"}).set(2)
        h = reg.histogram("pingoo_verdict_wait_ms", "wait",
                          buckets=WAIT_BUCKETS_MS,
                          labels={"plane": "python"})
        for v in (0.5, 3, 3, 42, 1500):
            h.observe(v)
        text = reg.prometheus_text()
        assert lint_prometheus_text(text) == []
        assert ('pingoo_requests_total{listener="l0",plane="python"} 3'
                in text)
        assert ('pingoo_verdict_wait_ms_bucket{le="+Inf",plane="python"} 5'
                in text)
        assert "# TYPE pingoo_verdict_wait_ms histogram" in text

    def test_lint_catches_broken_exposition(self):
        bad = ("# TYPE x_total counter\n"
               "x_total{le=} 3\n")
        assert lint_prometheus_text(bad)
        no_type = "lonely_metric 1\n"
        assert any("without TYPE" in p
                   for p in lint_prometheus_text(no_type))
        non_cumulative = (
            "# TYPE h histogram\n"
            'h_bucket{le="1"} 5\n'
            'h_bucket{le="2"} 3\n'
            'h_bucket{le="+Inf"} 5\n'
            "h_sum 1\nh_count 5\n")
        assert any("cumulative" in p
                   for p in lint_prometheus_text(non_cumulative))
        missing_inf = (
            "# TYPE h histogram\n"
            'h_bucket{le="1"} 1\n'
            "h_sum 1\nh_count 1\n")
        assert any("+Inf" in p for p in lint_prometheus_text(missing_inf))

    def test_collectors_fold_external_sources(self):
        reg = MetricRegistry()

        def collect():
            reg.counter("ext_total", "ext").set_total(42)

        reg.register_collector(collect)
        assert "ext_total 42" in reg.prometheus_text()
        snap = reg.json_snapshot()
        assert snap["ext_total"] == 42
        reg.unregister_collector(collect)

    def test_broken_collector_never_breaks_scrape(self):
        reg = MetricRegistry()
        reg.counter("ok_total", "x").inc()

        def broken():
            raise RuntimeError("ring unmapped")

        reg.register_collector(broken)
        assert "ok_total 1" in reg.prometheus_text()

    def test_stage_snapshot_keys_by_plane(self):
        reg = MetricRegistry()
        reg.histogram("pingoo_verdict_stage_ms", "",
                      buckets=LATENCY_BUCKETS_MS,
                      labels={"plane": "python",
                              "stage": "encode"}).observe(0.3)
        reg.histogram("pingoo_verdict_stage_ms", "",
                      buckets=LATENCY_BUCKETS_MS,
                      labels={"plane": "sidecar",
                              "stage": "encode"}).observe(0.4)
        snap = reg.stage_snapshot()
        assert set(snap) == {"python:encode", "sidecar:encode"}
        assert snap["python:encode"]["count"] == 1


def _src(rel: str) -> str:
    return (PKG / rel).read_text()


class TestSchemaParity:
    """Every plane of the port uses the inventory's names for shared
    concepts. The native plane's exposition is C++ string literals, so
    its source is the schema."""

    def _native_source(self):
        return _src("native/httpd.cc")

    def test_native_exposes_inventory(self):
        src = self._native_source()
        for name in (set(schema.SHARED_METRICS) | set(schema.RING_METRICS)
                     | set(schema.NATIVE_METRICS)):
            assert name in src, f"native plane missing {name}"
        assert schema.SHARED_WAIT_HISTOGRAM + "_bucket" in src
        for key in schema.NATIVE_JSON_KEYS:
            assert f'"{key}"' in src

    def test_python_listener_exposes_shared_names(self):
        src = _src("host/httpd.py")
        for name in schema.SHARED_METRICS:
            assert name in src, f"python listener missing {name}"

    def test_sidecar_exports_ring_names(self):
        src = _src("native_ring.py")
        for name in schema.RING_METRICS:
            assert name in src, f"sidecar missing {name}"

    def test_wait_buckets_match_everywhere(self):
        # Registry bounds == documented shared bounds == the native
        # record_wait bounds == the ring telemetry bounds.
        from pingoo_tpu_torch.native_ring import WAIT_BUCKET_BOUNDS_MS

        assert tuple(WAIT_BUCKET_BOUNDS_MS) == schema.SHARED_WAIT_BUCKETS_MS
        assert tuple(int(b) for b in WAIT_BUCKETS_MS) == \
            schema.SHARED_WAIT_BUCKETS_MS
        assert "{1, 2, 5, 10, 50, 100, 1000}" in self._native_source()
        assert audit_problems() == []


def audit_problems() -> list[str]:
    """The JAX package's metrics-schema audit (its check_metrics_schema
    tool) over the port's sources, for the families this port has: the
    native exposition, the listener, the sidecar and the service, the
    prefilter, DFA, body, scheduler, staging, pipeline, resilience and
    hot-swap names, and a registry holding the whole inventory that
    lints clean. Provenance, parity and the compile and cost ledgers
    belong to later slices of the port and are not looked for."""
    problems = []
    native = _src("native/httpd.cc")
    for name in sorted(set(schema.SHARED_METRICS) | set(schema.RING_METRICS)
                       | set(schema.NATIVE_METRICS)
                       | {schema.SHARED_WAIT_HISTOGRAM}):
        if name not in native:
            problems.append(f"native/httpd.cc: missing metric {name}")
    listener = _src("host/httpd.py")
    for name in schema.SHARED_METRICS:
        if name not in listener:
            problems.append(f"host/httpd.py: missing metric {name}")
    for key in schema.PYTHON_JSON_KEYS:
        if f'"{key}"' not in listener:
            problems.append(f"host/httpd.py: missing JSON key {key!r}")
    sidecar = _src("native_ring.py")
    service = _src("engine/service.py")
    if "SHARED_WAIT_HISTOGRAM" not in service:
        problems.append("engine/service.py: missing shared wait histogram")
    # Every stage is timed but provenance, which the port does not run.
    for stage in schema.VERDICT_STAGES:
        if stage != "provenance" and f'"{stage}"' not in service:
            problems.append(f"engine/service.py: stage {stage!r} not timed")
    for family in (schema.PREFILTER_METRICS, schema.DFA_METRICS,
                   schema.STAGING_METRICS):
        for name in family:
            for src, label in ((service, "engine/service.py"),
                               (sidecar, "native_ring.py")):
                if name not in src:
                    problems.append(f"{label}: missing metric {name}")
    for rel, names in (
            ("engine/bodyscan.py", schema.BODY_METRICS),
            ("sched/scheduler.py", schema.SCHED_METRICS),
            ("obs/pipeline.py", schema.PIPELINE_METRICS),
            ("engine/ladder.py", ["pingoo_degrade_total"]),
            ("obs/chaos.py", ["pingoo_chaos_injected_total"]),
            ("engine/hotswap.py", ["pingoo_ruleset_epoch",
                                   "pingoo_ruleset_swap_total"]),
            ("native_ring.py", ["pingoo_reattach_reconciled_total",
                                "pingoo_sidecar_epoch"])):
        src = _src(rel)
        for name in names:
            if name not in src:
                problems.append(f"{rel}: missing metric {name}")
    for name in ("pingoo_body_windows_total", "pingoo_body_bytes_total",
                 "pingoo_body_flows_active", "pingoo_body_degrade_total",
                 "pingoo_sidecar_up", "pingoo_degraded_mode",
                 "pingoo_sidecar_epoch", "pingoo_degraded_entered_total"):
        if name not in native:
            problems.append(f"native/httpd.cc: missing metric {name}")
    for src, label in ((service, "engine/service.py"),
                       (sidecar, "native_ring.py")):
        for symbol in ("Scheduler", "PipelineStats", "DegradationLadder"):
            if symbol not in src:
                problems.append(f"{label}: wiring missing {symbol}")
    if "attach_metrics" not in listener or "attach_metrics" not in sidecar:
        problems.append("a plane does not attach its body scanner's metrics")
    reg = MetricRegistry()
    for name in sorted(schema.all_metric_names()):
        if name in (schema.SHARED_WAIT_HISTOGRAM, "pingoo_verdict_stage_ms"):
            reg.histogram(name, "x", labels={"plane": "python"}).observe(1)
        else:
            reg.counter(name, "x", labels={"plane": "python"}).inc()
    problems += lint_prometheus_text(reg.prometheus_text())
    return problems


class TestServiceStages:
    def test_service_stats_snapshot_backcompat_keys(self):
        from pingoo_tpu_torch.engine.service import ServiceStats

        stats = ServiceStats(registry=MetricRegistry())
        snap = stats.snapshot()
        # the JAX package's keys
        for key in ("batches", "requests", "device_errors", "score_errors",
                    "host_fallback_batches", "mean_occupancy", "dedup_hits",
                    "prefilter_candidate_rate", "scan_banks_skipped",
                    "dfa_banks", "dfa_rechecks", "verdict_p50_ms",
                    "verdict_p99_ms"):
            assert key in snap, key
        assert set(snap["stages"]) == set(schema.VERDICT_STAGES)

    def test_stage_observation_is_bounded_memory(self):
        from pingoo_tpu_torch.engine.service import ServiceStats

        stats = ServiceStats()
        for i in range(100_000):
            stats.wait_hist.observe(i % 7)
        assert stats.wait_hist.count >= 100_000
        assert len(stats.wait_hist.counts) == len(WAIT_BUCKETS_MS) + 1
        assert stats.snapshot()["verdict_p50_ms"] >= 1


def test_sidecar_collector_reads_ring_telemetry_and_not_after_stop(
        tmp_path, monkeypatch):
    """The sidecar's `pingoo_ring_*` values are its `ring_telemetry()`,
    the wait histogram's buckets those of the ring's block; `stop()`
    detaches the collector before a ring can be unmapped, so a later
    scrape calls no ring."""
    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    for name in ("PINGOO_MEGASTEP", "PINGOO_BODY_INSPECT", "PINGOO_CHAOS"):
        monkeypatch.delenv(name, raising=False)
    rules, lists = generate_ruleset(20, list_sizes=(64, 16), seed=7)
    plan = compile_ruleset(rules, lists, device="cpu")
    reqs = generate_traffic(48, attack_fraction=0.5, seed=1234, lists=lists)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    reg = MetricRegistry()
    sidecar = nr.RingSidecar(ring, plan, lists, max_batch=16, device="cpu",
                             registry=reg)
    t = threading.Thread(target=sidecar.run, daemon=True)
    t.start()
    try:
        got = nr.drive_stream(ring, nr.pack_requests(reqs))
        assert len(got.actions) == len(reqs)
        want = sidecar.ring_telemetry()
        snap = reg.json_snapshot()
        text = reg.prometheus_text()
    finally:
        sidecar.stop()
        t.join(30)
    lab = "plane=sidecar"
    for name, field in (("pingoo_ring_enqueued_total", "enqueued"),
                        ("pingoo_ring_dequeued_total", "dequeued"),
                        ("pingoo_ring_enqueue_full_total", "enqueue_full"),
                        ("pingoo_ring_verdicts_posted_total",
                         "verdicts_posted"),
                        ("pingoo_ring_verdict_post_full_total",
                         "verdict_post_full"),
                        ("pingoo_ring_depth", "depth"),
                        ("pingoo_ring_depth_hwm", "depth_hwm")):
        assert snap[name][lab] == want[field], name
    assert want["enqueued"] == want["verdicts_posted"] == len(reqs)
    hist = snap[schema.SHARED_WAIT_HISTOGRAM][lab]
    assert hist["count"] == sum(want["wait_hist"]) == len(reqs)
    assert hist["sum"] == float(want["wait_sum_ms"])
    assert lint_prometheus_text(text) == []
    assert snap["pingoo_sidecar_epoch"][lab] == sidecar.epoch

    calls = []
    monkeypatch.setattr(nr.Ring, "telemetry",
                        lambda self: calls.append(self) or {})
    ring.close()
    reg.prometheus_text()
    reg.json_snapshot()
    assert calls == []
