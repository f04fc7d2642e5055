"""Deadline-aware continuous-batching admission scheduler.

The admission core both planes drive (engine/service.py's collector,
native_ring.RingSidecar's drain loop), a copy of the JAX package's
`pingoo_tpu/sched/scheduler.py` policy:

  * every request carries its admit timestamp and a latency budget
    (`PINGOO_DEADLINE_MS`, default 2 ms);
  * `continuous` (the default) keeps filling the batch being assembled
    while the oldest request's slack still covers the estimated cost of
    serving it: "launch when full OR slack <= estimate"; `fixed` keeps
    the fixed assembly window (`max_wait_us` on the Python plane, one
    drain pass on the sidecar);
  * the estimate is an EWMA per padded-batch-size bucket (`CostModel`),
    stage-decomposed once the executor feeds per-stage walls, with
    megastep (K, bucket) windows and staged-bytes dispatch walls of
    their own;
  * a request whose deadline is unmeetable even by an immediate launch
    can fail open per `PINGOO_SCHED_FAILOPEN`: `serve` (the default:
    serve late, count the miss), `allow` (answer at once with the
    fail-open verdict, action 0) or `interpret` (the host interpreter,
    off the device path).

The policy is pure float math on the host: it reads no tensor and never
waits for the device. The counters live in `Scheduler.snapshot()` and
in the JAX package's `pingoo_sched_*` instruments and
`pingoo_mesh_devices` (1: one card) on the metric registry
(`SchedMetrics`).
Unlike the JAX package, the cost model is not seeded from a bench
history: `PINGOO_SCHED_SEED_MS`, else `DEFAULT_SEED_MS`. A plane then
reloads the durable cost ledger (`load_cost_ledger`, PINGOO_COST_LEDGER,
on by default as in the JAX package): the `CostModel` snapshot the last
run of the same backend, plane and plan saved at its drain
(`save_cost_ledger`), which overwrites the seed. The file format is the
JAX package's; the port's backend label is `cuda` on the card and `cpu`
when the caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..obs.schema import PERF_METRICS, SCHED_METRICS

# The pow2 launch-size ladder of `pingoo_sched_batch_size`'s buckets.
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                      2048, 4096)

# The default per-request deadline (the JAX package's 2 ms budget).
DEFAULT_DEADLINE_MS = 2.0

# EWMA smoothing of the cost model, as in the JAX package.
DEFAULT_ALPHA = 0.2

# The cost seed when PINGOO_SCHED_SEED_MS is unset: the wall of one
# full batch through the port's Python plane at its max_batch default
# (1,024 rows of the 500-rule corpus's traffic through evaluate_batch,
# pipelined executor, median of 8 after two warm-up batches). Five runs
# of chip_smoke.py's sched phase on one NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit gave medians of 46.4-70.4 ms; this is their
# median.
DEFAULT_SEED_MS = 54.40

SCHED_MODES = ("continuous", "fixed")
FAILOPEN_POLICIES = ("serve", "allow", "interpret")

# The executor's stages: the estimate is their sum once any has data.
PIPELINE_COST_STAGES = ("encode", "dispatch", "compute")

# How the seed splits across the stages before they are observed (the
# fractions sum to 1, so a pure-seed estimate is the whole-batch seed).
STAGE_SEED_SPLIT = {"encode": 0.3, "dispatch": 0.2, "compute": 0.5}


@dataclass(frozen=True)
class SchedulerConfig:
    """Static admission policy of one plane's scheduler."""

    mode: str = "continuous"
    deadline_ms: float = DEFAULT_DEADLINE_MS
    failopen: str = "serve"
    max_batch: int = 1024

    @classmethod
    def from_env(cls, max_batch: int) -> "SchedulerConfig":
        """PINGOO_SCHED_MODE (an unknown mode is `continuous`),
        PINGOO_DEADLINE_MS (a non-number is the default) and
        PINGOO_SCHED_FAILOPEN (an unknown policy is `serve`)."""
        mode = os.environ.get("PINGOO_SCHED_MODE", "continuous")
        if mode not in SCHED_MODES:
            mode = "continuous"
        try:
            deadline_ms = float(
                os.environ.get("PINGOO_DEADLINE_MS", DEFAULT_DEADLINE_MS))
        except ValueError:
            deadline_ms = DEFAULT_DEADLINE_MS
        failopen = os.environ.get("PINGOO_SCHED_FAILOPEN", "serve")
        if failopen not in FAILOPEN_POLICIES:
            failopen = "serve"
        return cls(mode=mode, deadline_ms=deadline_ms, failopen=failopen,
                   max_batch=max_batch)


def _pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _pow2_kb_bucket(nbytes: int) -> int:
    """Staged-bytes bucket of the dispatch cost: pow2 KB, at least 1."""
    kb = max(1, (max(0, int(nbytes)) + 1023) // 1024)
    b = 1
    while b < kb:
        b *= 2
    return b


class CostModel:
    """EWMA cost estimates (ms) per padded-batch-size bucket.

    Unobserved buckets fall back to an affine seed (half fixed, half
    proportional to the bucket). Once any executor stage is observed,
    `estimate` is the sum of the stage estimates, each falling back to
    its `STAGE_SEED_SPLIT` share of the whole-batch baseline. Megastep
    windows have EWMAs per (K, bucket), whose first observation (the
    window shape's graph capture) is kept apart; unobserved pairs are
    one dispatch plus K computes. Dispatch walls also have EWMAs per
    staged-bytes bucket, preferred by `estimate_dispatch`."""

    def __init__(self, max_batch: int = 1024,
                 seed_ms: Optional[float] = None,
                 alpha: float = DEFAULT_ALPHA):
        self.max_batch = max(1, int(max_batch))
        if seed_ms is None:
            env = os.environ.get("PINGOO_SCHED_SEED_MS")
            if env:
                try:
                    seed_ms = float(env)
                except ValueError:
                    seed_ms = None
            if seed_ms is None:
                seed_ms = DEFAULT_SEED_MS
        self.seed_ms = max(float(seed_ms), 1e-3)
        self.alpha = float(alpha)
        self._ewma: dict[int, float] = {}
        self._stage_ewma: dict[str, dict[int, float]] = {}
        self._mega_ewma: dict[tuple[int, int], float] = {}
        self._mega_first: dict[tuple[int, int], float] = {}
        self._dispatch_bytes_ewma: dict[int, float] = {}

    def _seed_for(self, bucket: int) -> float:
        cap = _pow2_bucket(self.max_batch, self.max_batch)
        return self.seed_ms * (0.5 + 0.5 * bucket / cap)

    def _baseline(self, bucket: int) -> float:
        est = self._ewma.get(bucket)
        return self._seed_for(bucket) if est is None else est

    def estimate(self, batch_size: int) -> float:
        """Expected wall (ms) of a batch whose padded size covers
        `batch_size` rows."""
        bucket = _pow2_bucket(max(1, batch_size), self.max_batch)
        base = self._baseline(bucket)
        if not self._stage_ewma:
            return base
        total = 0.0
        for stage in PIPELINE_COST_STAGES:
            est = self._stage_ewma.get(stage, {}).get(bucket)
            total += STAGE_SEED_SPLIT[stage] * base if est is None else est
        return total

    def estimate_stage(self, stage: str, batch_size: int) -> float:
        """Expected active wall (ms) of one executor stage."""
        bucket = _pow2_bucket(max(1, batch_size), self.max_batch)
        est = self._stage_ewma.get(stage, {}).get(bucket)
        if est is None:
            return STAGE_SEED_SPLIT.get(stage, 1.0) * self._baseline(bucket)
        return est

    @staticmethod
    def _blend(table: dict, key, ms: float, alpha: float) -> None:
        prev = table.get(key)
        table[key] = ms if prev is None else prev + alpha * (ms - prev)

    def observe(self, batch_size: int, ms: float) -> None:
        """One served batch's measured wall."""
        if ms < 0:
            return
        self._blend(self._ewma, _pow2_bucket(max(1, batch_size),
                                             self.max_batch), ms, self.alpha)

    def observe_stage(self, stage: str, batch_size: int, ms: float) -> None:
        """One executor stage's active wall (token waits excluded)."""
        if ms < 0 or stage not in STAGE_SEED_SPLIT:
            return
        self._blend(self._stage_ewma.setdefault(stage, {}),
                    _pow2_bucket(max(1, batch_size), self.max_batch), ms,
                    self.alpha)

    def estimate_megastep(self, k: int, batch_size: int) -> float:
        """Expected wall (ms) of one K-slice megastep window."""
        k = max(1, int(k))
        bucket = _pow2_bucket(max(1, batch_size), self.max_batch)
        est = self._mega_ewma.get((k, bucket))
        if est is not None:
            return est
        return (self.estimate_stage("dispatch", batch_size)
                + k * self.estimate_stage("compute", batch_size))

    def observe_megastep(self, k: int, batch_size: int, ms: float) -> None:
        """One completed window's wall; the first of a (K, bucket) pays
        its graph capture and is kept apart."""
        if ms < 0:
            return
        key = (max(1, int(k)),
               _pow2_bucket(max(1, batch_size), self.max_batch))
        if key not in self._mega_first:
            self._mega_first[key] = ms
            return
        self._blend(self._mega_ewma, key, ms, self.alpha)

    def estimate_dispatch(self, batch_size: int,
                          staged_bytes: Optional[int] = None) -> float:
        """Expected dispatch wall (ms), from the staged-bytes bucket when
        it has been observed."""
        if staged_bytes:
            est = self._dispatch_bytes_ewma.get(_pow2_kb_bucket(staged_bytes))
            if est is not None:
                return est
        return self.estimate_stage("dispatch", batch_size)

    def observe_dispatch_bytes(self, staged_bytes: int, ms: float) -> None:
        """One dispatch wall keyed by the batch's staged bytes."""
        if ms < 0 or not staged_bytes or staged_bytes <= 0:
            return
        self._blend(self._dispatch_bytes_ewma, _pow2_kb_bucket(staged_bytes),
                    ms, self.alpha)

    def snapshot(self) -> dict:
        return {"seed_ms": round(self.seed_ms, 4),
                "ewma_ms": {b: round(v, 4)
                            for b, v in sorted(self._ewma.items())},
                "stage_ewma_ms": {
                    stage: {b: round(v, 4)
                            for b, v in sorted(buckets.items())}
                    for stage, buckets in sorted(self._stage_ewma.items())},
                "megastep_ewma_ms": {
                    f"{k}x{b}": round(v, 4)
                    for (k, b), v in sorted(self._mega_ewma.items())},
                "megastep_first_ms": {
                    f"{k}x{b}": round(v, 4)
                    for (k, b), v in sorted(self._mega_first.items())},
                "dispatch_bytes_ewma_ms": {
                    f"{kb}kb": round(v, 4)
                    for kb, v in sorted(self._dispatch_bytes_ewma.items())}}

    def restore(self, snap: dict) -> bool:
        """Overwrite this model's state from a `snapshot()` (its keys may
        have been through JSON: bucket keys as strings, "KxB" megastep
        keys, "<kb>kb" bytes keys). Unparseable entries are skipped;
        True when any state was restored."""
        if not isinstance(snap, dict):
            return False
        restored = False
        seed = snap.get("seed_ms")
        if isinstance(seed, (int, float)) and seed > 0:
            self.seed_ms = max(float(seed), 1e-3)
            restored = True

        def buckets(raw):
            out = {}
            if isinstance(raw, dict):
                for b, v in raw.items():
                    try:
                        bucket, val = int(b), float(v)
                    except (TypeError, ValueError):
                        continue
                    if bucket > 0 and val >= 0:
                        out[bucket] = val
            return out

        def mega(raw):
            out = {}
            if isinstance(raw, dict):
                for key, v in raw.items():
                    try:
                        k_s, b_s = str(key).split("x", 1)
                        out[(int(k_s), int(b_s))] = float(v)
                    except (TypeError, ValueError):
                        continue
            return out

        ewma = buckets(snap.get("ewma_ms"))
        if ewma:
            self._ewma = ewma
            restored = True
        stage_raw = snap.get("stage_ewma_ms")
        if isinstance(stage_raw, dict):
            stage = {name: parsed for name, raw in stage_raw.items()
                     if name in STAGE_SEED_SPLIT
                     for parsed in [buckets(raw)] if parsed}
            if stage:
                self._stage_ewma = stage
                restored = True
        for attr, key in (("_mega_ewma", "megastep_ewma_ms"),
                          ("_mega_first", "megastep_first_ms")):
            parsed = mega(snap.get(key))
            if parsed:
                setattr(self, attr, parsed)
                restored = True
        disp_raw = snap.get("dispatch_bytes_ewma_ms")
        if isinstance(disp_raw, dict):
            disp = {}
            for key, v in disp_raw.items():
                try:
                    kb, val = int(str(key).rstrip("kb")), float(v)
                except (TypeError, ValueError):
                    continue
                if kb > 0 and val >= 0:
                    disp[kb] = val
            if disp:
                self._dispatch_bytes_ewma = disp
                restored = True
        return restored


# -- the durable cost ledger ------------------------------------------------
#
# CostModel snapshots, saved at a plane's drain and reloaded at its boot,
# keyed by "<backend>|<plane>" and versioned by the plan's fingerprint
# (obs/perf.plan_fingerprint): a reload only ever restores costs measured
# on the same backend under the same plan.

COST_LEDGER_VERSION = 1
DEFAULT_COST_LEDGER = "COST_LEDGER.json"


def cost_ledger_path() -> Optional[str]:
    """PINGOO_COST_LEDGER: unset or empty -> the default path (on by
    default: it is boot- and drain-time IO only); `0`/`off` -> disabled;
    anything else is the path."""
    raw = os.environ.get("PINGOO_COST_LEDGER", "").strip()
    if raw.lower() in ("0", "off", "false", "none"):
        return None
    if not raw or raw.lower() in ("1", "on", "true"):
        return DEFAULT_COST_LEDGER
    return raw


def _reload_counter(plane: str, result: str, registry=None):
    """`pingoo_costmodel_reload_total{plane,result}`."""
    if registry is None:
        from ..obs.registry import REGISTRY as registry  # noqa: N813
    return registry.counter(
        "pingoo_costmodel_reload_total",
        PERF_METRICS["pingoo_costmodel_reload_total"],
        labels={"plane": plane, "result": result})


def load_cost_ledger(cost: CostModel, *, backend: str, fingerprint: str,
                     plane: str, path: Optional[str] = None,
                     registry=None) -> str:
    """Boot-time reload of this plane's saved CostModel snapshot. Returns
    the result it counted: `ok` (restored), `stale` (another version or
    plan fingerprint: discarded), `missing` (no file, or no entry for
    this backend and plane), `error` (unreadable), or `disabled` (gated
    off; nothing counted)."""
    import json

    if path is None:
        path = cost_ledger_path()
    if path is None:
        return "disabled"
    # Every result's series exists from boot, whichever fires.
    for result in ("ok", "stale", "missing", "error"):
        _reload_counter(plane, result, registry)
    try:
        if not os.path.exists(path):
            _reload_counter(plane, "missing", registry).inc()
            return "missing"
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        _reload_counter(plane, "error", registry).inc()
        return "error"
    if not isinstance(doc, dict) \
            or doc.get("version") != COST_LEDGER_VERSION:
        _reload_counter(plane, "stale", registry).inc()
        return "stale"
    entry = (doc.get("entries") or {}).get(f"{backend}|{plane}")
    if not isinstance(entry, dict):
        _reload_counter(plane, "missing", registry).inc()
        return "missing"
    if entry.get("fingerprint") != fingerprint:
        _reload_counter(plane, "stale", registry).inc()
        return "stale"
    if not cost.restore(entry.get("cost") or {}):
        _reload_counter(plane, "error", registry).inc()
        return "error"
    _reload_counter(plane, "ok", registry).inc()
    return "ok"


def save_cost_ledger(cost: CostModel, *, backend: str, fingerprint: str,
                     plane: str, path: Optional[str] = None) -> bool:
    """Drain-time save of this plane's CostModel snapshot: read, merge
    (other backend|plane entries stay), write atomically through a
    temporary file and a rename. False when the ledger is off or the
    file cannot be written (an OSError), so a full disk never blocks
    shutdown."""
    import json
    import time

    if path is None:
        path = cost_ledger_path()
    if path is None:
        return False
    doc: dict = {"version": COST_LEDGER_VERSION, "entries": {}}
    try:
        with open(path) as f:
            prior = json.load(f)
        if isinstance(prior, dict) \
                and prior.get("version") == COST_LEDGER_VERSION \
                and isinstance(prior.get("entries"), dict):
            doc["entries"] = prior["entries"]
    except (OSError, ValueError):
        pass
    doc["entries"][f"{backend}|{plane}"] = {
        "ts": round(time.time(), 3),
        "backend": backend,
        "plane": plane,
        "fingerprint": fingerprint,
        "cost": cost.snapshot(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


class SchedMetrics:
    """The plane's `pingoo_sched_*` instruments (obs/schema.py
    SCHED_METRICS), created at construction so both planes expose the
    whole family from boot. The serving mesh is one device here."""

    def __init__(self, plane: str, registry=None):
        if registry is None:
            from ..obs.registry import REGISTRY as registry  # noqa: N813
        labels = {"plane": plane}
        self.queue_depth = registry.gauge(
            "pingoo_sched_queue_depth",
            SCHED_METRICS["pingoo_sched_queue_depth"], labels=labels)
        self.batch_size = registry.histogram(
            "pingoo_sched_batch_size",
            SCHED_METRICS["pingoo_sched_batch_size"],
            buckets=BATCH_SIZE_BUCKETS, labels=labels)
        self.deadline_miss = registry.counter(
            "pingoo_sched_deadline_miss_total",
            SCHED_METRICS["pingoo_sched_deadline_miss_total"], labels=labels)
        self.failopen = registry.counter(
            "pingoo_sched_failopen_total",
            SCHED_METRICS["pingoo_sched_failopen_total"], labels=labels)
        self.mesh_devices = registry.gauge(
            "pingoo_mesh_devices", SCHED_METRICS["pingoo_mesh_devices"],
            labels=labels)
        self.mesh_devices.set(1)


class Scheduler:
    """One plane's admission scheduler: the launch policy and deadline
    accounting over its cost model.

    Timestamps are `time.monotonic()` seconds on the Python plane; the
    sidecar passes the ring's `enq_ms` clock in seconds."""

    def __init__(self, config: SchedulerConfig, plane: str = "python",
                 cost_model: Optional[CostModel] = None, registry=None):
        self.config = config
        self.plane = plane
        self.cost = cost_model or CostModel(max_batch=config.max_batch)
        self.metrics = SchedMetrics(plane, registry=registry)
        self.launches = 0
        self.deadline_misses = 0
        self.failopens = 0

    # -- launch policy ---------------------------------------------------------

    def wait_budget_s(self, n_pending: int, oldest_admit_s: float,
                      now_s: float) -> float:
        """How much longer the batch may assemble (s; <= 0: launch now):
        the oldest request's slack less the estimated cost of serving the
        batch at its current size."""
        if n_pending >= self.config.max_batch:
            return 0.0
        deadline_at = oldest_admit_s + self.config.deadline_ms / 1e3
        return (deadline_at - now_s) - self.cost.estimate(n_pending) / 1e3

    def should_launch(self, n_pending: int, oldest_admit_s: float,
                      now_s: float) -> bool:
        """Launch when full or when the oldest request's slack no longer
        covers the estimate."""
        return (n_pending >= self.config.max_batch
                or self.wait_budget_s(n_pending, oldest_admit_s,
                                      now_s) <= 0.0)

    def unmeetable(self, admit_s: float, now_s: float,
                   batch_size: int) -> bool:
        """True when this request's deadline cannot be met even by an
        immediate launch: the fail-open trigger."""
        deadline_at = admit_s + self.config.deadline_ms / 1e3
        return now_s + self.cost.estimate(batch_size) / 1e3 > deadline_at

    def size_megastep_k(self, k_ladder, batch_size: int,
                        oldest_admit_s: float, now_s: float) -> int:
        """The largest K rung whose estimated window still fits the
        oldest slice's slack; never below 1."""
        slack_ms = (oldest_admit_s + self.config.deadline_ms / 1e3
                    - now_s) * 1e3
        k = 1
        for rung in k_ladder:
            if rung != 1 and \
                    self.cost.estimate_megastep(rung, batch_size) <= slack_ms:
                k = rung
        return k

    # -- accounting --------------------------------------------------------------

    def note_launch(self, batch_size: int, queue_depth: int) -> None:
        """One batch left admission for the device."""
        self.launches += 1
        self.metrics.batch_size.observe(batch_size)
        self.metrics.queue_depth.set(queue_depth)

    def note_resolved(self, admit_s: float, resolve_s: float) -> bool:
        """Per-request deadline accounting; True on a miss."""
        missed = (resolve_s - admit_s) * 1e3 > self.config.deadline_ms
        if missed:
            self.deadline_misses += 1
            self.metrics.deadline_miss.inc()
        return missed

    def note_misses(self, n: int) -> None:
        """Misses counted by the caller (the sidecar's one vectorized
        compare per batch)."""
        if n > 0:
            self.deadline_misses += n
            self.metrics.deadline_miss.inc(n)

    def note_failopen(self, n: int = 1) -> None:
        self.failopens += n
        self.metrics.failopen.inc(n)

    def observe_cost(self, batch_size: int, ms: float) -> None:
        self.cost.observe(batch_size, ms)

    def observe_stage_cost(self, stage: str, batch_size: int,
                           ms: float) -> None:
        self.cost.observe_stage(stage, batch_size, ms)

    def observe_megastep_cost(self, k: int, batch_size: int,
                              ms: float) -> None:
        self.cost.observe_megastep(k, batch_size, ms)

    def observe_dispatch_bytes(self, staged_bytes: int, ms: float) -> None:
        self.cost.observe_dispatch_bytes(staged_bytes, ms)

    def snapshot(self) -> dict:
        return {
            "mode": self.config.mode,
            "deadline_ms": self.config.deadline_ms,
            "failopen_policy": self.config.failopen,
            "launches": self.launches,
            "deadline_misses": self.deadline_misses,
            "failopens": self.failopens,
            "cost_model": self.cost.snapshot(),
        }
