"""Shared metric registry: counters, gauges, fixed-bucket histograms.

The port's copy of the JAX package's `obs/registry.py`, which the port
keeps for itself (it imports nothing of the JAX package). One registry
per process backs every telemetry surface of the port: the Python
listener (host/httpd.py), the verdict service's stage histograms
(engine/service.py), the ring sidecar (native_ring.RingSidecar), the
scheduler, the degradation ladder, chaos, hot-swap and the body
scanner. The native C++ plane keeps its own counters (native/httpd.cc
Stats) but exposes them under the SAME metric names: obs/schema.py is
the inventory both sides are held to (tests/test_torch_obs.py).

Design constraints, in order:
  * hot-path cheap: Counter.inc is one integer add; Histogram.observe
    is a bisect into <=12 static bucket bounds. No locks on writes:
    every writer runs on the event loop, the sidecar's drain thread or
    under its plane's own lock, and a read of a Python int is never
    torn under the interpreter lock.
  * two expositions from one source: Prometheus text (the scrape
    format) and JSON.
  * external sources: collectors registered via `register_collector`
    run right before exposition, so values owned elsewhere (the shm
    ring telemetry block, listener and scanner counters) appear in the
    same scrape.

The Prometheus text of a sequence of calls is byte-identical to the JAX
package's for the same calls (tests/test_torch_metrics_parity.py).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Iterable, Optional

# Shared latency bucket bounds (milliseconds). The first seven match the
# native plane's verdict-wait histogram (native/httpd.cc record_wait:
# 1, 2, 5, 10, 50, 100, +inf) so the two planes' wait histograms are
# comparable bucket-for-bucket; 0.25/0.5 add sub-ms resolution for the
# on-chip stages and 1000 bounds the tail.
LATENCY_BUCKETS_MS = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 50.0, 100.0, 1000.0)

# The 7-bucket subset the native plane and the shm ring telemetry block
# use (upper bounds in ms; the last bucket is +inf).
WAIT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 50.0, 100.0, 1000.0)

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


def _check_name(name: str) -> str:
    if not name or name[0] not in _VALID_FIRST or any(
            ch not in _VALID_REST for ch in name):
        raise ValueError(f"invalid prometheus metric name {name!r}")
    return name


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace(
            '"', '\\"').replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f.is_integer():
        # "1", not "1.0": keeps le= labels identical across the Python
        # and native planes (the C++ exposition prints integers).
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonic counter. `set_total` exists for mirroring a counter
    owned by an external source (the shm telemetry block): collectors
    overwrite the absolute total at scrape time."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Optional[dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    def set_total(self, total) -> None:
        self._value = total

    @property
    def value(self):
        return self._value


class Gauge:
    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Optional[dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v

    def inc(self, n=1) -> None:
        self._value += n

    def dec(self, n=1) -> None:
        self._value -= n

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative exposition, Prometheus
    `le` semantics). Bounds are upper bounds; the +Inf bucket is
    implicit. `observe` is O(log n_buckets) with no allocation."""

    __slots__ = ("name", "labels", "bounds", "counts", "_count", "_sum")

    def __init__(self, name: str, bounds: Iterable[float],
                 labels: Optional[dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError(f"histogram bounds must be sorted: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self._count += 1
        self._sum += v

    def observe_n(self, v: float, n: int) -> None:
        """Record n identical observations (bucket-mirroring helper)."""
        self.counts[bisect_left(self.bounds, v)] += n
        self._count += n
        self._sum += v * n

    def set_bucket_counts(self, counts: Iterable[int],
                          total_sum: Optional[float] = None) -> None:
        """Overwrite from an external cumulative-free bucket array (the
        shm telemetry block ships per-bucket counts, not observations).
        `counts` must have len(bounds) + 1 entries (last = +Inf)."""
        counts = [int(c) for c in counts]
        if len(counts) != len(self.counts):
            raise ValueError(
                f"{self.name}: got {len(counts)} buckets, "
                f"want {len(self.counts)}")
        self.counts = counts
        self._count = sum(counts)
        if total_sum is not None:
            self._sum = float(total_sum)
        else:
            # Approximate the sum from bucket midpoints (upper bound for
            # the +Inf bucket) so rate math stays plausible.
            s = 0.0
            lo = 0.0
            for b, c in zip(self.bounds, counts):
                s += c * (lo + b) / 2.0
                lo = b
            s += counts[-1] * self.bounds[-1]
            self._sum = s

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (0..1) from the
        cumulative buckets; the +Inf bucket reports the largest finite
        bound (the same convention bench.py's `_hist_percentiles` uses —
        Infinity is not valid JSON)."""
        if self._count == 0:
            return 0.0
        need = q * self._count
        run = 0
        for bound, c in zip(self.bounds, self.counts):
            run += c
            if run >= need:
                return bound
        return self.bounds[-1]

    def snapshot(self) -> dict:
        cum = 0
        buckets = {}
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            buckets[_fmt_value(bound)] = cum
        buckets["+Inf"] = self._count
        return {"count": self._count, "sum": round(self._sum, 6),
                "buckets": buckets,
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99)}


class MetricRegistry:
    """Get-or-create instrument registry with Prometheus + JSON
    exposition. Instruments are keyed by (name, sorted labels); help
    text is per metric family."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._help: dict[str, tuple[str, str]] = {}  # name -> (type, help)
        self._collectors: list[Callable[[], None]] = []
        # Instrument creation can race (listener thread vs sidecar
        # thread first touch); mutation of live instruments does not.
        self._create_lock = threading.Lock()

    # -- instrument factories ------------------------------------------------

    def _get(self, cls, name, help_text, labels, **kw):
        _check_name(name)
        key = (name, tuple(sorted((labels or {}).items())))
        inst = self._metrics.get(key)
        if inst is None:
            with self._create_lock:
                inst = self._metrics.get(key)
                if inst is None:
                    inst = cls(name, labels=labels, **kw)
                    self._metrics[key] = inst
                    self._help.setdefault(
                        name, (cls.__name__.lower(), help_text))
        return inst

    def counter(self, name: str, help_text: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS_MS,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get(Histogram, name, help_text, labels,
                         bounds=buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """`fn` runs before every exposition to pull external values
        (shm ring telemetry, sidecar counters) into the registry."""
        with self._create_lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._create_lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _collect(self) -> None:
        for fn in list(self._collectors):
            try:
                fn()
            except Exception:
                # A broken external source must never take down the
                # scrape surface of everything else.
                pass

    # -- exposition ----------------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._collect()
        by_name: dict[str, list] = {}
        for (name, _), inst in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append(inst)
        out: list[str] = []
        for name, insts in by_name.items():
            kind, help_text = self._help.get(name, ("gauge", ""))
            if help_text:
                out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {kind}")
            for inst in insts:
                if isinstance(inst, Histogram):
                    cum = 0
                    for bound, c in zip(inst.bounds, inst.counts):
                        cum += c
                        lab = dict(inst.labels)
                        lab["le"] = _fmt_value(bound)
                        out.append(
                            f"{name}_bucket{_fmt_labels(lab)} {cum}")
                    lab = dict(inst.labels)
                    lab["le"] = "+Inf"
                    out.append(
                        f"{name}_bucket{_fmt_labels(lab)} {inst.count}")
                    out.append(f"{name}_sum{_fmt_labels(inst.labels)} "
                               f"{_fmt_value(inst.sum)}")
                    out.append(f"{name}_count{_fmt_labels(inst.labels)} "
                               f"{inst.count}")
                else:
                    out.append(f"{name}{_fmt_labels(inst.labels)} "
                               f"{_fmt_value(inst.value)}")
        return "\n".join(out) + "\n"

    def json_snapshot(self) -> dict:
        """{name: value | {labels-key: value} | histogram snapshot}."""
        self._collect()
        out: dict = {}
        for (name, labkey), inst in sorted(self._metrics.items()):
            val = (inst.snapshot() if isinstance(inst, Histogram)
                   else inst.value)
            if not labkey:
                out[name] = val
            else:
                slot = out.setdefault(name, {})
                if not isinstance(slot, dict) or "buckets" in slot:
                    out[name] = slot = {"": slot}
                slot[",".join(f"{k}={v}" for k, v in labkey)] = val
        return out

    def stage_snapshot(self, prefix: str = "pingoo_verdict_stage_ms") \
            -> dict:
        """Compact per-stage latency view (bench.py artifact embed and
        ServiceStats.snapshot): {stage: {count, p50_ms, p99_ms,
        mean_ms}} for every histogram in the `prefix` family."""
        out: dict = {}
        for (name, labkey), inst in self._metrics.items():
            if name != prefix or not isinstance(inst, Histogram):
                continue
            labs = dict(labkey)
            stage = labs.get("stage", "")
            plane = labs.get("plane", "")
            key = f"{plane}:{stage}" if plane else stage
            if inst.count:
                mean = inst.sum / inst.count
            else:
                mean = 0.0
            out[key or "all"] = {
                "count": inst.count,
                "p50_ms": inst.percentile(0.50),
                "p99_ms": inst.percentile(0.99),
                "mean_ms": round(mean, 4),
            }
        return out


_PROM_LINE = None  # compiled lazily (re import only when linting)


def lint_prometheus_text(text: str) -> list[str]:
    """Exposition-format lint shared by tests/test_obs.py and
    tools/check_metrics_schema.py. Checks line syntax, TYPE declarations
    preceding samples, histogram bucket monotonicity and the mandatory
    +Inf bucket / _sum / _count triple. Returns a list of problems
    (empty = clean)."""
    import re

    global _PROM_LINE
    if _PROM_LINE is None:
        _PROM_LINE = re.compile(
            r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
            r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
            r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
            r' (?:[+-]?(?:\d+(?:\.\d+)?(?:e[+-]?\d+)?|Inf|NaN))$')
    problems: list[str] = []
    typed: dict[str, str] = {}
    hist_buckets: dict[str, list[tuple[float, int]]] = {}
    hist_series: dict[str, set] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(f"line {i}: bad TYPE declaration: {line}")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            problems.append(f"line {i}: unknown comment form: {line}")
            continue
        if not _PROM_LINE.match(line):
            problems.append(f"line {i}: malformed sample: {line}")
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            problems.append(f"line {i}: sample without TYPE: {name}")
        if typed.get(base) == "histogram" and name.endswith("_bucket"):
            m = re.search(r'le="([^"]+)"', line)
            if not m:
                problems.append(f"line {i}: histogram bucket missing le=")
                continue
            le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
            series = re.sub(r',?le="[^"]+"', "", line.split(" ")[0])
            hist_buckets.setdefault(series, []).append(
                (le, int(float(line.rsplit(" ", 1)[1]))))
            hist_series.setdefault(base, set()).add(series)
    for series, buckets in hist_buckets.items():
        les = [b[0] for b in buckets]
        counts = [b[1] for b in buckets]
        if les != sorted(les):
            problems.append(f"{series}: le bounds not sorted")
        if counts != sorted(counts):
            problems.append(f"{series}: bucket counts not cumulative")
        if not les or les[-1] != float("inf"):
            problems.append(f"{series}: missing +Inf bucket")
    for base in hist_series:
        if f"{base}_sum" not in text:
            problems.append(f"{base}: missing _sum series")
        if f"{base}_count" not in text:
            problems.append(f"{base}: missing _count series")
    return problems


# The process-global registry every component shares. Tests that need
# isolation construct their own MetricRegistry.
REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return REGISTRY
