"""Compile ledger: every compile the port pays, counted and durable.

The JAX package's latency cliffs are XLA compiles; its ledger
(`pingoo_tpu/obs/perf.py`) records each as an event. The port's eager
per-batch programs compile nothing per shape, so its cliffs are others.
What counts as a compile here:

  * **A CUDA-graph capture** (engine/graphs.py `MegastepRunner._capture`,
    the warm-up run on the capture stream included): `fn="megastep"`,
    `cold` for a runner's first capture and `warm` for each later new
    key. `batch_bucket` is the key's rows, `k` its `k_ship`, `widths`
    its per-field byte widths (sorted by field): each read from the
    graph key, not guessed from argument shapes.
  * **An nvcc build that actually runs** (ops/_build.build). A hit in
    the hash-keyed `_build/` cache is none, as a hit in a persistent
    compilation cache is none. On the Python plane it is the event of
    the instrumented `verdict` program whose call needed it (`cold` at
    its first such call, `warm` after), with that call's wall, which
    holds the build: as in the JAX package, where the Pallas lowering
    is part of the first verdict compile. The sidecar builds at
    construction, before any lane call (`record_build`): a build that
    ran there is its `lanes` program's `cold` event, with the build's
    wall, and its lane programs are not wrapped.
  * **Nothing else.** The eager programs (`verdict`, `lanes`,
    `prefilter`, `score`) compile nothing else; their series exist at
    zero from `ensure_instruments`, so a scrape's inventory is the JAX
    package's. No `fn` outside `COMPILE_FN_KINDS` is emitted.

Every event lands in the process-global `CompileLedger`: a bounded ring
(`PINGOO_PERF_LEDGER_N`, dumped by `/__pingoo/compileledger`), the
`pingoo_compile_total{plane,fn,kind}` counter and the
`pingoo_compile_ms{plane,fn}` histogram (on the registry of the plane
that paid it), `pingoo_compile_unexpected_total{plane,fn}` for an event
outside the surface file `PINGOO_COMPILE_SURFACE` names, and, when
`PINGOO_PERF_LEDGER` names a file, one JSONL line per event.

Gating: unset or 0 `PINGOO_PERF_LEDGER` makes `instrument_jit` and
`instrument_megastep` return their argument itself, so the served path
does no added work (the series are still created at zero). `1`/`on`
enables it with the default `PERF_LEDGER.jsonl` in the working
directory; any other value is the ledger's path. The ledger's work runs
only on the build or capture branch: a served call reads one
thread-local counter before and after, and never syncs the device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter, deque
from typing import Any, Callable, Optional

from . import schema

# The fn label values the ledger emits (the JAX package's inventory).
COMPILE_FN_KINDS = ("verdict", "lanes", "prefilter", "megastep", "score")

# pingoo_compile_ms bounds: sub-ms up to the multi-second cold compiles.
COMPILE_BUCKETS_MS = (1.0, 5.0, 25.0, 100.0, 250.0, 500.0, 1000.0,
                      2500.0, 5000.0, 10000.0, 30000.0)

DEFAULT_LEDGER_FILE = "PERF_LEDGER.jsonl"
_EVENTS_CAP = 1024


def perf_ledger_path() -> Optional[str]:
    """The PINGOO_PERF_LEDGER gate: None = off (the default), otherwise
    the JSONL path compile events persist to."""
    raw = os.environ.get("PINGOO_PERF_LEDGER", "").strip()
    if not raw or raw.lower() in ("0", "off", "false"):
        return None
    if raw.lower() in ("1", "on", "true"):
        return DEFAULT_LEDGER_FILE
    return raw


def plan_fingerprint(plan) -> str:
    """A ruleset-epoch fingerprint of the plan's static content (rule
    names, staging caps, DFA default mode, field specs), the JAX
    package's recipe: equal plans of the two packages hash alike. It
    versions the compile events and the durable cost ledger
    (sched/scheduler.py)."""
    import hashlib

    h = hashlib.sha256()
    for name in getattr(plan, "rule_names", None) or ():
        h.update(str(name).encode("utf-8", "replace"))
        h.update(b"\x00")
    caps = getattr(plan, "staging_caps", None) or {}
    for field in sorted(caps):
        h.update(f"{field}={caps[field]}".encode())
    h.update(str(getattr(plan, "dfa_default_mode", "")).encode())
    h.update(str(getattr(plan, "field_specs", "")).encode())
    return h.hexdigest()[:16]


def staging_widths(plan) -> tuple:
    """The plan's staging widths tuple (sorted field -> cap)."""
    caps = getattr(plan, "staging_caps", None) or {}
    return tuple((f, int(caps[f])) for f in sorted(caps))


def _arg_shapes(args) -> list:
    """Tensor and array shapes of a call's arguments (and of the values
    of its dict arguments), at most 24; read on the compile branch
    only."""
    shapes = []
    stack = list(reversed(args))
    while stack and len(shapes) < 24:
        leaf = stack.pop()
        if isinstance(leaf, dict):
            stack.extend(reversed(list(leaf.values())))
            continue
        shp = getattr(leaf, "shape", None)
        if isinstance(shp, tuple) and len(shp):
            shapes.append(tuple(int(d) for d in shp))
    return shapes


def _shape_context(shapes: list) -> tuple:
    """(batch_bucket, k) from argument shapes: the most common leading
    dim of the 2-D arrays, and of the 3-D (stacked) ones."""
    lead2 = Counter(s[0] for s in shapes if len(s) == 2)
    bucket = lead2.most_common(1)[0][0] if lead2 else None
    lead3 = Counter(s[0] for s in shapes if len(s) == 3)
    k = lead3.most_common(1)[0][0] if lead3 else None
    return bucket, k


def load_compile_surface(path: str) -> Optional[dict]:
    """Read a compile-surface file; None for an unreadable or malformed
    one (the ledger then checks no event against a surface)."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) and "fns" in doc else None
    except (OSError, ValueError):
        return None


def event_in_surface(event: dict, surface: dict) -> Optional[str]:
    """None when a compile event lies inside the admissible surface;
    else the axis that left it."""
    if event.get("plane") not in surface.get("planes", ()):
        return f"plane={event.get('plane')!r}"
    if event.get("fn") not in surface.get("fns", ()):
        return f"fn={event.get('fn')!r}"
    if event.get("kind") not in surface.get("kinds", ()):
        return f"kind={event.get('kind')!r}"
    bucket = event.get("batch_bucket")
    if bucket is not None and bucket not in surface.get(
            "batch_buckets", ()):
        return f"batch_bucket={bucket}"
    k = event.get("k")
    if k is not None and k not in surface.get("k_rungs", ()):
        return f"k={k}"
    widths = [list(w) for w in event.get("widths") or ()]
    if widths and "widths" in surface and widths not in surface["widths"]:
        return "widths"
    return None


_SURFACE_UNSET = object()

# The padded launch rows of the next instrumented call, stamped by the
# planes right before it (per thread: the Python plane and the sidecar
# dispatch on threads of their own).
_DISPATCH_TLS = threading.local()

# nvcc builds that ran on each thread (ops/_build.build counts them):
# an instrumented call whose count moved paid a build.
_BUILD_TLS = threading.local()


def set_dispatch_context(batch: Optional[int] = None,
                         k: Optional[int] = None) -> None:
    _DISPATCH_TLS.batch = batch
    _DISPATCH_TLS.k = k


def dispatch_context() -> tuple:
    return (getattr(_DISPATCH_TLS, "batch", None),
            getattr(_DISPATCH_TLS, "k", None))


def batch_leading_dim(arrays) -> Optional[int]:
    """Padded launch rows of a per-field arrays mapping (the leading dim
    of any 2-D request array)."""
    for a in arrays.values():
        shape = getattr(a, "shape", ())
        if len(shape) >= 2:
            return int(shape[0])
    return None


def note_build() -> None:
    """One nvcc build ran on this thread (ops/_build.build, after it)."""
    _BUILD_TLS.builds = getattr(_BUILD_TLS, "builds", 0) + 1


def _builds() -> int:
    return getattr(_BUILD_TLS, "builds", 0)


def record_build(build: Callable[[], Any], *, plane: str, fn: str,
                 fingerprint: str = "", widths: tuple = (), ledger=None,
                 registry=None):
    """Run `build` (ops/_build.build) outside any served call; if it ran
    nvcc, note that as program `fn`'s cold compile with the build's
    wall. Returns what `build` returns."""
    if ledger is None:
        ledger = get_compile_ledger()
    before = _builds()
    t0 = time.monotonic()
    out = build()
    if ledger.enabled and _builds() != before:
        ledger.note(plane=plane, fn=fn, kind="cold",
                    wall_ms=(time.monotonic() - t0) * 1e3,
                    fingerprint=fingerprint, widths=widths,
                    registry=registry)
    return out


class CompileLedger:
    """Process-global sink of compile events, shared by both planes. Its
    series go on the registry of the plane that paid each event
    (`registry=`), else on the one the ledger was made with."""

    def __init__(self, path: Optional[str] = None, registry=None):
        self.path = path
        self._lock = threading.Lock()
        self.events: deque = deque(maxlen=int(
            os.environ.get("PINGOO_PERF_LEDGER_N", _EVENTS_CAP)))
        self.totals: dict[tuple, int] = {}
        self._registry = registry
        self._io_errors = 0
        self._surface_doc: Any = _SURFACE_UNSET
        self.unexpected_total = 0

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def _reg(self, registry=None):
        if registry is not None:
            return registry
        if self._registry is None:
            from .registry import REGISTRY

            self._registry = REGISTRY
        return self._registry

    def _surface(self) -> Optional[dict]:
        # Read once per ledger, on the first event.
        if self._surface_doc is _SURFACE_UNSET:
            path = os.environ.get("PINGOO_COMPILE_SURFACE")
            self._surface_doc = load_compile_surface(path) if path else None
        return self._surface_doc

    def _counter(self, plane: str, fn: str, kind: str, registry=None):
        return self._reg(registry).counter(
            "pingoo_compile_total", schema.PERF_METRICS["pingoo_compile_total"],
            labels={"plane": plane, "fn": fn, "kind": kind})

    def _hist(self, plane: str, fn: str, registry=None):
        return self._reg(registry).histogram(
            "pingoo_compile_ms", schema.PERF_METRICS["pingoo_compile_ms"],
            buckets=COMPILE_BUCKETS_MS, labels={"plane": plane, "fn": fn})

    def ensure_instruments(self, plane: str, registry=None) -> None:
        """Create the plane's compile series at zero (at boot, so that
        they are scraped before any event)."""
        for fn in COMPILE_FN_KINDS:
            for kind in ("cold", "warm"):
                self._counter(plane, fn, kind, registry)
            self._hist(plane, fn, registry)

    def note(self, *, plane: str, fn: str, kind: str, wall_ms: float,
             fingerprint: str = "", widths: tuple = (),
             shapes: Optional[list] = None,
             batch_bucket: Optional[int] = None,
             k: Optional[int] = None, registry=None) -> None:
        """One compile event. An explicit batch_bucket or k wins over the
        argument-shape heuristic."""
        h_bucket, h_k = _shape_context(shapes or [])
        bucket = batch_bucket if batch_bucket is not None else h_bucket
        k = k if k is not None else h_k
        event = {
            "ts": round(time.time(), 3),
            "plane": plane,
            "fn": fn,
            "kind": kind,
            "wall_ms": round(wall_ms, 3),
            "batch_bucket": bucket,
            "k": k,
            "widths": [list(w) for w in widths],
            "fingerprint": fingerprint,
            "shapes": [list(s) for s in (shapes or [])[:12]],
        }
        surface = self._surface()
        if surface is not None:
            reason = event_in_surface(event, surface)
            if reason is not None:
                event["unexpected"] = reason
                self._reg(registry).counter(
                    "pingoo_compile_unexpected_total",
                    schema.PERF_METRICS["pingoo_compile_unexpected_total"],
                    labels={"plane": plane, "fn": fn}).inc()
        self._counter(plane, fn, kind, registry).inc()
        self._hist(plane, fn, registry).observe(wall_ms)
        with self._lock:
            self.events.append(event)
            tkey = (plane, fn, kind)
            self.totals[tkey] = self.totals.get(tkey, 0) + 1
            if event.get("unexpected"):
                self.unexpected_total += 1
            if self.path:
                try:
                    with open(self.path, "a") as f:
                        f.write(json.dumps(event) + "\n")
                except OSError:
                    self._io_errors += 1

    def snapshot(self) -> dict:
        """The /__pingoo/compileledger payload."""
        with self._lock:
            events = list(self.events)
            totals = {f"{p}/{fn}/{kind}": n
                      for (p, fn, kind), n in sorted(self.totals.items())}
        return {
            "enabled": self.enabled,
            "path": self.path,
            "compiles_total": sum(totals.values()),
            "totals": totals,
            "io_errors": self._io_errors,
            "surface_loaded": self._surface() is not None,
            "unexpected_total": self.unexpected_total,
            "events": events,
        }


_LEDGER: Optional[CompileLedger] = None
_LEDGER_LOCK = threading.Lock()


def get_compile_ledger() -> CompileLedger:
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = CompileLedger(path=perf_ledger_path())
    return _LEDGER


def reset_compile_ledger_for_tests() -> None:
    """Drop the singleton so that PINGOO_PERF_LEDGER is read again."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = None


class _InstrumentedProgram:
    """A served program whose calls are watched for nvcc builds: one
    thread-local read before and after each call; the event branch runs
    only when a build ran inside it. Attribute access delegates to the
    wrapped callable."""

    __slots__ = ("_fn", "_plane", "_name", "_fingerprint", "_widths",
                 "_ledger", "_registry", "_compiles")

    def __init__(self, fn: Callable, name: str, plane: str,
                 fingerprint: str, widths: tuple, ledger: CompileLedger,
                 registry=None):
        self._fn = fn
        self._plane = plane
        self._name = name
        self._fingerprint = fingerprint
        self._widths = widths
        self._ledger = ledger
        self._registry = registry
        self._compiles = 0

    def __call__(self, *args, **kwargs):
        before = _builds()
        t0 = time.monotonic()
        out = self._fn(*args, **kwargs)
        if _builds() != before:
            wall_ms = (time.monotonic() - t0) * 1e3
            kind = "cold" if self._compiles == 0 else "warm"
            self._compiles += 1
            ctx_batch, ctx_k = dispatch_context()
            self._ledger.note(
                plane=self._plane, fn=self._name, kind=kind,
                wall_ms=wall_ms, fingerprint=self._fingerprint,
                widths=self._widths, shapes=_arg_shapes(args),
                batch_bucket=ctx_batch, k=ctx_k, registry=self._registry)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


def instrument_jit(fn, name: str, *, plane: str, fingerprint: str = "",
                   widths: tuple = (), ledger=None, registry=None):
    """Watch one served program for compiles (the nvcc builds its calls
    run). With the PINGOO_PERF_LEDGER gate off this returns `fn` itself;
    None passes through."""
    if fn is None:
        return None
    if ledger is None:
        ledger = get_compile_ledger()
    ledger.ensure_instruments(plane, registry)
    if not ledger.enabled:
        return fn
    return _InstrumentedProgram(fn, name, plane, fingerprint, widths,
                                ledger, registry)


class _InstrumentedMegastep:
    """A megastep program whose graph captures reach the ledger:
    `MegastepRunner` calls `note_capture` after each capture; everything
    else delegates to the program."""

    __slots__ = ("_prog", "_plane", "_fingerprint", "_ledger", "_registry")

    def __init__(self, prog, plane: str, fingerprint: str,
                 ledger: CompileLedger, registry=None):
        self._prog = prog
        self._plane = plane
        self._fingerprint = fingerprint
        self._ledger = ledger
        self._registry = registry

    def note_capture(self, key: tuple, wall_ms: float, cold: bool) -> None:
        """One capture of graph `key` = (kind, k_ship, rows, per-field
        byte widths in STRING_FIELDS order, DFA mode)."""
        from ..engine.batch import STRING_FIELDS

        _, k_ship, rows, widths = key[:4]
        self._ledger.note(
            plane=self._plane, fn="megastep",
            kind="cold" if cold else "warm", wall_ms=wall_ms,
            fingerprint=self._fingerprint,
            widths=tuple(sorted(zip(STRING_FIELDS, widths))),
            batch_bucket=int(rows), k=int(k_ship), registry=self._registry)

    def __getattr__(self, item):
        return getattr(self._prog, item)


def instrument_megastep(prog, *, plane: str, fingerprint: str = "",
                        ledger=None, registry=None):
    """instrument_jit for a megastep program (engine/verdict.py
    `MegastepProgram`): its graph captures become `megastep` events,
    each with the widths of its graph key. With the gate off this
    returns `prog` itself."""
    if prog is None:
        return None
    if ledger is None:
        ledger = get_compile_ledger()
    ledger.ensure_instruments(plane, registry)
    if not ledger.enabled:
        return prog
    return _InstrumentedMegastep(prog, plane, fingerprint, ledger, registry)
