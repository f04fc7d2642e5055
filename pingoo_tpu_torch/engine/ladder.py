"""Degradation ladder: one explicit fallback state machine per plane.

A copy of the JAX package's `engine/ladder.py`. A rung's failure is
counted, logged with its error and probed back with exponential
backoff, so a transient device fault degrades service for seconds, not
for the life of the process.

Rungs (cheapest first):

  ==========  =====================================================
  pipeline    staging encoder -> the one-batch encode chain
  megastep    megastep window (one CUDA graph replay) -> per batch
  dfa         lowered DFAs -> the exact NFA scans
  mesh        (no caller until the mesh is ported, ROADMAP item 9b)
  device      the card's verdict programs -> the host interpreter
  body        body inspection -> metadata-only verdicts
  ==========  =====================================================

Every rung but `body` falls back to a path that gives the same verdicts
(each fallback is the oracle its fast path is tested against); a demoted
`body` rung answers body windows with action 0 and judges requests on
their metadata alone.

A kernel that fails to build or launch (`ops/_build.KernelBuildError`)
and a CUDA runtime fault (`ops/_build.DeviceFault`, an illegal address
say: CUDA errors are sticky) are no rung failures: every rung's handler
calls `ops/_build.never_demoted` first, so a broken kernel is never
hidden behind a fallback.

Caller protocol, per batch::

    if ladder.try_rung("device"):   # healthy, or a backoff probe
        try:
            ... fast path ...
            ladder.note_success("device")
        except Exception as exc:
            ladder.note_failure("device", exc)
            ... fallback ...
    else:
        ... fallback ...

`try_rung` on a demoted rung returns True at most once per backoff
window (the probe); a failed probe doubles the backoff (up to its cap),
a successful one re-promotes and resets it. The counts live in
`snapshot()`, and each failure also counts in the JAX package's
`pingoo_degrade_total{plane,rung}` on the metric registry (`registry=`,
the process's REGISTRY by default).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

from ..logging_utils import get_logger
from ..obs.schema import RESILIENCE_METRICS
from .verdict import dfa_dispatch_counts

RUNGS = ("pipeline", "megastep", "dfa", "mesh", "device", "body")

# What each rung falls back to (log and snapshot only).
FALLBACKS = {
    "pipeline": "legacy-encode",
    "megastep": "per-batch-dispatch",
    "dfa": "nfa-scan",
    "mesh": "single-device",
    "device": "host-interpreter",
    "body": "metadata-only",
}

log = get_logger(__name__)


class _Rung:
    __slots__ = ("name", "healthy", "errors", "demotions", "backoff_s",
                 "next_probe_at", "last_error")

    def __init__(self, name: str, base_backoff_s: float):
        self.name = name
        self.healthy = True
        self.errors = 0  # note_failure calls
        self.demotions = 0  # healthy -> demoted transitions
        self.backoff_s = base_backoff_s
        self.next_probe_at = 0.0
        self.last_error = ""


class DegradationLadder:
    """Per-plane rungs with exponential-backoff re-promotion. Driven from
    the plane's own loop; `clock` is injectable so tests can step probe
    windows without sleeping."""

    def __init__(self, plane: str, base_backoff_s: float = 1.0,
                 max_backoff_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if registry is None:
            from ..obs.registry import REGISTRY as registry  # noqa: N813
        self.plane = plane
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self._clock = clock
        self._rungs = {name: _Rung(name, base_backoff_s) for name in RUNGS}
        self._counters = {
            name: registry.counter(
                "pingoo_degrade_total",
                RESILIENCE_METRICS["pingoo_degrade_total"],
                labels={"plane": plane, "rung": name})
            for name in RUNGS}

    def healthy(self, rung: str) -> bool:
        return self._rungs[rung].healthy

    def try_rung(self, rung: str) -> bool:
        """Attempt this rung's fast path now? Healthy, or demoted with
        its backoff window over (a probe, once per window)."""
        r = self._rungs[rung]
        if r.healthy:
            return True
        now = self._clock()
        if now >= r.next_probe_at:
            r.next_probe_at = now + r.backoff_s
            return True
        return False

    def note_failure(self, rung: str,
                     exc: Optional[BaseException] = None) -> None:
        """Demote (or keep demoted): count, log, double the backoff."""
        r = self._rungs[rung]
        r.errors += 1
        r.last_error = repr(exc) if exc is not None else ""
        self._counters[rung].inc()
        if r.healthy:
            r.demotions += 1
            r.backoff_s = self.base_backoff_s
        else:
            r.backoff_s = min(self.max_backoff_s, r.backoff_s * 2.0)
        r.healthy = False
        r.next_probe_at = self._clock() + r.backoff_s
        log.warning("ladder demote", extra={"fields": {
            "plane": self.plane, "rung": rung, "fallback": FALLBACKS[rung],
            "backoff_s": round(r.backoff_s, 3), "errors": r.errors,
            "error": r.last_error}})

    def note_success(self, rung: str) -> None:
        """Re-promote after a successful probe; no-op while healthy."""
        r = self._rungs[rung]
        if r.healthy:
            return
        r.healthy = True
        r.backoff_s = self.base_backoff_s
        r.next_probe_at = 0.0
        log.info("ladder promote", extra={"fields": {
            "plane": self.plane, "rung": rung, "errors": r.errors}})

    def demoted(self) -> list[str]:
        return [n for n in RUNGS if not self._rungs[n].healthy]

    def snapshot(self) -> dict:
        """Per rung: health, fallback, errors, demotions, backoff and the
        last error."""
        return {
            name: {
                "healthy": r.healthy,
                "fallback": FALLBACKS[name],
                "errors": r.errors,
                "demotions": r.demotions,
                "backoff_s": round(r.backoff_s, 3),
                "last_error": r.last_error,
            }
            for name, r in self._rungs.items()
        }


class DfaRung:
    """The `dfa` and `device` rungs of one plane's verdict work, as the
    JAX package's `_dfa_rung_tick`/`_note_device_failure`/
    `_note_device_success`: a device error while the plan runs a lowered
    DFA (and PINGOO_DFA does not pin it) turns the plan's DFAs off (the
    exact NFA scans serve); only a failure without them demotes the
    device rung to the host interpreter. `reset(plan)` when a swap
    installs another plan. The megastep's graph key holds the plan's DFA
    mode (engine/graphs.py), so no graph of the other mode replays."""

    def __init__(self, ladder: DegradationLadder, plan):
        self.ladder = ladder
        self.reset(plan)

    def reset(self, plan) -> None:
        """Take `plan`'s own DFA mode as the one a probe restores."""
        self.mode0 = plan.dfa_default_mode
        self.probe = False

    def tick(self, plan) -> None:
        """When the demoted dfa rung's backoff is over, turn the plan's
        DFAs back on for one batch: its device success or failure then
        promotes or demotes the rung again."""
        if not self.ladder.healthy("dfa") and not self.probe \
                and self.ladder.try_rung("dfa"):
            plan.dfa_default_mode = self.mode0
            self.probe = True

    def failure(self, plan, exc: BaseException) -> None:
        if self.probe:
            self.ladder.note_failure("dfa", exc)
            plan.dfa_default_mode = "off"
            self.probe = False
        elif self.ladder.healthy("dfa") \
                and not os.environ.get("PINGOO_DFA") \
                and dfa_dispatch_counts(plan)[1] > 0:
            self.ladder.note_failure("dfa", exc)
            plan.dfa_default_mode = "off"
        else:
            self.ladder.note_failure("device", exc)

    def success(self) -> None:
        if self.probe:
            self.ladder.note_success("dfa")
            self.probe = False
        self.ladder.note_success("device")
