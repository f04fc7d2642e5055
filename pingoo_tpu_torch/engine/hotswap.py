"""Epoch-switched ruleset hot-swap (the JAX package's `engine/hotswap.py`).

A new RulesetPlan is compiled ahead of the switch (through the artifact
cache, off the serving path), and each plane flips to it at a batch
boundary: batches in flight finish on the old plan, later admissions use
the new one, and every verdict is attributable to exactly one epoch.
The swap pause (the drain of the batches in flight plus the flip, the
compile excluded by construction) is what a swap costs the traffic.

`TenantPlanStore` keeps one compiled plan per tenant key, fingerprinted
tenant-scoped in the artifact cache, so one deployment serves several
rulesets and swaps each on its own.

`note_swap` and `set_epoch_gauge` count on the metric registry, as in
the JAX package: `pingoo_ruleset_swap_total{plane,tenant,result}` and
`pingoo_ruleset_epoch{plane}`. `swap_counts` and `epoch_of` read those
same instruments back for the planes' statistics, so there is one
source.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..compiler.plan import RulesetPlan
from ..obs.registry import REGISTRY
from ..obs.schema import HOTSWAP_METRICS

# The registry's instruments, by (plane, tenant, result) and by plane,
# as note_swap and set_epoch_gauge made them in this process.
_lock = threading.Lock()
_swaps: dict = {}
_epochs: dict = {}


def note_swap(plane: str, tenant: str, result: str) -> None:
    """Count one swap attempt of `plane` ("python" or "sidecar") for
    `tenant` with `result` ("ok" or "rejected")."""
    key = (plane, tenant or "default", result)
    ctr = REGISTRY.counter(
        "pingoo_ruleset_swap_total",
        HOTSWAP_METRICS["pingoo_ruleset_swap_total"],
        labels={"plane": key[0], "tenant": key[1], "result": key[2]})
    with _lock:
        _swaps[key] = ctr
        ctr.inc()


def set_epoch_gauge(plane: str, epoch: int) -> None:
    gauge = REGISTRY.gauge("pingoo_ruleset_epoch",
                           HOTSWAP_METRICS["pingoo_ruleset_epoch"],
                           labels={"plane": plane})
    with _lock:
        _epochs[plane] = gauge
        gauge.set(int(epoch))


def swap_counts(plane: str) -> dict[str, int]:
    """{"<tenant>/<result>": swaps} of one plane, in this process."""
    with _lock:
        return {f"{t}/{r}": c.value
                for (p, t, r), c in sorted(_swaps.items()) if p == plane}


def epoch_of(plane: str) -> int:
    """The epoch last set for `plane` in this process (0 before any)."""
    with _lock:
        gauge = _epochs.get(plane)
        return 0 if gauge is None else int(gauge.value)


@dataclass
class SwapHandle:
    """One requested swap, resolved by the serving loop at the next
    batch boundary. `wait()` blocks the requester (a config-reload
    thread, never the serving loop) until the flip happened; `pause_ms`
    is the drain and flip's wall time, the admission stall the swap
    cost."""

    plan: RulesetPlan
    tenant: str = "default"
    lists: Optional[dict] = None
    # The plan's engine state, built and warmed by the requester before
    # the handle reaches the serving loop, so that the flip is pointer
    # assignment.
    state: Optional[object] = None
    done: threading.Event = field(default_factory=threading.Event)
    epoch: int = -1
    pause_ms: float = 0.0
    result: str = "pending"
    error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def resolve(self, epoch: int, pause_ms: float,
                result: str = "ok",
                error: Optional[BaseException] = None) -> None:
        self.epoch = epoch
        self.pause_ms = pause_ms
        self.result = result
        self.error = error
        self.done.set()


@dataclass
class TenantPlan:
    tenant: str
    plan: RulesetPlan
    fingerprint: str
    lists: dict
    compiled_at: float


class TenantPlanStore:
    """Compile-ahead store: tenant key -> current RulesetPlan.

    `prepare()` compiles (or loads from the artifact cache, under a
    tenant-scoped fingerprint) without touching what is served; the
    caller hands the plan to VerdictService.swap_plan or
    RingSidecar.request_swap. A tenant's entry is replaced only once
    prepare() succeeded, so a broken ruleset never takes a tenant's
    serving plan away. Plans go to `device` (default: the CUDA card)."""

    def __init__(self, cache_dir: Optional[str] = None, device=None):
        self.cache_dir = cache_dir
        self.device = device
        self._lock = threading.Lock()
        self._plans: dict[str, TenantPlan] = {}

    def prepare(self, tenant: str, rules: list, lists: dict,
                field_specs=None, routes=None) -> TenantPlan:
        from ..compiler.cache import (compile_ruleset_cached,
                                      ruleset_fingerprint)

        fingerprint = ruleset_fingerprint(
            rules, lists, field_specs, routes=routes, tenant=tenant)
        plan = compile_ruleset_cached(
            rules, lists, cache_dir=self.cache_dir,
            field_specs=field_specs, routes=routes, tenant=tenant,
            device=self.device)
        entry = TenantPlan(tenant=tenant, plan=plan,
                           fingerprint=fingerprint, lists=dict(lists),
                           compiled_at=time.time())
        with self._lock:
            self._plans[tenant] = entry
        return entry

    def get(self, tenant: str) -> Optional[TenantPlan]:
        with self._lock:
            return self._plans.get(tenant)

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._plans)

    def total_rules(self) -> int:
        with self._lock:
            return sum(len(e.plan.rules) for e in self._plans.values())
