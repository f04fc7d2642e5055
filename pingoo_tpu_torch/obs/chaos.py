"""PINGOO_CHAOS fault injector of the ring sidecar.

A copy of the JAX package's `obs/chaos.py`: deterministic faults at
exact points of a batch's life, to prove the supervision machinery's
bounds (the heartbeat, crash reattach, the degradation ladder, the
swap protocol). Dormant unless PINGOO_CHAOS is set: every hook checks
`active` first.

Spec grammar, comma-separated faults, each ``name[:arg[:arg]]``::

  kill[:N]          SIGKILL this process after N completed batches
                    (default 1): the crash-reattach scenario.
  pause:MS[:N]      sleep MS ms in the drain loop after N completed
                    batches (default 1), once: the hung sidecar.
  heartbeat_freeze  never stamp the ring heartbeat.
  stall:STAGE:MS    sleep MS ms inside stage STAGE
                    (encode|dispatch|resolve), every batch.
  xla_error[:N]     raise ChaosDeviceError before the device work of the
                    Nth batch (default 1), once: drives the ladder's
                    device (or dfa, or megastep) rung. The name is the
                    JAX package's; on the card it stands for a device
                    error, raised before any launch or graph capture so
                    it never touches the CUDA context.
  verdict_full:N    report the verdict ring full for the next N post
                    attempts.
  swap_storm[:N]    request a same-plan hot-swap every N completed
                    batches (default 5).

A malformed spec raises ValueError. What was injected is counted in
`injected` and in the JAX package's
`pingoo_chaos_injected_total{plane="sidecar",fault}` on the metric
registry.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional


class ChaosDeviceError(RuntimeError):
    """The injected stand-in for a device error (`xla_error`)."""


class ChaosInjector:
    """Parsed PINGOO_CHAOS faults and the hooks the sidecar calls."""

    def __init__(self, spec: str = ""):
        self.spec = (spec or "").strip()
        self.active = bool(self.spec)
        self.kill_after: Optional[int] = None
        self.pause_ms = 0
        self.pause_after: Optional[int] = None
        self.freeze_heartbeat = False
        self.stalls: dict[str, float] = {}  # stage -> ms
        self.xla_error_at: Optional[int] = None
        self.verdict_full_budget = 0
        self.swap_every: Optional[int] = None
        self._last_swap_batch = 0
        self._fired: set[str] = set()
        self.injected: dict[str, int] = {}
        if not self.active:
            return
        for part in self.spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, rest = part.partition(":")
            args = rest.split(":") if rest else []
            try:
                if name == "kill":
                    self.kill_after = int(args[0]) if args else 1
                elif name == "pause":
                    self.pause_ms = int(args[0])
                    self.pause_after = int(args[1]) if len(args) > 1 else 1
                elif name == "heartbeat_freeze":
                    self.freeze_heartbeat = True
                elif name == "stall":
                    self.stalls[args[0]] = float(args[1])
                elif name == "xla_error":
                    self.xla_error_at = int(args[0]) if args else 1
                elif name == "verdict_full":
                    self.verdict_full_budget = int(args[0])
                elif name == "swap_storm":
                    self.swap_every = int(args[0]) if args else 5
                    if self.swap_every < 1:
                        raise ValueError(part)
                else:
                    raise ValueError(name)
            except (IndexError, ValueError):
                raise ValueError(
                    f"PINGOO_CHAOS: malformed fault {part!r}") from None

    @classmethod
    def from_env(cls) -> "ChaosInjector":
        return cls(os.environ.get("PINGOO_CHAOS", ""))

    def _count(self, fault: str) -> None:
        from .registry import REGISTRY
        from .schema import RESILIENCE_METRICS

        self.injected[fault] = self.injected.get(fault, 0) + 1
        REGISTRY.counter(
            "pingoo_chaos_injected_total",
            RESILIENCE_METRICS["pingoo_chaos_injected_total"],
            labels={"plane": "sidecar", "fault": fault}).inc()

    # -- hooks (called by RingSidecar) --------------------------------------

    def heartbeat_frozen(self) -> bool:
        return self.active and self.freeze_heartbeat

    def on_batch_done(self, batches: int) -> None:
        """After a batch resolved: the pause and kill triggers. SIGKILL,
        not an exit: the reattach must survive a sidecar that ran no
        cleanup."""
        if not self.active:
            return
        if self.pause_after is not None and batches >= self.pause_after \
                and "pause" not in self._fired:
            self._fired.add("pause")
            self._count("pause")
            time.sleep(self.pause_ms / 1e3)
        if self.kill_after is not None and batches >= self.kill_after:
            self._count("kill")
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_xla_error(self, batches: int) -> None:
        """Before a batch's or window's device work: one injected device
        error."""
        if not self.active or self.xla_error_at is None:
            return
        if batches + 1 >= self.xla_error_at and "xla" not in self._fired:
            self._fired.add("xla")
            self._count("xla_error")
            raise ChaosDeviceError("PINGOO_CHAOS: injected device error")

    def stage(self, stage: str) -> None:
        """Inside a stage: the injected stall."""
        if not self.active:
            return
        ms = self.stalls.get(stage)
        if ms:
            self._count(f"stall_{stage}")
            time.sleep(ms / 1e3)

    def swap_due(self, batches: int) -> bool:
        """At the top of a pass: does the storm want a hot-swap at this
        batch count? At most once per count."""
        if not self.active or not self.swap_every or batches <= 0:
            return False
        if batches == self._last_swap_batch or batches % self.swap_every:
            return False
        self._last_swap_batch = batches
        self._count("swap_storm")
        return True

    def verdict_full(self) -> bool:
        """Before a verdict post: pretend the ring is full."""
        if not self.active or self.verdict_full_budget <= 0:
            return False
        self.verdict_full_budget -= 1
        self._count("verdict_full")
        return True

    def snapshot(self) -> dict:
        return {"spec": self.spec, "active": self.active,
                "injected": dict(self.injected)}
