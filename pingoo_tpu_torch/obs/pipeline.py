"""The pipelined executor's telemetry: one `PipelineStats` per plane.

Both planes run the pipelined executor, the Python plane's
`VerdictService` (plane "python") and the native plane's `RingSidecar`
(plane "sidecar"), and each keeps one `PipelineStats`:

  * `inflight`: batches between entering the executor and their last
    verdict (bounded by the plane's depth);
  * `depth`: the configured in-flight bound;
  * stage occupancy: the share of the wall time since construction
    each stage was busy. A stage near 1.0 is the bottleneck; stages
    summing past 1.0 show overlap;
  * `overlap_ratio`: an EWMA of the share of a batch's compute window
    during which a DIFFERENT batch was in a host stage (encode or
    dispatch): above 0 the executor overlaps, it does not just queue;
  * batches served per executor mode ("on" pipelined, "off" one batch
    at a time);
  * megastep windows (`note_megastep`): windows launched, slices they
    covered, in total and per PINGOO_MEGASTEP mode, K of the latest
    window and an EWMA of K (slices per device dispatch).

The numbers are plain attributes, read through `snapshot()` with the
JAX package's keys, and each is also exported under the JAX package's
`pingoo_pipeline_*` and `pingoo_megastep_*` names (obs/schema.py
PIPELINE_METRICS) on the metric registry, created at construction so
the whole family exists from the first scrape. Overlap is scored from the stages' wall intervals
(monotonic seconds) kept in a short ring: whichever interval of a
(host stage of one batch, compute of another) pair is recorded second
finds the first, so each pair counts once. The Python plane records
from its batch threads, so a lock guards the bookkeeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .schema import PIPELINE_METRICS

# The executor's stages in the order a batch goes through them: host
# staging fill ("encode"), the host's issue of the device work
# ("dispatch"), the end of dispatch to the result on the host
# ("compute"), and the fan-out of the verdicts ("resolve").
PIPELINE_EXEC_STAGES = ("encode", "dispatch", "compute", "resolve")

# Host stages whose wall, overlapping ANOTHER batch's compute window, is
# the overlap the executor exists to create.
_HOST_STAGES = frozenset(("encode", "dispatch"))

_EWMA_ALPHA = 0.2
_RECENT_INTERVALS = 32


class PipelineStats:
    """One plane's executor counters and overlap bookkeeping."""

    def __init__(self, plane: str, depth: int, registry=None):
        if registry is None:
            from .registry import REGISTRY as registry  # noqa: N813
        self.plane = plane
        self._registry = registry
        self.depth = max(1, int(depth))
        self.inflight = 0
        # The most batches in flight at once since construction.
        self.peak_inflight = 0
        self.overlap_events = 0
        self._overlap_ewma: float | None = None
        self._batches: dict[str, int] = {}
        self._slot_seq = 0
        self._t_boot = time.monotonic()
        self._busy = dict.fromkeys(PIPELINE_EXEC_STAGES, 0.0)
        # (slot, stage, t_start, t_end) of recent stage intervals; 32
        # span several depths of history on both planes.
        self._recent: deque = deque(maxlen=_RECENT_INTERVALS)
        self.megastep_k = 0
        self.megastep_windows = 0
        self.megastep_slices = 0
        self._megastep_slices_by_mode: dict[str, int] = {}
        self._amort_ewma: float | None = None
        self._lock = threading.Lock()
        labels = {"plane": plane}
        self._inflight_gauge = registry.gauge(
            "pingoo_pipeline_inflight",
            PIPELINE_METRICS["pingoo_pipeline_inflight"], labels=labels)
        registry.gauge("pingoo_pipeline_depth",
                       PIPELINE_METRICS["pingoo_pipeline_depth"],
                       labels=labels).set(self.depth)
        self._overlap_gauge = registry.gauge(
            "pingoo_pipeline_overlap_ratio",
            PIPELINE_METRICS["pingoo_pipeline_overlap_ratio"], labels=labels)
        self._occupancy = {
            stage: registry.gauge(
                "pingoo_pipeline_stage_occupancy",
                PIPELINE_METRICS["pingoo_pipeline_stage_occupancy"],
                labels={"plane": plane, "stage": stage})
            for stage in PIPELINE_EXEC_STAGES}
        self._k_gauge = registry.gauge(
            "pingoo_megastep_k", PIPELINE_METRICS["pingoo_megastep_k"],
            labels=labels)
        self._amort_gauge = registry.gauge(
            "pingoo_megastep_amortization",
            PIPELINE_METRICS["pingoo_megastep_amortization"], labels=labels)

    def _mode_counter(self, name: str, mode: str):
        return self._registry.counter(
            name, PIPELINE_METRICS[name],
            labels={"plane": self.plane, "mode": mode})

    def enter(self, mode: str = "on") -> int:
        """A batch entered the executor under `mode`; returns its
        pipeline slot id (increasing per plane)."""
        with self._lock:
            self._slot_seq += 1
            self.inflight += 1
            self.peak_inflight = max(self.peak_inflight, self.inflight)
            self._batches[mode] = self._batches.get(mode, 0) + 1
            self._inflight_gauge.inc()
            self._mode_counter("pingoo_pipeline_batches_total", mode).inc()
            return self._slot_seq

    def exit(self) -> None:
        with self._lock:
            self.inflight -= 1
            self._inflight_gauge.dec()

    def note_megastep(self, k: int, mode: str) -> None:
        """One megastep window of `k` slices launched under
        PINGOO_MEGASTEP `mode`."""
        k = max(1, int(k))
        with self._lock:
            self.megastep_k = k
            self.megastep_windows += 1
            self.megastep_slices += k
            self._megastep_slices_by_mode[mode] = \
                self._megastep_slices_by_mode.get(mode, 0) + k
            prev = self._amort_ewma
            self._amort_ewma = float(k) if prev is None \
                else prev + _EWMA_ALPHA * (k - prev)
            self._k_gauge.set(k)
            self._mode_counter("pingoo_megastep_batches_total", mode).inc(k)
            self._amort_gauge.set(round(self._amort_ewma, 6))

    def note_stage(self, slot: int, stage: str, t_start: float,
                   t_end: float) -> None:
        """Record one stage's wall interval of pipeline slot `slot`: its
        occupancy and, where it pairs with another slot's interval of
        the opposite kind (host stage x compute), the overlap ratio.
        Negative intervals and unknown stages are ignored."""
        dur = t_end - t_start
        if dur < 0.0 or stage not in self._busy:
            return
        with self._lock:
            self._busy[stage] += dur
            wall = t_end - self._t_boot
            if wall > 0.0:
                self._occupancy[stage].set(
                    min(1.0, round(self._busy[stage] / wall, 6)))
            if stage == "compute":
                self._score_overlap(slot, t_start, t_end, want_host=True,
                                    compute_dur=dur)
            elif stage in _HOST_STAGES:
                self._score_overlap(slot, t_start, t_end, want_host=False)
            self._recent.append((slot, stage, t_start, t_end))

    def _score_overlap(self, slot: int, t0: float, t1: float,
                       want_host: bool, compute_dur: float = 0.0) -> None:
        """Pair the interval just finished with the stored intervals of
        the opposite kind of OTHER slots; the ratio's denominator is
        always the compute window (what is being hidden)."""
        for o_slot, o_stage, o_t0, o_t1 in self._recent:
            if o_slot == slot:
                continue
            if want_host != (o_stage in _HOST_STAGES):
                continue
            ov = min(t1, o_t1) - max(t0, o_t0)
            if ov <= 0.0:
                continue
            denom = compute_dur if want_host else (o_t1 - o_t0)
            if denom <= 0.0:
                continue
            self._note_overlap(min(1.0, ov / denom))

    def _note_overlap(self, ratio: float) -> None:
        self.overlap_events += 1
        prev = self._overlap_ewma
        self._overlap_ewma = ratio if prev is None \
            else prev + _EWMA_ALPHA * (ratio - prev)
        self._overlap_gauge.set(round(self._overlap_ewma, 6))

    def snapshot(self) -> dict:
        """The JAX package's keys."""
        wall = max(time.monotonic() - self._t_boot, 1e-9)
        with self._lock:
            return {
                "plane": self.plane,
                "depth": self.depth,
                "inflight": self.inflight,
                "batches": dict(sorted(self._batches.items())),
                "overlap_ratio": (round(self._overlap_ewma, 4)
                                  if self._overlap_ewma is not None
                                  else None),
                "overlap_events": self.overlap_events,
                "stage_occupancy": {
                    stage: round(self._busy[stage] / wall, 4)
                    for stage in PIPELINE_EXEC_STAGES},
                "megastep": {
                    "k": self.megastep_k,
                    "windows": self.megastep_windows,
                    "slices": self.megastep_slices,
                    "amortization": (round(self._amort_ewma, 4)
                                     if self._amort_ewma is not None
                                     else None),
                    "slices_by_mode": dict(sorted(
                        self._megastep_slices_by_mode.items())),
                },
            }
