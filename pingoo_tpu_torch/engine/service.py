"""VerdictService: the Python plane's async facade over the batched
verdict.

`evaluate(req)` queues one request, stamped with its entry time, and
awaits its `Verdict`. A collector task gathers requests into batches of
at most `max_batch` under the admission scheduler (sched/scheduler.py,
PINGOO_SCHED_MODE): `continuous` (the default) keeps assembling while
the oldest request's deadline slack (PINGOO_DEADLINE_MS) still covers
the cost model's estimate of serving the batch, `fixed` waits at most
`max_wait_us` after the first request; either way whatever is already
queued then rides the batch. Each batch runs in a worker thread: encode,
trim the field columns to a power of two, pad the batch axis to a power
of two, evaluate on the plan's device, re-interpret rows whose fields
overflowed the device capacity, and reduce to the two action lanes. The
measured walls (whole batch, encode, issue, compute, per staged bytes,
per megastep window) feed the cost model.

The executor (PINGOO_PIPELINE, as in the JAX package):

  * `on` (the default): up to `PINGOO_SCHED_PIPELINE` batches (default
    2; PINGOO_PIPELINE_DEPTH overrides it) are in flight, each its own
    task. A batch encodes into a `StagingEncoder`'s reused buffers under
    the "encode" token and issues its device work under the "dispatch"
    token, its result's copy to the host queued at the end of the issue
    (`verdict.to_host_async`); holding no token while it waits for that
    result, it lets the next batch encode and issue. All batches issue
    on torch's current stream, so issue order is device order.
  * `off`, `0` or `false`: one batch at a time through the allocating
    chain (`encode_requests` -> `bucket_arrays` -> `pad_batch`).

Under PINGOO_STAGING=compact (with `on`; the one-batch chain always
stages in full, as in the JAX package) the encoder stages each field at
the plan's cap (`resolve_stage_caps`) into one packed buffer per batch,
which uploads as one copy and is decoded on the device
(`verdict.unpack_staged`); rows longer than a clamped cap
(PINGOO_STAGING_DEPTH) are flagged and re-interpreted from their
untruncated tuples, as rows past the field capacity are.

Under PINGOO_MEGASTEP=force (either executor) a batch's device work is
one megastep window: its padded rows split into K slices (the largest
rung of the PINGOO_MEGASTEP_K ladder that divides them; K is 1 unless
the variable is set, see SERVICE_MEGASTEP_K_DEFAULT), staged into a
`DeviceInputQueue` set and run as one program, on the card one CUDA
graph replay (engine/graphs.py); its copy to the host is queued right
after the replay, and host rules run before the one wait. Under `auto`
a batch is a window only with a backlog queued behind it, and only when
the scheduler's `size_megastep_k` fits a K above 1 in the slack left
since its launch.

Fail-open (PINGOO_SCHED_FAILOPEN): under `allow` or `interpret`, the
requests whose deadline no immediate launch can meet are answered at
launch, with action 0 (`degraded`) or by the host interpreter; a batch
whose encode or issue overruns its slice of the deadline
(`PIPELINE_STAGE_BUDGET`) is answered so whole. `serve` (the default)
serves every request late and counts the miss.

The degradation ladder (engine/ladder.py), as in the JAX package: a
staging error demotes the `pipeline` rung (the batch encodes through the
one-batch chain), a failed megastep window the `megastep` rung (the
batch is issued per batch), and a device error the `dfa` rung when the
plan runs a lowered DFA (the plan's DFAs off until a probe), else the
`device` rung (the batch is served by the host interpreter). Each probes
back after its backoff. A kernel that fails to build or launch
(`ops/_build.KernelBuildError`) and a CUDA runtime fault
(`ops/_build.DeviceFault`) are never demoted: they fail the batch's
callers. A scorer error is counted (`score_errors`) and serves 0.0.

With `bot_score_params` (models/botscore.py) each batch is also
scored by the bot head on the same staged batch: its launches are
issued just before the verdict's, outside the megastep's graph, and its
result is read after the verdict's; `Verdict.bot_score` carries it.

`swap_plan(plan)` hot-swaps the ruleset (engine/hotswap.py): the new
plan's engine state is built and warmed off the serving path, a
sentinel in the admission queue closes the batch being assembled, and
at that boundary the collector waits for every batch in flight (the
collector's and those of `evaluate_batch` callers on other threads, who
wait meanwhile), flips to the new state and bumps `ruleset_epoch`.
Every `Verdict` carries the epoch it was evaluated under. A swap whose
state fails to build or warm up raises to its caller, and the old plan
goes on serving.

Batch dedup, as in the JAX package: the collector evaluates each
distinct `RequestTuple` of a batch once (`dedup_requests`) and fans its
verdict out to the duplicates, counted in `dedup_hits`.

What the listener reads, with the JAX package's keys: `stats.snapshot()`
(counts, the verdict wait and the stages, and the scheduler's and the
ladder's snapshots), `pipeline_snapshot()` (the executor's
`PipelineStats`: depth, batches in flight, stage occupancy, overlap)
and `explain(req)` (one request through the batched path and the
interpreter, per rule). The registry (`registry=`, the process's
REGISTRY by default) carries the JAX package's instruments of the
Python plane: the wait and stage histograms, the prefilter, DFA and
staged-bytes counters, the staging caps, and those of the scheduler,
the ladder and the executor.

The ledgers (obs/perf.py, sched/scheduler.py): the verdict program and
the megastep's runner are instrumented for the compile ledger (nvcc
builds and graph captures; unwrapped while PINGOO_PERF_LEDGER is off),
and the scheduler's cost model reloads the durable cost ledger at
construction (`cost_ledger_result`) and saves it at `stop()`
(`persist_cost_ledger`), keyed by the backend (`cuda` or `cpu`) and the
boot plan's fingerprint.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..compiler.plan import RulesetPlan
from ..device import check_env, pipeline_depth, pipeline_mode, resolve_device
from ..models import botscore
from ..obs.perf import (batch_leading_dim, instrument_jit,
                        instrument_megastep, plan_fingerprint,
                        set_dispatch_context, staging_widths)
from ..obs.pipeline import PipelineStats
from ..obs.registry import LATENCY_BUCKETS_MS, WAIT_BUCKETS_MS
from ..obs.schema import (DFA_METRICS, PREFILTER_METRICS,
                          SHARED_WAIT_HISTOGRAM, STAGING_METRICS,
                          VERDICT_STAGES)
from ..ops._build import never_demoted
from ..sched import Scheduler, SchedulerConfig
from ..sched.scheduler import load_cost_ledger, save_cost_ledger
from ..obs.trace import tuple_digest
from ..obs.window import WINDOW, TimingWindow
from .batch import (DeviceInputQueue, RequestBatch, RequestTuple,
                    StagingEncoder, _nbytes, batch_tensors, bucket_arrays,
                    encode_requests, packed_tensor, pad_batch,
                    pow2_batch_size, resolve_stage_caps,
                    stage_overflow_thresholds, tuple_to_context)
from .graphs import MegastepRunner
from .hotswap import note_swap, set_epoch_gauge, swap_counts
from .ladder import DegradationLadder, DfaRung
from .verdict import (_host_array, _resolve_megastep_mode, action_lanes,
                      dfa_dispatch_counts, finish_batch, finish_megastep,
                      interpret_rules_row, make_megastep_fn,
                      make_verdict_program, megastep_k_cap, megastep_k_ladder,
                      prefilter_aux_banks, prefilter_aux_len, to_host_async,
                      unpack_staged)


# PINGOO_MEGASTEP_K's default here. A window is one graph replay at any
# K, and each slice runs the whole slice body again (every gated bank,
# the glue kernels), so splitting one batch saves no issue and costs
# device time: on an H100 a 2048-row batch as one slice took as much
# issue as four slices of 512 and about a quarter of their device time
# (PERF.md, the megastep's findings). The sidecar's K (default 4) puts
# K dequeued batches in one window instead.
SERVICE_MEGASTEP_K_DEFAULT = 1

# Cumulative shares of PINGOO_DEADLINE_MS a batch may have spent, from
# its launch, when each host stage ends (the JAX package's): past them,
# under a fail-open policy other than `serve`, the batch is answered by
# the fail-open route rather than ride a doomed device round trip.
PIPELINE_STAGE_BUDGET = {"encode": 0.45, "dispatch": 0.75}


class _StageBudgetExceeded(RuntimeError):
    """A host stage blew its slice of the deadline budget."""

    def __init__(self, stage: str, elapsed_ms: float):
        super().__init__(
            f"pipeline stage {stage!r} blew its deadline slice "
            f"({elapsed_ms:.3f} ms since launch)")
        self.stage = stage
        self.elapsed_ms = elapsed_ms


class _PlanSwap:
    """Admission-queue sentinel of a prepared hot-swap: its place in the
    queue is the epoch boundary. Requests admitted ahead of it resolve
    on the old plan, those behind it on the new one."""

    __slots__ = ("state", "lists", "tenant", "fut")

    def __init__(self, state, lists, tenant, fut):
        self.state = state
        self.lists = lists
        self.tenant = tenant
        self.fut = fut


@dataclass
class Verdict:
    action: int  # unverified-client lane: 0 none, 1 block, 2 captcha
    matched: np.ndarray  # [R] bool, original rule order
    bot_score: float = 0.0
    # Verified-client lane: Captcha actions are skipped for verified
    # clients, but any matched rule carrying Block still blocks them.
    verified_block: bool = False
    degraded: bool = False
    epoch: int = 0

    @property
    def block(self) -> bool:
        return self.action == 1

    @property
    def captcha(self) -> bool:
        return self.action == 2

    def action_for(self, captcha_verified: bool) -> int:
        if captcha_verified:
            return 1 if self.verified_block else 0
        return self.action


# The stages one batch goes through: host encoding ("encode"), the
# host's issue of the device verdict ("verdict": dispatch and the path's
# own syncs, up to the queued copy of its result), and host rules, the wait
# for the device result, overflow rows and action lanes ("finish").
STAGES = ("encode", "verdict", "finish")

# Admission, per request: evaluate() to the collector's pop
# ("queue_wait"), the pop to the batch's launch ("batch_assembly"); per
# batch: the first pop to the launch decision ("sched").
ADMISSION_STAGES = ("queue_wait", "batch_assembly", "sched")

# The `pingoo_verdict_stage_ms{plane="python",stage}` stages that have a
# timing window of their own: (window family, window name).
_STAGE_WINDOWS = {"queue_wait": ("admission", "queue_wait"),
                  "batch_assembly": ("admission", "batch_assembly"),
                  "sched": ("admission", "sched"),
                  "encode": ("stages", "encode"),
                  "device_dispatch": ("stages", "verdict")}


class ServiceStats:
    """Counters, bounded timing windows and the registry's instruments
    of one VerdictService, read through `snapshot()` with the JAX
    package's keys.

    The instruments are the JAX package's: the verdict-wait histogram,
    the `pingoo_verdict_stage_ms{plane="python",stage}` histograms over
    obs/schema.VERDICT_STAGES, the prefilter, DFA and staged-bytes
    counters. They live on `registry` (the process's REGISTRY by
    default), so services of one process share them, as in the JAX
    package; `snapshot()` reads the wait percentiles and the stages from
    them, as the JAX package does. Each timing is recorded once, at one
    site (`observe_stage`, `observe_wait`), into its histogram and, where
    the port keeps one, its timing window (`stages`, `admission`, `wait`,
    which chip_smoke.py reads). The port runs no provenance stage (item
    10, slice 3), so that histogram stays empty."""

    def __init__(self, window: int = WINDOW, epoch=None, sched=None,
                 ladder=None, registry=None):
        if registry is None:
            from ..obs.registry import REGISTRY as registry  # noqa: N813
        self.batches = 0
        self.requests = 0
        # Batches whose device work failed (each demoted a ladder rung),
        # those the host interpreter served, and scorer failures.
        self.device_errors = 0
        self.host_fallback_batches = 0
        self.score_errors = 0
        # Duplicate tuples of a collector batch served by their first's
        # verdict (batch dedup).
        self.dedup_hits = 0
        # The Stage-A aux vector's fold (`_observe_prefilter`) and the
        # DFA dispatch counts (`_observe_dfa`).
        self.prefilter_candidate_rate = 0.0
        self.scan_banks_skipped = 0
        self.dfa_banks = 0
        self.dfa_rechecks = 0
        self.wait = TimingWindow(window)  # evaluate() -> resolved
        self.batch = TimingWindow(window)  # one batch's wall time
        self.stages = {k: TimingWindow(window) for k in STAGES}
        self.admission = {k: TimingWindow(window) for k in ADMISSION_STAGES}
        # Bytes staged for the device (`RequestBatch.staged_bytes`),
        # under the staging that `VerdictService.stage_caps` names.
        self.staged_bytes = 0
        # Read the owning service's served plan epoch, its scheduler's
        # and its ladder's snapshots at each snapshot (None: epoch 0,
        # nothing).
        self.epoch = epoch or (lambda: 0)
        self._sched = sched or dict
        self._ladder = ladder or dict
        # Counts written from `evaluate_batch` callers' threads.
        self._lock = threading.Lock()
        self.wait_hist = registry.histogram(
            SHARED_WAIT_HISTOGRAM, "verdict wait: evaluate() -> resolve (ms)",
            buckets=WAIT_BUCKETS_MS, labels={"plane": "python"})
        self.stage_hist = {
            stage: registry.histogram(
                "pingoo_verdict_stage_ms",
                "verdict pipeline stage latency (ms)",
                buckets=LATENCY_BUCKETS_MS,
                labels={"plane": "python", "stage": stage})
            for stage in VERDICT_STAGES}
        self.pf_rate_gauge = registry.gauge(
            "pingoo_prefilter_candidate_rate",
            PREFILTER_METRICS["pingoo_prefilter_candidate_rate"],
            labels={"plane": "python"})
        self.pf_skip_counter = registry.counter(
            "pingoo_scan_banks_skipped_total",
            PREFILTER_METRICS["pingoo_scan_banks_skipped_total"],
            labels={"plane": "python"})
        self.dfa_banks_counter = {
            mode: registry.counter(
                "pingoo_dfa_banks_total", DFA_METRICS["pingoo_dfa_banks_total"],
                labels={"plane": "python", "mode": mode})
            for mode in ("auto", "force")}
        self.dfa_recheck_counter = registry.counter(
            "pingoo_dfa_recheck_total", DFA_METRICS["pingoo_dfa_recheck_total"],
            labels={"plane": "python"})
        self.staged_bytes_counter = {
            mode: registry.counter(
                "pingoo_staged_bytes_total",
                STAGING_METRICS["pingoo_staged_bytes_total"],
                labels={"plane": "python", "mode": mode})
            for mode in ("full", "compact")}

    def observe_stage(self, stage: str, ms: float) -> None:
        """One timing of `stage` (obs/schema.VERDICT_STAGES), into its
        histogram and its timing window where it has one."""
        self.stage_hist[stage].observe(ms)
        family = _STAGE_WINDOWS.get(stage)
        if family is not None:
            getattr(self, family[0])[family[1]].append(ms)

    def observe_wait(self, ms: float) -> None:
        """One request's evaluate() -> resolve wall (on the loop)."""
        self.wait.append(ms)
        self.wait_hist.observe(ms)

    def note_batch(self, requests: int) -> None:
        with self._lock:
            self.batches += 1
            self.requests += requests

    def snapshot(self) -> dict:
        """O(buckets + window), whatever the uptime. `sched` is the
        scheduler's snapshot with the admission windows, `ladder` the
        ladder's; `hotswap` has the epoch and this process's swaps of
        the Python plane by tenant and result."""
        return {
            "batches": self.batches,
            "requests": self.requests,
            "device_errors": self.device_errors,
            "score_errors": self.score_errors,
            "host_fallback_batches": self.host_fallback_batches,
            "mean_occupancy": (self.requests / self.batches
                               if self.batches else 0.0),
            "dedup_hits": self.dedup_hits,
            "prefilter_candidate_rate": round(
                self.prefilter_candidate_rate, 4),
            "scan_banks_skipped": self.scan_banks_skipped,
            "dfa_banks": self.dfa_banks,
            "dfa_rechecks": self.dfa_rechecks,
            "verdict_p50_ms": self.wait_hist.percentile(0.50),
            "verdict_p99_ms": self.wait_hist.percentile(0.99),
            "stages": {
                stage: {"count": h.count,
                        "p50_ms": h.percentile(0.50),
                        "p99_ms": h.percentile(0.99),
                        "mean_ms": round(h.sum / h.count, 4)
                        if h.count else 0.0}
                for stage, h in self.stage_hist.items()},
            "sched": {**self._sched(),
                      "admission": {k: w.summary()
                                    for k, w in self.admission.items()}},
            "ladder": self._ladder(),
            "hotswap": {"epoch": self.epoch(),
                        "swaps": swap_counts("python")},
        }


def dedup_requests(reqs: list[RequestTuple]):
    """(the distinct tuples in first-seen order, for each request the
    index of its tuple there), or (reqs, None) when all are distinct.
    The key is the JAX package's: everything a verdict can depend on,
    never the trace id, which does not reach the device arrays."""
    seen: dict = {}
    uniq: list = []
    row_of: list = []
    for req in reqs:
        key = (req.method, req.path, req.url, req.host, req.user_agent,
               req.ip, req.remote_port, req.asn, req.country)
        j = seen.get(key)
        if j is None:
            j = seen[key] = len(uniq)
            uniq.append(req)
        row_of.append(j)
    if len(uniq) == len(reqs):
        return reqs, None
    return uniq, row_of


class VerdictService:
    """The scheduler's batching collector over `make_verdict_program`, with
    the pipelined executor and the ladder of the module's docstring."""

    # Timing samples kept per window (tests shrink it).
    WINDOW = WINDOW

    def __init__(self, plan: RulesetPlan, lists: dict,
                 max_batch: int = 1024, max_wait_us: int = 300,
                 device=None, bot_score_params=None, registry=None):
        dev = resolve_device(device)
        if dev.type != plan.device.type:
            raise ValueError(f"plan tables live on {plan.device}, the "
                             f"service was asked to run on {dev}")
        check_env()
        self.lists = lists
        self.max_batch = max_batch
        self.max_wait_s = max_wait_us / 1e6
        self.device = plan.device
        # The bot head's weights, on the plan's device (None: no head,
        # every score 0.0).
        self.bot_score_params = None if bot_score_params is None \
            else bot_score_params.to(self.device)
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        if registry is None:
            from ..obs.registry import REGISTRY as registry  # noqa: N813
        # The metric registry of this plane's instruments.
        self.registry = registry
        self.sched = Scheduler(SchedulerConfig.from_env(max_batch),
                               plane="python", registry=registry)
        # The durable cost ledger: the cost model reloads what the last
        # run of this backend, plane and plan measured, over the seed.
        # The fingerprint stays the boot plan's across swaps, as in the
        # JAX package. (The compile ledger's series are made with the
        # programs, in `_build_engine_state`.)
        self._plan_fp = plan_fingerprint(plan)
        self._backend_label = self.device.type
        self.cost_ledger_result = load_cost_ledger(
            self.sched.cost, backend=self._backend_label,
            fingerprint=self._plan_fp, plane="python", registry=registry)
        self.ladder = DegradationLadder("python", registry=registry)
        self._dfa_rung = DfaRung(self.ladder, plan)
        self.stats = ServiceStats(self.WINDOW,
                                  epoch=lambda: self.ruleset_epoch,
                                  sched=self.sched.snapshot,
                                  ladder=self.ladder.snapshot,
                                  registry=registry)
        # The executor: batches in flight at most `_pipeline_depth`
        # (PINGOO_SCHED_PIPELINE, default 2; a non-integer raises
        # ValueError as in the JAX package; PINGOO_PIPELINE_DEPTH
        # overrides it); `off` runs one batch at a time.
        depth = int(os.environ.get("PINGOO_SCHED_PIPELINE", "2"))
        self.pipeline_mode = pipeline_mode()
        self._pipeline_depth = pipeline_depth(depth) \
            if self.pipeline_mode == "on" else 1
        self._pipe = PipelineStats("python", self._pipeline_depth,
                                   registry=registry)
        # Host stages are serialized across batches (the dispatch token
        # covers the whole issue, the verdict function's lazily built
        # constants included), while a batch waiting for its result
        # holds neither: that asymmetry is the overlap.
        self._stage_tokens = {"encode": threading.Lock(),
                              "dispatch": threading.Lock()}
        self._batch_tasks: set = set()
        self._profiler = None  # (torch.profiler session, output dir)
        self._profile_task: Optional[asyncio.Task] = None
        # The megastep, taken by every batch of this service under
        # PINGOO_MEGASTEP=force at construction, and by batches with a
        # backlog behind them under auto (the mode decided once, as the
        # sidecar does). `mega_echo_mismatch` counts slices whose epoch
        # echo differs from the epoch served when they finish: a window
        # that crossed a swap's flip would show here.
        self._mega_mode = _resolve_megastep_mode()
        self._mega_rungs = megastep_k_ladder(
            megastep_k_cap(SERVICE_MEGASTEP_K_DEFAULT))
        self.ruleset_epoch = 0
        self.tenant = "default"
        self.mega_echo_mismatch = 0
        # Batches in `evaluate_batch`, on any thread: a swap's flip waits
        # until none is (new ones wait while `_swapping`).
        self._gate = threading.Condition()
        self._active = 0
        self._swapping = False
        self._adopt_engine_state(self._build_engine_state(plan))
        set_epoch_gauge("python", 0)

    def _build_engine_state(self, plan: RulesetPlan) -> dict:
        """Everything plan-derived that the batches read, built without
        touching the served references (at boot, and for a swap off the
        serving path): the verdict programs, the staging encoder and,
        under `force`, the megastep's graph runner and input sets.

        Under `on` one staging set per batch in flight, held from its
        encode to its last verdict: however many threads call
        evaluate_batch, at most `_pipeline_depth` batches are in flight,
        and a set is never refilled while its batch reads it. Compact
        staging: the plan's caps where the staging encoder takes them
        (under `on`), else None: the one-batch chain stages in full. A
        megastep set is held only
        while its window is issued (finish reads the batch's own
        arrays); the issue is serialized by the dispatch token, and a
        set is handed out again only once its upload has been read."""
        if plan.device.type != self.device.type:
            raise ValueError(f"plan tables live on {plan.device}, the "
                             f"service runs on {self.device}")
        fp, widths = plan_fingerprint(plan), staging_widths(plan)
        state = {"plan": plan,
                 "verdict_fn": instrument_jit(
                     make_verdict_program(plan), "verdict", plane="python",
                     fingerprint=fp, widths=widths, registry=self.registry),
                 "pf_gated_banks": len(prefilter_aux_banks(plan)[0]),
                 "aux_len": prefilter_aux_len(plan),
                 "stage_caps": None, "staging": None, "mega_runner": None,
                 "mega_queue": None}
        if self.pipeline_mode == "on":
            caps = state["stage_caps"] = resolve_stage_caps(plan)
            if caps is None:
                state["staging"] = StagingEncoder(
                    self.max_batch, plan.field_specs,
                    nbuf=self._pipeline_depth)
            else:
                state["staging"] = StagingEncoder(
                    self.max_batch, plan.field_specs,
                    nbuf=self._pipeline_depth, stage_caps=caps,
                    overflow_thresholds=stage_overflow_thresholds(plan,
                                                                  caps))
        if self._mega_mode != "off":
            state["mega_runner"] = MegastepRunner(
                instrument_megastep(
                    make_megastep_fn(plan, kind="matrix"), plane="python",
                    fingerprint=fp, registry=self.registry),
                plan.np_tables, plan.device)
            state["mega_queue"] = DeviceInputQueue(
                self._mega_rungs[-1], self.max_batch,
                field_specs=plan.field_specs, nbuf=2)
        return state

    def _adopt_engine_state(self, state: dict) -> None:
        """Install a built state as the served references: at boot, or at
        a swap's flip, when no batch is in `evaluate_batch`."""
        self.plan = state["plan"]
        self._verdict_fn = state["verdict_fn"]
        self._pf_gated_banks = state["pf_gated_banks"]
        self._aux_len = state["aux_len"]
        self.stage_caps = state["stage_caps"]
        self._staging = state["staging"]
        self._mega_runner = state["mega_runner"]
        self._mega_queue = state["mega_queue"]
        # The adopted plan's staging widths (`pingoo_staging_field_cap`).
        for field, cap in (self.stage_caps or {}).items():
            self.registry.gauge(
                "pingoo_staging_field_cap",
                STAGING_METRICS["pingoo_staging_field_cap"],
                labels={"field": field}).set(int(cap))

    def _warm_state(self, state: dict) -> None:
        """One padded batch of one empty request through a built state's
        issue (`_issue`: the bot head's and the verdict's launches, on
        the card under `force` the capture of that window's graph),
        waited for: the lazily built constants and table layouts, and
        the first launches, are paid here and not by the first batch
        served (under `auto` the per-batch path is warmed, and a window
        shape captures at its first window). An error raises."""
        staging = state["staging"]
        staged = staging.checkout() if staging is not None else None
        try:
            fast, _ = self._encode([RequestTuple()],
                                   pow2_batch_size(1, self.max_batch),
                                   staging, staged, state["plan"])
            k = self._window_k(fast.size) \
                if self._mega_mode == "force" else None
            for out in self._issue(fast, 1, self.ruleset_epoch,
                                   state, k)[:3]:
                if out is not None:
                    _host_array(out)
        finally:
            if staged is not None:
                staging.release(staged)

    async def start(self) -> None:
        if self._task is None:
            out_dir = os.environ.get("PINGOO_PROFILE_DIR")
            if out_dir and self._profiler is None:
                self._start_trace(out_dir)
            self._queue = asyncio.Queue()
            self._task = asyncio.create_task(self._collector())

    async def stop(self) -> None:
        for attr in ("_task", "_profile_task"):
            task = getattr(self, attr)
            setattr(self, attr, None)
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            if attr == "_task" and self._batch_tasks:
                # The batches in flight finish and resolve their callers.
                await asyncio.gather(*list(self._batch_tasks),
                                     return_exceptions=True)
        # A swap that never reached the collector is refused, not lost.
        while self._queue is not None and not self._queue.empty():
            item = self._queue.get_nowait()
            if isinstance(item, _PlanSwap) and not item.fut.done():
                note_swap("python", item.tenant, "rejected")
                item.fut.set_exception(RuntimeError(
                    "the service stopped before the swap's flip"))
        self.ensure_trace_stopped()
        self.persist_cost_ledger()

    def persist_cost_ledger(self) -> bool:
        """Save the scheduler's CostModel into the durable cost ledger
        (PINGOO_COST_LEDGER). Idempotent, so the SIGTERM drain may call
        it after a graceful stop ran out of time; False when the ledger
        is off or its file cannot be written."""
        return save_cost_ledger(
            self.sched.cost, backend=self._backend_label,
            fingerprint=self._plan_fp, plane="python")

    # -- torch.profiler windows: PINGOO_PROFILE_DIR traces start() to
    # stop(), capture_profile() a bounded window; one at a time, each
    # written as a Chrome trace (the card's kernels too) on stop.

    def _start_trace(self, out_dir: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self._profiler = (prof, out_dir)

    def ensure_trace_stopped(self) -> None:
        """Stop a live trace and write it out. Idempotent and
        synchronous, so the SIGTERM drain can call it even when the
        graceful stop ran out of time."""
        if self._profiler is None:
            return
        (prof, out_dir), self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"pingoo-{os.getpid()}-{time.time_ns()}.trace.json"))

    async def capture_profile(self, seconds: float,
                              out_dir: Optional[str] = None) -> dict:
        """A bounded torch.profiler window from now (the /__pingoo/profile
        route), capped at 30 s so a forgotten request cannot leave the
        profiler on; an error while another trace is live."""
        seconds = max(0.1, min(float(seconds), 30.0))
        if self._profiler is not None:
            return {"error": "a profiler trace is already active"}
        out_dir = out_dir or os.environ.get("PINGOO_PROFILE_DIR")
        if not out_dir:
            import tempfile

            out_dir = tempfile.mkdtemp(prefix="pingoo-profile-")
        try:
            self._start_trace(out_dir)
        except Exception as exc:
            return {"error": f"profiler unavailable: {exc!r}"}

        async def _stop_after_window():
            try:
                await asyncio.sleep(seconds)
            finally:
                # Cancellation (service stop) must still write it out.
                self.ensure_trace_stopped()

        self._profile_task = asyncio.create_task(_stop_after_window())
        return {"profiling": True, "dir": out_dir, "seconds": seconds}

    async def evaluate(self, req: RequestTuple) -> Verdict:
        """Await the verdict for one request. Its entry time anchors its
        deadline."""
        if self._task is None:
            raise RuntimeError("VerdictService.evaluate before start()")
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((req, fut, time.monotonic()))
        return await fut

    def pipeline_snapshot(self) -> dict:
        """The executor's `PipelineStats.snapshot()` and its mode, with
        the JAX package's keys."""
        snap = self._pipe.snapshot()
        snap["mode"] = self.pipeline_mode
        return snap

    async def explain(self, req: RequestTuple) -> dict:
        """One request through the real batched path (`evaluate`) and the
        interpreter, rule by rule: the /__pingoo/explain payload, with
        the JAX package's keys. `stages_ms` is None: the port keeps no
        per-request flight record (the JAX package's answer without one)."""
        verdict = await self.evaluate(req)
        want = await asyncio.get_running_loop().run_in_executor(
            None, interpret_rules_row, self.plan,
            tuple_to_context(req, self.lists))
        rules, mismatched = [], []
        for rule in self.plan.rules:
            dev_hit = None if verdict.degraded \
                else bool(verdict.matched[rule.index])
            interp_hit = bool(want[rule.index])
            if dev_hit is not None and dev_hit != interp_hit:
                mismatched.append(rule.name)
            rules.append({
                "name": rule.name,
                "index": rule.index,
                "host": rule.host,
                "always": rule.always,
                "actions": [a.value for a in rule.actions],
                "device": dev_hit,
                "interpreter": interp_hit,
            })
        hits = want if verdict.degraded else verdict.matched
        return {
            "trace_id": req.trace_id,
            "digest": tuple_digest(req.method, req.host, req.path,
                                   req.url, req.user_agent, req.ip),
            "request": {
                "method": req.method, "host": req.host,
                "path": req.path, "url": req.url,
                "user_agent": req.user_agent, "ip": req.ip,
                "asn": req.asn, "country": req.country,
            },
            "action": verdict.action,
            "verified_block": verdict.verified_block,
            "bot_score": verdict.bot_score,
            "degraded": verdict.degraded,
            "matched_rules": [r.name for r in self.plan.rules
                              if bool(hits[r.index])],
            "rules": rules,
            "parity": {"consistent": not mismatched,
                       "mismatched_rules": mismatched},
            "stages_ms": None,
        }

    async def _collector(self) -> None:
        """Admission: pop, assemble under the scheduler's launch policy,
        hand the batch to a task of its own (at most `_pipeline_depth` in
        flight), so the next batch assembles while it runs. Under
        `continuous` the assembly waits `wait_budget_s`: the oldest
        request's slack less the estimate; under `fixed` `max_wait_us`
        after the first pop. Pending entries are (request, future, entry
        time, admit time)."""
        sched = self.sched
        continuous = sched.config.mode == "continuous"
        observe = self.stats.observe_stage
        sem = asyncio.Semaphore(self._pipeline_depth)
        while True:
            item = await self._queue.get()
            if isinstance(item, _PlanSwap):
                await self._apply_swap(item)
                continue
            t_first = time.monotonic()
            observe("queue_wait", (t_first - item[2]) * 1e3)
            pending = [(*item, t_first)]
            oldest_enq = item[2]
            fixed_deadline = t_first + self.max_wait_s
            # A swap sentinel closes the batch being assembled: its
            # requests launch on the old plan, the flip follows (after
            # they finish), and the requests behind the sentinel are
            # admitted on the new plan.
            swap = None
            while len(pending) < self.max_batch:
                now = time.monotonic()
                timeout = sched.wait_budget_s(len(pending), oldest_enq, now) \
                    if continuous else fixed_deadline - now
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if isinstance(item, _PlanSwap):
                    swap = item
                    break
                t_adm = time.monotonic()
                observe("queue_wait", (t_adm - item[2]) * 1e3)
                pending.append((*item, t_adm))
            # Whatever is already queued rides this batch for free.
            while swap is None and len(pending) < self.max_batch \
                    and not self._queue.empty():
                item = self._queue.get_nowait()
                if isinstance(item, _PlanSwap):
                    swap = item
                    break
                t_adm = time.monotonic()
                observe("queue_wait", (t_adm - item[2]) * 1e3)
                pending.append((*item, t_adm))
            t_launch = time.monotonic()
            observe("sched", (t_launch - t_first) * 1e3)
            for entry in pending:
                observe("batch_assembly", (t_launch - entry[3]) * 1e3)
            sched.note_launch(len(pending), self._queue.qsize())
            await sem.acquire()
            task = asyncio.create_task(
                self._run_batch_guarded(pending, t_launch, sem))
            self._batch_tasks.add(task)
            task.add_done_callback(self._batch_tasks.discard)
            if swap is not None:
                await self._apply_swap(swap)

    # -- ruleset hot-swap (engine/hotswap.py) -------------------------------

    async def swap_plan(self, plan: RulesetPlan,
                        lists: Optional[dict] = None,
                        tenant: str = "default") -> dict:
        """Hot-swap the served ruleset at the next batch boundary;
        returns {epoch, tenant, pause_ms}.

        The plan's engine state (verdict programs, staging encoder with
        its caps, under `force` a graph runner whose warm-up window is
        captured) is built and warmed here, in a worker thread, off the
        serving path; a failure raises and the old plan goes on serving.
        Then a sentinel rides the admission queue: the collector
        launches everything admitted ahead of it on the old plan, waits
        for every batch in flight, flips, and bumps `ruleset_epoch`.
        `pause_ms` is the wait and flip's wall time."""
        if self._task is None:
            raise RuntimeError("swap_plan requires a started service")
        loop = asyncio.get_running_loop()
        try:
            state = await loop.run_in_executor(
                None, self._build_engine_state, plan)
            await loop.run_in_executor(None, self._warm_state, state)
        except Exception:
            note_swap("python", tenant, "rejected")
            raise
        fut = loop.create_future()
        await self._queue.put(_PlanSwap(state, lists, tenant, fut))
        return await fut

    async def _apply_swap(self, swap: _PlanSwap) -> None:
        """The flip, in the collector at a batch boundary: wait for the
        collector's batches in flight, then (in a worker thread) hold new
        `evaluate_batch` calls back, wait for the running ones, and
        install the new state."""
        t0 = time.monotonic()
        try:
            while self._batch_tasks:
                await asyncio.gather(*list(self._batch_tasks),
                                     return_exceptions=True)
            await asyncio.get_running_loop().run_in_executor(
                None, self._flip, swap)
        except asyncio.CancelledError:
            if not swap.fut.done():
                swap.fut.set_exception(RuntimeError(
                    "the service stopped during the swap"))
            raise
        except Exception as exc:
            note_swap("python", swap.tenant, "rejected")
            if not swap.fut.done():
                swap.fut.set_exception(exc)
            return
        pause_ms = (time.monotonic() - t0) * 1e3
        set_epoch_gauge("python", self.ruleset_epoch)
        note_swap("python", swap.tenant, "ok")
        self.stats.observe_stage("sched", pause_ms)
        if not swap.fut.done():
            swap.fut.set_result({"epoch": self.ruleset_epoch,
                                 "tenant": swap.tenant,
                                 "pause_ms": round(pause_ms, 3)})

    def _flip(self, swap: _PlanSwap) -> None:
        with self._gate:
            self._swapping = True
            try:
                while self._active:
                    self._gate.wait()
                self._adopt_engine_state(swap.state)
                if swap.lists is not None:
                    self.lists = swap.lists
                self._dfa_rung.reset(self.plan)
                self.tenant = swap.tenant
                self.ruleset_epoch += 1
            finally:
                self._swapping = False
                self._gate.notify_all()

    async def _run_batch_guarded(self, pending, t_launch: float,
                                 sem) -> None:
        """One batch in a worker thread; its verdicts, or its error, go
        to its callers, and its in-flight slot is released whatever
        happens. Under a fail-open policy other than `serve` the requests
        no immediate launch can serve in time are answered first, and a
        batch that overruns a stage's budget is answered whole. Then
        batch dedup, as in the JAX package: each distinct tuple is
        evaluated once and its verdict goes to its duplicates. The
        batch's counts (requests, dedup hits, the waits) are written
        here, on the event loop."""
        try:
            if self.sched.config.failopen != "serve":
                pending = await self._apply_failopen(pending)
                if not pending:
                    return
            reqs = [p[0] for p in pending]
            uniq, row_of = dedup_requests(reqs)
            try:
                verdicts = await asyncio.get_running_loop().run_in_executor(
                    None, self.evaluate_batch, uniq, t_launch)
            except _StageBudgetExceeded:
                await self._failopen_batch(pending)
                return
            except Exception as exc:  # surface the failure to every caller
                for p in pending:
                    if not p[1].done():
                        p[1].set_exception(exc)
                return
            if row_of is not None:
                self.stats.dedup_hits += len(reqs) - len(uniq)
                first = set()
                fanned = []
                for j in row_of:
                    fanned.append(verdicts[j] if j not in first
                                  else dataclasses.replace(verdicts[j]))
                    first.add(j)
                verdicts = fanned
            self.stats.note_batch(len(reqs))
            t_res = time.monotonic()
            self._resolve(pending, verdicts)
            self.stats.observe_stage("resolve",
                                     (time.monotonic() - t_res) * 1e3)
        finally:
            sem.release()

    def _resolve(self, pending, verdicts) -> None:
        """Answer `pending`, on the event loop, with each request's wait
        and its deadline miss."""
        t_res = time.monotonic()
        for (_, fut, t_enq, _), verdict in zip(pending, verdicts):
            self.stats.observe_wait((t_res - t_enq) * 1e3)
            self.sched.note_resolved(t_enq, t_res)
            if not fut.done():
                fut.set_result(verdict)

    def _interpreted(self, reqs: list[RequestTuple]) -> list[Verdict]:
        """Verdicts of the host interpreter over the untruncated tuples."""
        matched = self._interpret_rows(reqs)
        actions, verified_block = action_lanes(self.plan, matched)
        return [Verdict(action=int(actions[i]), matched=matched[i],
                        verified_block=bool(verified_block[i]),
                        epoch=self.ruleset_epoch)
                for i in range(len(reqs))]

    def _interpret_rows(self, reqs: list[RequestTuple]) -> np.ndarray:
        if not reqs:
            return np.zeros((0, len(self.plan.rules)), dtype=bool)
        return np.stack([interpret_rules_row(
            self.plan, tuple_to_context(r, self.lists)) for r in reqs])

    async def _failopen_batch(self, pending) -> None:
        """Answer `pending` by the PINGOO_SCHED_FAILOPEN route: `allow`
        with the degraded no-match verdict (action 0) at once,
        `interpret` by the host interpreter."""
        self.sched.note_failopen(len(pending))
        reqs = [p[0] for p in pending]
        if self.sched.config.failopen == "interpret":
            verdicts = await asyncio.get_running_loop().run_in_executor(
                None, self._interpreted, reqs)
        else:
            R = len(self.plan.rules)
            verdicts = [Verdict(action=0, matched=np.zeros(R, dtype=bool),
                                degraded=True, epoch=self.ruleset_epoch)
                        for _ in reqs]
        self._resolve(pending, verdicts)

    async def _apply_failopen(self, pending) -> list:
        """Fail open the requests whose deadline an immediate launch
        cannot meet (`sched.unmeetable`); returns those that still ride
        the device batch."""
        now = time.monotonic()
        late = [self.sched.unmeetable(p[2], now, len(pending))
                for p in pending]
        if not any(late):
            return pending
        await self._failopen_batch([p for p, x in zip(pending, late) if x])
        return [p for p, x in zip(pending, late) if not x]

    def _check_stage_budget(self, stage: str,
                            t_launch: Optional[float]) -> None:
        """Raise _StageBudgetExceeded when the batch, `t_launch` ago, has
        spent more than `stage`'s share of the deadline; never under
        `serve`, for a stage without a share, or without a launch time."""
        if t_launch is None or self.sched.config.failopen == "serve":
            return
        frac = PIPELINE_STAGE_BUDGET.get(stage)
        if frac is None:
            return
        elapsed_ms = (time.monotonic() - t_launch) * 1e3
        if elapsed_ms > frac * self.sched.config.deadline_ms:
            raise _StageBudgetExceeded(stage, elapsed_ms)

    def evaluate_batch(self, reqs: list[RequestTuple],
                       t_launch: Optional[float] = None) -> list[Verdict]:
        """Evaluate one batch synchronously, through the executor's
        chain (the collector's worker; callable from any thread: under
        `on` a caller waits for a free staging set, so at most
        `_pipeline_depth` batches are in flight; during a swap's flip a
        caller waits for the new plan). `t_launch` is the collector's
        launch time: the stage budgets and the megastep's K count from
        there. The collector, which always passes it, counts the batch's
        requests on the event loop; a direct call (without it) counts
        them here."""
        with self._gate:
            while self._swapping:
                self._gate.wait()
            self._active += 1
        try:
            staging = self._staging
            staged = staging.checkout() if staging is not None else None
            try:
                slot = self._pipe.enter(self.pipeline_mode)
                try:
                    out = self._evaluate(reqs, slot, staged, t_launch)
                finally:
                    self._pipe.exit()
                if t_launch is None:
                    self.stats.note_batch(len(reqs))
                return out
            finally:
                if staged is not None:
                    staging.release(staged)
        finally:
            with self._gate:
                self._active -= 1
                if not self._active:
                    self._gate.notify_all()

    def _evaluate(self, reqs: list[RequestTuple], slot: int,
                  staged: Optional[int],
                  t_launch: Optional[float]) -> list[Verdict]:
        pipe, tokens = self._pipe, self._stage_tokens
        n = len(reqs)
        P = pow2_batch_size(n, self.max_batch)
        t_start = time.monotonic()
        with tokens["encode"]:
            t0 = time.monotonic()
            fast, overflow, via_staging = self._encode_laddered(reqs, P,
                                                                staged)
            t1 = time.monotonic()
        self._check_stage_budget("encode", t_launch)
        epoch = self.ruleset_epoch
        matched, scores, t2, t3 = self._device_batch(fast, n, epoch,
                                                     t_launch, via_staging)
        t4 = time.monotonic()
        if matched is None:
            # The device rung is demoted, or this batch's device work
            # failed: the interpreter serves it, untruncated.
            self.stats.host_fallback_batches += 1
            matched = self._interpret_rows(reqs)
        else:
            matched = self._rewrite_overflow_rows(reqs, overflow, matched)
        actions, verified_block = action_lanes(self.plan, matched)
        bot = [0.0] * n
        if scores is not None:
            try:
                bot = _host_array(scores)[:n].tolist()
            except Exception as exc:
                never_demoted(exc)
                self.stats.score_errors += 1
        verdicts = [Verdict(action=int(actions[i]), matched=matched[i],
                            bot_score=bot[i],
                            verified_block=bool(verified_block[i]),
                            epoch=epoch)
                    for i in range(n)]
        t5 = time.monotonic()
        pipe.note_stage(slot, "encode", t0, t1)
        pipe.note_stage(slot, "dispatch", t2, t3)
        pipe.note_stage(slot, "compute", t3, t4)
        pipe.note_stage(slot, "resolve", t4, t5)
        stats = self.stats
        stats.batch.append((t5 - t_start) * 1e3)
        stats.observe_stage("encode", (t1 - t0) * 1e3)
        stats.observe_stage("device_dispatch", (t3 - t2) * 1e3)
        stats.stages["finish"].append((t5 - t3) * 1e3)
        stats.staged_bytes += fast.staged_bytes
        # The cost model: the batch's wall, and the executor's stages
        # (issue and compute only when the card served the batch).
        sched = self.sched
        sched.observe_cost(P, (t5 - t_start) * 1e3)
        sched.observe_stage_cost("encode", P, (t1 - t0) * 1e3)
        if t3 > t2:
            sched.observe_stage_cost("dispatch", P, (t3 - t2) * 1e3)
            sched.observe_stage_cost("compute", P, (t4 - t3) * 1e3)
        return verdicts

    def _encode_laddered(self, reqs: list[RequestTuple], P: int,
                         staged: Optional[int]):
        """`_encode` into the checked-out staging set while the ladder's
        pipeline rung is healthy (or probing); a staging error demotes it
        and the batch encodes through the one-batch chain. Returns the
        batch, its overflow rows and whether the staging encoder made
        it."""
        if staged is not None and self.ladder.try_rung("pipeline"):
            try:
                out = self._encode(reqs, P, self._staging, staged, self.plan)
                self.ladder.note_success("pipeline")
                return (*out, True)
            except Exception as exc:
                never_demoted(exc)
                self.ladder.note_failure("pipeline", exc)
        return (*self._encode(reqs, P, None, None, self.plan), False)

    def _device_batch(self, fast: RequestBatch, n: int, epoch: int,
                      t_launch: Optional[float], via_staging: bool = False):
        """The batch's [n, R] matrix from the card, its scores' queued
        copy (None without the head, or after a scorer error) and its
        issue's start and end. The matrix is None when the device rung is
        demoted or the device work failed (`DfaRung.failure`): the
        caller interprets the batch. A window that fails demotes the
        megastep rung and the batch is issued per batch.

        After the device served the batch, its Stage-A aux vector (per
        batch, or summed over the window's slices) and the plan's DFA
        dispatch counts go to the registry's counters; a batch from the
        staging encoder issued per batch counts its staged bytes, as in
        the JAX package."""
        state = {"plan": self.plan, "verdict_fn": self._verdict_fn,
                 "mega_runner": self._mega_runner,
                 "mega_queue": self._mega_queue}
        tokens = self._stage_tokens
        stats = self.stats
        self._dfa_rung.tick(self.plan)
        t2 = t3 = time.monotonic()
        if not self.ladder.try_rung("device"):
            return None, None, t2, t3

        def waited(ms):
            stats.observe_stage("device_compute", ms)

        try:
            matched = scores = None
            k = self._megastep_k(fast.size, t_launch)
            if k is not None:
                try:
                    with tokens["dispatch"]:
                        t2 = time.monotonic()
                        dev, echo, scores, slices, aux, _ = self._issue(
                            fast, n, epoch, state, k)
                        self._pipe.note_megastep(k, self._mega_mode)
                        t3 = time.monotonic()
                    self._check_dispatch_budget(t_launch, dev, scores)
                    matched = finish_megastep(self.plan, dev, slices, fast,
                                              self.lists, waited)[:n]
                    self.mega_echo_mismatch += int(
                        (_host_array(echo) != epoch).sum())
                    if self._aux_len:
                        # Per-slice row counts, additive over the window.
                        self._observe_prefilter(
                            _host_array(aux).sum(axis=0), fast.size)
                    self.sched.observe_megastep_cost(
                        k, fast.size // k, (time.monotonic() - t2) * 1e3)
                    self.ladder.note_success("megastep")
                except _StageBudgetExceeded:
                    raise
                except Exception as exc:
                    never_demoted(exc)
                    self.ladder.note_failure("megastep", exc)
                    matched = None
            if matched is None:
                with tokens["dispatch"]:
                    # Issue order is device order (one stream). The
                    # result's copy to the host is queued here, so the
                    # wait below is for this batch alone.
                    t2 = time.monotonic()
                    dev, _, scores, _, aux, stage_a_ms = self._issue(
                        fast, n, epoch, state)
                    t3 = time.monotonic()
                if stage_a_ms is not None:
                    stats.observe_stage("prefilter", stage_a_ms)
                if fast.staged_bytes:
                    self.sched.observe_dispatch_bytes(fast.staged_bytes,
                                                      (t3 - t2) * 1e3)
                    if via_staging:
                        stats.staged_bytes_counter[
                            "compact" if fast.packed is not None
                            else "full"].inc(fast.staged_bytes)
                self._check_dispatch_budget(t_launch, dev, scores)
                # Host rules run first, then the one wait; the aux
                # vector's copy was queued behind the matrix's.
                matched = finish_batch(self.plan, dev, fast,
                                       self.lists, waited)[:n]
                if aux is not None:
                    self._observe_prefilter(_host_array(aux), fast.size)
            self._observe_dfa()
            self._dfa_rung.success()
            return matched, scores, t2, t3
        except _StageBudgetExceeded:
            raise
        except Exception as exc:
            never_demoted(exc)
            self.stats.device_errors += 1
            self._dfa_rung.failure(self.plan, exc)
            return None, None, t2, t2

    def _check_dispatch_budget(self, t_launch, *outs) -> None:
        """The dispatch stage's budget; on an overrun the batch's queued
        results are waited for first, so its staging set is released
        only once the card has read it."""
        try:
            self._check_stage_budget("dispatch", t_launch)
        except _StageBudgetExceeded:
            for out in outs:
                if out is not None:
                    _host_array(out)
            raise

    # -- the megastep ---------------------------------------------------------

    def _window_k(self, size: int) -> int:
        """The largest rung of the K ladder that divides `size` rows."""
        return max(r for r in self._mega_rungs if size % r == 0)

    def _megastep_k(self, size: int, t_launch: Optional[float]):
        """K of this batch's window, or None for the per-batch path:
        under `force` `_window_k`; under `auto` only with a backlog
        queued, sized down by `sched.size_megastep_k` against the slack
        left since the launch, and None below 2; never while the
        megastep rung is demoted outside its probe."""
        if self._mega_runner is None:
            return None
        if self._mega_mode == "auto" and (self._queue is None
                                          or self._queue.qsize() <= 0):
            return None
        k = self._window_k(size)
        if self._mega_mode != "force":
            now = time.monotonic()
            k = min(k, self.sched.size_megastep_k(
                self._mega_rungs, size // k,
                t_launch if t_launch is not None else now, now))
            if k <= 1:
                return None
        if not self.ladder.try_rung("megastep"):
            return None
        return k

    @staticmethod
    def _encode(reqs: list[RequestTuple], P: int,
                staging: Optional[StagingEncoder], staged: Optional[int],
                plan: RulesetPlan):
        """One batch padded to P rows: into the checked-out staging set
        `staged`, else through the allocating chain. Returns the batch
        and its overflow rows."""
        if staged is not None:
            fast = staging.encode_requests(reqs, pad_to=P, into=staged)
            return fast, fast.overflow
        batch = encode_requests(reqs, plan.field_specs)
        fast = pad_batch(RequestBatch(size=len(reqs),
                                      arrays=bucket_arrays(batch.arrays)), P)
        fast.staged_bytes = _nbytes(fast.arrays)
        return fast, batch.overflow

    def _issue(self, fast: RequestBatch, n: int, epoch: int, state: dict,
               k: Optional[int] = None):
        """Issue one padded batch's device work on an engine state's
        programs (the served ones under the dispatch token, or a built
        state's for its warm-up): the bot head's launches first, on the
        same staged batch, then the verdict's, as one megastep window of
        `k` slices when `k` is given. A packed batch is uploaded once and
        decoded on the device. Returns the queued host copies of the
        matrix, the epoch echo (None off the megastep) and the scores
        (None without the head or after a scorer error, counted), the
        window's slices (None off the megastep), the Stage-A aux
        vector's ([K, aux_len] under the megastep; None with the
        prefilter off per batch) and Stage A's issue ms (None under the
        megastep or with the prefilter off)."""
        mega = k is not None
        if mega:
            arrays = None
        elif fast.packed is not None:
            arrays = unpack_staged(packed_tensor(fast.packed, self.device),
                                   fast.layout)
        else:
            arrays = batch_tensors(fast.arrays, self.device)
        scores = None
        if self.bot_score_params is not None:
            try:
                head_in = arrays if arrays is not None else batch_tensors(
                    {c: fast.arrays[c] for c in botscore.INPUT_KEYS},
                    self.device)
                scores = to_host_async(botscore.score(self.bot_score_params,
                                                      head_in))
            except Exception as exc:
                never_demoted(exc)
                self.stats.score_errors += 1
                scores = None
        if mega:
            dev, echo, slices, aux = self._issue_megastep(
                fast, n, k, state["mega_runner"], state["mega_queue"], epoch)
            return dev, echo, scores, slices, aux, None
        set_dispatch_context(batch=batch_leading_dim(fast.arrays))
        out, aux, stage_a_ms = state["verdict_fn"](state["plan"].np_tables,
                                                   arrays)
        return (to_host_async(out), None, scores, None,
                None if aux is None else to_host_async(aux), stage_a_ms)

    def _issue_megastep(self, fast: RequestBatch, n: int, k: int,
                        runner: MegastepRunner, queue: DeviceInputQueue,
                        epoch: int):
        """One batch as a megastep window (for `_issue`): its P padded
        rows as k slices of P / k rows, the n live rows in the first
        slices, each stamped with `epoch`. Returns the matrix's and the
        echo's queued copies to the host, each slice's (row offset, live
        rows) and the [K, aux_len] aux vectors' queued copy."""
        size = fast.size
        rows = size // k
        buf = queue.checkout()
        try:
            for j in range(k):
                off = j * rows
                queue.fill_slice(
                    buf, j, {name: arr[off:off + rows]
                             for name, arr in fast.arrays.items()},
                    max(0, min(rows, n - off)), epoch)
            out, _, echo, aux = runner.run(queue, buf, k, k)
            dev, echo = to_host_async(out), to_host_async(echo)
            aux = to_host_async(aux)
        finally:
            queue.release(buf)
        return dev, echo, [(j * rows, max(0, min(rows, n - j * rows)))
                           for j in range(k)], aux

    def _observe_prefilter(self, aux: np.ndarray, batch_rows: int) -> None:
        """Fold a Stage-A aux vector (host int32, the JAX package's
        layout) into `prefilter_candidate_rate` (candidate rows over
        rows x gated banks, of this batch) and `scan_banks_skipped`, and
        their registry instruments."""
        cand_rows, skipped = int(aux[0]), int(aux[1])
        denom = batch_rows * self._pf_gated_banks
        stats = self.stats
        stats.prefilter_candidate_rate = cand_rows / denom if denom else 0.0
        stats.scan_banks_skipped += skipped
        stats.pf_rate_gauge.set(stats.prefilter_candidate_rate)
        stats.pf_skip_counter.inc(skipped)

    def _observe_dfa(self) -> None:
        """The banks this batch ran through a lowered DFA under the
        resolved PINGOO_DFA mode, and the approximate ones among them
        that rechecked through the NFA (`dfa_dispatch_counts`: static per
        plan and environment, so nothing waits on the device)."""
        mode, banks, rechecks = dfa_dispatch_counts(self.plan)
        if not banks:
            return
        stats = self.stats
        stats.dfa_banks += banks
        stats.dfa_rechecks += rechecks
        ctr = stats.dfa_banks_counter.get(mode)
        if ctr is not None:
            ctr.inc(banks)
        if rechecks:
            stats.dfa_recheck_counter.inc(rechecks)

    def _rewrite_overflow_rows(self, reqs, overflow, matched: np.ndarray):
        """Rows whose fields exceeded device capacity (`overflow`) are
        re-evaluated by the interpreter over the UNTRUNCATED strings."""
        if overflow is None or not overflow[: len(reqs)].any():
            return matched
        for i in np.nonzero(overflow[: len(reqs)])[0]:
            matched[i, :] = interpret_rules_row(
                self.plan, tuple_to_context(reqs[i], self.lists))
        return matched
