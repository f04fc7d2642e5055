"""VerdictService: the Python plane's async facade over the batched
verdict.

`evaluate(req)` queues one request and awaits its `Verdict`. A collector
task gathers requests into batches of at most `max_batch`, waiting at
most `max_wait_us` after the first one, and runs each batch in a worker
thread: encode, trim the field columns to a power of two, pad the batch
axis to a power of two, evaluate on the plan's device, re-interpret
rows whose fields overflowed the device capacity, and reduce to the two
action lanes.

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
after the replay, and host rules run before the one wait.

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
Every `Verdict` carries the epoch it was evaluated under.

A staging, scorer or device error fails that batch's callers and nothing
else; there is no fallback to the other chain, nor from a megastep
window to the per-batch path, and no zero score. A swap whose state
fails to build or warm up raises to its caller, and the old plan goes
on serving.

What the listener reads, with the JAX package's keys: `stats.snapshot()`
(counts, the verdict wait and the stages), `pipeline_snapshot()` (the
executor's `PipelineStats`: depth, batches in flight, stage occupancy,
overlap) and `explain(req)` (one request through the batched path and
the interpreter, per rule). Every timing is kept in a bounded window
(`obs/window.py`).
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..compiler.plan import RulesetPlan
from ..device import check_env, pipeline_depth, pipeline_mode, resolve_device
from ..models import botscore
from ..obs.pipeline import PipelineStats
from ..obs.trace import tuple_digest
from ..obs.window import WINDOW, TimingWindow
from .batch import (DeviceInputQueue, RequestBatch, RequestTuple,
                    StagingEncoder, _nbytes, batch_tensors, bucket_arrays,
                    encode_requests, packed_tensor, pad_batch,
                    pow2_batch_size, resolve_stage_caps,
                    stage_overflow_thresholds, tuple_to_context)
from .graphs import MegastepRunner
from .hotswap import note_swap, set_epoch_gauge, swap_counts
from .verdict import (_host_array, _resolve_megastep_mode, action_lanes,
                      finish_batch, finish_megastep, interpret_rules_row,
                      make_megastep_fn, make_verdict_fn, megastep_k_cap,
                      megastep_k_ladder,
                      to_host_async, unpack_staged)


# PINGOO_MEGASTEP_K's default here. A window is one graph replay at any
# K, and each slice runs the whole slice body again (every gated bank,
# the glue kernels), so splitting one batch saves no issue and costs
# device time: on an H100 a 2048-row batch as one slice took as much
# issue as four slices of 512 and about a quarter of their device time
# (PERF.md, the megastep's findings). The sidecar's K (default 4) puts
# K dequeued batches in one window instead.
SERVICE_MEGASTEP_K_DEFAULT = 1


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


class ServiceStats:
    """Counters and bounded timing windows of one VerdictService, read
    through `snapshot()` with the JAX package's keys."""

    def __init__(self, window: int = WINDOW, epoch=None):
        self.batches = 0
        self.requests = 0
        self.wait = TimingWindow(window)  # evaluate() -> resolved
        self.batch = TimingWindow(window)  # one batch's wall time
        self.stages = {k: TimingWindow(window) for k in STAGES}
        # Bytes staged for the device (`RequestBatch.staged_bytes`),
        # under the staging that `VerdictService.stage_caps` names.
        self.staged_bytes = 0
        # Reads the owning service's served plan epoch at each snapshot
        # (None: always 0, the boot plan).
        self.epoch = epoch or (lambda: 0)

    def snapshot(self) -> dict:
        """O(window), whatever the uptime. The counts of features the
        port does not have read 0: device errors and the host fallback
        (ROADMAP item 9), batch dedup and the prefilter and DFA counters
        of the metric registry (item 10). `score_errors` stays 0: a
        scorer failure fails its batch. `hotswap` has the epoch and this
        process's swaps of the Python plane by tenant and result."""
        return {
            "batches": self.batches,
            "requests": self.requests,
            "device_errors": 0,
            "score_errors": 0,
            "host_fallback_batches": 0,
            "mean_occupancy": (self.requests / self.batches
                               if self.batches else 0.0),
            "dedup_hits": 0,
            "prefilter_candidate_rate": 0.0,
            "scan_banks_skipped": 0,
            "dfa_banks": 0,
            "dfa_rechecks": 0,
            "verdict_p50_ms": self.wait.percentile(50),
            "verdict_p99_ms": self.wait.percentile(99),
            "stages": {k: w.summary() for k, w in self.stages.items()},
            "hotswap": {"epoch": self.epoch(),
                        "swaps": swap_counts("python")},
        }


class VerdictService:
    """Fixed-window batching collector over `make_verdict_fn`, with the
    pipelined executor of the module's docstring."""

    # Timing samples kept per window (tests shrink it).
    WINDOW = WINDOW

    def __init__(self, plan: RulesetPlan, lists: dict,
                 max_batch: int = 1024, max_wait_us: int = 300,
                 device=None, bot_score_params=None):
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
        self.stats = ServiceStats(self.WINDOW,
                                  epoch=lambda: self.ruleset_epoch)
        # The executor: batches in flight at most `_pipeline_depth`
        # (PINGOO_SCHED_PIPELINE, default 2; a non-integer raises
        # ValueError as in the JAX package; PINGOO_PIPELINE_DEPTH
        # overrides it); `off` runs one batch at a time.
        depth = int(os.environ.get("PINGOO_SCHED_PIPELINE", "2"))
        self.pipeline_mode = pipeline_mode()
        self._pipeline_depth = pipeline_depth(depth) \
            if self.pipeline_mode == "on" else 1
        self._pipe = PipelineStats("python", self._pipeline_depth)
        # Host stages are serialized across batches (the dispatch token
        # covers the whole issue, the verdict function's lazily built
        # constants included), while a batch waiting for its result
        # holds neither: that asymmetry is the overlap.
        self._stage_tokens = {"encode": threading.Lock(),
                              "dispatch": threading.Lock()}
        self._batch_tasks: set = set()
        self._profiler = None  # (torch.profiler session, output dir)
        self._profile_task: Optional[asyncio.Task] = None
        # The megastep, taken by every batch of this service when
        # PINGOO_MEGASTEP=force at construction (decided once, as the
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
        state = {"plan": plan, "verdict_fn": make_verdict_fn(plan),
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
        if self._mega_mode == "force":
            state["mega_runner"] = MegastepRunner(
                make_megastep_fn(plan, kind="matrix"), plan.np_tables,
                plan.device)
            state["mega_queue"] = DeviceInputQueue(
                self._mega_rungs[-1], self.max_batch,
                field_specs=plan.field_specs, nbuf=2)
        return state

    def _adopt_engine_state(self, state: dict) -> None:
        """Install a built state as the served references: at boot, or at
        a swap's flip, when no batch is in `evaluate_batch`."""
        self.plan = state["plan"]
        self._verdict_fn = state["verdict_fn"]
        self.stage_caps = state["stage_caps"]
        self._staging = state["staging"]
        self._mega_runner = state["mega_runner"]
        self._mega_queue = state["mega_queue"]

    def _warm_state(self, state: dict) -> None:
        """One padded batch of one empty request through a built state's
        issue (`_issue`: the bot head's and the verdict's launches, on
        the card under `force` the capture of that window's graph),
        waited for: the lazily built constants and table layouts, and
        the first launches, are paid here and not by the first batch
        served. An error raises."""
        staging = state["staging"]
        staged = staging.checkout() if staging is not None else None
        try:
            fast, _ = self._encode([RequestTuple()],
                                   pow2_batch_size(1, self.max_batch),
                                   staging, staged, state["plan"])
            for out in self._issue(fast, 1, self.ruleset_epoch,
                                   state)[:3]:
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
        """Await the verdict for one request."""
        if self._task is None:
            raise RuntimeError("VerdictService.evaluate before start()")
        t0 = time.monotonic()
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((req, fut))
        verdict = await fut
        self.stats.wait.append((time.monotonic() - t0) * 1e3)
        return verdict

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
        sem = asyncio.Semaphore(self._pipeline_depth)
        while True:
            item = await self._queue.get()
            if isinstance(item, _PlanSwap):
                await self._apply_swap(item)
                continue
            pending = [item]
            # A swap sentinel closes the batch being assembled: its
            # requests launch on the old plan, the flip follows (after
            # they finish), and the requests behind the sentinel are
            # admitted on the new plan.
            swap = None
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if isinstance(item, _PlanSwap):
                    swap = item
                    break
                pending.append(item)
            # Whatever is already queued rides this batch for free.
            while swap is None and len(pending) < self.max_batch \
                    and not self._queue.empty():
                item = self._queue.get_nowait()
                if isinstance(item, _PlanSwap):
                    swap = item
                    break
                pending.append(item)
            # At most `_pipeline_depth` batches in flight: each is its own
            # task, and the next batch gathers while they run.
            await sem.acquire()
            task = asyncio.create_task(self._run_batch_guarded(pending, sem))
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
                self.tenant = swap.tenant
                self.ruleset_epoch += 1
            finally:
                self._swapping = False
                self._gate.notify_all()

    async def _run_batch_guarded(self, pending, sem) -> None:
        """One batch in a worker thread; its verdicts, or its error, go
        to its callers, and its in-flight slot is released whatever
        happens."""
        try:
            reqs = [r for r, _ in pending]
            try:
                verdicts = await asyncio.get_running_loop().run_in_executor(
                    None, self.evaluate_batch, reqs)
            except Exception as exc:  # surface the failure to every caller
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            for (_, fut), v in zip(pending, verdicts):
                if not fut.done():
                    fut.set_result(v)
        finally:
            sem.release()

    def evaluate_batch(self, reqs: list[RequestTuple]) -> list[Verdict]:
        """Evaluate one batch synchronously, through the executor's
        chain (the collector's worker; callable from any thread: under
        `on` a caller waits for a free staging set, so at most
        `_pipeline_depth` batches are in flight; during a swap's flip a
        caller waits for the new plan)."""
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
                    return self._evaluate(reqs, slot, staged)
                finally:
                    self._pipe.exit()
            finally:
                if staged is not None:
                    staging.release(staged)
        finally:
            with self._gate:
                self._active -= 1
                if not self._active:
                    self._gate.notify_all()

    def _evaluate(self, reqs: list[RequestTuple], slot: int,
                  staged: Optional[int]) -> list[Verdict]:
        pipe, tokens = self._pipe, self._stage_tokens
        n = len(reqs)
        t_start = time.monotonic()
        with tokens["encode"]:
            t0 = time.monotonic()
            fast, overflow = self._encode(
                reqs, pow2_batch_size(n, self.max_batch), self._staging,
                staged, self.plan)
            t1 = time.monotonic()
        epoch = self.ruleset_epoch
        with tokens["dispatch"]:
            # Issue order is device order (one stream). The result's copy
            # to the host is queued here, so the wait below is for this
            # batch alone.
            t2 = time.monotonic()
            dev, echo, scores, slices = self._issue(
                fast, n, epoch, {"plan": self.plan,
                                 "verdict_fn": self._verdict_fn,
                                 "mega_runner": self._mega_runner,
                                 "mega_queue": self._mega_queue})
            if slices is not None:
                self._pipe.note_megastep(len(slices), "force")
            t3 = time.monotonic()
        # Host rules run first, then the one wait for the device result.
        if slices is not None:
            matched = finish_megastep(self.plan, dev, slices, fast,
                                      self.lists)[:n]
            self.mega_echo_mismatch += int(
                (_host_array(echo) != self.ruleset_epoch).sum())
        else:
            matched = finish_batch(self.plan, dev, fast, self.lists)[:n]
        t4 = time.monotonic()
        matched = self._rewrite_overflow_rows(reqs, overflow, matched)
        actions, verified_block = action_lanes(self.plan, matched)
        bot = _host_array(scores)[:n].tolist() if scores is not None \
            else [0.0] * n
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
        stats.stages["encode"].append((t1 - t0) * 1e3)
        stats.stages["verdict"].append((t3 - t2) * 1e3)
        stats.stages["finish"].append((t5 - t3) * 1e3)
        stats.batches += 1
        stats.requests += n
        stats.staged_bytes += fast.staged_bytes
        return verdicts

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

    def _issue(self, fast: RequestBatch, n: int, epoch: int, state: dict):
        """Issue one padded batch's device work on an engine state's
        programs (the served ones under the dispatch token, or a built
        state's for its warm-up): the bot head's launches first, on the
        same staged batch, then the verdict's, as one megastep window
        under `force`. A packed batch is uploaded once and decoded on
        the device. Returns the queued host copies of the matrix, the
        epoch echo (None off the megastep) and the scores (None without
        the head), and the window's slices (None off the megastep)."""
        mega = state["mega_runner"] is not None
        if mega:
            arrays = None
        elif fast.packed is not None:
            arrays = unpack_staged(packed_tensor(fast.packed, self.device),
                                   fast.layout)
        else:
            arrays = batch_tensors(fast.arrays, self.device)
        scores = None
        if self.bot_score_params is not None:
            head_in = arrays if arrays is not None else batch_tensors(
                {k: fast.arrays[k] for k in botscore.INPUT_KEYS}, self.device)
            scores = to_host_async(botscore.score(self.bot_score_params,
                                                  head_in))
        if mega:
            dev, echo, slices = self._issue_megastep(
                fast, n, state["mega_runner"], state["mega_queue"], epoch)
            return dev, echo, scores, slices
        dev = to_host_async(state["verdict_fn"](state["plan"].np_tables,
                                                arrays))
        return dev, None, scores, None

    def _issue_megastep(self, fast: RequestBatch, n: int,
                        runner: MegastepRunner, queue: DeviceInputQueue,
                        epoch: int):
        """One batch as a megastep window (for `_issue`): its P padded
        rows as K slices of P / K rows, K the largest rung that divides
        P, the n live rows in the first slices, each stamped with
        `epoch`. Returns the matrix's and the echo's queued copies to the
        host and each slice's (row offset, live rows)."""
        size = fast.size
        k = max(r for r in self._mega_rungs if size % r == 0)
        rows = size // k
        buf = queue.checkout()
        try:
            for j in range(k):
                off = j * rows
                queue.fill_slice(
                    buf, j, {name: arr[off:off + rows]
                             for name, arr in fast.arrays.items()},
                    max(0, min(rows, n - off)), epoch)
            out, _, echo = runner.run(queue, buf, k, k)
            dev, echo = to_host_async(out), to_host_async(echo)
        finally:
            queue.release(buf)
        return dev, echo, [(j * rows, max(0, min(rows, n - j * rows)))
                           for j in range(k)]

    def _rewrite_overflow_rows(self, reqs, overflow, matched: np.ndarray):
        """Rows whose fields exceeded device capacity (`overflow`) are
        re-evaluated by the interpreter over the UNTRUNCATED strings."""
        if overflow is None or not overflow[: len(reqs)].any():
            return matched
        for i in np.nonzero(overflow[: len(reqs)])[0]:
            matched[i, :] = interpret_rules_row(
                self.plan, tuple_to_context(reqs[i], self.lists))
        return matched
