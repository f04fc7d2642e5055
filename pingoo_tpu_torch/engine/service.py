"""VerdictService: the Python plane's async facade over the batched
verdict.

`evaluate(req)` queues one request and awaits its `Verdict`. A collector
task gathers requests into batches of at most `max_batch`, waiting at
most `max_wait_us` after the first one, and runs each batch in a worker
thread: encode, trim the field columns to a power of two, pad the batch
axis to a power of two, evaluate on the plan's device, re-interpret
rows whose fields overflowed the device capacity, and reduce to the two
action lanes. One batch runs at a time.

What the listener reads, with the JAX package's keys: `stats.snapshot()`
(counts, the verdict wait and the stages), `pipeline_snapshot()` (the
one-batch executor seen as a pipeline of depth 1) and `explain(req)`
(one request through the batched path and the interpreter, per rule).
Every timing is kept in a bounded window (`obs/window.py`).
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..compiler.plan import RulesetPlan
from ..device import check_env, resolve_device
from ..obs.trace import tuple_digest
from ..obs.window import WINDOW, TimingWindow
from .batch import (RequestBatch, RequestTuple, bucket_arrays,
                    encode_requests, pad_batch, pow2_batch_size,
                    tuple_to_context)
from .verdict import (action_lanes, finish_batch, interpret_rules_row,
                      make_verdict_fn)


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
# own syncs, up to the returned device tensor), and host rules, the wait
# for the device result, overflow rows and action lanes ("finish").
STAGES = ("encode", "verdict", "finish")


class ServiceStats:
    """Counters and bounded timing windows of one VerdictService, read
    through `snapshot()` with the JAX package's keys."""

    def __init__(self, window: int = WINDOW):
        self.batches = 0
        self.requests = 0
        self.wait = TimingWindow(window)  # evaluate() -> resolved
        self.batch = TimingWindow(window)  # one batch's wall time
        self.stages = {k: TimingWindow(window) for k in STAGES}

    def snapshot(self) -> dict:
        """O(window), whatever the uptime. The counts of features the
        port does not have read 0: device errors and the host fallback
        (ROADMAP item 9), the bot score (item 7), batch dedup and the
        prefilter and DFA counters of the metric registry (item 10)."""
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
        }


class VerdictService:
    """Fixed-window batching collector over `make_verdict_fn`."""

    # Timing samples kept per window (tests shrink it).
    WINDOW = WINDOW

    def __init__(self, plan: RulesetPlan, lists: dict,
                 max_batch: int = 1024, max_wait_us: int = 300,
                 device=None):
        dev = resolve_device(device)
        if dev.type != plan.device.type:
            raise ValueError(f"plan tables live on {plan.device}, the "
                             f"service was asked to run on {dev}")
        check_env()
        self.plan = plan
        self.lists = lists
        self.max_batch = max_batch
        self.max_wait_s = max_wait_us / 1e6
        self.device = plan.device
        self._verdict_fn = make_verdict_fn(plan)
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self.stats = ServiceStats(self.WINDOW)
        self._t_boot = time.monotonic()
        self._inflight = 0
        self._profiler = None

    async def start(self) -> None:
        if self._task is None:
            self._start_profile()
            self._queue = asyncio.Queue()
            self._task = asyncio.create_task(self._collector())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._stop_profile()

    def _start_profile(self) -> None:
        """PINGOO_PROFILE_DIR: trace the serving window, start() to
        stop(), with torch.profiler (the card's kernels too) into a
        Chrome trace in that directory."""
        out_dir = os.environ.get("PINGOO_PROFILE_DIR")
        if not out_dir or self._profiler is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = (profile(activities=acts), out_dir)
        self._profiler[0].start()

    def _stop_profile(self) -> None:
        if self._profiler is None:
            return
        (prof, out_dir), self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"pingoo-{os.getpid()}-{time.time_ns()}.trace.json"))

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
        """The one-batch executor through the keys of the JAX package's
        pipelined executor: mode "off", depth 1, at most one batch in
        flight, no overlap and no megastep. Occupancy is each stage's
        busy share of the time since construction: "encode" is the encode
        stage, "dispatch" the verdict stage, "resolve" the finish stage,
        which holds the wait for the device; "compute" is not timed apart
        from it and reads 0."""
        wall = max(time.monotonic() - self._t_boot, 1e-9)
        stages = self.stats.stages
        busy = {"encode": stages["encode"].total,
                "dispatch": stages["verdict"].total,
                "compute": 0.0,
                "resolve": stages["finish"].total}
        return {
            "plane": "python",
            "depth": 1,
            "inflight": self._inflight,
            "batches": {"off": self.stats.batches},
            "overlap_ratio": None,
            "overlap_events": 0,
            "stage_occupancy": {k: round(ms / 1e3 / wall, 4)
                                for k, ms in busy.items()},
            "megastep": {"k": 0, "windows": 0, "slices": 0,
                         "amortization": None, "slices_by_mode": {}},
            "mode": "off",
        }

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
        loop = asyncio.get_running_loop()
        while True:
            pending = [await self._queue.get()]
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    pending.append(await asyncio.wait_for(
                        self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            # Whatever is already queued rides this batch for free.
            while len(pending) < self.max_batch and not self._queue.empty():
                pending.append(self._queue.get_nowait())
            reqs = [r for r, _ in pending]
            self._inflight = 1
            try:
                verdicts = await loop.run_in_executor(
                    None, self.evaluate_batch, reqs)
            except Exception as exc:  # surface the failure to every caller
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            finally:
                self._inflight = 0
            for (_, fut), v in zip(pending, verdicts):
                if not fut.done():
                    fut.set_result(v)

    def evaluate_batch(self, reqs: list[RequestTuple]) -> list[Verdict]:
        """Evaluate one batch synchronously (the collector's worker)."""
        t0 = time.monotonic()
        n = len(reqs)
        batch = encode_requests(reqs, self.plan.field_specs)
        fast = pad_batch(
            RequestBatch(size=n, arrays=bucket_arrays(batch.arrays)),
            pow2_batch_size(n, self.max_batch))
        t1 = time.monotonic()
        # The device result stays on the card: finish_batch interprets the
        # host rules before its one sync, so they overlap the device work.
        dev = self._verdict_fn(self.plan.np_tables, fast.arrays)
        t2 = time.monotonic()
        matched = finish_batch(self.plan, dev, fast, self.lists)[:n]
        matched = self._rewrite_overflow_rows(reqs, batch, matched)
        actions, verified_block = action_lanes(self.plan, matched)
        t3 = time.monotonic()
        stats = self.stats
        stats.batch.append((t3 - t0) * 1e3)
        stats.stages["encode"].append((t1 - t0) * 1e3)
        stats.stages["verdict"].append((t2 - t1) * 1e3)
        stats.stages["finish"].append((t3 - t2) * 1e3)
        stats.batches += 1
        stats.requests += n
        return [Verdict(action=int(actions[i]), matched=matched[i],
                        verified_block=bool(verified_block[i]))
                for i in range(n)]

    def _rewrite_overflow_rows(self, reqs, batch, matched: np.ndarray):
        """Rows whose fields exceeded device capacity are re-evaluated by
        the interpreter over the UNTRUNCATED strings."""
        overflow = batch.overflow
        if overflow is None or not overflow[: len(reqs)].any():
            return matched
        for i in np.nonzero(overflow[: len(reqs)])[0]:
            matched[i, :] = interpret_rules_row(
                self.plan, tuple_to_context(reqs[i], self.lists))
        return matched
