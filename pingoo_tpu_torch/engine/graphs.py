"""CUDA graphs of the megastep: one graph replay per window on the card.

The JAX package runs a megastep window as one jitted program, one host
dispatch for K batch slices. The counterpart here is a CUDA graph:
`MegastepRunner` captures the K-slice body (engine/verdict.py
`make_megastep_fn`) once per window shape and replays it, so a window's
hundreds of kernel launches cost the host one call.

  * One graph per (kind, k_ship, rows, per-field byte widths, DFA
    mode): the window's shape as `DeviceInputQueue.window_shape` gives
    it, and the plan's resolved PINGOO_DFA mode, which decides whether
    the graph launches the DFA kernel (the degradation ladder's `dfa`
    rung turns the plan's DFAs off and back on, engine/ladder.py). Under
    compact staging every slice arrives at the plan's capped widths, so
    one caps tuple gives one width tuple per (kind, K, rows). Its
    static inputs are views of one flat device buffer, filled by
    `DeviceInputQueue.ship` (one copy) on the current stream right
    before each replay; its outputs are static tensors, overwritten by the next
    replay of the same graph, so the caller queues their copies to the
    host (`verdict.to_host_async`) before it runs the next window.
  * Before a capture the body runs once on the capture stream with the
    window's own inputs: that builds every lazily made constant and
    table layout and lets cuDNN pick the window correlator's algorithm,
    none of which may happen inside a capture. Its launches are real
    and count as such.
  * The capture runs in `thread_local` mode by default: the capturing
    thread may make no call that is illegal under capture (a host sync,
    an allocation outside the graph's pool, ...), and one would raise
    there, while the planes' other threads (the Python plane's batches
    waiting on their results, the native plane's loopback listener) go
    on using the card. The global mode would fail those threads' calls
    and the capture with them. It holds the capturing thread to the same
    rules, so `capture_mode="global"` gives the same graphs where no
    other thread uses the card (chip_smoke.py captures its warm-up pass
    so, which shows the kernels' launchers legal under capture).
  * A graph is destroyed only under the capture lock, before a
    capture: one destroyed while a capture is under way invalidates it,
    and a graph dies wherever its last reference goes (an evicted
    entry, a swap's dropped plan state, the cyclic collector on a
    capturing thread). A dead entry hands its graph to `_RELEASED`,
    which the next capture empties, or the next window run of any
    runner when the lock is free (`_free_released`).
  * Captures are serialized across the process (`_CAPTURE_LOCK`):
    entering `torch.cuda.graph` synchronizes the device and empties the
    allocator's cache, which is illegal while another thread's capture
    is in progress and invalidates it. A hot-swap captures the new
    plan's graphs on its requester's thread while the serving path may
    capture a new window shape of its own, which then waits for the
    swap's capture: the runner counts its waits for the lock
    (`capture_wait_ms_total`, `capture_wait_ms_max`).
  * The cache holds at most `MAX_GRAPHS` graphs, the least recently
    replayed evicted first. It counts captures, their milliseconds,
    replays and the distinct keys it has seen.
  * A replay launches no Python launcher, so the kernels' launch counts
    (ops/_build.py) get, at each replay, the launches the capture
    recorded.
  * A capture is a compile: a program wrapped by
    `obs/perf.instrument_megastep` notes each in the compile ledger
    (`megastep`, cold for the runner's first), its wall from the start
    of the warm-up run to the end of the first replay.

A capture, replay or launch failure raises to the plane, whose
degradation ladder demotes its megastep rung (engine/ladder.py); a
kernel that fails to build or launch is never demoted. On the CPU the
runner calls the body eagerly over the kernels' plain versions.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import torch

from ..ops import _build
from .batch import STRING_FIELDS, DeviceInputQueue
from .verdict import MegastepProgram


_CAPTURE_LOCK = threading.Lock()
# Dead entries' graphs and pool tensors, destroyed under _CAPTURE_LOCK by
# the next capture or `_free_released` (list.append and list.clear are
# atomic).
_RELEASED: list = []


def _free_released() -> None:
    """Destroy the dead entries' graphs unless a capture is under way
    (its holder of `_CAPTURE_LOCK` empties `_RELEASED` at its next
    capture instead)."""
    if _RELEASED and _CAPTURE_LOCK.acquire(blocking=False):
        try:
            _RELEASED.clear()
        finally:
            _CAPTURE_LOCK.release()


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph = graph
        self.inputs = inputs  # the flat device buffer of the window
        self.outputs = outputs
        self.launches = launches

    def __del__(self):
        # Runs on any thread, possibly inside another thread's capture:
        # the graph is kept alive for the next capture to destroy.
        if _RELEASED is not None:
            _RELEASED.append((self.graph, self.inputs, self.outputs))


class MegastepRunner:
    """Runs a `MegastepProgram` over `DeviceInputQueue` windows: one CUDA
    graph replay per window on the card, the eager body on the CPU."""

    MAX_GRAPHS = 32
    # torch.cuda.graph's capture_error_mode (see the module's docstring).
    capture_mode = "thread_local"

    def __init__(self, program: MegastepProgram, tables, device):
        self.program = program
        self.tables = tables
        self.device = torch.device(device)
        self._graphs: OrderedDict = OrderedDict()
        self._stream = None  # the capture stream, made at first capture
        self.captures = 0
        self.capture_ms_total = 0.0
        self.capture_ms_max = 0.0
        self.capture_wait_ms_total = 0.0
        self.capture_wait_ms_max = 0.0
        self.replays = 0
        self.evictions = 0
        self.keys: set = set()

    def key(self, queue: DeviceInputQueue, buf_id: int, k_ship: int):
        shape = queue.window_shape(buf_id, k_ship)
        rows = shape["asn"][1]
        return (self.program.kind, k_ship, rows,
                tuple(shape[f"{f}_bytes"][2] for f in STRING_FIELDS),
                self.program.dfa_mode())

    def run(self, queue: DeviceInputQueue, buf_id: int, k_used: int,
            k_ship: int):
        """(out, rule_hits, epoch_echo, pf_aux) of the window of set
        `buf_id` (`k_used` slices filled, shipped as `k_ship`), on the
        device. On the card they are the graph's static outputs: queue
        their copies before the next run."""
        if self.device.type != "cuda":
            stacked, nv, ep = queue.device_stack(buf_id, k_used, k_ship)
            return self.program.fn(self.tables, stacked, nv, ep)
        _free_released()
        key = self.key(queue, buf_id, k_ship)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, queue, buf_id, k_used, k_ship)
        else:
            self._graphs.move_to_end(key)
            queue.ship(buf_id, k_used, k_ship, entry.inputs)
            entry.graph.replay()
        _build.add_launches(entry.launches)
        self.replays += 1
        return entry.outputs

    def _capture(self, key, queue, buf_id, k_used, k_ship) -> _Graph:
        t0 = time.monotonic()
        flat, inputs = queue.empty_inputs(buf_id, k_ship, self.device)
        queue.ship(buf_id, k_used, k_ship, flat)
        stacked = {n: t for n, t in inputs.items()
                   if n not in ("n_valid", "epoch")}
        args = (self.tables, stacked, inputs["n_valid"], inputs["epoch"])
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.program.fn(*args)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        t_wait = time.monotonic()
        with _CAPTURE_LOCK, _build.record_launches() as launches:
            wait_ms = (time.monotonic() - t_wait) * 1e3
            self.capture_wait_ms_total += wait_ms
            self.capture_wait_ms_max = max(self.capture_wait_ms_max, wait_ms)
            _RELEASED.clear()  # no capture is under way
            try:
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode=self.capture_mode):
                    outputs = self.program.fn(*args)
            except BaseException:
                # A failed capture's graph, too, dies under the lock.
                _RELEASED.append(graph)
                del graph
                raise
        graph.replay()
        entry = _Graph(graph, flat, outputs, dict(launches))
        self._graphs[key] = entry
        if len(self._graphs) > self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
            self.evictions += 1
        ms = (time.monotonic() - t0) * 1e3
        # An instrumented program (obs/perf.instrument_megastep) puts the
        # capture in the compile ledger; a plain one has no such hook.
        note = getattr(self.program, "note_capture", None)
        if note is not None:
            note(key, ms, cold=self.captures == 0)
        self.captures += 1
        self.keys.add(key)
        self.capture_ms_total += ms
        self.capture_ms_max = max(self.capture_ms_max, ms)
        return entry

    def snapshot(self) -> dict:
        return {"captures": self.captures,
                "capture_ms_total": round(self.capture_ms_total, 3),
                "capture_ms_max": round(self.capture_ms_max, 3),
                "capture_wait_ms_total": round(self.capture_wait_ms_total, 3),
                "capture_wait_ms_max": round(self.capture_wait_ms_max, 3),
                "replays": self.replays,
                "cached": len(self._graphs),
                "evictions": self.evictions,
                "distinct_keys": len(self.keys)}
