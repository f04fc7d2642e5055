"""The native plane: the shared-memory verdict ring and its sidecar.

The C++ data plane (httpd) enqueues one fixed-width request slot per
request into a shared-memory ring and waits for a verdict byte on the
same ring. This module holds the port's side of that ring:

  * `Ring`: the ctypes client of the ring library. The library is the
    port's own copy of `pingoo_ring.{h,cc}` in `native/`, built at first
    use with the system C++ compiler into `_build/` (`build_ring_lib`);
  * the numpy mirrors of the ring's C structs (`REQUEST_SLOT_DTYPE` and
    the rest), so that a dequeued batch decodes with one structured view
    (`slots_to_arrays`);
  * `RingSidecar`: the drain loop. It dequeues one merged batch across
    the rings, runs the lane function of `engine/verdict.py` on the
    plan's device, and posts the verdict bytes back on each request's
    own ring, one batch at a time. With PINGOO_BODY_INSPECT=on it also
    drains the request-body windows through `engine/bodyscan.py` and
    posts one body verdict per flow;
  * `pack_requests` / `drive_stream`: a producer that drives a seeded
    request stream (and request bodies, as body windows) through a ring
    and checks that every request gets exactly one verdict on each lane.

The verdict byte: bits 0-1 the unverified-client action (0 none,
1 block, 2 captcha), bit 2 the verified-client block, bits 3-7 the first
matching service's order (31: none) when the sidecar routes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import ipaddress
import mmap
import os
import platform
import shutil
import socket
import subprocess
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from .device import check_env, resolve_device
from .engine.bodyscan import (BodyScanner, BodyWindow, body_inspect_enabled,
                              body_max_flows, body_window_bytes,
                              merge_actions, split_payload)
from .engine.batch import (RequestBatch, RequestTuple, batch_to_contexts,
                           bucket_arrays, pad_batch, pow2_batch_size,
                           tuple_to_context)
from .engine.verdict import (LANE_NONE, action_lanes, host_rule_lanes,
                             interpret_rules_row, make_lane_fn, merge_lanes)
from .expr import execute_as_bool
from .obs.window import WINDOW, TimingWindow
from .ops import _build

PKG_DIR = Path(__file__).resolve().parent
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"
RING_SOURCES = ("pingoo_ring.h", "pingoo_ring.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

FIELD_CAPS = {"method": 16, "host": 256, "path": 2048, "url": 2048,
              "user_agent": 256}

RING_MAGIC = 0x50474F52  # PINGOO_RING_MAGIC ("PGOR")
SLOT_FLAG_TRUNCATED = 0x1  # PINGOO_SLOT_FLAG_TRUNCATED
SPILL_SLOTS = 64  # PINGOO_SPILL_SLOTS
SPILL_DATA_CAP = 65536  # PINGOO_SPILL_DATA_CAP
SPILL_NONE = 0xFF  # PINGOO_SPILL_NONE

# -- ABI mirror of native/pingoo_ring.h --------------------------------------
# Sizes and offsets of the C structs; tests/test_torch_ring.py holds them
# against the JAX package's mirror and tools/analyze/abi_golden.json.

RING_FORMAT_VERSION = 6  # PINGOO_RING_VERSION
REQUEST_SLOT_SIZE = 4688  # sizeof(PingooRequestSlot)
VERDICT_SLOT_SIZE = 24  # sizeof(PingooVerdictSlot)
RING_HEADER_SIZE = 640  # sizeof(PingooRingHeader)
TELEMETRY_BLOCK_SIZE = 128  # sizeof(PingooRingTelemetry)
SPILL_SLOT_SIZE = 65552  # sizeof(PingooSpillSlot)
WAIT_BUCKETS = 8  # PINGOO_WAIT_BUCKETS
BODY_SLOTS = 256  # PINGOO_BODY_SLOTS
BODY_WINDOW_CAP = 4096  # PINGOO_BODY_WINDOW_CAP
BODY_SLOT_SIZE = 4136  # sizeof(PingooBodySlot)
BODY_FLAG_FINAL = 0x1  # PINGOO_BODY_FLAG_FINAL
BODY_FLAG_ABORT = 0x2  # PINGOO_BODY_FLAG_ABORT
# Body verdicts ride the verdict ring with this bit set in the ticket
# (PINGOO_BODY_VERDICT_BIT) so the data plane demuxes them.
BODY_VERDICT_BIT = 1 << 63

# PingooRequestSlot. The explicit itemsize carries the C struct's 8-byte
# tail padding (4684 -> 4688).
REQUEST_SLOT_DTYPE = np.dtype({
    "names": [
        "seq", "ticket", "enq_ms",
        "method_len", "host_len", "path_len", "url_len", "ua_len",
        "remote_port", "ip", "asn", "country", "flags", "spill_idx",
        "method", "host", "path", "url", "user_agent",
    ],
    "formats": [
        "<u8", "<u8", "<u8",
        "<u2", "<u2", "<u2", "<u2", "<u2",
        "<u2", ("u1", 16), "<u4", "S2", "u1", "u1",
        ("u1", 16), ("u1", 256), ("u1", 2048), ("u1", 2048), ("u1", 256),
    ],
    "offsets": [
        0, 8, 16,
        24, 26, 28, 30, 32,
        34, 36, 52, 56, 58, 59,
        60, 76, 332, 2380, 4428,
    ],
    "itemsize": REQUEST_SLOT_SIZE,
})

# PingooVerdictSlot.
VERDICT_SLOT_DTYPE = np.dtype({
    "names": ["seq", "ticket", "action", "_pad", "bot_score"],
    "formats": ["<u8", "<u8", "u1", ("u1", 3), "<f4"],
    "offsets": [0, 8, 16, 17, 20],
    "itemsize": VERDICT_SLOT_SIZE,
})

# PingooRingTelemetry (alignas(64) pads it to 128 bytes).
TELEMETRY_DTYPE = np.dtype({
    "names": ["enqueued", "enqueue_full", "dequeued", "depth_hwm",
              "verdicts_posted", "verdict_post_full", "wait_sum_ms",
              "wait_hist"],
    "formats": ["<u8", "<u8", "<u8", "<u8", "<u8", "<u8", "<u8",
                ("<u8", WAIT_BUCKETS)],
    "offsets": [0, 8, 16, 24, 32, 40, 48, 56],
    "itemsize": TELEMETRY_BLOCK_SIZE,
})

# PingooRingHeader: counters on their own cache lines; the liveness block
# (sidecar_epoch, sidecar_heartbeat_ms, posted_floor) after the
# telemetry block, the body ring's head and tail last.
RING_HEADER_DTYPE = np.dtype({
    "names": ["magic", "version", "capacity", "request_slot_size",
              "verdict_slot_size", "body_slot_size", "body_capacity",
              "req_head", "req_tail", "ver_head", "ver_tail",
              "telemetry", "sidecar_epoch", "sidecar_heartbeat_ms",
              "posted_floor", "body_head", "body_tail"],
    "formats": ["<u4", "<u4", "<u4", "<u4", "<u4", "<u4", "<u4", "<u8",
                "<u8", "<u8", "<u8", TELEMETRY_DTYPE, "<u8", "<u8",
                "<u8", "<u8", "<u8"],
    "offsets": [0, 4, 8, 12, 16, 20, 24, 64, 128, 192, 256, 320, 448,
                456, 464, 512, 576],
    "itemsize": RING_HEADER_SIZE,
})

# PingooSpillSlot: the full url/path of a request past a slot cap.
SPILL_SLOT_DTYPE = np.dtype({
    "names": ["state", "url_len", "path_len", "data"],
    "formats": ["<u8", "<u4", "<u4", ("u1", 65536)],
    "offsets": [0, 8, 12, 16],
    "itemsize": SPILL_SLOT_SIZE,
})

# PingooBodySlot: one request-body window.
BODY_SLOT_DTYPE = np.dtype({
    "names": ["seq", "flow", "win_seq", "win_len", "total_len", "flags",
              "_pad", "data"],
    "formats": ["<u8", "<u8", "<u4", "<u4", "<u8", "u1", ("u1", 7),
                ("u1", BODY_WINDOW_CAP)],
    "offsets": [0, 8, 16, 20, 24, 32, 33, 40],
    "itemsize": BODY_SLOT_SIZE,
})

# Flat order of pingoo_ring_telemetry_snapshot (PINGOO_TELEMETRY_WORDS);
# the 8 wait_hist buckets follow.
TELEMETRY_FIELDS = ("enqueued", "enqueue_full", "dequeued", "depth",
                    "depth_hwm", "verdicts_posted", "verdict_post_full",
                    "wait_sum_ms")
TELEMETRY_WORDS = len(TELEMETRY_FIELDS) + 8
WAIT_BUCKET_BOUNDS_MS = (1, 2, 5, 10, 50, 100, 1000)  # last bucket +inf

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    """The C++ compiler on PATH; RuntimeError when there is none."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler (c++ or g++) on PATH: the ring library is "
            f"built from {NATIVE_DIR / 'pingoo_ring.cc'} at first use")
    return cxx


@functools.lru_cache(maxsize=None)
def _compiler_identity(cxx: str) -> str:
    """What the compiler says of itself (version and target) and the
    machine it runs on: a library built elsewhere never matches."""
    out = [platform.machine()]
    for flag in ("--version", "-dumpmachine"):
        proc = subprocess.run([cxx, flag], capture_output=True, text=True)
        out.append(proc.stdout.strip())
    return "\n".join(out)


def ring_lib_path() -> Path:
    """The built library's path, named by a hash of the sources, the
    flags, the compiler's identity and the machine, so an edited source,
    another compiler or a `_build/` copied from another machine
    rebuilds. RuntimeError when there is no compiler."""
    digest = hashlib.sha256()
    for name in RING_SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_compiler_identity(_compiler()).encode())
    return BUILD_DIR / f"libpingoo_ring-{digest.hexdigest()[:16]}.so"


def build_ring_lib() -> float:
    """Compile `native/pingoo_ring.cc` unless it is built; returns the
    seconds the build took (0.0 when it was built already). Raises
    RuntimeError when there is no C++ compiler or the build fails. The
    output is written under a temporary name and renamed, so processes
    building at the same time never load a partial library."""
    cxx = _compiler()
    out = ring_lib_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    t0 = time.monotonic()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / "pingoo_ring.cc")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ring library build failed ({cxx} exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return time.monotonic() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pingoo_ring_bytes.restype = ctypes.c_size_t
    lib.pingoo_ring_bytes.argtypes = [ctypes.c_uint32]
    lib.pingoo_ring_init.restype = None
    lib.pingoo_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.pingoo_ring_attach.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint32)]
    lib.pingoo_ring_attach.restype = ctypes.c_int
    lib.pingoo_ring_enqueue_request.restype = ctypes.c_uint64
    lib.pingoo_ring_enqueue_request.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_uint32,  # method
        ctypes.c_char_p, ctypes.c_uint32,  # host
        ctypes.c_char_p, ctypes.c_uint32,  # path
        ctypes.c_char_p, ctypes.c_uint32,  # url
        ctypes.c_char_p, ctypes.c_uint32,  # ua
        ctypes.c_char_p,                   # ip[16]
        ctypes.c_uint16, ctypes.c_uint32, ctypes.c_char_p,
    ]
    lib.pingoo_ring_dequeue_requests.restype = ctypes.c_uint32
    lib.pingoo_ring_dequeue_requests.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
    lib.pingoo_ring_post_verdict.restype = ctypes.c_int
    lib.pingoo_ring_post_verdict.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint8, ctypes.c_float]
    lib.pingoo_ring_post_verdicts.restype = ctypes.c_uint32
    lib.pingoo_ring_post_verdicts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
    lib.pingoo_ring_poll_verdict.restype = ctypes.c_int
    lib.pingoo_ring_poll_verdict.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
    lib.pingoo_ring_enqueue_body.restype = ctypes.c_int
    lib.pingoo_ring_enqueue_body.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_uint8]
    lib.pingoo_ring_dequeue_bodies.restype = ctypes.c_uint32
    lib.pingoo_ring_dequeue_bodies.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
    lib.pingoo_ring_spill_read.restype = ctypes.c_int
    lib.pingoo_ring_spill_read.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint32)]
    lib.pingoo_ring_spill_release.restype = None
    lib.pingoo_ring_spill_release.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint8]
    lib.pingoo_ring_telemetry_snapshot.restype = None
    lib.pingoo_ring_telemetry_snapshot.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.pingoo_ring_record_waits.restype = None
    lib.pingoo_ring_record_waits.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
    lib.pingoo_ring_now_ms.restype = ctypes.c_uint64
    lib.pingoo_ring_now_ms.argtypes = []
    lib.pingoo_ring_sidecar_attach.restype = ctypes.c_uint64
    lib.pingoo_ring_sidecar_attach.argtypes = [ctypes.c_void_p]
    lib.pingoo_ring_heartbeat.restype = None
    lib.pingoo_ring_heartbeat.argtypes = [ctypes.c_void_p]
    lib.pingoo_ring_liveness.restype = None
    lib.pingoo_ring_liveness.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.pingoo_ring_set_posted_floor.restype = None
    lib.pingoo_ring_set_posted_floor.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64]
    lib.pingoo_ring_reclaim_request.restype = ctypes.c_int
    lib.pingoo_ring_reclaim_request.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
    return lib


def load_ring_lib() -> ctypes.CDLL:
    """The ring library, built at first use and bound once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            build_ring_lib()
            _lib = _bind(ctypes.CDLL(str(ring_lib_path())))
        return _lib


class Ring:
    """A mapped ring file: `create=True` makes and initialises it, else
    an existing ring is attached (its layout checked by the library)."""

    def __init__(self, path: str, capacity: int = 4096, create: bool = False):
        if capacity <= 0 or capacity & (capacity - 1):
            # The C ring masks with `pos & (cap - 1)`; another capacity
            # would alias slots.
            raise ValueError(
                f"ring capacity must be a power of two, got {capacity}")
        self.lib = load_ring_lib()
        nbytes = self.lib.pingoo_ring_bytes(capacity)
        self.fd = os.open(path, os.O_RDWR | (os.O_CREAT if create else 0),
                          0o600)
        if create:
            os.ftruncate(self.fd, nbytes)
        self.map = mmap.mmap(self.fd, nbytes)
        self.addr = ctypes.addressof(
            (ctypes.c_char * nbytes).from_buffer(self.map))
        if create:
            self.lib.pingoo_ring_init(self.addr, capacity)
        cap_out = ctypes.c_uint32()
        if self.lib.pingoo_ring_attach(self.addr, ctypes.byref(cap_out)) != 0:
            raise RuntimeError("ring attach failed (layout mismatch?)")
        self.capacity = int(cap_out.value)
        self._scratch = np.zeros(self.capacity, dtype=REQUEST_SLOT_DTYPE)
        self._body_scratch = None  # allocated by the first dequeue_bodies

    def close(self) -> None:
        self._scratch = None
        self._body_scratch = None
        self.map.close()
        os.close(self.fd)

    # -- producer side ---------------------------------------------------------

    def enqueue(self, method=b"GET", host=b"", path=b"/", url=b"/",
                user_agent=b"", ip: bytes = b"\x00" * 16, port: int = 0,
                asn: int = 0, country: bytes = b"XX") -> Optional[int]:
        """Enqueue one request; its ticket, or None when the ring is
        full."""
        ticket = self.lib.pingoo_ring_enqueue_request(
            self.addr, method, len(method), host, len(host), path, len(path),
            url, len(url), user_agent, len(user_agent), ip, port, asn,
            country)
        return None if ticket == 2**64 - 1 else int(ticket)

    def poll_verdict(self) -> Optional[tuple[int, int, float]]:
        """(ticket, verdict byte, bot score) of one posted verdict, or
        None when there is none."""
        ticket = ctypes.c_uint64()
        action = ctypes.c_uint8()
        score = ctypes.c_float()
        if self.lib.pingoo_ring_poll_verdict(
                self.addr, ctypes.byref(ticket), ctypes.byref(action),
                ctypes.byref(score)) != 0:
            return None
        return int(ticket.value), int(action.value), float(score.value)

    # -- consumer side ---------------------------------------------------------

    def dequeue_batch(self, max_batch: int = 1024) -> np.ndarray:
        """Up to `max_batch` request slots, copied out of the ring."""
        n = self.lib.pingoo_ring_dequeue_requests(
            self.addr, self._scratch.ctypes.data_as(ctypes.c_void_p),
            min(max_batch, self.capacity))
        return self._scratch[:n].copy()

    def dequeue_batch_into(self, out: np.ndarray) -> int:
        """Dequeue into the caller's REQUEST_SLOT_DTYPE buffer; returns
        the slots written."""
        if out.dtype != REQUEST_SLOT_DTYPE or not out.flags.c_contiguous:
            raise ValueError("dequeue_batch_into needs a C-contiguous "
                             "REQUEST_SLOT_DTYPE array")
        if not len(out):
            return 0
        return int(self.lib.pingoo_ring_dequeue_requests(
            self.addr, out.ctypes.data_as(ctypes.c_void_p),
            min(len(out), self.capacity)))

    def post_verdict(self, ticket: int, action: int,
                     score: float = 0.0) -> bool:
        return self.lib.pingoo_ring_post_verdict(
            self.addr, ticket, action, score) == 0

    def post_verdicts(self, tickets: np.ndarray, actions: np.ndarray) -> int:
        """Post a batch in one call; returns the count posted, fewer than
        len(tickets) only when the verdict ring is full."""
        tickets = np.ascontiguousarray(tickets, dtype=np.uint64)
        actions = np.ascontiguousarray(actions, dtype=np.uint8)
        if len(tickets) != len(actions):
            raise ValueError(f"{len(tickets)} tickets, {len(actions)} "
                             f"actions")
        return int(self.lib.pingoo_ring_post_verdicts(
            self.addr, tickets.ctypes.data_as(ctypes.c_void_p),
            actions.ctypes.data_as(ctypes.c_void_p), len(tickets)))

    def spill_read(self, idx: int) -> Optional[tuple[bytes, bytes]]:
        """The full (url, path) of a claimed spill slot, or None."""
        url_p = ctypes.c_char_p()
        path_p = ctypes.c_char_p()
        url_n = ctypes.c_uint32()
        path_n = ctypes.c_uint32()
        if self.lib.pingoo_ring_spill_read(
                self.addr, idx, ctypes.byref(url_p), ctypes.byref(url_n),
                ctypes.byref(path_p), ctypes.byref(path_n)) != 0:
            return None
        return (ctypes.string_at(url_p, url_n.value),
                ctypes.string_at(path_p, path_n.value))

    def spill_release(self, idx: int) -> None:
        self.lib.pingoo_ring_spill_release(self.addr, idx)

    def telemetry(self) -> dict:
        """The header's telemetry counters, queue depth and the
        enqueue -> verdict-post wait histogram (bucket upper bounds
        WAIT_BUCKET_BOUNDS_MS, the last +inf)."""
        buf = (ctypes.c_uint64 * TELEMETRY_WORDS)()
        if not self.map.closed:
            self.lib.pingoo_ring_telemetry_snapshot(self.addr, buf)
        out = {name: int(buf[i]) for i, name in enumerate(TELEMETRY_FIELDS)}
        out["wait_hist"] = [int(buf[len(TELEMETRY_FIELDS) + b])
                            for b in range(WAIT_BUCKETS)]
        return out

    def record_waits(self, enq_ms: np.ndarray) -> None:
        """Record the enqueue -> now wait of posted requests (their
        slots' enq_ms) in the telemetry histogram."""
        if self.map.closed:
            return
        enq = np.ascontiguousarray(enq_ms, dtype=np.uint64)
        self.lib.pingoo_ring_record_waits(
            self.addr, enq.ctypes.data_as(ctypes.c_void_p), len(enq))

    # -- request-body windows ---------------------------------------------------

    def enqueue_body(self, flow: int, win_seq: int, data: bytes,
                     total_len: int, flags: int = 0) -> bool:
        """Enqueue one body window of `flow` (its request's ticket);
        False when the body ring is full."""
        rc = self.lib.pingoo_ring_enqueue_body(
            self.addr, flow, win_seq, total_len, data, len(data), flags)
        if rc == -2:
            raise ValueError(
                f"body window of {len(data)} bytes exceeds the "
                f"{BODY_WINDOW_CAP}-byte slot cap")
        return rc == 0

    def dequeue_bodies(self, max_batch: int = BODY_SLOTS) -> np.ndarray:
        """Up to `max_batch` body windows as BODY_SLOT_DTYPE rows."""
        if self._body_scratch is None:
            self._body_scratch = np.zeros(BODY_SLOTS, dtype=BODY_SLOT_DTYPE)
        n = self.lib.pingoo_ring_dequeue_bodies(
            self.addr, self._body_scratch.ctypes.data_as(ctypes.c_void_p),
            min(max_batch, BODY_SLOTS))
        return self._body_scratch[:n].copy()

    # -- liveness protocol -----------------------------------------------------

    def sidecar_attach(self) -> int:
        """Bump the sidecar epoch, stamp the first heartbeat; returns the
        new epoch."""
        return int(self.lib.pingoo_ring_sidecar_attach(self.addr))

    def heartbeat(self) -> None:
        """Stamp the liveness heartbeat (every poll cycle)."""
        if not self.map.closed:
            self.lib.pingoo_ring_heartbeat(self.addr)

    def liveness(self) -> dict:
        """epoch, heartbeat_ms (0: no sidecar ever attached),
        posted_floor, req_tail and now_ms, on the ring's CLOCK_MONOTONIC
        millisecond clock."""
        buf = (ctypes.c_uint64 * 5)()
        if not self.map.closed:
            self.lib.pingoo_ring_liveness(self.addr, buf)
        return {"epoch": int(buf[0]), "heartbeat_ms": int(buf[1]),
                "posted_floor": int(buf[2]), "req_tail": int(buf[3]),
                "now_ms": int(buf[4])}

    def set_posted_floor(self, ticket: int) -> None:
        """Advance the posted floor (a monotonic max): every ticket below
        it has a verdict, so a reattaching sidecar scans only
        [posted_floor, req_tail) for orphans."""
        self.lib.pingoo_ring_set_posted_floor(self.addr, ticket)

    def reclaim(self, ticket: int) -> Optional[np.ndarray]:
        """Reclaim one orphaned ticket: a 1-row REQUEST_SLOT_DTYPE array
        when its bytes are intact (re-evaluate them), None when the slot
        was reused (fail the ticket open)."""
        out = np.zeros(1, dtype=REQUEST_SLOT_DTYPE)
        if self.lib.pingoo_ring_reclaim_request(
                self.addr, ticket,
                out.ctypes.data_as(ctypes.c_void_p)) != 0:
            return None
        return out


def slots_to_arrays(slots: np.ndarray) -> dict:
    """Request slots -> the batch arrays of `engine/batch.py` (byte
    matrices at the slot widths, int32 lengths, [n, 4] uint32 IP words,
    int64 asn and remote_port)."""
    arrays: dict = {}
    for field in FIELD_CAPS:
        arrays[f"{field}_bytes"] = np.ascontiguousarray(slots[field])
        arrays[f"{field}_len"] = slots[f"{field}_len" if field != "user_agent"
                                       else "ua_len"].astype(np.int32)
    arrays["country_bytes"] = np.frombuffer(
        slots["country"].tobytes(), dtype=np.uint8).reshape(-1, 2).copy()
    arrays["country_len"] = np.full(len(slots), 2, dtype=np.int32)
    ip = slots["ip"].reshape(-1, 16)
    arrays["ip"] = np.ascontiguousarray(
        ip.view(">u4").reshape(-1, 4).astype(np.uint32))
    arrays["asn"] = slots["asn"].astype(np.int64)
    arrays["remote_port"] = slots["remote_port"].astype(np.int64)
    return arrays


class RingSidecar:
    """The native plane's verdict engine, one batch at a time.

    `ring` is one Ring or a list of them (one per data-plane worker);
    each pass dequeues one merged batch across them and posts every
    verdict back on its request's own ring. `services` (one service order
    for every ring) or `ring_services` (one per ring, entries may be
    None) add the route bits 3-7; a route whose predicate runs on the
    host is merged in per batch. `geoip`, any object with
    `.lookup(ip) -> record with .asn and .country`, fills in rows the
    producer left at asn 0 / country "XX".

    With PINGOO_BODY_INSPECT=on, each pass first drains the rings'
    body-window rings through a `BodyScanner` on the same device and
    posts each finished flow's body verdict on its ring, the ticket
    tagged with BODY_VERDICT_BIT (0 for a flow the scanner degraded).

    `device=None` means the CUDA card (raises without one). A device
    error, in a batch or in a body scan, propagates out of `run()`: the
    heartbeat stops and the data plane's liveness detector fails
    requests open, as for a dead sidecar. Orphans of an earlier sidecar
    and rows whose url/path went past the slot caps are evaluated by the
    interpreter over their full strings.
    """

    # A blocking window longer than this is treated as wedged: the
    # watchdog stops covering for it.
    _HB_BUSY_GRACE_S = 120.0
    IDLE_SLEEP_S = 0.0002  # between empty drain passes
    WINDOW = WINDOW  # timing samples kept per stage (tests shrink it)

    def __init__(self, ring, plan, lists, max_batch: int = 1024,
                 services: Optional[list] = None, geoip=None,
                 ring_services: Optional[list] = None, device=None):
        dev = resolve_device(device)
        if dev.type != plan.device.type:
            raise ValueError(f"plan tables live on {plan.device}, the "
                             f"sidecar was asked to run on {dev}")
        check_env()
        self.rings: list[Ring] = list(ring) if isinstance(
            ring, (list, tuple)) else [ring]
        self.plan = plan
        self.lists = lists
        self.max_batch = max_batch
        self.geoip = geoip
        if ring_services is not None:
            if services is not None:
                raise ValueError("pass services or ring_services, not both")
            if len(ring_services) != len(self.rings):
                raise ValueError(
                    f"ring_services has {len(ring_services)} entries for "
                    f"{len(self.rings)} rings")
            per_ring = [list(s) if s else None for s in ring_services]
        else:
            per_ring = [list(services) if services else None] * len(self.rings)
        # One route lane per distinct service order; each ring reads its
        # own group's lane (a ring without services has no group).
        self._groups: list[list] = []
        self._ring_group_of: dict[int, int] = {}
        for r, svc in zip(self.rings, per_ring):
            if svc is None:
                continue
            if len(svc) > 31:
                # The route field has 5 bits and 31 means "no match".
                raise ValueError(
                    f"native routing supports at most 31 services, "
                    f"got {len(svc)}")
            if svc not in self._groups:
                self._groups.append(svc)
            self._ring_group_of[id(r)] = self._groups.index(svc)
        self._lane_fn = make_lane_fn(plan,
                                     service_groups=self._groups or None)
        by_index = {r.index: r for r in plan.rules}
        self._host_routes: list[list] = []
        for g in self._groups:
            hr = []
            for order, name in enumerate(g):
                ridx = plan.route_index.get(name)
                if ridx is not None and by_index[ridx].host:
                    hr.append((order, by_index[ridx].program))
            self._host_routes.append(hr)
        self.processed = 0
        self.batches = 0
        self.truncated_rows = 0
        self.spilled_rows = 0  # overflow rows re-evaluated untruncated
        # Per batch (ms), the newest WINDOW of each: slots to padded
        # batch arrays ("decode"), the lane function's issue up to the
        # returned device tensor ("verdict"), host rules, the device sync,
        # routes, spill rows and the posts ("finish"). `count` counts all.
        self.stage_ms: dict[str, TimingWindow] = {
            k: TimingWindow(self.WINDOW)
            for k in ("decode", "verdict", "finish")}
        self._ring_rr = -1  # rotating drain start
        self._thread = None
        self._stop = False
        # Body inspection: the scanner's tables are built here, on the
        # sidecar's device; "body" (ms) is one drain that had windows.
        self.body_scanner = BodyScanner(device=dev) \
            if body_inspect_enabled() else None
        self.body_verdicts = 0
        if self.body_scanner is not None:
            self.stage_ms["body"] = TimingWindow(self.WINDOW)
        if dev.type == "cuda":
            # A first-use kernel build takes seconds: never in a batch.
            _build.build()
        # Bump each ring's epoch, then answer what the previous epoch
        # dequeued and never answered, before the drain loop starts.
        self.reconciled = {"reeval": 0, "failopen": 0}
        self.epoch = max(r.sidecar_attach() for r in self.rings)
        # The loop stamps the heartbeat every pass; inside a declared
        # blocking window (device work, reconciliation) the watchdog
        # stamps for it, up to the grace cap, so a stall anywhere else
        # looks dead to the data plane.
        self._busy_since: Optional[float] = None
        self._hb_watchdog = threading.Thread(
            target=self._heartbeat_watchdog, name="pingoo-hb-watchdog",
            daemon=True)
        self._hb_watchdog.start()
        with self._hb_busy():
            self._reconcile_orphans()

    @contextlib.contextmanager
    def _hb_busy(self):
        self._busy_since = time.monotonic()
        try:
            yield
        finally:
            self._busy_since = None

    def _heartbeat_watchdog(self) -> None:
        while not self._stop:
            busy = self._busy_since
            if busy is not None \
                    and time.monotonic() - busy < self._HB_BUSY_GRACE_S:
                for r in self.rings:
                    r.heartbeat()
            time.sleep(0.1)

    def run(self, max_requests: Optional[int] = None) -> int:
        """Blocking drain loop; returns the requests processed.

        Each pass stamps every ring's heartbeat, makes one merged
        dequeue pass across the rings (the start ring rotates, so a
        saturated ring cannot starve the others) of up to `max_batch`
        slots, and serves them as one batch, completed before the next
        pass. Slots are served in the pass that dequeued them, so none
        is left unanswered when the loop exits."""
        self._thread = threading.current_thread()
        while not self._stop:
            for r in self.rings:
                r.heartbeat()
            # Bodies before requests: a flow's body verdict never waits
            # a batch behind the metadata batch that admitted it.
            if self.body_scanner is not None:
                self._drain_bodies()
            parts = self._dequeue()
            if parts:
                self._complete(*self._dispatch(parts))
            elif max_requests is None or self.processed < max_requests:
                time.sleep(self.IDLE_SLEEP_S)
            if max_requests is not None and self.processed >= max_requests:
                break
        # FINAL windows already in the ring still get their verdicts.
        if self.body_scanner is not None:
            self._drain_bodies()
        return self.processed

    def _drain_bodies(self) -> None:
        """Drain each ring's body-window ring through the scanner and post
        the body verdict of every flow whose FINAL window came, on that
        ring, ticket-tagged with BODY_VERDICT_BIT; then drop flows idle
        past the TTL. A scan error propagates (no fallback)."""
        t0 = time.monotonic()
        drained = 0
        for r in self.rings:
            slots = r.dequeue_bodies()
            if not len(slots):
                continue
            drained += len(slots)
            windows = [BodyWindow(
                flow_id=int(s["flow"]), win_seq=int(s["win_seq"]),
                data=s["data"][:int(s["win_len"])].tobytes(),
                final=bool(s["flags"] & BODY_FLAG_FINAL),
                abort=bool(s["flags"] & BODY_FLAG_ABORT))
                for s in slots]
            with self._hb_busy():
                verdicts = self.body_scanner.scan_windows(windows)
            for v in verdicts:
                ticket = v.flow_id | BODY_VERDICT_BIT
                action = 0 if v.degraded else v.action_byte()
                while not r.post_verdict(ticket, action):
                    if self._stop:
                        return
                    time.sleep(self.IDLE_SLEEP_S)
                self.body_verdicts += 1
        self.body_scanner.evict_stale()
        if drained:
            self.stage_ms["body"].append((time.monotonic() - t0) * 1e3)

    def _dequeue(self) -> list[tuple[Ring, np.ndarray]]:
        budget = self.max_batch
        nrings = len(self.rings)
        self._ring_rr = (self._ring_rr + 1) % nrings
        parts = []
        for i in range(nrings):
            if budget <= 0:
                break
            r = self.rings[(self._ring_rr + i) % nrings]
            s = r.dequeue_batch(budget)
            if len(s):
                if self.geoip is not None:
                    # Before decoding, so the device batch and the
                    # spill rows' interpreter see the same values.
                    self._enrich_slots(s)
                parts.append((r, s))
                budget -= len(s)
        return parts

    def _dispatch(self, parts):
        """Decode one merged batch and issue the lane function; returns
        what `_complete` takes."""
        t0 = time.monotonic()
        slots = parts[0][1] if len(parts) == 1 else np.concatenate(
            [s for _, s in parts])
        n = len(slots)
        raw = RequestBatch(size=n, arrays=slots_to_arrays(slots))
        # Columns trimmed to a power of two over the batch's longest
        # value (the scans walk columns), rows padded to a power of two.
        batch = pad_batch(
            RequestBatch(size=n, arrays=bucket_arrays(raw.arrays)),
            pow2_batch_size(n, self.max_batch))
        t1 = time.monotonic()
        with self._hb_busy():
            dev = self._lane_fn(self.plan.np_tables, batch.arrays)
        t2 = time.monotonic()
        self.stage_ms["decode"].append((t1 - t0) * 1e3)
        self.stage_ms["verdict"].append((t2 - t1) * 1e3)
        return parts, slots, raw, dev, t2

    def _enrich_slots(self, slots: np.ndarray) -> None:
        """Fill asn/country in place for rows enqueued with the unknown
        markers (asn 0 and country "XX")."""
        need = (slots["asn"] == 0) & (slots["country"] == b"XX")
        if not need.any():
            return
        ips16 = slots["ip"].reshape(-1, 16)
        for i in np.nonzero(need)[0]:
            addr = ipaddress.ip_address(bytes(ips16[i]))
            mapped = getattr(addr, "ipv4_mapped", None)
            try:
                rec = self.geoip.lookup(mapped or addr)
            except Exception:
                continue  # not found / loopback: keep the XX/0 markers
            slots["asn"][i] = rec.asn
            cc = rec.country.encode("ascii", "replace")[:2]
            if len(cc) == 2:
                slots["country"][i] = cc

    def _complete(self, parts, slots, raw, dev, t_issued: float) -> None:
        n = len(slots)
        # Host rules run while the device is still computing.
        host = host_rule_lanes(self.plan, raw, self.lists)
        with self._hb_busy():
            dev_lanes = dev.cpu().numpy()[:, :n]
        unverified, verified_block = merge_lanes(dev_lanes, host)
        self.batches += 1
        # Rows the producer flagged as truncated (a field past its slot
        # cap) were matched on the slot view; spilled ones are served
        # exactly below.
        self.truncated_rows += int(
            ((slots["flags"] & SLOT_FLAG_TRUNCATED) != 0).sum())
        # Each ring's rows read their group's route lane (rows 3..3+G);
        # rows of a ring with no group keep route 0.
        route = None
        if self._groups:
            route = np.zeros(n, dtype=np.int64)
            group_rows: list[list] = [[] for _ in self._groups]
            off = 0
            for ring, part in parts:
                gi = self._ring_group_of.get(id(ring))
                m = len(part)
                if gi is not None:
                    route[off:off + m] = dev_lanes[3 + gi][off:off + m]
                    group_rows[gi].append(np.arange(off, off + m))
                off += m
            contexts = None
            for gi, chunks in enumerate(group_rows):
                if not self._host_routes[gi] or not chunks:
                    continue
                rows = np.concatenate(chunks)
                for order, prog in self._host_routes[gi]:
                    better = rows[route[rows] > order]
                    if not len(better):
                        continue
                    if contexts is None:
                        contexts = batch_to_contexts(raw, self.lists)
                    for i in better:
                        try:
                            hit = prog is None or execute_as_bool(
                                prog, contexts[i])
                        except Exception:
                            hit = False  # route errors fail to no-match
                        if hit:
                            route[i] = order
        # Rows whose url/path overflowed the slot caps carry their full
        # strings in the owning ring's spill area: every lane of those
        # rows comes from the interpreter over the untruncated bytes.
        # Rows truncated without a spill slot keep the slot-view verdict.
        off = 0
        for ring, part in parts:
            gi = self._ring_group_of.get(id(ring))
            svcs = self._groups[gi] if gi is not None else None
            for j in np.nonzero(part["spill_idx"] != SPILL_NONE)[0]:
                idx = int(part["spill_idx"][j])
                full = ring.spill_read(idx)
                if full is not None:
                    unv, vblk, rt = self._interpret_overflow_row(
                        part[j], full[0], full[1], svcs)
                    unverified[off + j] = unv
                    verified_block[off + j] = vblk
                    if route is not None and gi is not None:
                        route[off + j] = rt
                    self.spilled_rows += 1
                ring.spill_release(idx)
            off += len(part)
        actions = unverified | (verified_block.astype(np.int32) << 2)
        if route is not None:
            actions = actions | (np.minimum(route, 31).astype(np.int32) << 3)
        acts = actions.astype(np.uint8)
        off = 0
        for ring, part in parts:  # scatter per ring
            m = len(part)
            tickets = np.ascontiguousarray(part["ticket"], dtype=np.uint64)
            done = 0
            while done < m:  # resume on a full verdict ring
                done += ring.post_verdicts(tickets[done:],
                                           acts[off + done:off + m])
                if done < m:
                    if self._stop:  # a dead consumer must not wedge stop()
                        return
                    time.sleep(self.IDLE_SLEEP_S)
            ring.record_waits(part["enq_ms"])
            # Parts complete in FIFO order, so the posted tickets form a
            # prefix: a reattaching sidecar's orphan scan starts here.
            ring.set_posted_floor(int(part["ticket"].max()) + 1)
            off += m
        self.processed += n
        self.stage_ms["finish"].append((time.monotonic() - t_issued) * 1e3)

    def _reconcile_orphans(self) -> None:
        """Answer the tickets the previous epoch dequeued and never
        answered: exactly [posted_floor, req_tail), since the floor only
        advances past posted prefixes. Slots whose bytes survived are
        re-evaluated by the interpreter; recycled slots fail open
        (allow). This runs before the drain loop, so it cannot race this
        epoch's own posts."""
        for ring in self.rings:
            lv = ring.liveness()
            floor, tail = lv["posted_floor"], lv["req_tail"]
            if tail <= floor:
                continue
            # Slots more than one capacity old are certainly recycled.
            start = max(floor, tail - ring.capacity)
            for ticket in range(start, tail):
                slot = ring.reclaim(ticket)
                action = 0
                kind = "failopen"
                if slot is not None:
                    try:
                        action = self._reeval_reclaimed(ring, slot)
                        kind = "reeval"
                    except Exception:
                        action = 0  # interpreter error: fail open
                self._post_one(ring, ticket, action)
                self.reconciled[kind] += 1
            ring.set_posted_floor(tail)

    def _reeval_reclaimed(self, ring: Ring, slots1: np.ndarray) -> int:
        """The verdict byte of one reclaimed orphan slot, through the
        interpreter."""
        if self.geoip is not None:
            self._enrich_slots(slots1)
        s = slots1[0]
        url = bytes(s["url"][:int(s["url_len"])])
        path = bytes(s["path"][:int(s["path_len"])])
        idx = int(s["spill_idx"])
        if idx != SPILL_NONE:
            full = ring.spill_read(idx)
            if full is not None:
                url, path = full
            ring.spill_release(idx)
        gi = self._ring_group_of.get(id(ring))
        svcs = self._groups[gi] if gi is not None else None
        unv, vblk, rt = self._interpret_overflow_row(s, url, path, svcs)
        action = unv | (int(vblk) << 2)
        if svcs is not None:
            action |= min(rt, 31) << 3
        return action

    def _post_one(self, ring: Ring, ticket: int, action: int) -> None:
        tickets = np.asarray([ticket], dtype=np.uint64)
        acts = np.asarray([action & 0xFF], dtype=np.uint8)
        # Bounded retry: a live consumer drains a full verdict ring in
        # microseconds; a dead one must not wedge the reattach.
        for _ in range(10000):
            if ring.post_verdicts(tickets, acts):
                return
            if self._stop:
                return
            time.sleep(self.IDLE_SLEEP_S)

    def _interpret_overflow_row(self, slot, url: bytes, path: bytes,
                                services=None) -> tuple[int, bool, int]:
        """(unverified, verified_block, route) of one row through the
        interpreter over the full url/path; routes follow `services`, the
        row's ring's order."""
        def field(name, ln):
            return bytes(slot[name][:slot[ln]]).decode("latin-1")

        addr = ipaddress.ip_address(bytes(slot["ip"]))
        v4 = getattr(addr, "ipv4_mapped", None)
        tup = RequestTuple(
            host=field("host", "host_len"),
            url=url.decode("latin-1"),
            path=path.decode("latin-1"),
            method=field("method", "method_len"),
            user_agent=field("user_agent", "ua_len"),
            ip=str(v4 or addr),
            remote_port=int(slot["remote_port"]),
            asn=int(slot["asn"]),
            country=bytes(slot["country"]).decode("latin-1"),
        )
        row = interpret_rules_row(self.plan,
                                  tuple_to_context(tup, self.lists))[None, :]
        unv, vblk = action_lanes(self.plan, row)
        rt = int(LANE_NONE)
        for order, name in enumerate(services or []):
            ridx = self.plan.route_index.get(name)
            if ridx is None or row[0, ridx]:
                rt = order
                break
        return int(unv[0]), bool(vblk[0]), rt

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Stop the drain loop and wait for it and the watchdog (when
        called from another thread): only then may the caller close the
        rings, which the loop may be inside."""
        self._stop = True
        for t in (self._thread, self._hb_watchdog):
            if t is not None and t.is_alive() \
                    and t is not threading.current_thread():
                t.join(timeout=join_timeout_s)


# -- a producer: drive a request stream through a ring ------------------------

DRIVE_BURST = 64  # requests enqueued between two polls
# A drive in the sidecar's own process (the CPU tests) passes this as
# `idle_s`, so that a pass that enqueued and polled nothing leaves the
# sidecar the interpreter lock.
DRIVE_IDLE_S = 0.0001


def pack_requests(reqs) -> list[tuple]:
    """RequestTuples -> the `Ring.enqueue` arguments (method, host, path,
    url, user_agent, ip, port, asn, country), with the IP v4-mapped into
    16 bytes in network order."""
    packed = []
    for r in reqs:
        try:
            ip = b"\x00" * 10 + b"\xff\xff" + socket.inet_aton(r.ip)
        except OSError:
            ip = b"\x00" * 16
        packed.append((r.method.encode(), r.host.encode(), r.path.encode(),
                       r.url.encode(), r.user_agent.encode(), ip,
                       r.remote_port, r.asn, r.country.encode()))
    return packed


@dataclass
class DriveResult:
    seconds: float  # first enqueue to last verdict
    # The verdict byte of each request, in stream order: for a request
    # with a body, its metadata byte merged with its body byte.
    actions: bytes
    waits_ms: list[float]  # enqueue -> last verdict polled, per request
    max_heartbeat_age_ms: int  # largest now_ms - heartbeat_ms seen
    meta_actions: bytes = b""  # the metadata lane's bytes, stream order
    body_actions: Optional[dict] = None  # {stream index: body byte}

    @property
    def checksum(self) -> int:
        """crc32 over the verdict bytes in stream order."""
        return zlib.crc32(self.actions)


def drive_stream(ring: Ring, stream: list[tuple], bodies=None,
                 timeout_s: float = 600.0, idle_s: float = 0.0) -> DriveResult:
    """Enqueue `stream` (from `pack_requests`) in bursts of up to
    DRIVE_BURST requests, polling verdicts between bursts (both rings
    are finite: enqueueing the whole stream first could wedge against a
    full verdict ring), until every request has its verdict. Reads the
    ring's liveness block at every poll.

    `bodies`, where given, has one entry per request: the body's bytes,
    or None for a request without one. A request with a body is a flow:
    its windows of at most PINGOO_BODY_WINDOW bytes (and the slot cap)
    are enqueued on the body ring after it, in order, the last one
    FINAL, and it waits for two verdicts, its ticket's and the one
    tagged BODY_VERDICT_BIT, which merge as `merge_actions` (httpd.cc's
    `merge_body_action`). At most
    PINGOO_BODY_MAX_FLOWS flows are open at once, so the scanner never
    evicts one. A pass that enqueued and polled nothing sleeps `idle_s`.
    Raises on a verdict, on either lane, for a ticket it did not issue
    or already has that verdict for, and TimeoutError after
    `timeout_s`."""
    window = min(body_window_bytes(), BODY_WINDOW_CAP)
    max_flows = body_max_flows()
    idx_of: dict[int, int] = {}
    t_enq: dict[int, float] = {}
    answered: set[int] = set()
    flow_of: dict[int, int] = {}  # ticket -> stream index, body pending
    body_answered: set[int] = set()
    body_acts: dict[int, int] = {}
    body_q: list[tuple] = []  # windows not yet on the body ring
    bq = 0
    meta = bytearray(len(stream))
    waits: list[float] = []
    max_age = 0
    i = 0
    t0 = time.monotonic()

    def lane_in(ticket: int) -> None:
        """One lane of `ticket` is in; its wait ends with the last."""
        if ticket not in idx_of and ticket not in flow_of:
            waits.append((time.monotonic() - t_enq.pop(ticket)) * 1e3)

    while len(answered) < len(stream) or flow_of:
        burst = 0
        while i < len(stream) and burst < DRIVE_BURST:
            m, h, p, u, ua, ip, port, asn, cc = stream[i]
            body = None if bodies is None else bodies[i]
            if body is not None and len(flow_of) >= max_flows:
                break
            t = ring.enqueue(method=m, host=h, path=p, url=u, user_agent=ua,
                             ip=ip, port=port, asn=asn, country=cc)
            if t is None:
                break
            idx_of[t] = i
            t_enq[t] = time.monotonic()
            if body is not None:
                flow_of[t] = i
                parts = split_payload(body, window)
                body_q.extend(
                    (t, s, d, len(body),
                     BODY_FLAG_FINAL if s == len(parts) - 1 else 0)
                    for s, d in enumerate(parts))
            i += 1
            burst += 1
        pushed = bq
        while bq < len(body_q) and ring.enqueue_body(*body_q[bq]):
            bq += 1
        lv = ring.liveness()
        max_age = max(max_age, lv["now_ms"] - lv["heartbeat_ms"])
        v = ring.poll_verdict()
        if idle_s and v is None and not burst and bq == pushed:
            time.sleep(idle_s)
        while v is not None:
            ticket, action, _score = v
            if ticket & BODY_VERDICT_BIT:
                flow = ticket & ~BODY_VERDICT_BIT
                if flow in body_answered:
                    raise RuntimeError(
                        f"the body of ticket {flow} was answered twice")
                if flow not in flow_of:
                    raise RuntimeError(
                        f"body verdict for unknown ticket {flow}")
                body_answered.add(flow)
                body_acts[flow_of.pop(flow)] = action
            else:
                if ticket in answered:
                    raise RuntimeError(f"ticket {ticket} was answered twice")
                if ticket not in idx_of:
                    raise RuntimeError(f"verdict for unknown ticket {ticket}")
                answered.add(ticket)
                meta[idx_of.pop(ticket)] = action
                flow = ticket
            lane_in(flow)
            v = ring.poll_verdict()
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(
                f"{len(stream) - len(answered)} of {len(stream)} requests "
                f"had no verdict and {len(flow_of)} bodies none after "
                f"{timeout_s} s")
    actions = bytearray(meta)
    for idx, b in body_acts.items():
        actions[idx] = merge_actions(meta[idx], b & 3, bool(b & 4))
    return DriveResult(seconds=time.monotonic() - t0, actions=bytes(actions),
                       waits_ms=waits, max_heartbeat_age_ms=max_age,
                       meta_actions=bytes(meta), body_actions=body_acts)
