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
  * `RingSidecar`: the drain loop. It dequeues across the rings into
    one merged batch, launched when the admission scheduler says
    (`sched/scheduler.py`), runs the lane function of `engine/verdict.py`
    on the plan's device (down the degradation ladder,
    `engine/ladder.py`, when a rung fails), and posts the verdict bytes
    back on each request's own ring, with up to `pipeline_depth` batches
    in flight under
    PINGOO_PIPELINE=on (the default), one at a time under off; under
    PINGOO_MEGASTEP=force K batches at a time go through one megastep
    window (one CUDA graph replay on the card). With
    PINGOO_BODY_INSPECT=on it also
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
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from .device import check_env, pipeline_mode, resolve_device
from .device import pipeline_depth as _env_depth
from .engine.bodyscan import (BodyScanner, BodyVerdict, BodyWindow,
                              body_inspect_enabled,
                              body_max_flows, body_window_bytes,
                              merge_actions, split_payload)
from .engine.batch import (DeviceInputQueue, RequestBatch, RequestTuple,
                           StagingEncoder, _nbytes, batch_to_contexts,
                           bucket_arrays, pad_batch, pow2_batch_size, resolve_stage_caps,
                           stage_overflow_thresholds, tuple_to_context)
from .engine.graphs import MegastepRunner
from .engine.hotswap import SwapHandle, note_swap, set_epoch_gauge, swap_counts
from .engine.ladder import DegradationLadder, DfaRung
from .engine.verdict import (LANE_NONE, _host_array, _resolve_megastep_mode,
                             action_lanes, dfa_dispatch_counts,
                             host_rule_lanes, interpret_rules_row,
                             make_lane_program, make_megastep_fn,
                             make_packed_lane_program, megastep_k_cap,
                             megastep_k_ladder, merge_lanes,
                             prefilter_aux_banks, prefilter_aux_len,
                             to_host_async)
from .expr import execute_as_bool
from .obs.chaos import ChaosInjector
from .obs.perf import (get_compile_ledger, instrument_megastep,
                       plan_fingerprint, record_build, staging_widths)
from .obs.pipeline import PipelineStats
from .obs.schema import (DFA_METRICS, PREFILTER_METRICS, RESILIENCE_METRICS,
                         RING_METRICS, SHARED_WAIT_HISTOGRAM,
                         STAGING_METRICS)
from .obs.window import WINDOW, TimingWindow
from .ops import _build
from .ops._build import never_demoted
from .sched import Scheduler, SchedulerConfig
from .sched.scheduler import load_cost_ledger, save_cost_ledger

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


# -- the data plane's binaries ------------------------------------------------
# The httpd (the C++ front door), and the upstream and HTTP load generator
# of the end-to-end drive: copies of the JAX package's sources in
# `native/`, each built at first use in the idiom of the ring library.
# name -> (compiled sources, included headers, links OpenSSL and nghttp2).

BINARIES = {
    "httpd": (("httpd.cc", "pingoo_ring.cc"),
              ("pingoo_ring.h", "ossl_shim.h", "nghttp2_shim.h",
               "up_h2_link.h"), True),
    "pong": (("pong.cc",), (), False),
    "loadgen_http": (("loadgen_http.cc",), (), False),
}
# The binaries' own sources (the ring's are RING_SOURCES).
DATA_PLANE_SOURCES = tuple(dict.fromkeys(
    f for sources, headers, _ in BINARIES.values()
    for f in sources + headers if f not in RING_SOURCES))
BIN_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread")
NGHTTP2_SONAME = "libnghttp2.so.14"


def _ldconfig_listing() -> str:
    """`ldconfig -p`: the shared libraries the dynamic linker finds."""
    for exe in (shutil.which("ldconfig"), "/sbin/ldconfig",
                "/usr/sbin/ldconfig"):
        if exe and os.path.exists(exe):
            return subprocess.run([exe, "-p"], capture_output=True,
                                  text=True).stdout
    return ""


def tls_sonames() -> tuple[str, ...]:
    """The versioned sonames the httpd links: OpenSSL 3 where the linker
    lists it, else OpenSSL 1.1 (`ossl_shim.h` uses only symbols both
    export), and nghttp2. The machine needs the runtime libraries only:
    the shims declare the ABI, so no headers or dev packages. Raises
    RuntimeError naming what `ldconfig -p` does not list."""
    listed = set()
    for line in _ldconfig_listing().splitlines():
        name = line.strip().split(" ", 1)[0]
        if name:
            listed.add(name)
    ver = "3" if "libssl.so.3" in listed else "1.1"
    need = (f"libssl.so.{ver}", f"libcrypto.so.{ver}", NGHTTP2_SONAME)
    missing = [n for n in need if n not in listed]
    if missing:
        raise RuntimeError(
            f"the httpd links {', '.join(need)}, and `ldconfig -p` lists "
            f"no {', '.join(missing)}: install the runtime libraries of "
            f"OpenSSL 3 (or 1.1) and nghttp2")
    return need


def _link_flags(name: str) -> tuple[str, ...]:
    return tuple(f"-l:{so}" for so in tls_sonames()) \
        if BINARIES[name][2] else ()


def binary_path(name: str) -> Path:
    """Where binary `name` of BINARIES is built: named by a hash of its
    sources and headers, the flags and link line, the compiler's
    identity and the machine, as `ring_lib_path` is. RuntimeError when
    there is no compiler or a soname is missing."""
    sources, headers, _ = BINARIES[name]
    digest = hashlib.sha256()
    for src in sources + headers:
        digest.update(src.encode() + b"\0" + (NATIVE_DIR / src).read_bytes())
    digest.update(" ".join(BIN_FLAGS + _link_flags(name)).encode())
    digest.update(_compiler_identity(_compiler()).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"


def build_binary(name: str) -> float:
    """Build binary `name` unless it is built; returns the seconds the
    build took (0.0 when it was built already). RuntimeError, with the
    compiler's stderr, when there is no compiler, a soname is missing or
    the build fails. Written under a temporary name and renamed."""
    cxx = _compiler()
    out = binary_path(name)
    if out.exists():
        return 0.0
    sources = BINARIES[name][0]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    t0 = time.monotonic()
    proc = subprocess.run(
        [cxx, *BIN_FLAGS, "-o", str(tmp),
         *(str(NATIVE_DIR / s) for s in sources), *_link_flags(name)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name} build failed ({cxx} exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return time.monotonic() - t0


def httpd_path() -> Path:
    return binary_path("httpd")


def build_httpd() -> float:
    return build_binary("httpd")


def ensure_built() -> dict[str, float]:
    """Build the ring library and every binary of BINARIES, one compiler
    process each, all started together; returns each one's build seconds
    (0.0 where it was built already). Raises the first failure: the JAX
    package's `ensure_built` returns False instead."""
    from concurrent.futures import ThreadPoolExecutor

    builds = {"libpingoo_ring": build_ring_lib,
              **{name: functools.partial(build_binary, name)
                 for name in BINARIES}}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(build) for name, build in builds.items()}
        return {name: f.result() for name, f in futures.items()}


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


# The rows of RingSidecar.warm_up's batches (method, host, path, url,
# user agent): a clean request and attack shapes of the CRS corpus, so
# that candidate rows reach the scans behind the prefilter, and a
# browser's request, whose user agent (over 64 bytes) and path (over 16)
# give the narrow batches the column widths of real traffic: a megastep
# graph is keyed by them.
WARM_REQUESTS = (
    (b"GET", b"www.example.com", b"/", b"/", b"Mozilla/5.0"),
    (b"GET", b"www.example.com", b"/static/css/site-main.css",
     b"/static/css/site-main.css?v=3",
     b"Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like "
     b"Gecko) Chrome/124.0.0.0 Safari/537.36"),
    (b"GET", b"www.example.com", b"/search",
     b"/search?q=1' UNION SELECT pass --", b"Mozilla/5.0"),
    (b"POST", b"www.example.com", b"/page",
     b"/page?x=<script>alert(1)</script>", b"sqlmap/1.8"),
    (b"GET", b"www.example.com", b"/download",
     b"/download?file=../../../../etc/passwd", b"curl/8.0"),
)


def _warm_slots(rows: int, wide: bool) -> np.ndarray:
    """`rows` request slots cycling through WARM_REQUESTS; with `wide`,
    the first row's path and url fill the slots' full width."""
    slots = np.zeros(rows, dtype=REQUEST_SLOT_DTYPE)
    for i in range(rows):
        m, h, p, u, ua = WARM_REQUESTS[i % len(WARM_REQUESTS)]
        if wide and i == 0:
            p = u = p + b"a" * (FIELD_CAPS["url"] - len(p))
        for field, value in (("method", m), ("host", h), ("path", p),
                             ("url", u), ("user_agent", ua)):
            slots[field][i, :len(value)] = np.frombuffer(value, np.uint8)
            key = "ua_len" if field == "user_agent" else f"{field}_len"
            slots[key][i] = len(value)
    slots["country"] = b"XX"
    slots["spill_idx"] = SPILL_NONE
    return slots


class _MegaSlice:
    """One batch staged into the open megastep window: what `_dispatch`
    would have handed `_complete`, kept until the window's one wait."""

    __slots__ = ("parts", "slots", "raw", "n", "slot_buf", "pipe_slot",
                 "epoch", "oldest_enq_ms", "skip_masks")


class _MegaWindow:
    """One megastep window in flight: its slices, its input set and its
    result's queued copies to the host."""

    __slots__ = ("slices", "buf_id", "lanes", "echo", "aux", "t_launch",
                 "k_ship")


class RingSidecar:
    """The native plane's verdict engine.

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

    Admission (sched/scheduler.py, PINGOO_SCHED_MODE): under
    `continuous` (the default) the slots dequeued by successive passes
    accumulate into one batch (under `on`, into one pooled buffer at its
    next free row) until it is full or the oldest slot's deadline slack
    (PINGOO_DEADLINE_MS, on the ring's `enq_ms` clock) no longer covers
    the cost model's estimate; under `fixed` every pass that dequeued
    something launches it. Under PINGOO_SCHED_FAILOPEN=allow the rows no
    launch can serve in time are posted action 0 at launch, and their
    device verdicts are never posted; posts later than the deadline
    count as misses.

    The executor (PINGOO_PIPELINE, as in the JAX package): under `on`
    (the default) slots dequeue straight into a pooled slot buffer
    (`Ring.dequeue_batch_into`), a batch encodes through a
    `StagingEncoder`'s reused views, issues the lane function with its
    result's copy to the host queued behind it (`verdict.to_host_async`),
    and up to `pipeline_depth` batches (default 3; PINGOO_PIPELINE_DEPTH
    overrides it) stay in flight, completed in FIFO order when the bound
    is reached or when a pass launched nothing. Under `off`, `0` or
    `false` each batch is decoded through slots_to_arrays -> bucket ->
    pad and completed before the next pass. Completion in FIFO order
    keeps the posted tickets a prefix.

    Compact staging (PINGOO_STAGING=compact, under `on`): the encoder
    copies each field's capped prefix (`resolve_stage_caps`) straight
    from the slots into one packed buffer, which uploads as one copy
    and is decoded on the device (`make_packed_lane_program`); megastep
    slices take the capped views. Rows whose true length passes a cap
    clamped below the plan's required depth (PINGOO_STAGING_DEPTH) are
    flagged and re-served from their full slot bytes through the
    interpreter (`depth_overflow_rows`).

    The megastep (PINGOO_MEGASTEP=force or auto at construction;
    PINGOO_MEGASTEP_K caps K, default 4): a launched batch with no window
    open opens one (under `auto` only with slots still queued on the
    rings, its K target sized by `sched.size_megastep_k` against the
    oldest slot's slack), checking out a `DeviceInputQueue` set; while a
    window is open every launched batch stages into it (padded to
    `max_batch`), so tickets still post in order. The window ships when
    it holds its target, when a pass dequeued nothing, or (under `auto`)
    when the oldest slice's slack no longer covers the window's
    estimate: K quantised up the pow2 ladder, one CUDA graph replay on
    the card (engine/graphs.py), its lanes' copy queued right after. A
    window in flight counts as one of `pipeline_depth`; its completion
    runs every slice's host rules, waits once, then completes each slice
    as a batch, and returns the set. The set and the slot buffers of its
    slices are held until then, so there are `pipeline_depth + 1` sets
    and `pipeline_depth * K + 1` slot buffers.

    The degradation ladder (engine/ladder.py), as in the JAX package: a
    staging error demotes `pipeline` (the batch decodes through the
    one-batch chain), a window that fails `megastep` (its slices are
    interpreted, later batches dispatched per batch), a device error
    `dfa` while the plan runs a lowered DFA (the plan's DFAs off), else
    `device` (the interpreter serves), a body scan error `body` (the
    flows' final windows answer action 0). Each probes back after its
    backoff. A kernel that fails to build or launch
    (`ops/_build.KernelBuildError`) and a CUDA runtime fault
    (`ops/_build.DeviceFault`) are never demoted: they propagate out of
    `run()`. PINGOO_CHAOS (obs/chaos.py) injects faults at the JAX
    package's points.

    Hot-swap (engine/hotswap.py): `request_swap(plan)` builds and warms
    the new plan's state on the caller's thread (under `force` its
    graphs are captured there, so the drain loop never captures for a
    swap) and queues a `SwapHandle`. At the top of its next pass the
    loop launches the open window, completes every batch in flight on
    the old plan, then adopts the new state and bumps `ruleset_epoch`:
    each ticket posts exactly once, on the plan of the epoch it was
    dequeued in. `swap_pauses_ms` keeps each flip's pause; a swap still
    queued when `run()` ends is resolved "rejected".

    Metrics (obs/registry.py, `registry=`, the process's REGISTRY by
    default), the JAX package's of plane "sidecar": the
    `pingoo_verdict_stage_ms` histograms (each timing recorded once,
    beside its `stage_ms` window), staged bytes, the prefilter counters
    from each batch's Stage-A aux vector (a window's summed over its
    slices), the DFA dispatch counts, `pingoo_reattach_reconciled_total`,
    `pingoo_sidecar_epoch`, and a collector that reads the rings'
    shared-memory telemetry blocks at scrape time (`pingoo_ring_*` and the
    ring's verdict-wait histogram: nothing is observed per request). The
    collector is unregistered first thing in `stop()`, before any caller
    can unmap a ring.

    The ledgers, as on the Python plane: the lane programs and the
    megastep's runner are instrumented for the compile ledger
    (obs/perf.py), and the cost model reloads the durable cost ledger at
    construction (`cost_ledger_result`, entry `<cuda|cpu>|sidecar`) and
    saves it at the end of `stop()`.

    `device=None` means the CUDA card (raises without one). Orphans of
    an earlier sidecar and rows whose url/path went past the slot caps
    are evaluated by the interpreter over their full strings.
    """

    # A blocking window longer than this is treated as wedged: the
    # watchdog stops covering for it.
    _HB_BUSY_GRACE_S = 120.0
    IDLE_SLEEP_S = 0.0002  # between empty drain passes
    WINDOW = WINDOW  # timing samples kept per stage (tests shrink it)

    def __init__(self, ring, plan, lists, max_batch: int = 1024,
                 services: Optional[list] = None, geoip=None,
                 ring_services: Optional[list] = None, device=None,
                 pipeline_depth: int = 3, registry=None):
        dev = resolve_device(device)
        if dev.type != plan.device.type:
            raise ValueError(f"plan tables live on {plan.device}, the "
                             f"sidecar was asked to run on {dev}")
        check_env()
        self._device = plan.device
        self.rings: list[Ring] = list(ring) if isinstance(
            ring, (list, tuple)) else [ring]
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
        if registry is None:
            from .obs.registry import REGISTRY as registry  # noqa: N813
        self._registry = registry
        self._init_metrics(registry)
        self.sched = Scheduler(SchedulerConfig.from_env(max_batch),
                               plane="sidecar", registry=registry)
        # The durable cost ledger, as on the Python plane (the
        # fingerprint is the boot plan's).
        self._plan_fp = plan_fingerprint(plan)
        self._backend_label = self._device.type
        self.cost_ledger_result = load_cost_ledger(
            self.sched.cost, backend=self._backend_label,
            fingerprint=self._plan_fp, plane="sidecar", registry=registry)
        # The compile series at zero: the sidecar's only compiles are its
        # kernels' build below and its megastep's graph captures.
        get_compile_ledger().ensure_instruments("sidecar", registry)
        self.ladder = DegradationLadder("sidecar", registry=registry)
        self._dfa_rung = DfaRung(self.ladder, plan)
        self.chaos = ChaosInjector.from_env()
        self.pipeline_mode = pipeline_mode()
        on = self.pipeline_mode == "on"
        self.pipeline_depth = _env_depth(pipeline_depth) if on else 1
        self._pipe = PipelineStats("sidecar", self.pipeline_depth,
                                   registry=registry)
        # Under `on`: a slot buffer per batch in flight plus the one the
        # next pass dequeues into.
        self._slot_pool: deque = deque()
        # The megastep's window being filled.
        self._mega_mode = _resolve_megastep_mode()
        self._mega_k = megastep_k_cap()
        self._mega_rungs = megastep_k_ladder(self._mega_k)
        self._mega_staged: list = []
        self._mega_buf_id: Optional[int] = None
        self._mega_target = self._mega_k
        self.ruleset_epoch = 0
        self.tenant = "default"
        self.mega_windows = 0
        self.mega_echo_mismatch = 0  # echoed epoch != the staged one
        # Queued hot-swaps (thread-safe), and each flip's pause (ms).
        self._swap_lock = threading.Lock()
        self._swap_queue: list[SwapHandle] = []
        self.swap_pauses_ms: list[float] = []
        self._adopt_plan_state(plan, lists, self._build_plan_state(plan))
        set_epoch_gauge("sidecar", 0)
        if on:
            per_batch = self._mega_k if self._mega_runner is not None else 1
            for _ in range(self.pipeline_depth * per_batch + 1):
                self._slot_pool.append(
                    np.zeros(max_batch, dtype=REQUEST_SLOT_DTYPE))
        self.processed = 0
        self.batches = 0
        self.truncated_rows = 0
        self.spilled_rows = 0  # overflow rows re-evaluated untruncated
        # Rows past a clamped compact cap, re-served from the slot bytes.
        self.depth_overflow_rows = 0
        # Bytes staged for the device (`RequestBatch.staged_bytes`),
        # under the staging that `stage_caps` names.
        self.staged_bytes = 0
        self.device_wait_s = 0.0  # waiting for the lanes after host rules
        # Per batch (ms), the newest WINDOW of each: slots to padded
        # batch arrays ("decode"), the lane function's issue up to the
        # queued copy of its result ("verdict"), host rules, the wait for
        # the result, routes, spill rows and the posts ("finish", from the
        # start of the batch's completion). `count` counts all.
        # Under the megastep, "decode" is one slice's staging, "verdict"
        # one window's issue and "window" its wall from the end of the
        # issue to its lanes on the host.
        self.stage_ms: dict[str, TimingWindow] = {
            k: TimingWindow(self.WINDOW)
            for k in ("decode", "verdict", "finish")}
        if self._mega_runner is not None:
            self.stage_ms["window"] = TimingWindow(self.WINDOW)
        self._ring_rr = -1  # rotating drain start
        # The batch being accumulated by `run()`: its parts, slots, the
        # oldest slot's enq_ms and (under `on`) its pooled buffer.
        self._pend_parts: list = []
        self._pend_n = 0
        self._pend_oldest: Optional[int] = None
        self._pend_buf = None
        # Passes that ended with slots accumulated and not launched.
        self.held_passes = 0
        self._thread = None
        self._stop = False
        # Body inspection: the scanner's tables are built here, on the
        # sidecar's device; "body" (ms) is one drain that had windows.
        self.body_scanner = None
        if body_inspect_enabled():
            try:
                self.body_scanner = BodyScanner(device=dev)
                self.body_scanner.attach_metrics("sidecar", registry)
            except Exception as exc:
                never_demoted(exc)
                # As in the JAX package: no scanner, the rung demoted.
                self.ladder.note_failure("body", exc)
        self.body_verdicts = 0
        if self.body_scanner is not None:
            self.stage_ms["body"] = TimingWindow(self.WINDOW)
        if dev.type == "cuda":
            # A first-use kernel build takes seconds: never in a batch.
            # One that ran nvcc is the lane program's cold compile.
            record_build(_build.build, plane="sidecar", fn="lanes",
                         fingerprint=self._plan_fp,
                         widths=staging_widths(plan), registry=registry)
        # Bump each ring's epoch, then answer what the previous epoch
        # dequeued and never answered, before the drain loop starts.
        self.reconciled = {"reeval": 0, "failopen": 0}
        self.epoch = max(r.sidecar_attach() for r in self.rings)
        registry.gauge("pingoo_sidecar_epoch",
                       RESILIENCE_METRICS["pingoo_sidecar_epoch"],
                       labels={"plane": "sidecar"}).set(self.epoch)
        self._collector_live = True
        registry.register_collector(self._export_ring_telemetry)
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

    def _init_metrics(self, registry) -> None:
        """The sidecar's instruments on `registry`, as the JAX package's
        sidecar makes them."""
        lab = {"plane": "sidecar"}
        self._stage = {
            stage: registry.histogram(
                "pingoo_verdict_stage_ms",
                "verdict pipeline stage latency (ms)",
                labels={"plane": "sidecar", "stage": stage})
            for stage in ("sched", "encode", "prefilter", "device_dispatch",
                          "device_compute", "resolve", "provenance")}
        self._staged_bytes_counter = {
            mode: registry.counter(
                "pingoo_staged_bytes_total",
                STAGING_METRICS["pingoo_staged_bytes_total"],
                labels={"plane": "sidecar", "mode": mode})
            for mode in ("full", "compact")}
        self._pf_rate_gauge = registry.gauge(
            "pingoo_prefilter_candidate_rate",
            PREFILTER_METRICS["pingoo_prefilter_candidate_rate"], labels=lab)
        self._pf_skip_counter = registry.counter(
            "pingoo_scan_banks_skipped_total",
            PREFILTER_METRICS["pingoo_scan_banks_skipped_total"], labels=lab)
        self._dfa_banks_counter = {
            mode: registry.counter(
                "pingoo_dfa_banks_total", DFA_METRICS["pingoo_dfa_banks_total"],
                labels={"plane": "sidecar", "mode": mode})
            for mode in ("auto", "force")}
        self._dfa_recheck_counter = registry.counter(
            "pingoo_dfa_recheck_total", DFA_METRICS["pingoo_dfa_recheck_total"],
            labels=lab)
        self._reattach_counters = {
            action: registry.counter(
                "pingoo_reattach_reconciled_total",
                RESILIENCE_METRICS["pingoo_reattach_reconciled_total"],
                labels={"plane": "sidecar", "action": action})
            for action in ("reeval", "failopen")}

    def _export_ring_telemetry(self) -> None:
        """Registry collector: the rings' telemetry blocks, summed, as
        the `pingoo_ring_*` metrics and the ring's verdict-wait
        histogram (its bucket counts set whole, never observed per
        request). Runs at scrape time; touches no ring after `stop()`."""
        if not self._collector_live:
            return
        t = self.ring_telemetry()
        reg = self._registry
        lab = {"plane": "sidecar"}
        for name, field in (
                ("pingoo_ring_enqueued_total", "enqueued"),
                ("pingoo_ring_dequeued_total", "dequeued"),
                ("pingoo_ring_enqueue_full_total", "enqueue_full"),
                ("pingoo_ring_verdicts_posted_total", "verdicts_posted"),
                ("pingoo_ring_verdict_post_full_total",
                 "verdict_post_full")):
            reg.counter(name, RING_METRICS[name],
                        labels=lab).set_total(t[field])
        reg.gauge("pingoo_ring_depth", RING_METRICS["pingoo_ring_depth"],
                  labels=lab).set(t["depth"])
        reg.gauge("pingoo_ring_depth_hwm",
                  RING_METRICS["pingoo_ring_depth_hwm"],
                  labels=lab).set(t["depth_hwm"])
        reg.histogram(
            SHARED_WAIT_HISTOGRAM,
            "verdict wait: ring enqueue -> verdict post (ms)",
            buckets=WAIT_BUCKET_BOUNDS_MS,
            labels=lab).set_bucket_counts(
                t["wait_hist"], total_sum=float(t["wait_sum_ms"]))

    def _build_plan_state(self, plan) -> dict:
        """Everything plan-derived that the drain loop reads, built
        without touching the served references (at init, and for a swap
        on the requester's thread): the lane programs, the host routes,
        the staging encoder with the plan's caps and, under `force`, the
        megastep's graph runner and its input sets, one per window in
        flight plus the one being filled.

        Compact staging: the plan's caps and the packed lane program
        where the staging encoder takes them (under `on`), else None:
        the one-batch chain stages in full. Under `on` a staging set per
        batch in flight (a pass issues only when fewer than
        `pipeline_depth` are)."""
        if plan.device.type != self._device.type:
            raise ValueError(f"plan tables live on {plan.device}, the "
                             f"sidecar runs on {self._device}")
        groups = self._groups or None
        by_index = {r.index: r for r in plan.rules}
        host_routes: list[list] = []
        for g in self._groups:
            hr = []
            for order, name in enumerate(g):
                ridx = plan.route_index.get(name)
                if ridx is not None and by_index[ridx].host:
                    hr.append((order, by_index[ridx].program))
            host_routes.append(hr)
        on = self.pipeline_mode == "on"
        caps = resolve_stage_caps(plan) if on else None
        state = {"plan": plan,
                 "lane_fn": make_lane_program(plan, service_groups=groups),
                 "pf_gated_banks": len(prefilter_aux_banks(plan)[0]),
                 "aux_len": prefilter_aux_len(plan),
                 "host_routes": host_routes, "stage_caps": caps,
                 "packed_lane_fn": None if caps is None
                 else make_packed_lane_program(plan, service_groups=groups),
                 "staging": None, "mega_runner": None, "mega_queue": None}
        slot_caps = dict(FIELD_CAPS, country=2)
        if self._mega_mode != "off":
            state["mega_runner"] = MegastepRunner(
                instrument_megastep(
                    make_megastep_fn(plan, kind="lanes",
                                     service_groups=self._groups),
                    plane="sidecar", fingerprint=plan_fingerprint(plan),
                    registry=self._registry),
                plan.np_tables, plan.device)
            state["mega_queue"] = DeviceInputQueue(
                self._mega_k, self.max_batch, field_specs=slot_caps,
                nbuf=self.pipeline_depth + 1)
        if on:
            state["staging"] = StagingEncoder(
                self.max_batch, field_specs=slot_caps,
                nbuf=self.pipeline_depth, stage_caps=caps,
                overflow_thresholds=None if caps is None
                else stage_overflow_thresholds(plan, caps))
        return state

    def _adopt_plan_state(self, plan, lists, state: dict) -> None:
        """Install a built state as the served references: at init, or at
        a swap's flip, when no batch is in flight and no window open."""
        same_plan = getattr(self, "plan", None) is plan
        self.plan = plan
        if lists is not None:
            self.lists = lists
        self._lane_fn = state["lane_fn"]
        self._pf_gated_banks = state["pf_gated_banks"]
        self._aux_len = state["aux_len"]
        self._host_routes = state["host_routes"]
        self.stage_caps = state["stage_caps"]
        # The adopted plan's staging widths (`pingoo_staging_field_cap`).
        for field, cap in (self.stage_caps or {}).items():
            self._registry.gauge(
                "pingoo_staging_field_cap",
                STAGING_METRICS["pingoo_staging_field_cap"],
                labels={"field": field}).set(int(cap))
        self._packed_lane_fn = state["packed_lane_fn"]
        self._staging = state["staging"]
        self._mega_runner = state["mega_runner"]
        self._mega_queue = state["mega_queue"]
        self._plan_state = state
        # The ladder's dfa rung restores the plan's own DFA mode (a swap
        # to the served plan, as the swap storm's, keeps the rung's
        # state).
        if not same_plan:
            self._dfa_rung.reset(plan)

    def request_swap(self, plan, lists=None, tenant: str = "default",
                     state: Optional[dict] = None) -> SwapHandle:
        """Thread-safe hot-swap request: build and warm the plan's state
        here, on the caller's thread (`_warm_state`, which under `force`
        captures its graphs), then queue a SwapHandle that the drain
        loop flips to at its next pass; `handle.wait()` blocks until the
        flip. A build or warm-up failure raises here, and the old plan
        goes on serving. A built `state` is queued as it is (the swap
        storm re-queues the served one)."""
        if state is None:
            try:
                state = self._build_plan_state(plan)
                self._warm_state(state)
            except Exception as exc:
                note_swap("sidecar", tenant, "rejected")
                raise RuntimeError(f"hot-swap build failed for tenant "
                                   f"{tenant!r}: {exc}") from exc
        handle = SwapHandle(plan=plan, tenant=tenant, lists=lists,
                            state=state)
        with self._swap_lock:
            self._swap_queue.append(handle)
        return handle

    def _apply_swaps(self, inflight: deque) -> None:
        """Every queued swap, at the top of a pass: the batch being
        accumulated launches (into the open window when there is room),
        the open window launches, every batch in flight completes (and
        posts) on the old plan, then the newest state is adopted, one
        epoch per swap. The pause covers the drain and the flips; no
        capture, since each state was warmed by its requester."""
        t0 = time.monotonic()
        with self._hb_busy():
            self._launch_pending(inflight)
            if self._mega_staged:
                inflight.append(self._launch_megastep())
            while inflight:
                self._complete_inflight(inflight.popleft())
            while True:
                with self._swap_lock:
                    if not self._swap_queue:
                        break
                    handle = self._swap_queue.pop(0)
                self._adopt_plan_state(handle.plan, handle.lists,
                                       handle.state)
                self.ruleset_epoch += 1
                self.tenant = handle.tenant
                pause_ms = (time.monotonic() - t0) * 1e3
                set_epoch_gauge("sidecar", self.ruleset_epoch)
                note_swap("sidecar", handle.tenant, "ok")
                self._stage["sched"].observe(pause_ms)
                self.swap_pauses_ms.append(pause_ms)
                handle.resolve(self.ruleset_epoch, pause_ms)

    def _reject_queued_swaps(self) -> None:
        with self._swap_lock:
            leftovers, self._swap_queue = self._swap_queue, []
        for handle in leftovers:
            note_swap("sidecar", handle.tenant, "rejected")
            handle.resolve(self.ruleset_epoch, 0.0, result="rejected",
                           error=RuntimeError("the sidecar's drain loop "
                                              "ended before the flip"))

    @contextlib.contextmanager
    def _hb_busy(self):
        """A declared blocking window of the drain loop, during which the
        watchdog stamps the heartbeat; nested windows extend the
        outermost one (a swap's drain holds the batches' own)."""
        outer = self._busy_since
        if outer is None:
            self._busy_since = time.monotonic()
        try:
            yield
        finally:
            self._busy_since = outer

    def _heartbeat_watchdog(self) -> None:
        while not self._stop:
            busy = self._busy_since
            if busy is not None \
                    and time.monotonic() - busy < self._HB_BUSY_GRACE_S \
                    and not self.chaos.heartbeat_frozen():
                for r in self.rings:
                    r.heartbeat()
            time.sleep(0.1)

    def _now_ms(self) -> int:
        """The ring's clock (`enq_ms`'s), in ms."""
        return int(self.rings[0].lib.pingoo_ring_now_ms())

    def run(self, max_requests: Optional[int] = None) -> int:
        """Blocking drain loop; returns the requests processed.

        Each pass stamps every ring's heartbeat and makes one merged
        dequeue pass across the rings (the start ring rotates, so a
        saturated ring cannot starve the others) of up to what the batch
        being accumulated has room for; the batch launches when the
        scheduler says (every pass that dequeued under `fixed`). The
        oldest batch in flight completes when `pipeline_depth` are in
        flight or when the pass launched nothing. The batch being
        accumulated and the batches in flight are completed when the
        loop exits, so no dequeued slot is left unanswered."""
        self._thread = threading.current_thread()
        inflight: deque = deque()
        sched = self.sched
        continuous = sched.config.mode == "continuous"
        self._pend_parts, self._pend_n, self._pend_oldest = [], 0, None
        self._pend_buf = self._take_slot_buf() if self._staging is not None \
            else None
        while not self._stop:
            if not self.chaos.heartbeat_frozen():
                for r in self.rings:
                    r.heartbeat()
            # Bodies before requests: a flow's body verdict never waits
            # a batch behind the metadata batch that admitted it.
            if self.body_scanner is not None:
                self._drain_bodies()
            # The swap storm re-queues the served state: any verdict
            # drift it makes is a fault of the swap protocol.
            if self.chaos.swap_due(self.batches):
                self.request_swap(self.plan, tenant=self.tenant,
                                  state=self._plan_state)
            if self._swap_queue:
                self._apply_swaps(inflight)
            got = self._accumulate()
            launch = False
            if self._pend_n:
                launch = not continuous or self._pend_n >= self.max_batch \
                    or sched.should_launch(self._pend_n,
                                           self._pend_oldest / 1e3,
                                           self._now_ms() / 1e3)
                self.held_passes += not launch
            if launch:
                # While a window is open every batch stages into it: a
                # batch issued past staged ones would post younger
                # tickets first.
                if self._mega_staged or self._mega_begin(self._pend_oldest):
                    self._stage_mega_slice(*self._take_pending())
                else:
                    inflight.append(self._dispatch(*self._take_pending()))
            if self._mega_staged and (got == 0 or self._mega_due()):
                inflight.append(self._launch_megastep())
            if inflight and (len(inflight) >= self.pipeline_depth
                             or not launch):
                self._complete_inflight(inflight.popleft())
            elif got == 0 and not launch and (
                    max_requests is None or self.processed < max_requests):
                time.sleep(self.IDLE_SLEEP_S)
            if max_requests is not None and not inflight \
                    and not self._mega_staged and not self._pend_n \
                    and self.processed >= max_requests:
                break
        # Dequeued slots still get their verdicts, in FIFO order.
        self._launch_pending(inflight)
        if self._mega_staged:
            inflight.append(self._launch_megastep())
        while inflight:
            self._complete_inflight(inflight.popleft())
        if self._pend_buf is not None:
            self._slot_pool.append(self._pend_buf)
            self._pend_buf = None
        # FINAL windows already in the ring still get their verdicts.
        if self.body_scanner is not None:
            self._drain_bodies()
        self._reject_queued_swaps()
        return self.processed

    def _accumulate(self) -> int:
        """One dequeue pass into the batch being accumulated (under `on`
        its pooled buffer at its next free row); returns the slots it
        got."""
        budget = self.max_batch - self._pend_n
        if budget <= 0:
            return 0
        parts = self._dequeue(self._pend_buf, self._pend_n, budget)
        got = 0
        for _, s in parts:
            got += len(s)
            first = int(s["enq_ms"].min())
            if self._pend_oldest is None or first < self._pend_oldest:
                self._pend_oldest = first
        self._pend_parts += parts
        self._pend_n += got
        return got

    def _take_pending(self):
        """The batch accumulated so far, as (parts, slot buffer, n, oldest
        enq_ms), and a fresh accumulation."""
        out = (self._pend_parts, self._pend_buf, self._pend_n,
               self._pend_oldest)
        self._pend_parts, self._pend_n, self._pend_oldest = [], 0, None
        if self._pend_buf is not None:
            self._pend_buf = self._take_slot_buf()
        return out

    def _launch_pending(self, inflight: deque) -> None:
        """Launch the batch being accumulated now: into the open window
        while it has room, else (after shipping the window) per batch."""
        if not self._pend_n:
            return
        if self._mega_staged and len(self._mega_staged) < self._mega_k:
            self._stage_mega_slice(*self._take_pending())
            return
        if self._mega_staged:
            inflight.append(self._launch_megastep())
        inflight.append(self._dispatch(*self._take_pending()))

    def _drain_bodies(self) -> None:
        """Drain each ring's body-window ring through the scanner and post
        the body verdict of every flow whose FINAL window came, on that
        ring, ticket-tagged with BODY_VERDICT_BIT; then drop flows idle
        past the TTL. While the ladder's body rung is demoted (or when a
        scan fails, which demotes it and drops every live flow) each
        final window is answered action 0, on the metadata verdict
        alone."""
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
            verdicts = None
            if self.ladder.try_rung("body"):
                try:
                    with self._hb_busy():
                        verdicts = self.body_scanner.scan_windows(windows)
                    self.ladder.note_success("body")
                except Exception as exc:
                    never_demoted(exc)
                    self.ladder.note_failure("body", exc)
                    # Carries are suspect after a fault mid-scan.
                    self.body_scanner.flows.clear()
            if verdicts is None:
                verdicts = [BodyVerdict(w.flow_id, degraded=True)
                            for w in windows if w.final]
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

    def _take_slot_buf(self) -> np.ndarray:
        """A pooled REQUEST_SLOT_DTYPE buffer for the next batch. The
        pool holds one more than the batches in flight can (K per
        megastep window), so an empty pool (IndexError) means a buffer
        leaked."""
        return self._slot_pool.popleft()

    def _queued_depth(self) -> int:
        """Slots still queued across the rings (the megastep's `auto`
        backlog test)."""
        return sum(int(r.telemetry()["depth"]) for r in self.rings)

    def _dequeue(self, slot_buf=None, fill: int = 0,
                 budget: Optional[int] = None) -> list[tuple[Ring, np.ndarray]]:
        """One merged dequeue pass of up to `budget` slots: (ring, slots)
        per ring that had any. With `slot_buf` (under `on`) every ring's
        slots land in it one after the other from row `fill`, so the
        accumulated batch is one view of it."""
        budget = self.max_batch if budget is None else budget
        nrings = len(self.rings)
        self._ring_rr = (self._ring_rr + 1) % nrings
        parts = []
        for i in range(nrings):
            if budget <= 0:
                break
            r = self.rings[(self._ring_rr + i) % nrings]
            if slot_buf is not None:
                k = r.dequeue_batch_into(slot_buf[fill:fill + budget])
                s = slot_buf[fill:fill + k]
            else:
                s = r.dequeue_batch(budget)
            if len(s):
                if self.geoip is not None:
                    # Before decoding, so the device batch and the
                    # spill rows' interpreter see the same values.
                    self._enrich_slots(s)
                parts.append((r, s))
                budget -= len(s)
                fill += len(s)
        return parts

    def _dispatch(self, parts, slot_buf=None, n: Optional[int] = None,
                  oldest_enq_ms: Optional[int] = None):
        """Encode one merged batch and issue the lane function, its
        result's copy to the host queued behind it; returns what
        `_complete` takes. A staging error demotes the pipeline rung (the
        batch decodes through the one-batch chain); a device error the
        dfa or device rung (`_complete` interprets the batch)."""
        if n is None:
            n = sum(len(p) for _, p in parts)
        slot = self._pipe.enter(self.pipeline_mode)
        self.chaos.stage("encode")
        t0 = time.monotonic()
        staged = batch = None
        if slot_buf is not None:
            slots = slot_buf[:n]
            if self.ladder.try_rung("pipeline"):
                try:
                    staged = self._staging.checkout(block=False)
                    batch = self._staging.encode_slots(
                        slots, pad_to=pow2_batch_size(n, self.max_batch),
                        into=staged)
                    self.ladder.note_success("pipeline")
                except Exception as exc:
                    never_demoted(exc)
                    if staged is not None:
                        self._staging.release(staged)
                    staged = batch = None
                    self.ladder.note_failure("pipeline", exc)
        else:
            slots = parts[0][1] if len(parts) == 1 else np.concatenate(
                [s for _, s in parts])
        if batch is not None:
            # The unpadded rows of the same views: every consumer of
            # `raw` reads data[:len], and the columns hold every row's
            # bytes up to its length or its field's cap. The flags of
            # rows past a clamped cap ride along to `_finish`.
            raw = RequestBatch(size=n, arrays={
                k: v[:n] for k, v in batch.arrays.items()},
                overflow=None if batch.overflow is None
                else batch.overflow[:n])
        else:
            raw, batch = self._decode(slots)
        t1 = time.monotonic()
        self.chaos.stage("dispatch")
        dev = aux = None
        stage_a_ms = None
        self._dfa_rung.tick(self.plan)
        if self.ladder.try_rung("device"):
            try:
                # Raised before any launch: the CUDA context stays clean.
                self.chaos.maybe_xla_error(self.batches)
                with self._hb_busy():
                    lanes, aux, stage_a_ms = self._issue_lanes(batch)
                    dev = to_host_async(lanes)
                    if aux is not None:
                        aux = to_host_async(aux)
            except Exception as exc:
                never_demoted(exc)
                self._dfa_rung.failure(self.plan, exc)
                dev = aux = None
        t2 = time.monotonic()
        self._count_staged(batch)
        self._note_stage("decode", "encode", (t1 - t0) * 1e3)
        self._note_stage("verdict", "device_dispatch", (t2 - t1) * 1e3)
        if stage_a_ms is not None:
            self._stage["prefilter"].observe(stage_a_ms)
        self._pipe.note_stage(slot, "encode", t0, t1)
        self._pipe.note_stage(slot, "dispatch", t1, t2)
        sched = self.sched
        sched.observe_stage_cost("encode", self.max_batch, (t1 - t0) * 1e3)
        sched.observe_stage_cost("dispatch", self.max_batch, (t2 - t1) * 1e3)
        if batch.staged_bytes:
            sched.observe_dispatch_bytes(batch.staged_bytes, (t2 - t1) * 1e3)
        sched.note_launch(n, 0)
        self._note_hold(oldest_enq_ms)
        skip_masks = None
        if sched.config.failopen == "allow":
            # Encode and issue are spent: a row is charged the compute
            # stage's estimate, the work still ahead of it.
            skip_masks = self._failopen_late_rows(
                parts, self._now_ms(),
                sched.cost.estimate_stage("compute", self.max_batch))
        return (parts, slots, raw, dev, t2, slot_buf, staged, slot,
                skip_masks, time.monotonic(), None, None, aux)

    def _failopen_late_rows(self, parts, now_ms: int, est_ms: float) -> list:
        """PINGOO_SCHED_FAILOPEN=allow: the rows whose deadline cannot be
        met with `est_ms` of work still ahead are posted action 0 now,
        each once; their device verdicts are computed and never posted.
        Returns one keep-mask per part."""
        deadline_ms = self.sched.config.deadline_ms
        masks = []
        for ring, part in parts:
            late = (now_ms + est_ms) > (part["enq_ms"].astype(np.int64)
                                        + deadline_ms)
            if late.any():
                tickets = np.ascontiguousarray(part["ticket"][late],
                                               dtype=np.uint64)
                self._post_all(ring, tickets,
                               np.zeros(len(tickets), dtype=np.uint8))
                ring.record_waits(part["enq_ms"][late])
                self.sched.note_failopen(int(late.sum()))
            masks.append(~late)
        return masks

    def _post_all(self, ring: Ring, tickets: np.ndarray,
                  acts: np.ndarray) -> bool:
        """Post every verdict, resuming on a full verdict ring (and on
        the chaos injector's pretended one); False when the loop stopped
        first (a dead consumer must not wedge stop())."""
        done = 0
        while done < len(tickets):
            if self.chaos.verdict_full():
                time.sleep(self.IDLE_SLEEP_S)
                continue
            done += ring.post_verdicts(tickets[done:], acts[done:])
            if done < len(tickets):
                if self._stop:
                    return False
                time.sleep(self.IDLE_SLEEP_S)
        return True

    def _issue_lanes(self, batch: RequestBatch, state=None):
        """The lane program (the served one, or a built `state`'s) on one
        padded batch: its packed buffer under compact staging, its
        arrays otherwise. Returns (lanes, the Stage-A aux vector, Stage A's
        issue ms), the last two None with the prefilter off."""
        if state is not None:
            tables = state["plan"].np_tables
            lane_fn, packed_fn = state["lane_fn"], state["packed_lane_fn"]
        else:
            tables = self.plan.np_tables
            lane_fn, packed_fn = self._lane_fn, self._packed_lane_fn
        if batch.packed is not None:
            return packed_fn(tables, batch.packed, batch.layout)
        return lane_fn(tables, batch.arrays)

    def _count_staged(self, batch: RequestBatch) -> None:
        """A per-batch issue's staged bytes, as the JAX package counts
        them (`pingoo_staged_bytes_total{mode}`)."""
        self.staged_bytes += batch.staged_bytes
        if batch.staged_bytes:
            self._staged_bytes_counter[
                "compact" if batch.packed is not None
                else "full"].inc(batch.staged_bytes)

    def _note_stage(self, window: str, stage: str, ms: float) -> None:
        """One timing, at one site: its `stage_ms` window and its
        `pingoo_verdict_stage_ms` histogram."""
        self.stage_ms[window].append(ms)
        self._stage[stage].observe(ms)

    def _note_hold(self, oldest_enq_ms: Optional[int]) -> None:
        """The `sched` stage of a launch: its oldest slot's enqueue to the
        launch, on the ring's clock."""
        if oldest_enq_ms is not None:
            self._stage["sched"].observe(
                max(0.0, float(self._now_ms() - oldest_enq_ms)))

    def _observe_prefilter(self, aux: np.ndarray, rows: int) -> None:
        """Fold a Stage-A aux vector (host int32, the JAX package's
        layout) into the sidecar's prefilter instruments: the candidate
        rate over `rows` x gated banks, the banks skipped."""
        denom = rows * self._pf_gated_banks
        if denom:
            self._pf_rate_gauge.set(int(aux[0]) / denom)
        self._pf_skip_counter.inc(int(aux[1]))

    def _observe_dfa(self) -> None:
        """The plan's DFA dispatch counts of one batch (host-static)."""
        mode, banks, rechecks = dfa_dispatch_counts(self.plan)
        if banks:
            ctr = self._dfa_banks_counter.get(mode)
            if ctr is not None:
                ctr.inc(banks)
            if rechecks:
                self._dfa_recheck_counter.inc(rechecks)

    # -- the megastep -------------------------------------------------------

    def _mega_begin(self, oldest_enq_ms: Optional[int] = None) -> bool:
        """Open a window for the batch being launched? Under `force`
        always (a window of one slice is legal); under `auto` only with
        slots still queued on the rings, with a K target sized against
        the oldest slot's slack; never while the megastep rung is
        demoted outside its probe. Checks out the window's set."""
        if self._mega_runner is None:
            return False
        if self._mega_mode == "auto" and self._queued_depth() <= 0:
            return False
        if not self.ladder.try_rung("megastep"):
            return False
        self._mega_target = self._mega_k
        if self._mega_mode != "force":
            now_ms = self._now_ms()
            oldest = now_ms if oldest_enq_ms is None else oldest_enq_ms
            self._mega_target = min(self._mega_k, self.sched.size_megastep_k(
                self._mega_rungs, self.max_batch, oldest / 1e3, now_ms / 1e3))
        self._mega_buf_id = self._mega_queue.checkout(block=False)
        return True

    def _mega_due(self) -> bool:
        """Ship the open window now? At its K target; under `auto` also
        once the oldest slice's slack no longer covers the window's
        estimate."""
        staged = self._mega_staged
        if len(staged) >= self._mega_target:
            return True
        if self._mega_mode == "force":
            return False
        oldest = min((s.oldest_enq_ms for s in staged
                      if s.oldest_enq_ms is not None), default=None)
        if oldest is None:
            return True
        slack_ms = self.sched.config.deadline_ms - (self._now_ms() - oldest)
        return slack_ms <= self.sched.cost.estimate_megastep(
            len(staged), self.max_batch)

    def _stage_mega_slice(self, parts, slot_buf=None, n: Optional[int] = None,
                          oldest_enq_ms: Optional[int] = None) -> None:
        """Encode one launched batch into the open window's next slice.
        Its raw batch is the slice's view of the window's set, held until
        the window completes. Staging is the batch's launch: the
        scheduler counts it, and under `allow` its late rows are posted
        now, charged the whole window's estimate."""
        if n is None:
            n = sum(len(p) for _, p in parts)
        slot = self._pipe.enter(self.pipeline_mode)
        self.chaos.stage("encode")
        t0 = time.monotonic()
        if slot_buf is not None:
            slots = slot_buf[:n]
        else:
            slots = parts[0][1] if len(parts) == 1 else np.concatenate(
                [s for _, s in parts])
        j = len(self._mega_staged)
        overflow = self._encode_mega_slice(slots, self._mega_buf_id, j,
                                           count=True)
        rec = _MegaSlice()
        rec.parts, rec.slots, rec.n = parts, slots, n
        rec.raw = RequestBatch(size=n, arrays=self._mega_queue.slice_view(
            self._mega_buf_id, j, n), overflow=overflow)
        rec.slot_buf, rec.pipe_slot = slot_buf, slot
        rec.epoch = self.ruleset_epoch
        rec.oldest_enq_ms = oldest_enq_ms
        rec.skip_masks = None
        t1 = time.monotonic()
        self._note_stage("decode", "encode", (t1 - t0) * 1e3)
        self._pipe.note_stage(slot, "encode", t0, t1)
        sched = self.sched
        sched.observe_stage_cost("encode", self.max_batch, (t1 - t0) * 1e3)
        sched.note_launch(n, 0)
        self._note_hold(oldest_enq_ms)
        if sched.config.failopen == "allow":
            rec.skip_masks = self._failopen_late_rows(
                parts, self._now_ms(), sched.cost.estimate_megastep(
                    self._mega_target, self.max_batch))
        self._mega_staged.append(rec)

    def _encode_mega_slice(self, slots: np.ndarray, buf_id: int, j: int,
                           count: bool = False,
                           state=None) -> Optional[np.ndarray]:
        """Encode `slots`, padded to `max_batch`, into slice j of set
        `buf_id` (of the served queue, or a built `state`'s): under `on`
        through a staging set, released at once (the slice is a copy;
        under compact staging of the capped views), its bytes counted in
        `staged_bytes` with `count`; the served path's staging error
        demotes the pipeline rung and the slice encodes through the
        one-batch chain. Returns a copy of the rows' depth-overflow
        flags, or None."""
        n = len(slots)
        staging, queue = (self._staging, self._mega_queue) \
            if state is None else (state["staging"], state["mega_queue"])
        if staging is not None and (state is not None
                                    or self.ladder.try_rung("pipeline")):
            staged = staging.checkout(block=False)
            try:
                batch = staging.encode_slots(slots, pad_to=self.max_batch,
                                             into=staged)
                queue.fill_slice(buf_id, j, batch.arrays, n,
                                 self.ruleset_epoch)
                if count:
                    self._count_staged(batch)
                if state is None:
                    self.ladder.note_success("pipeline")
                return None if batch.overflow is None \
                    else batch.overflow[:n].copy()
            except Exception as exc:
                if state is not None:
                    raise
                never_demoted(exc)
                self.ladder.note_failure("pipeline", exc)
            finally:
                staging.release(staged)
        batch = pad_batch(RequestBatch(
            size=n, arrays=bucket_arrays(slots_to_arrays(slots))),
            self.max_batch)
        queue.fill_slice(buf_id, j, batch.arrays, n, self.ruleset_epoch)
        if count:
            self.staged_bytes += _nbytes(batch.arrays)
        return None

    def _k_ship(self, k: int) -> int:
        """The K a window of k slices ships at: the next rung of the
        ladder (so short windows reuse a few graph shapes), at most the
        cap, at least k."""
        k_ship = next((r for r in self._mega_rungs if r >= k), self._mega_k)
        return max(k, min(k_ship, self._mega_k))

    def _launch_megastep(self) -> _MegaWindow:
        """Ship the open window and run it (one graph replay on the
        card), its lanes' and echo's copies to the host queued right
        after; returns the window in flight (`_k_ship` gives its K). A
        window that fails demotes the megastep rung: its slices are
        interpreted at completion."""
        staged, self._mega_staged = self._mega_staged, []
        k = len(staged)
        k_ship = self._k_ship(k)
        self.chaos.stage("dispatch")
        self._dfa_rung.tick(self.plan)
        win = _MegaWindow()
        win.lanes = win.echo = win.aux = None
        t0 = time.monotonic()
        try:
            # Raised before the replay or capture: the CUDA context and
            # any capture stay clean.
            self.chaos.maybe_xla_error(self.batches)
            # The first window of a shape captures its graph (and runs
            # the body once before): the watchdog heartbeats through it.
            with self._hb_busy():
                lanes, _, echo, aux = self._mega_runner.run(
                    self._mega_queue, self._mega_buf_id, k, k_ship)
                win.lanes, win.echo = to_host_async(lanes), to_host_async(echo)
                win.aux = to_host_async(aux)
        except Exception as exc:
            never_demoted(exc)
            self.ladder.note_failure("megastep", exc)
            win.lanes = win.echo = win.aux = None
        t1 = time.monotonic()
        win.slices, win.buf_id, win.t_launch = staged, self._mega_buf_id, t1
        win.k_ship = k_ship
        self._mega_buf_id = None
        self._note_stage("verdict", "device_dispatch", (t1 - t0) * 1e3)
        self._pipe.note_stage(staged[0].pipe_slot, "dispatch", t0, t1)
        self.sched.observe_stage_cost("dispatch", self.max_batch,
                                      (t1 - t0) * 1e3)
        self._pipe.note_megastep(k, self._mega_mode)
        self.mega_windows += 1
        return win

    def _complete_inflight(self, entry) -> None:
        if isinstance(entry, _MegaWindow):
            self._complete_megastep(entry)
        else:
            self._complete(*entry)

    def _complete_megastep(self, win: _MegaWindow) -> None:
        """Every slice's host rules (while the card computes), one wait
        for the window's lanes, then each slice completes as a batch;
        the window's set returns to the queue after its last slice. A
        window whose wait fails demotes the megastep rung, and a window
        without lanes has its slices interpreted."""
        try:
            hosts = [host_rule_lanes(self.plan, s.raw, self.lists)
                     for s in win.slices]
            lanes = echo = aux = None
            t0 = time.monotonic()
            if win.lanes is not None:
                try:
                    with self._hb_busy():
                        lanes = _host_array(win.lanes)
                        echo = _host_array(win.echo)
                        aux = _host_array(win.aux)
                    self._dfa_rung.success()
                    self.ladder.note_success("megastep")
                except Exception as exc:
                    never_demoted(exc)
                    self.ladder.note_failure("megastep", exc)
                    lanes = echo = None
            t_ready = time.monotonic()
            self.device_wait_s += t_ready - t0
            self._stage["device_compute"].observe((t_ready - t0) * 1e3)
            if lanes is not None and self._aux_len:
                # The used slices' aux rows, additive over the window.
                k = len(win.slices)
                self._observe_prefilter(aux[:k].sum(axis=0),
                                        k * self.max_batch)
            self.stage_ms["window"].append((t_ready - win.t_launch) * 1e3)
            self._pipe.note_stage(win.slices[0].pipe_slot, "compute",
                                  win.t_launch, t_ready)
            window_ms = (t_ready - win.t_launch) * 1e3
            # The window's wall teaches the megastep EWMA (keyed by the
            # shipped K) and, per slice, the compute stage's.
            self.sched.observe_stage_cost(
                "compute", self.max_batch, window_ms / max(1, len(win.slices)))
            self.sched.observe_megastep_cost(win.k_ship, self.max_batch,
                                             window_ms)
            for j, s in enumerate(win.slices):
                if echo is not None and int(echo[j]) != s.epoch:
                    self.mega_echo_mismatch += 1
                self._complete(s.parts, s.slots, s.raw, None, win.t_launch,
                               s.slot_buf, None, s.pipe_slot, s.skip_masks,
                               host=hosts[j],
                               dev_lanes=None if lanes is None
                               else lanes[j][:, :s.n])
        finally:
            self._mega_queue.release(win.buf_id)

    def _decode(self, slots: np.ndarray) -> tuple[RequestBatch, RequestBatch]:
        """Slots -> the raw batch and the padded one the lane function
        takes: columns trimmed to a power of two over the batch's longest
        value (the scans walk columns), rows padded to a power of two."""
        n = len(slots)
        raw = RequestBatch(size=n, arrays=slots_to_arrays(slots))
        batch = pad_batch(
            RequestBatch(size=n, arrays=bucket_arrays(raw.arrays)),
            pow2_batch_size(n, self.max_batch))
        batch.staged_bytes = _nbytes(batch.arrays)
        return raw, batch

    def warm_up(self) -> list[tuple[int, int, float]]:
        """Run one batch of every padded row count the drain loop can
        issue (`pow2_batch_size` over 1..max_batch: 8, 16, ..., max_batch)
        through the lane function and wait for it, each at the narrowest
        column bucket and at the slots' full width, with rows cycling
        through WARM_REQUESTS. Call it before a data plane enqueues: the
        first batch of a shape pays one-time costs on the card (the
        first launch of each kernel and library module, the caching
        allocator's growth, cuDNN's algorithm choice for the window
        convolution's shapes, pinned host memory for the results), and
        the httpd fails a request open when its verdict misses the 3 s
        deadline. Under PINGOO_PIPELINE=on the batches go through the
        staging encoder, as the drain loop's do. Under
        PINGOO_MEGASTEP=force the drain loop runs windows only, so the
        warm-up runs windows instead (`_warm_up_megastep`); under auto
        it runs the windows, then the batches. Touches no
        ring and no counter; returns (rows, widest column, ms) of each
        batch or window."""
        return self._warm_state(self._plan_state, hb=True)

    def _warm_state(self, state: dict,
                    hb: bool = False) -> list[tuple[int, int, float]]:
        """`warm_up()`'s batches or windows through a built `state` (the
        served one, or a swap's on its requester's thread). With `hb` the
        waits are declared blocking windows (`_hb_busy`); a requester's
        thread never declares them, since the watchdog would then stamp
        the heartbeat for a drain loop it does not watch."""
        busy = self._hb_busy if hb else contextlib.nullcontext
        out = []
        if state["mega_runner"] is not None:
            out += self._warm_up_megastep(state, busy)
            if self._mega_mode == "force":
                return out
        staging = state["staging"]
        buckets = sorted({pow2_batch_size(1 << k, self.max_batch)
                          for k in range(self.max_batch.bit_length())})
        for rows in buckets:
            for wide in (False, True):
                slots = _warm_slots(rows, wide)
                t0 = time.monotonic()
                staged = None
                if staging is not None:
                    staged = staging.checkout(block=False)
                    batch = staging.encode_slots(slots, pad_to=rows,
                                                 into=staged)
                else:
                    _, batch = self._decode(slots)
                with busy():
                    _host_array(to_host_async(self._issue_lanes(batch,
                                                                state)[0]))
                if staged is not None:
                    staging.release(staged)
                out.append((rows, batch.arrays["url_bytes"].shape[1],
                            (time.monotonic() - t0) * 1e3))
        return out

    def _warm_up_megastep(self, state: dict,
                          busy) -> list[tuple[int, int, float]]:
        """One window of every K the drain loop can ship (`_k_ship` over
        1..the cap), its slices of `max_batch` WARM_REQUESTS rows, at the
        narrowest column bucket and at the slots' full width, each waited
        for: on the card each captures its graph here and not in the
        first live window of its key, whose tickets would wait for the
        capture. The graph runner counts these captures and replays; the
        windows count nowhere else. Returns (rows of the window, widest
        column, ms) of each."""
        queue, runner = state["mega_queue"], state["mega_runner"]
        out = []
        for k in sorted({self._k_ship(k)
                         for k in range(1, self._mega_k + 1)}):
            for wide in (False, True):
                slots = _warm_slots(self.max_batch, wide)
                t0 = time.monotonic()
                buf = queue.checkout(block=False)
                try:
                    for j in range(k):
                        self._encode_mega_slice(slots, buf, j, state=state)
                    width = queue.window_shape(buf, k)["url_bytes"][2]
                    with busy():
                        lanes = runner.run(queue, buf, k, k)[0]
                        _host_array(to_host_async(lanes))
                finally:
                    queue.release(buf)
                out.append((k * self.max_batch, width,
                            (time.monotonic() - t0) * 1e3))
        return out

    def ring_telemetry(self) -> dict:
        """The rings' telemetry blocks together: counters and the wait
        histogram summed, the depth marks maxed."""
        agg = {name: 0 for name in TELEMETRY_FIELDS}
        agg["wait_hist"] = [0] * WAIT_BUCKETS
        for ring in self.rings:
            t = ring.telemetry()
            for name in TELEMETRY_FIELDS:
                agg[name] = max(agg[name], t[name]) \
                    if name in ("depth", "depth_hwm") else agg[name] + t[name]
            agg["wait_hist"] = [a + b for a, b in zip(agg["wait_hist"],
                                                      t["wait_hist"])]
        return agg

    def stats(self) -> dict:
        """The sidecar's counters, beside the httpd's /__pingoo/metrics.
        `device_wait_ms_per_batch` is the mean wait for a batch's lanes
        after the host rules ran."""
        return {
            "processed": self.processed,
            "batches": self.batches,
            "batch_occupancy": round(self.processed / self.batches, 2)
            if self.batches else 0.0,
            "device_wait_ms_per_batch": round(
                1e3 * self.device_wait_s / self.batches, 3)
            if self.batches else 0.0,
            "truncated_rows": self.truncated_rows,
            "spilled_rows": self.spilled_rows,
            "depth_overflow_rows": self.depth_overflow_rows,
            "staging": {"caps": self.stage_caps,
                        "staged_bytes": self.staged_bytes},
            "body_verdicts": self.body_verdicts,
            "rings": len(self.rings),
            "ring_telemetry": self.ring_telemetry(),
            "pipeline": self._pipe.snapshot(),
            "megastep": {
                "mode": self._mega_mode,
                "k_cap": self._mega_k,
                "windows": self.mega_windows,
                "echo_mismatch": self.mega_echo_mismatch,
                "graphs": (self._mega_runner.snapshot()
                           if self._mega_runner is not None else None),
            },
            "supervision": {"epoch": self.epoch,
                            "reconciled": dict(self.reconciled)},
            "sched": {**self.sched.snapshot(),
                      "held_passes": self.held_passes},
            "ladder": self.ladder.snapshot(),
            "chaos": self.chaos.snapshot(),
            "hotswap": {"epoch": self.ruleset_epoch, "tenant": self.tenant,
                        "swaps": swap_counts("sidecar"),
                        "pauses_ms": list(self.swap_pauses_ms)},
        }

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

    def _complete(self, parts, slots, raw, dev, t_issued: float,
                  slot_buf=None, staged=None, pipe_slot: int = 0,
                  skip_masks=None, t_disp: Optional[float] = None,
                  host=None, dev_lanes=None, aux=None) -> None:
        """Finish one batch: host rules, the wait for its own lanes,
        routes, spill rows and the posts (a megastep slice comes with its
        host and device lanes already on the host). Its slot buffer and
        staging set then return to their pools and it leaves the
        pipeline; then the chaos injector's kill and pause triggers."""
        try:
            self._finish(parts, slots, raw, dev, t_issued, pipe_slot,
                         skip_masks, t_disp, host, dev_lanes, aux)
        finally:
            if slot_buf is not None:
                self._slot_pool.append(slot_buf)
            if staged is not None:
                self._staging.release(staged)
            self._pipe.exit()
        self.chaos.on_batch_done(self.batches)

    def _finish(self, parts, slots, raw, dev, t_issued: float,
                pipe_slot: int, skip_masks=None, t_disp=None, host=None,
                dev_lanes=None, aux=None) -> None:
        t_start = t_ready = time.monotonic()
        n = len(slots)
        if host is None:
            # Host rules run while the device is still computing.
            host = host_rule_lanes(self.plan, raw, self.lists)
        if dev is not None:
            t0 = time.monotonic()
            try:
                with self._hb_busy():
                    dev_lanes = _host_array(dev)[:, :n]
                    if aux is not None:
                        # Its copy was queued behind the lanes'.
                        aux = _host_array(aux)
                self._dfa_rung.success()
            except Exception as exc:
                never_demoted(exc)
                # A device error surfaces at the wait as well.
                self._dfa_rung.failure(self.plan, exc)
                aux = None
            t_ready = time.monotonic()
            self.device_wait_s += t_ready - t0
            self._stage["device_compute"].observe((t_ready - t0) * 1e3)
            if aux is not None:
                self._observe_prefilter(aux, self.max_batch)
            # The compute window: end of issue to the lanes on the host.
            self._pipe.note_stage(pipe_slot, "compute", t_issued, t_ready)
            self.sched.observe_stage_cost("compute", self.max_batch,
                                          (t_ready - t_issued) * 1e3)
            if t_disp is not None:
                self.sched.observe_cost(self.max_batch,
                                        (t_ready - t_disp) * 1e3)
        self._observe_dfa()
        self.chaos.stage("resolve")
        self.batches += 1
        interpreted = dev_lanes is None
        if interpreted:
            # The ladder's device fallback: the interpreter serves the
            # whole batch (routes included), as the device would.
            with self._hb_busy():
                unverified, verified_block, route = self._interpret_batch(
                    parts, raw)
        else:
            unverified, verified_block = merge_lanes(dev_lanes, host)
            route = None
        # Rows the producer flagged as truncated (a field past its slot
        # cap) were matched on the slot view; spilled ones are served
        # exactly below.
        self.truncated_rows += int(
            ((slots["flags"] & SLOT_FLAG_TRUNCATED) != 0).sum())
        # Each ring's rows read their group's route lane (rows 3..3+G);
        # rows of a ring with no group keep route 0.
        if self._groups and not interpreted:
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
        # Rows past a compact cap clamped below the plan's required depth
        # (PINGOO_STAGING_DEPTH): the device saw a prefix too short for
        # some scanner, so every lane of such a row is served from its
        # full slot bytes by the interpreter. Spilled rows were served
        # above; with unclamped caps no row is flagged.
        over = raw.overflow
        if over is not None and over[:n].any():
            off = 0
            for ring, part in parts:
                gi = self._ring_group_of.get(id(ring))
                svcs = self._groups[gi] if gi is not None else None
                m = len(part)
                for j in np.nonzero(over[off:off + m]
                                    & (part["spill_idx"] == SPILL_NONE))[0]:
                    s = part[j]
                    unv, vblk, rt = self._interpret_overflow_row(
                        s, bytes(s["url"][:int(s["url_len"])]),
                        bytes(s["path"][:int(s["path_len"])]), svcs)
                    unverified[off + j] = unv
                    verified_block[off + j] = vblk
                    if route is not None and gi is not None:
                        route[off + j] = rt
                    self.depth_overflow_rows += 1
                off += m
        actions = unverified | (verified_block.astype(np.int32) << 2)
        if route is not None:
            actions = actions | (np.minimum(route, 31).astype(np.int32) << 3)
        acts = actions.astype(np.uint8)
        off = 0
        for pi, (ring, part) in enumerate(parts):  # scatter per ring
            m = len(part)
            keep = None if skip_masks is None or skip_masks[pi].all() \
                else skip_masks[pi]
            # Rows failed open at launch were posted then, once.
            tickets = np.ascontiguousarray(
                part["ticket"] if keep is None else part["ticket"][keep],
                dtype=np.uint64)
            pacts = np.ascontiguousarray(
                acts[off:off + m] if keep is None else acts[off:off + m][keep])
            if not self._post_all(ring, tickets, pacts):
                return
            ring.record_waits(part["enq_ms"] if keep is None
                              else part["enq_ms"][keep])
            # Parts complete in FIFO order, so the posted tickets form a
            # prefix: a reattaching sidecar's orphan scan starts here.
            ring.set_posted_floor(int(part["ticket"].max()) + 1)
            off += m
        # Posts later than the deadline, on the ring's clock, are misses.
        self.sched.note_misses(int(
            ((self._now_ms() - slots["enq_ms"].astype(np.int64))
             > self.sched.config.deadline_ms).sum()))
        self.processed += n
        t_end = time.monotonic()
        self._pipe.note_stage(pipe_slot, "resolve", t_ready, t_end)
        self._stage["resolve"].observe((t_end - t_ready) * 1e3)
        self.stage_ms["finish"].append((t_end - t_start) * 1e3)

    def _interpret_batch(self, parts, raw):
        """The device rung's fallback: (unverified, verified_block,
        route or None) of the whole batch through the host interpreter,
        the oracle the device path is held to; each ring's rows route by
        its own service order."""
        contexts = batch_to_contexts(raw, self.lists)
        if contexts:
            rows = np.stack([interpret_rules_row(self.plan, c)
                             for c in contexts])
        else:
            rows = np.zeros((0, len(self.plan.rules)), dtype=bool)
        unv, vblk = action_lanes(self.plan, rows)
        route = None
        if self._groups:
            route = np.full(len(contexts), int(LANE_NONE), dtype=np.int64)
            off = 0
            for ring, part in parts:
                gi = self._ring_group_of.get(id(ring))
                if gi is not None:
                    svcs = self._groups[gi]
                    for i in range(off, off + len(part)):
                        for order, name in enumerate(svcs):
                            ridx = self.plan.route_index.get(name)
                            if ridx is None or rows[i, ridx]:
                                route[i] = order
                                break
                off += len(part)
        return (np.asarray(unv, dtype=np.int32),
                np.asarray(vblk, dtype=bool), route)

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
                self._reattach_counters[kind].inc()
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
        rings, which the loop may be inside. The registry's collector is
        detached first, so that no scrape reads a ring the caller unmaps
        next, and the cost model is saved to the durable cost ledger
        last (PINGOO_COST_LEDGER)."""
        self._collector_live = False
        self._registry.unregister_collector(self._export_ring_telemetry)
        if self.body_scanner is not None:
            self.body_scanner.detach_metrics()
        self._stop = True
        for t in (self._thread, self._hb_watchdog):
            if t is not None and t.is_alive() \
                    and t is not threading.current_thread():
                t.join(timeout=join_timeout_s)
        # The durable cost ledger: this run's costs for the next boot,
        # saved once the loop no longer updates them (an unwritable file
        # makes it return False).
        save_cost_ledger(self.sched.cost, backend=self._backend_label,
                         fingerprint=self._plan_fp, plane="sidecar")


# -- the services table -------------------------------------------------------
# The httpd routes each allowed request by its verdict's route bits to a
# service of this table (httpd.cc's ServiceTable), which it reloads when
# the file's mtime changes.


class _TableMarker(str):
    """A marker of a services-table upstream entry, recognised only by
    `isinstance` and identity: a hostname from the config that equals a
    marker's text is never taken for one (`_append_tls` raises and asks
    for the explicit (ip, port, "tls", name) form instead)."""

    __slots__ = ()


# The loopback control plane: the httpd sends its per-boot internal token
# on hops to it, which lets the Python listener trust the x-forwarded-for.
INTERNAL = _TableMarker("internal")
# A cleartext prior-knowledge HTTP/2 upstream (scheme h2://): the httpd
# frames requests over an nghttp2 client session instead of HTTP/1.1.
H2 = _TableMarker("h2-prior-knowledge")


def _append_tls(lines: list, ip, port, sni, explicit: bool = False) -> None:
    if not sni or len(sni) > 255 or any(ch.isspace() for ch in sni):
        # 255 is the reader's %255s scan width: a longer name would be
        # cut into one no certificate can verify.
        raise ValueError(f"bad tls server name {sni!r}")
    if not explicit and sni in (INTERNAL, H2):
        # In the 3-tuple form a server name equal to a marker's text is
        # ambiguous: retagging the hop would leak the internal token or
        # downgrade TLS to cleartext h2.
        raise ValueError(
            f"tls server name {sni!r} collides with a table marker; "
            f"use the (ip, port, 'tls', name) entry form")
    lines.append(f"upstream {ip} {port} tls {sni}")


def write_services_file(path: str, services: list) -> None:
    """Publish a listener's routing table. `services` is its ordered
    [(name, [upstream, ...])], or (name, upstreams, static_root) for a
    static site (the httpd serves its files of up to 500 KB and proxies
    larger ones to the upstreams). An upstream is (ip, port) in the
    clear, (ip, port, server_name) or (ip, port, "tls", server_name) for
    a verified TLS hop, (ip, port, H2) for prior-knowledge h2, or
    (ip, port, INTERNAL) for the loopback control plane. At most 31
    services (the route field's 5 bits, 31 meaning none). Written to a
    temporary file and renamed, so the reader never sees a partial
    table."""
    if len(services) > 31:
        raise ValueError(
            f"native routing supports at most 31 services (5-bit route "
            f"field, 31 = no match), got {len(services)}")
    lines = ["pingoo-services v1"]
    for order, entry in enumerate(services):
        name, ups = entry[0], entry[1]
        static_root = entry[2] if len(entry) > 2 else None
        lines.append(f"service {order} {name}")
        if static_root is not None:
            if (not static_root or len(static_root) > 383
                    or any(ch.isspace() for ch in static_root)):
                # %383s scan width; whitespace would split the token.
                raise ValueError(f"bad static root {static_root!r}")
            lines.append(f"static {static_root}")
        for up in ups:
            if len(up) == 2:
                lines.append(f"upstream {up[0]} {up[1]}")
            elif len(up) == 4 and up[2] == "tls":
                _append_tls(lines, up[0], up[1], up[3], explicit=True)
            elif isinstance(up[2], _TableMarker) and up[2] is INTERNAL:
                lines.append(f"upstream {up[0]} {up[1]} internal")
            elif isinstance(up[2], _TableMarker) and up[2] is H2:
                lines.append(f"upstream {up[0]} {up[1]} h2")
            else:
                _append_tls(lines, up[0], up[1], up[2])
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


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
