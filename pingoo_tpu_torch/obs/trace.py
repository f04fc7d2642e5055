"""Trace ids + sampled structured access logging.

Every request gets a 16-hex-char trace id at the edge. On the Python
plane it is generated in HttpListener.handle_request, rides the
RequestTuple through the batch (so engine-side logging can correlate),
returns in the `x-pingoo-trace-id` response header, and lands in the
sampled JSON access log. On the native plane the ring TICKET is the
correlation id: the C++ httpd echoes `x-pingoo-trace-id:
t-<ring ticket>` so a response can be joined against sidecar-side
telemetry without a new slot field.

Sampling: PINGOO_ACCESS_LOG_SAMPLE = N logs every Nth request per
listener (1 = every request, 0 = disabled). Default 128 — cheap enough
to leave on, dense enough to carry real latency evidence.
"""

from __future__ import annotations

import itertools
import os
import secrets
import time
import zlib

from ..logging_utils import get_logger

TRACE_HEADER = "x-pingoo-trace-id"

_counter = itertools.count()
_prefix = None


def new_trace_id() -> str:
    """16 hex chars: 8 random per-process prefix + 8 sequence. Unique
    across restarts and across co-resident listeners, no per-request
    entropy syscall."""
    global _prefix
    if _prefix is None:
        _prefix = secrets.token_hex(4)
    return f"{_prefix}{next(_counter) & 0xFFFFFFFF:08x}"


def tuple_digest(method: str, host: str, path: str, url: str,
                 user_agent: str, ip: str) -> str:
    """Stable 8-hex digest of the verdict-relevant request fields (the
    JAX package keeps it in obs/flightrecorder.py). crc32, not a
    cryptographic hash: a correlation key for joining an explain payload
    against logs and replays."""
    raw = "\x00".join((method, host, path, url, user_agent, ip))
    return f"{zlib.crc32(raw.encode('latin-1', 'replace')) & 0xFFFFFFFF:08x}"


def access_log_sample_every() -> int:
    try:
        return max(0, int(os.environ.get("PINGOO_ACCESS_LOG_SAMPLE", "128")))
    except ValueError:
        return 128


class AccessLogSampler:
    """Every-Nth sampler emitting one structured access-log line with
    the request's trace id (logging_utils JSON shape)."""

    def __init__(self, listener: str, sample_every: int | None = None):
        self.listener = listener
        self.sample_every = (access_log_sample_every()
                             if sample_every is None else sample_every)
        self._seen = 0
        self._log = get_logger("pingoo_tpu.access")

    def maybe_log(self, *, trace_id: str, method: str, path: str,
                  status: int, client_ip: str, duration_ms: float,
                  **extra) -> bool:
        if self.sample_every <= 0:
            return False
        self._seen += 1
        if self._seen % self.sample_every:
            return False
        fields = {
            "trace_id": trace_id,
            "listener": self.listener,
            "method": method,
            "path": path,
            "status": status,
            "client_ip": client_ip,
            "duration_ms": round(duration_ms, 3),
            "sampled_1_in": self.sample_every,
            "ts": round(time.time(), 3),
        }
        fields.update(extra)
        self._log.info("access", extra={"fields": fields})
        return True
