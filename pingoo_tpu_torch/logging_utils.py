"""Structured JSON logging to stderr.

Reference parity (pingoo/main.rs:34-44): tracing-subscriber JSON output,
flattened event fields, level from the PINGOO_LOG env var (default
info). Python logging is adapted to the same shape:
  {"timestamp": ..., "level": "INFO",
   "target": "pingoo_tpu_torch.host.discovery", "message": ..., **fields}
Use `log = get_logger(__name__); log.info("msg", extra={"fields": {...}})`.

The sampled access log (obs/trace.AccessLogSampler) emits through the
same pipeline under the `pingoo_tpu.access` target (the JAX package's
own, so a log pipeline reads both packages' access lines alike): one
line per sampled request with `trace_id`, method/path/status, client_ip
and duration_ms — the trace id matches the response's x-pingoo-trace-id
header, so a slow response in hand joins directly against the log.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if isinstance(fields, dict):
            payload.update(fields)
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        # default=repr: a non-JSON-safe field value (Path, bytes, an
        # exception object in access-log extras) must degrade to its
        # repr, never take down the logging pipeline mid-request.
        return json.dumps(payload, default=repr)


def init_logging(level: str | None = None) -> None:
    level_name = (level or os.environ.get("PINGOO_LOG", "info")).upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, level_name, logging.INFO))


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
