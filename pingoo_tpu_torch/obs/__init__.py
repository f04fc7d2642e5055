"""Telemetry of the port: the metric registry and its Prometheus/JSON
exposition, the shared metric inventory, trace ids, the sampled access
log and the bounded timing windows (`obs.window`).

    from pingoo_tpu_torch.obs import REGISTRY, get_registry
    from pingoo_tpu_torch.obs.trace import new_trace_id, AccessLogSampler
    from pingoo_tpu_torch.obs import schema

The compile and cost ledgers, provenance, parity sampling, the flight
recorder and the timeline are not ported yet (ROADMAP.md, port queue
item 10, slices 2 and 3).
"""

from .registry import (  # noqa: F401
    LATENCY_BUCKETS_MS,
    WAIT_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    REGISTRY,
    get_registry,
)
from . import schema  # noqa: F401
