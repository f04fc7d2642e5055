"""Telemetry of the port: trace ids, the sampled access log and the
bounded timing windows (`obs.window`).

    from pingoo_tpu_torch.obs.trace import new_trace_id, AccessLogSampler

The JAX package's metric registry, its Prometheus exposition and the
shared metric inventory are not ported yet (ROADMAP.md, port queue item
10); the listener registers nothing until they are.
"""
