"""The documented metric inventory: the parity contract between the
three telemetry surfaces (Python listener, native httpd, ring sidecar).

The port's copy of the JAX package's `obs/schema.py`, whole, including
the families that later slices of the port fill (provenance, parity,
the compile and cost ledgers, the timeline): every dict here equals the
JAX package's (tests/test_torch_metrics_parity.py). Both planes export
the SAME metric names for shared concepts, so a divergence (say native
`requests` minus sidecar `processed`) is one subtraction on one scrape,
not a join across incompatible schemas. tests/test_torch_obs.py holds
the port's expositions and sources to this inventory.
"""

from __future__ import annotations

# Metric names every plane that handles requests must expose (with a
# `plane` label distinguishing the source: python | native).
SHARED_METRICS = {
    "pingoo_requests_total": "requests entering the WAF hot path",
    "pingoo_blocked_total": "requests answered 403 by a verdict",
    "pingoo_captcha_total": "captcha challenges served/redirected",
    "pingoo_fail_open_total":
        "requests released without a verdict (ring full, verdict "
        "deadline, engine error)",
}

# Shared verdict-wait histogram: identical bucket upper bounds (ms) on
# every surface. Native plane: enqueue -> verdict-apply wall time
# (httpd.cc record_wait). Python plane: evaluate() -> resolve wall time
# (the pre-registry `verdict_ms`). Ring telemetry block: enqueue ->
# verdict-post (pingoo_ring.cc record_waits).
SHARED_WAIT_HISTOGRAM = "pingoo_verdict_wait_ms"
SHARED_WAIT_BUCKETS_MS = (1, 2, 5, 10, 50, 100, 1000)

# Python-plane verdict pipeline stages, in hot-path order
# (engine/service.py): each is a pingoo_verdict_stage_ms{stage=...}
# histogram.
VERDICT_STAGES = (
    "queue_wait",      # evaluate() enqueue -> collector pop
    "batch_assembly",  # PER-REQUEST admit -> batch launch (stamped from each
                       # request's own admit timestamp, not the
                       # batch's first pop)
    "sched",           # scheduler hold: first admit -> launch decision
    "encode",          # RequestTuple list -> fixed-shape arrays
    "prefilter",       # Stage-A factor pass dispatch (async)
    "device_dispatch", # jitted call issue (async) incl. host->device
    "device_compute",  # block_until_ready on the device result
    "resolve",         # lanes/actions + future resolution
    "provenance",      # attribution fold + flight record + parity submit
)

# Literal-prefilter cascade metrics (docs/PREFILTER.md): exported by
# every plane that runs the batched verdict engine — the Python
# listener plane (engine/service.py, plane="python") and the ring
# sidecar serving the native plane (native_ring.py, plane="sidecar").
# The "prefilter" entry in VERDICT_STAGES above is the matching
# prefilter_ms stage histogram.
PREFILTER_METRICS = {
    "pingoo_prefilter_candidate_rate":
        "fraction of request x gated-NFA-bank pairs the literal "
        "prefilter left as candidates in the last batch",
    "pingoo_scan_banks_skipped_total":
        "NFA bank scans skipped because no request in the batch held "
        "any of the bank's necessary literal factors",
}

# Bitsplit-DFA lowering metrics (docs/DFA.md): exported by
# every plane that runs the batched verdict engine (plane="python"
# listener service, plane="sidecar" ring drainer). Both are host-static
# per plan+env — counted once per batch from the plan's scan_plans and
# the resolved PINGOO_DFA mode (engine/verdict.dfa_dispatch_counts),
# not from device results. `pingoo_dfa_banks_total` carries a `mode`
# label (auto | force) naming how the dispatch was selected.
DFA_METRICS = {
    "pingoo_dfa_banks_total":
        "NFA bank evaluations dispatched to a lowered bitsplit DFA "
        "(mode label: auto = cost-model selected, force = env pinned)",
    "pingoo_dfa_recheck_total":
        "DFA bank dispatches that took the approximate-lowering path "
        "(merged states) and rechecked candidate rows through the "
        "exact NFA bank",
}

# Verdict-provenance metrics (docs/OBSERVABILITY.md
# Provenance/Parity sections): exported by every plane that runs the
# batched verdict engine (plane="python" listener service,
# plane="sidecar" ring drainer). Per-rule families carry a `rule` label
# bounded to the top-K hitters (PINGOO_ATTR_TOP_K) plus one "_overflow"
# series so a 500-rule plan cannot blow up Prometheus cardinality;
# per-bank families carry a `bank` label (one per gated scan bank — at
# most a handful per ruleset by construction).
PROVENANCE_METRICS = {
    "pingoo_rule_hits_total":
        "requests matching each rule (top-K labelled series + the "
        "\"_overflow\" remainder bucket)",
    "pingoo_prefilter_bank_candidate_rate":
        "fraction of the last batch's rows Stage A left as candidates "
        "for this gated scan bank",
    "pingoo_scan_bank_skipped_total":
        "batches in which this gated scan bank was skipped entirely",
    "pingoo_flightrecorder_records_total":
        "requests written into the in-memory flight-recorder ring",
}

# Shadow-parity auditor metrics : the always-on sampler that
# re-evaluates PINGOO_PARITY_SAMPLE of live batches through the host
# expression interpreter off the hot path and diffs the verdicts.
PARITY_METRICS = {
    "pingoo_parity_checked_total":
        "requests re-evaluated by the shadow-parity auditor",
    "pingoo_parity_mismatch_total":
        "audited requests whose device verdict diverged from the host "
        "interpreter",
    "pingoo_parity_rule_mismatch_total":
        "per-rule breakdown of parity divergences (bounded rule label "
        "+ \"_overflow\")",
    "pingoo_parity_dropped_total":
        "sampled batches dropped because the audit queue was full",
}

# Overlapped-executor pipeline metrics (docs/EXECUTOR.md):
# exported by every plane that runs the batched verdict engine
# (plane="python" listener service, plane="sidecar" ring drainer). The
# instrument bundle lives in obs/pipeline.PipelineStats — both planes
# construct one at boot, which is what makes the pingoo_pipeline_*
# series exist under both plane labels. `stage_occupancy` carries a
# `stage` label over obs/pipeline.PIPELINE_EXEC_STAGES;
# `batches_total` carries a `mode` label (on = staged overlap,
# off = legacy lockstep — the PINGOO_PIPELINE A/B arms).
PIPELINE_METRICS = {
    "pingoo_pipeline_inflight":
        "batches currently in flight in the overlapped executor "
        "(bounded by PINGOO_PIPELINE_DEPTH)",
    "pingoo_pipeline_depth":
        "configured executor in-flight bound (PINGOO_PIPELINE_DEPTH)",
    "pingoo_pipeline_stage_occupancy":
        "fraction of wall time this executor stage has been busy "
        "since boot (stages summing past 1.0 prove overlap)",
    "pingoo_pipeline_overlap_ratio":
        "EWMA fraction of each batch's device-compute window that a "
        "different in-flight batch spent in host-side encode/dispatch",
    "pingoo_pipeline_batches_total":
        "batches served by the executor, split by mode (on = staged "
        "overlap, off = legacy lockstep)",
    # Device-resident megastep (docs/EXECUTOR.md
    # "Device-resident loop"): one jitted lax.scan dispatch covering K
    # batch slices. `batches_total` carries a `mode` label over the
    # PINGOO_MEGASTEP arms that actually launch (auto / force).
    "pingoo_megastep_k":
        "K of the most recently launched megastep window (batch "
        "slices per device dispatch)",
    "pingoo_megastep_batches_total":
        "batch slices served device-resident, split by PINGOO_MEGASTEP "
        "mode (auto = backlog-engaged, force = pinned)",
    "pingoo_megastep_amortization":
        "EWMA batch slices amortized per device dispatch (1.0 = "
        "per-batch dispatch, K = fully amortized megastep windows)",
}

# Continuous-batching scheduler + serving-mesh metrics
# (docs/SCHEDULER.md): exported by every plane that runs the batched
# verdict engine (plane="python" listener service, plane="sidecar"
# ring drainer). `pingoo_sched_batch_size` is a histogram over the
# pow2 launch-size ladder (sched/scheduler.BATCH_SIZE_BUCKETS); the
# rest are counters/gauges. The matching `sched` entry in
# VERDICT_STAGES above is the scheduler's hold-time stage histogram.
SCHED_METRICS = {
    "pingoo_sched_queue_depth":
        "requests waiting in the admission queue at the last launch",
    "pingoo_sched_batch_size":
        "per-launch batch occupancy (histogram over the pow2 ladder)",
    "pingoo_sched_deadline_miss_total":
        "requests resolved after their PINGOO_DEADLINE_MS budget",
    "pingoo_sched_failopen_total":
        "requests failed open by the scheduler because their deadline "
        "was unmeetable (PINGOO_SCHED_FAILOPEN policy)",
    "pingoo_mesh_devices":
        "devices in this plane's serving mesh (dp*tp*sp; 1 = "
        "single-device)",
}

# Ring telemetry block metrics (source: the shm header's atomic
# telemetry block, pingoo_ring.h PingooRingTelemetry), exported by BOTH
# the native httpd (it maps the ring) and the sidecar drainer (so the
# Python control-plane scrape carries native-plane queue state).
RING_METRICS = {
    "pingoo_ring_enqueued_total": "request slots enqueued",
    "pingoo_ring_dequeued_total": "request slots dequeued",
    "pingoo_ring_enqueue_full_total":
        "enqueue attempts refused because the request ring was full",
    "pingoo_ring_verdicts_posted_total": "verdict slots posted",
    "pingoo_ring_verdict_post_full_total":
        "verdict posts that hit a full verdict ring (retried)",
    "pingoo_ring_depth": "request slots currently queued",
    "pingoo_ring_depth_hwm": "high-water mark of queued request slots",
}

# Sidecar supervision + degradation-ladder metrics
# (docs/RESILIENCE.md). The liveness trio (sidecar_up / degraded_mode /
# sidecar_epoch) is exported by BOTH planes from the same ring-header
# liveness block (v5): the native httpd reads it to decide the
# degraded fast-path, the sidecar writes it. pingoo_degrade_total is
# the ladder's per-rung demotion counter (engine/ladder.py), exported
# wherever a ladder runs (plane="python" and plane="sidecar");
# reattach/chaos counters are sidecar-plane.
RESILIENCE_METRICS = {
    "pingoo_sidecar_up":
        "1 while a sidecar heartbeat is fresh (0 before any sidecar "
        "ever attached AND while degraded — both alert the same way)",
    "pingoo_degraded_mode":
        "1 while the native plane bypasses the ring (stale heartbeat "
        "past PINGOO_SIDECAR_TIMEOUT_MS): every request fails open",
    "pingoo_sidecar_epoch":
        "monotonic sidecar attach count from the ring header (a bump "
        "= a sidecar restart; reconciliation ran)",
    "pingoo_degraded_entered_total":
        "degraded-mode entries (each one failed every awaiting ticket "
        "open at once)",
    "pingoo_reattach_reconciled_total":
        "tickets a restarting sidecar reconciled from the dead epoch, "
        "by action (reeval = slot bytes intact, re-evaluated; "
        "failopen = bytes recycled, allow posted)",
    "pingoo_degrade_total":
        "degradation-ladder demotions by rung (pipeline|megastep|dfa|"
        "mesh|device|body; engine/ladder.py)",
    "pingoo_chaos_injected_total":
        "faults injected by the PINGOO_CHAOS harness, by fault "
        "(obs/chaos.py; absent in production)",
}

# Ruleset hot-swap + differential-fuzzer metrics
# (docs/RESILIENCE.md Hot-swap section / docs/FUZZING.md). The epoch
# gauge and swap counter are exported by every plane that runs the
# batched verdict engine (plane="python" listener service,
# plane="sidecar" ring drainer): the epoch is the count of plan swaps
# this plane has applied (0 = the boot plan; every verdict is
# attributable to exactly one epoch), and the swap counter carries
# {tenant, result} labels (result: ok | rejected). The fuzz counter is
# emitted by the differential fuzzer (tools/analyze/fuzz.py) when a
# run's registry is scraped — absent in production serving.
HOTSWAP_METRICS = {
    "pingoo_ruleset_epoch":
        "ruleset plan epoch on this plane (bumps once per applied "
        "hot-swap; in-flight batches always finish on their epoch)",
    "pingoo_ruleset_swap_total":
        "ruleset hot-swap attempts by {tenant, result} (ok = flipped "
        "at a batch boundary, rejected = build/validation failed)",
    "pingoo_fuzz_discrepancy_total":
        "differential-fuzzer parse discrepancies by class (not a "
        "documented known-delta; tools/analyze/fuzz.py)",
}

# Streaming body-inspection metrics (docs/BODY_STREAMING.md
# / docs/OBSERVABILITY.md). Exported by BOTH planes when
# PINGOO_BODY_INSPECT=on: the sidecar (plane="sidecar") runs the
# windowed scanner over ring body slots, the Python listener
# (plane="python") over its buffered bodies, and the native httpd
# (plane="native") counts the producer side — windows enqueued, flows
# failed open, h2 streams skipped.
BODY_METRICS = {
    "pingoo_body_windows_total":
        "body windows scanned (sidecar/python) or enqueued (native)",
    "pingoo_body_flows_active":
        "flows with live carry-over state in the scanner table",
    "pingoo_body_carry_depth":
        "windows a finished flow's verdict waited for, i.e. carry-over "
        "chain length (histogram)",
    "pingoo_body_bytes_total": "body payload bytes scanned",
    "pingoo_body_degrade_total":
        "flows degraded to metadata-only verdicts, by reason (evict = "
        "state-table pressure, ttl = stalled flow reaped, gap = window "
        "sequence gap, abort = client reset, ring_full = body ring "
        "back-pressure, ladder = body rung demoted, h2 = native h2 "
        "stream not inspected this PR)",
}

# Compact-staging metrics (docs/EXECUTOR.md "Compact
# staging"). Exported by every plane that runs the batched verdict
# engine (plane="python" listener service, plane="sidecar" ring
# drainer). `staged_bytes_total` carries a `mode` label over the
# PINGOO_STAGING arms (full = per-field staging, compact = packed
# one-copy buffer) so the bytes-per-request reduction is one division
# on one scrape; `staging_field_cap` is host-static per adopted plan —
# the plan-derived per-field staging width (equal to the field spec
# under PINGOO_STAGING=full or when the ruleset pins the field).
STAGING_METRICS = {
    "pingoo_staged_bytes_total":
        "request bytes staged to the device for verdict batches, by "
        "mode (full = per-field arrays, compact = packed buffer)",
    "pingoo_staging_field_cap":
        "per-field staging width in bytes under the adopted plan "
        "(plan-derived cap, quantized to the pow2 rung ladder)",
}

# Perf ledger + cross-plane timeline + durable cost ledger
# (docs/OBSERVABILITY.md "Compile ledger"/"Timeline"/"Cost ledger").
# Exported by every plane that runs the batched verdict engine
# (plane="python" listener service, plane="sidecar" ring drainer).
# `pingoo_compile_total` carries {plane, fn, kind} — fn over
# obs/perf.COMPILE_FN_KINDS (verdict|lanes|prefilter|megastep|score;
# the packed-staging twins report under the same fn label), kind
# cold|warm (warm = a retrace under live traffic, the recompile-storm
# alert series); `pingoo_compile_ms` is a {plane, fn} histogram over
# obs/perf.COMPILE_BUCKETS_MS. `pingoo_timeline_spans_total{plane}`
# counts spans the sampler actually recorded (plane also takes the
# value "native" for ring-wait spans stamped from native enqueue
# clocks). `pingoo_costmodel_reload_total{plane, result}` counts boot
# reload attempts of the durable cost ledger (result: ok | stale |
# missing | error).
PERF_METRICS = {
    "pingoo_compile_total":
        "XLA trace/compile events observed by the compile ledger, by "
        "{fn, kind} (cold = a wrapper's first compile, warm = a later "
        "retrace — the recompile-storm signal)",
    "pingoo_compile_ms":
        "wall time of observed XLA trace/compile events (histogram "
        "per {plane, fn})",
    "pingoo_timeline_spans_total":
        "spans recorded by the cross-plane timeline sampler "
        "(PINGOO_TIMELINE_SAMPLE-gated; bounded in-memory ring)",
    "pingoo_costmodel_reload_total":
        "durable cost-ledger reload attempts at boot, by result (ok = "
        "EWMAs restored, stale = fingerprint/version mismatch "
        "discarded, missing = no snapshot for this backend+plane, "
        "error = unreadable file)",
    "pingoo_compile_unexpected_total":
        "compile events OUTSIDE the statically-proved admissible "
        "surface (COMPILE_SURFACE.json via PINGOO_COMPILE_SURFACE), by "
        "{plane, fn} — any nonzero value means an unquantized shape "
        "axis reached a jitted dispatch; fails make timeline-smoke",
}

# Native-plane-only counters (httpd.cc Stats), exported with
# plane="native" under these names.
NATIVE_METRICS = {
    "pingoo_ua_rejected_total": "empty/oversized UA pre-ring 403s",
    "pingoo_no_service_total": "route bits said no service (404)",
    "pingoo_upstream_fail_total": "upstream connect/response failures (502)",
    "pingoo_upstream_tls_fail_total":
        "upstream TLS handshake/verify failures",
    "pingoo_verdicts_total": "verdict bytes applied",
    "pingoo_connections": "open client connections",
    "pingoo_pooled_upstreams": "idle pooled upstream connections",
}

# JSON back-compat keys (the pre-registry schemas, still served under
# Accept: application/json). Maps JSON key -> metric name, per plane.
PYTHON_JSON_KEYS = {
    "requests": "pingoo_requests_total",
    "blocked": "pingoo_blocked_total",
    "captcha_served": "pingoo_captcha_total",
}
NATIVE_JSON_KEYS = {
    "requests": "pingoo_requests_total",
    "blocked": "pingoo_blocked_total",
    "captcha": "pingoo_captcha_total",
    "fail_open": "pingoo_fail_open_total",
    "verdict_wait_ms_hist": "pingoo_verdict_wait_ms",
}


def all_metric_names() -> set[str]:
    return (set(SHARED_METRICS) | set(RING_METRICS) | set(NATIVE_METRICS)
            | set(PREFILTER_METRICS) | set(DFA_METRICS)
            | set(PROVENANCE_METRICS)
            | set(PARITY_METRICS) | set(SCHED_METRICS)
            | set(PIPELINE_METRICS) | set(RESILIENCE_METRICS)
            | set(HOTSWAP_METRICS) | set(BODY_METRICS)
            | set(STAGING_METRICS) | set(PERF_METRICS)
            | {SHARED_WAIT_HISTOGRAM, "pingoo_verdict_stage_ms"})
