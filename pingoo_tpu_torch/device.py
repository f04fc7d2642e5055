"""Device resolution and the environment knobs this port refuses.

Entry points run on the CUDA card unless the caller asks for the CPU:
`resolve_device(None)` is `cuda` and raises when there is no card, so a
program meant for the card never carries on quietly on the CPU. Tests
pass `device="cpu"`, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import os

import torch


def _pipeline_depth_above_1(v: str) -> bool:
    try:
        return int(v) > 1
    except ValueError:  # the JAX package fails on such a value too
        return v != ""


# Knobs of the JAX package whose features the port does not have yet:
# (variable, predicate on its value, the ROADMAP.md port-queue item).
# Three knobs of the JAX package are not here: PINGOO_NFA_LOOKUP,
# PINGOO_DFA_KERNEL and PINGOO_PREFILTER_KERNEL choose among its JAX
# backends (lax.scan lookups, Pallas or XLA) and mean nothing in the
# port, whose only device route is its CUDA kernels.
_UNPORTED = (
    # Any value the JAX package reads as "on" (its default there); the
    # port always runs one batch at a time, which is its "off".
    ("PINGOO_PIPELINE", lambda v: v.strip().lower() not in
     ("", "off", "0", "false"),
     "port queue item 1c, the pipelined executor"),
    ("PINGOO_PIPELINE_DEPTH", lambda v: v != "",
     "port queue item 1c, the pipelined executor"),
    # The double-buffered dispatch; at most 1 is the port's one batch.
    ("PINGOO_SCHED_PIPELINE", _pipeline_depth_above_1,
     "port queue item 1c, the pipelined executor"),
    ("PINGOO_PREFILTER_LEVELS", lambda v: v != "",
     "port queue item 2, prefilter compact mode"),
    ("PINGOO_PREFILTER", lambda v: v == "compact",
     "port queue item 2, prefilter compact mode"),
    ("PINGOO_STAGING", lambda v: v.strip().lower() == "compact",
     "port queue item 3, compact staging"),
    ("PINGOO_STAGING_DEPTH", lambda v: v not in ("", "0"),
     "port queue item 3, compact staging"),
    ("PINGOO_NFA_SPLIT", lambda v: v not in ("", "0"),
     "port queue item 4, halo split"),
    ("PINGOO_SCAN_STRATEGY", lambda v: v == "halo",
     "port queue item 4, halo split"),
    ("PINGOO_HALO_SPLIT", lambda v: v not in ("", "0"),
     "port queue item 4, halo split"),
    # The JAX package's lane and row packing of lax.scan banks.
    ("PINGOO_SCAN_PACK", lambda v: v not in ("", "field"),
     "section 2, kernel work item 1, lane packing"),
    ("PINGOO_MEGASTEP", lambda v: v not in ("", "off"),
     "port queue item 5, megastep and DeviceInputQueue"),
    ("PINGOO_MEGASTEP_K", lambda v: v != "",
     "port queue item 5, megastep and DeviceInputQueue"),
    ("PINGOO_MESH", lambda v: v.strip() not in ("", "1", "1x1", "1x1x1"),
     "port queue item 9, the mesh"),
    # The port's sidecar dispatches whatever one drain pass returns (the
    # JAX package's "fixed" window); "allow" there answers rows that
    # would miss their deadline with allow, a different verdict.
    ("PINGOO_SCHED_MODE", lambda v: v not in ("", "fixed"),
     "port queue item 9, the scheduler"),
    ("PINGOO_SCHED_FAILOPEN", lambda v: v == "allow",
     "port queue item 9, the scheduler"),
    # The deadline of the continuous scheduler and of the pipelined
    # executor's stage budgets.
    ("PINGOO_DEADLINE_MS", lambda v: v != "",
     "port queue item 9, the scheduler"),
)


def check_env() -> None:
    """Raise NotImplementedError for a knob whose feature is not in the
    port, rather than ignoring it."""
    for name, unported, item in _UNPORTED:
        value = os.environ.get(name, "")
        if unported(value):
            raise NotImplementedError(
                f"{name}={value} is not supported by pingoo_tpu_torch yet "
                f"(ROADMAP.md: {item})")


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; raise when it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pingoo_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
