"""Device resolution and the environment knobs this port refuses.

Entry points run on the CUDA card unless the caller asks for the CPU:
`resolve_device(None)` is `cuda` and raises when there is no card, so a
program meant for the card never carries on quietly on the CPU. Tests
pass `device="cpu"`, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import os

import torch

# Knobs of the JAX package whose features the port does not have yet:
# (variable, predicate on its value, the ROADMAP.md port-queue item).
_UNPORTED = (
    # Any value the JAX package reads as "on" (its default there); the
    # port always runs one batch at a time, which is its "off".
    ("PINGOO_PIPELINE", lambda v: v.strip().lower() not in
     ("", "off", "0", "false"),
     "port queue item 1c, the pipelined executor"),
    ("PINGOO_PIPELINE_DEPTH", lambda v: v != "",
     "port queue item 1c, the pipelined executor"),
    ("PINGOO_PREFILTER", lambda v: v == "compact",
     "port queue item 2, prefilter compact mode"),
    ("PINGOO_STAGING", lambda v: v.strip().lower() == "compact",
     "port queue item 3, compact staging"),
    ("PINGOO_NFA_SPLIT", lambda v: v not in ("", "0"),
     "port queue item 4, halo split"),
    ("PINGOO_SCAN_STRATEGY", lambda v: v == "halo",
     "port queue item 4, halo split"),
    ("PINGOO_MEGASTEP", lambda v: v not in ("", "off"),
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
