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
# Three knobs of the JAX package are not here: PINGOO_NFA_LOOKUP,
# PINGOO_DFA_KERNEL and PINGOO_PREFILTER_KERNEL choose among its JAX
# backends (lax.scan lookups, Pallas or XLA) and mean nothing in the
# port, whose only device route is its CUDA kernels; nor is
# PINGOO_PREFILTER_LEVELS, the depth of the JAX package's compact row
# ladder: the port's compact mode gathers exactly its candidate rows.
_UNPORTED = (
    # The JAX package's lane and row packing of lax.scan banks.
    ("PINGOO_SCAN_PACK", lambda v: v not in ("", "field"),
     "section 2, kernel work item 1, lane packing"),
    # `off` and `force` are ported (engine/verdict.py, engine/graphs.py);
    # `auto` sizes K against deadline slack with the scheduler's cost
    # model, which the port does not have.
    ("PINGOO_MEGASTEP", lambda v: v == "auto",
     "port queue item 9, the scheduler (megastep auto sizing)"),
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


def pipeline_mode() -> str:
    """PINGOO_PIPELINE: "on" (the default) runs the pipelined executor,
    "off", "0" or "false" one batch at a time."""
    mode = os.environ.get("PINGOO_PIPELINE", "on").strip().lower()
    return "off" if mode in ("off", "0", "false") else "on"


def pipeline_depth(default: int) -> int:
    """A plane's in-flight bound: PINGOO_PIPELINE_DEPTH where it is an
    integer (at least 1), else `default`, as in the JAX package."""
    try:
        return max(1, int(os.environ.get("PINGOO_PIPELINE_DEPTH",
                                         str(default))))
    except ValueError:
        return max(1, int(default))


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
