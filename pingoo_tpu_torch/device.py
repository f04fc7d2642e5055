"""Device resolution and the environment knobs this port refuses.

Entry points run on the CUDA card unless the caller asks for the CPU:
`resolve_device(None)` is `cuda` and raises when there is no card, so a
program meant for the card never carries on quietly on the CPU. Tests
pass `device="cpu"`, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import os

import torch

from .obs.chaos import ChaosInjector
from .sched import mesh_env_spec

# Knobs of the JAX package whose features the port does not have yet:
# (variable, predicate on its value, the ROADMAP.md port-queue item). Each
# raises only where its value asks for its feature.
# The scheduler's knobs (PINGOO_SCHED_MODE, PINGOO_SCHED_FAILOPEN,
# PINGOO_DEADLINE_MS, PINGOO_SCHED_SEED_MS, PINGOO_MEGASTEP=auto), the
# ledgers' (PINGOO_COST_LEDGER, on by default; PINGOO_PERF_LEDGER,
# PINGOO_PERF_LEDGER_N and PINGOO_COMPILE_SURFACE) and PINGOO_CHAOS are
# read as the JAX package reads them (sched/scheduler.py, obs/perf.py,
# obs/chaos.py).
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
    # Provenance: the JAX package's default is on; the port has none, so
    # only unset or 0 passes.
    ("PINGOO_PROVENANCE", lambda v: v not in ("", "0"),
     "port queue item 10, provenance"),
    # Parity sampling: a rate above 0, or a fault to inject into it.
    ("PINGOO_PARITY_SAMPLE", lambda v: _positive(v),
     "port queue item 10, parity sampling"),
    ("PINGOO_PARITY_FAULT_INJECT", lambda v: bool(v),
     "port queue item 10, parity sampling"),
    # The cross-plane timeline: a sample rate above 0.
    ("PINGOO_TIMELINE_SAMPLE", lambda v: _positive(v),
     "port queue item 10, the timeline"),
    # The flight recorder's dump on drain.
    ("PINGOO_FLIGHT_DUMP_DIR", lambda v: bool(v),
     "port queue item 10, the flight recorder"),
)


def _positive(value: str) -> bool:
    """A rate that asks for its feature: a number above 0 (the JAX
    package reads anything else as 0, off)."""
    try:
        return float(value) > 0.0
    except ValueError:
        return False


def _unported(name: str, value: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}={value} is not supported by pingoo_tpu_torch yet "
        f"(ROADMAP.md: {item})")


def check_env() -> None:
    """Raise NotImplementedError for a knob whose feature is not in the
    port, rather than ignoring it, and ValueError for a malformed
    PINGOO_MESH or PINGOO_CHAOS spec."""
    for name, unported, item in _UNPORTED:
        value = os.environ.get(name, "")
        if unported(value):
            raise _unported(name, value, item)
    # On one card the serving mesh is one device; any other spec needs
    # more cards than the port's cells have.
    dp, tp, sp = mesh_env_spec()
    if dp * tp * sp > 1:
        raise _unported("PINGOO_MESH", os.environ["PINGOO_MESH"],
                        "port queue item 9b, the mesh")
    ChaosInjector.from_env()


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
