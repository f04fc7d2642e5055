"""The admission scheduler (`scheduler.Scheduler`): deadline-aware
continuous batching, per-request deadline accounting and the fail-open
policy for unmeetable deadlines, shared by both planes.

The JAX package's serving mesh (`sched/mesh_exec.py`, `parallel/`) is
not ported: on one card the mesh is one device (ROADMAP.md, port queue
item 9b). `mesh_env_spec` parses PINGOO_MESH as the JAX package does, so
a server validates it at boot; `device.check_env` refuses any spec
other than one device.
"""

import os

from .scheduler import (PIPELINE_COST_STAGES, CostModel, Scheduler,
                        SchedulerConfig)


def parse_mesh_spec(spec: str) -> tuple[int, int, int]:
    """`"dpxtpxsp"` -> (dp, tp, sp); ValueError on anything malformed,
    as the JAX package's `parallel/mesh.parse_mesh_spec`."""
    parts = str(spec).strip().lower().split("x")
    if len(parts) != 3:
        raise ValueError(f"bad mesh spec {spec!r}: want dpxtpxsp, e.g. 2x2x2")
    try:
        dp, tp, sp = (int(p) for p in parts)
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: non-integer axis") from None
    if dp < 1 or tp < 1 or sp < 1:
        raise ValueError(f"bad mesh spec {spec!r}: axes must be >= 1")
    return dp, tp, sp


def mesh_env_spec() -> tuple[int, int, int]:
    """(dp, tp, sp) from PINGOO_MESH (default 1x1x1)."""
    return parse_mesh_spec(os.environ.get("PINGOO_MESH", "1x1x1"))


__all__ = ["PIPELINE_COST_STAGES", "CostModel", "Scheduler",
           "SchedulerConfig", "mesh_env_spec", "parse_mesh_spec"]
