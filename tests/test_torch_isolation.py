"""The PyTorch port stands alone and refuses to guess.

  * With `jax` and `pingoo_tpu` blocked in sys.modules, a fresh
    interpreter imports the port, compiles a plan and evaluates a batch
    on the CPU (the card's machine has no JAX), builds the ring library
    and serves the batch through `RingSidecar` on a ring, scans one
    request body in three windows, imports the modules the listener
    stands on, and boots a deployment through them to `explain()`.
  * No source file of the port, nor chip_smoke.py, imports jax or the
    JAX package (`pingoo_tpu` not followed by `_torch`).
  * Without a card, an entry point called without device="cpu" raises,
    and knobs of features the port does not have raise too.
  * Importing the port builds no kernel; a failed build or launch
    raises, and only a successful launch is counted.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pingoo_tpu_torch import device as port_device
from pingoo_tpu_torch.compiler.plan import compile_ruleset, \
    tables_from_reference
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.ops import _build
from pingoo_tpu_torch.utils.crs import generate_ruleset

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

ISOLATED = r"""
import sys
sys.modules["jax"] = None
sys.modules["pingoo_tpu"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine.batch import bucket_arrays, encode_requests
from pingoo_tpu_torch.engine.verdict import make_lane_fn, make_verdict_fn
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
rules, lists = generate_ruleset(60, list_sizes=(128, 32), seed=7)
plan = compile_ruleset(rules, lists, device="cpu")
reqs = generate_traffic(64, attack_fraction=0.5, seed=8, lists=lists)
arrays = bucket_arrays(encode_requests(reqs).arrays)
m = make_verdict_fn(plan)(plan.np_tables, arrays)
lanes = make_lane_fn(plan)(plan.np_tables, arrays)
assert m.shape == (64, 60) and lanes.shape == (4, 64) and bool(m.any())
# The native plane: the ring library built from the port's copy, and the
# port's sidecar answering the same 64 requests on a temporary ring.
import tempfile, threading
from pingoo_tpu_torch import native_ring
from pingoo_tpu_torch.engine.service import VerdictService
native_ring.build_ring_lib()
with tempfile.TemporaryDirectory() as tmp:
    ring = native_ring.Ring(tmp + "/ring", capacity=128, create=True)
    sidecar = native_ring.RingSidecar(ring, plan, lists, max_batch=64,
                                      device="cpu")
    t = threading.Thread(target=sidecar.run, daemon=True)
    t.start()
    got = native_ring.drive_stream(ring, native_ring.pack_requests(reqs))
    sidecar.stop()
    t.join(30)
    ring.close()
want = bytes(v.action | (v.verified_block << 2) for v in
             VerdictService(plan, lists, device="cpu").evaluate_batch(reqs))
assert got.actions == want and any(a & 3 for a in want), (got.actions, want)
# Body inspection: one flow of three windows through the streaming scanner.
from pingoo_tpu_torch.engine import bodyscan
scanner = bodyscan.BodyScanner(bodyscan.compile_body_plan(window=16,
                                                          device="cpu"),
                               device="cpu")
body = b"a=1&b=" + b"x" * 20 + b"UNION SELECT 1"
verdicts = []
for i, piece in enumerate(bodyscan.split_payload(body, 16)):
    verdicts += scanner.scan_windows([bodyscan.BodyWindow(
        5, i, piece, final=i == 2)])
assert [(v.flow_id, v.unverified, v.verified_block) for v in verdicts] \
    == [(5, 1, True)], verdicts
# The modules the listener stands on, and a deployment booted through
# them: parse_config -> load_lists -> compile_ruleset(routes) -> explain.
import asyncio, importlib
for mod in ("config.load", "lists", "logging_utils", "obs.trace",
            "obs.window", "host.jwt", "host.captcha", "host.captcha_frontend",
            "host.geoip", "host.services", "host.discovery", "host.tlsmgr",
            "host.acme", "host.h2"):
    importlib.import_module("pingoo_tpu_torch." + mod)
from pingoo_tpu_torch.config import parse_config
from pingoo_tpu_torch.lists import load_lists
from pingoo_tpu_torch.utils.crs import deployment
with tempfile.TemporaryDirectory() as tmp:
    config = parse_config(deployment(rules, lists, tmp))
    loaded = load_lists(config.lists)
routes = [(s.name, s.route) for s in config.services]
booted = compile_ruleset(config.rules, loaded, routes=routes, device="cpu")
svc = VerdictService(booted, loaded, device="cpu")
async def explain_all():
    await svc.start()
    try:
        return [await svc.explain(r) for r in reqs[:8]]
    finally:
        await svc.stop()
explained = asyncio.run(explain_all())
assert all(e["parity"]["consistent"] for e in explained)
assert any(e["action"] for e in explained), explained
assert svc.stats.snapshot()["requests"] == 8
assert svc.pipeline_snapshot()["depth"] == 1
assert not any(k == "jax" or k.startswith(("jax.", "pingoo_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED-OK", int(m.sum()), sidecar.processed)
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", ISOLATED, str(REPO)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(REPO / "pingoo_tpu_torch"), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED-OK" in out.stdout


IMPORT_RE = re.compile(
    r"^\s*(?:from\s+(?:jax|pingoo_tpu(?!_torch))\b"
    r"|import\s+(?:[\w.]+\s*,\s*)*(?:jax|pingoo_tpu(?!_torch))\b)"
    r"|import_module\(\s*['\"](?:jax|pingoo_tpu(?!_torch))\b",
    re.MULTILINE)


def port_sources():
    files = sorted((REPO / "pingoo_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_import_scan_catches_reference_imports():
    """The scan's own guard: it flags JAX and JAX-package imports and
    passes the port's own name."""
    for bad in ("import jax", "from jax import numpy", "import jax.numpy",
                "from pingoo_tpu.ops import cidr", "import pingoo_tpu",
                "import os, pingoo_tpu.expr",
                "importlib.import_module('pingoo_tpu.engine')"):
        assert IMPORT_RE.search(bad), bad
    for good in ("from pingoo_tpu_torch.ops import cidr",
                 "import pingoo_tpu_torch", "from .nfa import build_bank",
                 "# the JAX package's pingoo_tpu/ops/pallas_scan.py"):
        assert not IMPORT_RE.search(good), good


def test_no_source_imports_jax_or_the_jax_package():
    files = port_sources()
    assert len(files) > 20
    assert REPO / "pingoo_tpu_torch" / "native_ring.py" in files
    assert REPO / "pingoo_tpu_torch" / "engine" / "bodyscan.py" in files
    offenders = []
    for path in files:
        for m in IMPORT_RE.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0)!r}")
    assert not offenders, offenders


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_ruleset(rules, lists)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_ruleset(rules, lists, device="cuda")
    plan = compile_ruleset(rules, lists, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VerdictService(plan, lists)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tables_from_reference({}, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.to("cuda")
    assert VerdictService(plan, lists, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name,value", [
    ("PINGOO_PREFILTER", "compact"),
    ("PINGOO_STAGING", "compact"),
    ("PINGOO_NFA_SPLIT", "1"),
    ("PINGOO_MEGASTEP", "auto"),
    ("PINGOO_MEGASTEP", "force"),
    ("PINGOO_MESH", "2x1x1"),
    ("PINGOO_PIPELINE", "on"),
    ("PINGOO_PIPELINE_DEPTH", "3"),
    ("PINGOO_SCAN_STRATEGY", "halo"),
    ("PINGOO_SCHED_MODE", "continuous"),
    ("PINGOO_SCHED_MODE", "deadline"),
    ("PINGOO_SCHED_FAILOPEN", "allow"),
    ("PINGOO_HALO_SPLIT", "1"),
    ("PINGOO_SCAN_PACK", "length"),
    ("PINGOO_SCAN_PACK", "batch"),
    ("PINGOO_PREFILTER_LEVELS", "4"),
    ("PINGOO_STAGING_DEPTH", "2"),
    ("PINGOO_MEGASTEP_K", "4"),
    ("PINGOO_SCHED_PIPELINE", "2"),
    ("PINGOO_SCHED_PIPELINE", "two"),
    ("PINGOO_DEADLINE_MS", "2"),
])
def test_unported_knobs_raise(monkeypatch, name, value):
    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    plan = compile_ruleset(rules, lists, device="cpu")
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_device.check_env()
    with pytest.raises(NotImplementedError, match=name):
        compile_ruleset(rules, lists, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        VerdictService(plan, lists, device="cpu")


@pytest.mark.parametrize("name,value,item", [
    ("PINGOO_PIPELINE", "on", "item 1c, the pipelined executor"),
    ("PINGOO_PIPELINE", "1", "item 1c, the pipelined executor"),
    ("PINGOO_PIPELINE_DEPTH", "3", "item 1c, the pipelined executor"),
    ("PINGOO_SCAN_STRATEGY", "halo", "item 4, halo split"),
    ("PINGOO_SCHED_MODE", "continuous", "item 9, the scheduler"),
    ("PINGOO_SCHED_FAILOPEN", "allow", "item 9, the scheduler"),
    ("PINGOO_HALO_SPLIT", "1", "item 4, halo split"),
    ("PINGOO_SCAN_PACK", "fill", "kernel work item 1, lane packing"),
    ("PINGOO_PREFILTER_LEVELS", "2", "item 2, prefilter compact mode"),
    ("PINGOO_STAGING_DEPTH", "1", "item 3, compact staging"),
    ("PINGOO_MEGASTEP_K", "2", "item 5, megastep and DeviceInputQueue"),
    ("PINGOO_SCHED_PIPELINE", "3", "item 1c, the pipelined executor"),
    ("PINGOO_DEADLINE_MS", "5", "item 9, the scheduler"),
])
def test_unported_knobs_name_their_item(monkeypatch, name, value, item):
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=item):
        port_device.check_env()


@pytest.mark.parametrize("name,value", [
    ("PINGOO_PREFILTER", "banks"), ("PINGOO_PREFILTER", "off"),
    ("PINGOO_STAGING", "full"), ("PINGOO_MEGASTEP", "off"),
    ("PINGOO_BODY_INSPECT", "off"), ("PINGOO_BODY_INSPECT", "on"),
    ("PINGOO_MESH", "1x1x1"),
    ("PINGOO_NFA_SPLIT", "0"), ("PINGOO_PIPELINE", "off"),
    ("PINGOO_SCAN_STRATEGY", "pair"), ("PINGOO_SCAN_STRATEGY", "pallas"),
    ("PINGOO_SCHED_MODE", "fixed"), ("PINGOO_SCHED_FAILOPEN", "serve"),
    ("PINGOO_HALO_SPLIT", "0"), ("PINGOO_SCAN_PACK", "field"),
    ("PINGOO_STAGING_DEPTH", "0"), ("PINGOO_SCHED_PIPELINE", "1"),
    ("PINGOO_SCHED_PIPELINE", "0"),
    # Knobs that pick among the JAX package's backends mean nothing here.
    ("PINGOO_NFA_LOOKUP", "pair"), ("PINGOO_DFA_KERNEL", "pallas"),
    ("PINGOO_PREFILTER_KERNEL", "pallas"),
])
def test_ported_knob_values_pass(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    port_device.check_env()


def test_import_builds_nothing():
    """Kernels compile at first use on a CUDA tensor, never on import;
    every launcher is registered with a zero count."""
    assert set(_build.KERNELS) == {"nfa_scan", "bitsplit_dfa", "prefilter"}
    assert set(_build.SOURCES) == set(_build.KERNELS)
    for name, src in _build.SOURCES.items():
        assert (_build.CSRC_DIR / src).is_file()
        assert _build.lib_path(name).name.startswith(f"lib{name}-")
    assert all(k._fn is None for k in _build.KERNELS.values()) \
        or torch.cuda.is_available()


def test_launch_failure_raises_and_counts_nothing():
    """A launcher's nonzero cudaError raises with its message; only a
    successful launch is counted."""
    kernel = _build.Kernel("prefilter", "pingoo_prefilter_chunk", [])
    kernel._fn = lambda *args: 0
    kernel._err = lambda rc: b"unused"
    kernel.launch()
    assert kernel.launches == 1
    kernel._fn = lambda *args: 9
    kernel._err = lambda rc: b"invalid configuration argument"
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        kernel.launch()
    assert kernel.launches == 1


def test_build_failure_raises(tmp_path, monkeypatch):
    """An nvcc that fails makes the build raise (no plain fallback), and
    leaves no library behind."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such target"):
        _build.build(["prefilter"])
    assert not _build.lib_path("prefilter").exists()
