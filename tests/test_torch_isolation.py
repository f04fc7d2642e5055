"""The PyTorch port stands alone and refuses to guess.

  * With `jax` and `pingoo_tpu` blocked in sys.modules, a fresh
    interpreter imports the port, compiles a plan and evaluates a batch
    on the CPU (the card's machine has no JAX), builds the ring library
    and serves the batch through `RingSidecar` on a ring, scans one
    request body in three windows, imports the listener, the server,
    `__main__`, the native-plane runner and the modules they stand on,
    and boots a deployment through them to `explain()`; and, in a
    second interpreter, the bot head, the artifact cache, the tenant
    store and a swap.
  * No source file of the port, nor chip_smoke.py, imports jax or the
    JAX package (`pingoo_tpu` not followed by `_torch`).
  * Without a card, an entry point called without device="cpu" raises,
    and knobs of features the port does not have raise too (the mesh,
    item 9b; the cost ledger, provenance, parity sampling, the compile
    ledger, the timeline and the flight recorder, item 10);
    PINGOO_CHAOS is parsed, and a malformed spec raises.
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
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

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
            "obs.window", "obs.pipeline", "host.jwt", "host.captcha",
            "host.captcha_frontend", "host.geoip", "host.services",
            "host.discovery", "host.tlsmgr", "host.acme", "host.h2",
            "host.httpd", "host.server", "host.native_plane", "__main__",
            "engine.graphs", "obs.registry", "obs.schema"):
    importlib.import_module("pingoo_tpu_torch." + mod)
# The megastep (PINGOO_MEGASTEP=force, K=4): one window of 4 slices.
import os
os.environ["PINGOO_MEGASTEP"] = "force"
os.environ["PINGOO_MEGASTEP_K"] = "4"
mega = VerdictService(plan, lists, max_batch=64, device="cpu")
assert [(v.action, v.matched.tobytes()) for v in
        mega.evaluate_batch(reqs[:32])] == [
    (v.action, v.matched.tobytes()) for v in
    VerdictService(plan, lists, device="cpu").evaluate_batch(reqs[:32])]
assert mega.pipeline_snapshot()["megastep"]["slices"] == 4
del os.environ["PINGOO_MEGASTEP"], os.environ["PINGOO_MEGASTEP_K"]
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
pipe = svc.pipeline_snapshot()
assert (pipe["mode"], pipe["depth"], pipe["batches"]) == ("on", 2, {"on": 8})
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


ISOLATED_SWAP = r"""
import sys
sys.modules["jax"] = None
sys.modules["pingoo_tpu"] = None
sys.path.insert(0, sys.argv[1])
import asyncio, tempfile
import torch
torch.set_num_threads(1)
from pingoo_tpu_torch.compiler.cache import compile_ruleset_cached
from pingoo_tpu_torch.compiler.obligations import prove_plan
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine.hotswap import TenantPlanStore, swap_counts
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.models import botscore
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
rules, lists = generate_ruleset(40, list_sizes=(64, 16), seed=7)
rules2, lists2 = generate_ruleset(40, list_sizes=(64, 16), seed=8)
with tempfile.TemporaryDirectory() as tmp:
    cold = compile_ruleset_cached(rules, lists, cache_dir=tmp, device="cpu")
    warm = compile_ruleset_cached(rules, lists, cache_dir=tmp, device="cpu")
    entry = TenantPlanStore(tmp, device="cpu").prepare("acme", rules2, lists2)
assert warm.stats == cold.stats and prove_plan(warm).ok
params = botscore.init_params(torch.Generator().manual_seed(3), device="cpu")
reqs = generate_traffic(16, seed=9, lists=lists)
svc = VerdictService(warm, lists, max_batch=16, device="cpu",
                     bot_score_params=params)
async def go():
    await svc.start()
    try:
        before = await asyncio.gather(*map(svc.evaluate, reqs))
        res = await svc.swap_plan(entry.plan, lists=entry.lists,
                                  tenant="acme")
        after = await asyncio.gather(*map(svc.evaluate, reqs))
        return before, res, after
    finally:
        await svc.stop()
before, res, after = asyncio.run(go())
assert {v.epoch for v in before} == {0} and {v.epoch for v in after} == {1}
assert res["epoch"] == 1 and swap_counts("python") == {"acme/ok": 1}
assert all(0.0 < v.bot_score < 1.0 for v in before + after)
assert not any(k == "jax" or k.startswith(("jax.", "pingoo_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED-SWAP-OK")
"""


def test_bot_head_cache_and_swap_run_without_jax():
    """The bot head, the artifact cache with its proofs, the tenant store
    and a swap, in an interpreter where jax and the JAX package cannot
    be imported."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", ISOLATED_SWAP, str(REPO)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(REPO / "pingoo_tpu_torch"), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED-SWAP-OK" in out.stdout


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
    for new in ("models/botscore.py", "compiler/cache.py",
                "compiler/obligations.py", "engine/hotswap.py",
                "sched/scheduler.py", "engine/ladder.py", "obs/chaos.py"):
        assert REPO / "pingoo_tpu_torch" / new in files, new
    offenders = []
    for path in files:
        for m in IMPORT_RE.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0)!r}")
    assert not offenders, offenders


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_new_entry_points_raise_without_a_card(no_card, tmp_path):
    from pingoo_tpu_torch.compiler.cache import compile_ruleset_cached
    from pingoo_tpu_torch.engine.hotswap import TenantPlanStore
    from pingoo_tpu_torch.models import botscore

    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TenantPlanStore(str(tmp_path)).prepare("acme", rules, lists)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        botscore.init_params(torch.Generator().manual_seed(1))
    params = botscore.init_params(torch.Generator().manual_seed(1),
                                  device="cpu")
    botscore.save_params(params, str(tmp_path / "head.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        botscore.load_params(str(tmp_path / "head.npz"))
    # The cache hit too places its tables on the card, or raises.
    compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path),
                           device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_ruleset_cached(rules, lists, cache_dir=str(tmp_path))


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
    ("PINGOO_MESH", "2x1x1"),
    ("PINGOO_SCAN_PACK", "length"),
    ("PINGOO_SCAN_PACK", "batch"),
    # Observability knobs of later slices of port queue item 10.
    ("PINGOO_PROVENANCE", "1"),
    ("PINGOO_PARITY_SAMPLE", "0.5"),
    ("PINGOO_PARITY_FAULT_INJECT", "rule_"),
    ("PINGOO_TIMELINE_SAMPLE", "0.01"),
    ("PINGOO_FLIGHT_DUMP_DIR", "flight"),
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
    ("PINGOO_SCAN_PACK", "fill", "kernel work item 1, lane packing"),
    ("PINGOO_MESH", "2x1x1", "item 9b, the mesh"),
    ("PINGOO_MESH", "1x2x1", "item 9b, the mesh"),
    ("PINGOO_PROVENANCE", "on", "item 10, provenance"),
    ("PINGOO_PARITY_SAMPLE", "1", "item 10, parity sampling"),
    ("PINGOO_PARITY_FAULT_INJECT", "x", "item 10, parity sampling"),
    ("PINGOO_TIMELINE_SAMPLE", "1", "item 10, the timeline"),
    ("PINGOO_FLIGHT_DUMP_DIR", "/d", "item 10, the flight recorder"),
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
    # The pipelined executor (port queue item 1c, ported): its knobs and
    # the JAX package's default "on".
    ("PINGOO_PIPELINE", "on"), ("PINGOO_PIPELINE", "1"),
    ("PINGOO_PIPELINE", "true"), ("PINGOO_PIPELINE_DEPTH", "3"),
    ("PINGOO_PIPELINE_DEPTH", "1"), ("PINGOO_SCHED_PIPELINE", "2"),
    ("PINGOO_SCHED_PIPELINE", "3"),
    # The megastep (port queue item 5, ported): `force` and its K cap.
    ("PINGOO_MEGASTEP", "force"), ("PINGOO_MEGASTEP_K", "4"),
    # Compact staging (item 3) and the prefilter's compact mode (item 2),
    # ported: the values that raised before.
    ("PINGOO_PREFILTER", "compact"), ("PINGOO_STAGING", "compact"),
    ("PINGOO_PREFILTER_LEVELS", "4"), ("PINGOO_STAGING_DEPTH", "2"),
    ("PINGOO_PREFILTER_LEVELS", "2"), ("PINGOO_STAGING_DEPTH", "1"),
    # The halo split (item 4, ported): the values that raised before.
    ("PINGOO_NFA_SPLIT", "1"), ("PINGOO_SCAN_STRATEGY", "halo"),
    ("PINGOO_HALO_SPLIT", "1"),
    # The scheduler (item 9, ported): the values that raised before, an
    # unknown mode (continuous) and policy (serve) as the JAX package
    # reads them, and the cost ledger turned off.
    ("PINGOO_MEGASTEP", "auto"), ("PINGOO_SCHED_MODE", "continuous"),
    ("PINGOO_SCHED_MODE", "deadline"), ("PINGOO_SCHED_FAILOPEN", "allow"),
    ("PINGOO_DEADLINE_MS", "2"), ("PINGOO_SCHED_MODE", "bogus"),
    ("PINGOO_SCHED_FAILOPEN", "interpret"), ("PINGOO_MEGASTEP_K", "8"),
    ("PINGOO_DEADLINE_MS", "5"), ("PINGOO_SCHED_FAILOPEN", "drop"),
    ("PINGOO_COST_LEDGER", "off"), ("PINGOO_COST_LEDGER", "0"),
    # Knobs that pick among the JAX package's backends mean nothing here.
    ("PINGOO_NFA_LOOKUP", "pair"), ("PINGOO_DFA_KERNEL", "pallas"),
    ("PINGOO_PREFILTER_KERNEL", "pallas"),
    # Item 10's observability knobs where they ask for nothing (None:
    # unset): provenance off, rates of 0, the compile ledger off.
    ("PINGOO_PROVENANCE", "0"), ("PINGOO_PROVENANCE", None),
    ("PINGOO_PARITY_SAMPLE", "0"), ("PINGOO_TIMELINE_SAMPLE", "0"),
    ("PINGOO_PERF_LEDGER", "off"), ("PINGOO_PERF_LEDGER", "0"),
    # The compile ledger and the durable cost ledger (item 10, slice 2,
    # ported): the values that raised before.
    ("PINGOO_COST_LEDGER", "COST_LEDGER.json"), ("PINGOO_COST_LEDGER", "on"),
    ("PINGOO_PERF_LEDGER", "on"), ("PINGOO_PERF_LEDGER", "perf.jsonl"),
    ("PINGOO_PERF_LEDGER", "1"),
    ("PINGOO_COMPILE_SURFACE", "COMPILE_SURFACE.json"),
    ("PINGOO_COMPILE_SURFACE", "s.json"),
])
def test_ported_knob_values_pass(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    port_device.check_env()


@pytest.mark.parametrize("spec,ok", [
    ("xla_error:1", True), ("kill:3,pause:20:2", True),
    ("stall:encode:1.5,verdict_full:2,swap_storm", True),
    ("heartbeat_freeze", True),
    ("bogus", False), ("pause", False), ("stall:encode", False),
    ("kill:x", False), ("swap_storm:0", False),
])
def test_chaos_spec_parses_or_raises(monkeypatch, spec, ok):
    """PINGOO_CHAOS is read, never ignored: a spec parses as the JAX
    package's does, and a malformed one raises at check_env() and at a
    plane's construction."""
    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    plan = compile_ruleset(rules, lists, device="cpu")
    monkeypatch.setenv("PINGOO_CHAOS", spec)
    if ok:
        port_device.check_env()
        VerdictService(plan, lists, device="cpu")
        return
    with pytest.raises(ValueError, match="PINGOO_CHAOS"):
        port_device.check_env()
    with pytest.raises(ValueError, match="PINGOO_CHAOS"):
        VerdictService(plan, lists, device="cpu")


ISOLATED_SCHED = r"""
import sys
sys.modules["jax"] = None
sys.modules["pingoo_tpu"] = None
sys.path.insert(0, sys.argv[1])
from pingoo_tpu_torch.engine.ladder import DegradationLadder
from pingoo_tpu_torch.obs.chaos import ChaosInjector
from pingoo_tpu_torch.sched import mesh_env_spec
from pingoo_tpu_torch.sched.scheduler import Scheduler, SchedulerConfig
s = Scheduler(SchedulerConfig(max_batch=64, deadline_ms=50.0))
s.observe_stage_cost("compute", 64, 4.0)
assert s.should_launch(64, 0.0, 0.0) and s.size_megastep_k([1, 2, 4], 64,
                                                            1.0, 1.0) >= 1
clock = [0.0]
ladder = DegradationLadder("python", clock=lambda: clock[0])
ladder.note_failure("device", RuntimeError("x"))
clock[0] = 1.0
assert ladder.try_rung("device") and ladder.demoted() == ["device"]
assert ChaosInjector("xla_error:2").xla_error_at == 2
assert mesh_env_spec() == (1, 1, 1)
assert not any(k == "jax" or k.startswith(("jax.", "pingoo_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED-SCHED-OK")
"""


def test_scheduler_ladder_and_chaos_import_neither_jax_nor_the_jax_package():
    """The new modules of port queue item 9 run in an interpreter where
    jax and the JAX package cannot be imported, and the source scan
    covers them."""
    files = port_sources()
    for new in ("sched/__init__.py", "sched/scheduler.py",
                "engine/ladder.py", "obs/chaos.py"):
        path = REPO / "pingoo_tpu_torch" / new
        assert path in files, new
        assert not IMPORT_RE.search(path.read_text()), new
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("PINGOO_MESH", None)
    out = subprocess.run([sys.executable, "-c", ISOLATED_SCHED, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO / "pingoo_tpu_torch"), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED-SCHED-OK" in out.stdout


def test_non_integer_sched_pipeline_raises_value_error(monkeypatch):
    """PINGOO_SCHED_PIPELINE is an integer: another value raises
    ValueError when the service is built, as `int()` does in the JAX
    package."""
    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    plan = compile_ruleset(rules, lists, device="cpu")
    monkeypatch.setenv("PINGOO_SCHED_PIPELINE", "two")
    port_device.check_env()
    with pytest.raises(ValueError, match="two"):
        VerdictService(plan, lists, device="cpu")


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
