"""The port's degradation ladder (engine/ladder.py) and chaos injector
(obs/chaos.py), against the JAX package, and both on the planes.

  * `DegradationLadder` steps through the JAX package's states on the
    same seeded calls with a fake clock; `ChaosInjector` parses every
    fault as the JAX package does, raises on malformed specs, fires its
    hooks alike and is dormant without PINGOO_CHAOS.
  * On the ring: `xla_error:1` demotes a rung (`device` on a plan
    without DFAs, `dfa` on one with them, `megastep` under force),
    the interpreter's verdicts are posted, and a probe after the backoff
    re-promotes it; a swap while demoted serves the new plan; the swap
    storm posts every ticket once with the oracle's verdicts; a body
    scanner failure demotes `body` and answers the final windows with
    action 0; `kill:1` in a child strands dequeued tickets that a new
    sidecar re-evaluates exactly once.
  * A `KernelBuildError` is never demoted, on either plane, and neither
    is a CUDA runtime fault raised at a sync (CUDA errors are sticky):
    it fails the batch as a `DeviceFault`; a scorer error on the Python
    plane is counted and serves 0.0.

CPU only, small plans; exact equality throughout.
"""

import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pingoo_tpu.engine.ladder import DegradationLadder as RefLadder
from pingoo_tpu.obs.chaos import ChaosInjector as RefChaos
from pingoo_tpu.obs.registry import MetricRegistry
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine.batch import RequestTuple, tuple_to_context
from pingoo_tpu_torch.engine.ladder import FALLBACKS, RUNGS, DegradationLadder
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.engine.verdict import (action_lanes, dfa_dispatch_counts,
                                             interpret_rules_row)
from pingoo_tpu_torch.expr import compile_expression
from pingoo_tpu_torch.models import botscore
from pingoo_tpu_torch.obs.chaos import ChaosDeviceError, ChaosInjector
from pingoo_tpu_torch.engine import service as service_mod
from pingoo_tpu_torch.engine import verdict as verdict_mod
from pingoo_tpu_torch.ops._build import DeviceFault, KernelBuildError
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEEDS = (7, 1234, 999983, 31337, 2026)
CLEARED_ENV = ("PINGOO_CHAOS", "PINGOO_DFA", "PINGOO_MESH",
               "PINGOO_SCHED_MODE", "PINGOO_SCHED_FAILOPEN",
               "PINGOO_DEADLINE_MS", "PINGOO_PIPELINE", "PINGOO_PIPELINE_DEPTH",
               "PINGOO_MEGASTEP", "PINGOO_MEGASTEP_K", "PINGOO_STAGING",
               "PINGOO_PREFILTER", "PINGOO_BODY_INSPECT")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- the ladder against the JAX package's ---------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_ladder_equals_the_reference(seed):
    clk_p, clk_r = FakeClock(), FakeClock()
    port = DegradationLadder("test", base_backoff_s=0.5, max_backoff_s=4.0,
                             clock=clk_p)
    ref = RefLadder("test", base_backoff_s=0.5, max_backoff_s=4.0,
                    clock=clk_r, registry=MetricRegistry())
    assert RUNGS == ("pipeline", "megastep", "dfa", "mesh", "device", "body")
    rng = random.Random(seed)
    for step in range(400):
        rung = rng.choice(RUNGS)
        op = rng.choice(("try", "fail", "ok", "tick", "healthy"))
        if op == "tick":
            dt = rng.choice((0.1, 0.5, 1.0, 3.0))
            clk_p.t += dt
            clk_r.t += dt
            continue
        if op == "try":
            assert port.try_rung(rung) == ref.try_rung(rung), step
        elif op == "fail":
            exc = RuntimeError(f"fault {step}")
            port.note_failure(rung, exc)
            ref.note_failure(rung, exc)
        elif op == "ok":
            port.note_success(rung)
            ref.note_success(rung)
        else:
            assert port.healthy(rung) == ref.healthy(rung)
        assert port.demoted() == ref.demoted(), step
        assert port.snapshot() == ref.snapshot(), step
    assert {n: s["fallback"] for n, s in port.snapshot().items()} \
        == FALLBACKS


def test_ladder_backoff_doubles_caps_and_resets():
    """The JAX package's cases (tests/test_resilience.py)."""
    clk = FakeClock()
    lad = DegradationLadder("test", base_backoff_s=1.0, max_backoff_s=4.0,
                            clock=clk)
    assert lad.try_rung("device")
    lad.note_failure("device", RuntimeError("boom"))
    assert lad.demoted() == ["device"] and not lad.try_rung("device")
    clk.t = 1.0
    assert lad.try_rung("device") and not lad.try_rung("device")
    lad.note_success("device")
    assert lad.try_rung("device") and lad.demoted() == []
    for i, want in enumerate((1.0, 2.0, 4.0, 4.0)):
        lad.note_failure("dfa", RuntimeError(str(i)))
        assert lad.snapshot()["dfa"]["backoff_s"] == want
    lad.note_success("dfa")
    snap = lad.snapshot()["dfa"]
    assert snap["backoff_s"] == 1.0 and snap["errors"] == 4 \
        and snap["demotions"] == 1 and "3" in snap["last_error"]


# -- the chaos injector against the JAX package's ----------------------------------

CHAOS_SPECS = ("kill", "kill:3", "pause:50:2,heartbeat_freeze",
               "stall:encode:2.5,stall:resolve:1", "xla_error",
               "xla_error:4", "verdict_full:3", "swap_storm",
               "swap_storm:7", " kill:2 , xla_error:2 ,", "")
CHAOS_ATTRS = ("spec", "active", "kill_after", "pause_ms", "pause_after",
               "freeze_heartbeat", "stalls", "xla_error_at",
               "verdict_full_budget", "swap_every")


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_spec_equals_the_reference(spec):
    port, ref = ChaosInjector(spec), RefChaos(spec)
    for attr in CHAOS_ATTRS:
        assert getattr(port, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("bad", ["bogus", "pause", "stall:encode", "kill:x",
                                 "swap_storm:0", "verdict_full",
                                 "xla_error:one", "pause:x:1"])
def test_malformed_chaos_spec_raises_as_the_reference(bad):
    with pytest.raises(ValueError, match="PINGOO_CHAOS"):
        ChaosInjector(bad)
    with pytest.raises(ValueError):
        RefChaos(bad)


def test_chaos_hooks_fire_as_the_reference():
    spec = "xla_error:3,verdict_full:2,swap_storm:3,stall:encode:1," \
           "pause:1:2,heartbeat_freeze"
    port, ref = ChaosInjector(spec), RefChaos(spec)
    for batches in range(8):
        got = []
        for c in (port, ref):
            try:
                c.maybe_xla_error(batches)
                raised = False
            except RuntimeError:
                raised = True
            got.append((raised, c.swap_due(batches), c.swap_due(batches),
                        c.verdict_full(), c.heartbeat_frozen()))
            c.stage("encode")
            c.stage("resolve")
            c.on_batch_done(batches)
        assert got[0] == got[1], batches
    with pytest.raises(ChaosDeviceError):
        ChaosInjector("xla_error:1").maybe_xla_error(0)
    assert port.injected == {"xla_error": 1, "verdict_full": 2,
                             "swap_storm": 2, "stall_encode": 8,
                             "pause": 1}
    assert port.snapshot() == {"spec": spec, "active": True,
                               "injected": port.injected}


def test_chaos_is_dormant_without_the_variable():
    c = ChaosInjector.from_env()
    assert not c.active
    c.on_batch_done(100)  # would SIGKILL if armed
    c.maybe_xla_error(100)
    c.stage("encode")
    assert not c.verdict_full() and not c.heartbeat_frozen()
    assert not c.swap_due(5) and c.injected == {}


# -- on the ring ----------------------------------------------------------------------


def two_rule_plan(prefix="/evil"):
    rules = [
        RuleConfig(name="waf", actions=(Action.BLOCK,),
                   expression=compile_expression(
                       f'http_request.path.starts_with("{prefix}")')),
        RuleConfig(name="bot", actions=(Action.BLOCK,),
                   expression=compile_expression(
                       'http_request.user_agent.contains("chaosbot")')),
    ]
    return compile_ruleset(rules, {}, device="cpu")


@pytest.fixture(scope="module")
def crs():
    rules, lists = generate_ruleset(40, list_sizes=(64, 16), seed=7)
    return compile_ruleset(rules, lists, device="cpu"), lists


def requests(n, offset=0):
    out = []
    for i in range(offset, offset + n):
        path = f"/evil/{i}" if i % 3 == 0 else f"/ok/{i}"
        if i % 5 == 0:
            path = f"/beta/{i}"
        ua = "chaosbot/1.0" if i % 7 == 0 else "Mozilla/5.0"
        out.append(RequestTuple(method="GET", host="r.test", path=path,
                                url=path, user_agent=ua, ip="10.0.0.1"))
    return out


def oracle_bytes(plan, lists, reqs):
    rows = np.stack([interpret_rules_row(plan, tuple_to_context(r, lists))
                     for r in reqs])
    unv, vblk = action_lanes(plan, rows)
    return bytes(int(u) | (int(v) << 2) for u, v in zip(unv, vblk))


def enqueue_all(ring, reqs):
    tickets = []
    for m, h, p, u, ua, ip, port, asn, cc in nr.pack_requests(reqs):
        t = ring.enqueue(method=m, host=h, path=p, url=u, user_agent=ua,
                         ip=ip, port=port, asn=asn, country=cc)
        assert t is not None
        tickets.append(t)
    return tickets


def poll_all(ring, need, timeout=120.0):
    """ticket -> [actions] until `need` verdicts came, then a short grace
    so that a second post of a ticket is seen."""
    got: dict = {}
    count = 0
    deadline = time.monotonic() + timeout
    while count < need and time.monotonic() < deadline:
        v = ring.poll_verdict()
        if v is None:
            time.sleep(0.002)
            continue
        got.setdefault(v[0], []).append(v[1])
        count += 1
    grace = time.monotonic() + 0.2
    while time.monotonic() < grace:
        v = ring.poll_verdict()
        if v is None:
            time.sleep(0.01)
            continue
        got.setdefault(v[0], []).append(v[1])
    return got


def serve(sidecar, ring, reqs, total, bodies=None):
    """Enqueue `reqs`, run the sidecar until it processed `total`, and
    return the verdict bytes in ticket order (each posted once). Body
    verdicts go to `bodies`, a dict, when given."""
    tickets = enqueue_all(ring, reqs)
    t = threading.Thread(target=sidecar.run, kwargs={"max_requests": total},
                         daemon=True)
    t.start()
    got = poll_all(ring, len(reqs) + (2 if bodies is not None else 0))
    t.join(120)
    assert not t.is_alive()
    if bodies is not None:
        for k in [k for k in got if k & nr.BODY_VERDICT_BIT]:
            bodies[k] = got.pop(k)
    assert sorted(got) == tickets
    assert all(len(a) == 1 for a in got.values())
    return bytes(got[k][0] for k in tickets)


def set_arm(monkeypatch, arm):
    if arm == "force":
        monkeypatch.setenv("PINGOO_MEGASTEP", "force")
        monkeypatch.setenv("PINGOO_MEGASTEP_K", "4")
    monkeypatch.setenv("PINGOO_PIPELINE", "off" if arm == "off" else "on")


@pytest.mark.parametrize("arm,dfa,rung", [
    ("on", "off", "device"), ("off", "off", "device"), ("on", "", "dfa"),
    ("off", "", "dfa"), ("force", "off", "megastep"),
    ("force", "", "megastep")])
def test_xla_error_demotes_serves_the_oracle_and_repromotes(
        crs, tmp_path, monkeypatch, arm, dfa, rung):
    """After tests/test_resilience.py's round trip: the injected device
    error demotes the cheapest rung (`dfa` while the plan runs a lowered
    DFA and PINGOO_DFA does not pin it, else `device`; the window's
    `megastep` under force), its batch is served by the interpreter, and
    a probe after the backoff re-promotes it."""
    lists = crs[1]
    plan = compile_ruleset(*generate_ruleset(40, list_sizes=(64, 16),
                                             seed=7), device="cpu")
    if dfa:
        monkeypatch.setenv("PINGOO_DFA", dfa)
    assert (dfa_dispatch_counts(plan)[1] > 0) == (not dfa)
    set_arm(monkeypatch, arm)
    monkeypatch.setenv("PINGOO_CHAOS", "xla_error:1")
    ring = nr.Ring(str(tmp_path / "ring"), capacity=256, create=True)
    sidecar = nr.RingSidecar(ring, plan, lists, max_batch=16, device="cpu")
    monkeypatch.delenv("PINGOO_CHAOS")
    clock = FakeClock()
    sidecar.ladder._clock = clock
    try:
        n = 16
        first = generate_traffic(n, attack_fraction=0.5, seed=SEEDS[2],
                                 lists=lists)
        second = generate_traffic(n, attack_fraction=0.5, seed=SEEDS[3],
                                  lists=lists)
        got = serve(sidecar, ring, first, n)
        assert sidecar.chaos.injected == {"xla_error": 1}
        assert sidecar.ladder.demoted() == [rung]
        snap = sidecar.stats()["ladder"][rung]
        assert snap["errors"] == snap["demotions"] == 1
        assert "injected device error" in snap["last_error"]
        assert got == oracle_bytes(plan, lists, first)
        if rung == "dfa":
            assert plan.dfa_default_mode == "off"
        clock.t += 1.0  # the backoff is over: the next batch probes
        got2 = serve(sidecar, ring, second, 2 * n)
        assert sidecar.ladder.demoted() == []
        assert got2 == oracle_bytes(plan, lists, second)
        assert plan.dfa_default_mode == "auto"
        if arm == "force":
            assert sidecar.stats()["megastep"]["windows"] >= 2
            assert sidecar.mega_echo_mismatch == 0
    finally:
        sidecar.stop()
        ring.close()


def test_swap_while_ladder_demoted_serves_the_new_plan(tmp_path, monkeypatch):
    """After tests/test_hotswap.py: a swap landing while the device rung
    serves the interpreter applies cleanly, and the demoted rung serves
    the new plan."""
    monkeypatch.setenv("PINGOO_CHAOS", "xla_error:1")
    monkeypatch.setenv("PINGOO_DFA", "off")  # the device rung demotes
    ring = nr.Ring(str(tmp_path / "ring"), capacity=256, create=True)
    alpha, beta = two_rule_plan("/evil"), two_rule_plan("/beta")
    sidecar = nr.RingSidecar(ring, alpha, {}, max_batch=16, device="cpu")
    monkeypatch.delenv("PINGOO_CHAOS")
    sidecar.ladder._clock = FakeClock()  # no probe: demoted throughout
    try:
        n = 16
        first = requests(n)
        assert serve(sidecar, ring, first, n) \
            == oracle_bytes(alpha, {}, first)
        assert sidecar.ladder.demoted() == ["device"]
        handle = sidecar.request_swap(beta)
        second = requests(n, n)
        got = serve(sidecar, ring, second, 2 * n)
        assert handle.wait(1) and handle.result == "ok"
        assert sidecar.ruleset_epoch == 1 and sidecar.plan is beta
        assert sidecar.ladder.demoted() == ["device"]
        assert got == oracle_bytes(beta, {}, second)
        assert got != oracle_bytes(alpha, {}, second)
    finally:
        sidecar.stop()
        ring.close()


@pytest.mark.parametrize("arm", ["on", "force"])
def test_swap_storm_posts_every_ticket_once(crs, tmp_path, monkeypatch, arm):
    plan, lists = crs
    set_arm(monkeypatch, arm)
    monkeypatch.setenv("PINGOO_CHAOS", "swap_storm:1")
    ring = nr.Ring(str(tmp_path / "ring"), capacity=512, create=True)
    sidecar = nr.RingSidecar(ring, plan, lists, max_batch=8, device="cpu")
    try:
        reqs = generate_traffic(192, attack_fraction=0.5, seed=SEEDS[1],
                                lists=lists)
        got = serve(sidecar, ring, reqs, len(reqs))
        assert got == oracle_bytes(plan, lists, reqs)
        stats = sidecar.stats()
        assert stats["chaos"]["injected"]["swap_storm"] \
            == stats["hotswap"]["epoch"] >= 2
        assert sidecar.mega_echo_mismatch == 0
        assert sidecar.ladder.demoted() == []
    finally:
        sidecar.stop()
        ring.close()


def test_body_scanner_failure_demotes_body_and_fails_windows_open(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PINGOO_BODY_INSPECT", "on")
    plan = two_rule_plan()
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    sidecar = nr.RingSidecar(ring, plan, {}, max_batch=16, device="cpu")
    sidecar.ladder._clock = FakeClock()

    def broken(windows):
        raise RuntimeError("scanner lost")

    sidecar.body_scanner.scan_windows = broken
    try:
        body = b"a=1&b=UNION SELECT password FROM users"
        for flow in (11, 12):
            assert ring.enqueue_body(flow, 0, body, len(body),
                                     nr.BODY_FLAG_FINAL)
        assert ring.enqueue_body(13, 0, body[:8], 64, 0)  # not final
        reqs = requests(4)
        bodies = {}
        got = serve(sidecar, ring, reqs, len(reqs), bodies)
        assert got == oracle_bytes(plan, {}, reqs)
        assert bodies == {11 | nr.BODY_VERDICT_BIT: [0],
                          12 | nr.BODY_VERDICT_BIT: [0]}
        snap = sidecar.stats()["ladder"]["body"]
        assert not snap["healthy"] and snap["errors"] == 1
        assert snap["fallback"] == "metadata-only"
        assert "scanner lost" in snap["last_error"]
        assert sidecar.body_verdicts == 2
    finally:
        sidecar.stop()
        ring.close()


KILL_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.expr import compile_expression
rules = [RuleConfig(name="waf", actions=(Action.BLOCK,),
                    expression=compile_expression(
                        'http_request.path.starts_with("/evil")')),
         RuleConfig(name="bot", actions=(Action.BLOCK,),
                    expression=compile_expression(
                        'http_request.user_agent.contains("chaosbot")'))]
plan = compile_ruleset(rules, {}, device="cpu")
ring = nr.Ring(sys.argv[2], capacity=256)
sidecar = nr.RingSidecar(ring, plan, {}, max_batch=16, device="cpu")
print("epoch", sidecar.epoch, flush=True)
sidecar.run()  # PINGOO_CHAOS=kill ends this
"""


def test_kill_in_a_child_then_orphans_reevaluated_once(tmp_path):
    """`kill:1` SIGKILLs a sidecar child after its first completed batch,
    with a second batch dequeued and unposted; a new sidecar re-evaluates
    exactly those orphans, then serves the rest: every ticket posted
    once, with the interpreter's verdict."""
    ring = nr.Ring(str(tmp_path / "ring"), capacity=256, create=True)
    try:
        n = 64
        reqs = requests(n)
        tickets = enqueue_all(ring, reqs)
        env = dict(os.environ, PINGOO_CHAOS="pause:100:1,kill:1",
                   PINGOO_PIPELINE_DEPTH="2", PINGOO_SCHED_MODE="fixed")
        env.pop("PYTHONPATH", None)
        proc = subprocess.run(
            [sys.executable, "-c", KILL_CHILD, str(REPO),
             str(tmp_path / "ring")], env=env, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == -9, proc.stderr[-3000:]
        assert "epoch 1" in proc.stdout
        lv = ring.liveness()
        orphans = lv["req_tail"] - lv["posted_floor"]
        assert lv["epoch"] == 1 and orphans >= 1
        posted = {}
        while (v := ring.poll_verdict()) is not None:
            posted.setdefault(v[0], []).append(v[1])
        plan = two_rule_plan()
        sidecar = nr.RingSidecar(ring, plan, {}, max_batch=16, device="cpu")
        try:
            assert sidecar.epoch == 2
            assert sidecar.reconciled == {"reeval": orphans, "failopen": 0}
            rest = n - lv["req_tail"]
            t = threading.Thread(target=sidecar.run,
                                 kwargs={"max_requests": rest}, daemon=True)
            t.start()
            got = poll_all(ring, n - len(posted))
            t.join(60)
            assert not t.is_alive()
        finally:
            sidecar.stop()
        for k, v in got.items():
            posted.setdefault(k, []).extend(v)
        assert sorted(posted) == tickets
        assert all(len(a) == 1 for a in posted.values())
        assert bytes(posted[k][0] for k in tickets) \
            == oracle_bytes(plan, {}, reqs)
    finally:
        ring.close()


# -- what is never demoted, and the scorer ----------------------------------------------


def test_kernel_build_error_is_never_demoted(tmp_path, monkeypatch):
    plan = two_rule_plan()

    def unbuilt(*args, **kwargs):
        raise KernelBuildError("CUDA kernel build failed: nvcc exited 2")

    service = VerdictService(plan, {}, max_batch=8, device="cpu")
    service._verdict_fn = unbuilt
    with pytest.raises(KernelBuildError, match="nvcc"):
        service.evaluate_batch(requests(4))
    assert service.ladder.demoted() == []
    assert service.stats.snapshot()["device_errors"] == 0
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, {}, max_batch=8, device="cpu")
        sidecar._lane_fn = unbuilt
        enqueue_all(ring, requests(4))
        with pytest.raises(KernelBuildError, match="nvcc"):
            sidecar.run(max_requests=4)
        assert sidecar.ladder.demoted() == []
        assert ring.poll_verdict() is None
        sidecar.stop()
    finally:
        ring.close()


CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


@pytest.mark.parametrize("kind", ["runtime", "accelerator"])
@pytest.mark.parametrize("arm", ["on", "off", "force"])
def test_cuda_fault_at_the_sync_is_never_demoted(tmp_path, monkeypatch, arm,
                                                 kind):
    """A fault of one of the port's own kernels surfaces at the wait for
    its result; CUDA errors are sticky, so a rung that took it would
    serve the interpreter for the life of the process. It fails the
    batch on the Python plane and ends `run()` on the ring, as a
    DeviceFault, and no rung moves."""
    if kind == "accelerator" and not hasattr(torch, "AcceleratorError"):
        pytest.skip("this torch has no AcceleratorError")
    plan = two_rule_plan()
    set_arm(monkeypatch, arm)

    def faulted(x):
        if kind == "accelerator":
            raise torch.AcceleratorError(CUDA_FAULT)
        raise RuntimeError(CUDA_FAULT)

    for mod in (verdict_mod, service_mod, nr):
        monkeypatch.setattr(mod, "_host_array", faulted)
    service = VerdictService(plan, {}, max_batch=8, device="cpu")
    with pytest.raises(DeviceFault, match="illegal memory access"):
        service.evaluate_batch(requests(4))
    assert service.ladder.demoted() == []
    assert service.stats.snapshot()["device_errors"] == 0
    assert service.stats.host_fallback_batches == 0
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, {}, max_batch=8, device="cpu")
        enqueue_all(ring, requests(4))
        with pytest.raises(DeviceFault, match="illegal memory access"):
            sidecar.run(max_requests=4)
        assert sidecar.ladder.demoted() == []
        assert ring.poll_verdict() is None
        sidecar.stop()
    finally:
        ring.close()


def test_scorer_error_counts_and_serves_zero(monkeypatch):
    """As in the JAX package: a failing bot head is counted in
    `score_errors` and its batch is served with scores of 0.0 and its
    verdicts; the next batch is scored."""
    plan = two_rule_plan()
    params = botscore.init_params(torch.Generator().manual_seed(6),
                                  device="cpu")
    service = VerdictService(plan, {}, max_batch=8, device="cpu",
                             bot_score_params=params)
    reqs = requests(6)
    want = [service.evaluate_batch(reqs), None]
    real = botscore.score

    def broken(*args):
        raise RuntimeError("scorer lost")

    monkeypatch.setattr(botscore, "score", broken)
    lost = service.evaluate_batch(reqs)
    monkeypatch.setattr(botscore, "score", real)
    again = service.evaluate_batch(reqs)
    assert [v.bot_score for v in lost] == [0.0] * len(reqs)
    assert [v.action for v in lost] == [v.action for v in want[0]]
    assert [v.bot_score for v in again] == [v.bot_score for v in want[0]]
    assert all(0.0 < v.bot_score < 1.0 for v in again)
    snap = service.stats.snapshot()
    assert snap["score_errors"] == 1 and snap["device_errors"] == 0
    assert service.ladder.demoted() == []
