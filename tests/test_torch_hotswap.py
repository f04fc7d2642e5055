"""Ruleset hot-swap (engine/hotswap.py) in the port, against the JAX
package's plans: the counterpart of tests/test_hotswap.py.

A new plan flips in at a batch boundary on both planes: verdicts
admitted before the flip are bit-exact under the old plan, verdicts
after under the new one (each against the JAX package's evaluation of
that epoch's plan, rows and lanes), and no request or ticket is dropped
or answered twice. On the Python plane under PINGOO_PIPELINE=off and on
(full and compact staging) and PINGOO_MEGASTEP=force, with a swap racing
in-flight evaluates, `evaluate_batch` callers on other threads, a
rejected swap and the counters; on the sidecar in the same four arms, a
swap from another thread mid-drive, and a swap left at shutdown; and the
TenantPlanStore. CPU only, one ring per test, small batches.
"""

import asyncio
import dataclasses
import sys
from collections import deque
import threading
import time

import numpy as np
import pytest

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import RequestTuple as RefRequestTuple
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine import hotswap
from pingoo_tpu_torch.engine.batch import RequestTuple
from pingoo_tpu_torch.engine.hotswap import TenantPlanStore
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.expr import compile_expression
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

CLEARED_ENV = ("PINGOO_CHAOS", "PINGOO_DFA", "PINGOO_PREFILTER", "PINGOO_MESH",
               "PINGOO_SCHED_MODE", "PINGOO_PARITY_SAMPLE", "PINGOO_PIPELINE",
               "PINGOO_PIPELINE_DEPTH", "PINGOO_SCHED_PIPELINE",
               "PINGOO_STAGING", "PINGOO_STAGING_DEPTH", "PINGOO_MEGASTEP",
               "PINGOO_MEGASTEP_K", "PINGOO_BODY_INSPECT", "PINGOO_PROVE",
               "PINGOO_NFA_SPLIT")
ARMS = {"off": {"PINGOO_PIPELINE": "off"},
        "on": {"PINGOO_PIPELINE": "on"},
        "compact": {"PINGOO_PIPELINE": "on", "PINGOO_STAGING": "compact"},
        "force": {"PINGOO_PIPELINE": "on", "PINGOO_MEGASTEP": "force"}}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def set_arm(monkeypatch, arm):
    for name, value in ARMS[arm].items():
        monkeypatch.setenv(name, value)


def sources(prefix: str, extra: int = 0) -> list[str]:
    """A plan that blocks path.starts_with(prefix), a url pattern
    (prefilter and NFA), a host rule the device cannot take (interpreted
    on the host: a batch finished under the other epoch's plan would
    read the other host rule), and `extra` never-matching rules, so the
    two epochs' plans differ in shape, not only content."""
    host = prefix.strip("/")
    return ([f'http_request.path.starts_with("{prefix}")',
             f'http_request.url.matches("{prefix}/[0-9]+5$")',
             f'http_request.host + ":" == "{host}.test:"']
            + [f'http_request.path.starts_with("/never/{i}/")'
               for i in range(extra)])


def both_plans(srcs):
    ref = ref_compile([RefRuleConfig(name=f"r{i}", actions=(RefAction.BLOCK,),
                                     expression=ref_compile_expression(s))
                       for i, s in enumerate(srcs)], {})
    port = compile_ruleset([RuleConfig(name=f"r{i}", actions=(Action.BLOCK,),
                                       expression=compile_expression(s))
                            for i, s in enumerate(srcs)], {}, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def epochs():
    """(ref, port) of epoch 0 (/alpha) and of epoch 1 (/beta, 3 more
    rules)."""
    return both_plans(sources("/alpha")), both_plans(sources("/beta", 3))


def stream(n: int, offset: int = 0) -> list[RequestTuple]:
    out = []
    for i in range(offset, offset + n):
        head = ("/alpha", "/beta", "/ok")[i % 3]
        host = ("alpha.test", "beta.test", "r.test", "r.test")[i % 4]
        out.append(RequestTuple(path=f"{head}/{i}", url=f"{head}/{i}",
                                host=host, user_agent="Mozilla/5.0",
                                ip=f"10.0.{i % 7}.{i % 200}"))
    return out


def want(ref, reqs):
    """The JAX package's rows and ring action bytes for `reqs` under
    `ref`."""
    ref_reqs = [RefRequestTuple(**dataclasses.asdict(r)) for r in reqs]
    rows = np.asarray(ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(ref_reqs, ref.field_specs), {}))
    act, vb = ref_verdict.action_lanes(ref, rows)
    return rows, act, vb, bytes(int(a) | (int(b) << 2)
                                for a, b in zip(act, vb))


def check_epoch_verdicts(epochs, reqs, verdicts, wants=None):
    """Every verdict bit-exact under its own epoch's plan (`wants`: each
    epoch's `want` of `reqs`, where computed already)."""
    wants = wants or [want(ref, reqs) for ref, _ in epochs]
    for i, v in enumerate(verdicts):
        assert v.epoch in (0, 1) and not v.degraded
        rows, act, vb, _ = wants[v.epoch]
        np.testing.assert_array_equal(v.matched, rows[i], err_msg=str(i))
        assert (v.action, v.verified_block) == (int(act[i]), bool(vb[i])), i
    return {v.epoch for v in verdicts}


# -- the Python plane: VerdictService.swap_plan -------------------------------


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_service_swap_bit_exact_per_epoch(epochs, monkeypatch, arm):
    """A swap races a wave of in-flight evaluates: the wave admitted
    before the sentinel rides epoch 0, the tail epoch 1."""
    set_arm(monkeypatch, arm)
    (_, p0), (_, p1) = epochs
    reqs = stream(48)

    async def run():
        service = VerdictService(p0, {}, max_batch=8, max_wait_us=500,
                                 device="cpu")
        await service.start()
        try:
            first = [asyncio.ensure_future(service.evaluate(r))
                     for r in reqs[:24]]
            res = await service.swap_plan(p1)
            rest = [asyncio.ensure_future(service.evaluate(r))
                    for r in reqs[24:]]
            return service, res, await asyncio.gather(*first, *rest)
        finally:
            await service.stop()

    service, res, verdicts = asyncio.run(run())
    assert res["epoch"] == 1 == service.ruleset_epoch
    assert res["tenant"] == "default" and res["pause_ms"] >= 0
    assert service.plan is p1
    assert check_epoch_verdicts(epochs, reqs, verdicts) == {0, 1}
    assert all(v.epoch == 1 for v in verdicts[24:])
    assert service.mega_echo_mismatch == 0
    if arm == "force":
        assert service._mega_runner.program is not None
    snap = service.stats.snapshot()["hotswap"]
    assert snap["epoch"] == 1 and snap["swaps"].get("default/ok", 0) >= 1
    if arm == "compact":
        assert service.stage_caps is not None


def test_service_swaps_twice_and_back(epochs, monkeypatch):
    """Two swaps in a row (to /beta, back to /alpha): epochs 1 and 2,
    each batch on its epoch's plan."""
    (_, p0), (_, p1) = epochs
    reqs = stream(12)

    async def run():
        service = VerdictService(p0, {}, max_batch=8, device="cpu")
        await service.start()
        try:
            out = []
            for plan in (None, p1, p0):
                if plan is not None:
                    await service.swap_plan(plan)
                out.append(await asyncio.gather(*map(service.evaluate,
                                                     reqs)))
            return service, out
        finally:
            await service.stop()

    service, out = asyncio.run(run())
    assert service.ruleset_epoch == 2
    for e, verdicts in enumerate(out):
        assert {v.epoch for v in verdicts} == {e}
        ref = epochs[e % 2][0]
        rows = want(ref, reqs)[0]
        np.testing.assert_array_equal(
            np.stack([v.matched for v in verdicts]), rows)


def test_service_flip_waits_for_evaluate_batch_threads(epochs):
    """Callers of `evaluate_batch` on other threads: the flip waits for
    their batches in flight, later ones wait for the flip, and each
    batch is served whole on one epoch's plan."""
    (_, p0), (_, p1) = epochs
    reqs = stream(16)
    results, errors = [], []
    stop = threading.Event()

    async def run():
        service = VerdictService(p0, {}, max_batch=16, device="cpu")
        await service.start()

        def caller():
            try:
                while not stop.is_set():
                    results.append(service.evaluate_batch(reqs))
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=caller) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            await asyncio.sleep(0.3)
            res = await service.swap_plan(p1)
            await asyncio.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
            await service.stop()
        assert not any(t.is_alive() for t in threads)
        return res

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: races show
    try:
        res = asyncio.run(run())
    finally:
        sys.setswitchinterval(interval)
    assert not errors and res["epoch"] == 1
    wants = [want(ref, reqs) for ref, _ in epochs]
    epochs_seen = set()
    for verdicts in results:
        batch_epochs = {v.epoch for v in verdicts}
        assert len(batch_epochs) == 1
        epochs_seen |= batch_epochs
        check_epoch_verdicts(epochs, reqs, verdicts, wants)
    assert epochs_seen == {0, 1}


def test_rejected_swap_keeps_the_old_plan(epochs, monkeypatch):
    """A state that fails to warm up rejects the swap: swap_plan raises,
    the epoch stays, the old plan serves, and the rejection is counted."""
    (_, p0), (_, p1) = epochs
    reqs = stream(6)

    async def run():
        service = VerdictService(p0, {}, max_batch=8, device="cpu")
        await service.start()
        try:
            def broken(state):
                raise RuntimeError("warm-up failed")

            monkeypatch.setattr(service, "_warm_state", broken)
            with pytest.raises(RuntimeError, match="warm-up failed"):
                await service.swap_plan(p1, tenant="acme")
            return service, await asyncio.gather(*map(service.evaluate,
                                                      reqs))
        finally:
            await service.stop()

    service, verdicts = asyncio.run(run())
    assert service.ruleset_epoch == 0 and service.plan is p0
    assert check_epoch_verdicts(epochs, reqs, verdicts) == {0}
    assert hotswap.swap_counts("python").get("acme/rejected", 0) >= 1


def test_swap_needs_a_started_service(epochs):
    (_, p0), (_, p1) = epochs
    service = VerdictService(p0, {}, device="cpu")
    with pytest.raises(RuntimeError, match="started"):
        asyncio.run(service.swap_plan(p1))


def test_swap_counters_and_epoch(epochs):
    (_, p0), (_, p1) = epochs
    before = hotswap.swap_counts("python").get("acme/ok", 0)

    async def run():
        service = VerdictService(p0, {}, device="cpu")
        await service.start()
        try:
            return service, await service.swap_plan(p1, tenant="acme")
        finally:
            await service.stop()

    service, res = asyncio.run(run())
    assert res["tenant"] == "acme" == service.tenant
    assert hotswap.swap_counts("python")["acme/ok"] == before + 1
    assert hotswap.epoch_of("python") == res["epoch"]


# -- the sidecar plane: RingSidecar.request_swap --------------------------------


def start_sidecar(ring, plan, **kw):
    sidecar = nr.RingSidecar(ring, plan, {}, max_batch=8, device="cpu", **kw)
    errors = []

    def run():
        try:
            sidecar.run()
        except Exception as exc:
            errors.append(exc)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return sidecar, thread, errors


def drive(ring, reqs):
    return nr.drive_stream(ring, nr.pack_requests(reqs), timeout_s=300,
                           idle_s=nr.DRIVE_IDLE_S)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_sidecar_swap_bit_exact_per_epoch(epochs, tmp_path, monkeypatch,
                                          arm):
    set_arm(monkeypatch, arm)
    (r0, p0), (r1, p1) = epochs
    ring = nr.Ring(str(tmp_path / "ring"), capacity=256, create=True)
    try:
        sidecar, thread, errors = start_sidecar(ring, p0)
        boot_runner = sidecar._mega_runner
        try:
            a = drive(ring, stream(24))
            handle = sidecar.request_swap(p1, tenant="acme")
            assert handle.wait(120) and handle.result == "ok"
            assert handle.epoch == sidecar.ruleset_epoch == 1
            assert handle.pause_ms >= 0
            b = drive(ring, stream(24, offset=24))
        finally:
            sidecar.stop()
            thread.join(30)
        assert not errors and not thread.is_alive()
        assert ring.poll_verdict() is None
    finally:
        ring.close()
    assert a.actions == want(r0, stream(24))[3]
    assert b.actions == want(r1, stream(24, offset=24))[3]
    assert sidecar.plan is p1 and sidecar.tenant == "acme"
    assert len(sidecar.swap_pauses_ms) == 1
    stats = sidecar.stats()
    assert stats["hotswap"]["epoch"] == 1
    assert stats["hotswap"]["swaps"].get("acme/ok", 0) >= 1
    assert stats["megastep"]["echo_mismatch"] == 0
    if arm == "force":
        assert stats["megastep"]["windows"] > 0
        # The new plan's windows run on its own graph runner.
        assert sidecar._mega_runner is not boot_runner
        assert sidecar._mega_runner.program is not boot_runner.program


@pytest.mark.parametrize("arm", ["on", "force"])
def test_sidecar_swap_from_another_thread_mid_drive(epochs, tmp_path,
                                                    monkeypatch, arm):
    """request_swap from another thread while the stream is being
    drained: each ticket posts once, and the tickets form a prefix on
    the old plan and a suffix on the new one."""
    set_arm(monkeypatch, arm)
    (r0, p0), (r1, p1) = epochs
    reqs = stream(240)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=256, create=True)
    handles = []
    try:
        sidecar, thread, errors = start_sidecar(ring, p0)

        def requester():
            while sidecar.processed < 40:
                time.sleep(0.001)
            handles.append(sidecar.request_swap(p1))

        req_thread = threading.Thread(target=requester)
        req_thread.start()
        try:
            first = drive(ring, reqs[:160])
            req_thread.join(120)
            assert handles and handles[0].wait(120)
            second = drive(ring, reqs[160:])
        finally:
            sidecar.stop()
            thread.join(30)
        assert not errors and not thread.is_alive()
        assert ring.poll_verdict() is None
    finally:
        ring.close()
    got = first.actions + second.actions
    w0, w1 = want(r0, reqs)[3], want(r1, reqs)[3]
    # The longest prefix on the old plan, the longest suffix on the new.
    prefix = next((i for i in range(len(got)) if got[i] != w0[i]), len(got))
    suffix = next((i for i in range(len(got), 0, -1)
                   if got[i - 1] != w1[i - 1]), 0)
    assert suffix <= prefix, (suffix, prefix)
    assert 40 <= prefix and suffix <= 160
    assert handles[0].result == "ok" and sidecar.ruleset_epoch == 1
    assert sidecar.mega_echo_mismatch == 0


@pytest.mark.parametrize("arm", ["on", "force"])
def test_sidecar_flip_finishes_in_flight_work_on_the_old_plan(
        epochs, tmp_path, monkeypatch, arm):
    """A batch in flight (`on`) or a slice staged into the open window
    (`force`) when the flip comes is launched and completed on the old
    plan, host rules included, before the new state is adopted."""
    set_arm(monkeypatch, arm)
    (r0, p0), (_, p1) = epochs
    reqs = stream(8)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, p0, {}, max_batch=8, device="cpu")
        for m, h, p, u, ua, ip, port, asn, cc in nr.pack_requests(reqs):
            assert ring.enqueue(method=m, host=h, path=p, url=u,
                                user_agent=ua, ip=ip, port=port, asn=asn,
                                country=cc) is not None
        slot_buf = sidecar._take_slot_buf()
        parts = sidecar._dequeue(slot_buf)
        inflight = deque()
        if arm == "force":
            assert sidecar._mega_begin()
            sidecar._stage_mega_slice(parts, slot_buf)
        else:
            inflight.append(sidecar._dispatch(parts, slot_buf))
        handle = sidecar.request_swap(p1)
        assert not handle.done.is_set()
        sidecar._apply_swaps(inflight)
        assert handle.result == "ok" and sidecar.ruleset_epoch == 1
        assert not inflight and not sidecar._mega_staged
        got = {}
        while (v := ring.poll_verdict()) is not None:
            got[v[0]] = v[1]
    finally:
        ring.close()
    assert bytes(got[t] for t in sorted(got)) == want(r0, reqs)[3]
    assert want(r0, reqs)[3] != want(epochs[1][0], reqs)[3]
    assert sidecar.mega_echo_mismatch == 0


def test_sidecar_swap_left_at_shutdown_is_rejected(epochs, tmp_path):
    (_, p0), (_, p1) = epochs
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, p0, {}, max_batch=8, device="cpu")
        handle = sidecar.request_swap(p1)
        sidecar._stop = True
        sidecar.run()
        sidecar.stop()
    finally:
        ring.close()
    assert handle.wait(1) and handle.result == "rejected"
    assert isinstance(handle.error, RuntimeError)
    assert sidecar.ruleset_epoch == 0 and sidecar.plan is p0


def test_sidecar_failed_build_raises_and_keeps_serving(epochs, tmp_path,
                                                       monkeypatch):
    (r0, p0), (_, p1) = epochs
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar, thread, errors = start_sidecar(ring, p0)
        try:
            def broken(state, hb=False):
                raise RuntimeError("capture failed")

            monkeypatch.setattr(sidecar, "_warm_state", broken)
            with pytest.raises(RuntimeError, match="capture failed"):
                sidecar.request_swap(p1, tenant="globex")
            res = drive(ring, stream(12))
        finally:
            sidecar.stop()
            thread.join(30)
        assert not errors
    finally:
        ring.close()
    assert res.actions == want(r0, stream(12))[3]
    assert sidecar.ruleset_epoch == 0
    assert hotswap.swap_counts("sidecar").get("globex/rejected", 0) >= 1


# -- the multi-tenant compile-ahead store -----------------------------------------


def tenant_rules(tenant: str, n: int = 2):
    return [RuleConfig(name=f"{tenant}-r{i}", actions=(Action.BLOCK,),
                       expression=compile_expression(
                           f'http_request.path.starts_with("/{tenant}/{i}/")'))
            for i in range(n)]


def test_tenant_scoped_fingerprints(tmp_path):
    """Identical rules under different tenants cache and fingerprint
    separately."""
    store = TenantPlanStore(cache_dir=str(tmp_path), device="cpu")
    shared = tenant_rules("shared", 3)
    tenants = ["acme", "globex", "initech", "umbrella"]
    entries = {t: store.prepare(t, shared, {}) for t in tenants}
    assert len({e.fingerprint for e in entries.values()}) == len(tenants)
    assert len(list(tmp_path.iterdir())) == len(tenants)
    assert store.tenants() == sorted(tenants)
    assert store.total_rules() == 3 * len(tenants)
    for t in tenants:
        assert store.get(t) is entries[t]
        assert entries[t].plan.device.type == "cpu"
        assert [r.name for r in entries[t].plan.rules][0] == "shared-r0"
    assert store.get("nosuch") is None


def test_failed_prepare_keeps_serving_plan(tmp_path):
    store = TenantPlanStore(cache_dir=str(tmp_path), device="cpu")
    good = store.prepare("acme", tenant_rules("acme"), {})
    with pytest.raises(Exception):
        store.prepare("acme", [object()], {})
    assert store.get("acme") is good


def test_multi_tenant_scale_2k_rules(tmp_path):
    """Four tenants, 2,048 rules in all, each compiled, fingerprinted and
    cached on its own; a re-prepare hits the tenant's artifact."""
    store = TenantPlanStore(cache_dir=str(tmp_path), device="cpu")
    tenants = ["acme", "globex", "initech", "umbrella"]
    for t in tenants:
        store.prepare(t, tenant_rules(t, 512), {})
    assert store.total_rules() == 2048
    assert len({store.get(t).fingerprint for t in tenants}) == 4
    fp0 = store.get("acme").fingerprint
    again = store.prepare("acme", tenant_rules("acme", 512), {})
    assert again.fingerprint == fp0 and store.get("acme") is again


def test_prepared_tenant_plan_swaps_into_service(tmp_path):
    store = TenantPlanStore(cache_dir=str(tmp_path), device="cpu")
    acme = store.prepare("acme", tenant_rules("acme"), {})
    globex = store.prepare("globex", tenant_rules("globex"), {})

    async def run():
        service = VerdictService(acme.plan, acme.lists, device="cpu")
        await service.start()
        try:
            res = await service.swap_plan(globex.plan, lists=globex.lists,
                                          tenant="globex")
            hit = await service.evaluate(RequestTuple(path="/globex/0/x",
                                                      url="/globex/0/x"))
            miss = await service.evaluate(RequestTuple(path="/acme/0/x",
                                                       url="/acme/0/x"))
            return service, res, hit, miss
        finally:
            await service.stop()

    service, res, hit, miss = asyncio.run(run())
    assert res["tenant"] == "globex" == service.tenant
    assert hit.action == 1 and hit.epoch == res["epoch"] == 1
    assert miss.action == 0
