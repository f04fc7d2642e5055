"""The port's megastep (PINGOO_MEGASTEP=force) against the JAX package.

  * The knobs: `off`, `force` and other values resolve as in the JAX
    package, `auto` raises naming its ROADMAP item, and the K cap and
    ladder are the JAX package's.
  * `DeviceInputQueue`: the stacks equal the JAX package's after the same
    `fill_slice` sequence with narrowing and widening widths; a window's
    shipped slices are the JAX package's, padded slices zero rows with
    n_valid 0; a held set survives later checkouts, and with every set
    out `checkout(block=False)` raises.
  * `make_megastep_fn`, both kinds: on the JAX package's
    TestMegastepProgramParity slices (16, 13, 16, 5 live rows of 16) and
    on CRS traffic at 64 rows a slice, it equals the JAX package's
    `make_megastep_fn` and the port's per-batch path, the epoch echoed.
  * `PipelineStats.note_megastep` gives the JAX package's snapshot, and
    the launch recorder of a capture counts at each replay only; a dead
    entry's graph is destroyed only when no capture is under way.
  * VerdictService and RingSidecar under `off` and `force` (K=4) give
    equal verdicts, equal to the JAX package's `off`; the Python plane's
    K is 1 unless PINGOO_MEGASTEP_K is set; the sidecar stream
    (400 requests, max_batch=8, a 256-slot ring) splits into more than
    40 slices, with no epoch echo mismatch, under either executor.
  * The window-reuse case: with host rules, a window completes only
    after two later windows were staged and launched, and its verdicts
    are the JAX package's for the same requests. Under `force` the
    sidecar's warm-up runs windows, one of every K it ships.
  * A megastep error raises on both planes; nothing falls back to the
    per-batch path.

CPU only, small plans, shm rings and no httpd; the tolerance is zero.
"""

import asyncio
import dataclasses
import random
import threading
import weakref

import numpy as np
import pytest
import torch

from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import DeviceInputQueue as RefQueue
from pingoo_tpu.engine.batch import RequestBatch as RefBatch
from pingoo_tpu.engine.batch import RequestTuple as RefRequestTuple
from pingoo_tpu.engine.batch import bucket_arrays as ref_bucket
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.engine.batch import pad_batch as ref_pad
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.obs.pipeline import PipelineStats as RefPipelineStats
from pingoo_tpu.obs.registry import MetricRegistry
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch import device as port_device
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine import graphs
from pingoo_tpu_torch.engine import verdict
from pingoo_tpu_torch.engine.batch import (DeviceInputQueue, RequestBatch,
                                           RequestTuple)
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.expr import Ip, compile_expression
from pingoo_tpu_torch.obs.pipeline import PipelineStats
from pingoo_tpu_torch.ops import _build
from pingoo_tpu_torch.utils.crs import generate_ruleset
from test_parity import (ACTIONS, HOST_FALLBACK_SOURCES, LISTS, RULE_SOURCES,
                         random_requests)
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
# The JAX package's one-batch chain, which the port is held to.
REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_SCHED_MODE": "fixed",
           "PINGOO_MEGASTEP": "off"}
CLEARED_ENV = ("PINGOO_CHAOS", "PINGOO_DFA", "PINGOO_PREFILTER",
               "PINGOO_MESH", "PINGOO_PARITY_SAMPLE", "PINGOO_PIPELINE",
               "PINGOO_PIPELINE_DEPTH", "PINGOO_SCHED_PIPELINE",
               "PINGOO_SCHED_FAILOPEN", "PINGOO_STAGING",
               "PINGOO_PROVENANCE", "PINGOO_BODY_INSPECT", "PINGOO_MEGASTEP",
               "PINGOO_MEGASTEP_K")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


def port_lists(lists):
    return {k: [Ip(str(v)) if hasattr(v, "contains") else v for v in vals]
            for k, vals in lists.items()}


def both_plans(sources, actions=ACTIONS):
    """The same rules compiled by both packages (on the CPU)."""
    ref_rules = [RefRuleConfig(name=f"r{i}",
                               expression=ref_compile_expression(s),
                               actions=actions)
                 for i, s in enumerate(sources)]
    rules = [RuleConfig(name=f"r{i}", expression=compile_expression(s),
                        actions=tuple(Action(a.value) for a in actions))
             for i, s in enumerate(sources)]
    return (ref_compile(ref_rules, LISTS),
            compile_ruleset(rules, port_lists(LISTS), device="cpu"))


@pytest.fixture(scope="module")
def parity():
    return both_plans(RULE_SOURCES)


@pytest.fixture(scope="module")
def crs60():
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    return (ref_compile(ref_rules, ref_lists), ref_lists,
            compile_ruleset(rules, lists, device="cpu"), lists)


# -- the knobs ------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "off", "auto", "force", "warp", ""])
def test_mode_resolves_as_the_reference(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("PINGOO_MEGASTEP", value)
    assert verdict._resolve_megastep_mode() \
        == ref_verdict._resolve_megastep_mode()


def test_auto_raises_naming_item_9(monkeypatch, crs60, tmp_path):
    """`auto`, refused before port queue item 9, is served: both planes
    build their graph runner under it. The mesh, item 9b, still raises."""
    _, _, plan, lists = crs60
    monkeypatch.setenv("PINGOO_MEGASTEP", "auto")
    port_device.check_env()
    service = VerdictService(plan, lists, device="cpu")
    assert service._mega_mode == "auto" and service._mega_runner is not None
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, lists, device="cpu")
        sidecar.stop()
        assert sidecar.stats()["megastep"]["mode"] == "auto"
        assert sidecar._mega_runner is not None
    finally:
        ring.close()
    with monkeypatch.context() as mp:
        mp.setenv("PINGOO_MESH", "2x1x1")
        with pytest.raises(NotImplementedError, match="item 9b"):
            port_device.check_env()
    for ok in ("off", "force", "warp"):
        monkeypatch.setenv("PINGOO_MEGASTEP", ok)
        port_device.check_env()


@pytest.mark.parametrize("k", [None, "1", "3", "4", "8", "0", "-2", "bogus"])
def test_k_cap_and_ladder_equal_the_reference(monkeypatch, k):
    if k is not None:
        monkeypatch.setenv("PINGOO_MEGASTEP_K", k)
    port_device.check_env()
    assert verdict.megastep_k_cap() == ref_verdict.megastep_k_cap()
    for k_max in range(-1, 20):
        assert verdict.megastep_k_ladder(k_max) \
            == ref_verdict.megastep_k_ladder(k_max)


# -- DeviceInputQueue ---------------------------------------------------------------


def ref_batch(reqs, specs, pad):
    raw = ref_encode(reqs, specs)
    return ref_pad(RefBatch(size=raw.size, arrays=ref_bucket(raw.arrays)),
                   pad)


def width_batch(path_len, seed, n=4):
    rng = random.Random(seed)
    reqs = [RequestTuple(host="h.test", url="/u" + "q" * rng.randrange(8),
                         path="/" + "p" * (path_len - 1),
                         user_agent="ua" * rng.randrange(1, 20),
                         ip=f"10.0.{seed % 250}.{i}", asn=seed + i)
            for i in range(n)]
    return ref_batch(reqs, None, n)


def test_queue_stacks_equal_the_reference():
    """Three windows on two sets, slices narrowing and widening: the
    stacks, widths and shipped windows are the JAX package's (the port's
    free list hands the sets out in the JAX package's order here)."""
    port, ref = DeviceInputQueue(3, 4, nbuf=2), RefQueue(3, 4, nbuf=2)
    windows = [(200, 120, 9), (5, 150, 20), (60, 7)]
    held = []
    for w, lens in enumerate(windows):
        pb, rb = port.checkout(block=False), ref.checkout()
        assert pb == rb
        for j, plen in enumerate(lens):
            b = width_batch(plen, 10 * w + j)
            port.fill_slice(pb, j, b.arrays, 4 - j % 2, epoch=w)
            ref.fill_slice(rb, j, b.arrays, 4 - j % 2, epoch=w)
        for name, stack in ref._bufs[rb].items():
            np.testing.assert_array_equal(port._bufs[pb][name], stack, name)
        assert port._widths[pb] == ref._widths[rb]
        for pad in (0, 3):
            got = port.device_stack(pb, len(lens), pad_to=pad)
            want = ref.device_stack(rb, len(lens), pad_to=pad)
            for g, x in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
            k = len(lens)  # past the filled slices the JAX package
            for name, x in want[0].items():  # ships stale bytes
                x = np.asarray(x)
                g = got[0][name].numpy()
                assert g.shape == x.shape, name
                np.testing.assert_array_equal(g[:k], x[:k].astype(g.dtype),
                                              name)
                assert not g[k:].any(), name
        held.append(pb)
        if len(held) == 2:
            port.release(held.pop(0))


def test_queue_pads_with_zero_rows():
    """Slices shipped past the filled ones are zero rows with n_valid 0,
    whatever the set held; the filled ones are unchanged."""
    q = DeviceInputQueue(4, 4, nbuf=1)
    buf = q.checkout(block=False)
    for j in range(4):
        q.fill_slice(buf, j, width_batch(40, j).arrays, 4, epoch=1)
    q.release(buf)
    buf = q.checkout(block=False)
    fresh = width_batch(20, 9)
    q.fill_slice(buf, 0, fresh.arrays, 3, epoch=5)
    stacked, nv, ep = q.device_stack(buf, 1, pad_to=4)
    assert nv.tolist() == [3, 0, 0, 0] and int(ep[0]) == 5
    for name, t in stacked.items():
        assert not t[1:].any(), name
        want = fresh.arrays[name]
        np.testing.assert_array_equal(t[0].numpy(), want.astype(
            t.numpy().dtype), name)
    assert q.window_shape(buf, 9)["url_bytes"][0] == 4  # capped at K


def test_window_layout_holds_the_shipped_window():
    """The one flat buffer a window is uploaded in: each array's view
    (at a 256-byte boundary) holds what `device_stack` ships."""
    q = DeviceInputQueue(4, 8, nbuf=1)
    buf = q.checkout(block=False)
    for j, plen in enumerate((70, 9, 33)):
        q.fill_slice(buf, j, width_batch(plen, j, n=8).arrays, 8 - j,
                     epoch=j)
    stacked, nv, ep = q.device_stack(buf, 3, pad_to=4)
    flat, views = q.empty_inputs(buf, 4, "cpu")
    offsets = [v.data_ptr() - flat.data_ptr() for v in views.values()]
    assert all(o % 256 == 0 for o in offsets) and len(set(offsets)) == 15 + 2
    assert max(offsets) < flat.numel()
    q._pack(buf, 3, {n: v.numpy() for n, v in views.items()})
    for name, t in dict(stacked, n_valid=nv, epoch=ep).items():
        assert views[name].dtype == t.dtype, name
        assert torch.equal(views[name], t), name


def test_queue_held_set_survives_later_checkouts():
    import time

    q = DeviceInputQueue(2, 4, nbuf=3)
    held = q.checkout(block=False)
    q.fill_slice(held, 0, width_batch(30, 1).arrays, 4, epoch=0)
    view = q.slice_view(held, 0, 4)
    frozen = {k: v.copy() for k, v in view.items()}
    for seed in range(6):  # the other sets, filled and released in turn
        b = q.checkout(block=False)
        assert b != held
        q.fill_slice(b, 0, width_batch(200, seed).arrays, 4, epoch=1)
        q.fill_slice(b, 1, width_batch(9, seed).arrays, 4, epoch=1)
        q.release(b)
    others = [q.checkout(block=False) for _ in range(2)]
    for k, v in frozen.items():
        np.testing.assert_array_equal(view[k], v, k)
    with pytest.raises(RuntimeError, match="checked out"):
        q.checkout(block=False)
    got = []
    waiter = threading.Thread(target=lambda: got.append(q.checkout()))
    waiter.start()
    time.sleep(0.2)
    assert waiter.is_alive() and not got
    q.release(held)
    waiter.join(10)
    assert got == [held]
    assert q._bufs[held]["n_valid"].tolist() == [0, 0]
    for b in others + got:
        q.release(b)
    assert sorted(q._free) == [0, 1, 2]


# -- make_megastep_fn -----------------------------------------------------------


def run_both(ref, port, batches, ns, kind, k_ship=None, epoch=3, **kw):
    """One window of `batches` through both packages' megastep."""
    B = batches[0].size
    K = k_ship or len(batches)
    rq = RefQueue(K, B, field_specs=ref.field_specs)
    pq = DeviceInputQueue(K, B, field_specs=port.field_specs)
    rb, pb = rq.checkout(), pq.checkout(block=False)
    for j, (n, b) in enumerate(zip(ns, batches)):
        rq.fill_slice(rb, j, b.arrays, n, epoch=epoch)
        pq.fill_slice(pb, j, b.arrays, n, epoch=epoch)
    want = [np.asarray(x) for x in ref_verdict.make_megastep_fn(
        ref, kind=kind, **kw).fn(ref.device_tables(),
                                 *rq.device_stack(rb, len(ns)))]
    got = verdict.make_megastep_fn(port, kind=kind, **kw).fn(
        port.np_tables, *pq.device_stack(pb, len(ns), pad_to=K))
    return want, [x.numpy() for x in got], pq, pb


def per_batch(port, kind, b, n, **kw):
    if kind == "matrix":
        return verdict.make_verdict_fn(port)(port.np_tables, b.arrays).numpy()
    out = verdict.make_lane_fn(port, **kw)(port.np_tables, b.arrays,
                                           n_valid=n)
    return out[0].numpy() if kw.get("with_rule_hits") else out.numpy()


@pytest.mark.parametrize("kind", ["matrix", "lanes"])
def test_program_equals_reference_and_per_batch(parity, kind):
    """The JAX package's TestMegastepProgramParity window: K=4 slices of
    16 rows with 16, 13, 16 and 5 live."""
    ref, port = parity
    ns = (16, 13, 16, 5)
    batches = [ref_batch(random_requests(random.Random(40 + j), n),
                         ref.field_specs, 16) for j, n in enumerate(ns)]
    want, got, _, _ = run_both(ref, port, batches, ns, kind)
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2].tolist() == want[3].tolist() == [3, 3, 3, 3]
    assert got[1].shape == (4, 0)
    for j, (n, b) in enumerate(zip(ns, batches)):
        np.testing.assert_array_equal(got[0][j], per_batch(port, kind, b, n))


@pytest.mark.parametrize("kind", ["matrix", "lanes"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_program_on_crs_traffic(crs60, kind, seed):
    """CRS traffic at 64 rows a slice, three slices shipped as four (the
    fourth a zero slice), the lanes with rule hits masked by n_valid."""
    ref, ref_lists, port, _ = crs60
    ns = (64, 41, 64)
    batches = [ref_batch(ref_generate_traffic(
        n, attack_fraction=0.3, seed=seed + j, lists=ref_lists),
        ref.field_specs, 64) for j, n in enumerate(ns)]
    kw = {"with_rule_hits": True} if kind == "lanes" else {}
    want, got, _, _ = run_both(ref, port, batches, ns, kind, k_ship=4,
                               epoch=seed % 100, **kw)
    np.testing.assert_array_equal(got[0][:3], want[0])
    np.testing.assert_array_equal(got[1][:3], want[1])
    assert got[2].tolist()[:3] == want[3].tolist()
    assert got[0][:3].any()
    for j, (n, b) in enumerate(zip(ns, batches)):
        np.testing.assert_array_equal(got[0][j],
                                      per_batch(port, kind, b, n, **kw))


def test_finish_megastep_equals_the_reference(parity):
    ref, port = parity
    lists = port_lists(LISTS)
    ns = (16, 13, 16, 5)
    batches = [ref_batch(random_requests(random.Random(40 + j), n),
                         ref.field_specs, 16) for j, n in enumerate(ns)]
    want, got, pq, pb = run_both(ref, port, batches, ns, "matrix")
    stacked, _, _ = pq.device_stack(pb, 4)
    slices = [(16 * j, n) for j, n in enumerate(ns)]
    stitched = {name: np.concatenate(list(t.numpy()))
                for name, t in stacked.items()}
    ref_stitched = dict(stitched, ip=stitched["ip"].astype(np.uint32))
    np.testing.assert_array_equal(
        verdict.finish_megastep(port, torch.from_numpy(got[0]), slices,
                                RequestBatch(size=64, arrays=stitched),
                                lists),
        ref_verdict.finish_megastep(ref, want[0], slices,
                                    RefBatch(size=64, arrays=ref_stitched),
                                    LISTS))


# -- telemetry and launch counts ----------------------------------------------------


def test_note_megastep_equals_the_reference():
    port = PipelineStats("test", 3)
    ref = RefPipelineStats("test", 3, registry=MetricRegistry())
    assert port.snapshot()["megastep"] == ref.snapshot()["megastep"]
    for k, mode in ((4, "force"), (1, "force"), (2, "auto"), (0, "force")):
        port.note_megastep(k, mode)
        ref.note_megastep(k, mode)
        assert port.snapshot()["megastep"] == ref.snapshot()["megastep"]


def test_capture_launches_count_at_replay_only(monkeypatch):
    kernel = _build.Kernel("prefilter", "pingoo_prefilter_chunk", [])
    kernel._fn = lambda *args: 0
    kernel._err = lambda rc: b"unused"
    monkeypatch.setitem(_build.KERNELS, "prefilter", kernel)
    kernel.launch()
    with _build.record_launches() as rec:
        kernel.launch()
        kernel.launch()
        seen = []
        t = threading.Thread(target=lambda: (kernel.launch(),
                                             seen.append(1)))
        t.start()
        t.join()
    assert rec == {"prefilter": 2} and kernel.launches == 2
    _build.add_launches(rec)
    _build.add_launches(rec)
    assert kernel.launches == 6


def test_dead_graphs_wait_for_the_capture_lock(monkeypatch):
    """A dead entry's graph outlives its last reference, dropped on any
    thread, until `_free_released` finds no capture under way."""
    class FakeGraph:
        pass

    released = []
    monkeypatch.setattr(graphs, "_RELEASED", released)
    fake = FakeGraph()
    alive = weakref.ref(fake)
    cache = {"key": graphs._Graph(fake, "inputs", "outputs", {})}
    del fake
    t = threading.Thread(target=cache.clear)
    t.start()
    t.join()
    assert released == [(alive(), "inputs", "outputs")]
    with graphs._CAPTURE_LOCK:  # a capture is under way
        graphs._free_released()
    assert alive() is not None and len(released) == 1
    graphs._free_released()
    assert alive() is None and released == []


# -- the Python plane -----------------------------------------------------------------


def serve_all(service, reqs):
    async def run():
        await service.start()
        try:
            return await asyncio.gather(*map(service.evaluate, reqs))
        finally:
            await service.stop()
    return asyncio.run(run())


@pytest.mark.parametrize("pipe", ["on", "off"])
def test_service_force_equals_off_and_reference(crs60, monkeypatch, pipe):
    ref, ref_lists, port, lists = crs60
    monkeypatch.setenv("PINGOO_PIPELINE", pipe)
    ref_reqs = ref_generate_traffic(160, attack_fraction=0.3, seed=SEEDS[2],
                                    lists=ref_lists)
    want = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(ref_reqs), ref_lists)
    want_act, want_vb = ref_verdict.action_lanes(ref, want)
    served = {}
    for mode in ("off", "force"):
        monkeypatch.setenv("PINGOO_MEGASTEP", mode)
        monkeypatch.setenv("PINGOO_MEGASTEP_K", "4")
        service = VerdictService(port, lists, max_batch=32, device="cpu")
        served[mode] = serve_all(service, as_port(ref_reqs))
        got = np.stack([v.matched for v in served[mode]])
        np.testing.assert_array_equal(got, want)
        assert [v.action for v in served[mode]] == want_act.tolist()
        assert [v.verified_block for v in served[mode]] == want_vb.tolist()
        mega = service.pipeline_snapshot()["megastep"]
        if mode == "force":
            assert mega["windows"] == service.stats.batches
            assert mega["slices_by_mode"] == {"force": mega["slices"]}
            assert mega["slices"] > mega["windows"]
            assert service.mega_echo_mismatch == 0
            assert sorted(service._mega_queue._free) == [0, 1]
        else:
            assert mega["windows"] == 0
    assert any(v.block for v in served["force"])


@pytest.mark.parametrize("k_env, k", [(None, 1), ("4", 4), ("bogus", 1)])
def test_service_k_defaults_to_one_slice(crs60, monkeypatch, k_env, k):
    """Unless PINGOO_MEGASTEP_K is set, the Python plane runs a batch as
    one slice (a window is one replay at any K); set, it splits the batch
    as the JAX package does. The sidecar's cap stays the JAX package's."""
    ref, ref_lists, port, lists = crs60
    monkeypatch.setenv("PINGOO_MEGASTEP", "force")
    if k_env is not None:
        monkeypatch.setenv("PINGOO_MEGASTEP_K", k_env)
    ref_reqs = ref_generate_traffic(64, attack_fraction=0.3, seed=SEEDS[4],
                                    lists=ref_lists)
    want = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(ref_reqs), ref_lists)
    service = VerdictService(port, lists, max_batch=32, device="cpu")
    reqs = as_port(ref_reqs)
    got = np.stack([v.matched for lo in (0, 32)
                    for v in service.evaluate_batch(reqs[lo:lo + 32])])
    np.testing.assert_array_equal(got, want)
    mega = service.pipeline_snapshot()["megastep"]
    assert (mega["windows"], mega["slices"], mega["k"]) == (2, 2 * k, k)
    assert verdict.megastep_k_cap() == 4  # the sidecar's cap


# -- the native plane -------------------------------------------------------------------


def mixed_stream(n, seed):
    """Requests whose path and url widths change every few requests (so
    windows mix narrow and wide slices), with attacks and host-rule hits."""
    rng = random.Random(seed)
    paths = ["/", "/.env", "/admin", "/etc/passwd", "/ok/page", "/a.php",
             "/api/x"]
    reqs = []
    for i in range(n):
        wide = (i // 5) % 3 == 0
        path = rng.choice(paths) + ("/" + "w" * rng.randrange(30, 90)
                                    if wide else "")
        url = path + rng.choice(["", "?q=union select 1", "?x=%3Cscript",
                                 "?a=1"])
        reqs.append(RequestTuple(
            host=rng.choice(["example.com", "api.example.com", "h.test"]),
            url=url, path=path,
            method=rng.choice(["GET", "POST", "HEAD"]),
            user_agent=rng.choice(["Mozilla/5.0", "curl/8", ""]),
            ip=rng.choice(["8.8.8.8", "10.1.2.3", "192.0.2.1",
                           "172.16.0.1"]),
            remote_port=rng.randrange(1024, 65536),
            asn=rng.choice([0, 15169, 64500, 65000]),
            country=rng.choice(["US", "FR", "RU"])))
    return reqs


def drive(mod, plan, lists, stream, path, env, max_batch=8, capacity=256,
          **kw):
    """`stream` through a sidecar of `mod` on a fresh ring, the producer
    in this process; returns (DriveResult, sidecar)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in CLEARED_ENV:
            mp.delenv(name, raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        ring = mod.Ring(str(path), capacity=capacity, create=True)
        try:
            if mod is nr:
                kw["device"] = "cpu"
            sidecar = mod.RingSidecar(ring, plan, lists, max_batch=max_batch,
                                      **kw)
            errors = []

            def run():
                try:
                    sidecar.run()
                except Exception as exc:
                    errors.append(exc)
            t = threading.Thread(target=run, daemon=True)
            t.start()
            try:
                res = nr.drive_stream(ring, stream, timeout_s=300,
                                      idle_s=nr.DRIVE_IDLE_S)
            finally:
                sidecar.stop()
                t.join(30)
            assert not errors, errors
        finally:
            ring.close()
    return res, sidecar


@pytest.fixture(scope="module")
def host_plans():
    """The parity rules with the host-interpreted ones, every rule
    blocking, so that host rules decide verdicts."""
    return both_plans(RULE_SOURCES[:12] + HOST_FALLBACK_SOURCES,
                      actions=(RefAction.BLOCK,))


@pytest.fixture(scope="module")
def stream_400(host_plans, tmp_path_factory):
    """400 requests, their bytes from the JAX package's sidecar (its
    one-batch chain, max_batch=8) and from the port's per-batch path."""
    ref, port = host_plans
    reqs = mixed_stream(400, SEEDS[3])
    stream = nr.pack_requests(reqs)
    want, _ = drive(ref_nr, ref, LISTS, stream,
                    tmp_path_factory.mktemp("ref") / "ring", REF_ENV)
    with pytest.MonkeyPatch.context() as mp:
        for name in CLEARED_ENV:
            mp.delenv(name, raising=False)
        service = VerdictService(port, port_lists(LISTS), max_batch=8,
                                 device="cpu")
        off = bytes(v.action | (v.verified_block << 2)
                    for lo in range(0, len(reqs), 8)
                    for v in service.evaluate_batch(reqs[lo:lo + 8]))
    return stream, want.actions, off


@pytest.mark.parametrize("pipe", ["on", "off"])
def test_sidecar_force_over_40_slices(host_plans, stream_400, tmp_path,
                                      pipe):
    """400 requests through a 256-slot ring at max_batch=8: more than 40
    slices under `force` (K=4; under `on` three windows in flight, under
    `off` one), the verdict bytes those of the port's `off` path and of
    the JAX package's sidecar."""
    _, port = host_plans
    stream, want, off = stream_400
    got, sidecar = drive(nr, port, port_lists(LISTS), stream,
                         tmp_path / "ring",
                         {"PINGOO_MEGASTEP": "force",
                          "PINGOO_MEGASTEP_K": "4", "PINGOO_PIPELINE": pipe})
    assert got.actions == off == want
    assert len({a & 3 for a in got.actions}) > 1
    st = sidecar.stats()
    mega, pipe_st = st["megastep"], st["pipeline"]["megastep"]
    assert sidecar.batches > 40 and pipe_st["slices"] == sidecar.batches
    assert mega["mode"] == "force" and mega["echo_mismatch"] == 0
    assert mega["windows"] == pipe_st["windows"] > 0
    assert st["pipeline"]["inflight"] == 0
    depth = sidecar.pipeline_depth
    assert depth == (3 if pipe == "on" else 1)
    assert sorted(sidecar._mega_queue._free) == list(range(depth + 1))
    if pipe == "on":
        assert len(sidecar._slot_pool) == depth * 4 + 1
        assert sorted(sidecar._staging._free) == [0, 1, 2]


def test_sidecar_window_reuse(host_plans, tmp_path, monkeypatch):
    """Three windows of two slices (K=2) queued whole before the loop
    runs: the first window completes only once the second and third have
    been staged and launched (three in flight), and its host-rule
    verdicts, read from its set's slice views at completion, are the JAX
    package's one-batch chain's for the same requests. Sets handed out in
    turn (the JAX package's, nbuf=2) would give the third window the
    first one's set."""
    ref, port = host_plans
    lists = port_lists(LISTS)
    first = [RequestTuple(host="example.com", path=f"/a{i}", url=f"/b{i}",
                          user_agent="Mozilla/5.0", ip="8.8.8.8")
             for i in range(16)]
    later = [RequestTuple(host="h.test", path=f"/z{i}", url="/a",
                          user_agent="Mozilla/5.0", ip="8.8.8.8")
             for i in range(32)]
    ref_reqs = [RefRequestTuple(**dataclasses.asdict(r))
                for r in first + later]
    matched = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(ref_reqs), LISTS)
    act, vb = ref_verdict.action_lanes(ref, matched)
    want = bytes(int(a) | (int(b) << 2) for a, b in zip(act, vb))
    assert set(want[:16]) == {5} and set(want[16:]) == {0}
    monkeypatch.setenv("PINGOO_MEGASTEP", "force")
    monkeypatch.setenv("PINGOO_MEGASTEP_K", "2")
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, port, lists, max_batch=8,
                                 device="cpu", pipeline_depth=3)
        launched_at_first = []
        complete = sidecar._complete_megastep

        def spy(win):
            if not launched_at_first:
                launched_at_first.append(sidecar.mega_windows)
            complete(win)

        sidecar._complete_megastep = spy
        for t, args in enumerate(nr.pack_requests(first + later)):
            assert ring.enqueue(*args) == t
        assert sidecar.run(max_requests=48) == 48
        got = {}
        v = ring.poll_verdict()
        while v is not None:
            got[v[0]] = v[1]
            v = ring.poll_verdict()
    finally:
        ring.close()
    assert launched_at_first == [3]
    assert sidecar.mega_windows == 3 and sidecar.batches == 6
    assert bytes(got[t] for t in range(48)) == want


@pytest.mark.parametrize("pipe", ["on", "off"])
def test_sidecar_warm_up_runs_every_window_shape(crs60, tmp_path,
                                                 monkeypatch, pipe):
    """Under `force` the warm-up runs one window of every K the drain loop
    ships (K=4: 1, 2 and 4 slices of max_batch rows), narrow and at the
    full width, and no per-batch lane call; it touches no ring, no
    counter and holds no set."""
    _, _, port, lists = crs60
    monkeypatch.setenv("PINGOO_MEGASTEP", "force")
    monkeypatch.setenv("PINGOO_MEGASTEP_K", "4")
    monkeypatch.setenv("PINGOO_PIPELINE", pipe)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, port, lists, max_batch=8,
                                 device="cpu")
        runner, windows = sidecar._mega_runner, []
        run = runner.run

        def spy(queue, buf_id, k_used, k_ship):
            windows.append((k_used, k_ship,
                            runner.key(queue, buf_id, k_ship)[3]))
            return run(queue, buf_id, k_used, k_ship)

        runner.run = spy
        sidecar._lane_fn = None  # a per-batch call would raise
        out = sidecar.warm_up()
        sidecar.stop()
        assert [(rows, width) for rows, width, _ in out] == [
            (8, 64), (8, 2048), (16, 64), (16, 2048), (32, 64), (32, 2048)]
        # Widths of (host, url, path, method, user_agent, country): the
        # narrow windows' are those of CRS traffic (a browser's user
        # agent, a path over 16 bytes), the wide ones' the slots' caps.
        narrow, wide = (16, 64, 32, 16, 128, 2), (16, 2048, 2048, 16, 128, 2)
        assert windows == [(k, k, w) for k in (1, 2, 4)
                           for w in (narrow, wide)]
        assert (sidecar.processed, sidecar.batches,
                sidecar.mega_windows) == (0, 0, 0)
        assert sidecar.stats()["pipeline"]["megastep"]["windows"] == 0
        assert sorted(sidecar._mega_queue._free) == list(
            range(sidecar.pipeline_depth + 1))
        if pipe == "on":
            assert sorted(sidecar._staging._free) == [0, 1, 2]
        assert ring.telemetry()["dequeued"] == 0
    finally:
        ring.close()


# -- errors raise -----------------------------------------------------------------------


def test_megastep_errors_raise(crs60, tmp_path, monkeypatch):
    """A failed window demotes the ladder's megastep rung: the Python
    plane issues the batch per batch, the sidecar interprets the
    window's slices, both with the per-batch path's verdicts. A kernel
    build error raises through the rung on both planes."""
    from pingoo_tpu_torch.ops._build import KernelBuildError

    _, _, port, lists = crs60
    monkeypatch.setenv("PINGOO_MEGASTEP", "force")
    error = [RuntimeError("replay broke")]

    def broken(*args, **kwargs):
        raise error[0]

    want = VerdictService(port, lists, max_batch=8, device="cpu") \
        .evaluate_batch([RequestTuple(path="/.env")])[0]
    monkeypatch.setattr(graphs.MegastepRunner, "run", broken)
    service = VerdictService(port, lists, max_batch=8, device="cpu")
    got = service.evaluate_batch([RequestTuple(path="/.env")])[0]
    assert (got.action, got.matched.tolist()) \
        == (want.action, want.matched.tolist())
    assert service.ladder.demoted() == ["megastep"]
    assert service.pipeline_snapshot()["megastep"]["slices"] == 0
    assert service.pipeline_snapshot()["inflight"] == 0
    assert sorted(service._mega_queue._free) == [0, 1]
    error[0] = KernelBuildError("nvcc exited 2")
    service.ladder.note_success("megastep")
    with pytest.raises(KernelBuildError, match="nvcc"):
        service.evaluate_batch([RequestTuple(path="/.env")])
    assert service.stats.batches == 1
    assert sorted(service._mega_queue._free) == [0, 1]
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        error[0] = RuntimeError("replay broke")
        sidecar = nr.RingSidecar(ring, port, lists, max_batch=8,
                                 device="cpu")
        ticket = ring.enqueue(*nr.pack_requests(
            [RequestTuple(path="/.env")])[0])
        assert sidecar.run(max_requests=1) == 1
        assert ring.poll_verdict()[:2] == (
            ticket, want.action | (want.verified_block << 2))
        assert sidecar.ladder.demoted() == ["megastep"]
        error[0] = KernelBuildError("nvcc exited 2")
        sidecar.ladder.note_success("megastep")
        assert ring.enqueue(*nr.pack_requests(
            [RequestTuple(path="/.env")])[0]) is not None
        with pytest.raises(KernelBuildError, match="nvcc"):
            sidecar.run(max_requests=2)
        assert ring.poll_verdict() is None  # no fallback verdict
        sidecar.stop()
    finally:
        ring.close()
