"""The port's pipelined executor (PINGOO_PIPELINE) against the JAX package.

  * `StagingEncoder.encode_requests` equals the JAX package's
    StagingEncoder and the port's own one-batch chain (encode_requests
    -> bucket_arrays -> pad_batch) across the seeds, odd sizes, a full
    batch and overflow rows; a batch's views survive nbuf - 1 more
    checkouts and until their set is released, whatever order batches
    finish in; bad shapes raise, and compact staging takes new caps only
    between batches.
  * `encode_slots` equals both packages' slots_to_arrays -> bucket ->
    pad chain and the JAX package's encoder on slots dequeued from a
    real ring: wrap-around, truncated rows and spill slots.
  * `PipelineStats` gives the JAX package's snapshot (built with a
    private registry) on the same interval sequences.
  * VerdictService under `on` (depth 3) and `off` gives the JAX
    package's matrices and action lanes; a staging error fails its
    batch's callers only; eight threads calling `evaluate_batch` at a
    time get each batch's own verdicts.
  * RingSidecar under `on` and `off` (max_batch=32) gives the JAX
    package's sidecar's verdict bytes, with three batches in flight
    under `on`; a staging error propagates out of `run()`.

CPU only, small plans, shm rings and no httpd; the tolerance is zero.
"""

import asyncio
import dataclasses
import random
import time

import numpy as np
import pytest
import torch

from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import StagingEncoder as RefStagingEncoder
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.obs.pipeline import PipelineStats as RefPipelineStats
from pingoo_tpu.obs.registry import MetricRegistry
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine.batch import (RequestBatch, RequestTuple,
                                           StagingEncoder, bucket_arrays,
                                           encode_requests, pad_batch,
                                           pow2_batch_size)
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.obs.pipeline import PIPELINE_EXEC_STAGES, PipelineStats
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
from test_parity import random_requests
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
# The reference sidecar's one-batch chain, which the port is held to.
REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_SCHED_MODE": "fixed",
           "PINGOO_MEGASTEP": "off"}
CLEARED_ENV = ("PINGOO_CHAOS", "PINGOO_DFA", "PINGOO_PREFILTER",
               "PINGOO_MESH", "PINGOO_PARITY_SAMPLE", "PINGOO_PIPELINE",
               "PINGOO_PIPELINE_DEPTH", "PINGOO_SCHED_PIPELINE",
               "PINGOO_SCHED_FAILOPEN", "PINGOO_STAGING",
               "PINGOO_PROVENANCE", "PINGOO_BODY_INSPECT")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


def legacy_requests(reqs, specs, pad_to):
    """The port's one-batch chain."""
    raw = encode_requests(reqs, specs)
    return pad_batch(RequestBatch(size=raw.size,
                                  arrays=bucket_arrays(raw.arrays),
                                  overflow=raw.overflow), pad_to)


def assert_same(got, want, with_overflow=True):
    assert got.size == want.size
    assert set(got.arrays) == set(want.arrays)
    for key, b in want.arrays.items():
        a = np.asarray(got.arrays[key])
        b = np.asarray(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), key
        assert np.array_equal(a, b), key
    if with_overflow:
        assert np.array_equal(got.overflow, want.overflow)


# -- StagingEncoder.encode_requests -------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_requests_equals_reference_and_legacy(seed):
    """Odd sizes and a full batch, from the parity stream and CRS
    traffic, through one encoder of each package."""
    port, ref = StagingEncoder(64), RefStagingEncoder(64)
    rng = random.Random(seed)
    for n in (1, 13, 37, 64):
        ref_reqs = random_requests(rng, n) if n % 2 else \
            ref_generate_traffic(n, attack_fraction=0.3, seed=seed + n)
        reqs = as_port(ref_reqs)
        pad = pow2_batch_size(n, 64)
        into = port.checkout(block=False)
        got = port.encode_requests(reqs, pad_to=pad, into=into)
        assert_same(got, legacy_requests(reqs, None, pad))
        assert_same(got, ref.encode_requests(ref_reqs, pad_to=pad))
        port.release(into)


def test_encode_requests_overflow_rows():
    specs = {"host": 16, "url": 32, "path": 16, "method": 16,
             "user_agent": 16, "country": 2}
    reqs = [RequestTuple(host="h.test", url="/" + "a" * 64,
                         path="/" + "b" * 40, user_agent="ua",
                         ip="10.0.0.1"),
            RequestTuple(host="x" * 20, url="/ok", path="/ok",
                         user_agent="u" * 16, ip="10.0.0.2"),
            RequestTuple(host="fits", url="/s", path="/s",
                         user_agent="ua", ip="not-an-ip",
                         asn=2**70, remote_port=-5)]
    got = StagingEncoder(16, field_specs=specs).encode_requests(
        reqs, pad_to=8, into=0)
    assert_same(got, legacy_requests(reqs, specs, 8))
    ref = RefStagingEncoder(16, field_specs=specs).encode_requests(
        [dataclasses.replace(r) for r in reqs], pad_to=8)
    assert_same(got, ref)
    assert got.overflow[:3].tolist() == [True, True, False]
    assert int(got.arrays["user_agent_len"][1]) == 16  # at the cap


def test_views_survive_nbuf_minus_one_checkouts():
    """A held set's views survive the other nbuf - 1 sets being checked
    out, filled and released again; with every set out a non-blocking
    checkout raises and a blocking one waits for the next release,
    which hands out that very set."""
    import threading

    enc = StagingEncoder(16, nbuf=3)

    def fill(seed, n):
        into = enc.checkout(block=False)
        return into, enc.encode_requests(
            as_port(random_requests(random.Random(seed), n)), pad_to=8,
            into=into)

    held, a = fill(11, 5)
    frozen = {k: v.copy() for k, v in a.arrays.items()}
    for seed in (12, 13, 14):  # finish before the held batch does
        into, _ = fill(seed, 7)
        enc.release(into)
    others = [fill(seed, 7)[0] for seed in (15, 16)]
    for k, v in frozen.items():
        assert np.array_equal(a.arrays[k], v), k
    with pytest.raises(RuntimeError, match="checked out"):
        enc.checkout(block=False)
    got = []
    waiter = threading.Thread(target=lambda: got.append(enc.checkout()))
    waiter.start()
    waiter.join(0.2)
    assert waiter.is_alive() and not got  # waits for a free set
    enc.release(held)
    waiter.join(10)
    assert got == [held]
    d = enc.encode_requests(as_port(random_requests(random.Random(17), 5)),
                            pad_to=8, into=held)
    assert any(np.shares_memory(d.arrays[k], a.arrays[k]) for k in d.arrays)
    for into in others + [held]:
        enc.release(into)
    assert sorted(enc._free) == [0, 1, 2]


def test_bad_shapes_and_compact_staging_raise():
    enc = StagingEncoder(16)
    reqs = as_port(random_requests(random.Random(0), 4))
    for bad in (([], 8), (reqs, 2), (reqs, 32)):
        with pytest.raises(ValueError, match="bad staging shape"):
            enc.encode_requests(*bad, into=0)
    with pytest.raises(ValueError, match="bad staging shape"):
        enc.encode_slots(np.zeros(0, dtype=nr.REQUEST_SLOT_DTYPE), 8,
                         into=0)
    # Compact staging: an encoder built with caps takes them, and takes
    # new ones only between batches; one built without packed buffers
    # raises.
    packed = StagingEncoder(16, stage_caps={"url": 64})
    assert packed.stage_caps["url"] == 64
    assert packed.stage_caps["host"] == 256  # unnamed fields: the spec
    held = packed.checkout(block=False)
    got = packed.encode_requests(reqs, pad_to=8, into=held)
    assert got.arrays["url_bytes"].shape == (8, 64)
    with pytest.raises(RuntimeError, match="between batches"):
        packed.set_stage_caps({"url": 128})
    packed.release(held)
    packed.set_stage_caps({"url": 128})
    assert packed.stage_caps["url"] == 128
    assert got.layout.width < packed._layout.width  # widened
    with pytest.raises(ValueError, match="packed"):
        enc.set_stage_caps({"url": 64})


# -- StagingEncoder.encode_slots ----------------------------------------------


def slot_caps():
    return dict(nr.FIELD_CAPS, country=2)


def enqueue(ring, i, url=None):
    body = url if url is not None else f"/p{i}?q={'x' * (i % 90)}".encode()
    return ring.enqueue(
        method=b"GET" if i % 3 else b"POST", host=f"h{i % 7}.test".encode(),
        path=body, url=body, user_agent=f"ua-{i % 5}".encode(),
        ip=b"\x00" * 10 + b"\xff\xff" + bytes([10, i % 256, (i * 7) % 256, 1]),
        port=1000 + i, asn=64500 + (i % 9),
        country=b"FR" if i % 2 else b"DE")


def legacy_slots(mod, slots, pad_to):
    raw = mod.slots_to_arrays(slots)
    return pad_batch(RequestBatch(size=len(slots), arrays=bucket_arrays(raw)),
                     pad_to)


def assert_slots_encode(enc, ref_enc, slots, pad):
    into = enc.checkout(block=False)
    got = enc.encode_slots(slots, pad_to=pad, into=into)
    assert got.overflow is None
    assert_same(got, legacy_slots(nr, slots, pad), with_overflow=False)
    assert_same(got, legacy_slots(ref_nr, slots, pad), with_overflow=False)
    assert_same(got, ref_enc.encode_slots(slots, pad_to=pad),
                with_overflow=False)
    enc.release(into)


def test_encode_slots_across_wraparound(tmp_path):
    ring = nr.Ring(str(tmp_path / "ring"), capacity=32, create=True)
    enc = StagingEncoder(32, field_specs=slot_caps())
    ref_enc = RefStagingEncoder(32, field_specs=slot_caps())
    out = np.zeros(32, dtype=nr.REQUEST_SLOT_DTYPE)
    try:
        i = 0
        for n in (20, 20, 13, 20, 1):  # the head wraps the 32-slot ring
            for _ in range(n):
                assert enqueue(ring, i) is not None
                i += 1
            assert ring.dequeue_batch_into(out) == n
            assert_slots_encode(enc, ref_enc, out[:n],
                                pow2_batch_size(n, 32))
    finally:
        ring.close()


def test_encode_slots_truncated_and_spill_rows(tmp_path):
    ring = nr.Ring(str(tmp_path / "ring"), capacity=32, create=True)
    try:
        enqueue(ring, 0, url=b"/" + b"A" * 3000)  # past the slot cap
        enqueue(ring, 1)
        enqueue(ring, 2, url=b"/" + b"B" * 2047)  # exactly at the cap
        out = np.zeros(32, dtype=nr.REQUEST_SLOT_DTYPE)
        assert ring.dequeue_batch_into(out) == 3
        slots = out[:3]
        assert slots["flags"][0] & nr.SLOT_FLAG_TRUNCATED
        assert slots["spill_idx"][0] != nr.SPILL_NONE
        assert_slots_encode(StagingEncoder(32, field_specs=slot_caps()),
                            RefStagingEncoder(32, field_specs=slot_caps()),
                            slots, 8)
        ring.spill_release(int(slots["spill_idx"][0]))
    finally:
        ring.close()


# -- PipelineStats -------------------------------------------------------------


def both_stats(depth=3):
    return (PipelineStats("test", depth),
            RefPipelineStats("test", depth, registry=MetricRegistry()))


def assert_snapshots_equal(port, ref):
    got, want = port.snapshot(), ref.snapshot()
    assert set(got) == set(want)
    occ_got, occ_want = got.pop("stage_occupancy"), want.pop(
        "stage_occupancy")
    assert set(occ_got) == set(occ_want) == set(PIPELINE_EXEC_STAGES)
    assert got == want
    assert port.overlap_events == ref.overlap_events


STAGE_SEQUENCES = {
    # slot 2's dispatch overlaps slot 1's compute by half of it
    "cross_slot": [(2, "dispatch", 0.0, 0.1), (1, "compute", 0.05, 0.15)],
    "same_slot": [(1, "encode", 0.0, 0.1), (1, "compute", 0.0, 0.1)],
    "disjoint": [(1, "dispatch", 0.0, 0.05), (2, "compute", 0.06, 0.1)],
    "negative_and_unknown": [(1, "compute", 0.0, -1.0), (1, "warp", 0, 0.1)],
    "pipelined_run": [
        (s, st, s * 0.03 + a, s * 0.03 + b)
        for s in range(1, 40)
        for st, a, b in (("encode", 0.0, 0.01), ("dispatch", 0.01, 0.02),
                         ("compute", 0.02, 0.07), ("resolve", 0.07, 0.08))],
}


@pytest.mark.parametrize("case", sorted(STAGE_SEQUENCES))
def test_pipeline_stats_equal_the_reference(case):
    port, ref = both_stats()
    slots = {}
    t = time.monotonic()
    for slot, stage, t0, t1 in STAGE_SEQUENCES[case]:
        if slot not in slots:
            slots[slot] = (port.enter("on"), ref.enter("on"))
            assert slots[slot][0] == slots[slot][1]
        port.note_stage(slots[slot][0], stage, t + t0, t + t1)
        ref.note_stage(slots[slot][1], stage, t + t0, t + t1)
    assert_snapshots_equal(port, ref)
    for _ in slots:
        port.exit()
        ref.exit()
    assert_snapshots_equal(port, ref)
    assert port.snapshot()["inflight"] == 0


def test_pipeline_stats_modes_and_pairing():
    port, ref = both_stats(depth=2)
    for ps in (port, ref):
        ps.enter("on")
        ps.enter("off")
    assert_snapshots_equal(port, ref)
    assert port.snapshot()["batches"] == {"off": 1, "on": 1}
    assert port.peak_inflight == 2
    port, _ = both_stats()
    t = time.monotonic()
    s1, s2 = port.enter(), port.enter()
    port.note_stage(s2, "dispatch", t, t + 0.1)
    assert port.overlap_events == 0  # no compute interval yet
    port.note_stage(s1, "compute", t + 0.05, t + 0.15)
    assert port.overlap_events == 1
    assert port.snapshot()["overlap_ratio"] == pytest.approx(0.5, abs=0.01)


# -- VerdictService --------------------------------------------------------------


@pytest.fixture(scope="module")
def crs60():
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    return (ref_compile(ref_rules, ref_lists), ref_lists,
            compile_ruleset(rules, lists, device="cpu"), lists)


def serve_all(service, reqs):
    async def run():
        await service.start()
        try:
            return await asyncio.gather(*map(service.evaluate, reqs))
        finally:
            await service.stop()
    return asyncio.run(run())


@pytest.mark.parametrize("mode", ["on", "off"])
def test_service_modes_equal_the_reference(crs60, monkeypatch, mode):
    ref, ref_lists, port, lists = crs60
    monkeypatch.setenv("PINGOO_PIPELINE", mode)
    monkeypatch.setenv("PINGOO_PIPELINE_DEPTH", "3")
    ref_reqs = ref_generate_traffic(160, attack_fraction=0.3, seed=SEEDS[0],
                                    lists=ref_lists)
    want = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_encode(ref_reqs), ref_lists)
    want_act, want_vb = ref_verdict.action_lanes(ref, want)
    service = VerdictService(port, lists, max_batch=32, device="cpu")
    verdicts = serve_all(service, as_port(ref_reqs))
    np.testing.assert_array_equal(np.stack([v.matched for v in verdicts]),
                                  want)
    assert [v.action for v in verdicts] == want_act.tolist()
    assert [v.verified_block for v in verdicts] == want_vb.tolist()
    assert any(v.block for v in verdicts)
    snap = service.pipeline_snapshot()
    with monkeypatch.context() as mp:
        for name, value in REF_ENV.items():
            mp.setenv(name, value)
        from pingoo_tpu.engine.service import VerdictService as RefService

        ref_snap = RefService(ref, ref_lists, use_device=False,
                              max_batch=32).pipeline_snapshot()
    assert set(snap) == set(ref_snap)
    assert set(snap["megastep"]) == set(ref_snap["megastep"])
    assert set(snap["stage_occupancy"]) == set(ref_snap["stage_occupancy"])
    n = service.stats.batches
    assert n >= 160 // 32
    assert (snap["mode"], snap["depth"], snap["batches"], snap["inflight"]) \
        == (mode, 3 if mode == "on" else 1, {mode: n}, 0)
    assert snap["overlap_events"] >= 0 and all(
        0 <= v for v in snap["stage_occupancy"].values())


def test_service_staging_error_fails_only_its_batch(crs60):
    """A staging error demotes the ladder's pipeline rung: the batch is
    encoded through the one-batch chain, with its verdicts, and the
    staging encoder serves again once a probe after the backoff finds
    it working. A kernel build error is never demoted: it fails that
    batch's callers only, every in-flight slot is released, and the
    service serves again."""
    from pingoo_tpu_torch.ops._build import KernelBuildError

    _, _, port, lists = crs60
    service = VerdictService(port, lists, max_batch=8, max_wait_us=0,
                             device="cpu")
    assert service._pipeline_depth == 2
    clock = [0.0]
    service.ladder._clock = lambda: clock[0]
    encode = service._staging.encode_requests
    want = VerdictService(port, lists, max_batch=8, device="cpu") \
        .evaluate_batch([RequestTuple(path="/.env")])[0]

    def broken(*args, **kwargs):
        raise RuntimeError("staging broke")

    def unbuilt(*args, **kwargs):
        raise KernelBuildError("nvcc exited 2")

    async def run():
        await service.start()
        try:
            service._staging.encode_requests = broken
            served = [await asyncio.wait_for(
                service.evaluate(RequestTuple(path="/.env")), 10)
                for _ in range(3)]
            demoted = service.ladder.demoted()
            service._staging.encode_requests = unbuilt
            out = []
            for path in ("/a", "/b", "/c"):
                clock[0] += 1.0  # a probe window opens
                with pytest.raises(KernelBuildError, match="nvcc"):
                    await asyncio.wait_for(
                        service.evaluate(RequestTuple(path=path)), 10)
                out.append(path)
            service._staging.encode_requests = encode
            clock[0] += 10.0
            v = await asyncio.wait_for(
                service.evaluate(RequestTuple(path="/.env")), 10)
            return served, demoted, out, v
        finally:
            await service.stop()

    served, demoted, out, v = asyncio.run(run())
    assert demoted == ["pipeline"]
    for got in served + [v]:
        np.testing.assert_array_equal(got.matched, want.matched)
        assert got.action == want.action
    assert out == ["/a", "/b", "/c"]
    assert v.matched.shape == (len(port.rules),)
    assert service.pipeline_snapshot()["inflight"] == 0
    assert service.ladder.demoted() == []
    assert service.stats.snapshot()["ladder"]["pipeline"]["errors"] == 1


# -- RingSidecar -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_ring_bytes(crs60, tmp_path_factory):
    """Each seed's stream of 128 CRS-style requests through the JAX
    package's sidecar (max_batch=32, its one-batch chain)."""
    ref, ref_lists, _, lists = crs60
    tmp = tmp_path_factory.mktemp("ref")
    streams = {s: nr.pack_requests(generate_traffic(
        128, attack_fraction=0.3, seed=s, lists=lists)) for s in SEEDS}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in CLEARED_ENV:
            mp.delenv(name, raising=False)
        for name, value in REF_ENV.items():
            mp.setenv(name, value)
        ring = ref_nr.Ring(str(tmp / "ring"), capacity=512, create=True)
        try:
            sidecar = ref_nr.RingSidecar(ring, ref, ref_lists, max_batch=32)
            import threading

            t = threading.Thread(target=sidecar.run, daemon=True)
            t.start()
            try:
                for s in SEEDS:
                    out[s] = nr.drive_stream(ring, streams[s]).actions
            finally:
                sidecar.stop()
                t.join(30)
        finally:
            ring.close()
    return streams, out


@pytest.mark.parametrize("mode", ["on", "off"])
def test_sidecar_modes_equal_the_reference(crs60, ref_ring_bytes, tmp_path,
                                           monkeypatch, mode):
    """Every seed's stream enqueued whole before the drain loop runs, so
    under `on` the loop keeps three batches in flight; the verdict bytes
    in stream order are the JAX package's sidecar's."""
    _, _, port, lists = crs60
    streams, want = ref_ring_bytes
    monkeypatch.setenv("PINGOO_PIPELINE", mode)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=1024, create=True)
    try:
        sidecar = nr.RingSidecar(ring, port, lists, max_batch=32,
                                 device="cpu")
        assert sidecar.pipeline_depth == (3 if mode == "on" else 1)
        total = 0
        for s in SEEDS:
            tickets = [ring.enqueue(*args) for args in streams[s]]
            assert None not in tickets
            total += len(tickets)
        assert sidecar.run(max_requests=total) == total
        got = {}
        v = ring.poll_verdict()
        while v is not None:
            assert v[0] not in got
            got[v[0]] = v[1]
            v = ring.poll_verdict()
    finally:
        ring.close()
    assert sorted(got) == list(range(total))
    acts = bytes(got[t] for t in range(total))
    assert acts == b"".join(want[s] for s in SEEDS)
    pipe = sidecar.stats()["pipeline"]
    assert pipe["batches"] == {mode: sidecar.batches}
    assert sidecar.batches == total // 32
    assert pipe["inflight"] == 0 and pipe["depth"] == sidecar.pipeline_depth
    assert sidecar._pipe.peak_inflight == sidecar.pipeline_depth
    if mode == "on":
        assert len(sidecar._slot_pool) == sidecar.pipeline_depth + 1
        assert len(sidecar._staging._free) == sidecar.pipeline_depth


def test_sidecar_staging_error_propagates(crs60, tmp_path):
    """A staging error demotes the sidecar's pipeline rung and the batch
    decodes through the one-batch chain, posting its verdict; a kernel
    build error propagates out of `run()`, with no fallback verdict."""
    from pingoo_tpu_torch.ops._build import KernelBuildError

    _, _, port, lists = crs60
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, port, lists, max_batch=32,
                                 device="cpu")
        assert sidecar.pipeline_mode == "on"

        def broken(*args, **kwargs):
            raise RuntimeError("staging broke")

        def unbuilt(*args, **kwargs):
            raise KernelBuildError("nvcc exited 2")

        sidecar._staging.encode_slots = broken
        ticket = enqueue(ring, 0)
        assert sidecar.run(max_requests=1) == 1
        got = ring.poll_verdict()
        want = VerdictService(port, lists, device="cpu").evaluate_batch(
            as_port(nr_requests(ring, [0])))[0]
        assert got[:2] == (ticket, want.action | (want.verified_block << 2))
        assert sidecar.ladder.demoted() == ["pipeline"]
        sidecar.ladder.note_success("pipeline")
        sidecar._staging.encode_slots = unbuilt
        assert enqueue(ring, 1) is not None
        with pytest.raises(KernelBuildError, match="nvcc"):
            sidecar.run(max_requests=2)
        assert ring.poll_verdict() is None  # no fallback verdict
        sidecar.stop()
    finally:
        ring.close()


def nr_requests(ring, ids):
    """The tuples `enqueue` put on the ring for `ids`."""
    out = []
    for i in ids:
        body = f"/p{i}?q={'x' * (i % 90)}"
        out.append(RequestTuple(
            method="GET" if i % 3 else "POST", host=f"h{i % 7}.test",
            path=body, url=body, user_agent=f"ua-{i % 5}",
            ip=f"10.{i % 256}.{(i * 7) % 256}.1", remote_port=1000 + i,
            asn=64500 + (i % 9), country="FR" if i % 2 else "DE"))
    return out


def test_service_batch_held_past_later_batches(monkeypatch):
    """A batch that stalls after its issue while four later batches
    finish keeps its own staging views: its host rules (which read the
    views at completion) give the verdicts of the batch served alone.
    A set handed out by the order of checkouts would be refilled by a
    later batch before the stalled one read it."""
    import threading

    from pingoo_tpu_torch.config.schema import Action, RuleConfig
    from pingoo_tpu_torch.engine import service as service_mod
    from pingoo_tpu_torch.expr import compile_expression
    from test_parity import HOST_FALLBACK_SOURCES, RULE_SOURCES

    rules = [RuleConfig(name=f"r{i}", expression=compile_expression(src),
                        actions=(Action.BLOCK,))
             for i, src in enumerate(RULE_SOURCES[:4] + HOST_FALLBACK_SOURCES)]
    plan = compile_ruleset(rules, {}, device="cpu")
    assert plan.host_rules
    monkeypatch.setenv("PINGOO_PIPELINE_DEPTH", "3")
    service = VerdictService(plan, {}, max_batch=8, device="cpu")
    held = [RequestTuple(host="example.com", path=f"/a{i}", url=f"/b{i}")
            for i in range(6)]
    later = [[RequestTuple(host=f"h{k}.test", path=f"/z{k}{i}", url="/a")
              for i in range(6)] for k in range(4)]

    def served(batch):
        return [(v.action, v.verified_block, v.matched.tobytes())
                for v in service.evaluate_batch(batch)]

    alone = served(held)
    assert {a for a, _, _ in alone} == {1}  # the host rules block them
    want_later = [served(b) for b in later]
    issued, go = threading.Event(), threading.Event()
    real_finish = service_mod.finish_batch

    def stalling_finish(*args):
        if threading.current_thread().name == "held":
            issued.set()
            assert go.wait(30)
        return real_finish(*args)

    monkeypatch.setattr(service_mod, "finish_batch", stalling_finish)
    got = []
    t = threading.Thread(target=lambda: got.append(served(held)),
                         name="held")
    t.start()
    try:
        assert issued.wait(30)
        assert [served(b) for b in later] == want_later
    finally:
        go.set()
        t.join(30)
    assert got == [alone]
    assert service.pipeline_snapshot()["inflight"] == 0
    assert sorted(service._staging._free) == [0, 1, 2]


def test_service_threads_stress(crs60, monkeypatch):
    """More callers than the depth and the cores, on threads switching
    every microsecond: each batch's verdicts equal the same batch served
    alone, the counts are exact and nothing stays in flight. A staging
    set reused while its batch still reads it would break the first."""
    import sys
    import threading

    _, _, port, lists = crs60
    service = VerdictService(port, lists, max_batch=16, device="cpu")
    batches = [as_port(random_requests(random.Random(seed), 5 + seed % 11))
               for seed in range(24)]
    want = [[(v.action, v.verified_block, v.matched.tobytes())
             for v in service.evaluate_batch(b)] for b in batches]
    got = [None] * len(batches)

    def worker(k):
        for i in range(k, len(batches), 8):
            got[i] = [(v.action, v.verified_block, v.matched.tobytes())
                      for v in service.evaluate_batch(batches[i])]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == want
    snap = service.pipeline_snapshot()
    assert snap["inflight"] == 0
    assert snap["batches"] == {"on": 2 * len(batches)}
    assert service.stats.batches == 2 * len(batches)
    assert service._pipe.peak_inflight <= service._pipeline_depth
