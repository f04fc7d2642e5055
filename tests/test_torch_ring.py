"""The port's native plane against the JAX package's: the ring client,
its ABI and `RingSidecar`, on the CPU.

  * ABI: the port's copy of the ring library is the reference's bytes,
    and its struct mirrors and constants equal the JAX package's and
    tools/analyze/abi_golden.json.
  * One ring file, two clients: requests the reference's `Ring` enqueues
    are dequeued and answered by the port's, and the other way round;
    both `slots_to_arrays` decode the slots alike.
  * The reference sidecar (under PINGOO_PIPELINE=off,
    PINGOO_SCHED_MODE=fixed, PINGOO_MEGASTEP=off) and the port's
    (device="cpu") serve the same requests, and every verdict byte is
    equal: seeded CRS traffic, routes with a host-route fallback and
    per-ring service orders, several rings, rows past the slot caps, and
    orphans reconciled at reattach.
  * Liveness: the heartbeat advances while serving and stays fresh
    through a slow batch; without a card the sidecar refuses to start;
    the producer's drive refuses a ticket answered twice or unknown; the
    C++ load generator goes through the port's sidecar.
"""

import contextlib
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.expr import compile_expression
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEEDS = (7, 1234, 999983, 31337, 2026)
# The reference sidecar's per-batch legacy chain: what the port serves.
REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_SCHED_MODE": "fixed",
           "PINGOO_MEGASTEP": "off"}
CLEARED_ENV = ("PINGOO_CHAOS", "PINGOO_DFA", "PINGOO_PREFILTER",
               "PINGOO_MESH", "PINGOO_PARITY_SAMPLE", "PINGOO_PIPELINE_DEPTH",
               "PINGOO_SCHED_FAILOPEN", "PINGOO_STAGING", "PINGOO_PROVENANCE",
               "PINGOO_BODY_INSPECT")


def _set_env(mp):
    for name in CLEARED_ENV:
        mp.delenv(name, raising=False)
    for name, value in REF_ENV.items():
        mp.setenv(name, value)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    _set_env(monkeypatch)


@contextlib.contextmanager
def serving(sidecar, **run_kwargs):
    """The sidecar's drain loop in a thread; stopped and joined after."""
    t = threading.Thread(target=sidecar.run, kwargs=run_kwargs, daemon=True)
    t.start()
    try:
        yield t
    finally:
        sidecar.stop()
        t.join(timeout=30)
        assert not t.is_alive()


def poll_all(rings, counts, timeout=60.0) -> list[dict]:
    """Per ring {ticket: [verdict bytes]} until every ring has its count
    of verdicts, then a short grace window that would catch a second
    verdict for a ticket."""
    got = [dict() for _ in rings]
    deadline = time.monotonic() + timeout

    def poll():
        any_v = False
        for g, ring in zip(got, rings):
            v = ring.poll_verdict()
            while v is not None:
                g.setdefault(v[0], []).append(v[1])
                any_v = True
                v = ring.poll_verdict()
        return any_v

    while time.monotonic() < deadline and any(
            sum(map(len, g.values())) < c for g, c in zip(got, counts)):
        if not poll():
            time.sleep(0.002)
    grace = time.monotonic() + 0.1
    while time.monotonic() < grace:
        if not poll():
            time.sleep(0.01)
    return got


def both_plans(rules, routes=None):
    """(reference plan, port plan) of [(name, source, block?)] rules and
    [(service, source or None)] routes."""
    def build(compile_fn, expr, RC, act):
        rs = [RC(name=n, expression=expr(src),
                 actions=(act.BLOCK,) if block else ())
              for n, src, block in rules]
        rt = [(n, expr(src) if src else None) for n, src in routes or []]
        return rs, rt

    rs, rt = build(ref_compile, ref_compile_expression, RefRuleConfig,
                   RefAction)
    ref = ref_compile(rs, {}, routes=rt or None)
    rs, rt = build(compile_ruleset, compile_expression, RuleConfig, Action)
    return ref, compile_ruleset(rs, {}, routes=rt or None, device="cpu")


def serve_both(tmp_path, plans, requests, max_batch=16, lists=({}, {}),
               **sidecar_kwargs):
    """Serve the same requests (per ring, a list of `Ring.enqueue`
    keyword arguments) through the reference sidecar and the port's, each
    on fresh rings of its own package. Returns (reference verdicts, port
    verdicts, port sidecar): per ring {ticket: verdict byte}, each ticket
    answered exactly once."""
    out = []
    for (ring_cls, sidecar_cls, kw), plan, lst in zip(
            ((ref_nr.Ring, ref_nr.RingSidecar, {}),
             (nr.Ring, nr.RingSidecar, {"device": "cpu"})), plans, lists):
        tag = "ref" if ring_cls is ref_nr.Ring else "port"
        rings = [ring_cls(str(tmp_path / f"{tag}{i}"), capacity=64,
                          create=True) for i in range(len(requests))]
        try:
            sidecar = sidecar_cls(rings if len(rings) > 1 else rings[0],
                                  plan, lst, max_batch=max_batch,
                                  **sidecar_kwargs, **kw)
            with serving(sidecar):
                for ring, reqs in zip(rings, requests):
                    for r in reqs:
                        assert ring.enqueue(**r) is not None
                got = poll_all(rings, [len(r) for r in requests])
        finally:
            for ring in rings:
                ring.close()
        for g, reqs in zip(got, requests):
            assert sorted(g) == list(range(len(reqs)))
            assert all(len(v) == 1 for v in g.values()), g
        out.append([{t: v[0] for t, v in g.items()} for g in got])
    return out[0], out[1], sidecar


# -- ABI ------------------------------------------------------------------------


@pytest.mark.parametrize("name", nr.RING_SOURCES)
def test_ring_sources_are_the_reference_bytes(name):
    assert (nr.NATIVE_DIR / name).read_bytes() == \
        (Path(ref_nr.NATIVE_DIR) / name).read_bytes()


STRUCT_OF_DTYPE = {
    "REQUEST_SLOT_DTYPE": "PingooRequestSlot",
    "VERDICT_SLOT_DTYPE": "PingooVerdictSlot",
    "TELEMETRY_DTYPE": "PingooRingTelemetry",
    "RING_HEADER_DTYPE": "PingooRingHeader",
    "SPILL_SLOT_DTYPE": "PingooSpillSlot",
    "BODY_SLOT_DTYPE": "PingooBodySlot",
}


def _layout(dt):
    return dt.itemsize, [(n, int(dt.fields[n][1]),
                          int(dt.fields[n][0].itemsize)) for n in dt.names]


@pytest.fixture(scope="module")
def golden():
    return json.loads((REPO / "tools/analyze/abi_golden.json").read_text())


@pytest.mark.parametrize("dtype_name", sorted(STRUCT_OF_DTYPE))
def test_slot_dtypes_match_reference_and_golden(golden, dtype_name):
    port = getattr(nr, dtype_name)
    assert port == getattr(ref_nr, dtype_name)
    assert _layout(port) == _layout(getattr(ref_nr, dtype_name))
    want = golden["structs"][STRUCT_OF_DTYPE[dtype_name]]
    assert _layout(port) == (want["size"], [
        (f["name"], f["offset"], f["size"]) for f in want["fields"]])


def test_ring_constants_match_reference_and_golden(golden):
    names = ("FIELD_CAPS", "RING_MAGIC", "SLOT_FLAG_TRUNCATED",
             "SPILL_SLOTS", "SPILL_DATA_CAP", "SPILL_NONE",
             "RING_FORMAT_VERSION", "REQUEST_SLOT_SIZE", "VERDICT_SLOT_SIZE",
             "RING_HEADER_SIZE", "TELEMETRY_BLOCK_SIZE", "SPILL_SLOT_SIZE",
             "WAIT_BUCKETS", "BODY_SLOTS", "BODY_WINDOW_CAP",
             "BODY_SLOT_SIZE", "BODY_FLAG_FINAL", "BODY_FLAG_ABORT",
             "BODY_VERDICT_BIT", "TELEMETRY_FIELDS", "TELEMETRY_WORDS",
             "WAIT_BUCKET_BOUNDS_MS")
    for name in names:
        assert getattr(nr, name) == getattr(ref_nr, name), name
    c = golden["constants"]
    assert golden["format_version"] == nr.RING_FORMAT_VERSION
    assert (c["PINGOO_RING_MAGIC"], c["PINGOO_RING_VERSION"],
            c["PINGOO_METHOD_CAP"], c["PINGOO_HOST_CAP"], c["PINGOO_PATH_CAP"],
            c["PINGOO_URL_CAP"], c["PINGOO_UA_CAP"],
            c["PINGOO_SLOT_FLAG_TRUNCATED"], c["PINGOO_SPILL_SLOTS"],
            c["PINGOO_SPILL_DATA_CAP"], c["PINGOO_SPILL_NONE"],
            c["PINGOO_WAIT_BUCKETS"], c["PINGOO_TELEMETRY_WORDS"],
            c["PINGOO_BODY_SLOTS"], c["PINGOO_BODY_WINDOW_CAP"],
            c["PINGOO_BODY_FLAG_FINAL"], c["PINGOO_BODY_FLAG_ABORT"],
            c["PINGOO_BODY_VERDICT_BIT"]) == (
        nr.RING_MAGIC, nr.RING_FORMAT_VERSION, nr.FIELD_CAPS["method"],
        nr.FIELD_CAPS["host"], nr.FIELD_CAPS["path"], nr.FIELD_CAPS["url"],
        nr.FIELD_CAPS["user_agent"], nr.SLOT_FLAG_TRUNCATED,
        nr.SPILL_SLOTS, nr.SPILL_DATA_CAP, nr.SPILL_NONE, nr.WAIT_BUCKETS,
        nr.TELEMETRY_WORDS, nr.BODY_SLOTS, nr.BODY_WINDOW_CAP,
        nr.BODY_FLAG_FINAL, nr.BODY_FLAG_ABORT, nr.BODY_VERDICT_BIT)


def test_build_without_a_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nr, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nr.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        nr.build_ring_lib()
    assert not (tmp_path / "build").exists()


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "pingoo_ring.h").write_text("")
    (src / "pingoo_ring.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(nr, "NATIVE_DIR", src)
    monkeypatch.setattr(nr, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="ring library build failed"):
        nr.build_ring_lib()
    assert not any((tmp_path / "build").iterdir())


def test_built_library_is_named_by_source_hash():
    nr.build_ring_lib()
    path = nr.ring_lib_path()
    assert path.parent == nr.BUILD_DIR and path.is_file()
    assert path.name.startswith("libpingoo_ring-")
    assert nr.build_ring_lib() == 0.0  # built: nothing to do


def test_library_name_holds_the_compiler_identity(monkeypatch):
    # A _build/ copied from another machine or compiler must not load.
    here = nr.ring_lib_path()
    monkeypatch.setattr(nr, "_compiler_identity",
                        lambda cxx: "aarch64\nc++ (other) 99.0\n")
    assert nr.ring_lib_path() != here


# -- one ring file, two clients ---------------------------------------------------


REQS = [
    dict(method=b"GET", host=b"h.test", path=b"/a", url=b"/a?x=1",
         user_agent=b"UA", ip=bytes(range(16)), port=1234, asn=64500,
         country=b"FR"),
    dict(path=b"/b", url=b"/b", user_agent=b"curl"),
    dict(method=b"POST", host=b"x" * 300, path=b"/" + b"p" * 2500,
         url=b"/" + b"u" * 3000 + b"NEEDLE", user_agent=b"ua" * 200,
         ip=b"\x00" * 10 + b"\xff\xff\x0a\x00\x00\x01", port=65535,
         asn=2**32 - 1, country=b"US"),
]


@pytest.mark.parametrize("producer", ["reference", "port"])
def test_one_ring_file_two_clients(tmp_path, producer):
    path = str(tmp_path / "ring")
    p_cls, c_cls = (ref_nr.Ring, nr.Ring) if producer == "reference" \
        else (nr.Ring, ref_nr.Ring)
    prod = p_cls(path, capacity=64, create=True)
    cons = c_cls(path, capacity=64)
    try:
        assert cons.capacity == 64
        assert [prod.enqueue(**r) for r in REQS] == [0, 1, 2]
        assert cons.sidecar_attach() == 1
        assert prod.liveness()["epoch"] == 1
        buf = np.zeros(8, dtype=nr.REQUEST_SLOT_DTYPE)
        assert cons.dequeue_batch_into(buf) == 3
        slots = buf[:3]
        assert slots["flags"][2] & nr.SLOT_FLAG_TRUNCATED
        assert slots["spill_idx"][2] != nr.SPILL_NONE
        assert cons.spill_read(int(slots["spill_idx"][2])) == \
            (REQS[2]["url"], REQS[2]["path"])
        cons.spill_release(int(slots["spill_idx"][2]))
        got, want = nr.slots_to_arrays(slots), ref_nr.slots_to_arrays(slots)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert cons.post_verdicts(slots["ticket"],
                                  np.array([1, 0, 13], dtype=np.uint8)) == 3
        cons.record_waits(slots["enq_ms"])
        cons.set_posted_floor(3)
        assert {prod.poll_verdict()[:2] for _ in range(3)} == \
            {(0, 1), (1, 0), (2, 13)}
        assert prod.poll_verdict() is None
        tel = prod.telemetry()
        assert tel["enqueued"] == tel["dequeued"] == 3
        assert tel["verdicts_posted"] == 3 and sum(tel["wait_hist"]) == 3
        assert prod.liveness()["posted_floor"] == 3
        assert prod.enqueue_body(0, 1, b"x=1&y=2", 7, nr.BODY_FLAG_FINAL)
        (body,) = cons.dequeue_bodies()
        assert (body["flow"], body["win_seq"], body["total_len"],
                body["flags"]) == (0, 1, 7, nr.BODY_FLAG_FINAL)
        assert bytes(body["data"][:body["win_len"]]) == b"x=1&y=2"
    finally:
        cons.close()
        prod.close()


# -- verdict parity on seeded CRS traffic ------------------------------------------


@pytest.fixture(scope="module")
def crs_served(tmp_path_factory):
    """Each seed's stream of 256 CRS-style requests (30% attacks) through
    one reference sidecar and one port sidecar: {seed: (reference drive,
    port drive)}."""
    tmp = tmp_path_factory.mktemp("crs")
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    streams = {s: nr.pack_requests(generate_traffic(
        256, attack_fraction=0.3, seed=s, lists=lists)) for s in SEEDS}
    out = {s: [] for s in SEEDS}
    with pytest.MonkeyPatch.context() as mp:
        _set_env(mp)
        for ring_cls, make in (
                (ref_nr.Ring, lambda ring: ref_nr.RingSidecar(
                    ring, ref_compile(ref_rules, ref_lists), ref_lists,
                    max_batch=128)),
                (nr.Ring, lambda ring: nr.RingSidecar(
                    ring, compile_ruleset(rules, lists, device="cpu"), lists,
                    max_batch=128, device="cpu"))):
            ring = ring_cls(str(tmp / ring_cls.__module__), capacity=512,
                            create=True)
            try:
                sidecar = make(ring)
                with serving(sidecar):
                    for s in SEEDS:
                        out[s].append(nr.drive_stream(ring, streams[s]))
            finally:
                ring.close()
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_crs_verdict_bytes_equal_the_reference(crs_served, seed):
    ref, port = crs_served[seed]
    assert len(port.actions) == 256
    assert port.actions == ref.actions
    assert port.checksum == ref.checksum
    acts = np.frombuffer(port.actions, dtype=np.uint8)
    assert (acts & 3 == 1).any() and (acts & 3 == 0).any()


# -- routes, several rings, spill rows ------------------------------------------------


EVIL = [("blk", 'http_request.path.starts_with("/evil")', True)]


def _req(path, host=b"h"):
    return dict(path=path, url=path, host=host, user_agent=b"ua")


def test_route_lane_with_host_fallback_route(tmp_path):
    routes = [("api", 'http_request.path.starts_with("/api")'),
              # '+' is outside the device subset: a host route
              ("hostsvc", 'http_request.host + "" == "hosted.test"'),
              ("web", None)]
    plans = both_plans(EVIL, routes)
    assert plans[1].stats["host_routes"] == plans[0].stats["host_routes"] == 1
    reqs = [_req(b"/api/v1", b"x.test"), _req(b"/p", b"hosted.test"),
            _req(b"/p", b"x.test"), _req(b"/evil", b"x.test")]
    (ref,), (got,), _ = serve_both(tmp_path, plans, [reqs],
                                   services=["api", "hostsvc", "web"])
    assert got == ref
    assert [(got[t] >> 3) & 31 for t in range(4)] == [0, 1, 2, 2]
    assert got[3] & 3 == 1  # blocked and routed


def test_ring_services_per_listener_orders(tmp_path):
    plans = both_plans(EVIL, [("api", 'http_request.path.starts_with("/api")'),
                              ("web", None)])
    reqs = [[_req(b"/api/x"), _req(b"/evil")] for _ in range(3)]
    ref, got, _ = serve_both(tmp_path, plans, reqs,
                             ring_services=[["api", "web"], ["web"], None])
    assert got == ref
    assert [(g[0] >> 3) & 31 for g in got] == [0, 0, 0]
    assert [(g[1] >> 3) & 31 for g in got] == [1, 0, 0]
    assert all(g[1] & 3 == 1 for g in got)


def test_overflow_row_routes_in_ring_group_order(tmp_path):
    plans = both_plans(EVIL, [("deep", 'http_request.url.contains("NEEDLE")'),
                            ("other", 'http_request.host == "other.test"')])
    deep = b"/" + b"a" * 3000 + b"NEEDLE"
    reqs = [[_req(deep)], [_req(deep)]]
    ref, got, sidecar = serve_both(
        tmp_path, plans, reqs,
        ring_services=[["deep", "other"], ["other", "deep"]])
    assert got == ref
    assert [(g[0] >> 3) & 31 for g in got] == [0, 1]
    assert sidecar.spilled_rows == 2


def test_verdicts_scatter_to_owning_ring(tmp_path):
    reqs = [[_req(b"/evil" if (i + j) % 2 == 0 else b"/fine")
             for j in range(5)] for i in range(3)]
    ref, got, sidecar = serve_both(tmp_path, both_plans(EVIL), reqs,
                                   max_batch=64)
    assert got == ref
    for i, g in enumerate(got):
        assert [g[j] & 3 for j in range(5)] == \
            [1 if (i + j) % 2 == 0 else 0 for j in range(5)]
    assert sidecar.processed == 15


def test_spilled_rows_are_blocked_exactly(tmp_path):
    plans = both_plans([("deep", 'http_request.url.contains("NEEDLE")',
                         True)])
    reqs = [[_req(b"/" + b"a" * 3000 + b"NEEDLE"),  # past the slot view
             _req(b"/" + b"c" * 3000), _req(b"/NEEDLE")]]
    (ref,), (got,), sidecar = serve_both(tmp_path, plans, reqs)
    assert got == ref
    assert [got[t] & 3 for t in range(3)] == [1, 0, 1]
    assert sidecar.spilled_rows == 2 and sidecar.truncated_rows == 2


class FakeGeoip:
    """`lookup` of one known IPv4 address; anything else is not found."""

    def lookup(self, addr):
        if str(addr) != "10.0.0.1":
            raise KeyError(addr)
        return type("Rec", (), {"asn": 64500, "country": "FR"})()


def test_geoip_fills_unknown_rows(tmp_path):
    plans = both_plans([("geo", 'client.country == "FR"', True),
                        ("asn", "client.asn == 64500", True)])
    v4 = b"\x00" * 10 + b"\xff\xff"
    reqs = [[dict(path=b"/", ip=v4 + bytes([10, 0, 0, 1])),  # filled in
             dict(path=b"/", ip=v4 + bytes([10, 0, 0, 2])),  # not found
             dict(path=b"/", ip=v4 + bytes([10, 0, 0, 1]), asn=5,
                  country=b"DE")]]  # known already: left as it is
    (ref,), (got,), _ = serve_both(tmp_path, plans, reqs, geoip=FakeGeoip())
    assert got == ref
    assert [got[t] & 3 for t in range(3)] == [1, 0, 0]


# -- reattach: orphans of a dead sidecar -----------------------------------------------


def _orphan_want(i):
    return 1 if (i % 3 == 0 or i % 7 == 0) else 0


def _orphan_enq(ring, i):
    path = b"/evil/%d" % i if i % 3 == 0 else b"/ok/%d" % i
    ua = b"chaosbot/1.0" if i % 7 == 0 else b"Mozilla/5.0"
    return ring.enqueue(method=b"GET", host=b"r.test", path=path, url=path,
                        user_agent=ua)


ORPHAN_RULES = [
    ("waf", 'http_request.path.starts_with("/evil")', True),
    ("bot", 'http_request.user_agent.contains("chaosbot")', True)]


@pytest.mark.parametrize("case", ["intact", "recycled"])
def test_reattach_reconciles_orphans_like_the_reference(tmp_path, case):
    """intact: 10 of 24 tickets dequeued by a dead epoch, never answered,
    are re-evaluated exactly once; recycled: producers lapped the dead
    epoch's 8 tickets, which fail open."""
    capacity, n, dead = (256, 24, 10) if case == "intact" else (8, 16, 8)
    outs = []
    for ring_cls, sidecar_cls, kw, plan in zip(
            (ref_nr.Ring, nr.Ring), (ref_nr.RingSidecar, nr.RingSidecar),
            ({}, {"device": "cpu"}), both_plans(ORPHAN_RULES)):
        ring = ring_cls(str(tmp_path / ring_cls.__module__),
                        capacity=capacity, create=True)
        try:
            ring.sidecar_attach()  # epoch 1: the consumer that dies
            first = n if case == "intact" else dead
            for i in range(first):
                assert _orphan_enq(ring, i) is not None
            assert len(ring.dequeue_batch(dead)) == dead
            for i in range(first, n):  # lapping the dead consumer
                assert _orphan_enq(ring, i) is not None
            sidecar = sidecar_cls(ring, plan, {}, max_batch=16, **kw)
            floor = ring.liveness()["posted_floor"]
            with serving(sidecar, max_requests=n - dead) as t:
                got = poll_all([ring], [n])[0]
                t.join(timeout=30)
            outs.append((sidecar.epoch, dict(sidecar.reconciled), floor,
                         ring.liveness()["posted_floor"], got))
        finally:
            ring.close()
    assert outs[1] == outs[0]
    epoch, reconciled, floor, final_floor, got = outs[1]
    assert epoch == 2 and floor == dead and final_floor == n
    assert reconciled == ({"reeval": dead, "failopen": 0}
                          if case == "intact"
                          else {"reeval": 0, "failopen": dead})
    assert sorted(got) == list(range(n))
    assert all(len(v) == 1 for v in got.values())
    for t in range(n):
        want = 0 if case == "recycled" and t < dead else _orphan_want(t)
        assert got[t][0] & 3 == want, t


# -- liveness, the card, the drive's guard, the C++ producer ---------------------------


def test_heartbeat_advances_while_serving(tmp_path):
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, both_plans(ORPHAN_RULES)[1], {},
                                 max_batch=16, device="cpu")
        hb0 = ring.liveness()["heartbeat_ms"]
        assert hb0 > 0 and sidecar.epoch == 1
        real = sidecar._lane_fn

        def slow(*args):  # a batch that blocks well past the 500 ms limit
            time.sleep(0.7)
            return real(*args)

        sidecar._lane_fn = slow
        stream = [(b"GET", b"r.test", p, p, b"ua", b"\x00" * 16, 0, 0, b"XX")
                  for p in (b"/evil/1", b"/ok/2", b"/evil/3")]
        with serving(sidecar):
            r = nr.drive_stream(ring, stream)
            time.sleep(0.05)
            lv = ring.liveness()
        assert [a & 3 for a in r.actions] == [1, 0, 1]
        assert sidecar.stage_ms["verdict"][0] >= 700
        # The watchdog stamped through the slow batch, the loop after it.
        assert r.max_heartbeat_age_ms < 500
        assert lv["heartbeat_ms"] > hb0
        assert lv["now_ms"] - lv["heartbeat_ms"] < 500
    finally:
        ring.close()


def test_sidecar_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = both_plans(EVIL)[1]
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nr.RingSidecar(ring, plan, {})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nr.RingSidecar(ring, plan, {}, device="cuda")
        assert ring.liveness()["epoch"] == 0  # never attached
    finally:
        ring.close()


@pytest.mark.parametrize("name,value", [
    ("PINGOO_SCHED_MODE", "continuous"), ("PINGOO_SCHED_FAILOPEN", "allow")])
def test_sidecar_refuses_the_scheduler_knobs(tmp_path, monkeypatch, name,
                                             value):
    plan = both_plans(EVIL)[1]
    monkeypatch.setenv(name, value)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        with pytest.raises(NotImplementedError, match="item 9"):
            nr.RingSidecar(ring, plan, {}, device="cpu")
        assert ring.liveness()["epoch"] == 0
    finally:
        ring.close()


@pytest.mark.parametrize("fault", ["answered twice", "unknown ticket"])
def test_drive_raises_on_a_bad_verdict(tmp_path, fault):
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        # Verdicts already on the ring when the drive's request takes
        # ticket 0: ticket 0 twice, or a ticket it never issued.
        for t in ((0, 0) if fault == "answered twice" else (7,)):
            assert ring.post_verdict(t, 1)
        stream = nr.pack_requests(generate_traffic(1, seed=3))
        with pytest.raises(RuntimeError, match=fault):
            nr.drive_stream(ring, stream, timeout_s=10)
    finally:
        ring.close()


def test_cxx_loadgen_through_the_port_sidecar(tmp_path):
    """The reference's C++ producer against both sidecars: every request
    answered, the same block and captcha counts."""
    if not ref_nr.ensure_built():
        pytest.skip("native toolchain unavailable")
    loadgen = os.path.join(ref_nr.NATIVE_DIR, "loadgen")
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    n = 1000
    results = []
    for ring_cls, make in (
            (ref_nr.Ring, lambda ring: ref_nr.RingSidecar(
                ring, ref_compile(ref_rules, ref_lists), ref_lists,
                max_batch=128)),
            (nr.Ring, lambda ring: nr.RingSidecar(
                ring, compile_ruleset(rules, lists, device="cpu"), lists,
                max_batch=128, device="cpu"))):
        path = str(tmp_path / ring_cls.__module__)
        ring = ring_cls(path, capacity=1024, create=True)
        try:
            sidecar = make(ring)
            with serving(sidecar, max_requests=n) as t:
                proc = subprocess.run([loadgen, path, str(n), "100"],
                                      capture_output=True, text=True,
                                      timeout=120)
                t.join(timeout=60)
        finally:
            ring.close()
        assert proc.returncode == 0, proc.stderr
        results.append(json.loads(proc.stdout.strip()))
        assert sidecar.processed == n
    ref, got = results
    assert got["received"] == n
    assert n * 0.02 < got["blocked"] < n * 0.4, got
    assert (got["blocked"], got["captcha"]) == (ref["blocked"],
                                                ref["captcha"])


def test_ring_verdict_bytes_equal_the_verdict_service(tmp_path):
    """The sidecar's byte for each request is VerdictService's action with
    verified_block in bit 2, on the same requests."""
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    plan = compile_ruleset(rules, lists, device="cpu")
    reqs = generate_traffic(96, attack_fraction=0.5, seed=11, lists=lists)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=128, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, lists, max_batch=64,
                                 device="cpu")
        with serving(sidecar):
            r = nr.drive_stream(ring, nr.pack_requests(reqs))
    finally:
        ring.close()
    verdicts = VerdictService(plan, lists, device="cpu").evaluate_batch(reqs)
    assert r.actions == bytes(v.action | (v.verified_block << 2)
                              for v in verdicts)
    assert sidecar.processed == 96 and sidecar.batches >= 2
    # One timing per batch, up to the window's bound.
    assert all(len(v) == min(sidecar.batches, sidecar.WINDOW)
               and v.count == sidecar.batches
               for v in sidecar.stage_ms.values())


def test_sidecar_timing_stays_bounded(tmp_path, monkeypatch):
    """Past the window's bound the sidecar keeps WINDOW timings per stage
    and its counts stay exact: its memory does not grow with uptime."""
    monkeypatch.setattr(nr.RingSidecar, "WINDOW", 4)
    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    plan = compile_ruleset(rules, lists, device="cpu")
    reqs = generate_traffic(96, attack_fraction=0.5, seed=12)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=128, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, lists, max_batch=8,
                                 device="cpu")
        with serving(sidecar):
            stream = nr.pack_requests(reqs)
            for k in range(0, len(stream), 8):  # one batch at a time
                nr.drive_stream(ring, stream[k:k + 8])
    finally:
        ring.close()
    assert sidecar.processed == 96 and sidecar.batches >= 12
    for name, window in sidecar.stage_ms.items():
        assert len(window) == 4, name
        assert window.count == sidecar.batches, name
        assert len(window.since(window.count - 2)) == 2
        assert len(window.since(0)) == 4
