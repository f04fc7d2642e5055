"""The port's streaming body inspection against the JAX package's, on
the CPU, with exact equality.

  * Tables: the seed rule set and the CRS payload cores as 53 regex body
    rules compile to the JAX package's NFA, exact-DFA and prefilter
    tables array by array, and `body_tables_from_reference` carries the
    JAX package's into a port plan equal to the port's own.
  * Split-anywhere parity: payloads cut at sampled points give the JAX
    scanner's verdict and the oracle's, in the modes nfa, dfa and nfa
    with lazy starts on and off, and per-flow carries equal the JAX
    scanner's after every call over interleaved flows with odd tails.
    A carry word with bit 31 set round-trips; an empty FINAL window and
    an empty body finish as in the reference.
  * Degrades (eviction, TTL, gap, abort), `merge_actions` over its whole
    domain, the knobs and a custom PINGOO_BODY_RULES file.
  * The port's `RingSidecar` with PINGOO_BODY_INSPECT=on posts the same
    metadata and body verdicts as the reference's, on two CRS seeds, and
    a scan error propagates out of `run()`.
"""

import json
import random
import threading

import numpy as np
import pytest
import torch

from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.engine import bodyscan as ref_bs
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.engine import bodyscan as bs
from pingoo_tpu_torch.utils.crs import (LFI_RCE_CORES, SQLI_CORES, XSS_CORES,
                                        generate_ruleset, generate_traffic)
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_SCHED_MODE": "fixed",
           "PINGOO_MEGASTEP": "off"}
BODY_ENV = ("PINGOO_BODY_INSPECT", "PINGOO_BODY_SCAN", "PINGOO_BODY_LAZY",
            "PINGOO_BODY_WINDOW", "PINGOO_BODY_MAX_FLOWS",
            "PINGOO_BODY_FLOW_TTL_MS", "PINGOO_BODY_RULES")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in BODY_ENV:
        monkeypatch.delenv(name, raising=False)


def crs_rules(mod):
    """The CRS payload cores (utils/crs.py) as regex body rules of `mod`
    (either package's bodyscan): every fourth one a captcha."""
    return tuple(mod.BodyRule(f"crs-{i}", p, "regex", False,
                              ("captcha",) if i % 4 == 3 else ("block",))
                 for i, p in enumerate(SQLI_CORES + XSS_CORES
                                       + LFI_RCE_CORES))


RULE_SETS = {"seed": (lambda mod: mod.DEFAULT_BODY_RULES, 64),
             "crs": (crs_rules, 128)}


@pytest.fixture(scope="module")
def plans():
    """{rule set: (reference plan, port plan)} on the CPU."""
    out = {}
    for name, (rules, window) in RULE_SETS.items():
        out[name] = (ref_bs.compile_body_plan(rules(ref_bs), window=window),
                     bs.compile_body_plan(rules(bs), window=window,
                                          device="cpu"))
    return out


PAYLOADS = [
    b"",
    b"a",
    b"id=1+UNION SELECT password from users--",
    b"union selec",
    b"x" * 37 + b"<ScRiPt>alert(1)</script>" + b"y" * 11,
    b"../../" + b"../../etc/shadow",
    b"e" * 64 + b"eval(base64_decode('aGk='))",
    b"<scrip" + b"t src=x>",
    b"' or '1'='1",
    b"q=1 union/**/all/**/select 2; <svg a=b onload =x> | id",
    b"f=" + b"z" * 150 + b"/etc/passwd&c=curl http://x",
    bytes(random.Random(7).randrange(256) for _ in range(181)),
]


def _cuts(n: int) -> list[int]:
    pts = {0, 1, n // 3, n // 2, n - 1, n} | set(
        random.Random(n).sample(range(n + 1), min(2, n + 1)))
    return sorted(p for p in pts if 0 <= p <= n)


def _feed(mod, scanner, payload, cuts, flow_id=1):
    """`payload` through `scanner`, split at `cuts`; returns its verdict."""
    bounds = [0] + list(cuts) + [len(payload)]
    pieces = [payload[a:b] for a, b in zip(bounds, bounds[1:])] or [b""]
    out = []
    for i, piece in enumerate(pieces):
        out = scanner.scan_windows([mod.BodyWindow(
            flow_id, i, piece, final=i == len(pieces) - 1)])
    assert len(out) == 1
    return out[0]


def vtuple(v):
    return (v.flow_id, v.unverified, v.verified_block, v.matched, v.degraded)


def _words(a):
    return None if a is None else (str(a.dtype), np.asarray(a).tolist())


def carries(scanner) -> dict:
    """Every live flow's carry, in comparable form."""
    return {fid: (fs.offset, fs.next_seq, fs.started, fs.degraded, fs.tail,
                  int(fs.dfa_state), _words(fs.nfa_state), _words(fs.dfa_h),
                  _words(fs.pf_s), _words(fs.pf_h))
            for fid, fs in scanner.flows.items()}


def stats(scanner) -> dict:
    return dict(vars(scanner.stats))


def scanners(plans, name, mode, **kw):
    ref_plan, plan = plans[name]
    return (ref_bs.BodyScanner(ref_plan, mode=mode, **kw),
            bs.BodyScanner(plan, mode=mode, device="cpu", **kw))


# -- tables -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_tables_equal_the_reference(plans, name):
    ref_plan, plan = plans[name]
    carried = bs.body_tables_from_reference(ref_plan, "cpu")
    for key in ("tables", "dfa_tables", "pf_tables"):
        ref_t, own, car = (getattr(p, key) for p in (ref_plan, plan, carried))
        assert (ref_t is None) == (own is None) == (car is None), key
        if own is None:
            continue
        arrays, carried_arrays = own.numpy_arrays(), car.numpy_arrays()
        assert sorted(arrays) == sorted(carried_arrays)
        for field, a in arrays.items():
            want = np.asarray(getattr(ref_t, field))
            for got in (a, carried_arrays[field]):
                assert got.dtype == want.dtype, (key, field)
                np.testing.assert_array_equal(got, want, err_msg=field)
        assert own.meta() == car.meta()
    want_rules = crs_rules(bs) if name == "crs" else bs.DEFAULT_BODY_RULES
    for p in (plan, carried):
        assert p.rules == want_rules
        for field in ("slot_rule", "rule_first", "rule_has_block"):
            np.testing.assert_array_equal(getattr(p, field),
                                          getattr(ref_plan, field))
        assert (p.lazy_ok, p.tail_cap, p.window) == (
            ref_plan.lazy_ok, ref_plan.tail_cap, ref_plan.window)
        assert [(r.pattern, r.flags) for r in p.oracle_res] == \
            [(r.pattern, r.flags) for r in ref_plan.oracle_res]
    # What the two sets exercise: the seed set has an exact DFA and lazy
    # starts; the CRS set neither, a 41-word NFA and 14 prefilter words.
    if name == "seed":
        assert plan.dfa_tables is not None and plan.lazy_ok
    else:
        assert plan.dfa_tables is None and not plan.lazy_ok
        assert (plan.tables.num_words, plan.pf_tables.num_words) == (41, 14)


# -- split-anywhere parity ----------------------------------------------------

MODES = [("seed", "nfa", "auto"), ("seed", "nfa", "off"),
         ("seed", "dfa", "auto"), ("crs", "nfa", "auto")]


@pytest.mark.parametrize("name,mode,lazy", MODES)
def test_split_anywhere_parity(plans, monkeypatch, name, mode, lazy):
    monkeypatch.setenv("PINGOO_BODY_LAZY", lazy)
    ref_plan, plan = plans[name]
    for payload in PAYLOADS:
        oracle = bs.body_lanes_oracle(plan, payload)
        assert oracle == ref_bs.body_lanes_oracle(ref_plan, payload)
        for cut in _cuts(len(payload)):
            ref_s, port_s = scanners(plans, name, mode)
            assert port_s.lazy == ref_s.lazy == (
                name == "seed" and mode == "nfa" and lazy == "auto")
            got = _feed(bs, port_s, payload, [cut])
            want = _feed(ref_bs, ref_s, payload, [cut])
            assert vtuple(got) == vtuple(want), (payload, cut)
            assert (got.unverified, got.verified_block) == oracle[:2]
            assert set(got.matched) == set(oracle[2])
            assert stats(port_s) == stats(ref_s)


@pytest.mark.parametrize("name,mode,lazy", MODES)
def test_interleaved_flows_carry_like_the_reference(plans, monkeypatch, name,
                                                    mode, lazy):
    """Seven flows (an odd round, one padded row) cut at random points,
    all their windows in each call: verdicts and every live flow's carry
    equal the JAX scanner's after each call."""
    monkeypatch.setenv("PINGOO_BODY_LAZY", lazy)
    rng = random.Random(11)
    payloads = [p for p in PAYLOADS if len(p) > 20][:7]
    per_flow = []
    for fid, p in enumerate(payloads):
        cuts = sorted(rng.sample(range(len(p) + 1), 3))
        bounds = [0] + cuts + [len(p)]
        per_flow.append([(fid, s, p[a:b], s == 3)
                         for s, (a, b) in enumerate(zip(bounds, bounds[1:]))])
    ref_s, port_s = scanners(plans, name, mode)
    for call in range(2):  # windows 0-1, then 2-3 (the FINAL ones)
        ws = [w for f in per_flow for w in f[2 * call:2 * call + 2]]
        got = port_s.scan_windows([bs.BodyWindow(*w) for w in ws])
        want = ref_s.scan_windows([ref_bs.BodyWindow(*w) for w in ws])
        assert [vtuple(v) for v in got] == [vtuple(v) for v in want]
        assert carries(port_s) == carries(ref_s)
        assert stats(port_s) == stats(ref_s)
    assert len(got) == len(payloads) and not port_s.flows
    ref_plan = plans[name][0]
    for v in got:
        o = ref_bs.body_lanes_oracle(ref_plan, payloads[v.flow_id])
        assert (v.unverified, v.verified_block) == o[:2]


@pytest.mark.parametrize("name,mode", [("seed", "dfa"), ("crs", "nfa")])
def test_carry_word_with_bit_31_round_trips(plans, name, mode):
    """A carried word with bit 31 set goes to the scan and back as the
    same bits (int32 tensors hold the uint32 words)."""
    ref_s, port_s = scanners(plans, name, mode)
    first = b"q=union select and <svg x=1 onload="
    for s in (ref_s, port_s):
        mod = ref_bs if s is ref_s else bs
        s.scan_windows([mod.BodyWindow(3, 0, first)])
        fs = s.flows[3]
        fs.pf_s = fs.pf_s | np.uint32(0x80000000)
        fs.pf_h = fs.pf_h | np.uint32(0x80000001)
        if mode == "dfa":
            fs.dfa_h = fs.dfa_h | np.uint32(0xC0000000)
        else:
            fs.nfa_state = fs.nfa_state | np.uint32(0x80000000)
    before = carries(port_s)
    assert before == carries(ref_s)
    words = before[3][7] if mode == "dfa" else before[3][6]
    assert any(w >= 2**31 for w in words[1])
    got = port_s.scan_windows([bs.BodyWindow(3, 1, b"=1>x", final=False)])
    want = ref_s.scan_windows([ref_bs.BodyWindow(3, 1, b"=1>x")])
    assert got == [] and want == []
    assert carries(port_s) == carries(ref_s)
    got = port_s.scan_windows([bs.BodyWindow(3, 2, b"", final=True)])
    want = ref_s.scan_windows([ref_bs.BodyWindow(3, 2, b"", final=True)])
    assert [vtuple(v) for v in got] == [vtuple(v) for v in want]


def test_host_device_views_keep_the_bits():
    words = np.array([[0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]], np.uint32)
    t = bs._on(torch.device("cpu"), words)
    assert t.dtype == torch.int32 and t.tolist() == [[0, 1, 2**31 - 1,
                                                      -2**31, -1]]
    (back,) = bs._to_host(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, words)
    st, h, hit = bs._to_host(torch.tensor([-5, 7], dtype=torch.int32),
                             t.expand(2, 5), torch.tensor([True, False]))
    assert st.tolist() == [-5, 7] and hit.astype(bool).tolist() == [True,
                                                                   False]
    np.testing.assert_array_equal(h, np.repeat(words, 2, axis=0))


@pytest.mark.parametrize("name,mode,lazy", MODES)
def test_empty_final_window_and_empty_body(plans, monkeypatch, name, mode,
                                           lazy):
    monkeypatch.setenv("PINGOO_BODY_LAZY", lazy)
    outs = []
    for s, mod in zip(scanners(plans, name, mode), (ref_bs, bs)):
        out = s.scan_windows([mod.BodyWindow(1, 0, b"a<script"),
                              mod.BodyWindow(1, 1, b"", final=True),
                              mod.BodyWindow(2, 0, b"", final=True),
                              mod.BodyWindow(4, 0, b"../../x")])
        out += s.scan_windows([mod.BodyWindow(4, 1, b"", final=True)])
        outs.append(([vtuple(v) for v in out], stats(s)))
    assert outs[1] == outs[0]
    assert [v[0] for v in outs[1][0]] == [2, 1, 4]  # by round


# -- flow table degrades --------------------------------------------------------


def _degrade_script(mod):
    """One sequence of calls hitting every degrade: eviction at a full
    table, the TTL, a window gap and an abort."""
    W = mod.BodyWindow
    return [
        ("scan", [W(1, 0, b"union sel"), W(2, 0, b"<scr")]),
        ("tick", 10),
        ("scan", [W(3, 0, b"x")]),  # evicts flow 1, the stalest
        ("scan", [W(1, 1, b"ect", final=True)]),  # flow 1 again: a gap
        ("scan", [W(2, 1, b"ipt", final=True)]),
        ("scan", [W(5, 0, b"eval("), W(5, 1, b"", abort=True)]),
        ("scan", [W(5, 3, b"x", final=True)]),  # after the abort: a gap
        ("scan", [W(6, 0, b"/etc/")]),
        ("tick", 500),
        ("evict", None),  # flows 3 and 6 are past the TTL
        ("scan", [W(6, 1, b"passwd", final=True)]),
        ("scan", [W(7, 0, b"<script", final=True)]),
    ]


@pytest.mark.parametrize("mode", ["nfa", "dfa"])
def test_degrades_match_the_reference(plans, mode):
    runs = []
    for mod, kw in ((ref_bs, {}), (bs, {"device": "cpu"})):
        clock = [0]
        plan = plans["seed"][0 if mod is ref_bs else 1]
        s = mod.BodyScanner(plan, mode=mode, max_flows=2, flow_ttl_ms=100,
                            now_ms=lambda: clock[0], **kw)
        trace = []
        for op, arg in _degrade_script(mod):
            if op == "tick":
                clock[0] += arg
            elif op == "evict":
                trace.append(("evicted", s.evict_stale()))
            else:
                trace.append([vtuple(v) for v in s.scan_windows(arg)])
            trace.append((sorted(s.flows), stats(s)))
        runs.append(trace)
    assert runs[1] == runs[0]
    final = runs[1][-1][1]
    assert set(final["degrade_reasons"]) == {"evict", "gap", "ttl"}


def test_merge_actions_equals_the_reference_everywhere():
    for meta in range(256):
        for unverified in range(4):
            for vb in (False, True):
                assert bs.merge_actions(meta, unverified, vb) == \
                    ref_bs.merge_actions(meta, unverified, vb)
    for v in (bs.BodyVerdict(1, 2, True), bs.BodyVerdict(1, 1, False),
              bs.BodyVerdict(1)):
        assert v.action_byte() == ref_bs.BodyVerdict(
            1, v.unverified, v.verified_block).action_byte()


# -- knobs, rule files, the card ----------------------------------------------


def test_knobs_read_as_the_reference(plans, monkeypatch):
    for name in ("seed", "crs"):
        ref_plan, plan = plans[name]
        for scan in ("auto", "nfa", "dfa"):
            monkeypatch.setenv("PINGOO_BODY_SCAN", scan)
            assert bs.resolve_scan_mode(plan) == \
                ref_bs.resolve_scan_mode(ref_plan)
    monkeypatch.setenv("PINGOO_BODY_SCAN", "nfa")
    monkeypatch.setenv("PINGOO_BODY_MAX_FLOWS", "17")
    monkeypatch.setenv("PINGOO_BODY_FLOW_TTL_MS", "123")
    monkeypatch.setenv("PINGOO_BODY_LAZY", "off")
    s = bs.BodyScanner(plans["seed"][1], device="cpu")
    assert (s.mode, s.max_flows, s.flow_ttl_ms, s.lazy) == ("nfa", 17, 123,
                                                            False)
    assert not bs.body_inspect_enabled()
    monkeypatch.setenv("PINGOO_BODY_INSPECT", "on")
    assert bs.body_inspect_enabled() and ref_bs.body_inspect_enabled()


def test_custom_rules_file(tmp_path, monkeypatch):
    path = tmp_path / "body_rules.json"
    path.write_text(json.dumps([
        {"name": "r1", "pattern": "abc", "kind": "literal",
         "actions": ["block"]},
        {"name": "r2", "pattern": r"id=[0-9]+--", "kind": "regex",
         "actions": ["captcha", "block"]},
        {"name": "r3", "pattern": "SeLeCt", "case_insensitive": True}]))
    monkeypatch.setenv("PINGOO_BODY_RULES", str(path))
    monkeypatch.setenv("PINGOO_BODY_WINDOW", "32")
    rules = bs.load_body_rules()
    assert [tuple(vars(r).values()) for r in rules] == \
        [tuple(vars(r).values()) for r in ref_bs.load_body_rules()]
    assert rules[0] == bs.BodyRule("r1", "abc", "literal", False, ("block",))
    port_s = bs.BodyScanner(device="cpu")  # rules and window from the env
    ref_s = ref_bs.BodyScanner()
    assert port_s.plan.window == 32 and port_s.plan.rules == rules
    for p in (b"x" * 40 + b"id=12--", b"ab" + b"c" * 40 + b"select",
              b"nothing"):
        assert vtuple(port_s.scan_buffered(p, 9)) == \
            vtuple(ref_s.scan_buffered(p, 9))


def test_entry_points_default_to_the_card(monkeypatch, plans):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bs.compile_body_plan(bs.DEFAULT_BODY_RULES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bs.BodyScanner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bs.BodyScanner(plans["seed"][1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bs.body_tables_from_reference(plans["seed"][0], None)
    assert bs.BodyScanner(plans["seed"][1], device="cpu").plan.device.type \
        == "cpu"


# -- the native plane ------------------------------------------------------------

SIDECAR_SEEDS = (7, 2026)
BODY_ALPHABET = b"abcdefghijklmnop0123456789=&"


def body_stream(n: int, seed: int) -> list:
    """Every fourth request of `n` gets a body of 0-600 bytes over a
    filler alphabet; one body in three carries a CRS attack string."""
    rng = random.Random(seed)
    attacks = [b"1' UNION SELECT pass --", b"<script>alert(1)</script>",
               b"../../../../etc/passwd", b"; cat /etc/shadow", b"eval(x)"]
    bodies = []
    for k in range(n):
        if k % 4:
            bodies.append(None)
            continue
        body = bytes(rng.choices(BODY_ALPHABET, k=rng.randint(0, 600)))
        if rng.random() < 1 / 3:
            at = rng.randint(0, len(body))
            body = body[:at] + rng.choice(attacks) + body[at:]
        bodies.append(body)
    return bodies


@pytest.fixture(scope="module")
def body_served(tmp_path_factory):
    """Each seed's 128 CRS requests with bodies, through the reference's
    sidecar and the port's, PINGOO_BODY_INSPECT=on with the CRS body
    rules: {seed: (reference drive, port drive)}, and the port sidecar."""
    tmp = tmp_path_factory.mktemp("body")
    rules_file = tmp / "crs_body_rules.json"
    rules_file.write_text(json.dumps([dict(
        name=r.name, pattern=r.pattern, kind=r.kind,
        actions=list(r.actions)) for r in crs_rules(bs)]))
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    streams = {s: (nr.pack_requests(generate_traffic(
        128, attack_fraction=0.3, seed=s, lists=lists)), body_stream(128, s))
        for s in SIDECAR_SEEDS}
    out = {s: [] for s in SIDECAR_SEEDS}
    sidecars = []
    with pytest.MonkeyPatch.context() as mp:
        for name in BODY_ENV:
            mp.delenv(name, raising=False)
        for name, value in dict(
                REF_ENV, PINGOO_BODY_INSPECT="on", PINGOO_BODY_WINDOW="256",
                PINGOO_BODY_RULES=str(rules_file)).items():
            mp.setenv(name, value)
        for ring_cls, make in (
                (ref_nr.Ring, lambda ring: ref_nr.RingSidecar(
                    ring, ref_compile(ref_rules, ref_lists), ref_lists,
                    max_batch=64)),
                (nr.Ring, lambda ring: nr.RingSidecar(
                    ring, compile_ruleset(rules, lists, device="cpu"), lists,
                    max_batch=64, device="cpu"))):
            ring = ring_cls(str(tmp / ring_cls.__module__), capacity=256,
                            create=True)
            try:
                sidecar = make(ring)
                sidecars.append(sidecar)
                t = threading.Thread(target=sidecar.run, daemon=True)
                t.start()
                try:
                    for s in SIDECAR_SEEDS:
                        # The drive shares the sidecar's process: it
                        # sleeps when idle to leave the sidecar the lock.
                        out[s].append(nr.drive_stream(
                            ring, *streams[s], timeout_s=120,
                            idle_s=nr.DRIVE_IDLE_S))
                finally:
                    sidecar.stop()
                    t.join(timeout=30)
                assert not t.is_alive()
            finally:
                ring.close()
    return out, streams, sidecars[1]


@pytest.mark.parametrize("seed", SIDECAR_SEEDS)
def test_sidecar_body_verdicts_equal_the_reference(body_served, seed):
    out, streams, sidecar = body_served
    ref, port = out[seed]
    assert port.meta_actions == ref.meta_actions
    assert port.body_actions == ref.body_actions
    assert port.actions == ref.actions and port.checksum == ref.checksum
    bodies = {i: b for i, b in enumerate(streams[seed][1])
              if b is not None}
    assert sorted(port.body_actions) == sorted(bodies) and len(bodies) == 32
    # Each body byte is the oracle's over the contiguous body, and the
    # merged byte is merge_actions of both lanes.
    plan = sidecar.body_scanner.plan
    for i, body in bodies.items():
        unv, vb, _ = bs.body_lanes_oracle(plan, body)
        assert port.body_actions[i] == unv | (vb << 2), i
        assert port.actions[i] == bs.merge_actions(port.meta_actions[i],
                                                   unv, vb)
    assert any(port.body_actions.values())
    assert any(port.actions[i] != port.meta_actions[i] for i in bodies)
    assert sidecar.body_scanner.stats.degrade_total == 0
    assert sidecar.body_verdicts == 2 * len(bodies)
    assert len(sidecar.stage_ms["body"]) >= 1


def test_body_scan_error_propagates_out_of_run(tmp_path, monkeypatch):
    """A scan error demotes the ladder's body rung (as in the JAX
    package): the flow's final window is answered action 0 on the
    metadata verdict alone and the loop goes on. A kernel build error is
    never demoted: it propagates out of `run()`, nothing posted."""
    from pingoo_tpu_torch.ops._build import KernelBuildError

    monkeypatch.setenv("PINGOO_BODY_INSPECT", "on")
    monkeypatch.setenv("PINGOO_BODY_WINDOW", "64")
    for name, value in REF_ENV.items():
        monkeypatch.setenv(name, value)
    rules, lists = generate_ruleset(20, with_lists=False, seed=3)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, compile_ruleset(rules, lists,
                                                       device="cpu"),
                                 lists, device="cpu")

        def broken(windows):
            raise RuntimeError("scan failed on the device")

        def unbuilt(windows):
            raise KernelBuildError("nvcc exited 2")

        sidecar.body_scanner.scan_windows = broken
        assert ring.enqueue_body(0, 0, b"x=1", 3, nr.BODY_FLAG_FINAL)
        assert sidecar.run(max_requests=0) == 0
        assert ring.poll_verdict()[:2] == (nr.BODY_VERDICT_BIT, 0)
        assert ring.poll_verdict() is None
        snap = sidecar.stats()["ladder"]["body"]
        assert not snap["healthy"] and "scan failed" in snap["last_error"]
        sidecar.ladder.note_success("body")
        sidecar.body_scanner.scan_windows = unbuilt
        assert ring.enqueue_body(1, 0, b"x=1", 3, nr.BODY_FLAG_FINAL)
        with pytest.raises(KernelBuildError, match="nvcc"):
            sidecar.run()
        assert ring.poll_verdict() is None  # nothing posted, no fallback
        sidecar.stop()
    finally:
        ring.close()
