"""The halo split in the port, against the JAX package.

  * The plan under PINGOO_NFA_SPLIT=1: the @short/@rest sub-bank tables,
    `slot_perm`, both strategies, and the sub-banks' Stage-A masks, slot
    codes and `bank_gated` equal the JAX package's on the 500-rule corpus
    (at the default field specs and at 64-byte url/path), and
    `tables_from_reference` carries the sub-banks across.
  * `halo_split_k` equals the JAX package's over a grid of widths, halos
    and caps.
  * `halo_split_scan` on the plain version equals the JAX package's
    (lax.scan, and the Pallas kernel in interpret mode) and the port's
    unsplit scan, with rows ending at 0, 1, Lc - 1, Lc, Lc + 1 and L
    bytes and sticky, `$`- and `^`-anchored patterns.
  * Matrices and lanes under PINGOO_NFA_SPLIT=1, PINGOO_SCAN_STRATEGY=
    halo and PINGOO_HALO_SPLIT=1 equal the JAX package's under the same
    knob and the port's default, in every PINGOO_PREFILTER mode; the
    halo route runs (its calls are counted).
  * VerdictService (executor on and off, compact staging, the megastep)
    and RingSidecar (on, off, the megastep) serve the same verdicts on
    the split plan, and VerdictService under each runtime knob.
  * A fully bounded rule set halo-splits with no knob at all.

CPU only: 64-byte url/path specs (at L = 64 the corpus @short banks split
with k = 4: 16 + 14 < 32), small batches, no process started; the
tolerance is zero.
"""

import asyncio
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.compiler.nfa import build_bank as ref_build_bank
from pingoo_tpu.compiler.repat import compile_regex as ref_compile_regex
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import encode_requests as ref_encode
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.ops import nfa_scan as ref_nfa
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler.nfa import build_bank
from pingoo_tpu_torch.compiler.plan import compile_ruleset, \
    tables_from_reference
from pingoo_tpu_torch.compiler.repat import compile_regex
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine import verdict
from pingoo_tpu_torch.engine.batch import (RequestBatch, RequestTuple,
                                           batch_to_contexts)
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.expr import compile_expression, execute_as_bool
from pingoo_tpu_torch.ops import nfa_scan
from pingoo_tpu_torch.utils.crs import generate_ruleset
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
SPECS = {"host": 64, "url": 64, "path": 64, "method": 16, "user_agent": 64,
         "country": 2}
CLEARED_ENV = ("PINGOO_DFA", "PINGOO_PREFILTER", "PINGOO_PREFILTER_LEVELS",
               "PINGOO_PIPELINE", "PINGOO_PIPELINE_DEPTH",
               "PINGOO_SCHED_PIPELINE", "PINGOO_STAGING",
               "PINGOO_STAGING_DEPTH", "PINGOO_MEGASTEP", "PINGOO_MEGASTEP_K",
               "PINGOO_NFA_SPLIT", "PINGOO_SCAN_STRATEGY",
               "PINGOO_HALO_SPLIT", "PINGOO_HALO_FP_BUDGET",
               "PINGOO_BODY_INSPECT", "PINGOO_MESH", "PINGOO_CHAOS",
               "PINGOO_PARITY_SAMPLE", "PINGOO_PROVENANCE")
# knob -> the runtime environment it sets (every knob runs on the split
# plans, whose @short sub-banks are halo-compatible).
KNOBS = {"nfa_split": {}, "strategy_halo": {"PINGOO_SCAN_STRATEGY": "halo"},
         "halo_split": {"PINGOO_HALO_SPLIT": "1"}}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


def compile_both(n, seed, specs, split):
    """(reference plan, its lists, port plan, its lists) for the corpus
    of `n` rules, compiled with PINGOO_NFA_SPLIT=1 when `split`."""
    kw = {} if seed is None else {"seed": seed}
    ref_rules, ref_lists = ref_generate_ruleset(n, **kw)
    rules, lists = generate_ruleset(n, **kw)
    with pytest.MonkeyPatch.context() as mp:
        for name in CLEARED_ENV:
            mp.delenv(name, raising=False)
        if split:
            mp.setenv("PINGOO_NFA_SPLIT", "1")
        return (ref_compile(ref_rules, ref_lists, field_specs=specs),
                ref_lists,
                compile_ruleset(rules, lists, field_specs=specs,
                                device="cpu"), lists)


@pytest.fixture(scope="module", params=["default_specs", "narrow_specs"])
def split500(request):
    specs = None if request.param == "default_specs" else SPECS
    return request.param, compile_both(500, None, specs, True)


def ref_arrays(value):
    return {f.name: np.asarray(getattr(value, f.name))
            for f in dataclasses.fields(value)
            if hasattr(getattr(value, f.name), "shape")}


def test_split_tables_equal_the_reference(split500):
    name, (ref, _, port, _) = split500
    assert list(port.np_tables) == list(ref.np_tables)
    subs = [k for k in port.np_tables if "@" in k]
    assert subs == ["nfa_url@short", "nfa_url@rest", "nfa_path@short",
                    "nfa_path@rest"]
    for key in subs:
        got = port.np_tables[key].numpy_arrays()
        want = ref_arrays(ref.np_tables[key])
        assert set(got) == set(want), key
        for field, w in want.items():
            assert got[field].dtype == w.dtype, (key, field)
            np.testing.assert_array_equal(got[field], w,
                                          err_msg=f"{key}.{field}")
        assert port.np_tables[key].meta() == {
            f.name: getattr(ref.np_tables[key], f.name)
            for f in dataclasses.fields(ref.np_tables[key])
            if not hasattr(getattr(ref.np_tables[key], f.name), "shape")}
    # The corpus's partition (url 13 + 90 words, path 13 + 89): the
    # @short banks are halo-compatible with H = 14 and split k = 8 at
    # 2048 columns, k = 4 at 64; the @rest banks never split.
    for field in ("url", "path"):
        short = port.np_tables[f"nfa_{field}@short"]
        rest = port.np_tables[f"nfa_{field}@rest"]
        assert short.halo_ok and short.max_footprint == 14
        assert not rest.halo_ok
        assert nfa_scan.halo_split_k(short, 64) == 4
        assert nfa_scan.halo_split_k(rest, 64) == 1
        if name == "default_specs":
            assert nfa_scan.halo_split_k(short, 2048) == 8
            assert short.num_words == 13 and short.accept_member.shape[1] \
                == 31


def test_split_scan_plans_equal_the_reference(split500):
    _, (ref, _, port, _) = split500
    assert list(port.scan_plans) == list(ref.scan_plans)
    for key, want in ref.scan_plans.items():
        got = port.scan_plans[key]
        assert got.split == want.split == (f"{key}@short", f"{key}@rest")
        assert got.slot_perm == want.slot_perm
        assert sorted(got.slot_perm) == list(range(len(got.slot_perm)))
        for f in ("strategy", "short_strategy", "rest_strategy",
                  "dfa_strategy"):
            assert dataclasses.asdict(getattr(got, f)) == \
                dataclasses.asdict(getattr(want, f)), (key, f)
        assert got.short_strategy.halo_k == 8
        assert got.rest_strategy.halo_k == 1
        assert (got.extended, got.dfa_key, got.dfa_auto) == \
            (want.extended, want.dfa_key, want.dfa_auto)


def test_split_prefilter_equals_the_reference(split500):
    _, (ref, _, port, _) = split500
    rp, pp = ref.prefilter, port.prefilter
    assert list(pp.bank_masks) == list(rp.bank_masks)
    for key in ("nfa_url@short", "nfa_url@rest", "nfa_path@short",
                "nfa_path@rest"):
        np.testing.assert_array_equal(pp.bank_masks[key], rp.bank_masks[key])
        assert pp.bank_gated[key] == rp.bank_gated[key], key
        assert pp.slot_codes[key] == rp.slot_codes[key], key
        assert pp.bank_field[key] == rp.bank_field[key], key
    assert pp.bank_gated == rp.bank_gated
    assert port.stats == {k: ref.stats[k] for k in port.stats}


def test_split_tables_carry_across(split500):
    _, (ref, _, port, _) = split500
    carried = tables_from_reference(ref.np_tables, "cpu")
    for key in ("nfa_url@short", "nfa_url@rest", "nfa_path@short",
                "nfa_path@rest"):
        got, want = carried[key], port.np_tables[key]
        assert type(got) is type(want)
        assert got.meta() == want.meta(), key
        for field, w in want.numpy_arrays().items():
            np.testing.assert_array_equal(got.numpy_arrays()[field], w)


def test_no_split_without_the_knob():
    ref, _, port, _ = compile_both(60, 2026, SPECS, False)
    assert not any("@" in k for k in port.np_tables)
    assert all(e.split is None for e in port.scan_plans.values())
    assert list(port.np_tables) == list(ref.np_tables)


# -- halo_split_k -------------------------------------------------------------


@pytest.mark.parametrize("max_k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("L", [8, 16, 48, 64, 96, 256, 1000, 2048])
@pytest.mark.parametrize("H", [0, 1, 14, 70])
def test_halo_split_k_equals_the_reference(L, H, max_k):
    for halo_ok in (True, False):
        bank = types.SimpleNamespace(halo_ok=halo_ok, max_footprint=H)
        got = nfa_scan.halo_split_k(bank, L, max_k=max_k)
        assert got == ref_nfa.halo_split_k(bank, L, max_k=max_k), halo_ok
        if got > 1:
            assert halo_ok and got <= max_k
            assert L % got == 0 and H <= L // got and L // got + H < L
        assert nfa_scan.halo_split_k(bank, L) == ref_nfa.halo_split_k(bank,
                                                                      L)


# -- halo_split_scan ----------------------------------------------------------

# Sticky (floating) patterns, `$`- and `^`-anchored ones and a word
# boundary, each of footprint well under 16 columns.
SCAN_SOURCES = (r"abc", r"\.php$", r"^/adm", r"\bor\b", r"e{0,6}f", r"qq",
                r"<s[^>]{0,4}>", r"x$")
PLANTS = (b"abc", b".php", b"/adm", b" or ", b"eeef", b"qq", b"<sx>", b"x")


def both_banks(sources):
    pats, ref_pats = [], []
    for src in sources:
        pats.extend(compile_regex(src))
        ref_pats.extend(ref_compile_regex(src))
    return (nfa_scan.bank_to_tables(build_bank(pats)),
            ref_nfa.bank_to_tables(ref_build_bank(ref_pats)))


def boundary_batch(seed, L, Lc, B=48):
    """[B, L] rows of filler with planted patterns, lengths 0, 1, Lc - 1,
    Lc, Lc + 1 and L among them, some matches ending at a chunk's last
    byte or straddling a chunk boundary."""
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(b"abcdefopqrsx /.<>", np.uint8),
                      size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    fixed = [0, 1, Lc - 1, Lc, Lc + 1, L, 2 * Lc - 1, 2 * Lc, 2 * Lc + 1]
    lens[:len(fixed)] = fixed
    for b in range(B):
        plant = PLANTS[rng.integers(len(PLANTS))]
        if lens[b] < len(plant):
            continue
        if b % 3 == 0:  # the match ends on the row's last byte
            at = lens[b] - len(plant)
        elif b % 3 == 1:  # across a chunk boundary
            at = max(0, min(lens[b] - len(plant),
                            Lc * int(rng.integers(1, L // Lc)) - 2))
        else:
            at = int(rng.integers(0, lens[b] - len(plant) + 1))
        data[b, at:at + len(plant)] = np.frombuffer(plant, np.uint8)
    for b in range(len(fixed), len(fixed) + 3):  # `^/adm` at t == 0
        if lens[b] >= 4:
            data[b, :4] = np.frombuffer(b"/adm", np.uint8)
    for b in range(B):
        data[b, lens[b]:] = 0
    return data, lens


@pytest.fixture(scope="module")
def corpus_short():
    """The 500-rule corpus's nfa_url@short at 64-byte specs, both
    packages."""
    ref, _, port, _ = compile_both(500, None, SPECS, True)
    return port.np_tables["nfa_url@short"], ref.np_tables["nfa_url@short"]


@pytest.mark.parametrize("seed", SEEDS)
def test_halo_split_scan_equals_the_reference(seed, corpus_short):
    L = 64
    for tables, ref_tables in (both_banks(SCAN_SOURCES), corpus_short):
        assert tables.halo_ok
        H = int(tables.max_footprint)
        ks = [k for k in (2, 4, 8) if H <= L // k]
        assert 4 in ks and nfa_scan.halo_split_k(tables, L) in ks
        for k in ks:
            data, lens = boundary_batch(seed, L, L // k)
            d, n = torch.from_numpy(data), torch.from_numpy(lens)
            got = nfa_scan.halo_split_scan(tables, d, n, k).numpy()
            unsplit = nfa_scan.nfa_scan(tables, d, n).numpy()
            np.testing.assert_array_equal(got, unsplit, err_msg=str(k))
            np.testing.assert_array_equal(
                got, nfa_scan.halo_split_scan(tables, d, n, k,
                                              pair=True).numpy())
            want = np.asarray(ref_nfa.halo_split_scan(ref_tables, data, lens,
                                                      k))
            np.testing.assert_array_equal(got, want, err_msg=str(k))
            if k == 4:
                pallas = np.asarray(ref_nfa.halo_split_scan(
                    ref_tables, data, lens, k, lookup="pair",
                    backend="pallas"))
                np.testing.assert_array_equal(got, pallas)
            if tables.accept_member.shape[1] == len(SCAN_SOURCES):
                # every source matches somewhere, none everywhere
                assert got.any(axis=0).all() and not got.all(axis=0).any()


def test_halo_split_scan_refuses_a_bad_split():
    tables, _ = both_banks(SCAN_SOURCES)
    d = torch.zeros((2, 64), dtype=torch.uint8)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunks"):
        nfa_scan.halo_split_scan(tables, d, n, 3)
    with pytest.raises(ValueError, match="halo"):
        nfa_scan.halo_split_scan(tables, d, n, 32)


# -- verdicts under the three knobs -------------------------------------------


@pytest.fixture(scope="module")
def crs80():
    """The 80-rule corpus (seed 31337) at 64-byte specs: the split plans
    of both packages, the port's default plan and a traffic batch
    encoded at the specs (url/path L = 64)."""
    ref, ref_lists, port, lists = compile_both(80, 31337, SPECS, True)
    _, _, default, _ = compile_both(80, 31337, SPECS, False)
    reqs = ref_generate_traffic(96, attack_fraction=0.4, seed=SEEDS[0],
                                lists=ref_lists)
    arrays = ref_encode(reqs, SPECS).arrays
    assert arrays["url_bytes"].shape[1] == 64
    return dict(ref=ref, ref_lists=ref_lists, port=port, lists=lists,
                default=default, reqs=reqs, arrays=arrays, cache={})


def set_knob(mp, knob, pf=None):
    for name, value in KNOBS[knob].items():
        mp.setenv(name, value)
    mp.setattr(ref_verdict, "HALO_SPLIT", knob == "halo_split")
    if pf is not None:
        mp.setenv("PINGOO_PREFILTER", pf)


def ref_results(c, knob, pf):
    """The JAX package's matrix (and, under banks, lanes) under `knob`
    and PINGOO_PREFILTER=`pf`, computed once."""
    key = (knob, pf)
    if key not in c["cache"]:
        with pytest.MonkeyPatch.context() as mp:
            set_knob(mp, knob, pf)
            ref = c["ref"]
            tables = ref.device_tables()
            m = np.asarray(ref_verdict.make_verdict_fn(ref)(tables,
                                                            c["arrays"]))
            lanes = np.asarray(ref_verdict.make_lane_fn(ref)(
                tables, c["arrays"])) if pf == "banks" else None
        c["cache"][key] = (m, lanes)
    return c["cache"][key]


@pytest.fixture
def halo_calls(monkeypatch):
    """Record the verdict body's halo-split scans: ((rows, columns) of
    the chunk launch, k)."""
    calls = []
    real = verdict.halo_split_scan

    def counted(tables, data, lengths, k, pair=False):
        B, L = data.shape
        calls.append(((B * k, int(tables.max_footprint) + L // k), k))
        return real(tables, data, lengths, k, pair=pair)
    monkeypatch.setattr(verdict, "halo_split_scan", counted)
    return calls


@pytest.mark.parametrize("pf", ["off", "banks", "compact"])
@pytest.mark.parametrize("knob", list(KNOBS))
def test_matrix_and_lanes_equal_the_reference(crs80, monkeypatch, halo_calls,
                                              knob, pf):
    c = crs80
    want, want_lanes = ref_results(c, knob, pf)
    assert want.any()
    monkeypatch.setenv("PINGOO_PREFILTER", pf)
    default = verdict.make_verdict_fn(c["default"])(c["default"].np_tables,
                                                    c["arrays"]).numpy()
    default_lanes = verdict.make_lane_fn(c["default"])(
        c["default"].np_tables, c["arrays"]).numpy()
    assert not halo_calls
    set_knob(monkeypatch, knob)
    port = c["port"]
    got = verdict.make_verdict_fn(port)(port.np_tables, c["arrays"]).numpy()
    lanes = verdict.make_lane_fn(port)(port.np_tables, c["arrays"]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, default)
    np.testing.assert_array_equal(lanes, default_lanes)
    if want_lanes is not None:
        np.testing.assert_array_equal(lanes, want_lanes)
    # Both @short banks split at L = 64 (url: H = 10, k = 4; path: H = 8,
    # k = 8) in each of the two calls, unless Stage B skipped one; a row
    # is H + 64 / k columns wide.
    assert halo_calls
    assert {(s[1], k) for s, k in halo_calls} <= {(10 + 16, 4), (8 + 8, 8)}
    if pf == "off":
        assert sorted(halo_calls) == [((96 * 4, 26), 4), ((96 * 4, 26), 4),
                                      ((96 * 8, 16), 8), ((96 * 8, 16), 8)]


def test_unknown_strategy_pin_raises(crs80, monkeypatch):
    monkeypatch.setenv("PINGOO_SCAN_STRATEGY", "fastest")
    with pytest.raises(ValueError, match="fastest"):
        verdict.make_verdict_fn(crs80["port"])(crs80["port"].np_tables,
                                               crs80["arrays"])


def serve_all(service, reqs):
    async def run():
        await service.start()
        try:
            return await asyncio.gather(*map(service.evaluate, reqs))
        finally:
            await service.stop()
    return asyncio.run(run())


def verdict_rows(verdicts):
    return (np.stack([v.matched for v in verdicts]),
            [v.action for v in verdicts],
            [v.verified_block for v in verdicts])


# arm -> the environment of a VerdictService run.
SERVICE_ARMS = {
    "pipeline_on": {"PINGOO_PIPELINE": "on"},
    "pipeline_off": {"PINGOO_PIPELINE": "off"},
    "staging_compact": {"PINGOO_STAGING": "compact"},
    "megastep_force": {"PINGOO_MEGASTEP": "force", "PINGOO_MEGASTEP_K": "4"},
    "megastep_compact": {"PINGOO_MEGASTEP": "force", "PINGOO_MEGASTEP_K": "2",
                         "PINGOO_STAGING": "compact",
                         "PINGOO_PREFILTER": "compact"},
}


@pytest.fixture(scope="module")
def default_service_rows(crs80):
    return verdict_rows(serve_all(
        VerdictService(crs80["default"], crs80["lists"], max_batch=32,
                       device="cpu"), as_port(crs80["reqs"])))


# (knob, arm): every executor arm on the split plan; the two runtime
# knobs, whose route the matrix test above holds in every prefilter mode
# through the same programs, once each on the executor's default arm.
SERVICE_CASES = [("nfa_split", arm) for arm in SERVICE_ARMS] \
    + [(knob, "pipeline_on") for knob in ("strategy_halo", "halo_split")]


@pytest.mark.parametrize("knob,arm", SERVICE_CASES)
def test_service_equals_the_reference(crs80, default_service_rows,
                                      monkeypatch, halo_calls, knob, arm):
    """The Python plane under each knob and executor arm: the per-batch
    body, the packed program (compact staging) and the megastep's
    sync-free body all reach the halo split."""
    c = crs80
    want, _ = ref_results(c, knob, "banks")
    want_act, want_vb = ref_verdict.action_lanes(c["ref"], want)
    set_knob(monkeypatch, knob)
    for name, value in SERVICE_ARMS[arm].items():
        monkeypatch.setenv(name, value)
    service = VerdictService(c["port"], c["lists"], max_batch=32,
                             device="cpu")
    m, act, vb = verdict_rows(serve_all(service, as_port(c["reqs"])))
    np.testing.assert_array_equal(m, want)
    assert act == want_act.tolist() and vb == want_vb.tolist()
    np.testing.assert_array_equal(m, default_service_rows[0])
    assert (act, vb) == tuple(default_service_rows[1:])
    assert halo_calls
    if "MEGASTEP" in str(SERVICE_ARMS[arm]):
        assert service.pipeline_snapshot()["megastep"]["windows"] > 0
    if "PINGOO_STAGING" in SERVICE_ARMS[arm]:
        assert service.stage_caps is not None


def drive(plan, lists, stream, path, max_batch=16, capacity=256):
    """`stream` through the port's sidecar on a fresh ring, the producer
    in this process; returns (DriveResult, sidecar)."""
    ring = nr.Ring(str(path), capacity=capacity, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, lists, max_batch=max_batch,
                                 device="cpu")
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


RING_ARMS = {"off": {"PINGOO_PIPELINE": "off"},
             "on": {"PINGOO_PIPELINE": "on"},
             "force": {"PINGOO_PIPELINE": "on", "PINGOO_MEGASTEP": "force",
                       "PINGOO_MEGASTEP_K": "4"}}


@pytest.mark.parametrize("arm", list(RING_ARMS))
def test_sidecar_equals_the_reference(crs80, monkeypatch, halo_calls,
                                      tmp_path, arm):
    """The ring plane on the split plan under each executor arm (the
    lane program is the one the matrix test holds under every knob)."""
    c = crs80
    want, _ = ref_results(c, "nfa_split", "banks")
    want_act, want_vb = ref_verdict.action_lanes(c["ref"], want)
    want_bytes = bytes(int(a) | (int(v) << 2)
                       for a, v in zip(want_act, want_vb))
    stream = nr.pack_requests(as_port(c["reqs"]))
    for name, value in RING_ARMS[arm].items():
        monkeypatch.setenv(name, value)
    res, sidecar = drive(c["port"], c["lists"], stream, tmp_path / "ring")
    assert res.actions == want_bytes
    assert len(set(res.actions)) > 1
    assert halo_calls
    if arm == "force":
        assert sidecar.stats()["megastep"]["windows"] > 0
    base, _ = drive(c["default"], c["lists"], stream, tmp_path / "base")
    assert res.actions == base.actions


# -- a bounded rule set: the halo route with no knob --------------------------

BOUNDED_SOURCES = (
    'http_request.path.matches("a[0-9]{0,3}b")',
    'http_request.path.matches("\\\\.(php|asp)$")',
    'http_request.url.matches("(?i)sel[e3]ct\\\\s{0,2}from")',
    'http_request.path.matches("^/wp-(admin|login)")',
    'http_request.url.matches("\\\\bunion\\\\b")',
    'http_request.url.matches("(?i)<scr[i1]pt")',
    'http_request.url.matches("[\'\\"];?\\\\s?--")',
)
BOUNDED_PLANTS = ("a12b", "x.php", "SELECT  from", "/wp-login",
                  "1 union 2", "<Scr1pt", "';--")


def bounded_plans(specs):
    ref_rules = [RefRuleConfig(name=f"b{i}",
                               expression=ref_compile_expression(s),
                               actions=(RefAction.BLOCK,))
                 for i, s in enumerate(BOUNDED_SOURCES)]
    rules = [RuleConfig(name=f"b{i}", expression=compile_expression(s),
                        actions=(Action.BLOCK,))
             for i, s in enumerate(BOUNDED_SOURCES)]
    return (ref_compile(ref_rules, {}, field_specs=specs), rules,
            compile_ruleset(rules, {}, field_specs=specs, device="cpu"))


@pytest.fixture(scope="module")
def bounded():
    return bounded_plans(SPECS)


def bounded_traffic(seed, n=64):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        path = "/" + "".join(rng.choice(list("abcdefgh/0123"),
                                        size=int(rng.integers(0, 60))))
        if i % 2:
            plant = BOUNDED_PLANTS[int(rng.integers(len(BOUNDED_PLANTS)))]
            at = int(rng.integers(0, len(path) + 1))
            path = path[:at] + plant + path[at:]
        url = path + ("?q=" + "x" * int(rng.integers(0, 20)) if i % 3 else "")
        reqs.append(RequestTuple(method="GET", url=url[:64], path=path[:64],
                                 ip="10.0.0.1"))
    return reqs


@pytest.mark.parametrize("dfa", ["off", "auto"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bounded_rules_halo_split_with_no_knob(bounded, monkeypatch,
                                               halo_calls, seed, dfa):
    """Every pattern is bounded, so the whole url and path banks are
    halo-compatible (halo_k = 8): at L = 64 both take the halo route in
    the port as in the JAX package (k = 4), under PINGOO_DFA=off; under
    auto their exact DFAs replace the scan. Bits equal the reference's
    and the interpreter's."""
    ref, rules, port = bounded
    for key in ("nfa_url", "nfa_path"):
        t = port.np_tables[key]
        assert t.halo_ok and port.scan_plans[key].strategy.halo_k == 8
        assert port.scan_plans[key].split is None
        assert nfa_scan.halo_split_k(t, 64) == 4
    monkeypatch.setenv("PINGOO_DFA", dfa)
    reqs = bounded_traffic(seed)
    batch_arrays = ref_encode(reqs, SPECS).arrays
    assert batch_arrays["path_bytes"].shape[1] == 64
    want = np.asarray(ref_verdict.make_verdict_fn(ref)(ref.device_tables(),
                                                       batch_arrays))
    got = verdict.make_verdict_fn(port)(port.np_tables, batch_arrays).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    if dfa == "off":
        assert sorted(halo_calls) == [((64 * 4, 16 + 11), 4),
                                      ((64 * 4, 16 + 14), 4)]
    else:
        assert not halo_calls
    contexts = batch_to_contexts(RequestBatch(size=len(reqs),
                                              arrays=batch_arrays), {})
    for r, rule in enumerate(rules):
        for i, ctx in enumerate(contexts):
            assert bool(got[i, r]) == execute_as_bool(rule.expression,
                                                      ctx), (rule.name, i)


@pytest.mark.parametrize("L", [16, 32, 64, 128])
def test_halo_route_where_the_reference_rule_takes_it(monkeypatch,
                                                      halo_calls, L):
    """At each staged width the port takes the halo route for a bank
    exactly where the JAX package's rule does: k = halo_split_k(bank, L,
    max_k=halo_k) > 1 and L // k + H below the base steps ((L + 1) // 2
    for the pair strategy the plan records); the bits equal the
    reference's either way."""
    specs = dict(SPECS, url=L, path=L)
    ref, _, port = bounded_plans(specs)
    monkeypatch.setenv("PINGOO_DFA", "off")
    reqs = [RequestTuple(url=("/x?q=" + "a1b" * 50)[:L],
                         path=("/wp-login" + "x" * 200)[:L], ip="10.0.0.1"),
            *bounded_traffic(SEEDS[1], n=16)]
    arrays = ref_encode(reqs, specs).arrays
    assert arrays["url_bytes"].shape[1] == L
    want_routes = []
    for key in ("nfa_path", "nfa_url"):
        t, strat = ref.np_tables[key], ref.scan_plans[key].strategy
        k = ref_nfa.halo_split_k(t, L, max_k=strat.halo_k)
        base = (L + 1) // 2 if strat.pair else L
        if k > 1 and L // k + int(t.max_footprint) < base:
            want_routes.append(((len(reqs) * k,
                                 int(t.max_footprint) + L // k), k))
    got = verdict.make_verdict_fn(port)(port.np_tables, arrays).numpy()
    want = np.asarray(ref_verdict.make_verdict_fn(ref)(ref.device_tables(),
                                                       arrays))
    np.testing.assert_array_equal(got, want)
    assert sorted(halo_calls) == sorted(want_routes)
    assert bool(want_routes) == (L >= 64)
