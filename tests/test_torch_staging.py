"""Compact staging (PINGOO_STAGING=compact) and the prefilter's compact
mode (PINGOO_PREFILTER=compact) in the port, against the JAX package.

  * The caps: `staging_required`, `staging_caps`, `resolve_stage_caps`
    and `stage_overflow_thresholds` equal the JAX package's on the
    500-rule corpus (its pinned table), on seeded random rulesets with
    host rules, and under PINGOO_STAGING_DEPTH 0, 1, 64 and 256.
  * The layout: `build_packed_layout`'s geometry is the JAX package's
    (4,430 and 846 bytes a row on the corpus), one instance per widths.
  * The encoders: packed bytes, overflow flags, views and staged bytes
    of `encode_requests` and `encode_slots` equal the JAX package's
    encoder's, byte for byte, clamped and not; `set_stage_caps` widens
    between batches only.
  * The decode: `unpack_staged` equals the JAX package's on the same
    buffer, and the full-staging arrays cut to the caps.
  * The Python plane: VerdictService under compact gives full staging's
    and the JAX package's compact verdicts, unclamped and clamped (rows
    past 64 bytes re-served), with the last dependent byte exactly at
    the cap, and under PINGOO_MEGASTEP=force.
  * The ring: RingSidecar on a long-tail stream gives one checksum
    under full, compact and compact with the megastep, and re-serves
    as many depth-overflow rows as the JAX package's sidecar.
  * The prefilter's compact mode at PINGOO_PREFILTER_LEVELS 0, 1, 2 and
    4: leaves and lanes equal `banks` and the JAX package's compact.

CPU only, narrow field specs where the plain scans run (they walk every
column), small batches; the tolerance is zero.
"""

import asyncio
import dataclasses
import random
import threading

import jax
import numpy as np
import pytest
import torch

from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.compiler import plan as ref_plan_mod
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.engine import batch as ref_batch
from pingoo_tpu.engine import verdict as ref_verdict
from pingoo_tpu.engine.batch import RequestTuple as RefRequestTuple
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.compiler import plan as plan_mod
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine import batch, verdict
from pingoo_tpu_torch.engine.batch import (STRING_FIELDS, RequestTuple,
                                           StagingEncoder, build_packed_layout,
                                           resolve_stage_caps,
                                           stage_overflow_thresholds)
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.expr import Ip, compile_expression
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic
from test_parity import (ACTIONS, HOST_FALLBACK_SOURCES, LISTS, RULE_SOURCES,
                         random_requests)
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
# Narrow field specs for the plans that scan on the CPU: the plain NFA
# and DFA walk every column of a batch.
SMALL_SPECS = {"host": 64, "url": 256, "path": 256, "method": 16,
               "user_agent": 128, "country": 2}
CLEARED_ENV = ("PINGOO_CHAOS", "PINGOO_DFA", "PINGOO_PREFILTER",
               "PINGOO_PREFILTER_LEVELS", "PINGOO_MESH",
               "PINGOO_PARITY_SAMPLE", "PINGOO_PIPELINE",
               "PINGOO_PIPELINE_DEPTH", "PINGOO_SCHED_PIPELINE",
               "PINGOO_SCHED_FAILOPEN", "PINGOO_STAGING",
               "PINGOO_STAGING_DEPTH", "PINGOO_PROVENANCE",
               "PINGOO_BODY_INSPECT", "PINGOO_MEGASTEP", "PINGOO_MEGASTEP_K")
# The JAX package's corpus caps (500 rules, lists of 4,096 IPs and 512
# ASNs): required depth, caps, and caps under PINGOO_STAGING_DEPTH=256.
CORPUS_REQUIRED = {"host": 0, "url": 2048, "path": 2048, "method": 0,
                   "user_agent": 256, "country": 3}
CORPUS_CAPS = {"host": 16, "url": 2048, "path": 2048, "method": 16,
               "user_agent": 256, "country": 2}
CORPUS_CAPS_256 = {"host": 16, "url": 256, "path": 256, "method": 16,
                   "user_agent": 256, "country": 2}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def set_env(monkeypatch, **env):
    for name, value in env.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, str(value))


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


def as_ref(reqs):
    return [RefRequestTuple(**{f.name: getattr(r, f.name)
                               for f in dataclasses.fields(RefRequestTuple)})
            for r in reqs]


def port_lists(lists):
    return {k: [Ip(str(v)) if hasattr(v, "contains") else v for v in vals]
            for k, vals in lists.items()}


def both_plans(sources, specs=None, actions=ACTIONS):
    """The same rules compiled by both packages (on the CPU)."""
    ref_rules = [RefRuleConfig(name=f"r{i}",
                               expression=ref_compile_expression(s),
                               actions=actions)
                 for i, s in enumerate(sources)]
    rules = [RuleConfig(name=f"r{i}", expression=compile_expression(s),
                        actions=tuple(Action(a.value) for a in actions))
             for i, s in enumerate(sources)]
    return (ref_compile(ref_rules, LISTS, field_specs=specs),
            compile_ruleset(rules, port_lists(LISTS), field_specs=specs,
                            device="cpu"))


@pytest.fixture(scope="module")
def corpus():
    ref_rules, ref_lists = ref_generate_ruleset(500, with_lists=True,
                                                list_sizes=(4096, 512))
    rules, lists = generate_ruleset(500, with_lists=True,
                                    list_sizes=(4096, 512))
    return (ref_compile(ref_rules, ref_lists),
            compile_ruleset(rules, lists, device="cpu"))


@pytest.fixture(scope="module")
def crs60():
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    return (ref_compile(ref_rules, ref_lists, field_specs=SMALL_SPECS),
            ref_lists,
            compile_ruleset(rules, lists, field_specs=SMALL_SPECS,
                            device="cpu"), lists)


def caps_of_both(ref, port, monkeypatch, depth):
    """(port, reference) resolved caps and thresholds under compact
    staging and PINGOO_STAGING_DEPTH=`depth` (None: unset)."""
    set_env(monkeypatch, PINGOO_STAGING="compact",
            PINGOO_STAGING_DEPTH=depth)
    got, want = resolve_stage_caps(port), ref_batch.resolve_stage_caps(ref)
    return ((got, stage_overflow_thresholds(port, got)),
            (want, ref_batch.stage_overflow_thresholds(ref, want)))


# -- the caps -------------------------------------------------------------------


def test_rungs_equal_the_reference():
    assert plan_mod.STAGING_RUNGS == ref_plan_mod.STAGING_RUNGS
    for spec in (2, 16, 256, 2048):
        for depth in range(0, 4200, 7):
            assert plan_mod.quantize_stage_cap(depth, spec) \
                == ref_plan_mod.quantize_stage_cap(depth, spec)


@pytest.mark.parametrize("depth", [None, "0", "1", "64", "256", "junk"])
def test_corpus_caps_equal_the_reference(corpus, monkeypatch, depth):
    ref, port = corpus
    assert port.staging_required == ref.staging_required == CORPUS_REQUIRED
    assert port.staging_caps == ref.staging_caps == CORPUS_CAPS
    got, want = caps_of_both(ref, port, monkeypatch, depth)
    assert got == want
    if depth == "256":
        assert got[0] == CORPUS_CAPS_256
        assert got[1]["url"] == got[1]["path"] == 256
    elif depth in (None, "0", "junk"):
        assert got[0] == CORPUS_CAPS
        assert got[1] == port.field_specs
    monkeypatch.setenv("PINGOO_STAGING", "full")
    assert resolve_stage_caps(port) is ref_batch.resolve_stage_caps(ref) \
        is None


@pytest.mark.parametrize("seed", SEEDS)
def test_random_ruleset_caps_equal_the_reference(monkeypatch, seed):
    """Seeded CRS rulesets and seeded draws of the parity rules with the
    host-interpreted ones (whose fields are pinned to the spec)."""
    ref_rules, _ = ref_generate_ruleset(40, seed=seed, with_lists=False)
    rules, _ = generate_ruleset(40, seed=seed, with_lists=False)
    ref_crs = ref_compile(ref_rules, {})
    crs = compile_ruleset(rules, {}, device="cpu")
    rng = random.Random(seed)
    sources = rng.sample(RULE_SOURCES, 8) + rng.sample(
        HOST_FALLBACK_SOURCES, rng.randrange(1, 3))
    pairs = [(ref_crs, crs), both_plans(sources),
             both_plans(sources, SMALL_SPECS)]
    for ref, port in pairs:
        assert port.staging_required == ref.staging_required
        assert port.staging_caps == ref.staging_caps
        for depth in ("0", "1", "64", "256"):
            got, want = caps_of_both(ref, port, monkeypatch, depth)
            assert got == want, depth
    # A host rule reading the path pins it to the spec.
    _, host = pairs[1]
    assert host.staging_required["path"] == host.field_specs["path"]


# -- the layout -------------------------------------------------------------------


@pytest.mark.parametrize("caps,width", [
    (CORPUS_CAPS, 4430), (CORPUS_CAPS_256, 846),
    ({"host": 32, "url": 64, "path": 32, "method": 16, "user_agent": 32,
      "country": 2}, None),
    ({f: 1 for f in STRING_FIELDS}, None)])
def test_layout_equals_the_reference(caps, width):
    got = build_packed_layout(dict(caps))
    want = ref_batch.build_packed_layout(dict(caps))
    assert tuple(got) == tuple(want)
    assert got._fields == want._fields
    if width is not None:
        assert got.width == width
    assert build_packed_layout(dict(caps)) is got
    assert build_packed_layout(dict(reversed(list(caps.items())))) is got


# -- the encoders ------------------------------------------------------------------


def tail_requests(reqs, seed, every, pad):
    """bench.py's long-tail shape: about one request in `every` gets a
    url and path of `pad` more bytes."""
    rng = random.Random(seed)
    out = list(reqs)
    for i in range(0, len(out), every):
        j = min(len(out) - 1, i + rng.randrange(every))
        r = out[j]
        fill = "".join(rng.choice("abcdefgh") for _ in range(pad))
        out[j] = dataclasses.replace(r, url=(r.path + "?q=" + fill)[:2040],
                                     path=(r.path + "/" + fill)[:2040])
    return out


def assert_packed_equal(got, want):
    assert got.size == want.size
    assert tuple(got.layout) == tuple(want.layout)
    np.testing.assert_array_equal(got.packed, want.packed)
    assert got.staged_bytes == want.staged_bytes == got.packed.nbytes
    assert set(got.arrays) == set(want.arrays)
    for key, b in want.arrays.items():
        a = got.arrays[key]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), key
        np.testing.assert_array_equal(a, b, err_msg=key)
        if key.endswith("_bytes"):
            assert np.shares_memory(a, got.packed), key
    np.testing.assert_array_equal(got.overflow, want.overflow)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth", [None, "64"])
def test_encode_requests_packed_equals_reference(crs60, monkeypatch, seed,
                                                 depth):
    ref, ref_lists, port, _ = crs60
    (caps, th), (ref_caps, ref_th) = caps_of_both(ref, port, monkeypatch,
                                                  depth)
    enc = StagingEncoder(64, port.field_specs, nbuf=1, stage_caps=caps,
                         overflow_thresholds=th)
    ref_enc = ref_batch.StagingEncoder(64, ref.field_specs, nbuf=1,
                                       stage_caps=ref_caps,
                                       overflow_thresholds=ref_th)
    rng = random.Random(seed)
    flagged = 0
    for n, pad in ((1, 1), (13, 16), (37, 64), (64, 64)):
        ref_reqs = random_requests(rng, n) if n % 2 else \
            ref_generate_traffic(n, attack_fraction=0.3, seed=seed + n,
                                 lists=ref_lists)
        ref_reqs = tail_requests(ref_reqs, seed + n, 8, 300)
        ref_reqs[-1] = dataclasses.replace(
            ref_reqs[-1], ip="not-an-ip", asn=-(2**40), remote_port=2**70)
        into = enc.checkout(block=False)
        got = enc.encode_requests(as_port(ref_reqs), pad_to=pad, into=into)
        assert_packed_equal(got, ref_enc.encode_requests(ref_reqs,
                                                         pad_to=pad))
        flagged += int(got.overflow.sum())
        enc.release(into)
    # Rows past the spec are flagged either way; the clamp flags more.
    assert flagged > 0


def slot_caps():
    return dict(nr.FIELD_CAPS, country=2)


def enqueue(ring, i, url=None):
    body = url if url is not None else f"/p{i}?q={'x' * (i % 90)}".encode()
    return ring.enqueue(
        method=b"GET" if i % 3 else b"POST", host=f"h{i % 7}.test".encode(),
        path=body, url=body, user_agent=f"ua-{i % 5}".encode(),
        ip=b"\x00" * 10 + b"\xff\xff" + bytes([10, i % 256, (i * 7) % 256, 1]),
        port=1000 + i, asn=64500 + (i % 9) - 70000 * (i % 2),
        country=b"FR" if i % 2 else b"DE")


@pytest.mark.parametrize("depth", [None, "64"])
def test_encode_slots_packed_equals_reference(corpus, tmp_path, monkeypatch,
                                              depth):
    """Slots off a real ring (wrap-around, a row past the slot cap with
    its spill slot, a row exactly at the cap) under the corpus's caps."""
    ref, port = corpus
    (caps, th), (ref_caps, ref_th) = caps_of_both(ref, port, monkeypatch,
                                                  depth)
    enc = StagingEncoder(32, field_specs=slot_caps(), nbuf=1,
                         stage_caps=caps, overflow_thresholds=th)
    ref_enc = ref_batch.StagingEncoder(32, field_specs=slot_caps(), nbuf=1,
                                       stage_caps=ref_caps,
                                       overflow_thresholds=ref_th)
    ring = nr.Ring(str(tmp_path / "ring"), capacity=32, create=True)
    out = np.zeros(32, dtype=nr.REQUEST_SLOT_DTYPE)
    flagged = []
    try:
        i = 0
        for n in (20, 20, 13, 20, 3):
            for k in range(n):
                url = None
                if n == 3:
                    url = (b"/" + b"A" * 3000, None,
                           b"/" + b"B" * 2047)[k]
                assert enqueue(ring, i, url) is not None
                i += 1
            assert ring.dequeue_batch_into(out) == n
            slots = out[:n]
            pad = batch.pow2_batch_size(n, 32)
            into = enc.checkout(block=False)
            got = enc.encode_slots(slots, pad_to=pad, into=into)
            assert_packed_equal(got, ref_enc.encode_slots(slots, pad_to=pad))
            flagged.append(int(got.overflow.sum()))
            enc.release(into)
            for idx in slots["spill_idx"]:
                if idx != nr.SPILL_NONE:
                    ring.spill_release(int(idx))
    finally:
        ring.close()
    # Unclamped, no slot row passes its threshold; clamped at 64, the
    # rows whose url passes 64 bytes are flagged.
    assert (sum(flagged) == 0) == (depth is None)


def test_set_stage_caps_widens_between_batches_only():
    caps16 = {f: 16 if f != "country" else 2 for f in STRING_FIELDS}
    caps64 = {f: 64 if f != "country" else 2 for f in STRING_FIELDS}
    enc = StagingEncoder(8, nbuf=2, stage_caps=caps16)
    r = [RequestTuple(url="/" + "z" * 60, path="/p", ip="10.0.0.1")]
    held = enc.checkout(block=False)
    narrow = enc.encode_requests(r, pad_to=1, into=held)
    assert narrow.layout.width == build_packed_layout(caps16).width
    assert narrow.arrays["url_bytes"].shape[1] == 16
    assert int(narrow.arrays["url_len"][0]) == 61
    with pytest.raises(RuntimeError, match="between batches"):
        enc.set_stage_caps(caps64)
    enc.release(held)
    # The packed buffers are sized at the installed layout's width.
    assert enc._bufs[0]["packed"].size == 8 * narrow.layout.width
    enc.set_stage_caps(caps64)
    into = enc.checkout(block=False)
    wide = enc.encode_requests(r, pad_to=1, into=into)
    assert wide.layout == build_packed_layout(enc.stage_caps)
    assert all(b["packed"].size == 8 * wide.layout.width for b in enc._bufs)
    assert wide.arrays["url_bytes"].shape[1] == 64
    assert bytes(wide.arrays["url_bytes"][0][:61]) == b"/" + b"z" * 60
    enc.release(into)
    with pytest.raises(ValueError, match="packed"):
        StagingEncoder(8).set_stage_caps(caps16)


# -- the decode -------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_unpack_staged_equals_reference_and_full(crs60, monkeypatch, seed):
    ref, ref_lists, port, _ = crs60
    (caps, th), _ = caps_of_both(ref, port, monkeypatch, "64")
    enc = StagingEncoder(64, port.field_specs, nbuf=1, stage_caps=caps,
                         overflow_thresholds=th)
    full = StagingEncoder(64, port.field_specs, nbuf=1)
    reqs = random_requests(random.Random(seed), 23)
    reqs[0] = dataclasses.replace(reqs[0], asn=-64500, remote_port=2**63 - 1,
                                  ip="2001:db8::ff")
    reqs = as_port(tail_requests(reqs, seed, 5, 100))
    got = enc.encode_requests(reqs, pad_to=32, into=0)
    dec = verdict.unpack_staged(torch.from_numpy(got.packed), got.layout)
    want = ref_verdict.unpack_staged(np.asarray(got.packed),
                                     ref_batch.build_packed_layout(caps))
    f = full.encode_requests(reqs, pad_to=32, into=0).arrays
    assert set(dec) == set(want) == set(f)
    for key, t in dec.items():
        a = t.numpy()
        np.testing.assert_array_equal(a, np.asarray(want[key]).astype(
            a.dtype), err_msg=key)
        if key.endswith("_bytes"):
            assert t.is_contiguous()
            w = min(a.shape[1], f[key].shape[1])
            np.testing.assert_array_equal(a[:, :w], f[key][:, :w],
                                          err_msg=key)
            # Past the full bucket (the batch's longest row) the
            # packed row holds no byte.
            assert not a[:, w:].any(), key
        else:
            np.testing.assert_array_equal(a, f[key].astype(a.dtype),
                                          err_msg=key)
    assert dec["ip"].dtype == dec["asn"].dtype == torch.int64
    assert int(dec["asn"][0]) == -64500
    assert int(dec["remote_port"][0]) == 2**63 - 1


# -- the Python plane -----------------------------------------------------------------


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


def ref_compact_matrix(ref, lists, reqs, monkeypatch, depth, B=32):
    """The JAX package's compact path on `reqs` in batches of B: its
    packed encoder, packed Stage A and verdict programs and host rules,
    then its interpreter over the flagged rows' untruncated tuples, as
    its VerdictService does; also how many rows were flagged."""
    set_env(monkeypatch, PINGOO_STAGING="compact",
            PINGOO_STAGING_DEPTH=depth)
    caps = ref_batch.resolve_stage_caps(ref)
    enc = ref_batch.StagingEncoder(
        B, ref.field_specs, stage_caps=caps,
        overflow_thresholds=ref_batch.stage_overflow_thresholds(ref, caps))
    tables = jax.device_put(ref.device_tables())
    ppf = ref_verdict.make_packed_prefilter_fn(ref)
    vfn = ref_verdict.make_packed_verdict_fn(ref)
    out, flagged = [], 0
    for lo in range(0, len(reqs), B):
        chunk = reqs[lo:lo + B]
        b = enc.encode_requests(chunk, pad_to=B)
        hits = ppf.fn(tables, b.packed, b.layout)[0] \
            if ppf is not None else None
        m = ref_verdict.finish_batch(
            ref, vfn(tables, b.packed, b.layout, hits), b, lists)[:len(chunk)]
        for i in np.nonzero(b.overflow[:len(chunk)])[0]:
            m[i] = ref_verdict.interpret_rules_row(
                ref, ref_batch.tuple_to_context(chunk[i], lists))
            flagged += 1
        out.append(m)
    return np.concatenate(out), flagged


def python_plane_traffic(ref_lists, seed, n=96):
    reqs = ref_generate_traffic(n, attack_fraction=0.3, seed=seed,
                                lists=ref_lists)
    reqs = tail_requests(reqs, seed, 12, 120)
    return reqs + random_requests(random.Random(seed), 32)


@pytest.mark.parametrize("depth", [None, "64"])
def test_service_compact_equals_full_and_reference(crs60, monkeypatch,
                                                   depth):
    ref, ref_lists, port, lists = crs60
    ref_reqs = python_plane_traffic(ref_lists, SEEDS[1])
    want, flagged = ref_compact_matrix(ref, ref_lists, ref_reqs, monkeypatch,
                                       depth)
    full_over = ref_batch.encode_requests(ref_reqs,
                                          ref.field_specs).overflow
    want_full = ref_verdict.evaluate_batch(
        ref, ref_verdict.make_verdict_fn(ref), ref.device_tables(),
        ref_batch.encode_requests(ref_reqs, ref.field_specs), ref_lists)
    for i in np.nonzero(full_over)[0]:
        want_full[i] = ref_verdict.interpret_rules_row(
            ref, ref_batch.tuple_to_context(ref_reqs[i], ref_lists))
    np.testing.assert_array_equal(want, want_full)
    want_act, want_vb = ref_verdict.action_lanes(ref, want)
    reqs = as_port(ref_reqs)
    served = {}
    for mode in ("full", "compact"):
        set_env(monkeypatch, PINGOO_STAGING=mode, PINGOO_STAGING_DEPTH=depth)
        service = VerdictService(port, lists, max_batch=32, device="cpu")
        assert (service.stage_caps is None) == (mode == "full")
        served[mode] = verdict_rows(serve_all(service, reqs))
        staged = service.stats.staged_bytes
        assert staged > 0
        if mode == "compact":  # whole packed rows
            assert staged % build_packed_layout(service.stage_caps).width \
                == 0
    for mode, (m, act, vb) in served.items():
        np.testing.assert_array_equal(m, want, err_msg=mode)
        assert act == want_act.tolist() and vb == want_vb.tolist(), mode
    assert any(a == 1 for a in served["compact"][1])
    # Rows past the spec are re-served either way; clamped at 64, the
    # tail rows too.
    assert flagged >= int(full_over.sum()) > 0
    assert (flagged > int(full_over.sum())) == (depth is not None)


def test_service_last_dependent_byte_at_the_cap(monkeypatch):
    """A 16-byte prefix and a 15-byte equality (which needs 16 bytes) on
    the path derive a 16-byte cap; rows decided by byte 15, and rows one
    byte longer, are served as under full staging."""
    pat = "/abcdefghijklmn/"
    eq = pat[:-1]
    ref, port = both_plans([f'http_request.path.starts_with("{pat}")',
                            f'http_request.path == "{eq}"'])
    assert port.staging_caps["path"] == ref.staging_caps["path"] == 16
    assert port.staging_required["path"] == 16
    reqs = [RequestTuple(path=pat + "tail/x", url=pat, ip="10.0.0.1"),
            RequestTuple(path=pat[:-1] + "X" + "tail", url="/",
                         ip="10.0.0.2"),
            RequestTuple(path=pat, url="/", ip="10.0.0.3"),
            RequestTuple(path=eq, url="/", ip="10.0.0.4"),
            RequestTuple(path=eq + "x", url="/", ip="10.0.0.5"),
            RequestTuple(path=eq[:-1], url="/", ip="10.0.0.6")]
    rows = {}
    for mode in ("full", "compact"):
        monkeypatch.setenv("PINGOO_STAGING", mode)
        service = VerdictService(port, port_lists(LISTS), max_batch=8,
                                 device="cpu")
        rows[mode] = np.stack([v.matched for v in
                               service.evaluate_batch(reqs)])
    want, flagged = ref_compact_matrix(ref, LISTS, as_ref(reqs), monkeypatch,
                                       None, B=8)
    assert flagged == 0
    np.testing.assert_array_equal(rows["compact"], rows["full"])
    np.testing.assert_array_equal(rows["compact"], want)
    assert rows["compact"][:, 0].tolist() == [True, False, True, False,
                                              False, False]
    assert rows["compact"][:, 1].tolist() == [False, False, False, True,
                                              False, False]


@pytest.mark.parametrize("depth", [None, "64"])
def test_service_compact_megastep(crs60, monkeypatch, depth):
    """PINGOO_MEGASTEP=force (K=4) under compact staging, with either
    prefilter mode: the capped views go through the window; verdicts
    equal the per-batch compact path's, overflow rows included."""
    ref, ref_lists, port, lists = crs60
    reqs = as_port(python_plane_traffic(ref_lists, SEEDS[2], n=64))
    set_env(monkeypatch, PINGOO_STAGING="compact", PINGOO_STAGING_DEPTH=depth)
    per_batch = verdict_rows(serve_all(
        VerdictService(port, lists, max_batch=32, device="cpu"), reqs))
    set_env(monkeypatch, PINGOO_MEGASTEP="force", PINGOO_MEGASTEP_K="4")
    service = VerdictService(port, lists, max_batch=32, device="cpu")
    mega = verdict_rows(serve_all(service, reqs))
    np.testing.assert_array_equal(mega[0], per_batch[0])
    assert mega[1:] == per_batch[1:]
    snap = service.pipeline_snapshot()["megastep"]
    assert snap["windows"] > 0 and snap["slices"] > snap["windows"]
    assert service.mega_echo_mismatch == 0
    assert service.stats.staged_bytes > 0
    # The prefilter's compact mode in the window is `gathered_rows`, as
    # `banks` is: the same bits.
    monkeypatch.setenv("PINGOO_PREFILTER", "compact")
    pf = verdict_rows(serve_all(
        VerdictService(port, lists, max_batch=32, device="cpu"), reqs))
    np.testing.assert_array_equal(pf[0], per_batch[0])
    assert pf[1:] == per_batch[1:]


# -- the ring -------------------------------------------------------------------------


def ring_drive(mod, plan, lists, stream, path, env, max_batch=16,
               capacity=512):
    """`stream` through a sidecar of `mod` on a fresh ring, the producer
    in this process; returns (DriveResult, sidecar)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in CLEARED_ENV:
            mp.delenv(name, raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        ring = mod.Ring(str(path), capacity=capacity, create=True)
        try:
            kw = {"device": "cpu"} if mod is nr else {}
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


def test_one_batch_chain_stages_in_full(crs60, monkeypatch, tmp_path):
    """PINGOO_STAGING=compact under PINGOO_PIPELINE=off: the one-batch
    chain stages in full on both planes, so neither resolves caps nor
    builds the packed program (the service has no staging encoder, whose
    batches alone are packed), and the service stages its batches in
    full."""
    ref, ref_lists, port, lists = crs60
    set_env(monkeypatch, PINGOO_STAGING="compact", PINGOO_STAGING_DEPTH=64,
            PINGOO_PIPELINE="off")
    service = VerdictService(port, lists, max_batch=32, device="cpu")
    assert service.stage_caps is None
    assert service._staging is None
    reqs = as_port(python_plane_traffic(ref_lists, SEEDS[4], n=16))
    serve_all(service, reqs)
    assert service.stats.staged_bytes > 0
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, port, lists, max_batch=16,
                                 device="cpu")
        assert sidecar.stage_caps is None
        assert sidecar._packed_lane_fn is None
        assert sidecar.stats()["staging"]["caps"] is None
    finally:
        ring.close()


@pytest.fixture(scope="module")
def tail_stream():
    """A small long-tail stream on the 60-rule plan at the slot caps."""
    ref_rules, ref_lists = ref_generate_ruleset(60, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(60, with_lists=True, list_sizes=(64, 16))
    reqs = tail_requests(generate_traffic(160, attack_fraction=0.3,
                                          seed=SEEDS[3], lists=lists),
                         SEEDS[3], 16, 200)
    return (ref_compile(ref_rules, ref_lists), ref_lists,
            compile_ruleset(rules, lists, device="cpu"), lists,
            nr.pack_requests(reqs))


def test_sidecar_compact_checksum_and_overflow_rows(tail_stream, tmp_path):
    ref, ref_lists, port, lists, stream = tail_stream
    compact = {"PINGOO_STAGING": "compact", "PINGOO_STAGING_DEPTH": "64"}
    want, ref_sidecar = ring_drive(
        ref_nr, ref, ref_lists, stream, tmp_path / "ref",
        dict(compact, PINGOO_PIPELINE="on", PINGOO_SCHED_MODE="fixed",
             PINGOO_MEGASTEP="off"))
    assert ref_sidecar.depth_overflow_rows > 0
    got = {}
    for arm, env in (("full", {}), ("compact", compact),
                     ("compact_force", dict(compact, PINGOO_MEGASTEP="force",
                                            PINGOO_MEGASTEP_K="4"))):
        res, sidecar = ring_drive(nr, port, lists, stream, tmp_path / arm,
                                  env)
        got[arm] = res.actions
        st = sidecar.stats()
        if arm == "full":
            assert st["depth_overflow_rows"] == 0
            assert st["staging"]["caps"] is None
        else:
            assert st["depth_overflow_rows"] \
                == ref_sidecar.depth_overflow_rows
            assert st["staging"]["caps"]["url"] == 64
            assert st["staging"]["staged_bytes"] > 0
        if arm == "compact_force":
            assert st["megastep"]["windows"] > 0
            # A window of capped slices has the caps as its graph key's
            # widths (one width tuple per caps tuple).
            queue = sidecar._mega_queue
            buf = queue.checkout(block=False)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sidecar, "_staging", sidecar._staging)
                sidecar._encode_mega_slice(nr._warm_slots(16, True), buf, 0)
            key = sidecar._mega_runner.key(queue, buf, 1)
            queue.release(buf)
            caps = sidecar._staging.stage_caps
            assert key == ("lanes", 1, 16,
                           tuple(caps[f] for f in STRING_FIELDS), "auto")
    assert got["full"] == got["compact"] == got["compact_force"] \
        == want.actions
    assert res.checksum == want.checksum
    assert len({a & 3 for a in want.actions}) > 1


# -- the prefilter's compact mode -------------------------------------------------------


@pytest.fixture(scope="module")
def crs20():
    """A 20-rule plan of both packages (gated NFA and window banks on
    url, path and user_agent), and a cache of the JAX package's jitted
    programs by (mode, levels)."""
    ref_rules, ref_lists = ref_generate_ruleset(20, with_lists=True,
                                                list_sizes=(64, 16))
    rules, lists = generate_ruleset(20, with_lists=True, list_sizes=(64, 16))
    ref = ref_compile(ref_rules, ref_lists, field_specs=SMALL_SPECS)
    return (ref, ref_lists,
            compile_ruleset(rules, lists, field_specs=SMALL_SPECS,
                            device="cpu"),
            {"tables": jax.device_put(ref.device_tables())})


def leaf_matrix(plan, arrays, B):
    tensors = batch.batch_tensors(arrays, "cpu")
    leaves, _, _ = verdict._eval_leaves(plan, plan.np_tables, tensors, B,
                                        {})
    return np.stack([(v & ~e).numpy() for _, (v, e) in
                     sorted(leaves.items())], axis=1)


PF_SERVICES = ["s0", "s1"]


def ref_pf_lanes(ref, cache, key, arrays):
    """The JAX package's lanes, Stage A first, under the current
    PINGOO_PREFILTER mode (programs traced once per `key`)."""
    if key not in cache:
        cache[key] = (ref_verdict.make_prefilter_fn(ref).fn,
                      ref_verdict.make_lane_fn(ref, PF_SERVICES))
    stage_a, lanes = cache[key]
    tables = cache["tables"]
    return np.asarray(lanes(tables, arrays, stage_a(tables, arrays)[0]))


@pytest.mark.parametrize("levels", ["0", "1", "2", "4"])
@pytest.mark.parametrize("attacks", [0.02, 0.3])
def test_prefilter_compact_equals_banks_and_reference(crs20, monkeypatch,
                                                      levels, attacks):
    """B=256 at the fields' full (narrow) specs, where the JAX package's
    ladder has rungs of 128, 64 and 32 rows: leaves, matrix and lanes
    under compact equal `banks` and the JAX package's compact at every
    level; the port's compact scans some bank's exact candidate rows,
    fewer than B, whatever the level."""
    ref, ref_lists, port, cache = crs20
    ref_reqs = ref_generate_traffic(256, attack_fraction=attacks, seed=31,
                                    lists=ref_lists)
    arrays = batch.encode_requests(as_port(ref_reqs), port.field_specs).arrays
    ref_arrays = ref_batch.encode_requests(ref_reqs, ref.field_specs).arrays
    rows_seen = []
    scans = {name: getattr(verdict, name)
             for name in ("scan_chunk", "dfa_scan", "window_hits")}

    def counting(fn):
        def scan(tables_, data, *args, **kw):
            rows_seen.append(data.shape[0])
            return fn(tables_, data, *args, **kw)
        return scan

    out = {}
    for mode in ("banks", "compact"):
        lv = levels if mode == "compact" else None
        set_env(monkeypatch, PINGOO_PREFILTER=mode,
                PINGOO_PREFILTER_LEVELS=lv)
        for name, fn in scans.items():
            monkeypatch.setattr(verdict, name, counting(fn))
        rows_seen.clear()
        out[mode] = (leaf_matrix(port, arrays, 256),
                     verdict.make_verdict_fn(port)(port.np_tables,
                                                   arrays).numpy(),
                     verdict.make_lane_fn(port, PF_SERVICES)(
                         port.np_tables, arrays).numpy(),
                     set(rows_seen))
        for name, fn in scans.items():
            monkeypatch.setattr(verdict, name, fn)
        out[f"ref_{mode}"] = ref_pf_lanes(ref, cache, (mode, lv),
                                          ref_arrays)
    for i, name in enumerate(("leaves", "matrix", "lanes")):
        np.testing.assert_array_equal(out["compact"][i], out["banks"][i],
                                      err_msg=name)
    np.testing.assert_array_equal(out["compact"][2], out["ref_compact"])
    np.testing.assert_array_equal(out["ref_banks"], out["ref_compact"])
    # Row counts scanned under compact and not under banks are gathers
    # of candidate rows: fewer than B.
    extra = out["compact"][3] - out["banks"][3]
    assert all(0 < n < 256 for n in extra)
    if attacks == 0.02:
        assert extra
