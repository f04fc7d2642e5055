"""Each op of the PyTorch port against the JAX package, on tables carried
across with `tables_from_reference`.

The three kernel-holding ops run their plain PyTorch versions here (CPU
tensors) and are held bit-equal to the JAX package's Pallas kernels,
run as that package's own tests run them off-TPU (interpret mode), and,
for the chunked DFA and prefilter contracts, to its lax.scan chunk
functions: the NFA advance (pair and single
stepping, odd chunk widths, per-row and negative offsets, cross-word
carry, extra propagation passes, a batch that is no multiple of the
TPU's 128-row tile; the synthetic banks on which chip_smoke.py runs
every instantiation of the CUDA kernel, and banks wider than one of its
launches), the bitsplit-DFA walk and the prefilter shift-AND. The CUDA
kernels' own table layouts and variants, which only the card runs, are
pinned here too. Then match_ops, cidr and the window correlator. Every
comparison is of integers or booleans: the tolerance is zero.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import chip_smoke

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.compiler.nfa import build_bank as ref_build_bank
from pingoo_tpu.compiler.repat import compile_regex as ref_compile_regex
from pingoo_tpu.engine.batch import bucket_arrays, encode_requests
from pingoo_tpu.expr import Ip as RefIp
from pingoo_tpu.ops import bitsplit_dfa as ref_dfa
from pingoo_tpu.ops import cidr as ref_cidr
from pingoo_tpu.ops import match_ops as ref_match
from pingoo_tpu.ops import nfa_scan as ref_nfa
from pingoo_tpu.ops import pallas_scan as ref_pallas
from pingoo_tpu.ops import prefilter as ref_pf
from pingoo_tpu.ops import window_match as ref_win
from pingoo_tpu.utils.crs import generate_ruleset, generate_traffic
from pingoo_tpu_torch.compiler.plan import tables_from_reference
from pingoo_tpu_torch.ops import _build
from pingoo_tpu_torch.ops import bitsplit_dfa as dfa
from pingoo_tpu_torch.ops import cidr, match_ops, nfa_scan
from pingoo_tpu_torch.ops import prefilter as pf
from pingoo_tpu_torch.ops import window_match
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)


def carry(table):
    """One JAX-package table -> the port's, on the CPU."""
    return tables_from_reference({"t": table}, "cpu")["t"]


def t(a):
    return torch.from_numpy(np.array(a))


def field_of(key):
    return "user_agent" if "user_agent" in key else key.split("_")[-1]


def bits(a):
    """uint32 words -> the port's int32-bit tensor."""
    return t(np.asarray(a).astype(np.uint32).view(np.int32))


def words(x):
    """The port's int32-bit tensor -> uint32 numpy."""
    return x.numpy().view(np.uint32)


def random_batch(rng, L, B, alphabet):
    data = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i in range(B):
        n = rng.randint(0, L)
        data[i, :n] = np.frombuffer(
            bytes(rng.choice(alphabet) for _ in range(n)), np.uint8)
        lens[i] = n
    return data, lens


def seeded_plan(seed):
    """A 60-rule CRS-style plan and 96 requests of its traffic (field
    columns bucketed: at most 64 bytes here)."""
    rules, lists = generate_ruleset(60, with_lists=True,
                                    list_sizes=(128, 32), seed=seed)
    plan = ref_compile(rules, lists)
    reqs = generate_traffic(96, lists=lists, seed=seed + 1,
                            attack_fraction=0.4)
    arrays = bucket_arrays(encode_requests(reqs).arrays)
    return plan, arrays


@pytest.fixture(scope="module", params=SEEDS)
def seeded(request):
    return seeded_plan(request.param)


# -- NFA advance --------------------------------------------------------------


def check_nfa(ref_tables, data, lens, state, toff):
    """Port chunk advance (scan_chunk) == the JAX package's Pallas
    kernel, at pair and single stepping."""
    port = carry(ref_tables)
    ref_toff = toff if isinstance(toff, int) else np.asarray(toff, np.int32)
    p_toff = toff if isinstance(toff, int) else t(toff)
    for pair in (True, False):
        want = np.asarray(ref_pallas.fused_scan_chunk(
            ref_tables, data, lens, state, ref_toff, pair=pair))
        got = nfa_scan.scan_chunk(port, t(data), t(lens), bits(state),
                                  p_toff, pair=pair)
        np.testing.assert_array_equal(words(got), want, err_msg=str(pair))
    return want


def test_nfa_corpus_banks(seeded):
    plan, arrays = seeded
    for key, tables in plan.np_tables.items():
        if not key.startswith("nfa_"):
            continue
        field = key[4:]
        data, lens = arrays[f"{field}_bytes"], arrays[f"{field}_len"]
        assert data.shape[1] <= 64
        state = np.zeros((data.shape[0], tables.opt.shape[0]), np.uint32)
        final = check_nfa(tables, data, lens, state, 0)
        got = nfa_scan.nfa_scan(carry(tables), t(data), t(lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            ref_nfa.extract_slots(tables, final, lens)))


CARRY_SOURCES = [r"abc", "x" * 40, r"<svg[^>]{0,40}onload", r"\.php$",
                 "b" * 45 + "$", r"\babc\b", "e{0,60}f", r"qq", r"(ab)+c"]


def carry_bank():
    patterns = []
    for src in CARRY_SOURCES:
        patterns.extend(ref_compile_regex(src))
    return ref_nfa.bank_to_tables(ref_build_bank(patterns))


def planted_batch(rng, L, B):
    data, lens = random_batch(rng, L, B, b"xab<svg>onload .phpeqcf")
    for i, p in enumerate([b"x" * 40, b"w" * 11 + b"b" * 45,
                           b"<svg " + b"a" * 30 + b"onload", b"e" * 50 + b"f",
                           b"ababc", b"qq", b"abc"]):
        p = p[:L]
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
        data[i, len(p):] = 0
        lens[i] = len(p)
    return data, lens


def test_nfa_carry_and_passes_odd_width_untiled_batch():
    tables = carry_bank()
    assert tables.has_carry and tables.extra_passes > 0
    data, lens = planted_batch(random.Random(11), 63, 130)
    state = np.zeros((130, tables.opt.shape[0]), np.uint32)
    want = check_nfa(tables, data, lens, state, 0)
    assert want.any()


def test_nfa_per_row_negative_offsets_with_carried_state():
    tables = carry_bank()
    rng = random.Random(23)
    data, lens = planted_batch(rng, 64, 96)
    state = np.zeros((96, tables.opt.shape[0]), np.uint32)
    first = check_nfa(tables, data[:, :29], lens, state, 0)
    # Rows' second chunks start anywhere from 20 bytes before the field
    # to past its end (negative offsets are live-gated off).
    toff = np.array([rng.randint(-20, 40) for _ in range(96)], np.int32)
    check_nfa(tables, data[:, 29:], lens, first, toff)
    check_nfa(tables, data[:, 29:], lens, first, -5)


def test_nfa_odd_length_tiny_batch():
    patterns = []
    for src in (r"ab", r"c$", r"^d", r"e+f"):
        patterns.extend(ref_compile_regex(src))
    tables = ref_nfa.bank_to_tables(ref_build_bank(patterns))
    data, lens = random_batch(random.Random(9), 7, 3, b"abcdef")
    data[0, :2] = np.frombuffer(b"ab", np.uint8)
    lens[0] = 7
    check_nfa(tables, data, lens, np.zeros((3, tables.opt.shape[0]),
                                           np.uint32), 0)


# Every dispatch path of csrc/nfa_scan.cu: chip_smoke.py holds the CUDA
# kernel to the plain version on these banks on the card; here the plain
# version is held to the Pallas kernel on the same banks, built by the
# JAX package's compiler from the same sources.


@pytest.mark.parametrize("num_words,has_carry,passes,wide",
                         chip_smoke.width_cases())
def test_nfa_width_banks(num_words, has_carry, passes, wide):
    tables, lits = chip_smoke.width_tables(
        num_words, has_carry, passes, wide, ref_compile_regex,
        ref_build_bank, ref_nfa.bank_to_tables)
    rng = np.random.default_rng(1000 * num_words + 10 * passes + has_carry)
    B, L, cut = 13, 33, 14
    data, lens = chip_smoke.width_batch(rng, lits, B, L, wide)
    zero = np.zeros((B, num_words), np.uint32)
    first = np.asarray(ref_pallas.fused_scan_chunk(tables, data[:, :cut],
                                                   lens, zero, 0))
    assert first.any()
    port = carry(tables)
    for pair in (True, False):
        got = nfa_scan.scan_chunk(port, t(data[:, :cut]), t(lens), bits(zero),
                                  0, pair=pair)
        np.testing.assert_array_equal(words(got), first, err_msg=str(pair))
    toff = (cut + rng.integers(-20, 8, size=B)).astype(np.int32)
    want = check_nfa(tables, data[:, cut:], lens, first, toff)
    # The instantiation the CUDA kernel runs gives the same state: a bank
    # without carry runs one pass whatever `passes` says.
    _, P, _ = nfa_scan.kernel_variant(num_words, passes, has_carry)
    run = dataclasses.replace(port, extra_passes=(P or passes) - 1)
    got = nfa_scan.scan_chunk_plain(run, t(data[:, cut:]), t(lens),
                                    bits(first), t(toff))
    np.testing.assert_array_equal(words(got), want)


@pytest.mark.parametrize("num_words,passes,has_carry,want", [
    (1, 1, False, (1, 1, False)), (32, 3, False, (1, 1, False)),
    (33, 1, True, (2, 0, True)), (64, 2, True, (2, 2, True)),
    (65, 3, True, (3, 0, True)), (96, 4, True, (3, 0, True)),
    (97, 2, True, (4, 2, True)), (128, 6, True, (4, 0, True)),
    (129, 1, False, (6, 1, False)), (192, 2, True, (6, 2, True)),
    (193, 2, True, (8, 2, True)), (256, 1, True, (8, 0, True)),
    (257, 5, False, (12, 1, False)), (384, 2, True, (12, 2, True)),
    (385, 3, True, (16, 0, True)), (512, 2, True, (16, 2, True)),
])
def test_nfa_kernel_variant(num_words, passes, has_carry, want):
    """Words per lane, unrolled passes and carry of the CUDA kernel's
    instantiation for a bank."""
    assert nfa_scan.kernel_variant(num_words, passes, has_carry) == want


@pytest.mark.parametrize("num_words,passes,has_carry,want,launches", [
    (513, 1, True, (16, 0, True), 2), (513, 2, False, (16, 1, False), 2),
    (600, 2, True, (16, 2, True), 2), (600, 1, False, (16, 1, False), 2),
    (1024, 3, True, (16, 0, True), 2), (1024, 2, True, (16, 2, True), 2),
    (2000, 2, True, (16, 2, True), 4), (2000, 1, False, (16, 1, False), 4),
])
def test_nfa_kernel_variant_wide_banks(num_words, passes, has_carry, want,
                                       launches):
    """A bank wider than 512 words runs at K = 16 in segments of 512
    words, one launch each, in word order."""
    assert nfa_scan.kernel_variant(num_words, passes, has_carry) == want
    spans = nfa_scan.segments(num_words)
    assert len(spans) == launches
    assert spans[0][0] == 0 and spans[-1][1] == num_words
    assert all(hi - lo <= nfa_scan.SEGMENT_WORDS for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_nfa_wide_plan_bank():
    """A bank wider than one launch of the NFA kernel (600 rules build a
    600-word nfa_path): the port's compiler builds the JAX package's
    tables, and the port's plain scan equals that package's Pallas
    kernel (interpret mode) and its plain scan, over a first chunk and a
    carried chunk at per-row offsets."""
    from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
    from pingoo_tpu.expr import compile_expression as ref_compile_expression
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config.schema import RuleConfig
    from pingoo_tpu_torch.expr import compile_expression

    pairs = chip_smoke.wide_rules()
    srcs = chip_smoke.wide_rule_sources(pairs)
    ref = ref_compile([RefRuleConfig(name=f"w{i}", actions=(),
                                     expression=ref_compile_expression(src))
                       for i, src in enumerate(srcs)], {})
    port = compile_ruleset([RuleConfig(name=f"w{i}", actions=(),
                                       expression=compile_expression(src))
                            for i, src in enumerate(srcs)], {}, device="cpu")
    tables = ref.np_tables["nfa_path"]
    W = tables.opt.shape[0]
    assert W == 600 and len(nfa_scan.segments(W)) == 2
    got_arrays = port.np_tables["nfa_path"].numpy_arrays()
    for name, want in carry(tables).numpy_arrays().items():
        np.testing.assert_array_equal(got_arrays[name], want, err_msg=name)
    rng = np.random.default_rng(600)
    B, L, cut = 16, 64, 23
    data, lens = chip_smoke.wide_batch(rng, pairs, B, L)
    zero = np.zeros((B, W), np.uint32)
    port_t = port.np_tables["nfa_path"]
    toff = (cut + rng.integers(-20, 8, size=B)).astype(np.int32)
    state = zero
    for chunk, off in ((data[:, :cut], 0), (data[:, cut:], toff)):
        want = np.asarray(ref_pallas.fused_scan_chunk(tables, chunk, lens,
                                                      state, off))
        np.testing.assert_array_equal(
            np.asarray(ref_nfa.scan_chunk(tables, chunk, lens, state, off)),
            want)
        got = nfa_scan.scan_chunk_plain(
            port_t, t(chunk), t(lens), bits(state),
            off if isinstance(off, int) else t(off))
        np.testing.assert_array_equal(words(got), want)
        state = want
    assert np.asarray(ref_nfa.extract_slots(tables, state, lens)).any()


# -- bitsplit DFA ---------------------------------------------------------


def test_dfa_corpus_banks(seeded):
    plan, arrays = seeded
    rng = np.random.default_rng(3)
    seen = 0
    for key, tables in plan.np_tables.items():
        if not key.startswith("dfa_"):
            continue
        seen += 1
        field = field_of(key)
        data, lens = arrays[f"{field}_bytes"], arrays[f"{field}_len"]
        port = carry(tables)
        want = np.asarray(ref_dfa._fused_dfa(tables, data, lens))
        np.testing.assert_array_equal(
            dfa.dfa_scan(port, t(data), t(lens)).numpy(), want, err_msg=key)
        # Chunked: a carried (state, H) and per-row offsets.
        B = data.shape[0]
        st0, H0 = ref_dfa.dfa_scan_chunk(
            tables, data[:, :19], lens, *ref_dfa.dfa_init_state(
                B, tables.num_words), 0)
        toff = rng.integers(-8, 30, size=B).astype(np.int32)
        rs, rH = ref_dfa.dfa_scan_chunk(tables, data[:, 19:], lens, st0, H0,
                                        toff)
        ps, pH = dfa.dfa_scan_chunk(port, t(data[:, 19:]), t(lens), t(st0),
                                    bits(H0), t(toff))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(words(pH), np.asarray(rH))
        np.testing.assert_array_equal(
            dfa.dfa_finalize(port, ps, pH, t(lens)).numpy(),
            np.asarray(ref_dfa.dfa_finalize(tables, rs, rH, lens)))
    assert seen >= 2


# The CUDA kernel reads each DFA table in its own layout (kernel_layout),
# made once per table: entries round-trip to trans_flat and step_accept,
# and each corpus table is given the path chip_smoke.py measured it on.

CORPUS_DFA_PATHS = {"dfa_url": "smem", "dfa_path": "l2", "dfa_win_url": "l2",
                    "dfa_win_path": "smem", "dfa_win_user_agent": "smem"}


@pytest.fixture(scope="module")
def crs500_port_tables():
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.utils.crs import generate_ruleset as port_ruleset

    rules, lists = port_ruleset(500)
    return compile_ruleset(rules, lists, device="cpu").np_tables


def unpack_layout(layout, S, C, Wh):
    """(next states [S * C], flags or None, step_accept [S, Wh] as int32
    bits) from a DfaLayout; every pad byte must be zero."""
    raw = layout.data
    assert raw.dtype == torch.uint8 and raw.numel() == \
        layout.trans_bytes + layout.accept_bytes
    assert layout.trans_bytes % 16 == 0 and layout.accept_bytes % 16 == 0
    entries = raw[:layout.trans_bytes].view(torch.int16).long() & 0xFFFF
    assert not entries[S * C:].any()
    entries = entries[:S * C]
    acc = raw[layout.trans_bytes:].view(torch.int32)
    assert not acc[S * Wh:].any()
    flags = entries & 1 if layout.shift else None
    return entries >> layout.shift, flags, acc[:S * Wh].view(S, Wh)


def raw_bytes(layout):
    return layout.trans_bytes + layout.accept_bytes


def check_layout(tables):
    layout = dfa.kernel_layout(tables)
    assert dfa.kernel_layout(tables) is layout  # made once per table
    S, C, Wh = tables.num_states, tables.num_classes, tables.num_words
    # Staged whole where it fits in a block's shared memory.
    assert layout.path == ("smem" if raw_bytes(layout) <=
                           dfa.SMEM_LAYOUT_BYTES else "l2")
    nxt, flags, acc = unpack_layout(layout, S, C, Wh)
    np.testing.assert_array_equal(nxt.numpy(), tables.trans_flat.numpy())
    np.testing.assert_array_equal(acc.numpy(), tables.step_accept.numpy())
    if flags is not None:
        has_accept = (tables.step_accept != 0).any(dim=1)
        np.testing.assert_array_equal(flags.bool().numpy(),
                                      has_accept[nxt].numpy())
    return layout


@pytest.mark.parametrize("key", sorted(CORPUS_DFA_PATHS))
def test_dfa_kernel_layout_round_trip(crs500_port_tables, key):
    layout = check_layout(crs500_port_tables[key])
    assert layout.shift == 1


def test_dfa_kernel_layout_paths(crs500_port_tables):
    """Which corpus DFA tables the kernel stages into shared memory and
    which it reads from L2."""
    got = {k: dfa.kernel_layout(t).path
           for k, t in crs500_port_tables.items() if k.startswith("dfa_")}
    assert got == CORPUS_DFA_PATHS


@pytest.mark.parametrize("S,C,Wh,shift,path", [
    (300, 20, 12, 1, "smem"), (32768, 3, 1, 1, "l2"),
    (32769, 2, 2, 0, "l2"), (65536, 2, 9, 0, "l2"),
])
def test_dfa_kernel_layout_synthetic(S, C, Wh, shift, path):
    """Tables past the flag's reach (S > 32768) keep bare 16-bit states;
    a small table is staged whatever Wh is."""
    tables = chip_smoke.random_dfa_tables(np.random.default_rng(S), S, C, Wh)
    layout = check_layout(tables)
    assert (layout.shift, layout.path) == (shift, path)


def test_dfa_kernel_layout_refuses_too_many_states():
    tables = chip_smoke.random_dfa_tables(np.random.default_rng(1),
                                          dfa.MAX_STATES + 1, 2, 1)
    with pytest.raises(ValueError, match="65536-state"):
        dfa.build_layout(tables)


# -- prefilter ------------------------------------------------------------


def test_prefilter_corpus_banks(seeded):
    plan, arrays = seeded
    rng = np.random.default_rng(5)
    for field, ff in plan.prefilter.fields.items():
        tables = plan.np_tables[ff.table_key]
        data, lens = arrays[f"{field}_bytes"], arrays[f"{field}_len"]
        port = carry(tables)
        want_H = np.asarray(ref_pf._fused_prefilter(tables, data, lens))
        B = data.shape[0]
        S, H = pf.prefilter_init_state(B, port.num_words, "cpu")
        _, pH = pf.prefilter_scan_chunk(port, t(data), t(lens), S, H, 0)
        np.testing.assert_array_equal(words(pH), want_H, err_msg=field)
        np.testing.assert_array_equal(
            pf.prefilter_scan(port, t(data), t(lens)).numpy(),
            np.asarray(ref_pf.prefilter_extract(tables, want_H)))
        # Chunked: carried (S, H) and per-row offsets.
        rS, rH = ref_pf.prefilter_scan_chunk(
            tables, data[:, :21], lens,
            *ref_pf.prefilter_init_state(B, tables.num_words), 0)
        toff = rng.integers(-6, 30, size=B).astype(np.int32)
        wS, wH = ref_pf.prefilter_scan_chunk(tables, data[:, 21:], lens,
                                             rS, rH, toff)
        gS, gH = pf.prefilter_scan_chunk(port, t(data[:, 21:]), t(lens),
                                         bits(rS), bits(rH), t(toff))
        np.testing.assert_array_equal(words(gS), np.asarray(wS))
        np.testing.assert_array_equal(words(gH), np.asarray(wH))


def test_prefilter_fields_corpus(seeded):
    """The grouped Stage-A entry on CPU tensors == the JAX package's
    Pallas kernel (interpret mode) then `prefilter_extract`, per field."""
    plan, arrays = seeded
    names = list(plan.prefilter.fields)
    refs = [plan.np_tables[plan.prefilter.fields[f].table_key]
            for f in names]
    got = pf.prefilter_scan_fields(
        [carry(r) for r in refs], [t(arrays[f"{f}_bytes"]) for f in names],
        [t(arrays[f"{f}_len"]) for f in names])
    assert len(got) == len(names) == 3
    for field, ref, hits in zip(names, refs, got):
        data, lens = arrays[f"{field}_bytes"], arrays[f"{field}_len"]
        want = ref_pf.prefilter_extract(
            ref, ref_pf._fused_prefilter(ref, data, lens))
        np.testing.assert_array_equal(hits.numpy(), np.asarray(want),
                                      err_msg=field)


@pytest.mark.parametrize("Lc,B,Wp,want", [
    (64, 2048, 52, 64), (32, 2048, 25, 32), (128, 2048, 3, 128),
    (0, 8, 3, 16), (2048, 2048, 52, 1024), (2048, 2048, 25, 1024),
    (256, 2048, 3, 256), (511, 2048, 52, 256), (2048, 2048, 202, 1024),
    (2048, 2048, 300, 2048), (2048, 75, 1, 256), (4096, 64, 52, 256),
    (2048, 2048, 4500, 2048), (64, 2048, 4500, 64),
])
def test_prefilter_segment_length(Lc, B, Wp, want):
    """Columns per segment of the CUDA kernel's walk: one segment for the
    main path's short rows, two for a 2048-row batch at full width; a
    row's segments and 256-word slices fit one block of 16 warps, but for
    a bank of more than 4096 words, whose slices alone spread over
    blocks, which keeps one segment."""
    seg = pf.segment_length(Lc, B, Wp)
    assert seg == want and seg % 16 == 0
    nseg = max(1, -(-Lc // seg))
    slices = -(-Wp // pf.SLICE_WORDS)
    units = pf.KERNEL_WARPS * 32 // pf.lanes_per_unit(Wp)
    assert nseg * slices <= units or (nseg == 1 and slices > units)


# Columns a segment of csrc/prefilter.cu walks before its first own one.
PF_WARM = 32


def segmented_chunk(port, data, lens, S, H, toff, seg):
    """The CUDA kernel's segmented walk of one chunk, from the plain chunk
    scan: segment k (columns [k*seg, k*seg + seg)) starts PF_WARM columns
    early from S = 0, or at column 0 from S_in, and ORs all it walks into
    H; H_in joins, and S is the segment's that holds the row's last live
    column (segment 0's when none is live)."""
    Lc = data.shape[1]
    steps = np.clip(lens.astype(np.int64) - toff, 0, Lc)
    owner = t(np.maximum(steps - 1, 0) // seg)
    zero = torch.zeros_like(S)
    S_out, H_out = S.clone(), H.clone()
    for k, s in enumerate(range(0, Lc, seg)):
        w = s - PF_WARM if s > PF_WARM else 0
        S_k, H_k = pf.prefilter_scan_chunk_plain(
            port, t(data[:, w:s + seg]), t(lens), S if w == 0 else zero,
            zero, t((toff + w).astype(np.int32)))
        H_out |= H_k
        S_out = torch.where((owner == k)[:, None], S_k, S_out)
    return S_out, H_out


@pytest.mark.parametrize("seg", [16, 32, 48, 64, 112])
def test_prefilter_segments_warm_up(seg):
    """Rows cut into segments with a PF_WARM-column warm-up give the JAX
    package's chunk scan exactly: 32-byte factors straddle every segment
    boundary, rows have 0, 1, 31, 32, 33 and all live columns, and the
    chunk starts from a carried (S, H) at per-row, partly negative
    offsets."""
    rng = np.random.default_rng(seg)
    facs = [rng.integers(97, 123, size=m).astype(np.uint8)
            for m in (32, 32, 32, 31, 17, 5, 1, 32, 24, 32)]
    bank = ref_pf.build_prefilter_bank(
        [tuple(frozenset([int(c)]) for c in f) for f in facs])
    ref_tables = ref_pf.bank_to_prefilter_tables(bank)
    port = carry(ref_tables)
    # Row b: factor b // 7 (b % 10 for the last 4 rows, of random length),
    # live columns of the chunk [0, 1, 31, 32, 33, all, none][b % 7].
    B, first, Lc = 74, 37, 123
    data = rng.integers(97, 123, size=(B, first + Lc)).astype(np.uint8)
    toff = (first + rng.integers(-40, 8, size=B)).astype(np.int32)
    live = np.array([0, 1, 31, 32, 33, Lc, -5] * 11)[:B]
    lens = np.clip(toff + live, 0, None).astype(np.int32)
    lens[-4:] = rng.integers(0, first + Lc, size=4)
    for b in range(B):
        f = facs[b // 7 if b < 70 else b % 10]
        for s in range(seg, Lc, seg):  # ends at s, or starts there
            at = first + s - len(f) + 1
            if b % 2 and first + s + len(f) <= first + Lc:
                at = first + s
            data[b, at:at + len(f)] = f
    S0, H0 = ref_pf.prefilter_init_state(B, bank.num_words)
    rS, rH = ref_pf.prefilter_scan_chunk(ref_tables, data[:, :first], lens,
                                         S0, H0, 0)
    assert np.asarray(rH).any()
    wS, wH = ref_pf.prefilter_scan_chunk(ref_tables, data[:, first:], lens,
                                         rS, rH, toff)
    gS, gH = segmented_chunk(port, data[:, first:], lens, bits(rS),
                             bits(rH), toff, seg)
    np.testing.assert_array_equal(words(gS), np.asarray(wS))
    np.testing.assert_array_equal(words(gH), np.asarray(wH))
    assert (np.asarray(ref_pf.prefilter_extract(ref_tables, wH)).sum(0)
            > 0).all()
    # From a fresh state, over the whole row at offset 0.
    zero = bits(np.zeros((B, bank.num_words), np.uint32))
    _, want = ref_pf.prefilter_scan_chunk(ref_tables, data, lens, S0, H0, 0)
    _, got = segmented_chunk(port, data, lens, zero, zero,
                             np.zeros(B, np.int64), seg)
    np.testing.assert_array_equal(words(got), np.asarray(want))


def test_cpu_wrappers_launch_no_kernel(seeded):
    """On CPU tensors every scan runs its plain version: no launch is
    counted."""
    plan, arrays = seeded
    _build.reset_launch_counts()
    for prefix, scan in (("nfa_", nfa_scan.nfa_scan), ("dfa_", dfa.dfa_scan),
                         ("pf_", pf.prefilter_scan)):
        key = next(k for k in plan.np_tables if k.startswith(prefix))
        field = field_of(key)
        scan(carry(plan.np_tables[key]), t(arrays[f"{field}_bytes"]),
             t(arrays[f"{field}_len"]))
    names = list(plan.prefilter.fields)
    pf.prefilter_scan_fields(
        [carry(plan.np_tables[plan.prefilter.fields[f].table_key])
         for f in names], [t(arrays[f"{f}_bytes"]) for f in names],
        [t(arrays[f"{f}_len"]) for f in names])
    assert {k: v.launches for k, v in _build.KERNELS.items()} == \
        {"nfa_scan": 0, "bitsplit_dfa": 0, "prefilter": 0}


def test_kernel_launchers_refuse_cpu_tensors(seeded):
    """The CUDA launchers raise on CPU tensors instead of running the
    plain version, and count no launch."""
    plan, arrays = seeded
    _build.reset_launch_counts()
    for prefix in ("nfa_", "dfa_", "pf_"):
        key = next(k for k in plan.np_tables if k.startswith(prefix))
        port = carry(plan.np_tables[key])
        field = field_of(key)
        data, lens = t(arrays[f"{field}_bytes"]), t(arrays[f"{field}_len"])
        B = data.shape[0]
        with pytest.raises(ValueError, match="CUDA"):
            if prefix == "nfa_":
                nfa_scan.fused_scan_chunk(port, data, lens,
                                          nfa_scan.init_scan_state(
                                              B, port.opt.shape[0], "cpu"),
                                          0)
            elif prefix == "dfa_":
                dfa.fused_dfa_chunk(port, data, lens, *dfa.dfa_init_state(
                    B, port.num_words, "cpu"), 0)
            else:
                pf.fused_prefilter_chunk(port, data, lens,
                                         *pf.prefilter_init_state(
                                             B, port.num_words, "cpu"), 0)
        if prefix == "pf_":
            with pytest.raises(ValueError, match="CUDA"):
                pf.fused_prefilter_fields([port], [data], [lens])
    assert {k: v.launches for k, v in _build.KERNELS.items()} == \
        {"nfa_scan": 0, "bitsplit_dfa": 0, "prefilter": 0}


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_prefilter_descriptors_outlive_their_launch(seeded, monkeypatch,
                                                    dtype):
    """Every field descriptor of a prefilter launch points at live memory
    when the launch is issued: the int32 lengths and unit-stride rows the
    wrapper makes are still held then, over three fields and for the
    chunk call. Runs on CPU tensors with the CUDA checks and the launch
    stubbed out; the stub reads each descriptor's rows and lengths after
    making tensors of the same sizes, which would take freed memory."""
    import ctypes

    plan, arrays = seeded
    names = list(plan.prefilter.fields)
    tabs = [carry(plan.np_tables[plan.prefilter.fields[f].table_key])
            for f in names]
    # Column-major rows: the wrapper copies them to unit stride.
    datas = [t(np.asfortranarray(arrays[f"{f}_bytes"])) for f in names]
    lenss = [t(arrays[f"{f}_len"]).to(dtype) for f in names]
    B = datas[0].shape[0]
    seen = []

    def launch(descs, nf, nrows, stream):
        descs = ctypes.cast(descs, ctypes.POINTER(pf._Field))
        for i in range(nf):
            d = descs[i]
            churn = [torch.full((nrows, n), -7, dtype=torch.int32)
                     for n in (1, 2, d.Lc // 4 + 1) for _ in range(4)]
            lens = np.ctypeslib.as_array(
                (ctypes.c_int32 * nrows).from_address(d.lens)).copy()
            rows = np.ctypeslib.as_array(
                (ctypes.c_uint8 * (nrows * d.stride)).from_address(d.data))
            seen.append((lens, rows.reshape(nrows, d.stride)[:, :d.Lc].copy()))
            del churn

    monkeypatch.setattr(pf, "require_cuda", lambda *a: None)
    monkeypatch.setattr(pf, "stream_of", lambda x: None)
    monkeypatch.setattr(pf.KERNEL, "launch", launch)
    pf.fused_prefilter_fields(tabs, datas, lenss)
    pf.fused_prefilter_chunk(tabs[0], datas[0], lenss[0],
                             *pf.prefilter_init_state(B, tabs[0].num_words,
                                                      "cpu"), 0)
    assert len(seen) == len(names) + 1 == 4
    for (lens, rows), data, want in zip(seen, datas + datas[:1],
                                        lenss + lenss[:1]):
        np.testing.assert_array_equal(lens, want.numpy())
        np.testing.assert_array_equal(rows, data.numpy())


# -- match_ops / cidr / window --------------------------------------------


def test_match_ops_parity():
    rng = random.Random(1234)
    pats = [(b"/.env", False), (b"/ADMIN", True), (b"x", False), (b"", False),
            (b"/a" * 20, True), (b".PHP", True), (b"~", False)]
    data, lens = random_batch(rng, 48, 200, b"/.envADMINadmin.phpPHPx~a")
    for i, (p, _) in enumerate(pats):
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    for build, ops in ((ref_match.build_pattern_table,
                        ("eq_match", "prefix_match")),
                       (ref_match.build_suffix_table, ("suffix_match",))):
        table = build(pats)
        port = carry(table)
        for op in ops:
            want = np.asarray(getattr(ref_match, op)(data, lens, table))
            got = getattr(match_ops, op)(t(data), t(lens), port).numpy()
            np.testing.assert_array_equal(got, want, err_msg=op)
            assert want.any()


def test_cidr_and_int_sets_parity():
    rng = random.Random(31337)
    entries = [RefIp(f"{rng.randrange(1, 224)}.{rng.randrange(256)}."
                     f"{rng.randrange(256)}.{rng.randrange(256)}")
               for _ in range(3000)]
    entries += [RefIp(f"{rng.randrange(1, 224)}.{rng.randrange(256)}.7.0/24")
                for _ in range(200)]
    entries += [RefIp("2001:db8::/32"), RefIp("10.0.0.0/8")]
    probes = [str(e).split("/")[0] for e in entries[::7]]
    probes += [f"{rng.randrange(1, 224)}.{rng.randrange(256)}.7.9"
               for _ in range(100)]
    probes += ["2001:db8::1", "2001:db9::1", "10.1.2.3", "0.0.0.0",
               "255.255.255.255"]
    ips = ref_cidr.encode_ip_batch([RefIp(p) for p in probes])
    ips_t = t(ips.astype(np.int64))
    for table in (ref_cidr.build_cidr_table(entries[:50] + entries[-2:]),
                  ref_cidr.build_cidr_table([]),
                  ref_cidr.build_v4_buckets(entries)):
        port = carry(table)
        fn = "v4_buckets_contains" if hasattr(table, "keys") \
            else "cidr_contains"
        want = np.asarray(getattr(ref_cidr, fn)(table, ips))
        np.testing.assert_array_equal(getattr(cidr, fn)(port, ips_t).numpy(),
                                      want, err_msg=fn)
    values = np.array([0, 1, 31, 32, 64500, 399999, -1, 2**40, -(2**40),
                       2**31, -(2**31), 7, 15169], dtype=np.int64)
    for vals in ([1, 31, 32, 64500, 15169, 399999], [-(2**40), 7, 2**40],
                 [-(2**31), 7, 2**31 - 1], []):
        table = ref_cidr.build_int_set(vals)
        want = np.asarray(ref_cidr.int_set_contains(table, values))
        got = cidr.int_set_contains(carry(table), t(values)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(vals))


def test_window_hits_parity(seeded):
    plan, arrays = seeded
    seen = 0
    for key, table in plan.np_tables.items():
        if not key.startswith("win_"):
            continue
        seen += 1
        field = key[4:]
        data, lens = arrays[f"{field}_bytes"], arrays[f"{field}_len"]
        want = np.asarray(ref_win.window_hits(table, data, lens))
        got = window_match.window_hits(carry(table), t(data), t(lens))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    assert seen
