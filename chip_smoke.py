#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pingoo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one CUDA card

1. Prints the card's name and power limit, builds the three CUDA
   kernels from pingoo_tpu_torch/csrc (one nvcc per source, together)
   and prints ptxas's registers and spills per instantiation.
2. Kernel phases: on the real 500-rule plan's tables, at B=2048 and the
   fields' full width (2048 bytes for url/path), with seeded lengths and
   planted attack strings, each kernel is held bit-equal to its plain
   PyTorch version on the card (the NFA at pair and single stepping and
   with per-row, partly negative offsets over an odd-width chunk; the
   DFA on every DFA table of the plan, also over a carried-state chunk
   at per-row offsets; the prefilter's chunk contract per field, over a
   carried-state chunk at per-row offsets, and its grouped Stage-A call
   over 1, 2 and 3 fields), and timed (median of CUDA-event timings,
   and queued behind a sleep). The NFA is also held bit-equal on
   synthetic banks that reach every instantiation of its kernel (words
   per lane x passes x carry, and banks wider than 512 words run in
   segments) and both table paths, and on a 600-rule plan whose
   nfa_path is 600 words wide; the prefilter on synthetic banks of 1 to
   300 words (several units per warp, shared-memory and L2 tables, 256-
   word slices) with 32-byte factors across its segment boundaries,
   and timed at several segment lengths.
   Stage A of one main-path batch (fresh state to hits, all three
   fields) is timed issued and queued, as one grouped call and as one
   call per field, and the profiler must show the grouped call running
   one device kernel.
3. Slice phase: a VerdictService(max_batch=2048) on the card answers
   8,192 CRS-style requests through `evaluate` under every
   PINGOO_DFA=off|auto|force x PINGOO_PREFILTER=off|banks mode; every
   matched row, action and verified_block must equal the interpreter
   oracle and the port's CPU path. The default mode (auto, banks) is the
   main path: the kernels' launch counts are reset just before it and
   read just after, and each kernel must have launched.
4. Config phase: the port booted from a deployment, as a server does.
   The same corpus is written as a pingoo deployment (its lists as CSV
   files, the rules as pingoo.yml's mapping, two services with `route:`
   predicates), parsed by load_and_validate (or parse_config on the
   mapping where PyYAML is missing), its lists loaded by load_lists and
   compiled with the services' routes on the card. The same stream
   through VerdictService (auto, banks) must give every rule column and
   both lanes of the main path and the oracle, each route column
   match_route's; explain() on 64 requests (list hits, attacks, clean)
   must agree with the interpreter, rule by rule, with tuple_digest's
   digest; stats.snapshot() must count the batches and requests served.
   The phase's launches per kernel are its `config_launches`.
5. Main-path capture: one more main-path pass records the inputs of
   every call of each kernel's launcher (NFA, DFA, and the prefilter's
   grouped Stage-A call), keyed by table (one key per field for the
   grouped call), and must show one prefilter call and launch per
   batch; each kernel's calls are replayed through it and its plain
   version (bit equality), and the replay is timed, issued by the host
   and queued on the card, beside its bound (and the DFA's chain floor).
6. Ring phase, in a process of its own: the native plane. The ring
   library is built from the port's copy (pingoo_tpu_torch/native), a
   RingSidecar(max_batch=2048) in a thread serves a ring of 16,384 slots
   on the 500-rule plan with its lists. A producer in a child process,
   as the httpd is, drives a warm stream, then the measured stream
   (generate_traffic(16384, seed=11)) twice, the second under
   torch.profiler. Each measured drive must give checksum 4032806221
   (the JAX package's value on this stream), VerdictService's verdict on
   the card for every request, every ticket answered once, a heartbeat
   age under 500 ms and launches of all three kernels (counts set to 0
   just before the drive, read just after). Prints {"ring": ...}: req/s, wait
   p50/p99, batches, the stage split, launches per batch and the
   device's busy share.
7. Body phase, in a process of its own: streaming body inspection
   (engine/bodyscan.py). (a) bench.py's body stream at the scanner's
   defaults (1,024 flows of 256-12,288 bytes, a payload planted in every
   third, windows of 4,096 bytes interleaved round-robin) through a
   BodyScanner in four configurations: the seed rule set under
   PINGOO_BODY_SCAN=auto (prefilter + DFA) and nfa with lazy starts on
   and off, and the CRS payload cores as 53 regex rules (prefilter + a
   41-word NFA). Every flow's streamed and contiguous verdict must equal
   the oracle, none degraded, the action bytes' crc32 the JAX package's,
   each configuration must launch its kernels (counts set to 0 just
   before the streamed pass, read just after), and every launch of a
   captured pass is replayed through kernel and plain version, bit for
   bit, and timed queued beside its bound. One more pass of each runs
   under torch.profiler (the device's busy share). (b) The native plane
   with PINGOO_BODY_INSPECT=on: the ring phase's set-up, a producer child
   driving generate_traffic(4096, seed=13) with a seed-set body on every
   fourth request; every ticket answered once on each lane, the merged
   bytes' crc32 the JAX package's sidecar's, each merged byte
   merge_actions(VerdictService's byte, the body oracle), no flow
   degraded, the heartbeat under 500 ms. Prints {"body": ...}.
8. Prints one JSON line of per-kernel results (with each kernel's
   launches in the config phase, on the ring drive and on the body
   phase's streamed passes),
   then, last, {"ok": true, "device": {...}}.

Any mismatch, build failure or error exits nonzero before the last line.
Imports no JAX and nothing of the JAX package.

    python3 chip_smoke.py --stage-a-of DIR

times one batch's Stage A as the port in DIR issues it and prints it as
a JSON line, but no result line: the smoke run uses it for its own
tree, and it times an earlier tree beside this one in one chip call.
`python3 chip_smoke.py --ring-phase` runs the ring phase alone (and
`--ring-producer PATH` is its producer, which drives one stream for each
line "seed requests every" it reads from stdin), and `--body-phase` the
body phase alone.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
import zlib

T_START = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20260417
B = 2048
N_REQUESTS = 8192
MODES = [(dfa, pf) for dfa in ("auto", "off", "force")
         for pf in ("banks", "off")]  # (auto, banks) first: the main path
# The ring phase: the JAX package's PINGOO_PIPELINE=off drive of the
# same stream (bench.py's pipeline bench: 16,384 requests of
# generate_traffic(seed=11), 500 rules, max_batch 2048) gives this crc32
# over the verdict bytes in stream order (BENCH_pipeline.json).
RING_REQUESTS = 16384
RING_CAPACITY = 16384
RING_CHECKSUM = 4032806221
# The httpd fails a request open when the sidecar's heartbeat is older.
HEARTBEAT_LIMIT_MS = 500
# Calls of a kernel's wrapper queued behind one sleep when its main-path
# launches are timed; with the wrapper's own small launches (a fill, a
# cast) that stays within the stream's launch queue.
QUEUED_CALLS = 256

# H100 SXM peaks: HBM 3.35 TB/s (data sheet); int32 ALU ops 16.7 T/s =
# 132 SMs x 64 INT32 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s fp32
# counts 128 FP32 lanes x 2 flops per FMA; Hopper has half as many INT32
# lanes).
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ
# The DFA's chain floor: a row's walk is a chain of dependent table
# loads, one per live byte, and no design of the algorithm shortens it.
# At about 30 cycles per shared-memory load, the launch takes at least
# its longest row's steps x 30 cycles.
CHAIN_CYCLES_PER_STEP = 30

# Synthetic NFA banks that reach every dispatch path of csrc/nfa_scan.cu:
# one bank per words-per-lane bucket (W <= 32, 64, 96, 128, 192, 256,
# 384, 512 words), two banks run in segments of 512 words (600: two
# segments, 1100: three), and per (cross-word carry, propagation passes) pair
# the compiler produces. Carry off with 2 or more passes, and more than
# 4 passes, it never produces (a pattern spans at most 4 words); the
# NFA phase forces those two through `extra_passes`.
WIDTH_TARGETS = (29, 61, 93, 125, 189, 253, 381, 509, 600, 1100)
WIDTH_COMBOS = ((False, 1), (True, 1), (True, 2), (True, 3), (True, 4))
# The pattern that gives a bank its carry and passes: a 40-byte literal
# spans two words with no optional run; an optional run of n bits adds
# one pass per word boundary it crosses.
CARRY_SOURCES = {1: "x" * 40, 2: r"e{0,40}f", 3: r"g{0,80}h",
                 4: r"k{0,95}m"}
FILLER_LEN = 25  # 25 positions + a guard bit: one word each, never two

ATTACKS = [
    b"/search?q=1' UNION SELECT pass --", b"<script>alert(1)</script>",
    b"../../../../etc/passwd", b"${jndi:ldap://evil}", b"php://input",
    b"/item?id=1 OR 1=1", b"%3Cscript%3E", b"sqlmap/1.8",
    b"<svg onload=alert(1)>", b"cmd.exe", b"sleep(5)", b"/.git/config",
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def field_batch(rng, width: int, dev):
    """[B, width] uint8 printable bytes with seeded lengths up to the
    full width and attack strings planted in about a third of rows."""
    import numpy as np
    import torch

    data = rng.integers(0x20, 0x7F, size=(B, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=B).astype(np.int32)
    lens[: B // 8] = width  # some rows fill the field
    for b in np.nonzero(rng.random(B) < 0.35)[0]:
        atk = ATTACKS[rng.integers(len(ATTACKS))][:width]
        if lens[b] >= len(atk):
            at = rng.integers(0, lens[b] - len(atk) + 1)
            data[b, at:at + len(atk)] = np.frombuffer(atk, dtype=np.uint8)
    for b in range(B):
        data[b, lens[b]:] = 0
    return (torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev))


def cuda_times(fn, reps: int) -> list[float]:
    """CUDA-event times (ms) of `fn()` over `reps` runs, after one
    warm-up run. Each run starts on an idle card, so the host's own
    time to issue the launches counts."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of `fn()` over `reps` runs."""
    return statistics.median(cuda_times(fn, reps))


def queued_ms(fn, reps: int) -> float:
    """CUDA-event time (ms) per run of `fn()` with all `reps` runs queued
    behind a sleep kernel: the card runs the launches back to back, so
    the host's time to issue them does not count. The host checks that
    the sleep was still running when it had issued every run (the start
    event not yet reached); if not, the sleep is lengthened and the runs
    made again, and after four tries the phase fails. The launches queued
    behind the sleep must stay within the stream's launch queue (about a
    thousand), or issuing them waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 100_000_000  # about 50 ms at the H100's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail(f"the host could not issue {reps} runs within a sleep of "
         f"{cycles // 4} cycles")


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over (kernel, plain) int tensor pairs;
    a shape mismatch fails."""
    err = 0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                 f"{tuple(want.shape)} {want.dtype}")
        d = (got.long() - want.long()).abs().max().item() if got.numel() \
            else 0
        err = max(err, int(d))
    return err


def live_columns(lens, toff, Lc: int, from_zero: bool):
    """[B] int64: the columns a kernel walks in each row, t = toff + i <
    len (the NFA also needs t >= 0; the DFA and the prefilter walk from
    column 0)."""
    import torch

    lens = lens.long()
    toff = toff.long() if isinstance(toff, torch.Tensor) \
        else torch.full_like(lens, int(toff))
    end = (lens - toff).clamp(0, Lc)
    if from_zero:
        return end
    return (end - (-toff).clamp(0, Lc)).clamp(min=0)


def nfa_work(tt, data, lens, toff) -> dict:
    """Bytes and int32 operations of one NFA chunk advance (its bound)."""
    B, Lc = data.shape
    W = tt.opt.shape[0]
    C = tt.cls_table.shape[0]
    live = int(live_columns(lens, toff, Lc, False).sum())
    passes = 1 + tt.extra_passes
    carry = 1 if tt.has_carry else 0
    per_word = 7 + 4 * passes + carry * (3 + 3 * (passes - 1))
    return dict(nbytes=live + 8 * B + C * W * 4 + 256 * 4 + 5 * W * 4
                + 2 * B * W * 4, ops=live * W * per_word)


def dfa_work(tt, data, lens, toff) -> dict:
    """Bytes and operations of one DFA chunk walk, and its chain: the
    longest row's steps."""
    B, Lc = data.shape
    steps = live_columns(lens, toff, Lc, True)
    live = int(steps.sum())
    Wh = tt.num_words
    return dict(nbytes=live + 8 * B + tt.num_states * tt.num_classes * 4
                + tt.num_states * Wh * 4 + 1024 + 2 * B * (1 + Wh) * 4,
                ops=live * (Wh + 3),  # Wh ORs, class lookup, index mul-add
                chain=int(steps.max()) if B else 0)


def pf_work(tt, data, lens, toff) -> dict:
    """Bytes and operations of one prefilter chunk shift-AND."""
    B, Lc = data.shape
    Wp = tt.num_words
    live = int(live_columns(lens, toff, Lc, True).sum())
    return dict(nbytes=live + 8 * B + 256 * Wp * 4 + Wp * 4 + 4 * B * Wp * 4,
                ops=live * Wp * 4)  # shift, or, and, or per word per byte


def add_work(works) -> dict:
    """Sum work dicts; chains of launches in a row add up too."""
    out = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0) + v
    return out


def bound_ms(work: dict) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over HBM
    rate and int32 operations over the int32 peak, and which it is."""
    t_bytes = work["nbytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = work["ops"] / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chain_floor_ms(work: dict) -> float:
    return work["chain"] * CHAIN_CYCLES_PER_STEP / CLOCK_HZ * 1e3


def field_of(key: str) -> str:
    """The request field a table's key scans (`dfa_win_user_agent` ->
    `user_agent`)."""
    return "user_agent" if key.endswith("user_agent") else key.split("_")[-1]


def kernel_phase(plan, dev, rng) -> dict:
    """Each kernel against its plain version on the card; returns the
    per-kernel measurements (launch counts are filled in later)."""
    import torch

    from pingoo_tpu_torch.ops import nfa_scan

    tables = plan.np_tables
    fields = {f: field_batch(rng, plan.field_specs[f], dev)
              for f in ("url", "path", "user_agent")}
    results = {}

    toff = torch.from_numpy(rng.integers(-40, 40, size=B).astype("int32")) \
        .to(dev)
    results["prefilter"] = prefilter_phase(plan, fields, toff, dev, rng)
    results["bitsplit_dfa"] = dfa_phase(plan, fields, toff, dev)

    # -- NFA: the exact banks behind the url/path DFAs ----------------------
    nfa_keys = [(key, key.split("_", 1)[1]) for key in plan.scan_plans]

    def nfa_run(fn, pair):
        outs = []
        for key, f in nfa_keys:
            t = tables[key]
            data, lens = fields[f]
            st = nfa_scan.init_scan_state(B, t.opt.shape[0], dev)
            outs.append(fn(t, data, lens, st, 0, pair))
        return outs

    got_pair = nfa_run(nfa_scan.fused_scan_chunk, True)
    got_single = nfa_run(nfa_scan.fused_scan_chunk, False)
    want = nfa_run(nfa_scan.scan_chunk_plain, True)
    err = max(max_abs_err(zip(got_pair, want)),
              max_abs_err(zip(got_single, want)))
    want_single = nfa_run(nfa_scan.scan_chunk_plain, False)
    err = max(err, max_abs_err(zip(want_single, want)))
    # Odd-width chunk, carried state, per-row (partly negative) offsets.
    key, f = nfa_keys[0]
    t = tables[key]
    data, lens = fields[f]
    chunk = data[:, 200:200 + 1023]
    for pair in (True, False):
        err = max(err, max_abs_err([(
            nfa_scan.fused_scan_chunk(t, chunk, lens, got_pair[0], toff,
                                      pair),
            nfa_scan.scan_chunk_plain(t, chunk, lens, got_pair[0], toff,
                                      pair))]))
    err = max(err, nfa_width_phase(dev, rng), wide_plan_phase(dev, rng))
    ms = cuda_ms(lambda: nfa_run(nfa_scan.fused_scan_chunk, True), 15)
    plain_ms = cuda_ms(lambda: nfa_run(nfa_scan.scan_chunk_plain, True), 2)
    work = add_work(nfa_work(tables[key], *fields[f], 0)
                    for key, f in nfa_keys)
    results["nfa_scan"] = dict(
        route="cuda", source="pingoo_tpu_torch/csrc/nfa_scan.cu",
        replaces="pingoo_tpu/ops/pallas_scan.py:71", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, work=work)
    print(f"nfa_scan: {[k for k, _ in nfa_keys]} pair+single, max_abs_err "
          f"{err}, {ms:.4f} ms (plain {plain_ms:.1f} ms)", flush=True)

    for name, r in results.items():
        if r["max_abs_err"] != 0:
            fail(f"{name} kernel disagrees with its plain version "
                 f"(max_abs_err {r['max_abs_err']})")
    return results


# Synthetic prefilter banks: Wp words each (1 and 3 run several units per
# warp; 202 is the widest table staged in shared memory, 240 is read from
# L2, 300 runs in two slices of 256 words, from L2; 4500 has 18 slices, a
# row's 16 in one block and 2 in another).
PF_SYNTHETIC_WORDS = (1, 3, 25, 52, 202, 240, 300, 4500)


def pf_synthetic_bank(words: int, rng):
    """A port PrefilterTables of exactly `words` words over the bytes
    "abcd": words - 1 factors of 32 bytes (one word each), then factors of
    1, 3, 5, 9 and 14 bytes that fill the last word. Returns (tables, the
    factors' bytes)."""
    import numpy as np

    from pingoo_tpu_torch.ops import prefilter as pf_ops

    lens = [32] * (words - 1) + [1, 3, 5, 9, 14]
    facs = [rng.integers(97, 101, size=m).astype(np.uint8) for m in lens]
    bank = pf_ops.build_prefilter_bank(
        [tuple(frozenset([int(c)]) for c in f) for f in facs])
    if bank.num_words != words:
        raise RuntimeError(f"prefilter bank of {words} words came out with "
                           f"{bank.num_words}")
    return pf_ops.bank_to_prefilter_tables(bank), facs


def pf_synthetic_phase(dev, rng) -> int:
    """The prefilter kernel against its plain version on
    PF_SYNTHETIC_WORDS banks over B=300 rows of 1100 columns, all banks in
    one grouped call (two launches of at most 4 fields), then each bank's
    chunk contract from that carried state over 427 columns at per-row
    offsets in -40..40. Each row plants 32-byte factors across every
    boundary of the kernel's segments (ending at it, or straddling it),
    and rows have 0, 1, 31, 32, 33 or all 1100 columns live. Returns the
    max_abs_err."""
    import numpy as np
    import torch

    from pingoo_tpu_torch.ops import prefilter as pf_ops

    Bs, L, L2 = 300, 1100, 427
    banks, datas, lenss, labels = [], [], [], []
    for words in PF_SYNTHETIC_WORDS:
        tables, facs = pf_synthetic_bank(words, rng)
        seg = pf_ops.segment_length(L, Bs, words)
        data = rng.integers(97, 101, size=(Bs, L + L2)).astype(np.uint8)
        lens = rng.integers(0, L + L2 + 1, size=Bs).astype(np.int32)
        lens[:60] = np.repeat([0, 1, 31, 32, 33, L], 10)
        for b in range(Bs):
            for s in list(range(seg, L, seg)) + [L]:
                f = facs[rng.integers(len(facs))]
                at = s - len(f) + 1 - (rng.integers(len(f)) if b % 2 else 0)
                data[b, max(at, 0):at + len(f)] = f[max(-at, 0):]
        banks.append(tables.to(dev))
        datas.append(torch.from_numpy(data).to(dev))
        lenss.append(torch.from_numpy(lens).to(dev))
        slices = -(-words // pf_ops.SLICE_WORDS)
        units = pf_ops.KERNEL_WARPS * 32 // pf_ops.lanes_per_unit(words)
        rows = max(1, units // (max(1, -(-L // seg)) * slices))
        smem = slices == 1 and (256 * words + pf_ops.TABLE_PAD) * 4 \
            + rows * words * 4 + 16 <= 227 * 1024
        labels.append(f"{words}w:seg{seg}{'smem' if smem else 'L2'}")
    first = [d[:, :L] for d in datas]
    hits = pf_ops.fused_prefilter_fields(banks, first, lenss)
    want = pf_ops.prefilter_scan_fields_plain(banks, first, lenss)
    if not all(w.any() for w in want):
        fail("a synthetic prefilter bank had no hit")
    err = max_abs_err(zip(hits, want))
    toff = torch.from_numpy((L + rng.integers(-40, 40, size=Bs))
                            .astype("int32")).to(dev)
    for tables, data, lens in zip(banks, datas, lenss):
        S, H = pf_ops.prefilter_init_state(Bs, tables.num_words, dev)
        got = pf_ops.fused_prefilter_chunk(tables, data[:, :L], lens, S, H, 0)
        plain = pf_ops.prefilter_scan_chunk_plain(tables, data[:, :L], lens,
                                                  S, H, 0)
        err = max(err, max_abs_err(zip(got, plain)))
        err = max(err, max_abs_err(zip(
            pf_ops.fused_prefilter_chunk(tables, data[:, L:], lens, *plain,
                                         toff),
            pf_ops.prefilter_scan_chunk_plain(tables, data[:, L:], lens,
                                              *plain, toff))))
    print(f"prefilter synthetic: {' '.join(labels)}; "
          f"{sum(int(w.sum()) for w in want)} hits; max_abs_err {err}",
          flush=True)
    return err


def prefilter_phase(plan, fields, toff, dev, rng) -> dict:
    """The prefilter kernel against its plain version on the plan's three
    Stage-A banks at B=2048 and full width: each field's chunk scan from a
    fresh state (S and H), a carried-state chunk of odd width at per-row
    offsets, the grouped call over 1, 2 and 3 fields (hits; with int64
    lengths too, which the wrapper casts), and the synthetic banks. Times
    the grouped call (all three fields, one launch, at the segment length
    `segment_length` picks), issued and queued, and the three chunk scans
    from a fresh state (one chunk call per field, its zero state
    included)."""
    from pingoo_tpu_torch.ops import prefilter as pf_ops

    tables = plan.np_tables
    names = [f for f in ("url", "path", "user_agent")
             if f in plan.prefilter.fields]
    tabs = [tables[plan.prefilter.fields[f].table_key] for f in names]
    datas = [fields[f][0] for f in names]
    lenss = [fields[f][1] for f in names]

    def chunk_run(fn):
        outs = []
        for t, data, lens in zip(tabs, datas, lenss):
            S, H = pf_ops.prefilter_init_state(B, t.num_words, dev)
            outs.extend(fn(t, data, lens, S, H, 0))
        return outs

    got = chunk_run(pf_ops.fused_prefilter_chunk)
    err = max_abs_err(zip(got, chunk_run(pf_ops.prefilter_scan_chunk_plain)))
    # Chunk contract: carried state, per-row offsets, odd width.
    chunk = datas[0][:, 101:101 + 511]
    err = max(err, max_abs_err(zip(
        pf_ops.fused_prefilter_chunk(tabs[0], chunk, lenss[0], got[0],
                                     got[1], toff),
        pf_ops.prefilter_scan_chunk_plain(tabs[0], chunk, lenss[0], got[0],
                                          got[1], toff))))
    wide = [lens.long() for lens in lenss]
    for n, lens in ((1, lenss), (2, lenss), (3, lenss), (2, wide), (3, wide)):
        err = max(err, max_abs_err(zip(
            pf_ops.fused_prefilter_fields(tabs[:n], datas[:n], lens[:n]),
            pf_ops.prefilter_scan_fields_plain(tabs[:n], datas[:n],
                                               lens[:n]))))
    err = max(err, pf_synthetic_phase(dev, rng))

    def grouped():
        return pf_ops.fused_prefilter_fields(tabs, datas, lenss)

    ms = cuda_ms(grouped, 15)
    device_ms = queued_ms(grouped, 64)
    chunk_ms = cuda_ms(lambda: chunk_run(pf_ops.fused_prefilter_chunk), 15)
    plain_ms = cuda_ms(lambda: pf_ops.prefilter_scan_fields_plain(
        tabs, datas, lenss), 2)
    picked = [pf_ops.segment_length(d.shape[1], B, t.num_words)
              for t, d in zip(tabs, datas)]
    work = pf_fields_work(tabs, datas, lenss)
    print(f"prefilter: {names} at full width, max_abs_err {err}; grouped "
          f"call {ms:.4f} ms issued, {device_ms:.4f} ms queued (bound "
          f"{bound_ms(work)[0]:.4f} ms), segments {picked} columns; three "
          f"chunk scans {chunk_ms:.4f} ms (plain {plain_ms:.1f} ms)",
          flush=True)
    return dict(
        route="cuda", source="pingoo_tpu_torch/csrc/prefilter.cu",
        replaces="pingoo_tpu/ops/prefilter.py:246", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, work=work, device_ms=device_ms,
        chunk_ms=chunk_ms, segments=picked)


# Synthetic DFAs that reach the kernel's other paths: (states, classes,
# accept words). Past 32768 states an entry carries no accept flag; a
# table past shared memory is read from L2; Wh above 8 keeps H in memory.
DFA_SYNTHETIC = ((300, 20, 12), (5000, 40, 9), (40000, 5, 3), (65536, 2, 1))


def random_dfa_tables(rng, S: int, C: int, Wh: int):
    """The port's DfaTables of a random DFA: S states over C byte
    classes, Wh accept words set on about one state in twenty."""
    import numpy as np

    from pingoo_tpu_torch.compiler.nfa import DfaBank
    from pingoo_tpu_torch.ops.bitsplit_dfa import dfa_to_tables

    def accepts():
        a = rng.integers(0, 2**32, size=(S, Wh), dtype=np.uint64) \
            .astype(np.uint32)
        a[rng.random(S) >= 0.05] = 0
        return a

    P = 32 * Wh
    return dfa_to_tables(DfaBank(
        trans=rng.integers(0, S, size=(S, C)).astype(np.int32),
        byte_cls=rng.integers(0, C, size=256).astype(np.int32),
        step_accept=accepts(), end_accept=accepts(),
        slot_always=np.zeros(P, bool), slot_empty_ok=np.zeros(P, bool),
        num_states=S, num_classes=C, num_slots=P, num_words=Wh))


def dfa_synthetic_phase(dev, rng) -> int:
    """The DFA kernel against its plain version on DFA_SYNTHETIC's tables:
    B=1000 rows (no multiple of a block) of 256 columns
    (read 16 bytes at a time) from the zero state, then 301 columns (read
    byte by byte) from that carried state at per-row offsets. Returns the
    max_abs_err."""
    import torch

    from pingoo_tpu_torch.ops import bitsplit_dfa as dfa_ops

    Bs = 1000
    err = 0
    for S, C, Wh in DFA_SYNTHETIC:
        tables = random_dfa_tables(rng, S, C, Wh).to(dev)
        data = torch.from_numpy(rng.integers(0, 256, size=(Bs, 557))
                                .astype("uint8")).to(dev)
        lens = torch.from_numpy(rng.integers(0, 600, size=Bs)
                                .astype("int32")).to(dev)
        toff = torch.from_numpy((256 + rng.integers(-40, 40, size=Bs))
                                .astype("int32")).to(dev)
        st, H = dfa_ops.dfa_init_state(Bs, Wh, dev)
        first = dfa_ops.dfa_scan_chunk_plain(tables, data[:, :256], lens, st,
                                             H, 0)
        second = dfa_ops.dfa_scan_chunk_plain(tables, data[:, 256:], lens,
                                              *first, toff)
        err = max(err, max_abs_err(zip(dfa_ops.fused_dfa_chunk(
            tables, data[:, :256], lens, st, H, 0), first)))
        err = max(err, max_abs_err(zip(dfa_ops.fused_dfa_chunk(
            tables, data[:, 256:], lens, *first, toff), second)))
    print(f"dfa synthetic: (states, classes, accept words) {DFA_SYNTHETIC}; "
          f"max_abs_err {err}", flush=True)
    return err


def dfa_phase(plan, fields, toff, dev) -> dict:
    """The DFA kernel against its plain version on every DFA table of the
    plan (the url/path gates and the window DFAs) at full width: a walk
    from the zero state, then a carried-state chunk of odd width at
    per-row offsets. Times the url + path gates (the work earlier runs
    timed) and each table alone."""
    import numpy as np

    from pingoo_tpu_torch.ops import bitsplit_dfa as dfa_ops

    tables = plan.np_tables
    keys = sorted(k for k in tables if k.startswith("dfa_"))
    gates = [e.dfa_key for e in plan.scan_plans.values() if e.dfa_key]

    def run(fn, ks):
        outs = []
        for k in ks:
            data, lens = fields[field_of(k)]
            st, H = dfa_ops.dfa_init_state(B, tables[k].num_words, dev)
            outs.extend(fn(tables[k], data, lens, st, H, 0))
        return outs

    got = run(dfa_ops.fused_dfa_chunk, keys)
    err = max_abs_err(zip(got, run(dfa_ops.dfa_scan_chunk_plain, keys)))
    for i, k in enumerate(keys):
        data, lens = fields[field_of(k)]
        chunk = data[:, 33:33 + 777]
        st, H = got[2 * i], got[2 * i + 1]
        err = max(err, max_abs_err(zip(
            dfa_ops.fused_dfa_chunk(tables[k], chunk, lens, st, H, toff),
            dfa_ops.dfa_scan_chunk_plain(tables[k], chunk, lens, st, H,
                                         toff))))
    err = max(err, dfa_synthetic_phase(dev, np.random.default_rng(SEED + 1)))
    per_table = {k: cuda_ms(lambda k=k: run(dfa_ops.fused_dfa_chunk, [k]), 15)
                 for k in keys}
    # Device time alone: the walk of one table from its initial state,
    # queued behind a sleep (the zero state is made once).
    init = {k: dfa_ops.dfa_init_state(B, tables[k].num_words, dev)
            for k in keys}

    def walk(fn, k):
        return fn(tables[k], *fields[field_of(k)], *init[k], 0)

    device = {k: queued_ms(lambda k=k: walk(dfa_ops.fused_dfa_chunk, k), 64)
              for k in keys}
    ms = cuda_ms(lambda: run(dfa_ops.fused_dfa_chunk, gates), 15)
    plain_ms = cuda_ms(lambda: run(dfa_ops.dfa_scan_chunk_plain, gates), 2)
    work = add_work(dfa_work(tables[k], *fields[field_of(k)], 0)
                    for k in gates)
    floors = {k: chain_floor_ms(dfa_work(tables[k], *fields[field_of(k)], 0))
              for k in keys}
    print(f"bitsplit_dfa: {keys} at full width, max_abs_err {err}; gates "
          f"{gates} {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
          f"{bound_ms(work)[0]:.4f} ms, chain floor "
          f"{chain_floor_ms(work):.4f} ms); per table ms issued / queued "
          "(chain floor): "
          + ", ".join(f"{k} {per_table[k]:.4f} / {device[k]:.4f} "
                      f"({floors[k]:.4f})" for k in keys), flush=True)
    return dict(
        route="cuda", source="pingoo_tpu_torch/csrc/bitsplit_dfa.cu",
        replaces="pingoo_tpu/ops/bitsplit_dfa.py:248", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, work=work, table_ms=per_table,
        table_device_ms=device)


def filler(i: int, wide: bool) -> bytes:
    """A 25-byte literal: lowercase letters, or with `wide` any byte but
    0 (banks of ~240 byte classes, whose padded table outgrows shared
    memory from K = 8 on)."""
    r = random.Random(1000 + i)
    if wide:
        return bytes(r.randrange(1, 256) for _ in range(FILLER_LEN))
    return bytes(r.choice(b"abcdijlnoqrstuvwyz") for _ in range(FILLER_LEN))


def width_bank(words: int, carry: bool, passes: int, compile_regex,
               build_bank, wide: bool = False):
    """An NfaBank of exactly `words` words, with a cross-word carry or
    not and `passes` propagation passes: CARRY_SOURCES[passes] plus
    one-word literals. Takes the compiler's two functions, so the port's
    and the JAX package's compilers build the same bank. Returns (bank,
    the literals' bytes)."""
    extra = [CARRY_SOURCES[passes]] if carry else []
    n = words
    for _ in range(6):
        lits = [filler(i, wide) for i in range(max(n, 0))]
        srcs = extra + ["".join(f"\\x{c:02x}" for c in lit) for lit in lits]
        bank = build_bank([p for s in srcs for p in compile_regex(s)])
        if bank.num_words == words:
            break
        n += words - bank.num_words
    got = (bank.num_words, bank.has_carry, bank.prop_passes)
    if got != (words, carry, passes):
        raise RuntimeError(f"width bank {(words, carry, passes)} came out "
                           f"as {got}")
    return bank, lits


def width_batch(rng, lits, B: int, L: int, wide: bool = False):
    """[B, L] uint8 rows over the bank's bytes with a carry pattern's
    match or a literal planted in each, lengths in [0, L] with every
    seventh row empty; returns numpy (data, lens)."""
    import numpy as np

    plants = [b"x" * 40, b"e" * 30 + b"f", b"g" * 70 + b"h",
              b"k" * 90 + b"m", b"ef", b"gh"] + lits[:8]
    alphabet = np.arange(1, 256, dtype=np.uint8) if wide \
        else np.frombuffer(b"xefghkmabcdijlnoqrs", np.uint8)
    data = rng.choice(alphabet, size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[::7] = 0
    for b in range(B):
        p = plants[rng.integers(len(plants))][:L]
        at = rng.integers(0, L - len(p) + 1)
        data[b, at:at + len(p)] = np.frombuffer(p, np.uint8)
        data[b, lens[b]:] = 0
    return data, lens


def width_cases():
    """(words, carry, passes, wide) of the NFA phase's synthetic banks:
    the compiler's (carry, passes) pairs at each words-per-lane bucket,
    carry off at 3 passes and carry at 6 (forced), and a wide-alphabet
    bank (carry, 2 passes)."""
    return [(w, c, p, wide) for w in WIDTH_TARGETS
            for c, p, wide in [(c, p, False) for c, p in WIDTH_COMBOS]
            + [(False, 3, False), (True, 6, False), (True, 2, True)]]


def width_tables(words, carry, passes, wide, compile_regex, build_bank,
                 bank_to_tables):
    """One width case's tables (through the given compiler) and literals;
    passes the compiler never gives are forced through `extra_passes`."""
    natural = (carry, passes) in WIDTH_COMBOS
    bank, lits = width_bank(words, carry, passes if natural else
                            (4 if carry else 1), compile_regex, build_bank,
                            wide)
    tables = bank_to_tables(bank)
    if not natural:
        tables = dataclasses.replace(tables, extra_passes=passes - 1)
    return tables, lits


def nfa_width_phase(dev, rng) -> int:
    """The NFA kernel against its plain version on synthetic banks that
    reach every instantiation of csrc/nfa_scan.cu (each words-per-lane
    bucket with each carry and pass count) and both table paths (shared
    memory, L2), at pair and single stepping: a first chunk from the zero
    state at offset 0, then an odd-width chunk from that carried state at
    per-row offsets, some negative, over B=75 rows (no multiple of the
    rows per block) with empty rows. The forced-pass cases read a class
    table that is not 16-byte aligned ("u" in the printed labels).
    Returns the max_abs_err."""
    import torch

    from pingoo_tpu_torch.compiler.nfa import build_bank
    from pingoo_tpu_torch.compiler.repat import compile_regex
    from pingoo_tpu_torch.ops import nfa_scan

    Bw, L, cut = 75, 131, 58
    err = cases = 0
    labels, seen = [], set()
    for words, carry, passes, wide in width_cases():
        tables, lits = width_tables(words, carry, passes, wide,
                                    compile_regex, build_bank,
                                    nfa_scan.bank_to_tables)
        tables = tables.to(dev)
        forced = (carry, passes) not in WIDTH_COMBOS
        if forced:  # a class table off 16-byte alignment: staged by words
            flat = torch.zeros(tables.cls_table.numel() + 1,
                               dtype=torch.int32, device=dev)
            flat[1:] = tables.cls_table.flatten()
            tables = dataclasses.replace(
                tables, cls_table=flat[1:].view(tables.cls_table.shape))
        data, lens = width_batch(rng, lits, Bw, L, wide)
        data = torch.from_numpy(data).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        toff = torch.from_numpy(
            (cut + rng.integers(-70, 20, size=Bw)).astype("int32")).to(dev)
        S0 = nfa_scan.init_scan_state(Bw, words, dev)
        first = nfa_scan.scan_chunk_plain(tables, data[:, :cut], lens, S0, 0)
        if not first.any():
            fail(f"width bank {(words, carry, passes, wide)}: the first "
                 f"chunk left every state word zero")
        for pair in (True, False):
            err = max(err, max_abs_err([
                (nfa_scan.fused_scan_chunk(tables, data[:, :cut], lens, S0,
                                           0, pair), first),
                (nfa_scan.fused_scan_chunk(tables, data[:, cut:], lens,
                                           first, toff, pair),
                 nfa_scan.scan_chunk_plain(tables, data[:, cut:], lens,
                                           first, toff, pair))]))
            cases += 2
        K, P, c = nfa_scan.kernel_variant(words, passes, carry)
        seg = carry and words > nfa_scan.SEGMENT_WORDS
        # The kernel reads a padded table above 227 KB from L2.
        l2 = 1024 + tables.cls_table.shape[0] * 128 * K > 227 * 1024
        seen.add((K, P, c, seg, l2))
        labels.append(f"{words}{'c' if carry else '-'}{passes}"
                      f"{'w' if wide else ''}:K{K}P{P}{'S' if seg else ''}"
                      f"{'L2' if l2 else ''}"
                      f"{'u' if forced and not seg else ''}")
    missing = [(K, P, c, seg) for K in nfa_scan.WORDS_PER_LANE
               for P, c in ((1, False), (2, True), (0, True))
               for seg in ((False, True) if c and K == 16 else (False,))
               if not any(s[:4] == (K, P, c, seg) for s in seen)]
    if missing or not any(s[4] for s in seen):
        fail(f"the width banks reached no {missing} instantiation or no "
             f"L2 table")
    print(f"nfa widths: {cases} cases, {len({s[:4] for s in seen})} "
          f"instantiations, {sum(s[4] for s in seen)} with the table in "
          f"L2: {' '.join(labels)}; max_abs_err {err}", flush=True)
    return err


def wide_rules(n: int = 600) -> list[tuple[str, str]]:
    """n distinct pairs of 6-letter words: the rules
    `http_request.path.matches("<a>[0-9]+<b>\\s*=")` take one NFA word
    each, so n of them build an n-word nfa_path, wider than one launch of
    the NFA kernel for n > 512 (no corpus rule set is that wide)."""
    r = random.Random(n)
    pairs = set()
    while len(pairs) < n:
        pairs.add(tuple("".join(r.choice("abcdefghijklmnopqrstuvwxyz")
                                for _ in range(6)) for _ in range(2)))
    return sorted(pairs)


def wide_rule_sources(pairs) -> list[str]:
    return [f'http_request.path.matches("{a}[0-9]+{b}\\\\s*=")'
            for a, b in pairs]


def wide_batch(rng, pairs, B: int, L: int):
    """[B, L] uint8 path rows (lowercase, digits, "/= "), a match of one of
    the rules planted in about half of them; returns numpy (data, lens)."""
    import numpy as np

    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789/= ",
                             np.uint8)
    data = rng.choice(alphabet, size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    for b in range(B):
        if rng.random() < 0.5:
            a, c = pairs[rng.integers(len(pairs))]
            hit = f"{a}{rng.integers(0, 1000)}{c}{' ' * rng.integers(3)}="
            hit = hit.encode()[:L]
            at = rng.integers(0, L - len(hit) + 1)
            data[b, at:at + len(hit)] = np.frombuffer(hit, np.uint8)
            lens[b] = max(lens[b], at + len(hit))
        data[b, lens[b]:] = 0
    return data, lens


def wide_plan_phase(dev, rng) -> int:
    """A plan whose nfa_path is wider than one launch (600 rules, 600
    words, two segments): its bank through the kernel against the plain
    version, over a first chunk and a carried chunk at per-row offsets,
    and the kernel's time on 2048 path rows of 128 bytes. Returns the
    max_abs_err."""
    import torch

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config.schema import RuleConfig
    from pingoo_tpu_torch.expr import compile_expression
    from pingoo_tpu_torch.ops import nfa_scan

    pairs = wide_rules()
    rules = [RuleConfig(name=f"wide{i}", expression=compile_expression(src),
                        actions=())
             for i, src in enumerate(wide_rule_sources(pairs))]
    tables = compile_ruleset(rules, {}, device=dev).np_tables["nfa_path"]
    W = tables.opt.shape[0]
    if W <= nfa_scan.SEGMENT_WORDS:
        fail(f"the wide plan's nfa_path has {W} words, not more than "
             f"{nfa_scan.SEGMENT_WORDS}")
    data, lens = (torch.from_numpy(a).to(dev)
                  for a in wide_batch(rng, pairs, 75, 131))
    toff = torch.from_numpy(
        (58 + rng.integers(-70, 20, size=75)).astype("int32")).to(dev)
    S0 = nfa_scan.init_scan_state(75, W, dev)
    first = nfa_scan.scan_chunk_plain(tables, data[:, :58], lens, S0, 0)
    err = max_abs_err([
        (nfa_scan.fused_scan_chunk(tables, data[:, :58], lens, S0, 0), first),
        (nfa_scan.fused_scan_chunk(tables, data[:, 58:], lens, first, toff),
         nfa_scan.scan_chunk_plain(tables, data[:, 58:], lens, first, toff))])
    data, lens = (torch.from_numpy(a).to(dev)
                  for a in wide_batch(rng, pairs, B, 128))
    S0 = nfa_scan.init_scan_state(B, W, dev)
    ms = cuda_ms(lambda: nfa_scan.fused_scan_chunk(tables, data, lens, S0, 0),
                 15)
    print(f"nfa wide plan: nfa_path W={W} in "
          f"{len(nfa_scan.segments(W))} launches, max_abs_err {err}; "
          f"{B}x128 path rows {ms:.4f} ms (bound "
          f"{bound_ms(nfa_work(tables, data, lens, 0))[0]:.4f} ms)",
          flush=True)
    return err


def pf_fields_work(tabs, datas, lenss) -> dict:
    """Bytes and operations of one grouped prefilter call: each field's
    chunk shift-AND from offset 0 (`pf_work`, the same yardstick as one
    chunk call per field)."""
    return add_work(pf_work(t, data, lens, 0)
                    for t, data, lens in zip(tabs, datas, lenss))


def launchers():
    """Each kernel's module, launcher name (the dispatcher looks it up at
    call time), plain version and the work of a call (its tables and
    positional arguments)."""
    from pingoo_tpu_torch.ops import bitsplit_dfa as dfa_ops
    from pingoo_tpu_torch.ops import nfa_scan
    from pingoo_tpu_torch.ops import prefilter as pf_ops

    return {
        "nfa_scan": (nfa_scan, "fused_scan_chunk", nfa_scan.scan_chunk_plain,
                     lambda tt, a: nfa_work(tt, a[0], a[1], a[-1])),
        "bitsplit_dfa": (dfa_ops, "fused_dfa_chunk",
                         dfa_ops.dfa_scan_chunk_plain,
                         lambda tt, a: dfa_work(tt, a[0], a[1], a[-1])),
        "prefilter": (pf_ops, "fused_prefilter_fields",
                      pf_ops.prefilter_scan_fields_plain,
                      lambda tt, a: pf_fields_work(tt, *a)),
    }


def call_tables(plan, key):
    """A captured call's tables: one table, or a list for the grouped
    prefilter call (one key per field)."""
    if isinstance(key, list):
        return [plan.np_tables[k] for k in key]
    return plan.np_tables[key]


def capture_main_path(plan, lists, reqs, dev):
    """Serve `reqs` once on the main path with every kernel's launcher
    wrapped; returns {kernel: its calls' inputs, by table key (a list of
    keys for a grouped call)} and {kernel: its own launch count over that
    pass}."""
    from pingoo_tpu_torch.engine.service import VerdictService

    keys = {id(t): k for k, t in plan.np_tables.items()}
    calls = {name: [] for name in launchers()}

    def copy(a):
        if isinstance(a, list):
            return [copy(x) for x in a]
        return a.clone() if hasattr(a, "clone") else a

    def wrap(name, real):
        def wrapped(tables, *args, **kwargs):
            key = [keys[id(t)] for t in tables] \
                if isinstance(tables, list) else keys[id(tables)]
            calls[name].append(dict(key=key, args=copy(args),
                                    kwargs=kwargs))
            return real(tables, *args, **kwargs)
        return wrapped

    os.environ["PINGOO_DFA"], os.environ["PINGOO_PREFILTER"] = MODES[0]
    reals = {name: getattr(mod, attr)
             for name, (mod, attr, _, _) in launchers().items()}
    before = {name: mod.KERNEL.launches
              for name, (mod, _, _, _) in launchers().items()}
    for name, (mod, attr, _, _) in launchers().items():
        setattr(mod, attr, wrap(name, reals[name]))
    try:
        asyncio.run(serve(VerdictService(plan, lists, max_batch=B,
                                         device=dev), reqs))
    finally:
        for name, (mod, attr, _, _) in launchers().items():
            setattr(mod, attr, reals[name])
        os.environ.pop("PINGOO_DFA")
        os.environ.pop("PINGOO_PREFILTER")
    return calls, {name: mod.KERNEL.launches - before[name]
                   for name, (mod, _, _, _) in launchers().items()}


def flat(outs):
    """A kernel's outputs (a tensor, or a tuple or list of them per call)
    as one list of tensors."""
    return [t for o in outs
            for t in (o if isinstance(o, (tuple, list)) else (o,))]


def call_shape(plan, c) -> str:
    data = c["args"][0]
    if isinstance(c["key"], list):
        return "+".join(c["key"]) + f":{data[0].shape[0]}x" \
            + "/".join(str(d.shape[1]) for d in data)
    return f"{c['key']}:{data.shape[0]}x{data.shape[1]}"


def main_path_phase(plan, name, calls, n_launched) -> dict:
    """Replay one kernel's captured main-path calls through the kernel
    and the plain version (bit equality), time the whole replay (issued
    by the host, and queued on the card) and give the work's bound and,
    for the DFA, its chain floor; `n_launched` is the kernel's launch
    count over the captured pass."""
    import numpy as np

    mod, attr, plain, work_fn = launchers()[name]
    fused = getattr(mod, attr)
    if not n_launched or not calls:
        fail(f"the main path launched no {name} kernel to capture")

    def replay(fn):
        return [fn(call_tables(plan, c["key"]), *c["args"], **c["kwargs"])
                for c in calls]

    err = max_abs_err(zip(flat(replay(fused)), flat(replay(plain))))
    times = cuda_times(lambda: replay(fused), 40)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    reps = max(8, QUEUED_CALLS // len(calls))
    dev_ms = queued_ms(lambda: replay(fused), reps)
    work = add_work(work_fn(call_tables(plan, c["key"]), c["args"])
                    for c in calls)
    bound = bound_ms(work)[0]
    shapes = [call_shape(plan, c) for c in calls]
    floor = f", chain floor {chain_floor_ms(work) * 1e3:.1f} us" \
        if "chain" in work else ""
    print(f"{name} main path: {len(calls)} calls, {n_launched} launches "
          f"{' '.join(shapes)}, max_abs_err {err}; replay {med * 1e3:.1f} us "
          f"(quartiles {q1 * 1e3:.1f}-{q3 * 1e3:.1f}), queued on the card "
          f"{dev_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us{floor}",
          flush=True)
    return dict(main_path_launches=n_launched, main_path_shapes=shapes,
                main_path_us=med * 1e3, main_path_us_q1=q1 * 1e3,
                main_path_us_q3=q3 * 1e3, main_path_device_us=dev_ms * 1e3,
                max_abs_err=err)


def stage_a_inputs(plan, reqs, dev):
    """One main-path batch's Stage-A inputs: the first B requests encoded
    and bucketed as the service does, on the card; returns (field names,
    tables, data, lengths)."""
    from pingoo_tpu_torch.engine.batch import (batch_tensors, bucket_arrays,
                                               encode_requests)

    arrays = batch_tensors(bucket_arrays(encode_requests(
        reqs[:B], plan.field_specs).arrays), dev)
    names = list(plan.prefilter.fields)
    return (names, [plan.np_tables[plan.prefilter.fields[f].table_key]
                    for f in names],
            [arrays[f"{f}_bytes"] for f in names],
            [arrays[f"{f}_len"] for f in names])


def device_kernels(fns: dict) -> dict:
    """{label: {device kernel name: launches}} of one run of each `fn`,
    all in one torch.profiler session (a second session in one process
    can record no device events), each run under its own annotation; a
    kernel counts for the annotated range its start falls in."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in fns.items():
            with record_function(f"run:{label}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda
               and not e.name.startswith("run:")]
    out = {}
    for e in events:
        if not e.name.startswith("run:") or e.device_type == cuda:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        counts = {}
        for k in kernels:
            if lo <= k.time_range.start < hi:
                counts[k.name] = counts.get(k.name, 0) + 1
        out[e.name[4:]] = counts
    return out


def stage_a_phase(pf_ops, plan, reqs, dev, grouped: bool = True) -> dict:
    """One batch's whole Stage A (fresh state, scan and hits for every
    field), timed issued (median of 40) and queued on the card: as one
    `prefilter_scan` call per field (how earlier trees' verdict issued
    Stage A) and, with `grouped`, as one `prefilter_scan_fields` call (how
    the verdict issues it now). Lists the device kernels each runs."""
    names, tabs, datas, lenss = stage_a_inputs(plan, reqs, dev)
    runs = {"per_field": lambda: [pf_ops.prefilter_scan(t, d, n)
                                  for t, d, n in zip(tabs, datas, lenss)]}
    if grouped:
        runs["grouped"] = lambda: pf_ops.prefilter_scan_fields(tabs, datas,
                                                               lenss)
    out = {}
    by_run = device_kernels(runs)
    for label, fn in runs.items():
        kernels = by_run[label]
        n = sum(kernels.values())
        issued = cuda_ms(fn, 40)
        # At most QUEUED_CALLS launches queued behind the sleep.
        queued = queued_ms(fn, max(4, QUEUED_CALLS // max(n, 1)))
        out[label] = dict(issued_us=issued * 1e3, queued_us=queued * 1e3,
                          device_kernels=n)
        print(f"stage A ({label}, {'+'.join(names)} "
              f"{datas[0].shape[0]}x{'/'.join(str(d.shape[1]) for d in datas)}"
              f"): {issued * 1e3:.1f} us issued, {queued * 1e3:.1f} us "
              f"queued; device kernels {kernels}", flush=True)
    if grouped:
        k = out["grouped"]["device_kernels"]
        if k != 1:
            fail(f"the grouped Stage A ran {k} device kernels, not 1")
    return out


async def serve(service, reqs):
    await service.start()
    try:
        t0 = time.monotonic()
        verdicts = await asyncio.gather(*(service.evaluate(r) for r in reqs))
        wall = time.monotonic() - t0
    finally:
        await service.stop()
    return verdicts, wall


def device_time_us(prof) -> dict:
    """{device kernel name: device time in µs} of a torch.profiler run."""
    import torch

    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + t_us
    return kernels


def profile_main_path(plan, lists, reqs, dev) -> None:
    """One more main-path run under torch.profiler: the device's busy
    share of the wall time and the device time by kernel name (printed
    as "not measured" when the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pingoo_tpu_torch.engine.service import VerdictService

    service = VerdictService(plan, lists, max_batch=B, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = asyncio.run(serve(service, reqs))
        torch.cuda.synchronize()
    kernels = device_time_us(prof)
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms <= 0:
        print("profile: device time not measured (the profiler recorded "
              "no device kernels)", flush=True)
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile (main path, {N_REQUESTS} requests): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / (wall * 1e3):.2f}% busy); by kernel (ms): "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f}" for k, v in top),
          flush=True)


def slice_phase(plan, rules, lists, reqs, dev):
    """Serve the traffic in every mode; returns the main path's launch
    counts, the interpreter oracle's rows and the main path's (matched,
    actions, verified_block)."""
    import numpy as np

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine.batch import (RequestBatch, bucket_arrays,
                                               encode_requests,
                                               tuple_to_context)
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.engine.verdict import (action_lanes, finish_batch,
                                                 interpret_rules_row,
                                                 make_verdict_fn)
    from pingoo_tpu_torch.ops import _build

    t0 = time.monotonic()
    oracle = np.stack([interpret_rules_row(plan, tuple_to_context(r, lists))
                       for r in reqs])
    o_act, o_vb = action_lanes(plan, oracle)
    print(f"oracle: {N_REQUESTS} requests interpreted in "
          f"{time.monotonic() - t0:.1f} s, {int(oracle.sum())} matches, "
          f"{int((o_act != 0).sum())} acted", flush=True)
    cpu_plan = compile_ruleset(rules, lists, device="cpu")
    cpu_fn = make_verdict_fn(cpu_plan)
    main_counts = None
    for dfa_mode, pf_mode in MODES:
        os.environ["PINGOO_DFA"] = dfa_mode
        os.environ["PINGOO_PREFILTER"] = pf_mode
        label = f"PINGOO_DFA={dfa_mode} PINGOO_PREFILTER={pf_mode}"
        # A warm-up pass over the same batches (each new field width
        # costs a first call) outside the timings, then a fresh service.
        warm = VerdictService(plan, lists, max_batch=B, device=dev)
        for lo in range(0, N_REQUESTS, B):
            warm.evaluate_batch(reqs[lo:lo + B])
        service = VerdictService(plan, lists, max_batch=B, device=dev)
        _build.reset_launch_counts()
        verdicts, wall = asyncio.run(serve(service, reqs))
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        if (dfa_mode, pf_mode) == ("auto", "banks"):
            main_counts = counts
        matched = np.stack([v.matched for v in verdicts])
        act = np.array([v.action for v in verdicts])
        vb = np.array([v.verified_block for v in verdicts])
        if (dfa_mode, pf_mode) == ("auto", "banks"):
            main = (matched, act, vb)
        # The port's CPU path on the same batches.
        cpu = []
        for lo in range(0, N_REQUESTS, B):
            chunk = reqs[lo:lo + B]
            arrays = bucket_arrays(
                encode_requests(chunk, cpu_plan.field_specs).arrays)
            cpu.append(finish_batch(
                cpu_plan, cpu_fn(cpu_plan.np_tables, arrays),
                RequestBatch(size=len(chunk), arrays=arrays), lists))
        cpu = np.concatenate(cpu)
        bad = int((matched != oracle).any(axis=1).sum())
        bad_cpu = int((cpu != oracle).any(axis=1).sum())
        if bad or bad_cpu or (act != o_act).any() or (vb != o_vb).any():
            fail(f"{label}: {bad} rows differ from the oracle on the card, "
                 f"{bad_cpu} on the CPU path; actions differ "
                 f"{int((act != o_act).sum())}, verified_block "
                 f"{int((vb != o_vb).sum())}")
        ms = np.array(list(service.stats.batch))
        stages = ", ".join(f"{k} {v.percentile(50):.2f}"
                           for k, v in service.stats.stages.items())
        print(f"{label}: {N_REQUESTS} verdicts equal the oracle and the CPU "
              f"path; {N_REQUESTS / wall:.0f} req/s, batch p50 "
              f"{np.percentile(ms, 50):.2f} ms p99 "
              f"{np.percentile(ms, 99):.2f} ms over {len(ms)} batches "
              f"(p50 ms: {stages}); launches {counts}", flush=True)
    os.environ["PINGOO_DFA"], os.environ["PINGOO_PREFILTER"] = MODES[0]
    profile_main_path(plan, lists, reqs, dev)
    os.environ.pop("PINGOO_DFA")
    os.environ.pop("PINGOO_PREFILTER")
    missing = [k for k in ("nfa_scan", "bitsplit_dfa", "prefilter")
               if main_counts.get(k, 0) == 0]
    if missing:
        fail(f"the main path launched no {missing} kernel")
    return main_counts, oracle, main


EXPLAIN_REQUESTS = 64


def config_phase(rules, lists, reqs, oracle, main, dev) -> dict:
    """Boot the port from a deployment, as a server does: the corpus
    written as pingoo.yml's mapping with its lists as CSV files and two
    services with `route:` predicates; parse (load_and_validate where
    PyYAML imports, else parse_config on the same mapping), load_lists,
    compile_ruleset(routes=) on the card, then the same stream through
    VerdictService (auto, banks) and `explain` on EXPLAIN_REQUESTS of
    it. Every rule column and both lanes must equal the plan built
    straight from the corpus and the oracle, each route column
    match_route in the interpreter, every explain the interpreter's
    rows and tuple_digest, and stats.snapshot() the batches and
    requests served. Returns the phase's launches per kernel."""
    import tempfile

    import numpy as np

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config import load_and_validate, parse_config
    from pingoo_tpu_torch.engine.batch import tuple_to_context
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.engine.verdict import interpret_rules_row
    from pingoo_tpu_torch.host.services import match_route
    from pingoo_tpu_torch.lists import load_lists
    from pingoo_tpu_torch.obs.trace import tuple_digest
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import deployment

    with tempfile.TemporaryDirectory() as tmp:
        raw = deployment(rules, lists, tmp)
        t0 = time.monotonic()
        try:
            import yaml
        except ImportError:
            how = "parse_config (PyYAML is not installed)"
            config = parse_config(raw)
        else:
            how = "load_and_validate (pingoo.yml written with PyYAML)"
            path = os.path.join(tmp, "pingoo.yml")
            with open(path, "w") as f:
                yaml.safe_dump(raw, f, sort_keys=False)
            config = load_and_validate(path)
        t1 = time.monotonic()
        loaded = load_lists(config.lists)
        t2 = time.monotonic()
    print(f"config: {how}: {len(config.rules)} rules, "
          f"{len(config.services)} services, lists "
          f"{ {k: len(v) for k, v in loaded.items()} }", flush=True)
    if [(r.name, r.expression.source) for r in config.rules] != \
            [(r.name, r.expression.source) for r in rules]:
        fail("the deployment's rules are not the corpus's")
    routes = [(svc.name, svc.route) for svc in config.services]
    plan = compile_ruleset(config.rules, loaded, routes=routes, device=dev)
    t3 = time.monotonic()
    print(f"config: parse {t1 - t0:.2f} s, load_lists {t2 - t1:.2f} s, "
          f"compile_ruleset(routes={[n for n, _ in routes]}) on {dev} "
          f"{t3 - t2:.2f} s", flush=True)

    os.environ["PINGOO_DFA"], os.environ["PINGOO_PREFILTER"] = MODES[0]
    service = VerdictService(plan, loaded, max_batch=B, device=dev)
    served = {"batches": 0, "requests": 0}
    evaluate_batch = service.evaluate_batch

    def counted(batch):
        served["batches"] += 1
        served["requests"] += len(batch)
        return evaluate_batch(batch)

    service.evaluate_batch = counted
    contexts = [tuple_to_context(r, loaded) for r in reqs]
    _build.reset_launch_counts()
    verdicts, wall = asyncio.run(serve(service, reqs))
    R = len(rules)
    matched = np.stack([v.matched for v in verdicts])
    act = np.array([v.action for v in verdicts])
    vb = np.array([v.verified_block for v in verdicts])
    # The main path's lanes equal the oracle's (slice_phase holds them).
    d_matched, d_act, d_vb = main
    bad = int((matched[:, :R] != d_matched).any(axis=1).sum())
    bad_oracle = int((matched[:, :R] != oracle).any(axis=1).sum())
    if bad or bad_oracle or (act != d_act).any() or (vb != d_vb).any():
        fail(f"config: {bad} rows differ from the plan built straight from "
             f"the corpus, {bad_oracle} from the oracle; actions differ "
             f"{int((act != d_act).sum())}, verified_block "
             f"{int((vb != d_vb).sum())}")
    for svc in config.services:
        col = plan.route_index[svc.name]
        want = np.array([match_route(svc.route, c) for c in contexts])
        if (matched[:, col] != want).any():
            fail(f"config: route {svc.name!r} differs from match_route on "
                 f"{int((matched[:, col] != want).sum())} requests")
        print(f"config: route {svc.name!r} column {col} matches "
              f"{int(want.sum())} of {len(reqs)} requests, as match_route "
              f"does", flush=True)
    batch_ms = np.array(list(service.stats.batch))

    # explain: list hits, attacks and clean requests, one a batch.
    names = {r.name: r.index for r in plan.rules}
    list_cols = [i for n, i in names.items() if n.startswith("list_")]
    hit = oracle.any(axis=1)
    picks = list(dict.fromkeys(
        [*np.nonzero(oracle[:, list_cols].any(axis=1))[0][:16],
         *np.nonzero(hit)[0][:24], *np.nonzero(~hit)[0][:24]]))
    for i in range(len(reqs)):
        if len(picks) >= EXPLAIN_REQUESTS:
            break
        if i not in picks:
            picks.append(i)
    picks = picks[:EXPLAIN_REQUESTS]

    async def explain_all():
        await service.start()
        try:
            out = []
            for i in picks:
                te = time.monotonic()
                out.append((await service.explain(reqs[i]),
                            (time.monotonic() - te) * 1e3))
            return out
        finally:
            await service.stop()

    explained = asyncio.run(explain_all())
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    os.environ.pop("PINGOO_DFA")
    os.environ.pop("PINGOO_PREFILTER")
    for i, (e, _) in zip(picks, explained):
        r = reqs[i]
        row = interpret_rules_row(plan, contexts[i])
        want_rules = [rule.name for rule in plan.rules if row[rule.index]]
        digest = tuple_digest(r.method, r.host, r.path, r.url,
                              r.user_agent, r.ip)
        if not e["parity"]["consistent"] or e["matched_rules"] != \
                want_rules or e["digest"] != digest or \
                e["action"] != int(act[i]):
            fail(f"config: explain of request {i} disagrees with the "
                 f"interpreter: {e['parity']}, {e['matched_rules']} != "
                 f"{want_rules}, digest {e['digest']} != {digest}")
    snap = service.stats.snapshot()
    if (snap["batches"], snap["requests"]) != (served["batches"],
                                               served["requests"]):
        fail(f"config: stats.snapshot() counts {snap['batches']} batches "
             f"and {snap['requests']} requests, the service served "
             f"{served['batches']} and {served['requests']}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the config phase launched no {missing} kernel")
    ex_ms = np.array([ms for _, ms in explained])
    kinds = (int(oracle[picks][:, list_cols].any(axis=1).sum()),
             int(hit[picks].sum()), int((~hit[picks]).sum()))
    print(f"config: {len(reqs)} verdicts of the deployment's plan equal the "
          f"plan built from the corpus and the oracle; "
          f"{len(reqs) / wall:.0f} req/s, batch p50 "
          f"{np.percentile(batch_ms, 50):.2f} ms over {len(batch_ms)} "
          f"batches", flush=True)
    print(f"config: {len(picks)} explain() calls ({kinds[0]} list hits, "
          f"{kinds[1]} matching a rule, {kinds[2]} clean) consistent with "
          f"the interpreter; explain ms p50 "
          f"{np.percentile(ex_ms, 50):.2f} p99 {np.percentile(ex_ms, 99):.2f}"
          f"; stats.snapshot() {snap['batches']} batches, "
          f"{snap['requests']} requests; pipeline_snapshot() "
          f"{service.pipeline_snapshot()['batches']}; launches {launches}",
          flush=True)
    return launches


def stage_a_of(tree: str) -> int:
    """Time one batch's Stage A as the port in `tree` issues it (one
    `prefilter_scan` call per field, and the grouped call where that tree
    has it), to set an earlier tree's Stage A beside this one's in one
    chip call. Prints no result line."""
    import torch

    sys.path.insert(0, tree)
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.ops import prefilter as pf_ops
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    print(f"{card_line()}; Stage A of the port in {tree}", flush=True)
    dev = torch.device("cuda")
    rules, lists = generate_ruleset(500)
    plan = compile_ruleset(rules, lists, device=dev)
    reqs = generate_traffic(B, attack_fraction=0.3, seed=SEED, lists=lists)
    out = stage_a_phase(pf_ops, plan, reqs, dev,
                        grouped=hasattr(pf_ops, "prefilter_scan_fields"))
    print(json.dumps({"stage_a": out}), flush=True)
    return 0


def stage_a_child() -> dict:
    """This tree's Stage A, timed by `--stage-a-of` in a process of its
    own: in this process, torch.profiler sessions opened after the
    main-path profile recorded no device kernels on the H100, and ones
    opened before the slice phase may slow the host's issue of the modes
    it serves."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--stage-a-of", REPO],
        capture_output=True, text=True, timeout=900)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the Stage-A phase exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["stage_a"]


def ring_producer(path: str) -> int:
    """The data plane's side, in a process of its own as the httpd is:
    attach the ring at `path`; for each line "seed requests every" read
    from stdin, drive generate_traffic(requests, seed) of the ring
    phase's set-up through the ring, every `every`-th request with a body
    of `body_ring_bodies` (none when 0), and write the drive as one JSON
    line. Ends at the end of stdin."""
    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    _, lists = generate_ruleset(500, with_lists=True, list_sizes=(4096, 512))
    ring = nr.Ring(path, capacity=RING_CAPACITY)
    try:
        for line in sys.stdin:
            seed, n, every = map(int, line.split())
            reqs = generate_traffic(n, lists=lists, seed=seed)
            r = nr.drive_stream(ring, nr.pack_requests(reqs),
                                body_ring_bodies(n) if every else None)
            print(json.dumps(dict(
                seconds=r.seconds, actions=r.actions.hex(),
                waits_ms=r.waits_ms,
                max_heartbeat_age_ms=r.max_heartbeat_age_ms,
                meta_actions=r.meta_actions.hex(),
                body_actions=sorted(r.body_actions.items()))), flush=True)
    finally:
        ring.close()
    return 0


class ChildProducer:
    """`ring_producer` in a child process; `drive(seed)` runs one drive
    there and returns its DriveResult."""

    def __init__(self, path: str):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ring-producer",
             path], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def drive(self, seed: int, n: int = RING_REQUESTS, every: int = 0):
        from pingoo_tpu_torch import native_ring as nr

        self.proc.stdin.write(f"{seed} {n} {every}\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            self.proc.kill()
            fail(f"the ring producer exited {self.proc.wait()}: "
                 f"{self.proc.stderr.read()[-3000:]}")
        d = json.loads(line)
        return nr.DriveResult(seconds=d["seconds"],
                              actions=bytes.fromhex(d["actions"]),
                              waits_ms=d["waits_ms"],
                              max_heartbeat_age_ms=d["max_heartbeat_age_ms"],
                              meta_actions=bytes.fromhex(d["meta_actions"]),
                              body_actions=dict(d["body_actions"]))

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        if rc != 0:
            fail(f"the ring producer exited {rc}: "
                 f"{self.proc.stderr.read()[-3000:]}")


def ring_drive(sidecar, drive, want: bytes, profiled: bool = False) -> dict:
    """Run `drive()` (-> DriveResult) with the kernels' launch counts set
    to 0 just before and read just after; hold the verdicts to the
    checksum, to `want` (byte for byte, in stream order) and the
    heartbeat's age to the data plane's limit. Returns the drive's
    numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pingoo_tpu_torch.ops import _build

    b0 = sidecar.batches
    s0 = {k: v.count for k, v in sidecar.stage_ms.items()}
    _build.reset_launch_counts()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = drive()
            torch.cuda.synchronize()
    else:
        r = drive()
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    batches = sidecar.batches - b0
    if r.checksum != RING_CHECKSUM:
        fail(f"ring drive checksum {r.checksum}, not {RING_CHECKSUM}")
    if r.actions != want:
        bad = sum(a != b for a, b in zip(r.actions, want))
        fail(f"{bad} ring verdict bytes differ from VerdictService's")
    if r.max_heartbeat_age_ms >= HEARTBEAT_LIMIT_MS:
        fail(f"the heartbeat aged {r.max_heartbeat_age_ms} ms during a "
             f"drive (the data plane fails open at {HEARTBEAT_LIMIT_MS})")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the ring drive launched no {missing} kernel")
    waits = np.array(r.waits_ms)
    out = dict(
        req_per_s=len(want) / r.seconds, seconds=r.seconds,
        wait_p50_ms=float(np.percentile(waits, 50)),
        wait_p99_ms=float(np.percentile(waits, 99)), batches=batches,
        rows_per_batch=len(want) / batches,
        stage_p50_ms={k: float(np.percentile(v.since(s0[k]), 50))
                      for k, v in sidecar.stage_ms.items()},
        max_heartbeat_age_ms=r.max_heartbeat_age_ms, checksum=r.checksum,
        launches=launches,
        launches_per_batch={k: n / batches for k, n in launches.items()})
    if profiled:
        busy_ms = sum(device_time_us(prof).values()) / 1e3
        out["device_busy_ms"] = busy_ms if busy_ms > 0 else "not measured"
        out["device_busy_pct"] = 100 * busy_ms / (r.seconds * 1e3) \
            if busy_ms > 0 else "not measured"
    return out


def ring_phase() -> int:
    """The native plane on the card: the ring library built from the
    port's copy, the 500-rule plan with its lists, a ring of
    RING_CAPACITY slots and `RingSidecar(max_batch=B)` in a thread. The
    producer runs in a child process, as the httpd does: a warm stream
    (`generate_traffic(seed=12)`), then the measured stream (seed=11)
    twice, the second under torch.profiler. Each measured drive must
    give the JAX package's checksum, VerdictService's verdict on the card
    for every request, a heartbeat younger than the data plane's limit, and
    launches of all three kernels. Prints one JSON line {"ring": ...},
    but no result line (it runs in a process of its own, so its profiler
    session is the process's first)."""
    import tempfile
    import threading

    import torch

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    dev = torch.device("cuda")
    build_s = nr.build_ring_lib()
    print(f"ring library {nr.ring_lib_path().name}: built in {build_s:.2f} s",
          flush=True)
    rules, lists = generate_ruleset(500, with_lists=True,
                                    list_sizes=(4096, 512))
    plan = compile_ruleset(rules, lists, device=dev)
    reqs = generate_traffic(RING_REQUESTS, lists=lists, seed=11)
    service = VerdictService(plan, lists, max_batch=B, device=dev)
    want = bytes(v.action | (v.verified_block << 2)
                 for lo in range(0, RING_REQUESTS, B)
                 for v in service.evaluate_batch(reqs[lo:lo + B]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring")
        ring = nr.Ring(path, capacity=RING_CAPACITY, create=True)
        try:
            sidecar = nr.RingSidecar(ring, plan, lists, max_batch=B,
                                     device=dev)
            thread = threading.Thread(target=sidecar.run, daemon=True)
            thread.start()
            producer = ChildProducer(path)
            try:
                t0 = time.monotonic()
                producer.drive(12)
                warm_s = time.monotonic() - t0
                drives = [ring_drive(sidecar, lambda: producer.drive(11),
                                     want, profiled)
                          for profiled in (False, True)]
                producer.close()
                time.sleep(0.2)
                if ring.poll_verdict() is not None:
                    fail("a verdict arrived after every request had its own")
            finally:
                if producer.proc.poll() is None:
                    producer.proc.kill()
                    producer.proc.wait()
                sidecar.stop()
                thread.join(timeout=30)
            if thread.is_alive():
                fail("the sidecar's drain loop did not stop")
        finally:
            ring.close()
    for label, d in zip(("measured", "profiled"), drives):
        print(f"ring drive ({label}): {RING_REQUESTS} requests, checksum "
              f"{d['checksum']}, {d['req_per_s']:.0f} req/s, wait p50 "
              f"{d['wait_p50_ms']:.2f} ms p99 {d['wait_p99_ms']:.2f} ms, "
              f"{d['batches']} batches of {d['rows_per_batch']:.1f} rows, "
              f"stage p50 ms {d['stage_p50_ms']}, heartbeat age max "
              f"{d['max_heartbeat_age_ms']} ms, launches {d['launches']}"
              + (f", device busy {d['device_busy_ms']} ms = "
                 f"{d['device_busy_pct']}% of the wall" if "device_busy_pct"
                 in d else ""), flush=True)
    print(json.dumps({"ring": dict(
        requests=RING_REQUESTS, max_batch=B, capacity=RING_CAPACITY,
        rules=500, build_s=build_s, warm_s=warm_s,
        processed=sidecar.processed, drives=drives)}), flush=True)
    return 0


def ring_child() -> dict:
    """`ring_phase` in a process of its own; returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--ring-phase"],
        capture_output=True, text=True, timeout=600)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the ring phase exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print(f"ring phase: {time.monotonic() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["ring"]


# -- the body phase: streaming body inspection (engine/bodyscan.py) ----------

# bench.py's body stream at the scanner's default table size: 1,024 flows
# (PINGOO_BODY_MAX_FLOWS), bodies of 256 to 3 windows of bytes over a
# filler alphabet free of rule bytes, one flow in three with a planted
# payload at a random offset, windows of 4,096 bytes.
BODY_FLOWS = 1024
BODY_WINDOW = 4096
BODY_SEED = 1306
BODY_ALPHABET = b"abcdefghijklmnop0123456789=&"
# Streamed passes timed per configuration (MB/s: their median).
BODY_TIMED_PASSES = 3
# A body reaches 16 MiB (the listener's PINGOO_MAX_BODY_BYTES default):
# each kernel's captured calls are also replayed with their offsets and
# lengths moved this far on, kernel against plain version.
BODY_FAR_OFFSET = 16 << 20
# (rule set, PINGOO_BODY_SCAN, PINGOO_BODY_LAZY) and the kernels each runs.
BODY_CONFIGS = (
    ("seed", "auto", "auto", ("prefilter", "bitsplit_dfa")),
    ("seed", "nfa", "auto", ("prefilter", "nfa_scan")),
    ("seed", "nfa", "off", ("prefilter", "nfa_scan")),
    ("crs", "auto", "auto", ("prefilter", "nfa_scan")),
)
# crc32 of the streamed action bytes in flow order: the JAX package's
# BodyScanner on the same stream, on the CPU. tests/test_torch_body_pins.py
# recomputes both pins below with the JAX package.
BODY_CHECKSUMS = {"seed": 2834130049, "crs": 2713547712}
# The native plane with bodies: generate_traffic(4096, seed=13) of the
# ring phase's set-up, every fourth request with the next body of the
# seed set's stream (1,024 flows); crc32 of the merged verdict bytes of
# the JAX package's sidecar (PINGOO_BODY_INSPECT=on) on this drive, on
# the CPU.
BODY_RING_REQUESTS = 4096
BODY_RING_SEED = 13
BODY_RING_EVERY = 4
BODY_RING_CHECKSUM = 2340204361


def body_rules(mod, name: str):
    """A body rule set of `mod` (a bodyscan module): "seed", the default
    six literals, or "crs", utils/crs.py's payload cores as 53 regex rules
    (every fourth a captcha)."""
    from pingoo_tpu_torch.utils.crs import LFI_RCE_CORES, SQLI_CORES, XSS_CORES

    if name == "seed":
        return mod.DEFAULT_BODY_RULES
    return tuple(mod.BodyRule(f"crs-{i}", p, "regex", False,
                              ("captcha",) if i % 4 == 3 else ("block",))
                 for i, p in enumerate(SQLI_CORES + XSS_CORES
                                       + LFI_RCE_CORES))


def body_payloads(name: str, n: int | None = None) -> list[bytes]:
    """bench.py's body stream (`bench_body`, seed 1306): n bodies of 256 to
    3 x BODY_WINDOW filler bytes; every third one gets a payload planted at
    a random offset, each of the seed set's literals in turn or, for
    "crs", each of utils/crs.py's ATTACK_URLS."""
    from pingoo_tpu_torch.engine.bodyscan import DEFAULT_BODY_RULES
    from pingoo_tpu_torch.utils.crs import ATTACK_URLS

    plants = [r.pattern.encode() for r in DEFAULT_BODY_RULES] \
        if name == "seed" else [u.encode() for u in ATTACK_URLS]
    rng = random.Random(BODY_SEED)
    payloads = []
    for i in range(BODY_FLOWS if n is None else n):
        body = bytes(rng.choices(BODY_ALPHABET,
                                 k=rng.randint(256, 3 * BODY_WINDOW)))
        # bench.py plants lits[i % 6], which reaches 2 of the 6 literals.
        if i % 3 == 0:
            at = rng.randint(0, len(body))
            body = body[:at] + plants[i // 3 % len(plants)] + body[at:]
        payloads.append(body)
    return payloads


def body_rounds(mod, payloads) -> list[list]:
    """The flows' windows of BODY_WINDOW bytes interleaved round-robin
    (bench.py's arrival order): round r holds window r of every flow that
    has one."""
    per_flow = []
    for fid, payload in enumerate(payloads):
        parts = mod.split_payload(payload, BODY_WINDOW)
        per_flow.append([mod.BodyWindow(fid, s, d, final=s == len(parts) - 1)
                         for s, d in enumerate(parts)])
    return [[w[r] for w in per_flow if len(w) > r]
            for r in range(max(map(len, per_flow)))]


def body_ring_bodies(n: int) -> list:
    """One entry for each of `n` requests of the body ring drive: every
    BODY_RING_EVERY-th request gets the next seed-set body, the rest
    None."""
    payloads = body_payloads("seed", -(-n // BODY_RING_EVERY))
    return [payloads[k // BODY_RING_EVERY] if k % BODY_RING_EVERY == 0
            else None for k in range(n)]


def stream_pass(scanner, rounds) -> dict:
    """Every round through `scanner`: {flow: its verdict}."""
    out = {}
    for rnd in rounds:
        for v in scanner.scan_windows(rnd):
            out[v.flow_id] = v
    return out


def body_launchers():
    """Each kernel's chunk launcher on the body path: module, launcher
    name (looked up at call time), plain version, work of a call."""
    from pingoo_tpu_torch.ops import bitsplit_dfa as dfa_ops
    from pingoo_tpu_torch.ops import nfa_scan
    from pingoo_tpu_torch.ops import prefilter as pf_ops

    return {
        "nfa_scan": (nfa_scan, "fused_scan_chunk", nfa_scan.scan_chunk_plain,
                     nfa_work),
        "bitsplit_dfa": (dfa_ops, "fused_dfa_chunk",
                         dfa_ops.dfa_scan_chunk_plain, dfa_work),
        "prefilter": (pf_ops, "fused_prefilter_chunk",
                      pf_ops.prefilter_scan_chunk_plain, pf_work),
    }


def capture_body(fn) -> dict:
    """Run `fn()` with every body-path launcher wrapped; returns {kernel:
    [(tables, inputs cloned)]}."""
    calls = {name: [] for name in body_launchers()}
    reals = {name: getattr(mod, attr)
             for name, (mod, attr, _, _) in body_launchers().items()}

    def wrap(name, real):
        def wrapped(tables, *args, **kwargs):  # `pair` changes no bits
            calls[name].append((tables, [a.clone() for a in args]))
            return real(tables, *args, **kwargs)
        return wrapped

    for name, (mod, attr, _, _) in body_launchers().items():
        setattr(mod, attr, wrap(name, reals[name]))
    try:
        fn()
    finally:
        for name, (mod, attr, _, _) in body_launchers().items():
            setattr(mod, attr, reals[name])
    return calls


def body_replay(name: str, calls, far: bool = False) -> dict:
    """Replay one kernel's captured body-path calls through the kernel
    and the plain version (every call's rows at once, per table and
    width: rows are independent), bit for bit, and with `far` those rows
    once more at BODY_FAR_OFFSET further on; time the kernel's replay
    queued on the card, per launch, beside its bound per launch."""
    import torch

    mod, attr, plain, work_fn = body_launchers()[name]
    fused = getattr(mod, attr)
    got = [fused(t, *a) for t, a in calls]
    groups: dict = {}
    for j, (t, a) in enumerate(calls):
        groups.setdefault((id(t), a[0].shape[1]), []).append(j)
    err = 0
    for js in groups.values():
        t = calls[js[0]][0]
        args = [torch.cat([calls[j][1][k] for j in js])
                for k in range(len(calls[js[0]][1]))]
        want = plain(t, *args)
        want = want if isinstance(want, tuple) else (want,)
        sizes = [calls[j][1][0].shape[0] for j in js]
        for k, w in enumerate(want):
            for j, part in zip(js, w.split(sizes)):
                g = got[j] if isinstance(got[j], tuple) else (got[j],)
                err = max(err, max_abs_err([(g[k], part)]))
        if far:  # (data, lens, *carries, t_offset): both ends move on
            args[1] = args[1] + BODY_FAR_OFFSET
            args[-1] = args[-1] + BODY_FAR_OFFSET
            err = max(err, max_abs_err(zip(flat([fused(t, *args)]),
                                           flat([plain(t, *args)]))))
    reps = max(8, QUEUED_CALLS // len(calls))
    per_launch_us = queued_ms(lambda: [fused(t, *a) for t, a in calls],
                              reps) * 1e3 / len(calls)
    work = add_work(work_fn(t, a[0], a[1], a[-1]) for t, a in calls)
    bound, by = bound_ms(work)
    shapes = sorted({f"{a[0].shape[0]}x{a[0].shape[1]}" for _, a in calls})
    offs = max(int(a[-1].max()) for _, a in calls)
    return dict(calls=len(calls), shapes=shapes, max_t_offset=offs,
                far_offset=BODY_FAR_OFFSET if far else 0,
                max_abs_err=err, queued_us_per_launch=per_launch_us,
                bound_us_per_launch=bound * 1e3 / len(calls), bound_by=by)


def body_config(bs, plans, name, scan, lazy, want_kernels, dev,
                far_done: set) -> dict:
    """One configuration of the body stream: a captured streamed pass
    (replayed through kernel and plain version), a timed one with the
    launch counts set to 0 just before and read just after, and the
    contiguous scan of each body (`scan_buffered`). Every flow's streamed
    and contiguous verdict must equal `body_lanes_oracle`, none degraded,
    and the streamed action bytes' crc32 the JAX package's."""
    import numpy as np
    import torch

    from pingoo_tpu_torch.ops import _build

    os.environ["PINGOO_BODY_SCAN"], os.environ["PINGOO_BODY_LAZY"] = scan, lazy
    plan, payloads, rounds, oracle = plans[name]
    label = f"{name}/{scan}/lazy={lazy}"
    t_config = time.monotonic()
    calls = capture_body(lambda: stream_pass(bs.BodyScanner(
        plan, device=dev), rounds))
    scanner = bs.BodyScanner(plan, device=dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.monotonic()
    streamed = stream_pass(scanner, rounds)
    pass_s = [time.monotonic() - t0]
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    for _ in range(BODY_TIMED_PASSES - 1):
        t0 = time.monotonic()
        stream_pass(bs.BodyScanner(plan, device=dev), rounds)
        pass_s.append(time.monotonic() - t0)
    stream_s = statistics.median(pass_s)
    contig_scanner = bs.BodyScanner(plan, device=dev)
    t0 = time.monotonic()
    contig = [contig_scanner.scan_buffered(p, fid)
              for fid, p in enumerate(payloads)]
    contig_s = time.monotonic() - t0
    bad = [fid for fid in range(len(payloads))
           if fid not in streamed or streamed[fid].degraded
           or contig[fid].degraded
           or (streamed[fid].unverified, streamed[fid].verified_block)
           != oracle[fid] or (contig[fid].unverified,
                              contig[fid].verified_block) != oracle[fid]]
    if bad:
        fail(f"body {label}: {len(bad)} flows differ from the oracle or the "
             f"contiguous scan, or were degraded (first {bad[:5]})")
    acts = bytes(streamed[fid].action_byte() for fid in range(len(payloads)))
    crc = zlib.crc32(acts)
    if crc != BODY_CHECKSUMS[name]:
        fail(f"body {label}: checksum {crc}, not {BODY_CHECKSUMS[name]}")
    ran = sorted(k for k, n in launches.items() if n)
    if ran != sorted(want_kernels):
        fail(f"body {label}: launched {launches}, not {want_kernels}")
    # Each kernel is also held at far offsets in the first configuration
    # that launches it (the NFA: the lazy one, with warm-up rows).
    replays = {k: body_replay(k, c, far=k not in far_done)
               for k, c in calls.items() if c}
    far_done.update(replays)
    for k, r in replays.items():
        if r["max_abs_err"] != 0:
            fail(f"body {label}: the {k} kernel disagrees with its plain "
                 f"version on a body-path launch")
    total = sum(map(len, payloads))
    stages = {k: v.percentile(50) for k, v in scanner.stage_ms.items()}
    out = dict(mode=scanner.mode, lazy=scanner.lazy, flows=len(payloads),
               bytes=total, rounds=len(rounds), checksum=crc,
               mb_per_s_streamed=total / stream_s / 1e6,
               pass_ms=[t * 1e3 for t in pass_s],
               mb_per_s_contiguous=total / contig_s / 1e6,
               round_p50_ms=stages, launches=launches, kernels=replays,
               lazy_skips=scanner.stats.lazy_skips,
               blocked=sum(a & 3 == 1 for a in acts),
               seconds=time.monotonic() - t_config)
    print(f"body {label} ({out['seconds']:.1f} s): {len(payloads)} flows, "
          f"{total} bytes, checksum "
          f"{crc}; {out['mb_per_s_streamed']:.2f} MB/s streamed (passes "
          f"{', '.join(f'{t * 1e3:.1f}' for t in pass_s)} ms), "
          f"{out['mb_per_s_contiguous']:.2f} MB/s contiguous; round p50 ms "
          f"{ {k: round(v, 3) for k, v in stages.items()} }; launches "
          f"{launches}; "
          + "; ".join(f"{k} {r['calls']} calls {r['shapes']} max t_offset "
                      f"{r['max_t_offset']} (+{r['far_offset']}): "
                      f"{r['queued_us_per_launch']:.1f} "
                      f"us queued per launch (bound "
                      f"{r['bound_us_per_launch']:.2f} us)"
                      for k, r in replays.items()), flush=True)
    return out


def body_busy(bs, plans, dev) -> dict:
    """One more streamed pass of each configuration, all in one
    torch.profiler session (the process's only one): the device's busy
    share of each pass's wall time (the union of the device events that
    start inside its annotated range, so overlapping copies and kernels
    count once), and the device time by event name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, scan, lazy, _ in BODY_CONFIGS:
            os.environ["PINGOO_BODY_SCAN"] = scan
            os.environ["PINGOO_BODY_LAZY"] = lazy
            plan, _, rounds, _ = plans[name]
            with record_function(f"body:{name}/{scan}/lazy={lazy}"):
                stream_pass(bs.BodyScanner(plan, device=dev), rounds)
                torch.cuda.synchronize()
    events = prof.events()
    # The annotations show on the device's timeline too: not device work.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("body:")]
    out = {}
    for e in events:
        if not e.name.startswith("body:"):
            continue
        lo, hi = e.time_range.start, e.time_range.end
        inside = sorted((k.time_range.start, k.time_range.end, k.name)
                        for k in kernels if lo <= k.time_range.start < hi)
        busy, end, by_name = 0.0, lo, {}
        for a, b, name in inside:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name[:48]] = by_name.get(name[:48], 0.0) + (b - a) / 1e3
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
        out[e.name[5:]] = dict(
            wall_ms=(hi - lo) / 1e3, device_ms=busy / 1e3,
            busy_pct=100 * busy / (hi - lo), top_ms=top) if busy \
            else "not measured"
    return out


def body_ring(dev) -> dict:
    """The native plane with PINGOO_BODY_INSPECT=on (the seed set, auto):
    the ring phase's plan and ring, a producer child driving
    generate_traffic(4096, seed=13) with a body on every fourth request.
    Every ticket must be answered once on each lane, the merged bytes'
    crc32 must be the JAX package's, each merged byte
    merge_actions(VerdictService's byte, the body oracle), no flow
    degraded and the heartbeat younger than the data plane's limit."""
    import tempfile
    import threading

    import numpy as np

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine import bodyscan as bs
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    for knob in ("PINGOO_BODY_SCAN", "PINGOO_BODY_LAZY"):
        os.environ.pop(knob, None)
    os.environ["PINGOO_BODY_INSPECT"] = "on"
    rules, lists = generate_ruleset(500, with_lists=True,
                                    list_sizes=(4096, 512))
    plan = compile_ruleset(rules, lists, device=dev)
    reqs = generate_traffic(BODY_RING_REQUESTS, lists=lists,
                            seed=BODY_RING_SEED)
    bodies = body_ring_bodies(BODY_RING_REQUESTS)
    service = VerdictService(plan, lists, max_batch=B, device=dev)
    meta = bytes(v.action | (v.verified_block << 2)
                 for lo in range(0, BODY_RING_REQUESTS, B)
                 for v in service.evaluate_batch(reqs[lo:lo + B]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring")
        ring = nr.Ring(path, capacity=RING_CAPACITY, create=True)
        try:
            sidecar = nr.RingSidecar(ring, plan, lists, max_batch=B,
                                     device=dev)
            body_plan = sidecar.body_scanner.plan
            want = bytearray(meta)
            for k, body in enumerate(bodies):
                if body is not None:
                    unv, vb, _ = bs.body_lanes_oracle(body_plan, body)
                    want[k] = bs.merge_actions(meta[k], unv, vb)
            thread = threading.Thread(target=sidecar.run, daemon=True)
            thread.start()
            producer = ChildProducer(path)
            try:
                producer.drive(12, 1024, BODY_RING_EVERY)  # warm
                d0 = sidecar.stage_ms["body"].count
                v0, b0 = sidecar.body_verdicts, sidecar.batches
                _build.reset_launch_counts()
                r = producer.drive(BODY_RING_SEED, BODY_RING_REQUESTS,
                                   BODY_RING_EVERY)
                launches = {k: v.launches for k, v in _build.KERNELS.items()}
                producer.close()
                time.sleep(0.2)
                if ring.poll_verdict() is not None:
                    fail("a verdict arrived after every request had its own")
            finally:
                if producer.proc.poll() is None:
                    producer.proc.kill()
                    producer.proc.wait()
                sidecar.stop()
                thread.join(timeout=30)
            if thread.is_alive():
                fail("the sidecar's drain loop did not stop")
        finally:
            ring.close()
    os.environ.pop("PINGOO_BODY_INSPECT")
    flows = sum(b is not None for b in bodies)
    if sorted(r.body_actions) != [k for k, b in enumerate(bodies)
                                  if b is not None]:
        fail(f"{len(r.body_actions)} body verdicts for {flows} bodies")
    if r.checksum != BODY_RING_CHECKSUM:
        fail(f"body ring checksum {r.checksum}, not {BODY_RING_CHECKSUM}")
    if r.actions != bytes(want) or r.meta_actions != meta:
        fail(f"{sum(a != b for a, b in zip(r.actions, want))} merged and "
             f"{sum(a != b for a, b in zip(r.meta_actions, meta))} metadata "
             f"verdict bytes differ from VerdictService's and the oracle")
    stats = sidecar.body_scanner.stats
    if stats.degrade_total:
        fail(f"the body drain degraded {stats.degrade_reasons}")
    if r.max_heartbeat_age_ms >= HEARTBEAT_LIMIT_MS:
        fail(f"the heartbeat aged {r.max_heartbeat_age_ms} ms during the "
             f"body drive (the data plane fails open at "
             f"{HEARTBEAT_LIMIT_MS})")
    drains = sidecar.stage_ms["body"].since(d0)
    out = dict(requests=BODY_RING_REQUESTS, flows=flows,
               req_per_s=BODY_RING_REQUESTS / r.seconds, seconds=r.seconds,
               checksum=r.checksum, body_drain_p50_ms=float(
                   np.percentile(drains, 50)), drains=len(drains),
               body_verdicts_per_drain=(sidecar.body_verdicts - v0)
               / len(drains), batches=sidecar.batches - b0,
               max_heartbeat_age_ms=r.max_heartbeat_age_ms,
               wait_p50_ms=float(np.percentile(r.waits_ms, 50)),
               wait_p99_ms=float(np.percentile(r.waits_ms, 99)),
               launches=launches)
    print(f"body ring: {BODY_RING_REQUESTS} requests, {flows} with bodies, "
          f"checksum {r.checksum}; {out['req_per_s']:.0f} req/s, body drain "
          f"p50 {out['body_drain_p50_ms']:.2f} ms over {len(drains)} drains "
          f"({out['body_verdicts_per_drain']:.1f} body verdicts each), "
          f"heartbeat age max {r.max_heartbeat_age_ms} ms, launches "
          f"{launches}", flush=True)
    return out


def body_phase() -> int:
    """The body phase in a process of its own: (a) the scanner over
    bench.py's body stream in the four BODY_CONFIGS, then the device's
    busy share under torch.profiler, and (b) the native plane with body
    inspection on. Prints one JSON line {"body": ...}, but no result
    line."""
    import torch

    from pingoo_tpu_torch.engine import bodyscan as bs
    from pingoo_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.monotonic()
    _build.build()  # run alone, the phase builds the kernels here
    print(f"body phase: set-up {t0 - T_START:.1f} s, build "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    plans = {}
    for name in ("seed", "crs"):
        plan = bs.compile_body_plan(body_rules(bs, name), BODY_WINDOW,
                                    device=dev)
        payloads = body_payloads(name)
        oracle = [bs.body_lanes_oracle(plan, p)[:2] for p in payloads]
        plans[name] = (plan, payloads, body_rounds(bs, payloads), oracle)
        print(f"body plan {name}: {len(plan.rules)} rules, NFA W="
              f"{plan.tables.num_words}, exact DFA "
              f"{plan.dfa_tables is not None}, prefilter "
              f"{plan.pf_tables.num_words} words, lazy_ok {plan.lazy_ok} "
              f"(tail_cap {plan.tail_cap}); {sum(map(len, payloads))} bytes "
              f"in {sum(map(len, plans[name][2]))} windows", flush=True)
    far_done: set = set()
    configs = {f"{n}/{s}/lazy={z}": body_config(bs, plans, n, s, z, k, dev,
                                                far_done)
               for n, s, z, k in BODY_CONFIGS}
    busy = body_busy(bs, plans, dev)
    print(f"body device busy: {busy}", flush=True)
    t_ring = time.monotonic()
    ring = body_ring(dev)
    ring["phase_s"] = time.monotonic() - t_ring
    print(json.dumps({"body": dict(
        window=BODY_WINDOW, configs=configs, busy=busy, ring=ring,
        seconds=time.monotonic() - t0)}), flush=True)
    return 0


def body_child() -> dict:
    """`body_phase` in a process of its own; returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--body-phase"],
        capture_output=True, text=True, timeout=600)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the body phase exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print(f"body phase: {time.monotonic() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["body"]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one card")
    if len(sys.argv) == 3 and sys.argv[1] == "--stage-a-of":
        return stage_a_of(os.path.abspath(sys.argv[2]))
    if not os.path.isdir(os.path.join(REPO, "pingoo_tpu_torch")):
        fail("pingoo_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["--ring-phase"]:
        return ring_phase()
    if sys.argv[1:] == ["--body-phase"]:
        return body_phase()
    if len(sys.argv) == 3 and sys.argv[1] == "--ring-producer":
        return ring_producer(sys.argv[2])
    import numpy as np

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    card = card_line()
    print(card, flush=True)
    t0 = time.monotonic()
    took = _build.build(verbose=True)
    print(f"build: {time.monotonic() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)
    for name, report in _build.ptxas_reports.items():
        parts = []
        for fn, body in re.findall(r"Compiling entry function '(\S+)'"
                                   r"(.*?)(?=Compiling entry|\Z)", report,
                                   re.S):
            # nfa_chunk_kernel<K, P, CARRY, SEG> is named by its arguments.
            t = re.search(r"ILi(\d+)ELi(\d+)ELb([01])ELb([01])E", fn)
            regs = re.search(r"Used (\d+) registers", body)
            spill = max([int(n) for n in
                         re.findall(r"(\d+) bytes spill", body)] or [0])
            label = f"K{t[1]}P{t[2]}c{t[3]}{'S' if t[4] == '1' else ''}:" \
                if t else ""
            # dfa_chunk_kernel<WH, SMEM>: accept words (0: any) and path.
            t = re.search(r"dfa_chunk_kernelILi(\d+)ELb([01])E", fn)
            if t:
                label = f"Wh{t[1]}{'smem' if t[2] == '1' else 'l2'}:"
            # pf_kernel<KMAX>: the most words per lane it serves.
            t = re.search(r"pf_kernelILi(\d+)E", fn)
            if t:
                label = f"Kmax{t[1]}:"
            parts.append(f"{label}{regs[1] if regs else '?'}/{spill}")
        print(f"  ptxas {name}: registers/spill bytes per instantiation "
              f"{' '.join(parts)}", flush=True)

    dev = torch.device("cuda")
    rules, lists = generate_ruleset(500)
    plan = compile_ruleset(rules, lists, device=dev)
    print(f"plan: {plan.stats}", flush=True)
    rng = np.random.default_rng(SEED)
    results = kernel_phase(plan, dev, rng)
    reqs = generate_traffic(N_REQUESTS, attack_fraction=0.3, seed=SEED,
                            lists=lists)
    results["prefilter"]["stage_a"] = stage_a_child()
    ring = ring_child()
    body = body_child()
    counts, oracle, main_path = slice_phase(plan, rules, lists, reqs, dev)
    config_counts = config_phase(rules, lists, reqs, oracle, main_path, dev)
    calls, launched = capture_main_path(plan, lists, reqs, dev)
    batches = -(-N_REQUESTS // B)
    if not len(calls["prefilter"]) == launched["prefilter"] == batches:
        fail(f"the main path's Stage A made {len(calls['prefilter'])} calls "
             f"and {launched['prefilter']} prefilter launches over "
             f"{batches} batches, not one each per batch")
    for name in ("nfa_scan", "bitsplit_dfa", "prefilter"):
        main = main_path_phase(plan, name, calls[name], launched[name])
        if main.pop("max_abs_err") != 0:
            fail(f"the {name} kernel disagrees with its plain version on a "
                 f"captured main-path launch")
        results[name].update(main)
    out = []
    for name in ("nfa_scan", "bitsplit_dfa", "prefilter"):
        r = results[name]
        bound, bound_by = bound_ms(r["work"])
        out.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None,
            "config_launches": config_counts[name],
            "ring_launches": ring["drives"][0]["launches"][name],
            "body_launches": sum(c["launches"][name]
                                 for c in body["configs"].values()),
            **{k: v for k, v in r.items() if k not in (
                "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "work")}})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
