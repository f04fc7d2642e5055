#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pingoo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one CUDA card

1. Prints the card's name and power limit and builds the three CUDA
   kernels from pingoo_tpu_torch/csrc (one nvcc per source, together).
2. Kernel phases: on the real 500-rule plan's tables, at B=2048 and the
   fields' full width (2048 bytes for url/path), with seeded lengths and
   planted attack strings, each kernel is held bit-equal to its plain
   PyTorch version on the card (the NFA at pair and single stepping and
   with per-row, partly negative offsets over an odd-width chunk), and
   timed (median of CUDA-event timings).
3. Slice phase: a VerdictService(max_batch=2048) on the card answers
   8,192 CRS-style requests through `evaluate` under every
   PINGOO_DFA=off|auto|force x PINGOO_PREFILTER=off|banks mode; every
   matched row, action and verified_block must equal the interpreter
   oracle and the port's CPU path. The default mode (auto, banks) is the
   main path: the kernels' launch counts are reset just before it and
   read just after, and each kernel must have launched.
4. Prints one JSON line of per-kernel results, then, last,
   {"ok": true, "device": {...}}.

Any mismatch, build failure or error exits nonzero before the last line.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20260417
B = 2048
N_REQUESTS = 8192
MODES = [(dfa, pf) for dfa in ("auto", "off", "force")
         for pf in ("banks", "off")]  # (auto, banks) first: the main path

# H100 SXM peaks: HBM 3.35 TB/s (data sheet); int32 ALU ops 16.7 T/s =
# 132 SMs x 64 INT32 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s fp32
# counts 128 FP32 lanes x 2 flops per FMA; Hopper has half as many INT32
# lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

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


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of `fn()` over `reps` runs (after one
    warm-up run)."""
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
    return statistics.median(times)


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


def kernel_phase(plan, dev, rng) -> dict:
    """Each kernel against its plain version on the card; returns the
    per-kernel measurements (launch counts are filled in later)."""
    import torch

    from pingoo_tpu_torch.ops import bitsplit_dfa as dfa_ops
    from pingoo_tpu_torch.ops import nfa_scan
    from pingoo_tpu_torch.ops import prefilter as pf_ops

    tables = plan.np_tables
    fields = {f: field_batch(rng, plan.field_specs[f], dev)
              for f in ("url", "path", "user_agent")}
    results = {}

    def live_bytes(lens, width):
        return int(lens.clamp(0, width).sum().item())

    # -- prefilter: Stage A over url, path and user_agent ------------------
    pf_fields = [f for f in ("url", "path", "user_agent")
                 if f in plan.prefilter.fields]

    def pf_run(fn):
        outs = []
        for f in pf_fields:
            t = tables[plan.prefilter.fields[f].table_key]
            data, lens = fields[f]
            S, H = pf_ops.prefilter_init_state(B, t.num_words, dev)
            outs.extend(fn(t, data, lens, S, H, 0))
        return outs

    got = pf_run(pf_ops.fused_prefilter_chunk)
    want = pf_run(pf_ops.prefilter_scan_chunk_plain)
    err = max_abs_err(zip(got, want))
    # Chunk contract: carried state, per-row offsets, odd width.
    t = tables["pf_url"]
    data, lens = fields["url"]
    toff = torch.from_numpy(rng.integers(-40, 40, size=B).astype("int32")) \
        .to(dev)
    S0, H0 = got[0], got[1]
    chunk = data[:, 101:101 + 511]
    err = max(err, max_abs_err(zip(
        pf_ops.fused_prefilter_chunk(t, chunk, lens, S0, H0, toff),
        pf_ops.prefilter_scan_chunk_plain(t, chunk, lens, S0, H0, toff))))
    ms = cuda_ms(lambda: pf_run(pf_ops.fused_prefilter_chunk), 15)
    plain_ms = cuda_ms(lambda: pf_run(pf_ops.prefilter_scan_chunk_plain), 2)
    nbytes = ops = 0
    for f in pf_fields:
        tt = tables[plan.prefilter.fields[f].table_key]
        data, lens = fields[f]
        Wp = tt.num_words
        live = live_bytes(lens, data.shape[1])
        nbytes += live + 8 * B + 256 * Wp * 4 + Wp * 4 + 4 * B * Wp * 4
        ops += live * Wp * 4  # shift, or, and, or per word per byte
    results["prefilter"] = dict(
        route="cuda", source="pingoo_tpu_torch/csrc/prefilter.cu",
        replaces="pingoo_tpu/ops/prefilter.py:246", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops)
    print(f"prefilter: {len(pf_fields)} fields, max_abs_err {err}, "
          f"{ms:.4f} ms (plain {plain_ms:.1f} ms)", flush=True)

    # -- bitsplit DFA: the url and path gates -------------------------------
    dfa_keys = [(e.dfa_key, key.split("_", 1)[1])
                for key, e in plan.scan_plans.items() if e.dfa_key]

    def dfa_run(fn):
        outs = []
        for dkey, f in dfa_keys:
            t = tables[dkey]
            data, lens = fields[f]
            st, H = dfa_ops.dfa_init_state(B, t.num_words, dev)
            outs.extend(fn(t, data, lens, st, H, 0))
        return outs

    got = dfa_run(dfa_ops.fused_dfa_chunk)
    want = dfa_run(dfa_ops.dfa_scan_chunk_plain)
    err = max_abs_err(zip(got, want))
    t = tables[dfa_keys[0][0]]
    data, lens = fields[dfa_keys[0][1]]
    chunk = data[:, 33:33 + 777]
    err = max(err, max_abs_err(zip(
        dfa_ops.fused_dfa_chunk(t, chunk, lens, got[0], got[1], toff),
        dfa_ops.dfa_scan_chunk_plain(t, chunk, lens, got[0], got[1], toff))))
    ms = cuda_ms(lambda: dfa_run(dfa_ops.fused_dfa_chunk), 15)
    plain_ms = cuda_ms(lambda: dfa_run(dfa_ops.dfa_scan_chunk_plain), 2)
    nbytes = ops = 0
    for dkey, f in dfa_keys:
        tt = tables[dkey]
        data, lens = fields[f]
        live = live_bytes(lens, data.shape[1])
        Wh = tt.num_words
        nbytes += (live + 8 * B + tt.num_states * tt.num_classes * 4
                   + tt.num_states * Wh * 4 + 1024 + 2 * B * (1 + Wh) * 4)
        ops += live * (Wh + 3)  # Wh ORs, class lookup, index mul-add
    results["bitsplit_dfa"] = dict(
        route="cuda", source="pingoo_tpu_torch/csrc/bitsplit_dfa.cu",
        replaces="pingoo_tpu/ops/bitsplit_dfa.py:248", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops)
    print(f"bitsplit_dfa: {[k for k, _ in dfa_keys]}, max_abs_err {err}, "
          f"{ms:.4f} ms (plain {plain_ms:.1f} ms)", flush=True)

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
    ms = cuda_ms(lambda: nfa_run(nfa_scan.fused_scan_chunk, True), 15)
    plain_ms = cuda_ms(lambda: nfa_run(nfa_scan.scan_chunk_plain, True), 2)
    nbytes = ops = 0
    for key, f in nfa_keys:
        tt = tables[key]
        data, lens = fields[f]
        W = tt.opt.shape[0]
        C = tt.cls_table.shape[0]
        live = live_bytes(lens, data.shape[1])
        passes = 1 + tt.extra_passes
        carry = 1 if tt.has_carry else 0
        per_word = 7 + 4 * passes + carry * (3 + 3 * (passes - 1))
        nbytes += (live + 8 * B + C * W * 4 + 256 * 4 + 5 * W * 4
                   + 2 * B * W * 4)
        ops += live * W * per_word
    results["nfa_scan"] = dict(
        route="cuda", source="pingoo_tpu_torch/csrc/nfa_scan.cu",
        replaces="pingoo_tpu/ops/pallas_scan.py:71", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops)
    print(f"nfa_scan: {[k for k, _ in nfa_keys]} pair+single, max_abs_err "
          f"{err}, {ms:.4f} ms (plain {plain_ms:.1f} ms)", flush=True)

    for name, r in results.items():
        if r["max_abs_err"] != 0:
            fail(f"{name} kernel disagrees with its plain version "
                 f"(max_abs_err {r['max_abs_err']})")
    return results


async def serve(service, reqs):
    await service.start()
    try:
        t0 = time.monotonic()
        verdicts = await asyncio.gather(*(service.evaluate(r) for r in reqs))
        wall = time.monotonic() - t0
    finally:
        await service.stop()
    return verdicts, wall


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
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + t_us
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


def slice_phase(plan, rules, lists, dev) -> dict:
    """Serve the traffic in every mode; returns the main path's launch
    counts."""
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
    from pingoo_tpu_torch.utils.crs import generate_traffic

    reqs = generate_traffic(N_REQUESTS, attack_fraction=0.3, seed=SEED,
                            lists=lists)
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
        ms = np.array(service.batch_ms)
        stages = ", ".join(f"{k} {np.percentile(v, 50):.2f}"
                           for k, v in service.stage_ms.items())
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
    return main_counts


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one card")
    if not os.path.isdir(os.path.join(REPO, "pingoo_tpu_torch")):
        fail("pingoo_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    import numpy as np

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import generate_ruleset

    card = card_line()
    print(card, flush=True)
    t0 = time.monotonic()
    took = _build.build(verbose=True)
    print(f"build: {time.monotonic() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)
    for name, report in _build.ptxas_reports.items():
        regs = re.findall(r"Used (\d+) registers", report)
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", report))
        print(f"  ptxas {name}: registers per instantiation "
              f"{','.join(regs)}; spill bytes {spills}", flush=True)

    dev = torch.device("cuda")
    rules, lists = generate_ruleset(500)
    plan = compile_ruleset(rules, lists, device=dev)
    print(f"plan: {plan.stats}", flush=True)
    rng = np.random.default_rng(SEED)
    results = kernel_phase(plan, dev, rng)
    counts = slice_phase(plan, rules, lists, dev)
    out = []
    for name in ("nfa_scan", "bitsplit_dfa", "prefilter"):
        r = results[name]
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
