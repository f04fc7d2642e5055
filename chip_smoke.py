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
   PINGOO_DFA=off|auto|force x PINGOO_PREFILTER=off|banks mode with the
   default pipelined executor (PINGOO_PIPELINE=on, two batches in
   flight), and the default mode once more under PINGOO_PIPELINE=off;
   every matched row, action and verified_block must equal the
   interpreter oracle (computed in processes of its own while the
   kernels build) and the port's CPU path, and each batch's Stage-A aux
   vector (the prefilter counters' input, reduced from the prefilter
   kernel's hits) on the card must equal the plain versions' on the
   CPU. The default mode (auto,
   banks) under on is the main path: the kernels' launch counts are
   reset just before it and read just after, and each kernel must have
   launched. Both executor modes print req/s, and the main path's
   in-issue syncs are timed (`SyncTimer`). The main path runs twice more
   under PINGOO_MEGASTEP=force, at PINGOO_MEGASTEP_K=4 (each batch one
   window of 4 slices of 512 rows, one CUDA graph replay) and at 1 (one
   slice of 2048 rows): a warm-up pass captures the
   graphs, then the measured pass through the same service must give
   the main path's verdicts (and the oracle's) with every kernel
   launched through the replays and no epoch echo mismatch, and one
   more pass runs under torch.profiler. It prints the captures and
   their ms, replays, distinct graph keys, the verdict issue per batch
   and the device's busy share. Last, the main path under
   PINGOO_STAGING=compact (the plan's caps, one packed buffer a batch)
   and under PINGOO_PREFILTER=compact: each must give the main path's
   and the oracle's verdicts with all three kernels launched; each
   prints its staged bytes a request, encode ms a batch and verdict
   issue beside the main path's, and its device busy share. Compact
   staging's upload (one pinned copy) and device decode (`unpack_staged`,
   six contiguous field copies) of one batch are timed at the plan's caps
   and at PINGOO_STAGING_DEPTH=256, the decode held to full staging's
   arrays cut to the caps.
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
   on the 500-rule plan with its lists, first under PINGOO_PIPELINE=off
   (one batch at a time), then a fresh one under on (pipeline_depth=3).
   A producer in a child process, as the httpd is, drives each a warm
   stream, then the measured stream (generate_traffic(16384, seed=11)),
   and under on the measured stream again under torch.profiler. Each
   measured drive must give checksum 4032806221 (the JAX package's
   value on this stream), VerdictService's verdict on the card for
   every request, every ticket answered once, a heartbeat age under 500
   ms and launches of all three kernels (counts set to 0 just before the
   drive, read just after); the on arm must have had two or more
   batches in flight. Two more arms run under PINGOO_MEGASTEP=force
   (K=4, on): max_batch=2048, and max_batch=256, whose measured drive
   must split into more than 40 slices; each first runs the sidecar's
   warm_up() (one window of every K it ships, narrow and wide, each
   capturing its graph) and counts the captures its warm stream still
   makes; both must give the same
   checksum and bytes, launch every kernel through graph replays and
   echo every slice's epoch. Each of these four arms' sidecars keeps a
   metric registry of its own, scraped after its drives: its
   `pingoo_ring_*` series and wait-histogram buckets must be its ring's
   `ring_telemetry()`, its text must lint clean and its prefilter
   counters must have moved. Then bench.py's staging pair on the same
   ring: bench_staging's warm (seed 22) and measured (seed 21) streams
   of 8,192 requests with its long-URL tail (one request in 200 with a
   url and path of about 1,800 more bytes), at PINGOO_STAGING_DEPTH=256,
   through fresh sidecars under PINGOO_STAGING=full, compact, and
   compact with PINGOO_MEGASTEP=force (after warm_up()). Each measured
   drive must give checksum 3631441880 (the JAX package's, both modes,
   BENCH_staging.json), every ticket answered once, a heartbeat under
   500 ms and launches of all three kernels; the compact arms must
   re-serve exactly the stream's rows whose url or path passes 256
   bytes. Prints {"ring": ...}: per arm req/s, wait
   p50/p99, batches, the stage split, the verdict issue per batch, the
   in-issue syncs, launches per batch, peak in flight, overlap_ratio
   and stage occupancy, the megastep arms' warm-up, windows, captures,
   capture ms, replays and window wall, and the on arms' device busy
   share; per staging arm its staged bytes a request, depth-overflow
   rows and, under force, its distinct graph keys. Last, the halo split
   on the ring: the corpus compiled under PINGOO_NFA_SPLIT=1 serves the
   measured stream once through a fresh sidecar under each of
   PINGOO_NFA_SPLIT=1 alone, with PINGOO_SCAN_STRATEGY=halo and with
   PINGOO_HALO_SPLIT=1, each under PINGOO_PIPELINE=on, off and
   PINGOO_MEGASTEP=force (after warm_up()): every drive must give the
   same checksum and VerdictService's bytes, and launch the NFA and
   prefilter kernels (a split bank runs no DFA).
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
8. Listener phase, in a process of its own: the Python plane over HTTP
   (host/httpd.py, host/server.py). The corpus as a deployment with a
   captcha rule appended, a static service and an `api` service proxied
   to a pong upstream (a child process), served by
   Server(config, device=None, xff_token=T). A client child sends the
   slice phase's stream as HTTP/1.1 requests over 256 keep-alive
   connections (each with its tuple's method, target, Host and user
   agent, the token and x-forwarded-for: its IP): a warm-up pass, the
   measured pass, 256 of them over h2 by prior knowledge, and the
   first 2,048 under torch.profiler; then a fresh Server with
   PINGOO_BODY_INSPECT=on, a seed-set body on every fourth of the first
   2,048.
   Every response must be the interpreter oracle's outcome on the tuple
   the listener derives (403, the challenge page, pong's 200, or the
   static site's 200/404/405), every request answered once, no engine
   error and no body scan failed open, stats.snapshot() the requests
   evaluated, and the measured pass must launch all three kernels
   (counts set to 0 just before it, read just after). In each pass the
   registry's `pingoo_requests_total{plane="python"}` must move by the
   requests sent and its wait histogram's count by those evaluated.
   After the passes, one batch of 48 distinct requests and 16 repeats
   of them goes straight into the listener's handler at once: dedup_hits
   must move by 16 in one collector batch, each repeat answered as its
   first; then a scrape of /__pingoo/metrics (no Accept header) must
   answer 200 `text/plain; version=0.0.4` that lints clean and carries
   the shared, prefilter, DFA and scheduler families. Last, `python -m
   pingoo_tpu_torch` on the card answers a blocked, a captcha and a
   proxied request and exits 0 within 20 s of SIGTERM. Prints
   {"listener": ...}: req/s, client latency p50/p99, batches and rows a
   batch, the stage split, CPU shares, the device's busy share and
   launches per pass.
9. Native phase, in a process of its own: the native-plane runner
   (host/native_plane.py). It prints what `ldconfig -p` lists of libssl,
   libcrypto and libnghttp2 and the build seconds of the httpd, pong
   and loadgen_http (pingoo_tpu_torch/native), then serves the listener
   phase's deployment (one more rule: the CRS `(?i)<script` signature
   on the URL) through NativePlane(config, device=None): the C++ httpd
   in front of RingSidecar on the card, `api` proxied to C++ pong. The
   listener client sends the same 8,192 requests over 256 keep-alive
   connections bound to addresses in 127.0.0.0/8, every eighth of them
   in the deployment's IP list; every response must be the interpreter
   oracle's outcome on the tuple the httpd derives (peer address, asn
   0, country XX, 302 for a captcha), the httpd's counters must move as
   the oracle says (no fail-open, no degraded entry) and the pass must
   launch all three kernels. bench.py's end-to-end drive follows
   (loadgen_http 8192 1024 100, then 100000 4096 100, then 16384 4096
   100 under torch.profiler in sessions of 0.2 s, each session's stop
   holding the sidecar well under the httpd's 500 ms liveness window):
   loadgen_http's shapes are first held to the
   oracle, and each measured run must block exactly the attacks it sent
   with no error, fail-open or degraded entry. Then a fresh plane with
   PINGOO_BODY_INSPECT=on and a seed-set body on every fourth of 2,048
   requests (each response the merged oracle's, no body scan failed
   open), and `python -m pingoo_tpu_torch --native-plane` answering a
   blocked, a captcha and a proxied request and exiting 0 within 20 s
   of SIGTERM with no httpd left. After the loadgen runs the httpd's
   Prometheus text must carry every shared metric name, and the
   sidecar's registry its ring's verdicts posted; the phase prints the
   httpd's pingoo_degraded_entered_total over the plane's life and the
   largest heartbeat age of the passes (the evidence on a stall of the
   sidecar's process). Prints {"native": ...}: req/s, client
   and added latency p50/p99, the httpd's and the ring's verdict-wait
   percentiles, the sidecar's stages and busy share, rows and launches
   per batch, the largest heartbeat age and the device's busy share.
10. Halo phase: the halo split (ops/nfa_scan.halo_split_scan). The
   corpus compiled under PINGOO_NFA_SPLIT=1 partitions nfa_url and
   nfa_path into @short (13 words, H = 14, halo-compatible) and @rest
   sub-banks. (a) On B rows at full width (2048-byte url and path with
   planted attacks, the first rows' lengths on and around the @short
   chunk boundaries), the split verdict under PINGOO_PREFILTER=off must
   equal the default plan's, each of its NFA launches (the @short halo
   launches of B x 8 rows of 14 + 256 columns, chunk 0 at offset -14,
   and the @rest launches) is replayed through kernel and plain version
   bit for bit, and the url @short halo launch, the same sub-bank over
   the unsplit rows and the url @rest launch are timed, issued and
   queued, beside their bounds. The split main path's own @short halo
   launches (grouped by staged width) are timed queued against the same
   sub-bank over the same rows unsplit, and so is the url @short
   sub-bank on seeded rows at each width from 32 to 2048, beside
   whether the JAX package's rule takes the halo route there and which
   of the two was faster on the card. (b) The main-path stream through a
   VerdictService on the split plan under PINGOO_NFA_SPLIT=1 alone, with
   PINGOO_SCAN_STRATEGY=halo and with PINGOO_HALO_SPLIT=1, each under
   PINGOO_PIPELINE=on, off and PINGOO_MEGASTEP=force, and on the default
   plan under the two runtime knobs: every verdict must equal the main
   path's and the oracle's, and each pass launch the NFA and prefilter
   kernels. (c) The default main path runs before and after, and with
   the split main path once under torch.profiler: req/s, launches a
   batch and device time a pass, in one process. Prints {"halo": ...}.
11. Bot phase: the bot head (models/botscore.py), its weights drawn
   from a seeded torch.Generator, saved to npz and loaded onto the card.
   Under PINGOO_PIPELINE=off, on, on with PINGOO_STAGING=compact and
   PINGOO_MEGASTEP=force, VerdictService(bot_score_params=) scores the
   8,192 requests within 1e-5 of the head's plain CPU computation over
   the arrays that arm stages, with verdicts equal to the oracle's and
   to the same service's without the head, and every kernel launched.
   Prints the scorer's µs a full-width batch (queued and issued) and the
   main path's req/s without and with the head in turn. Prints
   {"bot": ...}.
12. Swap phase: hot-swap (engine/hotswap.py) and the artifact cache
   (compiler/cache.py). Epoch 1 is generate_ruleset(500, seed=5), whose
   tables have other shapes; compile_ruleset_cached gives it cold
   (compile, proof, write) and warm (a hit placed on the card), timed,
   the hit's tables bit-equal to a fresh compile's. The interpreter's
   oracle of epoch 1 runs in processes of its own meanwhile. The Python
   plane under PINGOO_PIPELINE=off, on and PINGOO_MEGASTEP=force: half
   the stream, then swap_plan while bursts keep arriving, then the
   rest; every verdict equals its epoch's oracle. The ring under on and
   force, each after warm_up(): a producer child drives one stream of
   2,048 requests again and again, a thread calls request_swap once
   1,024 are processed (the new state built, and under force its graphs
   captured, on that thread), and two drives follow the flip; every
   ticket is posted once on its epoch's oracle, the heartbeat stays
   under 500 ms and no epoch echo differs. Each force arm then swaps
   back to epoch 0's plan (epoch 2) with the capture lock held by the
   swap's first capture until a serving capture of a new window shape
   waits for it (`HeldCaptureLock`): both captures must succeed, the
   serving side's verdict equal epoch 1's oracle, and the serving
   runner's wait for the lock is printed. Prints each swap's pause and
   {"swap": ...}.
13. Sched phase, in a process of its own: admission, the degradation
   ladder and chaos (sched/scheduler.py, engine/ladder.py,
   obs/chaos.py) on the ring phase's set-up (its stream's lanes'
   crc32 is RING_CHECKSUM). It times one 1,024-row batch through
   `evaluate_batch` (the cost model's seed). The Python plane serves
   the 16,384 requests under `continuous` and `fixed` at the default
   deadline (in the order continuous, fixed, fixed, continuous), a
   paced arm (64 requests every 4 ms under a 1 s deadline,
   whose batches must hold past one arrival), PINGOO_MEGASTEP=auto
   (K up to 4 under a 1 s deadline: windows of K > 1 through graph
   replays), `allow` at 500 ms (the burst's later batches fail open,
   counted once each) and `interpret` under an impossible deadline (256
   requests, the interpreter's rows); each prints req/s, launches, rows
   a batch and misses, and every verdict not failed open must equal
   VerdictService's lanes and the first 1,024 the interpreter's rows.
   The ring (a producer child) under `continuous`, `fixed`, a 1 s
   deadline (held passes), `auto`, `allow`, `fixed` and `continuous`
   again, each drive held to the
   checksum and the bytes (`allow` at 150 ms: the bytes off
   VerdictService's are 0 and no more than the rows failed open); then
   at max_batch 256 the chaos arms:
   `xla_error:1` per batch and under `force` (a rung demoted after the
   first drive, the interpreter's bytes posted, re-promoted by a probe
   after the backoff, a third drive launching every kernel again) and
   `swap_storm` under `force` (every ticket once, heartbeat under 500
   ms). Outside the chaos arms no ladder rung may fail, in this phase
   or any other (`guard_ladder`). Prints {"sched": ...}.
14. The ledgers (obs/perf.py, sched/scheduler.py). The compile ledger
   is off through the set-up, where a VerdictService's programs must be
   the unwrapped callables; then every process of the run keeps its
   compile ledger (PINGOO_PERF_LEDGER) and a compile surface
   (PINGOO_COMPILE_SURFACE: the graph keys' rows on the pow2 ladder, K
   in {1, 2, 4}) in files of its own under one temporary directory,
   never at the repo root. The set-up's nvcc build runs outside any
   served program, so it is no program's compile. The compile ledger's
   cold and warm counts and ms are printed after the slice phase's
   megastep warm-up and measured passes, and after each ring and
   staging arm's warm_up() and drives (the captures under traffic after
   warm_up(), reported, not gated, as are events outside the surface);
   each process's JSONL must equal its ledger's snapshot, and its
   registries' pingoo_compile_total (each ring arm's own registry, the
   arm's events exactly) the ledger's totals. The durable cost ledger
   is off in every arm (PINGOO_COST_LEDGER=off), so each arm starts
   from the seed whatever ran before it; its own steps use files of
   their own under the same directory. In the ring phase a sidecar
   that finds none reloads `missing`, drains the measured stream and
   saves `cuda|sidecar` at stop(); a new one on the same plan reloads
   `ok` with equal costs, one on the corpus less a rule `stale`. In the
   sched phase a Python service serves the ring stream and stops, a new
   one on the same plan reloads `ok` with equal costs, one on the corpus
   less a rule `stale`, one on generate_ruleset(500, seed=5) what the
   fingerprints predict (equal names and caps: `ok`); each prints the
   first batch's estimate before and after the reload, beside
   DEFAULT_SEED_MS; `python -m
   pingoo_tpu_torch`'s SIGTERM drain must save `cuda|python` costs.
   Last, the measured re-selection (`reselect_phase`): per-iteration
   costs of the NFA kernel (single and pair stepping) and the DFA kernel
   on the same 2048 x 2048 rows of the widest lowered bank,
   `reselect_scan_strategies`, the tuned plan through the artifact cache
   (its scan plans kept), and the main path served from it under
   PINGOO_DFA=auto with no verdict differing from the oracle.
15. Prints one JSON line of per-kernel results (with each kernel's
   launches in the config phase, on the ring drive, on the body
   phase's streamed passes, on the listener's measured pass, on the
   native phase's measured loadgen run, through the megastep's graph
   replays in the slice phase and the two ring arms, in the compact
   slice arms, in the ring's staging arms, on the split main path
   of the halo phase and its ring arm under on, on the bot phase's
   main path with the head, on the swap phase's Python `on` arm and
   ring `force` arm, and on the sched phase's Python `continuous` and
   `auto` arms), then, last,
   {"ok": true, "device": {...}}.

Any mismatch, build failure or error exits nonzero before the last line.
Imports no JAX and nothing of the JAX package.

    python3 chip_smoke.py --stage-a-of DIR

times one batch's Stage A as the port in DIR issues it and prints it as
a JSON line, but no result line: the smoke run uses it for its own
tree, and it times an earlier tree beside this one in one chip call.
`python3 chip_smoke.py --ring-phase` runs the ring phase alone (and
`--ring-producer PATH` is its producer, which drives one stream for each
line "seed requests every" it reads from stdin), `--body-phase` the
body phase alone, `--listener-phase` the listener phase alone
(`--listener-client` and `--listener-pong` are its client and
upstream; the native phase uses the same client), `--native-phase`
the native phase alone, `--halo-phase` the halo phase alone (after
the build, the oracle and one pass of the main path), `--bot-phase`
and `--swap-phase` the bot and swap phases alone (after the build and
the oracle), and `--sched-phase` the sched phase alone.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
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
# The ring phase's many-slice megastep arm: max_batch of its sidecar.
RING_MANY_SLICES = 256
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


_CARD: list = []


def card() -> str:
    """`card_line()`, read once per process (printed beside numbers)."""
    if not _CARD:
        _CARD.append(card_line())
    return _CARD[0]


# -- the ledgers (obs/perf.py, sched/scheduler.py) -----------------------------
#
# Every process of the run keeps its compile ledger and its durable cost
# ledger in files of its own under one temporary directory, which the
# first process makes and its children inherit through CHIP_SMOKE_LEDGERS;
# nothing is written at the repo root. The compile surface file admits
# the graph keys the planes capture (rows on the pow2 ladder, K in
# {1, 2, 4}); an event outside it is reported, not gated.

LEDGER_DIR_ENV = "CHIP_SMOKE_LEDGERS"
COMPILE_SURFACE = {"version": 1, "planes": ["python", "sidecar"],
                   "fns": ["verdict", "lanes", "megastep"],
                   "kinds": ["cold", "warm"],
                   "batch_buckets": [1 << i for i in range(13)],
                   "k_rungs": [1, 2, 4]}
# Compile events counted on registries of the ring arms' own, by (plane,
# fn, kind): with the process's REGISTRY they make the ledger's totals.
_OWN_REGISTRY_COMPILES: dict = {}


def ledger_env() -> str:
    """Point this process's compile ledger (PINGOO_PERF_LEDGER,
    PINGOO_COMPILE_SURFACE) at files of its own in the run's ledger
    directory, made (with the surface file) by the first process, and
    turn its durable cost ledger off (PINGOO_COST_LEDGER=off): every arm
    starts from the seed, whatever arm ran before it, and the cost
    ledger's own steps point it at files of theirs (`cost_ledger_at`).
    Returns the directory."""
    import tempfile

    from pingoo_tpu_torch.obs import perf

    d = os.environ.get(LEDGER_DIR_ENV)
    if not d:
        d = tempfile.mkdtemp(prefix="chip-smoke-ledgers-")
        os.environ[LEDGER_DIR_ENV] = d
        with open(os.path.join(d, "compile_surface.json"), "w") as f:
            json.dump(COMPILE_SURFACE, f)
    pid = os.getpid()
    os.environ.update({
        "PINGOO_PERF_LEDGER": os.path.join(d, f"perf_ledger-{pid}.jsonl"),
        "PINGOO_PERF_LEDGER_N": "100000",
        "PINGOO_COMPILE_SURFACE": os.path.join(d, "compile_surface.json"),
        "PINGOO_COST_LEDGER": "off"})
    perf.reset_compile_ledger_for_tests()
    return d


@contextlib.contextmanager
def cost_ledger_at(name: str):
    """PINGOO_COST_LEDGER at a file of its own in the run's ledger
    directory while the block runs (off again after it); yields the
    path."""
    path = os.path.join(os.environ[LEDGER_DIR_ENV],
                        f"cost_ledger-{name}-{os.getpid()}.json")
    prev = os.environ["PINGOO_COST_LEDGER"]
    os.environ["PINGOO_COST_LEDGER"] = path
    try:
        yield path
    finally:
        os.environ["PINGOO_COST_LEDGER"] = prev


def ledger_mark() -> int:
    """The number of compile events this process's ledger holds."""
    from pingoo_tpu_torch.obs.perf import get_compile_ledger

    return len(get_compile_ledger().snapshot()["events"])


def ledger_counts(since: int = 0) -> dict:
    """The compile events from index `since` on: counts and ms by kind
    and fn, and those outside the surface."""
    from pingoo_tpu_torch.obs.perf import get_compile_ledger

    events = get_compile_ledger().snapshot()["events"][since:]
    out = {"cold": 0, "warm": 0, "cold_ms": 0.0, "warm_ms": 0.0,
           "unexpected": 0, "by_fn": {}, "keys": []}
    for e in events:
        out[e["kind"]] += 1
        out[f"{e['kind']}_ms"] = round(out[f"{e['kind']}_ms"]
                                       + e["wall_ms"], 3)
        out["unexpected"] += bool(e.get("unexpected"))
        fn = f"{e['plane']}/{e['fn']}"
        out["by_fn"][fn] = out["by_fn"].get(fn, 0) + 1
        out["keys"].append((e["kind"], e["batch_bucket"], e["k"]))
    return out


def ledger_line(label: str, c: dict) -> None:
    print(f"compile ledger, {label}: cold {c['cold']} ({c['cold_ms']:.1f} "
          f"ms), warm {c['warm']} ({c['warm_ms']:.1f} ms), by fn "
          f"{c['by_fn']}, outside the surface {c['unexpected']}; "
          f"(kind, rows, K) {c['keys']} [{card()}]", flush=True)


def compile_totals(registry) -> dict:
    """{(plane, fn, kind): n} of a registry's pingoo_compile_total."""
    out = {}
    for key, v in registry.json_snapshot().get(
            "pingoo_compile_total", {}).items():
        lab = dict(kv.split("=", 1) for kv in key.split(","))
        if v:
            out[(lab["plane"], lab["fn"], lab["kind"])] = v
    return out


def ledger_check(label: str) -> dict:
    """This process's compile ledger: every JSONL line must be its
    snapshot's event, and the registries' pingoo_compile_total (the
    process's REGISTRY and the ring arms' own) its totals."""
    from pingoo_tpu_torch.obs.perf import get_compile_ledger
    from pingoo_tpu_torch.obs.registry import REGISTRY

    ledger = get_compile_ledger()
    snap = ledger.snapshot()
    lines = []
    if ledger.path and os.path.exists(ledger.path):
        with open(ledger.path) as f:
            lines = [json.loads(line) for line in f]
    if not ledger.enabled or lines != snap["events"]:
        fail(f"{label}: the compile ledger (enabled {ledger.enabled}) "
             f"wrote {len(lines)} lines, its snapshot holds "
             f"{len(snap['events'])} events, and they differ")
    counted = dict(compile_totals(REGISTRY))
    for k, n in _OWN_REGISTRY_COMPILES.items():
        counted[k] = counted.get(k, 0) + n
    want = {tuple(k.split("/")): n for k, n in snap["totals"].items()}
    if counted != want:
        fail(f"{label}: pingoo_compile_total {counted}, the ledger's "
             f"totals {want}")
    print(f"compile ledger of the {label}: {len(lines)} events, JSONL "
          f"equal to the snapshot, pingoo_compile_total equal to its "
          f"totals {snap['totals']}, outside the surface "
          f"{snap['unexpected_total']} [{card()}]", flush=True)
    return dict(events=len(lines), totals=snap["totals"],
                unexpected=snap["unexpected_total"])


def ledger_off_check(plan, lists, dev) -> None:
    """With PINGOO_PERF_LEDGER unset, a VerdictService's programs (the
    verdict program and, under PINGOO_MEGASTEP=force, its runner's
    megastep program) are the unwrapped callables."""
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.engine.verdict import MegastepProgram
    from pingoo_tpu_torch.obs import perf

    if perf.get_compile_ledger().enabled:
        fail("the compile ledger is on before ledger_env()")
    os.environ["PINGOO_MEGASTEP"] = "force"
    try:
        service = VerdictService(plan, lists, max_batch=B, device=dev)
    finally:
        os.environ.pop("PINGOO_MEGASTEP")
    fn, prog = service._verdict_fn, service._mega_runner.program
    if isinstance(fn, perf._InstrumentedProgram) \
            or type(prog) is not MegastepProgram:
        fail(f"with the ledger off the service runs {type(fn).__name__} "
             f"and {type(prog).__name__}, not the unwrapped programs")
    print(f"compile ledger off: the service's programs are the unwrapped "
          f"{type(fn).__name__} and {type(prog).__name__}", flush=True)


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


def capture_main_path(plan, lists, reqs, dev, megastep: bool = False):
    """Serve `reqs` once on the main path with every kernel's launcher
    wrapped; returns {kernel: its calls' inputs, by table key (a list of
    keys for a grouped call)} and {kernel: its own launch count over that
    pass}. With `megastep`, the batches go through VerdictService under
    PINGOO_MEGASTEP=force (the Python plane's default K, one slice a
    batch), one at a time, each window's K-slice body run
    eagerly instead of through its graph (a launch inside a capture
    runs nothing there to record): the megastep arm's calls."""
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
        if megastep:
            os.environ["PINGOO_MEGASTEP"] = "force"
            service = VerdictService(plan, lists, max_batch=B, device=dev)
            runner = service._mega_runner

            def eager(queue, buf_id, k_used, k_ship):
                stacked, nv, ep = queue.device_stack(buf_id, k_used, k_ship)
                return runner.program.fn(
                    runner.tables, {k: v.to(dev) for k, v in stacked.items()},
                    nv.to(dev), ep.to(dev))

            runner.run = eager
            for lo in range(0, N_REQUESTS, B):
                service.evaluate_batch(reqs[lo:lo + B])
        else:
            asyncio.run(serve(VerdictService(plan, lists, max_batch=B,
                                             device=dev), reqs))
    finally:
        for name, (mod, attr, _, _) in launchers().items():
            setattr(mod, attr, reals[name])
        os.environ.pop("PINGOO_DFA")
        os.environ.pop("PINGOO_PREFILTER")
        os.environ.pop("PINGOO_MEGASTEP", None)
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


def main_path_phase(plan, name, calls, n_launched,
                    label: str = "main path") -> dict:
    """Replay one kernel's captured main-path calls through the kernel
    and the plain version (bit equality), time the whole replay (issued
    by the host, and queued on the card) and give the work's bound and,
    for the DFA, its chain floor; `n_launched` is the kernel's launch
    count over the captured pass."""
    import numpy as np

    mod, attr, plain, work_fn = launchers()[name]
    fused = getattr(mod, attr)
    if not n_launched or not calls:
        fail(f"the {label} launched no {name} kernel to capture")

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
    print(f"{name} {label}: {len(calls)} calls, {n_launched} launches "
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
    can record no device events). A sleep kernel goes before each run and
    after the last, and a kernel counts for the run between the two
    markers it falls between on the device's own clock: the device's
    timestamps can lie tens of µs before the host's, so a kernel launched
    at the start of a host-side range has shown up before that range on
    the H100."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in prof.events() if e.device_type == cuda),
                     key=lambda e: e.time_range.start)
    runs = []
    for k in kernels:
        if "spin_kernel" in k.name:
            runs.append({})
        elif runs:
            runs[-1][k.name] = runs[-1].get(k.name, 0) + 1
    if len(runs) != len(fns) + 1 or runs[-1]:
        fail(f"the profiler recorded {len(runs)} marker kernels around "
             f"{len(fns)} runs, not {len(fns) + 1}")
    return dict(zip(fns, runs))


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


# The port's kernels as the profiler names them on the device.
PORT_KERNEL_NAMES = ("nfa_chunk_kernel", "dfa_chunk_kernel", "pf_kernel")


def session_device(prof) -> tuple[float, int]:
    """A stopped torch.profiler session's device time (µs: its kernels
    and copies, summed from the trace's events without building the
    per-name tables `device_time_us` reads) and the launches of the
    port's kernels it recorded."""
    import torch

    us, ours = 0.0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us += e.duration_ns() / 1e3
            ours += any(k in e.name() for k in PORT_KERNEL_NAMES)
    return us, ours


def profile_pass(service, reqs) -> tuple[dict, float]:
    """One pass of `reqs` through `service` under torch.profiler: the
    device time by kernel name (µs, `device_time_us`) and the pass's wall
    time (s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = asyncio.run(serve(service, reqs))
        torch.cuda.synchronize()
    return device_time_us(prof), wall


def profile_main_path(plan, lists, reqs, dev, service=None):
    """One more main-path run (through `service`, else a fresh one)
    under torch.profiler: the device's busy share of the wall time and
    the device time by kernel name (printed as "not measured" when the
    profiler records no device time); returns the busy share (%) or
    "not measured"."""
    from pingoo_tpu_torch.engine.service import VerdictService

    if service is None:
        service = VerdictService(plan, lists, max_batch=B, device=dev)
    kernels, wall = profile_pass(service, reqs)
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms <= 0:
        print("profile: device time not measured (the profiler recorded "
              "no device kernels)", flush=True)
        return "not measured"
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    busy = 100 * busy_ms / (wall * 1e3)
    print(f"profile (main path, {N_REQUESTS} requests): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_ms:.2f} ms "
          f"({busy:.2f}% busy); by kernel (ms): "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f}" for k, v in top),
          flush=True)
    return busy


# The slice phase's interpreter oracle runs in processes of its own while
# the kernels build.
SLICE_ORACLE_WORKERS = 6
_slice_oracle = None  # (the CPU plan, lists) of an oracle process


def slice_oracle_init(rules, lists) -> None:
    global _slice_oracle
    from pingoo_tpu_torch.compiler.plan import compile_ruleset

    _slice_oracle = (compile_ruleset(rules, lists, device="cpu"), lists)


def slice_oracle(reqs):
    """The interpreter's match rows of `reqs`, in an oracle process."""
    import numpy as np

    from pingoo_tpu_torch.engine.batch import tuple_to_context
    from pingoo_tpu_torch.engine.verdict import interpret_rules_row

    plan, lists = _slice_oracle
    return np.stack([interpret_rules_row(plan, tuple_to_context(r, lists))
                     for r in reqs])


def slice_phase(plan, rules, lists, reqs, dev, oracle):
    """Serve the traffic in every mode, each verdict held to `oracle`
    (the interpreter's rows of `reqs`); returns the main path's launch
    counts and its (matched, actions, verified_block)."""
    import numpy as np
    import torch

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine.batch import (RequestBatch, bucket_arrays,
                                               encode_requests)
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.engine.verdict import (action_lanes, finish_batch,
                                                 make_verdict_program)
    from pingoo_tpu_torch.ops import _build

    o_act, o_vb = action_lanes(plan, oracle)
    print(f"oracle: {int(oracle.sum())} matches, "
          f"{int((o_act != 0).sum())} acted", flush=True)
    cpu_plan = compile_ruleset(rules, lists, device="cpu")
    # With the Stage-A aux vector: the card's (its prefilter kernel's
    # hits) is held to the plain versions' on the CPU, batch by batch.
    cpu_fn = make_verdict_program(cpu_plan)
    card_fn = make_verdict_program(plan)
    aux_checked = {}
    aux_s = 0.0  # the card's half of the aux check, its added cost
    main_counts = None
    # Every mode under the default executor (PINGOO_PIPELINE=on); the
    # main path's mode also under off, one batch at a time, and under
    # PINGOO_MEGASTEP=force at PINGOO_MEGASTEP_K=4 (4 slices of 512 rows
    # a batch) and 1 (one slice of 2048 rows).
    # Last, the main path under PINGOO_STAGING=compact and under
    # PINGOO_PREFILTER=compact, each held to the main path's verdicts.
    runs = [(dfa, pf, "on", "off", None, "full") for dfa, pf in MODES]
    runs.insert(1, (*MODES[0], "off", "off", None, "full"))
    runs.insert(2, (*MODES[0], "on", "force", 4, "full"))
    runs.insert(3, (*MODES[0], "on", "force", 1, "full"))
    runs.append((*MODES[0], "on", "off", None, "compact"))
    runs.append(("auto", "compact", "on", "off", None, "full"))
    cpu_rows = {}
    megas = {}
    compacts = {}
    for dfa_mode, pf_mode, pipe_mode, mega_mode, mega_k, staging in runs:
        os.environ["PINGOO_DFA"] = dfa_mode
        os.environ["PINGOO_PREFILTER"] = pf_mode
        os.environ["PINGOO_PIPELINE"] = pipe_mode
        os.environ["PINGOO_MEGASTEP"] = mega_mode
        os.environ["PINGOO_STAGING"] = staging
        if mega_k is not None:
            os.environ["PINGOO_MEGASTEP_K"] = str(mega_k)
        label = (f"PINGOO_DFA={dfa_mode} PINGOO_PREFILTER={pf_mode} "
                 f"PINGOO_PIPELINE={pipe_mode}"
                 + (f" PINGOO_MEGASTEP=force PINGOO_MEGASTEP_K={mega_k}"
                    if mega_mode == "force" else "")
                 + (" PINGOO_STAGING=compact" if staging == "compact"
                    else ""))
        main = (dfa_mode, pf_mode, staging) == ("auto", "banks", "full")
        compact = "compact" in (pf_mode, staging)
        # A warm-up pass over the same batches (each new field width
        # costs a first call) outside the timings, then a fresh service;
        # under the megastep the warmed service itself, whose graphs the
        # warm-up captured, with its statistics started afresh.
        mark = ledger_mark()
        warm = VerdictService(plan, lists, max_batch=B, device=dev)
        if mega_mode == "force":
            # This thread alone uses the card in the warm-up pass: its
            # captures run in the global mode, where any call of the
            # slice body illegal under capture would raise.
            warm._mega_runner.capture_mode = "global"
        t0 = time.monotonic()
        for lo in range(0, N_REQUESTS, B):
            warm.evaluate_batch(reqs[lo:lo + B])
        warm_s = time.monotonic() - t0
        # The verdict issue of the warm-up's batches, one at a time in
        # this thread (the measured pass below issues beside another
        # batch's encode or finish, which contend for the interpreter).
        alone = warm.stats.stages["verdict"].summary()
        if mega_mode == "force":
            warm._mega_runner.capture_mode = "thread_local"
            service = warm
            mega = megas[mega_k] = {}
            mega["warm_s"] = warm_s
            mega["warm_graphs"] = service._mega_runner.snapshot()
            mega["ledger"] = {"warm_up": ledger_counts(mark)}
            ledger_line(f"slice phase, megastep K={mega_k}, after the "
                        f"warm-up pass", mega["ledger"]["warm_up"])
            mark = ledger_mark()
            service.stats = type(service.stats)(service.WINDOW,
                                                service.stats.epoch)
            service._pipe = type(service._pipe)("python",
                                                service._pipeline_depth)
        else:
            service = VerdictService(plan, lists, max_batch=B, device=dev)
        os.environ.pop("PINGOO_PIPELINE")
        syncs = SyncTimer()
        _build.reset_launch_counts()
        with syncs:
            verdicts, wall = asyncio.run(serve(service, reqs))
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        if main and (pipe_mode, mega_mode) == ("on", "off"):
            main_counts = counts
        matched = np.stack([v.matched for v in verdicts])
        act = np.array([v.action for v in verdicts])
        vb = np.array([v.verified_block for v in verdicts])
        if main and (pipe_mode, mega_mode) == ("on", "off"):
            main_out = (matched, act, vb)
        if mega_mode == "force":
            if (matched != main_out[0]).any() or (act != main_out[1]).any() \
                    or (vb != main_out[2]).any():
                fail(f"{label}: verdicts differ from the main path's")
            missing = [k for k, n in counts.items() if n == 0]
            if missing:
                fail(f"{label}: no {missing} kernel launched through the "
                     f"graph replays")
            mega["ledger"]["measured"] = ledger_counts(mark)
            ledger_line(f"slice phase, megastep K={mega_k}, after the "
                        f"measured pass", mega["ledger"]["measured"])
            mega.update(
                launches=counts, graphs=service._mega_runner.snapshot(),
                snapshot=service.pipeline_snapshot()["megastep"],
                echo_mismatch=service.mega_echo_mismatch,
                verdict_ms=service.stats.stages["verdict"].summary(),
                verdict_alone_ms=alone, req_per_s=N_REQUESTS / wall)
            if mega["echo_mismatch"]:
                fail(f"{label}: {mega['echo_mismatch']} epoch echoes differ")
        stats = service.stats
        staging_cols = dict(
            staged_bytes_per_request=stats.staged_bytes / N_REQUESTS,
            encode_ms=stats.stages["encode"].summary(),
            verdict_ms=stats.stages["verdict"].summary())
        if main and (pipe_mode, mega_mode) == ("on", "off"):
            main_staging = staging_cols
        if compact:
            if (matched != main_out[0]).any() or (act != main_out[1]).any() \
                    or (vb != main_out[2]).any():
                fail(f"{label}: verdicts differ from the main path's")
            missing = [k for k, n in counts.items() if n == 0]
            if missing:
                fail(f"{label}: the main path launched no {missing} kernel")
            compacts["staging" if staging == "compact" else "prefilter"] = \
                dict(label=label, launches=counts, req_per_s=N_REQUESTS / wall,
                     caps=service.stage_caps, **staging_cols)
        # The port's CPU path on the same batches, once per mode.
        if (dfa_mode, pf_mode) not in cpu_rows:
            cpu, auxes = [], []
            for lo in range(0, N_REQUESTS, B):
                chunk = reqs[lo:lo + B]
                arrays = bucket_arrays(
                    encode_requests(chunk, cpu_plan.field_specs).arrays)
                m, cpu_aux, _ = cpu_fn(cpu_plan.np_tables, arrays)
                cpu.append(finish_batch(
                    cpu_plan, m, RequestBatch(size=len(chunk), arrays=arrays),
                    lists))
                t_aux = time.monotonic()
                card_aux = card_fn(plan.np_tables, arrays)[1]
                aux_equal = (cpu_aux is None) == (card_aux is None) and (
                    cpu_aux is None or torch.equal(cpu_aux, card_aux.cpu()))
                aux_s += time.monotonic() - t_aux
                if not aux_equal:
                    fail(f"{label}: the Stage-A aux vector on the card "
                         f"{None if card_aux is None else card_aux.tolist()}"
                         f" differs from the plain versions' on the CPU "
                         f"{None if cpu_aux is None else cpu_aux.tolist()}")
                auxes.append(None if cpu_aux is None else cpu_aux.tolist())
            cpu_rows[dfa_mode, pf_mode] = np.concatenate(cpu)
            aux_checked[f"{dfa_mode}/{pf_mode}"] = auxes
        cpu = cpu_rows[dfa_mode, pf_mode]
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
        pipe = service.pipeline_snapshot()
        print(f"{label}: {N_REQUESTS} verdicts equal the oracle and the CPU "
              f"path; {N_REQUESTS / wall:.0f} req/s, batch p50 "
              f"{np.percentile(ms, 50):.2f} ms p99 "
              f"{np.percentile(ms, 99):.2f} ms over {len(ms)} batches "
              f"(p50 ms: {stages}); launches {counts}"
              + (f"; depth {pipe['depth']}, peak in flight "
                 f"{service._pipe.peak_inflight}, overlap_ratio "
                 f"{pipe['overlap_ratio']} over {pipe['overlap_events']} "
                 f"events, occupancy {pipe['stage_occupancy']}, in-issue "
                 f"syncs {syncs.summary(len(ms))}; verdict issue of the "
                 f"warm-up's batches one at a time: p50 "
                 f"{alone['p50_ms']:.3f} ms, mean {alone['mean_ms']:.3f} ms "
                 f"over {alone['count']}" if main else ""),
              flush=True)
        if mega_mode == "force":
            mega["busy"] = profile_main_path(plan, lists, reqs, dev,
                                             service=service)
        if compact:
            compacts["staging" if staging == "compact" else "prefilter"][
                "busy"] = profile_main_path(plan, lists, reqs, dev,
                                            service=service)
        os.environ.pop("PINGOO_MEGASTEP")
        os.environ.pop("PINGOO_MEGASTEP_K", None)
        os.environ.pop("PINGOO_STAGING")
    for name, c in compacts.items():
        print(f"compact {name} (slice phase, {c['label']}): verdicts equal "
              f"the main path's and the oracle; {c['req_per_s']:.0f} req/s; "
              f"staged {c['staged_bytes_per_request']:.1f} B a request "
              f"(full: {main_staging['staged_bytes_per_request']:.1f}); "
              f"encode p50 {c['encode_ms']['p50_ms']:.3f} ms mean "
              f"{c['encode_ms']['mean_ms']:.3f} ms a batch (full: p50 "
              f"{main_staging['encode_ms']['p50_ms']:.3f} mean "
              f"{main_staging['encode_ms']['mean_ms']:.3f}); verdict issue "
              f"p50 {c['verdict_ms']['p50_ms']:.3f} ms (full: "
              f"{main_staging['verdict_ms']['p50_ms']:.3f}); device busy "
              + (f"{c['busy']:.2f}%" if isinstance(c["busy"], float)
                 else str(c["busy"]))
              + f" under the profiler; caps {c['caps']}; launches "
              f"{c['launches']}", flush=True)
    print("Stage-A aux vectors [candidate rows, banks skipped, per bank "
          "candidates, per bank skipped] of each batch, equal on the card "
          f"and in the plain versions on the CPU (the card's calls and "
          f"the comparison {aux_s:.2f} s): " + json.dumps(aux_checked),
          flush=True)
    compacts["decode"] = decode_phase(plan, reqs, dev)
    os.environ["PINGOO_DFA"], os.environ["PINGOO_PREFILTER"] = MODES[0]
    profile_main_path(plan, lists, reqs, dev)
    os.environ.pop("PINGOO_DFA")
    os.environ.pop("PINGOO_PREFILTER")
    missing = [k for k in ("nfa_scan", "bitsplit_dfa", "prefilter")
               if main_counts.get(k, 0) == 0]
    if missing:
        fail(f"the main path launched no {missing} kernel")
    for k, mega in megas.items():
        g = mega["graphs"]
        print(f"megastep (slice phase, K={k} x {B // k} rows): warm-up "
              f"pass {mega['warm_s']:.2f} s with "
              f"{mega['warm_graphs']['captures']} captures "
              f"({mega['warm_graphs']['capture_ms_total']:.1f} ms, max "
              f"{mega['warm_graphs']['capture_ms_max']:.1f}); measured "
              f"pass {mega['req_per_s']:.0f} req/s, {g['replays']} replays "
              f"in all, {g['distinct_keys']} distinct graph keys, verdict "
              f"issue p50 {mega['verdict_ms']['p50_ms']:.3f} ms mean "
              f"{mega['verdict_ms']['mean_ms']:.3f} ms a batch (one at a "
              f"time in the warm-up, capture included: p50 "
              f"{mega['verdict_alone_ms']['p50_ms']:.3f} ms), launches "
              f"through replays {mega['launches']}, windows "
              f"{mega['snapshot']['windows']} of K {mega['snapshot']['k']}, "
              f"echo mismatches {mega['echo_mismatch']}, device busy "
              f"{mega['busy']}", flush=True)
    return main_counts, main_out, megas, compacts


def decode_phase(plan, reqs, dev) -> dict:
    """Compact staging's upload and device decode of one main-path batch
    (B rows of `reqs`), at the plan's caps and at PINGOO_STAGING_DEPTH=
    256: the packed buffer's one pinned copy and upload
    (`packed_tensor`) and `unpack_staged`, which makes each of the six
    string fields contiguous once (the NFA and DFA launchers take
    unit-stride rows), each timed by CUDA events; the decoded arrays
    must equal the full-staging arrays cut to the caps."""
    import numpy as np

    from pingoo_tpu_torch.engine.batch import (StagingEncoder,
                                               batch_tensors, packed_tensor,
                                               resolve_stage_caps,
                                               stage_overflow_thresholds)
    from pingoo_tpu_torch.engine.verdict import unpack_staged

    out = {}
    full = StagingEncoder(B, plan.field_specs, nbuf=1).encode_requests(
        reqs[:B], pad_to=B, into=0)
    full_dev = batch_tensors(full.arrays, dev)
    for depth in ("0", "256"):
        os.environ["PINGOO_STAGING"] = "compact"
        os.environ["PINGOO_STAGING_DEPTH"] = depth
        caps = resolve_stage_caps(plan)
        enc = StagingEncoder(B, plan.field_specs, nbuf=1, stage_caps=caps,
                             overflow_thresholds=stage_overflow_thresholds(
                                 plan, caps))
        os.environ.pop("PINGOO_STAGING")
        os.environ.pop("PINGOO_STAGING_DEPTH")
        b = enc.encode_requests(reqs[:B], pad_to=B, into=0)
        packed = packed_tensor(b.packed, dev)
        dec = unpack_staged(packed, b.layout)
        for key, t in dec.items():
            want = full_dev[key]
            if key.endswith("_bytes"):
                w = min(t.shape[1], want.shape[1])
                ok = bool((t[:, :w] == want[:, :w]).all()) \
                    and not bool(t[:, w:].any())
            else:
                ok = bool((t == want.to(t.dtype)).all())
            if not ok:
                fail(f"unpack_staged's {key} differs from full staging's "
                     f"at caps {caps}")
        contiguous = sum(1 for k, t in dec.items()
                         if k.endswith("_bytes") and t.is_contiguous())
        out[depth] = dict(
            caps=caps, width=b.layout.width, bytes=int(b.packed.nbytes),
            flagged=int(b.overflow.sum()),
            upload_ms=cuda_ms(lambda: packed_tensor(b.packed, dev), 15),
            decode_ms=cuda_ms(lambda: unpack_staged(packed, b.layout), 15),
            contiguous_fields=contiguous)
        print(f"compact decode (B={B}, PINGOO_STAGING_DEPTH={depth}): row "
              f"{b.layout.width} B, buffer {b.packed.nbytes} B, "
              f"{out[depth]['flagged']} rows flagged; one pinned copy and "
              f"upload {out[depth]['upload_ms']:.4f} ms, unpack_staged "
              f"{out[depth]['decode_ms']:.4f} ms ({contiguous} fields made "
              f"contiguous), equal to full staging cut to the caps",
              flush=True)
    return out


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

    def counted(batch, t_launch=None):
        served["batches"] += 1
        served["requests"] += len(batch)
        return evaluate_batch(batch, t_launch)

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
    # Batch dedup: a duplicate tuple of a batch rides its first's row.
    if (snap["batches"], snap["requests"]) != (
            served["batches"], served["requests"] + snap["dedup_hits"]):
        fail(f"config: stats.snapshot() counts {snap['batches']} batches "
             f"and {snap['requests']} requests ({snap['dedup_hits']} of "
             f"them duplicates), the service evaluated "
             f"{served['batches']} batches of {served['requests']} rows")
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


# -- the halo phase: the halo split (ops/nfa_scan.halo_split_scan) ------------

# The halo phase's knob sets: (label, environment read per call, plan
# compiled under PINGOO_NFA_SPLIT=1). On the corpus the whole url/path
# banks are not halo-compatible, so the two runtime knobs reach the halo
# split only through a split plan's @short sub-banks; on the default plan
# the strategy pin changes the route all the same (it turns PINGOO_DFA=
# auto's DFAs off, as in the JAX package).
HALO_KNOBS = (
    ("PINGOO_NFA_SPLIT=1", {}, True),
    ("PINGOO_NFA_SPLIT=1 PINGOO_SCAN_STRATEGY=halo",
     {"PINGOO_SCAN_STRATEGY": "halo"}, True),
    ("PINGOO_NFA_SPLIT=1 PINGOO_HALO_SPLIT=1", {"PINGOO_HALO_SPLIT": "1"},
     True),
    ("PINGOO_SCAN_STRATEGY=halo", {"PINGOO_SCAN_STRATEGY": "halo"}, False),
    ("PINGOO_HALO_SPLIT=1", {"PINGOO_HALO_SPLIT": "1"}, False),
)
# The executors each split-plan knob runs under: (PINGOO_PIPELINE,
# PINGOO_MEGASTEP); the default plan's knobs run under the first.
HALO_EXECUTORS = (("on", "off"), ("off", "off"), ("on", "force"))
# A split url/path bank runs its sub-banks' NFA scans and never the DFA,
# and the window banks run their correlator on the card: the kernels a
# split path must launch (it launches no DFA kernel).
HALO_NEED = ("nfa_scan", "prefilter")
# Lengths of the kernel batch's first url/path rows: on, just before and
# just after the @short banks' chunk boundaries at 2048 columns (k = 8,
# 256 columns a chunk), and the empty and one-byte rows.
HALO_BOUNDARY_LENS = (0, 1, 255, 256, 257, 511, 512, 513, 1791, 1792,
                      1793, 2047, 2048)


def compile_split(rules, lists, dev):
    """The corpus's plan compiled under PINGOO_NFA_SPLIT=1."""
    from pingoo_tpu_torch.compiler.plan import compile_ruleset

    os.environ["PINGOO_NFA_SPLIT"] = "1"
    try:
        return compile_ruleset(rules, lists, device=dev)
    finally:
        os.environ.pop("PINGOO_NFA_SPLIT")


def halo_kernel_phase(split, plan, reqs, dev, rng) -> dict:
    """The split plan's NFA launches on one batch at full width: the
    first B main-path requests, their url and path replaced by 2048-byte
    seeded rows with planted attacks (`field_batch`), the first rows'
    lengths HALO_BOUNDARY_LENS. The split verdict (PINGOO_PREFILTER=off,
    so that each sub-bank scans every row) must equal the default plan's
    on the same batch; each NFA launch it makes is captured and replayed
    through the kernel and the plain version (bit equality). Each @short
    launch must be a halo launch: B * k rows of H + Lc columns at per-row
    offsets i * Lc - H. Times the url @short halo launch, the same
    sub-bank over the unsplit rows and the url @rest launch (issued, and
    queued on the card), each beside its bound."""
    import torch

    from pingoo_tpu_torch.engine.batch import encode_requests
    from pingoo_tpu_torch.engine.verdict import make_verdict_fn
    from pingoo_tpu_torch.ops import nfa_scan

    arrays = dict(encode_requests(reqs[:B], split.field_specs).arrays)
    n_fixed = len(HALO_BOUNDARY_LENS)
    for f in ("url", "path"):
        width = split.field_specs[f]
        data, lens = field_batch(rng, width, dev)
        lens[:n_fixed] = torch.tensor(HALO_BOUNDARY_LENS, dtype=lens.dtype)
        live = torch.arange(width, device=dev)[None, :] < lens[:, None]
        arrays[f"{f}_bytes"] = (data * live).contiguous()
        arrays[f"{f}_len"] = lens
    keys = {id(t): k for k, t in split.np_tables.items()}
    real = nfa_scan.fused_scan_chunk
    calls = []

    def wrapped(tables, data, lengths, state, t_offset, pair=True):
        toff = t_offset.clone() if isinstance(t_offset, torch.Tensor) \
            else t_offset
        calls.append(dict(key=keys[id(tables)], pair=pair, args=(
            data.clone(), lengths.clone(), state.clone(), toff)))
        return real(tables, data, lengths, state, t_offset, pair=pair)

    os.environ["PINGOO_PREFILTER"] = "off"
    nfa_scan.fused_scan_chunk = wrapped
    try:
        got = make_verdict_fn(split)(split.np_tables, arrays)
    finally:
        nfa_scan.fused_scan_chunk = real
    want = make_verdict_fn(plan)(plan.np_tables, arrays)
    os.environ.pop("PINGOO_PREFILTER")
    if not torch.equal(got, want) or not bool(got.any()):
        fail(f"the split verdict on the full-width batch differs from the "
             f"default plan's in {int((got != want).any(dim=1).sum())} rows "
             f"({int(got.sum())} matches)")
    err = 0
    for c in calls:
        t = split.np_tables[c["key"]]
        err = max(err, max_abs_err([(
            real(t, *c["args"], pair=c["pair"]),
            nfa_scan.scan_chunk_plain(t, *c["args"], pair=c["pair"]))]))
    if err:
        fail(f"the NFA kernel disagrees with its plain version on a "
             f"captured split-path launch (max_abs_err {err})")
    shapes = {}
    for c in calls:
        t = split.np_tables[c["key"]]
        data, lens, _, toff = c["args"]
        shapes[c["key"]] = (int(data.shape[0]), int(data.shape[1]))
        if c["key"].endswith("@short"):
            L = split.field_specs[field_of(c["key"].split("@")[0])]
            k = nfa_scan.halo_split_k(t, L)
            H, Lc = int(t.max_footprint), L // k
            offs = (torch.arange(k, device=dev, dtype=torch.int32) * Lc
                    - H).repeat(B)
            if k < 2 or shapes[c["key"]] != (B * k, H + Lc) \
                    or not isinstance(toff, torch.Tensor) \
                    or not torch.equal(toff.to(torch.int32), offs):
                fail(f"{c['key']}: a launch of {shapes[c['key']]} rows x "
                     f"columns, not a halo launch of {B * k} x {H + Lc} "
                     f"from offset {-H}")
    if sorted(shapes) != ["nfa_path@rest", "nfa_path@short", "nfa_url@rest",
                          "nfa_url@short"] or len(calls) != 4:
        fail(f"the split verdict made the NFA launches {shapes} "
             f"({len(calls)} calls), not one per sub-bank")
    ts = split.np_tables["nfa_url@short"]
    short = next(c for c in calls if c["key"] == "nfa_url@short")
    rest = next(c for c in calls if c["key"] == "nfa_url@rest")
    runs = {
        "short_halo": (ts, short["args"]),
        "short_unsplit": (ts, (arrays["url_bytes"], arrays["url_len"],
                               nfa_scan.init_scan_state(
                                   B, ts.opt.shape[0], dev), 0)),
        "rest": (split.np_tables["nfa_url@rest"], rest["args"]),
    }
    card = card_line()
    out = dict(max_abs_err=err, launches_replayed=len(calls),
               shapes={k: list(v) for k, v in shapes.items()}, card=card)
    for name, (t, args) in runs.items():
        def fn(t=t, args=args):
            return real(t, *args)
        issued = cuda_ms(fn, 40)
        queued = queued_ms(fn, QUEUED_CALLS)
        work = nfa_work(t, args[0], args[1], args[3])
        bound, by = bound_ms(work)
        out[name] = dict(rows=int(args[0].shape[0]),
                         columns=int(args[0].shape[1]),
                         issued_us=issued * 1e3, queued_us=queued * 1e3,
                         bound_us=bound * 1e3, bound_by=by,
                         live_bytes=int(live_columns(
                             args[1], args[3], args[0].shape[1],
                             False).sum()))
        bank = "nfa_url@rest" if name == "rest" else "nfa_url@short"
        print(f"halo kernel {name} ({bank}, "
              f"{out[name]['rows']} x {out[name]['columns']}): issued "
              f"{issued * 1e3:.1f} us, queued on the card "
              f"{queued * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
              f"({by}), {out[name]['live_bytes']} live columns; {card}",
              flush=True)
    print(f"halo kernel: the split verdict on {B} full-width rows equals "
          f"the default plan's ({int(got.sum())} matches); {len(calls)} "
          f"NFA launches {out['shapes']} bit-equal to the plain version",
          flush=True)
    return out


def unsplit_args(t, args):
    """A captured halo launch's inputs (B * k rows of H + Lc columns at
    offsets i * Lc - H) as the same rows unsplit: ([B, k * Lc] bytes,
    [B] lengths, a fresh state, offset 0). Fails unless cutting those
    rows again gives back the captured chunks."""
    import torch
    import torch.nn.functional as F

    from pingoo_tpu_torch.ops import nfa_scan

    data, lens, _, toff = args
    H = int(t.max_footprint)
    Lc = int(data.shape[1]) - H
    n = int((toff == -H).sum())
    k = int(data.shape[0]) // n
    rows = data.view(n, k, H + Lc)[:, :, H:].reshape(n, k * Lc)
    if not torch.equal(F.pad(rows, (H, 0)).unfold(1, H + Lc, Lc)
                       .reshape(n * k, H + Lc), data):
        fail(f"a captured halo launch of {tuple(data.shape)} is not the "
             f"chunks of {n} rows of {k * Lc} columns")
    return (rows.contiguous(), lens.view(n, k)[:, 0].contiguous(),
            nfa_scan.init_scan_state(n, t.opt.shape[0], data.device), 0), k


def halo_route_phase(split, calls, dev, rng) -> dict:
    """The halo route against the unsplit scan of the same rows, both
    queued on the card beside their bounds: (a) the split main path's
    captured @short halo launches, grouped by sub-bank and staged width
    L, against the same sub-bank over the rows unsplit (`unsplit_args`);
    (b) the url @short sub-bank on `field_batch` rows at each bucket
    width from 32 to 2048, where the JAX package's rule (k =
    halo_split_k(bank, L, max_k=halo_k) > 1 and L // k + H below the base
    steps, halved for a pair strategy) takes the halo route or not.
    Returns per group and width the two times and which was faster."""
    import torch
    import torch.nn.functional as F

    from pingoo_tpu_torch.ops import nfa_scan

    real = nfa_scan.fused_scan_chunk
    card = card_line()

    def timed(t, runs):
        work = add_work(nfa_work(t, a[0], a[1], a[3]) for a in runs)
        us = queued_ms(lambda: [real(t, *a) for a in runs],
                       max(8, QUEUED_CALLS // len(runs))) * 1e3
        bound, by = bound_ms(work)
        return dict(queued_us=us, bound_us=bound * 1e3, bound_by=by,
                    shapes=sorted({f"{a[0].shape[0]}x{a[0].shape[1]}"
                                   for a in runs}))

    main = {}
    groups = {}
    for c in calls:
        if c["key"].endswith("@short"):
            t = split.np_tables[c["key"]]
            flat_args, k = unsplit_args(t, c["args"])
            L = int(flat_args[0].shape[1])
            groups.setdefault((c["key"], L, k), []).append(
                (c["args"], flat_args))
    if not groups:
        fail("the split main path made no @short halo launch")
    for (key, L, k), pairs in sorted(groups.items()):
        t = split.np_tables[key]
        halo = timed(t, [h for h, _ in pairs])
        whole = timed(t, [u for _, u in pairs])
        main[f"{key} L={L}"] = dict(k=k, launches=len(pairs), halo=halo,
                                    unsplit=whole,
                                    halo_faster=halo["queued_us"]
                                    < whole["queued_us"])
        print(f"halo route, split main path {key} at L={L} (k={k}, "
              f"{len(pairs)} launches): halo {halo['shapes']} queued "
              f"{halo['queued_us']:.1f} us (bound {halo['bound_us']:.2f}), "
              f"unsplit {whole['shapes']} {whole['queued_us']:.1f} us "
              f"(bound {whole['bound_us']:.2f}); {card}", flush=True)
    ts = split.np_tables["nfa_url@short"]
    strat = split.scan_plans["nfa_url"].short_strategy
    H = int(ts.max_footprint)
    widths = {}
    for L in (32, 64, 128, 256, 512, 1024, 2048):
        data, lens = field_batch(rng, L, dev)
        k = nfa_scan.halo_split_k(ts, L, max_k=strat.halo_k)
        base = (L + 1) // 2 if strat.pair else L
        rule = k > 1 and L // k + H < base
        flat_args = (data, lens,
                     nfa_scan.init_scan_state(B, ts.opt.shape[0], dev), 0)
        whole = timed(ts, [flat_args])
        row = dict(k=k, rule_takes_halo=rule, unsplit=whole)
        if k > 1:
            Lc = L // k
            chunks = (F.pad(data, (H, 0)).unfold(1, H + Lc, Lc)
                      .reshape(B * k, H + Lc).contiguous(),
                      lens[:, None].expand(B, k).reshape(B * k).contiguous(),
                      nfa_scan.init_scan_state(B * k, ts.opt.shape[0], dev),
                      (torch.arange(k, device=dev, dtype=torch.int32) * Lc
                       - H).repeat(B))
            row["halo"] = timed(ts, [chunks])
            row["halo_faster"] = row["halo"]["queued_us"] \
                < whole["queued_us"]
        widths[L] = row
        print(f"halo route, nfa_url@short at L={L} on {B} rows: the rule "
              f"{'takes' if rule else 'does not take'} the halo route "
              f"(k={k}, {L // k} + {H} against {base} base steps); "
              f"unsplit queued {whole['queued_us']:.1f} us (bound "
              f"{whole['bound_us']:.2f})"
              + (f", halo {B * k}x{H + L // k} {row['halo']['queued_us']:.1f}"
                 f" us (bound {row['halo']['bound_us']:.2f}): "
                 f"{'halo' if row['halo_faster'] else 'unsplit'} faster"
                 if k > 1 else "") + f"; {card}", flush=True)
    return dict(main_path=main, widths=widths, card=card)


def halo_service_arm(plan, lists, reqs, dev, oracle, main_out, label: str,
                     env: dict, pipe: str, mega: str,
                     profiled: bool = False) -> dict:
    """`reqs` through a VerdictService(max_batch=B) on `plan` under `env`,
    PINGOO_PIPELINE=`pipe` and PINGOO_MEGASTEP=`mega` (K = 1): a warm-up
    pass (under force, the warmed service itself, whose graphs it
    captured, serves the measured pass), then the measured pass with the
    kernels' launch counts set to 0 just before it and read just after.
    Every verdict must equal the main path's and the oracle's, and the
    pass must launch the kernels of HALO_NEED; `profiled` adds one pass
    under torch.profiler (the device time). Returns the arm's numbers."""
    import numpy as np

    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.ops import _build

    arm_env = dict(env, PINGOO_PIPELINE=pipe, PINGOO_MEGASTEP=mega)
    os.environ.update(arm_env)
    try:
        service = VerdictService(plan, lists, max_batch=B, device=dev)
        if mega == "force":
            service._mega_runner.capture_mode = "global"
        t0 = time.monotonic()
        for lo in range(0, N_REQUESTS, B):
            service.evaluate_batch(reqs[lo:lo + B])
        warm_s = time.monotonic() - t0
        if mega == "force":
            service._mega_runner.capture_mode = "thread_local"
        else:
            service = VerdictService(plan, lists, max_batch=B, device=dev)
        _build.reset_launch_counts()
        verdicts, wall = asyncio.run(serve(service, reqs))
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        busy = None
        if profiled:
            kernels, p_wall = profile_pass(service, reqs)
            busy_ms = sum(kernels.values()) / 1e3
            busy = dict(device_ms=busy_ms, wall_ms=p_wall * 1e3,
                        busy_pct=100 * busy_ms / (p_wall * 1e3)) \
                if busy_ms > 0 else "not measured"
    finally:
        for name in arm_env:
            os.environ.pop(name)
    matched = np.stack([v.matched for v in verdicts])
    act = np.array([v.action for v in verdicts])
    vb = np.array([v.verified_block for v in verdicts])
    o_act, o_vb = main_out[1], main_out[2]
    if (matched != main_out[0]).any() or (act != o_act).any() \
            or (vb != o_vb).any() or (matched != oracle).any():
        fail(f"halo arm {label} {pipe}/{mega}: "
             f"{int((matched != main_out[0]).any(axis=1).sum())} rows "
             f"differ from the main path's, "
             f"{int((matched != oracle).any(axis=1).sum())} from the "
             f"oracle, actions {int((act != o_act).sum())}")
    missing = [k for k in HALO_NEED if launches[k] == 0]
    if missing:
        fail(f"halo arm {label} {pipe}/{mega} launched no {missing} kernel")
    if mega == "force" and (service.mega_echo_mismatch or not
                            service.pipeline_snapshot()["megastep"][
                                "windows"]):
        fail(f"halo arm {label} under force ran no window or mismatched "
             f"{service.mega_echo_mismatch} epoch echoes")
    batches = -(-N_REQUESTS // B)
    return dict(label=label, pipeline=pipe, megastep=mega,
                req_per_s=N_REQUESTS / wall, warm_s=warm_s,
                launches=launches,
                launches_per_batch={k: n / batches
                                    for k, n in launches.items()},
                device=busy)


def halo_phase(plan, rules, lists, reqs, dev, oracle, main_out, rng) -> dict:
    """The halo split on the card: the corpus compiled under
    PINGOO_NFA_SPLIT=1, its NFA launches held and timed at full width
    (`halo_kernel_phase`), then the main-path stream on the Python plane
    under every knob of HALO_KNOBS (the split plan's under every executor
    of HALO_EXECUTORS), each verdict held to the main path's and the
    oracle's. The default plan's main path runs first and last, and with
    the split main path (PINGOO_NFA_SPLIT=1, on) once under the profiler,
    for their req/s and device time in one process; the split main
    path's NFA launches are captured and replayed (`main_path_phase`),
    its @short and its @rest launches apart. Returns the phase's
    numbers; `launches` are the split main path's."""
    t0 = time.monotonic()
    split = compile_split(rules, lists, dev)
    compile_s = time.monotonic() - t0
    entries = {k: (e.split, e.short_strategy.halo_k if e.short_strategy
                   else None) for k, e in split.scan_plans.items()}
    print(f"halo: split plan compiled in {compile_s:.1f} s, scan plans "
          f"{entries}, sub-bank words "
          + ", ".join(f"{k} {split.np_tables[k].num_words} (H "
                      f"{split.np_tables[k].max_footprint}, halo_ok "
                      f"{split.np_tables[k].halo_ok})"
                      for k in split.np_tables if "@" in k), flush=True)
    kernel = halo_kernel_phase(split, plan, reqs, dev, rng)
    # The split main path's own NFA launches (L = the batch's bucket),
    # replayed and timed per sub-bank kind.
    calls, launched = capture_main_path(split, lists, reqs, dev)
    if launched["nfa_scan"] != len(calls["nfa_scan"]):
        fail(f"the split main path made {len(calls['nfa_scan'])} NFA calls "
             f"and {launched['nfa_scan']} launches")
    for kind in ("@short", "@rest"):
        mine = [c for c in calls["nfa_scan"] if c["key"].endswith(kind)]
        m = main_path_phase(split, "nfa_scan", mine, len(mine),
                            label=f"split main path {kind}")
        if m.pop("max_abs_err") != 0:
            fail(f"the NFA kernel disagrees with its plain version on a "
                 f"captured split main-path {kind} launch")
        kernel[f"main_path{kind.replace('@', '_')}"] = m
    kernel["route"] = halo_route_phase(split, calls["nfa_scan"], dev, rng)
    arms = [halo_service_arm(plan, lists, reqs, dev, oracle, main_out,
                             "default", {}, "on", "off", profiled=True)]
    for label, env, on_split in HALO_KNOBS:
        for pipe, mega in (HALO_EXECUTORS if on_split
                           else HALO_EXECUTORS[:1]):
            arms.append(halo_service_arm(
                split if on_split else plan, lists, reqs, dev, oracle,
                main_out, label, env, pipe, mega,
                profiled=(label, pipe, mega) == (HALO_KNOBS[0][0], "on",
                                                 "off")))
    arms.append(halo_service_arm(plan, lists, reqs, dev, oracle, main_out,
                                 "default", {}, "on", "off"))
    for a in arms:
        print(f"halo arm {a['label']} PINGOO_PIPELINE={a['pipeline']} "
              f"PINGOO_MEGASTEP={a['megastep']}: {N_REQUESTS} verdicts "
              f"equal the main path's and the oracle; "
              f"{a['req_per_s']:.0f} req/s (warm-up pass "
              f"{a['warm_s']:.2f} s), launches {a['launches']} ("
              + ", ".join(f"{k} {v:.2f}"
                          for k, v in a["launches_per_batch"].items())
              + " a batch)"
              + (f", device {a['device']}" if a["device"] else ""),
              flush=True)
    split_main = arms[1]
    defaults = [arms[0], arms[-1]]
    print(f"halo: split main path {split_main['req_per_s']:.0f} req/s "
          f"against the default's {defaults[0]['req_per_s']:.0f} and "
          f"{defaults[1]['req_per_s']:.0f} (before and after, one "
          f"process); device time a pass {split_main['device']} against "
          f"{defaults[0]['device']}; {time.monotonic() - t0:.1f} s in all; "
          f"{card_line()}", flush=True)
    return dict(kernel=kernel, arms=arms, launches=split_main["launches"],
                compile_s=compile_s, phase_s=time.monotonic() - t0)


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


# The ring phase's staging pair: bench.py's `bench_staging` streams
# (generate_traffic(8192), seeds 22 warm and 21 measured, each with its
# long-URL tail) under PINGOO_STAGING_DEPTH=256; the crc32 of the
# measured stream's verdict bytes is the JAX package's under full and
# compact staging alike (BENCH_staging.json).
STAGING_REQUESTS = 8192
STAGING_DEPTH = "256"
STAGING_CHECKSUM = 3631441880
STAGING_TAIL_EVERY = 200
STAGING_TAIL_PAD = 1800
# arm -> (PINGOO_STAGING, PINGOO_MEGASTEP); the force arm at K=4.
STAGING_ARMS = {"full": ("full", "off"), "compact": ("compact", "off"),
                "compact_force": ("compact", "force")}


def tail_requests(reqs, seed: int):
    """bench.py's long-URL tail (`_staging_bench_child._tail`): one
    request of every STAGING_TAIL_EVERY gets a url and a path of about
    STAGING_TAIL_PAD more bytes (at most 2,040)."""
    rng = random.Random(seed)
    out = list(reqs)
    for i in range(0, len(out), STAGING_TAIL_EVERY):
        j = min(len(out) - 1, i + rng.randrange(STAGING_TAIL_EVERY))
        r = out[j]
        pad = "".join(rng.choice("abcdefgh") for _ in range(STAGING_TAIL_PAD))
        out[j] = dataclasses.replace(r, url=(r.path + "?q=" + pad)[:2040],
                                     path=(r.path + "/" + pad)[:2040])
    return out


def ring_producer(path: str) -> int:
    """The data plane's side, in a process of its own as the httpd is:
    attach the ring at `path`; for each line "seed requests every tail"
    read from stdin, drive generate_traffic(requests, seed) of the ring
    phase's set-up through the ring (with `tail_requests(.., tail)` when
    tail is not 0), every `every`-th request with a body of
    `body_ring_bodies` (none when 0), and write the drive as one JSON
    line. A fifth field of 1 drives `swap_ring_requests()` instead. Ends
    at the end of stdin."""
    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    _, lists = generate_ruleset(500, with_lists=True, list_sizes=(4096, 512))
    ring = nr.Ring(path, capacity=RING_CAPACITY)
    try:
        swap_reqs = None
        for line in sys.stdin:
            seed, n, every, tail, *swap = map(int, line.split())
            if swap and swap[0]:
                if swap_reqs is None:
                    swap_reqs = swap_ring_requests()
                reqs = swap_reqs
            else:
                reqs = generate_traffic(n, lists=lists, seed=seed)
            if tail:
                reqs = tail_requests(reqs, tail)
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

    def drive(self, seed: int, n: int = RING_REQUESTS, every: int = 0,
              tail: int = 0, swap: int = 0):
        from pingoo_tpu_torch import native_ring as nr

        self.proc.stdin.write(f"{seed} {n} {every} {tail} {swap}\n")
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


class SyncTimer:
    """Times the host syncs inside a batch's issue (engine/verdict.py):
    Stage B's one `.tolist()` of the banks' candidate flags and each
    `torch.nonzero` of `compact_rows`, on CUDA tensors, by wrapping
    both for the duration of a `with` block. `ms` holds one entry per
    call; the wrappers cost microseconds against syncs of milliseconds."""

    def __init__(self):
        self.ms = {"stage_b_tolist": [], "compact_rows_nonzero": []}

    def __enter__(self):
        import torch

        self._orig = (torch.Tensor.tolist, torch.nonzero)
        tolist, nonzero = self._orig
        ms = self.ms

        def timed_tolist(t, *args, **kwargs):
            if not t.is_cuda:
                return tolist(t, *args, **kwargs)
            t0 = time.perf_counter()
            out = tolist(t, *args, **kwargs)
            ms["stage_b_tolist"].append((time.perf_counter() - t0) * 1e3)
            return out

        def timed_nonzero(t, *args, **kwargs):
            if not t.is_cuda:
                return nonzero(t, *args, **kwargs)
            t0 = time.perf_counter()
            out = nonzero(t, *args, **kwargs)
            ms["compact_rows_nonzero"].append(
                (time.perf_counter() - t0) * 1e3)
            return out

        torch.Tensor.tolist, torch.nonzero = timed_tolist, timed_nonzero
        return self

    def __exit__(self, *exc):
        import torch

        torch.Tensor.tolist, torch.nonzero = self._orig

    def summary(self, batches: int) -> dict:
        import numpy as np

        return {k: {"calls": len(v),
                    "p50_ms": float(np.percentile(v, 50)) if v else 0.0,
                    "max_ms": max(v, default=0.0),
                    "ms_per_batch": sum(v) / max(batches, 1)}
                for k, v in self.ms.items()}


def ring_drive(sidecar, drive, want, profiled: bool = False,
               checksum: int = RING_CHECKSUM, need=None) -> dict:
    """Run `drive()` (-> DriveResult) with the kernels' launch counts set
    to 0 just before and read just after; hold the verdicts to the
    checksum, to `want` (byte for byte, in stream order; None: the
    checksum alone), the heartbeat's age to the data plane's limit and
    each kernel of `need` (default: all three) to one launch or more.
    Unprofiled drives time the in-issue syncs (`SyncTimer`). Returns the
    drive's numbers, the bytes staged and depth-overflow rows included."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pingoo_tpu_torch.ops import _build

    b0 = sidecar.batches
    staged0 = sidecar.staged_bytes
    over0 = sidecar.depth_overflow_rows
    s0 = {k: v.count for k, v in sidecar.stage_ms.items()}
    g0 = sidecar.stats()["megastep"]["graphs"]
    syncs = SyncTimer()
    _build.reset_launch_counts()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = drive()
            torch.cuda.synchronize()
    else:
        with syncs:
            r = drive()
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    batches = sidecar.batches - b0
    n = len(r.actions)
    if r.checksum != checksum:
        fail(f"ring drive checksum {r.checksum}, not {checksum}")
    if want is not None and r.actions != want:
        bad = sum(a != b for a, b in zip(r.actions, want))
        fail(f"{bad} ring verdict bytes differ from VerdictService's")
    if r.max_heartbeat_age_ms >= HEARTBEAT_LIMIT_MS:
        fail(f"the heartbeat aged {r.max_heartbeat_age_ms} ms during a "
             f"drive (the data plane fails open at {HEARTBEAT_LIMIT_MS})")
    missing = [k for k, n in launches.items() if n == 0
               and (need is None or k in need)]
    if missing:
        fail(f"the ring drive launched no {missing} kernel")
    waits = np.array(r.waits_ms)
    out = dict(
        req_per_s=n / r.seconds, seconds=r.seconds,
        wait_p50_ms=float(np.percentile(waits, 50)),
        wait_p99_ms=float(np.percentile(waits, 99)), batches=batches,
        rows_per_batch=n / batches,
        staged_bytes_per_request=(sidecar.staged_bytes - staged0) / n,
        depth_overflow_rows=sidecar.depth_overflow_rows - over0,
        stage_p50_ms={k: float(np.percentile(v.since(s0[k]), 50))
                      for k, v in sidecar.stage_ms.items()},
        max_heartbeat_age_ms=r.max_heartbeat_age_ms, checksum=r.checksum,
        launches=launches,
        launches_per_batch={k: n / batches for k, n in launches.items()},
        verdict_issue_ms_per_batch=sum(
            sidecar.stage_ms["verdict"].since(s0["verdict"])) / batches)
    if g0 is not None:
        # The megastep: windows, graph captures and replays in the drive.
        g1 = sidecar.stats()["megastep"]["graphs"]
        out["megastep"] = dict(
            windows=len(sidecar.stage_ms["window"].since(s0["window"])),
            captures=g1["captures"] - g0["captures"],
            capture_ms=round(g1["capture_ms_total"]
                             - g0["capture_ms_total"], 3),
            replays=g1["replays"] - g0["replays"],
            distinct_keys=g1["distinct_keys"],
            window_p50_ms=float(np.percentile(
                sidecar.stage_ms["window"].since(s0["window"]), 50)))
    if not profiled:
        out["issue_syncs"] = syncs.summary(batches)
    if profiled:
        busy_ms = sum(device_time_us(prof).values()) / 1e3
        out["device_busy_ms"] = busy_ms if busy_ms > 0 else "not measured"
        out["device_busy_pct"] = 100 * busy_ms / (r.seconds * 1e3) \
            if busy_ms > 0 else "not measured"
    return out


def sidecar_metrics(sidecar, label: str) -> dict:
    """The sidecar's registry, scraped with its drain loop idle: each
    `pingoo_ring_*` value and the wait histogram's buckets must be its
    rings' `ring_telemetry()`, the text must lint clean, and the
    prefilter counters must have moved. Returns the registry's sidecar
    series."""
    from pingoo_tpu_torch.obs.registry import lint_prometheus_text

    t0 = time.monotonic()
    reg = sidecar._registry
    text = reg.prometheus_text()
    snap = reg.json_snapshot()
    t = sidecar.ring_telemetry()
    lab = "plane=sidecar"
    wait = snap["pingoo_verdict_wait_ms"][lab]
    got = {f: snap[f"pingoo_ring_{f}" + ("" if f.startswith("depth")
                                          else "_total")][lab]
           for f in ("enqueued", "dequeued", "enqueue_full",
                     "verdicts_posted", "verdict_post_full", "depth",
                     "depth_hwm")}
    want = {f: t[f] for f in got}
    problems = lint_prometheus_text(text)
    cum = list(wait["buckets"].values())
    if got != want or cum != [sum(t["wait_hist"][:i + 1])
                              for i in range(len(t["wait_hist"]))] \
            or wait["sum"] != round(float(t["wait_sum_ms"]), 6) \
            or problems or not snap["pingoo_scan_banks_skipped_total"][lab] \
            and not snap["pingoo_prefilter_candidate_rate"][lab]:
        fail(f"{label}: the registry's ring series {got}, wait buckets "
             f"{cum} sum {wait['sum']}, against ring_telemetry() {want}, "
             f"{t['wait_hist']} sum {t['wait_sum_ms']}; lint {problems[:5]}; "
             f"prefilter counters "
             f"{snap['pingoo_scan_banks_skipped_total'][lab]}, "
             f"{snap['pingoo_prefilter_candidate_rate'][lab]}")
    return dict(ring=got, wait_count=wait["count"],
                banks_skipped=snap["pingoo_scan_banks_skipped_total"][lab],
                candidate_rate=snap["pingoo_prefilter_candidate_rate"][lab],
                dfa_banks=snap["pingoo_dfa_banks_total"],
                staged_bytes=snap["pingoo_staged_bytes_total"],
                text_bytes=len(text), seconds=time.monotonic() - t0)


def ring_arm(ring, producer, plan, lists, want, dev, mode: str,
             megastep: str = "off", max_batch: int = B, quick: bool = False,
             need=None) -> dict:
    """One arm of the ring phase: a RingSidecar(max_batch,
    pipeline_depth=3) under PINGOO_PIPELINE=`mode` and
    PINGOO_MEGASTEP=`megastep` drains the ring in a thread while the
    producer drives the warm stream, then the measured one (and under
    `on` the measured one again under torch.profiler); then the sidecar
    stops. A `quick` arm drives the measured stream once, with no warm
    stream before it (the process's earlier arms have warmed the card),
    and is not held to two batches in flight.
    `need` names the kernels each drive must launch (`ring_drive`).
    Returns the arm's numbers."""
    import threading

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.obs.perf import get_compile_ledger
    from pingoo_tpu_torch.obs.registry import MetricRegistry

    label = f"ring arm {mode}/{megastep} max_batch {max_batch}" + (
        " (halo split)" if need == HALO_NEED else "")
    mark = ledger_mark()
    os.environ["PINGOO_PIPELINE"] = mode
    os.environ["PINGOO_MEGASTEP"] = megastep
    try:
        sidecar = nr.RingSidecar(ring, plan, lists, max_batch=max_batch,
                                 device=dev, pipeline_depth=3,
                                 registry=MetricRegistry())
    finally:
        os.environ.pop("PINGOO_PIPELINE")
        os.environ.pop("PINGOO_MEGASTEP")
    if sidecar.pipeline_mode != mode:
        fail(f"the sidecar runs {sidecar.pipeline_mode}, not {mode}")
    t_arm = time.monotonic()
    warm_up = None
    ledger = {}
    if megastep == "force":
        # As the native plane does before its httpd enqueues: under force
        # one window of each K the loop ships, narrow and wide, each
        # capturing its graph.
        warm_up = dict(windows=sidecar.warm_up(),
                       graphs=sidecar.stats()["megastep"]["graphs"])
        ledger["warm_up"] = ledger_counts(mark)
        ledger_line(f"{label} after warm_up()", ledger["warm_up"])
    mark_drive = ledger_mark()
    thread = threading.Thread(target=sidecar.run, daemon=True)
    thread.start()
    try:
        t0 = time.monotonic()
        if not quick:
            producer.drive(12)
        warm_s = time.monotonic() - t0
        if warm_up is not None:
            warm_up["warm_drive_captures"] = sidecar.stats()["megastep"][
                "graphs"]["captures"] - warm_up["graphs"]["captures"]
        drives = [ring_drive(sidecar, lambda: producer.drive(11), want,
                             profiled, need=need)
                  for profiled in ((False, True) if mode == "on"
                                   and not quick else (False,))]
        metrics = sidecar_metrics(sidecar, f"ring arm {mode}/{megastep}")
    finally:
        sidecar.stop()
        thread.join(timeout=30)
    if thread.is_alive():
        fail(f"the {mode} sidecar's drain loop did not stop")
    # Captures under traffic: the graph keys the warm_up() did not reach.
    ledger["drives"] = ledger_counts(mark_drive)
    ledger_line(f"{label} after its drives (captures under traffic after "
                f"warm_up())", ledger["drives"])
    # The arm's registry counted exactly the arm's compile events.
    own = compile_totals(sidecar._registry)
    want = {}
    for e in get_compile_ledger().snapshot()["events"][mark:]:
        k = (e["plane"], e["fn"], e["kind"])
        want[k] = want.get(k, 0) + 1
    if own != want:
        fail(f"{label}: the arm's registry counted compiles {own}, the "
             f"ledger {want}")
    for k, n in own.items():
        _OWN_REGISTRY_COMPILES[k] = _OWN_REGISTRY_COMPILES.get(k, 0) + n
    stats = sidecar.stats()
    pipe = stats["pipeline"]
    peak = sidecar._pipe.peak_inflight
    if mode == "on" and peak < 2 and not quick:
        fail(f"the on arm never had two batches in flight (peak {peak})")
    if megastep == "force":
        mega = stats["megastep"]
        if mega["echo_mismatch"] or not mega["windows"]:
            fail(f"the megastep arm ran {mega['windows']} windows with "
                 f"{mega['echo_mismatch']} epoch echo mismatches")
        if max_batch == RING_MANY_SLICES and drives[0]["batches"] <= 40:
            fail(f"the megastep arm's measured drive split into "
                 f"{drives[0]['batches']} slices, not more than 40")
    return dict(mode=mode, megastep=megastep, max_batch=max_batch,
                depth=sidecar.pipeline_depth, warm_up=warm_up, warm_s=warm_s,
                arm_s=time.monotonic() - t_arm,
                processed=sidecar.processed, peak_inflight=peak,
                pipeline=pipe, megastep_stats=stats["megastep"],
                graph_keys=(sorted(sidecar._mega_runner.keys)
                            if megastep == "force" else None),
                metrics=metrics, drives=drives, ledger=ledger)


def staging_arm(ring, producer, plan, lists, dev, staging: str,
                megastep: str = "off") -> dict:
    """One arm of the ring phase's staging pair: a RingSidecar(max_batch=
    B, pipeline_depth=3) under PINGOO_PIPELINE=on,
    PINGOO_STAGING=`staging`, PINGOO_STAGING_DEPTH=256 (which full
    staging ignores) and PINGOO_MEGASTEP=`megastep` (after `warm_up()`
    under force) drains the ring while the producer drives bench.py's
    warm staging stream, then the measured one, which must give
    STAGING_CHECKSUM. Returns the arm's numbers."""
    import threading

    from pingoo_tpu_torch import native_ring as nr

    env = {"PINGOO_PIPELINE": "on", "PINGOO_MEGASTEP": megastep,
           "PINGOO_STAGING": staging, "PINGOO_STAGING_DEPTH": STAGING_DEPTH}
    label = f"ring staging arm {staging}/{megastep}"
    mark = ledger_mark()
    os.environ.update(env)
    try:
        sidecar = nr.RingSidecar(ring, plan, lists, max_batch=B,
                                 device=dev, pipeline_depth=3)
    finally:
        for name in env:
            os.environ.pop(name)
    t_arm = time.monotonic()
    warm_up = None
    ledger = {}
    if megastep == "force":
        warm_up = dict(windows=sidecar.warm_up(),
                       graphs=sidecar.stats()["megastep"]["graphs"])
        ledger["warm_up"] = ledger_counts(mark)
        ledger_line(f"{label} after warm_up()", ledger["warm_up"])
    mark_drive = ledger_mark()
    thread = threading.Thread(target=sidecar.run, daemon=True)
    thread.start()
    try:
        t0 = time.monotonic()
        producer.drive(22, STAGING_REQUESTS, 0, 2)
        warm_s = time.monotonic() - t0
        drive = ring_drive(
            sidecar, lambda: producer.drive(21, STAGING_REQUESTS, 0, 1),
            None, checksum=STAGING_CHECKSUM)
    finally:
        sidecar.stop()
        thread.join(timeout=30)
    if thread.is_alive():
        fail(f"the staging arm's ({staging}, {megastep}) drain loop did "
             f"not stop")
    ledger["drives"] = ledger_counts(mark_drive)
    ledger_line(f"{label} after its drives (captures under traffic after "
                f"warm_up())", ledger["drives"])
    stats = sidecar.stats()
    if megastep == "force" and (stats["megastep"]["echo_mismatch"]
                                or not stats["megastep"]["windows"]):
        fail(f"the compact megastep arm ran {stats['megastep']['windows']} "
             f"windows with {stats['megastep']['echo_mismatch']} epoch "
             f"echo mismatches")
    return dict(staging=staging, megastep=megastep, caps=sidecar.stage_caps,
                warm_up=warm_up, warm_s=warm_s,
                arm_s=time.monotonic() - t_arm, drive=drive,
                peak_inflight=sidecar._pipe.peak_inflight,
                megastep_stats=stats["megastep"],
                graph_keys=(sorted(sidecar._mega_runner.keys)
                            if megastep == "force" else None),
                ledger=ledger)


def sidecar_cost_ledger(ring, producer, rules, lists, plan, want,
                        dev) -> dict:
    """The sidecar's durable cost ledger, in a file of its own: a
    sidecar that finds none reloads `missing`, drains the measured
    stream once and saves its costs at stop(), which must be the file's
    one `cuda|sidecar` entry; a new sidecar on the same plan reloads
    `ok` with exactly those costs; one on the corpus without its last
    rule (another fingerprint) `stale`. Prints the first batch's
    estimate before and after the reload beside the seed."""
    import threading

    import torch

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.sched.scheduler import DEFAULT_SEED_MS

    t0 = time.monotonic()
    name = f"{torch.device(dev).type}|sidecar"
    with cost_ledger_at("sidecar") as path:
        first = nr.RingSidecar(ring, plan, lists, max_batch=B, device=dev)
        before = first.sched.cost.estimate(B)
        thread = threading.Thread(target=first.run, daemon=True)
        thread.start()
        try:
            drive = ring_drive(first, lambda: producer.drive(11), want)
        finally:
            first.stop()
            thread.join(timeout=30)
        if thread.is_alive():
            fail("the cost-ledger sidecar's drain loop did not stop")
        saved = first.sched.cost.snapshot()
        with open(path) as f:
            entries = json.load(f)["entries"]
        entry = entries.get(name) or {}
        if set(entries) != {name} or entry["fingerprint"] != first._plan_fp \
                or entry["cost"] != json.loads(json.dumps(saved)):
            fail(f"the sidecar's cost ledger holds {sorted(entries)}, not "
                 f"the stopped sidecar's {name} costs")
        again = nr.RingSidecar(ring, plan, lists, max_batch=B, device=dev)
        again.stop()
        after = again.sched.cost.estimate(B)
        if again.sched.cost.snapshot() != saved:
            fail("the reloaded sidecar's costs differ from the saved")
        dropped = nr.RingSidecar(
            ring, compile_ruleset(rules[:-1], lists, device=dev), lists,
            max_batch=B, device=dev)
        dropped.stop()
    results = {"first": first.cost_ledger_result,
               "same plan": again.cost_ledger_result,
               "one rule dropped": dropped.cost_ledger_result}
    want_results = {"first": "missing", "same plan": "ok",
                    "one rule dropped": "stale"}
    if results != want_results:
        fail(f"the sidecar's cost ledger reloads {results}, not "
             f"{want_results}")
    out = dict(results=results, fingerprints=dict(
        plan=first._plan_fp, dropped=dropped._plan_fp),
        estimate_ms_before=before, estimate_ms_after=after,
        seed_ms=DEFAULT_SEED_MS, ewma_ms=entry["cost"]["ewma_ms"],
        req_per_s=drive["req_per_s"], seconds=time.monotonic() - t0)
    print(f"sidecar cost ledger: {results}; fingerprints "
          f"{out['fingerprints']}; EWMA ms by rows {out['ewma_ms']}; "
          f"estimate of a {B}-row first batch {before:.2f} ms before the "
          f"reload (seed {DEFAULT_SEED_MS}) and {after:.2f} ms after it "
          f"({RING_REQUESTS} requests drained, {drive['req_per_s']:.0f} "
          f"req/s, {out['seconds']:.1f} s) [{card()}]", flush=True)
    return out


def ring_phase() -> int:
    """The native plane on the card: the ring library built from the
    port's copy, the 500-rule plan with its lists, a ring of
    RING_CAPACITY slots and `RingSidecar(max_batch=B)` in a thread. The
    producer runs in a child process, as the httpd does. Two arms on the
    same ring and producer, one sidecar each: PINGOO_PIPELINE=off (one
    batch at a time), then on (pipeline_depth=3, as bench.py's pipeline
    bench). Each drives a warm stream (`generate_traffic(seed=12)`) and
    the measured stream (seed=11); the on arm drives the measured stream
    again under torch.profiler. Each measured drive must give the JAX
    package's checksum, VerdictService's verdict on the card for every
    request, a heartbeat younger than the data plane's limit, and
    launches of all three kernels; the on arm must have had two or more
    batches in flight. Prints one JSON line {"ring": ...}, but no result
    line (it runs in a process of its own, so its profiler session is
    the process's first)."""
    import tempfile

    import torch

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine.batch import STRING_FIELDS
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
    arms = {}
    staging = {}
    halo = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring")
        ring = nr.Ring(path, capacity=RING_CAPACITY, create=True)
        try:
            producer = ChildProducer(path)
            try:
                for mode in ("off", "on"):
                    arms[mode] = ring_arm(ring, producer, plan, lists, want,
                                          dev, mode)
                # The megastep (K=4): windows of four max_batch slices,
                # then max_batch=256, where the stream splits into 64 or
                # more slices.
                arms["force"] = ring_arm(ring, producer, plan, lists, want,
                                         dev, "on", "force")
                arms["force_256"] = ring_arm(ring, producer, plan, lists,
                                             want, dev, "on", "force",
                                             max_batch=RING_MANY_SLICES)
                # The staging pair, and compact under the megastep.
                for arm, (mode, mega) in STAGING_ARMS.items():
                    staging[arm] = staging_arm(ring, producer, plan, lists,
                                               dev, mode, mega)
                # The halo split: the split plan under each knob and
                # executor, one measured drive each.
                split = compile_split(rules, lists, dev)
                for label, env, _ in HALO_KNOBS[:3]:
                    os.environ.update(env)
                    try:
                        for pipe, mega in HALO_EXECUTORS:
                            halo[f"{label} {pipe}/{mega}"] = ring_arm(
                                ring, producer, split, lists, want, dev,
                                pipe, mega, quick=True, need=HALO_NEED)
                    finally:
                        for name in env:
                            os.environ.pop(name)
                cost_ledger = sidecar_cost_ledger(ring, producer, rules,
                                                  lists, plan, want, dev)
                producer.close()
                time.sleep(0.2)
                if ring.poll_verdict() is not None:
                    fail("a verdict arrived after every request had its own")
            finally:
                if producer.proc.poll() is None:
                    producer.proc.kill()
                    producer.proc.wait()
        finally:
            ring.close()
    for mode, arm in arms.items():
        pipe = arm["pipeline"]
        print(f"ring arm {mode}: PINGOO_PIPELINE={arm['mode']} "
              f"PINGOO_MEGASTEP={arm['megastep']} max_batch "
              f"{arm['max_batch']} (depth {arm['depth']}, {arm['arm_s']:.1f}"
              f" s, warm-up drive {arm['warm_s']:.2f} s): "
              f"peak in flight {arm['peak_inflight']}, overlap_ratio "
              f"{pipe['overlap_ratio']} over {pipe['overlap_events']} "
              f"events, stage occupancy {pipe['stage_occupancy']}"
              + (f", megastep {arm['megastep_stats']}, windows "
                 f"{pipe['megastep']}; warm_up() {arm['warm_up']}; graph "
                 f"keys (kind, k_ship, rows, widths of {STRING_FIELDS}) "
                 f"{arm['graph_keys']}"
                 if arm["megastep"] == "force" else ""), flush=True)
        for label, d in zip(("measured", "profiled"), arm["drives"]):
            print(f"  ring drive ({mode}, {label}): {RING_REQUESTS} "
                  f"requests, checksum {d['checksum']}, "
                  f"{d['req_per_s']:.0f} req/s, wait p50 "
                  f"{d['wait_p50_ms']:.2f} ms p99 {d['wait_p99_ms']:.2f} ms, "
                  f"{d['batches']} batches of {d['rows_per_batch']:.1f} rows, "
                  f"stage p50 ms {d['stage_p50_ms']}, heartbeat age max "
                  f"{d['max_heartbeat_age_ms']} ms, launches {d['launches']}"
                  + f", verdict issue {d['verdict_issue_ms_per_batch']:.3f}"
                  f" ms a batch"
                  + (f", megastep {d['megastep']}" if "megastep" in d
                     else "")
                  + (f", in-issue syncs {d['issue_syncs']}"
                     if "issue_syncs" in d else "")
                  + (f", device busy {d['device_busy_ms']} ms = "
                     f"{d['device_busy_pct']}% of the wall"
                     if "device_busy_pct" in d else ""), flush=True)
    # Every arm of the staging pair re-serves the measured stream's rows
    # past a clamped cap: with the corpus's caps at depth 256, those whose
    # url or path passes 256 bytes.
    tail = tail_requests(generate_traffic(STAGING_REQUESTS, lists=lists,
                                          seed=21), 1)
    over = sum(1 for r in tail if max(len(r.url.encode("latin-1")),
                                      len(r.path.encode("latin-1"))) > 256)
    for arm, st in staging.items():
        d = st["drive"]
        want_over = 0 if st["staging"] == "full" else over
        if d["depth_overflow_rows"] != want_over:
            fail(f"staging arm {arm}: {d['depth_overflow_rows']} "
                 f"depth-overflow rows re-served, not {want_over}")
        print(f"ring staging arm {arm}: PINGOO_STAGING={st['staging']} "
              f"PINGOO_STAGING_DEPTH={STAGING_DEPTH} PINGOO_MEGASTEP="
              f"{st['megastep']} (caps {st['caps']}; {st['arm_s']:.1f} s, "
              f"warm drive {st['warm_s']:.2f} s): {STAGING_REQUESTS} "
              f"requests, checksum {d['checksum']}, {d['req_per_s']:.0f} "
              f"req/s, wait p50 {d['wait_p50_ms']:.2f} ms p99 "
              f"{d['wait_p99_ms']:.2f} ms, staged "
              f"{d['staged_bytes_per_request']:.1f} B a request, "
              f"depth-overflow rows {d['depth_overflow_rows']}, "
              f"{d['batches']} batches of {d['rows_per_batch']:.1f} rows, "
              f"stage p50 ms {d['stage_p50_ms']}, verdict issue "
              f"{d['verdict_issue_ms_per_batch']:.3f} ms a batch, heartbeat "
              f"age max {d['max_heartbeat_age_ms']} ms, launches "
              f"{d['launches']}, peak in flight {st['peak_inflight']}"
              + (f"; megastep {d['megastep']}, warm_up() {st['warm_up']}, "
                 f"{len(st['graph_keys'])} distinct graph keys "
                 f"{st['graph_keys']}" if st["megastep"] == "force" else ""),
              flush=True)
    for label, arm in halo.items():
        d = arm["drives"][0]
        print(f"ring halo arm {label} (max_batch {arm['max_batch']}, "
              f"{arm['arm_s']:.1f} s): {RING_REQUESTS} requests, checksum "
              f"{d['checksum']} and VerdictService's bytes, "
              f"{d['req_per_s']:.0f} req/s, wait p50 {d['wait_p50_ms']:.2f} "
              f"ms, {d['batches']} batches, heartbeat age max "
              f"{d['max_heartbeat_age_ms']} ms, launches {d['launches']}"
              + (f", megastep {d['megastep']}" if "megastep" in d else ""),
              flush=True)
    check_ladder("ring phase")
    ledger = ledger_check("ring phase's process")
    print(json.dumps({"ring": dict(
        requests=RING_REQUESTS, max_batch=B, capacity=RING_CAPACITY,
        rules=500, build_s=build_s, warm_s=arms["on"]["warm_s"],
        processed=arms["on"]["processed"], drives=arms["on"]["drives"],
        arms=arms, staging=staging, halo=halo, cost_ledger=cost_ledger,
        compile_ledger=ledger)}), flush=True)
    return 0


def ring_child() -> dict:
    """`ring_phase` in a process of its own; returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--ring-phase"],
        capture_output=True, text=True, timeout=900)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the ring phase exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print(f"ring phase: {time.monotonic() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["ring"]


# -- the sched phase: admission, the ladder and chaos (port queue item 9) -----

SCHED_ORACLE_N = 1024  # interpreter rows the Python arms are held to
SCHED_SEED_BATCH = 1024  # the port's max_batch default: the cost seed's batch
SCHED_SEED_REPS = 8
SCHED_SLACK_MS = "1000"  # a deadline that leaves slack on this card
# The ring's slack arm's max_batch: not a divisor of the stream's 16,384
# requests, so its last 1,024 arrive as a partial batch that continuous
# admission holds until its slack runs out, however fast the producer
# fills the ring (a producer ahead of the drain by a whole batch on
# every pass leaves the earlier batches nothing to hold).
SCHED_SLACK_BATCH = 1536
SCHED_ALLOW_MS = "500"  # lets the first batches of a burst in time
SCHED_RING_ALLOW_MS = "150"  # below the ring stream's wait p50
SCHED_PACE = (64, 0.004)  # the paced arm: 64 requests every 4 ms
SCHED_INTERPRET_N = 256  # requests of the `interpret` arm (the host serves)
SCHED_CHAOS_BATCH = RING_MANY_SLICES  # the chaos arms' max_batch
SCHED_BACKOFF_S = 1.1  # past the ladder's 1 s base backoff

LADDER_ERRORS: list = []  # (plane, rung, error) outside the chaos arms
_CHAOS_ARM = [0]


def guard_ladder() -> None:
    """Record every rung failure of this process's degradation ladders:
    outside a chaos arm any is a fault of the run (`check_ladder`)."""
    from pingoo_tpu_torch.engine import ladder

    orig = ladder.DegradationLadder.note_failure
    if getattr(orig, "guarded", False):
        return

    def note_failure(self, rung, exc=None):
        if not _CHAOS_ARM[0]:
            LADDER_ERRORS.append((self.plane, rung, repr(exc)))
        return orig(self, rung, exc)

    note_failure.guarded = True
    ladder.DegradationLadder.note_failure = note_failure


def check_ladder(label: str) -> None:
    if LADDER_ERRORS:
        fail(f"{label}: {len(LADDER_ERRORS)} ladder rung failures outside "
             f"the chaos arms: {LADDER_ERRORS[:4]}")
    print(f"{label}: 0 ladder rung errors and demotions", flush=True)


@contextlib.contextmanager
def sched_env(**env):
    """PINGOO_* variables for one arm (None unsets), restored after."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def chaos_arm():
    _CHAOS_ARM[0] += 1
    try:
        yield
    finally:
        _CHAOS_ARM[0] -= 1


def lane_bytes(verdicts) -> bytes:
    return bytes(v.action | (v.verified_block << 2) for v in verdicts)


def ladder_quiet(snap: dict, label: str) -> None:
    bad = {k: (r["errors"], r["demotions"]) for k, r in snap.items()
           if r["errors"] or r["demotions"]}
    if bad:
        fail(f"{label}: ladder rungs with errors or demotions {bad}")


def sched_seed(plan, lists, reqs, dev) -> dict:
    """The cost model's fallback seed: the wall of one full batch at the
    port's max_batch default through `evaluate_batch` (pipelined
    executor), median of SCHED_SEED_REPS after two warm-up batches."""
    import statistics as st

    from pingoo_tpu_torch.engine.service import VerdictService

    service = VerdictService(plan, lists, max_batch=SCHED_SEED_BATCH,
                             device=dev)
    walls = []
    for i in range(SCHED_SEED_REPS + 2):
        lo = (i * SCHED_SEED_BATCH) % (len(reqs) - SCHED_SEED_BATCH)
        t0 = time.monotonic()
        service.evaluate_batch(reqs[lo:lo + SCHED_SEED_BATCH])
        walls.append((time.monotonic() - t0) * 1e3)
    return dict(rows=SCHED_SEED_BATCH, walls_ms=walls[2:],
                median_ms=st.median(walls[2:]))


def py_arm(label, plan, lists, reqs, dev, want, oracle, env, paced=None):
    """One Python-plane arm: a VerdictService(max_batch=B) under `env`
    answers `reqs` through `evaluate` (all at once, or `paced` as (n,
    seconds): n requests every so many seconds); every verdict's lanes
    must equal `want` and the first rows the interpreter's `oracle`,
    except rows failed open under `allow` (action 0, degraded, each
    counted once). Kernel launch counts are set to 0 before the pass and
    read after. Returns the arm's numbers."""
    import numpy as np

    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.ops import _build

    with sched_env(**env):
        service = VerdictService(plan, lists, max_batch=B, device=dev)

    async def run():
        await service.start()
        try:
            t0 = time.monotonic()
            if paced is None:
                out = await asyncio.gather(*map(service.evaluate, reqs))
            else:
                n, gap = paced
                futs = []
                for lo in range(0, len(reqs), n):
                    futs += [asyncio.ensure_future(service.evaluate(r))
                             for r in reqs[lo:lo + n]]
                    await asyncio.sleep(gap)
                out = await asyncio.gather(*futs)
            return out, time.monotonic() - t0
        finally:
            await service.stop()

    _build.reset_launch_counts()
    verdicts, wall = asyncio.run(run())
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    snap = service.stats.snapshot()
    sched = snap["sched"]
    degraded = [v.degraded for v in verdicts]
    got = lane_bytes(verdicts)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a != b and not degraded[i]]
    if bad:
        fail(f"sched arm {label}: {len(bad)} verdicts differ from the "
             f"expected lanes (first {bad[:5]})")
    n_o = min(len(oracle), len(verdicts))
    rows = np.stack([v.matched for v in verdicts[:n_o]])
    keep = ~np.array(degraded[:n_o])
    if (rows[keep] != oracle[:n_o][keep]).any():
        fail(f"sched arm {label}: matched rows differ from the oracle")
    if any(degraded) and (sched["failopens"] != sum(degraded) or any(
            v.action or v.matched.any() for v in verdicts if v.degraded)):
        fail(f"sched arm {label}: {sum(degraded)} degraded verdicts, "
             f"{sched['failopens']} failed open")
    if env.get("PINGOO_SCHED_FAILOPEN") is None and any(degraded):
        fail(f"sched arm {label}: degraded verdicts under serve")
    ladder_quiet(snap["ladder"], f"sched arm {label}")
    batches = service.stats.batches
    mega = service.pipeline_snapshot()["megastep"]
    out = dict(requests=len(reqs), req_per_s=len(reqs) / wall,
               mode=sched["mode"], deadline_ms=sched["deadline_ms"],
               failopen=sched["failopen_policy"],
               launches=sched["launches"], batches=batches,
               rows_per_batch=(service.stats.requests / batches
                               if batches else 0.0),
               misses=sched["deadline_misses"],
               failopens=sched["failopens"],
               hold_ms=sched["admission"]["sched"],
               kernel_launches=launches, megastep=mega,
               graphs=(service._mega_runner.snapshot()
                       if service._mega_runner is not None else None),
               cost_model=sched["cost_model"])
    print(f"sched arm {label}: {len(reqs)} requests at {out['req_per_s']:.0f}"
          f" req/s, mode {out['mode']}, deadline {out['deadline_ms']} ms, "
          f"{out['failopen']}: {out['launches']} launches, {batches} batches "
          f"of {out['rows_per_batch']:.1f} rows, misses {out['misses']}, "
          f"failed open {out['failopens']}, hold p50/p99 "
          f"{out['hold_ms']['p50_ms']}/{out['hold_ms']['p99_ms']} ms, "
          f"launches {launches}"
          + (f", megastep {mega}, graphs {out['graphs']}"
             if mega["windows"] else ""), flush=True)
    return out


def sched_ring_arm(label, ring, producer, plan, lists, want, dev, env,
                   max_batch=B, drives=1, between=None, chaos=False,
                   warm=False):
    """One ring arm: a RingSidecar(max_batch, pipeline_depth=3) under
    `env` drains the ring while the producer drives the measured stream
    `drives` times (after the warm stream with `warm`; `between(sidecar,
    i)` runs before drive i > 0), each held by `ring_drive` (checksum,
    VerdictService's bytes unless failed open, heartbeat, kernel
    launches). Returns the arm's numbers."""
    import threading

    from pingoo_tpu_torch import native_ring as nr

    with sched_env(**env):
        sidecar = nr.RingSidecar(ring, plan, lists, max_batch=max_batch,
                                 device=dev, pipeline_depth=3)
    warm = None
    if sidecar._mega_runner is not None:
        warm = len(sidecar.warm_up())
    thread = threading.Thread(target=sidecar.run, daemon=True)
    thread.start()
    out = []
    t0 = time.monotonic()
    # The chaos arms' first drive may run without the DFAs (the dfa rung
    # demoted), so it need not launch the DFA kernel.
    need = ("nfa_scan", "prefilter") if chaos else None
    try:
        if warm:
            producer.drive(12)
        for i in range(drives):
            if i and between is not None:
                between(sidecar, i)
            allow = env.get("PINGOO_SCHED_FAILOPEN") == "allow"
            f0 = sidecar.sched.failopens
            if allow:
                r = producer.drive(11)
                zeroed = [k for k, (a, b) in enumerate(zip(r.actions, want))
                          if a != b]
                if any(r.actions[k] for k in zeroed) \
                        or len(zeroed) > sidecar.sched.failopens - f0 \
                        or r.max_heartbeat_age_ms >= HEARTBEAT_LIMIT_MS:
                    fail(f"sched ring arm {label}: {len(zeroed)} bytes off "
                         f"VerdictService's, {sidecar.sched.failopens - f0}"
                         f" failed open, heartbeat aged "
                         f"{r.max_heartbeat_age_ms} ms")
                out.append(dict(failopens=sidecar.sched.failopens - f0,
                                differing=len(zeroed),
                                max_heartbeat_age_ms=r.max_heartbeat_age_ms,
                                req_per_s=len(r.actions) / r.seconds))
            else:
                out.append(ring_drive(sidecar, lambda: producer.drive(11),
                                      want, need=need if i == 0 else None))
            out[-1]["ladder_demoted"] = sidecar.ladder.demoted()
    finally:
        sidecar.stop()
        thread.join(timeout=30)
    if thread.is_alive():
        fail(f"sched ring arm {label}: the drain loop did not stop")
    stats = sidecar.stats()
    if not chaos:
        ladder_quiet(stats["ladder"], f"sched ring arm {label}")
    if stats["megastep"]["echo_mismatch"]:
        fail(f"sched ring arm {label}: epoch echo mismatches")
    res = dict(max_batch=max_batch, warm_up=warm, drives=out,
               arm_s=time.monotonic() - t0, sched=stats["sched"],
               ladder={k: v for k, v in stats["ladder"].items()
                       if v["errors"]},
               chaos=stats["chaos"], megastep=stats["megastep"],
               pipeline_megastep=stats["pipeline"]["megastep"],
               hotswap_epoch=stats["hotswap"]["epoch"],
               processed=sidecar.processed, batches=sidecar.batches)
    d = out[-1]
    print(f"sched ring arm {label} (max_batch {max_batch}, "
          f"{res['arm_s']:.1f} s): mode {stats['sched']['mode']}, "
          f"deadline {stats['sched']['deadline_ms']} ms, "
          f"{stats['sched']['launches']} launches, {sidecar.batches} "
          f"batches of {sidecar.processed / max(sidecar.batches, 1):.1f} "
          f"rows, held passes {stats['sched']['held_passes']}, misses "
          f"{stats['sched']['deadline_misses']}, failed open "
          f"{stats['sched']['failopens']}; last drive "
          f"{ {k: v for k, v in d.items() if k in ('req_per_s', 'batches', 'rows_per_batch', 'max_heartbeat_age_ms', 'launches', 'megastep', 'failopens', 'differing', 'ladder_demoted')} }"
          f"; megastep {stats['pipeline']['megastep']}; ladder "
          f"{res['ladder']}; chaos {stats['chaos']}", flush=True)
    return res


def cost_ledger_python(rules, lists, plan, reqs, dev) -> dict:
    """The Python plane's durable cost ledger, in a file of its own: a
    service that finds none reloads `missing`, serves `reqs` and saves
    its costs at stop(); a new service on the same plan reloads `ok`
    with exactly those costs; one on the corpus without its last rule
    `stale`; one on generate_ruleset(500, seed=5) whatever the plans'
    fingerprints say (the recipe hashes rule names, caps, the DFA mode
    and the field specs: equal names and caps share an entry). Prints
    the first batch's estimate before and after the reload beside the
    seed."""
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.sched.scheduler import DEFAULT_SEED_MS
    from pingoo_tpu_torch.utils.crs import generate_ruleset

    t0 = time.monotonic()
    with cost_ledger_at("python") as path:
        first = VerdictService(plan, lists, max_batch=B, device=dev)
        before = first.sched.cost.estimate(B)
        verdicts, wall = asyncio.run(serve(first, reqs))
        saved = first.sched.cost.snapshot()
        again = VerdictService(plan, lists, max_batch=B, device=dev)
        after = again.sched.cost.estimate(B)
        results = {"first": first.cost_ledger_result,
                   "same plan": again.cost_ledger_result}
        if again.sched.cost.snapshot() != saved:
            fail("the reloaded Python plane's costs differ from the saved")
        dropped = VerdictService(compile_ruleset(rules[:-1], lists,
                                                 device=dev),
                                 lists, max_batch=B, device=dev)
        results["one rule dropped"] = dropped.cost_ledger_result
        r5, l5 = generate_ruleset(500, seed=5)
        seed5 = VerdictService(compile_ruleset(r5, l5, device=dev), l5,
                               max_batch=B, device=dev)
        results["seed 5"] = seed5.cost_ledger_result
        want = {"first": "missing", "same plan": "ok",
                "one rule dropped": "stale",
                "seed 5": "ok" if seed5._plan_fp == first._plan_fp
                else "stale"}
        if results != want:
            fail(f"the Python plane's cost ledger reloads {results}, not "
                 f"{want}")
        with open(path) as f:
            entries = json.load(f)["entries"]
        if set(entries) != {f"{first.device.type}|python"}:
            fail(f"the Python plane saved {sorted(entries)}")
    out = dict(results=results, fingerprints=dict(
        plan=first._plan_fp, dropped=dropped._plan_fp, seed5=seed5._plan_fp),
        estimate_ms_before=before, estimate_ms_after=after,
        seed_ms=DEFAULT_SEED_MS, served=len(verdicts), wall_s=wall,
        seconds=time.monotonic() - t0)
    print(f"python cost ledger: {results}; fingerprints {out['fingerprints']}"
          f"; estimate of a {B}-row first batch {before:.2f} ms before the "
          f"reload (seed {DEFAULT_SEED_MS}) and {after:.2f} ms after it "
          f"({len(verdicts)} requests served, {out['seconds']:.1f} s) "
          f"[{card()}]", flush=True)
    return out


def sched_phase() -> int:
    """`--sched-phase`, in a process of its own: admission, the
    degradation ladder and chaos on the card, on the ring phase's
    set-up (the 500-rule corpus with its lists, generate_traffic(16384,
    seed=11), whose lanes' crc32 is RING_CHECKSUM).

    The cost seed: one full batch at max_batch 1,024, timed. The Python
    plane (max_batch=B): `continuous` and `fixed` at the default
    deadline; a paced arm under a deadline with slack (batches hold past
    one pop); PINGOO_MEGASTEP=auto (K up to 4, slack: windows of K > 1
    through graph replays); `allow` under a deadline the later batches
    of a burst miss (those fail open, the rest as VerdictService); and
    `interpret` under an impossible one (the interpreter's rows). The
    ring: `continuous` and `fixed` at the default deadline, a deadline
    with slack at max_batch SCHED_SLACK_BATCH (passes held: at least the
    stream's partial last batch), `auto` (windows of K > 1), `allow`; then
    the chaos arms at max_batch 256: `xla_error:1` per batch and under
    `force` (the error demotes a rung and the interpreter serves, a
    probe after the backoff re-promotes it, and a third drive launches
    every kernel again), and `swap_storm` under `force` (every ticket
    once, heartbeat under 500 ms). Every arm but the chaos arms keeps
    every ladder rung at 0 errors and 0 demotions. Prints {"sched": ...}
    last."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    t_phase = time.monotonic()
    dev = torch.device("cuda")
    rules, lists = generate_ruleset(500, with_lists=True,
                                    list_sizes=(4096, 512))
    reqs = generate_traffic(RING_REQUESTS, lists=lists, seed=11)
    pool = ProcessPoolExecutor(
        SLICE_ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=slice_oracle_init, initargs=(rules, lists))
    chunk = -(-SCHED_ORACLE_N // SLICE_ORACLE_WORKERS)
    parts = [pool.submit(slice_oracle, reqs[i:i + chunk])
             for i in range(0, SCHED_ORACLE_N, chunk)]
    nr.build_ring_lib()
    _build.build()
    plan = compile_ruleset(rules, lists, device=dev)
    service = VerdictService(plan, lists, max_batch=B, device=dev)
    want = lane_bytes(v for lo in range(0, RING_REQUESTS, B)
                      for v in service.evaluate_batch(reqs[lo:lo + B]))
    if zlib.crc32(want) != RING_CHECKSUM:
        fail(f"VerdictService's lanes of the ring stream: crc32 "
             f"{zlib.crc32(want)}, not {RING_CHECKSUM}")
    seed = sched_seed(plan, lists, reqs, dev)
    print(f"sched seed: one batch of {seed['rows']} rows through "
          f"evaluate_batch, median {seed['median_ms']:.3f} ms of "
          f"{SCHED_SEED_REPS} ({[round(w, 3) for w in seed['walls_ms']]})",
          flush=True)
    oracle = np.concatenate([f.result() for f in parts])
    pool.shutdown()
    py, ring_arms = {}, {}
    py["continuous"] = py_arm("python continuous", plan, lists, reqs, dev,
                              want, oracle, {})
    py["fixed"] = py_arm("python fixed", plan, lists, reqs, dev, want,
                         oracle, {"PINGOO_SCHED_MODE": "fixed"})
    # The pair again in the other order: continuous, fixed, fixed,
    # continuous, so that neither holds the warmer place.
    py["fixed 2"] = py_arm("python fixed 2", plan, lists, reqs, dev, want,
                           oracle, {"PINGOO_SCHED_MODE": "fixed"})
    py["continuous 2"] = py_arm("python continuous 2", plan, lists, reqs,
                                dev, want, oracle, {})
    n_paced = 4096
    py["paced"] = py_arm("python paced", plan, lists, reqs[:n_paced], dev,
                         want[:n_paced], oracle,
                         {"PINGOO_DEADLINE_MS": SCHED_SLACK_MS},
                         paced=SCHED_PACE)
    if py["paced"]["rows_per_batch"] <= SCHED_PACE[0]:
        fail(f"the paced arm's batches held no longer than one arrival "
             f"({py['paced']['rows_per_batch']:.1f} rows a batch)")
    py["auto"] = py_arm("python auto", plan, lists, reqs, dev, want, oracle,
                        {"PINGOO_MEGASTEP": "auto", "PINGOO_MEGASTEP_K": "4",
                         "PINGOO_DEADLINE_MS": SCHED_SLACK_MS})
    mega = py["auto"]["megastep"]
    if not (mega["windows"] and mega["slices"] > mega["windows"]
            and py["auto"]["graphs"]["replays"]) or not all(
                py["auto"]["kernel_launches"].values()):
        fail(f"the Python auto arm ran no window of K > 1 through graph "
             f"replays: {mega}, {py['auto']['graphs']}")
    py["allow"] = py_arm("python allow", plan, lists, reqs, dev, want,
                         oracle, {"PINGOO_SCHED_FAILOPEN": "allow",
                                  "PINGOO_DEADLINE_MS": SCHED_ALLOW_MS})
    if not 0 < py["allow"]["failopens"] < RING_REQUESTS:
        fail(f"the allow arm failed open {py['allow']['failopens']} of "
             f"{RING_REQUESTS} requests, not some")
    py["interpret"] = py_arm(
        "python interpret", plan, lists, reqs[:SCHED_INTERPRET_N], dev,
        want[:SCHED_INTERPRET_N], oracle,
        {"PINGOO_SCHED_FAILOPEN": "interpret",
         "PINGOO_DEADLINE_MS": "0.000001"})
    if py["interpret"]["failopens"] != SCHED_INTERPRET_N:
        fail("the interpret arm did not serve every request on the host")
    cost_ledger = cost_ledger_python(rules, lists, plan, reqs, dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring")
        ring = nr.Ring(path, capacity=RING_CAPACITY, create=True)
        try:
            producer = ChildProducer(path)
            try:
                for label, env in (
                        ("continuous", {}),
                        ("fixed", {"PINGOO_SCHED_MODE": "fixed"}),
                        ("slack", {"PINGOO_DEADLINE_MS": SCHED_SLACK_MS}),
                        ("auto", {"PINGOO_MEGASTEP": "auto",
                                  "PINGOO_MEGASTEP_K": "4",
                                  "PINGOO_SCHED_MODE": "fixed",
                                  "PINGOO_DEADLINE_MS": "60000"}),
                        ("allow", {"PINGOO_SCHED_FAILOPEN": "allow",
                                   "PINGOO_DEADLINE_MS":
                                   SCHED_RING_ALLOW_MS}),
                        ("fixed 2", {"PINGOO_SCHED_MODE": "fixed"}),
                        ("continuous 2", {})):
                    ring_arms[label] = sched_ring_arm(
                        label, ring, producer, plan, lists, want, dev, env,
                        max_batch=SCHED_SLACK_BATCH if label == "slack"
                        else B, warm=label == "continuous")
                if ring_arms["slack"]["sched"]["held_passes"] == 0:
                    fail("the ring's slack arm held no pass")
                m = ring_arms["auto"]["pipeline_megastep"]
                d = ring_arms["auto"]["drives"][0]
                if not (m["windows"] and m["slices"] > m["windows"]
                        and d["megastep"]["replays"]):
                    fail(f"the ring's auto arm ran no window of K > 1 "
                         f"through graph replays: {m}, {d['megastep']}")
                if not 0 < ring_arms["allow"]["sched"]["failopens"]:
                    fail("the ring's allow arm failed nothing open")

                def backoff(sidecar, i):
                    time.sleep(SCHED_BACKOFF_S)

                with chaos_arm():
                    for label, mega in (("xla_error", "off"),
                                        ("xla_error force", "force")):
                        arm = sched_ring_arm(
                            label, ring, producer, plan, lists, want, dev,
                            {"PINGOO_CHAOS": "xla_error:1",
                             "PINGOO_MEGASTEP": mega},
                            max_batch=SCHED_CHAOS_BATCH, drives=3,
                            between=backoff, chaos=True)
                        ring_arms[label] = arm
                        # One rung failed once and was demoted once, and a
                        # probe after its backoff re-promoted it: no rung is
                        # demoted after any drive but (perhaps) the first.
                        first, second, third = arm["drives"]
                        rungs = arm["ladder"]
                        if len(rungs) != 1 or any(
                                (r["errors"], r["demotions"], r["healthy"])
                                != (1, 1, True) for r in rungs.values()) \
                                or second["ladder_demoted"] \
                                or third["ladder_demoted"] \
                                or arm["chaos"]["injected"] \
                                != {"xla_error": 1} \
                                or plan.dfa_default_mode != "auto":
                            fail(f"{label}: rungs {rungs}, demoted after the "
                                 f"drives {first['ladder_demoted']}, "
                                 f"{second['ladder_demoted']}, "
                                 f"{third['ladder_demoted']}, injected "
                                 f"{arm['chaos']['injected']}, DFA mode "
                                 f"{plan.dfa_default_mode}")
                        if mega == "force" and not third["megastep"][
                                "replays"]:
                            fail(f"{label}: no graph replay after the "
                                 f"re-promotion")
                    arm = sched_ring_arm(
                        "swap_storm force", ring, producer, plan, lists,
                        want, dev, {"PINGOO_CHAOS": "swap_storm",
                                    "PINGOO_MEGASTEP": "force"},
                        max_batch=SCHED_CHAOS_BATCH, chaos=True)
                    ring_arms["swap_storm force"] = arm
                    if not arm["hotswap_epoch"] or arm["ladder"]:
                        fail(f"the swap storm made {arm['hotswap_epoch']} "
                             f"swaps with ladder errors {arm['ladder']}")
                producer.close()
                time.sleep(0.2)
                if ring.poll_verdict() is not None:
                    fail("a verdict arrived after every request had its own")
            finally:
                if producer.proc.poll() is None:
                    producer.proc.kill()
                    producer.proc.wait()
        finally:
            ring.close()
    check_ladder("sched phase (outside its chaos arms)")
    ledger = ledger_check("sched phase's process")
    print(json.dumps({"sched": dict(
        seed=seed, python=py, ring=ring_arms, cost_ledger=cost_ledger,
        compile_ledger=ledger, seconds=time.monotonic() - t_phase)},
        default=str), flush=True)
    return 0


def sched_child() -> dict:
    """`sched_phase` in a process of its own; returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--sched-phase"],
        capture_output=True, text=True, timeout=600)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the sched phase exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print(f"sched phase: {time.monotonic() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["sched"]


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
    check_ladder("body phase")
    ledger_check("body phase's process")
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


# -- the listener phase: the Python plane over HTTP (host/httpd.py) ----------

LISTENER_TOKEN = "chip-smoke-xff-token"
LISTENER_CONNS = 256  # keep-alive h1 connections of the client
LISTENER_WARM = 1024  # the first requests of the stream, as a warm-up pass
LISTENER_H2 = 256  # the stream's first requests again, over h2
LISTENER_H2_CONNS = 8
# The stream's first requests again under torch.profiler, and with a body
# on every fourth (both cut from the whole stream to keep the script's
# time as the native phase joined it).
LISTENER_PROFILED = 2048
LISTENER_BODIES = 2048
LISTENER_ORACLE_WORKERS = 6
LISTENER_DRAIN_S = 20  # the server's graceful-stop cap (host/server.py)
LISTENER_WWW = {"index.html": b"<h1>welcome</h1>\n",
                "about.html": b"<h1>about</h1>\n",
                "robots.txt": b"User-agent: *\nDisallow:\n"}
# Request path -> the file the static service answers with (a directory
# serves its index.html, an extensionless path its .html); any other
# path is a 404.
LISTENER_STATIC = {"/": "index.html", "/index.html": "index.html",
                   "/about": "about.html", "/about.html": "about.html",
                   "/robots.txt": "robots.txt"}
LISTENER_API_ROUTE = 'http_request.path.starts_with("/api")'
# What `python -m pingoo_tpu_torch` is asked (label, method, target, user
# agent): the oracle must block the first, challenge the second and
# route the third to `api`.
LISTENER_PROBES = (
    ("a blocked request", "GET", "/download?file=../../../../etc/passwd",
     "Mozilla/5.0 (X11; Linux x86_64; rv:126.0) Gecko/20100101"),
    ("a captcha request", "GET", "/cart",
     "Mozilla/5.0 (X11; Linux x86_64; rv:126.0) Gecko/20100101"),
    ("a proxied request", "GET", "/api/v1/users?page=2",
     "Mozilla/5.0 (X11; Linux x86_64; rv:126.0) Gecko/20100101"))
LISTENER_PROBE_CLASSES = ("block", "captcha", "pong GET")
# Every rule of the corpus blocks; the deployment appends one that
# challenges (a captcha before the cart, one of the stream's clean paths).
LISTENER_CAPTCHA_RULE = ("challenge_cart", 'http_request.path == "/cart"')


def listener_pong() -> int:
    """The upstream of the `api` service, in a process of its own: a
    keep-alive HTTP/1.1 server answering every request with 200 and
    "pong: METHOD TARGET" (no body to HEAD). Prints its port, serves
    until stdin closes."""

    async def handle(reader, writer):
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                lines = head.split(b"\r\n")
                method, target = lines[0].split(b" ")[:2]
                for line in lines[1:]:
                    name, _, value = line.partition(b":")
                    if name.strip().lower() == b"content-length" and \
                            int(value):
                        await reader.readexactly(int(value))
                body = b"pong: " + method + b" " + target + b"\n"
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: text/plain"
                             b"\r\ncontent-length: %d\r\n\r\n" % len(body)
                             + (b"" if method == b"HEAD" else body))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        finally:
            writer.close()

    async def serve():
        server = await asyncio.start_server(handle, "127.0.0.1", 0,
                                            backlog=1024)
        print(server.sockets[0].getsockname()[1], flush=True)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, sys.stdin.read)
        server.close()

    asyncio.run(serve())
    return 0


def quote_target(url: str) -> str:
    """A request target a client sends for `url`: bytes outside the
    visible ASCII range (spaces in the stream's attack URLs) percent-
    encoded, as a browser does."""
    return "".join(chr(b) if 0x21 <= b <= 0x7E else f"%{b:02X}"
                   for b in url.encode())


def listener_client_h1(port: int, jobs: list, conns: int,
                       sources=None) -> dict:
    """Send jobs[i] = (method, raw request) on keep-alive connection
    i % conns, one request at a time per connection; each response read
    whole (Content-Length framing, none for HEAD). Connection k binds
    source address sources[k] where `sources` is given. Returns the
    per-request (status, content-type, body, local port, latency ms) and
    the wall time. Every connection is closed by its client after its
    last response, and must then read EOF: no response was left over."""
    results = [None] * len(jobs)

    async def connection(k):
        local_addr = (sources[k], 0) if sources else None
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", port, local_addr=local_addr)
        local = writer.get_extra_info("sockname")[1]
        for i in range(k, len(jobs), conns):
            method, raw = jobs[i]
            t0 = time.perf_counter()
            writer.write(raw)
            head = await reader.readuntil(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            status = int(lines[0].split(" ", 2)[1])
            hdrs = {}
            for line in lines[1:]:
                name, _, value = line.partition(":")
                hdrs.setdefault(name.strip().lower(), value.strip())
            size = int(hdrs.get("content-length", 0))
            body = b"" if method == "HEAD" or not size else \
                await reader.readexactly(size)
            results[i] = (status, hdrs.get("content-type", ""), body, local,
                          (time.perf_counter() - t0) * 1e3)
            if hdrs.get("connection", "").lower() == "close":
                writer.close()
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port, local_addr=local_addr)
                local = writer.get_extra_info("sockname")[1]
        writer.write_eof()
        rest = await asyncio.wait_for(reader.read(), 30)
        writer.close()
        return rest

    async def run():
        t0 = time.perf_counter()
        rests = await asyncio.gather(*(connection(k) for k in
                                       range(min(conns, len(jobs)))))
        return time.perf_counter() - t0, rests

    c0 = time.process_time()
    wall, rests = asyncio.run(run())
    return dict(wall_s=wall, cpu_s=time.process_time() - c0,
                results=results, leftover=sum(len(r) for r in rests))


def listener_client_h2(port: int, jobs: list, conns: int) -> dict:
    """jobs[i] = (method, authority, target, headers, body) as h2 streams
    by prior knowledge, on connection i % conns, all streams of a
    connection in flight together."""
    sys.path.insert(0, REPO)
    from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

    results = [None] * len(jobs)

    async def connection(k):
        conn = H2UpstreamConnection("127.0.0.1", port)
        await conn.connect()
        local = conn._writer.get_extra_info("sockname")[1]

        async def one(i):
            method, authority, target, headers, body = jobs[i]
            t0 = time.perf_counter()
            status, hdrs, out = await asyncio.wait_for(
                conn.request(method, authority, target, headers, body), 60)
            ctype = next((v for n, v in hdrs if n.lower() == "content-type"),
                         "")
            results[i] = (status, ctype, bytes(out), local,
                          (time.perf_counter() - t0) * 1e3)

        try:
            await asyncio.gather(*(one(i) for i in
                                   range(k, len(jobs), conns)))
        finally:
            await conn.close()

    async def run():
        t0 = time.perf_counter()
        await asyncio.gather(*(connection(k) for k in range(conns)))
        return time.perf_counter() - t0

    c0 = time.process_time()
    wall = asyncio.run(run())
    return dict(wall_s=wall, cpu_s=time.process_time() - c0,
                results=results, leftover=0)


def read_frame(stream):
    """One length-prefixed pickle from a binary stream; None at its end."""
    import pickle

    head = stream.read(8)
    if len(head) < 8:
        return None
    return pickle.loads(stream.read(int.from_bytes(head, "little")))


def write_frame(stream, obj) -> None:
    import pickle

    data = pickle.dumps(obj)
    stream.write(len(data).to_bytes(8, "little") + data)
    stream.flush()


def listener_client() -> int:
    """The client of the listener and native phases, in a process of its
    own as a load generator is: for each frame (proto, port, jobs, conns,
    sources) read from stdin, send the jobs and write the results as a
    frame to stdout. Ends at the end of stdin."""
    while (frame := read_frame(sys.stdin.buffer)) is not None:
        proto, port, jobs, conns, sources = frame
        out = listener_client_h1(port, jobs, conns, sources) \
            if proto == "h1" else listener_client_h2(port, jobs, conns)
        write_frame(sys.stdout.buffer, out)
    return 0


class ListenerClient:
    """`listener_client` in a child process."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--listener-client"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    def send(self, proto: str, port: int, jobs: list, conns: int,
             sources=None) -> dict:
        write_frame(self.proc.stdin, (proto, port, jobs, conns, sources))
        out = read_frame(self.proc.stdout)
        if out is None:
            self.proc.kill()
            fail(f"the listener client exited {self.proc.wait()}: "
                 f"{self.proc.stderr.read()[-3000:].decode(errors='replace')}")
        return out

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        if rc != 0:
            fail(f"the listener client exited {rc}: "
                 f"{self.proc.stderr.read()[-3000:].decode(errors='replace')}")


_ORACLE = {}


def listener_oracle_init(raw: dict) -> None:
    """A worker of the listener phase's oracle: the deployment's plan and
    the default body plan, on the CPU."""
    sys.path.insert(0, REPO)
    import torch

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config import parse_config
    from pingoo_tpu_torch.engine import bodyscan
    from pingoo_tpu_torch.lists import load_lists

    torch.set_num_threads(1)
    config = parse_config(raw)
    lists = load_lists(config.lists)
    routes = [(s.name, s.route) for s in config.services]
    _ORACLE.update(
        config=config, lists=lists,
        plan=compile_ruleset(config.rules, lists, routes=routes,
                             device="cpu"),
        body=bodyscan.compile_body_plan(device="cpu"))


def listener_oracle(chunk: list) -> list:
    """(action, verified_block, service) of each (RequestTuple fields,
    body or None) of `chunk`: the interpreter's rows through the action
    lanes, a body's oracle lanes merged in where the metadata allows (as
    the listener merges them), and the first service whose route
    matches."""
    from pingoo_tpu_torch.engine import bodyscan
    from pingoo_tpu_torch.engine.batch import RequestTuple, tuple_to_context
    from pingoo_tpu_torch.engine.verdict import (action_lanes,
                                                 interpret_rules_row)
    from pingoo_tpu_torch.host.services import match_route

    plan, lists = _ORACLE["plan"], _ORACLE["lists"]
    out = []
    for fields, body in chunk:
        ctx = tuple_to_context(RequestTuple(**fields), lists)
        act, vb = action_lanes(plan, interpret_rules_row(plan, ctx)[None])
        act, vb = int(act[0]), bool(vb[0])
        if act == 0 and body:
            bu, bvb = bodyscan.body_lanes_oracle(_ORACLE["body"], body)[:2]
            merged = bodyscan.merge_actions(act | (vb << 2), bu, bvb)
            act, vb = merged & 0x3, bool(merged & 0x4)
        service = next((s.name for s in _ORACLE["config"].services
                        if match_route(s.route, ctx)), None)
        out.append((act, vb, service))
    return out


def listener_fields(t, target: str, local_port: int) -> dict:
    """The RequestTuple the listener derives from what the client sent
    for `t`: the target as sent, its path, the Host header (no port in
    it), the trimmed user agent, the client IP the token-bound
    x-forwarded-for carries, the connection's port, and no GeoIP record
    (asn 0, country XX)."""
    return dict(host=t.host, url=target, path=target.split("?", 1)[0],
                method=t.method, user_agent=t.user_agent.strip(), ip=t.ip,
                remote_port=local_port, asn=0, country="XX")


def listener_expect(method: str, user_agent: str, path: str, act: int,
                    service) -> tuple:
    """(status, content type, body class) the listener must answer."""
    if method == "HEAD":
        status, ctype, _ = listener_expect("GET", user_agent, path, act,
                                           service)
        return status, ctype, "empty"
    if not user_agent or len(user_agent) >= 256 or act == 1:
        return 403, "text/plain", "block"
    if act == 2:
        return 403, "text/html", "captcha"
    if service == "api":
        return 200, "text/plain", f"pong {method}"
    if method != "GET":
        return 405, "text/plain", "method"
    if path in LISTENER_STATIC:
        name = LISTENER_STATIC[path]
        return 200, "text/plain" if name.endswith(".txt") else "text/html", \
            f"static {name}"
    return 404, "text/plain", "notfound"


def listener_class(body: bytes) -> str:
    from pingoo_tpu_torch.host.captcha import CAPTCHA_PAGE

    known = {b"Forbidden": "block", CAPTCHA_PAGE.encode(): "captcha",
             b"Not Found": "notfound", b"Method Not Allowed": "method",
             b"": "empty",
             **{v: f"static {k}" for k, v in LISTENER_WWW.items()}}
    if body in known:
        return known[body]
    m = re.match(rb"pong: (\S+) /api", body)
    return f"pong {m[1].decode()}" if m else f"other {body[:80]!r}"


def listener_jobs(reqs, bodies, proto: str) -> list:
    if proto == "h1":
        jobs = []
        for t, body in zip(reqs, bodies):
            head = (f"{t.method} {quote_target(t.url)} HTTP/1.1\r\n"
                    f"host: {t.host}\r\nuser-agent: {t.user_agent}\r\n"
                    f"x-pingoo-internal: {LISTENER_TOKEN}\r\n"
                    f"x-forwarded-for: {t.ip}\r\n")
            if body:
                head += f"content-length: {len(body)}\r\n"
            jobs.append((t.method, (head + "\r\n").encode("latin-1")
                         + (body or b"")))
        return jobs
    return [(t.method, t.host, quote_target(t.url),
             [("user-agent", t.user_agent),
              ("x-pingoo-internal", LISTENER_TOKEN),
              ("x-forwarded-for", t.ip)], body or b"")
            for t, body in zip(reqs, bodies)]


def listener_pass(label, client, server, proto, reqs, bodies, conns,
                  profiled=False) -> dict:
    """One drive of `reqs` through the server's listener, with the
    kernels' launch counts set to 0 just before and read just after.
    Returns the pass's numbers and, under "check", what the oracle needs
    to hold each response."""
    import numpy as np
    import torch

    from pingoo_tpu_torch.ops import _build

    listener = server.http_listeners[0]
    verdict = server.verdict
    jobs = listener_jobs(reqs, bodies, proto)
    t_snap = time.monotonic()
    m0, d0 = verdict.registry.json_snapshot(), verdict.stats.dedup_hits
    snapshot_s = time.monotonic() - t_snap
    b0, r0 = verdict.stats.batches, verdict.stats.requests
    s0 = {k: v.count for k, v in verdict.stats.stages.items()}
    w0 = verdict.stats.batch.count
    q0 = listener.stats.requests
    c0 = time.process_time()
    _build.reset_launch_counts()
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = client.send(proto, listener.bound_port, jobs, conns)
            torch.cuda.synchronize()
    else:
        out = client.send(proto, listener.bound_port, jobs, conns)
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    cpu_s = time.process_time() - c0
    results = out["results"]
    if any(r is None for r in results) or out["leftover"]:
        fail(f"listener {label}: {sum(r is None for r in results)} of "
             f"{len(results)} requests unanswered, {out['leftover']} bytes "
             f"after the last responses")
    batches = verdict.stats.batches - b0
    evaluated = verdict.stats.requests - r0
    # The registry's view of the pass: the listener's requests and the
    # verdict waits, as a scrape would read them.
    t_snap = time.monotonic()
    m1 = verdict.registry.json_snapshot()
    snapshot_s += time.monotonic() - t_snap
    metrics = dict(
        requests_total=registry_delta(
            m0, m1, "pingoo_requests_total",
            f"listener={listener.name},plane=python"),
        wait_count=registry_delta(m0, m1, "pingoo_verdict_wait_ms",
                                  "plane=python", "count"),
        dedup_hits=verdict.stats.dedup_hits - d0, snapshot_s=snapshot_s)
    if (metrics["requests_total"], metrics["wait_count"]) != \
            (len(reqs), evaluated):
        fail(f"listener {label}: the registry's pingoo_requests_total "
             f"moved by {metrics['requests_total']} and the wait "
             f"histogram's count by {metrics['wait_count']}, for "
             f"{len(reqs)} requests of which {evaluated} were evaluated")
    lat = np.array([r[4] for r in results])
    res = dict(
        proto=proto, requests=len(reqs), conns=conns,
        bodies=sum(b is not None for b in bodies),
        req_per_s=len(reqs) / out["wall_s"], wall_s=out["wall_s"],
        latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        batches=batches, evaluated=evaluated, metrics=metrics,
        rows_per_batch=evaluated / batches if batches else 0.0,
        stage_p50_ms={k: float(np.percentile(w.since(s0[k]), 50))
                      for k, w in verdict.stats.stages.items()
                      if w.count > s0[k]},
        launches=launches,
        served=listener.stats.requests - q0,
        # The server's process (the listener's event loop, the verdict
        # service's batch thread) and the client's, in CPU seconds per
        # second of the pass; the batches' share of the wall.
        server_cpu_share=cpu_s / out["wall_s"],
        client_cpu_share=out["cpu_s"] / out["wall_s"],
        batch_busy_share=sum(verdict.stats.batch.since(w0)) / 1e3
        / out["wall_s"])
    if profiled:
        busy_ms = sum(device_time_us(prof).values()) / 1e3
        res["device_busy_ms"] = busy_ms if busy_ms > 0 else "not measured"
        res["device_busy_pct"] = 100 * busy_ms / (out["wall_s"] * 1e3) \
            if busy_ms > 0 else "not measured"
    targets = [quote_target(t.url) for t in reqs]
    res["check"] = [(listener_fields(t, target, r[3]), body, r[:3])
                    for t, target, body, r in zip(reqs, targets, bodies,
                                                  results)]
    print(f"listener {label}: {len(reqs)} requests over {conns} {proto} "
          f"connections, {res['req_per_s']:.0f} req/s, latency p50 "
          f"{res['latency_p50_ms']:.2f} ms p99 {res['latency_p99_ms']:.2f} "
          f"ms, {batches} batches of {res['rows_per_batch']:.1f} rows, "
          f"stage p50 ms {res['stage_p50_ms']}, batches busy "
          f"{res['batch_busy_share']:.1%} of the wall, CPU server "
          f"{res['server_cpu_share']:.2f} client "
          f"{res['client_cpu_share']:.2f}, launches {launches}"
          + (f", device busy {res['device_busy_ms']} ms = "
             f"{res['device_busy_pct']}% of the wall" if profiled else ""),
          flush=True)
    return res


def registry_delta(before: dict, after: dict, name: str, key: str,
                   field: str = None):
    """after - before of one series of two registry JSON snapshots
    (`field` of a histogram's, e.g. "count"); 0 where absent."""
    def value(snap):
        v = snap.get(name, {}).get(key, 0)
        return v.get(field, 0) if field is not None and v else v
    return value(after) - value(before)


def listener_scrape(port: int) -> dict:
    """GET /__pingoo/metrics without an Accept header, as a Prometheus
    scraper sends it: the status, content type, lint problems and size
    of the text, and the samples of a few families."""
    import http.client

    from pingoo_tpu_torch.obs import schema
    from pingoo_tpu_torch.obs.registry import lint_prometheus_text

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/__pingoo/metrics",
                     headers={"user-agent": "chip-smoke-scraper"})
        resp = conn.getresponse()
        text = resp.read().decode()
        ctype = resp.getheader("content-type", "")
    finally:
        conn.close()
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    names = {ln.split("{", 1)[0].split(" ", 1)[0] for ln in lines}
    return dict(status=resp.status, content_type=ctype,
                problems=lint_prometheus_text(text), bytes=len(text),
                samples=len(lines),
                missing=sorted(n for n in (*schema.SHARED_METRICS,
                                           *schema.PREFILTER_METRICS,
                                           *schema.DFA_METRICS,
                                           *schema.SCHED_METRICS,
                                           "pingoo_staged_bytes_total",
                                           "pingoo_degrade_total",
                                           "pingoo_ruleset_epoch",
                                           "pingoo_pipeline_inflight")
                               if not any(x == n or x.startswith(n + "_")
                                          for x in names)),
                series={n: [ln for ln in lines if ln.startswith(n)]
                        for n in ("pingoo_requests_total",
                                  "pingoo_scan_banks_skipped_total",
                                  "pingoo_prefilter_candidate_rate",
                                  "pingoo_dfa_banks_total",
                                  "pingoo_verdict_wait_ms_count")})


LISTENER_DEDUP = 48  # distinct requests of the dedup step's one batch
LISTENER_DEDUP_REPEATS = (0, 0, 1, 2, 3, 5, 8, 13, 21, 34, 34, 34, 40, 47,
                          47, 47)


def listener_dedup(lt, server, reqs) -> dict:
    """One batch straight into the listener's handler, all at once on its
    event loop (so one collector batch): LISTENER_DEDUP distinct requests
    that need a verdict and LISTENER_DEDUP_REPEATS of them again.
    `dedup_hits` must move by the repeats, the batch be one, and each
    repeat be answered as its first."""
    from pingoo_tpu_torch.host.httpd import Request

    verdict = server.verdict
    listener = server.http_listeners[0]
    base = [r for r in reqs
            if r.user_agent and len(r.user_agent) < 256][:LISTENER_DEDUP]
    batch = base + [base[i] for i in LISTENER_DEDUP_REPEATS]
    d0, b0 = verdict.stats.dedup_hits, verdict.stats.batches

    async def send():
        return await asyncio.gather(*[listener.handle_request(Request(
            method=r.method, target=quote_target(r.url), path=r.path,
            headers=[("host", r.host), ("user-agent", r.user_agent)]),
            (r.ip, 40000)) for r in batch])

    resps = lt.run(send())
    hits = verdict.stats.dedup_hits - d0
    batches = verdict.stats.batches - b0
    first = {i: resps[i].status for i in range(len(base))}
    wrong = [(i, resps[len(base) + j].status, first[i])
             for j, i in enumerate(LISTENER_DEDUP_REPEATS)
             if resps[len(base) + j].status != first[i]]
    if hits != len(LISTENER_DEDUP_REPEATS) or batches != 1 or wrong:
        fail(f"listener dedup: {len(batch)} requests with "
             f"{len(LISTENER_DEDUP_REPEATS)} repeats in one batch gave "
             f"dedup_hits +{hits} over {batches} batches; repeats answered "
             f"otherwise than their first: {wrong}")
    out = dict(requests=len(batch), repeats=len(LISTENER_DEDUP_REPEATS),
               dedup_hits=hits, batches=batches,
               statuses=sorted({r.status for r in resps}))
    print(f"listener dedup: {out}", flush=True)
    return out


def listener_check(label, res, oracle) -> dict:
    """Hold every response of a pass to the oracle; returns the counts of
    each outcome."""
    bad, kinds = [], {}
    need_verdict = 0
    for (fields, body, (status, ctype, got)), (act, _, service) in zip(
            res.pop("check"), oracle):
        ua = fields["user_agent"]
        need_verdict += bool(ua) and len(ua) < 256
        want = listener_expect(fields["method"], ua, fields["path"], act,
                               service)
        have = (status, ctype.split(";")[0].strip(), listener_class(got))
        kinds[want[2]] = kinds.get(want[2], 0) + 1
        if have != want:
            bad.append((fields["method"], fields["url"], want, have))
    if bad:
        fail(f"listener {label}: {len(bad)} of {res['requests']} responses "
             f"differ from the oracle, e.g. {bad[:5]}")
    if res["evaluated"] != need_verdict or res["served"] != res["requests"]:
        fail(f"listener {label}: the verdict service evaluated "
             f"{res['evaluated']} requests and the listener served "
             f"{res['served']}; {need_verdict} needed a verdict of "
             f"{res['requests']}")
    print(f"listener {label}: every response as the oracle says: {kinds}",
          flush=True)
    return kinds


class LoopThread:
    """An event loop in a thread of its own (the server's), driven from
    the phase's thread."""

    def __init__(self):
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)


def listener_server(lt, raw: dict, tmp: str, device=None):
    """Start Server(config) as `python -m pingoo_tpu_torch` would, on
    the card, trusting LISTENER_TOKEN's x-forwarded-for."""
    from pingoo_tpu_torch.config import parse_config
    from pingoo_tpu_torch.host.server import Server

    server = Server(parse_config(raw), device=device, enable_docker=False,
                    xff_token=LISTENER_TOKEN,
                    geoip_paths=(os.path.join(tmp, "missing.mmdb"),),
                    captcha_jwks_path=os.path.join(tmp, "jwks.json"),
                    tls_dir=os.path.join(tmp, "tls"))

    async def start():
        await server.start()
        return asyncio.ensure_future(server.serve_forever())

    server.task = lt.run(start())
    return server


def listener_stop(lt, server) -> None:
    async def stop():
        server.task.cancel()
        await server.stop()

    lt.run(stop())
    st = server.http_listeners[0].stats
    if st.engine_errors or st.body_fail_open:
        fail(f"the listener counted {st.engine_errors} engine errors and "
             f"{st.body_fail_open} body scans failed open")


def httpd_children(pid: int) -> list[int]:
    """The pids of process `pid`'s children that run the port's httpd."""
    from pingoo_tpu_torch import native_ring

    httpd = str(native_ring.httpd_path()).encode()
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv0 = f.read().split(b"\0", 1)[0]
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and argv0 == httpd:
            out.append(int(d))
    return out


def proc_alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie has exited)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def listener_entry_point(raw: dict, tmp: str, probes, device=None,
                         native: bool = False) -> dict:
    """`python -m pingoo_tpu_torch --config <tmp>/<name>.yml --no-docker`
    on the card, with `--native-plane --state-dir <tmp>/<name>-state`
    where `native`: wait for its port, send `probes` [(label, method,
    target, user agent)] one connection each, then SIGTERM; it must exit
    0 within the drain, and with `native` have run an httpd child and
    left none. Returns the answers, each (status, body class, the
    probe's local port)."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    raw = dict(raw, listeners={"http": {"address":
                                        f"http://127.0.0.1:{port}"}})
    name = "native" if native else "entry"
    path = os.path.join(tmp, f"{name}.yml")
    with open(path, "w") as f:
        json.dump(raw, f)  # JSON is YAML: load_and_validate reads it
    log = open(os.path.join(tmp, f"{name}.log"), "w+")
    cmd = [sys.executable, "-m", "pingoo_tpu_torch", "--config", path,
           "--no-docker", "--captcha-jwks", os.path.join(tmp, f"{name}.jwks")]
    if native:
        cmd += ["--native-plane", "--state-dir",
                os.path.join(tmp, f"{name}-state")]
    if device == "cpu":
        cmd.append("--no-device")
    what = "python -m pingoo_tpu_torch" + (" --native-plane" if native
                                           else "")
    classify = native_class if native else listener_class
    t0 = time.monotonic()
    # Ledgers of the entry point's own: its drain saves the cost ledger.
    costs = os.path.join(tmp, f"{name}-cost_ledger.json")
    proc = subprocess.Popen(cmd, cwd=tmp, stdout=log, stderr=log,
                            env=dict(os.environ, PYTHONPATH=REPO,
                                     PINGOO_COST_LEDGER=costs,
                                     PINGOO_PERF_LEDGER=os.path.join(
                                         tmp, f"{name}-perf_ledger.jsonl")))
    try:
        while True:
            if proc.poll() is not None:
                log.seek(0)
                fail(f"{what} exited {proc.returncode} before serving: "
                     f"{log.read()[-3000:]}")
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                break
            except OSError:
                if time.monotonic() - t0 > 300:
                    fail(f"{what} did not open its port")
                time.sleep(0.1)
        boot_s = time.monotonic() - t0
        children = httpd_children(proc.pid) if native else []
        answers = []
        for _, method, target, ua in probes:
            with socket.create_connection(("127.0.0.1", port), 60) as s:
                s.sendall(f"{method} {target} HTTP/1.1\r\nhost: "
                          f"www.example.com\r\nuser-agent: {ua}\r\n"
                          f"connection: close\r\n\r\n".encode())
                local = s.getsockname()[1]
                resp = b""
                while chunk := s.recv(65536):
                    resp += chunk
            head, _, body = resp.partition(b"\r\n\r\n")
            answers.append((int(head.split(b" ", 2)[1]), classify(body),
                            local))
        t1 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=LISTENER_DRAIN_S + 5)
        except subprocess.TimeoutExpired:
            fail(f"{what} did not exit within {LISTENER_DRAIN_S} s of "
                 f"SIGTERM")
        drain_s = time.monotonic() - t1
        if rc != 0 or drain_s > LISTENER_DRAIN_S:
            log.seek(0)
            fail(f"{what} exited {rc} {drain_s:.1f} s after SIGTERM: "
                 f"{log.read()[-3000:]}")
        if native and (not children or any(map(proc_alive, children))):
            fail(f"{what} ran httpd children {children}; alive after its "
                 f"exit: {[p for p in children if proc_alive(p)]}")
        saved = {}
        if os.path.exists(costs):
            with open(costs) as f:
                saved = json.load(f)["entries"]
        entry = ("cpu" if device == "cpu" else "cuda") + "|" + (
            "sidecar" if native else "python")
        if not native and not saved.get(entry, {}).get("cost", {}).get(
                "ewma_ms"):
            fail(f"{what}'s SIGTERM drain saved no {entry} costs: "
                 f"{sorted(saved)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    print(f"{'native' if native else 'listener'} entry point: {what} "
          f"served after {boot_s:.1f} s"
          + (f" through {len(children)} httpd" if native else "")
          + f", answered {[p[0] for p in probes]} with "
          f"{[a[:2] for a in answers]}, exited 0 {drain_s:.2f} s after "
          f"SIGTERM" + (", no httpd left" if native else "")
          + f"; its cost ledger holds {sorted(saved)}"
          + (f", {entry} EWMA ms by rows {saved[entry]['cost']['ewma_ms']}"
             if entry in saved else "") + f" [{card()}]",
          flush=True)
    return dict(boot_s=boot_s, drain_s=drain_s, answers=answers,
                cost_ledger=sorted(saved),
                **(dict(httpd_children=len(children)) if native else {}))


def listener_phase(device=None, n: int = N_REQUESTS) -> int:
    """The Python listener plane on the card, in a process of its own.
    The 500-rule corpus as a deployment (its lists as CSV files, and
    LISTENER_CAPTCHA_RULE after its rules) with a static service over a small www/ directory and an http_proxy service
    `api` routed to a pong upstream (a child process);
    Server(config, device=None, enable_docker=False, xff_token=T) at the
    default max_batch. A client in another child process sends the slice
    phase's stream as HTTP/1.1 requests (each with its tuple's method,
    target, Host and user agent, and the token with x-forwarded-for: its
    IP) over LISTENER_CONNS keep-alive connections: a warm-up pass of its
    first LISTENER_WARM, the measured pass, LISTENER_H2 of them over h2
    by prior knowledge and its first LISTENER_PROFILED under
    torch.profiler; then a fresh Server with PINGOO_BODY_INSPECT=on and a
    seed-set body on every fourth of its first LISTENER_BODIES. Every response must be the oracle's (the
    interpreter on the tuple the listener derives, the action lanes, the
    body oracle merged in, the first matching route), every request
    answered once, each pass evaluated once per request needing a
    verdict, no engine error or body scan failed open, and the measured
    pass must launch all three kernels. Last, `python -m
    pingoo_tpu_torch` serves three probes and exits 0 on SIGTERM.
    Prints one JSON line {"listener": ...}, but no result line."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from pingoo_tpu_torch.engine.batch import RequestTuple
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import (deployment, generate_ruleset,
                                            generate_traffic)

    t_phase = time.monotonic()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _build.build()  # run alone, the phase builds the kernels here
    rules, lists = generate_ruleset(500)
    reqs = generate_traffic(n, attack_fraction=0.3, seed=SEED, lists=lists)
    bodies = body_ring_bodies(min(n, LISTENER_BODIES))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        pong = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--listener-pong"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        pong_port = int(pong.stdout.readline())
        www = os.path.join(tmp, "www")
        os.makedirs(www)
        for name, content in LISTENER_WWW.items():
            with open(os.path.join(www, name), "wb") as f:
                f.write(content)
        raw = deployment(rules, lists, tmp, services={
            "api": {"route": LISTENER_API_ROUTE,
                    "http_proxy": [f"http://127.0.0.1:{pong_port}"]},
            "www": {"static": {"root": www}}})
        raw["listeners"] = {"http": {"address": "http://127.0.0.1:0"}}
        name, expression = LISTENER_CAPTCHA_RULE
        raw["rules"][name] = {"expression": expression,
                              "actions": [{"action": "captcha"}]}
        pool = ProcessPoolExecutor(
            LISTENER_ORACLE_WORKERS,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=listener_oracle_init, initargs=(raw,))
        ready = [pool.submit(listener_oracle, [])
                 for _ in range(LISTENER_ORACLE_WORKERS)]
        lt = LoopThread()
        client = ListenerClient()
        try:
            t0 = time.monotonic()
            server = listener_server(lt, raw, tmp, device)
            boot_s = time.monotonic() - t0
            print(f"listener: Server on {server.device} with "
                  f"{len(server.plan.rules)} columns served on port "
                  f"{server.http_listeners[0].bound_port} after "
                  f"{boot_s:.1f} s; pong on {pong_port}", flush=True)
            none = [None] * n
            passes = [
                ("warm", "h1", reqs[:LISTENER_WARM], none[:LISTENER_WARM],
                 LISTENER_CONNS, False),
                ("h1", "h1", reqs, none, LISTENER_CONNS, False),
                ("h2", "h2", reqs[:LISTENER_H2], none[:LISTENER_H2],
                 LISTENER_H2_CONNS, False),
                ("profiled", "h1", reqs[:LISTENER_PROFILED],
                 none[:LISTENER_PROFILED], LISTENER_CONNS, True)]
            for label, proto, rq, bd, conns, prof in passes:
                results[label] = listener_pass(label, client, server, proto,
                                               rq, bd, conns, prof)
            t0 = time.monotonic()
            dedup = listener_dedup(lt, server, reqs)
            scrape = listener_scrape(server.http_listeners[0].bound_port)
            if scrape["status"] != 200 or not scrape["content_type"] \
                    .startswith("text/plain; version=0.0.4") \
                    or scrape["problems"] or scrape["missing"]:
                fail(f"listener: /__pingoo/metrics answered "
                     f"{scrape['status']} {scrape['content_type']!r}, lint "
                     f"{scrape['problems'][:5]}, missing families "
                     f"{scrape['missing']}")
            scrape["seconds"] = time.monotonic() - t0  # dedup included
            print(f"listener scrape: {json.dumps(scrape)}", flush=True)
            snap = server.verdict.stats.snapshot()
            max_batch = server.verdict.max_batch
            listener_stop(lt, server)
            os.environ["PINGOO_BODY_INSPECT"] = "on"
            try:
                server = listener_server(lt, raw, tmp, device)
                results["body"] = listener_pass(
                    "body", client, server, "h1", reqs[:LISTENER_BODIES],
                    bodies, LISTENER_CONNS)
                body_snap = server.verdict.stats.snapshot()
                listener_stop(lt, server)
            finally:
                os.environ.pop("PINGOO_BODY_INSPECT")
            entry = listener_entry_point(raw, tmp, LISTENER_PROBES, device)
        except BaseException:
            pool.shutdown(cancel_futures=True)
            raise
        finally:
            client.close()
            lt.close()
            pong.stdin.close()
            pong.wait(timeout=30)
        served = sum(r["evaluated"] for k, r in results.items()
                     if k != "body") + dedup["requests"]
        if (snap["requests"], body_snap["requests"]) != \
                (served, results["body"]["evaluated"]):
            fail(f"stats.snapshot() counts {snap['requests']} and "
                 f"{body_snap['requests']} requests, the passes evaluated "
                 f"{served} and {results['body']['evaluated']}")
        # The oracle, once the servers are down.
        t0 = time.monotonic()
        for f in ready:
            f.result()
        jobs = [(listener_fields(RequestTuple(
            host="www.example.com", url=target, method=m, user_agent=ua,
            ip="127.0.0.1"), target, local), None)
            for (_, m, target, ua), (*_, local) in zip(LISTENER_PROBES,
                                                      entry["answers"])]
        for res in results.values():
            jobs += [(fields, body) for fields, body, _ in res["check"]]
        chunk = 256
        futures = [pool.submit(listener_oracle, jobs[i:i + chunk])
                   for i in range(0, len(jobs), chunk)]
        oracle = [o for f in futures for o in f.result()]
    pool.shutdown()
    print(f"listener oracle: {len(oracle)} requests interpreted in "
          f"{time.monotonic() - t0:.1f} s in {LISTENER_ORACLE_WORKERS} "
          f"processes", flush=True)
    for (label, m, target, ua), (status, got, _), (act, _, service), \
            kind in zip(LISTENER_PROBES, entry["answers"], oracle,
                        LISTENER_PROBE_CLASSES):
        want = listener_expect(m, ua, target.split("?", 1)[0], act, service)
        if (status, got) != (want[0], want[2]) or want[2] != kind:
            fail(f"python -m pingoo_tpu_torch answered {label} with "
                 f"{(status, got)}, the oracle says {want}")
    at = len(LISTENER_PROBES)
    kinds = {}
    for label, res in results.items():
        kinds[label] = listener_check(label, res,
                                      oracle[at:at + res["requests"]])
        at += res["requests"]
    missing = [k for k, c in results["h1"]["launches"].items() if c == 0]
    if missing:
        fail(f"the listener's measured pass launched no {missing} kernel")
    check_ladder("listener phase")
    ledger_check("listener phase's process")
    print(json.dumps({"listener": dict(
        requests=n, conns=LISTENER_CONNS, max_batch=max_batch, boot_s=boot_s,
        passes=results, outcomes=kinds, entry_point=entry, dedup=dedup,
        scrape={k: v for k, v in scrape.items() if k != "series"},
        snapshot={k: snap[k] for k in ("batches", "requests",
                                       "mean_occupancy", "verdict_p50_ms",
                                       "verdict_p99_ms", "dedup_hits",
                                       "prefilter_candidate_rate",
                                       "scan_banks_skipped", "dfa_banks",
                                       "dfa_rechecks")},
        seconds=time.monotonic() - t_phase)}), flush=True)
    return 0


def listener_child() -> dict:
    """`listener_phase` in a process of its own; returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--listener-phase"],
        capture_output=True, text=True, timeout=900)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the listener phase exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print(f"listener phase: {time.monotonic() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["listener"]


NATIVE_CONNS = 256  # keep-alive h1 connections of the correctness pass
NATIVE_LISTED_EVERY = 8  # every 8th connection's source address is listed
NATIVE_BODIES = 2048  # requests of the body pass
# bench.py's end-to-end drive (bench_e2e): a warm-up run, then the
# measured one; loadgen_http <port> <requests> <connections> <attack ‰>.
NATIVE_LOADGEN_WARM = (8192, 1024, 100)
NATIVE_LOADGEN = (100000, 4096, 100)
# A shorter run at the measured run's load under torch.profiler, for the
# device's busy share. Stopping a profiler session holds the interpreter
# lock 29-41 ms for each sidecar batch it recorded (H100, PERF.md), and
# the sidecar shares that interpreter: a stop over 500 ms stales its
# heartbeat, and the httpd fails requests open (PINGOO_SIDECAR_TIMEOUT_MS).
# So the run is recorded in sessions of NATIVE_PROFILE_SLICE_S, a few
# batches each, and the httpd's counters are read after the last stop.
NATIVE_LOADGEN_PROFILED = (16384, 4096, 100)
NATIVE_PROFILE_SLICE_S = 0.2
# loadgen_http.cc's request shapes (method GET, host bench.test, user
# agent pingoo-bench/1.0, from 127.0.0.1): the attacks must be blocked,
# the clean paths allowed.
NATIVE_LOADGEN_ATTACKS = ("/page?x=<script>alert(1)</script>",
                          "/?b=eval(atob('x'))")
NATIVE_LOADGEN_CLEAN = ("/api/v1/users?page=2", "/index.html",
                        "/static/app.9f3c2.js", "/blog/2026/07/scaling-wafs",
                        "/products/widget-2000?sort=price")
# The corpus puts its `(?i)<script` signature on the path only, so it
# allows loadgen_http's first attack shape; the native deployment adds
# that CRS signature on the URL, so that every attack the loadgen sends
# is one the rules block.
NATIVE_XSS_RULE = ("xss_url_script", 'http_request.url.matches("(?i)<script")')
# The httpd's verdict-wait histogram (enqueue to the verdict applied):
# its keys and upper bounds in ms.
NATIVE_HIST_KEYS = ("le1", "le2", "le5", "le10", "le50", "le100", "inf")
NATIVE_HIST_BOUNDS = (1, 2, 5, 10, 50, 100, None)


def native_sources(conns: int) -> list[str]:
    """A source address in 127.0.0.0/8 for each client connection; none
    is 127.0.0.1, loadgen_http's address."""
    return [f"127.1.{k // 250}.{k % 250 + 2}" for k in range(conns)]


def native_fields(t, target: str, source: str, local_port: int) -> dict:
    """The RequestTuple the httpd derives from what the client sent for
    `t`: the target as sent and its path, the Host header, the trimmed
    user agent, the connection's peer address and port (the httpd trusts
    no x-forwarded-for), and no GeoIP record (asn 0, country XX)."""
    return dict(host=t.host, url=target, path=target.split("?", 1)[0],
                method=t.method, user_agent=t.user_agent.strip(),
                ip=source, remote_port=local_port, asn=0, country="XX")


def native_expect(method: str, user_agent: str, path: str, act: int,
                  service) -> tuple:
    """(status, content type, body class) the httpd must answer: 403 for
    the user-agent gate and a block, the 302 to /__pingoo/captcha for a
    captcha, C++ pong's 200 for `api`, and the static service (GET and
    HEAD only) for the rest. A HEAD response has no body."""
    if not user_agent or len(user_agent) >= 256 or act == 1:
        status, ctype, kind = 403, "text/plain", "block"
    elif act == 2:
        status, ctype, kind = 302, "", "empty"
    elif service == "api":
        status, ctype, kind = 200, "text/plain", "pong"
    elif method not in ("GET", "HEAD"):
        status, ctype, kind = 405, "text/plain", "method"
    elif path in LISTENER_STATIC:
        name = LISTENER_STATIC[path]
        status, ctype, kind = 200, "text/plain" if name.endswith(".txt") \
            else "text/html", f"static {name}"
    else:
        status, ctype, kind = 404, "text/plain", "notfound"
    return status, ctype, "empty" if method == "HEAD" else kind


def native_class(body: bytes) -> str:
    known = {b"Forbidden": "block", b"Not Found": "notfound",
             b"Method Not Allowed": "method", b"": "empty", b"pong": "pong",
             **{v: f"static {k}" for k, v in LISTENER_WWW.items()}}
    return known.get(body, f"other {body[:80]!r}")


def native_jobs(reqs, bodies) -> list:
    """HTTP/1.1 requests with each tuple's method, target, Host and user
    agent (no token, no x-forwarded-for: the httpd uses the peer)."""
    jobs = []
    for t, body in zip(reqs, bodies):
        head = (f"{t.method} {quote_target(t.url)} HTTP/1.1\r\n"
                f"host: {t.host}\r\nuser-agent: {t.user_agent}\r\n")
        if body:
            head += f"content-length: {len(body)}\r\n"
        jobs.append((t.method, (head + "\r\n").encode("latin-1")
                     + (body or b"")))
    return jobs


def native_metrics(port: int) -> dict:
    """The httpd's /__pingoo/metrics JSON."""
    import socket

    with socket.create_connection(("127.0.0.1", port), 30) as c:
        c.sendall(b"GET /__pingoo/metrics HTTP/1.1\r\nhost: m\r\n"
                  b"user-agent: chip-smoke\r\naccept: application/json\r\n"
                  b"connection: close\r\n\r\n")
        raw = b""
        while chunk := c.recv(65536):
            raw += chunk
    return json.loads(raw.partition(b"\r\n\r\n")[2])


def native_prometheus(port: int) -> str:
    """The httpd's /__pingoo/metrics in its default exposition, the
    Prometheus text."""
    import socket

    with socket.create_connection(("127.0.0.1", port), 30) as c:
        c.sendall(b"GET /__pingoo/metrics HTTP/1.1\r\nhost: m\r\n"
                  b"user-agent: chip-smoke\r\nconnection: close\r\n\r\n")
        raw = b""
        while chunk := c.recv(65536):
            raw += chunk
    return raw.partition(b"\r\n\r\n")[2].decode()


def native_liveness(port: int, plane, ages) -> dict:
    """The C++ httpd's Prometheus text against the shared inventory (it
    must carry every SHARED_METRICS name), its degraded-mode entries over
    the plane's life and the largest heartbeat age the passes sampled
    (`ages`), and the sidecar's registry against its ring's telemetry:
    the evidence on a stall of the sidecar's process."""
    import re as _re

    from pingoo_tpu_torch.obs import REGISTRY, schema
    from pingoo_tpu_torch.obs.registry import lint_prometheus_text

    text = native_prometheus(port)
    missing = [n for n in schema.SHARED_METRICS if n not in text]
    if missing:
        fail(f"native: the httpd's Prometheus text lacks {missing}")
    entered = [int(float(m)) for m in _re.findall(
        r"^pingoo_degraded_entered_total(?:\{[^}]*\})? (\S+)$", text,
        _re.M)]
    t = plane.sidecar.ring_telemetry()
    snap = REGISTRY.json_snapshot()
    exported = snap.get("pingoo_ring_verdicts_posted_total", {}).get(
        "plane=sidecar")
    out = dict(shared_metrics=sorted(schema.SHARED_METRICS),
               degraded_entered_total=entered,
               max_heartbeat_age_ms=max(ages), heartbeat_ages_ms=ages,
               lint_problems=len(lint_prometheus_text(text)),
               text_bytes=len(text),
               sidecar_verdicts_posted=dict(exported=exported,
                                            ring=t["verdicts_posted"]))
    if exported != t["verdicts_posted"]:
        fail(f"native: the sidecar's registry exports "
             f"{exported} verdicts posted, its ring's telemetry "
             f"{t['verdicts_posted']}")
    print(f"native liveness: the httpd's text carries "
          f"{len(schema.SHARED_METRICS)} shared metrics; "
          f"pingoo_degraded_entered_total {entered}, the heartbeat's "
          f"largest age {max(ages)} ms over the passes {ages}; "
          f"{out['lint_problems']} lint problems in {len(text)} bytes",
          flush=True)
    return out


def native_delta(before: dict, after: dict) -> dict:
    """after - before of the httpd's counters (the wait histogram and
    the body block per key)."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = native_delta(before.get(k, {}), v)
        elif isinstance(v, (int, float)):
            out[k] = v - before.get(k, 0)
    return out


def hist_percentile(counts, bounds, q: float) -> str:
    """The bucket of a wait histogram (counts per bucket, each bucket's
    upper bound in ms, None for the last, open one) holding quantile q,
    as "<= N ms" or "> N ms"."""
    total = sum(counts)
    seen = 0
    for c, bound in zip(counts, bounds):
        seen += c
        if total and seen >= q * total:
            return f"<= {bound} ms" if bound else f"> {bounds[-2]} ms"
    return "no samples"


class HeartbeatSampler:
    """The largest age of a ring's sidecar heartbeat, sampled every 5 ms
    by a thread while the `with` block runs."""

    def __init__(self, ring):
        self.ring = ring
        self.max_age_ms = 0

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            lv = self.ring.liveness()
            self.max_age_ms = max(self.max_age_ms,
                                  lv["now_ms"] - lv["heartbeat_ms"])

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def native_plane_start(lt, raw: dict, tmp: str, label: str, device=None):
    """NativePlane(config) on the card, started on the loop thread, as
    `python -m pingoo_tpu_torch --native-plane` starts it."""
    from pingoo_tpu_torch.config import parse_config
    from pingoo_tpu_torch.host.native_plane import NativePlane

    plane = NativePlane(parse_config(raw), os.path.join(tmp, label),
                        device=device, enable_docker=False,
                        geoip_paths=(os.path.join(tmp, "missing.mmdb"),),
                        captcha_jwks_path=os.path.join(tmp, "jwks.json"),
                        tls_dir=os.path.join(tmp, "tls"))

    async def start():
        await plane.start()
        return asyncio.ensure_future(plane.serve_forever())

    t0 = time.monotonic()
    plane.task = lt.run(start())
    plane.boot_s = time.monotonic() - t0
    return plane


def native_plane_stop(lt, plane) -> None:
    async def stop():
        plane.task.cancel()
        await plane.stop()

    lt.run(stop())
    if plane.sidecar_error is not None:
        fail(f"the ring sidecar died: {plane.sidecar_error!r}")


def native_pass(label, client, plane, port, reqs, bodies, sources) -> dict:
    """The client's requests through the httpd, with the kernels' launch
    counts set to 0 just before and read just after, and the httpd's
    counters read before and after."""
    import numpy as np

    from pingoo_tpu_torch.ops import _build

    sidecar = plane.sidecar
    m0 = native_metrics(port)
    p0, b0 = sidecar.processed, sidecar.batches
    with HeartbeatSampler(sidecar.rings[0]) as hb:
        _build.reset_launch_counts()
        out = client.send("h1", port, native_jobs(reqs, bodies),
                          NATIVE_CONNS, sources)
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
    delta = native_delta(m0, native_metrics(port))
    results = out["results"]
    if any(r is None for r in results) or out["leftover"]:
        fail(f"native {label}: {sum(r is None for r in results)} of "
             f"{len(results)} requests unanswered, {out['leftover']} bytes "
             f"after the last responses")
    lat = np.array([r[4] for r in results])
    batches = sidecar.batches - b0
    res = dict(
        requests=len(reqs), conns=NATIVE_CONNS,
        bodies=sum(b is not None for b in bodies),
        req_per_s=len(reqs) / out["wall_s"], wall_s=out["wall_s"],
        latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        batches=batches, rows_per_batch=(sidecar.processed - p0) / batches
        if batches else 0.0, launches=launches,
        max_heartbeat_age_ms=hb.max_age_ms,
        httpd={k: delta[k] for k in ("requests", "verdicts", "blocked",
                                     "captcha", "ua_rejected", "fail_open",
                                     "degraded_entered")},
        body=delta["body"])
    res["check"] = [(native_fields(t, quote_target(t.url),
                                   sources[i % NATIVE_CONNS], r[3]),
                     body, r[:3])
                    for i, (t, body, r) in enumerate(zip(reqs, bodies,
                                                         results))]
    print(f"native {label}: {len(reqs)} requests over {NATIVE_CONNS} "
          f"connections, {res['req_per_s']:.0f} req/s, latency p50 "
          f"{res['latency_p50_ms']:.2f} ms p99 {res['latency_p99_ms']:.2f} "
          f"ms, {batches} batches of {res['rows_per_batch']:.1f} rows, "
          f"heartbeat age at most {hb.max_age_ms} ms, httpd {res['httpd']}, "
          f"body {res['body']}, launches {launches}", flush=True)
    return res


def native_check(label, res, oracle) -> dict:
    """Hold every response of a pass to the oracle, and the httpd's
    counters to what the oracle says it answered; returns the counts of
    each outcome."""
    bad, kinds = [], {}
    gated = blocks = captchas = 0
    for (fields, body, (status, ctype, got)), (act, _, service) in zip(
            res.pop("check"), oracle):
        ua = fields["user_agent"]
        passes_gate = bool(ua) and len(ua) < 256
        gated += passes_gate
        blocks += passes_gate and act == 1
        captchas += passes_gate and act == 2
        want = native_expect(fields["method"], ua, fields["path"], act,
                             service)
        have = (status, ctype.split(";")[0].strip(), native_class(got))
        kinds[want[2]] = kinds.get(want[2], 0) + 1
        if have != want:
            bad.append((fields["method"], fields["url"], fields["ip"], want,
                        have))
    if bad:
        fail(f"native {label}: {len(bad)} of {res['requests']} responses "
             f"differ from the oracle, e.g. {bad[:5]}")
    h = res["httpd"]
    want = dict(requests=res["requests"], verdicts=gated, blocked=blocks,
                captcha=captchas, ua_rejected=res["requests"] - gated,
                fail_open=0, degraded_entered=0)
    if h != want:
        fail(f"native {label}: the httpd's counters moved by {h}, the "
             f"oracle says {want}")
    if res["body"]["fail_open"]:
        fail(f"native {label}: {res['body']['fail_open']} body scans "
             f"failed open")
    print(f"native {label}: every response as the oracle says: {kinds}; "
          f"the httpd's counters moved as the oracle says: {want}",
          flush=True)
    return kinds


def run_profiled(cmd, slice_s: float):
    """Run `cmd` to its end under torch.profiler (device activity), in
    one session per `slice_s` of wall time. Returns the completed
    process, the seconds from its start to the card's last kernel, the
    sessions, each one's stop seconds and the port's kernels' launches
    counted in each (the wrappers' counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pingoo_tpu_torch.ops import _build

    def launched() -> int:
        return sum(k.launches for k in _build.KERNELS.values())

    def session():
        p = profile(activities=[ProfilerActivity.CUDA])
        p.start()
        counted.append(-launched())
        return p

    def stop():
        counted[-1] += launched()
        t1 = time.monotonic()
        sessions[-1].stop()
        stops.append(time.monotonic() - t1)

    counted, stops = [], []
    sessions = [session()]  # the first start sets CUPTI up: off the clock
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    while True:
        try:
            out, err = proc.communicate(timeout=slice_s)
            break
        except subprocess.TimeoutExpired:
            if time.monotonic() - t0 > 300:
                proc.kill()
                fail(f"{cmd[0]} ran past 300 s")
            stop()
            sessions.append(session())
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    stop()
    return (subprocess.CompletedProcess(cmd, proc.returncode, out, err),
            wall_s, sessions, stops, counted)


def native_loadgen(label, plane, port: int, args, profiled=False) -> dict:
    """One run of loadgen_http against the httpd (bench.py's bench_e2e),
    with the kernels' launch counts set to 0 just before and read just
    after, the httpd's counters, the sidecar's stages and the heartbeat
    around it."""
    import numpy as np

    from pingoo_tpu_torch import native_ring
    from pingoo_tpu_torch.ops import _build

    sidecar = plane.sidecar
    m0 = native_metrics(port)
    w0 = sidecar.ring_telemetry()["wait_hist"]
    p0, b0 = sidecar.processed, sidecar.batches
    s0 = {k: w.count for k, w in sidecar.stage_ms.items()}
    cmd = [str(native_ring.binary_path("loadgen_http")), str(port),
           *map(str, args)]
    with HeartbeatSampler(sidecar.rings[0]) as hb:
        _build.reset_launch_counts()
        if profiled:
            proc, wall_s, sessions, stops, counted = run_profiled(
                cmd, NATIVE_PROFILE_SLICE_S)
        else:
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            wall_s = time.monotonic() - t0
        # After the profiler's last stop: its cost to the heartbeat shows.
        m1 = native_metrics(port)
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
    if proc.returncode != 0:
        fail(f"native {label}: loadgen_http exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    delta = native_delta(m0, m1)
    ring_waits = [b - a for a, b in zip(
        w0, sidecar.ring_telemetry()["wait_hist"])]
    stages = {k: w.since(s0[k]) for k, w in sidecar.stage_ms.items()
              if w.count > s0[k]}
    batches = sidecar.batches - b0
    res = dict(
        args=list(args), req_per_s=out["req_per_s"],
        added_p50_ms=out["p50_ms"], added_p90_ms=out["p90_ms"],
        added_p99_ms=out["p99_ms"], completed=out["completed"],
        blocked=out["blocked"], errors=out["errors"],
        elapsed_s=out["elapsed_s"],
        httpd={k: delta[k] for k in ("requests", "verdicts", "blocked",
                                     "fail_open", "degraded_entered")},
        verdict_wait_hist=delta["verdict_wait_ms_hist"],
        # Enqueue to the verdict applied (the httpd), and to the verdict
        # posted (the sidecar, the ring's telemetry).
        verdict_wait_p50=hist_percentile(
            [delta["verdict_wait_ms_hist"][k] for k in NATIVE_HIST_KEYS],
            NATIVE_HIST_BOUNDS, .5),
        verdict_wait_p99=hist_percentile(
            [delta["verdict_wait_ms_hist"][k] for k in NATIVE_HIST_KEYS],
            NATIVE_HIST_BOUNDS, .99),
        ring_wait_p50=hist_percentile(
            ring_waits, native_ring.WAIT_BUCKET_BOUNDS_MS + (None,), .5),
        ring_wait_p99=hist_percentile(
            ring_waits, native_ring.WAIT_BUCKET_BOUNDS_MS + (None,), .99),
        ring_wait_hist=ring_waits,
        batches=batches,
        rows_per_batch=(sidecar.processed - p0) / batches if batches else 0,
        stage_ms={k: dict(p50=float(np.percentile(v, 50)),
                          mean=float(np.mean(v)), max=float(np.max(v)))
                  for k, v in stages.items()},
        # The sidecar's stages' share of the pass's wall time.
        sidecar_busy_pct=100 * sum(map(sum, stages.values())) / 1e3
        / wall_s, wall_s=wall_s,
        max_heartbeat_age_ms=hb.max_age_ms, launches=launches,
        launches_per_batch={k: v / batches if batches else 0.0
                            for k, v in launches.items()})
    if profiled:
        per = [session_device(p) for p in sessions]
        busy_ms = sum(us for us, _ in per) / 1e3
        res["device_busy_ms"] = busy_ms if busy_ms > 0 else "not measured"
        res["device_busy_pct"] = 100 * busy_ms / (wall_s * 1e3) \
            if busy_ms > 0 else "not measured"
        # Launches of the port's kernels the sessions recorded, of those
        # the wrappers counted: how much of the run the trace saw.
        res["profiler"] = dict(
            sessions=len(sessions), stop_s=sum(stops),
            longest_stop_s=max(stops),
            launches_recorded=sum(n for _, n in per),
            launches_counted=sum(counted),
            per_session=[(us / 1e3, n, c)
                         for (us, n), c in zip(per, counted)])
    print(f"native {label}: loadgen_http {' '.join(map(str, args))}: "
          f"{res['req_per_s']:.0f} req/s, added p50 {res['added_p50_ms']:.2f}"
          f" ms p99 {res['added_p99_ms']:.2f} ms, blocked {res['blocked']}, "
          f"errors {res['errors']}, httpd {res['httpd']}, verdict wait "
          f"(httpd) p50 {res['verdict_wait_p50']} p99 "
          f"{res['verdict_wait_p99']}, (ring) p50 {res['ring_wait_p50']} p99 "
          f"{res['ring_wait_p99']}, {batches} batches of "
          f"{res['rows_per_batch']:.1f} rows, stage ms {res['stage_ms']}, "
          f"sidecar busy {res['sidecar_busy_pct']:.1f}% of the wall, "
          f"heartbeat age at most {hb.max_age_ms} ms, launches per batch "
          f"{res['launches_per_batch']}"
          + (f", device busy {res['device_busy_ms']} ms = "
             f"{res['device_busy_pct']}% of the wall; the profiler's "
             f"{len(sessions)} sessions stopped in {sum(stops):.3f} s, the "
             f"longest stop {max(stops):.3f} s, and recorded "
             f"{res['profiler']['launches_recorded']} of the "
             f"{res['profiler']['launches_counted']} launches of the port's "
             f"kernels" if profiled else ""),
          flush=True)
    return res


def native_loadgen_check(label, res) -> None:
    n, _, permille = res["args"]
    want = sum(1 for seq in range(n) if seq % 1000 < permille)
    h = res["httpd"]
    if (res["completed"], res["errors"], res["blocked"]) != (n, 0, want) \
            or h != dict(requests=n, verdicts=n, blocked=want, fail_open=0,
                         degraded_entered=0):
        fail(f"native {label}: loadgen_http completed {res['completed']} "
             f"of {n} with {res['errors']} errors and {res['blocked']} "
             f"blocked (want {want}); the httpd's counters moved by {h}")


def native_phase(device=None, n: int = N_REQUESTS) -> int:
    """The native plane, in a process of its own: the C++ httpd (built
    from pingoo_tpu_torch/native) in front of the port's RingSidecar on
    the card, through NativePlane as `python -m pingoo_tpu_torch
    --native-plane` runs it. First a line with what `ldconfig -p` lists
    of libssl, libcrypto and libnghttp2 and the builds' seconds.
    The listener phase's deployment (its captcha rule, the static
    service, `api` proxied to C++ pong), with the source addresses of
    every NATIVE_LISTED_EVERY-th client connection added to its IP list:
    (1) the listener client sends the slice phase's stream over
    NATIVE_CONNS keep-alive connections bound to addresses in
    127.0.0.0/8; every response must be the interpreter oracle's outcome
    on the tuple the httpd derives (peer address, asn 0, country XX, the
    302 captcha redirect), and the httpd's counters must move as the
    oracle says (verdicts for every request past the user-agent gate,
    blocks, captchas, no fail-open, no degraded entry), with all three
    kernels launched; (2) bench.py's end-to-end drive: loadgen_http's
    warm-up run, the measured run and a shorter one at its load under
    torch.profiler in sessions of NATIVE_PROFILE_SLICE_S (the httpd's
    counters read after the last stop), each blocking exactly the attacks
    it sent, without error, fail-open or degraded entry; (3) a fresh
    plane with PINGOO_BODY_INSPECT=on, a seed-set body on every fourth
    of NATIVE_BODIES requests, each response the
    merged oracle's, no body scan failed open; (4) `python -m
    pingoo_tpu_torch --native-plane` answers a blocked, a captcha and a
    proxied request and exits 0 within 20 s of SIGTERM with no httpd
    left. Prints one JSON line {"native": ...}, but no result line."""
    import multiprocessing
    import resource
    import socket
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from pingoo_tpu_torch import native_ring
    from pingoo_tpu_torch.engine.batch import RequestTuple
    from pingoo_tpu_torch.expr import Ip
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.utils.crs import (deployment, generate_ruleset,
                                            generate_traffic)

    t_phase = time.monotonic()
    steps = {}  # seconds of each step of the phase, in order
    t_step = [t_phase]

    def step(name: str) -> None:
        now = time.monotonic()
        steps[name] = now - t_step[0]
        t_step[0] = now

    listing = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True).stdout
    sonames = sorted({line.strip().split(" ", 1)[0]
                      for line in listing.splitlines()
                      if re.search(r"libssl|libcrypto|libnghttp2", line)})
    try:
        took = native_ring.ensure_built()
    except RuntimeError as exc:
        fail(f"native: ldconfig -p lists {sonames}; {exc}")
    print(f"native: ldconfig -p lists {sonames}; builds "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()),
          flush=True)
    step("builds")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _build.build()  # run alone, the phase builds the kernels here
    # loadgen_http holds 4,096 connections, and the httpd as many again
    # with their upstream hops.
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard == resource.RLIM_INFINITY or hard > soft:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    nofile = resource.getrlimit(resource.RLIMIT_NOFILE)[0]

    rules, lists = generate_ruleset(500)
    reqs = generate_traffic(n, attack_fraction=0.3, seed=SEED, lists=lists)
    sources = native_sources(NATIVE_CONNS)
    listed = sources[::NATIVE_LISTED_EVERY]
    lists = dict(lists, blocked_ips=list(lists["blocked_ips"])
                 + [Ip(a) for a in listed])
    bodies = body_ring_bodies(NATIVE_BODIES)

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        pong = subprocess.Popen([str(native_ring.binary_path("pong")), "0"],
                                stdout=subprocess.PIPE, text=True)
        pong_port = json.loads(pong.stdout.readline())["listening"]
        www = os.path.join(tmp, "www")
        os.makedirs(www)
        for name, content in LISTENER_WWW.items():
            with open(os.path.join(www, name), "wb") as f:
                f.write(content)
        raw = deployment(rules, lists, tmp, services={
            "api": {"route": LISTENER_API_ROUTE,
                    "http_proxy": [f"http://127.0.0.1:{pong_port}"]},
            "www": {"static": {"root": www}}})
        for (name, expression), action in ((LISTENER_CAPTCHA_RULE,
                                            "captcha"),
                                           (NATIVE_XSS_RULE, "block")):
            raw["rules"][name] = {"expression": expression,
                                  "actions": [{"action": action}]}
        pool = ProcessPoolExecutor(
            LISTENER_ORACLE_WORKERS,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=listener_oracle_init, initargs=(raw,))
        ready = [pool.submit(listener_oracle, [])
                 for _ in range(LISTENER_ORACLE_WORKERS)]
        # The loadgen's shapes first: its attacks must be blocked and its
        # clean paths allowed, or the blocked count proves nothing.
        shapes = NATIVE_LOADGEN_ATTACKS + NATIVE_LOADGEN_CLEAN
        shape_oracle = pool.submit(listener_oracle, [(dict(
            host="bench.test", url=u, path=u.split("?", 1)[0],
            method="GET", user_agent="pingoo-bench/1.0", ip="127.0.0.1",
            remote_port=40000, asn=0, country="XX"), None)
            for u in shapes])
        step("set-up")
        lt = LoopThread()
        client = ListenerClient()
        try:
            port = free_port()
            raw["listeners"] = {"http": {"address":
                                         f"http://127.0.0.1:{port}"}}
            # The oracle's processes start while the plane boots.
            plane = native_plane_start(lt, raw, tmp, "state", device)
            step("boot")
            acts = [a for a, _, _ in shape_oracle.result()]
            if acts != [1] * len(NATIVE_LOADGEN_ATTACKS) \
                    + [0] * len(NATIVE_LOADGEN_CLEAN):
                fail(f"native: the oracle answers loadgen_http's shapes "
                     f"{list(zip(shapes, acts))}: its attacks must block "
                     f"and its clean paths pass")
            step("oracle start")
            print(f"native: NativePlane on {plane.server.device} with "
                  f"{len(plane.server.plan.rules)} columns, the httpd on "
                  f"port {port} after {plane.boot_s:.1f} s (warm-up "
                  f"{sum(ms for *_, ms in plane.warm_up):.0f} ms over "
                  f"{len(plane.warm_up)} batches), pong on {pong_port}, "
                  f"{len(listed)} of {NATIVE_CONNS} client addresses "
                  f"listed, RLIMIT_NOFILE {nofile}", flush=True)
            none = [None] * n
            results["correctness"] = native_pass(
                "correctness", client, plane, port, reqs, none, sources)
            step("correctness")
            loadgen = {}
            for label, args, prof in (("warm", NATIVE_LOADGEN_WARM, False),
                                      ("throughput", NATIVE_LOADGEN, False),
                                      ("profiled", NATIVE_LOADGEN_PROFILED,
                                       True)):
                loadgen[label] = native_loadgen(label, plane, port, args,
                                                prof)
                step(f"loadgen {label}")
            liveness = native_liveness(port, plane, [
                results["correctness"]["max_heartbeat_age_ms"],
                *(r["max_heartbeat_age_ms"] for r in loadgen.values())])
            step("liveness")
            sidecar_stats = {k: v for k, v in plane.sidecar.stats().items()
                             if k != "ring_telemetry"}
            boot_s, warm_up = plane.boot_s, plane.warm_up
            native_plane_stop(lt, plane)
            step("stop")
            os.environ["PINGOO_BODY_INSPECT"] = "on"
            try:
                port = free_port()
                raw_body = dict(raw, listeners={"http": {
                    "address": f"http://127.0.0.1:{port}"}})
                plane = native_plane_start(lt, raw_body, tmp, "state-body",
                                           device)
                results["body"] = native_pass(
                    "body", client, plane, port, reqs[:NATIVE_BODIES],
                    bodies, sources)
                body_verdicts = plane.sidecar.body_verdicts
                native_plane_stop(lt, plane)
            finally:
                os.environ.pop("PINGOO_BODY_INSPECT")
            step("body boot, pass and stop")
            entry = listener_entry_point(raw, tmp, LISTENER_PROBES, device,
                                         native=True)
            step("entry point")
        except BaseException:
            pool.shutdown(cancel_futures=True)
            raise
        finally:
            client.close()
            lt.close()
            pong.kill()
            pong.wait(timeout=30)
        t0 = time.monotonic()
        for f in ready:
            f.result()
        jobs = [(native_fields(RequestTuple(
            host="www.example.com", url=target, method=m, user_agent=ua,
            ip="127.0.0.1"), target, "127.0.0.1", local), None)
            for (_, m, target, ua), (*_, local) in zip(LISTENER_PROBES,
                                                      entry["answers"])]
        for res in results.values():
            jobs += [(fields, body) for fields, body, _ in res["check"]]
        chunk = 256
        futures = [pool.submit(listener_oracle, jobs[i:i + chunk])
                   for i in range(0, len(jobs), chunk)]
        oracle = [o for f in futures for o in f.result()]
    pool.shutdown()
    step("oracle")
    print("native phase steps (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in steps.items()), flush=True)
    print(f"native oracle: {len(oracle)} requests interpreted in "
          f"{time.monotonic() - t0:.1f} s in {LISTENER_ORACLE_WORKERS} "
          f"processes", flush=True)
    for (label, m, target, ua), (status, got, _), (act, _, service), \
            kind in zip(LISTENER_PROBES, entry["answers"], oracle,
                        ("block", "empty", "pong")):
        want = native_expect(m, ua, target.split("?", 1)[0], act, service)
        if (status, got) != (want[0], want[2]) or want[2] != kind:
            fail(f"python -m pingoo_tpu_torch --native-plane answered "
                 f"{label} with {(status, got)}, the oracle says {want}")
    at = len(LISTENER_PROBES)
    kinds = {}
    for label, res in results.items():
        kinds[label] = native_check(label, res,
                                    oracle[at:at + res["requests"]])
        at += res["requests"]
    for label in ("correctness", "body"):
        missing = [k for k, c in results[label]["launches"].items()
                   if c == 0]
        if missing:
            fail(f"the native {label} pass launched no {missing} kernel")
    for label in ("throughput", "profiled"):
        native_loadgen_check(label, loadgen[label])
    if not body_verdicts:
        fail("the body pass's sidecar posted no body verdict")
    check_ladder("native phase")
    ledger_check("native phase's process")
    print(json.dumps({"native": dict(
        requests=n, conns=NATIVE_CONNS, listed=len(listed),
        boot_s=boot_s, warm_up=warm_up, builds=took, sonames=sonames,
        nofile=nofile, passes=results, loadgen=loadgen, outcomes=kinds,
        entry_point=entry, sidecar=sidecar_stats, liveness=liveness,
        body_verdicts=body_verdicts, steps_s=steps,
        seconds=time.monotonic() - t_phase)}), flush=True)
    return 0


def native_child() -> dict:
    """`native_phase` in a process of its own; returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--native-phase"],
        capture_output=True, text=True, timeout=900)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"the native phase exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    print(f"native phase: {time.monotonic() - t0:.1f} s", flush=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])["native"]


# -- the bot phase: the bot-score head (models/botscore.py) ------------------

# Executor arms of the bot and swap phases: (PINGOO_PIPELINE,
# PINGOO_STAGING, PINGOO_MEGASTEP).
BOT_ARMS = {"off": ("off", "full", "off"), "on": ("on", "full", "off"),
            "compact": ("on", "compact", "off"),
            "force": ("on", "full", "force")}
BOT_TOLERANCE = 1e-5
# Scorer calls queued behind one sleep: the head is about a hundred
# small launches a call, and the stream's launch queue holds about a
# thousand.
BOT_QUEUED_CALLS = 6


def set_executor(arm) -> None:
    pipe, staging, mega = arm
    os.environ.update(PINGOO_PIPELINE=pipe, PINGOO_STAGING=staging,
                      PINGOO_MEGASTEP=mega)


def clear_executor() -> None:
    for name in ("PINGOO_PIPELINE", "PINGOO_STAGING", "PINGOO_MEGASTEP"):
        os.environ.pop(name, None)


def warmed_service(plan, lists, reqs, dev, **kw):
    """A VerdictService(max_batch=B) under the current executor, after a
    warm-up pass of `reqs` one batch at a time (under the megastep its
    graphs captured in the global mode, where any call of the slice body
    illegal under capture would raise), its statistics started afresh."""
    from pingoo_tpu_torch.engine.service import VerdictService

    service = VerdictService(plan, lists, max_batch=B, device=dev, **kw)
    if service._mega_runner is not None:
        service._mega_runner.capture_mode = "global"
    for lo in range(0, len(reqs), B):
        service.evaluate_batch(reqs[lo:lo + B])
    if service._mega_runner is not None:
        service._mega_runner.capture_mode = "thread_local"
    service.stats = type(service.stats)(
        service.WINDOW, service.stats.epoch, sched=service.sched.snapshot,
        ladder=service.ladder.snapshot)
    return service


def plain_scores(params, plan, reqs, staging: str):
    """The head's scores of `reqs` on the CPU (the plain computation),
    over the arrays the service stages under `staging`: the bucketed
    full-width batch, or the compact encoder's capped views at the
    plan's caps."""
    import numpy as np

    from pingoo_tpu_torch.engine.batch import (StagingEncoder, batch_tensors,
                                               bucket_arrays, encode_requests,
                                               pow2_batch_size,
                                               resolve_stage_caps,
                                               stage_overflow_thresholds)
    from pingoo_tpu_torch.models import botscore

    cpu = params.to("cpu")
    enc = None
    if staging == "compact":
        os.environ["PINGOO_STAGING"] = "compact"
        caps = resolve_stage_caps(plan)
        os.environ.pop("PINGOO_STAGING")
        enc = StagingEncoder(B, plan.field_specs, nbuf=1, stage_caps=caps,
                             overflow_thresholds=stage_overflow_thresholds(
                                 plan, caps))
    out = []
    for lo in range(0, len(reqs), B):
        chunk = reqs[lo:lo + B]
        staged = None
        if enc is None:
            arrays = bucket_arrays(encode_requests(chunk,
                                                   plan.field_specs).arrays)
        else:
            staged = enc.checkout()
            arrays = enc.encode_requests(
                chunk, pad_to=pow2_batch_size(len(chunk), B),
                into=staged).arrays
        out.append(botscore.score(cpu, batch_tensors(
            arrays, "cpu")).numpy()[:len(chunk)].copy())
        if staged is not None:
            enc.release(staged)
    return np.concatenate(out)


def bot_phase(plan, lists, reqs, dev, oracle) -> dict:
    """The bot head on the 500-rule corpus at max_batch B and full width:
    weights from a seeded torch.Generator, saved to npz and loaded back
    onto the card. Under PINGOO_PIPELINE=off, on (full), on with compact
    staging and PINGOO_MEGASTEP=force, the scores of all N_REQUESTS equal
    the plain CPU computation within BOT_TOLERANCE, and the verdicts the
    oracle's and those of the same service without the head. Then the
    scorer's µs a batch (queued and issued) and req/s of the main path
    with and without the head, in turn, in this process. Returns the
    phase's numbers, the kernels' launches of the head's main-path pass
    included."""
    import tempfile

    import numpy as np
    import torch

    from pingoo_tpu_torch.engine.batch import batch_tensors, bucket_arrays, \
        encode_requests
    from pingoo_tpu_torch.engine.verdict import action_lanes
    from pingoo_tpu_torch.models import botscore
    from pingoo_tpu_torch.ops import _build

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "head.npz")
        botscore.save_params(botscore.init_params(
            torch.Generator().manual_seed(SEED), device="cpu"), path)
        params = botscore.load_params(path, device=dev)
    o_act, o_vb = action_lanes(plan, oracle)
    arms = {}
    plain = {}
    for name, arm in BOT_ARMS.items():
        set_executor(arm)
        try:
            runs = {}
            for head in (None, params):
                service = warmed_service(plan, lists, reqs, dev,
                                         bot_score_params=head)
                _build.reset_launch_counts()
                verdicts, wall = asyncio.run(serve(service, reqs))
                launches = {k: v.launches for k, v in _build.KERNELS.items()}
                runs[head is not None] = (verdicts, wall, launches, service)
        finally:
            clear_executor()
        (v0, wall0, _, _), (v1, wall1, launches, service) = \
            runs[False], runs[True]
        matched = np.stack([v.matched for v in v1])
        act = np.array([v.action for v in v1])
        vb = np.array([v.verified_block for v in v1])
        if (matched != np.stack([v.matched for v in v0])).any() \
                or (act != np.array([v.action for v in v0])).any():
            fail(f"bot arm {name}: verdicts with the head differ from "
                 f"those without it")
        if (matched != oracle).any() or (act != o_act).any() \
                or (vb != o_vb).any():
            fail(f"bot arm {name}: verdicts differ from the oracle")
        staging = arm[1]
        if staging not in plain:
            plain[staging] = plain_scores(params, plan, reqs, staging)
        got = np.array([v.bot_score for v in v1])
        err = float(np.abs(got - plain[staging]).max())
        if not err <= BOT_TOLERANCE or not np.isfinite(got).all():
            fail(f"bot arm {name}: scores differ from the plain CPU "
                 f"computation by {err} (limit {BOT_TOLERANCE})")
        if any(v.bot_score != 0.0 for v in v0):
            fail(f"bot arm {name}: a service without the head scored")
        if service.stats.snapshot()["score_errors"] != 0:
            fail(f"bot arm {name}: score_errors moved")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            fail(f"bot arm {name}: the path launched no {missing} kernel")
        arms[name] = dict(max_abs_err=err, req_per_s=N_REQUESTS / wall1,
                          req_per_s_without=N_REQUESTS / wall0,
                          launches=launches,
                          mean_score=float(got.mean()),
                          scores_over_half=int((got > 0.5).sum()))
        print(f"bot arm {name} (PINGOO_PIPELINE={arm[0]} PINGOO_STAGING="
              f"{arm[1]} PINGOO_MEGASTEP={arm[2]}): {N_REQUESTS} scores "
              f"within {err:.3g} of the plain CPU computation, verdicts "
              f"equal the oracle's and the headless service's; "
              f"{N_REQUESTS / wall1:.0f} req/s with the head, "
              f"{N_REQUESTS / wall0:.0f} without; launches {launches}",
              flush=True)
    # The scorer alone on one full-width batch, and the main path (`on`)
    # with and without the head in turn: without, with, with, without.
    arrays = batch_tensors(bucket_arrays(
        encode_requests(reqs[:B], plan.field_specs).arrays), dev)

    def score():
        botscore.score(params, arrays)

    queued = queued_ms(score, BOT_QUEUED_CALLS)
    issued = cuda_ms(score, 15)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        score()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    timed = []
    set_executor(BOT_ARMS["on"])
    try:
        for head in (None, params, params, None):
            service = warmed_service(plan, lists, reqs, dev,
                                     bot_score_params=head)
            _, wall = asyncio.run(serve(service, reqs))
            timed.append((head is not None, N_REQUESTS / wall))
    finally:
        clear_executor()
    with_head = [r for h, r in timed if h]
    without = [r for h, r in timed if not h]
    out = dict(arms=arms, launches=arms["on"]["launches"],
               score_queued_us=queued * 1e3, score_issued_us=issued * 1e3,
               score_device_ops=kernels,
               req_per_s_with=with_head, req_per_s_without=without,
               seconds=time.monotonic() - t_phase)
    print(f"bot head: {queued * 1e3:.1f} µs queued, {issued * 1e3:.1f} µs "
          f"issued a batch of {B} full-width rows, {kernels} device "
          f"kernels and copies a call (torch.profiler); the main path (on) "
          f"without / with / with / without the head: "
          + " / ".join(f"{r:.0f}" for _, r in timed)
          + f" req/s; phase {out['seconds']:.1f} s", flush=True)
    return out


# -- the swap phase: hot-swap and the artifact cache ---------------------------

# Epoch 1's ruleset: generate_ruleset(500, seed=SWAP_SEED), whose pf_url,
# dfa_win_url and ASN bitset have other shapes than epoch 0's.
SWAP_SEED = 5
SWAP_ARMS = {k: BOT_ARMS[k] for k in ("off", "on", "force")}
SWAP_RING_ARMS = {"on": "off", "force": "force"}  # arm: PINGOO_MEGASTEP
# The ring arms' producer stream, driven again and again until the swap
# has flipped, then twice more.
SWAP_RING_SEED = 31
SWAP_RING_CHUNK = 2048
SWAP_RING_MAX_CHUNKS = 2000
SWAP_RING_AFTER = 1024  # requests processed before the swap is asked for


def swap_ring_requests():
    """The ring swap arms' stream: generate_traffic(SWAP_RING_CHUNK,
    seed=SWAP_RING_SEED) over the corpus's lists, every second request's
    address taken from an IP list, epoch 0's and epoch 1's in turn. The
    two rulesets come from one generator and block the same attacks, so
    those addresses are what tells the epochs' verdicts apart."""
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    lists = (generate_ruleset(500)[1],
             generate_ruleset(500, seed=SWAP_SEED)[1])
    reqs = generate_traffic(SWAP_RING_CHUNK, lists=lists[0],
                            seed=SWAP_RING_SEED)
    for i, r in enumerate(reqs):
        if i % 2:
            ips = lists[(i // 2) % 2]["blocked_ips"]
            r.ip = str(ips[(i * 7919) % len(ips)]).split("/")[0]
    return reqs


def table_arrays(plan) -> dict:
    return {k: (v.numpy_arrays(), v.meta()) for k, v in
            plan.np_tables.items()}


def tables_equal(a: dict, b: dict) -> bool:
    import numpy as np

    if sorted(a) != sorted(b):
        return False
    for key, (arrs, meta) in a.items():
        other, other_meta = b[key]
        if meta != other_meta or sorted(arrs) != sorted(other):
            return False
        for name, x in arrs.items():
            y = other[name]
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not np.array_equal(x, y):
                return False
    return True


def swap_cache(rules, lists, plan0, dev, tmp) -> tuple:
    """Epoch 1's plan through the artifact cache: a cold call (compile,
    prove, write) and a warm one (load, place on the card), timed, the
    proof timed inside the cold one; the hit's tables on the card and
    bit-equal to a fresh compile's and the cold call's."""
    from pingoo_tpu_torch.compiler import cache as cache_mod
    from pingoo_tpu_torch.compiler.plan import compile_ruleset

    prove_s = []
    real = cache_mod.prove_plan

    def timed_prove(plan, fingerprint=""):
        t0 = time.monotonic()
        out = real(plan, fingerprint)
        prove_s.append(time.monotonic() - t0)
        return out

    cache_mod.prove_plan = timed_prove
    try:
        t0 = time.monotonic()
        cold = cache_mod.compile_ruleset_cached(rules, lists, cache_dir=tmp,
                                                device=dev)
        cold_s = time.monotonic() - t0
        t0 = time.monotonic()
        warm = cache_mod.compile_ruleset_cached(rules, lists, cache_dir=tmp,
                                                device=dev)
        warm_s = time.monotonic() - t0
    finally:
        cache_mod.prove_plan = real
    if len(prove_s) != 1:
        fail(f"the cold and warm cache calls proved {len(prove_s)} times, "
             f"not once")
    t0 = time.monotonic()
    fresh = compile_ruleset(rules, lists, device=dev)
    fresh_s = time.monotonic() - t0
    if warm is cold or any(t.device.type != "cuda"
                           for t in warm.np_tables.values()):
        fail("the cache's hit is not a plan with its tables on the card")
    want = table_arrays(fresh)
    if not tables_equal(table_arrays(warm), want) \
            or not tables_equal(table_arrays(cold), want):
        fail("the cache's plan differs from a fresh compile's")
    a0 = table_arrays(plan0)
    reshaped = sorted(k for k in set(a0) | set(want)
                      if k not in a0 or k not in want
                      or {n: x.shape for n, x in a0[k][0].items()}
                      != {n: x.shape for n, x in want[k][0].items()})
    if not reshaped:
        fail("epoch 1's tables have the shapes of epoch 0's")
    size = sum(os.path.getsize(os.path.join(tmp, f))
               for f in os.listdir(tmp))
    out = dict(cold_s=cold_s, warm_s=warm_s, prove_s=prove_s[0],
               fresh_compile_s=fresh_s, artifact_bytes=size,
               reshaped_tables=reshaped)
    print(f"cache: epoch 1's plan cold {cold_s:.2f} s (proof "
          f"{prove_s[0]:.2f} s), warm {warm_s:.2f} s, a fresh compile "
          f"{fresh_s:.2f} s; the hit's tables on the card and bit-equal to "
          f"the fresh compile's; artifact {size} bytes; tables of other "
          f"shapes than epoch 0's: {reshaped}", flush=True)
    return warm, out


# The force arms' capture-overlap step: how long the swap's first capture
# may hold the lock waiting for a serving capture, and the seeds tried for
# a ring request whose window shape the served runner has not captured.
OVERLAP_WAIT_S = 30.0
OVERLAP_RING_SEEDS = range(900, 932)


class HeldCaptureLock:
    """Stands in for engine/graphs.py's `_CAPTURE_LOCK` in a force arm's
    overlap step. The first thread to take it (a swap's warm-up: the
    serving side has then captured every shape it has served) holds it,
    before its capture, until a second thread waits for it, at most
    OVERLAP_WAIT_S: so a serving capture of a new window shape surely
    meets the swap's capture in progress. `met` says whether one did."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = threading.Lock()
        self.arrived = 0
        self.holding = threading.Event()
        self.met = False

    def __enter__(self):
        with self._count:
            self.arrived += 1
        self._lock.acquire()
        if not self.holding.is_set():
            self.holding.set()
            deadline = time.monotonic() + OVERLAP_WAIT_S
            while self.arrived < 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            self.met = self.arrived >= 2
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


@contextlib.contextmanager
def held_capture_lock():
    from pingoo_tpu_torch.engine import graphs

    held, real = HeldCaptureLock(), graphs._CAPTURE_LOCK
    graphs._CAPTURE_LOCK = held
    try:
        yield held
    finally:
        graphs._CAPTURE_LOCK = real


def lone_want(plan, lists, req) -> tuple:
    """(matched row, action, verified_block) of one request under `plan`,
    by the interpreter."""
    from pingoo_tpu_torch.engine.batch import tuple_to_context
    from pingoo_tpu_torch.engine.verdict import (action_lanes,
                                                 interpret_rules_row)

    row = interpret_rules_row(plan, tuple_to_context(req, lists))
    act, vb = action_lanes(plan, row[None])
    return row, int(act[0]), bool(vb[0])


def overlap_report(label, held, before, after, res_pause_ms) -> dict:
    """Fails unless the serving capture met the swap's and was made;
    returns and prints the serving runner's wait for the lock."""
    made = after["captures"] - before["captures"]
    if not held.met or made < 1:
        fail(f"{label}: no serving capture met the swap's capture "
             f"(met {held.met}, serving captures {made})")
    wait_ms = after["capture_wait_ms_total"] - before["capture_wait_ms_total"]
    out = dict(serving_captures=made, serving_wait_ms=wait_ms,
               swap_pause_ms=res_pause_ms)
    print(f"{label}: a serving capture of a new window shape met the swap's "
          f"capture in progress; both made; the serving side waited "
          f"{wait_ms:.3f} ms for the capture lock over {made} capture(s); "
          f"the swap back to epoch 0's plan paused {res_pause_ms:.3f} ms",
          flush=True)
    return out


async def service_overlap(service, plan, lists, served) -> dict:
    """The Python force arm's overlap step on a started `service` serving
    epoch 1 (`served` = (plan, lists)): swap_plan back to `plan` (epoch
    2) under `held_capture_lock`; once the swap's capture holds the lock,
    a lone request with a 300-byte url and every other field empty (a
    window shape no batch of the stream had) is admitted, and its batch
    captures on the served runner. Its verdict must equal epoch 1's
    oracle, and the swap must succeed."""
    from pingoo_tpu_torch.engine.batch import RequestTuple

    runner = service._mega_runner
    before = runner.snapshot()
    req = RequestTuple(path="/" + "o" * 299, url="/" + "o" * 299)
    loop = asyncio.get_running_loop()
    with held_capture_lock() as held:
        swap = asyncio.ensure_future(service.swap_plan(plan, lists=lists,
                                                       tenant="epoch2"))
        if not await loop.run_in_executor(None, held.holding.wait,
                                          OVERLAP_WAIT_S):
            fail("Python force overlap: the swap never took the capture "
                 "lock")
        verdict = await service.evaluate(req)
        res = await swap
    after = runner.snapshot()
    row, act, vb = lone_want(*served, req)
    if verdict.epoch != 1 or (verdict.matched != row).any() \
            or verdict.action != act or verdict.verified_block != vb:
        fail(f"Python force overlap: the lone verdict (epoch "
             f"{verdict.epoch}) differs from epoch 1's oracle")
    if res["epoch"] != 2 or service.ruleset_epoch != 2:
        fail(f"Python force overlap: the swap back ended {res}")
    return overlap_report("Python force overlap", held, before, after,
                          res["pause_ms"])


def ring_overlap(sidecar, producer, plans, lists) -> dict:
    """The ring force arm's overlap step on a running sidecar serving
    epoch 1: a thread calls request_swap back to epoch 0's plan (epoch 2)
    under `held_capture_lock`; once its first capture holds the lock, the
    producer drives lone requests (seeds OVERLAP_RING_SEEDS) until one's
    window shape is new to the served runner, whose capture then waits
    for the swap's. Each lone ticket's action must equal epoch 1's
    oracle, and the swap must flip."""
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    ring_lists = generate_ruleset(500, with_lists=True,
                                  list_sizes=(4096, 512))[1]
    runner = sidecar._mega_runner
    before = runner.snapshot()
    got = {}

    def requester():
        try:
            got["handle"] = sidecar.request_swap(plans[0], lists=lists[0],
                                                 tenant="epoch2")
        except Exception as exc:
            got["error"] = exc

    thread = threading.Thread(target=requester, name="swap-requester")
    ages = []
    with held_capture_lock() as held:
        thread.start()
        if not held.holding.wait(OVERLAP_WAIT_S):
            fail("ring force overlap: the swap never took the capture lock")
        for seed in OVERLAP_RING_SEEDS:
            r = producer.drive(seed, 1)
            req = generate_traffic(1, lists=ring_lists, seed=seed)[0]
            _, act, vb = lone_want(plans[1], lists[1], req)
            if r.actions != bytes([act | (int(vb) << 2)]):
                fail(f"ring force overlap: the lone ticket of seed {seed} "
                     f"differs from epoch 1's oracle")
            ages.append(r.max_heartbeat_age_ms)
            if held.met:
                break
        thread.join(120)
    if "handle" not in got or not got["handle"].wait(60) \
            or got["handle"].result != "ok" or sidecar.ruleset_epoch != 2:
        fail(f"ring force overlap: the swap back failed: {got}")
    after = runner.snapshot()
    out = overlap_report("ring force overlap", held, before, after,
                         got["handle"].pause_ms)
    out.update(lone_drives=len(ages), max_heartbeat_age_ms=max(ages))
    return out


def swap_service_arm(name, plans, lists, reqs, dev, oracles, lanes) -> dict:
    """The Python plane under SWAP_ARMS[name]: a warmed service on epoch
    0 gets the first half of `reqs`, then `swap_plan` to epoch 1 while
    bursts of 256 more arrive every 2 ms until the flip (or up to three
    quarters of `reqs`), then the rest.
    Every verdict equals its epoch's oracle; every future resolves once."""
    import numpy as np

    from pingoo_tpu_torch.ops import _build

    set_executor(SWAP_ARMS[name])
    try:
        service = warmed_service(plans[0], lists[0], reqs, dev)
    finally:
        clear_executor()
    n = len(reqs)

    async def run():
        await service.start()
        try:
            futs = [asyncio.ensure_future(service.evaluate(r))
                    for r in reqs[:n // 2]]
            t0 = time.monotonic()
            swap = asyncio.ensure_future(service.swap_plan(
                plans[1], lists=lists[1], tenant="epoch1"))
            i, stop = n // 2, n - n // 4
            while not swap.done() and i < stop:
                futs += [asyncio.ensure_future(service.evaluate(r))
                         for r in reqs[i:min(i + 256, stop)]]
                i = min(i + 256, stop)
                await asyncio.sleep(0.002)
            res = await swap
            swap_s = time.monotonic() - t0
            futs += [asyncio.ensure_future(service.evaluate(r))
                     for r in reqs[i:]]
            out = await asyncio.gather(*futs), res, swap_s, i
            launches = {k: v.launches for k, v in _build.KERNELS.items()}
            overlap = await service_overlap(
                service, plans[0], lists[0], (plans[1], lists[1])) \
                if service._mega_runner is not None else None
            return out + (launches, overlap)
        finally:
            await service.stop()

    _build.reset_launch_counts()
    verdicts, res, swap_s, during, launches, overlap = asyncio.run(run())
    if len(verdicts) != n:
        fail(f"swap arm {name}: {len(verdicts)} verdicts for {n} requests")
    epochs = np.array([v.epoch for v in verdicts])
    if set(epochs.tolist()) != {0, 1} or res["epoch"] != 1:
        fail(f"swap arm {name}: epochs {sorted(set(epochs.tolist()))}, "
             f"swap {res}")
    bad = 0
    for i, v in enumerate(verdicts):
        act, vb = lanes[v.epoch]
        if (v.matched != oracles[v.epoch][i]).any() \
                or v.action != act[i] or v.verified_block != vb[i]:
            bad += 1
    if bad:
        fail(f"swap arm {name}: {bad} verdicts differ from their epoch's "
             f"oracle")
    if service.mega_echo_mismatch:
        fail(f"swap arm {name}: {service.mega_echo_mismatch} epoch echoes "
             f"differ")
    out = dict(pause_ms=res["pause_ms"], swap_s=swap_s,
               epoch0=int((epochs == 0).sum()),
               epoch1=int((epochs == 1).sum()),
               admitted_during_swap=during - n // 2, launches=launches,
               overlap=overlap)
    print(f"swap arm {name} (Python plane, PINGOO_PIPELINE="
          f"{SWAP_ARMS[name][0]} PINGOO_MEGASTEP={SWAP_ARMS[name][2]}): "
          f"{n} verdicts equal their epoch's oracle ({out['epoch0']} epoch "
          f"0, {out['epoch1']} epoch 1, {out['admitted_during_swap']} "
          f"admitted while the state was built); swap_plan {swap_s:.2f} s, "
          f"pause {res['pause_ms']:.3f} ms; launches {launches}",
          flush=True)
    return out


def swap_ring_arm(arm, ring, producer, plans, lists, wants, dev) -> dict:
    """The sidecar under PINGOO_PIPELINE=on and PINGOO_MEGASTEP=
    SWAP_RING_ARMS[arm], after warm_up(): the producer drives one stream
    of SWAP_RING_CHUNK requests again and again; once SWAP_RING_AFTER
    are processed a thread asks for the swap to epoch 1 (the new state
    built and warmed there), and after the flip the stream is driven
    twice more. Each ticket is
    posted once (drive_stream), the chunks before the flip carry epoch
    0's oracle, those after epoch 1's, and at most one chunk is split at
    the flip. The heartbeat stays under the data plane's limit. Under
    force, `ring_overlap` follows (epoch 2)."""
    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.ops import _build

    mega = SWAP_RING_ARMS[arm]
    set_executor(("on", "full", mega))
    try:
        sidecar = nr.RingSidecar(ring, plans[0], lists[0], max_batch=B,
                                 device=dev, pipeline_depth=3)
    finally:
        clear_executor()
    t0 = time.monotonic()
    sidecar.warm_up()
    warm_s = time.monotonic() - t0
    errors = []

    def run():
        try:
            sidecar.run()
        except Exception as exc:
            errors.append(exc)

    got = {}

    def requester():
        while sidecar.processed < SWAP_RING_AFTER and not errors:
            time.sleep(0.0005)
        t = time.monotonic()
        got["handle"] = sidecar.request_swap(plans[1], lists=lists[1],
                                             tenant="epoch1")
        got["build_s"] = time.monotonic() - t

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    req = threading.Thread(target=requester, daemon=True)
    req.start()
    drives = []
    _build.reset_launch_counts()
    try:
        after = 0  # drives begun after the flip
        while after < 2:
            if len(drives) >= SWAP_RING_MAX_CHUNKS:
                fail(f"ring swap arm {arm}: no flip after {len(drives)} "
                     f"drives")
            h = got.get("handle")
            flipped = h is not None and h.done.is_set()
            drives.append(producer.drive(SWAP_RING_SEED, SWAP_RING_CHUNK,
                                         0, 0, 1))
            after += flipped
        req.join(60)
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        overlap = ring_overlap(sidecar, producer, plans, lists) \
            if mega == "force" else None
    finally:
        sidecar.stop()
        thread.join(timeout=30)
    if errors or thread.is_alive():
        fail(f"ring swap arm {arm}: the drain loop failed: {errors}")
    handle = got["handle"]
    if handle.result != "ok" or handle.epoch != 1:
        fail(f"ring swap arm {arm}: the swap ended {handle.result} "
             f"({handle.error})")
    # Chunks all epoch 0, at most one split at the flip, then epoch 1.
    phase, split = 0, None
    for j, r in enumerate(drives):
        a = r.actions
        if phase == 0 and a == wants[0]:
            continue
        if a == wants[1]:
            phase = 1
            continue
        pre = next((i for i in range(len(a)) if a[i] != wants[0][i]), len(a))
        suf = next((i for i in range(len(a), 0, -1)
                    if a[i - 1] != wants[1][i - 1]), 0)
        if phase == 0 and suf <= pre:
            phase, split = 1, (j, suf)
            continue
        fail(f"ring swap arm {arm}: drive {j} matches neither epoch's "
             f"oracle nor a split of them")
    if drives[-1].actions != wants[1] or drives[-2].actions != wants[1]:
        fail(f"ring swap arm {arm}: the drives after the flip are not on "
             f"epoch 1")
    age = max(r.max_heartbeat_age_ms for r in drives)
    if age >= HEARTBEAT_LIMIT_MS:
        fail(f"ring swap arm {arm}: the heartbeat aged {age} ms")
    if sidecar.mega_echo_mismatch:
        fail(f"ring swap arm {arm}: {sidecar.mega_echo_mismatch} epoch "
             f"echoes differ")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"ring swap arm {arm}: the drives launched no {missing} "
             f"kernel")
    stats = sidecar.stats()
    out = dict(pause_ms=handle.pause_ms, build_s=got["build_s"],
               warm_up_s=warm_s, drives=len(drives), split=split,
               max_heartbeat_age_ms=age, launches=launches,
               req_per_s=[len(r.actions) / r.seconds for r in drives],
               graphs=stats["megastep"]["graphs"],
               echo_mismatch=sidecar.mega_echo_mismatch, overlap=overlap)
    print(f"ring swap arm {arm} (PINGOO_PIPELINE=on PINGOO_MEGASTEP="
          f"{mega}, after warm_up() {warm_s:.2f} s): {len(drives)} drives "
          f"of {SWAP_RING_CHUNK}, each ticket posted once on its epoch's "
          f"oracle (split drive {split}); request_swap built and warmed "
          f"epoch 1 in {got['build_s']:.2f} s on its thread, pause "
          f"{handle.pause_ms:.3f} ms; heartbeat age max {age} ms; echo "
          f"mismatches {sidecar.mega_echo_mismatch}; graphs "
          f"{stats['megastep']['graphs']}; launches {launches}",
          flush=True)
    return out


def swap_phase(rules, lists, plan, reqs, dev, oracle) -> dict:
    """Hot-swap on the card. Epoch 0 is the corpus's plan, epoch 1
    generate_ruleset(500, seed=SWAP_SEED) through the artifact cache
    (`swap_cache`); the interpreter's oracle of epoch 1, and of the ring
    stream under both epochs, run in processes of their own meanwhile.
    Then the Python plane's arms (SWAP_ARMS) and the ring's
    (SWAP_RING_ARMS) on one ring and producer child."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from pingoo_tpu_torch import native_ring as nr
    from pingoo_tpu_torch.engine.verdict import action_lanes
    from pingoo_tpu_torch.utils.crs import generate_ruleset

    t_phase = time.monotonic()
    rules1, lists1 = generate_ruleset(500, seed=SWAP_SEED)
    ring_reqs = swap_ring_requests()
    spawn = multiprocessing.get_context("spawn")
    pools = [ProcessPoolExecutor(w, mp_context=spawn,
                                 initializer=slice_oracle_init,
                                 initargs=(r, ls))
             for w, r, ls in ((1, rules, lists),
                              (SLICE_ORACLE_WORKERS - 1, rules1, lists1))]
    chunk = -(-len(reqs) // (SLICE_ORACLE_WORKERS - 1))
    ring0 = pools[0].submit(slice_oracle, ring_reqs)
    ring1 = pools[1].submit(slice_oracle, ring_reqs)
    parts1 = [pools[1].submit(slice_oracle, reqs[i:i + chunk])
              for i in range(0, len(reqs), chunk)]
    with tempfile.TemporaryDirectory() as tmp:
        plan1, cache = swap_cache(rules1, lists1, plan, dev, tmp)
    t0 = time.monotonic()
    oracle1 = np.concatenate([f.result() for f in parts1])
    ring_rows = (ring0.result(), ring1.result())
    for p in pools:
        p.shutdown()
    oracle_wait_s = time.monotonic() - t0
    plans, all_lists = (plan, plan1), (lists, lists1)
    oracles = (oracle, oracle1)
    lanes = [action_lanes(p, o) for p, o in zip(plans, oracles)]
    wants = [bytes(int(a) | (int(b) << 2)
                   for a, b in zip(*action_lanes(p, rows)))
             for p, rows in zip(plans, ring_rows)]
    differ = sum(a != b for a, b in zip(*wants))
    if differ < len(ring_reqs) // 8:
        fail(f"the ring stream's verdicts tell the epochs apart on "
             f"{differ} of {len(ring_reqs)} requests only")
    service = {name: swap_service_arm(name, plans, all_lists, reqs, dev,
                                      oracles, lanes)
               for name in SWAP_ARMS}
    ring_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring")
        ring = nr.Ring(path, capacity=RING_CAPACITY, create=True)
        try:
            producer = ChildProducer(path)
            try:
                for arm in SWAP_RING_ARMS:
                    ring_out[arm] = swap_ring_arm(arm, ring, producer,
                                                  plans, all_lists, wants,
                                                  dev)
                producer.close()
                time.sleep(0.2)
                if ring.poll_verdict() is not None:
                    fail("a verdict arrived after every ticket had its own")
            finally:
                if producer.proc.poll() is None:
                    producer.proc.kill()
                    producer.proc.wait()
        finally:
            ring.close()
    out = dict(cache=cache, service=service, ring=ring_out,
               launches=service["on"]["launches"],
               ring_launches=ring_out["force"]["launches"],
               oracle_wait_s=oracle_wait_s,
               seconds=time.monotonic() - t_phase)
    print("swap pauses (ms): "
          + ", ".join(f"Python {k} {v['pause_ms']:.3f}"
                      for k, v in service.items())
          + ", " + ", ".join(f"ring {k} {v['pause_ms']:.3f}"
                             for k, v in ring_out.items())
          + "; serving waits for the capture lock behind a swap's capture "
          + ", ".join(f"{plane} {v['overlap']['serving_wait_ms']:.3f}"
                      for plane, v in (("Python", service["force"]),
                                       ("ring", ring_out["force"])))
          + f"; waited {oracle_wait_s:.1f} s for the oracles; phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


RESELECT_QUEUED_CALLS = 32


def reselect_phase(rules, lists, plan, reqs, dev, oracle, main_out) -> dict:
    """The measured re-selection of the plan's scan strategies, the
    counterpart of bench.py's autotune_scan_strategies. On the widest
    lowered bank (the one with the most NFA words that has a DFA) at B
    rows of its field's full width, the NFA kernel (single and pair
    stepping) and the DFA kernel walk the same rows and columns, each
    timed queued; a run's time over its loop iterations (the columns, or
    half of them for pair stepping) is its per-iteration cost. The costs
    are scaled so that the NFA kernel's single stepping keeps its
    modelled cost ("pallas"): the kinds with no route here ("scan",
    "pair") keep their defaults, and the DFA is ranked against the NFA
    kernel by measurement. `reselect_scan_strategies` re-ranks a copy of
    the plan, `update_cached_plan` stores it in a temporary artifact
    cache and `compile_ruleset_cached` loads it back, whose scan plans
    must be the tuned ones; the main path served from it under
    PINGOO_DFA=auto must give the oracle's verdicts, every one."""
    import copy
    import tempfile

    import numpy as np

    from pingoo_tpu_torch.compiler.cache import (compile_ruleset_cached,
                                                 update_cached_plan)
    from pingoo_tpu_torch.compiler.plan import (DEFAULT_STEP_COSTS,
                                                reselect_scan_strategies)
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.ops import _build
    from pingoo_tpu_torch.ops import bitsplit_dfa as dfa_ops
    from pingoo_tpu_torch.ops import nfa_scan

    t0 = time.monotonic()
    tables = plan.np_tables
    key = max((k for k, e in plan.scan_plans.items() if e.dfa_key),
              key=lambda k: tables[k].opt.shape[0])
    nfa, dfa = tables[key], tables[plan.scan_plans[key].dfa_key]
    field = key.split("_", 1)[1]
    data, lens = field_batch(np.random.default_rng(SEED + 7),
                             plan.field_specs[field], dev)
    L = data.shape[1]
    state = nfa_scan.init_scan_state(B, nfa.opt.shape[0], dev)
    dstate, H = dfa_ops.dfa_init_state(B, dfa.num_words, dev)
    runs = {
        "pallas": (lambda: nfa_scan.fused_scan_chunk(
            nfa, data, lens, state, 0, False), L),
        "pallas_pair": (lambda: nfa_scan.fused_scan_chunk(
            nfa, data, lens, state, 0, True), (L + 1) // 2),
        "dfa": (lambda: dfa_ops.fused_dfa_chunk(
            dfa, data, lens, dstate, H, 0), L)}
    run_ms = {k: queued_ms(fn, RESELECT_QUEUED_CALLS)
              for k, (fn, _) in runs.items()}
    iter_ns = {k: run_ms[k] * 1e6 / runs[k][1] for k in runs}
    scale = DEFAULT_STEP_COSTS["pallas"] / iter_ns["pallas"]
    costs = dict(DEFAULT_STEP_COSTS,
                 pallas_pair=iter_ns["pallas_pair"] * scale,
                 dfa=iter_ns["dfa"] * scale)
    before = {k: (e.strategy.kind, e.strategy.pair, e.dfa_auto)
              for k, e in plan.scan_plans.items()}
    tuned = copy.copy(plan)
    tuned.scan_plans = dict(plan.scan_plans)
    reselect_scan_strategies(tuned, costs)
    t1 = time.monotonic()
    with tempfile.TemporaryDirectory() as cache_dir:
        update_cached_plan(rules, lists, tuned, cache_dir)
        loaded = compile_ruleset_cached(rules, lists, cache_dir=cache_dir,
                                        device=dev)
    cache_s = time.monotonic() - t1
    if loaded.scan_plans != tuned.scan_plans:
        fail(f"the artifact cache gave back scan plans {loaded.scan_plans},"
             f" not the tuned {tuned.scan_plans}")
    after = {k: (e.strategy.kind, e.strategy.pair, e.dfa_auto)
             for k, e in loaded.scan_plans.items()}
    os.environ["PINGOO_DFA"] = "auto"
    try:
        _build.reset_launch_counts()
        verdicts, wall = asyncio.run(serve(
            VerdictService(loaded, lists, max_batch=B, device=dev), reqs))
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
    finally:
        os.environ.pop("PINGOO_DFA")
    matched = np.stack([v.matched for v in verdicts])
    act = np.array([v.action for v in verdicts])
    vb = np.array([v.verified_block for v in verdicts])
    differ = int(((matched != oracle).any(axis=1) | (act != main_out[1])
                  | (vb != main_out[2])).sum())
    if differ:
        fail(f"the tuned plan's main path: {differ} verdicts differ from "
             f"the oracle's")
    out = dict(bank=key, words=int(nfa.opt.shape[0]),
               dfa_states=int(dfa.num_states), rows=B, columns=L,
               run_ms=run_ms, iter_ns=iter_ns, costs=costs, before=before,
               after=after, cache_s=cache_s, differ=differ,
               req_per_s=len(reqs) / wall, launches=launches,
               seconds=time.monotonic() - t0)
    dfa_key = plan.scan_plans[key].dfa_key
    print(f"re-selection: {key} ({out['words']} words; {dfa_key} "
          f"{out['dfa_states']} states) at {B} x {L}, queued ms "
          f"{({k: round(v, 4) for k, v in run_ms.items()})}, ns an "
          f"iteration {({k: round(v, 4) for k, v in iter_ns.items()})}, "
          f"costs {({k: round(v, 4) for k, v in costs.items()})}; (kind, "
          f"pair, dfa_auto) before {before}, after {after}; the artifact "
          f"cache's round trip {cache_s:.1f} s kept them; the tuned plan's "
          f"main path under PINGOO_DFA=auto: {differ} verdicts differ, "
          f"{out['req_per_s']:.0f} req/s, launches {launches} "
          f"({out['seconds']:.1f} s) [{card()}]", flush=True)
    return out


def bot_alone() -> int:
    """`--bot-phase`: `setup()`, then `bot_phase`. Prints {"bot": ...},
    but no result line."""
    rules, lists, reqs, oracle, dev, plan = setup()
    print(json.dumps({"bot": bot_phase(plan, lists, reqs, dev, oracle)}),
          flush=True)
    return 0


def swap_alone() -> int:
    """`--swap-phase`: `setup()`, then `swap_phase`. Prints {"swap": ...},
    but no result line."""
    rules, lists, reqs, oracle, dev, plan = setup()
    print(json.dumps({"swap": swap_phase(rules, lists, plan, reqs, dev,
                                         oracle)}), flush=True)
    return 0


def build_with_oracle(rules, lists, reqs):
    """Build the three kernels (printing ptxas's registers and spills per
    instantiation) while the interpreter oracle of `reqs` runs in
    SLICE_ORACLE_WORKERS processes of its own; returns the oracle's
    match rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from pingoo_tpu_torch.ops import _build

    oracle_pool = ProcessPoolExecutor(
        SLICE_ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=slice_oracle_init, initargs=(rules, lists))
    chunk = -(-N_REQUESTS // SLICE_ORACLE_WORKERS)
    oracle_parts = [oracle_pool.submit(slice_oracle, reqs[i:i + chunk])
                    for i in range(0, N_REQUESTS, chunk)]
    t0 = time.monotonic()
    took = _build.build(verbose=True)
    print(f"build: {time.monotonic() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})",
          flush=True)
    t0 = time.monotonic()
    oracle = np.concatenate([f.result() for f in oracle_parts])
    oracle_pool.shutdown()
    print(f"oracle: {N_REQUESTS} requests interpreted in "
          f"{SLICE_ORACLE_WORKERS} processes during the build, then "
          f"{time.monotonic() - t0:.1f} s more", flush=True)
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
    return oracle


def setup():
    """The card line, the 500-rule corpus, the main-path stream, the
    built kernels and the oracle, and the corpus's plan on the card."""
    import torch

    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

    print(card_line(), flush=True)
    rules, lists = generate_ruleset(500)
    reqs = generate_traffic(N_REQUESTS, attack_fraction=0.3, seed=SEED,
                            lists=lists)
    oracle = build_with_oracle(rules, lists, reqs)
    dev = torch.device("cuda")
    plan = compile_ruleset(rules, lists, device=dev)
    print(f"plan: {plan.stats}", flush=True)
    return rules, lists, reqs, oracle, dev, plan


def halo_alone() -> int:
    """The halo phase alone (`--halo-phase`): `setup()`, the main path's
    verdicts (one pass of a VerdictService under the defaults, held to
    the oracle), then `halo_phase`. Prints {"halo": ...}, but no result
    line."""
    import numpy as np

    from pingoo_tpu_torch.engine.service import VerdictService

    rules, lists, reqs, oracle, dev, plan = setup()
    verdicts, _ = asyncio.run(serve(VerdictService(plan, lists, max_batch=B,
                                                   device=dev), reqs))
    main = (np.stack([v.matched for v in verdicts]),
            np.array([v.action for v in verdicts]),
            np.array([v.verified_block for v in verdicts]))
    if (main[0] != oracle).any():
        fail("the main path's verdicts differ from the oracle")
    halo = halo_phase(plan, rules, lists, reqs, dev, oracle, main,
                      np.random.default_rng(SEED))
    print(json.dumps({"halo": halo}), flush=True)
    return 0


def main() -> int:
    # The listener phase's helper processes, which need no card.
    if sys.argv[1:] == ["--listener-pong"]:
        return listener_pong()
    if sys.argv[1:] == ["--listener-client"]:
        return listener_client()
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
    guard_ladder()
    if sys.argv[1:]:
        ledger_env()
    if sys.argv[1:] == ["--ring-phase"]:
        return ring_phase()
    if sys.argv[1:] == ["--body-phase"]:
        return body_phase()
    if sys.argv[1:] == ["--listener-phase"]:
        return listener_phase()
    if sys.argv[1:] == ["--native-phase"]:
        return native_phase()
    if sys.argv[1:] == ["--halo-phase"]:
        return halo_alone()
    if sys.argv[1:] == ["--bot-phase"]:
        return bot_alone()
    if sys.argv[1:] == ["--swap-phase"]:
        return swap_alone()
    if sys.argv[1:] == ["--sched-phase"]:
        return sched_phase()
    if len(sys.argv) == 3 and sys.argv[1] == "--ring-producer":
        return ring_producer(sys.argv[2])
    import numpy as np

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        phase_s[name] = round(time.monotonic() - t0, 1)
        return out

    rules, lists, reqs, oracle, dev, plan = timed("setup", setup)
    # The compile ledger is off until here: the service's programs are
    # the unwrapped callables. From here on every process keeps its
    # ledgers under one temporary directory.
    ledger_off_check(plan, lists, dev)
    ledger_dir = ledger_env()
    rng = np.random.default_rng(SEED)
    results = timed("kernels", kernel_phase, plan, dev, rng)
    results["prefilter"]["stage_a"] = timed("stage_a", stage_a_child)
    ring = timed("ring", ring_child)
    sched = timed("sched", sched_child)
    body = timed("body", body_child)
    listener = timed("listener", listener_child)
    native = timed("native", native_child)
    counts, main_path, megas, compacts = timed(
        "slice", slice_phase, plan, rules, lists, reqs, dev, oracle)
    config_counts = timed("config", config_phase, rules, lists, reqs, oracle,
                          main_path, dev)
    t_capture = time.monotonic()
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
    # The megastep arm's calls: the slices' gathered rows (candidates at
    # the front, the rest at length 0), held and timed the same way.
    calls, launched = capture_main_path(plan, lists, reqs, dev,
                                        megastep=True)
    for name in ("nfa_scan", "bitsplit_dfa", "prefilter"):
        m = main_path_phase(plan, name, calls[name], launched[name],
                            label="megastep path")
        if m.pop("max_abs_err") != 0:
            fail(f"the {name} kernel disagrees with its plain version on a "
                 f"captured megastep launch")
        results[name].update({k.replace("main_path", "megastep_path"): v
                              for k, v in m.items()})
    phase_s["main_path_capture"] = round(time.monotonic() - t_capture, 1)
    halo = timed("halo", halo_phase, plan, rules, lists, reqs, dev, oracle,
                 main_path, rng)
    results["nfa_scan"]["halo"] = halo["kernel"]
    print(json.dumps({"halo": halo}), flush=True)
    bot = timed("bot", bot_phase, plan, lists, reqs, dev, oracle)
    print(json.dumps({"bot": bot}), flush=True)
    swap = timed("swap", swap_phase, rules, lists, plan, reqs, dev, oracle)
    print(json.dumps({"swap": swap}), flush=True)
    reselect = timed("reselect", reselect_phase, rules, lists, plan, reqs,
                     dev, oracle, main_path)
    print(json.dumps({"reselect": reselect}), flush=True)
    compile_ledger = ledger_check("main process")
    print("main process, seconds a phase (children from spawn to exit): "
          + json.dumps(phase_s), flush=True)
    ring_halo = ring["halo"][f"{HALO_KNOBS[0][0]} on/off"]["drives"][0]
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
            "listener_launches": listener["passes"]["h1"]["launches"][name],
            "native_launches": native["loadgen"]["throughput"]["launches"][
                name],
            "megastep_launches": megas[1]["launches"][name],
            "megastep_k4_launches": megas[4]["launches"][name],
            "ring_megastep_launches": ring["arms"]["force"]["drives"][0][
                "launches"][name],
            "ring_megastep_256_launches": ring["arms"]["force_256"][
                "drives"][0]["launches"][name],
            "compact_staging_launches": compacts["staging"]["launches"][name],
            "compact_prefilter_launches": compacts["prefilter"]["launches"][
                name],
            **{f"ring_staging_{arm}_launches": ring["staging"][arm][
                "drive"]["launches"][name]
               for arm in ("full", "compact", "compact_force")},
            "halo_launches": halo["launches"][name],
            "ring_halo_launches": ring_halo["launches"][name],
            "bot_launches": bot["launches"][name],
            "swap_launches": swap["launches"][name],
            "ring_swap_launches": swap["ring_launches"][name],
            "sched_launches": sched["python"]["continuous"][
                "kernel_launches"][name],
            "sched_auto_launches": sched["python"]["auto"][
                "kernel_launches"][name],
            **{k: v for k, v in r.items() if k not in (
                "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "work")}})
    check_ladder("the main process's phases")
    print(json.dumps({"ledgers": dict(
        compile=compile_ledger, ring_cost=ring["cost_ledger"],
        python_cost=sched["cost_ledger"],
        entry_point_cost=listener["entry_point"]["cost_ledger"])}),
        flush=True)
    shutil.rmtree(ledger_dir, ignore_errors=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
