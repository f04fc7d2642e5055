"""The body phase's pinned checksums in chip_smoke.py, recomputed with
the JAX package on the CPU over the phase's own streams.

  * BODY_CHECKSUMS: the crc32 of the action bytes, in flow order, of the
    JAX package's `BodyScanner` over `body_rounds(body_payloads(name))`
    (1,024 flows, windows of 4,096), for the seed set and the CRS set.
  * BODY_RING_CHECKSUM: the crc32 of the merged verdict bytes of the JAX
    package's `RingSidecar` with PINGOO_BODY_INSPECT=on, driven by the
    port's `drive_stream` with the body ring drive of the phase
    (`generate_traffic(4096, seed=13)` of the ring phase's set-up, a
    body on every fourth request).

The card's run holds the port to these values; this file holds the
values to the reference.
"""

import threading
import zlib

import pytest
import torch

import chip_smoke as cs
from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.engine import bodyscan as ref_bs
from pingoo_tpu.utils.crs import generate_ruleset as ref_generate_ruleset
from pingoo_tpu_torch import native_ring as nr
from pingoo_tpu_torch.utils.crs import generate_ruleset, generate_traffic

torch.set_num_threads(1)

REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_SCHED_MODE": "fixed",
           "PINGOO_MEGASTEP": "off", "PINGOO_BODY_INSPECT": "on"}
CLEARED_ENV = ("PINGOO_BODY_SCAN", "PINGOO_BODY_LAZY", "PINGOO_BODY_WINDOW",
               "PINGOO_BODY_MAX_FLOWS", "PINGOO_BODY_FLOW_TTL_MS",
               "PINGOO_BODY_RULES", "PINGOO_DFA", "PINGOO_PREFILTER",
               "PINGOO_STAGING", "PINGOO_CHAOS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("name", sorted(cs.BODY_CHECKSUMS))
def test_body_checksum_is_the_jax_scanners(name):
    plan = ref_bs.compile_body_plan(cs.body_rules(ref_bs, name),
                                    window=cs.BODY_WINDOW)
    payloads = cs.body_payloads(name)
    assert len(payloads) == cs.BODY_FLOWS
    scanner = ref_bs.BodyScanner(plan)
    verdicts = {}
    for rnd in cs.body_rounds(ref_bs, payloads):
        for v in scanner.scan_windows(rnd):
            verdicts[v.flow_id] = v
    assert sorted(verdicts) == list(range(len(payloads)))
    assert not any(v.degraded for v in verdicts.values())
    acts = bytes(verdicts[f].action_byte() for f in range(len(payloads)))
    assert zlib.crc32(acts) == cs.BODY_CHECKSUMS[name]


def test_body_ring_checksum_is_the_jax_sidecars(tmp_path, monkeypatch):
    for name, value in REF_ENV.items():
        monkeypatch.setenv(name, value)
    ref_rules, ref_lists = ref_generate_ruleset(500, with_lists=True,
                                                list_sizes=(4096, 512))
    _, lists = generate_ruleset(500, with_lists=True, list_sizes=(4096, 512))
    stream = nr.pack_requests(generate_traffic(
        cs.BODY_RING_REQUESTS, lists=lists, seed=cs.BODY_RING_SEED))
    bodies = cs.body_ring_bodies(cs.BODY_RING_REQUESTS)
    ring = ref_nr.Ring(str(tmp_path / "ring"), capacity=cs.RING_CAPACITY,
                       create=True)
    try:
        sidecar = ref_nr.RingSidecar(ring, ref_compile(ref_rules, ref_lists),
                                     ref_lists, max_batch=cs.B)
        thread = threading.Thread(target=sidecar.run, daemon=True)
        thread.start()
        try:
            # The drive shares the sidecar's process: it sleeps when idle
            # to leave the sidecar the interpreter lock.
            r = nr.drive_stream(ring, stream, bodies, timeout_s=600,
                                idle_s=nr.DRIVE_IDLE_S)
        finally:
            sidecar.stop()
            thread.join(timeout=30)
        assert not thread.is_alive()
    finally:
        ring.close()
    assert sorted(r.body_actions) == [k for k, b in enumerate(bodies)
                                      if b is not None]
    assert r.checksum == cs.BODY_RING_CHECKSUM
