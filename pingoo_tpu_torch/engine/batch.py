"""Request batch encoding: request tuples -> fixed-shape arrays.

The host extracts one `RequestTuple` per request and batches them into
zero-padded byte matrices plus numeric columns (numpy, on the host);
`batch_tensors` places them on the plan's device. Every string field is
capped at its plan capacity (compiler/lowering.DEFAULT_FIELD_SPECS); a
request whose field exceeds it is flagged in `overflow` and re-evaluated
by the interpreter over the untruncated strings (engine/service.py).
`batch_to_contexts` rebuilds the strings the device saw (the parity
oracle's view).

Two staging modes (PINGOO_STAGING, as in the JAX package):

  * `full` (the default): every field is staged at its full width, then
    `bucket_arrays` trims the columns to a power of two;
  * `compact`: each field is staged at the plan's cap
    (`RulesetPlan.staging_caps`, clamped by PINGOO_STAGING_DEPTH), all of
    a row in one packed byte row (`PackedLayout`) whose metadata tail
    holds the true lengths, the IP bytes and the numbers, so a batch
    uploads as one copy and the device decodes it
    (engine/verdict.py `unpack_staged`). A row longer than a cap set
    below the plan's required depth is flagged in `overflow` and
    re-interpreted from its untruncated source.

Two encode paths give the same arrays: the one-batch chain
(`encode_requests` -> `bucket_arrays` -> `pad_batch`, or the ring's
`slots_to_arrays` -> bucket -> pad), which allocates per batch, and the
pipelined executor's `StagingEncoder`, which fills reused buffers in
place and hands out views already bucketed and padded. The megastep's
`DeviceInputQueue` stacks K such batches for one device program.
"""

from __future__ import annotations

import ipaddress
import math
import os
import threading
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..compiler.lowering import DEFAULT_FIELD_SPECS
from ..compiler.plan import quantize_stage_cap
from ..expr import Context, Ip
from ..ops.cidr import ip_to_words

STRING_FIELDS = ("host", "url", "path", "method", "user_agent", "country")


@dataclass
class RequestTuple:
    """One request's rule-relevant metadata."""

    host: str = ""
    url: str = ""
    path: str = ""
    method: str = "GET"
    user_agent: str = ""
    ip: str = "0.0.0.0"
    remote_port: int = 0
    asn: int = 0
    country: str = "XX"
    # Correlation id (obs/trace.py), assigned at the edge so engine-side
    # logs can join a request to its response header and access-log
    # line. Never encoded, never packed onto the ring, never read by a
    # rule.
    trace_id: str = ""


@dataclass
class RequestBatch:
    """Fixed-shape encoded batch (numpy arrays in `.arrays`); `overflow`
    flags rows whose fields exceeded device capacity. Under compact
    staging `packed` is the [size, layout.width] uint8 buffer that the
    device decodes, and the byte matrices of `arrays` are views of it
    (host rules and overflow rows read the same bytes). `staged_bytes`
    is what the encoder staged for the device: the packed rows, or the
    arrays' bytes under full staging (the JAX package's measure)."""

    size: int
    arrays: dict
    overflow: Optional[np.ndarray] = None
    packed: Optional[np.ndarray] = None
    layout: Optional["PackedLayout"] = None
    staged_bytes: int = 0

    def __getitem__(self, key: str):
        return self.arrays[key]


def _to_bytes(text: str) -> bytes:
    """Canonical byte view (latin-1, bijective); non-byte chars are
    replaced so a hostile header can't crash encoding."""
    try:
        return text.encode("latin-1")
    except UnicodeEncodeError:
        return text.encode("latin-1", errors="replace")


def _clamp_i64(v: int) -> int:
    return max(min(int(v), 2**63 - 1), -(2**63))


def encode_requests(
    requests: list[RequestTuple],
    field_specs: Optional[Mapping[str, int]] = None,
) -> RequestBatch:
    specs = dict(field_specs or DEFAULT_FIELD_SPECS)
    B = len(requests)
    arrays: dict = {}
    overflow = np.zeros(B, dtype=bool)
    for field in STRING_FIELDS:
        L = specs.get(field, 256)
        data = np.zeros((B, L), dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        for i, req in enumerate(requests):
            full = _to_bytes(getattr(req, field))
            if len(full) > L:
                overflow[i] = True
            raw = full[:L]
            data[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            lens[i] = len(raw)
        arrays[f"{field}_bytes"] = data
        arrays[f"{field}_len"] = lens

    ip_words = np.zeros((B, 4), dtype=np.uint32)
    for i, req in enumerate(requests):
        try:
            ip_words[i], _ = ip_to_words(Ip(req.ip))
        except Exception:
            ip_words[i] = 0  # unparseable -> never matches any predicate
    arrays["ip"] = ip_words
    arrays["asn"] = np.array(
        [_clamp_i64(r.asn) for r in requests], dtype=np.int64)
    arrays["remote_port"] = np.array(
        [_clamp_i64(r.remote_port) for r in requests], dtype=np.int64)
    return RequestBatch(size=B, arrays=arrays, overflow=overflow)


def bucket_len(longest: int, cap: int, min_len: int = 16) -> int:
    """The pow2 column count (floor `min_len`, capped at `cap`) for a
    field whose longest value is `longest`."""
    L = min_len
    while L < longest:
        L *= 2
    return min(L, cap)


def bucket_arrays(arrays: dict, min_len: int = 16) -> dict:
    """Slice each field's byte matrix to the next power of two >= the
    batch's longest value: the scans are O(L), so not walking padding is
    the biggest lever for real traffic."""
    out = dict(arrays)
    for field in STRING_FIELDS:
        data = arrays[f"{field}_bytes"]
        lens = arrays[f"{field}_len"]
        longest = int(np.max(lens)) if len(lens) else 0
        L = bucket_len(longest, data.shape[1], min_len)
        out[f"{field}_bytes"] = np.ascontiguousarray(data[:, :L])
    return out


# The request slot's length field of each string field
# (native_ring.REQUEST_SLOT_DTYPE); `country` is a fixed 2-byte code with
# no length field.
SLOT_LEN_KEYS = {
    "method": "method_len",
    "host": "host_len",
    "path": "path_len",
    "url": "url_len",
    "user_agent": "ua_len",
}


def pow2_batch_size(n: int, max_batch: int) -> int:
    """Padded launch size for an n-row batch: the next power of two
    (floor 8), capped at `max_batch` but never below n."""
    target = 1
    while target < n:
        target *= 2
    return max(min(max(target, 8), max_batch), n)


def pad_batch(batch: RequestBatch, to_size: int) -> RequestBatch:
    """Pad a batch to a fixed size; padded rows are inert (zero-length
    fields, ip 0, no overflow)."""
    B = batch.size
    if B == to_size:
        return batch
    assert to_size > B
    arrays = {}
    for key, a in batch.arrays.items():
        pad_shape = (to_size - B,) + a.shape[1:]
        arrays[key] = np.concatenate([a, np.zeros(pad_shape, dtype=a.dtype)])
    overflow = batch.overflow
    if overflow is not None:
        overflow = np.concatenate(
            [overflow, np.zeros(to_size - B, dtype=bool)])
    return RequestBatch(size=to_size, arrays=arrays, overflow=overflow)


# -- compact staging -----------------------------------------------------------


def resolve_staging_mode() -> str:
    """PINGOO_STAGING: `full` (the default) or `compact`."""
    mode = os.environ.get("PINGOO_STAGING", "full").strip().lower()
    return "compact" if mode == "compact" else "full"


def resolve_stage_caps(plan) -> Optional[dict[str, int]]:
    """The per-field staged widths a plan serves under, or None under
    full staging: the plan's caps, clamped by PINGOO_STAGING_DEPTH (0,
    unset or not an integer: no clamp) on the rung ladder."""
    if resolve_staging_mode() != "compact":
        return None
    specs = dict(getattr(plan, "field_specs", None) or DEFAULT_FIELD_SPECS)
    caps = dict(getattr(plan, "staging_caps", None) or {})
    try:
        depth = int(os.environ.get("PINGOO_STAGING_DEPTH", "0"))
    except ValueError:
        depth = 0
    eff: dict[str, int] = {}
    for field in STRING_FIELDS:
        spec = int(specs.get(field, 256))
        cap = min(int(caps.get(field, spec)), spec)
        if depth > 0:
            cap = min(cap, quantize_stage_cap(min(depth, spec), spec))
        eff[field] = max(1, cap)
    return eff


def stage_overflow_thresholds(plan,
                              eff: Mapping[str, int]) -> dict[str, int]:
    """Per field, the true length past which a row is re-interpreted
    from its untruncated source: the spec where the cap covers the
    plan's required depth (full staging's rule), else the cap itself
    (a clamped cap drops bytes a scanner reads)."""
    specs = dict(getattr(plan, "field_specs", None) or DEFAULT_FIELD_SPECS)
    required = getattr(plan, "staging_required", None) or {}
    out: dict[str, int] = {}
    for field in STRING_FIELDS:
        spec = int(specs.get(field, 256))
        need = min(int(required.get(field, spec)), spec)
        cap = int(eff.get(field, spec))
        out[field] = cap if cap < need else spec
    return out


class PackedLayout(NamedTuple):
    """The byte layout of one packed staging row: each string field's
    capped bytes, then a metadata tail of the u16 little-endian true
    lengths, the 16 big-endian IP bytes and the int64 little-endian asn
    and remote_port."""

    fields: tuple  # ((field, offset, width), ...)
    lens: tuple  # ((field, offset), ...)
    ip_off: int
    asn_off: int
    port_off: int
    width: int  # the row's stride in bytes


_LAYOUT_CACHE: dict[tuple, PackedLayout] = {}


def build_packed_layout(stage_caps: Mapping[str, int]) -> PackedLayout:
    """The PackedLayout of a caps assignment, one instance per tuple of
    widths (plans whose caps land on the same rungs share it)."""
    widths = tuple(int(stage_caps[f]) for f in STRING_FIELDS)
    cached = _LAYOUT_CACHE.get(widths)
    if cached is not None:
        return cached
    fields, off = [], 0
    for field, w in zip(STRING_FIELDS, widths):
        fields.append((field, off, w))
        off += w
    lens = []
    for field in STRING_FIELDS:
        lens.append((field, off))
        off += 2
    layout = PackedLayout(fields=tuple(fields), lens=tuple(lens),
                          ip_off=off, asn_off=off + 16, port_off=off + 24,
                          width=off + 32)
    _LAYOUT_CACHE[widths] = layout
    return layout


class StagingEncoder:
    """Reused staging buffers for the pipelined executor.

    The one-batch chain allocates three full-batch copies before the
    device sees a byte: `encode_requests` builds fresh (B, cap)
    matrices, `bucket_arrays` copies the power-of-two column slice and
    `pad_batch` concatenates zero rows. This encoder owns
    (max_batch, cap) matrices per field and fills them in place,
    returning views already bucketed and padded, equal to that chain's
    arrays (tests/test_torch_pipeline.py holds the two equal).

    The encoder owns `nbuf` buffer sets. A batch `checkout`s one, fills
    it, and holds it until it `release`s it after its last verdict,
    since host rules, overflow rows and spill rows read its views at
    completion. The free list, not an order of checkouts, keeps a set
    from being refilled while its batch reads it, so batches may finish
    in any order. The planes take one set per batch in flight, so the
    sets also bound the batches in flight. (`batch_tensors` copies
    each array into pinned memory of its own before the upload, so a
    set is free for the host once its batch completes.)

    Two fill paths: `encode_requests` from RequestTuples (the Python
    plane) and `encode_slots` from request-slot rows (the sidecar),
    the latter with one strided copy per field and no per-slot Python.

    With `stage_caps` (compact staging) each set also owns a packed
    buffer sized at the installed layout's width (a `set_stage_caps`
    that widens it reallocates); a batch fills and ships its [P, width]
    prefix. The thresholds (`stage_overflow_thresholds`) decide which
    rows are flagged.
    """

    def __init__(self, max_batch: int,
                 field_specs: Optional[Mapping[str, int]] = None,
                 nbuf: int = 2,
                 stage_caps: Optional[Mapping[str, int]] = None,
                 overflow_thresholds: Optional[Mapping[str, int]] = None):
        specs = dict(field_specs or DEFAULT_FIELD_SPECS)
        self.max_batch = int(max_batch)
        self.specs = specs
        self.nbuf = max(1, int(nbuf))
        self._free = list(range(self.nbuf))
        self._cv = threading.Condition()
        self._bufs: list[dict] = []
        for _ in range(self.nbuf):
            bufs: dict = {}
            for field in STRING_FIELDS:
                cap = specs.get(field, 256)
                bufs[f"{field}_bytes"] = np.zeros(
                    (self.max_batch, cap), dtype=np.uint8)
                bufs[f"{field}_len"] = np.zeros(self.max_batch,
                                                dtype=np.int32)
            bufs["ip"] = np.zeros((self.max_batch, 4), dtype=np.uint32)
            bufs["asn"] = np.zeros(self.max_batch, dtype=np.int64)
            bufs["remote_port"] = np.zeros(self.max_batch, dtype=np.int64)
            bufs["overflow"] = np.zeros(self.max_batch, dtype=bool)
            self._bufs.append(bufs)
        self.stage_caps: Optional[dict[str, int]] = None
        self._thresholds: dict[str, int] = dict(specs)
        self._layout: Optional[PackedLayout] = None
        self._packed = stage_caps is not None
        if self._packed:
            self.set_stage_caps(stage_caps, overflow_thresholds)

    def set_stage_caps(
            self, stage_caps: Mapping[str, int],
            overflow_thresholds: Optional[Mapping[str, int]] = None
    ) -> None:
        """Install a plan's staged widths (each clamped to its spec) and
        overflow thresholds. Only between batches: it raises while a set
        is checked out, so that no batch is encoded under one layout and
        read under another; a layout wider than the packed buffers
        reallocates them. An encoder built without `stage_caps` stages
        in full and raises."""
        if not self._packed:
            raise ValueError(
                "this encoder was built without packed staging (stage_caps)")
        with self._cv:
            if len(self._free) != self.nbuf:
                raise RuntimeError(
                    "set_stage_caps while a staging set is checked out: "
                    "caps change only between batches")
            caps = {f: min(int(stage_caps.get(f, self.specs.get(f, 256))),
                           self.specs.get(f, 256)) for f in STRING_FIELDS}
            thresholds = dict(self.specs)
            if overflow_thresholds is not None:
                for f in STRING_FIELDS:
                    thresholds[f] = min(
                        int(overflow_thresholds.get(
                            f, self.specs.get(f, 256))),
                        self.specs.get(f, 256))
            layout = build_packed_layout(caps)
            size = self.max_batch * layout.width
            for bufs in self._bufs:
                if "packed" not in bufs or bufs["packed"].size < size:
                    bufs["packed"] = np.zeros(size, dtype=np.uint8)
            self.stage_caps = caps
            self._layout = layout
            self._thresholds = thresholds

    def checkout(self, block: bool = True) -> int:
        """A free buffer set for one batch, held until `release`.
        Blocks while every set is out; with `block=False` that raises
        instead (a caller that never holds more than `nbuf` sets)."""
        with self._cv:
            if not self._free and not block:
                raise RuntimeError(
                    f"every staging set is checked out (nbuf={self.nbuf})")
            while not self._free:
                self._cv.wait()
            return self._free.pop()

    def release(self, idx: int) -> None:
        with self._cv:
            self._free.append(idx)
            self._cv.notify()

    def _check_shape(self, n: int, pad_to: Optional[int]) -> int:
        P = n if pad_to is None else int(pad_to)
        if not n or P < n or P > self.max_batch:
            raise ValueError(f"bad staging shape: n={n} pad_to={pad_to} "
                             f"max_batch={self.max_batch}")
        return P

    def encode_requests(self, requests: list[RequestTuple],
                        pad_to: Optional[int] = None, *,
                        into: int) -> RequestBatch:
        """RequestTuples -> bucketed and padded views of the checked-out
        set `into`, equal to
        `pad_batch(bucket_arrays(encode_requests(requests)), pad_to)`
        (overflow included)."""
        B = len(requests)
        P = self._check_shape(B, pad_to)
        buf = self._bufs[into]
        if self._layout is not None:
            return self._encode_requests_packed(requests, B, P, buf)
        arrays: dict = {}
        overflow = buf["overflow"][:P]
        overflow[:] = False
        for field in STRING_FIELDS:
            cap = self.specs.get(field, 256)
            raws = []
            longest = 0
            for i, req in enumerate(requests):
                full = _to_bytes(getattr(req, field))
                if len(full) > cap:
                    overflow[i] = True
                raw = full[:cap]
                raws.append(raw)
                longest = max(longest, len(raw))
            L = bucket_len(longest, cap)
            data = buf[f"{field}_bytes"][:P, :L]
            lens = buf[f"{field}_len"][:P]
            data[:] = 0
            lens[B:] = 0
            for i, raw in enumerate(raws):
                data[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
                lens[i] = len(raw)
            arrays[f"{field}_bytes"] = data
            arrays[f"{field}_len"] = lens
        ip = buf["ip"][:P]
        ip[B:] = 0
        for i, req in enumerate(requests):
            try:
                ip[i], _ = ip_to_words(Ip(req.ip))
            except Exception:
                ip[i] = 0  # unparseable -> never matches any predicate
        arrays["ip"] = ip
        asn = buf["asn"][:P]
        port = buf["remote_port"][:P]
        asn[B:] = 0
        port[B:] = 0
        for i, req in enumerate(requests):
            asn[i] = _clamp_i64(req.asn)
            port[i] = _clamp_i64(req.remote_port)
        arrays["asn"] = asn
        arrays["remote_port"] = port
        return RequestBatch(size=P, arrays=arrays, overflow=overflow,
                            staged_bytes=_nbytes(arrays))

    def _packed_rows(self, buf: dict, P: int):
        """The set's packed buffer as [P, width] rows, zeroed."""
        W = self._layout.width
        pk = buf["packed"][:P * W].reshape(P, W)
        pk[:] = 0
        return pk

    def _encode_requests_packed(self, requests, B: int, P: int,
                                buf: dict) -> RequestBatch:
        """Compact staging from RequestTuples: each field's capped
        prefix and the metadata tail into one [P, width] buffer. The
        byte matrices handed out are views of it; the lengths are the
        true ones (up to the spec), as the device's length predicates
        need. A row longer than its field's threshold is flagged."""
        layout = self._layout
        pk = self._packed_rows(buf, P)
        arrays: dict = {}
        overflow = buf["overflow"][:P]
        overflow[:] = False
        for field, off, w in layout.fields:
            spec = self.specs.get(field, 256)
            limit = self._thresholds.get(field, spec)
            data = pk[:, off:off + w]
            lens = buf[f"{field}_len"][:P]
            lens[B:] = 0
            for i, req in enumerate(requests):
                full = _to_bytes(getattr(req, field))
                if len(full) > limit:
                    overflow[i] = True
                raw = full[:w]
                data[i, :len(raw)] = np.frombuffer(raw, dtype=np.uint8)
                lens[i] = min(len(full), spec)
            arrays[f"{field}_bytes"] = data
            arrays[f"{field}_len"] = lens
        ip = buf["ip"][:P]
        ip[B:] = 0
        for i, req in enumerate(requests):
            try:
                ip[i], _ = ip_to_words(Ip(req.ip))
            except Exception:
                ip[i] = 0  # unparseable -> never matches any predicate
        arrays["ip"] = ip
        asn = buf["asn"][:P]
        port = buf["remote_port"][:P]
        asn[B:] = 0
        port[B:] = 0
        for i, req in enumerate(requests):
            asn[i] = _clamp_i64(req.asn)
            port[i] = _clamp_i64(req.remote_port)
        arrays["asn"] = asn
        arrays["remote_port"] = port
        self._pack_meta(pk, P, buf)
        return RequestBatch(size=P, arrays=arrays, overflow=overflow,
                            packed=pk, layout=layout,
                            staged_bytes=pk.nbytes)

    def _pack_meta(self, pk: np.ndarray, P: int, buf: dict) -> None:
        """The metadata tail of every packed row, from the side arrays:
        u16 little-endian lengths, big-endian IP bytes, int64 asn and
        remote_port in little-endian byte order."""
        layout = self._layout
        for field, off in layout.lens:
            lens = buf[f"{field}_len"][:P]
            pk[:, off] = lens & 0xFF
            pk[:, off + 1] = (lens >> 8) & 0xFF
        pk[:, layout.ip_off:layout.ip_off + 16] = \
            buf["ip"][:P].astype(">u4").view(np.uint8)
        for key, off in (("asn", layout.asn_off),
                         ("remote_port", layout.port_off)):
            pk[:, off:off + 8] = \
                buf[key][:P].astype("<i8").view(np.uint8).reshape(P, 8)

    def encode_slots(self, slots: np.ndarray,
                     pad_to: Optional[int] = None, *,
                     into: int) -> RequestBatch:
        """Request-slot rows (a REQUEST_SLOT_DTYPE view, as
        `Ring.dequeue_batch_into` fills) -> bucketed and padded views of
        the checked-out set `into`, equal to slots_to_arrays ->
        bucket_arrays -> pad_batch, with one vectorized copy per field.
        `overflow` is None: rows past the slot caps carry their flags
        and spill slots instead."""
        n = len(slots)
        P = self._check_shape(n, pad_to)
        buf = self._bufs[into]
        if self._layout is not None:
            return self._encode_slots_packed(slots, n, P, buf)
        arrays: dict = {}
        for field, len_key in SLOT_LEN_KEYS.items():
            cap = self.specs.get(field, 256)
            lens = buf[f"{field}_len"][:P]
            lens[:n] = slots[len_key]
            lens[n:] = 0
            L = bucket_len(int(lens[:n].max()), cap)
            data = buf[f"{field}_bytes"][:P, :L]
            data[:n] = slots[field][:, :L]
            data[n:] = 0
            arrays[f"{field}_bytes"] = data
            arrays[f"{field}_len"] = lens
        # country: a fixed 2-byte code with no length field (length 2 for
        # live rows, 0 for padding, as slots_to_arrays gives).
        cdata = buf["country_bytes"][:P, :2]
        cdata[:n] = np.frombuffer(slots["country"].tobytes(),
                                  dtype=np.uint8).reshape(-1, 2)
        cdata[n:] = 0
        clens = buf["country_len"][:P]
        clens[:n] = 2
        clens[n:] = 0
        arrays["country_bytes"] = cdata
        arrays["country_len"] = clens
        ip = buf["ip"][:P]
        ip[:n] = slots["ip"].view(">u4")  # big-endian words -> native
        ip[n:] = 0
        arrays["ip"] = ip
        for key in ("asn", "remote_port"):
            col = buf[key][:P]
            col[:n] = slots[key]
            col[n:] = 0
            arrays[key] = col
        return RequestBatch(size=P, arrays=arrays, overflow=None,
                            staged_bytes=_nbytes(arrays))

    def _encode_slots_packed(self, slots: np.ndarray, n: int, P: int,
                             buf: dict) -> RequestBatch:
        """Compact staging from slot rows: each field's capped prefix
        copied straight from the slots into the packed buffer, one
        strided copy per field. Rows whose true slot length passes a
        clamped field's threshold are flagged (depth overflow); with
        unclamped caps the thresholds are the slot caps and no row is
        (rows past the slot caps ride the ring's truncated and spill
        flags instead)."""
        layout = self._layout
        pk = self._packed_rows(buf, P)
        arrays: dict = {}
        overflow = buf["overflow"][:P]
        overflow[:] = False
        for field, off, w in layout.fields:
            data = pk[:, off:off + w]
            lens = buf[f"{field}_len"][:P]
            if field == "country":
                data[:n] = np.frombuffer(slots["country"].tobytes(),
                                         dtype=np.uint8).reshape(-1, 2)[:, :w]
                lens[:n] = 2
                lens[n:] = 0
            else:
                spec = self.specs.get(field, 256)
                limit = self._thresholds.get(field, spec)
                lens[:n] = slots[SLOT_LEN_KEYS[field]]
                lens[n:] = 0
                if limit < spec:
                    overflow[:n] |= lens[:n] > limit
                data[:n] = slots[field][:, :w]
            arrays[f"{field}_bytes"] = data
            arrays[f"{field}_len"] = lens
        ip = buf["ip"][:P]
        ip[:n] = slots["ip"].view(">u4")
        ip[n:] = 0
        arrays["ip"] = ip
        for key in ("asn", "remote_port"):
            col = buf[key][:P]
            col[:n] = slots[key]
            col[n:] = 0
            arrays[key] = col
        self._pack_meta(pk, P, buf)
        return RequestBatch(size=P, arrays=arrays, overflow=overflow,
                            packed=pk, layout=layout,
                            staged_bytes=pk.nbytes)


def _nbytes(arrays: Mapping) -> int:
    return sum(a.nbytes for a in arrays.values())


# The megastep's per-slice words, beside the stacked batch arrays.
_WINDOW_WORDS = ("n_valid", "epoch")


class DeviceInputQueue:
    """The megastep's input stacks (PINGOO_MEGASTEP=force).

    The megastep (engine/verdict.make_megastep_fn) reads K batch slices
    as one stacked {field: [K, B, ...]} plus an n_valid and an epoch word
    per slice. Each set of this queue holds stacks sized to the field
    capacities; `fill_slice` copies one encoded batch into slice j in
    place (so the staging views it came from are free at once), and the
    window ships trimmed to its K, its row count and each byte field's
    widest slice (`device_stack` on the CPU; `ship` into a CUDA graph's
    static inputs on the card). Short slices are masked by n_valid,
    never re-shaped, and slices shipped past the filled ones (`k_ship`
    quantised up the K ladder) arrive as zero rows with n_valid 0.

    Two differences from the JAX package's queue, which hands its
    `nbuf` sets out in turn:

      * the sets come from a free list. A set is held from `checkout()`
        to `release()`: on the sidecar until its window's last verdict,
        since host rules and spill rows read its `slice_view`s then; so
        no later window can refill the stacks of a window in flight,
        however many are in flight. `checkout(block=False)` raises when
        every set is out;
      * on the card the window is packed, at its shape, into one pinned
        buffer of its set and uploaded by one non-blocking copy queued
        on the current stream right before the graph's replay, then a
        CUDA event is recorded. `checkout()` waits for the set's event
        before handing the set out again, so the copy has read the
        buffer before anything refills it.
    """

    def __init__(self, k: int, max_batch: int,
                 field_specs: Optional[Mapping[str, int]] = None,
                 nbuf: int = 2):
        specs = dict(field_specs or DEFAULT_FIELD_SPECS)
        self.k = max(1, int(k))
        self.max_batch = int(max_batch)
        self.specs = specs
        self.nbuf = max(1, int(nbuf))
        self._free = list(range(self.nbuf))
        self._cv = threading.Condition()
        self._bufs: list[dict] = []
        self._widths: list[dict] = []
        self._rows: list[int] = [0] * self.nbuf
        # Per set: the pinned upload buffer (grown on demand) and the
        # CUDA event recorded after its last upload.
        self._pinned: list = [None] * self.nbuf
        self._shipped: list = [None] * self.nbuf
        for _ in range(self.nbuf):
            stacks: dict = {}
            for field in STRING_FIELDS:
                cap = specs.get(field, 256)
                stacks[f"{field}_bytes"] = np.zeros(
                    (self.k, self.max_batch, cap), dtype=np.uint8)
                stacks[f"{field}_len"] = np.zeros(
                    (self.k, self.max_batch), dtype=np.int32)
            stacks["ip"] = np.zeros(
                (self.k, self.max_batch, 4), dtype=np.uint32)
            stacks["asn"] = np.zeros(
                (self.k, self.max_batch), dtype=np.int64)
            stacks["remote_port"] = np.zeros(
                (self.k, self.max_batch), dtype=np.int64)
            stacks["n_valid"] = np.zeros(self.k, dtype=np.int32)
            stacks["epoch"] = np.zeros(self.k, dtype=np.int32)
            self._bufs.append(stacks)
            self._widths.append({})

    def checkout(self, block: bool = True) -> int:
        """A free stack set for a new window, held until `release`, its
        n_valid words zeroed. Blocks while every set is out; with
        `block=False` that raises instead."""
        with self._cv:
            if not self._free and not block:
                raise RuntimeError(
                    f"every megastep input set is checked out "
                    f"(nbuf={self.nbuf})")
            while not self._free:
                self._cv.wait()
            i = self._free.pop(0)
        if self._shipped[i] is not None:
            self._shipped[i].synchronize()
            self._shipped[i] = None
        self._bufs[i]["n_valid"][:] = 0
        self._widths[i].clear()
        self._rows[i] = 0
        return i

    def release(self, buf_id: int) -> None:
        with self._cv:
            self._free.append(buf_id)
            self._cv.notify()

    def fill_slice(self, buf_id: int, j: int, arrays: Mapping,
                   n_valid: int, epoch: int) -> None:
        """Copy one encoded batch into slice j of the set. Byte columns
        may be narrower than the capacity (bucketed views): the columns
        from the slice's width up to the window's widest are zeroed, so
        no earlier window's bytes show in the shipped window."""
        buf = self._bufs[buf_id]
        widths = self._widths[buf_id]
        rows = 0
        for name, arr in arrays.items():
            rows = arr.shape[0]
            if name.endswith("_bytes"):
                w = arr.shape[1]
                prev = widths.get(name, 0)
                dst = buf[name][j, :rows]
                dst[:, :w] = arr
                if w < prev:
                    dst[:, w:prev] = 0
                elif w > prev:
                    if prev and j:
                        buf[name][:j, :rows, prev:w] = 0
                    widths[name] = w
            else:
                buf[name][j, :rows] = arr
        if self._rows[buf_id] and rows != self._rows[buf_id]:
            raise ValueError(
                f"megastep slices must share one row bucket: "
                f"{rows} != {self._rows[buf_id]}")
        self._rows[buf_id] = rows
        buf["n_valid"][j] = n_valid
        buf["epoch"][j] = epoch

    def slice_view(self, buf_id: int, j: int, n: int) -> dict:
        """Host views of slice j's first n rows (capacity width), valid
        until the set is released."""
        buf = self._bufs[buf_id]
        return {name: buf[name][j, :n]
                for name in buf if name not in _WINDOW_WORDS}

    def window_shape(self, buf_id: int, k_ship: int) -> dict:
        """{name: shape} of the window as shipped with `k_ship` slices:
        [k_ship, rows, width] bytes (the window's widest slice),
        [k_ship, rows] lengths and numbers, [k_ship, rows, 4] IP words,
        [k_ship] n_valid and epoch."""
        k_ship = min(self.k, k_ship)
        buf = self._bufs[buf_id]
        widths = self._widths[buf_id]
        rows = self._rows[buf_id] or self.max_batch
        out = {}
        for name, stack in buf.items():
            if name in _WINDOW_WORDS:
                out[name] = (k_ship,)
            elif name.endswith("_bytes"):
                out[name] = (k_ship, rows, widths.get(name, stack.shape[2]))
            else:
                out[name] = (k_ship, rows) + stack.shape[2:]
        return out

    def _pack(self, buf_id: int, k_used: int, out: dict) -> None:
        """Write the window into `out` ({name: array} of `window_shape`;
        IP words widened to int64): the filled slices, zeros past them."""
        buf = self._bufs[buf_id]
        for name, dst in out.items():
            stack = buf[name]
            if name in _WINDOW_WORDS:
                dst[:] = stack[:dst.shape[0]]
                continue
            k, rows = dst.shape[:2]
            src = stack[:k_used, :rows]
            if name.endswith("_bytes"):
                src = src[:, :, :dst.shape[2]]
            dst[:k_used] = src
            dst[k_used:] = 0

    def device_stack(self, buf_id: int, k_used: int, pad_to: int = 0):
        """(stacked, n_valid, epoch) of the window as CPU tensors, the
        leading dim `max(k_used, pad_to)` capped at K."""
        k_ship = min(self.k, max(k_used, pad_to))
        out = {name: np.empty(shape, dtype=np.int64 if name == "ip"
                              else self._bufs[buf_id][name].dtype)
               for name, shape in self.window_shape(buf_id, k_ship).items()}
        self._pack(buf_id, k_used, out)
        t = {name: torch.from_numpy(a) for name, a in out.items()}
        nv, ep = t.pop("n_valid"), t.pop("epoch")
        return t, nv, ep

    def _layout(self, buf_id: int, k_ship: int) -> tuple[dict, int]:
        """{name: (dtype, shape, byte offset)} of the window's arrays
        packed into one flat byte buffer (each at a 256-byte boundary),
        and the buffer's size."""
        buf = self._bufs[buf_id]
        layout, off = {}, 0
        for name, shape in self.window_shape(buf_id, k_ship).items():
            dtype = _torch_dtype(name, buf[name].dtype)
            layout[name] = (dtype, shape, off)
            off += -(-math.prod(shape) * dtype.itemsize // 256) * 256
        return layout, off

    def empty_inputs(self, buf_id: int, k_ship: int, device):
        """(flat, {name: view}): one device byte tensor holding the
        window's arrays, n_valid and epoch included (a graph's static
        inputs), and each array's view of it."""
        layout, nbytes = self._layout(buf_id, k_ship)
        flat = torch.empty(nbytes, dtype=torch.uint8, device=device)
        return flat, _carve(flat, layout)

    def ship(self, buf_id: int, k_used: int, k_ship: int,
             flat: torch.Tensor) -> None:
        """Queue the window's upload into `flat` (from `empty_inputs`)
        on the current stream: the window packed into the set's pinned
        buffer in the same layout, one non-blocking copy, then the set's
        event."""
        layout, nbytes = self._layout(buf_id, k_ship)
        if flat.numel() != nbytes:
            raise ValueError(f"a window of {nbytes} bytes shipped into "
                             f"{flat.numel()}")
        pinned = self._pinned[buf_id]
        if pinned is None or pinned.numel() < nbytes:
            pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._pinned[buf_id] = pinned
        host = pinned[:nbytes]
        self._pack(buf_id, k_used, {n: v.numpy() for n, v in
                                    _carve(host, layout).items()})
        flat.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._shipped[buf_id] = event


def _carve(flat: torch.Tensor, layout: dict) -> dict:
    return {name: flat.narrow(0, off, math.prod(shape) * dtype.itemsize)
            .view(dtype).view(shape)
            for name, (dtype, shape, off) in layout.items()}


def _torch_dtype(name: str, np_dtype) -> torch.dtype:
    """The device dtype of a stacked array (`batch_tensors`' types)."""
    if name == "ip":
        return torch.int64
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def batch_tensors(arrays: Mapping, device) -> dict[str, torch.Tensor]:
    """Host arrays -> device tensors: bytes uint8, lengths int32, the
    [B, 4] IP words as int64 (uint32 values), asn/remote_port int64.
    Tensors already on `device` pass through."""
    device = torch.device(device)
    out: dict[str, torch.Tensor] = {}
    for key, a in arrays.items():
        if isinstance(a, torch.Tensor):
            out[key] = a.to(device)
            continue
        a = np.ascontiguousarray(a)
        if key == "ip":
            a = a.astype(np.int64)
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def packed_tensor(packed: np.ndarray, device) -> torch.Tensor:
    """A packed staging buffer ([P, width] uint8) on `device`: on the
    card one pinned copy and one non-blocking upload, whatever the
    number of fields."""
    t = torch.from_numpy(np.ascontiguousarray(packed))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def batch_to_contexts(
    batch: RequestBatch, lists: Mapping[str, list]
) -> list[Context]:
    """Interpreter contexts over exactly the (truncated) bytes the device
    saw — the parity oracle's view."""
    out = []
    for i in range(batch.size):
        fields = {}
        for field in STRING_FIELDS:
            data = batch[f"{field}_bytes"][i]
            n = int(batch[f"{field}_len"][i])
            fields[field] = bytes(data[:n]).decode("latin-1")
        out.append(Context({
            "http_request": {
                "host": fields["host"],
                "url": fields["url"],
                "path": fields["path"],
                "method": fields["method"],
                "user_agent": fields["user_agent"],
            },
            "client": {
                "ip": _words_to_ip(batch["ip"][i]),
                "remote_port": int(batch["remote_port"][i]),
                "asn": int(batch["asn"][i]),
                "country": fields["country"],
            },
            "lists": dict(lists),
        }))
    return out


def tuple_to_context(tup: RequestTuple, lists: Mapping[str, list]) -> Context:
    """Interpreter context straight from the UNTRUNCATED request tuple
    (overflow-row re-evaluation)."""
    try:
        ip = Ip(tup.ip)
    except Exception:
        ip = Ip("0.0.0.0")
    return Context({
        "http_request": {
            "host": tup.host, "url": tup.url, "path": tup.path,
            "method": tup.method, "user_agent": tup.user_agent,
        },
        "client": {
            "ip": ip, "remote_port": tup.remote_port,
            "asn": tup.asn, "country": tup.country,
        },
        "lists": dict(lists),
    })


def _words_to_ip(words: np.ndarray) -> Ip:
    value = 0
    for w in words:
        value = (value << 32) | int(w)
    if (value >> 32) == 0xFFFF:  # v4-mapped
        return Ip(ipaddress.ip_address(value & 0xFFFFFFFF))
    return Ip(ipaddress.ip_address(value))

