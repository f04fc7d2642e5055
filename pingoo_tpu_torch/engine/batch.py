"""Request batch encoding: request tuples -> fixed-shape arrays.

The host extracts one `RequestTuple` per request and batches them into
zero-padded byte matrices plus numeric columns (numpy, on the host);
`batch_tensors` places them on the plan's device. Every string field is
capped at its plan capacity (compiler/lowering.DEFAULT_FIELD_SPECS); a
request whose field exceeds it is flagged in `overflow` and re-evaluated
by the interpreter over the untruncated strings (engine/service.py).
`batch_to_contexts` rebuilds the strings the device saw (the parity
oracle's view). Only full staging is ported: every field is staged at
its full width, then `bucket_arrays` trims the columns to a power of two.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from ..compiler.lowering import DEFAULT_FIELD_SPECS
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
    flags rows whose fields exceeded device capacity."""

    size: int
    arrays: dict
    overflow: Optional[np.ndarray] = None

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

