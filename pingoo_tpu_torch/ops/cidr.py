"""IP / CIDR / int-set membership.

IPs travel as 4 big-endian uint32 words [B, 4] (v4 addresses are
v6-mapped ::ffff:a.b.c.d), held in int64 tensors: PyTorch has no uint32
arithmetic on every op, and int64 keeps unsigned order for the sorted
bucket search. Lowerings:

  * masked-compare table for small CIDR lists: a [B, N] compare;
  * sorted-prefix buckets for large v4 lists: per prefix length a sorted
    key array, indexed by the key's top SLOT_BITS bits so a probe
    binary-searches only its slot's span;
  * a bitset (or a sorted array) for int lists such as ASNs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..expr.values import Ip
from ._tables import U32_WIDE, TensorTable, arr

V4_PREFIX_OFFSET = 96  # ::ffff:0:0/96
SLOT_BITS = 16  # top-slot fan-out of the bucket index
BITSET_MAX_VALUE = 1 << 26


def ip_to_words(ip: Ip) -> tuple[np.ndarray, int]:
    """-> (4 big-endian uint32 words, prefix length in 128-bit space)."""
    if ip.addr is not None:
        packed_int = int(ip.addr)
        version = ip.addr.version
        prefix = 128
    else:
        packed_int = int(ip.net.network_address)
        version = ip.net.version
        prefix = ip.net.prefixlen + (V4_PREFIX_OFFSET if version == 4 else 0)
    if version == 4:
        packed_int |= 0xFFFF << 32  # v6-map
    words = np.array(
        [(packed_int >> shift) & 0xFFFFFFFF for shift in (96, 64, 32, 0)],
        dtype=np.uint32,
    )
    return words, prefix


def prefix_masks(prefix: int) -> np.ndarray:
    """4 uint32 masks covering the first `prefix` bits of a 128-bit key."""
    masks = np.zeros(4, dtype=np.uint32)
    remaining = prefix
    for w in range(4):
        bits = min(32, max(0, remaining))
        if bits > 0:
            masks[w] = np.uint32(0xFFFFFFFF << (32 - bits) & 0xFFFFFFFF)
        remaining -= 32
    return masks


@dataclass(frozen=True)
class CidrTable(TensorTable):
    """Masked-compare CIDR list (exact, any size; O(B*N))."""

    nets: torch.Tensor = arr(U32_WIDE)  # [N, 4] pre-masked network words
    masks: torch.Tensor = arr(U32_WIDE)  # [N, 4]


def build_cidr_table(entries: list[Ip]) -> CidrTable:
    N = max(len(entries), 1)
    nets = np.zeros((N, 4), dtype=np.uint32)
    masks = np.zeros((N, 4), dtype=np.uint32)
    for i, ip in enumerate(entries):
        words, prefix = ip_to_words(ip)
        m = prefix_masks(prefix)
        nets[i] = words & m
        masks[i] = m
    if not entries:
        # Unsatisfiable sentinel: (ip & 0) ^ 1 != 0 for every ip.
        masks[:] = 0
        nets[:] = 1
    return CidrTable.from_numpy(nets=nets, masks=masks)


def cidr_contains(table: CidrTable, ips: torch.Tensor) -> torch.Tensor:
    """ips [B, 4] int64 -> [B] bool: ip in any list entry."""
    diff = (ips[:, None, :] & table.masks[None]) ^ table.nets[None]
    return torch.all(diff == 0, dim=2).any(dim=1)


def ip_one_matrix(nets: torch.Tensor, masks: torch.Tensor,
                  ips: torch.Tensor) -> torch.Tensor:
    """Single-address/CIDR predicates, one column each: [B, N] bool."""
    diff = (ips[:, None, :] & masks[None]) ^ nets[None]
    return torch.all(diff == 0, dim=2)


@dataclass(frozen=True)
class V4PrefixBuckets(TensorTable):
    """Large v4 list: per-prefix-length sorted keys (left-justified in
    each bucket row, padded with 0xFFFFFFFF), the top-bits slot index
    `starts`, and an auxiliary CidrTable for non-v4 entries. `span_pad`
    only carries, in its length, the static worst-case slot span in
    bits (the binary-search step count)."""

    keys: torch.Tensor = arr(U32_WIDE)  # [NB, Nmax]
    bucket_prefix: torch.Tensor = arr()  # [NB] int32
    bucket_size: torch.Tensor = arr()  # [NB] int32
    aux: CidrTable = arr()
    starts: Optional[torch.Tensor] = arr(optional=True)  # [NB, 2^16 + 1]
    span_pad: Optional[torch.Tensor] = arr(optional=True)  # [steps] uint8


def index_v4_buckets(keys: np.ndarray, bucket_prefix: np.ndarray,
                     bucket_size: np.ndarray,
                     aux: CidrTable) -> V4PrefixBuckets:
    """Attach the top-bit slot index to raw bucket arrays."""
    NB = keys.shape[0]
    nslots = 1 << SLOT_BITS
    starts = np.zeros((NB, nslots + 1), dtype=np.int32)
    max_span = 1
    for i in range(NB):
        size = int(bucket_size[i])
        p = int(bucket_prefix[i])
        live = keys[i, :size].astype(np.uint64)
        his = live >> max(p - SLOT_BITS, 0)
        counts = np.bincount(his.astype(np.int64), minlength=nslots)
        starts[i, 1:] = np.cumsum(counts).astype(np.int32)
        if size:
            max_span = max(max_span, int(counts.max()))
    return V4PrefixBuckets.from_numpy(
        keys=keys, bucket_prefix=bucket_prefix, bucket_size=bucket_size,
        aux=aux, starts=starts,
        span_pad=np.zeros(int(max_span).bit_length(), dtype=np.uint8))


def build_v4_buckets(entries: list[Ip]) -> V4PrefixBuckets:
    by_prefix: dict[int, list[int]] = {}
    aux: list[Ip] = []
    for ip in entries:
        if ip.addr is not None and ip.addr.version == 4:
            by_prefix.setdefault(32, []).append(int(ip.addr))
        elif ip.net is not None and ip.net.version == 4:
            by_prefix.setdefault(ip.net.prefixlen, []).append(
                int(ip.net.network_address))
        else:
            aux.append(ip)
    prefixes = sorted(by_prefix)
    NB = max(len(prefixes), 1)
    Nmax = max((len(v) for v in by_prefix.values()), default=1)
    keys = np.full((NB, Nmax), 0xFFFFFFFF, dtype=np.uint32)
    bucket_prefix = np.zeros(NB, dtype=np.int32)
    bucket_size = np.zeros(NB, dtype=np.int32)
    for i, p in enumerate(prefixes):
        # Keys are right-justified top-p bits: key = addr >> (32 - p).
        vals = sorted({(v >> (32 - p)) if p < 32 else v for v in by_prefix[p]})
        keys[i, : len(vals)] = np.array(vals, dtype=np.uint32)
        bucket_prefix[i] = p
        bucket_size[i] = len(vals)
    return index_v4_buckets(keys, bucket_prefix, bucket_size,
                            build_cidr_table(aux))


def _bucket_key(prefix: torch.Tensor, v4: torch.Tensor) -> torch.Tensor:
    """Probe key per bucket: the ip's right-justified top-p bits.
    prefix [NB, 1] int64, v4 [1, B] int64 -> [NB, B]."""
    shifted = v4 >> (32 - prefix).clamp(1, 31)
    return torch.where(prefix >= 32, v4,
                       torch.where(prefix <= 0, torch.zeros_like(shifted),
                                   shifted))


def v4_buckets_contains(buckets: V4PrefixBuckets,
                        ips: torch.Tensor) -> torch.Tensor:
    """ips [B, 4] (v6-mapped words, int64) -> [B] bool membership. All
    buckets are probed at once as [NB, B] tensors."""
    is_v4 = (ips[:, 0] == 0) & (ips[:, 1] == 0) & (ips[:, 2] == 0xFFFF)
    v4 = ips[:, 3][None, :]  # [1, B]
    prefix = buckets.bucket_prefix.long()[:, None]  # [NB, 1]
    size = buckets.bucket_size.long()[:, None]
    keys = buckets.keys  # [NB, Nmax]
    nmax = keys.shape[1]
    key = _bucket_key(prefix, v4)  # [NB, B]
    if buckets.starts is not None:
        starts = buckets.starts.long()
        hi = key >> (prefix - SLOT_BITS).clamp(0, 31)
        lo = starts.gather(1, hi)
        n = starts.gather(1, hi + 1) - lo
        for _ in range(buckets.span_pad.shape[0]):
            half = n >> 1
            mid = lo + half
            # Past the last key the probe reads as 0xFFFFFFFF (never
            # below any key), as the reference's out-of-range take does.
            inside = mid < nmax
            got = keys.gather(1, mid.clamp(0, nmax - 1))
            go_right = inside & (got < key)
            lo = torch.where(go_right, mid + 1, lo)
            n = torch.where(go_right, n - half - 1, half)
        idx = lo
    else:
        idx = torch.searchsorted(keys, key.contiguous())
        idx = idx.clamp(0, nmax - 1)
    found = (keys.gather(1, idx.clamp(max=nmax - 1)) == key) & (idx < size)
    v4_hit = found.any(dim=0) & is_v4
    return v4_hit | cidr_contains(buckets.aux, ips)


@dataclass(frozen=True)
class IntBitset(TensorTable):
    """Non-negative int set as a bitset: one word gather + bit test."""

    bitset: torch.Tensor = arr(U32_WIDE)  # [ceil(max / 32)]


@dataclass(frozen=True)
class SortedIntSet(TensorTable):
    """Sparse / out-of-range int set: sorted keys + searchsorted. Keys
    are int32 whenever every value fits, gated by an in-range check."""

    keys: torch.Tensor = arr()  # [N] sorted int32 or int64
    size: torch.Tensor = arr()  # scalar int32


def build_int_set(values: list[int]):
    vals = sorted(set(values))
    if vals and vals[0] >= 0 and vals[-1] < BITSET_MAX_VALUE:
        nwords = (vals[-1] >> 5) + 1
        bits = np.zeros(nwords, dtype=np.uint32)
        a = np.array(vals, dtype=np.int64)
        np.bitwise_or.at(bits, a >> 5, np.uint32(1) << (a & 31).astype(np.uint32))
        return IntBitset.from_numpy(bitset=bits)
    fits32 = all(-(2**31) <= v < 2**31 for v in vals)
    dtype = np.int32 if fits32 else np.int64
    N = max(len(vals), 1)
    keys = np.full(N, np.iinfo(dtype).max, dtype=dtype)
    keys[: len(vals)] = np.array(vals, dtype=dtype)
    return SortedIntSet.from_numpy(keys=keys,
                                   size=np.array(len(vals), dtype=np.int32))


def int_set_contains(table, values: torch.Tensor) -> torch.Tensor:
    """values [B] int64 -> [B] bool (IntBitset or SortedIntSet)."""
    if isinstance(table, IntBitset):
        nbits = table.bitset.shape[0] << 5
        in_range = (values >= 0) & (values < nbits)
        idx = values.clamp(0, nbits - 1)
        word = table.bitset[idx >> 5]
        return (((word >> (idx & 31)) & 1) != 0) & in_range
    if table.keys.dtype == torch.int32:
        in_range = (values >= -(2**31)) & (values < 2**31)
        probe = values.clamp(-(2**31), 2**31 - 1).to(torch.int32)
    else:
        in_range = torch.ones_like(values, dtype=torch.bool)
        probe = values
    n = table.keys.shape[0]
    idx = torch.searchsorted(table.keys, probe).clamp(0, n - 1)
    return (table.keys[idx] == probe) & (idx < table.size) & in_range
