"""GeoIP: a self-contained MaxMind-DB (mmdb) decoder + lookup cache.

Reference parity (pingoo/geoip.rs): load from the fixed candidate paths
(config.rs:31-36), optionally zstd-compressed (.zst); per-IP record
{asn: u32, country: 2-letter code} where asn may be serialized as
"AS123" (serde_utils.rs:1-9); loopback/multicast short-circuit to
not-found (geoip.rs:74-77); 50k-entry 1h-TTL cache (geoip.rs:59-63);
a missing database just disables geoip (server.rs:41-43).

The decoder implements the MaxMind DB file format v2.0 (binary search
tree over address bits + typed data section) natively — no maxminddb
dependency. Both the reference's flat schema ({asn, country}) and the
standard GeoLite2 schema (country.iso_code / autonomous_system_number)
are understood. `build_mmdb` writes a minimal valid database for tests.
"""

from __future__ import annotations

import ipaddress
import struct
import time
from typing import Optional

GEOIP_DATABASE_PATHS = (
    "/etc/pingoo/geoip.mmdb",
    "/etc/pingoo/geoip.mmdb.zst",
    "/usr/share/pingoo/geoip.mmdb",
    "/usr/share/pingoo/geoip.mmdb.zst",
)

_METADATA_MARKER = b"\xab\xcd\xefMaxMind.com"
_DATA_SEPARATOR_SIZE = 16


class GeoipError(Exception):
    pass


class AddressNotFound(GeoipError):
    pass


class GeoipRecord:
    __slots__ = ("asn", "country")

    def __init__(self, asn: int = 0, country: str = "XX"):
        self.asn = asn
        self.country = country

    def __repr__(self) -> str:
        return f"GeoipRecord(asn={self.asn}, country={self.country!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, GeoipRecord)
                and (self.asn, self.country) == (other.asn, other.country))


# -- decoder -----------------------------------------------------------------


class _Decoder:
    """Typed data-section decoder (MaxMind DB spec §data section)."""

    def __init__(self, data: bytes, base: int):
        self.data = data
        self.base = base  # absolute offset of the data section

    def decode(self, offset: int):
        """offset is relative to the data section; returns (value, next)."""
        ctrl = self.data[self.base + offset]
        offset += 1
        dtype = ctrl >> 5
        if dtype == 0:  # extended type
            dtype = 7 + self.data[self.base + offset]
            offset += 1
        size = ctrl & 0x1F
        if dtype == 1:  # pointer
            ss = (size >> 3) & 0x3
            vbits = size & 0x7
            raw = self.data[self.base + offset : self.base + offset + ss + 1]
            offset += ss + 1
            value = int.from_bytes(raw, "big") | (vbits << (8 * (ss + 1)))
            ptr = value + (0, 2048, 526336, 0)[ss] if ss < 3 else value
            target, _ = self.decode(ptr)
            return target, offset
        if size == 29:
            size = 29 + self.data[self.base + offset]
            offset += 1
        elif size == 30:
            size = 285 + int.from_bytes(
                self.data[self.base + offset : self.base + offset + 2], "big")
            offset += 2
        elif size == 31:
            size = 65821 + int.from_bytes(
                self.data[self.base + offset : self.base + offset + 3], "big")
            offset += 3

        start = self.base + offset
        if dtype == 2:  # utf8 string
            return self.data[start : start + size].decode("utf-8"), offset + size
        if dtype == 3:  # double
            return struct.unpack(">d", self.data[start : start + 8])[0], offset + 8
        if dtype == 4:  # bytes
            return self.data[start : start + size], offset + size
        if dtype in (5, 6, 9, 10):  # uint16/32/64/128
            return int.from_bytes(self.data[start : start + size], "big"), offset + size
        if dtype == 7:  # map
            out = {}
            for _ in range(size):
                key, offset = self.decode(offset)
                val, offset = self.decode(offset)
                out[key] = val
            return out, offset
        if dtype == 8:  # int32
            raw = self.data[start : start + size]
            return int.from_bytes(raw, "big", signed=True), offset + size
        if dtype == 11:  # array
            out = []
            for _ in range(size):
                val, offset = self.decode(offset)
                out.append(val)
            return out, offset
        if dtype == 14:  # boolean (size encodes the value)
            return size != 0, offset
        if dtype == 15:  # float
            return struct.unpack(">f", self.data[start : start + 4])[0], offset + 4
        raise GeoipError(f"unsupported mmdb data type {dtype}")


class MmdbReader:
    """Binary-search-tree reader over the raw file bytes."""

    def __init__(self, data: bytes):
        idx = data.rfind(_METADATA_MARKER)
        if idx < 0:
            raise GeoipError("mmdb file is not valid: no metadata marker")
        meta_decoder = _Decoder(data, idx + len(_METADATA_MARKER))
        self.metadata, _ = meta_decoder.decode(0)
        try:
            self.node_count = int(self.metadata["node_count"])
            self.record_size = int(self.metadata["record_size"])
            self.ip_version = int(self.metadata["ip_version"])
        except KeyError as exc:
            raise GeoipError(f"mmdb metadata missing {exc}")
        if self.record_size not in (24, 28, 32):
            raise GeoipError(f"unsupported record size {self.record_size}")
        self.data = data
        self.tree_size = self.node_count * self.record_size * 2 // 8
        self.decoder = _Decoder(data, self.tree_size + _DATA_SEPARATOR_SIZE)

    def _read_record(self, node: int, side: int) -> int:
        rs = self.record_size
        base = node * rs * 2 // 8
        d = self.data
        if rs == 24:
            o = base + 3 * side
            return int.from_bytes(d[o : o + 3], "big")
        if rs == 32:
            o = base + 4 * side
            return int.from_bytes(d[o : o + 4], "big")
        # 28-bit records: 7 bytes per node; middle byte shared.
        if side == 0:
            return ((d[base + 3] >> 4) << 24) | int.from_bytes(
                d[base : base + 3], "big")
        return ((d[base + 3] & 0x0F) << 24) | int.from_bytes(
            d[base + 4 : base + 7], "big")

    def lookup_raw(self, ip) -> Optional[dict]:
        addr = ipaddress.ip_address(ip)
        if addr.version == 4 and self.ip_version == 6:
            bits = 96 * "0" + format(int(addr), "032b")
        elif addr.version == 6 and self.ip_version == 4:
            return None
        else:
            bits = format(int(addr), f"0{128 if addr.version == 6 else 32}b")
        node = 0
        for bit in bits:
            record = self._read_record(node, int(bit))
            if record == self.node_count:
                return None  # no data
            if record > self.node_count:
                offset = record - self.node_count - _DATA_SEPARATOR_SIZE
                value, _ = self.decoder.decode(offset)
                return value
            node = record
        return None


def parse_asn(value) -> int:
    """"AS123" or 123 -> 123 (reference serde_utils.rs:1-9)."""
    if isinstance(value, int):
        return value
    if isinstance(value, str):
        text = value[2:] if value[:2].upper() == "AS" else value
        try:
            return int(text)
        except ValueError:
            return 0
    return 0


def record_from_raw(raw: dict) -> GeoipRecord:
    """Understand both the reference's flat schema and GeoLite2."""
    asn = 0
    country = "XX"
    if "asn" in raw:
        asn = parse_asn(raw["asn"])
    elif "autonomous_system_number" in raw:
        asn = parse_asn(raw["autonomous_system_number"])
    c = raw.get("country")
    if isinstance(c, str):
        country = c
    elif isinstance(c, dict):
        country = str(c.get("iso_code", "XX"))
    if len(country) != 2 or not country.isascii():
        country = "XX"
    return GeoipRecord(asn=asn, country=country.upper())


class GeoipDB:
    """Reader + cache, mirroring GeoipDB in the reference."""

    CACHE_MAX = 50_000
    CACHE_TTL_S = 3600.0

    def __init__(self, reader: MmdbReader):
        import threading

        self.reader = reader
        self._cache: dict = {}
        # Shared between the asyncio listener thread and the ring-
        # sidecar thread; guards the promote/evict cache mutations.
        self._lock = threading.Lock()

    @staticmethod
    def load(paths=GEOIP_DATABASE_PATHS) -> Optional["GeoipDB"]:
        import os

        for path in paths:
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                content = f.read()
            if path.endswith(".zst"):
                import zstandard

                content = zstandard.ZstdDecompressor().decompress(
                    content, max_output_size=1 << 31)
            return GeoipDB(MmdbReader(content))
        return None

    def lookup(self, ip) -> GeoipRecord:
        addr = ipaddress.ip_address(ip)
        if addr.is_loopback or addr.is_multicast:
            raise AddressNotFound(str(ip))
        now = time.monotonic()
        # One GeoipDB is shared between the asyncio listener thread and
        # the ring-sidecar thread (native_plane wiring): the promote /
        # evict mutations below need the lock (the mmdb tree walk runs
        # outside it).
        with self._lock:
            hit = self._cache.get(addr)
            if hit is not None and hit[1] > now:
                # LRU promotion: re-insert at the dict tail so
                # sustained floods of unique addresses evict their own
                # stale misses before they evict live entries.
                del self._cache[addr]
                self._cache[addr] = hit
        if hit is not None and hit[1] > now:
            if hit[0] is None:  # cached miss
                raise AddressNotFound(str(ip))
            return hit[0]
        raw = self.reader.lookup_raw(addr)
        if raw is None or not isinstance(raw, dict):
            # Cache the MISS too: with a partial database, absent
            # addresses are the common case on hot serving paths (the
            # ring sidecar enriches every request), and re-walking the
            # mmdb tree per request would defeat the cache entirely.
            with self._lock:
                if len(self._cache) >= self.CACHE_MAX:
                    self._evict(now)
                self._cache[addr] = (None, now + self.CACHE_TTL_S)
            raise AddressNotFound(str(ip))
        record = record_from_raw(raw)
        with self._lock:
            if len(self._cache) >= self.CACHE_MAX:
                self._evict(now)
            self._cache[addr] = (record, now + self.CACHE_TTL_S)
        return record

    def _evict(self, now: float) -> None:
        """Bounded partial eviction (expired first, then the oldest
        eighth) — wholesale clear() would let a flood of unique absent
        IPs repeatedly wipe every live positive entry (moka, the
        reference's cache, evicts incrementally for the same reason)."""
        expired = [k for k, v in self._cache.items() if v[1] <= now]
        for k in expired:
            del self._cache[k]
        if len(self._cache) >= self.CACHE_MAX:
            import itertools

            drop = max(1, self.CACHE_MAX // 8)
            for k in list(itertools.islice(iter(self._cache), drop)):
                del self._cache[k]


# -- writer (test fixtures) --------------------------------------------------


def _encode_value(value) -> bytes:
    if isinstance(value, str):
        raw = value.encode("utf-8")
        assert len(raw) < 29
        return bytes([(2 << 5) | len(raw)]) + raw
    if isinstance(value, int):
        raw = value.to_bytes(max((value.bit_length() + 7) // 8, 1), "big")
        assert len(raw) <= 4
        return bytes([(6 << 5) | len(raw)]) + raw
    if isinstance(value, dict):
        out = bytearray([(7 << 5) | len(value)])
        for k, v in value.items():
            out += _encode_value(str(k))
            out += _encode_value(v)
        return bytes(out)
    raise GeoipError(f"writer: unsupported type {type(value)}")


def build_mmdb(entries: dict[str, dict], ip_version: int = 6) -> bytes:
    """Build a minimal valid mmdb: {network_cidr: record_dict}.

    Networks must be IPv4 (mapped under ::/96 when ip_version is 6,
    matching how readers traverse v4 lookups).
    """
    record_size = 32
    # Data section: concatenate encoded records, remember offsets.
    data_section = bytearray()
    offsets: dict[str, int] = {}
    nets = []
    for cidr, record in entries.items():
        offsets[cidr] = len(data_section)
        data_section += _encode_value(record)
        nets.append(ipaddress.ip_network(cidr, strict=False))

    # Build an explicit bit trie.
    nodes: list[list] = [[None, None]]  # each: [left, right]; int -> node idx

    def insert(bits: str, leaf_key: str):
        cur = 0
        for i, b in enumerate(bits):
            side = int(b)
            if i == len(bits) - 1:
                nodes[cur][side] = ("leaf", leaf_key)
                return
            nxt = nodes[cur][side]
            if not isinstance(nxt, int):
                nodes.append([None, None])
                nxt = len(nodes) - 1
                nodes[cur][side] = nxt
            cur = nxt

    for cidr, net in zip(entries.keys(), nets):
        assert net.version == 4, "test writer supports v4 networks"
        prefix_bits = format(int(net.network_address), "032b")[: net.prefixlen]
        if ip_version == 6:
            prefix_bits = "0" * 96 + prefix_bits
        insert(prefix_bits, cidr)

    node_count = len(nodes)
    tree = bytearray()
    for left, right in nodes:
        for rec in (left, right):
            if rec is None:
                value = node_count  # no data
            elif isinstance(rec, int):
                value = rec
            else:
                value = node_count + _DATA_SEPARATOR_SIZE + offsets[rec[1]]
            tree += value.to_bytes(4, "big")

    metadata = {
        "node_count": node_count,
        "record_size": record_size,
        "ip_version": ip_version,
        "database_type": "pingoo-tpu-test",
        "binary_format_major_version": 2,
        "binary_format_minor_version": 0,
    }
    return (bytes(tree) + b"\x00" * _DATA_SEPARATOR_SIZE + bytes(data_section)
            + _METADATA_MARKER + _encode_value(metadata))
