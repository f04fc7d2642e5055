"""Runtime value model for the expression language.

Documented type set (reference docs/rules.md:40-48): Bool, String, Int,
Float, Ip, Regex, Array<T>, Map<K, V>.

Representation: Python natives for Bool/Int/Float/String/Array(list)/
Map(dict), plus two wrapper types:

  - Ip      — wraps either a single address or a CIDR network
              (`ipaddress` stdlib). List entries may be CIDRs (reference
              pingoo/lists.rs parses `IpNetwork`, lists.rs:86-100) and
              `Array<Ip>.contains(client.ip)` is CIDR containment
              (docs/rules.md:110 usage with a blocked_ips list).
  - Regex   — a compiled pattern; created from the string argument of
              `matches(...)`.

Int semantics are checked 64-bit signed (the reference language is Rust
i64; pingoo/rules.rs:30-33 notes "only signed integers are supported").
Arithmetic that leaves the i64 range is an EvalError -> the rule
no-matches (fail-open, pingoo/rules.rs:41-44).
"""

from __future__ import annotations

import functools
import ipaddress
import re
from typing import Union

from .errors import EvalError

I64_MIN = -(2**63)
I64_MAX = 2**63 - 1

_IpAddr = Union[ipaddress.IPv4Address, ipaddress.IPv6Address]
_IpNet = Union[ipaddress.IPv4Network, ipaddress.IPv6Network]


class Ip:
    """An IP address or CIDR network value."""

    __slots__ = ("addr", "net")

    def __init__(self, value: str | _IpAddr | _IpNet):
        self.addr: _IpAddr | None = None
        self.net: _IpNet | None = None
        if isinstance(value, (ipaddress.IPv4Address, ipaddress.IPv6Address)):
            self.addr = value
        elif isinstance(value, (ipaddress.IPv4Network, ipaddress.IPv6Network)):
            self.net = value
        else:
            text = str(value).strip()
            try:
                if "/" in text:
                    self.net = ipaddress.ip_network(text, strict=False)
                else:
                    self.addr = ipaddress.ip_address(text)
            except ValueError as exc:
                raise EvalError(f"invalid ip: {text!r}") from exc

    @property
    def is_network(self) -> bool:
        return self.net is not None

    def contains(self, other: "Ip") -> bool:
        """CIDR/equality containment: network ∋ address, or address == address."""
        if other.addr is None:
            raise EvalError("contains() argument must be a single ip address")
        if self.net is not None:
            if self.net.version != other.addr.version:
                return False
            return other.addr in self.net
        return self.addr == other.addr

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Ip):
            return NotImplemented
        return self.addr == other.addr and self.net == other.net

    def __hash__(self) -> int:
        return hash((self.addr, self.net))

    def __repr__(self) -> str:
        return f"Ip({self.addr or self.net})"

    def __str__(self) -> str:
        return str(self.addr if self.addr is not None else self.net)


class Regex:
    """A compiled regular expression value.

    `matches` is an unanchored search (CEL `matches` semantics). Patterns
    compile in *bytes mode* over UTF-8: the TPU engine scans byte tensors,
    so byte semantics everywhere keeps the CPU oracle and the device
    kernels bit-identical (ASCII-only \\d\\w\\s, `.` = any byte but \\n —
    also what Rust regex's (?-u) mode does). The pattern text is retained
    so the TPU compiler can re-compile it into a bit-parallel NFA
    (compiler/repat.py, compiler/nfa.py).
    """

    __slots__ = ("pattern", "_re")

    def __init__(self, pattern: str):
        self.pattern = pattern
        try:
            self._re = re.compile(pattern.encode("latin-1"))
        except (re.error, UnicodeEncodeError) as exc:
            raise EvalError(f"invalid regex {pattern!r}: {exc}") from exc

    def search(self, text: str) -> bool:
        try:
            data = text.encode("latin-1")
        except UnicodeEncodeError as exc:
            raise EvalError("non-byte string in matches()") from exc
        return self._re.search(data) is not None

    @staticmethod
    def cached(pattern: str) -> "Regex":
        """Compile-once lookup for the interpreter hot path — host-rule
        fallback evaluates `matches(lit)` per request, and re-compiling
        the pattern each time dominated the whole host batch cost.
        Failures are not cached (identical EvalError every call)."""
        return _regex_cache(pattern)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Regex):
            return NotImplemented
        return self.pattern == other.pattern

    def __hash__(self) -> int:
        return hash(self.pattern)

    def __repr__(self) -> str:
        return f"Regex({self.pattern!r})"


@functools.lru_cache(maxsize=4096)
def _regex_cache(pattern: str) -> Regex:
    return Regex(pattern)


def checked_i64(value: int) -> int:
    if not (I64_MIN <= value <= I64_MAX):
        raise EvalError("integer overflow")
    return value


def type_name(value: object) -> str:
    """Human-readable type name matching docs/rules.md:40-48 vocabulary."""
    if isinstance(value, bool):
        return "Bool"
    if isinstance(value, int):
        return "Int"
    if isinstance(value, float):
        return "Float"
    if isinstance(value, str):
        return "String"
    if isinstance(value, Ip):
        return "Ip"
    if isinstance(value, Regex):
        return "Regex"
    if isinstance(value, list):
        return "Array"
    if isinstance(value, dict):
        return "Map"
    return type(value).__name__
