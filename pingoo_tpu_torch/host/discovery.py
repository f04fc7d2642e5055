"""Service discovery: static config + DNS + Docker, with a 2s refresh loop.

Reference parity (pingoo/service_discovery/):
  * ServiceRegistry (service_registry.rs:22-103): static upstreams from
    config merged with discovered ones; background loop every 2 s;
    diff-and-swap so readers always see a consistent snapshot; a failing
    discoverer keeps the last known state (:112-119).
  * DNS discoverer (dns.rs): resolve non-ip upstream hostnames; the
    reference's IPv6-loopback workaround (::1 -> 127.0.0.1, dns.rs:73-75)
    is preserved.
  * Docker discoverer (docker.rs + docker/ crate): containers labeled
    `pingoo.service` (+ optional `pingoo.port`) via the Docker Engine API
    over the unix socket, taking the bridge-network IP (docker.rs:56-156).
    Implemented against the same REST endpoint (/containers/json) with a
    minimal unix-socket HTTP client — the reference's whole `docker`
    crate collapses into _docker_list_containers.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
from typing import Iterable, Optional

from ..config.schema import ServiceConfig, Upstream
from ..logging_utils import get_logger

log = get_logger(__name__)

REFRESH_INTERVAL_S = 2.0
DOCKER_SERVICE_LABEL = "pingoo.service"
DOCKER_PORT_LABEL = "pingoo.port"
# The reference clamps resolver TTLs (dns.rs:97-105): positive answers
# live at least 60 s (no re-resolve on every 2 s tick) and at most 2 h;
# a failing resolver serves the last-known addresses for up to the
# negative cap before the upstream drops.
DNS_POSITIVE_MIN_TTL_S = 60.0
DNS_POSITIVE_MAX_TTL_S = 7200.0
DNS_NEGATIVE_MAX_TTL_S = 1800.0
# Problem containers are warned about once per idle window, via a cache
# so ids don't accumulate forever (docker.rs:20-22,39 moka time_to_idle).
DOCKER_WARN_IDLE_S = 600.0


class ServiceRegistry:
    def __init__(
        self,
        services: Iterable[ServiceConfig],
        docker_socket: str = "/var/run/docker.sock",
        enable_docker: bool = True,
        enable_dns: bool = True,
    ):
        self._static: dict[str, list[Upstream]] = {}
        self._dns_targets: dict[str, list[Upstream]] = {}
        for svc in services:
            ups = list(svc.http_proxy or ()) + list(svc.tcp_proxy or ())
            resolved = [u for u in ups if u.ip is not None]
            pending = [u for u in ups if u.ip is None]
            self._static[svc.name] = resolved
            if pending:
                self._dns_targets[svc.name] = pending
        self._current: dict[str, list[Upstream]] = dict(self._static)
        self.docker_socket = docker_socket
        self.enable_docker = enable_docker
        self.enable_dns = enable_dns
        self._task: Optional[asyncio.Task] = None
        # (hostname, port) -> (resolved bare IPs, resolved-at timestamp).
        # Bare IPs, NOT Upstream objects: two services may point at the
        # same host:port with different tls/h2 flags, and each target
        # must rebuild its own Upstreams from the shared addresses.
        self._dns_cache: dict[tuple, tuple[list[str], float]] = {}
        self._docker_warned: dict[str, float] = {}  # container id -> warned-at

    # -- reads (hot path) ----------------------------------------------------

    def get_upstreams(self, service: str) -> list[Upstream]:
        return self._current.get(service, [])

    # -- background loop -----------------------------------------------------

    async def start_in_background(self) -> None:
        await self.discover()  # first resolution synchronously at boot
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(REFRESH_INTERVAL_S)
            try:
                await self.discover()
            except Exception:
                pass  # keep last state (service_registry.rs:112-119)

    async def discover(self) -> None:
        dns_result, docker_result = await asyncio.gather(
            self._discover_dns(), self._discover_docker(),
            return_exceptions=True)
        merged: dict[str, list[Upstream]] = {
            name: list(ups) for name, ups in self._static.items()
        }
        if isinstance(dns_result, dict):
            for name, ups in dns_result.items():
                merged.setdefault(name, []).extend(ups)
        if isinstance(docker_result, dict):
            for name, ups in docker_result.items():
                merged.setdefault(name, []).extend(ups)
        # Atomic swap per service (diff_upstreams + Arc swap in reference).
        self._current = merged

    # -- DNS -----------------------------------------------------------------

    async def _getaddrinfo(self, hostname: str, port: int):
        """Resolver seam (stubbed in tests for TTL-behavior checks)."""
        loop = asyncio.get_running_loop()
        return await loop.getaddrinfo(hostname, port,
                                      type=socket.SOCK_STREAM)

    async def _discover_dns(self) -> dict[str, list[Upstream]]:
        if not self.enable_dns or not self._dns_targets:
            return {}
        out: dict[str, list[Upstream]] = {}
        now = time.monotonic()
        for service, targets in self._dns_targets.items():
            ups: list[Upstream] = []
            for target in targets:
                def build(ips):
                    return [Upstream(hostname=target.hostname,
                                     port=target.port, tls=target.tls,
                                     ip=ip, h2=target.h2) for ip in ips]

                cache_key = (target.hostname, target.port)
                cached, resolved_at = self._dns_cache.get(
                    cache_key, ([], -1e18))
                age = now - resolved_at
                if cached and age < DNS_POSITIVE_MIN_TTL_S:
                    # Positive-TTL floor: don't hammer the resolver on
                    # every 2 s tick (dns.rs positive_min_ttl = 60 s).
                    ups.extend(build(cached))
                    continue
                try:
                    infos = await self._getaddrinfo(target.hostname,
                                                    target.port)
                except OSError:
                    # Resolver failure: serve the last-known addresses up
                    # to the negative cap (dns.rs negative_max_ttl 1800 s;
                    # reference also keeps last state on discoverer
                    # failure, service_registry.rs:112-119).
                    if cached and age < DNS_NEGATIVE_MAX_TTL_S:
                        ups.extend(build(cached))
                    continue
                ips: list[str] = []
                for _family, _type, _proto, _canon, sockaddr in infos:
                    ip = sockaddr[0]
                    if ip == "::1":
                        ip = "127.0.0.1"  # dns.rs:73-75 workaround
                    if ip not in ips:
                        ips.append(ip)
                self._dns_cache[cache_key] = (ips, now)
                ups.extend(build(ips))
            if ups:
                out[service] = ups
        # Positive-TTL ceiling: entries never serve past 2 h without a
        # successful re-resolution (dns.rs positive_max_ttl = 7200 s).
        self._dns_cache = {
            k: v for k, v in self._dns_cache.items()
            if now - v[1] < DNS_POSITIVE_MAX_TTL_S
        }
        return out

    # -- Docker --------------------------------------------------------------

    async def _discover_docker(self) -> dict[str, list[Upstream]]:
        if not self.enable_docker:
            return {}
        try:
            containers = await _docker_list_containers(self.docker_socket)
        except OSError:
            return {}
        out: dict[str, list[Upstream]] = {}
        for container in containers:
            labels = container.get("Labels") or {}
            service = labels.get(DOCKER_SERVICE_LABEL)
            if not service:
                continue
            cid = container.get("Id", "?")
            port = None
            if DOCKER_PORT_LABEL in labels:
                try:
                    port = int(labels[DOCKER_PORT_LABEL])
                except ValueError:
                    self._warn_container(
                        cid, f"invalid {DOCKER_PORT_LABEL} label")
                    continue
            else:
                ports = container.get("Ports") or []
                private = [p.get("PrivatePort") for p in ports
                           if p.get("PrivatePort")]
                if len(private) == 1:
                    port = private[0]
            if port is None:
                self._warn_container(
                    cid, "no usable port (ambiguous or missing; set "
                         f"{DOCKER_PORT_LABEL})")
                continue
            networks = ((container.get("NetworkSettings") or {})
                        .get("Networks") or {})
            ip = None
            for net in networks.values():
                if net.get("IPAddress"):
                    ip = net["IPAddress"]
                    break
            if not ip:
                self._warn_container(cid, "no bridge-network IP address")
                continue
            out.setdefault(service, []).append(
                Upstream(hostname=ip, port=port, tls=False, ip=ip))
        return out

    def _warn_container(self, cid: str, problem: str) -> None:
        """Warn about a problem container once per idle window, with the
        cache pruned so departed container ids don't accumulate
        (reference docker.rs:20-22,39 warned_containers moka cache)."""
        now = time.monotonic()
        self._docker_warned = {
            k: ts for k, ts in self._docker_warned.items()
            if now - ts < DOCKER_WARN_IDLE_S
        }
        if cid in self._docker_warned:
            self._docker_warned[cid] = now  # refresh the idle timer
            return
        self._docker_warned[cid] = now
        log.warning(f"docker discovery: skipping container {cid[:12]}: "
                    f"{problem}")


async def _docker_list_containers(socket_path: str) -> list[dict]:
    """GET /containers/json over the Docker unix socket
    (reference docker/src/client.rs:41-145 + containers.rs:6-12)."""
    reader, writer = await asyncio.open_unix_connection(socket_path)
    try:
        writer.write(
            b"GET /v1.43/containers/json HTTP/1.1\r\n"
            b"Host: docker\r\nConnection: close\r\n\r\n")
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0]
    if b" 200 " not in status_line:
        raise OSError(f"docker api: {status_line!r}")
    if b"chunked" in head.lower():
        body = _dechunk(body)
    return json.loads(body.decode("utf-8"))


def _dechunk(body: bytes) -> bytes:
    out = bytearray()
    while body:
        size_line, _, rest = body.partition(b"\r\n")
        try:
            size = int(size_line.split(b";")[0], 16)
        except ValueError:
            break
        if size == 0:
            break
        out += rest[:size]
        body = rest[size + 2:]
    return bytes(out)
