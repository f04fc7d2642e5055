"""HTTP/TCP services: reverse proxy, static site, TCP proxy.

Reference parity:
  * HttpProxyService (services/http_proxy_service.rs): route match,
    random upstream, hop-by-hop header stripping (:25-35,114-116),
    Host/X-Forwarded-For/-Host/-Proto + Pingoo-Client-Ip/-Country/-Asn
    (:134-190), upstream error -> 502 (:192-195), response cleanup:
    strip X-Accel-*/Alt-Svc, set `server: pingoo` (:37-43,197-201),
    4s connect timeout (:54-71).
  * StaticSiteService (services/http_static_site_service.rs): GET/HEAD
    only, traversal guard (:91-94), dir -> index.html and extensionless
    -> .html prettify (:100-123), ETag = SHA256(path,size,mtime) with
    If-None-Match -> 304 (:150-182), small-file cache 500 x <=500KB
    (:30-32,185-235), larger files streamed (:238-256), configurable
    not_found page.
  * TcpProxyService (services/tcp_proxy_service.rs): random upstream,
    3 retries / 5 ms, 3 s connect timeout, then bidirectional byte pump.
"""

from __future__ import annotations

import asyncio
import hashlib
import mimetypes
import os
import random
import time
from dataclasses import dataclass
from typing import Optional

from ..config.schema import ServiceConfig, StaticSiteConfig, Upstream
from ..expr import Context, Program, execute_as_bool

HOP_BY_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailer", "transfer-encoding", "upgrade",
}
RESPONSE_STRIP_HEADERS = {
    "x-accel-buffering", "x-accel-charset", "x-accel-expires",
    "x-accel-limit-rate", "x-accel-redirect", "alt-svc", "server",
}
CONNECT_TIMEOUT_S = 4.0
TCP_CONNECT_TIMEOUT_S = 3.0
TCP_RETRIES = 3
TCP_RETRY_DELAY_S = 0.005
STATIC_CACHE_MAX_ENTRIES = 500
STATIC_CACHE_MAX_FILE_SIZE = 500 * 1024


@dataclass
class Response:
    status: int
    headers: list[tuple[str, str]]
    body: bytes = b""
    stream_path: Optional[str] = None  # large static files stream from disk
    # Protocol upgrade (WebSocket): (upstream_reader, upstream_writer,
    # raw response head bytes). The listener relays the head verbatim
    # and then pumps raw bytes both ways until either side closes —
    # the reference serves with upgrades enabled
    # (http_listener.rs:277 serve_connection_with_upgrades).
    tunnel: Optional[tuple] = None


def match_route(route: Optional[Program], ctx: Context) -> bool:
    """Service route matching (services/mod.rs match_request): no route
    means match-all; errors mean no-match (same fail-open as rules)."""
    if route is None:
        return True
    return execute_as_bool(route, ctx)


class HttpProxyService:
    def __init__(self, config: ServiceConfig, registry):
        self.name = config.name
        self.route = config.route
        self.registry = registry
        self._session = None
        self._h2_conns: dict = {}  # (host, port) -> H2UpstreamConnection
        self._h2_lock = None  # created lazily on the serving loop

    async def _get_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0, ttl_dns_cache=10),
                timeout=aiohttp.ClientTimeout(connect=CONNECT_TIMEOUT_S),
                auto_decompress=False,
            )
        return self._session

    async def close(self):
        if self._session is not None:
            await self._session.close()
            self._session = None
        for conn in self._h2_conns.values():
            await conn.close()
        self._h2_conns.clear()

    async def _h2_conn(self, host: str, port: int):
        """Pooled h2 prior-knowledge upstream connection (the reference's
        hyper client pools h1/h2 alike, http_proxy_service.rs:54-71).
        Creation is serialized per service (concurrent first requests
        must not each open a connection and leak the losers), and a dead
        connection is closed before its replacement goes in."""
        from .h2 import H2UpstreamConnection

        if self._h2_lock is None:
            self._h2_lock = asyncio.Lock()
        key = (host, port)
        async with self._h2_lock:
            conn = self._h2_conns.get(key)
            if conn is None or not conn.alive:
                if conn is not None:
                    await conn.close()
                conn = H2UpstreamConnection(host, port)
                await asyncio.wait_for(conn.connect(), CONNECT_TIMEOUT_S)
                self._h2_conns[key] = conn
            return conn

    @staticmethod
    def _upgrade_value(req) -> Optional[str]:
        """The Upgrade token when this is an upgrade request (Connection
        lists 'upgrade' and an Upgrade header names the protocol)."""
        conn_v = ""
        up_v = None
        for n, v in req.headers:
            ln = n.lower()
            if ln == "connection":
                conn_v = v.lower()
            elif ln == "upgrade":
                up_v = v
        if up_v and "upgrade" in conn_v:
            return up_v
        return None

    async def _handle_upgrade(self, req, request_ctx, upstream,
                              upgrade: str) -> Response:
        """Tunnel an Upgrade request: send it to the upstream over a raw
        connection preserving the upgrade headers, read the response
        head, and hand the open connection to the listener for
        bidirectional pumping."""
        target_host = upstream.ip or upstream.hostname
        try:
            if upstream.tls:
                import ssl as ssl_mod

                ctx = ssl_mod.create_default_context()
                up_r, up_w = await asyncio.wait_for(
                    asyncio.open_connection(
                        target_host, upstream.port, ssl=ctx,
                        server_hostname=upstream.hostname),
                    CONNECT_TIMEOUT_S)
            else:
                up_r, up_w = await asyncio.wait_for(
                    asyncio.open_connection(target_host, upstream.port),
                    CONNECT_TIMEOUT_S)
        except Exception:
            return Response(502, [("content-type", "text/plain"),
                                  ("server", "pingoo")], b"Bad Gateway")
        head = f"{req.method} {req.target} HTTP/1.1\r\n"
        head += f"host: {upstream.hostname}\r\n"
        for n, v in req.headers:
            ln = n.lower()
            if ln in HOP_BY_HOP_HEADERS or ln == "host":
                continue
            head += f"{n}: {v}\r\n"
        head += f"connection: upgrade\r\nupgrade: {upgrade}\r\n"
        head += f"x-forwarded-for: {request_ctx.client_ip}\r\n"
        head += ("x-forwarded-proto: "
                 f"{'https' if request_ctx.tls else 'http'}\r\n")
        head += f"pingoo-client-ip: {request_ctx.client_ip}\r\n\r\n"
        try:
            up_w.write(head.encode("latin-1"))
            await up_w.drain()
            resp_head = await asyncio.wait_for(
                up_r.readuntil(b"\r\n\r\n"), 30)
        except Exception:
            up_w.close()
            return Response(502, [("content-type", "text/plain"),
                                  ("server", "pingoo")], b"Bad Gateway")
        status_line = resp_head.split(b"\r\n", 1)[0]
        parts = status_line.split()
        status = int(parts[1]) if len(parts) >= 2 and parts[1].isdigit() \
            else 502
        if status != 101:
            # Upstream REFUSED the upgrade: relay it as a normal framed
            # response (entering the raw tunnel here would let follow-up
            # keep-alive requests bypass rule evaluation entirely).
            try:
                return await self._read_refusal(up_r, resp_head, status)
            finally:
                up_w.close()
        # Relay the 101 head verbatim (its Connection/Upgrade/
        # Sec-WebSocket-* headers are the handshake).
        return Response(101, [], tunnel=(up_r, up_w, resp_head))

    @staticmethod
    async def _read_refusal(up_r, resp_head: bytes, status: int) -> Response:
        """Parse a non-101 answer to an upgrade request into a normal
        Response (content-length framing; EOF framing otherwise)."""
        headers = []
        content_length = None
        for line in resp_head.split(b"\r\n")[1:]:
            name, _, value = line.partition(b":")
            if not _:
                continue
            lname = name.decode("latin-1").strip().lower()
            v = value.decode("latin-1").strip()
            if lname == "content-length":
                try:
                    content_length = int(v)
                except ValueError:
                    pass
            if lname in HOP_BY_HOP_HEADERS or lname in RESPONSE_STRIP_HEADERS \
                    or lname == "content-length":
                continue
            headers.append((name.decode("latin-1").strip(), v))
        if content_length is not None:
            body = await asyncio.wait_for(
                up_r.readexactly(content_length), 30) if content_length \
                else b""
        else:
            body = await asyncio.wait_for(up_r.read(), 30)
        headers.append(("server", "pingoo"))
        return Response(status, headers, body)

    async def handle(self, req, request_ctx) -> Response:
        upstreams = self.registry.get_upstreams(self.name)
        if not upstreams:
            return Response(502, [("content-type", "text/plain")],
                            b"Bad Gateway")
        upstream = random.choice(upstreams)
        upgrade = self._upgrade_value(req)
        if upgrade is not None and not getattr(upstream, "h2", False):
            return await self._handle_upgrade(req, request_ctx, upstream,
                                              upgrade)
        scheme = "https" if upstream.tls else "http"
        target_host = upstream.ip or upstream.hostname
        url = f"{scheme}://{target_host}:{upstream.port}{req.target}"

        headers = []
        for name, value in req.headers:
            lname = name.lower()
            if lname in HOP_BY_HOP_HEADERS or lname == "host":
                continue
            headers.append((name, value))
        # Forwarding headers (http_proxy_service.rs:134-190).
        headers.append(("Host", upstream.hostname))
        headers.append(("X-Forwarded-Host", request_ctx.host))
        headers.append(("X-Forwarded-Proto",
                        "https" if request_ctx.tls else "http"))
        prior_xff = next((v for n, v in req.headers
                          if n.lower() == "x-forwarded-for"), None)
        xff = (f"{prior_xff}, {request_ctx.client_ip}" if prior_xff
               else request_ctx.client_ip)
        headers.append(("X-Forwarded-For", xff))
        headers.append(("Pingoo-Client-Ip", request_ctx.client_ip))
        if request_ctx.geoip_enabled:
            headers.append(("Pingoo-Client-Country", request_ctx.country))
            headers.append(("Pingoo-Client-Asn", str(request_ctx.asn)))

        if getattr(upstream, "h2", False):
            try:
                conn = await self._h2_conn(target_host, upstream.port)
                # No total timeout — the h1 path has none either (only
                # the connect timeout); long-poll upstreams must behave
                # identically over both protocols.
                status, resp_headers, body = await conn.request(
                    req.method, upstream.hostname, req.target, headers,
                    req.body or b"")
                out_headers = [
                    (n, v) for n, v in resp_headers
                    if n.lower() not in HOP_BY_HOP_HEADERS
                    and n.lower() not in RESPONSE_STRIP_HEADERS
                    and n.lower() != "content-length"
                ]
                out_headers.append(("server", "pingoo"))
                return Response(status, out_headers, body)
            except Exception:
                return Response(502, [("content-type", "text/plain"),
                                      ("server", "pingoo")], b"Bad Gateway")

        try:
            session = await self._get_session()
            async with session.request(
                req.method, url, headers=headers, data=req.body or None,
                allow_redirects=False,  # upstream TLS certs ARE validated
            ) as resp:
                body = await resp.read()
                out_headers = []
                for name, value in resp.headers.items():
                    lname = name.lower()
                    if (lname in HOP_BY_HOP_HEADERS
                            or lname in RESPONSE_STRIP_HEADERS
                            or lname == "content-length"):
                        continue
                    out_headers.append((name, value))
                out_headers.append(("server", "pingoo"))
                return Response(resp.status, out_headers, body)
        except Exception:
            return Response(502, [("content-type", "text/plain"),
                                  ("server", "pingoo")], b"Bad Gateway")


class StaticSiteService:
    def __init__(self, config: ServiceConfig):
        self.name = config.name
        self.route = config.route
        assert config.static is not None
        self.static: StaticSiteConfig = config.static
        self._cache: dict[str, tuple[float, Response]] = {}

    async def handle(self, req, request_ctx) -> Response:
        if req.method not in ("GET", "HEAD"):
            return Response(405, [("content-type", "text/plain")],
                            b"Method Not Allowed")
        path = req.path
        # Traversal guard (http_static_site_service.rs:91-94).
        if ".." in path or "\\" in path:
            return self._not_found()
        rel = path.lstrip("/")
        root = os.path.abspath(self.static.root)
        full = os.path.abspath(os.path.join(root, rel))
        if not (full == root or full.startswith(root + os.sep)):
            return self._not_found()
        # dir -> index.html; extensionless -> .html prettify (:100-123).
        if os.path.isdir(full):
            full = os.path.join(full, "index.html")
        elif not os.path.exists(full) and "." not in os.path.basename(full):
            candidate = full + ".html"
            if os.path.exists(candidate):
                full = candidate
        if not os.path.isfile(full):
            return self._not_found()

        try:
            st = os.stat(full)
        except OSError:
            return self._not_found()
        etag = '"' + hashlib.sha256(
            f"{full}{st.st_size}{st.st_mtime_ns}".encode()).hexdigest()[:32] + '"'
        if_none_match = next(
            (v for n, v in req.headers if n.lower() == "if-none-match"), None)
        if if_none_match == etag:
            return Response(304, [("etag", etag)])

        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        headers = [("content-type", ctype), ("etag", etag),
                   ("server", "pingoo")]
        if st.st_size > STATIC_CACHE_MAX_FILE_SIZE:
            return Response(200, headers, stream_path=full)
        cached = self._cache.get(full)
        if cached and cached[0] == st.st_mtime_ns:
            resp = cached[1]
            return Response(resp.status, headers, resp.body)
        with open(full, "rb") as f:
            body = f.read()
        if len(self._cache) >= STATIC_CACHE_MAX_ENTRIES:
            self._cache.clear()
        self._cache[full] = (st.st_mtime_ns, Response(200, headers, body))
        if req.method == "HEAD":
            return Response(200, headers)
        return Response(200, headers, body)

    def _not_found(self) -> Response:
        nf = self.static.not_found
        if nf.file and os.path.isfile(nf.file):
            with open(nf.file, "rb") as f:
                return Response(nf.status, [("content-type", "text/html")],
                                f.read())
        return Response(nf.status, [("content-type", "text/plain")],
                        b"Not Found")


class TcpProxyService:
    def __init__(self, config: ServiceConfig, registry):
        self.name = config.name
        self.registry = registry

    async def serve_connection(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        upstream_pair = None
        for attempt in range(TCP_RETRIES):
            upstreams = self.registry.get_upstreams(self.name)
            if upstreams:
                upstream = random.choice(upstreams)
                try:
                    upstream_pair = await asyncio.wait_for(
                        asyncio.open_connection(
                            upstream.ip or upstream.hostname, upstream.port),
                        TCP_CONNECT_TIMEOUT_S)
                    break
                except (OSError, asyncio.TimeoutError):
                    pass
            await asyncio.sleep(TCP_RETRY_DELAY_S)
        if upstream_pair is None:
            writer.close()
            return
        up_reader, up_writer = upstream_pair

        async def pump(src: asyncio.StreamReader, dst: asyncio.StreamWriter):
            try:
                while True:
                    chunk = await src.read(65536)
                    if not chunk:
                        # Half-close: signal EOF downstream but keep the
                        # other direction flowing (copy_bidirectional
                        # semantics, tcp_proxy_service.rs:74-82).
                        if dst.can_write_eof():
                            dst.write_eof()
                        break
                    dst.write(chunk)
                    await dst.drain()
            except (OSError, asyncio.CancelledError):
                try:
                    dst.close()
                except OSError:
                    pass

        await asyncio.gather(pump(reader, up_writer), pump(up_reader, writer))
        for w in (up_writer, writer):
            try:
                w.close()
            except OSError:
                pass


def build_http_services(configs: list[ServiceConfig], registry):
    """Factory (reference services/http_utils.rs:43-51)."""
    out = []
    for cfg in configs:
        if cfg.http_proxy is not None:
            out.append(HttpProxyService(cfg, registry))
        elif cfg.static is not None:
            out.append(StaticSiteService(cfg))
    return out
