"""HTTP/HTTPS listener: the WAF hot path.

Reference parity (pingoo/listeners/http_listener.rs:120-282, https_
listener.rs:98-110 — the same function drives both, TLS handled by the
wrapping transport):

  per request: host/path extraction (:140-141, 284-296) -> geoip lookup
  with not-found -> default record (:143-157) -> user-agent trim with
  256-byte cap (:159-165) -> captcha client id (:167) -> cookie parse
  (:169-181) -> empty/oversized UA -> 403 (:196-198) ->
  /__pingoo/captcha* routing (:200-204) -> captcha-verified cookie check
  where an INVALID cookie serves the challenge page immediately
  (:222-236) -> rules loop with per-action semantics: Block -> 403,
  Captcha -> challenge page unless verified; NOTE the loop continues
  through subsequent matching rules (:251-264) -> service routing loop,
  first match handles (:266-270) -> 404 (:272).

The one architectural change: the rules loop consumes a per-request row
of the batched verdict (engine/service.py, whose scans run as CUDA
kernels on the card) instead of tree-walking rules inline; action
application order is identical because the engine returns the full
per-rule match row.

The port's own decisions, where the JAX package's listener reaches
features the port does not have:

  * an exception from `VerdictService.evaluate` (a device error goes
    down the service's degradation ladder and is served; what reaches
    the listener is a kernel that failed to build or launch) answers
    503 and counts in `ListenerStats.engine_errors`, and never allows;
  * /__pingoo/metrics serves the metric registry's Prometheus text
    (`text/plain; version=0.0.4`) by default, as the JAX package does,
    and its JSON payload (listener counts, the verdict service's
    `stats.snapshot()` and `pipeline_snapshot()`) under
    `Accept: application/json`; the listener's counts reach the
    registry through a collector (`_export_metrics`, unregistered by
    `close()`). /__pingoo/compileledger dumps the process's compile
    ledger (obs/perf.py). The flight-recorder and timeline routes
    answer 501 (ROADMAP.md item 10, slice 3);
  * /__pingoo/profile opens a torch.profiler window
    (`VerdictService.capture_profile`).
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Optional

import h11

from ..engine import bodyscan
from ..engine.batch import RequestTuple
from ..engine.service import VerdictService
from ..expr import Context
from ..logging_utils import get_logger
from ..obs import schema as obs_schema
from ..obs.trace import TRACE_HEADER, AccessLogSampler, new_trace_id
from .captcha import (
    CAPTCHA_PATH_PREFIX,
    CAPTCHA_VERIFIED_COOKIE,
    CaptchaManager,
    generate_captcha_client_id,
)
from .geoip import AddressNotFound, GeoipDB, GeoipRecord
from .services import Response, match_route

USER_AGENT_MAX_LENGTH = 256
HOSTNAME_MAX_LENGTH = 256

log = get_logger(__name__)


def _int_env(name: str, default: int, floor: int) -> int:
    raw = os.environ.get(name, "")
    try:
        value = int(raw)
    except ValueError:
        return default
    return value if value >= floor else default


# Request-size caps, shared knob-for-knob with the JAX package's native
# plane (its httpd.cc reads the same env vars) so oversized requests get
# the same status on both listeners: 431 for a head beyond
# PINGOO_MAX_HEADER_BYTES, 413 for a body beyond PINGOO_MAX_BODY_BYTES.
MAX_HEADER_BYTES = _int_env("PINGOO_MAX_HEADER_BYTES", 32 * 1024, 256)
MAX_BODY_BYTES = _int_env("PINGOO_MAX_BODY_BYTES", 16 * 1024 * 1024, 1)

# End of an h1 request head, tolerating the bare-LF variants h11
# accepts (the strict gate below then rejects them explicitly rather
# than letting the two listener planes diverge on them).
_HEAD_END_RE = re.compile(rb"\r?\n\r?\n")

_RAW_400 = (b"HTTP/1.1 400 Bad Request\r\nserver: pingoo\r\n"
            b"content-length: 0\r\nconnection: close\r\n\r\n")
_RAW_413 = (b"HTTP/1.1 413 Content Too Large\r\nserver: pingoo\r\n"
            b"content-length: 0\r\nconnection: close\r\n\r\n")
_RAW_431 = (b"HTTP/1.1 431 Request Header Fields Too Large\r\n"
            b"server: pingoo\r\n"
            b"content-length: 0\r\nconnection: close\r\n\r\n")


def strict_head_violation(head: bytes) -> Optional[str]:
    """WAFFLED-class strict gate over the RAW request head, applied
    before h11 parses it (and mirrored in the native httpd's parse_head):
    h11 is lenient exactly where parser pairs historically disagree —
    it joins obsolete line folds, collapses value-identical duplicate
    Content-Length headers, accepts bare-LF line endings and
    Transfer-Encoding alongside Content-Length. Each of those is a
    framing ambiguity one hop may read differently from the next
    (request smuggling), so both listener planes refuse them outright.
    Returns a short reason string, or None when the head is clean."""
    if b"\n" in head.replace(b"\r\n", b""):
        return "bare-lf-line-ending"
    lines = head.split(b"\r\n")
    # h11 tolerates versions up to HTTP/2.x on an h1 socket; the native
    # plane serves exactly 1.0/1.1. Pin the gate to the intersection.
    if not (lines[0].endswith(b" HTTP/1.1")
            or lines[0].endswith(b" HTTP/1.0")):
        return "http-version"
    cl_seen = 0
    te_seen = False
    for line in lines[1:]:
        if not line:
            break
        if line[:1] in (b" ", b"\t"):
            return "obs-fold"
        name, sep, value = line.partition(b":")
        if not sep:
            return "colonless-field-line"
        if name != name.rstrip(b" \t"):
            return "whitespace-before-colon"
        lname = name.lower()
        if lname == b"content-length":
            cl_seen += 1
            # Digits only (after OWS): h11 collapses a value-identical
            # list ("3, 3") that the native plane refuses; and signs,
            # blanks, or separators are framing ambiguity either way.
            if not value.strip(b" \t").isdigit():
                return "bad-content-length"
        elif lname == b"transfer-encoding":
            te_seen = True
    if cl_seen > 1:
        return "duplicate-content-length"
    if te_seen and cl_seen:
        return "te-with-cl"
    return None
GRACEFUL_SHUTDOWN_S = 20  # listeners/mod.rs:28


@dataclass
class Request:
    method: str
    target: str  # full request target (url)
    path: str
    headers: list[tuple[str, str]]
    body: bytes = b""


@dataclass
class RequestContext:
    """Reference http_listener.rs RequestContext (:183-194)."""

    client_ip: str
    client_port: int
    asn: int = 0
    country: str = "XX"
    geoip_enabled: bool = False
    tls: bool = False
    host: str = ""


@dataclass
class ListenerStats:
    requests: int = 0
    blocked: int = 0
    captcha_served: int = 0
    fail_open: int = 0  # degraded verdicts served (engine fail-open)
    body_fail_open: int = 0  # body scans degraded to metadata-only
    engine_errors: int = 0  # evaluate() raised: answered 503
    started_at: float = field(default_factory=time.time)


def blocked_response() -> Response:
    return Response(403, [("content-type", "text/plain"),
                          ("server", "pingoo")], b"Forbidden")


def not_found_response() -> Response:
    return Response(404, [("content-type", "text/plain"),
                          ("server", "pingoo")], b"Not Found")


def unavailable_response() -> Response:
    return Response(503, [("content-type", "text/plain"),
                          ("server", "pingoo")], b"Service Unavailable")


def not_ported_response(route: str) -> Response:
    """501 for an observability route of the JAX package that the port
    does not have yet."""
    return Response(501, [("content-type", "application/json")],
                    json.dumps({"error": (
                        f"{route} is not supported by pingoo_tpu_torch yet "
                        "(ROADMAP.md: port queue item 10, observability "
                        "parity)")}).encode())


def parse_cookies(headers: list[tuple[str, str]]) -> dict[str, str]:
    out: dict[str, str] = {}
    for name, value in headers:
        if name.lower() != "cookie":
            continue
        for part in value.split(";"):
            k, _, v = part.strip().partition("=")
            if k:
                out.setdefault(k, v)
    return out


def _strip_port(authority: str) -> str:
    """Drop a trailing :port, IPv6-bracket aware: "[::1]:80" -> "[::1]"."""
    authority = authority.strip()
    if authority.startswith("["):
        end = authority.find("]")
        return authority[: end + 1] if end >= 0 else authority
    return authority.rsplit(":", 1)[0] if ":" in authority else authority


def get_host(req: Request) -> str:
    """Host from the request target or Host header (:284-296). Over-long
    hosts become EMPTY, not truncated (heapless from_str overflow ->
    unwrap_or_default, http_listener.rs:287,292)."""
    if req.target.startswith("http://") or req.target.startswith("https://"):
        rest = req.target.split("://", 1)[1]
        host = _strip_port(rest.split("/", 1)[0])
    else:
        host = ""
        for name, value in req.headers:
            if name.lower() == "host":
                host = _strip_port(value)
                break
    return host if len(host) <= HOSTNAME_MAX_LENGTH else ""


def declared_content_length(head: bytes) -> Optional[int]:
    """The head's Content-Length value, or None when absent/garbled.
    Only meaningful AFTER strict_head_violation passed (at most one CL,
    no folded lines)."""
    for line in head.split(b"\r\n")[1:]:
        if not line:
            break
        name, sep, value = line.partition(b":")
        if sep and name.lower() == b"content-length":
            try:
                return int(value.strip())
            except ValueError:
                return None
    return None


def extract_request_fields(req: Request) -> tuple[str, str]:
    """(host, user_agent) exactly as the serving path computes them.
    A differential fuzzer calls this so its oracle can never drift from
    the listener's own extraction."""
    host = get_host(req)
    user_agent = ""
    for name, value in req.headers:
        if name.lower() == "user-agent":
            user_agent = value.strip()
            break
    if len(user_agent) >= USER_AGENT_MAX_LENGTH:
        user_agent = ""  # heapless from_str overflow -> default empty
    return host, user_agent


def parse_request_bytes(data: bytes):
    """One-shot parse oracle: run DATA through exactly the gates and
    h11 parse the live listener applies, without sockets. Returns
    ("ok", Request), ("reject", "400"|"413"|"431"), or
    ("incomplete", None) when DATA ends before a full message."""
    m = _HEAD_END_RE.search(data)
    if m is None:
        return ("reject", "431") if len(data) > MAX_HEADER_BYTES \
            else ("incomplete", None)
    if m.end() > MAX_HEADER_BYTES:
        return ("reject", "431")
    if strict_head_violation(data[:m.end()]) is not None:
        return ("reject", "400")
    cl = declared_content_length(data[:m.end()])
    if cl is not None and cl > MAX_BODY_BYTES:
        return ("reject", "413")
    conn = h11.Connection(h11.SERVER,
                          max_incomplete_event_size=MAX_HEADER_BYTES)
    try:
        conn.receive_data(data)
        conn.receive_data(b"")  # EOF: flush a read-to-close body
        req_event = None
        body = bytearray()
        while True:
            event = conn.next_event()
            if event is h11.NEED_DATA or event is h11.PAUSED:
                return ("incomplete", None)
            if isinstance(event, h11.Request):
                req_event = event
            elif isinstance(event, h11.Data):
                body += event.data
                if len(body) > MAX_BODY_BYTES:
                    return ("reject", "413")
            elif isinstance(event, h11.EndOfMessage):
                break
            elif isinstance(event, h11.ConnectionClosed) or event is None:
                return ("incomplete", None)
    except h11.RemoteProtocolError:
        return ("reject", "400")
    target = req_event.target.decode("latin-1")
    headers = [(n.decode("latin-1"), v.decode("latin-1"))
               for n, v in req_event.headers]
    return ("ok", Request(method=req_event.method.decode("ascii"),
                          target=target, path=target.split("?", 1)[0],
                          headers=headers, body=bytes(body)))


def request_tuple_to_context(tup: RequestTuple, lists: dict) -> Context:
    """Interpreter context for route matching (engine/batch.py owns the
    shared construction)."""
    from ..engine.batch import tuple_to_context

    return tuple_to_context(tup, lists)


class HttpListener:
    """One HTTP(S) listener bound to an address, serving h11 connections."""

    def __init__(
        self,
        name: str,
        host: str,
        port: int,
        services: list,  # (service, is proxy/static objects with .route)
        verdict: VerdictService,
        lists: dict,
        rules_meta: list,  # plan.rules (kept for metrics/introspection)
        captcha: CaptchaManager,
        geoip: Optional[GeoipDB] = None,
        tls_context=None,
        acme_challenges: Optional[dict] = None,
        trust_xff: bool = False,
        xff_token: Optional[str] = None,
        route_indices: Optional[list] = None,
    ):
        self.name = name
        self.host = host
        self.port = port
        self.services = services
        self.verdict = verdict
        self.lists = lists
        self.rules_meta = rules_meta
        self.captcha = captcha
        self.geoip = geoip
        self.tls_context = tls_context
        self.acme_challenges = acme_challenges
        # When this listener runs as the control plane BEHIND the native
        # data plane (which injects x-forwarded-for), the captcha client
        # id must bind to the REAL client address, not the proxy's.
        # XFF is client-forgeable, so trust is TOKEN-BOUND when
        # xff_token is set: only requests carrying the native plane's
        # per-boot x-pingoo-internal token are trusted — any other
        # local process dialing the loopback port cannot spoof client
        # identity for captcha binding or IP rules. A bare
        # trust_xff=True (no token) trusts unconditionally; only for
        # closed test rigs. When xff_token is set it alone decides
        # (handle_request branches on it before consulting trust_xff).
        self.trust_xff = trust_xff
        self.xff_token = xff_token
        # Per-service columns of the batched verdict carrying the route
        # predicates (plan.route_index); None entries (or no list) fall
        # back to per-request interpretation of service.route.
        self.route_indices = route_indices
        self.stats = ListenerStats()
        self._server: Optional[asyncio.AbstractServer] = None
        # The access-log sampler emits trace-id-carrying structured
        # lines.
        self._access_log = AccessLogSampler(name)
        # Streaming body inspection: the listener buffers whole bodies,
        # but the scan still runs the SAME windowed chunk-carry engine
        # the native plane's sidecar uses (bodyscan.scan_buffered), on
        # the verdict service's device, so one payload yields one
        # verdict on both planes. Unlike the native plane, this covers
        # h2 streams too (their bodies buffer through the same Request).
        # A broken scanner fails open to metadata-only.
        self._registry = verdict.registry
        self._body_scanner = None
        if bodyscan.body_inspect_enabled():
            try:
                self._body_scanner = bodyscan.BodyScanner(
                    device=verdict.device)
                self._body_scanner.attach_metrics("python", self._registry)
            except Exception:
                log.exception("body scanner unavailable: metadata-only")
                self._body_scanner = None
                self.stats.body_fail_open += 1
        self._registry.register_collector(self._export_metrics)

    def _export_metrics(self) -> None:
        """Registry collector: the listener's counts under the shared
        metric names (obs/schema.SHARED_METRICS), as the JAX package's
        listener exports them, so the Prometheus text carries this
        listener beside the verdict service's instruments."""
        reg = self._registry
        lab = {"plane": "python", "listener": self.name}
        for name, value in (
                ("pingoo_requests_total", self.stats.requests),
                ("pingoo_blocked_total", self.stats.blocked),
                ("pingoo_captcha_total", self.stats.captcha_served),
                ("pingoo_fail_open_total", self.stats.fail_open)):
            reg.counter(name, obs_schema.SHARED_METRICS[name],
                        labels=lab).set_total(value)
        reg.counter(
            "pingoo_body_degrade_total",
            obs_schema.BODY_METRICS["pingoo_body_degrade_total"],
            labels={**lab, "reason": "ladder"},
        ).set_total(self.stats.body_fail_open)
        uptime = time.time() - self.stats.started_at
        reg.gauge("pingoo_uptime_seconds", "listener uptime",
                  labels=lab).set(round(uptime, 1))

    async def bind(self) -> None:
        # reuse_port: N processes can share the port for zero-downtime
        # upgrades (reference listeners/mod.rs:57-61 SO_REUSEPORT).
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port,
            ssl=self.tls_context, reuse_address=True, reuse_port=True,
            backlog=2048)

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._body_scanner is not None:
            self._body_scanner.detach_metrics()
        self._registry.unregister_collector(self._export_metrics)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection loop -----------------------------------------------------

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername") or ("0.0.0.0", 0)
        # HTTP/2 detection (reference hyper auto builder,
        # http_listener.rs:276-278): ALPN "h2" on TLS connections, the
        # 24-byte client preface on cleartext (prior knowledge).
        initial = b""
        ssl_obj = writer.get_extra_info("ssl_object")
        if ssl_obj is not None:
            if ssl_obj.selected_alpn_protocol() == "h2":
                await self._serve_h2(reader, writer, peer)
                return
        else:
            from .h2 import H2_PREFACE, available as h2_available

            if h2_available():
                while (len(initial) < len(H2_PREFACE)
                       and H2_PREFACE.startswith(initial)):
                    chunk = await reader.read(len(H2_PREFACE) - len(initial))
                    if not chunk:
                        break
                    initial += chunk
                if initial == H2_PREFACE:
                    await self._serve_h2(reader, writer, peer,
                                         initial=initial)
                    return
        conn = h11.Connection(h11.SERVER,
                              max_incomplete_event_size=MAX_HEADER_BYTES)
        if initial:
            conn.receive_data(initial)
        try:
            while True:
                raw = await self._gate_head(conn, reader)
                if raw is not None:
                    writer.write(raw)
                    await writer.drain()
                    break
                event = await self._next_event(conn, reader)
                if event is h11.PAUSED or isinstance(
                        event, (h11.ConnectionClosed, type(None))):
                    break
                if isinstance(event, h11.Request):
                    request = await self._read_request(conn, reader, event)
                    response = await self.handle_request(request, peer)
                    if response.tunnel is not None:
                        await self._pump_tunnel(conn, reader, writer,
                                                response.tunnel)
                        break  # raw bytes flowed: the h1 cycle is over
                    await self._send_response(conn, writer, request, response)
                    if conn.our_state is h11.MUST_CLOSE:
                        break
                    conn.start_next_cycle()
        except h11.RemoteProtocolError as exc:
            # Answer before closing (the native plane does too): 413
            # for the body cap, 400 for everything h11 refused — unless
            # a response already started, where injecting one would
            # corrupt the client's framing.
            try:
                if conn.our_state is h11.IDLE:
                    writer.write(_RAW_413 if "body too large" in str(exc)
                                 else _RAW_400)
                    await writer.drain()
            except (OSError, asyncio.IncompleteReadError):
                pass
        except (OSError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    async def _pump_tunnel(self, conn, reader, writer, tunnel) -> None:
        """Protocol upgrade (WebSocket): relay the upstream's response
        head verbatim, then splice raw bytes both directions until
        either side closes (reference http_listener.rs:277
        serve_connection_with_upgrades)."""
        up_reader, up_writer, head = tunnel
        try:
            writer.write(head)
            # Bytes the client sent after its upgrade request are
            # already buffered inside h11 — forward them first.
            trailing, _ = conn.trailing_data
            if trailing:
                up_writer.write(trailing)
            await writer.drain()
            await up_writer.drain()

            async def pump(src, dst):
                try:
                    while True:
                        data = await src.read(65536)
                        if not data:
                            break
                        dst.write(data)
                        await dst.drain()
                except (OSError, asyncio.IncompleteReadError):
                    pass
                finally:
                    try:
                        dst.write_eof()
                    except OSError:
                        pass

            await asyncio.gather(pump(reader, up_writer),
                                 pump(up_reader, writer))
        finally:
            try:
                up_writer.close()
            except OSError:
                pass

    async def _gate_head(self, conn, reader) -> Optional[bytes]:
        """Buffer the next request head RAW (h11 sees every byte too —
        this only mirrors, never consumes) and apply the strict gate
        plus the PINGOO_MAX_HEADER_BYTES cap before h11 parses it.
        Returns a raw response to send-and-close (431/400), or None
        when the head passed / the peer closed. h11's trailing_data
        seeds the scan so pipelined requests gate correctly."""
        scan = bytearray(conn.trailing_data[0])
        while _HEAD_END_RE.search(scan) is None:
            if len(scan) > MAX_HEADER_BYTES:
                return _RAW_431
            data = await reader.read(65536)
            if not data:
                return None  # EOF: the event loop settles the state
            conn.receive_data(data)
            scan += data
        end = _HEAD_END_RE.search(scan).end()
        if end > MAX_HEADER_BYTES:
            return _RAW_431
        head = bytes(scan[:end])
        if strict_head_violation(head) is not None:
            return _RAW_400
        cl = declared_content_length(head)
        if cl is not None and cl > MAX_BODY_BYTES:
            return _RAW_413  # eager, like the native plane: never buffer
        return None

    async def _next_event(self, conn, reader):
        while True:
            event = conn.next_event()
            if event is h11.NEED_DATA:
                data = await reader.read(65536)
                conn.receive_data(data)
                if data == b"" and conn.their_state is h11.IDLE:
                    return None
                continue
            return event

    async def _read_request(self, conn, reader, event: h11.Request) -> Request:
        body = bytearray()
        while True:
            ev = await self._next_event(conn, reader)
            if isinstance(ev, h11.Data):
                body += ev.data
                if len(body) > MAX_BODY_BYTES:
                    raise h11.RemoteProtocolError("body too large")
            elif isinstance(ev, h11.EndOfMessage) or ev is None:
                break
        target = event.target.decode("latin-1")
        path = target.split("?", 1)[0]
        headers = [(n.decode("latin-1"), v.decode("latin-1"))
                   for n, v in event.headers]
        return Request(method=event.method.decode("ascii"), target=target,
                       path=path, headers=headers, body=bytes(body))

    async def _send_response(self, conn, writer, request: Request,
                             response: Response) -> None:
        headers = [(k, v) for k, v in response.headers]
        if response.stream_path is not None and request.method != "HEAD":
            # Large static files stream in chunks — never slurped
            # (http_static_site_service.rs:238-256 ReaderStream parity).
            size = os.path.getsize(response.stream_path)
            headers.append(("content-length", str(size)))
            writer.write(conn.send(h11.Response(
                status_code=response.status,
                headers=[(k.encode(), v.encode()) for k, v in headers])))
            with open(response.stream_path, "rb") as f:
                while True:
                    chunk = f.read(65536)
                    if not chunk:
                        break
                    writer.write(conn.send(h11.Data(data=chunk)))
                    await writer.drain()
            writer.write(conn.send(h11.EndOfMessage()))
            await writer.drain()
            return
        if response.stream_path is not None:  # HEAD on a streamed file
            body = b""
            headers.append(
                ("content-length", str(os.path.getsize(response.stream_path))))
        else:
            body = b"" if request.method == "HEAD" else response.body
            headers.append(("content-length", str(len(response.body))))
        writer.write(conn.send(h11.Response(
            status_code=response.status,
            headers=[(k.encode(), v.encode()) for k, v in headers])))
        if body:
            writer.write(conn.send(h11.Data(data=body)))
        writer.write(conn.send(h11.EndOfMessage()))
        await writer.drain()

    # -- HTTP/2 connection loop ---------------------------------------------

    async def _serve_h2(self, reader, writer, peer, initial=b"") -> None:
        """Serve one h2 connection: every stream's request runs through
        the SAME handle_request hot path as h1 (the reference's hyper
        auto builder likewise multiplexes into one service_fn). Streams
        are handled CONCURRENTLY — one slow upstream must not stall the
        other multiplexed streams or frame processing — with writes
        serialized through a lock."""
        from .h2 import H2ServerSession

        write_lock = asyncio.Lock()
        tasks: set = set()

        async def flush():
            out = session.pull()
            if out:
                async with write_lock:
                    writer.write(out)
                    await writer.drain()

        async def handle_stream(sid, hdrs, body):
            req = self._h2_to_request(hdrs, body)
            if req is None:
                session.submit_response(sid, 400,
                                        [("content-type", "text/plain")],
                                        b"Bad Request")
                await flush()
                return
            response = await self.handle_request(req, peer)
            body_out = response.body
            content_length = None
            if response.stream_path is not None:
                if req.method == "HEAD":
                    # Advertise the real entity size without reading it.
                    body_out = b""
                    content_length = os.path.getsize(response.stream_path)
                else:
                    # h2 responses are submitted whole; large static
                    # files load here (streamed DATA frames are a
                    # future refinement).
                    with open(response.stream_path, "rb") as f:
                        body_out = f.read()
            elif req.method == "HEAD":
                content_length = len(response.body)
                body_out = b""
            session.submit_response(sid, response.status, response.headers,
                                    body_out, content_length=content_length)
            await flush()

        def on_request(sid, hdrs, body):
            task = asyncio.ensure_future(handle_stream(sid, hdrs, body))
            tasks.add(task)
            task.add_done_callback(tasks.discard)

        session = H2ServerSession(on_request)
        try:
            if initial and not session.feed(initial):
                return
            while True:
                await flush()
                data = await reader.read(65536)
                if not data or not session.feed(data):
                    break
        except (OSError, asyncio.IncompleteReadError):
            pass
        finally:
            for task in list(tasks):
                task.cancel()
            try:
                await flush()
            except OSError:
                pass
            session.close()
            try:
                writer.close()
            except OSError:
                pass

    @staticmethod
    def _h2_to_request(hdrs: list, body: bytes) -> Optional[Request]:
        """h2 pseudo-headers -> the Request shape the h1 path uses; the
        :authority travels as a host header (get_host reads it like
        hyper's uri.host for h2, http_listener.rs:284-289)."""
        pseudo = {k: v for k, v in hdrs if k.startswith(b":")}
        method = pseudo.get(b":method")
        path = pseudo.get(b":path")
        if not method or not path:
            return None
        headers = [(k.decode("latin-1"), v.decode("latin-1"))
                   for k, v in hdrs if not k.startswith(b":")]
        authority = pseudo.get(b":authority")
        if authority:
            headers.insert(0, ("host", authority.decode("latin-1")))
        target = path.decode("latin-1")
        return Request(method=method.decode("latin-1"), target=target,
                       path=target.split("?", 1)[0], headers=headers,
                       body=body)

    # -- the hot path --------------------------------------------------------

    async def handle_request(self, req: Request, peer) -> Response:
        """Trace-instrumented entry: every request gets a trace id that
        propagates into the verdict batch (RequestTuple.trace_id),
        returns in the x-pingoo-trace-id response header, and lands in
        the sampled structured access log."""
        t0 = time.monotonic()
        trace_id = new_trace_id()
        response = await self._handle_request(req, peer, trace_id)
        response.headers = list(response.headers) + [
            (TRACE_HEADER, trace_id)]
        self._access_log.maybe_log(
            trace_id=trace_id, method=req.method, path=req.path,
            status=response.status, client_ip=str(peer[0]),
            duration_ms=(time.monotonic() - t0) * 1e3)
        return response

    async def _handle_request(self, req: Request, peer,
                              trace_id: str = "") -> Response:
        self.stats.requests += 1
        client_ip, client_port = str(peer[0]), int(peer[1])
        trusted = self.trust_xff
        token = None
        for name, value in req.headers:
            if name.lower() == "x-pingoo-internal":
                token = value
                break
        if self.xff_token is not None:
            import hmac as _hmac

            # bytes compare: compare_digest raises TypeError on
            # non-ASCII str input, and the header is attacker-supplied.
            trusted = token is not None and _hmac.compare_digest(
                token.encode("latin-1", "replace"),
                self.xff_token.encode("latin-1", "replace"))
        if token is not None:
            # The token header never travels further (rules context,
            # upstream hops): strip it regardless of validity. Skipped
            # entirely on the common no-token request.
            req.headers = [(n, v) for n, v in req.headers
                           if n.lower() != "x-pingoo-internal"]
        if trusted:
            for name, value in req.headers:
                if name.lower() == "x-forwarded-for":
                    first = value.split(",")[0].strip()
                    if first:
                        client_ip = first
                    break
        host, user_agent = extract_request_fields(req)

        geoip_record = GeoipRecord()
        if self.geoip is not None:
            try:
                geoip_record = self.geoip.lookup(client_ip)
            except (AddressNotFound, ValueError):
                pass

        client_id = generate_captcha_client_id(client_ip, user_agent, host)
        cookies = parse_cookies(req.headers)

        request_ctx = RequestContext(
            client_ip=client_ip, client_port=client_port,
            asn=geoip_record.asn, country=geoip_record.country,
            geoip_enabled=self.geoip is not None,
            tls=self.tls_context is not None, host=host)

        # Empty/oversized UA -> 403 (:196-198).
        if not user_agent:
            self.stats.blocked += 1
            return blocked_response()

        # ACME http-01 (host/acme.py; the reference answers challenges at
        # TLS-accept time instead, listeners/mod.rs:130-141).
        if self.acme_challenges is not None and req.path.startswith(
                "/.well-known/acme-challenge/"):
            token = req.path.rsplit("/", 1)[-1]
            keyauth = self.acme_challenges.get(token)
            if keyauth:
                return Response(200, [("content-type", "text/plain")],
                                keyauth.encode())
            return not_found_response()

        if req.path.startswith(CAPTCHA_PATH_PREFIX):
            status, headers, body = self.captcha.serve(
                req.method, req.path, req.body, cookies, client_id)
            return Response(status, headers, body)

        if req.path == "/__pingoo/metrics":
            return self._metrics_response(req)

        if req.path == "/__pingoo/profile":
            return await self._profile_response(req)

        if req.path == "/__pingoo/compileledger":
            return self._compileledger_response()

        if req.path in ("/__pingoo/flightrecorder", "/__pingoo/timeline"):
            return not_ported_response(req.path)

        if req.path == "/__pingoo/explain":
            return await self._explain_response(req, request_ctx)

        # Captcha-verified cookie: invalid -> challenge page (:222-236).
        captcha_verified = False
        verified_cookie = cookies.get(CAPTCHA_VERIFIED_COOKIE)
        if verified_cookie is not None:
            if self.captcha.is_verified(verified_cookie, client_id):
                captcha_verified = True
            else:
                return self._serve_captcha()

        tup = RequestTuple(
            host=host, url=req.target, path=req.path, method=req.method,
            user_agent=user_agent, ip=client_ip, remote_port=client_port,
            asn=geoip_record.asn, country=geoip_record.country,
            trace_id=trace_id)

        # RULES LOOP (:251-264): the engine's action lanes reproduce the
        # reference loop for both captcha states (engine/verdict.py
        # action_lanes — verified clients skip Captcha actions but still
        # block on any matched Block).
        try:
            verdict = await self.verdict.evaluate(tup)
        except Exception:
            # No degraded verdict to serve in its place (ROADMAP.md item
            # 9): the request is refused, never allowed.
            self.stats.engine_errors += 1
            log.exception("verdict failed", extra={"fields": {
                "trace_id": trace_id}})
            return unavailable_response()
        if verdict.degraded:
            self.stats.fail_open += 1
        action = verdict.action_for(captcha_verified)
        # Body-verdict merge: skipped when metadata alone
        # already decides — the native plane aborts inspection on the
        # same condition, so both planes scan the same set of requests.
        if (action == 0 and req.body and not verdict.degraded
                and self._body_scanner is not None):
            bv = self._scan_body(req.body)
            if bv is not None and not bv.degraded:
                meta_byte = ((verdict.action & 0x3)
                             | (0x4 if verdict.verified_block else 0))
                merged = bodyscan.merge_actions(
                    meta_byte, bv.unverified, bv.verified_block)
                verdict.action = merged & 0x3
                verdict.verified_block = bool(merged & 0x4)
                action = verdict.action_for(captcha_verified)
        if action == 1:
            self.stats.blocked += 1
            return blocked_response()
        if action == 2:
            return self._serve_captcha()

        # ROUTING LOOP (:266-270): route predicates ride the SAME
        # batched verdict as the rules (plan route pseudo-columns) —
        # no per-request tree-walk on the hot path. Services without a
        # compiled column interpret their route inline (same semantics).
        route_ctx = None
        for j, service in enumerate(self.services):
            idx = (self.route_indices[j]
                   if self.route_indices and j < len(self.route_indices)
                   else None)
            if idx is not None and not verdict.degraded:
                routed = bool(verdict.matched[idx])
            else:
                # No compiled column, or the engine failed and matched
                # is a fail-open placeholder: interpret the route so a
                # broken engine degrades to slow routing, not to 404s.
                if route_ctx is None:
                    route_ctx = request_tuple_to_context(tup, self.lists)
                routed = match_route(service.route, route_ctx)
            if routed:
                return await service.handle(req, request_ctx)
        return not_found_response()

    def _scan_body(self, payload: bytes):
        """Run the buffered body through the windowed chunk-carry scan;
        None (metadata-only, counted) on any scanner fault — inspection
        fails open, never closed."""
        try:
            return self._body_scanner.scan_buffered(payload)
        except Exception:
            self.stats.body_fail_open += 1
            log.exception("body scan failed: metadata-only verdict")
            self._body_scanner.flows.clear()  # no half-scanned carry
            return None

    def _serve_captcha(self) -> Response:
        from .captcha import CAPTCHA_PAGE

        self.stats.captcha_served += 1
        return Response(403, [("content-type", "text/html; charset=utf-8"),
                              ("server", "pingoo")], CAPTCHA_PAGE.encode())

    @staticmethod
    def _accepts_json(req: Request) -> bool:
        for name, value in req.headers:
            if name.lower() == "accept":
                return "application/json" in value.lower()
        return False

    def _compileledger_response(self) -> Response:
        """The process's compile ledger (obs/perf.py): every nvcc build
        and graph capture it paid, with its fn, kind, shape and wall."""
        from ..obs.perf import get_compile_ledger

        return Response(200, [("content-type", "application/json")],
                        json.dumps(get_compile_ledger().snapshot()).encode())

    def _metrics_response(self, req: Request) -> Response:
        """Content-negotiated exposition: the registry's Prometheus text
        by default (what a scraper or a plain curl sees), the JSON
        payload under Accept: application/json."""
        if not self._accepts_json(req):
            return Response(
                200,
                [("content-type",
                  "text/plain; version=0.0.4; charset=utf-8")],
                self._registry.prometheus_text().encode())
        uptime = time.time() - self.stats.started_at
        payload = {
            "listener": self.name,
            "uptime_s": round(uptime, 1),
            "requests": self.stats.requests,
            "blocked": self.stats.blocked,
            "captcha_served": self.stats.captcha_served,
            "fail_open": self.stats.fail_open,
            "engine_errors": self.stats.engine_errors,
            "body_fail_open": self.stats.body_fail_open,
            "req_per_s": round(self.stats.requests / uptime, 2) if uptime else 0,
            "verdict": self.verdict.stats.snapshot(),
            "pipeline": self.verdict.pipeline_snapshot(),
        }
        return Response(200, [("content-type", "application/json")],
                        json.dumps(payload).encode())

    async def _explain_response(self, req: Request,
                                request_ctx: RequestContext) -> Response:
        """GET /__pingoo/explain?path=/x[&method=&host=&url=&ua=&ip=
        &asn=&country=&port=]: re-run one synthetic request through the
        REAL batched verdict path and the interpreter oracle, returning
        per-rule / per-stage provenance JSON (VerdictService.explain).
        Unspecified client fields default to the CALLING request's
        (ip/asn/country), so `curl .../__pingoo/explain?path=/probe`
        explains that path for the caller's own network identity."""
        from urllib.parse import parse_qs, unquote

        query = parse_qs(req.target.partition("?")[2],
                         keep_blank_values=True)

        def q(name, default=""):
            vals = query.get(name)
            return unquote(vals[0]) if vals else default

        path = q("path", "/")
        try:
            asn = int(q("asn", str(request_ctx.asn)) or 0)
            port = int(q("port", str(request_ctx.client_port)) or 0)
        except ValueError:
            return Response(400, [("content-type", "application/json")],
                            b'{"error": "asn/port must be integers"}')
        tup = RequestTuple(
            host=q("host", request_ctx.host),
            url=q("url", path),
            path=path,
            method=q("method", "GET") or "GET",
            user_agent=q("ua", q("user_agent", "pingoo-explain")),
            ip=q("ip", request_ctx.client_ip),
            remote_port=port,
            asn=asn,
            country=q("country", request_ctx.country),
            trace_id=new_trace_id())
        payload = await self.verdict.explain(tup)
        return Response(200, [("content-type", "application/json")],
                        json.dumps(payload).encode())

    async def _profile_response(self, req: Request) -> Response:
        """On-demand bounded torch.profiler window:
        GET /__pingoo/profile?seconds=N (default 3, cap 30). 409 when a
        capture (or the boot-time PINGOO_PROFILE_DIR trace) is live."""
        seconds = 3.0
        query = req.target.partition("?")[2]
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "seconds":
                try:
                    seconds = float(v)
                except ValueError:
                    pass
        result = await self.verdict.capture_profile(seconds)
        if "error" in result:
            status = 409 if "already active" in result["error"] else 503
        else:
            status = 200
        return Response(status, [("content-type", "application/json")],
                        json.dumps(result).encode())
