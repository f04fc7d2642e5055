"""The port's HTTP/2 binding (`pingoo_tpu_torch.host.h2`, ctypes over the
system libnghttp2) on every case of test_h2.py.

The JAX package's cases serve through its listener (host/httpd.py),
which the port has not yet (port queue item 1b-ii). Here the same
traffic goes through `Front`, the least listener the cases need, built
from the port's own modules: the h2 sessions (prior knowledge and TLS
ALPN from the port's TlsManager), the port's VerdictService on the CPU,
and the port's HttpProxyService over an h1 or h2 upstream. The front
answers a request the verdict blocks with 403 and proxies the rest; it
has none of the listener's own checks. So the reference's empty-UA case
(a 403 decided in httpd.py) waits for item 1b-ii: here it checks only
that the port's h2 session hands such a request over with no user agent.
"""

import asyncio
import ssl
from types import SimpleNamespace

import pytest
import torch

from pingoo_tpu_torch.host import h2 as h2mod

pytestmark = pytest.mark.skipif(not h2mod.available(),
                                reason="libnghttp2 unavailable")

torch.set_num_threads(1)


class TestBinding:
    def test_in_memory_round_trip(self):
        reqs, resps = [], []
        server = h2mod.H2ServerSession(
            lambda sid, hdrs, body: reqs.append((sid, hdrs, body)))
        client = h2mod.H2ClientSession(
            lambda sid, hdrs, body, err: resps.append((sid, hdrs, body, err)))
        s1 = client.submit_request("GET", "http", "t.test", "/a?x=1",
                                   [("user-agent", "ua")])
        s2 = client.submit_request("POST", "http", "t.test", "/b",
                                   [("user-agent", "ua")], body=b"body-2")
        answered = set()
        for _ in range(8):
            out = client.pull()
            if out:
                assert server.feed(out)
            for sid, hdrs, body in reqs:
                if sid not in answered:
                    answered.add(sid)
                    server.submit_response(
                        sid, 200, [("x-echo", "1")],
                        b"resp:" + bytes(body) + dict(hdrs)[b":path"])
            back = server.pull()
            if back:
                assert client.feed(back)
            if len(resps) == 2:
                break
        by_sid = {s: (dict(h), bytes(b), e) for s, h, b, e in resps}
        assert by_sid[s1][0][b":status"] == b"200"
        assert by_sid[s1][1] == b"resp:/a?x=1"
        assert by_sid[s2][1] == b"resp:body-2/b"
        assert all(e == 0 for _, _, e in by_sid.values())


class Front:
    """h1 and h2 connections -> the port's verdict -> the port's proxy."""

    def __init__(self, proxy, verdict, tls_context=None):
        self.proxy = proxy
        self.verdict = verdict
        self.tls_context = tls_context
        self.bound_port = None
        self.seen = []  # (target, headers) of every request handled

    async def bind(self):
        server = await asyncio.start_server(
            self.serve, "127.0.0.1", 0, ssl=self.tls_context)
        self.bound_port = server.sockets[0].getsockname()[1]

    async def handle(self, method, target, headers, body):
        from pingoo_tpu_torch.engine.batch import RequestTuple
        from pingoo_tpu_torch.host.services import Response

        self.seen.append((target, list(headers)))
        named = {k.lower(): v for k, v in headers}
        host = named.get("host", "").rsplit(":", 1)[0]
        path = target.split("?", 1)[0]
        verdict = await self.verdict.evaluate(RequestTuple(
            host=host, url=target, path=path, method=method,
            user_agent=named.get("user-agent", "").strip(), ip="127.0.0.1"))
        if verdict.block:
            return Response(403, [("content-type", "text/plain")],
                            b"Forbidden")
        req = SimpleNamespace(method=method, target=target, path=path,
                              headers=list(headers), body=body)
        ctx = SimpleNamespace(host=host, tls=self.tls_context is not None,
                              client_ip="127.0.0.1", geoip_enabled=False,
                              country="XX", asn=0)
        return await self.proxy.handle(req, ctx)

    async def serve(self, reader, writer):
        ssl_obj = writer.get_extra_info("ssl_object")
        if ssl_obj is not None and ssl_obj.selected_alpn_protocol() == "h2":
            return await self.serve_h2(reader, writer, b"")
        initial = b""
        while (len(initial) < len(h2mod.H2_PREFACE)
               and h2mod.H2_PREFACE.startswith(initial)):
            chunk = await reader.read(len(h2mod.H2_PREFACE) - len(initial))
            if not chunk:
                break
            initial += chunk
        if initial == h2mod.H2_PREFACE:
            return await self.serve_h2(reader, writer, initial)
        head = initial + await reader.readuntil(b"\r\n\r\n") \
            if b"\r\n\r\n" not in initial else initial
        lines = head.decode("latin-1").split("\r\n")
        method, target, _ = lines[0].split(" ", 2)
        headers = [tuple(s.strip() for s in line.split(":", 1))
                   for line in lines[1:] if ":" in line]
        resp = await self.handle(method, target, headers, b"")
        out = [f"HTTP/1.1 {resp.status} X",
               f"content-length: {len(resp.body)}", "connection: close"]
        out += [f"{k}: {v}" for k, v in resp.headers
                if k.lower() not in ("content-length", "connection")]
        writer.write(("\r\n".join(out) + "\r\n\r\n").encode("latin-1")
                     + resp.body)
        await writer.drain()
        writer.close()

    async def serve_h2(self, reader, writer, initial):
        lock = asyncio.Lock()

        async def flush():
            out = session.pull()
            if out:
                async with lock:
                    writer.write(out)
                    await writer.drain()

        async def stream(sid, hdrs, body):
            pseudo = {k.decode("latin-1"): v.decode("latin-1")
                      for k, v in hdrs if k.startswith(b":")}
            headers = [(k.decode("latin-1"), v.decode("latin-1"))
                       for k, v in hdrs if not k.startswith(b":")]
            headers.insert(0, ("host", pseudo.get(":authority", "")))
            resp = await self.handle(pseudo[":method"], pseudo[":path"],
                                     headers, bytes(body))
            session.submit_response(sid, resp.status, resp.headers,
                                    resp.body)
            await flush()

        tasks = set()

        def on_request(sid, hdrs, body):
            task = asyncio.ensure_future(stream(sid, hdrs, body))
            tasks.add(task)
            task.add_done_callback(tasks.discard)

        session = h2mod.H2ServerSession(on_request)
        try:
            if initial and not session.feed(initial):
                return
            while True:
                await flush()
                data = await reader.read(65536)
                if not data or not session.feed(data):
                    break
        except OSError:
            pass
        finally:
            for task in list(tasks):
                task.cancel()
            session.close()
            writer.close()


def _mk_listener(tmp_path, loop_runner, tls_context=None, upstream_h2=False):
    """Front + the port's verdict service + (h1 or h2) upstream."""
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config.schema import (
        Action,
        RuleConfig,
        ServiceConfig,
        Upstream,
    )
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.expr import compile_expression
    from pingoo_tpu_torch.host.services import HttpProxyService

    async def boot():
        if upstream_h2:
            up_port = await _start_h2_upstream()
        else:
            async def handle(reader, writer):
                data = await reader.read(8192)
                first = data.split(b"\r\n", 1)[0]
                body = b"up:" + first
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: " +
                             str(len(body)).encode() + b"\r\n\r\n" + body)
                await writer.drain()
                writer.close()

            up = await asyncio.start_server(handle, "127.0.0.1", 0)
            up_port = up.sockets[0].getsockname()[1]

        rules = [RuleConfig(
            name="waf", actions=(Action.BLOCK,),
            expression=compile_expression(
                'http_request.url.contains("evil")'))]
        plan = compile_ruleset(rules, {}, routes=[("app", None)],
                               device="cpu")

        class Reg:
            def get_upstreams(self, name):
                return [Upstream(hostname="127.0.0.1", port=up_port,
                                 tls=False, ip="127.0.0.1",
                                 h2=upstream_h2)]

        svc = HttpProxyService(
            ServiceConfig(name="app", route=None,
                          http_proxy=(Upstream(hostname="127.0.0.1",
                                               port=up_port, tls=False,
                                               ip="127.0.0.1",
                                               h2=upstream_h2),)),
            Reg())
        verdict = VerdictService(plan, {}, max_wait_us=100, device="cpu")
        front = Front(svc, verdict, tls_context=tls_context)
        await verdict.start()
        await front.bind()
        return front

    return loop_runner.run(boot())


async def _start_h2_upstream() -> int:
    """h2 prior-knowledge upstream echoing :path (built on the port's
    own server session — the binding under test serves both sides)."""

    async def serve(reader, writer):
        pending = []
        session = h2mod.H2ServerSession(
            lambda sid, hdrs, body: pending.append((sid, hdrs, body)))
        try:
            while True:
                out = session.pull()
                if out:
                    writer.write(out)
                    await writer.drain()
                while pending:
                    sid, hdrs, body = pending.pop(0)
                    path = dict(hdrs).get(b":path", b"?")
                    session.submit_response(
                        sid, 200, [("x-proto", "h2-upstream")],
                        b"h2up:" + path + b":" + bytes(body))
                    out = session.pull()
                    if out:
                        writer.write(out)
                        await writer.drain()
                data = await reader.read(65536)
                if not data or not session.feed(data):
                    break
        except OSError:
            pass
        finally:
            session.close()
            writer.close()

    server = await asyncio.start_server(serve, "127.0.0.1", 0)
    return server.sockets[0].getsockname()[1]


async def _h2_get(port, path, ssl_ctx=None, server_hostname=None, body=b"",
                  method="GET"):
    conn = h2mod.H2UpstreamConnection("127.0.0.1", port)
    await conn.connect(ssl=ssl_ctx, server_hostname=server_hostname)
    try:
        return await asyncio.wait_for(
            conn.request(method, "t.test", path,
                         [("user-agent", "h2-test-ua")], body), 10)
    finally:
        await conn.close()


class TestH2Listener:
    def test_prior_knowledge_waf_path(self, tmp_path, loop_runner):
        lst = _mk_listener(tmp_path, loop_runner)

        async def flow():
            ok = await _h2_get(lst.bound_port, "/hello")
            blocked = await _h2_get(lst.bound_port, "/x?q=evil")
            return ok, blocked

        ok, blocked = loop_runner.run(flow())
        assert ok[0] == 200 and b"up:GET /hello" in ok[2]
        assert blocked[0] == 403

    def test_multiplexed_streams_one_connection(self, tmp_path, loop_runner):
        lst = _mk_listener(tmp_path, loop_runner)

        async def flow():
            conn = h2mod.H2UpstreamConnection("127.0.0.1", lst.bound_port)
            await conn.connect()
            try:
                results = await asyncio.gather(
                    conn.request("GET", "t.test", "/a",
                                 [("user-agent", "ua")]),
                    conn.request("GET", "t.test", "/b?x=evil",
                                 [("user-agent", "ua")]),
                    conn.request("GET", "t.test", "/c",
                                 [("user-agent", "ua")]),
                )
            finally:
                await conn.close()
            return results

        a, b, c = loop_runner.run(flow())
        assert a[0] == 200 and b"/a" in a[2]
        assert b[0] == 403
        assert c[0] == 200 and b"/c" in c[2]

    def test_h1_still_works_alongside(self, tmp_path, loop_runner):
        lst = _mk_listener(tmp_path, loop_runner)

        async def flow():
            r, w = await asyncio.open_connection("127.0.0.1", lst.bound_port)
            w.write(b"GET /h1 HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                    b"connection: close\r\n\r\n")
            data = await r.read()
            w.close()
            return data

        data = loop_runner.run(flow())
        assert data.startswith(b"HTTP/1.1 200") and b"up:GET /h1" in data

    def test_empty_ua_reaches_the_front_without_user_agent_over_h2(
            self, tmp_path, loop_runner):
        """The reference answers this request 403 in httpd.py (item
        1b-ii); the port's h2 session delivers it with no user agent."""
        lst = _mk_listener(tmp_path, loop_runner)

        async def flow():
            conn = h2mod.H2UpstreamConnection("127.0.0.1", lst.bound_port)
            await conn.connect()
            try:
                return await asyncio.wait_for(
                    conn.request("GET", "t.test", "/", []), 10)
            finally:
                await conn.close()

        status, _, body = loop_runner.run(flow())
        assert status == 200 and b"up:GET / " in body
        [(target, headers)] = lst.seen
        assert target == "/"
        assert [k for k, _ in headers] == ["host"]
        assert dict(headers)["host"] == "t.test"


class TestH2OverTls:
    def test_alpn_h2_negotiated_and_served(self, tmp_path, loop_runner):
        from pingoo_tpu_torch.host.tlsmgr import TlsManager

        mgr = TlsManager(str(tmp_path / "tls"))
        lst = _mk_listener(tmp_path, loop_runner,
                           tls_context=mgr.server_context())
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        ctx.set_alpn_protocols(["h2"])

        async def flow():
            return await _h2_get(lst.bound_port, "/tls-h2", ssl_ctx=ctx,
                                 server_hostname="t.test")

        status, headers, body = loop_runner.run(flow())
        assert status == 200 and b"up:GET /tls-h2" in body


class TestH2Upstream:
    def test_proxy_over_h2_prior_knowledge(self, tmp_path, loop_runner):
        """h1 client -> front -> h2 upstream (the port's proxy speaks h2)."""
        lst = _mk_listener(tmp_path, loop_runner, upstream_h2=True)

        async def flow():
            r, w = await asyncio.open_connection("127.0.0.1", lst.bound_port)
            w.write(b"GET /via-h2?a=1 HTTP/1.1\r\nhost: t\r\n"
                    b"user-agent: ua\r\nconnection: close\r\n\r\n")
            data = await r.read()
            w.close()
            return data

        data = loop_runner.run(flow())
        assert data.startswith(b"HTTP/1.1 200")
        assert b"h2up:/via-h2?a=1" in data
        assert b"x-proto: h2-upstream" in data.lower()

    def test_h2_end_to_end_both_sides(self, tmp_path, loop_runner):
        """h2 client -> front -> h2 upstream: h2 on BOTH hops."""
        lst = _mk_listener(tmp_path, loop_runner, upstream_h2=True)

        async def flow():
            return await _h2_get(lst.bound_port, "/both?x=2")

        status, headers, body = loop_runner.run(flow())
        assert status == 200 and b"h2up:/both?x=2" in body
