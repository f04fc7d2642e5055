"""The port's Python listener plane on the CPU: `host/httpd.py`,
`host/server.py` and `python -m pingoo_tpu_torch`.

  * Every case of test_host_integration.py, under the same names, against
    the port's `Server(device="cpu")` with the same config and the same
    pong upstream, and its `HttpListener` for the XFF-token cases. The
    port's own decisions: the metrics route serves Prometheus text that
    lints clean, and its JSON payload under `Accept: application/json`;
    /__pingoo/compileledger dumps the compile ledger with the JAX
    package's keys; the flight recorder and timeline routes answer 501
    (ROADMAP item 10, slice 3); /__pingoo/profile opens a
    torch.profiler window.
  * Cross-package parity: the same raw requests to the JAX package's
    `Server(use_device=True)` (its CPU backend, as its own test runs it)
    and to the port's `Server(device="cpu")`, on one config and one
    upstream: equal status, body and headers (but the trace id).
  * The entry point: `python -m pingoo_tpu_torch --no-device` answers
    403, the challenge and 200 and exits 0 on SIGTERM; without a card
    and without --no-device, it and `Server` raise; unported options
    raise naming their ROADMAP item.

Coroutines run on the shared background loop (conftest.LoopRunner).
"""

import asyncio
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from pingoo_tpu_torch.config import load_and_validate
from pingoo_tpu_torch.host.server import Server
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
UA = "Mozilla/5.0 (integration-test)"
XFF_TOKEN = "parity-token"


async def start_pong(host="127.0.0.1"):
    """Reference pong/pong.rs: a hello-world HTTP upstream."""

    async def handle(reader, writer):
        data = await reader.read(8192)
        first_line = data.split(b"\r\n", 1)[0].decode()
        headers = data.split(b"\r\n\r\n")[0].decode().lower()
        if "upgrade: websocket" in headers:
            # Accept the upgrade and echo raw bytes (the tunnel path).
            writer.write(b"HTTP/1.1 101 Switching Protocols\r\n"
                         b"upgrade: websocket\r\nconnection: Upgrade\r\n"
                         b"sec-websocket-accept: test\r\n\r\n")
            await writer.drain()
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    break
                writer.write(chunk)
                await writer.drain()
            writer.close()
            return
        body = (f"pong: {first_line}\n"
                f"xff: {'x-forwarded-for' in headers}\n").encode()
        writer.write(
            b"HTTP/1.1 200 OK\r\ncontent-type: text/plain\r\n"
            b"content-length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        await writer.drain()
        writer.close()

    server = await asyncio.start_server(handle, host, 0)
    return server, server.sockets[0].getsockname()[1]


async def http_get(port, path, headers=None, method="GET", body=b"",
                   host="127.0.0.1"):
    reader, writer = await asyncio.open_connection(host, port)
    hdrs = {"host": "test.local", "user-agent": UA, "connection": "close"}
    hdrs.update(headers or {})
    lines = [f"{method} {path} HTTP/1.1"]
    lines += [f"{k}: {v}" for k, v in hdrs.items() if v is not None]
    if body:
        lines.append(f"content-length: {len(body)}")
    payload = ("\r\n".join(lines) + "\r\n\r\n").encode() + body
    writer.write(payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, resp_body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    header_map = {}
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.decode("latin-1").partition(":")
        header_map.setdefault(k.strip().lower(), v.strip())
    return status, header_map, resp_body


RULES = """
  basic_waf:
    expression: http_request.path.starts_with("/.env") || http_request.path.starts_with("/.git")
    actions: [{action: block}]
  sqli:
    expression: http_request.url.matches("(?i)union(%20|\\\\+|\\\\s)+select")
    actions: [{action: block}]
  bot_gate:
    expression: http_request.user_agent.contains("sqlmap")
    actions: [{action: captcha}]
"""

LIST_RULE = """
  listed:
    expression: lists["blocked_ips"].contains(client.ip)
    actions: [{action: block}]
"""


def write_config(tmp_path, pong_port, rules=RULES, address="127.0.0.1:0"):
    www = tmp_path / "www"
    www.mkdir(exist_ok=True)
    (www / "index.html").write_text("<h1>welcome</h1>")
    (www / "about.html").write_text("<h1>about</h1>")
    (tmp_path / "blocked_ips.csv").write_text("192.0.2.0/24,test range\n")
    cfg = tmp_path / "pingoo.yml"
    cfg.write_text(textwrap.dedent(f"""
        listeners:
          http:
            address: http://{address}
        services:
          api:
            route: http_request.path.starts_with("/api")
            http_proxy:
              - http://127.0.0.1:{pong_port}
          site:
            static:
              root: {tmp_path}/www
        lists:
          blocked_ips:
            type: Ip
            file: {tmp_path}/blocked_ips.csv
        rules:
    """) + textwrap.indent(textwrap.dedent(rules).strip("\n"), "  ") + "\n")
    return cfg


def server_kwargs(tmp_path):
    return dict(geoip_paths=(str(tmp_path / "missing.mmdb"),),
                captcha_jwks_path=str(tmp_path / "captcha_jwks.json"),
                tls_dir=str(tmp_path / "tls"), enable_docker=False)


@pytest.fixture(scope="module")
def env(loop_runner, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("host_e2e")

    async def setup():
        pong, pong_port = await start_pong()
        config = load_and_validate(str(write_config(tmp_path, pong_port)))
        server = Server(config, device="cpu", **server_kwargs(tmp_path))
        await server.start()
        port = server.http_listeners[0].bound_port
        task = asyncio.create_task(server.serve_forever())
        return pong, server, port, task

    pong, server, port, task = loop_runner.run(setup())

    class Env:
        pass

    e = Env()
    e.port = port
    e.server = server
    e.run = loop_runner.run
    yield e

    async def teardown():
        task.cancel()
        await server.stop()
        pong.close()

    loop_runner.run(teardown())


class TestEndToEnd:
    def test_static_site(self, env):
        status, headers, body = env.run(http_get(env.port, "/"))
        assert status == 200 and b"welcome" in body
        status, _, body = env.run(http_get(env.port, "/about"))
        assert status == 200 and b"about" in body
        status, headers, _ = env.run(http_get(env.port, "/"))
        etag = headers["etag"]
        status, _, _ = env.run(
            http_get(env.port, "/", headers={"if-none-match": etag}))
        assert status == 304

    def test_proxy_with_forwarding_headers(self, env):
        status, headers, body = env.run(http_get(env.port, "/api/hello"))
        assert status == 200
        assert b"pong: GET /api/hello" in body
        assert b"xff: True" in body
        assert headers.get("server") == "pingoo"

    def test_waf_blocks(self, env):
        for path in ("/.env", "/.git/config"):
            status, _, _ = env.run(http_get(env.port, path))
            assert status == 403, path
        # Spaces are illegal in request targets (h11 rejects the request
        # line outright), so real SQLi arrives encoded — match that form.
        for q in ("/api/q?id=1%20UNION%20SELECT%20x",
                  "/api/q?id=1+UNION+SELECT+x"):
            status, _, _ = env.run(http_get(env.port, q))
            assert status == 403, q

    def test_empty_ua_blocked(self, env):
        status, _, _ = env.run(
            http_get(env.port, "/", headers={"user-agent": ""}))
        assert status == 403

    def test_captcha_flow(self, env):
        bot = {"user-agent": "sqlmap/1.8"}
        status, _, body = env.run(http_get(env.port, "/", headers=bot))
        assert status == 403 and b"human" in body

        status, headers, body = env.run(http_get(
            env.port, "/__pingoo/captcha/api/init", method="POST",
            headers=bot))
        assert status == 200
        payload = json.loads(body)
        challenge, difficulty = payload["challenge"], payload["difficulty"]
        cookie = headers["set-cookie"].split(";")[0]
        nonce = 0
        while True:
            digest = hashlib.sha256(
                (challenge + str(nonce)).encode()).hexdigest()
            if digest.startswith("0" * difficulty):
                break
            nonce += 1
        status, headers, body = env.run(http_get(
            env.port, "/__pingoo/captcha/api/verify", method="POST",
            headers=dict(bot, cookie=cookie,
                         **{"content-type": "application/json"}),
            body=json.dumps({"nonce": str(nonce), "hash": digest}).encode()))
        assert status == 200 and json.loads(body)["ok"] is True
        verified_cookie = headers["set-cookie"].split(";")[0]

        status, _, body = env.run(http_get(
            env.port, "/", headers=dict(bot, cookie=verified_cookie)))
        assert status == 200 and b"welcome" in body

    def test_tampered_verified_cookie_serves_challenge(self, env):
        from pingoo_tpu_torch.host.captcha import CAPTCHA_VERIFIED_COOKIE

        status, _, body = env.run(http_get(
            env.port, "/",
            headers={"cookie": f"{CAPTCHA_VERIFIED_COOKIE}=ey.fake.token"}))
        assert status == 403 and b"human" in body

    def test_metrics_endpoint(self, env):
        env.run(http_get(env.port, "/"))
        # JSON (back-compat schema) under Accept: application/json.
        status, _, body = env.run(http_get(
            env.port, "/__pingoo/metrics",
            headers={"accept": "application/json"}))
        assert status == 200
        payload = json.loads(body)
        assert payload["requests"] >= 1
        assert "verdict" in payload
        assert "stages" in payload["verdict"]  # per-stage breakdown
        assert payload["verdict"]["requests"] >= 1
        assert payload["pipeline"]["depth"] == 2  # PINGOO_SCHED_PIPELINE
        assert payload["engine_errors"] == 0
        assert "ladder" not in payload
        # The Prometheus text is the default exposition, and lints clean;
        # the flight-recorder, compile-ledger and timeline routes answer
        # 501 with the reason.
        from pingoo_tpu_torch.obs.registry import lint_prometheus_text

        status, headers, body = env.run(http_get(env.port,
                                                 "/__pingoo/metrics"))
        assert status == 200
        assert headers["content-type"].startswith(
            "text/plain; version=0.0.4")
        text = body.decode()
        assert lint_prometheus_text(text) == []
        assert 'pingoo_requests_total{listener="' in text
        assert 'pingoo_verdict_wait_ms_bucket{le="+Inf",plane="python"}' \
            in text
        for path in ("/__pingoo/flightrecorder", "/__pingoo/timeline"):
            status, headers, body = env.run(http_get(env.port, path))
            assert status == 501, path
            assert headers["content-type"] == "application/json"
            assert "item 10" in json.loads(body)["error"]

    def test_compileledger_endpoint(self, env):
        """The process's compile ledger, with the JAX package's keys."""
        from pingoo_tpu.obs.perf import CompileLedger as RefLedger
        from pingoo_tpu_torch.obs.perf import get_compile_ledger

        status, headers, body = env.run(http_get(env.port,
                                                 "/__pingoo/compileledger"))
        assert status == 200
        assert headers["content-type"] == "application/json"
        payload = json.loads(body)
        want = get_compile_ledger().snapshot()
        assert set(payload) == set(want) == set(RefLedger().snapshot())
        assert payload["enabled"] is False and payload["path"] is None
        assert payload["compiles_total"] == len(payload["events"])

    def test_trace_id_header_and_sampled_access_log(self, env, caplog):
        import logging

        from pingoo_tpu_torch.obs.trace import TRACE_HEADER

        listener = env.server.http_listeners[0]
        old_every = listener._access_log.sample_every
        listener._access_log.sample_every = 1  # log every request
        try:
            with caplog.at_level(logging.INFO, logger="pingoo_tpu.access"):
                status, headers, _ = env.run(http_get(env.port, "/"))
        finally:
            listener._access_log.sample_every = old_every
        assert status == 200
        trace_id = headers[TRACE_HEADER]
        assert len(trace_id) == 16
        logged = [r for r in caplog.records
                  if getattr(r, "fields", {}).get("trace_id") == trace_id]
        assert logged, "trace id missing from sampled access log"
        assert logged[0].fields["status"] == 200

    def test_profile_endpoint_bounded_window(self, env, tmp_path,
                                             monkeypatch):
        """A torch.profiler window: 200, a 409 while it is live, and a
        Chrome trace written when it closes on its own."""
        monkeypatch.setenv("PINGOO_PROFILE_DIR", str(tmp_path))
        status, _, body = env.run(http_get(
            env.port, "/__pingoo/profile?seconds=0.2"))
        payload = json.loads(body)
        assert status == 200
        assert payload["profiling"] is True and payload["dir"] \
            == str(tmp_path)
        # A second capture while the window is live must 409.
        status2, _, body2 = env.run(http_get(
            env.port, "/__pingoo/profile?seconds=0.2"))
        assert status2 == 409
        assert "already active" in json.loads(body2)["error"]
        deadline = time.monotonic() + 10
        while not list(tmp_path.glob("*.trace.json")):
            assert time.monotonic() < deadline, "the window did not close"
            time.sleep(0.05)
        assert env.server.verdict._profiler is None

    def test_unknown_file_404(self, env):
        status, _, _ = env.run(http_get(env.port, "/nope.xyz"))
        assert status == 404

    def test_traversal_guard(self, env):
        status, _, _ = env.run(http_get(env.port, "/../pingoo.yml"))
        assert status in (403, 404)

    def test_websocket_upgrade_tunnels(self, env):
        """Upgrade requests tunnel raw bytes through the proxy after the
        verdict (reference http_listener.rs:277
        serve_connection_with_upgrades)."""

        async def ws_roundtrip():
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", env.port)
            writer.write(
                b"GET /api/ws HTTP/1.1\r\nhost: test.local\r\n"
                b"user-agent: " + UA.encode() + b"\r\n"
                b"connection: Upgrade\r\nupgrade: websocket\r\n"
                b"sec-websocket-key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                b"sec-websocket-version: 13\r\n\r\n")
            await writer.drain()
            head = b""
            while b"\r\n\r\n" not in head:
                chunk = await reader.read(4096)
                if not chunk:
                    break
                head += chunk
            assert head.startswith(b"HTTP/1.1 101"), head[:120]
            writer.write(b"\x81\x05hello")
            await writer.drain()
            got = b""
            while len(got) < 7:
                chunk = await reader.read(4096)
                if not chunk:
                    break
                got += chunk
            writer.close()
            return got

        assert env.run(ws_roundtrip()) == b"\x81\x05hello"

    def test_engine_error_answers_503(self, env, monkeypatch):
        """The port has no degraded verdict: a verdict that raises is
        refused with 503 and counted, never allowed."""
        listener = env.server.http_listeners[0]

        async def broken(tup):
            raise RuntimeError("device lost")

        before = listener.stats.engine_errors
        monkeypatch.setattr(listener.verdict, "evaluate", broken)
        status, _, body = env.run(http_get(env.port, "/"))
        assert (status, body) == (503, b"Service Unavailable")
        assert listener.stats.engine_errors == before + 1


class TestTcpProxy:
    def test_tcp_passthrough(self, loop_runner, tmp_path):
        async def flow():
            async def echo(reader, writer):
                data = await reader.read(1024)
                writer.write(b"echo:" + data)
                await writer.drain()
                writer.close()

            upstream = await asyncio.start_server(echo, "127.0.0.1", 0)
            up_port = upstream.sockets[0].getsockname()[1]
            cfg = tmp_path / "pingoo.yml"
            cfg.write_text(textwrap.dedent(f"""
                listeners:
                  tcp:
                    address: tcp://127.0.0.1:0
                services:
                  db:
                    tcp_proxy: [tcp://127.0.0.1:{up_port}]
            """))
            config = load_and_validate(str(cfg))
            server = Server(config, device="cpu", enable_docker=False,
                            geoip_paths=(str(tmp_path / "none"),),
                            captcha_jwks_path=str(tmp_path / "jwks.json"),
                            tls_dir=str(tmp_path / "tls"))
            await server.start()
            port = server.tcp_servers[0].sockets[0].getsockname()[1]
            try:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port)
                writer.write(b"hello")
                await writer.drain()
                writer.write_eof()
                data = await reader.read()
                assert data == b"echo:hello"
                writer.close()
            finally:
                await server.stop()
                upstream.close()

        loop_runner.run(flow())


class TestXffTokenTrust:
    """x-forwarded-for trust is TOKEN-BOUND: the loopback control plane
    honors spoofable identity headers only on requests carrying the
    native plane's per-boot x-pingoo-internal token — a co-resident
    process dialing 127.0.0.1 directly cannot spoof client identity for
    IP rules or captcha binding."""

    @pytest.fixture(scope="class")
    def listener(self, loop_runner):
        from pingoo_tpu_torch.compiler.plan import compile_ruleset
        from pingoo_tpu_torch.config.schema import Action, RuleConfig
        from pingoo_tpu_torch.engine.service import VerdictService
        from pingoo_tpu_torch.expr import compile_expression
        from pingoo_tpu_torch.host.captcha import CaptchaManager
        from pingoo_tpu_torch.host.httpd import HttpListener

        rules = [RuleConfig(
            name="ipblock", actions=(Action.BLOCK,),
            expression=compile_expression('client.ip == "9.9.9.9"'))]
        plan = compile_ruleset(rules, {}, device="cpu")

        async def boot(tmpdir):
            svc = VerdictService(plan, {}, max_wait_us=100, device="cpu")
            lst = HttpListener(
                "ctl", "127.0.0.1", 0, [], svc, {}, plan.rules,
                CaptchaManager(jwks_path=f"{tmpdir}/jwks.json"),
                xff_token="sekrit-token")
            await svc.start()
            await lst.bind()
            asyncio.ensure_future(lst.serve_forever())
            return lst

        import tempfile

        with tempfile.TemporaryDirectory() as tmpdir:
            lst = loop_runner.run(boot(tmpdir))
            yield lst

    def _get(self, loop_runner, port, headers):
        return loop_runner.run(http_get(port, "/x", headers=headers))

    def test_spoofed_xff_without_token_ignored(self, loop_runner, listener):
        status, _, _ = self._get(loop_runner, listener.bound_port,
                                 {"x-forwarded-for": "9.9.9.9"})
        assert status == 404  # rule did NOT match: peer ip was used

    def test_wrong_token_not_trusted(self, loop_runner, listener):
        status, _, _ = self._get(loop_runner, listener.bound_port,
                                 {"x-forwarded-for": "9.9.9.9",
                                  "x-pingoo-internal": "wrong"})
        assert status == 404

    def test_valid_token_binds_client_ip(self, loop_runner, listener):
        status, _, _ = self._get(loop_runner, listener.bound_port,
                                 {"x-forwarded-for": "9.9.9.9",
                                  "x-pingoo-internal": "sekrit-token"})
        assert status == 403  # trusted XFF hit the ip rule


# -- cross-package parity ----------------------------------------------------

# The JAX package's explain payload is the port's key for key with its
# provenance off (tests/test_torch_config_slice.py runs it so too).
REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_PROVENANCE": "0",
           "PINGOO_SCHED_MODE": "fixed", "PINGOO_MEGASTEP": "off"}


def raw_request(target="/", headers=None, method="GET", body=b"",
                version="HTTP/1.1"):
    hdrs = [("host", "test.local"), ("user-agent", UA)]
    drop = {k.lower() for k, _ in headers or ()}
    hdrs = [(k, v) for k, v in hdrs if k not in drop]
    hdrs += [(k, v) for k, v in headers or () if v is not None]
    hdrs.append(("connection", "close"))
    if body:
        hdrs.append(("content-length", str(len(body))))
    head = f"{method} {target} {version}\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in hdrs) + "\r\n"
    return head.encode("latin-1") + body


TOKEN = [("x-pingoo-internal", XFF_TOKEN)]
PARITY = {
    "static_index": raw_request("/"),
    "static_about": raw_request("/about"),
    "static_index_html": raw_request("/index.html"),
    "static_head": raw_request("/", method="HEAD"),
    "static_post_405": raw_request("/", method="POST", body=b"a=1"),
    "not_found": raw_request("/nope.xyz"),
    "traversal": raw_request("/../pingoo.yml"),
    "traversal_encoded": raw_request("/%2e%2e/pingoo.yml"),
    "acme_path_without_acme": raw_request(
        "/.well-known/acme-challenge/tok"),
    "blocked_env": raw_request("/.env"),
    "blocked_git": raw_request("/.git/config"),
    "blocked_sqli_encoded": raw_request("/api/q?id=1%20UNION%20SELECT%20x"),
    "blocked_sqli_plus": raw_request("/api/q?id=1+UNION+SELECT+x"),
    "blocked_head": raw_request("/.env", method="HEAD"),
    "proxied": raw_request("/api/hello"),
    "proxied_query": raw_request("/api/x?a=1&b=2"),
    "proxied_post_body": raw_request("/api/echo", method="POST",
                                     body=b"hello=world"),
    "proxied_absolute_form": raw_request("http://test.local/api/abs"),
    "captcha": raw_request("/", [("user-agent", "sqlmap/1.8")]),
    "captcha_on_api": raw_request("/api/hello",
                                  [("user-agent", "sqlmap/1.8")]),
    "tampered_verified_cookie": raw_request(
        "/", [("cookie", "__pingoo_captcha_verified=ey.fake.token")]),
    "empty_ua": raw_request("/", [("user-agent", "")]),
    "missing_ua": raw_request("/", [("user-agent", None)]),
    "oversized_ua": raw_request("/", [("user-agent", "U" * 300)]),
    "ua_255": raw_request("/", [("user-agent", "U" * 255)]),
    "host_300_bytes": raw_request("/", [("host", "h" * 300)]),
    "host_with_port": raw_request("/", [("host", "test.local:8080")]),
    "host_ipv6": raw_request("/", [("host", "[::1]:80")]),
    "list_hit_through_token": raw_request(
        "/", TOKEN + [("x-forwarded-for", "192.0.2.7")]),
    "list_hit_through_token_on_api": raw_request(
        "/api/hello", TOKEN + [("x-forwarded-for", "192.0.2.9, 10.0.0.1")]),
    "xff_without_token": raw_request(
        "/", [("x-forwarded-for", "192.0.2.7")]),
    "xff_wrong_token": raw_request(
        "/", [("x-pingoo-internal", "wrong"),
              ("x-forwarded-for", "192.0.2.7")]),
    "token_without_xff": raw_request("/api/hello", TOKEN),
    "http_1_0": raw_request("/", version="HTTP/1.0"),
    "http_2_0_on_h1": raw_request("/", version="HTTP/2.0"),
    "bare_lf": b"GET / HTTP/1.1\nhost: test.local\nuser-agent: ua\n\n",
    "cl_and_te": (b"POST /api/x HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                  b"content-length: 3\r\ntransfer-encoding: chunked\r\n"
                  b"\r\n0\r\n\r\n"),
    "duplicate_cl": (b"POST /api/x HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                     b"content-length: 1\r\ncontent-length: 1\r\n\r\nx"),
    "obs_fold": (b"GET / HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                 b"x-a: 1\r\n 2\r\n\r\n"),
    "oversized_head": raw_request("/", [("x-pad", "p" * (40 * 1024))]),
    "oversized_declared_body": (b"POST /api/x HTTP/1.1\r\nhost: t\r\n"
                                b"user-agent: ua\r\n"
                                b"content-length: 99999999999\r\n\r\n"),
    "chunked_body_proxied": (b"POST /api/chunked HTTP/1.1\r\nhost: t\r\n"
                             b"user-agent: ua\r\nconnection: close\r\n"
                             b"transfer-encoding: chunked\r\n\r\n"
                             b"5\r\nhello\r\n0\r\n\r\n"),
    "explain_env": raw_request("/__pingoo/explain?path=/.env"),
    "explain_captcha": raw_request(
        "/__pingoo/explain?path=/&ua=sqlmap%2F1.8&ip=192.0.2.1"),
    "explain_bad_asn": raw_request("/__pingoo/explain?asn=x"),
}


async def exchange(port: int, raw: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), 30)
    writer.close()
    return out


def response_of(raw: bytes):
    """(status, headers but the trace id, body); an explain payload is
    compared as JSON without its trace id, a fresh one per request."""
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    headers = [tuple(s.strip() for s in line.split(":", 1))
               for line in lines[1:]]
    headers = [(k.lower(), v) for k, v in headers
               if k.lower() not in ("x-pingoo-trace-id", "date")]
    if ("content-type", "application/json") in headers and status == 200:
        body = json.loads(body)
        body.pop("trace_id", None)
    return status, headers, body


@pytest.fixture(scope="module")
def pair(loop_runner, tmp_path_factory):
    """(JAX package's port, the port's port) on one config and one pong."""
    from pingoo_tpu.config import load_and_validate as ref_load
    from pingoo_tpu.host.server import Server as RefServer

    tmp_path = tmp_path_factory.mktemp("parity")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)

        async def setup():
            pong, pong_port = await start_pong()
            cfg = str(write_config(tmp_path, pong_port, RULES + LIST_RULE))
            ref = RefServer(ref_load(cfg), use_device=True,
                            xff_token=XFF_TOKEN, **server_kwargs(tmp_path))
            port = Server(load_and_validate(cfg), device="cpu",
                          xff_token=XFF_TOKEN, **server_kwargs(tmp_path))
            servers = (ref, port)
            for s in servers:
                await s.start()
            tasks = [asyncio.create_task(s.serve_forever()) for s in servers]
            return pong, servers, tasks

        pong, servers, tasks = loop_runner.run(setup(), timeout=300)
        yield [s.http_listeners[0].bound_port for s in servers]

        async def teardown():
            for t in tasks:
                t.cancel()
            for s in servers:
                await s.stop()
            pong.close()

        loop_runner.run(teardown())


@pytest.mark.parametrize("name", list(PARITY))
def test_cross_package_parity(pair, loop_runner, name):
    ref_port, port = pair
    want = response_of(loop_runner.run(exchange(ref_port, PARITY[name]),
                                       timeout=120))
    got = response_of(loop_runner.run(exchange(port, PARITY[name]),
                                      timeout=120))
    assert got == want


def test_parity_list_reaches_every_outcome(pair, loop_runner):
    """The list covers each class of response the listener gives."""
    statuses = {response_of(loop_runner.run(exchange(pair[1], raw)))[0]
                for raw in PARITY.values()}
    assert {200, 400, 403, 404, 405, 413, 431} <= statuses


# -- the entry point -----------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_serves_and_drains_on_sigterm(loop_runner, tmp_path,
                                               cost_ledger_per_test):
    async def boot_pong():
        return await start_pong()

    pong, pong_port = loop_runner.run(boot_pong())
    port = free_port()
    cfg = write_config(tmp_path, pong_port, address=f"127.0.0.1:{port}")
    env = dict(os.environ, PYTHONPATH=str(REPO), PINGOO_LOG="warning")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pingoo_tpu_torch", "--config", str(cfg),
         "--no-device", "--no-docker", "--captcha-jwks",
         str(tmp_path / "jwks.json")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                break
            except OSError:
                assert time.monotonic() < deadline, "the port never opened"
                time.sleep(0.1)
        blocked = loop_runner.run(http_get(port, "/.env"))
        captcha = loop_runner.run(http_get(
            port, "/", headers={"user-agent": "sqlmap/1.8"}))
        proxied = loop_runner.run(http_get(port, "/api/hello"))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        pong.close()
    assert blocked[0] == 403 and blocked[2] == b"Forbidden"
    assert captcha[0] == 403 and b"human" in captcha[2]
    assert proxied[0] == 200 and b"pong: GET /api/hello" in proxied[2]
    assert rc == 0, proc.stderr.read()[-3000:]
    # The drain saved the Python plane's cost model where
    # PINGOO_COST_LEDGER points (under tmp_path), and nothing in its
    # working directory.
    ledger = json.loads(cost_ledger_per_test.read_text())
    assert set(ledger["entries"]) == {"cpu|python"}
    assert not (tmp_path / "COST_LEDGER.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_server_and_main_default_to_the_card(tmp_path):
    from pingoo_tpu_torch.__main__ import main

    cfg = write_config(tmp_path, 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(load_and_validate(str(cfg)), **server_kwargs(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", str(cfg), "--no-docker", "--captcha-jwks",
              str(tmp_path / "jwks.json")])


@pytest.mark.parametrize("flags,item", [
    (["--native-plane", "--cache-dir", "cache"], "item 8"),
    (["--cache-dir", "cache"], "item 8"),
    (["--bot-score-params", "head.npz"], "item 7"),
])
def test_unported_options_raise(tmp_path, monkeypatch, loop_runner, flags,
                                item):
    """These options raised NotImplementedError naming their ROADMAP item
    until items 7 (the bot head) and 8 (the artifact cache) were ported.
    Now main() passes them to the plane's runner, and a Server given them
    boots: through the artifact cache (item 8: the plan is written to the
    cache directory, and a second boot loads it), or with the bot head
    (item 7: its weights on the service, a verdict with the head's score)."""
    import pingoo_tpu_torch.host.native_plane as native_plane
    import pingoo_tpu_torch.host.server as server_mod
    from pingoo_tpu_torch.__main__ import main
    from pingoo_tpu_torch.engine.batch import RequestTuple
    from pingoo_tpu_torch.models import botscore

    seen = {}

    async def fake_run(config, **kwargs):
        seen.update(kwargs)

    monkeypatch.setattr(server_mod, "run", fake_run)
    monkeypatch.setattr(native_plane, "run_native", fake_run)
    monkeypatch.chdir(tmp_path)
    params = botscore.init_params(torch.Generator().manual_seed(7),
                                  device="cpu")
    botscore.save_params(params, str(tmp_path / "head.npz"))
    cfg = write_config(tmp_path, 9)
    assert main(["--config", str(cfg), "--no-device", "--no-docker",
                 "--captcha-jwks", str(tmp_path / "jwks.json"),
                 *flags]) == 0
    cache_dir = flags[flags.index("--cache-dir") + 1] \
        if "--cache-dir" in flags else None
    head = flags[flags.index("--bot-score-params") + 1] \
        if "--bot-score-params" in flags else None
    assert (seen["cache_dir"], seen["bot_score_params_path"]) \
        == (cache_dir, head)

    async def boot():
        server = Server(load_and_validate(str(cfg)), device="cpu",
                        cache_dir=seen["cache_dir"],
                        bot_score_params_path=seen["bot_score_params_path"],
                        **server_kwargs(tmp_path))
        await server.start()
        try:
            verdict = await server.verdict.evaluate(RequestTuple(
                path="/x", url="/x", user_agent="Mozilla/5.0"))
        finally:
            await server.stop()
        return server, verdict

    server, verdict = loop_runner.run(boot())
    if item == "item 8":
        assert [p.suffix for p in (tmp_path / "cache").iterdir()] \
            == [".plan"]
        again, verdict2 = loop_runner.run(boot())
        assert again.plan.stats == server.plan.stats
        assert verdict2.action == verdict.action
    else:
        assert server.verdict.bot_score_params is not None
        from pingoo_tpu_torch.engine.batch import (batch_tensors,
                                                   encode_requests, pad_batch)

        batch = encode_requests([RequestTuple(path="/x", url="/x",
                                              user_agent="Mozilla/5.0")],
                                server.plan.field_specs)
        want = float(botscore.score(params, batch_tensors(
            pad_batch(batch, 8).arrays, "cpu"))[0])
        assert abs(verdict.bot_score - want) < 1e-6
