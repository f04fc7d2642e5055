"""The port's native plane on the CPU: every case of
tests/test_native_plane.py, under the same class and test names, against
the port: its httpd (built from pingoo_tpu_torch/native by
`native_ring.build_httpd`), `compile_ruleset(..., device="cpu")`, its
`RingSidecar(device="cpu")`, `NativePlane(device="cpu")` and its
`write_services_file`. The reference's `pipeline_depth=1` has no
counterpart in the per-batch sidecar and is dropped. The `drain` fixture
binary (a canned-verdict ring consumer) comes from the JAX package's own
build, and the Prometheus text is linted with the JAX package's
`lint_prometheus_text`, the reference of the port's copy.

The stacks of cases whose subject is not the sidecar's liveness start
their httpd with PINGOO_SIDECAR_TIMEOUT_MS=LENIENT_SIDECAR_TIMEOUT_MS
(`lenient_liveness`): on a host busy with other test workers the CPU
sidecar's heartbeat can go stale for 500 ms, which turns a verdict
assertion into a load test. TestVerdictTimeoutFailsOpen keeps the
httpd's defaults.

Reference semantics under test: per-request rules evaluation
(http_listener.rs:133-274), the captcha gate ordering (:200-236), the
verified-client action loop (:251-264), and ClientHello-time challenge
interception (listeners/mod.rs:112-154, acme.rs:180-242).
"""

import asyncio
import hashlib
import http.server
import json
import os
import socket
import ssl
import subprocess
import threading
import time

import pytest
import torch

from pingoo_tpu import native_ring as ref_native_ring
from pingoo_tpu_torch import native_ring
from pingoo_tpu_torch.native_ring import Ring, RingSidecar
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

HTTPD = None  # the port's httpd binary, set by `built`
LENIENT_SIDECAR_TIMEOUT_MS = "10000"


@pytest.fixture(scope="module", autouse=True)
def built():
    """Build the port's ring library and binaries once per module."""
    global HTTPD
    native_ring.ensure_built()
    HTTPD = str(native_ring.httpd_path())


@pytest.fixture(scope="module", autouse=True)
def lenient_liveness():
    """PINGOO_SIDECAR_TIMEOUT_MS for every httpd this module starts, but
    where a case deletes it (see the module's docstring)."""
    old = os.environ.get("PINGOO_SIDECAR_TIMEOUT_MS")
    os.environ["PINGOO_SIDECAR_TIMEOUT_MS"] = LENIENT_SIDECAR_TIMEOUT_MS
    yield
    if old is None:
        os.environ.pop("PINGOO_SIDECAR_TIMEOUT_MS")
    else:
        os.environ["PINGOO_SIDECAR_TIMEOUT_MS"] = old


def _drain_bin():
    """The JAX package's canned-verdict drain, from its own build."""
    subprocess.run(["make", "-C", ref_native_ring.NATIVE_DIR, "drain"],
                   check=True, capture_output=True)
    return os.path.join(ref_native_ring.NATIVE_DIR, "drain")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Upstream(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        body = f"up:{self.path}".encode()
        self.send_response(200)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("content-length", 0))
        body = b"post:" + self.rfile.read(n)
        self.send_response(200)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class NativeStack:
    """native httpd + ring sidecar + plain upstream (+ optional extras)."""

    def __init__(self, tmp, rules, lists=None, jwks=None, captcha_port=None,
                 tls_dir=None, alpn_dir=None, routes=None, services=None,
                 upstream_ca=None):
        from pingoo_tpu_torch.compiler import compile_ruleset

        self.upstream = http.server.HTTPServer(("127.0.0.1", 0), _Upstream)
        threading.Thread(target=self.upstream.serve_forever,
                         daemon=True).start()
        plan = compile_ruleset(rules, lists or {}, routes=routes,
                               device="cpu")
        self.ring_path = str(tmp / "ring")
        self.ring = Ring(self.ring_path, capacity=1024, create=True)
        self.sidecar = RingSidecar(
            self.ring, plan, lists or {}, max_batch=64,
            services=[name for name, _ in routes] if routes else None,
            device="cpu")
        threading.Thread(target=self.sidecar.run, daemon=True).start()
        self.port = _free_port()
        argv = [HTTPD, str(self.port), self.ring_path, "127.0.0.1",
                str(self.upstream.server_address[1])]
        if jwks:
            argv += ["--jwks", jwks]
        if captcha_port:
            argv += ["--captcha-upstream", f"127.0.0.1:{captcha_port}"]
        if tls_dir:
            argv += ["--tls-dir", tls_dir]
        if alpn_dir:
            argv += ["--alpn-dir", alpn_dir]
        self.services_path = None
        if services is not None:
            self.services_path = str(tmp / "services.tbl")
            native_ring.write_services_file(self.services_path, services)
            argv += ["--services", self.services_path]
        if upstream_ca:
            argv += ["--upstream-ca", upstream_ca]
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        line = self.proc.stdout.readline()
        assert b"listening" in line, line

    def stop(self):
        self.proc.kill()
        self.proc.wait()
        self.upstream.shutdown()
        self.sidecar.stop()
        self.ring.close()


def recv_one_response(c, pending=None):
    """Read one content-length-framed HTTP response from the socket. With
    `pending` (a bytearray kept across calls on one connection), bytes
    read past this response, the start of a pipelined next one, are kept
    there for the next call instead of dropped."""
    data = bytes(pending) if pending is not None else b""
    while b"\r\n\r\n" not in data:
        ch = c.recv(65536)
        if not ch:
            return data
        data += ch
    head, rest = data.split(b"\r\n\r\n", 1)
    cl = 0
    for ln in head.split(b"\r\n"):
        if ln.lower().startswith(b"content-length:"):
            cl = int(ln.split(b":")[1])
    while len(rest) < cl:
        ch = c.recv(65536)
        if not ch:
            break
        rest += ch
    if pending is not None:
        pending[:] = rest[cl:]
    return head + b"\r\n\r\n" + rest[:cl]


def raw_request(port, payload):
    c = socket.create_connection(("127.0.0.1", port), timeout=10)
    c.sendall(payload)
    data = b""
    c.settimeout(10)
    try:
        while True:
            ch = c.recv(65536)
            if not ch:
                break
            data += ch
    except socket.timeout:
        pass
    c.close()
    return data


def _block_rules(marker="evil"):
    from pingoo_tpu_torch.config.schema import Action, RuleConfig
    from pingoo_tpu_torch.expr import compile_expression

    return [RuleConfig(
        name="r", actions=(Action.BLOCK,),
        expression=compile_expression(
            f'http_request.url.contains("{marker}")'))]


class TestKeepAlive:
    @pytest.fixture(scope="class")
    def stack(self, tmp_path_factory):
        st = NativeStack(tmp_path_factory.mktemp("ka"), _block_rules())
        yield st
        st.stop()

    def test_every_request_on_a_connection_is_verdicted(self, stack):
        """The WAF-bypass regression: request #2 on a kept-alive
        connection must be evaluated, not blindly relayed."""
        c = socket.create_connection(("127.0.0.1", stack.port), timeout=10)
        c.sendall(b"GET /one HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        r1 = recv_one_response(c)
        assert r1.startswith(b"HTTP/1.1 200") and b"up:/one" in r1
        c.sendall(b"GET /evil HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        r2 = recv_one_response(c)
        assert r2.startswith(b"HTTP/1.1 403")
        c.close()

    def test_pipelined_attack_blocked(self, stack):
        c = socket.create_connection(("127.0.0.1", stack.port), timeout=10)
        c.sendall(b"GET /a HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n"
                  b"GET /b-evil HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        # Both responses may arrive in one read (the 403 then closes the
        # connection), so what the first read takes past r1 is kept.
        pending = bytearray()
        r1 = recv_one_response(c, pending)
        r2 = recv_one_response(c, pending)
        c.close()
        assert r1.startswith(b"HTTP/1.1 200") and b"up:/a" in r1
        assert r2.startswith(b"HTTP/1.1 403")

    def test_post_body_then_reuse(self, stack):
        c = socket.create_connection(("127.0.0.1", stack.port), timeout=10)
        c.sendall(b"POST /p HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                  b"content-length: 10\r\n\r\nhello-body")
        r1 = recv_one_response(c)
        assert b"post:hello-body" in r1
        c.sendall(b"GET /next HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        r2 = recv_one_response(c)
        assert b"up:/next" in r2
        c.close()

    def test_oversized_ua_403(self, stack):
        data = raw_request(
            stack.port,
            ("GET / HTTP/1.1\r\nhost: t\r\nuser-agent: " + "U" * 300 +
             "\r\nconnection: close\r\n\r\n").encode())
        assert data.startswith(b"HTTP/1.1 403")


class TestCookieGateAndCaptchaFlow:
    @pytest.fixture(scope="class")
    def stack(self, tmp_path_factory):
        from pingoo_tpu_torch.config.schema import Action, RuleConfig
        from pingoo_tpu_torch.compiler import compile_ruleset
        from pingoo_tpu_torch.engine.service import VerdictService
        from pingoo_tpu_torch.expr import compile_expression
        from pingoo_tpu_torch.host.captcha import CaptchaManager
        from pingoo_tpu_torch.host.httpd import HttpListener

        tmp = tmp_path_factory.mktemp("captcha")
        jwks = str(tmp / "jwks.json")
        cap = CaptchaManager(jwks_path=jwks)
        rules = [
            RuleConfig(name="bot", actions=(Action.CAPTCHA,),
                       expression=compile_expression(
                           'http_request.user_agent.contains("sqlmap")')),
            RuleConfig(name="cb", actions=(Action.CAPTCHA, Action.BLOCK),
                       expression=compile_expression(
                           'http_request.path == "/always-block"')),
        ]
        plan = compile_ruleset(rules, {}, device="cpu")

        # Python control plane serving the captcha API behind the native
        # front (trust_xff so the client id binds the real client ip).
        loop = asyncio.new_event_loop()

        async def boot():
            svc = VerdictService(plan, {}, device="cpu", max_wait_us=100)
            lst = HttpListener("ctl", "127.0.0.1", 0, [], svc, {}, plan.rules,
                               cap, trust_xff=True)
            await svc.start()
            await lst.bind()
            asyncio.ensure_future(lst.serve_forever())
            return lst

        ctl = loop.run_until_complete(boot())
        threading.Thread(target=loop.run_forever, daemon=True).start()

        st = NativeStack(tmp, rules, jwks=jwks, captcha_port=ctl.bound_port)
        yield st
        st.stop()

    def _req(self, stack, method, path, headers=None, body=b"",
             ua="sqlmap/1.8"):
        h = f"{method} {path} HTTP/1.1\r\nhost: t.test\r\nuser-agent: {ua}\r\n"
        for k, v in (headers or {}).items():
            h += f"{k}: {v}\r\n"
        if body:
            h += f"content-length: {len(body)}\r\n"
        h += "connection: close\r\n\r\n"
        data = raw_request(stack.port, h.encode() + body)
        head, _, rest = data.partition(b"\r\n\r\n")
        status = int(head.split(b" ")[1])
        hdrs = {}
        for ln in head.split(b"\r\n")[1:]:
            k, _, v = ln.partition(b":")
            hdrs[k.decode().lower()] = v.strip().decode()
        return status, hdrs, rest

    def test_full_flow_solve_then_verified_proxy(self, stack):
        # 1) bot is redirected to the challenge
        st, h, _ = self._req(stack, "GET", "/")
        assert st == 302 and h.get("location") == "/__pingoo/captcha"
        # 2) init + PoW via the proxied control plane
        st, h, body = self._req(stack, "POST", "/__pingoo/captcha/api/init")
        assert st == 200
        payload = json.loads(body)
        cookie = h["set-cookie"].split(";")[0]
        nonce = 0
        while True:
            digest = hashlib.sha256(
                (payload["challenge"] + str(nonce)).encode()).hexdigest()
            if digest.startswith("0" * payload["difficulty"]):
                break
            nonce += 1
        st, h, body = self._req(
            stack, "POST", "/__pingoo/captcha/api/verify",
            headers={"cookie": cookie, "content-type": "application/json"},
            body=json.dumps({"nonce": str(nonce), "hash": digest}).encode())
        assert st == 200 and json.loads(body)["ok"] is True
        verified = h["set-cookie"].split(";")[0]
        # 3) the verified client is PROXIED, not redirected — the C++
        # plane verified the Ed25519 cookie itself.
        st, h, body = self._req(stack, "GET", "/",
                                headers={"cookie": verified})
        assert st == 200 and b"up:/" in body
        # 4) [Captcha, Block] still blocks a VERIFIED client (the
        # verdict byte's bit-2 lane).
        st, h, _ = self._req(stack, "GET", "/always-block",
                             headers={"cookie": verified})
        assert st == 403

    def test_tampered_cookie_redirected(self, stack):
        st, h, _ = self._req(
            stack, "GET", "/",
            headers={"cookie": "__pingoo_captcha_verified=ey.bad.sig"})
        assert st == 302 and h.get("location") == "/__pingoo/captcha"

    def test_captcha_path_reachable_with_bad_cookie(self, stack):
        """Reference ordering: /__pingoo/captcha is served BEFORE the
        cookie gate, so a stale cookie can always be cleared."""
        st, _, _ = self._req(
            stack, "POST", "/__pingoo/captcha/api/init",
            headers={"cookie": "__pingoo_captcha_verified=ey.bad.sig"})
        assert st == 200


class TestTlsPlane:
    @pytest.fixture(scope="class")
    def stack(self, tmp_path_factory):
        from pingoo_tpu_torch.host.tlsmgr import generate_self_signed

        tmp = tmp_path_factory.mktemp("tls")
        tls_dir = tmp / "tls"
        alpn_dir = tmp / "alpn"
        tls_dir.mkdir()
        alpn_dir.mkdir()
        for name, domains in [("default", ["localhost"]),
                              ("site.test", ["site.test"]),
                              ("_.wild.test", ["*.wild.test"])]:
            cert, key = generate_self_signed(domains)
            (tls_dir / f"{name}.pem").write_bytes(cert)
            (tls_dir / f"{name}.key").write_bytes(key)
        cert, key = generate_self_signed(["chal.test"])
        (alpn_dir / "chal.test.pem").write_bytes(cert)
        (alpn_dir / "chal.test.key").write_bytes(key)
        st = NativeStack(tmp, _block_rules(), tls_dir=str(tls_dir),
                         alpn_dir=str(alpn_dir))
        yield st
        st.stop()

    def _tls_conn(self, stack, server_name, alpn):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        ctx.set_alpn_protocols(alpn)
        raw = socket.create_connection(("127.0.0.1", stack.port), timeout=10)
        return ctx.wrap_socket(raw, server_hostname=server_name)

    def _cert_sans(self, sock):
        from cryptography import x509

        pem = ssl.DER_cert_to_PEM_cert(sock.getpeercert(True))
        cert = x509.load_pem_x509_certificate(pem.encode())
        san = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        return san.get_values_for_type(x509.DNSName)

    def test_https_request_verdicted_and_proxied(self, stack):
        c = self._tls_conn(stack, "localhost", ["http/1.1"])
        assert c.selected_alpn_protocol() == "http/1.1"
        c.sendall(b"GET /hello HTTP/1.1\r\nhost: localhost\r\n"
                  b"user-agent: ua\r\nconnection: close\r\n\r\n")
        data = b""
        try:
            while True:
                ch = c.recv(65536)
                if not ch:
                    break
                data += ch
        except ssl.SSLError:
            pass
        c.close()
        assert data.startswith(b"HTTP/1.1 200") and b"up:/hello" in data

    def test_https_attack_blocked(self, stack):
        c = self._tls_conn(stack, "localhost", ["http/1.1"])
        c.sendall(b"GET /x?evil HTTP/1.1\r\nhost: localhost\r\n"
                  b"user-agent: ua\r\nconnection: close\r\n\r\n")
        data = b""
        try:
            while True:
                ch = c.recv(65536)
                if not ch:
                    break
                data += ch
        except ssl.SSLError:
            pass
        c.close()
        assert data.startswith(b"HTTP/1.1 403")

    def test_sni_selects_exact_and_wildcard_cert(self, stack):
        c = self._tls_conn(stack, "site.test", ["http/1.1"])
        assert self._cert_sans(c) == ["site.test"]
        c.close()
        c = self._tls_conn(stack, "a.wild.test", ["http/1.1"])
        assert self._cert_sans(c) == ["*.wild.test"]
        c.close()

    def test_acme_tls_alpn_challenge(self, stack):
        """RFC 8737: acme-tls/1 must be NEGOTIATED and the ephemeral
        challenge certificate presented for the SNI name."""
        c = self._tls_conn(stack, "chal.test", ["acme-tls/1"])
        assert c.selected_alpn_protocol() == "acme-tls/1"
        assert self._cert_sans(c) == ["chal.test"]
        c.close()

    def test_acme_tls_alpn_unknown_domain_refused(self, stack):
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            self._tls_conn(stack, "unknown.test", ["acme-tls/1"])


class TestVerdictTimeoutFailsOpen:
    def test_awaiting_verdict_connection_fails_open(self, tmp_path,
                                                     monkeypatch):
        """A dead sidecar must not leak connections: after the verdict
        timeout the request is proxied without a verdict (fail-open,
        like the ring-full path)."""
        monkeypatch.delenv("PINGOO_SIDECAR_TIMEOUT_MS")  # the defaults
        st = NativeStack(tmp_path, _block_rules())
        st.sidecar.stop()
        time.sleep(0.3)  # let the drain loop exit
        t0 = time.time()
        data = raw_request(
            st.port,
            b"GET /no-verdict HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
            b"connection: close\r\n\r\n")
        took = time.time() - t0
        st.stop()
        assert data.startswith(b"HTTP/1.1 200") and b"up:/no-verdict" in data
        assert took < 10, f"fail-open took {took:.1f}s"


class TestTlsAlpn01EndToEnd:
    def test_issuance_via_native_listener(self, tmp_path, loop_runner):
        """Full tls-alpn-01 issuance: the ACME client stages the RFC
        8737 challenge cert into --alpn-dir, the mock CA validates by a
        REAL acme-tls/1 handshake against the native listener, and the
        certificate is issued and installed."""
        import sys

        sys.path.insert(0, os.path.dirname(__file__))
        from test_acme import MockCa

        from pingoo_tpu_torch.host.acme import AcmeManager
        from pingoo_tpu_torch.host.tlsmgr import generate_self_signed

        tls_dir = tmp_path / "tls"
        alpn_dir = tmp_path / "alpn"
        tls_dir.mkdir()
        alpn_dir.mkdir()
        cert, key = generate_self_signed(["localhost"])
        (tls_dir / "default.pem").write_bytes(cert)
        (tls_dir / "default.key").write_bytes(key)

        stack = NativeStack(tmp_path, _block_rules(), tls_dir=str(tls_dir),
                            alpn_dir=str(alpn_dir))
        try:
            async def flow():
                ca = MockCa(challenge_type="tls-alpn-01")
                await ca.start()

                async def probe(domain):
                    def handshake():
                        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                        ctx.check_hostname = False
                        ctx.verify_mode = ssl.CERT_NONE
                        ctx.set_alpn_protocols(["acme-tls/1"])
                        raw = socket.create_connection(
                            ("127.0.0.1", stack.port), timeout=10)
                        c = ctx.wrap_socket(raw, server_hostname=domain)
                        if c.selected_alpn_protocol() != "acme-tls/1":
                            c.close()
                            return None
                        der = c.getpeercert(True)
                        c.close()
                        return der

                    return await asyncio.get_running_loop().run_in_executor(
                        None, handshake)

                ca.alpn_probe = probe
                manager = AcmeManager(str(tls_dir), ["issued.test"],
                                      directory_url=ca.url("/dir"),
                                      alpn_dir=str(alpn_dir))
                try:
                    await manager.renew_all()
                finally:
                    await ca.stop()
                    await manager.client.close()
                return ca

            ca = loop_runner.run(flow())
        finally:
            stack.stop()

        assert len(ca.validated_keyauths) == 1
        assert (tls_dir / "issued.test.pem").exists()
        assert (tls_dir / "issued.test.key").exists()
        # Challenge certs are ephemeral: cleaned up after the order.
        assert list(alpn_dir.iterdir()) == []


class TestResponseFraming:
    @pytest.fixture()
    def raw_stack(self, tmp_path):
        """Native stack whose upstream is a raw socket server we script
        per-test (python http.server can't speak chunked/100-continue)."""
        from pingoo_tpu_torch.compiler import compile_ruleset

        handler_box = {}
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)
        up_port = lsock.getsockname()[1]

        def serve():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                h = handler_box.get("handler")
                if h:
                    threading.Thread(target=h, args=(conn,),
                                     daemon=True).start()
                else:
                    conn.close()

        threading.Thread(target=serve, daemon=True).start()

        plan = compile_ruleset(_block_rules(), {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=256, create=True)
        sidecar = RingSidecar(ring, plan, {}, max_batch=32,
                              device="cpu")
        threading.Thread(target=sidecar.run, daemon=True).start()
        port = _free_port()
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "ring"), "127.0.0.1",
             str(up_port)], stdout=subprocess.PIPE)
        assert b"listening" in proc.stdout.readline()

        class S:
            pass

        s = S()
        s.port = port
        s.handler_box = handler_box
        yield s
        proc.kill()
        proc.wait()
        lsock.close()
        sidecar.stop()
        ring.close()

    @staticmethod
    def _read_head(conn):
        data = b""
        while b"\r\n\r\n" not in data:
            ch = conn.recv(65536)
            if not ch:
                return data
            data += ch
        return data

    def test_chunked_response_relayed_and_keepalive(self, raw_stack):
        def handler(conn):
            self._read_head(conn)
            conn.sendall(b"HTTP/1.1 200 OK\r\ntransfer-encoding: chunked\r\n"
                         b"connection: close\r\n\r\n"
                         b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n")
            conn.close()

        raw_stack.handler_box["handler"] = handler
        c = socket.create_connection(("127.0.0.1", raw_stack.port),
                                     timeout=10)
        c.sendall(b"GET /c HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        data = b""
        c.settimeout(10)
        while b"0\r\n\r\n" not in data:
            data += c.recv(65536)
        assert data.startswith(b"HTTP/1.1 200")
        assert b"hello" in data and b" world" in data
        # upstream said connection: close, but the proxy reframes:
        # chunked framing lets the client connection stay alive.
        assert b"connection: keep-alive" in data.lower()
        c.sendall(b"GET /c2 HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        data2 = b""
        while b"0\r\n\r\n" not in data2:
            data2 += c.recv(65536)
        assert data2.startswith(b"HTTP/1.1 200")
        c.close()

    def test_100_continue_interim_passthrough(self, raw_stack):
        def handler(conn):
            head = self._read_head(conn)
            assert b"expect" in head.lower()
            conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
            # read the body (4 bytes)
            body = b""
            while len(body) < 4:
                body += conn.recv(1024)
            resp = b"got:" + body
            conn.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: " +
                         str(len(resp)).encode() + b"\r\n\r\n" + resp)
            conn.close()

        raw_stack.handler_box["handler"] = handler
        c = socket.create_connection(("127.0.0.1", raw_stack.port),
                                     timeout=10)
        c.sendall(b"POST /e HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                  b"expect: 100-continue\r\ncontent-length: 4\r\n\r\n")
        c.settimeout(10)
        interim = self._read_head(c)
        assert interim.startswith(b"HTTP/1.1 100")
        c.sendall(b"BODY")
        data = interim[len(b"HTTP/1.1 100 Continue\r\n\r\n"):]
        while b"got:BODY" not in data:
            ch = c.recv(65536)
            if not ch:
                break
            data += ch
        assert b"HTTP/1.1 200" in data and b"got:BODY" in data
        c.close()

    def test_half_closed_client_times_out_not_spins(self, raw_stack):
        """A client that half-closes mid-proxy must be reaped by the
        idle sweep (the EOF disarms the read side; no busy loop)."""
        def handler(conn):
            self._read_head(conn)
            time.sleep(30)  # upstream never answers
            conn.close()

        raw_stack.handler_box["handler"] = handler
        c = socket.create_connection(("127.0.0.1", raw_stack.port),
                                     timeout=10)
        c.sendall(b"GET /h HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n\r\n")
        time.sleep(0.3)
        c.shutdown(socket.SHUT_WR)  # half-close during proxying
        # The connection must not consume CPU; give the sweep a moment
        # and confirm the process is still healthy by a second request.
        time.sleep(1.2)
        data = raw_stack.handler_box  # keep reference
        c2 = socket.create_connection(("127.0.0.1", raw_stack.port),
                                      timeout=10)
        c2.sendall(b"GET /evil HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
                   b"connection: close\r\n\r\n")
        resp = b""
        c2.settimeout(10)
        try:
            while True:
                ch = c2.recv(65536)
                if not ch:
                    break
                resp += ch
        except socket.timeout:
            pass
        assert resp.startswith(b"HTTP/1.1 403")
        c.close()
        c2.close()
        assert data is raw_stack.handler_box


class TestNativeH2:
    """HTTP/2 on the C++ data plane (nghttp2 ABI shim): cleartext prior
    knowledge and TLS ALPN, per-stream verdicts through the ring."""

    @pytest.fixture(scope="class")
    def stack(self, tmp_path_factory):
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        st = NativeStack(tmp_path_factory.mktemp("nh2"), _block_rules())
        yield st
        st.stop()

    def _request(self, port, method, path, headers, body=b"", ssl_ctx=None,
                 server_hostname=None):
        import asyncio

        from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

        async def flow():
            conn = H2UpstreamConnection("127.0.0.1", port)
            await conn.connect(ssl=ssl_ctx, server_hostname=server_hostname)
            try:
                return await asyncio.wait_for(
                    conn.request(method, "t.test", path, headers, body), 10)
            finally:
                await conn.close()

        return asyncio.run(flow())

    def test_prior_knowledge_verdicts(self, stack):
        st, _, body = self._request(stack.port, "GET", "/ok",
                                    [("user-agent", "ua")])
        assert st == 200 and b"up:/ok" in body
        st, _, _ = self._request(stack.port, "GET", "/x?evil",
                                 [("user-agent", "ua")])
        assert st == 403

    def test_post_body_forwarded(self, stack):
        st, _, body = self._request(stack.port, "POST", "/p",
                                    [("user-agent", "ua")], b"h2-native")
        assert st == 200 and b"post:h2-native" in body

    def test_empty_ua_blocked(self, stack):
        st, _, _ = self._request(stack.port, "GET", "/", [])
        assert st == 403

    def test_multiplexed_streams_sequential_service(self, stack):
        import asyncio

        from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

        async def flow():
            conn = H2UpstreamConnection("127.0.0.1", stack.port)
            await conn.connect()
            try:
                return await asyncio.gather(
                    conn.request("GET", "t.test", "/a",
                                 [("user-agent", "ua")]),
                    conn.request("GET", "t.test", "/b?evil",
                                 [("user-agent", "ua")]),
                    conn.request("GET", "t.test", "/c",
                                 [("user-agent", "ua")]),
                )
            finally:
                await conn.close()

        a, b, c = asyncio.run(flow())
        assert a[0] == 200 and b"/a" in a[2]
        assert b[0] == 403
        assert c[0] == 200 and b"/c" in c[2]

    def test_h1_coexists(self, stack):
        data = raw_request(
            stack.port,
            b"GET /h1 HTTP/1.1\r\nhost: t\r\nuser-agent: ua\r\n"
            b"connection: close\r\n\r\n")
        assert data.startswith(b"HTTP/1.1 200") and b"up:/h1" in data


class TestNativeH2OverTls:
    def test_alpn_h2_and_verdicts(self, tmp_path):
        from pingoo_tpu_torch.host import h2 as h2mod
        from pingoo_tpu_torch.host.tlsmgr import generate_self_signed

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        tls_dir = tmp_path / "tls"
        tls_dir.mkdir()
        cert, key = generate_self_signed(["localhost"])
        (tls_dir / "default.pem").write_bytes(cert)
        (tls_dir / "default.key").write_bytes(key)
        stack = NativeStack(tmp_path, _block_rules(), tls_dir=str(tls_dir))
        try:
            import asyncio

            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            ctx.set_alpn_protocols(["h2"])

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", stack.port)
                await conn.connect(ssl=ctx, server_hostname="localhost")
                try:
                    ok = await asyncio.wait_for(
                        conn.request("GET", "t.test", "/tls",
                                     [("user-agent", "ua")]), 10)
                    bad = await asyncio.wait_for(
                        conn.request("GET", "t.test", "/x?evil",
                                     [("user-agent", "ua")]), 10)
                    return ok, bad
                finally:
                    await conn.close()

            ok, bad = asyncio.run(flow())
            assert ok[0] == 200 and b"up:/tls" in ok[2]
            assert bad[0] == 403
        finally:
            stack.stop()


class TestNativeH2ChunkedUpstream:
    def test_chunked_upstream_deframed(self, tmp_path):
        """An h1 upstream answering chunked must reach the h2 client as
        clean DATA frames (no chunk metadata leaking)."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")

        handler_box = {}
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)

        def serve():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                data = b""
                while b"\r\n\r\n" not in data:
                    ch = conn.recv(65536)
                    if not ch:
                        break
                    data += ch
                conn.sendall(b"HTTP/1.1 200 OK\r\n"
                             b"transfer-encoding: chunked\r\n\r\n"
                             b"5\r\nhello\r\n6\r\n-world\r\n0\r\n\r\n")
                conn.close()

        threading.Thread(target=serve, daemon=True).start()

        from pingoo_tpu_torch.compiler import compile_ruleset
        from pingoo_tpu_torch.native_ring import Ring, RingSidecar

        plan = compile_ruleset(_block_rules(), {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=256, create=True)
        sidecar = RingSidecar(ring, plan, {}, max_batch=32,
                              device="cpu")
        threading.Thread(target=sidecar.run, daemon=True).start()
        port = _free_port()
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "ring"), "127.0.0.1",
             str(lsock.getsockname()[1])], stdout=subprocess.PIPE)
        assert b"listening" in proc.stdout.readline()
        try:
            import asyncio

            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", port)
                await conn.connect()
                try:
                    return await asyncio.wait_for(
                        conn.request("GET", "t.test", "/c",
                                     [("user-agent", "ua")]), 10)
                finally:
                    await conn.close()

            status, headers, body = asyncio.run(flow())
            assert status == 200
            assert body == b"hello-world"  # de-chunked, exact payload
        finally:
            proc.kill()
            proc.wait()
            lsock.close()
            sidecar.stop()
            ring.close()


class TestNativeH2StreamEdges:
    """h2 proxying edge behavior against hand-rolled upstreams/clients:
    truncated upstream bodies and stalled (non-reading) clients."""

    def test_truncated_cl_response_resets_stream(self, tmp_path):
        """An upstream dying mid content-length body must NOT become a
        well-formed short response over h2 — the stream is reset so the
        client can see the failure."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")

        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)

        def serve():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                data = b""
                while b"\r\n\r\n" not in data:
                    ch = conn.recv(65536)
                    if not ch:
                        break
                    data += ch
                conn.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: 1000"
                             b"\r\n\r\npartial")
                conn.close()  # truncated

        threading.Thread(target=serve, daemon=True).start()

        from pingoo_tpu_torch.compiler import compile_ruleset
        from pingoo_tpu_torch.native_ring import Ring, RingSidecar

        plan = compile_ruleset(_block_rules(), {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=256, create=True)
        sidecar = RingSidecar(ring, plan, {}, max_batch=32,
                              device="cpu")
        threading.Thread(target=sidecar.run, daemon=True).start()
        port = _free_port()
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "ring"), "127.0.0.1",
             str(lsock.getsockname()[1])], stdout=subprocess.PIPE)
        assert b"listening" in proc.stdout.readline()
        try:
            import asyncio

            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", port)
                await conn.connect()
                try:
                    with pytest.raises(ConnectionError, match="reset"):
                        await asyncio.wait_for(
                            conn.request("GET", "t.test", "/t",
                                         [("user-agent", "ua")]), 10)
                finally:
                    await conn.close()

            asyncio.run(flow())
        finally:
            proc.kill()
            proc.wait()
            lsock.close()
            sidecar.stop()
            ring.close()


    def test_interim_1xx_forwarded_on_h2(self, tmp_path):
        """An upstream 100 Continue must be relayed as a non-final h2
        HEADERS (hyper forwards interim responses) without corrupting
        the final response on the same stream."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")

        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)

        def serve():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                data = b""
                while b"\r\n\r\n" not in data:
                    ch = conn.recv(65536)
                    if not ch:
                        break
                    data += ch
                conn.sendall(
                    b"HTTP/1.1 100 Continue\r\nserver: leaky\r\n\r\n"
                    b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n\r\nok")
                conn.close()

        threading.Thread(target=serve, daemon=True).start()

        from pingoo_tpu_torch.compiler import compile_ruleset

        plan = compile_ruleset(_block_rules(), {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=256, create=True)
        sidecar = RingSidecar(ring, plan, {}, max_batch=32,
                              device="cpu")
        threading.Thread(target=sidecar.run, daemon=True).start()
        port = _free_port()
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "ring"), "127.0.0.1",
             str(lsock.getsockname()[1])], stdout=subprocess.PIPE)
        assert b"listening" in proc.stdout.readline()
        try:
            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", port)
                await conn.connect()
                try:
                    return await asyncio.wait_for(
                        conn.request("GET", "t.test", "/t",
                                     [("user-agent", "ua")]), 10)
                finally:
                    await conn.close()

            st, headers, body = asyncio.run(flow())
            assert st == 200 and body == b"ok"
            # the interim head's identity header must not leak through
            assert ("server", "leaky") not in headers
        finally:
            proc.kill()
            proc.wait()
            lsock.close()
            sidecar.stop()
            ring.close()

    def test_stalled_client_bounds_buffering(self, tmp_path):
        """h2 client-side backpressure: a client that raises its
        flow-control windows sky-high and then never reads its socket
        must NOT make httpd buffer the upstream response without bound.
        h2_flush stops pulling frames at the outbuf cap and
        h2_update_stream_events pauses the upstream read, so the bytes
        httpd drains from an endless upstream plateau near
        kMaxBuffered + kH2PendingCap + kernel socket buffers."""
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)
        sent = [0]

        def serve():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                data = b""
                while b"\r\n\r\n" not in data:
                    ch = conn.recv(65536)
                    if not ch:
                        break
                    data += ch
                # Endless EOF-framed response: stream until the proxy
                # stops reading (send blocks) or the test tears down.
                try:
                    conn.sendall(b"HTTP/1.1 200 OK\r\n\r\n")
                    chunk = b"x" * 65536
                    conn.settimeout(1.0)
                    while True:
                        conn.sendall(chunk)
                        sent[0] += len(chunk)
                except OSError:
                    pass
                finally:
                    conn.close()

        threading.Thread(target=serve, daemon=True).start()

        from pingoo_tpu_torch.compiler import compile_ruleset

        plan = compile_ruleset(_block_rules(), {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=256, create=True)
        sidecar = RingSidecar(ring, plan, {}, max_batch=32,
                              device="cpu")
        threading.Thread(target=sidecar.run, daemon=True).start()
        port = _free_port()
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "ring"), "127.0.0.1",
             str(lsock.getsockname()[1])], stdout=subprocess.PIPE)
        assert b"listening" in proc.stdout.readline()
        c = None
        try:
            # Hand-rolled h2 client: preface, SETTINGS raising
            # INITIAL_WINDOW_SIZE to max, a huge connection
            # WINDOW_UPDATE, one GET — then never read.
            def frame(ftype, flags, stream, payload):
                return (len(payload).to_bytes(3, "big")
                        + bytes([ftype, flags])
                        + stream.to_bytes(4, "big") + payload)

            settings = frame(0x4, 0, 0,
                             (4).to_bytes(2, "big")
                             + (2**31 - 1).to_bytes(4, "big"))
            winupd = frame(0x8, 0, 0, (2**30).to_bytes(4, "big"))
            hpack = (b"\x82"            # :method GET (static 2)
                     b"\x86"            # :scheme http (static 6)
                     b"\x44\x04/big"    # :path literal, name static 4
                     b"\x41\x06t.test"  # :authority
                     b"\x7a\x02ua")     # user-agent
            headers = frame(0x1, 0x5, 1, hpack)  # END_STREAM|END_HEADERS
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            # Shrink our receive buffer so the kernel absorbs little on
            # the stalled side and httpd's caps do the bounding.
            c.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
            c.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
                      + settings + winupd + headers
                      + frame(0x4, 0x1, 0, b""))  # ack server SETTINGS
            # Wait for the verdict + proxying to start, then give the
            # upstream time to push as much as httpd will take.
            deadline = time.time() + 20
            last = -1
            while time.time() < deadline:
                time.sleep(1.0)
                if sent[0] == last and sent[0] > 0:
                    break  # upstream send has blocked: backpressure
                last = sent[0]
            # kMaxBuffered (1 MiB) + kH2PendingCap (256 KiB) + kernel
            # socket buffers on both hops; 16 MiB of headroom vs the
            # endless stream proves the read side actually paused.
            assert 0 < sent[0] < 16 * 1024 * 1024, sent[0]
        finally:
            if c is not None:
                c.close()
            proc.kill()
            proc.wait()
            lsock.close()
            sidecar.stop()
            ring.close()


class _TaggedUpstream(http.server.BaseHTTPRequestHandler):
    """Echoes its server's tag so routing tests can see which upstream
    serviced the request."""

    protocol_version = "HTTP/1.1"

    def do_GET(self):
        delay = getattr(self.server, "delay_s", 0)
        if delay:
            time.sleep(delay)
        body = f"{self.server.tag}:{self.path}".encode()
        self.send_response(200)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def _tagged_upstream(tag, delay_s=0):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _TaggedUpstream)
    srv.tag = tag
    srv.delay_s = delay_s
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class TestNativeRouting:
    """VERDICT r2 item 1: the native plane as the front door — per-request
    service routing from the verdict byte's route bits, registry-fed
    multi-upstream with hot reload, and SIGTERM drain. Reference:
    http_listener.rs:266-270 (first matching service),
    http_proxy_service.rs:101,118 (random upstream), listeners/mod.rs:28
    (drain cap)."""

    def _routes(self):
        from pingoo_tpu_torch.expr import compile_expression

        return [("api", compile_expression(
                    'http_request.path.starts_with("/api")')),
                ("web", None)]  # no route -> match-all fallback

    def _get(self, port, path, timeout=8.0):
        payload = (f"GET {path} HTTP/1.1\r\nhost: t.test\r\n"
                   "user-agent: routed/1.0\r\nconnection: close\r\n\r\n")
        return raw_request(port, payload.encode())

    def _get_until(self, port, path, want: bytes, tries=25):
        """Retry until routing reflects `want` (first requests may fail
        open to service 0 while the sidecar's first batch compiles)."""
        out = b""
        for _ in range(tries):
            out = self._get(port, path)
            if want in out:
                return out
            time.sleep(0.4)
        return out

    def test_two_services_routed_and_hot_swapped(self, tmp_path):
        a = _tagged_upstream("svc-a")
        b = _tagged_upstream("svc-b")
        c = _tagged_upstream("svc-c")
        services = [("api", [("127.0.0.1", a.server_address[1])]),
                    ("web", [("127.0.0.1", b.server_address[1])])]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services)
        try:
            out = self._get_until(stack.port, "/api/v1", b"svc-a")
            assert b"svc-a:/api/v1" in out, out[:200]
            out = self._get(stack.port, "/index.html")
            assert b"svc-b:/index.html" in out, out[:200]
            # hot swap: the registry repoints api at svc-c; the C++ plane
            # reloads the table on mtime change without restarting
            native_ring.write_services_file(
                stack.services_path,
                [("api", [("127.0.0.1", c.server_address[1])]),
                 ("web", [("127.0.0.1", b.server_address[1])])])
            out = self._get_until(stack.port, "/api/v2", b"svc-c")
            assert b"svc-c:/api/v2" in out, out[:200]
            # web unaffected by the swap
            out = self._get(stack.port, "/w")
            assert b"svc-b:/w" in out, out[:200]
        finally:
            stack.stop()
            for srv in (a, b, c):
                srv.shutdown()

    def test_random_upstream_choice_spreads(self, tmp_path):
        a1 = _tagged_upstream("m1")
        a2 = _tagged_upstream("m2")
        services = [("api", [("127.0.0.1", a1.server_address[1]),
                             ("127.0.0.1", a2.server_address[1])]),
                    ("web", [("127.0.0.1", a1.server_address[1])])]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services)
        try:
            self._get_until(stack.port, "/api/x", b"m")
            seen = set()
            for _ in range(40):
                out = self._get(stack.port, "/api/x")
                if b"m1:" in out:
                    seen.add("m1")
                if b"m2:" in out:
                    seen.add("m2")
                if len(seen) == 2:
                    break
            assert seen == {"m1", "m2"}, seen
        finally:
            stack.stop()
            a1.shutdown()
            a2.shutdown()

    def test_no_matching_service_404(self, tmp_path):
        from pingoo_tpu_torch.expr import compile_expression

        a = _tagged_upstream("only")
        routes = [("api", compile_expression(
            'http_request.path.starts_with("/api")'))]
        services = [("api", [("127.0.0.1", a.server_address[1])])]
        stack = NativeStack(tmp_path, rules=[], routes=routes,
                            services=services)
        try:
            out = self._get_until(stack.port, "/api/ok", b"only")
            assert b"only:/api/ok" in out
            out = self._get(stack.port, "/nope")
            assert out.split(b"\r\n")[0].endswith(b"404 Not Found"), out[:80]
        finally:
            stack.stop()
            a.shutdown()

    def test_sigterm_drains_in_flight_request(self, tmp_path):
        import signal

        slow = _tagged_upstream("slow", delay_s=1.0)
        services = [("api", [("127.0.0.1", slow.server_address[1])]),
                    ("web", [("127.0.0.1", slow.server_address[1])])]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services)
        try:
            # warm the verdict path so the in-flight request is verdicted
            self._get_until(stack.port, "/warm", b"slow")
            conn = socket.create_connection(("127.0.0.1", stack.port),
                                            timeout=10)
            conn.sendall(b"GET /slow HTTP/1.1\r\nhost: t\r\n"
                         b"user-agent: u\r\n\r\n")
            time.sleep(0.3)  # request reaches the upstream
            stack.proc.send_signal(signal.SIGTERM)
            data = b""
            conn.settimeout(10)
            try:
                while b"slow:/slow" not in data:
                    ch = conn.recv(4096)
                    if not ch:
                        break
                    data += ch
            except socket.timeout:
                pass
            assert b"slow:/slow" in data, data[:200]  # drained, not dropped
            rc = stack.proc.wait(timeout=10)
            assert rc == 0
            conn.close()
        finally:
            if stack.proc.poll() is None:
                stack.stop()
            else:
                stack.upstream.shutdown()
                stack.sidecar.stop()
                stack.ring.close()
            slow.shutdown()


class TestUpstreamPooling:
    """Pooled keep-alive upstream connections: sequential proxied
    requests must reuse the upstream connection instead of opening one
    per request (reference pools its client, http_proxy_service.rs:54-71)."""

    def test_sequential_requests_reuse_upstream_connection(self, tmp_path):
        accepts = []

        class CountingUpstream(http.server.ThreadingHTTPServer):
            def get_request(self):
                req = super().get_request()
                accepts.append(req[1])
                return req

        srv = CountingUpstream(("127.0.0.1", 0), _TaggedUpstream)
        srv.tag = "pool"
        srv.delay_s = 0
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        stack = NativeStack(tmp_path, rules=[])
        # point httpd at the counting upstream instead of the stack's
        stack.proc.kill()
        stack.proc.wait()
        stack.proc = subprocess.Popen(
            [HTTPD, str(stack.port), stack.ring_path, "127.0.0.1",
             str(srv.server_address[1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        assert b"listening" in stack.proc.stdout.readline()
        try:
            n = 12
            ok = 0
            for i in range(n):
                out = raw_request(
                    stack.port,
                    f"GET /r{i} HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    "connection: close\r\n\r\n".encode())
                if f"pool:/r{i}".encode() in out:
                    ok += 1
            assert ok == n, (ok, n)
            # All 12 proxied requests over a handful of pooled upstream
            # connections (first request per idle moment may open one).
            assert len(accepts) < n, (len(accepts), n)
        finally:
            stack.stop()
            srv.shutdown()


class TestOverflowFieldParity:
    """VERDICT r2 item 5: a >2048-byte URL must still match content
    rules past the slot cap when fronted by the C++ plane — the spill
    side-channel carries the full strings to the sidecar."""

    def test_4kb_url_blocked_beyond_slot_cap(self, tmp_path):
        from pingoo_tpu_torch.config.schema import Action, RuleConfig
        from pingoo_tpu_torch.expr import compile_expression

        rules = [RuleConfig(
            name="deep", actions=(Action.BLOCK,),
            expression=compile_expression(
                'http_request.url.contains("XNEEDLEX")'))]
        stack = NativeStack(tmp_path, rules)
        try:
            deep = "/" + "a" * 4000 + "XNEEDLEX"  # marker past byte 2048
            out = raw_request(
                stack.port,
                (f"GET {deep} HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                 "connection: close\r\n\r\n").encode())
            assert out.split(b"\r\n")[0].endswith(b"403 Forbidden"), out[:80]
            # same-shape clean URL still proxied
            clean = "/" + "a" * 4000 + "ZZZZ"
            out = raw_request(
                stack.port,
                (f"GET {clean} HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                 "connection: close\r\n\r\n").encode())
            assert b"200" in out.split(b"\r\n")[0], out[:80]
            assert stack.sidecar.spilled_rows >= 2
        finally:
            stack.stop()


class TestNativeMetrics:
    """VERDICT r2 item 8: the native plane and the ring sidecar — the
    actual serving path — expose their own metrics."""

    def test_metrics_endpoint_and_sidecar_stats(self, tmp_path):
        stack = NativeStack(tmp_path, _block_rules())
        try:
            for path, ua in (("/ok", "u"), ("/x-evil", "u"), ("/ok2", "u"),
                             ("/noua", "")):
                h = (f"GET {path} HTTP/1.1\r\nhost: t\r\n" +
                     (f"user-agent: {ua}\r\n" if ua else "") +
                     "connection: close\r\n\r\n")
                raw_request(stack.port, h.encode())
            out = raw_request(
                stack.port,
                b"GET /__pingoo/metrics HTTP/1.1\r\nhost: t\r\n"
                b"user-agent: u\r\naccept: application/json\r\n"
                b"connection: close\r\n\r\n")
            head, _, body = out.partition(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            m = json.loads(body)
            assert m["requests"] >= 3
            assert m["blocked"] >= 1          # /x-evil
            assert m["ua_rejected"] >= 1      # /noua
            assert m["verdicts"] >= 3
            hist_total = sum(m["verdict_wait_ms_hist"].values())
            assert hist_total == m["verdicts"]
            assert "ring_pending" in m and "pooled_upstreams" in m
            # shm ring telemetry block (ring v4) rides the same scrape.
            assert m["ring"]["enqueued"] >= 3
            assert m["ring"]["verdicts_posted"] >= 3
            assert m["ring"]["depth_hwm"] >= 1
            # Default exposition (no Accept) is Prometheus text with
            # the shared metric names.
            out = raw_request(
                stack.port,
                b"GET /__pingoo/metrics HTTP/1.1\r\nhost: t\r\n"
                b"user-agent: u\r\nconnection: close\r\n\r\n")
            head, _, body = out.partition(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            assert b"text/plain" in head
            text = body.decode()
            assert "pingoo_requests_total{plane=\"native\"}" in text
            assert "pingoo_verdict_wait_ms_bucket" in text
            from pingoo_tpu.obs.registry import lint_prometheus_text

            assert lint_prometheus_text(text) == []
            st = stack.sidecar.stats()
            assert st["processed"] >= 3
            assert st["batches"] >= 1
            assert st["batch_occupancy"] > 0
            assert st["device_wait_ms_per_batch"] >= 0
            assert st["ring_telemetry"]["dequeued"] >= 3
        finally:
            stack.stop()


def _ws_echo_upstream():
    """Minimal upgrade-accepting upstream: answers the RFC 6455
    handshake and echoes raw bytes after the 101."""
    import base64
    import hashlib

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=handle, args=(c,), daemon=True).start()

    def handle(c):
        data = b""
        while b"\r\n\r\n" not in data:
            ch = c.recv(4096)
            if not ch:
                c.close()
                return
            data += ch
        head, _, rest = data.partition(b"\r\n\r\n")
        key = b""
        for ln in head.split(b"\r\n"):
            if ln.lower().startswith(b"sec-websocket-key:"):
                key = ln.split(b":", 1)[1].strip()
        accept = base64.b64encode(hashlib.sha1(
            key + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
        c.sendall(b"HTTP/1.1 101 Switching Protocols\r\n"
                  b"upgrade: websocket\r\nconnection: Upgrade\r\n"
                  b"sec-websocket-accept: " + accept + b"\r\n\r\n")
        if rest:
            c.sendall(rest)  # echo early frames
        while True:
            try:
                ch = c.recv(4096)
            except OSError:
                break
            if not ch:
                break
            c.sendall(ch)
        c.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv


class TestWebSocketPassthrough:
    """VERDICT r2 item 9: Upgrade requests tunnel through the plane
    after the verdict instead of losing their Upgrade headers."""

    def test_ws_echo_through_native_plane(self, tmp_path):
        ws = _ws_echo_upstream()
        stack = NativeStack(tmp_path, _block_rules())
        stack.proc.kill()
        stack.proc.wait()
        stack.proc = subprocess.Popen(
            [HTTPD, str(stack.port), stack.ring_path, "127.0.0.1",
             str(ws.getsockname()[1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        assert b"listening" in stack.proc.stdout.readline()
        try:
            c = socket.create_connection(("127.0.0.1", stack.port),
                                         timeout=10)
            c.sendall(b"GET /chat HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                      b"connection: Upgrade\r\nupgrade: websocket\r\n"
                      b"sec-websocket-key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                      b"sec-websocket-version: 13\r\n\r\n")
            head = b""
            c.settimeout(10)
            while b"\r\n\r\n" not in head:
                head += c.recv(4096)
            assert head.startswith(b"HTTP/1.1 101"), head[:120]
            assert b"sec-websocket-accept:" in head.lower()
            payload, _, early = head.partition(b"\r\n\r\n")
            # raw bytes flow both directions after the 101
            c.sendall(b"\x81\x05hello")  # a ws text frame (unmasked test)
            got = early
            while len(got) < 7:
                got += c.recv(4096)
            assert got == b"\x81\x05hello", got
            c.sendall(b"ping2")
            got = b""
            while len(got) < 5:
                got += c.recv(4096)
            assert got == b"ping2"
            c.close()
            # a blocked path is still blocked before any upgrade
            out = raw_request(
                stack.port,
                b"GET /x-evil HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                b"connection: Upgrade\r\nupgrade: websocket\r\n"
                b"connection: close\r\n\r\n")
            assert b"403" in out.split(b"\r\n")[0]
        finally:
            stack.stop()
            ws.close()


class _DelayEchoUpstream(http.server.BaseHTTPRequestHandler):
    """Path-programmable upstream: /slow waits 1s; /big streams 4 MiB."""

    protocol_version = "HTTP/1.1"

    def do_GET(self):
        if self.path.startswith("/slow"):
            time.sleep(1.0)
        if self.path.startswith("/big"):
            size = 4 * 1024 * 1024
            self.send_response(200)
            self.send_header("content-length", str(size))
            self.end_headers()
            chunk = b"B" * 65536
            sent = 0
            while sent < size:
                self.wfile.write(chunk)
                sent += len(chunk)
            return
        body = f"resp:{self.path}".encode()
        self.send_response(200)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class TestH2ConcurrentStreaming:
    """VERDICT r2 item 6: h2 streams are serviced CONCURRENTLY (a slow
    stream must not head-of-line block its siblings) and response bodies
    STREAM (a response larger than the old 1 MiB whole-buffer cap must
    arrive intact)."""

    def _stack(self, tmp_path):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                              _DelayEchoUpstream)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        stack = NativeStack(tmp_path, _block_rules())
        stack.proc.kill()
        stack.proc.wait()
        stack.proc = subprocess.Popen(
            [HTTPD, str(stack.port), stack.ring_path, "127.0.0.1",
             str(srv.server_address[1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        assert b"listening" in stack.proc.stdout.readline()
        return srv, stack

    def test_slow_stream_does_not_block_fast_sibling(self, tmp_path):
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

        srv, stack = self._stack(tmp_path)
        loop = asyncio.new_event_loop()
        try:
            async def run():
                conn = H2UpstreamConnection("127.0.0.1", stack.port)
                await conn.connect()
                order = []

                async def one(path, tag):
                    st, _, body = await conn.request(
                        "GET", "t.test", path, [("user-agent", "ua")], b"")
                    order.append(tag)
                    return st, body

                # the slow stream FIRST, so sequential servicing would
                # finish it before the fast one
                slow = asyncio.create_task(one("/slow/a", "slow"))
                await asyncio.sleep(0.15)  # slow stream reaches upstream
                fast = asyncio.create_task(one("/fast/b", "fast"))
                (s_st, s_body), (f_st, f_body) = await asyncio.gather(
                    slow, fast)
                await conn.close()
                assert s_st == 200 and b"resp:/slow/a" in s_body
                assert f_st == 200 and b"resp:/fast/b" in f_body
                return order

            order = loop.run_until_complete(asyncio.wait_for(run(), 60))
            assert order[0] == "fast", order  # no head-of-line blocking
        finally:
            loop.close()
            stack.stop()
            srv.shutdown()

    def test_big_response_streams_past_buffer_cap(self, tmp_path):
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

        srv, stack = self._stack(tmp_path)
        loop = asyncio.new_event_loop()
        try:
            async def run():
                conn = H2UpstreamConnection("127.0.0.1", stack.port)
                await conn.connect()
                st, headers, body = await conn.request(
                    "GET", "t.test", "/big", [("user-agent", "ua")], b"")
                await conn.close()
                return st, body

            st, body = loop.run_until_complete(asyncio.wait_for(run(), 120))
            assert st == 200
            assert len(body) == 4 * 1024 * 1024  # > the old 1 MiB cap
            assert body[:4] == b"BBBB" and body[-4:] == b"BBBB"
        finally:
            loop.close()
            stack.stop()
            srv.shutdown()


class TestSidecarGeoEnrichment:
    """The C++ plane enqueues asn=0/country=XX (it has no mmdb decoder);
    the sidecar must fill real geo columns before the verdict so geo/asn
    rules fire for natively fronted traffic (reference resolves geoip in
    the listener, http_listener.rs:143-157)."""

    def test_geo_rule_fires_via_ring(self, tmp_path):
        import ipaddress

        from pingoo_tpu_torch.compiler import compile_ruleset
        from pingoo_tpu_torch.config.schema import Action, RuleConfig
        from pingoo_tpu_torch.expr import compile_expression
        from pingoo_tpu_torch.host.geoip import GeoipDB, MmdbReader, build_mmdb

        mmdb = build_mmdb({
            "203.0.113.0/24": {
                "country": {"iso_code": "ZZ"},
                "autonomous_system_number": 64999,
            },
        })
        geoip = GeoipDB(MmdbReader(mmdb))
        rules = [
            RuleConfig(name="geo", actions=(Action.BLOCK,),
                       expression=compile_expression(
                           'client.country == "ZZ"')),
            RuleConfig(name="asn", actions=(Action.BLOCK,),
                       expression=compile_expression(
                           "client.asn == 64999")),
        ]
        plan = compile_ruleset(rules, {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=64, create=True)
        try:
            ip_in = (b"\x00" * 10 + b"\xff\xff"
                     + ipaddress.ip_address("203.0.113.7").packed)
            ip_out = (b"\x00" * 10 + b"\xff\xff"
                      + ipaddress.ip_address("198.51.100.9").packed)
            t_hit = ring.enqueue(method=b"GET", host=b"h", path=b"/",
                                 url=b"/", user_agent=b"ua", ip=ip_in,
                                 port=2000)
            t_miss = ring.enqueue(method=b"GET", host=b"h", path=b"/",
                                  url=b"/", user_agent=b"ua", ip=ip_out,
                                  port=2000)
            sidecar = RingSidecar(ring, plan, {}, max_batch=8,
                                  geoip=geoip, device="cpu")
            sidecar.run(max_requests=2)
            got = {}
            while True:
                v = ring.poll_verdict()
                if v is None:
                    break
                got[v[0]] = v[1]
            assert got[t_hit] & 3 == 1, got  # ZZ/64999 -> block
            assert got[t_miss] & 3 == 0, got  # not in the mmdb -> none
        finally:
            ring.close()

    def test_no_geoip_keeps_markers(self, tmp_path):
        import ipaddress

        from pingoo_tpu_torch.compiler import compile_ruleset
        from pingoo_tpu_torch.config.schema import Action, RuleConfig
        from pingoo_tpu_torch.expr import compile_expression

        rules = [RuleConfig(name="geo", actions=(Action.BLOCK,),
                            expression=compile_expression(
                                'client.country == "ZZ"'))]
        plan = compile_ruleset(rules, {}, device="cpu")
        ring = Ring(str(tmp_path / "ring"), capacity=64, create=True)
        try:
            ip = (b"\x00" * 10 + b"\xff\xff"
                  + ipaddress.ip_address("203.0.113.7").packed)
            t = ring.enqueue(method=b"GET", host=b"h", path=b"/", url=b"/",
                             user_agent=b"ua", ip=ip, port=2000)
            sidecar = RingSidecar(ring, plan, {}, max_batch=8,
                                  device="cpu")  # geoip=None
            sidecar.run(max_requests=1)
            v = ring.poll_verdict()
            assert v is not None and v[0] == t and v[1] & 3 == 0
        finally:
            ring.close()


class TestNativePlaneRunner:
    """Production wiring (host/native_plane.py): config in, C++ front
    door + loopback Python plane + sidecar + services republisher out."""

    def _write_config(self, tmp_path, port, up_port):
        import textwrap

        cfg = tmp_path / "pingoo.yml"
        cfg.write_text(textwrap.dedent(f"""
        listeners:
          main:
            address: "http://127.0.0.1:{port}"
        services:
          app:
            http_proxy: ["http://127.0.0.1:{up_port}"]
        rules:
          block-env:
            expression: http_request.path.starts_with("/.env")
            actions: [{{action: block}}]
          block-xss:
            expression: http_request.url.contains("<script")
            actions: [{{action: block}}]
        """))
        return cfg

    def test_end_to_end(self, tmp_path, loop_runner):
        import urllib.request

        from pingoo_tpu_torch.config import load_and_validate
        from pingoo_tpu_torch.host.native_plane import NativePlane

        upstream = http.server.HTTPServer(("127.0.0.1", 0), _Upstream)
        threading.Thread(target=upstream.serve_forever, daemon=True).start()
        port = _free_port()
        config = load_and_validate(str(self._write_config(
            tmp_path, port, upstream.server_address[1])))
        plane = NativePlane(
            config, state_dir=str(tmp_path / "state"), device="cpu",
            enable_docker=False,
            geoip_paths=(str(tmp_path / "missing.mmdb"),),
            captcha_jwks_path=str(tmp_path / "jwks.json"),
            tls_dir=str(tmp_path / "tls"))
        loop_runner.run(plane.start(), timeout=180)
        try:
            def get(path):
                # accept json keeps the metrics scrape on the legacy
                # schema (the default exposition is Prometheus now).
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    headers={"accept": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()
                except (urllib.error.URLError, OSError) as e:
                    # connection-level blips retry like wrong statuses
                    return None, repr(e).encode()

            def get_until(path, want_status, timeout_s=60):
                # Verdicts fail OPEN past their deadline by design; on
                # a heavily loaded host a blocked probe can slip
                # through while a competing compile hogs the core —
                # poll so the test asserts the policy, not the load.
                deadline = time.time() + timeout_s
                while True:
                    status, body = get(path)
                    if status == want_status or time.time() > deadline:
                        return status, body
                    time.sleep(0.5)

            status, body = get_until("/hello", 200)
            assert status == 200 and body == b"up:/hello", (status, body)
            status, _ = get_until("/.env", 403, 30)
            assert status == 403
            status, _ = get_until("/p?x=<script>alert(1)</script>", 403, 30)
            assert status == 403
            # Native metrics surface reachable on the public port.
            status, body = get_until("/__pingoo/metrics", 200, 30)
            assert status == 200
            stats = json.loads(body)
            assert stats["blocked"] >= 2 and stats["verdicts"] >= 3
            assert plane.procs and all(
                p.poll() is None for p in plane.procs)
        finally:
            loop_runner.run(plane.stop(), timeout=60)
        assert all(p.poll() is not None for p in plane.procs)


class TestNativePlaneWiring:
    def test_tcp_listeners_keep_public_address(self):
        import dataclasses

        from pingoo_tpu_torch.config.schema import (Config, ListenerConfig,
                                              ListenerProtocol,
                                              ServiceConfig, Upstream)
        from pingoo_tpu_torch.host.native_plane import _loopback_rebase

        up = Upstream(hostname="127.0.0.1", port=9, tls=False, ip="127.0.0.1")
        config = Config(
            listeners=(
                ListenerConfig(name="web", host="0.0.0.0", port=8080,
                               protocol=ListenerProtocol.HTTP,
                               services=("app",)),
                ListenerConfig(name="db", host="0.0.0.0", port=5432,
                               protocol=ListenerProtocol.TCP,
                               services=("dbsvc",)),
            ),
            services=(
                ServiceConfig(name="app", http_proxy=(up,)),
                ServiceConfig(name="dbsvc", tcp_proxy=(up,)),
            ),
            rules=(), lists=())
        rebased = _loopback_rebase(config)
        by_name = {l.name: l for l in rebased.listeners}
        assert by_name["web"].host == "127.0.0.1"
        # Port 0: the kernel assigns at bind (no pick-then-rebind race);
        # NativePlane reads the real port back after Server.start().
        assert by_name["web"].port == 0
        # TCP listeners are fronted by the C++ plane in tcp-proxy mode
        # (round 5): the Python plane no longer binds them at all.
        assert "db" not in by_name

    def test_tls_and_h2_upstreams_published_natively(self, tmp_path):
        """TLS upstreams ride the native connector (round 4); h2://
        prior-knowledge upstreams are table-marked `h2` and ride the
        native nghttp2 client (round 5) — no loopback detours left for
        proxy upstreams."""
        from pingoo_tpu_torch.config.schema import (Config, ListenerConfig,
                                              ListenerProtocol,
                                              ServiceConfig, Upstream)
        from pingoo_tpu_torch.host.native_plane import NativePlane

        tls_up = Upstream(hostname="backend.test", port=443, tls=True,
                          ip="1.2.3.4")
        h2_up = Upstream(hostname="1.2.3.5", port=8443, tls=False,
                         ip="1.2.3.5", h2=True)
        plain_up = Upstream(hostname="127.0.0.1", port=9, tls=False,
                            ip="127.0.0.1")
        config = Config(
            listeners=(ListenerConfig(
                name="web", host="127.0.0.1", port=_free_port(),
                protocol=ListenerProtocol.HTTP,
                services=("sec", "h2svc", "plain")),),
            services=(ServiceConfig(name="sec", http_proxy=(tls_up,)),
                      ServiceConfig(name="h2svc", http_proxy=(h2_up,)),
                      ServiceConfig(name="plain", http_proxy=(plain_up,))),
            rules=(), lists=())
        plane = NativePlane(config, state_dir=str(tmp_path / "st"),
                            device="cpu")
        plane._listener_services = {"web": ["sec", "h2svc", "plain"]}
        plane.services_paths = {"web": str(tmp_path / "st" / "web.tbl")}
        plane._loopback_ports = {"web": 54321}  # as read back post-bind

        class FakeRegistry:
            def get_upstreams(self, name):
                return {"sec": [tls_up], "h2svc": [h2_up],
                        "plain": [plain_up]}[name]

        plane.server.registry = FakeRegistry()
        os.makedirs(plane.state_dir, exist_ok=True)
        plane._write_services()
        # Parse the table back into {service: [upstream line parts]}.
        table = {}
        current = None
        for line in open(plane.services_paths["web"]).read(
                ).strip().splitlines():
            parts = line.split()
            if parts[0] == "service":
                current = parts[2]
                table[current] = []
            elif parts[0] == "upstream":
                table[current].append(tuple(parts[1:]))
        # TLS upstream: native, with the configured name for SNI/verify.
        assert table["sec"] == [("1.2.3.4", "443", "tls", "backend.test")]
        # h2 prior-knowledge: native nghttp2 client, no loopback hop.
        assert table["h2svc"] == [("1.2.3.5", "8443", "h2")]
        assert table["plain"] == [("127.0.0.1", "9")]


# -- TLS upstream hop (round 4, VERDICT r3 item 2) ---------------------------
# The C++ connector dials `tls`-marked table entries itself: OpenSSL
# client with SNI + mandatory verification against --upstream-ca (or the
# system roots), pooled like plaintext links. Reference semantics:
# http_proxy_service.rs:54-71 (pooled hyper-rustls client, no insecure
# mode; upstream connect/handshake failure -> 502 :192-195).


def _mini_ca():
    """-> (ca_cert_pem, ca_key): a one-off issuing CA."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "pingoo-test-ca")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=7))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    from cryptography.hazmat.primitives import serialization

    return cert.public_bytes(serialization.Encoding.PEM), key


def _issue(ca_pem, ca_key, sans):
    """CA-signed leaf for `sans` (DNS names or IP literals)."""
    import datetime
    import ipaddress as ipa

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    ca_cert = x509.load_pem_x509_certificate(ca_pem)
    key = ec.generate_private_key(ec.SECP256R1())
    alt = []
    for s in sans:
        try:
            alt.append(x509.IPAddress(ipa.ip_address(s)))
        except ValueError:
            alt.append(x509.DNSName(s))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, sans[0])]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=7))
        .add_extension(x509.SubjectAlternativeName(alt), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    key_pem = key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    return cert.public_bytes(serialization.Encoding.PEM), key_pem


def _tls_tagged_upstream(tag, tmp, cert_pem, key_pem, stem):
    cert_path = str(tmp / f"{stem}.pem")
    key_path = str(tmp / f"{stem}.key")
    open(cert_path, "wb").write(cert_pem)
    open(key_path, "wb").write(key_pem)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _TaggedUpstream)
    srv.tag = tag
    srv.delay_s = 0
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    # Handshake failures from intentionally-mistrusting clients land in
    # handler threads; keep them out of the test log.
    srv.handle_error = lambda *a: None
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class TestTlsUpstreamNative:
    def _routes(self):
        from pingoo_tpu_torch.expr import compile_expression

        return [("api", compile_expression(
                    'http_request.path.starts_with("/api")')),
                ("web", None)]

    def _get(self, port, path):
        payload = (f"GET {path} HTTP/1.1\r\nhost: t.test\r\n"
                   "user-agent: routed/1.0\r\nconnection: close\r\n\r\n")
        return raw_request(port, payload.encode())

    def _get_until(self, port, path, want, tries=25):
        out = b""
        for _ in range(tries):
            out = self._get(port, path)
            if want in out:
                return out
            time.sleep(0.4)
        return out

    def _metrics(self, port):
        out = raw_request(
            port,
            b"GET /__pingoo/metrics HTTP/1.1\r\nhost: t\r\n"
            b"user-agent: m/1.0\r\naccept: application/json\r\n"
            b"connection: close\r\n\r\n")
        return json.loads(out.split(b"\r\n\r\n", 1)[1])

    def test_tls_upstream_proxied_verified_and_pooled(self, tmp_path):
        ca_pem, ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = _issue(ca_pem, ca_key, ["upstream.test"])
        sec = _tls_tagged_upstream("svc-tls", tmp_path, cert, key, "sec")
        web = _tagged_upstream("svc-plain")
        services = [
            ("api", [("127.0.0.1", sec.server_address[1], "upstream.test")]),
            ("web", [("127.0.0.1", web.server_address[1])]),
        ]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services, upstream_ca=ca_path)
        try:
            out = self._get_until(stack.port, "/api/v1", b"svc-tls")
            assert b"svc-tls:/api/v1" in out, out[:300]
            # Keep-alive reuse: the pooled TLS session carries request 2.
            out = self._get(stack.port, "/api/v2")
            assert b"svc-tls:/api/v2" in out, out[:300]
            m = self._metrics(stack.port)
            assert m["upstream_tls_fail"] == 0
            # Plain routing unaffected.
            out = self._get(stack.port, "/index.html")
            assert b"svc-plain:/index.html" in out, out[:300]
        finally:
            stack.stop()
            sec.shutdown()
            web.shutdown()

    def test_tls_upstream_ip_san(self, tmp_path):
        ca_pem, ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = _issue(ca_pem, ca_key, ["127.0.0.1"])
        sec = _tls_tagged_upstream("svc-ip", tmp_path, cert, key, "sec")
        web = _tagged_upstream("svc-plain")
        services = [
            ("api", [("127.0.0.1", sec.server_address[1], "127.0.0.1")]),
            ("web", [("127.0.0.1", web.server_address[1])]),
        ]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services, upstream_ca=ca_path)
        try:
            out = self._get_until(stack.port, "/api/ip", b"svc-ip")
            assert b"svc-ip:/api/ip" in out, out[:300]
        finally:
            stack.stop()
            sec.shutdown()
            web.shutdown()

    def test_tls_upstream_untrusted_cert_rejected(self, tmp_path):
        """An upstream presenting a cert from OUTSIDE the trust bundle
        must never be proxied to: handshake aborts, client gets 502
        (http_proxy_service.rs:192-195), upstream_tls_fail counts it."""
        from pingoo_tpu_torch.host.tlsmgr import generate_self_signed

        ca_pem, _ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = generate_self_signed(["upstream.test"])  # wrong issuer
        sec = _tls_tagged_upstream("svc-evil", tmp_path, cert, key, "sec")
        web = _tagged_upstream("svc-plain")
        services = [
            ("api", [("127.0.0.1", sec.server_address[1], "upstream.test")]),
            ("web", [("127.0.0.1", web.server_address[1])]),
        ]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services, upstream_ca=ca_path)
        try:
            # Warm routing on the healthy service first (early requests
            # fail open to service 0 while the first batch compiles).
            out = self._get_until(stack.port, "/w", b"svc-plain")
            assert b"svc-plain:/w" in out, out[:300]
            out = self._get(stack.port, "/api/secret")
            assert b"502" in out.split(b"\r\n", 1)[0], out[:300]
            assert b"svc-evil" not in out
            m = self._metrics(stack.port)
            assert m["upstream_tls_fail"] >= 1
        finally:
            stack.stop()
            sec.shutdown()
            web.shutdown()

    def test_tls_upstream_name_mismatch_rejected(self, tmp_path):
        """CA-trusted but wrong name: hostname verification must fail
        the hop (rustls verifies the server name the same way)."""
        ca_pem, ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = _issue(ca_pem, ca_key, ["other.test"])
        sec = _tls_tagged_upstream("svc-mismatch", tmp_path, cert, key, "sec")
        web = _tagged_upstream("svc-plain")
        services = [
            ("api", [("127.0.0.1", sec.server_address[1], "upstream.test")]),
            ("web", [("127.0.0.1", web.server_address[1])]),
        ]
        stack = NativeStack(tmp_path, rules=[], routes=self._routes(),
                            services=services, upstream_ca=ca_path)
        try:
            out = self._get_until(stack.port, "/w", b"svc-plain")
            assert b"svc-plain:/w" in out, out[:300]
            out = self._get(stack.port, "/api/secret")
            assert b"502" in out.split(b"\r\n", 1)[0], out[:300]
            m = self._metrics(stack.port)
            assert m["upstream_tls_fail"] >= 1
        finally:
            stack.stop()
            sec.shutdown()
            web.shutdown()

    def test_malformed_tls_line_keeps_last_good_table(self, tmp_path):
        """A hot-reloaded table whose `tls` entry lost its server name
        must be REJECTED (keep last good table), never downgraded to a
        plaintext hop carrying the request in clear."""
        web = _tagged_upstream("svc-good")
        services = [("web", [("127.0.0.1", web.server_address[1])])]
        stack = NativeStack(tmp_path, rules=[],
                            routes=[("web", None)], services=services)
        try:
            out = self._get_until(stack.port, "/a", b"svc-good")
            assert b"svc-good:/a" in out, out[:300]
            time.sleep(1.1)  # distinct mtime second for the reload tick
            with open(stack.services_path, "w") as f:
                f.write("pingoo-services v1\n"
                        "service 0 web\n"
                        f"upstream 127.0.0.1 {web.server_address[1]} tls\n")
            time.sleep(1.5)  # reload tick runs at 1 Hz
            out = self._get(stack.port, "/b")
            assert b"svc-good:/b" in out, out[:300]
        finally:
            stack.stop()
            web.shutdown()


class TestTlsUpstreamTruncation:
    """ADVICE r4: a TLS upstream ending an EOF-delimited body with a
    bare TCP FIN (no close_notify) is indistinguishable from a clean
    end unless the alert is required — an attacker able to inject a FIN
    could truncate responses undetected. The connector must treat
    SSL_ERROR_SYSCALL/ret==0 as an error (rustls: UnexpectedEof): over
    h2 the stream RESETS instead of certifying a short body complete.
    A close_notify-terminated EOF body must still complete."""

    def test_close_notify_completes_bare_fin_resets(self, tmp_path):
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        from pingoo_tpu_torch.expr import compile_expression

        ca_pem, ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = _issue(ca_pem, ca_key, ["upstream.test"])
        cert_path, key_path = str(tmp_path / "u.pem"), str(tmp_path / "u.key")
        open(cert_path, "wb").write(cert)
        open(key_path, "wb").write(key)

        mode = {"clean": True}
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(8)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert_path, key_path)

        def serve():
            while True:
                try:
                    raw, _ = lsock.accept()
                except OSError:
                    return
                try:
                    conn = ctx.wrap_socket(raw, server_side=True)
                    data = b""
                    while b"\r\n\r\n" not in data:
                        ch = conn.recv(65536)
                        if not ch:
                            break
                        data += ch
                    # No content-length: EOF-delimited body (kUntilEof)
                    conn.sendall(b"HTTP/1.1 200 OK\r\n"
                                 b"connection: close\r\n\r\nEOFBODY")
                    if mode["clean"]:
                        try:
                            conn.unwrap()  # sends close_notify
                        except OSError:
                            pass
                        conn.close()
                    else:
                        # FIN without close_notify: detach the raw fd
                        # and close it beneath the TLS layer.
                        os.close(conn.detach())
                except OSError:
                    pass

        threading.Thread(target=serve, daemon=True).start()

        routes = [("api", compile_expression(
                      'http_request.path.starts_with("/api")')),
                  ("web", None)]
        services = [
            ("api", [("127.0.0.1", lsock.getsockname()[1],
                      "upstream.test")]),
            ("web", [("127.0.0.1", 9)]),  # unused
        ]
        stack = NativeStack(tmp_path, rules=[], routes=routes,
                            services=services, upstream_ca=ca_path)
        try:
            # Warm the route (first requests fail open while the first
            # verdict batch compiles).
            out = b""
            for _ in range(25):
                out = raw_request(
                    stack.port,
                    b"GET /api/w HTTP/1.1\r\nhost: t.test\r\n"
                    b"user-agent: ua\r\nconnection: close\r\n\r\n")
                if b"EOFBODY" in out:
                    break
                time.sleep(0.4)
            assert b"EOFBODY" in out, out[:300]

            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def req():
                conn = H2UpstreamConnection("127.0.0.1", stack.port)
                await conn.connect()
                try:
                    return await asyncio.wait_for(
                        conn.request("GET", "t.test", "/api/x",
                                     [("user-agent", "ua")]), 10)
                finally:
                    await conn.close()

            # Clean close_notify: EOF-delimited body certified complete.
            st, _hdrs, body = asyncio.run(req())
            assert st == 200 and body == b"EOFBODY"

            # Bare FIN: the h2 stream must RESET, not end cleanly.
            mode["clean"] = False
            with pytest.raises(ConnectionError, match="reset"):
                asyncio.run(req())
            m = json.loads(raw_request(
                stack.port,
                b"GET /__pingoo/metrics HTTP/1.1\r\nhost: t\r\n"
                b"user-agent: m\r\naccept: application/json\r\n"
                b"connection: close\r\n\r\n"
            ).split(b"\r\n\r\n", 1)[1])
            assert m["upstream_tls_fail"] == 0  # handshakes all fine
        finally:
            stack.stop()
            lsock.close()


class TestPerListenerServiceSets:
    """VERDICT r4 item 2: two HTTP listeners front DIFFERENT service
    sets natively — each listener's verdict route field indexes its OWN
    table (reference: per-listener service binding, config.rs:241-253 +
    selection loop http_listener.rs:266-270)."""

    def test_two_listeners_different_service_sets(self, tmp_path,
                                                  loop_runner):
        import textwrap
        import urllib.request

        from pingoo_tpu_torch.config import load_and_validate
        from pingoo_tpu_torch.host.native_plane import NativePlane

        api = _tagged_upstream("svc-api")
        web = _tagged_upstream("svc-web")
        admin = _tagged_upstream("svc-admin")
        port_a, port_b = _free_port(), _free_port()
        cfg = tmp_path / "pingoo.yml"
        cfg.write_text(textwrap.dedent(f"""
        listeners:
          edge:
            address: "http://127.0.0.1:{port_a}"
            services: [api, web]
          back:
            address: "http://127.0.0.1:{port_b}"
            services: [admin, web]
        services:
          api:
            http_proxy: ["http://127.0.0.1:{api.server_address[1]}"]
            route: http_request.path.starts_with("/api")
          admin:
            http_proxy: ["http://127.0.0.1:{admin.server_address[1]}"]
            route: http_request.path.starts_with("/admin")
          web:
            http_proxy: ["http://127.0.0.1:{web.server_address[1]}"]
        rules: {{}}
        """))
        config = load_and_validate(str(cfg))
        plane = NativePlane(
            config, state_dir=str(tmp_path / "state"), device="cpu",
            enable_docker=False,
            geoip_paths=(str(tmp_path / "missing.mmdb"),),
            captcha_jwks_path=str(tmp_path / "jwks.json"),
            tls_dir=str(tmp_path / "tls"))
        loop_runner.run(plane.start(), timeout=180)
        try:
            def get(port, path):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    headers={"user-agent": "plst/1.0"})
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            # Warm both listeners until routed verdicts flow (early
            # requests fail open to service 0 during first compile).
            deadline = time.time() + 60
            while time.time() < deadline:
                sa, ba = get(port_a, "/x")[1], get(port_b, "/x")[1]
                if b"svc-web" in sa and b"svc-web" in ba:
                    break
                time.sleep(0.5)
            # edge routes /api natively to svc-api; back has no api
            # service, so /api falls through to its catch-all web.
            assert b"svc-api:/api/v1" in get(port_a, "/api/v1")[1]
            assert b"svc-web:/api/v1" in get(port_b, "/api/v1")[1]
            # back routes /admin to svc-admin; edge falls to web.
            assert b"svc-admin:/admin/p" in get(port_b, "/admin/p")[1]
            assert b"svc-web:/admin/p" in get(port_a, "/admin/p")[1]
            # Each listener wrote its OWN table file.
            assert set(plane.services_paths) == {"edge", "back"}
            tbl_edge = open(plane.services_paths["edge"]).read()
            tbl_back = open(plane.services_paths["back"]).read()
            assert "service 0 api" in tbl_edge
            assert "service 0 admin" in tbl_back
        finally:
            loop_runner.run(plane.stop(), timeout=60)


def _tcp_echo_upstream(prefix=b"echo:"):
    """Threaded echo server replying `prefix + data` per recv; the
    listen socket is returned (close() stops the accept loop)."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(8)

    def serve():
        while True:
            try:
                conn, _ = ls.accept()
            except OSError:
                return

            def pump(conn=conn):
                while True:
                    d = conn.recv(4096)
                    if not d:
                        break
                    conn.sendall(prefix + d)
                conn.close()

            threading.Thread(target=pump, daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    return ls


class TestNativeTcpFronting:
    """VERDICT r4 item 3: TCP(+TLS) listeners are fronted by the C++
    plane (tcp-proxy mode — accept, optional TLS terminate, random
    upstream with retries, bidirectional splice; reference
    tcp_listener.rs:39-70, tcp_tls_listener.rs:42-79,
    tcp_proxy_service.rs:30-84). Python is control plane only."""

    def _echo_upstream(self):
        return _tcp_echo_upstream(b"echo:")

    def _config(self, tmp_path, proto, tcp_port, http_port, up_port,
                echo_port):
        import textwrap

        cfg = tmp_path / "pingoo.yml"
        cfg.write_text(textwrap.dedent(f"""
        listeners:
          web:
            address: "http://127.0.0.1:{http_port}"
            services: [app]
          db:
            address: "{proto}://127.0.0.1:{tcp_port}"
            services: [dbsvc]
        services:
          app:
            http_proxy: ["http://127.0.0.1:{up_port}"]
          dbsvc:
            tcp_proxy: ["tcp://127.0.0.1:{echo_port}"]
        rules: {{}}
        """))
        return cfg

    def _boot(self, tmp_path, loop_runner, proto):
        from pingoo_tpu_torch.config import load_and_validate
        from pingoo_tpu_torch.host.native_plane import NativePlane

        echo = self._echo_upstream()
        up = _tagged_upstream("svc-app")
        tcp_port, http_port = _free_port(), _free_port()
        config = load_and_validate(str(self._config(
            tmp_path, proto, tcp_port, http_port,
            up.server_address[1], echo.getsockname()[1])))
        plane = NativePlane(
            config, state_dir=str(tmp_path / "state"), device="cpu",
            enable_docker=False,
            geoip_paths=(str(tmp_path / "missing.mmdb"),),
            captcha_jwks_path=str(tmp_path / "jwks.json"),
            tls_dir=str(tmp_path / "tls"))
        loop_runner.run(plane.start(), timeout=180)
        return plane, echo, up, tcp_port

    def test_tcp_proxied_natively(self, tmp_path, loop_runner):
        plane, echo, up, tcp_port = self._boot(tmp_path, loop_runner,
                                               "tcp")
        try:
            # The Python plane binds NO tcp server: native carries it.
            assert plane.server.tcp_servers == []
            c = socket.create_connection(("127.0.0.1", tcp_port),
                                         timeout=10)
            c.settimeout(10)
            c.sendall(b"SELECT 1")
            assert c.recv(100) == b"echo:SELECT 1"
            c.sendall(b"more")
            assert c.recv(100) == b"echo:more"
            # half-close propagates; reverse direction stays open
            c.shutdown(socket.SHUT_WR)
            assert c.recv(100) == b""
            c.close()
        finally:
            loop_runner.run(plane.stop(), timeout=60)
            echo.close()
            up.shutdown()

    def test_tcp_tls_terminated_natively(self, tmp_path, loop_runner):
        plane, echo, up, tcp_port = self._boot(tmp_path, loop_runner,
                                               "tcp+tls")
        try:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            # the plane generates a self-signed `*` default cert on
            # first boot (tls_manager.rs:193-231 semantics)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            raw = socket.create_connection(("127.0.0.1", tcp_port),
                                           timeout=10)
            c = ctx.wrap_socket(raw, server_hostname="db.test")
            c.settimeout(10)
            c.sendall(b"tls-bytes")
            assert c.recv(100) == b"echo:tls-bytes"
            c.close()
        finally:
            loop_runner.run(plane.stop(), timeout=60)
            echo.close()
            up.shutdown()

    def test_tcp_connect_retries_ride_through_outage(self, tmp_path):
        """A transient upstream outage at connect time must be ridden
        through by the retry ladder (reference tcp_proxy_service.rs:
        30-84 retries with delays), not surfaced as an instant drop."""
        from pingoo_tpu_torch.native_ring import Ring, write_services_file

        # reserve a port, nothing listening yet
        hold = socket.socket()
        hold.bind(("127.0.0.1", 0))
        up_port = hold.getsockname()[1]
        hold.close()

        tbl = str(tmp_path / "svc.tbl")
        write_services_file(tbl, [("db", [("127.0.0.1", up_port)])])
        ring = Ring(str(tmp_path / "r"), capacity=64, create=True)
        port = _free_port()
        env = dict(os.environ)
        env["PINGOO_TCP_RETRIES"] = "8"  # span >5 sweep seconds
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "r"), "127.0.0.1", "9",
             "--services", tbl, "--tcp-proxy"],
            stdout=subprocess.PIPE, env=env)
        assert b"listening" in proc.stdout.readline()
        try:
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            c.settimeout(20)
            c.sendall(b"early")  # buffered while the proxy retries

            def bring_up():
                time.sleep(1.5)
                ls = socket.socket()
                ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                ls.bind(("127.0.0.1", up_port))
                ls.listen(4)
                conn, _ = ls.accept()
                d = conn.recv(100)
                conn.sendall(b"late-echo:" + d)
                conn.close()
                ls.close()

            t = threading.Thread(target=bring_up, daemon=True)
            t.start()
            assert c.recv(100) == b"late-echo:early"
            c.close()
            t.join(timeout=10)
        finally:
            proc.kill()
            proc.wait()
            ring.close()


class TestH2UpstreamNative:
    """VERDICT r4 item 7: h2 upstream hops ride the native connector —
    cleartext prior-knowledge for table-marked `h2` targets, ALPN for
    TLS targets (reference hyper client, http_proxy_service.rs:54-71).
    The second httpd in each chain is itself the h2 upstream server."""

    def _mk_httpd(self, tmp_path, tag, port, upstream_port, extra=()):
        ring_path = str(tmp_path / f"ring_{tag}")
        ring = Ring(ring_path, capacity=256, create=True)
        drain = subprocess.Popen(
            [_drain_bin(), ring_path],
            stdout=subprocess.PIPE)
        assert b"draining" in drain.stdout.readline()
        h = subprocess.Popen(
            [HTTPD, str(port), ring_path, "127.0.0.1",
             str(upstream_port)] + list(extra), stdout=subprocess.PIPE)
        assert b"listening" in h.stdout.readline()
        return ring, drain, h

    def test_h2c_prior_knowledge_upstream_pooled(self, tmp_path):
        from pingoo_tpu_torch.native_ring import H2

        class _PostEcho(_TaggedUpstream):
            def do_POST(self):
                n = int(self.headers.get("content-length", 0))
                got = self.rfile.read(n)
                body = f"post:{len(got)}:{got[:8].decode()}".encode()
                self.send_response(200)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        pong = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _PostEcho)
        pong.tag = "svc-pong"
        pong.delay_s = 0
        threading.Thread(target=pong.serve_forever, daemon=True).start()
        pa, pb = _free_port(), _free_port()
        cleanup = []
        try:
            cleanup.append(self._mk_httpd(
                tmp_path, "b", pb, pong.server_address[1]))
            tbl = str(tmp_path / "svc.tbl")
            native_ring.write_services_file(
                tbl, [("app", [("127.0.0.1", pb, H2)])])
            cleanup.append(self._mk_httpd(
                tmp_path, "a", pa, 9, ("--services", tbl)))
            # two keep-alive h1 requests: the second rides the POOLED
            # h2 session (same upstream connection)
            out1 = raw_request(
                pa, b"GET /h2c1 HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    b"connection: close\r\n\r\n")
            assert b"svc-pong:/h2c1" in out1, out1[:300]
            out2 = raw_request(
                pa, b"GET /h2c2 HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    b"connection: close\r\n\r\n")
            assert b"svc-pong:/h2c2" in out2, out2[:300]
            # POST body must be re-framed as h2 DATA correctly
            body = b"x" * 5000
            out3 = raw_request(
                pa, b"POST /p HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    b"content-length: 5000\r\nconnection: close\r\n\r\n"
                    + body)
            assert b"post:5000:xxxxxxxx" in out3, out3[:300]
        finally:
            for ring, drain, h in cleanup:
                drain.kill()
                h.kill()
                ring.close()
            pong.shutdown()

    def test_alpn_h2_tls_upstream(self, tmp_path):
        """A TLS upstream that negotiates h2 via ALPN must be spoken to
        in h2 — transparently, from the same `tls` table entry."""
        ca_pem, ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = _issue(ca_pem, ca_key, ["upstream.test"])
        tls_dir = tmp_path / "btls"
        tls_dir.mkdir()
        (tls_dir / "upstream.test.pem").write_bytes(cert)
        (tls_dir / "upstream.test.key").write_bytes(key)

        pong = _tagged_upstream("svc-pong")
        pa, pb = _free_port(), _free_port()
        cleanup = []
        try:
            # B terminates TLS and ANSWERS h2 when ALPN picks it
            cleanup.append(self._mk_httpd(
                tmp_path, "tb", pb, pong.server_address[1],
                ("--tls-dir", str(tls_dir))))
            tbl = str(tmp_path / "svc_tls.tbl")
            native_ring.write_services_file(
                tbl, [("app", [("127.0.0.1", pb, "upstream.test")])])
            cleanup.append(self._mk_httpd(
                tmp_path, "ta", pa, 9,
                ("--services", tbl, "--upstream-ca", ca_path)))
            out = raw_request(
                pa, b"GET /alpn1 HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    b"connection: close\r\n\r\n")
            assert b"svc-pong:/alpn1" in out, out[:300]
            out = raw_request(  # pooled h2-over-TLS session reuse
                pa, b"GET /alpn2 HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    b"connection: close\r\n\r\n")
            assert b"svc-pong:/alpn2" in out, out[:300]
        finally:
            for ring, drain, h in cleanup:
                drain.kill()
                h.kill()
                ring.close()
            pong.shutdown()

    def test_h2_downstream_over_h2_upstream(self, tmp_path):
        """h2 client -> native plane -> h2c upstream: both hops h2."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        from pingoo_tpu_torch.native_ring import H2

        pong = _tagged_upstream("svc-pong")
        pa, pb = _free_port(), _free_port()
        cleanup = []
        try:
            cleanup.append(self._mk_httpd(
                tmp_path, "db", pb, pong.server_address[1]))
            tbl = str(tmp_path / "svc_d.tbl")
            native_ring.write_services_file(
                tbl, [("app", [("127.0.0.1", pb, H2)])])
            cleanup.append(self._mk_httpd(
                tmp_path, "da", pa, 9, ("--services", tbl)))
            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", pa)
                await conn.connect()
                try:
                    r1 = await asyncio.wait_for(conn.request(
                        "GET", "t", "/d1", [("user-agent", "u")]), 10)
                    r2 = await asyncio.wait_for(conn.request(
                        "GET", "t", "/d2", [("user-agent", "u")]), 10)
                    return r1, r2
                finally:
                    await conn.close()

            (s1, _h1, b1), (s2, _h2, b2) = asyncio.run(flow())
            assert s1 == 200 and b1 == b"svc-pong:/d1", (s1, b1)
            assert s2 == 200 and b2 == b"svc-pong:/d2", (s2, b2)
        finally:
            for ring, drain, h in cleanup:
                drain.kill()
                h.kill()
                ring.close()
            pong.shutdown()


class TestUpgradePinsH1OnTls:
    """An Upgrade (WebSocket) request to a TLS upstream must NOT offer
    h2 in ALPN — a 101 tunnel cannot ride an h2 hop, and an h2-capable
    upstream would otherwise be negotiated into one (regression guard
    for the round-5 ALPN offer)."""

    def test_ws_upgrade_through_h2_capable_tls_upstream(self, tmp_path):
        ca_pem, ca_key = _mini_ca()
        ca_path = str(tmp_path / "ca.pem")
        open(ca_path, "wb").write(ca_pem)
        cert, key = _issue(ca_pem, ca_key, ["upstream.test"])
        tls_dir = tmp_path / "wtls"
        tls_dir.mkdir()
        (tls_dir / "upstream.test.pem").write_bytes(cert)
        (tls_dir / "upstream.test.key").write_bytes(key)

        ws = _ws_echo_upstream()
        pa, pb = _free_port(), _free_port()
        cleanup = []
        mk = TestH2UpstreamNative()._mk_httpd
        try:
            # B: TLS edge that PREFERS h2 in ALPN, forwards upgrades h1
            cleanup.append(mk(tmp_path, "wb", pb, ws.getsockname()[1],
                              ("--tls-dir", str(tls_dir))))
            tbl = str(tmp_path / "ws.tbl")
            native_ring.write_services_file(
                tbl, [("app", [("127.0.0.1", pb, "upstream.test")])])
            cleanup.append(mk(tmp_path, "wa", pa, 9,
                              ("--services", tbl,
                               "--upstream-ca", ca_path)))
            # Plain request first: negotiates h2 upstream (the pool now
            # holds an h2 session for this target).
            out = raw_request(
                pa, b"GET /warm HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                    b"connection: close\r\n\r\n")
            assert b"101" not in out.split(b"\r\n", 1)[0]
            # The upgrade must still tunnel: a FRESH h1-pinned TLS
            # connection is dialed even though the pool has h2.
            c = socket.create_connection(("127.0.0.1", pa), timeout=10)
            c.sendall(b"GET /chat HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n"
                      b"connection: Upgrade\r\nupgrade: websocket\r\n"
                      b"sec-websocket-key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                      b"sec-websocket-version: 13\r\n\r\n")
            head = b""
            c.settimeout(10)
            while b"\r\n\r\n" not in head:
                ch = c.recv(4096)
                if not ch:
                    break
                head += ch
            assert head.startswith(b"HTTP/1.1 101"), head[:200]
            c.sendall(b"\x81\x05hello")
            got = head.partition(b"\r\n\r\n")[2]
            while len(got) < 7:
                got += c.recv(4096)
            assert got == b"\x81\x05hello", got
            c.close()
        finally:
            for ring, drain, h in cleanup:
                drain.kill()
                h.kill()
                ring.close()
            ws.close()


class TestNativeStaticServing:
    """VERDICT r4 item 8: static sites served from the data-plane
    binary (reference http_static_site_service.rs:83-257 semantics:
    GET/HEAD only, traversal guard, index.html, .html prettify,
    SHA256 ETag + If-None-Match 304, 500KB cache limit); files past
    the cache limit proxy to the service's upstream list."""

    def _site(self, tmp_path):
        root = tmp_path / "site"
        (root / "sub").mkdir(parents=True)
        (root / "index.html").write_text("<h1>home</h1>")
        (root / "page.html").write_text("<h1>page</h1>")
        (root / "app.js").write_text("console.log(1)")
        (root / "sub" / "index.html").write_text("<h1>sub</h1>")
        (root / "big.bin").write_bytes(b"B" * 600_000)  # > 500 KB
        return root

    def _stack(self, tmp_path, root):
        fallback = _tagged_upstream("svc-stream")
        ring_path = str(tmp_path / "sring")
        ring = Ring(ring_path, capacity=256, create=True)
        drain = subprocess.Popen(
            [_drain_bin(), ring_path],
            stdout=subprocess.PIPE)
        assert b"draining" in drain.stdout.readline()
        tbl = str(tmp_path / "static.tbl")
        native_ring.write_services_file(
            tbl, [("site", [("127.0.0.1", fallback.server_address[1])],
                   str(root))])
        port = _free_port()
        h = subprocess.Popen(
            [HTTPD, str(port), ring_path, "127.0.0.1", "9",
             "--services", tbl], stdout=subprocess.PIPE)
        assert b"listening" in h.stdout.readline()
        return port, (ring, drain, h, fallback)

    def _req(self, port, payload):
        return raw_request(port, payload)

    def test_static_semantics_native(self, tmp_path):
        root = self._site(tmp_path)
        port, cleanup = self._stack(tmp_path, root)
        try:
            def get(path, extra=b"", method=b"GET"):
                return self._req(
                    port, method + b" " + path +
                    b" HTTP/1.1\r\nhost: t\r\nuser-agent: u\r\n" + extra +
                    b"connection: close\r\n\r\n")

            out = get(b"/")
            assert b"200" in out.split(b"\r\n")[0] and b"<h1>home</h1>" in out
            assert b"content-type: text/html" in out
            etag = [ln for ln in out.split(b"\r\n")
                    if ln.startswith(b"etag:")][0].split(b" ", 1)[1]
            # If-None-Match -> 304, no body
            out = get(b"/", b"if-none-match: " + etag + b"\r\n")
            assert b"304" in out.split(b"\r\n")[0], out[:200]
            assert b"<h1>" not in out
            # prettify: /page -> page.html
            out = get(b"/page")
            assert b"<h1>page</h1>" in out
            # directory -> index.html
            out = get(b"/sub/")
            assert b"<h1>sub</h1>" in out
            # mime by extension
            out = get(b"/app.js")
            assert b"content-type: text/javascript" in out
            # missing with extension -> 404
            out = get(b"/nope.css")
            assert b"404" in out.split(b"\r\n")[0]
            # traversal -> 404 (never escapes the root)
            out = get(b"/../secret")
            assert b"404" in out.split(b"\r\n")[0]
            # POST -> 405 (reference: GET/HEAD only)
            out = get(b"/", method=b"POST")
            assert b"405" in out.split(b"\r\n")[0]
            # HEAD: full content-length, no body
            out = get(b"/", method=b"HEAD")
            assert b"content-length: 13" in out and b"<h1>" not in out
            # oversized file -> proxied to the upstream list
            out = get(b"/big.bin")
            assert b"svc-stream:/big.bin" in out, out[:200]
        finally:
            ring, drain, h, fb = cleanup
            drain.kill()
            h.kill()
            ring.close()
            fb.shutdown()

    def test_static_native_in_plane(self, tmp_path, loop_runner):
        """Full NativePlane: a static config service is served from the
        C++ binary (policy still enforced by the verdict path)."""
        import textwrap
        import urllib.request

        from pingoo_tpu_torch.config import load_and_validate
        from pingoo_tpu_torch.host.native_plane import NativePlane

        root = self._site(tmp_path)
        port = _free_port()
        cfg = tmp_path / "pingoo.yml"
        cfg.write_text(textwrap.dedent(f"""
        listeners:
          web:
            address: "http://127.0.0.1:{port}"
        services:
          site:
            static: {{root: "{root}"}}
        rules:
          blk:
            expression: http_request.path.contains("blocked")
            actions: [{{action: block}}]
        """))
        config = load_and_validate(str(cfg))
        plane = NativePlane(
            config, state_dir=str(tmp_path / "state"), device="cpu",
            enable_docker=False,
            geoip_paths=(str(tmp_path / "missing.mmdb"),),
            captcha_jwks_path=str(tmp_path / "jwks.json"),
            tls_dir=str(tmp_path / "tls"))
        loop_runner.run(plane.start(), timeout=180)
        try:
            def get(path):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    headers={"user-agent": "st/1.0"})
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            deadline = time.time() + 60
            status, body = None, b""
            while time.time() < deadline:
                status, body = get("/page")
                if status == 200 and b"<h1>page</h1>" in body:
                    break
                time.sleep(0.5)
            assert status == 200 and b"<h1>page</h1>" in body, (status, body)
            # the published table carries the static root
            tbl = open(plane.services_paths["web"]).read()
            assert f"static {root}" in tbl
            # WAF still applies before static dispatch
            status, _ = get("/blocked.html")
            assert status == 403
            # oversized files stream via the control plane
            status, body = get("/big.bin")
            assert status == 200 and len(body) == 600_000
        finally:
            loop_runner.run(plane.stop(), timeout=60)

    def test_static_served_on_h2(self, tmp_path):
        """The h2 downstream path serves static responses natively too
        (reference: same service behind hyper's auto h1/h2 builder)."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        root = self._site(tmp_path)
        port, cleanup = self._stack(tmp_path, root)
        try:
            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", port)
                await conn.connect()
                try:
                    r1 = await asyncio.wait_for(conn.request(
                        "GET", "t", "/page", [("user-agent", "u")]), 10)
                    etag = dict(r1[1])["etag"]
                    r2 = await asyncio.wait_for(conn.request(
                        "GET", "t", "/page",
                        [("user-agent", "u"),
                         ("if-none-match", etag)]), 10)
                    return r1, r2
                finally:
                    await conn.close()

            (s1, h1, b1), (s2, _h2, b2) = asyncio.run(flow())
            assert s1 == 200 and b1 == b"<h1>page</h1>", (s1, b1)
            assert s2 == 304 and b2 == b"", (s2, b2)
        finally:
            ring, drain, h, fb = cleanup
            drain.kill()
            h.kill()
            ring.close()
            fb.shutdown()


class TestTcpUpstreamHalfClose:
    """tcp-proxy mode: an upstream that FINs its send side while still
    reading must get the FIN propagated to the client WITHOUT tearing
    down the client->upstream direction (copy_bidirectional semantics,
    tcp_proxy_service.rs:74-82)."""

    def test_upstream_fin_keeps_client_to_upstream_alive(self, tmp_path):
        from pingoo_tpu_torch.native_ring import Ring, write_services_file

        received = []
        done = threading.Event()
        ls = socket.socket()
        ls.bind(("127.0.0.1", 0))
        ls.listen(4)

        def serve():
            conn, _ = ls.accept()
            conn.sendall(b"greeting")       # server speaks first...
            conn.shutdown(socket.SHUT_WR)   # ...then FINs its send side
            while True:                     # but KEEPS reading
                d = conn.recv(4096)
                if not d:
                    break
                received.append(d)
            conn.close()
            done.set()

        threading.Thread(target=serve, daemon=True).start()

        tbl = str(tmp_path / "svc.tbl")
        write_services_file(
            tbl, [("db", [("127.0.0.1", ls.getsockname()[1])])])
        ring = Ring(str(tmp_path / "r"), capacity=64, create=True)
        port = _free_port()
        proc = subprocess.Popen(
            [HTTPD, str(port), str(tmp_path / "r"), "127.0.0.1", "9",
             "--services", tbl, "--tcp-proxy"], stdout=subprocess.PIPE)
        assert b"listening" in proc.stdout.readline()
        try:
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            c.settimeout(10)
            assert c.recv(100) == b"greeting"
            assert c.recv(100) == b""  # upstream FIN propagated
            # the reverse direction must still deliver bytes
            c.sendall(b"late-upload")
            c.shutdown(socket.SHUT_WR)
            assert done.wait(10)
            assert b"".join(received) == b"late-upload", received
            c.close()
        finally:
            proc.kill()
            proc.wait()
            ring.close()
            ls.close()


class TestH2UpstreamConcurrency:
    """Concurrent h2 downstream streams over a pooled h2c upstream:
    each stream opens (or reuses) its own upstream h2 session — mixed
    with h1 clients hammering the same pool. Exercises pool handoff,
    GOAWAY-free reuse, and session ownership transfer under load."""

    def test_mixed_h1_h2_traffic_over_h2c_upstream(self, tmp_path):
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        from pingoo_tpu_torch.native_ring import H2

        pong = _tagged_upstream("svc-pong")
        pa, pb = _free_port(), _free_port()
        mk = TestH2UpstreamNative()._mk_httpd
        cleanup = []
        try:
            cleanup.append(mk(tmp_path, "cb", pb, pong.server_address[1]))
            tbl = str(tmp_path / "svc_c.tbl")
            native_ring.write_services_file(
                tbl, [("app", [("127.0.0.1", pb, H2)])])
            cleanup.append(mk(tmp_path, "ca", pa, 9, ("--services", tbl)))

            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def h2_batch(n):
                conn = H2UpstreamConnection("127.0.0.1", pa)
                await conn.connect()
                try:
                    outs = await asyncio.gather(*[
                        asyncio.wait_for(conn.request(
                            "GET", "t", f"/s{i}", [("user-agent", "u")]),
                            20)
                        for i in range(n)])
                    return outs
                finally:
                    await conn.close()

            h1_results = []

            def h1_hammer(k):
                for i in range(k):
                    out = raw_request(
                        pa, f"GET /h1-{i} HTTP/1.1\r\nhost: t\r\n"
                            f"user-agent: u\r\nconnection: close"
                            f"\r\n\r\n".encode())
                    h1_results.append(b"svc-pong:/h1-" + str(i).encode()
                                      in out)

            t = threading.Thread(target=h1_hammer, args=(30,))
            t.start()
            outs = asyncio.run(h2_batch(24))
            t.join(timeout=60)
            for i, (st, _h, body) in enumerate(outs):
                assert st == 200 and body == f"svc-pong:/s{i}".encode(), \
                    (i, st, body)
            assert len(h1_results) == 30 and all(h1_results)
        finally:
            for ring, drain, h in cleanup:
                drain.kill()
                h.kill()
                ring.close()
            pong.shutdown()


class TestH2UpstreamLargeUpload:
    """A POST bigger than the h2 LINK's body cap: bytes past the cap
    stay in inbuf and MUST be re-pumped when the upstream's
    WINDOW_UPDATEs drain the link (round-5 fix: the client may be done
    sending, so upstream events drive the pump). The front proxy runs
    with PINGOO_MAX_BUFFER=64KB so a 512KB upload exercises the
    stranded-bytes path while staying under the h2 SERVER side's
    buffered-body cap (streamed h2 request bodies are the known
    remaining delta vs hyper)."""

    def test_post_past_link_cap_completes(self, tmp_path):
        from pingoo_tpu_torch.native_ring import H2

        class _BigPost(_TaggedUpstream):
            def do_POST(self):
                n = int(self.headers.get("content-length", 0))
                remaining, total = n, 0
                while remaining:
                    chunk = self.rfile.read(min(65536, remaining))
                    if not chunk:
                        break
                    total += len(chunk)
                    remaining -= len(chunk)
                body = f"got:{total}".encode()
                self.send_response(200)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        pong = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _BigPost)
        pong.tag = "big"
        pong.delay_s = 0
        threading.Thread(target=pong.serve_forever, daemon=True).start()
        pa, pb = _free_port(), _free_port()
        mk = TestH2UpstreamNative()._mk_httpd
        cleanup = []
        try:
            cleanup.append(mk(tmp_path, "bb", pb, pong.server_address[1]))
            tbl = str(tmp_path / "svc_big.tbl")
            native_ring.write_services_file(
                tbl, [("app", [("127.0.0.1", pb, H2)])])
            env = dict(os.environ)
            env["PINGOO_MAX_BUFFER"] = "65536"
            ring_path = str(tmp_path / "ring_ba")
            ring = Ring(ring_path, capacity=256, create=True)
            drain = subprocess.Popen(
                [_drain_bin(), ring_path],
                stdout=subprocess.PIPE)
            assert b"draining" in drain.stdout.readline()
            h = subprocess.Popen(
                [HTTPD, str(pa), ring_path, "127.0.0.1", "9",
                 "--services", tbl], stdout=subprocess.PIPE, env=env)
            assert b"listening" in h.stdout.readline()
            cleanup.append((ring, drain, h))
            n = 512 * 1024
            body = b"z" * n
            c = socket.create_connection(("127.0.0.1", pa), timeout=30)
            c.sendall((f"POST /up HTTP/1.1\r\nhost: t\r\nuser-agent: u"
                       f"\r\ncontent-length: {n}\r\nconnection: close"
                       f"\r\n\r\n").encode())
            c.sendall(body)
            c.settimeout(60)
            data = b""
            while True:
                try:
                    ch = c.recv(65536)
                except socket.timeout:
                    break
                if not ch:
                    break
                data += ch
            c.close()
            assert f"got:{n}".encode() in data, data[:300]
        finally:
            for ring, drain, h in cleanup:
                drain.kill()
                h.kill()
                ring.close()
            pong.shutdown()

    def test_h2_downstream_body_past_cap_streams_through(self, tmp_path):
        """Round 5: h2 DOWNSTREAM request bodies STREAM to the upstream
        (dispatch at END_HEADERS) — a body far past the buffering cap
        completes as long as the upstream keeps up, like hyper."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")

        class _Count(_TaggedUpstream):
            def do_POST(self):
                n = int(self.headers.get("content-length", 0))
                total, remaining = 0, n
                while remaining:
                    ch = self.rfile.read(min(65536, remaining))
                    if not ch:
                        break
                    total += len(ch)
                    remaining -= len(ch)
                body = f"streamed:{total}".encode()
                self.send_response(200)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        pong = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Count)
        pong.tag = "cnt"
        pong.delay_s = 0
        threading.Thread(target=pong.serve_forever, daemon=True).start()
        port = _free_port()
        ring_path = str(tmp_path / "ring_ov")
        ring = Ring(ring_path, capacity=256, create=True)
        drain = subprocess.Popen(
            [_drain_bin(), ring_path],
            stdout=subprocess.PIPE)
        assert b"draining" in drain.stdout.readline()
        env = dict(os.environ)
        env["PINGOO_MAX_BUFFER"] = "65536"
        h = subprocess.Popen(
            [HTTPD, str(port), ring_path, "127.0.0.1",
             str(pong.server_address[1])], stdout=subprocess.PIPE, env=env)
        assert b"listening" in h.stdout.readline()
        try:
            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", port)
                await conn.connect()
                try:
                    big = b"y" * (512 * 1024)  # 8x the buffering cap
                    r1 = await asyncio.wait_for(conn.request(
                        "POST", "t", "/up", [("user-agent", "u")],
                        big), 30)
                    r2 = await asyncio.wait_for(conn.request(
                        "GET", "t", "/after", [("user-agent", "u")]), 15)
                    return r1, r2
                finally:
                    await conn.close()

            (s1, _h1, b1), (s2, _h2, b2) = asyncio.run(flow())
            assert s1 == 200 and b1 == b"streamed:524288", (s1, b1)
            assert s2 == 200 and b2 == b"cnt:/after", (s2, b2)
        finally:
            drain.kill()
            h.kill()
            ring.close()
            pong.shutdown()

    def test_h2_body_to_stalled_upstream_bounded(self, tmp_path):
        """A STALLED upstream bounds a streamed h2 body at the cap: the
        stream errors (reset) instead of buffering without limit, and
        the worker survives."""
        from pingoo_tpu_torch.host import h2 as h2mod

        if not h2mod.available():
            pytest.skip("libnghttp2 unavailable")
        # upstream that accepts and never reads
        ls = socket.socket()
        ls.bind(("127.0.0.1", 0))
        ls.listen(4)
        held = []

        def hold():
            while True:
                try:
                    conn, _ = ls.accept()
                except OSError:
                    return
                held.append(conn)  # never read

        threading.Thread(target=hold, daemon=True).start()
        port = _free_port()
        ring_path = str(tmp_path / "ring_st")
        ring = Ring(ring_path, capacity=256, create=True)
        drain = subprocess.Popen(
            [_drain_bin(), ring_path],
            stdout=subprocess.PIPE)
        assert b"draining" in drain.stdout.readline()
        env = dict(os.environ)
        env["PINGOO_MAX_BUFFER"] = "65536"
        h = subprocess.Popen(
            [HTTPD, str(port), ring_path, "127.0.0.1",
             str(ls.getsockname()[1])], stdout=subprocess.PIPE, env=env)
        assert b"listening" in h.stdout.readline()
        try:
            from pingoo_tpu_torch.host.h2 import H2UpstreamConnection

            async def flow():
                conn = H2UpstreamConnection("127.0.0.1", port)
                await conn.connect()
                try:
                    big = b"y" * (1024 * 1024)
                    try:
                        await asyncio.wait_for(conn.request(
                            "POST", "t", "/up", [("user-agent", "u")],
                            big), 20)
                        return True
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError):
                        return False
                finally:
                    await conn.close()

            completed = asyncio.run(flow())
            assert not completed  # bounded: reset, not buffered forever
            assert h.poll() is None  # worker alive
        finally:
            drain.kill()
            h.kill()
            ring.close()
            ls.close()
            for s in held:
                s.close()

    def test_trailers_end_the_streamed_body(self, tmp_path):
        """An h2 request whose body ends with TRAILERS (HEADERS frame
        carrying END_STREAM) must finish the upstream body — the
        pre-round-5 code only ended bodies on DATA+END_STREAM."""
        got = {}
        done = threading.Event()

        class _Cap(_TaggedUpstream):
            def do_POST(self):
                n = int(self.headers.get("content-length", 0) or 0)
                if n:
                    body = self.rfile.read(n)
                else:
                    # chunked from the proxy (no client content-length)
                    body = b""
                    while True:
                        line = self.rfile.readline().strip()
                        size = int(line, 16)
                        if size == 0:
                            self.rfile.readline()
                            break
                        body += self.rfile.read(size)
                        self.rfile.readline()
                got["body"] = body
                done.set()
                out = b"ok"
                self.send_response(200)
                self.send_header("content-length", "2")
                self.end_headers()
                self.wfile.write(out)

        pong = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Cap)
        pong.tag = "cap"
        pong.delay_s = 0
        threading.Thread(target=pong.serve_forever, daemon=True).start()
        port = _free_port()
        ring_path = str(tmp_path / "ring_tr")
        ring = Ring(ring_path, capacity=256, create=True)
        drain = subprocess.Popen(
            [_drain_bin(), ring_path],
            stdout=subprocess.PIPE)
        assert b"draining" in drain.stdout.readline()
        h = subprocess.Popen(
            [HTTPD, str(port), ring_path, "127.0.0.1",
             str(pong.server_address[1])], stdout=subprocess.PIPE)
        assert b"listening" in h.stdout.readline()

        def hp(name, value):  # HPACK literal w/o indexing, new name
            return (b"\x00" + bytes([len(name)]) + name
                    + bytes([len(value)]) + value)

        def frame(ftype, flags, sid, payload):
            return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                    + sid.to_bytes(4, "big") + payload)

        try:
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            c.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
            c.sendall(frame(4, 0, 0, b""))  # SETTINGS
            heads = (hp(b":method", b"POST") + hp(b":path", b"/t")
                     + hp(b":scheme", b"http") + hp(b":authority", b"t")
                     + hp(b"user-agent", b"trail/1.0"))
            c.sendall(frame(1, 0x4, 1, heads))       # HEADERS, no ES
            c.sendall(frame(0, 0, 1, b"BODYBYTES"))  # DATA, no ES
            trailers = hp(b"x-checksum", b"abc123")
            c.sendall(frame(1, 0x5, 1, trailers))    # trailers: ES+EH
            assert done.wait(20), "upstream never saw the finished body"
            assert got["body"] == b"BODYBYTES", got
            # response HEADERS for stream 1 must come back
            c.settimeout(10)
            buf = b""
            saw_resp = False
            deadline = time.time() + 10
            while time.time() < deadline and not saw_resp:
                try:
                    ch = c.recv(65536)
                except socket.timeout:
                    break
                if not ch:
                    break
                buf += ch
                while len(buf) >= 9:
                    ln = int.from_bytes(buf[:3], "big")
                    if len(buf) < 9 + ln:
                        break
                    ftype = buf[3]
                    fsid = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
                    if ftype == 1 and fsid == 1:
                        saw_resp = True
                    buf = buf[9 + ln:]
            assert saw_resp, "no response HEADERS on stream 1"
            c.close()
        finally:
            drain.kill()
            h.kill()
            ring.close()
            pong.shutdown()


class TestFullStackCombinedConfig:
    """One CLI-driven config exercising every native-plane capability
    at once: an h2:// upstream service with a route, a static service
    with a route, a catch-all h1 proxy, a WAF rule, and a native TCP
    listener — the closest thing to a production deployment the test
    suite drives."""

    def test_cli_combined_deployment(self, tmp_path, loop_runner):
        import textwrap
        import urllib.request

        from pingoo_tpu_torch.config import load_and_validate
        from pingoo_tpu_torch.host.native_plane import NativePlane

        # h2c upstream: a second native httpd fronting a tagged pong
        pong = _tagged_upstream("svc-pong")
        h2_port = _free_port()
        ring_b = Ring(str(tmp_path / "rb"), capacity=256, create=True)
        drain_b = subprocess.Popen(
            [_drain_bin(),
             str(tmp_path / "rb")], stdout=subprocess.PIPE)
        assert b"draining" in drain_b.stdout.readline()
        h2up = subprocess.Popen(
            [HTTPD, str(h2_port), str(tmp_path / "rb"), "127.0.0.1",
             str(pong.server_address[1])], stdout=subprocess.PIPE)
        assert b"listening" in h2up.stdout.readline()

        echo = _tcp_echo_upstream(b"tcp:")

        site = tmp_path / "site"
        (site / "static").mkdir(parents=True)
        # the `site` route matches /static/*; paths resolve under the
        # root, so the file lives at <root>/static/page.html
        (site / "static" / "page.html").write_text("<h1>combined</h1>")
        app = _tagged_upstream("svc-app")
        port, tcp_port = _free_port(), _free_port()
        cfg = tmp_path / "pingoo.yml"
        cfg.write_text(textwrap.dedent(f"""
        listeners:
          main:
            address: "http://127.0.0.1:{port}"
            services: [api, site, app]
          db:
            address: "tcp://127.0.0.1:{tcp_port}"
            services: [dbsvc]
        services:
          api:
            http_proxy: ["h2://127.0.0.1:{h2_port}"]
            route: http_request.path.starts_with("/api")
          site:
            static: {{root: "{site}"}}
            route: http_request.path.starts_with("/static")
          app:
            http_proxy: ["http://127.0.0.1:{app.server_address[1]}"]
          dbsvc:
            tcp_proxy: ["tcp://127.0.0.1:{echo.getsockname()[1]}"]
        rules:
          block-env:
            expression: http_request.path.starts_with("/.env")
            actions: [{{action: block}}]
        """))
        config = load_and_validate(str(cfg))
        plane = NativePlane(
            config, state_dir=str(tmp_path / "state"), device="cpu",
            enable_docker=False,
            geoip_paths=(str(tmp_path / "missing.mmdb"),),
            captcha_jwks_path=str(tmp_path / "jwks.json"),
            tls_dir=str(tmp_path / "tls"))
        loop_runner.run(plane.start(), timeout=180)
        try:
            def get(path):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    headers={"user-agent": "full/1.0"})
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            # warm routing (fail-open to service 0 during first compile)
            deadline = time.time() + 60
            while time.time() < deadline:
                st, body = get("/")
                if st == 200 and b"svc-app:/" in body:
                    break
                time.sleep(0.5)
            assert b"svc-app:/" in body, (st, body)
            # h2:// upstream, natively framed
            deadline = time.time() + 30
            while time.time() < deadline:
                st, body = get("/api/x")
                if body == b"svc-pong:/api/x":
                    break
                time.sleep(0.5)
            assert st == 200 and body == b"svc-pong:/api/x", (st, body)
            # native static (with .html prettify) via the routed service
            st, body = get("/static/page")
            assert st == 200 and b"<h1>combined</h1>" in body, (st, body)
            # WAF applies before everything
            st, _ = get("/.env")
            assert st == 403
            # native tcp
            c = socket.create_connection(("127.0.0.1", tcp_port),
                                         timeout=10)
            c.settimeout(10)
            c.sendall(b"ping")
            assert c.recv(100) == b"tcp:ping"
            c.close()
        finally:
            loop_runner.run(plane.stop(), timeout=60)
            drain_b.kill()
            h2up.kill()
            ring_b.close()
            echo.close()
            pong.shutdown()
            app.shutdown()
