"""The port's native-plane runner on the CPU, beside the JAX package's.

  * Cross-package parity: the same raw requests go to one httpd in front
    of the JAX package's `RingSidecar` (its CPU backend, as its own tests
    run it) and to one in front of the port's, on one rule set, one
    services table and one pair of upstreams: blocked, captcha redirect
    and proxied requests, pipelined keep-alive, a chunked POST, URLs
    past the slot cap (spill rows), two routed services and the no-match
    404, and a geo rule through a fake GeoIP. Status, headers (but the
    date) and body must be equal, and neither httpd may fail a request
    open or enter its degraded mode.
  * The entry point: `python -m pingoo_tpu_torch --native-plane
    --no-device` answers 403 and 200 through the httpd and exits 0 on
    SIGTERM with its httpd children gone; without a card and without
    --no-device it raises.
  * The builds: the binaries are built from the port's sources into
    `_build/` under a name holding the hash, and raise without a
    compiler, without a soname and on a failed build.
  * The sidecar's warm-up and the runner's report of a dead sidecar.

The parity httpds run with PINGOO_VERDICT_TIMEOUT_MS and
PINGOO_SIDECAR_TIMEOUT_MS raised (PARITY_ENV): the JAX sidecar compiles
each new batch shape on its first batch, which takes longer than the
httpd's 3 s deadline; the cases assert that no request failed open.
"""

import functools
import http.server
import json
import os
import re
import shutil
import signal
import socket
import socketserver
import subprocess
import sys
import textwrap
import threading
import time
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from pingoo_tpu import native_ring as ref_nr
from pingoo_tpu_torch import native_ring as nr
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# The reference sidecar's per-batch chain, as tests/test_torch_ring.py.
REF_ENV = {"PINGOO_PIPELINE": "off", "PINGOO_SCHED_MODE": "fixed",
           "PINGOO_MEGASTEP": "off"}
PARITY_ENV = {"PINGOO_VERDICT_TIMEOUT_MS": "120000",
              "PINGOO_SIDECAR_TIMEOUT_MS": "120000"}

RULES = (
    ("block_evil", 'http_request.url.contains("evil")', "block"),
    ("bot_gate", 'http_request.user_agent.contains("sqlmap")', "captcha"),
    ("geo_kp", 'client.country == "KP" && '
               'http_request.path.starts_with("/api/geo")', "block"),
)
ROUTES = (("api", 'http_request.path.starts_with("/api")'),
          ("web", 'http_request.path.starts_with("/web")'))
GeoRecord = namedtuple("GeoRecord", "asn country")


class FakeGeoip:
    """127.0.0.1 is in North Korea, 127.0.0.2 in the US, the rest
    unknown (the lookup raises, so the slot keeps its markers)."""

    RECORDS = {"127.0.0.1": GeoRecord(64500, "KP"),
               "127.0.0.2": GeoRecord(15169, "US")}

    def lookup(self, ip):
        return self.RECORDS[str(ip)]


class _Tagged(http.server.BaseHTTPRequestHandler):
    """An upstream answering "<tag> <method> <target> <body>" and the
    names of the headers it was sent; it reads bodies framed by length
    or in chunks."""

    protocol_version = "HTTP/1.1"
    tag = b"?"

    def _body(self) -> bytes:
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            out = b""
            while True:
                size = int(self.rfile.readline().split(b";")[0], 16)
                chunk = self.rfile.read(size)
                self.rfile.readline()
                if not size:
                    return out
                out += chunk
        return self.rfile.read(int(self.headers.get("content-length", 0)))

    def _answer(self):
        body = self._body() if self.command != "HEAD" else b""
        names = ",".join(sorted(k.lower() for k in self.headers))
        out = b"%s %s %s %s" % (self.tag, self.command.encode(),
                                self.path.encode(), body)
        self.send_response(200)
        self.send_header("content-type", "text/plain")
        self.send_header("x-seen-headers", names)
        self.send_header("content-length", str(len(out)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(out)

    do_GET = do_POST = do_HEAD = do_PUT = _answer

    def log_message(self, *args):
        pass


class _Threaded(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True


def tagged_upstream(tag: bytes):
    handler = type("Handler", (_Tagged,), {"tag": tag})
    server = _Threaded(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ref_plan():
    from pingoo_tpu.compiler import compile_ruleset
    from pingoo_tpu.config.schema import Action, RuleConfig
    from pingoo_tpu.expr import compile_expression

    rules = [RuleConfig(name=n, actions=(Action(a),),
                        expression=compile_expression(e))
             for n, e, a in RULES]
    routes = [(n, compile_expression(e)) for n, e in ROUTES]
    return compile_ruleset(rules, {}, routes=routes)


def port_plan():
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config.schema import Action, RuleConfig
    from pingoo_tpu_torch.expr import compile_expression

    rules = [RuleConfig(name=n, actions=(Action(a),),
                        expression=compile_expression(e))
             for n, e, a in RULES]
    routes = [(n, compile_expression(e)) for n, e in ROUTES]
    return compile_ruleset(rules, {}, routes=routes, device="cpu")


class Plane:
    """One package's stack: its sidecar on a ring, its httpd in front."""

    def __init__(self, tmp: Path, ring_cls, sidecar, httpd: str,
                 table: str):
        self.ring = sidecar.rings[0]
        self.sidecar = sidecar
        self.thread = threading.Thread(target=sidecar.run, daemon=True)
        self.thread.start()
        self.port = free_port()
        self.proc = subprocess.Popen(
            [httpd, str(self.port), str(tmp / "ring"), "127.0.0.1", "9",
             "--services", table],
            stdout=subprocess.PIPE, env=dict(os.environ, **PARITY_ENV))
        line = self.proc.stdout.readline()
        assert b"listening" in line, line

    def metrics(self) -> dict:
        raw = exchange(self.port, b"GET /__pingoo/metrics HTTP/1.1\r\n"
                       b"host: t\r\nuser-agent: u\r\naccept: "
                       b"application/json\r\nconnection: close\r\n\r\n")
        return json.loads(raw.partition(b"\r\n\r\n")[2])

    def stop(self) -> None:
        self.proc.kill()
        self.proc.wait()
        self.sidecar.stop()
        self.thread.join(timeout=30)
        self.ring.close()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """(the JAX package's plane, the port's) on one services table."""
    subprocess.run(["make", "-C", ref_nr.NATIVE_DIR, "httpd"], check=True,
                   capture_output=True)
    nr.ensure_built()
    tmp = tmp_path_factory.mktemp("native-parity")
    ups = [tagged_upstream(b"A"), tagged_upstream(b"B")]
    table = str(tmp / "services.tbl")
    nr.write_services_file(table, [
        (name, [("127.0.0.1", up.server_address[1])])
        for (name, _), up in zip(ROUTES, ups)])
    services = [name for name, _ in ROUTES]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REF_ENV.items():
            mp.setenv(k, v)
        (tmp / "ref").mkdir()
        (tmp / "port").mkdir()
        ref_ring = ref_nr.Ring(str(tmp / "ref" / "ring"), capacity=256,
                               create=True)
        ref = Plane(tmp / "ref", ref_nr.Ring, ref_nr.RingSidecar(
            ref_ring, ref_plan(), {}, max_batch=64, services=services,
            geoip=FakeGeoip()), os.path.join(ref_nr.NATIVE_DIR, "httpd"),
            table)
        port_ring = nr.Ring(str(tmp / "port" / "ring"), capacity=256,
                            create=True)
        port = Plane(tmp / "port", nr.Ring, nr.RingSidecar(
            port_ring, port_plan(), {}, max_batch=64, services=services,
            geoip=FakeGeoip(), device="cpu"), str(nr.httpd_path()), table)
        yield ref, port
        for plane in (ref, port):
            plane.stop()
    for up in ups:
        up.shutdown()


def exchange(port: int, payload: bytes, source: str = "127.0.0.1") -> bytes:
    """Send `payload` on one connection from `source` and read until the
    server closes it."""
    with socket.create_connection(("127.0.0.1", port), timeout=60,
                                  source_address=(source, 0)) as c:
        c.sendall(payload)
        data = b""
        while chunk := c.recv(65536):
            data += chunk
    return data


def req(method: str, target: str, ua: str = "parity/1.0", headers=(),
        body: bytes = b"", close: bool = True) -> bytes:
    lines = [f"{method} {target} HTTP/1.1", "host: parity.test"]
    if ua is not None:
        lines.append(f"user-agent: {ua}")
    lines += [f"{k}: {v}" for k, v in headers]
    if body and not any(k == "transfer-encoding" for k, _ in headers):
        lines.append(f"content-length: {len(body)}")
    if close:
        lines.append("connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


LONG = "a" * 4000
# name -> (payload, source address)
PARITY = {
    "proxied_api": (req("GET", "/api/hello"), "127.0.0.2"),
    "proxied_web": (req("GET", "/web/page?x=1"), "127.0.0.2"),
    "proxied_web_root": (req("GET", "/web"), "127.0.0.2"),
    "no_service_404": (req("GET", "/elsewhere"), "127.0.0.2"),
    "no_service_root_404": (req("GET", "/"), "127.0.0.2"),
    "blocked_path": (req("GET", "/api/evil"), "127.0.0.2"),
    "blocked_query": (req("GET", "/web?q=evil"), "127.0.0.2"),
    "blocked_no_service": (req("GET", "/evil"), "127.0.0.2"),
    "captcha_redirect": (req("GET", "/api/x", ua="sqlmap/1.8"),
                         "127.0.0.2"),
    "captcha_then_block": (req("GET", "/api/evil", ua="sqlmap/1.8"),
                           "127.0.0.2"),
    "empty_ua": (req("GET", "/api/x", ua=""), "127.0.0.2"),
    "missing_ua": (req("GET", "/api/x", ua=None), "127.0.0.2"),
    "oversized_ua": (req("GET", "/api/x", ua="U" * 300), "127.0.0.2"),
    "head": (req("HEAD", "/api/head"), "127.0.0.2"),
    "post_length": (req("POST", "/api/form", body=b"a=1&b=2"),
                    "127.0.0.2"),
    "post_chunked": (req("POST", "/web/upload",
                         headers=[("transfer-encoding", "chunked")],
                         body=b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n"),
                     "127.0.0.2"),
    "post_blocked": (req("POST", "/api/evil", body=b"x=1"), "127.0.0.2"),
    "put": (req("PUT", "/api/item/7", body=b"{}"), "127.0.0.2"),
    "spill_url_clean": (req("GET", f"/api/{LONG}"), "127.0.0.2"),
    "spill_url_blocked": (req("GET", f"/api/{LONG}?q=evil"), "127.0.0.2"),
    "spill_path_blocked": (req("GET", f"/web/{LONG}/evil"), "127.0.0.2"),
    "spill_query_clean": (req("GET", f"/web/q?x={LONG}"), "127.0.0.2"),
    "geo_kp_blocked": (req("GET", "/api/geo/1"), "127.0.0.1"),
    "geo_us_proxied": (req("GET", "/api/geo/1"), "127.0.0.2"),
    "geo_unknown_proxied": (req("GET", "/api/geo/1"), "127.0.0.3"),
    "geo_kp_other_path": (req("GET", "/api/other"), "127.0.0.1"),
    "pipelined_three": (req("GET", "/api/1", close=False)
                        + req("GET", "/web/2", close=False)
                        + req("GET", "/api/3"), "127.0.0.2"),
    "pipelined_block_middle": (req("GET", "/api/a", close=False)
                               + req("GET", "/api/evil", close=False)
                               + req("GET", "/api/c"), "127.0.0.2"),
    "pipelined_captcha_first": (req("GET", "/api/a", ua="sqlmap/1.8",
                                    close=False)
                                + req("GET", "/api/b"), "127.0.0.2"),
    "pipelined_post_then_get": (req("POST", "/api/p", body=b"k=v",
                                    close=False)
                                + req("GET", "/web/g"), "127.0.0.2"),
    "pipelined_404_then_get": (req("GET", "/nowhere", close=False)
                               + req("GET", "/api/after"), "127.0.0.2"),
    "host_with_port": (req("GET", "/api/h").replace(
        b"host: parity.test", b"host: parity.test:8080"), "127.0.0.2"),
    "encoded_target": (req("GET", "/api/%65vil?x=%3Cscript%3E"),
                       "127.0.0.2"),
    "http10": (b"GET /api/old HTTP/1.0\r\nhost: parity.test\r\n"
               b"user-agent: parity/1.0\r\n\r\n", "127.0.0.2"),
    "bad_request_line": (b"NONSENSE\r\n\r\n", "127.0.0.2"),
    "captcha_path_no_upstream": (req("GET", "/__pingoo/captcha"),
                                 "127.0.0.2"),
    "expect_continue": (req("POST", "/api/e", headers=[
        ("expect", "100-continue")], body=b"later"), "127.0.0.2"),
    "lowercase_method": (req("get", "/api/lower"), "127.0.0.2"),
    "long_header_value": (req("GET", "/web/h", headers=[
        ("x-filler", "f" * 6000)]), "127.0.0.2"),
}


def normalized(raw: bytes) -> bytes:
    """The response stream without `date:` header lines (the upstream's
    clock)."""
    return re.sub(rb"(?im)^date:[^\r\n]*\r\n", b"", raw)


@pytest.mark.parametrize("name", list(PARITY))
def test_native_parity(planes, name):
    ref, port = planes
    payload, source = PARITY[name]
    want = exchange(ref.port, payload, source)
    got = exchange(port.port, payload, source)
    assert normalized(got) == normalized(want)
    assert want, "the reference plane answered nothing"
    for plane in planes:
        m = plane.metrics()
        assert (m["fail_open"], m["degraded_entered"]) == (0, 0), m


def test_parity_reaches_every_outcome(planes):
    """The list covers each response class of the httpd, and the port's
    sidecar served the spill rows untruncated."""
    statuses = set()
    for payload, source in PARITY.values():
        raw = exchange(planes[1].port, payload, source)
        statuses |= {int(m) for m in re.findall(rb"HTTP/1\.[01] (\d{3})",
                                                raw)}
    assert {200, 302, 400, 403, 404} <= statuses, statuses
    assert planes[1].sidecar.spilled_rows > 0
    assert planes[1].metrics()["blocked"] > 0


# -- the entry point ----------------------------------------------------------

def native_config(tmp_path: Path, port: int, up_port: int) -> Path:
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
    """))
    return cfg


def httpd_children(pid: int) -> list[int]:
    """The pids of `pid`'s children running the port's httpd."""
    binary = str(nr.httpd_path()).encode()
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
            argv0 = (d / "cmdline").read_bytes().split(b"\0", 1)[0]
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and argv0 == binary:
            out.append(int(d.name))
    return out


def gone(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return True
    return state.split()[0] == "Z"


def test_python_m_native_plane_serves_and_drains(tmp_path):
    nr.ensure_built()
    up = tagged_upstream(b"up")
    port = free_port()
    cfg = native_config(tmp_path, port, up.server_address[1])
    env = dict(os.environ, PYTHONPATH=str(REPO), PINGOO_LOG="warning")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pingoo_tpu_torch", "--native-plane",
         "--config", str(cfg), "--state-dir", str(tmp_path / "state"),
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
        children = httpd_children(proc.pid)
        blocked = exchange(port, req("GET", "/.env"))
        proxied = exchange(port, req("GET", "/hello"))
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        drain_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        up.shutdown()
    assert len(children) == 1
    assert blocked.startswith(b"HTTP/1.1 403") and blocked.endswith(
        b"Forbidden")
    assert proxied.startswith(b"HTTP/1.1 200") and proxied.endswith(
        b"up GET /hello ")
    assert rc == 0, proc.stderr.read()[-3000:]
    assert drain_s < 20
    assert all(gone(pid) for pid in children)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_native_plane_defaults_to_the_card(tmp_path):
    from pingoo_tpu_torch.__main__ import main
    from pingoo_tpu_torch.config import load_and_validate
    from pingoo_tpu_torch.host.native_plane import NativePlane

    cfg = native_config(tmp_path, free_port(), 9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NativePlane(load_and_validate(str(cfg)), str(tmp_path / "state"),
                    enable_docker=False,
                    captcha_jwks_path=str(tmp_path / "jwks.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--native-plane", "--config", str(cfg), "--state-dir",
              str(tmp_path / "state"), "--no-docker", "--captcha-jwks",
              str(tmp_path / "jwks.json")])
    assert not (tmp_path / "state").exists()


# -- the builds ---------------------------------------------------------------

def test_binaries_built_into_build_dir_by_hash():
    took = nr.ensure_built()
    assert set(took) == {"libpingoo_ring", *nr.BINARIES}
    for name in nr.BINARIES:
        path = nr.binary_path(name)
        assert path.parent == nr.BUILD_DIR
        assert re.fullmatch(rf"{name}-[0-9a-f]{{16}}", path.name), path
        assert os.access(path, os.X_OK)
        assert nr.build_binary(name) == 0.0  # built: not again
    assert nr.httpd_path() == nr.binary_path("httpd")


@pytest.fixture
def native_copy(tmp_path, monkeypatch):
    """The port's native sources in a scratch directory, built into
    another."""
    src = tmp_path / "native"
    shutil.copytree(nr.NATIVE_DIR, src)
    monkeypatch.setattr(nr, "NATIVE_DIR", src)
    monkeypatch.setattr(nr, "BUILD_DIR", tmp_path / "_build")
    return src


def test_binary_name_holds_the_hash(native_copy, monkeypatch):
    before = {name: nr.binary_path(name) for name in nr.BINARIES}
    with open(native_copy / "ossl_shim.h", "a") as f:
        f.write("\n// edited\n")
    after = {name: nr.binary_path(name) for name in nr.BINARIES}
    assert after["httpd"] != before["httpd"]  # a header of the httpd
    assert after["pong"] == before["pong"]
    listing = nr._ldconfig_listing()
    monkeypatch.setattr(nr, "_ldconfig_listing", lambda: listing.replace(
        "libssl.so.3 ", "libssl.so.1.1 ").replace(
        "libcrypto.so.3 ", "libcrypto.so.1.1 "))
    assert nr.tls_sonames()[:2] == ("libssl.so.1.1", "libcrypto.so.1.1")
    assert nr.binary_path("httpd") != after["httpd"]  # another link line


def test_build_raises_without_a_compiler(native_copy, monkeypatch):
    monkeypatch.setattr(nr.shutil, "which", lambda name: None)
    for build in (nr.build_httpd, *(functools.partial(nr.build_binary, name)
                                    for name in nr.BINARIES),
                  nr.ensure_built):
        with pytest.raises(RuntimeError, match="no C.. compiler"):
            build()
    assert not (nr.BUILD_DIR).exists()


@pytest.mark.parametrize("soname", ["libssl.so", "libcrypto.so",
                                    "libnghttp2.so.14"])
def test_build_raises_without_a_soname(native_copy, monkeypatch, soname):
    listing = "\n".join(
        line for line in nr._ldconfig_listing().splitlines()
        if not line.strip().startswith(soname))
    monkeypatch.setattr(nr, "_ldconfig_listing", lambda: listing)
    with pytest.raises(RuntimeError, match=re.escape(soname)):
        nr.build_httpd()
    assert nr.build_binary("pong") > 0  # links neither
    assert not nr.binary_path("pong").with_name("httpd").exists()


def test_failed_build_raises_with_the_compiler_stderr(native_copy):
    (native_copy / "pong.cc").write_text("int main() { return nope; }\n")
    with pytest.raises(RuntimeError, match="pong build failed(.|\n)*nope"):
        nr.build_binary("pong")
    assert list(nr.BUILD_DIR.iterdir()) == []  # no partial binary


# -- the sidecar's warm-up, and a dead sidecar --------------------------------

def test_warm_up_runs_every_row_bucket(tmp_path):
    plan = port_plan()
    ring = nr.Ring(str(tmp_path / "ring"), capacity=64, create=True)
    try:
        sidecar = nr.RingSidecar(ring, plan, {}, max_batch=32, device="cpu")
        out = sidecar.warm_up()
        sidecar.stop()
        assert [(rows, width) for rows, width, _ in out] == [
            (8, 64), (8, 2048), (16, 64), (16, 2048), (32, 64), (32, 2048)]
        assert (sidecar.processed, sidecar.batches) == (0, 0)
        assert ring.telemetry()["dequeued"] == 0
    finally:
        ring.close()


def test_runner_logs_a_dead_sidecar(tmp_path, caplog):
    from pingoo_tpu_torch.config import load_and_validate
    from pingoo_tpu_torch.host.native_plane import NativePlane

    plane = NativePlane(
        load_and_validate(str(native_config(tmp_path, free_port(), 9))),
        str(tmp_path / "state"), device="cpu", enable_docker=False,
        captcha_jwks_path=str(tmp_path / "jwks.json"))

    class Dying:
        def run(self):
            raise RuntimeError("CUDA error: an illegal memory access")

    plane.sidecar = Dying()
    with pytest.raises(RuntimeError, match="illegal memory"):
        plane._run_sidecar()
    assert isinstance(plane.sidecar_error, RuntimeError)
    assert any(r.levelname == "ERROR" and "sidecar died" in r.getMessage()
               for r in caplog.records)

