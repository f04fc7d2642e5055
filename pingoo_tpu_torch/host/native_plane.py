"""The native-plane runner: the C++ httpd as the data plane, in front of
the port's RingSidecar on the card.

    client
      -> httpd (native/httpd.cc)  the public address: TLS with SNI and
                                  acme-tls/1, h1/h2, the captcha cookie
                                  gate, each request's verdict from the
                                  ring, routing over the services table,
                                  a drain of at most 20 s on SIGTERM
           -> upstreams           chosen by the verdict's route bits
           -> the Python plane    on loopback: the fail-open target (ring
                                  full, verdict deadline), the captcha
                                  endpoints, static files over 500 KB,
                                  upstreams the httpd cannot resolve

This process runs the port's Python plane (`host/server.py`) moved to
loopback ports, so that a degraded hop still meets the rules; the
`RingSidecar`, whose lane function runs the NFA, DFA and prefilter
kernels on every batch; a republisher that writes each listener's
services table every 2 s (the reference's discovery tick) when the
registry changed, which the httpd reloads on its mtime; and the httpd
children, one per (listener, worker), each with a ring of its own.
TCP(+TLS) listeners are fronted by the same binary in --tcp-proxy mode.

There is no fallback: a failed build, bind or warm-up ends `start()`
with its error, and a device error ends the sidecar's thread (logged
here), after which its heartbeat stops and the httpd fails requests
open, as for a dead sidecar.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import secrets
import signal
import socket
import subprocess
import threading
from typing import Optional

from .. import native_ring
from ..config.schema import Config, ListenerProtocol
from ..logging_utils import get_logger
from .server import Server

log = get_logger("pingoo_tpu_torch.native_plane")

REPUBLISH_INTERVAL_S = 2.0  # the reference's discovery tick
DRAIN_CAP_S = 20.0  # the reference's graceful-shutdown cap
BIND_TIMEOUT_S = 60.0  # an httpd's "listening" banner, after cert/ring set-up
RING_CAPACITY = 16384
SIDECAR_MAX_BATCH = 1024


def _loopback_rebase(config: Config) -> Config:
    """The config with every HTTP(S) listener moved to loopback port 0 in
    the clear (the kernel picks the port at bind: no pick-then-rebind
    race; `NativePlane.start` reads the bound ports back). TLS ends at
    the httpd; TCP listeners are the httpd's alone."""
    listeners = []
    for listener in config.listeners:
        if not listener.protocol.is_http:
            continue
        proto = listener.protocol
        if proto == ListenerProtocol.HTTPS:
            proto = ListenerProtocol.HTTP
        listeners.append(dataclasses.replace(
            listener, host="127.0.0.1", port=0, protocol=proto))
    return dataclasses.replace(config, listeners=type(config.listeners)(
        listeners))


class NativePlane:
    """The httpd processes, the ring sidecar and the loopback plane.

    `device=None` is the CUDA card (the Server raises without one);
    "cpu" runs the kernels' plain versions. `server_kwargs` go to the
    loopback `Server`."""

    def __init__(self, config: Config, state_dir: str, device=None,
                 workers: int = 1, upstream_ca: Optional[str] = None,
                 **server_kwargs):
        self.config = config
        self.state_dir = state_dir
        self.workers = max(1, workers)
        # TLS upstream hops verify against the system roots, or this
        # bundle for private CAs.
        self.upstream_ca = upstream_ca or os.environ.get(
            "PINGOO_UPSTREAM_CA") or None
        # A per-boot token binds x-forwarded-for trust to this data
        # plane: the httpd sends it on loopback hops, the loopback
        # listeners trust XFF only with it. It goes to the children in a
        # 0600 file, never in argv (/proc/<pid>/cmdline is world-readable).
        self._internal_token = secrets.token_hex(16)
        self._token_path = os.path.join(state_dir, "internal.token")
        tls_alpn = bool(config.tls.acme is not None
                        and config.tls.acme.domains)
        self.server = Server(_loopback_rebase(config), device=device,
                             xff_token=self._internal_token,
                             tls_alpn=tls_alpn, **server_kwargs)
        self._loopback_ports: dict[str, int] = {}
        self.sidecar: Optional[native_ring.RingSidecar] = None
        self.sidecar_error: Optional[BaseException] = None
        self._sidecar_thread: Optional[threading.Thread] = None
        self.warm_up: list = []  # RingSidecar.warm_up's batches
        self.rings: list[native_ring.Ring] = []
        self.procs: list[subprocess.Popen] = []
        self._republish_task = None
        # Per listener: its ordered service names and its own routing
        # table (a listener's verdict route field indexes its own list).
        self._listener_services: dict[str, list[str]] = {}
        self.services_paths: dict[str, str] = {}

    async def start(self) -> None:
        await asyncio.to_thread(native_ring.build_ring_lib)
        await asyncio.to_thread(native_ring.build_httpd)
        httpd = str(native_ring.httpd_path())
        os.makedirs(self.state_dir, exist_ok=True)
        fd = os.open(self._token_path,
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(self._internal_token)

        await self.server.start()
        self._loopback_ports = {l.name: l.bound_port
                                for l in self.server.http_listeners}
        if any(l.protocol.is_tls for l in self.config.listeners):
            # The rebased config has no TLS listener, so the Server made
            # no TlsManager; the httpd terminates TLS from its store
            # (first boot writes the self-signed default).
            from .tlsmgr import TlsManager

            TlsManager(self.server.tls_dir)

        http_listeners = [l for l in self.config.listeners
                          if l.protocol.is_http]
        if not http_listeners:
            raise RuntimeError("native plane needs at least one http(s) "
                               "listener")
        for listener in http_listeners:
            self._listener_services[listener.name] = [
                n for n in listener.services if self._is_http_service(n)]
            self.services_paths[listener.name] = os.path.join(
                self.state_dir, f"services_{listener.name}.tbl")

        # One ring per (listener, worker): the verdict queue is MPMC, so
        # two httpds on one ring would take each other's tickets.
        ring_paths: dict[tuple[str, int], str] = {}
        ring_services: list = []
        for listener in http_listeners:
            for w in range(self.workers):
                path = os.path.join(self.state_dir,
                                    f"ring_{listener.name}_{w}")
                ring_paths[(listener.name, w)] = path
                self.rings.append(native_ring.Ring(
                    path, capacity=RING_CAPACITY, create=True))
                ring_services.append(
                    self._listener_services[listener.name] or None)
        server = self.server
        self.sidecar = await asyncio.to_thread(
            native_ring.RingSidecar, self.rings, server.plan, server.lists,
            max_batch=SIDECAR_MAX_BATCH, ring_services=ring_services,
            geoip=server.geoip, device=server.device)
        if server.device.type == "cuda":
            # Before any httpd enqueues: the first batch of each row
            # bucket pays one-time costs on the card that the httpd's
            # 3 s verdict deadline would turn into fail-opens. On the CPU
            # nothing loads lazily.
            self.warm_up = await asyncio.to_thread(self.sidecar.warm_up)
            log.info("sidecar warmed up", extra={"fields": {
                "batches": len(self.warm_up),
                "ms": round(sum(ms for *_, ms in self.warm_up), 1)}})
        self._sidecar_thread = threading.Thread(
            target=self._run_sidecar, name="pingoo-ring-sidecar",
            daemon=True)
        self._sidecar_thread.start()

        await asyncio.to_thread(self._write_services)

        tls_dir = server.tls_dir
        alpn_dir = os.path.join(tls_dir, "alpn")
        for listener in http_listeners:
            fail_open_port = self._loopback_ports[listener.name]
            for w in range(self.workers):
                argv = [
                    httpd, str(listener.port),
                    ring_paths[(listener.name, w)],
                    "127.0.0.1", str(fail_open_port),
                    "--captcha-upstream", f"127.0.0.1:{fail_open_port}",
                    "--jwks", server.captcha_jwks_path,
                    "--services", self.services_paths[listener.name],
                    "--bind", listener.host,
                    "--internal-token-file", self._token_path,
                ]
                if listener.protocol.is_tls:
                    argv += ["--tls-dir", tls_dir]
                    if os.path.isdir(alpn_dir):
                        argv += ["--alpn-dir", alpn_dir]
                if self.upstream_ca:
                    argv += ["--upstream-ca", self.upstream_ca]
                await self._spawn(argv, listener)
            log.info("native listener up", extra={"fields": {
                "listener": listener.name,
                "address": f"{listener.host}:{listener.port}",
                "tls": listener.protocol.is_tls,
                "workers": self.workers,
                "fail_open": f"127.0.0.1:{fail_open_port}",
            }})

        # TCP(+TLS) listeners: the same binary in --tcp-proxy mode
        # (accept, end TLS, pick a random upstream from the table, splice).
        tcp_listeners = [l for l in self.config.listeners
                         if not l.protocol.is_http]
        for listener in tcp_listeners:
            # config validation: exactly one service per tcp listener
            self._listener_services[listener.name] = list(listener.services)
            self.services_paths[listener.name] = os.path.join(
                self.state_dir, f"services_{listener.name}.tbl")
        if tcp_listeners:
            await asyncio.to_thread(self._write_services)
        for listener in tcp_listeners:
            ring_path = os.path.join(self.state_dir,
                                     f"ring_{listener.name}_tcp")
            # The ring argument is mandatory but unused in tcp mode: raw
            # streams get no verdict.
            self.rings.append(native_ring.Ring(ring_path, capacity=64,
                                               create=True))
            for _ in range(self.workers):
                argv = [
                    httpd, str(listener.port), ring_path,
                    "127.0.0.1", "9",  # unused: the table routes
                    "--services", self.services_paths[listener.name],
                    "--bind", listener.host,
                    "--tcp-proxy",
                ]
                if listener.protocol.is_tls:
                    argv += ["--tls-dir", tls_dir]
                    if os.path.isdir(alpn_dir):
                        argv += ["--alpn-dir", alpn_dir]
                await self._spawn(argv, listener)
            log.info("native tcp listener up", extra={"fields": {
                "listener": listener.name,
                "address": f"{listener.host}:{listener.port}",
                "tls": listener.protocol.is_tls,
                "workers": self.workers,
            }})
        self._republish_task = asyncio.create_task(self._republish_loop())

    async def _spawn(self, argv: list, listener) -> None:
        """Start one httpd and wait for its bind banner; then a thread
        drains its output for its lifetime (a chatty child against a full,
        unread pipe would block inside the data plane)."""
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE)
        self.procs.append(proc)  # before the bind check: stop() reaps it
        try:
            # A wedged child must not freeze the loop (the loopback plane
            # and the signal handlers run on it).
            line = await asyncio.wait_for(
                asyncio.to_thread(proc.stdout.readline),
                timeout=BIND_TIMEOUT_S)
        except asyncio.TimeoutError:
            raise RuntimeError(
                f"native httpd stalled before binding "
                f"{listener.host}:{listener.port}") from None
        if b"listening" not in line:
            raise RuntimeError(
                f"native httpd failed to bind "
                f"{listener.host}:{listener.port}: {line!r}")
        threading.Thread(target=self._pump_child_output, args=(proc,),
                         daemon=True).start()

    def _run_sidecar(self) -> None:
        try:
            self.sidecar.run()
        except BaseException as exc:
            self.sidecar_error = exc
            log.error("ring sidecar died: the native plane fails requests "
                      "open until it is restarted", exc_info=exc,
                      extra={"fields": {"error": repr(exc)}})
            raise

    @staticmethod
    def _pump_child_output(proc) -> None:
        for raw in proc.stdout:
            line = raw.decode("utf-8", "replace").rstrip()
            if line:
                log.info("native httpd", extra={"fields": {
                    "pid": proc.pid, "line": line}})

    def _is_http_service(self, name: str) -> bool:
        svc = next(s for s in self.config.services if s.name == name)
        return svc.tcp_proxy is None

    def _loopback_target(self, lname: str) -> tuple:
        """Listener `lname`'s own loopback hop (its route set, never
        another listener's)."""
        return ("127.0.0.1", self._loopback_ports[lname],
                native_ring.INTERNAL)

    def _service_upstreams(self, name: str) -> tuple:
        """One service's (upstreams, static_root, needs_loopback). Plain,
        TLS and h2 upstreams are published for the httpd; a static
        service publishes its root (the httpd serves files of up to 500
        KB, the loopback plane streams larger ones); an upstream whose
        address does not resolve is left to the loopback plane. The
        loopback entry is appended per listener by `_write_services`."""
        svc = next(s for s in self.config.services if s.name == name)
        ups: list = []
        via_python = False
        static_root = None
        if svc.tcp_proxy is not None:
            # Raw TCP has no loopback fallback; an unresolvable upstream
            # is skipped this tick.
            for u in self.server.registry.get_upstreams(name):
                try:
                    addr = socket.gethostbyname(u.ip or u.hostname)
                except OSError:
                    continue
                ups.append((addr, u.port))
            return ups, None, False
        if svc.static is not None:
            root = svc.static.root
            if root and len(root) <= 383 and not any(
                    ch.isspace() for ch in root):
                static_root = root
            via_python = True
        else:
            for u in self.server.registry.get_upstreams(name):
                try:
                    addr = socket.gethostbyname(u.ip or u.hostname)
                except OSError:
                    # Unresolvable here (or IPv6 only): the Python proxy
                    # may still reach it.
                    via_python = True
                    continue
                if u.h2:
                    ups.append((addr, u.port, native_ring.H2))
                elif u.tls:
                    # Verify against the configured name, or the literal
                    # address (IP SAN); the 4-tuple form is unambiguous.
                    ups.append((addr, u.port, "tls", u.hostname or addr))
                else:
                    ups.append((addr, u.port))
        return ups, static_root, via_python

    def _write_services(self) -> None:
        """Snapshot the registry into each listener's own table, in that
        listener's service order (in a worker thread: gethostbyname
        blocks)."""
        resolved = {name: self._service_upstreams(name)
                    for names in self._listener_services.values()
                    for name in names}
        for lname, names in self._listener_services.items():
            table = []
            for n in names:
                ups, static_root, needs_loopback = resolved[n]
                if needs_loopback and lname in self._loopback_ports:
                    ups = ups + [self._loopback_target(lname)]
                table.append((n, ups, static_root))
            native_ring.write_services_file(self.services_paths[lname],
                                            table)

    async def _republish_loop(self) -> None:
        last = None
        while True:
            await asyncio.sleep(REPUBLISH_INTERVAL_S)
            try:
                snapshot = [
                    (n, tuple(
                        (u.ip or u.hostname, u.port, u.tls)
                        for u in self.server.registry.get_upstreams(n)))
                    for names in self._listener_services.values()
                    for n in names
                ]
                if snapshot != last:
                    await asyncio.to_thread(self._write_services)
                    last = snapshot
            except Exception as exc:  # a blip must not end the loop
                log.warning("services republish failed",
                            extra={"fields": {"error": repr(exc)}})

    async def serve_forever(self) -> None:
        await self.server.serve_forever()

    async def stop(self) -> None:
        if self._republish_task is not None:
            self._republish_task.cancel()
        # SIGTERM starts each httpd's drain; it exits when idle or at its
        # own cap, and is killed past ours.
        for proc in self.procs:
            log.info("draining native worker", extra={"fields": {
                "pid": proc.pid, "poll": proc.poll()}})
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + DRAIN_CAP_S
        for proc in self.procs:
            try:
                await asyncio.wait_for(
                    asyncio.to_thread(proc.wait),
                    timeout=max(0.5, deadline - loop.time()))
            except asyncio.TimeoutError:
                proc.kill()
                await asyncio.to_thread(proc.wait)
        if self.sidecar is not None:
            self.sidecar.stop()
        if self._sidecar_thread is not None:
            self._sidecar_thread.join(timeout=10)
        for ring in self.rings:
            ring.close()
        await self.server.stop()


async def run_native(config: Config, state_dir: str, **kwargs) -> None:
    """The native plane's main(): build, serve, drain on SIGINT/SIGTERM."""
    plane = NativePlane(config, state_dir, **kwargs)
    try:
        await plane.start()
    except BaseException:
        # A partial start must not leave httpds holding public ports
        # with no consumer on their rings.
        await plane.stop()
        raise
    loop = asyncio.get_running_loop()
    stop_event = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop_event.set)
        except NotImplementedError:
            pass
    serve_task = asyncio.create_task(plane.serve_forever())
    await stop_event.wait()
    log.info("shutdown signal: draining native plane")
    serve_task.cancel()
    try:
        await plane.stop()
    finally:
        if plane.server.verdict is not None:
            plane.server.verdict.ensure_trace_stopped()
    log.info("native plane drained")
