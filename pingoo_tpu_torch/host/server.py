"""Server orchestrator: wire config -> registry, geoip, captcha, lists,
verdict engine, services, TLS, listeners; run until shutdown.

Reference parity (pingoo/server.rs:33-150 + main.rs:33-107): build the
service registry and start background discovery, load geoip (optional),
captcha manager, lists; construct per-listener service sets; TLS manager
for https/tcp+tls listeners; bind everything, then serve concurrently
with graceful shutdown. The addition over the reference is the
VerdictService between listeners and rules: the ruleset is compiled once
at boot (config errors fail fast, as in the reference where expressions
compile during config load) into the plan's tables on the device.

`device=None` is the CUDA card and raises without one; `device="cpu"`
runs the kernels' plain versions on the CPU (tests, `--no-device`).
"""

from __future__ import annotations

import asyncio
import os
import signal
from typing import Optional

from ..compiler.cache import compile_ruleset_cached
from ..config.schema import Config
from ..device import check_env, pipeline_mode, resolve_device
from ..engine.service import VerdictService
from ..lists import load_lists
from ..logging_utils import get_logger
from ..sched import SchedulerConfig, mesh_env_spec
from .captcha import CaptchaManager
from .discovery import ServiceRegistry
from .geoip import GeoipDB
from .httpd import HttpListener
from .services import TcpProxyService, build_http_services

log = get_logger(__name__)


class Server:
    def __init__(
        self,
        config: Config,
        device=None,
        geoip_paths: Optional[tuple] = None,
        captcha_jwks_path: str = "/etc/pingoo/captcha_jwks.json",
        tls_dir: str = "/etc/pingoo/tls",
        enable_docker: bool = True,
        cache_dir: Optional[str] = None,
        bot_score_params_path: Optional[str] = None,
        xff_token: Optional[str] = None,
        tls_alpn: bool = False,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.geoip_paths = geoip_paths
        self.captcha_jwks_path = captcha_jwks_path
        self.tls_dir = tls_dir
        self.enable_docker = enable_docker
        # The compiled-ruleset artifact cache (compiler/cache.py) and the
        # bot head's npz weights (models/botscore.py), both optional.
        self.cache_dir = cache_dir
        self.bot_score_params_path = bot_score_params_path
        # Deployment flags passed EXPLICITLY (never through process-
        # global env vars, which any co-resident Server would inherit):
        # - xff_token: per-boot token; the listeners trust
        #   x-forwarded-for ONLY on requests carrying it (a data plane
        #   in front sends it on loopback control-plane hops).
        # - tls_alpn: a native TLS transport fronts the public ports,
        #   so ACME validates via tls-alpn-01 (http-01 would hit the
        #   native verdict path, not the challenge handler).
        self.xff_token = xff_token
        self.tls_alpn = tls_alpn
        self.registry: Optional[ServiceRegistry] = None
        self.verdict: Optional[VerdictService] = None
        self.http_listeners: list[HttpListener] = []
        self.tcp_servers: list[asyncio.AbstractServer] = []
        self.acme = None

    async def start(self) -> None:
        config = self.config
        self.registry = ServiceRegistry(
            config.services,
            docker_socket=config.service_discovery.docker_socket,
            enable_docker=self.enable_docker)
        await self.registry.start_in_background()

        geoip = (GeoipDB.load(self.geoip_paths) if self.geoip_paths
                 else GeoipDB.load())
        captcha = CaptchaManager(self.captcha_jwks_path)
        lists = load_lists(config.lists)
        self.geoip = geoip
        self.lists = lists

        # The knobs of features the port does not have raise here, before
        # any table is built, and so does a malformed PINGOO_MESH; the
        # admission policy the planes will run under is logged.
        check_env()
        mesh_spec = mesh_env_spec()
        sched_cfg = SchedulerConfig.from_env(max_batch=1024)
        log.info("scheduler config", extra={"fields": {
            "device": str(self.device),
            "mesh": "x".join(str(d) for d in mesh_spec),
            "mode": sched_cfg.mode, "deadline_ms": sched_cfg.deadline_ms,
            "failopen": sched_cfg.failopen, "pipeline": pipeline_mode()}})

        # Service route predicates compile into the same plan as extra
        # verdict columns (rules AND routing decided by one batch).
        routes = [(s.name, s.route) for s in config.services]
        plan = compile_ruleset_cached(
            list(config.rules), lists, cache_dir=self.cache_dir,
            routes=routes, device=self.device)
        self.plan = plan
        bot_params = None
        if self.bot_score_params_path:
            from ..models.botscore import load_params

            bot_params = load_params(self.bot_score_params_path,
                                     device=self.device)
        self.verdict = VerdictService(plan, lists, device=self.device,
                                      bot_score_params=bot_params)
        await self.verdict.start()

        tls_manager = None
        if any(l.protocol.is_tls for l in config.listeners) or \
                config.tls.acme is not None:
            # Imported only here: TLS needs the `cryptography` package,
            # a plain-HTTP deployment does not.
            from .tlsmgr import TlsManager

            tls_manager = TlsManager(self.tls_dir)

        acme_challenges = None
        if config.tls.acme is not None and config.tls.acme.domains:
            from .acme import AcmeManager

            # Challenge type is an EXPLICIT deployment choice:
            # tls_alpn=True means a native TLS transport fronts port 443
            # and answers acme-tls/1 from <tls_dir>/alpn (tls-alpn-01,
            # the reference's only challenge type, acme.rs:180-242).
            # Without it, the Python-only deployment uses http-01.
            alpn_dir = None
            if self.tls_alpn:
                alpn_dir = os.path.join(self.tls_dir, "alpn")
                os.makedirs(alpn_dir, exist_ok=True)
            self.acme = AcmeManager(
                self.tls_dir, list(config.tls.acme.domains),
                directory_url=config.tls.acme.directory_url,
                tls_manager=tls_manager, alpn_dir=alpn_dir)
            acme_challenges = self.acme.challenges
            await self.acme.start_in_background()

        services_by_name = {s.name: s for s in config.services}
        for listener_cfg in config.listeners:
            listener_services = [services_by_name[n]
                                 for n in listener_cfg.services]
            if listener_cfg.protocol.is_http:
                http_services = build_http_services(
                    listener_services, self.registry)
                listener = HttpListener(
                    name=listener_cfg.name,
                    host=listener_cfg.host,
                    port=listener_cfg.port,
                    services=http_services,
                    verdict=self.verdict,
                    lists=lists,
                    rules_meta=plan.rules,
                    captcha=captcha,
                    geoip=geoip,
                    tls_context=(tls_manager.server_context()
                                 if listener_cfg.protocol.is_tls else None),
                    acme_challenges=acme_challenges,
                    xff_token=self.xff_token,
                    # Columns are looked up by the BUILT services' names:
                    # build_http_services may drop non-http entries, so a
                    # positional zip against the config list could hand a
                    # service another service's route column.
                    route_indices=[plan.route_index.get(s.name)
                                   for s in http_services],
                )
                await listener.bind()
                self.http_listeners.append(listener)
            else:
                svc = TcpProxyService(listener_services[0], self.registry)
                ssl_ctx = (tls_manager.server_context()
                           if listener_cfg.protocol.is_tls else None)
                server = await asyncio.start_server(
                    svc.serve_connection, listener_cfg.host,
                    listener_cfg.port, ssl=ssl_ctx, backlog=2048)
                self.tcp_servers.append(server)

    async def serve_forever(self) -> None:
        tasks = [asyncio.create_task(l.serve_forever())
                 for l in self.http_listeners]
        tasks += [asyncio.create_task(s.serve_forever())
                  for s in self.tcp_servers]
        if tasks:
            await asyncio.gather(*tasks)

    async def stop(self) -> None:
        for listener in self.http_listeners:
            await listener.close()
            for service in listener.services:
                close = getattr(service, "close", None)
                if close is not None:
                    await close()
        for server in self.tcp_servers:
            server.close()
            await server.wait_closed()
        if self.acme is not None:
            await self.acme.stop()
        if self.verdict is not None:
            await self.verdict.stop()
        if self.registry is not None:
            await self.registry.stop()


async def run(config: Config, **kwargs) -> None:
    """main() equivalent (reference main.rs:33-85): build, serve, and
    shut down gracefully on SIGINT/SIGTERM."""
    server = Server(config, **kwargs)
    await server.start()
    loop = asyncio.get_running_loop()
    stop_event = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop_event.set)
        except NotImplementedError:
            pass
    serve_task = asyncio.create_task(server.serve_forever())
    await stop_event.wait()
    serve_task.cancel()
    # Graceful-shutdown cap (reference listeners/mod.rs:28: 20 s).
    try:
        await asyncio.wait_for(server.stop(), timeout=20)
    except asyncio.TimeoutError:
        pass
    finally:
        # The drain must write out a live torch.profiler trace even when
        # stop() hit the 20 s cap mid-way: it is buffered in memory; and
        # persist the scheduler's cost ledger, which stop() may not have
        # reached. (The JAX package also dumps its flight recorders here:
        # ROADMAP.md item 10, slice 3.)
        if server.verdict is not None:
            server.verdict.ensure_trace_stopped()
            server.verdict.persist_cost_ledger()
