"""CLI entrypoint: `python -m pingoo_tpu_torch [--config PATH]`.

Reference parity (pingoo/main.rs:33-85): logging init -> config load ->
shutdown signal watch -> optional child process (sidecar mode,
main.rs:60-80) -> server run. The reference takes no CLI flags and uses
fixed /etc/pingoo paths; we accept overrides for testability but default
to the same locations.

The rules run on the CUDA card, and the server refuses to start without
one; `--no-device` runs the kernels' plain versions on the CPU instead.
`--native-plane` puts the C++ httpd (built from `native/` at first use)
on the listeners' addresses, each verdict from the ring sidecar, and
moves the Python plane to loopback (`host/native_plane.py`).
"""

from __future__ import annotations

import argparse
import asyncio
import subprocess
import sys

from .config import DEFAULT_CONFIG_FILE, ConfigError, load_and_validate
from .host.captcha import DEFAULT_JWKS_PATH
from .logging_utils import get_logger, init_logging

log = get_logger("pingoo_tpu_torch")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pingoo-tpu-torch")
    parser.add_argument("--config", default=DEFAULT_CONFIG_FILE)
    parser.add_argument("--no-device", action="store_true",
                        help="run the rules engine on the CPU (the "
                             "kernels' plain versions) instead of the "
                             "CUDA card")
    parser.add_argument("--no-docker", action="store_true")
    parser.add_argument("--captcha-jwks", default=DEFAULT_JWKS_PATH,
                        help="captcha signing key set (created on first "
                             "boot)")
    parser.add_argument("--cache-dir", default=None,
                        help="compiled-ruleset artifact cache directory")
    parser.add_argument("--bot-score-params", default=None,
                        help="npz of trained bot-score head weights")
    parser.add_argument("--native-plane", action="store_true",
                        help="front traffic with the C++ data plane "
                             "(epoll httpd + shared-memory verdict ring); "
                             "the Python plane moves to loopback as the "
                             "captcha/fail-open target")
    parser.add_argument("--native-workers", type=int, default=1,
                        help="SO_REUSEPORT httpd workers per listener "
                             "(one verdict ring each)")
    parser.add_argument("--state-dir", default="/var/run/pingoo",
                        help="ring files + services table directory "
                             "(native plane)")
    parser.add_argument("--upstream-ca", default=None,
                        help="PEM trust bundle for TLS upstream hops "
                             "(native plane; system roots by default)")
    args = parser.parse_args(argv)

    init_logging()
    try:
        config = load_and_validate(args.config)
    except ConfigError as exc:
        log.error(str(exc))
        return 1

    child = None
    if config.child_process is not None:
        # Sidecar mode: run the fronted app as a child (main.rs:60-80).
        child = subprocess.Popen(list(config.child_process.command))
        log.info("child process started",
                 extra={"fields": {"pid": child.pid}})

    log.info("starting pingoo-tpu-torch", extra={"fields": {
        "config": args.config,
        "listeners": [f"{l.protocol.value}://{l.host}:{l.port}"
                      for l in config.listeners],
        "rules": len(config.rules),
        "device": not args.no_device,
        "native_plane": args.native_plane,
    }})
    device = "cpu" if args.no_device else None
    server_kwargs = dict(enable_docker=not args.no_docker,
                         captcha_jwks_path=args.captcha_jwks,
                         cache_dir=args.cache_dir,
                         bot_score_params_path=args.bot_score_params)
    try:
        if args.native_plane:
            from .host.native_plane import run_native

            asyncio.run(run_native(
                config, state_dir=args.state_dir,
                workers=args.native_workers, upstream_ca=args.upstream_ca,
                device=device, **server_kwargs))
        else:
            from .host.server import run

            asyncio.run(run(config, device=device, **server_kwargs))
    except KeyboardInterrupt:
        pass
    finally:
        if child is not None:
            child.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
