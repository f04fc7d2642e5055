"""YAML config loading + validation.

Reference parity (pingoo/config/config.rs load_and_validate,
config_file.rs parsers):

  * listeners: name -> {address: "proto://ip[:port]", services: [..]};
    protocols http/https/tcp/tcp+tls; default ports 80/443 for http/https,
    required otherwise; host must be a literal ip (config_file.rs:145-188).
  * services: name -> exactly one of http_proxy/tcp_proxy/static, plus an
    optional `route` expression compiled at load time; tcp_proxy can't
    have a route (config_file.rs:190-274).
  * upstream URLs: scheme tcp/http/https, ascii host required, default
    port from scheme, https => tls, localhost -> 127.0.0.1
    (config_file.rs:280-333).
  * rules from the main file plus every *.yml in the rules folder,
    duplicate names rejected (config.rs:378-422, 206-213).
  * listener validation: duplicate ports, no services, >1 service on tcp,
    unknown/duplicate service names (config.rs:325-376).
  * acme: trimmed directory url, duplicate/wildcard/non-ascii-lowercase
    domains rejected (config.rs:269-303).

Unlike the reference's fixed /etc/pingoo paths (config.rs:24-38), every
path is parameterizable so the framework is testable; the defaults match
the reference.

PyYAML is imported only where a file is read (`load_and_validate` and the
rules folder), so `parse_config` over a mapping needs no YAML package.
"""

from __future__ import annotations

import ipaddress
import os
from typing import Any, Mapping
from urllib.parse import urlsplit

from ..expr import CompileError, Program, compile_expression
from .schema import (
    AcmeConfig,
    Action,
    ChildProcess,
    Config,
    ConfigError,
    ListConfig,
    ListenerConfig,
    ListenerProtocol,
    ListType,
    RuleConfig,
    ServiceConfig,
    ServiceDiscoveryConfig,
    StaticSiteConfig,
    StaticSiteNotFound,
    TlsConfig,
    Upstream,
)

DEFAULT_CONFIG_DIR = "/etc/pingoo"
DEFAULT_CONFIG_FILE = os.path.join(DEFAULT_CONFIG_DIR, "pingoo.yml")
LETSENCRYPT_PRODUCTION_URL = "https://acme-v02.api.letsencrypt.org/directory"


def load_and_validate(
    config_file: str = DEFAULT_CONFIG_FILE,
    rules_dir: str | None = None,
) -> Config:
    """Load the YAML config file, merge the rules folder, validate."""
    import yaml  # only files need PyYAML: parse_config takes a mapping

    try:
        with open(config_file, "rb") as f:
            raw = yaml.safe_load(f) or {}
    except OSError as exc:
        raise ConfigError(f"error reading config file ({config_file}): {exc}")
    except yaml.YAMLError as exc:
        raise ConfigError(f"error parsing config file ({config_file}): {exc}")
    if rules_dir is None:
        rules_dir = os.path.join(os.path.dirname(config_file) or ".", "rules")
    return parse_config(raw, rules_dir=rules_dir)


def parse_config(raw: Mapping[str, Any], rules_dir: str | None = None) -> Config:
    if not isinstance(raw, Mapping):
        raise ConfigError("config root must be a mapping")
    _check_keys(
        raw,
        {"listeners", "services", "rules", "tls", "service_discovery", "lists",
         "child_process"},
        "config",
    )

    services = _parse_services(_want_map(raw, "services"))
    listeners = _parse_listeners(_want_map(raw, "listeners"), services)

    rule_entries = dict(_want_map(raw, "rules", required=False))
    if rules_dir:
        for name, entry in _load_rules_folder(rules_dir).items():
            if name in rule_entries:
                raise ConfigError(f"duplicate rule name: {name}")
            rule_entries[name] = entry
    rules = tuple(_parse_rule(name, entry) for name, entry in rule_entries.items())

    lists = _parse_lists(_want_map(raw, "lists", required=False))
    tls = _parse_tls(raw.get("tls"), listeners)
    discovery = _parse_discovery(raw.get("service_discovery"))
    child = _parse_child_process(raw.get("child_process"))

    return Config(
        listeners=listeners,
        services=tuple(services.values()),
        rules=rules,
        lists=lists,
        tls=tls,
        service_discovery=discovery,
        child_process=child,
    )


def _load_rules_folder(rules_dir: str) -> dict[str, Any]:
    """Load rules from every .yml file in `rules_dir`
    (reference config.rs:378-422; a missing folder is fine)."""
    import yaml

    out: dict[str, Any] = {}
    try:
        entries = sorted(os.listdir(rules_dir))
    except FileNotFoundError:
        return out
    except OSError as exc:
        raise ConfigError(f"error reading rules folder {rules_dir!r}: {exc}")
    for fname in entries:
        if not fname.endswith(".yml"):
            continue
        path = os.path.join(rules_dir, fname)
        try:
            with open(path, "rb") as f:
                rules = yaml.safe_load(f) or {}
        except (OSError, yaml.YAMLError) as exc:
            raise ConfigError(f"error parsing rules file {path!r}: {exc}")
        if not isinstance(rules, Mapping):
            raise ConfigError(f"error parsing rules file {path!r}: not a mapping")
        for name, entry in rules.items():
            if name in out:
                raise ConfigError(f"duplicate rule name: {name}")
            out[name] = entry
    return out


# -- listeners ---------------------------------------------------------------


def parse_listener_address(text: str) -> tuple[str, int, ListenerProtocol]:
    """Parse "proto://ip[:port]" (reference config_file.rs:145-188)."""
    if "://" in text:
        scheme, _, rest = text.partition("://")
    else:
        scheme, rest = "http", text
    protocol = ListenerProtocol.parse(scheme)
    parts = urlsplit(f"//{rest}")
    if parts.path:
        raise ConfigError(f"listener address {text} is not valid: path must be empty")
    if not parts.hostname:
        raise ConfigError(f"listener address {text} is not valid: authority is missing")
    try:
        port = parts.port
    except ValueError:
        raise ConfigError(f"listener address {text} is not valid: bad port")
    if port is None:
        if protocol == ListenerProtocol.HTTP:
            port = 80
        elif protocol == ListenerProtocol.HTTPS:
            port = 443
        else:
            raise ConfigError(f"listener address {text} is not valid: port is missing")
    host = parts.hostname
    try:
        ipaddress.ip_address(host)
    except ValueError:
        raise ConfigError(f"listener address {text} is not valid: host must be an ip")
    return host, port, protocol


def _parse_listeners(
    raw: Mapping[str, Any], services: Mapping[str, ServiceConfig]
) -> tuple[ListenerConfig, ...]:
    if not raw:
        raise ConfigError("config: at least one listener is required")
    http_services = tuple(
        n for n, s in services.items() if s.http_proxy is not None or s.static is not None
    )
    tcp_services = tuple(n for n, s in services.items() if s.tcp_proxy is not None)

    listeners = []
    for name, entry in raw.items():
        if not isinstance(entry, Mapping):
            raise ConfigError(f"config: listeners.{name} must be a mapping")
        _check_keys(entry, {"address", "services"}, f"listeners.{name}")
        address = entry.get("address")
        if not isinstance(address, str):
            raise ConfigError(f"config: listeners.{name}: address is required")
        host, port, protocol = parse_listener_address(address)
        svc = entry.get("services")
        if svc is None:
            svc = list(http_services if protocol.is_http else tcp_services)
        if not isinstance(svc, list) or not all(isinstance(s, str) for s in svc):
            raise ConfigError(f"config: listeners.{name}: services must be a list of names")
        listeners.append(
            ListenerConfig(
                name=name, host=host, port=port, protocol=protocol,
                services=tuple(svc),
            )
        )

    # Validation per reference config.rs:325-376.
    for i, listener in enumerate(listeners):
        for j, other in enumerate(listeners):
            if i != j and listener.port == other.port:
                raise ConfigError(
                    f"config: listeners: {listener.name} and {other.name} "
                    "can't listen on the same port"
                )
        if not listener.services:
            raise ConfigError(
                f"config: listeners: {listener.name}: no service found for this listener"
            )
        if not listener.protocol.is_http and len(listener.services) > 1:
            raise ConfigError(
                f"config: listeners: {listener.name}: TCP listeners can only "
                "have 1 associated service"
            )
        seen: set[str] = set()
        for service_name in listener.services:
            if service_name not in services:
                raise ConfigError(
                    f"config: listeners: {listener.name}: service "
                    f"{service_name} doesn't exist"
                )
            if service_name in seen:
                raise ConfigError(
                    f"config: listeners: {listener.name}: duplicate services "
                    f"are not allowed ({service_name})"
                )
            seen.add(service_name)
    return tuple(listeners)


# -- services ----------------------------------------------------------------


def parse_upstream(text: str) -> Upstream:
    """Parse an upstream URL (reference config_file.rs:280-333)."""
    parts = urlsplit(text)
    scheme = parts.scheme
    # h2 = cleartext HTTP/2 prior knowledge (the reference's hyper
    # client negotiates h1/h2 instead; explicit scheme here).
    if scheme not in ("tcp", "http", "https", "h2"):
        raise ConfigError(f"{text} is not a valid URL: {scheme or '(none)'} is not a valid protocol")
    hostname = parts.hostname or ""
    if not hostname:
        raise ConfigError(f"{text} is not a valid URL: host is missing")
    if not hostname.isascii():
        raise ConfigError(
            f"{text} is not a valid URL: only ascii hostnames are currently supported"
        )
    try:
        port = parts.port
    except ValueError:
        raise ConfigError(f"{text} is not a valid URL: bad port")
    if port is None:
        port = {"http": 80, "https": 443, "h2": 80}.get(scheme)
        if port is None:
            raise ConfigError(f"{text} is not a valid URL: port is missing")
    tls = scheme == "https"
    h2 = scheme == "h2"
    if hostname == "localhost":
        return Upstream(hostname=hostname, port=port, tls=tls,
                        ip="127.0.0.1", h2=h2)
    try:
        ipaddress.ip_address(hostname)
    except ValueError:
        return Upstream(hostname=hostname, port=port, tls=tls, ip=None, h2=h2)
    return Upstream(hostname=hostname, port=port, tls=tls, ip=hostname, h2=h2)


def _parse_services(raw: Mapping[str, Any]) -> dict[str, ServiceConfig]:
    if not raw:
        raise ConfigError("config: at least one service is required")
    services: dict[str, ServiceConfig] = {}
    for name, entry in raw.items():
        if not isinstance(entry, Mapping):
            raise ConfigError(f"config: services.{name} must be a mapping")
        _check_keys(
            entry, {"route", "http_proxy", "tcp_proxy", "static"}, f"services.{name}"
        )
        kinds = [k for k in ("http_proxy", "tcp_proxy", "static") if entry.get(k) is not None]
        if len(kinds) != 1:
            raise ConfigError(
                f"invalid service definition for {name}: services must have "
                "exactly 1 http_proxy, tcp_proxy or static field"
            )
        route_src = entry.get("route")
        route: Program | None = None
        if route_src is not None:
            if entry.get("tcp_proxy") is not None:
                raise ConfigError(
                    f"Invalid service definition for {name}: TCP proxy can't have a route"
                )
            try:
                route = compile_expression(str(route_src))
            except CompileError as exc:
                raise ConfigError(f"error parsing route for service {name}: {exc}")

        http_proxy = tcp_proxy = None
        static = None
        if "http_proxy" in kinds:
            http_proxy = tuple(parse_upstream(str(u)) for u in _want_list(entry, "http_proxy", name))
        elif "tcp_proxy" in kinds:
            tcp_proxy = tuple(parse_upstream(str(u)) for u in _want_list(entry, "tcp_proxy", name))
        else:
            st = entry["static"]
            if not isinstance(st, Mapping):
                raise ConfigError(f"config: services.{name}.static must be a mapping")
            _check_keys(st, {"root", "not_found"}, f"services.{name}.static")
            nf_raw = st.get("not_found") or {}
            if not isinstance(nf_raw, Mapping):
                raise ConfigError(f"config: services.{name}.static.not_found must be a mapping")
            status = nf_raw.get("status", 404)
            if not isinstance(status, int) or not (100 <= status <= 999):
                raise ConfigError(
                    f"services.[{name}].static.not_found.status: Not a valid HTTP status code"
                )
            nf_file = nf_raw.get("file")
            static = StaticSiteConfig(
                root=str(st.get("root", "")),
                not_found=StaticSiteNotFound(
                    file=os.path.join(str(st.get("root", "")), nf_file) if nf_file else None,
                    status=status,
                ),
            )
        services[name] = ServiceConfig(
            name=name, route=route, http_proxy=http_proxy, tcp_proxy=tcp_proxy,
            static=static,
        )
    return services


# -- rules / lists / tls / misc ---------------------------------------------


def _parse_rule(name: str, entry: Any) -> RuleConfig:
    if not isinstance(entry, Mapping):
        raise ConfigError(f"error parsing rules: rule {name} must be a mapping")
    _check_keys(entry, {"expression", "actions"}, f"rules.{name}")
    expression_src = entry.get("expression")
    expression: Program | None = None
    if expression_src is not None:
        try:
            expression = compile_expression(str(expression_src))
        except CompileError as exc:
            raise ConfigError(f"error parsing rules: {name}: {exc}")
    actions_raw = entry.get("actions")
    if not isinstance(actions_raw, list):
        raise ConfigError(f"error parsing rules: {name}: actions must be a list")
    actions = []
    for a in actions_raw:
        if isinstance(a, Mapping) and "action" in a:
            actions.append(Action.parse(str(a["action"])))
        elif isinstance(a, str):
            actions.append(Action.parse(a))
        else:
            raise ConfigError(f"error parsing rules: {name}: invalid action entry {a!r}")
    return RuleConfig(name=name, expression=expression, actions=tuple(actions))


def _parse_lists(raw: Mapping[str, Any]) -> tuple[ListConfig, ...]:
    out = []
    for name, entry in raw.items():
        if not isinstance(entry, Mapping) or "type" not in entry or "file" not in entry:
            raise ConfigError(f"config: lists.{name} must have `type` and `file`")
        out.append(
            ListConfig(name=name, type=ListType.parse(str(entry["type"])), file=str(entry["file"]))
        )
    return tuple(out)


def _parse_tls(raw: Any, listeners: tuple[ListenerConfig, ...]) -> TlsConfig:
    if raw is None:
        return TlsConfig()
    if not isinstance(raw, Mapping):
        raise ConfigError("config: tls must be a mapping")
    _check_keys(raw, {"acme"}, "tls")
    acme_raw = raw.get("acme")
    if acme_raw is None:
        return TlsConfig()
    if not isinstance(acme_raw, Mapping):
        raise ConfigError("config: tls.acme must be a mapping")
    _check_keys(acme_raw, {"directory_url", "domains"}, "tls.acme")
    directory_url = str(
        acme_raw.get("directory_url", LETSENCRYPT_PRODUCTION_URL)
    ).strip().rstrip("/")
    domains_raw = acme_raw.get("domains", [])
    if not isinstance(domains_raw, list):
        raise ConfigError("acme: domains must be a list")
    domains = tuple(str(d) for d in domains_raw)
    seen: set[str] = set()
    for domain in domains:
        if domain in seen:
            raise ConfigError(f"acme: duplicate domain: {domain}")
        seen.add(domain)
        if "*" in domain:
            raise ConfigError(
                "acme: Pingoo currently doesn't support wildcard domains for "
                f"automatic TLS ({domain})"
            )
        if not domain.isascii() or domain.lower() != domain:
            raise ConfigError(f"acme: invalid domain: {domain}")
    return TlsConfig(acme=AcmeConfig(directory_url=directory_url, domains=domains))


def _parse_discovery(raw: Any) -> ServiceDiscoveryConfig:
    if raw is None:
        return ServiceDiscoveryConfig()
    if not isinstance(raw, Mapping):
        raise ConfigError("config: service_discovery must be a mapping")
    docker = raw.get("docker") or {}
    if not isinstance(docker, Mapping):
        raise ConfigError("config: service_discovery.docker must be a mapping")
    return ServiceDiscoveryConfig(
        docker_socket=str(docker.get("socket", "/var/run/docker.sock"))
    )


def _parse_child_process(raw: Any) -> ChildProcess | None:
    if raw is None:
        return None
    if not isinstance(raw, Mapping) or not isinstance(raw.get("command"), list):
        raise ConfigError("config: child_process.command must be a list")
    return ChildProcess(command=tuple(str(c) for c in raw["command"]))


# -- helpers -----------------------------------------------------------------


def _want_map(raw: Mapping[str, Any], key: str, required: bool = True) -> Mapping[str, Any]:
    value = raw.get(key)
    if value is None:
        if required:
            raise ConfigError(f"config: {key} is required")
        return {}
    if not isinstance(value, Mapping):
        raise ConfigError(f"config: {key} must be a mapping")
    return value


def _want_list(entry: Mapping[str, Any], key: str, service: str) -> list:
    value = entry.get(key)
    if not isinstance(value, list) or not value:
        raise ConfigError(f"config: services.{service}.{key} must be a non-empty list")
    return value


def _check_keys(raw: Mapping[str, Any], allowed: set[str], where: str) -> None:
    unknown = set(raw.keys()) - allowed
    if unknown:
        raise ConfigError(f"config: {where}: unknown keys: {sorted(unknown)}")
