"""Validated configuration model.

Mirrors the reference's two-stage config pipeline (pingoo/config/
config_file.rs -> config.rs): raw YAML is parsed into a file-shaped dict,
then converted into these validated dataclasses. Expressions (rules and
service routes) are compiled at load time so config errors fail fast at
boot (reference config.rs:255-269, config_file.rs:257-265).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from ..expr import Program


class ListenerProtocol(enum.Enum):
    TCP = "tcp"
    TCP_AND_TLS = "tcp+tls"
    HTTP = "http"
    HTTPS = "https"

    @staticmethod
    def parse(text: str) -> "ListenerProtocol":
        for proto in ListenerProtocol:
            if proto.value == text:
                return proto
        raise ConfigError(f"{text} is not a valid protocol")

    @property
    def is_tls(self) -> bool:
        return self in (ListenerProtocol.HTTPS, ListenerProtocol.TCP_AND_TLS)

    @property
    def is_http(self) -> bool:
        return self in (ListenerProtocol.HTTP, ListenerProtocol.HTTPS)


class ConfigError(Exception):
    """Invalid configuration (reference error.rs Error::Config)."""


class Action(enum.Enum):
    """Rule actions (reference rules/rules.rs:30-35)."""

    BLOCK = "block"
    CAPTCHA = "captcha"

    @staticmethod
    def parse(text: str) -> "Action":
        for action in Action:
            if action.value == text:
                return action
        raise ConfigError(f"unknown action: {text}")


class ListType(enum.Enum):
    """List item types (reference pingoo/lists.rs ListType)."""

    STRING = "String"
    INT = "Int"
    IP = "Ip"

    @staticmethod
    def parse(text: str) -> "ListType":
        for lt in ListType:
            if lt.value == text:
                return lt
        raise ConfigError(f"{text} is not a valid ListType")


@dataclass(frozen=True)
class ListenerConfig:
    name: str
    host: str  # ip address text
    port: int
    protocol: ListenerProtocol
    services: tuple[str, ...]


@dataclass(frozen=True)
class Upstream:
    """A resolved upstream address (reference service_registry.rs Upstream
    / config_file.rs parse_upstream)."""

    hostname: str
    port: int
    tls: bool
    ip: Optional[str] = None  # None -> hostname needs DNS discovery
    # h2:// scheme — proxy upstream over HTTP/2 prior knowledge (the
    # reference's hyper client speaks h1/h2, http_proxy_service.rs:54-71).
    h2: bool = False


@dataclass(frozen=True)
class StaticSiteNotFound:
    file: Optional[str] = None
    status: int = 404


@dataclass(frozen=True)
class StaticSiteConfig:
    root: str
    not_found: StaticSiteNotFound = field(default_factory=StaticSiteNotFound)


@dataclass(frozen=True)
class ServiceConfig:
    """Exactly one of http_proxy / tcp_proxy / static is set
    (reference config_file.rs parse_service)."""

    name: str
    route: Optional[Program] = None
    http_proxy: Optional[tuple[Upstream, ...]] = None
    tcp_proxy: Optional[tuple[Upstream, ...]] = None
    static: Optional[StaticSiteConfig] = None


@dataclass(frozen=True)
class RuleConfig:
    """A compiled rule (reference pingoo/rules.rs Rule). A rule without an
    expression always matches (pingoo/rules.rs:48-50)."""

    name: str
    expression: Optional[Program]
    actions: tuple[Action, ...]


@dataclass(frozen=True)
class ListConfig:
    name: str
    type: ListType
    file: str


@dataclass(frozen=True)
class AcmeConfig:
    directory_url: str
    domains: tuple[str, ...]


@dataclass(frozen=True)
class TlsConfig:
    acme: Optional[AcmeConfig] = None


@dataclass(frozen=True)
class ServiceDiscoveryConfig:
    docker_socket: str = "/var/run/docker.sock"


@dataclass(frozen=True)
class ChildProcess:
    command: tuple[str, ...]


@dataclass(frozen=True)
class Config:
    listeners: tuple[ListenerConfig, ...]
    services: tuple[ServiceConfig, ...]
    rules: tuple[RuleConfig, ...]
    lists: tuple[ListConfig, ...]
    tls: TlsConfig = field(default_factory=TlsConfig)
    service_discovery: ServiceDiscoveryConfig = field(
        default_factory=ServiceDiscoveryConfig
    )
    child_process: Optional[ChildProcess] = None
