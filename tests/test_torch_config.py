"""The port's config loader and list loader (`pingoo_tpu_torch.config`,
`pingoo_tpu_torch.lists`) on every case of test_config.py, and held to
the JAX package's on the same input: the same `Config` (Programs
compared by source), the same ConfigError text, the same lists."""

import dataclasses
import enum
import textwrap
from types import SimpleNamespace

import pytest

import pingoo_tpu.config as ref_config
import pingoo_tpu.lists as ref_lists
from pingoo_tpu_torch import config as port_config
from pingoo_tpu_torch import lists as port_lists
from pingoo_tpu_torch.config import (
    Action,
    ConfigError,
    ListenerProtocol,
    ListType,
    load_and_validate,
    parse_config,
    parse_listener_address,
    parse_upstream,
)
from pingoo_tpu_torch.expr import Ip
from pingoo_tpu_torch.lists import load_lists, parse_list

REF = SimpleNamespace(config=ref_config, lists=ref_lists)
PORT = SimpleNamespace(config=port_config, lists=port_lists)

MINIMAL = {
    "listeners": {"http": {"address": "http://0.0.0.0"}},
    "services": {"site": {"static": {"root": "/var/www"}}},
}


def plain(x):
    """A package-free view of a loaded value: dataclasses and enums by
    class name, Programs by source, Ips by address and network."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if type(x).__name__ == "Program":
        return ("Program", x.source)
    if type(x).__name__ == "Ip":
        return ("Ip", str(x.addr), str(x.net))
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def outcome(call, pkg):
    try:
        return ("ok", plain(call(pkg)))
    except Exception as exc:  # the error's class name and text
        return ("raised", type(exc).__name__, str(exc))


def same(call):
    """`call(pkg)` through the JAX package and the port: equal values, or
    the same exception class and text."""
    want, got = outcome(call, REF), outcome(call, PORT)
    assert got == want
    return got


def test_reference_default_config(tmp_path):
    # The reference's shipped assets/pingoo.yml shape.
    cfg_file = tmp_path / "pingoo.yml"
    cfg_file.write_text(
        textwrap.dedent(
            """
            listeners:
              http:
                address: http://0.0.0.0
            services:
              static_site:
                static:
                  root: /var/wwww
            rules:
              basic_waf:
                expression: http_request.path.starts_with("/.env") || http_request.path.starts_with("/.git")
                actions:
                  - action: block
            """
        )
    )
    config = load_and_validate(str(cfg_file))
    assert len(config.listeners) == 1
    listener = config.listeners[0]
    assert (listener.host, listener.port) == ("0.0.0.0", 80)
    assert listener.protocol == ListenerProtocol.HTTP
    # listener with no explicit services gets all http services (config.rs:236-253)
    assert listener.services == ("static_site",)
    assert config.rules[0].name == "basic_waf"
    assert config.rules[0].actions == (Action.BLOCK,)
    assert config.rules[0].expression is not None
    assert same(lambda p: p.config.load_and_validate(str(cfg_file)))[0] \
        == "ok"


def test_rules_folder_merge_and_duplicates(tmp_path):
    cfg_file = tmp_path / "pingoo.yml"
    cfg_file.write_text(
        "listeners:\n  l: {address: http://0.0.0.0}\n"
        "services:\n  s: {static: {root: /w}}\n"
    )
    rules_dir = tmp_path / "rules"
    rules_dir.mkdir()
    (rules_dir / "extra.yml").write_text(
        'blocked:\n  expression: http_request.path == "/blocked"\n'
        "  actions: [{action: block}]\n"
    )
    (rules_dir / "ignored.yaml").write_text("nope: {actions: []}\n")
    config = load_and_validate(str(cfg_file))
    assert [r.name for r in config.rules] == ["blocked"]
    same(lambda p: p.config.load_and_validate(str(cfg_file)))

    # Duplicate between folder files is an error.
    (rules_dir / "extra2.yml").write_text("blocked:\n  actions: []\n")
    with pytest.raises(ConfigError, match="duplicate rule name"):
        load_and_validate(str(cfg_file))
    same(lambda p: p.config.load_and_validate(str(cfg_file)))


class TestListenerAddress:
    def test_defaults(self):
        assert parse_listener_address("http://0.0.0.0") == (
            "0.0.0.0", 80, ListenerProtocol.HTTP)
        assert parse_listener_address("https://127.0.0.1") == (
            "127.0.0.1", 443, ListenerProtocol.HTTPS)
        assert parse_listener_address("tcp://0.0.0.0:9000") == (
            "0.0.0.0", 9000, ListenerProtocol.TCP)
        assert parse_listener_address("tcp+tls://0.0.0.0:9000")[2] == (
            ListenerProtocol.TCP_AND_TLS)
        for addr in ("http://0.0.0.0", "https://127.0.0.1",
                     "tcp://0.0.0.0:9000", "tcp+tls://0.0.0.0:9000"):
            same(lambda p: p.config.parse_listener_address(addr))

    def test_scheme_defaults_to_http(self):
        assert parse_listener_address("0.0.0.0:8080") == (
            "0.0.0.0", 8080, ListenerProtocol.HTTP)
        same(lambda p: p.config.parse_listener_address("0.0.0.0:8080"))

    def test_errors(self):
        with pytest.raises(ConfigError, match="port is missing"):
            parse_listener_address("tcp://0.0.0.0")
        with pytest.raises(ConfigError, match="not a valid protocol"):
            parse_listener_address("ftp://0.0.0.0:21")
        with pytest.raises(ConfigError, match="host must be an ip"):
            parse_listener_address("http://example.com")
        for addr in ("tcp://0.0.0.0", "ftp://0.0.0.0:21",
                     "http://example.com"):
            assert same(lambda p: p.config.parse_listener_address(addr))[0] \
                == "raised"


class TestUpstream:
    def test_parse(self):
        up = parse_upstream("http://127.0.0.1:3000")
        assert (up.ip, up.port, up.tls) == ("127.0.0.1", 3000, False)
        up = parse_upstream("https://backend.internal")
        assert (up.ip, up.hostname, up.port, up.tls) == (
            None, "backend.internal", 443, True)
        up = parse_upstream("http://localhost:8080")
        assert up.ip == "127.0.0.1"
        up = parse_upstream("tcp://10.0.0.1:5432")
        assert (up.ip, up.port) == ("10.0.0.1", 5432)
        for url in ("http://127.0.0.1:3000", "https://backend.internal",
                    "http://localhost:8080", "tcp://10.0.0.1:5432"):
            same(lambda p: p.config.parse_upstream(url))

    def test_errors(self):
        with pytest.raises(ConfigError, match="not a valid protocol"):
            parse_upstream("ftp://x:21")
        with pytest.raises(ConfigError, match="port is missing"):
            parse_upstream("tcp://10.0.0.1")
        with pytest.raises(ConfigError, match="host is missing"):
            parse_upstream("http://")
        for url in ("ftp://x:21", "tcp://10.0.0.1", "http://"):
            assert same(lambda p: p.config.parse_upstream(url))[0] \
                == "raised"


def parses_alike(raw):
    """The port's and the JAX package's parse_config agree on `raw`."""
    return same(lambda p: p.config.parse_config(raw))


class TestValidation:
    def test_service_exactly_one_kind(self):
        raw = dict(MINIMAL, services={"bad": {"static": {"root": "/w"},
                                              "http_proxy": ["http://1.2.3.4"]}})
        with pytest.raises(ConfigError, match="exactly 1"):
            parse_config(raw)
        parses_alike(raw)
        raw = dict(MINIMAL, services={"bad": {"route": "true"}})
        with pytest.raises(ConfigError, match="exactly 1"):
            parse_config(raw)
        parses_alike(raw)

    def test_tcp_proxy_no_route(self):
        raw = {
            "listeners": {"t": {"address": "tcp://0.0.0.0:9000"}},
            "services": {"db": {"tcp_proxy": ["tcp://10.0.0.1:5432"],
                                 "route": "true"}},
        }
        with pytest.raises(ConfigError, match="TCP proxy can't have a route"):
            parse_config(raw)
        parses_alike(raw)

    def test_duplicate_ports(self):
        raw = dict(
            MINIMAL,
            listeners={
                "a": {"address": "http://0.0.0.0:8080"},
                "b": {"address": "http://127.0.0.1:8080"},
            },
        )
        with pytest.raises(ConfigError, match="same port"):
            parse_config(raw)
        parses_alike(raw)

    def test_unknown_service(self):
        raw = dict(
            MINIMAL,
            listeners={"a": {"address": "http://0.0.0.0", "services": ["nope"]}},
        )
        with pytest.raises(ConfigError, match="doesn't exist"):
            parse_config(raw)
        parses_alike(raw)

    def test_tcp_listener_single_service(self):
        raw = {
            "listeners": {"t": {"address": "tcp://0.0.0.0:9000",
                                 "services": ["a", "b"]}},
            "services": {
                "a": {"tcp_proxy": ["tcp://10.0.0.1:1"]},
                "b": {"tcp_proxy": ["tcp://10.0.0.2:2"]},
            },
        }
        with pytest.raises(ConfigError, match="only have 1"):
            parse_config(raw)
        parses_alike(raw)

    def test_bad_rule_expression_fails_at_load(self):
        raw = dict(MINIMAL, rules={"r": {"expression": "a ==", "actions": []}})
        with pytest.raises(ConfigError, match="error parsing rules"):
            parse_config(raw)
        parses_alike(raw)

    def test_route_compiled_at_load(self):
        raw = dict(
            MINIMAL,
            services={
                "site": {
                    "static": {"root": "/w"},
                    "route": 'http_request.host == "example.com"',
                }
            },
        )
        config = parse_config(raw)
        assert config.services[0].route is not None
        assert parses_alike(raw)[0] == "ok"

    def test_acme_validation(self):
        base = dict(MINIMAL)
        base["tls"] = {"acme": {"domains": ["example.com", "example.com"]}}
        with pytest.raises(ConfigError, match="duplicate domain"):
            parse_config(base)
        parses_alike(base)
        base["tls"] = {"acme": {"domains": ["*.example.com"]}}
        with pytest.raises(ConfigError, match="wildcard"):
            parse_config(base)
        parses_alike(base)
        base["tls"] = {"acme": {"domains": ["EXAMPLE.com"]}}
        with pytest.raises(ConfigError, match="invalid domain"):
            parse_config(base)
        parses_alike(base)
        base["tls"] = {"acme": {"domains": ["example.com"],
                                  "directory_url": "https://acme.example/dir/ "}}
        config = parse_config(base)
        assert config.tls.acme.directory_url == "https://acme.example/dir"
        parses_alike(base)

    def test_unknown_keys_rejected(self):
        raw = dict(MINIMAL)
        raw["nope"] = {}
        with pytest.raises(ConfigError, match="unknown keys"):
            parse_config(raw)
        parses_alike(raw)


class TestLists:
    def test_parse_typed_lists(self):
        ips = parse_list('127.0.0.1,"really bad person"\n10.0.0.0/8,"corp"\n',
                         ListType.IP)
        assert ips[0] == Ip("127.0.0.1")
        assert ips[1].is_network
        ints = parse_list("64500\n64501,desc\n", ListType.INT)
        assert ints == [64500, 64501]
        strings = parse_list("/admin\n/.env, secret scan \n", ListType.STRING)
        assert strings == ["/admin", "/.env"]
        for text, kind in (
                ('127.0.0.1,"really bad person"\n10.0.0.0/8,"corp"\n', "IP"),
                ("64500\n64501,desc\n", "INT"),
                ("/admin\n/.env, secret scan \n", "STRING")):
            same(lambda p: p.lists.parse_list(
                text, getattr(p.config.ListType, kind)))

    def test_values_trimmed(self):
        assert parse_list(" 42 ,x\n", ListType.INT) == [42]
        same(lambda p: p.lists.parse_list(" 42 ,x\n", p.config.ListType.INT))

    def test_errors(self):
        with pytest.raises(ConfigError, match="number of columns"):
            parse_list("a,b,c\n", ListType.STRING)
        with pytest.raises(ConfigError, match="parsing int"):
            parse_list("abc\n", ListType.INT)
        with pytest.raises(ConfigError, match="IP network"):
            parse_list("999.1.1.1\n", ListType.IP)
        for text, kind in (("a,b,c\n", "STRING"), ("abc\n", "INT"),
                           ("999.1.1.1\n", "IP")):
            assert same(lambda p: p.lists.parse_list(
                text, getattr(p.config.ListType, kind)))[0] == "raised"

    def test_load_lists_end_to_end(self, tmp_path):
        f = tmp_path / "blocked.csv"
        f.write_text('127.0.0.1,"bad"\n192.0.2.0/24\n')
        from pingoo_tpu_torch.config.schema import ListConfig

        lists = load_lists([ListConfig(name="blocked_ips", type=ListType.IP,
                                        file=str(f))])
        assert "blocked_ips" in lists and len(lists["blocked_ips"]) == 2
        same(lambda p: p.lists.load_lists([p.config.ListConfig(
            name="blocked_ips", type=p.config.ListType.IP, file=str(f))]))
