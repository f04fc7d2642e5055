"""The port's host units on every case of test_host_units.py: JWT/JOSE,
TLS manager, captcha manager, discovery, and the port's VerdictService
where the JAX package's cases test its engine. Where an output is
deterministic it is held to the JAX package's: tokens each package
signs verify in the other, a captcha key one persists the other loads,
and captcha client ids are equal.

Cases whose JAX-package subject the port replaces by a decision of its
own test that decision on the same inputs:
  * the host parsing of the listener (`get_host`, host/httpd.py, port
    queue item 1b-ii): the hosts it derives reach the rules unchanged,
    up to the device's 256-byte host field and past it;
  * the JAX backend probe: the port has none, `resolve_device` answers
    at once, and raises without a card rather than degrading;
  * the host fallback: a kernel that fails to build or launch reaches
    every waiting caller, none hangs, and the collector serves the next
    batch; any other device error demotes the ladder's device rung and
    the interpreter serves (engine/ladder.py).
"""

import asyncio
import json
import ssl
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pingoo_tpu.host import captcha as ref_captcha
from pingoo_tpu.host import jwt as ref_jose
from pingoo_tpu_torch.host import jwt as jose
from pingoo_tpu_torch.host.captcha import (CaptchaManager,
                                           generate_captcha_client_id)
from pingoo_tpu_torch.host.tlsmgr import (TlsManager, cert_sans,
                                          generate_self_signed)

import test_host_units as ref_units
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def other_package(key, package):
    """The same key as `package`'s jwt.Key, through its JWK."""
    return package.Jwks.from_json(json.dumps(
        {"keys": [key.to_jwk(include_private=True)]})).keys[0]


class TestJose:
    @pytest.mark.parametrize("alg", [jose.ALG_HS512, jose.ALG_EDDSA,
                                     jose.ALG_ES256, jose.ALG_ES512])
    def test_sign_verify_roundtrip(self, alg):
        key = jose.Key.generate(alg, kid="k1")
        now = int(time.time())
        token = jose.sign(key, {"sub": "x", "exp": now + 60, "iss": "pingoo"})
        claims = jose.parse_and_verify(token, key, issuer="pingoo")
        assert claims["sub"] == "x"
        # Each package verifies what the other signs with the same key.
        ref_key = other_package(key, ref_jose)
        assert ref_jose.parse_and_verify(token, ref_key,
                                         issuer="pingoo") == claims
        ref_token = ref_jose.sign(ref_key, {"sub": "y", "iss": "pingoo"})
        assert jose.parse_and_verify(ref_token, key,
                                     issuer="pingoo")["sub"] == "y"

    def test_tampered_signature_rejected(self):
        key = jose.Key.generate(jose.ALG_EDDSA)
        token = jose.sign(key, {"sub": "x"})
        head, payload, sig = token.split(".")
        bad = head + "." + payload + "." + sig[:-4] + "AAAA"
        with pytest.raises(jose.JwtError, match="signature"):
            jose.parse_and_verify(bad, key)

    def test_tampered_claims_rejected(self):
        key = jose.Key.generate(jose.ALG_EDDSA)
        token = jose.sign(key, {"admin": False})
        head, _, sig = token.split(".")
        forged_claims = jose.b64url_encode(json.dumps({"admin": True}).encode())
        with pytest.raises(jose.JwtError):
            jose.parse_and_verify(head + "." + forged_claims + "." + sig, key)

    def test_expiry_and_nbf(self):
        key = jose.Key.generate(jose.ALG_HS512)
        now = time.time()
        token = jose.sign(key, {"exp": int(now - 3600)})
        with pytest.raises(jose.JwtError, match="expired"):
            jose.parse_and_verify(token, key)
        # within drift tolerance -> accepted (jwt.rs drift checks)
        token = jose.sign(key, {"exp": int(now - 10)})
        jose.parse_and_verify(token, key, drift_tolerance_s=60)
        token = jose.sign(key, {"nbf": int(now + 3600)})
        with pytest.raises(jose.JwtError, match="not yet valid"):
            jose.parse_and_verify(token, key)

    def test_audience_issuer(self):
        key = jose.Key.generate(jose.ALG_HS512)
        token = jose.sign(key, {"aud": ["a", "b"], "iss": "me"})
        jose.parse_and_verify(token, key, audience="a", issuer="me")
        with pytest.raises(jose.JwtError, match="audience"):
            jose.parse_and_verify(token, key, audience="c")
        with pytest.raises(jose.JwtError, match="issuer"):
            jose.parse_and_verify(token, key, issuer="you")

    def test_alg_confusion_rejected(self):
        """Token signed HS512 must not verify against an Ed25519 key."""
        hs = jose.Key.generate(jose.ALG_HS512)
        ed = jose.Key.generate(jose.ALG_EDDSA)
        token = jose.sign(hs, {"sub": "x"})
        with pytest.raises(jose.JwtError, match="algorithm mismatch"):
            jose.parse_and_verify(token, ed)

    @pytest.mark.parametrize("alg", [jose.ALG_EDDSA, jose.ALG_ES256,
                                     jose.ALG_ES512, jose.ALG_HS512])
    def test_jwk_roundtrip(self, alg):
        key = jose.Key.generate(alg, kid="kid9")
        jwks_json = jose.Jwks(keys=[key]).to_json(include_private=True)
        restored = jose.Jwks.from_json(jwks_json).find("kid9")
        token = jose.sign(key, {"sub": "x"})
        assert jose.parse_and_verify(token, restored)["sub"] == "x"
        # public-only JWKS still verifies (asymmetric algs)
        if alg != jose.ALG_HS512:
            pub = jose.Jwks.from_json(
                jose.Jwks(keys=[key]).to_json()).find("kid9")
            assert jose.parse_and_verify(token, pub)["sub"] == "x"
        # The JAX package reads the port's JWKS to the same JWK.
        ref = ref_jose.Jwks.from_json(jwks_json).find("kid9")
        assert ref.to_jwk(include_private=True) \
            == key.to_jwk(include_private=True)


class TestTlsManager:
    def test_self_signed_and_sni(self, tmp_path):
        mgr = TlsManager(str(tmp_path / "tls"))
        # Default '*' cert generated on first boot (tls_manager.rs:193-231).
        assert (tmp_path / "tls" / "default.pingoo.pem").exists()
        assert mgr.resolve("anything.example") is not None

        cert, key = generate_self_signed(["example.com", "*.api.example.com"])
        (tmp_path / "tls" / "example.pem").write_bytes(cert)
        (tmp_path / "tls" / "example.key").write_bytes(key)
        mgr2 = TlsManager(str(tmp_path / "tls"))
        exact = mgr2.resolve("example.com")
        wild = mgr2.resolve("v1.api.example.com")
        default = mgr2.resolve("other.test")
        assert exact is not None and wild is not None and default is not None
        assert exact is not default and wild is not default

    def test_cert_sans(self):
        cert, _ = generate_self_signed(["a.test", "*.b.test"])
        assert set(cert_sans(cert)) == {"a.test", "*.b.test"}

    def test_tls13_only(self, tmp_path):
        mgr = TlsManager(str(tmp_path / "tls"))
        ctx = mgr.server_context()
        assert ctx.minimum_version == ssl.TLSVersion.TLSv1_3


class TestCaptchaManager:
    def test_pow_flow(self, tmp_path):
        mgr = CaptchaManager(str(tmp_path / "jwks.json"))
        client_id = generate_captcha_client_id("1.2.3.4", "UA", "host")
        assert client_id == ref_captcha.generate_captcha_client_id(
            "1.2.3.4", "UA", "host")
        body, cookie = mgr.init_challenge(client_id)
        token = cookie.split("=", 1)[1].split(";")[0]
        import hashlib

        nonce = 0
        while True:
            digest = hashlib.sha256(
                (body["challenge"] + str(nonce)).encode()).hexdigest()
            if digest.startswith("0" * body["difficulty"]):
                break
            nonce += 1
        ok, verified_cookie = mgr.verify_challenge(
            {"nonce": str(nonce), "hash": digest}, token, client_id)
        assert ok and verified_cookie
        verified_token = verified_cookie.split("=", 1)[1].split(";")[0]
        assert mgr.is_verified(verified_token, client_id)
        # A different client id must not validate (constant-time compare).
        other = generate_captcha_client_id("5.6.7.8", "UA", "host")
        assert not mgr.is_verified(verified_token, other)
        # The JAX package, on the same key file, accepts the port's cookie.
        ref = ref_captcha.CaptchaManager(str(tmp_path / "jwks.json"))
        assert ref.is_verified(verified_token, client_id)
        assert not ref.is_verified(verified_token, other)

    def test_wrong_pow_rejected(self, tmp_path):
        mgr = CaptchaManager(str(tmp_path / "jwks.json"))
        client_id = generate_captcha_client_id("1.2.3.4", "UA", "host")
        _, cookie = mgr.init_challenge(client_id)
        token = cookie.split("=", 1)[1].split(";")[0]
        ok, _ = mgr.verify_challenge(
            {"nonce": "1", "hash": "f" * 64}, token, client_id)
        assert not ok

    def test_key_persistence(self, tmp_path):
        path = str(tmp_path / "jwks.json")
        mgr1 = CaptchaManager(path)
        client_id = generate_captcha_client_id("1.2.3.4", "UA", "host")
        _, cookie = mgr1.init_challenge(client_id)
        # A new manager instance reuses the persisted key (captcha.rs:78-123).
        mgr2 = CaptchaManager(path)
        token = cookie.split("=", 1)[1].split(";")[0]
        from pingoo_tpu_torch.host import jwt as j

        claims = j.parse_and_verify(token, mgr2.key, issuer="pingoo",
                                    drift_tolerance_s=5)
        assert claims["client_id"] == client_id
        ref = ref_captcha.CaptchaManager(path)
        assert ref_jose.parse_and_verify(token, ref.key, issuer="pingoo",
                                         drift_tolerance_s=5) == claims


class TestDiscovery:
    def test_static_and_dns(self, loop_runner):
        from pingoo_tpu_torch.config import parse_config
        from pingoo_tpu_torch.host.discovery import ServiceRegistry

        config = parse_config({
            "listeners": {"l": {"address": "http://0.0.0.0:8080"}},
            "services": {
                "s": {"http_proxy": ["http://127.0.0.1:9000",
                                      "http://localhost:9001"]},
            },
        })
        registry = ServiceRegistry(config.services, enable_docker=False,
                                   enable_dns=True)
        loop_runner.run(registry.discover())
        ups = registry.get_upstreams("s")
        assert {(u.ip, u.port) for u in ups} >= {("127.0.0.1", 9000),
                                                ("127.0.0.1", 9001)}
        assert registry.get_upstreams("unknown") == []


def listener_hosts(raw):
    """The hosts the port's listener derives (`get_host`) from raw
    (target, headers) pairs; the JAX package's `get_host` must derive
    the same ones."""
    from pingoo_tpu.host import httpd as ref_httpd
    from pingoo_tpu_torch.host.httpd import Request, get_host

    hosts = [get_host(Request(method="GET", target=target, path="/",
                              headers=hdrs))
             for target, hdrs in raw]
    assert hosts == [ref_httpd.get_host(ref_httpd.Request(
        method="GET", target=target, path="/", headers=hdrs))
        for target, hdrs in raw]
    return hosts


def host_rows(hosts, rule_hosts):
    """Each host through the port's batched path (CPU) and through the
    interpreter, against one `http_request.host == <h>` rule per
    `rule_hosts` entry; returns (matched, oracle, overflow)."""
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config.schema import Action, RuleConfig
    from pingoo_tpu_torch.engine.batch import (RequestTuple, encode_requests,
                                               tuple_to_context)
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.engine.verdict import interpret_rules_row
    from pingoo_tpu_torch.expr import compile_expression

    rules = [RuleConfig(name=f"h{i}", actions=(Action.BLOCK,),
                        expression=compile_expression(
                            f'http_request.host == "{h}"'))
             for i, h in enumerate(rule_hosts)]
    plan = compile_ruleset(rules, {}, device="cpu")
    svc = VerdictService(plan, {}, device="cpu")
    reqs = [RequestTuple(host=h, path="/") for h in hosts]
    matched = np.stack([v.matched for v in svc.evaluate_batch(reqs)])
    oracle = np.stack([interpret_rules_row(plan, tuple_to_context(r, {}))
                       for r in reqs])
    overflow = encode_requests(reqs, plan.field_specs).overflow
    return matched, oracle, overflow


class TestHostParsing:
    """The hosts come from the port's `get_host` on the reference cases'
    raw headers, equal to the JAX package's; each goes through the
    port's engine to the rule that names it."""

    def test_ipv6_host_header(self):
        hosts = listener_hosts([
            ("/", [("host", "[::1]:8080")]),
            ("/", [("host", "example.com:443")]),
            ("http://[2001:db8::1]:80/x", []),
        ])
        assert hosts == ["[::1]", "example.com", "[2001:db8::1]"]
        matched, oracle, overflow = host_rows(hosts, hosts)
        assert (matched == oracle).all()
        assert (matched == np.eye(3, dtype=bool)).all()
        assert not overflow.any()

    def test_overlong_host_becomes_empty(self):
        """An over-long host header reaches the rules as the empty host,
        not as its text; one of exactly 256 bytes reaches them whole."""
        long_host = "a" * 300 + ".example.com"
        ok = "b" * 256
        hosts = listener_hosts([("/", [("host", long_host)]),
                                 ("/", [("host", ok)])])
        assert hosts == ["", ok]
        matched, oracle, overflow = host_rows(hosts, ["", ok, long_host])
        assert (matched == oracle).all()
        assert matched.tolist() == [[True, False, False],
                                    [False, True, False]]
        assert not overflow.any()


class TestRingCapacityValidation:
    def test_non_pow2_rejected(self, tmp_path):
        from pingoo_tpu_torch import native_ring

        native_ring.build_ring_lib()
        with pytest.raises(ValueError, match="power of two"):
            native_ring.Ring(str(tmp_path / "r"), capacity=1000, create=True)


PROBE = (
    "import sys, time\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "t0 = time.monotonic()\n"
    "import torch\n"
    "from pingoo_tpu_torch.device import resolve_device\n"
    "try:\n"
    "    resolve_device(None)\n"
    "    raise SystemExit('resolve_device(None) ran without a card')\n"
    "except RuntimeError as exc:\n"
    "    assert \"device='cpu'\" in str(exc), exc\n"
    "try:\n"
    "    resolve_device('nonexistent_accel')\n"
    "    raise SystemExit('a bogus device was accepted')\n"
    "except (RuntimeError, ValueError):\n"
    "    pass\n"
    "dev = resolve_device('cpu')\n"
    "assert int(torch.arange(4, device=dev).sum()) == 6\n"
    "print('RESOLVED', dev, round(time.monotonic() - t0, 3))\n"
)


class TestBackendProbe:
    """The JAX package probes its accelerator in a subprocess under a
    deadline and degrades to the CPU. The port probes nothing and does
    not degrade: without a card `resolve_device(None)` raises at once, a
    bogus device is refused, and only an explicit device="cpu" runs on
    the CPU."""

    def test_without_a_card_only_an_explicit_cpu_resolves(self):
        import os

        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run([sys.executable, "-c", PROBE, str(REPO)],
                              timeout=120, capture_output=True, text=True,
                              env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "RESOLVED cpu" in proc.stdout


def one_rule_service(expr, **kw):
    from pingoo_tpu_torch.compiler.plan import compile_ruleset
    from pingoo_tpu_torch.config.schema import Action, RuleConfig
    from pingoo_tpu_torch.engine.service import VerdictService
    from pingoo_tpu_torch.expr import compile_expression

    rules = [RuleConfig(name="r", actions=(Action.BLOCK,),
                        expression=compile_expression(expr))]
    plan = compile_ruleset(rules, {}, device="cpu")
    return plan, VerdictService(plan, {}, device="cpu", **kw)


class TestProfilerHook:
    def test_profile_dir_captures_trace(self, loop_runner, tmp_path,
                                        monkeypatch):
        """PINGOO_PROFILE_DIR wraps the serving window, start() to stop(),
        in a torch.profiler trace written into the directory."""
        from pingoo_tpu_torch.engine.batch import RequestTuple

        monkeypatch.setenv("PINGOO_PROFILE_DIR", str(tmp_path))
        _, svc = one_rule_service('http_request.path == "/x"',
                                  max_wait_us=100)

        async def flow():
            await svc.start()
            try:
                return await svc.evaluate(RequestTuple(path="/x"))
            finally:
                await svc.stop()

        v = loop_runner.run(flow())
        assert v.block
        produced = [p for p in tmp_path.rglob("*.trace.json")]
        assert len(produced) == 1, list(tmp_path.rglob("*"))
        events = json.loads(produced[0].read_text())["traceEvents"]
        assert events


class TestVerdictServiceFallback:
    def test_device_error_reaches_the_caller_without_host_fallback(
            self, loop_runner):
        """A kernel that fails to build or launch reaches the caller, with
        no host fallback; any other device error demotes the ladder's
        device rung and the host interpreter serves, as in the JAX
        package, until a probe after the backoff finds the path working."""
        from pingoo_tpu_torch.engine.batch import RequestTuple
        from pingoo_tpu_torch.ops._build import KernelBuildError

        _, svc = one_rule_service('http_request.path == "/x"',
                                  max_wait_us=100)
        verdict_fn = svc._verdict_fn
        clock = [0.0]
        svc.ladder._clock = lambda: clock[0]

        def broken(*args):
            raise KernelBuildError("nvcc exited 2")

        def dead(*args):
            raise RuntimeError("device lost")

        async def flow():
            await svc.start()
            try:
                svc._verdict_fn = broken
                with pytest.raises(KernelBuildError, match="nvcc"):
                    await asyncio.wait_for(
                        svc.evaluate(RequestTuple(path="/x")), timeout=5)
                svc._verdict_fn = dead  # simulate a dead device path
                v0 = await asyncio.wait_for(
                    svc.evaluate(RequestTuple(path="/x")), timeout=5)
                demoted = svc.ladder.demoted()
                svc._verdict_fn = verdict_fn
                clock[0] += 1.0  # the backoff is over: the next batch probes
                v1 = await svc.evaluate(RequestTuple(path="/x"))
                v2 = await svc.evaluate(RequestTuple(path="/y"))
                return v0, demoted, v1, v2
            finally:
                await svc.stop()

        v0, demoted, v1, v2 = loop_runner.run(flow())
        assert v0.block and v1.block and not v2.block
        assert demoted == ["device"] and svc.ladder.demoted() == []
        snap = svc.stats.snapshot()
        assert snap["device_errors"] == 1
        assert snap["host_fallback_batches"] == 1
        assert snap["ladder"]["device"]["errors"] == 1
        assert snap["ladder"]["device"]["demotions"] == 1
        assert snap["batches"] == 3 and snap["requests"] == 3

    def test_collector_survives_total_failure(self, loop_runner):
        """Even if every batch explodes, requests must resolve (with the
        error) instead of hanging forever."""
        from pingoo_tpu_torch.engine.batch import RequestTuple

        _, svc = one_rule_service("true", max_wait_us=100)
        svc.evaluate_batch = lambda reqs, t_launch=None: (
            _ for _ in ()).throw(RuntimeError("boom"))

        async def flow():
            await svc.start()
            try:
                out = []
                for path in ("/x", "/y"):
                    try:
                        await asyncio.wait_for(
                            svc.evaluate(RequestTuple(path=path)), timeout=5)
                        out.append("served")
                    except RuntimeError as exc:
                        out.append(str(exc))
                return out, svc._task.done()
            finally:
                await svc.stop()

        out, collector_done = loop_runner.run(flow())
        assert out == ["boom", "boom"]  # resolved, not hung
        assert not collector_done


class TestOverflowRouting:
    """Fields past device capacity -> host interpreter over the FULL
    strings (reference matches full path/url; padding must not bypass),
    through one batch (`evaluate_batch`) or the collector (`evaluate`)."""

    @staticmethod
    def matched(svc, reqs, through, loop_runner):
        if through == "batch":
            return np.stack([v.matched for v in svc.evaluate_batch(reqs)])

        async def flow():
            await svc.start()
            try:
                return await asyncio.gather(*map(svc.evaluate, reqs))
            finally:
                await svc.stop()

        return np.stack([v.matched for v in loop_runner.run(flow())])

    @pytest.mark.parametrize("through", ["batch", "collector"])
    def test_padded_url_cannot_bypass_contains(self, through, loop_runner):
        from pingoo_tpu_torch.engine.batch import RequestTuple

        plan, svc = one_rule_service(
            'http_request.url.contains("attackmarker")', max_wait_us=100)
        cap = plan.field_specs["url"]
        long_url = "/" + "A" * (cap + 100) + "attackmarker"
        matched = self.matched(svc, [
            RequestTuple(url=long_url, path="/x"),
            RequestTuple(url="/clean", path="/x"),
            RequestTuple(url="/attackmarker", path="/x"),
        ], through, loop_runner)
        assert matched[0, 0], "marker past device cap must still match"
        assert not matched[1, 0]
        assert matched[2, 0]

    def test_overflow_length_uses_full_string(self):
        from pingoo_tpu_torch.engine.batch import RequestTuple

        plan, svc = one_rule_service("length(http_request.path) > 3000")
        cap = plan.field_specs["path"]
        matched = np.stack([v.matched for v in svc.evaluate_batch([
            RequestTuple(path="/" + "p" * 3200),
            RequestTuple(path="/" + "p" * (cap - 10)),
        ])])
        assert matched[0, 0]
        assert not matched[1, 0]

    def test_encode_marks_overflow_rows(self):
        from pingoo_tpu_torch.engine.batch import RequestTuple, encode_requests

        batch = encode_requests([
            RequestTuple(url="/" + "x" * 5000),
            RequestTuple(url="/short"),
        ])
        assert batch.overflow.tolist() == [True, False]
        assert "overflow" not in batch.arrays  # never rides the tensors


class TestDiscoveryTtlAndWarnOnce:
    def _registry_with_dns_target(self):
        from pingoo_tpu_torch.config.schema import ServiceConfig, Upstream
        from pingoo_tpu_torch.host.discovery import ServiceRegistry

        svc = ServiceConfig(
            name="s", route=None,
            http_proxy=(Upstream(hostname="backend.test", port=9000,
                                 tls=False, ip=None),))
        return ServiceRegistry([svc], enable_docker=False, enable_dns=True)

    def test_dns_positive_min_ttl_suppresses_reresolve(self, loop_runner):
        """dns.rs positive_min_ttl=60s equivalent: a fresh answer is not
        re-resolved on every 2s tick."""
        reg = self._registry_with_dns_target()
        calls = {"n": 0}

        async def stub(hostname, port):
            calls["n"] += 1
            return [(2, 1, 6, "", ("10.0.0.5", port))]

        reg._getaddrinfo = stub
        for _ in range(5):
            loop_runner.run(reg.discover())
        assert calls["n"] == 1  # floor: one resolution within the window
        assert [u.ip for u in reg.get_upstreams("s")] == ["10.0.0.5"]

    def test_dns_failure_serves_last_known_within_negative_ttl(
            self, loop_runner):
        reg = self._registry_with_dns_target()
        state = {"fail": False}

        async def stub(hostname, port):
            if state["fail"]:
                raise OSError("resolver down")
            return [(2, 1, 6, "", ("10.0.0.7", port))]

        reg._getaddrinfo = stub
        loop_runner.run(reg.discover())
        # Age the cache past the positive floor, then fail the resolver.
        key = ("backend.test", 9000)
        ups, ts = reg._dns_cache[key]
        reg._dns_cache[key] = (ups, ts - 120)
        state["fail"] = True
        loop_runner.run(reg.discover())
        assert [u.ip for u in reg.get_upstreams("s")] == ["10.0.0.7"]
        # Past the negative cap the stale answer drops.
        reg._dns_cache[key] = (ups, ts - 4000)
        loop_runner.run(reg.discover())
        assert reg.get_upstreams("s") == []

    def test_docker_problem_container_warned_once(self, caplog):
        import logging

        from pingoo_tpu_torch.host.discovery import ServiceRegistry

        reg = ServiceRegistry([], enable_docker=True, enable_dns=False)
        with caplog.at_level(logging.WARNING):
            for _ in range(3):
                reg._warn_container("abc123def456", "no usable port")
        warnings = [r for r in caplog.records
                    if "abc123def456"[:12] in r.getMessage()]
        assert len(warnings) == 1  # once per idle window, not per tick


class TestDockerDiscoveryEndToEnd:
    """Docker discovery against test_host_units.py's mock daemon on a
    real unix socket: labeled containers become upstreams; chunked
    transfer-encoding is de-framed; hot-swap applies on the next tick."""

    def test_labeled_containers_become_upstreams(self, tmp_path,
                                                 loop_runner):
        from pingoo_tpu_torch.config.schema import ServiceConfig
        from pingoo_tpu_torch.host.discovery import ServiceRegistry

        containers = [
            {   # labeled with explicit port
                "Id": "aaa111",
                "Labels": {"pingoo.service": "api", "pingoo.port": "8080"},
                "NetworkSettings": {"Networks": {
                    "bridge": {"IPAddress": "172.17.0.2"}}},
            },
            {   # single private port: inferred
                "Id": "bbb222",
                "Labels": {"pingoo.service": "api"},
                "Ports": [{"PrivatePort": 9000}],
                "NetworkSettings": {"Networks": {
                    "bridge": {"IPAddress": "172.17.0.3"}}},
            },
            {   # unlabeled: ignored
                "Id": "ccc333",
                "Labels": {},
                "NetworkSettings": {"Networks": {
                    "bridge": {"IPAddress": "172.17.0.4"}}},
            },
        ]
        path, srv, state = ref_units.TestDockerDiscoveryEndToEnd._mock_daemon(
            None, tmp_path, json.dumps(containers))
        try:
            svc = ServiceConfig(name="api", http_proxy=())
            reg = ServiceRegistry([svc], enable_docker=True,
                                  enable_dns=False, docker_socket=path)
            loop_runner.run(reg.discover())
            ups = reg.get_upstreams("api")
            got = sorted((u.ip, u.port) for u in ups)
            assert "bad_request" not in state, state["bad_request"]
            assert got == [("172.17.0.2", 8080), ("172.17.0.3", 9000)], got
            # hot-swap: a container goes away -> next tick drops it
            state["payload"] = json.dumps(containers[:1])
            loop_runner.run(reg.discover())
            ups = reg.get_upstreams("api")
            assert [(u.ip, u.port) for u in ups] == [("172.17.0.2", 8080)]
        finally:
            srv.close()
