"""ACME (RFC 8555) automatic TLS certificates.

Reference parity (pingoo/tls/acme.rs): Let's Encrypt production
directory by default (acme.rs:29); a background loop every 6 h orders
certificates for configured domains that are missing or expiring within
30 days (acme.rs:67-178); the account (ES256 key + registration URL) is
persisted to `<tls_dir>/acme.json` as a versioned document
(AcmeConfig::V1, acme.rs:32-58,308-371); issued certificates are
hot-inserted into the TlsManager and written next to the other certs
with retries (acme.rs:124-169).

Challenge types: tls-alpn-01 (the reference's only type, acme.rs:180-242)
when an `alpn_dir` is configured — the ephemeral challenge certificate
(RFC 8737: SAN = domain, critical acmeIdentifier extension carrying
SHA256(key authorization)) is written as `<domain>.pem/.key` into the
dir the native TLS transport answers `acme-tls/1` handshakes from
(native/httpd.cc client_hello_cb; Python's ssl layer cannot select a
certificate by client ALPN, which is why this rides the C++ plane).
Fallback: http-01 — the HTTP listener serves
/.well-known/acme-challenge/<token> from `AcmeManager.challenges`.
"""

from __future__ import annotations

import asyncio
import base64
import datetime
import json
import os
import time
from typing import Optional

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

from ..logging_utils import get_logger
from . import jwt as jose

log = get_logger(__name__)

LETSENCRYPT_PRODUCTION_URL = "https://acme-v02.api.letsencrypt.org/directory"
RENEW_BEFORE_DAYS = 30
LOOP_INTERVAL_S = 6 * 3600
PERSIST_RETRIES = 5
PERSIST_RETRY_DELAY_S = 5.0
HTTP01_PATH_PREFIX = "/.well-known/acme-challenge/"


ACME_IDENTIFIER_OID = x509.ObjectIdentifier("1.3.6.1.5.5.7.1.31")


class AcmeError(Exception):
    pass


def make_tls_alpn_challenge_cert(domain: str,
                                 keyauth: str) -> tuple[bytes, bytes]:
    """RFC 8737 §3 challenge certificate: self-signed, SAN = [domain],
    critical id-pe-acmeIdentifier extension = DER OCTET STRING of
    SHA256(key authorization) (reference acme.rs:208-242)."""
    import hashlib

    digest = hashlib.sha256(keyauth.encode("ascii")).digest()
    acme_ext = x509.UnrecognizedExtension(
        ACME_IDENTIFIER_OID, b"\x04\x20" + digest)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, domain)])
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(hours=1))
        .public_key(key.public_key())
        .add_extension(x509.SubjectAlternativeName(
            [x509.DNSName(domain)]), critical=False)
        .add_extension(acme_ext, critical=True)
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    return cert_pem, key_pem


class AcmeClient:
    """One account against one directory."""

    def __init__(self, directory_url: str, account_key: jose.Key,
                 kid: Optional[str] = None, session=None):
        self.directory_url = directory_url
        self.key = account_key
        self.kid = kid  # account URL once registered
        self._session = session
        self._directory: Optional[dict] = None
        self._nonce: Optional[str] = None

    async def _http(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self):
        if self._session is not None:
            await self._session.close()

    async def directory(self) -> dict:
        if self._directory is None:
            session = await self._http()
            async with session.get(self.directory_url) as resp:
                if resp.status != 200:
                    raise AcmeError(f"directory fetch: {resp.status}")
                self._directory = await resp.json()
        return self._directory

    async def _new_nonce(self) -> str:
        directory = await self.directory()
        session = await self._http()
        async with session.head(directory["newNonce"]) as resp:
            nonce = resp.headers.get("Replay-Nonce")
            if not nonce:
                raise AcmeError("no Replay-Nonce")
            return nonce

    async def _post(self, url: str, payload: Optional[dict],
                    use_jwk: bool = False) -> tuple[int, dict, dict]:
        """Signed JWS POST (flattened JSON). payload None -> POST-as-GET."""
        if self._nonce is None:
            self._nonce = await self._new_nonce()
        protected = {"alg": "ES256", "nonce": self._nonce, "url": url}
        if use_jwk or self.kid is None:
            protected["jwk"] = {
                k: v for k, v in self.key.to_jwk().items()
                if k in ("kty", "crv", "x", "y")}
        else:
            protected["kid"] = self.kid
        protected_b64 = jose.b64url_encode(
            json.dumps(protected, separators=(",", ":")).encode())
        payload_b64 = ("" if payload is None else jose.b64url_encode(
            json.dumps(payload, separators=(",", ":")).encode()))
        signature = self.key.sign(
            (protected_b64 + "." + payload_b64).encode("ascii"))
        body = json.dumps({
            "protected": protected_b64,
            "payload": payload_b64,
            "signature": jose.b64url_encode(signature),
        })
        session = await self._http()
        async with session.post(
            url, data=body,
            headers={"content-type": "application/jose+json"},
        ) as resp:
            self._nonce = resp.headers.get("Replay-Nonce")
            headers = dict(resp.headers)
            try:
                data = await resp.json()
            except Exception:
                data = {"raw": await resp.text()}
            return resp.status, headers, data

    # -- account / order flow ------------------------------------------------

    async def register(self) -> str:
        directory = await self.directory()
        status, headers, data = await self._post(
            directory["newAccount"],
            {"termsOfServiceAgreed": True}, use_jwk=True)
        if status not in (200, 201):
            raise AcmeError(f"newAccount: {status} {data}")
        self.kid = headers.get("Location")
        if not self.kid:
            raise AcmeError("newAccount: no Location")
        return self.kid

    async def order_certificate(self, domains: list[str],
                                challenges: dict[str, str],
                                poll_interval_s: float = 1.0,
                                poll_tries: int = 30,
                                alpn_dir: Optional[str] = None
                                ) -> tuple[bytes, bytes]:
        """-> (cert_pem_chain, key_pem).

        With `alpn_dir` set, validates via tls-alpn-01 (the reference's
        only type, acme.rs:180-242): the RFC 8737 challenge certificate
        is written as <domain>.pem/.key for the native TLS transport to
        answer at accept time. Otherwise http-01: key authorizations are
        published into `challenges` (token -> keyauth) for the HTTP
        listener. (reference order_certificate, acme.rs:245-306.)
        """
        directory = await self.directory()
        status, headers, order = await self._post(
            directory["newOrder"],
            {"identifiers": [{"type": "dns", "value": d} for d in domains]})
        if status not in (200, 201):
            raise AcmeError(f"newOrder: {status} {order}")
        order_url = headers.get("Location", "")

        want_type = "tls-alpn-01" if alpn_dir else "http-01"
        thumbprint = jose.jwk_thumbprint(self.key)
        published: list[str] = []
        staged_files: list[str] = []
        try:
            for authz_url in order.get("authorizations", []):
                status, _, authz = await self._post(authz_url, None)
                if status != 200:
                    raise AcmeError(f"authz: {status}")
                if authz.get("status") == "valid":
                    continue
                challenge = next(
                    (c for c in authz.get("challenges", [])
                     if c.get("type") == want_type), None)
                if challenge is None:
                    raise AcmeError(f"no {want_type} challenge offered")
                token = challenge["token"]
                keyauth = f"{token}.{thumbprint}"
                if alpn_dir:
                    domain = authz.get("identifier", {}).get(
                        "value", domains[0])
                    cert_pem, key_pem = make_tls_alpn_challenge_cert(
                        domain, keyauth)
                    os.makedirs(alpn_dir, exist_ok=True)
                    cert_path = os.path.join(alpn_dir, domain + ".pem")
                    key_path = os.path.join(alpn_dir, domain + ".key")
                    fd = os.open(key_path,
                                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                                 0o600)
                    # O_CREAT's mode only applies to NEW files; clamp a
                    # pre-existing key file's mode too (cert renewals).
                    os.fchmod(fd, 0o600)
                    with os.fdopen(fd, "wb") as f:
                        f.write(key_pem)
                    with open(cert_path, "wb") as f:
                        f.write(cert_pem)
                    staged_files += [cert_path, key_path]
                else:
                    challenges[token] = keyauth
                    published.append(token)
                status, _, _ = await self._post(challenge["url"], {})
                if status not in (200, 202):
                    raise AcmeError(f"challenge ready: {status}")
                for _ in range(poll_tries):
                    status, _, authz = await self._post(authz_url, None)
                    if authz.get("status") == "valid":
                        break
                    if authz.get("status") == "invalid":
                        raise AcmeError(f"authorization failed: {authz}")
                    await asyncio.sleep(poll_interval_s)
                else:
                    raise AcmeError("authorization timed out")

            key = ec.generate_private_key(ec.SECP256R1())
            csr = (
                x509.CertificateSigningRequestBuilder()
                .subject_name(x509.Name(
                    [x509.NameAttribute(NameOID.COMMON_NAME, domains[0])]))
                .add_extension(x509.SubjectAlternativeName(
                    [x509.DNSName(d) for d in domains]), critical=False)
                .sign(key, hashes.SHA256())
            )
            csr_b64 = jose.b64url_encode(
                csr.public_bytes(serialization.Encoding.DER))
            status, _, order = await self._post(
                order["finalize"], {"csr": csr_b64})
            if status not in (200, 202):
                raise AcmeError(f"finalize: {status} {order}")
            for _ in range(poll_tries):
                if order.get("status") == "valid" and order.get("certificate"):
                    break
                if order.get("status") == "invalid":
                    raise AcmeError(f"order failed: {order}")
                await asyncio.sleep(poll_interval_s)
                status, _, order = await self._post(order_url, None)
            cert_url = order.get("certificate")
            if not cert_url:
                raise AcmeError("order never became valid")
            status, _, cert_doc = await self._post(cert_url, None)
            if status != 200:
                raise AcmeError(f"certificate download: {status}")
            cert_pem = cert_doc.get("raw", "").encode()
            key_pem = key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption())
            return cert_pem, key_pem
        finally:
            for token in published:
                challenges.pop(token, None)
            for path in staged_files:  # challenge certs are ephemeral
                try:
                    os.unlink(path)
                except OSError:
                    pass


class AcmeManager:
    """Account persistence + renewal loop + challenge store."""

    def __init__(self, tls_dir: str, domains: list[str],
                 directory_url: str = LETSENCRYPT_PRODUCTION_URL,
                 tls_manager=None, alpn_dir: Optional[str] = None):
        self.tls_dir = tls_dir
        self.domains = list(domains)
        self.directory_url = directory_url
        self.tls_manager = tls_manager
        # tls-alpn-01 challenge-cert dir (native TLS transport answers
        # from it); None -> http-01 via `challenges`.
        self.alpn_dir = alpn_dir
        self.challenges: dict[str, str] = {}  # token -> key authorization
        self._task: Optional[asyncio.Task] = None
        self.client = AcmeClient(directory_url, *self._load_account())

    # -- account persistence (acme.rs:308-371, AcmeConfig::V1) ---------------

    def _account_path(self) -> str:
        return os.path.join(self.tls_dir, "acme.json")

    def _load_account(self) -> tuple[jose.Key, Optional[str]]:
        try:
            with open(self._account_path(), "r", encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("version") == 1 and doc.get("directory_url") == \
                    self.directory_url:
                der = base64.b64decode(doc["private_key"])
                priv = serialization.load_der_private_key(der, None)
                key = jose.Key(jose.ALG_ES256, private=priv,
                               public=priv.public_key())
                return key, doc.get("account_url")
        except (OSError, ValueError, KeyError):
            pass
        return jose.Key.generate(jose.ALG_ES256), None

    def _persist_account(self) -> None:
        der = self.client.key.private.private_bytes(
            serialization.Encoding.DER,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        doc = {
            "version": 1,
            "directory_url": self.directory_url,
            "account_url": self.client.kid,
            "private_key": base64.b64encode(der).decode(),
        }
        os.makedirs(self.tls_dir, exist_ok=True)
        with open(self._account_path(), "w", encoding="utf-8") as f:
            json.dump(doc, f)

    # -- renewal loop (acme.rs:67-178) ---------------------------------------

    async def start_in_background(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self.client.close()

    def domains_needing_certificates(self, now=None) -> list[str]:
        now = now or datetime.datetime.now(datetime.timezone.utc)
        out = []
        for domain in self.domains:
            cert_path = os.path.join(self.tls_dir, domain + ".pem")
            if not os.path.exists(cert_path):
                out.append(domain)
                continue
            try:
                with open(cert_path, "rb") as f:
                    cert = x509.load_pem_x509_certificate(f.read())
                expiry = cert.not_valid_after_utc
            except (ValueError, OSError):
                out.append(domain)
                continue
            if expiry - now < datetime.timedelta(days=RENEW_BEFORE_DAYS):
                out.append(domain)
        return out

    async def _loop(self) -> None:
        while True:
            try:
                await self.renew_all()
            except Exception as exc:
                log.warning(f"acme: renewal pass failed: {exc}")
            await asyncio.sleep(LOOP_INTERVAL_S)

    async def renew_all(self) -> None:
        needed = self.domains_needing_certificates()
        if not needed:
            return
        if self.client.kid is None:
            await self.client.register()
            self._persist_account()
        for domain in needed:
            try:
                cert_pem, key_pem = await self.client.order_certificate(
                    [domain], self.challenges, alpn_dir=self.alpn_dir)
                await self._install(domain, cert_pem, key_pem)
                log.info("acme: certificate issued",
                         extra={"fields": {"domain": domain}})
            except AcmeError as exc:
                log.warning(f"acme: {domain}: {exc}")

    async def _install(self, domain: str, cert_pem: bytes,
                       key_pem: bytes) -> None:
        cert_path = os.path.join(self.tls_dir, domain + ".pem")
        key_path = os.path.join(self.tls_dir, domain + ".key")
        for attempt in range(PERSIST_RETRIES):
            try:
                with open(key_path, "wb") as f:
                    f.write(key_pem)
                with open(cert_path, "wb") as f:
                    f.write(cert_pem)
                break
            except OSError:
                await asyncio.sleep(PERSIST_RETRY_DELAY_S)
        if self.tls_manager is not None:
            self.tls_manager.add_certificate(cert_path, key_path)
