"""TLS manager: certificate store, SNI dispatch, self-signed default.

Reference parity (pingoo/tls/tls_manager.rs, certificate.rs): load
`*.pem`/`*.key` pairs from the TLS folder (/etc/pingoo/tls), index
certificates by SAN including wildcard SANs (tls_manager.rs:105-128 SNI
resolver), generate a self-signed default certificate for `*` on first
boot (tls_manager.rs:193-231, certificate.rs:146-192), TLS 1.3-only
(tls_manager.rs:95). Python's ssl module handles the handshake; SNI
dispatch uses `SSLContext.sni_callback` swapping per-domain contexts.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from typing import Optional

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

DEFAULT_TLS_DIR = "/etc/pingoo/tls"
DEFAULT_CERT_NAME = "default.pingoo"


class TlsError(Exception):
    pass


def generate_self_signed(
    domains: list[str], valid_days: int = 3650
) -> tuple[bytes, bytes]:
    """-> (cert_pem, key_pem) (reference certificate.rs:146-192 rcgen)."""
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, domains[0] if domains else "*")])
    sans = []
    for d in domains:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(d)))
        except ValueError:
            sans.append(x509.DNSName(d))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=valid_days))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def cert_sans(cert_pem: bytes) -> list[str]:
    """SAN DNS names of a PEM certificate (certificate.rs:74-144)."""
    cert = x509.load_pem_x509_certificate(cert_pem)
    try:
        ext = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName)
    except x509.ExtensionNotFound:
        return []
    names = [n.lower() for n in ext.value.get_values_for_type(x509.DNSName)]
    names += [str(ip) for ip in ext.value.get_values_for_type(x509.IPAddress)]
    return names


def _make_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3  # TLS 1.3-only
    ctx.load_cert_chain(cert_path, key_path)
    # Advertise h2 + http/1.1 like the reference's hyper auto builder
    # (http_listener.rs:276-278); the listener dispatches on the
    # negotiated protocol. Skipped when libnghttp2 is absent.
    try:
        from .h2 import available as h2_available

        ctx.set_alpn_protocols(
            ["h2", "http/1.1"] if h2_available() else ["http/1.1"])
    except (ImportError, NotImplementedError):
        pass
    return ctx


class TlsManager:
    """Cert store + SNI resolver (reference TlsManager)."""

    def __init__(self, tls_dir: str = DEFAULT_TLS_DIR,
                 create_default: bool = True):
        self.tls_dir = tls_dir
        self._by_domain: dict[str, ssl.SSLContext] = {}
        self._wildcards: dict[str, ssl.SSLContext] = {}  # "*.example.com"
        self._default: Optional[ssl.SSLContext] = None
        os.makedirs(tls_dir, exist_ok=True)
        self._load_all()
        if self._default is None and create_default:
            self._create_default()

    def _load_all(self) -> None:
        for fname in sorted(os.listdir(self.tls_dir)):
            if not fname.endswith(".pem"):
                continue
            base = fname[:-4]
            cert_path = os.path.join(self.tls_dir, fname)
            key_path = os.path.join(self.tls_dir, base + ".key")
            if not os.path.exists(key_path):
                continue
            try:
                self.add_certificate(cert_path, key_path)
            except (ssl.SSLError, ValueError, TlsError):
                continue

    def add_certificate(self, cert_path: str, key_path: str) -> None:
        with open(cert_path, "rb") as f:
            cert_pem = f.read()
        ctx = _make_context(cert_path, key_path)
        domains = cert_sans(cert_pem)
        if not domains:
            raise TlsError(f"{cert_path}: certificate has no SANs")
        for domain in domains:
            if domain == "*":
                self._default = ctx
            elif domain.startswith("*."):
                self._wildcards[domain[2:]] = ctx
            else:
                self._by_domain[domain] = ctx

    def _create_default(self) -> None:
        cert_pem, key_pem = generate_self_signed(["*"])
        cert_path = os.path.join(self.tls_dir, DEFAULT_CERT_NAME + ".pem")
        key_path = os.path.join(self.tls_dir, DEFAULT_CERT_NAME + ".key")
        with open(cert_path, "wb") as f:
            f.write(cert_pem)
        with open(key_path, "wb") as f:
            f.write(key_pem)
        self._default = _make_context(cert_path, key_path)

    # -- SNI dispatch (tls_manager.rs:105-128) -------------------------------

    def resolve(self, server_name: Optional[str]) -> Optional[ssl.SSLContext]:
        if server_name:
            name = server_name.lower()
            ctx = self._by_domain.get(name)
            if ctx is not None:
                return ctx
            parent = name.split(".", 1)[-1] if "." in name else None
            if parent and parent in self._wildcards:
                return self._wildcards[parent]
        return self._default

    def server_context(self) -> ssl.SSLContext:
        """The listener-facing context with SNI-based swapping."""
        base = self._default or next(
            iter(self._by_domain.values()), None)
        if base is None:
            raise TlsError("no certificates available")

        def sni_callback(sock, server_name, _ctx):
            resolved = self.resolve(server_name)
            if resolved is not None:
                sock.context = resolved
            return None

        base.sni_callback = sni_callback
        return base
