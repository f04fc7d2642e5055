"""Host data plane: services, discovery, TLS, captcha, geoip, JWT, h2.

Python asyncio implementation of the reference's Rust data plane
(pingoo/services, service_discovery, tls, captcha.rs, geoip.rs). The
listener (`httpd.py`) and the server (`server.py`) are not ported yet
(ROADMAP.md, port queue item 1b-ii); the C++ native plane's ring and its
sidecar are `pingoo_tpu_torch.native_ring`.
"""

# Lazy attribute resolution (PEP 562): several submodules need optional
# packages (`cryptography` for tlsmgr/acme x509, zstd for geoip blobs) —
# importing `pingoo_tpu_torch.host.services` for e.g. route matching must not
# drag those in. Each public name resolves to its submodule on first
# access; a missing optional dependency surfaces where it is USED.
_EXPORTS = {
    "CaptchaManager": "captcha",
    "generate_captcha_client_id": "captcha",
    "ServiceRegistry": "discovery",
    "GeoipDB": "geoip",
    "GeoipRecord": "geoip",
    "HttpProxyService": "services",
    "StaticSiteService": "services",
    "TcpProxyService": "services",
    "build_http_services": "services",
    "TlsManager": "tlsmgr",
    "generate_self_signed": "tlsmgr",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        val = getattr(mod, name)
        globals()[name] = val  # cache for subsequent lookups
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CaptchaManager",
    "GeoipDB",
    "GeoipRecord",
    "HttpProxyService",
    "ServiceRegistry",
    "StaticSiteService",
    "TcpProxyService",
    "TlsManager",
    "build_http_services",
    "generate_self_signed",
    "generate_captcha_client_id",
]
