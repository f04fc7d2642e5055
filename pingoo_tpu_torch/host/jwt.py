"""Minimal JOSE: JWT sign/verify + JWK/JWKS.

Reference parity (jwt/ crate): algorithms HS512 / EdDSA(Ed25519) /
ES256 / ES512 (jwt.rs:141-155); compact serialization with
base64url-no-padding; registered claims iss/sub/aud/exp/nbf/iat/jti
(jwt.rs:37-124); verification checks signature then exp/nbf with
clock-drift tolerance and optional aud/iss matching (jwt.rs:213-327);
JWK kty OKP/EC/oct with Key<->Jwk conversion (jwk.rs:15-147,
key.rs:134-213). Crypto backed by the `cryptography` package instead of
aws-lc-rs.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import os
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec, ed25519
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
        encode_dss_signature,
    )

    HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:  # gated: HS512 (hmac/hashlib) needs no backend
    # Environments without the `cryptography` package still get the
    # symmetric JWT path (captcha cookies use HS512); the asymmetric
    # algorithms raise JwtError at key-construction/use time instead of
    # breaking every importer of host.services at import time.
    HAVE_CRYPTOGRAPHY = False

    class InvalidSignature(Exception):  # type: ignore[no-redef]
        pass

    class _MissingCrypto:
        def __init__(self, name):
            self._name = name

        def __getattr__(self, attr):
            raise JwtError(
                f"{self._name}.{attr} requires the 'cryptography' package, "
                "which is not installed")

    hashes = _MissingCrypto("hashes")
    ec = _MissingCrypto("ec")
    ed25519 = _MissingCrypto("ed25519")

    def decode_dss_signature(*_a, **_k):  # type: ignore[no-redef]
        raise JwtError("ECDSA requires the 'cryptography' package")

    def encode_dss_signature(*_a, **_k):  # type: ignore[no-redef]
        raise JwtError("ECDSA requires the 'cryptography' package")

DEFAULT_DRIFT_TOLERANCE_S = 60


class JwtError(Exception):
    pass


def b64url_encode(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode("ascii")


def b64url_decode(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    try:
        return base64.urlsafe_b64decode(text + pad)
    except Exception as exc:
        raise JwtError(f"invalid base64url: {exc}")


# -- keys --------------------------------------------------------------------

ALG_HS512 = "HS512"
ALG_EDDSA = "EdDSA"
ALG_ES256 = "ES256"
ALG_ES512 = "ES512"

_EC_CURVES = {
    ALG_ES256: (ec.SECP256R1(), hashes.SHA256(), 32),
    ALG_ES512: (ec.SECP521R1(), hashes.SHA512(), 66),
} if HAVE_CRYPTOGRAPHY else {}


@dataclass
class Key:
    """A signing/verification key (reference key.rs:12-131)."""

    algorithm: str
    kid: Optional[str] = None
    secret: Optional[bytes] = None  # HS512
    private: object = None  # Ed25519PrivateKey | EllipticCurvePrivateKey
    public: object = None

    # -- generation ----------------------------------------------------------

    @staticmethod
    def generate(algorithm: str, kid: Optional[str] = None) -> "Key":
        if algorithm == ALG_HS512:
            return Key(algorithm, kid=kid, secret=os.urandom(64))
        if algorithm == ALG_EDDSA:
            priv = ed25519.Ed25519PrivateKey.generate()
            return Key(algorithm, kid=kid, private=priv,
                       public=priv.public_key())
        if algorithm in _EC_CURVES:
            curve, _, _ = _EC_CURVES[algorithm]
            priv = ec.generate_private_key(curve)
            return Key(algorithm, kid=kid, private=priv,
                       public=priv.public_key())
        raise JwtError(f"unsupported algorithm {algorithm}")

    # -- sign / verify -------------------------------------------------------

    def sign(self, message: bytes) -> bytes:
        if self.algorithm == ALG_HS512:
            if self.secret is None:
                raise JwtError("missing secret")
            return hmac_mod.new(self.secret, message, hashlib.sha512).digest()
        if self.private is None:
            raise JwtError("missing private key")
        if self.algorithm == ALG_EDDSA:
            return self.private.sign(message)
        curve, hash_alg, size = _EC_CURVES[self.algorithm]
        der = self.private.sign(message, ec.ECDSA(hash_alg))
        r, s = decode_dss_signature(der)
        return r.to_bytes(size, "big") + s.to_bytes(size, "big")

    def verify(self, message: bytes, signature: bytes) -> bool:
        try:
            if self.algorithm == ALG_HS512:
                if self.secret is None:
                    return False
                expected = hmac_mod.new(
                    self.secret, message, hashlib.sha512).digest()
                return hmac_mod.compare_digest(expected, signature)
            pub = self.public or (
                self.private.public_key() if self.private else None)
            if pub is None:
                return False
            if self.algorithm == ALG_EDDSA:
                pub.verify(signature, message)
                return True
            curve, hash_alg, size = _EC_CURVES[self.algorithm]
            if len(signature) != 2 * size:
                return False
            r = int.from_bytes(signature[:size], "big")
            s = int.from_bytes(signature[size:], "big")
            pub.verify(encode_dss_signature(r, s), message, ec.ECDSA(hash_alg))
            return True
        except InvalidSignature:
            return False

    # -- JWK conversion (reference jwk.rs) -----------------------------------

    def to_jwk(self, include_private: bool = False) -> dict:
        jwk: dict = {"alg": self.algorithm}
        if self.kid:
            jwk["kid"] = self.kid
        if self.algorithm == ALG_HS512:
            jwk["kty"] = "oct"
            if include_private:
                jwk["k"] = b64url_encode(self.secret or b"")
            return jwk
        if self.algorithm == ALG_EDDSA:
            jwk["kty"] = "OKP"
            jwk["crv"] = "Ed25519"
            pub = self.public or self.private.public_key()
            from cryptography.hazmat.primitives.serialization import (
                Encoding, PublicFormat, PrivateFormat, NoEncryption,
            )

            jwk["x"] = b64url_encode(
                pub.public_bytes(Encoding.Raw, PublicFormat.Raw))
            if include_private and self.private is not None:
                jwk["d"] = b64url_encode(self.private.private_bytes(
                    Encoding.Raw, PrivateFormat.Raw, NoEncryption()))
            return jwk
        curve, _, size = _EC_CURVES[self.algorithm]
        jwk["kty"] = "EC"
        jwk["crv"] = "P-256" if self.algorithm == ALG_ES256 else "P-521"
        pub = self.public or self.private.public_key()
        nums = pub.public_numbers()
        jwk["x"] = b64url_encode(nums.x.to_bytes(size, "big"))
        jwk["y"] = b64url_encode(nums.y.to_bytes(size, "big"))
        if include_private and self.private is not None:
            d = self.private.private_numbers().private_value
            jwk["d"] = b64url_encode(d.to_bytes(size, "big"))
        return jwk

    @staticmethod
    def from_jwk(jwk: dict) -> "Key":
        kty = jwk.get("kty")
        alg = jwk.get("alg")
        kid = jwk.get("kid")
        if kty == "oct":
            return Key(alg or ALG_HS512, kid=kid,
                       secret=b64url_decode(jwk.get("k", "")))
        if kty == "OKP":
            if jwk.get("crv") != "Ed25519":
                raise JwtError(f"unsupported OKP curve {jwk.get('crv')}")
            pub = ed25519.Ed25519PublicKey.from_public_bytes(
                b64url_decode(jwk["x"]))
            priv = None
            if "d" in jwk:
                priv = ed25519.Ed25519PrivateKey.from_private_bytes(
                    b64url_decode(jwk["d"]))
            return Key(ALG_EDDSA, kid=kid, private=priv, public=pub)
        if kty == "EC":
            crv = jwk.get("crv")
            algorithm = {"P-256": ALG_ES256, "P-521": ALG_ES512}.get(crv)
            if algorithm is None:
                raise JwtError(f"unsupported EC curve {crv}")
            curve, _, _ = _EC_CURVES[algorithm]
            x = int.from_bytes(b64url_decode(jwk["x"]), "big")
            y = int.from_bytes(b64url_decode(jwk["y"]), "big")
            pub_nums = ec.EllipticCurvePublicNumbers(x, y, curve)
            pub = pub_nums.public_key()
            priv = None
            if "d" in jwk:
                d = int.from_bytes(b64url_decode(jwk["d"]), "big")
                priv = ec.EllipticCurvePrivateNumbers(d, pub_nums).private_key()
            return Key(algorithm, kid=kid, private=priv, public=pub)
        raise JwtError(f"unsupported kty {kty}")


@dataclass
class Jwks:
    """A JWK set (reference jwk.rs Jwks)."""

    keys: list[Key] = field(default_factory=list)

    def to_json(self, include_private: bool = False) -> str:
        return json.dumps(
            {"keys": [k.to_jwk(include_private) for k in self.keys]})

    @staticmethod
    def from_json(text: str) -> "Jwks":
        try:
            raw = json.loads(text)
            return Jwks(keys=[Key.from_jwk(j) for j in raw.get("keys", [])])
        except (ValueError, KeyError, TypeError) as exc:
            raise JwtError(f"invalid JWKS: {exc}")

    def find(self, kid: Optional[str]) -> Optional[Key]:
        for key in self.keys:
            if key.kid == kid:
                return key
        return self.keys[0] if self.keys and kid is None else None


def jwk_thumbprint(key: Key) -> str:
    """RFC 7638 JWK thumbprint (SHA-256, base64url) — used for ACME key
    authorizations."""
    jwk = key.to_jwk()
    if jwk["kty"] == "EC":
        canonical = {"crv": jwk["crv"], "kty": "EC", "x": jwk["x"],
                     "y": jwk["y"]}
    elif jwk["kty"] == "OKP":
        canonical = {"crv": jwk["crv"], "kty": "OKP", "x": jwk["x"]}
    else:
        canonical = {"k": jwk.get("k", ""), "kty": "oct"}
    digest = hashlib.sha256(
        json.dumps(canonical, separators=(",", ":"),
                   sort_keys=True).encode()).digest()
    return b64url_encode(digest)


# -- tokens ------------------------------------------------------------------


def sign(key: Key, claims: dict, header_extra: Optional[dict] = None) -> str:
    """Compact JWT (reference jwt.rs:172-196)."""
    header = {"alg": key.algorithm, "typ": "JWT"}
    if key.kid:
        header["kid"] = key.kid
    if header_extra:
        header.update(header_extra)
    signing_input = (
        b64url_encode(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + b64url_encode(json.dumps(claims, separators=(",", ":")).encode())
    )
    sig = key.sign(signing_input.encode("ascii"))
    return signing_input + "." + b64url_encode(sig)


def parse_header(token: str) -> dict:
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("invalid token: expected 3 parts")
    try:
        return json.loads(b64url_decode(parts[0]))
    except ValueError as exc:
        raise JwtError(f"invalid token header: {exc}")


def parse_and_verify(
    token: str,
    key: Key,
    audience: Optional[str] = None,
    issuer: Optional[str] = None,
    now: Optional[float] = None,
    drift_tolerance_s: int = DEFAULT_DRIFT_TOLERANCE_S,
) -> dict:
    """Verify signature + registered claims; returns the claims
    (reference jwt.rs:213-327)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("invalid token: expected 3 parts")
    header = parse_header(token)
    if header.get("alg") != key.algorithm:
        raise JwtError(
            f"algorithm mismatch: token {header.get('alg')}, key {key.algorithm}")
    signing_input = (parts[0] + "." + parts[1]).encode("ascii")
    if not key.verify(signing_input, b64url_decode(parts[2])):
        raise JwtError("invalid signature")
    try:
        claims = json.loads(b64url_decode(parts[1]))
    except ValueError as exc:
        raise JwtError(f"invalid claims: {exc}")
    if not isinstance(claims, dict):
        raise JwtError("invalid claims: not an object")

    now = time.time() if now is None else now
    exp = claims.get("exp")
    if exp is not None and float(exp) + drift_tolerance_s < now:
        raise JwtError("token expired")
    nbf = claims.get("nbf")
    if nbf is not None and float(nbf) - drift_tolerance_s > now:
        raise JwtError("token not yet valid")
    if audience is not None:
        aud = claims.get("aud")
        auds: Iterable = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise JwtError("audience mismatch")
    if issuer is not None and claims.get("iss") != issuer:
        raise JwtError("issuer mismatch")
    return claims
