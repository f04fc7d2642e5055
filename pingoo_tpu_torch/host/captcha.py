"""Proof-of-work captcha + bot gate.

Reference parity (pingoo/captcha.rs):
  * cookies `__pingoo_captcha` (challenge JWT, 10 min) and
    `__pingoo_captcha_verified` (24 h) signed EdDSA, issuer "pingoo"
    (captcha.rs:22-30); 5s JWT drift tolerance.
  * client id = base64url(SHA256(ip || user_agent || host))
    (captcha.rs:409-421), compared constant-time (crypto_utils.rs:3-5).
  * /__pingoo/captcha/api/init issues a 32-byte base64url challenge at
    difficulty 1 (captcha.rs:195-239).
  * /__pingoo/captcha/api/verify recomputes SHA-256(challenge || nonce),
    requires `difficulty` leading '0' hex chars, constant-time client-id
    match, then issues the verified cookie (captcha.rs:241-385).
  * Ed25519 signing key persisted as a JWKS at
    /etc/pingoo/captcha_jwks.json, auto-generated on first boot
    (captcha.rs:78-123).

The embedded frontend (reference: Preact+vite app embedded in the
binary, captcha/captcha.rs) is a single self-contained HTML page using
WebCrypto for the PoW loop.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import time
from typing import Optional

from . import jwt as jose

CAPTCHA_COOKIE = "__pingoo_captcha"
CAPTCHA_VERIFIED_COOKIE = "__pingoo_captcha_verified"
CAPTCHA_JWT_ISSUER = "pingoo"
CAPTCHA_VERIFIED_JWT_EXPIRATION_S = 24 * 3600
CAPTCHA_JWT_EXPIRATION_S = 600
PROOF_OF_WORK_DIFFICULTY = 1
JWT_DRIFT_S = 5
DEFAULT_JWKS_PATH = "/etc/pingoo/captcha_jwks.json"
CAPTCHA_PATH_PREFIX = "/__pingoo/captcha"


def generate_captcha_client_id(ip: str, user_agent: str, host: str) -> str:
    """base64url(SHA256(ip || ua || host)) (captcha.rs:409-421)."""
    digest = hashlib.sha256(
        ip.encode() + user_agent.encode("utf-8", "replace") + host.encode()
    ).digest()
    return base64.urlsafe_b64encode(digest).rstrip(b"=").decode()


class CaptchaManager:
    def __init__(self, jwks_path: str = DEFAULT_JWKS_PATH):
        self.jwks_path = jwks_path
        self.key = self._load_or_create_key()

    def _load_or_create_key(self) -> jose.Key:
        try:
            with open(self.jwks_path, "r", encoding="utf-8") as f:
                jwks = jose.Jwks.from_json(f.read())
            for key in jwks.keys:
                if key.algorithm == jose.ALG_EDDSA and key.private is not None:
                    return key
        except (OSError, jose.JwtError):
            pass
        key = jose.Key.generate(jose.ALG_EDDSA, kid=secrets.token_hex(8))
        try:
            os.makedirs(os.path.dirname(self.jwks_path) or ".", exist_ok=True)
            with open(self.jwks_path, "w", encoding="utf-8") as f:
                f.write(jose.Jwks(keys=[key]).to_json(include_private=True))
        except OSError:
            pass  # ephemeral key; still serviceable
        return key

    # -- verified-gate check (listener hot path) -----------------------------

    def is_verified(self, cookie_value: Optional[str], client_id: str) -> bool:
        """Check the __pingoo_captcha_verified cookie
        (captcha.rs:125-152, called from http_listener.rs:222-236)."""
        if not cookie_value:
            return False
        try:
            claims = jose.parse_and_verify(
                cookie_value, self.key, issuer=CAPTCHA_JWT_ISSUER,
                drift_tolerance_s=JWT_DRIFT_S)
        except jose.JwtError:
            return False
        return bool(claims.get("challenge_passed")) and hmac.compare_digest(
            str(claims.get("client_id", "")), client_id)

    # -- endpoints -----------------------------------------------------------

    def init_challenge(self, client_id: str) -> tuple[dict, str]:
        """-> (response body, Set-Cookie value) (captcha.rs:195-239)."""
        challenge = base64.urlsafe_b64encode(
            secrets.token_bytes(32)).rstrip(b"=").decode()
        now = int(time.time())
        token = jose.sign(self.key, {
            "iss": CAPTCHA_JWT_ISSUER,
            "iat": now,
            "exp": now + CAPTCHA_JWT_EXPIRATION_S,
            "client_id": client_id,
            "challenge": challenge,
            "difficulty": PROOF_OF_WORK_DIFFICULTY,
        })
        body = {"challenge": challenge, "difficulty": PROOF_OF_WORK_DIFFICULTY}
        cookie = (
            f"{CAPTCHA_COOKIE}={token}; Max-Age={CAPTCHA_JWT_EXPIRATION_S}; "
            "Path=/; HttpOnly; SameSite=Lax")
        return body, cookie

    def verify_challenge(
        self, body: dict, cookie_value: Optional[str], client_id: str
    ) -> tuple[bool, Optional[str]]:
        """-> (ok, Set-Cookie for verified token) (captcha.rs:241-385)."""
        if not cookie_value:
            return False, None
        try:
            claims = jose.parse_and_verify(
                cookie_value, self.key, issuer=CAPTCHA_JWT_ISSUER,
                drift_tolerance_s=JWT_DRIFT_S)
        except jose.JwtError:
            return False, None
        if not hmac.compare_digest(str(claims.get("client_id", "")), client_id):
            return False, None
        challenge = str(claims.get("challenge", ""))
        difficulty = int(claims.get("difficulty", PROOF_OF_WORK_DIFFICULTY))
        nonce = body.get("nonce")
        given_hash = str(body.get("hash", "")).lower()
        if not isinstance(nonce, str) or not challenge:
            return False, None
        digest = hashlib.sha256(
            challenge.encode() + nonce.encode()).hexdigest()
        # leading-zero check (captcha.rs:311-321) + exact hash match
        leading = len(digest) - len(digest.lstrip("0"))
        if leading < difficulty:
            return False, None
        if not hmac.compare_digest(digest, given_hash):
            return False, None
        now = int(time.time())
        token = jose.sign(self.key, {
            "iss": CAPTCHA_JWT_ISSUER,
            "iat": now,
            "exp": now + CAPTCHA_VERIFIED_JWT_EXPIRATION_S,
            "client_id": client_id,
            "challenge_passed": True,
        })
        cookie = (
            f"{CAPTCHA_VERIFIED_COOKIE}={token}; "
            f"Max-Age={CAPTCHA_VERIFIED_JWT_EXPIRATION_S}; "
            "Path=/; HttpOnly; SameSite=Lax")
        return True, cookie

    # -- request router (reference serve_captcha_request) --------------------

    def serve(self, method: str, path: str, body: bytes,
              cookies: dict[str, str], client_id: str):
        """Handle /__pingoo/captcha* -> (status, headers, body bytes)."""
        sub = path[len(CAPTCHA_PATH_PREFIX):] or "/"
        if sub in ("", "/") and method == "GET":
            return 200, [("content-type", "text/html; charset=utf-8")], \
                CAPTCHA_PAGE.encode()
        if sub == "/assets/index.js" and method == "GET":
            # The frontend's script asset (the reference serves its vite
            # bundle under /assets, captcha.rs serve_asset).
            from .captcha_frontend import APP_JS

            return 200, [("content-type", "text/javascript"),
                         ("cache-control",
                          "public, no-cache, must-revalidate")], \
                APP_JS.encode()
        # The reference routes /api/init by path only (captcha.rs:167) —
        # its frontend fetches it with GET; POST kept for existing
        # clients of this implementation.
        if sub == "/api/init" and method in ("GET", "POST"):
            payload, cookie = self.init_challenge(client_id)
            return 200, [("content-type", "application/json"),
                         ("set-cookie", cookie)], json.dumps(payload).encode()
        if sub == "/api/verify" and method == "POST":
            try:
                parsed = json.loads(body.decode("utf-8") or "{}")
            except ValueError:
                parsed = {}
            ok, cookie = self.verify_challenge(
                parsed, cookies.get(CAPTCHA_COOKIE), client_id)
            headers = [("content-type", "application/json")]
            if ok and cookie:
                headers.append(("set-cookie", cookie))
            return (200 if ok else 403), headers, json.dumps(
                {"ok": ok}).encode()
        return 404, [("content-type", "text/plain")], b"not found"


# The challenge frontend: built-app parity with the reference's
# Preact/vite bundle (see host/captcha_frontend.py for the derivation).
from .captcha_frontend import INDEX_HTML as CAPTCHA_PAGE  # noqa: E402
