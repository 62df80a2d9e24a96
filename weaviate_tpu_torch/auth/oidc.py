"""OIDC bearer-token validation against a JWKS.

Reference: adapters/handlers/rest/configure_api.go:601 + usecases/auth/
authentication/oidc — bearer tokens are validated against the issuer's
JWKS (signature, expiry, issuer, audience) and the username/groups claims
feed authorization.

Zero-egress deployments point ``AUTHENTICATION_OIDC_JWKS_FILE`` at a
local JWKS JSON (the issuer's /.well-known/jwks.json fetched out of
band); otherwise the JWKS is fetched once from the issuer and cached.
RS256 and ES256 keys are supported (the two algorithms real issuers use).
"""

from __future__ import annotations

import base64
import json
import os
import time


class OidcError(Exception):
    """Token failed validation (maps to 401)."""


def _b64url(data: str) -> bytes:
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


def _b64url_uint(data: str) -> int:
    return int.from_bytes(_b64url(data), "big")


class JwksValidator:
    """Validates JWTs against a JWKS key set."""

    def __init__(self, issuer: str, client_id: str,
                 jwks: dict | None = None, jwks_file: str | None = None,
                 username_claim: str = "sub", groups_claim: str = "",
                 skip_client_id_check: bool = False):
        self.issuer = issuer.rstrip("/")
        self.client_id = client_id
        self.username_claim = username_claim
        self.groups_claim = groups_claim
        self.skip_client_id_check = skip_client_id_check
        self._keys: dict[str, object] = {}
        if jwks is None and jwks_file:
            with open(jwks_file) as f:
                jwks = json.load(f)
        if jwks is None and self.issuer:
            jwks = self._fetch_jwks()
        for jwk in (jwks or {}).get("keys", []):
            key = self._load_jwk(jwk)
            if key is not None:
                # "alg" is OPTIONAL in a JWK (RFC 7517 §4.4) — infer from
                # the key type when absent so verification never trusts the
                # token header's alg
                alg = jwk.get("alg") or (
                    "RS256" if jwk.get("kty") == "RSA" else "ES256")
                self._keys[jwk.get("kid", "")] = (alg, key)

    # -- key loading ---------------------------------------------------------

    def _fetch_jwks(self) -> dict | None:
        """Fetch {issuer}/.well-known/jwks.json — best-effort (a zero-
        egress deployment uses AUTHENTICATION_OIDC_JWKS_FILE instead)."""
        import urllib.request

        for path in ("/.well-known/jwks.json", "/jwks", "/keys"):
            try:
                with urllib.request.urlopen(self.issuer + path,
                                            timeout=5) as r:
                    return json.loads(r.read())
            except Exception:  # noqa: BLE001 — try the next convention
                continue
        return None

    @staticmethod
    def _load_jwk(jwk: dict):
        from cryptography.hazmat.primitives.asymmetric import ec, rsa

        kty = jwk.get("kty")
        try:
            if kty == "RSA":
                pub = rsa.RSAPublicNumbers(
                    e=_b64url_uint(jwk["e"]), n=_b64url_uint(jwk["n"]))
                return pub.public_key()
            if kty == "EC" and jwk.get("crv") == "P-256":
                pub = ec.EllipticCurvePublicNumbers(
                    x=_b64url_uint(jwk["x"]), y=_b64url_uint(jwk["y"]),
                    curve=ec.SECP256R1())
                return pub.public_key()
        except (KeyError, ValueError):
            return None
        return None

    @property
    def has_keys(self) -> bool:
        return bool(self._keys)

    # -- validation ----------------------------------------------------------

    def validate(self, token: str) -> dict:
        """Returns the verified claims dict or raises OidcError."""
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec, padding
        from cryptography.hazmat.primitives.asymmetric.utils import (
            encode_dss_signature)

        parts = token.split(".")
        if len(parts) != 3:
            raise OidcError("malformed JWT")
        try:
            header = json.loads(_b64url(parts[0]))
            claims = json.loads(_b64url(parts[1]))
            sig = _b64url(parts[2])
        except (ValueError, json.JSONDecodeError) as e:
            raise OidcError(f"malformed JWT: {e}") from e
        kid = header.get("kid", "")
        entry = self._keys.get(kid)
        if entry is None and len(self._keys) == 1:
            entry = next(iter(self._keys.values()))  # single-key JWKS
        if entry is None:
            raise OidcError(f"no JWKS key for kid {kid!r}")
        alg, key = entry
        # Pin the algorithm to the JWK's declared (or key-type-inferred)
        # alg — never to the attacker-controlled token header (reference
        # go-oidc: supported algs come from config).
        if header.get("alg") != alg:
            raise OidcError(
                f"JWT alg {header.get('alg')!r} does not match JWK alg {alg!r}")
        signed = (parts[0] + "." + parts[1]).encode()
        try:
            if alg == "RS256":
                key.verify(sig, signed, padding.PKCS1v15(), hashes.SHA256())
            elif alg == "ES256":
                if len(sig) != 64:
                    raise OidcError("malformed ES256 signature")
                der = encode_dss_signature(
                    int.from_bytes(sig[:32], "big"),
                    int.from_bytes(sig[32:], "big"))
                key.verify(der, signed, ec.ECDSA(hashes.SHA256()))
            else:
                raise OidcError(f"unsupported JWT alg {alg!r}")
        except InvalidSignature as e:
            raise OidcError("invalid JWT signature") from e
        except OidcError:
            raise
        except Exception as e:  # key-type/alg mismatch etc.
            raise OidcError(f"JWT verification failed: {e}") from e

        now = time.time()
        # Missing expiry = invalid (the reference's go-oidc verifier treats
        # tokens without exp as expired) — otherwise a leaked token without
        # exp would be accepted forever.
        if "exp" not in claims:
            raise OidcError("JWT missing exp claim")
        try:
            exp = float(claims["exp"])
            nbf = float(claims["nbf"]) if "nbf" in claims else None
        except (TypeError, ValueError) as e:
            raise OidcError(f"JWT has non-numeric exp/nbf: {e}") from e
        if now >= exp + 30:
            raise OidcError("JWT expired")
        if nbf is not None and now < nbf - 30:
            raise OidcError("JWT not yet valid")
        if self.issuer and claims.get("iss", "").rstrip("/") != self.issuer:
            raise OidcError(
                f"JWT issuer {claims.get('iss')!r} != {self.issuer!r}")
        if not self.skip_client_id_check and self.client_id:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.client_id not in auds:
                raise OidcError("JWT audience does not include the client id")
        return claims

    def principal_claims(self, token: str) -> tuple[str, list[str]]:
        claims = self.validate(token)
        username = str(claims.get(self.username_claim, "")
                       or claims.get("sub", ""))
        if not username:
            raise OidcError(
                f"JWT missing username claim {self.username_claim!r}")
        groups = []
        if self.groups_claim:
            g = claims.get(self.groups_claim)
            if isinstance(g, list):
                groups = [str(x) for x in g]
            elif g:
                groups = [str(g)]
        return username, groups


def validator_from_env(env=None) -> JwksValidator | None:
    env = env if env is not None else os.environ
    if env.get("AUTHENTICATION_OIDC_ENABLED", "").lower() not in (
            "true", "1", "on"):
        return None
    v = JwksValidator(
        issuer=env.get("AUTHENTICATION_OIDC_ISSUER", ""),
        client_id=env.get("AUTHENTICATION_OIDC_CLIENT_ID", ""),
        jwks_file=env.get("AUTHENTICATION_OIDC_JWKS_FILE") or None,
        username_claim=env.get("AUTHENTICATION_OIDC_USERNAME_CLAIM", "sub"),
        groups_claim=env.get("AUTHENTICATION_OIDC_GROUPS_CLAIM", ""),
        skip_client_id_check=env.get(
            "AUTHENTICATION_OIDC_SKIP_CLIENT_ID_CHECK", "").lower() in (
                "true", "1", "on"),
    )
    return v  # a keyless validator still rejects tokens with a clear error
