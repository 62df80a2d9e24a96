"""Authentication and authorization.

Reference:
- authn: API keys (usecases/auth/authentication/apikey — static key list
  mapped to users via AUTHENTICATION_APIKEY_ALLOWED_KEYS/USERS),
  anonymous access (AUTHENTICATION_ANONYMOUS_ACCESS_ENABLED), and OIDC
  (adapters/handlers/rest/configure_api.go:601; validated against the
  issuer's JWKS).
- authz: admin-list (usecases/auth/authorization/adminlist — admins get
  everything, read-only users get GET/HEAD), composed at
  configure_api.go:468.

OIDC bearer tokens validate against the issuer's JWKS (auth/oidc.py —
RS256/ES256 signature, exp/nbf, issuer, audience), with
AUTHENTICATION_OIDC_JWKS_FILE providing the key set offline for
zero-egress deployments (reference: configure_api.go:601).
"""

from __future__ import annotations

import hmac
import os
from dataclasses import dataclass, field


class AuthError(Exception):
    """401 — missing/invalid credentials."""


class ForbiddenError(Exception):
    """403 — authenticated but not allowed."""


@dataclass
class Principal:
    username: str
    auth_method: str = "anonymous"  # anonymous | apikey | oidc

    @property
    def is_anonymous(self) -> bool:
        return self.auth_method == "anonymous"


@dataclass
class AuthConfig:
    anonymous_enabled: bool = True
    # api keys: keys[i] authenticates as users[min(i, len(users)-1)]
    # (reference: AUTHENTICATION_APIKEY_ALLOWED_KEYS / _USERS semantics)
    api_keys: list[str] = field(default_factory=list)
    api_users: list[str] = field(default_factory=list)
    oidc_enabled: bool = False
    oidc_issuer: str = ""
    oidc_client_id: str = ""
    # authorization: admin list (empty admin list = everyone may write)
    admin_users: list[str] = field(default_factory=list)
    readonly_users: list[str] = field(default_factory=list)

    def __post_init__(self):
        # Reference rejects this misconfiguration at startup
        # (usecases/config: keys and users must align, or a single user
        # covers all keys). Without this check, surplus keys silently
        # authenticate as the LAST listed user.
        if len(self.api_users) > 1 and len(self.api_keys) != len(self.api_users):
            raise ValueError(
                "AUTHENTICATION_APIKEY_ALLOWED_KEYS and "
                "AUTHENTICATION_APIKEY_USERS must have the same length "
                f"(got {len(self.api_keys)} keys, {len(self.api_users)} users) "
                "unless at most one user is configured")

    @classmethod
    def from_env(cls, env=os.environ) -> "AuthConfig":
        """Reference env surface (usecases/config/environment.go)."""
        def flag(name, default="false"):
            return env.get(name, default).lower() in ("true", "1", "on")

        def csv(name):
            raw = env.get(name, "")
            return [s.strip() for s in raw.split(",") if s.strip()]

        keys_on = flag("AUTHENTICATION_APIKEY_ENABLED")
        return cls(
            anonymous_enabled=flag(
                "AUTHENTICATION_ANONYMOUS_ACCESS_ENABLED",
                "false" if keys_on else "true"),
            api_keys=csv("AUTHENTICATION_APIKEY_ALLOWED_KEYS")
            if keys_on else [],
            api_users=csv("AUTHENTICATION_APIKEY_USERS") if keys_on else [],
            oidc_enabled=flag("AUTHENTICATION_OIDC_ENABLED"),
            oidc_issuer=env.get("AUTHENTICATION_OIDC_ISSUER", ""),
            oidc_client_id=env.get("AUTHENTICATION_OIDC_CLIENT_ID", ""),
            admin_users=csv("AUTHORIZATION_ADMINLIST_USERS")
            if flag("AUTHORIZATION_ADMINLIST_ENABLED") else [],
            readonly_users=csv("AUTHORIZATION_ADMINLIST_READONLY_USERS")
            if flag("AUTHORIZATION_ADMINLIST_ENABLED") else [],
        )


class Authenticator:
    def __init__(self, config: AuthConfig, oidc_validator=None):
        self.config = config
        if oidc_validator is None and config.oidc_enabled:
            from weaviate_tpu_torch.auth.oidc import validator_from_env

            try:
                oidc_validator = validator_from_env()
            except (OSError, ValueError) as e:
                import logging

                logging.getLogger(__name__).error(
                    "OIDC validator init failed: %s", e)
        self.oidc_validator = oidc_validator

    def authenticate(self, authorization: str | None) -> Principal:
        """``authorization``: the Authorization header value or None."""
        cfg = self.config
        if authorization:
            scheme, _, token = authorization.partition(" ")
            if scheme.lower() != "bearer" or not token:
                raise AuthError("Authorization header must be 'Bearer <key>'")
            token = token.strip()
            # compare as bytes: str compare_digest raises on non-ASCII,
            # which would turn a bad credential into a 500 instead of 401
            token_b = token.encode("utf-8", "surrogatepass")
            for i, key in enumerate(cfg.api_keys):
                if hmac.compare_digest(token_b, key.encode("utf-8")):
                    users = cfg.api_users
                    user = users[min(i, len(users) - 1)] if users else "api-key-user"
                    return Principal(user, "apikey")
            if cfg.oidc_enabled and token.count(".") == 2:
                # JWT validation against the configured JWKS (reference:
                # configure_api.go:601). JWTs have two dots; API keys
                # don't — a mistyped key keeps the crisp "invalid api
                # key" below instead of a confusing JWT-parse error.
                v = self.oidc_validator
                if v is None or not v.has_keys:
                    raise AuthError(
                        "OIDC is enabled but no JWKS is available; set "
                        "AUTHENTICATION_OIDC_JWKS_FILE or check issuer "
                        "connectivity")
                from weaviate_tpu_torch.auth.oidc import OidcError

                try:
                    username, _groups = v.principal_claims(token)
                except OidcError as e:
                    raise AuthError(str(e)) from e
                return Principal(username, "oidc")
            if cfg.oidc_enabled and not cfg.api_keys:
                raise AuthError("bearer token is not a JWT and no API "
                                "keys are configured")
            raise AuthError("invalid api key")
        if cfg.anonymous_enabled:
            return Principal("anonymous", "anonymous")
        raise AuthError("anonymous access is disabled; provide a Bearer key")


class Authorizer:
    """Admin-list authorization (reference: authorization/adminlist):
    - no admin list configured → every authenticated principal may do
      anything (the reference's default 'all allowed' authorizer)
    - admin list configured → admins: everything; read-only users: reads;
      everyone else: denied
    """

    def __init__(self, config: AuthConfig):
        self.config = config

    def authorize(self, principal: Principal, verb: str) -> None:
        """``verb``: "read" or "write"."""
        cfg = self.config
        if not cfg.admin_users and not cfg.readonly_users:
            return
        if principal.username in cfg.admin_users:
            return
        if principal.username in cfg.readonly_users:
            if verb == "read":
                return
            raise ForbiddenError(
                f"user {principal.username!r} has read-only access")
        raise ForbiddenError(
            f"user {principal.username!r} is not on the admin list")


class AuthStack:
    """Authenticator + authorizer bundle the API servers consume."""

    def __init__(self, config: AuthConfig | None = None):
        self.config = config or AuthConfig()
        self.authenticator = Authenticator(self.config)
        self.authorizer = Authorizer(self.config)

    def check(self, authorization: str | None, verb: str) -> Principal:
        p = self.authenticator.authenticate(authorization)
        self.authorizer.authorize(p, verb)
        return p

    def openid_configuration(self) -> dict | None:
        """Payload for /.well-known/openid-configuration (reference serves
        the issuer's discovery document location + client id)."""
        if not self.config.oidc_enabled:
            return None
        return {
            "href": f"{self.config.oidc_issuer.rstrip('/')}"
                    "/.well-known/openid-configuration",
            "clientId": self.config.oidc_client_id,
        }
