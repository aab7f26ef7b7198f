"""Authentication + RBAC.

Behavioral reference: upstream NornicDB pkg/auth/auth.go —
roles admin/editor/viewer/none (:160-163), permissions read/write/create/
delete/admin/user_manage (:171-176), bcrypt passwords (here: scrypt — no
external deps), users persisted as nodes in the system DB (:634-747), JWT
issue/validate/logout (:970, :1131), account lockout, audit event hook
(:619).

JWT is HS256 implemented with hmac/hashlib (no external jwt dependency).

The port's copy of ``nornicdb_tpu/auth/auth.py``.
"""

from __future__ import annotations

import base64
import logging
import hashlib
import hmac
import json
import os
import re
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.errors import AuthError, NotFoundError
from nornicdb_tpu_torch.storage.types import Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import count_error as _count_error

logger = logging.getLogger(__name__)

# roles (ref: auth.go:160-163)
ROLE_ADMIN = "admin"
ROLE_EDITOR = "editor"
ROLE_VIEWER = "viewer"
ROLE_NONE = "none"

# permissions (ref: auth.go:171-176)
PERM_READ = "read"
PERM_WRITE = "write"
PERM_CREATE = "create"
PERM_DELETE = "delete"
PERM_ADMIN = "admin"
PERM_USER_MANAGE = "user_manage"

ROLE_PERMISSIONS = {
    ROLE_ADMIN: {
        PERM_READ, PERM_WRITE, PERM_CREATE, PERM_DELETE, PERM_ADMIN,
        PERM_USER_MANAGE,
    },
    ROLE_EDITOR: {PERM_READ, PERM_WRITE, PERM_CREATE, PERM_DELETE},
    ROLE_VIEWER: {PERM_READ},
    ROLE_NONE: set(),
}

_USER_LABEL = "_User"


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    salt = salt or secrets.token_bytes(16)
    digest = hashlib.scrypt(
        password.encode(), salt=salt, n=2**14, r=8, p=1, dklen=32
    )
    return f"scrypt${_b64(salt)}${_b64(digest)}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, salt_s, digest_s = stored.split("$")
        if scheme != "scrypt":
            return False
        salt, digest = _unb64(salt_s), _unb64(digest_s)
        got = hashlib.scrypt(
            password.encode(), salt=salt, n=2**14, r=8, p=1, dklen=32
        )
        return hmac.compare_digest(got, digest)
    except (ValueError, TypeError):
        # malformed stored hash (wrong field count, bad base64, bad
        # scrypt params): treat as a non-match, never an auth crash
        return False


@dataclass
class User:
    username: str
    role: str = ROLE_VIEWER
    password_hash: str = ""
    created_at: float = field(default_factory=time.time)
    disabled: bool = False
    failed_attempts: int = 0
    locked_until: float = 0.0


@dataclass
class AuthConfig:
    token_ttl: float = 24 * 3600.0
    lockout_threshold: int = 5  # (ref: account lockout)
    lockout_duration: float = 300.0
    secret: Optional[str] = None


class Authenticator:
    """(ref: auth.Authenticator auth.go:362; NewAuthenticator :582)"""

    def __init__(
        self,
        system_storage: Engine,
        config: Optional[AuthConfig] = None,
        audit_hook: Optional[Callable[[str, dict], None]] = None,
    ):
        self.storage = system_storage
        self.config = config or AuthConfig()
        self.secret = (self.config.secret or secrets.token_hex(32)).encode()
        self.audit_hook = audit_hook
        self._lock = threading.RLock()
        self._revoked: set[str] = set()

    # -- audit ------------------------------------------------------------------
    def _audit(self, event: str, detail: dict) -> None:
        """(ref: audit event hook auth.go:619)"""
        if self.audit_hook is not None:
            try:
                self.audit_hook(event, detail)
            except Exception:
                logger.exception("audit hook failed for event %s", event)
                _count_error("auth")

    # -- user management (users as system-DB nodes, ref: auth.go:634-747) ------
    def _user_node_id(self, username: str) -> str:
        return f"user-{username}"

    _USERNAME_RE = re.compile(r"^[A-Za-z0-9._@-]{1,64}$")

    def create_user(
        self, username: str, password: str, role: str = ROLE_VIEWER
    ) -> User:
        if role not in ROLE_PERMISSIONS:
            raise AuthError(f"unknown role {role}")
        if not self._USERNAME_RE.match(username):
            raise AuthError(
                "invalid username (allowed: letters, digits, . _ @ -, max 64)"
            )
        user = User(username=username, role=role, password_hash=hash_password(password))
        node = Node(
            id=self._user_node_id(username),
            labels=[_USER_LABEL],
            properties={
                "username": username,
                "role": role,
                "password_hash": user.password_hash,
                "created_at": user.created_at,
                "disabled": False,
            },
        )
        self.storage.create_node(node)
        self._audit("user_created", {"username": username, "role": role})
        return user

    def get_user(self, username: str) -> User:
        try:
            n = self.storage.get_node(self._user_node_id(username))
        except NotFoundError:
            raise AuthError(f"user {username} not found")
        p = n.properties
        return User(
            username=p["username"],
            role=p.get("role", ROLE_VIEWER),
            password_hash=p.get("password_hash", ""),
            created_at=p.get("created_at", 0.0),
            disabled=p.get("disabled", False),
            failed_attempts=p.get("failed_attempts", 0),
            locked_until=p.get("locked_until", 0.0),
        )

    def _save_user(self, user: User) -> None:
        n = self.storage.get_node(self._user_node_id(user.username))
        n.properties.update(
            {
                "role": user.role,
                "password_hash": user.password_hash,
                "disabled": user.disabled,
                "failed_attempts": user.failed_attempts,
                "locked_until": user.locked_until,
            }
        )
        self.storage.update_node(n)

    def list_users(self) -> list[User]:
        out = []
        for n in self.storage.get_nodes_by_label(_USER_LABEL):
            out.append(
                User(
                    username=n.properties["username"],
                    role=n.properties.get("role", ROLE_VIEWER),
                    created_at=n.properties.get("created_at", 0.0),
                    disabled=n.properties.get("disabled", False),
                )
            )
        return sorted(out, key=lambda u: u.username)

    def delete_user(self, username: str) -> None:
        try:
            self.storage.delete_node(self._user_node_id(username))
            self._audit("user_deleted", {"username": username})
        except NotFoundError:
            raise AuthError(f"user {username} not found")

    def set_password(self, username: str, password: str) -> None:
        user = self.get_user(username)
        user.password_hash = hash_password(password)
        self._save_user(user)
        self._audit("password_changed", {"username": username})

    def set_disabled(self, username: str, disabled: bool) -> None:
        """(ref: DisableUser/EnableUser, server_auth.go handleUserByID PUT)"""
        user = self.get_user(username)
        user.disabled = disabled
        self._save_user(user)
        self._audit(
            "user_disabled" if disabled else "user_enabled",
            {"username": username},
        )

    def set_role(self, username: str, role: str) -> None:
        if role not in ROLE_PERMISSIONS:
            raise AuthError(f"unknown role {role}")
        user = self.get_user(username)
        user.role = role
        self._save_user(user)
        self._audit("role_changed", {"username": username, "role": role})

    # -- authentication -----------------------------------------------------------
    def check_password(self, username: str, password: str) -> bool:
        """Full login-semantics check for protocol authentication (Bolt,
        Qdrant gRPC): enforces disabled accounts, lockout counters, and
        audit events exactly like authenticate()."""
        try:
            return self.authenticate(username, password) is not None
        except AuthError:
            return False

    def verify_current_password(self, username: str, password: str) -> bool:
        """Verification for password-change flows: no token minting and no
        login_ok/login_failed events, but failed attempts DO count toward
        the account lockout and are audited — otherwise a hijacked session
        could brute-force the current password unthrottled through
        POST /auth/password while authenticate()'s lockout never engages."""
        # audit events collected under the lock, emitted after release: the
        # hook is externally supplied code (nornlint NL-LK03) — an audit
        # sink that logged back through this Authenticator would deadlock,
        # and a slow sink would serialize every login behind it
        events: list[tuple[str, dict]] = []
        try:
            with self._lock:
                try:
                    user = self.get_user(username)
                except AuthError:
                    return False
                now = time.time()
                if user.locked_until > now:
                    events.append((
                        "password_verify_rejected",
                        {"username": username, "reason": "locked"},
                    ))
                    return False
                if not verify_password(password, user.password_hash):
                    user.failed_attempts += 1
                    if user.failed_attempts >= self.config.lockout_threshold:
                        user.locked_until = now + self.config.lockout_duration
                        user.failed_attempts = 0
                    self._save_user(user)
                    events.append(
                        ("password_verify_failed", {"username": username}))
                    return False
                if user.failed_attempts:
                    user.failed_attempts = 0
                    self._save_user(user)
                return True
        finally:
            for event, detail in events:
                self._audit(event, detail)

    def authenticate(self, username: str, password: str) -> str:
        """Returns a JWT on success (ref: Authenticate auth.go:970)."""
        # same deferred-audit contract as verify_current_password: the hook
        # never runs under self._lock
        events: list[tuple[str, dict]] = []
        try:
            with self._lock:
                user = self.get_user(username)
                now = time.time()
                if user.disabled:
                    events.append(("login_rejected",
                                   {"username": username, "reason": "disabled"}))
                    raise AuthError("account disabled")
                if user.locked_until > now:
                    events.append(("login_rejected",
                                   {"username": username, "reason": "locked"}))
                    raise AuthError("account locked")
                if not verify_password(password, user.password_hash):
                    user.failed_attempts += 1
                    if user.failed_attempts >= self.config.lockout_threshold:
                        user.locked_until = now + self.config.lockout_duration
                        user.failed_attempts = 0
                    self._save_user(user)
                    events.append(("login_failed", {"username": username}))
                    raise AuthError("invalid credentials")
                if user.failed_attempts:
                    user.failed_attempts = 0
                    self._save_user(user)
        finally:
            for event, detail in events:
                self._audit(event, detail)
        token = self.issue_token(username, user.role)
        self._audit("login_ok", {"username": username})
        return token

    # -- JWT ---------------------------------------------------------------------
    def issue_token(
        self, username: str, role: str, ttl: Optional[float] = None
    ) -> str:
        header = {"alg": "HS256", "typ": "JWT"}
        now = int(time.time())
        payload = {
            "sub": username,
            "role": role,
            "iat": now,
            "exp": now + int(ttl if ttl is not None else self.config.token_ttl),
            "jti": secrets.token_hex(8),
        }
        h = _b64(json.dumps(header, separators=(",", ":")).encode())
        p = _b64(json.dumps(payload, separators=(",", ":")).encode())
        sig = hmac.new(self.secret, f"{h}.{p}".encode(), hashlib.sha256).digest()
        return f"{h}.{p}.{_b64(sig)}"

    def validate_token(self, token: str) -> Optional[dict[str, Any]]:
        """(ref: ValidateToken auth.go:1131)"""
        try:
            h, p, s = token.split(".")
            expected = hmac.new(self.secret, f"{h}.{p}".encode(), hashlib.sha256).digest()
            if not hmac.compare_digest(expected, _unb64(s)):
                return None
            payload = json.loads(_unb64(p))
            if payload.get("exp", 0) < time.time():
                return None
            if payload.get("jti") in self._revoked:
                return None
            return payload
        except (ValueError, TypeError, KeyError):
            # malformed token (field count, base64, JSON, digest types):
            # invalid credential, not an error path worth logging
            return None

    def logout(self, token: str) -> None:
        payload = self.validate_token(token)
        if payload and "jti" in payload:
            with self._lock:
                self._revoked.add(payload["jti"])
            self._audit("logout", {"username": payload.get("sub")})

    # -- authorization ---------------------------------------------------------------
    def has_permission(self, role: str, permission: str) -> bool:
        return permission in ROLE_PERMISSIONS.get(role, set())

    def authorize(self, token: str, permission: str) -> dict[str, Any]:
        payload = self.validate_token(token)
        if payload is None:
            raise AuthError("invalid or expired token")
        # cut off live sessions of disabled accounts: a still-valid JWT for
        # a user the admin has since disabled must stop authorizing (API
        # tokens whose subject isn't a stored user are unaffected)
        try:
            user = self.get_user(payload.get("sub", ""))
        except AuthError:
            user = None
        if user is not None and user.disabled:
            raise AuthError("account disabled")
        if not self.has_permission(payload.get("role", ROLE_NONE), permission):
            raise AuthError(f"permission {permission} denied")
        return payload
