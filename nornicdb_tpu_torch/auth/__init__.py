"""Authentication + RBAC (ref: upstream NornicDB pkg/auth/)."""

from nornicdb_tpu_torch.auth.auth import (
    PERM_ADMIN,
    PERM_CREATE,
    PERM_DELETE,
    PERM_READ,
    PERM_USER_MANAGE,
    PERM_WRITE,
    ROLE_ADMIN,
    ROLE_EDITOR,
    ROLE_NONE,
    ROLE_PERMISSIONS,
    ROLE_VIEWER,
    AuthConfig,
    Authenticator,
    User,
    hash_password,
    verify_password,
)

__all__ = [
    "PERM_ADMIN", "PERM_CREATE", "PERM_DELETE", "PERM_READ",
    "PERM_USER_MANAGE", "PERM_WRITE", "ROLE_ADMIN", "ROLE_EDITOR",
    "ROLE_NONE", "ROLE_PERMISSIONS", "ROLE_VIEWER", "AuthConfig",
    "Authenticator", "User", "hash_password", "verify_password",
]
