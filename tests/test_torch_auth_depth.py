"""Authenticator unit depth (ref: pkg/auth/auth_test.go — role permission
matrix, lockout timing + release, disabled accounts, token TTL/tamper/
revocation, password lifecycle, audit event stream, user CRUD persistence
in the system DB).

The port's copy of ``tests/test_auth_depth.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
"""

import time

import pytest

from nornicdb_tpu_torch.auth import (
    ROLE_ADMIN,
    ROLE_EDITOR,
    ROLE_NONE,
    ROLE_VIEWER,
    Authenticator,
)
from nornicdb_tpu_torch.auth.auth import AuthConfig, hash_password, verify_password
from nornicdb_tpu_torch.errors import AuthError
from nornicdb_tpu_torch.storage import MemoryEngine


@pytest.fixture
def auth():
    events = []
    a = Authenticator(
        MemoryEngine(),
        config=AuthConfig(lockout_threshold=3, lockout_duration=0.4,
                          token_ttl=3600.0),
        audit_hook=lambda ev, d: events.append((ev, d)),
    )
    a.events = events
    return a


class TestPasswordHashing:
    def test_same_password_different_salt(self):
        h1, h2 = hash_password("pw"), hash_password("pw")
        assert h1 != h2
        assert verify_password("pw", h1) and verify_password("pw", h2)

    def test_verify_rejects_wrong_and_garbage(self):
        h = hash_password("pw")
        assert not verify_password("other", h)
        assert not verify_password("pw", "not-a-hash")
        assert not verify_password("pw", "")


class TestRolePermissionMatrix:
    """ref: role/permission matrix auth.go — admin ⊃ editor ⊃ viewer ⊃
    none, and the exact per-role sets."""

    @pytest.mark.parametrize("role,perm,allowed", [
        (ROLE_ADMIN, "read", True), (ROLE_ADMIN, "write", True),
        (ROLE_ADMIN, "delete", True), (ROLE_ADMIN, "admin", True),
        (ROLE_EDITOR, "read", True), (ROLE_EDITOR, "write", True),
        (ROLE_EDITOR, "delete", True), (ROLE_EDITOR, "admin", False),
        (ROLE_VIEWER, "read", True), (ROLE_VIEWER, "write", False),
        (ROLE_VIEWER, "delete", False), (ROLE_VIEWER, "admin", False),
        (ROLE_NONE, "read", False), (ROLE_NONE, "admin", False),
    ])
    def test_matrix(self, auth, role, perm, allowed):
        assert auth.has_permission(role, perm) is allowed

    def test_unknown_role_has_nothing(self, auth):
        assert not auth.has_permission("made-up", "read")

    def test_create_user_rejects_unknown_role(self, auth):
        with pytest.raises(Exception):
            auth.create_user("u", "pw", role="superuser")


class TestLockout:
    def test_locks_after_threshold_and_releases(self, auth):
        """ref: lockout flow — threshold failures lock, the right password
        during lockout still fails, the window expiring unlocks."""
        auth.create_user("alice", "right-pw")
        for _ in range(3):
            with pytest.raises(AuthError):
                auth.authenticate("alice", "wrong")
        with pytest.raises(AuthError, match="locked"):
            auth.authenticate("alice", "right-pw")
        time.sleep(0.45)
        assert auth.authenticate("alice", "right-pw")

    def test_success_resets_failed_counter(self, auth):
        auth.create_user("bob", "pw")
        for _ in range(2):
            with pytest.raises(AuthError):
                auth.authenticate("bob", "wrong")
        auth.authenticate("bob", "pw")  # resets the counter
        for _ in range(2):
            with pytest.raises(AuthError):
                auth.authenticate("bob", "wrong")
        assert auth.authenticate("bob", "pw")  # still not locked

    def test_password_verify_counts_toward_lockout(self, auth):
        """A hijacked session must not brute-force through the
        password-change endpoint unthrottled."""
        auth.create_user("carol", "pw")
        for _ in range(3):
            assert auth.verify_current_password("carol", "wrong") is False
        with pytest.raises(AuthError, match="locked"):
            auth.authenticate("carol", "pw")

    def test_disabled_account_rejected_with_right_password(self, auth):
        auth.create_user("dave", "pw")
        auth.set_disabled("dave", True)
        with pytest.raises(AuthError, match="disabled"):
            auth.authenticate("dave", "pw")
        auth.set_disabled("dave", False)
        assert auth.authenticate("dave", "pw")


class TestTokens:
    def test_token_carries_identity_and_role(self, auth):
        auth.create_user("erin", "pw", role=ROLE_EDITOR)
        payload = auth.validate_token(auth.authenticate("erin", "pw"))
        assert payload["sub"] == "erin"
        assert payload["role"] == ROLE_EDITOR

    def test_expired_token_rejected(self, auth):
        auth.create_user("frank", "pw")
        tok = auth.issue_token("frank", ROLE_VIEWER, ttl=-1.0)
        assert auth.validate_token(tok) is None

    def test_tampered_token_rejected(self, auth):
        auth.create_user("gina", "pw", role=ROLE_VIEWER)
        tok = auth.authenticate("gina", "pw")
        h, p, s = tok.split(".")
        # swap a payload byte (e.g. attempt role escalation)
        forged = f"{h}.{p[:-2] + ('AA' if p[-2:] != 'AA' else 'BB')}.{s}"
        assert auth.validate_token(forged) is None

    def test_logout_revokes_just_that_token(self, auth):
        auth.create_user("hank", "pw")
        t1 = auth.authenticate("hank", "pw")
        t2 = auth.authenticate("hank", "pw")
        auth.logout(t1)
        assert auth.validate_token(t1) is None
        assert auth.validate_token(t2) is not None

    def test_authorize_enforces_permission(self, auth):
        auth.create_user("ivy", "pw", role=ROLE_VIEWER)
        tok = auth.authenticate("ivy", "pw")
        assert auth.authorize(tok, "read")["sub"] == "ivy"
        with pytest.raises(AuthError):
            auth.authorize(tok, "write")

    def test_secret_isolation_between_instances(self, auth):
        """A token minted by one deployment must not validate on another
        with a different secret."""
        other = Authenticator(MemoryEngine())
        other.create_user("java", "pw")
        foreign = other.authenticate("java", "pw")
        assert auth.validate_token(foreign) is None


class TestUserLifecycle:
    def test_users_persist_in_system_storage(self, auth):
        auth.create_user("kate", "pw", role=ROLE_EDITOR)
        # a fresh Authenticator over the SAME storage sees the user
        rehydrated = Authenticator(auth.storage,
                                   config=AuthConfig(secret="s"))
        assert rehydrated.get_user("kate").role == ROLE_EDITOR

    def test_duplicate_create_rejected(self, auth):
        auth.create_user("liam", "pw")
        with pytest.raises(Exception):
            auth.create_user("liam", "pw2")

    def test_set_password_invalidates_old(self, auth):
        auth.create_user("mona", "old")
        auth.set_password("mona", "new")
        with pytest.raises(AuthError):
            auth.authenticate("mona", "old")
        assert auth.authenticate("mona", "new")

    def test_set_role_changes_permissions(self, auth):
        auth.create_user("nina", "pw", role=ROLE_VIEWER)
        auth.set_role("nina", ROLE_ADMIN)
        tok = auth.authenticate("nina", "pw")
        assert auth.authorize(tok, "admin")

    def test_delete_user_then_login_fails(self, auth):
        auth.create_user("omar", "pw")
        auth.delete_user("omar")
        with pytest.raises(AuthError):
            auth.authenticate("omar", "pw")
        assert "omar" not in [u.username for u in auth.list_users()]


class TestAuditTrail:
    def test_login_events_emitted(self, auth):
        auth.create_user("pia", "pw")
        auth.authenticate("pia", "pw")
        with pytest.raises(AuthError):
            auth.authenticate("pia", "wrong")
        kinds = [ev for ev, _ in auth.events]
        assert "login_ok" in kinds
        assert "login_failed" in kinds

    def test_lockout_rejection_audited(self, auth):
        auth.create_user("quentin", "pw")
        for _ in range(3):
            with pytest.raises(AuthError):
                auth.authenticate("quentin", "wrong")
        with pytest.raises(AuthError):
            auth.authenticate("quentin", "pw")
        assert ("login_rejected", {"username": "quentin",
                                   "reason": "locked"}) in auth.events

    def test_audit_hook_errors_never_break_auth(self, auth):
        def boom(ev, d):
            raise RuntimeError("audit sink down")

        auth.audit_hook = boom
        auth.create_user("rosa", "pw")
        assert auth.authenticate("rosa", "pw")  # hook failure swallowed
