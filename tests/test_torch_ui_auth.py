"""Web console auth flow: login cookie sessions, /auth/me, user admin,
password change, API tokens, SPA deep links.

Behavioral reference: upstream NornicDB ui/src/pages/{Login,AdminUsers,
Security}.tsx + pkg/server/server_auth.go (handleToken :19,
handleAuthConfig :215, handleMe :368, handleUsers :549, handleUserByID,
handleChangePassword, handleGenerateAPIToken) and the SPA deep-link
serving in server_router.go:59-64.

The port's copy of ``tests/test_ui_auth.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.auth import Authenticator, ROLE_ADMIN, ROLE_VIEWER
from nornicdb_tpu_torch.server.http import HttpServer
from nornicdb_tpu_torch.storage import MemoryEngine


def _req(port, path, method="GET", body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=data,
        method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    resp = urllib.request.urlopen(req)
    raw = resp.read().decode()
    try:
        parsed = json.loads(raw)
    except json.JSONDecodeError:
        parsed = raw
    return resp.status, parsed, resp.headers


@pytest.fixture()
def auth_server():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    auth = Authenticator(MemoryEngine())
    auth.create_user("admin", "adminpw", ROLE_ADMIN)
    auth.create_user("bob", "bobpw", ROLE_VIEWER)
    server = HttpServer(db, port=0, authenticator=auth, auth_required=True)
    server.start()
    yield server, auth
    server.stop()
    db.close()


@pytest.fixture()
def open_server():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    server = HttpServer(db, port=0)
    server.start()
    yield server
    server.stop()
    db.close()


def _login(server, username, password):
    """POST /auth/token; returns (token, cookie header value)."""
    status, body, headers = _req(
        server.port, "/auth/token", "POST",
        {"username": username, "password": password},
    )
    assert status == 200
    cookie = headers.get("Set-Cookie", "")
    assert cookie.startswith("nornicdb_token=")
    assert "HttpOnly" in cookie
    return body["access_token"], cookie.split(";")[0]


class TestAuthConfigAndMe:
    def test_config_auth_off(self, open_server):
        status, body, _ = _req(open_server.port, "/auth/config")
        assert status == 200
        assert body["securityEnabled"] is False
        assert body["oauthProviders"] == []

    def test_config_auth_on(self, auth_server):
        server, _ = auth_server
        _, body, _ = _req(server.port, "/auth/config")
        assert body["securityEnabled"] is True

    def test_me_anonymous_when_auth_off(self, open_server):
        _, body, _ = _req(open_server.port, "/auth/me")
        assert body["username"] == "anonymous"
        assert body["roles"] == ["admin"]

    def test_me_requires_auth(self, auth_server):
        server, _ = auth_server
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/me")
        assert e.value.code == 401

    def test_me_with_cookie_session(self, auth_server):
        server, _ = auth_server
        _, cookie = _login(server, "bob", "bobpw")
        _, body, _ = _req(server.port, "/auth/me", headers={"Cookie": cookie})
        assert body["username"] == "bob"
        assert body["roles"] == ["viewer"]

    def test_bad_login_rejected(self, auth_server):
        server, _ = auth_server
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/token", "POST",
                 {"username": "bob", "password": "wrong"})
        assert e.value.code == 401

    def test_unsupported_grant_type(self, auth_server):
        server, _ = auth_server
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/token", "POST",
                 {"username": "bob", "password": "bobpw",
                  "grant_type": "client_credentials"})
        assert e.value.code == 400

    def test_logout_clears_cookie_and_revokes(self, auth_server):
        server, _ = auth_server
        token, cookie = _login(server, "bob", "bobpw")
        status, _, headers = _req(
            server.port, "/auth/logout", "POST", {},
            headers={"Cookie": cookie},
        )
        assert status == 200
        assert "Max-Age=0" in headers.get("Set-Cookie", "")
        # revoked token no longer works
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/me", headers={"Cookie": cookie})
        assert e.value.code == 401


class TestUserAdmin:
    def test_list_users_requires_user_manage(self, auth_server):
        server, _ = auth_server
        _, bob_cookie = _login(server, "bob", "bobpw")
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/users", headers={"Cookie": bob_cookie})
        assert e.value.code == 401

    def test_user_crud_lifecycle(self, auth_server):
        server, auth = auth_server
        _, admin = _login(server, "admin", "adminpw")
        hdr = {"Cookie": admin}

        # create
        status, body, _ = _req(
            server.port, "/auth/users", "POST",
            {"username": "carol", "password": "carolpw", "roles": ["editor"]},
            headers=hdr,
        )
        assert status == 201 and body["roles"] == ["editor"]

        # list includes the new user
        _, users, _ = _req(server.port, "/auth/users", headers=hdr)
        assert any(u["username"] == "carol" for u in users)

        # get single
        _, one, _ = _req(server.port, "/auth/users/carol", headers=hdr)
        assert one["roles"] == ["editor"]

        # role change via PUT
        _req(server.port, "/auth/users/carol", "PUT",
             {"roles": ["admin"]}, headers=hdr)
        assert auth.get_user("carol").role == "admin"

        # disable blocks login
        _req(server.port, "/auth/users/carol", "PUT",
             {"disabled": True}, headers=hdr)
        with pytest.raises(urllib.error.HTTPError):
            _req(server.port, "/auth/token", "POST",
                 {"username": "carol", "password": "carolpw"})
        # re-enable restores it
        _req(server.port, "/auth/users/carol", "PUT",
             {"disabled": False}, headers=hdr)
        _login(server, "carol", "carolpw")

        # delete
        status, _, _ = _req(server.port, "/auth/users/carol", "DELETE",
                            headers=hdr)
        assert status == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/users/carol", headers=hdr)
        assert e.value.code == 404

    def test_disable_cuts_off_live_sessions(self, auth_server):
        # a still-valid JWT must stop authorizing once the account is
        # disabled (ref: compromised-account lockout)
        server, _ = auth_server
        _, bob_cookie = _login(server, "bob", "bobpw")
        _, admin = _login(server, "admin", "adminpw")
        _req(server.port, "/auth/users/bob", "PUT", {"disabled": True},
             headers={"Cookie": admin})
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/me", headers={"Cookie": bob_cookie})
        assert e.value.code == 401

    def test_create_user_rejects_bad_usernames(self, auth_server):
        server, _ = auth_server
        _, admin = _login(server, "admin", "adminpw")
        for bad in ("a b", "x'); alert(1);//", "<script>", "a" * 65):
            with pytest.raises(urllib.error.HTTPError) as e:
                _req(server.port, "/auth/users", "POST",
                     {"username": bad, "password": "pw"},
                     headers={"Cookie": admin})
            assert e.value.code == 400

    def test_put_unknown_role_is_400(self, auth_server):
        server, _ = auth_server
        _, admin = _login(server, "admin", "adminpw")
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/users/bob", "PUT",
                 {"roles": ["superuser"]}, headers={"Cookie": admin})
        assert e.value.code == 400

    def test_percent_encoded_username_roundtrip(self, auth_server):
        server, _ = auth_server
        _, admin = _login(server, "admin", "adminpw")
        hdr = {"Cookie": admin}
        _req(server.port, "/auth/users", "POST",
             {"username": "svc@nornic.io", "password": "pw"}, headers=hdr)
        # %40 must decode back to @ for lookup/update/delete
        _, one, _ = _req(server.port, "/auth/users/svc%40nornic.io",
                         headers=hdr)
        assert one["username"] == "svc@nornic.io"
        status, _, _ = _req(server.port, "/auth/users/svc%40nornic.io",
                            "DELETE", headers=hdr)
        assert status == 200

    def test_api_token_no_longer_races_session_ttl(self, auth_server):
        # issuing an API token must not change interactive session TTLs
        server, auth = auth_server
        before = auth.config.token_ttl
        _, admin = _login(server, "admin", "adminpw")
        _req(server.port, "/auth/api-token", "POST",
             {"subject": "x", "expires_in": 31536000},
             headers={"Cookie": admin})
        assert auth.config.token_ttl == before

    def test_delete_unknown_user_404(self, auth_server):
        server, _ = auth_server
        _, admin = _login(server, "admin", "adminpw")
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/users/ghost", "DELETE",
                 headers={"Cookie": admin})
        assert e.value.code == 404


class TestSecurityPage:
    def test_change_password_verifies_old(self, auth_server):
        server, _ = auth_server
        _, cookie = _login(server, "bob", "bobpw")
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/password", "POST",
                 {"old_password": "wrong", "new_password": "newpw"},
                 headers={"Cookie": cookie})
        assert e.value.code == 401
        status, _, _ = _req(
            server.port, "/auth/password", "POST",
            {"old_password": "bobpw", "new_password": "newpw"},
            headers={"Cookie": cookie},
        )
        assert status == 200
        _login(server, "bob", "newpw")  # new password works

    def test_change_password_bruteforce_locks_out(self, auth_server):
        """Advisor round-2: failed old-password verifications must count
        toward the account lockout (unthrottled brute-forcing through
        POST /auth/password from a hijacked session)."""
        server, auth = auth_server
        _, cookie = _login(server, "bob", "bobpw")
        for _ in range(auth.config.lockout_threshold):
            with pytest.raises(urllib.error.HTTPError) as e:
                _req(server.port, "/auth/password", "POST",
                     {"old_password": "wrong", "new_password": "x"},
                     headers={"Cookie": cookie})
            assert e.value.code == 401
        # account now locked: even the CORRECT old password is refused
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/password", "POST",
                 {"old_password": "bobpw", "new_password": "newpw"},
                 headers={"Cookie": cookie})
        assert e.value.code == 401
        # and fresh logins are refused for the lockout duration
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/token", "POST",
                 {"username": "bob", "password": "bobpw"})
        assert e.value.code in (401, 423)

    def test_session_cookie_attributes(self, auth_server):
        """Cookie Max-Age tracks the JWT TTL; Secure only when configured."""
        server, auth = auth_server
        _, _, headers = _req(
            server.port, "/auth/token", "POST",
            {"username": "bob", "password": "bobpw"},
        )
        cookie = headers.get("Set-Cookie", "")
        assert f"Max-Age={int(auth.config.token_ttl)}" in cookie
        assert "Secure" not in cookie  # plain-HTTP test server
        server.cookie_secure = True
        _, _, headers = _req(
            server.port, "/auth/token", "POST",
            {"username": "bob", "password": "bobpw"},
        )
        assert "Secure" in headers.get("Set-Cookie", "")

    def test_api_token_admin_only(self, auth_server):
        server, _ = auth_server
        _, bob_cookie = _login(server, "bob", "bobpw")
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "/auth/api-token", "POST",
                 {"subject": "x"}, headers={"Cookie": bob_cookie})
        assert e.value.code == 401

    def test_api_token_usable_as_bearer(self, auth_server):
        server, _ = auth_server
        _, admin = _login(server, "admin", "adminpw")
        _, body, _ = _req(
            server.port, "/auth/api-token", "POST",
            {"subject": "my-mcp-server", "expires_in": 3600},
            headers={"Cookie": admin},
        )
        assert body["subject"] == "my-mcp-server"
        # the token authenticates API calls with the issuing role
        status, me, _ = _req(
            server.port, "/auth/me",
            headers={"Authorization": f"Bearer {body['token']}"},
        )
        assert status == 200
        assert me["username"] == "my-mcp-server"
        assert me["roles"] == ["admin"]


class TestSpaServing:
    def test_deep_links_serve_spa(self, open_server):
        for path in ("/", "/login", "/security", "/admin"):
            status, body, headers = _req(open_server.port, path)
            assert status == 200
            assert "text/html" in headers.get("Content-Type", "")
            assert "NornicDB-TPU" in body

    def test_spa_has_all_views(self, open_server):
        _, body, _ = _req(open_server.port, "/")
        for marker in ("login-view", "console-view", "admin-view",
                       "security-view", "/auth/token", "/auth/users",
                       "/auth/api-token"):
            assert marker in body

    def test_spa_has_browser_parity_affordances(self, open_server):
        """ref: ui/src/pages/Browser.tsx — query history, node edit/delete,
        DB switcher (VERDICT round-2 item 9)."""
        _, body, _ = _req(open_server.port, "/")
        for marker in ("nornic_query_history", "pushHistory", "clearHistory",
                       "renderHistory", "db-select", "SHOW DATABASES",
                       "switchDb", "editNode", "deleteNode",
                       "DETACH DELETE n", "SET n = $props"):
            assert marker in body

    def test_node_edit_delete_flow_via_tx_api(self, open_server):
        """The exact statements the console's edit/delete buttons issue."""
        port = open_server.port
        _, r, _ = _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{"statement":
                            "CREATE (n:UiEdit {k: 1}) RETURN n"}]})
        node = r["results"][0]["data"][0]["row"][0]
        assert node["labels"] == ["UiEdit"] and node["properties"] == {"k": 1}
        # edit: SET n = $props by id (what editNode() sends)
        _, r, _ = _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{
                "statement": "MATCH (n) WHERE id(n) = $id SET n = $props",
                "parameters": {"id": node["id"], "props": {"k": 2, "x": "y"}},
            }]})
        assert not r["errors"]
        _, r, _ = _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{"statement":
                            "MATCH (n:UiEdit) RETURN n.k, n.x"}]})
        assert r["results"][0]["data"][0]["row"] == [2, "y"]
        # delete: DETACH DELETE by id (what deleteNode() sends)
        _, r, _ = _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{
                "statement": "MATCH (n) WHERE id(n) = $id DETACH DELETE n",
                "parameters": {"id": node["id"]},
            }]})
        assert not r["errors"]
        _, r, _ = _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{"statement":
                            "MATCH (n:UiEdit) RETURN count(n)"}]})
        assert r["results"][0]["data"][0]["row"] == [0]

    def test_db_switcher_flow_via_tx_api(self, open_server):
        """SHOW DATABASES lists switchable DBs and /db/{name}/tx/commit
        routes to the named database (what switchDb() relies on)."""
        port = open_server.port
        _, r, _ = _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{"statement": "SHOW DATABASES"}]})
        res = r["results"][0]
        name_idx = res["columns"].index("name")
        names = [row["row"][name_idx] for row in res["data"]]
        assert "neo4j" in names and "system" in names
        # writes to the default DB are not visible via another DB route
        _req(port, "/db/neo4j/tx/commit", "POST", {
            "statements": [{"statement": "CREATE (:UiDbScope {v: 1})"}]})
        _, r, _ = _req(port, "/db/system/tx/commit", "POST", {
            "statements": [{"statement":
                            "MATCH (n:UiDbScope) RETURN count(n)"}]})
        assert r["results"][0]["data"][0]["row"] == [0]

    def test_headless_disables_ui(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        server = HttpServer(db, port=0, serve_ui=False)
        server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _req(server.port, "/login")
            assert e.value.code == 404
        finally:
            server.stop()
            db.close()
