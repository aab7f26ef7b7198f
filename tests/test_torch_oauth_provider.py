"""Standalone OAuth test provider (ref: cmd/oauth-provider, 650 LoC).

Covers the full RFC 6749 authorization-code flow end-to-end: discovery,
consent form, code issuance, token exchange (client_secret_post AND
client_secret_basic), userinfo, and the negative paths (wrong client,
replayed code, expired/invalid tokens, redirect_uri mismatch).

The port's copy of ``tests/test_oauth_provider.py``: the JAX cases with
only their imports changed, then ``python -m nornicdb_tpu_torch
oauth-provider`` as a process.
"""

import json
import urllib.error
import urllib.parse
import urllib.request

import pytest

from nornicdb_tpu_torch.server.oauth_provider import DEFAULT_USERS, OAuthTestProvider


@pytest.fixture(scope="module")
def provider():
    p = OAuthTestProvider(port=0).start()
    yield p
    p.stop()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    resp = urllib.request.urlopen(req, timeout=30)
    return resp.status, resp.read(), dict(resp.headers)


def _post_form(url, form, headers=None):
    data = urllib.parse.urlencode(form).encode()
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded",
                 **(headers or {})})

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(NoRedirect)
    try:
        resp = opener.open(req, timeout=30)
        return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _start_authorize(provider, redirect_uri, state="xyz", scope=""):
    """GET /authorize and pull the one-time rid out of the consent form."""
    q = urllib.parse.urlencode({
        "response_type": "code", "client_id": provider.client_id,
        "redirect_uri": redirect_uri, "state": state, "scope": scope})
    status, body, _ = _get(f"{provider.issuer}/oauth2/v1/authorize?{q}")
    assert status == 200
    import re

    m = re.search(r'name="rid" value="([^"]+)"', body.decode())
    assert m, "consent form must carry the request id"
    return m.group(1)


def _obtain_code(provider, redirect_uri="http://localhost:7474/cb",
                 username="admin", state="xyz"):
    rid = _start_authorize(provider, redirect_uri, state=state)
    status, _, headers = _post_form(
        f"{provider.issuer}/oauth2/v1/authorize/consent",
        {"username": username, "rid": rid})
    assert status == 302
    loc = urllib.parse.urlparse(headers["Location"])
    q = urllib.parse.parse_qs(loc.query)
    assert q["state"] == [state]
    return q["code"][0]


class TestDiscoveryAndHealth:
    def test_health(self, provider):
        status, body, _ = _get(f"{provider.issuer}/health")
        assert status == 200
        assert json.loads(body) == {"status": "ok",
                                    "users": len(DEFAULT_USERS)}

    def test_discovery_metadata(self, provider):
        _, body, _ = _get(
            f"{provider.issuer}/.well-known/oauth-authorization-server")
        meta = json.loads(body)
        assert meta["issuer"] == provider.issuer
        assert meta["authorization_endpoint"].endswith("/oauth2/v1/authorize")
        assert "authorization_code" in meta["grant_types_supported"]


class TestAuthorizationCodeFlow:
    def test_consent_form_lists_test_users(self, provider):
        q = urllib.parse.urlencode({
            "response_type": "code", "client_id": provider.client_id,
            "redirect_uri": "http://localhost:7474/cb", "state": "s1"})
        status, body, _ = _get(f"{provider.issuer}/oauth2/v1/authorize?{q}")
        assert status == 200
        page = body.decode()
        for u in DEFAULT_USERS:
            assert u.preferred_username in page

    def test_authorize_rejects_wrong_client(self, provider):
        q = urllib.parse.urlencode({
            "response_type": "code", "client_id": "evil",
            "redirect_uri": "http://localhost:7474/cb"})
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{provider.issuer}/oauth2/v1/authorize?{q}")
        assert e.value.code == 400

    def test_full_flow_post_auth(self, provider):
        code = _obtain_code(provider, username="developer")
        status, body, _ = _post_form(f"{provider.issuer}/oauth2/v1/token", {
            "grant_type": "authorization_code", "code": code,
            "redirect_uri": "http://localhost:7474/cb",
            "client_id": provider.client_id,
            "client_secret": provider.client_secret})
        assert status == 200
        tok = json.loads(body)
        assert tok["token_type"] == "Bearer"
        status, body, _ = _get(
            f"{provider.issuer}/oauth2/v1/userinfo",
            headers={"Authorization": f"Bearer {tok['access_token']}"})
        info = json.loads(body)
        assert info["preferred_username"] == "developer"
        assert info["roles"] == ["developer"]

    def test_full_flow_basic_auth(self, provider):
        import base64

        code = _obtain_code(provider, username="viewer")
        basic = base64.b64encode(
            f"{provider.client_id}:{provider.client_secret}".encode()
        ).decode()
        status, body, _ = _post_form(
            f"{provider.issuer}/oauth2/v1/token",
            {"grant_type": "authorization_code", "code": code,
             "redirect_uri": "http://localhost:7474/cb"},
            headers={"Authorization": f"Basic {basic}"})
        assert status == 200
        assert "access_token" in json.loads(body)

    def test_code_single_use(self, provider):
        code = _obtain_code(provider)
        form = {"grant_type": "authorization_code", "code": code,
                "redirect_uri": "http://localhost:7474/cb",
                "client_id": provider.client_id,
                "client_secret": provider.client_secret}
        assert _post_form(f"{provider.issuer}/oauth2/v1/token", form)[0] == 200
        status, body, _ = _post_form(f"{provider.issuer}/oauth2/v1/token", form)
        assert status == 400
        assert json.loads(body)["error"] == "invalid_grant"

    def test_token_rejects_bad_secret(self, provider):
        code = _obtain_code(provider)
        status, body, _ = _post_form(f"{provider.issuer}/oauth2/v1/token", {
            "grant_type": "authorization_code", "code": code,
            "redirect_uri": "http://localhost:7474/cb",
            "client_id": provider.client_id, "client_secret": "wrong"})
        assert status == 401

    def test_redirect_uri_mismatch_rejected(self, provider):
        code = _obtain_code(provider, redirect_uri="http://a/cb")
        status, body, _ = _post_form(f"{provider.issuer}/oauth2/v1/token", {
            "grant_type": "authorization_code", "code": code,
            "redirect_uri": "http://EVIL/cb",
            "client_id": provider.client_id,
            "client_secret": provider.client_secret})
        assert status == 400

    def test_consent_requires_bound_authorize_request(self, provider):
        """A direct consent POST (no rid, or a forged one) must not mint a
        code for an arbitrary redirect_uri (RFC 6749 binding)."""
        for form in (
            {"username": "admin", "redirect_uri": "http://evil/cb"},
            {"username": "admin", "rid": "forged-rid"},
        ):
            status, body, _ = _post_form(
                f"{provider.issuer}/oauth2/v1/authorize/consent", form)
            assert status == 400
            assert json.loads(body)["error"] == "invalid_request"

    def test_rid_single_use(self, provider):
        rid = _start_authorize(provider, "http://localhost:7474/cb")
        form = {"username": "admin", "rid": rid}
        url = f"{provider.issuer}/oauth2/v1/authorize/consent"
        assert _post_form(url, form)[0] == 302
        assert _post_form(url, form)[0] == 400

    def test_state_with_metacharacters_is_urlencoded(self, provider):
        """state containing &, #, spaces, CR/LF must round-trip intact and
        must not corrupt the redirect or inject headers."""
        evil_state = "a&b #c\r\nSet-Cookie: x=1"
        rid = _start_authorize(provider, "http://localhost:7474/cb",
                               state=evil_state)
        status, _, headers = _post_form(
            f"{provider.issuer}/oauth2/v1/authorize/consent",
            {"username": "admin", "rid": rid})
        assert status == 302
        loc = headers["Location"]
        assert "\r" not in loc and "\n" not in loc
        assert "Set-Cookie" not in headers or "x=1" not in headers.get(
            "Set-Cookie", "")
        q = urllib.parse.parse_qs(urllib.parse.urlparse(loc).query)
        assert q["state"] == [evil_state]

    def test_userinfo_rejects_bad_token(self, provider):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{provider.issuer}/oauth2/v1/userinfo",
                 headers={"Authorization": "Bearer nope"})
        assert e.value.code == 401


class TestCliWiring:
    def test_subcommand_registered(self):
        from nornicdb_tpu_torch.cli import main as cli_main

        with pytest.raises(SystemExit) as e:
            cli_main(["oauth-provider", "--help"])
        assert e.value.code == 0


class TestCliProcess:
    def test_python_m_oauth_provider_serves_then_stops(self):
        import os
        import signal
        import socket
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nornicdb_tpu_torch", "oauth-provider",
             "--port", str(port), "--client-id", "cid"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            line = proc.stdout.readline()
            assert f"http://127.0.0.1:{port}" in line, (
                line, proc.poll() is not None and proc.stderr.read())
            code, body, _ = _get(f"http://127.0.0.1:{port}/health")
            assert code == 200 and json.loads(body) == {
                "status": "ok", "users": len(DEFAULT_USERS)}
            code, body, _ = _get(f"http://127.0.0.1:{port}/.well-known/"
                                 "oauth-authorization-server")
            assert json.loads(body)["issuer"] == f"http://127.0.0.1:{port}"
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
