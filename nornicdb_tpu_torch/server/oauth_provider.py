"""Standalone OAuth 2.0 test provider for integration testing: the port's
copy of ``nornicdb_tpu/server/oauth_provider.py`` (``http.server`` only,
no device work).

Behavioral reference: the upstream NornicDB cmd/oauth-provider (650 LoC Go
binary) — a minimal RFC 6749 authorization-code provider with a consent
form, token exchange, userinfo, discovery metadata, and three
pre-configured test users, used to exercise NornicDB's OAuth integration
locally with zero external dependencies. Run via
`nornicdb oauth-provider [--port N]` or embed OAuthTestProvider in tests.

Endpoints (same paths as the reference):
  GET  /oauth2/v1/authorize          consent form (response_type=code)
  POST /oauth2/v1/authorize/consent  user picks a test identity -> 302 code
  POST /oauth2/v1/token              authorization_code -> access token
  GET  /oauth2/v1/userinfo           Bearer token -> profile JSON
  GET  /.well-known/oauth-authorization-server  discovery metadata
  GET  /health                       {status, users}
"""

from __future__ import annotations

import json
import secrets
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlencode, urlparse

CODE_TTL_S = 120.0
TOKEN_TTL_S = 3600.0


@dataclass
class TestUser:
    sub: str
    email: str
    preferred_username: str
    roles: list[str]
    password: str


# the reference's three pre-configured identities (cmd/oauth-provider README)
DEFAULT_USERS = [
    TestUser("user-001", "admin@localhost", "admin",
             ["admin", "developer"], "admin123"),
    TestUser("user-002", "developer@localhost", "developer",
             ["developer"], "dev123"),
    TestUser("user-003", "viewer@localhost", "viewer",
             ["viewer"], "view123"),
]


@dataclass
class _Grant:
    user: TestUser
    redirect_uri: str
    expires: float
    scope: str = ""


_CONSENT_HTML = """<!DOCTYPE html>
<html><head><title>OAuth Test Provider</title>
<style>body{{font:14px sans-serif;max-width:420px;margin:60px auto}}
button{{display:block;width:100%;margin:6px 0;padding:10px}}</style></head>
<body><h2>Sign in as a test user</h2>
<p>client: <code>{client_id}</code> &rarr; <code>{redirect_uri}</code></p>
<form method="POST" action="/oauth2/v1/authorize/consent">
<input type="hidden" name="rid" value="{rid}">
{buttons}
</form></body></html>
"""


class OAuthTestProvider:
    """In-memory OAuth 2.0 provider (threaded HTTP server)."""

    def __init__(self, port: int = 0, client_id: str = "nornicdb-local-test",
                 client_secret: str = "local-test-secret-123",
                 issuer: Optional[str] = None,
                 users: Optional[list[TestUser]] = None):
        self.client_id = client_id
        self.client_secret = client_secret
        self.users = list(users) if users is not None else list(DEFAULT_USERS)
        self._codes: dict[str, _Grant] = {}
        self._tokens: dict[str, _Grant] = {}
        # authorize requests awaiting consent, keyed by one-time request id:
        # the consent POST carries only the rid, so redirect_uri/state/scope
        # are bound server-side to the validated /authorize request and a
        # direct POST cannot mint a code for an arbitrary redirect_uri
        self._pending: dict[str, dict] = {}
        self._lock = threading.Lock()
        provider = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status: int, body, content_type="application/json",
                      headers=()):
                data = (json.dumps(body).encode()
                        if not isinstance(body, (bytes, str))
                        else body.encode() if isinstance(body, str) else body)
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/health":
                    self._send(200, {"status": "ok",
                                     "users": len(provider.users)})
                elif u.path == "/.well-known/oauth-authorization-server":
                    self._send(200, provider.discovery())
                elif u.path == "/oauth2/v1/authorize":
                    provider._handle_authorize(self, parse_qs(u.query))
                elif u.path == "/oauth2/v1/userinfo":
                    provider._handle_userinfo(self)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length).decode() if length else ""
                form = {k: v[0] for k, v in parse_qs(body).items()}
                u = urlparse(self.path)
                if u.path == "/oauth2/v1/authorize/consent":
                    provider._handle_consent(self, form)
                elif u.path == "/oauth2/v1/token":
                    provider._handle_token(self, form)
                else:
                    self._send(404, {"error": "not found"})

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_port
        self.issuer = issuer or f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "OAuthTestProvider":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="oauth-test-provider")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- metadata ----------------------------------------------------------
    def discovery(self) -> dict:
        return {
            "issuer": self.issuer,
            "authorization_endpoint": f"{self.issuer}/oauth2/v1/authorize",
            "token_endpoint": f"{self.issuer}/oauth2/v1/token",
            "userinfo_endpoint": f"{self.issuer}/oauth2/v1/userinfo",
            "response_types_supported": ["code"],
            "grant_types_supported": ["authorization_code"],
            "token_endpoint_auth_methods_supported": [
                "client_secret_post", "client_secret_basic"],
        }

    # -- flows -------------------------------------------------------------
    def _handle_authorize(self, h, q: dict) -> None:
        if (q.get("response_type") or [""])[0] != "code":
            h._send(400, {"error": "unsupported_response_type"})
            return
        if (q.get("client_id") or [""])[0] != self.client_id:
            h._send(400, {"error": "invalid_client"})
            return
        redirect_uri = (q.get("redirect_uri") or [""])[0]
        if not redirect_uri:
            h._send(400, {"error": "invalid_request",
                          "error_description": "redirect_uri required"})
            return
        import html as _html

        esc = lambda s: _html.escape(str(s), quote=True)  # noqa: E731
        buttons = "".join(
            f'<button name="username" value="{esc(u.preferred_username)}">'
            f"{esc(u.preferred_username)} — {esc(u.email)} "
            f"({esc(', '.join(u.roles))})</button>"
            for u in self.users
        )
        rid = secrets.token_urlsafe(16)
        with self._lock:
            # sweep expired entries so abandoned authorize requests can't
            # grow the dict without bound in a long-lived process
            now = time.time()
            for stale in [r for r, p in self._pending.items()
                          if p["expires"] < now]:
                del self._pending[stale]
            self._pending[rid] = {
                "redirect_uri": redirect_uri,
                "state": (q.get("state") or [""])[0],
                "scope": (q.get("scope") or [""])[0],
                "expires": time.time() + CODE_TTL_S,
            }
        # query-derived values reflected into the page are escaped; the
        # consent form itself carries only the opaque one-time rid
        h._send(200, _CONSENT_HTML.format(
            client_id=esc(self.client_id),
            redirect_uri=esc(redirect_uri),
            rid=esc(rid),
            buttons=buttons,
        ), content_type="text/html; charset=utf-8")

    def _handle_consent(self, h, form: dict) -> None:
        user = next(
            (u for u in self.users
             if u.preferred_username == form.get("username")),
            None,
        )
        with self._lock:
            pending = self._pending.pop(form.get("rid", ""), None)
        if user is None or pending is None or pending["expires"] < time.time():
            h._send(400, {"error": "invalid_request"})
            return
        redirect_uri = pending["redirect_uri"]
        code = secrets.token_urlsafe(24)
        with self._lock:
            self._codes[code] = _Grant(
                user, redirect_uri, time.time() + CODE_TTL_S,
                pending["scope"])
        # urlencode: state may contain '&', '#', spaces, or CR/LF — raw
        # interpolation would corrupt the redirect or inject headers
        params = {"code": code}
        if pending["state"]:
            params["state"] = pending["state"]
        sep = "&" if "?" in redirect_uri else "?"
        target = f"{redirect_uri}{sep}{urlencode(params)}"
        h._send(302, b"", headers=[("Location", target)])

    def _client_ok(self, h, form: dict) -> bool:
        cid = form.get("client_id")
        secret = form.get("client_secret")
        if cid is None:
            auth = h.headers.get("Authorization", "")
            if auth.startswith("Basic "):
                import base64

                try:
                    cid, _, secret = base64.b64decode(
                        auth[6:]).decode().partition(":")
                except (ValueError, UnicodeDecodeError):
                    return False  # malformed base64: not authenticated
        return cid == self.client_id and secret == self.client_secret

    def _handle_token(self, h, form: dict) -> None:
        if form.get("grant_type") != "authorization_code":
            h._send(400, {"error": "unsupported_grant_type"})
            return
        if not self._client_ok(h, form):
            h._send(401, {"error": "invalid_client"})
            return
        with self._lock:
            grant = self._codes.pop(form.get("code", ""), None)
        if grant is None or grant.expires < time.time():
            h._send(400, {"error": "invalid_grant"})
            return
        if form.get("redirect_uri") and form["redirect_uri"] != grant.redirect_uri:
            h._send(400, {"error": "invalid_grant",
                          "error_description": "redirect_uri mismatch"})
            return
        token = secrets.token_urlsafe(32)
        with self._lock:
            self._tokens[token] = _Grant(
                grant.user, grant.redirect_uri,
                time.time() + TOKEN_TTL_S, grant.scope)
        h._send(200, {
            "access_token": token,
            "token_type": "Bearer",
            "expires_in": int(TOKEN_TTL_S),
            "scope": grant.scope,
        })

    def _handle_userinfo(self, h) -> None:
        auth = h.headers.get("Authorization", "")
        token = auth[7:] if auth.startswith("Bearer ") else ""
        with self._lock:
            grant = self._tokens.get(token)
        if grant is None or grant.expires < time.time():
            h._send(401, {"error": "invalid_token"})
            return
        u = grant.user
        h._send(200, {
            "sub": u.sub,
            "email": u.email,
            "preferred_username": u.preferred_username,
            "roles": u.roles,
        })


def main(port: int = 8888, client_id: str = "nornicdb-local-test",
         client_secret: str = "local-test-secret-123") -> int:
    provider = OAuthTestProvider(port=port, client_id=client_id,
                                 client_secret=client_secret)
    provider.start()
    print(f"oauth test provider listening on {provider.issuer}")
    print(f"  client_id={client_id}")
    print(f"  users: " + ", ".join(
        u.preferred_username for u in provider.users))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        provider.stop()
    return 0
