"""HTTP server: Neo4j transaction API, search REST, admin, metrics, MCP.

Behavioral reference: upstream NornicDB pkg/server/server_router.go:53-240 —
/db/{name}/tx/commit (Neo4j HTTP tx API, server_db.go),
/nornicdb/search|similar|embed (server_nornicdb.go:236),
/auth/* endpoints, /admin/stats, /health, /status, /metrics (Prometheus
text, server_public.go:141-200), MCP mounting (pkg/mcp — 6 tools,
tools.go:63-332).

The port's copy of ``nornicdb_tpu/server/http.py``. Where it differs:

- ``DeviceUnavailable`` (the card is not serving; the port never answers
  from the host) is a 503 with ``Retry-After`` and ``"reason":
  "device_unavailable"``, on every route, a statement of the transaction
  API included.
- ``/graphql`` and ``/collections*`` (Qdrant REST) run on the DB's device:
  a GraphQL ``search`` / ``similar`` field and a collection search that
  meet a card that is not serving answer that 503 too, never a GraphQL
  error with a 200 and never a host answer. The Qdrant gRPC services
  (``qdrant_grpc.py``) share the ``/collections*`` registry.
- ``/admin/tpu/status`` reports ``torch.cuda`` and the device owner, and
  never initialises CUDA itself.
- A single process has no worker fleet (ROADMAP A6d): ``/metrics`` is the
  server's own exposition, ``/admin/stats`` has no broker, shm, workers
  or fleet sections, and the families those modules declare render from
  their declarations.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch.errors import (
    AuthError,
    DeviceUnavailable,
    DurabilityError,
    NornicError,
    ResourceExhausted,
)
from nornicdb_tpu_torch.storage.types import Edge, Node


from nornicdb_tpu_torch.cypher import ast as cypher_ast
from nornicdb_tpu_torch.cypher.executor import classify_query_text
from nornicdb_tpu_torch.cypher.parser import parse as cypher_parse
# registers the columnar-Cypher families (plan-cache hits/misses/
# invalidations, per-operator latency, columnar rows, offloads) so the
# tested docs/observability.md catalog renders in every server process
from nornicdb_tpu_torch.cypher import plan as _cypher_plan  # noqa: F401
# registers the serving-engine metric families (packed tokens, pack
# efficiency, sheds, staging overlap, embedder selection) so the tested
# docs/observability.md catalog renders in every server process, whether
# or not a ServingEngine was constructed
from nornicdb_tpu_torch.serving import stats as _serving_stats  # noqa: F401
# same deal for the device-broker and shared-memory read-plane families
# (nornicdb_broker_* / nornicdb_shm_*): registered at import so the tested
# catalog renders even in a single-process server with no worker pool
from nornicdb_tpu_torch.server import broker as _broker_mod  # noqa: F401
from nornicdb_tpu_torch.server import shm as _shm_mod  # noqa: F401


def _worker_pool_stats() -> list[dict]:
    """The prefork pools' stats: none until the workers are ported
    (ROADMAP A6d)."""
    return []
# likewise the generation-engine families (queue depth, page-pool
# utilization, prefill/decode latency, sheds, tokens) — the tested
# observability catalog must render them in every serving process
from nornicdb_tpu_torch.genserve import stats as _genserve_stats  # noqa: F401
# fleet telemetry plane: the federation module registers the worker
# serving-ladder + fleet-membership families and owns the /metrics merge
# collector; deviceprof registers the device program ledger + HBM
# residency families and the /admin/profile capture — imported here so
# the tested observability catalog renders them in every server process
from nornicdb_tpu_torch.telemetry import budget as _budget
# the cost-model module registers the nornicdb_cost_model_* / SLO-burn /
# build-info families and answers GET /admin/capacity — imported here so
# the tested observability catalog renders them in every server process
from nornicdb_tpu_torch.telemetry import costmodel as _costmodel
from nornicdb_tpu_torch.telemetry import deviceprof as _deviceprof
from nornicdb_tpu_torch.telemetry import federation as _federation  # noqa: F401
from nornicdb_tpu_torch.telemetry.metrics import (
    REGISTRY as _TELEMETRY_REGISTRY,
    Registry as _Registry,
)
from nornicdb_tpu_torch.telemetry.slowlog import slow_log as _slow_log
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

log = logging.getLogger(__name__)


def _jsonable(v: Any) -> Any:
    if isinstance(v, Node):
        return {
            "id": v.id,
            "labels": list(v.labels),
            "properties": _jsonable(v.properties),
        }
    if isinstance(v, Edge):
        return {
            "id": v.id,
            "type": v.type,
            "startNode": v.start_node,
            "endNode": v.end_node,
            "properties": _jsonable(v.properties),
        }
    if isinstance(v, dict):
        if v.get("__path__"):
            return {
                "nodes": [_jsonable(n) for n in v.get("nodes", [])],
                "relationships": [_jsonable(e) for e in v.get("relationships", [])],
            }
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class RateLimiter:
    """Token-bucket per client (ref: pkg/security/middleware.go rate limiting)."""

    def __init__(self, rate: float = 100.0, burst: int = 200):
        self.rate = rate
        self.burst = burst
        self._buckets: dict[str, tuple[float, float]] = {}  # ip -> (tokens, ts)
        self._lock = threading.Lock()

    MAX_BUCKETS = 10_000

    def allow(self, client: str) -> bool:
        now = time.monotonic()
        with self._lock:
            if len(self._buckets) > self.MAX_BUCKETS:
                # prune clients whose buckets have refilled (idle long enough)
                self._buckets = {
                    ip: (t, ts)
                    for ip, (t, ts) in self._buckets.items()
                    if t + (now - ts) * self.rate < self.burst
                }
            tokens, ts = self._buckets.get(client, (float(self.burst), now))
            tokens = min(self.burst, tokens + (now - ts) * self.rate)
            if tokens < 1.0:
                self._buckets[client] = (tokens, now)
                return False
            self._buckets[client] = (tokens - 1.0, now)
            return True


class HttpServer:
    """(ref: server.New pkg/server/server.go)"""

    def __init__(
        self,
        db,
        host: str = "127.0.0.1",
        port: int = 7474,
        authenticator=None,
        auth_required: bool = False,
        rate_limit: float = 0.0,  # requests/sec per client; 0 = unlimited
        serve_ui: bool = True,  # False = headless (ref: -tags noui)
        cookie_secure: Optional[bool] = None,  # None = NORNICDB_COOKIE_SECURE
    ):
        self.db = db
        self.serve_ui = serve_ui
        if cookie_secure is None:
            cookie_secure = os.environ.get(
                "NORNICDB_COOKIE_SECURE", ""
            ).lower() in ("1", "true", "yes")
        self.cookie_secure = cookie_secure
        self.host = host
        self.port = port
        self.authenticator = authenticator
        self.auth_required = auth_required
        self.started_at = time.monotonic()
        self.requests = 0
        self.errors = 0
        self.slow_queries = 0
        self.slow_threshold = 1.0
        self._oauth_codes: dict[str, float] = {}
        self.rate_limiter = (
            RateLimiter(rate_limit, burst=max(int(rate_limit * 2), 1))
            if rate_limit > 0
            else None
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._qdrant = None
        # per-server child registry: instrumentation-site families from the
        # process-global REGISTRY render first, then this server's
        # db-specific callbacks — so several servers in one process (tests)
        # never fight over one namespace
        self.registry = _Registry(parent=_TELEMETRY_REGISTRY)
        self._http_hist = self.registry.histogram(
            "nornicdb_http_request_seconds",
            "HTTP request latency by method and route family",
            labels=("method", "route"),
        )
        self._http_by_code = self.registry.counter(
            "nornicdb_http_requests_by_code_total",
            "HTTP requests by method and status code",
            labels=("method", "code"),
        )
        self._register_db_metrics()

    @staticmethod
    def _parse_body(raw: bytes) -> dict:
        if not raw:
            return {}
        try:
            return json.loads(raw or b"{}")
        except json.JSONDecodeError:
            raise NornicError("invalid JSON body")

    # -- hot-path response cache (shared policy: server/respcache.py) -----
    @property
    def response_cache(self):
        if getattr(self, "_resp_cache", None) is None:
            from nornicdb_tpu_torch.server.respcache import ResponseCache

            self._resp_cache = ResponseCache(
                lambda: self.db.search._generation
            )
        return self._resp_cache

    def _retention(self):
        if getattr(self, "_retention_mgr", None) is None:
            from nornicdb_tpu_torch.retention import RetentionManager

            self._retention_mgr = RetentionManager(self.db.storage)
        return self._retention_mgr

    @property
    def qdrant(self):
        if self._qdrant is None:
            # the db facade's SHARED registry: a private per-server
            # registry would build a second corpus per collection on the
            # card and miss the other transports' upserts
            shared = getattr(self.db, "qdrant_registry", None)
            if callable(shared):
                self._qdrant = shared()
            else:  # bare-engine test doubles without the facade
                from nornicdb_tpu_torch.server.qdrant import QdrantCollections

                self._qdrant = QdrantCollections(
                    self.db.storage,
                    vectorspaces=getattr(self.db, "vectorspaces", None),
                    device=getattr(self.db, "device", None),
                )
        return self._qdrant

    # -- request handling ----------------------------------------------------
    def _make_handler(server_self):  # noqa: N805
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Nagle + delayed-ACK costs ~40ms/request on keep-alive
            # connections (this attribute lives on the HANDLER, per
            # socketserver.StreamRequestHandler)
            disable_nagle_algorithm = True

            def log_message(self, *args):  # quiet
                pass

            def _send(
                self,
                code: int,
                body: Any,
                content_type="application/json",
                extra_headers: Optional[dict[str, str]] = None,
            ):
                data = (
                    json.dumps(body).encode()
                    if content_type == "application/json"
                    else body.encode()
                )
                self._send_raw(code, data, content_type, extra_headers)

            def _send_raw(
                self,
                code: int,
                data: bytes,
                content_type="application/json",
                extra_headers: Optional[dict[str, str]] = None,
            ) -> None:
                """Pre-encoded body with the standard header set."""
                self._status = code
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                root = getattr(self, "_trace_root", None)
                if root is not None and root.trace_id is not None:
                    # propagate the (possibly ingested) trace id back to the
                    # caller (W3C trace-context response propagation)
                    self.send_header("traceparent", root.traceparent())
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Access-Control-Allow-Origin", "*")
                # security headers (ref: pkg/security/middleware.go)
                self.send_header("X-Content-Type-Options", "nosniff")
                self.send_header("X-Frame-Options", "DENY")
                self.send_header("Referrer-Policy", "no-referrer")
                self.end_headers()
                self.wfile.write(data)

            def _raw_body(self) -> bytes:
                length = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(length) if length else b""

            def _body(self) -> dict:
                return server_self._parse_body(self._raw_body())

            def _auth(self, permission: str = "read") -> Optional[dict]:
                if not server_self.auth_required or server_self.authenticator is None:
                    return {"sub": "anonymous", "role": "admin"}
                hdr = self.headers.get("Authorization", "")
                auth = server_self.authenticator
                if hdr.startswith("Bearer "):
                    return auth.authorize(hdr[7:], permission)
                if hdr.startswith("Basic "):
                    try:
                        user, pw = (
                            base64.b64decode(hdr[6:]).decode().split(":", 1)
                        )
                    except Exception:
                        raise AuthError("malformed Basic auth")
                    token = auth.authenticate(user, pw)
                    return auth.authorize(token, permission)
                # browser sessions authenticate via the HttpOnly cookie set
                # by POST /auth/token (ref: server_auth.go handleToken's
                # SetCookie("nornicdb_token", ...))
                token = self._cookie_token()
                if token:
                    return auth.authorize(token, permission)
                raise AuthError("authentication required")

            def _cookie_token(self) -> str:
                for part in (self.headers.get("Cookie") or "").split(";"):
                    k, _, v = part.strip().partition("=")
                    if k == "nornicdb_token":
                        return v
                return ""

            def do_OPTIONS(self):  # CORS preflight
                self.send_response(204)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Methods", "GET, POST, DELETE, OPTIONS"
                )
                self.send_header(
                    "Access-Control-Allow-Headers", "Authorization, Content-Type"
                )
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _client_ip(self) -> str:
                # Worker-pool proxies (server/workers.py) connect from
                # loopback and carry the real peer in X-Forwarded-For.
                # Trust the header ONLY for loopback peers — an external
                # client must not be able to spoof its rate-limit bucket.
                peer = self.client_address[0]
                if peer in ("127.0.0.1", "::1"):
                    fwd = (self.headers.get("X-Forwarded-For") or "").strip()
                    if fwd:
                        # rightmost entry = the hop our trusted loopback
                        # worker appended; earlier entries are client-supplied
                        # and spoofable
                        return fwd.split(",")[-1].strip()
                return peer

            def _limited(self) -> bool:
                rl = server_self.rate_limiter
                if rl is not None and not rl.allow(self._client_ip()):
                    self._send(429, {"error": "rate limit exceeded"})
                    return True
                return False

            def _dispatch(self, method: str):
                server_self.requests += 1
                if self._limited():
                    return
                path = self.path.split("?")[0]
                route = server_self._route_label(path)
                self._status = 200
                t0 = time.perf_counter()
                # ingress tracing: ingest W3C traceparent, open the root
                # span every downstream span (executor, storage, device
                # sync) hangs off; the id is echoed on the response by
                # _send_raw
                with _tracer.start_trace(
                    f"http.{method}", traceparent=self.headers.get("traceparent")
                ) as root:
                    if root.trace_id is not None:
                        root.set_attr("path", path)
                        root.set_attr("route", route)
                    self._trace_root = root
                    try:
                        if path.startswith("/collections"):
                            server_self._route_qdrant(self, method, path)
                            return
                        if method == "GET":
                            server_self._route_get(self)
                        elif method == "POST":
                            server_self._route_post(self)
                        elif path.startswith("/auth/users/"):
                            server_self._route_user_by_name(self, method, path)
                        else:
                            self._send(405, {"error": f"{method} not allowed on {path}"})
                    except AuthError as e:
                        self._send(401, {"error": str(e)})
                    except ResourceExhausted as e:
                        # serving admission control shed this request
                        # (embed/search queue full or deadline passed):
                        # backpressure, not failure — clients back off
                        self._send(
                            429,
                            {"error": str(e), "reason": e.reason},
                            extra_headers={"Retry-After": "1"},
                        )
                    except DeviceUnavailable as e:
                        # the card is not serving and the port does not
                        # answer from the host: transient, like Bolt's
                        # Neo.TransientError.General.DatabaseUnavailable
                        self._send(
                            503,
                            {"error": str(e), "reason": "device_unavailable"},
                            extra_headers={"Retry-After": "1"},
                        )
                    except DurabilityError as e:
                        # the write was NOT acked and the WAL tail was
                        # repaired: transient storage unavailability, not
                        # a client error — 503 mirrors Bolt's
                        # Neo.TransientError.General.DatabaseUnavailable
                        # mapping (statement-level durability failures
                        # are already reported in-body by the tx API;
                        # this catches the ones raised outside a
                        # statement, e.g. lazy system-DB writes)
                        self._send(
                            503,
                            {"error": str(e), "kind": e.kind},
                            extra_headers={"Retry-After": "1"},
                        )
                    except Exception as e:
                        server_self.errors += 1
                        self._send(400 if method != "GET" else 500, {"error": str(e)})
                    finally:
                        # a keep-alive connection reuses this handler:
                        # responses sent before the NEXT request's trace
                        # opens (e.g. the rate limiter's 429) must not echo
                        # this request's traceparent
                        self._trace_root = None
                        elapsed = time.perf_counter() - t0
                        server_self._http_hist.labels(method, route).observe(
                            elapsed
                        )
                        server_self._http_by_code.labels(
                            method, str(self._status)
                        ).inc()

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        return Handler

    def _route_qdrant(self, h, method: str, path: str) -> None:
        """Qdrant-compatible vector API (ref: pkg/qdrantgrpc, REST shapes)."""
        from nornicdb_tpu_torch.server.qdrant import handle_qdrant

        h._auth("read" if method == "GET" else "write")
        body = h._body() if method in ("POST", "PUT", "DELETE") else {}
        routed = handle_qdrant(self.qdrant, method, path, body)
        if routed is None:
            h._send(404, {"error": f"not found: {path}"})
            return
        code, payload = routed
        h._send(code, _jsonable(payload))

    # -- GET routes --------------------------------------------------------------
    def _route_get(self, h) -> None:
        path = h.path.split("?")[0]
        if path in ("/", "/ui", "/browser", "/login", "/security", "/admin"):
            # embedded console (ref: ui/embed.go — SPA at the root, with
            # deep links /login and /security served by the same handler,
            # server_router.go:59-64; set serve_ui=False for the
            # reference's -tags noui equivalent)
            if not self.serve_ui:
                h._send(404, {"error": "ui disabled"})
                return
            from nornicdb_tpu_torch.server.ui import UI_HTML

            h._send(200, UI_HTML, content_type="text/html; charset=utf-8")
            return
        if path in ("/openapi.json", "/openapi.yaml", "/docs"):
            # machine-readable API description + embedded explorer
            # (ref: docs/api-reference/openapi.yaml + cmd/swagger-ui).
            # Behind serve_ui: the reference ships swagger-ui as a separate
            # binary, so a headless build exposes no docs/HTML surface —
            # and the spec enumerates every endpoint, which a locked-down
            # deployment may not want served unauthenticated.
            if not self.serve_ui:
                h._send(404, {"error": "ui disabled"})
                return
            from nornicdb_tpu_torch.server import openapi

            if path == "/docs":
                h._send(200, openapi.DOCS_HTML,
                        content_type="text/html; charset=utf-8")
            elif path == "/openapi.yaml":
                h._send(200, openapi.spec_yaml(),
                        content_type="application/yaml; charset=utf-8")
            else:
                h._send(200, openapi.build_spec())
            return
        if path.startswith("/auth/oauth/authorize"):
            # OAuth2 authorization-code flow, resource-owner-credential
            # variant (ref: pkg/auth/oauth.go + cmd/oauth-provider): GET
            # with response_type=code&redirect_uri=... returns a 302 carrying
            # a short-lived code; exchange at /auth/oauth/token with
            # grant_type=authorization_code (credentials passed via the
            # basic-auth header on the exchange).
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(h.path).query)
            redirect = (q.get("redirect_uri") or [""])[0]
            state = (q.get("state") or [""])[0]
            if not redirect or (q.get("response_type") or [""])[0] != "code":
                h._send(400, {"error": "response_type=code and redirect_uri required"})
                return
            import secrets as _secrets

            code = _secrets.token_urlsafe(24)
            self._oauth_codes[code] = time.time() + 120.0
            sep = "&" if "?" in redirect else "?"
            target = f"{redirect}{sep}code={code}"
            if state:
                target += f"&state={state}"
            h.send_response(302)
            h.send_header("Location", target)
            h.send_header("Content-Length", "0")
            h.end_headers()
            return
        if path == "/health":
            h._send(200, {"status": "ok"})
            return
        if path == "/status":
            wal = self.db.wal_stats()
            degraded = bool(wal and wal.get("degraded"))
            body = {
                "status": "degraded" if degraded else "running",
                "uptime_seconds": round(time.monotonic() - self.started_at, 1),
                "nodes": self.db.storage.node_count(),
                "edges": self.db.storage.edge_count(),
                "version": "1.0.0",
            }
            if degraded:
                body["wal_corruption"] = wal.get("corruption_info", "")
            h._send(200, body)
            return
        if path == "/metrics":
            # a single process: the exposition JAX's fleet collector
            # renders when no worker segment is registered
            h._send(200, self.registry.render_prometheus(),
                    content_type="text/plain; version=0.0.4")
            return
        if path == "/auth/config":
            # UI bootstrap: is auth on, which OAuth providers exist
            # (ref: server_auth.go:215 handleAuthConfig)
            providers = []
            if os.environ.get("NORNICDB_AUTH_PROVIDER") == "oauth":
                providers.append(
                    {
                        "name": "oauth",
                        "url": "/auth/oauth/authorize",
                        "displayName": "OAuth",
                    }
                )
            h._send(
                200,
                {
                    "devLoginEnabled": True,
                    "securityEnabled": bool(
                        self.auth_required and self.authenticator is not None
                    ),
                    "oauthProviders": providers,
                },
            )
            return
        if path == "/auth/me":
            # current user for the UI session (ref: server_auth.go:368)
            if not self.auth_required or self.authenticator is None:
                h._send(
                    200,
                    {
                        "id": "anonymous",
                        "username": "anonymous",
                        "roles": ["admin"],
                        "enabled": True,
                    },
                )
                return
            payload = h._auth("read")
            try:
                user = self.authenticator.get_user(payload["sub"])
                body = {
                    "id": f"user-{user.username}",
                    "username": user.username,
                    "roles": [user.role],
                    "created_at": user.created_at,
                    "disabled": user.disabled,
                }
            except AuthError:
                # token subject without a stored user (e.g. API token)
                body = {
                    "id": payload["sub"],
                    "username": payload["sub"],
                    "roles": [payload.get("role", "none")],
                    "disabled": False,
                }
            h._send(200, body)
            return
        if path == "/auth/users":
            # admin user list (ref: server_auth.go:549 handleUsers GET)
            h._auth("user_manage")
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            h._send(
                200,
                [
                    {
                        "username": u.username,
                        "roles": [u.role],
                        "created_at": u.created_at,
                        "disabled": u.disabled,
                    }
                    for u in self.authenticator.list_users()
                ],
            )
            return
        if path.startswith("/auth/users/"):
            h._auth("user_manage")
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            from urllib.parse import unquote

            name = unquote(path[len("/auth/users/"):])
            try:
                u = self.authenticator.get_user(name)
            except AuthError:
                h._send(404, {"error": f"user {name} not found"})
                return
            h._send(
                200,
                {
                    "username": u.username,
                    "roles": [u.role],
                    "created_at": u.created_at,
                    "disabled": u.disabled,
                },
            )
            return
        if path == "/api/bifrost/status":
            # assistant status: metrics, models, plugins
            # (ref: server_router.go:211 -> heimdall handler status)
            h._auth("read")
            mgr = self.db.heimdall
            body = {
                "status": "ok",
                "metrics": vars(mgr.metrics),
                "named_metrics": mgr.metrics_registry.snapshot(),
                "models": [m.as_dict() for m in mgr.models.list()],
                "events": {
                    "delivered": mgr.events.delivered,
                    "dropped": mgr.events.dropped,
                },
            }
            host = getattr(mgr, "plugin_host", None)
            if host is not None:
                body["plugins"] = [vars(p) for p in host.plugins()]
            h._send(200, body)
            return
        if path == "/v1/models":
            # OpenAI-compatible model listing from the registry
            h._auth("read")
            h._send(200, {
                "object": "list",
                "data": [
                    {"id": m.name, "object": "model", "owned_by": "nornicdb",
                     "type": m.type, "loaded": m.loaded}
                    for m in self.db.heimdall.models.list()
                ],
            })
            return
        if path == "/api/bifrost/events":
            # SSE notification bus (ref: server_router.go:219 -> bifrost.go)
            h._auth("read")
            import queue as _queue

            bus = self.db.heimdall.bifrost
            q = bus.subscribe()
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.send_header("Connection", "close")
            h.end_headers()
            try:
                while True:
                    try:
                        event = q.get(timeout=15.0)
                    except _queue.Empty:
                        h.wfile.write(b": keepalive\n\n")
                        h.wfile.flush()
                        continue
                    h.wfile.write(
                        f"event: {event['event']}\n".encode()
                        + b"data: " + json.dumps(
                            event["data"], default=str
                        ).encode() + b"\n\n"
                    )
                    h.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
            finally:
                bus.unsubscribe(q)
            h.close_connection = True
            return
        if path == "/admin/traces":
            # recent completed traces, newest first (tentpole pillar 2)
            h._auth("admin")
            h._send(200, {"traces": _tracer.traces()})
            return
        if path.startswith("/admin/traces/"):
            h._auth("admin")
            trace_id = path[len("/admin/traces/"):]
            tree = _tracer.trace(trace_id)
            if tree is None:
                h._send(404, {"error": f"trace {trace_id} not found"})
            else:
                # deadline-budget attribution: predicted vs actual per
                # named stage, when admission opened a budget for this
                # trace (satellite: budget breakdown on trace detail)
                budget = _budget.breakdown_for(trace_id,
                                               tree.get("spans", []))
                if budget is not None:
                    tree["budget"] = budget
                h._send(200, tree)
            return
        if path == "/admin/capacity":
            # cost-model table + headroom (max sustainable qps per
            # workload class) + SLO window state — the closed-loop
            # capacity surface the predictive admission decides from
            h._auth("admin")
            h._send(200, _costmodel.capacity_snapshot())
            return
        if path == "/admin/slow-queries":
            # over-threshold statements with redacted text, plan summary,
            # span breakdown and counter deltas (tentpole pillar 3); a
            # single process has no worker entries to merge (ROADMAP A6d)
            h._auth("admin")
            entries = [dict(e, proc="primary")
                       for e in _slow_log.snapshot()]
            entries.sort(key=lambda e: e.get("timestamp", 0.0),
                         reverse=True)
            h._send(200, {
                "threshold_ms": _slow_log.threshold_s * 1e3,
                "recorded": _slow_log.recorded,
                "slow_queries": entries,
            })
            return
        if path == "/admin/stats":
            h._auth("admin")
            stats = {
                "requests": self.requests,
                "errors": self.errors,
                "slow_queries": self.slow_queries,
                "telemetry": {
                    "traces_buffered": _tracer.count(),
                    "slow_queries_recorded": _slow_log.recorded,
                },
                "nodes": self.db.storage.node_count(),
                "edges": self.db.storage.edge_count(),
                "pending_embeddings": len(self.db.storage.pending_embed_ids()),
                "databases": self.db.database_manager.storage_stats(),
            }
            if self.db._embed_worker is not None:
                stats["embed_worker"] = vars(self.db._embed_worker.stats)
            engine = self.db.serving_engine()
            if engine is not None:
                # continuous batching engine health: pack efficiency,
                # sheds, staging overlap (docs/operations.md "Embed
                # serving tuning" reads these)
                stats["serving"] = engine.stats_snapshot()
            gen_engine = self.db.genserve_engine()
            if gen_engine is not None:
                # paged-KV generation engine health: queue depth, page
                # pool pressure, evictions, sheds by reason
                # (docs/generation.md reads these)
                stats["genserve"] = gen_engine.stats_snapshot()
            search = getattr(self.db, "search", None)
            if search is not None and hasattr(search, "stats_snapshot"):
                # index/search counters + device-sync patching + query
                # batcher sizes (tune batch_window / uploader cadence here)
                stats["search"] = search.stats_snapshot()
            wal = self.db.wal_stats()
            if wal is not None:
                stats["wal"] = wal
            adjacency = self.db.adjacency_stats()
            if adjacency is not None:
                # CSR topology snapshot health: builds / delta merges /
                # epoch retries / resident bytes (tune merge_threshold here)
                stats["adjacency"] = adjacency
            cypher_stats = self.db.cypher_stats()
            if cypher_stats is not None:
                # columnar Cypher engine: plan-cache hits/misses/
                # invalidations + full/fallback/unsupported outcomes
                # (docs/operations.md "Columnar Cypher execution")
                stats["cypher"] = cypher_stats
            from nornicdb_tpu_torch import backend as _backend_mod

            backend_stats = _backend_mod.manager_stats()
            if backend_stats is not None:
                # device lifecycle: state machine position, fallback /
                # recovery counters, probe latency, recent transitions
                # (docs/backend.md failure playbook reads from here)
                stats["backend"] = backend_stats
            # the broker, shm, workers and fleet sections come with the
            # prefork workers (ROADMAP A6d)
            pools = _worker_pool_stats()
            if pools:
                # prefork worker pool: live workers, respawns, ports
                stats["workers"] = pools[0] if len(pools) == 1 else pools
            # device-time & HBM profiler: program ledger by
            # (subsystem, kind, shape) + residency by component
            # (docs/observability.md "Device-time & HBM profiler")
            stats["deviceprof"] = _deviceprof.snapshot()
            h._send(200, stats)
            return
        if path == "/admin/config":
            # (ref: handleAdminConfig server_admin.go:64 — running config
            # view + runtime feature flags)
            h._auth("admin")
            from nornicdb_tpu_torch.config import flags

            # secret material never leaves the process, even for admins:
            # the response flows through proxies and ends up in logs
            secret = ("passphrase", "password", "secret", "token", "api_key")
            cfg = {
                k: ("<redacted>" if v and any(s in k for s in secret) else v)
                for k, v in vars(self.db.config).items()
                # feature_flags on Config is an inert seed field; the live
                # registry is the top-level feature_flags key below
                if not k.startswith("_") and k != "feature_flags"
            }
            h._send(200, {"config": cfg, "feature_flags": flags.all()})
            return
        if path == "/admin/tpu/status":
            # the reference's /admin/gpu/status analogue: accelerator
            # availability WITHOUT forcing backend init (a down relay
            # would hang the admin surface for minutes)
            h._auth("admin")
            h._send(200, self._tpu_status())
            return
        h._send(404, {"error": f"not found: {path}"})

    def _tpu_status(self) -> dict:
        """(ref: server_gpu.go:14 handleGPUStatus). Reports from CUDA state
        that is already initialised only: the admin route never
        initialises CUDA itself (the device owner does, on its own
        thread), so it cannot block or race a first touch. The route keeps
        the JAX package's path; ``kernel_launches`` counts this process's
        launches of each hand-written kernel."""
        import torch

        from nornicdb_tpu_torch import backend as _backend_mod

        out = {"framework": "torch", "backend_initialized": False,
               "devices": [], "platform": None}
        lifecycle = _backend_mod.manager_stats()
        if lifecycle is not None:
            # the device owner's view: state machine position + counters
            # (its probes run on its own thread, so this never blocks)
            out["lifecycle"] = lifecycle
        if not torch.cuda.is_initialized():
            out["note"] = ("CUDA not initialised yet; the device owner or "
                           "the first search or embed initialises it")
            return out
        try:
            n = torch.cuda.device_count()
            out["backend_initialized"] = True
            out["platform"] = "cuda"
            out["devices"] = [torch.cuda.get_device_name(i)
                              for i in range(n)]
            out["device_count"] = n
        except Exception as e:  # a card lost mid-call
            out["error"] = str(e)[:200]
        from nornicdb_tpu_torch.ops import kernels

        out["kernel_launches"] = kernels.launch_counts()
        return out

    # -- telemetry wiring (ref: server_public.go:141-200, now rendered
    # entirely by the telemetry registry instead of a hand-built string) ----
    def _register_db_metrics(self) -> None:
        """Register this server's db-level providers as render-time
        callbacks.  Subsystem stats() dicts plug in via stats_callback
        (numeric leaves flattened to gauges) with exact-name renames for
        the documented/asserted metric names."""
        reg = self.registry
        reg.gauge_callback(
            "nornicdb_uptime_seconds", "Server uptime in seconds",
            lambda: time.monotonic() - self.started_at,
        )
        reg.counter_callback(
            "nornicdb_requests_total", "HTTP requests served",
            lambda: self.requests,
        )
        reg.counter_callback(
            "nornicdb_errors_total", "HTTP requests that raised",
            lambda: self.errors,
        )
        reg.counter_callback(
            "nornicdb_slow_queries_total",
            "Statements captured by the slow-query log",
            lambda: _slow_log.recorded,
        )
        reg.gauge_callback(
            "nornicdb_nodes", "Nodes in the default database view",
            lambda: self.db.storage.node_count(),
        )
        reg.gauge_callback(
            "nornicdb_edges", "Edges in the default database view",
            lambda: self.db.storage.edge_count(),
        )
        reg.gauge_callback(
            "nornicdb_pending_embeddings", "Nodes awaiting embedding",
            lambda: len(self.db.storage.pending_embed_ids()),
        )

        def _embed_stats() -> Optional[dict]:
            w = self.db._embed_worker
            return None if w is None else vars(w.stats)

        reg.stats_callback(
            "nornicdb_embed", _embed_stats,
            help_="Embed-worker counters",
            rename={
                "nornicdb_embed_processed":
                    "nornicdb_embeddings_processed_total",
                "nornicdb_embed_failed": "nornicdb_embeddings_failed_total",
            },
            counters={"nornicdb_embed_processed", "nornicdb_embed_failed"},
        )

        def _search_stats() -> Optional[dict]:
            # the LAZY slot, never the property: /metrics must not force
            # search-service construction (and a full index build)
            search = self.db._search
            if search is None or not hasattr(search, "stats_snapshot"):
                return None
            return search.stats_snapshot()

        reg.stats_callback(
            "nornicdb_search", _search_stats,
            help_="Search service / device-sync / query-batcher counters",
            rename={
                "nornicdb_search_corpus_sync_bytes_uploaded":
                    "nornicdb_device_sync_bytes_total",
                "nornicdb_search_corpus_sync_patches":
                    "nornicdb_device_sync_patches_total",
                "nornicdb_search_corpus_sync_full_uploads":
                    "nornicdb_device_sync_full_uploads_total",
                "nornicdb_search_corpus_sync_query_stall_s":
                    "nornicdb_device_sync_query_stall_seconds_total",
                "nornicdb_search_batcher_queries":
                    "nornicdb_batched_queries_total",
                "nornicdb_search_batcher_batches":
                    "nornicdb_query_batches_total",
                "nornicdb_search_batcher_max_batch":
                    "nornicdb_query_batch_max",
            },
            counters={
                "nornicdb_search_corpus_sync_bytes_uploaded",
                "nornicdb_search_corpus_sync_patches",
                "nornicdb_search_corpus_sync_full_uploads",
                "nornicdb_search_corpus_sync_query_stall_s",
                "nornicdb_search_batcher_queries",
                "nornicdb_search_batcher_batches",
                "nornicdb_search_searches",
                "nornicdb_search_indexed",
                "nornicdb_search_removed",
                "nornicdb_search_vector_candidates",
                "nornicdb_search_fulltext_candidates",
                # mesh-sharded serving (ShardedCorpus.shard_stats)
                "nornicdb_search_corpus_shard_dispatches",
                "nornicdb_search_corpus_shard_ivf_dispatches",
                "nornicdb_search_corpus_shard_rebalances",
                "nornicdb_search_corpus_shard_local_k_overflows",
                "nornicdb_search_corpus_shard_promotions",
            },
        )
        reg.stats_callback(
            "nornicdb_wal", lambda: self.db.wal_stats(),
            help_="Write-ahead-log health counters",
            counters={
                "nornicdb_wal_entries", "nornicdb_wal_bytes_written",
                "nornicdb_wal_snapshots", "nornicdb_wal_recovered_entries",
                "nornicdb_wal_truncated_tail_records",
            },
        )
        reg.stats_callback(
            "nornicdb_adjacency", lambda: self.db.adjacency_stats(),
            help_="CSR adjacency snapshot counters",
            rename={
                "nornicdb_adjacency_builds": "nornicdb_adjacency_builds_total",
                "nornicdb_adjacency_delta_merges":
                    "nornicdb_adjacency_delta_merges_total",
                "nornicdb_adjacency_merged_edges":
                    "nornicdb_adjacency_merged_edges_total",
                "nornicdb_adjacency_epoch_retries":
                    "nornicdb_adjacency_epoch_retries_total",
            },
            counters={
                "nornicdb_adjacency_builds",
                "nornicdb_adjacency_delta_merges",
                "nornicdb_adjacency_merged_edges",
                "nornicdb_adjacency_epoch_retries",
            },
        )

        def _heimdall_families() -> list:
            # heimdall named metrics when the assistant has been used
            # (ref: pkg/heimdall/metrics.go Prometheus rendering)
            mgr = self.db._heimdall
            if mgr is None:
                return []
            return mgr.metrics_registry.prometheus_families()

        reg.families_callback("heimdall", _heimdall_families)

    ROUTE_FAMILIES = (
        ("/db/", "tx_commit"),
        ("/nornicdb/", "nornicdb"),
        ("/admin/", "admin"),
        ("/auth/", "auth"),
        ("/collections", "qdrant"),
        ("/api/bifrost", "bifrost"),
        ("/v1/", "openai"),
        ("/gdpr/", "gdpr"),
    )

    @classmethod
    def _route_label(cls, path: str) -> str:
        """Bounded-cardinality route family for metric labels."""
        if path in ("/metrics", "/health", "/status", "/mcp", "/graphql"):
            return path.lstrip("/")
        for prefix, label in cls.ROUTE_FAMILIES:
            if path.startswith(prefix):
                return label
        return "other"

    # -- POST routes ---------------------------------------------------------------
    def _route_post(self, h) -> None:
        path = h.path.split("?")[0]
        m = re.fullmatch(r"/db/([^/]+)/tx/commit", path)
        if m:
            body = h._body()
            # permission is per-statement: read-only queries work for viewers
            perm = "read"
            for stmt in body.get("statements", []):
                if classify_query_text(stmt.get("statement", "")) == "write":
                    perm = "write"
                    break
            h._auth(perm)
            self._tx_commit(h, m.group(1), body)
            return
        if path == "/nornicdb/search":
            h._auth("read")
            raw = h._raw_body()
            # hot-path response byte cache: generation-invalidated (any
            # index mutation kills it) + short TTL so decay/access-count
            # drift is bounded to TTL seconds (the rank layer underneath
            # already caches for 30s; ref: pkg/cache LRU+TTL query cache)
            cache = self.response_cache
            cached = cache.get((path, raw))
            if cached is not None:
                h._send_raw(200, cached)
                return
            # snapshot BEFORE searching: a mutation racing the search
            # must make this entry dead on arrival
            gen_before = cache.generation()
            body = self._parse_body(raw)
            vector = body.get("vector")
            if vector:
                # raw-vector search (the gRPC SearchRequest.vector shape on
                # the REST surface): the worker-servable hot path — prefork
                # workers answer it through the device broker and fall back
                # to the shared-memory host scan, bit-identical ids/scores
                # to this in-process path
                from nornicdb_tpu_torch.errors import NotFoundError

                hits = self.db.search.vector_candidates(
                    np.asarray(vector, np.float32),
                    k=int(body.get("limit", 10)),
                    min_similarity=float(body.get("min_score", -1.0)),
                )
                # include_content=false skips the per-hit node fetch —
                # the knob high-qps clients use when ids/scores suffice
                enrich = bool(body.get("include_content", True))
                out = []
                for nid, score in hits:
                    content = ""
                    if enrich:
                        try:
                            node = self.db.storage.get_node(nid)
                            content = node.properties.get("content", "")
                        except NotFoundError:
                            pass  # hit evicted between search and fetch
                    out.append(
                        {"id": nid, "score": score, "content": content}
                    )
                payload = json.dumps({"results": out}).encode()
                cache.put((path, raw), payload, gen_before)
                h._send_raw(200, payload)
                return
            results = self.db.search.search(
                body.get("query", ""), limit=int(body.get("limit", 10))
            )
            payload = json.dumps(
                {
                    "results": [
                        {
                            "id": r["id"],
                            "score": r["score"],
                            "content": r["content"],
                            "labels": r["labels"],
                            "properties": _jsonable(r["node"].properties),
                        }
                        for r in results
                    ]
                }
            ).encode()
            cache.put((path, raw), payload, gen_before)
            h._send_raw(200, payload)
            return
        if path == "/nornicdb/similar":
            h._auth("read")
            body = h._body()
            node = self.db.storage.get_node(body["id"])
            if node.embedding is None:
                h._send(200, {"results": []})
                return
            hits = self.db.search.vector_candidates(
                node.embedding, k=int(body.get("limit", 10)) + 1
            )
            h._send(
                200,
                {
                    "results": [
                        {"id": i, "score": s}
                        for i, s in hits
                        if i != node.id
                    ][: int(body.get("limit", 10))]
                },
            )
            return
        if path == "/nornicdb/embed":
            h._auth("write")
            body = h._body()
            if self.db.embedder is None:
                h._send(503, {"error": "no embedder configured"})
                return
            vec = self.db.embedder.embed(body.get("text", ""))
            h._send(200, {"embedding": _jsonable(vec), "dimensions": len(vec)})
            return
        if path == "/nornicdb/rag/answer":
            # GraphRAG: graph-context retrieval -> packed prompt ->
            # generation through the genserve engine (docs/generation.md).
            # A shed generation surfaces as 429 via the ResourceExhausted
            # handler in _dispatch, like every serving admission edge.
            h._auth("read")
            body = h._body()
            question = str(body.get("question", body.get("query", "")))
            if not question.strip():
                h._send(400, {"error": "question required"})
                return
            svc = self.db.graphrag()
            result = svc.answer(
                question,
                limit=body.get("limit"),
                max_new_tokens=body.get("max_tokens"),
                deadline_ms=body.get("deadline_ms"),
            )
            h._send(200, result)
            return
        if path == "/nornicdb/search/rebuild":
            h._auth("admin")
            n = self.db.search.build_indexes()
            h._send(200, {"indexed": n})
            return
        if path == "/admin/profile":
            # on-demand device profiler: single-flight torch.profiler
            # capture over ?seconds=N on the DB's device, returned as a
            # downloadable
            # .tar.gz artifact (telemetry/deviceprof.py; playbook in
            # docs/observability.md "Device-time & HBM profiler")
            h._auth("admin")
            from urllib.parse import parse_qs, urlparse

            import nornicdb_tpu_torch.telemetry as _telemetry

            qs = parse_qs(urlparse(h.path).query)
            try:
                seconds = float((qs.get("seconds") or ["1.0"])[0])
            except ValueError:
                h._send(400, {"error": "seconds must be a number"})
                return
            try:
                artifact = _deviceprof.capture_profile(
                    seconds, max_seconds=_telemetry.profile_max_s,
                    device=self.db.device)
            except _deviceprof.ProfileBusy as e:
                h._send(409, {"error": str(e)})
                return
            except Exception as e:
                log.exception("profile capture failed")
                h._send(503, {"error": f"profile capture failed: {e}"})
                return
            h._send_raw(
                200, artifact, content_type="application/gzip",
                extra_headers={
                    "Content-Disposition":
                        'attachment; filename="nornicdb-profile.tar.gz"',
                },
            )
            return
        if path == "/admin/backup":
            # (ref: server_router.go /admin/backup -> badger_backup.go)
            h._auth("admin")
            body = h._body()
            dest = self.db.backup(body.get("path") or None)
            h._send(200, {"file": dest})
            return
        if path == "/admin/restore":
            h._auth("admin")
            body = h._body()
            src = body.get("path", "")
            if not src or not os.path.exists(src):
                h._send(400, {"error": f"backup file not found: {src!r}"})
                return
            counts = self.db.restore(src)
            h._send(200, counts)
            return
        if path == "/auth/login":
            body = h._body()
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            token = self.authenticator.authenticate(
                body.get("username", ""), body.get("password", "")
            )
            h._send(200, {"token": token})
            return
        if path == "/auth/token":
            # browser login: JWT in body + HttpOnly session cookie
            # (ref: server_auth.go:19 handleToken)
            body = h._body()
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            grant = body.get("grant_type", "")
            if grant and grant != "password":
                h._send(400, {"error": "unsupported grant_type"})
                return
            token = self.authenticator.authenticate(
                body.get("username", ""), body.get("password", "")
            )
            h._send(
                200,
                {
                    "access_token": token,
                    "token_type": "Bearer",
                    "expires_in": int(self.authenticator.config.token_ttl),
                },
                extra_headers={
                    # Max-Age tracks the JWT TTL (a longer-lived cookie would
                    # just carry an expired bearer token); Secure when the
                    # deployment terminates TLS (NORNICDB_COOKIE_SECURE=1 or
                    # cookie_secure=True)
                    "Set-Cookie": (
                        f"nornicdb_token={token}; Path=/; HttpOnly; "
                        f"SameSite=Lax; "
                        f"Max-Age={int(self.authenticator.config.token_ttl)}"
                        + ("; Secure" if self.cookie_secure else "")
                    )
                },
            )
            return
        if path == "/auth/password":
            # change own password, old password re-verified
            # (ref: server_auth.go handleChangePassword, PermRead-gated)
            payload = h._auth("read")
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            body = h._body()
            username = payload["sub"]
            if not self.authenticator.verify_current_password(
                username, body.get("old_password", "")
            ):
                h._send(401, {"error": "current password incorrect"})
                return
            new = body.get("new_password", "")
            if len(new) < 4:
                h._send(400, {"error": "new password too short"})
                return
            self.authenticator.set_password(username, new)
            h._send(200, {"status": "password changed"})
            return
        if path == "/auth/api-token":
            # admin-only stateless API token with a subject label, for MCP
            # servers etc. (ref: server_auth.go handleGenerateAPIToken)
            payload = h._auth("admin")
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            body = h._body()
            subject = body.get("subject") or "api-token"
            ttl = float(body.get("expires_in") or 365 * 86400)
            token = self.authenticator.issue_token(
                subject, payload.get("role", "admin"), ttl=ttl
            )
            h._send(
                200,
                {
                    "token": token,
                    "subject": subject,
                    "expires_in": int(ttl),
                    "token_type": "Bearer",
                },
            )
            return
        if path == "/auth/users":
            # create user (ref: server_auth.go:549 handleUsers POST)
            h._auth("user_manage")
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            body = h._body()
            roles = body.get("roles") or [body.get("role", "viewer")]
            try:
                u = self.authenticator.create_user(
                    body.get("username", ""), body.get("password", ""), roles[0]
                )
            except AuthError as e:
                h._send(400, {"error": str(e)})
                return
            h._send(
                201,
                {
                    "username": u.username,
                    "roles": [u.role],
                    "created_at": u.created_at,
                },
            )
            return
        if path == "/gdpr/export":
            # GDPR data export (ref: server_router.go /gdpr/export)
            h._auth("read")
            body = h._body()
            subject = body.get("subject", "")
            if not subject:
                h._send(400, {"error": "subject required"})
                return
            h._send(200, {"subject": subject,
                          "records": _jsonable(self._retention().export_subject(subject))})
            return
        if path == "/gdpr/delete":
            # GDPR erasure: request -> approve -> execute in one call when
            # confirm=true (ref: /gdpr/delete + pkg/retention workflow)
            h._auth("delete")
            body = h._body()
            subject = body.get("subject", "")
            if not subject:
                h._send(400, {"error": "subject required"})
                return
            mgr = self._retention()
            req = mgr.request_erasure(subject)
            if not body.get("confirm", False):
                h._send(202, {"request_id": req.id, "status": req.status,
                              "note": "re-POST with confirm=true to execute"})
                return
            mgr.approve_erasure(req.id)
            done = mgr.execute_erasure(req.id)
            h._send(200, {"request_id": done.id, "status": done.status,
                          "erased": done.erased_count})
            return
        if path == "/auth/oauth/token":
            # OAuth2 token endpoint (ref: pkg/auth/oauth.go; cmd/oauth-provider):
            # password and client_credentials grants map onto the JWT issuer
            body = h._body()
            if self.authenticator is None:
                h._send(503, {"error": "auth not configured"})
                return
            grant = body.get("grant_type", "")
            if grant == "authorization_code":
                code = body.get("code", "")
                expiry = self._oauth_codes.pop(code, 0.0)
                if expiry < time.time():
                    h._send(400, {"error": "invalid_grant"})
                    return
                token = self.authenticator.authenticate(
                    body.get("username", body.get("client_id", "")),
                    body.get("password", body.get("client_secret", "")),
                )
            elif grant == "password":
                token = self.authenticator.authenticate(
                    body.get("username", ""), body.get("password", "")
                )
            elif grant == "client_credentials":
                token = self.authenticator.authenticate(
                    body.get("client_id", ""), body.get("client_secret", "")
                )
            else:
                h._send(400, {"error": "unsupported_grant_type"})
                return
            h._send(
                200,
                {
                    "access_token": token,
                    "token_type": "Bearer",
                    "expires_in": int(self.authenticator.config.token_ttl),
                },
            )
            return
        if path == "/auth/logout":
            body = h._body()
            if self.authenticator is not None:
                token = body.get("token", "") or h._cookie_token()
                self.authenticator.logout(token)
            # clear the browser session cookie (ref: handleLogout MaxAge=-1)
            h._send(
                200,
                {"ok": True},
                extra_headers={
                    "Set-Cookie": "nornicdb_token=; Path=/; HttpOnly; Max-Age=0"
                },
            )
            return
        if path == "/mcp":
            h._auth("write")
            h._send(200, self._mcp(h._body()))
            return
        if path == "/graphql":
            # (ref: pkg/graphql mounted at /graphql, handler.go)
            h._auth("read")  # gate before touching the body
            body = h._body()
            q = body.get("query", "")
            from nornicdb_tpu_torch.server.graphql import (
                GraphQLExecutor,
                parse_operation,
            )

            if parse_operation(q) == "mutation":
                h._auth("write")
            h._send(200, _jsonable(
                GraphQLExecutor(self.db).execute(q, body.get("variables"))
            ))
            return
        if path in ("/api/bifrost/chat/completions", "/v1/chat/completions"):
            # (ref: server_router.go:215 -> heimdall handler.go:207)
            h._auth("read")
            body = h._body()
            messages = body.get("messages", [])
            max_tokens = int(body.get("max_tokens", 128))
            model = body.get("model") or None
            if body.get("stream"):
                # SSE streaming (ref: handler.go:561 streaming responses)
                h.send_response(200)
                h.send_header("Content-Type", "text/event-stream")
                h.send_header("Cache-Control", "no-cache")
                h.send_header("Connection", "close")
                h.end_headers()
                try:
                    for chunk in self.db.heimdall.chat_stream(
                        messages, max_tokens, model=model
                    ):
                        h.wfile.write(
                            b"data: " + json.dumps(chunk).encode() + b"\n\n"
                        )
                    h.wfile.write(b"data: [DONE]\n\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                h.close_connection = True
                return
            result = self.db.heimdall.chat(messages, max_tokens, model=model)
            # OpenAI-compatible: invalid_request_error -> 404/400 status
            h._send(404 if "error" in result else 200, result)
            return
        if path == "/admin/config":
            # runtime feature-flag updates (ref: handleAdminConfig POST —
            # the reference's runtime flag registry); static config stays
            # immutable at runtime
            h._auth("admin")
            from nornicdb_tpu_torch.config import flags

            body = h._body()
            # only absent/null means "no updates": `or {}` would let falsy
            # non-dicts ([], false, 0) skip the shape check below
            updates = body.get("feature_flags")
            if updates is None:
                updates = {}
            if not isinstance(updates, dict):
                h._send(400, {"error": "feature_flags must be an object"})
                return
            unknown = [k for k in updates if k not in flags.all()]
            if unknown:
                h._send(400, {"error": f"unknown feature flags: {unknown}",
                              "valid": sorted(flags.all())})
                return
            # strict booleans only: bool("false") is True, so coercing
            # would silently ENABLE a flag the client meant to disable
            bad = [k for k, v in updates.items() if not isinstance(v, bool)]
            if bad:
                h._send(400, {"error":
                              f"feature flag values must be booleans: {bad}"})
                return
            for k, v in updates.items():
                flags.set(k, v)
            h._send(200, {"feature_flags": flags.all()})
            return
        h._send(404, {"error": f"not found: {path}"})

    def _route_user_by_name(self, h, method: str, path: str) -> None:
        """PUT (roles/disabled) and DELETE for /auth/users/{name}
        (ref: server_auth.go handleUserByID)."""
        h._auth("user_manage")
        if self.authenticator is None:
            h._send(503, {"error": "auth not configured"})
            return
        from urllib.parse import unquote

        from nornicdb_tpu_torch.auth.auth import ROLE_PERMISSIONS

        name = unquote(path[len("/auth/users/"):])
        auth = self.authenticator
        if method == "DELETE":
            try:
                auth.delete_user(name)
            except AuthError:
                h._send(404, {"error": f"user {name} not found"})
                return
            h._send(200, {"status": "deleted"})
            return
        if method == "PUT":
            body = h._body()
            roles = body.get("roles") or (
                [body["role"]] if body.get("role") else []
            )
            # validation errors are 400; a missing user is 404
            if roles and roles[0] not in ROLE_PERMISSIONS:
                h._send(400, {"error": f"unknown role {roles[0]}"})
                return
            try:
                auth.get_user(name)  # existence check up front, atomically-ish
                if roles:
                    auth.set_role(name, roles[0])
                if body.get("disabled") is not None:
                    auth.set_disabled(name, bool(body["disabled"]))
            except AuthError as e:
                h._send(404, {"error": str(e)})
                return
            h._send(200, {"status": "updated"})
            return
        h._send(405, {"error": f"{method} not allowed on {path}"})

    def _tx_commit(self, h, database: str, body: dict) -> None:
        """Neo4j HTTP transaction API (ref: server_db.go).

        The whole statement batch is ONE implicit transaction (Neo4j
        semantics): a failing statement rolls back every earlier statement's
        writes. Single-statement bodies run on the shared per-database
        executor WITHOUT tx framing — statement-level undo already makes one
        statement atomic, and the framing measured ~3.5x request cost. For
        multi-statement bodies a FRESH session executor scopes the tx to
        this request; opening a BEGIN frame on the shared executor would
        entangle tx state across handler threads."""
        out_results = []
        errors = []
        statements = body.get("statements", [])
        if len(statements) <= 1:
            # single statement: statement-level atomicity (undo frames)
            # already gives the one-transaction semantics — skip the
            # session + BEGIN/COMMIT framing (measured ~3.5x request cost)
            self._tx_run_statements(
                self.db.executor_for(database), body, out_results, errors)
            h._send(200, {"results": out_results, "errors": errors})
            return
        ex = self.db.session_executor(database)
        ex.execute("BEGIN", {})
        finished = False
        try:
            self._tx_run_statements(ex, body, out_results, errors)
            finished = True
        finally:
            if not finished:
                # an unexpected exception escaped the statement loop (e.g.
                # a non-dict statements entry): the tx must not be left
                # half-applied with its undo log garbage-collected
                try:
                    ex.execute("ROLLBACK", {})
                except Exception:
                    log.warning("post-failure rollback failed", exc_info=True)
        try:
            ex.execute("ROLLBACK" if errors else "COMMIT", {})
        except Exception as e:  # a failed commit voids the batch's results
            errors.append({
                "code": "Neo.DatabaseError.Transaction.TransactionCommitFailed",
                "message": str(e),
            })
            out_results = []
        h._send(200, {"results": out_results, "errors": errors})

    def _tx_run_statements(self, ex, body: dict, out_results: list,
                           errors: list) -> None:
        for stmt in body.get("statements", []):
            if not isinstance(stmt, dict):
                errors.append({
                    "code": "Neo.ClientError.Request.InvalidFormat",
                    "message": "each statements entry must be an object",
                })
                return
            query = stmt.get("statement", "")
            params = stmt.get("parameters", {})
            # User-issued tx control is still rejected: the batch already
            # runs in a transaction, and a client COMMIT would detach the
            # rollback-on-error contract. Gate on the parsed AST, not
            # string prefixes ("BEGIN;", "/* c */ BEGIN" must not slip
            # through; parse() is memoized so this stays a cache hit).
            try:
                if isinstance(cypher_parse(query), cypher_ast.TxCommand):
                    errors.append({
                        "code": "Neo.ClientError.Transaction.Invalid",
                        "message": "explicit transaction control is not "
                                   "available on the stateless tx endpoint",
                    })
                    return
            except Exception:  # nornlint: disable=NL-ERR02
                pass  # unparseable: fall through, execute() reports it
            t0 = time.perf_counter()
            try:
                result = ex.execute(query, params)
            except DeviceUnavailable:
                raise  # the whole request is a 503, never a partial answer
            except Exception as e:
                errors.append(
                    {"code": "Neo.ClientError.Statement.SyntaxError", "message": str(e)}
                )
                return
            if time.perf_counter() - t0 > self.slow_threshold:
                self.slow_queries += 1
            out_results.append(
                {
                    "columns": result.columns,
                    "data": [
                        {"row": [_jsonable(v) for v in row], "meta": []}
                        for row in result.rows
                    ],
                    "stats": result.stats.as_dict(),
                }
            )

    # -- MCP (ref: pkg/mcp/tools.go:63-332 — 6 tools) -----------------------------
    MCP_TOOLS = [
        {
            "name": "store",
            "description": "Store a memory in the knowledge graph",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "content": {"type": "string"},
                    "labels": {"type": "array", "items": {"type": "string"}},
                },
                "required": ["content"],
            },
        },
        {
            "name": "recall",
            "description": "Search memories by meaning",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "query": {"type": "string"},
                    "limit": {"type": "integer"},
                },
                "required": ["query"],
            },
        },
        {
            "name": "discover",
            "description": "Find related memories via graph neighborhood",
            "inputSchema": {
                "type": "object",
                "properties": {"id": {"type": "string"}, "depth": {"type": "integer"}},
                "required": ["id"],
            },
        },
        {
            "name": "link",
            "description": "Create a relationship between two memories",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "from": {"type": "string"},
                    "to": {"type": "string"},
                    "type": {"type": "string"},
                },
                "required": ["from", "to"],
            },
        },
        {
            "name": "task",
            "description": "Create a task node",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "title": {"type": "string"},
                    "status": {"type": "string"},
                },
                "required": ["title"],
            },
        },
        {
            "name": "tasks",
            "description": "List task nodes",
            "inputSchema": {
                "type": "object",
                "properties": {"status": {"type": "string"}},
            },
        },
    ]

    def _mcp(self, req: dict) -> dict:
        """JSON-RPC 2.0 dispatcher (ref: pkg/mcp/server.go)."""
        rid = req.get("id")
        method = req.get("method", "")
        params = req.get("params", {}) or {}

        def ok(result):
            return {"jsonrpc": "2.0", "id": rid, "result": result}

        def err(code, msg):
            return {"jsonrpc": "2.0", "id": rid, "error": {"code": code, "message": msg}}

        if method == "initialize":
            return ok(
                {
                    "protocolVersion": "2024-11-05",
                    "serverInfo": {"name": "nornicdb-tpu", "version": "1.0.0"},
                    "capabilities": {"tools": {}},
                }
            )
        if method == "tools/list":
            return ok({"tools": self.MCP_TOOLS})
        if method == "tools/call":
            name = params.get("name", "")
            args = params.get("arguments", {}) or {}
            try:
                result = self._mcp_tool(name, args)
            except DeviceUnavailable:
                raise  # a 503, as on every route
            except Exception as e:
                return err(-32000, str(e))
            return ok(
                {"content": [{"type": "text", "text": json.dumps(_jsonable(result))}]}
            )
        return err(-32601, f"unknown method {method}")

    def _mcp_tool(self, name: str, args: dict) -> Any:
        db = self.db
        if name == "store":
            node = db.store(args["content"], labels=args.get("labels"))
            return {"id": node.id}
        if name == "recall":
            results = db.recall(args["query"], limit=int(args.get("limit", 5)))
            return [
                {"id": r["id"], "content": r["content"], "score": r["score"]}
                for r in results
            ]
        if name == "discover":
            nodes = db.neighbors(args["id"], depth=int(args.get("depth", 1)))
            return [
                {"id": n.id, "content": n.properties.get("content", "")}
                for n in nodes
            ]
        if name == "link":
            edge = db.link(args["from"], args["to"], args.get("type", "RELATED_TO"))
            return {"id": edge.id, "type": edge.type}
        if name == "task":
            node = db.store(
                args["title"],
                labels=["Task"],
                properties={
                    "title": args["title"],
                    "status": args.get("status", "open"),
                },
            )
            return {"id": node.id}
        if name == "tasks":
            status = args.get("status")
            tasks = db.storage.get_nodes_by_label("Task")
            return [
                {
                    "id": t.id,
                    "title": t.properties.get("title", ""),
                    "status": t.properties.get("status", ""),
                }
                for t in tasks
                if status is None or t.properties.get("status") == status
            ]
        raise NornicError(f"unknown tool {name}")

    # -- lifecycle --------------------------------------------------------------------
    def start(self) -> None:
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-server"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
