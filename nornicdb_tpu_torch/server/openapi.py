"""OpenAPI 3.0 description of the HTTP surface + embedded docs explorer.

Behavioral reference: docs/api-reference/openapi.yaml (1,162 lines, 30
paths) and cmd/swagger-ui in the reference. Here the spec is BUILT FROM
CODE next to the handlers it describes (a hand-maintained YAML drifts;
tests assert every documented path is actually routable), served at
/openapi.yaml and /openapi.json, with a self-contained explorer at /docs
(no CDN assets — this image is zero-egress, so swagger-ui's external
bundle would be a blank page).

The port's copy of ``nornicdb_tpu/server/openapi.py``: the API is the
JAX package's. Three descriptions name the port's device:
``/admin/tpu/status``, ``/admin/profile`` and the API's own.
"""

from __future__ import annotations

import functools
import json
from typing import Any

_ERR = {"type": "object", "properties": {"error": {"type": "string"}}}

_SEARCH_REQ = {
    "type": "object",
    "required": ["query"],
    "properties": {
        "query": {"type": "string"},
        "limit": {"type": "integer", "default": 10},
        "offset": {"type": "integer", "default": 0},
        "min_similarity": {"type": "number"},
        "labels": {"type": "array", "items": {"type": "string"}},
    },
}

_SEARCH_RESP = {
    "type": "object",
    "properties": {
        "results": {
            "type": "array",
            "items": {
                "type": "object",
                "properties": {
                    "id": {"type": "string"},
                    "content": {"type": "string"},
                    "score": {"type": "number"},
                    "labels": {"type": "array", "items": {"type": "string"}},
                },
            },
        },
        "total": {"type": "integer"},
    },
}

_TX_REQ = {
    "type": "object",
    "properties": {
        "statements": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["statement"],
                "properties": {
                    "statement": {"type": "string"},
                    "parameters": {"type": "object"},
                },
            },
        }
    },
}

_TX_RESP = {
    "type": "object",
    "properties": {
        "results": {
            "type": "array",
            "items": {
                "type": "object",
                "properties": {
                    "columns": {"type": "array", "items": {"type": "string"}},
                    "data": {"type": "array", "items": {"type": "object"}},
                    "stats": {"type": "object"},
                },
            },
        },
        "errors": {"type": "array", "items": {"type": "object"}},
    },
}


def _op(summary: str, *, tag: str, req: Any = None, resp: Any = None,
        params: list | None = None, auth: bool = True,
        method_desc: str = "", shed: bool = False) -> dict:
    op: dict = {
        "summary": summary,
        "tags": [tag],
        "responses": {
            "200": {"description": "success"},
        },
    }
    if method_desc:
        op["description"] = method_desc
    if resp is not None:
        op["responses"]["200"]["content"] = {
            "application/json": {"schema": resp}
        }
    if shed:
        # serving admission control (docs/operations.md "Embed serving
        # tuning"): bounded queues + deadlines shed under overload
        op["responses"]["429"] = {
            "description": "shed by serving admission control (embed/"
                           "search queue full or deadline exceeded); "
                           "retry with backoff",
            "content": {"application/json": {"schema": _ERR}},
        }
    if auth:
        op["responses"]["401"] = {
            "description": "authentication required (when auth is enabled)",
            "content": {"application/json": {"schema": _ERR}},
        }
        op["security"] = [{"bearerAuth": []}, {"basicAuth": []},
                          {"cookieAuth": []}]
    if req is not None:
        op["requestBody"] = {
            "required": True,
            "content": {"application/json": {"schema": req}},
        }
    if params:
        op["parameters"] = params
    return op


def _path_param(name: str, desc: str) -> dict:
    return {"name": name, "in": "path", "required": True,
            "description": desc, "schema": {"type": "string"}}


@functools.lru_cache(maxsize=4)
def build_spec(version: str = "0.4.0") -> dict:
    """The complete OpenAPI document as a plain dict (memoized: the spec is
    static per version, and /openapi.* is unauthenticated + hot)."""
    paths: dict[str, dict] = {
        # -- service ---------------------------------------------------------
        "/health": {"get": _op("Liveness probe", tag="service", auth=False)},
        "/status": {"get": _op(
            "Server status: node/edge counts, uptime, pending embeds",
            tag="service", auth=False)},
        "/metrics": {"get": _op(
            "Prometheus metrics (text exposition format)",
            tag="service", auth=False)},
        # -- auth ------------------------------------------------------------
        "/auth/config": {"get": _op(
            "Auth configuration for clients (securityEnabled, providers)",
            tag="auth", auth=False)},
        "/auth/token": {"post": _op(
            "Login: exchange username/password for a JWT; also sets the "
            "nornicdb_token session cookie",
            tag="auth", auth=False,
            req={"type": "object",
                 "required": ["username", "password"],
                 "properties": {"username": {"type": "string"},
                                "password": {"type": "string"}}},
            resp={"type": "object",
                  "properties": {"token": {"type": "string"},
                                 "expires_in": {"type": "integer"}}})},
        "/auth/logout": {"post": _op(
            "Revoke the current session token and clear the cookie",
            tag="auth")},
        "/auth/me": {"get": _op(
            "Current identity: username, roles",
            tag="auth",
            resp={"type": "object",
                  "properties": {"username": {"type": "string"},
                                 "roles": {"type": "array",
                                           "items": {"type": "string"}}}})},
        "/auth/password": {"post": _op(
            "Change the current user's password (verifies the old one)",
            tag="auth",
            req={"type": "object",
                 "required": ["old_password", "new_password"],
                 "properties": {"old_password": {"type": "string"},
                                "new_password": {"type": "string"}}})},
        "/auth/api-token": {"post": _op(
            "Generate a long-lived API token (admin only)",
            tag="auth",
            req={"type": "object",
                 "properties": {"subject": {"type": "string"},
                                "expires_in": {"type": "integer"}}})},
        "/auth/users": {
            "get": _op("List users (user_manage permission)", tag="auth"),
            "post": _op(
                "Create a user", tag="auth",
                req={"type": "object",
                     "required": ["username", "password"],
                     "properties": {
                         "username": {"type": "string"},
                         "password": {"type": "string"},
                         "roles": {"type": "array",
                                   "items": {"type": "string"}}}}),
        },
        "/auth/users/{username}": {
            "put": _op("Update a user's roles / disabled flag", tag="auth",
                       params=[_path_param("username", "target user")]),
            "delete": _op("Delete a user", tag="auth",
                          params=[_path_param("username", "target user")]),
        },
        "/auth/oauth/authorize": {"get": _op(
            "OAuth2 authorization-code flow entry point", tag="auth",
            auth=False)},
        "/auth/oauth/token": {"post": _op(
            "OAuth2 token endpoint (authorization_code / client_credentials)",
            tag="auth", auth=False)},
        # -- cypher ----------------------------------------------------------
        "/db/{database}/tx/commit": {"post": _op(
            "Neo4j HTTP transaction API: execute Cypher statements in one "
            "implicit transaction. Explicit BEGIN/COMMIT/ROLLBACK are "
            "rejected (the endpoint is stateless).",
            tag="cypher", req=_TX_REQ, resp=_TX_RESP,
            params=[_path_param("database", "target database or alias")])},
        "/graphql": {"post": _op(
            "GraphQL endpoint (queries, mutations, introspection)",
            tag="graphql",
            req={"type": "object",
                 "required": ["query"],
                 "properties": {"query": {"type": "string"},
                                "variables": {"type": "object"},
                                "operationName": {"type": "string"}}})},
        # -- memory / search -------------------------------------------------
        "/nornicdb/search": {"post": _op(
            "Hybrid search: vector + BM25 + RRF fusion over stored memories",
            tag="memory", req=_SEARCH_REQ, resp=_SEARCH_RESP, shed=True)},
        "/nornicdb/similar": {"post": _op(
            "Find memories similar to a given node",
            tag="memory",
            req={"type": "object",
                 "required": ["id"],
                 "properties": {"id": {"type": "string"},
                                "limit": {"type": "integer"}}},
            resp=_SEARCH_RESP)},
        "/nornicdb/embed": {"post": _op(
            "Embed a text through the continuous batching engine",
            tag="memory", shed=True)},
        "/nornicdb/search/rebuild": {"post": _op(
            "Rebuild the search indexes from storage", tag="memory")},
        "/nornicdb/rag/answer": {"post": _op(
            "GraphRAG answer: hybrid search + one-hop graph expansion "
            "assemble a token-budgeted context prompt, generated through "
            "the paged-KV continuous-batching engine (docs/generation.md)."
            " Without generation weights the answer is extractive from "
            "the retrieved context.",
            tag="memory", shed=True,
            req={"type": "object",
                 "required": ["question"],
                 "properties": {
                     "question": {"type": "string"},
                     "limit": {"type": "integer",
                               "description": "context nodes to retrieve"},
                     "max_tokens": {"type": "integer"},
                     "deadline_ms": {"type": "number"}}},
            resp={"type": "object",
                  "properties": {
                      "answer": {"type": "string"},
                      "mode": {"type": "string",
                               "enum": ["paged", "dense", "extractive"]},
                      "sources": {"type": "array",
                                  "items": {"type": "object"}},
                      "context": {"type": "object"},
                      "generated_tokens": {"type": "integer"},
                      "timings_ms": {"type": "object"}}})},
        # -- admin -----------------------------------------------------------
        "/admin/stats": {"get": _op(
            "Server statistics: storage, cache, query counters, uptime, "
            "search/device-sync/adjacency sections (the search corpus's "
            "`shard` block reports mesh dispatches, rows per shard, "
            "rebalances, local_k overflows — docs/operations.md \"Sharded "
            "serving tuning\"), and the `backend` section (device "
            "lifecycle state PROBING/READY/DEGRADED_CPU/RECOVERING, "
            "fallbacks_total, recoveries_total, probe latency, recent "
            "transitions — docs/backend.md), plus the `genserve` section "
            "when the generation engine is live (queue depth, page-pool "
            "pressure, evictions, sheds by reason — docs/generation.md)",
            tag="admin")},
        "/admin/backup": {"post": _op(
            "Write a full backup archive (gzip) server-side; returns the "
            "file path", tag="admin",
            req={"type": "object",
                 "properties": {"path": {"type": "string"}}},
            resp={"type": "object",
                  "properties": {"file": {"type": "string"}}})},
        "/admin/restore": {"post": _op(
            "Restore from a backup archive", tag="admin",
            req={"type": "object",
                 "required": ["path"],
                 "properties": {"path": {"type": "string"}}})},
        "/admin/config": {
            "get": _op("Running configuration + runtime feature flags",
                       tag="admin"),
            "post": _op(
                "Toggle runtime feature flags", tag="admin",
                req={"type": "object",
                     "properties": {"feature_flags": {"type": "object"}}}),
        },
        "/admin/tpu/status": {"get": _op(
            "Accelerator status (the reference's /admin/gpu/status "
            "analogue); reports the CUDA devices once CUDA is "
            "initialised, the device owner's view and each kernel's "
            "launches, and never initialises CUDA itself", tag="admin")},
        "/admin/traces": {"get": _op(
            "Recent completed request traces (newest first): trace id, "
            "root span, duration, span count", tag="admin")},
        "/admin/traces/{trace_id}": {"get": _op(
            "One trace as a span tree (W3C trace id; see "
            "docs/observability.md for the propagation map). Spans "
            "shipped from prefork worker processes merge into the same "
            "tree, tagged with their proc", tag="admin")},
        "/admin/slow-queries": {"get": _op(
            "Slow-query capture ring: over-threshold statements with "
            "redacted text, plan summary, span breakdown and "
            "adjacency/device-sync counter deltas; worker-side vector "
            "search captures merge in with proc + served-path "
            "attribution", tag="admin")},
        "/admin/profile": {"post": _op(
            "On-demand device profiler: single-flight torch.profiler "
            "capture over ?seconds=N (clamped to the configured "
            "maximum), returned as a downloadable .tar.gz artifact; "
            "409 while another capture is in flight "
            "(docs/observability.md \"Device-time & HBM profiler\")",
            tag="admin")},
        # -- compliance ------------------------------------------------------
        "/gdpr/export": {"post": _op(
            "Export all data for a subject (GDPR right of access)",
            tag="compliance",
            req={"type": "object",
                 "properties": {"subject": {"type": "string"}}})},
        "/gdpr/delete": {"post": _op(
            "Erase a subject's data (GDPR right to erasure)",
            tag="compliance",
            req={"type": "object",
                 "properties": {"subject": {"type": "string"}}})},
        # -- assistant -------------------------------------------------------
        "/api/bifrost/chat/completions": {"post": _op(
            "Heimdall assistant chat (OpenAI-compatible shape; SSE when "
            "stream=true)",
            tag="assistant",
            req={"type": "object",
                 "required": ["messages"],
                 "properties": {
                     "messages": {"type": "array", "items": {
                         "type": "object",
                         "properties": {"role": {"type": "string"},
                                        "content": {"type": "string"}}}},
                     "model": {"type": "string"},
                     "stream": {"type": "boolean"}}})},
        "/api/bifrost/status": {"get": _op(
            "Assistant status: model registry, event queue depth",
            tag="assistant")},
        "/api/bifrost/events": {"get": _op(
            "Assistant event stream (SSE)", tag="assistant")},
        "/v1/models": {"get": _op(
            "OpenAI-compatible model list", tag="assistant")},
        "/v1/chat/completions": {"post": _op(
            "OpenAI-compatible alias of the assistant chat endpoint",
            tag="assistant",
            req={"type": "object",
                 "required": ["messages"],
                 "properties": {"messages": {"type": "array"}}})},
        # -- qdrant compat ---------------------------------------------------
        "/collections": {"get": _op(
            "Qdrant-compatible API root: list collections. Collection CRUD, "
            "points upsert/search/scroll and snapshots live under "
            "/collections/{name}/... exactly as in the Qdrant REST API.",
            tag="qdrant")},
        # -- mcp -------------------------------------------------------------
        "/mcp": {"post": _op(
            "Model Context Protocol endpoint (JSON-RPC: initialize, "
            "tools/list, tools/call)",
            tag="mcp",
            req={"type": "object",
                 "properties": {"jsonrpc": {"type": "string"},
                                "method": {"type": "string"},
                                "params": {"type": "object"},
                                "id": {}}})},
        # -- docs ------------------------------------------------------------
        "/openapi.json": {"get": _op(
            "This document (JSON)", tag="docs", auth=False)},
        "/openapi.yaml": {"get": _op(
            "This document (YAML)", tag="docs", auth=False)},
        "/docs": {"get": _op(
            "Embedded API explorer (self-contained HTML)", tag="docs",
            auth=False)},
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "NornicDB-TPU HTTP API",
            "description": (
                "Graph + vector memory database on a CUDA card. The HTTP "
                "surface mirrors the reference's REST API "
                "(docs/api-reference/openapi.yaml): Neo4j HTTP tx, hybrid "
                "search, auth/RBAC, admin, GDPR, GraphQL, Qdrant compat, "
                "MCP, and the Heimdall assistant."
            ),
            "version": version,
        },
        "servers": [{"url": "/"}],
        "components": {
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer",
                               "bearerFormat": "JWT"},
                "basicAuth": {"type": "http", "scheme": "basic"},
                "cookieAuth": {"type": "apiKey", "in": "cookie",
                               "name": "nornicdb_token"},
            },
        },
        "paths": paths,
    }


def to_yaml(spec: dict) -> str:
    """Serialize without requiring PyYAML at runtime (it is present in the
    image, but the spec only needs plain mappings/lists/scalars)."""
    try:
        import yaml

        return yaml.safe_dump(spec, sort_keys=False, allow_unicode=True)
    except ImportError:  # pragma: no cover
        return json.dumps(spec, indent=2)  # JSON is valid YAML


@functools.lru_cache(maxsize=4)
def spec_yaml(version: str = "0.4.0") -> str:
    """Cached YAML bytes for the hot unauthenticated GET."""
    return to_yaml(build_spec(version))


DOCS_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>NornicDB-TPU API</title>
<style>
  :root { --bg:#11151c; --panel:#1a2029; --fg:#d8dee9; --accent:#5fb3b3;
          --muted:#6c7a89; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:14px/1.5 ui-monospace, Menlo, monospace; padding:20px; }
  h1 { color:var(--accent); font-size:18px; }
  .tag { margin:18px 0 6px; color:var(--accent); text-transform:uppercase;
         letter-spacing:1px; font-size:12px; }
  .op { background:var(--panel); border-radius:6px; margin:6px 0;
        padding:8px 12px; cursor:pointer; }
  .m { display:inline-block; width:52px; font-weight:bold; }
  .m.get { color:#a3be8c; } .m.post { color:#88c0d0; }
  .m.put { color:#ebcb8b; } .m.delete { color:#bf616a; }
  .path { color:var(--fg); }
  .sum { color:var(--muted); margin-left:8px; }
  pre { background:#0d1117; border-radius:6px; padding:10px;
        overflow:auto; display:none; white-space:pre-wrap; }
  .op.open pre { display:block; }
</style>
</head>
<body>
<h1>NornicDB-TPU API</h1>
<p><a style="color:var(--accent)" href="/openapi.yaml">openapi.yaml</a> ·
   <a style="color:var(--accent)" href="/openapi.json">openapi.json</a></p>
<div id="ops">loading…</div>
<script>
fetch('/openapi.json').then(r => r.json()).then(spec => {
  const byTag = {};
  for (const [path, methods] of Object.entries(spec.paths)) {
    for (const [method, op] of Object.entries(methods)) {
      const tag = (op.tags || ['other'])[0];
      (byTag[tag] = byTag[tag] || []).push({path, method, op});
    }
  }
  const root = document.getElementById('ops');
  root.innerHTML = '';
  for (const [tag, ops] of Object.entries(byTag)) {
    const h = document.createElement('div');
    h.className = 'tag'; h.innerText = tag;
    root.appendChild(h);
    for (const {path, method, op} of ops) {
      const d = document.createElement('div');
      d.className = 'op';
      const detail = {summary: op.summary, description: op.description,
                      parameters: op.parameters,
                      requestBody: op.requestBody, responses: op.responses};
      d.innerHTML = '<span class="m ' + method + '">' +
        method.toUpperCase() + '</span><span class="path"></span>' +
        '<span class="sum"></span><pre></pre>';
      d.querySelector('.path').innerText = path;
      d.querySelector('.sum').innerText = op.summary || '';
      d.querySelector('pre').innerText = JSON.stringify(detail, null, 2);
      d.addEventListener('click', () => d.classList.toggle('open'));
      root.appendChild(d);
    }
  }
});
</script>
</body>
</html>
"""
