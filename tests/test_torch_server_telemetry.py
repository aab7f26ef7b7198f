"""Telemetry of the port's servers on the CPU: the ``TestHttpTelemetry``,
``TestPrometheusGolden`` and ``TestBoltTrace`` cases of
``tests/test_telemetry.py`` against the port's ``HttpServer`` and Bolt
session, with only their imports and the device argument changed. The
strict exposition parser is the JAX package's library code
(``telemetry/promparse.py``); the port has no copy of it yet (ROADMAP
A6d), and these tests only read its result.
"""

from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.request

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.db import Config
from nornicdb_tpu_torch.embed.base import HashEmbedder
from nornicdb_tpu_torch.server.http import HttpServer
from nornicdb_tpu_torch.telemetry.slowlog import slow_log
from nornicdb_tpu_torch.telemetry.tracing import (
    format_traceparent,
    parse_traceparent,
    tracer,
)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """The tracer/slow-log singletons are process-global; every test starts
    from an empty ring and the default thresholds."""
    tracer.clear()
    slow_log.clear()
    slow_log.recorded = 0
    old_threshold = slow_log.threshold_s
    old_enabled, old_rate = tracer.enabled, tracer.sample_rate
    yield
    tracer.clear()
    slow_log.clear()
    slow_log.configure(threshold_s=old_threshold)
    tracer.configure(enabled=old_enabled, sample_rate=old_rate)


# ---------------------------------------------------------------- HTTP e2e
def _span_index(entry):
    return {s["span_id"]: s for s in entry["spans"]}


def _is_ancestor(entry, ancestor_name: str, descendant_name: str) -> bool:
    """True if some span named ancestor_name is an ancestor of some span
    named descendant_name in the recorded trace."""
    by_id = _span_index(entry)
    for s in entry["spans"]:
        if s["name"] != descendant_name:
            continue
        cur = s
        while cur is not None:
            if cur["name"] == ancestor_name:
                return True
            cur = by_id.get(cur["parent_id"] or "")
    return False


@pytest.fixture
def traced_server(tmp_path):
    """Durable (WAL) engine with synchronous writes so storage spans land
    on the request thread, plus an embedder for the search stack."""
    # inference off: auto-TLP would run a similarity search right after
    # embedding and pay the first device sync OUTSIDE the traced request
    db = nornicdb_tpu_torch.open_db(
        str(tmp_path / "db"),
        Config(async_writes=False, inference_enabled=False),
        device="cpu",
    )
    db.set_embedder(HashEmbedder(32))
    server = HttpServer(db, port=0)
    server.start()
    yield db, server
    server.stop()
    db.close()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    return urllib.request.urlopen(req, timeout=30)


def _wait_trace(trace_id: str, timeout: float = 5.0):
    """The root span closes (and the trace rings) a hair AFTER the response
    bytes reach the client — poll instead of racing the handler thread."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        entry = tracer.trace(trace_id)
        if entry is not None:
            return entry
        time.sleep(0.01)
    return None


def _get_json(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as resp:
        return json.loads(resp.read())


class TestHttpTelemetry:
    def test_traceparent_ingested_and_echoed(self, traced_server):
        db, srv = traced_server
        want = "ab" * 16
        resp = _post(
            srv.port, "/db/neo4j/tx/commit",
            {"statements": [{"statement": "RETURN 1"}]},
            headers={"traceparent": format_traceparent(want, "cd" * 8)},
        )
        echoed = resp.headers.get("traceparent")
        assert echoed is not None and parse_traceparent(echoed)[0] == want
        # the incoming trace id keys the recorded trace: every span below
        # (ingress, executor) was recorded under it
        entry = _wait_trace(want)
        assert entry is not None and entry["spans"]
        assert {"http.POST", "cypher.execute"} <= {
            s["name"] for s in entry["spans"]
        }

    def test_http_root_is_ancestor_of_executor_and_storage(self, traced_server):
        db, srv = traced_server
        want = "cd" * 16
        _post(
            srv.port, "/db/neo4j/tx/commit",
            {"statements": [
                {"statement": "CREATE (:Traced {k: 1}) RETURN 1"}]},
            headers={"traceparent": format_traceparent(want, "ab" * 8)},
        )
        entry = _wait_trace(want)
        assert entry is not None
        # end-to-end causality: HTTP ingress -> executor -> WAL append
        assert _is_ancestor(entry, "http.POST", "cypher.execute")
        assert _is_ancestor(entry, "cypher.execute", "wal.append")
        assert _is_ancestor(entry, "http.POST", "wal.append")

    def test_device_sync_span_under_search_request(self, traced_server):
        db, srv = traced_server
        db.store("telemetry document for device sync")
        db.process_pending_embeddings()
        want = "ef" * 16
        _post(
            srv.port, "/nornicdb/search",
            {"query": "telemetry document", "limit": 3},
            headers={"traceparent": format_traceparent(want, "ab" * 8)},
        )
        entry = _wait_trace(want)
        assert entry is not None
        names = {s["name"] for s in entry["spans"]}
        assert "search.rank" in names
        assert "device.sync" in names
        assert _is_ancestor(entry, "http.POST", "device.sync")

    def test_admin_traces_endpoints(self, traced_server):
        db, srv = traced_server
        _post(srv.port, "/db/neo4j/tx/commit",
              {"statements": [{"statement": "RETURN 1"}]})
        # the root span rings a hair after the response bytes reach the
        # client (see _wait_trace) — poll the listing instead of racing
        # the handler thread
        deadline = time.monotonic() + 5.0
        while True:
            listing = _get_json(srv.port, "/admin/traces")
            if listing["traces"] or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        assert listing["traces"], "no traces recorded"
        tid = listing["traces"][0]["trace_id"]
        tree = _get_json(srv.port, f"/admin/traces/{tid}")
        assert tree["trace_id"] == tid and tree["tree"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get_json(srv.port, "/admin/traces/ffffffffffffffff")
        assert exc.value.code == 404

    def test_admin_slow_queries_endpoint(self, traced_server):
        db, srv = traced_server
        slow_log.configure(threshold_s=1e-9)
        _post(srv.port, "/db/neo4j/tx/commit",
              {"statements": [{"statement": "CREATE (:Slow {s: 'val'})"}]})
        body = _get_json(srv.port, "/admin/slow-queries")
        assert body["recorded"] >= 1
        assert body["slow_queries"][0]["trace_id"] is not None
        assert "val" not in json.dumps(body["slow_queries"])

    def test_metrics_histograms_present(self, traced_server):
        db, srv = traced_server
        _post(srv.port, "/db/neo4j/tx/commit",
              {"statements": [{"statement": "RETURN 1"}]})
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30
        ) as resp:
            text = resp.read().decode()
        for name in (
            "nornicdb_http_request_seconds",
            "nornicdb_cypher_stage_seconds",
            "nornicdb_wal_append_seconds",
            "nornicdb_device_sync_seconds",
            "nornicdb_search_queue_wait_seconds",
            "nornicdb_search_device_seconds",
        ):
            assert f"# TYPE {name} histogram" in text, name
        assert 'nornicdb_cypher_stage_seconds_bucket{stage="parse"' in text


# ------------------------------------------------------- golden exposition
# The strict parser is now library code (telemetry/promparse.py) shared
# with the fleet federation merge and the CI smoke script — this suite
# remains its golden consumer.
from nornicdb_tpu.telemetry.promparse import (  # noqa: E402
    parse_prometheus_strict,
)


class TestPrometheusGolden:
    @pytest.fixture
    def full_stack_server(self, tmp_path):
        """Force every documented subsystem live so the whole metric
        catalog renders: WAL engine, embed worker, device corpus + batcher,
        adjacency snapshot, traced HTTP request, slow query, heimdall."""
        from nornicdb_tpu_torch.search.service import SearchConfig

        # register the bolt/grpc ingress families even if no such server
        # runs in this process
        import nornicdb_tpu_torch.server.bolt  # noqa: F401
        import nornicdb_tpu_torch.server.grpc_search  # noqa: F401

        db = nornicdb_tpu_torch.open_db(
            str(tmp_path / "db"), Config(async_writes=True), device="cpu"
        )
        db.set_embedder(HashEmbedder(32))
        db.search.config = SearchConfig(batching_enabled=True)
        server = HttpServer(db, port=0)
        server.start()
        slow_log.configure(threshold_s=1e-9)
        db.store("golden exposition corpus doc")
        db.process_pending_embeddings()
        _post(server.port, "/db/neo4j/tx/commit", {"statements": [
            {"statement":
             "CREATE (:G {k: 1})-[:R]->(:G {k: 2}) RETURN 1"}]})
        _post(server.port, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "MATCH (a:G)-[*1..2]->(b) RETURN count(*)"}]})
        _post(server.port, "/nornicdb/search",
              {"query": "golden exposition", "limit": 3})
        db.heimdall.chat([{"role": "user", "content": "hello"}])
        db.flush()
        yield db, server
        server.stop()
        db.close()

    def test_exposition_parses_strict(self, full_stack_server):
        db, srv = full_stack_server
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30
        ) as resp:
            assert "text/plain" in resp.headers.get("Content-Type", "")
            text = resp.read().decode()
        types, samples = parse_prometheus_strict(text)
        assert types and samples

    def test_every_documented_metric_exists(self, full_stack_server):
        """docs/observability.md's catalog IS the contract: every
        `nornicdb_*`/`heimdall_*` name in the doc must exist in a live
        exposition (and the doc must not be empty of names)."""
        import os

        doc = open(os.path.join(os.path.dirname(__file__), "..",
                                "docs", "observability.md")).read()
        documented = set(re.findall(
            r"`((?:nornicdb|heimdall)_[a-z0-9_]+)`", doc
        ))
        assert len(documented) >= 20, "metric catalog looks truncated"
        db, srv = full_stack_server
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30
        ) as resp:
            text = resp.read().decode()
        types, _ = parse_prometheus_strict(text)
        missing = documented - set(types)
        assert not missing, f"documented but not exposed: {sorted(missing)}"

    def test_legacy_names_still_served(self, full_stack_server):
        db, srv = full_stack_server
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30
        ) as resp:
            text = resp.read().decode()
        for name in (
            "nornicdb_uptime_seconds", "nornicdb_requests_total",
            "nornicdb_errors_total", "nornicdb_nodes", "nornicdb_edges",
            "nornicdb_pending_embeddings", "nornicdb_slow_queries_total",
            "nornicdb_embeddings_processed_total",
            "nornicdb_device_sync_bytes_total",
            "nornicdb_device_sync_patches_total",
            "nornicdb_adjacency_builds_total", "nornicdb_adjacency_bytes",
            "heimdall_chat_requests",
        ):
            assert re.search(rf"^{name}(\{{| )", text, re.M), name


# ---------------------------------------------------------------- bolt
class TestBoltTrace:
    def test_run_starts_trace_with_tx_metadata_traceparent(self):
        from nornicdb_tpu_torch.server.bolt import BoltSession, MSG_RUN, MSG_SUCCESS

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            class FakeServer:
                auth_required = False
                authenticator = None
                session_executor_factory = None

                @staticmethod
                def executor_fn(q, p, d):
                    return db.executor.execute(q, p)

            session = BoltSession(FakeServer())
            want = "aa" * 16
            out = session.handle(MSG_RUN, [
                "RETURN 1", {},
                {"tx_metadata":
                 {"traceparent": format_traceparent(want, "bb" * 8)}},
            ])
            assert out[0][0] == MSG_SUCCESS
            entry = tracer.trace(want)
            assert entry is not None
            assert _is_ancestor(entry, "bolt.run", "cypher.execute")
        finally:
            db.close()


