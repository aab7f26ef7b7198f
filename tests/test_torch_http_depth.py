"""HTTP API depth (ref: pkg/server/server_test.go 2,024 LoC +
multi_database_e2e_test.go 1,394 LoC — the reference's transaction-API
matrix, per-database routing, admin/stats shapes, GDPR endpoints, and
error contracts).

The port's copy of ``tests/test_http_depth.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
"""

import json
import urllib.error
import urllib.request

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.server import HttpServer


@pytest.fixture(scope="module")
def http_db():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    db.set_embedder(HashEmbedder(32))
    srv = HttpServer(db, port=0)
    srv.start()
    yield db, srv
    srv.stop()
    db.close()


def _post(srv, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        resp = urllib.request.urlopen(req, timeout=30)
        return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(srv, path):
    try:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}", timeout=30)
        return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class TestTxCommitAPI:
    """ref: Neo4j HTTP tx API (server_db.go) — statement batches, params,
    row+meta shape, and the error contract (errors array, not a 500)."""

    def test_multi_statement_batch_runs_in_order(self, http_db):
        db, srv = http_db
        status, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "CREATE (n:TxApi {seq: 1})"},
            {"statement": "CREATE (n:TxApi {seq: 2})"},
            {"statement": "MATCH (n:TxApi) RETURN count(n) AS c"},
        ]})
        assert status == 200
        assert body["errors"] == []
        assert body["results"][2]["data"][0]["row"] == [2]

    def test_parameters_of_every_json_type(self, http_db):
        db, srv = http_db
        params = {"i": 7, "f": 1.5, "s": "str", "b": True, "n": None,
                  "l": [1, 2], "m": {"k": "v"}}
        status, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "RETURN $i, $f, $s, $b, $n, $l, $m",
             "parameters": params},
        ]})
        assert status == 200
        assert body["results"][0]["data"][0]["row"] == \
            [7, 1.5, "str", True, None, [1, 2], {"k": "v"}]

    def test_statement_error_reports_neo_code_and_continues_contract(
            self, http_db):
        db, srv = http_db
        status, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "THIS IS NOT CYPHER"},
        ]})
        assert status == 200  # tx API errors ride the errors array
        assert body["errors"]
        assert body["errors"][0]["code"].startswith("Neo.ClientError")

    def test_batch_atomicity_on_mid_batch_failure(self, http_db):
        """A failing statement mid-batch must not leave earlier statements'
        writes behind (each commit request is one implicit transaction)."""
        db, srv = http_db
        _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "CREATE (n:Atomic {v: 1})"},
            {"statement": "SYNTAX ERROR HERE"},
        ]})
        status, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "MATCH (n:Atomic) RETURN count(n) AS c"},
        ]})
        assert body["results"][0]["data"][0]["row"] == [0]

    def test_row_meta_and_columns_shape(self, http_db):
        db, srv = http_db
        status, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "CREATE (n:Shaped {k: 'v'}) RETURN n, 1 AS one"},
        ]})
        res = body["results"][0]
        assert res["columns"] == ["n", "one"]
        row = res["data"][0]["row"]
        assert row[0]["properties"] == {"k": "v"}
        assert "Shaped" in row[0]["labels"]
        assert row[1] == 1
        assert "stats" in res

    def test_constraints_persist_across_tx_requests_on_secondary_db(
            self, http_db):
        """A constraint created by one /tx/commit request must bind later
        requests — per-request sessions share the database's cached
        schema, they don't rebuild a blank one."""
        db, srv = http_db
        db.database_manager.create_database("schemadb")
        try:
            _post(srv, "/db/schemadb/tx/commit", {"statements": [
                {"statement": "CREATE CONSTRAINT u FOR (n:U) "
                              "REQUIRE n.email IS UNIQUE"},
                {"statement": "CREATE (n:U {email: 'a@x'})"}]})
            _, body = _post(srv, "/db/schemadb/tx/commit", {"statements": [
                {"statement": "CREATE (n:U {email: 'a@x'})"}]})
            assert body["errors"], "duplicate must violate the constraint"
            _, body = _post(srv, "/db/schemadb/tx/commit", {"statements": [
                {"statement": "MATCH (n:U) RETURN count(n) AS c"}]})
            assert body["results"][0]["data"][0]["row"] == [1]
        finally:
            db.database_manager.drop_database("schemadb")

    def test_malformed_statements_entry_rolls_back(self, http_db):
        """A non-object statements entry mid-batch must roll back earlier
        writes, not 500 with them half-applied."""
        db, srv = http_db
        status, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "CREATE (n:BadBatch)"},
            "oops-not-an-object"]})
        assert status == 200
        assert body["errors"][0]["code"] == \
            "Neo.ClientError.Request.InvalidFormat"
        _, body = _post(srv, "/db/neo4j/tx/commit", {"statements": [
            {"statement": "MATCH (n:BadBatch) RETURN count(n) AS c"}]})
        assert body["results"][0]["data"][0]["row"] == [0]

    def test_unknown_database_is_client_error(self, http_db):
        """Only databases created via CREATE DATABASE (plus the default +
        system) exist — an unseen /db/{name} is a client error, it must not
        silently materialize."""
        db, srv = http_db
        status, body = _post(srv, "/db/ghost-http-db/tx/commit",
                             {"statements": [{"statement": "RETURN 1"}]})
        assert status == 400
        assert "not found" in json.dumps(body)

    def test_per_database_routing_isolates_data(self, http_db):
        """ref: multi_database_e2e_test.go — same statement, different
        /db/{name} prefix, isolated results."""
        db, srv = http_db
        db.database_manager.create_database("depthdb")
        try:
            _post(srv, "/db/depthdb/tx/commit", {"statements": [
                {"statement": "CREATE (n:OnlyHere)"}]})
            _, there = _post(srv, "/db/depthdb/tx/commit", {"statements": [
                {"statement": "MATCH (n:OnlyHere) RETURN count(n) AS c"}]})
            _, here = _post(srv, "/db/neo4j/tx/commit", {"statements": [
                {"statement": "MATCH (n:OnlyHere) RETURN count(n) AS c"}]})
            assert there["results"][0]["data"][0]["row"] == [1]
            assert here["results"][0]["data"][0]["row"] == [0]
        finally:
            db.database_manager.drop_database("depthdb")


class TestOperationalEndpoints:
    def test_status_shape(self, http_db):
        db, srv = http_db
        status, body = _get(srv, "/status")
        assert status == 200
        assert {"nodes", "edges"} <= set(body) or "storage" in body

    def test_metrics_prometheus_format(self, http_db):
        db, srv = http_db
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30)
        text = resp.read().decode()
        assert "# TYPE" in text
        assert "nornicdb" in text

    def test_admin_stats(self, http_db):
        db, srv = http_db
        status, body = _get(srv, "/admin/stats")
        assert status == 200
        assert isinstance(body, dict) and body

    def test_v1_models_lists_heimdall(self, http_db):
        db, srv = http_db
        status, body = _get(srv, "/v1/models")
        assert status == 200
        ids = [m["id"] for m in body.get("data", [])]
        assert "heimdall" in ids

    def test_docs_and_openapi_served(self, http_db):
        db, srv = http_db
        for path in ("/docs", "/openapi.yaml"):
            resp = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}{path}", timeout=30)
            assert resp.status == 200
            assert resp.read()


class TestSearchAndSimilar:
    def test_search_then_similar_flow(self, http_db):
        db, srv = http_db
        a = db.store("unique handle for similarity")
        db.store("unrelated content entirely")
        db.process_pending_embeddings()
        status, body = _post(srv, "/nornicdb/search",
                             {"query": "unique handle", "limit": 5})
        assert status == 200
        hits = body.get("results", body.get("hits", []))
        assert hits and hits[0]["id"] == a.id
        status, body = _post(srv, "/nornicdb/similar",
                             {"id": a.id, "limit": 5})
        assert status == 200

    def test_embed_endpoint_returns_vector(self, http_db):
        db, srv = http_db
        status, body = _post(srv, "/nornicdb/embed", {"text": "hello"})
        assert status == 200
        vec = body.get("embedding", body.get("vector"))
        assert isinstance(vec, list) and len(vec) == 32

    def test_search_missing_query_returns_empty(self, http_db):
        db, srv = http_db
        status, body = _post(srv, "/nornicdb/search", {})
        assert status == 200
        assert body["results"] == []


class TestGdpr:
    """ref: gdpr endpoints — subject-based (id or subject/owner property
    match), erasure via request->confirm workflow (pkg/retention)."""

    def test_export_returns_subject_data(self, http_db):
        db, srv = http_db
        db.store("subject data", properties={"owner": "alice-gdpr"})
        status, body = _post(srv, "/gdpr/export", {"subject": "alice-gdpr"})
        assert status == 200
        assert "subject data" in json.dumps(body)

    def test_export_without_subject_is_client_error(self, http_db):
        db, srv = http_db
        status, _ = _post(srv, "/gdpr/export", {})
        assert status == 400

    def test_delete_requires_confirm_then_erases(self, http_db):
        db, srv = http_db
        n = db.store("to be erased", properties={"subject": "bob-gdpr"})
        status, body = _post(srv, "/gdpr/delete", {"subject": "bob-gdpr"})
        assert status == 202  # two-phase: request acknowledged, not executed
        assert db.storage.get_node(n.id)
        status, body = _post(srv, "/gdpr/delete",
                             {"subject": "bob-gdpr", "confirm": True})
        assert status == 200
        from nornicdb_tpu_torch.errors import NotFoundError

        with pytest.raises(NotFoundError):
            db.storage.get_node(n.id)


class TestErrorContracts:
    def test_unknown_path_404_json(self, http_db):
        db, srv = http_db
        status, body = _get(srv, "/no/such/path")
        assert status == 404

    def test_malformed_json_body_is_client_error(self, http_db):
        db, srv = http_db
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/db/neo4j/tx/commit",
            data=b"{not json", headers={"Content-Type": "application/json"},
            method="POST")
        try:
            resp = urllib.request.urlopen(req, timeout=30)
            status = resp.status
        except urllib.error.HTTPError as e:
            status = e.code
        assert 400 <= status < 500

    def test_method_not_allowed_on_post_only(self, http_db):
        db, srv = http_db
        status, _ = _get(srv, "/nornicdb/search")
        assert status in (400, 404, 405)
