"""Protocol server tests: PackStream codec, Bolt over a raw socket (the
official neo4j driver is not in this image, so the tests speak the wire
protocol directly — same approach as the reference's javascript_compat_test),
HTTP tx API + search + MCP, auth.

The port's copy of ``tests/test_servers.py``: the JAX cases with only their
imports and the device argument (``device="cpu"``) changed.
``TestGrpcSearch`` (the native gRPC search service) is in
``tests/test_torch_grpc_search.py``, ``TestHttpEmbedders`` in
``tests/test_torch_cli_embed.py``.
``TestGraphqlAndQdrantRoutes`` holds ``/graphql`` and ``/collections*`` to
the JAX server's answers.
"""

import base64
import json
import socket
import struct
import time
import urllib.error
import urllib.request

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.auth import Authenticator, ROLE_ADMIN, ROLE_VIEWER
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.errors import AuthError
from nornicdb_tpu_torch.server import BoltServer, HttpServer
from nornicdb_tpu_torch.server.packstream import Structure, pack, to_wire, unpack
from nornicdb_tpu_torch.storage import MemoryEngine, Node


class TestPackStream:
    @pytest.mark.parametrize(
        "value",
        [
            None, True, False, 0, 1, -1, 42, -17, 127, -128, 1000, -1000,
            2**31, -(2**31) - 1, 3.14, -2.5, "", "hello", "x" * 300,
            [], [1, 2, 3], ["a", [1, None]], {}, {"k": "v"},
            {"nested": {"list": [1, 2]}}, b"\x01\x02",
        ],
    )
    def test_roundtrip(self, value):
        assert unpack(pack(value)) == value

    def test_structure_roundtrip(self):
        s = Structure(0x4E, [1, ["Person"], {"name": "Ada"}, "id-1"])
        assert unpack(pack(s)) == s

    def test_node_to_wire(self):
        n = Node(id="n1", labels=["P"], properties={"x": 1})
        s = to_wire(n)
        assert s.tag == 0x4E
        assert s.fields[1] == ["P"]
        assert s.fields[3] == "n1"  # element_id

    def test_large_string_and_list(self):
        big = "y" * 70000
        assert unpack(pack(big)) == big
        lst = list(range(300))
        assert unpack(pack(lst)) == lst


class _BoltClient:
    """Minimal Bolt 4.4 client for tests."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.sock.sendall(b"\x60\x60\xb0\x17")
        # propose 4.4 only
        self.sock.sendall(
            struct.pack(">I", (4 << 0) | (4 << 8)) + b"\x00" * 12
        )
        chosen = self._recv_exact(4)
        assert chosen[3] == 4, f"server picked {chosen!r}"

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("closed")
            buf += part
        return buf

    def send(self, tag, fields):
        payload = pack(Structure(tag, fields))
        msg = b""
        for i in range(0, len(payload), 0xFFFF):
            part = payload[i : i + 0xFFFF]
            msg += struct.pack(">H", len(part)) + part
        msg += b"\x00\x00"
        self.sock.sendall(msg)

    def recv_message(self):
        chunks = b""
        while True:
            (size,) = struct.unpack(">H", self._recv_exact(2))
            if size == 0:
                if chunks:
                    return unpack(chunks)
                continue
            chunks += self._recv_exact(size)

    def run(self, query, params=None):
        self.send(0x10, [query, params or {}, {}])
        success = self.recv_message()
        assert success.tag == 0x70, success
        columns = success.fields[0].get("fields", [])
        self.send(0x3F, [{"n": -1}])
        rows = []
        while True:
            msg = self.recv_message()
            if msg.tag == 0x71:
                rows.append(msg.fields[0])
            elif msg.tag == 0x70:
                return columns, rows, msg.fields[0]
            else:
                raise AssertionError(f"unexpected {msg}")

    def close(self):
        self.sock.close()


@pytest.fixture
def bolt_db():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    server = BoltServer(
        lambda q, p, d: (db.executor_for(d) if d else db.executor).execute(q, p),
        port=0,
        session_executor_factory=db.session_executor,
    )
    server.start()
    yield db, server
    server.stop()
    db.close()


class TestBolt:
    def test_handshake_hello_run_pull(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"user_agent": "test/1.0", "scheme": "none"}])
        hello = c.recv_message()
        assert hello.tag == 0x70
        assert "NornicDB-TPU" in hello.fields[0]["server"]
        cols, rows, summary = c.run("RETURN 1 AS one, 'two' AS two")
        assert cols == ["one", "two"]
        assert rows == [[1, "two"]]
        c.close()

    def test_create_and_match_nodes(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"scheme": "none"}])
        c.recv_message()
        _, _, summary = c.run("CREATE (:City {name: 'Oslo', pop: 709037})")
        assert summary["stats"]["nodes_created"] == 1
        cols, rows, _ = c.run("MATCH (c:City) RETURN c")
        node = rows[0][0]
        assert node.tag == 0x4E
        assert node.fields[1] == ["City"]
        assert node.fields[2]["name"] == "Oslo"
        c.close()

    def test_parameters_and_types(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"scheme": "none"}])
        c.recv_message()
        cols, rows, _ = c.run(
            "RETURN $int + 1 AS i, $str AS s, $list AS l, $map.k AS m, $f AS f",
            {"int": 41, "str": "hi", "list": [1, 2], "map": {"k": "v"}, "f": 1.5},
        )
        assert rows == [[42, "hi", [1, 2], "v", 1.5]]
        c.close()

    def test_failure_then_reset(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"scheme": "none"}])
        c.recv_message()
        c.send(0x10, ["THIS IS NOT CYPHER", {}, {}])
        failure = c.recv_message()
        assert failure.tag == 0x7F
        assert "SyntaxError" in failure.fields[0]["code"]
        # subsequent messages ignored until RESET
        c.send(0x3F, [{"n": -1}])
        assert c.recv_message().tag == 0x7E
        c.send(0x0F, [])
        assert c.recv_message().tag == 0x70
        cols, rows, _ = c.run("RETURN 1 AS x")
        assert rows == [[1]]
        c.close()

    def test_explicit_transaction(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"scheme": "none"}])
        c.recv_message()
        c.send(0x11, [{}])  # BEGIN
        assert c.recv_message().tag == 0x70
        c.run("CREATE (:TxNode)")
        c.send(0x13, [{}])  # ROLLBACK
        assert c.recv_message().tag == 0x70
        cols, rows, _ = c.run("MATCH (t:TxNode) RETURN count(t)")
        assert rows == [[0]]
        c.close()

    def test_route_message(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"scheme": "none"}])
        c.recv_message()
        c.send(0x66, [{}, [], None])
        msg = c.recv_message()
        assert msg.tag == 0x70
        roles = {s["role"] for s in msg.fields[0]["rt"]["servers"]}
        assert roles == {"READ", "WRITE", "ROUTE"}
        c.close()


@pytest.fixture
def http_db():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    db.set_embedder(HashEmbedder(64))
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
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
        return resp.read().decode(), resp.headers.get("Content-Type", "")


class TestHttp:
    def test_health_status_metrics(self, http_db):
        db, server = http_db
        body, _ = _get(server.port, "/health")
        assert json.loads(body)["status"] == "ok"
        body, _ = _get(server.port, "/status")
        assert json.loads(body)["status"] == "running"
        body, ctype = _get(server.port, "/metrics")
        assert "nornicdb_nodes" in body and "text/plain" in ctype

    def test_tx_commit_api(self, http_db):
        db, server = http_db
        out = _post(
            server.port,
            "/db/neo4j/tx/commit",
            {
                "statements": [
                    {"statement": "CREATE (:P {name: $n}) RETURN 1",
                     "parameters": {"n": "Ada"}},
                    {"statement": "MATCH (p:P) RETURN p.name, p"},
                ]
            },
        )
        assert out["errors"] == []
        assert out["results"][1]["data"][0]["row"][0] == "Ada"
        assert out["results"][1]["data"][0]["row"][1]["properties"]["name"] == "Ada"

    def test_tx_commit_error_shape(self, http_db):
        db, server = http_db
        out = _post(
            server.port, "/db/neo4j/tx/commit",
            {"statements": [{"statement": "NOT CYPHER"}]},
        )
        assert out["errors"] and "SyntaxError" in out["errors"][0]["code"]

    def test_search_endpoint(self, http_db):
        db, server = http_db
        db.store("the TPU accelerates vector search")
        db.process_pending_embeddings()
        out = _post(server.port, "/nornicdb/search", {"query": "TPU vector", "limit": 3})
        assert out["results"] and "TPU" in out["results"][0]["content"]

    def test_search_response_cache_invalidated_by_mutation(self, http_db):
        # the HTTP byte cache must die on index mutation (generation bump),
        # so new documents appear immediately despite the 1s TTL
        db, server = http_db
        db.store("alpha document about caching")
        db.process_pending_embeddings()
        body = {"query": "caching document", "limit": 5}
        first = _post(server.port, "/nornicdb/search", body)
        again = _post(server.port, "/nornicdb/search", body)  # cache hit
        assert again == first
        db.store("beta document about caching too")
        db.process_pending_embeddings()
        after = _post(server.port, "/nornicdb/search", body)
        assert len(after["results"]) == len(first["results"]) + 1

    def test_embed_endpoint(self, http_db):
        db, server = http_db
        out = _post(server.port, "/nornicdb/embed", {"text": "hello"})
        assert out["dimensions"] == 64

    def test_mcp_flow(self, http_db):
        db, server = http_db
        out = _post(server.port, "/mcp", {"jsonrpc": "2.0", "id": 1, "method": "tools/list"})
        names = [t["name"] for t in out["result"]["tools"]]
        assert names == ["store", "recall", "discover", "link", "task", "tasks"]
        out = _post(
            server.port, "/mcp",
            {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
             "params": {"name": "store", "arguments": {"content": "mcp memory"}}},
        )
        stored = json.loads(out["result"]["content"][0]["text"])
        assert "id" in stored
        out = _post(
            server.port, "/mcp",
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
             "params": {"name": "task", "arguments": {"title": "write tests"}}},
        )
        out = _post(
            server.port, "/mcp",
            {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
             "params": {"name": "tasks", "arguments": {}}},
        )
        tasks = json.loads(out["result"]["content"][0]["text"])
        assert tasks and tasks[0]["title"] == "write tests"


class TestAuth:
    def _auth(self):
        eng = MemoryEngine()
        return Authenticator(eng)

    def test_password_hash_verify(self):
        from nornicdb_tpu_torch.auth import hash_password, verify_password

        h = hash_password("s3cret")
        assert verify_password("s3cret", h)
        assert not verify_password("wrong", h)

    def test_create_authenticate_authorize(self):
        auth = self._auth()
        auth.create_user("alice", "pw", ROLE_ADMIN)
        token = auth.authenticate("alice", "pw")
        payload = auth.authorize(token, "admin")
        assert payload["sub"] == "alice"

    def test_wrong_password_and_lockout(self):
        auth = self._auth()
        auth.config.lockout_threshold = 3
        auth.create_user("bob", "pw", ROLE_VIEWER)
        for _ in range(3):
            with pytest.raises(AuthError):
                auth.authenticate("bob", "nope")
        with pytest.raises(AuthError, match="locked"):
            auth.authenticate("bob", "pw")

    def test_rbac_denies(self):
        auth = self._auth()
        auth.create_user("carol", "pw", ROLE_VIEWER)
        token = auth.authenticate("carol", "pw")
        auth.authorize(token, "read")
        with pytest.raises(AuthError):
            auth.authorize(token, "write")

    def test_logout_revokes(self):
        auth = self._auth()
        auth.create_user("dan", "pw", ROLE_ADMIN)
        token = auth.authenticate("dan", "pw")
        auth.logout(token)
        assert auth.validate_token(token) is None

    def test_tampered_token_rejected(self):
        auth = self._auth()
        auth.create_user("eve", "pw", ROLE_VIEWER)
        token = auth.authenticate("eve", "pw")
        h, p, s = token.split(".")
        forged = json.dumps({"sub": "eve", "role": "admin", "exp": 9999999999})
        tampered = f"{h}.{base64.urlsafe_b64encode(forged.encode()).rstrip(b'=').decode()}.{s}"
        assert auth.validate_token(tampered) is None

    def test_http_auth_required(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("admin", "adminpw", ROLE_ADMIN)
        server = HttpServer(db, port=0, authenticator=auth, auth_required=True)
        server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, "/nornicdb/search", {"query": "x"})
            assert e.value.code == 401
            basic = base64.b64encode(b"admin:adminpw").decode()
            out = _post(
                server.port, "/nornicdb/search", {"query": "x"},
                headers={"Authorization": f"Basic {basic}"},
            )
            assert out == {"results": []}
        finally:
            server.stop()
            db.close()

    def test_bolt_auth(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("neo", "matrix", ROLE_ADMIN)
        server = BoltServer(
            lambda q, p, d: db.executor.execute(q, p),
            port=0, authenticator=auth, auth_required=True,
        )
        server.start()
        try:
            c = _BoltClient(server.port)
            c.send(0x01, [{"scheme": "basic", "principal": "neo",
                           "credentials": "wrong"}])
            assert c.recv_message().tag == 0x7F  # FAILURE
            c.close()
            c2 = _BoltClient(server.port)
            c2.send(0x01, [{"scheme": "basic", "principal": "neo",
                            "credentials": "matrix"}])
            assert c2.recv_message().tag == 0x70
            cols, rows, _ = c2.run("RETURN 1 AS ok")
            assert rows == [[1]]
            c2.close()
        finally:
            server.stop()
            db.close()


class TestOAuthToken:
    def test_password_and_client_credentials_grants(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("svc", "secret", ROLE_ADMIN)
        server = HttpServer(db, port=0, authenticator=auth, auth_required=True)
        server.start()
        try:
            out = _post(server.port, "/auth/oauth/token",
                        {"grant_type": "password", "username": "svc",
                         "password": "secret"})
            assert out["token_type"] == "Bearer"
            # the issued token works as a Bearer credential
            out2 = _post(
                server.port, "/nornicdb/search", {"query": "x"},
                headers={"Authorization": f"Bearer {out['access_token']}"},
            )
            assert out2 == {"results": []}
            out3 = _post(server.port, "/auth/oauth/token",
                         {"grant_type": "client_credentials",
                          "client_id": "svc", "client_secret": "secret"})
            assert out3["access_token"]
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, "/auth/oauth/token",
                      {"grant_type": "implicit"})
            assert e.value.code == 400
        finally:
            server.stop()
            db.close()


class TestEmbeddedUI:
    def test_console_served_at_root(self, http_db):
        db, server = http_db
        body, ctype = _get(server.port, "/")
        assert "NornicDB-TPU" in body and "runCypher" in body
        assert "text/html" in ctype
        body2, _ = _get(server.port, "/ui")
        assert body2 == body

    def test_headless_mode(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        server = HttpServer(db, port=0, serve_ui=False)
        server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.port, "/")
            assert e.value.code == 404
        finally:
            server.stop()
            db.close()


class TestGdprEndpoints:
    def test_export_and_delete_flow(self, http_db):
        db, server = http_db
        db.cypher("CREATE (:Doc {owner: 'user-9', content: 'theirs'})")
        db.cypher("CREATE (:Doc {owner: 'else', content: 'not theirs'})")
        out = _post(server.port, "/gdpr/export", {"subject": "user-9"})
        assert len(out["records"]) == 1
        assert out["records"][0]["properties"]["content"] == "theirs"
        # two-phase: first call returns a pending request
        out = _post(server.port, "/gdpr/delete", {"subject": "user-9"})
        assert out["status"] == "pending"
        out = _post(server.port, "/gdpr/delete",
                    {"subject": "user-9", "confirm": True})
        assert out["status"] == "completed" and out["erased"] == 1
        assert db.cypher("MATCH (d:Doc) RETURN count(d)").rows == [[1]]

    def test_security_headers(self, http_db):
        db, server = http_db
        import urllib.request

        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/health"
        ) as resp:
            assert resp.headers["X-Content-Type-Options"] == "nosniff"
            assert resp.headers["X-Frame-Options"] == "DENY"


class TestGraphqlAndQdrantRoutes:
    """``/graphql`` and ``/collections*`` answer as the JAX package's server
    answers the same request, on one keep-alive connection too."""

    @pytest.mark.parametrize("method,path", [
        ("POST", "/graphql"),
        ("GET", "/collections"),
        ("PUT", "/collections/docs"),
        ("POST", "/collections/docs/points/search"),
        ("DELETE", "/collections/docs"),
    ])
    def test_routes_answer_as_the_jax_server(self, http_db, method, path):
        import nornicdb_tpu
        from nornicdb_tpu.server import HttpServer as JaxHttpServer

        _, srv = http_db
        jdb = nornicdb_tpu.open_db("")
        jsrv = JaxHttpServer(jdb, port=0)
        jsrv.start()
        try:
            answers = []
            for port in (jsrv.port, srv.port):
                # the same request twice: the second meets the state the
                # first left (a created or dropped collection)
                for _ in range(2):
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}{path}", data=b"{}",
                        method=method,
                        headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req, timeout=10) as r:
                            answers.append((r.status, json.loads(r.read())))
                    except urllib.error.HTTPError as e:
                        answers.append((e.code, json.loads(e.read())))
        finally:
            jsrv.stop()
            jdb.close()
        assert answers[2:] == answers[:2]
        assert all(code != 501 for code, _ in answers)

    def test_keep_alive_connection_answers_graphql_and_qdrant(self, http_db):
        import http.client

        _, srv = http_db
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        try:
            for method, path, body in (
                    ("PUT", "/collections/docs", {"vectors": {"size": 2}}),
                    ("PUT", "/collections/docs/points", {"points": [
                        {"id": 1, "vector": [1.0, 0.0]}]}),
                    ("POST", "/graphql", {"query": "{ stats { nodes } }"}),
                    ("POST", "/collections/docs/points/search",
                     {"vector": [1.0, 0.0]}),
                    ("POST", "/db/neo4j/tx/commit", {"statements": [
                        {"statement": "RETURN 1 AS one"}]})):
                conn.request(method, path, body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                out = json.loads(resp.read())
                assert resp.status == 200, (path, out)
                if path == "/graphql":
                    assert out == {"data": {"stats": {"nodes": 1}}}
                elif path.endswith("/search"):
                    assert [h["id"] for h in out["result"]] == [1]
            assert out["results"][0]["data"][0]["row"] == [1]
        finally:
            conn.close()


class TestOAuthAuthorizeFlow:
    def test_code_flow(self):
        import urllib.parse

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("app", "apppw", ROLE_ADMIN)
        server = HttpServer(db, port=0, authenticator=auth, auth_required=True)
        server.start()
        try:
            url = (f"http://127.0.0.1:{server.port}/auth/oauth/authorize"
                   "?response_type=code&redirect_uri=http://cb.local/done&state=xyz")
            req = urllib.request.Request(url, method="GET")

            class NoRedirect(urllib.request.HTTPRedirectHandler):
                def redirect_request(self, *a, **k):
                    return None

            opener = urllib.request.build_opener(NoRedirect)
            try:
                opener.open(req)
                raise AssertionError("expected 302")
            except urllib.error.HTTPError as e:
                assert e.code == 302
                loc = e.headers["Location"]
            assert loc.startswith("http://cb.local/done?code=")
            assert "state=xyz" in loc
            code = urllib.parse.parse_qs(urllib.parse.urlparse(loc).query)["code"][0]
            out = _post(server.port, "/auth/oauth/token",
                        {"grant_type": "authorization_code", "code": code,
                         "username": "app", "password": "apppw"})
            assert out["access_token"]
            # a code is single-use
            with pytest.raises(urllib.error.HTTPError) as e2:
                _post(server.port, "/auth/oauth/token",
                      {"grant_type": "authorization_code", "code": code,
                       "username": "app", "password": "apppw"})
            assert e2.value.code == 400
        finally:
            server.stop()
            db.close()


class TestBoltTelemetry:
    def test_telemetry_acknowledged(self, bolt_db):
        db, server = bolt_db
        c = _BoltClient(server.port)
        c.send(0x01, [{"scheme": "none"}])
        c.recv_message()
        c.send(0x54, [1])  # TELEMETRY (Bolt 5.4)
        assert c.recv_message().tag == 0x70
        cols, rows, _ = c.run("RETURN 1 AS x")  # session still healthy
        assert rows == [[1]]
        c.close()


class TestSessionTransactionIsolation:
    def test_concurrent_begin_on_two_sessions(self, bolt_db):
        """Two connections holding explicit transactions must not collide
        (transactions are session-scoped, like Neo4j)."""
        db, server = bolt_db
        c1, c2 = _BoltClient(server.port), _BoltClient(server.port)
        for c in (c1, c2):
            c.send(0x01, [{"scheme": "none"}])
            c.recv_message()
        c1.send(0x11, [{}])  # BEGIN on session 1
        assert c1.recv_message().tag == 0x70
        c2.send(0x11, [{}])  # BEGIN on session 2 — must NOT conflict
        assert c2.recv_message().tag == 0x70
        c1.run("CREATE (:S1)")
        c2.run("CREATE (:S2)")
        c1.send(0x13, [{}])  # ROLLBACK session 1
        assert c1.recv_message().tag == 0x70
        c2.send(0x12, [{}])  # COMMIT session 2
        assert c2.recv_message().tag == 0x70
        cols, rows, _ = c1.run("MATCH (n) WHERE 'S1' IN labels(n) OR 'S2' IN labels(n) "
                               "RETURN labels(n)")
        assert [r[0] for r in rows] == [["S2"]]  # S1 rolled back, S2 kept
        c1.close(); c2.close()


class TestRBACGates:
    """Write-classification gates (advisor round-1 findings): mutating
    procedures must not pass a read-only token (HTTP), and Bolt must enforce
    role permissions, not just authentication."""

    def test_classify_query_text(self):
        from nornicdb_tpu_torch.cypher.executor import classify_query_text

        assert classify_query_text("MATCH (n) RETURN n") == "read"
        assert classify_query_text("CREATE (n)") == "write"
        # CALL of a mutating procedure is a write even with no write keyword
        assert classify_query_text(
            "CALL apoc.trigger.add('t', 'RETURN 1', {})") == "write"
        assert classify_query_text(
            "MATCH (n) CALL apoc.refactor.setType(n, 'X') YIELD rel RETURN rel"
        ) == "write"
        # read-only procedures stay reads
        assert classify_query_text("CALL db.labels()") == "read"
        # unparseable input classifies conservatively
        assert classify_query_text("garbage ( [") == "write"
        # DDL statements are writes; SHOW is a read
        assert classify_query_text("CREATE INDEX FOR (n:P) ON (n.x)") == "write"
        assert classify_query_text("SHOW INDEXES") == "read"

    def test_collect_subquery_rejects_updating_clauses(self):
        """Advisor round-2 high: writes inside COLLECT { } bypassed
        read/write classification. Neo4j rejects updating clauses in
        COLLECT subqueries — so do we, at parse time."""
        import pytest

        from nornicdb_tpu_torch.cypher.executor import classify_query_text
        from nornicdb_tpu_torch.errors import CypherSyntaxError

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            with pytest.raises(CypherSyntaxError):
                db.cypher("RETURN COLLECT { CREATE (n:X) RETURN n.id } AS c")
            with pytest.raises(CypherSyntaxError):
                # nested via CALL { } inside the collect subquery
                db.cypher(
                    "RETURN COLLECT { CALL { CREATE (m:Y) RETURN m } "
                    "RETURN m.id } AS c"
                )
            # nothing executed
            assert db.cypher("MATCH (n:X) RETURN count(n) AS c").rows[0][0] == 0
            # read-only collect subqueries still work
            db.cypher("CREATE (:P {k: 1})")
            r = db.cypher("RETURN COLLECT { MATCH (p:P) RETURN p.k } AS ks")
            assert r.rows[0][0] == [1]
        finally:
            db.close()
        # defense-in-depth: even an AST built without the parse-time gate
        # classifies as a write (RBAC + cacheability stay sound)
        from nornicdb_tpu_torch.cypher import ast
        from nornicdb_tpu_torch.cypher.executor import _is_write_query

        inner = ast.Query(
            clauses=[
                ast.CreateClause(
                    patterns=[
                        ast.PatternPath(
                            elements=[ast.NodePattern(None, ["X"], {})]
                        )
                    ]
                ),
                ast.ReturnClause(items=[ast.ReturnItem(ast.Literal(1), "one")]),
            ]
        )
        outer = ast.Query(
            clauses=[
                ast.ReturnClause(
                    items=[ast.ReturnItem(ast.CollectSubquery(inner), "c")]
                )
            ]
        )
        assert _is_write_query(outer)
        # string form classifies conservatively too (parse rejects -> write)
        assert (
            classify_query_text("RETURN COLLECT { CREATE (n:X) RETURN n.id }")
            == "write"
        )

    def test_composite_drop_alias_requires_constituent(self):
        """Advisor round-2 low: ALTER COMPOSITE ... DROP ALIAS half-applied
        (global alias deleted) when the alias target was not a constituent."""
        import pytest

        from nornicdb_tpu_torch.errors import NotFoundError

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            db.cypher("CREATE DATABASE d1")
            db.cypher("CREATE DATABASE d2")
            db.cypher("CREATE COMPOSITE DATABASE comp")
            db.cypher("CREATE ALIAS a2 FOR DATABASE d2")  # NOT a constituent
            with pytest.raises(NotFoundError):
                db.cypher("ALTER COMPOSITE DATABASE comp DROP ALIAS a2")
            # the global alias survived the failed command
            assert db.database_manager.resolve("a2") == "d2"
        finally:
            db.close()

    def test_http_viewer_cannot_call_mutating_procedure(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("viewer", "pw", ROLE_VIEWER)
        server = HttpServer(db, port=0, authenticator=auth, auth_required=True)
        server.start()
        basic = base64.b64encode(b"viewer:pw").decode()
        hdrs = {"Authorization": f"Basic {basic}"}
        try:
            # reads are allowed for viewers
            out = _post(server.port, "/db/neo4j/tx/commit",
                        {"statements": [{"statement": "RETURN 1 AS x"}]},
                        headers=hdrs)
            assert out["results"][0]["data"][0]["row"] == [1]
            # a CALL of a mutating procedure has no CREATE/SET/... keyword —
            # the old regex classified it read; it must be denied
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, "/db/neo4j/tx/commit",
                      {"statements": [{"statement":
                          "CALL apoc.trigger.add('t', 'RETURN 1', {})"}]},
                      headers=hdrs)
            assert e.value.code == 401
        finally:
            server.stop()
            db.close()

    def test_bolt_viewer_cannot_write(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("ro", "pw", ROLE_VIEWER)
        auth.create_user("rw", "pw", ROLE_ADMIN)
        server = BoltServer(
            lambda q, p, d: db.executor.execute(q, p),
            port=0, authenticator=auth, auth_required=True,
        )
        server.start()
        try:
            c = _BoltClient(server.port)
            c.send(0x01, [{"scheme": "basic", "principal": "ro",
                           "credentials": "pw"}])
            assert c.recv_message().tag == 0x70
            # read works
            cols, rows, _ = c.run("RETURN 1 AS ok")
            assert rows == [[1]]
            # write denied with Unauthorized
            c.send(0x10, ["CREATE (:Sneaky)", {}, {}])
            msg = c.recv_message()
            assert msg.tag == 0x7F
            assert "Unauthorized" in msg.fields[0]["code"]
            c.close()
            # an editor/admin on the same server still writes fine
            c2 = _BoltClient(server.port)
            c2.send(0x01, [{"scheme": "basic", "principal": "rw",
                            "credentials": "pw"}])
            assert c2.recv_message().tag == 0x70
            c2.run("CREATE (:Allowed)")
            c2.close()
            assert db.executor.execute(
                "MATCH (n:Sneaky) RETURN count(n)").rows[0][0] == 0
            assert db.executor.execute(
                "MATCH (n:Allowed) RETURN count(n)").rows[0][0] == 1
        finally:
            server.stop()
            db.close()

    def test_bolt_viewer_cannot_call_mutating_procedure(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("ro2", "pw", ROLE_VIEWER)
        server = BoltServer(
            lambda q, p, d: db.executor.execute(q, p),
            port=0, authenticator=auth, auth_required=True,
        )
        server.start()
        try:
            c = _BoltClient(server.port)
            c.send(0x01, [{"scheme": "basic", "principal": "ro2",
                           "credentials": "pw"}])
            assert c.recv_message().tag == 0x70
            c.send(0x10, ["CALL apoc.trigger.add('t', 'RETURN 1', {})", {}, {}])
            msg = c.recv_message()
            assert msg.tag == 0x7F
            assert "Unauthorized" in msg.fields[0]["code"]
            c.close()
        finally:
            server.stop()
            db.close()


class TestBoltTxLeak:
    """A client that BEGINs and vanishes (or RESETs) must not leave the
    engine's transaction open — a leaked tx defers WAL compaction forever."""

    def _servers(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        server = BoltServer(
            lambda q, p, d: db.executor.execute(q, p),
            port=0,
            session_executor_factory=lambda d: db.executor,
        )
        server.start()
        return db, server

    def test_reset_rolls_back_open_tx(self):
        db, server = self._servers()
        try:
            c = _BoltClient(server.port)
            c.send(0x01, [{"scheme": "none"}])
            c.recv_message()
            c.send(0x11, [{}])  # BEGIN
            assert c.recv_message().tag == 0x70
            c.run("CREATE (:LeakReset)")
            c.send(0x0F, [])  # RESET mid-tx
            assert c.recv_message().tag == 0x70
            # the tx was rolled back: the uncommitted node is gone
            # (tx state is thread-local to the bolt thread, so the node
            # count is the only meaningful observable from here)
            assert db.executor.execute(
                "MATCH (n:LeakReset) RETURN count(n)").rows[0][0] == 0
            c.close()
        finally:
            server.stop()
            db.close()

    def test_disconnect_rolls_back_open_tx(self):
        db, server = self._servers()
        try:
            c = _BoltClient(server.port)
            c.send(0x01, [{"scheme": "none"}])
            c.recv_message()
            c.send(0x11, [{}])  # BEGIN
            assert c.recv_message().tag == 0x70
            c.run("CREATE (:LeakDrop)")
            c.close()  # vanish mid-tx
            # tx state is thread-local to the bolt thread, so poll the
            # observable outcome: the uncommitted CREATE disappears once
            # the server's disconnect handler rolls the tx back
            deadline = time.time() + 5
            count = 1
            while time.time() < deadline:
                count = db.executor.execute(
                    "MATCH (n:LeakDrop) RETURN count(n)").rows[0][0]
                if count == 0:
                    break
                time.sleep(0.02)
            assert count == 0
        finally:
            server.stop()
            db.close()


class TestHttpTxCommandGate:
    def test_begin_rejected_on_stateless_endpoint(self):
        """Explicit tx control on /db/x/tx/commit would open a frame on one
        handler thread that no later request (different thread) could ever
        close — the endpoint must refuse it for every role."""
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        server = HttpServer(db, port=0)
        server.start()
        try:
            for stmt in ("BEGIN", "COMMIT", "ROLLBACK", "  begin  ",
                         "BEGIN;", "/* c */ BEGIN", "// c\nBEGIN"):
                r = _post(server.port, "/db/neo4j/tx/commit",
                          {"statements": [{"statement": stmt}]})
                assert r["errors"], stmt
                assert "transaction" in r["errors"][0]["message"].lower()
            # ordinary statements still run
            r = _post(server.port, "/db/neo4j/tx/commit",
                      {"statements": [{"statement": "RETURN 1"}]})
            assert not r["errors"]
        finally:
            server.stop()
            db.close()

    def test_viewer_cannot_begin_on_http(self):
        """BEGIN via the stateless HTTP endpoint would pin the shared
        executor's tx open forever; it classifies as write."""
        from nornicdb_tpu_torch.cypher.executor import classify_query_text

        assert classify_query_text("BEGIN") == "write"
        assert classify_query_text("ROLLBACK") == "write"

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        auth = Authenticator(MemoryEngine())
        auth.create_user("v2", "pw", ROLE_VIEWER)
        server = HttpServer(db, port=0, authenticator=auth, auth_required=True)
        server.start()
        basic = base64.b64encode(b"v2:pw").decode()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, "/db/neo4j/tx/commit",
                      {"statements": [{"statement": "BEGIN"}]},
                      headers={"Authorization": f"Basic {basic}"})
            assert e.value.code == 401
        finally:
            server.stop()
            db.close()
