"""The port's device policy at the edges of its servers, and ``python -m
nornicdb_tpu_torch serve``, on the CPU.

- A device owner driven into DEGRADED_CPU over ``FakeHooks("hang")`` (the
  state in which the port's requests raise ``DeviceUnavailable``),
  injected into the DB's corpus as ``tests/test_torch_backend.py`` does:
  ``/nornicdb/search`` (vector and text), a transaction statement and MCP
  answer 503 with ``Retry-After`` and ``"reason": "device_unavailable"``,
  and so do a GraphQL ``search`` / ``similar`` field and a Qdrant
  collection search (never a GraphQL error with a 200); a GraphQL field
  that fails otherwise stays a per-field error;
  Bolt fails the statement with
  ``Neo.TransientError.General.DatabaseUnavailable``. Nothing answers
  from the host, and after the owner recovers the same requests answer
  what they answered before. ``ResourceExhausted`` is a 429 with
  ``Retry-After``, as in JAX.
- ``/admin/tpu/status`` never initialises CUDA: with
  ``torch.cuda.is_initialized`` False it makes no device query.
- ``serve`` refuses the flags of what is not ported (prefork workers,
  ROADMAP A6d), boots the native gRPC search and the Qdrant gRPC services
  with ``NORNICDB_GRPC_ENABLED`` / ``NORNICDB_QDRANT_GRPC_ENABLED`` (on the
  port's own transport, no grpcio; the Qdrant services share the REST
  registry), refuses to start without a card unless ``--device cpu`` is
  named, gates
  ``--embedder student`` on its eval MRR, and with ``--auth`` refuses
  unauthenticated requests on HTTP and Bolt, then exits 0 on SIGTERM
  after closing the DB.
- The streaming kernels' corpus threshold is the JAX package's constant.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import nornicdb_tpu_torch
from nornicdb_tpu_torch import backend as backend_mod
from nornicdb_tpu_torch.backend import BackendManager, FakeHooks
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.errors import ResourceExhausted
from nornicdb_tpu_torch.server import BoltServer, HttpServer
from nornicdb_tpu_torch.server.packstream import Structure, pack, unpack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = 32


def _request(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class _Bolt:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.sock.sendall(b"\x60\x60\xb0\x17"
                          + struct.pack(">I", (4 << 0) | (4 << 8))
                          + b"\x00" * 12)
        self._exact(4)

    def _exact(self, n):
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("closed")
            buf += part
        return buf

    def _message(self):
        chunks = b""
        while True:
            (size,) = struct.unpack(">H", self._exact(2))
            if size == 0:
                return unpack(chunks)
            chunks += self._exact(size)

    def send(self, tag, fields):
        """Send one message; its first response."""
        payload = pack(Structure(tag, fields))
        self.sock.sendall(struct.pack(">H", len(payload)) + payload
                          + b"\x00\x00")
        return self._message()

    def pull(self):
        """PULL everything: the records' fields, and the summary."""
        msg, rows = self.send(0x3F, [{"n": -1}]), []
        while msg.tag == 0x71:
            rows.append(msg.fields[0])
            msg = self._message()
        return rows, msg

    def close(self):
        self.sock.close()


@pytest.fixture
def served():
    """A CPU DB with embedded documents behind both servers."""
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    db.set_embedder(HashEmbedder(DIMS))
    for i in range(24):
        db.store(f"edge policy document {i} about graph search", node_id=f"d{i}")
    db.process_pending_embeddings()
    http = HttpServer(db, port=0)
    http.start()
    bolt = BoltServer(
        lambda q, p, d: (db.executor_for(d) if d else db.executor).execute(
            q, p),
        port=0, session_executor_factory=db.session_executor)
    bolt.start()
    yield db, http, bolt
    bolt.stop()
    http.stop()
    db.close()


def _degraded_owner():
    hooks = FakeHooks("hang")
    mgr = BackendManager(hooks=hooks, acquire_timeout=0.3,
                         probe_interval=0.03, probe_timeout=0.25,
                         degrade_after=3, recover_after=2)
    assert mgr.await_ready() is False  # starts the owner; the acquire hangs
    deadline = time.monotonic() + 10
    while mgr.state != backend_mod.DEGRADED_CPU:
        assert time.monotonic() < deadline, mgr.state
        time.sleep(0.01)
    return mgr, hooks


def _vec(seed):
    return np.random.default_rng(seed).standard_normal(DIMS).tolist()


_QUERY_NODES = ("CALL db.index.vector.queryNodes('default', 3, $v) "
                "YIELD node, score RETURN node.id, score")


class TestDeviceUnavailableAtTheEdge:
    def test_http_answers_503_then_recovers(self, served):
        db, http, _ = served
        requests = [
            ("/nornicdb/search", {"vector": _vec(1), "limit": 3}),
            ("/nornicdb/search", {"query": "graph search", "limit": 3}),
            ("/db/neo4j/tx/commit", {"statements": [
                {"statement": _QUERY_NODES, "parameters": {"v": _vec(2)}}]}),
            ("/db/neo4j/tx/commit", {"statements": [
                {"statement": "CREATE (:Before {k: 1})"},
                {"statement": _QUERY_NODES, "parameters": {"v": _vec(3)}}]}),
            ("/mcp", {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
                      "params": {"name": "recall",
                                 "arguments": {"query": "graph search"}}}),
        ]
        mgr, hooks = _degraded_owner()
        try:
            db.search._corpus._backend = mgr
            for path, body in requests:
                code, headers, out = _request(http.port, "POST", path, body)
                assert code == 503, (path, code, out)
                assert headers.get("Retry-After") == "1"
                assert out["reason"] == "device_unavailable"
                assert "results" not in out and "result" not in out
            # the multi-statement batch was rolled back, not half applied
            assert db.cypher("MATCH (n:Before) RETURN count(n)").rows == [[0]]
            hooks.set_mode("ok")
            deadline = time.monotonic() + 10
            while mgr.state != backend_mod.READY:
                assert time.monotonic() < deadline, mgr.state
                time.sleep(0.01)
            code, _, out = _request(http.port, "POST", *requests[0])
            assert code == 200
            want = db.search.vector_candidates(
                np.asarray(requests[0][1]["vector"], np.float32), k=3)
            assert [(r["id"], r["score"]) for r in out["results"]] == [
                (i, s) for i, s in want]
            code, _, out = _request(http.port, "POST", *requests[2])
            assert code == 200 and not out["errors"]
            assert len(out["results"][0]["data"]) == 3
        finally:
            db.search._corpus._backend = None
            mgr.stop()

    def test_graphql_and_collections_answer_503_then_recover(self, served):
        db, http, _ = served
        code, _, _ = _request(http.port, "PUT", "/collections/docs",
                              {"vectors": {"size": DIMS}})
        assert code == 200
        code, _, _ = _request(http.port, "PUT", "/collections/docs/points", {
            "points": [{"id": i, "vector": _vec(10 + i), "payload": {"i": i}}
                       for i in range(8)]})
        assert code == 200
        device_requests = [
            ("/graphql", {"query": '{ search(query: "graph search", '
                                   "limit: 3) { id score } }"}),
            ("/graphql", {"query": '{ similar(id: "d1", limit: 3) '
                                   "{ id score } stats { nodes } }"}),
            ("/collections/docs/points/search",
             {"vector": _vec(10), "limit": 3}),
            ("/collections/docs/points/search",
             {"vector": _vec(11), "limit": 3,
              "filter": {"must": [{"key": "i", "match": {"value": 1}}]}}),
        ]
        mgr, hooks = _degraded_owner()
        corpus = db.qdrant_registry()._corpora["docs"]
        try:
            db.search._corpus._backend = mgr
            corpus._backend = mgr
            for path, body in device_requests:
                code, headers, out = _request(http.port, "POST", path, body)
                assert code == 503, (path, code, out)
                assert headers.get("Retry-After") == "1"
                assert out["reason"] == "device_unavailable"
                assert "data" not in out and "result" not in out
            # a field that fails otherwise stays a per-field error, 200
            code, _, out = _request(http.port, "POST", "/graphql", {
                "query": '{ node(id: "missing") { id } stats { nodes } }'})
            assert code == 200
            assert out["data"] == {"node": None, "stats": {"nodes": 32}}
            assert out["errors"][0]["path"] == ["node"]
            # routes that touch no device answer while the card is away
            code, _, out = _request(http.port, "POST",
                                    "/collections/docs/points/count", {})
            assert code == 200 and out["result"] == {"count": 8}
            hooks.set_mode("ok")
            deadline = time.monotonic() + 10
            while mgr.state != backend_mod.READY:
                assert time.monotonic() < deadline, mgr.state
                time.sleep(0.01)
            for path, body in device_requests:
                code, _, out = _request(http.port, "POST", path, body)
                assert code == 200, (path, out)
                assert "errors" not in out
            code, _, out = _request(http.port, "POST",
                                    "/collections/docs/points/search",
                                    device_requests[2][1])
            want = db.qdrant_registry().search("docs", _vec(10), limit=3)
            assert out["result"] == want and want[0]["id"] == 0
        finally:
            db.search._corpus._backend = None
            corpus._backend = None
            mgr.stop()

    def test_bolt_answers_the_transient_code(self, served):
        db, _, bolt = served
        mgr, hooks = _degraded_owner()
        try:
            db.search._corpus._backend = mgr
            c = _Bolt(bolt.port)
            assert c.send(0x01, [{"scheme": "none"}]).tag == 0x70
            failure = c.send(0x10, [_QUERY_NODES, {"v": _vec(4)}, {}])
            assert failure.tag == 0x7F
            assert failure.fields[0]["code"] == (
                "Neo.TransientError.General.DatabaseUnavailable")
            assert c.send(0x3F, [{"n": -1}]).tag == 0x7E  # IGNORED
            assert c.send(0x0F, []).tag == 0x70  # RESET
            hooks.set_mode("ok")
            deadline = time.monotonic() + 10
            while mgr.state != backend_mod.READY:
                assert time.monotonic() < deadline, mgr.state
                time.sleep(0.01)
            assert c.send(0x10, [_QUERY_NODES, {"v": _vec(4)}, {}]).tag == 0x70
            rows, summary = c.pull()
            assert summary.tag == 0x70
            want = db.search.vector_candidates(
                np.asarray(_vec(4), np.float32), k=3)
            assert [r[0] for r in rows] == [i for i, _ in want]
            c.close()
        finally:
            db.search._corpus._backend = None
            mgr.stop()

    def test_resource_exhausted_is_429_with_retry_after(self, served,
                                                        monkeypatch):
        db, http, _ = served

        def shed(*a, **k):
            raise ResourceExhausted("queue full", reason="queue_full")

        monkeypatch.setattr(db.search, "vector_candidates", shed)
        code, headers, out = _request(http.port, "POST", "/nornicdb/search",
                                      {"vector": _vec(5), "limit": 3})
        assert code == 429 and headers.get("Retry-After") == "1"
        assert out == {"error": "queue full", "reason": "queue_full"}


class TestDeviceStatus:
    def test_status_makes_no_device_query_before_cuda_init(self, served,
                                                           monkeypatch):
        _, http, _ = served

        def forbidden(*a, **k):
            raise AssertionError("the status route queried the device")

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        for name in ("device_count", "get_device_name", "init",
                     "current_device", "synchronize"):
            monkeypatch.setattr(torch.cuda, name, forbidden)
        code, _, out = _request(http.port, "GET", "/admin/tpu/status")
        assert code == 200
        assert out["framework"] == "torch"
        assert out["backend_initialized"] is False
        assert out["devices"] == [] and out["platform"] is None
        assert "kernel_launches" not in out

    def test_status_names_an_initialised_card(self, served, monkeypatch):
        _, http, _ = served
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "NVIDIA H100 80GB HBM3")
        code, _, out = _request(http.port, "GET", "/admin/tpu/status")
        assert code == 200 and out["backend_initialized"] is True
        assert out["platform"] == "cuda" and out["device_count"] == 1
        assert out["devices"] == ["NVIDIA H100 80GB HBM3"]
        assert set(out["kernel_launches"]) >= {"streaming_topk_bf16",
                                               "ragged_paged_attention"}


# ------------------------------------------------------------------ serve


def _serve_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("NORNICDB_GRPC_ENABLED", "NORNICDB_QDRANT_GRPC_ENABLED",
                "NORNICDB_WORKERS_HTTP", "NORNICDB_WORKERS_GRPC",
                "NORNICDB_STUDENT_MODEL",
                "NORNICDB_STUDENT_MIN_MRR", "NORNICDB_EMBEDDER_MODEL"):
        env.pop(var, None)
    env.update(extra)
    return env


@pytest.mark.parametrize("args,env,needle", [
    (["--device", "cpu", "--workers", "2"], {}, "A6d"),
    (["--device", "cpu"], {"NORNICDB_WORKERS_HTTP": "2"}, "A6d"),
    (["--device", "cpu"], {"NORNICDB_WORKERS_GRPC": "1"}, "A6d"),
])
def test_serve_refuses_unported_surfaces(tmp_path, monkeypatch, args, env,
                                         needle):
    from nornicdb_tpu_torch import cli

    for var, value in _serve_env(**env).items():
        if var.startswith("NORNICDB_"):
            monkeypatch.setenv(var, value)
    for var in ("NORNICDB_GRPC_ENABLED", "NORNICDB_QDRANT_GRPC_ENABLED",
                "NORNICDB_WORKERS_HTTP", "NORNICDB_WORKERS_GRPC"):
        if var not in env:
            monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--embedder", "hash", "--data-dir",
                  str(tmp_path / "d"), "--http-port", "0", "--bolt-port",
                  "0", *args])
    assert e.value.code != 0 and f"ROADMAP {needle}" in str(e.value.code)
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("env,schemes", [
    ({"NORNICDB_GRPC_ENABLED": "1"}, ("grpc",)),
    ({"NORNICDB_GRPC_ENABLED": "yes", "NORNICDB_QDRANT_GRPC_ENABLED": "true"},
     ("qdrant-grpc", "grpc")),
])
def test_serve_boots_the_grpc_servers(tmp_path, env, schemes):
    from nornicdb_tpu_torch.server import grpcwire
    from nornicdb_tpu_torch.server.grpc_search import search_over_grpc
    from nornicdb_tpu_torch.server.qdrant_grpc import (
        _ld, _packed_f32, _parse, _s, _vi, dec_point_id, enc_point_id,
        enc_vectors)

    data = tmp_path / "d"
    proc = subprocess.Popen(
        [sys.executable, "-m", "nornicdb_tpu_torch", "serve", "--device",
         "cpu", "--embedder", "hash", "--embed-dims", str(DIMS),
         "--host", "127.0.0.1", "--data-dir", str(data),
         "--http-port", "0", "--bolt-port", "0"],
        cwd=str(tmp_path), env=_serve_env(
            NORNICDB_GRPC_PORT="0", NORNICDB_QDRANT_GRPC_PORT="0", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "NornicDB-TPU serving" in line, (line, proc.stderr.read()
                                                if proc.poll() else "")
        ports = {}
        for word in line.split():
            scheme, _, rest = word.partition("://127.0.0.1:")
            if rest:
                ports[scheme] = int(rest)
        assert tuple(k for k in ports if "grpc" in k) == schemes, line
        http_port = ports["http"]
        code, _, out = _request(http_port, "POST", "/db/neo4j/tx/commit", {
            "statements": [{"statement": "CREATE (:Doc {content: "
                            "'grpc served doc'})"}]})
        assert code == 200 and not out["errors"], out
        deadline = time.monotonic() + 30
        while True:
            hits = search_over_grpc("127.0.0.1", ports["grpc"],
                                    query="grpc served doc")["hits"]
            if hits or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert hits and hits[0]["content"] == "grpc served doc"
        if "qdrant-grpc" in ports:
            with grpcwire.Channel("127.0.0.1", ports["qdrant-grpc"]) as ch:
                cfg = _ld(1, _vi(1, 2) + _vi(2, 1))
                ch.unary_unary("/qdrant.Collections/Create")(
                    _s(1, "c") + _ld(10, cfg), timeout=10)
                ch.unary_unary("/qdrant.Points/Upsert")(
                    _s(1, "c") + _ld(3, _ld(1, enc_point_id(7))
                                     + _ld(4, enc_vectors([1.0, 0.0]))),
                    timeout=10)
                # the REST routes share the registry, both ways
                code, _, out = _request(http_port, "PUT",
                                        "/collections/c/points", {
                                            "points": [{"id": 8, "vector":
                                                        [0.0, 1.0]}]})
                assert code == 200, out
                f = _parse(ch.unary_unary("/qdrant.Points/Search")(
                    _s(1, "c") + _packed_f32(2, [0.1, 1.0]) + _vi(4, 2),
                    timeout=10))
                ids = [dec_point_id(_parse(raw)[1][0][1]) for _, raw in f[1]]
                assert ids == [8, 7]
            code, _, out = _request(http_port, "POST",
                                    "/collections/c/points/count", {})
            assert code == 200 and out["result"] == {"count": 2}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    from nornicdb_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("the default device is the card when one exists")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--data-dir", str(tmp_path / "d"), "serve", "--embedder",
                  "hash", "--http-port", "0", "--bolt-port", "0"])
    assert "device='cpu'" in str(e.value.code)
    assert not (tmp_path / "d").exists()


def test_serve_with_auth_on_the_cpu_then_sigterm(tmp_path):
    data = tmp_path / "d"
    proc = subprocess.Popen(
        [sys.executable, "-m", "nornicdb_tpu_torch", "serve", "--device",
         "cpu", "--auth", "--embedder", "hash", "--embed-dims", str(DIMS),
         "--host", "127.0.0.1", "--data-dir", str(data),
         "--http-port", "0", "--bolt-port", "0"],
        cwd=str(tmp_path), env=_serve_env(NORNICDB_ADMIN_PASSWORD="pw-1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "NornicDB-TPU serving" in line, (line, proc.stderr.read()
                                                if proc.poll() else "")
        bolt_port = int(line.split("bolt://127.0.0.1:")[1].split()[0])
        http_port = int(line.split("http://127.0.0.1:")[1].split()[0])
        assert "on cpu" in line
        code, _, _ = _request(http_port, "GET", "/health")
        assert code == 200
        code, _, out = _request(http_port, "POST", "/nornicdb/search",
                                {"query": "served doc"})
        assert code == 401, out
        _, _, tok = _request(http_port, "POST", "/auth/login",
                             {"username": "admin", "password": "pw-1"})
        auth = {"Authorization": f"Bearer {tok['token']}"}
        code, _, out = _request(http_port, "POST", "/db/neo4j/tx/commit", {
            "statements": [{"statement":
                            "CREATE (:Doc {content: 'served doc', k: 1})"}]},
            auth)
        assert code == 200 and not out["errors"], out
        code, _, out = _request(http_port, "GET", "/admin/tpu/status",
                                headers=auth)
        assert code == 200 and out["framework"] == "torch"
        # GraphQL and the Qdrant REST API answer in the served process
        code, _, out = _request(http_port, "POST", "/graphql",
                                {"query": "{ stats { nodes } }"}, auth)
        assert code == 200 and out == {"data": {"stats": {"nodes": 1}}}
        for method, path, body in (
                ("PUT", "/collections/c", {"vectors": {"size": 2}}),
                ("PUT", "/collections/c/points",
                 {"points": [{"id": 1, "vector": [1.0, 0.0]}]}),
                ("POST", "/collections/c/points/search",
                 {"vector": [1.0, 0.0], "limit": 1})):
            code, _, out = _request(http_port, method, path, body, auth)
            assert code == 200, (path, out)
        assert [h["id"] for h in out["result"]] == [1]
        code, _, out = _request(http_port, "GET", "/collections")
        assert code == 401, out
        c = _Bolt(bolt_port)
        bad = c.send(0x01, [{"scheme": "basic", "principal": "admin",
                             "credentials": "wrong"}])
        assert bad.tag == 0x7F
        assert bad.fields[0]["code"] == "Neo.ClientError.Security.Unauthorized"
        c.close()
        c = _Bolt(bolt_port)
        assert c.send(0x01, [{"scheme": "basic", "principal": "admin",
                              "credentials": "pw-1"}]).tag == 0x70
        assert c.send(0x10, ["MATCH (n:Doc) RETURN n.k", {}, {}]).tag == 0x70
        assert c.pull()[0] == [[1]]
        c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # the DB was closed: a reopen finds the write and the point
    db = nornicdb_tpu_torch.open_db(str(data), device="cpu")
    try:
        assert db.cypher("MATCH (n:Doc) RETURN n.k").rows == [[1]]
        assert db.qdrant_registry().count("c") == 1
    finally:
        db.close()


@pytest.fixture(scope="module")
def student_dir(tmp_path_factory):
    """A distilled student of a tiny teacher, both trained on the CPU."""
    from nornicdb_tpu_torch.models import pretrain

    root = tmp_path_factory.mktemp("student")
    pretrain.train_encoder(str(root / "teacher"), steps=4, device="cpu")
    pretrain.distill_encoder(str(root / "teacher"), str(root / "student"),
                             layers=1, steps=2, device="cpu")
    return str(root / "student")


@pytest.mark.parametrize("min_mrr,admitted", [(0.99, False), (0.0, True)])
def test_serve_gates_the_student_embedder(tmp_path, student_dir, min_mrr,
                                          admitted):
    """``--embedder student`` serves the distilled checkpoint only when
    its eval MRR clears ``serving.student_min_mrr``; below it the config
    is rejected at startup, as the JAX ``cmd_serve`` does."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "nornicdb_tpu_torch", "serve", "--device",
         "cpu", "--embedder", "student", "--host", "127.0.0.1",
         "--http-port", "0", "--bolt-port", "0"],
        cwd=str(tmp_path), env=_serve_env(
            NORNICDB_STUDENT_MODEL=student_dir,
            NORNICDB_STUDENT_MIN_MRR=str(min_mrr)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        if not admitted:
            _, err = proc.communicate(timeout=120)
            assert proc.returncode != 0
            assert "serving config rejected" in err
            return
        assert "student embedder admitted" in proc.stdout.readline()
        line = proc.stdout.readline()
        assert "NornicDB-TPU serving" in line, line
        http_port = int(line.split("http://127.0.0.1:")[1].split()[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert 'nornicdb_serving_embedder{model="student"} 1' in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_streaming_threshold_is_the_reference():
    """The corpus size from which the card's searches take the streaming
    kernel is the JAX package's fixed constant, not a setting."""
    from nornicdb_tpu.ops.similarity import STREAMING_MIN_ROWS as jax_min
    from nornicdb_tpu_torch.ops.similarity import STREAMING_MIN_ROWS

    assert STREAMING_MIN_ROWS == jax_min == 65_536
