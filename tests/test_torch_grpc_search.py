"""The native gRPC search service of the port
(``nornicdb_tpu_torch/server/grpc_search.py``, on ``grpcwire``) on the CPU.

- The JAX ``tests/test_servers.py::TestGrpcSearch`` cases, with only their
  imports and the device argument (``device="cpu"``) changed.
- Both packages over DBs built alike from a seed (``HashEmbedder``
  documents): the same request bytes (text queries and raw vectors) sent
  to the JAX package's grpcio server and to the port's server give equal
  decoded answers: ids and content equal, scores within ``SCORE_TOL``
  (4e-3, the tolerance ``test_torch_server_parity.py`` holds HTTP search
  bodies to), ``took_micros`` left out. Where two hits' scores lie within
  that tolerance they may trade places. Needs grpcio for the JAX server.
- The response cache: a repeat answers the cached bytes, a write
  invalidates it; a grpcio client against the port's server.
- The edge policy: ``DeviceUnavailable`` answers UNAVAILABLE with details
  that start ``device_unavailable`` (the port's policy, recorded in
  ROADMAP §C) and the service answers again once the owner recovers;
  ``ResourceExhausted`` stays RESOURCE_EXHAUSTED; a ``traceparent`` in
  the call's metadata keys the trace of the search.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch import backend as backend_mod
from nornicdb_tpu_torch.backend import BackendManager, FakeHooks
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.errors import ResourceExhausted
from nornicdb_tpu_torch.server import grpcwire
from nornicdb_tpu_torch.server.grpc_search import (
    SEARCH_METHOD,
    GrpcSearchServer,
    decode_search_response,
    encode_search_request,
    search_over_grpc,
)
from nornicdb_tpu_torch.telemetry.tracing import format_traceparent, tracer

SCORE_TOL = 4e-3
DIMS = 32


class TestGrpcSearch:
    """(ref: pkg/nornicgrpc — the reference's fastest protocol endpoint)"""

    def _server(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        db.set_embedder(HashEmbedder(32))
        srv = GrpcSearchServer(db, port=0)
        srv.start()
        return db, srv

    def test_protobuf_codec_roundtrip(self):
        from nornicdb_tpu_torch.server.grpc_search import (
            decode_search_request,
            decode_search_response,
            encode_search_request,
            encode_search_response,
        )

        req = decode_search_request(
            encode_search_request("hello", 5, [0.5, -1.5], 0.25)
        )
        assert req["query"] == "hello" and req["limit"] == 5
        assert req["vector"] == [0.5, -1.5]
        assert abs(req["min_score"] - 0.25) < 1e-6
        resp = decode_search_response(
            encode_search_response(
                [{"id": "a", "score": 0.9, "content": "text"}], 123
            )
        )
        assert resp["hits"][0]["id"] == "a"
        assert resp["took_micros"] == 123

    def test_text_search_over_grpc(self):
        db, srv = self._server()
        try:
            db.store("the grpc endpoint serves vectors fast")
            db.process_pending_embeddings()
            out = search_over_grpc("127.0.0.1", srv.port, query="grpc vectors")
            assert out["hits"] and "grpc" in out["hits"][0]["content"]
            assert out["took_micros"] > 0
        finally:
            srv.stop()
            db.close()

    def test_grpc_response_cache_invalidated_by_mutation(self):
        db, srv = self._server()
        try:
            db.store("gamma grpc cache doc")
            db.process_pending_embeddings()
            first = search_over_grpc("127.0.0.1", srv.port,
                                     query="grpc cache doc")
            cached = search_over_grpc("127.0.0.1", srv.port,
                                      query="grpc cache doc")
            assert [h["id"] for h in cached["hits"]] == \
                [h["id"] for h in first["hits"]]
            db.store("delta grpc cache doc two")
            db.process_pending_embeddings()
            after = search_over_grpc("127.0.0.1", srv.port,
                                     query="grpc cache doc")
            assert len(after["hits"]) == len(first["hits"]) + 1
        finally:
            srv.stop()
            db.close()

    def test_vector_search_over_grpc(self):
        db, srv = self._server()
        try:
            n = db.store("target document")
            db.process_pending_embeddings()
            vec = db.storage.get_node(n.id).embedding
            out = search_over_grpc(
                "127.0.0.1", srv.port, vector=list(map(float, vec)), limit=1
            )
            assert out["hits"][0]["id"] == n.id
            assert out["hits"][0]["score"] > 0.99
        finally:
            srv.stop()
            db.close()


# ---------------------------------------------------------- both packages
WORDS = ("graph", "vector", "search", "node", "edge", "memory", "decay",
         "query", "index", "cosine", "kernel", "card", "cluster", "token")


def _texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 6))
            + f" doc{i}" for i in range(n)]


def _fill(db, seed: int, n: int = 120) -> None:
    for i, t in enumerate(_texts(seed, n)):
        db.store(t, node_id=f"d{i}")
    db.process_pending_embeddings()


def _requests(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed + 1)
    out = [encode_search_request(query=q, limit=int(k))
           for q, k in zip(_texts(seed + 2, 6), rng.integers(1, 12, 6))]
    emb = HashEmbedder(DIMS)
    for t in _texts(seed, 120)[::17]:
        vec = np.asarray(emb.embed(t)) + 0.05 * rng.standard_normal(DIMS)
        out.append(encode_search_request(vector=vec.tolist(), limit=8))
    out.append(encode_search_request(vector=rng.standard_normal(DIMS)
                                     .tolist(), limit=5, min_score=0.2))
    return out


def _same_hits(got: list, want: list) -> None:
    """ids and content equal, scores within SCORE_TOL; hits whose scores
    lie within it may trade places."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= SCORE_TOL, (g, w)
        if g["id"] != w["id"]:
            twin = next((x for x in want if x["id"] == g["id"]), None)
            assert twin is not None and \
                abs(twin["score"] - g["score"]) <= SCORE_TOL, (g, w)
    by_id = {w["id"]: w for w in want}
    for g in got:
        if g["id"] in by_id:
            assert g["content"] == by_id[g["id"]]["content"]


class TestBothPackages:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_request_bytes_same_answers(self, seed):
        pytest.importorskip("grpc")
        import nornicdb_tpu
        from nornicdb_tpu.embed import HashEmbedder as JaxHashEmbedder
        from nornicdb_tpu.server.grpc_search import (
            GrpcSearchServer as JaxGrpcSearchServer,
        )

        jdb = nornicdb_tpu.open_db("")
        jdb.set_embedder(JaxHashEmbedder(DIMS))
        pdb = nornicdb_tpu_torch.open_db("", device="cpu")
        pdb.set_embedder(HashEmbedder(DIMS))
        _fill(jdb, seed)
        _fill(pdb, seed)
        jsrv = JaxGrpcSearchServer(jdb, port=0)
        psrv = GrpcSearchServer(pdb, port=0)
        jsrv.start()
        psrv.start()
        try:
            with grpcwire.Channel("127.0.0.1", jsrv.port) as jch, \
                    grpcwire.Channel("127.0.0.1", psrv.port) as pch:
                for req in _requests(seed):
                    want = decode_search_response(
                        jch.unary_unary(SEARCH_METHOD)(req, timeout=10))
                    got = decode_search_response(
                        pch.unary_unary(SEARCH_METHOD)(req, timeout=10))
                    assert got["hits"], req
                    _same_hits(got["hits"], want["hits"])
        finally:
            psrv.stop()
            jsrv.stop()
            pdb.close()
            jdb.close()


# -------------------------------------------------------------- the edge
@pytest.fixture
def served():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    db.set_embedder(HashEmbedder(DIMS))
    _fill(db, 3, 40)
    srv = GrpcSearchServer(db, port=0)
    srv.start()
    ch = grpcwire.Channel("127.0.0.1", srv.port)
    yield db, srv, ch
    ch.close()
    srv.stop()
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


class TestEdge:
    def test_repeat_answers_the_cached_bytes(self, served):
        db, _, ch = served
        req = encode_search_request(query="graph vector doc3", limit=5)
        first = ch.unary_unary(SEARCH_METHOD)(req, timeout=10)
        assert ch.unary_unary(SEARCH_METHOD)(req, timeout=10) == first
        db.store("graph vector doc3 graph vector doc3", node_id="new")
        db.process_pending_embeddings()
        after = decode_search_response(
            ch.unary_unary(SEARCH_METHOD)(req, timeout=10))
        assert "new" in [h["id"] for h in after["hits"]]

    def test_device_unavailable_is_unavailable_then_recovers(self, served):
        db, _, ch = served
        vec = np.random.default_rng(5).standard_normal(DIMS).tolist()
        req = encode_search_request(vector=vec, limit=3)
        mgr, hooks = _degraded_owner()
        try:
            db.search._corpus._backend = mgr
            with pytest.raises(grpcwire.RpcError) as e:
                ch.unary_unary(SEARCH_METHOD)(req, timeout=10)
            assert e.value.code() == grpcwire.StatusCode.UNAVAILABLE
            assert e.value.details().startswith("device_unavailable")
            hooks.set_mode("ok")
            deadline = time.monotonic() + 10
            while mgr.state != backend_mod.READY:
                assert time.monotonic() < deadline, mgr.state
                time.sleep(0.01)
            out = decode_search_response(
                ch.unary_unary(SEARCH_METHOD)(req, timeout=10))
            want = db.search.vector_candidates(np.asarray(vec, np.float32),
                                               k=3)
            assert [h["id"] for h in out["hits"]] == [i for i, _ in want]
            assert np.allclose([h["score"] for h in out["hits"]],
                               [s for _, s in want], atol=1e-6)
        finally:
            db.search._corpus._backend = None
            mgr.stop()

    def test_shed_is_resource_exhausted(self, served, monkeypatch):
        db, _, ch = served

        def shed(*a, **kw):
            raise ResourceExhausted("search batch queue full (test); "
                                    "retry with backoff")

        monkeypatch.setattr(db.search, "vector_candidates", shed)
        with pytest.raises(grpcwire.RpcError) as e:
            ch.unary_unary(SEARCH_METHOD)(
                encode_search_request(vector=[0.1] * DIMS, limit=3),
                timeout=10)
        assert e.value.code() == grpcwire.StatusCode.RESOURCE_EXHAUSTED
        assert "queue full" in e.value.details()

    def test_traceparent_metadata_keys_the_trace(self, served):
        _, _, ch = served
        old = tracer.enabled, tracer.sample_rate
        tracer.clear()
        tracer.configure(enabled=True, sample_rate=1.0)
        try:
            want = "ab" * 16
            ch.unary_unary(SEARCH_METHOD)(
                encode_search_request(query="kernel card doc7", limit=2),
                timeout=10,
                metadata=[("traceparent", format_traceparent(want, "cd" * 8))])
            deadline = time.monotonic() + 5
            entry = None
            while entry is None and time.monotonic() < deadline:
                entry = tracer.trace(want)
                time.sleep(0.01)
            assert entry is not None
            assert "grpc.search" in {s["name"] for s in entry["spans"]}
        finally:
            tracer.clear()
            tracer.configure(enabled=old[0], sample_rate=old[1])

    def test_grpcio_client(self, served):
        grpc = pytest.importorskip("grpc")
        db, srv, _ = served
        with grpc.insecure_channel(f"127.0.0.1:{srv.port}") as gch:
            fn = gch.unary_unary(SEARCH_METHOD)
            out = decode_search_response(fn(encode_search_request(
                query="graph vector doc3", limit=4), timeout=10))
        want = db.search.search("graph vector doc3", limit=4)
        assert [h["id"] for h in out["hits"]] == [r["id"] for r in want]
