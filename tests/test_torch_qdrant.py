"""Qdrant-compatible API tests (ref: pkg/qdrantgrpc tests,
qdrant_official_e2e_test.go — exercised over the REST twin here).

The port's copy of ``tests/test_qdrant.py``: the JAX cases with only their
imports and the device argument (``device="cpu"``) changed. Then the
port against the JAX package on the same inputs, made from numpy seeds:

- one seeded sequence of REST requests (create, upsert of a few hundred
  points with payloads, unfiltered / filtered / thresholded search,
  count, scroll, retrieve, delete, snapshot, named vectors, errors) sent
  to both packages' ``HttpServer``: status codes and bodies are equal,
  scores within ``SCORE_TOL`` (half a bf16 step at 1.0, the tolerance
  ``test_torch_server_parity.py`` holds search bodies to: both score a
  bf16 product). Where two hits' scores lie within that tolerance their
  order may differ, and nothing else may;
- ``eval_filter`` of both packages over seeded payloads and filters
  (must / should / must_not, nested filters, match value / text / any /
  except, range, has_id, is_empty / is_null, dotted keys): the results
  are exactly equal;
- the registry's corpora sit on the device it was given, behind the
  owner it was given, and ``DB.qdrant_registry`` is one registry per DB.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.server import HttpServer as JaxHttpServer
from nornicdb_tpu.server import qdrant as jax_qdrant
from nornicdb_tpu_torch import backend as backend_mod
from nornicdb_tpu_torch.backend import BackendManager, FakeHooks
from nornicdb_tpu_torch.errors import DeviceUnavailable
from nornicdb_tpu_torch.server import HttpServer
from nornicdb_tpu_torch.server import qdrant as port_qdrant
from nornicdb_tpu_torch.server.http import RateLimiter
from nornicdb_tpu_torch.server.qdrant import QdrantCollections


def _req(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"},
        method=method,
    )
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


@pytest.fixture
def server():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    srv = HttpServer(db, port=0)
    srv.start()
    yield srv
    srv.stop()
    db.close()


class TestQdrantApi:
    def test_collection_lifecycle(self, server):
        out = _req(server.port, "PUT", "/collections/docs",
                   {"vectors": {"size": 4, "distance": "Cosine"}})
        assert out["status"] == "ok"
        out = _req(server.port, "GET", "/collections")
        assert {"name": "docs"} in out["result"]["collections"]
        out = _req(server.port, "GET", "/collections/docs")
        assert out["result"]["config"]["params"]["vectors"]["size"] == 4
        out = _req(server.port, "DELETE", "/collections/docs")
        assert out["result"] is True

    def test_upsert_search_delete_points(self, server):
        _req(server.port, "PUT", "/collections/vecs",
             {"vectors": {"size": 4, "distance": "Cosine"}})
        _req(server.port, "PUT", "/collections/vecs/points", {
            "points": [
                {"id": 1, "vector": [1, 0, 0, 0], "payload": {"tag": "x"}},
                {"id": 2, "vector": [0, 1, 0, 0], "payload": {"tag": "y"}},
                {"id": 3, "vector": [0.9, 0.1, 0, 0], "payload": {"tag": "z"}},
            ]
        })
        out = _req(server.port, "GET", "/collections/vecs")
        assert out["result"]["points_count"] == 3
        out = _req(server.port, "POST", "/collections/vecs/points/search",
                   {"vector": [1, 0, 0, 0], "limit": 2})
        hits = out["result"]
        assert [h["id"] for h in hits] == [1, 3]
        assert hits[0]["payload"]["tag"] == "x"
        assert hits[0]["score"] == pytest.approx(1.0, abs=1e-3)
        out = _req(server.port, "POST", "/collections/vecs/points/delete",
                   {"points": [1]})
        assert out["result"]["deleted"] == 1
        out = _req(server.port, "POST", "/collections/vecs/points/search",
                   {"vector": [1, 0, 0, 0], "limit": 3})
        assert [h["id"] for h in out["result"]] == [3, 2]

    def test_points_are_graph_nodes(self, server):
        """Qdrant points land in the same graph (ref: QdrantPoint label)."""
        _req(server.port, "PUT", "/collections/g", {"vectors": {"size": 2}})
        _req(server.port, "PUT", "/collections/g/points",
             {"points": [{"id": 7, "vector": [1, 0], "payload": {"k": "v"}}]})
        nodes = server.db.storage.get_nodes_by_label("QdrantPoint")
        assert len(nodes) == 1
        assert nodes[0].properties["k"] == "v"

    def test_search_score_threshold(self, server):
        _req(server.port, "PUT", "/collections/t", {"vectors": {"size": 2}})
        _req(server.port, "PUT", "/collections/t/points", {
            "points": [
                {"id": 1, "vector": [1, 0]},
                {"id": 2, "vector": [0, 1]},
            ]
        })
        out = _req(server.port, "POST", "/collections/t/points/search",
                   {"vector": [1, 0], "limit": 10, "score_threshold": 0.5})
        assert [h["id"] for h in out["result"]] == [1]

    def test_unknown_collection_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(server.port, "GET", "/collections/nope")
        assert e.value.code == 404


class TestRateLimiter:
    def test_token_bucket(self):
        rl = RateLimiter(rate=10.0, burst=2)
        assert rl.allow("a")
        assert rl.allow("a")
        assert not rl.allow("a")  # burst exhausted
        assert rl.allow("b")  # separate client

    def test_http_rate_limiting(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        srv = HttpServer(db, port=0, rate_limit=2.0)
        srv.start()
        try:
            codes = []
            for _ in range(6):
                try:
                    _req(srv.port, "GET", "/health")
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
            assert 429 in codes
        finally:
            srv.stop()
            db.close()


class TestNamedVectors:
    def test_named_vector_collection(self, server):
        _req(server.port, "PUT", "/collections/multi",
             {"vectors": {"text": {"size": 4, "distance": "Cosine"},
                          "image": {"size": 2, "distance": "Cosine"}}})
        _req(server.port, "PUT", "/collections/multi/points", {
            "points": [
                {"id": 1, "vector": {"text": [1, 0, 0, 0], "image": [1, 0]}},
                {"id": 2, "vector": {"text": [0, 1, 0, 0], "image": [0, 1]}},
            ]
        })
        out = _req(server.port, "POST", "/collections/multi/points/search",
                   {"vector": {"name": "image", "vector": [1, 0]}, "limit": 1})
        assert out["result"][0]["id"] == 1
        out = _req(server.port, "POST", "/collections/multi/points/search",
                   {"vector": {"name": "text", "vector": [0, 1, 0, 0]}, "limit": 1})
        assert out["result"][0]["id"] == 2

    def test_snapshot_endpoint(self, server):
        _req(server.port, "PUT", "/collections/snap", {"vectors": {"size": 2}})
        _req(server.port, "PUT", "/collections/snap/points",
             {"points": [{"id": 5, "vector": [1, 0], "payload": {"k": "v"}}]})
        out = _req(server.port, "POST", "/collections/snap/snapshots", {})
        assert out["result"]["count"] == 1
        point = out["result"]["points"][0]
        assert point["payload"]["k"] == "v"
        assert point["vector"] == [1.0, 0.0]  # snapshots preserve vectors

    def test_named_collection_survives_restart(self):
        """Named-vector collections rebuild from persisted named_embeddings."""
        from nornicdb_tpu_torch.server.qdrant import QdrantCollections
        from nornicdb_tpu_torch.storage import MemoryEngine

        eng = MemoryEngine()
        reg = QdrantCollections(eng, device="cpu")
        reg.create("m", named={"text": {"size": 2}})
        reg.upsert("m", [{"id": 1, "vector": {"text": [1, 0]}}])
        reg2 = QdrantCollections(eng, device="cpu")  # fresh registry, same storage
        assert reg2.info("m") is not None
        out = reg2.search("m", {"name": "text", "vector": [1, 0]}, limit=1)
        assert out[0]["id"] == 1

    def test_delete_removes_from_named_corpora(self):
        from nornicdb_tpu_torch.server.qdrant import QdrantCollections
        from nornicdb_tpu_torch.storage import MemoryEngine

        reg = QdrantCollections(MemoryEngine(), device="cpu")
        reg.create("m", named={"t": {"size": 2}})
        reg.upsert("m", [{"id": 1, "vector": {"t": [1, 0]}},
                         {"id": 2, "vector": {"t": [0, 1]}}])
        reg.delete_points("m", [1])
        out = reg.search("m", {"name": "t", "vector": [1, 0]}, limit=2)
        assert [h["id"] for h in out] == [2]

    def test_dims_mismatch_rejected(self):
        from nornicdb_tpu_torch.errors import NornicError
        from nornicdb_tpu_torch.server.qdrant import QdrantCollections
        from nornicdb_tpu_torch.storage import MemoryEngine

        reg = QdrantCollections(MemoryEngine(), device="cpu")
        reg.create("m", named={"t": {"size": 4}})
        reg.upsert("m", [{"id": 1, "vector": {"t": [1, 0, 0, 0]}}])
        with pytest.raises(NornicError):
            reg.upsert("m", [{"id": 2, "vector": {"t": [1, 0]}}])
        # prior vectors intact
        out = reg.search("m", {"name": "t", "vector": [1, 0, 0, 0]}, limit=1)
        assert out[0]["id"] == 1

    def test_retrieve_includes_named_vectors(self):
        from nornicdb_tpu_torch.server.qdrant import QdrantCollections
        from nornicdb_tpu_torch.storage import MemoryEngine

        reg = QdrantCollections(MemoryEngine(), device="cpu")
        reg.create("m", named={"t": {"size": 2}})
        reg.upsert("m", [{"id": 1, "vector": {"t": [1, 0]}}])
        out = reg.retrieve("m", [1])
        assert out[0]["vector"] == {"t": [1.0, 0.0]}


# ------------------------------------------------------ the port vs JAX
# half of bf16's step in [0.5, 1] (2**-8 / 2): both packages score a bf16
# product, rounded in another order (tests/test_torch_server_parity.py)
SCORE_TOL = 4e-3
DIMS = 32


def _status_req(port, method, path, body=None):
    """(status, parsed body) of one request; HTTP errors included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"},
        method=method,
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _payload(rng, i: int) -> dict:
    words = ["alpha", "beta", "gamma", "delta", "graph node", ""]
    p = {"doc": i, "group": i % 7, "word": str(rng.choice(words)),
         "flag": bool(rng.integers(0, 2)),
         "score": float(np.round(rng.standard_normal(), 3)),
         "meta": {"rank": int(rng.integers(0, 50)),
                  "tags": [str(t) for t in rng.choice(
                      ["a", "b", "c", "d"], int(rng.integers(0, 3)),
                      replace=False)]}}
    if i % 11 == 0:
        p["opt"] = None
    if i % 13 == 0:
        p["_collection"] = "spoofed"  # internal keys are dropped
    return p


def _requests(seed: int) -> list:
    """One seeded sequence of Qdrant REST requests."""
    rng = np.random.default_rng(seed)
    n = 300
    vecs = rng.standard_normal((n, DIMS)).astype(np.float32)
    points = [{"id": i, "vector": vecs[i].tolist(),
               "payload": _payload(rng, i)} for i in range(n)]
    near = (vecs[rng.choice(n, 6, replace=False)]
            + 0.05 * rng.standard_normal((6, DIMS))).astype(np.float32)
    g = int(rng.integers(0, 7))
    out = [
        ("GET", "/collections", None),
        ("PUT", "/collections/docs",
         {"vectors": {"size": DIMS, "distance": "Cosine"}}),
        ("PUT", "/collections/docs/points", {"points": points[:200]}),
        ("PUT", "/collections/docs/points", {"points": points[200:]}),
        # an upsert over existing points: new payload, new vector
        ("PUT", "/collections/docs/points", {"points": [
            {"id": 5, "vector": vecs[6].tolist(), "payload": {"k": "v"}}]}),
        ("GET", "/collections", None),
        ("GET", "/collections/docs", None),
    ]
    for q in near:
        out.append(("POST", "/collections/docs/points/search",
                    {"vector": q.tolist(), "limit": 10}))
    out += [
        ("POST", "/collections/docs/points/search",
         {"vector": near[0].tolist(), "limit": 5, "with_payload": False}),
        ("POST", "/collections/docs/points/search",
         {"vector": near[1].tolist(), "limit": 50, "score_threshold": 0.2}),
        ("POST", "/collections/docs/points/search",
         {"vector": near[2].tolist(), "limit": 8,
          "filter": {"must": [{"key": "group", "match": {"value": g}}]}}),
        ("POST", "/collections/docs/points/search",
         {"vector": near[3].tolist(), "limit": 8,
          "filter": {"should": [{"key": "meta.tags", "match": {"any": ["a"]}},
                                {"key": "flag", "match": {"value": True}}],
                     "must_not": [{"key": "meta.rank",
                                   "range": {"gte": 25}}]}}),
        ("POST", "/collections/docs/points/count", {}),
        ("POST", "/collections/docs/points/count",
         {"filter": {"must": [{"key": "group", "match": {"value": g}}]}}),
        ("POST", "/collections/docs/points/count",
         {"filter": {"must": [{"is_null": {"key": "opt"}}]}}),
        ("POST", "/collections/docs/points/scroll", {"limit": 25}),
        ("POST", "/collections/docs/points/scroll",
         {"limit": 10, "offset": 137,
          "filter": {"must": [{"key": "word", "match": {"text": "a"}}]}}),
        ("POST", "/collections/docs/points",
         {"ids": [int(i) for i in rng.choice(n, 8, replace=False)] + [9999]}),
        ("POST", "/collections/docs/points/delete",
         {"points": [int(i) for i in rng.choice(n, 20, replace=False)]
          + [9999]}),
        ("POST", "/collections/docs/points/count", {}),
        ("POST", "/collections/docs/points/search",
         {"vector": near[4].tolist(), "limit": 10}),
        ("POST", "/collections/docs/snapshots", {}),
        # named vectors
        ("PUT", "/collections/multi",
         {"vectors": {"text": {"size": DIMS, "distance": "Cosine"},
                      "small": {"size": 4, "distance": "Cosine"}}}),
        ("PUT", "/collections/multi/points", {"points": [
            {"id": f"p{i}", "vector": {
                "text": vecs[i].tolist(),
                "small": vecs[i, :4].tolist()},
             "payload": {"i": i}} for i in range(40)]}),
        ("POST", "/collections/multi/points/search",
         {"vector": {"name": "small", "vector": near[5, :4].tolist()},
          "limit": 5}),
        ("POST", "/collections/multi/points/search",
         {"vector": {"name": "text", "vector": near[5].tolist()},
          "limit": 5}),
        ("POST", "/collections/multi/points", {"ids": ["p1", "p3"]}),
        ("POST", "/collections/multi/snapshots", {}),
        # errors: dims mismatch, unknown collections and routes
        ("PUT", "/collections/multi/points", {"points": [
            {"id": "bad", "vector": {"small": [1.0, 0.0]}}]}),
        ("GET", "/collections/nope", None),
        ("POST", "/collections/nope/points/search",
         {"vector": near[0].tolist()}),
        ("POST", "/collections/nope/snapshots", {}),
        ("POST", "/collections/docs/points/unknown", {}),
        ("DELETE", "/collections/multi", None),
        ("DELETE", "/collections/multi", None),
        ("GET", "/collections", None),
    ]
    return out


def _strip(hit: dict) -> dict:
    return {k: v for k, v in hit.items() if k != "score"}


def _same_hits(a: list, b: list) -> None:
    """Equal hit lists, scores within SCORE_TOL. Two hits whose scores lie
    within SCORE_TOL may trade places (or, at the limit, one may be cut
    for the other); every hit is otherwise the same in both."""
    assert len(a) == len(b)
    in_a = {h["id"]: h for h in a}
    in_b = {h["id"]: h for h in b}
    for x, y in zip(a, b):
        assert abs(x["score"] - y["score"]) <= SCORE_TOL, (x, y)
        if x["id"] == y["id"]:
            assert _strip(x) == _strip(y)
            continue
        for h, other, seq in ((x, in_b, b), (y, in_a, a)):
            twin = other.get(h["id"])
            if twin is not None:
                assert abs(twin["score"] - h["score"]) <= SCORE_TOL, (h, twin)
                assert _strip(twin) == _strip(h)
            else:  # cut at the limit for a hit it ties with
                assert abs(h["score"] - seq[-1]["score"]) <= SCORE_TOL, h


@pytest.fixture
def both_servers():
    jdb = nornicdb_tpu.open_db("")
    pdb = nornicdb_tpu_torch.open_db("", device="cpu")
    js, ps = JaxHttpServer(jdb, port=0), HttpServer(pdb, port=0)
    js.start()
    ps.start()
    yield js, ps
    ps.stop()
    js.stop()
    pdb.close()
    jdb.close()


class TestQdrantParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_rest_sequence_equal(self, both_servers, seed):
        js, ps = both_servers
        searches = 0
        for method, path, body in _requests(seed):
            jc, jb = _status_req(js.port, method, path, body)
            pc, pb = _status_req(ps.port, method, path, body)
            assert jc == pc, (method, path, jb, pb)
            if path.endswith("/points/search") and jc == 200:
                assert set(jb) == set(pb) == {"result", "status", "time"}
                assert (jb["status"], jb["time"]) == (pb["status"], pb["time"])
                _same_hits(jb["result"], pb["result"])
                searches += 1
            else:
                assert jb == pb, (method, path)
        assert searches == 13

    def test_points_and_registry_equal_after_the_sequence(self,
                                                          both_servers):
        js, ps = both_servers
        for method, path, body in _requests(3):
            _status_req(js.port, method, path, body)
            _status_req(ps.port, method, path, body)

        def points(srv):
            return sorted(
                (n.id, sorted(n.labels), json.dumps(n.properties,
                                                    sort_keys=True),
                 None if n.embedding is None else n.embedding.tolist())
                for n in srv.db.storage.get_nodes_by_label("QdrantPoint"))

        assert points(js) == points(ps)
        jr, pr = js.qdrant, ps.qdrant
        assert jr.list() == pr.list()
        for name in ("docs",):
            assert jr.params(name) == pr.params(name)
            assert jr.info(name) == pr.info(name)
        assert sorted(jr._corpora) == sorted(pr._corpora)
        for key in jr._corpora:
            assert len(jr._corpora[key]) == len(pr._corpora[key]), key


# ------------------------------------------------------------- filters
def _condition(rng, depth: int):
    kind = int(rng.integers(0, 14 if depth < 2 else 12))
    key = str(rng.choice(["group", "word", "flag", "doc", "score",
                          "meta.rank", "meta.tags", "opt", "missing",
                          "meta.missing"]))
    if kind == 0:
        return {"key": key, "match": {"value": _scalar(rng)}}
    if kind == 1:
        return {"key": key, "match": {
            str(rng.choice(["keyword", "integer", "boolean"])):
                _scalar(rng)}}
    if kind == 2:
        return {"key": key, "match": {"text": str(rng.choice(
            ["a", "ph", "graph", "", "zz"]))}}
    if kind == 3:
        return {"key": key, "match": {"any": [_scalar(rng) for _ in range(
            int(rng.integers(0, 4)))]}}
    if kind == 4:
        return {"key": key, "match": {"except": [_scalar(rng) for _ in range(
            int(rng.integers(0, 3)))]}}
    if kind in (5, 6):
        rng_ = {}
        for op in ("gt", "gte", "lt", "lte"):
            if rng.integers(0, 2):
                rng_[op] = (None if rng.integers(0, 6) == 0
                            else int(rng.integers(-2, 40)))
        return {"key": key, "range": rng_}
    if kind == 7:
        return {"has_id": [int(i) for i in rng.integers(0, 60, 5)]}
    if kind == 8:
        return {"has_id": int(rng.integers(0, 60))}
    if kind == 9:
        return {"is_empty": {"key": key}}
    if kind == 10:
        return {"is_null": {"key": key}}
    if kind == 11:  # malformed: refused alike, or read as JAX reads it
        return [{"key": key, "match": {"any": "not-a-list"}},
                {"key": key, "match": {"bogus": 1}},
                {"key": key, "geo_radius": {}},
                {"match": {"value": 1}}][int(rng.integers(0, 4))]
    if kind == 12:
        return _filter(rng, depth + 1)  # a nested Filter as a condition
    return {"filter": _filter(rng, depth + 1)}


def _scalar(rng):
    return [int(rng.integers(0, 8)), str(rng.choice(["alpha", "a", "graph node",
                                                     ""])),
            bool(rng.integers(0, 2)), 1, True, 0, False][int(rng.integers(0, 7))]


def _filter(rng, depth: int = 0) -> dict:
    out = {}
    for clause in ("must", "should", "must_not"):
        roll = int(rng.integers(0, 4))
        if roll == 0:
            continue
        conds = [_condition(rng, depth) for _ in range(int(rng.integers(1, 3)))]
        out[clause] = conds[0] if roll == 1 else conds  # dict or list form
    return out


def _outcome(eval_filter, flt, pid, payload):
    try:
        return ("ok", eval_filter(flt, pid, payload))
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return (type(e).__name__, str(e))


class TestFilterParity:
    @pytest.mark.parametrize("seed", range(6))
    def test_seeded_filters_equal(self, seed):
        rng = np.random.default_rng(100 + seed)
        payloads = [_payload(rng, i) for i in range(60)]
        for p in payloads[::5]:
            p["word"] = [p["word"], "graph"]  # list-valued payloads
        for p in payloads[1::9]:
            p["meta"] = "flat"  # a dotted key through a non-dict
        filters = [_filter(rng) for _ in range(80)] + [None, {}]
        outcomes = set()
        for flt in filters:
            for i, p in enumerate(payloads):
                want = _outcome(jax_qdrant.eval_filter, flt, i, p)
                got = _outcome(port_qdrant.eval_filter, flt, i, p)
                assert got == want, (flt, i, p)
                outcomes.add(want[0] if want[0] != "ok" else want[1])
        # the draw reached matches, misses and refusals alike
        assert {True, False, "NornicError"} <= outcomes

    @pytest.mark.parametrize("flt", [
        {"must": [{"key": "meta.rank", "match": {"value": 3}}]},
        {"must": {"key": "word", "match": {"text": "ph"}}},
        {"should": [{"key": "group", "match": {"any": [1, 2]}}]},
        {"must": [{"key": "group", "match": {"except": [1, 2]}}]},
        {"must_not": [{"key": "flag", "match": {"boolean": True}}]},
        {"must": [{"key": "flag", "match": {"integer": 1}}]},
        {"must": [{"key": "score", "range": {"gt": 0, "lte": 1.5}}]},
        {"must": [{"key": "score", "range": {"gte": None, "lt": 0}}]},
        {"must": [{"has_id": [1, 3, 5]}]},
        {"must": [{"is_empty": {"key": "meta.tags"}}]},
        {"must": [{"is_null": {"key": "opt"}}]},
        {"must": [{"filter": {"should": [{"has_id": 4}]}}]},
        {"must": [{"must_not": [{"key": "group", "match": {"value": 0}}]}]},
        {"must": [{"key": "group"}]},
        {"must": [{"key": "group", "match": {"bogus": 1}}]},
        {"must": ["not-a-dict"]},
    ])
    def test_each_condition_kind_equal(self, flt):
        rng = np.random.default_rng(7)
        for i in range(40):
            p = _payload(rng, i)
            assert (_outcome(port_qdrant.eval_filter, flt, i, p)
                    == _outcome(jax_qdrant.eval_filter, flt, i, p)), (flt, p)


# --------------------------------------------------- device and the DB
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


class TestRegistryDevice:
    def test_every_corpus_on_the_named_device_and_owner(self):
        from nornicdb_tpu_torch.storage import MemoryEngine

        eng = MemoryEngine()
        mgr, hooks = _degraded_owner()
        try:
            reg = QdrantCollections(eng, device="cpu")
            reg.create("d", 4, named={"t": {"size": 2}})
            reg.upsert("d", [{"id": 1, "vector": [1, 0, 0, 0]}])
            reg.create("m", named={"t": {"size": 2}})
            reg.upsert("m", [{"id": 1, "vector": {"t": [1, 0]}}])
            reg2 = QdrantCollections(eng, device="cpu")
            # the rebuild knows a named vector only from a stored point
            assert sorted(reg._corpora) == ["d", "d/t", "m/t"]
            assert sorted(reg2._corpora) == ["d", "m/t"]
            for r in (reg, reg2):  # create and the rebuild alike
                for c in r._corpora.values():
                    assert c.device == torch.device("cpu")
                    # a CPU corpus has no owner unless one is injected, as
                    # tests/test_torch_server_policy.py injects it
                    assert c.backend is None
                    c._backend = mgr
            # the owner is not serving: a search raises, nothing answers
            # from the host
            with pytest.raises(DeviceUnavailable):
                reg.search("d", [1, 0, 0, 0], limit=1)
            with pytest.raises(DeviceUnavailable):
                reg2.search("m", {"name": "t", "vector": [1, 0]}, limit=1)
            hooks.set_mode("ok")
            deadline = time.monotonic() + 10
            while mgr.state != backend_mod.READY:
                assert time.monotonic() < deadline, mgr.state
                time.sleep(0.01)
            assert reg.search("d", [1, 0, 0, 0], limit=1)[0]["id"] == 1
            assert reg2.search("m", {"name": "t", "vector": [1, 0]},
                               limit=1)[0]["id"] == 1
        finally:
            mgr.stop()

    def test_default_device_is_the_card(self):
        from nornicdb_tpu_torch.storage import MemoryEngine

        if torch.cuda.is_available():
            pytest.skip("the default device is present here")
        with pytest.raises(DeviceUnavailable):
            QdrantCollections(MemoryEngine())

    def test_db_has_one_registry_on_its_device(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            got = []
            threads = [threading.Thread(
                target=lambda: got.append(db.qdrant_registry()))
                for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert len({id(r) for r in got}) == 1
            reg = got[0]
            assert reg is db.qdrant_registry()
            assert reg.device == db.device == torch.device("cpu")
            assert reg.vectorspaces is db.vectorspaces
            srv = HttpServer(db, port=0)
            assert srv.qdrant is reg  # the server shares it
            reg.create("c", 2)
            assert "qdrant:c" in [k.name for k in db.vectorspaces.list()]
        finally:
            db.close()

    def test_registry_rebuilds_from_a_reopened_db(self, tmp_path):
        d = str(tmp_path / "db")
        db = nornicdb_tpu_torch.open_db(d, device="cpu")
        reg = db.qdrant_registry()
        reg.create("c", 3)
        reg.upsert("c", [{"id": i, "vector": [1.0, float(i), 0.0],
                          "payload": {"i": i}} for i in range(5)])
        db.flush()
        db.close()
        db2 = nornicdb_tpu_torch.open_db(d, device="cpu")
        try:
            reg2 = db2.qdrant_registry()
            assert reg2.count("c") == 5
            hits = reg2.search("c", [1.0, 4.0, 0.0], limit=2)
            assert [h["id"] for h in hits] == [4, 3]
            assert hits[0]["payload"] == {"i": 4}
            assert reg2._corpora["c"].device == torch.device("cpu")
        finally:
            db2.close()
