"""Qdrant gRPC wire-level tests (ref: pkg/qdrantgrpc — the reference tests
with the official client, qdrant_official_e2e_test.go; that client is not in
this image, so these speak hand-encoded v1.16 protobuf frames through a raw
channel, the same approach the reference's collections_service_test.go
takes against hand-built requests).

The port's copy of ``tests/test_qdrant_grpc.py``: the JAX cases with only
their imports, the device argument (``device="cpu"``) and the channel
changed (the port's ``grpcwire.Channel``, whose ``RpcError`` and
``StatusCode`` have grpcio's names). Then, at the end, the port against
the JAX package's grpcio server method by method over the same request
bytes, and the ``DeviceUnavailable`` mapping."""

import struct

import numpy as np
import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.auth import Authenticator, ROLE_ADMIN, ROLE_VIEWER
from nornicdb_tpu_torch.server.qdrant import QdrantCollections
from nornicdb_tpu_torch.server.qdrant_grpc import (
    QdrantGrpcServer,
    _f32,
    _first,
    _floats,
    _ld,
    _packed_f32,
    _parse,
    _s,
    _vi,
    dec_payload_map,
    dec_point_id,
    dec_value,
    dec_vectors,
    enc_payload_map,
    enc_point_id,
    enc_value,
    enc_vectors,
)
from nornicdb_tpu_torch.server import grpcwire
from nornicdb_tpu_torch.server.grpcwire import StatusCode
from nornicdb_tpu_torch.storage import MemoryEngine


class TestValueCodec:
    @pytest.mark.parametrize("v", [
        None, True, False, 0, 7, -42, 3.5, "", "hello",
        [1, "two", None], {"k": "v", "n": {"deep": [1.5, False]}},
    ])
    def test_roundtrip(self, v):
        assert dec_value(enc_value(v)) == v

    def test_payload_map_roundtrip(self):
        p = {"city": "Oslo", "pop": 700000, "tags": ["a", "b"],
             "geo": {"lat": 59.9, "lon": 10.7}}
        parsed = _parse(enc_payload_map(3, p))
        assert dec_payload_map(parsed[3]) == p

    def test_point_id_roundtrip(self):
        assert dec_point_id(enc_point_id(42)) == 42
        assert dec_point_id(enc_point_id("uuid-x")) == "uuid-x"

    def test_vectors_roundtrip(self):
        v = dec_vectors(enc_vectors([1.0, 2.0, -3.0]))
        assert v == [1.0, 2.0, -3.0]
        named = dec_vectors(enc_vectors({"text": [1.0, 0.0], "img": [0.5]}))
        assert named == {"text": [1.0, 0.0], "img": [0.5]}


class _Client:
    def __init__(self, port, metadata=None):
        self.port = port
        self.metadata = metadata or []
        self.channel = grpcwire.Channel("127.0.0.1", port)

    def call(self, method, payload: bytes) -> bytes:
        fn = self.channel.unary_unary(method)
        return fn(payload, timeout=10, metadata=self.metadata)


@pytest.fixture
def qdrant_grpc(tmp_path):
    registry = QdrantCollections(MemoryEngine(), device="cpu")
    srv = QdrantGrpcServer(registry, port=0,
                           snapshot_dir=str(tmp_path / "snaps"))
    srv.start()
    yield registry, srv, _Client(srv.port)
    srv.stop()


def _create_collection(c, name="docs", size=4, named=None):
    if named:
        # VectorsConfig.params_map=2 -> VectorParamsMap{map=1 entries}
        entries = b"".join(
            _ld(1, _s(1, vn) + _ld(2, _vi(1, sz) + _vi(2, 1)))
            for vn, sz in named.items())
        cfg = _ld(2, entries)
    else:
        cfg = _ld(1, _vi(1, size) + _vi(2, 1))  # VectorParams{size, Cosine}
    return c.call("/qdrant.Collections/Create", _s(1, name) + _ld(10, cfg))


def _upsert(c, name, pid, vec, payload=None):
    point = _ld(1, enc_point_id(pid))
    if payload:
        point += enc_payload_map(3, payload)
    point += _ld(4, enc_vectors(vec))
    return c.call("/qdrant.Points/Upsert", _s(1, name) + _ld(3, point))


class TestQdrantGrpc:
    def test_health(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        f = _parse(c.call("/qdrant.Qdrant/HealthCheck", b""))
        assert b"qdrant" in f[1][0][1]
        assert f[2][0][1] == b"1.16.0"

    def test_collection_lifecycle(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        resp = _parse(_create_collection(c, "docs", 4))
        assert resp[1][0][1] == 1  # result: true
        # exists
        f = _parse(c.call("/qdrant.Collections/CollectionExists",
                          _s(1, "docs")))
        assert _parse(f[1][0][1])[1][0][1] == 1
        # list
        f = _parse(c.call("/qdrant.Collections/List", b""))
        names = [_parse(raw)[1][0][1].decode() for _, raw in f[1]]
        assert "docs" in names
        # get info: size+distance round-trips
        f = _parse(c.call("/qdrant.Collections/Get", _s(1, "docs")))
        info = _parse(f[1][0][1])
        cfg = _parse(info[7][0][1])
        params = _parse(cfg[1][0][1])
        vc = _parse(params[5][0][1])
        vp = _parse(vc[1][0][1])
        assert vp[1][0][1] == 4 and vp[2][0][1] == 1  # size=4, Cosine
        # delete
        f = _parse(c.call("/qdrant.Collections/Delete", _s(1, "docs")))
        assert f[1][0][1] == 1
        f = _parse(c.call("/qdrant.Collections/CollectionExists",
                          _s(1, "docs")))
        assert 1 not in _parse(f[1][0][1])  # exists=false omitted

    def test_upsert_search_payload_roundtrip(self, qdrant_grpc):
        registry, _, c = qdrant_grpc
        _create_collection(c, "docs", 4)
        _upsert(c, "docs", 1, [1.0, 0.0, 0.0, 0.0],
                {"title": "first", "rank": 1, "meta": {"ok": True}})
        _upsert(c, "docs", 2, [0.0, 1.0, 0.0, 0.0], {"title": "second"})
        # search near point 1 with payload
        req = (_s(1, "docs") + _packed_f32(2, [1.0, 0.0, 0.0, 0.0])
               + _vi(4, 2) + _ld(6, _vi(1, 1)))
        f = _parse(c.call("/qdrant.Points/Search", req))
        hits = []
        for _, raw in f[1]:
            hf = _parse(raw)
            pid = dec_point_id(hf[1][0][1])
            score = struct.unpack("<f", hf[3][0][1])[0]
            payload = dec_payload_map(hf.get(2, []))
            hits.append((pid, score, payload))
        assert hits[0][0] == 1
        assert hits[0][1] > 0.99
        assert hits[0][2] == {"title": "first", "rank": 1,
                              "meta": {"ok": True}}
        # the point is also visible through the shared REST registry
        assert registry.info("docs")["points_count"] == 2

    def test_get_count_scroll_delete(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        _create_collection(c, "docs", 2)
        for i in range(5):
            _upsert(c, "docs", i, [float(i), 1.0], {"i": i})
        # count
        f = _parse(c.call("/qdrant.Points/Count", _s(1, "docs")))
        assert _parse(f[1][0][1])[1][0][1] == 5
        # get by ids
        req = _s(1, "docs") + _ld(2, enc_point_id(3))
        f = _parse(c.call("/qdrant.Points/Get", req))
        pf = _parse(f[1][0][1])
        assert dec_point_id(pf[1][0][1]) == 3
        assert dec_vectors(pf[4][0][1]) == [3.0, 1.0]
        # scroll pages of 2: ids ordered 0,1 | 2,3 | 4
        req = _s(1, "docs") + _vi(4, 2)
        f = _parse(c.call("/qdrant.Points/Scroll", req))
        page1 = [dec_point_id(_parse(raw)[1][0][1]) for _, raw in f[2]]
        assert page1 == [0, 1]
        nxt = dec_point_id(f[1][0][1])
        assert nxt == 2
        f = _parse(c.call("/qdrant.Points/Scroll",
                          _s(1, "docs") + _ld(3, enc_point_id(nxt))
                          + _vi(4, 2)))
        page2 = [dec_point_id(_parse(raw)[1][0][1]) for _, raw in f[2]]
        assert page2 == [2, 3]
        # delete two points
        sel = _ld(1, _ld(1, enc_point_id(0)) + _ld(1, enc_point_id(1)))
        c.call("/qdrant.Points/Delete", _s(1, "docs") + _ld(3, sel))
        f = _parse(c.call("/qdrant.Points/Count", _s(1, "docs")))
        assert _parse(f[1][0][1])[1][0][1] == 3

    def test_named_vectors(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        _create_collection(c, "multi", named={"text": 2, "img": 3})
        _upsert(c, "multi", "a", {"text": [1.0, 0.0], "img": [0.0, 1.0, 0.0]})
        # named search via vector_name=10
        req = (_s(1, "multi") + _packed_f32(2, [1.0, 0.0]) + _vi(4, 1)
               + _s(10, "text"))
        f = _parse(c.call("/qdrant.Points/Search", req))
        hf = _parse(f[1][0][1])
        assert dec_point_id(hf[1][0][1]) == "a"

    def test_payload_ops(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        _create_collection(c, "docs", 2)
        _upsert(c, "docs", 9, [1.0, 0.0], {"keep": 1, "drop": 2})
        sel = _ld(5, _ld(1, _ld(1, enc_point_id(9))))
        # set
        c.call("/qdrant.Points/SetPayload",
               _s(1, "docs") + enc_payload_map(3, {"added": "yes"}) + sel)
        req = _s(1, "docs") + _ld(2, enc_point_id(9))
        pf = _parse(_parse(c.call("/qdrant.Points/Get", req))[1][0][1])
        payload = dec_payload_map(pf.get(2, []))
        assert payload == {"keep": 1, "drop": 2, "added": "yes"}
        # delete one key (keys=3 repeated string)
        c.call("/qdrant.Points/DeletePayload",
               _s(1, "docs") + _s(3, "drop") + sel)
        pf = _parse(_parse(c.call("/qdrant.Points/Get", req))[1][0][1])
        assert dec_payload_map(pf.get(2, [])) == {"keep": 1, "added": "yes"}
        # clear (ClearPayloadPoints.points=3)
        sel3 = _ld(3, _ld(1, _ld(1, enc_point_id(9))))
        c.call("/qdrant.Points/ClearPayload", _s(1, "docs") + sel3)
        pf = _parse(_parse(c.call("/qdrant.Points/Get", req))[1][0][1])
        assert dec_payload_map(pf.get(2, [])) == {}

    def test_snapshots(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        _create_collection(c, "docs", 2)
        _upsert(c, "docs", 1, [1.0, 0.0], {"x": 1})
        f = _parse(c.call("/qdrant.Snapshots/Create", _s(1, "docs")))
        desc = _parse(f[1][0][1])
        name = desc[1][0][1].decode()
        assert name.startswith("docs-") and desc[3][0][1] > 0
        f = _parse(c.call("/qdrant.Snapshots/List", _s(1, "docs")))
        names = [_parse(raw)[1][0][1].decode() for _, raw in f[1]]
        assert name in names
        c.call("/qdrant.Snapshots/Delete", _s(1, "docs") + _s(2, name))
        f = _parse(c.call("/qdrant.Snapshots/List", _s(1, "docs")))
        assert 1 not in f

    def test_missing_collection_is_not_found(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        with pytest.raises(grpcwire.RpcError) as e:
            c.call("/qdrant.Points/Count", _s(1, "nope"))
        assert e.value.code() == StatusCode.NOT_FOUND


class TestQdrantGrpcAuth:
    @pytest.fixture
    def authed(self, tmp_path):
        auth = Authenticator(MemoryEngine())
        auth.create_user("admin", "pw", ROLE_ADMIN)
        auth.create_user("ro", "pw", ROLE_VIEWER)
        registry = QdrantCollections(MemoryEngine(), device="cpu")
        srv = QdrantGrpcServer(registry, port=0, authenticator=auth,
                               snapshot_dir=str(tmp_path / "s"))
        srv.start()
        yield auth, srv
        srv.stop()

    def _basic(self, user):
        import base64
        return [("authorization",
                 "Basic " + base64.b64encode(f"{user}:pw".encode()).decode())]

    def test_unauthenticated_rejected(self, authed):
        _, srv = authed
        c = _Client(srv.port)
        with pytest.raises(grpcwire.RpcError) as e:
            c.call("/qdrant.Collections/List", b"")
        assert e.value.code() == StatusCode.UNAUTHENTICATED
        # health stays open (upstream qdrant behavior)
        f = _parse(c.call("/qdrant.Qdrant/HealthCheck", b""))
        assert 2 in f

    def test_viewer_reads_but_cannot_write(self, authed):
        auth, srv = authed
        admin = _Client(srv.port, self._basic("admin"))
        ro = _Client(srv.port, self._basic("ro"))
        _create_collection(admin, "docs", 2)
        _upsert(admin, "docs", 1, [1.0, 0.0])
        # viewer: read OK
        f = _parse(ro.call("/qdrant.Points/Count", _s(1, "docs")))
        assert _parse(f[1][0][1])[1][0][1] == 1
        # viewer: write denied
        with pytest.raises(grpcwire.RpcError) as e:
            _upsert(ro, "docs", 2, [0.0, 1.0])
        assert e.value.code() == StatusCode.PERMISSION_DENIED

    def test_bearer_token(self, authed):
        auth, srv = authed
        token = auth.authenticate("admin", "pw")
        c = _Client(srv.port, [("authorization", f"Bearer {token}")])
        assert _parse(_create_collection(c, "t", 2))[1][0][1] == 1
        # api-key metadata carries the same JWT (qdrant SDK convention)
        c2 = _Client(srv.port, [("api-key", token)])
        f = _parse(c2.call("/qdrant.Collections/List", b""))
        assert 1 in f


class TestVectorMutationGate:
    def test_disallowed_vector_mutations(self, tmp_path):
        registry = QdrantCollections(MemoryEngine(), device="cpu")
        srv = QdrantGrpcServer(registry, port=0,
                               allow_vector_mutations=False)
        srv.start()
        try:
            c = _Client(srv.port)
            _create_collection(c, "docs", 2)
            with pytest.raises(grpcwire.RpcError) as e:
                _upsert(c, "docs", 1, [1.0, 0.0])
            assert e.value.code() == StatusCode.FAILED_PRECONDITION
        finally:
            srv.stop()


class TestHardening:
    def test_snapshot_path_traversal_rejected(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        _create_collection(c, "docs", 2)
        with pytest.raises(grpcwire.RpcError) as e:
            c.call("/qdrant.Snapshots/Delete",
                   _s(1, "../../../etc") + _s(2, "passwd"))
        assert e.value.code() in (StatusCode.INVALID_ARGUMENT,
                                  StatusCode.NOT_FOUND)
        with pytest.raises(grpcwire.RpcError) as e:
            c.call("/qdrant.Snapshots/Create", _s(1, "a/b"))
        assert e.value.code() in (StatusCode.INVALID_ARGUMENT,
                                  StatusCode.NOT_FOUND)

    def test_malformed_frame_is_invalid_argument(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        with pytest.raises(grpcwire.RpcError) as e:
            # truncated: tag promises a length-delimited field of 200 bytes
            c.call("/qdrant.Collections/Get", b"\x0a\xc8")
        assert e.value.code() == StatusCode.INVALID_ARGUMENT

    def test_truncated_length_delimited_rejected(self, qdrant_grpc):
        _, _, c = qdrant_grpc
        with pytest.raises(grpcwire.RpcError) as e:
            # field 1 declares 100 bytes but only 2 are present — must not
            # silently decode the short prefix as a valid collection name
            c.call("/qdrant.Collections/Get", b"\x0a\x64xx")
        assert e.value.code() == StatusCode.INVALID_ARGUMENT

    def test_payload_cannot_clobber_internal_keys(self, qdrant_grpc):
        registry, _, c = qdrant_grpc
        _create_collection(c, "docs", 2)
        _upsert(c, "docs", 9, [1.0, 0.0], {"_collection": "evil", "ok": 1})
        sel = _ld(5, _ld(1, _ld(1, enc_point_id(9))))
        c.call("/qdrant.Points/SetPayload",
               _s(1, "docs") + enc_payload_map(3, {"_point_id": 404}) + sel)
        assert registry.info("docs")["points_count"] == 1
        item = registry.retrieve("docs", [9])[0]
        assert item["payload"] == {"ok": 1}


def _match_cond(key, match: dict) -> bytes:
    """Condition{field=1 FieldCondition{key=1, match=2 Match{...}}}"""
    if "keyword" in match:
        m = _s(1, match["keyword"])
    elif "integer" in match:
        m = _vi(2, match["integer"])
    elif "boolean" in match:
        m = _vi(3, 1 if match["boolean"] else 0)
    elif "text" in match:
        m = _s(4, match["text"])
    else:
        raise AssertionError(match)
    return _ld(1, _s(1, key) + _ld(2, m))


def _f64le(field, v):
    return bytes([(field << 3) | 1]) + struct.pack("<d", v)


class TestFilters:
    """Qdrant Filter support over gRPC (ref: points filters in
    pkg/qdrantgrpc/points_service.go — must/should/must_not, match, range,
    has_id; also exercised on the shared registry for the REST transport)."""

    @pytest.fixture
    def seeded(self, qdrant_grpc):
        registry, srv, c = qdrant_grpc
        _create_collection(c, "docs", 2)
        _upsert(c, "docs", 1, [1.0, 0.0], {"city": "Oslo", "pop": 700})
        _upsert(c, "docs", 2, [0.9, 0.1], {"city": "Bergen", "pop": 290})
        _upsert(c, "docs", 3, [0.0, 1.0], {"city": "Oslo", "pop": 700,
                                           "tags": ["a", "b"]})
        return registry, c

    def test_search_with_match_filter(self, seeded):
        _, c = seeded
        flt = _ld(3, _ld(2, _match_cond("city", {"keyword": "Oslo"})))
        req = (_s(1, "docs") + _packed_f32(2, [1.0, 0.0]) + flt + _vi(4, 10))
        f = _parse(c.call("/qdrant.Points/Search", req))
        ids = sorted(dec_point_id(_parse(raw)[1][0][1]) for _, raw in f[1])
        assert ids == [1, 3]

    def test_count_with_range_filter(self, seeded):
        _, c = seeded
        # Range{gte=3 (double) 300}
        rng = _ld(1, _s(1, "pop") + _ld(3, _f64le(3, 300.0)))
        flt = _ld(2, _ld(2, rng))  # CountPoints.filter=2, Filter.must=2
        f = _parse(c.call("/qdrant.Points/Count", _s(1, "docs") + flt))
        assert _parse(f[1][0][1])[1][0][1] == 2  # pids 1 and 3 (pop 700)

    def test_scroll_with_must_not(self, seeded):
        _, c = seeded
        flt = _ld(2, _ld(3, _match_cond("city", {"keyword": "Oslo"})))
        f = _parse(c.call("/qdrant.Points/Scroll",
                          _s(1, "docs") + flt + _vi(4, 10)))
        ids = [dec_point_id(_parse(raw)[1][0][1]) for _, raw in f[2]]
        assert ids == [2]

    def test_delete_by_filter_selector(self, seeded):
        _, c = seeded
        sel = _ld(2, _ld(2, _match_cond("city", {"keyword": "Bergen"})))
        c.call("/qdrant.Points/Delete", _s(1, "docs") + _ld(3, sel))
        f = _parse(c.call("/qdrant.Points/Count", _s(1, "docs")))
        assert _parse(f[1][0][1])[1][0][1] == 2

    def test_rest_shares_the_evaluator(self, seeded):
        registry, _ = seeded
        hits = registry.search(
            "docs", [1.0, 0.0], limit=10,
            query_filter={"must": [{"key": "tags",
                                    "match": {"value": "a"}}]})
        assert [h["id"] for h in hits] == [3]
        assert registry.count(
            "docs", {"must_not": [{"key": "city",
                                   "match": {"value": "Oslo"}}]}) == 1
        assert registry.count("docs", {"must": [{"has_id": [1, 2]}]}) == 2
        page, nxt = registry.scroll(
            "docs", limit=1,
            query_filter={"should": [
                {"key": "city", "match": {"value": "Oslo"}}]})
        assert page == [1] and nxt == 3


# ------------------------------------------------- the port against JAX
SCORE_TOL = 4e-3  # test_torch_qdrant.py's tolerance for both scores
# the field of each response that carries the server's own time
_TIME_FIELD = {"/qdrant.Points/Scroll": 3, "/qdrant.Snapshots/Delete": 1,
               "/qdrant.Qdrant/HealthCheck": None}


def _normal(method: str, raw: bytes):
    """A response without its time field; a search's hits as (id, score,
    payload, vectors) for the score tolerance; a snapshot's description
    as its collection prefix (the name and creation time carry a clock)."""
    f = _parse(raw)
    f.pop(_TIME_FIELD.get(method, 2), None)
    if method == "/qdrant.Points/Search":
        hits = []
        for _, hit in f.get(1, []):
            hf = _parse(hit)
            hits.append((dec_point_id(hf[1][0][1]),
                         struct.unpack("<f", hf[3][0][1])[0],
                         dec_payload_map(hf.get(2, [])),
                         dec_vectors(hf[6][0][1]) if 6 in hf else None))
        return hits
    if method == "/qdrant.Snapshots/Create":
        desc = _parse(f[1][0][1])
        return desc[1][0][1].split(b"-")[0]
    if method == "/qdrant.Snapshots/List":
        return [_parse(d)[1][0][1].split(b"-")[0] for _, d in f.get(1, [])]
    return f


def _same_search(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= SCORE_TOL, (g, w)
        if g[0] != w[0]:  # a tie within the tolerance may trade places
            twin = next((x for x in want if x[0] == g[0]), None)
            assert twin is not None and abs(twin[1] - g[1]) <= SCORE_TOL
    by_id = {w[0]: w for w in want}
    for g in got:
        if g[0] in by_id:
            assert g[2:] == by_id[g[0]][2:], g[0]


def _parity_requests(seed: int) -> list:
    """(method, request bytes) of one seeded session: collections, loads,
    searches (filters, thresholds, payload and vector selectors, named
    vectors), counts, scrolls, retrieves, payload operations, deletes,
    snapshots and errors."""
    rng = np.random.default_rng(seed)
    dims = 8
    reqs = [("/qdrant.Qdrant/HealthCheck", b"")]

    def create(name, size=0, named=None):
        if named:
            entries = b"".join(
                _ld(1, _s(1, vn) + _ld(2, _vi(1, sz) + _vi(2, 1)))
                for vn, sz in named.items())
            cfg = _ld(2, entries)
        else:
            cfg = _ld(1, _vi(1, size) + _vi(2, 1))
        return ("/qdrant.Collections/Create", _s(1, name) + _ld(10, cfg))

    reqs += [create("docs", dims), create("multi", named={"a": 4, "b": 6})]
    vecs = rng.standard_normal((60, dims)).astype(np.float32)
    for lo in range(0, 60, 20):
        body = b""
        for i in range(lo, lo + 20):
            pid = i if i % 7 else f"u-{i}"
            payload = {"g": int(i % 4), "name": f"p{i}",
                       "tags": ["x", "y"] if i % 3 == 0 else ["z"],
                       "w": float(np.round(rng.random(), 3))}
            body += _ld(3, _ld(1, enc_point_id(pid))
                        + enc_payload_map(3, payload)
                        + _ld(4, enc_vectors(vecs[i].tolist())))
        reqs.append(("/qdrant.Points/Upsert", _s(1, "docs") + body))
    named = rng.standard_normal((10, 10)).astype(np.float32)
    body = b"".join(
        _ld(3, _ld(1, enc_point_id(i)) + enc_payload_map(3, {"i": i})
            + _ld(4, enc_vectors({"a": named[i, :4].tolist(),
                                  "b": named[i, 4:].tolist()})))
        for i in range(10))
    reqs.append(("/qdrant.Points/Upsert", _s(1, "multi") + body))
    reqs += [("/qdrant.Collections/List", b""),
             ("/qdrant.Collections/CollectionExists", _s(1, "docs")),
             ("/qdrant.Collections/CollectionExists", _s(1, "nope")),
             ("/qdrant.Collections/Get", _s(1, "docs")),
             ("/qdrant.Collections/Get", _s(1, "multi"))]
    g1 = _ld(2, _match_cond("g", {"integer": 1}))
    for q in range(6):
        qv = (vecs[q * 9] + 0.1 * rng.standard_normal(dims)).tolist()
        req = _s(1, "docs") + _packed_f32(2, qv) + _vi(4, 5)
        if q % 2:
            req += _ld(3, g1)
        if q == 2:
            req += _f32(8, 0.3)
        if q == 3:
            req += _ld(6, _vi(1, 0))  # no payload
        if q == 4:
            req += _ld(11, _vi(1, 1))  # with vectors
        reqs.append(("/qdrant.Points/Search", req))
    reqs.append(("/qdrant.Points/Search", _s(1, "multi") + _packed_f32(
        2, named[3, 4:].tolist()) + _vi(4, 3) + _s(10, "b")))
    reqs += [("/qdrant.Points/Count", _s(1, "docs")),
             ("/qdrant.Points/Count", _s(1, "docs") + _ld(2, g1)),
             ("/qdrant.Points/Scroll", _s(1, "docs") + _vi(4, 7)),
             ("/qdrant.Points/Scroll", _s(1, "docs") + _ld(2, g1)
              + _ld(3, enc_point_id(9)) + _vi(4, 4)),
             ("/qdrant.Points/Get", _s(1, "docs") + _ld(2, enc_point_id(3))
              + _ld(2, enc_point_id("u-7")) + _ld(2, enc_point_id(999)))]
    sel = _ld(5, _ld(1, _ld(1, enc_point_id(3)) + _ld(1, enc_point_id(4))))
    get34 = _s(1, "docs") + _ld(2, enc_point_id(3)) + _ld(2, enc_point_id(4))
    reqs += [("/qdrant.Points/SetPayload", _s(1, "docs")
              + enc_payload_map(3, {"added": "yes", "_x": 1}) + sel),
             ("/qdrant.Points/Get", get34),
             ("/qdrant.Points/OverwritePayload", _s(1, "docs")
              + enc_payload_map(3, {"only": 1}) + sel),
             ("/qdrant.Points/Get", get34),
             ("/qdrant.Points/DeletePayload", _s(1, "docs") + _s(3, "only")
              + sel),
             ("/qdrant.Points/ClearPayload", _s(1, "docs")
              + _ld(3, _ld(1, _ld(1, enc_point_id(5))))),
             ("/qdrant.Points/Get", get34 + _ld(2, enc_point_id(5))),
             ("/qdrant.Points/Delete", _s(1, "docs") + _ld(3, _ld(1, _ld(
                 1, enc_point_id(1)) + _ld(1, enc_point_id("u-14"))))),
             ("/qdrant.Points/Delete", _s(1, "docs")
              + _ld(3, _ld(2, _ld(2, _match_cond("g", {"integer": 2}))))),
             ("/qdrant.Points/Count", _s(1, "docs")),
             ("/qdrant.Snapshots/Create", _s(1, "docs")),
             ("/qdrant.Snapshots/List", _s(1, "docs")),
             ("/qdrant.Collections/Update", _s(1, "docs")),
             ("/qdrant.Points/Count", _s(1, "gone")),
             ("/qdrant.Collections/Get", b"\x0a\xc8"),
             ("/qdrant.Snapshots/Delete", _s(1, "../x") + _s(2, "y")),
             ("/qdrant.Points/Nope", b""),
             ("/qdrant.Collections/Delete", _s(1, "multi")),
             ("/qdrant.Collections/List", b"")]
    return reqs


class TestBothPackages:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_method_by_method(self, seed, tmp_path):
        pytest.importorskip("grpc")
        from nornicdb_tpu.server.qdrant import (
            QdrantCollections as JaxCollections,
        )
        from nornicdb_tpu.server.qdrant_grpc import (
            QdrantGrpcServer as JaxServer,
        )
        from nornicdb_tpu.storage import MemoryEngine as JaxMemoryEngine

        jsrv = JaxServer(JaxCollections(JaxMemoryEngine()), port=0,
                         snapshot_dir=str(tmp_path / "jax"))
        psrv = QdrantGrpcServer(
            QdrantCollections(MemoryEngine(), device="cpu"), port=0,
            snapshot_dir=str(tmp_path / "port"))
        jsrv.start()
        psrv.start()
        try:
            with grpcwire.Channel("127.0.0.1", jsrv.port) as jch, \
                    grpcwire.Channel("127.0.0.1", psrv.port) as pch:
                for method, req in _parity_requests(seed):
                    outs = []
                    for ch in (jch, pch):
                        try:
                            outs.append(("ok", ch.unary_unary(method)(
                                req, timeout=30)))
                        except grpcwire.RpcError as e:
                            outs.append(("error", e.code()))
                    (jk, want), (pk, got) = outs
                    assert jk == pk, (method, want, got)
                    if jk == "error":
                        assert got == want, method
                    elif method == "/qdrant.Points/Search":
                        assert _normal(method, want), req  # hits to hold
                        _same_search(_normal(method, got),
                                     _normal(method, want))
                    else:
                        assert _normal(method, got) == \
                            _normal(method, want), method
        finally:
            psrv.stop()
            jsrv.stop()


class TestDeviceUnavailable:
    """The JAX ``_wrap`` maps every NornicError to INVALID_ARGUMENT; the
    port's ``DeviceUnavailable`` (a NornicError) answers UNAVAILABLE."""

    def _degraded_owner(self):
        from nornicdb_tpu_torch import backend as backend_mod
        from nornicdb_tpu_torch.backend import BackendManager, FakeHooks
        import time

        hooks = FakeHooks("hang")
        mgr = BackendManager(hooks=hooks, acquire_timeout=0.3,
                             probe_interval=0.03, probe_timeout=0.25,
                             degrade_after=3, recover_after=2)
        assert mgr.await_ready() is False
        deadline = time.monotonic() + 10
        while mgr.state != backend_mod.DEGRADED_CPU:
            assert time.monotonic() < deadline, mgr.state
            time.sleep(0.01)
        return mgr, hooks

    def test_search_on_a_sick_card_is_unavailable(self, qdrant_grpc):
        from nornicdb_tpu_torch import backend as backend_mod
        import time

        registry, _, c = qdrant_grpc
        _create_collection(c, "docs", 4)
        for i in range(6):
            _upsert(c, "docs", i, [1.0, float(i), 0.0, 0.5], {"i": i})
        search = (_s(1, "docs") + _packed_f32(2, [1.0, 0.0, 0.0, 0.0])
                  + _vi(4, 3))
        mgr, hooks = self._degraded_owner()
        corpus = registry._corpora["docs"]
        try:
            corpus._backend = mgr
            with pytest.raises(grpcwire.RpcError) as e:
                c.call("/qdrant.Points/Search", search)
            assert e.value.code() == StatusCode.UNAVAILABLE
            assert e.value.details().startswith("device_unavailable")
            # a method that touches no device still answers
            f = _parse(c.call("/qdrant.Points/Count", _s(1, "docs")))
            assert _parse(f[1][0][1])[1][0][1] == 6
            hooks.set_mode("ok")
            deadline = time.monotonic() + 10
            while mgr.state != backend_mod.READY:
                assert time.monotonic() < deadline, mgr.state
                time.sleep(0.01)
            f = _parse(c.call("/qdrant.Points/Search", search))
            assert dec_point_id(_parse(f[1][0][1])[1][0][1]) == 0
        finally:
            corpus._backend = None
            mgr.stop()

    def test_a_shed_stays_invalid_argument_as_in_jax(self, qdrant_grpc,
                                                     monkeypatch):
        from nornicdb_tpu_torch.errors import ResourceExhausted

        registry, _, c = qdrant_grpc
        _create_collection(c, "docs", 2)

        def shed(*a, **kw):
            raise ResourceExhausted("search batch queue full (test); "
                                    "retry with backoff")

        monkeypatch.setattr(registry, "search", shed)
        with pytest.raises(grpcwire.RpcError) as e:
            c.call("/qdrant.Points/Search", _s(1, "docs")
                   + _packed_f32(2, [1.0, 0.0]) + _vi(4, 1))
        assert e.value.code() == StatusCode.INVALID_ARGUMENT
        assert "queue full" in e.value.details()
