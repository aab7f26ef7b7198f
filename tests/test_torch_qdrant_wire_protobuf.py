"""Qdrant wire-format cross-validation against CANONICAL protobuf.

The reference proves client compatibility with the official Qdrant client
(ref: pkg/qdrantgrpc/qdrant_official_e2e_test.go). Zero egress blocks
pip-installing qdrant-client here, so this suite compiles the upstream
schema subset (tests/data/qdrant_subset.proto — identical field numbering)
with protoc and drives the server through a channel + Google's protobuf
runtime: every request is serialized by the canonical implementation and
every response parsed by it. A hand-codec bug that merely mirrored itself
(encode+decode agreeing on the wrong bytes) cannot pass these tests.

The port's copy of ``tests/test_qdrant_wire_protobuf.py``: the JAX cases
with only their imports, the device argument (``device="cpu"``) and the
channel changed (the port's ``grpcwire.Channel`` instead of grpcio's;
the test serialises each message and parses each answer itself).
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTO = os.path.join(ROOT, "tests", "data", "qdrant_subset.proto")


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    """protoc-compile the upstream-schema subset and import the stubs."""
    # the generated stubs need Google's protobuf runtime: skip, not error,
    # when the optional dep is absent (protoc-missing already skips below)
    pytest.importorskip("google.protobuf")
    out = str(tmp_path_factory.mktemp("qdrant_pb"))
    try:
        r = subprocess.run(
            ["protoc", f"--proto_path={os.path.dirname(PROTO)}",
             f"--python_out={out}", os.path.basename(PROTO)],
            capture_output=True, text=True,
        )
    except FileNotFoundError:
        # binary absent entirely (bare tier-1 image): same skip as a
        # failing protoc, instead of an ERROR during setup
        pytest.skip("protoc binary not installed")
    if r.returncode != 0:
        pytest.skip(f"protoc unavailable/failed: {r.stderr[:200]}")
    sys.path.insert(0, out)
    try:
        import qdrant_subset_pb2 as mod
    finally:
        sys.path.pop(0)
    return mod


# ---------------------------------------------------------------- codecs
class TestValueCodec:
    CASES = [None, True, False, 42, -7, 3.5, "text", [1, "a", None],
             {"k": {"nested": [1.5, False]}}]

    def test_hand_encoded_parses_canonically(self, pb):
        from nornicdb_tpu_torch.server.qdrant_grpc import enc_value

        for v in self.CASES:
            msg = pb.Value()
            msg.ParseFromString(enc_value(v))
            assert _value_to_py(msg) == v, v

    def test_canonical_bytes_decode_by_hand(self, pb):
        from nornicdb_tpu_torch.server.qdrant_grpc import dec_value

        for v in self.CASES:
            raw = _py_to_value(pb, v).SerializeToString()
            assert dec_value(raw) == v, v


def _py_to_value(pb, v):
    m = pb.Value()
    if v is None:
        m.null_value = 0
    elif isinstance(v, bool):
        m.bool_value = v
    elif isinstance(v, int):
        m.integer_value = v
    elif isinstance(v, float):
        m.double_value = v
    elif isinstance(v, str):
        m.string_value = v
    elif isinstance(v, list):
        for x in v:
            m.list_value.values.append(_py_to_value(pb, x))
    elif isinstance(v, dict):
        for k, x in v.items():
            m.struct_value.fields[k].CopyFrom(_py_to_value(pb, x))
    return m


def _value_to_py(m):
    kind = m.WhichOneof("kind")
    if kind is None or kind == "null_value":
        return None
    if kind == "struct_value":
        return {k: _value_to_py(v) for k, v in m.struct_value.fields.items()}
    if kind == "list_value":
        return [_value_to_py(v) for v in m.list_value.values]
    return getattr(m, kind)


class TestPointAndVectorCodec:
    def test_point_id_both_forms(self, pb):
        from nornicdb_tpu_torch.server.qdrant_grpc import dec_point_id, enc_point_id

        for pid in (7, "uuid-abc-123"):
            m = pb.PointId()
            m.ParseFromString(enc_point_id(pid))
            assert (m.num if isinstance(pid, int) else m.uuid) == pid
            m2 = pb.PointId()
            if isinstance(pid, int):
                m2.num = pid
            else:
                m2.uuid = pid
            assert dec_point_id(m2.SerializeToString()) == pid

    def test_vectors_plain_and_named(self, pb):
        from nornicdb_tpu_torch.server.qdrant_grpc import dec_vectors, enc_vectors

        m = pb.Vectors()
        m.ParseFromString(enc_vectors([1.0, 2.5, -3.0]))
        assert list(m.vector.data) == [1.0, 2.5, -3.0]

        named = {"dense": [0.5, 1.5], "title": [2.0]}
        m = pb.Vectors()
        m.ParseFromString(enc_vectors(named))
        assert {k: list(v.data) for k, v in m.vectors.vectors.items()} == named

        m2 = pb.Vectors()
        m2.vector.data.extend([4.0, 5.0])
        assert dec_vectors(m2.SerializeToString()) == [4.0, 5.0]
        m3 = pb.Vectors()
        m3.vectors.vectors["dense"].data.extend([1.0])
        assert dec_vectors(m3.SerializeToString()) == {"dense": [1.0]}


class TestFilterCodec:
    def test_canonical_filter_decodes_to_evaluator_form(self, pb):
        from nornicdb_tpu_torch.server.qdrant_grpc import dec_filter

        f = pb.Filter()
        c = f.must.add()
        c.field.key = "kind"
        c.field.match.keyword = "doc"
        c2 = f.must.add()
        c2.field.key = "score"
        c2.field.range.gte = 1.5
        c2.field.range.lt = 9.0
        c3 = f.should.add()
        c3.has_id.has_id.add().num = 3
        c4 = f.must_not.add()
        c4.is_null.key = "deleted"
        out = dec_filter(f.SerializeToString())
        assert out == {
            "must": [{"key": "kind", "match": {"keyword": "doc"}},
                     {"key": "score", "range": {"gte": 1.5, "lt": 9.0}}],
            "should": [{"has_id": [3]}],
            "must_not": [{"is_null": {"key": "deleted"}}],
        }

    def test_match_variants(self, pb):
        from nornicdb_tpu_torch.server.qdrant_grpc import _dec_match

        m = pb.Match(); m.integers.integers.extend([1, 2])
        assert _dec_match(m.SerializeToString()) == {"any": [1, 2]}
        m = pb.Match(); m.keywords.strings.extend(["a", "b"])
        assert _dec_match(m.SerializeToString()) == {"any": ["a", "b"]}
        m = pb.Match(); m.except_keywords.strings.extend(["x"])
        assert _dec_match(m.SerializeToString()) == {"except": ["x"]}
        m = pb.Match(); m.boolean = True
        assert _dec_match(m.SerializeToString()) == {"boolean": True}


# ------------------------------------------------------------------- e2e
@pytest.fixture(scope="module")
def server():
    from nornicdb_tpu_torch.server.qdrant import QdrantCollections
    from nornicdb_tpu_torch.server.qdrant_grpc import QdrantGrpcServer
    from nornicdb_tpu_torch.storage import MemoryEngine

    srv = QdrantGrpcServer(QdrantCollections(MemoryEngine(), device="cpu"), port=0)
    srv.start()
    yield srv
    srv.stop()


def _call(pb, srv, service, method, req, resp_cls):
    from nornicdb_tpu_torch.server import grpcwire

    with grpcwire.Channel("127.0.0.1", srv.port) as ch:
        fn = ch.unary_unary(f"/{service}/{method}")
        return resp_cls.FromString(fn(req.SerializeToString(), timeout=30))


class TestCanonicalClientE2E:
    """Full request/response cycle with canonical-protobuf messages — the
    in-image equivalent of the official-client e2e."""

    def test_collection_lifecycle_and_points(self, pb, server):
        # create
        req = pb.CreateCollection(collection_name="docs")
        req.vectors_config.params.size = 4
        req.vectors_config.params.distance = pb.Cosine
        out = _call(pb, server, "qdrant.Collections", "Create", req,
                    pb.CollectionOperationResponse)
        assert out.result is True

        # exists + info
        ex = _call(pb, server, "qdrant.Collections", "CollectionExists",
                   pb.CollectionExistsRequest(collection_name="docs"),
                   pb.CollectionExistsResponse)
        assert ex.result.exists is True
        info = _call(pb, server, "qdrant.Collections", "Get",
                     pb.GetCollectionInfoRequest(collection_name="docs"),
                     pb.GetCollectionInfoResponse)
        assert info.result.status == pb.Green
        assert info.result.config.params.vectors_config.params.size == 4

        # upsert three points through canonical serialization
        up = pb.UpsertPoints(collection_name="docs")
        for i, vec in enumerate(([1, 0, 0, 0], [0, 1, 0, 0], [1, 1, 0, 0])):
            p = up.points.add()
            p.id.num = i + 1
            p.vectors.vector.data.extend([float(x) for x in vec])
            p.payload["rank"].integer_value = i
            p.payload["kind"].string_value = "doc" if i < 2 else "other"
        out = _call(pb, server, "qdrant.Points", "Upsert", up,
                    pb.PointsOperationResponse)
        assert out.result.status == pb.Completed

        # count with canonical filter
        cnt = pb.CountPoints(collection_name="docs")
        c = cnt.filter.must.add()
        c.field.key = "kind"
        c.field.match.keyword = "doc"
        out = _call(pb, server, "qdrant.Points", "Count", cnt,
                    pb.CountResponse)
        assert out.result.count == 2

        # search: filtered, payload on
        sr = pb.SearchPoints(collection_name="docs", limit=10)
        sr.vector.extend([1.0, 0.0, 0.0, 0.0])
        sr.with_payload.enable = True
        fc = sr.filter.must.add()
        fc.field.key = "kind"
        fc.field.match.keyword = "doc"
        res = _call(pb, server, "qdrant.Points", "Search", sr,
                    pb.SearchResponse)
        assert [h.id.num for h in res.result][0] == 1
        assert all(h.payload["kind"].string_value == "doc"
                   for h in res.result)
        assert res.result[0].score == pytest.approx(1.0, abs=1e-3)

        # get + scroll through canonical parse
        gp = pb.GetPoints(collection_name="docs")
        gp.ids.add().num = 2
        out = _call(pb, server, "qdrant.Points", "Get", gp, pb.GetResponse)
        assert out.result[0].payload["rank"].integer_value == 1
        assert list(out.result[0].vectors.vector.data) == [0, 1, 0, 0]

        sc = pb.ScrollPoints(collection_name="docs", limit=2)
        out = _call(pb, server, "qdrant.Points", "Scroll", sc,
                    pb.ScrollResponse)
        assert len(out.result) == 2
        assert out.HasField("next_page_offset")

        # delete by canonical selector, then verify
        dp = pb.DeletePoints(collection_name="docs")
        dp.points.points.ids.add().num = 1
        out = _call(pb, server, "qdrant.Points", "Delete", dp,
                    pb.PointsOperationResponse)
        assert out.result.status == pb.Completed
        out = _call(pb, server, "qdrant.Points", "Count",
                    pb.CountPoints(collection_name="docs"), pb.CountResponse)
        assert out.result.count == 2

        # list + drop
        ls = _call(pb, server, "qdrant.Collections", "List",
                   pb.ListCollectionsRequest(), pb.ListCollectionsResponse)
        assert "docs" in [c.name for c in ls.collections]
        out = _call(pb, server, "qdrant.Collections", "Delete",
                    pb.DeleteCollection(collection_name="docs"),
                    pb.CollectionOperationResponse)
        assert out.result is True

    def test_health_check(self, pb, server):
        out = _call(pb, server, "qdrant.Qdrant", "HealthCheck",
                    pb.HealthCheckRequest(), pb.HealthCheckReply)
        assert out.title
        assert out.version
