"""Qdrant-compatible gRPC services (Collections / Points / Snapshots /
root): the port's copy of ``nornicdb_tpu/server/qdrant_grpc.py``.

Behavioral reference: the upstream NornicDB pkg/qdrantgrpc/ — server.go:207
(NewServer wiring, keepalive, default-deny method RBAC :353-475),
collections_service.go, points_service.go, snapshots_service.go,
registry.go (points live as graph nodes, label "QdrantPoint"), tested
upstream with the official client (qdrant_official_e2e_test.go).

Wire format: the upstream Qdrant protobuf contract (package `qdrant`,
v1.16 field numbers, documented per-message below). No generated stubs:
messages are hand-encoded/decoded, and the services run on ``grpcwire``,
the port's unary gRPC over HTTP/2 on the standard library (the JAX
package runs them on grpcio's GenericRpcHandler). The field numbers
follow the public qdrant protos (collections.proto / points.proto /
json_with_int.proto / snapshots_service.proto / qdrant.proto).

State is shared with the REST surface: both wrap one QdrantCollections
registry (``DB.qdrant_registry``), so a point upserted over gRPC is
visible to /collections/* REST at once, and the other way round (ref:
server.go "single unified vector index").

Where it differs from the JAX package: the JAX ``_wrap`` maps every
``NornicError`` to INVALID_ARGUMENT, and in the port ``DeviceUnavailable``
is one; it answers UNAVAILABLE instead (details ``device_unavailable:
...``), so a client is never told that a card which is not serving was
its own malformed request. Every other mapping is JAX's,
``ResourceExhausted`` -> INVALID_ARGUMENT included.
"""

from __future__ import annotations

import base64
import gzip
import json
import os
import struct
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from nornicdb_tpu_torch.errors import (
    AuthError,
    DeviceUnavailable,
    NornicError,
    NotFoundError,
)
from nornicdb_tpu_torch.server import grpcwire
from nornicdb_tpu_torch.server.grpcwire import StatusCode
from nornicdb_tpu_torch.server.qdrant import POINT_LABEL, QdrantCollections

SERVICE_COLLECTIONS = "qdrant.Collections"
SERVICE_POINTS = "qdrant.Points"
SERVICE_SNAPSHOTS = "qdrant.Snapshots"
SERVICE_ROOT = "qdrant.Qdrant"

# Distance enum (collections.proto): UnknownDistance=0 Cosine=1 Euclid=2
# Dot=3 Manhattan=4
_DISTANCE_TO_NUM = {"Cosine": 1, "Euclid": 2, "Dot": 3, "Manhattan": 4}
_NUM_TO_DISTANCE = {v: k for k, v in _DISTANCE_TO_NUM.items()}

_U64 = (1 << 64)
_I64_MAX = (1 << 63) - 1

import string as _string

_SAFE_NAME_CHARS = frozenset(_string.ascii_letters + _string.digits + "._-")


# ------------------------------------------------------------- wire helpers
def _varint(v: int) -> bytes:
    v &= _U64 - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise NornicError("malformed varint")


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, data: bytes) -> bytes:
    """Length-delimited field."""
    return _tag(field, 2) + _varint(len(data)) + data


def _vi(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f32(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f64(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _packed_f32(field: int, vals) -> bytes:
    return _ld(field, struct.pack(f"<{len(vals)}f", *vals))


def _s(field: int, text: str) -> bytes:
    return _ld(field, text.encode("utf-8"))


def _parse(buf: bytes) -> dict[int, list[tuple[int, Any]]]:
    """Generic TLV sweep: field -> [(wire_type, raw_value)].

    wire 0 -> int, wire 1 -> 8 raw bytes, wire 5 -> 4 raw bytes,
    wire 2 -> bytes. Unknown groups are rejected (proto3 never emits them).
    """
    out: dict[int, list[tuple[int, Any]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            if pos + 8 > n:
                raise NornicError("truncated fixed64 field")
            v = buf[pos : pos + 8]
            pos += 8
        elif wire == 5:
            if pos + 4 > n:
                raise NornicError("truncated fixed32 field")
            v = buf[pos : pos + 4]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise NornicError("truncated length-delimited field")
            v = buf[pos : pos + ln]
            pos += ln
        else:
            raise NornicError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append((wire, v))
    return out


def _first(fields: dict, num: int, default=None):
    vals = fields.get(num)
    return vals[0][1] if vals else default


def _i64(v: int) -> int:
    return v - _U64 if v > _I64_MAX else v


def _floats(raw: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(raw) // 4}f", raw[: len(raw) // 4 * 4]))


def _varint_list(entries: list[tuple[int, Any]]) -> list[int]:
    """repeated int64 values: canonical proto3 encoders PACK them (one
    length-delimited blob of varints, wiretype 2) while lenient encoders may
    emit one varint field per element — accept both, like protobuf does."""
    out: list[int] = []
    for wire, v in entries:
        if isinstance(v, bytes):
            pos = 0
            while pos < len(v):
                val, pos = _read_varint(v, pos)
                out.append(_i64(val))
        else:
            out.append(_i64(v))
    return out


# ----------------------------------------------------- qdrant.Value codec
# json_with_int.proto: Value oneof kind { NullValue null_value=1;
# double double_value=2; int64 integer_value=3; string string_value=4;
# bool bool_value=5; Struct struct_value=6; ListValue list_value=7 }
# Struct: map<string, Value> fields=1.  ListValue: repeated Value values=1.
def enc_value(v: Any) -> bytes:
    if v is None:
        return _vi(1, 0)
    if isinstance(v, bool):
        return _vi(5, 1 if v else 0)
    if isinstance(v, int):
        return _vi(3, v)
    if isinstance(v, float):
        return _f64(2, v)
    if isinstance(v, str):
        return _s(4, v)
    if isinstance(v, dict):
        body = b"".join(
            _ld(1, _s(1, str(k)) + _ld(2, enc_value(x))) for k, x in v.items()
        )
        return _ld(6, body)
    if isinstance(v, (list, tuple)):
        return _ld(7, b"".join(_ld(1, enc_value(x)) for x in v))
    if isinstance(v, np.ndarray):
        return enc_value(v.tolist())
    return _s(4, str(v))


def dec_value(raw: bytes) -> Any:
    f = _parse(raw)
    if 1 in f:
        return None
    if 5 in f:
        return bool(f[5][0][1])
    if 3 in f:
        return _i64(f[3][0][1])
    if 2 in f:
        return struct.unpack("<d", f[2][0][1])[0]
    if 4 in f:
        return f[4][0][1].decode("utf-8")
    if 6 in f:
        sf = _parse(f[6][0][1])  # Struct: map<string, Value> fields=1
        out = {}
        for _, entry in sf.get(1, []):
            ef = _parse(entry)
            k = _first(ef, 1, b"").decode("utf-8")
            out[k] = dec_value(_first(ef, 2, b""))
        return out
    if 7 in f:
        lf = _parse(f[7][0][1])
        return [dec_value(r) for _, r in lf.get(1, [])]
    return None


def enc_payload_map(field: int, payload: dict[str, Any]) -> bytes:
    """map<string, Value>: entries key=1, value=2."""
    return b"".join(
        _ld(field, _s(1, str(k)) + _ld(2, enc_value(v)))
        for k, v in payload.items()
    )


def dec_payload_map(entries: list[tuple[int, Any]]) -> dict[str, Any]:
    out = {}
    for _, raw in entries:
        f = _parse(raw)
        k = _first(f, 1, b"").decode("utf-8")
        out[k] = dec_value(_first(f, 2, b""))
    return out


# --------------------------------------------------------------- Filter
# points.proto Filter: should=1, must=2, must_not=3 (repeated Condition).
# Condition oneof: FieldCondition field=1, IsEmptyCondition is_empty=2,
# HasIdCondition has_id=3, Filter filter=4, IsNullCondition is_null=5.
# FieldCondition: key=1, Match match=2, Range range=3.
# Match oneof: keyword=1, integer=2, boolean=3, text=4,
#   RepeatedStrings keywords=5 {strings=1}, RepeatedIntegers integers=6
#   {integers=1}, except_integers=7, except_keywords=8.
# Range: lt=1, gt=2, gte=3, lte=4 (doubles).
# Decodes to the JSON-dict form evaluated by qdrant.eval_filter, so both
# transports share one evaluator (ref: pkg/qdrantgrpc points_service.go).
def _dec_match(raw: bytes) -> dict:
    f = _parse(raw)
    if 1 in f:
        return {"keyword": f[1][0][1].decode("utf-8")}
    if 2 in f:
        return {"integer": _i64(f[2][0][1])}
    if 3 in f:
        return {"boolean": bool(f[3][0][1])}
    if 4 in f:
        return {"text": f[4][0][1].decode("utf-8")}
    if 5 in f:
        rs = _parse(f[5][0][1])
        return {"any": [r.decode("utf-8") for _, r in rs.get(1, [])]}
    if 6 in f:
        ri = _parse(f[6][0][1])
        return {"any": _varint_list(ri.get(1, []))}
    if 7 in f:
        ri = _parse(f[7][0][1])
        return {"except": _varint_list(ri.get(1, []))}
    if 8 in f:
        rs = _parse(f[8][0][1])
        return {"except": [r.decode("utf-8") for _, r in rs.get(1, [])]}
    raise NornicError("empty match clause")


def _dec_condition(raw: bytes) -> dict:
    f = _parse(raw)
    if 1 in f:  # FieldCondition
        ff = _parse(f[1][0][1])
        cond: dict = {"key": _first(ff, 1, b"").decode("utf-8")}
        if 2 in ff:
            cond["match"] = _dec_match(ff[2][0][1])
        elif 3 in ff:
            rf = _parse(ff[3][0][1])
            rng = {}
            for num, name in ((1, "lt"), (2, "gt"), (3, "gte"), (4, "lte")):
                if num in rf:
                    rng[name] = struct.unpack("<d", rf[num][0][1])[0]
            cond["range"] = rng
        else:
            raise NornicError(
                f"unsupported field condition on {cond['key']!r} "
                "(match and range are supported)"
            )
        return cond
    if 2 in f:
        ef = _parse(f[2][0][1])
        return {"is_empty": {"key": _first(ef, 1, b"").decode("utf-8")}}
    if 3 in f:
        hf = _parse(f[3][0][1])
        return {"has_id": [dec_point_id(r) for _, r in hf.get(1, [])]}
    if 4 in f:
        return {"filter": dec_filter(f[4][0][1])}
    if 5 in f:
        nf = _parse(f[5][0][1])
        return {"is_null": {"key": _first(nf, 1, b"").decode("utf-8")}}
    raise NornicError("unsupported filter condition")


def dec_filter(raw: bytes) -> dict:
    f = _parse(raw)
    out: dict = {}
    for num, name in ((1, "should"), (2, "must"), (3, "must_not")):
        if num in f:
            out[name] = [_dec_condition(r) for _, r in f[num]]
    return out


# ------------------------------------------------------- PointId / Vectors
# points.proto PointId: oneof { uint64 num=1; string uuid=2 }
def enc_point_id(pid: Any) -> bytes:
    if isinstance(pid, int):
        return _vi(1, pid)
    return _s(2, str(pid))


def dec_point_id(raw: bytes) -> Any:
    f = _parse(raw)
    if 1 in f:
        return f[1][0][1]
    if 2 in f:
        return f[2][0][1].decode("utf-8")
    return None


# Vector: repeated float data=1 (packed).
# Vectors: oneof { Vector vector=1; NamedVectors vectors=2 };
# NamedVectors: map<string, Vector> vectors=1.
def enc_vectors(vector: Any) -> bytes:
    if isinstance(vector, dict):
        entries = b"".join(
            _ld(1, _s(1, name) + _ld(2, _packed_f32(1, vals)))
            for name, vals in vector.items()
        )
        return _ld(2, entries)
    return _ld(1, _packed_f32(1, list(vector)))


def dec_vectors(raw: bytes) -> Any:
    f = _parse(raw)
    if 1 in f:
        vf = _parse(f[1][0][1])
        return _floats(_first(vf, 1, b""))
    if 2 in f:
        out = {}
        nf = _parse(f[2][0][1])
        for _, entry in nf.get(1, []):
            ef = _parse(entry)
            name = _first(ef, 1, b"").decode("utf-8")
            vf = _parse(_first(ef, 2, b""))
            out[name] = _floats(_first(vf, 1, b""))
        return out
    return None


# ------------------------------------------------------- response shells
def _op_response(ok: bool, t0: float) -> bytes:
    """CollectionOperationResponse / result=1 bool, time=2 double."""
    return _vi(1, 1 if ok else 0) + _f64(2, time.perf_counter() - t0)


def _update_result_response(t0: float, status: int = 2) -> bytes:
    """PointsOperationResponse: result=1 UpdateResult{operation_id=1,
    status=2 (Completed=2)}, time=2."""
    return _ld(1, _vi(1, 0) + _vi(2, status)) + _f64(
        2, time.perf_counter() - t0
    )


def _scored_point(pid: Any, score: float, payload: Optional[dict],
                  vectors: Any = None) -> bytes:
    """ScoredPoint: id=1, payload=2 map, score=3 float, version=5,
    vectors=6."""
    body = _ld(1, enc_point_id(pid))
    if payload:
        body += enc_payload_map(2, payload)
    body += _f32(3, float(score)) + _vi(5, 0)
    if vectors is not None:
        body += _ld(6, enc_vectors(vectors))
    return body


def _retrieved_point(pid: Any, payload: Optional[dict],
                     vectors: Any = None) -> bytes:
    """RetrievedPoint: id=1, payload=2 map, vectors=4."""
    body = _ld(1, enc_point_id(pid))
    if payload:
        body += enc_payload_map(2, payload)
    if vectors is not None:
        body += _ld(4, enc_vectors(vectors))
    return body


# ----------------------------------------------------------------- server
class QdrantGrpcServer:
    """Qdrant v1.16-wire gRPC server on :6334 (ref: NewServer server.go:207).

    Auth mirrors the reference's interceptors (server.go:374-475):
    metadata `authorization: Bearer <jwt>` / `Basic <user:pass>` or
    `api-key: <jwt>`; per-method RBAC is default-deny — a method absent
    from the permission table is refused.
    """

    # ref: authorizeMethod server.go:353 — default-deny table
    METHOD_PERMISSIONS = {
        f"/{SERVICE_ROOT}/HealthCheck": None,  # open, like upstream qdrant
        f"/{SERVICE_COLLECTIONS}/List": "read",
        f"/{SERVICE_COLLECTIONS}/Get": "read",
        f"/{SERVICE_COLLECTIONS}/CollectionExists": "read",
        f"/{SERVICE_COLLECTIONS}/Create": "write",
        f"/{SERVICE_COLLECTIONS}/Update": "write",
        f"/{SERVICE_COLLECTIONS}/Delete": "write",
        f"/{SERVICE_POINTS}/Search": "read",
        f"/{SERVICE_POINTS}/Get": "read",
        f"/{SERVICE_POINTS}/Count": "read",
        f"/{SERVICE_POINTS}/Scroll": "read",
        f"/{SERVICE_POINTS}/Upsert": "write",
        f"/{SERVICE_POINTS}/Delete": "write",
        f"/{SERVICE_POINTS}/SetPayload": "write",
        f"/{SERVICE_POINTS}/OverwritePayload": "write",
        f"/{SERVICE_POINTS}/DeletePayload": "write",
        f"/{SERVICE_POINTS}/ClearPayload": "write",
        f"/{SERVICE_SNAPSHOTS}/List": "read",
        f"/{SERVICE_SNAPSHOTS}/Create": "write",
        f"/{SERVICE_SNAPSHOTS}/Delete": "write",
    }

    def __init__(
        self,
        registry: QdrantCollections,
        host: str = "127.0.0.1",
        port: int = 0,
        authenticator=None,
        allow_vector_mutations: bool = True,
        snapshot_dir: Optional[str] = None,
        max_workers: int = 4,
        version: str = "1.16.0",
    ):
        self.registry = registry
        self.authenticator = authenticator
        self.allow_vector_mutations = allow_vector_mutations
        self.snapshot_dir = snapshot_dir
        self.version = version
        self._snap_lock = threading.Lock()

        methods: dict[str, Callable] = {
            f"/{SERVICE_ROOT}/HealthCheck": self._health,
            f"/{SERVICE_COLLECTIONS}/Create": self._coll_create,
            f"/{SERVICE_COLLECTIONS}/Delete": self._coll_delete,
            f"/{SERVICE_COLLECTIONS}/List": self._coll_list,
            f"/{SERVICE_COLLECTIONS}/Get": self._coll_get,
            f"/{SERVICE_COLLECTIONS}/Update": self._coll_update,
            f"/{SERVICE_COLLECTIONS}/CollectionExists": self._coll_exists,
            f"/{SERVICE_POINTS}/Upsert": self._points_upsert,
            f"/{SERVICE_POINTS}/Get": self._points_get,
            f"/{SERVICE_POINTS}/Delete": self._points_delete,
            f"/{SERVICE_POINTS}/Search": self._points_search,
            f"/{SERVICE_POINTS}/Count": self._points_count,
            f"/{SERVICE_POINTS}/Scroll": self._points_scroll,
            f"/{SERVICE_POINTS}/SetPayload": self._points_set_payload,
            f"/{SERVICE_POINTS}/OverwritePayload": self._points_overwrite_payload,
            f"/{SERVICE_POINTS}/DeletePayload": self._points_delete_payload,
            f"/{SERVICE_POINTS}/ClearPayload": self._points_clear_payload,
            f"/{SERVICE_SNAPSHOTS}/Create": self._snap_create,
            f"/{SERVICE_SNAPSHOTS}/List": self._snap_list,
            f"/{SERVICE_SNAPSHOTS}/Delete": self._snap_delete,
        }
        try:
            self._server = grpcwire.Server(host, port, max_workers)
        except OSError as e:
            # surface a bind failure like BoltServer/HttpServer do instead
            # of serving nowhere
            raise NornicError(
                f"qdrant grpc failed to bind {host}:{port}: {e}") from e
        # a method outside this table answers UNIMPLEMENTED, as grpcio does
        for method, fn in methods.items():
            self._server.add_method(method, self._wrap(method, fn))
        self.port = self._server.port
        self.host = host

    # -- auth (ref: unaryAuthInterceptor server.go:374, basic :475) --------
    def _wrap(self, method: str, fn: Callable) -> Callable:
        def call(request: bytes, context) -> bytes:
            if self.authenticator is not None:
                perm = self.METHOD_PERMISSIONS.get(method, "__deny__")
                if perm == "__deny__":
                    context.abort(StatusCode.PERMISSION_DENIED,
                                  f"method {method} not permitted")
                if perm is not None:
                    payload = self._authenticate(dict(
                        context.invocation_metadata()))
                    if payload is None:
                        context.abort(StatusCode.UNAUTHENTICATED,
                                      "authentication required")
                    role = payload.get("role", "none")
                    if not self.authenticator.has_permission(role, perm):
                        context.abort(StatusCode.PERMISSION_DENIED,
                                      f"permission {perm} denied")
            try:
                return fn(request, context)
            except DeviceUnavailable as e:
                # before NornicError: a card that is not serving is a
                # transient state of the server, not a malformed request
                context.abort(StatusCode.UNAVAILABLE,
                              f"device_unavailable: {e}")
            except NotFoundError as e:
                context.abort(StatusCode.NOT_FOUND, str(e))
            except (NornicError, IndexError, struct.error,
                    UnicodeDecodeError) as e:
                # truncated varints / short fixed fields / bad UTF-8 from a
                # malformed frame must map to INVALID_ARGUMENT, not leak a
                # traceback as UNKNOWN
                context.abort(StatusCode.INVALID_ARGUMENT,
                              f"malformed request: {e}")

        return call

    def _authenticate(self, md: dict) -> Optional[dict]:
        auth = self.authenticator
        header = md.get("authorization", "")
        if header.startswith("Bearer "):
            return auth.validate_token(header[7:])
        if header.startswith("Basic "):
            try:
                user, pw = base64.b64decode(header[6:]).decode().split(":", 1)
            except (ValueError, UnicodeDecodeError):
                return None  # malformed basic-auth header
            if auth.check_password(user, pw):
                try:
                    return {"sub": user, "role": auth.get_user(user).role}
                except AuthError:
                    return None  # user deleted between check and fetch
            return None
        api_key = md.get("api-key", "")
        if api_key:
            return auth.validate_token(api_key)
        return None

    # -- root --------------------------------------------------------------
    def _health(self, request: bytes, context) -> bytes:
        """HealthCheckReply: title=1, version=2 (qdrant.proto)."""
        return _s(1, "nornicdb-tpu qdrant compat") + _s(2, self.version)

    # -- collections -------------------------------------------------------
    @staticmethod
    def _dec_vector_params(raw: bytes) -> dict:
        """VectorParams: size=1 uint64, distance=2 enum."""
        f = _parse(raw)
        return {
            "size": int(_first(f, 1, 0)),
            "distance": _NUM_TO_DISTANCE.get(int(_first(f, 2, 1)), "Cosine"),
        }

    def _dec_vectors_config(self, raw: bytes) -> tuple[int, str, dict]:
        """VectorsConfig: oneof { VectorParams params=1;
        VectorParamsMap params_map=2 }. Returns (size, distance, named)."""
        f = _parse(raw)
        if 1 in f:
            p = self._dec_vector_params(f[1][0][1])
            return p["size"], p["distance"], {}
        named = {}
        if 2 in f:
            mf = _parse(f[2][0][1])  # VectorParamsMap: map=1
            for _, entry in mf.get(1, []):
                ef = _parse(entry)
                name = _first(ef, 1, b"").decode("utf-8")
                named[name] = self._dec_vector_params(_first(ef, 2, b""))
        return 0, "Cosine", named

    def _coll_create(self, request: bytes, context) -> bytes:
        t0 = time.perf_counter()
        f = _parse(request)
        name = _first(f, 1, b"").decode("utf-8")
        size, distance, named = 0, "Cosine", {}
        if 10 in f:  # CreateCollection.vectors_config=10
            size, distance, named = self._dec_vectors_config(f[10][0][1])
        self.registry.create(name, size=size, distance=distance, named=named)
        return _op_response(True, t0)

    def _coll_delete(self, request: bytes, context) -> bytes:
        t0 = time.perf_counter()
        name = _first(_parse(request), 1, b"").decode("utf-8")
        return _op_response(self.registry.drop(name), t0)

    def _coll_update(self, request: bytes, context) -> bytes:
        # optimizer/HNSW retuning has no analogue here; acknowledge
        return _op_response(True, time.perf_counter())

    def _coll_list(self, request: bytes, context) -> bytes:
        """ListCollectionsResponse: collections=1 rep CollectionDescription
        {name=1}, time=2."""
        t0 = time.perf_counter()
        body = b"".join(
            _ld(1, _s(1, c["name"])) for c in self.registry.list()
        )
        return body + _f64(2, time.perf_counter() - t0)

    def _coll_exists(self, request: bytes, context) -> bytes:
        """CollectionExistsResponse: result=1 {exists=1 bool}, time=2."""
        t0 = time.perf_counter()
        name = _first(_parse(request), 1, b"").decode("utf-8")
        exists = self.registry.info(name) is not None
        # proto3 canonical form: default (false) is omitted
        return _ld(1, _vi(1, 1) if exists else b"") + _f64(
            2, time.perf_counter() - t0
        )

    def _coll_get(self, request: bytes, context) -> bytes:
        """GetCollectionInfoResponse: result=1 CollectionInfo{status=1,
        vectors_count=3, config=7 CollectionConfig{params=1
        CollectionParams{vectors_config=5}}, points_count=9}, time=2."""
        t0 = time.perf_counter()
        name = _first(_parse(request), 1, b"").decode("utf-8")
        info = self.registry.info(name)
        if info is None:
            raise NotFoundError(f"collection {name} not found")
        meta = self.registry.params(name) or {}
        vec_params = _vi(1, int(meta.get("size", 0))) + _vi(
            2, _DISTANCE_TO_NUM.get(meta.get("distance", "Cosine"), 1)
        )
        named = meta.get("named") or {}
        if named:
            entries = b"".join(
                _ld(1, _s(1, vn) + _ld(2, _vi(1, int(spec.get("size", 0)))
                                       + _vi(2, _DISTANCE_TO_NUM.get(
                                           spec.get("distance", "Cosine"), 1))))
                for vn, spec in named.items()
            )
            vectors_config = _ld(2, _ld(1, entries))
        else:
            vectors_config = _ld(1, vec_params)
        params = _ld(5, vectors_config)  # CollectionParams.vectors_config=5
        config = _ld(1, params)  # CollectionConfig.params=1
        count = info["points_count"]
        collection_info = (
            _vi(1, 1)  # status=Green
            + _vi(3, count)
            + _ld(7, config)
            + _vi(9, count)
        )
        return _ld(1, collection_info) + _f64(2, time.perf_counter() - t0)

    # -- points ------------------------------------------------------------
    def _points_upsert(self, request: bytes, context) -> bytes:
        """UpsertPoints: collection_name=1, wait=2, points=3 rep PointStruct
        {id=1, payload=3 map, vectors=4}."""
        t0 = time.perf_counter()
        if not self.allow_vector_mutations:
            # ref: AllowVectorMutations=false -> FailedPrecondition
            context.abort(
                StatusCode.FAILED_PRECONDITION,
                "vector mutations are managed by nornicdb embeddings",
            )
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        points = []
        for _, raw in f.get(3, []):
            pf = _parse(raw)
            pid = dec_point_id(_first(pf, 1, b""))
            payload = dec_payload_map(pf.get(3, []))
            vectors = dec_vectors(_first(pf, 4, b"")) if 4 in pf else None
            points.append(
                {"id": pid, "vector": vectors, "payload": payload}
            )
        self.registry.upsert(coll, points)
        return _update_result_response(t0)

    def _points_get(self, request: bytes, context) -> bytes:
        """GetPoints: collection_name=1, ids=2 rep PointId ->
        GetResponse: result=1 rep RetrievedPoint, time=2."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        ids = [dec_point_id(raw) for _, raw in f.get(2, [])]
        body = b""
        for item in self.registry.retrieve(coll, ids):
            body += _ld(1, _retrieved_point(
                item["id"], item.get("payload"), item.get("vector")))
        return body + _f64(2, time.perf_counter() - t0)

    def _selector_ids(self, coll: str, f: dict, field: int, context) -> list:
        """Decode PointsSelector at `field`: oneof { PointsIdsList points=1;
        Filter filter=2 }. Filter selectors resolve to the matching point
        ids via the shared evaluator."""
        if field not in f:
            return []
        sf = _parse(f[field][0][1])
        if 2 in sf:
            return self.registry.matching_ids(coll, dec_filter(sf[2][0][1]))
        if 1 in sf:
            lf = _parse(sf[1][0][1])
            return [dec_point_id(raw) for _, raw in lf.get(1, [])]
        return []

    def _points_delete(self, request: bytes, context) -> bytes:
        """DeletePoints: collection_name=1, points=3 PointsSelector
        {points=1 PointsIdsList{ids=1} | filter=2}."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        ids = self._selector_ids(coll, f, 3, context)
        self.registry.delete_points(coll, ids)
        return _update_result_response(t0)

    def _points_search(self, request: bytes, context) -> bytes:
        """SearchPoints: collection_name=1, vector=2 packed floats, filter=3,
        limit=4, with_payload=6 WithPayloadSelector{enable=1},
        score_threshold=8, vector_name=10, with_vectors=11 ->
        SearchResponse: result=1 rep ScoredPoint, time=2."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        vector = _floats(_first(f, 2, b""))
        flt = dec_filter(f[3][0][1]) if 3 in f else None
        limit = int(_first(f, 4, 10))
        with_payload = True
        if 6 in f:
            wf = _parse(f[6][0][1])
            if 1 in wf:
                with_payload = bool(wf[1][0][1])
        threshold = -1.0
        if 8 in f:
            threshold = struct.unpack("<f", f[8][0][1])[0]
        vec_name = _first(f, 10, b"").decode("utf-8") if 10 in f else ""
        with_vectors = False
        if 11 in f:
            wv = _parse(f[11][0][1])
            if 1 in wv:
                with_vectors = bool(wv[1][0][1])
        query: Any = vector
        if vec_name:
            query = {"name": vec_name, "vector": vector}
        hits = self.registry.search(
            coll, query, limit=limit, score_threshold=threshold,
            with_payload=with_payload, query_filter=flt,
        )
        body = b""
        vec_by_id = {}
        if with_vectors:
            for item in self.registry.retrieve(coll, [h["id"] for h in hits]):
                vec_by_id[item["id"]] = item.get("vector")
        for h in hits:
            body += _ld(1, _scored_point(
                h["id"], h["score"], h.get("payload"),
                vec_by_id.get(h["id"]) if with_vectors else None,
            ))
        return body + _f64(2, time.perf_counter() - t0)

    def _points_count(self, request: bytes, context) -> bytes:
        """CountPoints: collection_name=1, filter=2 -> CountResponse:
        result=1 {count=1}, time=2."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        flt = dec_filter(f[2][0][1]) if 2 in f else None
        count = self.registry.count(coll, flt)
        return _ld(1, _vi(1, count)) + _f64(2, time.perf_counter() - t0)

    def _points_scroll(self, request: bytes, context) -> bytes:
        """ScrollPoints: collection_name=1, filter=2, offset=3 PointId,
        limit=4 -> ScrollResponse: next_page_offset=1, result=2 rep
        RetrievedPoint, time=3. Points are ordered by point id (stringified)
        for a stable scroll, matching the reference's deterministic paging."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        flt = dec_filter(f[2][0][1]) if 2 in f else None
        offset = dec_point_id(_first(f, 3, b"")) if 3 in f else None
        limit = int(_first(f, 4, 10))
        page, nxt = self.registry.scroll(
            coll, offset=offset, limit=limit, query_filter=flt
        )
        body = b""
        for item in self.registry.retrieve(coll, page):
            body += _ld(2, _retrieved_point(
                item["id"], item.get("payload"), item.get("vector")))
        out = b""
        if nxt is not None:
            out += _ld(1, enc_point_id(nxt))
        return out + body + _f64(3, time.perf_counter() - t0)

    # -- payload ops (ref: points_service.go payload ops) -------------------
    def _payload_targets(self, f: dict, context,
                         selector_field: int = 5) -> tuple[str, list]:
        """Set/DeletePayload carry the selector at field 5 (field 3 is the
        payload map / key list — never a selector); ClearPayload carries it
        at field 3."""
        coll = _first(f, 1, b"").decode("utf-8")
        return coll, self._selector_ids(coll, f, selector_field, context)

    def _mutate_payload(self, coll: str, ids: list, fn) -> None:
        if self.registry.info(coll) is None:
            raise NotFoundError(f"collection {coll} not found")
        for pid in ids:
            nid = self.registry._node_id(coll, pid)
            try:
                node = self.registry.storage.get_node(nid)
            except NotFoundError:
                continue
            fn(node)
            self.registry.storage.update_node(node)

    def _points_set_payload(self, request: bytes, context) -> bytes:
        """SetPayloadPoints: collection_name=1, payload=3 map,
        points_selector=5."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll, ids = self._payload_targets(f, context)
        # underscore keys are internal (_collection, _point_id) — a client
        # payload must not clobber them (DeletePayload/Clear guard likewise)
        payload = {k: v for k, v in dec_payload_map(f.get(3, [])).items()
                   if not k.startswith("_")}
        self._mutate_payload(
            coll, ids, lambda n: n.properties.update(payload)
        )
        return _update_result_response(t0)

    def _points_overwrite_payload(self, request: bytes, context) -> bytes:
        t0 = time.perf_counter()
        f = _parse(request)
        coll, ids = self._payload_targets(f, context)
        payload = {k: v for k, v in dec_payload_map(f.get(3, [])).items()
                   if not k.startswith("_")}

        def overwrite(n):
            keep = {k: v for k, v in n.properties.items()
                    if k.startswith("_")}
            n.properties = {**keep, **payload}

        self._mutate_payload(coll, ids, overwrite)
        return _update_result_response(t0)

    def _points_delete_payload(self, request: bytes, context) -> bytes:
        """DeletePayloadPoints: collection_name=1, keys=3 rep string,
        points_selector=5."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll, ids = self._payload_targets(f, context)
        keys = [raw.decode("utf-8") for _, raw in f.get(3, [])]

        def drop(n):
            for k in keys:
                if not k.startswith("_"):
                    n.properties.pop(k, None)

        self._mutate_payload(coll, ids, drop)
        return _update_result_response(t0)

    def _points_clear_payload(self, request: bytes, context) -> bytes:
        """ClearPayloadPoints: collection_name=1, points=3 selector."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll, ids = self._payload_targets(f, context, selector_field=3)

        def clear(n):
            n.properties = {k: v for k, v in n.properties.items()
                            if k.startswith("_")}

        self._mutate_payload(coll, ids, clear)
        return _update_result_response(t0)

    # -- snapshots (ref: snapshots_service.go; on-disk archives) ------------
    @staticmethod
    def _safe_component(name: str) -> str:
        """Snapshot paths are built from client-supplied names; anything
        outside [A-Za-z0-9._-] (or starting with a dot) would let a crafted
        collection/snapshot name escape snapshot_dir."""
        if (
            not name
            or name.startswith(".")
            or any(c not in _SAFE_NAME_CHARS for c in name)
        ):
            raise NornicError(f"invalid name {name!r}")
        return name

    def _snap_path(self, coll: str, name: str) -> str:
        return os.path.join(
            self.snapshot_dir,
            self._safe_component(coll),
            self._safe_component(name),
        )

    def _snap_create(self, request: bytes, context) -> bytes:
        """CreateSnapshotResponse: snapshot_description=1
        {name=1, creation_time=2 Timestamp{seconds=1}, size=3}, time=2."""
        t0 = time.perf_counter()
        if self.snapshot_dir is None:
            context.abort(StatusCode.FAILED_PRECONDITION,
                          "snapshot_dir not configured")
        coll = self._safe_component(
            _first(_parse(request), 1, b"").decode("utf-8"))
        if self.registry.info(coll) is None:
            raise NotFoundError(f"collection {coll} not found")
        points = []
        for n in self.registry.storage.get_nodes_by_label(POINT_LABEL):
            if n.properties.get("_collection") != coll:
                continue
            points.append({
                "id": n.properties.get("_point_id"),
                "payload": {k: v for k, v in n.properties.items()
                            if not k.startswith("_")},
                "vector": (
                    {k: v.tolist() for k, v in n.named_embeddings.items()}
                    if n.named_embeddings
                    else (n.embedding.tolist()
                          if n.embedding is not None else None)
                ),
            })
        ts = int(time.time())
        name = f"{coll}-{ts}.snapshot"
        with self._snap_lock:
            os.makedirs(os.path.join(self.snapshot_dir, coll), exist_ok=True)
            blob = gzip.compress(json.dumps(
                {"collection": coll, "points": points}).encode())
            with open(self._snap_path(coll, name), "wb") as fh:
                fh.write(blob)
        desc = _s(1, name) + _ld(2, _vi(1, ts)) + _vi(3, len(blob))
        return _ld(1, desc) + _f64(2, time.perf_counter() - t0)

    def _snap_list(self, request: bytes, context) -> bytes:
        """ListSnapshotsResponse: snapshot_descriptions=1 rep, time=2."""
        t0 = time.perf_counter()
        coll = self._safe_component(
            _first(_parse(request), 1, b"").decode("utf-8"))
        body = b""
        d = os.path.join(self.snapshot_dir or "", coll)
        if self.snapshot_dir and os.path.isdir(d):
            for fname in sorted(os.listdir(d)):
                path = os.path.join(d, fname)
                body += _ld(1, _s(1, fname)
                            + _ld(2, _vi(1, int(os.path.getmtime(path))))
                            + _vi(3, os.path.getsize(path)))
        return body + _f64(2, time.perf_counter() - t0)

    def _snap_delete(self, request: bytes, context) -> bytes:
        """DeleteSnapshotResponse: time=1."""
        t0 = time.perf_counter()
        f = _parse(request)
        coll = _first(f, 1, b"").decode("utf-8")
        name = _first(f, 2, b"").decode("utf-8")
        if not self.snapshot_dir:
            raise NotFoundError("snapshots not configured")
        path = self._snap_path(coll, name)
        if not os.path.exists(path):
            raise NotFoundError(f"snapshot {name} not found")
        os.remove(path)
        return _f64(1, time.perf_counter() - t0)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=1)
