"""Native gRPC search service: the port's copy of
``nornicdb_tpu/server/grpc_search.py``.

Behavioral reference: the upstream NornicDB pkg/nornicgrpc/ —
proto/nornicdb_search.proto + search_service.go: a lean gRPC surface for
high-throughput vector/hybrid search (the reference's fastest endpoint;
its e2e README cites 29,331 ops/s, a figure of that system, not of this
one).

The protobuf messages are hand-encoded against the wire format (the
varint/tag codec below), and the service runs on ``grpcwire``, the port's
unary gRPC over HTTP/2 on the standard library, where the JAX package
runs on grpcio's GenericRpcHandler; no generated stubs either way.
Wire-compatible message shapes:

  SearchRequest  { string query = 1; int32 limit = 2;
                   repeated float vector = 3; float min_score = 4; }
  SearchHit      { string id = 1; float score = 2; string content = 3; }
  SearchResponse { repeated SearchHit hits = 1; int64 took_micros = 2; }

Service: nornicdb.SearchService / Search

A raw-vector request is ``db.search.vector_candidates``, which reaches the
streaming top-k kernel over a large corpus on the card; a text request is
``db.search.search``. Where it differs from the JAX package: a
``DeviceUnavailable`` (the card is not serving) answers UNAVAILABLE with
details that start ``device_unavailable``, the port's policy at every
edge (HTTP 503, Bolt's transient error); grpcio would answer UNKNOWN.
A shed (``ResourceExhausted``) answers RESOURCE_EXHAUSTED, as in JAX.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch.errors import (
    DeviceUnavailable,
    NotFoundError,
    ResourceExhausted,
)
from nornicdb_tpu_torch.server import grpcwire
from nornicdb_tpu_torch.server.respcache import ResponseCache
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

SERVICE_NAME = "nornicdb.SearchService"
SEARCH_METHOD = f"/{SERVICE_NAME}/Search"

_GRPC_HIST = _REGISTRY.histogram(
    "nornicdb_grpc_request_seconds",
    "gRPC Search latency (incl. cache hits)",
)


# ---------------------------------------------------------------- protobuf
def _varint(v: int) -> bytes:
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
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def encode_search_request(
    query: str = "", limit: int = 10,
    vector=None, min_score: float = 0.0,
) -> bytes:
    out = bytearray()
    if query:
        q = query.encode()
        out += _tag(1, 2) + _varint(len(q)) + q
    if limit:
        out += _tag(2, 0) + _varint(limit)
    if vector is not None and len(vector):
        packed = np.asarray(vector, dtype="<f4").tobytes()
        out += _tag(3, 2) + _varint(len(packed)) + packed
    if min_score:
        out += _tag(4, 5) + struct.pack("<f", min_score)
    return bytes(out)


def decode_search_request(buf: bytes) -> dict[str, Any]:
    pos = 0
    out: dict[str, Any] = {"query": "", "limit": 10, "vector": [], "min_score": 0.0}
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            if field == 2:
                out["limit"] = v
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            data = buf[pos : pos + ln]
            pos += ln
            if field == 1:
                out["query"] = data.decode()
            elif field == 3:
                out["vector"] = np.frombuffer(data, dtype="<f4").tolist()
        elif wire == 5:
            (v,) = struct.unpack_from("<f", buf, pos)
            pos += 4
            if field == 4:
                out["min_score"] = v
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return out


def encode_search_response(hits: list[dict[str, Any]], took_micros: int) -> bytes:
    out = bytearray()
    for h in hits:
        hit = bytearray()
        hid = str(h["id"]).encode()
        hit += _tag(1, 2) + _varint(len(hid)) + hid
        hit += _tag(2, 5) + struct.pack("<f", float(h["score"]))
        content = str(h.get("content", "")).encode()
        if content:
            hit += _tag(3, 2) + _varint(len(content)) + content
        out += _tag(1, 2) + _varint(len(hit)) + bytes(hit)
    out += _tag(2, 0) + _varint(took_micros)
    return bytes(out)


def decode_search_response(buf: bytes) -> dict[str, Any]:
    pos = 0
    hits = []
    took = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2 and field == 1:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            hit = {"id": "", "score": 0.0, "content": ""}
            spos = 0
            while spos < len(sub):
                skey, spos = _read_varint(sub, spos)
                sfield, swire = skey >> 3, skey & 7
                if swire == 2:
                    sln, spos = _read_varint(sub, spos)
                    data = sub[spos : spos + sln]
                    spos += sln
                    if sfield == 1:
                        hit["id"] = data.decode()
                    elif sfield == 3:
                        hit["content"] = data.decode()
                elif swire == 5:
                    (hit["score"],) = struct.unpack_from("<f", sub, spos)
                    spos += 4
                else:
                    v, spos = _read_varint(sub, spos)
            hits.append(hit)
        elif wire == 0 and field == 2:
            took, pos = _read_varint(buf, pos)
        else:
            break
    return {"hits": hits, "took_micros": took}


# ---------------------------------------------------------------- service
class GrpcSearchServer:
    """(ref: nornicgrpc search_service.go) over ``grpcwire``."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 0):
        if max_workers <= 0:
            # handler work is tiny (cached search + hand-rolled protobuf);
            # on few-core boxes extra handler threads just add GIL churn
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            max_workers = max(2, min(8, cores * 2))
        self.db = db
        self._resp_cache = ResponseCache(lambda: db.search._generation)
        self._server = grpcwire.Server(host, port, max_workers)
        self._server.add_method(SEARCH_METHOD, self._search)
        self.port = self._server.port
        self.host = host

    def _search(self, request: bytes, context) -> bytes:
        # cache-hit fast path BEFORE the trace machinery: a hit skips
        # decode, rank, encode
        t_hit = time.perf_counter()
        cached = self._resp_cache.get(request)
        if cached is not None:
            _GRPC_HIST.observe(time.perf_counter() - t_hit)
            return cached
        # ingress trace root; clients may attach a W3C traceparent as gRPC
        # metadata, carrying their trace across the process boundary
        traceparent = None
        try:
            for key, value in context.invocation_metadata() or ():
                if key == "traceparent":
                    traceparent = value
                    break
        except (AttributeError, TypeError):  # doubles without metadata
            traceparent = None
        t_req = time.perf_counter()
        try:
            with _tracer.start_trace("grpc.search", traceparent=traceparent):
                return self._search_traced(request)
        except ResourceExhausted as e:
            # serving admission control shed this query: the canonical
            # gRPC backpressure status, so clients back off
            context.abort(grpcwire.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except DeviceUnavailable as e:
            # the card is not serving: a transient status, never an
            # answer from the host (the port's policy at every edge)
            context.abort(grpcwire.StatusCode.UNAVAILABLE,
                          f"device_unavailable: {e}")
        finally:
            _GRPC_HIST.observe(time.perf_counter() - t_req)

    def _search_traced(self, request: bytes) -> bytes:
        # serialized-response cache: generation-invalidated + short TTL,
        # shared policy with the HTTP search cache (server/respcache.py)
        cached = self._resp_cache.get(request)
        if cached is not None:
            return cached
        gen_before = self._resp_cache.generation()
        t0 = time.perf_counter()
        req = decode_search_request(request)
        if len(req["vector"]):
            hits = self.db.search.vector_candidates(
                np.asarray(req["vector"], np.float32),
                k=req["limit"], min_similarity=req["min_score"],
            )
            out = []
            for nid, score in hits:
                node = None
                try:
                    node = self.db.storage.get_node(nid)
                except NotFoundError:
                    pass  # hit evicted between search and fetch: skip detail
                out.append(
                    {
                        "id": nid,
                        "score": score,
                        "content": node.properties.get("content", "") if node else "",
                    }
                )
        else:
            results = self.db.search.search(req["query"], limit=req["limit"])
            out = [
                {"id": r["id"], "score": r["score"], "content": r["content"]}
                for r in results
            ]
        took = int((time.perf_counter() - t0) * 1e6)
        payload = encode_search_response(out, took)
        self._resp_cache.put(request, payload, gen_before)
        return payload

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=1)


def search_over_grpc(
    host: str, port: int, query: str = "",
    vector: Optional[list[float]] = None, limit: int = 10,
    min_score: float = 0.0, channel: Optional[grpcwire.Channel] = None,
) -> dict[str, Any]:
    """Client helper over ``grpcwire.Channel`` (any protobuf-speaking
    client can hit the same endpoint with generated stubs). Pass
    ``channel`` to reuse a connection across calls: per-call connection
    setup and teardown costs more than the search itself under load."""
    own_channel = channel is None
    if own_channel:
        channel = grpcwire.Channel(host, port)
    fn = channel.unary_unary(SEARCH_METHOD)
    req = encode_search_request(query, limit, vector, min_score)
    try:
        resp = fn(req, timeout=10)
    finally:
        if own_channel:
            channel.close()
    return decode_search_response(resp)
