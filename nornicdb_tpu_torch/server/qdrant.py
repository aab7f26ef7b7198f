"""Qdrant-compatible vector API: the port's copy of
``nornicdb_tpu/server/qdrant.py``.

Behavioral reference: the upstream NornicDB pkg/qdrantgrpc/ — Collections/
Points services (collections_service.go, points_service.go), collection
registry mapped onto graph nodes with label "QdrantPoint" (registry.go),
named-vector support; points indexed into the same search service
(server.go:207).

The Qdrant REST shapes are mounted on the HTTP server under
/collections/* (this file); the Qdrant gRPC services
(``qdrant_grpc.py``) wrap the same registry.

Where it differs from the JAX package: every corpus the registry builds
is a ``DeviceCorpus`` on the registry's ``device`` (``None`` means CUDA;
the CPU only when the caller names it) behind the device owner's gate
(the process default for a CUDA corpus, as the DB's own corpus). A collection
search on a card that is not serving raises ``DeviceUnavailable``, which
the HTTP edge answers with a 503; it never answers from the host. The
filtered search ranks the whole corpus (``k = max(limit, len(corpus))``),
as in JAX, so only an unfiltered search over a large collection reaches
the streaming top-k kernel. ``matching_ids`` looks the collection up in
the registry where JAX counts its points (``info``, a scan of every
point under the registry lock): the same answers, one scan of the points
a filtered search, count or scroll instead of two.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.errors import (
    AlreadyExistsError,
    NornicError,
    NotFoundError,
)
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.storage.types import Engine, Node

POINT_LABEL = "QdrantPoint"


# ------------------------------------------------------------- filters
def _payload_get(payload: dict, key: str):
    """Dotted-path payload access (ref: Qdrant nested payload keys)."""
    cur: Any = payload
    for part in key.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _eq(a: Any, b: Any) -> bool:
    """Type-strict equality: True != 1 (payload bools vs integers)."""
    return isinstance(a, bool) == isinstance(b, bool) and a == b


def _match_one(value: Any, match: dict) -> bool:
    """Qdrant Match semantics: equality for keyword/integer/boolean, substring
    for text, membership for any/except; list-valued payloads match if any
    element matches (ref: pkg/qdrantgrpc points filters)."""
    values = value if isinstance(value, list) else [value]
    if "text" in match:
        needle = str(match["text"])
        return any(isinstance(v, str) and needle in v for v in values)
    if "any" in match:
        allowed = match["any"] if isinstance(match["any"], list) else []
        return any(any(_eq(v, a) for a in allowed) for v in values)
    if "except" in match:
        banned = match["except"] if isinstance(match["except"], list) else []
        return value is not None and all(
            not any(_eq(v, b) for b in banned) for v in values
        )
    for k in ("value", "keyword", "integer", "boolean"):
        if k in match:
            return any(_eq(v, match[k]) for v in values)
    raise NornicError(f"invalid match clause {match!r}")


def _range_ok(value: Any, rng: dict) -> bool:
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return False
    if "gt" in rng and rng["gt"] is not None and not value > rng["gt"]:
        return False
    if "gte" in rng and rng["gte"] is not None and not value >= rng["gte"]:
        return False
    if "lt" in rng and rng["lt"] is not None and not value < rng["lt"]:
        return False
    if "lte" in rng and rng["lte"] is not None and not value <= rng["lte"]:
        return False
    return True


def _eval_condition(cond: dict, point_id: Any, payload: dict) -> bool:
    if not isinstance(cond, dict):
        raise NornicError(f"invalid filter condition {cond!r}")
    if "must" in cond or "should" in cond or "must_not" in cond:
        return eval_filter(cond, point_id, payload)  # nested Filter
    if "filter" in cond:
        return eval_filter(cond["filter"], point_id, payload)
    if "has_id" in cond:
        ids = cond["has_id"]
        return point_id in (ids if isinstance(ids, list) else [ids])
    if "is_empty" in cond:
        v = _payload_get(payload, cond["is_empty"].get("key", ""))
        return v is None or v == [] or v == ""
    if "is_null" in cond:
        key = cond["is_null"].get("key", "")
        return _payload_get(payload, key) is None and _has_key(payload, key)
    key = cond.get("key")
    if key is None:
        raise NornicError(f"invalid filter condition {cond!r}")
    value = _payload_get(payload, key)
    if "match" in cond:
        return value is not None and _match_one(value, cond["match"])
    if "range" in cond:
        return _range_ok(value, cond["range"])
    raise NornicError(f"unsupported filter condition {cond!r}")


def _has_key(payload: dict, key: str) -> bool:
    parts = key.split(".")
    cur: Any = payload
    for part in parts:
        if not isinstance(cur, dict) or part not in cur:
            return False
        cur = cur[part]
    return True


def eval_filter(flt: Optional[dict], point_id: Any, payload: dict) -> bool:
    """Evaluate a Qdrant Filter (must AND / should OR / must_not NONE, each a
    list of Conditions; conditions may nest Filters). JSON-dict form shared by
    the REST transport and the gRPC decoder (ref: pkg/qdrantgrpc filter
    handling in points_service.go)."""
    if not flt:
        return True
    must = flt.get("must") or []
    should = flt.get("should") or []
    must_not = flt.get("must_not") or []
    if isinstance(must, dict):
        must = [must]
    if isinstance(should, dict):
        should = [should]
    if isinstance(must_not, dict):
        must_not = [must_not]
    if any(_eval_condition(c, point_id, payload) for c in must_not):
        return False
    if not all(_eval_condition(c, point_id, payload) for c in must):
        return False
    if should and not any(_eval_condition(c, point_id, payload) for c in should):
        return False
    return True


class QdrantCollections:
    """Collection registry over graph nodes (ref: registry.go:149 analogue —
    per-collection vector space + device corpus). Every corpus lives on
    ``device``, behind the process's device owner when that is the card."""

    def __init__(self, storage: Engine, vectorspaces=None, *,
                 device: DeviceLike = None):
        self.storage = storage
        self.vectorspaces = vectorspaces
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._collections: dict[str, dict[str, Any]] = {}
        self._corpora: dict[str, DeviceCorpus] = {}
        # rebuild registry from persisted points (default AND named vectors)
        for n in storage.get_nodes_by_label(POINT_LABEL):
            coll = n.properties.get("_collection")
            if not coll:
                continue
            meta = self._collections.setdefault(
                coll, {"size": 0, "distance": "Cosine", "named": {}}
            )
            if n.embedding is not None and not meta["size"]:
                meta["size"] = int(n.embedding.shape[0])
            for vec_name, v in n.named_embeddings.items():
                meta.setdefault("named", {}).setdefault(
                    vec_name, {"size": int(v.shape[0]), "distance": "Cosine"}
                )
        for name in self._collections:
            self._rebuild_corpus(name)

    def _new_corpus(self, dims: int) -> DeviceCorpus:
        return DeviceCorpus(dims=dims, device=self.device)

    def _rebuild_corpus(self, name: str) -> None:
        info = self._collections[name]
        if info.get("size"):
            corpus = self._new_corpus(info["size"])
            for n in self.storage.get_nodes_by_label(POINT_LABEL):
                if n.properties.get("_collection") == name and n.embedding is not None:
                    corpus.add(n.id, n.embedding)
            self._corpora[name] = corpus
        for vec_name, spec in (info.get("named") or {}).items():
            nc = self._new_corpus(int(spec.get("size", 1)) or 1)
            for n in self.storage.get_nodes_by_label(POINT_LABEL):
                if n.properties.get("_collection") != name:
                    continue
                v = n.named_embeddings.get(vec_name)
                if v is not None:
                    nc.add(n.id, v)
            self._corpora[f"{name}/{vec_name}"] = nc

    # -- collections -------------------------------------------------------
    def create(self, name: str, size: int = 0, distance: str = "Cosine",
               named: Optional[dict[str, dict]] = None) -> None:
        """size/distance for the default vector; `named` maps vector names
        to {"size", "distance"} for named-vector collections
        (ref: named-vector support, pkg/qdrantgrpc registry.go)."""
        named = named or {}
        with self._lock:
            self._collections[name] = {
                "size": int(size), "distance": distance,
                "named": {k: {"size": int(v.get("size", 0)),
                              "distance": v.get("distance", "Cosine")}
                          for k, v in named.items()},
            }
            if size:
                self._corpora[name] = self._new_corpus(int(size))
            for vec_name, spec in named.items():
                self._corpora[f"{name}/{vec_name}"] = self._new_corpus(
                    int(spec.get("size", 0)) or 1
                )
        if self.vectorspaces is not None:
            from nornicdb_tpu_torch.vectorspace import VectorSpaceKey

            if size:
                self.vectorspaces.register(
                    VectorSpaceKey(f"qdrant:{name}", int(size), distance.lower())
                )
            for vec_name, spec in named.items():
                self.vectorspaces.register(
                    VectorSpaceKey(
                        f"qdrant:{name}:{vec_name}", int(spec.get("size", 0)),
                        str(spec.get("distance", "Cosine")).lower(),
                    )
                )

    def drop(self, name: str) -> bool:
        with self._lock:
            existed = self._collections.pop(name, None) is not None
            self._corpora.pop(name, None)
            for key in [k for k in self._corpora if k.startswith(f"{name}/")]:
                self._corpora.pop(key, None)
        for n in list(self.storage.get_nodes_by_label(POINT_LABEL)):
            if n.properties.get("_collection") == name:
                self.storage.delete_node(n.id)
        return existed

    def list(self) -> list[dict[str, Any]]:
        with self._lock:
            return [{"name": n} for n in sorted(self._collections)]

    def params(self, name: str) -> Optional[dict[str, Any]]:
        """Public copy of a collection's vector params (size/distance/named),
        so transports never reach into the locked internal registry."""
        with self._lock:
            meta = self._collections.get(name)
            if meta is None:
                return None
            return {
                "size": meta.get("size", 0),
                "distance": meta.get("distance", "Cosine"),
                "named": {k: dict(v) for k, v in (meta.get("named") or {}).items()},
            }

    def info(self, name: str) -> Optional[dict[str, Any]]:
        with self._lock:
            meta = self._collections.get(name)
            if meta is None:
                return None
            count = sum(
                1
                for n in self.storage.get_nodes_by_label(POINT_LABEL)
                if n.properties.get("_collection") == name
            )
            return {
                "status": "green",
                "vectors_count": count,
                "points_count": count,
                "config": {
                    "params": {
                        "vectors": {"size": meta["size"], "distance": meta["distance"]}
                    }
                },
            }

    # -- points ------------------------------------------------------------
    def _node_id(self, collection: str, point_id: Any) -> str:
        return f"qdrant-{collection}-{point_id}"

    def upsert(self, collection: str, points: list[dict[str, Any]]) -> int:
        with self._lock:
            if collection not in self._collections:
                raise NotFoundError(f"collection {collection} not found")
            corpus = self._corpora.get(collection)
        n = 0
        for p in points:
            raw_vec = p["vector"]
            named_vecs: dict[str, np.ndarray] = {}
            vec = None
            if isinstance(raw_vec, dict):
                named_vecs = {k: np.asarray(v, np.float32)
                              for k, v in raw_vec.items()}
            else:
                vec = np.asarray(raw_vec, np.float32)
            nid = self._node_id(collection, p["id"])
            # underscore-prefixed keys are internal bookkeeping (_collection,
            # _point_id) — client payloads must never clobber them
            payload = {k: v for k, v in (p.get("payload") or {}).items()
                       if not k.startswith("_")}
            node = Node(
                id=nid,
                labels=[POINT_LABEL],
                properties={"_collection": collection, "_point_id": p["id"],
                            **payload},
                embedding=vec,
                named_embeddings=named_vecs,
            )
            try:
                self.storage.create_node(node)
            except AlreadyExistsError:
                existing = self.storage.get_node(nid)
                existing.properties = dict(node.properties)
                existing.embedding = vec
                existing.named_embeddings = named_vecs
                self.storage.update_node(existing)
            if vec is not None and corpus is not None:
                corpus.add(nid, vec)
            for vec_name, v in named_vecs.items():
                nc = self._corpora.get(f"{collection}/{vec_name}")
                if nc is None:
                    continue
                if nc.dims != v.shape[0]:
                    raise NornicError(
                        f"vector '{vec_name}' has {v.shape[0]} dims, "
                        f"collection expects {nc.dims}"
                    )
                nc.add(nid, v)
            n += 1
        return n

    def delete_points(self, collection: str, ids: list[Any]) -> int:
        with self._lock:
            corpora = [
                c for key, c in self._corpora.items()
                if key == collection or key.startswith(f"{collection}/")
            ]
        n = 0
        for pid in ids:
            nid = self._node_id(collection, pid)
            try:
                self.storage.delete_node(nid)
                n += 1
            except NotFoundError:
                continue
            for c in corpora:
                c.remove(nid)
        return n

    def _iter_points(self, collection: str):
        for n in self.storage.get_nodes_by_label(POINT_LABEL):
            if n.properties.get("_collection") == collection:
                yield n

    def matching_ids(self, collection: str,
                     query_filter: Optional[dict]) -> list[Any]:
        """Point ids in `collection` whose payload satisfies the Qdrant
        filter (all points when the filter is empty)."""
        with self._lock:  # JAX counts the points here (info): a second scan
            known = collection in self._collections
        if not known:
            raise NotFoundError(f"collection {collection} not found")
        out = []
        for n in self._iter_points(collection):
            pid = n.properties.get("_point_id")
            payload = {k: v for k, v in n.properties.items()
                       if not k.startswith("_")}
            if eval_filter(query_filter, pid, payload):
                out.append(pid)
        return out

    def count(self, collection: str,
              query_filter: Optional[dict] = None) -> int:
        if not query_filter:
            info = self.info(collection)
            if info is None:
                raise NotFoundError(f"collection {collection} not found")
            return info["points_count"]
        return len(self.matching_ids(collection, query_filter))

    def scroll(self, collection: str, offset: Any = None, limit: int = 10,
               query_filter: Optional[dict] = None
               ) -> tuple[list[Any], Optional[Any]]:
        """Stable id-ordered page of point ids; returns (page, next_offset)
        (ref: points_service.go Scroll — deterministic paging)."""
        pts = sorted(
            self.matching_ids(collection, query_filter),
            key=lambda p: (isinstance(p, str), str(p)),
        )
        if offset is not None:
            key = (isinstance(offset, str), str(offset))
            pts = [p for p in pts if (isinstance(p, str), str(p)) >= key]
        page, rest = pts[:limit], pts[limit:]
        return page, (rest[0] if rest else None)

    def search(
        self,
        collection: str,
        vector,
        limit: int = 10,
        score_threshold: float = -1.0,
        with_payload: bool = True,
        query_filter: Optional[dict] = None,
    ) -> list[dict[str, Any]]:
        key = collection
        if isinstance(vector, dict):  # named vector: {"name": ..., "vector": [...]}
            key = f"{collection}/{vector.get('name', '')}"
            vector = vector.get("vector", [])
        with self._lock:
            corpus = self._corpora.get(key)
        if corpus is None:
            raise NotFoundError(f"collection {collection} not found")
        allowed = None
        k = limit
        if query_filter:
            allowed = {
                self._node_id(collection, pid)
                for pid in self.matching_ids(collection, query_filter)
            }
            # filtering happens post-top-k, so rank the whole corpus to
            # guarantee `limit` survivors when they exist (exact, like the
            # reference's filtered search; ANN-with-filter is a later lever)
            k = max(limit, len(corpus))
        res = corpus.search(
            np.asarray(vector, np.float32), k=k,
            min_similarity=score_threshold,
        )
        out = []
        for nid, score in res[0] if res else []:
            if allowed is not None and nid not in allowed:
                continue
            try:
                node = self.storage.get_node(nid)
            except NotFoundError:
                continue
            item = {"id": node.properties.get("_point_id"), "score": score,
                    "version": 0}
            if with_payload:
                item["payload"] = {
                    k: v for k, v in node.properties.items()
                    if not k.startswith("_")
                }
            out.append(item)
            if len(out) >= limit:
                break
        return out

    def retrieve(self, collection: str, ids: list[Any]) -> list[dict[str, Any]]:
        out = []
        for pid in ids:
            try:
                node = self.storage.get_node(self._node_id(collection, pid))
            except NotFoundError:
                continue
            if node.named_embeddings:
                vector: Any = {
                    k: v.tolist() for k, v in node.named_embeddings.items()
                }
                if node.embedding is not None:
                    vector[""] = node.embedding.tolist()
            else:
                vector = (
                    node.embedding.tolist()
                    if node.embedding is not None
                    else None
                )
            out.append(
                {
                    "id": pid,
                    "payload": {
                        k: v for k, v in node.properties.items()
                        if not k.startswith("_")
                    },
                    "vector": vector,
                }
            )
        return out


def handle_qdrant(registry: QdrantCollections, method: str, path: str,
                  body: dict) -> Optional[tuple[int, dict]]:
    """Route a /collections/* request; None if the path isn't Qdrant's."""

    def ok(result: Any, code: int = 200) -> tuple[int, dict]:
        return code, {"result": result, "status": "ok", "time": 0.0}

    m = re.fullmatch(r"/collections", path)
    if m and method == "GET":
        return ok({"collections": registry.list()})
    m = re.fullmatch(r"/collections/([^/]+)", path)
    if m:
        name = m.group(1)
        if method == "PUT":
            vectors = body.get("vectors", {})
            if isinstance(vectors, dict) and "size" in vectors:
                registry.create(name, int(vectors["size"]),
                                str(vectors.get("distance", "Cosine")))
            elif isinstance(vectors, dict) and vectors and all(
                isinstance(v, dict) for v in vectors.values()
            ):
                registry.create(name, named=vectors)  # named-vector config
            else:
                registry.create(name, int(body.get("size", 0)),
                                str(body.get("distance", "Cosine")))
            return ok(True)
        if method == "GET":
            info = registry.info(name)
            if info is None:
                return 404, {"status": {"error": f"collection {name} not found"}}
            return ok(info)
        if method == "DELETE":
            return ok(registry.drop(name))
    m = re.fullmatch(r"/collections/([^/]+)/points", path)
    if m and method == "PUT":
        n = registry.upsert(m.group(1), body.get("points", []))
        return ok({"operation_id": 0, "status": "completed", "upserted": n})
    m = re.fullmatch(r"/collections/([^/]+)/points/search", path)
    if m and method == "POST":
        hits = registry.search(
            m.group(1),
            body.get("vector", []),
            limit=int(body.get("limit", 10)),
            score_threshold=float(body.get("score_threshold", -1.0)),
            with_payload=bool(body.get("with_payload", True)),
            query_filter=body.get("filter"),
        )
        return ok(hits)
    m = re.fullmatch(r"/collections/([^/]+)/points/count", path)
    if m and method == "POST":
        return ok({"count": registry.count(m.group(1), body.get("filter"))})
    m = re.fullmatch(r"/collections/([^/]+)/points/scroll", path)
    if m and method == "POST":
        page, nxt = registry.scroll(
            m.group(1), offset=body.get("offset"),
            limit=int(body.get("limit", 10)),
            query_filter=body.get("filter"),
        )
        return ok({"points": registry.retrieve(m.group(1), page),
                   "next_page_offset": nxt})
    m = re.fullmatch(r"/collections/([^/]+)/points/delete", path)
    if m and method == "POST":
        n = registry.delete_points(m.group(1), body.get("points", []))
        return ok({"operation_id": 0, "status": "completed", "deleted": n})
    m = re.fullmatch(r"/collections/([^/]+)/points", path)
    if m and method == "POST":
        return ok(registry.retrieve(m.group(1), body.get("ids", [])))
    m = re.fullmatch(r"/collections/([^/]+)/snapshots", path)
    if m and method == "POST":
        # snapshot of the collection's points INCLUDING vectors
        # (ref: snapshots_service.go) — scans only QdrantPoint nodes
        name = m.group(1)
        if registry.info(name) is None:
            return 404, {"status": {"error": f"collection {name} not found"}}
        points = []
        for n in registry.storage.get_nodes_by_label(POINT_LABEL):
            if n.properties.get("_collection") != name:
                continue
            points.append(
                {
                    "id": n.properties.get("_point_id"),
                    "payload": {
                        k: v for k, v in n.properties.items()
                        if not k.startswith("_")
                    },
                    "vector": (
                        {k: v.tolist() for k, v in n.named_embeddings.items()}
                        if n.named_embeddings
                        else (n.embedding.tolist()
                              if n.embedding is not None else None)
                    ),
                }
            )
        return ok({"name": f"{name}-snapshot", "points": points,
                   "count": len(points)})
    return None
