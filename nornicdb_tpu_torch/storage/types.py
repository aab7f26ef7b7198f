"""Core graph storage types of the port, counterpart of
``nornicdb_tpu/storage/types.py`` (the port imports nothing of the JAX
package, so it keeps its own copy).

Behavioral reference: the upstream NornicDB pkg/storage/types.go
  - Node / Edge shapes: types.go:185-346 (DecayScore, AccessCount,
    NamedEmbeddings map[string][]float32, ChunkEmbeddings)
  - Engine interface:   types.go:355-414

Embeddings are numpy float32 arrays on the host; the copy the card
searches lives in the search service's ``DeviceCorpus``, fed through the
engine's events. ``to_dict`` serialises through ``np.asarray``, so a CUDA
tensor raises at the chain's door instead of being copied to the host.
Events are synchronous callbacks; the async write-behind layer is a
separate decorator engine. Pure Python and numpy: no device work here.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError

log = logging.getLogger(__name__)

# Memory type tiers driving decay half-lives (ref: pkg/decay/decay.go:80-125).
EPISODIC = "episodic"
SEMANTIC = "semantic"
PROCEDURAL = "procedural"


def new_id() -> str:
    return str(uuid.uuid4())


def _now() -> float:
    return time.time()


@dataclass
class Node:
    """A graph node (ref: pkg/storage/types.go:185)."""

    id: str = field(default_factory=new_id)
    labels: list[str] = field(default_factory=list)
    properties: dict[str, Any] = field(default_factory=dict)
    embedding: Optional[np.ndarray] = None
    # Multiple named vector spaces per node (ref: NamedEmbeddings types.go:196).
    named_embeddings: dict[str, np.ndarray] = field(default_factory=dict)
    # Per-chunk embeddings for long documents (ref: ChunkEmbeddings types.go:197).
    chunk_embeddings: list[np.ndarray] = field(default_factory=list)
    decay_score: float = 1.0
    access_count: int = 0
    memory_type: str = SEMANTIC
    created_at: float = field(default_factory=_now)
    updated_at: float = field(default_factory=_now)
    last_accessed: float = field(default_factory=_now)

    def copy(self) -> "Node":
        return Node(
            id=self.id,
            labels=list(self.labels),
            properties=dict(self.properties),
            embedding=None if self.embedding is None else np.array(self.embedding),
            named_embeddings={k: np.array(v) for k, v in self.named_embeddings.items()},
            chunk_embeddings=[np.array(v) for v in self.chunk_embeddings],
            decay_score=self.decay_score,
            access_count=self.access_count,
            memory_type=self.memory_type,
            created_at=self.created_at,
            updated_at=self.updated_at,
            last_accessed=self.last_accessed,
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "id": self.id,
            "labels": list(self.labels),
            "properties": dict(self.properties),
            "decay_score": self.decay_score,
            "access_count": self.access_count,
            "memory_type": self.memory_type,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "last_accessed": self.last_accessed,
        }
        if self.embedding is not None:
            d["embedding"] = np.asarray(self.embedding, dtype=np.float32).tolist()
        if self.named_embeddings:
            d["named_embeddings"] = {
                k: np.asarray(v, dtype=np.float32).tolist()
                for k, v in self.named_embeddings.items()
            }
        if self.chunk_embeddings:
            d["chunk_embeddings"] = [
                np.asarray(v, dtype=np.float32).tolist() for v in self.chunk_embeddings
            ]
        return d

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Node":
        n = Node(
            id=d["id"],
            labels=list(d.get("labels", [])),
            properties=dict(d.get("properties", {})),
            decay_score=d.get("decay_score", 1.0),
            access_count=d.get("access_count", 0),
            memory_type=d.get("memory_type", SEMANTIC),
            created_at=d.get("created_at", _now()),
            updated_at=d.get("updated_at", _now()),
            last_accessed=d.get("last_accessed", _now()),
        )
        if d.get("embedding") is not None:
            n.embedding = np.asarray(d["embedding"], dtype=np.float32)
        for k, v in (d.get("named_embeddings") or {}).items():
            n.named_embeddings[k] = np.asarray(v, dtype=np.float32)
        for v in d.get("chunk_embeddings") or []:
            n.chunk_embeddings.append(np.asarray(v, dtype=np.float32))
        return n


@dataclass
class Edge:
    """A directed, typed relationship (ref: pkg/storage/types.go:298)."""

    id: str = field(default_factory=new_id)
    start_node: str = ""
    end_node: str = ""
    type: str = "RELATED_TO"
    properties: dict[str, Any] = field(default_factory=dict)
    # Auto-TLP provenance (ref: inference edges carry confidence + AutoGenerated).
    confidence: float = 1.0
    auto_generated: bool = False
    decay_score: float = 1.0
    access_count: int = 0
    created_at: float = field(default_factory=_now)
    updated_at: float = field(default_factory=_now)

    def copy(self) -> "Edge":
        return Edge(
            id=self.id,
            start_node=self.start_node,
            end_node=self.end_node,
            type=self.type,
            properties=dict(self.properties),
            confidence=self.confidence,
            auto_generated=self.auto_generated,
            decay_score=self.decay_score,
            access_count=self.access_count,
            created_at=self.created_at,
            updated_at=self.updated_at,
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "start_node": self.start_node,
            "end_node": self.end_node,
            "type": self.type,
            "properties": dict(self.properties),
            "confidence": self.confidence,
            "auto_generated": self.auto_generated,
            "decay_score": self.decay_score,
            "access_count": self.access_count,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Edge":
        return Edge(
            id=d["id"],
            start_node=d.get("start_node", ""),
            end_node=d.get("end_node", ""),
            type=d.get("type", "RELATED_TO"),
            properties=dict(d.get("properties", {})),
            confidence=d.get("confidence", 1.0),
            auto_generated=d.get("auto_generated", False),
            decay_score=d.get("decay_score", 1.0),
            access_count=d.get("access_count", 0),
            created_at=d.get("created_at", _now()),
            updated_at=d.get("updated_at", _now()),
        )


# Event kinds fired by engines (ref: BadgerEngine.notifyNodeCreated badger.go:162,
# wired to search indexing in pkg/nornicdb/db.go:1020-1033).
NODE_CREATED = "node_created"
NODE_UPDATED = "node_updated"
NODE_DELETED = "node_deleted"
EDGE_CREATED = "edge_created"
EDGE_UPDATED = "edge_updated"
EDGE_DELETED = "edge_deleted"

EventCallback = Callable[[str, Any], None]


class EventEmitter:
    """Mixin providing storage event callbacks."""

    def __init__(self) -> None:
        self._callbacks: list[EventCallback] = []
        self._events_lock = threading.Lock()

    def on_event(self, cb: EventCallback) -> None:
        with self._events_lock:
            self._callbacks.append(cb)

    def off_event(self, cb: EventCallback) -> None:
        """Unsubscribe (needed by anything shorter-lived than the engine,
        e.g. a WorkerPool whose generation file closes on stop)."""
        with self._events_lock:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    def _emit(self, kind: str, entity: Any) -> None:
        with self._events_lock:
            cbs = list(self._callbacks)
        for cb in cbs:
            try:
                cb(kind, entity)
            except Exception:
                # listeners must not break the write path, but a crashing
                # listener (index updater, cache invalidator, replicator)
                # is corrupting its own view — operators must see it
                log.warning("storage event listener failed on %s", kind,
                            exc_info=True)


class Engine(EventEmitter):
    """Abstract storage engine (ref: storage.Engine pkg/storage/types.go:355-414).

    Concrete engines: MemoryEngine, LogEngine (durable), and the decorator
    chain AsyncEngine -> WALEngine -> base, plus NamespacedEngine for multi-DB.

    OWNERSHIP CONTRACT: every Node/Edge RETURNED by a read or write method
    is a caller-owned fresh copy — never an interned/cached object the
    engine retains. Decorators rely on this to mutate return values in
    place (NamespacedEngine re-ids them without re-copying), and callers
    rely on it to mutate results without corrupting the store (pinned by
    test_storage_unit_depth's deep-copy tests on every engine). An engine
    that hands out retained objects breaks both.
    """

    # -- nodes -------------------------------------------------------------
    def create_node(self, node: Node) -> Node:
        raise NotImplementedError

    def get_node(self, node_id: str) -> Node:
        raise NotImplementedError

    def update_node(self, node: Node) -> Node:
        raise NotImplementedError

    def delete_node(self, node_id: str) -> None:
        raise NotImplementedError

    def get_nodes_by_label(self, label: str) -> list[Node]:
        raise NotImplementedError

    def all_nodes(self) -> Iterator[Node]:
        raise NotImplementedError

    def batch_get_nodes(self, ids: Iterable[str]) -> list[Node]:
        out = []
        for i in ids:
            try:
                out.append(self.get_node(i))
            except NotFoundError:
                pass
        return out

    def batch_create_nodes(self, nodes: Iterable[Node]) -> list[Node]:
        return [self.create_node(n) for n in nodes]

    # -- edges -------------------------------------------------------------
    def create_edge(self, edge: Edge) -> Edge:
        raise NotImplementedError

    def get_edge(self, edge_id: str) -> Edge:
        raise NotImplementedError

    def update_edge(self, edge: Edge) -> Edge:
        raise NotImplementedError

    def delete_edge(self, edge_id: str) -> None:
        raise NotImplementedError

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        raise NotImplementedError

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        raise NotImplementedError

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        raise NotImplementedError

    def all_edges(self) -> Iterator[Edge]:
        raise NotImplementedError

    def batch_create_edges(self, edges: Iterable[Edge]) -> list[Edge]:
        return [self.create_edge(e) for e in edges]

    # -- degree / counts ---------------------------------------------------
    def degree(self, node_id: str, direction: str = "both") -> int:
        n = 0
        if direction in ("out", "both"):
            n += len(self.get_outgoing_edges(node_id))
        if direction in ("in", "both"):
            n += len(self.get_incoming_edges(node_id))
        return n

    def node_count(self) -> int:
        raise NotImplementedError

    def edge_count(self) -> int:
        raise NotImplementedError

    def count_nodes_by_label(self, label: str) -> int:
        return len(self.get_nodes_by_label(label))

    def count_edges_by_type(self, edge_type: str) -> int:
        return len(self.get_edges_by_type(edge_type))

    # -- pending-embed index (ref: key prefix 0x07 badger.go:24) -----------
    def mark_pending_embed(self, node_id: str) -> None:
        raise NotImplementedError

    def unmark_pending_embed(self, node_id: str) -> None:
        raise NotImplementedError

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------
    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryEngine(Engine):
    """In-memory engine; the default test backend, and the recovery target for
    WAL replay (ref: pkg/storage/memory.go; Open("") path db.go:898-913)."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._edges: dict[str, Edge] = {}
        self._by_label: dict[str, set[str]] = {}
        self._by_type: dict[str, set[str]] = {}
        self._out: dict[str, set[str]] = {}
        self._in: dict[str, set[str]] = {}
        self._pending_embed: dict[str, float] = {}  # id -> enqueue ts (ordered)

    # -- nodes -------------------------------------------------------------
    def create_node(self, node: Node) -> Node:
        with self._lock:
            if node.id in self._nodes:
                raise AlreadyExistsError(f"node {node.id} already exists")
            stored = node.copy()
            self._nodes[stored.id] = stored
            for lbl in stored.labels:
                self._by_label.setdefault(lbl, set()).add(stored.id)
        self._emit(NODE_CREATED, stored.copy())
        return stored.copy()

    def get_node(self, node_id: str) -> Node:
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None:
                raise NotFoundError(f"node {node_id} not found")
            return n.copy()

    def update_node(self, node: Node) -> Node:
        with self._lock:
            old = self._nodes.get(node.id)
            if old is None:
                raise NotFoundError(f"node {node.id} not found")
            stored = node.copy()
            stored.created_at = old.created_at
            stored.updated_at = _now()
            for lbl in old.labels:
                self._by_label.get(lbl, set()).discard(old.id)
            for lbl in stored.labels:
                self._by_label.setdefault(lbl, set()).add(stored.id)
            self._nodes[stored.id] = stored
        self._emit(NODE_UPDATED, stored.copy())
        return stored.copy()

    def delete_node(self, node_id: str) -> None:
        with self._lock:
            n = self._nodes.pop(node_id, None)
            if n is None:
                raise NotFoundError(f"node {node_id} not found")
            for lbl in n.labels:
                self._by_label.get(lbl, set()).discard(node_id)
            # cascade: remove attached edges (ref Engine.DeleteNode semantics)
            attached = list(self._out.get(node_id, set()) | self._in.get(node_id, set()))
            removed_edges = []
            for eid in attached:
                e = self._edges.pop(eid, None)
                if e is None:
                    continue
                self._by_type.get(e.type, set()).discard(eid)
                self._out.get(e.start_node, set()).discard(eid)
                self._in.get(e.end_node, set()).discard(eid)
                removed_edges.append(e)
            self._out.pop(node_id, None)
            self._in.pop(node_id, None)
            self._pending_embed.pop(node_id, None)
        for e in removed_edges:
            self._emit(EDGE_DELETED, e)
        self._emit(NODE_DELETED, n)

    def get_nodes_by_label(self, label: str) -> list[Node]:
        with self._lock:
            ids = list(self._by_label.get(label, set()))
            return [self._nodes[i].copy() for i in ids if i in self._nodes]

    def all_nodes(self) -> Iterator[Node]:
        with self._lock:
            snapshot = [n.copy() for n in self._nodes.values()]
        return iter(snapshot)

    # -- edges -------------------------------------------------------------
    def create_edge(self, edge: Edge) -> Edge:
        with self._lock:
            if edge.id in self._edges:
                raise AlreadyExistsError(f"edge {edge.id} already exists")
            if edge.start_node not in self._nodes:
                raise NotFoundError(f"start node {edge.start_node} not found")
            if edge.end_node not in self._nodes:
                raise NotFoundError(f"end node {edge.end_node} not found")
            stored = edge.copy()
            self._edges[stored.id] = stored
            self._by_type.setdefault(stored.type, set()).add(stored.id)
            self._out.setdefault(stored.start_node, set()).add(stored.id)
            self._in.setdefault(stored.end_node, set()).add(stored.id)
        self._emit(EDGE_CREATED, stored.copy())
        return stored.copy()

    def get_edge(self, edge_id: str) -> Edge:
        with self._lock:
            e = self._edges.get(edge_id)
            if e is None:
                raise NotFoundError(f"edge {edge_id} not found")
            return e.copy()

    def update_edge(self, edge: Edge) -> Edge:
        with self._lock:
            old = self._edges.get(edge.id)
            if old is None:
                raise NotFoundError(f"edge {edge.id} not found")
            stored = edge.copy()
            stored.created_at = old.created_at
            stored.updated_at = _now()
            if old.type != stored.type:
                self._by_type.get(old.type, set()).discard(old.id)
                self._by_type.setdefault(stored.type, set()).add(stored.id)
            self._edges[stored.id] = stored
        self._emit(EDGE_UPDATED, stored.copy())
        return stored.copy()

    def delete_edge(self, edge_id: str) -> None:
        with self._lock:
            e = self._edges.pop(edge_id, None)
            if e is None:
                raise NotFoundError(f"edge {edge_id} not found")
            self._by_type.get(e.type, set()).discard(edge_id)
            self._out.get(e.start_node, set()).discard(edge_id)
            self._in.get(e.end_node, set()).discard(edge_id)
        self._emit(EDGE_DELETED, e)

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        with self._lock:
            ids = list(self._by_type.get(edge_type, set()))
            return [self._edges[i].copy() for i in ids if i in self._edges]

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        with self._lock:
            ids = list(self._out.get(node_id, set()))
            return [self._edges[i].copy() for i in ids if i in self._edges]

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        with self._lock:
            ids = list(self._in.get(node_id, set()))
            return [self._edges[i].copy() for i in ids if i in self._edges]

    # -- no-copy reads for internal fast paths ------------------------------
    # (ref: the Go engines hand out pointers; the Cypher traversal fastpath
    # is dominated by defensive Edge/Node copies without these)
    def iter_adjacency(self, node_id: str, direction: str) -> list[tuple]:
        """(edge_id, edge_type, other_node_id) tuples, built under the lock
        with no Edge materialization. direction: 'out' | 'in'."""
        index = self._out if direction == "out" else self._in
        with self._lock:
            out = []
            for i in index.get(node_id, ()):
                e = self._edges.get(i)
                if e is not None:
                    other = e.end_node if direction == "out" else e.start_node
                    out.append((e.id, e.type, other))
            return out

    def node_entry(self, node_id: str):
        """The stored node WITHOUT copying — READ-ONLY by contract (updates
        replace the stored object, so a held reference stays a consistent
        snapshot). None when absent. Property values alias storage exactly
        as the shallow Node.copy() already does."""
        with self._lock:
            return self._nodes.get(node_id)

    def node_ids_by_label(self, label: str) -> list[str]:
        """Label membership as bare ids — no Node materialization (the
        copying get_nodes_by_label clones embeddings per node, which a
        count or selectivity probe must never pay)."""
        with self._lock:
            return list(self._by_label.get(label, ()))

    def all_node_ids(self) -> list[str]:
        """Every node id with no Node materialization — the adjacency
        snapshot's vocab build (storage/adjacency.py) must not deep-copy
        embeddings just to learn the ids."""
        with self._lock:
            return list(self._nodes)

    def all_edges(self) -> Iterator[Edge]:
        with self._lock:
            snapshot = [e.copy() for e in self._edges.values()]
        return iter(snapshot)

    # -- counts ------------------------------------------------------------
    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def edge_count(self) -> int:
        with self._lock:
            return len(self._edges)

    def count_nodes_by_label(self, label: str) -> int:
        with self._lock:
            return len(self._by_label.get(label, ()))

    def count_edges_by_type(self, edge_type: str) -> int:
        with self._lock:
            return len(self._by_type.get(edge_type, ()))

    # -- pending embed -----------------------------------------------------
    def mark_pending_embed(self, node_id: str) -> None:
        with self._lock:
            if node_id in self._nodes:
                self._pending_embed.setdefault(node_id, _now())

    def unmark_pending_embed(self, node_id: str) -> None:
        with self._lock:
            self._pending_embed.pop(node_id, None)

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        with self._lock:
            ids = sorted(self._pending_embed, key=self._pending_embed.get)
            return ids[:limit] if limit > 0 else ids
