"""Core graph storage types of the port: copies of what the search service,
GraphRAG and their tests use from ``nornicdb_tpu/storage/types.py``.

``Node`` and ``Edge`` keep the reference's names and defaults for the
fields the port reads (a recall's touch bumps ``access_count`` and
``last_accessed``); decay, memory tiers, named and chunk embeddings,
inference provenance and the dict (de)serialisation are left to the
engines and subsystems that read them. ``MemoryEngine`` keeps node and
edge CRUD, ``all_nodes``, the adjacency reads and the synchronous storage
events (``node_created`` / ``node_updated`` / ``node_deleted`` and their
edge kinds) that ``SearchService.attach`` subscribes to. Label indexes,
the pending-embed index and the no-copy fast paths are not ported.

Pure Python and numpy: no device work happens here.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np

from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError

log = logging.getLogger(__name__)


def new_id() -> str:
    return str(uuid.uuid4())


def _now() -> float:
    return time.time()


@dataclass
class Node:
    """A graph node."""

    id: str = field(default_factory=new_id)
    labels: list[str] = field(default_factory=list)
    properties: dict[str, Any] = field(default_factory=dict)
    embedding: Optional[np.ndarray] = None
    access_count: int = 0
    created_at: float = field(default_factory=_now)
    updated_at: float = field(default_factory=_now)
    last_accessed: float = field(default_factory=_now)

    def copy(self) -> "Node":
        return Node(
            id=self.id,
            labels=list(self.labels),
            properties=dict(self.properties),
            embedding=None if self.embedding is None else np.array(self.embedding),
            access_count=self.access_count,
            created_at=self.created_at,
            updated_at=self.updated_at,
            last_accessed=self.last_accessed,
        )


@dataclass
class Edge:
    """A directed, typed relationship."""

    id: str = field(default_factory=new_id)
    start_node: str = ""
    end_node: str = ""
    type: str = "RELATED_TO"
    properties: dict[str, Any] = field(default_factory=dict)
    created_at: float = field(default_factory=_now)
    updated_at: float = field(default_factory=_now)

    def copy(self) -> "Edge":
        return Edge(
            id=self.id,
            start_node=self.start_node,
            end_node=self.end_node,
            type=self.type,
            properties=dict(self.properties),
            created_at=self.created_at,
            updated_at=self.updated_at,
        )


# event kinds fired by engines (search indexing subscribes to the node kinds)
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
        """Unsubscribe (anything shorter-lived than the engine)."""
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
            except Exception:  # noqa: BLE001 - a listener must not break the
                # write path, but a crashing index updater corrupts its own
                # view, so operators must see it
                log.warning("storage event listener failed on %s", kind,
                            exc_info=True)


class Engine(EventEmitter):
    """Abstract storage engine: the part of the reference's interface that
    the port uses.

    OWNERSHIP CONTRACT: every Node/Edge returned by a read or write method is
    a caller-owned fresh copy, never an object the engine retains."""

    # -- nodes -------------------------------------------------------------
    def create_node(self, node: Node) -> Node:
        raise NotImplementedError

    def get_node(self, node_id: str) -> Node:
        raise NotImplementedError

    def update_node(self, node: Node) -> Node:
        raise NotImplementedError

    def delete_node(self, node_id: str) -> None:
        raise NotImplementedError

    def all_nodes(self) -> Iterator[Node]:
        raise NotImplementedError

    # -- edges -------------------------------------------------------------
    def create_edge(self, edge: Edge) -> Edge:
        raise NotImplementedError

    def get_edge(self, edge_id: str) -> Edge:
        raise NotImplementedError

    def update_edge(self, edge: Edge) -> Edge:
        raise NotImplementedError

    def delete_edge(self, edge_id: str) -> None:
        raise NotImplementedError

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        raise NotImplementedError

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        raise NotImplementedError

    # -- counts ------------------------------------------------------------
    def node_count(self) -> int:
        raise NotImplementedError

    def edge_count(self) -> int:
        raise NotImplementedError


class MemoryEngine(Engine):
    """In-memory engine: the default engine of the tests and of the smoke
    run's hybrid search."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._edges: dict[str, Edge] = {}
        self._out: dict[str, set[str]] = {}
        self._in: dict[str, set[str]] = {}

    # -- nodes -------------------------------------------------------------
    def create_node(self, node: Node) -> Node:
        with self._lock:
            if node.id in self._nodes:
                raise AlreadyExistsError(f"node {node.id} already exists")
            stored = node.copy()
            self._nodes[stored.id] = stored
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
            self._nodes[stored.id] = stored
        self._emit(NODE_UPDATED, stored.copy())
        return stored.copy()

    def delete_node(self, node_id: str) -> None:
        with self._lock:
            n = self._nodes.pop(node_id, None)
            if n is None:
                raise NotFoundError(f"node {node_id} not found")
            # cascade: remove attached edges
            attached = list(self._out.get(node_id, set())
                            | self._in.get(node_id, set()))
            removed_edges = []
            for eid in attached:
                e = self._edges.pop(eid, None)
                if e is None:
                    continue
                self._out.get(e.start_node, set()).discard(eid)
                self._in.get(e.end_node, set()).discard(eid)
                removed_edges.append(e)
            self._out.pop(node_id, None)
            self._in.pop(node_id, None)
        for e in removed_edges:
            self._emit(EDGE_DELETED, e)
        self._emit(NODE_DELETED, n)

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
            self._edges[stored.id] = stored
        self._emit(EDGE_UPDATED, stored.copy())
        return stored.copy()

    def delete_edge(self, edge_id: str) -> None:
        with self._lock:
            e = self._edges.pop(edge_id, None)
            if e is None:
                raise NotFoundError(f"edge {edge_id} not found")
            self._out.get(e.start_node, set()).discard(edge_id)
            self._in.get(e.end_node, set()).discard(edge_id)
        self._emit(EDGE_DELETED, e)

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        with self._lock:
            ids = list(self._out.get(node_id, set()))
            return [self._edges[i].copy() for i in ids if i in self._edges]

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        with self._lock:
            ids = list(self._in.get(node_id, set()))
            return [self._edges[i].copy() for i in ids if i in self._edges]

    # -- counts ------------------------------------------------------------
    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def edge_count(self) -> int:
        with self._lock:
            return len(self._edges)
