"""Namespace-prefixing engine decorator for multi-database support.

Counterpart of ``nornicdb_tpu/storage/namespaced.py`` (the port keeps its
own copy and imports nothing of the JAX package).

Behavioral reference: the upstream NornicDB pkg/storage/namespaced.go — IDs are
stored as "<db>:<id>" in the shared base engine; the decorator strips/adds
the prefix transparently so each logical database sees bare IDs
(ref: pkg/multidb/manager.go:43, §9 of SURVEY.md).
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator, Optional

from nornicdb_tpu_torch.storage.types import Edge, Engine, Node


class NamespacedEngine(Engine):
    def __init__(self, base: Engine, namespace: str):
        super().__init__()
        self.base = base
        self.namespace = namespace
        self._prefix = namespace + ":"
        # event-maintained counts: node_count()/edge_count() were O(N) scans
        # that deep-copied every entity (every /graphql stats call, every
        # /status). Seeding must be exact even if a writer races engine
        # construction (multidb creates engines lazily in get_storage):
        # subscribe FIRST, buffer events by id while scanning, then
        # reconcile as id-sets — a mutation seen by both the scan and the
        # buffer lands once, one seen by neither cannot exist.
        self._count_lock = threading.Lock()
        self._seed_buffer: Optional[list[tuple[str, str]]] = []
        self._node_count = 0
        self._edge_count = 0
        base.on_event(self._forward_event)
        node_ids = {n.id for n in base.all_nodes()
                    if n.id.startswith(self._prefix)}
        edge_ids = {e.id for e in base.all_edges()
                    if e.id.startswith(self._prefix)}
        with self._count_lock:
            for kind, full_id in self._seed_buffer:
                target = node_ids if kind.startswith("node") else edge_ids
                if kind.endswith("_created"):
                    target.add(full_id)
                elif kind.endswith("_deleted"):
                    target.discard(full_id)
            self._seed_buffer = None
            self._node_count = len(node_ids)
            self._edge_count = len(edge_ids)

    # -- prefix helpers ----------------------------------------------------
    def _add(self, bare_id: str) -> str:
        return self._prefix + bare_id

    def _strip(self, full_id: str) -> str:
        if full_id.startswith(self._prefix):
            return full_id[len(self._prefix) :]
        return full_id

    def _owns(self, full_id: str) -> bool:
        return full_id.startswith(self._prefix)

    def _strip_node(self, n: Node) -> Node:
        """Copying strip — ONLY for shared objects (event entities go to
        every subscriber; mutating them would corrupt sibling namespaces)."""
        return self._restrip_node(n.copy())

    def _strip_edge(self, e: Edge) -> Edge:
        return self._restrip_edge(e.copy())

    def _restrip_node(self, n: Node) -> Node:
        """In-place strip for base-engine RETURN values: the Engine contract
        (pinned by test_storage_unit_depth deep-copy tests on both engines)
        makes those caller-owned fresh copies, so a second full copy here —
        embeddings included — was pure overhead. Profiled at ~1/3 of an
        uncached label-scan query's node copies."""
        n.id = self._strip(n.id)
        return n

    def _restrip_edge(self, e: Edge) -> Edge:
        e.id = self._strip(e.id)
        e.start_node = self._strip(e.start_node)
        e.end_node = self._strip(e.end_node)
        return e

    def _forward_event(self, kind: str, entity) -> None:
        if isinstance(entity, Node):
            if self._owns(entity.id):
                self._count_event(kind, entity.id, node=True)
                self._emit(kind, self._strip_node(entity))
        elif isinstance(entity, Edge):
            if self._owns(entity.id):
                self._count_event(kind, entity.id, node=False)
                self._emit(kind, self._strip_edge(entity))

    def _count_event(self, kind: str, full_id: str, node: bool) -> None:
        if not kind.endswith(("_created", "_deleted")):
            return
        with self._count_lock:
            if self._seed_buffer is not None:  # still scanning: defer
                self._seed_buffer.append((kind, full_id))
                return
            delta = 1 if kind.endswith("_created") else -1
            if node:
                self._node_count = max(0, self._node_count + delta)
            else:
                self._edge_count = max(0, self._edge_count + delta)

    # -- nodes -------------------------------------------------------------
    def create_node(self, node: Node) -> Node:
        stored = node.copy()
        stored.id = self._add(node.id)
        return self._restrip_node(self.base.create_node(stored))

    def get_node(self, node_id: str) -> Node:
        return self._restrip_node(self.base.get_node(self._add(node_id)))

    def update_node(self, node: Node) -> Node:
        stored = node.copy()
        stored.id = self._add(node.id)
        return self._restrip_node(self.base.update_node(stored))

    def delete_node(self, node_id: str) -> None:
        self.base.delete_node(self._add(node_id))

    def get_nodes_by_label(self, label: str) -> list[Node]:
        ids_fn = getattr(self.base, "node_ids_by_label", None)
        if ids_fn is not None:
            ids = ids_fn(label)
            owned = [i for i in ids if i.startswith(self._prefix)]
            if len(owned) < len(ids):
                # foreign namespaces share this label: fetch only ours —
                # the bulk scan would deep-copy their nodes (embeddings
                # included) just to discard them in the _owns filter
                return [self._restrip_node(n)
                        for n in self.base.batch_get_nodes(owned)]
        return [
            self._restrip_node(n)
            for n in self.base.get_nodes_by_label(label)
            if self._owns(n.id)
        ]

    def all_nodes(self) -> Iterator[Node]:
        return (self._restrip_node(n) for n in self.base.all_nodes() if self._owns(n.id))

    def all_node_ids(self) -> list[str]:
        """Id-only scan with prefix translation (see MemoryEngine
        .all_node_ids). Raises AttributeError when the base engine lacks
        it — callers probe and fall back to all_nodes."""
        return [self._strip(i) for i in self.base.all_node_ids()
                if self._owns(i)]

    def batch_get_nodes(self, ids: Iterable[str]) -> list[Node]:
        return [
            self._restrip_node(n)
            for n in self.base.batch_get_nodes(self._add(i) for i in ids)
        ]

    # -- edges -------------------------------------------------------------
    def create_edge(self, edge: Edge) -> Edge:
        stored = edge.copy()
        stored.id = self._add(edge.id)
        stored.start_node = self._add(edge.start_node)
        stored.end_node = self._add(edge.end_node)
        return self._restrip_edge(self.base.create_edge(stored))

    def get_edge(self, edge_id: str) -> Edge:
        return self._restrip_edge(self.base.get_edge(self._add(edge_id)))

    def update_edge(self, edge: Edge) -> Edge:
        stored = edge.copy()
        stored.id = self._add(edge.id)
        stored.start_node = self._add(edge.start_node)
        stored.end_node = self._add(edge.end_node)
        return self._restrip_edge(self.base.update_edge(stored))

    def delete_edge(self, edge_id: str) -> None:
        self.base.delete_edge(self._add(edge_id))

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        return [
            self._restrip_edge(e)
            for e in self.base.get_edges_by_type(edge_type)
            if self._owns(e.id)
        ]

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        return [
            self._restrip_edge(e) for e in self.base.get_outgoing_edges(self._add(node_id))
        ]

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        return [
            self._restrip_edge(e) for e in self.base.get_incoming_edges(self._add(node_id))
        ]

    def iter_adjacency(self, node_id: str, direction: str) -> list[tuple]:
        """No-copy adjacency (see MemoryEngine.iter_adjacency) with prefix
        translation. Raises AttributeError when the base engine has no
        fast adjacency — callers probe and fall back to edge accessors."""
        return [
            (self._strip(eid), t, self._strip(oid))
            for eid, t, oid in self.base.iter_adjacency(
                self._add(node_id), direction)
        ]

    def all_edges(self) -> Iterator[Edge]:
        return (self._restrip_edge(e) for e in self.base.all_edges() if self._owns(e.id))

    def count_nodes_by_label(self, label: str) -> int:
        ids_fn = getattr(self.base, "node_ids_by_label", None)
        if ids_fn is not None:
            # id-only membership scan: no per-node copies (the copying path
            # clones embedding arrays just to count)
            return sum(1 for i in ids_fn(label) if i.startswith(self._prefix))
        return sum(
            1 for n in self.base.get_nodes_by_label(label) if self._owns(n.id)
        )

    def count_edges_by_type(self, edge_type: str) -> int:
        return sum(
            1 for e in self.base.get_edges_by_type(edge_type) if self._owns(e.id)
        )

    # -- counts (namespace-scoped, seeded at construction, event-maintained)
    def node_count(self) -> int:
        return self._node_count

    def edge_count(self) -> int:
        return self._edge_count

    # -- pending embed -----------------------------------------------------
    def mark_pending_embed(self, node_id: str) -> None:
        self.base.mark_pending_embed(self._add(node_id))

    def unmark_pending_embed(self, node_id: str) -> None:
        self.base.unmark_pending_embed(self._add(node_id))

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        out = [
            self._strip(i)
            for i in self.base.pending_embed_ids(0)
            if self._owns(i)
        ]
        return out[:limit] if limit > 0 else out

    def flush(self) -> None:
        self.base.flush()

    def close(self) -> None:
        # shared base engine: owner (the DatabaseManager) closes it
        pass
