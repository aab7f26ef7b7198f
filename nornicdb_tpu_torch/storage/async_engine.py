"""Write-behind async engine decorator.

Counterpart of ``nornicdb_tpu/storage/async_engine.py`` (the port keeps its
own copy and imports nothing of the JAX package).

Behavioral reference: the upstream NornicDB pkg/storage/async_engine.go —
mutations buffer in an in-memory overlay and flush to the base engine on a
short interval (~50ms in the reference); reads consult the overlay first so
the engine is read-your-writes consistent; counts combine overlay + base
(the reference grew dedicated regression tests for that:
async_engine_count_flush_race_test.go, async_count_bug_test.go).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterable, Iterator, Optional

from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

log = logging.getLogger(__name__)

_FLUSH_HIST = _REGISTRY.histogram(
    "nornicdb_async_flush_seconds",
    "AsyncEngine overlay flush duration (only flushes that drained ops)",
)
_FLUSH_OPS = _REGISTRY.counter(
    "nornicdb_async_flush_ops_total",
    "Overlay operations drained to the base engine",
)

_TOMBSTONE = object()


class AsyncEngine(Engine):
    def __init__(self, base: Engine, flush_interval: float = 0.05):
        super().__init__()
        self.base = base
        self.flush_interval = flush_interval
        self._lock = threading.RLock()
        # overlay: id -> Node/Edge (pending upsert) or _TOMBSTONE (pending delete)
        self._nodes: dict[str, object] = {}
        self._edges: dict[str, object] = {}
        self._node_is_create: set[str] = set()
        self._edge_is_create: set[str] = set()
        self._flush_lock = threading.Lock()
        self._closed = False
        # trace hand-off across the flush hop: the FIRST writer into an
        # empty overlay becomes the batch leader — the (often background)
        # flush that drains the batch attaches that writer's span so
        # storage.flush lands in the originating request's trace
        self._flush_ctx = None
        # Creates/updates are emitted by THIS engine at write time; the base
        # engine's events for those same ops fire later at flush and would
        # double-notify listeners. Node deletes run directly against the
        # base (incl. edge cascades), so the base's events are
        # authoritative there. Edge deletes are emitted at write time too —
        # a tombstoned edge is already invisible to reads, and event-
        # maintained indexes (adjacency snapshot, namespaced counts) must
        # not serve it until flush — so the base's flush-time replay of the
        # same delete is suppressed by id. A create deleted before it ever
        # flushed never reaches the base at all; without the write-time
        # emit no listener would ever hear about its deletion.
        self._deleted_emitted: set[str] = set()
        base.on_event(self._forward_base_event)
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
        self._flusher.start()

    def _forward_base_event(self, kind: str, entity) -> None:
        if kind == "edge_deleted":
            with self._lock:
                if entity.id in self._deleted_emitted:
                    self._deleted_emitted.discard(entity.id)
                    return  # already announced at write time
            self._emit(kind, entity)
        elif kind == "node_deleted":
            self._emit(kind, entity)

    # -- flush loop --------------------------------------------------------
    def _flush_loop(self) -> None:
        stop = threading.Event()
        while not self._closed:
            stop.wait(self.flush_interval)
            try:
                self.flush()
            except Exception:
                # the loop must survive, but a failing flush means the
                # overlay is not draining — writes pile up silently
                log.warning("background flush failed; retrying next tick",
                            exc_info=True)

    def flush(self) -> None:
        """Drain the overlay into the base engine, preserving op order per id.

        Serialized: an explicit flush must not return while a background
        flush that already popped overlay entries is still applying them
        (counts would transiently miss those entries)."""
        with self._flush_lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        with self._lock:
            nodes = list(self._nodes.items())
            node_creates = set(self._node_is_create)
            edges = list(self._edges.items())
            edge_creates = set(self._edge_is_create)
            self._nodes.clear()
            self._edges.clear()
            self._node_is_create.clear()
            self._edge_is_create.clear()
            ctx, self._flush_ctx = self._flush_ctx, None
        n_ops = len(nodes) + len(edges)
        if n_ops == 0:
            # read-path flushes with an empty overlay are the common case;
            # recording them would drown the histogram in ~0 samples
            self.base.flush()
            return
        t0 = time.perf_counter()
        # the batch leader's trace (first writer into this overlay window)
        # adopts the flush — a background drain still shows up in the
        # request trace that caused it
        with _tracer.attach(ctx):
            with _tracer.span("storage.flush", {"ops": n_ops}):
                self._apply_ops(nodes, node_creates, edges, edge_creates)
                self.base.flush()
        _FLUSH_HIST.observe(time.perf_counter() - t0)
        _FLUSH_OPS.inc(n_ops)

    def _apply_ops(self, nodes, node_creates, edges, edge_creates) -> None:
        for nid, val in nodes:
            try:
                if val is _TOMBSTONE:
                    try:
                        self.base.delete_node(nid)
                    except NotFoundError:
                        pass
                elif nid in node_creates:
                    self.base.create_node(val)  # type: ignore[arg-type]
                else:
                    self.base.update_node(val)  # type: ignore[arg-type]
            except Exception:
                # the overlay entry is already popped: this node write is
                # LOST if we stay silent
                log.error("flush dropped node op for %s", nid, exc_info=True)
        for eid, val in edges:
            try:
                if val is _TOMBSTONE:
                    try:
                        self.base.delete_edge(eid)
                    except NotFoundError:
                        pass
                elif eid in edge_creates:
                    try:
                        self.base.create_edge(val)  # type: ignore[arg-type]
                    except AlreadyExistsError:
                        # this create overwrote a same-id tombstone in the
                        # overlay, so the delete never reached the base:
                        # apply as an update, not a lost write
                        self.base.update_edge(val)  # type: ignore[arg-type]
                else:
                    self.base.update_edge(val)  # type: ignore[arg-type]
            except Exception:
                # same contract as the node loop above: dropped == lost
                log.error("flush dropped edge op for %s", eid, exc_info=True)

    def _note_writer_locked(self) -> None:
        """First writer into an empty overlay claims flush-trace leadership
        (one contextvar read; None when the writer isn't traced)."""
        if self._flush_ctx is None:
            self._flush_ctx = _tracer.capture()

    # -- nodes -------------------------------------------------------------
    def create_node(self, node: Node) -> Node:
        with self._lock:
            existing = self._nodes.get(node.id)
            if existing is not None and existing is not _TOMBSTONE:
                raise AlreadyExistsError(f"node {node.id} already exists")
            if existing is None:
                try:
                    self.base.get_node(node.id)
                    raise AlreadyExistsError(f"node {node.id} already exists")
                except NotFoundError:
                    pass
            stored = node.copy()
            self._nodes[node.id] = stored
            self._node_is_create.add(node.id)
            self._note_writer_locked()
        self._emit("node_created", stored.copy())
        return stored.copy()

    def get_node(self, node_id: str) -> Node:
        with self._lock:
            val = self._nodes.get(node_id)
            if val is _TOMBSTONE:
                raise NotFoundError(f"node {node_id} not found")
            if val is not None:
                return val.copy()  # type: ignore[union-attr]
        try:
            return self.base.get_node(node_id)
        except NotFoundError:
            # a background flush may have popped the entry from the overlay
            # but not yet applied it to the base; retry once the in-flight
            # flush (if any) has drained
            with self._flush_lock:
                return self.base.get_node(node_id)

    def update_node(self, node: Node) -> Node:
        with self._lock:
            val = self._nodes.get(node.id)
            if val is _TOMBSTONE:
                raise NotFoundError(f"node {node.id} not found")
            if val is None:
                self.base.get_node(node.id)  # raises if absent
            stored = node.copy()
            was_create = node.id in self._node_is_create
            self._nodes[node.id] = stored
            if was_create:
                self._node_is_create.add(node.id)
            self._note_writer_locked()
        self._emit("node_updated", stored.copy())
        return stored.copy()

    def delete_node(self, node_id: str) -> None:
        # Node deletion cascades to attached edges in the base engine; a
        # tombstone overlay cannot mirror that cascade, so counts and edge
        # reads would go stale until flush (the class of bug behind the
        # reference's async_count_bug_test.go). Deletes are rare: flush and
        # delete synchronously.
        self.flush()
        self.base.delete_node(node_id)

    def get_nodes_by_label(self, label: str) -> list[Node]:
        self.flush()
        return self.base.get_nodes_by_label(label)

    def all_nodes(self) -> Iterator[Node]:
        self.flush()
        return self.base.all_nodes()

    def all_node_ids(self) -> list[str]:
        self.flush()
        return self.base.all_node_ids()  # AttributeError -> caller fallback

    # -- edges -------------------------------------------------------------
    def create_edge(self, edge: Edge) -> Edge:
        # Endpoint validation must see overlay nodes too.
        self.get_node(edge.start_node)
        self.get_node(edge.end_node)
        with self._lock:
            existing = self._edges.get(edge.id)
            if existing is not None and existing is not _TOMBSTONE:
                raise AlreadyExistsError(f"edge {edge.id} already exists")
            if existing is _TOMBSTONE:
                # the tombstone this create overwrites will never reach the
                # base, so its flush-replay suppression must not linger and
                # swallow a future genuine delete of this id
                self._deleted_emitted.discard(edge.id)
            stored = edge.copy()
            self._edges[edge.id] = stored
            self._edge_is_create.add(edge.id)
            self._note_writer_locked()
        self._emit("edge_created", stored.copy())
        return stored.copy()

    def get_edge(self, edge_id: str) -> Edge:
        with self._lock:
            val = self._edges.get(edge_id)
            if val is _TOMBSTONE:
                raise NotFoundError(f"edge {edge_id} not found")
            if val is not None:
                return val.copy()  # type: ignore[union-attr]
        return self.base.get_edge(edge_id)

    def update_edge(self, edge: Edge) -> Edge:
        with self._lock:
            val = self._edges.get(edge.id)
            if val is _TOMBSTONE:
                raise NotFoundError(f"edge {edge.id} not found")
            if val is None:
                self.base.get_edge(edge.id)
            stored = edge.copy()
            self._edges[edge.id] = stored
            self._note_writer_locked()
        self._emit("edge_updated", stored.copy())
        return stored.copy()

    def delete_edge(self, edge_id: str) -> None:
        try:
            self._delete_edge_once(edge_id)
        except NotFoundError:
            # a background flush may have popped the create from the overlay
            # but not yet applied it to the base (same window get_node
            # handles); drain the in-flight flush OUTSIDE self._lock —
            # flush takes _flush_lock then _lock — and retry once
            with self._flush_lock:
                pass
            self._delete_edge_once(edge_id)

    def _delete_edge_once(self, edge_id: str) -> None:
        with self._lock:
            val = self._edges.get(edge_id)
            if val is _TOMBSTONE:
                raise NotFoundError(f"edge {edge_id} not found")
            entity = val.copy() if val is not None else self.base.get_edge(edge_id)
            if edge_id in self._edge_is_create:
                self._edges.pop(edge_id, None)
                self._edge_is_create.discard(edge_id)
            else:
                self._edges[edge_id] = _TOMBSTONE
                # the base replays this delete at flush; don't notify twice
                self._deleted_emitted.add(edge_id)
                self._note_writer_locked()
        self._emit("edge_deleted", entity)

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        self.flush()
        return self.base.get_edges_by_type(edge_type)

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        self.flush()
        return self.base.get_outgoing_edges(node_id)

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        self.flush()
        return self.base.get_incoming_edges(node_id)

    def all_edges(self) -> Iterator[Edge]:
        self.flush()
        return self.base.all_edges()

    # -- counts: overlay-aware (ref: async_count_bug_test.go). The flush
    # lock keeps the popped-but-not-yet-applied window out of the count.
    def node_count(self) -> int:
        with self._flush_lock:
            with self._lock:
                delta = 0
                for nid, val in self._nodes.items():
                    if val is _TOMBSTONE:
                        delta -= 1
                    elif nid in self._node_is_create:
                        delta += 1
            return self.base.node_count() + delta

    def edge_count(self) -> int:
        with self._flush_lock:
            with self._lock:
                delta = 0
                for eid, val in self._edges.items():
                    if val is _TOMBSTONE:
                        delta -= 1
                    elif eid in self._edge_is_create:
                        delta += 1
            return self.base.edge_count() + delta

    def count_nodes_by_label(self, label: str) -> int:
        self.flush()
        return self.base.count_nodes_by_label(label)

    def count_edges_by_type(self, edge_type: str) -> int:
        self.flush()
        return self.base.count_edges_by_type(edge_type)

    # -- pending embed -----------------------------------------------------
    def mark_pending_embed(self, node_id: str) -> None:
        self.flush()
        self.base.mark_pending_embed(node_id)

    def unmark_pending_embed(self, node_id: str) -> None:
        self.base.unmark_pending_embed(node_id)

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        return self.base.pending_embed_ids(limit)

    def close(self) -> None:
        self._closed = True
        self.flush()
        self.base.close()
