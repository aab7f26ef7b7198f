"""Shared CSR adjacency snapshot: one event-maintained topology index.

Counterpart of ``nornicdb_tpu/storage/adjacency.py`` (the port keeps its own
copy and imports nothing of the JAX package).

Traversal hot paths used to pay Python-per-edge costs on every query:
GDS procedures rebuilt (src, dst) arrays from a full `all_edges()` scan per
call, variable-length MATCH / shortestPath BFS expanded one node at a time
through engine calls, and link prediction ran yet another full scan. This
module keeps the graph's topology resident as CSR arrays — int32
`offsets` / `neighbors` / `edge_rows` per direction plus per-edge
src/dst/type columns and the id<->index vocab — maintained incrementally
from the engine event bus (EDGE_CREATED/UPDATED/DELETED, NODE_CREATED/
DELETED), the same mechanism the columnar label index (cypher/colindex.py)
and NamespacedEngine counts use. After the first build there is never a
full engine rescan on the query path: mutations land in a delta buffer
(O(1) per event) that merges into the CSR arrays only when it exceeds a
threshold, and consumers cache derived views keyed on the snapshot
generation.

Concurrency contract (mirrors colindex.py, verified by nornsan):
the snapshot lock is never held across engine calls — the event handler
touches only snapshot state, and builds fetch from the engine *before*
taking the lock. A build is epoch-validated: if any topology event lands
during the snapshot scan, the build is discarded and retried; on repeated
interference the caller falls back to the engine-scan path for that query.

Index stability: node indices are append-only for the lifetime of the
snapshot (deleted nodes keep a dead vocab slot), so a traversal may hold
node indices across delta merges. Edge rows are renumbered by merges, so
expansion APIs hand back edge *ids*, resolved under the lock.

Known limitation (shared with every consumer of this event bus —
colindex, NamespacedEngine counts): engines emit events after releasing
their lock, so two threads racing create/delete of the SAME edge id can
deliver the events inverted relative to the engine mutations. Healing
this per-query is not an option — engine calls under the snapshot lock
are forbidden (AsyncEngine.edge_count takes its flush lock, whose holder
emits events into this handler: a guaranteed AB/BA deadlock) — and the
window requires a second thread to learn an edge id between another
writer's insert and its emit, which Cypher surfaces don't do.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Iterable, Optional

import numpy as np

from nornicdb_tpu_torch.storage.types import (
    EDGE_CREATED,
    EDGE_DELETED,
    EDGE_UPDATED,
    NODE_CREATED,
    NODE_DELETED,
    Edge,
    Node,
)
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

log = logging.getLogger(__name__)

_ADJ_HIST = _REGISTRY.histogram(
    "nornicdb_adjacency_maintenance_seconds",
    "CSR snapshot maintenance duration by phase (build / delta merge)",
    labels=("phase",),
)
_ADJ_BUILD_CELL = _ADJ_HIST.labels("build")
_ADJ_MERGE_CELL = _ADJ_HIST.labels("merge")

_EDGE_EVENTS = (EDGE_CREATED, EDGE_UPDATED, EDGE_DELETED)
_NODE_EVENTS = (NODE_CREATED, NODE_DELETED)

# delta events buffered before they are folded into the CSR arrays
# (docs/operations.md "Adjacency snapshot tuning")
DEFAULT_MERGE_THRESHOLD = 4096

# csr_view() fold economics: graphs at or under the eager floor always
# fold pending delta adds before serving (the rebuild is cheap); larger
# graphs wait for VIEW_FOLD_MIN_PENDING buffered events so a trickle of
# single writes can't force an O(m log m) rank rebuild per read — interim
# reads serve generically through the matcher's delta overlay instead
VIEW_FOLD_EAGER_EDGES = 32_768
VIEW_FOLD_MIN_PENDING = 512

_attach_lock = threading.Lock()


def _gather_csr(off, nbr, rows, row_alive, row_type, n_csr, arr, codes):
    """One batched gather over frontier `arr` for one CSR direction:
    (heads, rows, neighbor_idx) with tombstoned rows and non-matching type
    codes filtered out. Pure array math over a consistent set of refs —
    callers either hold the snapshot lock or captured the refs under it
    (merges replace these arrays, never resize them in place)."""
    arr = arr[arr < n_csr]
    empty = np.zeros(0, np.int64)
    if not arr.size:
        return empty, empty, empty
    starts = off[arr].astype(np.int64)
    cnts = (off[arr + 1] - off[arr]).astype(np.int64)
    total = int(cnts.sum())
    if not total:
        return empty, empty, empty
    shift = np.repeat(np.cumsum(cnts) - cnts, cnts)
    g = np.repeat(starts, cnts) + np.arange(total) - shift
    heads = np.repeat(arr, cnts)
    r = rows[g]
    keep = row_alive[r]
    if codes is not None:
        keep = keep & np.isin(row_type[r], codes)
    sel = np.nonzero(keep)[0]
    return heads[sel], r[sel].astype(np.int64), nbr[g[sel]].astype(np.int64)


def attach_snapshot(storage, merge_threshold: Optional[int] = None):
    """The engine's shared snapshot, created on first request.

    One snapshot per engine object: matcher, GDS procedures, and link
    prediction all subscribe through the same instance, so one build and
    one event-maintained index serve every consumer. An explicit
    merge_threshold re-tunes an already-attached snapshot (consumers
    auto-attach with the default, so the operator's later setting must
    not be silently dropped)."""
    snap = getattr(storage, "_adjacency_snapshot", None)
    if snap is None:
        with _attach_lock:
            snap = getattr(storage, "_adjacency_snapshot", None)
            if snap is None:
                snap = AdjacencySnapshot(
                    storage,
                    merge_threshold=merge_threshold
                    if merge_threshold is not None
                    else DEFAULT_MERGE_THRESHOLD)
                storage._adjacency_snapshot = snap
                return snap
    if merge_threshold is not None:
        snap.merge_threshold = max(int(merge_threshold), 1)
    return snap


class CSRView:
    """Generation-pinned capture of the merged CSR arrays for the columnar
    Cypher pipeline (cypher/columnar.py).  Built under the snapshot lock
    with the delta buffer folded first, so a view needs no overlay logic:
    the CSR arrays alone answer every expansion.  Arrays are replaced —
    never resized — by later merges, so holding a view across a query is
    safe; ``row_alive``/``node_alive`` are copies pinned at capture (a
    concurrent delete must not tear a half-executed operator pipeline).

    ``erow_rank[r]`` is the dense rank of edge row ``r`` in edge-ID-sorted
    order — expansions order each frontier node's edges by this integer
    instead of sorting edge-id strings per query (the generic matcher's
    per-edge ``sort()`` contract at array speed)."""

    __slots__ = ("generation", "n_csr", "ids", "node_alive", "row_alive",
                 "erow_type", "erow_rank", "row_ids", "type_code", "eprops",
                 "_csr")

    def __init__(self, generation, n_csr, ids, node_alive, row_alive,
                 erow_type, erow_rank, row_ids, type_code, eprops, csr):
        self.generation = generation
        self.n_csr = n_csr
        self.ids = ids              # vocab list ref (append-only)
        self.node_alive = node_alive
        self.row_alive = row_alive
        self.erow_type = erow_type
        self.erow_rank = erow_rank
        self.row_ids = row_ids      # row -> edge id (list ref; replaced by merges)
        self.type_code = type_code  # name -> code (copy)
        self.eprops = eprops        # key -> row-aligned column (list refs)
        self._csr = csr             # {"out": (off, nbr, rows), "in": ...}

    def edge_prop_column(self, key: str):
        """Row-aligned edge property column, or None when the key was never
        present on any edge at capture (callers synthesize all-null).  The
        list is shared with the snapshot: in-place property updates are
        visible until the next merge replaces it — the same mid-query
        read-latest semantics the node colindex columns have."""
        return self.eprops.get(key)

    def codes_for(self, types) -> Optional[list[int]]:
        """Codes for a rel-type filter; None = no filter. An empty list
        means the types were never seen on any edge (matches nothing)."""
        if not types:
            return None
        return [c for t in types if (c := self.type_code.get(t)) is not None]

    def expand_unique(
        self, uniq: np.ndarray, direction: str,
        codes: Optional[list[int]],
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched expansion of a SORTED array of unique node indices.

        Returns ``(counts, rows, nbrs)``: ``counts[i]`` edges for
        ``uniq[i]``, with the flat ``rows``/``nbrs`` arrays segmented per
        unique node and each segment ordered by edge id (via erow_rank) —
        the order the generic matcher's per-node expansion produces.
        Edges to dead neighbor nodes are dropped (the generic walk skips
        them at get_node time)."""
        dirs = (("out",) if direction == "out"
                else ("in",) if direction == "in" else ("out", "in"))
        h_parts, r_parts, n_parts = [], [], []
        for d in dirs:
            off, nbr, rows = self._csr[d]
            h, r, nb = _gather_csr(off, nbr, rows, self.row_alive,
                                   self.erow_type, self.n_csr, uniq, codes)
            if h.size:
                h_parts.append(h)
                r_parts.append(r)
                n_parts.append(nb)
        zero = np.zeros(len(uniq), np.int64)
        if not h_parts:
            empty = np.zeros(0, np.int64)
            return zero, empty, empty
        heads = np.concatenate(h_parts)
        rows = np.concatenate(r_parts)
        nbrs = np.concatenate(n_parts)
        keep = self.node_alive[nbrs]
        if not keep.all():
            sel = np.nonzero(keep)[0]
            heads, rows, nbrs = heads[sel], rows[sel], nbrs[sel]
        if not heads.size:
            empty = np.zeros(0, np.int64)
            return zero, empty, empty
        pos = np.searchsorted(uniq, heads)
        order = np.lexsort((self.erow_rank[rows], pos))
        pos = pos[order]
        counts = np.bincount(pos, minlength=len(uniq)).astype(np.int64)
        return counts, rows[order], nbrs[order]


class EdgeArraysView:
    """Sorted-id projection of the snapshot for array-native consumers
    (GDS procedures, link prediction). Arrays are immutable by contract —
    consumers may hold them across queries; the snapshot replaces (never
    mutates) the cached view when the generation moves."""

    __slots__ = ("ids", "index", "src", "dst", "type_codes", "type_names",
                 "generation")

    def __init__(self, ids, index, src, dst, type_codes, type_names,
                 generation):
        self.ids = ids
        self.index = index
        self.src = src
        self.dst = dst
        self.type_codes = type_codes
        self.type_names = type_names
        self.generation = generation


class SnapshotStats:
    """Counters in the corpus SyncStats style (ops/similarity.py)."""

    __slots__ = ("builds", "epoch_retries", "delta_merges", "merged_edges",
                 "delta_events", "expansions")

    def __init__(self) -> None:
        self.builds = 0
        self.epoch_retries = 0
        self.delta_merges = 0
        self.merged_edges = 0
        self.delta_events = 0
        self.expansions = 0


class AdjacencySnapshot:
    def __init__(self, storage,
                 merge_threshold: int = DEFAULT_MERGE_THRESHOLD):
        self.storage = storage
        self.merge_threshold = max(int(merge_threshold), 1)
        self._lock = threading.RLock()
        self.stats = SnapshotStats()
        self._built = False
        self._epoch = 0       # bumped per topology event; validates builds
        self._generation = 0  # bumped per applied topology change
        # -- node vocab (append-only indices; dead slots are kept) ---------
        self._ids: list[str] = []
        self._idx: dict[str, int] = {}
        self._alive: list[bool] = []
        self._alive_count = 0
        # -- edge-type vocab (append-only codes) ---------------------------
        self._type_names: list[str] = []
        self._type_code: dict[str, int] = {}
        # -- canonical CSR state (rebuilt by _merge_locked) ----------------
        self._n_csr = 0  # vocab size the CSR offsets were built for
        self._m = 0      # canonical edge rows
        self._erow_src = np.zeros(0, np.int32)
        self._erow_dst = np.zeros(0, np.int32)
        self._erow_type = np.zeros(0, np.int32)
        self._row_ids: list[str] = []
        self._row_of: dict[str, int] = {}
        self._row_alive = np.zeros(0, bool)
        # row-aligned edge property columns (key -> list, length _m); the
        # columnar pipeline's edge-prop filters/aggregates read these via
        # CSRView.edge_prop_column instead of per-row get_edge fetches
        self._eprops: dict[str, list] = {}
        self._tombstones = 0
        self._out_off = np.zeros(1, np.int32)
        self._out_nbr = np.zeros(0, np.int32)
        self._out_rows = np.zeros(0, np.int32)
        self._in_off = np.zeros(1, np.int32)
        self._in_nbr = np.zeros(0, np.int32)
        self._in_rows = np.zeros(0, np.int32)
        # -- delta buffer (edges since last merge; rows >= _m) -------------
        self._d_ids: list[str] = []
        self._d_src: list[int] = []
        self._d_dst: list[int] = []
        self._d_type: list[int] = []
        self._d_alive: list[bool] = []
        self._d_props: list[Optional[dict]] = []
        self._d_out: dict[int, list[int]] = {}
        self._d_in: dict[int, list[int]] = {}
        self._pending = 0  # delta events since last merge (adds + removes)
        # -- generation-tagged derived views -------------------------------
        self._view_cache: Optional[EdgeArraysView] = None
        self._graph_cache: dict[Any, tuple[int, Any]] = {}
        # columnar-pipeline view cache: the CSRView itself is keyed on
        # generation; the edge-id rank array on the _row_ids list identity
        # (merges replace the list, everything else leaves it alone)
        self._csr_view: Optional[CSRView] = None
        self._rank_src: Optional[list] = None
        self._rank_arr: Optional[np.ndarray] = None
        storage.on_event(self._on_event)

    # -- event handler (writer threads; touches ONLY snapshot state) -------
    def _on_event(self, kind: str, entity: Any) -> None:
        if kind in _EDGE_EVENTS:
            if not isinstance(entity, Edge):
                return
            with self._lock:
                self._epoch += 1
                if not self._built:
                    return
                if kind == EDGE_CREATED:
                    self._add_edge_locked(entity.id, entity.start_node,
                                          entity.end_node, entity.type,
                                          entity.properties)
                elif kind == EDGE_DELETED:
                    self._remove_edge_locked(entity.id)
                else:  # EDGE_UPDATED: re-link only if topology changed
                    self._update_edge_locked(entity)
        elif kind in _NODE_EVENTS:
            if not isinstance(entity, Node):
                return
            with self._lock:
                self._epoch += 1
                if not self._built:
                    return
                if kind == NODE_CREATED:
                    self._intern_node_locked(entity.id, resurrect=True)
                    self._generation += 1
                    self._view_cache = None
                else:
                    i = self._idx.get(entity.id)
                    if i is not None and self._alive[i]:
                        self._alive[i] = False
                        self._alive_count -= 1
                        self._generation += 1
                        self._view_cache = None

    # -- locked mutators ----------------------------------------------------
    def _intern_node_locked(self, node_id: str, resurrect: bool = False) -> int:
        i = self._idx.get(node_id)
        if i is None:
            i = len(self._ids)
            self._ids.append(node_id)
            self._idx[node_id] = i
            self._alive.append(True)
            self._alive_count += 1
        elif resurrect and not self._alive[i]:
            self._alive[i] = True
            self._alive_count += 1
        return i

    def _type_code_locked(self, name: str) -> int:
        c = self._type_code.get(name)
        if c is None:
            c = len(self._type_names)
            self._type_names.append(name)
            self._type_code[name] = c
        return c

    def _add_edge_locked(self, eid: str, src_id: str, dst_id: str,
                         type_name: str,
                         props: Optional[dict] = None) -> None:
        row = self._row_of.get(eid)
        if row is not None and self._edge_alive_locked(row):
            return  # duplicate create event
        s = self._intern_node_locked(src_id)
        d = self._intern_node_locked(dst_id)
        t = self._type_code_locked(type_name)
        j = len(self._d_ids)
        self._d_ids.append(eid)
        self._d_src.append(s)
        self._d_dst.append(d)
        self._d_type.append(t)
        self._d_alive.append(True)
        self._d_props.append(dict(props) if props else None)
        self._d_out.setdefault(s, []).append(j)
        self._d_in.setdefault(d, []).append(j)
        self._row_of[eid] = self._m + j
        self._pending += 1
        self.stats.delta_events += 1
        self._generation += 1
        self._view_cache = None

    def _remove_edge_locked(self, eid: str) -> None:
        row = self._row_of.get(eid)
        if row is None:
            return
        if row < self._m:
            if self._row_alive[row]:
                self._row_alive[row] = False
                self._tombstones += 1
                self._pending += 1
                self.stats.delta_events += 1
                self._generation += 1
                self._view_cache = None
            self._row_of.pop(eid, None)
        else:
            j = row - self._m
            if self._d_alive[j]:
                self._d_alive[j] = False
                self._pending += 1
                self.stats.delta_events += 1
                self._generation += 1
                self._view_cache = None
            self._row_of.pop(eid, None)

    def _edge_alive_locked(self, row: int) -> bool:
        if row < self._m:
            return bool(self._row_alive[row])
        return self._d_alive[row - self._m]

    def _edge_record_locked(self, row: int) -> tuple[int, int, int]:
        if row < self._m:
            return (int(self._erow_src[row]), int(self._erow_dst[row]),
                    int(self._erow_type[row]))
        j = row - self._m
        return (self._d_src[j], self._d_dst[j], self._d_type[j])

    def _update_edge_locked(self, edge: Edge) -> None:
        row = self._row_of.get(edge.id)
        if row is None or not self._edge_alive_locked(row):
            # update for an edge we never saw created: treat as add
            self._add_edge_locked(edge.id, edge.start_node, edge.end_node,
                                  edge.type, edge.properties)
            return
        s, d, t = self._edge_record_locked(row)
        ns = self._idx.get(edge.start_node)
        nd = self._idx.get(edge.end_node)
        nt = self._type_code.get(edge.type)
        if (ns, nd, nt) == (s, d, t):
            # property-only update: topology unchanged, refresh columns
            self._set_edge_props_locked(row, edge.properties)
            return
        self._remove_edge_locked(edge.id)
        self._add_edge_locked(edge.id, edge.start_node, edge.end_node,
                              edge.type, edge.properties)

    def _set_edge_props_locked(self, row: int, props: dict) -> None:
        """Overwrite an alive edge row's property columns in place (keys
        absent from ``props`` are cleared — update replaces the map)."""
        if row >= self._m:
            self._d_props[row - self._m] = dict(props) if props else None
            return
        for k, col in self._eprops.items():
            col[row] = props.get(k) if props else None
        if props:
            for k, v in props.items():
                if k not in self._eprops:
                    col = [None] * self._m
                    col[row] = v
                    self._eprops[k] = col
                    # a brand-new key isn't in the cached view's shallow
                    # column dict: drop the view so the next capture sees it
                    self._csr_view = None

    # -- build / merge ------------------------------------------------------
    def ready(self) -> bool:
        """Built and usable, without triggering a build."""
        with self._lock:
            return self._built

    def ensure(self) -> bool:
        """Build on first use (epoch-validated), fold the delta buffer into
        the CSR arrays when it exceeds the threshold. Returns False only
        when racing writers defeated every build attempt — callers fall
        back to the engine-scan path for that query."""
        with self._lock:
            if self._built:
                if self._pending > self.merge_threshold:
                    self._merge_locked()
                return True
        for _ in range(3):
            with self._lock:
                epoch0 = self._epoch
            node_ids = self._scan_node_ids()
            edges = [(e.id, e.start_node, e.end_node, e.type,
                      e.properties or None)
                     for e in self.storage.all_edges()]
            with self._lock:
                if self._built:
                    return True
                if self._epoch != epoch0:
                    self.stats.epoch_retries += 1
                    continue
                self._install_locked(node_ids, edges)
                return True
        return False

    def _scan_node_ids(self) -> list[str]:
        ids_fn = getattr(self.storage, "all_node_ids", None)
        if ids_fn is not None:
            try:
                return list(ids_fn())
            except AttributeError:
                # decorator engine whose base lacks the id-only scan
                pass
        return [n.id for n in self.storage.all_nodes()]

    def _install_locked(self, node_ids: list[str],
                        edges: list[tuple]) -> None:
        t0 = time.perf_counter()
        with _tracer.span("adjacency.build",
                          {"nodes": len(node_ids), "edges": len(edges)}):
            self._install_locked_inner(node_ids, edges)
        _ADJ_BUILD_CELL.observe(time.perf_counter() - t0)

    def _install_locked_inner(self, node_ids: list[str],
                              edges: list[tuple]) -> None:
        self._ids = list(node_ids)
        self._idx = {id_: i for i, id_ in enumerate(self._ids)}
        self._alive = [True] * len(self._ids)
        self._alive_count = len(self._ids)
        m = len(edges)
        src = np.zeros(m, np.int32)
        dst = np.zeros(m, np.int32)
        typ = np.zeros(m, np.int32)
        self._row_ids = [""] * m
        self._row_of = {}
        eprops: dict[str, list] = {}
        for r, (eid, s_id, d_id, t_name, props) in enumerate(edges):
            src[r] = self._intern_node_locked(s_id)
            dst[r] = self._intern_node_locked(d_id)
            typ[r] = self._type_code_locked(t_name)
            self._row_ids[r] = eid
            self._row_of[eid] = r
            if props:
                for k, v in props.items():
                    col = eprops.get(k)
                    if col is None:
                        col = eprops[k] = [None] * m
                    col[r] = v
        self._erow_src, self._erow_dst, self._erow_type = src, dst, typ
        self._eprops = eprops
        self._m = m
        self._row_alive = np.ones(m, bool)
        self._tombstones = 0
        self._clear_delta_locked()
        self._rebuild_csr_locked()
        self._built = True
        self.stats.builds += 1
        self._generation += 1
        self._view_cache = None

    def _clear_delta_locked(self) -> None:
        self._d_ids = []
        self._d_src = []
        self._d_dst = []
        self._d_type = []
        self._d_alive = []
        self._d_props = []
        self._d_out = {}
        self._d_in = {}
        self._pending = 0

    def _rebuild_csr_locked(self) -> None:
        n = len(self._ids)
        self._n_csr = n
        rows = np.arange(self._m, dtype=np.int32)
        for direction in ("out", "in"):
            key = self._erow_src if direction == "out" else self._erow_dst
            nbr = self._erow_dst if direction == "out" else self._erow_src
            order = np.argsort(key, kind="stable")
            counts = np.bincount(key, minlength=n) if self._m else \
                np.zeros(n, np.int64)
            off = np.zeros(n + 1, np.int32)
            off[1:] = np.cumsum(counts).astype(np.int32)
            if direction == "out":
                self._out_off = off
                self._out_nbr = nbr[order]
                self._out_rows = rows[order]
            else:
                self._in_off = off
                self._in_nbr = nbr[order]
                self._in_rows = rows[order]

    def _merge_locked(self) -> None:
        """Fold tombstones + delta adds into fresh canonical arrays. Node
        indices are preserved (vocab is append-only); edge rows renumber."""
        t0 = time.perf_counter()
        with _tracer.span("adjacency.merge", {"pending": self._pending}):
            self._merge_locked_inner()
        _ADJ_MERGE_CELL.observe(time.perf_counter() - t0)

    def _merge_locked_inner(self) -> None:
        keep = np.nonzero(self._row_alive)[0]
        d_keep = [j for j, a in enumerate(self._d_alive) if a]
        merged = len(d_keep) + self._tombstones
        src = np.concatenate([
            self._erow_src[keep],
            np.asarray([self._d_src[j] for j in d_keep], np.int32),
        ]).astype(np.int32)
        dst = np.concatenate([
            self._erow_dst[keep],
            np.asarray([self._d_dst[j] for j in d_keep], np.int32),
        ]).astype(np.int32)
        typ = np.concatenate([
            self._erow_type[keep],
            np.asarray([self._d_type[j] for j in d_keep], np.int32),
        ]).astype(np.int32)
        keep_l = keep.tolist()
        row_ids = [self._row_ids[r] for r in keep_l]
        row_ids += [self._d_ids[j] for j in d_keep]
        # re-gather property columns in the same keep + delta order (fresh
        # lists: views pinned pre-merge keep reading their own copies)
        keys = set(self._eprops)
        for j in d_keep:
            p = self._d_props[j]
            if p:
                keys.update(p)
        eprops: dict[str, list] = {}
        for k in keys:
            old = self._eprops.get(k)
            col = ([old[r] for r in keep_l] if old is not None
                   else [None] * len(keep_l))
            for j in d_keep:
                p = self._d_props[j]
                col.append(p.get(k) if p else None)
            eprops[k] = col
        self._erow_src, self._erow_dst, self._erow_type = src, dst, typ
        self._eprops = eprops
        self._row_ids = row_ids
        self._row_of = {eid: r for r, eid in enumerate(row_ids)}
        self._m = len(row_ids)
        self._row_alive = np.ones(self._m, bool)
        self._tombstones = 0
        self._clear_delta_locked()
        self._rebuild_csr_locked()
        self.stats.delta_merges += 1
        self.stats.merged_edges += merged

    # -- vocab --------------------------------------------------------------
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def index_of(self, node_id: str) -> Optional[int]:
        with self._lock:
            i = self._idx.get(node_id)
            if i is None or not self._alive[i]:
                return None
            return i

    def id_of(self, idx: int) -> str:
        with self._lock:
            return self._ids[idx]

    def ids_of(self, idxs: Iterable[int]) -> list[str]:
        with self._lock:
            ids = self._ids
            return [ids[i] for i in idxs]

    def type_codes(self, types) -> Optional[list[int]]:
        """Codes for a rel-type filter; None means no filter. Types never
        seen on any edge resolve to nothing — expansions are empty."""
        if not types:
            return None
        with self._lock:
            return [c for t in types
                    if (c := self._type_code.get(t)) is not None]

    # -- expansion ----------------------------------------------------------
    def expand_pairs(self, node_id: str, direction: str,
                     types=None) -> Optional[list[tuple[str, str]]]:
        """(edge_id, other_node_id) pairs, sorted — the matcher `_expand`
        contract. None when the node is unknown to the snapshot (caller
        falls back to the engine path)."""
        idx = self.index_of(node_id)
        if idx is None:
            return None
        codes = self.type_codes(types)
        if types and not codes:
            return []
        adj = self.expand_frontier([idx], direction, codes)
        with self._lock:
            ids = self._ids
            out = [(eid, ids[o]) for eid, o in adj.get(idx, ())]
        out.sort()
        return out

    def _maybe_merge_locked(self) -> None:
        """Fold an over-threshold delta before serving a read — EVERY read
        entry point calls this, so the overlay stays bounded even for
        workloads whose queries never go through ensure()."""
        if self._built and self._pending > self.merge_threshold:
            self._merge_locked()

    def _gather_csr_locked(
        self, direction: str, arr: np.ndarray,
        codes: Optional[list[int]],
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if direction == "out":
            off, nbr, rows = self._out_off, self._out_nbr, self._out_rows
        else:
            off, nbr, rows = self._in_off, self._in_nbr, self._in_rows
        return _gather_csr(off, nbr, rows, self._row_alive, self._erow_type,
                           self._n_csr, arr, codes)

    def _delta_neighbors_locked(self, direction: str, idx: int,
                                code_set: Optional[set]
                                ) -> Iterable[tuple[str, int]]:
        dmap = self._d_out if direction == "out" else self._d_in
        for j in dmap.get(idx, ()):
            if not self._d_alive[j]:
                continue
            if code_set is not None and self._d_type[j] not in code_set:
                continue
            yield (self._d_ids[j],
                   self._d_dst[j] if direction == "out" else self._d_src[j])

    def expand_frontier(
        self, idxs: list[int], direction: str,
        codes: Optional[list[int]] = None,
    ) -> dict[int, list[tuple[str, int]]]:
        """Batched CSR expansion: one gather over the frontier instead of
        one engine call per node. Returns idx -> [(edge_id, other_idx)],
        each list sorted by edge id (the order the generic matcher's
        per-edge sort produces)."""
        dirs = (("out",) if direction == "out"
                else ("in",) if direction == "in" else ("out", "in"))
        out: dict[int, list[tuple[str, int]]] = {i: [] for i in idxs}
        gathered = []
        # Lock only for the array gathers and the (threshold-bounded) delta
        # extraction; the per-edge Python tuple building runs outside so a
        # large frontier level never stalls writers' event handlers.
        # `_row_ids` is replaced (never mutated) by merges, so the captured
        # list stays aligned with the gathered row indices.
        with self._lock:
            self._maybe_merge_locked()
            self.stats.expansions += 1
            arr_all = np.fromiter(idxs, np.int64, len(idxs))
            code_set = None if codes is None else set(codes)
            row_ids = self._row_ids
            for d in dirs:
                heads, r, nb = self._gather_csr_locked(d, arr_all, codes)
                deltas = None
                if self._d_out or self._d_in:
                    deltas = {
                        i: list(self._delta_neighbors_locked(d, i, code_set))
                        for i in idxs
                    }
                gathered.append((heads, r, nb, deltas))
        for heads, r, nb, deltas in gathered:
            for k in range(heads.size):
                out[int(heads[k])].append((row_ids[int(r[k])], int(nb[k])))
            if deltas:
                for i, pairs in deltas.items():
                    out[i].extend(pairs)
        for lst in out.values():
            lst.sort()
        return out

    def bfs_distances(self, start_id: str, direction: str = "both",
                      types=None) -> Optional[np.ndarray]:
        """Frontier-batched BFS over the CSR arrays: hop distance per node
        index (-1 unreached). The whole loop is numpy gathers + dedup —
        no per-node engine calls, no per-edge Python."""
        start = self.index_of(start_id)
        if start is None:
            return None
        codes = self.type_codes(types)
        if types and not codes:
            codes = [-1]  # matches nothing
        dirs = (("out",) if direction == "out"
                else ("in",) if direction == "in" else ("out", "in"))
        # Capture a consistent view under the lock, then run the whole BFS
        # outside it: a multi-level walk over a big component must not
        # stall every writer's event handler for its full duration. The
        # CSR arrays are replaced (never resized) by merges; row_alive is
        # COPIED because tombstones flip it in place — the copy pins one
        # graph state for the whole walk instead of tearing mid-level.
        # The delta overlay is copied out while bounded by merge_threshold.
        with self._lock:
            self._maybe_merge_locked()
            n = len(self._ids)
            n_csr = self._n_csr
            row_alive, row_type = self._row_alive.copy(), self._erow_type
            csr = {"out": (self._out_off, self._out_nbr, self._out_rows),
                   "in": (self._in_off, self._in_nbr, self._in_rows)}
            code_set = None if codes is None else set(codes)
            delta: dict[str, dict[int, list[int]]] = {d: {} for d in dirs}
            for d in dirs:
                dmap = self._d_out if d == "out" else self._d_in
                for i in dmap:
                    others = [o for _eid, o in
                              self._delta_neighbors_locked(d, i, code_set)]
                    if others:
                        delta[d][i] = others
        dist = np.full(n, -1, np.int32)
        dist[start] = 0
        frontier = np.asarray([start], np.int64)
        level = 0
        while frontier.size:
            nxt_parts = []
            for d in dirs:
                off, nbr, rows = csr[d]
                _, _, nb = _gather_csr(off, nbr, rows, row_alive, row_type,
                                       n_csr, frontier, codes)
                if nb.size:
                    nxt_parts.append(nb)
                if delta[d]:
                    extra = [o for i in frontier.tolist()
                             for o in delta[d].get(i, ())]
                    if extra:
                        nxt_parts.append(np.asarray(extra, np.int64))
            if not nxt_parts:
                break
            cand = np.concatenate(nxt_parts).astype(np.int64)
            cand = cand[dist[cand] < 0]
            if not cand.size:
                break
            frontier = np.unique(cand)
            level += 1
            dist[frontier] = level
        return dist

    def indices_of(self, ids: list[str]) -> np.ndarray:
        """Batched id -> vocab index lookup (-1 for unknown/dead nodes) —
        one locked pass instead of a locked call per node."""
        with self._lock:
            idx = self._idx
            alive = self._alive
            out = np.empty(len(ids), np.int64)
            for k, s in enumerate(ids):
                i = idx.get(s)
                out[k] = i if (i is not None and alive[i]) else -1
            return out

    def csr_view(self) -> Optional[CSRView]:
        """Delta-folded, generation-pinned :class:`CSRView` for the
        columnar Cypher pipeline, or None before the first build.

        A pure-array consumer has no delta-overlay logic, so pending delta
        ADDS must be folded into the CSR before it reads.  But a fold
        rebuilds the canonical arrays AND the edge-id rank (O(m log m) —
        measured ~250ms at 500k edges), so a single trickled write must
        not pay that per read: small graphs fold eagerly (cheap), large
        graphs wait for the delta to amortize the rebuild and serve the
        interim reads generically (returning None — the matcher's
        existing delta overlay answers them).  Tombstoned deletes need no
        fold (the pinned ``row_alive`` copy filters them).  Repeat
        queries on an unchanged graph reuse the cached view (and its
        rank array) for free."""
        with self._lock:
            if not self._built:
                return None
            if self._d_ids:
                if self._m <= VIEW_FOLD_EAGER_EDGES \
                        or self._pending >= VIEW_FOLD_MIN_PENDING:
                    self._merge_locked()
                else:
                    return None
            view = self._csr_view
            if view is not None and view.generation == self._generation:
                return view
            if self._rank_src is not self._row_ids:
                # dense rank of each edge row in edge-ID-sorted order;
                # one C-speed argsort per merge, reused by every query
                if self._m:
                    order = np.argsort(np.asarray(self._row_ids))
                    rank = np.empty(self._m, np.int64)
                    rank[order] = np.arange(self._m)
                else:
                    rank = np.zeros(0, np.int64)
                self._rank_src = self._row_ids
                self._rank_arr = rank
            view = CSRView(
                generation=self._generation,
                n_csr=self._n_csr,
                ids=self._ids,
                node_alive=np.asarray(self._alive, bool),
                row_alive=self._row_alive.copy(),
                erow_type=self._erow_type,
                erow_rank=self._rank_arr,
                row_ids=self._row_ids,
                type_code=dict(self._type_code),
                eprops=dict(self._eprops),
                csr={"out": (self._out_off, self._out_nbr, self._out_rows),
                     "in": (self._in_off, self._in_nbr, self._in_rows)},
            )
            self._csr_view = view
            return view

    def export_arrays(self) -> Optional[tuple[dict, dict]]:
        """Merged, self-contained copies of the CSR arrays + vocab for the
        cross-process shared-memory read plane (server/readplane.py).

        Returns ``(arrays, vocab)`` or None when the snapshot was never
        built. Any pending delta/tombstones are folded first (exports are
        infrequent relative to merges), so readers need no delta-overlay
        logic: the exported CSR alone answers every expansion the
        in-process snapshot would — the twin-path equivalence the worker
        traversal tests assert."""
        with self._lock:
            if not self._built:
                return None
            if self._pending or self._tombstones:
                self._merge_locked()
            arrays = {
                "out_off": self._out_off.copy(),
                "out_nbr": self._out_nbr.copy(),
                "out_rows": self._out_rows.copy(),
                "in_off": self._in_off.copy(),
                "in_nbr": self._in_nbr.copy(),
                "in_rows": self._in_rows.copy(),
                "erow_type": self._erow_type.copy(),
                "row_alive": self._row_alive.copy(),
                "node_alive": np.asarray(self._alive, bool),
            }
            vocab = {
                "ids": list(self._ids),
                "row_ids": list(self._row_ids),
                "type_names": list(self._type_names),
                "generation": self._generation,
                "n_csr": self._n_csr,
            }
        return arrays, vocab

    # -- derived views ------------------------------------------------------
    def edge_arrays(self) -> EdgeArraysView:
        """Sorted-id (ids, index, src, dst) projection — the `_edge_arrays`
        contract in cypher/gds_procedures.py — generation-cached so
        repeated GDS calls on an unchanged graph reuse the same arrays."""
        with self._lock:
            self._maybe_merge_locked()
            view = self._view_cache
            if view is not None and view.generation == self._generation:
                return view
            alive_ids = sorted(
                id_ for i, id_ in enumerate(self._ids) if self._alive[i])
            index = {id_: i for i, id_ in enumerate(alive_ids)}
            pos = np.full(len(self._ids), -1, np.int64)
            for id_, p in index.items():
                pos[self._idx[id_]] = p
            keep = np.nonzero(self._row_alive)[0]
            s_parts = [self._erow_src[keep]]
            d_parts = [self._erow_dst[keep]]
            t_parts = [self._erow_type[keep]]
            d_live = [j for j, a in enumerate(self._d_alive) if a]
            if d_live:
                s_parts.append(np.asarray(
                    [self._d_src[j] for j in d_live], np.int32))
                d_parts.append(np.asarray(
                    [self._d_dst[j] for j in d_live], np.int32))
                t_parts.append(np.asarray(
                    [self._d_type[j] for j in d_live], np.int32))
            s_raw = np.concatenate(s_parts) if s_parts else \
                np.zeros(0, np.int32)
            d_raw = np.concatenate(d_parts) if d_parts else \
                np.zeros(0, np.int32)
            t_raw = np.concatenate(t_parts) if t_parts else \
                np.zeros(0, np.int32)
            src = pos[s_raw]
            dst = pos[d_raw]
            ok = (src >= 0) & (dst >= 0)  # drop edges touching dead nodes
            view = EdgeArraysView(
                ids=alive_ids,
                index=index,
                src=src[ok].astype(np.int32),
                dst=dst[ok].astype(np.int32),
                type_codes=t_raw[ok],
                type_names=list(self._type_names),
                generation=self._generation,
            )
            self._view_cache = view
            return view

    def graph_view(self, edge_types=None):
        """Undirected linkpredict Graph built from the snapshot arrays —
        no engine scan, cached per (generation, type filter)."""
        from nornicdb_tpu_torch.linkpredict.topology import Graph

        key = tuple(sorted(edge_types)) if edge_types else None
        view = self.edge_arrays()
        with self._lock:
            hit = self._graph_cache.get(key)
            if hit is not None and hit[0] == view.generation:
                return hit[1]
        src, dst = view.src, view.dst
        if edge_types:
            wanted = {c for c, name in enumerate(view.type_names)
                      if name in set(edge_types)}
            if wanted:
                mask = np.isin(view.type_codes, list(wanted))
                src, dst = src[mask], dst[mask]
            else:
                src = dst = np.zeros(0, np.int32)
        neighbors: list[set[int]] = [set() for _ in view.ids]
        for a, b in zip(src.tolist(), dst.tolist()):
            if a != b:
                neighbors[a].add(b)
                neighbors[b].add(a)
        g = Graph(list(view.ids), dict(view.index), neighbors)
        with self._lock:
            if len(self._graph_cache) > 8:
                self._graph_cache.clear()
            self._graph_cache[key] = (view.generation, g)
        return g

    # -- stats --------------------------------------------------------------
    def stats_snapshot(self) -> dict[str, Any]:
        with self._lock:
            edges_live = int(self._row_alive.sum()) + sum(
                1 for a in self._d_alive if a)
            csr_bytes = int(
                self._out_off.nbytes + self._out_nbr.nbytes
                + self._out_rows.nbytes + self._in_off.nbytes
                + self._in_nbr.nbytes + self._in_rows.nbytes
                + self._erow_src.nbytes + self._erow_dst.nbytes
                + self._erow_type.nbytes)
            return {
                "built": self._built,
                "generation": self._generation,
                "nodes": self._alive_count,
                "edges": edges_live,
                "builds": self.stats.builds,
                "epoch_retries": self.stats.epoch_retries,
                "delta_merges": self.stats.delta_merges,
                "merged_edges": self.stats.merged_edges,
                "delta_events": self.stats.delta_events,
                "delta_pending": self._pending,
                "expansions": self.stats.expansions,
                "bytes": csr_bytes,
                "merge_threshold": self.merge_threshold,
            }
