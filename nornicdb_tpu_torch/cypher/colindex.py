"""Event-maintained columnar scan index for label scans.

The engines copy every node on get_nodes_by_label (copy-on-read isolation,
storage/types.py:401) — correct for point reads, but it makes a 100k-node
WHERE scan pay ~1s of node materialization before a single predicate runs.
This index keeps per-label property *columns* (aligned Python lists) fresh
via the engine event bus (NODE_CREATED/UPDATED/DELETED, the same mechanism
NamespacedEngine uses for O(1) counts), so a compiled WHERE
(cypher/parallel.py) evaluates over raw values and only the surviving rows
are ever materialized as Nodes.

Role-wise this replaces the reference's scan-side worker pools
(pkg/cypher/parallel.go): goroutines across cores there, columnar
evaluation here — the shape that actually speeds a CPython host up.

Concurrency: the index lock is never held across engine calls (the event
handler only touches index state, builds fetch from the engine before
taking the lock), so there is no lock-order coupling with engine internals.
A build is epoch-validated: if any node event lands during the snapshot
fetch, the build is discarded and retried once, then deferred to the next
query. Deletes swap-remove to keep columns dense; result ids are sorted by
the caller to match the generic path's id-ordered scans.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch.storage.types import (
    NODE_CREATED,
    NODE_DELETED,
    NODE_UPDATED,
    Node,
)

_NODE_EVENTS = (NODE_CREATED, NODE_UPDATED, NODE_DELETED)


class _LabelColumns:
    """ids + aligned per-property value columns for one label."""

    def __init__(self, nodes: list[Node]):
        self.ids: list[str] = [n.id for n in nodes]
        self.pos: dict[str, int] = {id_: i for i, id_ in enumerate(self.ids)}
        self.cols: dict[str, list] = {}
        keys: set[str] = set()
        for n in nodes:
            keys.update(n.properties.keys())
        for k in keys:
            self.cols[k] = [n.properties.get(k) for n in nodes]

    def __len__(self) -> int:
        return len(self.ids)

    def column(self, key: str) -> list:
        col = self.cols.get(key)
        if col is None:
            return [None] * len(self.ids)
        return col

    # -- deltas -----------------------------------------------------------
    def upsert(self, node: Node) -> None:
        i = self.pos.get(node.id)
        if i is None:
            i = len(self.ids)
            self.ids.append(node.id)
            self.pos[node.id] = i
            for k, col in self.cols.items():
                col.append(node.properties.get(k))
            for k in node.properties:
                if k not in self.cols:
                    self.cols[k] = [None] * i + [node.properties[k]]
        else:
            for k, col in self.cols.items():
                col[i] = node.properties.get(k)
            for k, v in node.properties.items():
                if k not in self.cols:
                    col = [None] * len(self.ids)
                    col[i] = v
                    self.cols[k] = col

    def remove(self, node_id: str) -> None:
        i = self.pos.pop(node_id, None)
        if i is None:
            return
        last = len(self.ids) - 1
        if i != last:  # swap-remove keeps columns dense and aligned
            moved = self.ids[last]
            self.ids[i] = moved
            self.pos[moved] = i
            for col in self.cols.values():
                col[i] = col[last]
        self.ids.pop()
        for col in self.cols.values():
            col.pop()


class ColumnarScanIndex:
    """Lazily built per-label column store, kept fresh by engine events.

    The label set is LRU-capped: _on_event walks every cached label per
    node write, so an unbounded set (a workload touching hundreds of
    small queried-once labels) would grow write-path cost and resident
    columns without bound."""

    MAX_LABELS = 64

    def __init__(self, storage):
        self.storage = storage
        self._lock = threading.RLock()
        self._labels: "OrderedDict[str, _LabelColumns]" = OrderedDict()
        self._epoch = 0
        storage.on_event(self._on_event)

    # called from writer threads — touches only index state (never the
    # engine), so it cannot participate in a lock-order cycle
    def _on_event(self, kind: str, entity: Any) -> None:
        if kind not in _NODE_EVENTS or not isinstance(entity, Node):
            return
        with self._lock:
            self._epoch += 1
            if kind == NODE_DELETED:
                for lc in self._labels.values():
                    lc.remove(entity.id)
                return
            labels = set(entity.labels)
            for label, lc in self._labels.items():
                if label in labels:
                    lc.upsert(entity)
                else:
                    lc.remove(entity.id)

    def _get(self, label: str) -> Optional[_LabelColumns]:
        with self._lock:
            lc = self._labels.get(label)
            if lc is not None:
                self._labels.move_to_end(label)
                return lc
        for _ in range(2):  # one retry if a write races the snapshot
            with self._lock:
                epoch = self._epoch
            nodes = self.storage.get_nodes_by_label(label)
            built = _LabelColumns(nodes)
            with self._lock:
                if self._epoch == epoch:
                    self._labels[label] = built
                    self._labels.move_to_end(label)
                    while len(self._labels) > self.MAX_LABELS:
                        self._labels.popitem(last=False)
                    return built
        return None  # busy write window — caller falls back to generic scan

    def masked_ids(
        self, label: str, compiled, params: dict
    ) -> Optional[list[str]]:
        """Ids of label members whose columns satisfy the compiled WHERE,
        or None when the index can't serve (busy build window)."""
        lc = self._get(label)
        if lc is None:
            return None
        with self._lock:
            mask = compiled.mask(lc, params)
            return [lc.ids[i] for i in np.nonzero(mask)[0]]

    def count(self, label: str, compiled, params: dict) -> Optional[int]:
        lc = self._get(label)
        if lc is None:
            return None
        with self._lock:
            return int(compiled.mask(lc, params).sum())

    def prop_match_ids(self, label: str,
                       props: dict) -> Optional[list[str]]:
        """Ids of label members whose property columns equal every entry
        of ``props`` under the matcher's prop-map semantics (_value_eq:
        ``{k: null}`` matches a missing property — deliberately NOT the
        WHERE evaluator's three-valued ``_eq``). None when the index
        can't serve. Unindexed anchored scans ride this instead of
        materializing every label member."""
        from nornicdb_tpu_torch.cypher.matcher import _value_eq

        lc = self._get(label)
        if lc is None:
            return None
        with self._lock:
            items = [(lc.column(k), v) for k, v in props.items()]
            return [
                lc.ids[i] for i in range(len(lc.ids))
                if all(_value_eq(col[i], v) for col, v in items)
            ]

    def column_values(self, label: str, key: str,
                      ids: list) -> Optional[list]:
        """Property values for `ids` (all carrying `label`), aligned with
        the input order; None when the index can't serve. The columnar
        pipeline's projections/sort-keys/group-keys ride this instead of
        materializing Node copies for every surviving row."""
        lc = self._get(label)
        if lc is None:
            return None
        with self._lock:
            col = lc.cols.get(key)
            if col is None:
                # property never seen on any member of this label
                return [None] * len(ids)
            pos = lc.pos
            out = []
            for s in ids:
                i = pos.get(s)
                out.append(col[i] if i is not None else None)
            return out

    def epoch(self) -> int:
        """Monotone node-event counter: any cached derivation of column
        state (e.g. the VectorTopK embedding matrix) is valid exactly
        while the epoch it was built under still holds."""
        with self._lock:
            return self._epoch

    def embedding_snapshot(
        self, label: str, key: str
    ) -> Optional[tuple[int, list[str], list]]:
        """(epoch, ids, values) for one label property column — shallow
        copies taken under the lock, so the caller can run the expensive
        float conversion/normalization outside it and re-validate against
        ``epoch()`` before caching. None in a busy build window."""
        lc = self._get(label)
        if lc is None:
            return None
        with self._lock:
            return self._epoch, list(lc.ids), list(lc.column(key))

    def label_ids(self, label: str) -> Optional[list[str]]:
        """Ids of every node carrying `label` (unsorted — callers order),
        or None when the index can't serve (busy build window). Feeds the
        columnar pipeline's label scans and membership masks without
        materializing a single Node."""
        lc = self._get(label)
        if lc is None:
            return None
        with self._lock:
            return list(lc.ids)
