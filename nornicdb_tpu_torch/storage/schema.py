"""Schema manager: constraints and index metadata.

Counterpart of ``nornicdb_tpu/storage/schema.py`` (the port keeps its own
copy and imports nothing of the JAX package).

Behavioral reference: the upstream NornicDB pkg/storage/schema.go:42 — unique
constraints, property / composite / fulltext / vector / range indexes.
Here the property index also maintains a live value->ids map used by the
Cypher executor for index-backed lookups (the reference's Badger engine gets
this from key-prefix scans; a TPU-host build keeps it as a hash index).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from nornicdb_tpu_torch.errors import AlreadyExistsError, ConstraintViolationError, NotFoundError
from nornicdb_tpu_torch.storage.types import Engine, Node

log = logging.getLogger(__name__)

INDEX_PROPERTY = "property"
INDEX_COMPOSITE = "composite"
INDEX_FULLTEXT = "fulltext"
INDEX_VECTOR = "vector"
INDEX_RANGE = "range"


@dataclass
class IndexDef:
    name: str
    kind: str
    label: str
    properties: list[str]
    options: dict[str, Any] = field(default_factory=dict)  # vector: dimensions, similarity


@dataclass
class ConstraintDef:
    name: str
    label: str
    properties: list[str]
    kind: str = "unique"


def _norm(properties) -> tuple:
    """Internal prop-map keys are SORTED property tuples: equality lookup
    over (a, b) and (b, a) is the same index, and callers (the matcher,
    the fastpath probe) present keys sorted — a composite index declared
    in non-alphabetical order must not be invisible to them."""
    return tuple(sorted(properties))


def _freeze(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


class SchemaManager:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._indexes: dict[str, IndexDef] = {}
        self._constraints: dict[str, ConstraintDef] = {}
        # (label, props-tuple) -> frozen-value-tuple -> set of node ids
        self._prop_maps: dict[tuple, dict[Any, set[str]]] = {}
        # node id -> set of (map-key, value-tuple) it is indexed under,
        # so updates can drop stale entries
        self._node_entries: dict[str, set[tuple]] = {}
        self._engine = None
        self._subscribed = False
        # DDL generation: bumped on index/constraint create/drop so the
        # columnar plan cache (cypher/plan.py) can invalidate plans whose
        # anchor strategy was chosen against a different index set —
        # including DDL run through another executor sharing this manager
        self.generation = 0

    # -- index DDL ---------------------------------------------------------
    def create_index(
        self,
        name: str,
        kind: str,
        label: str,
        properties: list[str],
        options: Optional[dict[str, Any]] = None,
        if_not_exists: bool = False,
    ) -> IndexDef:
        with self._lock:
            if name in self._indexes:
                if if_not_exists:
                    return self._indexes[name]
                raise AlreadyExistsError(f"index {name} already exists")
            idx = IndexDef(name, kind, label, list(properties), options or {})
            self._indexes[name] = idx
            self.generation += 1
            if kind in (INDEX_PROPERTY, INDEX_COMPOSITE, INDEX_RANGE):
                self._subscribe()
                self._prop_maps.setdefault((label, _norm(properties)), {})
                self._backfill(label, _norm(properties))
            return idx

    def drop_index(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            idx = self._indexes.pop(name, None)
            if idx is None:
                if if_exists:
                    return
                raise NotFoundError(f"index {name} not found")
            self.generation += 1
            key = (idx.label, _norm(idx.properties))
            if not any(
                (i.label, _norm(i.properties)) == key
                for i in self._indexes.values()
                if i.kind in (INDEX_PROPERTY, INDEX_COMPOSITE, INDEX_RANGE)
            ):
                self._prop_maps.pop(key, None)

    def get_index(self, name: str) -> Optional[IndexDef]:
        with self._lock:
            return self._indexes.get(name)

    def list_indexes(self) -> list[IndexDef]:
        with self._lock:
            return list(self._indexes.values())

    def vector_indexes(self) -> list[IndexDef]:
        return [i for i in self.list_indexes() if i.kind == INDEX_VECTOR]

    def has_prop_index(self, label: str, properties: list[str]) -> bool:
        """True when an equality-lookup map exists for (label, properties)
        — i.e. lookup() would answer (property/composite/range/constraint
        maps, NOT fulltext/vector defs). Order-insensitive."""
        with self._lock:
            return (label, _norm(properties)) in self._prop_maps

    def find_index(self, label: str, properties: list[str]) -> Optional[IndexDef]:
        with self._lock:
            for i in self._indexes.values():
                if i.label == label and i.properties == list(properties):
                    return i
        return None

    # -- constraints -------------------------------------------------------
    def create_constraint(
        self,
        name: str,
        label: str,
        properties: list[str],
        kind: str = "unique",
        if_not_exists: bool = False,
    ) -> ConstraintDef:
        with self._lock:
            if name in self._constraints:
                if if_not_exists:
                    return self._constraints[name]
                raise AlreadyExistsError(f"constraint {name} already exists")
            c = ConstraintDef(name, label, list(properties), kind)
            self._constraints[name] = c
            self.generation += 1
            self._subscribe()
            key = (label, _norm(properties))
            created_map = key not in self._prop_maps
            self._prop_maps.setdefault(key, {})
            self._backfill(label, key[1])
            if kind == "unique":
                # Neo4j refuses to create a unique constraint over data
                # that already violates it
                dup = next(
                    (vals for vals, ids in self._prop_maps[key].items()
                     if len(ids) > 1),
                    None,
                )
                if dup is not None:
                    del self._constraints[name]
                    if created_map and not any(
                        (i.label, _norm(i.properties)) == key
                        for i in self._indexes.values()
                    ):
                        # drop the map we just created, or index_node would
                        # maintain it forever for a constraint that doesn't
                        # exist (every entry also leaves _node_entries)
                        for vals, ids in self._prop_maps[key].items():
                            for nid in ids:
                                self._node_entries.get(nid, set()).discard(
                                    (key, vals))
                        del self._prop_maps[key]
                    raise ConstraintViolationError(
                        f"cannot create unique constraint {name}: existing "
                        f"duplicate value {dup!r} on {label}"
                        f"({', '.join(properties)})"
                    )
            return c

    def drop_constraint(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            if self._constraints.pop(name, None) is None and not if_exists:
                raise NotFoundError(f"constraint {name} not found")
            self.generation += 1

    def list_constraints(self) -> list[ConstraintDef]:
        with self._lock:
            return list(self._constraints.values())

    # -- maintenance (called from engine event stream) ----------------------
    def check_unique(self, node: Node, exclude_id: Optional[str] = None) -> None:
        """Raise ConstraintViolationError if `node` collides with an existing
        unique-constrained value."""
        with self._lock:
            for c in self._constraints.values():
                if c.kind != "unique" or c.label not in node.labels:
                    continue
                props = _norm(c.properties)
                vals = tuple(_freeze(node.properties.get(p)) for p in props)
                if any(v is None for v in vals):
                    continue
                ids = self._prop_maps.get((c.label, props), {}).get(vals)
                if ids and any(i != (exclude_id or node.id) for i in ids):
                    raise ConstraintViolationError(
                        f"unique constraint {c.name} violated on {c.label}"
                        f"({', '.join(c.properties)})"
                    )

    def index_node(self, node: Node) -> None:
        with self._lock:
            self._unindex_locked(node.id)
            entries = set()
            for (label, props), valmap in self._prop_maps.items():
                if label in node.labels:
                    vals = tuple(_freeze(node.properties.get(p)) for p in props)
                    if any(v is None for v in vals):
                        continue
                    valmap.setdefault(vals, set()).add(node.id)
                    entries.add(((label, props), vals))
            if entries:
                self._node_entries[node.id] = entries

    def _unindex_locked(self, node_id: str) -> None:
        for key, vals in self._node_entries.pop(node_id, set()):
            valmap = self._prop_maps.get(key)
            if valmap is None:
                continue
            ids = valmap.get(vals)
            if ids:
                ids.discard(node_id)
                if not ids:
                    valmap.pop(vals, None)

    def unindex_node(self, node: Node) -> None:
        with self._lock:
            self._unindex_locked(node.id)

    def lookup(self, label: str, properties: list[str], values: list[Any]) -> Optional[set[str]]:
        """Index-backed equality lookup; None when no such index exists.
        Property order is irrelevant: (prop, value) pairs are normalized
        to the sorted-key layout the maps use."""
        pairs = sorted(zip(properties, values))
        with self._lock:
            valmap = self._prop_maps.get((label, tuple(p for p, _ in pairs)))
            if valmap is None:
                return None
            return set(valmap.get(tuple(_freeze(v) for _, v in pairs), set()))

    def attach(self, engine: Engine) -> None:
        """Subscribe to engine events so index maps stay current, and index
        whatever the engine already holds."""
        self._engine = engine
        self._subscribe()
        for n in engine.all_nodes():
            self.index_node(n)

    def attach_lazy(self, engine: Engine) -> None:
        """Remember the engine but defer the event subscription (and any
        node scan) until the first index/constraint DDL. Per-request
        CypherExecutor construction over a shared long-lived engine must
        not accumulate dead subscriptions or pay O(N) scans when no index
        is ever created; _backfill covers pre-existing data at DDL time."""
        self._engine = engine

    def _subscribe(self) -> None:
        if self._subscribed or self._engine is None:
            return
        self._subscribed = True

        def _on(kind: str, entity) -> None:
            if not isinstance(entity, Node):
                return
            if kind == "node_created" or kind == "node_updated":
                self.index_node(entity)
            elif kind == "node_deleted":
                self.unindex_node(entity)

        self._engine.on_event(_on)

    def _backfill(self, label: str, properties: tuple) -> None:
        """Populate a NEW prop map from data that already exists — an index
        or constraint created after writes must see earlier nodes (Neo4j
        indexes existing data at creation time)."""
        engine = getattr(self, "_engine", None)
        if engine is None:
            return
        valmap = self._prop_maps.get((label, properties))
        if valmap is None or valmap:
            return  # nothing registered, or map already live (shared key)
        try:
            nodes = engine.get_nodes_by_label(label)
        except Exception:
            # an index created over a broken engine scan starts empty; log
            # it, or the missing backfill looks like silent data loss later
            log.warning("index backfill scan failed for label %r", label,
                        exc_info=True)
            return
        for n in nodes:
            vals = tuple(_freeze(n.properties.get(p)) for p in properties)
            if any(v is None for v in vals):
                continue
            valmap.setdefault(vals, set()).add(n.id)
            self._node_entries.setdefault(n.id, set()).add(
                ((label, properties), vals))
