"""Multi-database management over one shared storage engine.

Counterpart of ``nornicdb_tpu/multidb/manager.py`` (the port keeps its own
copy and imports nothing of the JAX package).

Behavioral reference: the upstream NornicDB pkg/multidb/manager.go:43 —
DatabaseManager (CreateDatabase :275, GetStorage :356), ID namespacing
"<db>:<id>" via NamespacedEngine, the reserved "system" DB, aliases,
composite (federated) databases (composite.go:56-253, routing.go:13),
per-DB resource limits (limits.go, enforcement.go), metadata persisted in
the system DB (metadata.go).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

from nornicdb_tpu_torch.errors import AlreadyExistsError, NornicError, NotFoundError
from nornicdb_tpu_torch.storage.namespaced import NamespacedEngine
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node

SYSTEM_DB = "system"
DEFAULT_DB = "neo4j"
_META_LABEL = "_Database"
_ALIAS_LABEL = "_Alias"


@dataclass
class DatabaseLimits:
    """(ref: limits.go — StorageLimits + QueryLimits + RateLimits)"""

    max_nodes: int = 0  # 0 = unlimited
    max_edges: int = 0
    # query wall-clock budget in seconds (ref: QueryLimits.MaxQueryTime);
    # enforced at clause boundaries by the executor
    max_query_time: float = 0.0
    # token-bucket rates (ref: RateLimits.MaxQueriesPerSecond / MaxWrites...)
    max_queries_per_second: int = 0
    max_writes_per_second: int = 0

    FIELD_NAMES = ("max_nodes", "max_edges", "max_query_time",
                   "max_queries_per_second", "max_writes_per_second")


class _Bucket:
    """Minimal token bucket for per-database rate limits. Monotonic clock:
    a wall-clock step (NTP) must not drain tokens or mint free ones."""

    def __init__(self, rate: float):
        self.rate = rate
        self.tokens = float(rate)
        self.ts = time.monotonic()
        self.lock = threading.Lock()

    def take(self) -> bool:
        with self.lock:
            now = time.monotonic()
            self.tokens = min(self.rate, self.tokens + (now - self.ts) * self.rate)
            self.ts = now
            if self.tokens < 1.0:
                return False
            self.tokens -= 1.0
            return True


class LimitedEngine(NamespacedEngine):
    """Namespaced engine with per-DB resource enforcement
    (ref: enforcement.go)."""

    def __init__(self, base: Engine, namespace: str, limits: DatabaseLimits):
        super().__init__(base, namespace)
        self.limits = limits
        self._write_bucket = (
            _Bucket(limits.max_writes_per_second)
            if limits.max_writes_per_second else None
        )
        # consumed by the executor at query entry (it owns query boundaries)
        self.query_bucket = (
            _Bucket(limits.max_queries_per_second)
            if limits.max_queries_per_second else None
        )
        # per-instance: a rollback exemption on one database must not
        # suspend rate checks on other databases touched by the same thread
        self._exempt = threading.local()

    @contextlib.contextmanager
    def exempt_writes(self):
        """Suspend the write rate limit on this thread — rollback/undo
        writes must never be throttled, or a failed statement could be
        left half-unwound (exactly the corruption the undo frame exists
        to prevent)."""
        prev = getattr(self._exempt, "on", False)
        self._exempt.on = True
        try:
            yield
        finally:
            self._exempt.on = prev

    def _check_write_rate(self) -> None:
        if getattr(self._exempt, "on", False):
            return
        if self._write_bucket is not None and not self._write_bucket.take():
            raise NornicError(
                f"database {self.namespace} write rate limit exceeded "
                f"({self.limits.max_writes_per_second}/s)"
            )

    def create_node(self, node: Node) -> Node:
        self._check_write_rate()
        if self.limits.max_nodes and self.node_count() >= self.limits.max_nodes:
            raise NornicError(
                f"database {self.namespace} node limit reached ({self.limits.max_nodes})"
            )
        return super().create_node(node)

    def update_node(self, node: Node) -> Node:
        self._check_write_rate()
        return super().update_node(node)

    def delete_node(self, node_id: str) -> None:
        self._check_write_rate()
        super().delete_node(node_id)

    def create_edge(self, edge: Edge) -> Edge:
        self._check_write_rate()
        if self.limits.max_edges and self.edge_count() >= self.limits.max_edges:
            raise NornicError(
                f"database {self.namespace} edge limit reached ({self.limits.max_edges})"
            )
        return super().create_edge(edge)

    def update_edge(self, edge: Edge) -> Edge:
        self._check_write_rate()
        return super().update_edge(edge)

    def delete_edge(self, edge_id: str) -> None:
        self._check_write_rate()
        super().delete_edge(edge_id)


def _hash_string(s: str) -> int:
    """The reference's 31-multiplier string hash (composite_engine.go
    hashString) masked to 64-bit signed so routing indexes agree."""
    h = 0
    for ch in s:
        h = (h * 31 + ord(ch)) & 0xFFFFFFFFFFFFFFFF
    if h >= 1 << 63:
        h -= 1 << 64
    return h


def _hash_value(v) -> int:
    """(ref: hashValue composite_engine.go:265) — integers hash to their
    absolute value, everything else stringifies; keeps routing index-
    compatible with the reference for numeric tenant ids."""
    if isinstance(v, bool):  # bool is an int subclass; stringify like Go %v
        return _hash_string(str(v).lower())
    if isinstance(v, int):
        return abs(v)
    if isinstance(v, str):
        return _hash_string(v)
    return _hash_string(str(v))


class CompositeEngine(Engine):
    """Federated view over constituent databases with deterministic write
    routing (ref: pkg/storage/composite_engine.go, pkg/multidb/composite.go).

    Reads fan out / route by the `db.` id prefix. Writes route to a
    writable constituent by the reference's rules (routeWrite :160):
      0. properties.database_id exactly names a writable constituent
      1. first label matches a constituent alias (case-insensitive)
      2. properties.database_id consistent-hashes over writables
      3. first label consistent-hashes over writables
      4. first writable constituent
    Per-constituent access modes: "read", "write", "read_write".
    """

    def __init__(self, constituents: dict[str, Engine],
                 access_modes: Optional[dict[str, str]] = None):
        super().__init__()
        self.constituents = constituents
        self.access_modes = {
            name: (access_modes or {}).get(name, "read_write")
            for name in constituents
        }
        for name, mode in self.access_modes.items():
            if mode not in ("read", "write", "read_write"):
                raise NornicError(
                    f"access mode must be 'read', 'write', or 'read_write' "
                    f"(constituent {name}: {mode!r})"
                )

    # -- write routing -------------------------------------------------------
    def _writables(self) -> list[str]:
        # deterministic order: routing hashes index into this list
        return sorted(n for n, m in self.access_modes.items()
                      if m in ("write", "read_write"))

    def _readables(self) -> dict[str, Engine]:
        """Constituents visible to reads — 'write'-only ones are excluded,
        like the reference's getConstituentsForRead
        (composite_engine.go:112-126)."""
        return {n: e for n, e in self.constituents.items()
                if self.access_modes.get(n) in ("read", "read_write")}

    def _route_write(self, labels: list[str], properties: dict) -> str:
        writable = self._writables()
        if not writable:
            raise NornicError("composite has no writable constituents")
        db_val = (properties or {}).get("database_id")
        if isinstance(db_val, str) and db_val in writable:
            return db_val
        if labels:
            first = labels[0].lower()
            for alias in writable:
                if alias.lower() == first:
                    return alias
        if db_val is not None:
            idx = abs(_hash_value(db_val)) % len(writable)
            return writable[idx]
        if labels:
            idx = abs(_hash_string(labels[0])) % len(writable)
            return writable[idx]
        return writable[0]

    def create_node(self, node: Node) -> Node:
        # an id qualified with a constituent prefix IS the routing request:
        # storing "west.w2" in a different constituent would make the
        # caller's addressed id name nothing on later reads
        prefix = node.id.split(".", 1)[0] if "." in node.id else None
        if prefix in self.constituents:
            name = prefix
            self._check_writable(name)
        else:
            name = self._route_write(node.labels, node.properties)
        bare = node.copy()
        if bare.id.startswith(f"{name}."):
            bare.id = bare.id.split(".", 1)[1]
        created = self.constituents[name].create_node(bare)
        return self._qualify(name, created)

    def update_node(self, node: Node) -> Node:
        name, bare_id, _ = self._locate(node.id, kind="node", for_write=True)
        self._check_writable(name)
        bare = node.copy()
        bare.id = bare_id
        return self._qualify(name, self.constituents[name].update_node(bare))

    def delete_node(self, node_id: str) -> None:
        name, bare_id, _ = self._locate(node_id, kind="node", for_write=True)
        self._check_writable(name)
        self.constituents[name].delete_node(bare_id)

    def create_edge(self, edge: Edge) -> Edge:
        # an edge lives with its endpoints: both must resolve to ONE
        # writable constituent (cross-constituent edges don't exist in the
        # reference either)
        s_name, s_bare, _ = self._locate(edge.start_node, kind="node",
                                         for_write=True)
        t_name, t_bare, _ = self._locate(edge.end_node, kind="node",
                                         for_write=True)
        if s_name != t_name:
            raise NornicError(
                "cannot create an edge across composite constituents "
                f"({s_name} -> {t_name})"
            )
        self._check_writable(s_name)
        bare = edge.copy()
        bare.start_node, bare.end_node = s_bare, t_bare
        if "." in bare.id:
            prefix = bare.id.split(".", 1)[0]
            if prefix == s_name:
                bare.id = bare.id.split(".", 1)[1]
            elif prefix in self.constituents:
                # honoring a FOREIGN prefix would store an id the caller
                # can never address again — refuse, like create_node's
                # prefix-is-the-routing-request contract
                raise NornicError(
                    f"edge id is qualified for {prefix!r} but its endpoints "
                    f"live in {s_name!r}"
                )
        return self._qualify(s_name, self.constituents[s_name].create_edge(bare))

    def update_edge(self, edge: Edge) -> Edge:
        name, bare_id, _ = self._locate(edge.id, kind="edge", for_write=True)
        self._check_writable(name)
        bare = edge.copy()
        bare.id = bare_id
        if bare.start_node.startswith(f"{name}."):
            bare.start_node = bare.start_node.split(".", 1)[1]
        if bare.end_node.startswith(f"{name}."):
            bare.end_node = bare.end_node.split(".", 1)[1]
        return self._qualify(name, self.constituents[name].update_edge(bare))

    def delete_edge(self, edge_id: str) -> None:
        name, bare_id, _ = self._locate(edge_id, kind="edge", for_write=True)
        self._check_writable(name)
        self.constituents[name].delete_edge(bare_id)

    def _check_writable(self, name: str) -> None:
        if self.access_modes.get(name) == "read":
            raise NornicError(
                f"constituent {name} is read-only in this composite"
            )

    def _locate(self, qualified_id: str, kind: str,
                for_write: bool = False):
        """Resolve an id to (constituent, bare_id, entity_or_None).

        Visibility follows the access mode: reads only see 'read'/
        'read_write' constituents (a 'write'-only constituent is invisible
        even by qualified id — the scan and point-read views must agree);
        writes locate across 'write'/'read_write' constituents. The entity
        is returned when the search branch already fetched it, so callers
        don't pay a second point lookup."""
        # writes locate across EVERY constituent so that a write against a
        # read-only one fails with the permission error from _check_writable,
        # not a misleading not-found; reads only see readable constituents
        # ('write'-only data is invisible even by qualified id, so the scan
        # and point-read views agree)
        pool = self.constituents if for_write else self._readables()
        if "." in qualified_id:
            db, bare = qualified_id.split(".", 1)
            if db in self.constituents:
                if db not in pool:
                    raise NotFoundError(
                        f"id {qualified_id} not found in composite")
                return db, bare, None
        for name, eng in pool.items():
            try:
                entity = (eng.get_node(qualified_id) if kind == "node"
                          else eng.get_edge(qualified_id))
                return name, qualified_id, entity
            except NotFoundError:
                continue
        raise NotFoundError(f"id {qualified_id} not found in composite")

    def mark_pending_embed(self, node_id: str) -> None:
        name, bare, _ = self._locate(node_id, kind="node", for_write=True)
        self._check_writable(name)
        self.constituents[name].mark_pending_embed(bare)

    def unmark_pending_embed(self, node_id: str) -> None:
        name, bare, _ = self._locate(node_id, kind="node", for_write=True)
        self._check_writable(name)
        self.constituents[name].unmark_pending_embed(bare)

    def _qualify(self, name: str, entity):
        out = entity.copy()
        out.id = f"{name}.{entity.id}"
        if isinstance(out, Edge):
            out.start_node = f"{name}.{entity.start_node}"
            out.end_node = f"{name}.{entity.end_node}"
        return out

    def get_node(self, node_id: str) -> Node:
        name, bare, entity = self._locate(node_id, kind="node")
        if entity is None:
            entity = self.constituents[name].get_node(bare)
        return self._qualify(name, entity)

    def get_edge(self, edge_id: str) -> Edge:
        name, bare, entity = self._locate(edge_id, kind="edge")
        if entity is None:
            entity = self.constituents[name].get_edge(bare)
        return self._qualify(name, entity)

    def get_nodes_by_label(self, label: str) -> list[Node]:
        out = []
        for name, eng in self._readables().items():
            out.extend(self._qualify(name, n) for n in eng.get_nodes_by_label(label))
        return out

    def all_nodes(self) -> Iterator[Node]:
        for name, eng in self._readables().items():
            for n in eng.all_nodes():
                yield self._qualify(name, n)

    def all_edges(self) -> Iterator[Edge]:
        for name, eng in self._readables().items():
            for e in eng.all_edges():
                yield self._qualify(name, e)

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        out = []
        for name, eng in self._readables().items():
            out.extend(self._qualify(name, e) for e in eng.get_edges_by_type(edge_type))
        return out

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        name, bare, _ = self._locate(node_id, kind="node")
        eng = self.constituents[name]
        return [self._qualify(name, e) for e in eng.get_outgoing_edges(bare)]

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        name, bare, _ = self._locate(node_id, kind="node")
        eng = self.constituents[name]
        return [self._qualify(name, e) for e in eng.get_incoming_edges(bare)]

    def node_count(self) -> int:
        return sum(e.node_count() for e in self._readables().values())

    def edge_count(self) -> int:
        return sum(e.edge_count() for e in self._readables().values())

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        return []


class DatabaseManager:
    """(ref: multidb.DatabaseManager manager.go:43)"""

    def __init__(self, base: Engine, default_database: str = DEFAULT_DB,
                 on_invalidate=None):
        self.base = base
        self.default_database = default_database
        # called with the db name whenever its engine view becomes stale
        # (drop, limit change) so holders of cached executors can evict
        self.on_invalidate = on_invalidate
        self._lock = threading.RLock()
        self._limits: dict[str, DatabaseLimits] = {}
        self._query_buckets: dict[str, _Bucket] = {}
        self._composites: dict[str, list[str]] = {}
        # per (composite, constituent) access mode (ref: ConstituentRef.
        # AccessMode composite.go:24); absent = read_write
        self._composite_modes: dict[str, dict[str, str]] = {}
        self._engines: dict[str, Engine] = {}
        self._system = NamespacedEngine(base, SYSTEM_DB)
        self._load_metadata()
        # implicit databases
        for name in (SYSTEM_DB, default_database):
            if name not in self._databases:
                self._databases.add(name)
                self._persist_db(name)

    # -- metadata (persisted as nodes in the system DB, ref: metadata.go) ----
    def _load_metadata(self) -> None:
        self._databases: set[str] = set()
        self._aliases: dict[str, str] = {}
        for n in self._system.get_nodes_by_label(_META_LABEL):
            self._databases.add(n.properties["name"])
            if n.properties.get("composite"):
                self._composites[n.properties["name"]] = list(
                    n.properties.get("constituents", [])
                )
                self._composite_modes[n.properties["name"]] = dict(
                    n.properties.get("access_modes", {})
                )
        for n in self._system.get_nodes_by_label(_ALIAS_LABEL):
            self._aliases[n.properties["alias"]] = n.properties["target"]

    def _persist_db(self, name: str, composite: Optional[list[str]] = None) -> None:
        props = {"name": name}
        if composite is not None and self._composite_modes.get(name):
            props["access_modes"] = dict(self._composite_modes[name])
        if composite is not None:
            props["composite"] = True
            props["constituents"] = composite
        self._system.create_node(
            Node(id=f"db-{name}", labels=[_META_LABEL], properties=props)
        )

    # -- database lifecycle ----------------------------------------------------
    def create_database(self, name: str, if_not_exists: bool = False,
                        limits: Optional[DatabaseLimits] = None) -> None:
        """(ref: CreateDatabase manager.go:275)"""
        with self._lock:
            if name in self._databases or name in self._aliases:
                if if_not_exists:
                    return
                raise AlreadyExistsError(f"database {name} already exists")
            self._databases.add(name)
            if limits is not None:
                self._limits[name] = limits
            self._persist_db(name)

    def drop_database(self, name: str, if_exists: bool = False) -> None:
        with self._lock:
            if name == SYSTEM_DB:
                raise NornicError("cannot drop the system database")
            if name not in self._databases:
                if if_exists:
                    return
                raise NotFoundError(f"database {name} not found")
            if name not in self._composites:
                # delete all namespaced data; composites own no data — only
                # metadata is removed for them (constituents are untouched)
                eng = self.get_storage(name)
                for e in list(eng.all_edges()):
                    eng.delete_edge(e.id)
                for n in list(eng.all_nodes()):
                    eng.delete_node(n.id)
            self._databases.discard(name)
            self._engines.pop(name, None)
            self._composites.pop(name, None)
            self._composite_modes.pop(name, None)
            self._limits.pop(name, None)  # a re-created DB must not inherit
            self._query_buckets.pop(name, None)
            try:
                self._system.delete_node(f"db-{name}")
            except NotFoundError:
                pass
            # drop aliases pointing at it
            for alias, target in list(self._aliases.items()):
                if target == name:
                    self.drop_alias(alias)
        if self.on_invalidate is not None:
            self.on_invalidate(name)

    def create_composite(self, name: str, constituents: Optional[list[str]] = None) -> None:
        """(ref: composite.go:56-253)"""
        with self._lock:
            if name in self._databases:
                raise AlreadyExistsError(f"database {name} already exists")
            constituents = constituents or []
            for c in constituents:
                if c not in self._databases:
                    raise NotFoundError(f"constituent database {c} not found")
            self._databases.add(name)
            self._composites[name] = constituents
            self._persist_db(name, composite=constituents)

    def add_constituent(self, composite: str, database: str,
                        access_mode: Optional[str] = None) -> None:
        """access_mode None = ensure membership, KEEP any configured mode —
        an idempotent ALTER ... ADD ALIAS re-run must not silently promote
        a read-only constituent back to read_write."""
        if access_mode is not None and access_mode not in (
                "read", "write", "read_write"):
            raise NornicError(
                "access mode must be 'read', 'write', or 'read_write'")
        with self._lock:
            if composite not in self._composites:
                raise NotFoundError(f"composite {composite} not found")
            if database not in self._databases:
                raise NotFoundError(f"database {database} not found")
            changed = False
            if database not in self._composites[composite]:
                self._composites[composite].append(database)
                changed = True
            modes = self._composite_modes.setdefault(composite, {})
            if access_mode is not None and \
                    modes.get(database, "read_write") != access_mode:
                modes[database] = access_mode
                changed = True
            if changed:
                try:
                    self._system.delete_node(f"db-{composite}")
                except NotFoundError:
                    pass
                self._persist_db(composite, composite=self._composites[composite])
                self._engines.pop(composite, None)
        if changed and self.on_invalidate is not None:
            # cached per-DB executors hold the OLD CompositeEngine (and its
            # old access modes) — same eviction contract as set_limits
            self.on_invalidate(composite)

    def remove_constituent(self, composite: str, database: str) -> None:
        """(ref: ALTER COMPOSITE DATABASE ... DROP ALIAS, composite.go)"""
        with self._lock:
            if composite not in self._composites:
                raise NotFoundError(f"composite {composite} not found")
            removed = database in self._composites[composite]
            if removed:
                self._composites[composite].remove(database)
                self._composite_modes.get(composite, {}).pop(database, None)
                try:
                    self._system.delete_node(f"db-{composite}")
                except NotFoundError:
                    pass
                self._persist_db(composite, composite=self._composites[composite])
                self._engines.pop(composite, None)
        if removed and self.on_invalidate is not None:
            self.on_invalidate(composite)

    # -- aliases -------------------------------------------------------------------
    def create_alias(self, alias: str, target: str) -> None:
        with self._lock:
            if alias in self._databases or alias in self._aliases:
                raise AlreadyExistsError(f"name {alias} already in use")
            if target not in self._databases:
                raise NotFoundError(f"database {target} not found")
            self._aliases[alias] = target
            self._system.create_node(
                Node(
                    id=f"alias-{alias}",
                    labels=[_ALIAS_LABEL],
                    properties={"alias": alias, "target": target},
                )
            )

    def drop_alias(self, alias: str) -> None:
        with self._lock:
            if self._aliases.pop(alias, None) is None:
                raise NotFoundError(f"alias {alias} not found")
            try:
                self._system.delete_node(f"alias-{alias}")
            except NotFoundError:
                pass

    def list_aliases(self) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(self._aliases.items())

    # -- resolution ---------------------------------------------------------------
    def resolve(self, name: str) -> str:
        with self._lock:
            seen = set()
            while name in self._aliases:
                if name in seen:
                    raise NornicError(f"alias cycle at {name}")
                seen.add(name)
                name = self._aliases[name]
            return name

    def list_databases(self) -> list[str]:
        with self._lock:
            return sorted(self._databases)

    def exists(self, name: str) -> bool:
        with self._lock:
            return self.resolve(name) in self._databases

    def get_storage(self, name: str) -> Engine:
        """(ref: GetStorage manager.go:356)"""
        with self._lock:
            name = self.resolve(name)
            if name not in self._databases:
                raise NotFoundError(f"database {name} not found")
            eng = self._engines.get(name)
            if eng is None:
                if name in self._composites:
                    eng = CompositeEngine(
                        {
                            c: self.get_storage(c)
                            for c in self._composites[name]
                        },
                        access_modes=self._composite_modes.get(name),
                    )
                else:
                    limits = self._limits.get(name)
                    if limits is not None:
                        eng = LimitedEngine(self.base, name, limits)
                    else:
                        eng = NamespacedEngine(self.base, name)
                self._engines[name] = eng
            return eng

    def set_limits(self, name: str, limits: DatabaseLimits) -> None:
        """(ref: ALTER DATABASE ... SET LIMIT, system_commands_test.go:423)"""
        with self._lock:
            name = self.resolve(name)
            if name not in self._databases:
                raise NotFoundError(f"database {name} not found")
            self._limits[name] = limits
            self._engines.pop(name, None)
            self._query_buckets.pop(name, None)
        if self.on_invalidate is not None:
            self.on_invalidate(name)

    def get_limits(self, name: str) -> DatabaseLimits:
        with self._lock:
            return self._limits.get(self.resolve(name), DatabaseLimits())

    def query_limit_state(self, name: str):
        """(limits, query_bucket) for databases that are NOT served through
        a LimitedEngine — the default database's executor runs on the main
        facade chain, so the executor consults this instead. The bucket is
        cached per database and dies on set_limits."""
        with self._lock:
            name = self.resolve(name)
            limits = self._limits.get(name)
            if limits is None:
                return None, None
            bucket = self._query_buckets.get(name)
            if bucket is None and limits.max_queries_per_second:
                bucket = _Bucket(limits.max_queries_per_second)
                self._query_buckets[name] = bucket
            return limits, bucket

    def storage_stats(self) -> dict[str, dict[str, int]]:
        """(ref: storage-size accounting manager.go)"""
        out = {}
        for name in self.list_databases():
            eng = self.get_storage(name)
            out[name] = {"nodes": eng.node_count(), "edges": eng.edge_count()}
        return out
