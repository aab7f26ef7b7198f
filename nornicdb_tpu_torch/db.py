"""The port's DB facade, a port of ``nornicdb_tpu/db.py``: ``open()``
assembles the durable storage chain, the schema manager, and lazily the
search service, the embed worker, the inference engine and Heimdall, and
exposes the memory-centric API: store / recall / remember / link /
neighbors / forget.

The learning loop ("the graph database that learns") runs on the card:
``store`` marks a node pending; the ``EmbedWorker`` embeds it through the
embedder ``set_embedder`` installed (bge-m3 behind ``ServingEngine``) and
writes the embedding back, which the search service indexes from the
storage event; ``_on_embedded`` hands the node to
``InferenceEngine.on_store``, whose similarity lookup is
``SearchService.vector_candidates`` (the streaming top-k kernel); evidence
that passes the gate becomes a ``SIMILAR_TO`` edge, and a debounced
``recluster`` refits the IVF layout after a burst. ``recall`` is a hybrid
search; Heimdall's chat and ``graphrag()`` generate through the paged-KV
``GenerationEngine`` (the ragged attention kernel) that ``_wire_genserve``
builds over a mounted checkpoint.

Device policy: ``device=None`` means CUDA and raises DeviceUnavailable
without a card; the CPU runs only when the caller passes ``device="cpu"``.
The device goes to the search service, to ``load_generator`` and to the
generation engine. A checkpoint that fails to load (a missing or
malformed file) falls back to ``TemplateGenerator``, as in the JAX
package; DeviceUnavailable and CUDA errors propagate, so a template answer
never hides a dead card.

Cypher: ``cypher`` / ``execute_cypher`` run on ``executor``, a
``CypherExecutor`` on the DB's device over the default database with the
query cache as its result cache; ``executor_for`` keeps one executor per
database (dropped by ``invalidate_database_cache``, which the
``DatabaseManager`` calls on DROP DATABASE and limit changes) and
``session_executor`` makes a fresh one for a session's explicit
transactions. ``cypher_stats`` reads the columnar engine's counters
without building an executor. The GDS and APOC procedures run through
the same executor; their PageRank, components and link-prediction GEMMs
on its device.

``qdrant_registry`` is the one ``QdrantCollections`` of the DB: each
collection's corpus sits on the DB's device behind the device owner's
gate, and the HTTP server's ``/collections*`` routes and the Qdrant gRPC
services share it.

``decay`` is the DB's ``DecayManager`` (host code, as in JAX); with
``Config.decay_enabled`` the DB starts its periodic recalculation at
open and ``close`` stops it. ``temporal`` is a ``TemporalTracker`` made
at first use; from then on ``touch`` (and so ``recall`` and
``remember``) records each access in it. The servers (``server/``) and
``python -m nornicdb_tpu_torch serve`` drive this facade.

Behavioral reference: the upstream NornicDB pkg/nornicdb/db.go (Open :750,
DB :434, Store/Recall/Remember/Link/Neighbors/Forget :1365-1776).
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError
from nornicdb_tpu_torch.multidb import DEFAULT_DB
from nornicdb_tpu_torch.storage import (
    Edge,
    Engine,
    NamespacedEngine,
    Node,
    SchemaManager,
    new_id,
    open_storage,
)
from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)

# what load_generator raises for a missing or malformed checkpoint: the
# template fallback covers these and nothing else (DeviceUnavailable and
# CUDA errors, RuntimeError and torch.cuda.OutOfMemoryError, propagate)
_CHECKPOINT_ERRORS = (OSError, ValueError, KeyError, TypeError)


@dataclass
class Config:
    """DB configuration (ref: pkg/config/config.go:82-420, subset), the JAX
    package's fields and defaults."""

    async_writes: bool = True
    flush_interval: float = 0.05
    wal_sync: bool = False
    # at-rest encryption (ref: db.go:781-809, PBKDF2-derived key)
    encryption_passphrase: str = ""
    # durable engine: wal (memory + WAL replay) | segment (native C++ KV)
    storage_engine: str = "wal"
    auto_compact: bool = False
    auto_compact_interval: float = 300.0
    # embedding
    embed_enabled: bool = True
    embed_dimensions: int = 1024
    embed_chunk_tokens: int = 512
    embed_chunk_overlap: int = 50
    embed_workers: int = 1
    # decay
    decay_enabled: bool = False
    decay_interval: float = 3600.0
    archive_threshold: float = 0.05
    # inference (auto-TLP)
    inference_enabled: bool = True
    similarity_threshold: float = 0.85
    # integration adapters (ref: topology_integration.go,
    # cluster_integration.go)
    topology_integration: bool = False
    cluster_integration: bool = False
    # search
    search_brute_force_max: int = 5000
    # query cache (ref: pkg/cache, ConfigureGlobalCache main.go:320)
    query_cache_enabled: bool = True
    query_cache_size: int = 1000
    query_cache_ttl: float = 60.0
    log_queries: bool = False  # the Cypher executor logs each statement
    feature_flags: dict[str, bool] = field(default_factory=dict)


class DB:
    """The core database handle (ref: nornicdb.DB db.go:434)."""

    def __init__(self, data_dir: str = "", config: Optional[Config] = None,
                 device: DeviceLike = None):
        # resolved before anything is opened: no card, no data directory
        self.device = resolve_device(device)
        self.config = config or Config()
        self.data_dir = data_dir
        self._base_storage: Engine = open_storage(
            data_dir,
            async_writes=self.config.async_writes,
            flush_interval=self.config.flush_interval,
            wal_sync=self.config.wal_sync,
            auto_compact=self.config.auto_compact,
            auto_compact_interval=self.config.auto_compact_interval,
            encryption_passphrase=self.config.encryption_passphrase,
            engine=self.config.storage_engine,
        )
        # the default database is itself a namespace on the shared base
        # engine, like the reference's "nornic" namespace (ref:
        # NamespacedEngine wrap, db.go:896): multi-database views never
        # leak into default-DB scans
        self.default_database = DEFAULT_DB
        self._migrate_unprefixed(self._base_storage, DEFAULT_DB)
        self.storage: Engine = NamespacedEngine(self._base_storage, DEFAULT_DB)
        self.schema = SchemaManager()
        self.schema.attach(self.storage)
        self._lock = threading.RLock()
        self._closed = False
        # attached lazily by subsystem setters
        self._embedder = None
        self._embed_worker = None
        self._search = None
        self._inference = None
        self._dbmanager = None
        self._executor = None
        self._db_executors: dict[str, Any] = {}
        self._query_cache = None
        self._heimdall = None
        self._genserve = None
        self._graphrag = None
        self._vectorspaces = None
        self._qdrant = None
        self._decay = None
        self._decay_started = False
        self._temporal = None
        if self.config.decay_enabled:
            _ = self.decay  # starts the periodic recalculation ticker

    @staticmethod
    def _migrate_unprefixed(base: Engine, namespace: str) -> None:
        """Re-key data persisted before namespacing (bare ids) into the
        default namespace so old data directories keep working."""
        stale_nodes = [n for n in base.all_nodes() if ":" not in n.id]
        if not stale_nodes:
            return
        stale_edges = [e for e in base.all_edges() if ":" not in e.id]
        pending = set(base.pending_embed_ids())
        for e in stale_edges:
            base.delete_edge(e.id)
        for n in stale_nodes:
            base.delete_node(n.id)
        for n in stale_nodes:
            migrated = n.copy()
            migrated.id = f"{namespace}:{n.id}"
            base.create_node(migrated)
            if n.id in pending:
                base.mark_pending_embed(migrated.id)
        for e in stale_edges:
            migrated = e.copy()
            migrated.id = f"{namespace}:{e.id}"
            if ":" not in migrated.start_node:
                migrated.start_node = f"{namespace}:{migrated.start_node}"
            if ":" not in migrated.end_node:
                migrated.end_node = f"{namespace}:{migrated.end_node}"
            base.create_edge(migrated)

    def invalidate_database_cache(self, name: str) -> None:
        """Drop the cached per-database executor after DROP DATABASE or a
        limit change."""
        with self._lock:
            self._db_executors.pop(name, None)

    # -- subsystem wiring --------------------------------------------------
    def set_embedder(self, embedder) -> None:
        """(ref: DB.SetEmbedder db.go:1074): also starts the embed worker."""
        old_engine = self.serving_engine()
        self._embedder = embedder
        if old_engine is not None and old_engine is not self.serving_engine():
            # the replaced chain carried a continuous batching engine:
            # stop its pipeline threads instead of leaking them
            old_engine.stop()
        if self._search is not None:
            self._search.embedder = embedder
        if self._embed_worker is not None:
            self._embed_worker.stop()
            self._embed_worker = None
        if self.config.embed_enabled and embedder is not None:
            from nornicdb_tpu_torch.embed.queue import (
                EmbedWorker,
                EmbedWorkerConfig,
            )

            self._embed_worker = EmbedWorker(
                # the worker drains the BASE engine, so pending nodes of
                # every database namespace get embedded
                self._base_storage,
                embedder,
                EmbedWorkerConfig(
                    chunk_tokens=self.config.embed_chunk_tokens,
                    chunk_overlap=self.config.embed_chunk_overlap,
                    workers=self.config.embed_workers,
                ),
                # debounced k-means refit after bulk embedding
                # (ref: scheduleClusteringDebounced embed_queue.go:257)
                on_cluster_trigger=lambda: self.search.recluster(),
                # the learning loop: freshly embedded nodes feed auto-TLP
                on_embedded=self._on_embedded,
            )
            self._embed_worker.start()

    def _on_embedded(self, node) -> None:
        # the node comes from the base engine with a namespaced id;
        # auto-TLP runs over the default database only
        prefix = f"{self.default_database}:"
        if self.config.inference_enabled and node.id.startswith(prefix):
            bare = node.copy()
            bare.id = node.id[len(prefix):]
            self.inference.on_store(bare)

    @property
    def embedder(self):
        return self._embedder

    def serving_engine(self):
        """The continuous batching ServingEngine in the embedder chain
        (``CachedEmbedder(ServingEngine(inner))`` is the serving stack), or
        None when embedding is not engine-fronted."""
        from nornicdb_tpu_torch.serving import ServingEngine

        e = self._embedder
        seen = 0
        while e is not None and seen < 8:
            if isinstance(e, ServingEngine):
                return e
            e = getattr(e, "inner", None)
            seen += 1
        return None

    @property
    def search(self):
        """The hybrid SearchService over the default database on the DB's
        device, built, attached to storage events and backfilled on first
        use. Built OUTSIDE the db lock (the backfill takes seconds on a
        large corpus); the loser of a creation race detaches and stops
        its service."""
        with self._lock:
            svc = self._search
        if svc is not None:
            return svc
        from nornicdb_tpu_torch.search.service import SearchService

        svc = SearchService(
            self.storage,
            embedder=self._embedder,
            brute_force_max=self.config.search_brute_force_max,
            vectorspaces=self.vectorspaces,
            device=self.device,
        )
        # wire storage events + backfill existing nodes
        # (ref: db.go:1020-1033, EnsureSearchIndexesBuilt db.go:1044)
        svc.attach(self.storage)
        svc.build_indexes()
        with self._lock:
            if self._search is None:
                self._search = svc
                return svc
            winner = self._search
        svc.detach(self.storage)
        svc.shutdown()
        return winner

    @property
    def vectorspaces(self):
        """Canonical named vector spaces (ref: pkg/vectorspace registry)."""
        with self._lock:
            if self._vectorspaces is None:
                from nornicdb_tpu_torch.vectorspace import VectorSpaceRegistry

                self._vectorspaces = VectorSpaceRegistry()
            return self._vectorspaces

    def qdrant_registry(self):
        """The ONE QdrantCollections registry for this db: every Qdrant
        transport must share it, since per-transport registries would each
        build their own per-collection corpora on the card and drift on
        upserts (ref: the reference's "single unified vector index",
        pkg/qdrantgrpc server.go). Its corpora live on the DB's device.

        Constructed OUTSIDE the db lock (the `search` property's
        pattern): the registry rebuild scans every persisted point and
        builds per-collection corpora, seconds on a large point set, and
        every db-lock user would stall behind it. Losers of the creation
        race discard their registry before it serves anything."""
        with self._lock:
            if self._qdrant is not None:
                return self._qdrant
        from nornicdb_tpu_torch.server.qdrant import QdrantCollections

        registry = QdrantCollections(
            self.storage, vectorspaces=self.vectorspaces, device=self.device
        )
        with self._lock:
            if self._qdrant is None:
                self._qdrant = registry
            return self._qdrant

    @property
    def query_cache(self):
        """The query-result cache, invalidated by every storage mutation
        (store/forget and direct writes, not just Cypher's); the Cypher
        executor reads it."""
        if self._query_cache is None:
            from nornicdb_tpu_torch.cache import QueryCache

            cache = QueryCache(
                capacity=self.config.query_cache_size,
                ttl=self.config.query_cache_ttl,
            )

            def _on_event(kind: str, entity) -> None:
                if isinstance(entity, Node):
                    if entity.labels:
                        cache.invalidate_labels(set(entity.labels))
                    else:
                        cache.clear()
                elif isinstance(entity, Edge):
                    labels: set = set()
                    for nid in (entity.start_node, entity.end_node):
                        try:
                            labels.update(self.storage.get_node(nid).labels)
                        except Exception:
                            # endpoint vanished mid-event: the invalidation
                            # cannot be scoped, so drop everything (sound),
                            # and count it: a hot loop of these is thrash
                            log.debug("query-cache label scope lookup failed "
                                      "for %s; clearing cache", nid,
                                      exc_info=True)
                            count_error("db.query_cache_invalidate")
                            cache.clear()
                            return
                    if labels:
                        cache.invalidate_labels(labels)
                    else:
                        cache.clear()

            self.storage.on_event(_on_event)
            self._query_cache = cache
        return self._query_cache

    @property
    def executor(self):
        """The Cypher executor over the default database, on the DB's
        device, with the query cache as its result cache. Built once under
        the DB lock: concurrent first calls share one executor (and one
        plan cache)."""
        with self._lock:
            if self._executor is None:
                from nornicdb_tpu_torch.cypher.executor import CypherExecutor

                cache = (self.query_cache if self.config.query_cache_enabled
                         else None)
                self._executor = CypherExecutor(
                    self.storage, schema=self.schema, db=self, cache=cache,
                    log_queries=self.config.log_queries, device=self.device,
                )
            return self._executor

    def session_executor(self, database: Optional[str] = None):
        """A FRESH executor with its own explicit-transaction scope, for
        per-connection sessions. Shares storage, schema, facade hooks and
        the query cache (another database's executor shares that database's
        cached schema instead)."""
        from nornicdb_tpu_torch.cypher.executor import CypherExecutor

        if (database and self.database_manager.resolve(database)
                != self.default_database):
            # share the database's CACHED schema: a fresh SchemaManager per
            # session would forget DDL of earlier requests and leak an
            # event subscription and a full scan per session
            base = self.executor_for(database)
            return CypherExecutor(base.storage, schema=base.schema, db=self,
                                  log_queries=self.config.log_queries,
                                  device=self.device)
        cache = self.query_cache if self.config.query_cache_enabled else None
        return CypherExecutor(self.storage, schema=self.schema, db=self,
                              cache=cache,
                              log_queries=self.config.log_queries,
                              device=self.device)

    def executor_for(self, database: str):
        """Per-database Cypher executor over the namespaced engine, cached
        under the RESOLVED name so alias-routed executors die with their
        target database."""
        database = self.database_manager.resolve(database)
        if database == self.default_database:
            return self.executor
        with self._lock:
            ex = self._db_executors.get(database)
            if ex is None:
                from nornicdb_tpu_torch.cypher.executor import CypherExecutor

                storage = self.database_manager.get_storage(database)
                schema = SchemaManager()
                schema.attach(storage)
                ex = CypherExecutor(storage, schema=schema, db=self,
                                    log_queries=self.config.log_queries,
                                    device=self.device)
                self._db_executors[database] = ex
            return ex

    def cypher(self, query: str, params: Optional[dict[str, Any]] = None):
        """Execute a Cypher query (ref: ExecuteCypher db.go)."""
        return self.executor.execute(query, params or {})

    execute_cypher = cypher

    def cypher_stats(self) -> Optional[dict[str, Any]]:
        """Columnar Cypher engine counters (plan-cache hit/miss/
        invalidations and per-outcome query counts), or None before the
        executor exists: stats never force its construction."""
        col = getattr(self._executor, "columnar", None)
        return col.stats_snapshot() if col is not None else None

    @property
    def heimdall(self):
        """The assistant. With a checkpoint mounted
        (``NORNICDB_ASSISTANT_MODEL=<dir>``, as ``train_assistant`` writes
        it) it generates on the DB's device through the engine
        ``_wire_genserve`` builds; without one, or with a checkpoint whose
        files are missing or malformed, the TemplateGenerator answers.
        DeviceUnavailable and CUDA errors propagate."""
        if self._heimdall is None:
            from nornicdb_tpu_torch.heimdall import (
                HeimdallManager,
                TemplateGenerator,
            )

            generator = None
            model_dir = os.environ.get("NORNICDB_ASSISTANT_MODEL", "")
            if model_dir:
                try:
                    from nornicdb_tpu_torch.models.pretrain import (
                        load_generator,
                    )

                    generator = load_generator(model_dir, device=self.device)
                except _CHECKPOINT_ERRORS:  # bad checkpoint: fall back, loudly
                    log.warning(
                        "assistant checkpoint %r failed to load; using "
                        "template generator", model_dir, exc_info=True,
                    )
                    count_error("heimdall.checkpoint_load")
            if generator is None:
                generator = TemplateGenerator(self)
            self._heimdall = HeimdallManager(
                self._wire_genserve(generator), db=self)
        return self._heimdall

    def set_heimdall_generator(self, generator) -> None:
        from nornicdb_tpu_torch.heimdall import HeimdallManager

        self._heimdall = HeimdallManager(
            self._wire_genserve(generator), db=self)

    def _wire_genserve(self, generator):
        """Front a weights-backed generator with the continuous-batching
        GenerationEngine on the DB's device (paged KV, admission control,
        deadline shedding). Template and stub generators pass through
        unchanged; so does ``GenServeConfig.enabled=False`` (the
        synchronous per-request path stays the escape hatch)."""
        if self._genserve is not None:
            self._genserve.stop()
            self._genserve = None
        self._graphrag = None  # rebuilt against the new engine on demand
        if not all(hasattr(generator, a)
                   for a in ("params", "cfg", "tokenizer")):
            return generator
        from nornicdb_tpu_torch import genserve

        gcfg = genserve.current_config()
        if not gcfg.enabled:
            return generator
        from nornicdb_tpu_torch.heimdall import EngineGenerator

        self._genserve = genserve.GenerationEngine(
            generator.params, generator.cfg,
            tokenizer=generator.tokenizer, config=gcfg, device=self.device)
        return EngineGenerator(
            self._genserve,
            max_context=getattr(generator, "max_context", 256))

    def genserve_engine(self):
        """The generation engine behind Heimdall, or None when generation
        is template-backed or disabled (observability must not force the
        assistant to build)."""
        return self._genserve

    def graphrag(self):
        """GraphRAG answers over this DB's search, adjacency and generation
        engine. Cached: the service resolves its config once."""
        if self._graphrag is None:
            from nornicdb_tpu_torch.genserve import GraphRAGService

            _ = self.heimdall  # builds the engine when weights exist
            self._graphrag = GraphRAGService(self, engine=self._genserve)
        return self._graphrag

    @property
    def decay(self):
        """The DecayManager over the default database, with the config's
        ``archive_threshold`` and ``decay_interval``; its ticker runs when
        ``decay_enabled`` (ref: decay.Start decay.go:643)."""
        with self._lock:
            if self._decay is None:
                from nornicdb_tpu_torch.decay.decay import (
                    DecayConfig,
                    DecayManager,
                )

                self._decay = DecayManager(
                    self.storage,
                    config=DecayConfig(
                        archive_threshold=self.config.archive_threshold,
                        interval=self.config.decay_interval,
                    ),
                )
            if self.config.decay_enabled and not self._decay_started:
                self._decay.start()
                self._decay_started = True
            return self._decay

    @property
    def temporal(self):
        """The TemporalTracker that ``touch`` feeds once it exists."""
        with self._lock:
            if self._temporal is None:
                from nornicdb_tpu_torch.temporal.tracker import TemporalTracker

                self._temporal = TemporalTracker()
            return self._temporal

    @property
    def inference(self):
        """The auto-TLP InferenceEngine over the default database, its
        similarity lookup the search service's vector leg."""
        if self._inference is None:
            from nornicdb_tpu_torch.inference.engine import InferenceEngine

            engine = InferenceEngine(
                self.storage,
                similarity_fn=self._similarity_candidates,
                similarity_threshold=self.config.similarity_threshold,
            )
            if self.config.topology_integration:
                from nornicdb_tpu_torch.inference.integrations import (
                    TopologyIntegration,
                )

                TopologyIntegration(self.storage).attach(engine)
            if self.config.cluster_integration:
                from nornicdb_tpu_torch.inference.integrations import (
                    ClusterIntegration,
                )

                ClusterIntegration(
                    lambda: self.search.cluster_assignments
                ).attach(engine)
            self._inference = engine
        return self._inference

    @property
    def database_manager(self):
        """(ref: multidb.NewDatabaseManager cmd/nornicdb/main.go:501)"""
        with self._lock:
            if self._dbmanager is None:
                from nornicdb_tpu_torch.multidb import DatabaseManager

                self._dbmanager = DatabaseManager(
                    self._base_storage,
                    on_invalidate=self.invalidate_database_cache,
                )
            return self._dbmanager

    def _similarity_candidates(self, embedding, k: int = 10):
        return self.search.vector_candidates(embedding, k=k)

    # -- memory-centric API (ref: db.go:1365-1776) --------------------------
    def store(
        self,
        content: str,
        *,
        labels: Optional[list[str]] = None,
        properties: Optional[dict[str, Any]] = None,
        memory_type: str = "semantic",
        node_id: Optional[str] = None,
    ) -> Node:
        """Store a memory node; queues it for auto-embedding (ref: Store
        db.go:1365)."""
        props = dict(properties or {})
        props.setdefault("content", content)
        node = Node(
            id=node_id or new_id(),
            labels=list(labels or ["Memory"]),
            properties=props,
            memory_type=memory_type,
        )
        created = self.storage.create_node(node)
        if self.config.embed_enabled:
            self.storage.mark_pending_embed(created.id)
        if self.config.inference_enabled and self._inference is not None:
            self._inference.on_store(created)
        return created

    def recall(self, query: str, limit: int = 10) -> list[dict[str, Any]]:
        """Hybrid search over stored memories; each hit is touched."""
        results = self.search.search(query, limit=limit)
        for r in results:
            self.touch(r["id"])
        return results

    def remember(self, node_id: str) -> Node:
        """Fetch and reinforce a memory; feeds the co-access inference."""
        node = self.touch(node_id)
        if self.config.inference_enabled:
            self.inference.on_access(node_id)
        return node

    def touch(self, node_id: str) -> Node:
        """Record an access: bump access_count and last_accessed."""
        node = self.storage.get_node(node_id)
        node.access_count += 1
        node.last_accessed = time.time()
        if self._temporal is not None:
            self._temporal.record_access(node_id)
        return self.storage.update_node(node)

    def link(
        self,
        from_id: str,
        to_id: str,
        rel_type: str = "RELATED_TO",
        *,
        properties: Optional[dict[str, Any]] = None,
        confidence: float = 1.0,
        auto_generated: bool = False,
    ) -> Edge:
        edge = Edge(
            start_node=from_id,
            end_node=to_id,
            type=rel_type,
            properties=dict(properties or {}),
            confidence=confidence,
            auto_generated=auto_generated,
        )
        return self.storage.create_edge(edge)

    def neighbors(self, node_id: str, depth: int = 1) -> list[Node]:
        """BFS neighbourhood over both directions."""
        seen = {node_id}
        frontier = [node_id]
        out: list[Node] = []
        for _ in range(depth):
            nxt: list[str] = []
            for nid in frontier:
                for e in self.storage.get_outgoing_edges(nid):
                    if e.end_node not in seen:
                        seen.add(e.end_node)
                        nxt.append(e.end_node)
                for e in self.storage.get_incoming_edges(nid):
                    if e.start_node not in seen:
                        seen.add(e.start_node)
                        nxt.append(e.start_node)
            out.extend(self.storage.batch_get_nodes(nxt))
            frontier = nxt
        return out

    def forget(self, node_id: str) -> None:
        """Delete a node; its index entries go with the node_deleted event."""
        self.storage.delete_node(node_id)

    # -- maintenance -------------------------------------------------------
    def process_pending_embeddings(self, batch: int = 0) -> int:
        """Synchronously drain the pending-embed queue (test/CLI hook)."""
        if self._embed_worker is None:
            return 0
        return self._embed_worker.drain(batch)

    def flush(self) -> None:
        self.storage.flush()

    def wal_stats(self) -> Optional[dict[str, Any]]:
        """WAL health incl. the degraded-mode flag, or None when the store
        has no WAL (in-memory or segment engine)."""
        eng = self._base_storage
        while eng is not None:
            wal = getattr(eng, "wal", None)
            if wal is not None:
                return dict(vars(wal.stats))
            eng = getattr(eng, "base", None)
        return None

    def adjacency_stats(self) -> Optional[dict[str, Any]]:
        """CSR adjacency snapshot counters, or None before a traversal or
        graph offload attaches one."""
        snap = getattr(self.storage, "_adjacency_snapshot", None)
        return snap.stats_snapshot() if snap is not None else None

    # -- backup / restore (ref: badger_backup.go, db_admin.go) --------------
    def backup(self, dest_path: Optional[str] = None) -> str:
        """Full-fidelity gzip backup of the BASE engine (every database
        namespace, with embeddings, decay and access state) plus the
        default-db schema, in the JAX package's format. Returns the
        archive path."""
        self.flush()
        if dest_path is None:
            bdir = os.path.join(self.data_dir or ".", "backups")
            os.makedirs(bdir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            dest_path = os.path.join(bdir, f"backup-{stamp}.json.gz")
            seq = 1
            while os.path.exists(dest_path):  # two backups in one second
                dest_path = os.path.join(
                    bdir, f"backup-{stamp}-{seq}.json.gz")
                seq += 1
        nodes = [n.to_dict() for n in self._base_storage.all_nodes()]
        node_ids = {n["id"] for n in nodes}
        # the two passes are not one atomic snapshot: drop edges whose
        # endpoints missed the node pass, so the archive is consistent
        edges = [
            e.to_dict() for e in self._base_storage.all_edges()
            if e.start_node in node_ids and e.end_node in node_ids
        ]
        payload = {
            "version": 1,
            "nodes": nodes,
            "edges": edges,
            "pending_embed": list(self._base_storage.pending_embed_ids()),
            "schema": {
                "indexes": [
                    {"name": i.name, "kind": i.kind, "label": i.label,
                     "properties": list(i.properties),
                     "options": dict(i.options)}
                    for i in self.schema.list_indexes()
                ],
                "constraints": [
                    {"name": c.name, "label": c.label,
                     "properties": list(c.properties), "kind": c.kind}
                    for c in self.schema.list_constraints()
                ],
            },
        }
        tmp = dest_path + ".tmp"
        with gzip.open(tmp, "wt") as f:
            json.dump(payload, f)
        os.replace(tmp, dest_path)  # a torn backup must never look complete
        return dest_path

    def restore(self, src_path: str, skip_existing: bool = True) -> dict:
        """Load a backup archive into the base engine. Existing records are
        kept (skip_existing) or raise; returns counts."""
        with gzip.open(src_path, "rt") as f:
            payload = json.load(f)
        # DDL first so the index value-maps exist while data loads
        sch = payload.get("schema", {})
        for i in sch.get("indexes", []):
            self.schema.create_index(i["name"], i["kind"], i["label"],
                                     i["properties"], i.get("options"),
                                     if_not_exists=True)
        for c in sch.get("constraints", []):
            self.schema.create_constraint(c["name"], c["label"],
                                          c["properties"],
                                          c.get("kind", "unique"),
                                          if_not_exists=True)
        n_nodes = n_edges = skipped_edges = 0
        for nd in payload.get("nodes", []):
            try:
                self._base_storage.create_node(Node.from_dict(nd))
                n_nodes += 1
            except AlreadyExistsError:
                if not skip_existing:
                    raise
        for ed in payload.get("edges", []):
            try:
                self._base_storage.create_edge(Edge.from_dict(ed))
                n_edges += 1
            except AlreadyExistsError:
                if not skip_existing:
                    raise
            except NotFoundError:
                skipped_edges += 1  # dangling edge in a foreign archive
        for nid in payload.get("pending_embed", []):
            self._base_storage.mark_pending_embed(nid)
        # restored records arrive through the base engine, not the
        # default-DB view's events: backfill the schema maps (idempotent)
        for n in self.storage.all_nodes():
            self.schema.index_node(n)
        # a live DatabaseManager caches the database list in memory; an
        # archive can introduce new databases (system-DB metadata nodes)
        if self._dbmanager is not None:
            self._dbmanager._load_metadata()
        out = {"nodes": n_nodes, "edges": n_edges}
        if skipped_edges:
            out["skipped_edges"] = skipped_edges
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._embed_worker is not None:
            self._embed_worker.stop()
        engine = self.serving_engine()
        if engine is not None:
            # queued embed requests fail fast with ClosedError instead of
            # stranding callers
            engine.stop()
        if self._decay is not None:
            self._decay.stop()
        if self._search is not None:
            # the write-behind uploader and the batcher's dispatcher
            self._search.shutdown()
        if self._genserve is not None:
            # queued and running generations fail fast with ClosedError
            self._genserve.stop()
        self._base_storage.close()

    def __enter__(self) -> "DB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open(data_dir: str = "", config: Optional[Config] = None,  # noqa: A001
         device: DeviceLike = None) -> DB:
    """Open a database (ref: nornicdb.Open db.go:750); ``device=None``
    means CUDA."""
    return DB(data_dir, config, device=device)
