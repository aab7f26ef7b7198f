"""Graph storage engines of the port, counterpart of
``nornicdb_tpu/storage`` (ref: the upstream NornicDB pkg/storage/).

``open_storage`` assembles the chain exactly as the JAX package does, with
its defaults (ref: pkg/nornicdb/db.go:750-914):

    AsyncEngine -> WALEngine -> MemoryEngine (+WAL files)

or, with ``engine="segment"``, the native segment store as the durable
base. ``NamespacedEngine`` and ``multidb.DatabaseManager`` sit in front of
either. ``open_storage("")`` yields a pure in-memory chain (the reference's
Open("") path, db.go:898-913). ``attach_snapshot`` hangs the CSR adjacency
snapshot on an engine; its ``edge_arrays()`` feed the card's PageRank and
WCC, and the engine's events feed the search service's ``DeviceCorpus``.
The WAL, snapshot, segment and salt files are the JAX package's formats,
so a data directory written by one package opens in the other.
"""

from __future__ import annotations

import os
from typing import Optional

from nornicdb_tpu_torch.errors import NornicError
from nornicdb_tpu_torch.storage.adjacency import AdjacencySnapshot, attach_snapshot
from nornicdb_tpu_torch.storage.async_engine import AsyncEngine
from nornicdb_tpu_torch.storage.namespaced import NamespacedEngine
from nornicdb_tpu_torch.storage.schema import (
    INDEX_COMPOSITE,
    INDEX_FULLTEXT,
    INDEX_PROPERTY,
    INDEX_RANGE,
    INDEX_VECTOR,
    ConstraintDef,
    IndexDef,
    SchemaManager,
)
from nornicdb_tpu_torch.storage.types import (
    EDGE_CREATED,
    EDGE_DELETED,
    EDGE_UPDATED,
    EPISODIC,
    NODE_CREATED,
    NODE_DELETED,
    NODE_UPDATED,
    PROCEDURAL,
    SEMANTIC,
    Edge,
    Engine,
    MemoryEngine,
    Node,
    new_id,
)
from nornicdb_tpu_torch.storage.faults import INJECTOR as FAULT_INJECTOR
from nornicdb_tpu_torch.storage.faults import StorageFaultInjector
from nornicdb_tpu_torch.storage.wal import WAL, WALEngine, WALEntry

__all__ = [
    "FAULT_INJECTOR",
    "StorageFaultInjector",
    "AdjacencySnapshot",
    "AsyncEngine",
    "NamespacedEngine",
    "attach_snapshot",
    "SchemaManager",
    "IndexDef",
    "ConstraintDef",
    "INDEX_PROPERTY",
    "INDEX_COMPOSITE",
    "INDEX_FULLTEXT",
    "INDEX_VECTOR",
    "INDEX_RANGE",
    "Edge",
    "Engine",
    "MemoryEngine",
    "Node",
    "new_id",
    "WAL",
    "WALEngine",
    "WALEntry",
    "EPISODIC",
    "SEMANTIC",
    "PROCEDURAL",
    "NODE_CREATED",
    "NODE_UPDATED",
    "NODE_DELETED",
    "EDGE_CREATED",
    "EDGE_UPDATED",
    "EDGE_DELETED",
    "open_storage",
]


def open_storage(
    data_dir: str = "",
    *,
    async_writes: bool = True,
    flush_interval: float = 0.05,
    wal_sync: bool = False,
    auto_compact: bool = False,
    auto_compact_interval: float = 300.0,
    encryption_passphrase: str = "",
    engine: str = "wal",  # wal (memory+WAL replay) | segment (native C++ KV)
) -> Engine:
    """Assemble the storage chain (ref: pkg/nornicdb/db.go:750-914).

    data_dir == "" -> in-memory only (no WAL), mirroring reference Open("").
    engine="segment" uses the native C++ segment store (the BadgerEngine
    role) as the durable base instead of WAL-replayed memory.
    """
    base: Engine = MemoryEngine()
    if data_dir and engine == "segment":
        from nornicdb_tpu_torch.storage.segment import SegmentEngine

        base = SegmentEngine(data_dir, sync=wal_sync,
                             passphrase=encryption_passphrase or None)
    elif data_dir:
        os.makedirs(data_dir, exist_ok=True)
        wal = WAL(os.path.join(data_dir, "wal"), sync=wal_sync,
                  passphrase=encryption_passphrase or None)
        wal.recover(base)
        base = WALEngine(
            base,
            wal,
            auto_compact=auto_compact,
            auto_compact_interval=auto_compact_interval,
        )
    if async_writes:
        base = AsyncEngine(base, flush_interval=flush_interval)
    return base
