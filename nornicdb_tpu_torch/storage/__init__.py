"""Storage of the port (counterpart of ``nornicdb_tpu.storage``): the node and
edge types and the in-memory engine whose events feed the hybrid search
service. The durable engines (WAL, async write-behind, namespaces) are not
ported."""

from nornicdb_tpu_torch.storage.types import (
    EDGE_CREATED,
    EDGE_DELETED,
    EDGE_UPDATED,
    NODE_CREATED,
    NODE_DELETED,
    NODE_UPDATED,
    Edge,
    Engine,
    EventEmitter,
    MemoryEngine,
    Node,
    new_id,
)

__all__ = [
    "EDGE_CREATED",
    "EDGE_DELETED",
    "EDGE_UPDATED",
    "Edge",
    "Engine",
    "EventEmitter",
    "MemoryEngine",
    "NODE_CREATED",
    "NODE_DELETED",
    "NODE_UPDATED",
    "Node",
    "new_id",
]
