"""Multi-database support over one storage engine, counterpart of
``nornicdb_tpu/multidb`` (ref: the upstream NornicDB pkg/multidb/)."""

from nornicdb_tpu_torch.multidb.manager import (
    DEFAULT_DB,
    SYSTEM_DB,
    CompositeEngine,
    DatabaseLimits,
    DatabaseManager,
    LimitedEngine,
)

__all__ = [
    "DEFAULT_DB", "SYSTEM_DB", "CompositeEngine", "DatabaseLimits",
    "DatabaseManager", "LimitedEngine",
]
