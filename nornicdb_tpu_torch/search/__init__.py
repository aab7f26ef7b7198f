"""Search of the port: the vector path of the JAX package's search service."""

from nornicdb_tpu_torch.search.batcher import BatcherStats, QueryBatcher
from nornicdb_tpu_torch.search.service import (
    SearchConfig,
    SearchService,
    SearchStats,
)

__all__ = [
    "BatcherStats",
    "QueryBatcher",
    "SearchConfig",
    "SearchService",
    "SearchStats",
]
