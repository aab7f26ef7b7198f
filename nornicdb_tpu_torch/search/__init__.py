"""Search of the port: the vector path of the JAX package's search service."""

from nornicdb_tpu_torch.search.batcher import BatcherStats, QueryBatcher
from nornicdb_tpu_torch.search.service import (
    SearchConfig,
    SearchService,
    SearchStats,
)
from nornicdb_tpu_torch.search.tuner import IVFTuner, TuneState

__all__ = [
    "BatcherStats",
    "IVFTuner",
    "QueryBatcher",
    "SearchConfig",
    "SearchService",
    "SearchStats",
    "TuneState",
]
