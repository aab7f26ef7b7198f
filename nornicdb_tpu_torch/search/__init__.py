"""Search of the port: the JAX package's hybrid search service (device
vector search, BM25, RRF fusion, cross-encoder rerank, MMR, the ranked
result cache), its batcher, IVF tuner and host HNSW index."""

from nornicdb_tpu_torch.search.batcher import BatcherStats, QueryBatcher
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.fusion import (
    adaptive_rrf_weights,
    apply_mmr,
    fuse_rrf,
)
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
from nornicdb_tpu_torch.search.rerank import CrossEncoderReranker
from nornicdb_tpu_torch.search.service import (
    SearchConfig,
    SearchService,
    SearchStats,
    configure_defaults,
    default_search_config,
)
from nornicdb_tpu_torch.search.tuner import IVFTuner, TuneState

__all__ = [
    "BM25Index",
    "BatcherStats",
    "CrossEncoderReranker",
    "HNSWIndex",
    "IVFTuner",
    "QueryBatcher",
    "SearchConfig",
    "SearchService",
    "SearchStats",
    "TuneState",
    "adaptive_rrf_weights",
    "configure_defaults",
    "default_search_config",
    "apply_mmr",
    "fuse_rrf",
]
