"""GDS-compatible link prediction (ref: the upstream NornicDB pkg/linkpredict/),
counterpart of ``nornicdb_tpu.linkpredict``."""

from nornicdb_tpu_torch.linkpredict.topology import (
    SCORERS,
    Graph,
    HybridConfig,
    batch_scores,
    build_graph,
    hybrid_score,
    score_pair,
    top_candidates,
)

__all__ = [
    "SCORERS", "Graph", "HybridConfig", "batch_scores", "build_graph",
    "hybrid_score", "score_pair", "top_candidates",
]
