"""Device ops of the port: similarity, top-k, k-means, IVF and the
hand-written CUDA kernels (counterpart of ``nornicdb_tpu.ops``). The sharded
IVF layout (``ShardedIVFLayout``, ``build_sharded_ivf_layout``) waits for
the sharded corpus."""

from nornicdb_tpu_torch.ops.ivf import IVFLayout, build_ivf_layout, ivf_search
from nornicdb_tpu_torch.ops.kernels import fused_cosine_scores, fused_cosine_topk
from nornicdb_tpu_torch.ops.kmeans import (
    KMeansResult,
    assign_clusters,
    kmeans_fit,
    kmeans_pp_init,
    lloyd,
    nearest_clusters,
    optimal_k,
    pairwise_sq_dists,
)
from nornicdb_tpu_torch.ops.similarity import (
    LANE,
    DeviceCorpus,
    HostCorpus,
    cosine_scores,
    cosine_topk,
    dot_scores,
    euclidean_scores,
    l2_normalize,
    merge_topk,
    pad_to_multiple,
    score_subset,
    topk_backend,
)

__all__ = [
    "LANE",
    "DeviceCorpus",
    "HostCorpus",
    "cosine_scores",
    "cosine_topk",
    "dot_scores",
    "euclidean_scores",
    "l2_normalize",
    "merge_topk",
    "pad_to_multiple",
    "score_subset",
    "topk_backend",
    "IVFLayout",
    "build_ivf_layout",
    "ivf_search",
    "KMeansResult",
    "assign_clusters",
    "kmeans_fit",
    "kmeans_pp_init",
    "lloyd",
    "nearest_clusters",
    "optimal_k",
    "pairwise_sq_dists",
    "fused_cosine_scores",
    "fused_cosine_topk",
]
