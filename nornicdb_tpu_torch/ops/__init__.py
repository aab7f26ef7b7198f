"""Device ops of the port: similarity, top-k and the hand-written CUDA
kernels (counterpart of ``nornicdb_tpu.ops``; k-means, IVF and the fused
cosine kernel are still to be ported)."""

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
]
