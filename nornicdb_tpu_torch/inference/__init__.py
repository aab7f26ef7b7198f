"""Automatic relationship inference (ref: the upstream NornicDB pkg/inference/)."""

from nornicdb_tpu_torch.inference.engine import (
    CO_ACCESSED,
    RELATED_TO,
    SIMILAR_TO,
    InferenceConfig,
    InferenceEngine,
    InferenceStats,
)

__all__ = [
    "CO_ACCESSED", "RELATED_TO", "SIMILAR_TO", "InferenceConfig",
    "InferenceEngine", "InferenceStats",
]
