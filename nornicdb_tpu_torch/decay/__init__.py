"""Memory decay: the port's copy of ``nornicdb_tpu/decay`` (ref: the
upstream NornicDB pkg/decay/). Host code: no device work."""

from nornicdb_tpu_torch.decay.decay import (
    ARCHIVED_LABEL,
    HALF_LIVES,
    DecayConfig,
    DecayManager,
    DecayStats,
    half_life,
)

__all__ = [
    "ARCHIVED_LABEL", "HALF_LIVES", "DecayConfig", "DecayManager",
    "DecayStats", "half_life",
]
