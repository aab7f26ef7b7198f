"""Kalman filter library (ref: upstream NornicDB pkg/filter/).

The port's copy of ``nornicdb_tpu/filter/__init__.py``.
"""

from nornicdb_tpu_torch.filter.kalman import (
    CO_ACCESS,
    DECAY_PREDICTION,
    LATENCY,
    AdaptiveKalman,
    Kalman,
    KalmanConfig,
    VelocityKalman,
    process_if_enabled,
)

__all__ = [
    "CO_ACCESS", "DECAY_PREDICTION", "LATENCY", "AdaptiveKalman",
    "Kalman", "KalmanConfig", "VelocityKalman", "process_if_enabled",
]
