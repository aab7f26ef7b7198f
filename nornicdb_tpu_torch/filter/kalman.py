"""1-D Kalman filter library: basic, velocity-state and adaptive-R variants.

Behavioral reference: upstream NornicDB pkg/filter/kalman.go:122 (Kalman),
preset configs :56-107, Process/Predict/PredictWithUncertainty :366-435,
kalman_velocity.go, kalman_adaptive.go. Feature-flag gating mirrors
ProcessIfEnabled.

The port's copy of ``nornicdb_tpu/filter/kalman.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class KalmanConfig:
    """(ref: configs kalman.go:56-107)"""

    process_noise: float = 1e-3  # Q
    measurement_noise: float = 1e-1  # R
    initial_estimate: float = 0.0
    initial_uncertainty: float = 1.0


# Presets (ref: kalman.go preset constructors)
DECAY_PREDICTION = KalmanConfig(process_noise=1e-4, measurement_noise=5e-2)
CO_ACCESS = KalmanConfig(process_noise=1e-3, measurement_noise=1e-1)
LATENCY = KalmanConfig(process_noise=1e-2, measurement_noise=2e-1)


class Kalman:
    """Scalar Kalman filter (ref: filter.Kalman kalman.go:122)."""

    def __init__(self, config: Optional[KalmanConfig] = None):
        self.config = config or KalmanConfig()
        self.estimate = self.config.initial_estimate
        self.uncertainty = self.config.initial_uncertainty
        self.initialized = False
        self.updates = 0

    def process(self, measurement: float) -> float:
        """Predict + update with one measurement (ref: Process :366)."""
        if not self.initialized:
            self.estimate = measurement
            self.uncertainty = self.config.measurement_noise
            self.initialized = True
            self.updates = 1
            return self.estimate
        # predict
        self.uncertainty += self.config.process_noise
        # update
        gain = self.uncertainty / (self.uncertainty + self.config.measurement_noise)
        self.estimate += gain * (measurement - self.estimate)
        self.uncertainty *= 1.0 - gain
        self.updates += 1
        return self.estimate

    def predict(self) -> float:
        return self.estimate

    def predict_with_uncertainty(self) -> tuple[float, float]:
        """(ref: PredictWithUncertainty :435)"""
        return self.estimate, math.sqrt(
            max(self.uncertainty + self.config.process_noise, 0.0)
        )

    def reset(self) -> None:
        self.estimate = self.config.initial_estimate
        self.uncertainty = self.config.initial_uncertainty
        self.initialized = False
        self.updates = 0


class VelocityKalman:
    """Position+velocity state filter for trend tracking
    (ref: kalman_velocity.go)."""

    def __init__(self, config: Optional[KalmanConfig] = None):
        self.config = config or KalmanConfig()
        self.position = 0.0
        self.velocity = 0.0
        # covariance matrix [p00 p01; p10 p11]
        u = self.config.initial_uncertainty
        self.p = [[u, 0.0], [0.0, u]]
        self.initialized = False
        self._last_t: Optional[float] = None

    def process(self, measurement: float, t: float) -> float:
        if not self.initialized:
            self.position = measurement
            self.initialized = True
            self._last_t = t
            return self.position
        dt = max(t - (self._last_t or t), 1e-9)
        self._last_t = t
        q, r = self.config.process_noise, self.config.measurement_noise
        # predict
        self.position += self.velocity * dt
        p = self.p
        p00 = p[0][0] + dt * (p[1][0] + p[0][1]) + dt * dt * p[1][1] + q
        p01 = p[0][1] + dt * p[1][1]
        p10 = p[1][0] + dt * p[1][1]
        p11 = p[1][1] + q
        # update
        s = p00 + r
        k0 = p00 / s
        k1 = p10 / s
        resid = measurement - self.position
        self.position += k0 * resid
        self.velocity += k1 * resid
        self.p = [
            [(1 - k0) * p00, (1 - k0) * p01],
            [p10 - k1 * p00, p11 - k1 * p01],
        ]
        return self.position

    def predict_at(self, t: float) -> float:
        if self._last_t is None:
            return self.position
        return self.position + self.velocity * (t - self._last_t)


class AdaptiveKalman(Kalman):
    """Adaptive measurement-noise variant: R tracks the innovation variance
    (ref: kalman_adaptive.go)."""

    def __init__(self, config: Optional[KalmanConfig] = None, alpha: float = 0.3):
        import dataclasses

        # private copy: this filter mutates measurement_noise, and shared
        # preset configs (DECAY_PREDICTION etc.) must not drift
        super().__init__(dataclasses.replace(config) if config else None)
        self.alpha = alpha

    def process(self, measurement: float) -> float:
        if self.initialized:
            innovation = measurement - self.estimate
            est_r = innovation * innovation - self.uncertainty
            if est_r > 0:
                self.config.measurement_noise = (
                    (1 - self.alpha) * self.config.measurement_noise
                    + self.alpha * est_r
                )
        return super().process(measurement)


def process_if_enabled(
    filt: Kalman, measurement: float, enabled: bool = True
) -> float:
    """(ref: ProcessIfEnabled — feature-flag-gated path)"""
    if not enabled:
        return measurement
    return filt.process(measurement)
