"""Relationship-strength evolution (ref: pkg/temporal/relationship_evolution.go).

Tracks edge weights through a Kalman velocity filter so the system can
answer "is this relationship strengthening or weakening, and where will
it be in N steps?" — the signal auto-TLP and decay use to prioritize
edge maintenance.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from nornicdb_tpu_torch.filter.kalman import KalmanConfig, VelocityKalman


@dataclass
class RelationshipTrend:
    """(ref: RelationshipTrend relationship_evolution.go:78)"""

    source: str
    target: str
    direction: str  # strengthening / weakening / stable / unknown
    velocity: float
    current_strength: float
    predicted_strength: float  # 5 steps ahead
    confidence: float
    observation_count: int
    last_update: float


@dataclass
class RelationshipConfig:
    """(ref: DefaultRelationshipConfig relationship_evolution.go:126)"""

    max_tracked: int = 10_000  # LRU eviction bound
    strengthen_threshold: float = 0.01
    weaken_threshold: float = -0.01
    min_observations_for_trend: int = 3
    decay_idle: bool = True  # reference default (relationship_evolution.go)
    idle_decay_rate: float = 0.01  # weight lost per hour idle


class _EdgeTracker:
    __slots__ = ("filter", "observations", "last_weight", "last_update",
                 "first_update")

    def __init__(self):
        self.filter = VelocityKalman(KalmanConfig())
        self.observations = 0
        self.last_weight = 0.0
        self.last_update = 0.0
        self.first_update = 0.0

    @property
    def velocity_per_step(self) -> float:
        """Kalman velocity (weight/second) scaled by the mean observation
        spacing, so thresholds stay cadence-independent (the reference's
        thresholds assume per-step velocities)."""
        if self.observations < 2 or self.last_update <= self.first_update:
            return 0.0
        mean_dt = (self.last_update - self.first_update) / (self.observations - 1)
        return self.filter.velocity * mean_dt


def _edge_key(source: str, target: str) -> tuple[str, str]:
    # undirected co-access: (a,b) and (b,a) are one relationship
    return (source, target) if source <= target else (target, source)


class RelationshipEvolution:
    """(ref: RelationshipEvolution relationship_evolution.go:146)"""

    def __init__(self, config: Optional[RelationshipConfig] = None):
        self.config = config or RelationshipConfig()
        self._edges: OrderedDict[tuple, _EdgeTracker] = OrderedDict()
        self._lock = threading.Lock()

    def record_co_access(self, source: str, target: str,
                         weight: float = 1.0,
                         ts: Optional[float] = None) -> None:
        """(ref: RecordCoAccess/RecordCoAccessAt :200-240) — each co-access
        feeds the accumulated weight through the velocity filter."""
        ts = time.time() if ts is None else ts
        with self._lock:
            tracker = self._get_or_create(source, target)
            new_weight = tracker.last_weight
            if self.config.decay_idle and tracker.last_update:
                idle_h = max(ts - tracker.last_update, 0.0) / 3600.0
                new_weight = max(
                    new_weight - idle_h * self.config.idle_decay_rate, 0.0)
            new_weight += weight
            self._observe(tracker, new_weight, ts)

    def update_weight(self, source: str, target: str, new_weight: float,
                      ts: Optional[float] = None) -> None:
        """(ref: UpdateWeight :241) — absolute weight observation."""
        ts = time.time() if ts is None else ts
        with self._lock:
            tracker = self._get_or_create(source, target)
            self._observe(tracker, float(new_weight), ts)

    def get_trend(self, source: str, target: str
                  ) -> Optional[RelationshipTrend]:
        with self._lock:
            tracker = self._edges.get(_edge_key(source, target))
            if tracker is None:
                return None
            return self._trend(source, target, tracker)

    def predict_strength(self, source: str, target: str,
                         steps: int = 5) -> float:
        with self._lock:
            tracker = self._edges.get(_edge_key(source, target))
            if tracker is None:
                return 0.0
            return self._predict(tracker, steps)

    def strengthening(self, limit: int = 10) -> list[RelationshipTrend]:
        """(ref: GetStrengtheningRelationships :306)"""
        return self._ranked("strengthening", limit, descending=True)

    def weakening(self, limit: int = 10) -> list[RelationshipTrend]:
        return self._ranked("weakening", limit, descending=False)

    # -- internals ----------------------------------------------------------
    def _get_or_create(self, source: str, target: str) -> _EdgeTracker:
        key = _edge_key(source, target)
        tracker = self._edges.get(key)
        if tracker is None:
            tracker = _EdgeTracker()
            self._edges[key] = tracker
            while len(self._edges) > self.config.max_tracked:
                self._edges.popitem(last=False)  # LRU eviction
        else:
            self._edges.move_to_end(key)
        return tracker

    def _observe(self, tracker: _EdgeTracker, weight: float,
                 ts: float) -> None:
        tracker.last_weight = tracker.filter.process(weight, ts)
        if tracker.observations == 0:
            tracker.first_update = ts
        tracker.observations += 1
        tracker.last_update = ts

    def _predict(self, tracker: _EdgeTracker, steps: int) -> float:
        # one "step" is the tracker's mean observation spacing
        return max(
            tracker.last_weight + tracker.velocity_per_step * steps, 0.0)

    def _trend(self, source: str, target: str,
               tracker: _EdgeTracker) -> RelationshipTrend:
        v = tracker.velocity_per_step
        if tracker.observations < self.config.min_observations_for_trend:
            direction = "unknown"
        elif v > self.config.strengthen_threshold:
            direction = "strengthening"
        elif v < self.config.weaken_threshold:
            direction = "weakening"
        else:
            direction = "stable"
        confidence = tracker.observations / (tracker.observations + 10)
        return RelationshipTrend(
            source=source, target=target, direction=direction, velocity=v,
            current_strength=tracker.last_weight,
            predicted_strength=self._predict(tracker, 5),
            confidence=confidence,
            observation_count=tracker.observations,
            last_update=tracker.last_update,
        )

    def _ranked(self, direction: str, limit: int,
                descending: bool) -> list[RelationshipTrend]:
        with self._lock:
            trends = [self._trend(k[0], k[1], t)
                      for k, t in self._edges.items()]
        out = [t for t in trends if t.direction == direction]
        out.sort(key=lambda t: t.velocity, reverse=descending)
        return out[:limit]
