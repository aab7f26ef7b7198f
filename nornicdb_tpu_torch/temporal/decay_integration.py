"""Temporal-aware decay modulation (ref: pkg/temporal/decay_integration.go).

Combines access-rate velocity, detected patterns, recency, session
membership, and burst state into one smoothed decay-rate multiplier per
node (0.5 = half decay speed, 2.0 = double), with min/max clamps so
nodes can neither become immortal nor die instantly. `DecayManager`
consumes this through its `rate_modifier` hook.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from nornicdb_tpu_torch.filter.kalman import Kalman, KalmanConfig
from nornicdb_tpu_torch.temporal.patterns import (
    PATTERN_BURST,
    PATTERN_DAILY,
    PATTERN_GROWING,
    PATTERN_WEEKLY,
    PatternDetector,
)
from nornicdb_tpu_torch.temporal.tracker import TemporalTracker


@dataclass
class DecayComponent:
    name: str
    multiplier: float
    weight: float


@dataclass
class DecayModifier:
    """(ref: DecayModifier decay_integration.go:68)"""

    multiplier: float
    reason: str
    confidence: float
    components: list[DecayComponent] = field(default_factory=list)


@dataclass
class DecayIntegrationConfig:
    """(ref: DefaultDecayIntegrationConfig decay_integration.go:129)"""

    base_decay_rate: float = 0.01
    frequent_access_boost: float = 0.1  # 10x slower for frequent access
    rare_access_penalty: float = 2.0  # 2x faster for rare access
    daily_pattern_boost: float = 0.5
    burst_boost_duration: float = 300.0
    burst_boost_multiplier: float = 0.1
    session_boost_multiplier: float = 0.2
    min_decay_multiplier: float = 0.05
    max_decay_multiplier: float = 5.0
    velocity_weight: float = 0.4
    pattern_weight: float = 0.3
    recency_weight: float = 0.3


def conservative_decay_config() -> DecayIntegrationConfig:
    """(ref: ConservativeDecayConfig :147) — preserves more memories."""
    cfg = DecayIntegrationConfig()
    cfg.frequent_access_boost = 0.05
    cfg.min_decay_multiplier = 0.02
    cfg.max_decay_multiplier = 2.0
    return cfg


def aggressive_decay_config() -> DecayIntegrationConfig:
    """(ref: AggressiveDecayConfig :156) — forgets faster."""
    cfg = DecayIntegrationConfig()
    cfg.rare_access_penalty = 5.0
    cfg.min_decay_multiplier = 0.2
    cfg.max_decay_multiplier = 10.0
    return cfg


class DecayIntegration:
    """(ref: DecayIntegration decay_integration.go:165)"""

    def __init__(self, config: Optional[DecayIntegrationConfig] = None,
                 tracker: Optional[TemporalTracker] = None,
                 patterns: Optional[PatternDetector] = None):
        self.config = config or DecayIntegrationConfig()
        self.tracker = tracker or TemporalTracker()
        self.patterns = patterns or PatternDetector()
        self._burst_start: dict[str, float] = {}
        self._recent_hits: dict[str, deque] = {}
        self._filters: dict[str, Kalman] = {}
        self._lock = threading.Lock()

    def _now(self) -> float:
        """One clock for the whole integration: the tracker's now_fn, so
        simulated time and historical replays stay coherent."""
        return self.tracker.now()

    def record_access(self, node_id: str,
                      ts: Optional[float] = None) -> None:
        """(ref: RecordAccess :229) — feeds both the tracker and the
        pattern detector, and arms the burst boost when a burst fires."""
        ts = self._now() if ts is None else ts
        self.tracker.record_access(node_id, ts)
        self.patterns.record_access(node_id, ts)
        # burst arming is a direct window count anchored at THIS access —
        # independent of the pattern sample gate, O(window) not O(full
        # detection), and correct for historical timestamps too
        # (ref: RecordAccessAt decay_integration.go:251)
        with self._lock:
            recent = self._recent_hits.setdefault(node_id, deque())
            recent.append(ts)
            cutoff = ts - self.patterns.config.burst_window_seconds
            while recent and recent[0] < cutoff:
                recent.popleft()
            if len(recent) >= self.patterns.config.burst_min_accesses:
                start = self._burst_start.get(node_id)
                if start is None or ts - start >= self.config.burst_boost_duration:
                    # a NEW burst (or one whose boost already expired)
                    # re-arms; an in-flight burst keeps its start so the
                    # boost window is measured from burst onset
                    self._burst_start[node_id] = ts

    def get_decay_modifier(self, node_id: str) -> DecayModifier:
        """(ref: GetDecayModifier :262) — weighted blend of velocity,
        pattern, recency, session, and burst components, clamped and
        Kalman-smoothed."""
        cfg = self.config
        components: list[DecayComponent] = []
        velocity, trend = self.tracker.access_rate_trend(node_id)
        components.append(DecayComponent(
            "velocity", self._velocity_mult(velocity, trend),
            cfg.velocity_weight))

        patterns = self.patterns.detect_patterns(node_id, velocity)
        components.append(DecayComponent(
            "pattern", self._pattern_mult(patterns), cfg.pattern_weight))

        components.append(DecayComponent(
            "recency", self._recency_mult(node_id), cfg.recency_weight))

        # per-node session membership: accessed within the session gap of
        # now (the reference keeps per-node sessions; the tracker's global
        # detector would pin EVERY node in-session under steady load)
        last = self.tracker.last_access(node_id)
        gap = getattr(self.tracker.config, "session_gap", 1800.0)
        in_session = last is not None and (self._now() - last) < gap
        if in_session:
            components.append(DecayComponent(
                "session", cfg.session_boost_multiplier, 0.5))

        with self._lock:
            burst_start = self._burst_start.get(node_id)
            if burst_start is not None:
                if self._now() - burst_start < cfg.burst_boost_duration:
                    components.append(DecayComponent(
                        "burst", cfg.burst_boost_multiplier, 0.3))
                else:
                    del self._burst_start[node_id]  # burst expired

        total_w = sum(c.weight for c in components)
        mult = (sum(c.multiplier * c.weight for c in components) / total_w
                if total_w else 1.0)
        mult = min(max(mult, cfg.min_decay_multiplier),
                   cfg.max_decay_multiplier)
        with self._lock:
            filt = self._filters.setdefault(node_id, Kalman(KalmanConfig()))
            smoothed = filt.process(mult)
        if smoothed > 0:
            mult = min(max(smoothed, cfg.min_decay_multiplier),
                       cfg.max_decay_multiplier)

        import math as _math

        # dominant = furthest from neutral in EITHER direction, so a
        # penalty-driven speedup is named, not reported as "baseline"
        dominant = max(components,
                       key=lambda c: abs(_math.log(max(c.multiplier, 1e-9))))
        if abs(_math.log(max(dominant.multiplier, 1e-9))) < 0.05:
            reason = "baseline"
        else:
            kind = "boost" if dominant.multiplier < 1.0 else "penalty"
            reason = f"{dominant.name} {kind} (x{dominant.multiplier:.2f})"
        count = self.tracker.access_count(node_id)
        confidence = min(count / 20.0, 1.0) if count else 0.1
        return DecayModifier(mult, reason, confidence, components)

    # -- components ---------------------------------------------------------
    def _idle_hours(self, node_id: str) -> float:
        last = self.tracker.last_access(node_id)
        if last is None:
            return float("inf")
        return max(self._now() - last, 0.0) / 3600.0

    def _velocity_mult(self, velocity: float, trend: str) -> float:
        """(ref: calculateVelocityMultiplier :376). velocity is the
        tracker's dimensionless interval derivative, positive when access
        is accelerating; magnitude saturates to [0, 1] so an extreme
        reading only doubles the effect."""
        cfg = self.config
        a = min(abs(velocity), 1.0)
        if trend == "increasing":
            return min(cfg.frequent_access_boost * (1.0 + a), 1.0)
        if trend == "decreasing":
            return cfg.rare_access_penalty * (1.0 + a)
        return 1.0

    def _pattern_mult(self, patterns) -> float:
        """(ref: calculatePatternMultiplier :390) — the strongest boost
        wins; confidence deepens it."""
        best = 1.0
        for p in patterns:
            if p.type == PATTERN_DAILY:
                m = self.config.daily_pattern_boost * (1.0 - p.confidence * 0.5)
            elif p.type == PATTERN_WEEKLY:
                m = self.config.daily_pattern_boost * (1.2 - p.confidence * 0.5)
            elif p.type == PATTERN_GROWING:
                m = self.config.frequent_access_boost * 2.0
            else:
                continue
            best = min(best, m)
        return best

    def _recency_mult(self, node_id: str) -> float:
        idle_h = self._idle_hours(node_id)
        if idle_h == float("inf"):
            return 1.0
        if idle_h < 1.0:
            return 0.5  # accessed within the hour: slow decay
        if idle_h > 24.0 * 7:
            return 2.0  # idle for a week: speed it up
        return 1.0
