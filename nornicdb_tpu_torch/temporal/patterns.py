"""Access-pattern detection (ref: pkg/temporal/pattern_detector.go).

Detects daily / weekly / burst / growing / decaying access patterns per
node from hour-of-day and day-of-week histograms plus the Kalman access
velocity. Confidence for periodic patterns is concentration of the
histogram relative to uniform (4x concentration = full confidence,
pattern_detector.go:220-230).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional

PATTERN_NONE = "none"
PATTERN_DAILY = "daily"
PATTERN_WEEKLY = "weekly"
PATTERN_BURST = "burst"
PATTERN_DECAYING = "decaying"
PATTERN_GROWING = "growing"


@dataclass
class DetectedPattern:
    type: str
    confidence: float
    peak_hour: int = 0  # 0-23, daily patterns
    peak_day: int = 0  # 0-6 (Sunday=0), weekly patterns
    period: float = 0.0  # seconds
    last_seen: float = 0.0


@dataclass
class PatternDetectorConfig:
    """(ref: DefaultPatternDetectorConfig pattern_detector.go:86)"""

    min_samples_for_pattern: int = 10
    daily_confidence_threshold: float = 0.3
    weekly_confidence_threshold: float = 0.4
    burst_window_seconds: float = 60.0
    burst_min_accesses: int = 5
    growth_threshold: float = 0.05
    decay_threshold: float = -0.05


@dataclass
class _NodeData:
    hour_counts: list[int] = field(default_factory=lambda: [0] * 24)
    day_counts: list[int] = field(default_factory=lambda: [0] * 7)
    recent: deque = field(default_factory=lambda: deque(maxlen=256))
    total: int = 0


class PatternDetector:
    """(ref: PatternDetector pattern_detector.go:99)"""

    def __init__(self, config: Optional[PatternDetectorConfig] = None):
        self.config = config or PatternDetectorConfig()
        self._nodes: dict[str, _NodeData] = {}
        self._lock = threading.Lock()

    def record_access(self, node_id: str, ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        dt = datetime.fromtimestamp(ts, timezone.utc)
        with self._lock:
            data = self._nodes.setdefault(node_id, _NodeData())
            data.hour_counts[dt.hour] += 1
            # Sunday=0 convention (Go time.Weekday); Python Monday=0
            data.day_counts[(dt.weekday() + 1) % 7] += 1
            data.recent.append(ts)
            data.total += 1

    def detect_patterns(self, node_id: str,
                        velocity: float = 0.0) -> list[DetectedPattern]:
        """(ref: DetectPatterns :165) — all patterns passing thresholds,
        most confident first."""
        with self._lock:
            data = self._nodes.get(node_id)
            if data is None or data.total < self.config.min_samples_for_pattern:
                # below the sample gate NOTHING is reported, trends
                # included (ref: DetectPatterns :170-172 returns nil)
                return []
            out = []
            daily = self._daily(data)
            if daily is not None:
                out.append(daily)
            weekly = self._weekly(data)
            if weekly is not None:
                out.append(weekly)
            burst = self._burst(data)
            if burst is not None:
                out.append(burst)
        out.extend(self._trend_only(velocity))
        return sorted(out, key=lambda p: -p.confidence)

    def has_pattern(self, node_id: str, pattern_type: str,
                    velocity: float = 0.0) -> bool:
        return any(p.type == pattern_type
                   for p in self.detect_patterns(node_id, velocity))

    def peak_access_time(self, node_id: str) -> tuple[int, int, float]:
        """(hour, day, confidence) of the node's access concentration
        (ref: GetPeakAccessTime :344)."""
        with self._lock:
            data = self._nodes.get(node_id)
            if data is None or data.total == 0:
                return -1, -1, 0.0  # no-data sentinel (ref: :350)
            hour = max(range(24), key=lambda h: data.hour_counts[h])
            day = max(range(7), key=lambda d: data.day_counts[d])
            conf = self._concentration(data.hour_counts[hour], data.total, 24)
            return hour, day, conf

    # -- detectors ----------------------------------------------------------
    @staticmethod
    def _concentration(max_count: int, total: int, bins: int,
                       divisor: float = 3.0) -> float:
        """(ref: pattern_detector.go:220,260) — daily: 4x uniform
        concentration = full confidence (divisor 3); weekly: 3x = full
        (divisor 2)."""
        if total == 0:
            return 0.0
        expected = total / bins
        return min(max((max_count / expected - 1.0) / divisor, 0.0), 1.0)

    def _daily(self, data: _NodeData) -> Optional[DetectedPattern]:
        peak = max(range(24), key=lambda h: data.hour_counts[h])
        conf = self._concentration(data.hour_counts[peak], data.total, 24)
        if conf < self.config.daily_confidence_threshold:
            return None
        return DetectedPattern(PATTERN_DAILY, conf, peak_hour=peak,
                               period=86400.0, last_seen=time.time())

    def _weekly(self, data: _NodeData) -> Optional[DetectedPattern]:
        peak = max(range(7), key=lambda d: data.day_counts[d])
        conf = self._concentration(data.day_counts[peak], data.total, 7,
                                   divisor=2.0)
        if conf < self.config.weekly_confidence_threshold:
            return None
        return DetectedPattern(PATTERN_WEEKLY, conf, peak_day=peak,
                               period=7 * 86400.0, last_seen=time.time())

    def _burst(self, data: _NodeData) -> Optional[DetectedPattern]:
        if not data.recent:
            return None
        # anchored at NOW (ref: pattern_detector.go:296): a burst that
        # ended long ago must stop being reported once its window passes
        # wall clock on purpose: `recent` holds caller-supplied event
        # timestamps (epoch seconds), so the window must be anchored there
        cutoff = time.time() - self.config.burst_window_seconds
        in_window = sum(1 for t in data.recent if t >= cutoff)
        if in_window < self.config.burst_min_accesses:
            return None
        conf = min(in_window / (2.0 * self.config.burst_min_accesses), 1.0)
        return DetectedPattern(PATTERN_BURST, conf,
                               period=self.config.burst_window_seconds,
                               last_seen=data.recent[-1])

    def _trend_only(self, velocity: float) -> list[DetectedPattern]:
        """(ref: detectTrendPattern :323)"""
        if velocity > self.config.growth_threshold:
            conf = min(velocity / 0.5, 1.0)  # ref: detectTrendPattern :330
            return [DetectedPattern(PATTERN_GROWING, conf,
                                    last_seen=time.time())]
        if velocity < self.config.decay_threshold:
            conf = min(abs(velocity) / 0.5, 1.0)
            return [DetectedPattern(PATTERN_DECAYING, conf,
                                    last_seen=time.time())]
        return []
