"""Per-node temporal access tracking.

Behavioral reference: the upstream NornicDB pkg/temporal/tracker.go:216 (Tracker,
RecordAccess :419, PredictNextAccess :521), session.go (session boundary
detection), pattern_detector.go (co-access patterns), query_load.go.
Ring-buffer histories + Kalman-filtered access-rate velocity.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from nornicdb_tpu_torch.filter.kalman import CO_ACCESS, Kalman, VelocityKalman


@dataclass
class TrackerConfig:
    history_size: int = 64  # ring buffer per node
    session_gap: float = 1800.0  # 30 min silence = new session
    co_access_window: float = 60.0  # accesses within 60s are "together"


@dataclass
class AccessRecord:
    node_id: str
    timestamp: float


class SessionDetector:
    """(ref: session.go — boundary when gap > session_gap)"""

    def __init__(self, gap: float = 1800.0):
        self.gap = gap
        self.sessions: list[list[AccessRecord]] = []
        self._current: list[AccessRecord] = []

    def observe(self, rec: AccessRecord) -> bool:
        """Returns True when a new session started."""
        new_session = bool(
            self._current and rec.timestamp - self._current[-1].timestamp > self.gap
        )
        if new_session:
            self.sessions.append(self._current)
            self._current = []
        self._current.append(rec)
        return new_session

    @property
    def current_session(self) -> list[AccessRecord]:
        return list(self._current)


class TemporalTracker:
    """(ref: temporal.Tracker tracker.go:216)"""

    def __init__(
        self,
        config: Optional[TrackerConfig] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        self.config = config or TrackerConfig()
        self.now = now_fn
        self._lock = threading.RLock()
        self._history: dict[str, deque[float]] = {}
        self._rate: dict[str, VelocityKalman] = {}
        self._recent: deque[AccessRecord] = deque(maxlen=4096)
        self.sessions = SessionDetector(self.config.session_gap)
        # co-access counts: (a, b) sorted pair -> count
        self._co_access: dict[tuple[str, str], int] = defaultdict(int)

    # -- recording -------------------------------------------------------------
    def record_access(self, node_id: str, ts: Optional[float] = None) -> None:
        """(ref: RecordAccess tracker.go:419)"""
        ts = self.now() if ts is None else ts
        with self._lock:
            hist = self._history.setdefault(
                node_id, deque(maxlen=self.config.history_size)
            )
            hist.append(ts)
            # access-rate velocity: measure inter-access interval
            if len(hist) >= 2:
                interval = hist[-1] - hist[-2]
                self._rate.setdefault(node_id, VelocityKalman(CO_ACCESS)).process(
                    interval, ts
                )
            rec = AccessRecord(node_id, ts)
            # co-access pairs within the window (ref: pattern_detector.go)
            for other in reversed(self._recent):
                if ts - other.timestamp > self.config.co_access_window:
                    break
                if other.node_id != node_id:
                    pair = tuple(sorted((node_id, other.node_id)))
                    self._co_access[pair] += 1
            self._recent.append(rec)
            self.sessions.observe(rec)

    # -- queries ------------------------------------------------------------------
    def access_count(self, node_id: str) -> int:
        with self._lock:
            return len(self._history.get(node_id, ()))

    def last_access(self, node_id: str) -> Optional[float]:
        with self._lock:
            h = self._history.get(node_id)
            return h[-1] if h else None

    def access_rate(self, node_id: str) -> Optional[float]:
        """Smoothed mean inter-access interval in seconds."""
        with self._lock:
            k = self._rate.get(node_id)
            return k.position if k is not None and k.initialized else None

    def access_rate_trend(self, node_id: str) -> tuple[float, str]:
        """(velocity, trend) (ref: GetAccessRateTrend tracker.go:712) —
        velocity is positive when access is ACCELERATING, dimensionless
        (relative interval change: +1 = intervals halved between the first
        and second half of the history). trend: increasing / decreasing /
        stable. Computed from the raw access history so it stays robust to
        filter tuning."""
        with self._lock:
            hist = self._history.get(node_id)
            if hist is None or len(hist) < 4:
                return 0.0, "stable"
            ts = list(hist)
        intervals = [b - a for a, b in zip(ts, ts[1:])]
        half = len(intervals) // 2
        early = sum(intervals[:half]) / half
        late = sum(intervals[half:]) / (len(intervals) - half)
        if early <= 0 or late <= 0:
            return 0.0, "stable"
        v = early / late - 1.0  # +1 = intervals halved (2x faster access)
        if v > 0.1:
            return min(v, 10.0), "increasing"
        if v < -0.1:
            return max(v, -10.0), "decreasing"
        return v, "stable"

    def predict_next_access(self, node_id: str) -> Optional[float]:
        """(ref: PredictNextAccess tracker.go:521) — last access + predicted
        interval (velocity-extrapolated)."""
        with self._lock:
            h = self._history.get(node_id)
            k = self._rate.get(node_id)
            if not h or k is None or not k.initialized:
                return None
            interval = max(k.predict_at(self.now()), 0.0)
            return h[-1] + interval

    def co_access_pairs(self, min_count: int = 2) -> list[tuple[str, str, int]]:
        """(ref: pattern_detector.go co-access patterns)"""
        with self._lock:
            return sorted(
                (
                    (a, b, c)
                    for (a, b), c in self._co_access.items()
                    if c >= min_count
                ),
                key=lambda t: -t[2],
            )

    def co_accessed_with(self, node_id: str, min_count: int = 1) -> list[tuple[str, int]]:
        with self._lock:
            out = []
            for (a, b), c in self._co_access.items():
                if c < min_count:
                    continue
                if a == node_id:
                    out.append((b, c))
                elif b == node_id:
                    out.append((a, c))
            return sorted(out, key=lambda t: -t[1])
