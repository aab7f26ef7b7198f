"""Query-load tracking + relationship evolution.

Behavioral reference: the upstream NornicDB pkg/temporal/query_load.go (query-rate
tracking windows) and relationship_evolution.go (edge strength evolving with
co-access; decaying unused relationships).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from nornicdb_tpu_torch.filter.kalman import LATENCY, Kalman
from nornicdb_tpu_torch.storage.types import Engine
from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)


class QueryLoadTracker:
    """Sliding-window QPS + Kalman-smoothed latency (ref: query_load.go)."""

    def __init__(self, window: float = 60.0,
                 now_fn: Callable[[], float] = time.time):
        self.window = window
        self.now = now_fn
        self._lock = threading.Lock()
        self._events: deque[tuple[float, float]] = deque()  # (ts, latency)
        self._latency = Kalman(LATENCY)
        self.total = 0

    def record(self, latency: float = 0.0) -> None:
        ts = self.now()
        with self._lock:
            self._events.append((ts, latency))
            self.total += 1
            if latency > 0:
                self._latency.process(latency)
            self._trim(ts)

    def _trim(self, now: float) -> None:
        while self._events and now - self._events[0][0] > self.window:
            self._events.popleft()

    def qps(self) -> float:
        with self._lock:
            now = self.now()
            self._trim(now)
            if not self._events:
                return 0.0
            # denominator is the observation span, floored at 1s so sparse
            # traffic doesn't report absurd rates (1 query "in 1ns")
            span = min(max(now - self._events[0][0], 1.0), self.window)
            return len(self._events) / span

    def smoothed_latency(self) -> Optional[float]:
        with self._lock:
            return self._latency.predict() if self._latency.initialized else None

    def stats(self) -> dict:
        return {
            "qps": round(self.qps(), 3),
            "total": self.total,
            "smoothed_latency": self.smoothed_latency(),
        }


class EdgeStrengthEvolver:
    """Evolve auto-generated edge strength with use; decay the unused —
    the STORAGE side of relationship evolution (ref:
    relationship_evolution.go edge maintenance); trend tracking and
    prediction live in temporal.evolution.RelationshipEvolution."""

    def __init__(self, storage: Engine, strengthen: float = 0.05,
                 decay: float = 0.01, now_fn: Callable[[], float] = time.time):
        self.storage = storage
        self.strengthen_step = strengthen
        self.decay_step = decay
        self.now = now_fn

    def on_traversal(self, edge_id: str) -> float:
        """An edge used by a query gets stronger."""
        edge = self.storage.get_edge(edge_id)
        edge.confidence = min(edge.confidence + self.strengthen_step, 1.0)
        edge.access_count += 1
        self.storage.update_edge(edge)
        return edge.confidence

    def decay_pass(self, min_confidence: float = 0.05) -> dict[str, int]:
        """Weaken every auto-generated edge; remove the ones that fade out."""
        weakened = removed = 0
        for edge in list(self.storage.all_edges()):
            if not edge.auto_generated:
                continue
            edge.confidence = max(edge.confidence - self.decay_step, 0.0)
            if edge.confidence < min_confidence:
                try:
                    self.storage.delete_edge(edge.id)
                    removed += 1
                except Exception:
                    # raced a concurrent delete, most likely; the edge is
                    # gone either way — but count it so a systematically
                    # failing decay pass is visible
                    log.debug("decay delete of edge %s failed", edge.id,
                              exc_info=True)
                    count_error("temporal.decay_delete")
            else:
                self.storage.update_edge(edge)
                weakened += 1
        return {"weakened": weakened, "removed": removed}
