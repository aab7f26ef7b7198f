"""Three-tier exponential memory decay: the port's copy of
``nornicdb_tpu/decay/decay.py`` (host code, no device work).

Behavioral reference: the upstream NornicDB pkg/decay/decay.go —
half-lives EPISODIC 7d / SEMANTIC 69d / PROCEDURAL 693d (:80-125),
score = 0.4*recency + 0.3*frequency + 0.3*importance
(pkg/nornicdb/db.go:951-959), reinforcement on access (:582),
archive below threshold (default 0.05), periodic recalculation (:643),
Kalman-smoothed variant (kalman_adapter.go).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from nornicdb_tpu_torch.filter.kalman import DECAY_PREDICTION, Kalman
from nornicdb_tpu_torch.storage.types import EPISODIC, PROCEDURAL, SEMANTIC, Engine, Node

logger = logging.getLogger(__name__)

DAY = 86400.0

# (ref: decay.go:80-125)
HALF_LIVES = {
    EPISODIC: 7 * DAY,
    SEMANTIC: 69 * DAY,
    PROCEDURAL: 693 * DAY,
}

ARCHIVED_LABEL = "Archived"


def half_life(memory_type: str) -> float:
    """(ref: HalfLife decay.go:810)"""
    return HALF_LIVES.get(memory_type, HALF_LIVES[SEMANTIC])


@dataclass
class DecayConfig:
    recency_weight: float = 0.4
    frequency_weight: float = 0.3
    importance_weight: float = 0.3
    archive_threshold: float = 0.05
    reinforce_boost: float = 0.1
    interval: float = 3600.0
    kalman_smoothing: bool = False


@dataclass
class DecayStats:
    recalculations: int = 0
    nodes_scored: int = 0
    archived: int = 0
    reinforced: int = 0


class DecayManager:
    """(ref: decay.Manager decay.go:275)"""

    def __init__(
        self,
        storage: Engine,
        config: Optional[DecayConfig] = None,
        archive_threshold: Optional[float] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        self.storage = storage
        self.config = config or DecayConfig()
        if archive_threshold is not None:
            self.config.archive_threshold = archive_threshold
        self.now = now_fn
        self.stats = DecayStats()
        self._timer: Optional[threading.Timer] = None
        self._stopped = False
        self._kalman: dict[str, Kalman] = {}
        # optional temporal modulation hook: node_id -> multiplier where
        # 0.5 halves the decay speed and 2.0 doubles it (ref: pkg/temporal
        # decay_integration.go; wire temporal.DecayIntegration
        # .get_decay_modifier(...).multiplier here)
        self.rate_modifier: Optional[Callable[[str], float]] = None
        self._modifier_errors = 0
        self._modifier_error_logged_at = float("-inf")

    # -- scoring -------------------------------------------------------------
    def calculate_score(self, node: Node, now: Optional[float] = None) -> float:
        """(ref: CalculateScore decay.go:503; weights db.go:951-959)"""
        now = self.now() if now is None else now
        hl = half_life(node.memory_type)
        if self.rate_modifier is not None:
            # multiplier scales decay SPEED, so it divides the half-life
            # (x0.5 = memories live twice as long)
            try:
                mult = float(self.rate_modifier(node.id))
            except Exception:
                # per-node call site inside recalculate_all: a persistent
                # modifier failure (storage down) would otherwise emit one
                # traceback PER NODE per pass — rate-limit to one per 60s
                # with a suppressed-failure count
                self._modifier_errors += 1
                mono = time.monotonic()
                if mono - self._modifier_error_logged_at >= 60.0:
                    self._modifier_error_logged_at = mono
                    logger.exception(
                        "decay rate modifier failed for %s; using 1.0 "
                        "(%d failure(s) since last report)",
                        node.id, self._modifier_errors,
                    )
                    self._modifier_errors = 0
                mult = 1.0
            if mult > 0 and math.isfinite(mult):
                hl = hl / mult
        age = max(now - node.last_accessed, 0.0)
        recency = math.exp(-math.log(2.0) * age / hl)
        # frequency: saturating log scale (10+ accesses ~ 1.0)
        frequency = min(math.log1p(node.access_count) / math.log(11.0), 1.0)
        importance = float(node.properties.get("importance", 0.5))
        importance = min(max(importance, 0.0), 1.0)
        score = (
            self.config.recency_weight * recency
            + self.config.frequency_weight * frequency
            + self.config.importance_weight * importance
        )
        if self.config.kalman_smoothing:
            filt = self._kalman.setdefault(node.id, Kalman(DECAY_PREDICTION))
            score = filt.process(score)
        return min(max(score, 0.0), 1.0)

    def reinforce(self, node_id: str) -> float:
        """Boost on access (ref: Reinforce decay.go:582)."""
        node = self.storage.get_node(node_id)
        node.access_count += 1
        node.last_accessed = self.now()
        node.decay_score = min(node.decay_score + self.config.reinforce_boost, 1.0)
        if ARCHIVED_LABEL in node.labels:
            node.labels.remove(ARCHIVED_LABEL)  # resurrection on access
        self.storage.update_node(node)
        self.stats.reinforced += 1
        return node.decay_score

    # -- recalculation -----------------------------------------------------------
    def recalculate_all(self) -> tuple[int, int]:
        """Rescore every node; archive those below threshold
        (ref: periodic loop decay.go:643). Returns (scored, archived)."""
        scored = archived = 0
        now = self.now()
        for node in self.storage.all_nodes():
            score = self.calculate_score(node, now)
            changed = abs(score - node.decay_score) > 1e-9
            node.decay_score = score
            if score < self.config.archive_threshold and ARCHIVED_LABEL not in node.labels:
                node.labels.append(ARCHIVED_LABEL)
                archived += 1
                changed = True
            if changed:
                self.storage.update_node(node)
            scored += 1
        self.stats.recalculations += 1
        self.stats.nodes_scored += scored
        self.stats.archived += archived
        return scored, archived

    def archived_nodes(self) -> list[Node]:
        return self.storage.get_nodes_by_label(ARCHIVED_LABEL)

    # -- lifecycle -----------------------------------------------------------------
    def start(self) -> None:
        """(ref: Start decay.go:643 — ticker loop)"""
        self._stopped = False
        self._schedule()

    def _schedule(self) -> None:
        if self._stopped:
            return
        self._timer = threading.Timer(self.config.interval, self._tick)
        self._timer.daemon = True
        self._timer.start()

    def _tick(self) -> None:
        try:
            self.recalculate_all()
        except Exception:
            # the periodic timer must survive a bad pass, but silently
            # eating it hid real storage failures from operators
            logger.exception("periodic decay recalculation failed")
        self._schedule()

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
