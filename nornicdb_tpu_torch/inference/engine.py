"""Automatic relationship inference ("the graph database that learns"), a
copy of ``nornicdb_tpu/inference/engine.py``. Its device work is the
similarity lookup it is handed: ``DB`` passes ``SearchService.
vector_candidates``, the streaming top-k kernel on the card.

Behavioral reference: the upstream NornicDB pkg/inference/inference.go —
Engine :216, OnStore :498 (embedding-similarity suggestions),
OnAccess :679 (co-access windows), SuggestTransitive :736 (A->B->C => A->C),
ProcessSuggestion :874 (evidence accumulation + cooldowns to prevent edge
churn); evidence.go, cooldown.go; integration adapters
(topology_integration.go, cluster_integration.go).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from nornicdb_tpu_torch.errors import NotFoundError
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)

SIMILAR_TO = "SIMILAR_TO"
RELATED_TO = "RELATED_TO"
CO_ACCESSED = "CO_ACCESSED_WITH"


@dataclass
class InferenceConfig:
    similarity_threshold: float = 0.85  # min cosine for SIMILAR_TO
    min_evidence: int = 2  # observations before an edge is created
    cooldown: float = 300.0  # per-pair suggestion cooldown seconds
    co_access_min: int = 3  # co-access observations before suggesting
    transitive_min_confidence: float = 0.5
    max_suggestions_per_store: int = 5
    evidence_ttl: float = 7 * 86400.0


@dataclass
class InferenceStats:
    suggestions: int = 0
    edges_created: int = 0
    suppressed_cooldown: int = 0
    suppressed_existing: int = 0


@dataclass
class _Evidence:
    count: int = 0
    confidence_sum: float = 0.0
    first_seen: float = 0.0
    last_seen: float = 0.0
    rel_type: str = SIMILAR_TO


class InferenceEngine:
    """(ref: inference.Engine inference.go:216)"""

    def __init__(
        self,
        storage: Engine,
        similarity_fn: Optional[Callable[[np.ndarray, int], list[tuple[str, float]]]] = None,
        config: Optional[InferenceConfig] = None,
        similarity_threshold: Optional[float] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        self.storage = storage
        self.similarity_fn = similarity_fn  # injected (ref: inference.go:302)
        self.config = config or InferenceConfig()
        if similarity_threshold is not None:
            self.config.similarity_threshold = similarity_threshold
        self.now = now_fn
        self.stats = InferenceStats()
        self._lock = threading.RLock()
        self._evidence: dict[tuple[str, str, str], _Evidence] = {}
        self._cooldown: dict[tuple[str, str], float] = {}
        # rate-limited similarity-failure logging (one traceback per 60s
        # with a suppressed count — same pattern as decay.rate_modifier)
        self._sim_errors = 0
        # -inf, not 0.0: monotonic() has an arbitrary epoch that can start
        # near zero, which would silently suppress the FIRST traceback for
        # up to 60s of process life (decay.py uses the same sentinel)
        self._sim_error_logged_at = float("-inf")
        self._co_access: dict[tuple[str, str], int] = {}
        self._last_access: list[tuple[str, float]] = []

    # -- event hooks ------------------------------------------------------------
    def on_store(self, node: Node) -> list[Edge]:
        """Similarity-driven suggestions when a node (with embedding) lands
        (ref: OnStore inference.go:498)."""
        if node.embedding is None or self.similarity_fn is None:
            return []
        try:
            candidates = self.similarity_fn(
                np.asarray(node.embedding, np.float32),
                self.config.max_suggestions_per_store + 1,
            )
        except Exception:
            # a similarity backend hiccup must not fail the store, but a
            # silently dead suggestion path is undebuggable — count every
            # failure, log one traceback per 60s (a persistently-down
            # backend would otherwise emit one per stored node)
            count_error("inference.similarity")
            self._sim_errors += 1
            mono = time.monotonic()
            if mono - self._sim_error_logged_at >= 60.0:
                self._sim_error_logged_at = mono
                log.warning(
                    "similarity lookup failed during on_store "
                    "(%d failure(s) since last report)",
                    self._sim_errors, exc_info=True,
                )
                self._sim_errors = 0
            return []
        created = []
        for other_id, score in candidates:
            if other_id == node.id:
                continue
            if score < self.config.similarity_threshold:
                continue
            e = self.process_suggestion(node.id, other_id, SIMILAR_TO, float(score))
            if e is not None:
                created.append(e)
        return created

    def on_access(self, node_id: str, ts: Optional[float] = None) -> list[Edge]:
        """Co-access window tracking (ref: OnAccess inference.go:679)."""
        ts = self.now() if ts is None else ts
        created = []
        with self._lock:
            window = 60.0
            self._last_access = [
                (nid, t) for nid, t in self._last_access if ts - t <= window
            ]
            for other_id, _t in self._last_access:
                if other_id == node_id:
                    continue
                pair = tuple(sorted((node_id, other_id)))
                self._co_access[pair] = self._co_access.get(pair, 0) + 1
                count = self._co_access[pair]
                if count >= self.config.co_access_min:
                    conf = min(0.5 + 0.1 * (count - self.config.co_access_min), 0.95)
                    e = self.process_suggestion(pair[0], pair[1], CO_ACCESSED, conf)
                    if e is not None:
                        created.append(e)
            self._last_access.append((node_id, ts))
        return created

    def suggest_transitive(self, node_id: str) -> list[Edge]:
        """A->B->C => suggest A->C (ref: SuggestTransitive inference.go:736)."""
        created = []
        first_hop = self.storage.get_outgoing_edges(node_id)
        direct = {e.end_node for e in first_hop}
        for e1 in first_hop:
            for e2 in self.storage.get_outgoing_edges(e1.end_node):
                target = e2.end_node
                if target == node_id or target in direct:
                    continue
                conf = (
                    min(e1.confidence, e2.confidence)
                    * self.config.transitive_min_confidence
                    * 2.0
                )
                conf = min(conf, 0.9)
                if conf < self.config.transitive_min_confidence:
                    continue
                e = self.process_suggestion(node_id, target, RELATED_TO, conf)
                if e is not None:
                    created.append(e)
        return created

    # -- suggestion pipeline -------------------------------------------------------
    def process_suggestion(
        self, from_id: str, to_id: str, rel_type: str, confidence: float
    ) -> Optional[Edge]:
        """Evidence + cooldown gate, then edge creation
        (ref: ProcessSuggestion inference.go:874, evidence.go, cooldown.go)."""
        now = self.now()
        pair = tuple(sorted((from_id, to_id)))
        with self._lock:
            self.stats.suggestions += 1
            # cooldown (ref: cooldown.go — prevents edge churn)
            until = self._cooldown.get(pair, 0.0)
            if now < until:
                self.stats.suppressed_cooldown += 1
                return None
            # existing edge of this type?
            if self._edge_exists(from_id, to_id, rel_type):
                self.stats.suppressed_existing += 1
                self._cooldown[pair] = now + self.config.cooldown
                return None
            key = (pair[0], pair[1], rel_type)
            ev = self._evidence.get(key)
            if ev is None or now - ev.last_seen > self.config.evidence_ttl:
                ev = _Evidence(first_seen=now, rel_type=rel_type)
                self._evidence[key] = ev
            ev.count += 1
            ev.confidence_sum += confidence
            ev.last_seen = now
            if ev.count < self.config.min_evidence:
                return None
            avg_conf = ev.confidence_sum / ev.count
            del self._evidence[key]
            self._cooldown[pair] = now + self.config.cooldown
        edge = Edge(
            start_node=from_id,
            end_node=to_id,
            type=rel_type,
            confidence=round(avg_conf, 4),
            auto_generated=True,
            properties={"inferred_at": now, "evidence_count": ev.count},
        )
        try:
            created = self.storage.create_edge(edge)
        except Exception:
            # endpoint vanished / duplicate under race: the inference is
            # simply stale — but count it so a systematic failure shows up
            log.debug("inferred edge %s-[%s]->%s not created",
                      edge.start_node, edge.type, edge.end_node,
                      exc_info=True)
            count_error("inference.create_edge")
            return None
        self.stats.edges_created += 1
        return created

    def _edge_exists(self, a: str, b: str, rel_type: str) -> bool:
        for e in self.storage.get_outgoing_edges(a):
            if e.end_node == b and e.type == rel_type:
                return True
        for e in self.storage.get_outgoing_edges(b):
            if e.end_node == a and e.type == rel_type:
                return True
        return False

    # -- maintenance -----------------------------------------------------------------
    def decay_inferred_edges(self, min_confidence: float = 0.1) -> int:
        """Drop stale auto-generated edges below confidence
        (ref: edge_decay.go)."""
        removed = 0
        for e in list(self.storage.all_edges()):
            if e.auto_generated and e.confidence < min_confidence:
                try:
                    self.storage.delete_edge(e.id)
                    removed += 1
                except NotFoundError:
                    pass  # already gone (concurrent decay/delete)
        return removed
