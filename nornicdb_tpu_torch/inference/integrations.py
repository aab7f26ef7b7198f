"""Inference integration adapters: topology, clusters, Heimdall QC. A copy
of ``nornicdb_tpu/inference/integrations.py``: the topology scores come
from the port's ``linkpredict``, the clusters from the port's
``SearchService.cluster_assignments``.

Behavioral reference: the upstream NornicDB pkg/inference/ —
TopologyIntegration (topology_integration.go): link-prediction scores feed
suggestion confidence; ClusterIntegration (cluster_integration.go): same
k-means cluster membership boosts similarity suggestions;
HeimdallQC (heimdall_qc.go:1-40): SLM batch review of suggested edges,
gated by NORNICDB_AUTO_TLP_LLM_QC_ENABLED.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional

from nornicdb_tpu_torch.errors import NotFoundError
from nornicdb_tpu_torch.inference.engine import InferenceEngine
from nornicdb_tpu_torch.linkpredict.topology import build_graph, score_pair
from nornicdb_tpu_torch.storage.types import Engine
from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)


class TopologyIntegration:
    """Blend GDS topology scores into suggestion confidence
    (ref: topology_integration.go)."""

    def __init__(self, storage: Engine, method: str = "adamicAdar",
                 weight: float = 0.3):
        self.storage = storage
        self.method = method
        self.weight = weight
        self._graph = None
        self._graph_key = None

    def _current_graph(self):
        key = (self.storage.node_count(), self.storage.edge_count())
        if self._graph is None or self._graph_key != key:
            self._graph = build_graph(self.storage)
            self._graph_key = key
        return self._graph

    def adjust_confidence(self, from_id: str, to_id: str, confidence: float) -> float:
        g = self._current_graph()
        topo = score_pair(g, from_id, to_id, self.method)
        topo = topo / (1.0 + topo)  # squash unbounded scorers
        return min((1 - self.weight) * confidence + self.weight * topo, 1.0)

    def attach(self, engine: InferenceEngine) -> None:
        original = engine.process_suggestion

        def wrapped(from_id, to_id, rel_type, confidence):
            return original(
                from_id, to_id, rel_type,
                self.adjust_confidence(from_id, to_id, confidence),
            )

        engine.process_suggestion = wrapped  # type: ignore[method-assign]


class ClusterIntegration:
    """Same-cluster membership boosts similarity suggestions
    (ref: cluster_integration.go)."""

    def __init__(self, assignments_fn: Callable[[], dict[str, int]],
                 boost: float = 0.05, penalty: float = 0.05):
        self.assignments_fn = assignments_fn
        self.boost = boost
        self.penalty = penalty

    def adjust_confidence(self, from_id: str, to_id: str, confidence: float) -> float:
        assignments = self.assignments_fn() or {}
        ca, cb = assignments.get(from_id), assignments.get(to_id)
        if ca is None or cb is None:
            return confidence
        if ca == cb:
            return min(confidence + self.boost, 1.0)
        return max(confidence - self.penalty, 0.0)

    def attach(self, engine: InferenceEngine) -> None:
        original = engine.process_suggestion

        def wrapped(from_id, to_id, rel_type, confidence):
            return original(
                from_id, to_id, rel_type,
                self.adjust_confidence(from_id, to_id, confidence),
            )

        engine.process_suggestion = wrapped  # type: ignore[method-assign]


def qc_enabled() -> bool:
    """(ref: NORNICDB_AUTO_TLP_LLM_QC_ENABLED heimdall_qc.go)"""
    return os.environ.get("NORNICDB_AUTO_TLP_LLM_QC_ENABLED", "").lower() in (
        "1", "true", "yes",
    )


class HeimdallQC:
    """SLM batch review of suggested edges (ref: heimdall_qc.go:1-40).

    The generator is asked to answer per pair whether the relationship is
    plausible; suggestions it rejects are dropped. With the template
    generator this is a pass-through reviewer; with a trained Qwen it
    becomes a real QC gate.
    """

    def __init__(self, heimdall_manager, storage: Engine,
                 batch_size: int = 8):
        self.manager = heimdall_manager
        self.storage = storage
        self.batch_size = batch_size
        self.reviewed = 0
        self.rejected = 0

    def review(self, pairs: list[tuple[str, str, str]]) -> list[bool]:
        """pairs: (from_id, to_id, rel_type) -> keep? per pair.

        The whole batch is submitted through the manager's
        ``generate_many`` in one call: with the genserve continuous
        batching engine behind Heimdall, every pair's review decodes
        concurrently in the shared paged-KV batch instead of serializing
        one synchronous ``generate()`` per edge (the pre-genserve
        behavior, and still the fallback for template backends)."""
        out: list[Optional[bool]] = [None] * len(pairs)
        prompts: list[str] = []
        prompt_slots: list[int] = []
        for i, (from_id, to_id, rel_type) in enumerate(pairs):
            try:
                a = self.storage.get_node(from_id)
                b = self.storage.get_node(to_id)
            except NotFoundError:
                out[i] = False  # endpoint deleted since suggestion
                continue
            prompts.append(
                "Should these two memories be linked as "
                f"{rel_type}? Reply JSON {{\"keep\": true/false}}.\n"
                f"A: {a.properties.get('content', '')[:200]}\n"
                f"B: {b.properties.get('content', '')[:200]}"
            )
            prompt_slots.append(i)
        texts: list[Optional[str]] = []
        if prompts:
            try:
                texts = list(self.manager.generate_many(
                    prompts, max_tokens=16))
            except Exception:
                # QC failure must not block learning — but a QC model
                # that is ALWAYS down silently approves everything
                log.warning("link-QC batch generation failed; keeping "
                            "%d edges", len(prompts), exc_info=True)
                count_error("inference.link_qc")
                texts = [None] * len(prompts)
        for slot, text in zip(prompt_slots, texts):
            if text is None:
                out[slot] = True  # fail open
                continue
            self.reviewed += 1
            keep = True
            try:
                start = text.find("{")
                if start >= 0:
                    obj = json.loads(text[start : text.rfind("}") + 1])
                    keep = bool(obj.get("keep", True))
            except ValueError:
                keep = True  # non-JSON reply: fail open (keep the edge)
            if not keep:
                self.rejected += 1
            out[slot] = keep
        return [bool(k) for k in out]

    def attach(self, engine: InferenceEngine) -> None:
        if not qc_enabled():
            return
        original = engine.process_suggestion

        def wrapped(from_id, to_id, rel_type, confidence):
            if not self.review([(from_id, to_id, rel_type)])[0]:
                return None
            return original(from_id, to_id, rel_type, confidence)

        engine.process_suggestion = wrapped  # type: ignore[method-assign]
