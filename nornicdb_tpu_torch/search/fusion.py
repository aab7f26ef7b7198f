"""Result fusion: reciprocal-rank fusion (RRF) and MMR diversity, copies of
``nornicdb_tpu/search/fusion.py``. Host Python over the legs' ranked ids
and the service's normalized host vectors."""

from __future__ import annotations

import numpy as np

RRF_K = 60.0


def fuse_rrf(
    ranked_lists: dict[str, list[str]],
    weights: dict[str, float] | None = None,
    k0: float = RRF_K,
) -> list[tuple[str, float]]:
    """Fuse named ranked id lists: score(id) = sum_i w_i / (k0 + rank_i),
    best first, ties by id."""
    weights = weights or {}
    scores: dict[str, float] = {}
    for name, ids in ranked_lists.items():
        w = weights.get(name, 1.0)
        for rank, id_ in enumerate(ids):
            scores[id_] = scores.get(id_, 0.0) + w / (k0 + rank + 1)
    return sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))


def adaptive_rrf_weights(query: str) -> dict[str, float]:
    """Query-shape-driven vector/text weighting: short keyword-ish queries
    lean on BM25; long natural language leans on vectors."""
    n_words = len(query.split())
    if n_words <= 2:
        return {"vector": 0.8, "fulltext": 1.2}
    if n_words >= 8:
        return {"vector": 1.2, "fulltext": 0.8}
    return {"vector": 1.0, "fulltext": 1.0}


def apply_mmr(
    candidates: list[str],
    relevance: dict[str, float],
    vectors: dict[str, np.ndarray],
    limit: int,
    lambda_: float = 0.7,
) -> list[str]:
    """Maximal marginal relevance re-ranking: greedily pick
    argmax lambda*rel - (1-lambda)*max_sim_to_selected. Candidates without
    vectors are ranked by relevance only."""
    if limit >= len(candidates):
        return list(candidates)
    selected: list[str] = []
    remaining = list(candidates)
    while remaining and len(selected) < limit:
        best, best_score = None, -np.inf
        for c in remaining:
            rel = relevance.get(c, 0.0)
            div = 0.0
            vc = vectors.get(c)
            if vc is not None and selected:
                sims = [
                    float(np.dot(vc, vectors[s]))
                    for s in selected
                    if s in vectors
                ]
                if sims:
                    div = max(sims)
            score = lambda_ * rel - (1.0 - lambda_) * div
            if score > best_score:
                best, best_score = c, score
        selected.append(best)
        remaining.remove(best)
    return selected
