"""Search-quality evaluation harness: a copy of ``nornicdb_tpu/eval.py``
(host only), kept here so the port imports nothing of the JAX package. The
student gate (``serving/student_gate.py``) scores an embedder with it.

Behavioral reference: the reference's pkg/eval/harness.go:175 (Harness),
computeMetrics :309, precision/recall :424-442; JSON test suites with
thresholds + reporter (cmd/eval, docs/advanced/search-evaluation.md).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class EvalCase:
    query: str
    relevant: list[str]  # relevant doc/node ids (ordered by ideal relevance)


@dataclass
class EvalMetrics:
    precision_at_k: float
    recall_at_k: float
    mrr: float
    ndcg: float
    k: int

    def as_dict(self) -> dict[str, float]:
        return {
            f"precision@{self.k}": round(self.precision_at_k, 4),
            f"recall@{self.k}": round(self.recall_at_k, 4),
            "mrr": round(self.mrr, 4),
            "ndcg": round(self.ndcg, 4),
        }


def precision_at_k(results: list[str], relevant: set[str], k: int) -> float:
    """(ref: precision harness.go:424)"""
    top = results[:k]
    if not top:
        return 0.0
    return sum(1 for r in top if r in relevant) / len(top)


def recall_at_k(results: list[str], relevant: set[str], k: int) -> float:
    """(ref: recall harness.go:442)"""
    if not relevant:
        return 0.0
    return sum(1 for r in results[:k] if r in relevant) / len(relevant)


def mrr(results: list[str], relevant: set[str]) -> float:
    for i, r in enumerate(results, 1):
        if r in relevant:
            return 1.0 / i
    return 0.0


def ndcg_at_k(results: list[str], relevant: list[str], k: int) -> float:
    rel_rank = {r: len(relevant) - i for i, r in enumerate(relevant)}
    dcg = sum(
        rel_rank.get(r, 0) / math.log2(i + 1)
        for i, r in enumerate(results[:k], 1)
    )
    ideal = sorted(rel_rank.values(), reverse=True)[:k]
    idcg = sum(v / math.log2(i + 1) for i, v in enumerate(ideal, 1))
    return dcg / idcg if idcg > 0 else 0.0


@dataclass
class EvalReport:
    metrics: EvalMetrics
    per_case: list[dict[str, Any]]
    passed: bool
    thresholds: dict[str, float] = field(default_factory=dict)


class Harness:
    """(ref: eval.Harness harness.go:175)"""

    def __init__(
        self,
        search_fn: Callable[[str, int], list[str]],
        k: int = 10,
        thresholds: Optional[dict[str, float]] = None,
    ):
        self.search_fn = search_fn  # query, k -> ranked ids
        self.k = k
        self.thresholds = thresholds or {}

    def run(self, cases: list[EvalCase]) -> EvalReport:
        """(ref: computeMetrics harness.go:309)"""
        per_case = []
        p_sum = r_sum = mrr_sum = ndcg_sum = 0.0
        for case in cases:
            results = self.search_fn(case.query, self.k)
            rel = set(case.relevant)
            p = precision_at_k(results, rel, self.k)
            r = recall_at_k(results, rel, self.k)
            m = mrr(results, rel)
            n = ndcg_at_k(results, case.relevant, self.k)
            p_sum += p
            r_sum += r
            mrr_sum += m
            ndcg_sum += n
            per_case.append(
                {"query": case.query, "precision": p, "recall": r,
                 "mrr": m, "ndcg": n, "results": results[: self.k]}
            )
        n_cases = max(len(cases), 1)
        metrics = EvalMetrics(
            p_sum / n_cases, r_sum / n_cases, mrr_sum / n_cases,
            ndcg_sum / n_cases, self.k,
        )
        passed = all(
            metrics.as_dict().get(name, 0.0) >= threshold
            for name, threshold in self.thresholds.items()
        )
        return EvalReport(metrics, per_case, passed, dict(self.thresholds))

    @staticmethod
    def load_suite(path: str) -> list[EvalCase]:
        """JSON suite: [{"query": ..., "relevant": [...]}, ...]"""
        with open(path) as f:
            data = json.load(f)
        return [EvalCase(c["query"], list(c["relevant"])) for c in data]
