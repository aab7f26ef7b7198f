"""Eval gate for the distilled production embedder.

The round-5 quality tables showed the distilled students
(models/bge_m3.BGE_DISTILL_*) recover most of the teacher's retrieval
quality at 4-8x less compute — but "most" is a measurement, not a
promise, per checkpoint.  This gate makes the speed/quality trade an
operator knob with a hard floor: a student is only admitted as the
production embedder when its retrieval MRR (eval.py harness) over an
eval suite meets ``ServingConfig.student_min_mrr``.  Below the floor the
config is REJECTED at startup (:class:`StudentGateError`) — the server
refuses to come up quietly degraded.

Suites are JSON ``{"docs": {id: text}, "cases": [{"query", "relevant"}]}``
(``student_eval_suite``); without one, a deterministic builtin suite of
topical documents exercises basic retrieval structure (any semantically
coherent embedder scores ~1.0; a random or collapsed one scores ~1/n).

A copy of ``nornicdb_tpu/serving/student_gate.py`` (host only: it calls the
embedder's ``embed_batch``/``embed``, which run where the embedder runs),
with the same suites, scores and error text. ``ServingConfig``'s
``student_*`` fields name its inputs; the server's embedder selection that
reads them is not ported yet (ROADMAP).
"""

from __future__ import annotations

import json
import logging

import numpy as np

from nornicdb_tpu_torch.errors import StudentGateError
from nornicdb_tpu_torch.eval import EvalCase, EvalReport, Harness

logger = logging.getLogger(__name__)

# deterministic topical vocabulary: each topic's docs share a core word
# set, queries re-use a disjoint slice of it, and topics don't overlap —
# retrieval structure, not memorized strings
_TOPICS = {
    "graph": ("graph database node edge traversal cypher index "
              "adjacency shortest path query engine"),
    "vector": ("vector embedding similarity cosine search corpus "
               "nearest neighbor ann recall dense retrieval"),
    "storage": ("storage engine wal append fsync snapshot segment "
                "compaction durability crash recovery log"),
    "replication": ("replication raft leader follower election quorum "
                    "append entries commit heartbeat term"),
    "serving": ("serving batch queue latency throughput admission "
                "deadline shed backpressure scheduler packed"),
    "device": ("device accelerator tpu backend probe degrade recover "
               "fallback hbm transfer upload lifecycle"),
    "auth": ("auth token jwt password login role permission session "
             "credential lockout security"),
    "telemetry": ("telemetry metrics histogram counter gauge trace span "
                  "prometheus exposition slow query capture"),
}


def builtin_eval_suite() -> tuple[dict[str, str], list[EvalCase]]:
    """(docs, cases): 3 docs per topic, one query per topic+doc pairing."""
    docs: dict[str, str] = {}
    cases: list[EvalCase] = []
    for topic, words in _TOPICS.items():
        w = words.split()
        ids = []
        for j in range(3):
            did = f"{topic}-{j}"
            # overlapping word windows keep intra-topic docs mutually
            # closer than any cross-topic pair
            docs[did] = " ".join(w[j : j + 8])
            ids.append(did)
        cases.append(EvalCase(query=" ".join(w[2:7]), relevant=ids))
        cases.append(EvalCase(query=" ".join(w[4:9]), relevant=ids))
    return docs, cases


def load_eval_suite(path: str) -> tuple[dict[str, str], list[EvalCase]]:
    """JSON suite with its own doc corpus (the eval.py harness format
    plus a ``docs`` map, since the gate indexes from scratch)."""
    with open(path) as f:
        data = json.load(f)
    docs = {str(k): str(v) for k, v in data["docs"].items()}
    cases = [
        EvalCase(c["query"], [str(r) for r in c["relevant"]])
        for c in data["cases"]
    ]
    return docs, cases


def evaluate_embedder(
    embedder, docs: dict[str, str], cases: list[EvalCase], k: int = 10
) -> EvalReport:
    """Embed the suite's docs with ``embedder``, brute-force cosine
    retrieval, and score with the eval.py harness."""
    ids = list(docs.keys())
    mat = np.stack(
        [np.asarray(v, np.float32) for v in embedder.embed_batch(
            [docs[i] for i in ids]
        )]
    )
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    mat = mat / np.maximum(norms, 1e-12)

    def search_fn(query: str, n: int) -> list[str]:
        q = np.asarray(embedder.embed(query), np.float32)
        qn = np.linalg.norm(q)
        q = q / max(qn, 1e-12)
        scores = mat @ q
        top = np.argsort(-scores)[:n]
        return [ids[i] for i in top]

    return Harness(search_fn, k=min(k, len(ids))).run(cases)


def gate_student(
    embedder, min_mrr: float, suite_path: str = ""
) -> EvalReport:
    """Admit ``embedder`` as the production embedder only if its eval MRR
    clears ``min_mrr``; raise :class:`StudentGateError` otherwise."""
    docs, cases = (
        load_eval_suite(suite_path) if suite_path else builtin_eval_suite()
    )
    report = evaluate_embedder(embedder, docs, cases)
    mrr = report.metrics.mrr
    if mrr < min_mrr:
        raise StudentGateError(
            f"distilled student {embedder.model()!r} rejected: eval MRR "
            f"{mrr:.4f} < required {min_mrr:.4f} "
            f"({len(docs)} docs, {len(cases)} queries"
            f"{', suite ' + suite_path if suite_path else ', builtin suite'}"
            "). Fix: retrain/re-distill the student, lower "
            "serving.student_min_mrr, or set serving.embedder=full."
        )
    logger.info(
        "student embedder %s admitted: eval MRR %.4f >= %.4f",
        embedder.model(), mrr, min_mrr,
    )
    return report
