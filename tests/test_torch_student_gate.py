"""The port's distilled-student gate (nornicdb_tpu_torch.serving.
student_gate) and eval harness against the JAX package's, plus the
TestStudentGate cases of tests/test_serving.py on the port.

Tolerance: the gate is host code over the embedder's vectors, so the same
embedder gives the same report: MRR, precision, recall and nDCG equal to
the JAX gate's to 1e-12, and the same per-case rankings.
"""

import json

import numpy as np
import pytest

from nornicdb_tpu.embed.base import HashEmbedder as JaxHashEmbedder
from nornicdb_tpu.serving import student_gate as jgate
from nornicdb_tpu_torch import StudentGateError
from nornicdb_tpu_torch import eval as teval
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.serving import (
    builtin_eval_suite,
    evaluate_embedder,
    gate_student,
)


class _CollapsedEmbedder(HashEmbedder):
    """Every text maps to (nearly) the same vector: retrieval MRR ~ 1/n —
    the shape of a broken/undertrained student checkpoint."""

    def embed_batch(self, texts):
        rng = np.random.default_rng(0)
        base = rng.standard_normal(self._dims).astype(np.float32)
        base /= np.linalg.norm(base)
        out = []
        for i, _ in enumerate(texts):
            v = base.copy()
            v[0] += 1e-6 * i  # deterministic, meaningless tie-break
            out.append(v / np.linalg.norm(v))
        return out


def _suite():
    return builtin_eval_suite()


class TestAgainstJax:
    def test_builtin_suite_equal(self):
        docs, cases = builtin_eval_suite()
        jdocs, jcases = jgate.builtin_eval_suite()
        assert docs == jdocs
        assert [(c.query, c.relevant) for c in cases] == [
            (c.query, c.relevant) for c in jcases]

    @pytest.mark.parametrize("dims", [32, 128])
    def test_evaluate_embedder_equals_jax(self, dims):
        port = evaluate_embedder(HashEmbedder(dims), *_suite())
        ref = jgate.evaluate_embedder(JaxHashEmbedder(dims),
                                      *jgate.builtin_eval_suite())
        for name in ("mrr", "precision_at_k", "recall_at_k", "ndcg"):
            assert abs(getattr(port.metrics, name)
                       - getattr(ref.metrics, name)) <= 1e-12, name
        assert port.metrics.k == ref.metrics.k
        assert [c["results"] for c in port.per_case] == [
            c["results"] for c in ref.per_case]

    def test_rejection_text_equals_jax(self):
        with pytest.raises(StudentGateError) as port:
            gate_student(_CollapsedEmbedder(64), min_mrr=0.99)
        with pytest.raises(Exception) as ref:
            jgate.gate_student(JaxHashEmbedder(64), min_mrr=1.01)
        # the same template: the message up to the measured number
        assert str(port.value).split("MRR")[0] == str(ref.value).split(
            "MRR")[0]
        assert str(port.value).split("). ")[1] == str(ref.value).split(
            "). ")[1]

    def test_harness_metrics_equal_jax(self):
        from nornicdb_tpu import eval as jeval

        results, relevant = ["a", "x", "b", "y"], ["b", "a"]
        for fn in ("precision_at_k", "recall_at_k"):
            assert getattr(teval, fn)(results, set(relevant), 3) == getattr(
                jeval, fn)(results, set(relevant), 3)
        assert teval.mrr(results, set(relevant)) == jeval.mrr(
            results, set(relevant))
        assert teval.ndcg_at_k(results, relevant, 3) == jeval.ndcg_at_k(
            results, relevant, 3)


class TestStudentGate:
    """tests/test_serving.py TestStudentGate on the port."""

    def test_green_semantic_embedder_admitted(self):
        report = gate_student(HashEmbedder(128), min_mrr=0.5)
        assert report.metrics.mrr >= 0.5

    def test_red_collapsed_student_rejected(self):
        with pytest.raises(StudentGateError) as ei:
            gate_student(_CollapsedEmbedder(128), min_mrr=0.5)
        msg = str(ei.value)
        assert "rejected" in msg and "MRR" in msg
        # the error must carry the remediation knobs
        assert "student_min_mrr" in msg

    def test_threshold_is_the_gate(self):
        """Same embedder passes a low bar and fails a high one."""
        emb = HashEmbedder(128)
        report = evaluate_embedder(emb, *_suite())
        low = max(0.0, report.metrics.mrr - 0.1)
        high = min(1.0, report.metrics.mrr + 0.01)
        gate_student(emb, min_mrr=low)  # passes
        if high > report.metrics.mrr:
            with pytest.raises(StudentGateError):
                gate_student(emb, min_mrr=high)

    def test_custom_suite_loading(self, tmp_path):
        docs, cases = _suite()
        p = tmp_path / "suite.json"
        p.write_text(json.dumps({
            "docs": docs,
            "cases": [
                {"query": c.query, "relevant": c.relevant} for c in cases
            ],
        }))
        report = gate_student(HashEmbedder(128), 0.4, str(p))
        assert report.metrics.mrr >= 0.4
