"""Recall-governed IVF autotuning of the port (``search/tuner.py`` and the
service wiring), on the CPU: ``tests/test_ivf_tuner.py``'s TestTunerUnit,
TestServiceTuning and TestDriftRetune on the port (the sharded ``local_k``
case and the metric families wait for their slices; the plan's evidence is
read from ``stats_snapshot()``), and the slice as a whole against the JAX
package: the same fit tunes to the same ``n_probe`` and serves the same ids
(scores within 1e-5, the f32 sums of bf16 products run in another order).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from nornicdb_tpu.search.service import SearchConfig as JaxSearchConfig
from nornicdb_tpu.search.service import SearchService as JaxSearchService
from nornicdb_tpu.search.tuner import IVFTuner as JaxTuner
from nornicdb_tpu.storage import MemoryEngine
from nornicdb_tpu.storage.types import Node as JaxNode
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.search import IVFTuner, SearchConfig, SearchService
from nornicdb_tpu_torch.search.tuner import TUNE_OUTCOMES, _probe_ladder
from nornicdb_tpu_torch.storage import Node


def _clustered(n, d, n_centers, seed=0, spread=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    rows = centers[rng.integers(0, n_centers, n)] + spread * rng.normal(
        size=(n, d)).astype(np.float32)
    return rows.astype(np.float32), centers


class TestTunerUnit:
    def _fitted_corpus(self, n=4096, d=32, k=32, seed=0, capacity=0):
        rows, _ = _clustered(n, d, k, seed)
        c = DeviceCorpus(dims=d, capacity=capacity or 128, device="cpu")
        c.add_batch([f"v{i}" for i in range(n)], rows)
        assert c.cluster(k=k, iters=5) > 0
        return c, rows

    def test_picks_smallest_passing_n_probe(self):
        c, _rows = self._fitted_corpus()
        state = IVFTuner(recall_target=0.9, sample=32, k=50).tune(c)
        assert state.outcome == "ok"
        assert 1 <= state.n_probe < 32  # pruning actually engaged
        assert state.measured_recall >= 0.9
        assert 0.0 < state.flop_fraction < 1.0
        assert state.serving_pruned and state.layout_epoch == c._layout_epoch
        if state.n_probe > 1:
            # smallest: an unreachable floor walks the whole ladder
            probe_state = IVFTuner(recall_target=1.01, sample=32, k=50).tune(c)
            assert probe_state.outcome == "floor_unmet"
            assert probe_state.ladder_evals == len(_probe_ladder(32))

    def test_no_layout_outcome(self):
        c = DeviceCorpus(dims=16, device="cpu")
        c.add_batch([f"a{i}" for i in range(64)],
                    np.random.default_rng(0).normal(
                        size=(64, 16)).astype(np.float32))
        state = IVFTuner().tune(c)
        assert state.outcome == "no_layout"
        assert not state.serving_pruned

    def test_floor_unmet_when_layout_misses_rows(self):
        # fit over the first half, then add the second half WITHIN capacity
        # (no grow: the layout stays epoch-valid but covers half the
        # corpus): even probing every cluster cannot reach the floor
        rows, _ = _clustered(4096, 32, 32, seed=1)
        c = DeviceCorpus(dims=32, capacity=8192, device="cpu")
        c.add_batch([f"v{i}" for i in range(2048)], rows[:2048])
        assert c.cluster(k=32, iters=5) > 0
        c.add_batch([f"w{i}" for i in range(2048)], rows[2048:])
        state = IVFTuner(recall_target=0.95, sample=32, k=50).tune(c)
        assert c._ivf is not None  # plain adds keep the layout serving
        assert state.outcome == "floor_unmet"
        assert state.measured_recall < 0.95
        assert not state.serving_pruned

    def test_tuner_never_raises(self):
        class Broken:
            def __len__(self):
                return 10_000

            def __getattr__(self, name):
                raise RuntimeError("boom")

        state = IVFTuner().tune(Broken())
        assert state.outcome == "error" and "boom" in state.detail
        assert not state.serving_pruned

    def test_probe_ladder(self):
        assert _probe_ladder(1) == [1]
        assert _probe_ladder(6) == [1, 2, 4, 6]
        assert _probe_ladder(707)[-2:] == [512, 707]


def _service(dims=32, **cfg_kwargs) -> SearchService:
    cfg = SearchConfig(
        tune_min_rows=cfg_kwargs.pop("tune_min_rows", 256),
        tune_sample=cfg_kwargs.pop("tune_sample", 16),
        tune_k=cfg_kwargs.pop("tune_k", 20),
        recall_target=cfg_kwargs.pop("recall_target", 0.9),
        **cfg_kwargs,
    )
    return SearchService(dims=dims, config=cfg, device="cpu")


def _index(svc, vecs, prefix="n"):
    for i, v in enumerate(vecs):
        svc.index_node(Node(id=f"{prefix}{i}", embedding=v))


def _recall(tuned, exact):
    return np.mean([len({i for i, _ in g} & {i for i, _ in w}) / len(w)
                    for g, w in zip(tuned, exact)])


class TestServiceTuning:
    def test_recluster_installs_tuned_plan(self):
        svc = _service()
        rows, _ = _clustered(600, 32, 16, seed=3)
        _index(svc, rows)
        try:
            assignments = svc.recluster(k=16, iters=4)
            assert len(assignments) == 600 and svc.cluster_result.k == 16
            state = svc._tune_state
            assert state is not None and state.outcome == "ok", state.as_dict()
            kwargs = svc._corpus_search_kwargs(svc.corpus())
            assert kwargs.get("n_probe") == state.n_probe > 0
            # twin path: tuned pruned serving vs exact, on corpus rows
            corpus = svc.corpus()
            exact = corpus.search(rows[:8], k=10, exact=True)
            tuned = corpus.search(rows[:8], k=10, **kwargs)
            assert _recall(tuned, exact) >= 0.9
            # the plan and its evidence, as /admin/stats shows them
            snap = svc.stats_snapshot()
            assert snap["ivf_tuner"]["tunes"]["ok"] >= 1
            assert snap["ivf_tuner"]["active"]["n_probe"] == state.n_probe
            assert snap["ivf_tuner"]["active"]["measured_recall"] >= 0.9
            assert snap["ivf_tuner"]["recall_target"] == 0.9
            assert set(snap["ivf_tuner"]["tunes"]) == set(TUNE_OUTCOMES)
            # exact=True is the recall-1.0 contract: no pruning under it
            svc.config.exact = True
            assert svc._corpus_search_kwargs(corpus) == {"exact": True}
        finally:
            svc.shutdown()

    def test_served_through_the_batcher_in_fused_dispatches(self):
        svc = _service(batching_enabled=True, batch_window=0.05)
        rows, _ = _clustered(600, 32, 16, seed=13)
        svc.index_vectors([f"n{i}" for i in range(600)], rows)
        try:
            svc.recluster(k=16, iters=4)
            assert svc._tune_state.serving_pruned
            corpus = svc.corpus()
            d0 = corpus.sync_stats.device_dispatches
            got = [None] * 12
            barrier = threading.Barrier(12)

            def client(i):
                barrier.wait()
                got[i] = svc.vector_candidates(rows[i], k=5)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert all(g and g[0][0] == f"n{i}" for i, g in enumerate(got))
            assert corpus.sync_stats.device_dispatches - d0 < 12
        finally:
            svc.shutdown()

    def test_explicit_n_probe_overrides_tuner(self):
        svc = _service(n_probe=3)
        rows, _ = _clustered(400, 32, 8, seed=4)
        _index(svc, rows)
        try:
            svc.recluster(k=8, iters=3)
            kwargs = svc._corpus_search_kwargs(svc.corpus())
            assert kwargs.get("n_probe") == 3  # the operator's escape hatch
        finally:
            svc.shutdown()

    def test_too_small_corpus_skips_tuning(self):
        svc = _service(tune_min_rows=10_000)
        rows, _ = _clustered(300, 32, 8, seed=5)
        _index(svc, rows)
        try:
            svc.recluster(k=8, iters=3)
            state = svc._tune_state
            assert state is not None and state.outcome == "too_small"
            assert svc._corpus_search_kwargs(svc.corpus()) == {}
            assert svc.tune_counts["too_small"] == 1
        finally:
            svc.shutdown()

    def test_tuning_disabled_leaves_no_plan(self):
        svc = _service(tune_enabled=False)
        rows, _ = _clustered(300, 32, 8, seed=6)
        _index(svc, rows)
        try:
            assert svc.recluster(k=8, iters=3) is not None
            assert svc._tune_state is None and svc.corpus()._ivf is not None
            assert svc._corpus_search_kwargs(svc.corpus()) == {}
        finally:
            svc.shutdown()

    @pytest.mark.parametrize(
        "field", ["n_probe", "recall_target", "tune_enabled", "tune_sample",
                  "tune_k", "tune_min_rows", "drift_threshold",
                  "cluster_fit_sample"])
    def test_config_defaults_are_jax_defaults(self, field):
        assert getattr(SearchConfig(), field) == getattr(JaxSearchConfig(),
                                                         field)


class TestDriftRetune:
    def test_churn_past_threshold_triggers_background_retune(self):
        """Interleaved add/remove churn past the drift threshold schedules a
        background re-tune whose fresh layout and plan restore the recall
        floor, with no operator call."""
        svc = _service(drift_threshold=0.2)
        rows, _ = _clustered(1500, 32, 16, seed=7, spread=0.25)
        _index(svc, rows[:900])
        try:
            svc.recluster(k=16, iters=4)
            assert svc._tune_state is not None
            tunes_before = sum(svc.tune_counts.values())
            for i in range(0, 150):
                svc.remove_node(f"n{i}")
            _index(svc, rows[900:], prefix="m")
            deadline = time.time() + 60
            while time.time() < deadline:
                with svc._lock:
                    done = (sum(svc.tune_counts.values()) > tunes_before
                            and not svc._retuning
                            and svc._churn_since_tune < 32)
                if done:
                    break
                time.sleep(0.1)
            assert sum(svc.tune_counts.values()) > tunes_before, (
                "drift never triggered a re-tune", svc.tune_counts,
                svc._churn_since_tune)
            state = svc._tune_state
            assert state.outcome == "ok", state.as_dict()
            # the floor holds over the POST-churn corpus: tuned serving
            # sees the new rows
            corpus = svc.corpus()
            kwargs = svc._corpus_search_kwargs(corpus)
            assert kwargs.get("n_probe", 0) > 0
            eval_rows = rows[900:][:16]
            exact = corpus.search(eval_rows, k=10, exact=True)
            tuned = corpus.search(eval_rows, k=10, **kwargs)
            assert _recall(tuned, exact) >= 0.9
        finally:
            svc.shutdown()

    def test_no_retune_below_threshold(self):
        svc = _service(drift_threshold=0.9)
        rows, _ = _clustered(800, 32, 16, seed=8)
        _index(svc, rows[:700])
        try:
            svc.recluster(k=16, iters=4)
            tunes_before = sum(svc.tune_counts.values())
            _index(svc, rows[700:], prefix="x")
            time.sleep(0.5)
            assert sum(svc.tune_counts.values()) == tunes_before
            assert svc._churn_since_tune == 100
        finally:
            svc.shutdown()


@pytest.mark.parametrize("recall_target,outcome", [(0.9, "ok"),
                                                    (0.99, "floor_unmet")])
def test_slice_matches_jax_from_the_same_fit(recall_target, outcome):
    """The whole IVF slice against the JAX package: JAX's service fits,
    tunes and serves; the port's service installs JAX's fit, tunes and
    serves. Same outcome, n_probe and measured recall, same ids. (At 0.99
    the bf16 scores swap neighbours at rank 20 against the exact float32
    truth, so no n_probe meets the floor: the full scan serves.)"""
    rows, _ = _clustered(1200, 32, 24, seed=21, spread=0.3)
    ids = [f"n{i}" for i in range(1200)]
    cfg = dict(tune_min_rows=256, tune_sample=24, tune_k=20,
               recall_target=recall_target, drift_threshold=0.0)
    jsvc = JaxSearchService(MemoryEngine(), dims=32,
                            config=JaxSearchConfig(**cfg))
    tsvc = SearchService(dims=32, config=SearchConfig(**cfg), device="cpu")
    try:
        for i, v in zip(ids, rows):
            jsvc.index_node(JaxNode(id=i, labels=["D"], properties={},
                                    embedding=v))
            tsvc.index_node(Node(id=i, embedding=v))
        jsvc.recluster(k=24, iters=5)
        jstate = jsvc._tune_state
        tcorpus = tsvc.corpus()
        tcorpus.set_clusters(jsvc.cluster_result.centroids,
                             jsvc.cluster_assignments)
        tstate = tsvc.run_tune(tcorpus)
        assert tstate.outcome == jstate.outcome == outcome
        assert tstate.n_probe == jstate.n_probe
        assert tstate.measured_recall == jstate.measured_recall
        assert tstate.ladder_evals == jstate.ladder_evals
        # the tuner alone, on the same corpus, agrees as well
        assert IVFTuner(recall_target=recall_target, sample=24, k=20).tune(
            tcorpus).n_probe == JaxTuner(recall_target=recall_target,
                                         sample=24, k=20).tune(
            jsvc.corpus()).n_probe
        rng = np.random.default_rng(22)
        for q in rows[rng.integers(0, 1200, 6)] + 0.1 * rng.normal(
                size=(6, 32)).astype(np.float32):
            a = jsvc.vector_candidates(q, k=10)
            b = tsvc.vector_candidates(q, k=10)
            assert [i for i, _ in b] == [i for i, _ in a]
            assert np.allclose([s for _, s in b], [s for _, s in a],
                               atol=1e-5, rtol=0)
    finally:
        jsvc.shutdown()
        tsvc.shutdown()
