"""Vector search service of the port (the vector path of
``nornicdb_tpu/search/service.py``).

The device-resident corpus is the serving path at every N:
``vector_candidates`` -> QueryBatcher (optional) -> ``DeviceCorpus.search``
-> the streaming top-k kernels on the card, or, once ``recluster`` has
fitted k-means and the tuner has measured a plan that meets
``recall_target``, the IVF-pruned search (``search(n_probe=...)`` ->
``ops/ivf.py``). Mutations age the plan: past ``drift_threshold`` of the
corpus a background recluster + re-tune restores it.

Still to be ported: BM25, HNSW, rerank, MMR, the ranked-result cache,
shard promotion (and with it the sharded IVF layout and the tuner's
``local_k``), and the tuner's Prometheus families. ``index_node`` reads
only ``node.id`` and ``node.embedding``.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import weakref
from dataclasses import asdict, dataclass
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.kmeans import KMeansResult, kmeans_fit
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.search.batcher import QueryBatcher
from nornicdb_tpu_torch.search.tuner import TUNE_OUTCOMES, IVFTuner, TuneState

logger = logging.getLogger(__name__)


@dataclass
class SearchStats:
    indexed: int = 0
    removed: int = 0
    vector_candidates: int = 0


@dataclass
class SearchConfig:
    """The JAX package's SearchConfig fields that the vector path uses,
    with the same names and defaults."""

    min_similarity: float = 0.0
    # exact=True full-sorts (recall 1.0, slower); the default membership
    # honors the ~0.95 recall contract
    exact: bool = False
    # micro-batching of concurrent searches into one device dispatch
    batching_enabled: bool = False
    batch_window: float = 0.002
    batch_max: int = 256
    # admission control: pending queries beyond batch_max_queue shed with
    # ResourceExhausted (0 = unbounded); queries older than
    # batch_deadline_ms at dispatch are shed too (0 disables)
    batch_max_queue: int = 1024
    batch_deadline_ms: float = 0.0
    # IVF cluster pruning, EXPLICIT OVERRIDE ONLY (0 = tuner-governed):
    # setting n_probe bypasses the recall gate below
    n_probe: int = 0
    # recall-governed IVF autotuning (search/tuner.py): operators set the
    # floor, never probe counts; a layout that cannot meet it serves the
    # full scan
    recall_target: float = 0.95
    tune_enabled: bool = True
    tune_sample: int = 64        # held-out corpus rows per measurement
    tune_k: int = 100            # recall@k the floor is measured at
    tune_min_rows: int = 4096    # below this, the full scan is the plan
    # drift-triggered re-tune: fraction of the corpus mutated (adds +
    # removes) since the last tune that schedules a background
    # recluster + re-tune (0 disables)
    drift_threshold: float = 0.25
    # k-means fit sample cap for recluster (ops.kmeans.kmeans_fit): past
    # this many live rows the Lloyd fit runs on a uniform sample and the
    # full set is assigned in chunks. 0 = always fit everything.
    cluster_fit_sample: int = 262_144


class SearchService:
    """Vector candidate search over a DeviceCorpus. ``device=None`` means
    CUDA (DeviceUnavailable without a card); ``device="cpu"`` runs the
    kernels' plain versions."""

    def __init__(
        self,
        dims: int = 0,
        config: Optional[SearchConfig] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.config = config or SearchConfig()
        self.stats = SearchStats()
        self._lock = threading.RLock()
        self._dims = dims
        self._corpus: Optional[DeviceCorpus] = None
        self._batcher: Optional[QueryBatcher] = None
        # id -> embedding digest: an unchanged re-index keeps the corpus
        # clean (no dirty block, no patch)
        self._fingerprints: dict[str, bytes] = {}
        # the last k-means fit (recluster)
        self.cluster_result: Optional[KMeansResult] = None
        self.cluster_assignments: Optional[dict[str, int]] = None
        # recall-governed IVF plan (n_probe + its measured-recall evidence),
        # the layout it was measured on, and the drift bookkeeping that
        # schedules background re-tunes
        self._tune_state: Optional[TuneState] = None
        self._tuned_layout_ref: Optional[weakref.ref] = None
        self.tune_counts: dict[str, int] = {o: 0 for o in TUNE_OUTCOMES}
        self._churn_since_tune = 0
        self._retuning = False

    # -- index plumbing ----------------------------------------------------
    def _ensure_vector_index(self, dims: int) -> DeviceCorpus:
        """Create the vector corpus on first use. Construction races
        resolve under the lock; the loser's corpus is discarded."""
        with self._lock:
            if self._corpus is not None:
                return self._corpus
        corpus = DeviceCorpus(dims=dims, device=self.device)
        with self._lock:
            if self._corpus is not None:
                return self._corpus
            self._dims = dims
            self._corpus = corpus
            return corpus

    def index_node(self, node: Any) -> None:
        """Index (or re-index) one node's embedding; a node whose embedding
        was dropped leaves the corpus."""
        emb = (
            np.asarray(node.embedding, np.float32)
            if node.embedding is not None else None
        )
        fp = hashlib.blake2s(emb.tobytes()).digest() if emb is not None else b""
        if emb is not None and self._corpus is None:
            self._ensure_vector_index(emb.shape[0])
        with self._lock:
            if self._fingerprints.get(node.id) == fp:
                return  # unchanged: keep the device corpus clean
            self._fingerprints[node.id] = fp
            if emb is not None:
                n = np.linalg.norm(emb)
                self._corpus.add(node.id, emb / n if n > 1e-12 else emb)
            elif self._corpus is not None:
                self._corpus.remove(node.id)
            self.stats.indexed += 1
        self._note_churn()

    def index_vectors(self, ids: list[str], vecs: np.ndarray) -> None:
        """Bulk load: one ``add_batch`` into the corpus."""
        if not ids:
            return
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        corpus = self._ensure_vector_index(vecs.shape[1])
        with self._lock:
            for id_ in ids:
                self._fingerprints.pop(id_, None)
            corpus.add_batch(ids, vecs)
            self.stats.indexed += len(ids)
        self._note_churn(len(ids))

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._fingerprints.pop(node_id, None)
            if self._corpus is not None:
                self._corpus.remove(node_id)
            self.stats.removed += 1
        self._note_churn()

    # -- queries -----------------------------------------------------------
    def _corpus_search_kwargs(self, corpus: DeviceCorpus) -> dict:
        """Per-dispatch knobs: exact full-sort and IVF pruning. The pruning
        plan comes from the TUNER (measured against the floor) unless the
        operator set n_probe, an escape hatch that bypasses the gate. A
        tune whose outcome is not "ok" adds nothing: the search full-scans,
        which is always recall-correct. exact=True is the recall-1.0
        contract, so the tuner never injects pruning under it."""
        del corpus  # one corpus type: every DeviceCorpus can prune
        kwargs: dict = {}
        if self.config.exact:
            kwargs["exact"] = True
        if self.config.n_probe > 0:
            kwargs["n_probe"] = self.config.n_probe
        elif not self.config.exact:
            tune = self._tune_state
            if tune is not None and tune.serving_pruned:
                # a layout whose epoch moved makes _pruned_search return
                # None and the search full-scans whatever we pass here
                kwargs["n_probe"] = tune.n_probe
        return kwargs

    def _batched_corpus_search(
        self, queries: np.ndarray, k: int, min_similarity: float
    ) -> list:
        """One device dispatch for the whole batch."""
        with self._lock:
            corpus = self._corpus
        return corpus.search(
            queries, k=k, min_similarity=min_similarity,
            **self._corpus_search_kwargs(corpus),
        )

    def corpus(self) -> Optional[DeviceCorpus]:
        """The live vector corpus (None before the first embedding)."""
        with self._lock:
            return self._corpus

    def ensure_batcher(self) -> QueryBatcher:
        """The service's QueryBatcher, created on first use with the
        config's batching knobs."""
        with self._lock:
            if self._batcher is None:
                self._batcher = QueryBatcher(
                    self._batched_corpus_search,
                    window=self.config.batch_window,
                    max_batch=self.config.batch_max,
                    max_queue=self.config.batch_max_queue,
                    deadline=self.config.batch_deadline_ms / 1000.0,
                )
            return self._batcher

    def vector_candidates(
        self, embedding: np.ndarray, k: int = 10, min_similarity: float = -1.0
    ) -> list[tuple[str, float]]:
        """Top-k (id, score) of one query embedding."""
        with self._lock:
            self.stats.vector_candidates += 1
            corpus = self._corpus
        if corpus is None:
            return []
        if self.config.batching_enabled:
            return self.ensure_batcher().search(embedding, k, min_similarity)
        res = corpus.search(
            embedding, k=k, min_similarity=min_similarity,
            **self._corpus_search_kwargs(corpus),
        )
        return res[0] if res else []

    def stats_snapshot(self) -> dict:
        """Search counters, the tuner's plan and evidence, the corpus's
        sync accounting and the batcher's batch sizes."""
        out: dict = asdict(self.stats)
        with self._lock:
            corpus, batcher = self._corpus, self._batcher
            tuner: dict = {
                "tunes": dict(self.tune_counts),
                "churn_since_tune": self._churn_since_tune,
                "drift_threshold": self.config.drift_threshold,
                "recall_target": self.config.recall_target,
                "retuning": self._retuning,
            }
            if self._tune_state is not None:
                tuner["active"] = self._tune_state.as_dict()
            out["ivf_tuner"] = tuner
        if corpus is not None:
            out["corpus"] = corpus.stats()
        if batcher is not None:
            out["batcher"] = batcher.stats.as_dict()
        return out

    # -- clustering --------------------------------------------------------
    def recluster(self, k: int = 0, iters: int = 10
                  ) -> Optional[dict[str, int]]:
        """Fit k-means over the live vectors on the service's device, install
        the fit in the corpus (its IVF layout) and tune the serving plan
        against the recall floor. Returns id -> cluster, or None when there
        is nothing to fit."""
        with self._lock:
            corpus = self._corpus
            if corpus is None:
                return None
        with corpus._sync_lock:
            live = [i for i, id_ in enumerate(corpus._ids) if id_ is not None]
            ids = [corpus._ids[i] for i in live]
            mat = corpus._host[live]  # fancy indexing copies: a snapshot
        if len(ids) < 2:
            return None
        with self._lock:
            # drift resets HERE, at the fit snapshot: mutations landing
            # while the fit and the tune run are invisible to the new layout
            # and still count against it
            self._churn_since_tune = 0
        res = kmeans_fit(mat, k=k, iters=iters,
                         sample=self.config.cluster_fit_sample,
                         device=self.device)
        del mat
        assignments = {id_: int(c) for id_, c in zip(ids, res.assignments)}
        with self._lock:
            self.cluster_result = res
            self.cluster_assignments = assignments
        # one fit, mapped onto corpus slots (no second k-means)
        corpus.set_clusters(res.centroids, assignments)
        # eval-gate the fresh layout before it serves
        self.run_tune(corpus)
        return assignments

    def run_tune(self, corpus: Optional[DeviceCorpus] = None
                 ) -> Optional[TuneState]:
        """Measure the fitted IVF layout against the recall floor and
        install the resulting serving plan. Runs with no service lock held:
        the tuner dispatches real searches."""
        cfg = self.config
        if not cfg.tune_enabled:
            return None
        if corpus is None:
            with self._lock:
                corpus = self._corpus
        if corpus is None:
            return None
        if len(corpus) < cfg.tune_min_rows:
            # a corpus this small full-scans in the noise; recording
            # too_small (rather than nothing) says WHY nothing is pruned
            state = TuneState(outcome="too_small",
                              recall_target=cfg.recall_target,
                              corpus_rows=len(corpus))
        else:
            state = IVFTuner(recall_target=cfg.recall_target,
                             sample=cfg.tune_sample, k=cfg.tune_k).tune(corpus)
        self._install_tune(state, corpus)
        return state

    def _install_tune(self, state: TuneState, corpus: DeviceCorpus) -> None:
        """Install a tune verdict as the serving plan. Transient failures
        (stale, error, degraded) keep a measured-good plan, but only while
        it was measured on the very layout object that still serves; real
        verdicts (ok, floor_unmet, no_layout, too_small) always replace."""
        layout = IVFTuner._layout_of(corpus)[0]
        with self._lock:
            transient = state.outcome in ("stale", "error", "degraded")
            old = self._tune_state
            old_ref = self._tuned_layout_ref
            keep_old = (
                transient
                and old is not None
                and old.outcome == "ok"
                and layout is not None
                and old_ref is not None
                and old_ref() is layout
            )
            if not keep_old:
                self._tune_state = state
                self._tuned_layout_ref = (
                    weakref.ref(layout)
                    if state.outcome == "ok" and layout is not None else None
                )
            self.tune_counts[state.outcome] = (
                self.tune_counts.get(state.outcome, 0) + 1)

    def _note_churn(self, n: int = 1) -> None:
        """Drift tracking: every index mutation ages the tuned plan (new
        rows are invisible to the fitted layout; removals thin it). Past
        drift_threshold x corpus size, schedule a background recluster +
        re-tune so the measured recall floor comes back without an
        operator."""
        cfg = self.config
        if not cfg.tune_enabled or cfg.drift_threshold <= 0:
            return
        with self._lock:
            self._churn_since_tune += n
            corpus = self._corpus
            if self._tune_state is None or self._retuning or corpus is None:
                return  # nothing tuned yet (recluster's job) or running
            # a too_small verdict does not pin the full scan forever: once
            # the corpus outgrows tune_min_rows, churn schedules a real tune
            size = len(corpus)
            if size < cfg.tune_min_rows:
                return
            if self._churn_since_tune < max(32, int(cfg.drift_threshold * size)):
                return
            self._retuning = True
        threading.Thread(target=self._drift_retune,
                         name="nornicdb-ivf-retune", daemon=True).start()

    def _drift_retune(self) -> None:
        """Background drift response: refit and re-tune, again while the
        write burst is still landing (a layout fitted mid-burst is stale
        when it installs), at most three times. Failures leave the old plan
        serving; the corpus's layout-epoch guard full-scans anything
        stale."""
        try:
            for _ in range(3):
                self.recluster()
                with self._lock:
                    churn = self._churn_since_tune
                    corpus = self._corpus
                size = len(corpus) if corpus is not None else 0
                trigger = max(32, int(self.config.drift_threshold * size))
                if churn < max(32, trigger // 10):
                    break
        except Exception:  # noqa: BLE001 - a background re-tune must not
            # die silently; the old plan keeps serving
            logger.exception("drift-triggered IVF re-tune failed")
        finally:
            with self._lock:
                self._retuning = False

    def close(self) -> None:
        """Stop the batcher's dispatcher."""
        with self._lock:
            batcher = self._batcher
        if batcher is not None:
            batcher.close()
