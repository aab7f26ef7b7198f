"""Hybrid search service of the port (``nornicdb_tpu/search/service.py``):
device vector search + BM25 + RRF fusion, an optional cross-encoder rerank
and MMR, a ranked-result cache, and indexing fed by storage events.

``search`` (what ``/nornicdb/search`` and ``DB.recall`` call): the ranked
cache, else ``_rank``: the query embedded by the service's embedder, the
vector leg (``vector_candidates``), the BM25 leg, ``fuse_rrf`` with
``adaptive_rrf_weights``, then the rerank and MMR; the ranked head is
enriched from storage outside the service lock.

The vector leg: the device-resident corpus is the serving path at every N
(``backend`` "auto" or "tpu", the JAX config's name for it):
``vector_candidates`` -> QueryBatcher (optional) -> ``DeviceCorpus.search``
-> the streaming top-k kernels on the card, or, once ``recluster`` has
fitted k-means and the tuner has measured a plan that meets
``recall_target``, the IVF-pruned search (``search(n_probe=...)`` ->
``ops/ivf.py``). Mutations age the plan: past ``drift_threshold`` of the
corpus a background recluster + re-tune restores it. ``backend="hnsw"``
selects the host HNSW index instead.

Telemetry as in the JAX package: the ``search.rank``, ``search.embed`` and
(unbatched) ``search.vector`` spans, the device-time histogram of unbatched
dispatches, and the tuner's outcome counter and plan gauges.

Configuration is layered as in the JAX package: an explicit
``SearchService(config=...)`` > ``configure_defaults`` > the
``NORNICDB_SEARCH_<FIELD>`` environment > the dataclass defaults
(``default_search_config``). With a ``vectorspaces`` registry the service
registers its ``default`` space when the vector index is created.

``graph_masked_scores`` is the Cypher ``VectorTopK`` operator's device
scoring: one masked float32 product over the label's normalized embedding
matrix, resident on the caller's device, gated by the device owner.

Not ported (ROADMAP A7): shard promotion and ``backend="sharded"`` (with
them the sharded IVF layout, the tuner's ``local_k`` and the
``nornicdb_shard_*`` families; a non-default value of their config fields
is refused, as ``backend="sharded"`` is).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import asdict, dataclass, fields
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.config import _coerce_env
from nornicdb_tpu_torch.embed.base import Embedder
from nornicdb_tpu_torch.embed.queue import build_embedding_text
from nornicdb_tpu_torch.errors import NotFoundError
from nornicdb_tpu_torch.ops.kmeans import KMeansResult, kmeans_fit
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.search.batcher import QueryBatcher
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.fusion import (
    adaptive_rrf_weights,
    apply_mmr,
    fuse_rrf,
)
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
from nornicdb_tpu_torch.search.tuner import (
    TUNE_OUTCOMES,
    IVFTuner,
    TuneState,
    count_tune_outcome,
    publish_plan,
)
from nornicdb_tpu_torch.storage.types import Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

logger = logging.getLogger(__name__)

# same families the QueryBatcher feeds (idempotent re-resolution by name):
# unbatched corpus dispatches report device time too, and the queue-wait
# family is registered even before batching is ever enabled
_DEVICE_HIST = _REGISTRY.histogram(
    "nornicdb_search_device_seconds",
    "Device dispatch time per search batch",
)
_REGISTRY.histogram(
    "nornicdb_search_queue_wait_seconds",
    "Time a batched search waited for its batch to dispatch",
)


# -- graph x vector fusion -----------------------------------------------------
def _pow2_row_bucket(n: int) -> int:
    """Row/k counts padded to power-of-two shape classes, so the resident
    corpus is reused across queries whose survivor count varies."""
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def graph_masked_scores(
    qn: np.ndarray,
    corpus: np.ndarray,
    valid: np.ndarray,
    k: int,
    desc: bool,
    dev_ref: Optional[list] = None,
    device: DeviceLike = None,
    backend=None,
):
    """Device scoring for the Cypher ``VectorTopK`` operator: one masked
    float32 product (``ops.similarity.masked_dot_topk``) over a
    row-normalized ``corpus`` (n, d) with the graph-predicate survivors as
    ``valid``, on ``device`` (None: CUDA). Returns ``(scores, boundary)``:
    per-row cosine scores (length n, original orientation, float64) and
    the kth best masked score in that orientation. ``desc=False`` (ORDER
    BY ... ASC) runs on the negated query. ``dev_ref`` is a one-slot list
    caching the padded device-resident corpus across queries of the same
    shape bucket.

    The device owner gates the call (``backend``, else the process default
    for a CUDA device): a card that is not serving raises
    DeviceUnavailable. Device errors propagate."""
    import torch

    from nornicdb_tpu_torch import backend as _bk
    from nornicdb_tpu_torch.ops.similarity import LANE, masked_dot_topk
    from nornicdb_tpu_torch.telemetry import deviceprof as _deviceprof

    dev = resolve_device(device)
    _bk.gate(dev, backend)
    n = corpus.shape[0]
    rows_pad = max(_pow2_row_bucket(n), LANE)
    k_pad = min(_pow2_row_bucket(max(k, 1)), rows_pad)
    t0 = time.perf_counter()
    resident = None
    if dev_ref and dev_ref[0] is not None:
        cached_pad, cached_dev, cached = dev_ref[0]
        if cached_pad == rows_pad and cached_dev == dev:
            resident = cached
    if resident is None:
        buf = np.zeros((rows_pad, corpus.shape[1]), np.float32)
        buf[:n] = corpus
        resident = torch.from_numpy(buf).to(dev)
        if dev_ref is not None:
            dev_ref[0] = (rows_pad, dev, resident)
    vpad = np.zeros(rows_pad, bool)
    vpad[:n] = valid
    q = np.asarray(qn if desc else -qn, np.float32)
    scores, top = masked_dot_topk(
        torch.from_numpy(q).to(dev), resident,
        torch.from_numpy(vpad).to(dev), k_pad)
    scores = scores[:n].double().cpu().numpy()
    boundary = float(top[min(k, k_pad) - 1])
    _deviceprof.record_execute(
        "cypher", "vector_topk", _deviceprof.pow2_class(rows_pad, "n"),
        time.perf_counter() - t0)
    if not desc:
        # undo the ASC negation; masked rows become +inf, which can never
        # pass the caller's `score <= boundary + eps` cut
        scores = -scores
        boundary = -boundary
    return scores, boundary


@dataclass
class SearchStats:
    indexed: int = 0
    removed: int = 0
    searches: int = 0
    vector_candidates: int = 0
    fulltext_candidates: int = 0


# backends the port serves; "sharded" (the JAX mesh corpus) is ROADMAP A7
BACKENDS = ("auto", "tpu", "hnsw")
# SearchConfig fields only the sharded corpus reads (ROADMAP A7)
SHARDED_FIELDS = ("sharded_min_rows", "local_k", "int8_residency",
                  "rescore_factor")


@dataclass
class SearchConfig:
    """The JAX package's SearchConfig: the same fields, names and defaults.
    ``SHARDED_FIELDS`` belong to the sharded corpus (ROADMAP A7): a
    service refuses any value of theirs but the default."""

    min_similarity: float = 0.0
    rrf_k: float = 60.0
    mmr_enabled: bool = False
    mmr_lambda: float = 0.7
    candidates_multiplier: int = 4  # fetch k*mult candidates per leg
    # "auto" | "tpu": the device corpus on the service's device (the JAX
    # config's name for it is kept); "hnsw": the host HNSW index
    backend: str = "auto"
    # the sharded corpus's promotion threshold (ROADMAP A7)
    sharded_min_rows: int = 100_000
    # exact=True full-sorts (recall 1.0, slower); the default membership
    # honors the ~0.95 recall contract
    exact: bool = False
    # per-shard candidate count of the sharded merge (ROADMAP A7)
    local_k: int = 0
    # cross-encoder second stage, gated like the reference's feature flag
    rerank_enabled: bool = False
    rerank_candidates: int = 20
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
    # int8 residency and its exact rescore, of the sharded corpus
    # (ROADMAP A7)
    int8_residency: bool = False
    rescore_factor: int = 4
    # write-behind device sync: a background thread coalesces dirty corpus
    # blocks and patches them between queries, so a query after a write
    # burst waits for a bounded patch instead of staging the whole burst
    write_behind: bool = False
    write_behind_interval: float = 0.002


# -- default-config layering -------------------------------------------------
# A server installs the operator's AppConfig.search section here before any
# SearchService exists; embedded processes can set the same knobs via
# NORNICDB_SEARCH_<FIELD>, read once per service construction. Precedence:
# explicit SearchService(config=...) > configure_defaults() > env >
# dataclass defaults.
_DEFAULTS_LOCK = threading.Lock()
_CONFIG_DEFAULTS: dict[str, Any] = {}


def refuse_unported(values: dict) -> None:
    """Raise for an option only the sharded corpus reads (ROADMAP A7) set
    to anything but its default, so that no option silently does
    nothing."""
    default = SearchConfig()
    if values.get("backend") == "sharded":
        raise ValueError(
            'backend="sharded" (the mesh-sharded corpus) is not ported '
            "yet (ROADMAP A7); use \"auto\" or \"hnsw\"")
    bad = sorted(name for name in SHARDED_FIELDS
                 if name in values
                 and values[name] != getattr(default, name))
    if bad:
        raise ValueError(
            f"SearchConfig {', '.join(f'{n}={values[n]!r}' for n in bad)}: "
            "the sharded corpus these options tune is not ported yet "
            "(ROADMAP A7); leave them at their defaults")


def configure_defaults(**kwargs) -> None:
    """Set process-wide SearchConfig defaults (unknown keys rejected, and
    the sharded corpus's options refused: ``refuse_unported``)."""
    known = {f.name for f in fields(SearchConfig)}
    bad = set(kwargs) - known
    if bad:
        raise ValueError(f"unknown SearchConfig field(s): {sorted(bad)}")
    refuse_unported(kwargs)
    with _DEFAULTS_LOCK:
        _CONFIG_DEFAULTS.update(kwargs)


def default_search_config() -> SearchConfig:
    """The dataclass defaults, overridden by ``NORNICDB_SEARCH_<FIELD>``
    (coerced as ``config.load_from_env`` coerces, so a value parses the
    same in served and embedded processes), then by
    ``configure_defaults``."""
    cfg = SearchConfig()
    for f in fields(SearchConfig):
        raw = os.environ.get(f"NORNICDB_SEARCH_{f.name.upper()}")
        if raw is not None:
            setattr(cfg, f.name, _coerce_env(getattr(cfg, f.name), raw))
    with _DEFAULTS_LOCK:
        overrides = dict(_CONFIG_DEFAULTS)
    for name, value in overrides.items():
        setattr(cfg, name, value)
    return cfg


class SearchService:
    """Hybrid search over a storage engine. ``storage`` and ``embedder`` are
    the JAX constructor's; without ``storage`` the service serves the vector
    leg only (``vector_candidates`` over ``index_node`` /
    ``index_vectors``), and ``search`` needs one. ``config`` defaults to
    ``default_search_config()``; ``brute_force_max`` is the JAX
    constructor's (kept for parity, unused); ``vectorspaces`` is the DB's
    registry. ``device=None`` means CUDA (DeviceUnavailable without a
    card); ``device="cpu"`` runs the kernels' plain versions and the
    cross-encoder on the CPU."""

    def __init__(
        self,
        storage: Optional[Engine] = None,
        embedder: Optional[Embedder] = None,
        dims: int = 0,
        config: Optional[SearchConfig] = None,
        brute_force_max: int = 0,
        vectorspaces=None,
        device: DeviceLike = None,
    ):
        del brute_force_max  # the JAX constructor's; unused there too
        self.device = resolve_device(device)
        self.storage = storage
        self.embedder = embedder
        self.config = config or default_search_config()
        self.vectorspaces = vectorspaces
        refuse_unported(vars(self.config))
        if self.config.backend not in BACKENDS:
            raise ValueError(f"unknown search backend {self.config.backend!r}")
        self.stats = SearchStats()
        self._lock = threading.RLock()
        self._dims = dims or (embedder.dimensions() if embedder else 0)
        self._corpus: Optional[DeviceCorpus] = None
        self._hnsw: Optional[HNSWIndex] = None
        self._batcher: Optional[QueryBatcher] = None
        self._bm25 = BM25Index()
        self._vectors: dict[str, np.ndarray] = {}  # normalized, for MMR
        # id -> (text digest, embedding digest): no-op updates (the access
        # count touch of every recall hit) skip re-indexing, which would
        # otherwise dirty corpus blocks and kill the rank cache
        self._fingerprints: dict[str, tuple[bytes, bytes]] = {}
        self._reranker = None
        self._event_cb = None
        # ranked-result cache keyed by (query, limit, min_sim): only the
        # ranked (id, score, vec, ft) tuples; node data is fetched again on
        # each hit, so updates that do not re-index never go stale. Any
        # index mutation bumps _generation, which makes every older entry
        # dead on lookup (O(1) invalidation).
        self._generation = 0
        self._rank_cache: "OrderedDict[tuple, tuple[int, float, list]]" = (
            OrderedDict())
        self._rank_cache_max = 2048
        self._rank_cache_ttl = 30.0
        # the last k-means fit (recluster)
        self.cluster_result: Optional[KMeansResult] = None
        self.cluster_assignments: dict[str, int] = {}
        # recall-governed IVF plan (n_probe + its measured-recall evidence),
        # the layout it was measured on, and the drift bookkeeping that
        # schedules background re-tunes
        self._tune_state: Optional[TuneState] = None
        self._tuned_layout_ref: Optional[weakref.ref] = None
        self.tune_counts: dict[str, int] = {o: 0 for o in TUNE_OUTCOMES}
        self._churn_since_tune = 0
        self._retuning = False

    # -- index plumbing ----------------------------------------------------
    def _ensure_vector_index(self, dims: int) -> None:
        """Create the vector index on first use, with no service lock held
        (a device buffer is allocated). Construction races resolve under the
        lock; the loser's index is discarded before it starts anything."""
        with self._lock:
            if self._corpus is not None or self._hnsw is not None:
                return
        corpus = hnsw = None
        if self.config.backend == "hnsw":
            hnsw = HNSWIndex(dims=dims)
        else:
            corpus = DeviceCorpus(dims=dims, device=self.device)
        with self._lock:
            if self._corpus is not None or self._hnsw is not None:
                return  # lost the creation race: drop ours
            self._dims = dims
            if self.vectorspaces is not None:
                from nornicdb_tpu_torch.vectorspace import VectorSpaceKey

                self.vectorspaces.register(VectorSpaceKey("default", dims))
            self._corpus, self._hnsw = corpus, hnsw
            if corpus is not None and self.config.write_behind:
                corpus.start_uploader(self.config.write_behind_interval)

    def index_node(self, node: Node) -> None:
        """Index (or re-index) one node: its text in BM25, its embedding in
        the vector index and the MMR map. A node whose text or embedding
        was dropped leaves that index; an unchanged node is a no-op."""
        text = build_embedding_text(node)
        emb = (
            np.asarray(node.embedding, np.float32)
            if node.embedding is not None else None
        )
        fp = (
            hashlib.blake2s(text.encode()).digest(),
            hashlib.blake2s(emb.tobytes()).digest() if emb is not None
            else b"",
        )
        if emb is not None and self._corpus is None and self._hnsw is None:
            # OUTSIDE the service lock; the unlocked check is a benign race
            # (_ensure_vector_index is idempotent and double-checked)
            self._ensure_vector_index(emb.shape[0])
        with self._lock:
            if self._fingerprints.get(node.id) == fp:
                return  # unchanged: keep the device corpus clean
            self._fingerprints[node.id] = fp
            self._generation += 1  # kills every cached ranking
            if text:
                self._bm25.index(node.id, text)
            else:
                self._bm25.remove(node.id)  # text dropped on update
            if emb is not None:
                n = np.linalg.norm(emb)
                vn = emb / n if n > 1e-12 else emb
                self._vectors[node.id] = vn
                if self._corpus is not None:
                    self._corpus.add(node.id, vn)
                if self._hnsw is not None:
                    self._hnsw.add(node.id, vn)
            elif node.id in self._vectors:  # embedding dropped on update
                self._vectors.pop(node.id, None)
                if self._corpus is not None:
                    self._corpus.remove(node.id)
                if self._hnsw is not None:
                    self._hnsw.remove(node.id)
            self.stats.indexed += 1
        self._note_churn()

    def index_vectors(self, ids: list[str], vecs: np.ndarray) -> None:
        """Bulk load of embeddings without text: one ``add_batch`` into the
        corpus (the port's bulk path; the JAX service indexes node by
        node)."""
        if not ids:
            return
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vn = vecs / np.where(norms > 1e-12, norms, 1.0)  # as index_node
        self._ensure_vector_index(vecs.shape[1])
        with self._lock:
            self._generation += 1
            for id_ in ids:
                self._fingerprints.pop(id_, None)
            self._vectors.update(zip(ids, vn))
            if self._corpus is not None:
                self._corpus.add_batch(ids, vn)
            if self._hnsw is not None:
                for id_, v in zip(ids, vn):
                    self._hnsw.add(id_, v)
            self.stats.indexed += len(ids)
        self._note_churn(len(ids))

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._generation += 1
            self._fingerprints.pop(node_id, None)
            self._bm25.remove(node_id)
            self._vectors.pop(node_id, None)
            if self._corpus is not None:
                self._corpus.remove(node_id)
            if self._hnsw is not None:
                self._hnsw.remove(node_id)
            self.stats.removed += 1
        self._note_churn()

    def build_indexes(self) -> int:
        """Full rebuild from storage; returns the nodes indexed."""
        n = 0
        for node in self.storage.all_nodes():
            self.index_node(node)
            n += 1
        return n

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
        """Top-k (id, score) of one query embedding. The index references
        are taken under the lock and the search runs outside it."""
        with self._lock:
            self.stats.vector_candidates += 1
            corpus, hnsw = self._corpus, self._hnsw
        if corpus is not None:
            if self.config.batching_enabled:
                return self.ensure_batcher().search(embedding, k,
                                                    min_similarity)
            kwargs = self._corpus_search_kwargs(corpus)
            t0 = time.perf_counter()
            with _tracer.span("search.vector"):
                res = corpus.search(
                    embedding, k=k, min_similarity=min_similarity, **kwargs)
            # unbatched dispatches land in the same device-time histogram
            # the batcher feeds
            _DEVICE_HIST.observe(time.perf_counter() - t0)
            return res[0] if res else []
        if hnsw is not None:
            return [(i, s) for i, s in hnsw.search(embedding, k)
                    if s >= min_similarity]
        return []

    def search(
        self,
        query: str,
        limit: int = 10,
        min_similarity: Optional[float] = None,
        query_embedding: Optional[np.ndarray] = None,
    ) -> list[dict[str, Any]]:
        """Hybrid RRF search: up to ``limit`` dicts (id, node, score,
        vector_score, fulltext_score, content, labels), best first."""
        if self.storage is None:
            raise ValueError("search enriches from storage: construct the "
                             "service with one (vector_candidates needs none)")
        self.stats.searches += 1
        min_sim = (self.config.min_similarity if min_similarity is None
                   else min_similarity)
        cache_key = None
        if query_embedding is None and query:
            cache_key = (query, limit, min_sim)
            with self._lock:
                hit = self._rank_cache.get(cache_key)
                if hit is not None:
                    gen, ts, _ = hit
                    if (gen == self._generation
                            and time.monotonic() - ts < self._rank_cache_ttl):
                        self._rank_cache.move_to_end(cache_key)
                    else:
                        del self._rank_cache[cache_key]
                        hit = None
            if hit is not None:
                # enrich OUTSIDE the lock: node fetches must not serialize
                # concurrent hits or block index writers
                return self._enrich(hit[2], limit)
        # snapshot the generation BEFORE ranking: a mutation racing _rank()
        # must make this entry dead on arrival, not cached as current
        gen_before = self._generation
        rank = self._rank(query, limit, min_sim, query_embedding)
        if cache_key is not None:
            with self._lock:
                self._rank_cache[cache_key] = (
                    gen_before, time.monotonic(), rank)
                self._rank_cache.move_to_end(cache_key)
                while len(self._rank_cache) > self._rank_cache_max:
                    self._rank_cache.popitem(last=False)
        return self._enrich(rank, limit)

    def _rank(
        self,
        query: str,
        limit: int,
        min_sim: float,
        query_embedding: Optional[np.ndarray],
    ) -> list[tuple[str, float, Optional[float], Optional[float]]]:
        """The expensive half of a search: embed + vector + BM25 + fusion
        (+ rerank/MMR). Returns ordered (id, score, vec_score, ft_score)."""
        with _tracer.span("search.rank"):
            return self._rank_inner(query, limit, min_sim, query_embedding)

    def _rank_inner(
        self,
        query: str,
        limit: int,
        min_sim: float,
        query_embedding: Optional[np.ndarray],
    ) -> list[tuple[str, float, Optional[float], Optional[float]]]:
        n_cand = max(limit * self.config.candidates_multiplier, limit)
        ranked: dict[str, list[str]] = {}
        vec_scores: dict[str, float] = {}
        if query_embedding is None and self.embedder is not None and query:
            with _tracer.span("search.embed"):
                query_embedding = self.embedder.embed(query)
        if query_embedding is not None:
            vec = self.vector_candidates(query_embedding, n_cand, min_sim)
            ranked["vector"] = [i for i, _ in vec]
            vec_scores = dict(vec)
        ft = self._bm25.search(query, n_cand) if query else []
        if ft:
            ranked["fulltext"] = [i for i, _ in ft]
        ft_scores = dict(ft)
        if not ranked:
            return []
        fused = fuse_rrf(ranked, adaptive_rrf_weights(query), self.config.rrf_k)
        ordered = [i for i, _ in fused]
        if self.config.rerank_enabled and query:
            ordered = self._apply_rerank(query, ordered)
        if self.config.mmr_enabled:
            rel = dict(fused)
            with self._lock:
                ordered = apply_mmr(ordered, rel, self._vectors, limit,
                                    self.config.mmr_lambda)
        score_map = dict(fused)
        return [
            (id_, score_map[id_], vec_scores.get(id_), ft_scores.get(id_))
            for id_ in ordered[: max(limit, self.config.rerank_candidates)]
        ]

    def _enrich(
        self,
        rank: list[tuple[str, float, Optional[float], Optional[float]]],
        limit: int,
    ) -> list[dict[str, Any]]:
        """Fetch the nodes of the ranked head. Always reads storage, so
        cached rankings serve fresh node data; ids deleted since ranking
        drop out."""
        results = []
        for id_, score, vs, fs in rank:
            if len(results) >= limit:
                break
            try:
                node = self.storage.get_node(id_)
            except NotFoundError:
                continue
            results.append({
                "id": id_,
                "node": node,
                "score": score,
                "vector_score": vs,
                "fulltext_score": fs,
                "content": node.properties.get("content", ""),
                "labels": node.labels,
            })
        return results

    # -- cross-encoder second stage -----------------------------------------
    def set_reranker(self, reranker) -> None:
        self._reranker = reranker

    def _apply_rerank(self, query: str, ordered: list[str]) -> list[str]:
        """Reorder the fused head by the cross-encoder (one forward over the
        head's pairs on the service's device); ids missing from storage
        keep their head position, not the tail."""
        reranker = self._reranker
        if reranker is None:
            from nornicdb_tpu_torch.search.rerank import CrossEncoderReranker

            reranker = self._reranker = CrossEncoderReranker(
                device=self.device)
        head = ordered[: self.config.rerank_candidates]
        candidates = []
        missing = []
        for id_ in head:
            try:
                node = self.storage.get_node(id_)
            except NotFoundError:
                missing.append(id_)
                continue
            candidates.append((id_, build_embedding_text(node)[:1000]))
        if not candidates:
            return ordered
        reranked = [i for i, _ in reranker.rerank(query, candidates)]
        new_head = reranked + missing
        head_set = set(new_head)
        return new_head + [i for i in ordered if i not in head_set]

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
            mgr = corpus.backend
            if mgr is not None:
                # the corpus's device owner: the process default once a
                # CUDA corpus resolved it, or an injected one
                out["backend"] = mgr.stats()
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
        # the device owner's gate before the fit touches the device and
        # before any lock: a card that is not serving raises
        corpus.device_gate()
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
            count_tune_outcome("too_small")
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
            serving = self._tune_state
        # gauges reflect the plan the service actually SERVES (after the
        # keep/replace decision), not whatever the last tune measured
        publish_plan(serving)

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


    # -- wiring ------------------------------------------------------------
    def attach(self, engine: Engine) -> None:
        """Subscribe to the engine's node events: created and updated nodes
        are indexed, deleted ones removed."""

        def _on(kind: str, entity) -> None:
            if not isinstance(entity, Node):
                return
            if kind in ("node_created", "node_updated"):
                self.index_node(entity)
            elif kind == "node_deleted":
                self.remove_node(entity.id)

        self._event_cb = _on
        engine.on_event(_on)

    def detach(self, engine: Engine) -> None:
        """Unsubscribe (a discarded service must not keep indexing)."""
        cb = self._event_cb
        if cb is not None:
            engine.off_event(cb)
            self._event_cb = None

    def shutdown(self) -> None:
        """Stop the background resources: the corpus's write-behind uploader
        and the batcher's dispatcher."""
        with self._lock:
            corpus, batcher = self._corpus, self._batcher
        if corpus is not None:
            corpus.stop_uploader()
        if batcher is not None:
            batcher.close()
