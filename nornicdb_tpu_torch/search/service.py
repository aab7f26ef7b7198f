"""Vector search service of the port (the vector path of
``nornicdb_tpu/search/service.py``).

The device-resident brute-force corpus is the serving path at every N:
``vector_candidates`` -> QueryBatcher (optional) -> ``DeviceCorpus.search``
-> the streaming top-k kernels on the card. BM25, HNSW, rerank, MMR, the
ranked-result cache, shard promotion and the IVF tuner are still to be
ported. ``index_node`` reads only ``node.id`` and ``node.embedding``.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.search.batcher import QueryBatcher


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

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self._fingerprints.pop(node_id, None)
            if self._corpus is not None:
                self._corpus.remove(node_id)
            self.stats.removed += 1

    # -- queries -----------------------------------------------------------
    def _corpus_search_kwargs(self, corpus: DeviceCorpus) -> dict:
        """Per-dispatch knobs: exact full-sort (IVF pruning is still to be
        ported, so there is no n_probe)."""
        del corpus
        return {"exact": True} if self.config.exact else {}

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

    def close(self) -> None:
        """Stop the batcher's dispatcher."""
        with self._lock:
            batcher = self._batcher
        if batcher is not None:
            batcher.close()
