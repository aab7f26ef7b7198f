"""Background embedding worker, a copy of ``nornicdb_tpu/embed/queue.py``:
which text of a node is embedded (``build_embedding_text``), its chunking
and chunk averaging, and the ``EmbedWorker`` that drains the storage
engine's pending-embed queue through an embedder (on the card: the bge-m3
``DeviceEmbedder``, usually behind ``ServingEngine``), writes each
embedding back with ``update_node`` (which the search service indexes from
the storage event) and hands the node to ``on_embedded`` (the DB's
auto-TLP hook). Failed batches retry with backoff and stay pending; every
failure is counted (``nornicdb_embed_retries_total``, ``count_error``).

Behavioral reference: the upstream NornicDB pkg/nornicdb/embed_queue.go --
pull-based worker scanning the pending_embed index (:417 processNextBatch),
text assembly (:779 buildEmbeddingText), chunking 512 tokens / 50 overlap
(:856 chunkText), retry with backoff (:714 embedWithRetry), chunk-vector
averaging (:743 averageEmbeddings), debounced k-means trigger (:257, 30 s
quiet or >= 10 embeddings). The worker drains the queue in batches, so
each device step embeds many nodes at once.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from nornicdb_tpu_torch.embed.base import Embedder
from nornicdb_tpu_torch.errors import NotFoundError
from nornicdb_tpu_torch.storage.types import Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.metrics import count_error as _count_error

logger = logging.getLogger(__name__)

# retry/fallback visibility: attempts that failed and were retried used
# to vanish into debug logs — operators saw only the terminal `failed`
# stat.  Same family serving/stats.py registers (idempotent by name).
_RETRIES = _REGISTRY.counter(
    "nornicdb_embed_retries_total",
    "EmbedWorker embed_batch attempts that failed and were retried",
)

# Properties whose text gets embedded, in priority order
# (ref: buildEmbeddingText embed_queue.go:779).
TEXT_PROPERTIES = ("content", "text", "description", "title", "name", "summary")


def build_embedding_text(node: Node) -> str:
    parts = []
    for key in TEXT_PROPERTIES:
        v = node.properties.get(key)
        if isinstance(v, str) and v.strip():
            parts.append(v.strip())
    if not parts:  # fall back to all string properties
        for k in sorted(node.properties):
            v = node.properties[k]
            if isinstance(v, str) and v.strip():
                parts.append(v.strip())
    return "\n".join(parts)


def chunk_text(text: str, chunk_tokens: int = 512, overlap: int = 50) -> list[str]:
    """Whitespace-token chunking with overlap (ref: chunkText :856)."""
    words = text.split()
    if len(words) <= chunk_tokens:
        return [text] if text.strip() else []
    chunks = []
    step = max(chunk_tokens - overlap, 1)
    for start in range(0, len(words), step):
        chunk = words[start : start + chunk_tokens]
        chunks.append(" ".join(chunk))
        if start + chunk_tokens >= len(words):
            break
    return chunks


def average_embeddings(vectors: list[np.ndarray]) -> np.ndarray:
    """Mean + renormalize (ref: averageEmbeddings :743)."""
    v = np.mean(np.stack(vectors), axis=0)
    n = np.linalg.norm(v)
    return (v / n if n > 1e-12 else v).astype(np.float32)


@dataclass
class EmbedWorkerConfig:
    """(ref: EmbedWorkerConfig embed_queue.go:58)"""

    chunk_tokens: int = 512
    chunk_overlap: int = 50
    batch_size: int = 32
    poll_interval: float = 0.2
    max_retries: int = 3
    retry_backoff: float = 0.2
    workers: int = 1
    # debounced clustering trigger (ref: scheduleClusteringDebounced :257)
    cluster_quiet_period: float = 30.0
    cluster_min_new: int = 10


@dataclass
class EmbedWorkerStats:
    processed: int = 0
    failed: int = 0
    retries: int = 0
    batches: int = 0
    chunked_nodes: int = 0


class EmbedWorker:
    """(ref: EmbedWorker embed_queue.go:18)"""

    def __init__(
        self,
        storage: Engine,
        embedder: Embedder,
        config: Optional[EmbedWorkerConfig] = None,
        on_cluster_trigger: Optional[Callable[[], None]] = None,
        on_embedded: Optional[Callable[[Node], None]] = None,
    ):
        self.storage = storage
        self.embedder = embedder
        self.config = config or EmbedWorkerConfig()
        self.stats = EmbedWorkerStats()
        self.on_cluster_trigger = on_cluster_trigger
        # fired once per freshly-embedded node — the auto-TLP inference hook
        # (ref: the learning loop SURVEY.md §3.3: embed -> OnStore)
        self.on_embedded = on_embedded
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._since_cluster = 0
        self._last_embed_ts = 0.0
        self._cluster_lock = threading.Lock()
        # claim set: ids currently being processed, so concurrent consumers
        # (workers>1, or drain() alongside the background worker) never
        # process the same node twice
        self._claimed: set[str] = set()
        self._claim_lock = threading.Lock()
        # stats counters are read-modify-write from every consumer thread
        # (workers>1, or drain() alongside the background worker): unlocked
        # increments lose counts under GIL preemption
        self._stats_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for i in range(self.config.workers):
            t = threading.Thread(target=self._run, name=f"embed-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    @property
    def running(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.process_batch()
            except Exception:
                # a transient batch failure (storage DurabilityError under
                # ENOSPC, an embedder hiccup) must not kill the worker
                # thread forever — the queue would silently stop draining.
                # Log, count, back off, retry next tick.
                logger.warning("embed batch failed; backing off",
                               exc_info=True)
                _count_error("embed_queue")
                self._stop.wait(self.config.poll_interval)
                continue
            if n == 0:
                self._maybe_trigger_cluster()
                self._stop.wait(self.config.poll_interval)

    # -- core --------------------------------------------------------------
    def drain(self, batch: int = 0) -> int:
        """Synchronously process the whole queue (or up to `batch` nodes)."""
        total = 0
        while True:
            n = self.process_batch(batch - total if batch > 0 else 0)
            total += n
            if n == 0 or (batch > 0 and total >= batch):
                return total

    def process_batch(self, limit: int = 0) -> int:
        """One batched device step over pending nodes
        (ref: processNextBatch :417, but batched).

        Returns the number of queue entries HANDLED (embedded or unmarked as
        unembeddable) — not just embedded — so drain() keeps going while a
        batch full of textless/deleted nodes still made progress."""
        size = self.config.batch_size if limit <= 0 else min(limit, self.config.batch_size)
        with self._claim_lock:
            # fetch just enough head-of-queue ids to fill a batch past claims
            head = self.storage.pending_embed_ids(limit=size + len(self._claimed))
            ids = [i for i in head if i not in self._claimed][:size]
            self._claimed.update(ids)
        if not ids:
            return 0
        try:
            return self._process_claimed(ids)
        finally:
            with self._claim_lock:
                self._claimed.difference_update(ids)

    def _process_claimed(self, ids: list[str]) -> int:
        # Assemble (node, chunks) pairs; nodes with no text are just unmarked
        # (still counted as handled so drain() doesn't stop early).
        jobs: list[tuple[Node, list[str]]] = []
        skipped = 0
        for nid in ids:
            try:
                node = self.storage.get_node(nid)
            except NotFoundError:
                self.storage.unmark_pending_embed(nid)
                skipped += 1
                continue
            text = build_embedding_text(node)
            chunks = chunk_text(text, self.config.chunk_tokens, self.config.chunk_overlap)
            if not chunks:
                self.storage.unmark_pending_embed(nid)
                skipped += 1
                continue
            jobs.append((node, chunks))
        if not jobs:
            return skipped
        # One flat batch through the embedder (all chunks of all nodes).
        flat = [c for _, chunks in jobs for c in chunks]
        vectors = self._embed_with_retry(flat, [n.id for n, _ in jobs])
        if vectors is None:
            # batch failed terminally: mark failures, keep pending for later
            with self._stats_lock:
                self.stats.failed += len(jobs)
            return skipped
        processed = 0
        chunked = 0
        pos = 0
        for node, chunks in jobs:
            vecs = vectors[pos : pos + len(chunks)]
            pos += len(chunks)
            emb = average_embeddings(vecs) if len(vecs) > 1 else vecs[0]
            try:
                # Re-read just before writing so a concurrent touch/update
                # between our initial read and now isn't clobbered; we only
                # overlay the embedding fields onto the fresh copy.
                fresh = self.storage.get_node(node.id)
                if len(vecs) > 1:
                    chunked += 1
                    fresh.chunk_embeddings = [np.asarray(v, np.float32) for v in vecs]
                fresh.embedding = np.asarray(emb, np.float32)
                updated = self.storage.update_node(fresh)
                self.storage.unmark_pending_embed(node.id)
                processed += 1
                if self.on_embedded is not None:
                    try:
                        self.on_embedded(updated)
                    except Exception:
                        logger.exception(
                            "on_embedded callback failed for %s", node.id
                        )
                        _count_error("embed_queue")
            except NotFoundError:
                self.storage.unmark_pending_embed(node.id)
        with self._stats_lock:
            self.stats.processed += processed
            self.stats.batches += 1
            self.stats.chunked_nodes += chunked
        with self._cluster_lock:
            self._since_cluster += processed
            self._last_embed_ts = time.monotonic()
        return processed + skipped

    def _embed_with_retry(
        self, texts: list[str], node_ids: Optional[list[str]] = None
    ) -> Optional[list[np.ndarray]]:
        """(ref: embedWithRetry :714; crash recovery local_gguf.go:202)

        Every failed attempt is counted (`nornicdb_embed_retries_total` +
        component error counter) and the TERMINAL failure names the node
        batch it strands — previously retries and the final give-up were
        indistinguishable in the metrics and the affected nodes were
        invisible.  A serving-engine shed (ResourceExhausted backpressure)
        retries on the same backoff: the queue is the retry buffer."""
        delay = self.config.retry_backoff
        for attempt in range(self.config.max_retries):
            try:
                return self.embedder.embed_batch(texts)
            except Exception:
                terminal = attempt == self.config.max_retries - 1
                logger.warning(
                    "embed_batch failed (attempt %d/%d)",
                    attempt + 1, self.config.max_retries, exc_info=True,
                )
                _count_error("embed_queue")
                with self._stats_lock:
                    self.stats.retries += 1
                if terminal:
                    logger.error(
                        "embedding batch failed terminally after %d "
                        "attempts; %d node(s) stay pending: %s",
                        self.config.max_retries,
                        len(node_ids or ()),
                        ",".join(node_ids or ("<unknown>",)),
                    )
                    return None
                _RETRIES.inc()
                time.sleep(delay)
                delay *= 2
        return None

    def _maybe_trigger_cluster(self) -> None:
        """Debounce: fire when >= cluster_min_new embeddings have settled for
        cluster_quiet_period (ref: scheduleClusteringDebounced :257)."""
        if self.on_cluster_trigger is None:
            return
        with self._cluster_lock:
            if (
                self._since_cluster >= self.config.cluster_min_new
                and time.monotonic() - self._last_embed_ts >= self.config.cluster_quiet_period
            ):
                self._since_cluster = 0
            else:
                return
        try:
            self.on_cluster_trigger()
        except Exception:
            logger.exception("debounced cluster trigger failed")
            _count_error("embed_queue")
