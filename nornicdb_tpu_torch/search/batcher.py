"""Micro-batching for vector search dispatch (counterpart of
``nornicdb_tpu/search/batcher.py``).

Concurrent search calls coalesce into ONE device program: each dispatch has
a fixed cost (host-to-device transfer, launches, the result copy back), so
N concurrent single-query searches collapse into one (N, D) streaming top-k.

QueryBatcher: callers block up to `window` seconds while a batch
accumulates; one dispatcher thread flushes the batch through the corpus and
fans results back out. Kept from the JAX package: continuous batching, the
`max_queue` shed, the deadline shed and BatcherStats. The cost-model
admission and the telemetry histograms are still to be ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from nornicdb_tpu_torch.errors import ResourceExhausted


@dataclass
class _Pending:
    query: np.ndarray
    k: int
    min_similarity: float
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[list] = None
    error: Optional[Exception] = None
    enqueued: float = 0.0  # perf_counter at submit
    deadline: float = 0.0  # monotonic; 0 = none


@dataclass
class BatcherStats:
    queries: int = 0
    batches: int = 0
    max_batch: int = 0
    sheds_queue_full: int = 0
    sheds_deadline: int = 0

    @property
    def avg_batch(self) -> float:
        return self.queries / self.batches if self.batches else 0.0

    def as_dict(self) -> dict:
        return {
            "queries": self.queries,
            "batches": self.batches,
            "max_batch": self.max_batch,
            "avg_batch": self.avg_batch,
            "sheds_queue_full": self.sheds_queue_full,
            "sheds_deadline": self.sheds_deadline,
        }


class QueryBatcher:
    """Coalesce concurrent search calls into one device dispatch.

    search_batch_fn(queries (N, D), k, min_similarity) -> list of per-query
    [(id, score)], the DeviceCorpus.search signature.

    Dispatch is CONTINUOUS batching (one long-lived dispatcher thread, one
    in-flight device program at a time): each batch drains everything that
    queued while the previous program ran, up to max_batch. Under low
    concurrency a query waits at most `window` for companions; under load
    the fused batch size adapts to (dispatch time x arrival rate)."""

    def __init__(
        self,
        search_batch_fn: Callable[[np.ndarray, int, float], list],
        window: float = 0.002,
        max_batch: int = 256,
        max_queue: int = 0,
        deadline: float = 0.0,
    ):
        self.search_batch_fn = search_batch_fn
        self.window = window
        self.max_batch = max_batch
        # admission control: pending queries beyond max_queue shed at submit
        # (0 = unbounded); queries older than `deadline` seconds at dispatch
        # are shed rather than served stale (0 disables)
        self.max_queue = max_queue
        self.deadline = deadline
        self.stats = BatcherStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_Pending] = []
        self._dispatcher: Optional[threading.Thread] = None
        self._closed = False

    def submit(
        self, query: np.ndarray, k: int, min_similarity: float = -1.0
    ) -> _Pending:
        """Enqueue one query without blocking. Raises ResourceExhausted at
        admission when the queue is full."""
        p = _Pending(np.asarray(query, np.float32).reshape(-1), k, min_similarity)
        p.enqueued = time.perf_counter()
        if self.deadline > 0:
            p.deadline = time.monotonic() + self.deadline
        with self._lock:
            if self.max_queue > 0 and len(self._pending) >= self.max_queue:
                self.stats.sheds_queue_full += 1
                raise ResourceExhausted(
                    f"search batch queue full ({len(self._pending)} "
                    "pending); retry with backoff", reason="queue_full",
                )
            self._pending.append(p)
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop,
                    name="nornicdb-query-batcher", daemon=True,
                )
                self._dispatcher.start()
            self._cond.notify()
        return p

    def wait(self, p: _Pending) -> list:
        """Block until a submitted query's batch dispatched. Deadline-carrying
        tickets give up at deadline + 1 s of grace."""
        if p.deadline:
            if not p.event.wait(
                max(0.05, p.deadline - time.monotonic()) + 1.0
            ):
                with self._lock:
                    self.stats.sheds_deadline += 1
                raise ResourceExhausted(
                    "search deadline exceeded", reason="deadline"
                )
        else:
            p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def search(
        self, query: np.ndarray, k: int, min_similarity: float = -1.0
    ) -> list:
        return self.wait(self.submit(query, k, min_similarity))

    def close(self) -> None:
        """Stop the dispatcher thread (tickets already queued are flushed by
        the final loop pass before it exits)."""
        with self._lock:
            self._closed = True
            self._cond.notify_all()
        t = self._dispatcher
        if t is not None:
            t.join(timeout=5)

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                # give the FIRST waiter's companions up to `window` to
                # arrive; a full batch (or close()) cuts the wait short
                deadline = self._pending[0].enqueued + self.window
                while (len(self._pending) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            self._run_batch(batch)

    def _run_batch(self, pending: list[_Pending]) -> None:
        # deadline shedding at dispatch: work that already expired is
        # answered with ResourceExhausted instead of occupying the batch
        if self.deadline > 0:
            now = time.monotonic()
            live = []
            for p in pending:
                if p.deadline and now > p.deadline:
                    with self._lock:
                        self.stats.sheds_deadline += 1
                    p.error = ResourceExhausted(
                        "search deadline exceeded before dispatch",
                        reason="deadline",
                    )
                    p.event.set()
                else:
                    live.append(p)
            pending = live
            if not pending:
                return
        try:
            queries = np.stack([p.query for p in pending])
            k = max(p.k for p in pending)
            min_sim = min(p.min_similarity for p in pending)
            results = self.search_batch_fn(queries, k, min_sim)
            with self._lock:
                self.stats.queries += len(pending)
                self.stats.batches += 1
                self.stats.max_batch = max(self.stats.max_batch, len(pending))
            for p, res in zip(pending, results):
                # per-caller k / min_similarity re-applied on the shared batch
                p.result = [
                    (i, s) for i, s in res if s >= p.min_similarity
                ][: p.k]
                p.event.set()
        except Exception as e:  # fan the failure out: nobody hangs
            for p in pending:
                p.error = e
                p.event.set()
