"""Micro-batching for vector search dispatch (counterpart of
``nornicdb_tpu/search/batcher.py``).

Concurrent search calls coalesce into ONE device program: each dispatch has
a fixed cost (host-to-device transfer, launches, the result copy back), so
N concurrent single-query searches collapse into one (N, D) streaming top-k.

QueryBatcher: callers block up to `window` seconds while a batch
accumulates; one dispatcher thread flushes the batch through the corpus and
fans results back out. As in the JAX package: continuous batching, the
`max_queue` shed, the deadline shed, cost-model predictive admission at
submit, BatcherStats, the queue-wait / device / batch-size histograms and
the `search.queue_wait` span recorded into each caller's trace.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from nornicdb_tpu_torch.errors import ResourceExhausted
from nornicdb_tpu_torch.telemetry import budget as _budget
from nornicdb_tpu_torch.telemetry import costmodel as _costmodel
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

# queue wait (enqueue -> batch dispatch) vs device time (the batched GEMM
# itself): the two halves of a batched query's latency, the numbers the
# batch window is tuned from
_QUEUE_WAIT_HIST = _REGISTRY.histogram(
    "nornicdb_search_queue_wait_seconds",
    "Time a batched search waited for its batch to dispatch",
)
_DEVICE_HIST = _REGISTRY.histogram(
    "nornicdb_search_device_seconds",
    "Device dispatch time per search batch",
)
# observed coalesced batch sizes: the distribution (not just max/avg) is
# what batch_window tuning needs — a bimodal histogram means the window is
# too short for the arrival pattern
_BATCH_SIZE_HIST = _REGISTRY.histogram(
    "nornicdb_search_batch_size",
    "Queries coalesced per batched device dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
# admission-control sheds (same family the serving engine feeds for the
# embed path; idempotent by-name resolution)
_SHEDS = _REGISTRY.counter(
    "nornicdb_serving_sheds_total",
    "Requests shed by serving admission control",
    labels=("path", "reason"),
)


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
    ctx: Any = None  # caller's trace span, carried across the worker hop


@dataclass
class BatcherStats:
    queries: int = 0
    batches: int = 0
    max_batch: int = 0
    sheds_queue_full: int = 0
    sheds_deadline: int = 0
    sheds_predicted: int = 0

    @property
    def avg_batch(self) -> float:
        return self.queries / self.batches if self.batches else 0.0

    def as_dict(self) -> dict:
        """For the server stats/metrics surface: lets operators tune the
        batch window from observed batch sizes."""
        return {
            "queries": self.queries,
            "batches": self.batches,
            "max_batch": self.max_batch,
            "avg_batch": self.avg_batch,
            "sheds_queue_full": self.sheds_queue_full,
            "sheds_deadline": self.sheds_deadline,
            "sheds_predicted": self.sheds_predicted,
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
        cost_kind: str = "dense",
    ):
        self.search_batch_fn = search_batch_fn
        self.window = window
        self.max_batch = max_batch
        # deviceprof kind the predictive-admission check prices a batch
        # dispatch against ("dense": the single-device corpus)
        self.cost_kind = cost_kind
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
        p.ctx = _tracer.capture()  # None when the caller isn't traced
        with self._lock:
            if self.max_queue > 0 and len(self._pending) >= self.max_queue:
                self.stats.sheds_queue_full += 1
                _SHEDS.labels("search", "queue_full").inc()
                raise ResourceExhausted(
                    f"search batch queue full ({len(self._pending)} "
                    "pending); retry with backoff", reason="queue_full",
                )
            if p.deadline:
                # predictive admission: queries ahead mostly coalesce into
                # the same dispatch, so the wait is the batches that must
                # run before ours plus our own fused dispatch
                batches_ahead = len(self._pending) // max(1, self.max_batch)
                decision = _costmodel.COST_MODEL.decide(
                    "search", "search", self.cost_kind, units=None,
                    slack_s=self.deadline,
                    dispatches_ahead=float(batches_ahead),
                )
                if not decision.admit:
                    self.stats.sheds_predicted += 1
                    _SHEDS.labels("search", "predicted_deadline").inc()
                    raise ResourceExhausted(
                        "predicted search completion "
                        f"{decision.predicted_s * 1e3:.0f}ms exceeds the "
                        f"{self.deadline * 1e3:.0f}ms deadline budget; "
                        "retry with backoff", reason="predicted_deadline",
                    )
                _budget.open_budget(
                    _tracer.current_trace_id(), "search", self.deadline,
                    {"device_sync": decision.predicted_s},
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
                _SHEDS.labels("search", "deadline").inc()
                raise ResourceExhausted(
                    "search deadline exceeded", reason="deadline"
                )
        else:
            p.event.wait()
        if p.error is not None:
            raise p.error
        _costmodel.record_latency(
            "search", time.perf_counter() - p.enqueued)
        return p.result

    def search(
        self, query: np.ndarray, k: int, min_similarity: float = -1.0
    ) -> list:
        return self.wait(self.submit(query, k, min_similarity))

    def close(self) -> None:
        """Stop the dispatcher thread (drains nothing: callers of an
        already-closed batcher get their tickets flushed by the final
        loop pass before it exits)."""
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
                # low-concurrency coalescing: give the FIRST waiter's
                # companions up to `window` to arrive; a full batch (or
                # close()) cuts the wait short. Under load this wait never
                # triggers — the queue already holds a dispatch's worth.
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
                    _SHEDS.labels("search", "deadline").inc()
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
            t_dispatch = time.perf_counter()
            for p in pending:
                _QUEUE_WAIT_HIST.observe(t_dispatch - p.enqueued)
                # per-caller queue-wait span, recorded into the CALLER's
                # trace (the worker-hop propagation)
                if p.ctx is not None:
                    _tracer.add_span(
                        "search.queue_wait", p.enqueued, t_dispatch,
                        parent=p.ctx,
                    )
            # device work attributes to the batch leader's trace; followers
            # still get their queue-wait span above
            leader_ctx = pending[0].ctx
            with _tracer.attach(leader_ctx):
                with _tracer.span(
                    "search.batch", {"batch_size": len(pending)}
                ):
                    results = self.search_batch_fn(queries, k, min_sim)
            _DEVICE_HIST.observe(time.perf_counter() - t_dispatch)
            _BATCH_SIZE_HIST.observe(len(pending))
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
        except Exception as e:  # fan the failure out — nobody hangs
            for p in pending:
                p.error = e
                p.event.set()
