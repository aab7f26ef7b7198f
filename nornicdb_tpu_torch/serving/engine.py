"""Continuous ragged batching engine for the embed request path.

Counterpart of ``nornicdb_tpu/serving/engine.py``:

* **Continuous batching.** Callers (HTTP /nornicdb/embed, the search
  service's query embed, the EmbedWorker's background drains) enqueue
  texts; a scheduler packs whatever is queued, across requests, into
  ragged token-packed grids (``serving/ragged.py``) and dispatches ONE
  segment-masked forward per pack (``models/bge_m3.forward_packed``).
  Compute scales with real tokens, not bucket padding.
* **Admission control.** Bounded queue (texts + tokens); a full queue
  sheds at submit with :class:`ResourceExhausted`, and so does the cost
  model's predicted deadline, except on an idle engine (nothing queued,
  staged or in flight), which admits the request as a probe: the JAX
  engine sheds there too (ROADMAP §C). Batch sizing is
  queue-depth-aware: a deep queue dispatches full token budgets
  immediately, a shallow one waits ``batch_wait_ms`` for companions.
* **Deadline shedding.** Requests carry a deadline; expired work is shed
  at dispatch time and waiting callers give up at the deadline, so no
  request blocks indefinitely.
* **Double-buffered host staging.** A staging thread tokenizes and packs
  batch N+1 while the compute thread runs batch N (torch releases the GIL
  in its kernels and while it waits for the card). The overlap ratio is
  in the stats.

The engine IS an :class:`~nornicdb_tpu_torch.embed.base.Embedder`: drop it
around any inner embedder (``CachedEmbedder(ServingEngine(DeviceEmbedder()))``).
Inner embedders without a packed path (``HashEmbedder``) still get the
queue, admission control and cross-request batching through one
``embed_batch`` call per drained batch.

The engine reports through the port's telemetry as the JAX one does: the
families of ``serving/stats.py``, cost-model predictive admission and the
deadline budget at submit, the ``serving.queue_wait`` and ``serving.batch``
spans in the callers' traces, and ``record_execute("serving", "embed",
...)`` per pack, timed after its result reached the host.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from nornicdb_tpu_torch.config import ServingConfig
from nornicdb_tpu_torch.embed.base import Embedder
from nornicdb_tpu_torch.errors import ClosedError, ResourceExhausted
from nornicdb_tpu_torch.serving import stats as _stats
from nornicdb_tpu_torch.serving.ragged import RaggedPacker, unpack_results
from nornicdb_tpu_torch.telemetry import budget as _budget
from nornicdb_tpu_torch.telemetry import costmodel as _costmodel
from nornicdb_tpu_torch.telemetry import deviceprof as _deviceprof
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    """One embed_batch call in flight: completes when every text lands."""

    results: list
    remaining: int
    event: threading.Event = field(default_factory=threading.Event)
    error: Optional[Exception] = None
    deadline: float = 0.0  # monotonic; 0 = none
    shed: bool = False     # terminally shed (dispatcher must skip)
    ctx: object = None     # caller's trace span (cross-thread hand-off)
    enqueued: float = 0.0  # perf_counter at submit (queue-wait span)
    queue_wait_recorded: bool = False  # once per request, not per batch


@dataclass
class _Item:
    """One text of a request, the packing granularity."""

    text: str
    req: _Request
    idx: int            # position in the request's results
    est_tokens: int     # admission accounting (cheap, pre-tokenize)
    seq: Optional[list[int]] = None  # real tokens, staged lazily


@dataclass
class EngineStats:
    batches: int = 0
    packed_batches: int = 0
    texts: int = 0
    tokens: int = 0
    padded_tokens: int = 0
    sheds_queue_full: int = 0
    sheds_deadline: int = 0
    sheds_predicted: int = 0
    staging_seconds: float = 0.0
    overlap_seconds: float = 0.0
    device_seconds: float = 0.0

    def as_dict(self) -> dict:
        eff = (
            self.tokens / self.padded_tokens if self.padded_tokens else 0.0
        )
        overlap = (
            self.overlap_seconds / self.staging_seconds
            if self.staging_seconds else 0.0
        )
        return {
            "batches": self.batches,
            "packed_batches": self.packed_batches,
            "texts": self.texts,
            "tokens": self.tokens,
            "pack_efficiency": round(eff, 4),
            "sheds_queue_full": self.sheds_queue_full,
            "sheds_deadline": self.sheds_deadline,
            "sheds_predicted": self.sheds_predicted,
            "staging_overlap_ratio": round(overlap, 4),
            "device_seconds": round(self.device_seconds, 4),
        }


class ServingEngine(Embedder):
    """Continuous batching front for an inner embedder. ``config=None``
    reads ``ServingConfig.from_env()``.

    Thread model: caller threads do admission + a cheap length estimate
    and block on their request event; the staging thread tokenizes and
    packs; the compute thread dispatches packs. No engine lock is ever
    held across tokenization or a device op.
    """

    def __init__(self, inner: Embedder, config=None):
        if config is None:
            config = ServingConfig.from_env()
        self.inner = inner
        self.config = config
        self.stats = EngineStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque[_Item] = deque()
        self._queued_texts = 0
        self._queued_tokens = 0
        self._staged: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, int(config.staging_depth))
        )
        self._stop = threading.Event()
        self._started = False
        self._device_busy = False
        self._threads: list[threading.Thread] = []
        # ragged path needs a packed forward + a tokenizer on the inner
        # embedder; anything else still gets continuous batching through
        # plain embed_batch calls
        tok = getattr(inner, "tokenizer", None)
        self._tokenizer = tok if hasattr(tok, "encode") else None
        self._packer: Optional[RaggedPacker] = None
        if self._tokenizer is not None and hasattr(inner, "embed_packed"):
            cfg = getattr(inner, "cfg", None)
            self._packer = RaggedPacker(
                pad_id=self._tokenizer.pad_id,
                pad_token_id=getattr(cfg, "pad_token_id", 1),
                max_len=getattr(inner, "max_len", 512),
                max_rows=max(1, int(config.max_rows)),
                max_cells=max(64, int(config.max_batch_tokens) // 2),
            )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        for name, fn in (
            ("nornicdb-serving-stage", self._staging_loop),
            ("nornicdb-serving-compute", self._compute_loop),
        ):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Stop the pipeline; queued and staged requests fail fast with
        ClosedError rather than stranding their callers."""
        self._stop.set()
        with self._cond:
            items = list(self._queue)
            self._queue.clear()
            self._queued_texts = 0
            self._queued_tokens = 0
            self._cond.notify_all()
        for item in items:
            self._fail(item.req, ClosedError("serving engine stopped"))
        while True:
            try:
                _, items = self._staged.get_nowait()
            except queue_mod.Empty:
                break
            for item in items:
                self._fail(item.req, ClosedError("serving engine stopped"))
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    @property
    def running(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    # -- Embedder surface --------------------------------------------------
    def dimensions(self) -> int:
        return self.inner.dimensions()

    def model(self) -> str:
        return self.inner.model()

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        if not texts:
            return []
        if self._stop.is_set():
            raise ClosedError("serving engine stopped")
        self.start()
        cfg = self.config
        est = [len(t.split()) + 2 for t in texts]
        req = _Request(results=[None] * len(texts), remaining=len(texts))
        # worker-hop trace propagation (the QueryBatcher pattern): the
        # compute thread attaches this to record serving.batch and the
        # retroactive queue-wait span in the CALLER's trace
        req.ctx = _tracer.capture()
        req.enqueued = time.perf_counter()
        if cfg.deadline_ms > 0:
            req.deadline = time.monotonic() + cfg.deadline_ms / 1000.0
        with self._cond:
            # an empty queue always admits (a single oversized request
            # must serve, just in several packs); a non-empty one sheds
            # anything that would push the bounds past their limits
            if self._queued_texts > 0 and (
                self._queued_texts + len(texts) > cfg.max_queue
                or self._queued_tokens + sum(est) > cfg.max_queue_tokens
            ):
                self.stats.sheds_queue_full += 1
                _stats.SHEDS.labels("embed", "queue_full").inc()
                raise ResourceExhausted(
                    f"embed queue full ({self._queued_texts} texts / "
                    f"{self._queued_tokens} tokens queued); retry with "
                    "backoff", reason="queue_full",
                )
            if req.deadline:
                # predictive admission: the learned per-token cost of
                # the queued backlog plus this request, conservatively
                # scaled, must fit the deadline — shed at SUBMIT instead
                # of after the queue burns device time (fails open while
                # the cost model is cold; an idle engine probes)
                decision = _costmodel.COST_MODEL.decide(
                    "embed", "serving", "embed", units=sum(est),
                    slack_s=cfg.deadline_ms / 1000.0,
                    units_ahead=self._queued_tokens,
                    idle=(self._queued_texts == 0 and not self._device_busy
                          and self._staged.empty()),
                )
                if not decision.admit:
                    self.stats.sheds_predicted += 1
                    _stats.SHEDS.labels("embed", "predicted_deadline").inc()
                    raise ResourceExhausted(
                        f"predicted completion "
                        f"{decision.predicted_s * 1e3:.0f}ms exceeds the "
                        f"{cfg.deadline_ms:.0f}ms deadline budget; retry "
                        "with backoff", reason="predicted_deadline",
                    )
                _budget.open_budget(
                    _tracer.current_trace_id(), "embed",
                    cfg.deadline_ms / 1000.0,
                    {"device_sync": decision.predicted_s},
                )
            for i, t in enumerate(texts):
                self._queue.append(_Item(t, req, i, est[i]))
            self._queued_texts += len(texts)
            self._queued_tokens += sum(est)
            _stats.QUEUE_DEPTH.set(self._queued_texts)
            _stats.QUEUE_TOKENS.set(self._queued_tokens)
            self._cond.notify_all()
        self._await(req)
        _costmodel.record_latency(
            "embed", time.perf_counter() - req.enqueued)
        if req.error is not None:
            raise req.error
        return list(req.results)

    def _await(self, req: _Request) -> None:
        """Bounded wait: give up at the request deadline (plus a grace for
        an in-flight dispatch), never block indefinitely."""
        grace = 1.0
        while True:
            timeout = 1.0
            if req.deadline:
                timeout = min(
                    1.0, max(0.01, req.deadline + grace - time.monotonic())
                )
            if self._stop.is_set():
                timeout = min(timeout, 0.05)
            if req.event.wait(timeout=timeout):
                return
            if self._stop.is_set() and not self.running:
                req.error = ClosedError("serving engine stopped")
                return
            if req.deadline and time.monotonic() > req.deadline + grace:
                # dispatcher may still be running this batch; mark the
                # request shed so a late result is discarded quietly
                req.shed = True
                req.error = ResourceExhausted(
                    "embed deadline exceeded", reason="deadline"
                )
                self.stats.sheds_deadline += 1
                _stats.SHEDS.labels("embed", "deadline").inc()
                return

    # -- pipeline ----------------------------------------------------------
    def _fail(self, req: _Request, err: Exception) -> None:
        req.error = err
        req.event.set()

    def _shed_expired(self, now: float) -> None:
        """Drop queued items whose request deadline already passed (called
        under the lock)."""
        if not self._queue:
            return
        keep: deque[_Item] = deque()
        for item in self._queue:
            if item.req.deadline and now > item.req.deadline:
                if not item.req.shed:
                    item.req.shed = True
                    self.stats.sheds_deadline += 1
                    _stats.SHEDS.labels("embed", "deadline").inc()
                    self._fail(item.req, ResourceExhausted(
                        "embed deadline exceeded before dispatch",
                        reason="deadline",
                    ))
                self._queued_texts -= 1
                self._queued_tokens -= item.est_tokens
            else:
                keep.append(item)
        self._queue = keep
        # keep the depth gauges live even when shedding empties the
        # queue (no _take_batch follows to refresh them)
        _stats.QUEUE_DEPTH.set(self._queued_texts)
        _stats.QUEUE_TOKENS.set(self._queued_tokens)

    def _staging_loop(self) -> None:
        cfg = self.config
        window = max(0.0, cfg.batch_wait_ms / 1000.0)
        while not self._stop.is_set():
            with self._cond:
                while not self._queue and not self._stop.is_set():
                    self._cond.wait(0.5)
                if self._stop.is_set():
                    return
                self._shed_expired(time.monotonic())
                if not self._queue:
                    continue
                # queue-depth-aware sizing: dispatch now when a full token
                # budget is queued, else linger up to the batch window so
                # low-traffic requests pick up companions
                if self._queued_tokens < cfg.max_batch_tokens and window:
                    self._cond.wait(window)
                    self._shed_expired(time.monotonic())
                    if not self._queue:
                        continue
                # bounded snapshot of the FIFO head for tokenization
                # OUTSIDE the lock (the staging thread is the only
                # writer of item.seq; shed items are simply wasted work)
                scan = []
                for item in self._queue:
                    scan.append(item)
                    if len(scan) >= 4096:
                        break
            t0 = time.perf_counter()
            busy0 = self._device_busy
            scanned = 0
            scan_budget = max(64, int(cfg.max_batch_tokens)) * 2
            for item in scan:
                if item.seq is None and self._packer is not None:
                    item.seq = (
                        self._tokenizer.encode(
                            item.text, max_len=self._packer.max_len
                        )
                        or [self._tokenizer.pad_id]
                    )
                scanned += len(item.seq) if item.seq is not None else 1
                if scanned >= scan_budget:
                    break
            with self._cond:
                items, cap = self._take_batch()
                _stats.QUEUE_DEPTH.set(self._queued_texts)
                _stats.QUEUE_TOKENS.set(self._queued_tokens)
            if not items:
                continue
            try:
                pack = self._build_pack(items, cap)
            except Exception as e:
                logger.exception("serving pack build failed")
                for item in items:
                    self._fail(item.req, e)
                continue
            t1 = time.perf_counter()
            busy1 = self._device_busy
            # staging time covers tokenize + plan + pack — the full host
            # cost the overlap gauge claims to measure
            self.stats.staging_seconds += t1 - t0
            self.stats.overlap_seconds += (t1 - t0) * (busy0 + busy1) / 2.0
            if self.stats.staging_seconds > 0:
                _stats.STAGING_OVERLAP.set(
                    self.stats.overlap_seconds / self.stats.staging_seconds
                )
            while not self._stop.is_set():
                try:
                    # bounded put: the staging queue depth IS the double
                    # buffer — staging blocks here (not on the device)
                    # when compute falls behind
                    self._staged.put((pack, items), timeout=0.5)
                    break
                except queue_mod.Full:
                    continue
            else:
                for item in items:
                    self._fail(item.req, ClosedError("serving engine stopped"))

    def _take_batch(self) -> tuple[list[_Item], int]:
        """Pop the next pack's worth of items (called under the lock).
        Returns (items, planned_capacity); capacity 0 = unpacked path."""
        cfg = self.config
        cap = 0
        if self._packer is None:
            take = min(len(self._queue), 1024)
            items = [self._queue.popleft() for _ in range(take)]
        else:
            # class-segregated packing: the head-of-line item's capacity
            # class defines this pack's attention width, and only texts
            # that fit it ride along — short texts never pay a long
            # text's C^2 attention (longer texts head their own later
            # pack; deadline shedding bounds any wait). Tokenization
            # happened OUTSIDE the lock in the staging loop; the first
            # untokenized item marks the scan boundary.
            budget = max(64, int(cfg.max_batch_tokens))
            scan_budget = budget * 2
            eligible: list[_Item] = []
            total = scanned = 0
            for item in self._queue:
                if item.seq is None:
                    break  # beyond the pre-tokenized window
                n = len(item.seq)
                if cap == 0:
                    # short heads (<=32 tok) target ~2x their length so
                    # rows tile 2+ texts; longer heads take their own
                    # class — doubling C for them buys little fill but
                    # pays C^2 attention (a 50-token text 1-per-64-row
                    # beats 2-per-128-row on measured cells/s)
                    cap = self._packer.capacity_for(
                        min(2 * n, self._packer.max_len) if n <= 32 else n
                    )
                scanned += n
                # class band: texts shorter than cap/8 wait for a
                # narrower pack instead of paying this pack's C^2
                # attention (the head itself is always admitted, so
                # every text is eligible for the pack it heads)
                if cap // 8 <= n <= cap or not eligible:
                    eligible.append(item)
                    total += n
                    if total >= budget:
                        break
                if scanned >= scan_budget:
                    break
            take, _, _ = self._packer.plan(
                [len(i.seq) for i in eligible],
                budget_tokens=budget,
                capacity=cap,
            )
            chosen = set(id(i) for i in eligible[:take])
            items = [i for i in self._queue if id(i) in chosen]
            self._queue = deque(
                i for i in self._queue if id(i) not in chosen
            )
        for item in items:
            self._queued_texts -= 1
            self._queued_tokens -= item.est_tokens
        return items, cap

    def _build_pack(self, items: list[_Item], capacity: int = 0):
        if self._packer is None:
            return None
        return self._packer.pack(
            [i.seq for i in items], capacity=capacity
        )

    def _compute_loop(self) -> None:
        while not self._stop.is_set():
            try:
                pack, items = self._staged.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            self._device_busy = True
            t0 = time.perf_counter()
            # per-caller queue wait recorded retroactively into EACH
            # batched request's trace; the device span attaches to the
            # batch leader's (the QueryBatcher convention)
            reqs = []
            seen_req_ids = set()
            for item in items:
                if id(item.req) not in seen_req_ids:
                    seen_req_ids.add(id(item.req))
                    reqs.append(item.req)
            for req in reqs:
                # once per REQUEST: a request split across several fused
                # batches must not re-record queue wait spanning earlier
                # batches' device compute
                if req.ctx is not None and not req.queue_wait_recorded:
                    req.queue_wait_recorded = True
                    _tracer.add_span("serving.queue_wait", req.enqueued,
                                     t0, parent=req.ctx)
            leader_ctx = next(
                (r.ctx for r in reqs if r.ctx is not None), None)
            try:
                with _tracer.attach(leader_ctx), _tracer.span(
                    "serving.batch", {"texts": len(items)}
                ):
                    if pack is not None:
                        emb = self.inner.embed_packed(pack)
                        vecs = unpack_results(pack, emb)
                    else:
                        vecs = self.inner.embed_batch(
                            [i.text for i in items]
                        )
            except Exception as e:
                self._device_busy = False
                for item in items:
                    self._fail(item.req, e)
                continue
            self._device_busy = False
            dt = time.perf_counter() - t0
            # the embed path joins the deviceprof ledger (and with it
            # the cost model) keyed by packed-token pow2 class
            tokens = (pack.tokens if pack is not None
                      else sum(i.est_tokens for i in items))
            _deviceprof.record_execute(
                "serving", "embed",
                _deviceprof.pow2_class(max(tokens, 1), "t"), dt)
            self.stats.device_seconds += dt
            self.stats.batches += 1
            self.stats.texts += len(items)
            _stats.BATCHES.inc()
            if pack is not None:
                self.stats.packed_batches += 1
                self.stats.tokens += pack.tokens
                r, c = pack.ids.shape
                self.stats.padded_tokens += r * c
                _stats.PACKED_TOKENS_HIST.observe(pack.tokens)
                _stats.PACK_EFFICIENCY_HIST.observe(pack.efficiency)
            for item, vec in zip(items, vecs):
                req = item.req
                req.results[item.idx] = vec
                req.remaining -= 1
                if req.remaining <= 0 and not req.shed:
                    req.event.set()

    # -- observability -----------------------------------------------------
    def stats_snapshot(self) -> dict:
        out = self.stats.as_dict()
        with self._lock:
            out["queue_texts"] = self._queued_texts
            out["queue_tokens"] = self._queued_tokens
        out["ragged"] = self._packer is not None
        out["model"] = self.inner.model()
        if self._packer is not None:
            out["capacity_classes"] = list(self._packer.capacities)
        shapes = getattr(self.inner, "packed_shapes", None)
        if shapes:
            # copy first: the compute thread adds to the set concurrently
            out["packed_programs"] = sorted(shapes.copy())
        return out
