"""Continuous-batching generation engine over a paged KV cache.

Counterpart of ``nornicdb_tpu/genserve/engine.py``:

* **Paged KV cache.** One pooled buffer of fixed-size pages shared by every
  sequence, with per-sequence page tables (``models/qwen2.py``
  ``init_kv_pages``). Sequences join and leave the running batch at step
  boundaries by allocating and freeing pages.
* **One fused ragged step per iteration.** Each scheduler iteration runs
  ``qwen2.ragged_fused_step`` over every decode lane plus at most one
  prompt-prefill chunk. The flat token batch and the chunk width are
  power-of-two bucketed, so the step shapes form a small fixed set of
  classes (:meth:`GenerationEngine._ragged_classes`). On a CUDA pool the
  attention is the ragged paged attention kernel
  (``ops/csrc/ragged_paged_attention.cu``); on a CPU pool the block-gather
  torch path.
* **Shared-prefix KV caching.** Full prompt pages are content-hashed (a
  chained digest) and kept resident after their sequence finishes; a new
  prompt whose leading pages hit the cache skips prefilling them. Pages are
  refcounted and idle cached pages are reclaimed LRU under pool pressure.
* **Admission / eviction on page-pool pressure**, **deadline shedding** and
  **per-request streaming**, as in the reference.
* **``mode="dense"``**, the escape hatch: no pool; each sequence keeps a
  dense ``(1, Tmax)`` KV cache (``qwen2.prefill`` + ``qwen2.decode_step``,
  torch ops, no ragged kernel), one prefill and then one decode step per
  running sequence an iteration. On the card a sequence's decode step is
  captured as a CUDA graph at its first step and replayed after
  (``qwen2.DecodeGraph``), as the reference compiles one step program a
  cache width. It is the numeric reference the paged path is held to.

Not ported (ROADMAP): the backend gate and its DEGRADED_CPU host mirror
(the engine runs where its ``device`` says and fails a step that raises),
cost-model predictive admission, tracer spans, device profiling and the
Prometheus families.

Thread model: caller threads do admission and block on their handle; the
single scheduler thread owns the page pool, page tables and running set, so
no lock is held across device work. The engine lock guards only the queue.
The pool is updated in place by every step (the reference donates it), so a
step that raised may have half-written it: the scheduler then drops the
pool and the prefix cache that indexes it.
"""

from __future__ import annotations

import hashlib
import logging
import queue as queue_mod
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device, tree_to
from nornicdb_tpu_torch.errors import ClosedError, ResourceExhausted
from nornicdb_tpu_torch.models import qwen2

logger = logging.getLogger(__name__)

# sequence states (scheduler-owned)
_QUEUED, _PREFILL, _DECODE = "queued", "prefill", "decode"


@dataclass
class GenStats:
    requests: int = 0
    completed: int = 0
    generated_tokens: int = 0
    # fused steps run (paged mode); each runs the decode block, and a step
    # that carries a prefill chunk (prefill_chunks) also runs the chunk block
    fused_steps: int = 0
    prefill_chunks: int = 0
    decode_steps: int = 0
    decode_lane_tokens: int = 0  # real (non-padding) lanes stepped
    # prefill tokens by pass: first-pass prompt tokens vs tokens
    # re-prefilled after an eviction
    prefill_tokens_first: int = 0
    prefill_tokens_re: int = 0
    # shared-prefix cache: pages reused at admission + the prompt tokens
    # those pages made prefill skip
    prefix_hits: int = 0
    prefix_reused_tokens: int = 0
    admissions: int = 0
    readmissions: int = 0
    evictions: int = 0
    sheds_queue_full: int = 0
    sheds_deadline: int = 0
    sheds_pool: int = 0
    cancelled: int = 0
    errors: int = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class GenHandle:
    """Caller-side surface of one generation request.

    Tokens accumulate on the handle as the scheduler produces them; callers
    either stream (:meth:`stream_tokens` / :meth:`stream_text`) or wait for
    the full result (:meth:`result` / :meth:`text`). The per-token stream
    queue exists only once a consumer streams. Every wait is bounded by the
    request deadline plus a grace window.
    """

    _GRACE = 1.0

    def __init__(self, engine: "GenerationEngine", deadline: float):
        self._engine = engine
        self._mu = threading.Lock()
        self._tokens: list[int] = []
        self._stream_q: Optional[queue_mod.Queue] = None
        self._done = threading.Event()
        self.deadline = deadline  # monotonic; 0 = none
        self.error: Optional[Exception] = None
        self.shed = False  # terminal: scheduler must drop this sequence
        # prompt tokens the shared-prefix cache let prefill skip
        self.prefix_reused_tokens = 0

    # -- scheduler side ----------------------------------------------------
    def _deliver(self, tok: int) -> None:
        with self._mu:
            self._tokens.append(tok)
            q = self._stream_q
        if q is not None:
            q.put(tok)

    def _finish(self, error: Optional[Exception] = None) -> None:
        with self._mu:
            if self._done.is_set():
                return
            self.error = error
            self._done.set()
            q = self._stream_q
        if q is not None:
            q.put(None)

    # -- caller side -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def tokens(self) -> list[int]:
        with self._mu:
            return list(self._tokens)

    def _time_left(self) -> float:
        if not self.deadline:
            return 1.0
        return min(1.0, max(0.01,
                            self.deadline + self._GRACE - time.monotonic()))

    def _mark_shed(self) -> bool:
        """Atomically transition to shed; True only for the ONE thread that
        made the transition, so shed counters increment once a request."""
        with self._mu:
            if self.shed:
                return False
            self.shed = True
            return True

    def _give_up(self) -> Exception:
        """Caller-side deadline expiry: the scheduler sees .shed and frees
        the sequence's pages at the next step boundary."""
        if self._mark_shed():
            self._engine.stats.sheds_deadline += 1
        self.error = ResourceExhausted(
            "generation deadline exceeded", reason="deadline")
        return self.error

    def stream_tokens(self) -> Iterator[int]:
        """Yield token ids as the scheduler produces them (tokens already
        generated are replayed first). Raises the request's terminal error
        (shed/closed) when generation failed."""
        with self._mu:
            if self._stream_q is None:
                self._stream_q = queue_mod.Queue()
                for tok in self._tokens:
                    self._stream_q.put(tok)
                if self._done.is_set():
                    self._stream_q.put(None)
            q = self._stream_q
        while True:
            try:
                tok = q.get(timeout=self._time_left())
            except queue_mod.Empty:
                if self._done.is_set():
                    continue  # race: sentinel arriving; loop re-polls
                if self.deadline and time.monotonic() > (
                        self.deadline + self._GRACE):
                    raise self._give_up()
                continue
            if tok is None:
                if self.error is not None:
                    raise self.error
                return
            yield tok

    def stream_text(self) -> Iterator[str]:
        """Decoded text deltas (diffs of the running decode)."""
        tokenizer = self._engine.tokenizer
        if tokenizer is None:
            raise ValueError("engine has no tokenizer; stream tokens instead")
        prev = ""
        out: list[int] = []
        for tok in self.stream_tokens():
            out.append(tok)
            text = tokenizer.decode(out)
            if text != prev:
                yield text[len(prev):]
                prev = text

    def result(self, partial_ok: bool = False) -> list[int]:
        """All generated token ids (bounded wait on the completion event).
        With ``partial_ok`` a shed/failed request returns what it produced
        instead of raising."""
        while not self._done.wait(timeout=self._time_left()):
            if self.deadline and time.monotonic() > (
                    self.deadline + self._GRACE):
                err = self._give_up()
                if not partial_ok:
                    raise err
                break
        if self._done.is_set() and self.error is not None and not partial_ok:
            raise self.error
        return self.tokens

    def text(self, partial_ok: bool = False) -> str:
        tokenizer = self._engine.tokenizer
        if tokenizer is None:
            raise ValueError("engine has no tokenizer")
        return tokenizer.decode(self.result(partial_ok=partial_ok))


class _Seq:
    """Scheduler-internal state of one admitted-or-queued request."""

    __slots__ = (
        "handle", "prompt", "out", "max_new", "eos_id", "state",
        "prefill_tokens", "prefill_pos", "page_ids", "page_table",
        "cache_len", "admit_no", "dense_cache", "dense_graph", "dense_len",
        "counted",
        "prefix_keys", "re_prefill",
    )

    def __init__(self, handle: GenHandle, prompt: list[int], max_new: int,
                 eos_id: int):
        self.handle = handle
        self.prompt = prompt
        self.out: list[int] = []
        self.max_new = max_new
        self.eos_id = eos_id
        self.state = _QUEUED
        self.prefill_tokens: list[int] = []
        self.prefill_pos = 0
        self.page_ids: list[int] = []
        self.page_table: Optional[np.ndarray] = None
        self.cache_len = 0
        self.admit_no = -1
        self.dense_cache = None  # mode="dense": this sequence's KV caches
        self.dense_graph = None  # its captured decode step (CUDA only)
        self.dense_len = 0
        self.counted = False
        # chained page-content keys over this admission's prefill tokens
        # (full pages only); registered when the final chunk lands
        self.prefix_keys: Optional[list[bytes]] = None
        self.re_prefill = False  # this admission re-prefills prior work


class GenerationEngine:
    """Paged-KV continuous-batching decode engine for one Qwen2 model.

    ``params`` is the port's parameter dict (``qwen2.init_params`` or
    ``convert.qwen2_params_from_jax``), moved to ``device`` if it lies
    elsewhere. ``device=None`` means CUDA and raises DeviceUnavailable
    without a card; pass ``device="cpu"`` to serve from the CPU."""

    def __init__(self, params, cfg, tokenizer=None, config=None,
                 device: DeviceLike = None):
        if config is None:
            from nornicdb_tpu_torch.genserve import current_config

            config = current_config()
        if config.mode not in ("paged", "dense"):
            raise ValueError(f"genserve mode {config.mode!r} is neither "
                             "'paged' nor 'dense'")
        self.device = resolve_device(device)
        self.params = qwen2.with_f32_logit_weights(
            tree_to(params, self.device))
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.config = config
        self.stats = GenStats()
        # (kind, F, Tq, P) step shape classes dispatched so far
        self.programs: set = set()
        # dense mode on the card: the stream its step graphs are captured on
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self._page_size = max(1, int(config.page_size))
        self._table_width = qwen2.pages_for(int(config.max_seq_tokens),
                                            self._page_size)
        self._usable_pages = int(config.pool_pages) - 1  # page 0 = null
        if self._usable_pages < self._table_width:
            raise ValueError(
                f"genserve pool_pages={config.pool_pages} cannot hold one "
                f"max_seq_tokens={config.max_seq_tokens} sequence "
                f"({self._table_width} pages needed + the null page)")
        self._prefill_chunk = qwen2.round_up_pow2(
            max(16, int(config.prefill_chunk)), 16)
        self._max_seqs = max(1, int(config.max_seqs))
        # attention lanes of the fused step: decode lanes 0..max_seqs-1,
        # the chunk lane, and a dump lane for padding rows
        self._lmax = self._max_seqs + 2
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque[_Seq] = deque()
        self._stop = threading.Event()
        self._started = False
        self._thread: Optional[threading.Thread] = None
        # scheduler-owned (no lock: single owner thread)
        self._running: list[_Seq] = []
        self._free_pages: list[int] = list(
            range(1, self._usable_pages + 1))
        self._pages: Optional[torch.Tensor] = None
        self._admit_counter = 0
        # shared-prefix page cache (scheduler-owned, like the pool):
        #   _page_refs     pid -> live holders (sequences sharing it)
        #   _prefix_cache  chain-key -> pid, LRU order (oldest first); a
        #                  cached page with refcount 0 stays RESIDENT and
        #                  reclaimable, it is not on the free list
        #   _page_hash     pid -> chain-key (reverse index for reclaim)
        self._page_refs: dict[int, int] = {}
        self._prefix_cache: "OrderedDict[bytes, int]" = OrderedDict()
        self._page_hash: dict[int, bytes] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        t = threading.Thread(target=self._loop, name="nornicdb-genserve",
                             daemon=True)
        t.start()
        self._thread = t

    def stop(self) -> None:
        """Stop the scheduler; queued and running requests fail fast with
        ClosedError rather than stranding their callers."""
        self._stop.set()
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for seq in queued:
            self._finish_seq(seq, error=ClosedError("generation engine "
                                                    "stopped"), drop=False)
        if self._thread is not None:
            # the scheduler fails its own running set on exit
            self._thread.join(timeout=5)

    def _attn_for(self) -> str:
        """The ragged kernel on a CUDA pool, the torch block-gather path on
        a CPU pool; no other choice and no fallback."""
        return "cuda" if self.device.type == "cuda" else "torch"

    def _ragged_classes(self) -> list[tuple[int, int]]:
        """Every (F, Tq) shape class the fused scheduler can dispatch.

        Decode-only steps collapse Tq to 1 with F = pow2(ndec). A step
        carrying a chunk of bucket Tq=c has n_valid in [c/2+1, c] (or
        [1, 16] for the first bucket) plus 0..max_seqs-1 decode rows, so
        the reachable F buckets for that c are the contiguous pow2 range
        between those bounds."""
        classes: list[tuple[int, int]] = []
        f = 8
        while True:
            classes.append((f, 1))
            if f >= qwen2.round_up_pow2(self._max_seqs, 8):
                break
            f *= 2
        c = 16
        while True:
            # the bucket-edge clamp in _fused_step can shrink a Tq=c chunk
            # down to exactly c//2 flat rows, so lo starts there
            lo = 1 if c == 16 else c // 2
            hi = c + max(0, self._max_seqs - 1)
            f = qwen2.round_up_pow2(lo, 8)
            top = qwen2.round_up_pow2(hi, 8)
            while True:
                classes.append((f, c))
                if f >= top:
                    break
                f *= 2
            if c >= self._prefill_chunk:
                break
            c *= 2
        return classes

    def warmup(self, timeout: float = 60.0) -> None:
        """Run one step of EVERY shape class (:meth:`_ragged_classes`) on a
        throwaway pool before taking traffic, so every kernel shape, cuBLAS
        plan and allocator block is made before a live request pays for it.
        The scheduler's pool and state are never touched. ``timeout`` is
        checked between steps. Dense mode serves one tiny request instead."""
        deadline = time.monotonic() + timeout
        if self.config.mode == "dense":
            handle = self.submit([1, 2, 3], max_new_tokens=2, deadline_ms=0)
            while not handle.done and time.monotonic() < deadline:
                time.sleep(0.01)
            return
        w, lmax = self._table_width, self._lmax
        pool = qwen2.init_kv_pages(self.cfg, self._usable_pages + 1,
                                   self._page_size, self.device)
        for f, tq in self._ragged_classes():
            if time.monotonic() >= deadline:
                break
            meta, (tokens, lane_id, lane_pos, positions, logit_rows,
                   lane_tables) = qwen2.pack_ragged_meta(lmax, w, f)
            tokens[:] = 0
            lane_id[:] = lmax - 1
            lane_pos[:] = 0
            positions[:] = -1
            logit_rows[:] = 0
            lane_tables[:] = 0
            # one real row (writes throwaway page 1) so the step runs the
            # full scatter/attend path
            lane_id[0] = 0
            positions[0] = 0
            lane_tables[0, 0] = 1
            self.programs.add(("ragged", f, tq, w))
            ids, _lg, pool = qwen2.ragged_fused_step(
                self.params, self.cfg, torch.from_numpy(meta).to(self.device),
                pool, lmax=lmax, w=w, tq=tq, attn_impl=self._attn_for())
            ids.cpu()  # finish the step before the next class
        del pool

    # -- submission --------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
               deadline_ms: Optional[float] = None) -> GenHandle:
        """Enqueue one generation request; returns its streaming handle.

        Sheds with :class:`ResourceExhausted` when the queue is full (an
        empty queue always admits); raises ClosedError once stopped."""
        if self._stop.is_set():
            raise ClosedError("generation engine stopped")
        self.start()
        prompt = [int(t) for t in prompt_ids] or [1]
        # bound to the page table: keep the prompt TAIL and leave room for
        # at least one generated token
        limit = int(self.config.max_seq_tokens)
        if len(prompt) > limit - 1:
            prompt = prompt[-(limit - 1):]
        max_new = max(1, min(int(max_new_tokens), limit - len(prompt)))
        if deadline_ms is None:
            deadline_ms = float(self.config.deadline_ms)
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms and deadline_ms > 0 else 0.0)
        handle = GenHandle(self, deadline)
        eos = getattr(self.tokenizer, "eos_id", -1) if self.tokenizer else -1
        seq = _Seq(handle, prompt, max_new, eos)
        with self._cond:
            # re-check under the lock stop() drains the queue with: a seq
            # appended after the drain would never be processed
            if self._stop.is_set():
                raise ClosedError("generation engine stopped")
            if self._queue and len(self._queue) + 1 > int(
                    self.config.max_queue):
                self.stats.sheds_queue_full += 1
                raise ResourceExhausted(
                    f"generation queue full ({len(self._queue)} queued); "
                    "retry with backoff", reason="queue_full")
            self.stats.requests += 1
            self._queue.append(seq)
            self._cond.notify_all()
        return handle

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 64,
                 deadline_ms: Optional[float] = None) -> list[int]:
        """Synchronous convenience: submit + wait for the full result."""
        return self.submit(prompt_ids, max_new_tokens, deadline_ms).result()

    def generate_text(self, prompt: str, max_new_tokens: int = 64,
                      deadline_ms: Optional[float] = None) -> str:
        if self.tokenizer is None:
            raise ValueError("engine has no tokenizer")
        ids = self.tokenizer.encode(prompt, add_special=False)
        return self.submit(ids, max_new_tokens, deadline_ms).text()

    # -- scheduler ---------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                while (not self._queue and not self._running
                       and not self._stop.is_set()):
                    self._cond.wait(0.25)
                if self._stop.is_set():
                    break
                self._shed_expired_queued()
            if self._stop.is_set():
                break
            try:
                self._step()
            except Exception as e:  # a broken step must not strand callers:
                # fail everything resident (running AND queued)
                logger.exception("genserve scheduler step failed")
                for seq in list(self._running):
                    self._finish_seq(seq, error=e)
                # the step writes the pool in place: a step that raised may
                # have half-written it, so rebuild it from scratch, and the
                # prefix cache indexes the dropped pool's content
                self._pages = None
                self._free_pages = list(range(1, self._usable_pages + 1))
                self._reset_prefix_cache()
                with self._cond:
                    queued = list(self._queue)
                    self._queue.clear()
                for seq in queued:
                    self._finish_seq(seq, error=e, drop=False)
        # scheduler exit: fail whatever is still resident
        for seq in list(self._running):
            self._finish_seq(seq, error=ClosedError(
                "generation engine stopped"))

    def _shed_expired_queued(self) -> None:
        """Drop queued requests whose deadline already passed (under the
        lock; no device work here)."""
        if not self._queue:
            return
        now = time.monotonic()
        keep: deque[_Seq] = deque()
        for seq in self._queue:
            h = seq.handle
            if h.shed:
                self._count_outcome(seq, "shed")
                h._finish(h.error or ResourceExhausted(
                    "generation request cancelled", reason="deadline"))
            elif h.deadline and now > h.deadline:
                if h._mark_shed():
                    self.stats.sheds_deadline += 1
                self._count_outcome(seq, "shed")
                h._finish(ResourceExhausted(
                    "generation deadline exceeded before admission",
                    reason="deadline"))
            else:
                keep.append(seq)
        self._queue = keep

    def _count_outcome(self, seq: _Seq, outcome: str) -> None:
        if seq.counted:
            return
        seq.counted = True
        if outcome == "ok":
            self.stats.completed += 1
        elif outcome == "error":
            self.stats.errors += 1

    def _finish_seq(self, seq: _Seq, error: Optional[Exception] = None,
                    drop: bool = True) -> None:
        """Terminal bookkeeping for one sequence (scheduler thread, or
        stop()): free pages, count the outcome, wake the caller."""
        if drop and seq in self._running:
            self._running.remove(seq)
        self._release_pages(seq)
        seq.dense_cache = seq.dense_graph = None
        if error is None:
            self._count_outcome(seq, "ok")
        elif isinstance(error, ResourceExhausted):
            self._count_outcome(seq, "shed")
        else:
            self._count_outcome(seq, "error")
        seq.handle._finish(error)

    def _release_pages(self, seq: _Seq) -> None:
        for pid in seq.page_ids:
            refs = self._page_refs.get(pid, 1) - 1
            if refs > 0:
                # still shared with another live sequence: never freed out
                # from under its co-holder
                self._page_refs[pid] = refs
                continue
            self._page_refs.pop(pid, None)
            if pid not in self._page_hash:
                self._free_pages.append(pid)
            # else: a prefix-cached page goes idle-resident (refcount 0),
            # reclaimable LRU by _alloc_page under pool pressure
        seq.page_ids = []
        seq.page_table = None
        seq.cache_len = 0
        seq.prefill_pos = 0

    def _alloc_page(self) -> Optional[int]:
        """One physical page for a new holder: the free list first, then the
        least-recently-used IDLE prefix-cached page. None means genuine pool
        pressure."""
        if self._free_pages:
            return self._free_pages.pop()
        victim_key = None
        for key, pid in self._prefix_cache.items():  # oldest first
            if self._page_refs.get(pid, 0) == 0:
                victim_key = key
                break
        if victim_key is None:
            return None
        pid = self._prefix_cache.pop(victim_key)
        self._page_hash.pop(pid, None)
        return pid

    def _available_pages(self) -> int:
        """Pages an admission could claim: free + idle prefix-cached."""
        idle = sum(1 for pid in self._prefix_cache.values()
                   if self._page_refs.get(pid, 0) == 0)
        return len(self._free_pages) + idle

    def _reset_prefix_cache(self) -> None:
        """Pool content invalidated: every cached key now describes bytes
        that no longer exist."""
        self._prefix_cache.clear()
        self._page_hash.clear()
        self._page_refs.clear()

    def _prefix_page_keys(self, toks: list[int]) -> list[bytes]:
        """Chained content keys, one per FULL page of ``toks``: key i
        commits to every token in pages 0..i, so matching key i implies the
        whole prefix matches."""
        ps = self._page_size
        h = hashlib.sha1(b"nornic-prefix")
        keys: list[bytes] = []
        for i in range(len(toks) // ps):
            h.update(np.asarray(toks[i * ps:(i + 1) * ps],
                                np.int64).tobytes())
            keys.append(h.digest())
        return keys

    def _register_prefix(self, seq: _Seq) -> None:
        """Final prefill chunk landed: publish this sequence's full prompt
        pages into the prefix cache (first writer wins)."""
        if seq.prefix_keys is None or seq.page_table is None:
            return
        ps = self._page_size
        n_full = min(len(seq.prefix_keys),
                     len(seq.prefill_tokens) // ps, len(seq.page_ids))
        for idx in range(n_full):
            key = seq.prefix_keys[idx]
            pid = int(seq.page_table[idx])
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            if pid in self._page_hash:
                continue
            self._prefix_cache[key] = pid
            self._page_hash[pid] = key

    def _ensure_pool(self) -> Optional[torch.Tensor]:
        if self._pages is None and self.config.mode != "dense":
            self._pages = qwen2.init_kv_pages(
                self.cfg, self._usable_pages + 1, self._page_size,
                self.device)
        return self._pages

    # -- one scheduler iteration -------------------------------------------
    def _step(self) -> None:
        self._ensure_pool()
        self._admit()
        if self.config.mode == "dense":
            self._prefill_one()
            self._decode_step()
        else:
            self._fused_step()

    def _admit(self) -> None:
        paged = self.config.mode != "dense"
        while len(self._running) < self._max_seqs:
            hits: list[int] = []
            keys: list[bytes] = []
            with self._cond:
                if not self._queue:
                    return
                seq = self._queue[0]
                toks = seq.prompt + seq.out
                need = (qwen2.pages_for(len(toks) + 1, self._page_size)
                        if paged else 0)
                if paged:
                    keys = self._prefix_page_keys(toks)
                    # cap reuse below the full prompt: the final chunk must
                    # prefill at least one token to produce first-token
                    # logits
                    cap = (len(toks) - 1) // self._page_size
                    for idx in range(min(len(keys), cap)):
                        pid = self._prefix_cache.get(keys[idx])
                        if pid is None:
                            break
                        hits.append(pid)
                # idle cached hits count as "available" but adopting them
                # consumes that availability
                idle_hits = sum(1 for pid in hits
                                if self._page_refs.get(pid, 0) == 0)
                if (need - len(hits)
                        > self._available_pages() - idle_hits):
                    return  # pool pressure: wait for a finisher/evictor
                self._queue.popleft()
            if seq.handle.shed:
                self._finish_seq(seq, error=seq.handle.error or
                                 ResourceExhausted("cancelled",
                                                   reason="deadline"),
                                 drop=False)
                continue
            seq.prefill_tokens = toks
            seq.prefill_pos = 0
            seq.cache_len = 0
            seq.state = _PREFILL
            seq.admit_no = self._admit_counter
            self._admit_counter += 1
            if paged:
                seq.prefix_keys = keys
                table = np.zeros((self._table_width,), np.int32)
                seq.page_ids = []
                for pid in hits:
                    # shared pages: take a reference, refresh LRU
                    self._page_refs[pid] = self._page_refs.get(pid, 0) + 1
                    self._prefix_cache.move_to_end(self._page_hash[pid])
                    seq.page_ids.append(pid)
                for _ in range(need - len(hits)):
                    pid = self._alloc_page()  # availability checked above
                    self._page_refs[pid] = 1
                    seq.page_ids.append(pid)
                table[:len(seq.page_ids)] = seq.page_ids
                seq.page_table = table
                if hits:
                    reused = len(hits) * self._page_size
                    # cached pages already hold these tokens' KV: prefill
                    # starts at the novel suffix
                    seq.prefill_pos = reused
                    seq.cache_len = reused
                    seq.handle.prefix_reused_tokens = reused
                    self.stats.prefix_hits += len(hits)
                    self.stats.prefix_reused_tokens += reused
            seq.re_prefill = bool(seq.out)
            if seq.out:
                self.stats.readmissions += 1
            self.stats.admissions += 1
            self._running.append(seq)

    def _grow(self, seq: _Seq) -> bool:
        """Ensure the sequence has a page for cache slot ``cache_len``. On
        an empty free list, evict the youngest OTHER running sequence
        (requeued at the queue head). Returns False only when the sequence
        had to be shed."""
        need = qwen2.pages_for(seq.cache_len + 1, self._page_size)
        while len(seq.page_ids) < need:
            pid = self._alloc_page()
            if pid is None:
                # an eviction may free ZERO pages (every victim page shared
                # or cache-resident), so alloc-then-evict loops: each round
                # removes one victim, so it terminates
                victims = [s for s in self._running
                           if s is not seq and s.page_ids]
                if not victims:
                    self.stats.sheds_pool += 1
                    self._finish_seq(seq, error=ResourceExhausted(
                        "page pool exhausted", reason="pool_exhausted"))
                    return False
                self._evict(max(victims, key=lambda s: s.admit_no))
                continue
            self._page_refs[pid] = 1
            seq.page_ids.append(pid)
            seq.page_table[len(seq.page_ids) - 1] = pid
        return True

    def _evict(self, victim: _Seq) -> None:
        self.stats.evictions += 1
        self._running.remove(victim)
        self._release_pages(victim)
        victim.dense_cache = victim.dense_graph = None
        victim.state = _QUEUED
        with self._cond:
            self._queue.appendleft(victim)

    def _fused_step(self) -> None:
        """ONE fused step per scheduler iteration: every running decode
        lane plus at most one prompt-prefill chunk (the oldest admitted
        sequence still prefilling), as ragged per-lane metadata into
        ``qwen2.ragged_fused_step``."""
        active = [s for s in self._running if s.state == _DECODE]
        active = [s for s in active if not self._expired(s)]
        # page growth first, for side effects only: a shed or evicted
        # sequence leaves self._running and the re-filter below drops it
        for seq in list(active):
            if seq in self._running:
                self._grow(seq)
        active = [s for s in active if s in self._running
                  and s.state == _DECODE]
        pre = [s for s in self._running if s.state == _PREFILL]
        chunk_seq = min(pre, key=lambda s: s.admit_no) if pre else None
        if chunk_seq is not None and self._expired(chunk_seq):
            chunk_seq = None
        if not active and chunk_seq is None:
            return
        ndec = len(active)
        if chunk_seq is not None:
            remaining = (len(chunk_seq.prefill_tokens)
                         - chunk_seq.prefill_pos)
            tq = min(self._prefill_chunk, qwen2.round_up_pow2(remaining, 16))
            n_valid = min(remaining, tq)
            f = qwen2.round_up_pow2(ndec + n_valid, 8)
            half = f // 2
            if (ndec + n_valid < f and half >= 8
                    and half - ndec >= (n_valid + 1) // 2):
                # decode rows pushed the flat bucket over a pow2 edge: fill
                # the LOWER bucket exactly and leave the chunk tail for the
                # next step, when the clamp keeps at least half the chunk
                n_valid = half - ndec
                f = half
            piece = chunk_seq.prefill_tokens[
                chunk_seq.prefill_pos:chunk_seq.prefill_pos + n_valid]
            final = (chunk_seq.prefill_pos + n_valid
                     >= len(chunk_seq.prefill_tokens))
        else:
            tq, piece, n_valid, final = 1, [], 0, False
            # flat token rows: decode lanes first, then the chunk, then
            # padding up to the pow2 bucket
            f = qwen2.round_up_pow2(ndec, 8)
        lmax, w = self._lmax, self._table_width
        # ONE packed int32 host array per step (one host-to-device copy);
        # the names below are writable views into it
        meta, (tokens, lane_id, lane_pos, positions, logit_rows,
               lane_tables) = qwen2.pack_ragged_meta(lmax, w, f)
        tokens[:] = 0
        lane_id[:] = lmax - 1                        # dump lane default
        lane_pos[:] = 0
        positions[:] = -1                            # -1 = padding row
        lane_tables[:] = 0
        # logits are projected only for rows that pick a token: the decode
        # rows and the chunk's last valid row
        logit_rows[:] = 0
        for i, seq in enumerate(active):
            tokens[i] = seq.out[-1]
            lane_id[i] = i
            positions[i] = seq.cache_len
            lane_tables[i] = seq.page_table
            logit_rows[i] = i
        chunk_lane = lmax - 2  # THE chunk lane, fixed by convention
        for j in range(n_valid):
            fi = ndec + j
            tokens[fi] = piece[j]
            lane_id[fi] = chunk_lane
            lane_pos[fi] = j
            positions[fi] = chunk_seq.prefill_pos + j
        if chunk_seq is not None:
            lane_tables[chunk_lane] = chunk_seq.page_table
            logit_rows[ndec] = ndec + n_valid - 1
        self.programs.add(("ragged", f, tq, w))
        try:
            ids, _logits, self._pages = qwen2.ragged_fused_step(
                self.params, self.cfg, torch.from_numpy(meta).to(self.device),
                self._pages, lmax=lmax, w=w, tq=tq,
                attn_impl=self._attn_for())
            # the greedy argmax ran on the device: (Lmax,) ints cross to
            # the host, not the (Lmax, V) logits
            host = ids.cpu().numpy()
        except Exception:
            # the step writes the pool in place and may have half-written
            # it: drop it here so _ensure_pool rebuilds it from scratch,
            # and the prefix cache that indexes its content with it
            self._pages = None
            self._reset_prefix_cache()
            raise
        self.stats.fused_steps += 1
        if chunk_seq is not None:
            self.stats.prefill_chunks += 1
            if chunk_seq.re_prefill:
                self.stats.prefill_tokens_re += n_valid
            else:
                self.stats.prefill_tokens_first += n_valid
        if active:
            self.stats.decode_steps += 1
            self.stats.decode_lane_tokens += ndec
        for i, seq in enumerate(active):
            seq.cache_len += 1
            self._emit(seq, int(host[i]))
        if chunk_seq is not None:
            chunk_seq.prefill_pos += n_valid
            chunk_seq.cache_len = chunk_seq.prefill_pos
            if final:
                # full prompt resident: publish its pages for sharing, then
                # the last valid row's logits pick the first token
                self._register_prefix(chunk_seq)
                self._emit(chunk_seq, int(host[ndec]))

    # -- prefill and decode (dense mode) ------------------------------------
    def _prefill_one(self) -> None:
        """Run ONE prompt prefill for the oldest sequence still waiting
        (dense mode only; paged mode fuses prefill into
        :meth:`_fused_step`)."""
        pre = [s for s in self._running if s.state == _PREFILL]
        if not pre:
            return
        seq = min(pre, key=lambda s: s.admit_no)
        if self._expired(seq):
            return
        self._dense_prefill(seq)

    def _dense_prefill(self, seq: _Seq) -> None:
        """The per-sequence dense (1, Tmax) cache, Tmax the power-of-two
        bucket of prompt + budget (at most max_seq_tokens)."""
        toks = seq.prefill_tokens
        max_len = qwen2.round_up_pow2(
            min(len(toks) + seq.max_new, int(self.config.max_seq_tokens)))
        self.programs.add(("dense_prefill", len(toks), max_len))
        logits, seq.dense_cache = qwen2.prefill(
            self.params, self.cfg,
            torch.tensor([toks], dtype=torch.long, device=self.device),
            max_len)
        # one token id crosses to the host: the prefill's output
        tok = int(torch.argmax(logits[0]))
        self.stats.prefill_chunks += 1
        if seq.re_prefill:
            self.stats.prefill_tokens_re += len(toks)
        else:
            self.stats.prefill_tokens_first += len(toks)
        seq.prefill_pos = len(toks)
        seq.dense_len = len(toks)
        seq.cache_len = len(toks)
        self._emit(seq, tok)

    def _decode_step(self) -> None:
        active = [s for s in self._running if s.state == _DECODE]
        active = [s for s in active if not self._expired(s)]
        for seq in active:
            self._dense_decode(seq)

    def _dense_decode(self, seq: _Seq) -> None:
        """One decode step of one sequence: on the card its captured
        :class:`qwen2.DecodeGraph` (captured at its first step, replayed
        after), on the CPU ``qwen2.decode_step``."""
        max_len = seq.dense_cache[0][0].shape[1]
        self.programs.add(("dense_step", max_len))
        try:
            if self.device.type == "cuda":
                if seq.dense_graph is None:
                    if self._capture_stream is None:
                        self._capture_stream = torch.cuda.Stream(self.device)
                    seq.dense_graph = qwen2.DecodeGraph(
                        self.params, self.cfg, seq.dense_cache,
                        self._capture_stream)
                logits = seq.dense_graph.step(seq.out[-1], seq.dense_len)
            else:
                logits, seq.dense_cache = qwen2.decode_step(
                    self.params, self.cfg,
                    torch.tensor([seq.out[-1]], dtype=torch.long,
                                 device=self.device),
                    seq.dense_cache, seq.dense_len)
            # one token id crosses to the host: the step's output
            tok = int(torch.argmax(logits[0]))
        except Exception:
            # the step writes the cache in place and may have half-written
            # it: drop it, so a requeue re-prefills instead of reading it
            seq.dense_cache = seq.dense_graph = None
            raise
        self.stats.decode_steps += 1
        self.stats.decode_lane_tokens += 1
        seq.dense_len += 1
        seq.cache_len += 1
        self._emit(seq, tok)

    def _emit(self, seq: _Seq, tok: int) -> None:
        """Deliver one generated token and advance lifecycle state."""
        seq.out.append(tok)
        self.stats.generated_tokens += 1
        seq.handle._deliver(tok)
        if (tok == seq.eos_id and seq.eos_id >= 0) or \
                len(seq.out) >= seq.max_new:
            self._finish_seq(seq)
        else:
            seq.state = _DECODE

    def _expired(self, seq: _Seq) -> bool:
        h = seq.handle
        if h.shed:
            self.stats.cancelled += 1
            self._finish_seq(seq, error=h.error or ResourceExhausted(
                "generation request cancelled", reason="deadline"))
            return True
        if h.deadline and time.monotonic() > h.deadline:
            if h._mark_shed():
                self.stats.sheds_deadline += 1
            self._finish_seq(seq, error=ResourceExhausted(
                "generation deadline exceeded", reason="deadline"))
            return True
        return False

    # -- observability -----------------------------------------------------
    def stats_snapshot(self) -> dict:
        out = self.stats.as_dict()
        with self._lock:
            out["queue_depth"] = len(self._queue)
        out["running_seqs"] = len(self._running)
        out["free_pages"] = len(self._free_pages)
        out["prefix_pages"] = len(self._prefix_cache)
        out["usable_pages"] = self._usable_pages
        out["page_size"] = self._page_size
        out["mode"] = self.config.mode
        out["device"] = str(self.device)
        out["max_seqs"] = self._max_seqs
        # copy first: the scheduler thread adds to the ledger concurrently
        out["programs"] = sorted(str(p) for p in self.programs.copy())
        return out
