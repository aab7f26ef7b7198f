"""The device owner: probe -> acquire -> serve -> degrade -> recover.

A port of ``nornicdb_tpu/backend/manager.py`` for CUDA. Device acquisition
is a first-class, time-bounded component:

* **One device-owner thread.** CUDA init and the first-touch round trip
  run on the manager's worker thread, never on a caller. A caller waits on
  an event with a config timeout and walks away when it fires; a hung CUDA
  call cannot be cancelled, so it keeps the owner thread stuck in the
  background, and the worker discards abandoned results.
* **Explicit lifecycle state machine.** PROBING -> READY -> DEGRADED_CPU ->
  RECOVERING (-> READY). A periodic health probe (a tiny round trip on the
  manager's own CUDA stream, synchronising that stream only, with a latency
  threshold) drives READY -> DEGRADED_CPU; hysteresis (``degrade_after``
  consecutive failures / ``recover_after`` consecutive successes) prevents
  flap-thrash. The probe never synchronises the whole device: that would
  wait on every other thread's queued work and measure load, not health.
* **One policy: fail.** A caller that finds the device not serving gets
  ``DeviceUnavailable`` within ``acquire_timeout``; no request meant for
  the card runs on the host (the JAX package's ``"cpu"`` policy has no
  counterpart here). The state keeps the JAX name DEGRADED_CPU, so the
  state gauge renders as JAX's; here it means "not serving".
* **Recovery on CUDA.** A sticky error (an illegal address, ECC, an Xid)
  leaves the CUDA context unusable until the process restarts: probes go
  on failing and the manager stays DEGRADED_CPU. RECOVERING is reachable
  only from transient failures: a slow probe, a hung call that returns,
  or ``FakeHooks``. None of these loses device memory, so corpora keep
  their resident buffers: the manager re-acquires on the worker thread,
  enters READY, and wakes registered corpora, whose uploaders patch the
  blocks written while the card was not serving (the JAX package's
  "dirty" re-upload; its "full" mode assumes a TPU's lost buffers).

The structural invariant, *no device op or acquisition under a held
lock*, is kept by consumers gating through ``await_ready()`` /
``require_ready()`` BEFORE they take their locks; ``await_ready`` itself
refuses (``BackendLockHeldError``) where an instrumented-lock shim reports
held locks.

Import-light: ``torch.cuda`` is touched only inside the real hooks, so
importing this module never initialises CUDA.
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import statistics
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.errors import BackendLockHeldError, DeviceUnavailable
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

logger = logging.getLogger(__name__)

# -- lifecycle states --------------------------------------------------------
PROBING = "PROBING"            # initial acquisition in flight
READY = "READY"                # device serving; periodic probe green
DEGRADED_CPU = "DEGRADED_CPU"  # device lost/unreachable; requests raise
RECOVERING = "RECOVERING"      # probe green again; re-acquire + re-upload

STATES = (PROBING, READY, DEGRADED_CPU, RECOVERING)

# -- metrics (cells created at import so the catalog renders before the
#    first transition; only the process-default manager publishes) ----------
_STATE_GAUGE = _REGISTRY.gauge(
    "nornicdb_backend_state",
    "Backend lifecycle state (one-hot: the current state's cell is 1)",
    labels=("state",),
)
_STATE_CELLS = {s: _STATE_GAUGE.labels(s) for s in STATES}
_PROBE_HIST = _REGISTRY.histogram(
    "nornicdb_backend_probe_seconds",
    "Device health-probe round-trip latency",
)
# the JAX package's catalog, rendered as JAX renders it; the port serves
# no device-path request from the host, so these cells stay at 0
_FALLBACKS = _REGISTRY.counter(
    "nornicdb_backend_fallbacks_total",
    "Device-path requests served from CPU host arrays instead",
    labels=("op",),
)
_FALLBACKS.labels("search")  # eager cells: render at 0
_FALLBACKS.labels("embed")
_RECOVERIES = _REGISTRY.counter(
    "nornicdb_backend_recoveries_total",
    "DEGRADED_CPU -> READY recoveries (device re-acquired, corpora re-uploaded)",
)
_DEGRADES = _REGISTRY.counter(
    "nornicdb_backend_degrades_total",
    "Transitions into DEGRADED_CPU (acquire timeout or probe failures)",
)
_ACQUIRE_TIMEOUTS = _REGISTRY.counter(
    "nornicdb_backend_acquire_timeouts_total",
    "Device acquisitions abandoned at the configured timeout",
)
_PROBE_FAILURES = _REGISTRY.counter(
    "nornicdb_backend_probe_failures_total",
    "Health probes that timed out, errored, or exceeded the latency threshold",
)
_LOCK_VIOLATIONS = _REGISTRY.counter(
    "nornicdb_backend_lock_violations_total",
    "Backend acquisitions attempted while the caller held a lock (NL-DEV01)",
)


# -- nornsan bridge ----------------------------------------------------------
def _held_lock_sites() -> list[str]:
    """Creation sites of instrumented locks the calling thread holds, when
    the nornsan shim is installed; [] otherwise. The port's shim
    (``nornicdb_tpu_torch.tools.nornsan``) comes with ROADMAP A8, so until
    then this returns []."""
    import sys

    nornsan = sys.modules.get("nornicdb_tpu_torch.tools.nornsan")
    if nornsan is None or not getattr(nornsan, "active", lambda: False)():
        return []
    held = getattr(nornsan.tracker, "held_sites", None)
    return held() if held is not None else []


# -- device hooks ------------------------------------------------------------
class RealHooks:
    """Actual CUDA operations. Every method may block (that is the point:
    they only ever run on the manager's worker thread).

    ``probe`` replays a CUDA graph of a tiny kernel between two timing
    events on the manager's own stream and waits on that stream's event
    only, so other threads' queued work (a train step, a search batch)
    does not count against the probe's latency threshold. It moves no
    bytes between host and card: a copy queues behind other threads'
    transfers on the copy engines, which is load, not health."""

    def __init__(self, index: int = 0):
        self.index = index
        self.stream = None  # torch.cuda.Stream, made at touch
        # buffers, timing events and the probe's graph, made once at
        # touch: a probe allocates nothing, so it never waits on the
        # allocator (an emptied cache would make it call cudaMalloc)
        self._host = self._dev = self._out = self._back = None
        self._start = self._end = self._graph = None
        self.last_event_s = 0.0

    def touch(self) -> dict:
        """Acquire: CUDA init, the device list, a tiny host -> device ->
        host round trip on the manager's stream, its value checked, and
        the probe's graph captured on that stream."""
        import torch

        torch.cuda.init()
        count = torch.cuda.device_count()
        name = torch.cuda.get_device_name(self.index)
        dev = torch.device("cuda", self.index)
        with torch.cuda.device(dev):
            self.stream = torch.cuda.Stream()
            with torch.cuda.stream(self.stream):
                self._dev = torch.empty(8, dtype=torch.float32, device=dev)
                self._out = torch.empty_like(self._dev)
            # external: captured as event-record nodes of the graph
            self._start = torch.cuda.Event(enable_timing=True, external=True)
            self._end = torch.cuda.Event(enable_timing=True, external=True)
        self._host = torch.ones(8, dtype=torch.float32).pin_memory()
        self._back = torch.empty(8, dtype=torch.float32).pin_memory()
        with torch.cuda.stream(self.stream):
            self._dev.copy_(self._host, non_blocking=True)
            torch.add(self._dev, 1.0, out=self._out)
            self._back.copy_(self._out, non_blocking=True)
        self.stream.synchronize()
        if float(self._back[0]) != 2.0:
            raise RuntimeError("device round trip returned a wrong value")
        # captured on this stream alone ("thread_local": other threads'
        # CUDA calls go on), with no device-wide synchronize
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(self.stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._start.record(self.stream)
                torch.add(self._dev, 1.0, out=self._out)
                self._end.record(self.stream)
            finally:
                graph.capture_end()
        self._graph = graph
        return {"platform": "cuda", "device_count": count, "name": name,
                "index": self.index}

    def probe(self) -> float:
        """One replay of the probe's graph; returns the device seconds
        between its two events. One graph launch enqueues both events and
        the kernel between them, so no host stall (another thread holding
        the interpreter lock, a garbage collection) can come between them
        and read as device time. Raises if the device is unhealthy (a
        sticky CUDA error raises here on every probe); a hung device never
        returns, and the manager's ``probe_timeout`` walks away.
        ``last_event_s`` keeps the span."""
        import torch

        if self._graph is None:
            raise RuntimeError("probe before touch")
        with torch.cuda.stream(self.stream):
            self._graph.replay()
        self._end.synchronize()
        self.last_event_s = self._start.elapsed_time(self._end) / 1e3
        return self.last_event_s


class FakeHooks:
    """Fault-injecting backend for tests and chaos runs.

    ``mode`` is mutable at runtime so a test can flip a hung backend
    healthy and watch the manager recover:

    * ``ok``   — succeed instantly
    * ``slow`` — succeed after ``delay`` seconds (latency-threshold tests)
    * ``fail`` — raise immediately
    * ``hang`` — block until ``release()`` (or forever)
    """

    def __init__(self, mode: str = "ok", delay: float = 0.0):
        self.mode = mode
        self.delay = delay
        self._release = threading.Event()
        self.touches = 0
        self.probes = 0

    def set_mode(self, mode: str) -> None:
        self.mode = mode
        if mode != "hang":
            self._release.set()
            self._release = threading.Event()

    def release(self) -> None:
        self._release.set()

    def _apply(self) -> None:
        # capture the release event BEFORE reading mode: set_mode sets the
        # old event then swaps in a fresh one, so a waiter that read
        # mode=="hang" must wait on the event set_mode will actually set
        # (waiting on the post-swap event would hang forever)
        release = self._release
        mode = self.mode
        if mode == "hang":
            release.wait()
            # woken by set_mode: re-read and apply the new behavior
            mode = self.mode
        if mode == "fail":
            raise RuntimeError("fake backend failure (NORNICDB_FAKE_BACKEND)")
        if mode == "slow" and self.delay > 0:
            time.sleep(self.delay)

    def touch(self) -> dict:
        self.touches += 1
        self._apply()
        return {"platform": "fake", "device_count": 1}

    def probe(self) -> None:
        self.probes += 1
        self._apply()


def hooks_from_env() -> Optional[FakeHooks]:
    """NORNICDB_FAKE_BACKEND=hang|fail|slow[:seconds]|ok -> FakeHooks."""
    raw = os.environ.get("NORNICDB_FAKE_BACKEND", "").strip().lower()
    if not raw:
        return None
    mode, _, arg = raw.partition(":")
    if mode not in ("ok", "hang", "fail", "slow"):
        logger.warning("NORNICDB_FAKE_BACKEND=%r: unknown mode, ignoring", raw)
        return None
    delay = float(arg) if arg else 0.5
    return FakeHooks(mode=mode, delay=delay)


# -- single-flight device executor ------------------------------------------
class _Result:
    __slots__ = ("event", "value", "error", "abandoned")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.abandoned = False


class _DeviceExecutor:
    """The process's device-owner thread: all potentially-hanging backend
    calls run here.  ``submit()`` waits up to ``timeout`` then abandons the
    call (the worker finishes or hangs in the background; abandoned results
    are discarded).  ``busy`` is True while a call is in flight, so probes
    can count a stuck worker as a failure without stacking work behind it."""

    def __init__(self, name: str = "nornicdb-backend"):
        self._q: "queue.Queue[tuple[Callable[[], Any], _Result]]" = queue.Queue()
        self._busy = 0
        self._mu = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    @property
    def busy(self) -> bool:
        with self._mu:
            return self._busy > 0 or not self._q.empty()

    def _loop(self) -> None:
        while True:
            fn, res = self._q.get()
            if fn is None:  # shutdown sentinel
                return
            with self._mu:
                self._busy += 1
            try:
                res.value = fn()
            except BaseException as e:  # delivered to the waiter, not lost
                res.error = e
            finally:
                with self._mu:
                    self._busy -= 1
                res.event.set()

    def stop(self) -> None:
        """Queue a shutdown sentinel.  The worker exits once any in-flight
        (possibly hung) call finishes; a permanently hung call strands the
        daemon thread — nothing can interrupt a wedged CUDA call."""
        self._q.put((None, None))

    def submit(self, fn: Callable[[], Any], timeout: float) -> Any:
        """Run fn on the worker; TimeoutError if it doesn't finish in time
        (the call itself keeps running — nothing can interrupt a hung CUDA
        call — but the caller walks away)."""
        res = _Result()
        self._q.put((fn, res))
        if not res.event.wait(timeout):
            res.abandoned = True
            raise TimeoutError(f"device op exceeded {timeout:.1f}s")
        if res.error is not None:
            raise res.error
        return res.value


# -- the manager -------------------------------------------------------------
@dataclass
class BackendCounters:
    recoveries: int = 0
    degrades: int = 0
    acquire_timeouts: int = 0
    probes: int = 0
    probe_failures: int = 0
    lock_violations: int = 0
    transitions: list = field(default_factory=list)  # (ts, old, new, reason)


class BackendManager:
    """Owns device acquisition + health for the process (or, in tests, for
    one corpus).  Thread-safe; the state lock is never held across a device
    op — device work runs on the executor thread, bounded by timeouts."""

    def __init__(
        self,
        acquire_timeout: float = 15.0,
        probe_interval: float = 5.0,
        probe_timeout: float = 5.0,
        probe_latency_threshold: float = 1.0,
        degrade_after: int = 3,
        recover_after: int = 2,
        hooks: Optional[Any] = None,
        publish: bool = False,
    ):
        self.acquire_timeout = acquire_timeout
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.probe_latency_threshold = probe_latency_threshold
        self.degrade_after = max(1, int(degrade_after))
        self.recover_after = max(1, int(recover_after))
        self.hooks = hooks if hooks is not None else (
            hooks_from_env() or RealHooks()
        )
        self._publish = publish
        self._state = PROBING
        self._cond = threading.Condition()
        self._started = False
        self._stop = threading.Event()
        self._executor: Optional[_DeviceExecutor] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._fail_streak = 0
        self._ok_streak = 0
        self._device_info: dict = {}
        self._probe_latency = 0.0
        # the last green probes' round trips (seconds), for stats()
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=1024)
        # (time, reason) of the last probe failures, for stats()
        self._failure_reasons: "collections.deque[tuple]" = (
            collections.deque(maxlen=10))
        self.counters = BackendCounters()
        # corpora to re-upload on recovery (weak: test corpora must not be
        # kept alive by the process-default manager)
        self._corpora: list = []  # list[weakref.ref]
        if publish:
            _STATE_CELLS[PROBING].set(1.0)

    # -- lifecycle ----------------------------------------------------------
    def ensure_started(self) -> None:
        with self._cond:
            if self._started:
                return
            self._started = True
            self._executor = _DeviceExecutor()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="nornicdb-backend-probe",
                daemon=True,
            )
        # initial acquisition kicks off OUTSIDE the state lock
        self._probe_thread.start()
        threading.Thread(
            target=self._initial_acquire, name="nornicdb-backend-acquire",
            daemon=True,
        ).start()

    def stop(self) -> None:
        self._stop.set()
        if self._executor is not None:
            self._executor.stop()
        with self._cond:
            self._cond.notify_all()

    @property
    def state(self) -> str:
        return self._state

    def ready(self) -> bool:
        """Fast non-blocking check: is the device serving right now?"""
        return self._state == READY

    def await_ready(self, timeout: Optional[float] = None) -> bool:
        """Block (bounded) until the device is serving.  Returns False when
        the wait ends with the card not serving (``require_ready`` then
        raises).  Never call this holding a lock: the whole point is that
        the *caller's* locks stay free while acquisition may hang."""
        self._guard_no_locks("await_ready")
        self.ensure_started()
        if self._state == READY:
            return True
        if self._state in (DEGRADED_CPU, RECOVERING):
            # degraded (or mid-recovery): fail fast, the probe loop owns
            # getting back to READY
            return False
        deadline = time.monotonic() + (
            self.acquire_timeout if timeout is None else timeout
        )
        with self._cond:
            while self._state == PROBING:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    break
                self._cond.wait(remaining)
        if self._state == READY:
            return True
        if self._state == PROBING:
            # acquisition still in flight past the caller's budget: the
            # caller fails NOW (its answer can't wait), the manager keeps
            # acquiring in the background
            self._note_acquire_timeout()
        return self._state == READY

    def require_ready(self, timeout: Optional[float] = None) -> None:
        """await_ready that raises DeviceUnavailable when the card is not
        serving (the port's one policy)."""
        if not self.await_ready(timeout):
            raise DeviceUnavailable(f"backend {self._state}: card not serving")

    # -- consumer registration ----------------------------------------------
    def register_corpus(self, corpus: Any) -> None:
        """Corpora are woken after a recovery via _on_backend_ready(), so
        their uploaders patch the writes made while the card was not
        serving."""
        with self._cond:
            self._corpora = [r for r in self._corpora if r() is not None]
            if not any(r() is corpus for r in self._corpora):
                self._corpora.append(weakref.ref(corpus))

    # -- internals -----------------------------------------------------------
    def _guard_no_locks(self, op: str) -> None:
        held = _held_lock_sites()
        if not held:
            return
        self.counters.lock_violations += 1
        if self._publish:
            _LOCK_VIOLATIONS.inc()
        # held is only ever non-empty under an instrumented-lock shim,
        # where this is a test failure by contract
        raise BackendLockHeldError(
            f"backend {op} while holding lock(s) {held}: device acquisition "
            "can hang in CUDA init and every thread needing those locks "
            "would block forever"
        )

    def _note_acquire_timeout(self) -> None:
        self.counters.acquire_timeouts += 1
        if self._publish:
            _ACQUIRE_TIMEOUTS.inc()

    def _transition(self, new: str, reason: str) -> None:
        with self._cond:
            old = self._state
            if old == new:
                return
            self._state = new
            self.counters.transitions.append(
                (time.time(), old, new, reason)
            )
            del self.counters.transitions[:-50]
            # counted before a waiter can see the new state (JAX counts
            # after the lock, so a caller woken on READY may read the
            # previous count; ROADMAP §C)
            if new == DEGRADED_CPU:
                self.counters.degrades += 1
            if old in (RECOVERING, DEGRADED_CPU) and new == READY:
                self.counters.recoveries += 1
            self._cond.notify_all()
        logger.warning("backend %s -> %s (%s)", old, new, reason)
        if self._publish:
            for s, cell in _STATE_CELLS.items():
                cell.set(1.0 if s == new else 0.0)
            if new == DEGRADED_CPU:
                _DEGRADES.inc()
            if old in (RECOVERING, DEGRADED_CPU) and new == READY:
                _RECOVERIES.inc()
        # state transitions are recorded as single-span traces so
        # /admin/traces shows the lifecycle timeline next to request traces
        with _tracer.start_trace(
            "backend.transition",
            attrs={"from": old, "to": new, "reason": reason},
        ):
            pass

    def _initial_acquire(self) -> None:
        try:
            info = self._executor.submit(self.hooks.touch, self.acquire_timeout)
            self._device_info = info or {}
            self._transition(READY, "acquired")
        except TimeoutError:
            self._note_acquire_timeout()
            self._transition(DEGRADED_CPU, "acquire timeout")
        except Exception as e:
            self._transition(DEGRADED_CPU, f"acquire failed: {e}")

    def _run_probe(self) -> bool:
        """One bounded health probe; True when green (and fast enough)."""
        self.counters.probes += 1
        if self._executor.busy:
            # a previous device call is still hung: that IS the failure —
            # don't stack another behind it
            self._note_probe_failure("worker busy/hung")
            return False
        try:
            latency = self._executor.submit(self._timed_probe,
                                            self.probe_timeout)
        except TimeoutError:
            self._note_probe_failure("probe timeout")
            return False
        except Exception as e:
            self._note_probe_failure(f"probe error: {e}")
            return False
        self._probe_latency = latency
        self._latencies.append(latency)
        if self._publish:
            _PROBE_HIST.observe(latency)
        if latency > self.probe_latency_threshold:
            self._note_probe_failure(f"probe latency {latency:.3f}s")
            return False
        return True

    def _timed_probe(self) -> float:
        """The latency held to ``probe_latency_threshold``: the device's
        own time when the hook reports it (RealHooks: the event-timed
        kernel on the manager's stream), else the hook's time on the owner
        thread (FakeHooks). Neither counts the wait for the owner thread or
        the interpreter lock (a busy host is load, not a sick card;
        ``probe_timeout`` still bounds the whole wait)."""
        t0 = time.perf_counter()
        device_s = self.hooks.probe()
        return device_s if device_s is not None else time.perf_counter() - t0

    def _note_probe_failure(self, reason: str) -> None:
        self.counters.probe_failures += 1
        self._failure_reasons.append((time.time(), reason))
        if self._publish:
            _PROBE_FAILURES.inc()
        logger.debug("backend probe failed: %s", reason)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            try:
                self._probe_tick()
            except Exception:
                logger.exception("backend probe loop iteration failed")

    def _probe_tick(self) -> None:
        """One probe + hysteresis step (the probe loop's body; tests call
        it directly for deterministic streak scenarios)."""
        state = self._state
        if state == PROBING:
            return  # initial acquisition owns this phase
        ok = self._run_probe()
        if ok:
            self._fail_streak = 0
            self._ok_streak += 1
            if (
                state == DEGRADED_CPU
                and self._ok_streak >= self.recover_after
            ):
                self._recover()
        else:
            self._ok_streak = 0
            self._fail_streak += 1
            if (
                state == READY
                and self._fail_streak >= self.degrade_after
            ):
                self._transition(
                    DEGRADED_CPU,
                    f"{self._fail_streak} consecutive probe failures",
                )

    def _recover(self) -> None:
        """Probe went green while degraded: re-acquire, go READY, wake the
        corpora.  A failed re-acquire drops straight back to
        DEGRADED_CPU."""
        self._transition(RECOVERING, f"{self._ok_streak} consecutive green probes")
        try:
            info = self._executor.submit(self.hooks.touch, self.acquire_timeout)
            self._device_info = info or {}
        except Exception as e:
            self._ok_streak = 0
            self._transition(DEGRADED_CPU, f"re-acquire failed: {e}")
            return
        with self._cond:
            corpora = [r() for r in self._corpora]
            self._corpora = [r for r in self._corpora if r() is not None]
        self._transition(READY, "recovered")
        # AFTER the READY transition lands: an uploader woken earlier would
        # still see RECOVERING and skip its sync
        for corpus in corpora:
            if corpus is None:
                continue
            try:
                corpus._on_backend_ready()
            except Exception:
                logger.exception("corpus post-recovery notification failed")

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        c = self.counters
        lat = list(self._latencies)
        return {
            "state": self._state,
            "device": dict(self._device_info),
            "probe_latency_s": round(self._probe_latency, 6),
            "probe_latency_p50_s": (
                round(statistics.median(lat), 6) if lat else 0.0),
            "probe_latency_max_s": round(max(lat), 6) if lat else 0.0,
            "probe_interval_s": self.probe_interval,
            "acquire_timeout_s": self.acquire_timeout,
            "recoveries_total": c.recoveries,
            "degrades_total": c.degrades,
            "acquire_timeouts_total": c.acquire_timeouts,
            "probes_total": c.probes,
            "probe_failures_total": c.probe_failures,
            "lock_violations_total": c.lock_violations,
            "probe_failures": [
                {"ts": ts, "reason": r} for ts, r in self._failure_reasons],
            "transitions": [
                {"ts": ts, "from": a, "to": b, "reason": r}
                for ts, a, b, r in c.transitions[-10:]
            ],
        }
