"""Device-time & HBM profiler: one per-process view of device cost
(counterpart of ``nornicdb_tpu/telemetry/deviceprof.py``; family names,
help text and labels are the JAX package's).

- **Program registry** keyed ``(subsystem, kind, shape)``: every device
  dispatch records its execute time; the first execute of a new key also
  counts as a compile (the ledger meaning: the first time a shape class is
  seen in this process), and warmup paths may pre-register keys with
  :func:`record_compile`. Exposed as ``nornicdb_device_programs_total``
  and ``nornicdb_device_program_seconds``, both labeled ``(subsystem,
  kind, shape)``; callers keep the shape classes bounded (pow2 buckets).
- **Device residency** ``nornicdb_hbm_bytes{component}``: components
  (corpus f32 buffers, int8 codes+scales, IVF block arrays, the genserve
  KV page pool, embedder params) register weakref'd byte providers at
  construction, each summing its tensors' ``numel() * element_size()``;
  a registry collect-hook sums the live providers per component at
  scrape time. Providers run on the scrape thread: they read tensor refs
  lock-free (stats-grade accuracy, never a lock).
- **On-demand profile capture** (:func:`capture_profile`): a
  single-flight ``torch.profiler`` trace (CPU and, on the card, CUDA
  activity) over N seconds, its Chrome trace tarred into a downloadable
  artifact.

Import-light: torch loads only inside :func:`capture_profile`.
"""

from __future__ import annotations

import io
import logging
import os
import shutil
import tarfile
import tempfile
import threading
import time
import weakref
from typing import TYPE_CHECKING, Callable, Optional

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

if TYPE_CHECKING:
    from nornicdb_tpu_torch._device import DeviceLike

log = logging.getLogger(__name__)

# components rendered eagerly so the tested docs/observability.md catalog
# exposes the family (at 0) before any device buffer exists
HBM_COMPONENTS = (
    "corpus_f32", "corpus_int8", "ivf", "kv_pages", "kv_prefix",
    "embedder_params",
)

_HBM = _REGISTRY.gauge(
    "nornicdb_hbm_bytes",
    "Device-resident bytes by component (corpus f32 buffers, int8 "
    "codes+scales, IVF block arrays, genserve KV page pool, the pool "
    "slice held by the shared-prefix cache, embedder params)",
    labels=("component",),
)
_HBM_CELLS = {c: _HBM.labels(c) for c in HBM_COMPONENTS}

_PROGRAMS = _REGISTRY.counter(
    "nornicdb_device_programs_total",
    "Distinct compiled device programs by (subsystem, kind, shape) — "
    "ledger semantics: one count per static shape class per process",
    labels=("subsystem", "kind", "shape"),
)
_EXEC_HIST = _REGISTRY.histogram(
    "nornicdb_device_program_seconds",
    "Device program execute time by (subsystem, kind, shape)",
    labels=("subsystem", "kind", "shape"),
)
# the help text is the JAX package's, word for word (dashboards match it)
_PROFILE_CAPTURES = _REGISTRY.counter(
    "nornicdb_profile_captures_total",
    "On-demand jax.profiler captures by outcome",
    labels=("outcome",),
)
for _out in ("ok", "busy", "error"):
    _PROFILE_CAPTURES.labels(_out)


class ProfileBusy(RuntimeError):
    """A capture is already in flight (the endpoint is single-flight: one
    profiler session a process)."""


class _ProgramEntry:
    __slots__ = ("compiles", "executes", "total_s")

    def __init__(self) -> None:
        self.compiles = 0
        self.executes = 0
        self.total_s = 0.0


class DeviceProfiler:
    """Per-process program registry + HBM provider set."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: dict[tuple[str, str, str], _ProgramEntry] = {}
        # id(owner) -> (weakref(owner), fn(owner) -> {component: bytes})
        self._hbm_providers: dict[int, tuple] = {}
        self._capture_lock = threading.Lock()
        self.captures = 0
        # observers see every record_compile/record_execute key on the
        # RECORDING thread, before/around the dispatch it annotates
        self._observers: list[Callable[[str, str, str], None]] = []
        # time observers additionally receive the execute duration: the
        # per-program cost model (telemetry/costmodel.py) learns its EWMAs
        # from these
        self._time_observers: list[
            Callable[[str, str, str, float], None]
        ] = []

    def add_observer(self, fn: Callable[[str, str, str], None]) -> None:
        """Register ``fn(subsystem, kind, shape)`` called synchronously
        on every ledger record.  Observers must be cheap and must not
        raise (failures are swallowed at notify time)."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn: Callable[[str, str, str], None]) -> None:
        with self._lock:
            try:
                self._observers.remove(fn)
            except ValueError:
                pass

    def add_time_observer(
        self, fn: Callable[[str, str, str, float], None],
    ) -> None:
        """Register ``fn(subsystem, kind, shape, seconds)`` called on
        every :meth:`record_execute`.  Same contract as observers:
        cheap, never raises (failures swallowed at notify time)."""
        with self._lock:
            if fn not in self._time_observers:
                self._time_observers.append(fn)

    def remove_time_observer(
        self, fn: Callable[[str, str, str, float], None],
    ) -> None:
        with self._lock:
            try:
                self._time_observers.remove(fn)
            except ValueError:
                pass

    def _notify(self, key: tuple[str, str, str]) -> None:
        for fn in list(self._observers):
            try:
                fn(*key)
            except Exception:
                log.debug("deviceprof observer failed", exc_info=True)

    def _notify_time(self, key: tuple[str, str, str],
                     seconds: float) -> None:
        for fn in list(self._time_observers):
            try:
                fn(key[0], key[1], key[2], seconds)
            except Exception:
                log.debug("deviceprof time observer failed", exc_info=True)

    # -- program ledger ----------------------------------------------------
    def record_compile(self, subsystem: str, kind: str, shape) -> None:
        """Register a program key without an execute (warmup paths).
        Idempotent per key — ledger semantics, not a recompile count."""
        key = (subsystem, kind, str(shape))
        with self._lock:
            entry = self._programs.get(key)
            if entry is None:
                entry = self._programs[key] = _ProgramEntry()
            if entry.compiles == 0:
                entry.compiles = 1
                _PROGRAMS.labels(*key).inc()
        self._notify(key)

    def record_execute(self, subsystem: str, kind: str, shape,
                       seconds: float) -> None:
        """One device dispatch: execute-time histogram + first-seen
        compile count."""
        key = (subsystem, kind, str(shape))
        with self._lock:
            entry = self._programs.get(key)
            if entry is None:
                entry = self._programs[key] = _ProgramEntry()
            if entry.compiles == 0:
                entry.compiles = 1
                _PROGRAMS.labels(*key).inc()
            entry.executes += 1
            entry.total_s += seconds
        _EXEC_HIST.labels(*key).observe(seconds)
        self._notify(key)
        self._notify_time(key, seconds)

    # -- HBM residency -----------------------------------------------------
    def register_hbm(self, owner, fn: Callable[[object], dict]) -> None:
        """Register a residency provider: ``fn(owner) -> {component:
        bytes}``.  ``owner`` is held by weakref — a GC'd corpus/engine
        disappears from the sum without unregistration ceremony.  ``fn``
        must be lock-free (scrape-thread contract)."""
        ref = weakref.ref(owner)
        with self._lock:
            self._hbm_providers[id(owner)] = (ref, fn)

    def refresh_hbm(self) -> None:
        """Collect-hook: sum live providers per component into the gauge
        (runs at the start of every /metrics render)."""
        totals = {c: 0.0 for c in HBM_COMPONENTS}
        with self._lock:
            providers = list(self._hbm_providers.items())
        dead = []
        for key, (ref, fn) in providers:
            owner = ref()
            if owner is None:
                dead.append(key)
                continue
            try:
                contrib = fn(owner)
            except Exception:
                log.debug("hbm provider failed", exc_info=True)
                continue
            for comp, nbytes in (contrib or {}).items():
                totals[comp] = totals.get(comp, 0.0) + float(nbytes or 0)
        if dead:
            with self._lock:
                for key in dead:
                    self._hbm_providers.pop(key, None)
        for comp, total in totals.items():
            cell = _HBM_CELLS.get(comp)
            if cell is None:
                cell = _HBM_CELLS[comp] = _HBM.labels(comp)
            cell.set(total)

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured view for /admin/stats → ``deviceprof``."""
        self.refresh_hbm()
        with self._lock:
            programs = [
                {
                    "subsystem": k[0], "kind": k[1], "shape": k[2],
                    "compiles": e.compiles, "executes": e.executes,
                    "total_s": round(e.total_s, 6),
                }
                for k, e in sorted(self._programs.items())
            ]
        return {
            "programs": programs,
            "program_count": len(programs),
            "hbm_bytes": {c: cell.get()
                          for c, cell in sorted(_HBM_CELLS.items())},
            "captures": self.captures,
        }

    # -- profile capture ---------------------------------------------------
    def capture_profile(self, seconds: float, max_seconds: float = 60.0,
                        device: DeviceLike = None) -> bytes:
        """Single-flight ``torch.profiler`` capture: trace for ``seconds``
        (clamped to [0.05, max_seconds]), return the capture directory (a
        Chrome trace) as a gzipped tar. ``device=None`` means CUDA (CPU and
        CUDA activity, the token op on the card; DeviceUnavailable without
        one); ``device="cpu"`` traces CPU activity only. CUDA kernels are
        recorded process-wide, whichever thread launched them. Raises
        :class:`ProfileBusy` when a capture is already running; any
        profiler failure propagates."""
        seconds = max(0.05, min(float(seconds), float(max_seconds)))
        # non-blocking try-acquire: the single-flight gate; on success the
        # very next statement is the try whose finally releases
        if not self._capture_lock.acquire(blocking=False):
            _PROFILE_CAPTURES.labels("busy").inc()
            raise ProfileBusy("a profile capture is already in flight")
        tmpdir = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            from nornicdb_tpu_torch._device import resolve_device

            dev = resolve_device(device)
            activities = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            tmpdir = tempfile.mkdtemp(prefix="nornic-profile-")
            with profile(activities=activities) as prof:
                # a token device op so even an idle process produces a
                # non-empty trace (the capture's value is the LIVE traffic
                # recorded during the window; this just guarantees the
                # artifact is never empty)
                x = torch.ones((128, 128), dtype=torch.float32, device=dev)
                (x @ x).sum().item()
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(tmpdir, "trace.json"))
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                for dirpath, _dirnames, filenames in os.walk(tmpdir):
                    for fname in filenames:
                        full = os.path.join(dirpath, fname)
                        tar.add(full,
                                arcname=os.path.relpath(full, tmpdir))
            self.captures += 1
            _PROFILE_CAPTURES.labels("ok").inc()
            return buf.getvalue()
        except Exception:
            _PROFILE_CAPTURES.labels("error").inc()
            raise
        finally:
            if tmpdir is not None:
                shutil.rmtree(tmpdir, ignore_errors=True)
            self._capture_lock.release()


#: process-global profiler — instrumentation sites resolve it at import.
#: Only the singleton drives the registry's pre-render refresh: a
#: privately-constructed profiler (tests) must not hijack the hook and
#: zero the shared gauges with its own empty provider set.
PROFILER = DeviceProfiler()
_REGISTRY.collect_hook("deviceprof_hbm", PROFILER.refresh_hbm)

add_time_observer = PROFILER.add_time_observer
record_compile = PROFILER.record_compile
record_execute = PROFILER.record_execute
register_hbm = PROFILER.register_hbm
capture_profile = PROFILER.capture_profile
snapshot = PROFILER.snapshot


def pow2_class(n: int, prefix: str = "") -> str:
    """Bounded shape-class label: n rounded up to a power of two."""
    n = max(1, int(n))
    return f"{prefix}{1 << (n - 1).bit_length()}"
