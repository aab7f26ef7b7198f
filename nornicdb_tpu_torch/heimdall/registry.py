"""Heimdall model registry, metrics registry, and async DB-event
dispatcher: a copy of ``nornicdb_tpu/heimdall/registry.py`` (host code).

Behavioral reference: the upstream NornicDB pkg/heimdall/ —
ModelInfo/ModelType registry (types.go:23-42: name/path/type/size/
quantization/loaded/last_used/VRAM estimate), the metrics registry
(metrics.go: named counters/gauges with Prometheus text rendering), and
the database event dispatcher (plugin.go:1345-1488: bounded 1000-event
queue, background delivery thread, non-blocking emit with drop-on-full,
per-plugin panic isolation).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)

# model kinds (ref: types.go:23-29)
MODEL_EMBEDDING = "embedding"
MODEL_REASONING = "reasoning"
MODEL_CLASSIFICATION = "classification"

_MODEL_TYPES = {MODEL_EMBEDDING, MODEL_REASONING, MODEL_CLASSIFICATION}


@dataclass
class ModelInfo:
    """(ref: ModelInfo types.go:32)"""

    name: str
    type: str
    path: str = ""
    size_bytes: int = 0
    quantization: str = ""
    loaded: bool = False
    last_used: float = 0.0
    vram_estimate_bytes: int = 0
    # the in-process backend (a Generator or an Embedder); None = metadata
    # entry only, loaded lazily via the loader callable
    backend: Any = None
    loader: Optional[Callable[[], Any]] = None

    def as_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "type": self.type,
            "path": self.path,
            "size_bytes": self.size_bytes,
            "quantization": self.quantization,
            "loaded": self.loaded,
            "last_used": self.last_used,
            "vram_estimate_bytes": self.vram_estimate_bytes,
        }


class ModelRegistry:
    """Named models by type, with lazy loading + LRU-style last_used
    tracking (ref: the registry the scheduler consults to pick the
    generation model; generator_cgo.go loads on demand)."""

    def __init__(self) -> None:
        self._models: dict[str, ModelInfo] = {}
        self._default: dict[str, str] = {}  # type -> model name
        self._lock = threading.Lock()
        # per-model load locks so two threads never run the same (large)
        # loader concurrently, without serializing unrelated loads
        self._load_locks: dict[str, threading.Lock] = {}

    def register(self, info: ModelInfo, default: bool = False) -> None:
        if info.type not in _MODEL_TYPES:
            raise ValueError(f"unknown model type {info.type!r}")
        with self._lock:
            self._models[info.name] = info
            if default or info.type not in self._default:
                self._default[info.type] = info.name

    def get(self, name: str) -> Optional[ModelInfo]:
        with self._lock:
            return self._models.get(name)

    def list(self, type_: Optional[str] = None) -> list[ModelInfo]:
        with self._lock:
            models = list(self._models.values())
        if type_ is not None:
            models = [m for m in models if m.type == type_]
        return sorted(models, key=lambda m: m.name)

    def default_for(self, type_: str) -> Optional[ModelInfo]:
        with self._lock:
            name = self._default.get(type_)
            return self._models.get(name) if name else None

    def set_default(self, type_: str, name: str) -> None:
        with self._lock:
            if name not in self._models:
                raise KeyError(name)
            self._default[type_] = name

    def acquire(self, name: str) -> Any:
        """Returns the model backend, loading it on first use and
        stamping last_used (ref: Loaded/LastUsed bookkeeping)."""
        with self._lock:
            info = self._models.get(name)
            if info is None:
                raise KeyError(f"model {name!r} not registered")
            load_lock = self._load_locks.setdefault(name, threading.Lock())
        if info.backend is None and info.loader is not None:
            # the expensive load runs under the per-model lock so a
            # concurrent request for the same model waits instead of
            # double-loading a multi-GB backend
            with load_lock:
                if info.backend is None:
                    info.backend = info.loader()
        with self._lock:
            info.loaded = info.backend is not None
            info.last_used = time.time()
            return info.backend

    def unload(self, name: str) -> bool:
        """Drop the backend reference (memory reclaim on next GC)."""
        with self._lock:
            info = self._models.get(name)
            if info is None or info.backend is None:
                return False
            info.backend = None
            info.loaded = False
            return True


class MetricsRegistry:
    """Named counters/gauges with Prometheus text rendering
    (ref: pkg/heimdall/metrics.go)."""

    def __init__(self, prefix: str = "heimdall") -> None:
        self.prefix = prefix
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, self._gauges.get(name, 0.0))

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {**self._counters, **self._gauges}

    def prometheus_families(self) -> list[tuple[str, str, str, float]]:
        """Typed samples for the telemetry registry's families_callback:
        [(metric_name, kind, help, value)] — keeps counter/gauge typing
        when the unified /metrics exposition renders these."""
        out: list[tuple[str, str, str, float]] = []
        with self._lock:
            for name, v in sorted(self._counters.items()):
                out.append((f"{self.prefix}_{name}", "counter", "", v))
            for name, v in sorted(self._gauges.items()):
                out.append((f"{self.prefix}_{name}", "gauge", "", v))
        return out

    def render_prometheus(self) -> str:
        lines = []
        for full, kind, _help, v in self.prometheus_families():
            lines.append(f"# TYPE {full} {kind}")
            lines.append(f"{full} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")


@dataclass
class DatabaseEvent:
    """(ref: DatabaseEvent plugin.go — node/relationship/query events)"""

    type: str
    node_id: str = ""
    node_labels: list[str] = field(default_factory=list)
    relationship_id: str = ""
    relationship_type: str = ""
    source_node_id: str = ""
    target_node_id: str = ""
    properties: dict[str, Any] = field(default_factory=dict)
    query: str = ""
    duration: float = 0.0
    rows_affected: int = 0
    error: str = ""
    timestamp: float = 0.0


class EventDispatcher:
    """Async delivery of database events to subscribers: bounded queue,
    one background thread, non-blocking emit with drop-on-full, per-
    subscriber error isolation (ref: dbEventDispatcher plugin.go:1349,
    1000-event buffer, fire-and-forget with panic recovery)."""

    QUEUE_SIZE = 1000

    def __init__(self) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=self.QUEUE_SIZE)
        self._subscribers: list[Callable[[DatabaseEvent], None]] = []
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.dropped = 0
        self.delivered = 0

    def subscribe(self, fn: Callable[[DatabaseEvent], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="heimdall-events"
        )
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
        try:
            # non-blocking wake: a full queue means the worker is active
            # and will observe _running on its own — a blocking put here
            # could hang stop() behind a wedged subscriber
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def emit(self, event: DatabaseEvent) -> bool:
        """Non-blocking; returns False when the queue is full and the
        event was dropped (ref: EmitDatabaseEvent drop-on-full)."""
        if not self._running:
            return False
        if not event.timestamp:
            event.timestamp = time.time()
        try:
            self._queue.put_nowait(event)
            return True
        except queue.Full:
            self.dropped += 1
            return False

    # convenience emitters (ref: EmitNodeEvent/EmitRelationshipEvent/
    # EmitQueryEvent plugin.go:1455-1488)
    def emit_node_event(self, type_: str, node_id: str,
                        labels: Optional[list[str]] = None,
                        properties: Optional[dict] = None) -> bool:
        return self.emit(DatabaseEvent(
            type=type_, node_id=node_id, node_labels=list(labels or []),
            properties=dict(properties or {}),
        ))

    def emit_relationship_event(self, type_: str, rel_id: str,
                                rel_type: str, source_id: str,
                                target_id: str) -> bool:
        return self.emit(DatabaseEvent(
            type=type_, relationship_id=rel_id, relationship_type=rel_type,
            source_node_id=source_id, target_node_id=target_id,
        ))

    def emit_query_event(self, type_: str, query_text: str,
                         duration: float, rows: int = 0,
                         error: str = "") -> bool:
        return self.emit(DatabaseEvent(
            type=type_, query=query_text, duration=duration,
            rows_affected=rows, error=error,
        ))

    def _run(self) -> None:
        while True:
            try:
                # bounded wait so the worker re-checks _running even when
                # stop()'s wake sentinel couldn't be enqueued (full queue)
                event = self._queue.get(timeout=0.5)
            except queue.Empty:
                with self._lock:
                    if not self._running:
                        return
                continue
            if event is None:
                with self._lock:
                    if not self._running:
                        return
                continue
            with self._lock:
                subs = list(self._subscribers)
            for fn in subs:
                try:
                    fn(event)
                except Exception:
                    # a broken subscriber must not stall delivery, but a
                    # permanently crashing one should be visible
                    log.warning("event subscriber %r failed",
                                getattr(fn, "__name__", fn), exc_info=True)
                    count_error("heimdall.event_subscriber")
            self.delivered += 1
