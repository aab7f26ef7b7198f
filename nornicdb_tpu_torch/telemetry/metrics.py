"""Metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``nornicdb_tpu/telemetry/metrics.py`` (the port imports nothing of
the JAX package): family names, help text, label names, span names and
environment variables are the JAX package's, so one dashboard reads both.

Design targets:

- **Hot-path cheap.** An instrumentation site resolves its cell ONCE
  (``family.labels(...)`` caches per label-value tuple) and every
  ``inc``/``set``/``observe`` afterwards is a slot update under that
  cell's own small lock — no registry lock, no dict lookup, no string
  formatting, no allocation.  Rendering walks the registry under the
  registry lock but never holds any cell lock while calling out
  (nornsan: cell locks are leaves).
- **Valid exposition.** ``render_prometheus()`` emits ``# HELP`` /
  ``# TYPE`` once per family, escapes label values, and renders
  histograms as cumulative ``_bucket`` / ``_sum`` / ``_count`` triples —
  the golden-file test in tests/test_telemetry.py parses the output with
  a strict reader.
- **Adapters, not re-plumbing.** ``stats_callback`` registers an existing
  ``stats()`` / ``stats_snapshot()`` dict provider; numeric leaves are
  flattened into gauges at render time (with optional exact-name renames
  for metrics whose names are documented/asserted, e.g.
  ``nornicdb_adjacency_builds_total``).

Registries nest: ``Registry(parent=REGISTRY)`` renders the process-global
instrumentation families plus its own — the HTTP server keeps its
db-specific callbacks in a child registry so multiple servers in one
process (tests) never fight over one namespace.
"""

from __future__ import annotations

import logging
import math
import re
import threading
from bisect import bisect_left
from typing import Any, Callable, Iterable, Optional

log = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency buckets (seconds): 100us .. 10s, roughly prometheus defaults
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# transfer-size buckets (bytes): 1KiB .. 1GiB
BYTE_BUCKETS = (
    1024.0, 16384.0, 131072.0, 1048576.0, 16777216.0,
    134217728.0, 1073741824.0,
)


def _escape_label(value: Any) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt(v: float) -> str:
    """Prometheus sample value: integral values render without a decimal
    point (``{:g}`` would silently round counters past 6 digits)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 2**63:
        return str(int(f))
    return repr(f)


class CounterCell:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def get(self) -> float:
        return self.value


class GaugeCell:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n

    def get(self) -> float:
        return self.value


class HistogramCell:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        idx = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self.counts), self.sum, self.count


_CELL_TYPES = {
    "counter": CounterCell,
    "gauge": GaugeCell,
    "histogram": HistogramCell,
}


class Family:
    """One named metric with a fixed label-name set and per-label-value
    cells.  The zero-label family IS its single cell's facade: ``inc`` /
    ``set`` / ``observe`` delegate to ``labels()``."""

    def __init__(
        self,
        name: str,
        kind: str,
        help_: str,
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._cells: dict[tuple[str, ...], Any] = {}

    def labels(self, *values: Any) -> Any:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {key}"
            )
        cell = self._cells.get(key)
        if cell is None:
            with self._lock:
                cell = self._cells.get(key)
                if cell is None:
                    if self.kind == "histogram":
                        cell = HistogramCell(self.buckets)
                    else:
                        cell = _CELL_TYPES[self.kind]()
                    self._cells[key] = cell
        return cell

    # zero-label convenience -------------------------------------------------
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def get(self, *values: Any) -> float:
        return self.labels(*values).get()

    # rendering --------------------------------------------------------------
    def _label_str(self, key: tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{ln}="{_escape_label(lv)}"'
            for ln, lv in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self, out: list[str]) -> None:
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            cells = list(self._cells.items())
        for key, cell in sorted(cells):
            if self.kind == "histogram":
                counts, total, n = cell.snapshot()
                cum = 0
                for bound, c in zip(cell.bounds, counts):
                    cum += c
                    le = 'le="%s"' % _fmt(bound)
                    out.append(
                        f"{self.name}_bucket{self._label_str(key, le)} {cum}"
                    )
                cum += counts[-1]
                inf = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket{self._label_str(key, inf)} {cum}"
                )
                out.append(
                    f"{self.name}_sum{self._label_str(key)} {_fmt(total)}"
                )
                out.append(f"{self.name}_count{self._label_str(key)} {n}")
            else:
                out.append(
                    f"{self.name}{self._label_str(key)} {_fmt(cell.get())}"
                )


def _flatten(prefix: str, data: Any, out: dict[str, float]) -> None:
    if isinstance(data, dict):
        for k, v in data.items():
            key = str(k).replace("-", "_").replace(".", "_")
            _flatten(f"{prefix}_{key}" if prefix else key, v, out)
    elif isinstance(data, bool):
        out[prefix] = 1.0 if data else 0.0
    elif isinstance(data, (int, float)):
        out[prefix] = float(data)
    # strings / lists / None are not metrics: skipped


class _StatsAdapter:
    """Render-time adapter flattening a stats() dict into samples."""

    def __init__(
        self,
        prefix: str,
        fn: Callable[[], Optional[dict]],
        help_: str,
        rename: Optional[dict[str, str]],
        counters: Iterable[str],
    ):
        self.prefix = prefix
        self.fn = fn
        self.help = help_
        self.rename = dict(rename or {})
        self.counters = frozenset(counters)

    def samples(self) -> list[tuple[str, str, str, float]]:
        """-> [(metric_name, kind, help, value)]"""
        data = self.fn()
        if not isinstance(data, dict):
            return []
        flat: dict[str, float] = {}
        _flatten(self.prefix, data, flat)
        out = []
        for flat_name, value in sorted(flat.items()):
            name = self.rename.get(flat_name, flat_name)
            if not _NAME_RE.match(name):
                continue
            kind = "counter" if flat_name in self.counters else "gauge"
            out.append((name, kind, self.help, value))
        return out


class Registry:
    """Metric families + render-time callbacks, optionally chained to a
    parent registry whose families render first."""

    def __init__(self, parent: Optional["Registry"] = None):
        self.parent = parent
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}
        # name -> (kind, help, fn) with fn() -> float
        self._callbacks: dict[str, tuple[str, str, Callable[[], float]]] = {}
        self._adapters: dict[str, _StatsAdapter] = {}
        # key -> fn() -> [(name, kind, help, value)], for providers whose
        # metric names/types are only known at render time (heimdall's
        # named-metric registry)
        self._family_callbacks: dict[
            str, Callable[[], list[tuple[str, str, str, float]]]
        ] = {}
        # key -> fn(), invoked BEFORE families render: refresh hooks for
        # labeled gauge families whose values are derived at scrape time
        # (the deviceprof HBM residency collector) — the family itself
        # renders through the normal path afterwards
        self._collect_hooks: dict[str, Callable[[], None]] = {}

    # -- family creation (idempotent: instrumentation sites may re-run) ----
    def _family(
        self,
        name: str,
        kind: str,
        help_: str,
        labels: tuple[str, ...],
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}{labels} "
                        f"(was {fam.kind}{fam.labelnames})"
                    )
                return fam
            fam = Family(name, kind, help_, tuple(labels), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Family:
        return self._family(name, "counter", help_, labels)

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Family:
        return self._family(name, "gauge", help_, labels)

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Family:
        return self._family(name, "histogram", help_, labels, buckets)

    # -- render-time callbacks (replace-on-re-register: a new server
    # instance in the same process takes over its names) -------------------
    def gauge_callback(
        self, name: str, help_: str, fn: Callable[[], float],
        kind: str = "gauge",
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            self._callbacks[name] = (kind, help_, fn)

    def counter_callback(self, name: str, help_: str, fn: Callable[[], float]) -> None:
        self.gauge_callback(name, help_, fn, kind="counter")

    def stats_callback(
        self,
        prefix: str,
        fn: Callable[[], Optional[dict]],
        help_: str = "",
        rename: Optional[dict[str, str]] = None,
        counters: Iterable[str] = (),
    ) -> None:
        """Adapt an existing stats()/stats_snapshot() provider: numeric
        leaves of the returned dict become gauges named
        ``<prefix>_<path_joined_by_underscores>``.  ``rename`` maps a
        flattened name to an exact metric name (for documented names);
        ``counters`` marks flattened names whose TYPE is counter."""
        with self._lock:
            self._adapters[prefix] = _StatsAdapter(
                prefix, fn, help_, rename, counters
            )

    def families_callback(
        self,
        key: str,
        fn: Callable[[], list[tuple[str, str, str, float]]],
    ) -> None:
        """Register a provider returning fully-formed samples
        ``[(metric_name, kind, help, value)]`` at render time."""
        with self._lock:
            self._family_callbacks[key] = fn

    def collect_hook(self, key: str, fn: Callable[[], None]) -> None:
        """Register a refresh hook run at the START of every render —
        for labeled families whose cell values are derived at scrape
        time (a plain gauge_callback cannot carry labels).  Hooks must
        be cheap and lock-light: they run on the scrape thread."""
        with self._lock:
            self._collect_hooks[key] = fn

    # -- rendering ----------------------------------------------------------
    def render_prometheus(self) -> str:
        out: list[str] = []
        seen: set[str] = set()
        self._render_into(out, seen)
        return "\n".join(out) + ("\n" if out else "")

    def _render_into(self, out: list[str], seen: set[str]) -> None:
        if self.parent is not None:
            self.parent._render_into(out, seen)
        with self._lock:
            collect_hooks = list(self._collect_hooks.items())
        for key, hook in collect_hooks:
            try:
                hook()
            except Exception:
                # a dead refresher must not take the exposition down
                log.debug("collect hook %s failed", key, exc_info=True)
        with self._lock:
            families = sorted(self._families.items())
            callbacks = sorted(self._callbacks.items())
            adapters = sorted(self._adapters.items())
            family_callbacks = sorted(self._family_callbacks.items())
        for name, fam in families:
            if name in seen:
                continue
            seen.add(name)
            fam.render(out)
        for name, (kind, help_, fn) in callbacks:
            if name in seen:
                continue
            try:
                value = fn()
            except Exception:
                # a dead provider (closed db in tests) must not take the
                # whole exposition down
                log.debug("metrics callback %s failed", name, exc_info=True)
                continue
            seen.add(name)
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            out.append(f"{name} {_fmt(value)}")
        for _, adapter in adapters:
            try:
                samples = adapter.samples()
            except Exception:
                log.debug(
                    "stats adapter %s failed", adapter.prefix, exc_info=True
                )
                continue
            for name, kind, help_, value in samples:
                if name in seen:
                    continue
                seen.add(name)
                if help_:
                    out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} {kind}")
                out.append(f"{name} {_fmt(value)}")
        for key, fn in family_callbacks:
            try:
                samples = fn()
            except Exception:
                log.debug("families callback %s failed", key, exc_info=True)
                continue
            for name, kind, help_, value in samples:
                if name in seen or not _NAME_RE.match(name):
                    continue
                seen.add(name)
                if help_:
                    out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} {kind}")
                out.append(f"{name} {_fmt(value)}")


#: process-global registry for instrumentation-site metrics (WAL, executor,
#: search, device sync, ...).  Server-owned db-specific callbacks live in a
#: child ``Registry(parent=REGISTRY)`` per server instance.
REGISTRY = Registry()

_component_errors = REGISTRY.counter(
    "nornicdb_component_errors_total",
    "Errors swallowed-but-logged by component (NL-ERR hygiene sites)",
    labels=("component",),
)


def count_error(component: str) -> None:
    """Error-hygiene helper: silent-except sites log AND count here, so
    operators see failure rates without grepping logs."""
    _component_errors.labels(component).inc()
