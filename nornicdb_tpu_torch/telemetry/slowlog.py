"""Slow-query capture: a bounded ring of queries over a threshold.

A copy of ``nornicdb_tpu/telemetry/slowlog.py`` (the port imports nothing of
the JAX package): family names, help text, label names, span names and
environment variables are the JAX package's, so one dashboard reads both.

The Cypher executor calls ``slow_log.maybe_record(...)`` after every
statement; queries at or above ``threshold_s`` are recorded with:

- **redacted query text** — string literals are replaced with ``'?'``
  (parameter placeholders like ``$name`` are already value-free), and
  parameter values are reduced to type/size descriptors, so the ring
  never holds user data;
- a **plan summary** (EXPLAIN output, computed only for slow queries);
- the **span breakdown** of the active trace so far (time per span name);
- **adjacency / device-sync counter deltas** between query start and end
  (a lightweight integer probe on the hot path, diffed only when slow).

Served at ``/admin/slow-queries``; knobs: ``NORNICDB_SLOW_QUERY_MS``
(default 1000; 0 disables) and ``NORNICDB_SLOW_QUERY_BUFFER`` (128), or
``config.TelemetryConfig`` via ``telemetry.configure``.
"""

from __future__ import annotations

import os
import re
import time
from collections import deque
from typing import Any, Optional

from nornicdb_tpu_torch.telemetry import budget as _budget

_STRING_LIT_RE = re.compile(
    r"""'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*\"""", re.S
)

# counters probed around every query; diffed only for slow ones.
# (name, attr-path) pairs resolved against the DB facade.
_MAX_QUERY_CHARS = 4096
_MAX_PLAN_CHARS = 2048


def redact_query(text: str) -> str:
    """Strip inline string literals; parameters stay as placeholders."""
    out = _STRING_LIT_RE.sub("'?'", text)
    if len(out) > _MAX_QUERY_CHARS:
        out = out[:_MAX_QUERY_CHARS] + "…"
    return out


def redact_params(params: Optional[dict]) -> dict[str, str]:
    """Parameter VALUES never enter the ring — only shape descriptors."""
    if not params:
        return {}
    out = {}
    for k, v in params.items():
        if isinstance(v, (list, tuple, set)):
            out[str(k)] = f"<{type(v).__name__}[{len(v)}]>"
        elif isinstance(v, dict):
            out[str(k)] = f"<dict[{len(v)}]>"
        elif isinstance(v, str):
            out[str(k)] = f"<str[{len(v)}]>"
        elif isinstance(v, bool) or v is None or isinstance(v, (int, float)):
            # scalars of these types are structural, not payload — but a
            # number can still be sensitive; keep only the type
            out[str(k)] = f"<{type(v).__name__}>"
        else:
            out[str(k)] = f"<{type(v).__name__}>"
    return out


def counters_probe(db) -> Optional[dict[str, float]]:
    """Cheap integer reads of the adjacency + device-sync counters (no
    dict building through the stats() surfaces, no locks)."""
    if db is None:
        return None
    out: dict[str, float] = {}
    snap = getattr(getattr(db, "storage", None), "_adjacency_snapshot", None)
    stats = getattr(snap, "stats", None)
    if stats is not None:
        out["adjacency_builds"] = stats.builds
        out["adjacency_delta_merges"] = stats.delta_merges
        out["adjacency_merged_edges"] = stats.merged_edges
        out["adjacency_epoch_retries"] = stats.epoch_retries
    search = getattr(db, "_search", None)  # never force lazy creation
    corpus = getattr(search, "_corpus", None)
    sync = getattr(corpus, "sync_stats", None)
    if sync is not None:
        out["sync_patches"] = sync.patches
        out["sync_full_uploads"] = sync.full_uploads
        out["sync_bytes_uploaded"] = sync.bytes_uploaded
        out["sync_query_stall_s"] = sync.query_stall_s
    # active recall-governed IVF plan: a slow search whose probe deltas
    # show a tune (or a drift re-tune) landing mid-query explains itself
    tune = getattr(search, "_tune_state", None)
    if tune is not None:
        out["ivf_n_probe"] = float(tune.n_probe if tune.serving_pruned
                                   else 0)
        out["ivf_local_k"] = float(tune.local_k if tune.serving_pruned
                                   else 0)
        out["ivf_measured_recall"] = float(tune.measured_recall)
        out["ivf_layout_epoch"] = float(tune.layout_epoch)
    counts = getattr(search, "tune_counts", None)
    if counts:
        out["ivf_tunes_total"] = float(sum(counts.values()))
    # columnar plan-cache counters (cypher/plan.py): a slow statement
    # whose deltas show a plan-cache miss just paid a fresh compile.
    # _executor, never the executor property — probing must not force
    # lazy executor construction
    ex = getattr(db, "_executor", None)
    pc = getattr(getattr(ex, "columnar", None), "cache", None)
    if pc is not None:
        out["cypher_plan_cache_hits"] = pc.hits
        out["cypher_plan_cache_misses"] = pc.misses
        out["cypher_plan_cache_invalidations"] = pc.invalidations
    return out or None


class SlowQueryLog:
    def __init__(self):
        try:
            ms = float(os.environ.get("NORNICDB_SLOW_QUERY_MS", "1000"))
        except ValueError:
            ms = 1000.0
        self.threshold_s = ms / 1000.0
        try:
            cap = int(os.environ.get("NORNICDB_SLOW_QUERY_BUFFER", "128"))
        except ValueError:
            cap = 128
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(cap, 1))
        self.recorded = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_s > 0

    def configure(self, threshold_s: Optional[float] = None,
                  capacity: Optional[int] = None) -> None:
        if threshold_s is not None:
            self.threshold_s = float(threshold_s)
        if capacity is not None:
            self._ring = deque(self._ring, maxlen=max(int(capacity), 1))

    def maybe_record(
        self,
        query: str,
        params: Optional[dict],
        duration_s: float,
        database: Optional[str] = None,
        plan: Optional[str] = None,
        probe_before: Optional[dict[str, float]] = None,
        probe_after: Optional[dict[str, float]] = None,
        trace_spans: Optional[list[dict]] = None,
        trace_id: Optional[str] = None,
        columnar: Optional[dict[str, Any]] = None,
        served: Optional[str] = None,
    ) -> bool:
        if not self.enabled or duration_s < self.threshold_s:
            return False
        deltas = None
        if probe_before and probe_after:
            deltas = {
                k: probe_after[k] - probe_before[k]
                for k in probe_after
                if k in probe_before and probe_after[k] != probe_before[k]
            }
        breakdown: dict[str, dict[str, float]] = {}
        for rec in trace_spans or []:
            agg = breakdown.setdefault(
                rec["name"], {"count": 0, "total_ms": 0.0}
            )
            agg["count"] += 1
            agg["total_ms"] += rec["duration_ms"]
        for agg in breakdown.values():
            agg["total_ms"] = round(agg["total_ms"], 3)
        entry = {
            "query": redact_query(query),
            "params": redact_params(params),
            "duration_ms": round(duration_s * 1e3, 3),
            "timestamp": time.time(),
            "database": database,
            "trace_id": trace_id,
            "span_breakdown": breakdown or None,
            # deadline-budget stage attribution (predicted at admission
            # vs actual from the spans) for offloaded device programs
            "budget": _budget.breakdown_for(trace_id, trace_spans),
            "counter_deltas": deltas,
            "plan": (plan[:_MAX_PLAN_CHARS] if plan else None),
            # columnar engine report: plan-cache key hash, outcome, and
            # measured per-operator timings (value-free — operator labels
            # render lifted literals as §N placeholders)
            "columnar": columnar,
        }
        if served is not None:
            # served-path attribution for worker-side vector searches
            # (broker / shm / proxy — the serving-ladder step that
            # actually answered)
            entry["served"] = served
        self._ring.append(entry)  # deque.append: atomic under the GIL
        self.recorded += 1
        return True

    def snapshot(self, limit: int = 100) -> list[dict[str, Any]]:
        """Newest-first for /admin/slow-queries."""
        return list(self._ring)[-limit:][::-1]

    def clear(self) -> None:
        self._ring.clear()


slow_log = SlowQueryLog()
