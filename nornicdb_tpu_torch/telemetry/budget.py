"""Per-request deadline-budget ledger: where did the deadline go?

A copy of ``nornicdb_tpu/telemetry/budget.py`` (the port imports nothing of
the JAX package): family names, help text, label names, span names and
environment variables are the JAX package's, so one dashboard reads both.

A request admitted with a deadline has a fixed budget of wall time; this
module attributes that budget to named pipeline stages so a slow or shed
request explains itself:

- **Stages** are a small closed vocabulary (``admission_queue``,
  ``tokenize_pack``, ``broker_hop``, ``prefill``, ``decode``,
  ``device_sync``, ``host_merge``) mapped from the span names the
  serving stack already records — no new instrumentation on the hot
  path, the tracer's retroactive spans ARE the actuals.
- **Predictions** land at admission: the predictive-admission points
  (serving/genserve/search) call :meth:`BudgetLedger.open` with the cost
  model's per-stage estimates, keyed by trace id on the existing trace
  context.
- **Breakdowns** (:func:`breakdown_for`) join predicted vs actual per
  stage for a finished trace — attached to slow-query entries
  (telemetry/slowlog.py) and the ``/admin/traces/<id>`` detail view.

The ledger is a bounded LRU (no growth under sustained traffic) and the
whole module is stdlib-only (telemetry package contract).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

#: closed stage vocabulary, in pipeline order
STAGES = (
    "admission_queue", "tokenize_pack", "broker_hop", "prefill",
    "decode", "device_sync", "host_merge",
)

#: span name -> budget stage.  Span names are the tracer's existing
#: vocabulary (docs/observability.md trace maps); anything unmapped is
#: simply not budget-attributed (it still shows in the span breakdown).
SPAN_STAGE_MAP = {
    "serving.queue_wait": "admission_queue",
    "search.queue_wait": "admission_queue",
    "genserve.queue_wait": "admission_queue",
    "genserve.admit": "admission_queue",
    "search.embed": "tokenize_pack",
    "worker.broker_call": "broker_hop",
    "worker.shm_search": "broker_hop",
    "genserve.prefill": "prefill",
    "genserve.decode": "decode",
    "serving.batch": "device_sync",
    "search.batch": "device_sync",
    "search.vector": "device_sync",
    "device.sync": "device_sync",
    "search.rank": "host_merge",
}

_MAX_ENTRIES = 512


class _Entry:
    __slots__ = ("route", "slack_s", "predicted_s", "opened_wall")

    def __init__(self, route: str, slack_s: float,
                 predicted_s: dict[str, float]):
        self.route = route
        self.slack_s = slack_s
        self.predicted_s = dict(predicted_s)
        self.opened_wall = time.time()


class BudgetLedger:
    """trace_id -> admission-time prediction, bounded LRU."""

    def __init__(self, capacity: int = _MAX_ENTRIES):
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self._capacity = capacity
        self.opened = 0

    def open(self, trace_id: Optional[str], route: str, slack_s: float,
             predicted_s: dict[str, float]) -> None:
        """Record the admission-time stage predictions for a trace.
        No-op without a trace id (untraced/unsampled requests carry no
        budget — the ledger keys on the trace the breakdown joins)."""
        if not trace_id:
            return
        entry = _Entry(route, slack_s, predicted_s)
        with self._lock:
            self._entries[trace_id] = entry
            self._entries.move_to_end(trace_id)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)
            self.opened += 1

    def get(self, trace_id: Optional[str]) -> Optional[_Entry]:
        if not trace_id:
            return None
        with self._lock:
            return self._entries.get(trace_id)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def stage_actuals(spans) -> dict[str, dict[str, float]]:
    """Fold span records into per-stage actuals:
    ``{stage: {"ms": total, "count": n}}`` (unmapped spans skipped)."""
    out: dict[str, dict[str, float]] = {}
    for rec in spans or []:
        if not isinstance(rec, dict):
            continue
        stage = SPAN_STAGE_MAP.get(rec.get("name"))
        if stage is None:
            continue
        agg = out.setdefault(stage, {"ms": 0.0, "count": 0})
        agg["ms"] += float(rec.get("duration_ms") or 0.0)
        agg["count"] += 1
    for agg in out.values():
        agg["ms"] = round(agg["ms"], 3)
    return out


def breakdown_for(trace_id: Optional[str],
                  spans) -> Optional[dict[str, Any]]:
    """Join the ledger's admission-time predictions with the trace's
    span-derived actuals into one stage table (pipeline order; stages
    with neither prediction nor actual are omitted).  None when the
    trace has no budget-attributable content at all."""
    actuals = stage_actuals(spans)
    entry = LEDGER.get(trace_id)
    if not actuals and entry is None:
        return None
    predicted = entry.predicted_s if entry is not None else {}
    stages = []
    for stage in STAGES:
        pred_s = predicted.get(stage)
        act = actuals.get(stage)
        if pred_s is None and act is None:
            continue
        stages.append({
            "stage": stage,
            "predicted_ms": (round(pred_s * 1e3, 3)
                             if pred_s is not None else None),
            "actual_ms": act["ms"] if act else None,
            "spans": act["count"] if act else 0,
        })
    out: dict[str, Any] = {"stages": stages}
    if entry is not None:
        out["route"] = entry.route
        out["deadline_budget_ms"] = round(entry.slack_s * 1e3, 3)
        out["predicted_total_ms"] = round(
            sum(predicted.values()) * 1e3, 3)
    actual_total = sum(s["actual_ms"] or 0.0 for s in stages)
    out["actual_total_ms"] = round(actual_total, 3)
    return out


#: process-global ledger (admission points write, slowlog/traces read)
LEDGER = BudgetLedger()

open_budget = LEDGER.open
