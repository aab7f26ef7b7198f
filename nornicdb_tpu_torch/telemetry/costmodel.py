"""Online per-program cost model: the capacity loop's control signal.

A copy of ``nornicdb_tpu/telemetry/costmodel.py`` (the port imports nothing of
the JAX package): family names, help text, label names, span names and
environment variables are the JAX package's, so one dashboard reads both. Two
things differ: ``_refresh_build_info`` reads the backend from torch, and
``decide`` takes ``idle`` (an idle backend probes instead of shedding).

The deviceprof ledger (telemetry/deviceprof.py) records what every device
dispatch *did* cost, keyed ``(subsystem, kind, shape-class)``.  This
module learns from that stream — an EWMA per shape class plus a per-unit
EWMA per kind — and turns it around into *predictions* the admission
points consult BEFORE dispatching:

- :meth:`CostModel.observe` is wired as a deviceprof time observer:
  every ``record_execute`` first scores the model (relative error of the
  standing prediction vs the actual, into
  ``nornicdb_cost_model_relative_error``) and then folds the sample in.
- :meth:`CostModel.predict` answers "what will a dispatch of this kind
  and size cost" — exact shape-class EWMA when the class has history,
  per-unit scaling from the kind aggregate otherwise, a cold-start prior
  as the last resort — with a confidence score ``n / (n + K)``.
- :meth:`CostModel.decide` is the predictive-admission primitive: given
  the caller's deadline slack and the work already queued ahead of it,
  shed at submit (``reason="predicted_deadline"``) when the conservative
  prediction cannot fit, fail OPEN while confidence is low (a cold model
  must never turn traffic away), and always admit when predictive
  admission is disabled.  Decisions are counted in
  ``nornicdb_cost_model_admission_total{route,decision}``.
- :meth:`CostModel.record_latency` feeds per-route SLO burn-rate gauges
  (``nornicdb_slo_burn_rate``): the miss fraction over a sliding window
  divided by the error budget ``1 - objective`` — burn > 1 means the
  route is eating budget faster than the SLO allows.
- :meth:`CostModel.capacity_snapshot` renders the whole table for
  ``GET /admin/capacity``: per-program costs, confidence, and a headroom
  estimate (max sustainable qps per workload class, device-serialized).

Knobs (config.TelemetryConfig / ``NORNICDB_TELEMETRY_*`` env):
``cost_conservatism`` (predictions are multiplied by this before the
deadline comparison), ``cost_min_confidence`` (fail-open floor),
``predictive_admission`` (master switch), ``slo_targets``
(``"route=ms,route=ms"``), ``slo_objective``.

Import-light and stdlib-only (telemetry package contract); the
``nornicdb_build_info`` info-gauge also lives here so every process that
can answer /admin/capacity also says what build is answering.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from collections import deque
from typing import Optional

from nornicdb_tpu_torch.telemetry import deviceprof as _deviceprof
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

log = logging.getLogger(__name__)

# EWMA smoothing factor: ~10 samples of memory, fast enough to track a
# backend fallback (device -> host) within one scrape interval
ALPHA = 0.3
# confidence = n / (n + K): K observations to reach 0.5
CONFIDENCE_K = 8.0
# recent relative errors kept per kind (accuracy tests + snapshot)
REL_ERR_WINDOW = 256
# per-route SLO window: latency outcomes considered by the burn rate
SLO_WINDOW = 512
# half-open probe cadence: after this many consecutive predicted sheds
# of a (subsystem, kind), admit one request anyway.  A model that sheds
# everything starves itself of observations and can never unlearn an
# outlier-inflated EWMA (a 2s backend hang folded into a 60ms program
# would otherwise shed that route forever).
PROBE_EVERY = 8

# cold-start priors (seconds per dispatch) by (subsystem, kind); the
# generic prior covers unseen kinds.  Deliberately pessimistic for the
# generation path (a prefill chunk is model-forward-sized) and cheap for
# the vector paths (one fused GEMM).
PRIORS: dict[tuple[str, str], float] = {
    ("serving", "embed"): 0.02,
    ("genserve", "ragged"): 0.05,
    ("search", "dense"): 0.005,
    ("search", "ivf"): 0.005,
    ("search", "sharded"): 0.01,
    ("search", "sharded_ivf"): 0.01,
    ("search", "sharded_int8"): 0.01,
    ("cypher", "vector_topk"): 0.005,
    ("cypher", "topk_offload"): 0.005,
}
DEFAULT_PRIOR_S = 0.02

_REL_ERR_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5, 0.75, 1.0, 2.0, 5.0,
)

PREDICTED_SECONDS = _REGISTRY.counter(
    "nornicdb_cost_model_predicted_seconds_total",
    "Cumulative predicted device seconds by program kind (each ledger "
    "observation adds the prediction that stood before it)",
    labels=("subsystem", "kind"),
)
ACTUAL_SECONDS = _REGISTRY.counter(
    "nornicdb_cost_model_actual_seconds_total",
    "Cumulative actual device seconds by program kind (the deviceprof "
    "ledger stream the cost model learns from)",
    labels=("subsystem", "kind"),
)
OBSERVATIONS = _REGISTRY.counter(
    "nornicdb_cost_model_observations_total",
    "Ledger observations folded into the cost model by program kind",
    labels=("subsystem", "kind"),
)
REL_ERR_HIST = _REGISTRY.histogram(
    "nornicdb_cost_model_relative_error",
    "Relative error |actual - predicted| / actual of the standing "
    "prediction at each ledger observation",
    labels=("subsystem", "kind"),
    buckets=_REL_ERR_BUCKETS,
)
CONFIDENCE = _REGISTRY.gauge(
    "nornicdb_cost_model_confidence",
    "Cost-model confidence n/(n+K) by program kind (admission fails "
    "open below cost_min_confidence)",
    labels=("subsystem", "kind"),
)
ADMISSIONS = _REGISTRY.counter(
    "nornicdb_cost_model_admission_total",
    "Predictive-admission decisions by route (shed = predicted "
    "completion past the deadline at submit; fail_open = confidence "
    "below the floor, admitted unchecked)",
    labels=("route", "decision"),
)
for _route in ("embed", "search", "generate"):
    for _decision in ("admit", "shed", "fail_open"):
        ADMISSIONS.labels(_route, _decision)
SLO_BURN = _REGISTRY.gauge(
    "nornicdb_slo_burn_rate",
    "Per-route SLO burn rate: miss fraction over the sliding window "
    "divided by the error budget (1 - objective); > 1 burns budget",
    labels=("route",),
)
SLO_TARGET = _REGISTRY.gauge(
    "nornicdb_slo_target_seconds",
    "Configured per-route latency SLO target",
    labels=("route",),
)
BUILD_INFO = _REGISTRY.gauge(
    "nornicdb_build_info",
    "Build/runtime identity info-gauge (value is always 1; the labels "
    "are the payload)",
    labels=("version", "backend", "mesh_devices"),
)

_Q_RE = re.compile(r"q(\d+)")
_TRAIL_RE = re.compile(r"(\d+)$")


def shape_units(shape: str) -> Optional[int]:
    """Work units encoded in a bounded shape-class label.

    Deviceprof shape classes are pow2 buckets with a subsystem prefix
    (``b64``, ``t4096``, ``n1024``, bare ``1024``); genserve's fused
    ragged step uses ``f{rows}q{chunk}x{width}`` where the chunk token
    count (``qN``) is the work-proportional axis."""
    m = _Q_RE.search(shape)
    if m:
        return int(m.group(1))
    m = _TRAIL_RE.search(shape)
    if m:
        return int(m.group(1))
    return None


class _ClassEntry:
    """EWMA state for one exact (subsystem, kind, shape-class)."""

    __slots__ = ("ewma_s", "n")

    def __init__(self) -> None:
        self.ewma_s = 0.0
        self.n = 0

    def fold(self, seconds: float) -> None:
        if self.n == 0:
            self.ewma_s = seconds
        else:
            self.ewma_s += ALPHA * (seconds - self.ewma_s)
        self.n += 1

    @property
    def confidence(self) -> float:
        return self.n / (self.n + CONFIDENCE_K)


class _KindStats:
    """Aggregate state for one (subsystem, kind) across shape classes."""

    __slots__ = ("ewma_s", "ewma_per_unit", "n", "rel_errs")

    def __init__(self) -> None:
        self.ewma_s = 0.0  # per dispatch, any shape
        self.ewma_per_unit = 0.0  # per work unit (token/row/chunk)
        self.n = 0
        self.rel_errs: deque[float] = deque(maxlen=REL_ERR_WINDOW)

    def fold(self, seconds: float, units: Optional[int]) -> None:
        if self.n == 0:
            self.ewma_s = seconds
        else:
            self.ewma_s += ALPHA * (seconds - self.ewma_s)
        if units:
            per_unit = seconds / max(units, 1)
            if self.ewma_per_unit <= 0.0:
                self.ewma_per_unit = per_unit
            else:
                self.ewma_per_unit += ALPHA * (per_unit -
                                               self.ewma_per_unit)
        self.n += 1

    @property
    def confidence(self) -> float:
        return self.n / (self.n + CONFIDENCE_K)


class Decision:
    """One predictive-admission verdict."""

    __slots__ = ("admit", "decision", "predicted_s", "confidence",
                 "slack_s")

    def __init__(self, admit: bool, decision: str, predicted_s: float,
                 confidence: float, slack_s: float):
        self.admit = admit
        self.decision = decision  # admit | shed | fail_open
        self.predicted_s = predicted_s
        self.confidence = confidence
        self.slack_s = slack_s


class CostModel:
    """Online per-program cost model + SLO burn tracker."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._classes: dict[tuple[str, str, str], _ClassEntry] = {}
        self._kinds: dict[tuple[str, str], _KindStats] = {}
        # knobs (import-time env, then telemetry.configure overrides)
        self.conservatism = _env_float(
            "NORNICDB_TELEMETRY_COST_CONSERVATISM", 1.5)
        self.min_confidence = _env_float(
            "NORNICDB_TELEMETRY_COST_MIN_CONFIDENCE", 0.25)
        self.predictive_admission = os.environ.get(
            "NORNICDB_TELEMETRY_PREDICTIVE_ADMISSION", "1"
        ).lower() not in ("0", "false", "no")
        self.slo_objective = _env_float(
            "NORNICDB_TELEMETRY_SLO_OBJECTIVE", 0.99)
        self.slo_targets: dict[str, float] = parse_slo_targets(
            os.environ.get("NORNICDB_TELEMETRY_SLO_TARGETS",
                           "embed=250,search=250,generate=5000"))
        self._slo_windows: dict[str, deque[bool]] = {}
        self._shed_streaks: dict[tuple[str, str], int] = {}
        for route, target_s in self.slo_targets.items():
            SLO_TARGET.labels(route).set(target_s)
            SLO_BURN.labels(route)

    # -- configuration -----------------------------------------------------
    def configure(
        self,
        conservatism: Optional[float] = None,
        min_confidence: Optional[float] = None,
        predictive_admission: Optional[bool] = None,
        slo_targets=None,
        slo_objective: Optional[float] = None,
    ) -> None:
        with self._lock:
            if conservatism is not None:
                self.conservatism = max(1.0, float(conservatism))
            if min_confidence is not None:
                self.min_confidence = min(1.0, max(0.0,
                                                   float(min_confidence)))
            if predictive_admission is not None:
                self.predictive_admission = bool(predictive_admission)
            if slo_objective is not None:
                self.slo_objective = min(0.9999,
                                         max(0.5, float(slo_objective)))
            if slo_targets is not None:
                if isinstance(slo_targets, str):
                    slo_targets = parse_slo_targets(slo_targets)
                self.slo_targets = dict(slo_targets)
                for route, target_s in self.slo_targets.items():
                    SLO_TARGET.labels(route).set(target_s)
                    SLO_BURN.labels(route)

    # -- learning ----------------------------------------------------------
    def observe(self, subsystem: str, kind: str, shape: str,
                seconds: float) -> None:
        """Deviceprof time-observer entry point: score the standing
        prediction against the actual, then fold the sample in."""
        shape = str(shape)
        units = shape_units(shape)
        key = (subsystem, kind, shape)
        with self._lock:
            entry = self._classes.get(key)
            if entry is None:
                entry = self._classes[key] = _ClassEntry()
            ks = self._kinds.get((subsystem, kind))
            if ks is None:
                ks = self._kinds[(subsystem, kind)] = _KindStats()
            predicted, had_history = self._predict_locked(
                subsystem, kind, units, entry, ks)
            if had_history and seconds > 0:
                rel = abs(seconds - predicted) / seconds
                ks.rel_errs.append(rel)
            entry.fold(seconds)
            ks.fold(seconds, units)
        if had_history and seconds > 0:
            REL_ERR_HIST.labels(subsystem, kind).observe(rel)
            PREDICTED_SECONDS.labels(subsystem, kind).inc(predicted)
            ACTUAL_SECONDS.labels(subsystem, kind).inc(seconds)
        OBSERVATIONS.labels(subsystem, kind).inc()

    def _predict_locked(self, subsystem: str, kind: str,
                        units: Optional[int],
                        entry: Optional[_ClassEntry],
                        ks: Optional[_KindStats]) -> tuple[float, bool]:
        """-> (predicted seconds for ONE dispatch, had_history)."""
        if entry is not None and entry.n > 0:
            return entry.ewma_s, True
        if ks is not None and ks.n > 0:
            if units and ks.ewma_per_unit > 0.0:
                return ks.ewma_per_unit * units, True
            return ks.ewma_s, True
        return PRIORS.get((subsystem, kind), DEFAULT_PRIOR_S), False

    # -- prediction --------------------------------------------------------
    def predict(self, subsystem: str, kind: str,
                units: Optional[int] = None,
                shape: Optional[str] = None) -> tuple[float, float]:
        """Predicted seconds for one dispatch + confidence in [0, 1)."""
        with self._lock:
            entry = self._classes.get(
                (subsystem, kind, str(shape))) if shape else None
            ks = self._kinds.get((subsystem, kind))
            predicted, _ = self._predict_locked(subsystem, kind, units,
                                                entry, ks)
            if entry is not None and entry.n > 0:
                conf = entry.confidence
            elif ks is not None and ks.n > 0:
                conf = ks.confidence
            else:
                conf = 0.0
        return predicted, conf

    def per_unit(self, subsystem: str, kind: str) -> float:
        """Learned seconds per work unit (0.0 while cold)."""
        with self._lock:
            ks = self._kinds.get((subsystem, kind))
            return ks.ewma_per_unit if ks is not None else 0.0

    def median_rel_error(self, subsystem: str,
                         kind: str) -> Optional[float]:
        """Median of the recent relative errors for a kind (None while
        the model has no scored history) — the accuracy contract the
        tests assert."""
        with self._lock:
            ks = self._kinds.get((subsystem, kind))
            if ks is None or not ks.rel_errs:
                return None
            errs = sorted(ks.rel_errs)
        mid = len(errs) // 2
        if len(errs) % 2:
            return errs[mid]
        return 0.5 * (errs[mid - 1] + errs[mid])

    # -- predictive admission ----------------------------------------------
    def decide(self, route: str, subsystem: str, kind: str,
               units: Optional[int], slack_s: float,
               units_ahead: float = 0.0,
               dispatches_ahead: float = 0.0,
               idle: bool = False) -> Decision:
        """Shed-at-submit verdict for one request.

        ``slack_s`` is the remaining deadline budget (<= 0 means no
        deadline: always admit).  ``units_ahead`` / ``dispatches_ahead``
        describe the backlog already queued in front of this request —
        the queue-aware term that makes overload shed *early* instead of
        after the queue has already burned the deadline.

        ``idle`` says the backend has nothing queued and nothing in
        flight: a would-be shed is then admitted as a probe, since it
        waits behind no one and a shed would protect no one, and its
        dispatch refreshes an estimate learned under another load (an
        EWMA taught by a contended burst would otherwise turn away the
        first requests to an idle engine).

        Decisions: ``admit`` / ``shed`` / ``fail_open`` (confidence too
        low to act on) / ``probe`` (half-open admission after
        ``PROBE_EVERY`` consecutive sheds, or on an idle backend,
        keeping observations flowing so an inflated EWMA can recover)."""
        if slack_s <= 0 or not self.predictive_admission:
            return Decision(True, "admit", 0.0, 0.0, slack_s)
        predicted_own, conf = self.predict(subsystem, kind, units)
        with self._lock:
            ks = self._kinds.get((subsystem, kind))
            per_unit = ks.ewma_per_unit if ks is not None else 0.0
            per_dispatch = ks.ewma_s if ks is not None else 0.0
            conservatism = self.conservatism
            min_conf = self.min_confidence
        predicted_wait = (per_unit * max(units_ahead, 0.0)
                          + per_dispatch * max(dispatches_ahead, 0.0))
        predicted = predicted_own + predicted_wait
        if conf < min_conf:
            ADMISSIONS.labels(route, "fail_open").inc()
            return Decision(True, "fail_open", predicted, conf, slack_s)
        if predicted * conservatism > slack_s:
            # half-open probe (see PROBE_EVERY): every Nth consecutive
            # would-shed is admitted so the route keeps producing
            # observations and an inflated EWMA can decay back down
            with self._lock:
                streak = self._shed_streaks.get((subsystem, kind), 0) + 1
                probe = idle or streak >= PROBE_EVERY
                self._shed_streaks[(subsystem, kind)] = 0 if probe else streak
            if probe:
                ADMISSIONS.labels(route, "probe").inc()
                return Decision(True, "probe", predicted, conf, slack_s)
            ADMISSIONS.labels(route, "shed").inc()
            return Decision(False, "shed", predicted, conf, slack_s)
        with self._lock:
            self._shed_streaks.pop((subsystem, kind), None)
        ADMISSIONS.labels(route, "admit").inc()
        return Decision(True, "admit", predicted, conf, slack_s)

    # -- SLO burn ----------------------------------------------------------
    def record_latency(self, route: str, seconds: float) -> None:
        """Feed one completed request's end-to-end latency into the
        route's SLO window (routes without a configured target are
        ignored — no unbounded label growth)."""
        with self._lock:
            target = self.slo_targets.get(route)
            if target is None:
                return
            window = self._slo_windows.get(route)
            if window is None:
                window = self._slo_windows[route] = deque(
                    maxlen=SLO_WINDOW)
            window.append(seconds > target)

    def refresh_gauges(self) -> None:
        """Collect-hook: derive the confidence + SLO burn gauges at
        scrape time (cheap: a few dict walks, no allocation-heavy
        work)."""
        with self._lock:
            kinds = list(self._kinds.items())
            budget = max(1e-6, 1.0 - self.slo_objective)
            windows = {r: (sum(w), len(w))
                       for r, w in self._slo_windows.items()}
            targets = dict(self.slo_targets)
        for (subsystem, kind), ks in kinds:
            CONFIDENCE.labels(subsystem, kind).set(ks.confidence)
        for route in targets:
            misses, n = windows.get(route, (0, 0))
            burn = (misses / n) / budget if n else 0.0
            SLO_BURN.labels(route).set(burn)

    # -- capacity ----------------------------------------------------------
    def capacity_snapshot(self) -> dict:
        """The /admin/capacity payload: cost table + headroom."""
        with self._lock:
            programs = [
                {
                    "subsystem": k[0], "kind": k[1], "shape": k[2],
                    "ewma_seconds": round(e.ewma_s, 9),
                    "observations": e.n,
                    "confidence": round(e.confidence, 4),
                }
                for k, e in sorted(self._classes.items())
            ]
            headroom = {}
            for (subsystem, kind), ks in sorted(self._kinds.items()):
                qps = 1.0 / ks.ewma_s if ks.ewma_s > 0 else None
                headroom[f"{subsystem}.{kind}"] = {
                    "ewma_seconds_per_dispatch": round(ks.ewma_s, 9),
                    "seconds_per_unit": round(ks.ewma_per_unit, 12),
                    "max_sustainable_qps":
                        round(qps, 3) if qps is not None else None,
                    "confidence": round(ks.confidence, 4),
                    "observations": ks.n,
                }
            slo = {
                "objective": self.slo_objective,
                "targets_s": dict(self.slo_targets),
                "windows": {
                    r: {"samples": len(w), "misses": sum(w)}
                    for r, w in sorted(self._slo_windows.items())
                },
            }
            knobs = {
                "conservatism": self.conservatism,
                "min_confidence": self.min_confidence,
                "predictive_admission": self.predictive_admission,
            }
        for entry in programs:
            med = self.median_rel_error(entry["subsystem"],
                                        entry["kind"])
            entry["median_rel_error"] = (round(med, 4)
                                         if med is not None else None)
        return {
            "programs": programs,
            "headroom": headroom,
            "slo": slo,
            "admission": knobs,
        }

    def reset(self) -> None:
        """Test helper: drop all learned state (metrics cells persist —
        counters are monotonic by contract)."""
        with self._lock:
            self._classes.clear()
            self._kinds.clear()
            self._slo_windows.clear()
            self._shed_streaks.clear()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def parse_slo_targets(spec) -> dict[str, float]:
    """``"embed=250,search=250"`` (ms) -> ``{"embed": 0.25, ...}``.
    Dicts pass through with values interpreted as SECONDS."""
    if isinstance(spec, dict):
        return {str(k): float(v) for k, v in spec.items()}
    out: dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        route, _, raw = part.partition("=")
        try:
            out[route.strip()] = float(raw) / 1000.0
        except ValueError:
            continue
    return out


# -- build info --------------------------------------------------------------
_build_state = {"cell": None, "backend": None}
_build_lock = threading.Lock()


def _refresh_build_info() -> None:
    """Resolve the build-identity labels lazily at scrape time. The backend
    is read from torch: ``cuda`` with ``torch.cuda.device_count()`` once
    CUDA is initialized in this process, ``cpu`` (one host device)
    otherwise; the probe never initializes CUDA itself. When the backend
    changes the cell is re-resolved (the stale cell drops to 0, info-gauge
    semantics)."""
    backend, devices = "cpu", 1
    try:
        import torch

        if torch.cuda.is_initialized():
            backend, devices = "cuda", int(torch.cuda.device_count())
    except Exception:
        log.debug("torch backend identity probe failed", exc_info=True)
        backend, devices = "error", 0
    import nornicdb_tpu_torch

    version = getattr(nornicdb_tpu_torch, "__version__", "dev")
    with _build_lock:  # concurrent scrapes race the cell swap
        if _build_state["backend"] == backend and _build_state["cell"]:
            return
        old = _build_state["cell"]
        if old is not None:
            old.set(0.0)
        cell = BUILD_INFO.labels(version, backend, devices)
        cell.set(1.0)
        _build_state["cell"] = cell
        _build_state["backend"] = backend


#: process-global cost model, learning from the deviceprof ledger
COST_MODEL = CostModel()
_deviceprof.PROFILER.add_time_observer(COST_MODEL.observe)
_REGISTRY.collect_hook("costmodel", COST_MODEL.refresh_gauges)
_REGISTRY.collect_hook("build_info", _refresh_build_info)

observe = COST_MODEL.observe
predict = COST_MODEL.predict
decide = COST_MODEL.decide
record_latency = COST_MODEL.record_latency
capacity_snapshot = COST_MODEL.capacity_snapshot
