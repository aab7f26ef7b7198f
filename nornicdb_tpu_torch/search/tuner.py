"""Recall-governed IVF autotuning (counterpart of
``nornicdb_tpu/search/tuner.py``): operators set a recall floor, the tuner
spends FLOPs against it.

``n_probe`` is a speed knob whose recall cost is invisible until someone
measures it. So operators configure ``SearchConfig.recall_target``
(default 0.95) and the tuner, run at recluster time and again when drift
tracking trips, measures recall@k of the fitted IVF layout against exact
float32 ground truth on held-out corpus rows and picks the smallest
``n_probe`` meeting the floor. A layout that cannot meet the floor is not
served: the tune records ``outcome="floor_unmet"`` and the service keeps
the full scan.

Cost model: probing P of K clusters scores ~P/K of the corpus, so the
ladder walks n_probe geometrically and stops at the first value whose
measured recall clears the floor, verified on a second independent sample.

Outcomes are counted in ``nornicdb_ivf_tunes_total{outcome}`` and the
served plan is published in ``nornicdb_ivf_measured_recall``,
``nornicdb_ivf_n_probe`` and ``nornicdb_ivf_local_k``, the JAX package's
families. Deferred: the sharded corpus's ``local_k`` ladder (with the mesh
slice); until then ``nornicdb_ivf_local_k`` reads 0 (the default width).
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass, field

import numpy as np

from nornicdb_tpu_torch.errors import DeviceUnavailable
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.ops.host_search import host_topk

logger = logging.getLogger(__name__)

TUNE_OUTCOMES = (
    "ok",            # floor met: n_probe installed for serving
    "floor_unmet",   # no n_probe met the floor: serve the full scan
    "degraded",      # no device: nothing to tune, the full scan serves
    "no_layout",     # no fitted IVF layout (or epoch-invalidated mid-fit)
    "stale",         # corpus layout epoch moved mid-tune: result discarded
    "too_small",     # corpus under tune_min_rows: the full scan is the
                     # right plan at this size
    "error",         # tune crashed; the full scan serves
)

_TUNES = _REGISTRY.counter(
    "nornicdb_ivf_tunes_total",
    "Recall-governed IVF tunes by outcome (outcome!=ok serves full scan)",
    labels=("outcome",),
)
for _o in TUNE_OUTCOMES:
    _TUNES.labels(_o)
_MEASURED_RECALL = _REGISTRY.gauge(
    "nornicdb_ivf_measured_recall",
    "Recall@k of the served IVF configuration, measured against exact "
    "f32 ground truth on the held-out corpus-row sample at tune time",
)
_ACTIVE_NPROBE = _REGISTRY.gauge(
    "nornicdb_ivf_n_probe",
    "n_probe the tuner picked for serving (0 = full scan)",
)
_ACTIVE_LOCALK = _REGISTRY.gauge(
    "nornicdb_ivf_local_k",
    "Per-shard candidate width the tuner picked (0 = default k)",
)


def count_tune_outcome(outcome: str) -> None:
    """Bump the outcome counter for tunes decided OUTSIDE IVFTuner.tune
    (the service's too_small short-circuit), so the metric family stays
    the single source of tune-outcome truth."""
    _TUNES.labels(outcome).inc()


def publish_plan(state) -> None:
    """Point the serving-plan gauges at what is ACTUALLY being served.

    Called by the service after its keep-or-replace decision, never by
    tune() itself, which only measures. ``state`` may be None (no plan:
    the full scan). The single-device plan has no local_k: its gauge
    reads 0."""
    if state is not None and state.serving_pruned:
        _MEASURED_RECALL.set(state.measured_recall)
        _ACTIVE_NPROBE.set(float(state.n_probe))
    else:
        _MEASURED_RECALL.set(0.0)
        _ACTIVE_NPROBE.set(0.0)
    _ACTIVE_LOCALK.set(0.0)


@dataclass
class TuneState:
    """One tune's verdict: the serving plan plus its evidence."""

    outcome: str
    n_probe: int = 0
    measured_recall: float = 0.0
    recall_target: float = 0.95
    k: int = 0
    sample: int = 0
    clusters: int = 0          # K of the tuned layout
    flop_fraction: float = 1.0  # ~n_probe/K of a full scan (1.0 = full)
    layout_epoch: int = -1
    corpus_rows: int = 0
    ladder_evals: int = 0      # n_probe values measured
    tune_seconds: float = 0.0
    detail: str = ""

    def as_dict(self) -> dict:
        return asdict(self)

    @property
    def serving_pruned(self) -> bool:
        return self.outcome == "ok" and self.n_probe > 0


def _probe_ladder(k_clusters: int) -> list[int]:
    """Geometric n_probe candidates, 1..K (K last: probing every cluster
    is the layout's own upper recall bound)."""
    ladder = []
    p = 1
    while p < k_clusters:
        ladder.append(p)
        p *= 2
    ladder.append(k_clusters)
    return ladder


def _recall(got: list[list[tuple[str, float]]], truth: list[set]) -> float:
    vals = []
    for row, want in zip(got, truth):
        if not want:
            continue
        vals.append(len({i for i, _ in row} & want) / len(want))
    return float(np.mean(vals)) if vals else 1.0


@dataclass
class IVFTuner:
    """Measure-and-pick autotuner over a fitted DeviceCorpus. Stateless
    between calls: the service owns the returned TuneState and the drift
    bookkeeping."""

    recall_target: float = 0.95
    sample: int = 64
    k: int = 100
    seed: int = 7
    # verify each passing candidate on a SECOND, independent held-out
    # sample before serving it, so a value that over-fits the tune sample's
    # cluster geometry keeps the ladder climbing
    verify: bool = True
    rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    @staticmethod
    def _layout_of(corpus):
        """(layout, epoch_ok); layout is None when nothing is fitted."""
        layout = getattr(corpus, "_ivf", None)
        if layout is None:
            return None, False
        return layout, layout.epoch == corpus._layout_epoch

    def tune(self, corpus, k: int = 0) -> TuneState:
        """Measure recall@k of the corpus's fitted IVF layout against exact
        ground truth and return the smallest passing n_probe. Never raises:
        every failure is an outcome the caller serves around (the full scan
        is always a correct plan)."""
        t0 = time.perf_counter()
        k = int(k) if k > 0 else self.k
        try:
            state = self._tune_inner(corpus, k)
        except Exception as e:  # noqa: BLE001 - a tune must never take
            # serving down; the fallback plan (full scan) is always correct
            logger.exception("IVF tune failed")
            state = TuneState(outcome="error", recall_target=self.recall_target,
                              k=k, detail=str(e)[:200])
        state.tune_seconds = time.perf_counter() - t0
        _TUNES.labels(state.outcome).inc()
        # the serving-plan gauges are published by the OWNER of the plan
        # (SearchService._install_tune, after its keep-or-replace decision)
        logger.info(
            "IVF tune: outcome=%s n_probe=%d recall=%.4f target=%.2f k=%d "
            "clusters=%d evals=%d (%.2fs) %s",
            state.outcome, state.n_probe, state.measured_recall,
            state.recall_target, state.k, state.clusters, state.ladder_evals,
            state.tune_seconds, state.detail,
        )
        return state

    def _tune_inner(self, corpus, k: int) -> TuneState:
        base = TuneState(outcome="error", recall_target=self.recall_target,
                         k=k, corpus_rows=len(corpus))
        try:
            corpus.device_gate()
        except DeviceUnavailable:
            base.outcome = "degraded"
            return base
        layout, epoch_ok = self._layout_of(corpus)
        if layout is None or not epoch_ok:
            base.outcome = "no_layout"
            return base
        base.clusters = int(layout.k)
        epoch_at_start = corpus._layout_epoch

        # held-out query samples: the corpus rows themselves, snapshotted
        # under the sync lock so a racing overwrite cannot tear one. The
        # ladder measures against the first draw; a passing value must
        # ALSO pass the second before it serves.
        with corpus._sync_lock:
            live = np.nonzero(corpus._valid)[0]
            if live.size == 0:
                base.outcome = "no_layout"
                return base
            n_sample = int(min(self.sample, live.size))
            n_draw = int(min(2 * n_sample, live.size))
            pick = self.rng.choice(live, size=n_draw, replace=False)
            queries = corpus._host[pick[:n_sample]].copy()
            vqueries = (corpus._host[pick[n_sample:]].copy()
                        if self.verify and n_draw > n_sample else None)
            host, valid, ids = corpus._host, corpus._valid, corpus._ids
        base.sample = n_sample
        kk = min(k, int(live.size))
        base.k = kk

        # exact f32 ground truth over the host mirror (unlocked reads are
        # measurement-grade: a row mutated mid-scan skews one membership
        # test, not the plan)
        def _truth_for(qs):
            _, t_idx = host_topk(qs, host, valid, kk)
            return [{ids[i] for i in row
                     if 0 <= i < len(ids) and ids[i] is not None}
                    for row in t_idx]

        truth = _truth_for(queries)
        vtruth = _truth_for(vqueries) if vqueries is not None else None

        best_recall, best = -1.0, 0
        evals = 0
        for n_probe in _probe_ladder(base.clusters):
            got = corpus.search(queries, k=kk, n_probe=n_probe)
            evals += 1
            eff = _recall(got, truth)
            if eff >= self.recall_target and vtruth is not None:
                vgot = corpus.search(vqueries, k=kk, n_probe=n_probe)
                evals += 1
                eff = min(eff, _recall(vgot, vtruth))
            if eff > best_recall:
                best_recall, best = eff, n_probe
            if eff < self.recall_target:
                continue
            if corpus._layout_epoch != epoch_at_start:
                base.outcome = "stale"
                base.ladder_evals = evals
                return base
            base.outcome = "ok"
            base.n_probe = n_probe
            base.measured_recall = eff
            base.flop_fraction = round(n_probe / max(base.clusters, 1), 4)
            base.layout_epoch = epoch_at_start
            base.ladder_evals = evals
            return base
        # nothing met the floor: serve the full scan and say so, never a
        # layout that silently under-recalls
        base.outcome = "floor_unmet"
        base.n_probe = best
        base.measured_recall = best_recall
        base.ladder_evals = evals
        base.detail = (f"best recall {best_recall:.4f} at n_probe={best} "
                       f"< target {self.recall_target}")
        return base
