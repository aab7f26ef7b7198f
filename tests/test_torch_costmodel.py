"""Closed-loop capacity tests of the port's cost model
(``nornicdb_tpu_torch/telemetry/costmodel.py``, ``budget.py``): the cases of
``tests/test_costmodel.py`` against the port. Learning and the accuracy
contract (median relative error under 30% after warmup, through the
port's deviceprof ledger), predictive admission, the SLO burn gauges, the
capacity snapshot, the deadline-budget attribution, the rendered
families and the ``/admin/capacity`` endpoint of the port's HTTP server.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.server.http import HttpServer

from nornicdb_tpu_torch.telemetry import budget, configure
from nornicdb_tpu_torch.telemetry.costmodel import (
    COST_MODEL,
    CostModel,
    PRIORS,
    parse_slo_targets,
    shape_units,
)
from nornicdb_tpu_torch.telemetry.deviceprof import PROFILER
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY


@pytest.fixture
def model():
    m = CostModel()
    yield m


# ------------------------------------------------------------ learning


class TestLearning:
    def test_cold_model_predicts_prior_with_zero_confidence(self, model):
        predicted, conf = model.predict("serving", "embed")
        assert predicted == PRIORS[("serving", "embed")]
        assert conf == 0.0

    def test_shape_class_ewma_converges(self, model):
        for _ in range(32):
            model.observe("search", "dense", "b8", 0.004)
        predicted, conf = model.predict("search", "dense", shape="b8")
        assert predicted == pytest.approx(0.004, rel=0.05)
        assert conf > 0.7

    def test_unseen_shape_scales_per_unit(self, model):
        # teach the kind at two sizes so the per-unit slope is learned,
        # then ask about a size never observed
        for _ in range(16):
            model.observe("serving", "embed", "t128", 0.001)
            model.observe("serving", "embed", "t512", 0.004)
        predicted, conf = model.predict("serving", "embed", units=1024)
        per_unit = model.per_unit("serving", "embed")
        assert per_unit > 0
        assert predicted == pytest.approx(per_unit * 1024)
        assert conf > 0.5

    def test_accuracy_median_rel_error_under_30pct_after_warmup(self):
        """End-to-end through the deviceprof ledger: a noisy-but-stable
        workload must warm the GLOBAL model to ≤30% median error."""
        rng = np.random.default_rng(20260807)
        COST_MODEL.reset()
        try:
            for _ in range(200):
                # ±10% jitter around stable per-shape costs
                PROFILER.record_execute(
                    "search", "dense", "b8",
                    0.004 * (1 + 0.1 * rng.standard_normal()))
                PROFILER.record_execute(
                    "serving", "embed", "t256",
                    0.010 * (1 + 0.1 * rng.standard_normal()))
            for sub, kind in (("search", "dense"), ("serving", "embed")):
                med = COST_MODEL.median_rel_error(sub, kind)
                assert med is not None and med <= 0.30, (
                    f"{sub}.{kind} median rel error {med}")
        finally:
            COST_MODEL.reset()

    def test_shape_units_parsing(self):
        assert shape_units("b64") == 64
        assert shape_units("t4096") == 4096
        assert shape_units("1024") == 1024
        assert shape_units("f8q32x512") == 32  # ragged chunk axis
        assert shape_units("full") is None


# ------------------------------------------------- predictive admission


class TestDecide:
    def _warm(self, model, seconds=0.01, n=32):
        for _ in range(n):
            model.observe("search", "dense", "b8", seconds)

    def test_no_deadline_always_admits(self, model):
        self._warm(model)
        d = model.decide("search", "search", "dense", None, slack_s=0.0)
        assert d.admit and d.decision == "admit"

    def test_cold_model_fails_open(self, model):
        d = model.decide("search", "search", "dense", None, slack_s=0.001)
        assert d.admit and d.decision == "fail_open"
        assert d.confidence < model.min_confidence

    def test_warm_model_sheds_past_deadline(self, model):
        self._warm(model, seconds=0.01)
        # 10ms dispatch × 1.5 conservatism > 5ms slack -> shed
        d = model.decide("search", "search", "dense", None, slack_s=0.005)
        assert not d.admit and d.decision == "shed"
        assert d.predicted_s == pytest.approx(0.01, rel=0.1)
        # plenty of slack -> admit
        assert model.decide("search", "search", "dense", None,
                            slack_s=1.0).admit

    def test_backlog_term_sheds_queued_overload(self, model):
        self._warm(model, seconds=0.01)
        # own dispatch fits, but 20 dispatches queued ahead do not
        assert model.decide("search", "search", "dense", None,
                            slack_s=0.05).admit
        d = model.decide("search", "search", "dense", None,
                         slack_s=0.05, dispatches_ahead=20)
        assert not d.admit

    def test_conservatism_knob_widens_the_margin(self, model):
        self._warm(model, seconds=0.01)
        slack = 0.012  # fits at 1.0x, not at 1.5x
        model.configure(conservatism=1.0)
        assert model.decide("search", "search", "dense", None,
                            slack_s=slack).admit
        model.configure(conservatism=1.5)
        assert not model.decide("search", "search", "dense", None,
                                slack_s=slack).admit

    def test_half_open_probe_breaks_shed_starvation(self, model):
        from nornicdb_tpu_torch.telemetry.costmodel import PROBE_EVERY
        self._warm(model, seconds=10.0)  # hopelessly slow program
        decisions = [
            model.decide("search", "search", "dense", None, slack_s=0.005)
            for _ in range(2 * PROBE_EVERY)]
        probes = [d for d in decisions if d.decision == "probe"]
        assert len(probes) == 2 and all(d.admit for d in probes)
        assert sum(1 for d in decisions if d.decision == "shed") == (
            2 * PROBE_EVERY - 2)
        # every PROBE_EVERYth would-shed is the probe, deterministically
        assert decisions[PROBE_EVERY - 1].decision == "probe"
        # probe-admitted traffic re-teaches the model (the hang cleared):
        # the inflated EWMA decays and the route reopens
        for _ in range(32):
            model.observe("search", "dense", "b8", 0.001)
        assert model.decide("search", "search", "dense", None,
                            slack_s=0.005).decision == "admit"

    def test_admit_resets_probe_streak(self, model):
        from nornicdb_tpu_torch.telemetry.costmodel import PROBE_EVERY
        self._warm(model, seconds=0.01)
        for _ in range(PROBE_EVERY - 1):
            assert model.decide("search", "search", "dense", None,
                                slack_s=0.005).decision == "shed"
        # a clean admit in between clears the consecutive-shed streak
        assert model.decide("search", "search", "dense", None,
                            slack_s=1.0).decision == "admit"
        assert model.decide("search", "search", "dense", None,
                            slack_s=0.005).decision == "shed"

    def test_idle_backend_probes_a_would_be_shed(self, model):
        """An idle backend (nothing queued or in flight) admits what the
        model would shed, as a probe, and the streak starts again."""
        self._warm(model, seconds=10.0)  # a contended burst's estimate
        assert model.decide("search", "search", "dense", None,
                            slack_s=0.005).decision == "shed"
        d = model.decide("search", "search", "dense", None, slack_s=0.005,
                         idle=True)
        assert d.admit and d.decision == "probe"
        assert d.predicted_s == pytest.approx(10.0, rel=0.01)
        assert model._shed_streaks[("search", "dense")] == 0
        # busy again: the same request sheds
        assert not model.decide("search", "search", "dense", None,
                                slack_s=0.005).admit
        # an idle request that fits is a plain admit
        assert model.decide("search", "search", "dense", None, slack_s=100.0,
                            idle=True).decision == "admit"

    def test_predictive_admission_off_admits_everything(self, model):
        self._warm(model, seconds=10.0)
        model.configure(predictive_admission=False)
        d = model.decide("search", "search", "dense", None, slack_s=0.001)
        assert d.admit and d.decision == "admit"


# ------------------------------------------------------ SLO + snapshot


class TestSloAndSnapshot:
    def test_parse_slo_targets(self):
        assert parse_slo_targets("embed=250,search=100") == {
            "embed": 0.25, "search": 0.1}

    def test_burn_rate_gauge_tracks_miss_fraction(self, model):
        model.configure(slo_targets={"search": 0.01}, slo_objective=0.99)
        for _ in range(90):
            model.record_latency("search", 0.001)   # hits
        for _ in range(10):
            model.record_latency("search", 0.1)     # misses
        model.refresh_gauges()
        from nornicdb_tpu_torch.telemetry.costmodel import SLO_BURN
        # 10% misses / 1% budget = burn 10
        assert SLO_BURN.labels("search").get() == pytest.approx(10.0)
        # unconfigured routes are ignored (no unbounded label growth)
        model.record_latency("nosuchroute", 1.0)

    def test_capacity_snapshot_structure(self, model):
        for _ in range(16):
            model.observe("search", "dense", "b8", 0.004)
        snap = model.capacity_snapshot()
        (entry,) = snap["programs"]
        assert entry["subsystem"] == "search" and entry["shape"] == "b8"
        assert entry["ewma_seconds"] == pytest.approx(0.004, rel=0.05)
        assert 0 < entry["confidence"] < 1
        hr = snap["headroom"]["search.dense"]
        assert hr["max_sustainable_qps"] == pytest.approx(250, rel=0.1)
        assert set(snap["admission"]) == {
            "conservatism", "min_confidence", "predictive_admission"}
        assert "objective" in snap["slo"]

    def test_configure_plumbing_reaches_global_model(self):
        before = (COST_MODEL.conservatism, COST_MODEL.min_confidence)
        try:
            configure(cost_conservatism=2.5, cost_min_confidence=0.5)
            assert COST_MODEL.conservatism == 2.5
            assert COST_MODEL.min_confidence == 0.5
        finally:
            COST_MODEL.configure(conservatism=before[0],
                                 min_confidence=before[1])


# ------------------------------------------------------ deadline budget


class TestBudget:
    def test_breakdown_joins_predictions_with_span_actuals(self):
        budget.open_budget("trace-bk", "generate", 3.0,
                           {"prefill": 0.040, "decode": 0.020})
        spans = [
            {"name": "genserve.prefill", "duration_ms": 40.5},
            {"name": "genserve.prefill", "duration_ms": 39.5},
            {"name": "genserve.decode", "duration_ms": 25.0},
            {"name": "unmapped.span", "duration_ms": 999.0},
        ]
        bk = budget.breakdown_for("trace-bk", spans)
        assert bk["route"] == "generate"
        assert bk["deadline_budget_ms"] == 3000.0
        by_stage = {s["stage"]: s for s in bk["stages"]}
        assert by_stage["prefill"]["predicted_ms"] == 40.0
        assert by_stage["prefill"]["actual_ms"] == 80.0
        assert by_stage["prefill"]["spans"] == 2
        assert by_stage["decode"]["actual_ms"] == 25.0
        # unmapped spans don't invent stages
        assert set(by_stage) == {"prefill", "decode"}
        assert bk["actual_total_ms"] == pytest.approx(105.0)

    def test_breakdown_none_without_budget_or_mapped_spans(self):
        assert budget.breakdown_for("no-such-trace", []) is None
        assert budget.breakdown_for(
            "no-such-trace",
            [{"name": "unmapped", "duration_ms": 1.0}]) is None

    def test_spans_alone_still_attribute(self):
        bk = budget.breakdown_for(
            "never-opened",
            [{"name": "search.batch", "duration_ms": 3.0}])
        assert bk["stages"][0]["stage"] == "device_sync"
        assert bk["stages"][0]["predicted_ms"] is None
        assert "route" not in bk

    def test_ledger_lru_bounded(self):
        from nornicdb_tpu_torch.telemetry.budget import BudgetLedger
        led = BudgetLedger(capacity=4)
        for i in range(8):
            led.open(f"t{i}", "search", 1.0, {})
        assert led.get("t0") is None and led.get("t7") is not None


# -------------------------------------------------------- live surface


class TestLiveSurface:
    @pytest.fixture
    def server(self, tmp_path):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        db.set_embedder(HashEmbedder(32))
        srv = HttpServer(db, port=0)
        srv.start()
        yield srv
        srv.stop()
        db.close()

    def _get(self, port, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())

    def test_admin_capacity_endpoint(self, server):
        status, cap = self._get(server.port, "/admin/capacity")
        assert status == 200
        assert set(cap) >= {"programs", "headroom", "slo", "admission"}
        assert cap["slo"]["targets_s"]  # defaults configured at boot

    def test_build_info_renders_one_live_cell(self):
        text = REGISTRY.render_prometheus()
        lines = [l for l in text.splitlines()
                 if l.startswith("nornicdb_build_info{")]
        live = [l for l in lines if l.endswith(" 1")]
        assert len(live) == 1
        assert 'version="' in live[0] and 'backend="' in live[0]
        assert 'mesh_devices="' in live[0]

    def test_cost_model_families_render(self):
        text = REGISTRY.render_prometheus()
        for family in (
            "nornicdb_cost_model_predicted_seconds_total",
            "nornicdb_cost_model_actual_seconds_total",
            "nornicdb_cost_model_observations_total",
            "nornicdb_cost_model_relative_error",
            "nornicdb_cost_model_confidence",
            "nornicdb_cost_model_admission_total",
            "nornicdb_slo_burn_rate",
            "nornicdb_slo_target_seconds",
        ):
            assert f"# TYPE {family}" in text, family


# ------------------------------------------------------ against the JAX one


class TestParity:
    def test_same_stream_same_predictions_and_decisions(self):
        from nornicdb_tpu.telemetry.costmodel import CostModel as JaxCostModel

        rng = np.random.default_rng(7)
        port, ref = CostModel(), JaxCostModel()
        for _ in range(64):
            shape = f"t{int(2 ** rng.integers(6, 12))}"
            secs = float(rng.uniform(0.001, 0.02))
            port.observe("serving", "embed", shape, secs)
            ref.observe("serving", "embed", shape, secs)
        for units in (None, 64, 1000, 4096):
            assert port.predict("serving", "embed", units) == ref.predict(
                "serving", "embed", units)
        for slack in (0.001, 0.01, 0.05, 1.0):
            got = port.decide("embed", "serving", "embed", 512, slack,
                              units_ahead=2048)
            want = ref.decide("embed", "serving", "embed", 512, slack,
                              units_ahead=2048)
            assert (got.admit, got.decision, got.predicted_s,
                    got.confidence) == (want.admit, want.decision,
                                        want.predicted_s, want.confidence)
        assert port.capacity_snapshot() == ref.capacity_snapshot()
