"""The port's Kalman filters (``nornicdb_tpu_torch/filter``) and the
``kalman.*`` Cypher functions on the CPU: the cases of
``tests/test_learning.py::TestKalman``, its ``test_kalman_functions`` and
``tests/test_round4_breadth.py::TestKalmanFamilies`` run against the port,
unchanged but for their imports; then both packages over one seeded
series, held equal bit for bit (host float64 arithmetic in both)."""

import json

import numpy as np
import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.errors import NornicError
from nornicdb_tpu_torch.filter import (
    AdaptiveKalman,
    Kalman,
    KalmanConfig,
    VelocityKalman,
)
from nornicdb_tpu_torch.storage import MemoryEngine


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


class TestKalman:
    def test_converges_to_constant(self):
        k = Kalman(KalmanConfig(process_noise=1e-5, measurement_noise=0.5))
        for _ in range(100):
            est = k.process(10.0)
        assert est == pytest.approx(10.0, abs=0.01)

    def test_smooths_noise(self):
        rng = np.random.default_rng(0)
        k = Kalman(KalmanConfig(process_noise=1e-4, measurement_noise=1.0))
        ests = [k.process(5.0 + rng.normal(0, 1)) for _ in range(200)]
        assert abs(np.mean(ests[-50:]) - 5.0) < 0.3
        assert np.std(ests[-50:]) < 0.3  # much less than measurement noise

    def test_uncertainty_decreases(self):
        k = Kalman()
        k.process(1.0)
        _, u1 = k.predict_with_uncertainty()
        for _ in range(20):
            k.process(1.0)
        _, u2 = k.predict_with_uncertainty()
        assert u2 < u1

    def test_velocity_tracks_trend(self):
        k = VelocityKalman(KalmanConfig(process_noise=1e-3, measurement_noise=0.1))
        for t in range(50):
            k.process(2.0 * t, float(t))
        assert k.velocity == pytest.approx(2.0, abs=0.2)
        assert k.predict_at(60.0) == pytest.approx(120.0, abs=3.0)

    def test_adaptive_r_grows_with_noise(self):
        ak = AdaptiveKalman(KalmanConfig(measurement_noise=0.01), alpha=0.5)
        rng = np.random.default_rng(1)
        for _ in range(100):
            ak.process(rng.normal(0, 5.0))
        assert ak.config.measurement_noise > 0.01

    def test_reset(self):
        k = Kalman()
        k.process(9.0)
        k.reset()
        assert not k.initialized and k.updates == 0


def test_kalman_functions():
    ex = CypherExecutor(MemoryEngine())
    r = ex.execute(
        "UNWIND [10.0, 10.0, 10.0] AS m "
        "RETURN kalman.filter('test-k', m) AS est"
    )
    assert r.rows[-1][0] == pytest.approx(10.0, abs=0.5)
    r = ex.execute("RETURN kalman.smooth([1.0, 1.0, 1.0]) AS s")
    assert len(r.rows[0][0]) == 3
    ex.execute("RETURN kalman.reset('test-k')")


@pytest.fixture
def db():
    d = nornicdb_tpu_torch.open_db("", device="cpu")
    yield d
    d.close()


class TestKalmanFamilies:
    def test_scalar_state_roundtrip(self, db):
        st = db.cypher("RETURN kalman.init()").rows[0][0]
        out = db.cypher("RETURN kalman.process(100.0, $s)",
                        {"s": st}).rows[0][0]
        assert out["value"] == 100.0  # first measurement seeds the filter
        st2 = out["state"]
        out2 = db.cypher("RETURN kalman.process(0.0, $s)",
                         {"s": st2}).rows[0][0]
        assert 0.0 < out2["value"] < 100.0  # smoothed, not raw

    def test_predict_from_state_json(self, db):
        st = db.cypher("RETURN kalman.init()").rows[0][0]
        for v in (10, 20, 30, 40, 50):
            st = db.cypher("RETURN kalman.process($v, $s)",
                           {"v": float(v), "s": st}).rows[0][0]["state"]
        pred = db.cypher("RETURN kalman.predict($s, 3)",
                         {"s": st}).rows[0][0]
        assert 10.0 <= pred <= 70.0  # reference's plausibility window

    def test_velocity_tracks_trend(self, db):
        st = db.cypher("RETURN kalman.velocity.init()").rows[0][0]
        out = None
        for v in (10, 20, 30, 40):
            out = db.cypher("RETURN kalman.velocity.process($v, $s)",
                            {"v": float(v), "s": st}).rows[0][0]
            st = out["state"]
        assert out["velocity"] > 0
        pred = db.cypher("RETURN kalman.velocity.predict($s, 2)",
                         {"s": st}).rows[0][0]
        assert pred > out["value"]

    def test_adaptive_reseeds_on_level_shift(self, db):
        st = db.cypher("RETURN kalman.adaptive.init({hysteresis: 2})"
                       ).rows[0][0]
        for v in (10.0, 10.0, 10.0):
            st = db.cypher("RETURN kalman.adaptive.process($v, $s)",
                           {"v": v, "s": st}).rows[0][0]["state"]
        # two consecutive large innovations re-seed onto the new level
        for v in (500.0, 500.0):
            out = db.cypher("RETURN kalman.adaptive.process($v, $s)",
                            {"v": v, "s": st}).rows[0][0]
            st = out["state"]
        assert out["value"] == 500.0

    def test_malformed_state_is_clean_error(self, db):
        for q in ("RETURN kalman.process(1.0, 'junk')",
                  "RETURN kalman.state('junk')",
                  "RETURN kalman.velocity.predict('junk', 2)"):
            with pytest.raises(NornicError):
                db.cypher(q)


# -- both packages on one seeded series ---------------------------------------

def _series(seed=7, n=64):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    return [float(v) for v in 3.0 * t + 20.0 * np.sin(t / 5.0)
            + rng.normal(0.0, 4.0, n)]


class TestBothPackages:
    @pytest.mark.parametrize("kind", ["scalar", "velocity", "adaptive"])
    def test_filters_equal(self, kind):
        import nornicdb_tpu.filter as jf
        import nornicdb_tpu_torch.filter as pf

        series = _series()
        outs = []
        for mod in (jf, pf):
            cfg = mod.KalmanConfig(process_noise=1e-3, measurement_noise=2.0)
            if kind == "scalar":
                k = mod.Kalman(cfg)
                got = [k.process(v) for v in series]
                got.append(k.predict_with_uncertainty())
            elif kind == "velocity":
                k = mod.VelocityKalman(cfg)
                got = [k.process(v, float(i)) for i, v in enumerate(series)]
                got += [k.velocity, k.predict_at(80.0)]
            else:
                k = mod.AdaptiveKalman(cfg, alpha=0.3)
                got = [k.process(v) for v in series]
                got.append(k.config.measurement_noise)
            outs.append(got)
        assert outs[0] == outs[1]

    def test_cypher_functions_equal(self):
        series = _series(seed=11, n=32)
        steps = [
            ("RETURN kalman.init({measurementNoise: 5.0, processNoise: 2.0})",
             {}),
            ("UNWIND $xs AS m RETURN kalman.filter('s', m) AS est",
             {"xs": series}),
            ("RETURN kalman.predict('s', 4) AS p", {}),
            ("RETURN kalman.smooth($xs) AS s", {"xs": series}),
            ("RETURN kalman.velocity.init() AS s", {}),
            ("RETURN kalman.adaptive.init({hysteresis: 3}) AS s", {}),
            ("RETURN kalman.reset('s') AS r", {}),
        ]
        outs = []
        for pkg, kw in ((nornicdb_tpu, {}), (nornicdb_tpu_torch,
                                              {"device": "cpu"})):
            d = pkg.open_db("", **kw)
            try:
                got = [d.cypher(q, p).rows for q, p in steps]
                # the state-carrying families, step by step
                for fam in ("", "velocity.", "adaptive."):
                    st = d.cypher(f"RETURN kalman.{fam}init()").rows[0][0]
                    for v in series:
                        out = d.cypher(f"RETURN kalman.{fam}process($v, $s)",
                                       {"v": v, "s": st}).rows[0][0]
                        st = out["state"]
                        got.append(out)
                    got.append(json.loads(st))
                outs.append(got)
            finally:
                d.close()
        assert outs[0] == outs[1]
