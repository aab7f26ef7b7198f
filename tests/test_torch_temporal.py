"""Port of pkg/temporal pattern_detector_test.go + relationship_evolution
_test.go: periodic/burst/trend pattern detection and edge-strength
evolution trends.

The port's copy of ``tests/test_temporal_patterns.py``: the JAX cases
with only their imports changed. Then both packages over one seeded access
stream (tracker, pattern detector, relationship evolution, decay
integration, query load: equal outputs), and ``DB.temporal`` fed by
``touch``.
"""

import time

import pytest

import nornicdb_tpu_torch

from nornicdb_tpu_torch.temporal import (
    PATTERN_BURST,
    PATTERN_DAILY,
    PATTERN_DECAYING,
    PATTERN_GROWING,
    PATTERN_WEEKLY,
    PatternDetector,
    PatternDetectorConfig,
    RelationshipConfig,
    RelationshipEvolution,
)

DAY = 86400.0
HOUR = 3600.0


class TestPatternDetector:
    def test_daily_pattern_at_peak_hour(self):
        """Accesses concentrated at 09:00 UTC across two weeks -> daily
        pattern with peak_hour 9."""
        pd = PatternDetector()
        base = 1_700_000_000 - (1_700_000_000 % DAY)  # midnight UTC
        for day in range(14):
            pd.record_access("n", base + day * DAY + 9 * HOUR)
        patterns = pd.detect_patterns("n")
        daily = next(p for p in patterns if p.type == PATTERN_DAILY)
        assert daily.peak_hour == 9
        assert daily.confidence > 0.9  # fully concentrated
        hour, _, conf = pd.peak_access_time("n")
        assert hour == 9 and conf > 0.9

    def test_uniform_access_no_daily_pattern(self):
        pd = PatternDetector()
        base = 1_700_000_000 - (1_700_000_000 % DAY)
        for i in range(48):  # every hour for two days: uniform
            pd.record_access("n", base + i * HOUR)
        assert not any(p.type == PATTERN_DAILY
                       for p in pd.detect_patterns("n"))

    def test_weekly_pattern(self):
        """Every Sunday for 8 weeks -> weekly pattern, peak_day 0."""
        pd = PatternDetector()
        # 1_700_000_000 is a Tuesday; find the next Sunday 10:00
        base = 1_700_000_000 - (1_700_000_000 % DAY)
        import datetime

        dt = datetime.datetime.fromtimestamp(base, datetime.timezone.utc)
        days_to_sunday = (6 - dt.weekday()) % 7
        sunday = base + days_to_sunday * DAY + 10 * HOUR
        for week in range(10):
            pd.record_access("n", sunday + week * 7 * DAY)
        weekly = next(p for p in pd.detect_patterns("n")
                      if p.type == PATTERN_WEEKLY)
        assert weekly.peak_day == 0  # Sunday=0 convention
        assert weekly.confidence > 0.9

    def test_burst_pattern(self):
        pd = PatternDetector()
        now = time.time()
        for i in range(12):
            pd.record_access("n", now - 30 + i * 2)  # 12 hits in 30s
        assert pd.has_pattern("n", PATTERN_BURST)

    def test_trend_patterns_from_velocity(self):
        """Trends report only ABOVE the sample gate (the reference's
        DetectPatterns returns nil below it, even with a velocity)."""
        pd = PatternDetector()
        assert not pd.detect_patterns("unknown", velocity=0.5)
        now = time.time()
        for i in range(12):
            pd.record_access("n", now - i * 7200)  # spread out: no burst
        assert pd.has_pattern("n", PATTERN_GROWING, velocity=0.5)
        assert pd.has_pattern("n", PATTERN_DECAYING, velocity=-0.5)

    def test_burst_expires_with_wall_clock(self):
        """A burst that ended long ago must stop being reported."""
        pd = PatternDetector()
        old = time.time() - 7 * DAY
        for i in range(12):
            pd.record_access("n", old + i * 2)
        assert not pd.has_pattern("n", PATTERN_BURST)

    def test_unknown_node_peak_sentinel(self):
        assert PatternDetector().peak_access_time("ghost") == (-1, -1, 0.0)

    def test_min_samples_gate(self):
        pd = PatternDetector(PatternDetectorConfig(min_samples_for_pattern=10))
        for i in range(5):
            pd.record_access("n", 1_700_000_000 + i * DAY)
        assert pd.detect_patterns("n") == []


class TestRelationshipEvolution:
    def test_strengthening_trend(self):
        re_ = RelationshipEvolution()
        t0 = 1_700_000_000.0
        for i in range(8):
            re_.update_weight("a", "b", 1.0 + i * 0.5, ts=t0 + i * 60)
        trend = re_.get_trend("a", "b")
        assert trend.direction == "strengthening"
        assert trend.velocity > 0
        assert trend.predicted_strength > trend.current_strength
        assert 0 < trend.confidence < 1

    def test_weakening_trend(self):
        re_ = RelationshipEvolution()
        t0 = 1_700_000_000.0
        for i in range(8):
            re_.update_weight("a", "b", 5.0 - i * 0.5, ts=t0 + i * 60)
        trend = re_.get_trend("a", "b")
        assert trend.direction == "weakening"
        assert trend.velocity < 0

    def test_unknown_below_min_observations(self):
        re_ = RelationshipEvolution(RelationshipConfig(
            min_observations_for_trend=5))
        re_.update_weight("a", "b", 1.0, ts=1_700_000_000.0)
        re_.update_weight("a", "b", 2.0, ts=1_700_000_060.0)
        assert re_.get_trend("a", "b").direction == "unknown"

    def test_undirected_key(self):
        re_ = RelationshipEvolution()
        re_.record_co_access("a", "b", ts=1_700_000_000.0)
        re_.record_co_access("b", "a", ts=1_700_000_060.0)
        assert re_.get_trend("a", "b").observation_count == 2

    def test_rankings(self):
        re_ = RelationshipEvolution()
        t0 = 1_700_000_000.0
        for i in range(6):
            re_.update_weight("up1", "x", 1.0 + i, ts=t0 + i * 60)
            re_.update_weight("up2", "x", 1.0 + 2 * i, ts=t0 + i * 60)
            re_.update_weight("down", "x", 9.0 - i, ts=t0 + i * 60)
        stronger = re_.strengthening(limit=5)
        assert [t.source for t in stronger][0] == "up2"  # fastest first
        assert {t.source for t in stronger} == {"up1", "up2"}
        weaker = re_.weakening(limit=5)
        assert [t.source for t in weaker] == ["down"]

    def test_lru_eviction_bound(self):
        re_ = RelationshipEvolution(RelationshipConfig(max_tracked=3))
        for i in range(6):
            re_.update_weight(f"s{i}", "t", 1.0, ts=1_700_000_000.0 + i)
        assert re_.get_trend("s0", "t") is None  # evicted
        assert re_.get_trend("s5", "t") is not None

    def test_predict_unknown_edge_is_zero(self):
        assert RelationshipEvolution().predict_strength("x", "y") == 0.0

    def test_co_access_accumulates(self):
        re_ = RelationshipEvolution()
        t0 = 1_700_000_000.0
        for i in range(6):
            re_.record_co_access("a", "b", weight=1.0, ts=t0 + i * 10)
        trend = re_.get_trend("a", "b")
        assert trend.current_strength > 1.0  # accumulated, not replaced
        assert trend.direction == "strengthening"


class TestDecayIntegration:
    """Port of pkg/temporal decay_integration_test.go intent: temporal
    signals blend into one clamped, smoothed decay-rate multiplier, and
    the DecayManager hook actually stretches half-lives."""

    def test_frequent_access_slows_decay(self):
        from nornicdb_tpu_torch.temporal import DecayIntegration

        di = DecayIntegration()
        now = time.time()
        for i in range(30):
            di.record_access("hot", now - (30 - i) * 60)  # steady hits
        mod = di.get_decay_modifier("hot")
        assert mod.multiplier < 1.0, mod
        assert mod.confidence > 0.5
        assert any(c.name == "velocity" for c in mod.components)

    def test_unknown_node_is_baseline_and_clamped(self):
        from nornicdb_tpu_torch.temporal import (DecayIntegration,
                                           DecayIntegrationConfig)

        cfg = DecayIntegrationConfig()
        di = DecayIntegration(cfg)
        mod = di.get_decay_modifier("ghost")
        assert cfg.min_decay_multiplier <= mod.multiplier <= \
            cfg.max_decay_multiplier
        assert mod.confidence <= 0.2

    def test_burst_boost_expires(self):
        from nornicdb_tpu_torch.temporal import DecayIntegration

        di = DecayIntegration()
        now = time.time()
        for i in range(12):
            di.record_access("bursty", now - 20 + i)
        assert any(c.name == "burst"
                   for c in di.get_decay_modifier("bursty").components)
        # simulate expiry
        di._burst_start["bursty"] = now - 10_000
        assert not any(c.name == "burst"
                       for c in di.get_decay_modifier("bursty").components)

    def test_conservative_vs_aggressive_presets(self):
        from nornicdb_tpu_torch.temporal import (aggressive_decay_config,
                                           conservative_decay_config)

        cons, aggr = conservative_decay_config(), aggressive_decay_config()
        assert cons.min_decay_multiplier < aggr.min_decay_multiplier
        assert cons.max_decay_multiplier < aggr.max_decay_multiplier

    def test_decay_manager_hook_stretches_half_life(self):
        from nornicdb_tpu_torch.decay import DecayManager
        from nornicdb_tpu_torch.storage import MemoryEngine, Node

        eng = MemoryEngine()
        now = time.time()
        node = Node(id="m", properties={"importance": 0.5})
        node.last_accessed = now - 7 * 86400
        eng.create_node(node)
        mgr = DecayManager(eng, now_fn=lambda: now)
        mgr.config.kalman_smoothing = False
        base = mgr.calculate_score(eng.get_node("m"), now)
        mgr.rate_modifier = lambda nid: 0.1  # 10x slower decay
        slowed = mgr.calculate_score(eng.get_node("m"), now)
        assert slowed > base
        mgr.rate_modifier = lambda nid: 5.0  # 5x faster decay
        sped = mgr.calculate_score(eng.get_node("m"), now)
        assert sped < base

    def test_access_rate_trend_directions(self):
        """access_rate_trend: positive velocity = accelerating access
        (ref: GetAccessRateTrend tracker.go:712)."""
        from nornicdb_tpu_torch.temporal import TemporalTracker

        tr = TemporalTracker()
        t = 1_700_000_000.0
        for i in range(40):
            tr.record_access("accel", t)
            t += 300 * (0.93 ** i)
        v, trend = tr.access_rate_trend("accel")
        assert trend == "increasing" and v > 0
        t = 1_700_000_000.0
        for i in range(40):
            tr.record_access("decel", t)
            t += 20 * (1.08 ** i)
        v, trend = tr.access_rate_trend("decel")
        assert trend == "decreasing" and v < 0
        t = 1_700_000_000.0
        for i in range(40):
            tr.record_access("steady", t)
            t += 60
        assert tr.access_rate_trend("steady")[1] == "stable"
        assert tr.access_rate_trend("unknown") == (0.0, "stable")

    def test_rare_access_penalized_vs_frequent(self):
        """The decay modifier must penalize decelerating access and boost
        accelerating access (the semantic the unit-confusion review
        finding flagged as inverted)."""
        from nornicdb_tpu_torch.temporal import DecayIntegration

        di = DecayIntegration()
        t = time.time() - 7200
        for i in range(40):
            di.record_access("accel", t)
            t += 300 * (0.93 ** i)
        t = time.time() - 7200
        for i in range(40):
            di.record_access("decel", t)
            t += 20 * (1.08 ** i)
        accel = di.get_decay_modifier("accel")
        decel = di.get_decay_modifier("decel")
        a_vel = next(c for c in accel.components if c.name == "velocity")
        d_vel = next(c for c in decel.components if c.name == "velocity")
        assert a_vel.multiplier < 1.0 < d_vel.multiplier
        assert accel.multiplier < decel.multiplier


# ---------------------------------------------------------- both packages
def _stream(seed: int, n: int = 600) -> list[tuple[str, float, float]]:
    """(node, timestamp, latency) of one seeded access stream: bursts,
    daily habits and stragglers over three weeks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = 1_700_000_000.0 - (1_700_000_000.0 % DAY)
    out = []
    t = base
    for i in range(n):
        node = f"n{int(rng.zipf(1.6)) % 12}"
        if rng.random() < 0.3:
            t += float(rng.uniform(0.5, 30.0))  # a burst
        else:
            t += float(rng.exponential(0.05 * DAY))
        out.append((node, t, float(rng.uniform(0.001, 0.2))))
    return out


def _outputs(mod, decay_mod, seed: int) -> dict:
    """Everything one package's temporal classes say about the stream."""
    stream = _stream(seed)
    clock = {"now": stream[0][1]}
    now = lambda: clock["now"]  # noqa: E731
    tracker = mod.TemporalTracker(now_fn=now)
    patterns = mod.PatternDetector()
    evolution = mod.RelationshipEvolution()
    integ = mod.DecayIntegration(tracker=mod.TemporalTracker(now_fn=now))
    from importlib import import_module

    qmod = import_module(mod.__name__ + ".query_load")
    load = qmod.QueryLoadTracker(window=3600.0, now_fn=now)
    prev = None
    for node, ts, lat in stream:
        clock["now"] = ts
        tracker.record_access(node, ts)
        patterns.record_access(node, ts)
        integ.record_access(node, ts)
        load.record(lat)
        if prev is not None and prev[0] != node:
            evolution.record_co_access(prev[0], node, ts=ts)
        prev = (node, ts)
    clock["now"] += 600.0
    nodes = sorted({s[0] for s in stream})

    def pat(p):  # last_seen of a trend or daily pattern is the wall clock
        return (p.type, p.confidence, p.peak_hour, p.peak_day, p.period)

    out = {"qps": load.qps(), "latency": load.smoothed_latency(),
           "total": load.total,
           "pairs": tracker.co_access_pairs(2),
           "sessions": [len(s) for s in tracker.sessions.sessions],
           "strengthening": [vars(t) for t in evolution.strengthening(20)],
           "weakening": [vars(t) for t in evolution.weakening(20)]}
    for n in nodes:
        vel, trend = tracker.access_rate_trend(n)
        mod_ = integ.get_decay_modifier(n)
        out[n] = {
            "count": tracker.access_count(n), "last": tracker.last_access(n),
            "rate": tracker.access_rate(n), "trend": (vel, trend),
            "next": tracker.predict_next_access(n),
            "with": tracker.co_accessed_with(n),
            "patterns": [pat(p) for p in patterns.detect_patterns(n, vel)
                         if p.type != mod.PATTERN_BURST],
            "peak": patterns.peak_access_time(n),
            "modifier": (mod_.multiplier, mod_.reason, mod_.confidence,
                         [vars(c) for c in mod_.components]),
        }
    for a, b in zip(nodes, nodes[1:]):
        t = evolution.get_trend(a, b)
        out[(a, b)] = (vars(t) if t else None,
                       evolution.predict_strength(a, b, 3))
    # the decay manager with the integration as its rate modifier
    storage_mod = import_module(decay_mod.__name__.rsplit(".", 1)[0]
                                + ".storage")
    eng = storage_mod.MemoryEngine()
    for n in nodes:
        node = storage_mod.Node(id=n, properties={"importance": 0.4})
        node.last_accessed = tracker.last_access(n)
        node.access_count = tracker.access_count(n)
        eng.create_node(node)
    mgr = decay_mod.DecayManager(eng, now_fn=now)
    mgr.rate_modifier = lambda nid: integ.get_decay_modifier(nid).multiplier
    mgr.recalculate_all()
    out["scores"] = {n.id: n.decay_score for n in eng.all_nodes()}
    return out


class TestBothPackages:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_one_access_stream(self, seed):
        import nornicdb_tpu.decay as jax_decay
        import nornicdb_tpu.temporal as jax_temporal

        import nornicdb_tpu_torch.decay as port_decay
        import nornicdb_tpu_torch.temporal as port_temporal

        want = _outputs(jax_temporal, jax_decay, seed)
        got = _outputs(port_temporal, port_decay, seed)
        assert got == want


class TestDbTemporal:
    def test_touch_feeds_the_tracker(self):
        from nornicdb_tpu_torch.embed import HashEmbedder

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            db.set_embedder(HashEmbedder(16))
            ids = [db.store(f"temporal doc {i} graph memory").id
                   for i in range(10)]
            db.process_pending_embeddings()
            db.touch(ids[0])  # before the tracker exists: not recorded
            tracker = db.temporal
            assert db.temporal is tracker
            touched: dict = {}
            for q in ("temporal doc 3", "graph memory", "doc 7 graph"):
                for r in db.recall(q, limit=4):
                    touched[r["id"]] = touched.get(r["id"], 0) + 1
            db.remember(ids[5])
            touched[ids[5]] = touched.get(ids[5], 0) + 1
            assert touched
            for nid in ids:
                assert tracker.access_count(nid) == touched.get(nid, 0), nid
        finally:
            db.close()
