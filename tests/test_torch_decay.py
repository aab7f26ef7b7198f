"""Decay manager unit depth (ref: pkg/decay/decay_test.go +
kalman_adapter_test.go — per-tier half-life formula exactness, score
composition, archive boundary, reinforce/resurrect, stats accounting,
scheduler lifecycle, concurrency, Kalman smoothing on/off).

The port's copy of ``tests/test_decay_depth.py``: the JAX cases with only
their imports changed. Then both packages' managers over the same nodes
with a fixed clock (scores equal within 1e-12, the archived sets equal),
``DB(Config(decay_enabled=True))`` opening and ticking, and ``python -m
nornicdb_tpu_torch decay``.
"""

import math
import threading

import pytest

from nornicdb_tpu_torch.decay.decay import (
    ARCHIVED_LABEL,
    DAY,
    HALF_LIVES,
    DecayConfig,
    DecayManager,
    half_life,
)
from nornicdb_tpu_torch.storage import MemoryEngine
from nornicdb_tpu_torch.storage.types import EPISODIC, PROCEDURAL, SEMANTIC, Node

T0 = 1_000_000_000.0


def _mgr(config=None, now=T0):
    state = {"now": now}
    m = DecayManager(MemoryEngine(), config=config,
                     now_fn=lambda: state["now"])
    return m, state


def _node(engine, nid, mtype=SEMANTIC, accessed=T0, count=0, **props):
    n = Node(id=nid, memory_type=mtype, properties=props)
    n.last_accessed = accessed
    n.access_count = count
    return engine.create_node(n)


class TestHalfLife:
    """ref: TestHalfLife / TestTierLambdaValues"""

    def test_tier_values(self):
        assert half_life(EPISODIC) == 7 * DAY
        assert half_life(SEMANTIC) == 69 * DAY
        assert half_life(PROCEDURAL) == 693 * DAY

    def test_unknown_tier_falls_back_to_semantic(self):
        assert half_life("no-such-tier") == HALF_LIVES[SEMANTIC]

    def test_ordering_episodic_fastest(self):
        assert half_life(EPISODIC) < half_life(SEMANTIC) < \
            half_life(PROCEDURAL)


class TestDecayFormula:
    """ref: TestDecayFormula / TestManager_CalculateScore"""

    def test_fresh_max_importance_scores_near_one(self):
        m, st = _mgr()
        n = Node(id="n", memory_type=SEMANTIC,
                 properties={"importance": 1.0})
        n.last_accessed = T0
        n.access_count = 100
        assert m.calculate_score(n, now=T0) == pytest.approx(1.0, abs=1e-6)

    def test_recency_component_halves_at_half_life(self):
        cfg = DecayConfig(recency_weight=1.0, frequency_weight=0.0,
                          importance_weight=0.0)
        m, _ = _mgr(cfg)
        n = Node(id="n", memory_type=EPISODIC)
        n.last_accessed = T0
        n.access_count = 0
        assert m.calculate_score(n, now=T0) == pytest.approx(1.0, abs=1e-9)
        assert m.calculate_score(n, now=T0 + 7 * DAY) == \
            pytest.approx(0.5, abs=1e-9)
        assert m.calculate_score(n, now=T0 + 14 * DAY) == \
            pytest.approx(0.25, abs=1e-9)

    def test_frequency_saturates_at_ten_accesses(self):
        cfg = DecayConfig(recency_weight=0.0, frequency_weight=1.0,
                          importance_weight=0.0)
        m, _ = _mgr(cfg)
        n = Node(id="n")
        n.last_accessed = T0
        n.access_count = 10
        assert m.calculate_score(n, now=T0) == pytest.approx(1.0, abs=1e-9)
        n.access_count = 1000
        assert m.calculate_score(n, now=T0) == 1.0
        n.access_count = 0
        assert m.calculate_score(n, now=T0) == 0.0

    def test_importance_clamped_to_unit_interval(self):
        cfg = DecayConfig(recency_weight=0.0, frequency_weight=0.0,
                          importance_weight=1.0)
        m, _ = _mgr(cfg)
        for raw, expect in ((2.5, 1.0), (-1.0, 0.0), (0.3, 0.3)):
            n = Node(id="n", properties={"importance": raw})
            n.last_accessed = T0
            assert m.calculate_score(n, now=T0) == pytest.approx(expect)

    def test_future_last_accessed_does_not_exceed_one(self):
        m, _ = _mgr()
        n = Node(id="n", properties={"importance": 1.0})
        n.last_accessed = T0 + 999.0  # clock skew
        n.access_count = 50
        assert m.calculate_score(n, now=T0) <= 1.0

    def test_rate_modifier_halves_decay_speed(self):
        cfg = DecayConfig(recency_weight=1.0, frequency_weight=0.0,
                          importance_weight=0.0)
        m, _ = _mgr(cfg)
        m.rate_modifier = lambda nid: 0.5  # memories live twice as long
        n = Node(id="n", memory_type=EPISODIC)
        n.last_accessed = T0
        assert m.calculate_score(n, now=T0 + 14 * DAY) == \
            pytest.approx(0.5, abs=1e-9)

    def test_kalman_smoothing_damps_step_change(self):
        """ref: TestKalmanAdapter_CalculateScore_Smoothing — with smoothing
        on, a sudden score drop moves gradually."""
        cfg = DecayConfig(recency_weight=1.0, frequency_weight=0.0,
                          importance_weight=0.0, kalman_smoothing=True)
        m, _ = _mgr(cfg)
        n = Node(id="n", memory_type=EPISODIC)
        n.last_accessed = T0
        first = m.calculate_score(n, now=T0)
        # raw would be 0.5; the filter keeps it closer to the prior 1.0
        smoothed = m.calculate_score(n, now=T0 + 7 * DAY)
        assert 0.5 < smoothed < first


class TestReinforceAndArchive:
    def test_reinforce_bumps_and_caps(self):
        """ref: TestManager_Reinforce"""
        m, _ = _mgr()
        n = _node(m.storage, "n")
        n.decay_score = 0.95
        m.storage.update_node(n)
        assert m.reinforce("n") == 1.0  # capped
        stored = m.storage.get_node("n")
        assert stored.access_count == 1
        assert m.stats.reinforced == 1

    def test_reinforce_resurrects_archived(self, ):
        m, _ = _mgr()
        n = _node(m.storage, "n")
        n.labels.append(ARCHIVED_LABEL)
        m.storage.update_node(n)
        m.reinforce("n")
        assert ARCHIVED_LABEL not in m.storage.get_node("n").labels

    def test_recalculate_archives_below_threshold(self):
        """ref: TestManager_ShouldArchive — stale episodic memory crosses
        the archive threshold, fresh one does not."""
        m, st = _mgr()
        _node(m.storage, "stale", mtype=EPISODIC, accessed=T0 - 300 * DAY,
              importance=0.0)
        _node(m.storage, "fresh", mtype=EPISODIC, accessed=T0,
              importance=0.9, count=5)
        scored, archived = m.recalculate_all()
        assert scored == 2
        assert archived == 1
        archived_ids = [n.id for n in m.archived_nodes()]
        assert archived_ids == ["stale"]
        assert m.storage.get_node("stale").decay_score < \
            m.config.archive_threshold

    def test_recalculate_is_idempotent_on_archived(self):
        m, _ = _mgr()
        _node(m.storage, "stale", mtype=EPISODIC, accessed=T0 - 300 * DAY,
              importance=0.0)
        m.recalculate_all()
        scored, archived = m.recalculate_all()
        assert archived == 0  # already archived, not double counted
        assert m.storage.get_node("stale").labels.count(ARCHIVED_LABEL) == 1

    def test_stats_accumulate(self):
        """ref: TestManager_GetStats"""
        m, _ = _mgr()
        for i in range(3):
            _node(m.storage, f"n{i}")
        m.recalculate_all()
        m.recalculate_all()
        assert m.stats.recalculations == 2
        assert m.stats.nodes_scored == 6


class TestLifecycle:
    def test_start_stop_scheduler(self):
        """ref: TestManager_StartStop — ticks run on the interval and stop
        cancels cleanly."""
        m, _ = _mgr(DecayConfig(interval=0.05))
        _node(m.storage, "n")
        m.start()
        try:
            import time as _t

            deadline = _t.monotonic() + 5.0
            while m.stats.recalculations < 2 and _t.monotonic() < deadline:
                _t.sleep(0.02)
            assert m.stats.recalculations >= 2
        finally:
            m.stop()
        after = m.stats.recalculations
        import time as _t

        _t.sleep(0.15)
        assert m.stats.recalculations == after  # no ticks after stop

    def test_concurrent_reinforce_and_recalculate(self):
        """ref: TestManager_Concurrency"""
        m, _ = _mgr()
        for i in range(20):
            _node(m.storage, f"n{i}")
        errs = []

        def reinforcer():
            try:
                for i in range(50):
                    m.reinforce(f"n{i % 20}")
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        def recalcer():
            try:
                for _ in range(10):
                    m.recalculate_all()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=reinforcer) for _ in range(3)] + \
            [threading.Thread(target=recalcer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert m.stats.reinforced == 150


# ---------------------------------------------------------- both packages
def _seeded_nodes(seed: int, n: int = 400) -> list[dict]:
    import numpy as np

    rng = np.random.default_rng(seed)
    types = [EPISODIC, SEMANTIC, PROCEDURAL, "unknown-tier"]
    out = []
    for i in range(n):
        props = {"content": f"memory {i}"}
        if rng.random() < 0.8:
            props["importance"] = float(np.round(rng.uniform(-0.2, 1.2), 4))
        out.append({"id": f"m{i}", "type": types[int(rng.integers(0, 4))],
                    "count": int(rng.integers(0, 30)),
                    "accessed": T0 - float(rng.uniform(0, 400)) * DAY,
                    "props": props,
                    "archived": bool(rng.random() < 0.05)})
    return out


def _fill_engine(engine, node_cls, nodes: list[dict]) -> None:
    for d in nodes:
        n = node_cls(id=d["id"], memory_type=d["type"],
                     labels=["Memory"] + (["Archived"] if d["archived"]
                                          else []),
                     properties=dict(d["props"]))
        n.last_accessed = d["accessed"]
        n.access_count = d["count"]
        engine.create_node(n)


class TestBothPackages:
    @pytest.mark.parametrize("seed,kalman", [(0, False), (1, False),
                                             (2, True)])
    def test_same_scores_and_archive(self, seed, kalman):
        from nornicdb_tpu.decay.decay import (
            DecayConfig as JaxConfig,
            DecayManager as JaxManager,
        )
        from nornicdb_tpu.storage import MemoryEngine as JaxEngine
        from nornicdb_tpu.storage.types import Node as JaxNode

        nodes = _seeded_nodes(seed)
        managers = []
        for mgr_cls, cfg_cls, eng_cls, node_cls in (
                (JaxManager, JaxConfig, JaxEngine, JaxNode),
                (DecayManager, DecayConfig, MemoryEngine, Node)):
            eng = eng_cls()
            _fill_engine(eng, node_cls, nodes)
            clock = {"now": T0}
            m = mgr_cls(eng, config=cfg_cls(kalman_smoothing=kalman),
                        archive_threshold=0.2, now_fn=lambda c=clock: c["now"])
            managers.append((m, eng, clock))
        for step in range(3):  # three passes, the clock moved ahead
            results = []
            for m, eng, clock in managers:
                clock["now"] = T0 + step * 30 * DAY
                counts = m.recalculate_all()
                results.append((counts, {
                    n.id: (n.decay_score, "Archived" in n.labels)
                    for n in eng.all_nodes()}))
            (jc, jnodes), (pc, pnodes) = results
            assert pc == jc
            assert pnodes.keys() == jnodes.keys()
            for nid, (score, archived) in jnodes.items():
                assert abs(pnodes[nid][0] - score) <= 1e-12, nid
                assert pnodes[nid][1] == archived, nid
        jm, pm = managers[0][0], managers[1][0]
        assert vars(pm.stats) == vars(jm.stats)
        assert sorted(n.id for n in pm.archived_nodes()) == \
            sorted(n.id for n in jm.archived_nodes())
        for m, _, _ in managers:
            m.reinforce("m3")
        assert managers[0][1].get_node("m3").decay_score == \
            managers[1][1].get_node("m3").decay_score


class TestDbAndCli:
    def test_decay_enabled_opens_and_ticks(self):
        import time

        import nornicdb_tpu_torch
        from nornicdb_tpu_torch.db import Config

        db = nornicdb_tpu_torch.open_db(
            "", Config(decay_enabled=True, decay_interval=0.05,
                       archive_threshold=0.3), device="cpu")
        try:
            n = db.store("an old memory", memory_type=EPISODIC)
            node = db.storage.get_node(n.id)
            node.last_accessed -= 400 * DAY
            node.properties["importance"] = 0.0
            db.storage.update_node(node)
            deadline = time.monotonic() + 10
            while db.decay.stats.recalculations < 2:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert db.decay.config.archive_threshold == 0.3
            assert db.decay.config.interval == 0.05
            assert [x.id for x in db.decay.archived_nodes()] == [n.id]
            rows = db.cypher("CALL nornicdb.decay.info()").rows
            assert rows[0][0] is True
        finally:
            db.close()
        assert db.decay._stopped
        seen = db.decay.stats.recalculations
        time.sleep(0.2)
        assert db.decay.stats.recalculations == seen  # the ticker stopped

    def test_cli_decay_against_jax(self, tmp_path, capsys):
        import shutil

        import nornicdb_tpu_torch
        from nornicdb_tpu.cli import main as jax_main
        from nornicdb_tpu_torch.cli import main as port_main

        d = tmp_path / "d"
        db = nornicdb_tpu_torch.open_db(str(d), device="cpu")
        for i in range(30):
            n = db.store(f"memory {i}", memory_type=EPISODIC,
                         properties={"importance": 0.0 if i % 3 else 1.0})
            node = db.storage.get_node(n.id)
            node.last_accessed -= (400 if i % 2 else 0) * DAY
            db.storage.update_node(node)
        db.close()
        shutil.copytree(d, tmp_path / "j")
        outs = {}
        for name, main, path, extra in (
                ("port", port_main, d, ["--device", "cpu"]),
                ("jax", jax_main, tmp_path / "j", [])):
            lines = []
            for action in ("recalculate", "archive", "stats"):
                assert main(["--data-dir", str(path), "decay", action,
                             *extra]) == 0
                lines.append(capsys.readouterr().out.strip().splitlines()[-1])
            outs[name] = lines
        assert outs["port"] == outs["jax"]
        assert outs["port"][0] == "scored 30 nodes, archived 10"
        assert outs["port"][1] == "10 archived nodes"

    def test_cli_decay_needs_the_card_unless_told(self, tmp_path):
        import torch

        from nornicdb_tpu_torch.cli import main as port_main

        if torch.cuda.is_available():
            pytest.skip("the default device is the card when one exists")
        with pytest.raises(SystemExit) as e:
            port_main(["--data-dir", str(tmp_path / "d"), "decay", "stats"])
        assert "device='cpu'" in str(e.value.code)
        assert not (tmp_path / "d").exists()
