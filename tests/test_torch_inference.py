"""The port's auto-TLP inference (``nornicdb_tpu_torch.inference``), its
integration adapters and the vector-space registry against the JAX
package's.

The cases of ``tests/test_inference_evidence.py``, the inference cases of
``tests/test_learning.py`` and the integration and registry cases of
``tests/test_integrations.py`` run in both packages. Then one seeded stream
of suggestions, stores and accesses, with ``now_fn`` injected, goes
through both engines: the inferred edges (ends, type, confidence, evidence
count, time) and the statistics must be equal.
"""

import threading

import numpy as np
import pytest

from nornicdb_tpu import inference as JI
from nornicdb_tpu import vectorspace as JV
from nornicdb_tpu.errors import NornicError as JNornicError
from nornicdb_tpu.heimdall import HeimdallManager as JManager
from nornicdb_tpu.heimdall import TemplateGenerator as JTemplate
from nornicdb_tpu.inference import integrations as JInt
from nornicdb_tpu.storage import Edge as JEdge
from nornicdb_tpu.storage import MemoryEngine as JMem
from nornicdb_tpu.storage import Node as JNode
from nornicdb_tpu_torch import inference as PI
from nornicdb_tpu_torch import vectorspace as PV
from nornicdb_tpu_torch.errors import NornicError as PNornicError
from nornicdb_tpu_torch.heimdall import HeimdallManager as PManager
from nornicdb_tpu_torch.heimdall import TemplateGenerator as PTemplate
from nornicdb_tpu_torch.inference import integrations as PInt
from nornicdb_tpu_torch.storage import Edge as PEdge
from nornicdb_tpu_torch.storage import MemoryEngine as PMem
from nornicdb_tpu_torch.storage import Node as PNode


class Pkg:
    def __init__(self, I, Int, V, Mem, Node, Edge, Manager, Template,
                 NornicError):
        self.I, self.Int, self.V = I, Int, V
        self.Mem, self.Node, self.Edge = Mem, Node, Edge
        self.Manager, self.Template = Manager, Template
        self.NornicError = NornicError


PKGS = {
    "jax": Pkg(JI, JInt, JV, JMem, JNode, JEdge, JManager, JTemplate,
               JNornicError),
    "torch": Pkg(PI, PInt, PV, PMem, PNode, PEdge, PManager, PTemplate,
                 PNornicError),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def setup(pkg):
    eng = pkg.Mem()
    for nid in ("a", "b", "c", "d"):
        eng.create_node(pkg.Node(id=nid))
    clock = {"t": 1_700_000_000.0}
    inf = pkg.I.InferenceEngine(eng, config=pkg.I.InferenceConfig(
        min_evidence=3, cooldown=300.0, evidence_ttl=3600.0),
        now_fn=lambda: clock["t"])
    return inf, eng, clock


# ---- cases of tests/test_inference_evidence.py, in both packages
class TestEvidenceThreshold:
    def test_requires_threshold(self, setup):
        inf, eng, _ = setup
        assert inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9) is None
        assert inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9) is None
        assert eng.edge_count() == 0
        edge = inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        assert edge is not None
        assert eng.edge_count() == 1
        assert edge.auto_generated
        assert edge.properties["evidence_count"] == 3

    def test_confidence_averaged_across_evidence(self, setup):
        inf, _, _ = setup
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.6)
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.8)
        edge = inf.process_suggestion("a", "b", "SIMILAR_TO", 1.0)
        assert edge.confidence == pytest.approx(0.8, abs=1e-4)

    def test_expired_evidence_restarts(self, setup):
        inf, eng, clock = setup
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        clock["t"] += 3601.0  # TTL passes
        assert inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9) is None
        assert eng.edge_count() == 0  # count restarted at 1, not 3

    def test_different_rel_types_keyed_separately(self, setup):
        inf, eng, _ = setup
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        assert inf.process_suggestion("a", "b", "RELATED_TO", 0.9) is None
        edge = inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        assert edge is not None and edge.type == "SIMILAR_TO"


class TestCooldown:
    def test_cooldown_suppresses_after_creation(self, setup):
        inf, _, _ = setup
        for _ in range(3):
            inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        before = inf.stats.suppressed_cooldown
        assert inf.process_suggestion("a", "b", "RELATED_TO", 0.9) is None
        assert inf.stats.suppressed_cooldown == before + 1

    def test_cooldown_expires(self, setup):
        inf, eng, clock = setup
        for _ in range(3):
            inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        clock["t"] += 301.0
        for _ in range(3):
            inf.process_suggestion("a", "b", "RELATED_TO", 0.9)
        assert eng.edge_count() == 2

    def test_existing_edge_suppressed_and_cooled(self, setup, pkg):
        inf, eng, _ = setup
        eng.create_edge(pkg.Edge(id="e", start_node="a", end_node="b",
                                 type="SIMILAR_TO"))
        assert inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9) is None
        assert inf.stats.suppressed_existing == 1
        assert inf.process_suggestion("b", "a", "RELATED_TO", 0.9) is None
        assert inf.stats.suppressed_cooldown == 1

    def test_pair_key_is_undirected(self, setup):
        inf, _, _ = setup
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        inf.process_suggestion("b", "a", "SIMILAR_TO", 0.9)
        assert inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9) is not None


class TestConcurrency:
    def test_concurrent_suggestions_create_exactly_one_edge(self, pkg):
        eng = pkg.Mem()
        eng.create_node(pkg.Node(id="a"))
        eng.create_node(pkg.Node(id="b"))
        inf = pkg.I.InferenceEngine(eng, config=pkg.I.InferenceConfig(
            min_evidence=3, cooldown=300.0))
        threads = [
            threading.Thread(target=lambda: inf.process_suggestion(
                "a", "b", "SIMILAR_TO", 0.9))
            for _ in range(24)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert eng.edge_count() == 1
        assert inf.stats.edges_created == 1


class TestStatsAccounting:
    def test_stats_track_every_path(self, setup):
        inf, _, _ = setup
        for _ in range(3):
            inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)
        inf.process_suggestion("a", "b", "SIMILAR_TO", 0.9)  # cooled
        assert inf.stats.suggestions == 4
        assert inf.stats.edges_created == 1
        assert inf.stats.suppressed_cooldown == 1


# ---- the inference cases of tests/test_learning.py, in both packages
class TestInference:
    @pytest.fixture(autouse=True)
    def _clock(self):
        self._now = [1000.0]

    def _engine(self, pkg, eng, sims=None, **cfg):
        config = (pkg.I.InferenceConfig(**cfg) if cfg
                  else pkg.I.InferenceConfig(min_evidence=2))
        return pkg.I.InferenceEngine(
            eng, similarity_fn=(lambda v, k: sims or []), config=config,
            now_fn=lambda: self._now[0])

    def _ab(self, pkg):
        eng = pkg.Mem()
        a = eng.create_node(pkg.Node(id="a", embedding=np.ones(4, np.float32)))
        eng.create_node(pkg.Node(id="b"))
        return eng, a

    def test_similarity_creates_edge_after_evidence(self, pkg):
        eng, a = self._ab(pkg)
        inf = self._engine(pkg, eng, sims=[("b", 0.95)], min_evidence=2,
                           cooldown=0.0)
        assert inf.on_store(a) == []
        edges = inf.on_store(a)
        assert len(edges) == 1
        e = edges[0]
        assert e.type == pkg.I.SIMILAR_TO and e.auto_generated
        assert e.confidence == pytest.approx(0.95, abs=1e-3)

    def test_below_threshold_ignored(self, pkg):
        eng, a = self._ab(pkg)
        inf = self._engine(pkg, eng, sims=[("b", 0.5)])
        assert inf.on_store(a) == []
        assert inf.on_store(a) == []
        assert eng.edge_count() == 0

    def test_cooldown_suppresses(self, pkg):
        eng, a = self._ab(pkg)
        inf = self._engine(pkg, eng, sims=[("b", 0.9)], min_evidence=1,
                           cooldown=100.0)
        assert len(inf.on_store(a)) == 1
        eng.delete_edge(list(eng.all_edges())[0].id)
        assert inf.on_store(a) == []
        assert inf.stats.suppressed_cooldown >= 1
        self._now[0] += 200.0
        assert len(inf.on_store(a)) == 1

    def test_existing_edge_not_duplicated(self, pkg):
        eng, a = self._ab(pkg)
        eng.create_edge(pkg.Edge(start_node="a", end_node="b",
                                 type=pkg.I.SIMILAR_TO))
        inf = self._engine(pkg, eng, sims=[("b", 0.9)], min_evidence=1,
                           cooldown=0.0)
        assert inf.on_store(a) == []
        assert inf.stats.suppressed_existing == 1

    def test_co_access_suggestion(self, pkg):
        eng = pkg.Mem()
        eng.create_node(pkg.Node(id="x"))
        eng.create_node(pkg.Node(id="y"))
        inf = self._engine(pkg, eng, min_evidence=1, co_access_min=2,
                           cooldown=0.0)
        for _ in range(3):
            inf.on_access("x")
            inf.on_access("y")
        edges = [e for e in eng.all_edges() if e.type == "CO_ACCESSED_WITH"]
        assert len(edges) == 1

    def test_transitive_suggestion(self, pkg):
        eng = pkg.Mem()
        for i in "abc":
            eng.create_node(pkg.Node(id=i))
        eng.create_edge(pkg.Edge(start_node="a", end_node="b", confidence=1.0))
        eng.create_edge(pkg.Edge(start_node="b", end_node="c", confidence=1.0))
        inf = self._engine(pkg, eng, min_evidence=1, cooldown=0.0)
        created = inf.suggest_transitive("a")
        assert len(created) == 1
        assert created[0].start_node == "a" and created[0].end_node == "c"

    def test_decay_inferred_edges(self, pkg):
        eng = pkg.Mem()
        eng.create_node(pkg.Node(id="a"))
        eng.create_node(pkg.Node(id="b"))
        eng.create_edge(pkg.Edge(start_node="a", end_node="b",
                                 auto_generated=True, confidence=0.05))
        eng.create_edge(pkg.Edge(start_node="a", end_node="b",
                                 confidence=0.05))
        inf = self._engine(pkg, eng)
        assert inf.decay_inferred_edges(min_confidence=0.1) == 1
        assert eng.edge_count() == 1

    def test_similarity_failure_counted_not_raised(self, pkg):
        eng, a = self._ab(pkg)

        def broken(v, k):
            raise RuntimeError("backend down")

        inf = pkg.I.InferenceEngine(eng, similarity_fn=broken)
        assert inf.on_store(a) == [] and inf._sim_errors in (0, 1)


# ---- the integration and registry cases of tests/test_integrations.py
def _graph_engine(pkg):
    eng = pkg.Mem()
    for i in "abcd":
        eng.create_node(pkg.Node(id=i))
    for eid, s, t in (("e1", "a", "b"), ("e2", "b", "c"), ("e3", "a", "d"),
                      ("e4", "c", "d")):
        eng.create_edge(pkg.Edge(id=eid, start_node=s, end_node=t))
    return eng


class TestIntegrations:
    def test_topology_boosts_connected_pairs(self, pkg):
        topo = pkg.Int.TopologyIntegration(_graph_engine(pkg), weight=0.5)
        assert topo.adjust_confidence("a", "c", 0.5) > 0.5

    def test_topology_attach_changes_created_confidence(self, pkg):
        eng = _graph_engine(pkg)
        inf = pkg.I.InferenceEngine(
            eng, config=pkg.I.InferenceConfig(min_evidence=1, cooldown=0.0))
        pkg.Int.TopologyIntegration(eng, weight=0.5).attach(inf)
        edge = inf.process_suggestion("a", "c", "SIMILAR_TO", 0.5)
        assert edge is not None and edge.confidence > 0.5

    def test_cluster_integration(self, pkg):
        ci = pkg.Int.ClusterIntegration(lambda: {"x": 0, "y": 0, "z": 1})
        assert ci.adjust_confidence("x", "y", 0.5) == pytest.approx(0.55)
        assert ci.adjust_confidence("x", "z", 0.5) == pytest.approx(0.45)
        assert ci.adjust_confidence("x", "unknown", 0.5) == 0.5
        empty = pkg.Int.ClusterIntegration(lambda: None)
        assert empty.adjust_confidence("x", "y", 0.5) == 0.5

    def test_heimdall_qc_review(self, pkg):
        eng = pkg.Mem()
        eng.create_node(pkg.Node(id="a", properties={"content": "alpha"}))
        eng.create_node(pkg.Node(id="b", properties={"content": "beta"}))

        class Rejecting(pkg.Template):
            def generate(self, prompt, max_tokens=128):
                return '{"keep": false}'

        qc = pkg.Int.HeimdallQC(pkg.Manager(Rejecting()), eng)
        assert qc.review([("a", "b", "SIMILAR_TO"),
                          ("a", "ghost", "SIMILAR_TO")]) == [False, False]
        assert qc.rejected == 1 and qc.reviewed == 1

    def test_qc_gate_attaches_only_when_enabled(self, pkg, monkeypatch):
        eng = _graph_engine(pkg)

        class Rejecting(pkg.Template):
            def generate(self, prompt, max_tokens=128):
                return '{"keep": false}'

        inf = pkg.I.InferenceEngine(
            eng, config=pkg.I.InferenceConfig(min_evidence=1, cooldown=0.0))
        qc = pkg.Int.HeimdallQC(pkg.Manager(Rejecting()), eng)
        monkeypatch.setenv("NORNICDB_AUTO_TLP_LLM_QC_ENABLED", "true")
        qc.attach(inf)
        assert inf.process_suggestion("a", "c", "SIMILAR_TO", 0.9) is None
        assert qc.rejected == 1


class TestVectorSpaceRegistry:
    def test_register_get_canonical(self, pkg):
        reg = pkg.V.VectorSpaceRegistry()
        key = reg.register(pkg.V.VectorSpaceKey("Docs", 1024))
        assert reg.get("docs") == key
        assert key.canonical() == "docs:1024:cosine:tpu"
        assert len(key.hash()) == 16

    def test_dims_mismatch_rejected(self, pkg):
        reg = pkg.V.VectorSpaceRegistry()
        reg.register(pkg.V.VectorSpaceKey("a", 64))
        with pytest.raises(pkg.NornicError):
            reg.register(pkg.V.VectorSpaceKey("a", 128))

    def test_list_and_drop(self, pkg):
        reg = pkg.V.VectorSpaceRegistry()
        reg.register(pkg.V.VectorSpaceKey("b", 8))
        reg.register(pkg.V.VectorSpaceKey("a", 8))
        assert [k.name for k in reg.list()] == ["a", "b"]
        assert reg.drop("a") and not reg.drop("a")

    def test_same_keys_and_hashes(self):
        for name, dims, dist in (("Docs", 1024, "cosine"), ("x", 8, "dot"),
                                 ("Img", 512, "euclidean")):
            p = PV.VectorSpaceKey(name, dims, dist)
            j = JV.VectorSpaceKey(name, dims, dist)
            assert (p.canonical(), p.hash()) == (j.canonical(), j.hash())


# ---- one seeded stream through both engines
def _stream(pkg, seed: int):
    """Seeded suggestions, stores (similarity from a fixed table) and
    accesses under an injected clock; returns the edges and stats.
    (``suggest_transitive`` is left out: its confidence follows the order
    of a node's outgoing edges, whose random ids order them differently
    from run to run in either package.)"""
    rng = np.random.default_rng(seed)
    ids = [f"n{i}" for i in range(12)]
    eng = pkg.Mem()
    for nid in ids:
        eng.create_node(pkg.Node(id=nid, embedding=np.ones(4, np.float32)))
    clock = [1_700_000_000.0]
    table = {nid: [(ids[j], float(s)) for j, s in zip(
        rng.choice(12, 4, replace=False), rng.uniform(0.7, 1.0, 4))]
        for nid in ids}
    current = {"id": None}
    inf = pkg.I.InferenceEngine(
        eng, similarity_fn=lambda v, k: table[current["id"]][:k],
        config=pkg.I.InferenceConfig(min_evidence=2, cooldown=50.0,
                                     co_access_min=2, evidence_ttl=400.0),
        now_fn=lambda: clock[0])
    for step in range(300):
        clock[0] += float(rng.uniform(0.0, 20.0))
        op = int(rng.integers(0, 3))
        a, b = (ids[int(i)] for i in rng.choice(12, 2, replace=False))
        if op == 0:
            inf.process_suggestion(a, b, ["SIMILAR_TO", "RELATED_TO"][
                step % 2], float(rng.uniform(0.5, 1.0)))
        elif op == 1:
            current["id"] = a
            inf.on_store(eng.get_node(a))
        else:
            inf.on_access(a)
    edges = sorted((e.start_node, e.end_node, e.type, e.confidence,
                    e.auto_generated, e.properties["evidence_count"],
                    e.properties["inferred_at"]) for e in eng.all_edges())
    return edges, vars(inf.stats).copy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_stream_same_edges(seed):
    edges, stats = _stream(PKGS["torch"], seed)
    assert (edges, stats) == _stream(PKGS["jax"], seed)
    assert stats["edges_created"] > 0
