"""The port's GDS procedures (``nornicdb_tpu_torch/cypher/gds_procedures.py``)
and the ``apoc.algo.*`` aliases on the CPU.

- the procedure-level cases of ``tests/test_graph_algos.py`` and
  ``tests/test_learning.py::TestGdsProcedures`` run against the port,
  unchanged but for their imports (the executor takes ``device="cpu"``);
- both packages on one seeded graph (200 nodes, 800 typed and weighted
  edges, through the storage API with the same ids): every ``gds.*``
  procedure and every ``apoc.algo.*`` procedure and function gives the
  same columns, rows and ids. PageRank is float32 in both and sums in
  another order (``index_add_`` against XLA's ``segment_sum``): held within
  rtol 1e-5, atol 1e-9, as ``tests/test_torch_graph_algos.py`` holds it.
  Everything else is host code in both packages and equal exactly;
- ``gds.linkPrediction.suggest`` at n >= 64: the JAX device branch raises
  on its read-only product (ROADMAP §C), so the port's answer is held
  against JAX's numpy branch, as ``tests/test_torch_linkpredict.py`` does:
  scores within rtol 1e-6 / atol 1e-6 and the same pairs apart from ties
  at the cut;
- the device policy: PageRank, components and the suggest GEMMs run on
  ``ex.device`` after ``backend.gate``; a hung injected owner raises
  DeviceUnavailable within its bound and serves again after recovery; a
  device error propagates (no host retry); an executor on CUDA without a
  card raises DeviceUnavailable.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu_torch import DeviceUnavailable
from nornicdb_tpu_torch.backend import BackendManager, FakeHooks
from nornicdb_tpu_torch.cypher.executor import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node
from nornicdb_tpu_torch.storage.schema import SchemaManager


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


# -- the procedure cases of tests/test_graph_algos.py ------------------------

@pytest.fixture
def ex():
    storage = MemoryEngine()
    schema = SchemaManager()
    schema.attach(storage)
    return CypherExecutor(storage, schema=schema)


def _communities(ex):
    ex.execute(
        "CREATE (a:P {g: 1}), (b:P {g: 1}), (c:P {g: 1}), "
        "(d:P {g: 2}), (e:P {g: 2}), (f:P {g: 2}), "
        "(a)-[:R]->(b), (b)-[:R]->(c), (c)-[:R]->(a), "
        "(d)-[:R]->(e), (e)-[:R]->(f), (f)-[:R]->(d), (c)-[:R]->(d)"
    )


def test_gds_pagerank_stream(ex):
    _communities(ex)
    res = ex.execute(
        "CALL gds.pageRank.stream() YIELD node, score "
        "RETURN node.g, score ORDER BY score DESC"
    )
    assert len(res.rows) == 6
    assert all(isinstance(r[1], float) for r in res.rows)


def test_gds_louvain_and_wcc_stream(ex):
    _communities(ex)
    res = ex.execute(
        "CALL gds.louvain.stream() YIELD node, communityId "
        "RETURN node.g AS g, communityId"
    )
    by_group = {}
    for g, c in res.rows:
        by_group.setdefault(g, set()).add(c)
    assert len(by_group[1]) == 1 and len(by_group[2]) == 1
    assert by_group[1] != by_group[2]
    res = ex.execute(
        "CALL gds.wcc.stream() YIELD componentId RETURN count(DISTINCT componentId)"
    )
    assert res.rows[0][0] == 1  # bridge joins everything weakly


def test_gds_triangle_and_degree_stream(ex):
    _communities(ex)
    res = ex.execute(
        "CALL gds.triangleCount.stream() YIELD triangleCount "
        "RETURN sum(triangleCount)"
    )
    assert res.rows[0][0] == 6  # 2 triangles × 3 member nodes
    res = ex.execute(
        "CALL gds.degree.stream() YIELD score RETURN max(score)"
    )
    assert res.rows[0][0] == 3.0


def test_gds_dijkstra_stream_weighted(ex):
    ex.execute(
        "CREATE (a:C {name:'a'}), (b:C {name:'b'}), (c:C {name:'c'}), "
        "(a)-[:ROAD {cost: 1.0}]->(b), (b)-[:ROAD {cost: 1.0}]->(c), "
        "(a)-[:ROAD {cost: 5.0}]->(c)"
    )
    res = ex.execute(
        "MATCH (a:C {name:'a'}), (c:C {name:'c'}) "
        "CALL gds.shortestPath.dijkstra.stream(a, c, "
        "{relationshipWeightProperty: 'cost'}) "
        "YIELD totalCost, nodeIds RETURN totalCost, size(nodeIds)"
    )
    assert res.rows[0][0] == 2.0
    assert res.rows[0][1] == 3


def test_gds_astar_stream(ex):
    ex.execute(
        "CREATE (a:G {name:'a', lat: 0.0, lon: 0.0}), "
        "(b:G {name:'b', lat: 0.5, lon: 0.5}), "
        "(c:G {name:'c', lat: 1.0, lon: 1.0}), "
        "(a)-[:E]->(b), (b)-[:E]->(c)"
    )
    res = ex.execute(
        "MATCH (a:G {name:'a'}), (c:G {name:'c'}) "
        "CALL gds.shortestPath.astar.stream(a, c, "
        "{latitudeProperty: 'lat', longitudeProperty: 'lon'}) "
        "YIELD totalCost, nodeIds RETURN totalCost, size(nodeIds)"
    )
    assert res.rows[0] == [2.0, 3]


def test_apoc_algo_aliases(ex):
    _communities(ex)
    res = ex.execute(
        "CALL apoc.algo.pageRank() YIELD score RETURN count(score)"
    )
    assert res.rows[0][0] == 6


def test_unreachable_dijkstra_empty(ex):
    ex.execute("CREATE (a:I {name:'a'}), (b:I {name:'b'})")
    res = ex.execute(
        "MATCH (a:I {name:'a'}), (b:I {name:'b'}) "
        "CALL gds.shortestPath.dijkstra.stream(a, b, {}) "
        "YIELD totalCost RETURN totalCost"
    )
    assert res.rows == []


# -- review regressions -----------------------------------------------------

def test_degree_gds_orientations(ex):
    ex.execute("CREATE (a:O)-[:R]->(b:O)")
    res = ex.execute(
        "CALL gds.degree.stream({orientation: 'UNDIRECTED'}) YIELD score "
        "RETURN sum(score)"
    )
    assert res.rows[0][0] == 2.0
    res = ex.execute(
        "CALL gds.degree.stream({orientation: 'NATURAL'}) YIELD score "
        "RETURN max(score)"
    )
    assert res.rows[0][0] == 1.0
    from nornicdb_tpu_torch.errors import CypherSyntaxError
    with pytest.raises(CypherSyntaxError, match="orientation"):
        ex.execute("CALL gds.degree.stream({orientation: 'SIDEWAYS'})")


def test_dijkstra_respects_direction(ex):
    # a->b, c->b: no directed path a..c
    ex.execute(
        "CREATE (a:D2 {name:'a'})-[:R]->(b:D2 {name:'b'}), "
        "(c:D2 {name:'c'})-[:R]->(b)"
    )
    res = ex.execute(
        "MATCH (a:D2 {name:'a'}), (c:D2 {name:'c'}) "
        "CALL gds.shortestPath.dijkstra.stream(a, c, {}) "
        "YIELD totalCost RETURN totalCost"
    )
    assert res.rows == []
    # but UNDIRECTED finds a->b<-c
    res = ex.execute(
        "MATCH (a:D2 {name:'a'}), (c:D2 {name:'c'}) "
        "CALL gds.shortestPath.dijkstra.stream(a, c, "
        "{orientation: 'UNDIRECTED'}) YIELD totalCost RETURN totalCost"
    )
    assert res.rows[0][0] == 2.0


def test_dijkstra_path_has_relationships(ex):
    ex.execute(
        "CREATE (a:D3 {name:'a'})-[:R {cost: 1.0}]->(b:D3 {name:'b'})"
        "-[:R {cost: 1.0}]->(c:D3 {name:'c'})"
    )
    res = ex.execute(
        "MATCH (a:D3 {name:'a'}), (c:D3 {name:'c'}) "
        "CALL gds.shortestPath.dijkstra.stream(a, c, "
        "{relationshipWeightProperty: 'cost'}) "
        "YIELD path RETURN length(path), size(relationships(path))"
    )
    assert res.rows[0] == [2, 2]


def test_undirected_dijkstra_path_relationships_complete(ex):
    # path traverses f<-e<-d against edge direction
    ex.execute(
        "CREATE (a:U {n:'a'})-[:R]->(b:U {n:'b'}), (c:U {n:'c'})-[:R]->(b)"
    )
    res = ex.execute(
        "MATCH (a:U {n:'a'}), (c:U {n:'c'}) "
        "CALL gds.shortestPath.dijkstra.stream(a, c, "
        "{orientation: 'UNDIRECTED'}) "
        "YIELD totalCost, path RETURN totalCost, length(path)"
    )
    assert res.rows[0] == [2.0, 2]


# -- the cases of tests/test_learning.py::TestGdsProcedures ------------------

def _chain_graph():
    """a-b, b-c, a-d, c-d : common neighbors etc."""
    eng = MemoryEngine()
    for i in "abcd":
        eng.create_node(Node(id=i))
    eng.create_edge(Edge(id="e1", start_node="a", end_node="b"))
    eng.create_edge(Edge(id="e2", start_node="b", end_node="c"))
    eng.create_edge(Edge(id="e3", start_node="a", end_node="d"))
    eng.create_edge(Edge(id="e4", start_node="c", end_node="d"))
    return eng


class TestGdsProcedures:
    def test_linkprediction_procs(self):
        eng = _chain_graph()
        ex = CypherExecutor(eng)
        r = ex.execute(
            "MATCH (a {}), (c {}) WHERE id(a) = 'a' AND id(c) = 'c' "
            "CALL gds.linkPrediction.commonNeighbors(a, c) YIELD score RETURN score"
        )
        assert r.rows == [[2.0]]

    def test_lp_suggest(self):
        ex = CypherExecutor(_chain_graph())
        r = ex.execute(
            "CALL gds.linkPrediction.suggest('commonNeighbors', 5) "
            "YIELD node1, node2, score RETURN id(node1), id(node2), score"
        )
        assert len(r.rows) >= 1
        assert r.rows[0][2] > 0

    def test_fastrp(self):
        ex = CypherExecutor(_chain_graph())
        r = ex.execute(
            "CALL gds.fastRP.stream({embeddingDimension: 16}) "
            "YIELD nodeId, embedding RETURN nodeId, size(embedding)"
        )
        assert len(r.rows) == 4
        assert all(row[1] == 16 for row in r.rows)


# -- both packages on one seeded graph -----------------------------------------

N_NODES, N_EDGES, SEED = 200, 800, 20241
PR_RTOL, PR_ATOL = 1e-5, 1e-9
LP_RTOL, LP_ATOL = 1e-6, 1e-6


def _seeded_graph(pkg, n=N_NODES, m=N_EDGES, seed=SEED):
    """``n`` nodes (labels P or Q, a name, lat/lon) and ``m`` directed
    edges (types R or S, an integer cost, self-loops and duplicates kept)
    from ``seed``, built through ``pkg``'s storage API with fixed ids."""
    rng = np.random.default_rng(seed)
    eng = pkg.storage.MemoryEngine()
    for i in range(n):
        eng.create_node(pkg.storage.Node(
            id=f"n{i:03d}", labels=["P" if i % 3 else "Q"],
            properties={"name": f"n{i}", "lat": float(rng.uniform(59, 60)),
                        "lon": float(rng.uniform(10, 11))}))
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    for k, (a, b) in enumerate(zip(src, dst)):
        eng.create_edge(pkg.storage.Edge(
            id=f"e{k:04d}", start_node=f"n{a:03d}", end_node=f"n{b:03d}",
            type="R" if k % 4 else "S",
            properties={"cost": int(rng.integers(1, 10))}))
    return eng


def _executors(n=N_NODES, m=N_EDGES, seed=SEED):
    from nornicdb_tpu.cypher.executor import CypherExecutor as JaxExecutor
    from nornicdb_tpu.storage.schema import SchemaManager as JaxSchema

    jeng = _seeded_graph(nornicdb_tpu, n, m, seed)
    peng = _seeded_graph(nornicdb_tpu_torch, n, m, seed)
    js, ps = JaxSchema(), SchemaManager()
    js.attach(jeng)
    ps.attach(peng)
    return JaxExecutor(jeng, schema=js), CypherExecutor(peng, schema=ps)


def _norm(v):
    """Entities by id, paths by their entities' ids, numpy scalars as
    Python numbers."""
    if hasattr(v, "labels") and hasattr(v, "properties"):
        return ("node", v.id)
    if hasattr(v, "start_node") and hasattr(v, "properties"):
        return ("edge", v.id)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    return v


def _run(ex, q):
    r = ex.execute(q)
    return list(r.columns), _norm(r.rows)


# (query, exact): exact=False holds the float column (PageRank) within
# PR_RTOL / PR_ATOL, everything else is equal exactly
SAME = [
    "CALL gds.wcc.stream()",
    "CALL gds.scc.stream()",
    "CALL gds.labelPropagation.stream({maxIterations: 7})",
    "CALL gds.louvain.stream()",
    "CALL gds.triangleCount.stream()",
    "CALL gds.localClusteringCoefficient.stream()",
    "CALL gds.degree.stream()",
    "CALL gds.degree.stream({orientation: 'NATURAL'})",
    "CALL gds.degree.stream({orientation: 'REVERSE'})",
    "CALL gds.closeness.stream()",
    "CALL gds.betweenness.stream()",
    "CALL gds.kcore.stream()",
    "CALL gds.graph.density()",
    "CALL gds.modularity({n000: 1, n001: 1, n002: 2, n003: 2})",
    "CALL gds.linkPrediction.adamicAdar('n000', 'n005')",
    "CALL gds.linkPrediction.commonNeighbors('n001', 'n007')",
    "CALL gds.linkPrediction.jaccard('n002', 'n009')",
    "CALL gds.linkPrediction.preferentialAttachment('n003', 'n004')",
    "CALL gds.linkPrediction.resourceAllocation('n010', 'n020')",
    "CALL gds.linkPrediction.adamicAdar.stream({sourceNode: 'n000', topK: 10})",
    "CALL gds.linkPrediction.commonNeighbors.stream({sourceNode: 'n011', "
    "topK: 10})",
    "CALL gds.linkPrediction.jaccard.stream({sourceNode: 'n012', topK: 10})",
    "CALL gds.linkPrediction.preferentialAttachment.stream({sourceNode: "
    "'n013', topK: 10})",
    "CALL gds.linkPrediction.resourceAllocation.stream({sourceNode: 'n014', "
    "topK: 10})",
    "CALL gds.linkPrediction.predict.stream({sourceNode: 'n015', topK: 5, "
    "algorithm: 'common_neighbors', topologyWeight: 1.0})",
    "CALL gds.fastRP.stream({embeddingDimension: 32, randomSeed: 7})",
    "CALL gds.fastRP.stats('g', {embeddingDimension: 32})",
    "CALL gds.shortestPath.dijkstra.stream('n000', 'n150', "
    "{relationshipWeightProperty: 'cost'})",
    "CALL gds.shortestPath.dijkstra.stream('n001', 'n199', "
    "{orientation: 'UNDIRECTED'})",
    "CALL gds.shortestPath.astar.stream('n002', 'n120', "
    "{latitudeProperty: 'lat', longitudeProperty: 'lon'})",
    "CALL gds.version()",
    "CALL apoc.algo.wcc()",
    "CALL apoc.algo.betweenness()",
    "CALL apoc.algo.closeness()",
    "CALL apoc.algo.community()",
    "CALL apoc.algo.louvain(['Q'])",
    "CALL apoc.algo.labelPropagation()",
    "CALL apoc.algo.dijkstra('n000', 'n150', 'R', 'cost')",
    "CALL apoc.algo.aStar('n003', 'n140', 'R|S', 'cost')",
    "CALL apoc.algo.allSimplePaths('n000', 'n001', 'R', 2)",
    "CALL apoc.neighbors.byhop('n004', 'R', 2)",
    "MATCH (n:Q) WITH collect(n) AS ns "
    "RETURN apoc.algo.degreeCentrality(ns) AS d",
    "MATCH (n:Q) WITH collect(n) AS ns "
    "RETURN apoc.algo.closenessCentrality(ns) AS c",
    "MATCH (n:Q) WITH collect(n) AS ns "
    "RETURN apoc.algo.betweennessCentrality(ns) AS b",
    "MATCH (n:Q) WITH collect(n) AS ns RETURN apoc.algo.community(ns) AS c",
    "MATCH (n) WITH collect(n) AS ns "
    "RETURN apoc.community.weaklyConnectedComponents(ns) AS c",
]

RANKED = [
    "CALL gds.pageRank.stream({maxIterations: 20, dampingFactor: 0.85})",
    "CALL gds.pageRank.stream({maxIterations: 5, dampingFactor: 0.5})",
    "CALL apoc.algo.pageRank()",
]


@pytest.fixture(scope="module")
def both():
    return _executors()


class TestBothPackages:
    @pytest.mark.parametrize("query", SAME)
    def test_same_rows(self, both, query):
        jex, pex = both
        got, want = _run(pex, query), _run(jex, query)
        assert got == want
        assert want[1], query  # the graph gives every call rows

    @pytest.mark.parametrize("query", RANKED)
    def test_pagerank_rows(self, both, query):
        jex, pex = both
        (gc, got), (wc, want) = _run(pex, query), _run(jex, query)
        assert gc == wc == ["node", "score"]
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                                   rtol=PR_RTOL, atol=PR_ATOL)

    def test_pagerank_function(self, both):
        jex, pex = both
        q = ("MATCH (n:P) WITH collect(n) AS ns "
             "RETURN apoc.algo.pageRank(ns) AS r")
        got, want = _run(pex, q)[1][0][0], _run(jex, q)[1][0][0]
        assert sorted(got) == sorted(want) and len(got) > 100
        np.testing.assert_allclose([got[k] for k in sorted(got)],
                                   [want[k] for k in sorted(want)],
                                   rtol=PR_RTOL, atol=PR_ATOL)

    def test_graph_catalog(self, both):
        for ex in both:
            for name in ("g1", "g2"):
                ex.execute(f"CALL gds.graph.project('{name}', 'P', 'R')")
        steps = ["CALL gds.graph.list()", "CALL gds.graph.list('g1')",
                 "CALL gds.graph.exists('g2')", "CALL gds.graph.drop('g1')",
                 "CALL gds.graph.exists('g1')", "CALL gds.graph.list()",
                 "CALL gds.graph.drop('g2')"]
        jex, pex = both
        for q in steps:
            assert _run(pex, q) == _run(jex, q)

    @pytest.mark.parametrize("method", ["commonNeighbors", "adamicAdar",
                                        "jaccard", "resourceAllocation",
                                        "preferentialAttachment"])
    def test_suggest_against_the_numpy_branch(self, both, method,
                                              monkeypatch):
        """n = 200 >= 64: the port's GEMMs run on ``ex.device`` (the CPU
        here). JAX's device branch raises on its read-only product for the
        three methods whose product it fills the diagonal of in place
        (ROADMAP §C), so every answer is held against its numpy branch."""
        from nornicdb_tpu.linkpredict import topology as jtopo

        jex, pex = both
        q = (f"CALL gds.linkPrediction.suggest('{method}', 25) "
             "YIELD node1, node2, score RETURN node1, node2, score")
        got = _run(pex, q)[1]
        if method in ("commonNeighbors", "adamicAdar", "resourceAllocation"):
            with pytest.raises(ValueError):
                jex.execute(q)
        numpy_scores = jtopo.batch_scores
        monkeypatch.setattr(
            jtopo, "batch_scores",
            lambda g, m: numpy_scores(g, m, use_device=False))
        want = _run(jex, q)[1]
        assert len(got) == len(want) == 25
        for g, w in zip(got, want):
            assert g[2] == pytest.approx(w[2], rel=LP_RTOL, abs=LP_ATOL)
        cut = want[-1][2] + LP_ATOL + LP_RTOL * abs(want[-1][2])
        pairs = lambda rows: {(r[0][1], r[1][1]) for r in rows if r[2] > cut}
        assert pairs(got) == pairs(want)


# -- the device policy ----------------------------------------------------------

GATED = [
    "CALL gds.pageRank.stream({maxIterations: 20})",
    "CALL gds.wcc.stream()",
    "CALL apoc.algo.pageRank()",
    "CALL apoc.algo.wcc()",
    "CALL gds.linkPrediction.suggest('adamicAdar', 5)",
    "MATCH (n) RETURN apoc.algo.pageRank(collect(n))",
    "MATCH (n) WITH collect(n) AS ns "
    "RETURN apoc.community.weaklyConnectedComponents(ns)",
]


class TestDevicePolicy:
    @pytest.fixture(autouse=True)
    def _stop(self):
        self._live = []
        yield
        for m in self._live:
            m.stop()

    def _mgr(self, mode, **kw):
        mgr = BackendManager(hooks=FakeHooks(mode), acquire_timeout=0.3,
                             probe_interval=0.03, probe_timeout=0.25, **kw)
        self._live.append(mgr)
        return mgr

    def _ex(self, **kw):
        eng = _seeded_graph(nornicdb_tpu_torch, n=80, m=320)
        return eng, CypherExecutor(eng, **kw)

    @pytest.mark.parametrize("query", GATED)
    def test_hung_owner_refuses_within_the_bound(self, query):
        mgr = self._mgr("hang")
        _, ex = self._ex(backend=mgr)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            ex.execute(query)
        assert time.perf_counter() - t0 < mgr.acquire_timeout + 1.0

    def test_host_algorithms_need_no_owner(self):
        """Only the device work passes the gate: the host algorithms
        answer while the owner hangs, as JAX's do."""
        _, ex = self._ex(backend=self._mgr("hang"))
        assert len(ex.execute("CALL gds.scc.stream()").rows) == 80
        assert len(ex.execute("CALL gds.fastRP.stream({embeddingDimension: "
                              "8})").rows) == 80

    def test_small_suggest_needs_no_owner(self):
        """Below 64 nodes ``batch_scores`` takes numpy's branch (JAX's own
        rule): no device work, so no gate."""
        eng = _seeded_graph(nornicdb_tpu_torch, n=40, m=160)
        ex = CypherExecutor(eng, backend=self._mgr("hang"))
        jex, _ = _executors(n=40, m=160)
        q = "CALL gds.linkPrediction.suggest('commonNeighbors', 5)"
        assert _run(ex, q) == _run(jex, q)

    def test_recovered_owner_serves_again(self):
        mgr = self._mgr("hang", recover_after=1)
        _, ex = self._ex(backend=mgr)
        _, ref = self._ex()
        q = "CALL gds.pageRank.stream({maxIterations: 20})"
        with pytest.raises(DeviceUnavailable):
            ex.execute(q)
        mgr.hooks.set_mode("ok")
        deadline = time.monotonic() + 10
        while not mgr.ready() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mgr.ready(), mgr.state
        assert _run(ex, q) == _run(ref, q)

    @pytest.mark.parametrize("query", GATED[:4] + GATED[5:])
    def test_device_errors_propagate(self, query, monkeypatch):
        """A device error reaches the caller: nothing retries the work on
        the host."""
        from nornicdb_tpu_torch.ops import graph_algos as tga

        def boom(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(tga, "pagerank_device", boom)
        monkeypatch.setattr(tga, "wcc_device", boom)
        _, ex = self._ex()
        with pytest.raises(RuntimeError, match="CUDA error"):
            ex.execute(query)

    def test_suggest_gemm_error_propagates(self, monkeypatch):
        import torch

        def boom(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

        _, ex = self._ex()
        monkeypatch.setattr(torch, "matmul", boom)
        with pytest.raises(RuntimeError, match="CUDA error"):
            ex.execute("CALL gds.linkPrediction.suggest('adamicAdar', 5)")

    def test_suggest_runs_on_the_executor_device(self, monkeypatch):
        from nornicdb_tpu_torch.linkpredict import topology as ttopo

        seen = []
        real = ttopo._full_precision_matmul

        def spy(dev):
            seen.append(dev)
            return real(dev)

        monkeypatch.setattr(ttopo, "_full_precision_matmul", spy)
        _, ex = self._ex()
        ex.execute("CALL gds.linkPrediction.suggest('adamicAdar', 5)")
        assert [d.type for d in seen] == ["cpu"]

    def test_cuda_executor_without_a_card_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the CUDA executor serves")
        with pytest.raises(DeviceUnavailable):
            _PortExecutor(MemoryEngine())
