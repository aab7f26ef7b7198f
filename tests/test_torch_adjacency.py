"""The port's CSR adjacency snapshot (``nornicdb_tpu_torch.storage.adjacency``)
against the JAX package's, and the consumers it feeds.

Seeded op sequences with mutations (retypes, node deletes that cascade,
resurrection of a deleted id, delete-then-recreate of an edge id before a
flush), through bare engines and through the async overlay, go through
twin engines of both packages; every read of the snapshot API
(``expand_pairs``, ``expand_frontier``, ``bfs_distances``, ``csr_view``,
``export_arrays``, ``edge_arrays``, ``graph_view``) must agree.
``build_graph``'s snapshot branch must equal its scan branch. The cases
of ``tests/test_adjacency.py`` run against the port, its Cypher
equivalence suite (the CSR path against the engine-scan path, through the
matcher and the GDS procedures) included, with the executor on the CPU,
and ``TestStatsSurfacing`` through the port's HTTP server.
"""

import threading
import time
import types

import numpy as np
import pytest

import nornicdb_tpu.storage as jax_storage
from nornicdb_tpu.linkpredict import build_graph as jax_build_graph
import nornicdb_tpu_torch.storage as port_storage
from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.linkpredict import build_graph
from nornicdb_tpu_torch.ops import graph_algos
from nornicdb_tpu_torch.storage import MemoryEngine, attach_snapshot
from nornicdb_tpu_torch.storage.adjacency import AdjacencySnapshot
from nornicdb_tpu_torch.storage.types import Edge, Node


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


# ---- cases of tests/test_adjacency.py, against the port
def _populate(engines, n_people=14, seed=5):
    """Deterministic social graph applied identically to every engine."""
    rng = np.random.default_rng(seed)
    for eng in engines:
        for i in range(n_people):
            eng.create_node(Node(id=f"p{i}", labels=["Person"],
                                 properties={"k": i, "name": f"P{i:02d}"}))
    k = 0
    edges = []
    for i in range(n_people):
        for j in rng.choice(n_people, size=3, replace=False):
            edges.append((f"e{k}", f"p{i}", f"p{int(j)}",
                          "KNOWS" if k % 3 else "LIKES"))
            k += 1
    for eng in engines:
        for eid, s, d, t in edges:
            eng.create_edge(Edge(id=eid, start_node=s, end_node=d, type=t))
    return k  # next edge serial


class Twins:
    """Fast executor (CSR snapshot) and slow executor (engine-scan paths
    forced) over identical engines; every mutation is applied to both."""

    def __init__(self, n_people=14, seed=5):
        self.fast_eng = MemoryEngine()
        self.slow_eng = MemoryEngine()
        self.serial = _populate([self.fast_eng, self.slow_eng],
                                n_people, seed)
        self.fast = CypherExecutor(self.fast_eng)
        self.slow = CypherExecutor(self.slow_eng)
        # force every engine-scan fallback on the slow twin
        self.slow.matcher._snapshot = False
        self.slow._adj_snapshot_cache = False
        self.snap = attach_snapshot(self.fast_eng)
        assert self.snap.ensure()

    def both(self, fn):
        fn(self.fast_eng)
        fn(self.slow_eng)

    def add_edge(self, s, d, t="KNOWS"):
        eid = f"e{self.serial}"
        self.serial += 1
        self.both(lambda e: e.create_edge(
            Edge(id=eid, start_node=s, end_node=d, type=t)))
        return eid

    def del_edge(self, eid):
        self.both(lambda e: e.delete_edge(eid))

    def retype_edge(self, eid, new_type):
        def upd(eng):
            e = eng.get_edge(eid)
            e.type = new_type
            eng.update_edge(e)
        self.both(upd)

    def add_node(self, nid, labels=("Person",)):
        k = int(nid.lstrip("p")) if nid.lstrip("p").isdigit() else 99
        self.both(lambda e: e.create_node(
            Node(id=nid, labels=list(labels),
                 properties={"k": k, "name": nid})))

    def del_node(self, nid):
        self.both(lambda e: e.delete_node(nid))

    def assert_rows_equal(self, query, params=None):
        f = self.fast.execute(query, params or {}).rows
        s = self.slow.execute(query, params or {}).rows
        assert f == s, f"{query}\nfast={f}\nslow={s}"

    def assert_close(self, query, params=None):
        f = self.fast.execute(query, params or {}).rows
        s = self.slow.execute(query, params or {}).rows
        assert len(f) == len(s), query
        for rf, rs in zip(sorted(f), sorted(s)):
            np.testing.assert_allclose(rf[1:], rs[1:], rtol=1e-5,
                                       atol=1e-6, err_msg=query)
            assert rf[0] == rs[0], query

    def assert_partition_equal(self, query):
        """Community/component labels are arbitrary ids: compare the
        induced partitions, not the raw values."""
        def parts(rows):
            groups = {}
            for nid, label in rows:
                groups.setdefault(label, set()).add(nid)
            return sorted(frozenset(g) for g in groups.values())
        f = self.fast.execute(query).rows
        s = self.slow.execute(query).rows
        assert parts(f) == parts(s), query


MATCH_QUERIES = [
    # var-length, typed and untyped, directed and not, zero-length
    "MATCH (a:Person {k: 0})-[:KNOWS*1..3]->(b) RETURN b.k ORDER BY b.k",
    "MATCH (a:Person {k: 2})-[:KNOWS|LIKES*1..2]-(b) RETURN count(*)",
    "MATCH (a:Person {k: 1})-[r:KNOWS*2]->(b:Person) "
    "RETURN size(r), b.k ORDER BY b.k",
    "MATCH p = (a:Person {k: 3})-[:KNOWS*0..2]->(b) "
    "RETURN length(p), b.k ORDER BY length(p), b.k",
    # plain expansion riding the snapshot one-hop path
    "MATCH (a:Person {k: 4})-[:KNOWS]->(b) RETURN b.k ORDER BY b.k",
    # bound target: both endpoints fixed before the var-length expansion
    "MATCH (a:Person {k: 0}), (b:Person {k: 9}) "
    "MATCH (a)-[*1..3]->(b) RETURN count(*)",
    # shortest paths
    "MATCH p = shortestPath((a:Person {k: 0})-[*..6]->(b:Person {k: 9})) "
    "RETURN length(p), [n IN nodes(p) | n.k]",
    "MATCH p = shortestPath((a:Person {k: 5})-[:KNOWS*..8]-(b:Person {k: 11})) "
    "RETURN length(p)",
    "MATCH p = allShortestPaths((a:Person {k: 1})-[*..5]->(b:Person {k: 8})) "
    "RETURN length(p), [n IN nodes(p) | n.k] ORDER BY 2",
]

GDS_FLOAT_QUERIES = [
    "CALL gds.pagerank.stream() YIELD node, score RETURN node.k, score",
    "CALL gds.degree.stream({orientation: 'NATURAL'}) "
    "YIELD node, score RETURN node.k, score",
    "CALL gds.closeness.stream() YIELD node, score RETURN node.k, score",
    "CALL gds.betweenness.stream() YIELD node, score RETURN node.k, score",
    "CALL gds.localclusteringcoefficient.stream() "
    "YIELD node, localClusteringCoefficient AS c RETURN node.k, c",
]

GDS_EXACT_QUERIES = [
    "CALL gds.trianglecount.stream() YIELD node, triangleCount "
    "RETURN node.k, triangleCount ORDER BY node.k",
    "CALL gds.kcore.stream() YIELD node, coreValue "
    "RETURN node.k, coreValue ORDER BY node.k",
    "CALL gds.graph.density() YIELD density RETURN density",
]

GDS_PARTITION_QUERIES = [
    "CALL gds.wcc.stream() YIELD node, componentId RETURN node.k, componentId",
    "CALL gds.scc.stream() YIELD node, componentId RETURN node.k, componentId",
    "CALL gds.labelpropagation.stream() YIELD node, communityId "
    "RETURN node.k, communityId",
    "CALL gds.louvain.stream() YIELD node, communityId "
    "RETURN node.k, communityId",
]

LINKPRED_QUERIES = [
    "CALL gds.linkprediction.adamicadar('p0', 'p7') YIELD score RETURN score",
    "CALL gds.linkprediction.jaccard('p2', 'p9') YIELD score RETURN score",
    "CALL gds.linkprediction.commonneighbors('p1', 'p5') "
    "YIELD score RETURN score",
    "CALL gds.linkprediction.preferentialattachment('p3', 'p8') "
    "YIELD score RETURN score",
    "CALL gds.linkprediction.resourceallocation('p0', 'p11') "
    "YIELD score RETURN score",
    "CALL gds.linkprediction.suggest('adamicAdar', 5) "
    "YIELD node1, node2, score RETURN node1.name, node2.name, score",
]


class TestEquivalence:
    """CSR path vs engine-scan path: identical results, including under
    interleaved create / retype / delete mutations of edges and nodes."""

    def _check_all(self, tw: Twins):
        for q in MATCH_QUERIES:
            tw.assert_rows_equal(q)
        for q in GDS_FLOAT_QUERIES:
            tw.assert_close(q)
        for q in GDS_EXACT_QUERIES:
            tw.assert_rows_equal(q)
        for q in GDS_PARTITION_QUERIES:
            tw.assert_partition_equal(q)
        for q in LINKPRED_QUERIES:
            tw.assert_rows_equal(q)

    def test_equivalence_under_mutations(self):
        tw = Twins()
        self._check_all(tw)

        # round 1: adds (delta-buffer path, no merge)
        e_new = tw.add_edge("p0", "p9", "KNOWS")
        tw.add_edge("p9", "p12", "LIKES")
        self._check_all(tw)

        # round 2: deletes (CSR tombstones) incl. a delta-buffered edge
        tw.del_edge(e_new)
        tw.del_edge("e1")
        self._check_all(tw)

        # round 3: type update (remove+add in the snapshot)
        tw.retype_edge("e4", "LIKES")
        self._check_all(tw)

        # round 4: node churn — cascade deletes + a new node wired in
        tw.del_node("p13")
        tw.add_node("p14")
        tw.add_edge("p14", "p0", "KNOWS")
        tw.add_edge("p6", "p14", "KNOWS")
        self._check_all(tw)

        # round 5: force a delta merge, then verify again
        tw.snap.merge_threshold = 1
        assert tw.snap.ensure()
        assert tw.snap.stats_snapshot()["delta_merges"] >= 1
        self._check_all(tw)

    def test_equivalence_after_node_resurrection(self):
        tw = Twins()
        tw.del_node("p3")
        tw.add_node("p3")
        tw.add_edge("p3", "p0", "KNOWS")
        self._check_all(tw)

    def test_breadth_cap_falls_back_to_generic_walk(self, monkeypatch):
        """Past MAX_BATCHED_PATHS live partial paths the batched walk hands
        the query to the lazy generic DFS — results stay identical."""
        from nornicdb_tpu_torch.cypher import matcher as matcher_mod

        tw = Twins()
        monkeypatch.setattr(matcher_mod, "MAX_BATCHED_PATHS", 4)
        for q in MATCH_QUERIES:
            tw.assert_rows_equal(q)



class CountingEngine(MemoryEngine):
    """MemoryEngine that counts full-scan calls."""

    def __init__(self):
        super().__init__()
        self.all_edges_calls = 0
        self.all_node_ids_calls = 0

    def all_edges(self):
        self.all_edges_calls += 1
        return super().all_edges()

    def all_node_ids(self):
        self.all_node_ids_calls += 1
        return super().all_node_ids()


class RacingEngine(MemoryEngine):
    """Injects a concurrent-looking write during the snapshot's build scan
    (between its epoch read and its install)."""

    def __init__(self, inject: int):
        super().__init__()
        self.inject = inject
        self._n_injected = 0

    def all_edges(self):
        if self.inject > 0:
            self.inject -= 1
            self._n_injected += 1
            self.create_edge(Edge(id=f"racer{self._n_injected}",
                                  start_node="p0", end_node="p1",
                                  type="KNOWS"))
        return super().all_edges()


class TestEpochRetry:
    def test_mid_build_event_retries_and_lands_the_write(self):
        eng = RacingEngine(inject=1)
        _populate([eng], n_people=4)
        snap = attach_snapshot(eng)
        assert snap.ensure()
        s = snap.stats_snapshot()
        assert s["epoch_retries"] == 1
        assert s["builds"] == 1
        # the write that interrupted the first attempt is in the snapshot
        pairs = snap.expand_pairs("p0", "out", ["KNOWS"])
        assert any(eid == "racer1" for eid, _ in pairs)

    def test_persistent_interference_falls_back(self):
        eng = RacingEngine(inject=10)  # every attempt sees a mid-scan write
        _populate([eng], n_people=4)
        snap = attach_snapshot(eng)
        assert not snap.ensure()
        assert not snap.ready()
        assert snap.stats_snapshot()["epoch_retries"] == 3
        # consumers fall back to the engine-scan path and stay correct
        # (the matcher's fallback is a Cypher case; here build_graph's)
        g = build_graph(eng)
        assert g.n == 4
        assert sum(len(s) for s in g.neighbors) > 0


class TestDeltaMerge:
    def test_merge_threshold_folds_delta(self):
        eng = MemoryEngine()
        for i in range(12):
            eng.create_node(Node(id=f"n{i}"))
        for i in range(11):
            eng.create_edge(Edge(id=f"e{i}", start_node=f"n{i}",
                                 end_node=f"n{i+1}", type="R"))
        snap = AdjacencySnapshot(eng, merge_threshold=4)
        assert snap.ensure()
        for i in range(4):  # at threshold: buffered, not merged
            eng.create_edge(Edge(id=f"x{i}", start_node=f"n{i}",
                                 end_node=f"n{i+2}", type="R"))
        assert snap.ensure()
        assert snap.stats_snapshot()["delta_merges"] == 0
        assert snap.stats_snapshot()["delta_pending"] == 4
        eng.create_edge(Edge(id="x4", start_node="n4", end_node="n6",
                             type="R"))
        assert snap.ensure()  # crosses the threshold: folds into CSR
        s = snap.stats_snapshot()
        assert s["delta_merges"] == 1
        assert s["delta_pending"] == 0
        assert s["merged_edges"] == 5
        assert s["edges"] == 16
        # post-merge expansion still correct
        assert ("x4", "n6") in snap.expand_pairs("n4", "out")

    def test_attach_retunes_existing_snapshot_threshold(self):
        """Consumers auto-attach with the default; a later explicit
        attach_snapshot(engine, merge_threshold=...) must re-tune the
        live snapshot, not silently drop the operator's setting."""
        eng = MemoryEngine()
        snap = attach_snapshot(eng)
        assert snap.merge_threshold == 4096
        assert attach_snapshot(eng, merge_threshold=256) is snap
        assert snap.merge_threshold == 256
        assert attach_snapshot(eng) is snap  # no-arg attach leaves it alone
        assert snap.merge_threshold == 256

    def test_expansion_only_reads_also_fold_delta(self):
        """Workloads whose reads never call ensure() (one-hop expansions,
        edge_arrays views) must still fold an over-threshold delta — the
        overlay is bounded on every read entry point."""
        eng = MemoryEngine()
        for i in range(8):
            eng.create_node(Node(id=f"n{i}"))
        eng.create_edge(Edge(id="seed", start_node="n0", end_node="n1",
                             type="R"))
        snap = AdjacencySnapshot(eng, merge_threshold=3)
        assert snap.ensure()
        for i in range(5):  # past the threshold, no ensure() afterwards
            eng.create_edge(Edge(id=f"d{i}", start_node="n0",
                                 end_node=f"n{i + 2}", type="R"))
        assert len(snap.expand_pairs("n0", "out")) == 6
        s = snap.stats_snapshot()
        assert s["delta_merges"] == 1
        assert s["delta_pending"] == 0

    def test_concurrent_writers_during_queries(self):
        """Writers mutating while readers expand: no exceptions, and the
        final snapshot state converges to the engine's."""
        eng = MemoryEngine()
        for i in range(30):
            eng.create_node(Node(id=f"n{i}"))
        for i in range(29):
            eng.create_edge(Edge(id=f"e{i}", start_node=f"n{i}",
                                 end_node=f"n{i+1}", type="R"))
        snap = AdjacencySnapshot(eng, merge_threshold=8)
        assert snap.ensure()
        errors = []
        stop = threading.Event()

        def writer(t):
            try:
                for i in range(60):
                    eid = f"w{t}-{i}"
                    eng.create_edge(Edge(id=eid, start_node=f"n{t}",
                                         end_node=f"n{(t + i) % 30}",
                                         type="R"))
                    if i % 3 == 0:
                        eng.delete_edge(eid)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        def reader():
            try:
                while not stop.is_set():
                    snap.ensure()
                    snap.expand_pairs("n0", "both")
                    snap.edge_arrays()
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        ts = [threading.Thread(target=writer, args=(t,)) for t in range(3)]
        rs = [threading.Thread(target=reader) for _ in range(2)]
        for t in ts + rs:
            t.start()
        for t in ts:
            t.join()
        stop.set()
        for t in rs:
            t.join()
        assert not errors
        view = snap.edge_arrays()
        assert len(view.src) == eng.edge_count()
        # exact same edge multiset as the engine
        engine_pairs = sorted((e.start_node, e.end_node)
                              for e in eng.all_edges())
        snap_pairs = sorted((view.ids[s], view.ids[d])
                            for s, d in zip(view.src, view.dst))
        assert engine_pairs == snap_pairs


class TestAsyncChainEvents:
    def test_snapshot_stays_fresh_through_async_overlay(self):
        """The AsyncEngine tombstones edge deletes until flush; the
        snapshot must see them at write time — including an edge created
        and deleted before it ever flushed."""
        from nornicdb_tpu_torch.storage import AsyncEngine

        eng = AsyncEngine(MemoryEngine(), flush_interval=3600.0)
        try:
            for nid in ("a", "b", "c"):
                eng.create_node(Node(id=nid))
            eng.create_edge(Edge(id="ab", start_node="a", end_node="b",
                                 type="R"))
            eng.flush()
            snap = attach_snapshot(eng)
            assert snap.ensure()
            # created + deleted entirely inside the overlay window
            eng.create_edge(Edge(id="bc", start_node="b", end_node="c",
                                 type="R"))
            assert snap.expand_pairs("b", "out") == [("bc", "c")]
            eng.delete_edge("bc")
            assert snap.expand_pairs("b", "out") == []
            # tombstoned (pre-existing) delete is visible before flush
            eng.delete_edge("ab")
            assert snap.expand_pairs("a", "out") == []
            eng.flush()  # the base replay must not double-apply
            assert snap.expand_pairs("a", "out") == []
            assert eng.edge_count() == 0
        finally:
            eng.close()

    def test_delete_then_recreate_same_id_before_flush(self):
        """A create overwriting a same-id tombstone must survive the flush
        (applied as an update — the delete never reached the base), clear
        the delete's flush-replay suppression, and leave the snapshot
        serving the recreated edge."""
        from nornicdb_tpu_torch.storage import AsyncEngine

        eng = AsyncEngine(MemoryEngine(), flush_interval=3600.0)
        try:
            for nid in ("a", "b", "c"):
                eng.create_node(Node(id=nid))
            eng.create_edge(Edge(id="ab", start_node="a", end_node="b",
                                 type="R"))
            eng.flush()
            snap = attach_snapshot(eng)
            assert snap.ensure()
            eng.delete_edge("ab")  # tombstone + write-time delete event
            eng.create_edge(Edge(id="ab", start_node="a", end_node="c",
                                 type="R"))
            assert snap.expand_pairs("a", "out") == [("ab", "c")]
            eng.flush()
            assert eng.get_edge("ab").end_node == "c"  # not a lost write
            # the recreated edge's eventual real delete must reach listeners
            events = []
            eng.on_event(lambda k, e: events.append((k, e.id)))
            eng.delete_edge("ab")
            eng.flush()
            assert events.count(("edge_deleted", "ab")) == 1
            assert snap.expand_pairs("a", "out") == []
        finally:
            eng.close()


# ---------------------------------------------------------------- microbench
@pytest.mark.slow
class TestMicrobench:
    def test_frontier_batched_bfs_vs_engine_calls(self):
        """~100k nodes / 500k edges: full BFS via the CSR snapshot's
        frontier-batched gathers vs the per-node engine-call path the
        matcher used before. Asserts >= 5x and prints the ratio."""
        n, m = 100_000, 500_000
        eng = MemoryEngine()
        for i in range(n):
            eng.create_node(Node(id=f"n{i}"))
        rng = np.random.default_rng(11)
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)
        for i in range(m):
            eng.create_edge(Edge(id=f"e{i}", start_node=f"n{src[i]}",
                                 end_node=f"n{dst[i]}", type="R"))
        snap = attach_snapshot(eng)
        assert snap.ensure()

        def engine_bfs(start: str) -> dict[str, int]:
            dist = {start: 0}
            frontier = [start]
            while frontier:
                nxt = []
                for nid in frontier:
                    for direction in ("out", "in"):
                        for _eid, _t, other in eng.iter_adjacency(
                                nid, direction):
                            if other not in dist:
                                dist[other] = dist[nid] + 1
                                nxt.append(other)
                frontier = nxt
            return dist

        sources = ["n0", "n1", "n2"]
        t0 = time.perf_counter()
        engine_out = [engine_bfs(s) for s in sources]
        t_engine = time.perf_counter() - t0

        t0 = time.perf_counter()
        snap_out = [snap.bfs_distances(s, "both") for s in sources]
        t_snap = time.perf_counter() - t0

        # identical reachability and distances
        for ref, got in zip(engine_out, snap_out):
            reached = np.nonzero(got >= 0)[0]
            assert len(ref) == len(reached)
            for i in reached.tolist():
                assert ref[snap.id_of(i)] == int(got[i])

        ratio = t_engine / max(t_snap, 1e-9)
        print(f"\nBFS microbench ({n} nodes / {m} edges, "
              f"{len(sources)} sources): engine-call path "
              f"{t_engine:.3f}s, frontier-batched {t_snap:.3f}s, "
              f"ratio {ratio:.1f}x")
        assert ratio >= 5.0


class TestGenerationInvalidation:
    def test_pagerank_sees_count_neutral_topology_change(self):
        """Regression: the old `_edge_arrays` cache keyed on (node_count,
        edge_count) served stale topology when a CREATE+DELETE pair left
        the counts unchanged. The generation-tagged snapshot must not."""
        eng = MemoryEngine()
        for nid in ("a", "b", "c"):
            eng.create_node(Node(id=nid, labels=["T"]))
        eng.create_edge(Edge(id="ab", start_node="a", end_node="b", type="R"))
        ex = CypherExecutor(eng)
        q = ("CALL gds.pagerank.stream() YIELD node, score "
             "RETURN node.id, score ORDER BY node.id")
        before = ex.execute(q).rows
        # count-neutral mutation: +1 edge, -1 edge
        eng.create_edge(Edge(id="bc", start_node="b", end_node="c", type="R"))
        eng.delete_edge("ab")
        after = ex.execute(q).rows
        assert after != before
        # ground truth: a fresh executor over an identical engine
        eng2 = MemoryEngine()
        for nid in ("a", "b", "c"):
            eng2.create_node(Node(id=nid, labels=["T"]))
        eng2.create_edge(Edge(id="bc", start_node="b", end_node="c", type="R"))
        expected = CypherExecutor(eng2).execute(q).rows
        for (ida, sa), (idb, sb) in zip(after, expected):
            assert ida == idb
            assert sa == pytest.approx(sb)

    def test_unchanged_graph_reuses_arrays(self):
        """Repeated calls on an unchanged graph get the *same* array
        objects back (generation tag unchanged); a count-neutral
        mutation moves the generation."""
        eng = MemoryEngine()
        for nid in ("a", "b", "c"):
            eng.create_node(Node(id=nid))
        eng.create_edge(Edge(id="ab", start_node="a", end_node="b", type="R"))
        snap = attach_snapshot(eng)
        assert snap.ensure()
        v1 = snap.edge_arrays()
        assert v1 is snap.edge_arrays()
        g1 = snap.graph_view()
        assert g1 is snap.graph_view()
        gen = snap.generation()
        eng.create_edge(Edge(id="bc", start_node="b", end_node="c", type="R"))
        eng.delete_edge("ab")
        assert snap.generation() != gen
        v2 = snap.edge_arrays()
        assert v2 is not v1
        assert [(v2.ids[s], v2.ids[d]) for s, d in zip(v2.src, v2.dst)] \
            == [("b", "c")]


class TestNoRescan:
    def test_no_all_edges_scan_on_repeated_query_paths(self):
        eng = CountingEngine()
        _populate([eng])
        ex = CypherExecutor(eng)
        queries = [
            "CALL gds.pagerank.stream() YIELD node, score RETURN count(*)",
            "CALL gds.wcc.stream() YIELD node, componentId RETURN count(*)",
            "CALL gds.linkprediction.adamicadar('p0', 'p7') "
            "YIELD score RETURN score",
            "MATCH (a:Person {k: 0})-[:KNOWS*1..3]->(b) RETURN count(*)",
            "MATCH p = shortestPath((a:Person {k: 0})-[*..6]->"
            "(b:Person {k: 9})) RETURN length(p)",
        ]
        for q in queries:
            ex.execute(q)
        assert eng.all_edges_calls == 1, "only the first snapshot build scans"
        assert eng.all_node_ids_calls == 1
        # mutations keep the snapshot fresh through events — still no rescan
        eng.create_edge(Edge(id="fresh", start_node="p0", end_node="p9",
                             type="KNOWS"))
        eng.delete_edge("e0")
        for q in queries:
            ex.execute(q)
        assert eng.all_edges_calls == 1
        assert eng.all_node_ids_calls == 1

    def test_no_all_edges_scan_on_repeated_reads(self):
        """The array consumers (edge_arrays, build_graph, bfs) scan the
        engine once, at the snapshot's first build; later mutations reach
        it through events."""
        eng = CountingEngine()
        _populate([eng])
        snap = attach_snapshot(eng)
        for _ in range(2):
            assert snap.ensure()
            snap.edge_arrays()
            build_graph(eng)
            snap.bfs_distances("p0", "both")
            snap.expand_pairs("p0", "out", ["KNOWS"])
            eng.create_edge(Edge(id=f"fresh{_}", start_node="p0",
                                 end_node="p9", type="KNOWS"))
            eng.delete_edge(f"e{_}")
        assert eng.all_edges_calls == 1
        assert eng.all_node_ids_calls == 1


# ---- against the JAX package
PKGS = {"jax": jax_storage, "port": port_storage}


def _mutations(seed: int, n: int = 16, steps: int = 120) -> list:
    """Seeded mutations over ``n`` nodes: edge creates and deletes,
    retypes, node deletes (cascading), resurrection of a deleted node id
    and delete-then-recreate of an edge id."""
    rng = np.random.default_rng(seed)
    ops = [("node", f"v{i}") for i in range(n)]
    live_edges: list[str] = []
    dead_nodes: list[str] = []
    k = 0
    for _ in range(steps):
        r = rng.random()
        if r < 0.45 or not live_edges:
            a, b = (int(x) for x in rng.integers(0, n, 2))
            t = ("KNOWS", "LIKES", "CITES")[int(rng.integers(0, 3))]
            ops.append(("edge", (f"x{k}", f"v{a}", f"v{b}", t)))
            live_edges.append(f"x{k}")
            k += 1
        elif r < 0.65:
            eid = live_edges.pop(int(rng.integers(0, len(live_edges))))
            ops.append(("delete_edge", eid))
            if rng.random() < 0.3:  # same id, new endpoints
                a, b = (int(x) for x in rng.integers(0, n, 2))
                ops.append(("edge", (eid, f"v{a}", f"v{b}", "KNOWS")))
                live_edges.append(eid)
        elif r < 0.8:
            eid = live_edges[int(rng.integers(0, len(live_edges)))]
            ops.append(("retype", (eid, "RETYPED")))
        elif r < 0.9:
            victim = f"v{int(rng.integers(0, n))}"
            ops.append(("delete_node", victim))
            dead_nodes.append(victim)
        elif dead_nodes:
            ops.append(("node", dead_nodes.pop(0)))  # resurrection
    return ops


def _apply(pkg, eng, ops) -> None:
    for op, arg in ops:
        try:
            if op == "node":
                eng.create_node(pkg.Node(id=arg, labels=["V"]))
            elif op == "edge":
                eid, a, b, t = arg
                eng.create_edge(pkg.Edge(id=eid, start_node=a, end_node=b,
                                         type=t))
            elif op == "retype":
                eid, t = arg
                e = eng.get_edge(eid)
                e.type = t
                eng.update_edge(e)
            else:
                getattr(eng, op)(arg)
        except Exception as e:  # missing endpoints etc.: the same in both
            assert type(e).__name__ in ("NotFoundError",
                                        "AlreadyExistsError")


def _reads(snap, probe_ids) -> dict:
    """Every read of the snapshot API, with indices mapped back to ids."""
    out = {"ready": snap.ensure()}
    ids = lambda: [snap.id_of(i) for i in range(len(snap._ids))]  # noqa: E731
    for nid in probe_ids:
        for d in ("out", "in", "both"):
            for t in (None, ["KNOWS"], ["RETYPED", "LIKES"], ["NOPE"]):
                out[("pairs", nid, d, str(t))] = snap.expand_pairs(nid, d, t)
            dist = snap.bfs_distances(nid, d)
            out[("bfs", nid, d)] = None if dist is None else {
                snap.id_of(i): int(dist[i]) for i in np.nonzero(dist >= 0)[0]}
    idxs = [i for i in (snap.index_of(x) for x in probe_ids) if i is not None]
    vocab = ids()
    for d in ("out", "in", "both"):
        adj = snap.expand_frontier(idxs, d, snap.type_codes(["KNOWS"]))
        out[("frontier", d)] = {vocab[i]: [(e, vocab[o]) for e, o in lst]
                                for i, lst in adj.items()}
    v = snap.edge_arrays()
    out["edge_arrays"] = (list(v.ids), v.src.tolist(), v.dst.tolist(),
                          v.type_codes.tolist(), list(v.type_names))
    g = snap.graph_view()
    out["graph"] = (g.ids, [sorted(s) for s in g.neighbors])
    g2 = snap.graph_view(["KNOWS"])
    out["graph_knows"] = [sorted(s) for s in g2.neighbors]
    cv = snap.csr_view()
    out["csr_view"] = None if cv is None else (
        cv.n_csr, list(cv.ids), cv.node_alive.tolist(),
        cv.row_alive.tolist(), cv.erow_type.tolist(), cv.erow_rank.tolist(),
        list(cv.row_ids), dict(cv.type_code),
        {d: [a.tolist() for a in arrs] for d, arrs in cv._csr.items()})
    exp = snap.export_arrays()
    out["export"] = None if exp is None else (
        {k: a.tolist() for k, a in exp[0].items()},
        {k: v for k, v in exp[1].items() if k != "generation"})
    return out


def _scan_graph(eng):
    """build_graph's scan branch: the engine with no snapshot attached."""
    return build_graph(types.SimpleNamespace(all_nodes=eng.all_nodes,
                                             all_edges=eng.all_edges))


class TestSnapshotAgainstJax:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("threshold", [4, 4096])
    def test_bare_engine_reads_match(self, seed, threshold):
        """Build before the mutations (event-maintained, deltas folded at
        a low or the default merge threshold) and compare every read."""
        ops = _mutations(seed)
        snaps, engs = {}, {}
        for name, pkg in PKGS.items():
            eng = pkg.MemoryEngine()
            _apply(pkg, eng, ops[:20])
            snap = pkg.attach_snapshot(eng, merge_threshold=threshold)
            assert snap.ensure()
            _apply(pkg, eng, ops[20:])
            snaps[name], engs[name] = snap, eng
        probe = [f"v{i}" for i in range(16)] + ["absent"]
        got = {name: _reads(s, probe) for name, s in snaps.items()}
        assert got["port"] == got["jax"]
        # and with the engine itself: the snapshot serves its edges
        eng = engs["port"]
        view = snaps["port"].edge_arrays()
        assert sorted(zip((view.ids[s] for s in view.src),
                          (view.ids[d] for d in view.dst))) == sorted(
            (e.start_node, e.end_node) for e in eng.all_edges())

    @pytest.mark.parametrize("seed", range(4))
    def test_async_overlay_reads_match(self, seed):
        """The same through the write-behind overlay, read before and
        after its flush: the snapshot follows the write-time events."""
        ops = _mutations(seed + 100)
        engs, snaps = {}, {}
        for name, pkg in PKGS.items():
            eng = pkg.AsyncEngine(pkg.MemoryEngine(), flush_interval=3600.0)
            _apply(pkg, eng, ops[:20])
            eng.flush()
            snaps[name] = pkg.attach_snapshot(eng)
            assert snaps[name].ensure()
            _apply(pkg, eng, ops[20:])
            engs[name] = eng
        probe = [f"v{i}" for i in range(16)]
        before = {n: _reads(s, probe) for n, s in snaps.items()}
        for eng in engs.values():
            eng.flush()
        after = {n: _reads(s, probe) for n, s in snaps.items()}
        try:
            assert before["port"] == before["jax"]
            assert after["port"] == after["jax"]
            assert after["port"]["edge_arrays"] == \
                before["port"]["edge_arrays"]
        finally:
            for eng in engs.values():
                eng.close()

    @pytest.mark.parametrize("seed", range(4))
    def test_build_graph_snapshot_branch_equals_scan(self, seed):
        eng = MemoryEngine()
        jeng = jax_storage.MemoryEngine()
        ops = _mutations(seed + 200)
        _apply(port_storage, eng, ops)
        _apply(jax_storage, jeng, ops)
        scan = _scan_graph(eng)
        snap = attach_snapshot(eng)
        jax_storage.attach_snapshot(jeng)
        g = build_graph(eng)
        assert g is snap.graph_view()  # served by the snapshot, cached
        assert (g.ids, g.index, g.neighbors) == \
            (scan.ids, scan.index, scan.neighbors)
        jg = jax_build_graph(jeng)
        assert (g.ids, g.neighbors) == (jg.ids, jg.neighbors)
        for t in (["KNOWS"], ["NOPE"]):
            a = build_graph(eng, t)
            b = build_graph(types.SimpleNamespace(
                all_nodes=eng.all_nodes, all_edges=eng.all_edges), t)
            assert (a.ids, a.neighbors) == (b.ids, b.neighbors)

    def test_bfs_matches_graph_algos_csr(self):
        eng = MemoryEngine()
        _apply(port_storage, eng, _mutations(7, n=40, steps=300))
        snap = attach_snapshot(eng)
        assert snap.ensure()
        view = snap.edge_arrays()
        n = len(view.ids)
        indptr, indices = graph_algos.build_csr(view.src, view.dst, n)
        for start in view.ids[:10]:
            dist = snap.bfs_distances(start, "both")
            want = graph_algos.bfs_distances_csr(indptr, indices,
                                                 view.index[start], n)
            got = {snap.id_of(i): int(dist[i])
                   for i in np.nonzero(dist >= 0)[0]}
            assert got == {view.ids[i]: int(want[i])
                           for i in np.nonzero(want >= 0)[0]}

    def test_concurrent_writers_converge_in_both(self):
        """Writers and readers race; each package's snapshot ends equal to
        its own engine, and the two end states agree."""
        finals = {}
        for name, pkg in PKGS.items():
            eng = pkg.MemoryEngine()
            for i in range(30):
                eng.create_node(pkg.Node(id=f"n{i}"))
            snap = pkg.AdjacencySnapshot(eng, merge_threshold=8)
            assert snap.ensure()
            errors = []
            stop = threading.Event()

            def writer(t):
                try:
                    for i in range(60):
                        eid = f"w{t}-{i}"
                        eng.create_edge(pkg.Edge(
                            id=eid, start_node=f"n{t}",
                            end_node=f"n{(t + i) % 30}", type="R"))
                        if i % 3 == 0:
                            eng.delete_edge(eid)
                except Exception as exc:  # pragma: no cover
                    errors.append(exc)

            def reader():
                try:
                    while not stop.is_set():
                        snap.ensure()
                        snap.expand_pairs("n0", "both")
                        snap.edge_arrays()
                except Exception as exc:  # pragma: no cover
                    errors.append(exc)

            ws = [threading.Thread(target=writer, args=(t,))
                  for t in range(3)]
            rs = [threading.Thread(target=reader) for _ in range(2)]
            for t in ws + rs:
                t.start()
            for t in ws:
                t.join()
            stop.set()
            for t in rs:
                t.join()
            assert not errors
            view = snap.edge_arrays()
            pairs = sorted((view.ids[s], view.ids[d])
                           for s, d in zip(view.src, view.dst))
            assert pairs == sorted((e.start_node, e.end_node)
                                   for e in eng.all_edges())
            finals[name] = pairs
        assert finals["port"] == finals["jax"]


class TestStatsSurfacing:
    def test_facade_admin_stats_and_metrics(self):
        import json
        import urllib.request

        import nornicdb_tpu_torch
        from nornicdb_tpu_torch.server import HttpServer

        db = nornicdb_tpu_torch.open_db("", device="cpu")
        srv = HttpServer(db, port=0)
        srv.start()
        try:
            assert db.adjacency_stats() is None  # not attached yet
            db.cypher("CREATE (:S {k: 1})-[:R]->(:S {k: 2})")
            db.cypher("MATCH (a:S {k: 1})-[*1..2]->(b) RETURN count(*)")
            stats = db.adjacency_stats()
            assert stats is not None and stats["builds"] == 1
            assert stats["edges"] == 1 and stats["bytes"] > 0

            base = f"http://127.0.0.1:{srv.port}"
            body = json.loads(urllib.request.urlopen(
                base + "/admin/stats", timeout=30).read())
            assert body["adjacency"]["builds"] == 1
            assert body["adjacency"]["edges"] == 1
            text = urllib.request.urlopen(
                base + "/metrics", timeout=30).read().decode()
            assert "nornicdb_adjacency_builds_total 1" in text
            assert "nornicdb_adjacency_bytes" in text
        finally:
            srv.stop()
            db.close()
