"""The port's columnar Cypher pipeline: the twin-engine equivalence cases of
``tests/test_columnar.py`` run against the port on the CPU, unchanged but
for their imports (the executor takes ``device="cpu"``).
"""

import random

import pytest

from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.storage import MemoryEngine, NamespacedEngine
from nornicdb_tpu_torch.storage.types import Edge, Node


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


def _build_graph(eng, n_people=40, n_msgs=60, seed=11):
    rng = random.Random(seed)
    cities = ["Oslo", "Bergen", "Narvik", None]
    for p in range(n_people):
        eng.create_node(Node(
            id=f"p{p:03d}", labels=["Person"],
            properties={"i": p, "name": f"P{p:03d}",
                        "age": (p * 7) % 61,
                        "score": round(rng.random() * 10, 3),
                        "city": rng.choice(cities),
                        "emb": [round(rng.random() * 2 - 1, 6)
                                for _ in range(8)]}))
    for m in range(n_msgs):
        eng.create_node(Node(
            id=f"m{m:03d}", labels=["Message"],
            properties={"i": m, "content": f"c{m}",
                        "created": (m * 37) % 100}))
        eng.create_edge(Edge(
            id=f"po{m:03d}", start_node=f"p{m % n_people:03d}",
            end_node=f"m{m:03d}", type="POSTED",
            properties={"w": round(rng.random(), 3)}))
    k = 0
    for p in range(n_people):
        for q in ((p + 1) % n_people, (p + 9) % n_people):
            eng.create_edge(Edge(
                id=f"k{k:03d}", start_node=f"p{p:03d}",
                end_node=f"p{q:03d}", type="KNOWS",
                properties={"w": (k % 7) / 3.0}))
            k += 1


def _twin(engine=None, **kw):
    eng = engine if engine is not None else MemoryEngine()
    _build_graph(eng, **kw)
    ex = CypherExecutor(eng)
    gen = CypherExecutor(eng)
    gen.columnar.enabled = False
    return eng, ex, gen


def _run(ex, query, params):
    try:
        r = ex.execute(query, dict(params))
        return ("ok", r.columns, repr(r.rows))
    except Exception as exc:  # identical error classes/messages count too
        return ("err", type(exc).__name__, str(exc))


def _churn(eng, round_no):
    """Interleaved create/retype/delete between comparison rounds."""
    base = 1000 + round_no * 50
    for j in range(6):
        eng.create_node(Node(id=f"p{base + j}", labels=["Person"],
                             properties={"i": base + j,
                                         "name": f"P{base + j}",
                                         "age": (base + j) % 61,
                                         "score": 1.5, "city": "Oslo"}))
    eng.create_edge(Edge(id=f"ke{base}", start_node=f"p{base}",
                         end_node=f"p{base + 1}", type="KNOWS",
                         properties={"w": 0.5}))
    # retype: KNOWS -> FOLLOWS for one edge (may already be deleted by an
    # earlier round's churn)
    try:
        e = eng.get_edge(f"k{(round_no * 3) % 70:03d}")
        e.type = "FOLLOWS"
        eng.update_edge(e)
    except Exception:
        pass
    # deletes: one node (cascading its edges), one edge
    try:
        eng.delete_edge(f"k{(round_no * 5 + 1) % 70:03d}")
    except Exception:
        pass
    try:
        eng.delete_node(f"m{(round_no * 7) % 55:03d}")
    except Exception:
        pass


SHAPES = [
    # scans + columnar WHERE
    ("MATCH (n:Person) WHERE n.age > 30 RETURN n.i", {}),
    ("MATCH (n:Person) WHERE n.age >= 10 AND n.city = 'Oslo' "
     "RETURN n.i, n.age", {}),
    ("MATCH (n:Person) WHERE n.city IS NULL RETURN n.i", {}),
    ("MATCH (n:Person) WHERE n.city IN ['Oslo', $c] OR n.age < 5 "
     "RETURN n.i", {"c": "Bergen"}),
    ("MATCH (n:Person) WHERE n.name STARTS WITH 'P00' RETURN n.name", {}),
    ("MATCH (n) WHERE n.created IS NOT NULL RETURN n.i", {}),
    # counts (former _fp_count family)
    ("MATCH (n:Person) RETURN count(n)", {}),
    ("MATCH (n) RETURN count(*)", {}),
    ("MATCH (n:Person) WHERE n.age > 40 RETURN count(*)", {}),
    ("MATCH ()-[r:KNOWS]->() RETURN count(r)", {}),
    ("MATCH ()-[r:KNOWS|FOLLOWS]->() RETURN count(*)", {}),
    # group counts (former _fp_group_count family)
    ("MATCH (x)-[:KNOWS]->(y) RETURN x.i, count(y)", {}),
    ("MATCH (x)<-[:KNOWS]-(y) RETURN x.i, count(*)", {}),
    ("MATCH (x)-[r:KNOWS]->(y) RETURN x, count(r)", {}),
    # mutual rel (former _fp_mutual_rel)
    ("MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(a) RETURN count(*)", {}),
    # expand chains + projections + sort/limit
    ("MATCH (p:Person)-[:POSTED]->(m:Message) "
     "RETURN m.content ORDER BY m.created DESC LIMIT 7", {}),
    ("MATCH (p:Person)-[:KNOWS]-(f:Person)-[:POSTED]->(m:Message) "
     "RETURN f.name, m.created ORDER BY m.created, f.name LIMIT 9", {}),
    ("MATCH (a:Person)-[:KNOWS]->(b) WHERE b.age > 20 "
     "RETURN a.name, b.age ORDER BY b.age DESC, a.name SKIP 2 LIMIT 6", {}),
    ("MATCH (p:Person {i: $i})-[:KNOWS]-(f:Person)-[:POSTED]->(m:Message) "
     "RETURN m.content, m.created ORDER BY m.created DESC LIMIT 5",
     {"i": 3}),
    ("MATCH (a:Person {i: 0})-[:KNOWS]-(f) "
     "RETURN f.name, f ORDER BY f.name SKIP 1 LIMIT 2", {}),
    # aggregates over node property columns
    ("MATCH (a:Person)-[:KNOWS]->(b) "
     "RETURN avg(b.age), min(a.name), max(b.i), sum(a.age)", {}),
    ("MATCH (a:Person)-[:POSTED]->(m) RETURN a.city, count(m), "
     "collect(m.created)", {}),
    ("MATCH (n:Person) RETURN n.city, count(*)", {}),
    # distinct
    ("MATCH (m:Message) RETURN DISTINCT m.created ORDER BY m.created "
     "LIMIT 6", {}),
    ("MATCH (a:Person)-[:KNOWS]-(b) RETURN DISTINCT b.city", {}),
    # both directions / typeless / unseen types
    ("MATCH (a:Person {i: 1})-[]-(b) RETURN b.i ORDER BY b.i", {}),
    ("MATCH (a)-[:NEVER_SEEN]->(b) RETURN count(*)", {}),
    ("MATCH (n:NoSuchLabel) RETURN count(n)", {}),
    # parameters in every position
    ("MATCH (n:Person) WHERE n.age > $a RETURN n.i ORDER BY n.i LIMIT $l",
     {"a": 33, "l": 4}),
    # WITH projection/aggregation across the clause boundary
    ("MATCH (a:Person) WITH a.age AS ag RETURN max(ag)", {}),
    ("MATCH (a:Person)-[:KNOWS]->(b) WITH b, count(a) AS deg "
     "WHERE deg > 1 RETURN b.i, deg ORDER BY deg DESC, b.i LIMIT 5", {}),
    ("MATCH (a:Person) WITH DISTINCT a.city AS c ORDER BY c SKIP 1 "
     "RETURN c", {}),
    ("MATCH (p:Person)-[:POSTED]->(m) WITH p, m ORDER BY m.created DESC "
     "LIMIT 4 RETURN p.i, m.content", {}),
    # multi-MATCH hash joins over id columns
    ("MATCH (a:Person {i: 1}) MATCH (b:Message {i: 2}) "
     "RETURN a.name, b.i", {}),
    ("MATCH (a:Person)-[:KNOWS]->(b) MATCH (b)-[:POSTED]->(m) "
     "RETURN b.i, count(m) ORDER BY b.i LIMIT 6", {}),
    # var-length expansion as bounded-hop batched CSR gathers
    ("MATCH (a:Person)-[:KNOWS*1..2]->(b) RETURN count(*)", {}),
    ("MATCH (a:Person {i: 0})-[:KNOWS*1..3]->(b:Person) "
     "RETURN b.i ORDER BY b.i LIMIT 10", {}),
    ("MATCH (a:Person {i: 2})-[:KNOWS|FOLLOWS*2..2]-(b) "
     "RETURN count(*)", {}),
    # CSR-resident edge property columns
    ("MATCH (a:Person)-[r:KNOWS]->(b) RETURN sum(r.w)", {}),
    ("MATCH ()-[r:KNOWS]->() WHERE r.w > 0.5 RETURN count(r)", {}),
    ("MATCH (a:Person)-[r:POSTED]->(m) RETURN a.city, min(r.w), "
     "count(r.w)", {}),
    # vector ranking (host-exact at this scale; the device cut path has
    # its own suite below)
    ("MATCH (n:Person) WHERE n.age > 10 RETURN n.i ORDER BY "
     "vector.similarity.cosine(n.emb, $q) DESC LIMIT 5",
     {"q": [0.5] * 8}),
    ("MATCH (n:Person) RETURN n.i ORDER BY "
     "vector.similarity.cosine($q, n.emb) LIMIT 4", {"q": [1.0] * 8}),
]

FALLBACK_SHAPES = [
    # residual WHERE (function call)
    ("MATCH (n:Person) WHERE toLower(n.name) = 'p003' RETURN n.name", {}),
    # cross-variable conjunct
    ("MATCH (a:Person)-[:KNOWS]->(b) WHERE b.age > a.age "
     "RETURN count(*)", {}),
    # WITH projection the planner can't columnarize
    ("MATCH (a:Person) WITH toLower(a.name) AS l RETURN l", {}),
    # WITH ORDER BY over a computed expression
    ("MATCH (a:Person) WITH a.age AS x ORDER BY x + 1 RETURN max(x)", {}),
    # RETURN *
    ("MATCH (a:Person {i: 1})-[:KNOWS]->(b) RETURN *", {}),
    # whole-entity projection with entity ORDER BY
    ("MATCH (p:Person) RETURN p ORDER BY p.name LIMIT 3", {}),
]

GENERIC_SHAPES = [
    ("OPTIONAL MATCH (n:Person) WHERE n.age > 1000 RETURN n", {}),
    ("MATCH (a:Person)-[r:KNOWS*1..2]->(b) RETURN count(r)", {}),
    ("MATCH (a:Person {i: 1}), (b:Message {i: 2}) RETURN a.name, b.i", {}),
    ("MATCH p = (a:Person {i: 1})-[:KNOWS]->(b) RETURN length(p)", {}),
]


class TestTwinEngineEquivalence:
    @pytest.mark.parametrize("query,params", SHAPES,
                             ids=[q[0][:48] for q in SHAPES])
    def test_shape_identical(self, query, params):
        _, ex, gen = _twin()
        assert _run(ex, query, params) == _run(gen, query, params)

    def test_all_shapes_under_churn(self):
        eng, ex, gen = _twin()
        for rnd in range(4):
            _churn(eng, rnd)
            for query, params in SHAPES + FALLBACK_SHAPES:
                got = _run(ex, query, params)
                want = _run(gen, query, params)
                assert got == want, f"round {rnd}: {query}"

    def test_namespaced_engine(self):
        _, ex, gen = _twin(engine=NamespacedEngine(MemoryEngine(), "ns"))
        for query, params in SHAPES[:12]:
            assert _run(ex, query, params) == _run(gen, query, params)

    def test_small_merge_threshold_delta_folding(self):
        """A tiny merge threshold forces CSR merges mid-churn; csr_view
        must fold pending delta adds so the columnar expansion sees every
        edge the generic engine sees."""
        from nornicdb_tpu_torch.storage.adjacency import attach_snapshot

        eng, ex, gen = _twin()
        attach_snapshot(eng, merge_threshold=2)
        for rnd in range(3):
            _churn(eng, rnd + 10)
            for query, params in SHAPES[9:18]:
                assert _run(ex, query, params) == _run(gen, query, params)

    def test_tied_sort_keys_with_limit_deterministic(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a", labels=["A"], properties={"i": 1}))
        for i in range(8):
            eng.create_node(Node(id=f"b{i}", labels=["B"],
                                 properties={"n": f"b{i}", "tie": 0}))
            eng.create_edge(Edge(id=f"e{i}", start_node="a",
                                 end_node=f"b{i}", type="R"))
        ex = CypherExecutor(eng)
        r = ex.execute(
            "MATCH (a:A {i: 1})-[:R]->(b:B) RETURN b.n ORDER BY b.tie "
            "LIMIT 4")
        assert r.rows == [["b0"], ["b1"], ["b2"], ["b3"]]
        tr = ex.columnar.last_trace()
        assert tr is not None and tr["outcome"] == "full"

    def test_order_by_duplicated_alias_uses_last_column(self):
        """The generic binding overlays columns via dict(zip(...)), so a
        duplicated RETURN alias in ORDER BY resolves to its LAST
        occurrence — the columnar sort must pick the same column."""
        eng = MemoryEngine()
        for i in range(8):
            eng.create_node(Node(id=f"d{i}", labels=["D"],
                                 properties={"i": i, "j": 7 - i}))
        ex = CypherExecutor(eng)
        gen = CypherExecutor(eng)
        gen.columnar.enabled = False
        q = "MATCH (a:D) RETURN a.i AS k, a.j AS k ORDER BY k LIMIT 4"
        assert _run(ex, q, {}) == _run(gen, q, {})

    def test_whole_node_result_does_not_alias_storage(self):
        _, ex, _ = _twin()
        r = ex.execute("MATCH (p:Person {i: 0})-[:KNOWS]->(f:Person) "
                       "RETURN f ORDER BY f.name LIMIT 1")
        r.rows[0][0].properties["name"] = "EVIL"
        r2 = ex.execute("MATCH (p:Person {i: 0})-[:KNOWS]->(f:Person) "
                        "RETURN f ORDER BY f.name LIMIT 1")
        assert r2.rows[0][0].properties["name"] != "EVIL"


class TestFallbackDiscipline:
    def _outcome(self, ex, query, params):
        ex.execute(query, dict(params))
        tr = ex.columnar.last_trace()
        return tr["outcome"] if tr is not None else "generic"

    @pytest.mark.parametrize("query,params", FALLBACK_SHAPES,
                             ids=[q[0][:48] for q in FALLBACK_SHAPES])
    def test_partial_fallback_engages(self, query, params):
        """These shapes must run a columnar prefix, then hand the partial
        binding table to the generic engine (results already proven
        identical above)."""
        _, ex, _ = _twin()
        assert self._outcome(ex, query, params) == "fallback"

    @pytest.mark.parametrize("query,params", GENERIC_SHAPES,
                             ids=[q[0][:48] for q in GENERIC_SHAPES])
    def test_unsupported_goes_generic(self, query, params):
        _, ex, gen = _twin()
        assert self._outcome(ex, query, params) == "generic"
        assert _run(ex, query, params) == _run(gen, query, params)

    def test_fallback_results_identical(self):
        _, ex, gen = _twin()
        for query, params in FALLBACK_SHAPES:
            assert _run(ex, query, params) == _run(gen, query, params)


class TestPlanCache:
    def test_warm_traffic_compiles_once(self):
        _, ex, _ = _twin()
        q = "MATCH (n:Person) WHERE n.age > 30 RETURN count(n)"
        ex.execute(q)
        pc = ex.columnar.cache
        compiles_after_first = pc.compiles
        for _ in range(5):
            ex.execute(q)
        assert pc.compiles == compiles_after_first
        assert pc.hits >= 5

    def test_text_fast_path_skips_parse_and_plan(self):
        """After the first execution the exact text is bound; repeats must
        hit the text probe (no shape normalization, no compile)."""
        _, ex, _ = _twin()
        q = "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.i, count(b)"
        r1 = ex.execute(q)
        assert ex.columnar.cache.stats_snapshot()["text_entries"] >= 1
        misses_before = ex.columnar.cache.misses
        hits_before = ex.columnar.cache.hits
        r2 = ex.execute(q)
        assert r2.columns == r1.columns and r2.rows == r1.rows
        assert ex.columnar.cache.misses == misses_before
        assert ex.columnar.cache.hits > hits_before

    def test_literal_lifting_shares_plans(self):
        """Texts differing only in literals share one compiled plan."""
        _, ex, gen = _twin()
        ex.execute("MATCH (n:Person) WHERE n.age > 30 RETURN count(n)")
        compiles = ex.columnar.cache.compiles
        r = ex.execute("MATCH (n:Person) WHERE n.age > 50 RETURN count(n)")
        assert ex.columnar.cache.compiles == compiles  # shape hit
        want = gen.execute(
            "MATCH (n:Person) WHERE n.age > 50 RETURN count(n)")
        assert r.rows == want.rows  # and the literal value still applies

    def test_ddl_invalidates_plan_cache(self):
        _, ex, _ = _twin()
        q = "MATCH (n:Person) WHERE n.age > 30 RETURN count(n)"
        ex.execute(q)
        assert ex.columnar.cache.stats_snapshot()["entries"] >= 1
        ex.execute("CREATE INDEX FOR (p:Person) ON (p.i)")
        snap = ex.columnar.cache.stats_snapshot()
        assert snap["entries"] == 0 and snap["text_entries"] == 0
        assert snap["invalidations"] >= 1
        # re-execution recompiles and still serves correct results
        r = ex.execute(q)
        assert r.rows[0][0] > 0

    def test_schema_generation_catches_foreign_ddl(self):
        """DDL issued through ANOTHER executor sharing the SchemaManager
        must invalidate this executor's cached plans (generation stamp)."""
        eng, ex, _ = _twin()
        other = CypherExecutor(eng, schema=ex.schema)
        q = "MATCH (p:Person {i: 3})-[:KNOWS]->(f) RETURN f.i ORDER BY f.i"
        before = ex.execute(q)
        other.execute("CREATE INDEX FOR (p:Person) ON (p.i)")
        inv_before = ex.columnar.cache.invalidations
        after = ex.execute(q)
        assert after.rows == before.rows
        assert ex.columnar.cache.invalidations > inv_before

    def test_params_do_not_leak_into_shape_key(self):
        from nornicdb_tpu_torch.cypher.parser import parse
        from nornicdb_tpu_torch.cypher.plan import normalize_query

        k1 = normalize_query(parse(
            "MATCH (n:P) WHERE n.x > 5 RETURN count(n)"))[0]
        k2 = normalize_query(parse(
            "MATCH (n:P) WHERE n.x > 99 RETURN count(n)"))[0]
        k3 = normalize_query(parse(
            "MATCH (n:Q) WHERE n.x > 5 RETURN count(n)"))[0]
        assert k1 == k2
        assert k1 != k3

    def test_count_star_not_lifted(self):
        from nornicdb_tpu_torch.cypher.parser import parse
        from nornicdb_tpu_torch.cypher.plan import normalize_query

        key, canon, lits = normalize_query(parse(
            "MATCH (n:P) RETURN count(*)"))
        assert "*" in key and lits == []


class TestExplainProfile:
    def test_explain_reports_engine_per_operator(self):
        _, ex, _ = _twin()
        r = ex.execute("EXPLAIN MATCH (a:Person)-[:KNOWS]->(b) "
                       "WHERE a.age > 10 RETURN a.name, count(b)")
        plan = r.rows[0][0]
        assert "columnar plan [cache miss" in plan
        assert "[columnar]" in plan
        assert "Expand((a)-[:KNOWS]->(b))" in plan
        # second EXPLAIN of the same shape reports a cache hit
        r2 = ex.execute("EXPLAIN MATCH (a:Person)-[:KNOWS]->(b) "
                        "WHERE a.age > 10 RETURN a.name, count(b)")
        assert "columnar plan [cache hit" in r2.rows[0][0]

    def test_explain_reports_generic_with_reason(self):
        _, ex, _ = _twin()
        r = ex.execute("EXPLAIN MATCH p = (a:Person)-[:KNOWS]->(b) "
                       "RETURN length(p)")
        assert "columnar: generic" in r.rows[0][0]

    def test_explain_reports_generic_tail_operator(self):
        _, ex, _ = _twin()
        r = ex.execute("EXPLAIN MATCH (a:Person) "
                       "WITH toLower(a.name) AS l RETURN l")
        assert "GenericTail" in r.rows[0][0]
        assert "[generic]" in r.rows[0][0]

    def test_explain_reports_vector_topk_operator(self):
        _, ex, _ = _twin()
        r = ex.execute("EXPLAIN MATCH (n:Person) RETURN n.i ORDER BY "
                       "vector.similarity.cosine(n.emb, $q) DESC LIMIT 3",
                       {"q": [0.1] * 8})
        plan = r.rows[0][0]
        assert "VectorTopK(" in plan and "[columnar]" in plan

    def test_profile_includes_measured_operator_timings(self):
        _, ex, _ = _twin()
        r = ex.execute("PROFILE MATCH (a:Person)-[:KNOWS]->(b) "
                       "RETURN a.i, count(b)")
        assert "columnar execution [full" in r.plan
        assert "rows=" in r.plan and " ms" in r.plan


class TestTelemetrySurfaces:
    def test_metric_families_render(self):
        from nornicdb_tpu_torch.telemetry.metrics import REGISTRY

        _, ex, _ = _twin()
        ex.execute("MATCH (n:Person) RETURN count(n)")
        text = REGISTRY.render_prometheus()
        for name in (
            "nornicdb_cypher_plan_cache_hits_total",
            "nornicdb_cypher_plan_cache_misses_total",
            "nornicdb_cypher_plan_cache_invalidations_total",
            "nornicdb_cypher_columnar_rows",
            "nornicdb_cypher_operator_seconds",
            "nornicdb_cypher_columnar_queries_total",
            "nornicdb_cypher_offloads_total",
        ):
            assert name in text, name

    def test_slowlog_captures_plan_key_and_operator_timings(self):
        from nornicdb_tpu_torch.telemetry.slowlog import slow_log

        _, ex, _ = _twin()
        old_thr = slow_log.threshold_s
        slow_log.configure(threshold_s=1e-9)
        try:
            slow_log.clear()
            ex.execute("MATCH (a:Person)-[:KNOWS]->(b) "
                       "RETURN a.i, count(b)")
            entries = slow_log.snapshot()
            col = next((e["columnar"] for e in entries
                        if e.get("columnar")), None)
            assert col is not None
            assert col["plan_key"] and col["outcome"] == "full"
            assert col["operators"] and all(
                "ms" in op for op in col["operators"])
        finally:
            slow_log.configure(threshold_s=old_thr)
            slow_log.clear()

    def test_counters_probe_reports_plan_cache(self):
        from nornicdb_tpu_torch.telemetry import slowlog as sl

        class FakeDB:
            pass

        eng, ex, _ = _twin()
        db = FakeDB()
        db._executor = ex
        db.storage = eng
        ex.execute("MATCH (n:Person) RETURN count(n)")
        probe = sl.counters_probe(db)
        assert probe is not None
        assert "cypher_plan_cache_hits" in probe
        assert "cypher_plan_cache_misses" in probe


class TestResultCacheInterplay:
    def test_text_fast_path_respects_result_cache_isolation(self):
        from nornicdb_tpu_torch.cache import QueryCache

        eng = MemoryEngine()
        _build_graph(eng)
        ex = CypherExecutor(eng, cache=QueryCache())
        q = "MATCH (p:Person {i: 0})-[:KNOWS]->(f) RETURN f"
        r1 = ex.execute(q)
        r1.rows[0][0].properties["name"] = "EVIL"
        r2 = ex.execute(q)  # result-cache hit via the text fast path
        assert r2.rows[0][0].properties["name"] != "EVIL"

    def test_text_fast_path_sees_writes(self):
        """A write invalidating the result cache must not leave the text
        fast path serving stale rows (plans bind data per execution)."""
        from nornicdb_tpu_torch.cache import QueryCache

        eng = MemoryEngine()
        _build_graph(eng)
        ex = CypherExecutor(eng, cache=QueryCache())
        q = "MATCH (n:Person) RETURN count(n)"
        n0 = ex.execute(q).rows[0][0]
        ex.execute("CREATE (:Person {i: 9999, name: 'new'})")
        assert ex.execute(q).rows[0][0] == n0 + 1


class TestDeviceOffloadDegradation:
    def test_offload_path_equal_or_host_under_hang(self, monkeypatch):
        """With the offload threshold forced to 1, ORDER BY numeric LIMIT
        returns generic-identical rows through the offload (here on the
        CPU device; a card that is not serving is held in
        ``TestPortOffloadPolicy``)."""
        monkeypatch.setenv("NORNICDB_CYPHER_OFFLOAD_MIN_ROWS", "1")
        _, ex, gen = _twin()
        q = ("MATCH (n:Person) WHERE n.age > 5 "
             "RETURN n.name ORDER BY n.score DESC LIMIT 4")
        assert _run(ex, q, {}) == _run(gen, q, {})
        tr = ex.columnar.last_trace()
        assert tr is not None and tr["outcome"] == "full"

    def test_offload_boundary_ties_included(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_CYPHER_OFFLOAD_MIN_ROWS", "1")
        eng = MemoryEngine()
        for i in range(32):
            eng.create_node(Node(id=f"t{i:02d}", labels=["T"],
                                 properties={"v": i // 8, "n": i}))
        ex = CypherExecutor(eng)
        gen = CypherExecutor(eng)
        gen.columnar.enabled = False
        q = "MATCH (t:T) RETURN t.n ORDER BY t.v DESC LIMIT 5"
        assert _run(ex, q, {}) == _run(gen, q, {})


class TestMigrationFromFastpaths:
    """Each former `_try_fastpath` family member routes through the
    columnar pipeline and returns identical results (the fastpath methods
    themselves are deleted — see test_traversal_fastpath.py)."""

    FORMER = [
        ("MATCH (n:Person) RETURN count(n)", {}),
        ("MATCH (n) RETURN count(*)", {}),
        ("MATCH ()-[r:KNOWS]->() RETURN count(r)", {}),
        ("MATCH (x)-[:KNOWS]->(y) RETURN x.i, count(y)", {}),
        ("MATCH (x)<-[:KNOWS]-(y) RETURN x, count(*)", {}),
        ("MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(a) RETURN count(*)", {}),
        ("MATCH (p:Person {i: 2})-[:KNOWS]-(f)-[:POSTED]->(m:Message) "
         "RETURN m.content ORDER BY m.created DESC LIMIT 5", {}),
        ("MATCH (a:Person) WITH a.age AS ag RETURN max(ag)", {}),
        ("MATCH (a:Person)-[:KNOWS*1..2]->(b) RETURN count(*)", {}),
        ("MATCH (a:Person {i: 1}) MATCH (b:Message {i: 2}) "
         "RETURN a.name, b.i", {}),
        ("MATCH (a:Person)-[r:KNOWS]->(b) RETURN sum(r.w)", {}),
        ("MATCH (n:Person) RETURN n.i ORDER BY "
         "vector.similarity.cosine(n.emb, $q) DESC LIMIT 3",
         {"q": [0.25] * 8}),
    ]

    @pytest.mark.parametrize("query,params", FORMER,
                             ids=[q[0][:48] for q in FORMER])
    def test_routes_columnar_and_identical(self, query, params):
        _, ex, gen = _twin()
        got = _run(ex, query, params)
        tr = ex.columnar.last_trace()
        assert tr is not None and tr["outcome"] == "full", query
        assert got == _run(gen, query, params)

    def test_edge_prop_agg_runs_columnar_fastpath_deleted(self):
        """Edge-property aggregation — the last executor fastpath — now
        runs over the CSR-resident edge property columns, and the
        `_fp_edge_agg` / `_try_fastpath` methods are deleted, not
        shadowed."""
        _, ex, gen = _twin()
        q = ("MATCH ()-[r:KNOWS]->() RETURN avg(r.w), sum(r.w), count(r), "
             "min(r.w), max(r.w)")
        got = _run(ex, q, {})
        assert got == _run(gen, q, {})
        tr = ex.columnar.last_trace()
        assert tr is not None and tr["outcome"] == "full"
        assert not hasattr(ex, "_fp_edge_agg")
        assert not hasattr(ex, "_try_fastpath")


class TestTopologyEdgeCases:
    def test_self_loops_both_directions(self):
        eng = MemoryEngine()
        for i in range(4):
            eng.create_node(Node(id=f"s{i}", labels=["S"],
                                 properties={"i": i}))
        eng.create_edge(Edge(id="loop", start_node="s0", end_node="s0",
                             type="L"))
        eng.create_edge(Edge(id="l01", start_node="s0", end_node="s1",
                             type="L"))
        ex = CypherExecutor(eng)
        gen = CypherExecutor(eng)
        gen.columnar.enabled = False
        for q in [
            "MATCH (a:S {i: 0})-[:L]-(b) RETURN b.i ORDER BY b.i",
            "MATCH (a:S)-[:L]-(b) RETURN count(*)",
            "MATCH ()-[r:L]-() RETURN count(r)",
            "MATCH (a:S)-[:L]->(a) RETURN count(*)",
        ]:
            assert _run(ex, q, {}) == _run(gen, q, {}), q

    def test_empty_graph(self):
        eng = MemoryEngine()
        ex = CypherExecutor(eng)
        gen = CypherExecutor(eng)
        gen.columnar.enabled = False
        for q in [
            "MATCH (n) RETURN count(*)",
            "MATCH (n:L) RETURN count(n)",
            "MATCH ()-[r:T]->() RETURN count(r)",
            "MATCH (a:L)-[:T]->(b) RETURN a.x, count(b)",
        ]:
            assert _run(ex, q, {}) == _run(gen, q, {}), q

    def test_null_property_map_matches_missing(self):
        """Anchor prop map {k: null} matches nodes WITHOUT the property —
        the matcher's _value_eq semantics, not WHERE's three-valued _eq."""
        eng = MemoryEngine()
        eng.create_node(Node(id="a", labels=["N"], properties={"k": 1}))
        eng.create_node(Node(id="b", labels=["N"], properties={}))
        eng.create_edge(Edge(id="e", start_node="b", end_node="a",
                             type="T"))
        ex = CypherExecutor(eng)
        gen = CypherExecutor(eng)
        gen.columnar.enabled = False
        q = "MATCH (n:N {k: null})-[:T]->(m) RETURN m.k"
        assert _run(ex, q, {}) == _run(gen, q, {})


class TestUnionAndWrappers:
    def test_union_query_stable_across_repeats(self):
        """A UNION query's main branch may run full-columnar, but its
        text must NEVER be bound to the text fast path (which would drop
        the union rows on repeat traffic)."""
        _, ex, gen = _twin()
        q = ("MATCH (n:Person) WHERE n.age > 10 RETURN count(n) AS c "
             "UNION ALL MATCH (m:Message) RETURN count(m) AS c")
        want = gen.execute(q).rows
        assert ex.execute(q).rows == want
        assert ex.execute(q).rows == want  # repeat: no truncated fast path

    def test_profile_repeats_keep_plan_output(self):
        _, ex, _ = _twin()
        q = "PROFILE MATCH (n:Person) RETURN count(n)"
        r1 = ex.execute(q)
        r2 = ex.execute(q)
        assert r1.plan and "runtime:" in r1.plan
        assert r2.plan and "runtime:" in r2.plan


class TestDisableSwitch:
    def test_env_disable(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_CYPHER_COLUMNAR", "0")
        eng = MemoryEngine()
        _build_graph(eng)
        ex = CypherExecutor(eng)
        assert not ex.columnar.enabled
        r = ex.execute("MATCH (n:Person) RETURN count(n)")
        assert r.rows[0][0] == 40
        assert ex.columnar.last_trace() is None


# ---------------------------------------------------------------- VectorTopK
def _build_vec_graph(n=64, dim=6, seed=7, dup_every=8, miss_every=13):
    """Label-V corpus with deliberate tie groups (duplicate vectors every
    ``dup_every`` nodes) and missing embeddings (every ``miss_every``)."""
    rng = random.Random(seed)
    eng = MemoryEngine()
    base = [[round(rng.random() * 2 - 1, 6) for _ in range(dim)]
            for _ in range(dup_every)]
    for i in range(n):
        props = {"i": i}
        if i % miss_every != 0:
            props["emb"] = list(base[i % dup_every]) if i % 2 == 0 else \
                [round(rng.random() * 2 - 1, 6) for _ in range(dim)]
        eng.create_node(Node(id=f"v{i:03d}", labels=["V"],
                             properties=props))
    for i in range(n):
        eng.create_edge(Edge(id=f"r{i:03d}", start_node=f"v{i:03d}",
                             end_node=f"v{(i + 1) % n:03d}", type="R"))
    ex = CypherExecutor(eng)
    gen = CypherExecutor(eng)
    gen.columnar.enabled = False
    return eng, ex, gen


class TestGraphVectorFusion:
    """``ORDER BY vector.similarity.cosine(...) LIMIT k`` plans into the
    masked device top-k (exact host rescore, tie-stable) and must
    bit-match the interpreter: ties, nulls, malformed rows, churned
    embeddings, and the host path (the port's policy for a card that is
    not serving is held in ``TestPortOffloadPolicy``)."""

    Q = [0.3, -0.2, 0.9, 0.1, -0.7, 0.4]

    @pytest.fixture(autouse=True)
    def _engage_cut(self, monkeypatch):
        # corpus is tiny; drop the floor so the top-k cut engages
        monkeypatch.setenv("NORNICDB_VECTOR_TOPK_MIN_ROWS", "1")
        monkeypatch.setenv("NORNICDB_VECTOR_TOPK_CUTOVER", "0.5")

    def test_desc_topk_bitmatch_and_planned(self):
        _, ex, gen = _build_vec_graph()
        q = ("MATCH (v:V) RETURN v.i ORDER BY "
             "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5")
        assert _run(ex, q, {"q": self.Q}) == _run(gen, q, {"q": self.Q})
        tr = ex.columnar.last_trace()
        assert tr is not None and tr["outcome"] == "full"
        plan = ex.execute("EXPLAIN " + q, {"q": self.Q}).rows[0][0]
        assert "VectorTopK(" in plan and "[columnar]" in plan

    def test_asc_topk_bitmatch(self):
        _, ex, gen = _build_vec_graph()
        q = ("MATCH (v:V) RETURN v.i ORDER BY "
             "vector.similarity.cosine($q, v.emb) LIMIT 4")
        assert _run(ex, q, {"q": self.Q}) == _run(gen, q, {"q": self.Q})
        assert ex.columnar.last_trace()["outcome"] == "full"

    def test_tie_groups_cross_boundary(self):
        # duplicate vectors guarantee score ties; sweep k so the cut
        # boundary lands inside a tie group at least once
        _, ex, gen = _build_vec_graph(dup_every=4)
        for k in (2, 3, 5, 8, 13):
            for d in ("DESC", "ASC"):
                q = ("MATCH (v:V) RETURN v.i, v.emb ORDER BY "
                     f"vector.similarity.cosine(v.emb, $q) {d} LIMIT {k}")
                assert _run(ex, q, {"q": self.Q}) == \
                    _run(gen, q, {"q": self.Q}), (k, d)

    def test_filtered_topk_mask_pushdown(self):
        _, ex, gen = _build_vec_graph()
        for cut in (8, 32, 60):
            q = (f"MATCH (v:V) WHERE v.i < {cut} RETURN v.i ORDER BY "
                 "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5")
            assert _run(ex, q, {"q": self.Q}) == \
                _run(gen, q, {"q": self.Q}), cut
            assert ex.columnar.last_trace()["outcome"] == "full"

    def test_nulls_order_like_interpreter(self):
        # k large enough that missing-emb (null-score) rows enter the
        # window: DESC puts nulls first generically, ASC last
        _, ex, gen = _build_vec_graph(miss_every=5)
        for d in ("DESC", "ASC"):
            q = ("MATCH (v:V) RETURN v.i ORDER BY "
                 f"vector.similarity.cosine(v.emb, $q) {d} LIMIT 20")
            assert _run(ex, q, {"q": self.Q}) == \
                _run(gen, q, {"q": self.Q}), d

    def test_malformed_row_reproduces_interpreter_error(self):
        eng, ex, gen = _build_vec_graph()
        n = eng.get_node("v002")
        n.properties["emb"] = [1.0, 2.0]  # wrong dim: interpreter raises
        eng.update_node(n)
        q = ("MATCH (v:V) RETURN v.i ORDER BY "
             "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5")
        got, want = _run(ex, q, {"q": self.Q}), _run(gen, q, {"q": self.Q})
        assert got == want
        assert got[0] == "err"

    def test_churn_epoch_invalidation(self):
        rng = random.Random(3)
        eng, ex, gen = _build_vec_graph()
        q = ("MATCH (v:V) RETURN v.i ORDER BY "
             "vector.similarity.cosine(v.emb, $q) DESC LIMIT 6")
        for rnd in range(4):
            # rewrite some embeddings + add a node: cached matrix must
            # invalidate via the colindex epoch, never serve stale scores
            for i in (rnd, rnd + 17, rnd + 40):
                n = eng.get_node(f"v{i:03d}")
                n.properties["emb"] = [round(rng.random(), 6)
                                       for _ in range(6)]
                eng.update_node(n)
            eng.create_node(Node(
                id=f"vx{rnd}", labels=["V"],
                properties={"i": 100 + rnd,
                            "emb": [round(rng.random(), 6)
                                    for _ in range(6)]}))
            assert _run(ex, q, {"q": self.Q}) == \
                _run(gen, q, {"q": self.Q}), rnd

    def test_device_unavailable_propagates(self, monkeypatch):
        """JAX's case degrades to host scoring when the device scoring
        returns nothing; the port's device scoring never returns nothing,
        and a card that is not serving raises through the query instead
        of scoring on the host (ROADMAP §C)."""
        from nornicdb_tpu_torch.cypher.plan import OFFLOAD_CELLS
        from nornicdb_tpu_torch.search import service as svc

        def unavailable(*a, **k):
            raise DeviceUnavailable("backend DEGRADED_CPU: card not serving")

        monkeypatch.setattr(svc, "graph_masked_scores", unavailable)
        before = OFFLOAD_CELLS["unavailable"].value
        _, ex, _ = _build_vec_graph()
        q = ("MATCH (v:V) RETURN v.i ORDER BY "
             "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5")
        with pytest.raises(DeviceUnavailable, match="not serving"):
            ex.execute(q, {"q": self.Q})
        assert OFFLOAD_CELLS["unavailable"].value == before

    def test_fused_with_then_expand(self):
        _, ex, gen = _build_vec_graph()
        q = ("MATCH (v:V) WITH v ORDER BY "
             "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5 "
             "MATCH (v)-[:R]->(w) RETURN v.i, w.i")
        assert _run(ex, q, {"q": self.Q}) == _run(gen, q, {"q": self.Q})
        tr = ex.columnar.last_trace()
        assert tr is not None and tr["outcome"] == "full"
        plan = ex.execute("EXPLAIN " + q, {"q": self.Q}).rows[0][0]
        assert "VectorTopK(" in plan

    def test_operator_metric_observed(self):
        from nornicdb_tpu_torch.cypher.plan import OP_CELLS

        before = OP_CELLS["vector_topk"].count
        _, ex, _ = _build_vec_graph()
        ex.execute("MATCH (v:V) RETURN v.i ORDER BY "
                   "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5",
                   {"q": self.Q})
        assert OP_CELLS["vector_topk"].count > before


# ---- the port's own offload policy, and both packages on the same shapes
import time  # noqa: E402

import numpy as np  # noqa: E402

from nornicdb_tpu.cypher import CypherExecutor as JaxExecutor  # noqa: E402
from nornicdb_tpu.storage import MemoryEngine as JaxMemoryEngine  # noqa: E402
from nornicdb_tpu.storage.types import Edge as JaxEdge  # noqa: E402
from nornicdb_tpu.storage.types import Node as JaxNode  # noqa: E402
from nornicdb_tpu_torch.backend import BackendManager, FakeHooks  # noqa: E402
from nornicdb_tpu_torch.cypher.plan import OFFLOAD_CELLS  # noqa: E402
from nornicdb_tpu_torch.errors import DeviceUnavailable  # noqa: E402


def _norm(v):
    if hasattr(v, "labels") and hasattr(v, "properties"):
        return ("node", v.id, sorted(v.labels), _norm(v.properties))
    if hasattr(v, "start_node") and hasattr(v, "properties"):
        return ("edge", v.id, v.type, _norm(v.properties))
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


class _JaxEngineAdapter:
    """Feeds ``_build_graph`` into a JAX engine with the JAX types."""

    def __init__(self, eng):
        self.eng = eng

    def create_node(self, n):
        return self.eng.create_node(JaxNode(
            id=n.id, labels=list(n.labels), properties=dict(n.properties)))

    def create_edge(self, e):
        return self.eng.create_edge(JaxEdge(
            id=e.id, start_node=e.start_node, end_node=e.end_node,
            type=e.type, properties=dict(e.properties)))


def _run_norm(ex, query, params):
    try:
        r = ex.execute(query, dict(params))
        return ("ok", r.columns, _norm(r.rows))
    except Exception as exc:
        return ("err", type(exc).__name__, str(exc))


class TestBothPackages:
    """Every columnar shape of the JAX suite through both packages'
    executors on the same graph: the same columns, rows and tie order."""

    @pytest.mark.parametrize("query,params", SHAPES + FALLBACK_SHAPES,
                             ids=[q[:50] for q, _ in SHAPES + FALLBACK_SHAPES])
    def test_same_rows_as_jax(self, query, params):
        port = MemoryEngine()
        _build_graph(port)
        jeng = JaxMemoryEngine()
        _build_graph(_JaxEngineAdapter(jeng))
        got = _run_norm(CypherExecutor(port), query, params)
        want = _run_norm(JaxExecutor(jeng), query, params)
        assert got == want


class TestPortOffloadPolicy:
    """The offloads run on the executor's device (the CPU here) with the
    thresholds at 1, equal the generic engine, and follow the device
    owner's one policy: a card that is not serving raises within the
    bound, never the host path, and the offload serves again once the
    owner recovers."""

    ORDER = ("MATCH (n:Person) WHERE n.age > 5 "
             "RETURN n.name ORDER BY n.score DESC LIMIT 4")
    VEC = ("MATCH (v:V) WHERE v.i < 60 RETURN v.i ORDER BY "
           "vector.similarity.cosine(v.emb, $q) DESC LIMIT 5")
    Q = {"q": [0.3, -0.2, 0.9, 0.1, -0.7, 0.4]}

    @pytest.fixture(autouse=True)
    def _thresholds(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_CYPHER_OFFLOAD_MIN_ROWS", "1")
        monkeypatch.setenv("NORNICDB_VECTOR_TOPK_MIN_ROWS", "1")
        monkeypatch.setenv("NORNICDB_VECTOR_TOPK_CUTOVER", "0.5")

    def _mgr(self, mode, **kw):
        mgr = BackendManager(hooks=FakeHooks(mode), acquire_timeout=0.3,
                             probe_interval=0.03, probe_timeout=0.25, **kw)
        self._live.append(mgr)
        return mgr

    @pytest.fixture(autouse=True)
    def _stop(self):
        self._live = []
        yield
        for m in self._live:
            m.stop()

    def test_order_by_offload_used_on_the_cpu_device(self):
        eng, ex, gen = _twin()
        used = OFFLOAD_CELLS["used"].value
        assert _run(ex, self.ORDER, {}) == _run(gen, self.ORDER, {})
        assert OFFLOAD_CELLS["used"].value == used + 1
        assert ex.device.type == "cpu"

    def test_vector_topk_used_on_the_cpu_device(self):
        _, ex, gen = _build_vec_graph()
        used = OFFLOAD_CELLS["used"].value
        assert _run(ex, self.VEC, self.Q) == _run(gen, self.VEC, self.Q)
        assert OFFLOAD_CELLS["used"].value == used + 1

    @pytest.mark.parametrize("which", ["order", "vector"])
    def test_fail_policy_raises_within_the_bound(self, which):
        mgr = self._mgr("hang")
        if which == "order":
            eng, _, _ = _twin()
            query, params = self.ORDER, {}
        else:
            eng, _, _ = _build_vec_graph()
            query, params = self.VEC, self.Q
        ex = CypherExecutor(eng, backend=mgr)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            ex.execute(query, params)
        assert time.perf_counter() - t0 < mgr.acquire_timeout + 1.0

    @pytest.mark.parametrize("which", ["order", "vector"])
    def test_recovered_owner_serves_the_offload(self, which):
        mgr = self._mgr("hang", recover_after=1)
        if which == "order":
            eng, _, gen = _twin()
            query, params = self.ORDER, {}
        else:
            eng, _, gen = _build_vec_graph()
            query, params = self.VEC, self.Q
        ex = CypherExecutor(eng, backend=mgr)
        unavailable = OFFLOAD_CELLS["unavailable"].value
        used = OFFLOAD_CELLS["used"].value
        with pytest.raises(DeviceUnavailable):
            ex.execute(query, params)
        mgr.hooks.set_mode("ok")
        deadline = time.monotonic() + 10
        while not mgr.ready() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mgr.ready(), mgr.state
        assert _run(ex, query, params) == _run(gen, query, params)
        assert OFFLOAD_CELLS["unavailable"].value == unavailable
        assert OFFLOAD_CELLS["used"].value == used + 1
        assert ex.columnar.last_trace()["outcome"] == "full"

    def test_device_errors_propagate(self, monkeypatch):
        import torch

        def broken(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(torch, "topk", broken)
        _, ex, _ = _twin()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            ex.execute(self.ORDER)

    def test_graph_masked_scores_matches_numpy(self):
        from nornicdb_tpu_torch.search.service import graph_masked_scores

        rng = np.random.default_rng(0)
        m = rng.standard_normal((300, 16)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        valid = rng.random(300) < 0.6
        q = m[3]
        cache = [None]
        for desc in (True, False):
            scores, boundary = graph_masked_scores(q, m, valid, 7, desc,
                                                   dev_ref=cache,
                                                   device="cpu")
            want = (m @ q).astype(np.float64)
            np.testing.assert_allclose(scores[valid], want[valid],
                                       atol=1e-6)
            kth = np.sort(want[valid])[::-1][6] if desc else \
                np.sort(want[valid])[6]
            assert boundary == pytest.approx(kth, abs=1e-6)
        assert cache[0][0] == 512  # padded to the pow2 bucket, reused
