"""The port's parallel Cypher execution (``cypher/parallel.py``): the cases
of ``tests/test_cypher_parallel.py`` run against the port on the CPU,
unchanged but for their imports.
"""

import numpy as np
import pytest

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.cypher.executor import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.cypher.parallel import (
    ParallelConfig,
    compile_where,
    get_parallel_config,
    parallel_count,
    parallel_filter,
    parallel_map,
    parallel_sum,
    set_parallel_config,
)
from nornicdb_tpu_torch.cypher.parser import parse
from nornicdb_tpu_torch.storage import MemoryEngine
from nornicdb_tpu_torch.storage.types import Edge, Node


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


@pytest.fixture(autouse=True)
def _restore_config():
    old = get_parallel_config()
    yield
    set_parallel_config(old)


def _executor(n=300, seed=0):
    rng = np.random.default_rng(seed)
    storage = MemoryEngine()
    cities = ["Oslo", "Bergen", "Trondheim", None]
    for i in range(n):
        props = {"i": i, "age": int(rng.integers(0, 90))}
        c = cities[int(rng.integers(0, 4))]
        if c is not None:
            props["city"] = c
        if rng.random() < 0.3:
            props["score"] = float(rng.random())
        storage.create_node(Node(
            id=f"n{i}", labels=["P"] if i % 3 else ["P", "Q"], properties=props
        ))
    eid = 0
    for i in range(n):
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(0, n))
            storage.create_edge(Edge(
                id=f"e{eid}", start_node=f"n{i}", end_node=f"n{j}",
                type="KNOWS",
                properties=(
                    {"w": float(rng.random())} if rng.random() < 0.8 else {}
                ),
            ))
            eid += 1
    return CypherExecutor(storage)


class TestParallelPrimitives:
    def test_filter_count_map_sum_match_sequential(self):
        set_parallel_config(ParallelConfig(max_workers=4, min_batch_size=10))
        items = list(range(1000))
        pred = lambda x: (x % 3 == 0) or None  # None must NOT be kept
        assert parallel_filter(items, lambda x: x % 3 == 0 or None) == [
            x for x in items if x % 3 == 0
        ]
        assert parallel_count(items, lambda x: x % 7 == 0) == len(
            [x for x in items if x % 7 == 0]
        )
        assert parallel_map(items, lambda x: x * 2) == [x * 2 for x in items]
        assert parallel_sum(items, lambda x: x) == sum(items)

    def test_gates(self):
        set_parallel_config(ParallelConfig(enabled=False))
        assert parallel_filter([1, 2, 3], lambda x: True) == [1, 2, 3]
        set_parallel_config(ParallelConfig(min_batch_size=0, max_workers=-1,
                                           columnar_min_rows=0))
        cfg = get_parallel_config()
        assert cfg.min_batch_size == 1000  # zero values fall back, parallel.go:68
        assert cfg.max_workers == 0
        assert cfg.columnar_min_rows == 64  # zero value falls back too

    def test_columnar_min_rows_gate_is_independent(self, monkeypatch):
        """Raising columnar_min_rows forces the index-free path (the
        operator escape hatch) on BOTH the scan and count fastpaths,
        without touching thread-pool parallelism; results agree."""
        from nornicdb_tpu_torch.cypher import colindex as ci

        ex = _executor(n=120, seed=5)
        queries = ["MATCH (n:P) WHERE n.age > 30 RETURN count(n)",
                   "MATCH (n:P) WHERE n.age > 30 RETURN n.i"]
        set_parallel_config(ParallelConfig(min_batch_size=1,
                                           columnar_min_rows=1))
        fast = [sorted(map(tuple, ex.execute(q).rows)) for q in queries]
        set_parallel_config(ParallelConfig(min_batch_size=1,
                                           columnar_min_rows=10**6))
        # with the threshold raised, the scan index must never be consulted
        def boom(self, label, *a, **k):
            raise AssertionError("scan index consulted despite gate")

        monkeypatch.setattr(ci.ColumnarScanIndex, "masked_ids", boom)
        monkeypatch.setattr(ci.ColumnarScanIndex, "count", boom)
        generic = [sorted(map(tuple, ex.execute(q).rows)) for q in queries]
        assert fast == generic

    def test_colindex_label_set_lru_capped(self):
        """Hundreds of queried-once labels must not grow the per-write
        event walk without bound."""
        from nornicdb_tpu_torch.cypher.colindex import ColumnarScanIndex

        eng = MemoryEngine()
        for li in range(ColumnarScanIndex.MAX_LABELS + 10):
            for i in range(3):
                eng.create_node(Node(id=f"l{li}-n{i}", labels=[f"L{li}"],
                                     properties={"v": i}))
        idx = ColumnarScanIndex(eng)
        for li in range(ColumnarScanIndex.MAX_LABELS + 10):
            assert idx._get(f"L{li}") is not None
        assert len(idx._labels) == ColumnarScanIndex.MAX_LABELS
        # evicted labels rebuild on demand (correctness unaffected)
        assert len(idx._get("L0").ids) == 3


class TestCompileWhere:
    def _nodes(self):
        return [
            Node(id="a", labels=[], properties={"x": 5, "s": "hello"}),
            Node(id="b", labels=[], properties={"x": "str"}),
            Node(id="c", labels=[], properties={}),
            Node(id="d", labels=[], properties={"x": 10, "s": "hi"}),
        ]

    def _mask(self, cypher_where, params=None):
        q = parse(f"MATCH (n) WHERE {cypher_where} RETURN n")
        where = q.clauses[0].where
        cw = compile_where(where, "n")
        assert cw.has_columnar and cw.residual is None, cypher_where
        return list(cw.mask(self._nodes(), params or {}))

    def test_leaves(self):
        assert self._mask("n.x > 4") == [True, False, False, True]
        assert self._mask("n.x = 5") == [True, False, False, False]
        assert self._mask("n.x <> 5") == [False, True, False, True]
        assert self._mask("n.s STARTS WITH 'h'") == [True, False, False, True]
        assert self._mask("n.x IN [5, 'str']") == [True, True, False, False]
        assert self._mask("n.x IS NULL") == [False, False, True, False]
        assert self._mask("n.x IS NOT NULL") == [True, True, False, True]
        assert self._mask("7 < n.x") == [False, False, False, True]
        assert self._mask("n.s =~ 'h.*'") == [True, False, False, True]

    def test_boolean_composition(self):
        assert self._mask("n.x > 4 AND n.s ENDS WITH 'o'") == [
            True, False, False, False]
        assert self._mask("n.x = 5 OR n.s = 'hi'") == [
            True, False, False, True]
        assert self._mask("NOT n.x IS NULL") == [True, True, False, True]

    def test_params(self):
        assert self._mask("n.x > $min", {"min": 6}) == [
            False, False, False, True]

    def test_residual_split(self):
        q = parse("MATCH (n) WHERE n.x > 4 AND size(n.s) > 2 RETURN n")
        cw = compile_where(q.clauses[0].where, "n")
        assert cw.has_columnar and cw.residual is not None
        assert list(cw.mask(self._nodes(), {})) == [True, False, False, True]

    def test_uncompilable(self):
        q = parse("MATCH (n) WHERE size(n.s) > 2 RETURN n")
        cw = compile_where(q.clauses[0].where, "n")
        assert not cw.has_columnar and cw.residual is not None


def _rows(res):
    # floats canonicalize through 9 significant digits: the fastpath and the
    # generic pipeline may SUM in different orders (hash-seed-dependent scan
    # order), and float addition is not associative — ulp-level noise like
    # 194.38789001697194 vs ...88 is equivalence, not a bug
    def _canon(v):
        if isinstance(v, float):
            return f"{v:.9g}"
        return repr(v)

    return sorted(
        tuple(_canon(v) for v in row) for row in res.rows
    )


QUERIES = [
    "MATCH (n:P) WHERE n.age > 40 RETURN n.i",
    "MATCH (n:P) WHERE n.age >= 10 AND n.city = 'Oslo' RETURN n.i, n.age",
    "MATCH (n) WHERE n.city IS NULL RETURN n.i",
    "MATCH (n:P) WHERE n.city IN ['Oslo', 'Bergen'] OR n.age < 5 RETURN n.i",
    "MATCH (n:P) WHERE n.age > 10 AND n.score IS NOT NULL RETURN n.i, n.score",
    "MATCH (n:P) WHERE n.age > $a RETURN n.i",
    "MATCH (n:P) WHERE n.age > 20 AND size(keys(n)) > 2 RETURN n.i",
    "MATCH (n:P) WHERE n.city STARTS WITH 'O' RETURN count(n)",
    "MATCH (n:P) WHERE n.age > 30 RETURN count(*)",
    "MATCH (x)-[:KNOWS]->(y) RETURN x.i, count(y)",
    "MATCH (x)<-[:KNOWS]-(y) RETURN x.i, count(*)",
    "MATCH (x)-[r:KNOWS]->(y) RETURN x, count(r)",
    "MATCH ()-[r:KNOWS]->() RETURN avg(r.w), sum(r.w), count(r), min(r.w), max(r.w)",
    "MATCH ()-[r:KNOWS]-() RETURN count(*), sum(r.w)",
    "MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(a) RETURN count(*)",
]


class TestFastpathEquivalence:
    """Every fastpath-eligible query must return exactly what the generic
    pipeline returns (as a multiset — no ORDER BY means no order contract)."""

    @pytest.mark.parametrize("query", QUERIES)
    def test_matches_generic(self, query, monkeypatch):
        ex = _executor(n=250, seed=7)
        params = {"a": 33}
        set_parallel_config(ParallelConfig(min_batch_size=1, max_workers=4))
        fast = ex.execute(query, params)
        # generic: disable every shortcut (the pattern-fastpath family is
        # retired into the columnar engine, so turning that off is the
        # whole story now)
        monkeypatch.setattr(ex.columnar, "enabled", False)
        monkeypatch.setattr(ex, "_match_scan_fast", lambda c, r, p: None)
        generic = ex.execute(query, params)
        assert fast.columns == generic.columns
        assert _rows(fast) == _rows(generic), query

    def test_scan_fast_path_used(self, monkeypatch):
        """The columnar path actually engages on large scans."""
        ex = _executor(n=250, seed=3)
        set_parallel_config(ParallelConfig(min_batch_size=1))
        called = {}
        import nornicdb_tpu_torch.cypher.parallel as par

        orig = par.compile_where

        def spy(where, var):
            called["yes"] = True
            return orig(where, var)

        monkeypatch.setattr(par, "compile_where", spy)
        ex.execute("MATCH (n:P) WHERE n.age > 40 RETURN n.i")
        assert called.get("yes")

    def test_optional_match_empty_scan(self):
        # columnar_min_rows=1 keeps the 50-node label on the columnar fast
        # path so its optional-empty branch stays regression-covered
        ex = _executor(n=50, seed=1)
        set_parallel_config(ParallelConfig(min_batch_size=1,
                                           columnar_min_rows=1))
        res = ex.execute(
            "OPTIONAL MATCH (n:P) WHERE n.age > 1000 RETURN n")
        assert res.rows == [[None]]

    def test_where_referencing_outer_binding(self):
        """Residual conjuncts may reference earlier bindings."""
        ex = _executor(n=120, seed=2)
        set_parallel_config(ParallelConfig(min_batch_size=1))
        q = ("MATCH (m) WHERE m.i = 0 "
             "MATCH (n:P) WHERE n.age > 10 AND n.i > m.i RETURN count(n)")
        fast = ex.execute(q)
        set_parallel_config(ParallelConfig(enabled=False))
        generic = ex.execute(q)
        assert fast.rows == generic.rows
