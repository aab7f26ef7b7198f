"""The cases of ``tests/test_apoc_ext.py`` run against the port on the CPU,
unchanged but for their imports (the executor takes ``device="cpu"``).
"""


import math

import pytest

from nornicdb_tpu_torch.apoc import call
from nornicdb_tpu_torch.cypher.executor import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.storage.schema import SchemaManager
from nornicdb_tpu_torch.storage.types import MemoryEngine


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


@pytest.fixture
def ex():
    import nornicdb_tpu_torch.apoc as apoc

    apoc.register_procedures()
    storage = MemoryEngine()
    schema = SchemaManager()
    schema.attach(storage)
    return CypherExecutor(storage, schema=schema)


# -- bitwise ----------------------------------------------------------------

def test_bitwise():
    assert call("apoc.bitwise.op", 12, "&", 10) == 8
    assert call("apoc.bitwise.op", 12, "OR", 10) == 14
    assert call("apoc.bitwise.op", 1, "<<", 4) == 16
    assert call("apoc.bitwise.and", 12, 10) == 8
    assert call("apoc.bitwise.or", [12, 10, 1]) == 15
    assert call("apoc.bitwise.xor", 12, 10) == 6
    assert call("apoc.bitwise.not", 0) == -1
    assert call("apoc.bitwise.setBit", 0, 3) == 8
    assert call("apoc.bitwise.clearBit", 15, 0) == 14
    assert call("apoc.bitwise.toggleBit", 8, 3) == 0
    assert call("apoc.bitwise.testBit", 8, 3) is True
    assert call("apoc.bitwise.countBits", 255) == 8
    assert call("apoc.bitwise.countBits", -1) == 64
    assert call("apoc.bitwise.op", None, "&", 1) is None


# -- json -------------------------------------------------------------------

def test_json_path_and_tools():
    doc = '{"a": {"b": [{"c": 42}]}, "xs": [1,2,3]}'
    assert call("apoc.json.path", doc, "a.b[0].c") == 42
    assert call("apoc.json.path", doc, "$.xs[2]") == 3
    assert call("apoc.json.path", doc, "missing.deep") is None
    assert call("apoc.json.validate", doc) is True
    assert call("apoc.json.validate", "{nope") is False
    assert call("apoc.json.parse", "[1,2]") == [1, 2]
    assert call("apoc.json.stringify", {"k": 1}) == '{"k": 1}'
    assert call("apoc.json.keys", doc) == ["a", "xs"]
    assert call("apoc.json.size", '{"a":1,"b":2}') == 2
    assert call("apoc.json.merge", {"a": 1}, {"b": 2}) == {"a": 1, "b": 2}
    flat = call("apoc.json.flatten", {"a": {"b": 1}, "xs": [5, 6]})
    assert flat == {"a.b": 1, "xs[0]": 5, "xs[1]": 6}
    assert call("apoc.json.set", {"a": {}}, "a.b", 7) == {"a": {"b": 7}}
    assert call("apoc.json.delete", {"a": 1, "b": 2}, "a") == {"b": 2}


# -- diff -------------------------------------------------------------------

def test_diff_maps_lists_strings():
    d = call("apoc.diff.maps", {"a": 1, "b": 2, "c": 3}, {"b": 2, "c": 9, "d": 4})
    assert d["leftOnly"] == {"a": 1}
    assert d["rightOnly"] == {"d": 4}
    assert d["inCommon"] == {"b": 2}
    assert d["different"] == {"c": {"left": 3, "right": 9}}

    l = call("apoc.diff.lists", [1, 2, 3], [2, 3, 4])
    assert l == {"leftOnly": [1], "rightOnly": [4], "inCommon": [2, 3]}

    s = call("apoc.diff.strings", "hello world", "hello there world")
    assert s["equal"] is False
    assert s["commonPrefix"].startswith("hello ")
    assert s["commonSuffix"].endswith("world")


def test_diff_nodes_uses_properties():
    from nornicdb_tpu_torch.storage.types import Node

    a = Node(labels=["A"], properties={"x": 1})
    b = Node(labels=["A"], properties={"x": 2})
    d = call("apoc.diff.nodes", a, b)
    assert d["different"] == {"x": {"left": 1, "right": 2}}


# -- stats ------------------------------------------------------------------

def test_stats_suite():
    xs = [2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0]
    assert call("apoc.stats.mean", xs) == 5.0
    assert call("apoc.stats.median", xs) == 4.5
    assert call("apoc.stats.mode", xs) == 4.0
    assert call("apoc.stats.stdev", xs, True) == 2.0
    assert call("apoc.stats.variance", xs, True) == 4.0
    assert call("apoc.stats.percentile", xs, 0.5) == 4.5
    assert call("apoc.stats.percentile", xs, 50) == 4.5
    q = call("apoc.stats.quartiles", xs)
    assert q["q2"] == 4.5
    assert call("apoc.stats.iqr", xs) == q["q3"] - q["q1"]
    z = call("apoc.stats.zscore", xs)
    assert abs(sum(z)) < 1e-9
    n = call("apoc.stats.normalize", xs)
    assert min(n) == 0.0 and max(n) == 1.0
    assert call("apoc.stats.correlation", [1, 2, 3], [2, 4, 6]) == pytest.approx(1.0)
    hist = call("apoc.stats.histogram", xs, 2)
    assert sum(b["count"] for b in hist) == len(xs)
    assert call("apoc.stats.outliers", [1, 2, 3, 2, 100]) == [100]
    s = call("apoc.stats.summary", xs)
    assert s["count"] == 8 and s["min"] == 2.0 and s["max"] == 9.0
    assert call("apoc.stats.mean", []) is None


# -- spatial ----------------------------------------------------------------

def test_spatial_geodesy():
    paris = {"latitude": 48.8566, "longitude": 2.3522}
    london = {"latitude": 51.5074, "longitude": -0.1278}
    d = call("apoc.spatial.distance", paris, london)
    assert 330_000 < d < 350_000  # ~344 km
    b = call("apoc.spatial.bearing", paris, london)
    assert 300 < b < 340  # roughly NW
    dest = call("apoc.spatial.destination", paris, d, b)
    assert abs(dest["latitude"] - london["latitude"]) < 0.01
    mid = call("apoc.spatial.midpoint", paris, london)
    assert 48.8 < mid["latitude"] < 51.6
    assert call("apoc.spatial.withinDistance", paris, london, 400_000) is True
    assert call("apoc.spatial.withinDistance", paris, london, 100_000) is False
    box = call("apoc.spatial.boundingBox", [paris, london])
    assert call("apoc.spatial.within", mid, box) is True
    c = call("apoc.spatial.centroid", [paris, london])
    assert abs(c["latitude"] - (48.8566 + 51.5074) / 2) < 1e-9


def test_spatial_geohash_roundtrip():
    p = {"latitude": 37.7749, "longitude": -122.4194}
    gh = call("apoc.spatial.encodeGeohash", p, 9)
    assert len(gh) == 9
    back = call("apoc.spatial.decodeGeohash", gh)
    assert abs(back["latitude"] - p["latitude"]) < 0.001
    assert abs(back["longitude"] - p["longitude"]) < 0.001
    assert call("apoc.spatial.decodeGeohash", "!!") is None


# -- scoring ----------------------------------------------------------------

def test_scoring_metrics():
    assert call("apoc.scoring.existence", 5.0, True) == 5.0
    assert call("apoc.scoring.existence", 5.0, False) == 0.0
    # pareto: at the 80% value the score reaches 80% of max
    p = call("apoc.scoring.pareto", 0, 10, 100, 10)
    assert abs(p - 80.0) < 1e-6
    assert call("apoc.scoring.pareto", 5, 10, 100, 3) == 0.0
    assert call("apoc.scoring.cosine", [1, 0], [1, 0]) == pytest.approx(1.0)
    assert call("apoc.scoring.cosine", [1, 0], [0, 1]) == pytest.approx(0.0)
    assert call("apoc.scoring.euclidean", [0, 0], [3, 4]) == 5.0
    assert call("apoc.scoring.manhattan", [0, 0], [3, 4]) == 7.0
    assert call("apoc.scoring.jaccard", [1, 2, 3], [2, 3, 4]) == 0.5
    assert call("apoc.scoring.dice", [1, 2], [2, 3]) == 0.5
    assert call("apoc.scoring.pearson", [1, 2, 3], [3, 2, 1]) == pytest.approx(-1.0)
    assert call("apoc.scoring.sigmoid", 0) == 0.5
    sm = call("apoc.scoring.softmax", [1.0, 1.0])
    assert sm == [0.5, 0.5]
    assert call("apoc.scoring.rank", [10, 30, 20]) == [3, 1, 2]
    assert call("apoc.scoring.topK", [5, 1, 9, 3], 2) == [9, 5]
    assert call("apoc.scoring.tfidf", 0, 100, 10, 1) == 0.0
    assert call("apoc.scoring.tfidf", 3, 100, 10, 1) > 0


# -- xml --------------------------------------------------------------------

def test_xml_parse_and_helpers():
    doc = '<root id="1"><item name="a">hello</item><item name="b"/></root>'
    m = call("apoc.xml.parse", doc)
    assert m["_type"] == "root" and m["id"] == "1"
    assert m["_children"][0]["_text"] == "hello"
    assert call("apoc.xml.validate", doc) is True
    assert call("apoc.xml.validate", "<broken") is False
    assert call("apoc.xml.parse", "<broken") is None
    assert '"_type": "root"' in call("apoc.xml.toJson", doc)
    assert call("apoc.xml.escape", '<a href="x">') == "&lt;a href=&quot;x&quot;&gt;"
    assert call("apoc.xml.unescape", "&lt;x&gt;") == "<x>"
    assert call("apoc.xml.getAttribute", doc, "item", "name") == "a"
    assert call("apoc.xml.getText", doc, "item") == "hello"


# -- procedures -------------------------------------------------------------

def test_apoc_cypher_run(ex):
    ex.execute("CREATE (:P {name: 'a'}), (:P {name: 'b'})")
    res = ex.execute(
        "CALL apoc.cypher.run('MATCH (p:P) RETURN p.name AS name ORDER BY name', {}) "
        "YIELD value RETURN value.name AS n"
    )
    assert [r[0] for r in res.rows] == ["a", "b"]


def test_apoc_cypher_run_many_and_first_column(ex):
    ex.execute(
        "CALL apoc.cypher.runMany('CREATE (:Q {v: 1}); CREATE (:Q {v: 2})', {})"
    )
    res = ex.execute(
        "CALL apoc.cypher.runFirstColumnSingle('MATCH (q:Q) RETURN count(q)', {}) "
        "YIELD value RETURN value"
    )
    assert res.rows[0][0] == 2
    res = ex.execute(
        "CALL apoc.cypher.runFirstColumnMany('MATCH (q:Q) RETURN q.v ORDER BY q.v', {}) "
        "YIELD value RETURN value"
    )
    assert [r[0] for r in res.rows] == [1, 2]


def test_apoc_schema_nodes_and_assert(ex):
    ex.schema.create_index("i1", "property", "Person", ["name"])
    res = ex.execute("CALL apoc.schema.nodes()")
    assert any("Person" in str(r) for r in res.rows)
    # assert converges: creates listed, drops unlisted
    res = ex.execute(
        "CALL apoc.schema.assert({City: [['name']]}, {}) "
        "YIELD label, action RETURN label, action"
    )
    actions = {(r[0], r[1]) for r in res.rows}
    assert ("City", "CREATED") in actions
    assert ("Person", "DROPPED") in actions
    names = {i.label for i in ex.schema.list_indexes()}
    assert names == {"City"}


def test_apoc_nodes_link_connected_delete(ex):
    ex.execute("CREATE (:N {i: 1}), (:N {i: 2}), (:N {i: 3})")
    res = ex.execute(
        "MATCH (n:N) WITH n ORDER BY n.i WITH collect(n) AS ns "
        "CALL apoc.nodes.link(ns, 'NEXT') YIELD created RETURN created"
    )
    assert res.rows[0][0] == 2
    res = ex.execute(
        "MATCH (a:N {i: 1}), (b:N {i: 2}) "
        "CALL apoc.nodes.connected(a, b) YIELD value RETURN value"
    )
    assert res.rows[0][0] is True
    res = ex.execute(
        "MATCH (a:N {i: 1}), (b:N {i: 3}) "
        "CALL apoc.nodes.connected(a, b) YIELD value RETURN value"
    )
    assert res.rows[0][0] is False
    ex.execute("MATCH (n:N) WITH collect(n) AS ns CALL apoc.nodes.delete(ns) YIELD value RETURN value")
    assert ex.execute("MATCH (n:N) RETURN count(n)").rows[0][0] == 0


def test_apoc_nodes_collapse(ex):
    ex.execute(
        "CREATE (a:A {k: 1})-[:R]->(b:B {k: 2}), (c:C)-[:S]->(b)"
    )
    res = ex.execute(
        "MATCH (a:A), (b:B) "
        "CALL apoc.nodes.collapse([a, b]) YIELD node RETURN node"
    )
    merged = res.rows[0][0]
    assert set(merged.labels) == {"A", "B"}
    assert merged.properties["k"] == 1  # first node's props win
    # c's edge rewired to merged node
    res = ex.execute("MATCH (:C)-[:S]->(x) RETURN labels(x)")
    assert set(res.rows[0][0]) == {"A", "B"}


def test_apoc_log_and_graph(ex):
    res = ex.execute("CALL apoc.log.info('hello %s', 'world') YIELD value RETURN value")
    assert res.rows[0][0] == "hello world"
    res = ex.execute(
        "MATCH (n) WITH collect(n) AS ns "
        "CALL apoc.graph.fromData(ns, [], 'g', {k: 1}) YIELD graph RETURN graph.name"
    )
    assert res.rows[0][0] == "g"


def test_apoc_meta_stats(ex):
    ex.execute("CREATE (:X)-[:R]->(:Y), (:X)")
    res = ex.execute(
        "CALL apoc.meta.stats() YIELD nodeCount, relCount, labels "
        "RETURN nodeCount, relCount, labels"
    )
    nc, rc, labels = res.rows[0]
    assert nc == 3 and rc == 1
    assert labels == {"X": 2, "Y": 1}


# -- review regressions -----------------------------------------------------

def test_run_many_semicolon_in_string_literal(ex):
    res = ex.execute(
        "CALL apoc.cypher.runMany(\"CREATE (:S {name: 'a;b'}); CREATE (:S {name: 'c'})\", {})"
    )
    assert len(res.rows) == 2
    got = ex.execute("MATCH (s:S) RETURN s.name ORDER BY s.name")
    assert [r[0] for r in got.rows] == ["a;b", "c"]


def test_collapse_duplicate_target_survives(ex):
    ex.execute("CREATE (:D {k: 1})")
    res = ex.execute(
        "MATCH (d:D) CALL apoc.nodes.collapse([d, d]) YIELD node RETURN node"
    )
    assert res.rows[0][0].properties["k"] == 1
    assert ex.execute("MATCH (d:D) RETURN count(d)").rows[0][0] == 1


def test_schema_assert_keeps_equivalent_index(ex):
    ex.schema.create_index("my_idx", "property", "Person", ["name"])
    res = ex.execute(
        "CALL apoc.schema.assert({Person: [['name']]}, {}) "
        "YIELD label, action RETURN label, action"
    )
    assert res.rows == [["Person", "KEPT"]]
    assert len(ex.schema.list_indexes()) == 1  # no duplicate created


def test_json_path_canonical():
    # the functions_ext implementation is the single registration
    assert call("apoc.json.path", None, "a.b") is None
    assert call("apoc.json.path", {"a": {"b": 1}}, "a.b") == 1


def test_first_column_no_args_is_syntax_error(ex):
    from nornicdb_tpu_torch.errors import CypherSyntaxError
    with pytest.raises(CypherSyntaxError):
        ex.execute("CALL apoc.cypher.runFirstColumnSingle()")


def test_agg_gap_functions():
    assert call("apoc.agg.nth", [10, 20, 30], 1) == 20
    assert call("apoc.agg.nth", [10], 5) is None
    assert call("apoc.agg.slice", [1, 2, 3, 4], 1, 2) == [2, 3]
    assert call("apoc.agg.mode", [1, 2, 2, 3]) == 2
    assert call("apoc.agg.mode", [[1], [1], [2]]) == [1]  # unhashable values ok
    mi = call("apoc.agg.minItems", ["a", "b", "c"], [2, 1, 1])
    assert mi == {"value": 1, "items": ["b", "c"]}
    fr = call("apoc.agg.frequencies", [{"k": 1}, {"k": 1}, {"k": 2}])
    assert fr[0] == {"item": {"k": 1}, "count": 2}


def test_apoc_util_gaps(ex):
    res = ex.execute("RETURN apoc.util.encodeBase64('abc'), apoc.util.encodeUrl('a b&c')")
    assert res.rows[0] == ["YWJj", "a%20b%26c"]
    from nornicdb_tpu_torch.errors import NornicError
    with pytest.raises(Exception, match="must be positive"):
        ex.execute("RETURN apoc.util.validate(true, 'must be positive %s', [1])")
    # falsy predicate: no error
    assert ex.execute("RETURN apoc.util.validate(false, 'x', [])").rows == [[None]]


def _second_session(ex):
    return CypherExecutor(ex.storage, schema=ex.schema)


def test_apoc_lock_procedures(ex):
    ex.execute("CREATE (:L {name: 'a'})")
    res = ex.execute(
        "MATCH (l:L) CALL apoc.lock.nodes([l]) YIELD locked RETURN locked")
    assert res.rows[0][0] == 1
    res = ex.execute(
        "MATCH (l:L) CALL apoc.lock.isLocked(l) YIELD locked RETURN locked")
    assert res.rows[0][0] is True
    # same session re-lock is reentrant (rows can bind a node twice)
    res = ex.execute(
        "MATCH (l:L) CALL apoc.lock.tryLock(l, 50) YIELD acquired RETURN acquired")
    assert res.rows[0][0] is True
    # a DIFFERENT session fails fast
    other = _second_session(ex)
    res = other.execute(
        "MATCH (l:L) CALL apoc.lock.tryLock(l, 50) YIELD acquired RETURN acquired")
    assert res.rows[0][0] is False
    # other session cannot release our lock
    res = other.execute(
        "MATCH (l:L) CALL apoc.lock.unlockNodes([l]) YIELD released RETURN released")
    assert res.rows[0][0] == 0
    res = other.execute("CALL apoc.lock.unlockAll() YIELD released RETURN released")
    assert res.rows[0][0] == 0
    # unlockAll unwinds our reentrant holds; other can then acquire
    assert ex.execute(
        "CALL apoc.lock.unlockAll() YIELD released RETURN released").rows[0][0] == 1
    res = other.execute(
        "MATCH (l:L) CALL apoc.lock.tryLock(l, 50) YIELD acquired RETURN acquired")
    assert res.rows[0][0] is True
    # admin escape hatch releases foreign locks
    assert ex.execute("CALL apoc.lock.clear() YIELD cleared RETURN cleared").rows[0][0] == 1


def test_apoc_lock_duplicate_ids_no_self_deadlock(ex):
    ex.execute("CREATE (:L2 {name: 'x'})")
    res = ex.execute(
        "MATCH (l:L2) CALL apoc.lock.nodes([l, l]) YIELD locked RETURN locked")
    assert res.rows[0][0] == 1  # deduped, returned promptly
    ex.execute("CALL apoc.lock.clear()")


def test_apoc_lock_trylock_list_all_or_nothing(ex):
    ex.execute("CREATE (:L3 {name: 'p'}), (:L3 {name: 'q'})")
    other = _second_session(ex)
    # other session takes q; our list tryLock must fail AND not hold p
    other.execute("MATCH (l:L3 {name: 'q'}) CALL apoc.lock.nodes([l]) YIELD locked RETURN locked")
    res = ex.execute(
        "MATCH (l:L3) WITH collect(l) AS ls "
        "CALL apoc.lock.tryLock(ls, 50) YIELD acquired RETURN acquired")
    assert res.rows[0][0] is False
    res = other.execute(
        "MATCH (l:L3 {name: 'p'}) CALL apoc.lock.tryLock(l, 50) YIELD acquired RETURN acquired")
    assert res.rows[0][0] is True  # p was rolled back, not leaked
    other.execute("CALL apoc.lock.clear()")


def test_apoc_search_procedures(ex):
    ex.execute(
        "CREATE (:Emp {name: 'Ann', dept: 'eng', age: 30}), "
        "(:Emp {name: 'Bob', dept: 'eng', age: 45}), "
        "(:Mgr {name: 'Cat', dept: 'eng', age: 50}), "
        "(:Emp {name: 'Dee', dept: 'hr', age: 30})"
    )
    r = ex.execute("CALL apoc.search.node('Emp', 'dept', 'eng') YIELD node RETURN count(node)")
    assert r.rows[0][0] == 2
    r = ex.execute("CALL apoc.search.node('Emp', 'age', 40, '>') YIELD node RETURN node.name")
    assert [x[0] for x in r.rows] == ["Bob"]
    r = ex.execute("CALL apoc.search.node('Emp', 'name', 'A', 'starts with') YIELD node RETURN node.name")
    assert [x[0] for x in r.rows] == ["Ann"]
    r = ex.execute(
        "CALL apoc.search.nodeAll('Emp', {dept: 'eng', age: 30}) YIELD node RETURN node.name")
    assert [x[0] for x in r.rows] == ["Ann"]
    r = ex.execute(
        "CALL apoc.search.nodeAny('Emp', {dept: 'hr', age: 45}) YIELD node RETURN count(node)")
    assert r.rows[0][0] == 2  # Bob (age) + Dee (dept)
    r = ex.execute(
        "CALL apoc.search.multiSearchAll(['Emp', 'Mgr'], {dept: 'eng'}) YIELD node RETURN count(node)")
    assert r.rows[0][0] == 3
    r = ex.execute(
        "CALL apoc.search.multiSearchAny(['Emp', 'Mgr'], {age: 50}) YIELD node RETURN node.name")
    assert [x[0] for x in r.rows] == ["Cat"]


def test_apoc_search_null_and_bool_semantics(ex):
    ex.execute("CREATE (:S2 {flag: true}), (:S2 {n: 5})")
    # null criterion matches nothing (three-valued logic), not missing-key nodes
    r = ex.execute("CALL apoc.search.nodeAll('S2', {nickname: null}) YIELD node RETURN count(node)")
    assert r.rows[0][0] == 0
    # boolean true does not equal integer 1 (Cypher equality)
    r = ex.execute("CALL apoc.search.node('S2', 'flag', 1) YIELD node RETURN count(node)")
    assert r.rows[0][0] == 0
    r = ex.execute("CALL apoc.search.node('S2', 'flag', true) YIELD node RETURN count(node)")
    assert r.rows[0][0] == 1


def test_apoc_search_does_not_clear_query_cache(ex):
    from nornicdb_tpu_torch.cache import QueryCache
    ex.cache = QueryCache(capacity=10, ttl=60.0)
    ex.execute("CREATE (:C1 {v: 1})")
    r1 = ex.execute("MATCH (c:C1) RETURN c.v")  # populates cache
    ex.execute("CALL apoc.search.node('C1', 'v', 1) YIELD node RETURN node")
    # read-classified: the cached MATCH result must still be served
    stats_before = ex.cache.stats.hits if hasattr(ex.cache, "stats") else None
    r2 = ex.execute("MATCH (c:C1) RETURN c.v")
    assert r2.rows == r1.rows
    if stats_before is not None:
        assert ex.cache.stats.hits == stats_before + 1
    ex.cache = None


def test_refactor_clone_settype_invert_redirect(ex):
    ex.execute("CREATE (a:RA {k: 1})-[:REL {w: 2}]->(b:RB)")
    # clone with relationships (clone copies properties, so match count after)
    r = ex.execute(
        "MATCH (a:RA) CALL apoc.refactor.cloneNodes([a], true) "
        "YIELD output RETURN output.k")
    assert r.rows[0][0] == 1
    assert ex.execute("MATCH (:RA)-[r:REL]->(:RB) RETURN count(r)").rows[0][0] == 2
    # setType on ONE rel (both RA nodes carry k:1 — the clone is faithful)
    ex.execute(
        "MATCH (a:RA)-[r:REL]->(:RB) WITH r LIMIT 1 "
        "CALL apoc.refactor.setType(r, 'KNOWS') YIELD output RETURN output")
    assert ex.execute("MATCH ()-[r:KNOWS]->() RETURN r.w").rows[0][0] == 2
    assert ex.execute("MATCH ()-[r:KNOWS]->() RETURN count(r)").rows[0][0] == 1
    # invert
    ex.execute("MATCH ()-[r:KNOWS]->() CALL apoc.refactor.invert(r) YIELD output RETURN output")
    assert ex.execute("MATCH (:RB)-[r:KNOWS]->(:RA) RETURN count(r)").rows[0][0] == 1


def test_refactor_redirect_and_rename_property(ex):
    ex.execute("CREATE (a:RC)-[:R2]->(b:RD), (c:RE)")
    ex.execute(
        "MATCH (a:RC)-[r:R2]->(), (c:RE) "
        "CALL apoc.refactor.to(r, c) YIELD output RETURN output")
    assert ex.execute("MATCH (:RC)-[r:R2]->(:RE) RETURN count(r)").rows[0][0] == 1
    ex.execute("CREATE (:RF {old_name: 'x'}), (:RG {old_name: 'y'})")
    r = ex.execute(
        "CALL apoc.refactor.rename.nodeProperty('old_name', 'name') "
        "YIELD total RETURN total")
    assert r.rows[0][0] == 2
    assert ex.execute("MATCH (f:RF) RETURN f.name").rows[0][0] == "x"


def test_refactor_extract_node_and_normalize_bool(ex):
    ex.execute("CREATE (a:RH)-[:WORKS_AT {since: 2020}]->(b:RI)")
    r = ex.execute(
        "MATCH ()-[r:WORKS_AT]->() "
        "CALL apoc.refactor.extractNode(r, ['Job'], 'HAS', 'AT') "
        "YIELD output RETURN output.since")
    assert r.rows[0][0] == 2020
    assert ex.execute(
        "MATCH (:RH)-[:HAS]->(j:Job)-[:AT]->(:RI) RETURN count(j)").rows[0][0] == 1
    ex.execute("CREATE (:RJ {active: 'yes'}), (:RJ {active: 'no'}), (:RJ {active: 'maybe'})")
    ex.execute(
        "MATCH (n:RJ) CALL apoc.refactor.normalizeAsBoolean(n, 'active', "
        "['yes'], ['no']) YIELD entity RETURN entity")
    rows = ex.execute(
        "MATCH (n:RJ) RETURN n.active ORDER BY toString(n.active)").rows
    assert sorted([r[0] for r in rows], key=str) == [False, None, True]


def test_refactor_clone_self_loop(ex):
    ex.execute("CREATE (a:SL)-[:SELF]->(a)")
    ex.execute("MATCH (a:SL) CALL apoc.refactor.cloneNodes([a], true) YIELD output RETURN output")
    # exactly one new self-loop on the clone, nothing cross-wired
    assert ex.execute("MATCH ()-[r:SELF]->() RETURN count(r)").rows[0][0] == 2
    r = ex.execute("MATCH (n:SL)-[:SELF]->(n) RETURN count(n)")
    assert r.rows[0][0] == 2  # both are self-loops


def test_refactor_settype_preserves_identity(ex):
    ex.execute("CREATE (:RK)-[:OLD {w: 1}]->(:RL)")
    before = ex.execute("MATCH ()-[r:OLD]->() RETURN r").rows[0][0]
    ex.execute("MATCH ()-[r:OLD]->() CALL apoc.refactor.setType(r, 'NEW') YIELD output RETURN output")
    after = ex.execute("MATCH ()-[r:NEW]->() RETURN r").rows[0][0]
    assert after.id == before.id  # same edge, re-typed in place


def test_refactor_to_missing_target_not_destructive(ex):
    ex.execute("CREATE (a:RM)-[:R3]->(b:RN)")
    from nornicdb_tpu_torch.storage.types import Node
    ghost = Node(id="never-stored", labels=["Ghost"])  # not in storage
    r = ex.execute("MATCH ()-[r:R3]->() RETURN count(r)")
    assert r.rows[0][0] == 1
    import pytest as _pt
    from nornicdb_tpu_torch.errors import NotFoundError
    with _pt.raises(Exception):
        from nornicdb_tpu_torch.apoc.procedures import apoc_redirect_to
        e = ex.execute("MATCH ()-[r:R3]->() RETURN r").rows[0][0]
        apoc_redirect_to(ex, [e, ghost], {})
    # the original edge survived the failed redirect
    assert ex.execute("MATCH ()-[r:R3]->() RETURN count(r)").rows[0][0] == 1


def test_refactor_rename_property_scoped(ex):
    ex.execute("CREATE (:RP {v: 1}), (:RQ {v: 2})")
    r = ex.execute(
        "MATCH (n:RP) WITH collect(n) AS ns "
        "CALL apoc.refactor.rename.nodeProperty('v', 'val', ns) "
        "YIELD total RETURN total")
    assert r.rows[0][0] == 1
    assert ex.execute("MATCH (n:RQ) RETURN n.v").rows[0][0] == 2  # untouched
    assert ex.execute("MATCH (n:RP) RETURN n.val").rows[0][0] == 1


def test_convert_gaps():
    assert call("apoc.convert.toSet", [1, 2, 2, 1, 3]) == [1, 2, 3]
    assert call("apoc.convert.toSet", [{"a": 1}, {"a": 1}]) == [{"a": 1}]
    assert call("apoc.convert.toSortedJsonMap", {"b": 1, "a": 2}) == '{"a": 2, "b": 1}'
    assert call("apoc.convert.toIntList", ["1", "2.7", None, "x"]) == [1, 2, None, None]
    assert call("apoc.convert.toBooleanList", ["true", "no", 1, 0]) == [True, False, True, False]
    from nornicdb_tpu_torch.storage.types import Node
    n = Node(properties={"meta": '{"a": {"b": 5}}'})
    assert call("apoc.convert.getJsonProperty", n, "meta", "a.b") == 5
    call("apoc.convert.setJsonProperty", n, "cfg", {"x": 1})
    assert n.properties["cfg"] == '{"x": 1}'


def test_date_gaps():
    ms = call("apoc.date.fromISO8601", "2026-07-29T12:30:00Z")
    assert call("apoc.date.toISO8601", ms) == "2026-07-29T12:30:00.000Z"
    assert call("apoc.date.toUnixTime", ms) == ms // 1000
    assert call("apoc.date.fromUnixTime", ms // 1000) == ms
    assert call("apoc.date.field", ms, "year") == 2026
    assert call("apoc.date.field", ms, "h") == 12
    assert call("apoc.date.field", ms, "m") == 30  # minutes, not month
    f = call("apoc.date.fields", ms)
    assert (f["year"], f["month"], f["day"], f["hour"]) == (2026, 7, 29, 12)
    assert f["dayOfWeek"] == 3 and f["dayOfYear"] == 210  # Wed, day 210
    assert call("apoc.date.fromISO8601", None) is None


def test_convert_review_regressions():
    big = 9007199254740993  # 2^53 + 1: int(float()) would corrupt it
    assert call("apoc.convert.toIntList", [big]) == [big]
    # string vs structurally-equal list stay distinct
    assert call("apoc.convert.toSet", ["[1, 2]", [1, 2]]) == ["[1, 2]", [1, 2]]
    assert call("apoc.convert.toSet", [1, True]) == [1, True]
    # reference JSON-string forms
    assert call("apoc.convert.getJsonProperty", '{"name": "Alice"}', "name") == "Alice"
    out = call("apoc.convert.setJsonProperty", '{"a": 1}', "b", 2)
    import json as _j
    assert _j.loads(out) == {"a": 1, "b": 2}
    assert call("apoc.convert.getJsonProperty", "{broken", "x") is None


def test_temporal_calendar_helpers():
    ms = call("apoc.date.fromISO8601", "2026-07-29T12:30:45Z")  # Wednesday
    assert call("apoc.temporal.startOf", ms, "day") == call(
        "apoc.date.fromISO8601", "2026-07-29T00:00:00Z")
    assert call("apoc.temporal.startOf", ms, "month") == call(
        "apoc.date.fromISO8601", "2026-07-01T00:00:00Z")
    assert call("apoc.temporal.startOf", ms, "week") == call(
        "apoc.date.fromISO8601", "2026-07-27T00:00:00Z")  # Monday
    assert call("apoc.temporal.endOf", ms, "day") == call(
        "apoc.date.fromISO8601", "2026-07-30T00:00:00Z") - 1
    assert call("apoc.temporal.isWeekend", ms) is False
    assert call("apoc.temporal.isWeekday", ms) is True
    assert call("apoc.temporal.quarter", ms) == 3
    assert call("apoc.temporal.isLeapYear", 2024) is True
    assert call("apoc.temporal.isLeapYear", 2026) is False
    assert call("apoc.temporal.daysInMonth", 2026, 2) == 28
    assert call("apoc.temporal.daysInMonth", 2024, 2) == 29
    day = 86_400_000
    assert call("apoc.temporal.difference", ms, ms + 3 * day, "days") == 3
    assert call("apoc.temporal.difference", ms, ms + 90_000, "m") == 1
    # signed: earlier - later is negative (ref temporal.go semantics)
    assert call("apoc.temporal.difference", ms + 3 * day, ms, "days") == -3
    assert call("apoc.temporal.difference", ms, ms + 70 * day, "months") == 2
    assert call("apoc.temporal.difference", ms, ms + 400 * day, "year") == 1
    assert call("apoc.temporal.difference", ms, ms + 120_000, "minute") == 2
    birth = call("apoc.date.fromISO8601", "2000-08-15T00:00:00Z")
    assert call("apoc.temporal.age", birth, ms) == 25  # birthday not yet
    birth2 = call("apoc.date.fromISO8601", "2000-07-01T00:00:00Z")
    assert call("apoc.temporal.age", birth2, ms) == 26
    assert call("apoc.temporal.startOf", None, "day") is None
    assert call("apoc.temporal.startOf", ms, "nope") is None


def test_map_gaps():
    assert call("apoc.map.fromValues", ["a", 1, "b", 2]) == {"a": 1, "b": 2}
    assert call("apoc.map.setEntry", {"a": 1}, "b", 2) == {"a": 1, "b": 2}
    assert call("apoc.map.setPairs", {}, [["x", 1], ["y", 2]]) == {"x": 1, "y": 2}
    assert call("apoc.map.setLists", {}, ["p", "q"], [1, 2]) == {"p": 1, "q": 2}
    assert call("apoc.map.setValues", {"a": 0}, ["a", 1, "b", 2]) == {"a": 1, "b": 2}
    assert call("apoc.map.mget", {"a": 1}, ["a", "zz"], -1) == [1, -1]
    assert call("apoc.map.keys", {"b": 2, "a": 1}) == ["a", "b"]  # sorted
    flat = {"a.b": 1, "a.c": 2, "d": 3}
    assert call("apoc.map.unflatten", flat) == {"a": {"b": 1, "c": 2}, "d": 3}
    # flatten/unflatten round-trip
    nested = {"x": {"y": {"z": 9}}, "w": 1}
    assert call("apoc.map.unflatten", call("apoc.map.flatten", nested)) == nested
    tree = {"a": {"b": 1}, "keep": True}
    out = call("apoc.map.updateTree", tree, "a.b", 2)
    assert out == {"a": {"b": 2}, "keep": True}
    assert tree["a"]["b"] == 1  # copy-on-write, original untouched
    assert call("apoc.map.updateTree", {}, "x.y.z", 7) == {"x": {"y": {"z": 7}}}
    assert call("apoc.map.dropNullValues", {"a": 1, "b": None}) == {"a": 1}
    # original maps untouched (functional semantics)
    m = {"a": 1}
    call("apoc.map.setEntry", m, "b", 2)
    assert m == {"a": 1}


def test_coll_gaps():
    assert call("apoc.coll.containsAny", [1, 2, 3], [9, 2]) is True
    assert call("apoc.coll.containsAny", [1, 2], [9]) is False
    assert call("apoc.coll.containsSorted", [1, 3, 5, 7], 5) is True
    assert call("apoc.coll.containsSorted", [1, 3, 5, 7], 4) is False
    assert call("apoc.coll.different", [1, 2, 3, 4], [2, 4]) == [1, 3]
    assert call("apoc.coll.disjunction", [1, 2, 3], [2, 3, 4]) == [1, 4]
    d = call("apoc.coll.duplicatesWithCount", ["a", "b", "a", "a"])
    assert d == [{"item": "a", "count": 3}]
    assert call("apoc.coll.insertAll", [1, 4], 1, [2, 3]) == [1, 2, 3, 4]
    assert call("apoc.coll.isEmpty", []) is True
    assert call("apoc.coll.isNotEmpty", [1]) is True
    assert call("apoc.coll.pairsMin", [1, 2, 3, 4, 5]) == [[1, 2], [3, 4]]
    assert call("apoc.coll.removeAll", [1, 2, 3, 2], [2]) == [1, 3]
    assert call("apoc.coll.set", [1, 2, 3], 1, 9) == [1, 9, 3]
    assert call("apoc.coll.set", [1], 5, 9) == [1]  # out of range: unchanged
    assert call("apoc.coll.slice", [1, 2, 3, 4], 1, 2) == [2, 3]
    maps = [{"n": 1}, {"n": 3}, {"x": 0}, {"n": 2}]
    assert call("apoc.coll.sortMaps", maps, "n") == [
        {"n": 1}, {"n": 2}, {"n": 3}, {"x": 0}]  # ascending, nulls last
    assert call("apoc.coll.unionAll", [1, 2], [2, 3]) == [1, 2, 2, 3]
    fam = call("apoc.coll.frequenciesAsMap", ["a", "b", "a"])
    assert {"item": "a", "count": 2} in fam  # reference list-of-maps shape
    assert call("apoc.coll.isEmpty", None) is None


def test_coll_review_regressions():
    # disjunction dedups (set semantics)
    assert call("apoc.coll.disjunction", [1, 1, 2], [2, 3]) == [1, 3]
    # non-comparable probe is just not contained, not a crash
    assert call("apoc.coll.containsSorted", ["a", "b"], 3) is False
    # mixed-type sort keys don't crash; groups by type (ascending default)
    out = call("apoc.coll.sortMaps", [{"n": 1}, {"n": "x"}, {"n": 2}], "n")
    assert [m["n"] for m in out] == [1, 2, "x"]
    # OOB insertAll is a no-op
    assert call("apoc.coll.insertAll", [1, 2], 99, [3]) == [1, 2]
    assert call("apoc.coll.insertAll", [1, 2], -1, [3]) == [1, 2]


def test_text_gaps():
    assert call("apoc.text.capitalizeAll", "hello world") == "HELLO WORLD"
    assert call("apoc.text.decapitalizeAll", "Hello World") == "hello world"
    assert call("apoc.text.reverse", "abc") == "cba"
    assert call("apoc.text.trim", "  x  ") == "x"
    assert call("apoc.text.ltrim", "  x ") == "x "
    assert call("apoc.text.indexesOf", "banana", "a") == [1, 3, 5]
    assert call("apoc.text.indexesOf", "banana", "a", 2) == [3, 5]
    assert call("apoc.text.fromCodePoint", [72, 105]) == "Hi"
    assert call("apoc.text.bytesToString", call("apoc.text.bytes", "héllo")) == "héllo"
    assert call("apoc.text.hammingDistance", "karolin", "kathrin") == 3
    assert call("apoc.text.hammingDistance", "abc", "abcd") == -1  # ref sentinel
    jw = call("apoc.text.jaroWinklerDistance", "MARTHA", "MARHTA")
    assert abs(jw - 0.9611) < 0.001  # canonical example
    assert call("apoc.text.jaroWinklerDistance", "x", "x") == 1.0
    assert call("apoc.text.phonetic", "Robert") == "R163"
    assert call("apoc.text.phonetic", "Rupert") == "R163"
    assert call("apoc.text.phoneticDelta", "Robert", "Rupert") == 0  # same code
    assert call("apoc.text.phoneticDelta", "Robert", "Xylophone") == 4
    assert call("apoc.text.reverse", None) is None


def test_jaro_winkler_short_strings():
    # window clamps to 1: transposed 2-char strings are similar, not 0
    assert call("apoc.text.jaroWinklerDistance", "ab", "ba") > 0.5


def test_number_gaps():
    assert call("apoc.number.romanize", 1994) == "MCMXCIV"
    assert call("apoc.number.arabize", "MCMXCIV") == 1994
    assert call("apoc.number.arabize", call("apoc.number.romanize", 3888)) == 3888
    assert call("apoc.number.romanize", 0) is None
    assert call("apoc.number.toHex", 255) == "FF"  # ref uppercases
    assert call("apoc.number.fromHex", "ff") == 255
    assert call("apoc.number.fromHex", "FF") == 255
    assert call("apoc.number.toBinary", 10) == "1010"
    assert call("apoc.number.fromBinary", "1010") == 10
    assert call("apoc.number.toOctal", 8) == "10"
    assert call("apoc.number.toBase", 255, 36) == "73"
    assert call("apoc.number.fromBase", "73", 36) == 255
    assert call("apoc.number.toBase", -10, 2) == "-1010"
    assert call("apoc.number.fromHex", "zz") is None
    # strconv strictness: prefixes/underscores/overflow all rejected
    assert call("apoc.number.fromHex", "0xff") is None
    assert call("apoc.number.fromBinary", "0b1") is None
    assert call("apoc.number.fromHex", "f_f") is None
    assert call("apoc.number.fromHex", "ffffffffffffffffff") is None  # >int64
    assert call("apoc.number.arabize", "VIX") == 14  # ref's subtractive rule


def test_math_gaps():
    assert call("apoc.math.clamp", 15, 0, 10) == 10.0
    assert call("apoc.math.lerp", 0, 10, 0.5) == 5.0
    assert call("apoc.math.gcd", 12, 18) == 6
    assert call("apoc.math.lcm", 4, 6) == 12
    assert call("apoc.math.factorial", 5) == 120
    assert call("apoc.math.factorial", -1) == 1  # ref: n <= 1 -> 1
    assert call("apoc.math.factorial", 21) is None  # int64 overflow guard
    assert call("apoc.math.fibonacci", 10) == 55
    assert call("apoc.math.isPrime", 97) is True
    assert call("apoc.math.isPrime", 1) is False
    assert call("apoc.math.nextPrime", 97) == 101
    import math as _m
    assert abs(call("apoc.math.logit", 0.5)) < 1e-12
    assert call("apoc.math.logit", 1.5) is None


def test_hashing_gaps():
    # FNV-1a known vectors
    assert call("apoc.hashing.fnv1a", "") == 0x811C9DC5
    assert call("apoc.hashing.fnv1a", "a") == 0xE40C292C
    assert call("apoc.hashing.fnv1a64", "a") == 0xAF63DC4C8601EC8C
    # murmur3 x86_32 known vectors (seed 0)
    assert call("apoc.hashing.murmur3", "") == 0
    assert call("apoc.hashing.murmur3", "hello") == 0x248BFA47
    # jump hash: stable, in-range, minimal reshuffling on growth
    b10 = [call("apoc.hashing.jumpHash", f"k{i}", 10) for i in range(50)]
    assert all(0 <= b < 10 for b in b10)
    b11 = [call("apoc.hashing.jumpHash", f"k{i}", 11) for i in range(50)]
    moved = sum(1 for x, y in zip(b10, b11) if x != y)
    assert moved <= 15  # ~1/11 expected to move, never a full reshuffle
    # consistent hash: fnv1a64 % buckets (reference API: bucket COUNT)
    pick = call("apoc.hashing.consistentHash", "user-42", 100)
    assert 0 <= pick < 100
    assert call("apoc.hashing.consistentHash", "user-42", 100) == pick
    assert pick == call("apoc.hashing.fnv1a64", "user-42") % 100
    assert call("apoc.hashing.consistentHash", "k", 0) is None
    # fingerprint: property-order independent, exclude list honored
    from nornicdb_tpu_torch.storage.types import Node
    a = Node(labels=["P"], properties={"x": 1, "y": 2})
    b = Node(labels=["P"], properties={"y": 2, "x": 1})
    assert call("apoc.hashing.fingerprint", a) == call("apoc.hashing.fingerprint", b)
    c = Node(labels=["P"], properties={"x": 1, "y": 2, "updated_at": 999})
    assert call("apoc.hashing.fingerprint", a, ["updated_at"]) == call(
        "apoc.hashing.fingerprint", c, ["updated_at"])
    assert call("apoc.hashing.fingerprint", a) != call("apoc.hashing.fingerprint", c)
    assert call("apoc.hashing.fnv1a", None) is None


def test_fingerprint_review_regressions():
    from nornicdb_tpu_torch.storage.types import Node
    # scalars hash their value, not an empty map
    assert call("apoc.hashing.fingerprint", "hello") != call(
        "apoc.hashing.fingerprint", "world")
    assert call("apoc.hashing.fingerprint", 42) != call(
        "apoc.hashing.fingerprint", [1, 2, 3])
    # label-list encoding is unambiguous
    a = Node(labels=["A|B"], properties={"x": 1})
    b = Node(labels=["A", "B"], properties={"x": 1})
    assert call("apoc.hashing.fingerprint", a) != call("apoc.hashing.fingerprint", b)


def test_entity_accessor_gaps():
    from nornicdb_tpu_torch.storage.types import Edge, Node
    n = Node(id="n1", labels=["A", "B"])
    e = Edge(id="e1", start_node="n1", end_node="n1", type="SELF")
    assert call("apoc.node.id", n) == "n1"
    assert call("apoc.node.labels", n) == ["A", "B"]
    assert call("apoc.node.hasLabel", n, "A") is True
    assert call("apoc.node.hasLabels", n, ["A", "B"]) is True
    assert call("apoc.node.hasLabels", n, ["A", "Z"]) is False
    assert call("apoc.rel.id", e) == "e1"
    assert call("apoc.rel.isType", e, "SELF") is True
    assert call("apoc.rel.isLoop", e) is True
    assert call("apoc.any.isNode", n) is True
    assert call("apoc.any.isNode", e) is False
    assert call("apoc.any.isRelationship", e) is True
    assert call("apoc.any.isPath", {"__path__": True, "nodes": [], "relationships": []}) is True
    assert call("apoc.util.isNode", n) is True  # reference spelling
    assert call("apoc.node.hasLabels", n, "A") is True  # bare string = 1 label
    assert call("apoc.node.id", None) is None


def test_rel_startnode_resolves_node(ex):
    ex.execute("CREATE (:SA {name: 'src'})-[:R4]->(:SB {name: 'dst'})")
    r = ex.execute(
        "MATCH ()-[r:R4]->() "
        "RETURN apoc.rel.startNode(r).name, apoc.rel.endNode(r).name, "
        "apoc.util.isNode(apoc.rel.startNode(r))")
    assert r.rows[0] == ["src", "dst", True]


def test_meta_schema_and_type_properties(ex):
    ex.execute(
        "CREATE (a:User {name: 'ann', age: 30})-[:FOLLOWS {since: 1}]->"
        "(:User {name: 'bob'}), (a)-[:WROTE]->(:Post {title: 't', views: 2.5})"
    )
    r = ex.execute("CALL apoc.meta.schema() YIELD value RETURN value")
    schema = r.rows[0][0]
    assert schema["User"]["count"] == 2
    assert schema["User"]["properties"]["name"]["type"] == "STRING"
    assert schema["User"]["properties"]["age"]["count"] == 1
    assert schema["User"]["relationships"]["FOLLOWS"]["count"] == 1
    assert schema["Post"]["properties"]["views"]["type"] == "FLOAT"

    r = ex.execute(
        "CALL apoc.meta.nodeTypeProperties() "
        "YIELD nodeLabels, propertyName, propertyTypes, mandatory "
        "RETURN nodeLabels, propertyName, propertyTypes, mandatory")
    by_key = {(tuple(x[0]), x[1]): (x[2], x[3]) for x in r.rows}
    assert by_key[(("User",), "name")] == (["STRING"], True)  # on both users
    assert by_key[(("User",), "age")][1] is False  # only one user has it

    r = ex.execute(
        "CALL apoc.meta.relTypeProperties() "
        "YIELD relType, propertyName, mandatory RETURN relType, propertyName, mandatory")
    assert [":`FOLLOWS`", "since", True] in r.rows

    r = ex.execute(
        "CALL apoc.meta.data() YIELD label, property, isRelationship "
        "RETURN count(*)")
    assert r.rows[0][0] >= 5
