"""The port's APOC library on the CPU: the cases of ``tests/test_apoc.py``
and ``tests/test_io_rerank.py::TestNewApoc`` run against the port,
unchanged but for their imports (the executor takes ``device="cpu"``);
then the registries of both packages held equal (every ``apoc.*``
function with its category, every ``apoc.*`` / ``gds.*`` procedure and
every ``kalman.*`` function), and the aggregate form
``apoc.algo.pageRank(collect(n))``, which the port answers.
"""


import pytest

from nornicdb_tpu_torch.apoc import all_functions, call, categories
from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.storage import MemoryEngine, Node


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


@pytest.fixture
def ex():
    return CypherExecutor(MemoryEngine())


class TestCollText:
    def test_coll_basics(self, ex):
        r = ex.execute(
            "RETURN apoc.coll.sum([1,2,3]) AS s, apoc.coll.sort([3,1,2]) AS so, "
            "apoc.coll.toSet([1,1,2]) AS st, apoc.coll.flatten([[1,2],[3]]) AS f, "
            "apoc.coll.intersection([1,2,3],[2,3,4]) AS i, "
            "apoc.coll.partition([1,2,3,4,5], 2) AS p"
        )
        assert r.rows == [[6, [1, 2, 3], [1, 2], [1, 2, 3], [2, 3], [[1, 2], [3, 4], [5]]]]

    def test_text_basics(self, ex):
        r = ex.execute(
            "RETURN apoc.text.join(['a','b'], '-') AS j, "
            "apoc.text.capitalize('hello') AS c, "
            "apoc.text.slug('Hello World!') AS s, "
            "apoc.text.levenshteinDistance('kitten','sitting') AS l, "
            "apoc.text.camelCase('foo_bar baz') AS cc"
        )
        assert r.rows == [["a-b", "Hello", "hello-world", 3, "fooBarBaz"]]

    def test_map_basics(self, ex):
        r = ex.execute(
            "RETURN apoc.map.merge({a:1},{b:2}) AS m, "
            "apoc.map.fromPairs([['x',1],['y',2]]) AS fp, "
            "apoc.map.removeKey({a:1,b:2},'a') AS rk, "
            "apoc.map.flatten({a:{b:1}}) AS fl"
        )
        assert r.rows == [[{"a": 1, "b": 2}, {"x": 1, "y": 2}, {"b": 2}, {"a.b": 1}]]

    def test_convert_json(self, ex):
        r = ex.execute(
            "RETURN apoc.convert.toJson({a:[1,2]}) AS j, "
            "apoc.convert.fromJsonMap('{\"k\":5}') AS m, "
            "apoc.json.path('{\"a\":{\"b\":[10,20]}}', '$.a.b[1]') AS p"
        )
        assert r.rows == [['{"a": [1, 2]}', {"k": 5}, 20]]

    def test_date(self, ex):
        r = ex.execute(
            "RETURN apoc.date.format(0, 's', 'yyyy-MM-dd') AS d, "
            "apoc.date.parse('1970-01-02 00:00:00', 's') AS p"
        )
        assert r.rows == [["1970-01-01", 86400]]

    def test_hashing_meta(self, ex):
        r = ex.execute(
            "RETURN apoc.hashing.md5('x') AS h, apoc.meta.type(1) AS t1, "
            "apoc.meta.type('s') AS t2, apoc.meta.type([1]) AS t3"
        )
        assert r.rows[0][1:] == ["INTEGER", "STRING", "LIST"]
        assert len(r.rows[0][0]) == 32

    def test_registry_surface(self):
        fns = all_functions()
        assert len(fns) > 100
        cats = categories()
        assert {"coll", "text", "map", "convert", "date"} <= set(cats)
        assert call("apoc.coll.sum", [1, 2]) == 3


class TestApocProcedures:
    def test_create_node_and_relationship(self, ex):
        r = ex.execute(
            "CALL apoc.create.node(['Person'], {name:'Ada'}) YIELD node RETURN node.name"
        )
        assert r.rows == [["Ada"]]
        r = ex.execute(
            "MATCH (a:Person) CALL apoc.create.node(['City'], {name:'Oslo'}) YIELD node "
            "CALL apoc.create.relationship(a, 'LIVES_IN', {since: 2020}, node) YIELD rel "
            "RETURN type(rel), rel.since"
        )
        assert r.rows == [["LIVES_IN", 2020]]

    def test_merge_node_idempotent(self, ex):
        ex.execute("CALL apoc.merge.node(['K'], {k:1}, {created:true}) YIELD node RETURN node")
        ex.execute("CALL apoc.merge.node(['K'], {k:1}, {created:true}) YIELD node RETURN node")
        r = ex.execute("MATCH (n:K) RETURN count(n)")
        assert r.rows == [[1]]

    def test_refactor_rename(self, ex):
        ex.execute("CREATE (:Old {x:1}), (:Old {x:2})")
        r = ex.execute("CALL apoc.refactor.rename.label('Old','New') YIELD total RETURN total")
        assert r.rows == [[2]]
        assert ex.execute("MATCH (n:New) RETURN count(n)").rows == [[2]]

    def test_node_degree(self, ex):
        ex.execute("CREATE (a:D {k:1})-[:R]->(:D), (a)-[:R]->(:D)")
        r = ex.execute(
            "MATCH (a:D {k:1}) CALL apoc.node.degree(a) YIELD value RETURN value"
        )
        assert r.rows == [[2]]

    def test_periodic_iterate(self, ex):
        ex.execute("UNWIND range(1, 10) AS i CREATE (:Item {v: i})")
        r = ex.execute(
            "CALL apoc.periodic.iterate("
            "'MATCH (n:Item) RETURN n', "
            "'SET n.doubled = n.v * 2', {batchSize: 3}) "
            "YIELD batches, total RETURN batches, total"
        )
        assert r.rows == [[4, 10]]
        r = ex.execute("MATCH (n:Item {v: 5}) RETURN n.doubled")
        assert r.rows == [[10]]

    def test_neighbors_tohop(self, ex):
        ex.execute("CREATE (:H {k:1})-[:R]->(:H {k:2})-[:R]->(:H {k:3})")
        r = ex.execute(
            "MATCH (a:H {k:1}) CALL apoc.neighbors.toHop(a, 'R', 2) YIELD node "
            "RETURN node.k ORDER BY node.k"
        )
        assert [row[0] for row in r.rows] == [2, 3]

    def test_apoc_help(self, ex):
        r = ex.execute("CALL apoc.help('coll.sum') YIELD name RETURN name")
        assert ["apoc.coll.sum"] in r.rows  # sumLongs also matches the prefix


class TestTriggers:
    """(ref: apoc/trigger category)"""

    def test_trigger_fires_on_create(self, ex):
        ex.execute(
            "CALL apoc.trigger.add('stamp', "
            "'UNWIND $createdNodes AS n MATCH (m) WHERE id(m) = id(n) "
            "SET m.stamped = true', {}) YIELD name RETURN name"
        )
        ex.execute("CREATE (:T {v: 1})")
        r = ex.execute("MATCH (t:T) RETURN t.stamped")
        assert r.rows == [[True]]
        r = ex.execute("CALL apoc.trigger.list() YIELD name, fired RETURN name, fired")
        assert r.rows[0][0] == "stamp" and r.rows[0][1] >= 1

    def test_no_recursive_cascade(self, ex):
        ex.execute(
            "CALL apoc.trigger.add('spawner', "
            "'CREATE (:Spawned)', {}) YIELD name RETURN name"
        )
        ex.execute("CREATE (:Origin)")
        # the trigger created ONE Spawned; its own create didn't re-fire
        r = ex.execute("MATCH (s:Spawned) RETURN count(s)")
        assert r.rows == [[1]]

    def test_pause_resume_remove(self, ex):
        ex.execute(
            "CALL apoc.trigger.add('p', 'CREATE (:Fired)', {}) YIELD name RETURN name"
        )
        ex.execute("CALL apoc.trigger.pause('p') YIELD name RETURN name")
        ex.execute("CREATE (:A1)")
        assert ex.execute("MATCH (f:Fired) RETURN count(f)").rows == [[0]]
        ex.execute("CALL apoc.trigger.resume('p') YIELD name RETURN name")
        ex.execute("CREATE (:A2)")
        assert ex.execute("MATCH (f:Fired) RETURN count(f)").rows == [[1]]
        ex.execute("CALL apoc.trigger.remove('p') YIELD name RETURN name")
        ex.execute("CREATE (:A3)")
        assert ex.execute("MATCH (f:Fired) RETURN count(f)").rows == [[1]]

    def test_broken_trigger_does_not_break_writes(self, ex):
        ex.execute(
            "CALL apoc.trigger.add('bad', 'THIS IS NOT CYPHER', {}) YIELD name RETURN name"
        )
        ex.execute("CREATE (:Works)")  # must not raise
        assert ex.execute("MATCH (w:Works) RETURN count(w)").rows == [[1]]
        r = ex.execute("CALL apoc.trigger.list() YIELD errors RETURN errors")
        assert r.rows[0][0] >= 1

    def test_selector_label_and_event(self, ex):
        ex.execute(
            "CALL apoc.trigger.add('scoped', 'CREATE (:Hit)', "
            "{label: 'Watched', event: 'create'}) YIELD name RETURN name"
        )
        ex.execute("CREATE (:Other)")  # wrong label: no fire
        assert ex.execute("MATCH (h:Hit) RETURN count(h)").rows == [[0]]
        ex.execute("CREATE (:Watched)")
        assert ex.execute("MATCH (h:Hit) RETURN count(h)").rows == [[1]]
        ex.execute("MATCH (w:Watched) SET w.x = 1")  # update, not create
        assert ex.execute("MATCH (h:Hit) RETURN count(h)").rows == [[1]]

    def test_registry_is_database_global(self, ex):
        CE = CypherExecutor

        ex.execute("CALL apoc.trigger.add('global', 'CREATE (:G)', {}) "
                   "YIELD name RETURN name")
        other = CE(ex.storage, schema=ex.schema)  # a second "session"
        r = other.execute("CALL apoc.trigger.list() YIELD name RETURN name")
        assert ["global"] in r.rows
        other.execute("CALL apoc.trigger.remove('global') YIELD name RETURN name")
        assert ex.execute("CALL apoc.trigger.list() YIELD name RETURN name").rows == []

    def test_missing_trigger_errors(self, ex):
        from nornicdb_tpu_torch.errors import CypherSyntaxError as E

        with pytest.raises(E):
            ex.execute("CALL apoc.trigger.remove('nope') YIELD name RETURN name")
        with pytest.raises(E):
            ex.execute("CALL apoc.trigger.pause('nope') YIELD name RETURN name")

    def test_assigned_properties_shape(self, ex):
        ex.execute(
            "CALL apoc.trigger.add('props', "
            "'UNWIND keys($assignedNodeProperties) AS k "
            "CREATE (:Seen {key: k})', {event: 'update'}) YIELD name RETURN name"
        )
        ex.execute("CREATE (:P2 {a: 1})")
        ex.execute("MATCH (p:P2) SET p.b = 2")
        keys = {r[0] for r in ex.execute("MATCH (s:Seen) RETURN s.key").rows}
        assert "b" in keys  # APOC-shaped {key: [...]} map


# -- the cases of tests/test_io_rerank.py::TestNewApoc -----------------------

class TestNewApoc:
    def test_agg(self):
        assert call("apoc.agg.median", [1, 2, 3, 4]) == 2.5
        assert call("apoc.agg.product", [2, 3, 4]) == 24
        stats = call("apoc.agg.statistics", [1.0, 2.0, 3.0])
        assert stats["mean"] == 2.0 and stats["count"] == 3

    def test_atomic(self):
        m = call("apoc.atomic.add", {"n": 1}, "n", 5)
        assert m["n"] == 6
        m = call("apoc.atomic.concat", {}, "s", "x")
        assert m["s"] == "x"

    def test_load_json(self, tmp_path, monkeypatch):
        p = tmp_path / "d.json"
        p.write_text('{"k": [1, 2]}')
        with pytest.raises(ValueError):  # gated off by default
            call("apoc.load.json", f"file://{p}")
        monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "true")
        assert call("apoc.load.json", f"file://{p}") == {"k": [1, 2]}
        with pytest.raises(ValueError):
            call("apoc.load.json", "http://example.com/x.json")

    def test_coll_extras(self):
        assert call("apoc.coll.duplicates", [1, 2, 2, 3, 3, 3]) == [2, 3]
        assert call("apoc.coll.dropDuplicateNeighbors", [1, 1, 2, 1]) == [1, 2, 1]
        assert call("apoc.coll.runningTotal", [1, 2, 3]) == [1, 3, 6]
        assert call("apoc.coll.containsAll", [1, 2, 3], [1, 3])

    def test_text_extras(self):
        assert call("apoc.text.fuzzyMatch", "hello", "helo") is True
        assert call("apoc.text.sorensenDiceSimilarity", "night", "nacht") > 0.2
        assert call("apoc.text.swapCase", "aB") == "Ab"
        assert call("apoc.text.repeat", "ab", 3) == "ababab"


# -- both packages: the registries -------------------------------------------

def _jax():
    import nornicdb_tpu.apoc as jax_apoc
    import nornicdb_tpu.cypher  # noqa: F401 — registers GDS, APOC procs
    from nornicdb_tpu.cypher import executor as jax_executor
    from nornicdb_tpu.cypher import functions as jax_functions

    return jax_apoc, jax_executor, jax_functions


class TestRegistries:
    def test_apoc_functions_equal(self):
        import nornicdb_tpu_torch.apoc as port_apoc

        jax_apoc, _, _ = _jax()
        assert port_apoc.all_functions() == jax_apoc.all_functions()
        assert len(port_apoc.all_functions()) > 900

    def test_apoc_categories_equal(self):
        import nornicdb_tpu_torch.apoc as port_apoc

        jax_apoc, _, _ = _jax()
        assert port_apoc.categories() == jax_apoc.categories()

    @pytest.mark.parametrize("prefix", ["apoc.", "gds."])
    def test_procedures_equal(self, prefix):
        import nornicdb_tpu_torch.cypher  # noqa: F401
        from nornicdb_tpu_torch.cypher.executor import PROCEDURES

        _, jax_executor, _ = _jax()
        port = sorted(p for p in PROCEDURES if p.startswith(prefix))
        want = sorted(p for p in jax_executor.PROCEDURES
                      if p.startswith(prefix))
        assert port == want and port

    def test_kalman_functions_equal(self):
        import nornicdb_tpu_torch.cypher  # noqa: F401
        from nornicdb_tpu_torch.cypher.functions import FUNCTIONS

        _, _, jax_functions = _jax()
        port = sorted(f for f in FUNCTIONS if f.startswith("kalman."))
        want = sorted(f for f in jax_functions.FUNCTIONS
                      if f.startswith("kalman."))
        assert port == want and port

    def test_procedure_listing_names_the_graph_procedures(self, ex):
        names = {r[0] for r in ex.execute(
            "CALL dbms.procedures() YIELD name RETURN name").rows}
        for want in ("gds.pagerank.stream", "gds.linkprediction.suggest",
                     "apoc.path.expand", "apoc.trigger.add"):
            assert want in names


class TestAggregateCall:
    """``apoc.algo.pageRank(collect(n))``: a function that takes the
    executor, called over an aggregate. The JAX executor's aggregate path
    calls it without the executor and raises TypeError (ROADMAP §C); the
    port passes it, so the answer equals JAX's ``WITH collect(n) AS ns``
    form of the same query."""

    GRAPH = ("CREATE (a:P {name:'a'})-[:K]->(b:P {name:'b'})-[:K]->"
             "(c:P {name:'c'}), (c)-[:K]->(a), (d:P {name:'d'})-[:K]->(a)")

    def test_port_answers_the_aggregate_form(self):
        import nornicdb_tpu
        import nornicdb_tpu_torch

        jdb = nornicdb_tpu.open_db("")
        pdb = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            for db in (jdb, pdb):
                db.cypher(self.GRAPH)
            with pytest.raises(TypeError):
                jdb.cypher("MATCH (n:P) RETURN apoc.algo.pageRank(collect(n))")
            want = jdb.cypher("MATCH (n:P) WITH collect(n) AS ns "
                              "RETURN apoc.algo.pageRank(ns)").rows[0][0]
            got = pdb.cypher(
                "MATCH (n:P) RETURN apoc.algo.pageRank(collect(n))").rows[0][0]
            name = {}
            for db, m in ((jdb, "j"), (pdb, "p")):
                for nid, nm in db.cypher(
                        "MATCH (n:P) RETURN n.id, n.name").rows:
                    name[(m, nid)] = nm
            w = {name[("j", k)]: v for k, v in want.items()}
            g = {name[("p", k)]: v for k, v in got.items()}
            assert g.keys() == w.keys()
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-7)
        finally:
            jdb.close()
            pdb.close()
