"""The port's Cypher engine: the cases of ``tests/test_cypher_breadth2.py``
run against the port on the CPU, unchanged but for their imports (the
executor takes ``device="cpu"``), those that call GDS, APOC and the Kalman
functions included.
"""

from __future__ import annotations

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.errors import CypherSyntaxError, CypherTypeError
from nornicdb_tpu_torch.storage import MemoryEngine, SchemaManager


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


@pytest.fixture
def ex():
    eng = MemoryEngine()
    schema = SchemaManager()
    schema.attach(eng)
    e = CypherExecutor(eng, schema)
    e.execute(
        "CREATE (a:Person:Employee {name:'Alice', age:30})"
        "-[:KNOWS]->(b:Person {name:'Bob', age:25}),"
        " (a)-[:WORKS_AT]->(:Company {name:'Acme'})"
    )
    return e


class TestLabelPredicates:
    def test_where_label(self, ex):
        rows = ex.execute("MATCH (p:Person) WHERE p:Employee RETURN p.name")
        assert rows.rows == [["Alice"]]

    def test_where_not_label(self, ex):
        rows = ex.execute(
            "MATCH (p:Person) WHERE NOT p:Employee RETURN p.name"
        )
        assert rows.rows == [["Bob"]]

    def test_label_and_property(self, ex):
        rows = ex.execute(
            "MATCH (p:Person) WHERE p:Employee AND p.age > 28 RETURN p.name"
        )
        assert rows.rows == [["Alice"]]

    def test_multi_label_requires_all(self, ex):
        rows = ex.execute("MATCH (n) WHERE n:Person:Employee RETURN n.name")
        assert rows.rows == [["Alice"]]

    def test_set_label_then_predicate(self, ex):
        ex.execute("MATCH (c:Company) WHERE NOT c:Node SET c:Node")
        rows = ex.execute("MATCH (c:Company) WHERE c:Node RETURN c.name")
        assert rows.rows == [["Acme"]]


class TestDdlForms:
    def test_fulltext_on_each_brackets(self, ex):
        ex.execute(
            "CREATE FULLTEXT INDEX node_search IF NOT EXISTS "
            "FOR (n:Doc) ON EACH [n.text, n.title]"
        )
        idx = [i for i in ex.schema.list_indexes() if i.name == "node_search"]
        assert idx and idx[0].properties == ["text", "title"]

    def test_vector_options_dotted_keys(self, ex):
        ex.execute(
            "CREATE VECTOR INDEX vi IF NOT EXISTS FOR (n:Doc) ON (n.emb) "
            "OPTIONS {indexConfig: {vector.dimensions: 768, "
            "vector.similarity_function: 'cosine'}}"
        )
        idx = [i for i in ex.schema.list_indexes() if i.name == "vi"]
        assert idx

    def test_alter_composite_add_drop_alias(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            db.cypher("CREATE DATABASE db3")
            db.cypher("CREATE COMPOSITE DATABASE composite1")
            db.cypher(
                "ALTER COMPOSITE DATABASE composite1 "
                "ADD ALIAS db3 FOR DATABASE db3"
            )
            mgr = db.database_manager
            assert "db3" in mgr._composites["composite1"]
            db.cypher("ALTER COMPOSITE DATABASE composite1 DROP ALIAS db3")
            assert "db3" not in mgr._composites["composite1"]
        finally:
            db.close()


class TestDialectExtensions:
    def test_unwind_where(self, ex):
        rows = ex.execute("UNWIND [1,2,3,4] AS x WHERE x > 2 RETURN x")
        assert rows.rows == [[3], [4]]

    def test_unwind_where_label_filter(self, ex):
        rows = ex.execute(
            "MATCH (f:Person) UNWIND labels(f) AS label "
            "WHERE label <> 'Person' RETURN label, count(*) AS c"
        )
        assert rows.rows == [["Employee", 1]]

    def test_not_equals_alias(self, ex):
        rows = ex.execute(
            "MATCH (p:Person) WHERE p.name != 'Bob' RETURN p.name"
        )
        assert rows.rows == [["Alice"]]

    def test_use_prefix(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            db.cypher("CREATE DATABASE test_db")
            db.cypher(':use test_db CREATE (n:Test {name: "test"})')
            rows = db.cypher("USE test_db MATCH (n:Test) RETURN n.name")
            assert rows.rows == [["test"]]
        finally:
            db.close()

    def test_call_yield_limit_tail(self, ex):
        res = ex.execute("CALL db.labels() YIELD label LIMIT 2")
        assert len(res.rows) == 2

    def test_call_yield_order_by_tail(self, ex):
        res = ex.execute(
            "CALL db.labels() YIELD label ORDER BY label DESC LIMIT 1 "
            "RETURN label"
        )
        assert res.rows == [["Person"]]

    def test_call_subquery_order_tail(self, ex):
        res = ex.execute(
            "CALL { MATCH (p:Person) RETURN p.name AS name, p.age AS age } "
            "ORDER BY age ASC RETURN name"
        )
        assert res.rows == [["Bob"], ["Alice"]]

    def test_collect_subquery(self, ex):
        rows = ex.execute(
            "MATCH (p:Person) RETURN p.name, "
            "COLLECT { MATCH (p)-[:KNOWS]->(f) RETURN f.name } AS friends "
            "ORDER BY p.name"
        )
        assert rows.rows == [["Alice", ["Bob"]], ["Bob", []]]

    def test_named_argument_call(self, ex):
        res = ex.execute(
            "CALL gds.linkPrediction.adamicAdar.stream"
            "(sourceNode: 'missing', topK: 5) YIELD node1 RETURN node1"
        )
        assert res.rows == []


class TestStreamProcedures:
    @pytest.fixture
    def graph(self, ex):
        # triangle + pendant so link prediction has candidates
        ex.execute(
            "CREATE (x:N {name:'x'}), (y:N {name:'y'}), (z:N {name:'z'}),"
            " (w:N {name:'w'}), (x)-[:R]->(y), (y)-[:R]->(z), (y)-[:R]->(w)"
        )
        xid = ex.execute("MATCH (n:N {name:'x'}) RETURN n").rows[0][0].id
        return ex, xid

    def test_adamic_adar_stream(self, graph):
        ex, xid = graph
        res = ex.execute(
            "CALL gds.linkPrediction.adamicAdar.stream"
            "({sourceNode: $src, topK: 5}) "
            "YIELD node1, node2, score RETURN node2.name, score",
            {"src": xid},
        )
        names = {r[0] for r in res.rows}
        assert names == {"z", "w"}  # share neighbor y; not adjacent to x
        assert all(r[1] > 0 for r in res.rows)

    def test_predict_stream_hybrid(self, graph):
        ex, xid = graph
        res = ex.execute(
            "CALL gds.linkPrediction.predict.stream({sourceNode: $src, "
            "topK: 3, algorithm: 'adamic_adar', topologyWeight: 0.6, "
            "semanticWeight: 0.4}) YIELD node2, score RETURN node2.name",
            {"src": xid},
        )
        assert res.rows  # candidates streamed

    def test_fastrp_stats(self, graph):
        ex, _ = graph
        res = ex.execute(
            "CALL gds.fastRP.stats('s', {embeddingDimension: 32}) "
            "YIELD nodeCount RETURN nodeCount"
        )
        assert res.rows[0][0] >= 4


class TestAdminProcedures:
    def test_db_info_and_ping(self, ex):
        res = ex.execute("CALL db.info() YIELD name, nodeCount "
                         "RETURN name, nodeCount")
        assert res.rows[0][1] == 3
        assert ex.execute("CALL db.ping()").rows == [[True]]

    def test_await_and_resample(self, ex):
        ex.execute("CREATE INDEX my_index IF NOT EXISTS "
                    "FOR (n:Person) ON (n.name)")
        # the reference tolerates unknown names and yields status
        # (db_procedures_test.go:126 awaits 'my_index' on an EMPTY store)
        r = ex.execute("CALL db.awaitIndex('my_index')")
        assert r.columns == ["status"] and r.rows == [["online"]]
        ex.execute("CALL db.awaitIndex('my_index', 60)")
        ex.execute("CALL db.awaitIndex('never_created')")
        ex.execute("CALL db.resampleIndex('my_index')")

    def test_stats_lifecycle(self, ex):
        ex.execute("CALL db.stats.collect('QUERIES')")
        st = ex.execute("CALL db.stats.status()")
        assert st.rows[0][1] == "collecting"
        data = ex.execute("CALL db.stats.retrieve('QUERIES')")
        assert data.rows[0][1]["queryCount"] > 0
        ex.execute("CALL db.stats.stop()")
        assert ex.execute("CALL db.stats.status()").rows[0][1] == "idle"

    def test_dbms_procs(self, ex):
        procs = ex.execute(
            "CALL dbms.procedures() YIELD name RETURN name"
        )
        names = {r[0] for r in procs.rows}
        assert "db.labels" in names and "dbms.procedures" in names
        ex.execute("CALL dbms.info()")
        ex.execute("CALL dbms.listConfig()")
        ex.execute("CALL dbms.listConnections()")
        ex.execute("CALL dbms.clientConfig()")

    def test_tx_set_metadata(self, ex):
        ex.execute("CALL tx.setMetaData({app: 'myapp', userId: 123})")
        assert ex._tx_metadata == {"app": "myapp", "userId": 123}

    def test_fulltext_admin(self, ex):
        ex.execute("CALL db.index.fulltext.createNodeIndex"
                    "('ft_idx3', 'Memory', 'text')")
        assert any(i.name == "ft_idx3" for i in ex.schema.list_indexes())
        ex.execute("CALL db.index.fulltext.drop('ft_idx3')")
        assert not any(i.name == "ft_idx3" for i in ex.schema.list_indexes())
        res = ex.execute("CALL db.index.fulltext.listAvailableAnalyzers()")
        assert res.rows and res.rows[0][0] == "standard"

    def test_clear_query_caches(self, ex):
        ex.execute("CALL db.clearQueryCaches()")


class TestReviewFixes:
    def test_lpad_rpad_null_pad_is_null(self, ex):
        assert ex.execute("RETURN lpad('5', 3, null) AS r").rows == [[None]]
        assert ex.execute("RETURN rpad('5', 3, null) AS r").rows == [[None]]

    def test_rel_type_predicate(self, ex):
        rows = ex.execute(
            "MATCH (a)-[r]->(b) WHERE r:KNOWS RETURN type(r)"
        )
        assert rows.rows == [["KNOWS"]]

    def test_stream_accepts_node_object(self, ex):
        ex.execute(
            "CREATE (x:M {name:'x'})-[:R]->(y:M {name:'y'})"
            "-[:R]->(z:M {name:'z'})"
        )
        res = ex.execute(
            "MATCH (n:M {name:'x'}) "
            "CALL gds.linkPrediction.adamicAdar.stream"
            "({sourceNode: n, topK: 5}) "
            "YIELD node2 RETURN node2.name"
        )
        assert [r[0] for r in res.rows] == ["z"]

    def test_composite_alias_collision_surfaces(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            db.cypher("CREATE DATABASE t1")
            db.cypher("CREATE DATABASE t2")
            db.cypher("CREATE COMPOSITE DATABASE comp")
            # alias name collides with existing database t2 -> must error,
            # not half-apply
            with pytest.raises(Exception):
                db.cypher(
                    "ALTER COMPOSITE DATABASE comp "
                    "ADD ALIAS t2 FOR DATABASE t1"
                )
            assert "t1" not in db.database_manager._composites["comp"]
            # dropping a nonexistent alias errors
            with pytest.raises(Exception):
                db.cypher("ALTER COMPOSITE DATABASE comp DROP ALIAS ghost")
        finally:
            db.close()


class TestNewFunctions:
    def test_format(self, ex):
        assert ex.execute(
            "RETURN format('%s is %d years old', 'Alice', 30) AS r"
        ).rows == [["Alice is 30 years old"]]
        assert ex.execute("RETURN format('Hello %s', 'World') AS r"
                          ).rows == [["Hello World"]]
        assert ex.execute("RETURN format('100%%') AS r").rows == [["100%"]]

    def test_lpad_rpad(self, ex):
        assert ex.execute("RETURN lpad('5', 3, '0') AS r").rows == [["005"]]
        assert ex.execute("RETURN rpad('5', 3, '0') AS r").rows == [["500"]]
        assert ex.execute("RETURN lpad('abcd', 3, '0') AS r").rows == [["abcd"]]

    def test_kalman_init_process_state(self, ex):
        res = ex.execute(
            "RETURN kalman.init({measurementNoise: 5.0}) AS s"
        )
        state = res.rows[0][0]
        assert isinstance(state, str)
        out = ex.execute(
            "RETURN kalman.process(10.0, $s) AS r", {"s": state}
        ).rows[0][0]
        assert out["value"] == 10.0  # first measurement initializes
        out2 = ex.execute(
            "RETURN kalman.process(20.0, $s) AS r", {"s": out["state"]}
        ).rows[0][0]
        assert 10.0 < out2["value"] < 20.0  # smoothed toward measurement
        parsed = ex.execute(
            "RETURN kalman.state($s) AS r", {"s": out["state"]}
        ).rows[0][0]
        assert parsed["r"] == 5.0


class TestApocPathStartForms:
    def test_spanning_tree_map_start(self, ex):
        node_id = ex.execute(
            "MATCH (a:Person {name:'Alice'}) RETURN a"
        ).rows[0][0].id
        res = ex.execute(
            "CALL apoc.path.spanningTree({id: $id}, {bfs: false}) "
            "YIELD path RETURN path",
            {"id": node_id},
        )
        assert res.rows

    def test_expand_id_string_start(self, ex):
        node_id = ex.execute(
            "MATCH (a:Person {name:'Alice'}) RETURN a"
        ).rows[0][0].id
        res = ex.execute(
            "CALL apoc.path.expand($id, null, null, 0, 2) "
            "YIELD path RETURN path",
            {"id": node_id},
        )
        assert res.rows

    def test_unknown_start_errors(self, ex):
        with pytest.raises(CypherTypeError):
            ex.execute(
                "CALL apoc.path.expand({id: 'ghost'}, null, null, 0, 2)"
            )

