"""The port's Cypher engine (``nornicdb_tpu_torch.cypher``): the cases of
``tests/test_cypher.py`` run against the port on the CPU, unchanged but for
their imports (the executor takes ``device="cpu"``; ``None`` means CUDA).
"""

import pytest

from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.errors import (
    ConstraintViolationError,
    CypherSyntaxError,
    CypherTypeError,
    TransactionError,
)
from nornicdb_tpu_torch.storage import MemoryEngine, Node, SchemaManager


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


@pytest.fixture
def ex():
    eng = MemoryEngine()
    schema = SchemaManager()
    schema.attach(eng)
    return CypherExecutor(eng, schema)


@pytest.fixture
def movies(ex):
    """Tiny movie graph like the Neo4j docs examples."""
    ex.execute(
        """
        CREATE (keanu:Person {name: 'Keanu Reeves', born: 1964}),
               (carrie:Person {name: 'Carrie-Anne Moss', born: 1967}),
               (laurence:Person {name: 'Laurence Fishburne', born: 1961}),
               (matrix:Movie {title: 'The Matrix', released: 1999}),
               (speed:Movie {title: 'Speed', released: 1994}),
               (keanu)-[:ACTED_IN {roles: ['Neo']}]->(matrix),
               (keanu)-[:ACTED_IN {roles: ['Jack']}]->(speed),
               (carrie)-[:ACTED_IN {roles: ['Trinity']}]->(matrix),
               (laurence)-[:ACTED_IN {roles: ['Morpheus']}]->(matrix)
        """
    )
    return ex


class TestCreateMatch:
    def test_create_return(self, ex):
        r = ex.execute("CREATE (n:Person {name: 'Ada'}) RETURN n.name")
        assert r.columns == ["n.name"]
        assert r.rows == [["Ada"]]
        assert r.stats.nodes_created == 1

    def test_match_by_label_and_property(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) RETURN p.born"
        )
        assert r.rows == [[1964]]

    def test_match_where(self, movies):
        r = movies.execute(
            "MATCH (p:Person) WHERE p.born > 1962 RETURN p.name ORDER BY p.name"
        )
        assert r.rows == [["Carrie-Anne Moss"], ["Keanu Reeves"]]

    def test_match_relationship(self, movies):
        r = movies.execute(
            "MATCH (p:Person)-[:ACTED_IN]->(m:Movie {title: 'The Matrix'}) "
            "RETURN p.name ORDER BY p.name"
        )
        assert [row[0] for row in r.rows] == [
            "Carrie-Anne Moss", "Keanu Reeves", "Laurence Fishburne",
        ]

    def test_match_incoming_direction(self, movies):
        r = movies.execute(
            "MATCH (m:Movie)<-[:ACTED_IN]-(p:Person {name: 'Keanu Reeves'}) "
            "RETURN m.title ORDER BY m.title"
        )
        assert r.rows == [["Speed"], ["The Matrix"]]

    def test_undirected(self, movies):
        r = movies.execute(
            "MATCH (a {name: 'Keanu Reeves'})-[:ACTED_IN]-(m) RETURN count(m)"
        )
        assert r.rows == [[2]]

    def test_rel_variable_and_props(self, movies):
        r = movies.execute(
            "MATCH (p)-[r:ACTED_IN]->(m {title: 'The Matrix'}) "
            "WHERE p.name = 'Keanu Reeves' RETURN r.roles"
        )
        assert r.rows == [[["Neo"]]]

    def test_multiple_patterns_join(self, movies):
        r = movies.execute(
            "MATCH (a:Person)-[:ACTED_IN]->(m), (b:Person)-[:ACTED_IN]->(m) "
            "WHERE a.name < b.name RETURN a.name, b.name, m.title ORDER BY a.name, b.name"
        )
        assert ["Carrie-Anne Moss", "Keanu Reeves", "The Matrix"] in r.rows

    def test_match_missing_label_empty(self, ex):
        r = ex.execute("MATCH (x:Nothing) RETURN x")
        assert r.rows == []

    def test_parameters(self, ex):
        ex.execute("CREATE (:P {name: $name, age: $age})", {"name": "Bob", "age": 3})
        r = ex.execute("MATCH (p:P {name: $name}) RETURN p.age", {"name": "Bob"})
        assert r.rows == [[3]]

    def test_create_from_param_map(self, ex):
        ex.execute("CREATE (n:X $props)", {"props": {"a": 1, "b": "two"}})
        r = ex.execute("MATCH (n:X) RETURN n.a, n.b")
        assert r.rows == [[1, "two"]]


class TestProjection:
    def test_alias(self, movies):
        r = movies.execute("MATCH (m:Movie) RETURN m.title AS title ORDER BY title")
        assert r.columns == ["title"]

    def test_distinct(self, movies):
        r = movies.execute(
            "MATCH (p:Person)-[:ACTED_IN]->(m) RETURN DISTINCT p.name ORDER BY p.name"
        )
        assert len(r.rows) == 3

    def test_order_desc_skip_limit(self, movies):
        r = movies.execute(
            "MATCH (p:Person) RETURN p.name ORDER BY p.born DESC SKIP 1 LIMIT 1"
        )
        assert r.rows == [["Keanu Reeves"]]

    def test_return_star(self, ex):
        ex.execute("CREATE (:A {x: 1})")
        r = ex.execute("MATCH (n:A) RETURN *")
        assert r.columns == ["n"]

    def test_return_node_object(self, ex):
        ex.execute("CREATE (:A {x: 1})")
        r = ex.execute("MATCH (n:A) RETURN n")
        node = r.rows[0][0]
        assert isinstance(node, Node) and node.properties["x"] == 1

    def test_arithmetic_and_functions(self, ex):
        r = ex.execute(
            "RETURN 1 + 2 * 3 AS a, 7 / 2 AS b, 7.0 / 2 AS c, 7 % 3 AS d, "
            "2 ^ 3 AS e, toUpper('abc') AS f, size([1,2,3]) AS g"
        )
        assert r.rows == [[7, 3, 3.5, 1, 8.0, "ABC", 3]]

    def test_string_predicates(self, movies):
        r = movies.execute(
            "MATCH (p:Person) WHERE p.name STARTS WITH 'K' RETURN p.name"
        )
        assert r.rows == [["Keanu Reeves"]]
        r = movies.execute(
            "MATCH (p:Person) WHERE p.name CONTAINS 'Fish' RETURN count(*)"
        )
        assert r.rows == [[1]]
        r = movies.execute(
            "MATCH (p:Person) WHERE p.name =~ '.*Moss' RETURN count(*)"
        )
        assert r.rows == [[1]]

    def test_case_expression(self, movies):
        r = movies.execute(
            "MATCH (p:Person) RETURN p.name, "
            "CASE WHEN p.born < 1964 THEN 'old' ELSE 'young' END AS age "
            "ORDER BY p.name"
        )
        assert r.rows[1] == ["Keanu Reeves", "young"]

    def test_list_ops(self, ex):
        r = ex.execute(
            "RETURN [1,2,3][0] AS a, [1,2,3][-1] AS b, [1,2,3,4][1..3] AS c, "
            "[x IN range(1,5) WHERE x % 2 = 0 | x * 10] AS d, "
            "reduce(acc = 0, x IN [1,2,3] | acc + x) AS e"
        )
        assert r.rows == [[1, 3, [2, 3], [20, 40], 6]]

    def test_null_semantics(self, ex):
        r = ex.execute(
            "RETURN null = null AS a, null <> 1 AS b, NOT null AS c, "
            "null + 1 AS d, coalesce(null, 'x') AS e, null IS NULL AS f"
        )
        assert r.rows == [[None, None, None, None, "x", True]]

    def test_in_operator(self, ex):
        r = ex.execute("RETURN 2 IN [1,2,3] AS a, 5 IN [1,2] AS b, null IN [1] AS c")
        assert r.rows == [[True, False, None]]

    def test_map_literal_and_access(self, ex):
        r = ex.execute("RETURN {a: 1, b: {c: 'x'}}.b.c AS v")
        assert r.rows == [["x"]]


class TestAggregation:
    def test_count_star_and_column(self, movies):
        r = movies.execute("MATCH (p:Person) RETURN count(*)")
        assert r.rows == [[3]]
        r = movies.execute("MATCH (n) RETURN count(n)")
        assert r.rows == [[5]]

    def test_group_by(self, movies):
        r = movies.execute(
            "MATCH (p:Person)-[:ACTED_IN]->(m:Movie) "
            "RETURN m.title AS t, count(p) AS c ORDER BY c DESC"
        )
        assert r.rows == [["The Matrix", 3], ["Speed", 1]]

    def test_collect_sum_avg_min_max(self, movies):
        r = movies.execute(
            "MATCH (p:Person) RETURN sum(p.born) AS s, avg(p.born) AS a, "
            "min(p.born) AS mn, max(p.born) AS mx"
        )
        assert r.rows == [[5892, 1964.0, 1961, 1967]]
        r = movies.execute(
            "MATCH (p:Person) RETURN collect(p.name) AS names"
        )
        assert sorted(r.rows[0][0]) == [
            "Carrie-Anne Moss", "Keanu Reeves", "Laurence Fishburne",
        ]

    def test_count_distinct(self, movies):
        r = movies.execute(
            "MATCH (p:Person)-[:ACTED_IN]->(m) RETURN count(DISTINCT p) AS c"
        )
        assert r.rows == [[3]]

    def test_aggregate_on_empty_is_zero_row(self, ex):
        r = ex.execute("MATCH (x:None) RETURN count(x)")
        assert r.rows == [[0]]

    def test_agg_expression(self, movies):
        r = movies.execute("MATCH (p:Person) RETURN count(*) + 1 AS c")
        assert r.rows == [[4]]


class TestWithUnwind:
    def test_with_filtering(self, movies):
        r = movies.execute(
            "MATCH (p:Person)-[:ACTED_IN]->(m) WITH m, count(p) AS cast "
            "WHERE cast > 2 RETURN m.title"
        )
        assert r.rows == [["The Matrix"]]

    def test_with_order_limit(self, movies):
        r = movies.execute(
            "MATCH (p:Person) WITH p ORDER BY p.born LIMIT 1 RETURN p.name"
        )
        assert r.rows == [["Laurence Fishburne"]]

    def test_unwind(self, ex):
        r = ex.execute("UNWIND [1,2,3] AS x RETURN x * 2 AS y")
        assert r.rows == [[2], [4], [6]]

    def test_unwind_create(self, ex):
        ex.execute("UNWIND range(1, 3) AS i CREATE (:Num {v: i})")
        r = ex.execute("MATCH (n:Num) RETURN count(n)")
        assert r.rows == [[3]]

    def test_with_star(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) WITH * RETURN p.name"
        )
        assert r.rows == [["Keanu Reeves"]]


class TestMutations:
    def test_set_property(self, ex):
        ex.execute("CREATE (:P {name: 'x'})")
        r = ex.execute("MATCH (p:P) SET p.age = 30 RETURN p.age")
        assert r.rows == [[30]]
        assert r.stats.properties_set == 1

    def test_set_map_replace_and_merge(self, ex):
        ex.execute("CREATE (:P {a: 1, b: 2})")
        ex.execute("MATCH (p:P) SET p += {b: 20, c: 3}")
        r = ex.execute("MATCH (p:P) RETURN p.a, p.b, p.c")
        assert r.rows == [[1, 20, 3]]
        ex.execute("MATCH (p:P) SET p = {z: 9}")
        r = ex.execute("MATCH (p:P) RETURN p.a, p.z")
        assert r.rows == [[None, 9]]

    def test_set_label(self, ex):
        ex.execute("CREATE (:A)")
        ex.execute("MATCH (n:A) SET n:B:C")
        r = ex.execute("MATCH (n:B) RETURN labels(n)")
        assert sorted(r.rows[0][0]) == ["A", "B", "C"]

    def test_remove(self, ex):
        ex.execute("CREATE (:A:B {x: 1, y: 2})")
        ex.execute("MATCH (n:A) REMOVE n.x, n:B")
        r = ex.execute("MATCH (n:A) RETURN n.x, n.y, labels(n)")
        assert r.rows == [[None, 2, ["A"]]]

    def test_delete_requires_detach(self, ex):
        ex.execute("CREATE (:A)-[:R]->(:B)")
        with pytest.raises(CypherTypeError):
            ex.execute("MATCH (a:A) DELETE a")
        ex.execute("MATCH (a:A) DETACH DELETE a")
        r = ex.execute("MATCH (n) RETURN count(n)")
        assert r.rows == [[1]]

    def test_delete_relationship(self, ex):
        ex.execute("CREATE (:A)-[:R]->(:B)")
        r = ex.execute("MATCH ()-[r:R]->() DELETE r")
        assert r.stats.relationships_deleted == 1

    def test_merge_creates_then_matches(self, ex):
        r1 = ex.execute("MERGE (p:P {name: 'solo'}) RETURN p")
        assert r1.stats.nodes_created == 1
        r2 = ex.execute("MERGE (p:P {name: 'solo'}) RETURN p")
        assert r2.stats.nodes_created == 0
        r = ex.execute("MATCH (p:P) RETURN count(p)")
        assert r.rows == [[1]]

    def test_merge_on_create_on_match(self, ex):
        ex.execute(
            "MERGE (p:P {name: 'x'}) ON CREATE SET p.created = true "
            "ON MATCH SET p.matched = true"
        )
        r = ex.execute("MATCH (p:P) RETURN p.created, p.matched")
        assert r.rows == [[True, None]]
        ex.execute(
            "MERGE (p:P {name: 'x'}) ON CREATE SET p.created2 = true "
            "ON MATCH SET p.matched = true"
        )
        r = ex.execute("MATCH (p:P) RETURN p.created2, p.matched")
        assert r.rows == [[None, True]]

    def test_merge_relationship(self, ex):
        ex.execute("CREATE (:A {k: 1}), (:B {k: 2})")
        ex.execute("MATCH (a:A), (b:B) MERGE (a)-[:LINK]->(b)")
        ex.execute("MATCH (a:A), (b:B) MERGE (a)-[:LINK]->(b)")
        r = ex.execute("MATCH ()-[r:LINK]->() RETURN count(r)")
        assert r.rows == [[1]]

    def test_foreach(self, ex):
        ex.execute("FOREACH (i IN range(1,3) | CREATE (:F {v: i}))")
        r = ex.execute("MATCH (f:F) RETURN count(f)")
        assert r.rows == [[3]]


class TestPaths:
    def test_var_length(self, ex):
        ex.execute(
            "CREATE (a:N {v: 1})-[:R]->(b:N {v: 2})-[:R]->(c:N {v: 3})-[:R]->(d:N {v: 4})"
        )
        r = ex.execute(
            "MATCH (a:N {v: 1})-[:R*1..2]->(x) RETURN x.v ORDER BY x.v"
        )
        assert r.rows == [[2], [3]]
        r = ex.execute("MATCH (a:N {v: 1})-[:R*]->(x) RETURN count(x)")
        assert r.rows == [[3]]
        r = ex.execute("MATCH (a:N {v: 1})-[:R*3]->(x) RETURN x.v")
        assert r.rows == [[4]]

    def test_var_length_rel_list(self, ex):
        ex.execute("CREATE (:N {v:1})-[:R {w: 1}]->(:N {v:2})-[:R {w: 2}]->(:N {v:3})")
        r = ex.execute(
            "MATCH (:N {v:1})-[rs:R*2]->(:N {v:3}) RETURN size(rs), rs[0].w"
        )
        assert r.rows == [[2, 1]]

    def test_named_path(self, ex):
        ex.execute("CREATE (:A {n:'a'})-[:R]->(:B {n:'b'})")
        r = ex.execute("MATCH p = (:A)-[:R]->(:B) RETURN length(p), size(nodes(p))")
        assert r.rows == [[1, 2]]

    def test_shortest_path(self, ex):
        ex.execute(
            "CREATE (a:S {v:1})-[:R]->(b:S {v:2})-[:R]->(c:S {v:3}), (a)-[:R]->(c)"
        )
        r = ex.execute(
            "MATCH p = shortestPath((a:S {v:1})-[:R*]->(c:S {v:3})) RETURN length(p)"
        )
        assert r.rows == [[1]]


class TestOptionalMatch:
    def test_optional_null(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) "
            "OPTIONAL MATCH (p)-[:DIRECTED]->(m) RETURN p.name, m"
        )
        assert r.rows == [["Keanu Reeves", None]]

    def test_optional_found(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) "
            "OPTIONAL MATCH (p)-[:ACTED_IN]->(m) RETURN count(m)"
        )
        assert r.rows == [[2]]


class TestSubqueriesUnion:
    def test_exists_subquery(self, movies):
        r = movies.execute(
            "MATCH (p:Person) WHERE EXISTS { (p)-[:ACTED_IN]->(:Movie {title: 'Speed'}) } "
            "RETURN p.name"
        )
        assert r.rows == [["Keanu Reeves"]]

    def test_count_subquery(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) "
            "RETURN COUNT { (p)-[:ACTED_IN]->() } AS c"
        )
        assert r.rows == [[2]]

    def test_pattern_predicate(self, movies):
        r = movies.execute(
            "MATCH (p:Person) WHERE (p)-[:ACTED_IN]->(:Movie {title: 'Speed'}) "
            "RETURN p.name"
        )
        assert r.rows == [["Keanu Reeves"]]

    def test_not_pattern(self, movies):
        r = movies.execute(
            "MATCH (p:Person) WHERE NOT (p)-[:ACTED_IN]->(:Movie {title: 'Speed'}) "
            "RETURN count(p)"
        )
        assert r.rows == [[2]]

    def test_union(self, movies):
        r = movies.execute(
            "MATCH (m:Movie) RETURN m.title AS name "
            "UNION MATCH (p:Person) RETURN p.name AS name"
        )
        assert len(r.rows) == 5

    def test_union_all_keeps_dupes(self, ex):
        r = ex.execute("RETURN 1 AS x UNION ALL RETURN 1 AS x")
        assert r.rows == [[1], [1]]
        r = ex.execute("RETURN 1 AS x UNION RETURN 1 AS x")
        assert r.rows == [[1]]

    def test_call_subquery(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) "
            "CALL { MATCH (m:Movie) RETURN max(m.released) AS latest } "
            "RETURN p.name, latest"
        )
        assert r.rows == [["Keanu Reeves", 1999]]


class TestEntityFunctions:
    def test_id_labels_type_properties(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'})-[r:ACTED_IN]->(m {title: 'Speed'}) "
            "RETURN labels(p), type(r), properties(m), keys(m)"
        )
        row = r.rows[0]
        assert row[0] == ["Person"]
        assert row[1] == "ACTED_IN"
        assert row[2] == {"title": "Speed", "released": 1994}
        assert row[3] == ["released", "title"]

    def test_start_end_node(self, ex):
        ex.execute("CREATE (:A {n: 'a'})-[:R]->(:B {n: 'b'})")
        r = ex.execute(
            "MATCH ()-[r:R]->() RETURN startNode(r).n, endNode(r).n"
        )
        assert r.rows == [["a", "b"]]


class TestProcedures:
    def test_db_labels(self, movies):
        r = movies.execute("CALL db.labels()")
        assert [x[0] for x in r.rows] == ["Movie", "Person"]

    def test_rel_types_yield(self, movies):
        r = movies.execute(
            "CALL db.relationshipTypes() YIELD relationshipType AS t RETURN t"
        )
        assert r.rows == [["ACTED_IN"]]

    def test_show_procedures(self, ex):
        r = ex.execute("SHOW PROCEDURES")
        assert ["db.labels"] in r.rows


class TestDDL:
    def test_create_show_drop_index(self, ex):
        ex.execute("CREATE INDEX person_name FOR (n:Person) ON (n.name)")
        r = ex.execute("SHOW INDEXES")
        assert any(row[0] == "person_name" for row in r.rows)
        ex.execute("DROP INDEX person_name")
        r = ex.execute("SHOW INDEXES")
        assert r.rows == []

    def test_vector_index_with_options(self, ex):
        ex.execute(
            "CREATE VECTOR INDEX emb IF NOT EXISTS FOR (n:Memory) ON (n.embedding) "
            "OPTIONS {indexConfig: {`vector.dimensions`: 1024, "
            "`vector.similarity_function`: 'cosine'}}"
        )
        r = ex.execute("SHOW INDEXES")
        assert any(row[1] == "vector" for row in r.rows)

    def test_unique_constraint_enforced(self, ex):
        ex.execute(
            "CREATE CONSTRAINT uq FOR (n:User) REQUIRE n.email IS UNIQUE"
        )
        ex.execute("CREATE (:User {email: 'a@b.c'})")
        with pytest.raises(ConstraintViolationError):
            ex.execute("CREATE (:User {email: 'a@b.c'})")

    def test_index_backed_lookup(self, ex):
        ex.execute("CREATE INDEX idx FOR (n:K) ON (n.v)")
        for i in range(20):
            ex.execute("CREATE (:K {v: $i})", {"i": i})
        r = ex.execute("MATCH (n:K {v: 7}) RETURN count(n)")
        assert r.rows == [[1]]


class TestTransactions:
    def test_rollback_undoes(self, ex):
        ex.execute("CREATE (:T {v: 1})")
        ex.execute("BEGIN")
        ex.execute("CREATE (:T {v: 2})")
        ex.execute("MATCH (t:T {v: 1}) SET t.v = 99")
        ex.execute("ROLLBACK")
        r = ex.execute("MATCH (t:T) RETURN t.v ORDER BY t.v")
        assert r.rows == [[1]]

    def test_commit_keeps(self, ex):
        ex.execute("BEGIN")
        ex.execute("CREATE (:T)")
        ex.execute("COMMIT")
        r = ex.execute("MATCH (t:T) RETURN count(t)")
        assert r.rows == [[1]]

    def test_tx_errors(self, ex):
        with pytest.raises(TransactionError):
            ex.execute("COMMIT")
        ex.execute("BEGIN")
        with pytest.raises(TransactionError):
            ex.execute("BEGIN")
        ex.execute("ROLLBACK")


class TestErrors:
    def test_syntax_error(self, ex):
        with pytest.raises(CypherSyntaxError):
            ex.execute("MATCH (n RETURN n")

    def test_unknown_function(self, ex):
        with pytest.raises(CypherSyntaxError):
            ex.execute("RETURN nosuchfunction(1)")

    def test_undefined_variable(self, ex):
        with pytest.raises(CypherSyntaxError):
            ex.execute("RETURN undefined_var")

    def test_unknown_procedure(self, ex):
        with pytest.raises(CypherSyntaxError):
            ex.execute("CALL no.such.proc()")


class TestExplain:
    def test_explain_returns_plan(self, ex):
        r = ex.execute("EXPLAIN MATCH (n) RETURN n")
        assert "MatchClause" in r.rows[0][0]

    def test_profile_runs(self, ex):
        ex.execute("CREATE (:X)")
        r = ex.execute("PROFILE MATCH (n:X) RETURN count(n)")
        assert r.rows == [[1]]
        assert "runtime" in r.plan


class TestMapProjections:
    def test_basic_projection(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) RETURN p {.name, .born} AS m"
        )
        assert r.rows == [[{"name": "Keanu Reeves", "born": 1964}]]

    def test_star_alias_and_var(self, movies):
        r = movies.execute(
            "MATCH (m:Movie {title: 'Speed'}) "
            "WITH m, 99 AS rank RETURN m {.*, rank, label: 'film'} AS out"
        )
        out = r.rows[0][0]
        assert out == {"title": "Speed", "released": 1994, "rank": 99,
                       "label": "film"}

    def test_missing_prop_is_null(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) RETURN p {.nope} AS m"
        )
        assert r.rows == [[{"nope": None}]]


class TestInlineWhere:
    def test_first_node_inline_where(self, movies):
        r = movies.execute(
            "MATCH (p:Person WHERE p.born > 1962) RETURN p.name ORDER BY p.name"
        )
        assert [x[0] for x in r.rows] == ["Carrie-Anne Moss", "Keanu Reeves"]

    def test_target_node_inline_where(self, movies):
        r = movies.execute(
            "MATCH (p:Person)-[:ACTED_IN]->(m:Movie WHERE m.released < 1999) "
            "RETURN p.name, m.title"
        )
        assert r.rows == [["Keanu Reeves", "Speed"]]


class TestPatternComprehensions:
    def test_project_neighbors(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) "
            "RETURN [(p)-[:ACTED_IN]->(m) | m.title] AS titles"
        )
        assert sorted(r.rows[0][0]) == ["Speed", "The Matrix"]

    def test_with_where(self, movies):
        r = movies.execute(
            "MATCH (p:Person {name: 'Keanu Reeves'}) "
            "RETURN [(p)-[:ACTED_IN]->(m) WHERE m.released > 1995 | m.title] AS t"
        )
        assert r.rows == [[["The Matrix"]]]

    def test_list_literal_with_parens_still_works(self, ex):
        r = ex.execute("RETURN [(1 + 2), 3] AS l")
        assert r.rows == [[[3, 3]]]
