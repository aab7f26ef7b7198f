"""The port's strict Cypher validator: the cases of
``tests/test_cypher_validator.py`` run against the port on the CPU,
unchanged but for their imports (the executor takes ``device="cpu"``).
"""

import pytest

from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.errors import CypherSyntaxError
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
    e.strict_validation = True
    return e


@pytest.fixture
def lenient():
    eng = MemoryEngine()
    schema = SchemaManager()
    schema.attach(eng)
    return CypherExecutor(eng, schema)


REJECTED = [
    # query termination (Neo4j: "Query cannot conclude with ...")
    ("MATCH (n)", "conclude with MATCH"),
    ("MATCH (n) WITH n", "conclude with WITH"),
    ("UNWIND [1,2] AS x", "conclude with UNWIND"),
    # undefined variables
    ("MATCH (n) RETURN m", "not defined"),
    ("MATCH (n) WHERE m.x = 1 RETURN n", "not defined"),
    ("MATCH (n) WITH n AS a RETURN n", "not defined"),  # WITH resets scope
    ("MATCH (n) DELETE m", "not defined"),
    # WITH alias requirement
    ("MATCH (n) WITH n.x RETURN 1", "must be aliased"),
    # aggregate placement
    ("MATCH (n) WHERE count(n) > 1 RETURN n", "aggregating function"),
    ("MATCH (n) UNWIND collect(n) AS x RETURN x", "aggregating function"),
    ("MATCH (n) RETURN count(count(n))", "inside of aggregate"),
    # RETURN * with empty scope
    ("RETURN *", "no variables in scope"),
    # duplicate result columns (RETURN and WITH alike)
    ("MATCH (n) RETURN n AS a, n.x AS a", "same name"),
    ("MATCH (n) WITH 1 AS a, 2 AS a RETURN a", "same name"),
    # aggregates hidden inside nested expression nodes still rejected
    # nested aggregate hidden inside a map projection
    ("MATCH (n) RETURN count(n {.x, c: count(n)}) AS x",
     "inside of aggregate"),
    ("MATCH (n) WHERE size([x IN [1] | count(n)]) > 0 RETURN n",
     "aggregating function"),
    # variable kind conflicts
    ("MATCH (n)-[n]->(m) RETURN n", "node and a relationship"),
    ("MATCH (a)-[r]->()-[r]->() RETURN a", "same relationship variable"),
    # rebinding in updating clauses
    ("MATCH (n) CREATE (n:Extra) RETURN n", "already declared"),
    ("CREATE (a)-[r:R*1..3]->(b)", "Variable length"),
    # SKIP/LIMIT literals
    ("MATCH (n) RETURN n LIMIT -1", "non-negative"),
    ("MATCH (n) RETURN n SKIP -2", "non-negative"),
    # UNION column agreement
    ("MATCH (n) RETURN n AS x UNION MATCH (m) RETURN m AS y", "same column"),
    # DELETE of a literal
    ("MATCH (n) DELETE 42", "literal"),
]


ACCEPTED = [
    "MATCH (n) WHERE n.x > 1 RETURN n.y AS y ORDER BY y LIMIT 5",
    "MATCH (n) WITH n AS m RETURN m",
    "MATCH (n) WITH collect(n) AS ns UNWIND ns AS x RETURN x",
    "MATCH (n) RETURN count(n) AS c",
    "MATCH (a)-[r:KNOWS]->(b) WHERE a.age > b.age RETURN a, r, b",
    "MATCH p = (a)-[*1..2]->(b) RETURN p",
    "CREATE (a:Person {name: 'x'})-[:KNOWS]->(b:Person) RETURN a, b",
    "MATCH (n) SET n.x = 1 REMOVE n.y RETURN n",
    "MATCH (n) DETACH DELETE n",
    "MATCH (n) RETURN [x IN [1,2,3] WHERE x > 1 | x * 2] AS doubled",
    "MATCH (n) RETURN reduce(acc = 0, x IN [1,2] | acc + x) AS s",
    "MATCH (n) RETURN all(x IN [1,2] WHERE x > 0) AS ok",
    "MATCH (n) RETURN n {.name, alias: n.x} AS projected",
    "RETURN 1 AS one UNION RETURN 2 AS one",
    "MATCH (n) RETURN n.x AS x SKIP 1 LIMIT 2",
    "MATCH (n) RETURN n.x AS x ORDER BY x DESC",
    "UNWIND [1,2] AS x RETURN x",
    "MATCH (n) WHERE exists((n)-[:KNOWS]->()) RETURN n",
    "CALL db.labels() YIELD label RETURN label",
    "MERGE (a:Person {name: 'x'}) ON CREATE SET a.created = 1 RETURN a",
    "MATCH (a) WITH a, count(*) AS c WHERE c > 0 RETURN a, c",
    "MATCH (n) RETURN n LIMIT $lim",
    "FOREACH (x IN [1,2] | CREATE (:Item {v: x}))",
]


class TestStrictRejections:
    @pytest.mark.parametrize("query,fragment", REJECTED)
    def test_rejected(self, ex, query, fragment):
        with pytest.raises(CypherSyntaxError) as e:
            ex.execute(query)
        assert fragment.lower() in str(e.value).lower()

    def test_lenient_mode_unchanged(self, lenient):
        # the default parser stays permissive (ref: "Lenient" column,
        # parser-modes doc) — bare MATCH executes and returns nothing
        assert lenient.strict_validation is False
        lenient.execute("MATCH (n)")


class TestStrictAccepts:
    @pytest.mark.parametrize("query", ACCEPTED)
    def test_accepted(self, ex, query):
        # seed a small graph so queries also *execute* under strict mode
        ex.execute(
            "CREATE (:Person {name: 'a', x: 1, y: 2, age: 30})"
            "-[:KNOWS]->(:Person {name: 'b', x: 2, age: 20})"
        )
        ex.execute(query, {"lim": 1})


class TestEnvGate:
    def test_env_enables_strict(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_PARSER", "strict")
        eng = MemoryEngine()
        schema = SchemaManager()
        schema.attach(eng)
        assert CypherExecutor(eng, schema).strict_validation is True

    def test_antlr_alias(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_PARSER", "antlr")
        eng = MemoryEngine()
        schema = SchemaManager()
        schema.attach(eng)
        assert CypherExecutor(eng, schema).strict_validation is True

    def test_default_lenient(self, monkeypatch):
        monkeypatch.delenv("NORNICDB_PARSER", raising=False)
        eng = MemoryEngine()
        schema = SchemaManager()
        schema.attach(eng)
        assert CypherExecutor(eng, schema).strict_validation is False


class TestScopeThreading:
    def test_call_subquery_import_checked(self, ex):
        with pytest.raises(CypherSyntaxError):
            ex.execute("CALL { WITH q MATCH (q)--(b) RETURN b } RETURN b")

    def test_call_subquery_exports_columns(self, ex):
        ex.execute("CREATE (:A {x: 1})")
        ex.execute("MATCH (a:A) CALL { MATCH (b:A) RETURN b } RETURN a, b")

    def test_yield_star_opens_scope(self, ex):
        # after YIELD * we cannot enumerate bindings — undefined-variable
        # checks are suppressed, other checks still run
        ex.execute("CALL db.labels() YIELD * RETURN label")
        with pytest.raises(CypherSyntaxError):
            ex.execute("CALL db.labels() YIELD * RETURN label LIMIT -1")

    def test_pattern_comprehension_binds(self, ex):
        ex.execute("CREATE (:Person {name: 'p'})")
        ex.execute(
            "MATCH (p:Person) RETURN [(p)-[:KNOWS]->(f) | f.name] AS names"
        )
