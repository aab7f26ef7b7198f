"""GraphQL on the port, on the CPU.

The port's copies of ``tests/test_graphql_features.py`` (fragments,
directives, variable defaults, __typename, introspection) and of
``tests/test_graphql_temporal.py`` (``TestGraphQL``, and the Cypher
temporal, temporal-arithmetic and ``CALL {} IN TRANSACTIONS`` classes,
which no other ``test_torch_*`` file holds): the JAX cases with only their
imports and the device argument (``device="cpu"``) changed.

Then ``GraphQLExecutor.execute`` of both packages over the same seeded
graph (nodes and edges with explicit ids, 32-wide ``HashEmbedder``
embeddings; ``uuid.uuid4`` seeded alike before each document, so the ids
that mutations generate are equal): a list of documents with fragments,
aliases, variables and their defaults, directives, introspection,
per-field and document errors, ``search`` / ``similar`` / ``cypher`` /
``neighbors`` / ``stats`` and each mutation, in order. The answers are
equal; a ``score`` is held within ``SCORE_TOL`` (half a bf16 step at 1.0:
both packages score a bf16 product), and two hits whose scores lie within
it may trade places.
"""

import json
import urllib.request
import uuid

import numpy as np
import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu import embed as jax_embed
from nornicdb_tpu.server.graphql import GraphQLExecutor as JaxGraphQLExecutor
from nornicdb_tpu.storage import types as jax_types
from nornicdb_tpu_torch import embed as port_embed
from nornicdb_tpu_torch.cypher import CypherExecutor
from nornicdb_tpu_torch.server import HttpServer
from nornicdb_tpu_torch.server.graphql import GraphQLExecutor
from nornicdb_tpu_torch.storage import MemoryEngine
from nornicdb_tpu_torch.storage import types as port_types

# half of bf16's step in [0.5, 1] (2**-8 / 2), as in
# tests/test_torch_server_parity.py
SCORE_TOL = 4e-3


@pytest.fixture
def db():
    d = nornicdb_tpu_torch.open_db("", device="cpu")
    yield d
    d.close()


@pytest.fixture
def gq():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    yield GraphQLExecutor(db)
    db.close()


# ------------------------------------------------ tests/test_graphql_features.py
def _seed(gq):
    gq.execute('mutation { createNode(labels: ["City"], properties: {name: "Oslo"}) { id } }')


def test_named_fragment(gq):
    _seed(gq)
    out = gq.execute(
        'query { nodes(label: "City") { ...CityBits } } '
        "fragment CityBits on Node { id labels properties }"
    )
    assert "errors" not in out
    row = out["data"]["nodes"][0]
    assert set(row.keys()) == {"id", "labels", "properties"}


def test_fragment_before_operation_and_nesting(gq):
    _seed(gq)
    out = gq.execute(
        "fragment Inner on Node { labels } "
        "fragment Outer on Node { id ...Inner } "
        'query { nodes(label: "City") { ...Outer } }'
    )
    assert "errors" not in out
    assert set(out["data"]["nodes"][0].keys()) == {"id", "labels"}


def test_unknown_fragment_is_error(gq):
    out = gq.execute("query { nodes { ...Nope } }")
    assert "errors" in out


def test_fragment_cycle_is_error_not_hang(gq):
    _seed(gq)
    out = gq.execute(
        "fragment A on Node { ...B } fragment B on Node { ...A } "
        'query { nodes(label: "City") { ...A } }'
    )
    assert "errors" in out
    assert "deep" in out["errors"][0]["message"]


def test_inline_fragment_type_condition(gq):
    _seed(gq)
    out = gq.execute(
        'query { nodes(label: "City") { '
        "... on Node { id } ... on Relationship { type } } }"
    )
    row = out["data"]["nodes"][0]
    assert "id" in row and "type" not in row  # Relationship branch skipped


def test_include_skip_directives(gq):
    _seed(gq)
    out = gq.execute(
        "query Q($yes: Boolean = true, $no: Boolean = false) { "
        'nodes(label: "City") { '
        "id @include(if: $yes) labels @include(if: $no) "
        "properties @skip(if: $yes) } }"
    )
    row = out["data"]["nodes"][0]
    assert set(row.keys()) == {"id"}


def test_variable_defaults_and_override(gq):
    _seed(gq)
    out = gq.execute(
        'query Q($l: String = "City") { nodes(label: $l) { id } }'
    )
    assert len(out["data"]["nodes"]) == 1
    out = gq.execute(
        'query Q($l: String = "City") { nodes(label: $l) { id } }',
        {"l": "Nope"},
    )
    assert out["data"]["nodes"] == []


def test_typename_at_all_levels(gq):
    _seed(gq)
    out = gq.execute(
        'query { __typename nodes(label: "City") { __typename id } }'
    )
    assert out["data"]["__typename"] == "Query"
    assert out["data"]["nodes"][0]["__typename"] == "Node"


def test_introspection_schema(gq):
    out = gq.execute(
        "query { __schema { queryType { name } mutationType { name } "
        "types { name kind } } }"
    )
    assert "errors" not in out
    schema = out["data"]["__schema"]
    assert schema["queryType"]["name"] == "Query"
    assert schema["mutationType"]["name"] == "Mutation"
    names = {t["name"] for t in schema["types"]}
    assert {"Query", "Mutation", "Node", "Relationship"} <= names


def test_introspection_type_fields(gq):
    out = gq.execute(
        'query { __type(name: "Node") { name fields { name type { name } } } }'
    )
    t = out["data"]["__type"]
    assert t["name"] == "Node"
    fields = {f["name"] for f in t["fields"]}
    assert {"id", "labels", "properties"} <= fields


def test_introspection_unknown_type_is_null(gq):
    out = gq.execute('query { __type(name: "Nope") { name } }')
    assert out["data"]["__type"] is None


def test_complex_variable_types_parse(gq):
    _seed(gq)
    out = gq.execute(
        "query Q($ls: [String!]! = []) { "
        'nodes(label: "City") { id } }'
    )
    assert "errors" not in out
    assert len(out["data"]["nodes"]) == 1


def test_multiple_operations_rejected(gq):
    out = gq.execute("query A { stats { nodes } } query B { stats { nodes } }")
    assert "errors" in out


def test_mutation_root_typename(gq):
    out = gq.execute(
        'mutation { __typename createNode(labels: ["X"]) { __typename id } }'
    )
    assert out["data"]["__typename"] == "Mutation"
    assert out["data"]["createNode"]["__typename"] == "Node"


# -- review regressions -----------------------------------------------------

def test_fragment_field_merging(gq):
    """Composed fragments selecting into the same field merge, not clobber."""
    out = gq.execute(
        "query { ...A ...B } "
        "fragment A on Query { stats { nodes } } "
        "fragment B on Query { stats { edges } }"
    )
    assert "errors" not in out
    assert set(out["data"]["stats"].keys()) == {"nodes", "edges"}


def test_duplicate_root_mutation_resolves_once(gq):
    out = gq.execute(
        'mutation { createNode(labels: ["Once"]) { id } '
        'createNode(labels: ["Once"]) { labels } }'
    )
    assert "errors" not in out
    check = gq.execute('query { nodes(label: "Once") { id } }')
    assert len(check["data"]["nodes"]) == 1  # merged key -> one execution


def test_introspection_list_wrapper_shape(gq):
    out = gq.execute(
        'query { __type(name: "Query") { fields { name type { kind name '
        "ofType { name kind } } } } }"
    )
    fields = {f["name"]: f["type"] for f in out["data"]["__type"]["fields"]}
    t = fields["nodes"]
    assert t["kind"] == "LIST" and t["name"] is None
    assert t["ofType"] == {"name": "Node", "kind": "OBJECT"}


def test_typename_on_stats_and_search_objects(gq):
    out = gq.execute("query { stats { __typename nodes } }")
    assert out["data"]["stats"]["__typename"] == "Stats"


def test_query_fragment_does_not_leak_into_node(gq):
    _seed(gq)
    out = gq.execute(
        'query { nodes(label: "City") { ...Meta id } } '
        "fragment Meta on Query { stats }"
    )
    row = out["data"]["nodes"][0]
    assert "stats" not in row  # Query-conditioned fragment skipped inside Node


def test_include_without_if_is_error(gq):
    _seed(gq)
    out = gq.execute('query { nodes(label: "City") { id @include } }')
    assert "errors" in out
    assert "'if'" in out["errors"][0]["message"]


def test_include_undefined_variable_is_error(gq):
    _seed(gq)
    out = gq.execute(
        'query { nodes(label: "City") { id @include(if: $typo) } }'
    )
    assert "errors" in out
    assert "$typo" in out["errors"][0]["message"]


def test_conflicting_same_key_fields_rejected(gq):
    out = gq.execute('query { node(id: "a") { id } node(id: "b") { labels } }')
    assert "errors" in out
    assert "conflict" in out["errors"][0]["message"]


def test_same_var_args_merge_cleanly(gq):
    _seed(gq)
    out = gq.execute(
        'query Q($l: String = "City") '
        "{ nodes(label: $l) { id } nodes(label: $l) { labels } }"
    )
    assert "errors" not in out
    assert set(out["data"]["nodes"][0].keys()) == {"id", "labels"}


# ------------------------------------------------ tests/test_graphql_temporal.py
class TestGraphQL:
    def test_create_and_query_nodes(self, db):
        gq = GraphQLExecutor(db)
        out = gq.execute(
            'mutation { createNode(labels: ["City"], properties: {name: "Oslo", pop: 700000}) { id properties } }'
        )
        assert out["data"]["createNode"]["properties"]["name"] == "Oslo"
        out = gq.execute('{ nodes(label: "City") { id labels properties } }')
        assert len(out["data"]["nodes"]) == 1
        assert out["data"]["nodes"][0]["labels"] == ["City"]

    def test_field_projection_and_alias(self, db):
        gq = GraphQLExecutor(db)
        gq.execute('mutation { createNode(labels: ["P"], properties: {a: 1, b: 2}) { id } }')
        out = gq.execute('{ people: nodes(label: "P") { props: properties } }')
        row = out["data"]["people"][0]
        assert set(row.keys()) == {"props"}  # only selected fields
        assert row["props"] == {"a": 1, "b": 2}

    def test_relationships_and_neighbors(self, db):
        gq = GraphQLExecutor(db)
        a = gq.execute('mutation { createNode(labels: ["N"]) { id } }')["data"]["createNode"]["id"]
        b = gq.execute('mutation { createNode(labels: ["N"]) { id } }')["data"]["createNode"]["id"]
        out = gq.execute(
            'mutation($f: ID, $t: ID) { createRelationship(from: $f, to: $t, type: "LINKS") { id type } }',
            {"f": a, "t": b},
        )
        assert out["data"]["createRelationship"]["type"] == "LINKS"
        out = gq.execute(f'{{ neighbors(id: "{a}") {{ id }} }}')
        assert out["data"]["neighbors"][0]["id"] == b

    def test_cypher_passthrough(self, db):
        gq = GraphQLExecutor(db)
        out = gq.execute(
            'query($s: String) { cypher(statement: $s) { columns rows } }',
            {"s": "RETURN 1 + 1 AS two"},
        )
        assert out["data"]["cypher"] == {"columns": ["two"], "rows": [[2]]}

    def test_errors_reported_per_field(self, db):
        gq = GraphQLExecutor(db)
        out = gq.execute('{ node(id: "missing") { id } stats { nodes } }')
        assert out["data"]["node"] is None
        assert out["data"]["stats"]["nodes"] == 0
        assert out["errors"][0]["path"] == ["node"]

    def test_http_graphql_endpoint(self, db):
        server = HttpServer(db, port=0)
        server.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/graphql",
                data=json.dumps(
                    {"query": "{ stats { nodes edges } }"}
                ).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req) as resp:
                out = json.loads(resp.read())
            assert out["data"]["stats"] == {"nodes": 0, "edges": 0}
        finally:
            server.stop()


class TestTemporal:
    @pytest.fixture
    def ex(self):
        return CypherExecutor(MemoryEngine(), device="cpu")

    def test_date_and_accessors(self, ex):
        r = ex.execute("RETURN date('2024-03-15') AS d")
        d = r.rows[0][0]
        assert (d["year"], d["month"], d["day"]) == (2024, 3, 15)
        r = ex.execute("RETURN date('2024-03-15').year AS y")
        assert r.rows == [[2024]]

    def test_datetime_parse_and_epoch(self, ex):
        r = ex.execute("RETURN datetime('2024-01-01T00:00:00Z') AS dt")
        dt = r.rows[0][0]
        assert dt["epochMillis"] == 1704067200000
        r = ex.execute("RETURN datetime.fromEpochMillis(0).year AS y")
        assert r.rows == [[1970]]

    def test_duration(self, ex):
        r = ex.execute("RETURN duration('P1DT2H30M') AS d")
        d = r.rows[0][0]
        assert d["days"] == 1 and d["hours"] == 2 and d["minutes"] == 30
        assert d["milliseconds"] == (86400 + 2 * 3600 + 30 * 60) * 1000
        r = ex.execute("RETURN duration({hours: 2}).iso AS i")
        assert r.rows == [["PT2H"]]

    def test_duration_between(self, ex):
        r = ex.execute(
            "RETURN duration.between(datetime('2024-01-01T00:00:00Z'), "
            "datetime('2024-01-02T03:00:00Z')) AS d"
        )
        d = r.rows[0][0]
        assert d["days"] == 1 and d["hours"] == 3

    def test_truncate_and_ordering(self, ex):
        r = ex.execute("RETURN date.truncate('month', datetime('2024-03-15T10:00:00Z')).day AS d")
        assert r.rows == [[1]]
        # iso strings sort correctly
        r = ex.execute(
            "UNWIND ['2024-05-01', '2023-01-01', '2024-01-01'] AS s "
            "RETURN date(s).iso AS d ORDER BY d"
        )
        assert [row[0] for row in r.rows] == ["2023-01-01", "2024-01-01", "2024-05-01"]

    def test_store_datetime_property(self, ex):
        ex.execute("CREATE (:E {at: datetime('2024-06-01T12:00:00Z').epochMillis})")
        r = ex.execute("MATCH (e:E) WHERE e.at > 0 RETURN e.at")
        assert r.rows == [[1717243200000]]


class TestTemporalArithmetic:
    @pytest.fixture
    def ex(self):
        return CypherExecutor(MemoryEngine(), device="cpu")

    def test_datetime_plus_duration(self, ex):
        r = ex.execute(
            "RETURN (datetime('2024-01-01T00:00:00Z') + duration('P1DT2H')).iso AS i"
        )
        assert r.rows == [["2024-01-02T02:00:00+00:00"]]

    def test_datetime_minus_duration_and_date(self, ex):
        r = ex.execute(
            "RETURN (datetime('2024-01-02T00:00:00Z') - duration({hours: 24})).day AS d, "
            "(date('2024-03-15') + duration({days: 20})).iso AS i"
        )
        assert r.rows == [[1, "2024-04-04"]]

    def test_datetime_difference_is_duration(self, ex):
        r = ex.execute(
            "RETURN (datetime('2024-01-02T03:00:00Z') - datetime('2024-01-01T00:00:00Z'))"
            ".milliseconds AS ms"
        )
        assert r.rows == [[(27 * 3600) * 1000]]

    def test_duration_sum(self, ex):
        r = ex.execute(
            "RETURN (duration({hours: 1}) + duration({minutes: 30})).milliseconds AS ms"
        )
        assert r.rows == [[5400000]]


class TestCallInTransactions:
    @pytest.fixture
    def ex(self):
        return CypherExecutor(MemoryEngine(), device="cpu")

    def test_batched_import(self, ex):
        r = ex.execute(
            "UNWIND range(1, 10) AS i "
            "CALL { CREATE (:Batch {v: i}) } IN TRANSACTIONS OF 3 ROWS "
            "RETURN count(*) AS n"
        )
        assert r.rows == [[10]]
        assert ex.execute("MATCH (b:Batch) RETURN count(b)").rows == [[10]]

    def test_failure_keeps_committed_batches(self, ex):
        ex.execute("CREATE CONSTRAINT uq FOR (n:U) REQUIRE n.v IS UNIQUE")
        ex.schema.attach(ex.storage)
        with pytest.raises(Exception):
            ex.execute(
                "UNWIND [1, 2, 3, 4, 5, 5, 7] AS i "
                "CALL { CREATE (:U {v: i}) } IN TRANSACTIONS OF 2 ROWS "
                "RETURN count(*)"
            )
        # batches before the duplicate committed; the failing one aborted
        n = ex.execute("MATCH (u:U) RETURN count(u)").rows[0][0]
        assert 4 <= n <= 5


# ------------------------------------------------------ the port vs JAX
PKGS = {
    "jax": (lambda: nornicdb_tpu.open_db(""), jax_types, jax_embed,
            JaxGraphQLExecutor),
    "torch": (lambda: nornicdb_tpu_torch.open_db("", device="cpu"),
              port_types, port_embed, GraphQLExecutor),
}
N_DOCS = 30
WORDS = ["graph", "vector", "search", "node", "edge", "query", "index",
         "card", "memory", "label"]


class _Ids:
    """A seeded stand-in for ``uuid.uuid4``."""

    def __init__(self, start: int):
        self.n = start

    def __call__(self):
        self.n += 1
        return uuid.UUID(int=(0x5EED << 96) + self.n, version=4)


def _seed_graph(db, types_mod, embed_mod, seed: int) -> None:
    rng = np.random.default_rng(seed)
    emb = embed_mod.HashEmbedder(32)
    for i in range(N_DOCS):
        text = " ".join(rng.choice(WORDS, 4)) + f" doc{i}"
        db.storage.create_node(types_mod.Node(
            id=f"d{i}", labels=["Doc"] + (["Hot"] if i % 4 == 0 else []),
            properties={"content": text, "k": i, "w": float(i) / 8,
                        "tags": [str(t) for t in rng.choice(WORDS, 2)]},
            embedding=emb.embed(text)))
    for i in range(N_DOCS - 1):
        db.storage.create_edge(types_mod.Edge(
            id=f"e{i}", start_node=f"d{i}", end_node=f"d{(i * 7 + 3) % N_DOCS}",
            type="NEXT" if i % 3 else "LINKS", properties={"i": i}))
    db.set_embedder(emb)  # the search field embeds its query


def _documents() -> list:
    """(query, variables) pairs, run in order."""
    return [
        ("{ stats { nodes edges pendingEmbeddings __typename } }", None),
        ('{ node(id: "d3") { id labels properties decayScore accessCount '
         "__typename } }", None),
        ('{ hot: nodes(label: "Hot", limit: 5) { id props: properties } '
         'all: nodes(limit: 4) { id } }', None),
        ('{ relationships(type: "LINKS", limit: 4) { id type from to '
         "properties confidence autoGenerated } relationships2: "
         "relationships(limit: 3) { id } }", None),
        ('query Q($q: String = "graph search") { search(query: $q, '
         "limit: 5) { id score content node { id labels } } }", None),
        ('query Q($q: String = "graph search") { search(query: $q, '
         "limit: 3) { id score } }", {"q": "memory card"}),
        ('{ similar(id: "d1", limit: 4) { id score __typename } '
         'other: similar(id: "d7") { id score } }', None),
        ('query C($s: String, $p: JSON) { cypher(statement: $s, '
         "parameters: $p) { columns rows stats __typename } }",
         {"s": "MATCH (n:Doc) WHERE n.k < $m RETURN n.k AS k, n.tags AS t "
               "ORDER BY k", "p": {"m": 4}}),
        ('{ cypher(statement: "MATCH (n:Doc {k: 2}) RETURN n") '
         "{ columns rows } }", None),
        ('{ neighbors(id: "d0", depth: 2) { id labels } '
         'one: neighbors(id: "d5") { id } }', None),
        ("query F($yes: Boolean = true, $no: Boolean = false) { "
         'nodes(label: "Hot", limit: 3) { ...Bits ... on Node { labels '
         "@include(if: $no) } properties @skip(if: $yes) } "
         "stats @include(if: $yes) { ...S } } "
         "fragment Bits on Node { id __typename } "
         "fragment S on Stats { nodes edges }", None),
        ("query F($yes: Boolean = true) { stats @skip(if: $yes) "
         "{ nodes } }", {"yes": False}),
        ("{ __schema { queryType { name } mutationType { name } "
         "subscriptionType { name } types { name kind fields { name args "
         "{ name type { name kind } } type { kind name ofType { name } } } }"
         " directives { name locations args { name } } } }", None),
        ('{ __type(name: "Mutation") { name kind fields { name } } '
         'missing: __type(name: "Nope") { name } }', None),
        ('{ node(id: "missing") { id } stats { nodes } bogus }', None),
        ('{ similar(id: "nope") { id } }', None),
        ("{ nodes( }", None),
        ("query { ...Nope }", None),
        ("query A { stats { nodes } } query B { stats { edges } }", None),
        ('{ node(id: "a") { id } node(id: "b") { labels } }', None),
        ('{ nodes { id @include } }', None),
        ('{ cypher(statement: "MATCH (n RETURN n") { rows } }', None),
        ('mutation { createNode(labels: ["City"], properties: {name: '
         '"Oslo", pop: 700000, tags: ["a", "b"]}) { id labels properties '
         "__typename } }", None),
        ('mutation U($p: JSON) { updateNode(id: "d2", properties: $p) '
         "{ id properties } }", {"p": {"k": 200, "extra": [1, 2]}}),
        ('mutation { createRelationship(from: "d0", to: "d9", type: '
         '"CITES", properties: {w: 0.5}) { id type from to properties } '
         'second: createRelationship(from: "d9", to: "d0") { type } }',
         None),
        ('mutation { deleteRelationship(id: "e4") }', None),
        ('mutation { deleteRelationship(id: "e4") }', None),
        ('mutation { deleteNode(id: "d11") __typename }', None),
        ('mutation { deleteNode(id: "d11") }', None),
        ('mutation { updateNode(id: "nope", properties: {a: 1}) { id } }',
         None),
        ('mutation { bogus }', None),
        ("{ stats { nodes edges } relationships(limit: 100) { id type } "
         'nodes(label: "City") { labels properties } '
         'neighbors(id: "d9") { id } }', None),
    ]


def _equal(a, b, path="$") -> None:
    """Equal answers; a score within SCORE_TOL, and hits (dicts with a
    score) that tie within it may trade places."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            if k == "score":
                assert abs(a[k] - b[k]) <= SCORE_TOL, (path, a[k], b[k])
            else:
                _equal(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), path
        if a and all(isinstance(h, dict) and "score" in h for h in a + b):
            _same_hits(a, b, path)
            return
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
        return
    assert a == b, (path, a, b)


def _same_hits(a: list, b: list, path: str) -> None:
    in_a = {h["id"]: h for h in a}
    in_b = {h["id"]: h for h in b}
    for i, (x, y) in enumerate(zip(a, b)):
        assert abs(x["score"] - y["score"]) <= SCORE_TOL, (path, i, x, y)
        for h, other, seq in ((x, in_b, b), (y, in_a, a)):
            twin = other.get(h["id"])
            if twin is not None:
                _equal(h, twin, f"{path}[{i}]")
            else:  # cut at the limit for a hit it ties with
                assert abs(h["score"] - seq[-1]["score"]) <= SCORE_TOL, (
                    path, h)


def _answers(name: str, monkeypatch, seed: int) -> list:
    open_db, types_mod, embed_mod, executor = PKGS[name]
    db = open_db()
    try:
        _seed_graph(db, types_mod, embed_mod, seed)
        gq = executor(db)
        out = []
        for i, (query, variables) in enumerate(_documents()):
            monkeypatch.setattr(uuid, "uuid4", _Ids(1000 * i))
            out.append(json.loads(json.dumps(gq.execute(query, variables),
                                             default=str)))
        return out
    finally:
        db.close()


class TestGraphQLParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_documents_answer_alike(self, monkeypatch, seed):
        want = _answers("jax", monkeypatch, seed)
        got = _answers("torch", monkeypatch, seed)
        docs = _documents()
        assert len(want) == len(got) == len(docs)
        for (query, _), w, g in zip(docs, want, got):
            _equal(w, g, query)
        # the list reached data, per-field errors and document errors alike
        assert sum("errors" not in w for w in want) >= 15
        assert sum("errors" in w and bool(w.get("data")) for w in want) >= 3
        assert sum("errors" in w and "data" not in w for w in want) >= 3
