"""The cases of ``tests/test_apoc_export_path.py`` run against the port on the CPU,
unchanged but for their imports (the executor takes ``device="cpu"``).
"""


import os

import pytest

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


def _fresh_ex():
    storage = MemoryEngine()
    schema = SchemaManager()
    schema.attach(storage)
    return CypherExecutor(storage, schema=schema)


def _seed(ex):
    ex.execute(
        "CREATE (a:Person {name: 'Ada', age: 36})-[:KNOWS {since: 1840}]->"
        "(b:Person {name: 'Babbage'}), (a)-[:WROTE]->(:Note {text: 'x,y\"z'})"
    )


# -- export streaming --------------------------------------------------------

def test_export_json_stream(ex):
    _seed(ex)
    res = ex.execute(
        "CALL apoc.export.json.all(null) YIELD nodes, relationships, data "
        "RETURN nodes, relationships, data"
    )
    n, r, data = res.rows[0]
    assert (n, r) == (3, 2)
    assert '"type": "node"' in data and '"type": "relationship"' in data


def test_export_csv_stream_quoting(ex):
    _seed(ex)
    res = ex.execute("CALL apoc.export.csv.all(null) YIELD data RETURN data")
    data = res.rows[0][0]
    assert '"x,y""z"' in data  # csv-quoted comma+quote payload
    assert "_id,_labels" in data.splitlines()[0]


def test_export_cypher_stream(ex):
    _seed(ex)
    res = ex.execute("CALL apoc.export.cypher.all(null) YIELD data RETURN data")
    data = res.rows[0][0]
    assert "CREATE (:`Person`" in data
    assert "CREATE (a)-[:`KNOWS`" in data


def test_export_graphml_stream(ex):
    _seed(ex)
    res = ex.execute("CALL apoc.export.graphml.all(null) YIELD data RETURN data")
    data = res.rows[0][0]
    assert data.startswith("<?xml")
    assert 'label="KNOWS"' in data


def test_export_data_subset(ex):
    _seed(ex)
    res = ex.execute(
        "MATCH (p:Person) WITH collect(p) AS ps "
        "CALL apoc.export.json.data(ps, [], null) YIELD nodes, relationships "
        "RETURN nodes, relationships"
    )
    assert res.rows[0] == [2, 0]


# -- file gating -------------------------------------------------------------

def test_export_to_file_gated(ex, tmp_path, monkeypatch):
    _seed(ex)
    target = str(tmp_path / "out.json")
    monkeypatch.delenv("NORNICDB_APOC_EXPORT_ENABLED", raising=False)
    with pytest.raises(Exception, match="EXPORT_ENABLED"):
        ex.execute(f"CALL apoc.export.json.all('{target}')")
    assert not os.path.exists(target)
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    res = ex.execute(
        f"CALL apoc.export.json.all('{target}') YIELD file RETURN file"
    )
    assert res.rows[0][0] == target
    assert os.path.exists(target)


# -- round-trips -------------------------------------------------------------

def test_json_roundtrip(ex, tmp_path, monkeypatch):
    _seed(ex)
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "1")
    f = str(tmp_path / "g.jsonl")
    ex.execute(f"CALL apoc.export.json.all('{f}')")
    ex2 = _fresh_ex()
    res = ex2.execute(
        f"CALL apoc.import.json('{f}') YIELD nodes, relationships "
        "RETURN nodes, relationships"
    )
    assert res.rows[0] == [3, 2]
    got = ex2.execute(
        "MATCH (a:Person {name:'Ada'})-[k:KNOWS]->(b) RETURN k.since, b.name"
    )
    assert got.rows[0] == [1840, "Babbage"]


def test_csv_roundtrip(ex, tmp_path, monkeypatch):
    _seed(ex)
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "1")
    f = str(tmp_path / "g.csv")
    ex.execute(f"CALL apoc.export.csv.all('{f}')")
    ex2 = _fresh_ex()
    res = ex2.execute(
        f"CALL apoc.import.csv('{f}') YIELD nodes, relationships "
        "RETURN nodes, relationships"
    )
    assert res.rows[0] == [3, 2]
    got = ex2.execute("MATCH (n:Note) RETURN n.text")
    assert got.rows[0][0] == 'x,y"z'  # csv quoting round-trips


def test_graphml_roundtrip(ex, tmp_path, monkeypatch):
    _seed(ex)
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "1")
    f = str(tmp_path / "g.graphml")
    ex.execute(f"CALL apoc.export.graphml.all('{f}')")
    ex2 = _fresh_ex()
    res = ex2.execute(
        f"CALL apoc.import.graphml('{f}') YIELD nodes, relationships "
        "RETURN nodes, relationships"
    )
    assert res.rows[0] == [3, 2]
    got = ex2.execute("MATCH (:Person)-[k:KNOWS]->(:Person) RETURN count(k)")
    assert got.rows[0][0] == 1


def test_cypher_export_replayable(ex, tmp_path, monkeypatch):
    _seed(ex)
    res = ex.execute("CALL apoc.export.cypher.all(null) YIELD data RETURN data")
    script = res.rows[0][0]
    ex2 = _fresh_ex()
    for stmt in script.split(";\n"):
        if stmt.strip():
            ex2.execute(stmt)
    got = ex2.execute(
        "MATCH (a:Person {name:'Ada'})-[:KNOWS]->(b) RETURN b.name"
    )
    assert got.rows[0][0] == "Babbage"


def test_import_without_gate_refused(ex, tmp_path, monkeypatch):
    monkeypatch.delenv("NORNICDB_APOC_IMPORT_ENABLED", raising=False)
    f = str(tmp_path / "g.jsonl")
    open(f, "w").write("")
    with pytest.raises(Exception, match="IMPORT_ENABLED"):
        ex.execute(f"CALL apoc.import.json('{f}')")


# -- apoc.path.* -------------------------------------------------------------

def _chain(ex):
    ex.execute(
        "CREATE (a:N {i: 1})-[:R]->(b:N {i: 2})-[:R]->(c:N {i: 3}), "
        "(b)-[:S]->(d:M {i: 4})"
    )


def test_path_expand_depth_and_types(ex):
    _chain(ex)
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.expand(a, 'R>', null, 1, 3) "
        "YIELD path RETURN length(path) ORDER BY length(path)"
    )
    assert [r[0] for r in res.rows] == [1, 2]  # a->b, a->b->c; S-edge excluded


def test_path_expand_label_blacklist(ex):
    _chain(ex)
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.expand(a, null, '-M', 1, 3) "
        "YIELD path RETURN count(path)"
    )
    assert res.rows[0][0] == 2  # d:M filtered out


def test_path_expand_config_limit_and_uniqueness(ex):
    _chain(ex)
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.expandConfig(a, "
        "{relationshipFilter: 'R>', maxLevel: 5, limit: 1}) "
        "YIELD path RETURN count(path)"
    )
    assert res.rows[0][0] == 1


def test_path_spanning_tree(ex):
    _chain(ex)
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.spanningTree(a, {maxLevel: 5}) "
        "YIELD path RETURN count(path)"
    )
    assert res.rows[0][0] == 3  # b, c, d each reached exactly once


def test_path_elements_combine_slice(ex):
    _chain(ex)
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.expand(a, 'R>', null, 2, 2) "
        "YIELD path CALL apoc.path.elements(path) YIELD value "
        "RETURN size(value)"
    )
    assert res.rows[0][0] == 5  # n r n r n
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.expand(a, 'R>', null, 2, 2) "
        "YIELD path CALL apoc.path.slice(path, 1, 1) YIELD path AS p "
        "RETURN [n IN nodes(p) | n.i]"
    )
    assert res.rows[0][0] == [2, 3]


# -- review regressions -----------------------------------------------------

def test_csv_roundtrip_preserves_rel_props_and_ids(ex, tmp_path, monkeypatch):
    _seed(ex)
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "1")
    f = str(tmp_path / "g2.csv")
    ex.execute(f"CALL apoc.export.csv.all('{f}')")
    ex2 = _fresh_ex()
    ex2.execute(f"CALL apoc.import.csv('{f}')")
    got = ex2.execute("MATCH ()-[k:KNOWS]->() RETURN k.since")
    assert got.rows[0][0] == "1840"  # csv stringifies; value survives


def test_graphml_quotes_in_type_and_id(ex, tmp_path, monkeypatch):
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "1")
    ex.execute('CREATE (a:X {q: "has\\"quote"})-[:`SAYS_HI` {note: ""}]->(b:Y)')
    f = str(tmp_path / "q.graphml")
    ex.execute(f"CALL apoc.export.graphml.all('{f}')")
    ex2 = _fresh_ex()
    res = ex2.execute(
        f"CALL apoc.import.graphml('{f}') YIELD nodes, relationships "
        "RETURN nodes, relationships"
    )
    assert res.rows[0] == [2, 1]
    # empty-string property survives as "" not null
    got = ex2.execute("MATCH ()-[r:SAYS_HI]->() RETURN r.note")
    assert got.rows[0][0] == ""


def test_cypher_export_escapes_backtick_label(ex):
    ex.execute("CREATE (:`Weird``Label` {v: 1})")
    res = ex.execute("CALL apoc.export.cypher.all(null) YIELD data RETURN data")
    script = res.rows[0][0]
    ex2 = _fresh_ex()
    for stmt in script.split(";\n"):
        if stmt.strip():
            ex2.execute(stmt)
    got = ex2.execute("MATCH (n:`Weird``Label`) RETURN n.v")
    assert got.rows[0][0] == 1


def test_path_expand_min_level_zero(ex):
    _chain(ex)
    res = ex.execute(
        "MATCH (a:N {i: 1}) CALL apoc.path.expand(a, 'R>', null, 0, 1) "
        "YIELD path RETURN length(path) ORDER BY length(path)"
    )
    assert [r[0] for r in res.rows] == [0, 1]  # start-only path included


def test_path_expand_deep_chain_no_recursion_error(ex):
    # 1200-node chain > default recursion limit
    from nornicdb_tpu_torch.storage.types import Edge, Node
    for i in range(1200):
        ex.storage.create_node(
            Node(id=f"c{i}", labels=["C"], properties={"i": i}))
    for i in range(1199):
        ex.storage.create_edge(Edge(start_node=f"c{i}", end_node=f"c{i+1}",
                                    type="R"))
    res = ex.execute(
        "MATCH (a:C {i: 0}) "
        "CALL apoc.path.expandConfig(a, {relationshipFilter: 'R>', "
        "maxLevel: 100000}) YIELD path RETURN count(path)"
    )
    assert res.rows[0][0] == 1199


def test_csv_roundtrip_with_reserved_property_names(ex, tmp_path, monkeypatch):
    monkeypatch.setenv("NORNICDB_APOC_EXPORT_ENABLED", "1")
    monkeypatch.setenv("NORNICDB_APOC_IMPORT_ENABLED", "1")
    ex.execute("CREATE (a:T {`_id`: 'boom', `_weird`: 'w'})-[:L]->(b:T2)")
    f = str(tmp_path / "res.csv")
    ex.execute(f"CALL apoc.export.csv.all('{f}')")
    ex2 = _fresh_ex()
    ex2.execute(f"CALL apoc.import.csv('{f}')")
    got = ex2.execute("MATCH (t:T) RETURN t.`_id`, t.`_weird`")
    assert got.rows[0] == ["boom", "w"]
    # the edge survived: endpoints resolved by REAL ids, not the prop
    assert ex2.execute("MATCH (:T)-[l:L]->(:T2) RETURN count(l)").rows[0][0] == 1


def test_spanning_tree_bfs_reaches_via_shortest(ex):
    # DFS would claim y via the long branch and truncate z at maxLevel
    from nornicdb_tpu_torch.storage.types import Edge, Node
    for nid in ["a", "b", "c", "y", "d", "z"]:
        ex.storage.create_node(Node(id=nid, labels=["S2"], properties={"name": nid}))
    for s, t in [("a", "b"), ("b", "c"), ("c", "y"), ("a", "d"), ("d", "y"),
                 ("y", "z")]:
        ex.storage.create_edge(Edge(start_node=s, end_node=t, type="R"))
    res = ex.execute(
        "MATCH (a:S2 {name: 'a'}) "
        "CALL apoc.path.spanningTree(a, {maxLevel: 3}) "
        "YIELD path RETURN count(path)"
    )
    assert res.rows[0][0] == 5  # b, c, d, y, z all reached
