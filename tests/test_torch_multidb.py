"""The port's multi-database manager (``nornicdb_tpu_torch.multidb``).

The cases of ``TestDatabaseManager`` in ``tests/test_multidb.py`` run
against the port unchanged but for their imports (its Cypher cases wait for
the port's executor). Then the same lifecycle, aliases, composites, limits
and metadata reload go through both packages' managers by the API, over
in-memory and durable chains, and must agree.
"""

import pytest

from nornicdb_tpu_torch.errors import AlreadyExistsError, NornicError, NotFoundError
from nornicdb_tpu_torch.multidb import DatabaseLimits, DatabaseManager, SYSTEM_DB
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node


# ---- cases of tests/test_multidb.py, against the port
class TestDatabaseManager:
    def test_implicit_databases(self):
        mgr = DatabaseManager(MemoryEngine())
        assert set(mgr.list_databases()) >= {SYSTEM_DB, "neo4j"}

    def test_create_drop(self):
        mgr = DatabaseManager(MemoryEngine())
        mgr.create_database("sales")
        assert "sales" in mgr.list_databases()
        with pytest.raises(AlreadyExistsError):
            mgr.create_database("sales")
        mgr.create_database("sales", if_not_exists=True)  # no raise
        mgr.drop_database("sales")
        assert "sales" not in mgr.list_databases()
        with pytest.raises(NotFoundError):
            mgr.drop_database("sales")
        mgr.drop_database("sales", if_exists=True)

    def test_cannot_drop_system(self):
        mgr = DatabaseManager(MemoryEngine())
        with pytest.raises(NornicError):
            mgr.drop_database(SYSTEM_DB)

    def test_isolation(self):
        mgr = DatabaseManager(MemoryEngine())
        mgr.create_database("a")
        mgr.create_database("b")
        sa, sb = mgr.get_storage("a"), mgr.get_storage("b")
        sa.create_node(Node(id="x", labels=["T"]))
        assert sa.node_count() == 1
        assert sb.node_count() == 0
        with pytest.raises(NotFoundError):
            sb.get_node("x")

    def test_drop_deletes_data(self):
        base = MemoryEngine()
        mgr = DatabaseManager(base)
        mgr.create_database("tmp")
        s = mgr.get_storage("tmp")
        s.create_node(Node(id="n1"))
        s.create_node(Node(id="n2"))
        s.create_edge(Edge(id="e", start_node="n1", end_node="n2"))
        mgr.drop_database("tmp")
        assert all(not n.id.startswith("tmp:") for n in base.all_nodes())

    def test_aliases(self):
        mgr = DatabaseManager(MemoryEngine())
        mgr.create_database("prod")
        mgr.create_alias("main", "prod")
        assert mgr.resolve("main") == "prod"
        s = mgr.get_storage("main")
        s.create_node(Node(id="via-alias"))
        assert mgr.get_storage("prod").get_node("via-alias")
        assert mgr.list_aliases() == [("main", "prod")]
        mgr.drop_alias("main")
        with pytest.raises(NotFoundError):
            mgr.get_storage("main")

    def test_metadata_persists(self):
        base = MemoryEngine()
        mgr = DatabaseManager(base)
        mgr.create_database("persisted")
        mgr.create_alias("p", "persisted")
        mgr2 = DatabaseManager(base)  # fresh manager, same storage
        assert "persisted" in mgr2.list_databases()
        assert mgr2.resolve("p") == "persisted"

    def test_limits_enforced(self):
        mgr = DatabaseManager(MemoryEngine())
        mgr.create_database("small", limits=DatabaseLimits(max_nodes=2))
        s = mgr.get_storage("small")
        s.create_node(Node(id="1"))
        s.create_node(Node(id="2"))
        with pytest.raises(NornicError):
            s.create_node(Node(id="3"))

    def test_composite_federation(self):
        mgr = DatabaseManager(MemoryEngine())
        mgr.create_database("east")
        mgr.create_database("west")
        mgr.get_storage("east").create_node(Node(id="e1", labels=["City"]))
        mgr.get_storage("west").create_node(Node(id="w1", labels=["City"]))
        mgr.create_composite("world", ["east", "west"])
        comp = mgr.get_storage("world")
        assert comp.node_count() == 2
        labels = {n.id for n in comp.get_nodes_by_label("City")}
        assert labels == {"east.e1", "west.w1"}
        # routing by qualified id
        assert comp.get_node("east.e1").id == "east.e1"
        # writes route deterministically (ref composite_engine.go routeWrite):
        # a label matching a constituent alias lands there
        created = comp.create_node(Node(id="ne1", labels=["east"]))
        assert created.id == "east.ne1"
        assert mgr.get_storage("east").get_node("ne1") is not None
        # database_id property names the target exactly
        created = comp.create_node(Node(
            id="nw1", labels=["City"], properties={"database_id": "west"}))
        assert created.id == "west.nw1"
        # no labels/properties: deterministic first-writable fallback
        assert comp.create_node(Node(id="plain")).id.split(".")[0] in (
            "east", "west")

    def test_storage_stats(self):
        mgr = DatabaseManager(MemoryEngine())
        mgr.create_database("s1")
        mgr.get_storage("s1").create_node(Node(id="a"))
        stats = mgr.storage_stats()
        assert stats["s1"] == {"nodes": 1, "edges": 0}


# ---- against the JAX package
import nornicdb_tpu.multidb as jax_multidb  # noqa: E402
import nornicdb_tpu.storage as jax_storage  # noqa: E402
import nornicdb_tpu_torch.multidb as port_multidb  # noqa: E402
import nornicdb_tpu_torch.storage as port_storage  # noqa: E402

PKGS = {"jax": (jax_storage, jax_multidb),
        "port": (port_storage, port_multidb)}


def _try(fn, *a, **kw):
    try:
        out = fn(*a, **kw)
        return ("ok", None if out is None else getattr(out, "id", repr(out)))
    except Exception as e:
        return ("raised", type(e).__name__)


def _lifecycle(st, mdb, base) -> list:
    """Every manager operation through the API, recording each answer."""
    mgr = mdb.DatabaseManager(base)
    rec = [sorted(mgr.list_databases())]
    rec.append(_try(mgr.create_database, "sales"))
    rec.append(_try(mgr.create_database, "sales"))
    rec.append(_try(mgr.create_database, "sales", if_not_exists=True))
    rec.append(_try(mgr.create_database, "hr",
                    limits=mdb.DatabaseLimits(max_nodes=3, max_edges=1)))
    rec.append(_try(mgr.drop_database, mdb.SYSTEM_DB))
    for db in ("sales", "hr"):
        s = mgr.get_storage(db)
        for i in range(4):  # the same ids in both databases
            rec.append(_try(s.create_node, st.Node(
                id=f"x{i}", labels=["Emp"], properties={"db": db},
                created_at=1.0, updated_at=1.0, last_accessed=1.0)))
        for j in range(2):
            rec.append(_try(s.create_edge, st.Edge(
                id=f"r{j}", start_node="x0", end_node=f"x{j + 1}",
                created_at=1.0, updated_at=1.0)))
    rec.append(_try(mgr.create_alias, "people", "hr"))
    rec.append(_try(mgr.create_alias, "people", "sales"))
    rec.append(mgr.resolve("people"))
    rec.append(sorted(n.properties["db"]
                      for n in mgr.get_storage("people").get_nodes_by_label(
                          "Emp")))
    rec.append(_try(mgr.create_composite, "all", ["sales", "hr"]))
    comp = mgr.get_storage("all")
    rec.append(sorted(n.id for n in comp.all_nodes()))
    rec.append(comp.node_count())
    for target in ("sales", "hr"):  # hr is at its node limit
        rec.append(_try(comp.create_node, st.Node(
            id=f"routed-{target}", labels=[target], created_at=1.0,
            updated_at=1.0, last_accessed=1.0)))
    rec.append(_try(mgr.set_limits, "sales",
                    mdb.DatabaseLimits(max_edges=2)))
    rec.append(_try(mgr.get_storage("sales").create_edge, st.Edge(
        id="r9", start_node="x2", end_node="x3")))
    rec.append(repr(mgr.get_limits("sales")))
    rec.append(mgr.storage_stats())
    rec.append(sorted(mgr.list_aliases()))
    rec.append(_try(mgr.create_database, "tmp"))
    mgr.get_storage("tmp").create_node(st.Node(id="gone"))
    rec.append(_try(mgr.drop_database, "tmp"))
    rec.append(_try(mgr.get_storage, "tmp"))
    rec.append(sorted(n.id for n in base.all_nodes()
                      if not n.id.startswith("system:")))
    # a fresh manager over the same storage reloads the metadata
    mgr2 = mdb.DatabaseManager(base)
    rec.append(sorted(mgr2.list_databases()))
    rec.append((mgr2.resolve("people"), sorted(mgr2.list_aliases())))
    rec.append(mgr2.storage_stats())
    return rec


class TestManagerAgainstJax:
    def test_lifecycle_matches_in_memory(self):
        out = {name: _lifecycle(st, mdb, st.MemoryEngine())
               for name, (st, mdb) in PKGS.items()}
        assert out["port"] == out["jax"]
        stats = out["port"][-1]
        assert stats["sales"]["nodes"] == 5  # one routed in by its label
        assert stats["hr"] == {"nodes": 3, "edges": 1}  # held to its limits

    @pytest.mark.parametrize("engine", ["wal", "segment"])
    def test_lifecycle_matches_and_reopens_on_disk(self, tmp_path, engine):
        out = {}
        for name, (st, mdb) in PKGS.items():
            d = str(tmp_path / name)
            base = st.open_storage(d, engine=engine)
            rec = _lifecycle(st, mdb, base)
            base.close()
            again = st.open_storage(d, engine=engine)
            mgr = mdb.DatabaseManager(again)
            rec.append((sorted(mgr.list_databases()),
                        sorted(mgr.list_aliases()), mgr.storage_stats()))
            again.close()
            out[name] = rec
        assert out["port"] == out["jax"]
        assert "all" in out["port"][-1][0]
        # the port reopens the JAX package's directory to the same state
        again = port_storage.open_storage(str(tmp_path / "jax"),
                                          engine=engine)
        try:
            mgr = port_multidb.DatabaseManager(again)
            assert mgr.storage_stats() == out["jax"][-1][2]
        finally:
            again.close()

    def test_rate_limits_match(self):
        out = {}
        for name, (st, mdb) in PKGS.items():
            mgr = mdb.DatabaseManager(st.MemoryEngine())
            mgr.create_database(
                "slow", limits=mdb.DatabaseLimits(max_writes_per_second=2))
            s = mgr.get_storage("slow")
            res = [_try(s.create_node, st.Node(id=f"n{i}"))
                   for i in range(4)]
            with s.exempt_writes():
                res.append(_try(s.create_node, st.Node(id="exempt")))
            limits, bucket = mgr.query_limit_state("slow")
            res.append((repr(limits), bucket is None))
            out[name] = res
        assert out["port"] == out["jax"]
        assert out["port"][2] == ("raised", "NornicError")
