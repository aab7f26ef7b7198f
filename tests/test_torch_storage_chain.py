"""The port's storage chain (``nornicdb_tpu_torch.storage``): the engines,
the async write-behind, namespaces, the schema manager, import/export and
``open_storage``.

The engine-level cases of ``tests/test_storage.py`` and
``tests/test_storage_unit_depth.py`` run against the port unchanged but for
their imports (the ``open_db`` cases wait for the port's ``db.py``). Then
``open_storage`` with each of its flags, the async flush's trace hand-off
(``TestAsyncFlushTrace`` of ``tests/test_telemetry.py``), and the same
seeded op sequence through both packages' chains, compared entity by
entity, with the event sequences the search service and the adjacency
snapshot consume.
"""

import os
import threading
import time

import numpy as np
import pytest

from nornicdb_tpu_torch.errors import (
    AlreadyExistsError,
    ConstraintViolationError,
    NornicError,
    NotFoundError,
)
from nornicdb_tpu_torch.storage import (
    WAL,
    AsyncEngine,
    MemoryEngine,
    NamespacedEngine,
    Node,
    Edge,
    SchemaManager,
    WALEngine,
    open_storage,
)
from nornicdb_tpu_torch.storage.segment import SegmentEngine


# ---- cases of tests/test_storage.py, against the port
class TestMemoryEngine:
    def test_node_crud(self):
        eng = MemoryEngine()
        n = eng.create_node(Node(id="a", labels=["Person"], properties={"name": "Ada"}))
        assert n.id == "a"
        got = eng.get_node("a")
        assert got.properties["name"] == "Ada"
        got.properties["name"] = "Grace"
        eng.update_node(got)
        assert eng.get_node("a").properties["name"] == "Grace"
        eng.delete_node("a")
        with pytest.raises(NotFoundError):
            eng.get_node("a")

    def test_duplicate_create_raises(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a"))
        with pytest.raises(AlreadyExistsError):
            eng.create_node(Node(id="a"))

    def test_label_index_tracks_updates(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a", labels=["Person"]))
        n = eng.get_node("a")
        n.labels = ["Robot"]
        eng.update_node(n)
        assert eng.get_nodes_by_label("Person") == []
        assert [x.id for x in eng.get_nodes_by_label("Robot")] == ["a"]

    def test_edges_and_degree(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a"))
        eng.create_node(Node(id="b"))
        e = eng.create_edge(Edge(id="e1", start_node="a", end_node="b", type="KNOWS"))
        assert e.type == "KNOWS"
        assert [x.id for x in eng.get_outgoing_edges("a")] == ["e1"]
        assert [x.id for x in eng.get_incoming_edges("b")] == ["e1"]
        assert eng.degree("a") == 1
        assert eng.degree("a", "in") == 0
        assert [x.id for x in eng.get_edges_by_type("KNOWS")] == ["e1"]

    def test_edge_requires_endpoints(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a"))
        with pytest.raises(NotFoundError):
            eng.create_edge(Edge(start_node="a", end_node="missing"))

    def test_delete_node_cascades_edges(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a"))
        eng.create_node(Node(id="b"))
        eng.create_edge(Edge(id="e1", start_node="a", end_node="b"))
        eng.delete_node("b")
        assert eng.edge_count() == 0
        assert eng.get_outgoing_edges("a") == []

    def test_events_fire(self):
        eng = MemoryEngine()
        events = []
        eng.on_event(lambda kind, ent: events.append(kind))
        eng.create_node(Node(id="a"))
        eng.create_node(Node(id="b"))
        eng.create_edge(Edge(id="e", start_node="a", end_node="b"))
        eng.delete_node("a")
        assert events == [
            "node_created",
            "node_created",
            "edge_created",
            "edge_deleted",
            "node_deleted",
        ]

    def test_copy_isolation(self):
        eng = MemoryEngine()
        eng.create_node(Node(id="a", properties={"x": 1}))
        got = eng.get_node("a")
        got.properties["x"] = 99
        assert eng.get_node("a").properties["x"] == 1

    def test_embedding_roundtrip(self):
        eng = MemoryEngine()
        v = np.arange(4, dtype=np.float32)
        eng.create_node(Node(id="a", embedding=v, named_embeddings={"alt": v * 2}))
        got = eng.get_node("a")
        np.testing.assert_array_equal(got.embedding, v)
        np.testing.assert_array_equal(got.named_embeddings["alt"], v * 2)

    def test_pending_embed_fifo(self):
        eng = MemoryEngine()
        for i in "abc":
            eng.create_node(Node(id=i))
            eng.mark_pending_embed(i)
        assert eng.pending_embed_ids() == ["a", "b", "c"]
        assert eng.pending_embed_ids(limit=2) == ["a", "b"]
        eng.unmark_pending_embed("b")
        assert eng.pending_embed_ids() == ["a", "c"]


# ---------------------------------------------------------------- WAL
class TestWAL:
    def test_append_and_replay(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        weng.create_node(Node(id="a", properties={"k": 1}))
        weng.create_node(Node(id="b"))
        weng.create_edge(Edge(id="e", start_node="a", end_node="b"))
        weng.delete_node("b")
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        n = wal2.recover(fresh)
        assert n == 4
        assert fresh.node_count() == 1
        assert fresh.get_node("a").properties["k"] == 1

    def test_snapshot_truncate_recover(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        for i in range(5):
            weng.create_node(Node(id=f"n{i}"))
        weng.compact()
        weng.create_node(Node(id="after"))
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)
        assert fresh.node_count() == 6
        assert fresh.get_node("after")

    def test_torn_tail_is_truncated(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        weng.create_node(Node(id="good"))
        weng.create_node(Node(id="torn"))
        wal.close()
        # chop bytes off the tail to simulate a crash mid-write
        path = tmp_path / "wal" / "wal.log"
        raw = path.read_bytes()
        path.write_bytes(raw[:-12])  # > max padding (7), so the footer is torn
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)
        assert fresh.node_count() == 1
        assert fresh.get_node("good")

    def test_corrupt_payload_stops_replay(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        weng.create_node(Node(id="a"))
        weng.create_node(Node(id="b"))
        wal.close()
        path = tmp_path / "wal" / "wal.log"
        raw = bytearray(path.read_bytes())
        # flip a byte inside the second record's payload
        raw[len(raw) // 2 + 10] ^= 0xFF
        path.write_bytes(bytes(raw))
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)
        assert fresh.node_count() <= 1

    def test_incomplete_transaction_undone(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        weng.create_node(Node(id="outside"))
        weng.tx_begin("tx1")
        weng.create_node(Node(id="in-tx"))
        # crash before commit: recovery must drop the tx ops
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)
        assert fresh.node_count() == 1
        assert fresh.get_node("outside")
        with pytest.raises(NotFoundError):
            fresh.get_node("in-tx")

    def test_committed_transaction_replayed(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        weng = WALEngine(MemoryEngine(), wal)
        weng.tx_begin("tx1")
        weng.create_node(Node(id="a"))
        weng.tx_commit("tx1")
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)
        assert fresh.get_node("a")


# ---------------------------------------------------------------- async
class TestAsyncEngine:
    def test_read_your_writes(self):
        eng = AsyncEngine(MemoryEngine(), flush_interval=10)  # no auto flush
        eng.create_node(Node(id="a", properties={"v": 1}))
        assert eng.get_node("a").properties["v"] == 1
        eng.delete_node("a")
        with pytest.raises(NotFoundError):
            eng.get_node("a")
        eng.close()

    def test_count_includes_unflushed(self):
        base = MemoryEngine()
        eng = AsyncEngine(base, flush_interval=10)
        for i in range(5):
            eng.create_node(Node(id=f"n{i}"))
        assert eng.node_count() == 5  # overlay-aware (ref async_count_bug_test)
        eng.flush()
        assert base.node_count() == 5
        assert eng.node_count() == 5
        eng.close()

    def test_create_delete_before_flush_cancels(self):
        base = MemoryEngine()
        eng = AsyncEngine(base, flush_interval=10)
        eng.create_node(Node(id="x"))
        eng.delete_node("x")
        eng.flush()
        assert base.node_count() == 0
        assert eng.node_count() == 0
        eng.close()

    def test_concurrent_create_and_count(self):
        # ref: async_engine_count_flush_race_test.go
        eng = AsyncEngine(MemoryEngine(), flush_interval=0.001)
        errs = []

        def writer(start):
            try:
                for i in range(50):
                    eng.create_node(Node(id=f"w{start}-{i}"))
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        eng.flush()
        assert not errs
        assert eng.node_count() == 200
        eng.close()

    def test_edge_across_overlay_nodes(self):
        eng = AsyncEngine(MemoryEngine(), flush_interval=10)
        eng.create_node(Node(id="a"))
        eng.create_node(Node(id="b"))
        eng.create_edge(Edge(id="e", start_node="a", end_node="b"))
        eng.flush()
        assert eng.get_edge("e").start_node == "a"
        eng.close()


# ---------------------------------------------------------------- namespaced
class TestNamespacedEngine:
    def test_isolation_between_namespaces(self):
        base = MemoryEngine()
        db1 = NamespacedEngine(base, "db1")
        db2 = NamespacedEngine(base, "db2")
        db1.create_node(Node(id="a", labels=["X"]))
        db2.create_node(Node(id="a", labels=["X"]))  # same bare id, no clash
        assert db1.get_node("a").id == "a"
        assert db1.node_count() == 1
        assert db2.node_count() == 1
        assert base.node_count() == 2
        assert {n.id for n in base.all_nodes()} == {"db1:a", "db2:a"}
        assert [n.id for n in db1.get_nodes_by_label("X")] == ["a"]

    def test_edges_prefixed(self):
        base = MemoryEngine()
        db1 = NamespacedEngine(base, "db1")
        db1.create_node(Node(id="a"))
        db1.create_node(Node(id="b"))
        db1.create_edge(Edge(id="e", start_node="a", end_node="b"))
        e = db1.get_edge("e")
        assert (e.start_node, e.end_node) == ("a", "b")
        assert base.get_edge("db1:e").start_node == "db1:a"

    def test_events_scoped_and_stripped(self):
        base = MemoryEngine()
        db1 = NamespacedEngine(base, "db1")
        db2 = NamespacedEngine(base, "db2")
        seen1, seen2 = [], []
        db1.on_event(lambda k, e: seen1.append(e.id))
        db2.on_event(lambda k, e: seen2.append(e.id))
        db1.create_node(Node(id="a"))
        assert seen1 == ["a"]
        assert seen2 == []


# ---------------------------------------------------------------- schema
class TestSchema:
    def test_unique_constraint(self):
        eng = MemoryEngine()
        schema = SchemaManager()
        schema.attach(eng)
        schema.create_constraint("uq_email", "Person", ["email"])
        n1 = Node(id="a", labels=["Person"], properties={"email": "x@y.z"})
        schema.check_unique(n1)
        eng.create_node(n1)
        dup = Node(id="b", labels=["Person"], properties={"email": "x@y.z"})
        with pytest.raises(ConstraintViolationError):
            schema.check_unique(dup)

    def test_property_index_lookup(self):
        eng = MemoryEngine()
        schema = SchemaManager()
        schema.attach(eng)
        schema.create_index("idx_name", "property", "Person", ["name"])
        eng.create_node(Node(id="a", labels=["Person"], properties={"name": "Ada"}))
        eng.create_node(Node(id="b", labels=["Person"], properties={"name": "Bob"}))
        assert schema.lookup("Person", ["name"], ["Ada"]) == {"a"}
        # update moves index entry
        n = eng.get_node("a")
        n.properties["name"] = "Ada2"
        eng.update_node(n)
        assert schema.lookup("Person", ["name"], ["Ada"]) == set()
        assert schema.lookup("Person", ["name"], ["Ada2"]) == {"a"}
        eng.delete_node("b")
        assert schema.lookup("Person", ["name"], ["Bob"]) == set()

    def test_no_index_returns_none(self):
        schema = SchemaManager()
        assert schema.lookup("Person", ["name"], ["Ada"]) is None


# ---------------------------------------------------------------- full chain
class TestOpenStorage:
    def test_memory_chain(self):
        eng = open_storage("")
        eng.create_node(Node(id="a"))
        assert eng.node_count() == 1
        eng.close()

    def test_durable_chain_survives_reopen(self, tmp_path):
        d = str(tmp_path / "data")
        eng = open_storage(d)
        eng.create_node(Node(id="a", properties={"v": 42}))
        eng.create_node(Node(id="b"))
        eng.create_edge(Edge(id="e", start_node="a", end_node="b"))
        eng.close()
        eng2 = open_storage(d)
        assert eng2.node_count() == 2
        assert eng2.get_node("a").properties["v"] == 42
        assert eng2.get_edge("e").end_node == "b"
        eng2.close()


class TestWALCompactRace:
    """Advisor round-1 finding: compact() snapshotted + truncated without
    excluding concurrent appends — a write landing between the engine dump
    and the truncate was erased from the log yet absent from the snapshot."""

    def test_writes_during_compaction_survive_recovery(self, tmp_path):
        import threading as _t

        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        created = []
        stop = _t.Event()

        def writer(tag):
            i = 0
            while not stop.is_set():
                nid = f"{tag}-{i}"
                weng.create_node(Node(id=nid))
                created.append(nid)
                i += 1

        threads = [_t.Thread(target=writer, args=(t,)) for t in ("a", "b", "c")]
        for t in threads:
            t.start()
        # hammer compaction while writes stream in
        for _ in range(25):
            weng.compact()
        stop.set()
        for t in threads:
            t.join()
        weng.compact()  # final snapshot includes the tail
        wal.close()

        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)  # loads snapshot + replays tail
        # every acked write must be present after recovery
        assert fresh.node_count() == len(created)
        for nid in created[:: max(1, len(created) // 50)]:
            assert fresh.get_node(nid)


class TestWALCompactOpenTx:
    def test_compact_deferred_during_open_transaction(self, tmp_path):
        """A snapshot taken mid-transaction would bake uncommitted ops into
        durable state while truncating their txid records — recovery could
        then never undo the incomplete tx."""
        wal = WAL(str(tmp_path / "wal"))
        eng = MemoryEngine()
        weng = WALEngine(eng, wal)
        weng.create_node(Node(id="committed"))
        weng.tx_begin("t1")
        weng.create_node(Node(id="uncommitted"))
        weng.compact()  # must be a no-op while t1 is open
        wal.close()  # crash before commit

        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        wal2.recover(fresh)
        assert fresh.get_node("committed")
        # the incomplete tx's write is undone by recovery, not baked in
        with pytest.raises(Exception):
            fresh.get_node("uncommitted")


class TestWALSeqMonotonicAcrossRestart:
    def test_writes_after_compact_and_restart_survive(self, tmp_path):
        """seq must be reseeded from the snapshot: compact() empties the log,
        so a restarted WAL scanning only the log restarts seq at 0 and
        recovery's `seq > snap_seq` filter drops all post-restart writes."""
        wal = WAL(str(tmp_path / "wal"))
        weng = WALEngine(MemoryEngine(), wal)
        for i in range(5):
            weng.create_node(Node(id=f"pre{i}"))
        weng.compact()
        wal.close()

        # restart: recover then keep writing through a fresh WAL
        wal2 = WAL(str(tmp_path / "wal"))
        eng2 = MemoryEngine()
        wal2.recover(eng2)
        weng2 = WALEngine(eng2, wal2)
        weng2.create_node(Node(id="post-restart"))
        wal2.close()

        wal3 = WAL(str(tmp_path / "wal"))
        eng3 = MemoryEngine()
        wal3.recover(eng3)
        assert eng3.node_count() == 6
        assert eng3.get_node("post-restart")


# ---- cases of tests/test_storage_unit_depth.py, against the port
@pytest.fixture(params=["memory", "segment"])
def engine(request, tmp_path):
    if request.param == "memory":
        eng = MemoryEngine()
    else:
        eng = SegmentEngine(str(tmp_path / "seg"))
    yield eng
    eng.close()


def _mk_nodes(engine, *ids, labels=()):
    out = []
    for i in ids:
        out.append(engine.create_node(Node(id=i, labels=list(labels))))
    return out


# ------------------------------------------------------------- node CRUD
class TestCreateNode:
    def test_success_stores_labels_and_properties(self, engine):
        engine.create_node(Node(id="node-1", labels=["Person", "Employee"],
                                properties={"name": "Alice", "age": 30}))
        stored = engine.get_node("node-1")
        assert stored.labels == ["Person", "Employee"]
        assert stored.properties == {"name": "Alice", "age": 30}

    def test_duplicate_id_raises(self, engine):
        engine.create_node(Node(id="node-1"))
        with pytest.raises(AlreadyExistsError):
            engine.create_node(Node(id="node-1"))

    def test_deep_copy_prevents_caller_mutation(self, engine):
        props = {"key": "original"}
        n = Node(id="node-1", properties=props)
        engine.create_node(n)
        props["key"] = "mutated"
        n.properties["new"] = "value"
        n.labels.append("Sneaky")
        stored = engine.get_node("node-1")
        assert stored.properties.get("key") == "original"
        assert "new" not in stored.properties
        assert stored.labels == []

    def test_returned_node_is_isolated(self, engine):
        created = engine.create_node(Node(id="node-1",
                                          properties={"k": "v"}))
        created.properties["k"] = "tampered"
        assert engine.get_node("node-1").properties["k"] == "v"


class TestGetNode:
    def test_missing_raises_not_found(self, engine):
        with pytest.raises(NotFoundError):
            engine.get_node("nonexistent")

    def test_returned_copy_is_isolated(self, engine):
        engine.create_node(Node(id="node-1", properties={"a": 1}))
        got = engine.get_node("node-1")
        got.properties["a"] = 999
        assert engine.get_node("node-1").properties["a"] == 1

    def test_embedding_copy_is_isolated(self, engine):
        engine.create_node(Node(
            id="node-1", embedding=np.asarray([1.0, 2.0], np.float32)))
        got = engine.get_node("node-1")
        got.embedding[0] = -5.0
        assert engine.get_node("node-1").embedding[0] == 1.0

    def test_named_embeddings_copy_is_isolated(self, engine):
        """ref: TestMemoryEngine_CopyNodeWithNamedEmbeddings"""
        engine.create_node(Node(
            id="node-1",
            named_embeddings={"title": np.asarray([0.5], np.float32)},
            chunk_embeddings=[np.asarray([1.5], np.float32)]))
        got = engine.get_node("node-1")
        got.named_embeddings["title"][0] = 9.0
        got.chunk_embeddings[0][0] = 9.0
        fresh = engine.get_node("node-1")
        assert fresh.named_embeddings["title"][0] == 0.5
        assert fresh.chunk_embeddings[0][0] == 1.5


class TestUpdateNode:
    def test_missing_raises_not_found(self, engine):
        with pytest.raises(NotFoundError):
            engine.update_node(Node(id="nonexistent"))

    def test_preserves_created_at_bumps_updated_at(self, engine):
        created = engine.create_node(Node(id="node-1"))
        updated = engine.update_node(Node(id="node-1",
                                          properties={"v": 2}))
        assert updated.created_at == created.created_at
        assert updated.updated_at >= created.updated_at
        assert engine.get_node("node-1").properties == {"v": 2}

    def test_label_change_reindexes(self, engine):
        engine.create_node(Node(id="node-1", labels=["Old"]))
        engine.update_node(Node(id="node-1", labels=["New"]))
        assert engine.get_nodes_by_label("Old") == []
        assert [n.id for n in engine.get_nodes_by_label("New")] == ["node-1"]

    def test_replaces_properties_wholesale(self, engine):
        engine.create_node(Node(id="node-1", properties={"a": 1, "b": 2}))
        engine.update_node(Node(id="node-1", properties={"a": 10}))
        assert engine.get_node("node-1").properties == {"a": 10}


class TestDeleteNode:
    def test_missing_raises_not_found(self, engine):
        with pytest.raises(NotFoundError):
            engine.delete_node("nonexistent")

    def test_removes_from_label_index(self, engine):
        engine.create_node(Node(id="node-1", labels=["TestLabel"]))
        engine.delete_node("node-1")
        assert engine.get_nodes_by_label("TestLabel") == []

    @pytest.mark.parametrize("victim", ["source", "target"])
    def test_cascades_edges_both_directions(self, engine, victim):
        _mk_nodes(engine, "source", "target")
        engine.create_edge(Edge(id="edge-1", start_node="source",
                                end_node="target", type="KNOWS"))
        engine.delete_node(victim)
        with pytest.raises(NotFoundError):
            engine.get_edge("edge-1")
        assert engine.edge_count() == 0
        survivor = "target" if victim == "source" else "source"
        assert engine.degree(survivor) == 0


# ------------------------------------------------------------- edge CRUD
class TestCreateEdge:
    def test_success_and_adjacency(self, engine):
        _mk_nodes(engine, "a", "b")
        engine.create_edge(Edge(id="e1", start_node="a", end_node="b",
                                type="KNOWS", properties={"w": 1.5}))
        stored = engine.get_edge("e1")
        assert stored.type == "KNOWS"
        assert stored.properties == {"w": 1.5}
        assert [e.id for e in engine.get_outgoing_edges("a")] == ["e1"]
        assert [e.id for e in engine.get_incoming_edges("b")] == ["e1"]

    def test_missing_endpoints_raise(self, engine):
        engine.create_node(Node(id="a"))
        with pytest.raises(NotFoundError):
            engine.create_edge(Edge(id="e1", start_node="a",
                                    end_node="ghost", type="T"))
        with pytest.raises(NotFoundError):
            engine.create_edge(Edge(id="e2", start_node="ghost",
                                    end_node="a", type="T"))
        assert engine.edge_count() == 0

    def test_duplicate_id_raises(self, engine):
        _mk_nodes(engine, "a", "b")
        engine.create_edge(Edge(id="e1", start_node="a", end_node="b",
                                type="T"))
        with pytest.raises(AlreadyExistsError):
            engine.create_edge(Edge(id="e1", start_node="a", end_node="b",
                                    type="T"))

    def test_self_loop_counts_in_and_out(self, engine):
        engine.create_node(Node(id="a"))
        engine.create_edge(Edge(id="loop", start_node="a", end_node="a",
                                type="SELF"))
        assert [e.id for e in engine.get_outgoing_edges("a")] == ["loop"]
        assert [e.id for e in engine.get_incoming_edges("a")] == ["loop"]


class TestUpdateEdge:
    def test_missing_raises(self, engine):
        with pytest.raises(NotFoundError):
            engine.update_edge(Edge(id="ghost", start_node="a",
                                    end_node="b", type="T"))

    def test_type_change_reindexes(self, engine):
        _mk_nodes(engine, "a", "b")
        engine.create_edge(Edge(id="e1", start_node="a", end_node="b",
                                type="OLD"))
        engine.update_edge(Edge(id="e1", start_node="a", end_node="b",
                                type="NEW"))
        assert engine.get_edges_by_type("OLD") == []
        assert [e.id for e in engine.get_edges_by_type("NEW")] == ["e1"]

    def test_preserves_created_at(self, engine):
        _mk_nodes(engine, "a", "b")
        created = engine.create_edge(Edge(id="e1", start_node="a",
                                          end_node="b", type="T"))
        updated = engine.update_edge(Edge(id="e1", start_node="a",
                                          end_node="b", type="T",
                                          properties={"x": 1}))
        assert updated.created_at == created.created_at


class TestDeleteEdge:
    def test_missing_raises(self, engine):
        with pytest.raises(NotFoundError):
            engine.delete_edge("ghost")

    def test_clears_adjacency_and_type_index(self, engine):
        _mk_nodes(engine, "a", "b")
        engine.create_edge(Edge(id="e1", start_node="a", end_node="b",
                                type="T"))
        engine.delete_edge("e1")
        assert engine.get_outgoing_edges("a") == []
        assert engine.get_incoming_edges("b") == []
        assert engine.get_edges_by_type("T") == []
        assert engine.degree("a") == 0
        # endpoints survive
        assert engine.get_node("a").id == "a"


# ----------------------------------------------------- queries and counts
class TestLabelAndTypeQueries:
    def test_get_nodes_by_label_multiple(self, engine):
        _mk_nodes(engine, "p1", "p2", labels=["Person"])
        _mk_nodes(engine, "c1", labels=["City"])
        assert sorted(n.id for n in engine.get_nodes_by_label("Person")) == \
            ["p1", "p2"]
        assert engine.get_nodes_by_label("Ghost") == []
        assert engine.count_nodes_by_label("Person") == 2
        assert engine.count_nodes_by_label("Ghost") == 0

    def test_edges_between_and_by_type(self, engine):
        _mk_nodes(engine, "a", "b", "c")
        engine.create_edge(Edge(id="ab", start_node="a", end_node="b",
                                type="KNOWS"))
        engine.create_edge(Edge(id="ac", start_node="a", end_node="c",
                                type="KNOWS"))
        engine.create_edge(Edge(id="ba", start_node="b", end_node="a",
                                type="LIKES"))
        between = [e.id for e in engine.get_outgoing_edges("a")
                   if e.end_node == "b"]
        assert between == ["ab"]
        assert sorted(e.id for e in engine.get_edges_by_type("KNOWS")) == \
            ["ab", "ac"]
        assert engine.count_edges_by_type("KNOWS") == 2
        assert engine.count_edges_by_type("LIKES") == 1

    def test_degree_directions(self, engine):
        """ref: TestGetInDegree / TestGetOutDegree"""
        _mk_nodes(engine, "hub", "x", "y", "z")
        engine.create_edge(Edge(id="e1", start_node="hub", end_node="x",
                                type="T"))
        engine.create_edge(Edge(id="e2", start_node="hub", end_node="y",
                                type="T"))
        engine.create_edge(Edge(id="e3", start_node="z", end_node="hub",
                                type="T"))
        assert engine.degree("hub", "out") == 2
        assert engine.degree("hub", "in") == 1
        assert engine.degree("hub") == 3
        assert engine.degree("x", "in") == 1
        assert engine.degree("ghost-node", "both") == 0


class TestBulkAndCounts:
    def test_batch_create_nodes_and_counts(self, engine):
        created = engine.batch_create_nodes(
            [Node(id=f"n{i}", labels=["Bulk"]) for i in range(25)])
        assert len(created) == 25
        assert engine.node_count() == 25
        assert engine.count_nodes_by_label("Bulk") == 25

    def test_batch_get_preserves_order_skips_missing(self, engine):
        _mk_nodes(engine, "a", "b", "c")
        got = engine.batch_get_nodes(["c", "ghost", "a"])
        assert [n.id for n in got] == ["c", "a"]

    def test_batch_create_edges(self, engine):
        _mk_nodes(engine, *[f"n{i}" for i in range(5)])
        edges = [Edge(id=f"e{i}", start_node=f"n{i}",
                      end_node=f"n{(i + 1) % 5}", type="RING")
                 for i in range(5)]
        assert len(engine.batch_create_edges(edges)) == 5
        assert engine.edge_count() == 5

    def test_all_nodes_snapshot_is_stable_under_mutation(self, engine):
        _mk_nodes(engine, *[f"n{i}" for i in range(10)])
        it = engine.all_nodes()
        engine.delete_node("n0")
        assert len(list(it)) == 10  # snapshot taken at call time

    def test_all_edges_snapshot_is_stable_under_mutation(self, engine):
        _mk_nodes(engine, *[f"n{i}" for i in range(6)])
        for i in range(5):
            engine.create_edge(Edge(id=f"e{i}", start_node=f"n{i}",
                                    end_node=f"n{i + 1}", type="R"))
        it = engine.all_edges()
        engine.delete_edge("e0")
        assert len(list(it)) == 5  # snapshot taken at call time

    def test_counts_track_deletes(self, engine):
        _mk_nodes(engine, "a", "b")
        engine.create_edge(Edge(id="e1", start_node="a", end_node="b",
                                type="T"))
        assert (engine.node_count(), engine.edge_count()) == (2, 1)
        engine.delete_edge("e1")
        engine.delete_node("a")
        assert (engine.node_count(), engine.edge_count()) == (1, 0)


# ----------------------------------------------------------- concurrency
class TestConcurrency:
    def test_parallel_creates_all_land(self, engine):
        """ref: TestMemoryEngine_Concurrency — N writers, no lost writes."""
        errs = []

        def writer(base):
            try:
                for i in range(20):
                    engine.create_node(Node(id=f"w{base}-n{i}"))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert engine.node_count() == 160

    def test_parallel_read_write_mix(self, engine):
        _mk_nodes(engine, *[f"seed{i}" for i in range(10)])
        stop = threading.Event()
        errs = []

        def reader():
            while not stop.is_set():
                try:
                    for n in engine.all_nodes():
                        _ = n.id
                    engine.node_count()
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
                    return

        r = threading.Thread(target=reader)
        r.start()
        try:
            for i in range(50):
                engine.create_node(Node(id=f"rw{i}", labels=["RW"]))
                if i % 5 == 0:
                    engine.delete_node(f"rw{i}")
        finally:
            stop.set()
            r.join()
        assert not errs
        assert engine.count_nodes_by_label("RW") == 40


# ---- the async flush's trace hand-off (TestAsyncFlushTrace of
# tests/test_telemetry.py), against the port's tracer
class TestAsyncFlushTrace:
    def test_background_flush_adopts_leader_trace(self):
        from nornicdb_tpu_torch.telemetry import tracer

        eng = AsyncEngine(MemoryEngine(), flush_interval=0.01)
        try:
            with tracer.start_trace("write.request") as root:
                eng.create_node(Node(id="af1", labels=["T"]))
            # the BACKGROUND loop drains the overlay; the leader's context
            # was captured at write time, so storage.flush lands in this
            # trace even though the root already closed. The span is
            # recorded AFTER the overlay empties — poll for the span
            # itself, not for drain.
            deadline = time.monotonic() + 5.0
            names: set = set()
            while time.monotonic() < deadline:
                entry = tracer.trace(root.trace_id)
                names = {s["name"] for s in entry["spans"]} if entry else set()
                if "storage.flush" in names:
                    break
                time.sleep(0.01)
            assert "storage.flush" in names
        finally:
            eng.close()


# ---- against the JAX package
import json  # noqa: E402

import nornicdb_tpu.storage as jax_storage  # noqa: E402
import nornicdb_tpu.storage.io as jax_io  # noqa: E402
import nornicdb_tpu_torch.storage as port_storage  # noqa: E402
import nornicdb_tpu_torch.storage.io as port_io  # noqa: E402
from nornicdb_tpu_torch.storage import native  # noqa: E402
from nornicdb_tpu_torch.storage import segment as port_segment  # noqa: E402

PKGS = {"jax": jax_storage, "port": port_storage}


def _chain(eng) -> list[str]:
    out = []
    while eng is not None:
        out.append(type(eng).__name__)
        eng = getattr(eng, "base", None)
    return out


def _ops(seed: int, n: int = 40) -> list:
    """Seeded writes with fixed ids: creates, updates, edge and node
    deletes (a node delete cascades), a delete-then-recreate of one edge
    id, labels and types that move."""
    rng = np.random.default_rng(seed)
    ops = [("node", dict(id=f"n{i}", labels=[f"L{i % 3}"],
                         properties={"k": i},
                         embedding=rng.standard_normal(8).astype(np.float32),
                         created_at=1.0, updated_at=1.0, last_accessed=1.0))
           for i in range(n)]
    for j in range(2 * n):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        ops.append(("edge", dict(id=f"e{j}", start_node=f"n{a}",
                                 end_node=f"n{b}", type=f"T{j % 2}",
                                 created_at=1.0, updated_at=1.0)))
    for i in range(0, n, 6):
        ops.append(("update_node", dict(id=f"n{i}", labels=["Moved"],
                                        properties={"k": -i},
                                        created_at=1.0, updated_at=1.0,
                                        last_accessed=1.0)))
    for j in range(0, 2 * n, 7):
        ops.append(("delete_edge", f"e{j}"))
    ops.append(("edge", dict(id="e0", start_node="n1", end_node="n2",
                             type="BACK", created_at=1.0, updated_at=1.0)))
    ops.append(("update_edge", dict(id="e1", start_node="n0", end_node="n0",
                                    type="T9", created_at=1.0,
                                    updated_at=1.0)))
    ops.append(("delete_node", "n5"))
    ops.append(("delete_node", "n11"))
    return ops


def _run(pkg, eng, ops) -> list:
    events = []
    eng.on_event(lambda kind, ent: events.append((kind, ent.id)))
    for op, arg in ops:
        try:
            if op == "node":
                eng.create_node(pkg.Node(**arg))
            elif op == "edge":
                eng.create_edge(pkg.Edge(**arg))
            elif op == "update_node":
                eng.update_node(pkg.Node(**arg))
            elif op == "update_edge":
                eng.update_edge(pkg.Edge(**arg))
            else:
                getattr(eng, op)(arg)
        except Exception as e:  # the same refusals in both packages
            events.append(("refused", type(e).__name__))
    eng.flush()
    return events


def _entities(eng) -> tuple:
    nodes = sorted(
        (n.id, tuple(sorted(n.labels)), json.dumps(n.properties),
         None if n.embedding is None else n.embedding.tobytes())
        for n in eng.all_nodes())
    edges = sorted((e.id, e.start_node, e.end_node, e.type)
                   for e in eng.all_edges())
    return nodes, edges


class TestAgainstJax:
    @pytest.mark.parametrize("flags", [
        {},
        {"async_writes": False},
        {"wal_sync": True},
        {"async_writes": False, "wal_sync": True},
        {"auto_compact": True, "auto_compact_interval": 3600.0},
        {"flush_interval": 3600.0},
        {"engine": "segment"},
        {"engine": "segment", "async_writes": False},
    ], ids=["default", "sync_chain", "wal_sync", "sync_fsync",
            "auto_compact", "manual_flush", "segment", "segment_sync"])
    def test_open_storage_flags(self, tmp_path, flags):
        """Each flag assembles the JAX package's chain; the same writes
        give the same events and entities, and survive a reopen."""
        got = {}
        for name, pkg in PKGS.items():
            d = str(tmp_path / name)
            eng = pkg.open_storage(d, **flags)
            chain = _chain(eng)
            events = _run(pkg, eng, _ops(seed=5))
            state = _entities(eng)
            if flags.get("auto_compact"):
                wal_engine = eng.base if flags.get("async_writes", True) \
                    else eng
                assert wal_engine._compact_timer is not None
            eng.close()
            again = pkg.open_storage(d, **flags)
            assert _entities(again) == state
            again.close()
            got[name] = (chain, events, state)
        assert got["port"] == got["jax"]
        assert got["port"][0][-1] == ("SegmentEngine"
                                      if flags.get("engine") == "segment"
                                      else "MemoryEngine")

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_memory_chain_events_match(self, seed):
        """The write-time event contract of the async engine (creates and
        updates at write time, node deletes through the base, edge deletes
        at write time and suppressed at flush) gives the JAX sequence."""
        out = {}
        for name, pkg in PKGS.items():
            eng = pkg.open_storage("", flush_interval=3600.0)
            out[name] = (_run(pkg, eng, _ops(seed)), _entities(eng))
            eng.close()
        assert out["port"] == out["jax"]
        assert ("edge_deleted", "e0") in out["port"][0]

    def test_namespaced_engines_match(self):
        out = {}
        for name, pkg in PKGS.items():
            base = pkg.MemoryEngine()
            a = pkg.NamespacedEngine(base, "a")
            b = pkg.NamespacedEngine(base, "b")
            ev_a = _run(pkg, a, _ops(seed=3, n=12))
            ev_b = _run(pkg, b, _ops(seed=4, n=12))
            out[name] = (ev_a, ev_b, _entities(a), _entities(b),
                         _entities(base), a.node_count(), b.edge_count())
        assert out["port"] == out["jax"]
        assert out["port"][5] == 10  # n5 and n11 deleted

    def test_schema_manager_matches(self):
        out = {}
        for name, pkg in PKGS.items():
            eng = pkg.MemoryEngine()
            schema = pkg.SchemaManager()
            schema.attach(eng)
            schema.create_constraint("uniq", "P", ["email"])
            schema.create_index("by_name", pkg.INDEX_PROPERTY, "P", ["name"])
            rows = []
            for i in range(6):
                node = pkg.Node(id=f"p{i}", labels=["P"],
                                properties={"name": f"n{i % 3}",
                                            "email": f"e{i}"})
                schema.check_unique(node)
                eng.create_node(node)
            dup = pkg.Node(id="dup", labels=["P"],
                           properties={"email": "e2"})
            try:
                schema.check_unique(dup)
            except Exception as e:
                rows.append(type(e).__name__)
            for v in ("n0", "n1", "n9"):
                hit = schema.lookup("P", ["name"], [v])
                rows.append(None if hit is None else sorted(hit))
            rows.append(sorted(i.name for i in schema.list_indexes()))
            rows.append(sorted(c.name for c in schema.list_constraints()))
            out[name] = rows
        assert out["port"] == out["jax"]
        assert out["port"][0] == "ConstraintViolationError"

    def test_json_export_import_and_mimir_match(self, tmp_path):
        mimir = tmp_path / "export.jsonl"
        mimir.write_text("\n".join(json.dumps(o) for o in [
            {"type": "memory", "id": "m1", "content": "alpha",
             "metadata": {"src": "x"}, "importance": 0.5},
            {"type": "memory", "id": "m2", "text": "beta", "labels": ["K"]},
            {"type": "relation", "from": "m1", "to": "m2",
             "relation": "CITES"},
            {"type": "relation", "from": "m1", "to": "gone"},
        ]) + "\n")
        out = {}
        for name, (pkg, io) in {"jax": (jax_storage, jax_io),
                                "port": (port_storage, port_io)}.items():
            eng = pkg.MemoryEngine()
            _run(pkg, eng, _ops(seed=9, n=10))
            data = io.export_json(eng)
            eng2 = pkg.MemoryEngine()
            counts = io.import_json(eng2, data)
            eng3 = pkg.MemoryEngine()
            loaded = io.load_mimir(eng3, str(mimir))
            out[name] = (data, counts, io.export_json(eng2) == data, loaded,
                         sorted((n.id, tuple(n.labels),
                                 json.dumps(n.properties))
                                for n in eng3.all_nodes()),
                         [(e.start_node, e.end_node, e.type)
                          for e in eng3.all_edges()],
                         eng3.pending_embed_ids())
        assert out["port"] == out["jax"]
        assert out["port"][2] and out["port"][3] == (2, 1)


class TestSegmentWithoutCompiler:
    def test_segment_engine_raises_and_never_falls_back(self, tmp_path,
                                                        monkeypatch):
        """Without a working g++ ``engine="segment"`` raises NornicError,
        as the JAX package does; it never opens the WAL engine instead,
        and the failed build is reported."""
        monkeypatch.setattr(port_segment, "_lib", None)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
        monkeypatch.delenv("NORNICDB_NATIVE_DIR", raising=False)
        native.build_errors.pop("segstore", None)
        d = str(tmp_path / "db")
        with pytest.raises(NornicError, match="segment store unavailable"):
            open_storage(d, engine="segment")
        assert not os.path.exists(os.path.join(d, "wal"))
        assert "no-such-g++" in native.build_errors["segstore"]
        assert not list((tmp_path / "build").glob("*.so"))
