"""The port's ``DB`` facade (``nornicdb_tpu_torch.db``, ``open_db``) against
the JAX package's ``DB``.

The cases of ``tests/test_db_facade.py`` and ``tests/test_db_facade_depth.py``
(not the Cypher case) run in both packages, the port on the CPU
(``device="cpu"``), with the same ``HashEmbedder`` width. Then both
packages are held equal on the same seeded inputs: recall rankings and
scores, neighbour sets, the learning loop's inferred edges, the query
cache's invalidation. The ``open_db`` cases the storage slice left (the
encrypted WAL through the facade, the segment store and the encrypted
segment store through the facade) and the per-database limits and
isolation of ``tests/test_db_limits.py`` / ``tests/test_multidb.py``
through ``database_manager`` follow; a data directory written by one
package opens in the other (namespaced ids, ``_migrate_unprefixed``), and
``backup`` archives restore across packages. Last, the repaired search
wiring (the ``default`` vector space, ``cluster_assignments`` before the
first recluster) and the facade's device policy.
"""

import os
import time

import numpy as np
import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.db import Config as JConfig
from nornicdb_tpu.embed import CachedEmbedder as JCached
from nornicdb_tpu.embed import HashEmbedder as JHash
from nornicdb_tpu.errors import NotFoundError as JNotFound
from nornicdb_tpu_torch.db import Config as PConfig
from nornicdb_tpu_torch.embed import CachedEmbedder as PCached
from nornicdb_tpu_torch.embed import HashEmbedder as PHash
from nornicdb_tpu_torch.errors import DeviceUnavailable
from nornicdb_tpu_torch.errors import NotFoundError as PNotFound


class Pkg:
    def __init__(self, name, open_db, Config, Hash, Cached, NotFound):
        self.name, self._open = name, open_db
        self.Config, self.Hash, self.Cached = Config, Hash, Cached
        self.NotFound = NotFound

    def open(self, path: str = "", config=None):
        return self._open(path, config)


PKGS = {
    "jax": Pkg("jax", nornicdb_tpu.open_db, JConfig, JHash, JCached,
               JNotFound),
    "torch": Pkg("torch", lambda p, c: nornicdb_tpu_torch.open_db(
        p, c, device="cpu"), PConfig, PHash, PCached, PNotFound),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def db(pkg):
    d = pkg.open("")
    d.set_embedder(pkg.Hash(32))
    yield d
    d.close()


def _wait_drained(db, timeout: float = 10.0) -> None:
    deadline = time.time() + timeout
    while db.storage.pending_embed_ids() and time.time() < deadline:
        time.sleep(0.02)
    assert db.storage.pending_embed_ids() == []


# ---- cases of tests/test_db_facade.py, in both packages
class TestLearningLoop:
    def test_store_autoembed_recall(self, pkg):
        db = pkg.open("")
        db.set_embedder(pkg.Cached(pkg.Hash(64)))
        try:
            a = db.store("TPUs accelerate matrix multiplication")
            db.store("gardening requires regular watering")
            c = db.store("XLA compiles matrix programs for TPUs")
            _wait_drained(db)
            res = db.recall("TPU matrix compilation", limit=2)
            assert {res[0]["id"], res[1]["id"]} == {a.id, c.id}
        finally:
            db.close()

    def test_search_service_backfills_preexisting_nodes(self, pkg):
        db = pkg.open("")
        db.set_embedder(pkg.Hash(32))
        db.store("node before search service exists")
        db.process_pending_embeddings()
        assert len(db.recall("search service")) == 1
        db.close()

    def test_recall_reinforces_access(self, db):
        a = db.store("reinforced memory")
        db.process_pending_embeddings()
        db.recall("reinforced memory")
        assert db.storage.get_node(a.id).access_count >= 1

    def test_forget_removes_everywhere(self, db):
        a = db.store("soon forgotten")
        db.process_pending_embeddings()
        db.forget(a.id)
        assert db.recall("soon forgotten") == []

    def test_link_and_neighbors(self, db):
        a, b, c = db.store("node a"), db.store("node b"), db.store("node c")
        db.link(a.id, b.id, "KNOWS")
        db.link(b.id, c.id, "KNOWS")
        assert {n.id for n in db.neighbors(a.id, depth=1)} == {b.id}
        assert {n.id for n in db.neighbors(a.id, depth=2)} == {b.id, c.id}

    def test_durable_embedding_roundtrip(self, pkg, tmp_path):
        d = str(tmp_path / "db")
        db1 = pkg.open(d)
        db1.set_embedder(pkg.Hash(16))
        x = db1.store("persisted")
        db1.process_pending_embeddings()
        db1.close()
        db2 = pkg.open(d)
        node = db2.storage.get_node(x.id)
        assert node.embedding is not None and node.embedding.shape == (16,)
        db2.close()


# ---- cases of tests/test_db_facade_depth.py, in both packages
class TestStore:
    def test_defaults(self, db):
        n = db.store("Test content")
        assert n.id and n.labels == ["Memory"]
        assert n.properties["content"] == "Test content"
        assert n.memory_type == "semantic"
        assert n.decay_score == 1.0 and n.access_count == 0
        assert n.created_at > 0 and n.last_accessed > 0

    def test_explicit_memory_type(self, db):
        n = db.store("Important skill", memory_type="procedural")
        assert db.storage.get_node(n.id).memory_type == "procedural"

    def test_custom_labels_and_properties(self, db):
        n = db.store("Tagged content", labels=["Doc", "Tagged"],
                     properties={"source": "test-source", "custom": "value"})
        assert n.labels == ["Doc", "Tagged"]
        assert n.properties["source"] == "test-source"
        n2 = db.store("ignored", properties={"content": "explicit"})
        assert n2.properties["content"] == "explicit"

    def test_store_queues_embedding(self, db):
        n = db.store("embed me")
        assert n.id in db.storage.pending_embed_ids()
        db.process_pending_embeddings()
        assert db.storage.get_node(n.id).embedding is not None

    def test_explicit_node_id(self, db):
        assert db.store("with id", node_id="custom-id-1").id == "custom-id-1"
        assert db.storage.get_node("custom-id-1")


class TestRecallRememberTouch:
    def test_recall_returns_relevant_and_reinforces(self, db):
        a = db.store("norse mythology and ravens")
        db.store("cooking pasta recipes")
        db.process_pending_embeddings()
        results = db.recall("norse ravens", limit=5)
        assert results and results[0]["id"] == a.id
        assert db.storage.get_node(a.id).access_count >= 1

    def test_remember_fetches_and_reinforces(self, db):
        n = db.store("a fact")
        before = db.storage.get_node(n.id)
        time.sleep(0.01)
        got = db.remember(n.id)
        assert got.id == n.id
        assert got.access_count == before.access_count + 1
        assert got.last_accessed > before.last_accessed

    def test_remember_missing_raises(self, pkg, db):
        with pytest.raises(pkg.NotFound):
            db.remember("ghost")


class TestLink:
    def test_link_with_metadata(self, db):
        a, b = db.store("a"), db.store("b")
        e = db.link(a.id, b.id, "CAUSES", properties={"weight": 0.8},
                    confidence=0.7, auto_generated=True)
        stored = db.storage.get_edge(e.id)
        assert stored.type == "CAUSES" and stored.confidence == 0.7
        assert stored.auto_generated is True
        assert stored.properties["weight"] == 0.8

    def test_link_missing_endpoint_raises(self, pkg, db):
        a = db.store("a")
        with pytest.raises(pkg.NotFound):
            db.link(a.id, "ghost", "R")

    def test_default_relation_type(self, db):
        a, b = db.store("a"), db.store("b")
        assert db.link(a.id, b.id).type == "RELATED_TO"


class TestNeighbors:
    def test_depth_one_both_directions(self, db):
        center, out_n, in_n = db.store("c"), db.store("o"), db.store("i")
        db.link(center.id, out_n.id, "TO")
        db.link(in_n.id, center.id, "FROM")
        assert {n.id for n in db.neighbors(center.id)} == {out_n.id, in_n.id}

    def test_depth_two_bfs_no_revisit(self, db):
        a, b, c = db.store("a"), db.store("b"), db.store("c")
        db.link(a.id, b.id)
        db.link(b.id, c.id)
        db.link(c.id, a.id)
        assert {n.id for n in db.neighbors(a.id, depth=1)} == {b.id, c.id}
        assert {n.id for n in db.neighbors(a.id, depth=2)} == {b.id, c.id}

    def test_isolated_node_empty(self, db):
        assert db.neighbors(db.store("lonely").id) == []


class TestForget:
    def test_forget_cascades_and_removes_from_search(self, pkg, db):
        a, b = db.store("target phrase unique"), db.store("other")
        db.link(a.id, b.id)
        db.process_pending_embeddings()
        assert any(r["id"] == a.id for r in db.recall("target phrase"))
        db.forget(a.id)
        with pytest.raises(pkg.NotFound):
            db.storage.get_node(a.id)
        assert db.storage.edge_count() == 0
        assert all(r["id"] != a.id for r in db.recall("target phrase"))

    def test_forget_missing_raises(self, pkg, db):
        with pytest.raises(pkg.NotFound):
            db.forget("ghost")


class TestLifecycle:
    def test_context_manager_closes(self, pkg):
        with pkg.open("") as d:
            d.store("x")
        d.close()  # a second close is harmless

    def test_durable_open_close_reopen(self, pkg, tmp_path):
        p = str(tmp_path / "data")
        d = pkg.open(p)
        n = d.store("durable memory")
        d.flush()
        d.close()
        d2 = pkg.open(p)
        try:
            assert d2.storage.get_node(n.id).properties["content"] == \
                "durable memory"
            assert d2.wal_stats()["degraded"] is False
            assert d2.adjacency_stats() is None
        finally:
            d2.close()


class TestBackupRestore:
    def test_backup_restore_roundtrip(self, pkg, db, tmp_path):
        a = db.store("keep me", properties={"k": [1, 2]})
        b = db.store("and me")
        db.link(a.id, b.id, "R")
        db.process_pending_embeddings()
        path = db.backup(str(tmp_path / "bk.json.gz"))
        assert os.path.exists(path)
        fresh = pkg.open("")
        try:
            assert fresh.restore(path) == {"nodes": 2, "edges": 1}
            assert fresh.storage.node_count() == 2
            assert fresh.storage.edge_count() == 1
            restored = fresh.storage.get_node(a.id)
            assert restored.properties["k"] == [1, 2]
            assert np.allclose(restored.embedding,
                               db.storage.get_node(a.id).embedding)
        finally:
            fresh.close()


# ---- both packages on the same seeded inputs
WORDS = ("graph node edge vector search index memory storage engine query "
         "batch token device shard corpus embed serve latency").split()


def _texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(2, 9)))) + f" u{i}"
            for i in range(n)]


def _loaded(pkg, seed: int, n: int = 48, **cfg):
    db = pkg.open("", pkg.Config(**cfg))
    db.set_embedder(pkg.Hash(32))
    rng = np.random.default_rng(seed + 1)
    for i, t in enumerate(_texts(seed, n)):
        db.store(t, node_id=f"m{i}")
    for k in range(n):
        a, b = rng.integers(0, n, 2)
        if a != b:
            db.link(f"m{a}", f"m{b}", "NEAR")
    db.process_pending_embeddings()
    return db


@pytest.mark.parametrize("seed", [0, 1])
def test_recall_rankings_same(seed):
    dbs = [_loaded(PKGS[k], seed, inference_enabled=False)
           for k in ("jax", "torch")]
    try:
        rng = np.random.default_rng(seed + 2)
        queries = [" ".join(rng.choice(WORDS, 2)) for _ in range(8)]
        queries += [_texts(seed, 48)[i] for i in (0, 7, 30)]
        for q in queries:
            want, got = (d.recall(q, limit=5) for d in dbs)
            assert [r["id"] for r in got] == [r["id"] for r in want], q
            for g, w in zip(got, want):
                assert g["score"] == pytest.approx(w["score"], abs=1e-6)
        for nid in ("m0", "m5", "m11"):
            for depth in (1, 2):
                want, got = (sorted(n.id for n in d.neighbors(nid, depth))
                             for d in dbs)
                assert got == want
        counts = [sorted((n.id, n.access_count) for n in d.storage.all_nodes())
                  for d in dbs]
        assert counts[0] == counts[1]
    finally:
        for d in dbs:
            d.close()


def _learned(pkg, seed: int):
    """The learning loop at a small width: stores, the worker embeds,
    on_store suggests over the vector leg; one re-embed (the node marked
    pending again) observes each pair a second time."""
    db = pkg.open("", pkg.Config(similarity_threshold=0.5))
    db.set_embedder(pkg.Hash(32))
    texts = _texts(seed, 24)
    for i, t in enumerate(texts):
        db.store(t, node_id=f"m{i}")
    _wait_drained(db)
    for i in range(0, 24, 3):
        db.storage.mark_pending_embed(f"m{i}")
    _wait_drained(db)
    time.sleep(0.3)  # the last batch's on_embedded runs after the unmark
    edges = sorted((e.start_node, e.end_node, e.type, e.confidence,
                    e.properties["evidence_count"])
                   for e in db.storage.all_edges())
    stats = vars(db.inference.stats).copy()
    processed = db._embed_worker.stats.processed
    db.close()
    return edges, stats, processed


def test_learning_loop_same_edges():
    got = _learned(PKGS["torch"], 3)
    assert got == _learned(PKGS["jax"], 3)
    edges, stats, processed = got
    assert processed == 24 + 8
    assert edges and all(e[2] == "SIMILAR_TO" and e[4] == 2 for e in edges)
    assert stats["edges_created"] == len(edges)


def test_remember_drives_co_access_edges(pkg):
    db = pkg.open("")
    try:
        a, b = db.store("first"), db.store("second")
        for _ in range(4):
            db.remember(a.id)
            db.remember(b.id)
        edges = [e for e in db.storage.all_edges()
                 if e.type == "CO_ACCESSED_WITH"]
        assert len(edges) == 1 and edges[0].auto_generated
    finally:
        db.close()


def test_query_cache_invalidated_by_storage_events(pkg):
    db = pkg.open("")
    try:
        cache = db.query_cache
        cache.put("q1", None, [1], labels={"Doc"})
        cache.put("q2", None, [2], labels={"Other"})
        db.store("x", labels=["Doc"])
        assert cache.get("q1") is None and cache.get("q2") == [2]
        cache.put("q3", None, [3], labels={"Other"})
        a = db.store("y", labels=["Other"])
        b = db.store("z", labels=["Third"])
        cache.put("q4", None, [4], labels={"Third"})
        db.link(a.id, b.id)
        assert cache.get("q4") is None
        assert cache.stats.invalidations >= 3
    finally:
        db.close()


# ---- the open_db cases of the storage slice, in both packages
class TestEncryptedWALThroughFacade:
    @pytest.fixture(autouse=True)
    def _needs_cryptography(self):
        pytest.importorskip("cryptography")

    def test_roundtrip_and_ciphertext_on_disk(self, pkg, tmp_path):
        d = str(tmp_path / "enc")
        db = pkg.open(d, pkg.Config(encryption_passphrase="hunter2"))
        db.store("top secret payload contents")
        db.flush()
        db.close()
        raw = (tmp_path / "enc" / "wal" / "wal.log").read_bytes()
        snap = (tmp_path / "enc" / "wal" / "snapshot.json").read_bytes()
        assert b"top secret" not in raw and b"top secret" not in snap
        db2 = pkg.open(d, pkg.Config(encryption_passphrase="hunter2"))
        nodes = list(db2.storage.all_nodes())
        assert nodes and nodes[0].properties["content"].startswith(
            "top secret")
        db2.close()

    def test_wrong_passphrase_recovers_nothing(self, pkg, tmp_path):
        d = str(tmp_path / "enc2")
        db = pkg.open(d, pkg.Config(encryption_passphrase="right"))
        db.store("secret")
        db.flush()
        db.close()
        with pytest.raises(Exception):
            db2 = pkg.open(d, pkg.Config(encryption_passphrase="wrong"))
            try:
                assert db2.storage.node_count() == 0
                raise RuntimeError("decryption produced no data")
            finally:
                db2.close()


class TestSegmentThroughFacade:
    def test_full_stack_on_segment_engine(self, pkg, tmp_path):
        cfg = pkg.Config(storage_engine="segment")
        db = pkg.open(str(tmp_path / "segdb"), cfg)
        a = db.store("Oslo", labels=["City"], node_id="oslo")
        b = db.store("Bergen", labels=["City"], node_id="bergen")
        db.link(a.id, b.id, "ROAD")
        assert [n.id for n in db.neighbors("oslo")] == ["bergen"]
        db.close()
        db2 = pkg.open(str(tmp_path / "segdb"), cfg)
        assert db2.storage.node_count() == 2
        assert [e.type for e in db2.storage.get_outgoing_edges("oslo")] == [
            "ROAD"]
        assert db2.wal_stats() is None
        db2.close()

    def test_db_facade_with_encrypted_segment(self, pkg, tmp_path):
        pytest.importorskip("cryptography")
        d = str(tmp_path / "db")
        cfg = pkg.Config(storage_engine="segment",
                         encryption_passphrase="pp", embed_enabled=False)
        db = pkg.open(d, cfg)
        db.store("x", labels=["V"], properties={"name": "x"})
        db.flush()
        db.close()
        db2 = pkg.open(d, cfg)
        assert [n.properties["name"] for n in db2.storage.all_nodes()] == [
            "x"]
        db2.close()


# ---- tests/test_db_limits.py and tests/test_multidb.py through the facade
class TestDatabasesThroughFacade:
    def test_databases_isolated_from_the_default(self, pkg):
        db = pkg.open("")
        try:
            mgr = db.database_manager
            assert db.database_manager is mgr
            mgr.create_database("hr")
            hr = mgr.get_storage("hr")
            db.store("default memory", node_id="x")
            from_pkg = type(db.storage.get_node("x"))
            hr.create_node(from_pkg(id="x", properties={"content": "hr"}))
            assert db.storage.get_node("x").properties["content"] == \
                "default memory"
            assert hr.node_count() == 1 and db.storage.node_count() == 1
            assert "hr" in mgr.list_databases()
        finally:
            db.close()

    def test_node_cap_enforced(self, pkg):
        limits_cls = (nornicdb_tpu.multidb.DatabaseLimits
                      if pkg.name == "jax"
                      else nornicdb_tpu_torch.multidb.DatabaseLimits)
        db = pkg.open("")
        try:
            mgr = db.database_manager
            mgr.create_database("limited", limits=limits_cls(max_nodes=3))
            st = mgr.get_storage("limited")
            Node = type(db.store("probe"))
            for i in range(3):
                st.create_node(Node(id=f"n{i}"))
            with pytest.raises(Exception, match="limit"):
                st.create_node(Node(id="n99"))
        finally:
            db.close()

    def test_worker_embeds_every_namespace(self, pkg):
        db = pkg.open("")
        try:
            db.set_embedder(pkg.Hash(16))
            mgr = db.database_manager
            mgr.create_database("other")
            st = mgr.get_storage("other")
            Node = type(db.store("in default"))
            st.create_node(Node(id="o1", properties={"content": "in other"}))
            st.mark_pending_embed("o1")
            db.process_pending_embeddings()
            assert st.get_node("o1").embedding is not None
            # auto-TLP runs over the default database only
            assert db.inference.stats.suggestions == 0
        finally:
            db.close()


# ---- data directories and archives across packages
def _write(pkg, path: str) -> list:
    db = pkg.open(path)
    db.set_embedder(pkg.Hash(16))
    ids = [db.store(t, node_id=f"d{i}").id
           for i, t in enumerate(_texts(5, 12))]
    db.link("d0", "d1", "NEXT", confidence=0.5)
    db.link("d2", "d0", "NEXT")
    db.process_pending_embeddings()
    db.storage.mark_pending_embed("d3")
    db.flush()
    db.close()
    return ids


def _state(db) -> tuple:
    nodes = sorted((n.id, n.properties.get("content"), n.labels,
                    None if n.embedding is None else n.embedding.tobytes())
                   for n in db.storage.all_nodes())
    edges = sorted((e.id, e.start_node, e.end_node, e.type, e.confidence)
                   for e in db.storage.all_edges())
    return nodes, edges, sorted(db.storage.pending_embed_ids())


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_data_directory_across_packages(writer, reader, tmp_path):
    d = str(tmp_path / "db")
    _write(PKGS[writer], d)
    a = PKGS[writer].open(d)
    b = PKGS[reader].open(d)
    try:
        assert _state(b) == _state(a)
        base_ids = sorted(n.id for n in b._base_storage.all_nodes())
        assert base_ids and all(i.startswith("neo4j:") for i in base_ids)
        assert _state(b)[2] == ["d3"]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", sorted(PKGS))
def test_migrate_unprefixed_same(name, tmp_path):
    """A directory written before namespacing (bare ids through the bare
    storage chain) is re-keyed into the default namespace on open, the
    same way by both packages."""
    from nornicdb_tpu.storage import Edge as JEdge, Node as JNode
    from nornicdb_tpu.storage import open_storage as j_open

    out = {}
    for reader in ("jax", "torch"):
        d = str(tmp_path / reader)
        st = j_open(d) if name == "jax" else \
            nornicdb_tpu_torch.storage.open_storage(d)
        Node = JNode if name == "jax" else nornicdb_tpu_torch.storage.Node
        Edge = JEdge if name == "jax" else nornicdb_tpu_torch.storage.Edge
        for i in range(4):
            st.create_node(Node(id=f"b{i}", properties={"content": f"t{i}"}))
        st.create_edge(Edge(id="e0", start_node="b0", end_node="b1"))
        st.mark_pending_embed("b2")
        st.close()
        db = PKGS[reader].open(d)
        out[reader] = (_state(db), sorted(
            n.id for n in db._base_storage.all_nodes()),
            sorted(e.start_node for e in db._base_storage.all_edges()))
        db.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == [f"neo4j:b{i}" for i in range(4)]
    assert out["torch"][0][2] == ["b2"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_backup_restore_across_packages(writer, reader, tmp_path):
    src = PKGS[writer].open("")
    src.set_embedder(PKGS[writer].Hash(16))
    for i, t in enumerate(_texts(7, 10)):
        src.store(t, node_id=f"r{i}")
    src.link("r0", "r9", "R", properties={"w": 1.5})
    src.process_pending_embeddings()
    src.storage.mark_pending_embed("r4")
    path = src.backup(str(tmp_path / f"{writer}.json.gz"))
    dst = PKGS[reader].open("")
    try:
        assert dst.restore(path) == {"nodes": 10, "edges": 1}
        assert _state(dst) == _state(src)
        assert dst.storage.get_edge(
            dst.storage.get_outgoing_edges("r0")[0].id).properties == {
                "w": 1.5}
        assert dst.restore(path)["nodes"] == 0  # existing nodes skipped
    finally:
        src.close()
        dst.close()


# ---- the repaired search wiring
class TestSearchWiring:
    """Faults: the port's SearchService had no ``vectorspaces`` argument,
    so a DB could not register its ``default`` space, and its
    ``cluster_assignments`` started as None where the JAX one is {}."""

    def test_default_vector_space_registered(self, pkg, db):
        db.store("embedded text")
        db.process_pending_embeddings()
        assert db.search.vectorspaces is db.vectorspaces
        key = db.vectorspaces.get("default")
        assert key is not None and key.dims == 32
        assert key.canonical() == "default:32:cosine:tpu"

    def test_cluster_assignments_start_empty(self, pkg, db):
        assert db.search.cluster_assignments == {}
        from nornicdb_tpu_torch.search import SearchService

        assert SearchService(device="cpu").cluster_assignments == {}

    def test_cluster_integration_before_recluster(self, pkg):
        db = pkg.open("", pkg.Config(cluster_integration=True,
                                     topology_integration=True))
        try:
            a, b = db.store("a"), db.store("b")
            edge = db.inference.process_suggestion(a.id, b.id,
                                                   "SIMILAR_TO", 0.9)
            assert edge is None  # evidence 1 of 2
            edge = db.inference.process_suggestion(a.id, b.id,
                                                   "SIMILAR_TO", 0.9)
            assert edge is not None and 0.0 < edge.confidence <= 1.0
        finally:
            db.close()


# ---- the facade's device policy
class TestDevicePolicy:
    def test_cpu_only_when_named(self):
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            assert db.device.type == "cpu"
            db.set_embedder(PHash(8))
            db.store("x")
            db.process_pending_embeddings()
            assert db.search.device.type == "cpu"
            assert db.search.corpus().device.type == "cpu"
        finally:
            db.close()

    def test_decay_refused_until_ported(self):
        """Decay is no longer refused: the DB opens with the manager over
        its storage and its ticker running, and ``close`` stops the
        ticker. (The name dates from when the port refused decay, before
        ROADMAP A6c; a failure here means decay failed to open or stop.)"""
        db = nornicdb_tpu_torch.open_db("", PConfig(decay_enabled=True),
                                        device="cpu")
        try:
            assert db.decay.storage is db.storage
            assert db.decay._timer is not None and db.decay._timer.is_alive()
        finally:
            db.close()
        db.decay._timer.join(timeout=5)
        assert db.decay._stopped and not db.decay._timer.is_alive()

    def test_bad_checkpoint_falls_back_to_template(self, tmp_path,
                                                   monkeypatch):
        from nornicdb_tpu_torch.heimdall import TemplateGenerator
        from nornicdb_tpu_torch.telemetry.metrics import REGISTRY

        cell = REGISTRY._families["nornicdb_component_errors_total"].labels(
            "heimdall.checkpoint_load")
        before = cell.value
        for broken in ("missing", "config"):
            d = tmp_path / broken
            d.mkdir()
            if broken == "config":
                (d / "config.json").write_text("{not json")
            monkeypatch.setenv("NORNICDB_ASSISTANT_MODEL", str(d))
            db = nornicdb_tpu_torch.open_db("", device="cpu")
            try:
                assert isinstance(db.heimdall.generator, TemplateGenerator)
                assert db.genserve_engine() is None
            finally:
                db.close()
        assert cell.value == before + 2

    @pytest.mark.parametrize("error", [
        DeviceUnavailable("no card"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
    ])
    def test_device_errors_propagate_from_heimdall(self, tmp_path,
                                                   monkeypatch, error):
        """Where the JAX package would answer from the template, the port
        lets a dead card surface."""
        from nornicdb_tpu_torch.models import pretrain

        def loader(model_dir, device=None):
            raise error

        monkeypatch.setattr(pretrain, "load_generator", loader)
        monkeypatch.setenv("NORNICDB_ASSISTANT_MODEL", str(tmp_path))
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            with pytest.raises(type(error)):
                _ = db.heimdall
            assert db._heimdall is None
        finally:
            db.close()

    def test_checkpoint_mounted_through_the_engine(self, tmp_path,
                                                   monkeypatch):
        """NORNICDB_ASSISTANT_MODEL -> load_generator on the DB's device ->
        GenerationEngine + EngineGenerator; chat and graphrag() answer
        through it. ``GenServeConfig.enabled=False`` keeps the synchronous
        generator."""
        from nornicdb_tpu_torch import genserve
        from nornicdb_tpu_torch.config import GenServeConfig
        from nornicdb_tpu_torch.heimdall import EngineGenerator, QwenGenerator
        from nornicdb_tpu_torch.models import pretrain

        out = str(tmp_path / "ckpt")
        pretrain.train_assistant(out, steps=2, batch=2, seq_len=16,
                                 hidden=32, layers=1, device="cpu")
        monkeypatch.setenv("NORNICDB_ASSISTANT_MODEL", out)
        db = nornicdb_tpu_torch.open_db("", device="cpu")
        try:
            db.set_embedder(PHash(16))
            db.store("the capital of norway is oslo", node_id="n1")
            db.process_pending_embeddings()
            gen = db.heimdall.generator
            assert isinstance(gen, EngineGenerator)
            eng = db.genserve_engine()
            assert eng is gen.engine and eng.device.type == "cpu"
            reply = db.heimdall.chat([{"role": "user", "content": "hi"}],
                                     max_tokens=4)
            assert reply["choices"][0]["finish_reason"] == "stop"
            assert eng.stats.completed >= 1
            ans = db.graphrag().answer("capital of norway")
            assert "n1" in [s["id"] for s in ans["sources"]]
        finally:
            db.close()
        genserve.configure(GenServeConfig(enabled=False))
        try:
            db = nornicdb_tpu_torch.open_db("", device="cpu")
            assert isinstance(db.heimdall.generator, QwenGenerator)
            assert db.genserve_engine() is None
            db.close()
        finally:
            genserve.configure(None)
