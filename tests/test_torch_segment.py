"""The port's segment store (``nornicdb_tpu_torch.storage.segment``) and its
native WAL codec (``storage.native``), both built with ``g++`` from the
port's copies of ``native/segstore.cc`` and ``native/walcodec.cc``.

The engine-level cases of ``tests/test_segment.py`` (the ``open_db`` ones
wait for the port's ``db.py``) and the cases of ``tests/test_native.py``
run against the port unchanged but for their imports, with no skip: the
port needs a working compiler for these libraries and raises without one.
Then a segment directory written by either package reopens in the other,
plain and encrypted, and the port's libraries are checked to be its own
builds.
"""

import json
import os
import zlib

import numpy as np
import pytest

from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node, WALEngine
from nornicdb_tpu_torch.storage import native
from nornicdb_tpu_torch.storage.segment import (
    SegmentEngine,
    segment_store_available,
)
from nornicdb_tpu_torch.storage.wal import (
    _FOOTER,
    _HEADER,
    MAGIC,
    VERSION,
    WAL,
)


# ---- cases of tests/test_segment.py, against the port
class TestSegmentEngine:
    def test_crud_roundtrip(self, tmp_path):
        eng = SegmentEngine(str(tmp_path))
        eng.create_node(Node(id="a", labels=["X"], properties={"k": 1}))
        eng.create_node(Node(id="b"))
        eng.create_edge(Edge(id="e", start_node="a", end_node="b", type="R"))
        assert eng.get_node("a").properties["k"] == 1
        assert eng.node_count() == 2 and eng.edge_count() == 1
        assert [n.id for n in eng.get_nodes_by_label("X")] == ["a"]
        assert [e.id for e in eng.get_outgoing_edges("a")] == ["e"]
        with pytest.raises(AlreadyExistsError):
            eng.create_node(Node(id="a"))
        eng.close()

    def test_durability_across_reopen(self, tmp_path):
        eng = SegmentEngine(str(tmp_path))
        eng.create_node(Node(id="persist", properties={"v": 42}))
        eng.create_node(Node(id="other", labels=["L"]))
        eng.create_edge(Edge(id="e1", start_node="persist", end_node="other"))
        eng.delete_node("other")  # cascades e1
        eng.close()
        eng2 = SegmentEngine(str(tmp_path))
        assert eng2.node_count() == 1 and eng2.edge_count() == 0
        assert eng2.get_node("persist").properties["v"] == 42
        assert eng2.get_nodes_by_label("L") == []
        eng2.close()

    def test_update_and_label_index(self, tmp_path):
        eng = SegmentEngine(str(tmp_path))
        eng.create_node(Node(id="n", labels=["A"]))
        node = eng.get_node("n")
        node.labels = ["B"]
        eng.update_node(node)
        assert eng.get_nodes_by_label("A") == []
        assert [x.id for x in eng.get_nodes_by_label("B")] == ["n"]
        eng.close()
        eng2 = SegmentEngine(str(tmp_path))
        assert [x.id for x in eng2.get_nodes_by_label("B")] == ["n"]
        eng2.close()

    def test_pending_embed_persistence(self, tmp_path):
        eng = SegmentEngine(str(tmp_path))
        eng.create_node(Node(id="p1"))
        eng.mark_pending_embed("p1")
        eng.close()
        eng2 = SegmentEngine(str(tmp_path))
        assert eng2.pending_embed_ids() == ["p1"]
        eng2.unmark_pending_embed("p1")
        assert eng2.pending_embed_ids() == []
        eng2.close()

    def test_compaction_reclaims(self, tmp_path):
        eng = SegmentEngine(str(tmp_path))
        for i in range(50):
            eng.create_node(Node(id=f"n{i}", properties={"pad": "x" * 200}))
        for i in range(40):
            eng.delete_node(f"n{i}")
        eng.compact()
        size_after = os.path.getsize(tmp_path / "graph.seg")
        assert size_after < 50 * 250  # most of the dead bytes gone
        eng.close()
        eng2 = SegmentEngine(str(tmp_path))
        assert eng2.node_count() == 10
        assert eng2.get_node("n45")
        eng2.close()

    def test_torn_tail_recovery(self, tmp_path):
        eng = SegmentEngine(str(tmp_path))
        eng.create_node(Node(id="good1"))
        eng.create_node(Node(id="good2"))
        eng.close()
        path = tmp_path / "graph.seg"
        raw = path.read_bytes()
        path.write_bytes(raw[:-5])  # torn tail
        eng2 = SegmentEngine(str(tmp_path))
        assert eng2.node_count() == 1
        assert eng2.get_node("good1")
        eng2.create_node(Node(id="after"))  # still writable
        eng2.close()
        eng3 = SegmentEngine(str(tmp_path))
        assert eng3.node_count() == 2
        eng3.close()


# -- at-rest encryption (ref: db.go:781-809 — Badger built-in encryption) ----

class TestSegmentEncryption:
    @pytest.fixture(autouse=True)
    def _needs_cryptography(self):
        # optional dep: a bare tier-1 image skips, not errors
        pytest.importorskip("cryptography")

    def _open(self, d, passphrase=None):
        from nornicdb_tpu_torch.storage.segment import SegmentEngine
        return SegmentEngine(d, passphrase=passphrase)

    def test_roundtrip_and_restart(self, tmp_path):
        from nornicdb_tpu_torch.storage.types import Node
        d = str(tmp_path / "enc")
        eng = self._open(d, passphrase="hunter2")
        n = eng.create_node(Node(labels=["Secret"], properties={"k": "classified"}))
        eng.close()
        eng2 = self._open(d, passphrase="hunter2")
        got = eng2.get_node(n.id)
        assert got.properties["k"] == "classified"
        assert got.labels == ["Secret"]
        eng2.close()

    def test_plaintext_never_on_disk(self, tmp_path):
        from nornicdb_tpu_torch.storage.types import Node
        d = str(tmp_path / "enc")
        eng = self._open(d, passphrase="hunter2")
        eng.create_node(Node(labels=["Secret"], properties={"k": "classified-payload"}))
        eng.close()
        raw = open(f"{d}/graph.seg", "rb").read()
        assert b"classified-payload" not in raw
        assert b"Secret" not in raw

    def test_wrong_passphrase_rejected(self, tmp_path):
        import pytest
        from nornicdb_tpu_torch.errors import NornicError
        d = str(tmp_path / "enc")
        self._open(d, passphrase="right").close()
        with pytest.raises(NornicError, match="passphrase"):
            self._open(d, passphrase="wrong")

    def test_missing_passphrase_rejected(self, tmp_path):
        import pytest
        from nornicdb_tpu_torch.errors import NornicError
        d = str(tmp_path / "enc")
        self._open(d, passphrase="right").close()
        with pytest.raises(NornicError, match="encrypted"):
            self._open(d)

    def test_unencrypted_store_still_plain(self, tmp_path):
        from nornicdb_tpu_torch.storage.types import Node
        d = str(tmp_path / "plain")
        eng = self._open(d)
        eng.create_node(Node(labels=["Open"], properties={"k": 1}))
        eng.close()
        assert b"Open" in open(f"{d}/graph.seg", "rb").read()


    def test_passphrase_on_existing_plaintext_store_refused_safely(self, tmp_path):
        import os, pytest
        from nornicdb_tpu_torch.errors import NornicError
        from nornicdb_tpu_torch.storage.types import Node
        d = str(tmp_path / "plain2")
        eng = self._open(d)
        n = eng.create_node(Node(labels=["Keep"], properties={"k": 1}))
        eng.close()
        with pytest.raises(NornicError, match="unencrypted data"):
            self._open(d, passphrase="pp")
        # refusal must not have persisted a salt or sentinel: plain reopen works
        assert not os.path.exists(f"{d}/seg.salt")
        eng2 = self._open(d)
        assert eng2.get_node(n.id).properties["k"] == 1
        eng2.close()


class TestSegmentStartupGC:
    def test_leftover_garbage_collected_on_open(self, tmp_path):
        """Garbage above COMPACT_RATIO left by a previous run (e.g. a crash
        between the tombstone append and the inline compact) is collected
        once at open, post-recovery."""
        from nornicdb_tpu_torch.storage.segment import SegmentEngine
        from nornicdb_tpu_torch.storage.types import Node
        d = str(tmp_path / "gc")
        eng = SegmentEngine(d)
        ids = [eng.create_node(Node(labels=["G"], properties={"i": i})).id
               for i in range(10)]
        # bypass the engine (and its inline GC): raw tombstones, like a run
        # that died mid-cleanup
        for nid in ids[:8]:
            eng._kv.delete(b"n:" + nid.encode())
        assert eng._kv.tombstones() > eng.COMPACT_RATIO * eng._kv.count()
        eng.close()
        eng2 = SegmentEngine(d)
        assert eng2._kv.tombstones() == 0  # opened clean
        assert sum(1 for _ in eng2.all_nodes()) == 2
        eng2.close()

    def test_inline_gc_keeps_ratio_bounded(self, tmp_path):
        from nornicdb_tpu_torch.storage.segment import SegmentEngine
        from nornicdb_tpu_torch.storage.types import Node
        d = str(tmp_path / "gc2")
        eng = SegmentEngine(d)
        for i in range(50):
            n = eng.create_node(Node(labels=["G"], properties={"i": i}))
            eng.delete_node(n.id)
        live = max(eng._kv.count(), 1)
        assert eng._kv.tombstones() <= max(eng.COMPACT_RATIO * live, 2)
        eng.close()


class TestOnlineCompaction:
    """Round-2: two-phase compaction runs under live load without blocking
    readers (ref: Badger's background value-log GC, pkg/storage/badger.go:67)
    + mmap read path."""

    def test_compaction_under_concurrent_write_load(self, tmp_path):
        """Writers and readers keep operating while compactions run in a
        background thread; no data is lost or resurrected."""
        import threading

        eng = SegmentEngine(str(tmp_path), auto_compact_interval=0)
        for i in range(500):
            eng.create_node(Node(id=f"n{i}", labels=["L"],
                                 properties={"i": i, "pad": "x" * 200}))
        for i in range(0, 250):
            eng.delete_node(f"n{i}")

        stop = threading.Event()
        errors: list = []

        def writer():
            j = 1000
            while not stop.is_set():
                try:
                    eng.create_node(Node(id=f"w{j}", labels=["L"],
                                         properties={"j": j}))
                    if j % 3 == 0:
                        eng.delete_node(f"w{j}")
                    j += 1
                except Exception as e:  # pragma: no cover
                    errors.append(e)
                    return

        def reader():
            while not stop.is_set():
                try:
                    n = eng.get_node("n400")
                    assert n.properties["i"] == 400
                except Exception as e:  # pragma: no cover
                    errors.append(e)
                    return

        threads = [threading.Thread(target=writer),
                   threading.Thread(target=reader)]
        for t in threads:
            t.start()
        try:
            for _ in range(5):
                eng.compact()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errors
        # survivors intact, deletions stayed deleted
        assert eng.get_node("n400").properties["i"] == 400
        with pytest.raises(NotFoundError):
            eng.get_node("n100")
        eng.close()
        # and the compacted file recovers cleanly
        eng2 = SegmentEngine(str(tmp_path), auto_compact_interval=0)
        assert eng2.get_node("n400").properties["i"] == 400
        with pytest.raises(NotFoundError):
            eng2.get_node("n100")
        eng2.close()

    def test_background_compaction_thread_sweeps(self, tmp_path):
        eng = SegmentEngine(str(tmp_path), auto_compact_interval=0.2)
        for i in range(200):
            eng.create_node(Node(id=f"n{i}", labels=["L"],
                                 properties={"i": i}))
        # bypass the inline ratio check to build garbage the background
        # sweep must collect
        for i in range(180):
            eng._kv.delete(eng._nk(f"n{i}"))
        assert eng._kv.tombstones() > 0
        import time

        deadline = time.time() + 10
        while time.time() < deadline and eng._kv.tombstones() > 20:
            time.sleep(0.1)
        assert eng._kv.tombstones() <= 20, "background sweep did not run"
        eng.close()

    def test_stale_compact_tmp_removed_on_open(self, tmp_path):
        eng = SegmentEngine(str(tmp_path), auto_compact_interval=0)
        eng.create_node(Node(id="a", labels=[], properties={}))
        eng.close()
        tmp = os.path.join(str(tmp_path), "graph.seg.compact")
        with open(tmp, "w") as f:
            f.write("garbage from a crashed compaction")
        eng2 = SegmentEngine(str(tmp_path), auto_compact_interval=0)
        assert not os.path.exists(tmp)
        assert eng2.get_node("a").id == "a"
        eng2.close()

    def test_reads_after_growth_remap(self, tmp_path):
        """mmap view must follow appends past the original mapping."""
        eng = SegmentEngine(str(tmp_path), auto_compact_interval=0)
        eng.create_node(Node(id="first", labels=[], properties={"v": 1}))
        assert eng.get_node("first").properties["v"] == 1  # maps small file
        for i in range(1000):
            eng.create_node(Node(id=f"grow{i}", labels=[],
                                 properties={"pad": "y" * 500}))
        assert eng.get_node("grow999").properties["pad"] == "y" * 500
        assert eng.get_node("first").properties["v"] == 1
        eng.close()


# ---- cases of tests/test_native.py, against the port
def _python_encode(payload: bytes, seq: int) -> bytes:
    rec = _HEADER.pack(MAGIC, VERSION, len(payload)) + payload
    rec += _FOOTER.pack(zlib.crc32(payload) & 0xFFFFFFFF, seq)
    return rec + b"\x00" * ((-len(rec)) % 8)


@pytest.fixture(autouse=True)
def _native_codec_built():
    """The port builds its codec at first use; a failed build fails here
    with the compiler's output instead of skipping."""
    assert native.load() is not None, native.build_errors


class TestNativeCodec:
    def test_encode_matches_python(self):
        for payload in (b"{}", b'{"op":"x"}', b"p" * 1000):
            for seq in (0, 1, 2**40):
                assert native.encode(payload, seq) == _python_encode(payload, seq)

    def test_scan_roundtrip(self):
        buf = b"".join(native.encode(f'{{"i":{i}}}'.encode(), i) for i in range(50))
        records, valid = native.scan(buf)
        assert valid == len(buf)
        assert len(records) == 50
        assert records[7] == (b'{"i":7}', 7)

    def test_scan_stops_at_torn_tail(self):
        buf = native.encode(b'{"a":1}', 1) + native.encode(b'{"b":2}', 2)
        records, valid = native.scan(buf[:-10])
        assert len(records) == 1
        assert valid <= len(buf) - 10

    def test_scan_detects_corruption(self):
        raw = bytearray(native.encode(b'{"a":1}', 1) + native.encode(b'{"b":2}', 2))
        raw[len(raw) // 2 + 4] ^= 0xFF  # flip a byte in record 2
        records, _ = native.scan(bytes(raw))
        assert len(records) == 1

    def test_crc_matches_zlib(self):
        import ctypes
        lib = native.load()
        for data in (b"", b"x", b"hello world" * 99):
            assert lib.wal_crc32(data, len(data)) == (zlib.crc32(data) & 0xFFFFFFFF)

    def test_wal_end_to_end_with_native(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NORNICDB_NATIVE_WAL", "1")
        wal = WAL(str(tmp_path / "wal"))
        eng = WALEngine(MemoryEngine(), wal)
        for i in range(10):
            eng.create_node(Node(id=f"n{i}"))
        wal2 = WAL(str(tmp_path / "wal"))
        fresh = MemoryEngine()
        assert wal2.recover(fresh) == 10
        assert fresh.node_count() == 10


# ---- against the JAX package
import nornicdb_tpu.storage as jax_storage  # noqa: E402
import nornicdb_tpu.storage.segment as jax_segment  # noqa: E402
import nornicdb_tpu_torch.storage as port_storage  # noqa: E402
from nornicdb_tpu_torch.storage import segment as port_segment  # noqa: E402

PKGS = {"jax": jax_storage, "port": port_storage}


def _write(pkg, eng, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(30):
        eng.create_node(pkg.Node(
            id=f"d{i}", labels=["Doc"], properties={"content": f"doc {i}"},
            embedding=rng.standard_normal(16).astype(np.float32),
            created_at=5.0, updated_at=5.0, last_accessed=5.0))
    for j in range(60):
        a, b = (int(x) for x in rng.integers(0, 30, 2))
        eng.create_edge(pkg.Edge(id=f"e{j}", start_node=f"d{a}",
                                 end_node=f"d{b}", type="R",
                                 created_at=5.0, updated_at=5.0))
    for j in range(0, 60, 4):
        eng.delete_edge(f"e{j}")
    eng.delete_node("d3")
    eng.mark_pending_embed("d4")


def _state(eng) -> tuple:
    nodes = sorted(
        (n.id, json.dumps(n.properties), tuple(n.labels),
         n.embedding.tobytes()) for n in eng.all_nodes())
    edges = sorted((e.id, e.start_node, e.end_node, e.type)
                   for e in eng.all_edges())
    return nodes, edges, eng.pending_embed_ids()


class TestCrossPackageReopen:
    @pytest.mark.parametrize("passphrase", ["", "s3cret"],
                             ids=["plain", "encrypted"])
    @pytest.mark.parametrize("writer,reader",
                             [("jax", "port"), ("port", "jax")])
    def test_segment_directory_reopens_in_the_other_package(
            self, tmp_path, writer, reader, passphrase):
        if passphrase:
            pytest.importorskip("cryptography")
        w, r = PKGS[writer], PKGS[reader]
        d = str(tmp_path / "seg")
        eng = w.open_storage(d, engine="segment",
                             encryption_passphrase=passphrase)
        _write(w, eng, seed=1)
        eng.flush()
        want = _state(eng)
        eng.close()
        assert len(want[0]) == 29 and want[2] == ["d4"]
        got = r.open_storage(d, engine="segment",
                             encryption_passphrase=passphrase)
        try:
            assert _state(got) == want
        finally:
            got.close()
        # the same directory written through both engines in turn
        eng = r.open_storage(d, engine="segment",
                             encryption_passphrase=passphrase)
        eng.create_node(r.Node(id="late", embedding=np.ones(16, np.float32)))
        eng.close()
        back = w.open_storage(d, engine="segment",
                              encryption_passphrase=passphrase)
        try:
            assert back.get_node("late").embedding.tobytes() == \
                np.ones(16, np.float32).tobytes()
            assert back.node_count() == 30
        finally:
            back.close()

    def test_record_file_bytes_identical(self, tmp_path, monkeypatch):
        """Unencrypted, the same writes leave the same segment file (the
        pending-embed mark stores the clock: both read one fixed clock)."""
        import time

        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
        blobs = []
        for name, pkg in PKGS.items():
            d = str(tmp_path / name)
            seg = jax_segment if name == "jax" else port_segment
            eng = seg.SegmentEngine(d, auto_compact_interval=0)
            _write(pkg, eng, seed=2)
            eng.close()
            blobs.append(open(os.path.join(d, "graph.seg"), "rb").read())
        assert len(blobs[0]) > 1000 and blobs[0] == blobs[1]


class TestPortBuilds:
    def test_libraries_are_the_ports_own_builds(self):
        assert segment_store_available()
        for name in ("walcodec", "segstore"):
            path = native.library_path(name)
            assert os.path.dirname(path) == str(native.BUILD_DIR)
            assert os.path.basename(path).startswith(f"lib{name}-")
            assert os.path.exists(path)
            # the port's copy of the source: framing and records unchanged
            assert (native.CSRC / f"{name}.cc").exists()
        assert port_segment._lib is not jax_segment._lib

    def test_digest_follows_the_source(self, tmp_path, monkeypatch):
        src = tmp_path / "csrc"
        src.mkdir()
        (src / "walcodec.cc").write_bytes(
            (native.CSRC / "walcodec.cc").read_bytes())
        monkeypatch.setattr(native, "CSRC", src)
        monkeypatch.delenv("NORNICDB_NATIVE_DIR", raising=False)
        before = native.library_path("walcodec")
        (src / "walcodec.cc").write_bytes(
            (src / "walcodec.cc").read_bytes() + b"\n// edited\n")
        assert native.library_path("walcodec") != before

    def test_native_dir_names_prebuilt_libraries(self, tmp_path, monkeypatch):
        monkeypatch.setenv("NORNICDB_NATIVE_DIR", str(tmp_path))
        assert native.library_path("segstore") == str(
            tmp_path / "libsegstore.so")
        native.build_errors.pop("segstore", None)
        assert native.build_library("segstore") is None
        assert "not found" in native.build_errors["segstore"]
        assert not list(tmp_path.iterdir())  # nothing built there
