"""WAL, WALEngine and the storage fault seams of the port
(``nornicdb_tpu_torch.storage.wal`` / ``faults`` / ``native``), held to the
JAX package's cases and to its bytes.

The cases of ``tests/test_wal_depth.py``, ``tests/test_storage_chaos.py``
and ``tests/test_storage_faults.py`` run against the port unchanged but for
their imports. Then both packages' ``WALEngine``s take the same seeded op
sequence (fixed ids, timestamps and float32 embeddings) and must write
byte-identical WAL files and snapshots, with the Python codec and with the
native one; and a data directory written by either package recovers in the
other to equal nodes and edges, plain and encrypted.
"""

import errno
import json
import os
import threading
import zlib

import numpy as np
import pytest

from nornicdb_tpu_torch.errors import DurabilityError, WALCorruptionError
from nornicdb_tpu_torch.storage import (
    WAL,
    AsyncEngine,
    MemoryEngine,
    Node,
    WALEngine,
)
from nornicdb_tpu_torch.storage.faults import INJECTOR, StorageFaultInjector
from nornicdb_tpu_torch.storage.types import Edge
from nornicdb_tpu_torch.storage.wal import (
    _FOOTER,
    _HEADER,
    MAGIC,
    OP_CREATE_NODE,
    WALEntry,
)


# ---- cases of tests/test_wal_depth.py, against the port
def _node(i, **props):
    return Node(id=f"n{i}", labels=["T"], properties=props)


class TestAppendAndStats:
    def test_append_returns_monotonic_seq(self, tmp_path):
        """ref: TestWAL_Append"""
        wal = WAL(str(tmp_path))
        seqs = [wal.append("create_node", {"id": f"n{i}"}) for i in range(5)]
        assert seqs == sorted(seqs)
        assert len(set(seqs)) == 5
        assert wal.last_seq == seqs[-1]
        wal.close()

    def test_stats_track_entries_and_bytes(self, tmp_path):
        """ref: TestWAL_Stats"""
        wal = WAL(str(tmp_path))
        assert wal.stats.entries == 0
        wal.append("create_node", {"id": "n1", "payload": "x" * 100})
        wal.append("delete_node", {"id": "n1"})
        assert wal.stats.entries == 2
        assert wal.stats.bytes_written > 100
        wal.close()

    def test_read_all_returns_entries_in_order(self, tmp_path):
        """ref: TestWAL_ReadEntries"""
        wal = WAL(str(tmp_path))
        for i in range(10):
            wal.append("create_node", {"id": f"n{i}"})
        wal.close()
        entries = WAL(str(tmp_path)).read_all()
        assert [e.data["id"] for e in entries] == [f"n{i}" for i in range(10)]
        assert [e.seq for e in entries] == list(range(1, 11))

    def test_concurrent_appends_no_lost_or_duplicate_seq(self, tmp_path):
        """ref: TestWAL_ConcurrentAppends"""
        wal = WAL(str(tmp_path))
        out: list[int] = []
        lock = threading.Lock()

        def writer(base):
            local = [wal.append("create_node", {"id": f"{base}-{i}"})
                     for i in range(50)]
            with lock:
                out.extend(local)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wal.close()
        assert len(out) == 300
        assert len(set(out)) == 300  # no duplicate seqs under contention
        entries = WAL(str(tmp_path)).read_all()
        assert len(entries) == 300

    def test_sequence_restored_after_reopen(self, tmp_path):
        """ref: TestWAL_SequenceRestoration"""
        wal = WAL(str(tmp_path))
        last = 0
        for i in range(7):
            last = wal.append("create_node", {"id": f"n{i}"})
        wal.close()
        wal2 = WAL(str(tmp_path))
        assert wal2.append("create_node", {"id": "after"}) == last + 1
        wal2.close()


class TestEntryEncoding:
    def test_crc_detects_flipped_byte(self, tmp_path):
        """ref: TestCrc32Checksum — a flipped payload byte in a MIDDLE
        record (valid records after it) is mid-file corruption: detected at
        open, surfaced as degraded, corrupt log quarantined, valid prefix
        preserved."""
        wal = WAL(str(tmp_path))
        wal.append("create_node", {"id": "n1", "k": "a" * 64})
        r2_start = os.path.getsize(tmp_path / "wal.log")
        wal.append("create_node", {"id": "n2", "k": "b" * 64})
        wal.append("create_node", {"id": "n3", "k": "c" * 64})
        wal.close()
        path = tmp_path / "wal.log"
        raw = bytearray(path.read_bytes())
        raw[r2_start + 16] ^= 0xFF  # inside record 2's payload
        path.write_bytes(bytes(raw))
        wal2 = WAL(str(tmp_path))
        assert wal2.stats.degraded
        assert "corrupt" in wal2.stats.corruption_info.lower() or \
            wal2.stats.corruption_info
        # the valid prefix before the corruption survives
        entries = wal2.read_all()
        assert [e.data["id"] for e in entries] == ["n1"]
        # corrupt original quarantined next to the live log
        assert any("corrupt" in f for f in os.listdir(tmp_path))
        wal2.close()

    def test_entry_roundtrip_unicode_and_nested(self, tmp_path):
        e = WALEntry(seq=3, op="create_node",
                     data={"id": "n-ø", "props": {"list": [1, {"k": "日本"}]}},
                     txid="tx-1")
        wal = WAL(str(tmp_path))
        out = wal._parse_buffer(e.encode())
        assert len(out) == 1
        assert out[0].seq == 3
        assert out[0].op == "create_node"
        assert out[0].data["props"]["list"][1]["k"] == "日本"
        assert out[0].txid == "tx-1"
        wal.close()


class TestSnapshots:
    def test_create_and_load_roundtrip(self, tmp_path):
        """ref: TestSnapshot_CreateAndLoad"""
        eng = MemoryEngine()
        eng.create_node(_node(1, name="a"))
        eng.create_node(_node(2, name="b"))
        eng.create_edge(Edge(id="e1", start_node="n1", end_node="n2",
                             type="R"))
        wal = WAL(str(tmp_path))
        wal.append("create_node", {"x": 1})
        wal.create_snapshot(eng)
        snap = wal.load_snapshot()
        assert len(snap["nodes"]) == 2
        assert len(snap["edges"]) == 1
        assert snap["seq"] == wal.last_seq
        wal.close()

    def test_snapshot_write_is_atomic(self, tmp_path):
        """ref: TestSnapshot_AtomicWrite — no partially-written snapshot
        file becomes visible under the final name (temp + rename)."""
        eng = MemoryEngine()
        eng.create_node(_node(1))
        wal = WAL(str(tmp_path))
        wal.create_snapshot(eng)
        files = os.listdir(tmp_path)
        assert "snapshot.json" in files
        assert not [f for f in files if f.endswith(".tmp")]
        # the snapshot on disk is complete, valid JSON
        with open(tmp_path / "snapshot.json") as f:
            assert json.load(f)["nodes"]
        wal.close()

    def test_truncate_up_to_keeps_newer_entries(self, tmp_path):
        """ref: TestWAL_TruncateAfterSnapshot"""
        eng = MemoryEngine()
        wal = WAL(str(tmp_path))
        for i in range(5):
            wal.append("create_node", {"id": f"old{i}"})
        cut = wal.last_seq
        wal.write_snapshot(wal.snapshot_state(eng) | {"seq": cut})
        wal.append("create_node", {"id": "new1"})
        wal.truncate_up_to(cut)
        entries = wal.read_all()
        assert [e.data["id"] for e in entries] == ["new1"]
        wal.close()


class TestReplayOps:
    """ref: TestReplayWALEntry — every op kind replays onto an engine."""

    def test_all_op_kinds_replay(self, tmp_path):
        src = MemoryEngine()
        wal_eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
        n1 = wal_eng.create_node(_node(1, name="orig"))
        wal_eng.create_node(_node(2))
        wal_eng.create_edge(Edge(id="e1", start_node="n1", end_node="n2",
                                 type="R", properties={"w": 1}))
        n1.properties["name"] = "updated"
        wal_eng.update_node(n1)
        e = wal_eng.get_edge("e1")
        e.properties["w"] = 2
        wal_eng.update_edge(e)
        wal_eng.create_node(_node(3))
        wal_eng.delete_node("n3")
        wal_eng.mark_pending_embed("n1")
        wal_eng.close()

        fresh = MemoryEngine()
        wal2 = WAL(str(tmp_path))
        wal2.recover(fresh)  # close() compacted: state may live in snapshot
        assert fresh.get_node("n1").properties["name"] == "updated"
        assert fresh.get_edge("e1").properties["w"] == 2
        assert fresh.node_count() == 2  # n3 deleted
        assert "n1" in fresh.pending_embed_ids()
        wal2.close()

    def test_recovery_is_deterministic_across_engines(self, tmp_path):
        """Recovering the same log into two fresh engines yields identical
        state (replay has no hidden per-run state)."""
        wal_eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
        wal_eng.create_node(_node(1, name="x"))
        wal_eng.create_node(_node(2))
        wal_eng.delete_node("n2")
        wal_eng.close()
        a, b = MemoryEngine(), MemoryEngine()
        WAL(str(tmp_path)).recover(a)
        WAL(str(tmp_path)).recover(b)
        assert a.node_count() == b.node_count() == 1
        assert a.get_node("n1").properties == b.get_node("n1").properties


class TestWALEngineCompaction:
    def test_compact_preserves_state_and_shrinks_log(self, tmp_path):
        """ref: TestWALEngine_AutoCompaction (manual trigger)"""
        wal_eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
        for i in range(50):
            wal_eng.create_node(_node(i))
        size_before = os.path.getsize(tmp_path / "wal.log")
        wal_eng.compact()
        assert os.path.getsize(tmp_path / "wal.log") < size_before
        wal_eng.close()
        fresh = MemoryEngine()
        wal2 = WAL(str(tmp_path))
        wal2.recover(fresh)
        assert fresh.node_count() == 50
        wal2.close()

    def test_writes_after_compact_recover(self, tmp_path):
        wal_eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
        wal_eng.create_node(_node(1))
        wal_eng.compact()
        wal_eng.create_node(_node(2))
        wal_eng.close()
        fresh = MemoryEngine()
        WAL(str(tmp_path)).recover(fresh)
        assert fresh.node_count() == 2

    def test_compact_deferred_inside_open_tx(self, tmp_path):
        """A snapshot during an open tx would bake uncommitted ops in while
        losing their txid tags (ref: tx-aware recovery wal.go:1845)."""
        wal_eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
        wal_eng.create_node(_node(1))
        wal_eng.tx_begin("tx-open")
        wal_eng.create_node(_node(2))
        size_before = os.path.getsize(tmp_path / "wal.log")
        wal_eng.compact()  # must be a no-op
        assert os.path.getsize(tmp_path / "wal.log") == size_before
        wal_eng.tx_commit("tx-open")
        wal_eng.compact()  # now it runs
        wal_eng.close()
        fresh = MemoryEngine()
        WAL(str(tmp_path)).recover(fresh)
        assert fresh.node_count() == 2


class TestTransactionalRecovery:
    """ref: TestBatchWriter_Commit / _Rollback — tx framing decides replay."""

    def test_uncommitted_tx_rolled_back_on_recovery(self, tmp_path):
        wal = WAL(str(tmp_path))
        wal.append("create_node", Node(id="durable").to_dict())
        wal.append("tx_begin", {}, txid="t1")
        wal.append("create_node", Node(id="phantom").to_dict(), txid="t1")
        # crash: no commit record
        wal.close()
        fresh = MemoryEngine()
        WAL(str(tmp_path)).recover(fresh)
        assert fresh.node_count() == 1
        assert fresh.get_node("durable")

    def test_committed_tx_replays(self, tmp_path):
        wal = WAL(str(tmp_path))
        wal.append("tx_begin", {}, txid="t1")
        wal.append("create_node", Node(id="a").to_dict(), txid="t1")
        wal.append("create_node", Node(id="b").to_dict(), txid="t1")
        wal.append("tx_commit", {}, txid="t1")
        wal.close()
        fresh = MemoryEngine()
        WAL(str(tmp_path)).recover(fresh)
        assert fresh.node_count() == 2

    def test_explicit_rollback_discards(self, tmp_path):
        wal = WAL(str(tmp_path))
        wal.append("tx_begin", {}, txid="t1")
        wal.append("create_node", Node(id="x").to_dict(), txid="t1")
        wal.append("tx_rollback", {}, txid="t1")
        wal.close()
        fresh = MemoryEngine()
        WAL(str(tmp_path)).recover(fresh)
        assert fresh.node_count() == 0

    def test_interleaved_transactions_independent(self, tmp_path):
        """Two interleaved txids: one commits, one doesn't."""
        wal = WAL(str(tmp_path))
        wal.append("tx_begin", {}, txid="good")
        wal.append("tx_begin", {}, txid="bad")
        wal.append("create_node", Node(id="keep").to_dict(), txid="good")
        wal.append("create_node", Node(id="drop").to_dict(), txid="bad")
        wal.append("tx_commit", {}, txid="good")
        wal.close()
        fresh = MemoryEngine()
        WAL(str(tmp_path)).recover(fresh)
        assert fresh.node_count() == 1
        assert fresh.get_node("keep")


class TestStreamingReads:
    """ref: TestWALEngine_StreamNodes/_StreamEdges — iteration surfaces
    on the durable chain behave like the base engine's."""

    def test_all_nodes_and_edges_stream_through(self, tmp_path):
        wal_eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
        for i in range(20):
            wal_eng.create_node(_node(i))
        for i in range(10):
            wal_eng.create_edge(Edge(id=f"e{i}", start_node=f"n{i}",
                                     end_node=f"n{i + 1}", type="R"))
        assert len(list(wal_eng.all_nodes())) == 20
        assert len(list(wal_eng.all_edges())) == 10
        assert wal_eng.degree("n1") == 2
        wal_eng.close()


# ---- cases of tests/test_storage_chaos.py, against the port
def _wal_with_nodes(tmp_path, n=3):
    wal = WAL(str(tmp_path))
    for i in range(n):
        wal.append(OP_CREATE_NODE, Node(id=f"n{i}", labels=["Test"]).to_dict())
    wal.close()
    return str(tmp_path / "wal.log")


def _records(buf):
    """Split a WAL buffer into (offset, length) framed records."""
    out = []
    off = 0
    while off + _HEADER.size <= len(buf):
        magic, ver, oplen = _HEADER.unpack_from(buf, off)
        if magic != MAGIC:
            break
        body_end = off + _HEADER.size + oplen + _FOOTER.size
        total = body_end - off
        total += (-total) % 8
        out.append((off, total))
        off += total
    return out


# =============================================================================
# CRC32 (TestCRC32ProperImplementation / MatchesStandardLibrary /
# Deterministic / TestVerifyCRC32)
# =============================================================================
class TestCRC32:
    @pytest.mark.parametrize("a,b", [
        (bytes([0, 0, 0, 0]), bytes([0, 0, 0, 1])),      # single bit flip
        (bytes([1, 2, 3, 4]), bytes([4, 3, 2, 1])),      # byte swap
        (b"hello", b"hellp"),                            # off by one
        (b"test", b"test\x00"),                          # length difference
    ])
    def test_no_weak_collisions(self, a, b):
        """TestCRC32ProperImplementation — a weak XOR checksum collides on
        these; real CRC32 must not."""
        assert zlib.crc32(a) != zlib.crc32(b)

    def test_record_crc_matches_stdlib(self, tmp_path):
        """TestCRC32MatchesStandardLibrary — the CRC stored in each record
        footer is exactly stdlib crc32 of the payload."""
        path = _wal_with_nodes(tmp_path)
        buf = open(path, "rb").read()
        assert len(_records(buf)) == 3
        for off, _ in _records(buf):
            _, _, oplen = _HEADER.unpack_from(buf, off)
            payload = buf[off + _HEADER.size: off + _HEADER.size + oplen]
            crc, _ = _FOOTER.unpack_from(buf, off + _HEADER.size + oplen)
            assert crc == zlib.crc32(payload) & 0xFFFFFFFF

    def test_deterministic(self, tmp_path):
        """TestCRC32Deterministic — identical entries encode identically."""
        e = WALEntry(seq=7, op=OP_CREATE_NODE, data={"id": "n1"})
        first = e.encode()
        for _ in range(100):
            assert WALEntry(seq=7, op=OP_CREATE_NODE,
                            data={"id": "n1"}).encode() == first

    def test_verify_integrity_helper(self, tmp_path):
        """TestVerifyCRC32 — verify_integrity is ok for a clean log; after a
        byte of corruption the open quarantines the damaged file (keeping it
        for forensics), flags degraded, and the rewritten log holds only the
        valid prefix."""
        import os

        path = _wal_with_nodes(tmp_path)
        wal = WAL(str(tmp_path))
        n, ok = wal.verify_integrity()
        assert (n, ok) == (3, True)
        wal.close()
        buf = bytearray(open(path, "rb").read())
        buf[_records(bytes(buf))[1][0] + _HEADER.size] ^= 0xFF
        open(path, "wb").write(bytes(buf))
        wal = WAL(str(tmp_path))
        assert wal.stats.degraded, "corruption must be flagged on open"
        assert os.path.exists(path + ".corrupt-1"), "damaged log preserved"
        n, ok = wal.verify_integrity()
        assert (n, ok) == (1, True), "rewritten log holds the valid prefix"
        wal.close()


# =============================================================================
# CORRUPTED ENTRY DETECTION (TestWALDetectsCorruptedChecksum,
# TestWALSkipsCorruptedEmbeddingEntries)
# =============================================================================
class TestCorruptionDetection:
    def test_detects_corrupted_checksum(self, tmp_path):
        """TestWALDetectsCorruptedChecksum — an entry whose stored CRC does
        not match its payload must error in strict mode and never be
        returned as valid."""
        path = _wal_with_nodes(tmp_path, n=2)
        buf = bytearray(open(path, "rb").read())
        recs = _records(bytes(buf))
        # flip a bit in the SECOND record's stored checksum
        off, total = recs[1]
        _, _, oplen = _HEADER.unpack_from(bytes(buf), off)
        buf[off + _HEADER.size + oplen] ^= 0x01
        open(path, "wb").write(bytes(buf))

        wal = WAL(str(tmp_path))
        with pytest.raises(WALCorruptionError):
            wal.read_all(strict=True)
        wal.close()
        # non-strict: the corrupted entry is never surfaced as data
        wal = WAL(str(tmp_path))
        entries = wal.read_all()
        assert [e.data["id"] for e in entries] == ["n0"]
        wal.close()

    def test_corrupt_middle_with_valid_after_is_degraded(self, tmp_path):
        """TestWALSkipsCorruptedEmbeddingEntries intent, mapped to this
        framework's contract: a corrupt record FOLLOWED by intact records
        means committed data was lost — recovery continues but flags
        degraded mode (wal_degraded.go)."""
        path = _wal_with_nodes(tmp_path, n=3)
        buf = bytearray(open(path, "rb").read())
        recs = _records(bytes(buf))
        off, _ = recs[1]
        buf[off + _HEADER.size + 2] ^= 0xFF  # corrupt middle payload
        open(path, "wb").write(bytes(buf))

        wal = WAL(str(tmp_path))
        entries = wal.read_all()
        assert [e.data["id"] for e in entries] == ["n0"]
        assert wal.stats.degraded, "intact records after corruption = degraded"
        assert "offset" in (wal.stats.corruption_info or "")
        wal.close()

    def test_corrupt_tail_only_is_benign(self, tmp_path):
        """Counterpart: a torn FINAL record (crash mid-append) is expected
        and must NOT flag degraded mode."""
        path = _wal_with_nodes(tmp_path, n=2)
        with open(path, "ab") as f:
            f.write(_HEADER.pack(MAGIC, 1, 9999))  # header promising bytes
        wal = WAL(str(tmp_path))
        entries = wal.read_all()
        assert [e.data["id"] for e in entries] == ["n0", "n1"]
        assert not wal.stats.degraded
        wal.close()


# =============================================================================
# REPLAY TRACKING (TestReplayResultTracking, TestRecoverFromWAL...)
# =============================================================================
class TestReplayTracking:
    def test_replay_applies_and_tolerates_duplicates(self, tmp_path):
        """TestReplayResultTracking — duplicates / checkpoint-class entries
        must be skipped without failing recovery."""
        wal = WAL(str(tmp_path))
        n1 = Node(id="n1", labels=["Test"])
        n2 = Node(id="n2", labels=["Test"])
        wal.append(OP_CREATE_NODE, n1.to_dict())
        wal.append(OP_CREATE_NODE, n2.to_dict())
        wal.append(OP_CREATE_NODE, n1.to_dict())  # duplicate — must skip
        wal.close()

        wal = WAL(str(tmp_path))
        engine = MemoryEngine()
        applied = wal.recover(engine)
        assert applied == 3  # three entries processed...
        assert engine.node_count() == 2  # ...two landed, duplicate skipped
        wal.close()

    def test_recovery_tracks_errors_but_keeps_valid_data(self, tmp_path):
        """TestRecoverFromWALWithResultTracksErrors — an edge whose endpoints
        do not exist must not poison recovery of the valid node."""
        from nornicdb_tpu_torch.storage import Edge
        from nornicdb_tpu_torch.storage.wal import OP_CREATE_EDGE

        wal = WAL(str(tmp_path))
        wal.append(OP_CREATE_NODE, Node(id="valid-node", labels=["Test"]).to_dict())
        wal.append(OP_CREATE_EDGE, Edge(
            id="e1", start_node="nonexistent1", end_node="nonexistent2",
            type="LINKS").to_dict())
        wal.close()

        wal = WAL(str(tmp_path))
        engine = MemoryEngine()
        wal.recover(engine)
        assert engine.get_node("valid-node") is not None
        assert engine.edge_count() == 0
        wal.close()


# =============================================================================
# ROUND-TRIP INTEGRITY (TestWALEntryIntegrity)
# =============================================================================
class TestEntryIntegrity:
    def test_full_round_trip(self, tmp_path):
        """TestWALEntryIntegrity — append, reopen, decode, verify checksums
        and node payloads byte-for-byte."""
        nodes = [
            Node(id="n1", labels=["Person"], properties={"name": "Alice"}),
            Node(id="n2", labels=["Person"], properties={"name": "Bob"}),
        ]
        wal = WAL(str(tmp_path), sync=True)
        for n in nodes:
            wal.append(OP_CREATE_NODE, n.to_dict())
        wal.close()

        wal = WAL(str(tmp_path))
        entries = wal.read_all()
        assert len(entries) == 2
        for entry, node in zip(entries, nodes):
            assert entry.op == OP_CREATE_NODE
            assert entry.data["id"] == node.id
            assert entry.data["properties"]["name"] == node.properties["name"]
        n, ok = wal.verify_integrity()
        assert (n, ok) == (2, True)
        wal.close()


# =============================================================================
# ASYNC ENGINE COUNT/FLUSH RACE
# (pkg/storage/async_engine_count_flush_race_test.go)
# =============================================================================
class _BlockingBase(MemoryEngine):
    """Base engine whose create_node blocks until released — freezes a
    flush mid-apply, exactly like the reference's blockingBulkCreateEngine."""

    def __init__(self):
        super().__init__()
        self.create_started = threading.Event()
        self.allow_create = threading.Event()
        self._passthrough = True

    def arm(self):
        self._passthrough = False

    def create_node(self, node):
        if not self._passthrough:
            self.create_started.set()
            assert self.allow_create.wait(timeout=30), "never released"
        return super().create_node(node)


class TestAsyncCountFlushRace:
    def test_node_count_blocks_during_flush(self):
        """TestAsyncEngine_NodeCount_BlocksDuringFlush — node_count must not
        return a count that misses entries a concurrent flush has already
        popped from the overlay but not yet applied to the base."""
        base = _BlockingBase()
        ae = AsyncEngine(base, flush_interval=3600.0)  # manual flush only
        try:
            ae.create_node(Node(id="nornic:node-1", labels=["N"]))
            ae.create_node(Node(id="nornic:node-2", labels=["N"]))
            base.arm()

            flush_done = threading.Event()
            threading.Thread(target=lambda: (ae.flush(), flush_done.set()),
                             daemon=True).start()
            assert base.create_started.wait(timeout=5), "flush never started"

            # node_count must BLOCK while the flush holds the lock
            count_result = []
            t = threading.Thread(
                target=lambda: count_result.append(ae.node_count()),
                daemon=True)
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive(), (
                "node_count returned mid-flush — the popped-but-unapplied "
                "window escaped the count"
            )

            base.allow_create.set()
            assert flush_done.wait(timeout=10)
            t.join(timeout=10)
            assert count_result == [2]
        finally:
            base.allow_create.set()
            ae.close()


# =============================================================================
# SCORE-SUBSET CONCURRENT REMOVE RACE (pkg/gpu/score_subset_race_test.go)
# =============================================================================
class TestScoreSubsetRace:
    def test_concurrent_remove_does_not_crash(self):
        """TestEmbeddingIndex_ScoreSubset_ConcurrentRemoveDoesNotPanic —
        score_subset racing remove/re-add of the same id must never raise
        or attribute a score to the wrong id."""
        from nornicdb_tpu_torch.ops.similarity import DeviceCorpus

        idx = DeviceCorpus(dims=4, device="cpu")
        idx.add("a", np.array([1, 0, 0, 0], np.float32))
        idx.add("b", np.array([0, 1, 0, 0], np.float32))
        query = np.array([0, 1, 0, 0], np.float32)

        errors = []
        stop = threading.Event()

        def scorer():
            try:
                for _ in range(300):
                    results = idx.score_subset(query, ["b"])
                    if len(results) > 1:
                        errors.append(f"unexpected results length {len(results)}")
                        return
                    if len(results) == 1 and results[0][0] != "b":
                        errors.append(f"unexpected result id {results[0][0]}")
                        return
            except Exception as e:  # noqa: BLE001 — the test IS about crashes
                errors.append(f"scorer raised: {e!r}")
            finally:
                stop.set()

        def churner():
            try:
                vec = np.array([0, 1, 0, 0], np.float32)
                while not stop.is_set():
                    idx.remove("b")
                    idx.add("b", vec)
            except Exception as e:  # noqa: BLE001
                errors.append(f"churner raised: {e!r}")

        ts = [threading.Thread(target=scorer, daemon=True),
              threading.Thread(target=churner, daemon=True)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors


# ---- cases of tests/test_storage_faults.py, against the port
@pytest.fixture(autouse=True)
def _clean_injector():
    INJECTOR.disarm()
    yield
    INJECTOR.disarm()


def _recovered_ids(wal_dir: str) -> set[str]:
    wal = WAL(wal_dir)
    eng = MemoryEngine()
    wal.recover(eng)
    wal.close()
    return {n.id for n in eng.all_nodes()}


class TestFsyncFailure:
    def test_typed_error_not_swallowed(self, tmp_path):
        wal = WAL(str(tmp_path), sync=True)
        wal.append("create_node", {"id": "good-1"})
        INJECTOR.arm("fsync_fail", count=1, path_prefix=str(tmp_path))
        with pytest.raises(DurabilityError) as e:
            wal.append("create_node", {"id": "lost"})
        assert e.value.kind == "fsync"
        wal.close()

    def test_wal_replayable_after_fsync_fail(self, tmp_path):
        wal = WAL(str(tmp_path), sync=True)
        wal.append("create_node", {"id": "a"})
        INJECTOR.arm("fsync_fail", count=1, path_prefix=str(tmp_path))
        with pytest.raises(DurabilityError):
            wal.append("create_node", {"id": "never-acked"})
        # the un-durable record was rolled off the tail; appends continue
        wal.append("create_node", {"id": "b"})
        wal.close()
        assert _recovered_ids(str(tmp_path)) == {"a", "b"}

    def test_seq_not_leaked_by_failed_append(self, tmp_path):
        """The failed append's seq is handed out again: a hole in the sequence
        would make recovery's seq filter silently drop later replays."""
        wal = WAL(str(tmp_path), sync=True)
        s1 = wal.append("create_node", {"id": "a"})
        INJECTOR.arm("fsync_fail", count=1, path_prefix=str(tmp_path))
        with pytest.raises(DurabilityError):
            wal.append("create_node", {"id": "x"})
        s2 = wal.append("create_node", {"id": "b"})
        assert s2 == s1 + 1
        wal.close()


class TestTornTail:
    def test_repairable_torn_tail_keeps_appending(self, tmp_path):
        wal = WAL(str(tmp_path))
        wal.append("create_node", {"id": "a"})
        INJECTOR.arm("torn_tail", count=1, path_prefix=str(tmp_path))
        with pytest.raises(DurabilityError) as e:
            wal.append("create_node", {"id": "torn"})
        assert e.value.kind == "io"
        wal.append("create_node", {"id": "b"})
        wal.close()
        assert _recovered_ids(str(tmp_path)) == {"a", "b"}
        assert wal.stats.append_failures == 1

    def test_unrepairable_torn_tail_disables_appends(self, tmp_path):
        """Crash-shaped: the partial record stays on disk.  Appending past
        it would strand new records behind the corruption, so the WAL
        refuses until reopened — and replay stops at the last good
        record (benign torn tail, no acked data lost)."""
        wal = WAL(str(tmp_path))
        wal.append("create_node", {"id": "a"})
        INJECTOR.arm("torn_tail", count=1, path_prefix=str(tmp_path),
                     repairable=False)
        with pytest.raises(DurabilityError):
            wal.append("create_node", {"id": "torn"})
        with pytest.raises(DurabilityError) as e:
            wal.append("create_node", {"id": "blocked"})
        assert e.value.kind == "wal_disabled"
        wal.close()
        # reopen: the torn bytes are chopped and appends work again
        assert _recovered_ids(str(tmp_path)) == {"a"}
        wal2 = WAL(str(tmp_path))
        wal2.append("create_node", {"id": "b"})
        wal2.close()
        assert _recovered_ids(str(tmp_path)) == {"a", "b"}


class TestPaddingTruncatedCrash:
    def test_crash_inside_trailing_padding_is_repaired(self, tmp_path):
        """A crash can persist the final record whole but cut its 8-byte
        alignment padding short.  The record parses, so torn-tail counters
        never trip — but an append at the unaligned end would strand every
        later record on the next replay.  The open-time repair must detect
        the misaligned tail and complete the padding."""
        import json as _json

        def pad_for(id_: str) -> int:
            payload = len(_json.dumps(
                {"op": "create_node", "data": {"id": id_}, "txid": None},
                separators=(",", ":")).encode())
            return (-(9 + payload + 12)) % 8  # header + payload + footer

        wid = next("b" * k for k in range(1, 9) if pad_for("b" * k) >= 3)
        wal = WAL(str(tmp_path))
        wal.append("create_node", {"id": "a"})
        wal.append("create_node", {"id": wid})
        wal.close()
        path = tmp_path / "wal.log"
        size = path.stat().st_size
        assert size % 8 == 0
        # compute the LAST record's true alignment padding from the frame
        # layout (trailing zeros are ambiguous: the footer's LE seq also
        # ends in zero bytes)
        from nornicdb_tpu_torch.storage.wal import _FOOTER, _HEADER

        raw = path.read_bytes()
        start = aligned_end = 0
        for _payload, _seq, off in WAL._iter_frames(raw):
            start, aligned_end = aligned_end, off
        _magic, _ver, oplen = _HEADER.unpack_from(raw, start)
        unpadded_end = start + _HEADER.size + oplen + _FOOTER.size
        pad = aligned_end - unpadded_end
        if pad == 0:
            pytest.skip("record layout left no trailing padding to cut")
        os.truncate(path, size - min(pad, 3))  # crash inside the padding
        wal2 = WAL(str(tmp_path))
        wal2.append("create_node", {"id": "c"})
        wal2.append("create_node", {"id": "d"})
        wal2.close()
        assert _recovered_ids(str(tmp_path)) == {"a", wid, "c", "d"}


class TestEnospc:
    def test_transient_enospc_recovers(self, tmp_path):
        wal = WAL(str(tmp_path))
        wal.append("create_node", {"id": "a"})
        INJECTOR.arm("enospc", count=3, path_prefix=str(tmp_path))
        for _ in range(3):
            with pytest.raises(DurabilityError) as e:
                wal.append("create_node", {"id": "full"})
            assert e.value.kind == "enospc"
        # disk "frees up" (plan exhausted): next append lands
        wal.append("create_node", {"id": "b"})
        wal.close()
        assert _recovered_ids(str(tmp_path)) == {"a", "b"}

    def test_enospc_errno_preserved_in_chain(self, tmp_path):
        wal = WAL(str(tmp_path))
        INJECTOR.arm("enospc", count=1, path_prefix=str(tmp_path))
        with pytest.raises(DurabilityError) as e:
            wal.append("create_node", {"id": "x"})
        assert isinstance(e.value.__cause__, OSError)
        assert e.value.__cause__.errno == errno.ENOSPC
        wal.close()


class TestEngineIntegration:
    def test_walengine_does_not_apply_unacked_write(self, tmp_path):
        """Log-before-apply: a failed append must leave the in-memory
        engine untouched, so the served state never diverges from what
        recovery can rebuild."""
        wal = WAL(str(tmp_path))
        eng = WALEngine(MemoryEngine(), wal)
        eng.create_node(Node(id="a"))
        INJECTOR.arm("enospc", count=1, path_prefix=str(tmp_path))
        with pytest.raises(DurabilityError):
            eng.create_node(Node(id="rejected"))
        assert eng.node_count() == 1
        eng.create_node(Node(id="b"))
        eng.wal.close()  # crash-ish: skip the close() compaction
        assert _recovered_ids(str(tmp_path)) == {"a", "b"}

    def test_path_prefix_scopes_the_fault(self, tmp_path):
        a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
        wal_a, wal_b = WAL(a_dir), WAL(b_dir)
        INJECTOR.arm("enospc", count=5, path_prefix=a_dir)
        with pytest.raises(DurabilityError):
            wal_a.append("create_node", {"id": "x"})
        wal_b.append("create_node", {"id": "y"})  # other WAL unaffected
        wal_a.close()
        wal_b.close()
        assert _recovered_ids(b_dir) == {"y"}


class TestInjectorMechanics:
    def test_count_exhaustion_and_fired_accounting(self, tmp_path):
        inj = StorageFaultInjector()
        plan = inj.arm("enospc", count=2)
        assert inj.active()
        assert inj._take("enospc", "/any/wal.log") is plan
        assert inj._take("enospc", "/any/wal.log") is plan
        assert inj._take("enospc", "/any/wal.log") is None
        assert not inj.active()
        assert plan.fired == 2
        assert inj.fired["enospc"] == 2

    def test_disarm_by_kind(self):
        inj = StorageFaultInjector()
        inj.arm("enospc", count=5)
        inj.arm("fsync_fail", count=5)
        inj.disarm("enospc")
        assert inj._take("enospc", "p") is None
        assert inj._take("fsync_fail", "p") is not None

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            StorageFaultInjector().arm("bitrot")

    def test_metrics_counter_renders(self, tmp_path):
        from nornicdb_tpu_torch.telemetry.metrics import REGISTRY

        INJECTOR.arm("enospc", count=1, path_prefix=str(tmp_path))
        wal = WAL(str(tmp_path))
        with pytest.raises(DurabilityError):
            wal.append("create_node", {"id": "x"})
        wal.close()
        text = REGISTRY.render_prometheus()
        assert "nornicdb_storage_faults_injected_total" in text
        assert "nornicdb_wal_append_failures_total" in text


# ---- against the JAX package: the same op sequence, the same bytes
import shutil  # noqa: E402

import nornicdb_tpu.storage as jax_storage  # noqa: E402
import nornicdb_tpu.storage.types as jax_types  # noqa: E402
import nornicdb_tpu_torch.storage as port_storage  # noqa: E402
import nornicdb_tpu_torch.storage.types as port_types  # noqa: E402

PKGS = {"jax": jax_storage, "port": port_storage}
T0 = 1_700_000_000.25


def _op_sequence(seed: int, n_nodes: int = 24, dims: int = 16) -> list:
    """Seeded creates, updates, deletes, pending marks and transactions
    with fixed ids and timestamps; one embedding carries NaN and +-inf."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_nodes):
        emb = rng.standard_normal(dims).astype(np.float32)
        if i == 3:
            emb[:3] = [np.nan, np.inf, -np.inf]
        kw = dict(id=f"n{i}", labels=["Doc", f"L{i % 3}"],
                  properties={"content": f"text {i}", "k": i,
                              "w": float(rng.random())},
                  embedding=emb, access_count=i % 4,
                  created_at=T0 + i, updated_at=T0 + i,
                  last_accessed=T0 + i)
        if i % 5 == 0:
            kw["named_embeddings"] = {
                "title": rng.standard_normal(4).astype(np.float32)}
            kw["chunk_embeddings"] = [
                rng.standard_normal(4).astype(np.float32) for _ in range(2)]
            kw["memory_type"] = "episodic"
            kw["decay_score"] = 0.5
        ops.append(("create_node", kw))
    for j in range(3 * n_nodes):
        a, b = (int(x) for x in rng.integers(0, n_nodes, 2))
        ops.append(("create_edge", dict(
            id=f"e{j}", start_node=f"n{a}", end_node=f"n{b}",
            type="KNOWS" if j % 3 else "LIKES",
            properties={"w": float(rng.random())},
            confidence=0.75 if j % 7 == 0 else 1.0,
            auto_generated=j % 7 == 0,
            created_at=T0 + j, updated_at=T0 + j)))
    ops.append(("tx_begin", "t1"))
    for i in range(0, n_nodes, 4):
        ops.append(("update_node", dict(
            id=f"n{i}", labels=["Doc", "Updated"],
            properties={"content": f"new text {i}", "k": -i},
            embedding=rng.standard_normal(dims).astype(np.float32),
            created_at=T0 + i, updated_at=T0 + 100 + i,
            last_accessed=T0 + 100 + i)))
    ops.append(("tx_commit", "t1"))
    for j in range(0, 3 * n_nodes, 5):
        ops.append(("delete_edge", f"e{j}"))
    ops.append(("update_edge", dict(
        id="e1", start_node="n0", end_node="n1", type="RETYPED",
        created_at=T0, updated_at=T0 + 1)))
    ops.append(("delete_node", "n7"))  # cascades its remaining edges
    ops.append(("mark_pending_embed", "n2"))
    ops.append(("mark_pending_embed", "n9"))
    ops.append(("unmark_pending_embed", "n2"))
    ops.append(("tx_begin", "t2"))  # rolled back: recovery omits it
    ops.append(("create_node", dict(id="rolled", created_at=T0,
                                    updated_at=T0, last_accessed=T0)))
    ops.append(("tx_rollback", "t2"))
    return ops


def _apply_ops(pkg, eng, ops) -> None:
    for op, arg in ops:
        if op in ("create_node", "update_node"):
            getattr(eng, op)(pkg.Node(**arg))
        elif op in ("create_edge", "update_edge"):
            getattr(eng, op)(pkg.Edge(**arg))
        elif op.startswith("tx_"):
            getattr(eng, op)(arg)
        elif op == "delete_edge":
            try:
                eng.delete_edge(arg)
            except Exception:  # already gone with a cascaded node
                pass
        else:
            getattr(eng, op)(arg)


def _base_ops(ops) -> list:
    """The op sequence without transaction markers (for the async chain,
    which has no transaction scope) and without the rolled-back write."""
    out, skip = [], False
    for op, arg in ops:
        if op == "tx_begin":
            skip = arg == "t2"
            continue
        if op.startswith("tx_"):
            skip = False
            continue
        if not skip:
            out.append((op, arg))
    return out


@pytest.fixture
def fixed_clock(monkeypatch):
    """Engines stamp ``updated_at`` on update; both packages get one
    clock so their snapshots can be compared byte for byte."""
    for mod in (jax_types, port_types):
        monkeypatch.setattr(mod, "_now", lambda: T0 + 1000.0)


def _state(eng) -> tuple[dict, dict, list]:
    """Every node and edge as its dict, embeddings as raw float32 bytes
    (bitwise: NaN compares equal to itself here), plus the pending ids."""
    nodes = {}
    for n in eng.all_nodes():
        d = n.to_dict()
        for key in ("embedding",):
            if key in d:
                d[key] = np.asarray(n.embedding, np.float32).tobytes()
        if "named_embeddings" in d:
            d["named_embeddings"] = {
                k: np.asarray(v, np.float32).tobytes()
                for k, v in n.named_embeddings.items()}
        if "chunk_embeddings" in d:
            d["chunk_embeddings"] = [np.asarray(v, np.float32).tobytes()
                                     for v in n.chunk_embeddings]
        nodes[n.id] = d
    edges = {e.id: e.to_dict() for e in eng.all_edges()}
    return nodes, edges, list(eng.pending_embed_ids())


class TestBytesAgainstJax:
    @pytest.mark.parametrize("codec", ["python", "native"])
    def test_wal_and_snapshots_byte_identical(self, tmp_path, monkeypatch,
                                              fixed_clock, codec):
        if codec == "native":
            monkeypatch.setenv("NORNICDB_NATIVE_WAL", "1")
        else:
            monkeypatch.delenv("NORNICDB_NATIVE_WAL", raising=False)
        ops = _op_sequence(seed=7)
        half = len(ops) // 2
        files = {}
        for name, pkg in PKGS.items():
            d = str(tmp_path / name)
            wal = pkg.WAL(d)
            assert wal._use_native == (codec == "native")
            eng = pkg.WALEngine(pkg.MemoryEngine(), wal)
            _apply_ops(pkg, eng, ops[:half])
            log1 = open(os.path.join(d, "wal.log"), "rb").read()
            eng.compact()
            snap1 = open(os.path.join(d, "snapshot.json"), "rb").read()
            _apply_ops(pkg, eng, ops[half:])
            log2 = open(os.path.join(d, "wal.log"), "rb").read()
            eng.close()  # final snapshot, log truncated
            snap2 = open(os.path.join(d, "snapshot.json"), "rb").read()
            files[name] = (log1, snap1, log2, snap2)
        assert len(files["port"][0]) > 10_000
        for a, b in zip(files["jax"], files["port"]):
            assert a == b

    def test_native_and_python_codecs_write_the_same_log(
            self, tmp_path, monkeypatch, fixed_clock):
        ops = _op_sequence(seed=3)
        logs = []
        for flag in ("1", "0"):
            monkeypatch.setenv("NORNICDB_NATIVE_WAL", flag)
            d = str(tmp_path / f"native{flag}")
            wal = port_storage.WAL(d)
            assert wal._use_native == (flag == "1")
            _apply_ops(port_storage, port_storage.WALEngine(
                port_storage.MemoryEngine(), wal), ops)
            wal.close()
            logs.append(open(os.path.join(d, "wal.log"), "rb").read())
        assert logs[0] == logs[1]


class TestCrossRecovery:
    @pytest.mark.parametrize("passphrase", ["", "hunter2"],
                             ids=["plain", "encrypted"])
    @pytest.mark.parametrize("writer,reader",
                             [("jax", "port"), ("port", "jax")])
    def test_directory_recovers_in_the_other_package(
            self, tmp_path, fixed_clock, writer, reader, passphrase):
        if passphrase:
            pytest.importorskip("cryptography")
        ops = _base_ops(_op_sequence(seed=11))
        w, r = PKGS[writer], PKGS[reader]
        d = str(tmp_path / "db")
        eng = w.open_storage(d, encryption_passphrase=passphrase)
        _apply_ops(w, eng, ops)
        eng.flush()
        # the image a kill would leave now: WAL only, no snapshot
        shutil.copytree(d, str(tmp_path / "crash"))
        want = _state(eng)
        eng.close()
        assert want[0] and want[1] and want[2] == ["n9"]
        for image, has_snapshot in (("db", True), ("crash", False)):
            path = str(tmp_path / image)
            assert os.path.exists(os.path.join(path, "wal", "snapshot.json")) \
                == has_snapshot
            if passphrase:
                raw = open(os.path.join(path, "wal", "wal.log"), "rb").read()
                assert b"text 1" not in raw
            got = r.open_storage(path, encryption_passphrase=passphrase)
            try:
                assert _state(got) == want
            finally:
                got.close()
