"""SegmentEngine: durable graph engine over the native C++ segment store.

Counterpart of ``nornicdb_tpu/storage/segment.py`` (the port keeps its own
copy and imports nothing of the JAX package). The store is the port's copy
of ``native/segstore.cc`` (``storage/csrc/segstore.cc``), built with ``g++``
at first open into ``storage/_build/`` (see ``storage/native.py``); without
a working compiler, opening raises ``NornicError``. The segment records and
the salt file are the JAX package's, so a directory opens in either.

Behavioral reference: the reference's BadgerEngine
(the upstream NornicDB pkg/storage/badger.go:67 — LSM KV with single-byte key
prefixes 0x01-0x08 for nodes/edges/indexes incl. prefixPendingEmbed 0x07).
Here the KV is storage/csrc/segstore.cc (append-only segments, CRC records,
tombstones, compaction — payload bytes stay in C++ during recovery scans
and compaction). Key prefixes mirror the reference:

    n:<id>  node JSON          e:<id>  edge JSON          p:<id>  pending-embed

Secondary indexes (labels, types, adjacency) are rebuilt in memory on open
by a single native key scan + value reads, like Badger's prefix iterations.
Compaction triggers at tombstone_ratio like the HNSW/corpus rebuild policy.

At-rest encryption (ref: db.go:781-809 — the reference hands a PBKDF2-derived
key to Badger's built-in encryption): values are AES-256-GCM sealed with the
key id as AAD before they reach the native store; keys stay plaintext so the
native prefix scans keep working. Salt lives in seg.salt; a sentinel record
(m:chk) rejects wrong passphrases at open."""

from __future__ import annotations

import ctypes
import json
import logging
import os
import threading
from typing import Iterable, Iterator, Optional

from nornicdb_tpu_torch.errors import AlreadyExistsError, NornicError, NotFoundError
from nornicdb_tpu_torch.storage import native as _native
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node

log = logging.getLogger(__name__)

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        # the port's copy of segstore.cc, built with g++ at first open
        # (storage/native.py); engine locks are never held around this
        path = _native.build_library("segstore")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            log.warning("segstore native library failed to load from %s",
                        path, exc_info=True)
            return None
        lib.seg_open.restype = ctypes.c_void_p
        lib.seg_open.argtypes = [ctypes.c_char_p]
        lib.seg_close.argtypes = [ctypes.c_void_p]
        lib.seg_put.restype = ctypes.c_int32
        lib.seg_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32]
        lib.seg_get.restype = ctypes.c_int64
        lib.seg_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_uint64]
        lib.seg_delete.restype = ctypes.c_int32
        lib.seg_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
        lib.seg_count.restype = ctypes.c_uint64
        lib.seg_count.argtypes = [ctypes.c_void_p]
        lib.seg_tombstones.restype = ctypes.c_uint64
        lib.seg_tombstones.argtypes = [ctypes.c_void_p]
        lib.seg_keys.restype = ctypes.c_int64
        lib.seg_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_uint64]
        lib.seg_compact.restype = ctypes.c_int32
        lib.seg_compact.argtypes = [ctypes.c_void_p]
        lib.seg_set_sync.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        _lib = lib
        return _lib


def segment_store_available() -> bool:
    return _load_lib() is not None


class _SegKV:
    """Thin ctypes wrapper over one segment store handle."""

    def __init__(self, path: str, sync: bool = False):
        lib = _load_lib()
        if lib is None:
            raise NornicError("native segment store unavailable (g++ missing?)")
        self._lib = lib
        self._h = lib.seg_open(path.encode())
        if not self._h:
            raise NornicError(f"failed to open segment store at {path}")
        if sync:
            lib.seg_set_sync(self._h, 1)

    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.seg_put(self._h, key, len(key), value, len(value)) != 0:
            raise NornicError("segment store write failed")

    _GET_CAP = 4096

    def get(self, key: bytes) -> Optional[bytes]:
        cap = self._GET_CAP
        while True:
            buf = (ctypes.c_uint8 * cap)()
            n = self._lib.seg_get(self._h, key, len(key), buf, cap)
            if n == -1:
                return None
            if n == -2:
                raise NornicError("segment store read failed")
            if n < -2:  # -(len)-2: grow and retry (atomic per attempt)
                cap = -int(n) - 2
                continue
            return bytes(buf[: int(n)])

    def delete(self, key: bytes) -> bool:
        return self._lib.seg_delete(self._h, key, len(key)) == 0

    def count(self) -> int:
        return int(self._lib.seg_count(self._h))

    def tombstones(self) -> int:
        return int(self._lib.seg_tombstones(self._h))

    def keys(self, prefix: bytes = b"") -> list[bytes]:
        import struct as _struct

        cap = 1 << 16
        while True:
            buf = (ctypes.c_uint8 * cap)()
            n = self._lib.seg_keys(self._h, prefix, len(prefix), buf, cap)
            if n < 0:
                cap = -int(n)
                continue
            raw = bytes(buf[: int(n)])
            out = []
            off = 0
            while off + 4 <= len(raw):  # [u32 klen][key] — any byte is legal
                (klen,) = _struct.unpack_from("<I", raw, off)
                off += 4
                out.append(raw[off : off + klen])
                off += klen
            return out

    def compact(self) -> None:
        rc = self._lib.seg_compact(self._h)
        if rc == -3:
            return  # another thread's compaction is already running
        if rc != 0:
            raise NornicError("segment store compaction failed")

    def close(self) -> None:
        if self._h:
            self._lib.seg_close(self._h)
            self._h = None


class _EncKV:
    """Value-encrypting view over _SegKV: AES-256-GCM with the record key as
    AAD (so a ciphertext can't be replayed under a different key). Keys are
    left plaintext — native prefix scans and compaction never see plaintext
    values (ref: Badger's value-only encryption, db.go:781-809)."""

    def __init__(self, kv: "_SegKV", enc) -> None:
        self._kv = kv
        self._enc = enc

    def put(self, key: bytes, value: bytes) -> None:
        self._kv.put(key, self._enc.encrypt(value, aad=key))

    def get(self, key: bytes) -> Optional[bytes]:
        raw = self._kv.get(key)
        if raw is None:
            return None
        try:
            return self._enc.decrypt(raw, aad=key)
        except Exception as e:
            raise NornicError(
                f"segment store decrypt failed for {key!r} (wrong passphrase "
                f"or corrupted data): {e}"
            ) from e

    def __getattr__(self, name: str):
        return getattr(self._kv, name)


class SegmentEngine(Engine):
    """(ref: BadgerEngine badger.go:67 — the durable engine role)"""

    COMPACT_RATIO = 0.5

    _CHK_KEY = b"m:chk"
    _CHK_PLAINTEXT = b"nornicdb-segment"

    def __init__(self, data_dir: str, sync: bool = False,
                 passphrase: Optional[str] = None,
                 auto_compact_interval: float = 30.0):
        super().__init__()
        os.makedirs(data_dir, exist_ok=True)
        self._kv = _SegKV(os.path.join(data_dir, "graph.seg"), sync=sync)
        salt_path = os.path.join(data_dir, "seg.salt")
        try:
            if passphrase:
                from nornicdb_tpu_torch.encryption import (
                    Encryptor,
                    load_or_create_salt,
                )

                chk = self._kv.get(self._CHK_KEY)
                if chk is None and self._kv.count() > 0:
                    # existing plaintext store: refuse BEFORE persisting a
                    # salt/sentinel, or the intact data becomes unreachable
                    # under both open modes
                    raise NornicError(
                        "segment store at %r holds unencrypted data; "
                        "encrypting an existing store in place is not "
                        "supported (export, then re-import into a store "
                        "created with the passphrase)" % data_dir
                    )
                salt = load_or_create_salt(salt_path)
                enc = Encryptor.from_passphrase(passphrase, salt)
                if chk is None:
                    self._kv.put(
                        self._CHK_KEY,
                        enc.encrypt(self._CHK_PLAINTEXT, aad=self._CHK_KEY))
                else:
                    try:
                        ok = (enc.decrypt(chk, aad=self._CHK_KEY)
                              == self._CHK_PLAINTEXT)
                    except Exception:
                        # expected on a wrong passphrase (AEAD tag mismatch)
                        # but the trace distinguishes that from a corrupt
                        # check blob when operators debug an unopenable store
                        log.debug("passphrase check decrypt failed",
                                  exc_info=True)
                        ok = False
                    if not ok:
                        raise NornicError(
                            "segment store: wrong encryption passphrase"
                        )
                self._kv = _EncKV(self._kv, enc)
            elif os.path.exists(salt_path):
                raise NornicError(
                    "segment store at %r is encrypted; an "
                    "encryption_passphrase is required to open it" % data_dir
                )
        except BaseException:
            self._kv.close()
            raise
        self._lock = threading.RLock()
        # in-memory secondary indexes (ref: Badger prefix scans)
        self._by_label: dict[str, set[str]] = {}
        self._by_type: dict[str, set[str]] = {}
        self._out: dict[str, set[str]] = {}
        self._in: dict[str, set[str]] = {}
        self._node_count = 0
        self._edge_count = 0
        try:
            self._rebuild_indexes()
        except BaseException:
            # a corrupted record surfacing here must not leak the native
            # handle/fd (callers may retry open in a loop)
            self._kv.close()
            raise
        # GC: every mutation path ratio-checks inline (_maybe_compact at
        # the create/update/delete sites), which covers steady state; a
        # post-recovery pass collects garbage a previous run left behind;
        # and a background thread (the role of Badger's value-log GC
        # ticker, pkg/storage/badger.go:67) sweeps periodically. The
        # native compaction is two-phase/online, so the sweep blocks
        # readers only for the write-delta replay.
        self._maybe_compact()
        self._compact_stop = threading.Event()
        self._compact_thread: Optional[threading.Thread] = None
        if auto_compact_interval > 0:
            self._compact_thread = threading.Thread(
                target=self._compact_loop, args=(auto_compact_interval,),
                daemon=True, name="seg-compact",
            )
            self._compact_thread.start()

    def _compact_loop(self, interval: float) -> None:
        while not self._compact_stop.wait(interval):
            try:
                # ratio check without the engine lock; the native two-phase
                # compaction serializes against writers itself
                if (self._kv.tombstones() / max(self._kv.count(), 1)
                        > self.COMPACT_RATIO):
                    self._kv.compact()
            except Exception:
                # storage may be mid-close; the next tick retries
                log.warning("background segment compaction failed",
                            exc_info=True)

    # -- recovery ------------------------------------------------------------
    def _rebuild_indexes(self) -> None:
        for key in self._kv.keys(b"n:"):
            raw = self._kv.get(key)
            if raw is None:
                continue
            node = Node.from_dict(json.loads(raw))
            for lbl in node.labels:
                self._by_label.setdefault(lbl, set()).add(node.id)
            self._node_count += 1
        for key in self._kv.keys(b"e:"):
            raw = self._kv.get(key)
            if raw is None:
                continue
            edge = Edge.from_dict(json.loads(raw))
            self._by_type.setdefault(edge.type, set()).add(edge.id)
            self._out.setdefault(edge.start_node, set()).add(edge.id)
            self._in.setdefault(edge.end_node, set()).add(edge.id)
            self._edge_count += 1

    def _maybe_compact(self) -> None:
        # no `live and` guard: a store whose every record was deleted
        # (live == 0, tombstones > 0) is exactly the one most worth
        # compacting — the old guard let that garbage grow unbounded
        if self._kv.tombstones() / max(self._kv.count(), 1) > self.COMPACT_RATIO:
            self._kv.compact()

    # -- nodes ----------------------------------------------------------------
    @staticmethod
    def _nk(node_id: str) -> bytes:
        return b"n:" + node_id.encode()

    @staticmethod
    def _ek(edge_id: str) -> bytes:
        return b"e:" + edge_id.encode()

    def create_node(self, node: Node) -> Node:
        with self._lock:
            key = self._nk(node.id)
            if self._kv.get(key) is not None:
                raise AlreadyExistsError(f"node {node.id} already exists")
            stored = node.copy()
            self._kv.put(key, json.dumps(stored.to_dict()).encode())
            for lbl in stored.labels:
                self._by_label.setdefault(lbl, set()).add(stored.id)
            self._node_count += 1
        self._emit("node_created", stored.copy())
        return stored.copy()

    def get_node(self, node_id: str) -> Node:
        raw = self._kv.get(self._nk(node_id))
        if raw is None:
            raise NotFoundError(f"node {node_id} not found")
        return Node.from_dict(json.loads(raw))

    def update_node(self, node: Node) -> Node:
        with self._lock:
            old = self.get_node(node.id)  # raises if absent
            import time as _time

            stored = node.copy()
            stored.created_at = old.created_at
            stored.updated_at = _time.time()
            for lbl in old.labels:
                self._by_label.get(lbl, set()).discard(old.id)
            for lbl in stored.labels:
                self._by_label.setdefault(lbl, set()).add(stored.id)
            self._kv.put(self._nk(node.id), json.dumps(stored.to_dict()).encode())
            self._maybe_compact()  # overwrites count as garbage too
        self._emit("node_updated", stored.copy())
        return stored.copy()

    def delete_node(self, node_id: str) -> None:
        with self._lock:
            node = self.get_node(node_id)
            attached = list(
                self._out.get(node_id, set()) | self._in.get(node_id, set())
            )
            removed_edges = []
            for eid in attached:
                raw = self._kv.get(self._ek(eid))
                if raw is None:
                    continue
                edge = Edge.from_dict(json.loads(raw))
                self._kv.delete(self._ek(eid))
                self._by_type.get(edge.type, set()).discard(eid)
                self._out.get(edge.start_node, set()).discard(eid)
                self._in.get(edge.end_node, set()).discard(eid)
                self._edge_count -= 1
                removed_edges.append(edge)
            self._kv.delete(self._nk(node_id))
            self._kv.delete(b"p:" + node_id.encode())
            for lbl in node.labels:
                self._by_label.get(lbl, set()).discard(node_id)
            self._node_count -= 1
            self._maybe_compact()
        for e in removed_edges:
            self._emit("edge_deleted", e)
        self._emit("node_deleted", node)

    def get_nodes_by_label(self, label: str) -> list[Node]:
        with self._lock:
            ids = sorted(self._by_label.get(label, set()))
        out = []
        for i in ids:
            try:
                out.append(self.get_node(i))
            except NotFoundError:
                pass
        return out

    def all_nodes(self) -> Iterator[Node]:
        # snapshot at call time (the badger engine iterates inside one txn
        # view, ref: badger_test.go TestGetAllNodes): a concurrent delete
        # must not change what an already-started iteration yields
        with self._lock:
            snapshot = [raw for raw in
                        (self._kv.get(k) for k in self._kv.keys(b"n:"))
                        if raw is not None]
        # decode lazily: consumers that stop early (LIMIT 1 scans) must not
        # pay a full-store JSON parse; the raw snapshot above already gives
        # the call-time view
        return (Node.from_dict(json.loads(r)) for r in snapshot)

    # -- edges -----------------------------------------------------------------
    def create_edge(self, edge: Edge) -> Edge:
        with self._lock:
            if self._kv.get(self._ek(edge.id)) is not None:
                raise AlreadyExistsError(f"edge {edge.id} already exists")
            if self._kv.get(self._nk(edge.start_node)) is None:
                raise NotFoundError(f"start node {edge.start_node} not found")
            if self._kv.get(self._nk(edge.end_node)) is None:
                raise NotFoundError(f"end node {edge.end_node} not found")
            stored = edge.copy()
            self._kv.put(self._ek(edge.id), json.dumps(stored.to_dict()).encode())
            self._by_type.setdefault(stored.type, set()).add(stored.id)
            self._out.setdefault(stored.start_node, set()).add(stored.id)
            self._in.setdefault(stored.end_node, set()).add(stored.id)
            self._edge_count += 1
        self._emit("edge_created", stored.copy())
        return stored.copy()

    def get_edge(self, edge_id: str) -> Edge:
        raw = self._kv.get(self._ek(edge_id))
        if raw is None:
            raise NotFoundError(f"edge {edge_id} not found")
        return Edge.from_dict(json.loads(raw))

    def update_edge(self, edge: Edge) -> Edge:
        with self._lock:
            old = self.get_edge(edge.id)
            import time as _time

            stored = edge.copy()
            stored.created_at = old.created_at
            stored.updated_at = _time.time()
            if old.type != stored.type:
                self._by_type.get(old.type, set()).discard(old.id)
                self._by_type.setdefault(stored.type, set()).add(stored.id)
            self._kv.put(self._ek(edge.id), json.dumps(stored.to_dict()).encode())
            self._maybe_compact()
        self._emit("edge_updated", stored.copy())
        return stored.copy()

    def delete_edge(self, edge_id: str) -> None:
        with self._lock:
            edge = self.get_edge(edge_id)
            self._kv.delete(self._ek(edge_id))
            self._by_type.get(edge.type, set()).discard(edge_id)
            self._out.get(edge.start_node, set()).discard(edge_id)
            self._in.get(edge.end_node, set()).discard(edge_id)
            self._edge_count -= 1
            self._maybe_compact()
        self._emit("edge_deleted", edge)

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        with self._lock:
            ids = sorted(self._by_type.get(edge_type, set()))
        out = []
        for i in ids:
            try:
                out.append(self.get_edge(i))
            except NotFoundError:
                pass
        return out

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        with self._lock:
            ids = sorted(self._out.get(node_id, set()))
        return [e for e in (self._safe_edge(i) for i in ids) if e]

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        with self._lock:
            ids = sorted(self._in.get(node_id, set()))
        return [e for e in (self._safe_edge(i) for i in ids) if e]

    def _safe_edge(self, edge_id: str) -> Optional[Edge]:
        try:
            return self.get_edge(edge_id)
        except NotFoundError:
            return None

    def all_edges(self) -> Iterator[Edge]:
        # snapshot at call time, same contract as all_nodes (badger
        # iterates inside one txn view): concurrent deletes must not
        # change what an already-started iteration yields
        with self._lock:
            snapshot = [raw for raw in
                        (self._kv.get(k) for k in self._kv.keys(b"e:"))
                        if raw is not None]
        return (Edge.from_dict(json.loads(r)) for r in snapshot)

    # -- counts / pending ---------------------------------------------------------
    def node_count(self) -> int:
        with self._lock:
            return self._node_count

    def count_nodes_by_label(self, label: str) -> int:
        with self._lock:
            return len(self._by_label.get(label, ()))

    def count_edges_by_type(self, edge_type: str) -> int:
        with self._lock:
            return len(self._by_type.get(edge_type, ()))

    def edge_count(self) -> int:
        with self._lock:
            return self._edge_count

    def mark_pending_embed(self, node_id: str) -> None:
        if self._kv.get(self._nk(node_id)) is not None:
            import time

            self._kv.put(b"p:" + node_id.encode(), str(time.time()).encode())

    def unmark_pending_embed(self, node_id: str) -> None:
        self._kv.delete(b"p:" + node_id.encode())

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        entries = []
        for key in self._kv.keys(b"p:"):
            raw = self._kv.get(key)
            ts = float(raw) if raw else 0.0
            entries.append((ts, key[2:].decode()))
        entries.sort()
        ids = [i for _, i in entries]
        return ids[:limit] if limit > 0 else ids

    def compact(self) -> None:
        with self._lock:
            self._kv.compact()

    def close(self) -> None:
        self._compact_stop.set()
        if self._compact_thread is not None:
            self._compact_thread.join(timeout=5.0)
        with self._lock:
            self._kv.close()
