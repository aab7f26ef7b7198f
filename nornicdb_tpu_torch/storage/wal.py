"""Write-ahead log with CRC-validated atomic records, snapshots and
transaction-aware recovery.

Counterpart of ``nornicdb_tpu/storage/wal.py`` (the port keeps its own copy
and imports nothing of the JAX package). The on-disk format is the JAX
package's, byte for byte, so a data directory written by one package opens
in the other.

Behavioral reference: the upstream NornicDB pkg/storage/wal.go,
wal_atomic_record.go:8-39 (record framing: magic, version, length, payload,
CRC32, trailer, 8-byte alignment), wal.go:819-938 (CreateSnapshot /
TruncateAfterSnapshot), wal.go:1512-1845 (recovery incl. incomplete-tx undo).

Record layout (own format, same guarantees as the reference's v2 records):

    [magic:4 = b"NWAL"][version:1][oplen:4 LE][payload: oplen bytes]
    [crc32:4 LE over payload][seq:8 LE][padding to 8-byte boundary]

A torn tail (partial record, bad magic, or CRC mismatch) terminates replay at
the last good record; preceding records are preserved.
"""

from __future__ import annotations

import errno as _errno
import json
import logging
import os
import struct
import threading
import time as _time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.errors import DurabilityError, WALCorruptionError
from nornicdb_tpu_torch.storage import native as _native
from nornicdb_tpu_torch.storage.faults import INJECTOR as _FAULTS
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

log = logging.getLogger(__name__)

_WAL_APPEND_HIST = _REGISTRY.histogram(
    "nornicdb_wal_append_seconds",
    "WAL append latency (encode + write + flush, incl. fsync when sync=True)",
)
_WAL_FSYNC_HIST = _REGISTRY.histogram(
    "nornicdb_wal_fsync_seconds",
    "WAL fsync latency (sync=True appends only)",
)
_WAL_APPEND_FAILURES = _REGISTRY.counter(
    "nornicdb_wal_append_failures_total",
    "WAL appends that failed durability (write/fsync error, ENOSPC) and "
    "were rolled back off the tail — surfaced to callers as DurabilityError",
    labels=("kind",),
)
for _k in ("enospc", "io", "fsync"):
    _WAL_APPEND_FAILURES.labels(_k)  # eager cells: render 0, not absent
del _k

MAGIC = b"NWAL"
VERSION = 1
_HEADER = struct.Struct("<4sBI")  # magic, version, oplen
_FOOTER = struct.Struct("<IQ")  # crc32, seq

# Operation kinds
OP_CREATE_NODE = "create_node"
OP_UPDATE_NODE = "update_node"
OP_DELETE_NODE = "delete_node"
OP_CREATE_EDGE = "create_edge"
OP_UPDATE_EDGE = "update_edge"
OP_DELETE_EDGE = "delete_edge"
OP_TX_BEGIN = "tx_begin"
OP_TX_COMMIT = "tx_commit"
OP_TX_ROLLBACK = "tx_rollback"
OP_MARK_PENDING = "mark_pending_embed"
OP_UNMARK_PENDING = "unmark_pending_embed"


@dataclass
class WALEntry:
    seq: int
    op: str
    data: dict[str, Any] = field(default_factory=dict)
    txid: Optional[str] = None

    def encode(self, encryptor=None, use_native: bool = False) -> bytes:
        """Frame one record. ``use_native`` is resolved ONCE by the owning
        WAL at init (outside any lock): deciding here via _native.enabled()
        would put the first-call dlopen — and possibly a compiler build —
        inside WAL.append's critical section. Both codecs emit identical
        bytes, so a bare encode() (tests, tooling) is format-compatible."""
        payload = json.dumps(
            {"op": self.op, "data": self.data, "txid": self.txid},
            separators=(",", ":"),
        ).encode("utf-8")
        if encryptor is not None:
            payload = encryptor.encrypt(payload)
        if use_native:
            native_rec = _native.encode(payload, self.seq)
            if native_rec is not None:
                return native_rec
        rec = _HEADER.pack(MAGIC, VERSION, len(payload)) + payload
        rec += _FOOTER.pack(zlib.crc32(payload) & 0xFFFFFFFF, self.seq)
        pad = (-len(rec)) % 8
        return rec + b"\x00" * pad


def apply_storage_op(engine: Engine, op: str, d: dict[str, Any]) -> None:
    """Apply one logged storage op. Shared by WAL recovery and the
    replication layer (HA shipping, Raft apply) so the dispatch never forks.

    Idempotent-best-effort: duplicate create / missing delete after a
    snapshot race is not fatal (ref: wal.go replay tolerates
    AlreadyExists/NotFound during recovery)."""
    try:
        if op == OP_CREATE_NODE:
            engine.create_node(Node.from_dict(d))
        elif op == OP_UPDATE_NODE:
            engine.update_node(Node.from_dict(d))
        elif op == OP_DELETE_NODE:
            engine.delete_node(d["id"])
        elif op == OP_CREATE_EDGE:
            engine.create_edge(Edge.from_dict(d))
        elif op == OP_UPDATE_EDGE:
            engine.update_edge(Edge.from_dict(d))
        elif op == OP_DELETE_EDGE:
            engine.delete_edge(d["id"])
        elif op == OP_MARK_PENDING:
            engine.mark_pending_embed(d["id"])
        elif op == OP_UNMARK_PENDING:
            engine.unmark_pending_embed(d["id"])
    except Exception:
        # tolerated (duplicate create / missing delete after a snapshot
        # race), but silent data divergence is undebuggable — leave a trace
        log.debug("replayed op %s skipped", op, exc_info=True)


@dataclass
class WALStats:
    entries: int = 0
    bytes_written: int = 0
    snapshots: int = 0
    recovered_entries: int = 0
    truncated_tail_records: int = 0
    # appends that failed durability and were rolled back (DurabilityError
    # surfaced to the caller; nothing was acked)
    append_failures: int = 0
    # degraded mode (ref: wal_degraded.go): recovery stopped at MID-FILE
    # corruption with real records after it — data was lost, unlike the
    # benign torn-tail case. Surfaced via /status and /admin/stats.
    degraded: bool = False
    corruption_info: str = ""


class WAL:
    """Append-only log file + snapshot management (ref: storage.WAL wal.go:263).

    With a passphrase, record payloads and snapshots are encrypted at rest
    with AES-256-GCM (the reference delegates at-rest encryption to Badger
    with a PBKDF2-derived key, db.go:781-809; here the WAL is the storage of
    record so it encrypts its own payloads). The PBKDF2 salt persists next
    to the log.
    """

    LOG_NAME = "wal.log"
    SNAPSHOT_NAME = "snapshot.json"
    SALT_NAME = "wal.salt"

    def __init__(self, directory: str, sync: bool = False,
                 passphrase: Optional[str] = None):
        self.dir = directory
        self.sync = sync
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, self.LOG_NAME)
        self._lock = threading.Lock()
        self._tail_dirty = False
        # (scan end offset, file length) from the most recent read_all —
        # lets the open-time misalignment check reuse the scan it already
        # paid for instead of re-reading the whole log
        self._tail_scan = (0, 0)
        # resolve the native codec HERE, before any append can run: the
        # first _native.enabled() call dlopens (and may `make`-build) the
        # library — work that must never happen inside the append lock
        self._use_native = _native.enabled()
        self.stats = WALStats()
        self._encryptor = None
        if passphrase:
            from nornicdb_tpu_torch.encryption import Encryptor, load_or_create_salt

            salt = load_or_create_salt(os.path.join(directory, self.SALT_NAME))
            self._encryptor = Encryptor.from_passphrase(passphrase, salt)
        self._seq = self._scan_last_seq()
        # seq must stay monotonic across restarts even when compact() left an
        # empty log: recovery filters replay on `seq > snapshot seq`, so a
        # counter reseeded from the (empty) log alone would hand out seqs the
        # filter silently drops — losing every write acked since the restart
        try:
            snap = self.load_snapshot()
            if snap is not None:
                self._seq = max(self._seq, int(snap.get("seq", 0)))
        except Exception:
            # corrupt/locked snapshot surfaces at recover(), not here
            log.debug("snapshot seq probe failed during WAL open",
                      exc_info=True)
        if self.stats.degraded:
            self._quarantine_corrupt_log()
        # benign torn tail (crash mid-append): the partial record must be
        # repaired before the FIRST append — otherwise the new record
        # lands on the torn bytes and every later record is stranded
        # behind them on the following replay (same contract as the raft
        # durable log's open path, raft.py).  Detection compares the file
        # length against the aligned end of the intact prefix, which also
        # catches a crash INSIDE the final record's alignment padding
        # (the record parses fine, so truncated_tail_records alone would
        # miss it).  Deferred to append() so read-only opens keep the
        # damaged bytes for strict-mode corruption diagnostics.
        self._needs_chop = (not self.stats.degraded
                            and self._tail_misaligned())
        self._f = open(self._path, "ab")

    # -- append ------------------------------------------------------------
    def append(self, op: str, data: dict[str, Any], txid: Optional[str] = None) -> int:
        t0 = _time.perf_counter()
        with _tracer.span("wal.append", {"op": op}):
            with self._lock:
                if self._tail_dirty:
                    # a failed append could not be repaired: appending past
                    # the damaged region would strand every new record
                    # behind it on replay (read_all stops at corruption)
                    raise DurabilityError(
                        "WAL tail damaged by an unrepaired append failure; "
                        "reopen the WAL to recover", kind="wal_disabled",
                    )
                if self._needs_chop:
                    self._needs_chop = False
                    self._f.close()
                    repaired = self._chop_torn_tail()
                    self._f = open(self._path, "ab")
                    if not repaired:
                        raise DurabilityError(
                            "WAL tail repair failed at first append; "
                            "reopen the WAL to retry", kind="wal_disabled",
                        )
                self._seq += 1
                entry = WALEntry(seq=self._seq, op=op, data=data, txid=txid)
                raw = entry.encode(self._encryptor, use_native=self._use_native)
                pos = self._f.tell()
                try:
                    _FAULTS.check_write(self._path, self._f, raw)
                    self._f.write(raw)
                    self._f.flush()
                    if self.sync:
                        # deliberate fsync under the WAL lock: sync=True is
                        # the durability mode — records must hit disk in
                        # seq order
                        t_fsync = _time.perf_counter()
                        try:
                            _FAULTS.check_fsync(self._path)
                            os.fsync(self._f.fileno())  # nornlint: disable=NL-LK02
                        except OSError as e:
                            # tag the failing stage: the message of a real
                            # fsync EIO carries no hint of where it came
                            # from, and the failure-kind metric must not
                            # depend on string contents
                            e.nornicdb_stage = "fsync"
                            raise
                        _WAL_FSYNC_HIST.observe(_time.perf_counter() - t_fsync)
                except OSError as e:
                    self._abort_append(pos, e)  # raises DurabilityError
                self.stats.entries += 1
                self.stats.bytes_written += len(raw)
                seq = self._seq
        _WAL_APPEND_HIST.observe(_time.perf_counter() - t0)
        return seq

    def _abort_append(self, pos: int, cause: OSError) -> None:
        """A record failed to become durable (write error, torn tail,
        ENOSPC, fsync failure).  Roll the append back so the log ends at
        its last good record: the seq is handed back (recovery filters on
        seq ordering, so a hole would silently drop later replays) and any
        partially-written tail bytes are truncated away.  Always raises
        :class:`DurabilityError` — the caller must NOT ack the write."""
        self._seq -= 1
        self.stats.append_failures += 1
        kind = ("enospc" if cause.errno == _errno.ENOSPC
                else getattr(cause, "nornicdb_stage", None) or "io")
        _WAL_APPEND_FAILURES.labels(kind).inc()
        repairable = getattr(cause, "nornicdb_repairable", True)
        if repairable:
            try:
                self._f.seek(pos)
                self._f.truncate(pos)
                self._f.flush()
            except OSError:
                log.error("WAL tail repair after failed append at offset %d "
                          "also failed; disabling appends until reopen",
                          pos, exc_info=True)
                self._tail_dirty = True
        else:
            # crash-shaped: the torn bytes stay on disk; replay stops at
            # the last good record (benign torn tail) but appending past
            # them would strand new records — require a reopen
            self._tail_dirty = True
        raise DurabilityError(
            f"WAL append not durable: {cause}", kind=kind,
        ) from cause

    @property
    def last_seq(self) -> int:
        return self._seq

    def _decrypt(self, payload: bytes) -> bytes:
        if self._encryptor is None:
            return payload
        return self._encryptor.decrypt(payload)

    # -- read / replay -----------------------------------------------------
    def read_all(self, strict: bool = False) -> list[WALEntry]:
        """Read every valid record. A corrupt/torn tail stops the scan; with
        strict=True it raises WALCorruptionError instead (ref: corruption
        diagnostics wal.go:75-110)."""
        entries: list[WALEntry] = []
        try:
            with open(self._path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            self._tail_scan = (0, 0)
            return entries
        # opt-in native path: C++ does framing + CRC sweep; Python parses JSON
        native_out = _native.scan(buf) if _native.enabled() else None
        if native_out is not None:
            records, valid_bytes = native_out
            self._tail_scan = (valid_bytes, len(buf))
            if valid_bytes < len(buf):
                if strict:
                    raise WALCorruptionError(
                        f"bad record at offset {valid_bytes}"
                    )
                self.stats.truncated_tail_records += 1
                self._note_corruption(valid_bytes, len(buf), buf)
            for idx, (payload, seq) in enumerate(records):
                try:
                    obj = json.loads(self._decrypt(payload).decode("utf-8"))
                except Exception:
                    if strict:
                        raise WALCorruptionError("bad payload")
                    self.stats.truncated_tail_records += 1
                    if idx < len(records) - 1:
                        # CRC-valid records FOLLOW the undecodable one:
                        # committed data is being dropped -> degraded
                        self.stats.degraded = True
                        self.stats.corruption_info = (
                            f"undecodable payload at record {idx}; "
                            f"{len(records) - idx - 1} later records skipped"
                        )
                    break
                entries.append(
                    WALEntry(seq=seq, op=obj["op"], data=obj.get("data", {}),
                             txid=obj.get("txid"))
                )
            return entries
        off = 0
        n = len(buf)
        while off + _HEADER.size <= n:
            magic, ver, oplen = _HEADER.unpack_from(buf, off)
            body_end = off + _HEADER.size + oplen + _FOOTER.size
            if magic != MAGIC or ver != VERSION or body_end > n:
                if strict:
                    raise WALCorruptionError(f"bad record header at offset {off}")
                self.stats.truncated_tail_records += 1
                self._note_corruption(off, n, buf)
                break
            payload = buf[off + _HEADER.size : off + _HEADER.size + oplen]
            crc, seq = _FOOTER.unpack_from(buf, off + _HEADER.size + oplen)
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                if strict:
                    raise WALCorruptionError(f"CRC mismatch at offset {off}")
                self.stats.truncated_tail_records += 1
                self._note_corruption(off, n, buf)
                break
            try:
                obj = json.loads(self._decrypt(payload).decode("utf-8"))
            except Exception:
                if strict:
                    raise WALCorruptionError(f"bad payload at offset {off}")
                self.stats.truncated_tail_records += 1
                self._note_corruption(off, n, buf)
                break
            entries.append(
                WALEntry(seq=seq, op=obj["op"], data=obj.get("data", {}), txid=obj.get("txid"))
            )
            off = body_end + ((-(body_end - off)) % 8)
        # where the scan actually stopped vs the file length: the open-time
        # misalignment check compares these (clean exit leaves off at the
        # aligned end; any break leaves it at the bad record's start)
        self._tail_scan = (off, n)
        return entries

    def _note_corruption(self, offset: int, total: int,
                         buf: Optional[bytes] = None) -> None:
        """Classify a recovery stop (ref: wal_degraded.go). A torn tail
        (crash mid-append: the FINAL record is partial) is expected and
        benign. If any intact record exists after the corruption point,
        committed data was lost -> degraded mode."""
        if buf is None or not self._has_valid_record_after(buf, offset):
            return
        self.stats.degraded = True
        self.stats.corruption_info = (
            f"unreadable record at offset {offset} with intact records "
            f"after it; {total - offset} bytes were skipped"
        )

    @staticmethod
    def _has_valid_record_after(buf: bytes, offset: int) -> bool:
        pos = buf.find(MAGIC, offset + 1)
        while pos != -1:
            if pos + _HEADER.size <= len(buf):
                magic, ver, oplen = _HEADER.unpack_from(buf, pos)
                end = pos + _HEADER.size + oplen + _FOOTER.size
                if ver == VERSION and end <= len(buf):
                    payload = buf[pos + _HEADER.size : pos + _HEADER.size + oplen]
                    crc, _seq = _FOOTER.unpack_from(buf, pos + _HEADER.size + oplen)
                    if zlib.crc32(payload) & 0xFFFFFFFF == crc:
                        return True
            pos = buf.find(MAGIC, pos + 1)
        return False

    def _quarantine_corrupt_log(self) -> None:
        """Degraded open: appending after a corrupt region would strand
        every new record behind it on the next recovery (read_all stops at
        the corruption). Preserve the damaged file for forensics, then
        rewrite the log with only the readable records so subsequent
        appends stay recoverable. The degraded flag stays set."""
        n = 1
        while os.path.exists(f"{self._path}.corrupt-{n}"):
            n += 1
        os.replace(self._path, f"{self._path}.corrupt-{n}")
        try:
            with open(f"{self._path}.corrupt-{n}", "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            buf = b""
        with open(self._path, "wb") as out:
            for e in self._parse_buffer(buf):
                out.write(e.encode(self._encryptor, use_native=self._use_native))
            out.flush()
            os.fsync(out.fileno())
        self.stats.corruption_info += (
            f"; valid prefix rewritten, damaged log kept as "
            f"{os.path.basename(self._path)}.corrupt-{n}"
        )

    @staticmethod
    def _iter_frames(buf: bytes):
        """Yield ``(payload, seq, end_off)`` for each intact leading
        record, stopping at the first bad header / short body / CRC
        mismatch — the frame-walk shared by the torn-tail repair and the
        quarantine salvage scan.  (``read_all`` keeps its own walk: it
        needs per-stop diagnostics — WHICH offset failed and why — for
        strict mode and degraded-mode classification.)  The last yielded
        ``end_off`` is the aligned intact-prefix length and may exceed
        ``len(buf)`` when the final record's padding was cut short."""
        off = 0
        n = len(buf)
        while off + _HEADER.size <= n:
            magic, ver, oplen = _HEADER.unpack_from(buf, off)
            body_end = off + _HEADER.size + oplen + _FOOTER.size
            if magic != MAGIC or ver != VERSION or body_end > n:
                return
            payload = buf[off + _HEADER.size : off + _HEADER.size + oplen]
            crc, seq = _FOOTER.unpack_from(buf, off + _HEADER.size + oplen)
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                return
            off = body_end + ((-(body_end - off)) % 8)
            yield payload, seq, off

    def _parse_buffer(self, buf: bytes) -> list[WALEntry]:
        """Parse records from a raw buffer (decrypted), stopping at the
        first unreadable record. Used by quarantine; does not touch stats."""
        entries: list[WALEntry] = []
        for payload, seq, off in self._iter_frames(buf):
            try:
                obj = json.loads(self._decrypt(payload).decode("utf-8"))
            except Exception:
                # corrupt record: keep only the prefix (quarantine semantics)
                log.warning("undecodable WAL record before offset %d stops "
                            "the salvage scan", off, exc_info=True)
                break
            entries.append(WALEntry(seq=seq, op=obj["op"],
                                    data=obj.get("data", {}),
                                    txid=obj.get("txid")))
        return entries

    def _intact_prefix_end(self, buf: bytes) -> int:
        """Aligned end offset of the intact leading records.  May exceed
        ``len(buf)`` when a crash cut the final record's alignment
        padding short (the record itself is whole)."""
        off = 0
        for _payload, _seq, off in self._iter_frames(buf):
            pass
        return off

    def _tail_misaligned(self) -> bool:
        """True when the file does not end exactly at the aligned end of
        its intact prefix — torn garbage after it, or short padding.
        Reuses the scan _scan_last_seq already paid for (``_tail_scan``)
        instead of re-reading the log."""
        end, n = self._tail_scan
        return n > 0 and end != n

    def _chop_torn_tail(self) -> bool:
        """Repair the log tail before the first append: truncate torn
        bytes after the last intact record, or complete a final record's
        crash-shortened alignment padding with zeros.  Only reached for a
        benign torn tail — mid-file corruption takes the quarantine path.
        Returns False (and poisons the tail) when the repair itself
        failed: appending past unrepaired damage would strand every new
        record on the next replay."""
        try:
            with open(self._path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return True
        n = len(buf)
        end = self._intact_prefix_end(buf)
        try:
            if end < n:
                log.warning("chopping %d torn tail bytes off %s at offset "
                            "%d", n - end, self._path, end)
                os.truncate(self._path, end)
            elif end > n:
                # crash inside the trailing padding: the record is whole,
                # only zero-padding is missing — complete it in place
                log.warning("completing %d missing padding bytes on %s",
                            end - n, self._path)
                with open(self._path, "ab") as f:
                    f.write(b"\x00" * (end - n))
                    f.flush()
                    # deliberate fsync under the WAL lock: this one-time
                    # open repair must be durable before the append that
                    # triggered it lands — same serialized-durability
                    # contract as append() itself
                    os.fsync(f.fileno())  # nornlint: disable=NL-LK02
        except OSError:
            log.error("torn-tail repair failed; disabling appends until "
                      "reopen", exc_info=True)
            self._tail_dirty = True
            return False
        return True

    def _scan_last_seq(self) -> int:
        last = 0
        for e in self.read_all():
            last = max(last, e.seq)
        return last

    def verify_integrity(self) -> tuple[int, bool]:
        """Returns (valid_records, clean). clean=False when a torn tail was hit."""
        before = self.stats.truncated_tail_records
        entries = self.read_all()
        return len(entries), self.stats.truncated_tail_records == before

    # -- snapshot / compaction --------------------------------------------
    def snapshot_state(self, engine: Engine) -> dict[str, Any]:
        """In-memory engine dump (no IO) — callable under a write-blocking
        lock so serialization and disk writes can happen outside it."""
        return {
            "seq": self._seq,
            "nodes": [n.to_dict() for n in engine.all_nodes()],
            "edges": [e.to_dict() for e in engine.all_edges()],
            "pending_embed": engine.pending_embed_ids(),
        }

    def create_snapshot(self, engine: Engine) -> str:
        """Full engine dump (ref: WAL.CreateSnapshot wal.go:819)."""
        return self.write_snapshot(self.snapshot_state(engine))

    def write_snapshot(self, snap: dict[str, Any]) -> str:
        path = os.path.join(self.dir, self.SNAPSHOT_NAME)
        tmp = path + ".tmp"
        blob = json.dumps(snap).encode("utf-8")
        if self._encryptor is not None:
            blob = b"NSNAPENC" + self._encryptor.encrypt(blob)
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            # deliberate fsync under the compact lock (never the mutation
            # lock): _compact_lock exists to host exactly this slow disk
            # work so concurrent appends don't stall — see WALEngine.compact
            os.fsync(f.fileno())  # nornlint: disable=NL-LK02
        os.replace(tmp, path)
        self.stats.snapshots += 1
        return path

    def truncate_after_snapshot(self) -> None:
        """Drop the log; the snapshot now carries all state up to its seq
        (ref: TruncateAfterSnapshot wal.go:938)."""
        with self._lock:
            self._f.close()
            self._f = open(self._path, "wb")
            self._tail_dirty = False  # fresh file: damaged tail is gone
            self._needs_chop = False

    def truncate_up_to(self, seq: int) -> None:
        """Rewrite the log keeping only entries with seq > `seq` (appended
        while the snapshot was being written; recovery replays exactly those
        on top of the snapshot). Atomic via tmp+replace."""
        with self._lock:
            self._f.close()
            keep = [e for e in self.read_all() if e.seq > seq]
            tmp = self._path + ".tmp"
            with open(tmp, "wb") as f:
                for e in keep:
                    f.write(e.encode(self._encryptor, use_native=self._use_native))
                f.flush()
                # deliberate fsync under the WAL lock: truncation races an
                # in-flight append otherwise — same serialized-durability
                # contract as append() itself
                os.fsync(f.fileno())  # nornlint: disable=NL-LK02
            os.replace(tmp, self._path)
            self._f = open(self._path, "ab")
            self._tail_dirty = False  # rewrite kept only intact records
            self._needs_chop = False

    def load_snapshot(self) -> Optional[dict[str, Any]]:
        path = os.path.join(self.dir, self.SNAPSHOT_NAME)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            blob = f.read()
        if blob.startswith(b"NSNAPENC"):
            if self._encryptor is None:
                raise WALCorruptionError(
                    "snapshot is encrypted; passphrase required"
                )
            blob = self._encryptor.decrypt(blob[8:])
        return json.loads(blob.decode("utf-8"))

    # -- recovery ----------------------------------------------------------
    def recover(self, engine: Engine) -> int:
        """Load snapshot + replay tail with incomplete-transaction undo
        (ref: RecoverWithTransactions wal.go:1845). Returns replayed count."""
        snap = self.load_snapshot()
        snap_seq = 0
        if snap is not None:
            snap_seq = snap.get("seq", 0)
            for nd in snap.get("nodes", []):
                engine.create_node(Node.from_dict(nd))
            for ed in snap.get("edges", []):
                engine.create_edge(Edge.from_dict(ed))
            for nid in snap.get("pending_embed", []):
                engine.mark_pending_embed(nid)

        entries = [e for e in self.read_all() if e.seq > snap_seq]
        # First pass: find committed transactions.
        committed: set[str] = set()
        rolled_back: set[str] = set()
        seen_tx: set[str] = set()
        for e in entries:
            if e.op == OP_TX_BEGIN and e.txid:
                seen_tx.add(e.txid)
            elif e.op == OP_TX_COMMIT and e.txid:
                committed.add(e.txid)
            elif e.op == OP_TX_ROLLBACK and e.txid:
                rolled_back.add(e.txid)
        # Second pass: apply non-tx ops and ops of committed transactions only.
        applied = 0
        for e in entries:
            if e.op in (OP_TX_BEGIN, OP_TX_COMMIT, OP_TX_ROLLBACK):
                continue
            if e.txid is not None and e.txid not in committed:
                continue  # incomplete or rolled-back tx: skip (undo-by-omission)
            self._apply(engine, e)
            applied += 1
        self.stats.recovered_entries = applied
        return applied

    @staticmethod
    def _apply(engine: Engine, e: WALEntry) -> None:
        apply_storage_op(engine, e.op, e.data)

    def close(self) -> None:
        with self._lock:
            self._f.close()


class WALEngine(Engine):
    """Write-ahead decorator: every mutation is logged before it is applied
    (ref: NewWALEngine wal_engine.go:45; auto-compaction wal_engine.go:65-149).
    """

    def __init__(
        self,
        base: Engine,
        wal: WAL,
        auto_compact_interval: float = 300.0,
        auto_compact: bool = False,
    ):
        super().__init__()
        self.base = base
        self.wal = wal
        self._txid: Optional[str] = None  # set by transaction scope
        # serializes whole mutations (log + apply) against compaction: a
        # record appended after the snapshot's engine dump but before the
        # truncate would otherwise be erased yet absent from the snapshot,
        # losing the write on recovery (reachable via the auto-compact timer)
        self._mut_lock = threading.RLock()
        # serializes compact-vs-compact: Timer.cancel() cannot stop an
        # already-running tick, so close()'s final compact could otherwise
        # interleave with it (older snapshot overwriting a newer one while
        # the log is truncated past it)
        self._compact_lock = threading.Lock()
        self._compact_timer: Optional[threading.Timer] = None
        self._auto_compact_interval = auto_compact_interval
        self._closed = False
        base.on_event(self._emit)  # forward base events
        if auto_compact:
            self._schedule_compact()

    def _schedule_compact(self) -> None:
        if self._closed:
            return
        self._compact_timer = threading.Timer(self._auto_compact_interval, self._compact_tick)
        self._compact_timer.daemon = True
        self._compact_timer.start()

    def _compact_tick(self) -> None:
        try:
            self.compact()
        except Exception:
            # the next tick retries, but a persistently failing compaction
            # means unbounded log growth — operators need the trace
            log.warning("WAL auto-compaction failed; will retry",
                        exc_info=True)
        self._schedule_compact()

    def compact(self) -> None:
        """Snapshot + truncate (ref: wal_engine.go:65-149, 5-min default).

        _mut_lock is held only for the in-memory engine dump; serialization,
        fsync, and the log rewrite happen outside it, so writes stall for the
        copy, not the disk IO. The truncate keeps entries newer than the
        snapshot's seq (appended during the write) — recovery replays exactly
        those on top of the snapshot (recover() filters on seq > snap seq).

        Deferred while an explicit transaction is open: the base engine holds
        the tx's uncommitted ops, so a snapshot taken now would bake them in
        while dropping their txid-tagged records — recovery could then no
        longer undo an incomplete transaction (ref: tx-aware recovery
        wal.go:1845). The auto-compact timer retries next interval; protocol
        layers roll back on RESET/disconnect so a vanished client cannot
        defer compaction forever (bolt.py abort_tx).
        """
        with self._compact_lock:
            if self._closed:
                return
            with self._mut_lock:
                if self._txid is not None:
                    return
                snap = self.wal.snapshot_state(self.base)
            self.wal.write_snapshot(snap)
            self.wal.truncate_up_to(snap["seq"])

    # -- transaction scoping ----------------------------------------------
    def tx_begin(self, txid: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_TX_BEGIN, {}, txid=txid)
            self._txid = txid

    def tx_commit(self, txid: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_TX_COMMIT, {}, txid=txid)
            self._txid = None

    def tx_rollback(self, txid: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_TX_ROLLBACK, {}, txid=txid)
            self._txid = None

    # -- mutations (log first, then apply; atomic vs compact) ---------------
    def create_node(self, node: Node) -> Node:
        with self._mut_lock:
            self.wal.append(OP_CREATE_NODE, node.to_dict(), txid=self._txid)
            return self.base.create_node(node)

    def update_node(self, node: Node) -> Node:
        with self._mut_lock:
            self.wal.append(OP_UPDATE_NODE, node.to_dict(), txid=self._txid)
            return self.base.update_node(node)

    def delete_node(self, node_id: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_DELETE_NODE, {"id": node_id}, txid=self._txid)
            self.base.delete_node(node_id)

    def create_edge(self, edge: Edge) -> Edge:
        with self._mut_lock:
            self.wal.append(OP_CREATE_EDGE, edge.to_dict(), txid=self._txid)
            return self.base.create_edge(edge)

    def update_edge(self, edge: Edge) -> Edge:
        with self._mut_lock:
            self.wal.append(OP_UPDATE_EDGE, edge.to_dict(), txid=self._txid)
            return self.base.update_edge(edge)

    def delete_edge(self, edge_id: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_DELETE_EDGE, {"id": edge_id}, txid=self._txid)
            self.base.delete_edge(edge_id)

    def mark_pending_embed(self, node_id: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_MARK_PENDING, {"id": node_id}, txid=self._txid)
            self.base.mark_pending_embed(node_id)

    def unmark_pending_embed(self, node_id: str) -> None:
        with self._mut_lock:
            self.wal.append(OP_UNMARK_PENDING, {"id": node_id}, txid=self._txid)
            self.base.unmark_pending_embed(node_id)

    # -- reads: delegate ---------------------------------------------------
    def get_node(self, node_id: str) -> Node:
        return self.base.get_node(node_id)

    def get_nodes_by_label(self, label: str) -> list[Node]:
        return self.base.get_nodes_by_label(label)

    def all_nodes(self):
        return self.base.all_nodes()

    def all_node_ids(self):
        return self.base.all_node_ids()  # AttributeError -> caller fallback

    def batch_get_nodes(self, ids):
        return self.base.batch_get_nodes(ids)

    def get_edge(self, edge_id: str) -> Edge:
        return self.base.get_edge(edge_id)

    def get_edges_by_type(self, edge_type: str) -> list[Edge]:
        return self.base.get_edges_by_type(edge_type)

    def get_outgoing_edges(self, node_id: str) -> list[Edge]:
        return self.base.get_outgoing_edges(node_id)

    def get_incoming_edges(self, node_id: str) -> list[Edge]:
        return self.base.get_incoming_edges(node_id)

    def all_edges(self):
        return self.base.all_edges()

    def node_count(self) -> int:
        return self.base.node_count()

    def edge_count(self) -> int:
        return self.base.edge_count()

    def count_nodes_by_label(self, label: str) -> int:
        return self.base.count_nodes_by_label(label)

    def count_edges_by_type(self, edge_type: str) -> int:
        return self.base.count_edges_by_type(edge_type)

    def pending_embed_ids(self, limit: int = 0) -> list[str]:
        return self.base.pending_embed_ids(limit)

    def flush(self) -> None:
        self.base.flush()

    def close(self) -> None:
        if self._compact_timer is not None:
            self._compact_timer.cancel()
        self.compact()  # final snapshot; serialized with any in-flight tick
        with self._compact_lock:
            # an in-flight tick has finished; nothing may touch the WAL after
            self._closed = True
        self.wal.close()
        self.base.close()
