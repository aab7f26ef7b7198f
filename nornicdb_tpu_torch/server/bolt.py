"""Bolt protocol server (Neo4j drivers connect here).

Behavioral reference: upstream NornicDB pkg/bolt/server.go —
handshake magic 0x6060B017 (:874), version negotiation 4.0-4.4 (:139-144),
messages HELLO/GOODBYE/RESET/RUN/DISCARD/PULL/BEGIN/COMMIT/ROLLBACK/ROUTE
(:148-165), per-session state machine with result streaming (:745-815),
chunked message framing, injected QueryExecutor (:249), auth adapter.

Implementation: asyncio TCP server; each session holds buffered results
streamed on PULL (qid-less, single-query-at-a-time like Bolt 4 autocommit).

The port's copy of ``nornicdb_tpu/server/bolt.py``. One difference: a
``DeviceUnavailable`` (the card is not serving; the port never answers
from the host) fails the statement with
``Neo.TransientError.General.DatabaseUnavailable``, so drivers back off
and retry.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
import time
from typing import Any, Optional

from nornicdb_tpu_torch.cypher.executor import classify_query_text
from nornicdb_tpu_torch.errors import AuthError, DeviceUnavailable
from nornicdb_tpu_torch.server.packstream import Structure, pack, to_wire, unpack
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

log = logging.getLogger(__name__)

_BOLT_HIST = _REGISTRY.histogram(
    "nornicdb_bolt_request_seconds",
    "Bolt RUN latency (query execution, excluding PULL streaming)",
)

MAGIC = b"\x60\x60\xb0\x17"

# message tags (ref: server.go:148-165)
MSG_HELLO = 0x01
MSG_GOODBYE = 0x02
MSG_RESET = 0x0F
MSG_RUN = 0x10
MSG_BEGIN = 0x11
MSG_COMMIT = 0x12
MSG_ROLLBACK = 0x13
MSG_DISCARD = 0x2F
MSG_PULL = 0x3F
MSG_ROUTE = 0x66
MSG_LOGON = 0x6A
MSG_LOGOFF = 0x6B
MSG_TELEMETRY = 0x54
MSG_SUCCESS = 0x70
MSG_RECORD = 0x71
MSG_IGNORED = 0x7E
MSG_FAILURE = 0x7F

# Bolt 5.x first (modern drivers; LOGON flow + element-id structs),
# 4.x fallback (ref: server.go:139-144 negotiates 4.0-4.4)
SUPPORTED_VERSIONS = [
    (5, 4), (5, 3), (5, 2), (5, 1), (5, 0),
    (4, 4), (4, 3), (4, 2), (4, 1),
]


def _is_tx_keyword(query: str) -> bool:
    return query.strip().upper() in ("BEGIN", "COMMIT", "ROLLBACK")


class BoltSession:
    """Per-connection state machine (ref: Session server.go:815)."""

    def __init__(self, server: "BoltServer", conn_no: int = 0):
        self.server = server
        self.conn_no = conn_no
        self.authenticated = not server.auth_required
        # RBAC: role resolved at HELLO/LOGON, enforced per-RUN with the same
        # AST-based write classification as the HTTP tx endpoint (ref: Bolt
        # auth adapter auth_adapter.go + permission model auth.go:171-176).
        # No authenticator / auth disabled => full access.
        self.role = "admin" if self.authenticated else "none"
        self.ready = False
        self.streaming: Optional[dict] = None  # {columns, rows, pos, stats}
        self.in_tx = False
        self.failed = False
        self.database: Optional[str] = None
        # explicit transactions are session-scoped: two connections doing
        # BEGIN must not share one executor's tx state
        self._session_executor = None

    def handle(self, tag: int, fields: list[Any]) -> list[tuple[int, Any]]:
        """Process one message, return response messages [(tag, metadata)]."""
        try:
            if tag == MSG_HELLO:
                return self._hello(fields)
            if tag == MSG_LOGON:
                return self._logon(fields)
            if tag == MSG_LOGOFF:
                self.authenticated = not self.server.auth_required
                self.role = "admin" if self.authenticated else "none"
                return [(MSG_SUCCESS, {})]
            if tag == MSG_TELEMETRY:
                return [(MSG_SUCCESS, {})]  # 5.4 drivers emit api telemetry
            if tag == MSG_RESET:
                self.abort_tx()  # RESET mid-tx must ROLLBACK, not leak it
                self.streaming = None
                self.failed = False
                return [(MSG_SUCCESS, {})]
            if tag == MSG_GOODBYE:
                return []
            if self.failed and tag not in (MSG_RESET,):
                return [(MSG_IGNORED, {})]
            if not self.authenticated:
                self.failed = True
                return [
                    (
                        MSG_FAILURE,
                        {
                            "code": "Neo.ClientError.Security.Unauthorized",
                            "message": "authentication required",
                        },
                    )
                ]
            if tag == MSG_RUN:
                return self._run(fields)
            if tag == MSG_PULL:
                return self._pull(fields)
            if tag == MSG_DISCARD:
                self.streaming = None
                return [(MSG_SUCCESS, {"has_more": False})]
            if tag == MSG_BEGIN:
                self._execute("BEGIN", {})
                self.in_tx = True
                return [(MSG_SUCCESS, {})]
            if tag == MSG_COMMIT:
                self._execute("COMMIT", {})
                self.in_tx = False
                return [(MSG_SUCCESS, {})]
            if tag == MSG_ROLLBACK:
                self._execute("ROLLBACK", {})
                self.in_tx = False
                return [(MSG_SUCCESS, {})]
            if tag == MSG_ROUTE:
                return self._route(fields)
            self.failed = True
            return [
                (
                    MSG_FAILURE,
                    {
                        "code": "Neo.ClientError.Request.Invalid",
                        "message": f"unknown message 0x{tag:02X}",
                    },
                )
            ]
        except Exception as e:  # surface executor errors as FAILURE
            self.failed = True
            code = "Neo.ClientError.Statement.SyntaxError"
            name = type(e).__name__
            if "NotFound" in name:
                code = "Neo.ClientError.Statement.EntityNotFound"
            elif "Constraint" in name:
                code = "Neo.ClientError.Schema.ConstraintValidationFailed"
            elif "Auth" in name:
                code = "Neo.ClientError.Security.Unauthorized"
            elif "Durability" in name:
                # a WAL append failed durability (disk error / ENOSPC /
                # injected storage fault): nothing was acked; transient so
                # drivers back off and retry once the disk recovers
                code = "Neo.TransientError.General.DatabaseUnavailable"
            elif isinstance(e, DeviceUnavailable):
                # the card is not serving and the port does not answer
                # from the host: transient, so drivers back off and retry
                # once the device owner recovers
                code = "Neo.TransientError.General.DatabaseUnavailable"
            elif "ResourceExhausted" in name:
                # serving admission control shed work under this statement
                # (embed/search queue full or deadline): a TRANSIENT code,
                # so neo4j drivers retry with backoff instead of failing
                # the transaction permanently
                code = "Neo.TransientError.Request.ResourceExhausted"
            return [(MSG_FAILURE, {"code": code, "message": str(e)})]

    def _hello(self, fields: list[Any]) -> list[tuple[int, Any]]:
        meta = fields[0] if fields else {}
        if self.server.auth_required:
            self._try_auth(meta)
        else:
            self.authenticated = True
        if not self.authenticated and "credentials" in (meta or {}):
            self.failed = True
            return [
                (
                    MSG_FAILURE,
                    {
                        "code": "Neo.ClientError.Security.Unauthorized",
                        "message": "invalid credentials",
                    },
                )
            ]
        self.ready = True
        return [
            (
                MSG_SUCCESS,
                {
                    "server": f"NornicDB-TPU/{self.server.version}",
                    # monotonic accept counter, not id() and not the
                    # active-connection gauge (which decrements and would
                    # reuse ids): deterministic for the transcribed wire
                    # fixtures and collision-free for log correlation
                    "connection_id": f"bolt-{self.conn_no}",
                },
            )
        ]

    def _logon(self, fields: list[Any]) -> list[tuple[int, Any]]:
        meta = fields[0] if fields else {}
        self._try_auth(meta)
        if not self.authenticated:
            self.failed = True
            return [
                (
                    MSG_FAILURE,
                    {
                        "code": "Neo.ClientError.Security.Unauthorized",
                        "message": "invalid credentials",
                    },
                )
            ]
        return [(MSG_SUCCESS, {})]

    def _try_auth(self, meta: dict) -> None:
        if self.server.authenticator is None:
            self.authenticated = True
            self.role = "admin"
            return
        scheme = (meta or {}).get("scheme", "none")
        if scheme == "basic":
            user = meta.get("principal", "")
            pw = meta.get("credentials", "")
            self.authenticated = self.server.authenticator.check_password(user, pw)
            if self.authenticated:
                try:
                    self.role = self.server.authenticator.get_user(user).role
                except AuthError:
                    self.role = "none"
        elif scheme == "bearer":
            token = meta.get("credentials", "")
            payload = self.server.authenticator.validate_token(token)
            self.authenticated = payload is not None
            if payload is not None:
                self.role = payload.get("role", "none")
        else:
            self.authenticated = not self.server.auth_required
            self.role = "admin" if self.authenticated else "none"
        if not self.authenticated:
            self.role = "none"

    def abort_tx(self) -> None:
        """Roll back an open explicit transaction (RESET / disconnect).

        Without this, a client that BEGINs and vanishes leaves the engine's
        tx id set forever — which, among other things, permanently defers
        WAL auto-compaction (wal.py compact() skips while a tx is open)."""
        if not self.in_tx:
            return
        self.in_tx = False
        try:
            self._execute("ROLLBACK", {})
        except Exception:
            log.warning("implicit rollback failed", exc_info=True)

    def _execute(self, query: str, params: dict):
        factory = self.server.session_executor_factory
        if factory is not None and (self.in_tx or _is_tx_keyword(query)):
            # route tx-scoped statements through this session's own executor
            if self._session_executor is None:
                self._session_executor = factory(self.database)
            return self._session_executor.execute(query, params)
        return self.server.executor_fn(query, params, self.database)

    def _run(self, fields: list[Any]) -> list[tuple[int, Any]]:
        query = fields[0] if fields else ""
        params = fields[1] if len(fields) > 1 else {}
        extra = fields[2] if len(fields) > 2 else {}
        if isinstance(extra, dict) and extra.get("db"):
            self.database = extra["db"]
        if self.server.authenticator is not None and not _is_tx_keyword(query):
            perm = classify_query_text(query)
            if not self.server.authenticator.has_permission(self.role, perm):
                raise AuthError(
                    f"permission {perm} denied for role {self.role}"
                )
        # Bolt ingress root span: drivers may hand a W3C traceparent via
        # the RUN extra's tx_metadata (no header channel on Bolt); the
        # executor / storage / device spans below nest under this root
        meta = extra.get("tx_metadata") if isinstance(extra, dict) else None
        traceparent = (
            meta.get("traceparent") if isinstance(meta, dict) else None
        )
        t0 = time.perf_counter()
        with _tracer.start_trace("bolt.run", traceparent=traceparent) as root:
            if root.trace_id is not None:
                root.set_attr("db", self.database or "neo4j")
            result = self._execute(query, params or {})
        _BOLT_HIST.observe(time.perf_counter() - t0)
        self.streaming = {
            "columns": result.columns,
            "rows": result.rows,
            "pos": 0,
            "stats": result.stats.as_dict(),
        }
        return [(MSG_SUCCESS, {"fields": result.columns, "t_first": 0})]

    def _pull(self, fields: list[Any]) -> list[tuple[int, Any]]:
        meta = fields[0] if fields else {}
        n = int(meta.get("n", -1)) if isinstance(meta, dict) else -1
        out: list[tuple[int, Any]] = []
        if self.streaming is None:
            return [(MSG_SUCCESS, {"has_more": False})]
        rows = self.streaming["rows"]
        pos = self.streaming["pos"]
        end = len(rows) if n < 0 else min(pos + n, len(rows))
        for i in range(pos, end):
            out.append((MSG_RECORD, [to_wire(v) for v in rows[i]]))
        self.streaming["pos"] = end
        if end >= len(rows):
            summary = {
                "type": "rw",
                "t_last": 0,
                "db": self.database or "neo4j",
            }
            stats = self.streaming["stats"]
            if stats:
                summary["stats"] = stats
            self.streaming = None
            out.append((MSG_SUCCESS, summary))
        else:
            out.append((MSG_SUCCESS, {"has_more": True}))
        return out

    def _route(self, fields: list[Any]) -> list[tuple[int, Any]]:
        # single-instance routing table (ref: handleRoute)
        host = f"{self.server.host}:{self.server.port}"
        table = {
            "rt": {
                "ttl": 300,
                "db": self.database or "neo4j",
                "servers": [
                    {"addresses": [host], "role": role}
                    for role in ("WRITE", "READ", "ROUTE")
                ],
            }
        }
        return [(MSG_SUCCESS, table)]


class BoltServer:
    """(ref: bolt.Server server.go:191)"""

    version = "1.0.0"

    def __init__(
        self,
        executor_fn,
        host: str = "127.0.0.1",
        port: int = 7687,
        authenticator=None,
        auth_required: bool = False,
        session_executor_factory=None,
    ):
        """executor_fn(query, params, database) -> cypher Result
        (ref: QueryExecutor interface server.go:249).
        session_executor_factory(database) -> executor, used to give each
        connection its own transaction scope (BEGIN/COMMIT isolation)."""
        self.executor_fn = executor_fn
        self.session_executor_factory = session_executor_factory
        self.host = host
        self.port = port
        self.authenticator = authenticator
        self.auth_required = auth_required
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.connections = 0  # active-connection gauge (dec on close)
        self._conn_seq = 0    # monotonic accept counter (never reused)

    # -- wire helpers --------------------------------------------------------
    @staticmethod
    def _chunk(payload: bytes) -> bytes:
        """Chunked framing: [len u16][data]... [0x0000]."""
        out = bytearray()
        for i in range(0, len(payload), 0xFFFF):
            part = payload[i : i + 0xFFFF]
            out += struct.pack(">H", len(part))
            out += part
        out += b"\x00\x00"
        return bytes(out)

    async def _read_message(self, reader: asyncio.StreamReader) -> Optional[bytes]:
        chunks = bytearray()
        while True:
            header = await reader.readexactly(2)
            (size,) = struct.unpack(">H", header)
            if size == 0:
                if chunks:
                    return bytes(chunks)
                continue  # NOOP keepalive chunk
            chunks += await reader.readexactly(size)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self.connections += 1
        session = None
        try:
            # handshake (ref: server.go:867-898)
            magic = await reader.readexactly(4)
            if magic != MAGIC:
                writer.close()
                return
            proposals = await reader.readexactly(16)
            chosen = (0, 0)
            for i in range(4):
                # proposal bytes: [00, range, minor, major] — the client
                # supports (major, minor-range) .. (major, minor)
                rng = proposals[i * 4 + 1]
                minor, major = proposals[i * 4 + 2], proposals[i * 4 + 3]
                for v in SUPPORTED_VERSIONS:  # ordered best-first
                    if v[0] == major and (minor - rng) <= v[1] <= minor:
                        chosen = v  # always a version WE support
                        break
                if chosen != (0, 0):
                    break
            writer.write(bytes([0, 0, chosen[1], chosen[0]]))
            await writer.drain()
            if chosen == (0, 0):
                writer.close()
                return
            self._conn_seq += 1  # single-threaded: the server's event loop
            session = BoltSession(self, conn_no=self._conn_seq)
            while True:
                try:
                    raw = await self._read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                if raw is None:
                    break
                msg = unpack(raw)
                if not isinstance(msg, Structure):
                    break
                responses = session.handle(msg.tag, msg.fields)
                if msg.tag == MSG_GOODBYE:
                    break
                # one transport write for the whole response stream: a
                # per-RECORD write costs a syscall + event-loop hop each
                # (profiled at ~40% of request wall time on a 19-record
                # stream; ref: the Go server's buffered writer batches the
                # same way, bolt/server.go WriteRecordNoFlush)
                buf = bytearray()
                for tag, meta in responses:
                    buf += self._chunk(pack(Structure(tag, [meta])))
                if buf:
                    # transports accept bytearray; buf is rebound next
                    # iteration, never mutated after the write
                    writer.write(buf)
                # drain() only matters for flow control; awaiting it per
                # message costs an event-loop round-trip per op (measured
                # ~2x op latency at RETURN-1 scale). Await only when the
                # transport's buffer actually backs up.
                if writer.transport.get_write_buffer_size() > 65536:
                    await writer.drain()
        except Exception:
            # client gone mid-conversation is routine; anything else in the
            # message loop should leave a trace before we drop the session
            log.debug("bolt session ended abnormally", exc_info=True)
        finally:
            self.connections -= 1
            if session is not None:
                try:
                    session.abort_tx()  # dropped connection mid-tx: roll back
                except Exception:
                    log.warning("abort_tx on dropped connection failed",
                                exc_info=True)
            try:
                writer.close()
            except OSError:
                pass  # socket already torn down

    # -- lifecycle ---------------------------------------------------------------
    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def start(self) -> None:
        """Run the server on a background thread (blocking variant: serve())."""

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve())
            except asyncio.CancelledError:
                pass

        self._thread = threading.Thread(target=run, daemon=True, name="bolt-server")
        self._thread.start()
        self._started.wait(timeout=10)

    def stop(self) -> None:
        if self._loop is not None:

            def _shutdown():
                if self._server is not None:
                    self._server.close()
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)
