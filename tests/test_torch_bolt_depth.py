"""Bolt server state-machine depth (ref: pkg/bolt/server_test.go 2,061 LoC
+ server_extra_test.go 1,450 LoC — handshake negotiation, chunking, PULL
batching/has_more, DISCARD, FAILURE->IGNORED->RESET, per-connection tx
isolation, RESET-mid-tx rollback, error-code taxonomy, ROUTE).

The port's copy of ``tests/test_bolt_depth.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
"""

import socket
import struct

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.server import BoltServer
from nornicdb_tpu_torch.server.packstream import Structure, pack, unpack

MSG_RUN, MSG_PULL, MSG_DISCARD = 0x10, 0x3F, 0x2F
MSG_BEGIN, MSG_COMMIT, MSG_ROLLBACK = 0x11, 0x12, 0x13
MSG_RESET, MSG_HELLO, MSG_GOODBYE = 0x0F, 0x01, 0x02
MSG_SUCCESS, MSG_RECORD, MSG_IGNORED, MSG_FAILURE = 0x70, 0x71, 0x7E, 0x7F


class Client:
    def __init__(self, port, versions=(0x0404, 0, 0, 0), hello=True):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.sock.sendall(b"\x60\x60\xb0\x17")
        self.sock.sendall(b"".join(struct.pack(">I", v) for v in versions))
        self.chosen = self._recv_exact(4)
        if hello:
            assert self.request(MSG_HELLO, [{"user_agent": "depth/1.0"}])[0] \
                .tag == MSG_SUCCESS

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("closed")
            buf += part
        return buf

    def send(self, tag, fields):
        payload = pack(Structure(tag, fields))
        msg = b""
        for i in range(0, len(payload), 0xFFFF):
            part = payload[i:i + 0xFFFF]
            msg += struct.pack(">H", len(part)) + part
        self.sock.sendall(msg + b"\x00\x00")

    def recv(self):
        chunks = b""
        while True:
            (size,) = struct.unpack(">H", self._recv_exact(2))
            if size == 0:
                if chunks:
                    return unpack(chunks)
                continue
            chunks += self._recv_exact(size)

    def request(self, tag, fields, nresp=1):
        self.send(tag, fields)
        return [self.recv() for _ in range(nresp)]

    def drain_stream(self):
        """After PULL: collect records until a summary message."""
        records = []
        while True:
            m = self.recv()
            if m.tag == MSG_RECORD:
                records.append(m.fields[0])
            else:
                return records, m

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


@pytest.fixture(scope="module")
def server():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    srv = BoltServer(
        lambda q, p, d: (db.executor_for(d) if d else db.executor).execute(q, p),
        port=0,
        session_executor_factory=db.session_executor,
    )
    srv.start()
    yield db, srv
    srv.stop()
    db.close()


class TestHandshake:
    def test_picks_highest_supported_of_offered(self, server):
        _, srv = server
        c = Client(srv.port, versions=(0x0404, 0x0304, 0x0204, 0x0104),
                   hello=False)
        assert c.chosen[3] == 4 and c.chosen[2] in (1, 2, 3, 4)
        c.close()

    def test_unsupported_only_rejected(self, server):
        """Offering only a version the server doesn't speak -> all-zero
        reply (the spec's rejection), not a silent pick."""
        _, srv = server
        c = Client(srv.port, versions=(0x0905, 0, 0, 0), hello=False)
        assert c.chosen == b"\x00\x00\x00\x00"
        c.close()

    def test_lower_minor_negotiates(self, server):
        _, srv = server
        c = Client(srv.port, versions=(0x0104, 0, 0, 0), hello=False)
        assert tuple(c.chosen[2:]) == (1, 4)
        c.close()

    def test_hello_returns_server_identity(self, server):
        _, srv = server
        c = Client(srv.port, hello=False)
        (ok,) = c.request(MSG_HELLO, [{"user_agent": "x"}])
        assert ok.tag == MSG_SUCCESS
        meta = ok.fields[0]
        assert "server" in meta
        assert "connection_id" in meta
        c.close()


class TestStreaming:
    def test_pull_n_batches_with_has_more(self, server):
        """ref: PULL {n} flow control — partial pulls leave the stream
        open (has_more=true), the final pull closes it."""
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_RUN, ["UNWIND range(1, 10) AS x RETURN x", {}, {}])
        c.send(MSG_PULL, [{"n": 4}])
        records, summary = c.drain_stream()
        assert [r[0] for r in records] == [1, 2, 3, 4]
        assert summary.fields[0].get("has_more") is True
        c.send(MSG_PULL, [{"n": -1}])
        records, summary = c.drain_stream()
        assert [r[0] for r in records] == [5, 6, 7, 8, 9, 10]
        # final summary: stream closed — has_more absent (spec default) or
        # explicitly false, and the summary carries the db name
        assert summary.fields[0].get("has_more") is not True
        assert "db" in summary.fields[0]
        c.close()

    def test_discard_closes_stream(self, server):
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_RUN, ["UNWIND range(1, 100) AS x RETURN x", {}, {}])
        (ok,) = c.request(MSG_DISCARD, [{"n": -1}])
        assert ok.tag == MSG_SUCCESS
        assert ok.fields[0].get("has_more") is False
        # the connection is reusable immediately
        c.request(MSG_RUN, ["RETURN 1", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        assert records == [[1]]
        c.close()

    def test_large_result_chunked_over_64k(self, server):
        """A record bigger than one 0xFFFF chunk must arrive intact."""
        db, srv = server
        c = Client(srv.port)
        big = "y" * 200_000
        c.request(MSG_RUN, ["RETURN $s AS s", {"s": big}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, summary = c.drain_stream()
        assert records[0][0] == big
        c.close()

    def test_large_inbound_query_chunked(self, server):
        db, srv = server
        c = Client(srv.port)
        big = "z" * 150_000
        c.request(MSG_RUN, [f"RETURN '{big}' AS s", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        assert records[0][0] == big
        c.close()


class TestFailureStateMachine:
    def test_failure_then_ignored_until_reset(self, server):
        """ref: server_test.go failure flow — after FAILURE every message
        except RESET answers IGNORED."""
        db, srv = server
        c = Client(srv.port)
        (fail,) = c.request(MSG_RUN, ["THIS IS NOT CYPHER", {}, {}])
        assert fail.tag == MSG_FAILURE
        assert fail.fields[0]["code"].startswith("Neo.ClientError")
        (ig1,) = c.request(MSG_PULL, [{"n": -1}])
        assert ig1.tag == MSG_IGNORED
        (ig2,) = c.request(MSG_RUN, ["RETURN 1", {}, {}])
        assert ig2.tag == MSG_IGNORED
        (ok,) = c.request(MSG_RESET, [])
        assert ok.tag == MSG_SUCCESS
        c.request(MSG_RUN, ["RETURN 1", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        assert records == [[1]]
        c.close()

    def test_error_code_taxonomy(self, server):
        db, srv = server
        c = Client(srv.port)
        (fail,) = c.request(MSG_RUN, ["MATCH (n WHERE", {}, {}])
        assert fail.fields[0]["code"] == \
            "Neo.ClientError.Statement.SyntaxError"
        c.request(MSG_RESET, [])
        c.close()


class TestTransactions:
    def test_per_connection_tx_scoping(self, server):
        """ref: BEGIN scoping — each connection owns its tx state: a BEGIN
        on c1 must not put c2 into a transaction (c2's autocommit writes
        survive c1's rollback). The engine's tx model is undo-based
        atomicity (rollback reverts), not snapshot isolation."""
        db, srv = server
        c1, c2 = Client(srv.port), Client(srv.port)
        assert c1.request(MSG_BEGIN, [{}])[0].tag == MSG_SUCCESS
        c1.request(MSG_RUN, ["CREATE (:TxDepth {who: 'c1'})", {}, {}])
        c1.send(MSG_PULL, [{"n": -1}])
        c1.drain_stream()
        # c2 writes OUTSIDE any tx while c1's tx is open
        c2.request(MSG_RUN, ["CREATE (:TxDepth {who: 'c2'})", {}, {}])
        c2.send(MSG_PULL, [{"n": -1}])
        c2.drain_stream()
        assert c1.request(MSG_ROLLBACK, [{}])[0].tag == MSG_SUCCESS
        # c1's write reverted; c2's autocommit write untouched
        c2.request(MSG_RUN,
                   ["MATCH (n:TxDepth) RETURN n.who ORDER BY n.who",
                    {}, {}])
        c2.send(MSG_PULL, [{"n": -1}])
        records, _ = c2.drain_stream()
        assert records == [["c2"]]
        c1.close()
        c2.close()

    def test_rollback_discards_writes(self, server):
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_BEGIN, [{}])
        c.request(MSG_RUN, ["CREATE (:RolledBack)", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        c.drain_stream()
        assert c.request(MSG_ROLLBACK, [{}])[0].tag == MSG_SUCCESS
        c.request(MSG_RUN, ["MATCH (n:RolledBack) RETURN count(n)", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        assert records == [[0]]
        c.close()

    def test_reset_mid_tx_rolls_back(self, server):
        """ref: RESET must ROLLBACK an open tx, not leak it."""
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_BEGIN, [{}])
        c.request(MSG_RUN, ["CREATE (:ResetLeak)", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        c.drain_stream()
        assert c.request(MSG_RESET, [])[0].tag == MSG_SUCCESS
        c.request(MSG_RUN, ["MATCH (n:ResetLeak) RETURN count(n)", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        assert records == [[0]]
        c.close()

    def test_disconnect_mid_tx_rolls_back(self, server):
        """A vanished client's open tx must not block compaction or leak
        writes (ref: abort_tx on connection close)."""
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_BEGIN, [{}])
        c.request(MSG_RUN, ["CREATE (:Vanished)", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        c.drain_stream()
        c.close()  # no COMMIT, no GOODBYE
        import time

        c2 = Client(srv.port)
        for _ in range(50):
            c2.request(MSG_RUN,
                       ["MATCH (n:Vanished) RETURN count(n)", {}, {}])
            c2.send(MSG_PULL, [{"n": -1}])
            records, _ = c2.drain_stream()
            if records == [[0]]:
                break
            time.sleep(0.1)
        assert records == [[0]]
        c2.close()


class TestTypesOverWire:
    @pytest.mark.parametrize("expr,expected", [
        ("RETURN 1 + 2", 3),
        ("RETURN 1.5", 1.5),
        ("RETURN 'tekst'", "tekst"),
        ("RETURN true", True),
        ("RETURN null", None),
        ("RETURN [1, 'a', null]", [1, "a", None]),
        ("RETURN {a: 1, b: [2]}", {"a": 1, "b": [2]}),
    ])
    def test_value_roundtrip(self, server, expr, expected):
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_RUN, [expr + " AS v", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        assert records == [[expected]]
        c.close()

    def test_node_and_relationship_structures(self, server):
        db, srv = server
        c = Client(srv.port)
        c.request(MSG_RUN,
                  ["CREATE (a:WireA {k: 1})-[r:WIRED {w: 2}]->(b:WireB) "
                   "RETURN a, r, b", {}, {}])
        c.send(MSG_PULL, [{"n": -1}])
        records, _ = c.drain_stream()
        a, r, b = records[0]
        assert a.tag == 0x4E and "WireA" in a.fields[1]
        assert a.fields[2] == {"k": 1}
        assert r.tag == 0x52 and r.fields[3] == "WIRED"
        assert r.fields[4] == {"w": 2}
        assert b.tag == 0x4E
        c.close()

    def test_route_message_shape(self, server):
        db, srv = server
        c = Client(srv.port)
        (ok,) = c.request(0x66, [{}, [], None])
        assert ok.tag == MSG_SUCCESS
        rt = ok.fields[0]["rt"]
        assert {"ttl", "servers"} <= set(rt)
        roles = {s["role"] for s in rt["servers"]}
        assert {"WRITE", "READ", "ROUTE"} <= roles
        c.close()
