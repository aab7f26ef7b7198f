"""Transcribed Bolt/PackStream wire fixtures (ROADMAP item 5a): replay
committed byte streams from a neo4j-driver-shaped session against a live
BoltServer and assert BYTE-EXACT responses.

The client bytes were hand-encoded from the PackStream v2 / Bolt 5.x
specs with an independent encoder (tests/data/bolt_wire/regen.py) — the
zero-egress analogue of the reference's javascript_compat_test.go: a
shared encode/decode bug in server/packstream.py cannot self-validate
here, because the input bytes never pass through it.

Any intentional protocol change regenerates fixtures with regen.py; an
UNintentional byte drift (encoding width, field order, metadata keys)
fails with a hexdump diff.

The port's copy of ``tests/test_bolt_wire_fixtures.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
The port's server answers the JAX package's committed fixtures
byte for byte.
"""

from __future__ import annotations

import json
import os
import socket
import struct

import pytest

import nornicdb_tpu_torch
from nornicdb_tpu_torch.server.bolt import BoltServer
from nornicdb_tpu_torch.server.packstream import Structure, unpack

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "data", "bolt_wire")
FIXTURES = sorted(
    f[:-5] for f in os.listdir(FIXTURE_DIR) if f.endswith(".json"))


def _load(name: str) -> dict:
    with open(os.path.join(FIXTURE_DIR, f"{name}.json")) as f:
        return json.load(f)


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError(
                f"connection closed after {len(buf)}/{n} bytes")
        buf += part
    return buf


def _hexdiff(got: bytes, want: bytes) -> str:
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            lo = max(0, i - 12)
            return (f"first differing byte at offset {i}: "
                    f"got ...{got[lo:i+12].hex()}... "
                    f"want ...{want[lo:i+12].hex()}...")
    return f"length mismatch: got {len(got)}, want {len(want)}"


def _decode_stream(raw: bytes) -> list:
    """Unchunk a response stream into decoded Structures (for the
    semantic assertions that keep fixtures meaningful)."""
    msgs, off, chunks = [], 0, b""
    while off < len(raw):
        (size,) = struct.unpack(">H", raw[off:off + 2])
        off += 2
        if size == 0:
            if chunks:
                msgs.append(unpack(chunks))
                chunks = b""
            continue
        chunks += raw[off:off + size]
        off += size
    return msgs


@pytest.fixture()
def fresh_server():
    """Each fixture session needs connection #1 on an empty graph — the
    HELLO connection_id and write stats are part of the asserted bytes."""
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    server = BoltServer(
        lambda q, p, d: db.executor.execute(q, p),
        port=0, session_executor_factory=db.session_executor)
    server.start()
    yield server
    server.stop()
    db.close()


@pytest.mark.parametrize("name", FIXTURES)
def test_byte_exact_replay(name, fresh_server):
    fixture = _load(name)
    sock = socket.create_connection(("127.0.0.1", fresh_server.port),
                                    timeout=10)
    try:
        steps = fixture["steps"]
        i = 0
        while i < len(steps):
            step = steps[i]
            assert step["dir"] == "send", f"step {i} out of order"
            sock.sendall(bytes.fromhex(step["hex"]))
            if i + 1 < len(steps) and steps[i + 1]["dir"] == "recv":
                want = bytes.fromhex(steps[i + 1]["hex"])
                got = _read_exact(sock, len(want))
                assert got == want, (
                    f"{name} step {i + 1}: response bytes drifted — "
                    f"{_hexdiff(got, want)}")
                i += 2
            else:
                i += 1
    finally:
        sock.close()


class TestFixtureSemantics:
    """Decode the committed server bytes with our own unpacker: fixtures
    must stay meaningful protocol exchanges, not opaque blobs."""

    def test_hello_session_shape(self):
        fx = _load("hello_logon_run_pull")
        recvs = [bytes.fromhex(s["hex"]) for s in fx["steps"]
                 if s["dir"] == "recv"]
        # version negotiation: 4 raw bytes, Bolt 5.4
        assert recvs[0] == b"\x00\x00\x04\x05"
        hello = _decode_stream(recvs[1])[0]
        assert hello.tag == 0x70
        assert hello.fields[0]["server"].startswith("NornicDB-TPU/")
        assert hello.fields[0]["connection_id"] == "bolt-1"
        run = _decode_stream(recvs[3])[0]
        assert run.fields[0]["fields"] == ["n"]
        pull = _decode_stream(recvs[4])
        assert [m.tag for m in pull] == [0x71, 0x70]  # RECORD, SUCCESS
        assert pull[0].fields[0] == [1]

    def test_create_summary_stats(self):
        fx = _load("create_match_params")
        recvs = [bytes.fromhex(s["hex"]) for s in fx["steps"]
                 if s["dir"] == "recv"]
        summary = _decode_stream(recvs[3])[-1]
        assert summary.fields[0]["stats"]["nodes_created"] == 1
        match_pull = _decode_stream(recvs[5])
        assert match_pull[0].fields[0] == [42]  # w.n round-tripped

    def test_failure_then_recovery(self):
        fx = _load("failure_ignored_reset")
        recvs = [bytes.fromhex(s["hex"]) for s in fx["steps"]
                 if s["dir"] == "recv"]
        failure = _decode_stream(recvs[2])[0]
        assert failure.tag == 0x7F
        assert failure.fields[0]["code"].startswith("Neo.ClientError")
        ignored = _decode_stream(recvs[3])[0]
        assert ignored.tag == 0x7E
        reset_ok = _decode_stream(recvs[4])[0]
        assert reset_ok.tag == 0x70
        recovered = _decode_stream(recvs[6])
        assert recovered[0].fields[0] == [2]

    def test_client_bytes_use_smallest_int_encoding(self):
        """The independent encoder must agree with the JS-compat contract:
        param 42 in create_match_params is a tiny int (1 byte, 0x2A)."""
        fx = _load("create_match_params")
        run_step = bytes.fromhex(fx["steps"][4]["hex"])
        assert b"\x82ic\x2a"[-1:] == b"\x2a"  # sanity for the reader
        # the encoded RUN message contains ...n": 42 as 0x81 'n' 0x2A
        assert b"\x81n\x2a" in run_step

    def test_fixtures_exist(self):
        assert set(FIXTURES) >= {
            "hello_logon_run_pull", "create_match_params",
            "failure_ignored_reset",
        }
