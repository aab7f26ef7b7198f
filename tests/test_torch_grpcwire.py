"""``nornicdb_tpu_torch/server/grpcwire.py``, the port's unary gRPC over
cleartext HTTP/2 in place of grpcio, on the CPU.

- HPACK: the worked examples of RFC 7541 Appendix C (integers, literal
  forms, the request and response sequences with and without Huffman,
  eviction at a 256-byte table), every byte value through the Huffman
  code, and malformed strings refused.
- An independent oracle: libnghttp2 through ``ctypes`` encodes header
  blocks (Huffman, incremental indexing, never-indexed fields, table
  size updates) that the port's decoder must read, and decodes the port's
  encoder's blocks. Skipped where the library is absent.
- The wire, through a raw HTTP/2 peer written here: flow control with a
  message over 65,535 bytes each way (the server replenishes its windows
  as it reads, and sends nothing past the peer's window), DATA frames
  split at the peer's SETTINGS_MAX_FRAME_SIZE, PING ACK, unknown frame
  types and settings ignored, GOAWAY on ``stop``, an unsupported
  ``grpc-encoding`` answered UNIMPLEMENTED, a gzip-compressed request.
- Calls: grpcio's 4 MiB receive limit on both sides, UNIMPLEMENTED for an
  unknown method, ``abort`` codes with percent-encoded details, 16
  concurrent streams on one connection, a deadline, the metadata a
  handler sees, ``stop`` leaving no thread behind.
- Interop, where grpcio is installed: a grpcio client (``-bin`` metadata,
  which grpcio Huffman-encodes, and a gzip-compressed call) against the
  port's server, and the port's client against the JAX package's
  grpcio-backed ``GrpcSearchServer``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import gzip
import random
import socket
import struct
import threading
import time

import numpy as np
import pytest

from nornicdb_tpu_torch.server import grpcwire as gw
from nornicdb_tpu_torch.server.grpcwire import StatusCode

H = bytes.fromhex


# ------------------------------------------------------------------ HPACK
class TestHpackIntegers:
    # RFC 7541 C.1
    @pytest.mark.parametrize("value,prefix,wire", [
        (10, 5, "0a"), (1337, 5, "1f9a0a"), (42, 8, "2a"),
    ])
    def test_rfc_examples(self, value, prefix, wire):
        assert gw.encode_int(value, prefix) == H(wire)
        assert gw.decode_int(H(wire), 0, prefix) == (value, len(H(wire)))

    def test_truncated_integer_refused(self):
        with pytest.raises(gw.ProtocolError):
            gw.decode_int(H("1f9a"), 0, 5)


_REQ1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com")]
_REQ2 = _REQ1 + [("cache-control", "no-cache")]
_REQ3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         (":authority", "www.example.com"), ("custom-key", "custom-value")]
_RESP1 = [(":status", "302"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
          ("location", "https://www.example.com")]
_RESP2 = [(":status", "307")] + _RESP1[1:]
_RESP3 = [(":status", "200"), ("cache-control", "private"),
          ("date", "Mon, 21 Oct 2013 20:13:22 GMT"),
          ("location", "https://www.example.com"),
          ("content-encoding", "gzip"),
          ("set-cookie",
           "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")]

# RFC 7541 Appendix C: (blocks, decoded headers, dynamic table size after
# each block), one decoder through each sequence
RFC_SEQUENCES = {
    "C.2.1": (4096, ["400a637573746f6d2d6b65790d637573746f6d2d686561646572"],
              [[("custom-key", "custom-header")]], [55]),
    "C.2.2": (4096, ["040c2f73616d706c652f70617468"],
              [[(":path", "/sample/path")]], [0]),
    "C.2.3": (4096, ["100870617373776f726406736563726574"],
              [[("password", "secret")]], [0]),
    "C.2.4": (4096, ["82"], [[(":method", "GET")]], [0]),
    "C.3": (4096, [
        "828684410f7777772e6578616d706c652e636f6d",
        "828684be58086e6f2d6361636865",
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"],
        [_REQ1, _REQ2, _REQ3], [57, 110, 164]),
    "C.4": (4096, [
        "828684418cf1e3c2e5f23a6ba0ab90f4ff",
        "828684be5886a8eb10649cbf",
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"],
        [_REQ1, _REQ2, _REQ3], [57, 110, 164]),
    "C.5": (256, [
        "4803333032580770726976617465611d4d6f6e2c203231204f63742032303133"
        "2032303a31333a323120474d546e1768747470733a2f2f7777772e6578616d70"
        "6c652e636f6d",
        "4803333037c1c0bf",
        "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d"
        "54c05a04677a69707738666f6f3d4153444a4b48514b425a584f5157454f5049"
        "5541585157454f49553b206d61782d6167653d333630303b2076657273696f6e"
        "3d31"],
        [_RESP1, _RESP2, _RESP3], [222, 222, 215]),
    "C.6": (256, [
        "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a6"
        "2d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3",
        "4883640effc1c0bf",
        "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab"
        "77ad94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f"
        "9587316065c003ed4ee5b1063d5007"],
        [_RESP1, _RESP2, _RESP3], [222, 222, 215]),
}


class TestHpackRfc7541:
    @pytest.mark.parametrize("name", sorted(RFC_SEQUENCES))
    def test_appendix_c(self, name):
        table, blocks, want, sizes = RFC_SEQUENCES[name]
        dec = gw.HpackDecoder(table)
        for block, headers, size in zip(blocks, want, sizes):
            assert dec.decode(H(block)) == headers
            assert dec.size == size

    def test_eviction_order_after_c5(self):
        dec = gw.HpackDecoder(256)
        for block in RFC_SEQUENCES["C.5"][1]:
            dec.decode(H(block))
        # RFC 7541 C.5.3: the table after the third response
        assert list(dec.table) == [
            ("set-cookie", _RESP3[5][1]), ("content-encoding", "gzip"),
            ("date", "Mon, 21 Oct 2013 20:13:22 GMT")]

    def test_size_update_evicts_and_is_bounded(self):
        dec = gw.HpackDecoder(4096)
        for block in RFC_SEQUENCES["C.3"][1]:
            dec.decode(H(block))
        assert len(dec.table) == 3
        # an update to 60 bytes keeps the newest entry that fits (54+...)
        dec.decode(gw.encode_int(60, 5, 0x20))
        assert dec.size <= 60 and list(dec.table) == [
            ("custom-key", "custom-value")]
        dec.decode(gw.encode_int(0, 5, 0x20))
        assert dec.size == 0 and not dec.table
        with pytest.raises(gw.ProtocolError):
            dec.decode(gw.encode_int(4097, 5, 0x20))
        with pytest.raises(gw.ProtocolError):  # after a field
            dec.decode(H("82") + gw.encode_int(10, 5, 0x20))

    def test_index_out_of_range_refused(self):
        with pytest.raises(gw.ProtocolError):
            gw.HpackDecoder().decode(gw.encode_int(62, 7, 0x80))


class TestHuffman:
    def test_rfc_string(self):
        # RFC 7541 C.4.1: "www.example.com"
        assert gw.huffman_encode(b"www.example.com") == H(
            "f1e3c2e5f23a6ba0ab90f4ff")
        assert gw.huffman_decode(H("f1e3c2e5f23a6ba0ab90f4ff")) == \
            b"www.example.com"

    def test_every_byte_value(self):
        # each alone (its own padding), then all 256 in one string
        for b in range(256):
            enc = gw.huffman_encode(bytes([b]))
            assert len(enc) == (gw.HUFFMAN_LENGTHS[b] + 7) // 8
            assert gw.huffman_decode(enc) == bytes([b])
        data = bytes(range(256)) + bytes(range(255, -1, -1))
        assert gw.huffman_decode(gw.huffman_encode(data)) == data

    def test_the_code_is_prefix_free_and_complete(self):
        # Kraft's sum over the 257 lengths is exactly 1, and the codes are
        # the RFC's: '0' 00000, 'a' 00011, ' ' 010100, EOS thirty ones
        assert sum(2.0 ** -n for n in gw.HUFFMAN_LENGTHS) == 1.0
        assert gw.HUFFMAN_CODES[ord("0")] == 0b00000
        assert gw.HUFFMAN_CODES[ord("a")] == 0b00011
        assert gw.HUFFMAN_CODES[ord(" ")] == 0b010100
        assert gw.HUFFMAN_CODES[gw.EOS] == (1 << 30) - 1

    @pytest.mark.parametrize("bad", [
        "ff",  # 8 bits of padding
        "fffffffc",  # EOS (30 ones) inside the string
        "00",  # '0' then three zero bits: padding must be ones
    ])
    def test_malformed_refused(self, bad):
        with pytest.raises(gw.ProtocolError):
            gw.huffman_decode(H(bad))


# ------------------------------------------------- the libnghttp2 oracle
def _nghttp2():
    name = ctypes.util.find_library("nghttp2") or "libnghttp2.so.14"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        pytest.skip("libnghttp2 is not installed")
    lib.nghttp2_hd_deflate_hd.restype = ctypes.c_ssize_t
    lib.nghttp2_hd_deflate_hd.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(_NV), ctypes.c_size_t]
    lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
    lib.nghttp2_hd_inflate_hd2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_NV), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    return lib


class _NV(ctypes.Structure):
    _fields_ = [("name", ctypes.c_void_p), ("value", ctypes.c_void_p),
                ("namelen", ctypes.c_size_t), ("valuelen", ctypes.c_size_t),
                ("flags", ctypes.c_uint8)]


def _random_headers(rng: random.Random) -> list:
    names = [":path", ":authority", "content-type", "user-agent",
             "authorization", "x-trace", "grpc-timeout", "custom-key",
             "set-cookie", "accept-encoding"]
    out = []
    for _ in range(rng.randint(1, 12)):
        name = rng.choice(names + [f"x-{rng.randrange(10**6)}"])
        alphabet = ("abcdefghijklmnopqrstuvwxyz0123456789-_./:=;, %"
                    "ABCDEFGHIJKLMNOPQRSTUVWXYZ\"'{}[]~^|\\`!@#$&*()+?<>")
        value = "".join(rng.choice(alphabet)
                        for _ in range(rng.randint(0, 80)))
        if rng.random() < 0.2:
            value += "".join(chr(rng.randrange(0x80, 0x100))
                             for _ in range(rng.randint(1, 8)))
        out.append((name, value))
    return out


class TestNghttp2Oracle:
    @pytest.mark.parametrize("seed", range(4))
    def test_port_decodes_nghttp2_blocks(self, seed):
        lib = _nghttp2()
        rng = random.Random(seed)
        deflater = ctypes.c_void_p()
        assert lib.nghttp2_hd_deflate_new(ctypes.byref(deflater), 4096) == 0
        dec = gw.HpackDecoder(4096)
        buf = ctypes.create_string_buffer(1 << 16)
        try:
            for i in range(40):
                if i % 10 == 5:  # the encoder then emits a size update
                    lib.nghttp2_hd_deflate_change_table_size(
                        deflater, ctypes.c_size_t(rng.choice(
                            [0, 64, 256, 4096])))
                headers = _random_headers(rng)
                raw = [(n.encode("latin-1"), v.encode("latin-1"))
                       for n, v in headers]
                keep = [ctypes.create_string_buffer(x) for pair in raw
                        for x in pair]
                flags = [rng.choice([0, 0, 1]) for _ in raw]  # 1: no index
                arr = (_NV * len(raw))(*[
                    _NV(ctypes.addressof(keep[2 * j]),
                        ctypes.addressof(keep[2 * j + 1]),
                        len(n), len(v), flags[j])
                    for j, (n, v) in enumerate(raw)])
                n = lib.nghttp2_hd_deflate_hd(deflater, buf, len(buf), arr,
                                              len(raw))
                assert n > 0, n
                assert dec.decode(buf.raw[:n]) == headers, i
        finally:
            lib.nghttp2_hd_deflate_del(deflater)

    def test_nghttp2_decodes_port_blocks(self):
        lib = _nghttp2()
        rng = random.Random(7)
        inflater = ctypes.c_void_p()
        assert lib.nghttp2_hd_inflate_new(ctypes.byref(inflater)) == 0
        enc = gw.HpackEncoder()
        try:
            for _ in range(40):
                headers = _random_headers(rng)
                block = enc.encode(headers)
                got, pos = [], 0
                while True:
                    nv, fl = _NV(), ctypes.c_int(0)
                    n = lib.nghttp2_hd_inflate_hd2(
                        inflater, ctypes.byref(nv), ctypes.byref(fl),
                        block[pos:], len(block) - pos, 1)
                    assert n >= 0, n
                    pos += n
                    if fl.value & 0x2:
                        got.append((
                            ctypes.string_at(nv.name, nv.namelen).decode(
                                "latin-1"),
                            ctypes.string_at(nv.value, nv.valuelen).decode(
                                "latin-1")))
                    if fl.value & 0x1:
                        lib.nghttp2_hd_inflate_end_headers(inflater)
                        break
                assert got == headers
        finally:
            lib.nghttp2_hd_inflate_del(inflater)


# ------------------------------------------------------------ the server
def _echo(request: bytes, ctx) -> bytes:
    return request[::-1]


def _meta(request: bytes, ctx) -> bytes:
    return repr(ctx.invocation_metadata()).encode()


def _abort(request: bytes, ctx) -> bytes:
    ctx.abort(StatusCode(int(request.decode())), "nope: ü 100% sure\nline")


def _sleep(request: bytes, ctx) -> bytes:
    time.sleep(float(request.decode()))
    return b"slept"


def _big(request: bytes, ctx) -> bytes:
    return b"x" * int(request.decode())


def _boom(request: bytes, ctx) -> bytes:
    raise RuntimeError("boom")


@pytest.fixture
def server():
    srv = gw.Server("127.0.0.1", 0, max_workers=16)
    for name, fn in (("Echo", _echo), ("Meta", _meta), ("Abort", _abort),
                     ("Sleep", _sleep), ("Big", _big), ("Boom", _boom)):
        srv.add_method(f"/t.Test/{name}", fn)
    srv.start()
    yield srv
    srv.stop(0)


@pytest.fixture
def channel(server):
    ch = gw.Channel("127.0.0.1", server.port)
    yield ch
    ch.close()


class _Raw:
    """A raw HTTP/2 client peer: the preface, its SETTINGS, and frames
    read one at a time, for the checks the port's own client hides."""

    def __init__(self, port: int, settings: dict | None = None):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.settimeout(5)
        payload = b"".join(struct.pack(">HI", k, v)
                           for k, v in (settings or {}).items())
        self.sock.sendall(gw.PREFACE + gw.encode_frame(gw.SETTINGS, 0, 0,
                                                       payload))
        self.dec = gw.HpackDecoder()
        self.enc = gw.HpackEncoder()

    def frame(self):
        return gw.read_frame(self.sock)

    def send(self, *frames: bytes) -> None:
        self.sock.sendall(b"".join(frames))

    def request_headers(self, sid: int, path: str, extra=()) -> bytes:
        block = self.enc.encode([
            (":method", "POST"), (":scheme", "http"), (":path", path),
            (":authority", "t"), ("content-type", "application/grpc"),
            ("te", "trailers"), *extra])
        return gw.encode_frame(gw.HEADERS, gw.END_HEADERS, sid, block)

    def until(self, pred, limit: int = 10_000):
        """Frames until one satisfies ``pred``; answers the server's
        SETTINGS on the way."""
        seen = []
        for _ in range(limit):
            f = self.frame()
            seen.append(f)
            if f[0] == gw.SETTINGS and not f[1] & gw.ACK:
                self.send(gw.encode_frame(gw.SETTINGS, gw.ACK, 0))
            if pred(f):
                return seen
        raise AssertionError("frame never came")

    def response(self, sid: int):
        """Headers, body and trailers of stream ``sid`` (window updates
        for its DATA sent back as it is read)."""
        heads, body = [], bytearray()
        while True:
            ftype, flags, s, payload = self.frame()
            if ftype == gw.SETTINGS and not flags & gw.ACK:
                self.send(gw.encode_frame(gw.SETTINGS, gw.ACK, 0))
            if s != sid:
                continue
            if ftype == gw.HEADERS:
                heads.append(self.dec.decode(payload))
            elif ftype == gw.DATA:
                body += payload
                if payload:
                    inc = struct.pack(">I", len(payload))
                    self.send(gw.encode_frame(gw.WINDOW_UPDATE, 0, 0, inc),
                              gw.encode_frame(gw.WINDOW_UPDATE, 0, sid, inc))
            if flags & gw.END_STREAM:
                return heads, bytes(body)

    def close(self):
        self.sock.close()


class TestWire:
    def test_flow_control_both_ways_and_frame_size(self, server):
        """A 200,000-byte request from a raw peer that keeps to the
        server's 65,535-byte windows (so it must see WINDOW_UPDATEs), and
        a 200,000-byte response to a peer whose stream window is 1,000:
        the server sends 1,000 bytes, stops, and goes on only after a
        WINDOW_UPDATE; no DATA frame is longer than 16,384 bytes."""
        raw = _Raw(server.port, {gw.SETTINGS_INITIAL_WINDOW_SIZE: 1000})
        try:
            n = 200_000
            msg = gw.frame_message(str(n).encode())
            raw.send(raw.request_headers(1, "/t.Test/Big"),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 1, msg))
            got = bytearray()
            seen = raw.until(lambda f: f[0] == gw.DATA)
            got += seen[-1][3]
            assert len(got) == 1000
            raw.sock.settimeout(0.5)
            with pytest.raises(socket.timeout):  # stalled at the window
                while True:
                    f = raw.frame()
                    assert f[0] != gw.DATA
            raw.sock.settimeout(5)
            while True:  # open the windows frame by frame
                raw.send(gw.encode_frame(gw.WINDOW_UPDATE, 0, 1,
                                         struct.pack(">I", 16_384)),
                         gw.encode_frame(gw.WINDOW_UPDATE, 0, 0,
                                         struct.pack(">I", 16_384)))
                f = raw.frame()
                if f[0] == gw.DATA:
                    assert len(f[3]) <= 16_384
                    got += f[3]
                elif f[0] == gw.HEADERS and f[1] & gw.END_STREAM:
                    break
            assert bytes(got) == gw.frame_message(b"x" * n)
            # the other way: 200,000 bytes within the server's windows
            body = gw.frame_message(bytes(range(256)) * 782)
            window = gw.DEFAULT_WINDOW
            raw.send(raw.request_headers(3, "/t.Test/Echo"))
            pos, updates = 0, 0
            while pos < len(body):
                while window <= 0:
                    f = raw.frame()
                    if f[0] == gw.WINDOW_UPDATE and f[2] == 0:
                        window += int.from_bytes(f[3], "big")
                        updates += 1
                chunk = body[pos:pos + min(16_384, window)]
                pos += len(chunk)
                window -= len(chunk)
                raw.send(gw.encode_frame(
                    gw.DATA, gw.END_STREAM if pos == len(body) else 0, 3,
                    chunk))
            heads, data = raw.response(3)
            assert updates > 0
            assert dict(heads[-1])["grpc-status"] == "0"
            assert data == gw.frame_message(body[5:][::-1])
        finally:
            raw.close()

    def test_messages_over_the_window_through_the_client(self, channel):
        for n in (65_535, 65_536, 300_001):
            msg = np.random.default_rng(n).bytes(n)
            assert channel.unary_unary("/t.Test/Echo")(msg, timeout=10) == \
                msg[::-1]

    def test_ping_unknown_frames_and_settings(self, server):
        raw = _Raw(server.port, {0xFE03: 1, 0x7777: 42})
        try:
            raw.send(gw.encode_frame(0xFA, 0x3, 0, b"junk"),
                     gw.encode_frame(gw.PING, 0, 0, b"12345678"))
            seen = raw.until(lambda f: f[0] == gw.PING)
            assert seen[-1][1] & gw.ACK and seen[-1][3] == b"12345678"
            raw.send(raw.request_headers(1, "/t.Test/Echo"),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 1,
                                     gw.frame_message(b"abc")))
            heads, data = raw.response(1)
            assert data == gw.frame_message(b"cba")
            assert dict(heads[0])[":status"] == "200"
            assert dict(heads[0])["content-type"] == "application/grpc"
            assert dict(heads[1])["grpc-status"] == "0"
        finally:
            raw.close()

    def test_encodings(self, server):
        raw = _Raw(server.port)
        try:
            packed = gzip.compress(b"compressed!")
            msg = b"\x01" + struct.pack(">I", len(packed)) + packed
            raw.send(raw.request_headers(1, "/t.Test/Echo",
                                         [("grpc-encoding", "gzip")]),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 1, msg))
            heads, data = raw.response(1)
            assert data == gw.frame_message(b"!desserpmoc")
            raw.send(raw.request_headers(3, "/t.Test/Echo",
                                         [("grpc-encoding", "br")]),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 3,
                                     gw.frame_message(b"x")))
            heads, data = raw.response(3)
            assert len(heads) == 1 and data == b""  # trailers-only
            assert dict(heads[0])["grpc-status"] == str(
                int(StatusCode.UNIMPLEMENTED))
        finally:
            raw.close()

    def test_goaway_on_stop(self):
        srv = gw.Server("127.0.0.1", 0)
        srv.add_method("/t.Test/Echo", _echo)
        srv.start()
        raw = _Raw(srv.port)
        try:
            raw.send(raw.request_headers(1, "/t.Test/Echo"),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 1,
                                     gw.frame_message(b"ab")))
            raw.response(1)
            srv.stop(0)
            seen = raw.until(lambda f: f[0] == gw.GOAWAY)
            last, code = struct.unpack(">II", seen[-1][3])
            assert (last, code) == (1, gw.NO_ERROR)
        finally:
            raw.close()
            srv.stop(0)

    def test_reset_stream_leaves_the_connection_serving(self, server):
        raw = _Raw(server.port)
        try:
            raw.send(raw.request_headers(1, "/t.Test/Sleep"),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 1,
                                     gw.frame_message(b"0.3")),
                     gw.encode_frame(gw.RST_STREAM, 0, 1,
                                     struct.pack(">I", gw.CANCEL)))
            raw.send(raw.request_headers(3, "/t.Test/Echo"),
                     gw.encode_frame(gw.DATA, gw.END_STREAM, 3,
                                     gw.frame_message(b"ok")))
            heads, data = raw.response(3)
            assert data == gw.frame_message(b"ko")
        finally:
            raw.close()


class TestCalls:
    def test_message_limit_both_sides(self, channel):
        limit = gw.MAX_MESSAGE_BYTES
        assert limit == 4_194_304  # grpcio's default
        assert len(channel.unary_unary("/t.Test/Echo")(b"y" * limit,
                                                       timeout=30)) == limit
        with pytest.raises(gw.RpcError) as e:
            channel.unary_unary("/t.Test/Echo")(b"y" * (limit + 1),
                                                timeout=30)
        assert e.value.code() == StatusCode.RESOURCE_EXHAUSTED
        assert "4194305 vs. 4194304" in e.value.details()
        with pytest.raises(gw.RpcError) as e:  # the client's own limit
            channel.unary_unary("/t.Test/Big")(str(limit + 1).encode(),
                                               timeout=30)
        assert e.value.code() == StatusCode.RESOURCE_EXHAUSTED
        # the channel still serves
        assert channel.unary_unary("/t.Test/Echo")(b"ab", timeout=5) == b"ba"

    def test_unknown_method_is_unimplemented(self, channel):
        with pytest.raises(gw.RpcError) as e:
            channel.unary_unary("/t.Test/Nope")(b"", timeout=5)
        assert e.value.code() == StatusCode.UNIMPLEMENTED

    @pytest.mark.parametrize("code", [StatusCode.NOT_FOUND,
                                      StatusCode.PERMISSION_DENIED,
                                      StatusCode.UNAVAILABLE,
                                      StatusCode.UNAUTHENTICATED])
    def test_abort_codes_and_details(self, channel, code):
        with pytest.raises(gw.RpcError) as e:
            channel.unary_unary("/t.Test/Abort")(str(int(code)).encode(),
                                                 timeout=5)
        assert e.value.code() == code
        assert e.value.details() == "nope: ü 100% sure\nline"

    def test_details_percent_encoding(self):
        text = "nope: ü 100% sure\nline"
        assert gw.percent_encode(text) == "nope: %C3%BC 100%25 sure%0Aline"
        assert gw.percent_decode(gw.percent_encode(text)) == text
        assert gw.percent_decode("50%") == "50%"  # a stray '%' kept

    def test_handler_exception_is_unknown(self, channel):
        with pytest.raises(gw.RpcError) as e:
            channel.unary_unary("/t.Test/Boom")(b"", timeout=5)
        assert e.value.code() == StatusCode.UNKNOWN
        assert "boom" in e.value.details()

    def test_sixteen_concurrent_streams_on_one_connection(self, channel):
        errors, results = [], {}
        barrier = threading.Barrier(16)

        def worker(i):
            try:
                barrier.wait()
                for j in range(8):
                    m = f"{i}:{j}".encode() * (1 + 997 * (j % 3))
                    results[(i, j)] = channel.unary_unary("/t.Test/Echo")(
                        m, timeout=20) == m[::-1]
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        conn0 = channel._connection()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors and len(results) == 128 and all(results.values())
        assert channel._connection() is conn0
        assert conn0.next_id == 2 * 128 + 1

    def test_deadline(self, channel):
        with pytest.raises(gw.RpcError) as e:
            channel.unary_unary("/t.Test/Sleep")(b"1.0", timeout=0.2)
        assert e.value.code() == StatusCode.DEADLINE_EXCEEDED
        assert channel.unary_unary("/t.Test/Echo")(b"ab", timeout=5) == b"ba"

    def test_metadata_a_handler_sees(self, channel):
        got = channel.unary_unary("/t.Test/Meta")(
            b"", timeout=5, metadata=[("traceparent", "00-ab-cd-01"),
                                      ("X-Key", "v"),
                                      ("blob-bin", bytes(range(40)))])
        md = eval(got)  # noqa: S307 - the handler's own repr
        names = [k for k, _ in md]
        assert not any(k.startswith(":") for k in names)
        assert not {"content-type", "te", "grpc-timeout"} & set(names)
        assert ("traceparent", "00-ab-cd-01") in md
        assert ("x-key", "v") in md
        assert ("blob-bin", bytes(range(40))) in md

    def test_connection_refused_is_unavailable(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        with gw.Channel("127.0.0.1", port) as ch:
            with pytest.raises(gw.RpcError) as e:
                ch.unary_unary("/t.Test/Echo")(b"", timeout=2)
        assert e.value.code() == StatusCode.UNAVAILABLE

    def test_stop_leaves_no_thread(self):
        before = {t.ident for t in threading.enumerate()}
        srv = gw.Server("127.0.0.1", 0, max_workers=4)
        srv.add_method("/t.Test/Echo", _echo)
        srv.start()
        idle = socket.create_connection(("127.0.0.1", srv.port))  # no preface
        ch = gw.Channel("127.0.0.1", srv.port)
        assert ch.unary_unary("/t.Test/Echo")(b"ab", timeout=5) == b"ba"
        srv.stop(1)
        ch.close()
        idle.close()
        left = [t for t in threading.enumerate()
                if t.ident not in before and t.name.startswith("grpcwire")]
        assert not left, left

    def test_bind_failure_raises(self, server):
        with pytest.raises(OSError):
            gw.Server("127.0.0.1", server.port)


# ------------------------------------------------------------ interop
class TestGrpcioInterop:
    def test_grpcio_client_against_the_port_server(self, server):
        grpc = pytest.importorskip("grpc")
        with grpc.insecure_channel(f"127.0.0.1:{server.port}") as ch:
            def call(method, req, **kw):
                return ch.unary_unary(method)(req, timeout=10, **kw)

            assert call("/t.Test/Echo", b"hello") == b"olleh"
            big = np.random.default_rng(1).bytes(300_000)
            assert call("/t.Test/Echo", big) == big[::-1]
            assert call("/t.Test/Echo", b"zipped" * 1000,
                        compression=grpc.Compression.Gzip) == \
                (b"zipped" * 1000)[::-1]
            blob = bytes(range(256)) * 3
            md = eval(call("/t.Test/Meta", b"", metadata=[  # noqa: S307
                ("x-blob-bin", blob), ("x-text", "with spaces, and %")]))
            assert ("x-blob-bin", blob) in md
            assert ("x-text", "with spaces, and %") in md
            with pytest.raises(grpc.RpcError) as e:
                call("/t.Test/Abort", str(int(StatusCode.NOT_FOUND)).encode())
            assert e.value.code() == grpc.StatusCode.NOT_FOUND
            assert e.value.details() == "nope: ü 100% sure\nline"
            with pytest.raises(grpc.RpcError) as e:
                call("/t.Test/Nope", b"")
            assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
            with pytest.raises(grpc.RpcError) as e:
                call("/t.Test/Echo", b"z" * (gw.MAX_MESSAGE_BYTES + 1))
            assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED

    def test_port_client_against_the_jax_grpcio_server(self):
        pytest.importorskip("grpc")
        import nornicdb_tpu
        from nornicdb_tpu.embed import HashEmbedder
        from nornicdb_tpu.server.grpc_search import GrpcSearchServer

        from nornicdb_tpu_torch.server import grpc_search as port_gs

        db = nornicdb_tpu.open_db("")
        db.set_embedder(HashEmbedder(32))
        for i in range(20):
            db.store(f"document {i} about graphs and vectors", node_id=f"d{i}")
        db.process_pending_embeddings()
        srv = GrpcSearchServer(db, port=0)
        srv.start()
        try:
            with gw.Channel("127.0.0.1", srv.port) as ch:
                out = port_gs.search_over_grpc(
                    "127.0.0.1", srv.port, query="document 3 graphs",
                    limit=5, channel=ch)
                assert out["hits"] and out["hits"][0]["id"]
                vec = HashEmbedder(32).embed("document 7 about graphs")
                out = port_gs.search_over_grpc("127.0.0.1", srv.port,
                                               vector=vec, limit=3,
                                               channel=ch)
                assert len(out["hits"]) == 3
                with pytest.raises(gw.RpcError) as e:
                    ch.unary_unary("/nornicdb.SearchService/Nope")(
                        b"", timeout=5)
                assert e.value.code() == StatusCode.UNIMPLEMENTED
        finally:
            srv.stop()
            db.close()
