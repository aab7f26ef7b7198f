"""Unary gRPC over cleartext HTTP/2 (h2c), on the standard library only.

The port's stand-in for ``grpcio``, which the JAX package's two gRPC
servers (``server/grpc_search.py``, ``server/qdrant_grpc.py``) and its
client helper (``search_over_grpc``) run on. Both hand-encode their
protobuf messages and use only a small part of grpcio: unary-unary
methods over raw bytes, the call's metadata, ``abort(code, details)``, an
insecure port, start and stop, and on the client
``channel.unary_unary(method)(request, timeout=..., metadata=...)``. This
module is that part, written over ``socket`` and ``threading``:

- ``Server(host, port, max_workers)``: a table of ``bytes -> bytes``
  handlers (``add_method``), each called as ``handler(request,
  context)`` on a thread pool; ``context.invocation_metadata()`` (the
  pseudo-headers and transport headers left out, as grpcio does; ``-bin``
  values base64-decoded to bytes) and ``context.abort(code, details)``.
  ``start()``, ``stop(grace)``.
- ``Channel(host, port)``: one connection, many concurrent calls;
  ``unary_unary(method)(request, timeout=None, metadata=None)`` returns
  the response bytes or raises ``RpcError`` with ``.code()`` and
  ``.details()``.

The wire (RFC 9113 and the gRPC HTTP/2 protocol): the client preface,
SETTINGS and their ACK; HEADERS and CONTINUATION; DATA carrying the
5-byte length prefix, with the compressed flag honoured for
``grpc-encoding: gzip`` (any other encoding answers UNIMPLEMENTED);
WINDOW_UPDATE flow control both ways (the windows are replenished as DATA
is read, and nothing is sent past the peer's windows or its
SETTINGS_MAX_FRAME_SIZE); PING ACK; RST_STREAM; GOAWAY on ``stop``.
Unknown frame types and settings are ignored. A response is HEADERS
(``:status 200``), DATA, then trailers (``grpc-status``, the
percent-encoded ``grpc-message``); an error is trailers-only. An unknown
method answers UNIMPLEMENTED. HPACK (RFC 7541) is whole on the decoding
side: the static and dynamic tables with size updates and eviction, and
Huffman decoding; the encoder writes literals without indexing, Huffman
coded where that is shorter.

grpcio's default receive limit is kept: a message over MAX_MESSAGE_BYTES
(4 MiB) is refused with RESOURCE_EXHAUSTED, by the server and by the
client. Streaming RPCs, TLS and grpcio's other options are left out.
"""

from __future__ import annotations

import base64
import enum
import socket
import struct
import threading
import time
import zlib
from collections import deque
from concurrent import futures
from typing import Callable, Iterable, Optional

MAX_MESSAGE_BYTES = 4 * 1024 * 1024  # grpcio's default receive limit

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types and flags (RFC 9113 section 6); PRIORITY (2) and
# PUSH_PROMISE (5, refused by SETTINGS_ENABLE_PUSH) are read as unknown
DATA, HEADERS, RST_STREAM, SETTINGS = 0, 1, 3, 4
PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 6, 7, 8, 9
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20

# settings (section 6.5.2)
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

# error codes (section 7)
NO_ERROR, PROTOCOL_ERROR, REFUSED_STREAM, CANCEL = 0x0, 0x1, 0x7, 0x8

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_WINDOW = (1 << 31) - 1

# headers a handler's context does not see (grpcio keeps them out of
# invocation_metadata too)
_TRANSPORT_HEADERS = frozenset((
    "content-type", "te", "grpc-timeout", "grpc-encoding",
    "grpc-accept-encoding", "grpc-status", "grpc-message",
))


class StatusCode(enum.IntEnum):
    """grpcio's status codes, by name and number."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that did not end OK, as grpcio's client raises it."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class AbortError(Exception):
    """Raised by ``ServicerContext.abort``; the server answers the call
    with its code and details."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


class ProtocolError(Exception):
    """The peer broke RFC 9113 or RFC 7541; the connection is closed."""


# -------------------------------------------------------------------- HPACK
# RFC 7541 Appendix A
STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
)
_STATIC_NAME = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_NAME.setdefault(_n, _i)
_STATIC_PAIR = {pair: i for i, pair in enumerate(STATIC_TABLE, 1)}

# RFC 7541 Appendix B: the code length of each of the 256 byte values,
# then of EOS (256). The code is canonical: codes are handed out in order
# of length, then of symbol, so these lengths fix every code.
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
)
EOS = 256


def _canonical_codes(lengths) -> list[int]:
    codes = [0] * len(lengths)
    code, prev = 0, 0
    for length, sym in sorted((n, s) for s, n in enumerate(lengths)):
        code <<= length - prev
        codes[sym] = code
        code += 1
        prev = length
    return codes


HUFFMAN_CODES = _canonical_codes(HUFFMAN_LENGTHS)
# decoding by length: (length, code) -> symbol
_HUFFMAN_DECODE = {(n, c): s for s, (n, c) in
                   enumerate(zip(HUFFMAN_LENGTHS, HUFFMAN_CODES))}
_HUFFMAN_MIN = min(HUFFMAN_LENGTHS)


def huffman_encode(data: bytes) -> bytes:
    acc, nbits = 0, 0
    for b in data:
        acc = (acc << HUFFMAN_LENGTHS[b]) | HUFFMAN_CODES[b]
        nbits += HUFFMAN_LENGTHS[b]
    pad = -nbits % 8  # padded with the most significant bits of EOS
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code, n = 0, 0
    table = _HUFFMAN_DECODE
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if n >= _HUFFMAN_MIN:
                sym = table.get((n, code))
                if sym is not None:
                    if sym == EOS:
                        raise ProtocolError("EOS in a Huffman string")
                    out.append(sym)
                    code, n = 0, 0
        if n > 30:
            raise ProtocolError("invalid Huffman code")
    # what is left must be padding: under 8 bits, all ones (an EOS prefix)
    if n > 7 or code != (1 << n) - 1:
        raise ProtocolError("invalid Huffman padding")
    return bytes(out)


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """An HPACK integer with a ``prefix``-bit prefix; ``first`` holds the
    flag bits above the prefix."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes((first | value,))
    out = bytearray((first | limit,))
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(buf: bytes, pos: int, prefix: int) -> tuple[int, int]:
    limit = (1 << prefix) - 1
    if pos >= len(buf):
        raise ProtocolError("truncated integer")
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise ProtocolError("truncated integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 35:
            raise ProtocolError("integer overflow")


def _encode_str(data: bytes) -> bytes:
    huff = huffman_encode(data)
    if len(huff) < len(data):
        return encode_int(len(huff), 7, 0x80) + huff
    return encode_int(len(data), 7) + data


def _decode_str(buf: bytes, pos: int) -> tuple[bytes, int]:
    if pos >= len(buf):
        raise ProtocolError("truncated string")
    huff = buf[pos] & 0x80
    length, pos = decode_int(buf, pos, 7)
    if pos + length > len(buf):
        raise ProtocolError("truncated string")
    raw = buf[pos:pos + length]
    return (huffman_decode(raw) if huff else bytes(raw)), pos + length


class HpackEncoder:
    """Literal header fields without indexing (RFC 7541 section 6.2.2):
    the encoder keeps no dynamic table, so the peer's table size never
    matters to it. A name in the static table is written by its index."""

    def encode(self, headers: Iterable[tuple[str, str]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            full = _STATIC_PAIR.get((name, value))
            if full is not None:
                out += encode_int(full, 7, 0x80)
                continue
            idx = _STATIC_NAME.get(name)
            if idx is not None:
                out += encode_int(idx, 4)
            else:
                out += b"\x00" + _encode_str(name.encode("latin-1"))
            out += _encode_str(value.encode("latin-1"))
        return bytes(out)


class HpackDecoder:
    """RFC 7541 decoding: indexed fields, the three literal forms, dynamic
    table size updates (bounded by ``max_table_size``, the
    SETTINGS_HEADER_TABLE_SIZE this side advertised) and eviction."""

    def __init__(self, max_table_size: int = 4096):
        self.settings_limit = max_table_size
        self.max_size = max_table_size
        self.size = 0
        self.table: deque[tuple[str, str]] = deque()  # newest first

    def _add(self, name: str, value: str) -> None:
        entry = len(name) + len(value) + 32
        self.table.appendleft((name, value))
        self.size += entry
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            n, v = self.table.pop()
            self.size -= len(n) + len(v) + 32

    def _get(self, index: int) -> tuple[str, str]:
        if index <= 0:
            raise ProtocolError("header index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        dyn = index - len(STATIC_TABLE) - 1
        if dyn >= len(self.table):
            raise ProtocolError(f"header index {index} out of range")
        return self.table[dyn]

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        pos, n = 0, len(block)
        seen_field = False
        while pos < n:
            b = block[pos]
            if b & 0x80:  # indexed field
                idx, pos = decode_int(block, pos, 7)
                headers.append(self._get(idx))
                seen_field = True
            elif b & 0xC0 == 0x40:  # literal with incremental indexing
                name, value, pos = self._literal(block, pos, 6)
                self._add(name, value)
                headers.append((name, value))
                seen_field = True
            elif b & 0xE0 == 0x20:  # dynamic table size update
                if seen_field:
                    raise ProtocolError("table size update after a field")
                size, pos = decode_int(block, pos, 5)
                if size > self.settings_limit:
                    raise ProtocolError("table size over the settings")
                self.max_size = size
                self._evict()
            else:  # literal without indexing (0000) or never indexed (0001)
                name, value, pos = self._literal(block, pos, 4)
                headers.append((name, value))
                seen_field = True
        return headers

    def _literal(self, block: bytes, pos: int,
                 prefix: int) -> tuple[str, str, int]:
        idx, pos = decode_int(block, pos, prefix)
        if idx:
            name = self._get(idx)[0]
        else:
            raw, pos = _decode_str(block, pos)
            name = raw.decode("latin-1")
        raw, pos = _decode_str(block, pos)
        return name, raw.decode("latin-1"), pos


# ------------------------------------------------------------------ framing
def encode_frame(ftype: int, flags: int, stream: int,
                 payload: bytes = b"") -> bytes:
    return (struct.pack(">I", len(payload))[1:]
            + struct.pack(">BBI", ftype, flags, stream & MAX_WINDOW)
            + payload)


def read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> tuple[int, int, int, bytes]:
    head = read_exact(sock, 9)
    length = int.from_bytes(head[:3], "big")
    ftype, flags = head[3], head[4]
    stream = int.from_bytes(head[5:9], "big") & MAX_WINDOW
    return ftype, flags, stream, read_exact(sock, length)


def _strip_padding(flags: int, payload: bytes) -> bytes:
    if flags & PADDED:
        if not payload:
            raise ProtocolError("padded frame without a pad length")
        pad = payload[0]
        if pad >= len(payload):
            raise ProtocolError("padding longer than the frame")
        payload = payload[1:len(payload) - pad]
    return payload


def percent_encode(text: str) -> str:
    """grpc-message's encoding: UTF-8, every byte outside 0x20-0x7E and
    '%' written as %XX."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def percent_decode(text: str) -> str:
    raw = text.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        if raw[i] == 0x25 and _is_hex(raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", errors="replace")


def _is_hex(pair: bytes) -> bool:
    return len(pair) == 2 and all(c in b"0123456789abcdefABCDEF" for c in pair)


def frame_message(payload: bytes) -> bytes:
    """A gRPC length-prefixed message, uncompressed."""
    return b"\x00" + struct.pack(">I", len(payload)) + payload


def _decompress_gzip(data: bytes) -> bytes:
    d = zlib.decompressobj(16 + zlib.MAX_WBITS)
    out = d.decompress(data, MAX_MESSAGE_BYTES + 1)
    if len(out) > MAX_MESSAGE_BYTES:
        raise _TooLarge(len(out))
    if not d.eof:
        raise ValueError("truncated gzip message")
    return out


class _TooLarge(Exception):
    def __init__(self, size: int):
        super().__init__(size)
        self.size = size


def _too_large(size) -> str:
    return (f"Received message larger than max ({size} vs. "
            f"{MAX_MESSAGE_BYTES})")


def parse_message(body: bytes, encoding: str) -> bytes:
    """The one message of a unary call's body: its 5-byte prefix, then the
    payload, gunzipped when the flag says so. Raises ``AbortError``."""
    if len(body) < 5:
        raise AbortError(StatusCode.INTERNAL, "missing message")
    flag = body[0]
    length = int.from_bytes(body[1:5], "big")
    if length > MAX_MESSAGE_BYTES:
        raise AbortError(StatusCode.RESOURCE_EXHAUSTED, _too_large(length))
    if len(body) != 5 + length:
        raise AbortError(StatusCode.INTERNAL, "not one message")
    payload = body[5:]
    if flag == 0:
        return payload
    if flag != 1 or encoding != "gzip":
        raise AbortError(StatusCode.INTERNAL,
                         f"compressed message with encoding {encoding!r}")
    try:
        return _decompress_gzip(payload)
    except _TooLarge as e:
        raise AbortError(StatusCode.RESOURCE_EXHAUSTED, _too_large(e.size))
    except (ValueError, zlib.error) as e:
        raise AbortError(StatusCode.INTERNAL, f"bad gzip message: {e}")


def _metadata_pairs(headers: list[tuple[str, str]]) -> tuple:
    out = []
    for name, value in headers:
        if name.startswith(":") or name in _TRANSPORT_HEADERS:
            continue
        if name.endswith("-bin"):
            out.append((name, base64.b64decode(value + "=" * (-len(value) % 4))))
        else:
            out.append((name, value))
    return tuple(out)


class _Stream:
    __slots__ = ("id", "headers", "block", "body", "window", "done",
                 "trailers", "refused", "remote_ended", "reset",
                 "block_ends_stream", "orphan")

    def __init__(self, sid: int, window: int, orphan: bool = False):
        self.id = sid
        # a stream this side has already let go (answered, cancelled):
        # its header blocks are decoded for the HPACK state and dropped
        self.orphan = orphan
        self.headers: Optional[list] = None
        self.trailers: Optional[list] = None
        self.block = bytearray()  # a header block awaiting CONTINUATION
        self.block_ends_stream = False
        self.body = bytearray()
        self.window = window  # what this side may still send on it
        self.remote_ended = False
        self.reset: Optional[int] = None
        self.refused: Optional[AbortError] = None  # over the size limit
        self.done = threading.Event()


class _Connection:
    """One HTTP/2 connection, for either side: the reader thread, the
    HPACK state, both directions of flow control, and writes serialised
    under one lock. ``stream_for_headers`` and the ``on_*`` methods are
    the side's hooks."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.wlock = threading.Lock()  # one frame sequence at a time
        self.flow = threading.Condition()  # send windows; never held writing
        self.conn_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.decoder = HpackDecoder()
        self.encoder = HpackEncoder()
        self.streams: dict[int, _Stream] = {}
        self.closed = False
        self.goaway_last: Optional[int] = None
        self.max_seen = 0
        self.continuation: Optional[_Stream] = None

    # -- writing -------------------------------------------------------------
    def send(self, data: bytes) -> None:
        with self.wlock:
            if self.closed:
                raise ConnectionError("connection closed")
            self.sock.sendall(data)

    def send_headers(self, sid: int, headers: list, end_stream: bool) -> None:
        block = self.encoder.encode(headers)
        limit = self.peer_max_frame
        first, rest = block[:limit], block[limit:]
        flags = END_STREAM if end_stream else 0
        frames = [encode_frame(HEADERS, flags | (0 if rest else END_HEADERS),
                               sid, first)]
        while rest:
            chunk, rest = rest[:limit], rest[limit:]
            frames.append(encode_frame(CONTINUATION,
                                       0 if rest else END_HEADERS, sid, chunk))
        self.send(b"".join(frames))

    def send_data(self, st: _Stream, data: bytes, end_stream: bool,
                  deadline: Optional[float] = None) -> None:
        """DATA within the peer's connection and stream windows and its
        frame size; waits for WINDOW_UPDATE without holding the write lock
        (the reader applies updates under ``flow`` alone)."""
        view = memoryview(data)
        if not len(view):
            self.send(encode_frame(DATA, END_STREAM if end_stream else 0,
                                   st.id))
            return
        while len(view):
            with self.flow:
                while (self.conn_window <= 0 or st.window <= 0) and not (
                        self.closed or st.reset is not None):
                    left = None if deadline is None else \
                        deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise TimeoutError("flow control window")
                    self.flow.wait(left if left is not None else 1.0)
                if self.closed:
                    raise ConnectionError("connection closed")
                if st.reset is not None:
                    raise ConnectionResetError(f"stream reset {st.reset}")
                n = min(len(view), self.conn_window, st.window,
                        self.peer_max_frame)
                self.conn_window -= n
                st.window -= n
            chunk = bytes(view[:n])
            view = view[n:]
            last = end_stream and not len(view)
            self.send(encode_frame(DATA, END_STREAM if last else 0, st.id,
                                   chunk))

    def send_settings(self, settings: dict) -> None:
        payload = b"".join(struct.pack(">HI", k, v)
                           for k, v in settings.items())
        self.send(encode_frame(SETTINGS, 0, 0, payload))

    def send_rst(self, sid: int, code: int) -> None:
        try:
            self.send(encode_frame(RST_STREAM, 0, sid,
                                   struct.pack(">I", code)))
        except OSError:
            pass

    def send_goaway(self, code: int = NO_ERROR) -> None:
        try:
            self.send(encode_frame(GOAWAY, 0, 0,
                                   struct.pack(">II", self.max_seen, code)))
        except OSError:
            pass

    # -- reading -------------------------------------------------------------
    def read_loop(self) -> None:
        try:
            while True:
                self.handle(*read_frame(self.sock))
        except (OSError, ConnectionError, ProtocolError) as e:
            if isinstance(e, ProtocolError):
                self.send_goaway(PROTOCOL_ERROR)
        finally:
            self.shutdown()

    def handle(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self.continuation is not None and ftype != CONTINUATION:
            raise ProtocolError("expected CONTINUATION")
        if ftype == DATA:
            self._data(flags, sid, payload)
        elif ftype == HEADERS:
            payload = _strip_padding(flags, payload)
            if flags & PRIORITY_FLAG:
                payload = payload[5:]
            st = self.stream_for_headers(sid)
            st.block = bytearray(payload)
            st.block_ends_stream = bool(flags & END_STREAM)
            if flags & END_HEADERS:
                self._header_block(st)
            else:
                self.continuation = st
        elif ftype == CONTINUATION:
            st = self.continuation
            if st is None or st.id != sid:
                raise ProtocolError("unexpected CONTINUATION")
            st.block += payload
            if flags & END_HEADERS:
                self.continuation = None
                self._header_block(st)
        elif ftype == SETTINGS:
            if flags & ACK:
                return
            self._settings(payload)
            self.send(encode_frame(SETTINGS, ACK, 0))
        elif ftype == PING:
            if not flags & ACK:
                self.send(encode_frame(PING, ACK, 0, payload))
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise ProtocolError("WINDOW_UPDATE length")
            inc = int.from_bytes(payload, "big") & MAX_WINDOW
            with self.flow:
                if sid == 0:
                    self.conn_window += inc
                elif sid in self.streams:
                    self.streams[sid].window += inc
                self.flow.notify_all()
        elif ftype == RST_STREAM:
            st = self.streams.get(sid)
            if st is not None:
                code = int.from_bytes(payload[:4], "big")
                with self.flow:
                    st.reset = code
                    self.flow.notify_all()
                self.on_reset(st)
        elif ftype == GOAWAY:
            self.goaway_last = int.from_bytes(payload[:4], "big") & MAX_WINDOW
            self.on_goaway()
        # PRIORITY, PUSH_PROMISE and unknown types are ignored

    def _settings(self, payload: bytes) -> None:
        for i in range(0, len(payload) - len(payload) % 6, 6):
            key, value = struct.unpack_from(">HI", payload, i)
            if key == SETTINGS_INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise ProtocolError("initial window too large")
                with self.flow:
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for st in self.streams.values():
                        st.window += delta
                    self.flow.notify_all()
            elif key == SETTINGS_MAX_FRAME_SIZE:
                self.peer_max_frame = max(DEFAULT_MAX_FRAME,
                                          min(value, (1 << 24) - 1))
            # the peer's HEADER_TABLE_SIZE bounds the encoder's table, and
            # the encoder indexes nothing; unknown settings are ignored

    def _data(self, flags: int, sid: int, payload: bytes) -> None:
        size = len(payload)
        data = _strip_padding(flags, payload)
        st = self.streams.get(sid)
        # replenish what was read: the connection always, the stream while
        # more of it may come
        updates = encode_frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", size)) \
            if size else b""
        if size and st is not None and not flags & END_STREAM:
            updates += encode_frame(WINDOW_UPDATE, 0, sid,
                                    struct.pack(">I", size))
        if updates:
            self.send(updates)
        if st is None or st.remote_ended:
            return
        if st.refused is None:
            st.body += data
            if len(st.body) >= 5:
                length = int.from_bytes(st.body[1:5], "big")
                if length > MAX_MESSAGE_BYTES or \
                        len(st.body) > 5 + MAX_MESSAGE_BYTES:
                    st.refused = AbortError(StatusCode.RESOURCE_EXHAUSTED,
                                            _too_large(length))
                    st.body = bytearray()
        if flags & END_STREAM:
            st.remote_ended = True
            self.on_end(st)

    def _header_block(self, st: _Stream) -> None:
        headers = self.decoder.decode(bytes(st.block))
        st.block = bytearray()
        if st.orphan:
            return
        ends = st.block_ends_stream
        if st.headers is None:
            st.headers = headers
        else:
            st.trailers = headers
        if ends:
            st.remote_ended = True
            self.on_end(st)

    def shutdown(self) -> None:
        with self.flow:
            if self.closed:
                return
            self.closed = True
            self.flow.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self.on_close()

    # hooks
    def stream_for_headers(self, sid: int) -> _Stream:
        raise NotImplementedError

    def on_end(self, st: _Stream) -> None:
        pass

    def on_reset(self, st: _Stream) -> None:
        pass

    def on_goaway(self) -> None:
        pass

    def on_close(self) -> None:
        pass


# ------------------------------------------------------------------- server
class ServicerContext:
    """What a handler gets beside its request bytes."""

    def __init__(self, metadata: tuple):
        self._metadata = metadata

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def abort(self, code: StatusCode, details: str):
        raise AbortError(code, details)


Handler = Callable[[bytes, ServicerContext], bytes]


class _ServerConnection(_Connection):
    def __init__(self, server: "Server", sock: socket.socket):
        super().__init__(sock)
        self.server = server
        self.active = 0  # handlers running or answering

    def stream_for_headers(self, sid: int) -> _Stream:
        st = self.streams.get(sid)
        if st is not None:
            return st  # trailers of a request (not sent by unary clients)
        if sid % 2 == 0:
            raise ProtocolError(f"bad client stream id {sid}")
        if sid <= self.max_seen:  # a stream already answered or reset
            return _Stream(sid, 0, orphan=True)
        self.max_seen = sid
        with self.flow:
            st = _Stream(sid, self.peer_initial_window)
            self.streams[sid] = st
        return st

    def on_end(self, st: _Stream) -> None:
        if self.server._stopping:
            self._forget(st)
            self.send_rst(st.id, REFUSED_STREAM)
            return
        with self.flow:
            self.active += 1
        try:
            self.server._pool.submit(self._serve, st)
        except RuntimeError:  # the pool has shut down
            with self.flow:
                self.active -= 1
            self._forget(st)
            self.send_rst(st.id, REFUSED_STREAM)

    def on_reset(self, st: _Stream) -> None:
        if st.remote_ended is False:
            self._forget(st)

    def on_close(self) -> None:
        self.server._connection_closed(self)

    def _forget(self, st: _Stream) -> None:
        with self.flow:
            self.streams.pop(st.id, None)

    def _serve(self, st: _Stream) -> None:
        try:
            try:
                payload = self._call(st)
                code, details = StatusCode.OK, ""
            except AbortError as e:
                payload, code, details = None, e.code, e.details
            if st.reset is not None or self.closed:
                return
            self._answer(st, payload, code, details)
        except (OSError, ConnectionError, TimeoutError):
            pass  # the connection or the stream went away
        finally:
            self._forget(st)
            with self.flow:
                self.active -= 1
                self.flow.notify_all()

    def _call(self, st: _Stream) -> bytes:
        headers = dict(st.headers or ())
        if st.refused is not None:
            raise st.refused
        if headers.get(":method") != "POST":
            raise AbortError(StatusCode.INTERNAL, "gRPC requires POST")
        ctype = headers.get("content-type", "")
        if not ctype.startswith("application/grpc"):
            raise AbortError(StatusCode.UNKNOWN,
                             f"bad content-type {ctype!r}")
        encoding = headers.get("grpc-encoding", "identity")
        if encoding not in ("identity", "gzip"):
            raise AbortError(StatusCode.UNIMPLEMENTED,
                             f"Compression algorithm {encoding!r} is not "
                             "supported")
        handler = self.server._methods.get(headers.get(":path", ""))
        if handler is None:
            raise AbortError(StatusCode.UNIMPLEMENTED, "Method not found!")
        request = parse_message(bytes(st.body), encoding)
        ctx = ServicerContext(_metadata_pairs(st.headers))
        try:
            response = handler(request, ctx)
        except AbortError:
            raise
        except Exception as e:  # grpcio's answer to a handler's exception
            raise AbortError(StatusCode.UNKNOWN,
                             f"Exception calling application: {e}")
        if not isinstance(response, (bytes, bytearray, memoryview)):
            raise AbortError(StatusCode.INTERNAL,
                             "handler returned no bytes")
        return bytes(response)

    def _answer(self, st: _Stream, payload: Optional[bytes],
                code: StatusCode, details: str) -> None:
        head = [(":status", "200"), ("content-type", "application/grpc")]
        trailers = [("grpc-status", str(int(code)))]
        if details:
            trailers.append(("grpc-message", percent_encode(details)))
        if payload is None:  # trailers-only
            self.send_headers(st.id, head + trailers, end_stream=True)
            return
        self.send_headers(st.id, head, end_stream=False)
        self.send_data(st, frame_message(payload), end_stream=False)
        self.send_headers(st.id, trailers, end_stream=True)


class Server:
    """A unary gRPC server over h2c. ``add_method(path, handler)`` before
    ``start``; the port is bound at construction (``port=0``: a free
    one; ``self.port`` is the bound port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 4):
        self.host = host
        self._methods: dict[str, Handler] = {}
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="grpcwire")
        family, stype, proto, _, addr = socket.getaddrinfo(
            host or None, port, type=socket.SOCK_STREAM,
            flags=socket.AI_PASSIVE)[0]
        self._listener = socket.socket(family, stype, proto)
        try:
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(addr)
            self._listener.listen(128)
        except OSError:
            self._listener.close()
            self._pool.shutdown(wait=False)
            raise
        self.port = self._listener.getsockname()[1]
        self._listener.settimeout(0.2)
        self._lock = threading.Lock()
        self._connections: set[_ServerConnection] = set()
        self._socks: set[socket.socket] = set()  # accepted, not yet closed
        self._threads: list[threading.Thread] = []
        self._stopping = False
        self._accept_thread: Optional[threading.Thread] = None

    def add_method(self, path: str, handler: Handler) -> None:
        """``path`` is ``/package.Service/Method``."""
        self._methods[path] = handler

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"grpcwire-accept-{self.port}",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            t = threading.Thread(target=self._serve_connection,
                                 args=(sock,),
                                 name="grpcwire-conn", daemon=True)
            with self._lock:
                if self._stopping:
                    sock.close()
                    break
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                self._socks.add(sock)
            t.start()

    def _serve_connection(self, sock: socket.socket) -> None:
        try:
            try:
                if read_exact(sock, len(PREFACE)) != PREFACE:
                    return
            except OSError:
                return
            conn = _ServerConnection(self, sock)
            with self._lock:
                if self._stopping:
                    return
                self._connections.add(conn)
            try:
                conn.send_settings({SETTINGS_ENABLE_PUSH: 0})
            except OSError:
                return
            conn.read_loop()
        finally:
            with self._lock:
                self._socks.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _connection_closed(self, conn: _ServerConnection) -> None:
        with self._lock:
            self._connections.discard(conn)

    def stop(self, grace: Optional[float] = None) -> None:
        """GOAWAY to every connection, then up to ``grace`` seconds for the
        calls in flight, then every socket closed and every thread joined,
        so that no thread of this server is left in a blocking call."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            conns = list(self._connections)
        if self._accept_thread is not None:
            self._accept_thread.join()
        self._listener.close()
        for conn in conns:
            conn.send_goaway(NO_ERROR)
        deadline = time.monotonic() + (grace or 0.0)
        for conn in conns:
            with conn.flow:
                while conn.active and not conn.closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    conn.flow.wait(left)
        for conn in conns:
            conn.shutdown()
        with self._lock:
            socks = list(self._socks)  # those still before their preface
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._pool.shutdown(wait=True, cancel_futures=True)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join()


# ------------------------------------------------------------------- client
class _ClientConnection(_Connection):
    def __init__(self, sock: socket.socket):
        super().__init__(sock)
        self.next_id = 1
        self.lock = threading.Lock()  # stream ids in order on the wire

    def stream_for_headers(self, sid: int) -> _Stream:
        st = self.streams.get(sid)
        if st is None:  # a call that timed out or was cancelled
            return _Stream(sid, 0, orphan=True)
        return st

    def on_end(self, st: _Stream) -> None:
        st.done.set()

    def on_reset(self, st: _Stream) -> None:
        st.done.set()

    def on_goaway(self) -> None:
        with self.flow:
            for sid, st in self.streams.items():
                if sid > (self.goaway_last or 0):
                    st.done.set()

    def on_close(self) -> None:
        with self.flow:
            for st in self.streams.values():
                st.done.set()


_HTTP_TO_CODE = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                 403: StatusCode.PERMISSION_DENIED,
                 404: StatusCode.UNIMPLEMENTED, 429: StatusCode.UNAVAILABLE,
                 502: StatusCode.UNAVAILABLE, 503: StatusCode.UNAVAILABLE,
                 504: StatusCode.UNAVAILABLE}


class Channel:
    """A client connection to ``host:port`` (opened at the first call,
    opened again after it fails); calls from many threads share it, each
    on a stream of its own."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = int(port)
        self._lock = threading.Lock()
        self._conn: Optional[_ClientConnection] = None
        self._reader: Optional[threading.Thread] = None
        self._closed = False

    def __enter__(self) -> "Channel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def unary_unary(self, method: str) -> Callable:
        """grpcio's spelling: the call sends the request's bytes and
        returns the response's."""

        def call(request: bytes, timeout: Optional[float] = None,
                 metadata: Optional[Iterable[tuple[str, object]]] = None
                 ) -> bytes:
            return self._call(method, bytes(request), timeout, metadata)

        return call

    def _connection(self) -> _ClientConnection:
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "channel closed")
            conn = self._conn
            if conn is not None and not conn.closed and \
                    conn.goaway_last is None:
                return conn
            try:
                sock = socket.create_connection((self.host, self.port))
            except OSError as e:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"failed to connect to {self.host}:"
                               f"{self.port}: {e}")
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _ClientConnection(sock)
            sock.sendall(PREFACE + encode_frame(
                SETTINGS, 0, 0, struct.pack(">HI", SETTINGS_ENABLE_PUSH, 0)))
            reader = threading.Thread(target=conn.read_loop,
                                      name="grpcwire-client", daemon=True)
            reader.start()
            old = self._conn, self._reader
            self._conn, self._reader = conn, reader
        if old[0] is not None:
            old[0].shutdown()
            old[1].join()
        return conn

    def _call(self, method: str, request: bytes, timeout: Optional[float],
              metadata) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        conn = self._connection()
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", method), (":authority", f"{self.host}:{self.port}"),
                   ("content-type", "application/grpc"), ("te", "trailers"),
                   ("user-agent", "nornicdb-grpcwire/1")]
        if timeout is not None:
            headers.append(("grpc-timeout",
                            f"{max(int(timeout * 1000), 1)}m"))
        for key, value in metadata or ():
            key = key.lower()
            if key.endswith("-bin"):
                value = base64.b64encode(bytes(value)).decode().rstrip("=")
            headers.append((key, str(value)))
        try:
            # an id is taken and its HEADERS sent under one hold of the
            # lock: ids must reach the wire in increasing order, or the
            # peer takes a lower one, sent later, for a closed stream
            with conn.lock:
                sid = conn.next_id
                conn.next_id += 2
                with conn.flow:
                    st = _Stream(sid, conn.peer_initial_window)
                    conn.streams[sid] = st
                conn.send_headers(sid, headers, end_stream=False)
            conn.send_data(st, frame_message(request), end_stream=True,
                           deadline=deadline)
        except TimeoutError:
            self._cancel(conn, sid)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        except (OSError, ConnectionError) as e:
            with conn.flow:
                conn.streams.pop(sid, None)
            raise RpcError(StatusCode.UNAVAILABLE, f"connection lost: {e}")
        left = None if deadline is None else max(deadline - time.monotonic(),
                                                 0.0)
        if not st.done.wait(left):
            self._cancel(conn, sid)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        with conn.flow:
            conn.streams.pop(sid, None)
        return self._result(st, conn)

    @staticmethod
    def _cancel(conn: _ClientConnection, sid: int) -> None:
        with conn.flow:
            conn.streams.pop(sid, None)
        conn.send_rst(sid, CANCEL)

    @staticmethod
    def _result(st: _Stream, conn: _ClientConnection) -> bytes:
        if st.headers is None:
            if st.reset is not None:
                raise RpcError(StatusCode.UNAVAILABLE if st.reset ==
                               REFUSED_STREAM else StatusCode.INTERNAL,
                               f"stream reset with code {st.reset}")
            raise RpcError(StatusCode.UNAVAILABLE, "connection lost")
        head = dict(st.headers)
        status = head.get(":status", "")
        if status != "200":
            code = _HTTP_TO_CODE.get(int(status) if status.isdigit() else 0,
                                     StatusCode.UNKNOWN)
            raise RpcError(code, f"HTTP status {status}")
        if not st.remote_ended:
            raise RpcError(StatusCode.UNAVAILABLE, "stream ended early")
        trailers = dict(st.trailers if st.trailers is not None
                        else st.headers)
        try:
            code = StatusCode(int(trailers.get("grpc-status", "2")))
        except ValueError:
            code = StatusCode.UNKNOWN
        details = percent_decode(trailers.get("grpc-message", ""))
        if st.refused is not None:
            raise RpcError(st.refused.code, st.refused.details)
        if code != StatusCode.OK:
            raise RpcError(code, details)
        try:
            return parse_message(bytes(st.body),
                                 head.get("grpc-encoding", "identity"))
        except AbortError as e:
            raise RpcError(e.code, e.details)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, reader = self._conn, self._reader
            self._conn = self._reader = None
        if conn is not None:
            conn.shutdown()
            reader.join()
