"""PackStream v2 codec (the Bolt wire serialization).

Behavioral reference: upstream NornicDB pkg/bolt/packstream.go (1,304 LoC
complete codec). Implements the marker scheme: tiny/8/16/32 ints, float64,
strings, lists, maps, booleans, null, bytes, and structures — including the
graph structs Node (0x4E), Relationship (0x52), UnboundRelationship (0x72)
and Path (0x50) used in RECORD messages.

The port's copy of ``nornicdb_tpu/server/packstream.py``: both packages
pack the same bytes and unpack the same values.
"""

from __future__ import annotations

import struct
from typing import Any

from nornicdb_tpu_torch.storage.types import Edge, Node

# structure tags
STRUCT_NODE = 0x4E
STRUCT_REL = 0x52
STRUCT_UNBOUND_REL = 0x72
STRUCT_PATH = 0x50


class Structure:
    def __init__(self, tag: int, fields: list[Any]):
        self.tag = tag
        self.fields = fields

    def __repr__(self) -> str:
        return f"Structure(0x{self.tag:02X}, {self.fields!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Structure)
            and self.tag == other.tag
            and self.fields == other.fields
        )


class Packer:
    def __init__(self) -> None:
        self.buf = bytearray()

    def pack(self, value: Any) -> "Packer":
        b = self.buf
        if value is None:
            b.append(0xC0)
        elif value is True:
            b.append(0xC3)
        elif value is False:
            b.append(0xC2)
        elif isinstance(value, int):
            self._pack_int(value)
        elif isinstance(value, float):
            b.append(0xC1)
            b += struct.pack(">d", value)
        elif isinstance(value, str):
            data = value.encode("utf-8")
            self._pack_header(len(data), 0x80, 0xD0)
            b += data
        elif isinstance(value, (bytes, bytearray)):
            n = len(value)
            if n < 0x100:
                b += bytes([0xCC, n])
            elif n < 0x10000:
                b.append(0xCD)
                b += struct.pack(">H", n)
            else:
                b.append(0xCE)
                b += struct.pack(">I", n)
            b += value
        elif isinstance(value, (list, tuple)):
            self._pack_header(len(value), 0x90, 0xD4)
            for item in value:
                self.pack(item)
        elif isinstance(value, dict):
            self._pack_header(len(value), 0xA0, 0xD8)
            for k, v in value.items():
                self.pack(str(k))
                self.pack(v)
        elif isinstance(value, Structure):
            n = len(value.fields)
            if n < 0x10:
                b.append(0xB0 + n)
            else:
                raise ValueError("structure too large")
            b.append(value.tag)
            for f in value.fields:
                self.pack(f)
        elif isinstance(value, Node):
            self.pack(node_struct(value))
        elif isinstance(value, Edge):
            self.pack(edge_struct(value))
        else:
            # numpy scalars / arrays and other iterables
            try:
                import numpy as np

                if isinstance(value, np.integer):
                    return self.pack(int(value))
                if isinstance(value, np.floating):
                    return self.pack(float(value))
                if isinstance(value, np.ndarray):
                    return self.pack(value.tolist())
            except ImportError:
                pass
            raise ValueError(f"cannot pack {type(value).__name__}")
        return self

    def _pack_int(self, v: int) -> None:
        b = self.buf
        if -0x10 <= v < 0x80:
            b.append(v & 0xFF)
        elif -0x80 <= v < 0x80:
            b.append(0xC8)
            b += struct.pack(">b", v)
        elif -0x8000 <= v < 0x8000:
            b.append(0xC9)
            b += struct.pack(">h", v)
        elif -0x80000000 <= v < 0x80000000:
            b.append(0xCA)
            b += struct.pack(">i", v)
        else:
            b.append(0xCB)
            b += struct.pack(">q", v)

    def _pack_header(self, n: int, tiny_marker: int, sized_marker: int) -> None:
        b = self.buf
        if n < 0x10:
            b.append(tiny_marker + n)
        elif n < 0x100:
            b += bytes([sized_marker, n])
        elif n < 0x10000:
            b.append(sized_marker + 1)
            b += struct.pack(">H", n)
        else:
            b.append(sized_marker + 2)
            b += struct.pack(">I", n)

    def bytes(self) -> bytes:
        return bytes(self.buf)


def pack(value: Any) -> bytes:
    return Packer().pack(value).bytes()


class Unpacker:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("packstream: truncated input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self) -> Any:
        marker = self._take(1)[0]
        if marker < 0x80:  # tiny positive int
            return marker
        if marker >= 0xF0:  # tiny negative int
            return marker - 0x100
        if 0x80 <= marker < 0x90:  # tiny string
            return self._take(marker & 0x0F).decode("utf-8")
        if 0x90 <= marker < 0xA0:  # tiny list
            return [self.unpack() for _ in range(marker & 0x0F)]
        if 0xA0 <= marker < 0xB0:  # tiny map
            return {self.unpack(): self.unpack() for _ in range(marker & 0x0F)}
        if 0xB0 <= marker < 0xC0:  # structure
            n = marker & 0x0F
            tag = self._take(1)[0]
            return Structure(tag, [self.unpack() for _ in range(n)])
        if marker == 0xC0:
            return None
        if marker == 0xC1:
            return struct.unpack(">d", self._take(8))[0]
        if marker == 0xC2:
            return False
        if marker == 0xC3:
            return True
        if marker == 0xC8:
            return struct.unpack(">b", self._take(1))[0]
        if marker == 0xC9:
            return struct.unpack(">h", self._take(2))[0]
        if marker == 0xCA:
            return struct.unpack(">i", self._take(4))[0]
        if marker == 0xCB:
            return struct.unpack(">q", self._take(8))[0]
        if marker == 0xCC:
            return bytes(self._take(self._take(1)[0]))
        if marker == 0xCD:
            return bytes(self._take(struct.unpack(">H", self._take(2))[0]))
        if marker == 0xCE:
            return bytes(self._take(struct.unpack(">I", self._take(4))[0]))
        if marker == 0xD0:
            return self._take(self._take(1)[0]).decode("utf-8")
        if marker == 0xD1:
            return self._take(struct.unpack(">H", self._take(2))[0]).decode("utf-8")
        if marker == 0xD2:
            return self._take(struct.unpack(">I", self._take(4))[0]).decode("utf-8")
        if marker == 0xD4:
            return [self.unpack() for _ in range(self._take(1)[0])]
        if marker == 0xD5:
            return [
                self.unpack()
                for _ in range(struct.unpack(">H", self._take(2))[0])
            ]
        if marker == 0xD6:
            return [
                self.unpack()
                for _ in range(struct.unpack(">I", self._take(4))[0])
            ]
        if marker == 0xD8:
            return {self.unpack(): self.unpack() for _ in range(self._take(1)[0])}
        if marker == 0xD9:
            return {
                self.unpack(): self.unpack()
                for _ in range(struct.unpack(">H", self._take(2))[0])
            }
        if marker == 0xDA:
            return {
                self.unpack(): self.unpack()
                for _ in range(struct.unpack(">I", self._take(4))[0])
            }
        raise ValueError(f"packstream: unknown marker 0x{marker:02X}")


def unpack(data: bytes) -> Any:
    return Unpacker(data).unpack()


# ---------------------------------------------------------------- graph types
def _element_int_id(id_: str) -> int:
    """Bolt's legacy numeric id field: stable hash of the string id."""
    import zlib

    return zlib.crc32(id_.encode()) & 0x7FFFFFFF


def node_struct(n: Node) -> Structure:
    props = dict(n.properties)
    return Structure(
        STRUCT_NODE,
        [_element_int_id(n.id), list(n.labels), props, n.id],  # + element_id (5.x)
    )


def edge_struct(e: Edge) -> Structure:
    return Structure(
        STRUCT_REL,
        [
            _element_int_id(e.id),
            _element_int_id(e.start_node),
            _element_int_id(e.end_node),
            e.type,
            dict(e.properties),
            e.id,
            e.start_node,
            e.end_node,
        ],
    )


def path_struct(p: dict) -> Structure:
    nodes = [node_struct(n) for n in p.get("nodes", [])]
    rels = [
        Structure(
            STRUCT_UNBOUND_REL,
            [_element_int_id(e.id), e.type, dict(e.properties), e.id],
        )
        for e in p.get("relationships", [])
    ]
    # index sequence: [rel_idx, node_idx, ...] 1-based alternating
    seq: list[int] = []
    for i in range(len(rels)):
        seq.append(i + 1)
        seq.append(i + 1)
    return Structure(STRUCT_PATH, [nodes, rels, seq])


def to_wire(value: Any) -> Any:
    """Convert executor result values into packable form."""
    if isinstance(value, Node):
        return node_struct(value)
    if isinstance(value, Edge):
        return edge_struct(value)
    if isinstance(value, dict):
        if value.get("__path__"):
            return path_struct(value)
        return {k: to_wire(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_wire(v) for v in value]
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return value.tolist()
        if isinstance(value, np.integer):
            return int(value)
        if isinstance(value, np.floating):
            return float(value)
    except ImportError:
        pass
    return value
