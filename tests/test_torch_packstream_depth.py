"""PackStream v2 wire-format depth (ref: pkg/bolt/packstream_bytes_test.go,
packstream_into_test.go, packstream_fallback_test.go, packstream_hash_test.go
— the reference pins every size-class boundary and the storage Node/Edge
structure layout; a stock neo4j driver depends on exact markers).

Marker constants asserted here are from the PackStream spec the reference
implements: TINY_INT -16..127, INT_8/16/32/64 (C8/C9/CA/CB), TINY_STRING
<=15 (80+n) then D0/D1/D2, TINY_LIST (90+n) then D4/D5/D6, TINY_MAP (A0+n)
then D8/D9/DA, BYTES CC/CD/CE, FLOAT C1, NULL C0, BOOL C2/C3, STRUCT B<n>.

The port's copy of ``tests/test_packstream_depth.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
"""

import math
import struct

import pytest

from nornicdb_tpu_torch.server.packstream import (
    STRUCT_NODE,
    STRUCT_REL,
    Structure,
    edge_struct,
    node_struct,
    pack,
    unpack,
)
from nornicdb_tpu_torch.storage.types import Edge, Node


def _roundtrip(v):
    out = unpack(pack(v))
    assert out == v, (v, out)
    return pack(v)


class TestIntBoundaries:
    """ref: TestEncodePackStreamIntInto_MatchesExisting — every size-class
    boundary encodes with the spec marker and round-trips."""

    @pytest.mark.parametrize("v,marker_len", [
        (0, 1), (127, 1), (-16, 1),            # TINY_INT: one byte
        (-17, 2), (-128, 2),                   # INT_8
        (128, 3), (32767, 3), (-32768, 3),     # INT_16
        (32768, 5), (2**31 - 1, 5), (-2**31, 5),   # INT_32
        (2**31, 9), (2**63 - 1, 9), (-2**63, 9),   # INT_64
    ])
    def test_boundary_encoding_length(self, v, marker_len):
        assert len(_roundtrip(v)) == marker_len

    def test_markers_exact(self):
        assert pack(1) == b"\x01"
        assert pack(-1) == b"\xff"          # tiny negative
        assert pack(-17) == b"\xc8\xef"     # INT_8
        assert pack(128) == b"\xc9\x00\x80"  # INT_16
        assert pack(2**31) == b"\xcb" + struct.pack(">q", 2**31)


class TestScalars:
    def test_null_bool_markers(self):
        assert pack(None) == b"\xc0"
        assert pack(True) == b"\xc3"
        assert pack(False) == b"\xc2"
        for v in (None, True, False):
            _roundtrip(v)

    def test_float_marker_and_precision(self):
        raw = pack(1.5)
        assert raw[0] == 0xC1
        assert unpack(raw) == 1.5
        assert unpack(pack(math.pi)) == math.pi
        # a whole float stays float, never collapses to int encoding
        assert isinstance(unpack(pack(2.0)), float)

    def test_nan_and_inf_roundtrip_bits(self):
        assert math.isinf(unpack(pack(math.inf)))
        assert math.isnan(unpack(pack(math.nan)))


class TestStringSizeClasses:
    @pytest.mark.parametrize("n,marker", [
        (0, 0x80), (15, 0x8F),   # tiny
        (16, 0xD0), (255, 0xD0),  # STRING_8
        (256, 0xD1), (65535, 0xD1),  # STRING_16
        (65536, 0xD2),  # STRING_32
    ])
    def test_boundaries(self, n, marker):
        raw = _roundtrip("x" * n)
        assert raw[0] == marker

    def test_utf8_multibyte(self):
        s = "norrøn mytologi — 北欧神話 🪓"
        assert unpack(pack(s)) == s
        # length prefix counts BYTES not codepoints
        raw = pack("ø")
        assert raw[0] == 0x80 + 2


class TestContainerSizeClasses:
    @pytest.mark.parametrize("n,marker", [
        (0, 0x90), (15, 0x9F), (16, 0xD4), (256, 0xD5),
    ])
    def test_list_boundaries(self, n, marker):
        raw = _roundtrip(list(range(n)))
        assert raw[0] == marker

    @pytest.mark.parametrize("n,marker", [
        (0, 0xA0), (15, 0xAF), (16, 0xD8), (256, 0xD9),
    ])
    def test_map_boundaries(self, n, marker):
        raw = _roundtrip({f"k{i:04d}": i for i in range(n)})
        assert raw[0] == marker

    def test_bytes_size_classes(self):
        """ref: TestEncodeDecodePackStreamBytes_RoundTrip"""
        for n, marker in ((0, 0xCC), (255, 0xCC), (256, 0xCD),
                          (65536, 0xCE)):
            raw = pack(bytes(range(256)) * (n // 256) + bytes(range(n % 256)))
            assert raw[0] == marker
            assert unpack(raw) == bytes(range(256)) * (n // 256) + \
                bytes(range(n % 256))

    def test_deep_nesting(self):
        v = {"rows": [[1, {"inner": ["a", None, {"deep": [True, 2.5]}]}]]}
        _roundtrip(v)


class TestStructures:
    def test_node_structure_wire_layout(self):
        """ref: TestEncodePackStreamValueInto_StorageNodeStructure — Node
        packs as B4 0x4E with element id fields the JS driver reads."""
        n = Node(id="node-42", labels=["Person"],
                 properties={"name": "Freya"})
        s = node_struct(n)
        assert s.tag == STRUCT_NODE
        raw = pack(s)
        assert raw[0] == 0xB0 + len(s.fields)
        assert raw[1] == STRUCT_NODE
        out = unpack(raw)
        assert out.tag == STRUCT_NODE
        assert out.fields[1] == ["Person"]
        assert out.fields[2] == {"name": "Freya"}
        assert out.fields[3] == "node-42"  # element_id field

    def test_edge_structure_wire_layout(self):
        """ref: TestEncodePackStreamValueInto_StorageEdgeStructure"""
        e = Edge(id="e-7", start_node="a", end_node="b", type="KNOWS",
                 properties={"since": 2020})
        s = edge_struct(e)
        assert s.tag == STRUCT_REL
        out = unpack(pack(s))
        assert out.fields[3] == "KNOWS"
        assert out.fields[4] == {"since": 2020}

    def test_unknown_struct_roundtrips_generically(self):
        s = Structure(0x7A, ["field", 1])
        out = unpack(pack(s))
        assert out.tag == 0x7A
        assert out.fields == ["field", 1]


class TestMalformedInput:
    """A truncated or lying buffer must raise, not hang or return junk."""

    @pytest.mark.parametrize("raw", [
        b"\xd0",            # STRING_8 missing length byte
        b"\xd0\x05ab",      # string shorter than declared
        b"\xc9\x00",        # INT_16 with one byte
        b"\x92\x01",        # list declares 2 items, has 1
        b"\xc1\x00\x00",    # float with 2 of 8 bytes
    ])
    def test_truncated_raises(self, raw):
        with pytest.raises(Exception):
            unpack(raw)
