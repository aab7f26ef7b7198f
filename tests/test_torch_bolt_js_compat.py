"""JavaScript-driver PackStream compatibility: smallest-encoding integer
contract.

Behavioral reference: upstream NornicDB pkg/bolt/javascript_compat_test.go —
the neo4j JS driver decodes INT64-marked values (0xCB) as BigInt, which
cannot mix with Number arithmetic; every value that fits a smaller
encoding MUST use it (TestJavaScriptDriverCompatibility :25,
TestMimirUsedCountScenario :150, TestPackStreamEncodingRanges :176).
Test names trace to the reference cases.

The port's copy of ``tests/test_bolt_js_compat.py``: the JAX cases with only
their imports and the device argument (``device="cpu"``) changed.
"""

from __future__ import annotations

import pytest

from nornicdb_tpu_torch.server.packstream import pack, unpack


# (name, value, expected first byte, expected total length, JS type)
# — the exact table from TestJavaScriptDriverCompatibility
JS_COMPAT_CASES = [
    ("zero (tiny)", 0, 0x00, 1, "Number"),
    ("small positive (tiny)", 42, 42, 1, "Number"),
    ("small negative (tiny)", -1, 0xFF, 1, "Number"),
    ("usedCount=1 (typical Mimir value)", 1, 0x01, 1, "Number"),
    ("usedCount=100", 100, 100, 1, "Number"),
    ("INT8 boundary", -17, 0xC8, 2, "Number"),
    ("INT16 needed", 1000, 0xC9, 3, "Number"),
    ("INT32 needed", 100000, 0xCA, 5, "Number"),
    ("large INT32 (still Number in JS)", 2147483647, 0xCA, 5, "Number"),
    ("INT64 boundary (becomes BigInt)", 2147483648, 0xCB, 9, "BigInt"),
    ("large negative INT32 (still Number)", -2147483648, 0xCA, 5, "Number"),
    ("beyond INT32 (becomes BigInt)", -2147483649, 0xCB, 9, "BigInt"),
]


class TestJavaScriptDriverCompatibility:
    @pytest.mark.parametrize(
        "name,value,marker,length,js_type", JS_COMPAT_CASES,
        ids=[c[0] for c in JS_COMPAT_CASES],
    )
    def test_smallest_encoding(self, name, value, marker, length, js_type):
        encoded = pack(value)
        assert encoded[0] == marker, (
            f"marker mismatch for {value}: got 0x{encoded[0]:02X}, "
            f"want 0x{marker:02X}"
        )
        assert len(encoded) == length, (
            f"length mismatch for {value}: got {len(encoded)}, want {length}"
        )
        assert unpack(encoded) == value


class TestMimirUsedCountScenario:
    """usedCount (0-100) must use tiny encoding so the JS driver yields
    Number, not BigInt (ref: TestMimirUsedCountScenario :150)."""

    @pytest.mark.parametrize("count", [0, 1, 2, 5, 10, 50, 100])
    def test_used_count_is_tiny(self, count):
        encoded = pack(count)
        assert len(encoded) == 1, (
            f"usedCount={count} should use tiny encoding (1 byte)"
        )
        assert encoded[0] <= 0x7F
        assert unpack(encoded) == count


class TestPackStreamEncodingRanges:
    """Boundary table from TestPackStreamEncodingRanges :176."""

    RANGES = [
        # (name, min, max, bytes)
        ("Tiny Int", -16, 127, 1),
        ("INT8", -128, -17, 2),
        ("INT16", -32768, 32767, 3),
        ("INT32", -2147483648, 2147483647, 5),
        ("INT64", -(2**63), 2**63 - 1, 9),
    ]

    @pytest.mark.parametrize(
        "name,lo,hi,nbytes", RANGES, ids=[r[0] for r in RANGES],
    )
    def test_boundaries(self, name, lo, hi, nbytes):
        # min boundary always uses exactly this encoding's width
        assert len(pack(lo)) == nbytes
        assert unpack(pack(lo)) == lo
        # max boundary may legitimately fit a smaller class (tiny overlap)
        enc_hi = pack(hi)
        assert len(enc_hi) <= nbytes
        assert unpack(enc_hi) == hi

    def test_one_past_each_range_widens(self):
        # crossing a range boundary must move to the next encoding, never
        # truncate
        for boundary, wider_len in [
            (127, 3),            # 128 -> INT16 (no positive INT8 range)
            (32767, 5),          # 32768 -> INT32
            (2147483647, 9),     # 2^31 -> INT64
            (-16, 2),            # -17 -> INT8
            (-128, 3),           # -129 -> INT16
            (-32768, 5),         # -32769 -> INT32
            (-2147483648, 9),    # -2^31-1 -> INT64
        ]:
            past = boundary + (1 if boundary > 0 else -1)
            assert len(pack(past)) == wider_len, (past, len(pack(past)))
            assert unpack(pack(past)) == past

    def test_int64_out_of_range_rejected(self):
        with pytest.raises(Exception):
            pack(2**63)
