"""APOC extended pure-function categories.

Behavioral reference: upstream NornicDB apoc/{bitwise,json,diff,stats,
spatial,scoring,xml}/ — each is a Go package of pure helpers
(bitwise/bitwise.go, json/json.go, diff/diff.go, stats/stats.go,
spatial/spatial.go, scoring/scoring.go, xml/xml.go). Reimplemented from
observed behavior; signatures follow the APOC dotted-name convention and
null-in/null-out semantics used throughout functions.py.

The port's copy of ``nornicdb_tpu/apoc/functions_ext.py``.
"""

from __future__ import annotations

import json as _json
import math as _math
import re
import statistics
import xml.etree.ElementTree as _ET
from typing import Any, Optional

from nornicdb_tpu_torch.apoc.registry import register

# ---------------------------------------------------------------------------
# apoc.bitwise.* (ref: apoc/bitwise/bitwise.go — Op/And/Or/Xor/shifts/bits)
# ---------------------------------------------------------------------------


@register("apoc.bitwise.op")
def bitwise_op(a, op, b):
    if a is None or b is None:
        return None
    a, b = int(a), int(b)
    op = str(op).upper()
    if op in ("&", "AND"):
        return a & b
    if op in ("|", "OR"):
        return a | b
    if op in ("^", "XOR"):
        return a ^ b
    if op in ("<<", "LEFT_SHIFT", "LEFT SHIFT"):
        return a << b
    if op in (">>", "RIGHT_SHIFT", "RIGHT SHIFT"):
        return a >> b
    if op in ("~", "NOT"):
        return ~a
    return 0


@register("apoc.bitwise.and")
def bitwise_and(*values):
    vals = values[0] if len(values) == 1 and isinstance(values[0], list) else values
    if not vals:
        return 0
    out = int(vals[0])
    for v in vals[1:]:
        out &= int(v)
    return out


@register("apoc.bitwise.or")
def bitwise_or(*values):
    vals = values[0] if len(values) == 1 and isinstance(values[0], list) else values
    out = 0
    for v in vals:
        out |= int(v)
    return out


@register("apoc.bitwise.xor")
def bitwise_xor(*values):
    vals = values[0] if len(values) == 1 and isinstance(values[0], list) else values
    out = 0
    for v in vals:
        out ^= int(v)
    return out


@register("apoc.bitwise.not")
def bitwise_not(a):
    return None if a is None else ~int(a)


@register("apoc.bitwise.leftShift")
def bitwise_lshift(a, n):
    return None if a is None else int(a) << int(n)


@register("apoc.bitwise.rightShift")
def bitwise_rshift(a, n):
    return None if a is None else int(a) >> int(n)


@register("apoc.bitwise.setBit")
def bitwise_set_bit(a, pos):
    return None if a is None else int(a) | (1 << int(pos))


@register("apoc.bitwise.clearBit")
def bitwise_clear_bit(a, pos):
    return None if a is None else int(a) & ~(1 << int(pos))


@register("apoc.bitwise.toggleBit")
def bitwise_toggle_bit(a, pos):
    return None if a is None else int(a) ^ (1 << int(pos))


@register("apoc.bitwise.testBit")
def bitwise_test_bit(a, pos):
    return None if a is None else bool(int(a) & (1 << int(pos)))


@register("apoc.bitwise.countBits")
def bitwise_count_bits(a):
    if a is None:
        return None
    v = int(a)
    return bin(v & 0xFFFFFFFFFFFFFFFF).count("1") if v < 0 else bin(v).count("1")


# ---------------------------------------------------------------------------
# apoc.json.* (ref: apoc/json/json.go — Path/Validate/Parse/Stringify/…)
# ---------------------------------------------------------------------------


def _json_path(obj: Any, path: str) -> Any:
    """Dotted/bracket path: `a.b[0].c` (ref json.go Path). `$.` prefix ok."""
    if path.startswith("$"):
        path = path[1:].lstrip(".")
    cur = obj
    for part in re.findall(r"[^.\[\]]+|\[\d+\]", path):
        if cur is None:
            return None
        if part.startswith("["):
            idx = int(part[1:-1])
            if not isinstance(cur, list) or idx >= len(cur):
                return None
            cur = cur[idx]
        else:
            if isinstance(cur, dict):
                cur = cur.get(part)
            elif isinstance(cur, list) and part.isdigit():
                i = int(part)
                cur = cur[i] if i < len(cur) else None
            else:
                return None
    return cur


@register("apoc.json.path")
def json_path(value, path):
    if value is None:
        return None
    obj = _json.loads(value) if isinstance(value, str) else value
    return _json_path(obj, str(path or ""))


@register("apoc.json.validate")
def json_validate(s):
    if s is None:
        return False
    try:
        _json.loads(s)
        return True
    except (ValueError, TypeError):
        return False


@register("apoc.json.parse")
def json_parse(s):
    return None if s is None else _json.loads(s)


@register("apoc.json.stringify")
def json_stringify(v):
    return _json.dumps(v, default=str)


@register("apoc.json.pretty")
def json_pretty(v):
    obj = _json.loads(v) if isinstance(v, str) else v
    return _json.dumps(obj, indent=2, default=str)


@register("apoc.json.compact")
def json_compact(v):
    obj = _json.loads(v) if isinstance(v, str) else v
    return _json.dumps(obj, separators=(",", ":"), default=str)


@register("apoc.json.keys")
def json_keys(v):
    obj = _json.loads(v) if isinstance(v, str) else v
    return sorted(obj.keys()) if isinstance(obj, dict) else []


@register("apoc.json.size")
def json_size(v):
    obj = _json.loads(v) if isinstance(v, str) else v
    if isinstance(obj, (dict, list, str)):
        return len(obj)
    return 0


@register("apoc.json.merge")
def json_merge(a, b):
    da = _json.loads(a) if isinstance(a, str) else dict(a or {})
    db = _json.loads(b) if isinstance(b, str) else dict(b or {})
    return {**da, **db}


@register("apoc.json.flatten")
def json_flatten(v, delimiter="."):
    """{"a": {"b": 1}} -> {"a.b": 1} (ref json.go Flatten)."""
    obj = _json.loads(v) if isinstance(v, str) else v
    out: dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict) and node:
            for k, val in node.items():
                walk(f"{prefix}{delimiter}{k}" if prefix else str(k), val)
        elif isinstance(node, list) and node:
            for i, val in enumerate(node):
                walk(f"{prefix}[{i}]", val)
        else:
            out[prefix] = node

    walk("", obj)
    return out


@register("apoc.json.set")
def json_set(v, path, value):
    obj = _json.loads(v) if isinstance(v, str) else dict(v or {})
    parts = str(path).split(".")
    cur = obj
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value
    return obj


@register("apoc.json.delete")
def json_delete(v, path):
    obj = _json.loads(v) if isinstance(v, str) else dict(v or {})
    parts = str(path).split(".")
    cur = obj
    for p in parts[:-1]:
        cur = cur.get(p) if isinstance(cur, dict) else None
        if cur is None:
            return obj
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)
    return obj


# ---------------------------------------------------------------------------
# apoc.diff.* (ref: apoc/diff/diff.go — Nodes/Maps/Lists/Strings)
# ---------------------------------------------------------------------------


def _props_of(x) -> dict:
    return dict(getattr(x, "properties", x) or {})


@register("apoc.diff.nodes")
def diff_nodes(a, b):
    """{leftOnly, rightOnly, inCommon, different} (ref diff.go Nodes)."""
    return diff_maps(_props_of(a), _props_of(b))


@register("apoc.diff.relationships")
def diff_relationships(a, b):
    return diff_maps(_props_of(a), _props_of(b))


@register("apoc.diff.maps")
def diff_maps(a, b):
    a, b = dict(a or {}), dict(b or {})
    left_only = {k: v for k, v in a.items() if k not in b}
    right_only = {k: v for k, v in b.items() if k not in a}
    in_common = {k: v for k, v in a.items() if k in b and b[k] == v}
    different = {
        k: {"left": a[k], "right": b[k]}
        for k in a
        if k in b and b[k] != a[k]
    }
    return {
        "leftOnly": left_only,
        "rightOnly": right_only,
        "inCommon": in_common,
        "different": different,
    }


@register("apoc.diff.lists")
def diff_lists(a, b):
    a, b = list(a or []), list(b or [])
    return {
        "leftOnly": [x for x in a if x not in b],
        "rightOnly": [x for x in b if x not in a],
        "inCommon": [x for x in a if x in b],
    }


@register("apoc.diff.strings")
def diff_strings(a, b):
    if a is None or b is None:
        return None
    a, b = str(a), str(b)
    prefix = 0
    while prefix < min(len(a), len(b)) and a[prefix] == b[prefix]:
        prefix += 1
    suffix = 0
    while (
        suffix < min(len(a), len(b)) - prefix
        and a[len(a) - 1 - suffix] == b[len(b) - 1 - suffix]
    ):
        suffix += 1
    return {
        "equal": a == b,
        "commonPrefix": a[:prefix],
        "commonSuffix": a[len(a) - suffix :] if suffix else "",
        "leftDelta": a[prefix : len(a) - suffix],
        "rightDelta": b[prefix : len(b) - suffix],
    }


# ---------------------------------------------------------------------------
# apoc.stats.* (ref: apoc/stats/stats.go — Mean/Median/StdDev/…/Histogram)
# ---------------------------------------------------------------------------


def _nums(xs) -> list[float]:
    return [float(x) for x in (xs or []) if x is not None]


@register("apoc.stats.mean")
def stats_mean(xs):
    v = _nums(xs)
    return statistics.fmean(v) if v else None


@register("apoc.stats.median")
def stats_median(xs):
    v = _nums(xs)
    return statistics.median(v) if v else None


@register("apoc.stats.mode")
def stats_mode(xs):
    v = _nums(xs)
    return statistics.mode(v) if v else None


@register("apoc.stats.stdev")
def stats_stdev(xs, population=False):
    v = _nums(xs)
    if len(v) < 2:
        return 0.0 if v else None
    return statistics.pstdev(v) if population else statistics.stdev(v)


@register("apoc.stats.variance")
def stats_variance(xs, population=False):
    v = _nums(xs)
    if len(v) < 2:
        return 0.0 if v else None
    return statistics.pvariance(v) if population else statistics.variance(v)


@register("apoc.stats.percentile")
def stats_percentile(xs, p):
    """Linear-interpolation percentile, p in [0,1] or [0,100]."""
    v = sorted(_nums(xs))
    if not v:
        return None
    p = float(p)
    if p > 1.0:
        p /= 100.0
    idx = p * (len(v) - 1)
    lo, hi = int(_math.floor(idx)), int(_math.ceil(idx))
    if lo == hi:
        return v[lo]
    return v[lo] + (v[hi] - v[lo]) * (idx - lo)


@register("apoc.stats.quartiles")
def stats_quartiles(xs):
    v = _nums(xs)
    if not v:
        return None
    return {
        "q1": stats_percentile(v, 0.25),
        "q2": stats_percentile(v, 0.5),
        "q3": stats_percentile(v, 0.75),
    }


@register("apoc.stats.iqr")
def stats_iqr(xs):
    q = stats_quartiles(xs)
    return None if q is None else q["q3"] - q["q1"]


@register("apoc.stats.zscore")
def stats_zscore(xs):
    v = _nums(xs)
    if len(v) < 2:
        return [0.0] * len(v)
    mu, sd = statistics.fmean(v), statistics.pstdev(v)
    if sd == 0:
        return [0.0] * len(v)
    return [(x - mu) / sd for x in v]


@register("apoc.stats.normalize")
def stats_normalize(xs):
    """Min-max normalize into [0,1]."""
    v = _nums(xs)
    if not v:
        return []
    lo, hi = min(v), max(v)
    if hi == lo:
        return [0.0] * len(v)
    return [(x - lo) / (hi - lo) for x in v]


@register("apoc.stats.skewness")
def stats_skewness(xs):
    v = _nums(xs)
    if len(v) < 3:
        return None
    mu, sd = statistics.fmean(v), statistics.pstdev(v)
    if sd == 0:
        return 0.0
    return sum(((x - mu) / sd) ** 3 for x in v) / len(v)


@register("apoc.stats.kurtosis")
def stats_kurtosis(xs):
    """Excess kurtosis (normal -> 0)."""
    v = _nums(xs)
    if len(v) < 4:
        return None
    mu, sd = statistics.fmean(v), statistics.pstdev(v)
    if sd == 0:
        return 0.0
    return sum(((x - mu) / sd) ** 4 for x in v) / len(v) - 3.0


@register("apoc.stats.correlation")
def stats_correlation(xs, ys):
    a, b = _nums(xs), _nums(ys)
    if len(a) != len(b) or len(a) < 2:
        return None
    try:
        return statistics.correlation(a, b)
    except statistics.StatisticsError:
        return None


@register("apoc.stats.covariance")
def stats_covariance(xs, ys):
    a, b = _nums(xs), _nums(ys)
    if len(a) != len(b) or len(a) < 2:
        return None
    return statistics.covariance(a, b)


@register("apoc.stats.histogram")
def stats_histogram(xs, bins=10):
    v = _nums(xs)
    if not v:
        return []
    lo, hi = min(v), max(v)
    bins = max(1, int(bins))
    width = (hi - lo) / bins or 1.0
    counts = [0] * bins
    for x in v:
        idx = min(int((x - lo) / width), bins - 1)
        counts[idx] += 1
    return [
        {"min": lo + i * width, "max": lo + (i + 1) * width, "count": c}
        for i, c in enumerate(counts)
    ]


@register("apoc.stats.outliers")
def stats_outliers(xs):
    """IQR-fence outliers (ref stats.go Outliers)."""
    v = _nums(xs)
    q = stats_quartiles(v)
    if q is None:
        return []
    iqr = q["q3"] - q["q1"]
    lo, hi = q["q1"] - 1.5 * iqr, q["q3"] + 1.5 * iqr
    return [x for x in v if x < lo or x > hi]


@register("apoc.stats.summary")
def stats_summary(xs):
    v = _nums(xs)
    if not v:
        return None
    return {
        "count": len(v),
        "min": min(v),
        "max": max(v),
        "sum": sum(v),
        "mean": statistics.fmean(v),
        "median": statistics.median(v),
        "stdev": statistics.pstdev(v) if len(v) > 1 else 0.0,
    }


# ---------------------------------------------------------------------------
# apoc.spatial.* (ref: apoc/spatial/spatial.go — haversine/bearing/geohash)
# ---------------------------------------------------------------------------

_EARTH_R_M = 6371008.8  # mean earth radius, meters


def _latlon(p) -> tuple[float, float]:
    if isinstance(p, dict):
        return float(p.get("latitude", p.get("lat", 0.0))), float(
            p.get("longitude", p.get("lon", p.get("lng", 0.0)))
        )
    lat, lon = p
    return float(lat), float(lon)


@register("apoc.spatial.distance")
def spatial_distance(p1, p2):
    """Haversine great-circle distance in meters."""
    if p1 is None or p2 is None:
        return None
    lat1, lon1 = _latlon(p1)
    lat2, lon2 = _latlon(p2)
    phi1, phi2 = _math.radians(lat1), _math.radians(lat2)
    dphi = _math.radians(lat2 - lat1)
    dlam = _math.radians(lon2 - lon1)
    a = (
        _math.sin(dphi / 2) ** 2
        + _math.cos(phi1) * _math.cos(phi2) * _math.sin(dlam / 2) ** 2
    )
    return 2 * _EARTH_R_M * _math.asin(_math.sqrt(a))


@register("apoc.spatial.bearing")
def spatial_bearing(p1, p2):
    """Initial bearing in degrees [0, 360)."""
    if p1 is None or p2 is None:
        return None
    lat1, lon1 = _latlon(p1)
    lat2, lon2 = _latlon(p2)
    phi1, phi2 = _math.radians(lat1), _math.radians(lat2)
    dlam = _math.radians(lon2 - lon1)
    y = _math.sin(dlam) * _math.cos(phi2)
    x = _math.cos(phi1) * _math.sin(phi2) - _math.sin(phi1) * _math.cos(
        phi2
    ) * _math.cos(dlam)
    return (_math.degrees(_math.atan2(y, x)) + 360.0) % 360.0


@register("apoc.spatial.destination")
def spatial_destination(p, distance_m, bearing_deg):
    if p is None:
        return None
    lat, lon = _latlon(p)
    phi1, lam1 = _math.radians(lat), _math.radians(lon)
    delta = float(distance_m) / _EARTH_R_M
    theta = _math.radians(float(bearing_deg))
    phi2 = _math.asin(
        _math.sin(phi1) * _math.cos(delta)
        + _math.cos(phi1) * _math.sin(delta) * _math.cos(theta)
    )
    lam2 = lam1 + _math.atan2(
        _math.sin(theta) * _math.sin(delta) * _math.cos(phi1),
        _math.cos(delta) - _math.sin(phi1) * _math.sin(phi2),
    )
    return {
        "latitude": _math.degrees(phi2),
        "longitude": (_math.degrees(lam2) + 540.0) % 360.0 - 180.0,
    }


@register("apoc.spatial.midpoint")
def spatial_midpoint(p1, p2):
    if p1 is None or p2 is None:
        return None
    d = spatial_distance(p1, p2)
    b = spatial_bearing(p1, p2)
    return spatial_destination(p1, d / 2.0, b)


@register("apoc.spatial.boundingBox")
def spatial_bbox(points):
    pts = [_latlon(p) for p in (points or []) if p is not None]
    if not pts:
        return None
    lats = [p[0] for p in pts]
    lons = [p[1] for p in pts]
    return {
        "minLatitude": min(lats),
        "maxLatitude": max(lats),
        "minLongitude": min(lons),
        "maxLongitude": max(lons),
    }


@register("apoc.spatial.within")
def spatial_within(p, bbox):
    if p is None or bbox is None:
        return None
    lat, lon = _latlon(p)
    return (
        bbox["minLatitude"] <= lat <= bbox["maxLatitude"]
        and bbox["minLongitude"] <= lon <= bbox["maxLongitude"]
    )


@register("apoc.spatial.withinDistance")
def spatial_within_distance(p1, p2, max_m):
    d = spatial_distance(p1, p2)
    return None if d is None else d <= float(max_m)


@register("apoc.spatial.centroid")
def spatial_centroid(points):
    pts = [_latlon(p) for p in (points or []) if p is not None]
    if not pts:
        return None
    return {
        "latitude": sum(p[0] for p in pts) / len(pts),
        "longitude": sum(p[1] for p in pts) / len(pts),
    }


_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


@register("apoc.spatial.encodeGeohash")
def spatial_encode_geohash(p, precision=9):
    if p is None:
        return None
    lat, lon = _latlon(p)
    lat_rng, lon_rng = [-90.0, 90.0], [-180.0, 180.0]
    out, bits, ch, even = [], 0, 0, True
    while len(out) < int(precision):
        rng, v = (lon_rng, lon) if even else (lat_rng, lat)
        mid = (rng[0] + rng[1]) / 2
        ch <<= 1
        if v >= mid:
            ch |= 1
            rng[0] = mid
        else:
            rng[1] = mid
        even = not even
        bits += 1
        if bits == 5:
            out.append(_GEOHASH32[ch])
            bits, ch = 0, 0
    return "".join(out)


@register("apoc.spatial.decodeGeohash")
def spatial_decode_geohash(gh):
    if not gh:
        return None
    lat_rng, lon_rng = [-90.0, 90.0], [-180.0, 180.0]
    even = True
    for c in str(gh).lower():
        idx = _GEOHASH32.find(c)
        if idx < 0:
            return None
        for bit in (16, 8, 4, 2, 1):
            rng = lon_rng if even else lat_rng
            mid = (rng[0] + rng[1]) / 2
            if idx & bit:
                rng[0] = mid
            else:
                rng[1] = mid
            even = not even
    return {
        "latitude": (lat_rng[0] + lat_rng[1]) / 2,
        "longitude": (lon_rng[0] + lon_rng[1]) / 2,
    }


# ---------------------------------------------------------------------------
# apoc.scoring.* (ref: apoc/scoring/scoring.go — similarity + rank metrics)
# ---------------------------------------------------------------------------


@register("apoc.scoring.existence")
def scoring_existence(score, exists):
    """(ref scoring.go Existence) score if exists else 0."""
    return float(score) if exists else 0.0


@register("apoc.scoring.pareto")
def scoring_pareto(minimum_threshold, eighty_percent_value, maximum_value, score):
    """(ref scoring.go Pareto) 80/20 cumulative-exponential scoring."""
    score = float(score)
    if score < float(minimum_threshold):
        return 0.0
    k = _math.log(5.0) / float(eighty_percent_value)
    return float(maximum_value) * (1.0 - _math.exp(-k * score))


@register("apoc.scoring.cosine")
def scoring_cosine(a, b):
    a, b = _nums(a), _nums(b)
    if len(a) != len(b) or not a:
        return None
    dot = sum(x * y for x, y in zip(a, b))
    na = _math.sqrt(sum(x * x for x in a))
    nb = _math.sqrt(sum(y * y for y in b))
    if na == 0 or nb == 0:
        return 0.0
    return dot / (na * nb)


@register("apoc.scoring.euclidean")
def scoring_euclidean(a, b):
    a, b = _nums(a), _nums(b)
    if len(a) != len(b) or not a:
        return None
    return _math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)))


@register("apoc.scoring.manhattan")
def scoring_manhattan(a, b):
    a, b = _nums(a), _nums(b)
    if len(a) != len(b) or not a:
        return None
    return sum(abs(x - y) for x, y in zip(a, b))


@register("apoc.scoring.jaccard")
def scoring_jaccard(a, b):
    sa, sb = set(a or []), set(b or [])
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


@register("apoc.scoring.overlap")
def scoring_overlap(a, b):
    sa, sb = set(a or []), set(b or [])
    denom = min(len(sa), len(sb))
    return len(sa & sb) / denom if denom else 0.0


@register("apoc.scoring.dice")
def scoring_dice(a, b):
    sa, sb = set(a or []), set(b or [])
    if not sa and not sb:
        return 1.0
    return 2 * len(sa & sb) / (len(sa) + len(sb))


@register("apoc.scoring.pearson")
def scoring_pearson(a, b):
    return stats_correlation(a, b)


@register("apoc.scoring.sigmoid")
def scoring_sigmoid(x):
    return None if x is None else 1.0 / (1.0 + _math.exp(-float(x)))


@register("apoc.scoring.softmax")
def scoring_softmax(xs):
    v = _nums(xs)
    if not v:
        return []
    m = max(v)
    exps = [_math.exp(x - m) for x in v]
    s = sum(exps)
    return [e / s for e in exps]


@register("apoc.scoring.minMax")
def scoring_minmax(xs):
    return stats_normalize(xs)


@register("apoc.scoring.rank")
def scoring_rank(xs, descending=True):
    """1-based ranks; ties share the lower rank."""
    v = _nums(xs)
    order = sorted(v, reverse=bool(descending))
    return [order.index(x) + 1 for x in v]


@register("apoc.scoring.topK")
def scoring_topk(xs, k):
    v = _nums(xs)
    return sorted(v, reverse=True)[: int(k)]


@register("apoc.scoring.tfidf")
def scoring_tfidf(term_count, doc_len, n_docs, docs_with_term):
    """tf * idf with smooth idf (ref scoring.go TFIDF)."""
    if not doc_len or not n_docs:
        return 0.0
    tf = float(term_count) / float(doc_len)
    idf = _math.log((1.0 + float(n_docs)) / (1.0 + float(docs_with_term))) + 1.0
    return tf * idf


# ---------------------------------------------------------------------------
# apoc.xml.* (ref: apoc/xml/xml.go — Parse/ToMap/ToJson/escape helpers)
# ---------------------------------------------------------------------------


def _xml_to_map(el: _ET.Element) -> dict:
    out: dict[str, Any] = {"_type": el.tag}
    if el.attrib:
        out.update(el.attrib)
    text = (el.text or "").strip()
    if text:
        out["_text"] = text
    children = [_xml_to_map(c) for c in el]
    if children:
        out["_children"] = children
    return out


@register("apoc.xml.parse")
def xml_parse(s):
    """XML string -> nested map {_type, attrs..., _text, _children}."""
    if s is None:
        return None
    try:
        return _xml_to_map(_ET.fromstring(s))
    except _ET.ParseError:
        return None


@register("apoc.xml.validate")
def xml_validate(s):
    if s is None:
        return False
    try:
        _ET.fromstring(s)
        return True
    except _ET.ParseError:
        return False


@register("apoc.xml.toJson")
def xml_to_json(s):
    m = xml_parse(s)
    return None if m is None else _json.dumps(m)


@register("apoc.xml.escape")
def xml_escape(s):
    if s is None:
        return None
    return (
        str(s)
        .replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace('"', "&quot;")
        .replace("'", "&apos;")
    )


@register("apoc.xml.unescape")
def xml_unescape(s):
    if s is None:
        return None
    return (
        str(s)
        .replace("&apos;", "'")
        .replace("&quot;", '"')
        .replace("&gt;", ">")
        .replace("&lt;", "<")
        .replace("&amp;", "&")
    )


@register("apoc.xml.getAttribute")
def xml_get_attribute(s, tag, attr):
    if s is None:
        return None
    try:
        root = _ET.fromstring(s)
    except _ET.ParseError:
        return None
    if root.tag == tag and attr in root.attrib:
        return root.attrib[attr]
    el = root.find(f".//{tag}")
    return el.attrib.get(attr) if el is not None else None


@register("apoc.xml.getText")
def xml_get_text(s, tag):
    if s is None:
        return None
    try:
        root = _ET.fromstring(s)
    except _ET.ParseError:
        return None
    el = root if root.tag == tag else root.find(f".//{tag}")
    return (el.text or "").strip() if el is not None else None


# ---------------------------------------------------------------------------
# apoc.agg.* gaps (ref: apoc/agg — Nth/Slice/Mode/MinItems/MaxItems/
# Frequencies; the rest live in functions.py)
# ---------------------------------------------------------------------------


@register("apoc.agg.nth", category="agg")
def agg_nth(xs, offset):
    xs = list(xs or [])
    i = int(offset)
    return xs[i] if -len(xs) <= i < len(xs) else None


@register("apoc.agg.slice", category="agg")
def agg_slice(xs, start=0, length=None):
    xs = list(xs or [])
    start = int(start)
    if length is None:
        return xs[start:]
    return xs[start : start + int(length)]


def _agg_key(v: Any) -> Any:
    """Canonical hashable key for Cypher values. Type-tagged so a string
    never collides with a structurally-equal serialized list/map and
    booleans stay distinct from 0/1 (Cypher equality treats 1 = 1.0 as
    equal, so plain numbers share a key)."""
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, (list, dict)):
        return ("json", _json.dumps(v, sort_keys=True, default=str))
    if isinstance(v, str):
        return ("str", v)
    return ("val", v)


@register("apoc.agg.mode", category="agg")
def agg_mode(xs):
    xs = [x for x in (xs or []) if x is not None]
    if not xs:
        return None
    counts: dict[Any, int] = {}
    for x in xs:
        k = _agg_key(x)
        counts[k] = counts.get(k, 0) + 1
    best = max(counts.values())
    # deterministic: first value reaching the max count
    for x in xs:
        if counts[_agg_key(x)] == best:
            return x
    return None


@register("apoc.agg.minItems", category="agg")
def agg_min_items(items, values=None):
    """All items tied for the minimum value. One-arg form reduces the list
    itself; two-arg form pairs items with their sort values."""
    items = list(items or [])
    vals = list(values) if values is not None else items
    pairs = [(v, i) for i, v in zip(items, vals) if v is not None]
    if not pairs:
        return {"value": None, "items": []}
    lo = min(p[0] for p in pairs)
    return {"value": lo, "items": [i for v, i in pairs if v == lo]}


@register("apoc.agg.maxItems", category="agg")
def agg_max_items(items, values=None):
    items = list(items or [])
    vals = list(values) if values is not None else items
    pairs = [(v, i) for i, v in zip(items, vals) if v is not None]
    if not pairs:
        return {"value": None, "items": []}
    hi = max(p[0] for p in pairs)
    return {"value": hi, "items": [i for v, i in pairs if v == hi]}


@register("apoc.agg.frequencies", category="agg")
def agg_frequencies(xs):
    counts: dict[Any, int] = {}
    order: list[tuple[Any, Any]] = []  # (key, original value)
    for x in xs or []:
        k = _agg_key(x)
        if k not in counts:
            order.append((k, x))
        counts[k] = counts.get(k, 0) + 1
    return [{"item": x, "count": counts[k]} for k, x in order]


# ---------------------------------------------------------------------------
# apoc.util.* gaps (ref: apoc/util/util.go — sleep/validate/compress/
# base64/url/timestamps; md5/sha* live in functions.py)
# ---------------------------------------------------------------------------


@register("apoc.util.sleep")
def util_sleep(ms):
    """Capped at 10s: an unbounded sleep inside a query is a DoS lever
    (the reference sleeps uncapped; deliberate deviation)."""
    import time as _t

    _t.sleep(min(max(float(ms or 0), 0.0), 10_000.0) / 1000.0)
    return None


@register("apoc.util.validate")
def util_validate(predicate, message, params=None):
    """Raise with `message` when predicate is truthy (ref util.go Validate:
    used for inline assertions in write queries)."""
    if predicate:
        msg = str(message or "validation failed")
        for i, p in enumerate(params or []):
            msg = msg.replace("%s", str(p), 1).replace(f"{{{i}}}", str(p))
        raise ValueError(msg)
    return None


@register("apoc.util.compress")
def util_compress(s, config=None):
    import gzip as _gzip

    if s is None:
        return None
    return list(_gzip.compress(str(s).encode("utf-8")))


@register("apoc.util.decompress")
def util_decompress(data, config=None):
    import gzip as _gzip

    if data is None:
        return None
    return _gzip.decompress(bytes(bytearray(int(b) & 0xFF for b in data))).decode("utf-8")


# base64/url codecs already exist as apoc.text.*; register the util names
# as aliases of the SAME functions so a fix in one spelling reaches both
from nornicdb_tpu_torch.apoc.functions import (  # noqa: E402
    text_b64,
    text_unb64,
    text_urldecode,
    text_urlencode,
)

register("apoc.util.encodeBase64")(text_b64)
register("apoc.util.decodeBase64")(text_unb64)
register("apoc.util.encodeUrl")(text_urlencode)
register("apoc.util.decodeUrl")(text_urldecode)


# ---------------------------------------------------------------------------
# apoc.convert.* gaps (ref: apoc/convert/convert.go — typed lists, sets,
# sorted json, json property helpers)
# ---------------------------------------------------------------------------


@register("apoc.convert.toSet")
def convert_to_set(xs):
    """Dedup preserving first-seen order (apoc returns a list)."""
    if xs is None:
        return None
    seen = set()
    out = []
    for x in xs if isinstance(xs, list) else [xs]:
        k = _agg_key(x)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


@register("apoc.convert.toSortedJsonMap")
def convert_sorted_json(v):
    return None if v is None else _json.dumps(v, sort_keys=True, default=str)


def _to_typed_list(xs, cast):
    if xs is None:
        return None
    out = []
    for x in xs if isinstance(xs, list) else [xs]:
        try:
            out.append(None if x is None else cast(x))
        except (TypeError, ValueError):
            out.append(None)
    return out


@register("apoc.convert.toIntList")
def convert_int_list(xs):
    def cast(v):
        try:
            return int(v)  # exact for big ints; int(float()) would round 2^53+
        except (TypeError, ValueError):
            return int(float(v))  # decimal strings like "2.7"
    return _to_typed_list(xs, cast)


@register("apoc.convert.toFloatList")
def convert_float_list(xs):
    return _to_typed_list(xs, float)


@register("apoc.convert.toStringList")
def convert_string_list(xs):
    return _to_typed_list(xs, str)


@register("apoc.convert.toBooleanList")
def convert_bool_list(xs):
    def cast(v):
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "1")
        return bool(v)
    return _to_typed_list(xs, cast)


@register("apoc.convert.getJsonProperty")
def convert_get_json_prop(entity, key, path=None):
    """Parse a JSON-string property and optionally descend a path. Accepts
    a node, a property map, or a raw JSON string (ref convert.go:237 takes
    the JSON string form)."""
    if isinstance(entity, str):
        # reference form: the FIRST arg is the JSON document; the value is
        # returned as-is (no double parse)
        try:
            doc = _json.loads(entity)
        except ValueError:
            return None
        if not isinstance(doc, dict):
            return None
        val = doc.get(key)
        return _json_path(val, str(path)) if path else val
    # node/map form: the property VALUE is a JSON string to parse
    props = getattr(entity, "properties", entity) or {}
    if not isinstance(props, dict):
        return None
    raw = props.get(key)
    if raw is None:
        return None
    try:
        obj = _json.loads(raw) if isinstance(raw, str) else raw
    except ValueError:
        return None
    return _json_path(obj, str(path)) if path else obj


@register("apoc.convert.setJsonProperty")
def convert_set_json_prop(entity, key, value):
    """Serialize value into a JSON-string property. For a node/map input
    the entity is returned; for a raw JSON-string input the updated JSON
    string is returned (ref convert.go SetJsonProperty)."""
    if isinstance(entity, str):
        try:
            obj = _json.loads(entity)
        except ValueError:
            return None
        if not isinstance(obj, dict):
            return None
        obj[key] = value
        return _json.dumps(obj, default=str)
    props = getattr(entity, "properties", entity)
    props[key] = _json.dumps(value, default=str)
    return entity


# ---------------------------------------------------------------------------
# apoc.date.* gaps (ref: apoc/date/date.go — ISO8601 + unix + fields)
# ---------------------------------------------------------------------------


@register("apoc.date.toISO8601")
def date_to_iso(epoch, unit="ms"):
    import datetime as _dt

    if epoch is None:
        return None
    secs = float(epoch) / (1000.0 if unit == "ms" else 1.0)
    return _dt.datetime.fromtimestamp(
        secs, tz=_dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


@register("apoc.date.fromISO8601")
def date_from_iso(s):
    import datetime as _dt

    if s is None:
        return None
    s = str(s).replace("Z", "+00:00")
    dt = _dt.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


@register("apoc.date.toUnixTime")
def date_to_unix(epoch_ms):
    return None if epoch_ms is None else int(float(epoch_ms) / 1000.0)


@register("apoc.date.fromUnixTime")
def date_from_unix(secs):
    return None if secs is None else int(float(secs) * 1000.0)


@register("apoc.date.field")
def date_field(epoch_ms, unit="d"):
    """Extract a field from an epoch-ms timestamp (UTC)."""
    import datetime as _dt

    if epoch_ms is None:
        return None
    dt = _dt.datetime.fromtimestamp(float(epoch_ms) / 1000.0,
                                    tz=_dt.timezone.utc)
    unit = str(unit).lower()
    return {
        "years": dt.year, "year": dt.year, "y": dt.year,
        "months": dt.month, "month": dt.month,
        "days": dt.day, "day": dt.day, "d": dt.day,
        "hours": dt.hour, "hour": dt.hour, "h": dt.hour,
        # 'm' means MINUTES (ref date.go duration units), not month
        "minutes": dt.minute, "minute": dt.minute, "m": dt.minute,
        "seconds": dt.second, "second": dt.second, "s": dt.second,
    }.get(unit)


@register("apoc.date.fields")
def date_fields(epoch_ms):
    import datetime as _dt

    if epoch_ms is None:
        return None
    dt = _dt.datetime.fromtimestamp(float(epoch_ms) / 1000.0,
                                    tz=_dt.timezone.utc)
    # key names follow the reference's Fields map (date.go:80)
    return {"year": dt.year, "month": dt.month, "day": dt.day,
            "hour": dt.hour, "minute": dt.minute, "second": dt.second,
            "dayOfWeek": dt.isoweekday(),
            "dayOfYear": dt.timetuple().tm_yday,
            "weekOfYear": dt.isocalendar()[1]}


# ---------------------------------------------------------------------------
# apoc.temporal.* gaps (ref: apoc/temporal/temporal.go — epoch-ms calendar
# helpers: StartOf/EndOf/IsWeekend/Quarter/IsLeapYear/DaysInMonth/
# Difference/Age; apoc.temporal.format lives in functions.py)
# ---------------------------------------------------------------------------


def _dt_utc(epoch_ms):
    import datetime as _dt

    return _dt.datetime.fromtimestamp(float(epoch_ms) / 1000.0,
                                      tz=_dt.timezone.utc)


@register("apoc.temporal.startOf")
def temporal_start_of(epoch_ms, unit="day"):
    import datetime as _dt

    if epoch_ms is None:
        return None
    dt = _dt_utc(epoch_ms)
    unit = str(unit).lower()
    if unit in ("year", "years"):
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    elif unit in ("month", "months"):
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit in ("week", "weeks"):
        dt = (dt - _dt.timedelta(days=dt.isoweekday() - 1)).replace(
            hour=0, minute=0, second=0, microsecond=0)
    elif unit in ("day", "days"):
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit in ("hour", "hours"):
        dt = dt.replace(minute=0, second=0, microsecond=0)
    elif unit in ("minute", "minutes"):
        dt = dt.replace(second=0, microsecond=0)
    else:
        return None
    return int(dt.timestamp() * 1000)


def _next_period_start(dt, unit: str):
    """Start of the FOLLOWING unit period; shared by endOf so the unit
    dispatch can never drift from startOf's. Returns None for unknown
    units (same contract as startOf)."""
    import datetime as _dt

    if unit in ("year", "years"):
        return dt.replace(year=dt.year + 1)
    if unit in ("month", "months"):
        return (dt.replace(year=dt.year + 1, month=1) if dt.month == 12
                else dt.replace(month=dt.month + 1))
    if unit in ("week", "weeks"):
        return dt + _dt.timedelta(days=7)
    if unit in ("day", "days"):
        return dt + _dt.timedelta(days=1)
    if unit in ("hour", "hours"):
        return dt + _dt.timedelta(hours=1)
    if unit in ("minute", "minutes"):
        return dt + _dt.timedelta(minutes=1)
    return None


@register("apoc.temporal.endOf")
def temporal_end_of(epoch_ms, unit="day"):
    if epoch_ms is None:
        return None
    start = temporal_start_of(epoch_ms, unit)
    if start is None:
        return None
    nxt = _next_period_start(_dt_utc(start), str(unit).lower())
    if nxt is None:
        return None
    return int(nxt.timestamp() * 1000) - 1


@register("apoc.temporal.isWeekend")
def temporal_is_weekend(epoch_ms):
    return None if epoch_ms is None else _dt_utc(epoch_ms).isoweekday() >= 6


@register("apoc.temporal.isWeekday")
def temporal_is_weekday(epoch_ms):
    return None if epoch_ms is None else _dt_utc(epoch_ms).isoweekday() <= 5


@register("apoc.temporal.quarter")
def temporal_quarter(epoch_ms):
    if epoch_ms is None:
        return None
    return (_dt_utc(epoch_ms).month - 1) // 3 + 1


@register("apoc.temporal.isLeapYear")
def temporal_is_leap(year):
    import calendar

    return None if year is None else calendar.isleap(int(year))


@register("apoc.temporal.daysInMonth")
def temporal_days_in_month(year, month):
    import calendar

    if year is None or month is None:
        return None
    return calendar.monthrange(int(year), int(month))[1]


@register("apoc.temporal.difference")
def temporal_difference(a_ms, b_ms, unit="ms"):
    """Signed difference b - a, truncated toward zero (ref temporal.go
    Difference — the sign tells callers which side is later). months/years
    use the reference's fixed 30/365-day approximations."""
    if a_ms is None or b_ms is None:
        return None
    diff = float(b_ms) - float(a_ms)
    divisors = {
        "ms": 1.0,
        "s": 1e3, "second": 1e3, "seconds": 1e3,
        "m": 6e4, "minute": 6e4, "minutes": 6e4,
        "h": 3.6e6, "hour": 3.6e6, "hours": 3.6e6,
        "d": 8.64e7, "day": 8.64e7, "days": 8.64e7,
        "month": 30 * 8.64e7, "months": 30 * 8.64e7,
        "year": 365 * 8.64e7, "years": 365 * 8.64e7,
    }
    div = divisors.get(str(unit).lower())
    return None if div is None else int(diff / div)


@register("apoc.temporal.age")
def temporal_age(birth_ms, now_ms=None):
    """Whole years between birth and now (calendar-aware)."""
    if birth_ms is None:
        return None
    import time as _t

    b = _dt_utc(birth_ms)
    n = _dt_utc(now_ms if now_ms is not None else _t.time() * 1000.0)
    years = n.year - b.year
    if (n.month, n.day) < (b.month, b.day):
        years -= 1
    return years


# ---------------------------------------------------------------------------
# apoc.map.* gaps (ref: apoc/map/map.go — FromValues/SetEntry/SetPairs/
# SetLists/SetValues/MGet/Keys/Unflatten/UpdateTree/DropNullValues)
# ---------------------------------------------------------------------------


@register("apoc.map.fromValues")
def map_from_values(xs):
    """Alternating [k1, v1, k2, v2, ...] -> map."""
    xs = list(xs or [])
    return {str(xs[i]): xs[i + 1] for i in range(0, len(xs) - 1, 2)}


# setEntry is the reference's alias for SetKey — register the SAME function
from nornicdb_tpu_torch.apoc.functions import map_set_key as _map_set_key  # noqa: E402

register("apoc.map.setEntry")(_map_set_key)


@register("apoc.map.setPairs")
def map_set_pairs(m, pairs):
    out = dict(m or {})
    for pair in pairs or []:
        if isinstance(pair, (list, tuple)) and len(pair) >= 2:
            out[str(pair[0])] = pair[1]
    return out


@register("apoc.map.setLists")
def map_set_lists(m, keys, values):
    out = dict(m or {})
    for k, v in zip(keys or [], values or []):
        out[str(k)] = v
    return out


@register("apoc.map.setValues")
def map_set_values(m, xs):
    """Alternating [k1, v1, ...] merged into m."""
    out = dict(m or {})
    xs = list(xs or [])
    for i in range(0, len(xs) - 1, 2):
        out[str(xs[i])] = xs[i + 1]
    return out


@register("apoc.map.mget")
def map_mget(m, keys, default=None):
    m = m or {}
    return [m.get(str(k), default) for k in keys or []]


@register("apoc.map.keys")
def map_keys(m):
    return sorted((m or {}).keys())  # ref map.go Keys sorts


@register("apoc.map.unflatten")
def map_unflatten(m, delimiter="."):
    """{"a.b": 1} -> {"a": {"b": 1}} (inverse of apoc.map.flatten)."""
    out: dict[str, Any] = {}
    for k, v in (m or {}).items():
        parts = str(k).split(delimiter)
        cur = out
        for p in parts[:-1]:
            nxt = cur.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                cur[p] = nxt
            cur = nxt
        cur[parts[-1]] = v
    return out


@register("apoc.map.updateTree")
def map_update_tree(m, path, value):
    """Set a value at a dot-delimited path, creating intermediate maps
    (ref map.go UpdateTree). Non-map intermediates are replaced rather
    than panicking like the reference's type assertion."""
    out = dict(m or {})
    parts = str(path).split(".")
    cur = out
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
        else:
            nxt = dict(nxt)  # copy-on-write down the path
        cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value
    return out


@register("apoc.map.dropNullValues")
def map_drop_nulls(m):
    return {k: v for k, v in (m or {}).items() if v is not None}


# ---------------------------------------------------------------------------
# apoc.coll.* gaps (ref: apoc/coll/coll.go — ContainsAny/Sorted, Different,
# Disjunction, DuplicatesWithCount, InsertAll, IsEmpty/IsNotEmpty,
# PairsMin, RemoveAll, Set, Slice, SortMaps, UnionAll, FrequenciesAsMap)
# ---------------------------------------------------------------------------


@register("apoc.coll.containsAny")
def coll_contains_any(xs, candidates):
    if xs is None or candidates is None:
        return None
    keys = {_agg_key(x) for x in xs}
    return any(_agg_key(c) in keys for c in candidates)


@register("apoc.coll.containsSorted")
def coll_contains_sorted(xs, value):
    """Binary search over an already-sorted list (ref coll.go
    ContainsSorted). A probe that isn't order-comparable with the
    elements is simply not contained."""
    import bisect

    if xs is None:
        return None
    try:
        i = bisect.bisect_left(xs, value)
    except TypeError:
        return False
    return i < len(xs) and xs[i] == value


@register("apoc.coll.different")
def coll_different(a, b):
    """Elements of the first list absent from the second (ref coll.go
    Different(list1, list2) — a list difference, not a predicate)."""
    if a is None:
        return None
    kb = {_agg_key(x) for x in (b or [])}
    return [x for x in a if _agg_key(x) not in kb]


@register("apoc.coll.disjunction")
def coll_disjunction(a, b):
    """Symmetric difference, first-seen order."""
    a, b = list(a or []), list(b or [])
    ka = {_agg_key(x) for x in a}
    kb = {_agg_key(x) for x in b}
    out = []
    emitted: set[Any] = set()  # result is a SET (ref applies ToSet)
    for x in a:
        k = _agg_key(x)
        if k not in kb and k not in emitted:
            emitted.add(k)
            out.append(x)
    for x in b:
        k = _agg_key(x)
        if k not in ka and k not in emitted:
            emitted.add(k)
            out.append(x)
    return out


@register("apoc.coll.duplicatesWithCount")
def coll_dupes_with_count(xs):
    counts: dict[Any, int] = {}
    order: list[tuple[Any, Any]] = []
    for x in xs or []:
        k = _agg_key(x)
        if k not in counts:
            order.append((k, x))
        counts[k] = counts.get(k, 0) + 1
    return [{"item": x, "count": counts[k]} for k, x in order if counts[k] > 1]


@register("apoc.coll.insertAll")
def coll_insert_all(xs, index, values):
    xs = list(xs or [])
    i = int(index)
    if not 0 <= i <= len(xs):
        return xs  # out-of-range is a no-op (ref + coll.set convention)
    return xs[:i] + list(values or []) + xs[i:]


@register("apoc.coll.isEmpty")
def coll_is_empty(xs):
    return None if xs is None else len(xs) == 0


@register("apoc.coll.isNotEmpty")
def coll_is_not_empty(xs):
    return None if xs is None else len(xs) > 0


@register("apoc.coll.pairsMin")
def coll_pairs_min(xs):
    """NON-overlapping pairs, stepping by two; a trailing odd element is
    dropped (ref coll.go PairsMin i += 2)."""
    xs = list(xs or [])
    return [[xs[i], xs[i + 1]] for i in range(0, len(xs) - 1, 2)]


@register("apoc.coll.removeAll")
def coll_remove_all(xs, to_remove):
    kill = {_agg_key(x) for x in (to_remove or [])}
    return [x for x in (xs or []) if _agg_key(x) not in kill]


@register("apoc.coll.set")
def coll_set(xs, index, value):
    xs = list(xs or [])
    i = int(index)
    if 0 <= i < len(xs):
        xs[i] = value
    return xs


@register("apoc.coll.slice")
def coll_slice(xs, offset, length=None):
    xs = list(xs or [])
    off = max(0, int(offset))
    if length is None:
        return xs[off:]
    return xs[off : off + max(0, int(length))]


@register("apoc.coll.sortMaps")
def coll_sort_maps(maps, key, descending=False):
    """Sort a list of maps by a key, ASCENDING like the reference
    (coll.go SortMaps has no direction param); null-valued entries sort
    last. The optional descending flag is a convenience superset."""
    maps = list(maps or [])
    with_val = [m for m in maps if isinstance(m, dict) and m.get(key) is not None]
    without = [m for m in maps if not (isinstance(m, dict) and m.get(key) is not None)]
    # heterogeneous property values are normal graph data: sort within
    # type groups (type-tagged key) instead of raising TypeError
    def sort_key(m):
        v = m[key]
        if isinstance(v, bool):
            return (0, v)
        if isinstance(v, (int, float)):
            return (1, v)
        if isinstance(v, str):
            return (2, v)
        return (3, str(v))
    with_val.sort(key=sort_key, reverse=bool(descending))
    return with_val + without


@register("apoc.coll.unionAll")
def coll_union_all(a, b):
    """Concatenation keeping duplicates (union() dedups)."""
    return list(a or []) + list(b or [])


@register("apoc.coll.frequenciesAsMap")
def coll_frequencies_as_map(xs):
    """List of {item, count} rows, exactly the reference's shape
    (coll.go FrequenciesAsMap returns []map, not a dict — the name is
    historical)."""
    from nornicdb_tpu_torch.apoc.functions import coll_frequencies

    return coll_frequencies(xs)


# ---------------------------------------------------------------------------
# apoc.text.* gaps (ref: apoc/text/text.go — CapitalizeAll/DecapitalizeAll/
# Reverse/Trim family/IndexesOf/FromCodePoint/Bytes/Hamming/JaroWinkler/
# Phonetic/DoubleMetaphone)
# ---------------------------------------------------------------------------


@register("apoc.text.capitalizeAll")
def text_capitalize_all(s):
    # ref text.go CapitalizeAll is strings.ToUpper (not title-case)
    return None if s is None else str(s).upper()


@register("apoc.text.decapitalizeAll")
def text_decapitalize_all(s):
    return None if s is None else str(s).lower()


@register("apoc.text.reverse")
def text_reverse(s):
    return None if s is None else str(s)[::-1]


@register("apoc.text.trim")
def text_trim(s):
    return None if s is None else str(s).strip()


@register("apoc.text.ltrim")
def text_ltrim(s):
    return None if s is None else str(s).lstrip()


@register("apoc.text.rtrim")
def text_rtrim(s):
    return None if s is None else str(s).rstrip()


@register("apoc.text.indexesOf")
def text_indexes_of(s, lookup, from_=0, to=None):
    if s is None or lookup is None:
        return None
    s, lookup = str(s), str(lookup)
    end = len(s) if to is None else int(to)
    out = []
    i = int(from_)
    while True:
        i = s.find(lookup, i, end)
        if i == -1:
            break
        out.append(i)
        i += 1
    return out


@register("apoc.text.fromCodePoint")
def text_from_code_point(*codes):
    vals = codes[0] if len(codes) == 1 and isinstance(codes[0], list) else codes
    return "".join(chr(int(c)) for c in vals)


@register("apoc.text.bytes")
def text_bytes(s, charset="UTF-8"):
    return None if s is None else list(str(s).encode(charset))


@register("apoc.text.bytesToString")
def text_bytes_to_string(data, charset="UTF-8"):
    if data is None:
        return None
    return bytes(bytearray(int(b) & 0xFF for b in data)).decode(charset)


@register("apoc.text.hammingDistance")
def text_hamming(a, b):
    if a is None or b is None:
        return None
    a, b = str(a), str(b)
    if len(a) != len(b):
        return -1  # ref text.go: unequal lengths are invalid, sentinel -1
    return sum(x != y for x, y in zip(a, b))


@register("apoc.text.jaroWinklerDistance")
def text_jaro_winkler(a, b):
    """Jaro-Winkler SIMILARITY in [0,1] (apoc's name says distance but it
    returns similarity, matching the reference)."""
    if a is None or b is None:
        return None
    s1, s2 = str(a), str(b)
    if s1 == s2:
        return 1.0
    if not s1 or not s2:
        return 0.0
    window = max(max(len(s1), len(s2)) // 2 - 1, 1)  # ref clamps to >= 1
    m1, m2 = [False] * len(s1), [False] * len(s2)
    matches = 0
    for i, c in enumerate(s1):
        lo, hi = max(0, i - window), min(len(s2), i + window + 1)
        for j in range(lo, hi):
            if not m2[j] and s2[j] == c:
                m1[i] = m2[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    t = 0
    k = 0
    for i in range(len(s1)):
        if m1[i]:
            while not m2[k]:
                k += 1
            if s1[i] != s2[k]:
                t += 1
            k += 1
    jaro = (matches / len(s1) + matches / len(s2)
            + (matches - t / 2) / matches) / 3.0
    prefix = 0
    for x, y in zip(s1, s2):
        if x != y or prefix == 4:
            break
        prefix += 1
    return jaro + prefix * 0.1 * (1.0 - jaro)


def _soundex(s: str) -> str:
    """Classic Soundex (ref text.go Phonetic)."""
    codes = {
        **dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
        **dict.fromkeys("DT", "3"), "L": "4",
        **dict.fromkeys("MN", "5"), "R": "6",
    }
    s = "".join(c for c in s.upper() if c.isalpha())
    if not s:
        return ""
    out = s[0]
    prev = codes.get(s[0], "")
    for c in s[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out += code
            if len(out) == 4:
                break
        if c not in "HW":
            prev = code
    return (out + "000")[:4]


@register("apoc.text.phonetic")
def text_phonetic(s):
    if s is None:
        return None
    return "".join(_soundex(w) for w in str(s).split())


@register("apoc.text.phoneticDelta")
def text_phonetic_delta(a, b):
    """0 = identical soundex codes, 4 = different (ref text.go
    PhoneticDelta — a DELTA, so zero means phonetically the same)."""
    if a is None or b is None:
        return None
    return 0 if _soundex(str(a)) == _soundex(str(b)) else 4


# ---------------------------------------------------------------------------
# apoc.number.* gaps (ref: apoc/number/number.go — romanize/arabize, base
# conversions, clamp/lerp, primality, gcd/lcm, factorial, fibonacci)
# ---------------------------------------------------------------------------

_ROMAN = [(1000, "M"), (900, "CM"), (500, "D"), (400, "CD"), (100, "C"),
          (90, "XC"), (50, "L"), (40, "XL"), (10, "X"), (9, "IX"),
          (5, "V"), (4, "IV"), (1, "I")]


@register("apoc.number.romanize")
def number_romanize(n):
    if n is None:
        return None
    n = int(n)
    if not 0 < n < 4000:
        return None
    out = []
    for val, sym in _ROMAN:
        while n >= val:
            out.append(sym)
            n -= val
    return "".join(out)


@register("apoc.number.arabize")
def number_arabize(s):
    if not s:
        return None
    vals = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
    s = str(s).upper()
    total = 0
    prev = 0  # value of the PREVIOUS char (right-to-left), not a running max
    for c in reversed(s):
        v = vals.get(c)
        if v is None:
            return None
        total += v if v >= prev else -v
        prev = v
    return total


_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)
_BASE_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def _parse_int_strict(s, base: int):
    """strconv.ParseInt-shaped parsing: optional sign, strict per-base
    charset (no 0x/0b prefixes, no underscores, no whitespace), int64
    bounds. Returns None on any violation — shared by every from* codec
    so their leniency can never diverge."""
    if s is None:
        return None
    s = str(s)
    body = s[1:] if s[:1] in "+-" else s
    if not body:
        return None
    allowed = set(_BASE_DIGITS[:base])
    if any(c not in allowed for c in body.lower()):
        return None
    v = int(s, base)
    if not _INT64_MIN <= v <= _INT64_MAX:
        return None
    return v


@register("apoc.number.toHex")
def number_to_hex(n):
    # reference uppercases (number.go ToHex: strings.ToUpper)
    return None if n is None else format(int(n), "X")


@register("apoc.number.fromHex")
def number_from_hex(s):
    return _parse_int_strict(s, 16)


@register("apoc.number.toBinary")
def number_to_binary(n):
    return None if n is None else format(int(n), "b")


@register("apoc.number.fromBinary")
def number_from_binary(s):
    return _parse_int_strict(s, 2)


@register("apoc.number.toOctal")
def number_to_octal(n):
    return None if n is None else format(int(n), "o")


@register("apoc.number.fromOctal")
def number_from_octal(s):
    return _parse_int_strict(s, 8)


@register("apoc.number.toBase")
def number_to_base(n, base):
    if n is None or base is None:
        return None
    base = int(base)
    if not 2 <= base <= 36:
        return None
    n = int(n)
    if n == 0:
        return "0"
    neg = n < 0
    n = abs(n)
    out = []
    while n:
        out.append(_BASE_DIGITS[n % base])
        n //= base
    # reference uppercases base-converted output (number.go ToBase)
    return (("-" if neg else "") + "".join(reversed(out))).upper()


@register("apoc.number.fromBase")
def number_from_base(s, base):
    try:
        base = int(base)
    except (TypeError, ValueError):
        return None
    if not 2 <= base <= 36:
        return None
    return _parse_int_strict(s, base)


# ---------------------------------------------------------------------------
# apoc.math.* gaps (ref: apoc/math/math.go — clamp/lerp/gcd/lcm/factorial/
# fibonacci/isPrime/nextPrime/logit and the trig family)
# ---------------------------------------------------------------------------


@register("apoc.math.clamp")
def math_clamp(v, lo, hi):
    if v is None or lo is None or hi is None:
        return None
    return max(float(lo), min(float(hi), float(v)))


@register("apoc.math.lerp")
def math_lerp(a, b, t):
    if a is None or b is None or t is None:
        return None
    return float(a) + (float(b) - float(a)) * float(t)


@register("apoc.math.gcd")
def math_gcd(a, b):
    return None if a is None or b is None else _math.gcd(int(a), int(b))


@register("apoc.math.lcm")
def math_lcm(a, b):
    if a is None or b is None:
        return None
    a, b = int(a), int(b)
    return 0 if a == 0 or b == 0 else abs(a * b) // _math.gcd(a, b)


@register("apoc.math.factorial")
def math_factorial(n):
    if n is None:
        return None
    n = int(n)
    if n <= 1:
        return 1  # ref math.go Factorial: n <= 1 (incl. negatives) -> 1
    if n > 20:
        return None  # 21! overflows int64; the reference silently wraps
    return _math.factorial(n)


@register("apoc.math.fibonacci")
def math_fibonacci(n):
    if n is None or int(n) < 0:
        return None
    a, b = 0, 1
    for _ in range(int(n)):
        a, b = b, a + b
    return a


@register("apoc.math.isPrime")
def math_is_prime(n):
    if n is None:
        return None
    n = int(n)
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


@register("apoc.math.nextPrime")
def math_next_prime(n):
    if n is None:
        return None
    c = int(n) + 1
    while not math_is_prime(c):
        c += 1
    return c


@register("apoc.math.logit")
def math_logit(p):
    if p is None:
        return None
    p = float(p)
    if not 0.0 < p < 1.0:
        return None
    return _math.log(p / (1.0 - p))


# ---------------------------------------------------------------------------
# apoc.hashing.* gaps (ref: apoc/hashing/hashing.go — FNV1a 32/64,
# MurmurHash3 32, JumpHash, ConsistentHash, Fingerprint; md5/sha live in
# functions.py)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


@register("apoc.hashing.fnv1a")
def hashing_fnv1a(s):
    if s is None:
        return None
    h = 0x811C9DC5
    for b in str(s).encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & _U32
    return h


@register("apoc.hashing.fnv1a64")
def hashing_fnv1a64(s):
    if s is None:
        return None
    h = 0xCBF29CE484222325
    for b in str(s).encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & _U64
    return h


@register("apoc.hashing.murmur3")
def hashing_murmur3(s, seed=0):
    """MurmurHash3 x86 32-bit (ref hashing.go murmur3_32)."""
    if s is None:
        return None
    data = str(s).encode("utf-8")
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = int(seed) & _U32
    n_blocks = len(data) // 4
    for i in range(n_blocks):
        k = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k = (k * c1) & _U32
        k = ((k << 15) | (k >> 17)) & _U32
        k = (k * c2) & _U32
        h ^= k
        h = ((h << 13) | (h >> 19)) & _U32
        h = (h * 5 + 0xE6546B64) & _U32
    tail = data[n_blocks * 4 :]
    k = 0
    for i, b in enumerate(tail):
        k |= b << (8 * i)
    if tail:
        k = (k * c1) & _U32
        k = ((k << 15) | (k >> 17)) & _U32
        k = (k * c2) & _U32
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    h ^= h >> 16
    return h


@register("apoc.hashing.jumpHash")
def hashing_jump_hash(key, buckets):
    """Jump consistent hash (ref hashing.go JumpHash — Lamping-Veach).
    String keys are fnv1a64-hashed first."""
    if key is None or buckets is None:
        return None
    buckets = int(buckets)
    if buckets <= 0:
        return None
    k = hashing_fnv1a64(key) if isinstance(key, str) else int(key) & _U64
    b, j = -1, 0
    while j < buckets:
        b = j
        k = (k * 2862933555777941757 + 1) & _U64
        j = int(float(b + 1) * (float(1 << 31) / float((k >> 33) + 1)))
    return b


@register("apoc.hashing.consistentHash")
def hashing_consistent(key, buckets):
    """fnv1a64(key) % buckets -> bucket index (ref hashing.go
    ConsistentHash). For ring-with-named-nodes semantics use jumpHash
    over an index into your node list."""
    if key is None or buckets is None:
        return None
    try:
        buckets = int(buckets)
    except (TypeError, ValueError):
        return None
    if buckets <= 0:
        return None
    return hashing_fnv1a64(str(key)) % buckets


@register("apoc.hashing.fingerprint")
def hashing_fingerprint(entity, exclude=None):
    """Content fingerprint of a node/relationship/map: sha256 over the
    sorted properties (minus excluded keys) + labels/type (ref
    hashing.go Fingerprint)."""
    import hashlib as _hl

    if entity is None:
        return None
    exclude = set(exclude or [])
    props = getattr(entity, "properties", None)
    if props is None and isinstance(entity, dict):
        props = entity
    if props is None:
        # scalar/list input: hash the value itself (ref hashes %v), so
        # distinct scalars get distinct fingerprints
        blob = _json.dumps(entity, sort_keys=True, default=str)
        return _hl.sha256(blob.encode("utf-8")).hexdigest()
    payload = {k: v for k, v in dict(props).items() if k not in exclude}
    # unambiguous envelope: labels/type ride INSIDE the json, so
    # ['A|B'] vs ['A','B'] can never collide and type never clobbers labels
    envelope = {"properties": payload}
    labels = getattr(entity, "labels", None)
    if labels is not None:
        envelope["labels"] = sorted(labels)
    etype = getattr(entity, "type", None)
    if isinstance(etype, str):
        envelope["type"] = etype
    blob = _json.dumps(envelope, sort_keys=True, default=str)
    return _hl.sha256(blob.encode("utf-8")).hexdigest()


# ---------------------------------------------------------------------------
# apoc.node./rel./label./any. gaps (ref: apoc/node/node.go, rel/rel.go,
# label/label.go, any/any.go — pure accessors over bound entities)
# ---------------------------------------------------------------------------


@register("apoc.node.id")
def node_id(n):
    return None if n is None else getattr(n, "id", None)


@register("apoc.node.labels")
def node_labels(n):
    return None if n is None else list(getattr(n, "labels", []) or [])


@register("apoc.node.hasLabel")
def node_has_label(n, label):
    if n is None or label is None:
        return None
    return str(label) in (getattr(n, "labels", []) or [])


@register("apoc.node.hasLabels")
def node_has_labels(n, labels):
    if n is None or labels is None:
        return None
    if isinstance(labels, str):
        labels = [labels]  # a bare string is ONE label, not a char list
    have = set(getattr(n, "labels", []) or [])
    return all(str(l) in have for l in labels)


@register("apoc.rel.id")
def rel_id(e):
    return None if e is None else getattr(e, "id", None)


@register("apoc.rel.startNode")
def rel_start(ex, e):
    """Resolves the NODE (not its id), like the builtin startNode() and
    the reference's Storage.GetNode path (rel.go StartNode)."""
    if e is None:
        return None
    if ex is None:
        raise ValueError("apoc.rel.startNode requires executor context")
    return ex.get_node_or_none(getattr(e, "start_node", None))


rel_start.needs_executor = True


@register("apoc.rel.endNode")
def rel_end(ex, e):
    if e is None:
        return None
    if ex is None:
        raise ValueError("apoc.rel.endNode requires executor context")
    return ex.get_node_or_none(getattr(e, "end_node", None))


rel_end.needs_executor = True


@register("apoc.rel.isType")
def rel_is_type(e, rel_type):
    if e is None or rel_type is None:
        return None
    return getattr(e, "type", None) == str(rel_type)


@register("apoc.rel.isLoop")
def rel_is_loop(e):
    from nornicdb_tpu_torch.storage.types import Edge as _Edge

    if e is None:
        return None
    if not isinstance(e, _Edge):
        return None  # not a relationship: no sentinel-equality surprises
    return e.start_node == e.end_node


from nornicdb_tpu_torch.storage.types import Edge as _EdgeT  # noqa: E402
from nornicdb_tpu_torch.storage.types import Node as _NodeT  # noqa: E402


# reference registers these under apoc.util.* (apoc.go:482-484); the
# any.* spellings stay as aliases for symmetry with any.properties
@register("apoc.util.isNode")
@register("apoc.any.isNode")
def any_is_node(v):
    return isinstance(v, _NodeT)


@register("apoc.util.isRelationship")
@register("apoc.any.isRelationship")
def any_is_rel(v):
    return isinstance(v, _EdgeT)


@register("apoc.util.isPath")
@register("apoc.any.isPath")
def any_is_path(v):
    return isinstance(v, dict) and bool(v.get("__path__"))
