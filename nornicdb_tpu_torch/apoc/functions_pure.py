"""APOC pure-function gap fill: math / number / util / stats / scoring /
json / hashing / convert / date / agg / bitwise / diff / coll / temporal /
xml / spatial / text categories.

Behavioral reference: upstream NornicDB apoc/apoc.go registerAllFunctions —
names, arities and result conventions follow the example strings registered
there (e.g. `apoc.math.ceil(3.14) => 4.0` returns a float where the Java
original returns long). Implementations are original; non-obvious algorithms
(xxHash, CityHash, Double Metaphone) are clean-room from their public specs.

The port's copy of ``nornicdb_tpu/apoc/functions_pure.py``.
"""

from __future__ import annotations

import base64
import json as _json
import math
import random
import re
import time
import uuid as _uuid
import zlib

from nornicdb_tpu_torch.apoc.functions_ext import (
    _nums,
    hashing_fnv1a64,
    hashing_murmur3,
    stats_percentile,
)
from nornicdb_tpu_torch.apoc.registry import register

_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


# ============================================================== apoc.math
# (ref: apoc/math/math.go — float-returning wrappers over the stdlib)
def _math(name, fn, arity=1):
    @register(f"apoc.math.{name}")
    def f(*args):
        if any(a is None for a in args[:arity]):
            return None
        return fn(*[float(a) for a in args])

    f.__name__ = f"math_{name}"
    return f


_math("abs", abs)
_math("ceil", lambda x: float(math.ceil(x)))
_math("floor", lambda x: float(math.floor(x)))
_math("sqrt", math.sqrt)
_math("log", math.log)
_math("log10", math.log10)
_math("exp", math.exp)
_math("sin", math.sin)
_math("cos", math.cos)
_math("tan", math.tan)
_math("asin", math.asin)
_math("acos", math.acos)
_math("atan", math.atan)
_math("atan2", math.atan2, arity=2)
_math("pow", lambda a, b: float(a ** b), arity=2)


@register("apoc.math.maxDouble")
def math_max_double(*args):
    vals = _nums(args[0]) if len(args) == 1 and isinstance(args[0], list) \
        else _nums(list(args))
    return max(vals) if vals else None


@register("apoc.math.minDouble")
def math_min_double(*args):
    vals = _nums(args[0]) if len(args) == 1 and isinstance(args[0], list) \
        else _nums(list(args))
    return min(vals) if vals else None


@register("apoc.math.normalize")
def math_normalize(value, lo, hi):
    if value is None or lo is None or hi is None or hi == lo:
        return None
    return (float(value) - float(lo)) / (float(hi) - float(lo))


@register("apoc.math.random")
def math_random():
    return random.random()


@register("apoc.math.randomInt")
def math_random_int(lo, hi):
    return random.randint(int(lo), int(hi))


@register("apoc.math.percentile")
def math_percentile(xs, p):
    return stats_percentile(xs, p)


@register("apoc.math.median")
def math_median(xs):
    return stats_percentile(xs, 0.5)


@register("apoc.math.mean")
def math_mean(xs):
    v = _nums(xs)
    return sum(v) / len(v) if v else None


@register("apoc.math.stdev")
def math_stdev(xs, population=False):
    v = _nums(xs)
    if len(v) < 2:
        return 0.0
    m = sum(v) / len(v)
    var = sum((x - m) ** 2 for x in v) / (len(v) if population else len(v) - 1)
    return math.sqrt(var)


@register("apoc.math.variance")
def math_variance(xs, population=True):
    v = _nums(xs)
    if not v:
        return None
    m = sum(v) / len(v)
    n = len(v) if population or len(v) < 2 else len(v) - 1
    return sum((x - m) ** 2 for x in v) / n


@register("apoc.math.mode")
def math_mode(xs):
    if not xs:
        return None
    counts: dict = {}
    for x in xs:
        counts[x] = counts.get(x, 0) + 1
    return max(counts, key=lambda k: (counts[k],))


@register("apoc.math.range")
def math_range(lo, hi, step=1):
    step = int(step) or 1
    return list(range(int(lo), int(hi) + (1 if step > 0 else -1), step))


@register("apoc.math.sum")
def math_sum(xs):
    return sum(_nums(xs))


@register("apoc.math.product")
def math_product(xs):
    out = 1.0
    for x in _nums(xs):
        out *= x
    return out


# ============================================================ apoc.number
# (ref: apoc/number/number.go — int-preserving where the example shows ints)
@register("apoc.number.abs")
def number_abs(x):
    return None if x is None else abs(x)


@register("apoc.number.ceil")
def number_ceil(x):
    return None if x is None else math.ceil(float(x))


@register("apoc.number.floor")
def number_floor(x):
    return None if x is None else math.floor(float(x))


@register("apoc.number.round")
def number_round(x, digits=0):
    """Half-up rounding (the reference rounds 0.5 away from the floor, not
    banker's)."""
    if x is None:
        return None
    q = 10 ** int(digits)
    out = math.floor(float(x) * q + 0.5) / q
    return int(out) if not digits else out


@register("apoc.number.sign")
def number_sign(x):
    if x is None:
        return None
    return 0 if x == 0 else (1 if x > 0 else -1)


@register("apoc.number.exact")
def number_exact(x, digits=2):
    if x is None:
        return None
    q = 10 ** int(digits)
    return math.floor(float(x) * q + 0.5) / q


@register("apoc.number.parse")
def number_parse(text, pattern=None):
    """Parse '12,345.67'-style grouped decimals (ref number.go Parse)."""
    if text is None:
        return None
    s = str(text).replace(",", "").strip()
    v = float(s)
    return int(v) if v.is_integer() and "." not in s else v


@register("apoc.number.isEven")
def number_is_even(x):
    return None if x is None else int(x) % 2 == 0


@register("apoc.number.isOdd")
def number_is_odd(x):
    return None if x is None else int(x) % 2 == 1


@register("apoc.number.isPrime")
def number_is_prime(x):
    if x is None:
        return None
    n = int(x)
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


@register("apoc.number.gcd")
def number_gcd(a, b):
    return math.gcd(int(a), int(b))


@register("apoc.number.lcm")
def number_lcm(a, b):
    a, b = int(a), int(b)
    return abs(a * b) // math.gcd(a, b) if a and b else 0


@register("apoc.number.factorial")
def number_factorial(n):
    n = int(n)
    if n < 0:
        raise ValueError("factorial of negative number")
    return math.factorial(n)


@register("apoc.number.fibonacci")
def number_fibonacci(n):
    n = int(n)
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


@register("apoc.number.power")
def number_power(a, b):
    out = float(a) ** float(b)
    return int(out) if out.is_integer() else out


@register("apoc.number.sqrt")
def number_sqrt(x):
    out = math.sqrt(float(x))
    return int(out) if out.is_integer() else out


@register("apoc.number.log")
def number_log(x):
    return math.log(float(x))


@register("apoc.number.log10")
def number_log10(x):
    return math.log10(float(x))


@register("apoc.number.exp")
def number_exp(x):
    return math.exp(float(x))


@register("apoc.number.clamp")
def number_clamp(x, lo, hi):
    return max(lo, min(hi, x))


@register("apoc.number.lerp")
def number_lerp(a, b, t):
    out = float(a) + (float(b) - float(a)) * float(t)
    return int(out) if out.is_integer() else out


@register("apoc.number.normalize")
def number_normalize(x, lo, hi):
    return math_normalize(x, lo, hi)


@register("apoc.number.map")
def number_map(x, in_lo, in_hi, out_lo, out_hi):
    """Map x from [in_lo, in_hi] to [out_lo, out_hi] (ref number.go Map)."""
    if in_hi == in_lo:
        return None
    t = (float(x) - float(in_lo)) / (float(in_hi) - float(in_lo))
    out = float(out_lo) + t * (float(out_hi) - float(out_lo))
    return int(out) if out.is_integer() else out


@register("apoc.number.random")
def number_random():
    return random.random()


@register("apoc.number.randomInt")
def number_random_int(lo, hi):
    return random.randint(int(lo), int(hi))


# ============================================================== apoc.util
@register("apoc.util.uuid")
@register("apoc.util.randomUUID")
def util_uuid():
    return str(_uuid.uuid4())


@register("apoc.util.coalesce")
def util_coalesce(*args):
    for a in args:
        if a is not None:
            return a
    return None


@register("apoc.util.case")
def util_case(pairs, default=None):
    """[[cond, value], ...] -> first value whose cond is truthy."""
    for pair in pairs or []:
        if isinstance(pair, list) and len(pair) == 2 and pair[0]:
            return pair[1]
    return default


@register("apoc.util.when")
def util_when(cond, then_val, else_val=None):
    return then_val if cond else else_val


@register("apoc.util.typeOf")
def util_type_of(v):
    from nornicdb_tpu_torch.storage.types import Edge, Node

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "FLOAT"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "LIST"
    if isinstance(v, Node):
        return "NODE"
    if isinstance(v, Edge):
        return "RELATIONSHIP"
    if isinstance(v, dict):
        return "MAP"
    return type(v).__name__.upper()


@register("apoc.util.merge")
def util_merge(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        return {**a, **b}
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    return b if b is not None else a


def _digest(algo, s):
    import hashlib

    h = hashlib.new(algo)
    h.update(str(s).encode("utf-8"))
    return h


@register("apoc.util.sha256")
@register("apoc.util.sha256Hex")
def util_sha256(s):
    return _digest("sha256", s).hexdigest()


@register("apoc.util.sha1Hex")
def util_sha1_hex(s):
    return _digest("sha1", s).hexdigest()


@register("apoc.util.md5Hex")
def util_md5_hex(s):
    return _digest("md5", s).hexdigest()


@register("apoc.util.sha256Base64")
def util_sha256_b64(s):
    return base64.b64encode(_digest("sha256", s).digest()).decode()


@register("apoc.util.sha1Base64")
def util_sha1_b64(s):
    return base64.b64encode(_digest("sha1", s).digest()).decode()


@register("apoc.util.md5Base64")
def util_md5_b64(s):
    return base64.b64encode(_digest("md5", s).digest()).decode()


@register("apoc.util.validatePattern")
def util_validate_pattern(value, pattern):
    if value is None or pattern is None:
        return None
    # bounded engine: user-supplied patterns must not wedge the query
    # thread via catastrophic backtracking (same guarantee as Cypher =~)
    from nornicdb_tpu_torch.cypher.expr import regex_fullmatch

    return regex_fullmatch(str(pattern), str(value))


@register("apoc.util.repeat")
def util_repeat(value, times):
    times = int(times)
    if isinstance(value, str):
        return value * times
    return [value] * times


@register("apoc.util.range")
def util_range(lo, hi, step=1):
    return math_range(lo, hi, step)


@register("apoc.util.partition")
def util_partition(xs, size):
    size = int(size)
    if size <= 0:
        return []
    return [xs[i:i + size] for i in range(0, len(xs or []), size)]


@register("apoc.util.compressWithAlgorithm")
def util_compress_algo(data, algo="gzip"):
    """Returns base64 of the compressed bytes (transport-safe value form)."""
    raw = str(data).encode("utf-8")
    algo = str(algo).lower()
    if algo == "gzip":
        import gzip

        out = gzip.compress(raw)
    elif algo in ("deflate", "zlib"):
        out = zlib.compress(raw)
    else:
        raise ValueError(f"unsupported compression algorithm {algo!r}")
    return base64.b64encode(out).decode()


@register("apoc.util.decompressWithAlgorithm")
def util_decompress_algo(data, algo="gzip"):
    raw = base64.b64decode(str(data))
    algo = str(algo).lower()
    if algo == "gzip":
        import gzip

        return gzip.decompress(raw).decode("utf-8")
    if algo in ("deflate", "zlib"):
        return zlib.decompress(raw).decode("utf-8")
    raise ValueError(f"unsupported compression algorithm {algo!r}")


@register("apoc.util.now")
@register("apoc.util.timestamp")
def util_now():
    return int(time.time() * 1000)


@register("apoc.util.nowInSeconds")
def util_now_seconds():
    return int(time.time())


@register("apoc.util.parseTimestamp")
def util_parse_timestamp(s, fmt=None):
    """ISO-8601 (or epoch-millis string) -> epoch millis."""
    if s is None:
        return None
    s = str(s)
    if s.isdigit():
        return int(s)
    from datetime import datetime, timezone

    dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1000)


@register("apoc.util.formatTimestamp")
def util_format_timestamp(ts, fmt="iso"):
    if ts is None:
        return None
    from datetime import datetime, timezone

    dt = datetime.fromtimestamp(int(ts) / 1000.0, tz=timezone.utc)
    if fmt in ("iso", None):
        return dt.isoformat().replace("+00:00", "Z")
    # java-style subset: yyyy MM dd HH mm ss
    out = (str(fmt).replace("yyyy", "%Y").replace("MM", "%m")
           .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
           .replace("ss", "%S"))
    return dt.strftime(out)


# ============================================================= apoc.stats
@register("apoc.stats.min")
def stats_min(xs):
    v = _nums(xs)
    return min(v) if v else None


@register("apoc.stats.max")
def stats_max(xs):
    v = _nums(xs)
    return max(v) if v else None


@register("apoc.stats.sum")
def stats_sum(xs):
    return sum(_nums(xs))


@register("apoc.stats.count")
def stats_count(xs):
    return len(xs or [])


@register("apoc.stats.range")
def stats_range(xs):
    v = _nums(xs)
    return (max(v) - min(v)) if v else None


@register("apoc.stats.stdDev")
def stats_stddev(xs, population=False):
    return math_stdev(xs, population)


@register("apoc.stats.degrees")
def stats_degrees(degree_list):
    """Summary stats over a degree list: {min,max,mean,total} (ref
    stats.go Degrees shape)."""
    v = _nums(degree_list)
    if not v:
        return {"min": 0, "max": 0, "mean": 0.0, "total": 0}
    return {"min": min(v), "max": max(v), "mean": sum(v) / len(v),
            "total": sum(v)}


# =========================================================== apoc.scoring
@register("apoc.scoring.tf")
def scoring_tf(term, doc):
    """Term frequency: occurrences / doc length (whitespace tokens)."""
    words = str(doc).lower().split()
    if not words:
        return 0.0
    return words.count(str(term).lower()) / len(words)


@register("apoc.scoring.idf")
def scoring_idf(term, docs):
    t = str(term).lower()
    n = len(docs or [])
    if not n:
        return 0.0
    df = sum(1 for d in docs if t in str(d).lower().split())
    return math.log((n + 1) / (df + 1)) + 1.0


@register("apoc.scoring.bm25")
def scoring_bm25(term, doc, docs, k1=1.2, b=0.75):
    tf_count = str(doc).lower().split().count(str(term).lower())
    dl = len(str(doc).split())
    avgdl = (sum(len(str(d).split()) for d in docs) / len(docs)) if docs else 1
    idf = scoring_idf(term, docs)
    denom = tf_count + k1 * (1 - b + b * dl / max(avgdl, 1e-9))
    return idf * (tf_count * (k1 + 1)) / max(denom, 1e-9)


@register("apoc.scoring.normalize")
def scoring_normalize(scores):
    v = _nums(scores)
    if not v:
        return []
    lo, hi = min(v), max(v)
    if hi == lo:
        return [0.0 for _ in v]
    return [(x - lo) / (hi - lo) for x in v]


@register("apoc.scoring.percentile")
def scoring_percentile(scores, p):
    return stats_percentile(scores, p)


@register("apoc.scoring.zScore")
def scoring_zscore(value, values):
    v = _nums(values)
    if len(v) < 2:
        return 0.0
    m = sum(v) / len(v)
    sd = math.sqrt(sum((x - m) ** 2 for x in v) / (len(v) - 1))
    return (float(value) - m) / sd if sd else 0.0


@register("apoc.scoring.pageRank")
def scoring_pagerank(node_ids, edges, damping=0.85, iters=20):
    """PageRank over explicit (src, dst) pairs (value-level twin of the
    gds.pageRank procedure; ref scoring.go PageRank)."""
    ids = list(node_ids or [])
    if not ids:
        return {}
    out_deg: dict = {i: 0 for i in ids}
    incoming: dict = {i: [] for i in ids}
    for e in edges or []:
        s, d = (e[0], e[1]) if isinstance(e, list) else (e["start"], e["end"])
        if s in out_deg and d in incoming:
            out_deg[s] += 1
            incoming[d].append(s)
    n = len(ids)
    rank = {i: 1.0 / n for i in ids}
    for _ in range(int(iters)):
        new = {}
        sink = sum(rank[i] for i in ids if out_deg[i] == 0)
        for i in ids:
            s = sum(rank[j] / out_deg[j] for j in incoming[i])
            new[i] = (1 - damping) / n + damping * (s + sink / n)
        rank = new
    return rank


# ============================================================== apoc.json
@register("apoc.json.values")
def json_values(j):
    obj = _json.loads(j) if isinstance(j, str) else j
    if isinstance(obj, dict):
        return list(obj.values())
    if isinstance(obj, list):
        return obj
    return [obj]


@register("apoc.json.type")
def json_type(v):
    if isinstance(v, str):
        try:
            v = _json.loads(v)
        except (ValueError, TypeError):
            return "string"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    return "object"


@register("apoc.json.unflatten")
def json_unflatten(flat):
    """{'a.b': 1} -> {'a': {'b': 1}} (inverse of apoc.json.flatten)."""
    out: dict = {}
    for k, v in (flat or {}).items():
        parts = str(k).split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


@register("apoc.json.filter")
def json_filter(j, keys):
    """Keep only the listed top-level keys."""
    obj = _json.loads(j) if isinstance(j, str) else j
    keep = set(keys or [])
    if isinstance(obj, dict):
        return {k: v for k, v in obj.items() if k in keep}
    return obj


@register("apoc.json.map")
def json_map(j, mapping):
    """Rename top-level keys via {'old': 'new'}."""
    obj = _json.loads(j) if isinstance(j, str) else j
    if not isinstance(obj, dict):
        return obj
    m = mapping or {}
    return {m.get(k, k): v for k, v in obj.items()}


@register("apoc.json.reduce")
def json_reduce(j, op="sum", init=0):
    """Reduce numeric leaf values: sum/min/max/count."""
    obj = _json.loads(j) if isinstance(j, str) else j

    def leaves(o):
        if isinstance(o, dict):
            for v in o.values():
                yield from leaves(v)
        elif isinstance(o, list):
            for v in o:
                yield from leaves(v)
        elif isinstance(o, (int, float)) and not isinstance(o, bool):
            yield o

    vals = list(leaves(obj))
    if op == "count":
        return len(vals)
    if op == "min":
        return min(vals) if vals else init
    if op == "max":
        return max(vals) if vals else init
    return sum(vals, init if isinstance(init, (int, float)) else 0)


# =========================================================== apoc.hashing
@register("apoc.hashing.sha384")
def hashing_sha384(s):
    return _digest("sha384", s).hexdigest()


@register("apoc.hashing.fnv1")
def hashing_fnv1(s):
    """FNV-1 (multiply-then-xor) 32-bit."""
    h = 0x811C9DC5
    for b in str(s).encode("utf-8"):
        h = (h * 0x01000193) & _U32
        h ^= b
    return h


@register("apoc.hashing.fnv164")
def hashing_fnv164(s):
    h = 0xCBF29CE484222325
    for b in str(s).encode("utf-8"):
        h = (h * 0x100000001B3) & _U64
        h ^= b
    return h


@register("apoc.hashing.murmurHash3")
def hashing_murmurhash3(s, seed=0):
    return hashing_murmur3(s, seed)


def _xx_rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _U32


@register("apoc.hashing.xxHash32")
def hashing_xxhash32(s, seed=0):
    """xxHash32, clean-room from the public spec."""
    data = str(s).encode("utf-8")
    seed = int(seed) & _U32
    p1, p2, p3, p4, p5 = (2654435761, 2246822519, 3266489917,
                          668265263, 374761393)
    n = len(data)
    i = 0
    if n >= 16:
        acc = [(seed + p1 + p2) & _U32, (seed + p2) & _U32, seed,
               (seed - p1) & _U32]
        while i <= n - 16:
            for vi in range(4):
                lane = int.from_bytes(data[i:i + 4], "little")
                acc[vi] = (
                    _xx_rotl32((acc[vi] + lane * p2) & _U32, 13) * p1
                ) & _U32
                i += 4
        h = (_xx_rotl32(acc[0], 1) + _xx_rotl32(acc[1], 7)
             + _xx_rotl32(acc[2], 12) + _xx_rotl32(acc[3], 18)) & _U32
    else:
        h = (seed + p5) & _U32
    h = (h + n) & _U32
    while i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        h = (_xx_rotl32((h + lane * p3) & _U32, 17) * p4) & _U32
        i += 4
    while i < n:
        h = (_xx_rotl32((h + data[i] * p5) & _U32, 11) * p1) & _U32
        i += 1
    h ^= h >> 15
    h = (h * p2) & _U32
    h ^= h >> 13
    h = (h * p3) & _U32
    h ^= h >> 16
    return h


def _xx_rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _U64


@register("apoc.hashing.xxHash64")
def hashing_xxhash64(s, seed=0):
    """xxHash64, clean-room from the public spec."""
    data = str(s).encode("utf-8")
    seed = int(seed) & _U64
    p1, p2, p3, p4, p5 = (11400714785074694791, 14029467366897019727,
                          1609587929392839161, 9650029242287828579,
                          2870177450012600261)

    def rnd(acc, lane):
        return (_xx_rotl64((acc + lane * p2) & _U64, 31) * p1) & _U64

    def merge(acc, v):
        return ((acc ^ rnd(0, v)) * p1 + p4) & _U64

    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + p1 + p2) & _U64
        v2 = (seed + p2) & _U64
        v3 = seed
        v4 = (seed - p1) & _U64
        while i <= n - 32:
            v1 = rnd(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = rnd(v2, int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = rnd(v3, int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = rnd(v4, int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        h = (_xx_rotl64(v1, 1) + _xx_rotl64(v2, 7)
             + _xx_rotl64(v3, 12) + _xx_rotl64(v4, 18)) & _U64
        h = merge(h, v1)
        h = merge(h, v2)
        h = merge(h, v3)
        h = merge(h, v4)
    else:
        h = (seed + p5) & _U64
    h = (h + n) & _U64
    while i <= n - 8:
        h = ((_xx_rotl64(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")),
                         27) * p1) + p4) & _U64
        i += 8
    if i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        h = ((_xx_rotl64(h ^ ((lane * p1) & _U64), 23) * p2) + p3) & _U64
        i += 4
    while i < n:
        h = (_xx_rotl64(h ^ ((data[i] * p5) & _U64), 11) * p1) & _U64
        i += 1
    h ^= h >> 33
    h = (h * p2) & _U64
    h ^= h >> 29
    h = (h * p3) & _U64
    h ^= h >> 32
    return h


@register("apoc.hashing.cityHash64")
def hashing_cityhash64(s):
    """64-bit string hash in the CityHash role. The reference's internal
    cityHash64 is likewise a reduced variant (hashing.go:145); this uses the
    xxHash64 core with a distinct seed, documented as not bit-identical to
    Google CityHash."""
    return hashing_xxhash64(s, seed=0x9AE16A3B2F90404F)


@register("apoc.hashing.rendezvousHash")
def hashing_rendezvous(key, nodes):
    """Highest-random-weight node pick (ref hashing.go:205)."""
    if not nodes:
        return ""
    best, best_h = nodes[0], -1
    for node in nodes:
        h = hashing_fnv1a64(f"{key}{node}")
        if h > best_h:
            best, best_h = node, h
    return best


@register("apoc.hashing.fingerprintGraph")
def hashing_fingerprint_graph(nodes, rels):
    """SHA256 over the canonical repr of nodes+rels (ref hashing.go:185)."""
    from nornicdb_tpu_torch.apoc.functions_ext import _props_of

    def canon(x):
        try:
            return _json.dumps(_props_of(x), sort_keys=True, default=str)
        except (TypeError, ValueError):
            return repr(x)

    payload = ("|".join(sorted(canon(n) for n in (nodes or [])))
               + "||" + "|".join(sorted(canon(r) for r in (rels or []))))
    return _digest("sha256", payload).hexdigest()


# ============================================================== apoc.coll
@register("apoc.coll.containsDuplicates")
def coll_contains_duplicates(xs):
    seen = []
    for x in xs or []:
        if x in seen:
            return True
        seen.append(x)
    return False


@register("apoc.coll.randomItem")
def coll_random_item(xs):
    return random.choice(xs) if xs else None


@register("apoc.coll.randomItems")
def coll_random_items(xs, n, allow_repeats=False):
    if not xs:
        return []
    n = int(n)
    if allow_repeats:
        return [random.choice(xs) for _ in range(n)]
    return random.sample(list(xs), min(n, len(xs)))


# =========================================================== apoc.bitwise
@register("apoc.bitwise.reverseBits")
def bitwise_reverse_bits(value, width=64):
    v = int(value) & ((1 << int(width)) - 1)
    out = 0
    for _ in range(int(width)):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


@register("apoc.bitwise.rotateLeft")
def bitwise_rotate_left(value, shift, width=64):
    width = int(width)
    mask = (1 << width) - 1
    v = int(value) & mask
    s = int(shift) % width
    return ((v << s) | (v >> (width - s))) & mask


@register("apoc.bitwise.rotateRight")
def bitwise_rotate_right(value, shift, width=64):
    width = int(width)
    s = int(shift) % width
    return bitwise_rotate_left(value, width - s, width)


# ============================================================== apoc.diff
@register("apoc.diff.deep")
def diff_deep(a, b):
    """Recursive diff of nested maps: {added, removed, changed} with dotted
    paths."""
    out = {"added": {}, "removed": {}, "changed": {}}

    def walk(x, y, prefix):
        xk = set(x.keys()) if isinstance(x, dict) else set()
        yk = set(y.keys()) if isinstance(y, dict) else set()
        for k in yk - xk:
            out["added"][f"{prefix}{k}"] = y[k]
        for k in xk - yk:
            out["removed"][f"{prefix}{k}"] = x[k]
        for k in xk & yk:
            if isinstance(x[k], dict) and isinstance(y[k], dict):
                walk(x[k], y[k], f"{prefix}{k}.")
            elif x[k] != y[k]:
                out["changed"][f"{prefix}{k}"] = {"left": x[k], "right": y[k]}

    walk(a or {}, b or {}, "")
    return out


@register("apoc.diff.patch")
def diff_patch(obj, diff):
    """Apply a diff.deep result: right-side wins."""
    out = _json.loads(_json.dumps(obj or {}))  # deep copy of plain data

    def set_path(d, path, value):
        parts = path.split(".")
        cur = d
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value

    def del_path(d, path):
        parts = path.split(".")
        cur = d
        for p in parts[:-1]:
            if not isinstance(cur, dict) or p not in cur:
                return
            cur = cur[p]
        if isinstance(cur, dict):
            cur.pop(parts[-1], None)

    for path, v in (diff or {}).get("added", {}).items():
        set_path(out, path, v)
    for path in (diff or {}).get("removed", {}):
        del_path(out, path)
    for path, ch in (diff or {}).get("changed", {}).items():
        set_path(out, path, ch.get("right") if isinstance(ch, dict) else ch)
    return out


@register("apoc.diff.merge")
def diff_merge(d1, d2):
    """Combine two diffs; the second wins on conflicts."""
    out = {"added": {}, "removed": {}, "changed": {}}
    for d in (d1 or {}), (d2 or {}):
        for k in out:
            out[k].update(d.get(k, {}))
    return out


@register("apoc.diff.summary")
def diff_summary(diff):
    d = diff or {}
    return {
        "added": len(d.get("added", {})),
        "removed": len(d.get("removed", {})),
        "changed": len(d.get("changed", {})),
    }


# =============================================================== apoc.agg
@register("apoc.agg.percentile")
def agg_percentile(xs, p=0.5):
    return stats_percentile(xs, p)


@register("apoc.agg.stdev")
def agg_stdev(xs):
    return math_stdev(xs)


@register("apoc.agg.histogram")
def agg_histogram(xs):
    out: dict = {}
    for x in xs or []:
        k = str(x)
        out[k] = out.get(k, 0) + 1
    return out


@register("apoc.agg.graph")
def agg_graph(nodes, rels):
    return {"nodes": list(nodes or []), "relationships": list(rels or [])}
