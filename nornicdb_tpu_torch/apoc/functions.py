"""APOC core function library.

Behavioral reference: upstream NornicDB apoc/ — the ~45 category subdirs
(SURVEY.md §2.1 APOC row). This module implements the high-traffic core:
coll, text, map, math, number, convert, date/temporal, hashing, json, meta,
agg, label, node, util. Graph-touching procedures (create/merge/refactor/
path/periodic) live in procedures.py.

The port's copy of ``nornicdb_tpu/apoc/functions.py``.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json as _json
import math as _math
import random
import re
import statistics
import time
import urllib.parse
import zlib
from typing import Any, Optional

from nornicdb_tpu_torch.apoc.registry import register
from nornicdb_tpu_torch.storage.types import Edge, Node


# ================================================================= coll
@register("apoc.coll.sum")
def coll_sum(xs):
    return sum(xs or [])


@register("apoc.coll.avg")
def coll_avg(xs):
    return sum(xs) / len(xs) if xs else None


@register("apoc.coll.min")
def coll_min(xs):
    return min(xs) if xs else None


@register("apoc.coll.max")
def coll_max(xs):
    return max(xs) if xs else None


@register("apoc.coll.sort")
def coll_sort(xs):
    return sorted(xs or [])


@register("apoc.coll.sortNodes")
def coll_sort_nodes(nodes, prop):
    return sorted(nodes or [], key=lambda n: (n.properties.get(prop) is None,
                                              n.properties.get(prop)))


@register("apoc.coll.reverse")
def coll_reverse(xs):
    return list(reversed(xs or []))


@register("apoc.coll.contains")
def coll_contains(xs, v):
    return v in (xs or [])


@register("apoc.coll.indexOf")
def coll_index_of(xs, v):
    try:
        return (xs or []).index(v)
    except ValueError:
        return -1


@register("apoc.coll.distinct")
@register("apoc.coll.toSet")
def coll_to_set(xs):
    out = []
    seen = set()
    for x in xs or []:
        k = _json.dumps(x, sort_keys=True, default=str)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


@register("apoc.coll.flatten")
def coll_flatten(xs):
    out = []
    for x in xs or []:
        if isinstance(x, list):
            out.extend(x)
        else:
            out.append(x)
    return out


@register("apoc.coll.pairs")
def coll_pairs(xs):
    xs = xs or []
    if not xs:
        return []
    # APOC includes the trailing [last, null] pair
    return [[xs[i], xs[i + 1] if i + 1 < len(xs) else None] for i in range(len(xs))]


@register("apoc.coll.zip")
def coll_zip(a, b):
    return [[x, y] for x, y in zip(a or [], b or [])]


@register("apoc.coll.union")
def coll_union(a, b):
    return coll_to_set((a or []) + (b or []))


@register("apoc.coll.intersection")
def coll_intersection(a, b):
    bset = {_json.dumps(x, sort_keys=True, default=str) for x in (b or [])}
    return [x for x in coll_to_set(a or [])
            if _json.dumps(x, sort_keys=True, default=str) in bset]


@register("apoc.coll.subtract")
def coll_subtract(a, b):
    bset = {_json.dumps(x, sort_keys=True, default=str) for x in (b or [])}
    return [x for x in coll_to_set(a or [])
            if _json.dumps(x, sort_keys=True, default=str) not in bset]


@register("apoc.coll.split")
def coll_split(xs, v):
    out, cur = [], []
    for x in xs or []:
        if x == v:
            out.append(cur)
            cur = []
        else:
            cur.append(x)
    out.append(cur)
    return out


@register("apoc.coll.partition")
def coll_partition(xs, size):
    xs = xs or []
    size = int(size)
    return [xs[i : i + size] for i in range(0, len(xs), size)]


@register("apoc.coll.shuffle")
def coll_shuffle(xs):
    out = list(xs or [])
    random.shuffle(out)
    return out


@register("apoc.coll.randomItem")
def coll_random_item(xs):
    return random.choice(xs) if xs else None


@register("apoc.coll.frequencies")
def coll_frequencies(xs):
    counts: dict[str, dict] = {}
    for x in xs or []:
        k = _json.dumps(x, sort_keys=True, default=str)
        if k not in counts:
            counts[k] = {"item": x, "count": 0}
        counts[k]["count"] += 1
    return list(counts.values())


@register("apoc.coll.occurrences")
def coll_occurrences(xs, v):
    return sum(1 for x in xs or [] if x == v)


@register("apoc.coll.insert")
def coll_insert(xs, idx, v):
    out = list(xs or [])
    out.insert(int(idx), v)
    return out


@register("apoc.coll.remove")
def coll_remove(xs, idx, length=1):
    out = list(xs or [])
    i = int(idx)
    del out[i : i + int(length)]
    return out


@register("apoc.coll.stdev")
def coll_stdev(xs, biased=False):
    if not xs or len(xs) < 2:
        return 0.0
    return statistics.pstdev(xs) if biased else statistics.stdev(xs)


# ================================================================= text
@register("apoc.text.join")
def text_join(xs, sep):
    return (sep or "").join(str(x) for x in (xs or []) if x is not None)


@register("apoc.text.split")
def text_split(s, regex):
    if s is None:
        return None
    return re.split(regex, s)


@register("apoc.text.replace")
def text_replace(s, regex, repl):
    if s is None:
        return None
    return re.sub(regex, repl, s)


@register("apoc.text.regexGroups")
def text_regex_groups(s, regex):
    if s is None:
        return []
    return [[m.group(0), *m.groups()] for m in re.finditer(regex, s)]


@register("apoc.text.capitalize")
def text_capitalize(s):
    return None if s is None else (s[:1].upper() + s[1:])


@register("apoc.text.decapitalize")
def text_decapitalize(s):
    return None if s is None else (s[:1].lower() + s[1:])


@register("apoc.text.upperCamelCase")
def text_upper_camel(s):
    if s is None:
        return None
    return "".join(w.capitalize() for w in re.split(r"[\s_\-]+", s))


@register("apoc.text.camelCase")
def text_camel(s):
    v = text_upper_camel(s)
    return None if v is None else (v[:1].lower() + v[1:])


@register("apoc.text.snakeCase")
def text_snake(s):
    if s is None:
        return None
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return re.sub(r"[\s_\-]+", "_", s).lower()


@register("apoc.text.random")
def text_random(length, valid="A-Za-z0-9"):
    import string

    chars = ""
    for rng in re.findall(r"(\w-\w|\w)", valid):
        if "-" in rng and len(rng) == 3:
            chars += "".join(chr(c) for c in range(ord(rng[0]), ord(rng[2]) + 1))
        else:
            chars += rng
    chars = chars or string.ascii_letters
    return "".join(random.choice(chars) for _ in range(int(length)))


@register("apoc.text.lpad")
def text_lpad(s, count, delim=" "):
    s = "" if s is None else str(s)
    return s.rjust(int(count), delim or " ")


@register("apoc.text.rpad")
def text_rpad(s, count, delim=" "):
    s = "" if s is None else str(s)
    return s.ljust(int(count), delim or " ")


@register("apoc.text.format")
def text_format(fmt, params):
    return fmt % tuple(params or [])


@register("apoc.text.slug")
def text_slug(s, delim="-"):
    if s is None:
        return None
    return re.sub(r"[^\w]+", delim, s.strip()).strip(delim).lower()


@register("apoc.text.distance")
@register("apoc.text.levenshteinDistance")
def text_levenshtein(a, b):
    if a is None or b is None:
        return None
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        curr = [i]
        for j, cb in enumerate(b, 1):
            curr.append(min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = curr
    return prev[-1]


@register("apoc.text.levenshteinSimilarity")
def text_levenshtein_sim(a, b):
    if a is None or b is None:
        return None
    if not a and not b:
        return 1.0
    return 1.0 - text_levenshtein(a, b) / max(len(a), len(b))


@register("apoc.text.indexOf")
def text_index_of(s, lookup, from_=0):
    if s is None:
        return None
    return s.find(lookup, int(from_))


@register("apoc.text.clean")
def text_clean(s):
    if s is None:
        return None
    return re.sub(r"[^a-z0-9]", "", s.lower())


@register("apoc.text.compareCleaned")
def text_compare_cleaned(a, b):
    return text_clean(a) == text_clean(b)


@register("apoc.text.urlencode")
def text_urlencode(s):
    return None if s is None else urllib.parse.quote(s, safe="")


@register("apoc.text.urldecode")
def text_urldecode(s):
    return None if s is None else urllib.parse.unquote(s)


@register("apoc.text.base64Encode")
def text_b64(s):
    import base64

    return None if s is None else base64.b64encode(s.encode()).decode()


@register("apoc.text.base64Decode")
def text_unb64(s):
    import base64

    return None if s is None else base64.b64decode(s).decode()


@register("apoc.text.charAt")
def text_char_at(s, i):
    if s is None or int(i) >= len(s):
        return None
    return ord(s[int(i)])


@register("apoc.text.code")
def text_code(i):
    return chr(int(i))


@register("apoc.text.hexValue")
def text_hex(v):
    return f"{int(v):X}"


# ================================================================= map
@register("apoc.map.fromPairs")
def map_from_pairs(pairs):
    return {str(k): v for k, v in (pairs or [])}


@register("apoc.map.fromLists")
def map_from_lists(keys, values):
    return {str(k): v for k, v in zip(keys or [], values or [])}


@register("apoc.map.merge")
def map_merge(a, b):
    out = dict(a or {})
    out.update(b or {})
    return out


@register("apoc.map.mergeList")
def map_merge_list(maps):
    out: dict = {}
    for m in maps or []:
        out.update(m or {})
    return out


@register("apoc.map.setKey")
def map_set_key(m, key, value):
    out = dict(m or {})
    out[str(key)] = value
    return out


@register("apoc.map.removeKey")
def map_remove_key(m, key):
    out = dict(m or {})
    out.pop(key, None)
    return out


@register("apoc.map.removeKeys")
def map_remove_keys(m, keys):
    out = dict(m or {})
    for k in keys or []:
        out.pop(k, None)
    return out


@register("apoc.map.clean")
def map_clean(m, keys, values):
    keys = set(keys or [])
    values = values or []
    return {
        k: v
        for k, v in (m or {}).items()
        if k not in keys and v not in values and v is not None
    }


@register("apoc.map.get")
def map_get(m, key, default=None):
    return (m or {}).get(key, default)


@register("apoc.map.submap")
def map_submap(m, keys):
    return {k: (m or {}).get(k) for k in keys or []}


@register("apoc.map.sortedProperties")
def map_sorted_props(m):
    return [[k, (m or {})[k]] for k in sorted(m or {})]


@register("apoc.map.flatten")
def map_flatten(m, delimiter="."):
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{delimiter}{k}" if prefix else str(k), v)
        else:
            out[prefix] = node

    walk("", m or {})
    return out


@register("apoc.map.groupBy")
def map_group_by(items, key):
    out = {}
    for item in items or []:
        k = item.get(key) if isinstance(item, dict) else None
        if k is not None:
            out[str(k)] = item
    return out


@register("apoc.map.groupByMulti")
def map_group_by_multi(items, key):
    out: dict = {}
    for item in items or []:
        k = item.get(key) if isinstance(item, dict) else None
        if k is not None:
            out.setdefault(str(k), []).append(item)
    return out


@register("apoc.map.values")
def map_values(m, keys=None, add_null=False):
    if keys is None:
        return list((m or {}).values())
    out = []
    for k in keys:
        v = (m or {}).get(k)
        if v is not None or add_null:
            out.append(v)
    return out


# ================================================================= math/number
@register("apoc.math.round")
def math_round(v, precision=0):
    return round(float(v), int(precision))


@register("apoc.math.maxLong")
def math_max_long():
    return 2**63 - 1


@register("apoc.math.minLong")
def math_min_long():
    return -(2**63)


@register("apoc.math.sigmoid")
def math_sigmoid(v):
    return 1.0 / (1.0 + _math.exp(-float(v)))


@register("apoc.math.tanh")
def math_tanh(v):
    return _math.tanh(float(v))


@register("apoc.math.cosh")
def math_cosh(v):
    return _math.cosh(float(v))


@register("apoc.math.sinh")
def math_sinh(v):
    return _math.sinh(float(v))


@register("apoc.number.format")
def number_format(v, pattern=None):
    if isinstance(v, float):
        return f"{v:,.2f}" if pattern is None else f"{v:,}"
    return f"{int(v):,}"


@register("apoc.number.parseInt")
def number_parse_int(s, radix=10):
    try:
        return int(str(s), int(radix))
    except (ValueError, TypeError):
        return None


@register("apoc.number.parseFloat")
def number_parse_float(s):
    try:
        return float(s)
    except (ValueError, TypeError):
        return None


# ================================================================= convert
@register("apoc.convert.toList")
def convert_to_list(v):
    if v is None:
        return []
    if isinstance(v, list):
        return v
    return [v]


@register("apoc.convert.toMap")
def convert_to_map(v):
    if isinstance(v, (Node, Edge)):
        return dict(v.properties)
    if isinstance(v, dict):
        return dict(v)
    return None


@register("apoc.convert.toString")
def convert_to_string(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


@register("apoc.convert.toInteger")
def convert_to_integer(v):
    try:
        return int(float(v)) if isinstance(v, str) else int(v)
    except (ValueError, TypeError):
        return None


@register("apoc.convert.toFloat")
def convert_to_float(v):
    try:
        return float(v)
    except (ValueError, TypeError):
        return None


@register("apoc.convert.toBoolean")
def convert_to_boolean(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.lower() in ("true", "1", "yes")
    if isinstance(v, (int, float)):
        return v != 0
    return False


@register("apoc.convert.toJson")
def convert_to_json(v):
    def default(o):
        if isinstance(o, (Node, Edge)):
            return o.to_dict()
        return str(o)

    return _json.dumps(v, default=default)


@register("apoc.convert.fromJsonMap")
def convert_from_json_map(s):
    v = _json.loads(s)
    return v if isinstance(v, dict) else None


@register("apoc.convert.fromJsonList")
def convert_from_json_list(s):
    v = _json.loads(s)
    return v if isinstance(v, list) else None


# ================================================================= date
@register("apoc.date.format")
def date_format(epoch, unit="ms", fmt="yyyy-MM-dd HH:mm:ss"):
    seconds = float(epoch) / (1000.0 if unit == "ms" else 1.0)
    py_fmt = (
        fmt.replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
        .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
    )
    return _dt.datetime.fromtimestamp(seconds, _dt.timezone.utc).strftime(py_fmt)


@register("apoc.date.parse")
def date_parse(s, unit="ms", fmt="yyyy-MM-dd HH:mm:ss"):
    py_fmt = (
        fmt.replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
        .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
    )
    dt = _dt.datetime.strptime(s, py_fmt).replace(tzinfo=_dt.timezone.utc)
    seconds = dt.timestamp()
    return int(seconds * 1000) if unit == "ms" else int(seconds)


@register("apoc.date.currentTimestamp")
def date_now():
    return int(time.time() * 1000)


@register("apoc.date.add")
def date_add(epoch, unit, value, value_unit):
    ms = {"ms": 1, "s": 1000, "m": 60000, "h": 3600000, "d": 86400000}
    delta_ms = int(value) * ms.get(value_unit, 1)
    # the addend converts into the epoch's own unit
    return int(epoch) + delta_ms // ms.get(unit, 1)


@register("apoc.date.convert")
def date_convert(v, from_unit, to_unit):
    ms = {"ms": 1, "s": 1000, "m": 60000, "h": 3600000, "d": 86400000}
    return int(int(v) * ms.get(from_unit, 1) / ms.get(to_unit, 1))


@register("apoc.temporal.format", category="temporal")
def temporal_format(epoch_ms, fmt="yyyy-MM-dd"):
    return date_format(epoch_ms, "ms", fmt)


# ================================================================= hashing
@register("apoc.hashing.md5", category="hashing")
def hash_md5(v):
    return hashlib.md5(str(v).encode()).hexdigest()


@register("apoc.hashing.sha1", category="hashing")
def hash_sha1(v):
    return hashlib.sha1(str(v).encode()).hexdigest()


@register("apoc.hashing.sha256", category="hashing")
def hash_sha256(v):
    return hashlib.sha256(str(v).encode()).hexdigest()


@register("apoc.hashing.sha512", category="hashing")
def hash_sha512(v):
    return hashlib.sha512(str(v).encode()).hexdigest()


@register("apoc.hashing.crc32", category="hashing")
def hash_crc32(v):
    return zlib.crc32(str(v).encode()) & 0xFFFFFFFF


@register("apoc.util.md5")
def util_md5(values):
    return hashlib.md5("".join(str(v) for v in values).encode()).hexdigest()


@register("apoc.util.sha1")
def util_sha1(values):
    return hashlib.sha1("".join(str(v) for v in values).encode()).hexdigest()


@register("apoc.util.validatePredicate")
def util_validate(predicate, message, params=None):
    if predicate:
        raise ValueError(message % tuple(params or []) if params else message)
    return True


# ================================================================= label/meta
@register("apoc.label.exists")
def label_exists(node, label):
    return isinstance(node, Node) and label in node.labels


@register("apoc.meta.type")
def meta_type(v):
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
        return "PATH" if v.get("__path__") else "MAP"
    return type(v).__name__.upper()


@register("apoc.meta.isType")
def meta_is_type(v, t):
    return meta_type(v) == t


# ================================================================= node/rel
@register("apoc.node.degree")
def node_degree_fn(node):
    # resolved via executor-bound variant in procedures.py when storage needed
    raise ValueError("apoc.node.degree requires executor context")


@register("apoc.rel.type")
def rel_type(rel):
    return rel.type if isinstance(rel, Edge) else None


@register("apoc.any.properties")
def any_properties(v):
    if isinstance(v, (Node, Edge)):
        return dict(v.properties)
    return v if isinstance(v, dict) else None


@register("apoc.any.property")
def any_property(v, key):
    props = any_properties(v)
    return None if props is None else props.get(key)


# ================================================================= agg
@register("apoc.agg.first", category="agg")
def agg_first(xs):
    return xs[0] if xs else None


@register("apoc.agg.last", category="agg")
def agg_last(xs):
    return xs[-1] if xs else None


@register("apoc.agg.median", category="agg")
def agg_median(xs):
    return statistics.median(xs) if xs else None


@register("apoc.agg.percentiles", category="agg")
def agg_percentiles(xs, ps=None):
    if not xs:
        return {}
    ps = ps or [0.5, 0.75, 0.9, 0.95, 0.99]
    ordered = sorted(xs)
    out = {}
    for p in ps:
        idx = max(min(int(round(p * (len(ordered) - 1))), len(ordered) - 1), 0)
        out[str(p)] = ordered[idx]
    return out


@register("apoc.agg.product", category="agg")
def agg_product(xs):
    out = 1
    for x in xs or []:
        out *= x
    return out


@register("apoc.agg.statistics", category="agg")
def agg_statistics(xs):
    if not xs:
        return {"count": 0}
    return {
        "count": len(xs),
        "sum": sum(xs),
        "min": min(xs),
        "max": max(xs),
        "mean": sum(xs) / len(xs),
        "stdev": statistics.pstdev(xs) if len(xs) > 1 else 0.0,
    }


# ================================================================= atomic
# (ref: apoc/atomic — numeric read-modify-write on properties; the executor
# passes entities by value so these operate on maps/lists functionally)
@register("apoc.atomic.add", category="atomic")
def atomic_add(m, key, value):
    out = dict(m or {})
    out[key] = (out.get(key) or 0) + value
    return out


@register("apoc.atomic.subtract", category="atomic")
def atomic_subtract(m, key, value):
    return atomic_add(m, key, -value)


@register("apoc.atomic.concat", category="atomic")
def atomic_concat(m, key, value):
    out = dict(m or {})
    out[key] = str(out.get(key) or "") + str(value)
    return out


@register("apoc.atomic.insert", category="atomic")
def atomic_insert(m, key, value):
    out = dict(m or {})
    lst = list(out.get(key) or [])
    lst.append(value)
    out[key] = lst
    return out


# ================================================================= load
@register("apoc.load.json", category="load")
def load_json(url):
    """file:// JSON loader, gated like the reference's import setting
    (requires NORNICDB_APOC_IMPORT_ENABLED=true — arbitrary local file reads
    must be an explicit operator decision, not a default; NORNICDB_IMPORT_DIR
    confines paths when set)."""
    from nornicdb_tpu_torch.config import resolve_import_url

    try:
        path = resolve_import_url(str(url))
    except PermissionError as e:
        raise ValueError(str(e)) from None
    with open(path) as f:
        return _json.load(f)


@register("apoc.load.jsonArray", category="load")
def load_json_array(url):
    v = load_json(url)
    return v if isinstance(v, list) else [v]


# ================================================================= more coll
@register("apoc.coll.duplicates")
def coll_duplicates(xs):
    seen, dups, out = set(), set(), []
    for x in xs or []:
        k = _json.dumps(x, sort_keys=True, default=str)
        if k in seen and k not in dups:
            dups.add(k)
            out.append(x)
        seen.add(k)
    return out


@register("apoc.coll.dropDuplicateNeighbors")
def coll_drop_dup_neighbors(xs):
    out = []
    for x in xs or []:
        if not out or out[-1] != x:
            out.append(x)
    return out


@register("apoc.coll.fill")
def coll_fill(item, count):
    return [item] * int(count)


@register("apoc.coll.sumLongs")
def coll_sum_longs(xs):
    return int(sum(int(x) for x in xs or []))


@register("apoc.coll.containsAll")
def coll_contains_all(xs, values):
    pool = {_json.dumps(x, sort_keys=True, default=str) for x in xs or []}
    return all(
        _json.dumps(v, sort_keys=True, default=str) in pool for v in values or []
    )


@register("apoc.coll.runningTotal")
def coll_running_total(xs):
    out, acc = [], 0
    for x in xs or []:
        acc += x
        out.append(acc)
    return out


# ================================================================= more text
@register("apoc.text.fuzzyMatch")
def text_fuzzy_match(a, b):
    if a is None or b is None:
        return None
    return text_levenshtein_sim(a.lower(), b.lower()) > 0.7


@register("apoc.text.sorensenDiceSimilarity")
def text_dice(a, b):
    if a is None or b is None:
        return None
    def bigrams(s):
        s = s.lower()
        return {s[i : i + 2] for i in range(len(s) - 1)}
    ba, bb = bigrams(a), bigrams(b)
    if not ba and not bb:
        return 1.0
    return 2 * len(ba & bb) / (len(ba) + len(bb))


@register("apoc.text.repeat")
def text_repeat(s, count):
    return None if s is None else s * int(count)


@register("apoc.text.byteCount")
def text_byte_count(s, charset="UTF-8"):
    return None if s is None else len(s.encode(charset))


@register("apoc.text.swapCase")
def text_swap_case(s):
    return None if s is None else s.swapcase()
