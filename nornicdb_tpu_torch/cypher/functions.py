"""Cypher scalar/list/string/math function registry.

Behavioral reference: upstream NornicDB pkg/cypher/fn/registry.go and the
function surface exercised by the reference's compat tests
(neo4j_compat_test.go, documentation_examples_test.go).
"""

from __future__ import annotations

import math
import random
import re
import time
import uuid
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.errors import CypherTypeError
from nornicdb_tpu_torch.storage.types import Edge, Node

FUNCTIONS: dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        FUNCTIONS[name] = fn
        return fn

    return deco


def _null_in(*args) -> bool:
    return any(a is None for a in args)


# ---------------------------------------------------------------- entity fns
@register("id")
def fn_id(x):
    if x is None:
        return None
    if isinstance(x, (Node, Edge)):
        return x.id
    raise CypherTypeError("id() expects a node or relationship")


@register("elementid")
def fn_element_id(x):
    return fn_id(x)


@register("labels")
def fn_labels(x):
    if x is None:
        return None
    if isinstance(x, Node):
        return list(x.labels)
    raise CypherTypeError("labels() expects a node")


@register("type")
def fn_type(x):
    if x is None:
        return None
    if isinstance(x, Edge):
        return x.type
    if isinstance(x, list) and x and all(isinstance(e, Edge) for e in x):
        # var-length pattern binding: r in (a)-[r*1..2]-(b) is a LIST of
        # relationships; the reference's type(r) answers with the first
        # hop's type (graph_traversal_test.go:190 requires NoError)
        return x[0].type
    raise CypherTypeError("type() expects a relationship")


@register("properties")
def fn_properties(x):
    if x is None:
        return None
    if isinstance(x, (Node, Edge)):
        return dict(x.properties)
    if isinstance(x, dict):
        return dict(x)
    raise CypherTypeError("properties() expects a node, relationship or map")


@register("keys")
def fn_keys(x):
    if x is None:
        return None
    if isinstance(x, (Node, Edge)):
        return sorted(x.properties.keys())
    if isinstance(x, dict):
        return sorted(x.keys())
    raise CypherTypeError("keys() expects a node, relationship or map")


@register("startnode")
def fn_start_node(x):
    # resolved by the executor (needs storage access); placeholder raises
    raise CypherTypeError("startNode() requires executor context")


@register("exists")
def fn_exists(x):
    return x is not None


# ---------------------------------------------------------------- scalars
@register("coalesce")
def fn_coalesce(*args):
    for a in args:
        if a is not None:
            return a
    return None


@register("size")
def fn_size(x):
    if x is None:
        return None
    if isinstance(x, (list, str, dict)):
        return len(x)
    raise CypherTypeError("size() expects a list, string or map")


@register("length")
def fn_length(x):
    if x is None:
        return None
    if isinstance(x, dict) and x.get("__path__"):
        return len(x.get("relationships", []))
    if isinstance(x, (list, str)):
        return len(x)
    raise CypherTypeError("length() expects a path, list or string")


@register("head")
def fn_head(x):
    if x is None or not isinstance(x, list) or not x:
        return None
    return x[0]


@register("last")
def fn_last(x):
    if x is None or not isinstance(x, list) or not x:
        return None
    return x[-1]


@register("tail")
def fn_tail(x):
    if x is None or not isinstance(x, list):
        return None
    return x[1:]


@register("reverse")
def fn_reverse(x):
    if x is None:
        return None
    if isinstance(x, list):
        return list(reversed(x))
    if isinstance(x, str):
        return x[::-1]
    raise CypherTypeError("reverse() expects a list or string")


@register("range")
def fn_range(start, end, step=1):
    if _null_in(start, end):
        return None
    step = int(step)
    if step == 0:
        raise CypherTypeError("range() step must not be zero")
    out = []
    i = int(start)
    end = int(end)
    if step > 0:
        while i <= end:
            out.append(i)
            i += step
    else:
        while i >= end:
            out.append(i)
            i += step
    return out


@register("randomuuid")
def fn_random_uuid():
    return str(uuid.uuid4())


@register("rand")
def fn_rand():
    return random.random()


@register("timestamp")
def fn_timestamp():
    return int(time.time() * 1000)


@register("toboolean")
def fn_to_boolean(x):
    if x is None:
        return None
    if isinstance(x, bool):
        return x
    if isinstance(x, str):
        low = x.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        return None
    if isinstance(x, int):
        return x != 0
    return None


@register("tointeger")
def fn_to_integer(x):
    if x is None:
        return None
    try:
        if isinstance(x, str):
            return int(float(x)) if ("." in x or "e" in x.lower()) else int(x)
        if isinstance(x, bool):
            return 1 if x else 0
        return int(x)
    except (ValueError, TypeError):
        return None


@register("tofloat")
def fn_to_float(x):
    if x is None:
        return None
    try:
        return float(x)
    except (ValueError, TypeError):
        return None


@register("tostring")
def fn_to_string(x):
    if x is None:
        return None
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, float) and x.is_integer():
        return f"{x:.1f}"
    return str(x)


# ---------------------------------------------------------------- strings
@register("tolower")
@register("lower")
def fn_to_lower(x):
    return None if x is None else str(x).lower()


@register("toupper")
@register("upper")
def fn_to_upper(x):
    return None if x is None else str(x).upper()


@register("trim")
def fn_trim(x):
    return None if x is None else str(x).strip()


@register("ltrim")
def fn_ltrim(x):
    return None if x is None else str(x).lstrip()


@register("rtrim")
def fn_rtrim(x):
    return None if x is None else str(x).rstrip()


@register("replace")
def fn_replace(s, search, repl):
    if _null_in(s, search, repl):
        return None
    return str(s).replace(str(search), str(repl))


@register("split")
def fn_split(s, sep):
    if _null_in(s, sep):
        return None
    return str(s).split(str(sep))


@register("substring")
def fn_substring(s, start, length=None):
    if _null_in(s, start):
        return None
    s = str(s)
    start = int(start)
    if length is None:
        return s[start:]
    return s[start : start + int(length)]


@register("left")
def fn_left(s, n):
    if _null_in(s, n):
        return None
    return str(s)[: int(n)]


@register("right")
def fn_right(s, n):
    if _null_in(s, n):
        return None
    n = int(n)
    return str(s)[-n:] if n > 0 else ""


@register("lpad")
def fn_lpad(s, length, pad=" "):
    """lpad(string, length, padString) (ref:
    functions_eval_functions.go:1229)."""
    if _null_in(s, length, pad):
        return None
    s, pad = str(s), str(pad) or " "
    need = int(length) - len(s)
    if need <= 0:
        return s
    padding = (pad * (need // len(pad) + 1))[:need]
    return padding + s


@register("rpad")
def fn_rpad(s, length, pad=" "):
    """rpad(string, length, padString) (ref:
    functions_eval_functions.go:1259)."""
    if _null_in(s, length, pad):
        return None
    s, pad = str(s), str(pad) or " "
    need = int(length) - len(s)
    if need <= 0:
        return s
    padding = (pad * (need // len(pad) + 1))[:need]
    return s + padding


@register("format")
def fn_format(template, *args):
    """format(template, ...) — printf-style %s/%d/%f/%v
    (ref: functions_eval_functions.go:1290)."""
    if template is None:
        return None
    out = []
    it = iter(args)
    i = 0
    t = str(template)
    while i < len(t):
        ch = t[i]
        if ch == "%" and i + 1 < len(t):
            spec = t[i + 1]
            if spec == "%":
                out.append("%")
                i += 2
                continue
            if spec in "sdfv":
                try:
                    v = next(it)
                except StopIteration:
                    v = None
                if spec == "d":
                    out.append(str(int(v)) if v is not None else "null")
                elif spec == "f":
                    out.append(f"{float(v):f}" if v is not None else "null")
                else:
                    out.append("null" if v is None else str(v))
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


# ---------------------------------------------------------------- math
@register("abs")
def fn_abs(x):
    return None if x is None else abs(x)


@register("sign")
def fn_sign(x):
    if x is None:
        return None
    return 0 if x == 0 else (1 if x > 0 else -1)


@register("round")
def fn_round(x, precision=0):
    if x is None:
        return None
    if precision == 0:
        return float(math.floor(x + 0.5)) if isinstance(x, float) else float(x)
    return round(float(x), int(precision))


@register("floor")
def fn_floor(x):
    return None if x is None else float(math.floor(x))


@register("ceil")
def fn_ceil(x):
    return None if x is None else float(math.ceil(x))


@register("sqrt")
def fn_sqrt(x):
    if x is None:
        return None
    return math.sqrt(x) if x >= 0 else None


@register("exp")
def fn_exp(x):
    return None if x is None else math.exp(x)


@register("log")
def fn_log(x):
    if x is None or x <= 0:
        return None
    return math.log(x)


@register("log10")
def fn_log10(x):
    if x is None or x <= 0:
        return None
    return math.log10(x)


@register("sin")
def fn_sin(x):
    return None if x is None else math.sin(x)


@register("cos")
def fn_cos(x):
    return None if x is None else math.cos(x)


@register("tan")
def fn_tan(x):
    return None if x is None else math.tan(x)


@register("atan2")
def fn_atan2(y, x):
    if _null_in(y, x):
        return None
    return math.atan2(y, x)


@register("sinh")
def fn_sinh(x):
    return None if x is None else math.sinh(x)


@register("cosh")
def fn_cosh(x):
    return None if x is None else math.cosh(x)


@register("tanh")
def fn_tanh(x):
    return None if x is None else math.tanh(x)


@register("coth")
def fn_coth(x):
    """(ref: clauses_test.go hyperbolic family; coth(0) is undefined)"""
    if x is None or x == 0:
        return None
    return math.cosh(x) / math.sinh(x)


@register("power")
def fn_power(base, exponent):
    """Alias of ^ (ref: clauses_test.go RETURN power(2, 10))."""
    if _null_in(base, exponent):
        return None
    return float(base) ** float(exponent)


@register("pi")
def fn_pi():
    return math.pi


@register("e")
def fn_e():
    return math.e


@register("toupper")
def _dup_toupper(x):  # keep registry import-stable
    return fn_to_upper(x)


# ---------------------------------------------------------------- list fns
@register("nodes")
def fn_nodes(p):
    if p is None:
        return None
    if isinstance(p, dict) and p.get("__path__"):
        return p.get("nodes", [])
    raise CypherTypeError("nodes() expects a path")


@register("relationships")
def fn_relationships(p):
    if p is None:
        return None
    if isinstance(p, dict) and p.get("__path__"):
        return p.get("relationships", [])
    raise CypherTypeError("relationships() expects a path")


@register("reduce")
def fn_reduce(*a):
    raise CypherTypeError("reduce() requires executor context")


# vector similarity (ref: vector.similarity.cosine in Neo4j 5 / NornicDB)
@register("vector.similarity.cosine")
def fn_vec_cosine(a, b):
    if _null_in(a, b):
        return None
    import numpy as np

    va = np.asarray(a, np.float32)
    vb = np.asarray(b, np.float32)
    na, nb = np.linalg.norm(va), np.linalg.norm(vb)
    if na < 1e-12 or nb < 1e-12:
        return 0.0
    return float(np.dot(va, vb) / (na * nb))


@register("vector.similarity.euclidean")
def fn_vec_euclidean(a, b):
    if _null_in(a, b):
        return None
    import numpy as np

    va = np.asarray(a, np.float32)
    vb = np.asarray(b, np.float32)
    return float(1.0 / (1.0 + np.sum((va - vb) ** 2)))


# -------------------------------------------------------------- spatial fns
# (ref: functions_eval_math.go:716-930 — point maps with x/y[/z] cartesian
# or latitude/longitude WGS84 coordinates; distance picks euclidean vs
# haversine by coordinate kind; accessors return None off-kind)
_EARTH_RADIUS_M = 6_371_000.0


def _coord(m, *names):
    if not isinstance(m, dict):
        return None
    out = []
    for n in names:
        v = m.get(n)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return None
        out.append(float(v))
    return out


@register("point")
def fn_point(m):
    if m is None:
        return None
    if not isinstance(m, dict):
        raise CypherTypeError("point() expects a map of coordinates")
    if _coord(m, "x", "y") is None and _coord(
            m, "latitude", "longitude") is None:
        raise CypherTypeError(
            "point() needs x/y or latitude/longitude coordinates")
    return dict(m)


@register("distance")
@register("point.distance")
def fn_distance(p1, p2):
    if _null_in(p1, p2):
        return None
    xy1, xy2 = _coord(p1, "x", "y"), _coord(p2, "x", "y")
    if xy1 is not None and xy2 is not None:
        dz = 0.0
        z1, z2 = _coord(p1, "z"), _coord(p2, "z")
        if z1 is not None and z2 is not None:
            dz = z1[0] - z2[0]
        return math.sqrt((xy1[0] - xy2[0]) ** 2
                         + (xy1[1] - xy2[1]) ** 2 + dz * dz)
    ll1 = _coord(p1, "latitude", "longitude")
    ll2 = _coord(p2, "latitude", "longitude")
    if ll1 is not None and ll2 is not None:
        lat1, lon1, lat2, lon2 = map(math.radians,
                                     (ll1[0], ll1[1], ll2[0], ll2[1]))
        a = (math.sin((lat2 - lat1) / 2) ** 2
             + math.cos(lat1) * math.cos(lat2)
             * math.sin((lon2 - lon1) / 2) ** 2)
        return _EARTH_RADIUS_M * 2 * math.asin(min(math.sqrt(a), 1.0))
    return None


@register("withinbbox")
@register("point.withinbbox")
def fn_within_bbox(p, lower_left, upper_right):
    coords = [_coord(m, "x", "y") for m in (p, lower_left, upper_right)]
    if all(c is not None for c in coords):
        (px, py), (llx, lly), (urx, ury) = coords
        return llx <= px <= urx and lly <= py <= ury
    coords = [_coord(m, "latitude", "longitude")
              for m in (p, lower_left, upper_right)]
    if all(c is not None for c in coords):
        (plat, plon), (lllat, lllon), (urlat, urlon) = coords
        return lllat <= plat <= urlat and lllon <= plon <= urlon
    return False


def _point_accessor(key):
    def fn(p):
        c = _coord(p, key)
        return c[0] if c is not None else None

    return fn


for _key in ("x", "y", "z", "latitude", "longitude"):
    register(f"point.{_key}")(_point_accessor(_key))


@register("point.srid")
def fn_point_srid(p):
    if not isinstance(p, dict):
        return None
    if "srid" in p:
        return p["srid"]
    return 4326 if "latitude" in p else 7203  # WGS84 vs cartesian 2D


AGGREGATES = {"count", "sum", "avg", "min", "max", "collect", "stdev",
              "stdevp", "percentilecont", "percentiledisc"}


def is_aggregate(name: str) -> bool:
    return name in AGGREGATES
