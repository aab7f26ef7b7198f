"""APOC final gap-fill: temporal / xml / spatial / convert / date / text /
meta / schema / import function forms completing the reference's registry
inventory (ref: upstream NornicDB apoc/apoc.go registerAllFunctions).

Temporal values use the framework's field-map convention
(cypher/temporal_fns.py: __temporal__/iso/epochMillis; durations carry
milliseconds) so results compose with the Cypher temporal accessors.

The port's copy of ``nornicdb_tpu/apoc/functions_tail.py``.
"""

from __future__ import annotations

import datetime as _dt
import json as _json
import math
import re
import xml.etree.ElementTree as _ET
from typing import Any

from nornicdb_tpu_torch.apoc.functions_ext import _latlon, _xml_to_map
from nornicdb_tpu_torch.apoc.functions_graph import _graph_fn
from nornicdb_tpu_torch.apoc.registry import register
from nornicdb_tpu_torch.errors import NornicError
from nornicdb_tpu_torch.storage.types import Edge, Node


def _temporal():
    """Lazy: cypher/__init__ imports apoc, so this module must not import
    cypher at module load."""
    from nornicdb_tpu_torch.cypher.temporal_fns import (
        _datetime_map,
        _parse_input,
        fn_duration,
    )

    return _datetime_map, _parse_input, fn_duration

# ========================================================== apoc.temporal


@register("apoc.temporal.parse")
def temporal_parse(value, fmt=None):
    """ISO-8601 (or java-style subset format) -> datetime map."""
    if value is None:
        return None
    if fmt and not str(fmt).lower().startswith("iso"):
        py = (str(fmt).replace("yyyy", "%Y").replace("MM", "%m")
              .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
              .replace("ss", "%S"))
        dt = _dt.datetime.strptime(str(value), py)
        dm, _, _ = _temporal()
        return dm(dt.replace(tzinfo=_dt.timezone.utc))
    dm, pi, _ = _temporal()
    return dm(pi(value))


@register("apoc.temporal.toEpochMillis")
def temporal_to_epoch(value):
    _, pi, _ = _temporal()
    return int(pi(value).timestamp() * 1000) if value is not None else None


@register("apoc.temporal.fromEpochMillis")
def temporal_from_epoch(ms):
    if ms is None:
        return None
    dm, _, _ = _temporal()
    return dm(_dt.datetime.fromtimestamp(int(ms) / 1000.0, _dt.timezone.utc))


@register("apoc.temporal.duration")
def temporal_duration(value):
    _, _, fd = _temporal()
    return fd(value)


@register("apoc.temporal.formatDuration")
def temporal_format_duration(duration):
    if duration is None:
        return None
    if isinstance(duration, dict) and "iso" in duration:
        return duration["iso"]
    _, _, fd = _temporal()
    return fd(duration)["iso"]


def _dur_ms(duration) -> int:
    if isinstance(duration, dict) and "milliseconds" in duration:
        return int(duration["milliseconds"])
    if isinstance(duration, (int, float)):
        return int(duration)
    _, _, fd = _temporal()
    return int(fd(duration)["milliseconds"])


@register("apoc.temporal.add")
def temporal_add(value, duration):
    dm, pi, _ = _temporal()
    dt = pi(value)
    return dm(dt + _dt.timedelta(milliseconds=_dur_ms(duration)))


@register("apoc.temporal.subtract")
def temporal_subtract(value, duration):
    dm, pi, _ = _temporal()
    dt = pi(value)
    return dm(dt - _dt.timedelta(milliseconds=_dur_ms(duration)))


@register("apoc.temporal.isBetween")
def temporal_is_between(value, start, end):
    _, pi, _ = _temporal()
    t = pi(value)
    return pi(start) <= t <= pi(end)


@register("apoc.temporal.dayOfWeek")
def temporal_day_of_week(value):
    return _temporal()[1](value).isoweekday()


@register("apoc.temporal.dayOfYear")
def temporal_day_of_year(value):
    return _temporal()[1](value).timetuple().tm_yday


@register("apoc.temporal.weekOfYear")
def temporal_week_of_year(value):
    return _temporal()[1](value).isocalendar()[1]


@register("apoc.temporal.timezone")
def temporal_timezone(value):
    if isinstance(value, dict) and "timezone" in value:
        return value["timezone"]
    return str(_temporal()[1](value).tzinfo or "UTC")


@register("apoc.temporal.toUTC")
def temporal_to_utc(value):
    dm, pi, _ = _temporal()
    return dm(pi(value).astimezone(_dt.timezone.utc))


@register("apoc.temporal.toLocal")
def temporal_to_local(value, offset_minutes=0):
    dm, pi, _ = _temporal()
    tz = _dt.timezone(_dt.timedelta(minutes=int(offset_minutes)))
    return dm(pi(value).astimezone(tz))


_TRUNC_UNITS = ("year", "month", "day", "hour", "minute", "second")


@register("apoc.temporal.truncate")
def temporal_truncate(value, unit="day"):
    dm, pi, _ = _temporal()
    dt = pi(value)
    u = str(unit).lower()
    if u not in _TRUNC_UNITS and u != "week":
        raise NornicError(f"unknown truncation unit {unit!r}")
    if u == "week":
        start = dt - _dt.timedelta(days=dt.isoweekday() - 1)
        return temporal_truncate(start, "day")
    repl = {}
    for candidate, zero in (("month", 1), ("day", 1), ("hour", 0),
                            ("minute", 0), ("second", 0)):
        if _TRUNC_UNITS.index(u) < _TRUNC_UNITS.index(candidate):
            repl[candidate] = zero
    return dm(dt.replace(microsecond=0, **repl))


@register("apoc.temporal.round")
def temporal_round(value, unit="hour"):
    dm, pi, _ = _temporal()
    dt = pi(value)
    u = str(unit).lower()
    step = {"second": 1, "minute": 60, "hour": 3600, "day": 86400}.get(u)
    if step is None:
        raise NornicError(f"unknown rounding unit {unit!r}")
    ts = dt.timestamp()
    return dm(_dt.datetime.fromtimestamp(
        round(ts / step) * step, _dt.timezone.utc))


# =============================================================== apoc.xml
def _xml_from_value(v) -> _ET.Element:
    """Accept a map form ({_type, attrs, _text, _children}) or an XML
    string."""
    if isinstance(v, str):
        return _ET.fromstring(v)
    if isinstance(v, dict):
        el = _ET.Element(str(v.get("_type", "node")))
        for k, val in v.items():
            if k in ("_type", "_text", "_children"):
                continue
            el.set(k, str(val))
        if v.get("_text"):
            el.text = str(v["_text"])
        for child in v.get("_children", []):
            el.append(_xml_from_value(child))
        return el
    raise NornicError("expected an XML string or map")


@register("apoc.xml.toMap")
def xml_to_map(doc):
    return _xml_to_map(_xml_from_value(doc))


@register("apoc.xml.fromMap")
@register("apoc.xml.toString")
def xml_to_string(doc):
    return _ET.tostring(_xml_from_value(doc), encoding="unicode")


@register("apoc.xml.create")
def xml_create(name, attrs=None, text=None):
    out: dict = {"_type": str(name)}
    out.update({k: v for k, v in (attrs or {}).items()})
    if text is not None:
        out["_text"] = str(text)
    return out


@register("apoc.xml.clone")
def xml_clone(node):
    return _json.loads(_json.dumps(xml_to_map(node)))


@register("apoc.xml.setAttribute")
def xml_set_attribute(node, attr, value):
    out = xml_clone(node)
    out[str(attr)] = value
    return out


@register("apoc.xml.setText")
def xml_set_text(node, text):
    out = xml_clone(node)
    out["_text"] = str(text)
    return out


@register("apoc.xml.addChild")
def xml_add_child(parent, child):
    out = xml_clone(parent)
    out.setdefault("_children", []).append(xml_to_map(child))
    return out


@register("apoc.xml.removeChild")
def xml_remove_child(parent, child_type):
    out = xml_clone(parent)
    out["_children"] = [c for c in out.get("_children", [])
                        if c.get("_type") != str(child_type)]
    return out


@register("apoc.xml.query")
def xml_query(doc, path):
    """ElementTree XPath subset query -> list of matched maps."""
    el = _xml_from_value(doc)
    return [_xml_to_map(m) for m in el.findall(str(path))]


@register("apoc.xml.namespace")
@register("apoc.xml.getNamespace")
def xml_namespace(node):
    tag = str((node or {}).get("_type") if isinstance(node, dict)
              else _xml_from_value(node).tag)
    m = re.match(r"\{([^}]+)\}", tag)
    return m.group(1) if m else None


@register("apoc.xml.prettify")
def xml_prettify(doc):
    el = _xml_from_value(doc)
    _ET.indent(el)
    return _ET.tostring(el, encoding="unicode")


@register("apoc.xml.minify")
def xml_minify(doc):
    s = xml_to_string(doc) if not isinstance(doc, str) else doc
    return re.sub(r">\s+<", "><", str(s).strip())


@register("apoc.xml.fromJson")
def xml_from_json(j):
    """JSON object -> XML map (keys become child elements)."""
    obj = _json.loads(j) if isinstance(j, str) else j

    def build(name, v):
        if isinstance(v, dict):
            return {"_type": str(name),
                    "_children": [build(k, c) for k, c in v.items()]}
        if isinstance(v, list):
            return {"_type": str(name),
                    "_children": [build("item", c) for c in v]}
        return {"_type": str(name), "_text": "" if v is None else str(v)}

    return build("root", obj)


@register("apoc.xml.transform")
def xml_transform(doc, mapping):
    """Rename element types via {'old': 'new'} (lightweight stand-in for
    the reference's XSLT placeholder, xml.go Transform)."""
    m = mapping or {}

    def walk(node):
        out = dict(node)
        out["_type"] = m.get(out.get("_type"), out.get("_type"))
        if "_children" in out:
            out["_children"] = [walk(c) for c in out["_children"]]
        return out

    return walk(xml_to_map(doc))


# =========================================================== apoc.spatial
@register("apoc.spatial.haversineDistance")
def spatial_haversine(lat1, lon1, lat2, lon2):
    from nornicdb_tpu_torch.apoc.functions_ext import _EARTH_R_M

    p1, l1 = math.radians(float(lat1)), math.radians(float(lon1))
    p2, l2 = math.radians(float(lat2)), math.radians(float(lon2))
    a = (math.sin((p2 - p1) / 2) ** 2
         + math.cos(p1) * math.cos(p2) * math.sin((l2 - l1) / 2) ** 2)
    return 2 * _EARTH_R_M * math.asin(math.sqrt(a))


@register("apoc.spatial.vincentyDistance")
def spatial_vincenty(lat1, lon1, lat2, lon2):
    """Vincenty inverse on the WGS-84 ellipsoid (meters)."""
    a, f = 6378137.0, 1 / 298.257223563
    b = (1 - f) * a
    L = math.radians(float(lon2) - float(lon1))
    u1 = math.atan((1 - f) * math.tan(math.radians(float(lat1))))
    u2 = math.atan((1 - f) * math.tan(math.radians(float(lat2))))
    su1, cu1 = math.sin(u1), math.cos(u1)
    su2, cu2 = math.sin(u2), math.cos(u2)
    lam = L
    for _ in range(100):
        sl, cl = math.sin(lam), math.cos(lam)
        ss = math.sqrt((cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2)
        if ss == 0:
            return 0.0
        cs = su1 * su2 + cu1 * cu2 * cl
        sig = math.atan2(ss, cs)
        sa = cu1 * cu2 * sl / ss
        c2a = 1 - sa ** 2
        c2m = cs - 2 * su1 * su2 / c2a if c2a else 0.0
        C = f / 16 * c2a * (4 + f * (4 - 3 * c2a))
        lam_prev = lam
        lam = L + (1 - C) * f * sa * (
            sig + C * ss * (c2m + C * cs * (-1 + 2 * c2m ** 2)))
        if abs(lam - lam_prev) < 1e-12:
            break
    u2_ = c2a * (a ** 2 - b ** 2) / (b ** 2)
    A = 1 + u2_ / 16384 * (4096 + u2_ * (-768 + u2_ * (320 - 175 * u2_)))
    B = u2_ / 1024 * (256 + u2_ * (-128 + u2_ * (74 - 47 * u2_)))
    dsig = B * ss * (c2m + B / 4 * (cs * (-1 + 2 * c2m ** 2)
                                    - B / 6 * c2m * (-3 + 4 * ss ** 2)
                                    * (-3 + 4 * c2m ** 2)))
    return b * A * (sig - dsig)


@register("apoc.spatial.area")
def spatial_area(polygon):
    """Spherical excess area of a lat/lon polygon (m^2, shoelace on the
    equirectangular projection — adequate for small polygons)."""
    from nornicdb_tpu_torch.apoc.functions_ext import _EARTH_R_M

    pts = [_latlon(p) for p in (polygon or [])]
    if len(pts) < 3:
        return 0.0
    lat0 = sum(p[0] for p in pts) / len(pts)
    scale = math.cos(math.radians(lat0))
    xy = [(math.radians(lon) * scale * _EARTH_R_M,
           math.radians(lat) * _EARTH_R_M) for lat, lon in pts]
    s = 0.0
    for (x1, y1), (x2, y2) in zip(xy, xy[1:] + xy[:1]):
        s += x1 * y2 - x2 * y1
    return abs(s) / 2.0


@register("apoc.spatial.nearest")
def spatial_nearest(point, points):
    lat, lon = _latlon(point)
    best, best_d = None, None
    for p in points or []:
        la, lo = _latlon(p)
        d = spatial_haversine(lat, lon, la, lo)
        if best_d is None or d < best_d:
            best, best_d = p, d
    return best


@register("apoc.spatial.kNearest")
def spatial_k_nearest(point, points, k):
    lat, lon = _latlon(point)
    scored = sorted(
        (points or []),
        key=lambda p: spatial_haversine(lat, lon, *_latlon(p)),
    )
    return scored[: int(k)]


def _bbox(geom):
    pts = [_latlon(p) for p in (geom if isinstance(geom, list) else [geom])]
    lats = [p[0] for p in pts]
    lons = [p[1] for p in pts]
    return min(lats), min(lons), max(lats), max(lons)


@register("apoc.spatial.intersects")
def spatial_intersects(g1, g2):
    """Bounding-box intersection of two point sets."""
    a = _bbox(g1)
    b = _bbox(g2)
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])


@register("apoc.spatial.contains")
def spatial_contains(g1, g2):
    """Bounding box of g1 contains every point of g2."""
    a = _bbox(g1)
    b = _bbox(g2)
    return a[0] <= b[0] and a[1] <= b[1] and a[2] >= b[2] and a[3] >= b[3]


@register("apoc.spatial.toGeoJSON")
def spatial_to_geojson(geom):
    if isinstance(geom, list):
        return {"type": "Polygon", "coordinates": [[
            [_latlon(p)[1], _latlon(p)[0]] for p in geom]]}
    lat, lon = _latlon(geom)
    return {"type": "Point", "coordinates": [lon, lat]}


@register("apoc.spatial.fromGeoJSON")
def spatial_from_geojson(gj):
    g = _json.loads(gj) if isinstance(gj, str) else (gj or {})
    t = g.get("type")
    if t == "Point":
        lon, lat = g["coordinates"][:2]
        return {"latitude": lat, "longitude": lon}
    if t == "Polygon":
        return [{"latitude": lat, "longitude": lon}
                for lon, lat in g["coordinates"][0]]
    raise NornicError(f"unsupported GeoJSON type {t!r}")


# =========================================================== apoc.convert
@register("apoc.convert.toNode")
def convert_to_node(m, labels=None):
    if isinstance(m, Node):
        return m
    if not isinstance(m, dict):
        return None
    props = dict(m.get("properties") or
                 {k: v for k, v in m.items()
                  if k not in ("id", "labels")})
    return Node(id=str(m.get("id", "")), labels=list(labels or m.get("labels") or []),
                properties=props)


@register("apoc.convert.fromJsonNode")
def convert_from_json_node(j):
    return convert_to_node(_json.loads(j) if isinstance(j, str) else j)


@register("apoc.convert.toNodeList")
def convert_to_node_list(maps):
    return [convert_to_node(m) for m in (maps or [])]


@register("apoc.convert.toRelationship")
def convert_to_relationship(m, rel_type=None):
    if isinstance(m, Edge):
        return m
    if not isinstance(m, dict):
        return None
    return Edge(
        id=str(m.get("id", "")), start_node=str(m.get("start", "")),
        end_node=str(m.get("end", "")),
        type=str(rel_type or m.get("type", "RELATED_TO")),
        properties=dict(m.get("properties") or {}),
    )


@register("apoc.convert.toRelationshipList")
def convert_to_relationship_list(maps):
    return [convert_to_relationship(m) for m in (maps or [])]


@register("apoc.convert.getJsonPropertyMap")
def convert_get_json_property_map(entity, key):
    """Parse a JSON-string property into a map."""
    props = entity.properties if isinstance(entity, (Node, Edge)) \
        else (entity or {})
    v = props.get(key)
    if v is None:
        return None
    return _json.loads(v) if isinstance(v, str) else v


@register("apoc.convert.toTree")
def convert_to_tree(paths):
    """Paths ([{nodes, relationships}] or node-id lists) -> nested tree
    keyed by parent (ref convert.go ToTree shape: children under
    lowercased rel type)."""
    roots: dict[str, dict] = {}
    index: dict[str, dict] = {}

    def entry(n):
        if isinstance(n, Node):
            nid = n.id
            data = {"_id": nid, "_labels": list(n.labels), **n.properties}
        else:
            nid = str(n)
            data = {"_id": nid}
        if nid not in index:
            index[nid] = data
        return index[nid]

    for p in paths or []:
        nodes = p.get("nodes", []) if isinstance(p, dict) else list(p)
        rels = p.get("relationships", []) if isinstance(p, dict) else []
        if not nodes:
            continue
        root = entry(nodes[0])
        roots[root["_id"]] = root
        for i in range(1, len(nodes)):
            parent = entry(nodes[i - 1])
            child = entry(nodes[i])
            key = (rels[i - 1].type.lower()
                   if i - 1 < len(rels) and isinstance(rels[i - 1], Edge)
                   else "children")
            bucket = parent.setdefault(key, [])
            if child not in bucket:
                bucket.append(child)
            roots.pop(child["_id"], None)
    return list(roots.values())


# =============================================================== apoc.date
@register("apoc.date.convertFormat")
def date_convert_format(text, from_fmt, to_fmt):
    def py(fmt):
        return (str(fmt).replace("yyyy", "%Y").replace("MM", "%m")
                .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
                .replace("ss", "%S"))

    dt = _dt.datetime.strptime(str(text), py(from_fmt))
    return dt.strftime(py(to_fmt))


@register("apoc.date.toYears")
def date_to_years(ts):
    """Epoch millis -> fractional years since 1970."""
    return float(ts) / (365.2425 * 86400 * 1000)


@register("apoc.date.systemTimezone")
def date_system_timezone():
    return "UTC"  # the engine normalizes all temporals to UTC


@register("apoc.date.parseAsZonedDateTime")
def date_parse_zoned(text, fmt=None):
    return temporal_parse(text, fmt)


# =============================================================== apoc.text
@register("apoc.text.doubleMetaphone")
def text_double_metaphone(s):
    """Primary Double Metaphone code (simplified clean-room variant
    covering the common English rules; 'Smith' -> 'SM0')."""
    if not s:
        return ""
    w = re.sub(r"[^A-Z]", "", str(s).upper())
    if not w:
        return ""
    out = []
    i = 0
    n = len(w)
    vowels = "AEIOUY"
    if w[:2] in ("GN", "KN", "PN", "WR", "PS"):
        i = 1
    if w[0] == "X":
        out.append("S")
        i = max(i, 1)
    while i < n and len(out) < 4:
        c = w[i]
        nxt = w[i + 1] if i + 1 < n else ""
        prev = w[i - 1] if i > 0 else ""
        if c in vowels:
            if i == 0:
                out.append("A")
            i += 1
            continue
        if c == "B":
            out.append("P")
            i += 2 if nxt == "B" else 1
        elif c == "C":
            if nxt == "H":
                out.append("X")
                i += 2
            elif nxt in "IEY":
                out.append("S")
                i += 1
            else:
                out.append("K")
                i += 2 if nxt in "CKQ" else 1
        elif c == "D":
            if nxt == "G" and i + 2 < n and w[i + 2] in "IEY":
                out.append("J")
                i += 3
            else:
                out.append("T")
                i += 2 if nxt in "DT" else 1
        elif c == "F":
            out.append("F")
            i += 2 if nxt == "F" else 1
        elif c == "G":
            if nxt == "H":
                if i > 0 and prev not in vowels:
                    out.append("K")
                i += 2
            elif nxt == "N":
                out.append("KN" if i == 0 else "N")
                i += 2
            elif nxt in "IEY":
                out.append("J")
                i += 1
            else:
                out.append("K")
                i += 2 if nxt == "G" else 1
        elif c == "H":
            if prev in vowels and nxt not in vowels:
                i += 1
            else:
                out.append("H")
                i += 1
        elif c == "J":
            out.append("J")
            i += 1
        elif c in "KQ":
            out.append("K")
            i += 2 if nxt in "KQ" else 1
        elif c == "L":
            out.append("L")
            i += 2 if nxt == "L" else 1
        elif c == "M":
            out.append("M")
            i += 2 if nxt == "M" else 1
        elif c == "N":
            out.append("N")
            i += 2 if nxt == "N" else 1
        elif c == "P":
            if nxt == "H":
                out.append("F")
                i += 2
            else:
                out.append("P")
                i += 2 if nxt == "P" else 1
        elif c == "R":
            out.append("R")
            i += 2 if nxt == "R" else 1
        elif c == "S":
            if nxt == "H":
                out.append("X")
                i += 2
            elif w[i:i + 3] in ("SIO", "SIA"):
                out.append("X")
                i += 1
            else:
                out.append("S")
                i += 2 if nxt == "S" else 1
        elif c == "T":
            if nxt == "H":
                out.append("0")
                i += 2
            elif w[i:i + 3] in ("TIO", "TIA"):
                out.append("X")
                i += 1
            else:
                out.append("T")
                i += 2 if nxt == "T" else 1
        elif c == "V":
            out.append("F")
            i += 1
        elif c == "W":
            if nxt in vowels:
                out.append("W")
            i += 1
        elif c == "X":
            out.append("KS")
            i += 1
        elif c == "Z":
            out.append("S")
            i += 1
        else:
            i += 1
    return "".join(out)[:4]


# ============================================ meta/schema/import fn forms
@_graph_fn("apoc.meta.data")
def meta_data_fn(ex):
    """Tabular label/property/type rows (function form of the
    apoc.meta.data procedure)."""
    rows = []
    seen: dict = {}
    for n in ex.storage.all_nodes():
        for label in n.labels:
            for k, v in n.properties.items():
                from nornicdb_tpu_torch.apoc.functions_graph2 import _cypher_type

                key = (label, k)
                if key not in seen:
                    seen[key] = _cypher_type(v)
                    rows.append({"label": label, "property": k,
                                 "type": seen[key]})
    return rows


@_graph_fn("apoc.meta.schema")
def meta_schema_fn(ex):
    out: dict = {}
    for n in ex.storage.all_nodes():
        for label in n.labels:
            entry = out.setdefault(
                label, {"type": "node", "count": 0, "properties": {}})
            entry["count"] += 1
            for k, v in n.properties.items():
                from nornicdb_tpu_torch.apoc.functions_graph2 import _cypher_type

                entry["properties"].setdefault(k, {"type": _cypher_type(v)})
    return out


@_graph_fn("apoc.meta.nodeTypeProperties")
def meta_node_type_properties_fn(ex):
    rows = []
    seen: set = set()
    for n in ex.storage.all_nodes():
        for label in n.labels:
            for k, v in n.properties.items():
                from nornicdb_tpu_torch.apoc.functions_graph2 import _cypher_type

                key = (label, k, _cypher_type(v))
                if key not in seen:
                    seen.add(key)
                    rows.append({"nodeType": f":`{label}`",
                                 "propertyName": k,
                                 "propertyTypes": [key[2]]})
    return rows


@_graph_fn("apoc.meta.relTypeProperties")
def meta_rel_type_properties_fn(ex):
    rows = []
    seen: set = set()
    for e in ex.storage.all_edges():
        for k, v in e.properties.items():
            from nornicdb_tpu_torch.apoc.functions_graph2 import _cypher_type

            key = (e.type, k, _cypher_type(v))
            if key not in seen:
                seen.add(key)
                rows.append({"relType": f":`{e.type}`", "propertyName": k,
                             "propertyTypes": [key[2]]})
    return rows


@_graph_fn("apoc.schema.nodes")
def schema_nodes_fn(ex):
    out = []
    for i in ex.schema.list_indexes():
        out.append({"name": i.name, "label": i.label,
                    "properties": list(i.properties), "status": "ONLINE",
                    "type": i.kind})
    return out


@_graph_fn("apoc.schema.relationships")
def schema_relationships_fn(ex):
    return []  # relationship indexes are not part of the schema manager


@_graph_fn("apoc.import.json")
def import_json_fn(ex, path):
    from nornicdb_tpu_torch.apoc.export_import import import_json

    return import_json(ex, [str(path)], {})


@_graph_fn("apoc.import.csv")
def import_csv_fn(ex, path):
    from nornicdb_tpu_torch.apoc.export_import import import_csv

    return import_csv(ex, [str(path)], {})


@_graph_fn("apoc.import.graphML")
def import_graphml_fn(ex, path):
    from nornicdb_tpu_torch.apoc.export_import import import_graphml

    return import_graphml(ex, [str(path)], {})
