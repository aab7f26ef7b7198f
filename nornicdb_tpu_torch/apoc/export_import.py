"""APOC export/import and path-expansion procedures.

Behavioral reference: upstream NornicDB apoc/export/export.go (Json/Csv/
Cypher/GraphML × All/Data, ToFile/ToString), apoc/import/import.go
(Json/Csv/GraphML round-trips), apoc/path(s)/ (ExpandConfig, SpanningTree,
Elements, Combine, Slice). File writes are gated by
NORNICDB_APOC_EXPORT_ENABLED, file reads by NORNICDB_APOC_IMPORT_ENABLED
(the reference gates file access the same way, apoc/config.go); with a
null/empty file the exporters stream the payload back as a row instead.

The port's copy of ``nornicdb_tpu/apoc/export_import.py``.
"""

from __future__ import annotations

import csv
import io
import json
import os
from typing import Any, Optional
from xml.sax.saxutils import escape as _xml_escape
from xml.sax.saxutils import quoteattr as _xml_attr

from nornicdb_tpu_torch.cypher.executor import CypherExecutor, procedure
from nornicdb_tpu_torch.errors import CypherSyntaxError, CypherTypeError, NornicError
from nornicdb_tpu_torch.storage.types import Edge, Node


def _export_allowed() -> bool:
    return os.environ.get("NORNICDB_APOC_EXPORT_ENABLED", "").lower() in (
        "1", "true", "yes")


def _import_allowed() -> bool:
    return os.environ.get("NORNICDB_APOC_IMPORT_ENABLED", "").lower() in (
        "1", "true", "yes")


def _all_graph(ex: CypherExecutor) -> tuple[list[Node], list[Edge]]:
    return list(ex.storage.all_nodes()), list(ex.storage.all_edges())


def _emit(ex, file: Optional[str], payload: str, fmt: str, n_nodes: int,
          n_rels: int):
    """Write to file (gated) or stream back, with apoc.export.*'s row shape."""
    cols = ["file", "format", "nodes", "relationships", "data"]
    if file:
        if not _export_allowed():
            raise NornicError(
                "file export disabled; set NORNICDB_APOC_EXPORT_ENABLED=1"
            )
        with open(file, "w") as f:
            f.write(payload)
        return cols, [[file, fmt, n_nodes, n_rels, None]]
    return cols, [[None, fmt, n_nodes, n_rels, payload]]


# ---------------------------------------------------------------------------
# exporters (ref: export.go Json/Csv/Cypher/GraphML)
# ---------------------------------------------------------------------------


def _json_payload(nodes: list[Node], rels: list[Edge]) -> str:
    out = io.StringIO()
    for n in nodes:
        rec = {"type": "node", "id": n.id, "labels": list(n.labels),
               "properties": dict(n.properties)}
        out.write(json.dumps(rec, default=str) + "\n")
    for e in rels:
        rec = {"type": "relationship", "id": e.id, "label": e.type,
               "start": {"id": e.start_node}, "end": {"id": e.end_node},
               "properties": dict(e.properties)}
        out.write(json.dumps(rec, default=str) + "\n")
    return out.getvalue()


_CSV_RESERVED = {"_id", "_labels", "_start", "_end", "_type"}


def _csv_col(key: str) -> str:
    """Header column for a property key; reserved names are aliased so a
    user property literally named `_id` can't shadow the structural
    columns."""
    return "_prop" + key if key in _CSV_RESERVED else key


def _csv_payload(nodes: list[Node], rels: list[Edge]) -> str:
    """Union-of-keys header over BOTH node and relationship properties (the
    reference uses first-node keys, which drops columns — deliberately
    diverging to a lossless header). Edge rows carry their id/props too, so
    apoc.import.csv round-trips relationships faithfully."""
    out = io.StringIO()
    w = csv.writer(out)
    prop_keys = sorted({k for n in nodes for k in n.properties}
                       | {k for e in rels for k in e.properties})
    w.writerow(["_id", "_labels"] + [_csv_col(k) for k in prop_keys] +
               ["_start", "_end", "_type"])
    for n in nodes:
        w.writerow([n.id, ";".join(n.labels)] +
                   [_csv_val(n.properties.get(k)) for k in prop_keys] +
                   ["", "", ""])
    for e in rels:
        w.writerow([e.id, ""] +
                   [_csv_val(e.properties.get(k)) for k in prop_keys] +
                   [e.start_node, e.end_node, e.type])
    return out.getvalue()


def _csv_val(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, (list, dict)):
        return json.dumps(v, default=str)
    return str(v)


def _cypher_literal(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(_cypher_literal(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(
            f"{_bt(k)}: {_cypher_literal(x)}" for k, x in v.items()) + "}"
    s = str(v).replace("\\", "\\\\").replace("'", "\\'")
    return f"'{s}'"


def _bt(name: str) -> str:
    """Backtick-quoted Cypher identifier; embedded backticks are doubled so
    a hostile label/type/key can't escape the identifier in the replay
    script."""
    return "`" + str(name).replace("`", "``") + "`"


def _cypher_payload(nodes: list[Node], rels: list[Edge]) -> str:
    """CREATE-script export keyed on an `_import_id` property so the
    relationship MATCHes are replayable (the reference emits positional
    n<i> aliases valid only within one statement batch)."""
    out = io.StringIO()
    for n in nodes:
        labels = "".join(f":{_bt(l)}" for l in n.labels)
        props = dict(n.properties)
        props["_import_id"] = n.id
        out.write(f"CREATE ({labels} {_cypher_literal(props)});\n")
    for e in rels:
        out.write(
            "MATCH (a {_import_id: %s}), (b {_import_id: %s}) "
            "CREATE (a)-[:%s %s]->(b);\n"
            % (_cypher_literal(e.start_node), _cypher_literal(e.end_node),
               _bt(e.type), _cypher_literal(dict(e.properties)))
        )
    return out.getvalue()


def _graphml_payload(nodes: list[Node], rels: list[Edge]) -> str:
    # attribute positions use quoteattr (escape() leaves '"' alone, which
    # would break label="..." on values containing quotes)
    out = io.StringIO()
    out.write('<?xml version="1.0" encoding="UTF-8"?>\n')
    out.write('<graphml xmlns="http://graphml.graphdrawing.org/xmlns">\n')
    keys = sorted({k for n in nodes for k in n.properties}
                  | {k for e in rels for k in e.properties} | {"labels"})
    for k in keys:
        out.write(f"  <key id={_xml_attr(k)} for=\"all\" "
                  f"attr.name={_xml_attr(k)} attr.type=\"string\"/>\n")
    out.write('  <graph id="G" edgedefault="directed">\n')
    for n in nodes:
        out.write(f"    <node id={_xml_attr(n.id)}>\n")
        out.write(f'      <data key="labels">{_xml_escape(";".join(n.labels))}'
                  "</data>\n")
        for k, v in n.properties.items():
            out.write(f"      <data key={_xml_attr(k)}>"
                      f"{_xml_escape(_csv_val(v))}</data>\n")
        out.write("    </node>\n")
    for e in rels:
        out.write(f"    <edge id={_xml_attr(e.id)} "
                  f"source={_xml_attr(e.start_node)} "
                  f"target={_xml_attr(e.end_node)} "
                  f"label={_xml_attr(e.type)}>\n")
        for k, v in e.properties.items():
            out.write(f"      <data key={_xml_attr(k)}>"
                      f"{_xml_escape(_csv_val(v))}</data>\n")
        out.write("    </edge>\n")
    out.write("  </graph>\n</graphml>\n")
    return out.getvalue()


def _split_data_args(args) -> tuple[list, list, Optional[str]]:
    nodes = list(args[0] or []) if args else []
    rels = list(args[1] or []) if len(args) > 1 else []
    file = args[2] if len(args) > 2 and args[2] else None
    return nodes, rels, file


@procedure("apoc.export.json.all")
def export_json_all(ex: CypherExecutor, args, row):
    file = args[0] if args and args[0] else None
    nodes, rels = _all_graph(ex)
    return _emit(ex, file, _json_payload(nodes, rels), "json",
                 len(nodes), len(rels))


@procedure("apoc.export.json.data")
def export_json_data(ex: CypherExecutor, args, row):
    nodes, rels, file = _split_data_args(args)
    return _emit(ex, file, _json_payload(nodes, rels), "json",
                 len(nodes), len(rels))


@procedure("apoc.export.csv.all")
def export_csv_all(ex: CypherExecutor, args, row):
    file = args[0] if args and args[0] else None
    nodes, rels = _all_graph(ex)
    return _emit(ex, file, _csv_payload(nodes, rels), "csv",
                 len(nodes), len(rels))


@procedure("apoc.export.csv.data")
def export_csv_data(ex: CypherExecutor, args, row):
    nodes, rels, file = _split_data_args(args)
    return _emit(ex, file, _csv_payload(nodes, rels), "csv",
                 len(nodes), len(rels))


@procedure("apoc.export.cypher.all")
def export_cypher_all(ex: CypherExecutor, args, row):
    file = args[0] if args and args[0] else None
    nodes, rels = _all_graph(ex)
    return _emit(ex, file, _cypher_payload(nodes, rels), "cypher",
                 len(nodes), len(rels))


@procedure("apoc.export.cypher.data")
def export_cypher_data(ex: CypherExecutor, args, row):
    nodes, rels, file = _split_data_args(args)
    return _emit(ex, file, _cypher_payload(nodes, rels), "cypher",
                 len(nodes), len(rels))


@procedure("apoc.export.graphml.all")
def export_graphml_all(ex: CypherExecutor, args, row):
    file = args[0] if args and args[0] else None
    nodes, rels = _all_graph(ex)
    return _emit(ex, file, _graphml_payload(nodes, rels), "graphml",
                 len(nodes), len(rels))


@procedure("apoc.export.graphml.data")
def export_graphml_data(ex: CypherExecutor, args, row):
    nodes, rels, file = _split_data_args(args)
    return _emit(ex, file, _graphml_payload(nodes, rels), "graphml",
                 len(nodes), len(rels))


# ---------------------------------------------------------------------------
# importers (ref: import.go — mirror of the exporters above)
# ---------------------------------------------------------------------------


def _require_import(file: str) -> str:
    if not _import_allowed():
        raise NornicError(
            "file import disabled; set NORNICDB_APOC_IMPORT_ENABLED=1"
        )
    with open(file) as f:
        return f.read()


@procedure("apoc.import.json")
def import_json(ex: CypherExecutor, args, row):
    """Reads the jsonl produced by apoc.export.json.* — ids are preserved."""
    if not args:
        raise CypherSyntaxError("apoc.import.json(file)")
    text = _require_import(str(args[0]))
    n_nodes = n_rels = 0
    deferred: list[dict] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        if rec.get("type") == "node":
            ex.storage.create_node(Node(
                id=rec["id"], labels=list(rec.get("labels") or []),
                properties=dict(rec.get("properties") or {})))
            n_nodes += 1
        else:
            deferred.append(rec)
    for rec in deferred:
        ex.storage.create_edge(Edge(
            id=rec["id"], type=rec.get("label", "RELATED_TO"),
            start_node=rec["start"]["id"], end_node=rec["end"]["id"],
            properties=dict(rec.get("properties") or {})))
        n_rels += 1
    return ["nodes", "relationships"], [[n_nodes, n_rels]]


@procedure("apoc.import.csv")
def import_csv(ex: CypherExecutor, args, row):
    """Reads the union-header CSV produced by apoc.export.csv.*."""
    if not args:
        raise CypherSyntaxError("apoc.import.csv(file)")
    text = _require_import(str(args[0]))
    rows = list(csv.reader(io.StringIO(text)))
    if not rows:
        return ["nodes", "relationships"], [[0, 0]]
    header = rows[0]
    # property columns: everything except the structural ones; `_prop<name>`
    # aliases map back to their reserved-looking original keys
    prop_cols = [(h, h[5:] if h.startswith("_prop") else h)
                 for h in header if h not in _CSV_RESERVED]
    idx = {h: i for i, h in enumerate(header)}
    n_nodes = n_rels = 0
    for r in rows[1:]:
        if not r:
            continue
        props = {k: r[idx[h]] for h, k in prop_cols if r[idx[h]] != ""}
        if r[idx["_start"]]:  # edge rows are the ones with endpoints
            kwargs = {"id": r[idx["_id"]]} if r[idx["_id"]] else {}
            ex.storage.create_edge(Edge(
                start_node=r[idx["_start"]], end_node=r[idx["_end"]],
                type=r[idx["_type"]] or "RELATED_TO", properties=props,
                **kwargs))
            n_rels += 1
        elif r[idx["_id"]]:
            ex.storage.create_node(Node(
                id=r[idx["_id"]],
                labels=[l for l in r[idx["_labels"]].split(";") if l],
                properties=props))
            n_nodes += 1
    return ["nodes", "relationships"], [[n_nodes, n_rels]]


@procedure("apoc.import.graphml")
def import_graphml(ex: CypherExecutor, args, row):
    if not args:
        raise CypherSyntaxError("apoc.import.graphml(file)")
    import xml.etree.ElementTree as ET

    text = _require_import(str(args[0]))
    ns = {"g": "http://graphml.graphdrawing.org/xmlns"}
    root = ET.fromstring(text)
    n_nodes = n_rels = 0
    graph = root.find("g:graph", ns)
    if graph is None:
        raise NornicError("graphml: no <graph> element")
    for el in graph.findall("g:node", ns):
        props = {}
        labels: list[str] = []
        for d in el.findall("g:data", ns):
            if d.get("key") == "labels":
                labels = [l for l in (d.text or "").split(";") if l]
            else:
                # ElementTree yields text=None for <data></data>; that was
                # an empty string at export time, not a null
                props[d.get("key")] = d.text or ""
        ex.storage.create_node(Node(id=el.get("id"), labels=labels,
                                    properties=props))
        n_nodes += 1
    for el in graph.findall("g:edge", ns):
        props = {d.get("key"): d.text or "" for d in el.findall("g:data", ns)}
        kwargs = {}
        if el.get("id"):
            kwargs["id"] = el.get("id")
        ex.storage.create_edge(Edge(
            start_node=el.get("source"), end_node=el.get("target"),
            type=el.get("label") or "RELATED_TO", properties=props, **kwargs))
        n_rels += 1
    return ["nodes", "relationships"], [[n_nodes, n_rels]]


# ---------------------------------------------------------------------------
# apoc.path.* (ref: apoc/path/path.go ExpandConfig/SpanningTree,
# apoc/paths/paths.go Elements/Combine/Slice)
# ---------------------------------------------------------------------------


def _path_obj(nodes: list[Node], rels: list[Edge]) -> dict:
    return {"__path__": True, "nodes": nodes, "relationships": rels}


def _parse_rel_filter(spec: Optional[str]) -> tuple[set[str], set[str]]:
    """"KNOWS>|<WORKS_WITH|BOTH" -> (outgoing types, incoming types);
    empty spec allows everything both ways."""
    out_t: set[str] = set()
    in_t: set[str] = set()
    if not spec:
        return out_t, in_t
    for part in str(spec).split("|"):
        part = part.strip()
        if not part:
            continue
        if part.endswith(">"):
            out_t.add(part.rstrip(">"))
        elif part.startswith("<"):
            in_t.add(part.lstrip("<"))
        else:
            out_t.add(part)
            in_t.add(part)
    return out_t, in_t


def _parse_label_filter(spec: Optional[str]) -> tuple[set[str], set[str]]:
    """"+Person|-Banned" -> (whitelist, blacklist)."""
    white: set[str] = set()
    black: set[str] = set()
    for part in str(spec or "").split("|"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("-"):
            black.add(part[1:])
        else:
            white.add(part.lstrip("+"))
    return white, black


def _resolve_start(ex, start) -> Node:
    """The start argument accepts a Node, an id string, or a map carrying
    an `id` key (ref: apoc.path.* taking {id: ...} in the reference
    tests)."""
    if isinstance(start, Node):
        return start
    if isinstance(start, dict):
        start = start.get("id")
    node = ex.get_node_or_none(str(start)) if start is not None else None
    if node is None:
        raise CypherTypeError(f"start node not found: {start!r}")
    return node


def _expand(ex, start, rel_spec, label_spec, min_level: int,
            max_level: int, uniqueness: str = "RELATIONSHIP_PATH",
            limit: Optional[int] = None, bfs: bool = False) -> list[dict]:
    start = _resolve_start(ex, start)
    out_t, in_t = _parse_rel_filter(rel_spec)
    no_filter = not rel_spec
    white, black = _parse_label_filter(label_spec)
    results: list[dict] = []

    def node_ok(n: Node) -> bool:
        if black and any(l in black for l in n.labels):
            return False
        if white and not any(l in white for l in n.labels):
            return False
        return True

    # iterative walk (deep graphs with large maxLevel must not hit the
    # interpreter recursion limit); RELATIONSHIP_PATH uniqueness derives
    # the per-path seen-sets from the path itself, NODE_GLOBAL keeps one
    # shared visited set (first path to a node claims it). NODE_GLOBAL
    # callers (spanningTree) need BFS order so the claiming path is a
    # shortest one — DFS would claim nodes via long detours and then
    # truncate their subtrees at maxLevel.
    from collections import deque

    global_seen = {start.id}
    stack: deque[tuple[Node, list[Node], list[Edge]]] = deque(
        [(start, [start], [])])
    while stack:
        node, nodes, rels = stack.popleft() if bfs else stack.pop()
        if limit is not None and len(results) >= limit:
            break
        depth = len(rels)
        if depth >= min_level:
            results.append(_path_obj(list(nodes), list(rels)))
        if depth >= max_level:
            continue
        path_rel_ids = {e.id for e in rels}
        steps: list[tuple[Edge, str]] = []
        for e in ex.storage.get_outgoing_edges(node.id):
            if no_filter or e.type in out_t:
                steps.append((e, e.end_node))
        for e in ex.storage.get_incoming_edges(node.id):
            if no_filter or e.type in in_t:
                steps.append((e, e.start_node))
        for e, nxt_id in reversed(steps):  # preserve first-edge-first order
            if e.id in path_rel_ids:
                continue
            if uniqueness == "NODE_GLOBAL" and nxt_id in global_seen:
                continue
            nxt = ex.get_node_or_none(nxt_id)
            if nxt is None or not node_ok(nxt):
                continue
            if uniqueness == "NODE_GLOBAL":
                global_seen.add(nxt_id)
            stack.append((nxt, nodes + [nxt], rels + [e]))
    return results


@procedure("apoc.path.expand")
def apoc_path_expand(ex: CypherExecutor, args, row):
    """apoc.path.expand(start, relFilter, labelFilter, minLevel, maxLevel)"""
    if not args:
        raise CypherSyntaxError(
            "apoc.path.expand(start, relFilter, labelFilter, min, max)")
    start = args[0]
    rel_spec = args[1] if len(args) > 1 else None
    label_spec = args[2] if len(args) > 2 else None
    min_level = int(args[3]) if len(args) > 3 else 0
    max_level = int(args[4]) if len(args) > 4 else 3
    # minLevel 0 includes the zero-length start-only path, same as
    # expandConfig (APOC semantics)
    paths = _expand(ex, start, rel_spec, label_spec, min_level, max_level)
    return ["path"], [[p] for p in paths]


@procedure("apoc.path.expandconfig")
def apoc_path_expand_config(ex: CypherExecutor, args, row):
    """apoc.path.expandConfig(start, {relationshipFilter, labelFilter,
    minLevel, maxLevel, uniqueness, limit})"""
    if not args:
        raise CypherSyntaxError("apoc.path.expandConfig(start, config)")
    start = args[0]
    cfg = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    paths = _expand(
        ex, start,
        cfg.get("relationshipFilter"), cfg.get("labelFilter"),
        max(int(cfg.get("minLevel", 1)), 0),
        int(cfg.get("maxLevel", 3)),
        uniqueness=str(cfg.get("uniqueness", "RELATIONSHIP_PATH")),
        limit=int(cfg["limit"]) if cfg.get("limit") is not None else None,
    )
    return ["path"], [[p] for p in paths]


@procedure("apoc.path.spanningtree")
def apoc_path_spanning_tree(ex: CypherExecutor, args, row):
    """BFS spanning tree: one path per reachable node (NODE_GLOBAL)."""
    if not args:
        raise CypherSyntaxError("apoc.path.spanningTree(start, config)")
    start = args[0]
    cfg = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    paths = _expand(
        ex, start,
        cfg.get("relationshipFilter"), cfg.get("labelFilter"),
        1, int(cfg.get("maxLevel", 3)), uniqueness="NODE_GLOBAL", bfs=True,
    )
    return ["path"], [[p] for p in paths]


@procedure("apoc.path.elements")
def apoc_path_elements(ex: CypherExecutor, args, row):
    """Interleaved [n0, r0, n1, r1, ...] (ref paths.go Elements)."""
    p = args[0] if args else None
    if not (isinstance(p, dict) and p.get("__path__")):
        raise CypherSyntaxError("apoc.path.elements(path)")
    out: list[Any] = []
    nodes, rels = p["nodes"], p["relationships"]
    for i, n in enumerate(nodes):
        out.append(n)
        if i < len(rels):
            out.append(rels[i])
    return ["value"], [[out]]


@procedure("apoc.path.combine")
def apoc_path_combine(ex: CypherExecutor, args, row):
    """Join two paths sharing an endpoint node (ref paths.go Combine)."""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.path.combine(first, second)")
    a, b = args[0], args[1]
    for p in (a, b):
        if not (isinstance(p, dict) and p.get("__path__")):
            raise CypherSyntaxError("apoc.path.combine expects two paths")
    if not a["nodes"] or not b["nodes"] or \
            a["nodes"][-1].id != b["nodes"][0].id:
        raise CypherSyntaxError(
            "apoc.path.combine: first path must end where second begins")
    return ["path"], [[_path_obj(a["nodes"] + b["nodes"][1:],
                                 a["relationships"] + b["relationships"])]]


@procedure("apoc.path.slice")
def apoc_path_slice(ex: CypherExecutor, args, row):
    """Sub-path [offset, offset+length] in relationship units."""
    p = args[0] if args else None
    if not (isinstance(p, dict) and p.get("__path__")):
        raise CypherSyntaxError("apoc.path.slice(path, offset, length)")
    offset = int(args[1]) if len(args) > 1 else 0
    length = int(args[2]) if len(args) > 2 else len(p["relationships"])
    rels = p["relationships"][offset : offset + length]
    nodes = p["nodes"][offset : offset + length + 1]
    return ["path"], [[_path_obj(nodes, rels)]]
