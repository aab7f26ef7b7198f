"""APOC graph-access function categories: node / rel / nodes / label /
neighbors / atomic / meta / schema / search / create / merge / graph /
cypher / community / algo / paths / path.

Behavioral reference: upstream NornicDB apoc/apoc.go registerAllFunctions and
the per-category dirs (node/, rel/, label/, community/community.go, ...).
Mutating functions persist through the executor's storage and return the
updated entity; community/algo delegate to ops/graph_algos.py (the same
functions behind the gds.* procedures; PageRank and weakly connected
components on the executor's device). Where the reference takes Go func-typed predicate params that
Cypher can't express (nodes.go:301 Filter), the predicate is a Cypher
expression string evaluated with the entity bound as `n` — strictly more
usable from the query language.

The port's copy of ``nornicdb_tpu/apoc/functions_graph.py``.
"""

from __future__ import annotations

import fnmatch
import re
import threading
import uuid as _uuid
from typing import Any

from nornicdb_tpu_torch.apoc.registry import register
from nornicdb_tpu_torch.errors import NornicError, NotFoundError
from nornicdb_tpu_torch.storage.types import Edge, Node

_atomic_lock = threading.RLock()
# parsed-predicate memo: concurrent Cypher sessions evaluate apoc
# predicates on their own threads, so reads/writes go under a lock
_expr_memo: dict[str, Any] = {}
_expr_memo_lock = threading.Lock()


def _graph_fn(name):
    """register + needs_executor marker."""

    def deco(fn):
        fn.needs_executor = True
        return register(name)(fn)

    return deco


def _node(ex, v) -> Node:
    if isinstance(v, Node):
        return v
    n = ex.get_node_or_none(str(v))
    if n is None:
        raise NotFoundError(f"node {v} not found")
    return n


def _edge(ex, v) -> Edge:
    if isinstance(v, Edge):
        return v
    return ex.storage.get_edge(str(v))


def _save_node(ex, node: Node) -> Node:
    return ex.storage.update_node(node)


def _save_edge(ex, edge: Edge) -> Edge:
    return ex.storage.update_edge(edge)


def _eval_pred(ex, expr_text: str, bindings: dict) -> Any:
    from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate
    from nornicdb_tpu_torch.cypher.parser import parse

    with _expr_memo_lock:
        e = _expr_memo.get(expr_text)
    if e is None:
        q = parse(f"RETURN {expr_text}")
        e = q.clauses[0].items[0].expr
        with _expr_memo_lock:
            _expr_memo[expr_text] = e
    return evaluate(e, EvalContext(bindings, {}, ex))


# ============================================================== apoc.node
@_graph_fn("apoc.node.degreeIn")
def node_degree_in(ex, node):
    return len(ex.storage.get_incoming_edges(_node(ex, node).id))


@_graph_fn("apoc.node.degreeOut")
def node_degree_out(ex, node):
    return len(ex.storage.get_outgoing_edges(_node(ex, node).id))


@register("apoc.node.properties")
def node_properties(node):
    return dict(node.properties) if isinstance(node, (Node, Edge)) else None


@register("apoc.node.property")
def node_property(node, key):
    return node.properties.get(key) if isinstance(node, (Node, Edge)) else None


def _rels_of(ex, node, direction):
    nid = _node(ex, node).id
    out = []
    if direction in ("out", "both"):
        out.extend(ex.storage.get_outgoing_edges(nid))
    if direction in ("in", "both"):
        out.extend(ex.storage.get_incoming_edges(nid))
    return out


@_graph_fn("apoc.node.relationships")
def node_relationships(ex, node, rel_type=None):
    rels = _rels_of(ex, node, "both")
    return [r for r in rels if rel_type is None or r.type == rel_type]


@_graph_fn("apoc.node.relationshipsIn")
def node_relationships_in(ex, node, rel_type=None):
    return [r for r in _rels_of(ex, node, "in")
            if rel_type is None or r.type == rel_type]


@_graph_fn("apoc.node.relationshipsOut")
def node_relationships_out(ex, node, rel_type=None):
    return [r for r in _rels_of(ex, node, "out")
            if rel_type is None or r.type == rel_type]


@_graph_fn("apoc.node.relationshipTypes")
def node_relationship_types(ex, node):
    return sorted({r.type for r in _rels_of(ex, node, "both")})


@_graph_fn("apoc.node.relationshipTypesIn")
def node_relationship_types_in(ex, node):
    return sorted({r.type for r in _rels_of(ex, node, "in")})


@_graph_fn("apoc.node.relationshipTypesOut")
def node_relationship_types_out(ex, node):
    return sorted({r.type for r in _rels_of(ex, node, "out")})


@_graph_fn("apoc.node.relationshipExists")
def node_relationship_exists(ex, node, rel_type=None):
    return any(rel_type is None or r.type == rel_type
               for r in _rels_of(ex, node, "both"))


@_graph_fn("apoc.node.connected")
def node_connected(ex, n1, n2, rel_type=None):
    a, b = _node(ex, n1).id, _node(ex, n2).id
    for r in _rels_of(ex, n1, "both"):
        if rel_type is not None and r.type != rel_type:
            continue
        if b in (r.start_node, r.end_node) and a in (r.start_node, r.end_node):
            if a != b or r.start_node == r.end_node:
                return True
    return False


def _neighbor_ids(ex, node, direction):
    nid = _node(ex, node).id
    out = set()
    for r in _rels_of(ex, node, direction):
        out.add(r.end_node if r.start_node == nid else r.start_node)
    return out


@_graph_fn("apoc.node.neighbors")
def node_neighbors(ex, node):
    return [n for i in sorted(_neighbor_ids(ex, node, "both"))
            if (n := ex.get_node_or_none(i)) is not None]


@_graph_fn("apoc.node.neighborsIn")
def node_neighbors_in(ex, node):
    return [n for i in sorted(_neighbor_ids(ex, node, "in"))
            if (n := ex.get_node_or_none(i)) is not None]


@_graph_fn("apoc.node.neighborsOut")
def node_neighbors_out(ex, node):
    return [n for i in sorted(_neighbor_ids(ex, node, "out"))
            if (n := ex.get_node_or_none(i)) is not None]


@_graph_fn("apoc.node.isDense")
def node_is_dense(ex, node, threshold=50):
    """Degree above threshold (ref: dense-node flag, node.go IsDense)."""
    return len(_rels_of(ex, node, "both")) > int(threshold)


@register("apoc.node.toMap")
def node_to_map(node):
    if not isinstance(node, Node):
        return None
    return {"id": node.id, "labels": list(node.labels),
            "properties": dict(node.properties)}


@_graph_fn("apoc.node.fromMap")
def node_from_map(ex, m):
    """Create a node from {labels, properties[, id]} (persisted)."""
    node = Node(
        id=str(m.get("id") or f"apoc-{_uuid.uuid4()}"),
        labels=list(m.get("labels") or []),
        properties=dict(m.get("properties") or {}),
    )
    return ex.storage.create_node(node)


@_graph_fn("apoc.node.setProperty")
def node_set_property(ex, node, key, value):
    n = _node(ex, node)
    n.properties[key] = value
    return _save_node(ex, n)


@_graph_fn("apoc.node.setProperties")
def node_set_properties(ex, node, props):
    n = _node(ex, node)
    n.properties.update(props or {})
    return _save_node(ex, n)


@_graph_fn("apoc.node.removeProperty")
def node_remove_property(ex, node, key):
    n = _node(ex, node)
    n.properties.pop(key, None)
    return _save_node(ex, n)


@_graph_fn("apoc.node.removeProperties")
def node_remove_properties(ex, node, keys):
    n = _node(ex, node)
    for k in keys or []:
        n.properties.pop(k, None)
    return _save_node(ex, n)


@_graph_fn("apoc.node.addLabel")
def node_add_label(ex, node, label):
    n = _node(ex, node)
    if label not in n.labels:
        n.labels.append(label)
    return _save_node(ex, n)


@_graph_fn("apoc.node.addLabels")
def node_add_labels(ex, node, labels):
    n = _node(ex, node)
    for lbl in labels or []:
        if lbl not in n.labels:
            n.labels.append(lbl)
    return _save_node(ex, n)


@_graph_fn("apoc.node.removeLabel")
def node_remove_label(ex, node, label):
    n = _node(ex, node)
    n.labels = [l for l in n.labels if l != label]
    return _save_node(ex, n)


@_graph_fn("apoc.node.removeLabels")
def node_remove_labels(ex, node, labels):
    n = _node(ex, node)
    drop = set(labels or [])
    n.labels = [l for l in n.labels if l not in drop]
    return _save_node(ex, n)


@_graph_fn("apoc.node.clone")
def node_clone(ex, node):
    n = _node(ex, node)
    return ex.storage.create_node(Node(
        id=f"apoc-{_uuid.uuid4()}", labels=list(n.labels),
        properties=dict(n.properties),
    ))


@register("apoc.node.diff")
def node_diff(n1, n2):
    """Property/label diff (ref node.go Diff shape)."""
    p1 = dict(n1.properties) if isinstance(n1, Node) else {}
    p2 = dict(n2.properties) if isinstance(n2, Node) else {}
    l1 = set(n1.labels) if isinstance(n1, Node) else set()
    l2 = set(n2.labels) if isinstance(n2, Node) else set()
    return {
        "labels": {"onlyLeft": sorted(l1 - l2), "onlyRight": sorted(l2 - l1)},
        "properties": {
            "onlyLeft": {k: v for k, v in p1.items() if k not in p2},
            "onlyRight": {k: v for k, v in p2.items() if k not in p1},
            "different": {
                k: {"left": p1[k], "right": p2[k]}
                for k in p1.keys() & p2.keys() if p1[k] != p2[k]
            },
        },
    }


@register("apoc.node.equals")
def node_equals(n1, n2):
    if not isinstance(n1, Node) or not isinstance(n2, Node):
        return False
    return (sorted(n1.labels) == sorted(n2.labels)
            and n1.properties == n2.properties)


# =============================================================== apoc.rel
@register("apoc.rel.properties")
def rel_properties(rel):
    return dict(rel.properties) if isinstance(rel, Edge) else None


@register("apoc.rel.property")
def rel_property(rel, key):
    return rel.properties.get(key) if isinstance(rel, Edge) else None


@_graph_fn("apoc.rel.nodes")
def rel_nodes(ex, rel):
    r = _edge(ex, rel)
    return [ex.get_node_or_none(r.start_node), ex.get_node_or_none(r.end_node)]


@_graph_fn("apoc.rel.setProperty")
def rel_set_property(ex, rel, key, value):
    r = _edge(ex, rel)
    r.properties[key] = value
    return _save_edge(ex, r)


@_graph_fn("apoc.rel.setProperties")
def rel_set_properties(ex, rel, props):
    r = _edge(ex, rel)
    r.properties.update(props or {})
    return _save_edge(ex, r)


@_graph_fn("apoc.rel.removeProperty")
def rel_remove_property(ex, rel, key):
    r = _edge(ex, rel)
    r.properties.pop(key, None)
    return _save_edge(ex, r)


@_graph_fn("apoc.rel.removeProperties")
def rel_remove_properties(ex, rel, keys):
    r = _edge(ex, rel)
    for k in keys or []:
        r.properties.pop(k, None)
    return _save_edge(ex, r)


@register("apoc.rel.toMap")
def rel_to_map(rel):
    if not isinstance(rel, Edge):
        return None
    return {"id": rel.id, "type": rel.type, "start": rel.start_node,
            "end": rel.end_node, "properties": dict(rel.properties)}


@_graph_fn("apoc.rel.fromMap")
def rel_from_map(ex, m):
    edge = Edge(
        id=str(m.get("id") or f"apoc-{_uuid.uuid4()}"),
        start_node=str(m["start"]), end_node=str(m["end"]),
        type=str(m.get("type", "RELATED_TO")),
        properties=dict(m.get("properties") or {}),
    )
    return ex.storage.create_edge(edge)


@_graph_fn("apoc.rel.exists")
def rel_exists(ex, rel_id):
    try:
        ex.storage.get_edge(str(rel_id))
        return True
    except NotFoundError:
        return False


@_graph_fn("apoc.rel.delete")
def rel_delete(ex, rel):
    r = _edge(ex, rel)
    ex.storage.delete_edge(r.id)
    return True


@_graph_fn("apoc.rel.clone")
def rel_clone(ex, rel):
    r = _edge(ex, rel)
    return ex.storage.create_edge(Edge(
        id=f"apoc-{_uuid.uuid4()}", start_node=r.start_node,
        end_node=r.end_node, type=r.type, properties=dict(r.properties),
    ))


@_graph_fn("apoc.rel.reverse")
def rel_reverse(ex, rel):
    """Persisted endpoint swap (ref refactor.invertRelationship semantics)."""
    r = _edge(ex, rel)
    ex.storage.delete_edge(r.id)
    return ex.storage.create_edge(Edge(
        id=r.id, start_node=r.end_node, end_node=r.start_node,
        type=r.type, properties=dict(r.properties),
    ))


@register("apoc.rel.isAnyType")
def rel_is_any_type(rel, types):
    return isinstance(rel, Edge) and rel.type in (types or [])


@register("apoc.rel.hasProperty")
def rel_has_property(rel, key):
    return isinstance(rel, Edge) and key in rel.properties


@register("apoc.rel.hasProperties")
def rel_has_properties(rel, keys):
    return isinstance(rel, Edge) and all(k in rel.properties
                                         for k in (keys or []))


@register("apoc.rel.equals")
def rel_equals(r1, r2):
    if not isinstance(r1, Edge) or not isinstance(r2, Edge):
        return False
    return (r1.type == r2.type and r1.start_node == r2.start_node
            and r1.end_node == r2.end_node and r1.properties == r2.properties)


@register("apoc.rel.compare")
def rel_compare(r1, r2):
    return {
        "sameType": isinstance(r1, Edge) and isinstance(r2, Edge)
        and r1.type == r2.type,
        "sameEndpoints": isinstance(r1, Edge) and isinstance(r2, Edge)
        and (r1.start_node, r1.end_node) == (r2.start_node, r2.end_node),
        "equal": rel_equals(r1, r2),
    }


@register("apoc.rel.weight")
def rel_weight(rel, prop="weight", default=1.0):
    if not isinstance(rel, Edge):
        return None
    v = rel.properties.get(prop, default)
    return float(v) if isinstance(v, (int, float)) else default


@register("apoc.rel.direction")
def rel_direction(rel, node):
    nid = node.id if isinstance(node, Node) else str(node)
    if not isinstance(rel, Edge):
        return None
    if rel.start_node == nid:
        return "OUT"
    if rel.end_node == nid:
        return "IN"
    return None


@_graph_fn("apoc.rel.otherNode")
def rel_other_node(ex, rel, node):
    r = _edge(ex, rel)
    nid = node.id if isinstance(node, Node) else str(node)
    other = r.end_node if r.start_node == nid else r.start_node
    return ex.get_node_or_none(other)


@register("apoc.rel.isBetween")
def rel_is_between(rel, n1, n2):
    a = n1.id if isinstance(n1, Node) else str(n1)
    b = n2.id if isinstance(n2, Node) else str(n2)
    return isinstance(rel, Edge) and {rel.start_node, rel.end_node} == {a, b}


@register("apoc.rel.isDirectedBetween")
def rel_is_directed_between(rel, from_n, to_n):
    a = from_n.id if isinstance(from_n, Node) else str(from_n)
    b = to_n.id if isinstance(to_n, Node) else str(to_n)
    return isinstance(rel, Edge) and rel.start_node == a and rel.end_node == b


# ============================================================= apoc.label
@_graph_fn("apoc.label.list")
def label_list(ex):
    labels = set()
    for n in ex.storage.all_nodes():
        labels.update(n.labels)
    return sorted(labels)


@_graph_fn("apoc.label.count")
def label_count(ex, label):
    return ex.storage.count_nodes_by_label(label)


@_graph_fn("apoc.label.nodes")
def label_nodes(ex, label):
    return sorted(ex.storage.get_nodes_by_label(label), key=lambda n: n.id)


@_graph_fn("apoc.label.add")
def label_add(ex, node, label):
    return node_add_label(ex, node, label)


@_graph_fn("apoc.label.remove")
def label_remove(ex, node, label):
    return node_remove_label(ex, node, label)


@_graph_fn("apoc.label.replace")
def label_replace(ex, node, old_labels, new_labels):
    n = _node(ex, node)
    drop = set(old_labels or [])
    n.labels = [l for l in n.labels if l not in drop]
    for lbl in new_labels or []:
        if lbl not in n.labels:
            n.labels.append(lbl)
    return _save_node(ex, n)


@register("apoc.label.has")
def label_has(node, label):
    return isinstance(node, Node) and label in node.labels


@register("apoc.label.hasAny")
def label_has_any(node, labels):
    return isinstance(node, Node) and any(l in node.labels
                                          for l in (labels or []))


@register("apoc.label.hasAll")
def label_has_all(node, labels):
    return isinstance(node, Node) and all(l in node.labels
                                          for l in (labels or []))


@register("apoc.label.get")
def label_get(node):
    return list(node.labels) if isinstance(node, Node) else None


@_graph_fn("apoc.label.set")
def label_set(ex, node, labels):
    n = _node(ex, node)
    n.labels = list(labels or [])
    return _save_node(ex, n)


@_graph_fn("apoc.label.clear")
def label_clear(ex, node):
    return label_set(ex, node, [])


@_graph_fn("apoc.label.merge")
def label_merge(ex, node, labels):
    return node_add_labels(ex, node, labels)


@register("apoc.label.diff")
def label_diff(n1, n2):
    l1 = set(n1.labels) if isinstance(n1, Node) else set()
    l2 = set(n2.labels) if isinstance(n2, Node) else set()
    return {"onlyLeft": sorted(l1 - l2), "onlyRight": sorted(l2 - l1),
            "common": sorted(l1 & l2)}


@register("apoc.label.union")
def label_union(n1, n2):
    l1 = set(n1.labels) if isinstance(n1, Node) else set()
    l2 = set(n2.labels) if isinstance(n2, Node) else set()
    return sorted(l1 | l2)


@register("apoc.label.intersection")
def label_intersection(n1, n2):
    l1 = set(n1.labels) if isinstance(n1, Node) else set()
    l2 = set(n2.labels) if isinstance(n2, Node) else set()
    return sorted(l1 & l2)


@register("apoc.label.compare")
def label_compare(n1, n2):
    d = label_diff(n1, n2)
    return {**d, "equal": not d["onlyLeft"] and not d["onlyRight"]}


@register("apoc.label.validate")
def label_validate(label):
    """Valid Cypher label: identifier-shaped (ref label.go Validate)."""
    return bool(re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(label or "")))


@register("apoc.label.normalize")
def label_normalize(label):
    """PascalCase normalization: 'person name' -> 'PersonName'."""
    parts = re.split(r"[\s_\-]+", str(label or "").strip())
    return "".join(p[:1].upper() + p[1:] for p in parts if p)


@register("apoc.label.toString")
def label_to_string(labels):
    return ":".join(labels or [])


@register("apoc.label.fromString")
def label_from_string(s):
    return [p for p in str(s or "").split(":") if p]


@register("apoc.label.pattern")
def label_pattern(label):
    return f"(:{label})"


@register("apoc.label.fromPattern")
def label_from_pattern(pattern):
    return re.findall(r":([A-Za-z_][A-Za-z0-9_]*)", str(pattern or ""))


@register("apoc.label.format")
def label_format(label, style="pascal"):
    s = str(label or "")
    parts = [p for p in re.split(r"[\s_\-]+|(?<=[a-z])(?=[A-Z])", s) if p]
    style = str(style).lower()
    if style in ("pascal", "label"):
        return "".join(p[:1].upper() + p[1:].lower() for p in parts)
    if style == "camel":
        out = "".join(p[:1].upper() + p[1:].lower() for p in parts)
        return out[:1].lower() + out[1:]
    if style in ("snake", "snake_case"):
        return "_".join(p.lower() for p in parts)
    if style in ("upper", "constant"):
        return "_".join(p.upper() for p in parts)
    return s


@_graph_fn("apoc.label.search")
def label_search(ex, pattern):
    return [l for l in label_list(ex) if fnmatch.fnmatch(l, str(pattern))]


@_graph_fn("apoc.label.stats")
def label_stats(ex):
    counts: dict[str, int] = {}
    for n in ex.storage.all_nodes():
        for l in n.labels:
            counts[l] = counts.get(l, 0) + 1
    return counts


# ============================================================ apoc.nodes
@_graph_fn("apoc.nodes.get")
def nodes_get(ex, ids):
    return [n for i in (ids or []) if (n := ex.get_node_or_none(str(i)))]


@_graph_fn("apoc.nodes.delete")
def nodes_delete(ex, nodes):
    count = 0
    for v in nodes or []:
        nid = v.id if isinstance(v, Node) else str(v)
        try:
            ex.storage.delete_node(nid)
            count += 1
        except NotFoundError:
            continue
    return count


@_graph_fn("apoc.nodes.link")
def nodes_link(ex, nodes, rel_type):
    """Chain nodes with rel_type in list order (ref nodes.go Link)."""
    out = []
    seq = [_node(ex, v) for v in (nodes or [])]
    for a, b in zip(seq, seq[1:]):
        out.append(ex.storage.create_edge(Edge(
            id=f"apoc-{_uuid.uuid4()}", start_node=a.id, end_node=b.id,
            type=str(rel_type), properties={},
        )))
    return out


@register("apoc.nodes.distinct")
def nodes_distinct(nodes):
    seen: dict[str, Node] = {}
    for n in nodes or []:
        if isinstance(n, Node) and n.id not in seen:
            seen[n.id] = n
    return list(seen.values())


@_graph_fn("apoc.nodes.connected")
def nodes_connected(ex, n1, n2, rel_type=None):
    return node_connected(ex, n1, n2, rel_type)


@_graph_fn("apoc.nodes.isDense")
def nodes_is_dense(ex, node, threshold=50):
    return node_is_dense(ex, node, threshold)


@_graph_fn("apoc.nodes.relationships")
def nodes_relationships(ex, node):
    return node_relationships(ex, node)


@_graph_fn("apoc.nodes.distinctRels")
def nodes_distinct_rels(ex, node):
    seen: dict[str, Edge] = {}
    for r in node_relationships(ex, node):
        seen.setdefault(r.id, r)
    return list(seen.values())


@register("apoc.nodes.intersect")
def nodes_intersect(nodes1, nodes2):
    ids2 = {n.id for n in (nodes2 or []) if isinstance(n, Node)}
    return [n for n in nodes_distinct(nodes1) if n.id in ids2]


@register("apoc.nodes.union")
def nodes_union(nodes1, nodes2):
    return nodes_distinct(list(nodes1 or []) + list(nodes2 or []))


@register("apoc.nodes.difference")
def nodes_difference(nodes1, nodes2):
    ids2 = {n.id for n in (nodes2 or []) if isinstance(n, Node)}
    return [n for n in nodes_distinct(nodes1) if n.id not in ids2]


@register("apoc.nodes.sort")
def nodes_sort(nodes, prop, descending=False):
    def key(n):
        v = n.properties.get(prop)
        return (v is None, v if isinstance(v, (int, float)) else str(v))

    return sorted([n for n in (nodes or []) if isinstance(n, Node)],
                  key=key, reverse=bool(descending))


@_graph_fn("apoc.nodes.filter")
def nodes_filter(ex, nodes, predicate):
    """predicate: Cypher expression over `n` (e.g. 'n.age > 30')."""
    return [n for n in (nodes or [])
            if _eval_pred(ex, predicate, {"n": n}) is True]


@_graph_fn("apoc.nodes.partition")
def nodes_partition(ex, nodes, predicate):
    yes, no = [], []
    for n in nodes or []:
        (yes if _eval_pred(ex, predicate, {"n": n}) is True else no).append(n)
    return [yes, no]


@_graph_fn("apoc.nodes.map")
def nodes_map(ex, nodes, expr):
    """expr: Cypher expression over `n` (e.g. 'n.name')."""
    return [_eval_pred(ex, expr, {"n": n}) for n in (nodes or [])]


@_graph_fn("apoc.nodes.reduce")
def nodes_reduce(ex, nodes, expr, init=None):
    """expr over `acc` and `n` (e.g. 'acc + n.age')."""
    acc = init
    for n in nodes or []:
        acc = _eval_pred(ex, expr, {"acc": acc, "n": n})
    return acc


@register("apoc.nodes.toMap")
def nodes_to_map(nodes):
    return {n.id: node_to_map(n) for n in (nodes or [])
            if isinstance(n, Node)}


@_graph_fn("apoc.nodes.fromMap")
def nodes_from_map(ex, m):
    return [node_from_map(ex, spec) for spec in (m or {}).values()]


@_graph_fn("apoc.nodes.batch")
def nodes_batch(ex, nodes, batch_size, expr):
    """Apply `expr` (over `batch`) to size-batches; returns per-batch
    results."""
    nodes = list(nodes or [])
    size = max(int(batch_size), 1)
    return [
        _eval_pred(ex, expr, {"batch": nodes[i:i + size]})
        for i in range(0, len(nodes), size)
    ]


@_graph_fn("apoc.nodes.collapse")
def nodes_collapse(ex, nodes):
    """Merge nodes into the first: union labels/properties, rewire rels
    (ref refactor.mergeNodes)."""
    seq = [_node(ex, v) for v in (nodes or [])]
    if not seq:
        return None
    target = seq[0]
    for other in seq[1:]:
        for lbl in other.labels:
            if lbl not in target.labels:
                target.labels.append(lbl)
        for k, v in other.properties.items():
            target.properties.setdefault(k, v)
        for r in ex.storage.get_outgoing_edges(other.id):
            ex.storage.delete_edge(r.id)
            if r.end_node != target.id:
                ex.storage.create_edge(Edge(
                    id=r.id, start_node=target.id, end_node=r.end_node,
                    type=r.type, properties=dict(r.properties)))
        for r in ex.storage.get_incoming_edges(other.id):
            try:
                ex.storage.delete_edge(r.id)
            except NotFoundError:
                continue  # self-loop already rewired above
            if r.start_node != target.id:
                ex.storage.create_edge(Edge(
                    id=r.id, start_node=r.start_node, end_node=target.id,
                    type=r.type, properties=dict(r.properties)))
        ex.storage.delete_node(other.id)
    return _save_node(ex, target)


@_graph_fn("apoc.nodes.group")
def nodes_group(ex, labels, props):
    """Group nodes carrying `labels` by the given property values; returns
    [{values, count, ids}] (ref nodes.go Group shape)."""
    props = list(props or [])
    groups: dict[tuple, dict] = {}
    for label in labels or []:
        for n in ex.storage.get_nodes_by_label(label):
            key = tuple(repr(n.properties.get(p)) for p in props)
            g = groups.setdefault(key, {
                "values": {p: n.properties.get(p) for p in props},
                "count": 0, "ids": [],
            })
            g["count"] += 1
            g["ids"].append(n.id)
    return list(groups.values())


@_graph_fn("apoc.nodes.cycles")
def nodes_cycles(ex, nodes, rel_type=None):
    """Directed cycles among the given nodes (bounded DFS)."""
    idset = {(_node(ex, v)).id for v in (nodes or [])}
    cycles = []
    for start in sorted(idset):
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for r in ex.storage.get_outgoing_edges(cur):
                if rel_type is not None and r.type != rel_type:
                    continue
                nxt = r.end_node
                if nxt == start and len(path) > 1:
                    if min(path) == start:  # canonical: smallest id first
                        cycles.append(path)
                elif nxt in idset and nxt not in path and len(path) < 16:
                    stack.append((nxt, path + [nxt]))
    return cycles


# ========================================================= apoc.neighbors
def _hop_sets(ex, node, rel_type, max_hops):
    nid = _node(ex, node).id
    frontier = {nid}
    seen = {nid}
    levels = []
    for _ in range(int(max_hops)):
        nxt = set()
        for cur in frontier:
            for r in ex.storage.get_outgoing_edges(cur):
                if rel_type in (None, "") or r.type == rel_type:
                    nxt.add(r.end_node)
            for r in ex.storage.get_incoming_edges(cur):
                if rel_type in (None, "") or r.type == rel_type:
                    nxt.add(r.start_node)
        nxt -= seen
        seen |= nxt
        levels.append(nxt)
        frontier = nxt
        if not nxt:
            break
    return levels


@_graph_fn("apoc.neighbors.atHop")
def neighbors_at_hop(ex, node, rel_type, hop):
    levels = _hop_sets(ex, node, rel_type, int(hop))
    ids = levels[int(hop) - 1] if len(levels) >= int(hop) else set()
    return [n for i in sorted(ids) if (n := ex.get_node_or_none(i))]


@_graph_fn("apoc.neighbors.toHop")
def neighbors_to_hop(ex, node, rel_type, hop):
    ids: set = set()
    for level in _hop_sets(ex, node, rel_type, int(hop)):
        ids |= level
    return [n for i in sorted(ids) if (n := ex.get_node_or_none(i))]


@_graph_fn("apoc.neighbors.bfs")
def neighbors_bfs(ex, node, rel_type=None, max_hops=10):
    return neighbors_to_hop(ex, node, rel_type, max_hops)


@_graph_fn("apoc.neighbors.dfs")
def neighbors_dfs(ex, node, rel_type=None, max_hops=10):
    """DFS preorder of reachable neighbors (directed out + in)."""
    nid = _node(ex, node).id
    seen = {nid}
    order = []
    stack = [(nid, 0)]
    while stack:
        cur, depth = stack.pop()
        if depth >= int(max_hops):
            continue
        nbrs = set()
        for r in ex.storage.get_outgoing_edges(cur):
            if rel_type in (None, "") or r.type == rel_type:
                nbrs.add(r.end_node)
        for r in ex.storage.get_incoming_edges(cur):
            if rel_type in (None, "") or r.type == rel_type:
                nbrs.add(r.start_node)
        for nxt in sorted(nbrs, reverse=True):
            if nxt not in seen:
                seen.add(nxt)
                order.append(nxt)
                stack.append((nxt, depth + 1))
    return [n for i in order if (n := ex.get_node_or_none(i))]


@_graph_fn("apoc.neighbors.count")
def neighbors_count(ex, node, rel_type=None):
    ids = _neighbor_ids(ex, node, "both")
    if rel_type not in (None, ""):
        nid = _node(ex, node).id
        ids = set()
        for r in _rels_of(ex, node, "both"):
            if r.type == rel_type:
                ids.add(r.end_node if r.start_node == nid else r.start_node)
    return len(ids)


@_graph_fn("apoc.neighbors.exists")
def neighbors_exists(ex, node, rel_type=None):
    return neighbors_count(ex, node, rel_type) > 0


# ============================================================ apoc.atomic
# (ref apoc/atomic/atomic.go — process-wide mutex around read-modify-write)
@_graph_fn("apoc.atomic.increment")
def atomic_increment(ex, node, prop, delta=1):
    with _atomic_lock:
        n = _node(ex, node)
        cur = n.properties.get(prop, 0)
        n.properties[prop] = (cur if isinstance(cur, (int, float)) else 0) + delta
        _save_node(ex, n)
        return n.properties[prop]


@_graph_fn("apoc.atomic.decrement")
def atomic_decrement(ex, node, prop, delta=1):
    return atomic_increment(ex, node, prop, -delta)


@_graph_fn("apoc.atomic.update")
def atomic_update(ex, node, prop, value):
    with _atomic_lock:
        n = _node(ex, node)
        n.properties[prop] = value
        _save_node(ex, n)
        return value


@_graph_fn("apoc.atomic.remove")
def atomic_remove(ex, node, prop, index=None):
    """Remove a property, or one index from a list property."""
    with _atomic_lock:
        n = _node(ex, node)
        if index is None or not isinstance(n.properties.get(prop), list):
            n.properties.pop(prop, None)
            _save_node(ex, n)
            return None
        lst = list(n.properties[prop])
        i = int(index)
        if 0 <= i < len(lst):
            lst.pop(i)
        n.properties[prop] = lst
        _save_node(ex, n)
        return lst


@_graph_fn("apoc.atomic.compareAndSwap")
def atomic_cas(ex, node, prop, old, new):
    with _atomic_lock:
        n = _node(ex, node)
        if n.properties.get(prop) != old:
            return False
        n.properties[prop] = new
        _save_node(ex, n)
        return True
