"""APOC graph-access categories, part 2: meta / schema / search / create /
merge / graph / cypher / community / algo / paths / path (the port's copy
of ``nornicdb_tpu/apoc/functions_graph2.py``).

Behavioral reference: upstream NornicDB apoc/apoc.go registerAllFunctions +
per-category dirs. community/algo delegate to ops/graph_algos.py (the same
functions as gds.*): PageRank and weakly connected components run on the
executor's device after the device owner's gate, as gds.* does; the
reference's own exotic variants alias the basic ones the same way
(community.go:810 InfoMap -> LabelPropagation, :1063 WalkTrap -> FastGreedy).
Community results use {nodeId: communityId} maps; path results are node-id
lists — the value-level twins of the procedure forms.
"""

from __future__ import annotations

import json as _json
import re
import uuid as _uuid
from typing import Any, Optional

import numpy as np

from nornicdb_tpu_torch.apoc.functions_graph import (
    _edge,
    _eval_pred,
    _graph_fn,
    _node,
    node_to_map,
    rel_to_map,
)
from nornicdb_tpu_torch.apoc.registry import register
from nornicdb_tpu_torch.errors import NornicError, NotFoundError
from nornicdb_tpu_torch.storage.types import Edge, Node

# ============================================================== apoc.meta


def _cypher_type(v) -> str:
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
        if {"nodes", "relationships"} <= set(v.keys()):
            return "PATH"
        return "MAP"
    return type(v).__name__.upper()


@register("apoc.meta.typeOf")
@register("apoc.meta.cypherType")
def meta_type_of(v):
    return _cypher_type(v)


@register("apoc.meta.types")
@register("apoc.meta.cypherTypes")
def meta_types(m):
    return {k: _cypher_type(v) for k, v in (m or {}).items()}


@register("apoc.meta.isNode")
def meta_is_node(v):
    return isinstance(v, Node)


@register("apoc.meta.isRelationship")
def meta_is_relationship(v):
    return isinstance(v, Edge)


@register("apoc.meta.isPath")
def meta_is_path(v):
    return isinstance(v, dict) and {"nodes", "relationships"} <= set(v.keys())


@_graph_fn("apoc.meta.nodeLabels")
def meta_node_labels(ex):
    labels: set = set()
    for n in ex.storage.all_nodes():
        labels.update(n.labels)
    return sorted(labels)


@_graph_fn("apoc.meta.relTypes")
def meta_rel_types(ex):
    return sorted({e.type for e in ex.storage.all_edges()})


@_graph_fn("apoc.meta.propertyKeys")
def meta_property_keys(ex):
    keys: set = set()
    for n in ex.storage.all_nodes():
        keys.update(n.properties.keys())
    for e in ex.storage.all_edges():
        keys.update(e.properties.keys())
    return sorted(keys)


@_graph_fn("apoc.meta.stats")
def meta_stats(ex):
    label_counts: dict[str, int] = {}
    for n in ex.storage.all_nodes():
        for l in n.labels:
            label_counts[l] = label_counts.get(l, 0) + 1
    type_counts: dict[str, int] = {}
    for e in ex.storage.all_edges():
        type_counts[e.type] = type_counts.get(e.type, 0) + 1
    return {
        "nodeCount": ex.storage.node_count(),
        "relCount": ex.storage.edge_count(),
        "labels": label_counts,
        "relTypes": type_counts,
        "labelCount": len(label_counts),
        "relTypeCount": len(type_counts),
    }


@_graph_fn("apoc.meta.graph")
def meta_graph(ex):
    """Label-level meta graph: nodes = labels, rels = observed
    (label)-[type]->(label) triples (ref meta.go Graph)."""
    rels: set = set()
    for e in ex.storage.all_edges():
        s = ex.get_node_or_none(e.start_node)
        t = ex.get_node_or_none(e.end_node)
        for sl in (s.labels if s else ["?"]):
            for tl in (t.labels if t else ["?"]):
                rels.add((sl, e.type, tl))
    return {
        "nodes": meta_node_labels(ex),
        "relationships": [
            {"start": s, "type": t, "end": d} for s, t, d in sorted(rels)
        ],
    }


@_graph_fn("apoc.meta.graphSample")
def meta_graph_sample(ex, sample=100):
    """Meta graph from the first `sample` edges."""
    rels: set = set()
    for i, e in enumerate(ex.storage.all_edges()):
        if i >= int(sample):
            break
        s = ex.get_node_or_none(e.start_node)
        t = ex.get_node_or_none(e.end_node)
        for sl in (s.labels if s else ["?"]):
            for tl in (t.labels if t else ["?"]):
                rels.add((sl, e.type, tl))
    return {"relationships": [
        {"start": s, "type": t, "end": d} for s, t, d in sorted(rels)]}


@_graph_fn("apoc.meta.subGraph")
def meta_subgraph(ex, config=None):
    """Meta graph restricted to config {labels: [...], rels: [...]}."""
    cfg = config or {}
    want_labels = set(cfg.get("labels") or [])
    want_types = set(cfg.get("rels") or cfg.get("relTypes") or [])
    full = meta_graph(ex)
    rels = [
        r for r in full["relationships"]
        if (not want_types or r["type"] in want_types)
        and (not want_labels
             or (r["start"] in want_labels and r["end"] in want_labels))
    ]
    nodes = sorted({r["start"] for r in rels} | {r["end"] for r in rels}
                   | (want_labels & set(full["nodes"])))
    return {"nodes": nodes, "relationships": rels}


@_graph_fn("apoc.meta.cardinality")
def meta_cardinality(ex, label):
    return ex.storage.count_nodes_by_label(label)


@_graph_fn("apoc.meta.constraints")
def meta_constraints(ex):
    return [
        {"name": c.name, "label": c.label, "properties": list(c.properties),
         "kind": c.kind}
        for c in ex.schema.list_constraints()
    ]


@_graph_fn("apoc.meta.indexes")
def meta_indexes(ex):
    return [
        {"name": i.name, "kind": i.kind, "label": i.label,
         "properties": list(i.properties)}
        for i in ex.schema.list_indexes()
    ]


@_graph_fn("apoc.meta.functions")
def meta_functions(ex):
    from nornicdb_tpu_torch.apoc.registry import all_functions

    return all_functions()


@_graph_fn("apoc.meta.procedures")
def meta_procedures(ex):
    from nornicdb_tpu_torch.cypher.executor import PROCEDURES

    return sorted(PROCEDURES)


@register("apoc.meta.version")
def meta_version():
    import nornicdb_tpu_torch

    return getattr(nornicdb_tpu_torch, "__version__", "0.2.0")


@register("apoc.meta.config")
def meta_config():
    from nornicdb_tpu_torch.apoc.registry import categories

    return {"categories": categories()}


@_graph_fn("apoc.meta.export")
@_graph_fn("apoc.meta.snapshot")
def meta_export(ex):
    """Schema snapshot: labels/types/keys + declared indexes/constraints."""
    return {
        "labels": meta_node_labels(ex),
        "relTypes": meta_rel_types(ex),
        "propertyKeys": meta_property_keys(ex),
        "indexes": meta_indexes(ex),
        "constraints": meta_constraints(ex),
    }


@_graph_fn("apoc.meta.import")
@_graph_fn("apoc.meta.restore")
def meta_import(ex, snapshot):
    """Recreate declared indexes/constraints from a meta.export snapshot."""
    created = {"indexes": 0, "constraints": 0}
    for i in (snapshot or {}).get("indexes", []):
        ex.schema.create_index(
            i["name"], i.get("kind", "property"), i["label"],
            list(i["properties"]), if_not_exists=True,
        )
        created["indexes"] += 1
    for c in (snapshot or {}).get("constraints", []):
        ex.schema.create_constraint(
            c["name"], c["label"], list(c["properties"]),
            kind=c.get("kind", "unique"), if_not_exists=True,
        )
        created["constraints"] += 1
    return created


@register("apoc.meta.compare")
@register("apoc.meta.diff")
def meta_compare(s1, s2):
    out = {}
    for key in ("labels", "relTypes", "propertyKeys"):
        a = set((s1 or {}).get(key) or [])
        b = set((s2 or {}).get(key) or [])
        out[key] = {"onlyLeft": sorted(a - b), "onlyRight": sorted(b - a)}
    return out


@register("apoc.meta.validate")
def meta_validate(schema):
    return isinstance(schema, dict) and all(
        isinstance(schema.get(k, []), list)
        for k in ("labels", "relTypes", "propertyKeys")
    )


@_graph_fn("apoc.meta.analyze")
def meta_analyze(ex):
    stats = meta_stats(ex)
    n = stats["nodeCount"]
    return {
        **stats,
        "avgDegree": (2.0 * stats["relCount"] / n) if n else 0.0,
        "propertyKeyCount": len(meta_property_keys(ex)),
    }


@_graph_fn("apoc.meta.pattern")
def meta_pattern(ex):
    g = meta_graph(ex)
    return [f"(:{r['start']})-[:{r['type']}]->(:{r['end']})"
            for r in g["relationships"]]


@_graph_fn("apoc.meta.toString")
def meta_to_string(ex):
    return _json.dumps(meta_export(ex), sort_keys=True)


@register("apoc.meta.fromString")
def meta_from_string(s):
    return _json.loads(s)


# ============================================================ apoc.schema
@_graph_fn("apoc.schema.labels")
def schema_labels(ex):
    return meta_node_labels(ex)


@_graph_fn("apoc.schema.types")
def schema_types(ex):
    return meta_rel_types(ex)


@_graph_fn("apoc.schema.nodeConstraints")
def schema_node_constraints(ex):
    return meta_constraints(ex)


@_graph_fn("apoc.schema.nodeIndexes")
def schema_node_indexes(ex):
    return meta_indexes(ex)


@_graph_fn("apoc.schema.relationshipConstraints")
def schema_rel_constraints(ex):
    return []  # relationship constraints are not part of the schema manager


@_graph_fn("apoc.schema.relationshipIndexes")
def schema_rel_indexes(ex):
    return []


@_graph_fn("apoc.schema.info")
def schema_info(ex):
    return {"indexes": meta_indexes(ex), "constraints": meta_constraints(ex)}


def _index_name(label, props):
    return f"idx_{label}_{'_'.join(props)}"


@_graph_fn("apoc.schema.createIndex")
def schema_create_index(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    idx = ex.schema.create_index(
        _index_name(label, props),
        "composite" if len(props) > 1 else "property",
        label, props, if_not_exists=True,
    )
    return {"name": idx.name, "label": idx.label,
            "properties": list(idx.properties)}


@_graph_fn("apoc.schema.dropIndex")
def schema_drop_index(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    ex.schema.drop_index(_index_name(label, props), if_exists=True)
    return True


@_graph_fn("apoc.schema.createConstraint")
@_graph_fn("apoc.schema.createUniqueConstraint")
def schema_create_constraint(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    c = ex.schema.create_constraint(
        f"constraint_{label}_{'_'.join(props)}", label, props,
        if_not_exists=True,
    )
    return {"name": c.name, "label": c.label, "properties": list(c.properties),
            "kind": c.kind}


@_graph_fn("apoc.schema.createExistsConstraint")
def schema_create_exists_constraint(ex, label, prop):
    c = ex.schema.create_constraint(
        f"exists_{label}_{prop}", label, [prop], kind="exists",
        if_not_exists=True,
    )
    return {"name": c.name, "label": c.label, "kind": c.kind}


@_graph_fn("apoc.schema.createNodeKeyConstraint")
def schema_create_node_key(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    c = ex.schema.create_constraint(
        f"nodekey_{label}_{'_'.join(props)}", label, props, kind="node_key",
        if_not_exists=True,
    )
    return {"name": c.name, "label": c.label, "kind": c.kind}


@_graph_fn("apoc.schema.dropConstraint")
def schema_drop_constraint(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    for prefix in ("constraint", "nodekey"):
        ex.schema.drop_constraint(
            f"{prefix}_{label}_{'_'.join(props)}", if_exists=True)
    if len(props) == 1:
        ex.schema.drop_constraint(f"exists_{label}_{props[0]}", if_exists=True)
    return True


@_graph_fn("apoc.schema.nodeConstraintExists")
def schema_constraint_exists(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    return any(
        c.label == label and list(c.properties) == props
        for c in ex.schema.list_constraints()
    )


@_graph_fn("apoc.schema.nodeIndexExists")
def schema_index_exists(ex, label, properties):
    props = [properties] if isinstance(properties, str) else list(properties)
    return ex.schema.find_index(label, props) is not None


@_graph_fn("apoc.schema.properties")
def schema_properties(ex, label):
    keys: set = set()
    for n in ex.storage.get_nodes_by_label(label):
        keys.update(n.properties.keys())
    return sorted(keys)


@_graph_fn("apoc.schema.propertiesDistinct")
def schema_properties_distinct(ex, label, prop):
    vals = []
    seen = set()
    for n in ex.storage.get_nodes_by_label(label):
        v = n.properties.get(prop)
        k = repr(v)
        if v is not None and k not in seen:
            seen.add(k)
            vals.append(v)
    try:
        return sorted(vals)
    except TypeError:
        return sorted(vals, key=repr)


@_graph_fn("apoc.schema.export")
@_graph_fn("apoc.schema.snapshot")
def schema_export(ex):
    return schema_info(ex)


@_graph_fn("apoc.schema.import")
@_graph_fn("apoc.schema.restore")
def schema_import(ex, snapshot):
    return meta_import(ex, snapshot)


@register("apoc.schema.compare")
def schema_compare(s1, s2):
    def names(s, key):
        return {i.get("name") for i in (s or {}).get(key, [])}

    return {
        key: {"onlyLeft": sorted(names(s1, key) - names(s2, key)),
              "onlyRight": sorted(names(s2, key) - names(s1, key))}
        for key in ("indexes", "constraints")
    }


@_graph_fn("apoc.schema.validate")
def schema_validate(ex):
    """Checks every unique constraint actually holds (ref schema.go
    Validate); returns violations."""
    violations = []
    for c in ex.schema.list_constraints():
        if c.kind not in ("unique", "node_key"):
            continue
        seen: dict = {}
        for n in ex.storage.get_nodes_by_label(c.label):
            key = tuple(repr(n.properties.get(p)) for p in c.properties)
            if all(n.properties.get(p) is not None for p in c.properties):
                if key in seen:
                    violations.append({
                        "constraint": c.name, "nodes": [seen[key], n.id]})
                seen[key] = n.id
    return {"valid": not violations, "violations": violations}


@_graph_fn("apoc.schema.stats")
def schema_stats(ex):
    return {
        "indexCount": len(ex.schema.list_indexes()),
        "constraintCount": len(ex.schema.list_constraints()),
    }


@_graph_fn("apoc.schema.analyze")
def schema_analyze(ex):
    """Suggest indexes for labels with many nodes but none declared."""
    suggestions = []
    for label in meta_node_labels(ex):
        count = ex.storage.count_nodes_by_label(label)
        has = any(i.label == label for i in ex.schema.list_indexes())
        if count >= 100 and not has:
            suggestions.append({"label": label, "count": count,
                                "suggestion": "add an index"})
    return {"suggestions": suggestions, **schema_stats(ex)}


@_graph_fn("apoc.schema.optimize")
def schema_optimize(ex):
    """No-op optimizer (indexes here are maintained eagerly); reports what
    analyze would."""
    return {"optimized": 0, **schema_analyze(ex)}


@_graph_fn("apoc.schema.assert")
def schema_assert(ex, indexes, constraints):
    """Declarative sync (ref schema.go Assert): maps {label: [props...]}."""
    out = []
    for label, props_list in (indexes or {}).items():
        for props in props_list:
            props = [props] if isinstance(props, str) else list(props)
            schema_create_index(ex, label, props)
            out.append({"label": label, "key": props, "unique": False})
    for label, props_list in (constraints or {}).items():
        for props in props_list:
            props = [props] if isinstance(props, str) else list(props)
            schema_create_constraint(ex, label, props)
            out.append({"label": label, "key": props, "unique": True})
    return out


# ============================================================ apoc.search
def _label_nodes(ex, label):
    return sorted(ex.storage.get_nodes_by_label(label), key=lambda n: n.id)


@_graph_fn("apoc.search.node")
def search_node(ex, label, prop, value):
    return [n for n in _label_nodes(ex, label)
            if n.properties.get(prop) == value]


@_graph_fn("apoc.search.nodeAll")
def search_node_all(ex, label, props):
    return [
        n for n in _label_nodes(ex, label)
        if all(n.properties.get(k) == v for k, v in (props or {}).items())
    ]


@_graph_fn("apoc.search.nodeAny")
def search_node_any(ex, label, props):
    return [
        n for n in _label_nodes(ex, label)
        if any(n.properties.get(k) == v for k, v in (props or {}).items())
    ]


@_graph_fn("apoc.search.nodeReduced")
def search_node_reduced(ex, label, props):
    """Matching nodes reduced to {id, labels} (ref search.go NodeReduced)."""
    return [{"id": n.id, "labels": list(n.labels)}
            for n in search_node_all(ex, label, props)]


@_graph_fn("apoc.search.regex")
def search_regex(ex, label, prop, pattern):
    # bounded engine (see cypher/expr.py): a catastrophic pattern over a
    # large label must error, not wedge the query thread
    from nornicdb_tpu_torch.cypher.expr import _compiled

    pat = _compiled(str(pattern))
    return [n for n in _label_nodes(ex, label)
            if isinstance(n.properties.get(prop), str)
            and pat.fullmatch(n.properties[prop])]


@_graph_fn("apoc.search.prefix")
def search_prefix(ex, label, prop, prefix):
    return [n for n in _label_nodes(ex, label)
            if isinstance(n.properties.get(prop), str)
            and n.properties[prop].startswith(str(prefix))]


@_graph_fn("apoc.search.suffix")
def search_suffix(ex, label, prop, suffix):
    return [n for n in _label_nodes(ex, label)
            if isinstance(n.properties.get(prop), str)
            and n.properties[prop].endswith(str(suffix))]


@_graph_fn("apoc.search.contains")
def search_contains(ex, label, prop, needle):
    return [n for n in _label_nodes(ex, label)
            if isinstance(n.properties.get(prop), str)
            and str(needle) in n.properties[prop]]


@_graph_fn("apoc.search.match")
def search_match(ex, label, prop, glob):
    import fnmatch

    return [n for n in _label_nodes(ex, label)
            if isinstance(n.properties.get(prop), str)
            and fnmatch.fnmatch(n.properties[prop], str(glob))]


@_graph_fn("apoc.search.range")
def search_range(ex, label, prop, lo, hi):
    out = []
    for n in _label_nodes(ex, label):
        v = n.properties.get(prop)
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and lo <= v <= hi:
            out.append(n)
    return out


@_graph_fn("apoc.search.in")
def search_in(ex, label, prop, values):
    vals = list(values or [])
    return [n for n in _label_nodes(ex, label)
            if n.properties.get(prop) in vals]


@_graph_fn("apoc.search.notIn")
def search_not_in(ex, label, prop, values):
    vals = list(values or [])
    return [n for n in _label_nodes(ex, label)
            if n.properties.get(prop) not in vals]


@_graph_fn("apoc.search.exists")
@_graph_fn("apoc.search.notNull")
def search_exists(ex, label, prop):
    return [n for n in _label_nodes(ex, label)
            if n.properties.get(prop) is not None]


@_graph_fn("apoc.search.missing")
@_graph_fn("apoc.search.null")
def search_missing(ex, label, prop):
    return [n for n in _label_nodes(ex, label)
            if n.properties.get(prop) is None]


def _lev(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@_graph_fn("apoc.search.fuzzy")
def search_fuzzy(ex, label, prop, query, max_distance=2):
    q = str(query).lower()
    out = []
    for n in _label_nodes(ex, label):
        v = n.properties.get(prop)
        if isinstance(v, str) and _lev(v.lower(), q) <= int(max_distance):
            out.append(n)
    return out


@_graph_fn("apoc.search.didYouMean")
def search_did_you_mean(ex, label, prop, query):
    best, best_d = None, None
    q = str(query).lower()
    for n in _label_nodes(ex, label):
        v = n.properties.get(prop)
        if isinstance(v, str):
            d = _lev(v.lower(), q)
            if best_d is None or d < best_d:
                best, best_d = v, d
    return best


@_graph_fn("apoc.search.suggest")
@_graph_fn("apoc.search.autocomplete")
def search_suggest(ex, label, prop, prefix, limit=10):
    vals = sorted({
        n.properties[prop] for n in _label_nodes(ex, label)
        if isinstance(n.properties.get(prop), str)
        and n.properties[prop].lower().startswith(str(prefix).lower())
    })
    return vals[: int(limit)]


@register("apoc.search.score")
def search_score(node, query):
    """Token-overlap score of a node's string properties vs the query."""
    if not isinstance(node, Node):
        return 0.0
    tokens = set(str(query).lower().split())
    if not tokens:
        return 0.0
    text = " ".join(str(v).lower() for v in node.properties.values()
                    if isinstance(v, str))
    hits = sum(1 for t in tokens if t in text)
    return hits / len(tokens)


@register("apoc.search.highlight")
def search_highlight(text, query, pre="<b>", post="</b>"):
    out = str(text)
    for token in sorted(set(str(query).split()), key=len, reverse=True):
        if token:
            out = re.sub(
                f"({re.escape(token)})", rf"{pre}\1{post}", out,
                flags=re.IGNORECASE,
            )
    return out


@_graph_fn("apoc.search.fullText")
def search_fulltext(ex, label, query, limit=10):
    """Scored substring search across all string properties."""
    from nornicdb_tpu_torch.apoc.functions_graph2 import search_score

    scored = [
        (search_score(n, query), n) for n in _label_nodes(ex, label)
    ]
    scored = [(s, n) for s, n in scored if s > 0]
    scored.sort(key=lambda t: (-t[0], t[1].id))
    return [{"node": n, "score": s} for s, n in scored[: int(limit)]]


@_graph_fn("apoc.search.parallel")
def search_parallel(ex, queries):
    """[{label, prop, value}] batch of point searches."""
    return [search_node(ex, q["label"], q["prop"], q["value"])
            for q in (queries or [])]


@_graph_fn("apoc.search.multiSearchAll")
def search_multi_all(ex, queries):
    """Nodes matching every {label, prop, value} query."""
    results = search_parallel(ex, queries)
    if not results:
        return []
    ids = set.intersection(*({n.id for n in r} for r in results))
    out = {n.id: n for r in results for n in r if n.id in ids}
    return sorted(out.values(), key=lambda n: n.id)


@_graph_fn("apoc.search.multiSearchAny")
def search_multi_any(ex, queries):
    out = {n.id: n for r in search_parallel(ex, queries) for n in r}
    return sorted(out.values(), key=lambda n: n.id)


@_graph_fn("apoc.search.index")
def search_index(ex, label, properties):
    return schema_create_index(ex, label, properties)


@_graph_fn("apoc.search.dropIndex")
def search_drop_index(ex, label, properties):
    return schema_drop_index(ex, label, properties)


@_graph_fn("apoc.search.reindex")
def search_reindex(ex, label=None):
    """Re-registers every node into the schema property maps."""
    count = 0
    for n in ex.storage.all_nodes():
        if label is None or label in n.labels:
            ex.schema.index_node(n)
            count += 1
    return {"reindexed": count}


# ============================================================ apoc.create
@register("apoc.create.uuid")
def create_uuid():
    return str(_uuid.uuid4())


@register("apoc.create.uuids")
def create_uuids(n):
    return [str(_uuid.uuid4()) for _ in range(int(n))]


@_graph_fn("apoc.create.node")
def create_node(ex, labels, props):
    return ex.storage.create_node(Node(
        id=f"apoc-{_uuid.uuid4()}", labels=list(labels or []),
        properties=dict(props or {}),
    ))


@_graph_fn("apoc.create.nodes")
def create_nodes(ex, labels, props_list):
    return [create_node(ex, labels, p) for p in (props_list or [])]


@_graph_fn("apoc.create.relationship")
def create_relationship(ex, n1, rel_type, n2, props=None):
    a, b = _node(ex, n1), _node(ex, n2)
    return ex.storage.create_edge(Edge(
        id=f"apoc-{_uuid.uuid4()}", start_node=a.id, end_node=b.id,
        type=str(rel_type), properties=dict(props or {}),
    ))


@register("apoc.create.vNode")
def create_vnode(labels, props):
    """Virtual node: never persisted (ref create.go VNode)."""
    return Node(id=f"vnode-{_uuid.uuid4()}", labels=list(labels or []),
                properties=dict(props or {}))


@register("apoc.create.vNodes")
def create_vnodes(labels, props_list):
    return [create_vnode(labels, p) for p in (props_list or [])]


@register("apoc.create.vRelationship")
def create_vrelationship(n1, rel_type, n2, props=None):
    a = n1.id if isinstance(n1, Node) else str(n1)
    b = n2.id if isinstance(n2, Node) else str(n2)
    return Edge(id=f"vrel-{_uuid.uuid4()}", start_node=a, end_node=b,
                type=str(rel_type), properties=dict(props or {}))


@register("apoc.create.vPattern")
def create_vpattern(from_props, rel_type, to_props, rel_props=None):
    a = create_vnode(from_props.pop("_labels", []) if isinstance(from_props, dict) else [], from_props)
    b = create_vnode(to_props.pop("_labels", []) if isinstance(to_props, dict) else [], to_props)
    r = create_vrelationship(a, rel_type, b, rel_props)
    return {"from": a, "rel": r, "to": b}


@_graph_fn("apoc.create.addLabels")
def create_add_labels(ex, node, labels):
    from nornicdb_tpu_torch.apoc.functions_graph import node_add_labels

    return node_add_labels(ex, node, labels)


@_graph_fn("apoc.create.removeLabels")
def create_remove_labels(ex, node, labels):
    from nornicdb_tpu_torch.apoc.functions_graph import node_remove_labels

    return node_remove_labels(ex, node, labels)


@_graph_fn("apoc.create.setProperty")
def create_set_property(ex, node, key, value):
    from nornicdb_tpu_torch.apoc.functions_graph import node_set_property

    return node_set_property(ex, node, key, value)


@_graph_fn("apoc.create.setProperties")
def create_set_properties(ex, node, props):
    from nornicdb_tpu_torch.apoc.functions_graph import node_set_properties

    return node_set_properties(ex, node, props)


@_graph_fn("apoc.create.removeProperties")
def create_remove_properties(ex, node, keys):
    from nornicdb_tpu_torch.apoc.functions_graph import node_remove_properties

    return node_remove_properties(ex, node, keys)


@_graph_fn("apoc.create.setRelProperty")
def create_set_rel_property(ex, rel, key, value):
    from nornicdb_tpu_torch.apoc.functions_graph import rel_set_property

    return rel_set_property(ex, rel, key, value)


@_graph_fn("apoc.create.setRelProperties")
def create_set_rel_properties(ex, rel, props):
    from nornicdb_tpu_torch.apoc.functions_graph import rel_set_properties

    return rel_set_properties(ex, rel, props)


@_graph_fn("apoc.create.removeRelProperties")
def create_remove_rel_properties(ex, rel, keys):
    from nornicdb_tpu_torch.apoc.functions_graph import rel_remove_properties

    return rel_remove_properties(ex, rel, keys)


@_graph_fn("apoc.create.clone")
def create_clone(ex, node):
    from nornicdb_tpu_torch.apoc.functions_graph import node_clone

    return node_clone(ex, node)


@_graph_fn("apoc.create.cloneSubgraph")
def create_clone_subgraph(ex, nodes, rels):
    """Clone nodes + the rels among them; returns {nodes, rels} clones."""
    mapping: dict[str, Node] = {}
    out_nodes = []
    for v in nodes or []:
        n = _node(ex, v)
        clone = ex.storage.create_node(Node(
            id=f"apoc-{_uuid.uuid4()}", labels=list(n.labels),
            properties=dict(n.properties)))
        mapping[n.id] = clone
        out_nodes.append(clone)
    out_rels = []
    for v in rels or []:
        r = _edge(ex, v)
        if r.start_node in mapping and r.end_node in mapping:
            out_rels.append(ex.storage.create_edge(Edge(
                id=f"apoc-{_uuid.uuid4()}",
                start_node=mapping[r.start_node].id,
                end_node=mapping[r.end_node].id,
                type=r.type, properties=dict(r.properties))))
    return {"nodes": out_nodes, "rels": out_rels}


# ============================================================= apoc.merge
@_graph_fn("apoc.merge.mergeNode")
@_graph_fn("apoc.merge.nodeEager")
def merge_node(ex, labels, match_props, on_create=None, on_match=None):
    """MERGE semantics: find by labels+props, else create
    (ref merge.go MergeNode)."""
    labels = list(labels or [])
    match_props = dict(match_props or {})
    for n in (ex.storage.get_nodes_by_label(labels[0])
              if labels else ex.storage.all_nodes()):
        if all(l in n.labels for l in labels) and all(
            n.properties.get(k) == v for k, v in match_props.items()
        ):
            if on_match:
                n.properties.update(on_match)
                return ex.storage.update_node(n)
            return n
    return ex.storage.create_node(Node(
        id=f"apoc-{_uuid.uuid4()}", labels=labels,
        properties={**match_props, **(on_create or {})},
    ))


@_graph_fn("apoc.merge.mergeRelationship")
@_graph_fn("apoc.merge.relationshipEager")
def merge_relationship(ex, n1, rel_type, n2, props=None):
    a, b = _node(ex, n1), _node(ex, n2)
    for r in ex.storage.get_outgoing_edges(a.id):
        if r.end_node == b.id and r.type == rel_type:
            if props:
                r.properties.update(props)
                return ex.storage.update_edge(r)
            return r
    return ex.storage.create_edge(Edge(
        id=f"apoc-{_uuid.uuid4()}", start_node=a.id, end_node=b.id,
        type=str(rel_type), properties=dict(props or {}),
    ))


@_graph_fn("apoc.merge.nodes")
def merge_nodes(ex, nodes):
    from nornicdb_tpu_torch.apoc.functions_graph import nodes_collapse

    return nodes_collapse(ex, nodes)


@_graph_fn("apoc.merge.properties")
def merge_properties(ex, node, props):
    n = _node(ex, node)
    for k, v in (props or {}).items():
        n.properties.setdefault(k, v)
    return ex.storage.update_node(n)


@register("apoc.merge.deepMerge")
def merge_deep(m1, m2):
    def deep(a, b):
        out = dict(a)
        for k, v in b.items():
            if isinstance(out.get(k), dict) and isinstance(v, dict):
                out[k] = deep(out[k], v)
            else:
                out[k] = v
        return out

    return deep(m1 or {}, m2 or {})


@_graph_fn("apoc.merge.labels")
def merge_labels(ex, node, labels):
    from nornicdb_tpu_torch.apoc.functions_graph import node_add_labels

    return node_add_labels(ex, node, labels)


@_graph_fn("apoc.merge.pattern")
def merge_pattern(ex, pattern, props=None):
    """'(:A)-[:T]->(:B)' -> merge both nodes + rel."""
    m = re.fullmatch(
        r"\(:(\w+)\)-\[:(\w+)\]->\(:(\w+)\)", str(pattern).strip())
    if not m:
        raise NornicError(f"unsupported merge pattern {pattern!r}")
    a = merge_node(ex, [m.group(1)], (props or {}).get("from") or {})
    b = merge_node(ex, [m.group(3)], (props or {}).get("to") or {})
    r = merge_relationship(ex, a, m.group(2), b,
                           (props or {}).get("rel") or {})
    return {"from": a, "rel": r, "to": b}


@_graph_fn("apoc.merge.batch")
def merge_batch(ex, items, config=None):
    """[{labels, props}] batch of mergeNode calls."""
    return [merge_node(ex, it.get("labels"), it.get("props"))
            for it in (items or [])]


@_graph_fn("apoc.merge.conditional")
def merge_conditional(ex, condition, config):
    """Merge only when `condition` (Cypher expr) is true."""
    if _eval_pred(ex, str(condition), {}) is not True:
        return None
    cfg = config or {}
    return merge_node(ex, cfg.get("labels"), cfg.get("props"))


@register("apoc.merge.strategy")
def merge_strategy(name):
    allowed = {"COMBINE", "OVERWRITE", "DISCARD"}
    s = str(name).upper()
    if s not in allowed:
        raise NornicError(f"unknown merge strategy {name!r}")
    return s


@register("apoc.merge.conflict")
def merge_conflict(n1, n2, strategy="COMBINE"):
    """Resolve property conflicts between two nodes' maps."""
    p1 = dict(n1.properties) if isinstance(n1, Node) else dict(n1 or {})
    p2 = dict(n2.properties) if isinstance(n2, Node) else dict(n2 or {})
    s = str(strategy).upper()
    if s == "OVERWRITE":
        return {**p1, **p2}
    if s == "DISCARD":
        return {**p2, **p1}
    # COMBINE: conflicting keys become lists
    out = dict(p1)
    for k, v in p2.items():
        if k in out and out[k] != v:
            cur = out[k] if isinstance(out[k], list) else [out[k]]
            out[k] = cur + [v]
        else:
            out[k] = v
    return out


@register("apoc.merge.validate")
def merge_validate(props):
    """Mergeable props: plain keys, no None keys, scalar/list/map values."""
    if not isinstance(props, dict):
        return False
    return all(isinstance(k, str) and k for k in props)


@_graph_fn("apoc.merge.preview")
def merge_preview(ex, config):
    """What mergeNode would do, without writing."""
    cfg = config or {}
    labels = list(cfg.get("labels") or [])
    props = dict(cfg.get("props") or {})
    for n in (ex.storage.get_nodes_by_label(labels[0])
              if labels else ex.storage.all_nodes()):
        if all(l in n.labels for l in labels) and all(
            n.properties.get(k) == v for k, v in props.items()
        ):
            return {"action": "match", "node": n}
    return {"action": "create", "labels": labels, "props": props}


_merge_snapshots: dict[str, dict] = {}


@_graph_fn("apoc.merge.snapshot")
def merge_snapshot(ex, node):
    """Capture a node's state for later rollback; returns a snapshot id."""
    n = _node(ex, node)
    sid = str(_uuid.uuid4())
    _merge_snapshots[sid] = {
        "id": n.id, "labels": list(n.labels), "properties": dict(n.properties)
    }
    return sid


@_graph_fn("apoc.merge.rollback")
def merge_rollback(ex, snapshot_id):
    snap = _merge_snapshots.pop(str(snapshot_id), None)
    if snap is None:
        return False
    n = _node(ex, snap["id"])
    n.labels = list(snap["labels"])
    n.properties = dict(snap["properties"])
    ex.storage.update_node(n)
    return True


# ============================================================= apoc.graph
@register("apoc.graph.from")
def graph_from(nodes, rels, name="graph"):
    return {"name": name, "nodes": list(nodes or []),
            "relationships": list(rels or [])}


@register("apoc.graph.fromData")
def graph_from_data(data):
    d = data or {}
    return graph_from(d.get("nodes"), d.get("relationships") or d.get("rels"))


@register("apoc.graph.fromPath")
def graph_from_path(path):
    p = path or {}
    return graph_from(p.get("nodes"), p.get("relationships"))


@register("apoc.graph.fromPaths")
def graph_from_paths(paths):
    nodes: dict[str, Node] = {}
    rels: dict[str, Edge] = {}
    for p in paths or []:
        for n in (p or {}).get("nodes", []):
            if isinstance(n, Node):
                nodes[n.id] = n
        for r in (p or {}).get("relationships", []):
            if isinstance(r, Edge):
                rels[r.id] = r
    return graph_from(list(nodes.values()), list(rels.values()))


@register("apoc.graph.fromDocument")
def graph_from_document(doc):
    """Nested map -> virtual graph: one node per map, CHILD rels (ref
    graph.go FromDocument)."""
    nodes: list[Node] = []
    rels: list[Edge] = []

    def walk(obj, label):
        scalars = {k: v for k, v in obj.items()
                   if not isinstance(v, (dict, list))}
        node = create_vnode([label], scalars)
        nodes.append(node)
        for k, v in obj.items():
            children = v if isinstance(v, list) else [v]
            for child in children:
                if isinstance(child, dict):
                    cn = walk(child, k.capitalize())
                    rels.append(create_vrelationship(node, k.upper(), cn))
        return node

    if isinstance(doc, str):
        doc = _json.loads(doc)
    if isinstance(doc, dict):
        walk(doc, doc.get("type", "Document"))
    return graph_from(nodes, rels)


@_graph_fn("apoc.graph.fromCypher")
def graph_from_cypher(ex, query, params=None):
    res = ex.execute(str(query), params or {})
    nodes: dict[str, Node] = {}
    rels: dict[str, Edge] = {}
    for row in res.rows:
        for v in row:
            if isinstance(v, Node):
                nodes[v.id] = v
            elif isinstance(v, Edge):
                rels[v.id] = v
    return graph_from(list(nodes.values()), list(rels.values()))


@register("apoc.graph.validate")
def graph_validate(graph):
    """Every rel endpoint must be among the graph's nodes."""
    g = graph or {}
    ids = {n.id for n in g.get("nodes", []) if isinstance(n, Node)}
    dangling = [
        r.id for r in g.get("relationships", [])
        if isinstance(r, Edge)
        and (r.start_node not in ids or r.end_node not in ids)
    ]
    return {"valid": not dangling, "dangling": dangling}


@register("apoc.graph.nodes")
def graph_nodes(graph):
    return list((graph or {}).get("nodes", []))


@register("apoc.graph.relationships")
def graph_relationships(graph):
    return list((graph or {}).get("relationships", []))


@register("apoc.graph.merge")
def graph_merge(g1, g2):
    nodes: dict[str, Node] = {}
    rels: dict[str, Edge] = {}
    for g in (g1 or {}), (g2 or {}):
        for n in g.get("nodes", []):
            if isinstance(n, Node):
                nodes[n.id] = n
        for r in g.get("relationships", []):
            if isinstance(r, Edge):
                rels[r.id] = r
    return graph_from(list(nodes.values()), list(rels.values()))


@register("apoc.graph.clone")
def graph_clone(graph):
    g = graph or {}
    return graph_from(list(g.get("nodes", [])),
                      list(g.get("relationships", [])),
                      name=g.get("name", "graph"))


@register("apoc.graph.stats")
def graph_stats(graph):
    g = graph or {}
    n = len(g.get("nodes", []))
    m = len(g.get("relationships", []))
    return {"nodeCount": n, "relCount": m,
            "density": (m / (n * (n - 1))) if n > 1 else 0.0}


@register("apoc.graph.toMap")
def graph_to_map(graph):
    g = graph or {}
    return {
        "name": g.get("name", "graph"),
        "nodes": [node_to_map(n) for n in g.get("nodes", [])
                  if isinstance(n, Node)],
        "relationships": [rel_to_map(r) for r in g.get("relationships", [])
                          if isinstance(r, Edge)],
    }


@register("apoc.graph.fromMap")
def graph_from_map(m):
    g = m or {}
    nodes = [Node(id=str(s["id"]), labels=list(s.get("labels") or []),
                  properties=dict(s.get("properties") or {}))
             for s in g.get("nodes", [])]
    rels = [Edge(id=str(s["id"]), start_node=str(s["start"]),
                 end_node=str(s["end"]), type=str(s.get("type", "RELATED_TO")),
                 properties=dict(s.get("properties") or {}))
            for s in g.get("relationships", [])]
    return graph_from(nodes, rels, name=g.get("name", "graph"))


@register("apoc.graph.subgraph")
def graph_subgraph(graph, node_ids):
    g = graph or {}
    keep = {str(i) for i in (node_ids or [])}
    nodes = [n for n in g.get("nodes", [])
             if isinstance(n, Node) and n.id in keep]
    rels = [r for r in g.get("relationships", [])
            if isinstance(r, Edge) and r.start_node in keep
            and r.end_node in keep]
    return graph_from(nodes, rels)


# ============================================================ apoc.cypher
@_graph_fn("apoc.cypher.run")
@_graph_fn("apoc.cypher.doIt")
def cypher_run(ex, query, params=None):
    res = ex.execute(str(query), params or {})
    return res.rows_as_dicts()


@_graph_fn("apoc.cypher.runMany")
def cypher_run_many(ex, queries, params=None):
    return [cypher_run(ex, q, params) for q in (queries or [])]


@_graph_fn("apoc.cypher.runFirstColumn")
def cypher_run_first_column(ex, query, params=None):
    res = ex.execute(str(query), params or {})
    return [row[0] for row in res.rows if row]


@_graph_fn("apoc.cypher.runFirstColumnSingle")
def cypher_run_first_column_single(ex, query, params=None):
    col = cypher_run_first_column(ex, query, params)
    return col[0] if col else None


@_graph_fn("apoc.cypher.runFirstColumnMany")
def cypher_run_first_column_many(ex, queries, params=None):
    return [cypher_run_first_column(ex, q, params) for q in (queries or [])]


@register("apoc.cypher.parse")
def cypher_parse(query):
    """Parse and describe the statement (clause names)."""
    from nornicdb_tpu_torch.cypher.parser import parse

    stmt = parse(str(query))
    clauses = [type(c).__name__ for c in getattr(stmt, "clauses", [])]
    return {"valid": True, "statement": type(stmt).__name__,
            "clauses": clauses}


@register("apoc.cypher.validate")
def cypher_validate(query):
    from nornicdb_tpu_torch.cypher.parser import parse

    try:
        parse(str(query))
        return True
    # the exception IS the (negative) validation result the caller asked
    # for — not an operational error worth a log line or counter
    except Exception:  # nornlint: disable=NL-ERR02
        return False


@_graph_fn("apoc.cypher.explain")
def cypher_explain(ex, query):
    res = ex.execute(f"EXPLAIN {query}")
    return res.rows[0][0] if res.rows else None


@_graph_fn("apoc.cypher.profile")
def cypher_profile(ex, query):
    res = ex.execute(f"PROFILE {query}")
    return res.rows[0][0] if res.rows else None


@_graph_fn("apoc.cypher.parallel")
@_graph_fn("apoc.cypher.mapParallel")
def cypher_parallel(ex, query, items, param_name="item"):
    """Run the query once per item with $item bound (the reference fans
    out goroutines; here items run through the scan thread pool)."""
    from nornicdb_tpu_torch.cypher.parallel import parallel_map

    return parallel_map(
        list(items or []),
        lambda it: cypher_run(ex, query, {param_name: it}),
    )


@register("apoc.cypher.toMap")
def cypher_to_map(result):
    if isinstance(result, list):
        return result[0] if result else {}
    return result


@register("apoc.cypher.toList")
def cypher_to_list(result):
    return result if isinstance(result, list) else [result]


@register("apoc.cypher.toJson")
def cypher_to_json(result):
    def default(o):
        if isinstance(o, Node):
            return node_to_map(o)
        if isinstance(o, Edge):
            return rel_to_map(o)
        return str(o)

    return _json.dumps(result, default=default, sort_keys=True)


@_graph_fn("apoc.cypher.runFile")
def cypher_run_file(ex, path):
    """Run semicolon-separated statements from a local file."""
    with open(str(path), "r", encoding="utf-8") as f:
        text = f.read()
    out = []
    for stmt in text.split(";"):
        stmt = stmt.strip()
        if stmt:
            out.append(cypher_run(ex, stmt))
    return out


# ===================================================== community / algo
def _graph_arrays(ex, nodes, rels):
    """(ids, src, dst) index arrays from Node/id lists + Edge/[s,d] lists;
    when rels is None, edges among the nodes are read from storage."""
    ids = [v.id if isinstance(v, Node) else str(v) for v in (nodes or [])]
    pos = {nid: i for i, nid in enumerate(ids)}
    src, dst = [], []
    if rels is None:
        for nid in ids:
            for r in ex.storage.get_outgoing_edges(nid):
                if r.end_node in pos:
                    src.append(pos[nid])
                    dst.append(pos[r.end_node])
    else:
        for r in rels:
            if isinstance(r, Edge):
                s, d = r.start_node, r.end_node
            elif isinstance(r, dict):
                s, d = str(r["start"]), str(r["end"])
            else:
                s, d = str(r[0]), str(r[1])
            if s in pos and d in pos:
                src.append(pos[s])
                dst.append(pos[d])
    return ids, np.asarray(src, np.int32), np.asarray(dst, np.int32)


def _by_id(ids, values):
    return {nid: (v.item() if hasattr(v, "item") else v)
            for nid, v in zip(ids, values)}


@_graph_fn("apoc.community.louvain")
@_graph_fn("apoc.community.fastGreedy")
@_graph_fn("apoc.community.walkTrap")
@_graph_fn("apoc.community.spinGlass")
def community_louvain(ex, nodes, rels=None, config=None):
    from nornicdb_tpu_torch.ops.graph_algos import louvain

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, louvain(src, dst, len(ids)))


@_graph_fn("apoc.community.labelPropagation")
@_graph_fn("apoc.community.infoMap")
def community_label_propagation(ex, nodes, rels=None, iters=10):
    from nornicdb_tpu_torch.ops.graph_algos import label_propagation

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, label_propagation(src, dst, len(ids),
                                         iters=int(iters or 10)))


@_graph_fn("apoc.community.modularity")
def community_modularity(ex, nodes, rels, communities):
    from nornicdb_tpu_torch.ops.graph_algos import modularity

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return 0.0
    labels = np.asarray(
        [int((communities or {}).get(nid, 0)) for nid in ids], np.int32)
    return float(modularity(src, dst, len(ids), labels))


@_graph_fn("apoc.community.triangleCount")
def community_triangle_count(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import triangle_counts

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, triangle_counts(src, dst, len(ids)))


@_graph_fn("apoc.community.totalTriangles")
def community_total_triangles(ex, nodes, rels=None):
    counts = community_triangle_count(ex, nodes, rels)
    return sum(counts.values()) // 3 if counts else 0


@_graph_fn("apoc.community.clusteringCoefficient")
def community_clustering(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import clustering_coefficient

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, clustering_coefficient(src, dst, len(ids)))


@_graph_fn("apoc.community.averageClusteringCoefficient")
def community_avg_clustering(ex, nodes, rels=None):
    c = community_clustering(ex, nodes, rels)
    return sum(c.values()) / len(c) if c else 0.0


@_graph_fn("apoc.community.connectedComponents")
@_graph_fn("apoc.community.weaklyConnectedComponents")
def community_wcc(ex, nodes, rels=None):
    from nornicdb_tpu_torch.cypher.gds_procedures import _gated_device
    from nornicdb_tpu_torch.ops.graph_algos import connected_components

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, connected_components(src, dst, len(ids),
                                            device=_gated_device(ex)))


@_graph_fn("apoc.community.numComponents")
def community_num_components(ex, nodes, rels=None):
    comps = community_wcc(ex, nodes, rels)
    return len(set(comps.values())) if comps else 0


@_graph_fn("apoc.community.stronglyConnectedComponents")
def community_scc(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import strongly_connected_components

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, strongly_connected_components(src, dst, len(ids)))


@_graph_fn("apoc.community.kCore")
def community_k_core(ex, nodes, rels=None, k=2):
    from nornicdb_tpu_torch.ops.graph_algos import k_core

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return []
    core = k_core(src, dst, len(ids))
    return [nid for nid, c in zip(ids, core) if int(c) >= int(k)]


@_graph_fn("apoc.community.coreNumber")
def community_core_number(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import k_core

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, k_core(src, dst, len(ids)))


@_graph_fn("apoc.community.conductance")
def community_conductance(ex, nodes, rels, communities, community):
    from nornicdb_tpu_torch.ops.graph_algos import conductance

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return 0.0
    labels = np.asarray(
        [int((communities or {}).get(nid, 0)) for nid in ids], np.int32)
    return float(conductance(src, dst, len(ids), labels, int(community)))


@_graph_fn("apoc.community.density")
def community_density(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import density

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return 0.0
    return float(density(src, dst, len(ids)))


@_graph_fn("apoc.algo.pageRank")
def algo_pagerank(ex, nodes, rels=None, damping=0.85, iters=20):
    from nornicdb_tpu_torch.cypher.gds_procedures import _gated_device
    from nornicdb_tpu_torch.ops.graph_algos import pagerank

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, pagerank(src, dst, len(ids), damping=float(damping),
                                iters=int(iters), device=_gated_device(ex)))


@_graph_fn("apoc.algo.degreeCentrality")
def algo_degree_centrality(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import degree_centrality

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, degree_centrality(src, dst, len(ids)))


@_graph_fn("apoc.algo.closenessCentrality")
def algo_closeness_centrality(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import closeness_centrality

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, closeness_centrality(src, dst, len(ids)))


@_graph_fn("apoc.algo.betweennessCentrality")
def algo_betweenness_centrality(ex, nodes, rels=None):
    from nornicdb_tpu_torch.ops.graph_algos import betweenness_centrality

    ids, src, dst = _graph_arrays(ex, nodes, rels)
    if not ids:
        return {}
    return _by_id(ids, betweenness_centrality(src, dst, len(ids)))


@_graph_fn("apoc.algo.community")
def algo_community(ex, nodes, rels=None):
    return community_louvain(ex, nodes, rels)


def _weighted_adj(ex, weight_prop=None):
    adj: dict[str, list[tuple[str, float]]] = {}
    for e in ex.storage.all_edges():
        w = 1.0
        if weight_prop:
            v = e.properties.get(weight_prop)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                w = float(v)
        adj.setdefault(e.start_node, []).append((e.end_node, w))
        adj.setdefault(e.end_node, []).append((e.start_node, w))
    return adj


@_graph_fn("apoc.algo.dijkstra")
def algo_dijkstra(ex, start, end, weight_prop=None):
    """Shortest weighted path -> {path: [ids], cost} or None."""
    import heapq

    s, t = _node(ex, start).id, _node(ex, end).id
    adj = _weighted_adj(ex, weight_prop)
    dist = {s: 0.0}
    prev: dict[str, str] = {}
    heap = [(0.0, s)]
    seen = set()
    while heap:
        d, cur = heapq.heappop(heap)
        if cur in seen:
            continue
        seen.add(cur)
        if cur == t:
            break
        for nxt, w in adj.get(cur, []):
            nd = d + w
            if nd < dist.get(nxt, float("inf")):
                dist[nxt] = nd
                prev[nxt] = cur
                heapq.heappush(heap, (nd, nxt))
    if t not in dist:
        return None
    path = [t]
    while path[-1] != s:
        path.append(prev[path[-1]])
    return {"path": path[::-1], "cost": dist[t]}


@_graph_fn("apoc.algo.aStar")
def algo_astar(ex, start, end, config=None):
    """A* = dijkstra here (admissible zero heuristic; config may carry
    weightProperty)."""
    cfg = config or {}
    return algo_dijkstra(ex, start, end, cfg.get("weightProperty"))


@_graph_fn("apoc.algo.allPairs")
def algo_all_pairs(ex, nodes, rels=None):
    """All-pairs hop distances among the given nodes (BFS per node)."""
    ids, src, dst = _graph_arrays(ex, nodes, rels)
    adj: dict[int, set[int]] = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        adj.setdefault(s, set()).add(d)
        adj.setdefault(d, set()).add(s)
    out = {}
    for i, nid in enumerate(ids):
        dist = {i: 0}
        frontier = [i]
        while frontier:
            nxt = []
            for cur in frontier:
                for nb in adj.get(cur, ()):
                    if nb not in dist:
                        dist[nb] = dist[cur] + 1
                        nxt.append(nb)
            frontier = nxt
        out[nid] = {ids[j]: h for j, h in dist.items() if j != i}
    return out


@_graph_fn("apoc.algo.cover")
def algo_cover(ex, node_ids):
    """Edges whose both endpoints are in the given set (ref algo.go
    Cover)."""
    keep = {(_node(ex, v)).id for v in (node_ids or [])}
    out = []
    for nid in sorted(keep):
        for r in ex.storage.get_outgoing_edges(nid):
            if r.end_node in keep:
                out.append(r)
    return out


# ======================================================= paths / path
def _bfs_paths(ex, start_id, end_id, max_len=6, all_paths=False, limit=1000):
    """Simple (node-unique) directed+undirected paths via DFS."""
    out = []
    stack = [(start_id, [start_id])]
    while stack and len(out) < limit:
        cur, path = stack.pop()
        if cur == end_id and len(path) > 1:
            out.append(path)
            if not all_paths:
                break
            continue
        if len(path) > max_len:
            continue
        nbrs = set()
        for r in ex.storage.get_outgoing_edges(cur):
            nbrs.add(r.end_node)
        for r in ex.storage.get_incoming_edges(cur):
            nbrs.add(r.start_node)
        for nxt in sorted(nbrs, reverse=True):
            if nxt == end_id or nxt not in path:
                stack.append((nxt, path + [nxt]))
    return out


@_graph_fn("apoc.paths.all")
@_graph_fn("apoc.paths.simple")
@_graph_fn("apoc.paths.elementary")
def paths_all(ex, start, end, max_length=6):
    s, t = _node(ex, start).id, _node(ex, end).id
    return _bfs_paths(ex, s, t, int(max_length), all_paths=True)


@_graph_fn("apoc.paths.shortest")
def paths_shortest(ex, start, end):
    s, t = _node(ex, start).id, _node(ex, end).id
    # BFS = fewest hops
    frontier = [s]
    prev = {s: None}
    while frontier and t not in prev:
        nxt = []
        for cur in frontier:
            nbrs = set()
            for r in ex.storage.get_outgoing_edges(cur):
                nbrs.add(r.end_node)
            for r in ex.storage.get_incoming_edges(cur):
                nbrs.add(r.start_node)
            for nb in sorted(nbrs):
                if nb not in prev:
                    prev[nb] = cur
                    nxt.append(nb)
        frontier = nxt
    if t not in prev:
        return None
    path = [t]
    while path[-1] != s:
        path.append(prev[path[-1]])
    return path[::-1]


@_graph_fn("apoc.paths.longest")
def paths_longest(ex, start, end, max_length=8):
    ps = paths_all(ex, start, end, max_length)
    return max(ps, key=len) if ps else None


@_graph_fn("apoc.paths.kShortest")
def paths_k_shortest(ex, start, end, k=3, max_length=8):
    ps = paths_all(ex, start, end, max_length)
    return sorted(ps, key=lambda p: (len(p), p))[: int(k)]


@_graph_fn("apoc.paths.count")
def paths_count(ex, start, end, max_length=6):
    return len(paths_all(ex, start, end, max_length))


@_graph_fn("apoc.paths.exists")
def paths_exists(ex, start, end):
    return paths_shortest(ex, start, end) is not None


@_graph_fn("apoc.paths.distance")
def paths_distance(ex, start, end):
    p = paths_shortest(ex, start, end)
    return len(p) - 1 if p else None


@_graph_fn("apoc.paths.withLength")
def paths_with_length(ex, start, end, length):
    return [p for p in paths_all(ex, start, end, int(length))
            if len(p) - 1 == int(length)]


@_graph_fn("apoc.paths.withinLength")
def paths_within_length(ex, start, end, max_length):
    return paths_all(ex, start, end, int(max_length))


@_graph_fn("apoc.paths.cycles")
def paths_cycles(ex, start, max_length=8):
    """Directed cycles through `start`."""
    s = _node(ex, start).id
    out = []
    stack = [(s, [s])]
    while stack:
        cur, path = stack.pop()
        for r in ex.storage.get_outgoing_edges(cur):
            nxt = r.end_node
            if nxt == s and len(path) > 1:
                out.append(path + [s])
            elif nxt not in path and len(path) < int(max_length):
                stack.append((nxt, path + [nxt]))
    return out


@_graph_fn("apoc.paths.disjoint")
def paths_disjoint(ex, start, end, max_length=6):
    """Greedy node-disjoint path set."""
    used: set = set()
    out = []
    for p in sorted(paths_all(ex, start, end, max_length),
                    key=lambda p: (len(p), p)):
        inner = set(p[1:-1])
        if not inner & used:
            out.append(p)
            used |= inner
    return out


@_graph_fn("apoc.paths.edgeDisjoint")
def paths_edge_disjoint(ex, start, end, max_length=6):
    used: set = set()
    out = []
    for p in sorted(paths_all(ex, start, end, max_length),
                    key=lambda p: (len(p), p)):
        edges = {tuple(sorted((a, b))) for a, b in zip(p, p[1:])}
        if not edges & used:
            out.append(p)
            used |= edges
    return out


@_graph_fn("apoc.paths.hamiltonian")
def paths_hamiltonian(ex, nodes):
    """Hamiltonian path over the given nodes (backtracking, small sets)."""
    ids = [(_node(ex, v)).id for v in (nodes or [])]
    idset = set(ids)
    if len(ids) > 12:
        raise NornicError("hamiltonian search capped at 12 nodes")

    def nbrs(nid):
        out = set()
        for r in ex.storage.get_outgoing_edges(nid):
            out.add(r.end_node)
        for r in ex.storage.get_incoming_edges(nid):
            out.add(r.start_node)
        return out & idset

    def walk(path):
        if len(path) == len(ids):
            return path
        for nb in sorted(nbrs(path[-1])):
            if nb not in path:
                r = walk(path + [nb])
                if r:
                    return r
        return None

    for s in sorted(ids):
        r = walk([s])
        if r:
            return r
    return None


@_graph_fn("apoc.paths.eulerian")
def paths_eulerian(ex, nodes):
    """Eulerian path over the subgraph induced by `nodes` (Hierholzer,
    undirected)."""
    ids = {(_node(ex, v)).id for v in (nodes or [])}
    adj: dict[str, list] = {i: [] for i in ids}
    edges = set()
    for nid in ids:
        for r in ex.storage.get_outgoing_edges(nid):
            if r.end_node in ids and r.id not in edges:
                edges.add(r.id)
                adj[nid].append((r.end_node, r.id))
                adj[r.end_node].append((nid, r.id))
    odd = [i for i in sorted(ids) if len(adj[i]) % 2 == 1]
    if len(odd) not in (0, 2) or not edges:
        return None
    start = odd[0] if odd else sorted(ids)[0]
    used: set = set()
    stack = [start]
    path = []
    while stack:
        cur = stack[-1]
        found = None
        for nb, eid in adj[cur]:
            if eid not in used:
                found = (nb, eid)
                break
        if found:
            used.add(found[1])
            stack.append(found[0])
        else:
            path.append(stack.pop())
    if len(used) != len(edges):
        return None
    return path[::-1]


@register("apoc.paths.common")
def paths_common(p1, p2):
    s = set(p2 or [])
    return [x for x in (p1 or []) if x in s]


@register("apoc.paths.unique")
def paths_unique(paths):
    seen = set()
    out = []
    for p in paths or []:
        key = tuple(p)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


@register("apoc.paths.merge")
def paths_merge(p1, p2):
    p1, p2 = list(p1 or []), list(p2 or [])
    if p1 and p2 and p1[-1] == p2[0]:
        return p1 + p2[1:]
    return p1 + p2


@register("apoc.paths.reverse")
def paths_reverse(path):
    return list(reversed(path or []))


@register("apoc.paths.slice")
def paths_slice(path, start, end=None):
    p = list(path or [])
    return p[int(start): (int(end) if end is not None else len(p))]


@_graph_fn("apoc.path.shortestPath")
def path_shortest(ex, start, end):
    return paths_shortest(ex, start, end)


@_graph_fn("apoc.path.allShortestPaths")
def path_all_shortest(ex, start, end):
    sp = paths_shortest(ex, start, end)
    if sp is None:
        return []
    want = len(sp) - 1
    return [p for p in paths_all(ex, start, end, want)
            if len(p) - 1 == want]


@_graph_fn("apoc.path.subgraphNodes")
def path_subgraph_nodes(ex, start, config=None):
    cfg = config or {}
    from nornicdb_tpu_torch.apoc.functions_graph import neighbors_to_hop

    return neighbors_to_hop(
        ex, start, cfg.get("relationshipFilter"),
        int(cfg.get("maxLevel", 3)),
    )


@_graph_fn("apoc.path.subgraphAll")
def path_subgraph_all(ex, start, config=None):
    nodes = path_subgraph_nodes(ex, start, config)
    ids = {n.id for n in nodes} | {_node(ex, start).id}
    rels = []
    for nid in sorted(ids):
        for r in ex.storage.get_outgoing_edges(nid):
            if r.end_node in ids:
                rels.append(r)
    return {"nodes": nodes, "relationships": rels}


@_graph_fn("apoc.path.spanningTree")
def path_spanning_tree(ex, start, config=None):
    """BFS tree edges from start (ref path.go SpanningTree)."""
    cfg = config or {}
    max_level = int(cfg.get("maxLevel", 5))
    s = _node(ex, start).id
    seen = {s}
    frontier = [s]
    tree = []
    for _ in range(max_level):
        nxt = []
        for cur in frontier:
            for r in ex.storage.get_outgoing_edges(cur):
                if r.end_node not in seen:
                    seen.add(r.end_node)
                    tree.append(r)
                    nxt.append(r.end_node)
            for r in ex.storage.get_incoming_edges(cur):
                if r.start_node not in seen:
                    seen.add(r.start_node)
                    tree.append(r)
                    nxt.append(r.start_node)
        frontier = nxt
    return tree


@_graph_fn("apoc.path.expandConfig")
def path_expand_config(ex, start, config=None):
    """Paths from start honoring {maxLevel, relationshipFilter, labelFilter,
    uniqueness: NODE_PATH} (subset of the reference's expandConfig)."""
    cfg = config or {}
    max_level = int(cfg.get("maxLevel", 3))
    rel_filter = cfg.get("relationshipFilter")
    label_filter = cfg.get("labelFilter")
    s = _node(ex, start).id
    out = []
    stack = [(s, [s])]
    while stack:
        cur, path = stack.pop()
        if len(path) > 1:
            out.append(path)
        if len(path) > max_level:
            continue
        for r in ex.storage.get_outgoing_edges(cur):
            if rel_filter and r.type != rel_filter:
                continue
            if r.end_node in path:
                continue
            if label_filter:
                n = ex.get_node_or_none(r.end_node)
                if n is None or label_filter not in n.labels:
                    continue
            stack.append((r.end_node, path + [r.end_node]))
    return out


@register("apoc.path.combine")
def path_combine(p1, p2):
    return paths_merge(p1, p2)


@register("apoc.path.elements")
def path_elements(path):
    if isinstance(path, dict):
        nodes = path.get("nodes", [])
        rels = path.get("relationships", [])
        out = []
        for i, n in enumerate(nodes):
            out.append(n)
            if i < len(rels):
                out.append(rels[i])
        return out
    return list(path or [])


@register("apoc.path.slice")
def path_slice(path, offset, length=None):
    p = list(path or [])
    start = int(offset)
    return p[start: start + int(length)] if length is not None else p[start:]
