"""APOC graph procedures (storage-touching).

Behavioral reference: upstream NornicDB apoc/create, merge, refactor, path(s),
periodic, neighbors categories; wired through the Cypher procedure registry
the way the reference routes CALL apoc.* via its registry
(pkg/cypher/call.go, apoc/apoc.go:121).

The port's copy of ``nornicdb_tpu/apoc/procedures.py``.
"""

from __future__ import annotations

import logging
from typing import Any

from nornicdb_tpu_torch.cypher.executor import CypherExecutor, procedure
from nornicdb_tpu_torch.errors import CypherSyntaxError
from nornicdb_tpu_torch.storage.types import Edge, Node, new_id
from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)


@procedure("apoc.create.node")
def apoc_create_node(ex: CypherExecutor, args, row):
    labels = args[0] if args else []
    props = args[1] if len(args) > 1 else {}
    node = Node(labels=list(labels or []), properties=dict(props or {}))
    created = ex.storage.create_node(node)
    return ["node"], [[created]]


@procedure("apoc.create.nodes")
def apoc_create_nodes(ex: CypherExecutor, args, row):
    labels = args[0] if args else []
    props_list = args[1] if len(args) > 1 else []
    out = []
    for props in props_list or []:
        node = Node(labels=list(labels or []), properties=dict(props or {}))
        out.append([ex.storage.create_node(node)])
    return ["node"], out


@procedure("apoc.create.relationship")
def apoc_create_rel(ex: CypherExecutor, args, row):
    if len(args) < 4:
        raise CypherSyntaxError("apoc.create.relationship(from, type, props, to)")
    from_n, rel_type, props, to_n = args[0], args[1], args[2], args[3]
    edge = Edge(
        start_node=from_n.id if isinstance(from_n, Node) else str(from_n),
        end_node=to_n.id if isinstance(to_n, Node) else str(to_n),
        type=str(rel_type),
        properties=dict(props or {}),
    )
    created = ex.storage.create_edge(edge)
    return ["rel"], [[created]]


@procedure("apoc.create.uuid")
def apoc_uuid(ex: CypherExecutor, args, row):
    return ["uuid"], [[new_id()]]


@procedure("apoc.merge.node")
def apoc_merge_node(ex: CypherExecutor, args, row):
    """(ref: apoc/merge) — match on identProps, set onCreateProps when new."""
    labels = args[0] if args else []
    ident = args[1] if len(args) > 1 else {}
    on_create = args[2] if len(args) > 2 else {}
    if not ident:
        raise CypherSyntaxError(
            "apoc.merge.node: you need to supply at least one identifying property"
        )
    for n in ex.storage.get_nodes_by_label(labels[0]) if labels else ex.storage.all_nodes():
        if all(n.properties.get(k) == v for k, v in (ident or {}).items()):
            if all(l in n.labels for l in labels or []):
                return ["node"], [[n]]
    node = Node(labels=list(labels or []),
                properties={**(ident or {}), **(on_create or {})})
    return ["node"], [[ex.storage.create_node(node)]]


@procedure("apoc.merge.relationship")
def apoc_merge_rel(ex: CypherExecutor, args, row):
    from_n, rel_type = args[0], str(args[1])
    ident = args[2] if len(args) > 2 else {}
    on_create = args[3] if len(args) > 3 else {}
    to_n = args[4] if len(args) > 4 else None
    for e in ex.storage.get_outgoing_edges(from_n.id):
        if e.type == rel_type and e.end_node == to_n.id and all(
            e.properties.get(k) == v for k, v in (ident or {}).items()
        ):
            return ["rel"], [[e]]
    edge = Edge(
        start_node=from_n.id, end_node=to_n.id, type=rel_type,
        properties={**(ident or {}), **(on_create or {})},
    )
    return ["rel"], [[ex.storage.create_edge(edge)]]


@procedure("apoc.refactor.rename.label")
def apoc_rename_label(ex: CypherExecutor, args, row):
    old, new = str(args[0]), str(args[1])
    count = 0
    for n in ex.storage.get_nodes_by_label(old):
        n.labels = [new if l == old else l for l in n.labels]
        ex.storage.update_node(n)
        count += 1
    return ["total"], [[count]]


@procedure("apoc.refactor.rename.type")
def apoc_rename_type(ex: CypherExecutor, args, row):
    old, new = str(args[0]), str(args[1])
    count = 0
    for e in ex.storage.get_edges_by_type(old):
        e.type = new
        ex.storage.update_edge(e)
        count += 1
    return ["total"], [[count]]


@procedure("apoc.node.degree")
def apoc_node_degree(ex: CypherExecutor, args, row):
    node = args[0]
    direction = str(args[1]) if len(args) > 1 else "both"
    d = ex.storage.degree(node.id, direction.lower().strip("<>") or "both")
    return ["value"], [[d]]


@procedure("apoc.neighbors.tohop")
def apoc_neighbors(ex: CypherExecutor, args, row):
    from nornicdb_tpu_torch.cypher.gds_procedures import _resolve_node

    node = _resolve_node(ex, args[0])
    rel_types: set[str] = set()
    if len(args) > 1 and isinstance(args[1], str):
        # "KNOWS|WORKS_WITH>" style spec; direction arrows are stripped
        rel_types = {t.strip("<>") for t in args[1].split("|") if t.strip("<>")}
    hops = int(args[2]) if len(args) > 2 else int(args[1]) if len(args) > 1 and not isinstance(args[1], str) else 1
    seen = {node.id}
    frontier = [node.id]
    out = []
    for _ in range(hops):
        nxt = []
        for nid in frontier:
            for e in ex.storage.get_outgoing_edges(nid):
                if rel_types and e.type not in rel_types:
                    continue
                if e.end_node not in seen:
                    seen.add(e.end_node)
                    nxt.append(e.end_node)
            for e in ex.storage.get_incoming_edges(nid):
                if rel_types and e.type not in rel_types:
                    continue
                if e.start_node not in seen:
                    seen.add(e.start_node)
                    nxt.append(e.start_node)
        for nid in nxt:
            n = ex.get_node_or_none(nid)
            if n is not None:
                out.append([n])
        frontier = nxt
    return ["node"], out


@procedure("apoc.path.subgraphnodes")
def apoc_subgraph_nodes(ex: CypherExecutor, args, row):
    node = args[0]
    cfg = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    max_level = int(cfg.get("maxLevel", 3))
    seen = {node.id}
    frontier = [node.id]
    out = [[node]]
    for _ in range(max_level):
        nxt = []
        for nid in frontier:
            for e in ex.storage.get_outgoing_edges(nid):
                if e.end_node not in seen:
                    seen.add(e.end_node)
                    nxt.append(e.end_node)
            for e in ex.storage.get_incoming_edges(nid):
                if e.start_node not in seen:
                    seen.add(e.start_node)
                    nxt.append(e.start_node)
        for nid in nxt:
            n = ex.get_node_or_none(nid)
            if n is not None:
                out.append([n])
        frontier = nxt
    return ["node"], out


@procedure("apoc.periodic.iterate")
def apoc_periodic_iterate(ex: CypherExecutor, args, row):
    """(ref: apoc/periodic, pkg/cypher/call_apoc_periodic.go) — run the outer
    query, then the inner update in batches binding each outer row."""
    if len(args) < 2:
        raise CypherSyntaxError(
            "apoc.periodic.iterate(outerQuery, innerQuery, config)"
        )
    outer_q, inner_q = str(args[0]), str(args[1])
    cfg = args[2] if len(args) > 2 and isinstance(args[2], dict) else {}
    batch_size = int(cfg.get("batchSize", 1000))
    outer = ex.execute(outer_q)
    total = len(outer.rows)
    batches = 0
    failed = 0
    from nornicdb_tpu_torch.cypher.parser import parse as _parse
    from nornicdb_tpu_torch.cypher import ast as _ast

    inner_stmt = _parse(inner_q)
    if not isinstance(inner_stmt, _ast.Query):
        raise CypherSyntaxError("inner query must be a Cypher query")
    for start in range(0, total, batch_size):
        batch_rows = [
            dict(zip(outer.columns, r)) for r in outer.rows[start : start + batch_size]
        ]
        batches += 1
        try:
            ex._run_query(inner_stmt, {}, start_rows=batch_rows)
        except Exception:
            # contract: iterate continues past failed batches, but operators
            # need to see WHY batches failed, not just the count
            log.warning("apoc.periodic.iterate batch %d failed", batches,
                        exc_info=True)
            count_error("apoc.periodic_iterate")
            failed += 1
    return (
        ["batches", "total", "errorMessages", "failedBatches"],
        [[batches, total, {}, failed]],
    )


@procedure("apoc.help")
def apoc_help(ex: CypherExecutor, args, row):
    from nornicdb_tpu_torch.apoc.registry import all_functions

    prefix = str(args[0]).lower() if args else ""
    return ["name"], [[f] for f in all_functions() if prefix in f]


def _trigger_manager(ex: CypherExecutor):
    from nornicdb_tpu_torch.apoc.triggers import manager_for

    return manager_for(ex)  # database-global registry, shared by sessions


@procedure("apoc.trigger.add")
def apoc_trigger_add(ex: CypherExecutor, args, row):
    """(ref: apoc/trigger) apoc.trigger.add(name, statement, selector)"""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.trigger.add(name, statement, selector)")
    selector = args[2] if len(args) > 2 and isinstance(args[2], dict) else {}
    t = _trigger_manager(ex).add(str(args[0]), str(args[1]), selector)
    return ["name", "query", "paused"], [[t.name, t.statement, t.paused]]


@procedure("apoc.trigger.remove")
def apoc_trigger_remove(ex: CypherExecutor, args, row):
    if not _trigger_manager(ex).remove(str(args[0])):
        raise CypherSyntaxError(f"trigger {args[0]!r} not found")
    return ["name", "removed"], [[str(args[0]), True]]


@procedure("apoc.trigger.removeall")
def apoc_trigger_remove_all(ex: CypherExecutor, args, row):
    return ["removed"], [[_trigger_manager(ex).remove_all()]]


@procedure("apoc.trigger.pause")
def apoc_trigger_pause(ex: CypherExecutor, args, row):
    t = _trigger_manager(ex).pause(str(args[0]), True)
    if t is None:
        raise CypherSyntaxError(f"trigger {args[0]!r} not found")
    return ["name", "paused"], [[t.name, t.paused]]


@procedure("apoc.trigger.resume")
def apoc_trigger_resume(ex: CypherExecutor, args, row):
    t = _trigger_manager(ex).pause(str(args[0]), False)
    if t is None:
        raise CypherSyntaxError(f"trigger {args[0]!r} not found")
    return ["name", "paused"], [[t.name, t.paused]]


@procedure("apoc.trigger.list")
def apoc_trigger_list(ex: CypherExecutor, args, row):
    return (
        ["name", "query", "paused", "fired", "errors"],
        [[t.name, t.statement, t.paused, t.fired, t.errors]
         for t in _trigger_manager(ex).list()],
    )


# ---------------------------------------------------------------------------
# apoc.cypher.* (ref: apoc/cypher/cypher.go — Run/RunMany/DoIt/RunFirstColumn)
# ---------------------------------------------------------------------------


@procedure("apoc.cypher.run")
def apoc_cypher_run(ex: CypherExecutor, args, row):
    """apoc.cypher.run(statement, params) -> value rows as maps."""
    if not args:
        raise CypherSyntaxError("apoc.cypher.run(statement, params)")
    params = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    res = ex.execute(str(args[0]), params)
    return ["value"], [[dict(zip(res.columns, r))] for r in res.rows]


@procedure("apoc.cypher.doit")
def apoc_cypher_doit(ex: CypherExecutor, args, row):
    """Like apoc.cypher.run but explicitly allowed to write (same here:
    the inner executor enforces RBAC at the session layer, not here)."""
    return apoc_cypher_run(ex, args, row)


@procedure("apoc.cypher.runmany")
def apoc_cypher_run_many(ex: CypherExecutor, args, row):
    """Semicolon-separated statements, each run in order; returns per-
    statement row counts (ref cypher.go RunMany)."""
    if not args:
        raise CypherSyntaxError("apoc.cypher.runMany(statements, params)")
    params = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    out = []
    for i, stmt in enumerate(s.strip() for s in _split_statements(str(args[0]))):
        if not stmt:
            continue
        res = ex.execute(stmt, params)
        out.append([i, len(res.rows)])
    return ["statement", "rowCount"], out


def _split_statements(text: str) -> list[str]:
    """Split on ';' outside of Cypher string literals / backtick names."""
    parts, buf = [], []
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            buf.append(c)
            if c == "\\" and quote in "'\"" and i + 1 < len(text):
                buf.append(text[i + 1])
                i += 1
            elif c == quote:
                quote = None
        elif c in ("'", '"', "`"):
            quote = c
            buf.append(c)
        elif c == ";":
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    parts.append("".join(buf))
    return parts


@procedure("apoc.cypher.runfirstcolumnsingle")
def apoc_cypher_first_single(ex: CypherExecutor, args, row):
    if not args:
        raise CypherSyntaxError("apoc.cypher.runFirstColumnSingle(statement, params)")
    params = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    res = ex.execute(str(args[0]), params)
    val = res.rows[0][0] if res.rows and res.rows[0] else None
    return ["value"], [[val]]


@procedure("apoc.cypher.runfirstcolumnmany")
def apoc_cypher_first_many(ex: CypherExecutor, args, row):
    if not args:
        raise CypherSyntaxError("apoc.cypher.runFirstColumnMany(statement, params)")
    params = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    res = ex.execute(str(args[0]), params)
    return ["value"], [[r[0]] for r in res.rows if r]


# ---------------------------------------------------------------------------
# apoc.schema.* (ref: apoc/schema/schema.go — Nodes/Assert/index+constraint
# introspection against the SchemaManager)
# ---------------------------------------------------------------------------


@procedure("apoc.schema.nodes")
def apoc_schema_nodes(ex: CypherExecutor, args, row):
    """Rows follow apoc's contract: status is the online state, type is the
    index/constraint kind (e.g. RANGE, UNIQUENESS)."""
    out = []
    for idx in ex.schema.list_indexes():
        out.append([f":{idx.label}({','.join(idx.properties)})",
                    idx.label, idx.properties, "ONLINE",
                    str(idx.kind).upper()])
    for c in ex.schema.list_constraints():
        kind = "UNIQUENESS" if c.kind == "unique" else str(c.kind).upper()
        out.append([f":{c.label}({','.join(c.properties)})",
                    c.label, c.properties, "ONLINE", kind])
    return ["name", "label", "properties", "status", "type"], out


@procedure("apoc.schema.relationships")
def apoc_schema_rels(ex: CypherExecutor, args, row):
    return ["name", "type", "properties", "status"], []


@procedure("apoc.schema.assert")
def apoc_schema_assert(ex: CypherExecutor, args, row):
    """apoc.schema.assert(indexMap, constraintMap[, dropExisting]) —
    declaratively converge schema: create what's listed, drop the rest
    when dropExisting (default true), matching apoc's contract."""
    want_idx = args[0] if args and isinstance(args[0], dict) else {}
    want_con = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
    drop_existing = bool(args[2]) if len(args) > 2 else True
    out = []
    existing_con = {
        (c.label, tuple(c.properties)): c for c in ex.schema.list_constraints()
    }
    wanted_idx_keys = set()
    for label, prop_lists in (want_idx or {}).items():
        for props in prop_lists or []:
            props = props if isinstance(props, list) else [props]
            wanted_idx_keys.add((label, tuple(props)))
            if ex.schema.find_index(label, props) is not None:
                out.append([label, props, "KEPT", "INDEX"])
                continue
            name = f"apoc_idx_{label}_{'_'.join(props)}"
            ex.schema.create_index(name, "property", label, props,
                                   if_not_exists=True)
            out.append([label, props, "CREATED", "INDEX"])
    wanted_con_keys = set()
    for label, prop_lists in (want_con or {}).items():
        for props in prop_lists or []:
            props = props if isinstance(props, list) else [props]
            wanted_con_keys.add((label, tuple(props)))
            if (label, tuple(props)) in existing_con:
                out.append([label, props, "KEPT", "CONSTRAINT"])
                continue
            name = f"apoc_con_{label}_{'_'.join(props)}"
            ex.schema.create_constraint(name, label, props,
                                        if_not_exists=True)
            out.append([label, props, "CREATED", "CONSTRAINT"])
    if drop_existing:
        for idx in list(ex.schema.list_indexes()):
            if idx.kind == "vector":
                continue  # vector indexes back live search; never implicit-drop
            if (idx.label, tuple(idx.properties)) not in wanted_idx_keys:
                ex.schema.drop_index(idx.name, if_exists=True)
                out.append([idx.label, idx.properties, "DROPPED", "INDEX"])
        for c in list(ex.schema.list_constraints()):
            if (c.label, tuple(c.properties)) not in wanted_con_keys:
                ex.schema.drop_constraint(c.name, if_exists=True)
                out.append([c.label, c.properties, "DROPPED", "CONSTRAINT"])
    return ["label", "key", "action", "type"], out


# ---------------------------------------------------------------------------
# apoc.nodes.* (ref: apoc/nodes/nodes.go — Link/Delete/Connected/Collapse)
# ---------------------------------------------------------------------------


@procedure("apoc.nodes.link")
def apoc_nodes_link(ex: CypherExecutor, args, row):
    """Chain a list of nodes with rels of the given type (ref nodes.go Link)."""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.nodes.link(nodes, relType)")
    nodes, rel_type = args[0] or [], str(args[1])
    created = 0
    for a, b in zip(nodes, nodes[1:]):
        ex.storage.create_edge(Edge(start_node=a.id, end_node=b.id,
                                    type=rel_type))
        created += 1
    return ["created"], [[created]]


@procedure("apoc.nodes.delete")
def apoc_nodes_delete(ex: CypherExecutor, args, row):
    """Detach-delete the given nodes (ref nodes.go Delete)."""
    nodes = args[0] or []
    if isinstance(nodes, Node):
        nodes = [nodes]
    count = 0
    for n in nodes:
        for e in list(ex.storage.get_outgoing_edges(n.id)) + list(
            ex.storage.get_incoming_edges(n.id)
        ):
            ex.storage.delete_edge(e.id)
        ex.storage.delete_node(n.id)
        count += 1
    return ["value"], [[count]]


@procedure("apoc.nodes.connected")
def apoc_nodes_connected(ex: CypherExecutor, args, row):
    if len(args) < 2:
        raise CypherSyntaxError("apoc.nodes.connected(a, b[, types])")
    a, b = args[0], args[1]
    want = set()
    if len(args) > 2 and args[2]:
        want = {t.strip("<>") for t in str(args[2]).split("|")}
    for e in ex.storage.get_outgoing_edges(a.id):
        if e.end_node == b.id and (not want or e.type in want):
            return ["value"], [[True]]
    for e in ex.storage.get_incoming_edges(a.id):
        if e.start_node == b.id and (not want or e.type in want):
            return ["value"], [[True]]
    return ["value"], [[False]]


@procedure("apoc.nodes.collapse")
def apoc_nodes_collapse(ex: CypherExecutor, args, row):
    """Merge a list of nodes into the first: union labels/props, rewire
    edges, delete the rest (ref nodes.go Collapse)."""
    nodes = args[0] or []
    # dedup by id: collect() without DISTINCT can repeat the target, and
    # treating a duplicate as an "other" would delete the merged node
    seen_ids: set[str] = set()
    nodes = [n for n in nodes if n.id not in seen_ids and not seen_ids.add(n.id)]
    if len(nodes) < 2:
        return ["node"], [[nodes[0]]] if nodes else []
    target = nodes[0]
    for other in nodes[1:]:
        for l in other.labels:
            if l not in target.labels:
                target.labels.append(l)
        for k, v in other.properties.items():
            target.properties.setdefault(k, v)
        for e in list(ex.storage.get_outgoing_edges(other.id)):
            ex.storage.delete_edge(e.id)
            if e.end_node != target.id:
                ex.storage.create_edge(Edge(start_node=target.id,
                                            end_node=e.end_node, type=e.type,
                                            properties=e.properties))
        for e in list(ex.storage.get_incoming_edges(other.id)):
            ex.storage.delete_edge(e.id)
            if e.start_node != target.id:
                ex.storage.create_edge(Edge(start_node=e.start_node,
                                            end_node=target.id, type=e.type,
                                            properties=e.properties))
        ex.storage.delete_node(other.id)
    ex.storage.update_node(target)
    return ["node"], [[target]]


# ---------------------------------------------------------------------------
# apoc.log.* (ref: apoc/log/log.go — levelled logging through the server's
# logger rather than a side-channel)
# ---------------------------------------------------------------------------


def _apoc_log(level: str, args):
    import logging

    msg = str(args[0]) if args else ""
    params = args[1:] if len(args) > 1 else ()
    try:
        msg = msg % tuple(params) if params else msg
    except (TypeError, ValueError):
        msg = " ".join([msg] + [str(p) for p in params])
    logging.getLogger("nornicdb.apoc").log(
        getattr(logging, level.upper(), logging.INFO), "%s", msg
    )
    return ["value"], [[msg]]


@procedure("apoc.log.info")
def apoc_log_info(ex, args, row):
    return _apoc_log("info", args)


@procedure("apoc.log.debug")
def apoc_log_debug(ex, args, row):
    return _apoc_log("debug", args)


@procedure("apoc.log.warn")
def apoc_log_warn(ex, args, row):
    return _apoc_log("warning", args)


@procedure("apoc.log.error")
def apoc_log_error(ex, args, row):
    return _apoc_log("error", args)


# ---------------------------------------------------------------------------
# apoc.graph.fromData (ref: apoc/graph/graph.go — virtual graph handles)
# ---------------------------------------------------------------------------


@procedure("apoc.graph.fromdata")
def apoc_graph_from_data(ex: CypherExecutor, args, row):
    """Bundle nodes+rels into a named virtual graph map (not persisted)."""
    nodes = args[0] if args else []
    rels = args[1] if len(args) > 1 else []
    name = str(args[2]) if len(args) > 2 else "graph"
    props = args[3] if len(args) > 3 and isinstance(args[3], dict) else {}
    return ["graph"], [[{
        "name": name, "nodes": list(nodes or []),
        "relationships": list(rels or []), "properties": props,
    }]]


@procedure("apoc.meta.stats")
def apoc_meta_stats(ex: CypherExecutor, args, row):
    """(ref: apoc/meta — label/type counts for the whole database)."""
    labels: dict[str, int] = {}
    n_nodes = 0
    for n in ex.storage.all_nodes():
        n_nodes += 1
        for l in n.labels:
            labels[l] = labels.get(l, 0) + 1
    types: dict[str, int] = {}
    n_edges = 0
    for e in ex.storage.all_edges():
        n_edges += 1
        types[e.type] = types.get(e.type, 0) + 1
    return (
        ["nodeCount", "relCount", "labels", "relTypes"],
        [[n_nodes, n_edges, labels, types]],
    )


# ---------------------------------------------------------------------------
# apoc.lock.* (ref: apoc/lock/lock.go — advisory per-entity locks in a
# database-global registry). Deviations, documented:
#   - the reference releases at transaction end; here release is explicit
#     (unlockNodes/unlockAll) because executor transactions are per-session;
#   - blocking acquires are BOUNDED (default 30s) and raise on timeout —
#     an unbounded in-query block is a DoS lever, same rationale as the
#     apoc.util.sleep cap;
#   - unlockNodes/unlockAll release only locks held by THIS session;
#     apoc.lock.clear (admin escape hatch, ref lock.go Clear) force-releases
#     everything, e.g. after a crashed session leaked its locks.
# ---------------------------------------------------------------------------

_LOCK_WAIT_DEFAULT_MS = 30_000.0


def _lock_registry(ex: CypherExecutor):
    storage = ex.storage
    reg = getattr(storage, "_apoc_lock_registry", None)
    if reg is None:
        import threading

        # locks: eid -> Lock; owners: eid -> (owner_key, count)
        reg = {"mu": threading.Lock(), "locks": {}, "owners": {}}
        storage._apoc_lock_registry = reg
    return reg


def _entity_ids(args) -> list[str]:
    items = args[0] if args else []
    if not isinstance(items, list):
        items = [items]
    # sorted for a stable order, deduped so one call never self-deadlocks
    return sorted({x.id if hasattr(x, "id") else str(x) for x in items})


def _acquire(reg, eid: str, owner, timeout_s: float) -> bool:
    """Owner-aware acquire: reentrant for the same session (count bump),
    bounded wait otherwise."""
    import threading

    with reg["mu"]:
        lk = reg["locks"].setdefault(eid, threading.Lock())
        holder = reg["owners"].get(eid)
        if holder is not None and holder[0] == owner:
            reg["owners"][eid] = (owner, holder[1] + 1)
            return True
    # session-scoped ownership: the lock is held across procedure calls and
    # released by the paired apoc.lock.release procedure, not try/finally
    got = lk.acquire(timeout=timeout_s) if timeout_s > 0 else lk.acquire(  # nornlint: disable=NL-CC01
        blocking=False)
    if got:
        with reg["mu"]:
            reg["owners"][eid] = (owner, 1)
    return got


def _release(reg, eid: str, owner) -> bool:
    with reg["mu"]:
        holder = reg["owners"].get(eid)
        if holder is None or holder[0] != owner:
            return False  # not ours: never release another session's lock
        if holder[1] > 1:
            reg["owners"][eid] = (owner, holder[1] - 1)
            return True
        del reg["owners"][eid]
        reg["locks"][eid].release()
        return True


@procedure("apoc.lock.nodes")
def apoc_lock_nodes(ex: CypherExecutor, args, row):
    """Acquire advisory locks (sorted order; bounded wait, raises on
    timeout rather than hanging the session)."""
    reg = _lock_registry(ex)
    ids = _entity_ids(args)
    timeout_s = (float(args[1]) if len(args) > 1 and args[1] is not None
                 else _LOCK_WAIT_DEFAULT_MS) / 1000.0
    acquired: list[str] = []
    for eid in ids:
        if not _acquire(reg, eid, ex, timeout_s):
            for got in acquired:  # all-or-nothing
                _release(reg, got, ex)
            raise CypherSyntaxError(
                f"apoc.lock.nodes: timed out waiting for lock on {eid!r}")
        acquired.append(eid)
    return ["locked"], [[len(ids)]]


@procedure("apoc.lock.trylock")
def apoc_lock_try(ex: CypherExecutor, args, row):
    """apoc.lock.tryLock(nodeOrList, timeoutMs) -> acquired (all-or-nothing
    when given a list)."""
    if not args:
        raise CypherSyntaxError("apoc.lock.tryLock(node, timeoutMs)")
    reg = _lock_registry(ex)
    ids = _entity_ids(args)  # handles both a single node and a list
    timeout_s = float(args[1]) / 1000.0 if len(args) > 1 else 0.0
    acquired: list[str] = []
    ok = True
    for eid in ids:
        if _acquire(reg, eid, ex, timeout_s):
            acquired.append(eid)
        else:
            ok = False
            break
    if not ok:
        for eid in acquired:
            _release(reg, eid, ex)
    return ["acquired"], [[ok]]


@procedure("apoc.lock.islocked")
def apoc_lock_islocked(ex: CypherExecutor, args, row):
    reg = _lock_registry(ex)
    eid = _entity_ids(args)[0] if args else ""
    with reg["mu"]:
        return ["locked"], [[eid in reg["owners"]]]


@procedure("apoc.lock.unlocknodes")
def apoc_lock_unlock(ex: CypherExecutor, args, row):
    reg = _lock_registry(ex)
    released = sum(1 for eid in _entity_ids(args) if _release(reg, eid, ex))
    return ["released"], [[released]]


@procedure("apoc.lock.unlockall")
def apoc_lock_unlock_all(ex: CypherExecutor, args, row):
    """Release every lock THIS session holds."""
    reg = _lock_registry(ex)
    with reg["mu"]:
        mine = {eid: count for eid, (owner, count) in reg["owners"].items()
                if owner is ex}
    for eid, count in mine.items():
        for _ in range(count):  # fully unwind reentrant holds
            _release(reg, eid, ex)
    return ["released"], [[len(mine)]]


@procedure("apoc.lock.clear")
def apoc_lock_clear(ex: CypherExecutor, args, row):
    """Force-release ALL locks regardless of owner (ref: lock.go Clear) —
    the admin escape hatch for locks leaked by a dead session."""
    reg = _lock_registry(ex)
    with reg["mu"]:
        n = len(reg["owners"])
        for eid in list(reg["owners"]):
            del reg["owners"][eid]
            reg["locks"][eid].release()
    return ["cleared"], [[n]]


procedure("apoc.lock.relationships")(apoc_lock_nodes)  # same registry
procedure("apoc.lock.unlockrelationships")(apoc_lock_unlock)


# ---------------------------------------------------------------------------
# apoc.search.* (ref: apoc/search/search.go — label+property scans with
# operator support; here they use the label index instead of full scans)
# ---------------------------------------------------------------------------


def _search_op(val, op: str, want) -> bool:
    """Delegates to the Cypher expression helpers so CALL apoc.search.*
    results always agree with the equivalent WHERE filter (same null,
    bool-vs-int, and string-coercion semantics)."""
    from nornicdb_tpu_torch.cypher.expr import _compare, _eq

    if op in ("=", "==", "exact"):
        return _eq(val, want) is True
    if op in ("!=", "<>"):
        return _eq(val, want) is False
    if op == "contains":
        return (isinstance(val, str) and isinstance(want, str)
                and want in val)
    if op in ("starts with", "startswith", "prefix"):
        return (isinstance(val, str) and isinstance(want, str)
                and val.startswith(want))
    if op in ("ends with", "endswith", "suffix"):
        return (isinstance(val, str) and isinstance(want, str)
                and val.endswith(want))
    if op in (">", ">=", "<", "<="):
        return _compare(op, val, want) is True
    return False


def _criteria_match(props: dict, criteria: dict, mode: str) -> bool:
    """all/any criteria with Cypher equality: a missing key or a null
    criterion never matches (three-valued logic, matching WHERE)."""
    from nornicdb_tpu_torch.cypher.expr import _eq

    checks = (k in props and _eq(props[k], v) is True
              for k, v in criteria.items())
    return all(checks) if mode == "all" else any(checks)


@procedure("apoc.search.node")
def apoc_search_node(ex: CypherExecutor, args, row):
    """apoc.search.node(label, property, value[, operator='='])"""
    if len(args) < 3:
        raise CypherSyntaxError("apoc.search.node(label, property, value)")
    label, prop, value = str(args[0]), str(args[1]), args[2]
    op = str(args[3]).lower() if len(args) > 3 else "="
    out = []
    for n in ex.storage.get_nodes_by_label(label):
        if prop in n.properties and _search_op(n.properties[prop], op, value):
            out.append([n])
    return ["node"], out


@procedure("apoc.search.nodeall")
def apoc_search_node_all(ex: CypherExecutor, args, row):
    """apoc.search.nodeAll(label, criteriaMap) — every criterion must hold."""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.search.nodeAll(label, criteria)")
    label = str(args[0])
    criteria = args[1] if isinstance(args[1], dict) else {}
    out = []
    for n in ex.storage.get_nodes_by_label(label):
        if _criteria_match(n.properties, criteria, "all"):
            out.append([n])
    return ["node"], out


@procedure("apoc.search.nodeany")
def apoc_search_node_any(ex: CypherExecutor, args, row):
    if len(args) < 2:
        raise CypherSyntaxError("apoc.search.nodeAny(label, criteria)")
    label = str(args[0])
    criteria = args[1] if isinstance(args[1], dict) else {}
    out = []
    for n in ex.storage.get_nodes_by_label(label):
        if _criteria_match(n.properties, criteria, "any"):
            out.append([n])
    return ["node"], out


@procedure("apoc.search.multisearchall")
def apoc_search_multi_all(ex: CypherExecutor, args, row):
    """apoc.search.multiSearchAll(labels, criteria) — union over labels,
    all-criteria match, deduped by node id."""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.search.multiSearchAll(labels, criteria)")
    labels = args[0] if isinstance(args[0], list) else [args[0]]
    criteria = args[1] if isinstance(args[1], dict) else {}
    seen: set[str] = set()
    out = []
    for label in labels:
        for n in ex.storage.get_nodes_by_label(str(label)):
            if n.id in seen:
                continue
            if _criteria_match(n.properties, criteria, "all"):
                seen.add(n.id)
                out.append([n])
    return ["node"], out


@procedure("apoc.search.multisearchany")
def apoc_search_multi_any(ex: CypherExecutor, args, row):
    if len(args) < 2:
        raise CypherSyntaxError("apoc.search.multiSearchAny(labels, criteria)")
    labels = args[0] if isinstance(args[0], list) else [args[0]]
    criteria = args[1] if isinstance(args[1], dict) else {}
    seen: set[str] = set()
    out = []
    for label in labels:
        for n in ex.storage.get_nodes_by_label(str(label)):
            if n.id in seen:
                continue
            if _criteria_match(n.properties, criteria, "any"):
                seen.add(n.id)
                out.append([n])
    return ["node"], out


# ---------------------------------------------------------------------------
# apoc.refactor.* gaps (ref: apoc/refactor/refactor.go — CloneNodes,
# SetType, InvertRelationship, RedirectRelationship, RenameProperty,
# ExtractNode, NormalizeAsBoolean; rename.label/type live above)
# ---------------------------------------------------------------------------


@procedure("apoc.refactor.clonenodes")
def apoc_clone_nodes(ex: CypherExecutor, args, row):
    """apoc.refactor.cloneNodes(nodes[, withRelationships=false])"""
    nodes = (args[0] or []) if args else []
    if isinstance(nodes, Node):
        nodes = [nodes]
    with_rels = bool(args[1]) if len(args) > 1 else False
    out = []
    for n in nodes:
        # snapshot BOTH edge lists before any insert, or the incoming scan
        # picks up the clone edges we just created; self-loops appear in
        # both lists, so dedup by id and remap both endpoints to the clone
        outgoing = list(ex.storage.get_outgoing_edges(n.id)) if with_rels else []
        incoming = [e for e in ex.storage.get_incoming_edges(n.id)
                    if e.start_node != n.id] if with_rels else []
        clone = ex.storage.create_node(
            Node(labels=list(n.labels), properties=dict(n.properties)))
        for e in outgoing:
            end = clone.id if e.end_node == n.id else e.end_node
            ex.storage.create_edge(Edge(
                start_node=clone.id, end_node=end, type=e.type,
                properties=dict(e.properties)))
        for e in incoming:
            ex.storage.create_edge(Edge(
                start_node=e.start_node, end_node=clone.id, type=e.type,
                properties=dict(e.properties)))
        out.append([n, clone])
    return ["input", "output"], out


@procedure("apoc.refactor.settype")
def apoc_set_type(ex: CypherExecutor, args, row):
    """apoc.refactor.setType(rel, newType) — in-place mutation; update_edge
    re-indexes the type map, so the edge keeps its id and created_at."""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.refactor.setType(rel, newType)")
    e, new_type = args[0], str(args[1])
    updated = e.copy()
    updated.type = new_type
    updated = ex.storage.update_edge(updated)
    return ["input", "output"], [[e, updated]]


@procedure("apoc.refactor.invert")
def apoc_invert_rel(ex: CypherExecutor, args, row):
    """Flip a relationship's direction."""
    if not args:
        raise CypherSyntaxError("apoc.refactor.invert(rel)")
    e = args[0]
    # endpoint changes need delete+recreate (adjacency maps key on the
    # endpoints); create FIRST so a failure never destroys the original
    created = ex.storage.create_edge(Edge(
        start_node=e.end_node, end_node=e.start_node, type=e.type,
        properties=dict(e.properties)))
    ex.storage.delete_edge(e.id)
    return ["input", "output"], [[e, created]]


@procedure("apoc.refactor.to")
def apoc_redirect_to(ex: CypherExecutor, args, row):
    """apoc.refactor.to(rel, newEndNode) — redirect the end node."""
    if len(args) < 2:
        raise CypherSyntaxError("apoc.refactor.to(rel, endNode)")
    e, target = args[0], args[1]
    created = ex.storage.create_edge(Edge(  # create-then-delete: a missing
        start_node=e.start_node, end_node=target.id, type=e.type,  # target
        properties=dict(e.properties)))  # must not destroy the original
    ex.storage.delete_edge(e.id)
    return ["input", "output"], [[e, created]]


@procedure("apoc.refactor.from")
def apoc_redirect_from(ex: CypherExecutor, args, row):
    if len(args) < 2:
        raise CypherSyntaxError("apoc.refactor.from(rel, startNode)")
    e, source = args[0], args[1]
    created = ex.storage.create_edge(Edge(
        start_node=source.id, end_node=e.end_node, type=e.type,
        properties=dict(e.properties)))
    ex.storage.delete_edge(e.id)
    return ["input", "output"], [[e, created]]


@procedure("apoc.refactor.rename.nodeproperty")
def apoc_rename_node_prop(ex: CypherExecutor, args, row):
    if len(args) < 2:
        raise CypherSyntaxError(
            "apoc.refactor.rename.nodeProperty(old, new[, nodes])")
    old_name, new_name = str(args[0]), str(args[1])
    scope = args[2] if len(args) > 2 and args[2] else None
    targets = scope if scope is not None else list(ex.storage.all_nodes())
    count = 0
    for n in targets:
        if old_name in n.properties:
            n.properties[new_name] = n.properties.pop(old_name)
            ex.storage.update_node(n)
            count += 1
    return ["total"], [[count]]


@procedure("apoc.refactor.extractnode")
def apoc_extract_node(ex: CypherExecutor, args, row):
    """Turn a relationship into a node with connecting edges
    (rel A-[R]->B  becomes  A-[OUT]->(:R)-[IN]->B)."""
    if not args:
        raise CypherSyntaxError(
            "apoc.refactor.extractNode(rel[, labels, outType, inType])")
    e = args[0]
    labels = args[1] if len(args) > 1 and args[1] else [e.type]
    out_type = str(args[2]) if len(args) > 2 else "OUT"
    in_type = str(args[3]) if len(args) > 3 else "IN"
    mid = ex.storage.create_node(Node(labels=list(labels),
                                      properties=dict(e.properties)))
    ex.storage.delete_edge(e.id)
    ex.storage.create_edge(Edge(start_node=e.start_node, end_node=mid.id,
                                type=out_type))
    ex.storage.create_edge(Edge(start_node=mid.id, end_node=e.end_node,
                                type=in_type))
    return ["input", "output"], [[e, mid]]


@procedure("apoc.refactor.normalizeasboolean")
def apoc_normalize_bool(ex: CypherExecutor, args, row):
    """apoc.refactor.normalizeAsBoolean(entity, prop, trueValues, falseValues)"""
    if len(args) < 4:
        raise CypherSyntaxError(
            "apoc.refactor.normalizeAsBoolean(entity, prop, trues, falses)")
    entity, prop = args[0], str(args[1])
    trues = args[2] or []
    falses = args[3] or []
    val = entity.properties.get(prop)
    if val in trues:
        entity.properties[prop] = True
    elif val in falses:
        entity.properties[prop] = False
    else:
        entity.properties.pop(prop, None)  # unmappable: drop, per apoc
    if isinstance(entity, Node):
        ex.storage.update_node(entity)
    else:
        ex.storage.update_edge(entity)
    return ["entity"], [[entity]]


# ---------------------------------------------------------------------------
# apoc.meta.* introspection (ref: apoc/meta/meta.go — Schema/Data/
# NodeTypeProperties/RelTypeProperties)
# ---------------------------------------------------------------------------


def _cypher_type_of(v) -> str:
    """Delegates to apoc.meta.type so schema introspection and the
    meta.type function can never disagree on a value's type name."""
    from nornicdb_tpu_torch.apoc.functions import meta_type

    return str(meta_type(v)).upper()


@procedure("apoc.meta.schema")
def apoc_meta_schema(ex: CypherExecutor, args, row):
    """One map describing every label: property names -> {type, count} and
    outgoing relationship types (ref meta.go Schema)."""
    schema: dict[str, Any] = {}
    nodes_by_id: dict[str, Any] = {}
    for n in ex.storage.all_nodes():
        nodes_by_id[n.id] = n
        for label in n.labels:
            entry = schema.setdefault(
                label, {"type": "node", "count": 0, "properties": {},
                        "relationships": {}})
            entry["count"] += 1
            for k, v in n.properties.items():
                p = entry["properties"].setdefault(
                    k, {"type": _cypher_type_of(v), "count": 0})
                p["count"] += 1
                if p["type"] != _cypher_type_of(v):
                    p["type"] = "ANY"  # mixed types across nodes
    for e in ex.storage.all_edges():
        src = nodes_by_id.get(e.start_node)
        if src is None:
            continue
        for label in src.labels:
            entry = schema.get(label)
            if entry is not None:
                rel = entry["relationships"].setdefault(
                    e.type, {"direction": "out", "count": 0})
                rel["count"] += 1
    return ["value"], [[schema]]


@procedure("apoc.meta.nodetypeproperties")
def apoc_meta_node_type_props(ex: CypherExecutor, args, row):
    """Row per (label, property): observed types + counts (ref meta.go
    NodeTypeProperties / db.schema.nodeTypeProperties shape)."""
    seen: dict[tuple, dict] = {}
    totals: dict[str, int] = {}
    for n in ex.storage.all_nodes():
        for label in n.labels:
            totals[label] = totals.get(label, 0) + 1
            for k, v in n.properties.items():
                rec = seen.setdefault((label, k), {"types": set(), "count": 0})
                rec["types"].add(_cypher_type_of(v))
                rec["count"] += 1
    rows = []
    for (label, prop), rec in sorted(seen.items()):
        rows.append([f":`{label}`", [label], prop,
                     sorted(rec["types"]), rec["count"] == totals[label]])
    return (["nodeType", "nodeLabels", "propertyName", "propertyTypes",
             "mandatory"], rows)


@procedure("apoc.meta.reltypeproperties")
def apoc_meta_rel_type_props(ex: CypherExecutor, args, row):
    seen: dict[tuple, dict] = {}
    totals: dict[str, int] = {}
    for e in ex.storage.all_edges():
        totals[e.type] = totals.get(e.type, 0) + 1
        for k, v in e.properties.items():
            rec = seen.setdefault((e.type, k), {"types": set(), "count": 0})
            rec["types"].add(_cypher_type_of(v))
            rec["count"] += 1
    rows = []
    for (rtype, prop), rec in sorted(seen.items()):
        rows.append([f":`{rtype}`", prop, sorted(rec["types"]),
                     rec["count"] == totals[rtype]])
    return ["relType", "propertyName", "propertyTypes", "mandatory"], rows


@procedure("apoc.meta.data")
def apoc_meta_data(ex: CypherExecutor, args, row):
    """Row per (label, property/relationship) — the tabular twin of
    apoc.meta.schema (ref meta.go Data)."""
    _, rows_ = apoc_meta_schema(ex, args, row)
    schema = rows_[0][0]
    out = []
    for label, entry in sorted(schema.items()):
        for prop, info in sorted(entry["properties"].items()):
            out.append([label, prop, info["type"], False, info["count"]])
        for rtype, info in sorted(entry["relationships"].items()):
            out.append([label, rtype, "RELATIONSHIP", True, info["count"]])
    return ["label", "property", "type", "isRelationship", "count"], out
