"""Graph pattern matching: binds MATCH/MERGE patterns against storage.

Behavioral reference: upstream NornicDB pkg/cypher/match.go:124 (executeMatch),
traversal.go:886-1330 (BFS findPaths :1127, shortestPath :1332). Uses the
schema property index for equality lookups when available (the reference's
pattern fastpaths, optimized_executors.go).
"""

from __future__ import annotations

import logging
from typing import Any, Iterator, Optional

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate
from nornicdb_tpu_torch.errors import CypherTypeError, NotFoundError
from nornicdb_tpu_torch.storage.schema import SchemaManager
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node

log = logging.getLogger(__name__)

MAX_VAR_LENGTH = 15  # traversal depth cap (ref: traversal.go bounds)

# Live partial paths the batched var-length walk may hold before handing
# the query back to the lazy generic DFS: the batched walk materializes a
# whole frontier level at once, so a dense deep pattern (branching^hops)
# must not trade the generic path's O(depth) walk state for unbounded
# memory. Tests lower this to force the fallback.
MAX_BATCHED_PATHS = 100_000


def make_path(nodes: list[Node], rels: list[Edge]) -> dict[str, Any]:
    return {"__path__": True, "nodes": nodes, "relationships": rels}


def _rel_id(e) -> str:
    """path_rels holds full Edge objects where materialization is needed
    (rel variable bound, named path) and bare edge-id strings elsewhere —
    isomorphism checks work uniformly through this."""
    return e if isinstance(e, str) else e.id


class PatternMatcher:
    def __init__(self, storage: Engine, schema: Optional[SchemaManager] = None,
                 executor=None):
        self.storage = storage
        self.schema = schema
        self.executor = executor
        # no-copy adjacency where the engine offers it (probe once:
        # NamespacedEngine surfaces AttributeError when its base lacks it)
        self._iter_adj = getattr(storage, "iter_adjacency", None)
        if self._iter_adj is not None:
            try:
                self._iter_adj("\x00probe\x00", "out")
            except AttributeError:
                self._iter_adj = None
            except Exception:
                log.debug("iter_adjacency probe failed; keeping fast path",
                          exc_info=True)
        # shared CSR topology snapshot (storage/adjacency.py): resolved on
        # first traversal; False = engine cannot host one
        self._snapshot: Any = None

    def _snap(self):
        """The engine's adjacency snapshot, attaching on first use."""
        if self._snapshot is None:
            try:
                from nornicdb_tpu_torch.storage.adjacency import attach_snapshot

                self._snapshot = attach_snapshot(self.storage)
            except Exception:
                log.debug("adjacency snapshot unavailable; traversals use "
                          "the engine-scan path", exc_info=True)
                self._snapshot = False
        return self._snapshot or None

    def _snap_ready(self):
        """Snapshot only if already built — plain one-hop expansion must
        not pay the first full build. Falls through to a snapshot another
        consumer (GDS, link prediction) already attached to the engine."""
        if self._snapshot is False:
            return None
        snap = self._snapshot or \
            getattr(self.storage, "_adjacency_snapshot", None)
        return snap if (snap is not None and snap.ready()) else None

    # -- public --------------------------------------------------------------
    def match_path(
        self,
        path: ast.PatternPath,
        row: dict[str, Any],
        params: dict[str, Any],
    ) -> Iterator[dict[str, Any]]:
        """Yield binding rows extending `row` with this path's variables."""
        if path.shortest:
            yield from self._match_shortest(path, row, params)
            return
        yield from self._match_elements(path, row, params, 0, row, [], [])

    # -- node candidates -------------------------------------------------------
    def _node_props(
        self, node_pat: ast.NodePattern, row: dict, params: dict
    ) -> Optional[dict[str, Any]]:
        if node_pat.properties is None:
            return None
        ctx = EvalContext(row, params, self.executor)
        v = evaluate(node_pat.properties, ctx)
        if not isinstance(v, dict):
            raise CypherTypeError("node pattern properties must be a map")
        return v

    def _node_matches(
        self, node: Node, node_pat: ast.NodePattern, props: Optional[dict]
    ) -> bool:
        labels = node_pat.labels
        if labels:
            # single-label is the overwhelmingly common shape; skip the
            # genexpr machinery (profiled top cost of unanchored scans)
            if len(labels) == 1:
                if labels[0] not in node.labels:
                    return False
            elif not any(l in node.labels for l in labels):
                return False
        if props:
            for k, v in props.items():
                if not _value_eq(node.properties.get(k), v):
                    return False
        return True

    def _passes_inline_where(
        self, node: Node, node_pat: ast.NodePattern, row: dict, params: dict
    ) -> bool:
        """Inline predicate (n:L WHERE n.x > 1) — evaluated with the node
        bound under its pattern variable."""
        if node_pat.where is None:
            return True
        bindings = dict(row)
        if node_pat.variable:
            bindings[node_pat.variable] = node
        ctx = EvalContext(bindings, params, self.executor)
        return evaluate(node_pat.where, ctx) is True

    def _candidates(
        self, node_pat: ast.NodePattern, row: dict, params: dict
    ) -> list[Node]:
        # bound variable -> single candidate
        if node_pat.variable and node_pat.variable in row:
            v = row[node_pat.variable]
            if v is None:
                return []
            if not isinstance(v, Node):
                raise CypherTypeError(
                    f"variable `{node_pat.variable}` is not a node"
                )
            props = self._node_props(node_pat, row, params)
            return [v] if self._node_matches(v, node_pat, props) else []
        props = self._node_props(node_pat, row, params)
        # index-backed equality lookup (ref: optimized_executors.go fastpath)
        if self.schema is not None and node_pat.labels and props:
            for label in node_pat.labels:
                keys = sorted(props.keys())
                ids = self.schema.lookup(label, keys, [props[k] for k in keys])
                if ids is None and len(keys) > 1:
                    for k in keys:
                        ids = self.schema.lookup(label, [k], [props[k]])
                        if ids is not None:
                            break
                if ids is not None:
                    nodes = self.storage.batch_get_nodes(sorted(ids))
                    return [n for n in nodes if self._node_matches(n, node_pat, props)]
        if node_pat.labels:
            seen: dict[str, Node] = {}
            for label in node_pat.labels:
                for n in self.storage.get_nodes_by_label(label):
                    seen[n.id] = n
            nodes = sorted(seen.values(), key=lambda n: n.id)
            return [n for n in nodes if self._node_matches(n, node_pat, props)]
        return [
            n
            for n in sorted(self.storage.all_nodes(), key=lambda n: n.id)
            if self._node_matches(n, node_pat, props)
        ]

    # -- relationship matching ---------------------------------------------------
    def _rel_props(
        self, rel_pat: ast.RelPattern, row: dict, params: dict
    ) -> Optional[dict[str, Any]]:
        if rel_pat.properties is None:
            return None
        ctx = EvalContext(row, params, self.executor)
        return evaluate(rel_pat.properties, ctx)

    def _rel_matches(self, edge: Edge, rel_pat: ast.RelPattern, props) -> bool:
        if rel_pat.types and edge.type not in rel_pat.types:
            return False
        if props:
            for k, v in props.items():
                if not _value_eq(edge.properties.get(k), v):
                    return False
        return True

    def _expand(
        self, node_id: str, rel_pat: ast.RelPattern, props,
        materialize: bool = True,
    ) -> list[tuple]:
        """Edges leaving `node_id` per the pattern direction.

        materialize=True -> (Edge, other_id) pairs (needed when the rel
        binds a variable, the path is named, or the pattern filters on
        edge properties). materialize=False with fast adjacency ->
        (edge_id, other_id) pairs, skipping per-edge defensive copies —
        the dominant cost of unanchored traversal scans."""
        if not materialize and props is None:
            snap = self._snap_ready()
            if snap is not None:
                pairs = snap.expand_pairs(
                    node_id, rel_pat.direction, rel_pat.types)
                if pairs is not None:
                    return pairs
        if not materialize and props is None and self._iter_adj is not None:
            out = []
            types = rel_pat.types
            if rel_pat.direction in ("out", "both"):
                for eid, t, oid in self._iter_adj(node_id, "out"):
                    if not types or t in types:
                        out.append((eid, oid))
            if rel_pat.direction in ("in", "both"):
                for eid, t, oid in self._iter_adj(node_id, "in"):
                    if not types or t in types:
                        out.append((eid, oid))
            out.sort()
            return out
        out = []
        if rel_pat.direction in ("out", "both"):
            for e in self.storage.get_outgoing_edges(node_id):
                if self._rel_matches(e, rel_pat, props):
                    out.append((e, e.end_node))
        if rel_pat.direction in ("in", "both"):
            for e in self.storage.get_incoming_edges(node_id):
                if self._rel_matches(e, rel_pat, props):
                    out.append((e, e.start_node))
        out.sort(key=lambda t: t[0].id)
        return out

    # -- recursive path walk ------------------------------------------------------
    def _match_elements(
        self,
        path: ast.PatternPath,
        base_row: dict,
        params: dict,
        idx: int,
        row: dict,
        path_nodes: list[Node],
        path_rels: list[Edge],
    ) -> Iterator[dict[str, Any]]:
        elements = path.elements
        if idx >= len(elements):
            out = dict(row)
            if path.name:
                out[path.name] = make_path(path_nodes, path_rels)
            yield out
            return
        el = elements[idx]
        if isinstance(el, ast.NodePattern):
            if idx == 0:
                for node in self._candidates(el, row, params):
                    if not self._passes_inline_where(node, el, row, params):
                        continue
                    new_row = dict(row)
                    if el.variable:
                        new_row[el.variable] = node
                    yield from self._match_elements(
                        path, base_row, params, idx + 1, new_row,
                        path_nodes + [node], path_rels,
                    )
            else:
                raise CypherTypeError("internal: node pattern out of sequence")
            return
        # relationship element: el, followed by target node element
        rel_pat = el
        target_pat = elements[idx + 1]
        src = path_nodes[-1]
        props = self._rel_props(rel_pat, row, params)
        tprops = self._node_props(target_pat, row, params)
        if rel_pat.var_length:
            yield from self._match_var_length(
                path, params, idx, row, path_nodes, path_rels, rel_pat,
                target_pat, props, tprops, src,
            )
            return
        need_edges = bool(rel_pat.variable or path.name)
        for edge, other_id in self._expand(
            src.id, rel_pat, props, materialize=need_edges
        ):
            eid = _rel_id(edge)
            if any(_rel_id(e) == eid for e in path_rels):
                continue  # relationship isomorphism
            try:
                other = self.storage.get_node(other_id)
            except NotFoundError:
                continue
            if not self._node_matches(other, target_pat, tprops):
                continue
            if not self._passes_inline_where(other, target_pat, row, params):
                continue
            if target_pat.variable and target_pat.variable in row:
                bound = row[target_pat.variable]
                if not isinstance(bound, Node) or bound.id != other.id:
                    continue
            new_row = dict(row)
            if rel_pat.variable:
                new_row[rel_pat.variable] = edge
            if target_pat.variable:
                new_row[target_pat.variable] = other
            yield from self._match_elements(
                path, row, params, idx + 2, new_row,
                path_nodes + [other], path_rels + [edge],
            )

    def _match_var_length(
        self, path, params, idx, row, path_nodes, path_rels,
        rel_pat, target_pat, props, tprops, src,
    ) -> Iterator[dict[str, Any]]:
        """Variable-length expansion (ref: findPaths traversal.go:1127).

        With an edge-property filter or no usable snapshot this is the
        original DFS over per-node engine expansion; otherwise the
        frontier-batched CSR walk (_var_length_batched) produces the same
        paths — sorted back into the DFS's lexicographic edge-id order —
        with node/edge materialization only for surviving bindings."""
        max_h = min(rel_pat.max_hops, MAX_VAR_LENGTH)
        min_h = rel_pat.min_hops
        need_edges = bool(rel_pat.variable or path.name)

        if props is None:
            snap = self._snap()
            if snap is not None and snap.ensure():
                found = self._var_length_batched(
                    snap, params, row, path_rels, rel_pat, target_pat,
                    tprops, src, min_h, max_h, need_edges)
                if found is not None:
                    # no zero-edge filter needed: the batched walk only
                    # yields at hops >= min_h, one edge per hop
                    start_nodes = list(path_nodes)
                    for new_row, nodes, rels in found:
                        yield from self._match_elements(
                            path, row, params, idx + 2, new_row,
                            start_nodes + nodes, path_rels + rels,
                        )
                    return

        def walk(curr: Node, hops: int, rels: list[Edge], nodes: list[Node]):
            if hops >= min_h:
                if self._node_matches(curr, target_pat, tprops) and \
                        self._passes_inline_where(curr, target_pat, row, params):
                    if target_pat.variable and target_pat.variable in row:
                        bound = row[target_pat.variable]
                        ok = isinstance(bound, Node) and bound.id == curr.id
                    else:
                        ok = True
                    if ok:
                        new_row = dict(row)
                        if rel_pat.variable:
                            new_row[rel_pat.variable] = list(rels)
                        if target_pat.variable:
                            new_row[target_pat.variable] = curr
                        yield new_row, list(nodes), list(rels)
            if hops >= max_h:
                return
            for edge, other_id in self._expand(
                curr.id, rel_pat, props, materialize=need_edges
            ):
                eid = _rel_id(edge)
                if any(_rel_id(e) == eid for e in rels) or any(
                    _rel_id(e) == eid for e in path_rels
                ):
                    continue
                try:
                    other = self.storage.get_node(other_id)
                except NotFoundError:
                    continue
                yield from walk(other, hops + 1, rels + [edge], nodes + [other])

        start_nodes = list(path_nodes)
        if min_h == 0:
            # zero-length: current node is also the target
            for new_row, nodes, rels in walk(src, 0, [], []):
                yield from self._match_elements(
                    path, row, params, idx + 2, new_row,
                    start_nodes + nodes, path_rels + rels,
                )
            return
        for new_row, nodes, rels in walk(src, 0, [], []):
            if not rels:
                continue
            yield from self._match_elements(
                path, row, params, idx + 2, new_row,
                start_nodes + nodes, path_rels + rels,
            )

    def _var_length_batched(
        self, snap, params, row, path_rels, rel_pat, target_pat,
        tprops, src, min_h: int, max_h: int, need_edges: bool,
    ) -> Optional[list[tuple[dict, list[Node], list]]]:
        """Frontier-batched var-length walk over CSR slices: each hop is
        one batched gather over the unique frontier endpoints (rel-type
        filtering via the code column), partial paths stay as index/edge-id
        tuples, and Nodes/Edges are fetched only for paths that survive the
        target checks. Results are sorted by their edge-id sequence, which
        reproduces the generic DFS's yield order exactly. None -> caller
        falls back to the generic walk."""
        src_idx = snap.index_of(src.id)
        if src_idx is None:
            return None
        codes = snap.type_codes(rel_pat.types)
        excluded = {_rel_id(e) for e in path_rels}
        bound_idx = -1  # -1 = unbound; None = bound to a node not in vocab
        if target_pat.variable and target_pat.variable in row:
            bound = row[target_pat.variable]
            if not isinstance(bound, Node):
                return []
            bound_idx = snap.index_of(bound.id)
        node_cache: dict[int, Node] = {src_idx: src}
        edge_cache: dict[str, Edge] = {}

        def fetch_nodes(idxs) -> None:
            missing = [i for i in idxs if i not in node_cache]
            if not missing:
                return
            ids = snap.ids_of(missing)
            got = {n.id: n for n in self.storage.batch_get_nodes(ids)}
            for i, nid in zip(missing, ids):
                n = got.get(nid)
                if n is not None:
                    node_cache[i] = n

        # partial path: (endpoint idx, edge-id tuple, node-idx tuple)
        matched: list[tuple[tuple, tuple, Node]] = []
        level: list[tuple[int, tuple, tuple]] = [(src_idx, (), ())]
        hops = 0
        while True:
            if hops >= min_h and level:
                # bound target: only paths ending AT the bound node can
                # yield — filter on indices before materializing anything
                check = level if bound_idx == -1 else \
                    [p for p in level if p[0] == bound_idx]
                fetch_nodes({p[0] for p in check})
                for last, eids, nidxs in check:
                    curr = node_cache.get(last)
                    if curr is None:
                        continue  # vanished mid-walk: generic skips it too
                    if not self._node_matches(curr, target_pat, tprops):
                        continue
                    if not self._passes_inline_where(curr, target_pat,
                                                     row, params):
                        continue
                    matched.append((eids, nidxs, curr))
            if hops >= max_h or not level:
                break
            endpoints = list(dict.fromkeys(p[0] for p in level))
            adj = snap.expand_frontier(endpoints, rel_pat.direction, codes)
            nxt = []
            for last, eids, nidxs in level:
                for eid, oidx in adj.get(last, ()):
                    if eid in excluded or eid in eids:
                        continue  # relationship isomorphism
                    nxt.append((oidx, eids + (eid,), nidxs + (oidx,)))
            if len(nxt) + len(matched) > MAX_BATCHED_PATHS:
                return None  # combinatorial blowup: lazy generic DFS instead
            level = nxt
            hops += 1
        matched.sort(key=lambda t: t[0])
        out = []
        for eids, nidxs, curr in matched:
            fetch_nodes(set(nidxs))
            nodes: list[Node] = []
            ok = True
            for i in nidxs:
                n = node_cache.get(i)
                if n is None:
                    ok = False
                    break
                nodes.append(n)
            if not ok:
                continue
            rels: list = []
            if need_edges:
                for eid in eids:
                    e = edge_cache.get(eid)
                    if e is None:
                        try:
                            e = self.storage.get_edge(eid)
                        except NotFoundError:
                            break
                        edge_cache[eid] = e
                    rels.append(e)
                if len(rels) != len(eids):
                    continue
            else:
                rels = list(eids)
            new_row = dict(row)
            if rel_pat.variable:
                new_row[rel_pat.variable] = list(rels)
            if target_pat.variable:
                new_row[target_pat.variable] = curr
            out.append((new_row, nodes, rels))
        return out

    # -- shortest path -------------------------------------------------------------
    def _match_shortest(
        self, path: ast.PatternPath, row: dict, params: dict
    ) -> Iterator[dict[str, Any]]:
        """(ref: shortestPath traversal.go:1332) — BFS between two bound/matched
        endpoints over the middle relationship pattern."""
        if len(path.elements) != 3:
            raise CypherTypeError("shortestPath expects (a)-[rel]-(b)")
        start_pat, rel_pat, end_pat = path.elements
        props = self._rel_props(rel_pat, row, params)
        max_h = min(rel_pat.max_hops if rel_pat.var_length else MAX_VAR_LENGTH,
                    MAX_VAR_LENGTH)
        for start in self._candidates(start_pat, row, params):
            for end in self._candidates(end_pat, row, params):
                found = self._bfs_shortest(
                    start, end, rel_pat, props, max_h,
                    all_paths=(path.shortest == "allshortest"),
                )
                for nodes, rels in found:
                    out = dict(row)
                    if start_pat.variable:
                        out[start_pat.variable] = start
                    if end_pat.variable:
                        out[end_pat.variable] = end
                    if rel_pat.variable:
                        out[rel_pat.variable] = rels
                    if path.name:
                        out[path.name] = make_path(nodes, rels)
                    yield out

    def _bfs_shortest(
        self, start: Node, end: Node, rel_pat, props, max_h: int,
        all_paths: bool = False,
    ) -> list[tuple[list[Node], list[Edge]]]:
        if start.id == end.id:
            return [([start], [])]
        if props is None:
            snap = self._snap()
            if snap is not None and snap.ensure():
                res = self._bfs_shortest_batched(
                    snap, start, end, rel_pat, max_h, all_paths)
                if res is not None:
                    return res
        return self._bfs_shortest_generic(
            start, end, rel_pat, props, max_h, all_paths)

    def _bfs_shortest_batched(
        self, snap, start: Node, end: Node, rel_pat, max_h: int,
        all_paths: bool,
    ) -> Optional[list[tuple[list[Node], list[Edge]]]]:
        """BFS over CSR slices: one batched expansion per level over the
        unique frontier endpoints; partial paths are index/edge-id tuples
        and only result paths materialize Nodes/Edges. Frontier order and
        per-node edge-id order match the generic BFS, so the first path
        found (and the all-shortest set) is identical."""
        si = snap.index_of(start.id)
        ei = snap.index_of(end.id)
        if si is None or ei is None:
            return None  # snapshot lagging the engine: generic path decides
        codes = snap.type_codes(rel_pat.types)
        frontier: list[tuple[int, tuple, tuple]] = [(si, (), ())]
        visited = {si}
        found: list[tuple[tuple, tuple]] = []
        for _ in range(max_h):
            endpoints = list(dict.fromkeys(p[0] for p in frontier))
            adj = snap.expand_frontier(endpoints, rel_pat.direction, codes)
            nxt: list[tuple[int, tuple, tuple]] = []
            level_visited: set[int] = set()
            for nid, eids, nidxs in frontier:
                for eid, oidx in adj.get(nid, ()):
                    if oidx in visited:
                        continue
                    p = (eids + (eid,), nidxs + (oidx,))
                    if oidx == ei:
                        found.append(p)
                        if not all_paths:
                            return self._materialize_index_paths(
                                snap, start, found)
                        continue
                    level_visited.add(oidx)
                    nxt.append((oidx, p[0], p[1]))
            if found:
                break
            visited |= level_visited
            frontier = nxt
            if not frontier:
                break
        return self._materialize_index_paths(snap, start, found)

    def _materialize_index_paths(
        self, snap, start: Node, items: list[tuple[tuple, tuple]],
    ) -> list[tuple[list[Node], list[Edge]]]:
        node_cache: dict[int, Node] = {}
        out: list[tuple[list[Node], list[Edge]]] = []
        for eids, nidxs in items:
            nodes = [start]
            ok = True
            for i in nidxs:
                n = node_cache.get(i)
                if n is None:
                    try:
                        n = self.storage.get_node(snap.id_of(i))
                    except NotFoundError:
                        ok = False
                        break
                    node_cache[i] = n
                nodes.append(n)
            if not ok:
                continue
            rels: list[Edge] = []
            for eid in eids:
                try:
                    rels.append(self.storage.get_edge(eid))
                except NotFoundError:
                    ok = False
                    break
            if ok:
                out.append((nodes, rels))
        return out

    def _bfs_shortest_generic(
        self, start: Node, end: Node, rel_pat, props, max_h: int,
        all_paths: bool = False,
    ) -> list[tuple[list[Node], list[Edge]]]:
        if start.id == end.id:
            return [([start], [])]
        frontier: list[tuple[str, list[Node], list[Edge]]] = [(start.id, [start], [])]
        visited = {start.id}
        results: list[tuple[list[Node], list[Edge]]] = []
        for _ in range(max_h):
            nxt: list[tuple[str, list[Node], list[Edge]]] = []
            level_visited: set[str] = set()
            for nid, nodes, rels in frontier:
                for edge, other_id in self._expand(nid, rel_pat, props):
                    if other_id in visited:
                        continue
                    try:
                        other = self.storage.get_node(other_id)
                    except NotFoundError:
                        continue
                    p = (nodes + [other], rels + [edge])
                    if other_id == end.id:
                        results.append(p)
                        if not all_paths:
                            return results
                        continue
                    level_visited.add(other_id)
                    nxt.append((other_id, p[0], p[1]))
            if results:
                return results
            visited |= level_visited
            frontier = nxt
            if not frontier:
                break
        return results


def _value_eq(a: Any, b: Any) -> bool:
    if a is None and b is None:
        return True
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b
