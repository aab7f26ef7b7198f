"""Columnar Cypher operator pipeline over the CSR adjacency snapshot: the
port's copy of ``nornicdb_tpu/cypher/columnar.py``.

This module retires the executor's ad-hoc pattern-fastpath family
(``query_patterns.go`` / ``optimized_executors.go`` in the reference) into
one architecture: a planner pattern-compiles a ``Query`` AST into a DAG of
batched array operators — NodeScan / Filter / Expand / VarLenExpand /
JoinCheck / With / Aggregate / Project / Sort-Limit / VectorTopK —
evaluated over:

* the CSR snapshot (``storage/adjacency.py``): per-direction
  ``offsets``/``neighbors``/``edge_rows`` arrays plus per-edge
  src/dst/type columns, captured per query as a delta-folded
  :class:`~nornicdb_tpu_torch.storage.adjacency.CSRView`;
* the colindex property columns (``cypher/colindex.py``) for label-scan
  WHERE masks, via the same :func:`~nornicdb_tpu_torch.cypher.parallel.compile_where`
  compiler the scan fastpath uses — bit-identical three-valued semantics;
* batched node/edge materialization (one ``batch_get_nodes`` per variable,
  never a per-row engine call) for property gathers and projections.

**Equivalence contract** (the snapshot discipline, enforced by
``tests/test_columnar.py``): every columnar result is bit-identical to the
generic interpreter, *including row order*.  Scans emit id-sorted
candidates; expansions order each frontier node's edges by edge id (the
``erow_rank`` array), nested hops compose lexicographically — exactly the
generic DFS order.  Aggregation groups in first-encounter order, float
sums run left-to-right per group (Python ``sum``, not pairwise
``np.sum``), and sorting reuses the executor's ``_multisort``.

**Per-operator fallback**: any unsupported expression or clause ends the
columnar prefix with a ``FallbackOp`` that materializes the partial
binding table into generic rows and hands them to the interpreter for the
remaining clauses (plus any residual WHERE conjuncts — sound to apply
late because WHERE is conjunctive and every filter here is
order-stable).  Shapes with no plannable prefix return to the generic
engine untouched.

**Clause boundaries don't stop the pipeline**: multi-MATCH
queries hash-join/cartesian against the standing id columns, ``WITH``
projects or aggregates the table in place (value columns cross the
boundary as plain row-aligned lists), bounded var-length hops
(``*min..max``) run as batched per-level CSR gathers with rank-lexsorted
emission, and edge-property filters/aggregates ride the CSR-resident
edge property columns.

**Device offload**: scoring-heavy Sort/Limit plans (large N, small K,
single numeric key) find the boundary value with ``torch.topk`` over
float32 keys on the executor's device, then host-sort only the surviving
candidate set: results remain bit-identical because the boundary is
widened (``nextafter``) before the exact stable sort.

**VectorTopK**: ``MATCH ... WHERE <preds> ORDER BY
vector.similarity.cosine(n.emb, $q) [DESC] LIMIT k`` plans the ranking
as a device product: graph-predicate survivors become a validity mask over
a cached label-wide normalized embedding matrix (epoch-validated against
the colindex), ``search.service.graph_masked_scores`` finds the k-th
boundary on the executor's device, and the widened boundary cut is
exact-rescored on the host with the real ``vector.similarity.cosine`` so
ordering — ties, nulls, errors included — bit-matches the interpreter.

**What differs from the JAX package.** Both offloads gate through the
device owner (``nornicdb_tpu_torch.backend``) and keep only the
data-driven bail-outs, each counted as
``nornicdb_cypher_offloads_total{outcome="unavailable"}`` where JAX counts
it: too few rows, ``k * 4 > n`` or k over the cutover, NaN keys, a
candidate count below k, ragged/null/non-finite embedding rows. A device
or CUDA error propagates, and a card that is not serving raises
DeviceUnavailable within ``acquire_timeout``: neither ever ends on the
host. JAX catches every exception, and goes to the host whenever its
manager is not ready.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import weakref
from typing import Any, Callable, Optional

import numpy as np

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.cypher import parallel as _parallel
from nornicdb_tpu_torch.cypher.parallel import (
    CompiledWhere,
    NodeListSource,
    _join_and,
    _split_and,
)
from nornicdb_tpu_torch.cypher.plan import (
    OFFLOAD_CELLS,
    OP_CELLS,
    Q_CELLS,
    ROWS_HIST,
    PlanCache,
    key_hash,
    merge_lits,
    normalize_query,
)
from nornicdb_tpu_torch.errors import NotFoundError
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

log = logging.getLogger(__name__)

_AGG_FNS = ("count", "sum", "avg", "min", "max", "collect")


class _Bail(Exception):
    """Capability bail: hand the whole query back to the generic engine.
    Never used for real query errors — those propagate unchanged."""


# ---------------------------------------------------------------- helpers
def _expr_vars(e: Any, out: set) -> None:
    """Every Variable name under ``e`` (conservative: shadowed comprehension
    locals count too, which only routes the conjunct to the residual)."""
    if isinstance(e, ast.Variable):
        out.add(e.name)
        return
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            _expr_vars(getattr(e, f.name), out)
    elif isinstance(e, (list, tuple)):
        for x in e:
            _expr_vars(x, out)
    elif isinstance(e, dict):
        for v in e.values():
            _expr_vars(v, out)


class _ObjSource:
    """Column access over a materialized per-row entity list (the
    compile_where source protocol; None entities read as all-null)."""

    def __init__(self, objs: list):
        self.objs = objs

    def __len__(self) -> int:
        return len(self.objs)

    def column(self, key: str) -> list:
        return [o.properties.get(key) if o is not None else None
                for o in self.objs]


def _const_getter(e: ast.Expr) -> Optional[Callable[[dict], Any]]:
    if isinstance(e, ast.Literal):
        return lambda params, v=e.value: v
    if isinstance(e, ast.Parameter):
        return lambda params, n=e.name: params.get(n)
    return None


def _colindex_for(ex, label: str):
    """The executor's columnar scan index, honoring the operator escape
    hatch: raising ``ParallelConfig.columnar_min_rows`` bypasses the scan
    index everywhere (the `_match_scan_fast`/`colindex` contract) — the
    pipeline then serves the same results through engine label scans."""
    if ex.storage.count_nodes_by_label(label) < \
            _parallel.get_parallel_config().columnar_min_rows:
        return None
    return ex._scan_index()


# ---------------------------------------------------------------- state
class _State:
    """Mutable execution state: the columnar binding table.

    ``node_cols[var]`` is an int64 array of snapshot vocab indices;
    ``edge_cols[var]`` an int64 array of CSR edge-row numbers valid for
    the pinned ``view``.  Row order IS the generic engine's row order."""

    def __init__(self, ex, q, params, stats, snap, view, trace):
        self.ex = ex
        self.q = q
        self.params = params
        self.stats = stats
        self.snap = snap
        self.view = view
        self.trace = trace
        self.n = 0
        self.node_cols: dict[str, np.ndarray] = {}
        self.edge_cols: dict[str, np.ndarray] = {}
        # WITH-projected value columns (plain Python lists, row-aligned):
        # aggregates, property projections and constants that survive a
        # clause boundary without ever becoming generic binding rows
        self.val_cols: dict[str, list] = {}
        self.version = 0
        self.peak_rows = 0
        # var -> single label every row of that column is known to carry
        # (scan label / enforced dst-label mask): lets property gathers
        # ride the colindex columns instead of materializing Node copies
        self.var_label: dict[str, str] = {}
        self._objs: dict[tuple[str, int], list] = {}
        self._edge_objs: dict[tuple[str, int], list] = {}
        self._row_ids: dict[tuple[str, int], list] = {}
        self._label_idx: dict[tuple, np.ndarray] = {}

    # -- table mutation ----------------------------------------------------
    def set_initial(self, var: str, idx: np.ndarray,
                    objs: Optional[list] = None,
                    label: Optional[str] = None) -> None:
        self.n = len(idx)
        self.node_cols = {var: idx}
        self.edge_cols = {}
        self.val_cols = {}
        self.version += 1
        self.peak_rows = max(self.peak_rows, self.n)
        if objs is not None:
            self._objs[(var, self.version)] = objs
        if label is not None:
            self.var_label[var] = label

    def root(self, var: str, idx: np.ndarray,
             objs: Optional[list] = None,
             label: Optional[str] = None) -> None:
        """Root a new pattern chain: first chain seeds the table, later
        chains cartesian-join against it (row-major × id-sorted candidate
        order — exactly the generic nested-loop enumeration)."""
        if not self.node_cols and not self.edge_cols and not self.val_cols:
            self.set_initial(var, idx, objs, label)
            return
        n_old, m = self.n, len(idx)
        sel = np.repeat(np.arange(n_old, dtype=np.int64), m)
        self.version += 1
        self._objs.clear()
        self._edge_objs.clear()
        self._row_ids.clear()
        for k, col in self.node_cols.items():
            self.node_cols[k] = col[sel]
        for k, col in self.edge_cols.items():
            self.edge_cols[k] = col[sel]
        if self.val_cols:
            sel_list = sel.tolist()
            for k, col in self.val_cols.items():
                self.val_cols[k] = [col[i] for i in sel_list]
        self.node_cols[var] = np.tile(idx, n_old)
        self.n = n_old * m
        self.peak_rows = max(self.peak_rows, self.n)
        if objs is not None:
            self._objs[(var, self.version)] = objs * n_old
        if label is not None:
            self.var_label[var] = label

    def apply_sel(self, sel: np.ndarray) -> None:
        """Gather every column through ``sel`` (filter survivors, sort
        permutation, slice) — memoized materializations re-key along."""
        old_version = self.version
        self.version += 1
        for k, col in self.node_cols.items():
            self.node_cols[k] = col[sel]
        for k, col in self.edge_cols.items():
            self.edge_cols[k] = col[sel]
        # re-key surviving materializations instead of refetching
        sel_list = sel.tolist()
        for k, col in self.val_cols.items():
            self.val_cols[k] = [col[i] for i in sel_list]
        for (var, ver), objs in list(self._objs.items()):
            if ver == old_version:
                self._objs[(var, self.version)] = [objs[i] for i in sel_list]
        for (var, ver), objs in list(self._edge_objs.items()):
            if ver == old_version:
                self._edge_objs[(var, self.version)] = [objs[i]
                                                        for i in sel_list]
        for (var, ver), ids in list(self._row_ids.items()):
            if ver == old_version:
                self._row_ids[(var, self.version)] = [ids[i]
                                                      for i in sel_list]
        self.n = len(sel)

    def apply_mask(self, mask: np.ndarray) -> None:
        self.apply_sel(np.nonzero(mask)[0])

    def apply_expand(self, src_row: np.ndarray, dst_var: Optional[str],
                     dst_idx: Optional[np.ndarray],
                     edge_var: Optional[str],
                     edge_rows: Optional[np.ndarray]) -> None:
        self.version += 1
        self._objs.clear()   # refetched lazily against the new row set
        self._edge_objs.clear()
        self._row_ids.clear()
        for k, col in self.node_cols.items():
            self.node_cols[k] = col[src_row]
        for k, col in self.edge_cols.items():
            self.edge_cols[k] = col[src_row]
        if self.val_cols:
            src_list = src_row.tolist()
            for k, col in self.val_cols.items():
                self.val_cols[k] = [col[i] for i in src_list]
        if dst_var is not None and dst_idx is not None:
            self.node_cols[dst_var] = dst_idx
        if edge_var is not None and edge_rows is not None:
            self.edge_cols[edge_var] = edge_rows
        self.n = len(src_row)
        self.peak_rows = max(self.peak_rows, self.n)

    def replace_table(self, node_cols: dict, edge_cols: dict,
                      val_cols: dict, var_label: dict, n: int) -> None:
        """Swap in a WITH projection's binding table: the old variable
        namespace is gone, only the projected aliases survive."""
        self.version += 1
        self._objs.clear()
        self._edge_objs.clear()
        self._row_ids.clear()
        self.node_cols = node_cols
        self.edge_cols = edge_cols
        self.val_cols = val_cols
        self.var_label = var_label
        self.n = n
        self.peak_rows = max(self.peak_rows, n)

    # -- gathers -----------------------------------------------------------
    def node_objects(self, var: str) -> list:
        key = (var, self.version)
        hit = self._objs.get(key)
        if hit is not None:
            return hit
        idxs = self.node_cols[var]
        uniq = np.unique(idxs) if len(idxs) else np.zeros(0, np.int64)
        ids_list = self.view.ids
        uid_pairs = [(i, ids_list[i]) for i in uniq.tolist()]
        by_id = {n.id: n for n in self.ex.storage.batch_get_nodes(
            sorted(p[1] for p in uid_pairs))}
        by_idx = {i: by_id.get(s) for i, s in uid_pairs}
        out = [by_idx[i] for i in idxs.tolist()]
        self._objs[key] = out
        return out

    def edge_objects(self, var: str) -> list:
        key = (var, self.version)
        hit = self._edge_objs.get(key)
        if hit is not None:
            return hit
        rows = self.edge_cols[var]
        uniq = np.unique(rows) if len(rows) else np.zeros(0, np.int64)
        row_ids = self.view.row_ids
        by_row: dict[int, Any] = {}
        for r in uniq.tolist():
            try:
                by_row[r] = self.ex.storage.get_edge(row_ids[r])
            except NotFoundError:
                by_row[r] = None  # deleted mid-query: reads as null
        out = [by_row[r] for r in rows.tolist()]
        self._edge_objs[key] = out
        return out

    def row_ids_for(self, var: str) -> list:
        memo_key = (var, self.version)
        hit = self._row_ids.get(memo_key)
        if hit is None:
            ids_list = self.view.ids
            hit = [ids_list[i] for i in self.node_cols[var].tolist()]
            self._row_ids[memo_key] = hit
        return hit

    def prop_column(self, var: str, key: str) -> list:
        if var not in self.node_cols:
            # CSR-resident edge property columns: one row-aligned gather,
            # no per-edge materialization (the retired _fp_edge_agg scan)
            rows = self.edge_cols[var]
            col = self.view.edge_prop_column(key)
            if col is None:
                return [None] * len(rows)
            return [col[r] for r in rows.tolist()]
        label = self.var_label.get(var)
        if label is not None and (var, self.version) not in self._objs:
            colind = _colindex_for(self.ex, label)
            if colind is not None:
                vals = colind.column_values(label, key,
                                            self.row_ids_for(var))
                if vals is not None:
                    return vals
        return _ObjSource(self.node_objects(var)).column(key)

    def label_member_idx(self, labels: tuple) -> np.ndarray:
        """Vocab indices of every node carrying any of ``labels``."""
        hit = self._label_idx.get(labels)
        if hit is not None:
            return hit
        ids: set[str] = set()
        for label in labels:
            colind = _colindex_for(self.ex, label)
            got = colind.label_ids(label) if colind is not None else None
            if got is None:
                got = [n.id for n in
                       self.ex.storage.get_nodes_by_label(label)]
            ids.update(got)
        idx = self.snap.indices_of(sorted(ids)) if ids else \
            np.zeros(0, np.int64)
        idx = idx[idx >= 0]
        self._label_idx[labels] = idx
        return idx

    # -- generic-row materialization --------------------------------------
    def materialize_rows(self, named_node_vars: list[str],
                         named_edge_vars: list[str],
                         named_val_vars: Optional[list[str]] = None,
                         ) -> list[dict]:
        cols: dict[str, list] = {}
        for var in named_node_vars:
            cols[var] = self.node_objects(var)
        for var in named_edge_vars:
            cols[var] = self.edge_objects(var)
        for var in (named_val_vars or ()):
            cols[var] = self.val_cols[var]
        names = list(cols)
        lists = [cols[v] for v in names]
        return [dict(zip(names, vals)) for vals in zip(*lists)] \
            if names else [{} for _ in range(self.n)]


# ---------------------------------------------------------------- operators
class _Op:
    kind = "scan"
    engine = "columnar"
    label = ""
    self_timed = False  # ReturnOp observes its own sub-phase cells

    def run(self, st: _State):  # pragma: no cover - interface
        raise NotImplementedError


def _ids_to_idx(st: _State, ids: list[str]) -> np.ndarray:
    idx = st.snap.indices_of(ids)
    if len(idx) and (idx < 0).any():
        # a scan source knows a node the snapshot doesn't: stale event
        # window — serve this query generically rather than drop rows
        raise _Bail("scan id missing from snapshot vocab")
    return idx


def _scan_cache_get(st: _State, labels: tuple) -> Optional[np.ndarray]:
    """Cross-query memo of a sorted label scan's vocab indices.  Sound
    because the entry pins both the snapshot object (vocab identity) and
    every label's colindex epoch (membership): any node event bumps the
    epoch, any vocab rebuild replaces the snapshot."""
    ceng = getattr(st.ex, "columnar", None)
    if ceng is None:
        return None
    with ceng._scan_lock:
        hold = ceng._scan_cache
        if hold is None or hold[0] is not st.snap:
            return None
        hit = hold[1].get(labels)
    if hit is None:
        return None
    epochs, idx = hit
    for label, ep in zip(labels, epochs):
        colind = _colindex_for(st.ex, label)
        if colind is None or colind.epoch() != ep:
            return None
    return idx


def _scan_cache_put(st: _State, labels: tuple, idx: np.ndarray) -> None:
    ceng = getattr(st.ex, "columnar", None)
    if ceng is None:
        return
    epochs = []
    for label in labels:
        colind = _colindex_for(st.ex, label)
        if colind is None:
            return
        epochs.append(colind.epoch())
    with ceng._scan_lock:
        hold = ceng._scan_cache
        if hold is None or hold[0] is not st.snap:
            hold = (st.snap, {})
            ceng._scan_cache = hold
        if len(hold[1]) >= 16:
            hold[1].clear()
        hold[1][labels] = (tuple(epochs), idx)


class AnchorScanOp(_Op):
    """Anchor with a property map: index-backed candidate lookup through
    the matcher (schema equality indexes), id-sorted by contract."""

    kind = "scan"

    def __init__(self, var: str, node_pat: ast.NodePattern):
        self.var = var
        self.pat = ast.NodePattern(node_pat.variable, node_pat.labels,
                                   node_pat.properties)
        props = ", ".join(node_pat.properties.items.keys()) \
            if node_pat.properties else ""
        self.label = f"AnchorScan({var}:{':'.join(node_pat.labels)} " \
                     f"{{{props}}})"

    def run(self, st: _State):
        ex = st.ex
        if len(self.pat.labels) == 1 and self.pat.properties is not None:
            label = self.pat.labels[0]
            keys = sorted(self.pat.properties.items.keys())
            indexed = ex.schema is not None and (
                ex.schema.has_prop_index(label, keys)
                or any(ex.schema.has_prop_index(label, [k]) for k in keys))
            colind = None if indexed else _colindex_for(ex, label)
            if colind is not None:
                # unindexed anchor: equality mask over the label columns —
                # survivors only, no per-candidate Node materialization
                props = ex.matcher._node_props(self.pat, {}, st.params)
                ids = colind.prop_match_ids(label, props or {})
                if ids is not None:
                    st.root(self.var, _ids_to_idx(st, sorted(ids)),
                            label=label)
                    return
        nodes = ex.matcher._candidates(self.pat, {}, st.params)
        idx = _ids_to_idx(st, [n.id for n in nodes])
        st.root(self.var, idx, objs=nodes,
                label=self.pat.labels[0]
                if len(self.pat.labels) == 1 else None)


class LabelScanOp(_Op):
    kind = "scan"

    def __init__(self, var: str, labels: list[str]):
        self.var = var
        self.labels = list(labels)
        self.label = f"NodeScan({var}:{':'.join(labels)})"

    def run(self, st: _State):
        lbl = self.labels[0] if len(self.labels) == 1 else None
        key = tuple(self.labels)
        idx = _scan_cache_get(st, key)
        if idx is not None:
            st.root(self.var, idx, label=lbl)
            return
        ids: Optional[set[str]] = set()
        for label in self.labels:
            colind = _colindex_for(st.ex, label)
            got = colind.label_ids(label) if colind is not None else None
            if got is None:
                ids = None
                break
            ids.update(got)
        objs = None
        if ids is None:
            seen: dict[str, Any] = {}
            for label in self.labels:
                for n in st.ex.storage.get_nodes_by_label(label):
                    seen[n.id] = n
            ordered = sorted(seen)
            objs = [seen[i] for i in ordered]
            idx = _ids_to_idx(st, ordered)
        else:
            idx = _ids_to_idx(st, sorted(ids))
            _scan_cache_put(st, key, idx)
        st.root(self.var, idx, objs=objs, label=lbl)


class AllScanOp(_Op):
    kind = "scan"

    def __init__(self, var: str):
        self.var = var
        self.label = f"NodeScan({var})"

    def run(self, st: _State):
        view = st.view
        alive = np.nonzero(view.node_alive)[0]
        pairs = sorted((view.ids[i], i) for i in alive.tolist())
        idx = np.fromiter((p[1] for p in pairs), np.int64, len(pairs))
        st.root(self.var, idx)


class MaskedLabelScanOp(_Op):
    """Fused label scan + fully-columnar WHERE mask over the colindex
    property columns — survivors only ever materialize as ids."""

    kind = "scan"

    def __init__(self, var: str, label: str, cw: CompiledWhere,
                 where_text: str):
        self.var = var
        self.lbl = label
        self.cw = cw
        self.label = f"NodeScan({var}:{label} WHERE {where_text})"

    def run(self, st: _State):
        colind = _colindex_for(st.ex, self.lbl)
        ids = colind.masked_ids(self.lbl, self.cw, st.params) \
            if colind is not None else None
        objs = None
        if ids is None:  # busy build window / no index: engine scan + mask
            nodes = st.ex.storage.get_nodes_by_label(self.lbl)
            nodes.sort(key=lambda n: n.id)
            mask = self.cw.mask(NodeListSource(nodes), st.params)
            objs = [n for n, m in zip(nodes, mask) if m]
            ordered = [n.id for n in objs]
        else:
            ordered = sorted(ids)
        st.root(self.var, _ids_to_idx(st, ordered), objs=objs,
                label=self.lbl)


class FilterOp(_Op):
    kind = "filter"

    def __init__(self, var: str, cw: CompiledWhere, where_text: str):
        self.var = var
        self.cw = cw
        self.label = f"Filter({var}: {where_text})"

    def run(self, st: _State):
        if not st.n:
            return

        class _Src:  # compile_where column protocol over state gathers
            def __init__(self, state, var):
                self.state, self.var = state, var

            def __len__(self):
                return self.state.n

            def column(self, key):
                return self.state.prop_column(self.var, key)

        st.apply_mask(self.cw.mask(_Src(st, self.var), st.params))


class ExpandOp(_Op):
    kind = "expand"

    def __init__(self, src_var: str, rel: ast.RelPattern, dst_var: str,
                 dst_join: bool, dst_labels: list[str], edge_var: str,
                 prior_edge_vars: list[str]):
        self.src_var = src_var
        self.types = list(rel.types)
        self.direction = rel.direction
        self.dst_var = dst_var
        self.dst_join = dst_join
        self.dst_labels = tuple(dst_labels)
        self.edge_var = edge_var
        self.prior = list(prior_edge_vars)
        arrow = {"out": "-%s->", "in": "<-%s-", "both": "-%s-"}[rel.direction]
        t = (":" + "|".join(rel.types)) if rel.types else ""
        rel_txt = arrow % (f"[{t}]" if t else "[]")
        self.label = f"Expand(({src_var}){rel_txt}({dst_var}))"

    def run(self, st: _State):
        if not st.n:
            st.apply_expand(np.zeros(0, np.int64), None
                            if self.dst_join else self.dst_var,
                            np.zeros(0, np.int64), self.edge_var,
                            np.zeros(0, np.int64))
            return
        view = st.view
        codes = view.codes_for(self.types)
        src = st.node_cols[self.src_var]
        if self.types and not codes:
            empty = np.zeros(0, np.int64)
            st.apply_expand(empty, None if self.dst_join else self.dst_var,
                            empty, self.edge_var, empty)
            return
        uniq, inv = np.unique(src, return_inverse=True)
        counts, rows, nbrs = view.expand_unique(uniq, self.direction, codes)
        seg_start = np.zeros(len(counts), np.int64)
        if len(counts) > 1:
            seg_start[1:] = np.cumsum(counts)[:-1]
        row_counts = counts[inv]
        total = int(row_counts.sum())
        if not total:
            empty = np.zeros(0, np.int64)
            st.apply_expand(empty, None if self.dst_join else self.dst_var,
                            empty, self.edge_var, empty)
            return
        src_row = np.repeat(np.arange(st.n, dtype=np.int64), row_counts)
        shift = np.repeat(np.cumsum(row_counts) - row_counts, row_counts)
        flat = seg_start[inv][src_row] + (np.arange(total) - shift)
        new_rows = rows[flat]
        new_dst = nbrs[flat]
        keep: Optional[np.ndarray] = None
        for prev_var in self.prior:  # relationship isomorphism per path
            m = new_rows != st.edge_cols[prev_var][src_row]
            keep = m if keep is None else keep & m
        if self.dst_join:
            m = new_dst == st.node_cols[self.dst_var][src_row]
            keep = m if keep is None else keep & m
        if self.dst_labels:
            member = st.label_member_idx(self.dst_labels)
            m = np.isin(new_dst, member)
            keep = m if keep is None else keep & m
        if keep is not None and not keep.all():
            sel = np.nonzero(keep)[0]
            src_row, new_rows, new_dst = \
                src_row[sel], new_rows[sel], new_dst[sel]
        st.apply_expand(src_row, None if self.dst_join else self.dst_var,
                        new_dst, self.edge_var, new_rows)
        if not self.dst_join and len(self.dst_labels) == 1:
            # every surviving dst row passed the label mask: property
            # gathers for this var may ride the colindex columns
            st.var_label[self.dst_var] = self.dst_labels[0]


class JoinCheckOp(_Op):
    """A later MATCH clause re-anchoring on an already-bound variable with
    extra labels: one membership mask over the id column — the hash-join
    equivalent of the generic engine's bound-candidate label check."""

    kind = "join"

    def __init__(self, var: str, labels: list[str]):
        self.var = var
        self.labels = tuple(labels)
        self.label = f"JoinCheck({var}:{':'.join(labels)})"

    def run(self, st: _State):
        member = st.label_member_idx(self.labels)
        st.apply_mask(np.isin(st.node_cols[self.var], member))


class VarLenExpandOp(_Op):
    """Bounded-hop var-length expansion (``*min..max``) as batched CSR
    gathers: each hop is one ``expand_unique`` over the unique frontier,
    partial paths stay as (state-row, endpoint, per-hop rank) arrays, and
    relationship isomorphism is a per-hop rank-inequality mask.  Emitted
    paths are lexsorted by their edge-id rank sequence (−1-padded, so
    shorter prefixes sort first) under a stable state-row major key —
    exactly the generic walk's ``matched.sort(key=eids)`` yield order."""

    kind = "varlen"

    def __init__(self, src_var: str, rel: ast.RelPattern, dst_var: str,
                 dst_join: bool, dst_labels: list[str],
                 prior_edge_vars: list[str]):
        from nornicdb_tpu_torch.cypher.matcher import MAX_VAR_LENGTH

        self.src_var = src_var
        self.types = list(rel.types)
        self.direction = rel.direction
        self.min_hops = rel.min_hops
        self.max_hops = min(rel.max_hops, MAX_VAR_LENGTH)
        self.dst_var = dst_var
        self.dst_join = dst_join
        self.dst_labels = tuple(dst_labels)
        self.prior = list(prior_edge_vars)
        arrow = {"out": "-%s->", "in": "<-%s-", "both": "-%s-"}[rel.direction]
        t = (":" + "|".join(rel.types)) if rel.types else ""
        rel_txt = arrow % f"[{t}*{rel.min_hops}..{rel.max_hops}]"
        self.label = f"VarLenExpand(({src_var}){rel_txt}({dst_var}))"

    def run(self, st: _State):
        from nornicdb_tpu_torch.cypher.matcher import MAX_BATCHED_PATHS

        empty = np.zeros(0, np.int64)
        if not st.n:
            st.apply_expand(empty, None if self.dst_join else self.dst_var,
                            empty, None, None)
            return
        view = st.view
        codes = view.codes_for(self.types)
        no_edges = bool(self.types) and not codes
        path_row = np.arange(st.n, dtype=np.int64)
        cur = st.node_cols[self.src_var]
        hist_rows: list[np.ndarray] = []   # per-hop edge rows (identity)
        hist_ranks: list[np.ndarray] = []  # per-hop erow_rank (sort keys)
        out_rows: list[np.ndarray] = []
        out_cur: list[np.ndarray] = []
        out_hist: list[list[np.ndarray]] = []
        emitted = 0
        for level in range(self.max_hops + 1):
            if level >= self.min_hops:
                out_rows.append(path_row)
                out_cur.append(cur)
                out_hist.append(list(hist_ranks))
                emitted += len(path_row)
            if level == self.max_hops or not len(path_row) or no_edges:
                break
            uniq, inv = np.unique(cur, return_inverse=True)
            counts, rows, nbrs = view.expand_unique(uniq, self.direction,
                                                    codes)
            seg_start = np.zeros(len(counts), np.int64)
            if len(counts) > 1:
                seg_start[1:] = np.cumsum(counts)[:-1]
            pc = counts[inv]
            total = int(pc.sum())
            if not total:
                path_row = empty
                cur = empty
                hist_rows, hist_ranks = [], []
                continue
            src_pos = np.repeat(np.arange(len(path_row), dtype=np.int64), pc)
            shift = np.repeat(np.cumsum(pc) - pc, pc)
            flat = seg_start[inv][src_pos] + (np.arange(total) - shift)
            new_rows = rows[flat]
            new_dst = nbrs[flat]
            keep = np.ones(total, bool)
            for h in hist_rows:  # within-path relationship isomorphism
                keep &= new_rows != h[src_pos]
            for prev in self.prior:  # prior fixed hops of the same chain
                keep &= new_rows != st.edge_cols[prev][path_row[src_pos]]
            if not keep.all():
                sel = np.nonzero(keep)[0]
                src_pos, new_rows, new_dst = \
                    src_pos[sel], new_rows[sel], new_dst[sel]
            if emitted + len(src_pos) > MAX_BATCHED_PATHS:
                raise _Bail("var-length path blowup")
            hist_rows = [h[src_pos] for h in hist_rows] + [new_rows]
            hist_ranks = [h[src_pos] for h in hist_ranks] \
                + [view.erow_rank[new_rows]]
            path_row = path_row[src_pos]
            cur = new_dst
        if not emitted:
            st.apply_expand(empty, None if self.dst_join else self.dst_var,
                            empty, None, None)
            return
        rows_cat = np.concatenate(out_rows)
        cur_cat = np.concatenate(out_cur)
        max_len = max(len(h) for h in out_hist)
        rank_cols = []
        for d in range(max_len):
            parts = [h[d] if d < len(h)
                     else np.full(len(r), -1, np.int64)
                     for r, h in zip(out_rows, out_hist)]
            rank_cols.append(np.concatenate(parts))
        keep = None
        if self.dst_join:
            keep = cur_cat == st.node_cols[self.dst_var][rows_cat]
        if self.dst_labels:
            member = st.label_member_idx(self.dst_labels)
            m = np.isin(cur_cat, member)
            keep = m if keep is None else keep & m
        if keep is not None and not keep.all():
            sel = np.nonzero(keep)[0]
            rows_cat, cur_cat = rows_cat[sel], cur_cat[sel]
            rank_cols = [c[sel] for c in rank_cols]
        if max_len:
            order = np.lexsort(tuple(reversed(rank_cols)) + (rows_cat,))
        else:
            order = np.argsort(rows_cat, kind="stable")
        st.apply_expand(rows_cat[order],
                        None if self.dst_join else self.dst_var,
                        cur_cat[order], None, None)
        if not self.dst_join and len(self.dst_labels) == 1:
            st.var_label[self.dst_var] = self.dst_labels[0]


class EdgeCountOp(_Op):
    """MATCH ()-[r:T]->() RETURN count(r|*): one vectorized pass over the
    per-edge type column (the retired ``_fp_count`` edge shape)."""

    kind = "scan"

    def __init__(self, types: list[str], direction: str, out_key: str):
        self.types = list(types)
        self.direction = direction
        self.out_key = out_key
        t = (":" + "|".join(types)) if types else ""
        self.label = f"EdgeCount([{t}] {direction})"

    def run(self, st: _State):
        from nornicdb_tpu_torch.cypher.executor import Result

        view = st.view
        alive = view.row_alive
        if self.types:
            codes = view.codes_for(self.types)
            n = int((alive & np.isin(view.erow_type, codes)).sum()) \
                if codes else 0
        else:
            n = int(alive.sum())
        if self.direction == "both":
            n *= 2  # each edge matches once per orientation
        return Result([self.out_key], [[n]])


class NodeCountOp(_Op):
    """MATCH (n[:L]) RETURN count(n|*) without WHERE: O(1) engine counts
    (the retired ``_fp_count`` node shape)."""

    kind = "scan"

    def __init__(self, labels: list[str], out_key: str):
        self.labels = list(labels)
        self.out_key = out_key
        self.label = f"NodeCount({':'.join(labels) or '*'})"

    def run(self, st: _State):
        from nornicdb_tpu_torch.cypher.executor import Result

        storage = st.ex.storage
        if not self.labels:
            n = storage.node_count()
        elif len(self.labels) == 1:
            n = storage.count_nodes_by_label(self.labels[0])
        else:
            seen: set[str] = set()
            for label in self.labels:
                colind = _colindex_for(st.ex, label)
                got = colind.label_ids(label) if colind is not None else None
                if got is None:
                    got = [nd.id for nd in storage.get_nodes_by_label(label)]
                seen.update(got)
            n = len(seen)
        return Result([self.out_key], [[n]])


class FallbackOp(_Op):
    """Per-operator fallback: materialize the partial binding table into
    generic rows, apply any residual WHERE conjuncts, and hand the
    remaining clauses to the interpreter — results bit-identical because
    every columnar filter upstream was order-stable and conjunctive."""

    kind = "fallback"
    engine = "generic"

    def __init__(self, clause_idx: int, residual: Optional[ast.Expr],
                 named_node_vars: list[str], named_edge_vars: list[str],
                 named_val_vars: Optional[list[str]] = None):
        self.clause_idx = clause_idx
        self.residual = residual
        self.node_vars = named_node_vars
        self.edge_vars = named_edge_vars
        self.val_vars = list(named_val_vars or ())
        extra = " +residual WHERE" if residual is not None else ""
        self.label = f"GenericTail(clauses[{clause_idx}:]{extra})"

    def run(self, st: _State):
        from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate

        rows = st.materialize_rows(self.node_vars, self.edge_vars,
                                   self.val_vars)
        if self.residual is not None:
            rows = [
                r for r in rows
                if evaluate(self.residual,
                            EvalContext(r, st.params, st.ex)) is True
            ]
        return st.ex._finish_clauses(st.q, st.params, rows,
                                     self.clause_idx, st.stats)


# ------------------------------------------------------------ shared columns
def _value_column(st: _State, spec) -> list:
    """Evaluate one column spec over the state: entity columns, property
    gathers, WITH value columns, or parameter/literal constants."""
    kind = spec[0]
    if kind == "node":
        return st.node_objects(spec[1])
    if kind == "edge":
        return st.edge_objects(spec[1])
    if kind == "nprop" or kind == "eprop":
        return st.prop_column(spec[1], spec[2])
    if kind == "val":
        return st.val_cols[spec[1]]
    if kind == "const":
        v = spec[1](st.params)
        return [v] * st.n
    raise _Bail(f"unknown column spec {kind}")  # pragma: no cover


def _fold_agg(agg: str, rows: list[int], col: Optional[list]):
    """One aggregate over one group — the generic ``_eval_aggregate``
    fold bit-for-bit (non-null collection order, Python left-to-right
    float sums, sum []->0 / avg|min|max []->None)."""
    if agg in ("count_star", "count_ent"):
        return len(rows)
    vals = [v for r in rows if (v := col[r]) is not None]
    if agg == "count":
        return len(vals)
    if agg == "sum":
        return sum(vals) if vals else 0
    if agg == "avg":
        return sum(vals) / len(vals) if vals else None
    if agg == "min":
        return min(vals) if vals else None
    if agg == "max":
        return max(vals) if vals else None
    return vals  # collect


def _encounter_groups(st: _State, item_specs, group_idx, vals_for):
    """Aggregation groups as row-index arrays in first-encounter order
    (the generic dict-insertion grouping).  Entity group keys use the
    int columns directly: a vocab index / edge row is exactly as
    distinct as the ``("__ent__", id)`` key ``_hashable`` produces."""
    from nornicdb_tpu_torch.cypher.executor import _hashable

    n = st.n
    if not group_idx:
        return [np.arange(n, dtype=np.int64)]
    key_cols = []
    int_only = True
    for i in group_idx:
        spec = item_specs[i][1]
        if spec[0] == "node":
            key_cols.append(("int", st.node_cols[spec[1]]))
        elif spec[0] == "edge":
            key_cols.append(("int", st.edge_cols[spec[1]]))
        else:
            key_cols.append(("obj", vals_for(i)))
            int_only = False
    if n == 0:
        return []
    if len(key_cols) == 1 and int_only:
        col = key_cols[0][1]
        uniq, first, inv = np.unique(
            col, return_index=True, return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.cumsum(np.bincount(inv))
        segs = np.split(order, bounds[:-1])
        enc = np.argsort(first, kind="stable")  # first-encounter
        return [segs[g] for g in enc.tolist()]
    by_key: dict[Any, list] = {}
    mats = [c[1] if c[0] == "obj" else c[1].tolist() for c in key_cols]
    for r in range(n):
        k = _hashable([m[r] for m in mats])
        by_key.setdefault(k, []).append(r)
    return [np.asarray(rows, np.int64) for rows in by_key.values()]


def _static_limit(st: _State, clause) -> Optional[int]:
    """skip+limit when both are statically evaluable non-negative ints
    (the top-k window size), else None."""
    from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate

    if clause.limit is None:
        return None
    try:
        k = int(evaluate(clause.limit, EvalContext({}, st.params, st.ex)))
        if clause.skip is not None:
            k += int(evaluate(clause.skip,
                              EvalContext({}, st.params, st.ex)))
    except (TypeError, ValueError):
        # non-static/non-integer LIMIT: the slice tail will raise the
        # user-facing error; the offload simply doesn't engage
        return None
    return k if k >= 0 else None


# ------------------------------------------------------------- VectorTopK
_VEC_FN = "vector.similarity.cosine"


def _vector_min_rows() -> int:
    try:
        return int(os.environ.get("NORNICDB_VECTOR_TOPK_MIN_ROWS", "8192"))
    except ValueError:
        return 8192


def _vector_cutover() -> float:
    """k/n selectivity above which the full host sort beats masked-GEMM
    candidate selection (docs/operations.md "Graph×vector fusion")."""
    try:
        return float(os.environ.get("NORNICDB_VECTOR_TOPK_CUTOVER", "0.25"))
    except ValueError:
        return 0.25


def _vec_order_spec(expr, node_vars: set):
    """('vec', var, key, getter, swap) for ``ORDER BY
    vector.similarity.cosine(n.emb, $q)`` (either argument order) over a
    pattern node property vs a parameter/literal — else None.  ``swap``
    records the original argument order so the exact rescore reproduces
    the interpreter's evaluation (including its errors) verbatim."""
    if not (isinstance(expr, ast.FunctionCall) and expr.name == _VEC_FN
            and not expr.distinct and len(expr.args) == 2):
        return None
    for swap in (False, True):
        prop = expr.args[1] if swap else expr.args[0]
        other = expr.args[0] if swap else expr.args[1]
        if (isinstance(prop, ast.Property)
                and isinstance(prop.subject, ast.Variable)
                and prop.subject.name in node_vars
                and prop.key != "id"):
            getter = _const_getter(other)
            if getter is not None:
                return ("vec", prop.subject.name, prop.key, getter, swap)
    return None


class _EmbMatrix:
    """Label-wide normalized embedding matrix for VectorTopK, cached on
    the engine and validated against the colindex epoch.  ``lookup`` maps
    snapshot vocab index -> matrix row (-1 = not a clean member);
    ``null`` marks rows the GEMM must not score (missing / malformed /
    wrong-dim values — they rejoin the candidate set unconditionally so
    the exact rescore reproduces interpreter nulls and errors).  ``dev``
    is the one-slot device-corpus cache ``graph_masked_scores`` fills."""

    __slots__ = ("epoch", "lookup", "matrix", "null", "dev")

    def __init__(self, epoch, lookup, matrix, null):
        self.epoch = epoch
        self.lookup = lookup
        self.matrix = matrix
        self.null = null
        self.dev = [None]


def _emb_matrix(st: _State, var: str, key: str) -> Optional[_EmbMatrix]:
    label = st.var_label.get(var)
    if label is None:
        return None
    colind = _colindex_for(st.ex, label)
    if colind is None:
        return None
    eng = getattr(st.ex, "columnar", None)
    if eng is None:
        return None
    ck = (label, key)
    ep = colind.epoch()
    with eng._emb_lock:
        ent = eng._emb.get(ck)
        if ent is not None and ent.epoch == ep:
            return ent
    snap = colind.embedding_snapshot(label, key)
    if snap is None:
        return None
    ep0, ids, vals = snap
    if not ids:
        return None
    # float conversion + row normalization OUTSIDE the colindex lock
    null: Optional[np.ndarray] = None
    try:
        mat = np.asarray(vals, np.float32)
        if mat.ndim != 2 or not mat.shape[1]:
            raise ValueError("not a clean matrix")
        null = ~np.isfinite(mat).all(axis=1)
    except (ValueError, TypeError):
        # ragged / missing / non-numeric rows: per-row salvage — bad rows
        # are null (never scored, always candidates)
        dim = None
        rows_f: list[Optional[np.ndarray]] = []
        for v in vals:
            a = None
            if v is not None:
                try:
                    cand = np.asarray(v, np.float32)
                    if cand.ndim == 1 and len(cand) \
                            and np.isfinite(cand).all() \
                            and (dim is None or len(cand) == dim):
                        a = cand
                        dim = len(cand) if dim is None else dim
                except (ValueError, TypeError):
                    a = None
            rows_f.append(a)
        if dim is None:
            return None
        mat = np.zeros((len(vals), dim), np.float32)
        null = np.ones(len(vals), bool)
        for i, a in enumerate(rows_f):
            if a is not None:
                mat[i] = a
                null[i] = False
    mat = np.ascontiguousarray(mat)
    norms = np.linalg.norm(mat, axis=1)
    nz = norms >= 1e-12
    mat[nz] /= norms[nz, None]
    mat[~nz & ~null] = 0.0  # zero-norm rows score 0.0, like the fn
    vidx = st.snap.indices_of(ids)
    lookup = np.full(len(st.view.ids), -1, np.int64)
    ok = vidx >= 0
    lookup[vidx[ok]] = np.nonzero(ok)[0]
    if colind.epoch() != ep0:
        return None  # raced a write: a stale matrix must never drive a cut
    ent = _EmbMatrix(ep0, lookup, mat, null)
    with eng._emb_lock:
        eng._emb[ck] = ent
        while len(eng._emb) > 8:
            eng._emb.pop(next(iter(eng._emb)))
    return ent


def _prop_values_at(st: _State, var: str, key: str,
                    poss: list[int]) -> list:
    """Raw property values for a SUBSET of table rows — the survivor
    rescore after a top-k cut fetches k+ties values, not the corpus."""
    label = st.var_label.get(var)
    if label is not None and (var, st.version) not in st._objs:
        colind = _colindex_for(st.ex, label)
        if colind is not None:
            ids_list = st.view.ids
            idxs = st.node_cols[var][np.asarray(poss, np.int64)]
            vals = colind.column_values(
                label, key, [ids_list[i] for i in idxs.tolist()])
            if vals is not None:
                return vals
    col = st.prop_column(var, key)
    return [col[i] for i in poss]


def _vector_rank(st: _State, vspec, positions, desc: bool,
                 k: Optional[int]):
    """Sort keys for an ``ORDER BY cosine(...)`` row set.

    Returns ``(sel, keys)``: ``sel`` is an order-preserving subset of
    positions-in-``positions`` guaranteed to contain the whole skip+limit
    window under generic ordering semantics (nulls included — ASC nulls
    last, DESC nulls first), and ``keys`` are the EXACT per-row function
    values for those rows, so the host stable sort over the survivors
    bit-matches the interpreter, tie order included.  With no engageable
    top-k cut, ``sel`` covers every row and this degrades to host exact
    scoring.  Scoring errors raise ``_Bail`` so the generic engine
    reproduces the user-facing exception."""
    _, var, key, getter, swap = vspec
    from nornicdb_tpu_torch.cypher.functions import fn_vec_cosine as _fn

    pos_list = list(positions)
    q = getter(st.params)
    m = len(pos_list)
    col = None  # full raw column: only the degrade paths ever fetch it

    def exact(sel=None):
        nonlocal col
        if sel is None:
            if col is None:
                col = st.prop_column(var, key)
            vals = [col[i] for i in pos_list]
        elif col is not None:
            vals = [col[pos_list[i]] for i in sel]
        else:
            # cut engaged: rescore survivors only, never the full column
            vals = _prop_values_at(st, var, key,
                                   [pos_list[i] for i in sel])
        try:
            if swap:
                return [_fn(q, v) for v in vals]
            return [_fn(v, q) for v in vals]
        except Exception as e:
            raise _Bail(f"vector scoring error: {e!r}")

    full = list(range(m))
    if (k is None or k <= 0 or k >= m or q is None
            or m < _vector_min_rows() or k > m * _vector_cutover()):
        return full, exact()
    try:
        qa = np.asarray(q, np.float32)
    except (ValueError, TypeError):
        return full, exact()
    if qa.ndim != 1 or not len(qa) or not np.isfinite(qa).all():
        return full, exact()
    qnorm = float(np.linalg.norm(qa))
    if qnorm < 1e-12:
        return full, exact()
    qn = (qa / np.float32(qnorm)).astype(np.float32)
    ent = _emb_matrix(st, var, key)
    if ent is None or ent.matrix.shape[1] != len(qn):
        return full, exact()
    rows = st.node_cols[var][np.asarray(pos_list, np.int64)]
    if int(rows.max()) >= len(ent.lookup):
        return full, exact()  # nodes newer than the cached vocab window
    mrows = ent.lookup[rows]
    if (mrows < 0).any():
        return full, exact()
    isnull = ent.null[mrows]
    valid = np.zeros(len(ent.matrix), bool)
    valid[mrows[~isnull]] = True
    n_valid = int(valid.sum())
    if n_valid < k:
        return full, exact()
    from nornicdb_tpu_torch.search.service import graph_masked_scores

    # device errors and DeviceUnavailable (a card that is not serving)
    # propagate: this never scores on the host instead
    scores, boundary = graph_masked_scores(
        qn, ent.matrix, valid, k, desc, dev_ref=ent.dev,
        device=st.ex.device, backend=st.ex.backend)
    OFFLOAD_CELLS["used"].inc()
    # the boundary is over DISTINCT nodes; duplicates only push the true
    # row-wise kth value further inside it, so the widened cut is always
    # a superset of the interpreter's first skip+limit rows
    dim = ent.matrix.shape[1]
    eps = dim * 3.0e-7 + 1.0e-6
    row_scores = scores[mrows]
    if desc:
        cand = row_scores >= boundary - 2.0 * eps
    else:
        cand = row_scores <= boundary + 2.0 * eps
    cand |= isnull  # nulls sort first (DESC) / pad short windows (ASC)
    sel = np.nonzero(cand)[0]
    if len(sel) < min(k, m):
        return full, exact()  # the cut cannot prove window coverage
    sel_list = sel.tolist()
    return sel_list, exact(sel_list)


# ---------------------------------------------------------------- RETURN op
class ReturnOp(_Op):
    """Terminal projection: aggregate or plain projection, then the
    DISTINCT / ORDER BY / SKIP / LIMIT tail with generic-identical
    semantics (shared ``_multisort`` / ``_hashable``)."""

    kind = "project"
    self_timed = True

    def __init__(self, clause: ast.ReturnClause, item_specs, group_idx,
                 agg_idx, order_specs, sublabels):
        self.clause = clause
        self.item_specs = item_specs
        self.group_idx = group_idx
        self.agg_idx = agg_idx
        self.order_specs = order_specs  # None => fully generic-eval path
        self.has_agg = bool(agg_idx)
        self.has_vec = bool(order_specs) and \
            any(s[0] == "vec" for s in order_specs)
        self.label = sublabels[0]
        self.sublabels = sublabels

    # -- column evaluation -------------------------------------------------
    def _value_column(self, st: _State, spec) -> list:
        return _value_column(st, spec)

    def run(self, st: _State):
        from nornicdb_tpu_torch.cypher.executor import Result

        clause = self.clause
        if (not self.has_agg and not clause.distinct and clause.order_by
                and self.order_specs is not None
                and all(s[0] != "col" for s in self.order_specs)):
            # deferred projection: every ORDER BY key reads source
            # columns, so order + slice the binding table FIRST and only
            # ever materialize output values for the served window
            t1 = time.perf_counter()
            perm = self._order_rows(st)
            OP_CELLS["vector_topk" if self.has_vec else "sort"].observe(
                time.perf_counter() - t1)
            perm = self._slice(st, perm)
            st.apply_sel(np.asarray(perm, np.int64))
            t0 = time.perf_counter()
            columns, data, _ = self._project(st)
            OP_CELLS["project"].observe(time.perf_counter() - t0)
            return Result(columns, data)
        t0 = time.perf_counter()
        if self.has_agg:
            columns, data = self._aggregate(st)
            src_for_order = None
            OP_CELLS["aggregate"].observe(time.perf_counter() - t0)
        else:
            columns, data, row_idx = self._project(st)
            src_for_order = row_idx
            OP_CELLS["project"].observe(time.perf_counter() - t0)
        clause = self.clause
        if clause.distinct:
            from nornicdb_tpu_torch.cypher.executor import _hashable

            seen = set()
            uniq_rows, uniq_src = [], []
            for pos, r in enumerate(data):
                k = _hashable(r)
                if k not in seen:
                    seen.add(k)
                    uniq_rows.append(r)
                    if src_for_order is not None:
                        uniq_src.append(src_for_order[pos])
            data = uniq_rows
            if src_for_order is not None:
                src_for_order = uniq_src
        if clause.order_by:
            t1 = time.perf_counter()
            data = self._order(st, columns, data, src_for_order)
            OP_CELLS["vector_topk" if self.has_vec else "sort"].observe(
                time.perf_counter() - t1)
        data = self._slice(st, data)
        return Result(columns, data)

    def _project(self, st: _State):
        columns = [it.key for it in self.clause.items]
        cols = [self._value_column(st, spec) for _, spec in self.item_specs]
        data = [list(vals) for vals in zip(*cols)] if cols and st.n else []
        return columns, data, list(range(len(data)))

    # -- aggregation -------------------------------------------------------
    def _aggregate(self, st: _State):
        items = self.clause.items
        columns = [it.key for it in items]
        val_cache: dict[int, list] = {}

        def vals_for(i):
            if i not in val_cache:
                val_cache[i] = self._value_column(st, self.item_specs[i][1])
            return val_cache[i]

        groups = _encounter_groups(st, self.item_specs, self.group_idx,
                                   vals_for)
        if not groups and not self.group_idx:
            groups = [np.zeros(0, np.int64)]  # RETURN count(*) on empty
        out = []
        for g in groups:
            rows = g.tolist()
            row_vals: list[Any] = [None] * len(items)
            for i in self.group_idx:
                row_vals[i] = vals_for(i)[rows[0]] if rows else None
            for i in self.agg_idx:
                agg, spec = self.item_specs[i]
                col = None if agg in ("count_star", "count_ent") \
                    else vals_for(i)
                row_vals[i] = _fold_agg(agg, rows, col)
            out.append(row_vals)
        return columns, out

    # -- ordering ----------------------------------------------------------
    def _order_rows(self, st: _State) -> list[int]:
        """Stable row permutation (incl. any top-k cut) over the source
        binding table — the deferred-projection path's sort."""
        from nornicdb_tpu_torch.cypher.executor import _multisort

        descs = [oi.descending for oi in self.clause.order_by]
        if self.has_vec:
            sel, keys = _vector_rank(st, self.order_specs[0],
                                     range(st.n), descs[0],
                                     _static_limit(st, self.clause))
            keyed = [([keys[j]], i) for j, i in enumerate(sel)]
            return _multisort(keyed, descs)
        key_cols = [self._value_column(st, spec)
                    for spec in self.order_specs]
        positions = range(st.n)
        if len(descs) == 1:
            cut = self._offload_candidates(st, key_cols[0], descs[0])
            if cut is not None:
                positions = cut
        keyed = [([kc[i] for kc in key_cols], i) for i in positions]
        return _multisort(keyed, descs)

    def _order(self, st: _State, columns, data, src_for_order):
        from nornicdb_tpu_torch.cypher.executor import _multisort
        from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate

        order_by = self.clause.order_by
        descs = [oi.descending for oi in order_by]
        if self.has_agg or self.order_specs is None:
            # aggregated outputs: generic evaluation over the (few) group
            # rows, exactly the interpreter's column-overlay binding
            keyed = []
            for row_vals in data:
                binding = dict(zip(columns, row_vals))
                keys = []
                for oi in order_by:
                    if isinstance(oi.expr, ast.Variable) \
                            and oi.expr.name in binding:
                        keys.append(binding[oi.expr.name])
                    else:
                        keys.append(evaluate(
                            oi.expr, EvalContext(binding, st.params, st.ex)))
                keyed.append((keys, row_vals))
            return _multisort(keyed, descs)
        if self.has_vec:
            # VectorTopK: device/host masked scoring picks an order-
            # preserving candidate superset of the skip+limit window,
            # exact fn values key the final stable host sort
            sel, keys = _vector_rank(st, self.order_specs[0],
                                     src_for_order, descs[0],
                                     _static_limit(st, self.clause))
            keyed = [([keys[j]], data[i]) for j, i in enumerate(sel)]
            return _multisort(keyed, descs)
        key_cols = []
        for spec in self.order_specs:
            if spec[0] == "col":
                key_cols.append([row[spec[1]] for row in data])
            else:
                col = self._value_column(st, spec)
                key_cols.append([col[i] for i in src_for_order])
        if len(order_by) == 1:
            cut = self._offload_candidates(st, key_cols[0], descs[0])
            if cut is not None:
                data = [data[i] for i in cut]
                key_cols = [[key_cols[0][i] for i in cut]]
        keyed = [([kc[i] for kc in key_cols], row)
                 for i, row in enumerate(data)]
        return _multisort(keyed, descs)

    def _slice(self, st: _State, data):
        from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate

        clause = self.clause
        if clause.skip is not None:
            n = evaluate(clause.skip, EvalContext({}, st.params, st.ex))
            data = data[int(n):]
        if clause.limit is not None:
            n = evaluate(clause.limit, EvalContext({}, st.params, st.ex))
            data = data[: int(n)]
        return data

    # -- device offload ----------------------------------------------------
    def _offload_candidates(self, st: _State, keys: list,
                            desc: bool) -> Optional[list[int]]:
        """Device top-k boundary for a single-numeric-key ORDER BY ...
        LIMIT: returns the (order-preserving) candidate row positions
        whose keys reach the boundary incl. ties, or None for the host
        path.  The caller still runs the exact stable host sort over the
        survivors, so served rows are bit-identical to the full sort."""
        n = len(keys)
        k = _static_limit(st, self.clause)
        if k is None or n < _offload_min_rows() or k * 4 > n or k == 0:
            return None
        for v in keys:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
        from nornicdb_tpu_torch import backend

        dev = st.ex.device
        # the device owner's gate: a card that is not serving raises
        backend.gate(dev, st.ex.backend)
        vals = np.asarray(keys, np.float64)
        if np.isnan(vals).any():
            OFFLOAD_CELLS["unavailable"].inc()
            return None
        import torch

        from nornicdb_tpu_torch.telemetry import deviceprof as _deviceprof

        t0 = time.perf_counter()
        v = torch.from_numpy(
            np.asarray(vals if desc else -vals, np.float32)).to(dev)
        top = torch.topk(v, min(k, n), sorted=True).values
        boundary = float(top[-1])
        # unified device-program ledger (fleet telemetry plane)
        _deviceprof.record_execute(
            "cypher", "topk_offload", _deviceprof.pow2_class(n, "n"),
            time.perf_counter() - t0)
        # f32 rounding must only ever WIDEN the candidate set
        boundary = np.nextafter(boundary, -np.inf)
        cand = vals >= boundary if desc else -vals >= boundary
        if int(cand.sum()) < min(k, n):
            # a candidate count below k cannot prove the boundary sits at
            # or under the true kth key — host path, never a wrong
            # (under-inclusive) cut
            OFFLOAD_CELLS["unavailable"].inc()
            return None
        OFFLOAD_CELLS["used"].inc()
        return np.nonzero(cand)[0].tolist()


class WithOp(_Op):
    """Columnar WITH: project/aggregate into a REPLACEMENT binding table
    (entity items stay int columns, property projections / aggregates /
    constants become value columns — no Node dicts cross the clause
    boundary), then DISTINCT / ORDER BY / SKIP / LIMIT / WHERE with the
    generic ``_with`` ordering exactly: WHERE runs LAST, after the
    slice, over output-column-only bindings."""

    kind = "project"
    self_timed = True

    def __init__(self, clause: ast.WithClause, item_specs, group_idx,
                 agg_idx, order_specs, sublabels):
        self.clause = clause
        self.item_specs = item_specs
        self.group_idx = group_idx
        self.agg_idx = agg_idx
        self.order_specs = order_specs
        self.has_agg = bool(agg_idx)
        self.has_vec = bool(order_specs) and \
            any(s[0] == "vec" for s in order_specs)
        self.label = sublabels[0]
        self.sublabels = sublabels

    def run(self, st: _State):
        t0 = time.perf_counter()
        if self.has_agg:
            self._aggregate_into(st)
            OP_CELLS["aggregate"].observe(time.perf_counter() - t0)
        else:
            self._project_into(st)
            OP_CELLS["project"].observe(time.perf_counter() - t0)
        clause = self.clause
        if clause.distinct:
            self._distinct(st)
        if clause.order_by:
            t1 = time.perf_counter()
            self._order(st)
            OP_CELLS["vector_topk" if self.has_vec else "sort"].observe(
                time.perf_counter() - t1)
        self._slice(st)
        if clause.where is not None:
            self._where(st)
        return None

    # -- projection / aggregation into the replacement table ---------------
    def _project_into(self, st: _State):
        node_cols: dict[str, np.ndarray] = {}
        edge_cols: dict[str, np.ndarray] = {}
        val_cols: dict[str, list] = {}
        var_label: dict[str, str] = {}
        for it, (agg, spec) in zip(self.clause.items, self.item_specs):
            alias = it.key
            if spec[0] == "node":
                node_cols[alias] = st.node_cols[spec[1]]
                lbl = st.var_label.get(spec[1])
                if lbl is not None:
                    var_label[alias] = lbl
            elif spec[0] == "edge":
                edge_cols[alias] = st.edge_cols[spec[1]]
            else:
                val_cols[alias] = _value_column(st, spec)
        st.replace_table(node_cols, edge_cols, val_cols, var_label, st.n)

    def _aggregate_into(self, st: _State):
        items = self.clause.items
        val_cache: dict[int, list] = {}

        def vals_for(i):
            if i not in val_cache:
                val_cache[i] = _value_column(st, self.item_specs[i][1])
            return val_cache[i]

        groups = _encounter_groups(st, self.item_specs, self.group_idx,
                                   vals_for)
        if not groups and not self.group_idx:
            groups = [np.zeros(0, np.int64)]  # count(*) over empty input
        rows_l = [g.tolist() for g in groups]
        node_cols: dict[str, np.ndarray] = {}
        edge_cols: dict[str, np.ndarray] = {}
        val_cols: dict[str, list] = {}
        var_label: dict[str, str] = {}
        first = np.asarray([r[0] for r in rows_l], np.int64) \
            if self.group_idx else None
        for i in self.group_idx:
            alias = items[i].key
            spec = self.item_specs[i][1]
            if spec[0] == "node":
                node_cols[alias] = st.node_cols[spec[1]][first]
                lbl = st.var_label.get(spec[1])
                if lbl is not None:
                    var_label[alias] = lbl
            elif spec[0] == "edge":
                edge_cols[alias] = st.edge_cols[spec[1]][first]
            else:
                col = vals_for(i)
                val_cols[alias] = [col[r[0]] for r in rows_l]
        for i in self.agg_idx:
            agg, spec = self.item_specs[i]
            col = None if agg in ("count_star", "count_ent") \
                else vals_for(i)
            val_cols[items[i].key] = [_fold_agg(agg, r, col)
                                      for r in rows_l]
        st.replace_table(node_cols, edge_cols, val_cols, var_label,
                         len(rows_l))

    # -- tail --------------------------------------------------------------
    def _distinct(self, st: _State):
        from nornicdb_tpu_torch.cypher.executor import _hashable

        cols = []
        for it in self.clause.items:
            alias = it.key
            if alias in st.node_cols:
                cols.append(("i", st.node_cols[alias]))
            elif alias in st.edge_cols:
                cols.append(("i", st.edge_cols[alias]))
            else:
                cols.append(("o", st.val_cols[alias]))
        seen = set()
        keep = []
        for r in range(st.n):
            kk = tuple(int(c[r]) if t == "i" else _hashable([c[r]])
                       for t, c in cols)
            if kk not in seen:
                seen.add(kk)
                keep.append(r)
        if len(keep) != st.n:
            st.apply_sel(np.asarray(keep, np.int64))

    def _order(self, st: _State):
        from nornicdb_tpu_torch.cypher.executor import _multisort

        descs = [oi.descending for oi in self.clause.order_by]
        if self.has_vec:
            sel, keys = _vector_rank(st, self.order_specs[0],
                                     range(st.n), descs[0],
                                     _static_limit(st, self.clause))
            keyed = [([keys[j]], i) for j, i in enumerate(sel)]
            perm = _multisort(keyed, descs)
            st.apply_sel(np.asarray(perm, np.int64))
            return
        key_cols = [_value_column(st, spec) for spec in self.order_specs]
        keyed = [([kc[i] for kc in key_cols], i) for i in range(st.n)]
        perm = _multisort(keyed, descs)
        st.apply_sel(np.asarray(perm, np.int64))

    def _slice(self, st: _State):
        from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate

        clause = self.clause
        if clause.skip is None and clause.limit is None:
            return
        idx = list(range(st.n))  # Python slice semantics, verbatim
        if clause.skip is not None:
            n = evaluate(clause.skip, EvalContext({}, st.params, st.ex))
            idx = idx[int(n):]
        if clause.limit is not None:
            n = evaluate(clause.limit, EvalContext({}, st.params, st.ex))
            idx = idx[: int(n)]
        if len(idx) != st.n:
            st.apply_sel(np.asarray(idx, np.int64))

    def _where(self, st: _State):
        from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate

        rows = st.materialize_rows(list(st.node_cols), list(st.edge_cols),
                                   list(st.val_cols))
        w = self.clause.where
        mask = np.array(
            [evaluate(w, EvalContext(r, st.params, st.ex)) is True
             for r in rows], dtype=bool)
        if not mask.all():
            st.apply_mask(mask)


def _offload_min_rows() -> int:
    try:
        return int(os.environ.get("NORNICDB_CYPHER_OFFLOAD_MIN_ROWS",
                                  "100000"))
    except ValueError:
        return 100000


# ---------------------------------------------------------------- plan
class CompiledPlan:
    __slots__ = ("ops", "q", "full", "key")

    def __init__(self, ops: list, q: ast.Query, full: bool, key: str):
        self.ops = ops
        self.q = q
        self.full = full
        self.key = key

    def describe(self) -> list[str]:
        lines = []
        for op in self.ops:
            if isinstance(op, (ReturnOp, WithOp)):
                lines.extend(f"{lbl} [columnar]" for lbl in op.sublabels)
            else:
                lines.append(f"{op.label} [{op.engine}]")
        return lines


# ---------------------------------------------------------------- planner
def _classify_item(expr, node_vars: set, edge_vars: set,
                   val_vars: frozenset = frozenset()):
    """(agg_kind|None, spec) — spec is a column spec; None = unsupported."""
    if isinstance(expr, ast.Variable):
        if expr.name in node_vars:
            return None, ("node", expr.name)
        if expr.name in edge_vars:
            return None, ("edge", expr.name)
        if expr.name in val_vars:
            return None, ("val", expr.name)
        return None, None
    if isinstance(expr, ast.Property) and isinstance(expr.subject,
                                                     ast.Variable):
        v = expr.subject.name
        if expr.key == "id":
            return None, None  # evaluator falls back to entity id: generic
        if v in node_vars:
            return None, ("nprop", v, expr.key)
        if v in edge_vars:
            return None, ("eprop", v, expr.key)
        return None, None
    getter = _const_getter(expr)
    if getter is not None:
        return None, ("const", getter)
    return None, None


def _classify_agg(expr, node_vars: set, edge_vars: set,
                  val_vars: frozenset = frozenset()):
    if not (isinstance(expr, ast.FunctionCall) and expr.name in _AGG_FNS
            and not expr.distinct and len(expr.args) == 1):
        return None, None
    arg = expr.args[0]
    if expr.name == "count":
        if isinstance(arg, ast.Literal) and arg.value == "*":
            return "count_star", ("const", lambda p: None)
        if isinstance(arg, ast.Variable):
            if arg.name in node_vars or arg.name in edge_vars:
                return "count_ent", ("const", lambda p: None)
            if arg.name in val_vars:
                return "count", ("val", arg.name)
        if (isinstance(arg, ast.Property)
                and isinstance(arg.subject, ast.Variable)
                and arg.key != "id"):
            v = arg.subject.name
            if v in node_vars:
                return "count", ("nprop", v, arg.key)
            if v in edge_vars:
                return "count", ("eprop", v, arg.key)
        return None, None
    # sum/avg/min/max/collect over a node OR edge property column (edge
    # properties are CSR-resident: storage/adjacency.py edge_prop_column)
    # or over a WITH-projected value column
    if (isinstance(arg, ast.Property)
            and isinstance(arg.subject, ast.Variable)
            and arg.key != "id"):
        v = arg.subject.name
        if v in node_vars:
            return expr.name, ("nprop", v, arg.key)
        if v in edge_vars:
            return expr.name, ("eprop", v, arg.key)
    if isinstance(arg, ast.Variable) and arg.name in val_vars:
        return expr.name, ("val", arg.name)
    return None, None


def _plan_return(clause: ast.ReturnClause, node_vars: set, edge_vars: set,
                 val_vars: frozenset = frozenset()):
    """ReturnOp for a supported RETURN, else a FallbackOp reason string."""
    from nornicdb_tpu_torch.cypher.executor import _contains_aggregate

    if clause.star:
        return None, "RETURN *"
    item_specs = []
    group_idx, agg_idx = [], []
    for i, it in enumerate(clause.items):
        if _contains_aggregate(it.expr):
            agg, spec = _classify_agg(it.expr, node_vars, edge_vars,
                                      val_vars)
            if agg is None:
                return None, f"aggregate `{it.key}`"
            item_specs.append((agg, spec))
            agg_idx.append(i)
        else:
            _, spec = _classify_item(it.expr, node_vars, edge_vars,
                                     val_vars)
            if spec is None:
                return None, f"projection `{it.key}`"
            item_specs.append((None, spec))
            group_idx.append(i)
    has_agg = bool(agg_idx)
    columns = [it.key for it in clause.items]
    order_specs: Optional[list] = []
    if clause.order_by and not has_agg:
        for oi in clause.order_by:
            if isinstance(oi.expr, ast.Variable):
                if oi.expr.name in columns:
                    # LAST duplicate wins: the generic binding overlays
                    # columns via dict(zip(...)), so a repeated alias
                    # resolves to its final occurrence
                    idx = len(columns) - 1 - columns[::-1].index(oi.expr.name)
                    order_specs.append(("col", idx))
                    continue
                if oi.expr.name in val_vars:
                    order_specs.append(("val", oi.expr.name))
                    continue
                return None, "ORDER BY entity variable"
            if (isinstance(oi.expr, ast.Property)
                    and isinstance(oi.expr.subject, ast.Variable)):
                v = oi.expr.subject.name
                if v in columns:
                    return None, "ORDER BY property of alias"
                if v in val_vars:
                    return None, "ORDER BY property of value alias"
                if oi.expr.key != "id" and (v in node_vars
                                            or v in edge_vars):
                    order_specs.append(
                        ("nprop" if v in node_vars else "eprop",
                         v, oi.expr.key))
                    continue
            if len(clause.order_by) == 1:
                vspec = _vec_order_spec(oi.expr, node_vars)
                if vspec is not None:
                    v = vspec[1]
                    if v in columns:
                        # generic ORDER BY binding overlays output columns
                        # over the source row (output wins) — the vec var
                        # only survives the overlay when its last aliased
                        # item is the variable itself
                        idx = len(columns) - 1 - columns[::-1].index(v)
                        shadow = clause.items[idx].expr
                        if not (isinstance(shadow, ast.Variable)
                                and shadow.name == v):
                            return None, "ORDER BY property of alias"
                    order_specs.append(vspec)
                    continue
            getter = _const_getter(oi.expr)
            if getter is not None:
                order_specs.append(("const", getter))
                continue
            return None, "ORDER BY expression"
    sublabels = []
    if has_agg:
        aggs = ", ".join(clause.items[i].key for i in agg_idx)
        sublabels.append(f"Aggregate({aggs})")
    else:
        sublabels.append("Project(" + ", ".join(columns) + ")")
    if clause.distinct:
        sublabels.append("Distinct")
    if clause.order_by:
        if order_specs and any(s[0] == "vec" for s in order_specs):
            oi = clause.order_by[0]
            sublabels.append("VectorTopK(" + ast.expr_text(oi.expr)
                             + (" DESC" if oi.descending else "") + ")")
        else:
            sublabels.append("Sort(" + ", ".join(
                ("DESC " if oi.descending else "") +
                ast.expr_text(oi.expr) for oi in clause.order_by) + ")")
    if clause.skip is not None or clause.limit is not None:
        sublabels.append("Slice(skip/limit)")
    return ReturnOp(clause, item_specs, group_idx, agg_idx,
                    order_specs if not has_agg else None, sublabels), ""


def _retired_fastpaths(q: ast.Query, cls) -> Optional[CompiledPlan]:
    """The count short-circuit shapes (NodeCountOp/EdgeCountOp) as planner
    special cases — the executor-level ``_try_fastpath`` these replace is
    deleted, not shadowed."""
    if len(cls) != 2 or not isinstance(cls[1], ast.ReturnClause):
        return None
    m, ret = cls
    if m.optional or len(m.patterns) != 1:
        return None
    pat = m.patterns[0]
    if pat.name or pat.shortest:
        return None
    els = pat.elements
    if len(els) % 2 == 0 or not els:
        return None
    if not all(isinstance(n, ast.NodePattern) for n in els[0::2]) or \
            not all(isinstance(r, ast.RelPattern) for r in els[1::2]):
        return None
    plain_ret = (not ret.distinct and not ret.order_by and ret.skip is None
                 and ret.limit is None and not ret.star
                 and len(ret.items) == 1)
    anchor = els[0]
    if not plain_ret or m.where is not None or anchor.where is not None:
        return None
    e = ret.items[0].expr
    if not (isinstance(e, ast.FunctionCall) and e.name == "count"
            and not e.distinct and len(e.args) == 1):
        return None
    arg = e.args[0]
    if len(els) == 1 and anchor.properties is None:
        counts_node = (isinstance(arg, ast.Literal) and arg.value == "*") \
            or (isinstance(arg, ast.Variable)
                and arg.name == anchor.variable)
        if counts_node:
            op = NodeCountOp(anchor.labels, ret.items[0].key)
            return CompiledPlan([op], q, True, "")
    if len(els) == 3:
        a, rel, b = els
        if rel.var_length or rel.min_hops != 1 or rel.max_hops != 1 \
                or rel.properties is not None:
            return None
        bare = not (a.labels or a.properties or a.where or b.labels
                    or b.properties or b.where)
        if not bare:
            return None
        counts_rel = (isinstance(arg, ast.Literal) and arg.value == "*") \
            or (isinstance(arg, ast.Variable)
                and (arg.name == rel.variable or arg.name == a.variable
                     or arg.name == b.variable))
        if counts_rel \
                and not (a.variable and a.variable == b.variable) \
                and not (rel.variable
                         and rel.variable in (a.variable, b.variable)):
            op = EdgeCountOp(rel.types, rel.direction, ret.items[0].key)
            return CompiledPlan([op], q, True, "")
    return None


def _plan_match_clause(m: ast.MatchClause, ci: int, ops: list,
                       node_vars: set, edge_vars: set, val_vars: set,
                       rooted: bool):
    """Plan one MATCH clause into scan/join/filter/expand ops appended to
    ``ops``.  Returns ``("ok", None)`` or ``("residual", expr)`` — ops
    committed, variable sets updated (residual WHERE conjuncts must run
    on the generic tail) — or ``("no", reason)`` with nothing committed."""
    if m.optional:
        return "no", "OPTIONAL MATCH"
    if len(m.patterns) != 1:
        return "no", "multiple patterns"
    pat = m.patterns[0]
    if pat.name or pat.shortest:
        return "no", "named path / shortestPath"
    els = pat.elements
    if len(els) % 2 == 0 or not els:
        return "no", "malformed pattern"
    nodes = els[0::2]
    rels = els[1::2]
    if not all(isinstance(n, ast.NodePattern) for n in nodes) or \
            not all(isinstance(r, ast.RelPattern) for r in rels):
        return "no", "malformed pattern"
    last = len(rels) - 1
    for i, r in enumerate(rels):
        if r.properties is not None:
            return "no", "relationship property map"
        if r.var_length or r.min_hops != 1 or r.max_hops != 1:
            if i != last:
                return "no", "variable-length hop mid-chain"
            if r.variable:
                return "no", "named variable-length relationship"
    for nd in nodes[1:]:
        if nd.properties is not None:
            return "no", "non-anchor property map"
    anchor = nodes[0]

    # -- variable naming (anonymous get clause-scoped § names) --------------
    node_names: list[str] = []
    local_first: dict[str, int] = {}
    for i, nd in enumerate(nodes):
        name = nd.variable or f"§n{ci}_{i}"
        node_names.append(name)
        local_first.setdefault(name, i)
    edge_names: list[str] = []
    for i, r in enumerate(rels):
        name = r.variable or f"§e{ci}_{i}"
        if name in edge_names or name in local_first or name in node_vars \
                or name in edge_vars or name in val_vars:
            return "no", "repeated relationship variable"
        edge_names.append(name)
    for name in node_names:
        if name in edge_vars or name in val_vars:
            return "no", "variable name collision"
    anchor_name = node_names[0]
    bound_anchor = anchor_name in node_vars
    if bound_anchor and (anchor.properties is not None
                         or anchor.where is not None):
        return "no", "bound anchor with inline predicate"
    if not bound_anchor and rooted and anchor.properties is not None:
        pvars: set = set()
        for pv in anchor.properties.items.values():
            _expr_vars(pv, pvars)
        if pvars:
            # AnchorScanOp evaluates the prop map with an EMPTY binding —
            # correct only when nothing upstream could be referenced
            return "no", "anchor property map references variables"

    # -- WHERE conjunct split ----------------------------------------------
    known_nodes = node_vars | set(node_names)
    known_edges = edge_vars | set(edge_names)
    per_var: dict[str, list] = {}
    residual_parts: list = []
    if m.where is not None:
        for part in _split_and(m.where):
            vs: set = set()
            _expr_vars(part, vs)
            if len(vs) == 1:
                v = next(iter(vs))
                if (v in known_nodes or v in known_edges) \
                        and not v.startswith("§"):
                    per_var.setdefault(v, []).append(part)
                    continue
            residual_parts.append(part)
    for nd, name in zip(nodes, node_names):
        if nd.where is not None:
            if not nd.variable:
                return "no", "inline WHERE on anonymous node"
            per_var.setdefault(name, []).append(nd.where)
    var_cw: dict[str, CompiledWhere] = {}
    for v, parts in per_var.items():
        cw = _parallel.compile_where(_join_and(parts), v)
        if cw.residual is not None:
            residual_parts.append(cw.residual)
        if cw.has_columnar:
            var_cw[v] = cw

    # -- scan / join + filter + expand pipeline ------------------------------
    temp: list[_Op] = []
    if bound_anchor:
        # re-anchoring on an already-bound id column: membership mask
        if anchor.labels:
            temp.append(JoinCheckOp(anchor_name, anchor.labels))
    else:
        anchor_cw = var_cw.pop(anchor_name, None)
        if anchor.properties is not None:
            temp.append(AnchorScanOp(anchor_name, anchor))
            if anchor_cw is not None:
                temp.append(FilterOp(anchor_name, anchor_cw,
                                     _cw_text(per_var.get(anchor_name))))
        elif anchor_cw is not None and len(anchor.labels) == 1:
            temp.append(MaskedLabelScanOp(anchor_name, anchor.labels[0],
                                          anchor_cw,
                                          _cw_text(per_var.get(anchor_name))))
        elif anchor.labels:
            temp.append(LabelScanOp(anchor_name, anchor.labels))
            if anchor_cw is not None:
                temp.append(FilterOp(anchor_name, anchor_cw,
                                     _cw_text(per_var.get(anchor_name))))
        else:
            temp.append(AllScanOp(anchor_name))
            if anchor_cw is not None:
                temp.append(FilterOp(anchor_name, anchor_cw,
                                     _cw_text(per_var.get(anchor_name))))
        if rooted:
            # a scan under a non-empty table is a cartesian join root
            temp[0].kind = "join"
    seen = set(node_vars) | {anchor_name}
    for i, rel in enumerate(rels):
        src = node_names[i]
        dst = node_names[i + 1]
        dst_join = dst in seen
        is_vl = rel.var_length or rel.min_hops != 1 or rel.max_hops != 1
        if is_vl:
            temp.append(VarLenExpandOp(src, rel, dst, dst_join,
                                       nodes[i + 1].labels,
                                       edge_names[:i]))
        else:
            temp.append(ExpandOp(src, rel, dst, dst_join,
                                 nodes[i + 1].labels, edge_names[i],
                                 edge_names[:i]))
        seen.add(dst)
        cw = var_cw.pop(dst, None)
        if cw is not None:  # join vars filtered after re-binding
            temp.append(FilterOp(dst, cw, _cw_text(per_var.get(dst))))
    for v in sorted(var_cw):  # edge vars / re-filtered earlier bindings
        temp.append(FilterOp(v, var_cw[v], _cw_text(per_var.get(v))))

    ops.extend(temp)
    node_vars.update(n for n in node_names if not n.startswith("§"))
    edge_vars.update(n for n in edge_names if not n.startswith("§"))
    if residual_parts:
        return "residual", _join_and(residual_parts)
    return "ok", None


def _plan_with(clause: ast.WithClause, node_vars: set, edge_vars: set,
               val_vars: frozenset):
    """(WithOp, "", (nodes, edges, vals)) for a supported WITH — the sets
    are the POST-projection variable namespace — else (None, reason, None)."""
    from nornicdb_tpu_torch.cypher.executor import _contains_aggregate

    if clause.star:
        return None, "WITH *", None
    aliases = [it.key for it in clause.items]
    if len(set(aliases)) != len(aliases):
        return None, "duplicate WITH alias", None
    item_specs = []
    group_idx, agg_idx = [], []
    for i, it in enumerate(clause.items):
        if _contains_aggregate(it.expr):
            agg, spec = _classify_agg(it.expr, node_vars, edge_vars,
                                      val_vars)
            if agg is None:
                return None, f"WITH aggregate `{it.key}`", None
            item_specs.append((agg, spec))
            agg_idx.append(i)
        else:
            _, spec = _classify_item(it.expr, node_vars, edge_vars,
                                     val_vars)
            if spec is None:
                return None, f"WITH projection `{it.key}`", None
            item_specs.append((None, spec))
            group_idx.append(i)
    new_nodes: set = set()
    new_edges: set = set()
    new_vals: set = set()
    for i, (agg, spec) in enumerate(item_specs):
        if agg is None and spec[0] == "node":
            new_nodes.add(aliases[i])
        elif agg is None and spec[0] == "edge":
            new_edges.add(aliases[i])
        else:
            new_vals.add(aliases[i])
    # ORDER BY resolves in the POST-projection namespace only (the generic
    # overlay favors output columns; anything needing a source-row var
    # stays generic)
    order_specs: list = []
    if clause.order_by:
        for oi in clause.order_by:
            expr = oi.expr
            spec = None
            if isinstance(expr, ast.Variable) and expr.name in new_vals:
                spec = ("val", expr.name)
            elif (isinstance(expr, ast.Property)
                    and isinstance(expr.subject, ast.Variable)
                    and expr.key != "id"):
                v = expr.subject.name
                if v in new_nodes:
                    spec = ("nprop", v, expr.key)
                elif v in new_edges:
                    spec = ("eprop", v, expr.key)
            if spec is None and len(clause.order_by) == 1:
                spec = _vec_order_spec(expr, new_nodes)
            if spec is None:
                getter = _const_getter(expr)
                if getter is not None:
                    spec = ("const", getter)
            if spec is None:
                return None, "WITH ORDER BY expression", None
            order_specs.append(spec)
    sublabels = []
    if agg_idx:
        sublabels.append("WithAggregate(" + ", ".join(
            aliases[i] for i in agg_idx) + ")")
    else:
        sublabels.append("WithProject(" + ", ".join(aliases) + ")")
    if clause.distinct:
        sublabels.append("Distinct")
    if clause.order_by:
        if any(s[0] == "vec" for s in order_specs):
            oi = clause.order_by[0]
            sublabels.append("VectorTopK(" + ast.expr_text(oi.expr)
                             + (" DESC" if oi.descending else "") + ")")
        else:
            sublabels.append("Sort(" + ", ".join(
                ("DESC " if oi.descending else "") +
                ast.expr_text(oi.expr) for oi in clause.order_by) + ")")
    if clause.skip is not None or clause.limit is not None:
        sublabels.append("Slice(skip/limit)")
    if clause.where is not None:
        sublabels.append("Filter(WHERE " + ast.expr_text(clause.where)
                         + ")")
    op = WithOp(clause, item_specs, group_idx, agg_idx, order_specs,
                sublabels)
    return op, "", (new_nodes, new_edges, new_vals)


def compile_query(q: ast.Query, ex) -> tuple[Optional[CompiledPlan], str]:
    """Pattern-compile a canonical (literal-lifted) Query into an operator
    DAG, or (None, reason) when no columnar prefix exists.  Clause
    boundaries don't stop the pipeline: MATCH chains join against the
    standing table, WITH projects/aggregates it in place, and the first
    unsupported construct plants a FallbackOp that hands the *current*
    binding table to the interpreter for the remaining clauses."""
    cls = q.clauses
    if not cls or not isinstance(cls[0], ast.MatchClause):
        return None, "no leading MATCH"
    fast = _retired_fastpaths(q, cls)
    if fast is not None:
        return fast, ""

    ops: list[_Op] = []
    node_vars: set = set()
    edge_vars: set = set()
    val_vars: set = set()

    def fallback(idx: int, residual=None) -> CompiledPlan:
        ops.append(FallbackOp(idx, residual, sorted(node_vars),
                              sorted(edge_vars), sorted(val_vars)))
        return CompiledPlan(ops, q, False, "")

    rooted = False
    ci = 0
    while ci < len(cls):
        c = cls[ci]
        if isinstance(c, ast.MatchClause):
            status, extra = _plan_match_clause(
                c, ci, ops, node_vars, edge_vars, val_vars, rooted)
            if status == "no":
                if ci == 0:
                    return None, extra
                return fallback(ci), extra
            rooted = True
            if status == "residual":
                return fallback(ci + 1, extra), "residual WHERE"
            ci += 1
            continue
        if isinstance(c, ast.ReturnClause):
            if ci != len(cls) - 1:
                return fallback(ci), "RETURN not final"
            rop, reason = _plan_return(c, node_vars, edge_vars,
                                       frozenset(val_vars))
            if rop is not None:
                ops.append(rop)
                return CompiledPlan(ops, q, True, ""), ""
            return fallback(ci), reason
        if isinstance(c, ast.WithClause):
            if ci == len(cls) - 1:
                return fallback(ci), "trailing WITH"
            wop, reason, sets = _plan_with(c, node_vars, edge_vars,
                                           frozenset(val_vars))
            if wop is None:
                return fallback(ci), reason
            ops.append(wop)
            node_vars, edge_vars, val_vars = sets
            ci += 1
            continue
        return fallback(ci), f"unsupported clause {type(c).__name__}"
    return fallback(len(cls)), "no RETURN tail"


def _cw_text(parts) -> str:
    if not parts:
        return "…"
    return " AND ".join(ast.expr_text(p) for p in parts)


# ---------------------------------------------------------------- engine
def _env_enabled() -> bool:
    return os.environ.get("NORNICDB_CYPHER_COLUMNAR", "1").lower() not in (
        "0", "false", "no", "off")


class ColumnarEngine:
    """Per-executor columnar pipeline: shape-keyed plan cache + operator
    execution + trace capture for EXPLAIN/PROFILE and the slow-query log."""

    def __init__(self, ex):
        self.ex = ex
        self.enabled = _env_enabled()
        self.cache = PlanCache(ex.schema)
        self._tls = threading.local()
        self.outcomes = {"full": 0, "fallback": 0, "bail": 0,
                         "unsupported": 0}
        # VectorTopK embedding-matrix cache: (label, key) -> _EmbMatrix,
        # epoch-validated against the colindex on every use
        self._emb: dict[tuple[str, str], _EmbMatrix] = {}
        self._emb_lock = threading.Lock()
        # label-scan memo: (snapshot, {labels: (epochs, sorted idx)}) —
        # one snapshot generation at a time, validated on every get
        self._scan_cache: Optional[tuple] = None
        self._scan_lock = threading.Lock()

    # -- shape path (from _run_single) --------------------------------------
    def try_query(self, q: ast.Query, params: dict, stats) -> Optional[Any]:
        if not self.enabled:
            return None
        norm = normalize_query(q)
        if norm is None:
            return None
        key, canon, lits = norm
        hit = True
        entry = self.cache.shape_lookup(key)
        if entry is None:
            hit = False
            plan, reason = compile_query(canon, self.ex)
            if plan is not None:
                plan.key = key
            entry = self.cache.shape_store(key, plan, reason)
        if entry.plan is None:
            self.outcomes["unsupported"] += 1
            Q_CELLS["unsupported"].inc()
            return None
        merged = merge_lits(params, lits)
        res, outcome = self._execute(entry.plan, merged, stats, q, hit)
        if res is None:
            return None
        if outcome == "full":
            self._tls.note = (weakref.ref(q), key, entry.plan, lits)
        return res

    # -- text path (from _execute_traced) ------------------------------------
    def run_text_entry(self, entry, params: dict, stats) -> Optional[Any]:
        merged = merge_lits(params, entry.lits)
        res, _ = self._execute(entry.plan, merged, stats, None, True)
        return res

    def maybe_bind_text(self, text: str, stmt) -> None:
        """Bind query text -> full-columnar plan after a successful run,
        so repeat traffic skips parse+plan entirely.  Only full plans are
        bindable: the text fast path bypasses the write-statement
        machinery, and full plans are read-only by construction."""
        note = getattr(self._tls, "note", None)
        if note is None:
            return
        qref, key, plan, lits = note
        if qref() is not stmt or not plan.full:
            return
        if stmt.unions or stmt.explain or stmt.profile:
            # a union query's full-columnar note covers only the MAIN
            # branch — binding its text would drop the union rows on the
            # fast path; EXPLAIN/PROFILE must keep their wrappers
            self._tls.note = None
            return
        self._tls.note = None
        from nornicdb_tpu_torch.cypher.executor import (
            _is_nondeterministic,
            _read_cache_labels,
        )

        canon = plan.q
        self.cache.bind_text(
            text, key, canon, lits, plan,
            cacheable=not _is_nondeterministic(canon),
            labels=frozenset(_read_cache_labels(canon)))

    # -- execution -----------------------------------------------------------
    def _execute(self, plan: CompiledPlan, params: dict, stats,
                 orig_q, cache_hit: bool):
        ex = self.ex
        snap = ex.matcher._snap()
        if snap is None:
            self._note_outcome("bail")
            return None, "bail"
        trace_ops: list[tuple] = []
        t_start = time.perf_counter()
        try:
            if not snap.ensure():
                raise _Bail("snapshot build raced out")
            view = snap.csr_view()
            if view is None:
                raise _Bail("snapshot unavailable")
            st = _State(ex, plan.q, params, stats, snap, view, trace_ops)
            result = None
            with _tracer.span("cypher.columnar"):
                for op in plan.ops:
                    t0 = time.perf_counter()
                    result = op.run(st)
                    dt = time.perf_counter() - t0
                    if not op.self_timed:
                        OP_CELLS[op.kind].observe(dt)
                    trace_ops.append((op.label, op.engine, st.n,
                                      round(dt * 1e3, 3)))
                    if result is not None:
                        break
            if result is None:  # pragma: no cover - planner guarantees
                raise _Bail("plan produced no result")
            ROWS_HIST.observe(st.peak_rows)
            outcome = "full" if plan.full else "fallback"
            self._note_outcome(outcome)
            self._tls.trace = {
                "qref": weakref.ref(orig_q) if orig_q is not None else None,
                "key": key_hash(plan.key) if plan.key else "",
                "outcome": outcome,
                "cache": "hit" if cache_hit else "miss",
                "total_ms": round((time.perf_counter() - t_start) * 1e3, 3),
                "ops": trace_ops,
            }
            return result, outcome
        except _Bail as b:
            log.debug("columnar bail: %s", b)
            self._note_outcome("bail")
            return None, "bail"

    def _note_outcome(self, outcome: str) -> None:
        self.outcomes[outcome] += 1
        Q_CELLS[outcome].inc()

    # -- introspection -------------------------------------------------------
    def begin_statement(self) -> None:
        """Drop this thread's trace so slow-query capture never attributes
        a previous statement's columnar execution to the current one."""
        self._tls.trace = None

    def last_trace(self, stmt=None) -> Optional[dict]:
        tr = getattr(self._tls, "trace", None)
        if tr is None:
            return None
        if stmt is not None:
            qref = tr.get("qref")
            if qref is None or qref() is not stmt:
                return None
        return tr

    def explain_lines(self, q: ast.Query) -> list[str]:
        if not self.enabled:
            return ["columnar: disabled"]
        norm = normalize_query(q)
        if norm is None:
            return ["columnar: generic (unnormalizable query)"]
        key, canon, _lits = norm
        entry = self.cache.shape_lookup(key)
        hit = entry is not None
        if entry is None:
            plan, reason = compile_query(canon, self.ex)
            if plan is not None:
                plan.key = key
            entry = self.cache.shape_store(key, plan, reason)
        if entry.plan is None:
            return [f"columnar: generic ({entry.reason})"]
        status = "hit" if hit else "miss"
        lines = [f"columnar plan [cache {status}, shape={key_hash(key)}]:"]
        lines.extend(f"  {line}" for line in entry.plan.describe())
        return lines

    def stats_snapshot(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "plan_cache": self.cache.stats_snapshot(),
            "outcomes": dict(self.outcomes),
        }
