"""Cypher executor: clause pipeline over binding rows (the port's copy of
``nornicdb_tpu/cypher/executor.py``).

Device policy: the executor takes ``device`` (None means CUDA and raises
DeviceUnavailable without a card; the CPU only when the caller names it)
and an optional ``backend`` (a BackendManager to gate through instead of
the process default). The columnar engine's two offloads (ORDER BY ...
LIMIT top-k and VectorTopK) run on it, and so do the graph procedures'
PageRank, weakly connected components and link-prediction GEMMs
(``cypher/gds_procedures.py``, ``apoc/functions_graph2.py``), each after
the device owner's gate. ``db.index.vector.queryNodes`` goes through the
DB's ``search.vector_candidates`` (the streaming top-k kernel at scale),
``db.index.fulltext.queryNodes`` through ``search/bm25.py``.

Behavioral reference: upstream NornicDB pkg/cypher/executor.go (Execute
:490-695), match.go, create.go, merge.go, executor_mutations.go, call.go,
call_vector.go, call_fulltext.go. The architecture differs deliberately
(SURVEY.md §7): parsed AST -> row pipeline, not keyword re-dispatch.

Explicit transactions implement ROLLBACK with an executor-level undo log
(inverse operations), mirroring the reference's transaction-aware WAL undo
(pkg/storage/wal.go:1845).
"""

from __future__ import annotations

import logging

import copy
import csv as csv_mod
import functools
import threading
import time
import uuid
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.cypher.expr import EvalContext, evaluate
from nornicdb_tpu_torch.cypher.functions import FUNCTIONS, is_aggregate
from nornicdb_tpu_torch.cypher.matcher import PatternMatcher, make_path
from nornicdb_tpu_torch.cypher.parser import parse
from nornicdb_tpu_torch.cypher.validator import strict_mode_enabled, validate
from nornicdb_tpu_torch.errors import (
    AlreadyExistsError,
    CypherSyntaxError,
    CypherTypeError,
    NornicError,
    NotFoundError,
    TransactionError,
)
from nornicdb_tpu_torch.storage.schema import SchemaManager
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node
from nornicdb_tpu_torch.telemetry import slowlog as _slowlog
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY
from nornicdb_tpu_torch.telemetry.tracing import tracer as _tracer

# stage cells resolved once at import: the per-query cost is one
# perf_counter pair + one cell observe per stage, plus a single
# contextvar read for the (usually no-op) span
_STAGE_HIST = _REGISTRY.histogram(
    "nornicdb_cypher_stage_seconds",
    "Cypher execute latency by stage",
    labels=("stage",),
)
_STAGE_PARSE = _STAGE_HIST.labels("parse")
_STAGE_PLAN = _STAGE_HIST.labels("plan")
_STAGE_MATCH = _STAGE_HIST.labels("match")
_STAGE_PROJECT = _STAGE_HIST.labels("project")
_STAGE_EXECUTE = _STAGE_HIST.labels("execute")
_slow_log = _slowlog.slow_log


@dataclass
class Stats:
    nodes_created: int = 0
    nodes_deleted: int = 0
    relationships_created: int = 0
    relationships_deleted: int = 0
    properties_set: int = 0
    labels_added: int = 0
    labels_removed: int = 0
    indexes_added: int = 0
    constraints_added: int = 0

    def as_dict(self) -> dict[str, int]:
        return {k: v for k, v in self.__dict__.items() if v}


@dataclass
class Result:
    columns: list[str]
    rows: list[list[Any]]
    stats: Stats = field(default_factory=Stats)
    plan: Optional[str] = None

    def rows_as_dicts(self) -> list[dict[str, Any]]:
        return [dict(zip(self.columns, r)) for r in self.rows]

    def single(self) -> Optional[list[Any]]:
        return self.rows[0] if self.rows else None


ProcedureFn = Callable[["CypherExecutor", list[Any], dict[str, Any]], tuple[list[str], list[list[Any]]]]
PROCEDURES: dict[str, ProcedureFn] = {}
# registration is import-time in practice, but apoc extension modules may
# load lazily from executing sessions — serialize writers
_PROCEDURES_LOCK = threading.Lock()


def procedure(name: str):
    def deco(fn):
        with _PROCEDURES_LOCK:
            PROCEDURES[name.lower()] = fn
        return fn

    return deco


_query_log = logging.getLogger("nornicdb.query")
_log = logging.getLogger(__name__)


class CypherExecutor:
    """(ref: cypher.StorageExecutor executor.go:187)"""

    def __init__(
        self,
        storage: Engine,
        schema: Optional[SchemaManager] = None,
        db=None,
        cache=None,
        log_queries: bool = False,
        device: DeviceLike = None,
        backend=None,
    ):
        # resolved first: no card, no executor (device=None means CUDA)
        self.device = resolve_device(device)
        self.backend = backend  # injected BackendManager; None: default
        self.storage = storage
        if schema is None:
            # a self-created schema must hear the engine's write events, or
            # an index created before data silently never indexes anything.
            # Lazy: the subscription (and any node scan) only happens at
            # the first index/constraint DDL, so per-request executors over
            # a shared engine cost nothing (the DB facade attaches its own
            # schema eagerly; a passed-in one is the caller's to wire).
            schema = SchemaManager()
            schema.attach_lazy(storage)
        self.schema = schema
        self.db = db  # DB facade: embedder, search service, multidb hooks
        self.cache = cache  # QueryCache (ref: pkg/cache wiring main.go:320)
        # per-executor (NOT process-global: two DBs in one process must not
        # leak each other's query text into logs)
        self.log_queries = log_queries
        self.matcher = PatternMatcher(storage, self.schema, self)
        self._plugin_functions: dict[str, Callable] = {}
        # explicit transaction state (ref: executor.go tx statements :611)
        # Undo frames are THREAD-LOCAL: protocol servers run concurrent
        # statements on one executor, and a shared frame would let thread
        # A's rollback undo thread B's committed writes (the race
        # TestRollback_ConcurrentWritesDuringRollback exercises). Explicit
        # transactions are per-connection-thread too (Bolt session model).
        self._tx_state = threading.local()
        # Write statements serialize while their undo frame is live:
        # rollback restores whole-entity pre-images, so a concurrent write
        # statement committing between another's mutation and its unwind
        # would be silently erased (lost update). Reads never take this.
        self._write_stmt_lock = threading.RLock()
        self._last_call_columns: list[str] = []
        self.query_count = 0
        self._colindex: Any = None  # lazy ColumnarScanIndex; False = unusable
        # columnar operator pipeline + shape-keyed plan cache
        # (cypher/columnar.py; NORNICDB_CYPHER_COLUMNAR=0 disables)
        from nornicdb_tpu_torch.cypher.columnar import ColumnarEngine

        self.columnar = ColumnarEngine(self)
        # opt-in strict OpenCypher semantic validation (ref: the ANTLR
        # validation mode, executor.go:1572-1584, NORNICDB_PARSER=antlr;
        # here NORNICDB_PARSER=strict, with `antlr` accepted as an alias)
        self.strict_validation = strict_mode_enabled()

    def _scan_index(self):
        """Lazily attach the event-maintained columnar scan index
        (cypher/colindex.py) to this executor's storage."""
        if self._colindex is None:
            try:
                from nornicdb_tpu_torch.cypher.colindex import ColumnarScanIndex

                self._colindex = ColumnarScanIndex(self.storage)
            except Exception:
                _log.debug("columnar scan index unavailable; label "
                                "scans use the engine path", exc_info=True)
                self._colindex = False
        return self._colindex or None

    # -- public ----------------------------------------------------------------
    def execute(self, query: str, params: Optional[dict[str, Any]] = None) -> Result:
        """(ref: Execute executor.go:490 — analyze -> cache -> route)

        Telemetry wrapper: every statement lands in the cypher-stage
        latency histogram and opens a ``cypher.execute`` span (a no-op
        handle unless an ingress started a trace on this context);
        statements over the slow-query threshold are captured with plan,
        span breakdown, and adjacency/device-sync counter deltas."""
        t0 = time.perf_counter()
        probe = (
            _slowlog.counters_probe(self.db) if _slow_log.enabled else None
        )
        self.columnar.begin_statement()
        with _tracer.span("cypher.execute") as sp:
            if sp.trace_id is not None:
                sp.set_attr("query", _slowlog.redact_query(query))
            try:
                return self._execute_traced(query, params)
            finally:
                duration = time.perf_counter() - t0
                _STAGE_EXECUTE.observe(duration)
                if self.log_queries:
                    # --log-queries (ref: cmd/nornicdb/main.go:137): every
                    # statement with wall time, via the logging module
                    _query_log.info("%.1fms %s", duration * 1e3,
                                    " ".join(query.split()))
                if _slow_log.enabled and duration >= _slow_log.threshold_s:
                    self._record_slow_query(query, params, duration, probe)

    def _record_slow_query(
        self,
        query: str,
        params: Optional[dict[str, Any]],
        duration: float,
        probe_before: Optional[dict],
    ) -> None:
        """Capture one over-threshold statement into the global slow-query
        ring.  Plan summary is computed here — only slow queries pay for
        EXPLAIN — and must never break the caller's result path."""
        try:
            plan = None
            try:
                stmt = parse(query)  # memoized: cache hit for this query
                if isinstance(stmt, ast.Query):
                    plan = self._explain(stmt)
            except Exception:  # unparseable/plan-less statements: no plan
                _log.debug("no plan for slow query", exc_info=True)
                plan = None
            cur = _tracer.capture()
            col_trace = self.columnar.last_trace()
            columnar = None
            if col_trace is not None:
                # plan-cache key + per-operator timings of the LAST
                # columnar execution on this thread — the slow statement,
                # when it ran columnar at all
                columnar = {
                    "plan_key": col_trace["key"],
                    "outcome": col_trace["outcome"],
                    "cache": col_trace["cache"],
                    "total_ms": col_trace["total_ms"],
                    "operators": [
                        {"op": label, "engine": engine, "rows": rows_n,
                         "ms": ms}
                        for label, engine, rows_n, ms in col_trace["ops"]
                    ],
                }
            _slow_log.maybe_record(
                query,
                params,
                duration,
                plan=plan,
                probe_before=probe_before,
                probe_after=_slowlog.counters_probe(self.db),
                trace_spans=cur.trace.spans if cur is not None else None,
                trace_id=cur.trace_id if cur is not None else None,
                columnar=columnar,
            )
        except Exception:
            _log.warning("slow-query capture failed", exc_info=True)

    def _execute_traced(self, query: str,
                        params: Optional[dict[str, Any]] = None) -> Result:
        self.query_count += 1
        params = params or {}
        stripped = query.lstrip()
        if stripped[:4].lower() == ":use":
            # browser-style :use prefix (ref: executor.go:500-541 — the
            # :USE line selects the database for the rest of the text)
            rest = stripped[4:].lstrip()
            parts = rest.split(None, 1)
            if not parts:
                raise CypherSyntaxError(":use requires a database name")
            query = f"USE {parts[0]}" + (
                f" {parts[1]}" if len(parts) > 1 else ""
            )
        # plan-cache text fast path: repeat read traffic skips parse,
        # validation, classification AND planning. Only full-columnar
        # read-only plans are ever text-bound (maybe_bind_text), so the
        # write-statement machinery below cannot be bypassed. A None from
        # the runner (snapshot momentarily unable to serve) falls through
        # to the normal path.
        if self.columnar.enabled and self._tx_undo is None:
            entry = self.columnar.cache.text_probe(query)
            if entry is not None:
                res = self._execute_text_plan(entry, query, params)
                if res is not None:
                    return res
        _t_parse = time.perf_counter()
        with _tracer.span("cypher.parse"):
            stmt = parse(query)
        _STAGE_PARSE.observe(time.perf_counter() - _t_parse)
        if self.strict_validation:
            validate(stmt)
        if isinstance(stmt, ast.Query):
            # per-database query rate limit (ref: enforcement.go
            # MaxQueriesPerSecond); the bucket lives on the LimitedEngine —
            # except for the DEFAULT database, whose executor runs on the
            # main facade chain, so its state comes from the manager
            limits, bucket = self._query_limits()
            if bucket is not None and not bucket.take():
                raise NornicError(
                    "database query rate limit exceeded "
                    f"({limits.max_queries_per_second}/s)"
                )
        if self.cache is not None and isinstance(stmt, ast.Query):
            write = _is_write_query(stmt)
            if self._tx_undo is not None and not write:
                # reads inside an explicit tx bypass the cache entirely:
                # no stale serve, no spurious invalidation
                return self.execute_statement(stmt, params)
            if not write:
                hit = self.cache.get(query, params)
                if hit is not None:
                    return _copy_result(hit)
                result = self.execute_statement(stmt, params)
                self.columnar.maybe_bind_text(query, stmt)
                if not _is_nondeterministic(stmt):
                    # reads with unlabeled dependencies get EMPTY label sets,
                    # which invalidate_labels always drops — soundness over
                    # retention
                    self.cache.put(
                        query, params, result, _read_cache_labels(stmt)
                    )
                    # the caller gets a COPY on the miss too: the cached
                    # object must never be reachable from callers, or one
                    # mutating a row — or a returned node's properties
                    # dict — would poison every later hit
                    return _copy_result(result)
                return result
            result = self.execute_statement(stmt, params)
            labels = _write_labels(stmt)
            if labels:
                self.cache.invalidate_labels(labels)
            else:
                self.cache.clear()  # unscoped write: drop everything
            return result
        result = self.execute_statement(stmt, params)
        if isinstance(stmt, ast.Query):
            # cache-less executors still get the plan-cache text fast path
            self.columnar.maybe_bind_text(query, stmt)
        return result

    def _execute_text_plan(
        self, entry, query: str, params: dict[str, Any]
    ) -> Optional[Result]:
        """Run a text-bound (full-columnar, read-only) plan, replicating
        the normal read path's rate-limit and result-cache interplay."""
        limits, bucket = self._query_limits()
        if bucket is not None and not bucket.take():
            raise NornicError(
                "database query rate limit exceeded "
                f"({limits.max_queries_per_second}/s)"
            )
        if self.cache is not None:
            hit = self.cache.get(query, params)
            if hit is not None:
                return _copy_result(hit)
        result = self.columnar.run_text_entry(entry, params, Stats())
        if result is None:
            return None  # momentary bail: the generic path re-runs it
        if self.cache is not None and entry.cacheable:
            self.cache.put(query, params, result, set(entry.labels))
            return _copy_result(result)
        return result

    def execute_statement(self, stmt: ast.Statement, params: dict[str, Any]) -> Result:
        if isinstance(stmt, ast.Query):
            if stmt.explain or stmt.profile:
                _t_plan = time.perf_counter()
                with _tracer.span("cypher.plan"):
                    plan = self._explain(stmt)
                _STAGE_PLAN.observe(time.perf_counter() - _t_plan)
                if stmt.explain:
                    return Result(["plan"], [[plan]], plan=plan)
            t0 = time.perf_counter()
            result = self._run_query_atomic(stmt, params)
            if stmt.profile:
                result.plan = (self._explain(stmt)
                               + f"\nruntime: {(time.perf_counter()-t0)*1000:.2f} ms"
                               + f", rows: {len(result.rows)}")
                trace = self.columnar.last_trace(stmt)
                if trace is not None:
                    # measured per-operator timings from THIS execution
                    result.plan += (
                        f"\ncolumnar execution [{trace['outcome']}, cache "
                        f"{trace['cache']}, {trace['total_ms']} ms]:")
                    for label, engine, rows_n, ms in trace["ops"]:
                        result.plan += \
                            f"\n  {label} [{engine}] rows={rows_n} {ms} ms"
            return result
        if isinstance(stmt, ast.CreateIndex):
            r = self._create_index(stmt)
            self._invalidate_cache_for_ddl()
            return r
        if isinstance(stmt, ast.DropIndex):
            self.schema.drop_index(stmt.name, stmt.if_exists)
            self._invalidate_cache_for_ddl()
            return Result([], [])
        if isinstance(stmt, ast.CreateConstraint):
            self.schema.create_constraint(
                stmt.name, stmt.label, stmt.properties, stmt.kind, stmt.if_not_exists
            )
            self._invalidate_cache_for_ddl()
            r = Result([], [])
            r.stats.constraints_added = 1
            return r
        if isinstance(stmt, ast.DropConstraint):
            self.schema.drop_constraint(stmt.name, stmt.if_exists)
            self._invalidate_cache_for_ddl()
            return Result([], [])
        if isinstance(stmt, ast.ShowCommand):
            return self._show(stmt)
        if isinstance(stmt, ast.DatabaseCommand):
            return self._database_command(stmt)
        if isinstance(stmt, ast.UseCommand):
            return self._use_command(stmt, params)
        if isinstance(stmt, ast.TxCommand):
            return self._tx_command(stmt)
        raise CypherSyntaxError(f"unsupported statement {type(stmt).__name__}")

    # -- query pipeline -----------------------------------------------------------
    # The executor-level pattern-fastpath family (ref: DetectQueryPattern
    # query_patterns.go, ExecuteOptimized optimized_executors.go) is fully
    # RETIRED into the columnar operator pipeline (cypher/columnar.py):
    # counts are planner short circuits (NodeCountOp/EdgeCountOp) and
    # edge-property aggregation runs over the CSR-resident edge property
    # columns (storage/adjacency.py edge_prop_column) — deleted here, not
    # shadowed.
    def _run_query(
        self,
        q: ast.Query,
        params: dict[str, Any],
        start_rows: Optional[list[dict]] = None,
        stats: Optional[Stats] = None,
    ) -> Result:
        result = self._run_single(q, params, start_rows, stats)
        for sub, all_ in q.unions:
            other = self._run_single(sub, params, start_rows, stats)
            if other.columns != result.columns:
                raise CypherSyntaxError("UNION queries must return the same columns")
            result.rows.extend(other.rows)
            if not all_:
                seen = set()
                unique = []
                for r in result.rows:
                    key = _hashable(r)
                    if key not in seen:
                        seen.add(key)
                        unique.append(r)
                result.rows = unique
        return result

    def _run_single(
        self,
        q: ast.Query,
        params: dict[str, Any],
        start_rows: Optional[list[dict]] = None,
        stats: Optional[Stats] = None,
    ) -> Result:
        stats = stats if stats is not None else Stats()
        if start_rows is None:
            # columnar operator pipeline (cypher/columnar.py): compiled
            # plans over the CSR snapshot with per-operator fallback; a
            # None return means "serve it generically" (unsupported shape
            # or the snapshot cannot serve this engine/query right now)
            res = self.columnar.try_query(q, params, stats)
            if res is not None:
                return res
        rows: list[dict[str, Any]] = (
            [dict(r) for r in start_rows] if start_rows is not None else [{}]
        )
        return self._finish_clauses(q, params, rows, 0, stats)

    def _finish_clauses(
        self,
        q: ast.Query,
        params: dict[str, Any],
        rows: list[dict],
        start_idx: int,
        stats: Stats,
    ) -> Result:
        """Run clauses from ``start_idx`` over generic binding rows — the
        whole query when called from _run_single, the generic tail when
        the columnar pipeline hands a partial binding table back."""
        columns: list[str] = []
        out_rows: list[list[Any]] = []
        produced = False
        # per-database query budget (ref: enforcement.go MaxQueryTime):
        # checked at clause boundaries — coarse, but enough to stop
        # multi-clause runaways without per-row overhead. Monotonic clock:
        # wall-time steps must not expire (or extend) the budget.
        limits, _ = self._query_limits()
        deadline = (
            time.monotonic() + limits.max_query_time
            if limits is not None and getattr(limits, "max_query_time", 0)
            else None
        )
        for clause in q.clauses[start_idx:]:
            if deadline is not None and time.monotonic() > deadline:
                raise NornicError(
                    f"query exceeded max_query_time "
                    f"({limits.max_query_time}s)"
                )
            if isinstance(clause, ast.ReturnClause):
                columns, out_rows = self._project(clause, rows, params, stats)
                produced = True
                break
            rows = self._apply_clause(clause, rows, params, stats)
        if not produced:
            last = q.clauses[-1] if q.clauses else None
            if isinstance(last, ast.CallClause):
                # standalone CALL: its yielded columns are the result
                if last.yield_items:
                    columns = [a or n for n, a in last.yield_items]
                else:
                    columns = self._last_call_columns
                out_rows = [[r.get(c) for c in columns] for r in rows]
        return Result(columns, out_rows, stats)

    def _apply_clause(
        self, clause: ast.Clause, rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        if isinstance(clause, ast.MatchClause):
            return self._match(clause, rows, params)
        if isinstance(clause, ast.CreateClause):
            return self._create(clause, rows, params, stats)
        if isinstance(clause, ast.MergeClause):
            return self._merge(clause, rows, params, stats)
        if isinstance(clause, ast.SetClause):
            return self._set(clause.items, rows, params, stats)
        if isinstance(clause, ast.RemoveClause):
            return self._remove(clause.items, rows, params, stats)
        if isinstance(clause, ast.DeleteClause):
            return self._delete(clause, rows, params, stats)
        if isinstance(clause, ast.WithClause):
            return self._with(clause, rows, params, stats)
        if isinstance(clause, ast.UnwindClause):
            return self._unwind(clause, rows, params)
        if isinstance(clause, ast.CallClause):
            return self._call(clause, rows, params, stats)
        if isinstance(clause, ast.CallSubquery):
            return self._call_subquery(clause, rows, params, stats)
        if isinstance(clause, ast.ForeachClause):
            return self._foreach(clause, rows, params, stats)
        if isinstance(clause, ast.LoadCsvClause):
            return self._load_csv(clause, rows, params)
        raise CypherSyntaxError(f"unsupported clause {type(clause).__name__}")

    # -- MATCH -----------------------------------------------------------------
    def _match(self, clause: ast.MatchClause, rows: list[dict], params: dict) -> list[dict]:
        _t_match = time.perf_counter()
        with _tracer.span("cypher.match"):
            out = self._match_inner(clause, rows, params)
        _STAGE_MATCH.observe(time.perf_counter() - _t_match)
        return out

    def _match_inner(self, clause: ast.MatchClause, rows: list[dict], params: dict) -> list[dict]:
        fast = self._match_scan_fast(clause, rows, params)
        if fast is not None:
            return fast
        out: list[dict] = []
        for row in rows:
            matched: list[dict] = [row]
            for pattern in clause.patterns:
                nxt: list[dict] = []
                for r in matched:
                    nxt.extend(self.matcher.match_path(pattern, r, params))
                matched = nxt
            if clause.where is not None:
                matched = [
                    r
                    for r in matched
                    if evaluate(clause.where, EvalContext(r, params, self)) is True
                ]
            if clause.optional and not matched:
                null_row = dict(row)
                for pattern in clause.patterns:
                    for var in _pattern_variables(pattern):
                        null_row.setdefault(var, None)
                out.append(null_row)
            else:
                out.extend(matched)
        return out

    def _match_scan_fast(
        self, clause: ast.MatchClause, rows: list[dict], params: dict
    ) -> Optional[list[dict]]:
        """Large single-node-pattern scans with a WHERE: columnar mask over
        the candidate list + thread-pooled residual filter, instead of a
        full expression-tree walk per row (ref: parallelFilterNodes
        parallel.go:99 + the MinBatchSize gate :100; columnar design note in
        cypher/parallel.py). Semantics-identical to the generic path — the
        chaos suite runs both and compares."""
        from nornicdb_tpu_torch.cypher.parallel import (
            compile_where,
            get_parallel_config,
            parallel_filter,
        )

        if len(clause.patterns) != 1 or len(rows) != 1:
            return None
        pattern = clause.patterns[0]
        if pattern.name or pattern.shortest or len(pattern.elements) != 1:
            return None
        node_pat = pattern.elements[0]
        if not isinstance(node_pat, ast.NodePattern) or not node_pat.variable:
            return None
        row = rows[0]
        if node_pat.variable in row:
            return None
        where = _and_exprs(node_pat.where, clause.where)
        if where is None:
            return None  # unfiltered scan is already a single pass
        cfg = get_parallel_config()
        if not cfg.enabled:
            return None
        cw = compile_where(where, node_pat.variable)
        nodes: Optional[list] = None
        # preferred: columns straight from the scan index — only survivors
        # ever materialize as Nodes
        if (
            cw.has_columnar
            and len(node_pat.labels) == 1
            and node_pat.properties is None
        ):
            label = node_pat.labels[0]
            # the columnar mask is one vectorized numpy op — profitable far
            # below cfg.min_batch_size (that gate prices THREAD dispatch;
            # parallel_filter still applies it to any residual predicate)
            if self.storage.count_nodes_by_label(label) < cfg.columnar_min_rows:
                return None
            idx = self._scan_index()
            if idx is not None:
                ids = idx.masked_ids(label, cw, params)
                if ids is not None:
                    nodes = self.storage.batch_get_nodes(sorted(ids))
        if nodes is None:
            candidates = self.matcher._candidates(
                ast.NodePattern(node_pat.variable, node_pat.labels,
                                node_pat.properties),
                row, params,
            )
            if len(candidates) < cfg.min_batch_size:
                return None
            nodes = candidates
            if cw.has_columnar:
                mask = cw.mask(nodes, params)
                nodes = [n for n, m in zip(nodes, mask) if m]
        if cw.residual is not None:
            res = cw.residual
            var = node_pat.variable

            def pred(n):
                return evaluate(res, EvalContext({**row, var: n}, params, self))

            nodes = parallel_filter(nodes, pred)
        out = [{**row, node_pat.variable: n} for n in nodes]
        if clause.optional and not out:
            null_row = dict(row)
            null_row.setdefault(node_pat.variable, None)
            return [null_row]
        return out

    # -- CREATE ------------------------------------------------------------------
    def _create(
        self, clause: ast.CreateClause, rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        out = []
        for row in rows:
            new_row = dict(row)
            for pattern in clause.patterns:
                self._create_path(pattern, new_row, params, stats)
            out.append(new_row)
        return out

    def _create_path(
        self, pattern: ast.PatternPath, row: dict, params: dict, stats: Stats
    ) -> None:
        elements = pattern.elements
        nodes: list[Node] = []
        rels: list[Edge] = []
        prev_node: Optional[Node] = None
        i = 0
        while i < len(elements):
            el = elements[i]
            if isinstance(el, ast.NodePattern):
                node = self._resolve_or_create_node(el, row, params, stats)
                nodes.append(node)
                if i > 0:
                    rel_pat = elements[i - 1]
                    edge = self._create_edge(rel_pat, prev_node, node, row, params, stats)
                    rels.append(edge)
                prev_node = node
                i += 1
            else:
                i += 1
        if pattern.name:
            row[pattern.name] = make_path(nodes, rels)

    def _resolve_or_create_node(
        self, pat: ast.NodePattern, row: dict, params: dict, stats: Stats
    ) -> Node:
        if pat.variable and pat.variable in row:
            v = row[pat.variable]
            if not isinstance(v, Node):
                raise CypherTypeError(f"variable `{pat.variable}` is not a node")
            if pat.labels or pat.properties:
                raise CypherSyntaxError(
                    f"variable `{pat.variable}` already declared"
                )
            return v
        props = {}
        if pat.properties is not None:
            props = evaluate(pat.properties, EvalContext(row, params, self)) or {}
        node = Node(labels=list(pat.labels), properties=dict(props))
        self.schema.check_unique(node)
        created = self.storage.create_node(node)
        self._record_undo(lambda nid=created.id: self.storage.delete_node(nid))
        if self.db is not None and getattr(self.db.config, "embed_enabled", False):
            self.storage.mark_pending_embed(created.id)
        stats.nodes_created += 1
        stats.properties_set += len(props)
        stats.labels_added += len(pat.labels)
        if pat.variable:
            row[pat.variable] = created
        return created

    def _create_edge(
        self, rel_pat: ast.RelPattern, start: Node, end: Node, row, params, stats
    ) -> Edge:
        if rel_pat.direction == "both":
            raise CypherSyntaxError("CREATE requires a directed relationship")
        if rel_pat.var_length:
            raise CypherSyntaxError("cannot CREATE a variable-length relationship")
        props = {}
        if rel_pat.properties is not None:
            props = evaluate(rel_pat.properties, EvalContext(row, params, self)) or {}
        rel_type = rel_pat.types[0] if rel_pat.types else "RELATED_TO"
        s, t = (start, end) if rel_pat.direction == "out" else (end, start)
        edge = Edge(start_node=s.id, end_node=t.id, type=rel_type, properties=dict(props))
        created = self.storage.create_edge(edge)
        self._record_undo(lambda eid=created.id: self.storage.delete_edge(eid))
        stats.relationships_created += 1
        stats.properties_set += len(props)
        if rel_pat.variable:
            row[rel_pat.variable] = created
        return created

    # -- MERGE --------------------------------------------------------------------
    def _merge(
        self, clause: ast.MergeClause, rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        """(ref: merge.go)"""
        out = []
        for row in rows:
            matches = list(self.matcher.match_path(clause.pattern, row, params))
            if matches:
                for m in matches:
                    if clause.on_match:
                        self._set(clause.on_match, [m], params, stats)
                        m = self._refresh_row(m)
                    out.append(m)
            else:
                new_row = dict(row)
                self._create_path(clause.pattern, new_row, params, stats)
                if clause.on_create:
                    self._set(clause.on_create, [new_row], params, stats)
                    new_row = self._refresh_row(new_row)
                out.append(new_row)
        return out

    def _refresh_row(self, row: dict) -> dict:
        """Re-fetch entities after SET so later clauses see fresh copies."""
        out = {}
        for k, v in row.items():
            if isinstance(v, Node):
                try:
                    out[k] = self.storage.get_node(v.id)
                except NotFoundError:
                    out[k] = v
            elif isinstance(v, Edge):
                try:
                    out[k] = self.storage.get_edge(v.id)
                except NotFoundError:
                    out[k] = v
            else:
                out[k] = v
        return out

    # -- SET / REMOVE ----------------------------------------------------------------
    def _set(
        self, items: list[ast.SetItem], rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        for row in rows:
            ctx = EvalContext(row, params, self)
            for item in items:
                if item.kind == "property":
                    assert isinstance(item.target, ast.Property)
                    entity = evaluate(item.target.subject, ctx)
                    if entity is None:
                        continue
                    value = evaluate(item.value, ctx) if item.value is not None else None
                    self._set_property(entity, item.target.key, value, stats)
                elif item.kind == "variable":
                    entity = evaluate(item.target, ctx)
                    if entity is None:
                        continue
                    value = evaluate(item.value, ctx)
                    if not isinstance(value, dict):
                        if isinstance(value, (Node, Edge)):
                            value = dict(value.properties)
                        else:
                            raise CypherTypeError("SET n = expects a map")
                    self._set_all_properties(entity, value, item.merge, stats)
                elif item.kind == "label":
                    entity = evaluate(item.target, ctx)
                    if entity is None:
                        continue
                    if not isinstance(entity, Node):
                        raise CypherTypeError("labels can only be set on nodes")
                    self._add_labels(entity, item.labels, stats)
            # refresh entity bindings so subsequent clauses see updates
            refreshed = self._refresh_row(row)
            row.clear()
            row.update(refreshed)
        return rows

    def _set_property(self, entity, key: str, value, stats: Stats) -> None:
        if isinstance(entity, Node):
            node = self.storage.get_node(entity.id)
            old = node.copy()
            if value is None:
                node.properties.pop(key, None)
            else:
                node.properties[key] = _to_storable(value)
            self.schema.check_unique(node, exclude_id=node.id)
            self.storage.update_node(node)
            self._record_undo(lambda o=old: self.storage.update_node(o))
            stats.properties_set += 1
        elif isinstance(entity, Edge):
            edge = self.storage.get_edge(entity.id)
            old = edge.copy()
            if value is None:
                edge.properties.pop(key, None)
            else:
                edge.properties[key] = _to_storable(value)
            self.storage.update_edge(edge)
            self._record_undo(lambda o=old: self.storage.update_edge(o))
            stats.properties_set += 1
        else:
            raise CypherTypeError("SET target must be a node or relationship")

    def _set_all_properties(self, entity, value: dict, merge: bool, stats: Stats) -> None:
        value = {k: _to_storable(v) for k, v in value.items()}
        if isinstance(entity, Node):
            node = self.storage.get_node(entity.id)
            old = node.copy()
            if merge:
                node.properties.update(value)
            else:
                node.properties = dict(value)
            self.schema.check_unique(node, exclude_id=node.id)
            self.storage.update_node(node)
            self._record_undo(lambda o=old: self.storage.update_node(o))
            stats.properties_set += len(value)
        elif isinstance(entity, Edge):
            edge = self.storage.get_edge(entity.id)
            old = edge.copy()
            if merge:
                edge.properties.update(value)
            else:
                edge.properties = dict(value)
            self.storage.update_edge(edge)
            self._record_undo(lambda o=old: self.storage.update_edge(o))
            stats.properties_set += len(value)
        else:
            raise CypherTypeError("SET target must be a node or relationship")

    def _add_labels(self, entity: Node, labels: list[str], stats: Stats) -> None:
        node = self.storage.get_node(entity.id)
        old = node.copy()
        added = 0
        for lbl in labels:
            if lbl not in node.labels:
                node.labels.append(lbl)
                added += 1
        if added:
            self.storage.update_node(node)
            self._record_undo(lambda o=old: self.storage.update_node(o))
            stats.labels_added += added

    def _remove(
        self, items: list[ast.SetItem], rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        for row in rows:
            ctx = EvalContext(row, params, self)
            for item in items:
                if item.kind == "property":
                    assert isinstance(item.target, ast.Property)
                    entity = evaluate(item.target.subject, ctx)
                    if entity is None:
                        continue
                    self._set_property(entity, item.target.key, None, stats)
                elif item.kind == "label":
                    entity = evaluate(item.target, ctx)
                    if entity is None:
                        continue
                    node = self.storage.get_node(entity.id)
                    old = node.copy()
                    removed = 0
                    for lbl in item.labels:
                        if lbl in node.labels:
                            node.labels.remove(lbl)
                            removed += 1
                    if removed:
                        self.storage.update_node(node)
                        self._record_undo(lambda o=old: self.storage.update_node(o))
                        stats.labels_removed += removed
            refreshed = self._refresh_row(row)
            row.clear()
            row.update(refreshed)
        return rows

    # -- DELETE ------------------------------------------------------------------
    def _delete(
        self, clause: ast.DeleteClause, rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        deleted_nodes: set[str] = set()
        deleted_edges: set[str] = set()
        for row in rows:
            ctx = EvalContext(row, params, self)
            for expr in clause.exprs:
                v = evaluate(expr, ctx)
                items = v if isinstance(v, list) else [v]
                for item in items:
                    if item is None:
                        continue
                    if isinstance(item, Node):
                        self._delete_node(item.id, clause.detach, deleted_nodes,
                                          deleted_edges, stats)
                    elif isinstance(item, Edge):
                        self._delete_edge(item.id, deleted_edges, stats)
                    elif isinstance(item, dict) and item.get("__path__"):
                        # deleting a path deletes its relationships AND nodes
                        for e in item.get("relationships", []):
                            self._delete_edge(e.id, deleted_edges, stats)
                        for pn in item.get("nodes", []):
                            self._delete_node(pn.id, clause.detach, deleted_nodes,
                                              deleted_edges, stats)
                    else:
                        raise CypherTypeError("DELETE expects nodes/relationships")
        return rows

    def _delete_node(
        self,
        node_id: str,
        detach: bool,
        deleted_nodes: set[str],
        deleted_edges: set[str],
        stats: Stats,
    ) -> None:
        if node_id in deleted_nodes:
            return
        try:
            old = self.storage.get_node(node_id)
        except NotFoundError:
            deleted_nodes.add(node_id)  # already gone (e.g. earlier cascade)
            return
        old_edges = {
            e.id: e
            for e in self.storage.get_outgoing_edges(node_id)
            + self.storage.get_incoming_edges(node_id)
        }
        if old_edges and not detach:
            raise CypherTypeError(
                "cannot delete node with relationships; use DETACH DELETE"
            )
        self.storage.delete_node(node_id)
        deleted_nodes.add(node_id)
        stats.nodes_deleted += 1
        cascaded = set(old_edges) - deleted_edges
        stats.relationships_deleted += len(cascaded)
        deleted_edges.update(old_edges)

        def undo_node(o=old, es=[old_edges[i] for i in cascaded]):
            self.storage.create_node(o)
            for e in es:
                try:
                    self.storage.create_edge(e)
                except Exception:
                    _log.debug("undo: cascaded-edge restore failed",
                               exc_info=True)

        self._record_undo(undo_node)

    def _delete_edge(
        self, edge_id: str, deleted_edges: set[str], stats: Stats
    ) -> None:
        if edge_id in deleted_edges:
            return
        try:
            old_e = self.storage.get_edge(edge_id)
        except NotFoundError:
            deleted_edges.add(edge_id)  # cascaded away by an earlier node delete
            return
        self.storage.delete_edge(edge_id)
        deleted_edges.add(edge_id)
        stats.relationships_deleted += 1
        self._record_undo(lambda o=old_e: self.storage.create_edge(o))

    # -- WITH / RETURN projection ---------------------------------------------------
    def _with(
        self, clause: ast.WithClause, rows: list[dict], params: dict, stats: Stats
    ) -> list[dict]:
        ret = ast.ReturnClause(
            clause.items, clause.distinct, clause.order_by, clause.skip,
            clause.limit, clause.star,
        )
        columns, data = self._project(ret, rows, params, stats, star_keep=clause.star,
                                      original_rows=rows)
        out = [dict(zip(columns, r)) for r in data]
        if clause.where is not None:
            out = [
                r for r in out
                if evaluate(clause.where, EvalContext(r, params, self)) is True
            ]
        return out

    def _project(
        self,
        clause: ast.ReturnClause,
        rows: list[dict],
        params: dict,
        stats: Stats,
        star_keep: bool = False,
        original_rows: Optional[list[dict]] = None,
    ) -> tuple[list[str], list[list[Any]]]:
        _t_proj = time.perf_counter()
        with _tracer.span("cypher.project"):
            out = self._project_inner(clause, rows, params, stats,
                                      star_keep, original_rows)
        _STAGE_PROJECT.observe(time.perf_counter() - _t_proj)
        return out

    def _project_inner(
        self,
        clause: ast.ReturnClause,
        rows: list[dict],
        params: dict,
        stats: Stats,
        star_keep: bool = False,
        original_rows: Optional[list[dict]] = None,
    ) -> tuple[list[str], list[list[Any]]]:
        items = list(clause.items)
        star = getattr(clause, "star", False)
        # RETURN * / WITH * expands to all bound variables
        if star:
            star_cols = sorted({k for r in rows for k in r.keys()})
            star_items = [ast.ReturnItem(ast.Variable(c), c) for c in star_cols]
            items = star_items + items
        columns = [it.key for it in items]
        has_agg = any(_contains_aggregate(it.expr) for it in items)
        if has_agg:
            data = self._aggregate_project(items, rows, params)
            source_rows: list[dict] = [{} for _ in data]
        else:
            data = []
            source_rows = []
            for row in rows:
                ctx = EvalContext(row, params, self)
                data.append([evaluate(it.expr, ctx) for it in items])
                source_rows.append(row)
        if clause.distinct:
            seen = set()
            unique, unique_src = [], []
            for r, src in zip(data, source_rows):
                key = _hashable(r)
                if key not in seen:
                    seen.add(key)
                    unique.append(r)
                    unique_src.append(src)
            data, source_rows = unique, unique_src
        if clause.order_by:
            data = self._order_by(
                clause.order_by, columns, data, source_rows, params
            )
        if clause.skip is not None:
            n = evaluate(clause.skip, EvalContext({}, params, self))
            data = data[int(n):]
        if clause.limit is not None:
            n = evaluate(clause.limit, EvalContext({}, params, self))
            data = data[: int(n)]
        return columns, data

    def _order_by(self, order_items, columns, data, source_rows, params):
        # ORDER BY may reference output columns OR pre-projection variables.
        # Keys are evaluated ONCE per row, then sorted with one stable pass
        # per key (last key first — stability composes them). A pass whose
        # values are all-numeric or all-string sorts on the native value;
        # only mixed-type/entity passes pay for the _SortKey comparison
        # wrapper (profiled: wrapper comparisons dominated traversal+sort
        # query time before this).
        keyed = []
        for row_vals, src in zip(data, source_rows):
            binding = dict(src)
            binding.update(dict(zip(columns, row_vals)))
            keys = []
            for oi in order_items:
                if isinstance(oi.expr, ast.Variable) and oi.expr.name in binding:
                    v = binding[oi.expr.name]
                else:
                    v = evaluate(oi.expr, EvalContext(binding, params, self))
                keys.append(v)
            keyed.append((keys, row_vals))

        return _multisort(keyed, [oi.descending for oi in order_items])

    def _aggregate_project(self, items, rows, params) -> list[list[Any]]:
        group_idx = [i for i, it in enumerate(items) if not _contains_aggregate(it.expr)]
        agg_idx = [i for i, it in enumerate(items) if _contains_aggregate(it.expr)]
        groups: dict[Any, dict] = {}
        order: list[Any] = []
        for row in rows:
            ctx = EvalContext(row, params, self)
            gkey_vals = [evaluate(items[i].expr, ctx) for i in group_idx]
            gkey = _hashable(gkey_vals)
            if gkey not in groups:
                groups[gkey] = {"key_vals": gkey_vals, "rows": []}
                order.append(gkey)
            groups[gkey]["rows"].append(row)
        if not rows and not group_idx:
            groups[()] = {"key_vals": [], "rows": []}
            order.append(())
        out = []
        for gkey in order:
            g = groups[gkey]
            vals: list[Any] = [None] * len(items)
            for pos, i in enumerate(group_idx):
                vals[i] = g["key_vals"][pos]
            for i in agg_idx:
                vals[i] = self._eval_aggregate(items[i].expr, g["rows"], params)
            out.append(vals)
        return out

    def _eval_aggregate(self, expr: ast.Expr, rows: list[dict], params: dict) -> Any:
        if isinstance(expr, ast.FunctionCall) and is_aggregate(expr.name):
            name = expr.name
            if name == "count" and expr.args and isinstance(expr.args[0], ast.Literal) \
                    and expr.args[0].value == "*":
                return len(rows)
            values = []
            for row in rows:
                ctx = EvalContext(row, params, self)
                v = evaluate(expr.args[0], ctx) if expr.args else None
                if v is not None:
                    values.append(v)
            if expr.distinct:
                seen = set()
                uniq = []
                for v in values:
                    k = _hashable([v])
                    if k not in seen:
                        seen.add(k)
                        uniq.append(v)
                values = uniq
            if name == "count":
                return len(values)
            if name == "collect":
                return values
            if name == "sum":
                return sum(values) if values else 0
            if name == "avg":
                return sum(values) / len(values) if values else None
            if name == "min":
                return min(values) if values else None
            if name == "max":
                return max(values) if values else None
            if name in ("stdev", "stdevp"):
                if len(values) < 2:
                    return 0.0
                arr = np.asarray(values, np.float64)
                return float(arr.std(ddof=1 if name == "stdev" else 0))
            if name in ("percentilecont", "percentiledisc"):
                if len(expr.args) != 2:
                    raise CypherSyntaxError(f"{name} expects (value, percentile)")
                p = evaluate(
                    expr.args[1],
                    EvalContext(rows[0] if rows else {}, params, self),
                )
                if not values:
                    return None
                arr = np.sort(np.asarray(values, np.float64))
                if name == "percentilecont":
                    return float(np.quantile(arr, float(p)))
                # nearest-rank (discrete)
                idx = max(int(np.ceil(float(p) * len(arr))) - 1, 0)
                v = arr[min(idx, len(arr) - 1)]
                return int(v) if float(v).is_integer() and all(
                    isinstance(x, int) for x in values
                ) else float(v)
        # expression containing aggregates, e.g. count(x) + 1
        if isinstance(expr, ast.BinaryOp):
            left = (
                self._eval_aggregate(expr.left, rows, params)
                if _contains_aggregate(expr.left)
                else evaluate(expr.left, EvalContext(rows[0] if rows else {}, params, self))
            )
            right = (
                self._eval_aggregate(expr.right, rows, params)
                if _contains_aggregate(expr.right)
                else evaluate(expr.right, EvalContext(rows[0] if rows else {}, params, self))
            )
            return _binary_value(expr.op, left, right)
        if isinstance(expr, ast.FunctionCall):
            # scalar fn over aggregate args, e.g. round(avg(x))
            args = [
                self._eval_aggregate(a, rows, params)
                if _contains_aggregate(a)
                else evaluate(a, EvalContext(rows[0] if rows else {}, params, self))
                for a in expr.args
            ]
            fn = FUNCTIONS.get(expr.name) or self.lookup_function(expr.name)
            if fn is None:
                raise CypherSyntaxError(f"unknown function {expr.name}()")
            if getattr(fn, "needs_executor", False):
                # as evaluate() calls it: apoc.algo.pageRank(collect(n))
                # (the JAX package passes no executor here and raises
                # TypeError; ROADMAP §C, recorded differences)
                return fn(self, *args)
            return fn(*args)
        raise CypherSyntaxError("invalid aggregate expression")

    # -- UNWIND / CALL / FOREACH / LOAD CSV -----------------------------------------
    def _unwind(self, clause: ast.UnwindClause, rows, params) -> list[dict]:
        out = []
        for row in rows:
            v = evaluate(clause.expr, EvalContext(row, params, self))
            if v is None:
                continue
            items = v if isinstance(v, list) else [v]
            for item in items:
                nr = dict(row)
                nr[clause.variable] = item
                if clause.where is not None and evaluate(
                    clause.where, EvalContext(nr, params, self)
                ) is not True:
                    # UNWIND ... WHERE row filter (reference dialect)
                    continue
                out.append(nr)
        return out

    def _call(self, clause: ast.CallClause, rows, params, stats) -> list[dict]:
        fn = PROCEDURES.get(clause.procedure)
        if fn is None:
            raise CypherSyntaxError(f"unknown procedure {clause.procedure}")
        self._last_call_columns: list[str] = []
        out = []
        for row in rows:
            args = [
                evaluate(a, EvalContext(row, params, self)) for a in clause.args
            ]
            cols, data = fn(self, args, row)
            self._last_call_columns = list(cols)
            if not clause.yield_items and not clause.yield_star:
                # no YIELD: procedure acts as a side effect / passthrough
                if not data:
                    out.append(row)
                for r in data:
                    nr = dict(row)
                    nr.update(dict(zip(cols, r)))
                    out.append(nr)
                continue
            names = (
                [(c, None) for c in cols] if clause.yield_star else clause.yield_items
            )
            for r in data:
                rec = dict(zip(cols, r))
                nr = dict(row)
                for name, alias in names:
                    if name not in rec:
                        raise CypherSyntaxError(
                            f"procedure {clause.procedure} does not yield `{name}`"
                        )
                    nr[alias or name] = rec[name]
                if clause.where is not None and evaluate(
                    clause.where, EvalContext(nr, params, self)
                ) is not True:
                    continue
                out.append(nr)
        return self._apply_order_skip_limit(
            out, clause.order_by, clause.skip, clause.limit, params
        )

    def _apply_order_skip_limit(self, rows, order_by, skip, limit, params):
        """Shared ORDER BY/SKIP/LIMIT tail for the RETURN-less CALL forms
        (standalone CALL ... YIELD and CALL { ... } subqueries)."""
        if order_by:
            def sort_keys(r):
                return [
                    _SortKey(
                        evaluate(oi.expr, EvalContext(r, params, self)),
                        oi.descending,
                    )
                    for oi in order_by
                ]

            rows.sort(key=sort_keys)
        if skip is not None:
            rows = rows[int(evaluate(skip, EvalContext({}, params, self))):]
        if limit is not None:
            rows = rows[: int(evaluate(limit, EvalContext({}, params, self)))]
        return rows

    def eval_collect_subquery(self, e, ctx: EvalContext) -> list:
        """COLLECT { ... RETURN expr } — correlated single-column subquery
        per row; returns the column values as a list (Neo4j 5)."""
        res = self._run_query(
            e.query, ctx.params, start_rows=[dict(ctx.bindings)],
            stats=Stats(),
        )
        if len(res.columns) != 1:
            raise CypherSyntaxError(
                "COLLECT subquery must return exactly one column"
            )
        return [row[0] for row in res.rows]

    def _call_subquery(self, clause: ast.CallSubquery, rows, params, stats) -> list[dict]:
        if clause.in_transactions:
            return self._call_in_transactions(clause, rows, params, stats)
        out = []
        returns = any(
            isinstance(c, ast.ReturnClause) for c in clause.query.clauses
        )
        for row in rows:
            # full query semantics per input row — including UNION branches;
            # writes inside the subquery accumulate into the outer stats
            res = self._run_query(clause.query, params, start_rows=[row], stats=stats)
            if not returns:
                out.append(row)
                continue
            for r in res.rows:
                nr = dict(row)
                nr.update(dict(zip(res.columns, r)))
                out.append(nr)
        # reference-dialect tail: CALL { ... } ORDER BY/SKIP/LIMIT
        return self._apply_order_skip_limit(
            out, clause.order_by, clause.skip, clause.limit, params
        )

    def _call_in_transactions(
        self, clause: ast.CallSubquery, rows, params, stats
    ) -> list[dict]:
        """CALL { ... } IN TRANSACTIONS OF n ROWS — input rows run through
        the subquery in committed batches (Neo4j ON ERROR FAIL semantics:
        earlier batches stay committed, the failing batch aborts the query).
        WAL transaction markers bracket each batch when the storage chain
        supports them."""
        out = []
        returns = any(
            isinstance(c, ast.ReturnClause) for c in clause.query.clauses
        )
        batch = max(clause.batch_rows, 1)
        tx_begin = getattr(self.storage, "tx_begin", None)
        tx_commit = getattr(self.storage, "tx_commit", None)
        for start in range(0, len(rows), batch):
            chunk = rows[start : start + batch]
            txid = str(uuid.uuid4())
            if callable(tx_begin):
                tx_begin(txid)
            # checkpoint the implicit statement frame: once this batch
            # commits, its mutations are durable and must NOT be undone by a
            # later batch's failure (ON ERROR FAIL: earlier batches stay)
            mark = (len(self._tx_undo)
                    if self._tx_implicit and self._tx_undo is not None
                    else None)
            try:
                for row in chunk:
                    res = self._run_query(
                        clause.query, params, start_rows=[row], stats=stats
                    )
                    if returns:
                        for r in res.rows:
                            nr = dict(row)
                            nr.update(dict(zip(res.columns, r)))
                            out.append(nr)
                    else:
                        out.append(row)
            except Exception:
                if callable(getattr(self.storage, "tx_rollback", None)):
                    self.storage.tx_rollback(txid)
                raise
            if callable(tx_commit):
                tx_commit(txid)
            if mark is not None:
                del self._tx_undo[mark:]
        return out

    def _foreach(self, clause: ast.ForeachClause, rows, params, stats) -> list[dict]:
        for row in rows:
            v = evaluate(clause.expr, EvalContext(row, params, self))
            if v is None:
                continue
            if not isinstance(v, list):
                raise CypherTypeError("FOREACH expects a list")
            for item in v:
                inner = dict(row)
                inner[clause.variable] = item
                inner_rows = [inner]
                for c in clause.updates:
                    inner_rows = self._apply_clause(c, inner_rows, params, stats)
        return rows

    def _load_csv(self, clause: ast.LoadCsvClause, rows, params) -> list[dict]:
        # The reference refuses LOAD CSV in embedded mode outright
        # (clauses.go:1800 "not supported"); here it exists as an opt-in
        # superset gated exactly like apoc.load.* — never a default
        # capability, confinable to an import directory.
        from nornicdb_tpu_torch.config import resolve_import_url

        out = []
        for row in rows:
            url = evaluate(clause.url, EvalContext(row, params, self))
            try:
                path = resolve_import_url(str(url))
            except PermissionError as e:
                raise CypherTypeError(str(e)) from None
            with open(path, newline="") as f:
                reader = csv_mod.reader(f, delimiter=clause.field_terminator)
                data = list(reader)
            if clause.with_headers:
                if not data:
                    continue
                headers = data[0]
                for rec in data[1:]:
                    nr = dict(row)
                    nr[clause.variable] = dict(zip(headers, rec))
                    out.append(nr)
            else:
                for rec in data:
                    nr = dict(row)
                    nr[clause.variable] = list(rec)
                    out.append(nr)
        return out

    # -- pattern expressions (WHERE (a)-[:X]->(b), EXISTS {}, COUNT {}) -----------
    def eval_pattern_expr(self, e, ctx: EvalContext) -> Any:
        if isinstance(e, ast.PatternPredicate):
            it = self.matcher.match_path(e.pattern, ctx.bindings, ctx.params)
            return next(iter(it), None) is not None
        if isinstance(e, (ast.ExistsSubquery, ast.CountSubquery)):
            count = 0
            for r in self.matcher.match_path(e.pattern, ctx.bindings, ctx.params):
                if e.where is None or evaluate(
                    e.where, EvalContext(r, ctx.params, self)
                ) is True:
                    count += 1
                    if isinstance(e, ast.ExistsSubquery):
                        return True
            return count if isinstance(e, ast.CountSubquery) else False
        raise CypherTypeError("unknown pattern expression")

    def eval_pattern_comprehension(self, e, ctx: EvalContext) -> list:
        """[(a)-[:R]->(b) WHERE p | expr] — match from current bindings,
        filter, project."""
        out = []
        for row in self.matcher.match_path(e.pattern, ctx.bindings, ctx.params):
            row_ctx = EvalContext(row, ctx.params, self)
            if e.where is not None and evaluate(e.where, row_ctx) is not True:
                continue
            out.append(evaluate(e.projection, row_ctx))
        return out

    # -- hooks -------------------------------------------------------------------
    def get_node_or_none(self, node_id: str) -> Optional[Node]:
        try:
            return self.storage.get_node(node_id)
        except NotFoundError:
            return None

    def lookup_function(self, name: str) -> Optional[Callable]:
        """Plugin / APOC function lookup (ref: PluginFunctionLookup db.go:933)."""
        fn = self._plugin_functions.get(name)
        if fn is not None:
            return fn
        if name.startswith("apoc."):
            try:
                from nornicdb_tpu_torch.apoc import lookup as apoc_lookup

                return apoc_lookup(name)
            except ImportError:
                return None
        return None

    def register_function(self, name: str, fn: Callable) -> None:
        self._plugin_functions[name.lower()] = fn

    # -- transactions ---------------------------------------------------------------
    def _tx_command(self, stmt: ast.TxCommand) -> Result:
        if stmt.op == "begin":
            if self._tx_undo is not None:
                raise TransactionError("transaction already open")
            self._tx_undo = []
            self._tx_id = str(uuid.uuid4())
            wal = getattr(self.storage, "tx_begin", None)
            if callable(wal):
                wal(self._tx_id)
        elif stmt.op == "commit":
            if self._tx_undo is None:
                raise TransactionError("no open transaction")
            wal = getattr(self.storage, "tx_commit", None)
            if callable(wal):
                wal(self._tx_id)
            self._tx_undo = None
        elif stmt.op == "rollback":
            if self._tx_undo is None:
                raise TransactionError("no open transaction")
            self._apply_undos(self._tx_undo)
            wal = getattr(self.storage, "tx_rollback", None)
            if callable(wal):
                wal(self._tx_id)
            self._tx_undo = None
        return Result([], [])

    # thread-local views over _tx_state (see __init__ for why)
    @property
    def _tx_undo(self) -> Optional[list]:
        return getattr(self._tx_state, "undo", None)

    @_tx_undo.setter
    def _tx_undo(self, v: Optional[list]) -> None:
        self._tx_state.undo = v

    @property
    def _tx_implicit(self) -> bool:
        return getattr(self._tx_state, "implicit", False)

    @_tx_implicit.setter
    def _tx_implicit(self, v: bool) -> None:
        self._tx_state.implicit = v

    @property
    def _tx_id(self) -> Optional[str]:
        return getattr(self._tx_state, "txid", None)

    @_tx_id.setter
    def _tx_id(self, v: Optional[str]) -> None:
        self._tx_state.txid = v

    def _record_undo(self, fn: Callable[[], None]) -> None:
        if self._tx_undo is not None:
            self._tx_undo.append(fn)

    def _run_query_atomic(self, stmt: ast.Query, params: dict) -> Result:
        """Statement-level atomicity (ref: chaos_injection_test.go
        TestRollback_* — 'partial writes are rolled back on error,
        preventing data corruption from failed queries').

        Outside an explicit transaction, every statement runs in an
        implicit undo frame: if any clause fails mid-statement (undefined
        function in a later SET, type error after a CREATE...), the
        mutations already applied are undone in reverse order, so a failed
        statement leaves storage exactly as it found it. Inside an explicit
        transaction the open frame already accumulates undos, and
        BEGIN/ROLLBACK owns the decision.

        Memory: the frame holds one undo closure (and, for SET/DELETE, the
        pre-image copy) per mutation until the statement finishes — the
        price of atomicity, same as the reference's rollback tracking. For
        bulk imports, CALL { ... } IN TRANSACTIONS OF n ROWS both bounds
        this (committed batches drop their undos) and matches the tool the
        reference points bulk writers at."""
        if self._tx_undo is not None:
            return self._run_query(stmt, params)
        if not _is_write_query(stmt):
            return self._run_query(stmt, params)
        # single-writer while a frame is live: see _write_stmt_lock. An
        # explicit BEGIN..COMMIT still interleaves with other writers
        # between ITS statements (a session lock held across client round
        # trips would let an abandoned connection wedge every writer) —
        # same read-committed caveat as the reference's executor.
        with self._write_stmt_lock:
            self._tx_undo = []
            self._tx_implicit = True
            try:
                return self._run_query(stmt, params)
            except Exception:
                self._apply_undos(self._tx_undo)
                raise
            finally:
                self._tx_undo = None
                self._tx_implicit = False

    def _invalidate_cache_for_ddl(self) -> None:
        """Index/constraint DDL changes what reads can see (a fulltext CALL
        cached as empty before CREATE INDEX must not survive it), but DDL
        statements bypass the write-classified cache path — clear
        explicitly."""
        if self.cache is not None:
            self.cache.clear()
        # DDL moves planning decisions (index-backed anchors): drop every
        # cached columnar plan (counted as invalidations; the schema
        # generation stamp also catches DDL issued via another executor
        # sharing this SchemaManager)
        self.columnar.cache.clear()

    def _query_limits(self):
        """(limits, query_bucket) for this executor's database. LimitedEngine
        carries both; the default database's executor (main facade chain)
        consults the manager instead."""
        limits = getattr(self.storage, "limits", None)
        if limits is not None:
            return limits, getattr(self.storage, "query_bucket", None)
        db = self.db
        # lazily-created manager: only consult it if DDL ever instantiated
        # it, and only for executors on the default facade chain (per-DB
        # executors carry a LimitedEngine and returned above)
        if db is not None and getattr(db, "_dbmanager", None) is not None \
                and self.storage is getattr(db, "storage", None):
            return db._dbmanager.query_limit_state(db.default_database)
        return None, None

    def _apply_undos(self, undos: list) -> None:
        """Apply undo closures in reverse, with per-database rate limits
        suspended: a rollback must never itself be throttled, or the
        statement would be left half-unwound."""
        import contextlib as _ctx

        exempt = getattr(self.storage, "exempt_writes", None)
        cm = exempt() if callable(exempt) else _ctx.nullcontext()
        with cm:
            for undo in reversed(undos):
                try:
                    undo()
                except Exception:
                    # best effort: keep unwinding, but a failed undo step
                    # means a partially rolled-back tx — operators must
                    # be able to see it
                    _log.warning("tx rollback: undo step failed",
                                 exc_info=True)

    # -- DDL / admin ------------------------------------------------------------------
    def _create_index(self, stmt: ast.CreateIndex) -> Result:
        self.schema.create_index(
            stmt.name, stmt.kind, stmt.label, stmt.properties, stmt.options,
            stmt.if_not_exists,
        )
        if stmt.kind == "vector" and self.db is not None:
            registry = getattr(self.db, "vectorspaces", None)
            if registry is not None:
                from nornicdb_tpu_torch.vectorspace import VectorSpaceKey

                opts = stmt.options.get("indexConfig", stmt.options) or {}
                dims = int(opts.get("vector.dimensions", 0) or 0)
                sim = str(opts.get("vector.similarity_function", "cosine"))
                if dims:
                    registry.register(VectorSpaceKey(stmt.name, dims, sim.lower()))
        r = Result([], [])
        r.stats.indexes_added = 1
        return r

    def _show(self, stmt: ast.ShowCommand) -> Result:
        if stmt.what == "indexes":
            cols = ["name", "type", "labelsOrTypes", "properties", "options"]
            rows = [
                [i.name, i.kind, [i.label], i.properties, i.options]
                for i in self.schema.list_indexes()
            ]
            return Result(cols, rows)
        if stmt.what == "constraints":
            cols = ["name", "type", "labelsOrTypes", "properties"]
            rows = [
                [c.name, c.kind.upper(), [c.label], c.properties]
                for c in self.schema.list_constraints()
            ]
            return Result(cols, rows)
        if stmt.what == "databases":
            mgr = getattr(self.db, "database_manager", None) if self.db else None
            if mgr is not None:
                return Result(
                    ["name", "default"],
                    [[n, n == mgr.default_database] for n in mgr.list_databases()],
                )
            return Result(["name", "default"], [["neo4j", True]])
        if stmt.what == "procedures":
            return Result(["name"], [[p] for p in sorted(PROCEDURES)])
        if stmt.what == "functions":
            names = sorted(set(FUNCTIONS) | set(self._plugin_functions))
            return Result(["name"], [[f] for f in names])
        if stmt.what == "aliases":
            mgr = getattr(self.db, "database_manager", None) if self.db else None
            if mgr is not None:
                pairs = mgr.list_aliases()
                if stmt.target:
                    pairs = [(a, t) for a, t in pairs if t == stmt.target]
                return Result(["name", "database"],
                              [[a, t] for a, t in pairs])
            return Result(["name", "database"], [])
        if stmt.what == "limits":
            # columns per system_commands_test.go:511: a single "unlimited"
            # row when nothing is set, else one row per configured limit
            mgr = getattr(self.db, "database_manager", None) if self.db else None
            if mgr is None:
                raise CypherSyntaxError(
                    "multi-database commands require a DatabaseManager")
            from nornicdb_tpu_torch.multidb.manager import DatabaseLimits

            limits = mgr.get_limits(stmt.target)
            cols = ["database", "limit", "value", "description"]
            rows = [
                [stmt.target, f, getattr(limits, f),
                 f.replace("_", " ")]
                for f in DatabaseLimits.FIELD_NAMES if getattr(limits, f)
            ]
            if not rows:
                rows = [[stmt.target, "unlimited", None,
                         "no limits configured"]]
            return Result(cols, rows)
        raise CypherSyntaxError(f"unsupported SHOW {stmt.what}")

    def _database_command(self, stmt: ast.DatabaseCommand) -> Result:
        mgr = getattr(self.db, "database_manager", None) if self.db else None
        if mgr is None:
            raise CypherSyntaxError("multi-database commands require a DatabaseManager")
        if stmt.op == "create":
            mgr.create_database(stmt.name, if_not_exists=stmt.if_not_exists)
        elif stmt.op == "drop":
            mgr.drop_database(stmt.name, if_exists=stmt.if_exists)
            invalidate = getattr(self.db, "invalidate_database_cache", None)
            if callable(invalidate):
                invalidate(stmt.name)
        elif stmt.op == "create_alias":
            mgr.create_alias(stmt.name, stmt.options["target"])
        elif stmt.op == "drop_alias":
            try:
                mgr.drop_alias(stmt.name)
            except NotFoundError:
                if not stmt.if_exists:
                    raise
        elif stmt.op == "set_limits":
            # ALTER DATABASE name SET LIMIT k = v (ref:
            # system_commands_test.go:423-486): unknown keys must error,
            # existing limit values are preserved unless overridden
            from nornicdb_tpu_torch.multidb.manager import DatabaseLimits

            current = mgr.get_limits(stmt.name)
            updates = stmt.options["limits"]
            for key in updates:
                if key not in DatabaseLimits.FIELD_NAMES:
                    raise CypherSyntaxError(
                        f"unknown limit {key!r} (valid: "
                        f"{', '.join(DatabaseLimits.FIELD_NAMES)})"
                    )
            # the default database is served by the main facade chain, not
            # a LimitedEngine: write-side limits cannot be enforced there —
            # refuse rather than confirm-and-ignore (query-side limits ARE
            # enforced via the manager's query_limit_state)
            if mgr.resolve(stmt.name) == mgr.default_database:
                inert = {"max_nodes", "max_edges",
                         "max_writes_per_second"} & set(updates)
                if inert:
                    raise CypherSyntaxError(
                        f"limits {sorted(inert)} are not enforceable on the "
                        "default database; create a dedicated database for "
                        "write-side quotas"
                    )
            merged = {f: getattr(current, f) for f in DatabaseLimits.FIELD_NAMES}
            merged.update({
                k: (float(v) if k == "max_query_time" else int(v))
                for k, v in updates.items()
            })
            mgr.set_limits(stmt.name, DatabaseLimits(**merged))
        elif stmt.op == "create_composite":
            mgr.create_composite(stmt.name)
        elif stmt.op == "composite_add_alias":
            # ALTER COMPOSITE DATABASE c ADD ALIAS a FOR DATABASE t:
            # the alias becomes a constituent route into the composite
            alias = stmt.options["alias"]
            target = stmt.options["target"]
            if alias != target:
                try:
                    mgr.create_alias(alias, target)
                except AlreadyExistsError:
                    # tolerable only when the existing name already routes
                    # to the same target; a collision with a different
                    # database must surface, not half-apply
                    if mgr.resolve(alias) != target:
                        raise
            mgr.add_constituent(stmt.name, target)
        elif stmt.op == "composite_drop_alias":
            alias = stmt.options["alias"]
            target = mgr.resolve(alias)
            constituents = mgr._composites.get(stmt.name, [])
            # the resolved target must actually be a constituent — otherwise
            # remove_constituent would no-op while drop_alias still deleted
            # the global alias, half-applying the command
            if target not in constituents:
                raise NotFoundError(
                    f"alias {alias} not found in composite {stmt.name}"
                )
            mgr.remove_constituent(stmt.name, target)
            if target != alias:
                mgr.drop_alias(alias)
        else:
            raise CypherSyntaxError(f"unsupported database command {stmt.op}")
        return Result([], [])

    def _use_command(self, stmt: ast.UseCommand, params: dict) -> Result:
        if self.db is None or getattr(self.db, "database_manager", None) is None:
            raise CypherSyntaxError("USE requires a DatabaseManager")
        ex = self.db.executor_for(stmt.database)
        if stmt.query is None:
            return Result([], [])
        return ex.execute_statement(stmt.query, params)

    def _explain(self, q: ast.Query) -> str:
        lines = ["Query plan:"]
        for c in q.clauses:
            lines.append(f"  {type(c).__name__}")
        # per-operator engine report (columnar vs generic) + plan-cache
        # hit/miss for the columnar pipeline (docs/operations.md
        # "Columnar Cypher execution")
        try:
            lines.extend(self.columnar.explain_lines(q))
        except Exception:
            _log.debug("columnar explain failed", exc_info=True)
        return "\n".join(lines)


# ---------------------------------------------------------------- helpers
# single source of truth in ast.py, shared with has_updating_clause so the
# parse-time COLLECT gate and RBAC/cache classification can't diverge
_WRITE_CLAUSES = ast._UPDATING_CLAUSES


# functions whose results must never be served from the query cache
_NONDETERMINISTIC_FNS = {
    "rand", "randomuuid", "timestamp",
    "apoc.create.uuid", "apoc.text.random", "apoc.date.currenttimestamp",
    "apoc.coll.shuffle", "apoc.coll.randomitem",
    "apoc.util.sleep",  # side effect: caching it would skip the delay
}


def classify_query_text(query: str) -> str:
    """Permission class ("read" | "write") of a raw query string.
    Memoized for normal-sized texts: Bolt calls this on EVERY RUN under
    auth and the class of a fixed text never changes — but oversized
    texts bypass the cache, or a client could pin gigabytes of RAM by
    sending thousands of unique multi-megabyte queries as cache keys."""
    try:
        if len(query) > 4096:
            return _classify_query(query)
        return _classify_query_cached(query)
    except RecursionError:
        # pathologically nested expressions blow the AST walk — the
        # conservative class cannot leak privileges, and the executor
        # will reject the query on its own terms
        return "write"


@functools.lru_cache(maxsize=4096)
def _classify_query_cached(query: str) -> str:
    return _classify_query(query)


def _classify_query(query: str) -> str:
    """AST-based, shared by the HTTP tx API and Bolt RBAC gates: any CALL of a
    procedure ast.procedure_is_readonly rejects counts as a write (readonly
    prefixes minus MUTATING_PROCEDURE_EXCEPTIONS like gds.graph.project),
    so mutating procedures (CALL apoc.refactor.*, apoc.trigger.add, ...)
    can't slip past a keyword regex under a viewer token (ref: auth gating of
    /db/{db}/tx/commit, server_middleware.go). Unparseable input classifies
    as write — the executor rejects it anyway, and the conservative class
    cannot leak privileges.
    """
    try:
        stmt = parse(query)
    except Exception:
        # deliberate conservative class: unparseable input is treated as a
        # write (the executor will reject it anyway); log at debug so the
        # classification is traceable without flooding on bad clients
        _log.debug("unparseable query classified as write", exc_info=True)
        return "write"
    if isinstance(stmt, ast.Query):
        return "write" if _is_write_query(stmt) else "read"
    if isinstance(stmt, ast.UseCommand):
        if stmt.query is not None:
            return "write" if _is_write_query(stmt.query) else "read"
        return "read"
    if isinstance(stmt, ast.ShowCommand):
        return "read"
    # TxCommand (BEGIN/COMMIT/ROLLBACK) classifies as write: on the stateless
    # HTTP endpoint a viewer-opened BEGIN would pin the shared executor's tx
    # open forever (deferring WAL compaction unboundedly) and let a later
    # ROLLBACK wipe other users' writes. Bolt exempts tx keywords from this
    # gate (read-only explicit transactions stay allowed there, where the
    # session owns and cleans up its tx).
    return "write"  # TxCommand, index/constraint DDL, database commands


def _is_write_query(q: ast.Query) -> bool:
    for c in q.clauses:
        if isinstance(c, _WRITE_CLAUSES):
            return True
        if isinstance(c, ast.CallClause) and not ast.procedure_is_readonly(
            c.procedure
        ):
            return True  # index DDL procs / apoc.create / unknown may mutate
        if isinstance(c, ast.CallSubquery) and _is_write_query(c.query):
            return True
    # defense-in-depth: query-bearing expressions (COLLECT { }) are rejected
    # at parse time when they contain updating clauses, but classification
    # must not depend on that — an AST built another way still classifies
    # correctly for RBAC and cacheability.
    for node in _walk_exprs(q):
        if isinstance(node, ast.CollectSubquery) and _is_write_query(node.query):
            return True
    return any(_is_write_query(sub) for sub, _ in q.unions)


def _walk_exprs(q: ast.Query):
    """Yield every expression node reachable from the query's clauses."""

    def walk(e):
        if e is None:
            return
        yield e
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, list):
                for x in v:
                    if hasattr(x, "__dataclass_fields__"):
                        yield from walk(x)
            elif isinstance(v, dict):
                for x in v.values():
                    if hasattr(x, "__dataclass_fields__"):
                        yield from walk(x)
            elif hasattr(v, "__dataclass_fields__"):
                yield from walk(v)

    for c in q.clauses:
        yield from walk(c)
    for sub, _ in q.unions:
        yield from _walk_exprs(sub)


def _is_nondeterministic(q: ast.Query) -> bool:
    for node in _walk_exprs(q):
        if isinstance(node, ast.FunctionCall):
            name = node.name
            if name in _NONDETERMINISTIC_FNS or name.startswith("kalman."):
                return True
    return False


def _pattern_labels(p: ast.PatternPath) -> tuple[set[str], bool]:
    """(labels, fully_labeled): fully_labeled=False when any node pattern
    has no label (the read could match anything)."""
    labels: set[str] = set()
    fully = True
    for el in p.elements:
        if isinstance(el, ast.NodePattern):
            if el.labels:
                labels.update(el.labels)
            else:
                fully = False
    return labels, fully


def _read_cache_labels(q: ast.Query) -> set[str]:
    """Labels a cached read depends on. Returns the EMPTY set (= invalidated
    by every write) unless every dependency is label-scoped — pattern
    predicates and EXISTS/COUNT subqueries also force the unscoped bucket."""
    labels: set[str] = set()
    for c in q.clauses:
        pats = list(getattr(c, "patterns", []) or [])
        if isinstance(c, ast.MergeClause):
            pats.append(c.pattern)
        for p in pats:
            got, fully = _pattern_labels(p)
            if not fully:
                return set()
            labels.update(got)
        if isinstance(c, ast.CallClause):
            return set()  # procedure reads scan arbitrary data
        if isinstance(c, ast.CallSubquery):
            inner = _read_cache_labels(c.query)
            if not inner:
                return set()
            labels.update(inner)
    for node in _walk_exprs(q):
        if isinstance(
            node,
            (
                ast.PatternPredicate,
                ast.ExistsSubquery,
                ast.CountSubquery,
                ast.CollectSubquery,
            ),
        ):
            return set()
    for sub, _ in q.unions:
        inner = _read_cache_labels(sub)
        if not inner:
            return set()
        labels.update(inner)
    return labels


def _write_labels(q: ast.Query) -> set[str]:
    """Labels a write may affect — includes labels added/removed via
    SET/REMOVE/MERGE items. Empty set means 'unscoped: clear everything'."""
    labels: set[str] = set()
    unscoped = False
    for c in q.clauses:
        pats = list(getattr(c, "patterns", []) or [])
        if isinstance(c, ast.MergeClause):
            pats.append(c.pattern)
            for item in list(c.on_create) + list(c.on_match):
                labels.update(item.labels)
        for p in pats:
            got, fully = _pattern_labels(p)
            labels.update(got)
            if not fully and isinstance(c, (ast.CreateClause, ast.MergeClause)):
                unscoped = True
        if isinstance(c, (ast.SetClause, ast.RemoveClause)):
            for item in c.items:
                labels.update(item.labels)
        if isinstance(c, ast.ForeachClause):
            unscoped = True  # nested updates: play safe
        if isinstance(c, ast.CallClause) and not ast.procedure_is_readonly(
            c.procedure
        ):
            unscoped = True
        if isinstance(c, ast.CallSubquery):
            inner = _write_labels(c.query)
            if inner:
                labels.update(inner)
            elif _is_write_query(c.query):
                unscoped = True
    for sub, _ in q.unions:
        inner = _write_labels(sub)
        if inner:
            labels.update(inner)
        elif _is_write_query(sub):
            unscoped = True
    return set() if unscoped else labels


class _SortKey:
    """Comparable wrapper: mixed-type tolerant, nulls sort last (asc),
    honours per-key DESC. Used only for mixed-type sort passes — see
    _multisort."""

    __slots__ = ("v", "desc")

    def __init__(self, v, desc: bool):
        self.v = v
        self.desc = desc

    def _cmp(self, other) -> int:
        a, b = self.v, other.v
        if a is None and b is None:
            return 0
        if a is None:
            return 1  # nulls last in ascending
        if b is None:
            return -1
        if isinstance(a, (Node, Edge)):
            a = a.id
        if isinstance(b, (Node, Edge)):
            b = b.id
        try:
            if a == b:
                return 0
            return -1 if a < b else 1
        except TypeError:
            ta, tb = type(a).__name__, type(b).__name__
            if ta != tb:
                return -1 if ta < tb else 1
            sa, sb = str(a), str(b)
            return 0 if sa == sb else (-1 if sa < sb else 1)

    def __lt__(self, other) -> bool:
        c = self._cmp(other)
        return c > 0 if self.desc else c < 0

    def __eq__(self, other) -> bool:
        return self._cmp(other) == 0


_IMMUTABLE_SCALARS = (str, int, float, bool, bytes, type(None))


def _deep_copy_json(v):
    """Recursive copy for query-result value trees. copy.deepcopy's memo
    machinery costs ~27x more per tiny container (measured 4.3us vs 0.16us
    for a 4-element list) and dominated the cached-serve cost (154us of a
    187us cached read). Result values are trees — property data is
    JSON-able and Cypher values nest finitely — so no cycle memo is needed.
    Every mutable type a result can legally carry is handled explicitly
    (ndarray/tuple/set included — aliasing any of them would let a caller
    poison the cache); anything unrecognized falls back to deepcopy rather
    than alias."""
    if isinstance(v, _IMMUTABLE_SCALARS):
        return v
    if isinstance(v, list):
        return [_deep_copy_json(x) for x in v]
    if isinstance(v, dict):
        return {k: _deep_copy_json(x) for k, x in v.items()}
    if isinstance(v, (Node, Edge)):
        return _copy_cached_value(v)
    if isinstance(v, tuple):
        return tuple(_deep_copy_json(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, set):
        return {_deep_copy_json(x) for x in v}
    if isinstance(v, frozenset):
        return v
    return copy.deepcopy(v)


def _copy_cached_value(v):
    """Deep enough that no mutable state is shared with the cache: entity
    copies get their property VALUES copied too (Node.copy is shallow on
    values), and every other row value routes through the typed tree copy —
    including tuples/ndarrays/sets at the top level."""
    if isinstance(v, (Node, Edge)):
        c = v.copy()
        c.properties = {
            k: (x if isinstance(x, _IMMUTABLE_SCALARS)
                else _deep_copy_json(x))
            for k, x in c.properties.items()
        }
        return c
    return _deep_copy_json(v)


def _copy_result(r: "Result") -> "Result":
    """Structural copy deep enough that mutating the returned rows, a
    returned node/edge's properties, or a collected list cannot reach the
    cached object."""
    return Result(
        list(r.columns),
        [[_copy_cached_value(v) for v in row] for row in r.rows],
        dataclasses.replace(r.stats),  # Stats is mutable too
        r.plan,
    )


def _multisort(keyed: list, descs: list) -> list:
    """Stable multi-key sort of (keys, payload) pairs: one stable pass per
    key, last key first (stability composes them). A pass whose non-null
    values are all-numeric or all-string sorts natively; only
    mixed-type/entity passes pay for the _SortKey comparison wrapper.
    Null is the largest value: last in ASC, first in DESC (Neo4j order)."""
    for ki in range(len(descs) - 1, -1, -1):
        desc = descs[ki]
        nonnull = [t for t in keyed if t[0][ki] is not None]
        vals = [t[0][ki] for t in nonnull]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals) or all(isinstance(v, str) for v in vals):
            nulls = [t for t in keyed if t[0][ki] is None]
            nonnull.sort(key=lambda t, ki=ki: t[0][ki], reverse=desc)
            keyed = (nulls + nonnull) if desc else (nonnull + nulls)
        else:
            keyed.sort(key=lambda t, ki=ki, desc=desc: _SortKey(t[0][ki], desc))
    return [payload for _, payload in keyed]


def _pattern_variables(pattern: ast.PatternPath) -> list[str]:
    out = []
    if pattern.name:
        out.append(pattern.name)
    for el in pattern.elements:
        v = getattr(el, "variable", None)
        if v:
            out.append(v)
    return out


def _contains_aggregate(e: ast.Expr) -> bool:
    if isinstance(e, ast.FunctionCall):
        if is_aggregate(e.name):
            return True
        return any(_contains_aggregate(a) for a in e.args)
    if isinstance(e, ast.BinaryOp):
        return _contains_aggregate(e.left) or _contains_aggregate(e.right)
    if isinstance(e, ast.UnaryOp):
        return _contains_aggregate(e.operand)
    if isinstance(e, ast.Property):
        return _contains_aggregate(e.subject)
    return False


def _and_exprs(
    a: Optional[ast.Expr], b: Optional[ast.Expr]
) -> Optional[ast.Expr]:
    if a is None:
        return b
    if b is None:
        return a
    return ast.BinaryOp("AND", a, b)


def _hashable(vals: Iterable[Any]) -> Any:
    out = []
    for v in vals:
        if isinstance(v, (Node, Edge)):
            out.append(("__ent__", v.id))
        elif isinstance(v, list):
            out.append(_hashable(v))
        elif isinstance(v, dict):
            out.append(tuple(sorted((k, _hashable([x])) for k, x in v.items())))
        elif isinstance(v, np.ndarray):
            out.append(v.tobytes())
        else:
            out.append(v)
    return tuple(out)


def _to_storable(v: Any) -> Any:
    if isinstance(v, (Node, Edge)):
        raise CypherTypeError("cannot store an entity as a property")
    return v


def _binary_value(op: str, a: Any, b: Any) -> Any:
    from nornicdb_tpu_torch.cypher.expr import _binary  # reuse via tiny shim

    e = ast.BinaryOp(op, ast.Literal(a), ast.Literal(b))
    return _binary(e, EvalContext({}, {}, None))


# ---------------------------------------------------------------- procedures
@procedure("db.labels")
def proc_labels(ex: CypherExecutor, args, row):
    labels = sorted({l for n in ex.storage.all_nodes() for l in n.labels})
    return ["label"], [[l] for l in labels]


@procedure("db.relationshiptypes")
def proc_rel_types(ex: CypherExecutor, args, row):
    types = sorted({e.type for e in ex.storage.all_edges()})
    return ["relationshipType"], [[t] for t in types]


@procedure("db.propertykeys")
def proc_prop_keys(ex: CypherExecutor, args, row):
    keys: set[str] = set()
    for n in ex.storage.all_nodes():
        keys.update(n.properties.keys())
    for e in ex.storage.all_edges():
        keys.update(e.properties.keys())
    return ["propertyKey"], [[k] for k in sorted(keys)]


@procedure("dbms.components")
def proc_components(ex: CypherExecutor, args, row):
    from nornicdb_tpu_torch import __version__

    return (
        ["name", "versions", "edition"],
        [["NornicDB-TPU", [__version__], "tpu"]],
    )


@procedure("db.index.vector.querynodes")
def proc_vector_query(ex: CypherExecutor, args, row):
    """(ref: call_vector.go:35 — accepts a vector OR a string; strings are
    auto-embedded server-side)."""
    if len(args) < 3:
        raise CypherSyntaxError(
            "db.index.vector.queryNodes(indexName, k, vectorOrText)"
        )
    index_name, k, query = args[0], int(args[1]), args[2]
    if isinstance(query, str):
        embedder = getattr(ex.db, "embedder", None) if ex.db else None
        if embedder is None:
            raise CypherTypeError(
                "string query requires an embedder (SetEmbedder)"
            )
        query = embedder.embed(query)
    vec = np.asarray(query, np.float32)
    svc = ex.db.search if ex.db is not None else None
    if svc is None:
        raise CypherTypeError("vector search requires the DB search service")
    hits = svc.vector_candidates(vec, k=k)
    out = []
    for nid, score in hits:
        node = ex.get_node_or_none(nid)
        if node is not None:
            out.append([node, float(score)])
    return ["node", "score"], out


# built-in fulltext index names that work without explicit creation
# (ref: neo4j_compat_test.go:265 — 'node_search' and 'default' must answer
# on a bare store, Mimir compatibility)
_BUILTIN_FULLTEXT = ("node_search", "default")


@procedure("db.index.fulltext.querynodes")
def proc_fulltext_query(ex: CypherExecutor, args, row):
    """(ref: call_fulltext.go; builtin-index contract
    neo4j_compat_test.go:243 — unknown index errors immediately, built-in
    names answer with BM25 over node text even without the DB facade)."""
    if len(args) < 2:
        raise CypherSyntaxError("db.index.fulltext.queryNodes(indexName, query)")
    index_name = str(args[0])
    query = str(args[1])
    limit = int(args[2]) if len(args) > 2 else 10
    svc = ex.db.search if ex.db is not None else None
    if svc is not None:
        hits = svc._bm25.search(query, limit)
    else:
        known = index_name in _BUILTIN_FULLTEXT or any(
            i.name == index_name and i.kind == "fulltext"
            for i in ex.schema.list_indexes()
        )
        if not known:
            raise CypherTypeError(
                f"there is no such fulltext schema index: {index_name}"
            )
        from nornicdb_tpu_torch.search.bm25 import BM25Index

        idx = BM25Index()
        for n in ex.storage.all_nodes():
            text = " ".join(
                str(v) for v in n.properties.values() if isinstance(v, str)
            )
            if text:
                idx.index(n.id, text)
        hits = idx.search(query, limit)
    out = []
    for nid, score in hits:
        node = ex.get_node_or_none(nid)
        if node is not None:
            out.append([node, float(score)])
    return ["node", "score"], out


@procedure("db.index.vector.createnodeindex")
def proc_vector_create(ex: CypherExecutor, args, row):
    # legacy creation form (name, label, prop, dims, similarity)
    name, label, prop = str(args[0]), str(args[1]), str(args[2])
    dims = int(args[3]) if len(args) > 3 else 0
    sim = str(args[4]) if len(args) > 4 else "cosine"
    ex.schema.create_index(
        name, "vector", label, [prop],
        {"vector.dimensions": dims, "vector.similarity_function": sim},
        if_not_exists=True,
    )
    return [], []


@procedure("db.index.vector.createrelationshipindex")
def proc_vector_create_rel(ex: CypherExecutor, args, row):
    """db.index.vector.createRelationshipIndex(name, relType, prop, dims,
    similarity) — relationship vectors live in an edge property (ref:
    vector_procedures_test.go:719: edges carry {features: [...]})."""
    name, rel_type, prop = str(args[0]), str(args[1]), str(args[2])
    dims = int(args[3]) if len(args) > 3 else 0
    sim = str(args[4]) if len(args) > 4 else "cosine"
    ex.schema.create_index(
        name, "vector-rel", rel_type, [prop],
        {"vector.dimensions": dims, "vector.similarity_function": sim},
        if_not_exists=True,
    )
    return [], []


@procedure("db.index.vector.queryrelationships")
def proc_vector_query_rels(ex: CypherExecutor, args, row):
    """db.index.vector.queryRelationships(indexName, k, vectorOrText)
    YIELD relationship, score. Unknown index -> empty result with the
    right columns (ref: vector_procedures_test.go:782-787)."""
    if len(args) < 3:
        raise CypherSyntaxError(
            "db.index.vector.queryRelationships(indexName, k, vectorOrText)"
        )
    index_name, k, query = str(args[0]), int(args[1]), args[2]
    idx = next(
        (i for i in ex.schema.list_indexes()
         if i.name == index_name and i.kind == "vector-rel"),
        None,
    )
    if idx is None:
        return ["relationship", "score"], []
    if isinstance(query, str):
        embedder = getattr(ex.db, "embedder", None) if ex.db else None
        if embedder is None:
            raise CypherTypeError(
                "string query requires an embedder (SetEmbedder)"
            )
        query = embedder.embed(query)
    q = np.asarray(query, np.float32)
    qn = float(np.linalg.norm(q)) or 1.0
    prop = idx.properties[0]
    sim = str(idx.options.get("vector.similarity_function", "cosine")).lower()
    scored = []
    for e in ex.storage.get_edges_by_type(idx.label):
        vec = e.properties.get(prop)
        if not isinstance(vec, (list, tuple)) or not vec:
            continue
        v = np.asarray(vec, np.float32)
        if v.shape != q.shape:
            continue
        if sim == "euclidean":
            # Neo4j's euclidean score: 1 / (1 + d^2) — higher is closer
            d2 = float(np.sum((q - v) ** 2))
            score = 1.0 / (1.0 + d2)
        else:
            vn = float(np.linalg.norm(v)) or 1.0
            score = float(np.dot(q, v) / (qn * vn))
        scored.append((score, e))
    scored.sort(key=lambda t: -t[0])
    return ["relationship", "score"], [[e, s] for s, e in scored[:k]]


@procedure("db.index.vector.drop")
def proc_vector_drop(ex: CypherExecutor, args, row):
    ex.schema.drop_index(str(args[0]) if args else "", if_exists=True)
    return [], []


@procedure("db.awaitindexes")
def proc_await_indexes(ex: CypherExecutor, args, row):
    return [], []


@procedure("db.indexes")
def proc_db_indexes(ex: CypherExecutor, args, row):
    """Legacy listing (ref: clauses_test.go CALL db.indexes())."""
    return (["name", "type", "labelsOrTypes", "properties"],
            [[i.name, i.kind, [i.label], i.properties]
             for i in ex.schema.list_indexes()])


@procedure("dbms.functions")
def proc_dbms_functions(ex: CypherExecutor, args, row):
    names = sorted(set(FUNCTIONS) | set(ex._plugin_functions))
    return ["name"], [[n] for n in names]


@procedure("nornicdb.decay.info")
def proc_decay_info(ex: CypherExecutor, args, row):
    """(ref: clauses_test.go:427 — one row describing the decay config)"""
    decay = getattr(ex.db, "decay", None) if ex.db else None
    cfg = getattr(decay, "config", None)
    return (["enabled", "halfLifeDays", "floor"],
            [[decay is not None,
              getattr(cfg, "half_life_days", 30.0),
              getattr(cfg, "floor", 0.1)]])


@procedure("db.schema.nodeproperties")
def proc_schema_node_properties(ex: CypherExecutor, args, row):
    """(ref: clauses_test.go:468) nodeLabels + propertyName + types."""
    seen: dict[tuple, set] = {}
    for n in ex.storage.all_nodes():
        for k, v in n.properties.items():
            seen.setdefault((tuple(sorted(n.labels)), k), set()).add(
                type(v).__name__)
    return (["nodeLabels", "propertyName", "propertyTypes"],
            [[list(labels), key, sorted(types)]
             for (labels, key), types in sorted(seen.items())])


@procedure("db.constraints")
def proc_db_constraints(ex: CypherExecutor, args, row):
    """Legacy listing (ref: db_procedures_test.go CALL db.constraints())."""
    return (["name", "type", "labelsOrTypes", "properties"],
            [[c.name, c.kind.upper(), [c.label], c.properties]
             for c in ex.schema.list_constraints()])


@procedure("db.stats.retrieveallanthestats")
def proc_db_stats_retrieve(ex: CypherExecutor, args, row):
    """(sic — the reference registers this exact name,
    db_procedures_test.go: db.stats.retrieveAllAnTheStats)"""
    return (["section", "data"],
            [["GRAPH COUNTS", {
                "nodes": ex.storage.node_count(),
                "relationships": ex.storage.edge_count(),
            }]])


@procedure("gds.version")
def proc_gds_version(ex: CypherExecutor, args, row):
    return ["version"], [["2.5.0-nornicdb-tpu"]]


@procedure("nornicdb.version")
def proc_nornic_version(ex: CypherExecutor, args, row):
    """(ref: apoc_integration_test.go:32)"""
    return ["version", "edition"], [["0.4.0", "tpu"]]


@procedure("nornicdb.stats")
def proc_nornic_stats(ex: CypherExecutor, args, row):
    return (["nodes", "relationships", "labels"],
            [[ex.storage.node_count(), ex.storage.edge_count(),
              sorted({l for n in ex.storage.all_nodes()
                      for l in n.labels})]])


@procedure("db.create.setnodevectorproperty")
def proc_set_node_vector(ex: CypherExecutor, args, row):
    """db.create.setNodeVectorProperty(nodeIdOrNode, prop, vector)
    (ref: vector_procedures_test.go:184)."""
    if len(args) < 3:
        raise CypherSyntaxError(
            "db.create.setNodeVectorProperty(node, key, vector)")
    target, prop, vec = args[0], str(args[1]), args[2]
    node = target if isinstance(target, Node) else ex.storage.get_node(str(target))
    old = node.copy()  # pre-image BEFORE the mutation, like every undo site
    node.properties[prop] = [float(v) for v in (vec or [])]
    ex.storage.update_node(node)
    ex._record_undo(lambda o=old: ex.storage.update_node(o))
    return ["node"], [[node]]


@procedure("db.create.setrelationshipvectorproperty")
def proc_set_rel_vector(ex: CypherExecutor, args, row):
    if len(args) < 3:
        raise CypherSyntaxError(
            "db.create.setRelationshipVectorProperty(rel, key, vector)")
    target, prop, vec = args[0], str(args[1]), args[2]
    edge = target if isinstance(target, Edge) else ex.storage.get_edge(str(target))
    old = edge.copy()
    edge.properties[prop] = [float(v) for v in (vec or [])]
    ex.storage.update_edge(edge)
    ex._record_undo(lambda o=old: ex.storage.update_edge(o))
    return ["relationship"], [[edge]]


@procedure("db.index.fulltext.createrelationshipindex")
def proc_fulltext_create_rel(ex: CypherExecutor, args, row):
    """db.index.fulltext.createRelationshipIndex(name, relType, prop)."""
    name, rel_type = str(args[0]), str(args[1])
    props = [str(p) for p in args[2:]] or ["text"]
    ex.schema.create_index(name, "fulltext-rel", rel_type, props, {},
                           if_not_exists=True)
    return [], []


@procedure("db.index.fulltext.queryrelationships")
def proc_fulltext_query_rels(ex: CypherExecutor, args, row):
    """YIELD relationship, score: BM25-free substring/token scoring over
    the indexed edge properties (parity shape; unknown index -> empty)."""
    if len(args) < 2:
        raise CypherSyntaxError(
            "db.index.fulltext.queryRelationships(indexName, query)")
    index_name, query = str(args[0]), str(args[1]).lower()
    idx = next(
        (i for i in ex.schema.list_indexes()
         if i.name == index_name and i.kind == "fulltext-rel"),
        None,
    )
    if idx is None:
        return ["relationship", "score"], []
    terms = query.split()
    out = []
    for e in ex.storage.get_edges_by_type(idx.label):
        text = " ".join(
            str(e.properties.get(p, "")) for p in idx.properties
        ).lower()
        hits = sum(1 for t in terms if t in text)
        if hits:
            out.append([e, hits / max(len(terms), 1)])
    out.sort(key=lambda r: -r[1])
    return ["relationship", "score"], out


@procedure("db.awaitindex")
def proc_await_index2(ex: CypherExecutor, args, row):
    """db.awaitIndex(name[, timeoutSeconds]) yields status — indexes are
    maintained synchronously, and the reference tolerates unknown names
    (db_procedures_test.go:126 awaits 'my_index' on an empty store)."""
    return ["status"], [["online"]]


@procedure("db.resampleindex")
def proc_resample_index(ex: CypherExecutor, args, row):
    """db.resampleIndex(name) — statistics resampling is a no-op (no
    cost-based planner statistics in this engine)."""
    return [], []


@procedure("db.resampleoutdatedindexes")
def proc_resample_outdated(ex: CypherExecutor, args, row):
    return [], []


@procedure("db.ping")
def proc_ping(ex: CypherExecutor, args, row):
    return ["success"], [[True]]


@procedure("db.info")
def proc_db_info(ex: CypherExecutor, args, row):
    import time as _time

    return (
        ["id", "name", "creationDate", "nodeCount", "edgeCount"],
        [[
            "nornicdb-tpu", "neo4j",
            _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime()),
            ex.storage.node_count(), ex.storage.edge_count(),
        ]],
    )


@procedure("db.clearquerycaches")
def proc_clear_query_caches(ex: CypherExecutor, args, row):
    if ex.cache is not None:
        ex.cache.clear()
    return ["value"], [["Query caches cleared"]]


# db.stats.* query-statistics collection (ref: the reference's db.stats
# surface; stats here are the executor's own counters)
@procedure("db.stats.collect")
def proc_stats_collect(ex: CypherExecutor, args, row):
    ex._stats_collecting = True
    return ["section", "success", "message"], [
        [str(args[0]) if args else "QUERIES", True, "collection started"]
    ]


@procedure("db.stats.stop")
def proc_stats_stop(ex: CypherExecutor, args, row):
    ex._stats_collecting = False
    return ["section", "success", "message"], [
        [str(args[0]) if args else "QUERIES", True, "collection stopped"]
    ]


@procedure("db.stats.status")
def proc_stats_status(ex: CypherExecutor, args, row):
    collecting = bool(getattr(ex, "_stats_collecting", False))
    return ["section", "status"], [
        ["QUERIES", "collecting" if collecting else "idle"]
    ]


@procedure("db.stats.retrieve")
def proc_stats_retrieve(ex: CypherExecutor, args, row):
    section = str(args[0]) if args else "QUERIES"
    return ["section", "data"], [
        [section, {"queryCount": ex.query_count}]
    ]


@procedure("db.stats.clear")
def proc_stats_clear(ex: CypherExecutor, args, row):
    return ["section", "success"], [["QUERIES", True]]


@procedure("dbms.info")
def proc_dbms_info(ex: CypherExecutor, args, row):
    from nornicdb_tpu_torch import __version__

    return (
        ["id", "name", "creationDate"],
        [["nornicdb-tpu", "DBMS", __version__]],
    )


@procedure("dbms.listconfig")
def proc_dbms_list_config(ex: CypherExecutor, args, row):
    cfg = getattr(ex.db, "config", None) if ex.db else None
    rows = []
    if cfg is not None:
        for k, v in sorted(vars(cfg).items()):
            if isinstance(v, (str, int, float, bool)) or v is None:
                rows.append([k, str(v)])
    return ["name", "value"], rows


@procedure("dbms.clientconfig")
def proc_dbms_client_config(ex: CypherExecutor, args, row):
    return ["name", "value"], []


@procedure("dbms.listconnections")
def proc_dbms_list_connections(ex: CypherExecutor, args, row):
    return (
        ["connectionId", "connectTime", "connector", "username"],
        [],
    )


@procedure("dbms.procedures")
def proc_dbms_procedures(ex: CypherExecutor, args, row):
    return (
        ["name", "signature"],
        [[name, f"{name}(...)"] for name in sorted(PROCEDURES)],
    )


@procedure("tx.setmetadata")
def proc_tx_set_metadata(ex: CypherExecutor, args, row):
    """tx.setMetaData(map) — attaches metadata to the current transaction
    (surfaced through dbms.listConnections in the reference; stored on
    the executor here)."""
    ex._tx_metadata = args[0] if args and isinstance(args[0], dict) else {}
    return [], []


@procedure("db.index.fulltext.createnodeindex")
def proc_fulltext_create(ex: CypherExecutor, args, row):
    """db.index.fulltext.createNodeIndex(name, labelsOrLabel, propsOrProp)
    — legacy creation form (ref: call_fulltext.go)."""
    name = str(args[0]) if args else ""
    labels = args[1] if len(args) > 1 else []
    props = args[2] if len(args) > 2 else []
    if isinstance(labels, str):
        labels = [labels]
    if isinstance(props, str):
        props = [props]
    ex.schema.create_index(
        name, "fulltext", str(labels[0]) if labels else "",
        [str(p) for p in props], {}, if_not_exists=True,
    )
    return [], []


@procedure("db.index.fulltext.drop")
def proc_fulltext_drop(ex: CypherExecutor, args, row):
    name = str(args[0]) if args else ""
    ex.schema.drop_index(name, if_exists=True)
    return [], []


@procedure("db.index.fulltext.listavailableanalyzers")
def proc_fulltext_analyzers(ex: CypherExecutor, args, row):
    return (
        ["analyzer", "description"],
        [["standard", "BM25 tokenizer (lowercase, word boundaries)"]],
    )
