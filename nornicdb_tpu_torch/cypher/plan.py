"""Shape-keyed Cypher plan cache for the columnar operator pipeline.

A query's *shape* is its AST with every inline literal lifted out into a
positional pseudo-parameter (``§0``, ``§1``, ... — ``§`` cannot appear in
a real ``$param`` identifier, so user params can never collide), so
``MATCH (n:P) WHERE n.age > 5`` and ``... > 6`` share one compiled plan
and differ only in the literal vector merged into the execution params.
``count(*)``'s ``Literal("*")`` sentinel is deliberately NOT lifted: it is
shape, not data (the executor's aggregate detectors dispatch on it).

Two cache levels, both bounded:

* **text** — exact query text -> (shape key, literal vector, canonical
  AST).  A hit skips parse, validation, classification, shape
  normalization AND planning: the repeat-traffic fast path the bench's
  ``zero fresh compiles`` invariant asserts.
* **shape** — shape key -> compiled plan (or an ``unsupported`` marker so
  unplannable shapes don't pay re-planning either).

Invalidation semantics (docs/operations.md "Columnar Cypher execution"):
plans capture **no data references** — every execution re-binds to the
current adjacency-snapshot generation (``csr_view``) and colindex column
state, so data churn never serves stale topology.  What a plan *does*
capture are planning-time decisions (index-backed anchor strategy), so
entries are stamped with the schema generation and dropped — counted in
``nornicdb_cypher_plan_cache_invalidations_total`` — when DDL moves it;
executor-level DDL handling also clears the cache outright.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Any, Optional

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

__all__ = [
    "PlanCache", "TextEntry", "ShapeEntry", "normalize_query", "key_hash",
]

# ------------------------------------------------------------------ metrics
# Registered at import (server/http.py imports this module) so the tested
# docs/observability.md catalog renders in every serving process; label
# cells are resolved eagerly for the same reason.
PC_HITS = _REGISTRY.counter(
    "nornicdb_cypher_plan_cache_hits_total",
    "Cypher plan-cache hits (text-exact or shape-level)")
PC_MISSES = _REGISTRY.counter(
    "nornicdb_cypher_plan_cache_misses_total",
    "Cypher plan-cache misses (a fresh shape normalization + plan compile)")
PC_INVALIDATIONS = _REGISTRY.counter(
    "nornicdb_cypher_plan_cache_invalidations_total",
    "Cached plans dropped by DDL / schema-generation movement")
ROWS_HIST = _REGISTRY.histogram(
    "nornicdb_cypher_columnar_rows",
    "Peak binding-table rows per columnar-executed query")
OP_HIST = _REGISTRY.histogram(
    "nornicdb_cypher_operator_seconds",
    "Columnar operator latency by operator kind",
    labels=("op",))
OP_CELLS = {op: OP_HIST.labels(op)
            for op in ("scan", "filter", "expand", "join", "varlen",
                       "aggregate", "project", "sort", "vector_topk",
                       "fallback")}
Q_TOTAL = _REGISTRY.counter(
    "nornicdb_cypher_columnar_queries_total",
    "Columnar pipeline outcomes per attempted query",
    labels=("outcome",))
Q_CELLS = {o: Q_TOTAL.labels(o)
           for o in ("full", "fallback", "bail", "unsupported")}
OFFLOADS = _REGISTRY.counter(
    "nornicdb_cypher_offloads_total",
    "Device top-k offload attempts on scoring-heavy sort plans",
    labels=("outcome",))
OFFLOAD_CELLS = {o: OFFLOADS.labels(o) for o in ("used", "unavailable")}


def key_hash(key: str) -> str:
    """Short stable digest of a shape key for slowlog / EXPLAIN output."""
    return hashlib.sha1(key.encode()).hexdigest()[:12]


# ------------------------------------------------------- shape normalization
def _lift(node: Any, lits: list) -> Any:
    """Rebuild an AST subtree with literals lifted into ``lits``.  The
    memoized parse tree is shared across threads — this NEVER mutates it."""
    if isinstance(node, ast.Literal):
        if node.value == "*":
            return node  # count(*) sentinel: shape, not data
        i = len(lits)
        lits.append(node.value)
        return ast.Parameter(f"§{i}")
    if isinstance(node, ast.ReturnItem):
        # column names derive from the ORIGINAL expression text when no
        # alias was written — pin them before the literals disappear
        alias = node.alias or ast.expr_text(node.expr)
        return ast.ReturnItem(_lift(node.expr, lits), alias)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        kwargs = {
            f.name: _lift(getattr(node, f.name), lits)
            for f in dataclasses.fields(node)
        }
        return type(node)(**kwargs)
    if isinstance(node, list):
        return [_lift(x, lits) for x in node]
    if isinstance(node, tuple):
        return tuple(_lift(x, lits) for x in node)
    if isinstance(node, dict):
        return {k: _lift(v, lits) for k, v in node.items()}
    return node


def normalize_query(q: ast.Query) -> Optional[tuple[str, ast.Query, list]]:
    """(shape_key, canonical_query, literal_vector) — or None when the
    tree is too deep to walk (pathological input; planning is skipped and
    the generic engine rejects or serves it on its own terms)."""
    try:
        lits: list = []
        canon = _lift(q, lits)
        return repr(canon), canon, lits
    except RecursionError:
        return None


def merge_lits(params: dict, lits: list) -> dict:
    if not lits:
        return params
    merged = dict(params)
    for i, v in enumerate(lits):
        merged[f"§{i}"] = v
    return merged


# ------------------------------------------------------------------- cache
@dataclasses.dataclass
class ShapeEntry:
    key: str
    plan: Any            # CompiledPlan, or None = shape is unsupported
    schema_gen: int
    reason: str = ""     # why unsupported (EXPLAIN / tests)


@dataclasses.dataclass
class TextEntry:
    key: str
    canon: ast.Query
    lits: list
    plan: Any
    schema_gen: int
    cacheable: bool      # result-cache eligibility (deterministic read)
    labels: frozenset    # result-cache invalidation label set


class PlanCache:
    """Bounded two-level plan cache; thread-safe, per-executor."""

    def __init__(self, schema, capacity: Optional[int] = None):
        self.schema = schema
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "NORNICDB_CYPHER_PLAN_CACHE", "256"))
            except ValueError:
                capacity = 256
        self.capacity = max(capacity, 8)
        self._lock = threading.Lock()
        self._shapes: "OrderedDict[str, ShapeEntry]" = OrderedDict()
        self._texts: "OrderedDict[str, TextEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.invalidations = 0

    # -- generation ---------------------------------------------------------
    def _schema_gen(self) -> int:
        return getattr(self.schema, "generation", 0)

    # -- text level ---------------------------------------------------------
    def text_probe(self, text: str) -> Optional[TextEntry]:
        """Exact-text hit: everything needed to execute without parse or
        plan.  Stale schema generation drops the entry (and its shape)."""
        with self._lock:
            e = self._texts.get(text)
            if e is None:
                return None
            if e.schema_gen != self._schema_gen():
                self._texts.pop(text, None)
                self._drop_shape_locked(e.key)
                return None
            self._texts.move_to_end(text)
            self.hits += 1
        PC_HITS.inc()
        return e

    def bind_text(self, text: str, key: str, canon: ast.Query, lits: list,
                  plan: Any, cacheable: bool, labels: frozenset) -> None:
        with self._lock:
            if text in self._texts:
                return
            self._texts[text] = TextEntry(
                key=key, canon=canon, lits=lits, plan=plan,
                schema_gen=self._schema_gen(), cacheable=cacheable,
                labels=labels)
            while len(self._texts) > self.capacity:
                self._texts.popitem(last=False)

    # -- shape level --------------------------------------------------------
    def _drop_shape_locked(self, key: str) -> None:
        if self._shapes.pop(key, None) is not None:
            self.invalidations += 1
            PC_INVALIDATIONS.inc()

    def shape_lookup(self, key: str) -> Optional[ShapeEntry]:
        with self._lock:
            e = self._shapes.get(key)
            if e is None:
                return None
            if e.schema_gen != self._schema_gen():
                self._drop_shape_locked(key)
                return None
            self._shapes.move_to_end(key)
            self.hits += 1
        PC_HITS.inc()
        return e

    def shape_store(self, key: str, plan: Any, reason: str = "") -> ShapeEntry:
        e = ShapeEntry(key=key, plan=plan, schema_gen=self._schema_gen(),
                       reason=reason)
        with self._lock:
            self._shapes[key] = e
            while len(self._shapes) > self.capacity:
                self._shapes.popitem(last=False)
            self.misses += 1
            if plan is not None:
                self.compiles += 1
        PC_MISSES.inc()
        return e

    # -- maintenance --------------------------------------------------------
    def clear(self, count_invalidations: bool = True) -> None:
        """Drop everything (DDL path: index/constraint changes move
        planning decisions, so every cached plan is suspect)."""
        with self._lock:
            dropped = len(self._shapes)
            self._shapes.clear()
            self._texts.clear()
            if count_invalidations and dropped:
                self.invalidations += dropped
                PC_INVALIDATIONS.inc(dropped)

    def stats_snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._shapes),
                "text_entries": len(self._texts),
                "hits": self.hits,
                "misses": self.misses,
                "compiles": self.compiles,
                "invalidations": self.invalidations,
                "capacity": self.capacity,
            }
