"""Scan parallelism + columnar WHERE compilation for large MATCH scans.

Behavioral reference: pkg/cypher/parallel.go:41-515 — ParallelConfig
(Enabled / MaxWorkers / MinBatchSize, default min batch 1000),
parallelFilterNodes/parallelCount/parallelSum/parallelCollect/parallelMap —
and the fastpath family in query_patterns.go.

Design note (host-native rather than a goroutine translation): the
reference gets scan speedups from goroutines across cores. Under CPython
the same shape only helps when workers release the GIL or spare cores run
other work, so the chunked thread-pool layer here is paired with what
actually makes single-interpreter scans fast: compiling the WHERE tree into
*columnar* mask evaluation — one property-column extraction pass, tight
per-leaf loops reusing the exact `_eq`/`_compare` three-valued semantics of
the row evaluator, numpy boolean combination — instead of a full AST walk
per row. Residual (non-compilable) conjuncts run per-row on the survivors
only, through the thread-pool filter.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from nornicdb_tpu_torch.cypher import ast

__all__ = [
    "ParallelConfig",
    "get_parallel_config",
    "set_parallel_config",
    "parallel_filter",
    "parallel_count",
    "parallel_map",
    "parallel_sum",
    "compile_where",
    "CompiledWhere",
]


@dataclass
class ParallelConfig:
    """Mirrors the reference's ParallelConfig (parallel.go:45-53)."""

    enabled: bool = True
    max_workers: int = 0  # 0 -> os.cpu_count()
    min_batch_size: int = 1000  # parallelize only above this (parallel.go:60)
    # the columnar masked scan is one vectorized numpy op, profitable far
    # below the THREAD-dispatch gate above; separately tunable so operators
    # can still force the generic path without killing all parallelism
    columnar_min_rows: int = 64

    def workers(self) -> int:
        return self.max_workers or (os.cpu_count() or 1)


_config = ParallelConfig()
_config_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0


def get_parallel_config() -> ParallelConfig:
    return _config


def set_parallel_config(config: ParallelConfig) -> None:
    """Install a new config (ref: SetParallelConfig parallel.go:68 — zero
    values fall back to defaults)."""
    global _config
    if config.max_workers < 0:
        config.max_workers = 0
    if config.min_batch_size <= 0:
        config.min_batch_size = 1000
    if config.columnar_min_rows <= 0:
        config.columnar_min_rows = 64
    with _config_lock:
        _config = config


def _get_pool(workers: int) -> ThreadPoolExecutor:
    global _pool, _pool_size
    with _config_lock:
        if _pool is None or _pool_size < workers:
            _pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="cypher-scan"
            )
            _pool_size = workers
        return _pool


def _chunks(n_items: int, n_chunks: int) -> list[tuple[int, int]]:
    size = (n_items + n_chunks - 1) // n_chunks
    return [(i, min(i + size, n_items)) for i in range(0, n_items, size)]


def _run_chunked(items: list, chunk_fn: Callable[[list], Any]) -> list:
    """Apply chunk_fn over worker-count chunks; returns per-chunk results
    in order. Sequential when disabled / small / single-core."""
    cfg = _config
    workers = cfg.workers()
    if (
        not cfg.enabled
        or workers <= 1
        or len(items) < cfg.min_batch_size
    ):
        return [chunk_fn(items)]
    pool = _get_pool(workers)
    spans = _chunks(len(items), workers)
    futures = [pool.submit(chunk_fn, items[a:b]) for a, b in spans]
    return [f.result() for f in futures]


def parallel_filter(items: list, pred: Callable[[Any], Any]) -> list:
    """Keep items where pred(x) is True (ref: parallelFilterNodes
    parallel.go:99 — order-preserving chunk merge)."""
    parts = _run_chunked(items, lambda chunk: [x for x in chunk if pred(x) is True])
    out = parts[0] if len(parts) == 1 else [x for p in parts for x in p]
    return out


def parallel_count(items: list, pred: Callable[[Any], Any]) -> int:
    parts = _run_chunked(
        items, lambda chunk: sum(1 for x in chunk if pred(x) is True)
    )
    return sum(parts)


def parallel_map(items: list, fn: Callable[[Any], Any]) -> list:
    parts = _run_chunked(items, lambda chunk: [fn(x) for x in chunk])
    return parts[0] if len(parts) == 1 else [x for p in parts for x in p]


def parallel_sum(items: list, getter: Callable[[Any], Any]) -> float:
    def chunk_sum(chunk):
        t = 0.0
        for x in chunk:
            v = getter(x)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                t += v
        return t

    return sum(_run_chunked(items, chunk_sum))


# --------------------------------------------------------------- columnar
# Leaf ops reuse the row evaluator's three-valued helpers so the compiled
# path is semantics-identical to evaluate() (chaos suite runs both).


class NodeListSource:
    """Column access over a list of Node objects (adapter; the columnar
    index in colindex.py provides the same protocol over live columns)."""

    def __init__(self, nodes: list):
        self.nodes = nodes

    def __len__(self) -> int:
        return len(self.nodes)

    def column(self, key: str) -> list:
        return [n.properties.get(key) for n in self.nodes]


class CompiledWhere:
    """A WHERE conjunction split into a columnar part (mask over a column
    source) and residual conjuncts for the generic evaluator."""

    def __init__(self, mask_fn: Optional[Callable], residual: list[ast.Expr]):
        self._mask_fn = mask_fn
        self.residual: Optional[ast.Expr] = _join_and(residual)

    @property
    def has_columnar(self) -> bool:
        return self._mask_fn is not None

    def mask(self, source, params: dict) -> np.ndarray:
        """source: NodeListSource / colindex label source / list of Nodes."""
        if isinstance(source, list):
            source = NodeListSource(source)
        if self._mask_fn is None:
            return np.ones(len(source), bool)
        return self._mask_fn(source, params)


def _join_and(parts: list[ast.Expr]) -> Optional[ast.Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = ast.BinaryOp("AND", out, p)
    return out


def _split_and(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.BinaryOp) and e.op == "AND":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _prop_key(e: ast.Expr, var: str) -> Optional[str]:
    """Matches `var.key` property access. `id` is excluded: the evaluator
    falls back to the entity id for a missing id property (expr.py), which
    a raw property column cannot reproduce — those leaves stay residual."""
    if (
        isinstance(e, ast.Property)
        and isinstance(e.subject, ast.Variable)
        and e.subject.name == var
        and e.key != "id"
    ):
        return e.key
    return None


def _const_value(e: ast.Expr) -> tuple[bool, Any]:
    """(is_constant, getter(params))."""
    if isinstance(e, ast.Literal):
        return True, (lambda params, v=e.value: v)
    if isinstance(e, ast.Parameter):
        return True, (lambda params, n=e.name: params.get(n))
    if isinstance(e, ast.ListLiteral) and all(
        isinstance(i, (ast.Literal, ast.Parameter)) for i in e.items
    ):
        getters = [_const_value(i)[1] for i in e.items]
        return True, (lambda params, gs=getters: [g(params) for g in gs])
    return False, None


_COMPARE_OPS = ("<", ">", "<=", ">=")
_LEAF_OPS = ("=", "<>", "IN", "STARTS WITH", "ENDS WITH", "CONTAINS", "=~") + _COMPARE_OPS


def _compile_leaf(e: ast.Expr, var: str) -> Optional[Callable]:
    """Compile one leaf into mask_fn(nodes, params) -> bool ndarray, or None.

    Leaves: var.key <op> const, const <op> var.key, var.key IS [NOT] NULL.
    Truthiness: mask is True only where evaluate() would yield True.
    """
    if isinstance(e, ast.IsNull):
        key = _prop_key(e.operand, var)
        if key is None:
            return None
        if e.negated:  # IS NOT NULL
            return lambda source, params, k=key: np.fromiter(
                (v is not None for v in source.column(k)), bool, len(source))
        return lambda source, params, k=key: np.fromiter(
            (v is None for v in source.column(k)), bool, len(source))

    if not (isinstance(e, ast.BinaryOp) and e.op in _LEAF_OPS):
        return None
    key = _prop_key(e.left, var)
    const_side = e.right
    swapped = False
    if key is None:
        key = _prop_key(e.right, var)
        const_side = e.left
        swapped = True
        if key is None:
            return None
        if e.op not in ("=", "<>") + _COMPARE_OPS:
            return None  # asymmetric string/list ops: const-on-left differs
    is_const, getter = _const_value(const_side)
    if not is_const:
        return None

    # reuse the evaluator's own binary dispatch per element: exact parity
    # with three-valued semantics at a fraction of the tree-walk cost
    op = e.op

    def mask_fn(source, params, k=key, op=op, getter=getter, swapped=swapped):
        from nornicdb_tpu_torch.cypher.expr import _compare, _eq

        const = getter(params)
        vals = source.column(k)
        if op == "=":
            it = (_eq(v, const) is True for v in vals)
        elif op == "<>":
            it = ((lambda r: r is not None and not r)(_eq(v, const))
                  for v in vals)
        elif op in _COMPARE_OPS:
            if swapped:
                it = (_compare(op, const, v) is True for v in vals)
            else:
                it = (_compare(op, v, const) is True for v in vals)
        elif op == "IN":
            if not isinstance(const, list):
                if const is None:
                    return np.zeros(len(vals), bool)
                from nornicdb_tpu_torch.errors import CypherTypeError

                raise CypherTypeError("IN expects a list")
            it = (any(_eq(v, item) is True for item in const)
                  if v is not None else False for v in vals)
        elif op == "STARTS WITH":
            it = (v is not None and const is not None
                  and str(v).startswith(str(const)) for v in vals)
        elif op == "ENDS WITH":
            it = (v is not None and const is not None
                  and str(v).endswith(str(const)) for v in vals)
        elif op == "CONTAINS":
            it = (v is not None and const is not None
                  and str(const) in str(v) for v in vals)
        elif op == "=~":
            # bounded engine shared with the row evaluator — a catastrophic
            # pattern must error, not wedge the scan pool (see expr.py).
            # _compiled: eager invalid-pattern error + cross-query memo.
            from nornicdb_tpu_torch.cypher.expr import _compiled

            if const is None:
                return np.zeros(len(vals), bool)
            pat = _compiled(const)
            # non-string values raise TypeError in fullmatch, matching the
            # row evaluator's behavior exactly
            it = (v is not None and pat.fullmatch(v)
                  for v in vals)
        else:  # pragma: no cover
            return None
        return np.fromiter(it, bool, len(vals))

    return mask_fn


def _compile_tree(e: ast.Expr, var: str) -> Optional[Callable]:
    """Full compile of a boolean tree; None when any leaf can't compile.

    True-mask composition is sound for WHERE filtering (keep-if-TRUE):
    AND(a,b) true-set == a_true & b_true; OR true-set == union; NOT(x) keeps
    rows where x is False — which for compilable leaves is the complement of
    x's True set only when x is never null, so NOT compiles only over
    null-free leaves (IS NULL / IS NOT NULL and their combinations)."""
    leaf = _compile_leaf(e, var)
    if leaf is not None:
        return leaf
    if isinstance(e, ast.BinaryOp) and e.op in ("AND", "OR"):
        lf = _compile_tree(e.left, var)
        rf = _compile_tree(e.right, var)
        if lf is None or rf is None:
            return None
        if e.op == "AND":
            return lambda src, params: lf(src, params) & rf(src, params)
        return lambda src, params: lf(src, params) | rf(src, params)
    if isinstance(e, ast.UnaryOp) and e.op == "NOT":
        inner = e.operand
        if _null_free(inner, var):
            f = _compile_tree(inner, var)
            if f is not None:
                return lambda src, params: ~f(src, params)
    return None


def _null_free(e: ast.Expr, var: str) -> bool:
    """Expressions that never evaluate to null (so NOT == mask complement)."""
    if isinstance(e, ast.IsNull):
        return _prop_key(e.operand, var) is not None
    if isinstance(e, ast.BinaryOp) and e.op in ("AND", "OR"):
        return _null_free(e.left, var) and _null_free(e.right, var)
    if isinstance(e, ast.UnaryOp) and e.op == "NOT":
        return _null_free(e.operand, var)
    return False


def compile_where(where: Optional[ast.Expr], var: str) -> CompiledWhere:
    """Split a WHERE into compiled columnar conjuncts + residual AST.

    Sound because WHERE keeps only TRUE rows and a conjunction is TRUE iff
    every conjunct is TRUE — so conjuncts can be checked in any order/form."""
    if where is None:
        return CompiledWhere(None, [])
    compiled: list[Callable] = []
    residual: list[ast.Expr] = []
    for part in _split_and(where):
        f = _compile_tree(part, var)
        if f is None:
            residual.append(part)
        else:
            compiled.append(f)
    if not compiled:
        return CompiledWhere(None, residual)

    def mask_fn(source, params):
        m = compiled[0](source, params)
        for f in compiled[1:]:
            m &= f(source, params)
        return m

    return CompiledWhere(mask_fn, residual)
