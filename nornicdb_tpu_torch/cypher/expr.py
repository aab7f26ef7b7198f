"""Cypher expression evaluation.

Three-valued logic (null propagation) follows Neo4j semantics, which the
reference mirrors (pkg/cypher executor expression handling; compat spec in
neo4j_compat_test.go).
"""

from __future__ import annotations

import functools
import re
from typing import Any, Optional

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.cypher.functions import FUNCTIONS
from nornicdb_tpu_torch.errors import CypherSyntaxError, CypherTypeError
from nornicdb_tpu_torch.storage.types import Edge, Node

try:  # the `regex` engine supports a hard match timeout
    import regex as _regex_mod
except ImportError:  # pragma: no cover - regex is in the standard image
    _regex_mod = None

# Bound on a single =~ evaluation. The reference runs on Go's RE2, which is
# linear-time by construction (chaos_injection_test.go TestInjection_RegexReDoS
# relies on that); CPython's `re` backtracks exponentially, so a catastrophic
# pattern like (a+)+$ would hang the executor for hours. The `regex` module's
# timeout gives the same guarantee operationally: evil patterns error out
# instead of wedging the query thread.
REGEX_TIMEOUT_S = 2.0


class BoundedPattern:
    """A compiled regex whose matches are time-bounded. Compile once, match
    per row (the columnar WHERE path scans whole property columns)."""

    def __init__(self, pattern):
        try:
            if _regex_mod is not None:
                self._pat = _regex_mod.compile(pattern)
            else:  # pragma: no cover - regex is in the standard image
                self._pat = re.compile(pattern)
        except Exception:
            raise CypherSyntaxError(f"invalid regex: {pattern!r}")
        self._pattern = pattern

    def fullmatch(self, value) -> bool:
        try:
            if _regex_mod is not None:
                return self._pat.fullmatch(
                    value, timeout=REGEX_TIMEOUT_S) is not None
            return self._pat.fullmatch(value) is not None
        except TimeoutError:
            raise CypherSyntaxError(
                f"regex timed out after {REGEX_TIMEOUT_S}s "
                f"(catastrophic backtracking?): {self._pattern!r}"
            )


@functools.lru_cache(maxsize=256)
def _compiled(pattern) -> BoundedPattern:
    return BoundedPattern(pattern)


def regex_fullmatch(pattern, value) -> bool:
    """Cypher `=~`: full match, bounded runtime, CypherSyntaxError on a bad
    pattern. Raises TypeError for non-string subjects (caller semantics)."""
    try:
        pat = _compiled(pattern)
    except TypeError:  # unhashable pattern (caller passed a non-string)
        pat = BoundedPattern(pattern)
    return pat.fullmatch(value)


class EvalContext:
    """Evaluation context: row bindings + params + hooks into the executor."""

    def __init__(
        self,
        bindings: dict[str, Any],
        params: dict[str, Any],
        executor=None,
    ):
        self.bindings = bindings
        self.params = params
        self.executor = executor  # for subqueries / startNode / endNode

    def child(self, extra: dict[str, Any]) -> "EvalContext":
        merged = dict(self.bindings)
        merged.update(extra)
        return EvalContext(merged, self.params, self.executor)


def evaluate(e: ast.Expr, ctx: EvalContext) -> Any:
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.Parameter):
        if e.name not in ctx.params:
            raise CypherSyntaxError(f"missing parameter ${e.name}")
        return ctx.params[e.name]
    if isinstance(e, ast.Variable):
        if e.name in ctx.bindings:
            return ctx.bindings[e.name]
        raise CypherSyntaxError(f"variable `{e.name}` not defined")
    if isinstance(e, ast.Property):
        subject = evaluate(e.subject, ctx)
        if subject is None:
            return None
        if isinstance(subject, (Node, Edge)):
            v = subject.properties.get(e.key)
            if v is None and e.key == "id":
                # `n.id` falls back to the entity id when no id property
                # exists (ref contract: neo4j_compat_test.go:299 returns the
                # storage ID for nodes created without an id property)
                return subject.id
            return v
        if isinstance(subject, dict):
            return subject.get(e.key)
        raise CypherTypeError(f"cannot access property .{e.key} on {type(subject).__name__}")
    if isinstance(e, ast.ListLiteral):
        return [evaluate(i, ctx) for i in e.items]
    if isinstance(e, ast.MapLiteral):
        if "__param__" in e.items:  # (n $props) pattern form
            return evaluate(e.items["__param__"], ctx)
        return {k: evaluate(v, ctx) for k, v in e.items.items()}
    if isinstance(e, ast.UnaryOp):
        return _unary(e, ctx)
    if isinstance(e, ast.BinaryOp):
        return _binary(e, ctx)
    if isinstance(e, ast.IsNull):
        v = evaluate(e.operand, ctx)
        return (v is not None) if e.negated else (v is None)
    if isinstance(e, ast.Subscript):
        subject = evaluate(e.subject, ctx)
        idx = evaluate(e.index, ctx)
        if subject is None or idx is None:
            return None
        if isinstance(subject, dict):
            return subject.get(idx)
        if isinstance(subject, (Node, Edge)):
            return subject.properties.get(idx)
        if isinstance(subject, list):
            i = int(idx)
            if -len(subject) <= i < len(subject):
                return subject[i]
            return None
        raise CypherTypeError("subscript on non-list/map")
    if isinstance(e, ast.Slice):
        subject = evaluate(e.subject, ctx)
        if subject is None:
            return None
        start = evaluate(e.start, ctx) if e.start is not None else None
        end = evaluate(e.end, ctx) if e.end is not None else None
        return subject[
            int(start) if start is not None else None : int(end) if end is not None else None
        ]
    if isinstance(e, ast.CaseExpr):
        if e.subject is not None:
            subj = evaluate(e.subject, ctx)
            for cond, result in e.whens:
                if _eq(subj, evaluate(cond, ctx)) is True:
                    return evaluate(result, ctx)
        else:
            for cond, result in e.whens:
                if evaluate(cond, ctx) is True:
                    return evaluate(result, ctx)
        return evaluate(e.default, ctx) if e.default is not None else None
    if isinstance(e, ast.ListComprehension):
        src = evaluate(e.source, ctx)
        if src is None:
            return None
        out = []
        for item in src:
            child = ctx.child({e.variable: item})
            if e.where is not None and evaluate(e.where, child) is not True:
                continue
            out.append(evaluate(e.projection, child) if e.projection is not None else item)
        return out
    if isinstance(e, ast.Quantifier):
        src = evaluate(e.source, ctx)
        if src is None:
            return None
        results = [evaluate(e.predicate, ctx.child({e.variable: item})) for item in src]
        truths = [r is True for r in results]
        if e.kind == "all":
            return all(truths)
        if e.kind == "any":
            return any(truths)
        if e.kind == "none":
            return not any(truths)
        if e.kind == "single":
            return sum(truths) == 1
    if isinstance(e, ast.MapProjection):
        subject = evaluate(e.subject, ctx)
        if subject is None:
            return None
        if isinstance(subject, (Node, Edge)):
            props = subject.properties
        elif isinstance(subject, dict):
            props = subject
        else:
            raise CypherTypeError("map projection needs a node/relationship/map")
        out: dict[str, Any] = {}
        for kind, payload in e.items:
            if kind == "all":
                out.update(props)
            elif kind == "prop":
                out[payload] = props.get(payload)
            elif kind == "alias":
                name, expr2 = payload
                out[name] = evaluate(expr2, ctx)
            elif kind == "var":
                out[payload] = evaluate(ast.Variable(payload), ctx)
        return out
    if isinstance(e, ast.PatternComprehension):
        if ctx.executor is None:
            raise CypherTypeError("pattern comprehension requires executor context")
        return ctx.executor.eval_pattern_comprehension(e, ctx)
    if isinstance(e, ast.ReduceExpr):
        src = evaluate(e.source, ctx)
        if src is None:
            return None
        acc = evaluate(e.init, ctx)
        for item in src:
            acc = evaluate(e.body, ctx.child({e.accumulator: acc, e.variable: item}))
        return acc
    if isinstance(e, ast.FunctionCall):
        return _function(e, ctx)
    if isinstance(e, (ast.PatternPredicate, ast.ExistsSubquery, ast.CountSubquery)):
        if ctx.executor is None:
            raise CypherTypeError("pattern predicate requires executor context")
        return ctx.executor.eval_pattern_expr(e, ctx)
    if isinstance(e, ast.LabelPredicate):
        # n:Label[:Label...] — true iff the subject node has EVERY label;
        # on a relationship, r:TYPE checks the relationship type (Neo4j 5
        # relationship type expressions)
        subject = evaluate(e.subject, ctx)
        if subject is None:
            return None
        if isinstance(subject, Edge):
            return subject.type in e.labels
        if not isinstance(subject, Node):
            raise CypherTypeError(
                "label predicate expects a node or relationship"
            )
        return all(label in subject.labels for label in e.labels)
    if isinstance(e, ast.CollectSubquery):
        if ctx.executor is None:
            raise CypherTypeError("COLLECT subquery requires executor context")
        return ctx.executor.eval_collect_subquery(e, ctx)
    raise CypherTypeError(f"cannot evaluate {type(e).__name__}")


def _unary(e: ast.UnaryOp, ctx: EvalContext) -> Any:
    v = evaluate(e.operand, ctx)
    if e.op == "NOT":
        if v is None:
            return None
        if not isinstance(v, bool):
            raise CypherTypeError("NOT expects a boolean")
        return not v
    if v is None:
        return None
    if e.op == "-":
        return -v
    return v


def _eq(a: Any, b: Any) -> Optional[bool]:
    if a is None or b is None:
        return None
    if isinstance(a, (Node, Edge)) and isinstance(b, (Node, Edge)):
        return a.id == b.id
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if type(a) is not type(b) and not (
        isinstance(a, (list, dict)) and isinstance(b, (list, dict))
    ):
        return False
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return False
        return all(_eq(x, y) is True for x, y in zip(a, b))
    return a == b


def _compare(op: str, a: Any, b: Any) -> Optional[bool]:
    if a is None or b is None:
        return None
    try:
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        if op == ">=":
            return a >= b
    except TypeError:
        return None
    return None


def _binary(e: ast.BinaryOp, ctx: EvalContext) -> Any:
    op = e.op
    if op in ("AND", "OR", "XOR"):
        left = evaluate(e.left, ctx)
        # three-valued logic with short-circuit
        if op == "AND":
            if left is False:
                return False
            right = evaluate(e.right, ctx)
            if right is False:
                return False
            if left is None or right is None:
                return None
            return True
        if op == "OR":
            if left is True:
                return True
            right = evaluate(e.right, ctx)
            if right is True:
                return True
            if left is None or right is None:
                return None
            return False
        right = evaluate(e.right, ctx)
        if left is None or right is None:
            return None
        return bool(left) != bool(right)

    a = evaluate(e.left, ctx)
    b = evaluate(e.right, ctx)
    if op == "=":
        return _eq(a, b)
    if op in ("<>", "!="):  # != is the reference-dialect alias for <>
        r = _eq(a, b)
        return None if r is None else not r
    if op in ("<", ">", "<=", ">="):
        return _compare(op, a, b)
    if op == "IN":
        if b is None:
            return None
        if not isinstance(b, list):
            raise CypherTypeError("IN expects a list")
        if a is None:
            return None
        found_null = False
        for item in b:
            r = _eq(a, item)
            if r is True:
                return True
            if r is None:
                found_null = True
        return None if found_null else False
    if op == "STARTS WITH":
        if a is None or b is None:
            return None
        return str(a).startswith(str(b))
    if op == "ENDS WITH":
        if a is None or b is None:
            return None
        return str(a).endswith(str(b))
    if op == "CONTAINS":
        if a is None or b is None:
            return None
        return str(b) in str(a)
    if op == "=~":
        if a is None or b is None:
            return None
        return regex_fullmatch(b, a)
    if a is None or b is None:
        return None
    # temporal arithmetic: datetime/date ± duration, duration ± duration
    if op in ("+", "-") and (_temporal_kind(a) or _temporal_kind(b)):
        out = _temporal_arith(op, a, b)
        if out is not None:
            return out
    if op == "+":
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        if isinstance(a, list):
            return a + [b]
        if isinstance(b, list):
            return [a] + b
        if isinstance(a, str) or isinstance(b, str):
            if isinstance(a, str) and isinstance(b, str):
                return a + b
            # string + number coerces (Neo4j allows string concatenation)
            return _to_str(a) + _to_str(b)
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if isinstance(a, int) and isinstance(b, int):
            if b == 0:
                raise CypherTypeError("/ by zero")
            q = a // b
            if (a % b != 0) and ((a < 0) != (b < 0)):
                q += 1
            return q
        if b == 0:
            raise CypherTypeError("/ by zero")
        return a / b
    if op == "%":
        if b == 0:
            raise CypherTypeError("% by zero")
        return a - b * int(a / b) if isinstance(a, float) or isinstance(b, float) else _cmod(a, b)
    if op == "^":
        return float(a) ** float(b)
    raise CypherTypeError(f"unknown operator {op}")


def _temporal_kind(v: Any) -> Optional[str]:
    if isinstance(v, dict):
        return v.get("__temporal__")
    return None


def _temporal_arith(op: str, a: Any, b: Any) -> Any:
    """datetime/date ± duration → datetime/date; duration ± duration →
    duration; datetime - datetime → duration. None = not a temporal combo
    (caller falls through to numeric/list semantics)."""
    from nornicdb_tpu_torch.cypher import temporal_fns as t

    ka, kb = _temporal_kind(a), _temporal_kind(b)
    if ka in ("datetime", "date") and kb == "duration":
        ms = a["epochMillis"] + (b["milliseconds"] if op == "+" else -b["milliseconds"])
        out = t.fn_from_epoch_millis(ms)
        return t.fn_date(out) if ka == "date" else out
    if ka == "duration" and kb in ("datetime", "date") and op == "+":
        return _temporal_arith("+", b, a)
    if ka == "duration" and kb == "duration":
        ms = a["milliseconds"] + (b["milliseconds"] if op == "+" else -b["milliseconds"])
        return t.fn_duration({"seconds": ms / 1000.0})
    if ka in ("datetime", "date") and kb in ("datetime", "date") and op == "-":
        return t.fn_duration(
            {"seconds": (a["epochMillis"] - b["epochMillis"]) / 1000.0}
        )
    return None


def _cmod(a: int, b: int) -> int:
    return a - b * int(a / b)


def _to_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _function(e: ast.FunctionCall, ctx: EvalContext) -> Any:
    name = e.name
    if name in ("startnode", "endnode"):
        rel = evaluate(e.args[0], ctx) if e.args else None
        if rel is None:
            return None
        if not isinstance(rel, Edge):
            raise CypherTypeError(f"{name}() expects a relationship")
        if ctx.executor is None:
            raise CypherTypeError(f"{name}() requires executor context")
        nid = rel.start_node if name == "startnode" else rel.end_node
        return ctx.executor.get_node_or_none(nid)
    fn = FUNCTIONS.get(name)
    if fn is None and ctx.executor is not None:
        fn = ctx.executor.lookup_function(name)
    if fn is None:
        raise CypherSyntaxError(f"unknown function {name}()")
    args = [evaluate(a, ctx) for a in e.args]
    if getattr(fn, "needs_executor", False):
        return fn(ctx.executor, *args)
    return fn(*args)
