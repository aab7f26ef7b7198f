"""Opt-in strict Cypher semantic validation.

Behavioral reference: the reference ships a full generated ANTLR grammar
used for validation only, switched by NORNICDB_PARSER=nornic|antlr
(upstream NornicDB pkg/cypher/antlr/, executor.go:1572-1655,
docs/architecture/cypher-parser-modes.md — "Syntax Validation: Lenient"
vs "Strict OpenCypher"). This build's recursive-descent parser already
rejects malformed token streams; what the lenient path misses is the
*semantic* layer of OpenCypher validation. This module is that layer:
a pure AST pass (no execution), enabled by NORNICDB_PARSER=strict (the
reference's `antlr` value is accepted as an alias) or per-executor via
`executor.strict_validation = True`.

Checks and the Neo4j errors they mirror:
- queries cannot conclude with MATCH/WITH/UNWIND/LOAD CSV
- undefined variable references ("Variable `x` not defined"), with scope
  threaded through WITH projections, UNWIND, CALL YIELD, subqueries
- expressions in WITH must be aliased
- invalid use of aggregating functions (WHERE, UNWIND, pattern
  properties) and nested aggregation
- RETURN * with no variables in scope
- duplicate result column names
- conflicting variable redeclaration (node var reused as rel var; same
  rel variable bound twice in one pattern; CREATE of a bound variable
  with labels/properties)
- variable-length relationships in CREATE/MERGE
- non-integer or negative SKIP/LIMIT literals
- UNION branches must have identical column names
"""

from __future__ import annotations

import os
from typing import Optional

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.errors import CypherSyntaxError

# aggregating functions per OpenCypher (ref: the ANTLR grammar's
# aggregate rules; executor fast-agg family traversal_fast_agg.go)
AGGREGATES = {
    "count", "sum", "avg", "min", "max", "collect", "stdev", "stdevp",
    "percentilecont", "percentiledisc",
}


def strict_mode_enabled() -> bool:
    """NORNICDB_PARSER=strict|antlr (ref: config.SetParserType)."""
    return os.environ.get("NORNICDB_PARSER", "").lower() in ("strict", "antlr")


def _err(msg: str) -> CypherSyntaxError:
    return CypherSyntaxError(f"strict validation: {msg}")


class _Scope:
    """Variable scope with an `open` escape hatch: once we pass a
    construct whose bindings we cannot enumerate (CALL ... YIELD *),
    undefined-variable errors are suppressed, but every other check
    still runs."""

    def __init__(self, names: Optional[set[str]] = None, open_: bool = False):
        self.names: set[str] = set(names or ())
        self.open = open_

    def has(self, name: str) -> bool:
        return self.open or name in self.names

    def copy(self) -> "_Scope":
        return _Scope(self.names, self.open)


class Validator:
    def validate(self, stmt: ast.Statement) -> None:
        if isinstance(stmt, ast.Query):
            self._query(stmt)
        elif isinstance(stmt, ast.UseCommand) and stmt.query is not None:
            self._query(stmt.query)
        # DDL/admin statements are fully checked by the parser

    # -- query level -------------------------------------------------------
    def _query(self, q: ast.Query, outer: Optional[_Scope] = None) -> None:
        cols = self._single_query(q, outer)
        for union_q, _all in q.unions:
            ucols = self._single_query(union_q, outer)
            if cols is not None and ucols is not None and cols != ucols:
                raise _err(
                    "All sub queries in an UNION must have the same "
                    f"column names (got {cols} vs {ucols})"
                )

    def _single_query(
        self, q: ast.Query, outer: Optional[_Scope] = None
    ) -> Optional[list[str]]:
        """Validates one UNION branch; returns its column names (None if
        unknowable, e.g. RETURN *)."""
        scope = outer.copy() if outer is not None else _Scope()
        columns: Optional[list[str]] = None
        for i, clause in enumerate(q.clauses):
            last = i == len(q.clauses) - 1
            if last and isinstance(
                clause,
                (ast.MatchClause, ast.WithClause, ast.UnwindClause,
                 ast.LoadCsvClause),
            ):
                kind = {
                    ast.MatchClause: "MATCH",
                    ast.WithClause: "WITH",
                    ast.UnwindClause: "UNWIND",
                    ast.LoadCsvClause: "LOAD CSV",
                }[type(clause)]
                raise _err(
                    f"Query cannot conclude with {kind} (must be a RETURN "
                    "clause, an update clause, a unit subquery call, or a "
                    "procedure call with no YIELD)"
                )
            columns = self._clause(clause, scope)
        return columns

    # -- clauses -----------------------------------------------------------
    def _clause(self, clause, scope: _Scope) -> Optional[list[str]]:
        if isinstance(clause, ast.MatchClause):
            self._match(clause, scope)
        elif isinstance(clause, ast.CreateClause):
            self._create(clause, scope)
        elif isinstance(clause, ast.MergeClause):
            self._merge(clause, scope)
        elif isinstance(clause, ast.SetClause):
            for item in clause.items:
                self._set_item(item, scope)
        elif isinstance(clause, ast.RemoveClause):
            for item in clause.items:
                self._set_item(item, scope)
        elif isinstance(clause, ast.DeleteClause):
            for e in clause.exprs:
                if isinstance(e, (ast.Literal, ast.MapLiteral, ast.ListLiteral)):
                    raise _err("DELETE expected a node or relationship "
                               "variable, got a literal")
                self._expr(e, scope)
        elif isinstance(clause, (ast.WithClause, ast.ReturnClause)):
            return self._projection(clause, scope)
        elif isinstance(clause, ast.UnwindClause):
            self._no_aggregates(clause.expr, "UNWIND")
            self._expr(clause.expr, scope)
            scope.names.add(clause.variable)
        elif isinstance(clause, ast.CallClause):
            for a in clause.args:
                self._expr(a, scope)
            if clause.yield_star:
                scope.open = True
            for name, alias in clause.yield_items:
                scope.names.add(alias or name)
            if clause.where is not None:
                self._expr(clause.where, scope)
        elif isinstance(clause, ast.CallSubquery):
            for v in clause.imported:
                if not scope.has(v):
                    raise _err(f"Variable `{v}` not defined (imported into "
                               "CALL subquery)")
            inner = _Scope(set(clause.imported), scope.open)
            self._query(clause.query, inner)
            # the subquery's RETURN aliases join the outer scope
            for sub_clause in clause.query.clauses:
                if isinstance(sub_clause, ast.ReturnClause):
                    if sub_clause.star:
                        scope.open = True
                    for item in sub_clause.items:
                        scope.names.add(item.key)
        elif isinstance(clause, ast.ForeachClause):
            self._expr(clause.expr, scope)
            body_scope = scope.copy()
            body_scope.names.add(clause.variable)
            for upd in clause.updates:
                if isinstance(
                    upd, (ast.MatchClause, ast.WithClause, ast.ReturnClause,
                          ast.UnwindClause, ast.CallClause)
                ):
                    raise _err(
                        "Invalid use of "
                        f"{type(upd).__name__.replace('Clause', '').upper()} "
                        "inside FOREACH (only updating clauses are allowed)"
                    )
                self._clause(upd, body_scope)
        elif isinstance(clause, ast.LoadCsvClause):
            self._expr(clause.url, scope)
            scope.names.add(clause.variable)
        return None

    def _match(self, clause: ast.MatchClause, scope: _Scope) -> None:
        new = scope.copy()
        for path in clause.patterns:
            self._pattern(path, new, binding=True, updating=False)
        if clause.where is not None:
            self._no_aggregates(clause.where, "WHERE")
            self._expr(clause.where, new)
        scope.names |= new.names

    def _create(self, clause: ast.CreateClause, scope: _Scope) -> None:
        for path in clause.patterns:
            self._pattern(path, scope, binding=True, updating=True)

    def _merge(self, clause: ast.MergeClause, scope: _Scope) -> None:
        self._pattern(clause.pattern, scope, binding=True, updating=True)
        for item in clause.on_create + clause.on_match:
            self._set_item(item, scope)

    def _set_item(self, item: ast.SetItem, scope: _Scope) -> None:
        self._expr(item.target, scope)
        if item.value is not None:
            self._no_aggregates(item.value, "SET")
            self._expr(item.value, scope)

    def _projection(self, clause, scope: _Scope) -> Optional[list[str]]:
        is_with = isinstance(clause, ast.WithClause)
        if clause.star and not scope.open and not scope.names:
            raise _err(
                f"{'WITH' if is_with else 'RETURN'} * is not allowed when "
                "there are no variables in scope"
            )
        names: list[str] = []
        for item in clause.items:
            if is_with and item.alias is None and not isinstance(
                item.expr, ast.Variable
            ):
                raise _err(
                    "Expression in WITH must be aliased (use AS)"
                )
            self._check_nested_aggregates(item.expr)
            self._expr(item.expr, scope)
            names.append(item.key)
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise _err(
                "Multiple result columns with the same name are not "
                f"supported ({sorted(dupes)})"
            )
        # ORDER BY/WHERE see both input scope and the new aliases
        extended = scope.copy()
        extended.names |= set(names)
        for item in clause.order_by:
            self._expr(item.expr, extended)
        if is_with and clause.where is not None:
            self._expr(clause.where, extended)
        for bound, label in ((clause.skip, "SKIP"), (clause.limit, "LIMIT")):
            # fold unary minus so LIMIT -1 (UnaryOp('-', Literal(1)))
            # is seen as the negative literal it is
            if (
                isinstance(bound, ast.UnaryOp)
                and bound.op == "-"
                and isinstance(bound.operand, ast.Literal)
                and isinstance(bound.operand.value, (int, float))
                and not isinstance(bound.operand.value, bool)
            ):
                bound = ast.Literal(-bound.operand.value)
            if isinstance(bound, ast.Literal):
                v = bound.value
                if not isinstance(v, int) or isinstance(v, bool):
                    raise _err(f"{label} must be a non-negative integer "
                               f"(got {v!r})")
                if v < 0:
                    raise _err(f"{label} must be a non-negative integer "
                               f"(got {v})")
            elif bound is not None and not isinstance(bound, ast.Parameter):
                # expressions referencing variables are not allowed here
                for name in self._free_variables(bound):
                    raise _err(
                        f"It is not allowed to refer to variables "
                        f"(`{name}`) in {label}"
                    )
        if is_with:
            new = _Scope(set(names))
            if clause.star:
                new.names |= scope.names
                new.open = scope.open
            scope.names = new.names
            scope.open = new.open
            return None
        return None if clause.star else names

    # -- patterns ----------------------------------------------------------
    def _pattern(
        self, path: ast.PatternPath, scope: _Scope, binding: bool,
        updating: bool,
    ) -> None:
        """Validates one pattern path, binding its variables into scope.

        `updating` marks CREATE/MERGE patterns, which have stricter rules
        (no var-length rels, no re-binding with labels/properties).
        """
        rel_vars_here: set[str] = set()
        node_vars: set[str] = set()
        rel_vars: set[str] = set()
        for el in path.elements:
            if isinstance(el, ast.NodePattern):
                if el.variable:
                    node_vars.add(el.variable)
            else:
                if el.variable:
                    rel_vars.add(el.variable)
        for el in path.elements:
            if isinstance(el, ast.NodePattern):
                if el.variable:
                    if el.variable in rel_vars:
                        raise _err(
                            f"Type mismatch: `{el.variable}` is used as "
                            "both a node and a relationship variable"
                        )
                    already = el.variable in scope.names
                    if updating and already and (el.labels or el.properties):
                        raise _err(
                            f"Can't create/merge node `{el.variable}` with "
                            "labels or properties here — the variable is "
                            "already declared in this context"
                        )
                    if binding:
                        scope.names.add(el.variable)
                if el.properties is not None:
                    self._no_aggregates(el.properties, "pattern properties")
                    self._expr(el.properties, self._pattern_scope(scope, path))
                if el.where is not None:
                    self._expr(el.where, self._pattern_scope(scope, path))
            else:  # RelPattern
                if el.var_length and updating:
                    raise _err(
                        "Variable length relationships cannot be used in "
                        "CREATE or MERGE"
                    )
                if el.variable:
                    if el.variable in rel_vars_here:
                        raise _err(
                            "Cannot use the same relationship variable "
                            f"`{el.variable}` for multiple relationships"
                        )
                    rel_vars_here.add(el.variable)
                    if el.variable in node_vars:
                        raise _err(
                            f"Type mismatch: `{el.variable}` is used as "
                            "both a node and a relationship variable"
                        )
                    if binding:
                        scope.names.add(el.variable)
                if el.properties is not None:
                    self._no_aggregates(el.properties, "pattern properties")
                    self._expr(el.properties, self._pattern_scope(scope, path))
        if path.name:
            if binding:
                scope.names.add(path.name)

    @staticmethod
    def _pattern_scope(scope: _Scope, path: ast.PatternPath) -> _Scope:
        """Expressions inside a pattern may reference variables bound
        anywhere in the same pattern (plus the enclosing scope)."""
        s = scope.copy()
        for el in path.elements:
            if el.variable:
                s.names.add(el.variable)
        if path.name:
            s.names.add(path.name)
        return s

    # -- expressions -------------------------------------------------------
    def _expr(self, e, scope: _Scope) -> None:
        if e is None or isinstance(e, (ast.Literal, ast.Parameter)):
            return
        if isinstance(e, ast.Variable):
            if not scope.has(e.name):
                raise _err(f"Variable `{e.name}` not defined")
            return
        if isinstance(e, ast.Property):
            self._expr(e.subject, scope)
            return
        if isinstance(e, ast.ListLiteral):
            for x in e.items:
                self._expr(x, scope)
            return
        if isinstance(e, ast.MapLiteral):
            for x in e.items.values():
                self._expr(x, scope)
            return
        if isinstance(e, ast.FunctionCall):
            for a in e.args:
                self._expr(a, scope)
            return
        if isinstance(e, ast.UnaryOp):
            self._expr(e.operand, scope)
            return
        if isinstance(e, ast.BinaryOp):
            self._expr(e.left, scope)
            self._expr(e.right, scope)
            return
        if isinstance(e, ast.IsNull):
            self._expr(e.operand, scope)
            return
        if isinstance(e, ast.Subscript):
            self._expr(e.subject, scope)
            self._expr(e.index, scope)
            return
        if isinstance(e, ast.Slice):
            self._expr(e.subject, scope)
            self._expr(e.start, scope)
            self._expr(e.end, scope)
            return
        if isinstance(e, ast.CaseExpr):
            self._expr(e.subject, scope)
            for w, t in e.whens:
                self._expr(w, scope)
                self._expr(t, scope)
            self._expr(e.default, scope)
            return
        if isinstance(e, ast.ListComprehension):
            self._expr(e.source, scope)
            inner = scope.copy()
            inner.names.add(e.variable)
            self._expr(e.where, inner)
            self._expr(e.projection, inner)
            return
        if isinstance(e, ast.MapProjection):
            self._expr(e.subject, scope)
            for kind, payload in e.items:
                if kind == "alias":
                    self._expr(payload[1], scope)
                elif kind == "var":
                    self._expr(ast.Variable(payload), scope)
            return
        if isinstance(e, ast.PatternComprehension):
            inner = scope.copy()
            self._pattern(e.pattern, inner, binding=True, updating=False)
            self._expr(e.where, inner)
            self._expr(e.projection, inner)
            return
        if isinstance(e, ast.PatternPredicate):
            # bare pattern predicate: may introduce no new bindings; all
            # its variables must exist OR be anonymous
            inner = scope.copy()
            self._pattern(e.pattern, inner, binding=True, updating=False)
            return
        if isinstance(e, (ast.ExistsSubquery, ast.CountSubquery)):
            inner = scope.copy()
            self._pattern(e.pattern, inner, binding=True, updating=False)
            self._expr(e.where, inner)
            return
        if isinstance(e, ast.ReduceExpr):
            self._expr(e.init, scope)
            self._expr(e.source, scope)
            inner = scope.copy()
            inner.names.add(e.accumulator)
            inner.names.add(e.variable)
            self._expr(e.body, inner)
            return
        if isinstance(e, ast.Quantifier):
            self._expr(e.source, scope)
            inner = scope.copy()
            inner.names.add(e.variable)
            self._expr(e.predicate, inner)
            return
        # unknown expression node: nothing to check

    # -- aggregate rules ---------------------------------------------------
    def _iter_function_calls(self, e):
        if isinstance(e, ast.FunctionCall):
            yield e
        for child in self._children(e):
            yield from self._iter_function_calls(child)

    @staticmethod
    def _children(e):
        if isinstance(e, ast.FunctionCall):
            return list(e.args)
        if isinstance(e, ast.UnaryOp):
            return [e.operand]
        if isinstance(e, ast.BinaryOp):
            return [e.left, e.right]
        if isinstance(e, ast.IsNull):
            return [e.operand]
        if isinstance(e, ast.Property):
            return [e.subject]
        if isinstance(e, ast.ListLiteral):
            return list(e.items)
        if isinstance(e, ast.MapLiteral):
            return list(e.items.values())
        if isinstance(e, ast.Subscript):
            return [e.subject, e.index]
        if isinstance(e, ast.Slice):
            return [x for x in (e.subject, e.start, e.end) if x is not None]
        if isinstance(e, ast.CaseExpr):
            out = [x for x in (e.subject, e.default) if x is not None]
            for w, t in e.whens:
                out += [w, t]
            return out
        if isinstance(e, ast.ListComprehension):
            return [x for x in (e.source, e.where, e.projection)
                    if x is not None]
        if isinstance(e, ast.ReduceExpr):
            return [e.init, e.source, e.body]
        if isinstance(e, ast.Quantifier):
            return [e.source, e.predicate]
        if isinstance(e, ast.MapProjection):
            out = [e.subject]
            for kind, payload in e.items:
                if kind == "alias":
                    out.append(payload[1])
            return out
        if isinstance(e, ast.PatternComprehension):
            return Validator._pattern_exprs(e.pattern) + [
                x for x in (e.where, e.projection) if x is not None
            ]
        if isinstance(e, ast.PatternPredicate):
            return Validator._pattern_exprs(e.pattern)
        if isinstance(e, (ast.ExistsSubquery, ast.CountSubquery)):
            return Validator._pattern_exprs(e.pattern) + (
                [e.where] if e.where is not None else []
            )
        return []

    @staticmethod
    def _pattern_exprs(path: ast.PatternPath) -> list:
        """Expressions embedded in a pattern: property maps and inline
        WHEREs."""
        out: list = []
        for el in path.elements:
            if el.properties is not None:
                out.append(el.properties)
            if isinstance(el, ast.NodePattern) and el.where is not None:
                out.append(el.where)
        return out

    def _no_aggregates(self, e, context: str) -> None:
        for fc in self._iter_function_calls(e):
            if fc.name.lower() in AGGREGATES:
                raise _err(
                    f"Invalid use of aggregating function "
                    f"{fc.name}(...) in {context}"
                )

    def _check_nested_aggregates(self, e) -> None:
        for fc in self._iter_function_calls(e):
            if fc.name.lower() in AGGREGATES:
                for inner in fc.args:
                    for nested in self._iter_function_calls(inner):
                        if nested.name.lower() in AGGREGATES:
                            raise _err(
                                "Can't use aggregate functions inside of "
                                f"aggregate functions ({nested.name} inside "
                                f"{fc.name})"
                            )

    # -- helpers -----------------------------------------------------------
    def _free_variables(self, e) -> set[str]:
        out: set[str] = set()
        if isinstance(e, ast.Variable):
            out.add(e.name)
        for child in self._children(e):
            out |= self._free_variables(child)
        return out


def validate(stmt: ast.Statement) -> None:
    """Run the strict semantic pass; raises CypherSyntaxError."""
    Validator().validate(stmt)
