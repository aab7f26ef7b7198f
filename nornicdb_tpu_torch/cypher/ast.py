"""Cypher AST node definitions."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union


# ---------------------------------------------------------------- expressions
@dataclass
class Literal:
    value: Any


@dataclass
class Parameter:
    name: str


@dataclass
class Variable:
    name: str


@dataclass
class Property:
    subject: "Expr"
    key: str


@dataclass
class ListLiteral:
    items: list["Expr"]


@dataclass
class MapLiteral:
    items: dict[str, "Expr"]


@dataclass
class FunctionCall:
    name: str  # lowercased, may be dotted (apoc.text.join)
    args: list["Expr"]
    distinct: bool = False


@dataclass
class UnaryOp:
    op: str  # NOT, -, +
    operand: "Expr"


@dataclass
class BinaryOp:
    op: str  # + - * / % ^ = <> < > <= >= AND OR XOR IN =~ STARTS ENDS CONTAINS
    left: "Expr"
    right: "Expr"


@dataclass
class IsNull:
    operand: "Expr"
    negated: bool = False


@dataclass
class Subscript:
    subject: "Expr"
    index: "Expr"


@dataclass
class Slice:
    subject: "Expr"
    start: Optional["Expr"]
    end: Optional["Expr"]


@dataclass
class CaseExpr:
    subject: Optional["Expr"]  # simple CASE has a subject; searched has None
    whens: list[tuple["Expr", "Expr"]]
    default: Optional["Expr"]


@dataclass
class ListComprehension:
    variable: str
    source: "Expr"
    where: Optional["Expr"]
    projection: Optional["Expr"]


@dataclass
class MapProjection:
    """n {.a, .b, .*, key: expr, var} — Neo4j map projection."""

    subject: "Expr"
    items: list[tuple[str, Any]]  # (kind, payload): prop/all/alias/var


@dataclass
class PatternComprehension:
    """[(a)-[:R]->(b) WHERE p | expr]"""

    pattern: "PatternPath"
    where: Optional["Expr"]
    projection: "Expr"


@dataclass
class PatternPredicate:
    """A bare pattern used as a boolean predicate, e.g. WHERE (a)-[:KNOWS]->(b)."""

    pattern: "PatternPath"


@dataclass
class ExistsSubquery:
    pattern: "PatternPath"
    where: Optional["Expr"] = None


@dataclass
class CountSubquery:
    pattern: "PatternPath"
    where: Optional["Expr"] = None


@dataclass
class CollectSubquery:
    """COLLECT { MATCH ... RETURN expr } — Neo4j 5 collect subquery;
    evaluates the inner single-column query per row, returns the list."""

    query: "Query"


@dataclass
class LabelPredicate:
    """n:Label[:Label...] used as a boolean expression (WHERE n:Person)."""

    subject: "Expr"
    labels: list[str]


@dataclass
class ReduceExpr:
    """reduce(acc = init, x IN list | expr)"""

    accumulator: str
    init: "Expr"
    variable: str
    source: "Expr"
    body: "Expr"


@dataclass
class Quantifier:
    """ALL/ANY/NONE/SINGLE(x IN list WHERE pred)"""

    kind: str
    variable: str
    source: "Expr"
    predicate: "Expr"


Expr = Union[
    Literal, Parameter, Variable, Property, ListLiteral, MapLiteral,
    FunctionCall, UnaryOp, BinaryOp, IsNull, Subscript, Slice, CaseExpr,
    ListComprehension, PatternPredicate, ExistsSubquery, CountSubquery,
    CollectSubquery, LabelPredicate,
    Quantifier, ReduceExpr, MapProjection, PatternComprehension,
]


# ---------------------------------------------------------------- patterns
@dataclass
class NodePattern:
    variable: Optional[str]
    labels: list[str]
    properties: Optional[MapLiteral]
    where: Optional["Expr"] = None  # inline (n:L WHERE n.x > 1)


@dataclass
class RelPattern:
    variable: Optional[str]
    types: list[str]
    properties: Optional[MapLiteral]
    direction: str  # "out" (->), "in" (<-), "both" (-)
    min_hops: int = 1
    max_hops: int = 1
    var_length: bool = False


@dataclass
class PatternPath:
    """node (rel node)* — optionally named: p = (a)-[r]->(b)."""

    elements: list[Union[NodePattern, RelPattern]]
    name: Optional[str] = None
    shortest: Optional[str] = None  # None | "shortest" | "allshortest"


# ---------------------------------------------------------------- clauses
@dataclass
class ReturnItem:
    expr: Expr
    alias: Optional[str]

    @property
    def key(self) -> str:
        return self.alias or expr_text(self.expr)


@dataclass
class OrderItem:
    expr: Expr
    descending: bool = False


@dataclass
class MatchClause:
    patterns: list[PatternPath]
    optional: bool = False
    where: Optional[Expr] = None


@dataclass
class CreateClause:
    patterns: list[PatternPath]


@dataclass
class MergeClause:
    pattern: PatternPath
    on_create: list["SetItem"] = field(default_factory=list)
    on_match: list["SetItem"] = field(default_factory=list)


@dataclass
class SetItem:
    # kinds: property (a.x = v), variable (a = {..} / a += {..}), label (a:Foo)
    kind: str
    target: Expr
    value: Optional[Expr] = None
    labels: list[str] = field(default_factory=list)
    merge: bool = False  # += semantics


@dataclass
class SetClause:
    items: list[SetItem]


@dataclass
class RemoveClause:
    items: list[SetItem]  # property / label kinds


@dataclass
class DeleteClause:
    exprs: list[Expr]
    detach: bool = False


@dataclass
class WithClause:
    items: list[ReturnItem]
    distinct: bool = False
    order_by: list[OrderItem] = field(default_factory=list)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None
    where: Optional[Expr] = None
    star: bool = False


@dataclass
class ReturnClause:
    items: list[ReturnItem]
    distinct: bool = False
    order_by: list[OrderItem] = field(default_factory=list)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None
    star: bool = False


@dataclass
class UnwindClause:
    expr: Expr
    variable: str
    # reference-dialect extension: UNWIND ... AS x WHERE pred row filter
    where: Optional[Expr] = None


@dataclass
class CallClause:
    procedure: str
    args: list[Expr]
    yield_items: list[tuple[str, Optional[str]]]  # (name, alias)
    where: Optional[Expr] = None
    yield_star: bool = False
    # standalone-call tail without RETURN (CALL ... YIELD ... LIMIT n)
    order_by: list["OrderItem"] = field(default_factory=list)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclass
class CallSubquery:
    query: "Query"
    imported: list[str] = field(default_factory=list)
    # CALL { ... } IN TRANSACTIONS [OF n ROWS]
    in_transactions: bool = False
    batch_rows: int = 1000
    # reference-dialect tail without RETURN (CALL { ... } ORDER BY ...)
    order_by: list["OrderItem"] = field(default_factory=list)
    skip: Optional["Expr"] = None
    limit: Optional["Expr"] = None


@dataclass
class ForeachClause:
    variable: str
    expr: Expr
    updates: list[Any] = field(default_factory=list)


@dataclass
class LoadCsvClause:
    url: Expr
    variable: str
    with_headers: bool = False
    field_terminator: str = ","


Clause = Union[
    MatchClause, CreateClause, MergeClause, SetClause, RemoveClause,
    DeleteClause, WithClause, ReturnClause, UnwindClause, CallClause,
    CallSubquery, ForeachClause, LoadCsvClause,
]


@dataclass
class Query:
    clauses: list[Clause]
    # UNION chains: list of (query, all) appended to this one
    unions: list[tuple["Query", bool]] = field(default_factory=list)
    explain: bool = False
    profile: bool = False


_UPDATING_CLAUSES = (
    CreateClause, MergeClause, SetClause, RemoveClause, DeleteClause,
    ForeachClause, LoadCsvClause,
)

# procedures known to be pure reads; every other CALL is treated as updating.
# Shared with the executor's read/write classification so the parse-time
# COLLECT gate and RBAC/cacheability never disagree on what counts as a write.
READONLY_PROCEDURES = (
    "db.labels", "db.relationshiptypes", "db.propertykeys",
    "dbms.components", "db.index.vector.querynodes",
    "db.index.vector.queryrelationships",
    "db.index.fulltext.querynodes",
    "db.index.fulltext.queryrelationships", "apoc.help",
    # every gds.* STREAM procedure is read-only; the graph catalog is not
    # (see MUTATING_PROCEDURE_EXCEPTIONS)
    "gds.",
    # read-only graph scans/traversals; NOT apoc.lock./apoc.export. etc. —
    # side-effectful-but-non-mutating procedures must stay write-classified
    # or the cache would skip their side effects on repeat calls
    "apoc.search.", "apoc.path.", "apoc.meta.",
    "apoc.schema.nodes", "apoc.schema.relationships",
)

# procedures under a read-only prefix that DO mutate state — classified as
# writes so the result cache never serves a stale catalog and RBAC treats
# them as writes (gds.graph.project registers, drop removes)
MUTATING_PROCEDURE_EXCEPTIONS = ("gds.graph.project", "gds.graph.drop")


def procedure_is_readonly(name: str) -> bool:
    name = name.lower()
    if name.startswith(MUTATING_PROCEDURE_EXCEPTIONS):
        return False
    return name.startswith(READONLY_PROCEDURES)


def has_updating_clause(q: "Query") -> bool:
    """True if the query (or a nested CALL { } subquery / UNION branch)
    contains an updating clause, including CALLs of procedures not known to
    be read-only. Used to reject writes where Neo4j forbids them
    (COLLECT { } subqueries) and to keep read/write classification honest
    for expression-level subqueries."""
    for c in q.clauses:
        if isinstance(c, _UPDATING_CLAUSES):
            return True
        if isinstance(c, CallClause) and not procedure_is_readonly(
            c.procedure
        ):
            return True
        if isinstance(c, CallSubquery) and has_updating_clause(c.query):
            return True
    return any(has_updating_clause(sub) for sub, _ in q.unions)


# ---------------------------------------------------------------- DDL / admin
@dataclass
class CreateIndex:
    name: Optional[str]
    kind: str  # property/composite/vector/fulltext/range/text
    label: str
    properties: list[str]
    options: dict[str, Any] = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class DropIndex:
    name: str
    if_exists: bool = False


@dataclass
class CreateConstraint:
    name: Optional[str]
    label: str
    properties: list[str]
    kind: str = "unique"
    if_not_exists: bool = False


@dataclass
class DropConstraint:
    name: str
    if_exists: bool = False


@dataclass
class ShowCommand:
    what: str  # indexes/constraints/databases/procedures/functions
    yield_items: list[str] = field(default_factory=list)
    target: Optional[str] = None  # SHOW ALIASES FOR DATABASE <target>


@dataclass
class DatabaseCommand:
    op: str  # create/drop/start/stop/alias...
    name: str
    if_not_exists: bool = False
    if_exists: bool = False
    options: dict[str, Any] = field(default_factory=dict)


@dataclass
class UseCommand:
    database: str
    query: Optional[Query] = None


@dataclass
class TxCommand:
    op: str  # begin/commit/rollback


Statement = Union[
    Query, CreateIndex, DropIndex, CreateConstraint, DropConstraint,
    ShowCommand, DatabaseCommand, UseCommand, TxCommand,
]


def expr_text(e: Expr) -> str:
    """Render an expression back to a column-name-ish string."""
    if isinstance(e, Variable):
        return e.name
    if isinstance(e, Property):
        return f"{expr_text(e.subject)}.{e.key}"
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, Parameter):
        return f"${e.name}"
    if isinstance(e, FunctionCall):
        inner = ", ".join(expr_text(a) for a in e.args)
        d = "DISTINCT " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    if isinstance(e, BinaryOp):
        return f"{expr_text(e.left)} {e.op} {expr_text(e.right)}"
    if isinstance(e, UnaryOp):
        return f"{e.op} {expr_text(e.operand)}"
    if isinstance(e, CountSubquery):
        return "COUNT { ... }"
    if isinstance(e, ExistsSubquery):
        return "EXISTS { ... }"
    return type(e).__name__.lower()
