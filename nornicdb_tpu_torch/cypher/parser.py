"""Cypher recursive-descent parser.

Produces the AST in nornicdb_tpu_torch.cypher.ast. Grammar coverage tracks the
reference's executor surface (upstream NornicDB pkg/cypher/executor.go routing
switch :1153-1447): MATCH/OPTIONAL MATCH/WHERE/RETURN/WITH/UNWIND/CREATE/
MERGE/SET/REMOVE/DELETE/DETACH DELETE/ORDER BY/SKIP/LIMIT/UNION/CALL
(procedures + subqueries)/FOREACH/CASE/EXISTS/COUNT subqueries/shortestPath/
var-length paths/parameters/list+map literals/comprehensions, plus DDL
(CREATE/DROP INDEX|CONSTRAINT, vector/fulltext index options), SHOW commands,
multi-database commands and transaction keywords.
"""

from __future__ import annotations

import threading

from typing import Any, Optional, Union

from nornicdb_tpu_torch.cypher import ast
from nornicdb_tpu_torch.cypher.lexer import Token, tokenize
from nornicdb_tpu_torch.errors import CypherSyntaxError


class Parser:
    def __init__(self, query: str):
        self.tokens = tokenize(query)
        self.pos = 0
        self.src = query

    # -- token helpers -------------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def peek(self, offset: int = 1) -> Token:
        i = min(self.pos + offset, len(self.tokens) - 1)
        return self.tokens[i]

    def advance(self) -> Token:
        t = self.cur
        if t.kind != "EOF":
            self.pos += 1
        return t

    def at_kw(self, *words: str) -> bool:
        return self.cur.kind == "KEYWORD" and self.cur.value in words

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "OP" and self.cur.value in ops

    def accept_kw(self, *words: str) -> Optional[Token]:
        if self.at_kw(*words):
            return self.advance()
        return None

    def accept_op(self, *ops: str) -> Optional[Token]:
        if self.at_op(*ops):
            return self.advance()
        return None

    def expect_kw(self, word: str) -> Token:
        if not self.at_kw(word):
            raise self.error(f"expected {word}, got {self.cur.value or 'EOF'}")
        return self.advance()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise self.error(f"expected {op!r}, got {self.cur.value or 'EOF'}")
        return self.advance()

    def expect_ident(self) -> str:
        # keywords usable as identifiers in non-reserved positions
        if self.cur.kind == "IDENT":
            return self.advance().value
        if self.cur.kind == "KEYWORD":
            return self.advance().value.lower()
        raise self.error(f"expected identifier, got {self.cur.value or 'EOF'}")

    def error(self, msg: str) -> CypherSyntaxError:
        return CypherSyntaxError(
            f"{msg} (line {self.cur.line}, pos {self.cur.pos})",
            self.cur.pos,
            self.cur.line,
        )

    # -- entry ----------------------------------------------------------------
    def parse(self) -> ast.Statement:
        explain = profile = False
        if self.accept_kw("EXPLAIN"):
            explain = True
        elif self.accept_kw("PROFILE"):
            profile = True

        stmt = self.parse_statement()
        if isinstance(stmt, ast.Query):
            stmt.explain = explain
            stmt.profile = profile
        self.accept_op(";")
        if self.cur.kind != "EOF":
            raise self.error(f"unexpected trailing input: {self.cur.value!r}")
        return stmt

    def parse_statement(self) -> ast.Statement:
        if self.at_kw("BEGIN"):
            self.advance()
            return ast.TxCommand("begin")
        if self.at_kw("COMMIT"):
            self.advance()
            return ast.TxCommand("commit")
        if self.at_kw("ROLLBACK"):
            self.advance()
            return ast.TxCommand("rollback")
        if self.at_kw("USE"):
            return self.parse_use()
        if self.at_kw("SHOW"):
            return self.parse_show()
        if self.at_kw("CREATE") and self.peek().kind == "KEYWORD" and self.peek().value in (
            "INDEX", "CONSTRAINT", "VECTOR", "FULLTEXT", "RANGE", "TEXT",
            "LOOKUP", "BTREE", "DATABASE", "COMPOSITE", "ALIAS", "OR",
        ):
            return self.parse_ddl_create()
        if self.at_kw("ALTER"):
            return self.parse_alter()
        if self.at_kw("DROP"):
            return self.parse_ddl_drop()
        return self.parse_query()

    def parse_alter(self) -> ast.DatabaseCommand:
        """ALTER COMPOSITE DATABASE name ADD|DROP ALIAS a [FOR DATABASE t]
        and ALTER DATABASE name SET LIMIT k = v[, k = v] (ref: composite
        management pkg/multidb/composite.go; limits DDL
        system_commands_test.go:423-486)."""
        self.expect_kw("ALTER")
        if self.at_kw("DATABASE"):
            self.advance()
            name = self.expect_ident()
            self.expect_kw("SET")
            self.expect_ident_value("limit")
            limits: dict[str, float] = {}
            while True:
                key = self.expect_ident()
                self.expect_op("=")
                tok = self.cur
                if tok.kind != "NUMBER":
                    raise self.error("limit value must be a number")
                self.advance()
                value = float(tok.value)
                # duration suffix: 60s / 5m lexes as NUMBER then IDENT
                if self.cur.kind == "IDENT" and self.cur.value in ("s", "m", "h"):
                    value *= {"s": 1, "m": 60, "h": 3600}[self.advance().value]
                limits[key] = value
                if not self.accept_op(","):
                    break
            return ast.DatabaseCommand("set_limits", name,
                                       options={"limits": limits})
        self.expect_kw("COMPOSITE")
        self.expect_kw("DATABASE")
        name = self.expect_ident()
        if self.accept_kw("ADD"):
            self.expect_kw("ALIAS")
            alias = self.expect_ident()
            self.expect_kw("FOR")
            self.expect_kw("DATABASE")
            target = self.expect_ident()
            return ast.DatabaseCommand(
                "composite_add_alias", name,
                options={"alias": alias, "target": target},
            )
        self.expect_kw("DROP")
        self.expect_kw("ALIAS")
        alias = self.expect_ident()
        return ast.DatabaseCommand(
            "composite_drop_alias", name, options={"alias": alias}
        )

    # -- USE / SHOW / DDL ------------------------------------------------------
    def parse_use(self) -> ast.UseCommand:
        self.expect_kw("USE")
        name = self.expect_ident()
        while self.accept_op("."):
            name += "." + self.expect_ident()
        if self.cur.kind == "EOF" or self.at_op(";"):
            return ast.UseCommand(name)
        q = self.parse_query()
        return ast.UseCommand(name, q)

    def parse_show(self) -> ast.ShowCommand:
        self.expect_kw("SHOW")
        if self.at_kw("INDEX", "INDEXES", "BTREE", "RANGE", "FULLTEXT", "VECTOR",
                      "LOOKUP", "TEXT"):
            kind = self.advance().value
            self.accept_kw("INDEX", "INDEXES")
            return ast.ShowCommand("indexes")
        if self.at_kw("CONSTRAINT", "CONSTRAINTS", "UNIQUE"):
            self.advance()
            self.accept_kw("CONSTRAINT", "CONSTRAINTS")
            return ast.ShowCommand("constraints")
        if self.at_kw("DATABASE", "DATABASES"):
            self.advance()
            return ast.ShowCommand("databases")
        if self.at_kw("PROCEDURES"):
            self.advance()
            return ast.ShowCommand("procedures")
        if self.at_kw("FUNCTIONS"):
            self.advance()
            return ast.ShowCommand("functions")
        if self.at_kw("ALIAS", "ALIASES"):
            self.advance()
            target = None
            if self.accept_kw("FOR"):
                self.accept_kw("DATABASE", "DATABASES")
                if self.cur.kind == "IDENT":
                    # SHOW ALIASES FOR DATABASE tenant_a: scope to one target
                    target = self.advance().value
            return ast.ShowCommand("aliases", target=target)
        if self.accept_ident_value("limits"):
            # SHOW LIMITS FOR DATABASE name (system_commands_test.go:509)
            self.expect_kw("FOR")
            self.expect_kw("DATABASE")
            return ast.ShowCommand("limits", target=self.expect_ident())
        raise self.error("unsupported SHOW target")

    def parse_ddl_create(self) -> ast.Statement:
        self.expect_kw("CREATE")
        if_not = False
        # CREATE OR REPLACE (treated as if-not-exists for idempotence)
        if self.accept_kw("OR"):
            self.expect_ident_value("replace")
            if_not = True
        if self.at_kw("DATABASE"):
            self.advance()
            name = self.expect_ident()
            if self.accept_kw("IF"):
                self.expect_kw("NOT")
                self.expect_ident_value("exists")
                if_not = True
            return ast.DatabaseCommand("create", name, if_not_exists=if_not)
        if self.at_kw("COMPOSITE"):
            self.advance()
            self.expect_kw("DATABASE")
            name = self.expect_ident()
            return ast.DatabaseCommand("create_composite", name, if_not_exists=if_not)
        if self.at_kw("ALIAS"):
            self.advance()
            name = self.expect_ident()
            self.expect_kw("FOR")
            self.expect_kw("DATABASE")
            target = self.expect_ident()
            return ast.DatabaseCommand("create_alias", name, options={"target": target})
        kind = "property"
        if self.at_kw("VECTOR", "FULLTEXT", "RANGE", "TEXT", "LOOKUP", "BTREE"):
            kind = self.advance().value.lower()
            if kind in ("btree", "lookup"):
                kind = "range"
        if self.at_kw("CONSTRAINT"):
            return self.parse_create_constraint(if_not)
        self.expect_kw("INDEX")
        name = None
        if self.cur.kind == "IDENT":
            name = self.advance().value
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_ident_value("exists")
            if_not = True
        self.expect_kw("FOR")
        self.expect_op("(")
        var = self.expect_ident()
        self.expect_op(":")
        label = self.expect_ident()
        self.expect_op(")")
        self.expect_kw("ON")
        # ON EACH [n.prop, ...] for fulltext (Neo4j bracket form);
        # ON (n.prop, ...) otherwise — both delimiters accepted for both
        self.accept_ident_value("each")
        if self.at_op("["):
            self.advance()
            closer = "]"
        else:
            self.expect_op("(")
            closer = ")"
        props = []
        while True:
            v = self.expect_ident()
            self.expect_op(".")
            props.append(self.expect_ident())
            if not self.accept_op(","):
                break
        self.expect_op(closer)
        options: dict[str, Any] = {}
        if self.accept_kw("OPTIONS"):
            m = self.parse_map_literal()
            options = _literal_map(m)
        if kind == "property" and len(props) > 1:
            kind = "composite"
        if name is None:
            name = f"{kind}_{label}_{'_'.join(props)}".lower()
        return ast.CreateIndex(name, kind, label, props, options, if_not)

    def expect_ident_value(self, value: str) -> None:
        t = self.advance()
        if t.value.lower() != value:
            raise self.error(f"expected {value!r}")

    def accept_ident_value(self, value: str) -> bool:
        if self.cur.kind == "IDENT" and self.cur.value.lower() == value:
            self.advance()
            return True
        return False

    def parse_create_constraint(self, if_not: bool) -> ast.CreateConstraint:
        self.expect_kw("CONSTRAINT")
        name = None
        if self.cur.kind == "IDENT":
            name = self.advance().value
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not = True
        # legacy Neo4j 3.x/4.x form (ref: mimir_queries_test.go,
        # chaos_injection_test.go): CREATE CONSTRAINT [IF NOT EXISTS]
        # ON (n:Label) ASSERT n.prop IS UNIQUE
        legacy = self.accept_kw("ON")
        if not legacy:
            self.expect_kw("FOR")
        self.expect_op("(")
        self.expect_ident()
        self.expect_op(":")
        label = self.expect_ident()
        self.expect_op(")")
        if legacy:
            self.expect_ident_value("assert")
        else:
            self.expect_kw("REQUIRE")
        props = []
        if self.accept_op("("):
            while True:
                self.expect_ident()
                self.expect_op(".")
                props.append(self.expect_ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        else:
            self.expect_ident()
            self.expect_op(".")
            props.append(self.expect_ident())
        self.expect_kw("IS")
        self.expect_kw("UNIQUE")
        if name is None:
            name = f"uq_{label}_{'_'.join(props)}".lower()
        return ast.CreateConstraint(name, label, props, "unique", if_not)

    def parse_ddl_drop(self) -> ast.Statement:
        self.expect_kw("DROP")
        if self.at_kw("DATABASE"):
            self.advance()
            name = self.expect_ident()
            if_e = False
            if self.accept_kw("IF"):
                self.expect_ident_value("exists")
                if_e = True
            return ast.DatabaseCommand("drop", name, if_exists=if_e)
        if self.at_kw("ALIAS"):
            self.advance()
            name = self.expect_ident()
            if_e = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_e = True
            self.accept_kw("FOR")
            self.accept_kw("DATABASE")
            return ast.DatabaseCommand("drop_alias", name, if_exists=if_e)
        if self.at_kw("INDEX"):
            self.advance()
            name = self.expect_ident()
            if_e = False
            if self.accept_kw("IF"):
                self.expect_ident_value("exists")
                if_e = True
            return ast.DropIndex(name, if_e)
        if self.at_kw("CONSTRAINT"):
            self.advance()
            name = self.expect_ident()
            if_e = False
            if self.accept_kw("IF"):
                self.expect_ident_value("exists")
                if_e = True
            return ast.DropConstraint(name, if_e)
        raise self.error("unsupported DROP target")

    # -- query ------------------------------------------------------------------
    def parse_query(self) -> ast.Query:
        clauses: list[ast.Clause] = []
        while True:
            c = self.parse_clause()
            if c is None:
                break
            clauses.append(c)
        if not clauses:
            raise self.error("empty query")
        q = ast.Query(clauses)
        while self.at_kw("UNION"):
            self.advance()
            all_ = bool(self.accept_kw("ALL"))
            q.unions.append((self.parse_query(), all_))
        return q

    def parse_clause(self) -> Optional[ast.Clause]:
        if self.at_kw("MATCH"):
            return self.parse_match(False)
        if self.at_kw("OPTIONAL"):
            self.advance()
            self.expect_kw("MATCH")
            return self.parse_match(True, consumed=True)
        if self.at_kw("CREATE"):
            self.advance()
            return ast.CreateClause(self.parse_patterns())
        if self.at_kw("MERGE"):
            return self.parse_merge()
        if self.at_kw("SET"):
            self.advance()
            return ast.SetClause(self.parse_set_items())
        if self.at_kw("REMOVE"):
            self.advance()
            return ast.RemoveClause(self.parse_remove_items())
        if self.at_kw("DELETE"):
            self.advance()
            return self.parse_delete(False)
        if self.at_kw("DETACH"):
            self.advance()
            self.expect_kw("DELETE")
            return self.parse_delete(True)
        if self.at_kw("WITH"):
            return self.parse_with()
        if self.at_kw("RETURN"):
            return self.parse_return()
        if self.at_kw("UNWIND"):
            self.advance()
            expr = self.parse_expr()
            self.expect_kw("AS")
            var = self.expect_ident()
            where = None
            if self.accept_kw("WHERE"):
                # UNWIND ... WHERE: reference-dialect extension used by
                # the Mimir workloads (a row filter on the unwound var)
                where = self.parse_expr()
            return ast.UnwindClause(expr, var, where)
        if self.at_kw("CALL"):
            return self.parse_call()
        if self.at_kw("FOREACH"):
            return self.parse_foreach()
        if self.at_kw("LOAD"):
            return self.parse_load_csv()
        return None

    def parse_match(self, optional: bool, consumed: bool = False) -> ast.MatchClause:
        if not consumed:
            self.expect_kw("MATCH")
        patterns = self.parse_patterns()
        # planner hints (ref: index_hints_test.go): parsed for compatibility,
        # then discarded — this executor picks columnar/index paths itself
        while self.accept_ident_value("using"):
            if self.accept_kw("INDEX"):
                self.accept_ident_value("seek")
                self.expect_ident()
                self.expect_op(":")
                self.expect_ident()
                self.expect_op("(")
                self.expect_ident()
                while self.accept_op(","):
                    self.expect_ident()
                self.expect_op(")")
            elif self.accept_ident_value("scan"):
                self.expect_ident()
                self.expect_op(":")
                self.expect_ident()
            elif self.accept_ident_value("join"):
                self.expect_kw("ON")
                self.expect_ident()
                while self.accept_op(","):
                    self.expect_ident()
            else:
                raise self.error("expected INDEX, SCAN or JOIN after USING")
        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()
        return ast.MatchClause(patterns, optional, where)

    def parse_merge(self) -> ast.MergeClause:
        self.expect_kw("MERGE")
        pattern = self.parse_pattern_path()
        on_create: list[ast.SetItem] = []
        on_match: list[ast.SetItem] = []
        while self.at_kw("ON"):
            self.advance()
            if self.accept_kw("CREATE"):
                self.expect_kw("SET")
                on_create.extend(self.parse_set_items())
            elif self.accept_kw("MATCH"):
                self.expect_kw("SET")
                on_match.extend(self.parse_set_items())
            else:
                raise self.error("expected ON CREATE or ON MATCH")
        return ast.MergeClause(pattern, on_create, on_match)

    def parse_delete(self, detach: bool) -> ast.DeleteClause:
        exprs = [self.parse_expr()]
        while self.accept_op(","):
            exprs.append(self.parse_expr())
        return ast.DeleteClause(exprs, detach)

    def parse_set_items(self) -> list[ast.SetItem]:
        items = [self.parse_set_item()]
        while self.accept_op(","):
            items.append(self.parse_set_item())
        return items

    def parse_set_item(self) -> ast.SetItem:
        # a:Label(:Label2)* | a.prop = expr | a = expr | a += expr
        start = self.pos
        name = self.expect_ident()
        if self.at_op(":"):
            labels = []
            while self.accept_op(":"):
                labels.append(self.expect_ident())
            return ast.SetItem("label", ast.Variable(name), labels=labels)
        if self.accept_op("."):
            key = self.expect_ident()
            target = ast.Property(ast.Variable(name), key)
            # nested property paths are not supported; single level like Neo4j
            self.expect_op("=")
            return ast.SetItem("property", target, self.parse_expr())
        if self.accept_op("+="):
            return ast.SetItem("variable", ast.Variable(name), self.parse_expr(), merge=True)
        if self.accept_op("="):
            return ast.SetItem("variable", ast.Variable(name), self.parse_expr())
        self.pos = start
        raise self.error("invalid SET item")

    def parse_remove_items(self) -> list[ast.SetItem]:
        items = []
        while True:
            name = self.expect_ident()
            if self.at_op(":"):
                labels = []
                while self.accept_op(":"):
                    labels.append(self.expect_ident())
                items.append(ast.SetItem("label", ast.Variable(name), labels=labels))
            else:
                self.expect_op(".")
                key = self.expect_ident()
                items.append(
                    ast.SetItem("property", ast.Property(ast.Variable(name), key))
                )
            if not self.accept_op(","):
                break
        return items

    def parse_with(self) -> ast.WithClause:
        self.expect_kw("WITH")
        distinct = bool(self.accept_kw("DISTINCT"))
        star = False
        items: list[ast.ReturnItem] = []
        if self.accept_op("*"):
            star = True
            while self.accept_op(","):
                items.append(self.parse_return_item())
        else:
            items.append(self.parse_return_item())
            while self.accept_op(","):
                items.append(self.parse_return_item())
        order_by, skip, limit = self.parse_order_skip_limit()
        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()
        return ast.WithClause(items, distinct, order_by, skip, limit, where, star)

    def parse_return(self) -> ast.ReturnClause:
        self.expect_kw("RETURN")
        distinct = bool(self.accept_kw("DISTINCT"))
        star = False
        items: list[ast.ReturnItem] = []
        if self.accept_op("*"):
            star = True
            while self.accept_op(","):
                items.append(self.parse_return_item())
        else:
            items.append(self.parse_return_item())
            while self.accept_op(","):
                items.append(self.parse_return_item())
        order_by, skip, limit = self.parse_order_skip_limit()
        return ast.ReturnClause(items, distinct, order_by, skip, limit, star)

    def parse_return_item(self) -> ast.ReturnItem:
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect_ident()
        return ast.ReturnItem(expr, alias)

    def parse_order_skip_limit(self):
        order_by: list[ast.OrderItem] = []
        skip = limit = None
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("DESC", "DESCENDING"):
                    desc = True
                elif self.accept_kw("ASC", "ASCENDING"):
                    pass
                order_by.append(ast.OrderItem(e, desc))
                if not self.accept_op(","):
                    break
        if self.accept_kw("SKIP"):
            skip = self.parse_expr()
        if self.accept_kw("LIMIT"):
            limit = self.parse_expr()
        return order_by, skip, limit

    def parse_call(self) -> Union[ast.CallClause, ast.CallSubquery]:
        self.expect_kw("CALL")
        if self.at_op("{"):
            self.advance()
            inner = self.parse_query()
            self.expect_op("}")
            sub = ast.CallSubquery(inner)
            # CALL { ... } IN TRANSACTIONS [OF n ROWS]
            if self.accept_kw("IN"):
                self.expect_ident_value("transactions")
                sub.in_transactions = True
                if self.cur.kind == "KEYWORD" and self.cur.value == "OF":
                    self.advance()
                    if self.cur.kind == "NUMBER":
                        sub.batch_rows = int(self.advance().value)
                    self.expect_ident_value("rows")
                elif self.cur.kind == "IDENT" and self.cur.value.lower() == "of":
                    self.advance()
                    if self.cur.kind == "NUMBER":
                        sub.batch_rows = int(self.advance().value)
                    self.expect_ident_value("rows")
            # reference-dialect tail: CALL { ... } ORDER BY/SKIP/LIMIT
            # applied to the subquery's output rows without a RETURN
            if self.at_kw("ORDER", "SKIP", "LIMIT"):
                sub.order_by, sub.skip, sub.limit = \
                    self.parse_order_skip_limit()
            return sub
        name = self.expect_ident()
        while self.accept_op("."):
            name += "." + self.expect_ident()
        args: list[ast.Expr] = []
        if self.accept_op("("):
            if not self.at_op(")"):
                if (
                    self.cur.kind == "IDENT"
                    and self.peek().kind == "OP"
                    and self.peek().value == ":"
                ):
                    # named-argument form CALL p(key: v, ...) — reference
                    # dialect for gds.* config; folds into one map arg
                    items: dict[str, ast.Expr] = {}
                    while True:
                        key = self.expect_ident()
                        self.expect_op(":")
                        items[key] = self.parse_expr()
                        if not self.accept_op(","):
                            break
                    args.append(ast.MapLiteral(items))
                else:
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
            self.expect_op(")")
        yields: list[tuple[str, Optional[str]]] = []
        ystar = False
        where = None
        if self.accept_kw("YIELD"):
            if self.accept_op("*"):
                ystar = True
            else:
                while True:
                    y = self.expect_ident()
                    alias = None
                    if self.accept_kw("AS"):
                        alias = self.expect_ident()
                    yields.append((y, alias))
                    if not self.accept_op(","):
                        break
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
        call = ast.CallClause(name.lower(), args, yields, where, ystar)
        # standalone-call tail: CALL ... YIELD ... [ORDER BY][SKIP][LIMIT]
        # without a RETURN (used by the reference's fulltext tests)
        if (ystar or yields) and self.at_kw("ORDER", "SKIP", "LIMIT"):
            call.order_by, call.skip, call.limit = self.parse_order_skip_limit()
        return call

    def parse_foreach(self) -> ast.ForeachClause:
        self.expect_kw("FOREACH")
        self.expect_op("(")
        var = self.expect_ident()
        self.expect_kw("IN")
        expr = self.parse_expr()
        self.expect_op("|")
        updates: list[ast.Clause] = []
        while not self.at_op(")"):
            c = self.parse_clause()
            if c is None:
                break
            updates.append(c)
        self.expect_op(")")
        return ast.ForeachClause(var, expr, updates)

    def parse_load_csv(self) -> ast.LoadCsvClause:
        self.expect_kw("LOAD")
        self.expect_kw("CSV")
        with_headers = False
        if self.accept_kw("WITH"):
            self.expect_kw("HEADERS")
            with_headers = True
        self.expect_kw("FROM")
        url = self.parse_expr()
        self.expect_kw("AS")
        var = self.expect_ident()
        term = ","
        if self.cur.kind == "IDENT" and self.cur.value.lower() == "fieldterminator":
            self.advance()
            t = self.advance()
            term = t.value
        return ast.LoadCsvClause(url, var, with_headers, term)

    # -- patterns ---------------------------------------------------------------
    def parse_patterns(self) -> list[ast.PatternPath]:
        pats = [self.parse_pattern_path()]
        while self.accept_op(","):
            pats.append(self.parse_pattern_path())
        return pats

    def parse_pattern_path(self) -> ast.PatternPath:
        name = None
        shortest = None
        if (
            self.cur.kind == "IDENT"
            and self.peek().kind == "OP"
            and self.peek().value == "="
            and self.peek(2).kind in ("OP", "KEYWORD")
            and (self.peek(2).value == "(" or self.peek(2).value in ("SHORTESTPATH", "ALLSHORTESTPATHS"))
        ):
            name = self.advance().value
            self.advance()  # =
        if self.at_kw("SHORTESTPATH", "ALLSHORTESTPATHS"):
            shortest = "shortest" if self.cur.value == "SHORTESTPATH" else "allshortest"
            self.advance()
            self.expect_op("(")
            path = self._parse_path_elements()
            self.expect_op(")")
            path.name = name
            path.shortest = shortest
            return path
        path = self._parse_path_elements()
        path.name = name
        return path

    def _parse_path_elements(self) -> ast.PatternPath:
        elements: list[Union[ast.NodePattern, ast.RelPattern]] = [self.parse_node_pattern()]
        while self.at_op("-", "<-") or self.at_op("<"):
            rel = self.parse_rel_pattern()
            node = self.parse_node_pattern()
            elements.append(rel)
            elements.append(node)
        return ast.PatternPath(elements)

    def parse_node_pattern(self) -> ast.NodePattern:
        self.expect_op("(")
        var = None
        labels: list[str] = []
        props = None
        if self.cur.kind == "IDENT" or (
            self.cur.kind == "KEYWORD" and self.peek().kind == "OP"
            and self.peek().value in (":", ")", "{")
        ):
            var = self.expect_ident()
        while self.accept_op(":"):
            labels.append(self.expect_ident())
            # label disjunction a:X|Y — treat as multiple labels (any)
            while self.accept_op("|"):
                labels.append(self.expect_ident())
        if self.at_op("{"):
            props = self.parse_map_literal()
        if self.cur.kind == "PARAM":  # (n $props)
            props = ast.MapLiteral({"__param__": ast.Parameter(self.advance().value)})
        where = None
        if self.accept_kw("WHERE"):  # inline predicate: (n:L WHERE n.x > 1)
            where = self.parse_expr()
        self.expect_op(")")
        return ast.NodePattern(var, labels, props, where)

    def parse_rel_pattern(self) -> ast.RelPattern:
        direction = "both"
        if self.accept_op("<-"):
            direction = "in"
        elif self.at_op("<"):
            self.advance()
            self.expect_op("-")
            direction = "in"
        else:
            self.expect_op("-")
        var = None
        types: list[str] = []
        props = None
        min_h, max_h, var_len = 1, 1, False
        if self.accept_op("["):
            if self.cur.kind in ("IDENT",) or (
                self.cur.kind == "KEYWORD" and self.peek().value in (":", "]", "*", "{")
            ):
                var = self.expect_ident()
            if self.accept_op(":"):
                types.append(self.expect_ident())
                while self.accept_op("|"):
                    self.accept_op(":")
                    types.append(self.expect_ident())
            if self.accept_op("*"):
                var_len = True
                min_h, max_h = 1, 15  # default bound (ref traversal caps depth)
                if self.cur.kind == "NUMBER":
                    min_h = int(self.advance().value)
                    max_h = min_h
                    if self.accept_op(".."):
                        if self.cur.kind == "NUMBER":
                            max_h = int(self.advance().value)
                        else:
                            max_h = 15
                elif self.accept_op(".."):
                    min_h = 0 if False else 1
                    if self.cur.kind == "NUMBER":
                        max_h = int(self.advance().value)
                    else:
                        max_h = 15
            if self.at_op("{"):
                props = self.parse_map_literal()
            self.expect_op("]")
        # closing direction
        if self.accept_op("->"):
            if direction == "in":
                raise self.error("relationship cannot point both ways")
            direction = "out"
        else:
            self.expect_op("-")
        return ast.RelPattern(var, types, props, direction, min_h, max_h, var_len)

    def parse_map_literal(self) -> ast.MapLiteral:
        self.expect_op("{")
        items: dict[str, ast.Expr] = {}
        if not self.at_op("}"):
            while True:
                key = self.expect_ident() if self.cur.kind != "STRING" else self.advance().value
                # dotted config keys (vector.dimensions: 768 — the
                # reference's index OPTIONS maps use them unquoted)
                while self.at_op(".") :
                    self.advance()
                    key += "." + self.expect_ident()
                self.expect_op(":")
                items[key] = self.parse_expr()
                if not self.accept_op(","):
                    break
        self.expect_op("}")
        return ast.MapLiteral(items)

    # -- expressions (precedence climbing) ---------------------------------------
    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        left = self.parse_xor()
        while self.at_kw("OR"):
            self.advance()
            left = ast.BinaryOp("OR", left, self.parse_xor())
        return left

    def parse_xor(self) -> ast.Expr:
        left = self.parse_and()
        while self.at_kw("XOR"):
            self.advance()
            left = ast.BinaryOp("XOR", left, self.parse_and())
        return left

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        while self.at_kw("AND"):
            self.advance()
            left = ast.BinaryOp("AND", left, self.parse_not())
        return left

    def parse_not(self) -> ast.Expr:
        if self.at_kw("NOT"):
            self.advance()
            return ast.UnaryOp("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", ">", "<=", ">=", "=~"):
                op = self.advance().value
                left = ast.BinaryOp(op, left, self.parse_additive())
            elif self.at_kw("IN"):
                self.advance()
                left = ast.BinaryOp("IN", left, self.parse_additive())
            elif self.at_kw("STARTS"):
                self.advance()
                self.expect_kw("WITH")
                left = ast.BinaryOp("STARTS WITH", left, self.parse_additive())
            elif self.at_kw("ENDS"):
                self.advance()
                self.expect_kw("WITH")
                left = ast.BinaryOp("ENDS WITH", left, self.parse_additive())
            elif self.at_kw("CONTAINS"):
                self.advance()
                left = ast.BinaryOp("CONTAINS", left, self.parse_additive())
            elif self.at_kw("IS"):
                self.advance()
                negated = bool(self.accept_kw("NOT"))
                self.expect_kw("NULL")
                left = ast.IsNull(left, negated)
            else:
                return left

    def parse_additive(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.advance().value
            if op == "||":
                op = "+"
            left = ast.BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_power()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            left = ast.BinaryOp(op, left, self.parse_power())
        return left

    def parse_power(self) -> ast.Expr:
        left = self.parse_unary()
        if self.at_op("^"):
            self.advance()
            return ast.BinaryOp("^", left, self.parse_power())
        return left

    def parse_unary(self) -> ast.Expr:
        if self.at_op("-"):
            self.advance()
            return ast.UnaryOp("-", self.parse_unary())
        if self.at_op("+"):
            self.advance()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        e = self.parse_atom()
        while True:
            # map projection: n {.a, .b, .*, key: expr, other_var}
            if (
                isinstance(e, ast.Variable)
                and self.at_op("{")
                and self.peek().kind == "OP"
                and self.peek().value in (".", "}")
            ):
                e = self.parse_map_projection(e)
                continue
            # label predicate: n:Label[:Label...] as a boolean expression
            # (WHERE p:Employee — Neo4j label expression)
            if (
                isinstance(e, (ast.Variable, ast.LabelPredicate))
                and self.at_op(":")
                and self.peek().kind in ("IDENT", "KEYWORD")
            ):
                self.advance()
                label = self.expect_ident()
                if isinstance(e, ast.LabelPredicate):
                    e.labels.append(label)
                else:
                    e = ast.LabelPredicate(e, [label])
                continue
            if self.at_op("."):
                # property access; but don't eat ".." (range)
                self.advance()
                key = self.expect_ident()
                e = ast.Property(e, key)
            elif self.at_op("["):
                self.advance()
                if self.accept_op(".."):
                    end = None if self.at_op("]") else self.parse_expr()
                    e = ast.Slice(e, None, end)
                else:
                    idx = self.parse_expr()
                    if self.accept_op(".."):
                        end = None if self.at_op("]") else self.parse_expr()
                        e = ast.Slice(e, idx, end)
                    else:
                        e = ast.Subscript(e, idx)
                self.expect_op("]")
            else:
                return e

    def parse_map_projection(self, subject: ast.Variable) -> ast.MapProjection:
        self.expect_op("{")
        items: list[tuple[str, object]] = []
        while not self.at_op("}"):
            if self.accept_op("."):
                if self.accept_op("*"):
                    items.append(("all", None))
                else:
                    items.append(("prop", self.expect_ident()))
            else:
                name = self.expect_ident()
                if self.accept_op(":"):
                    items.append(("alias", (name, self.parse_expr())))
                else:
                    items.append(("var", name))
            if not self.accept_op(","):
                break
        self.expect_op("}")
        return ast.MapProjection(subject, items)

    def try_parse_quantifier(self, kind: str) -> Optional[ast.Quantifier]:
        """all/any/none/single(x IN list WHERE p); rewinds and returns
        None if the parenthesized body isn't quantifier-shaped (then the
        name parses as an ordinary function call)."""
        save = self.pos
        try:
            self.advance()
            self.expect_op("(")
            var = self.expect_ident()
            self.expect_kw("IN")
            src = self.parse_expr()
            self.expect_kw("WHERE")
            pred = self.parse_expr()
            self.expect_op(")")
            return ast.Quantifier(kind, var, src, pred)
        except CypherSyntaxError:
            self.pos = save
            return None

    def parse_atom(self) -> ast.Expr:
        t = self.cur
        if t.kind == "NUMBER":
            self.advance()
            v = t.value
            if v.startswith("0x"):
                return ast.Literal(int(v, 16))
            if "." in v or "e" in v or "E" in v:
                return ast.Literal(float(v))
            return ast.Literal(int(v))
        if t.kind == "STRING":
            self.advance()
            return ast.Literal(t.value)
        if t.kind == "PARAM":
            self.advance()
            return ast.Parameter(t.value)
        if t.kind == "KEYWORD":
            if t.value == "TRUE":
                self.advance()
                return ast.Literal(True)
            if t.value == "FALSE":
                self.advance()
                return ast.Literal(False)
            if t.value == "NULL":
                self.advance()
                return ast.Literal(None)
            if t.value == "CASE":
                return self.parse_case()
            if t.value == "COUNT" and self.peek().value in ("(", "{"):
                # bare `count` stays usable as a variable name — Neo4j allows
                # `WITH count(*) AS count RETURN count ORDER BY count`
                # (ref: documentation_examples_test.go CountByCategory)
                return self.parse_count_atom()
            if t.value == "EXISTS" and self.peek().value in ("(", "{"):
                return self.parse_exists_atom()
            if t.value == "COLLECT" and self.peek().value == "{":
                # COLLECT { MATCH ... RETURN expr } — Neo4j 5 collect
                # subquery (single-column full query -> list)
                self.advance()
                self.expect_op("{")
                inner = self.parse_query()
                self.expect_op("}")
                if ast.has_updating_clause(inner):
                    # Neo4j: "A Collect Expression cannot contain any updating
                    # clauses". Rejecting here also keeps the executor's
                    # read/write classification (RBAC, cacheability) sound.
                    raise self.error(
                        "a COLLECT expression cannot contain updating clauses"
                    )
                return ast.CollectSubquery(inner)
            if t.value == "ALL" and self.peek().value == "(":
                # ALL is a keyword (UNION ALL) but also the all() quantifier
                q = self.try_parse_quantifier("all")
                if q is not None:
                    return q
            if t.value in ("ALL", "NOT"):
                pass  # handled elsewhere
            if t.value == "SHORTESTPATH" or t.value == "ALLSHORTESTPATHS":
                pp = self.parse_pattern_path()
                return ast.PatternPredicate(pp)
            # keyword used as function name / identifier — including dotted
            # namespaces whose head lexes as a keyword (point.x(...),
            # vector.similarity.cosine(...)), same lookahead as the IDENT
            # branch below
            if self.peek().kind == "OP" and self.peek().value in ("(", "."):
                save = self.pos
                name = self.advance().value
                dotted = name
                while self.at_op(".") and self.peek().kind in (
                        "IDENT", "KEYWORD"):
                    self.advance()
                    dotted += "." + self.advance().value
                    if self.at_op("("):
                        break
                    if not self.at_op("."):
                        self.pos = save
                        dotted = None
                        break
                if dotted and self.at_op("("):
                    return self.parse_function_call(dotted.lower())
                self.pos = save
            self.advance()
            return ast.Variable(t.value.lower())
        if t.kind == "IDENT":
            # quantifiers: all/any/none/single(x IN list WHERE p)
            low = t.value.lower()
            if low in ("all", "any", "none", "single") and self.peek().value == "(":
                q = self.try_parse_quantifier(low)
                if q is not None:
                    return q
            # function call (possibly dotted)
            if self.peek().kind == "OP" and self.peek().value in ("(", "."):
                save = self.pos
                name = self.advance().value
                dotted = name
                while self.at_op(".") and self.peek().kind in ("IDENT", "KEYWORD"):
                    # lookahead: only treat as function path if eventually '('
                    save2 = self.pos
                    self.advance()
                    part = self.advance().value
                    dotted += "." + part
                    if self.at_op("("):
                        break
                    if not self.at_op("."):
                        # plain property access chain, rewind fully
                        self.pos = save
                        dotted = None
                        break
                if dotted and self.at_op("("):
                    return self.parse_function_call(dotted.lower())
                self.pos = save
            self.advance()
            return ast.Variable(t.value)
        if t.kind == "OP":
            if t.value == "(":
                # could be a parenthesized expr OR a pattern predicate
                save = self.pos
                try:
                    pp = self._parse_path_elements()
                    if len(pp.elements) > 1:
                        return ast.PatternPredicate(pp)
                    # single node pattern with label/props -> predicate too
                    node = pp.elements[0]
                    if node.labels or node.properties:
                        return ast.PatternPredicate(pp)
                    raise CypherSyntaxError("not a pattern")
                except CypherSyntaxError:
                    self.pos = save
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_op(")")
                return e
            if t.value == "[":
                return self.parse_list_or_comprehension()
            if t.value == "{":
                return self.parse_map_literal()
        raise self.error(f"unexpected token {t.value!r}")

    def parse_function_call(self, name: str) -> ast.Expr:
        if name == "reduce":
            return self.parse_reduce()
        self.expect_op("(")
        distinct = bool(self.accept_kw("DISTINCT"))
        args: list[ast.Expr] = []
        if self.accept_op("*"):
            args.append(ast.Literal("*"))
        elif not self.at_op(")"):
            args.append(self.parse_expr())
            while self.accept_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        return ast.FunctionCall(name, args, distinct)

    def parse_reduce(self) -> ast.ReduceExpr:
        self.expect_op("(")
        acc = self.expect_ident()
        self.expect_op("=")
        init = self.parse_expr()
        self.expect_op(",")
        var = self.expect_ident()
        self.expect_kw("IN")
        src = self.parse_expr()
        self.expect_op("|")
        body = self.parse_expr()
        self.expect_op(")")
        return ast.ReduceExpr(acc, init, var, src, body)

    def parse_case(self) -> ast.CaseExpr:
        self.expect_kw("CASE")
        subject = None
        if not self.at_kw("WHEN"):
            subject = self.parse_expr()
        whens: list[tuple[ast.Expr, ast.Expr]] = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            whens.append((cond, self.parse_expr()))
        default = None
        if self.accept_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        return ast.CaseExpr(subject, whens, default)

    def parse_count_atom(self) -> ast.Expr:
        self.expect_kw("COUNT")
        if self.at_op("{"):
            self.advance()
            self.accept_kw("MATCH")
            pattern = self.parse_pattern_path()
            where = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
            self.expect_op("}")
            return ast.CountSubquery(pattern, where)
        return self.parse_function_call("count")

    def parse_exists_atom(self) -> ast.Expr:
        self.expect_kw("EXISTS")
        if self.at_op("{"):
            self.advance()
            self.accept_kw("MATCH")
            pattern = self.parse_pattern_path()
            where = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
            self.expect_op("}")
            return ast.ExistsSubquery(pattern, where)
        if self.at_op("("):
            # exists(n.prop) legacy or exists((a)-[]->(b)) pattern form
            save = self.pos
            self.advance()
            try:
                pp = self._parse_path_elements()
                self.expect_op(")")
                return ast.ExistsSubquery(pp)
            except CypherSyntaxError:
                self.pos = save
            return self.parse_function_call("exists")
        raise self.error("expected ( or { after EXISTS")

    def parse_list_or_comprehension(self) -> ast.Expr:
        self.expect_op("[")
        if self.at_op("]"):
            self.advance()
            return ast.ListLiteral([])
        # try comprehension: [x IN expr WHERE p | proj]
        save = self.pos
        if self.cur.kind == "IDENT" and self.peek().kind == "KEYWORD" and self.peek().value == "IN":
            var = self.advance().value
            self.advance()  # IN
            src = self.parse_expr()
            where = None
            proj = None
            if self.accept_kw("WHERE"):
                where = self.parse_expr()
            if self.accept_op("|"):
                proj = self.parse_expr()
            self.expect_op("]")
            return ast.ListComprehension(var, src, where, proj)
        self.pos = save
        # pattern comprehension: [(a)-[:R]->(b) WHERE p | expr]
        if self.at_op("("):
            try:
                pattern = self._parse_path_elements()
                if len(pattern.elements) >= 3:  # must include a relationship
                    where = None
                    if self.accept_kw("WHERE"):
                        where = self.parse_expr()
                    self.expect_op("|")
                    proj = self.parse_expr()
                    self.expect_op("]")
                    return ast.PatternComprehension(pattern, where, proj)
                raise CypherSyntaxError("not a pattern comprehension")
            except CypherSyntaxError:
                self.pos = save
        items = [self.parse_expr()]
        while self.accept_op(","):
            items.append(self.parse_expr())
        self.expect_op("]")
        return ast.ListLiteral(items)


def _literal_map(m: ast.MapLiteral) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in m.items.items():
        if isinstance(v, ast.Literal):
            out[k] = v.value
        elif isinstance(v, ast.MapLiteral):
            out[k] = _literal_map(v)
        elif isinstance(v, ast.ListLiteral):
            out[k] = [x.value if isinstance(x, ast.Literal) else None for x in v.items]
    return out


_PARSE_CACHE: dict[str, ast.Statement] = {}
_PARSE_LOCK = threading.Lock()
_PARSE_CACHE_MAX = 512


def parse(query: str) -> ast.Statement:
    """Parse with an AST memo: profiling showed re-parsing was ~87% of
    repeated-query execution time (the result cache still paid a full parse
    per hit). ASTs are execution-immutable — the executor never writes to
    statement nodes — so sharing one tree across executions/threads is
    safe. Eviction is epoch-style (clear at cap): zero bookkeeping on the
    hit path, and a steady workload re-warms in one round."""
    with _PARSE_LOCK:
        hit = _PARSE_CACHE.get(query)
    if hit is not None:
        return hit
    stmt = Parser(query).parse()
    with _PARSE_LOCK:
        if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[query] = stmt
    return stmt
