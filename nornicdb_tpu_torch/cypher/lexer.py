"""Cypher lexer.

The reference routes queries by keyword scanning with an opt-in ANTLR
validator (upstream NornicDB pkg/cypher/executor.go:1153-1447,
docs/architecture/cypher-parser-modes.md). This build uses a real
lexer -> recursive-descent parser -> AST -> executor (SURVEY.md §7 design
stance: "build a small real parser ... reusing the reference's behavior").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from nornicdb_tpu_torch.errors import CypherSyntaxError

KEYWORDS = {
    "MATCH", "OPTIONAL", "WHERE", "RETURN", "CREATE", "MERGE", "SET", "REMOVE",
    "DELETE", "DETACH", "WITH", "UNWIND", "AS", "ORDER", "BY", "SKIP", "LIMIT",
    "ASC", "ASCENDING", "DESC", "DESCENDING", "DISTINCT", "AND", "OR", "XOR",
    "NOT", "IN", "STARTS", "ENDS", "CONTAINS", "IS", "NULL", "TRUE", "FALSE",
    "CALL", "YIELD", "UNION", "ALL", "ON", "CASE", "WHEN", "THEN", "ELSE",
    "END", "EXISTS", "COUNT", "FOREACH", "LOAD", "CSV", "FROM", "HEADERS",
    "INDEX", "CONSTRAINT", "DROP", "SHOW", "DATABASE", "DATABASES", "USE",
    "IF", "FOR", "REQUIRE", "UNIQUE", "VECTOR", "FULLTEXT", "RANGE", "TEXT",
    "POINT", "LOOKUP", "BTREE", "BEGIN", "COMMIT", "ROLLBACK", "EXPLAIN",
    "PROFILE", "INDEXES", "CONSTRAINTS", "PROCEDURES", "FUNCTIONS", "ALIAS",
    "ALIASES", "COMPOSITE", "SHORTESTPATH", "ALLSHORTESTPATHS", "OPTIONS",
    "ALTER", "ADD", "COLLECT",
}


@dataclass
class Token:
    kind: str  # KEYWORD, IDENT, STRING, NUMBER, PARAM, OP, EOF
    value: str
    pos: int
    line: int

    def __repr__(self) -> str:
        return f"{self.kind}:{self.value}"


_MULTI_OPS = ["<>", "<=", ">=", "=~", "->", "<-", "..", "+=", "||", "!="]
_SINGLE_OPS = "()[]{}.,:;|=<>+-*/%^"


def tokenize(query: str) -> list[Token]:
    tokens: list[Token] = []
    i = 0
    n = len(query)
    line = 1
    while i < n:
        c = query[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c.isspace():
            i += 1
            continue
        # comments
        if c == "/" and i + 1 < n and query[i + 1] == "/":
            while i < n and query[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and query[i + 1] == "*":
            end = query.find("*/", i + 2)
            if end == -1:
                raise CypherSyntaxError("unterminated block comment", i, line)
            line += query.count("\n", i, end)
            i = end + 2
            continue
        # strings
        if c in ("'", '"'):
            j = i + 1
            buf = []
            while j < n:
                if query[j] == "\\" and j + 1 < n:
                    esc = query[j + 1]
                    buf.append(
                        {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'", '"': '"'}.get(esc, esc)
                    )
                    j += 2
                    continue
                if query[j] == c:
                    break
                buf.append(query[j])
                j += 1
            if j >= n:
                raise CypherSyntaxError("unterminated string literal", i, line)
            tokens.append(Token("STRING", "".join(buf), i, line))
            i = j + 1
            continue
        # backtick-quoted identifiers; `` is an escaped literal backtick
        # (Neo4j identifier quoting)
        if c == "`":
            parts = []
            j = i + 1
            while True:
                k = query.find("`", j)
                if k == -1:
                    raise CypherSyntaxError(
                        "unterminated backtick identifier", i, line)
                parts.append(query[j:k])
                if k + 1 < n and query[k + 1] == "`":
                    parts.append("`")
                    j = k + 2
                else:
                    j = k + 1
                    break
            tokens.append(Token("IDENT", "".join(parts), i, line))
            i = j
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and query[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = query[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # ".." range operator, or property access on int: stop
                    if j + 1 < n and query[j + 1] == ".":
                        break
                    if j + 1 < n and not query[j + 1].isdigit():
                        break
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    query[j + 1].isdigit() or query[j + 1] in "+-"
                ):
                    seen_exp = True
                    j += 2 if query[j + 1] in "+-" else 1
                elif ch == "x" and j == i + 1 and query[i] == "0":
                    j += 1
                    while j < n and query[j] in "0123456789abcdefABCDEF":
                        j += 1
                    break
                else:
                    break
            tokens.append(Token("NUMBER", query[i:j], i, line))
            i = j
            continue
        # parameters
        if c == "$":
            j = i + 1
            while j < n and (query[j].isalnum() or query[j] == "_"):
                j += 1
            if j == i + 1:
                raise CypherSyntaxError("empty parameter name", i, line)
            tokens.append(Token("PARAM", query[i + 1 : j], i, line))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (query[j].isalnum() or query[j] == "_"):
                j += 1
            word = query[i:j]
            upper = word.upper()
            if upper in KEYWORDS:
                tokens.append(Token("KEYWORD", upper, i, line))
            else:
                tokens.append(Token("IDENT", word, i, line))
            i = j
            continue
        # operators
        two = query[i : i + 2]
        if two in _MULTI_OPS:
            tokens.append(Token("OP", two, i, line))
            i += 2
            continue
        if c in _SINGLE_OPS:
            tokens.append(Token("OP", c, i, line))
            i += 1
            continue
        raise CypherSyntaxError(f"unexpected character {c!r}", i, line)
    tokens.append(Token("EOF", "", n, line))
    return tokens
