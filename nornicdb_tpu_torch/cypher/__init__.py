"""Cypher query language (ref: pkg/cypher): the port's copy of
``nornicdb_tpu/cypher``. Lexer -> parser -> AST -> validator -> executor
over the storage engine, with the columnar pipeline and its two device
offloads (ORDER BY ... LIMIT top-k and VectorTopK) on the executor's
device. Registers the temporal functions; the APOC procedures and the GDS
procedures are not ported yet (ROADMAP A5b), and a call to one raises a
CypherSyntaxError that says so."""

from nornicdb_tpu_torch.cypher.executor import CypherExecutor, Result, Stats
from nornicdb_tpu_torch.cypher.parser import parse
from nornicdb_tpu_torch.cypher import temporal_fns  # noqa: F401 — date/datetime/duration

__all__ = ["CypherExecutor", "Result", "Stats", "parse"]
