"""Cypher query language (ref: pkg/cypher): the port's copy of
``nornicdb_tpu/cypher``. Lexer -> parser -> AST -> validator -> executor
over the storage engine, with the columnar pipeline and its two device
offloads (ORDER BY ... LIMIT top-k and VectorTopK) on the executor's
device. Registers the temporal functions, the GDS procedures with the
Kalman functions, and the APOC procedures (APOC functions route through
the executor's ``lookup_function``)."""

from nornicdb_tpu_torch.cypher.executor import CypherExecutor, Result, Stats
from nornicdb_tpu_torch.cypher.parser import parse
from nornicdb_tpu_torch.cypher import gds_procedures  # noqa: F401 — registers procs/fns
from nornicdb_tpu_torch.cypher import temporal_fns  # noqa: F401 — date/datetime/duration
from nornicdb_tpu_torch.apoc import register_procedures as _register_apoc

_register_apoc()  # CALL apoc.* procedures (functions route via lookup_function)

__all__ = ["CypherExecutor", "Result", "Stats", "parse"]
