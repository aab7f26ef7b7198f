"""APOC-compatible function/procedure library (ref: upstream NornicDB apoc/ —
850+ functions in ~45 categories; this build implements the core categories:
coll, text, map, math, number, convert, json, date, temporal, hashing, meta,
label, node, rel, any, util, bitwise, diff, stats, spatial, scoring, xml,
create, merge, refactor, neighbors, path, periodic, trigger, cypher, schema,
nodes, log).

The port's copy of ``nornicdb_tpu/apoc/__init__.py``.
"""

from nornicdb_tpu_torch.apoc import functions as _functions  # noqa: F401 — registers
from nornicdb_tpu_torch.apoc import functions_ext as _functions_ext  # noqa: F401
from nornicdb_tpu_torch.apoc import functions_graph as _functions_graph  # noqa: F401
from nornicdb_tpu_torch.apoc import functions_graph2 as _functions_graph2  # noqa: F401
from nornicdb_tpu_torch.apoc import functions_ops as _functions_ops  # noqa: F401
from nornicdb_tpu_torch.apoc import functions_pure as _functions_pure  # noqa: F401
from nornicdb_tpu_torch.apoc import functions_tail as _functions_tail  # noqa: F401
from nornicdb_tpu_torch.apoc.registry import all_functions, call, categories, lookup

__all__ = ["all_functions", "call", "categories", "lookup"]


def register_procedures() -> None:
    """Import the storage-touching procedures into the Cypher registry."""
    from nornicdb_tpu_torch.apoc import export_import as _export_import  # noqa: F401
    from nornicdb_tpu_torch.apoc import procedures as _procedures  # noqa: F401
