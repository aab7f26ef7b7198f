"""Graph import/export: Neo4j JSON shapes + Mimir export loader.

Counterpart of ``nornicdb_tpu/storage/io.py`` (the port keeps its own copy
and imports nothing of the JAX package).

Behavioral reference: the upstream NornicDB pkg/storage/ —
Neo4j JSON import/export (types.go:475-707), Mimir export loader
(mimir_loader.go, wired at db.go:1138), generic loader (loader.go).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from nornicdb_tpu_torch.errors import AlreadyExistsError, NotFoundError
from nornicdb_tpu_torch.storage.types import Edge, Engine, Node


def export_json(engine: Engine) -> dict[str, Any]:
    """Neo4j-style JSON export (ref: types.go:475-707)."""
    return {
        "nodes": [
            {
                "id": n.id,
                "labels": list(n.labels),
                "properties": dict(n.properties),
            }
            for n in sorted(engine.all_nodes(), key=lambda n: n.id)
        ],
        "relationships": [
            {
                "id": e.id,
                "type": e.type,
                "startNode": e.start_node,
                "endNode": e.end_node,
                "properties": dict(e.properties),
            }
            for e in sorted(engine.all_edges(), key=lambda e: e.id)
        ],
    }


def import_json(engine: Engine, data: dict[str, Any],
                skip_existing: bool = True) -> tuple[int, int]:
    """Neo4j-style JSON import. Returns (nodes, relationships) imported."""
    from nornicdb_tpu_torch.storage.types import new_id

    n_nodes = n_edges = 0
    for nd in data.get("nodes", []):
        node = Node(
            id=str(nd["id"]) if nd.get("id") is not None else new_id(),
            labels=list(nd.get("labels", [])),
            properties=dict(nd.get("properties", {})),
        )
        try:
            engine.create_node(node)
            n_nodes += 1
        except AlreadyExistsError:
            if not skip_existing:
                raise
    for ed in data.get("relationships", data.get("edges", [])):
        edge = Edge(
            id=str(ed["id"]) if ed.get("id") is not None else new_id(),
            start_node=str(ed.get("startNode", ed.get("start_node", ""))),
            end_node=str(ed.get("endNode", ed.get("end_node", ""))),
            type=ed.get("type", "RELATED_TO"),
            properties=dict(ed.get("properties", {})),
        )
        try:
            engine.create_edge(edge)
            n_edges += 1
        except AlreadyExistsError:
            if not skip_existing:
                raise
    return n_nodes, n_edges


def load_mimir(engine: Engine, path: str) -> tuple[int, int]:
    """Mimir memory-export loader (ref: mimir_loader.go; db.go:1138).

    Mimir exports are JSONL: one {"type": "memory"|"relation", ...} per line.
    Memories become Memory-labeled nodes (content + metadata); relations
    become typed edges.
    """
    n_nodes = n_edges = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.get("type", "memory")
            if kind == "memory":
                from nornicdb_tpu_torch.storage.types import new_id as _new_id

                node = Node(
                    id=str(obj["id"]) if obj.get("id") is not None else _new_id(),
                    labels=["Memory"] + list(obj.get("labels", [])),
                    properties={
                        "content": obj.get("content", obj.get("text", "")),
                        **{k: v for k, v in (obj.get("metadata") or {}).items()},
                    },
                )
                if obj.get("importance") is not None:
                    node.properties["importance"] = obj["importance"]
                try:
                    engine.create_node(node)
                    engine.mark_pending_embed(node.id)
                    n_nodes += 1
                except AlreadyExistsError:
                    pass
            elif kind == "relation":
                edge = Edge(
                    start_node=str(obj.get("from", obj.get("source", ""))),
                    end_node=str(obj.get("to", obj.get("target", ""))),
                    type=obj.get("relation", obj.get("rel_type", "RELATED_TO")),
                    properties=dict(obj.get("properties", {})),
                )
                try:
                    engine.create_edge(edge)
                    n_edges += 1
                except (AlreadyExistsError, NotFoundError):
                    # duplicate relation, or a relation whose endpoint was
                    # not part of the import — skip it, count the rest
                    pass
    return n_nodes, n_edges
