"""Which text of a node gets embedded and indexed: a copy of
``TEXT_PROPERTIES`` and ``build_embedding_text`` from
``nornicdb_tpu/embed/queue.py``. The background EmbedWorker waits for the
DB wiring (ROADMAP)."""

from __future__ import annotations

from typing import Any

# properties whose text gets embedded, in priority order
TEXT_PROPERTIES = ("content", "text", "description", "title", "name", "summary")


def build_embedding_text(node: Any) -> str:
    """The node's text properties joined by newlines; a node with none of
    them falls back to all its string properties, sorted by key."""
    parts = []
    for key in TEXT_PROPERTIES:
        v = node.properties.get(key)
        if isinstance(v, str) and v.strip():
            parts.append(v.strip())
    if not parts:  # fall back to all string properties
        for k in sorted(node.properties):
            v = node.properties[k]
            if isinstance(v, str) and v.strip():
                parts.append(v.strip())
    return "\n".join(parts)
