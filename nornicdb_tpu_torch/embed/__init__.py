"""Embedders of the port (counterpart of ``nornicdb_tpu.embed``): the bge-m3
encoder on the card (``DeviceEmbedder``), the deterministic
``HashEmbedder`` and the content-hash LRU ``CachedEmbedder``.

``embed/queue.py`` holds ``build_embedding_text`` (which text of a node is
embedded and indexed); its background EmbedWorker and the HTTP embedders
are not ported yet (ROADMAP)."""

from nornicdb_tpu_torch.embed.base import (
    CachedEmbedder,
    DeviceEmbedder,
    Embedder,
    HashEmbedder,
)

__all__ = ["CachedEmbedder", "DeviceEmbedder", "Embedder", "HashEmbedder"]
