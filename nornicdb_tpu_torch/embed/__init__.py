"""Embedders of the port (counterpart of ``nornicdb_tpu.embed``): the bge-m3
encoder on the card (``DeviceEmbedder``), the deterministic
``HashEmbedder`` and the content-hash LRU ``CachedEmbedder``.

The HTTP embedders and ``embed/queue.py``'s background EmbedWorker are not
ported yet (ROADMAP)."""

from nornicdb_tpu_torch.embed.base import (
    CachedEmbedder,
    DeviceEmbedder,
    Embedder,
    HashEmbedder,
)

__all__ = ["CachedEmbedder", "DeviceEmbedder", "Embedder", "HashEmbedder"]
