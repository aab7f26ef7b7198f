"""Embedders of the port (counterpart of ``nornicdb_tpu.embed``): the bge-m3
encoder on the card (``DeviceEmbedder``), the deterministic
``HashEmbedder``, the content-hash LRU ``CachedEmbedder`` and the HTTP
embedders ``OllamaEmbedder`` and ``OpenAIEmbedder`` (standard-library
urllib, no device code); and in ``embed/queue.py`` the background
``EmbedWorker`` the DB runs over its pending-embed queue."""

from nornicdb_tpu_torch.embed.base import (
    CachedEmbedder,
    DeviceEmbedder,
    Embedder,
    HashEmbedder,
    OllamaEmbedder,
    OpenAIEmbedder,
)
from nornicdb_tpu_torch.embed.queue import (
    EmbedWorker,
    EmbedWorkerConfig,
    EmbedWorkerStats,
    average_embeddings,
    build_embedding_text,
    chunk_text,
)

__all__ = ["CachedEmbedder", "DeviceEmbedder", "Embedder", "EmbedWorker",
           "EmbedWorkerConfig", "EmbedWorkerStats", "HashEmbedder",
           "OllamaEmbedder", "OpenAIEmbedder",
           "average_embeddings", "build_embedding_text", "chunk_text"]
