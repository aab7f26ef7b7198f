"""NornicDB's vector-search tier, embed serving and paged-KV generation
serving in PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(sm_90a): ``search`` (the hybrid ``SearchService``: device vector search,
BM25, RRF fusion, rerank, MMR, over a storage engine), ``storage`` (the
durable chain ``open_storage`` assembles: write-behind over a WAL over an
in-memory engine, the native segment store, namespaces, and the CSR
adjacency snapshot that feeds the graph offloads) and ``multidb``,
``serving`` (``ServingEngine`` over ``embed.DeviceEmbedder``, the bge-m3
encoder of ``models``),
``genserve`` (``GenerationEngine`` over the Qwen2 decoder of ``models``, and
``GraphRAGService`` answering over search and generation) and ``heimdall``
(the assistant's generators; ``models.pretrain.load_generator`` mounts a
checkpoint).

A port of ``nornicdb_tpu`` (JAX on a TPU), kept beside it: the module names
mirror the JAX package's so each module's counterpart is easy to find, and
the tests hold every ported function against the JAX one on the same
inputs. The port imports ``torch`` and never ``jax`` or ``nornicdb_tpu``.

Every entry point takes ``device=None``, which means CUDA: without a card
it raises DeviceUnavailable. The CPU runs only when the caller passes
``device="cpu"`` (the tests do), and then each kernel's plain PyTorch
version runs in its place.
"""

from nornicdb_tpu_torch._device import resolve_device
from nornicdb_tpu_torch.errors import (
    ClosedError,
    DeviceUnavailable,
    NornicError,
    NotFoundError,
    ResourceExhausted,
    StudentGateError,
)

__version__ = "0.1.0"

__all__ = [
    "ClosedError",
    "DeviceUnavailable",
    "NornicError",
    "NotFoundError",
    "ResourceExhausted",
    "StudentGateError",
    "resolve_device",
]
