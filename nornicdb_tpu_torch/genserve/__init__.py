"""nornicdb_tpu_torch.genserve — paged-KV continuous-batching generation.

Counterpart of ``nornicdb_tpu.genserve``:

* :class:`GenerationEngine` / :class:`GenHandle` / :class:`GenStats` — the
  continuous batching decode engine over the paged KV cache (engine.py).
* :class:`GraphRAGService` — graph-context retrieval -> packed prompt ->
  generation (graphrag.py).
* :func:`configure` / :func:`current_config` — process-default
  :class:`~nornicdb_tpu_torch.config.GenServeConfig` (a configured one, else
  the ``NORNICDB_GENSERVE_*`` environment over the defaults).
"""

from __future__ import annotations

import threading
from typing import Optional

from nornicdb_tpu_torch.config import GenServeConfig
from nornicdb_tpu_torch.genserve.engine import (
    GenerationEngine,
    GenHandle,
    GenStats,
)
from nornicdb_tpu_torch.genserve.graphrag import GraphRAGService

__all__ = [
    "GenerationEngine", "GenHandle", "GenStats", "GraphRAGService",
    "configure", "current_config",
]

_config: Optional[GenServeConfig] = None
_mu = threading.Lock()


def configure(cfg: Optional[GenServeConfig] = None) -> None:
    """Set the process-default GenServeConfig; ``None`` resets to the
    env-derived defaults."""
    global _config
    with _mu:
        _config = cfg


def current_config() -> GenServeConfig:
    """The configured process default, else a fresh env-derived
    GenServeConfig."""
    with _mu:
        if _config is not None:
            return _config
    return GenServeConfig.from_env()
