"""Configuration of the port's generation engine: a copy of
``GenServeConfig`` (``nornicdb_tpu/config.py``), same fields and defaults,
kept here so the port imports nothing of the JAX package."""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Mapping, Optional


@dataclass
class GenServeConfig:
    """Continuous-batching generation engine knobs
    (``nornicdb_tpu_torch.genserve``). Env form:
    ``NORNICDB_GENSERVE_<FIELD>`` (:meth:`from_env`).

    ``enabled``, ``fallback``, ``rag_context_nodes`` and
    ``rag_max_new_tokens`` are read by nothing in the port yet: their
    readers (Heimdall, GraphRAG) are still to port. Setting them changes
    nothing; in particular the engine never falls back to the CPU."""

    # master switch: off = Heimdall keeps the synchronous per-request path
    enabled: bool = True
    # "paged" = paged-KV continuous batching; "dense" (the per-sequence
    # dense-cache path of the JAX package) is not ported: the engine
    # refuses it
    mode: str = "paged"
    # KV page geometry: slots per page and physical pages in the pool
    # (one page is reserved as the null/scratch page)
    page_size: int = 16
    pool_pages: int = 129
    # concurrency + per-sequence bound (prompt + generated tokens; the
    # page-table width is max_seq_tokens / page_size)
    max_seqs: int = 8
    max_seq_tokens: int = 256
    # max tokens per interleaved prefill chunk (bucketed to powers of two)
    prefill_chunk: int = 64
    # admission control: queued requests beyond this shed with
    # ResourceExhausted (an empty queue always admits)
    max_queue: int = 64
    # per-request deadline; expired requests are shed (0 disables)
    deadline_ms: float = 10000.0
    # degraded backend policy of the JAX package; ignored: the port has no
    # CPU fallback, the field is kept for config compatibility
    fallback: str = "cpu"
    # GraphRAG answer endpoint: retrieved context nodes + decode budget
    rag_context_nodes: int = 5
    rag_max_new_tokens: int = 64

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "GenServeConfig":
        """Defaults overridden by ``NORNICDB_GENSERVE_<FIELD>`` variables,
        coerced by each field's default type as the JAX package does."""
        env = os.environ if environ is None else environ
        cfg = cls()
        for f in fields(cls):
            raw = env.get(f"NORNICDB_GENSERVE_{f.name.upper()}")
            if raw is None:
                continue
            current = getattr(cfg, f.name)
            if isinstance(current, bool):
                value = raw.lower() in ("1", "true", "yes", "always", "sync")
            else:
                value = type(current)(raw)
            setattr(cfg, f.name, value)
        return cfg
