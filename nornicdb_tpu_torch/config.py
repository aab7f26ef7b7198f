"""Configuration of the port's serving engines: copies of ``ServingConfig``
(embedding) and ``GenServeConfig`` (generation) of
``nornicdb_tpu/config.py``, same fields and defaults, kept here so the port
imports nothing of the JAX package."""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Mapping, Optional, TypeVar

_C = TypeVar("_C")


def _from_env(cls: type[_C], prefix: str,
              environ: Optional[Mapping[str, str]]) -> _C:
    """``cls()`` overridden by ``<prefix><FIELD>`` variables, coerced by
    each field's default type as the JAX package does."""
    env = os.environ if environ is None else environ
    cfg = cls()
    for f in fields(cls):
        raw = env.get(f"{prefix}{f.name.upper()}")
        if raw is None:
            continue
        current = getattr(cfg, f.name)
        if isinstance(current, bool):
            value = raw.lower() in ("1", "true", "yes", "always", "sync")
        else:
            value = type(current)(raw)
        setattr(cfg, f.name, value)
    return cfg


@dataclass
class ServingConfig:
    """Continuous batching engine knobs of the embed path
    (``nornicdb_tpu_torch.serving.ServingEngine``). Env form:
    ``NORNICDB_SERVING_<FIELD>`` (:meth:`from_env`).

    ``enabled``, ``embedder`` and the ``student_*`` fields are read by
    nothing in the port yet: their readers (the server's embedder
    selection and the distilled-student gate) are still to port. Setting
    them changes nothing."""

    # master switch for the continuous batching engine
    enabled: bool = True
    # production embedder selection: "full" = the configured encoder as
    # is; "student" = the distilled checkpoint at student_model_dir,
    # admitted only when its eval MRR clears student_min_mrr
    embedder: str = "full"
    student_model_dir: str = ""
    student_min_mrr: float = 0.6
    student_eval_suite: str = ""  # JSON suite path; "" = builtin suite
    # admission control: queued texts/tokens beyond these shed new
    # requests with ResourceExhausted (an empty queue always admits)
    max_queue: int = 4096
    max_queue_tokens: int = 262144
    # per-request deadline; expired work is shed pre-dispatch and waiting
    # callers give up at deadline + grace. 0 disables (not recommended
    # for serving: the deadline is the no-indefinite-block guarantee)
    deadline_ms: float = 2000.0
    # batch window under low queue depth (a deep queue dispatches
    # immediately at max_batch_tokens)
    batch_wait_ms: float = 2.0
    # ragged scheduler: token budget per packed dispatch + row-grid bound
    max_batch_tokens: int = 8192
    max_rows: int = 16
    # host staging pipeline depth (double buffering; >=1)
    staging_depth: int = 2

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "ServingConfig":
        """Defaults overridden by ``NORNICDB_SERVING_<FIELD>`` variables."""
        return _from_env(cls, "NORNICDB_SERVING_", environ)


@dataclass
class GenServeConfig:
    """Continuous-batching generation engine knobs
    (``nornicdb_tpu_torch.genserve``). Env form:
    ``NORNICDB_GENSERVE_<FIELD>`` (:meth:`from_env`).

    ``GraphRAGService`` reads ``rag_context_nodes`` and
    ``rag_max_new_tokens``. ``enabled`` and ``fallback`` are read by nothing
    in the port yet: their readers (the DB wiring that fronts Heimdall with
    the engine, and the backend gate) are still to port. Setting them
    changes nothing; in particular the engine never falls back to the
    CPU."""

    # master switch: off = Heimdall keeps the synchronous per-request path
    enabled: bool = True
    # "paged" = paged-KV continuous batching; "dense" = the escape hatch, a
    # per-sequence dense KV cache (torch ops, no ragged kernel)
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
        """Defaults overridden by ``NORNICDB_GENSERVE_<FIELD>`` variables."""
        return _from_env(cls, "NORNICDB_GENSERVE_", environ)
