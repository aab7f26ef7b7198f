"""Serving-engine metric families.

A copy of ``nornicdb_tpu/serving/stats.py``: the same families, help text and
labels, in the port's own registry.

Registered at import time (idempotent by-name resolution, same pattern as
search/service.py) so the docs/observability.md catalog — a tested
contract — renders these families in every process that serves traffic,
whether or not a ServingEngine was ever constructed.  server/http.py
imports this module for exactly that reason.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

# real (non-padding) tokens per packed device batch: the throughput axis
# the ragged scheduler optimizes — compare against PACK_EFFICIENCY to see
# whether small batches come from low load or from a tight token budget
PACKED_TOKENS_HIST = _REGISTRY.histogram(
    "nornicdb_serving_packed_tokens",
    "Real (non-padding) tokens per ragged-packed embed batch",
    buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384),
)
# real tokens / (rows * capacity) per pack: 1.0 = zero padding. The
# padded-bucket path this engine replaces sits at ~0.2-0.5 on mixed text.
PACK_EFFICIENCY_HIST = _REGISTRY.histogram(
    "nornicdb_serving_pack_efficiency",
    "Real-token fraction of each packed batch's (rows x capacity) grid",
    buckets=(0.25, 0.5, 0.625, 0.75, 0.875, 0.9375, 1.0),
)
# admission-control sheds by path (embed engine vs search batcher) and
# reason (queue_full at submit, deadline at/after dispatch,
# predicted_deadline = the cost model shed it at submit)
SHEDS = _REGISTRY.counter(
    "nornicdb_serving_sheds_total",
    "Requests shed by serving admission control",
    labels=("path", "reason"),
)
for _path in ("embed", "search"):
    for _reason in ("queue_full", "deadline", "predicted_deadline"):
        SHEDS.labels(_path, _reason)  # eager cells: render at 0
# host-staging overlap: fraction of tokenize+pack wall time that ran
# while the device was busy with the previous batch (WindVE-style
# double buffering; ~0 means staging serializes with compute)
STAGING_OVERLAP = _REGISTRY.gauge(
    "nornicdb_serving_staging_overlap_ratio",
    "Fraction of host staging time overlapped with device compute",
)
# which production embedder is serving (one-hot; set by cli serve after
# the student passes its eval gate, or by ServingEngine construction)
EMBEDDER_GAUGE = _REGISTRY.gauge(
    "nornicdb_serving_embedder",
    "Selected production embedder (one-hot by model)",
    labels=("model",),
)
_EMBEDDER_CELLS = {m: EMBEDDER_GAUGE.labels(m) for m in ("full", "student")}
QUEUE_DEPTH = _REGISTRY.gauge(
    "nornicdb_serving_queue_depth",
    "Embed texts currently queued in the continuous batching engine",
)
QUEUE_TOKENS = _REGISTRY.gauge(
    "nornicdb_serving_queue_tokens",
    "Tokens currently queued in the continuous batching engine",
)
BATCHES = _REGISTRY.counter(
    "nornicdb_serving_batches_total",
    "Packed device batches dispatched by the serving engine",
)
# embed-queue retry visibility (satellite: retries/fallbacks previously
# vanished into logs) — resolved by embed/queue.py at use sites too
EMBED_RETRIES = _REGISTRY.counter(
    "nornicdb_embed_retries_total",
    "EmbedWorker embed_batch attempts that failed and were retried",
)


def set_embedder_selection(model: str) -> None:
    """One-hot the production-embedder gauge (``full`` or ``student``)."""
    for name, cell in _EMBEDDER_CELLS.items():
        cell.set(1.0 if name == model else 0.0)
