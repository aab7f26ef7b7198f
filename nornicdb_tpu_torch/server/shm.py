"""The shared-memory read plane's metric families, declared so that
``/metrics`` renders the catalog of ``nornicdb_tpu/server/shm.py`` (and
of ``docs/observability.md``) in the port's single-process server.

Only the family block is ported here, with the JAX names, types, help
text, labels and eager cells. The segments themselves come with the
prefork workers (ROADMAP A6d). Until then nothing increments these
families.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

# eager cells for the two shipped segments so the catalog renders before
# a first publish
_PUBLISHES = _REGISTRY.counter(
    "nornicdb_shm_publishes_total",
    "Shared-memory segment generations published by the primary",
    labels=("segment",),
)
_REMAPS = _REGISTRY.counter(
    "nornicdb_shm_remaps_total",
    "Reader remaps onto a newer shared-segment generation",
    labels=("segment",),
)
_BYTES = _REGISTRY.gauge(
    "nornicdb_shm_bytes",
    "Payload bytes of the current shared-segment generation",
    labels=("segment",),
)
_GENERATION = _REGISTRY.gauge(
    "nornicdb_shm_generation",
    "Current published generation per shared segment",
    labels=("segment",),
)
for _seg in ("corpus", "adjacency"):
    _PUBLISHES.labels(_seg)
    _REMAPS.labels(_seg)
    _BYTES.labels(_seg)
    _GENERATION.labels(_seg)
