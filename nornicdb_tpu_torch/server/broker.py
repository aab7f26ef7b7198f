"""The device broker's metric families, declared so that ``/metrics``
renders the catalog of ``nornicdb_tpu/server/broker.py`` (and of
``docs/observability.md``) in the port's single-process server.

Only the family block is ported here, with the JAX names, types, help
text, labels and eager cells. The broker itself (the Unix-socket server
that fuses the workers' searches on the card) comes with the prefork
workers (ROADMAP A6d). Until then nothing increments these families.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

_REQUESTS = _REGISTRY.counter(
    "nornicdb_broker_requests_total",
    "Device-broker requests by operation and outcome",
    labels=("op", "outcome"),
)
for _op in ("search", "embed", "status", "qdrant"):
    for _out in ("ok", "shed", "degraded", "error"):
        _REQUESTS.labels(_op, _out)
_REQ_HIST = _REGISTRY.histogram(
    "nornicdb_broker_request_seconds",
    "Device-broker request service time by operation",
    labels=("op",),
)
_REQ_HIST.labels("search")
_REQ_HIST.labels("embed")
_REQ_HIST.labels("qdrant")
_CONNECTIONS = _REGISTRY.gauge(
    "nornicdb_broker_connections",
    "Worker connections currently attached to the device broker",
)
_QUERIES = _REGISTRY.counter(
    "nornicdb_broker_queries_total",
    "Individual search queries received by the broker (fused downstream "
    "by the QueryBatcher)",
)
_BYTES = _REGISTRY.counter(
    "nornicdb_broker_bytes_total",
    "Bytes moved across the broker socket",
    labels=("direction",),
)
_BYTES.labels("rx")
_BYTES.labels("tx")
