"""The native gRPC search service's metric family, declared so that
``/metrics`` renders the catalog of ``nornicdb_tpu/server/grpc_search.py``
(and of ``docs/observability.md``) in the port's server.

Only the family is ported here, with the JAX name, type and help text.
The service itself (``GrpcSearchServer``, ``NORNICDB_GRPC_ENABLED``)
comes with the Qdrant gRPC services (ROADMAP A6b-2); ``serve``
refuses the flag until then. Until then nothing observes this family.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

_GRPC_HIST = _REGISTRY.histogram(
    "nornicdb_grpc_request_seconds",
    "gRPC Search latency (incl. cache hits)",
)
