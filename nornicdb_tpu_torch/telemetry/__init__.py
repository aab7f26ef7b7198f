"""Unified telemetry: metrics registry, request tracing, slow-query capture
(counterpart of ``nornicdb_tpu.telemetry``).

One process-wide instrumentation layer for the whole serving stack
(HTTP/Bolt/gRPC -> cypher executor -> search/batcher -> storage/WAL ->
device sync -> replication). Three pillars:

- ``metrics`` — counters / gauges / fixed-bucket histograms with label
  sets.  Cells are resolved once at the instrumentation site and updated
  with a per-cell lock (no registry-wide locking, no allocation per
  observe).  ``Registry.render_prometheus()`` produces the full text
  exposition served at ``/metrics``; ``stats_callback`` adapts existing
  ``stats()`` / ``stats_snapshot()`` dicts into gauges without hand
  plumbing.
- ``tracing`` — contextvar-propagated trace context with spans recorded
  into a bounded ring buffer; W3C ``traceparent`` in/out on HTTP, carried
  across the Bolt/gRPC servers, the QueryBatcher worker hop, and
  replication RPCs.  Disabled or unsampled paths cost one contextvar read
  and allocate nothing (``tracer.span`` returns a shared no-op handle).
- ``slowlog`` — executor-recorded ring buffer of queries over a
  configurable threshold, with redacted query text, plan summary, span
  breakdown, and adjacency/device-sync counter deltas; served at
  ``/admin/slow-queries``.

The package is import-light (torch loads only inside a profile capture
and the build-info probe) so any subsystem can instrument itself without
layering concerns. The fleet federation and the exposition parser
(``federation``, ``promparse``) come with the servers.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    REGISTRY,
    Registry,
    count_error,
)
from nornicdb_tpu_torch.telemetry.slowlog import slow_log  # noqa: F401
from nornicdb_tpu_torch.telemetry.tracing import (  # noqa: F401
    format_traceparent,
    parse_traceparent,
    tracer,
)


def configure(
    tracing_enabled=None,
    trace_sample=None,
    trace_buffer=None,
    slow_query_ms=None,
    slow_buffer=None,
    profile_max_seconds=None,
    cost_conservatism=None,
    cost_min_confidence=None,
    predictive_admission=None,
    slo_targets=None,
    slo_objective=None,
) -> None:
    """Apply config-file / CLI settings to the process-global telemetry
    singletons (config.TelemetryConfig maps 1:1 onto these arguments, but
    for ``fleet_staleness_s``: the fleet federation comes with the
    servers)."""
    tracer.configure(
        enabled=tracing_enabled,
        sample_rate=trace_sample,
        capacity=trace_buffer,
    )
    slow_log.configure(
        threshold_s=None if slow_query_ms is None else slow_query_ms / 1000.0,
        capacity=slow_buffer,
    )
    if profile_max_seconds is not None:
        global profile_max_s
        profile_max_s = float(profile_max_seconds)
    if any(v is not None for v in (cost_conservatism, cost_min_confidence,
                                   predictive_admission, slo_targets,
                                   slo_objective)):
        from nornicdb_tpu_torch.telemetry.costmodel import COST_MODEL

        COST_MODEL.configure(
            conservatism=cost_conservatism,
            min_confidence=cost_min_confidence,
            predictive_admission=predictive_admission,
            slo_targets=slo_targets,
            slo_objective=slo_objective,
        )


#: upper bound for POST /admin/profile?seconds=N captures (configurable
#: via TelemetryConfig.profile_max_seconds)
profile_max_s = 60.0
