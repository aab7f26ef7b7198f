"""The fleet telemetry plane's metric families, declared so that
``/metrics`` renders the catalog of ``nornicdb_tpu/telemetry/federation.py``
(and of ``docs/observability.md``) in the port's single-process server.

Only the family block is ported here, with the JAX names, types, help
text, labels and eager cells. The publisher and the fleet collector that
merges the workers' expositions come with the prefork workers (ROADMAP
A6d). A single process has no fleet: its ``/metrics`` is its own
registry's exposition, which is what JAX's collector renders when no
worker segment is registered.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

# -- worker-side serving-ladder families
WORKER_REQUESTS = _REGISTRY.counter(
    "nornicdb_worker_requests_total",
    "Worker frontend requests by how they were served "
    "(cache hit / device broker / shm read plane / proxy / shed)",
    labels=("served",),
)
for _served in ("cache", "broker", "shm", "proxy", "limited", "error"):
    WORKER_REQUESTS.labels(_served)
WORKER_BROKER_RTT = _REGISTRY.histogram(
    "nornicdb_worker_broker_roundtrip_seconds",
    "Worker-side device-broker call round trip (encode + socket + fused "
    "dispatch + decode)",
)
# -- primary-side fleet families
FLEET_MEMBERS = _REGISTRY.gauge(
    "nornicdb_fleet_members",
    "Live fleet members by process (1 = exposition merged this scrape)",
    labels=("proc",),
)
FLEET_MEMBERS.labels("primary").set(1.0)
FLEET_AGE = _REGISTRY.gauge(
    "nornicdb_fleet_exposition_age_seconds",
    "Age of each worker's last published exposition at scrape time",
    labels=("proc",),
)
FLEET_STALE_DROPS = _REGISTRY.counter(
    "nornicdb_fleet_stale_drops_total",
    "Worker expositions dropped from a merge because the segment was "
    "stale (dead worker / wedged publisher)",
)
FLEET_MERGE_ERRORS = _REGISTRY.counter(
    "nornicdb_fleet_merge_errors_total",
    "Worker expositions skipped because they failed the strict parse",
)
