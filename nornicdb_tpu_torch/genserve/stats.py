"""Generation-engine metric families (``nornicdb_genserve_*``).

A copy of ``nornicdb_tpu/genserve/stats.py``: the same families, help text and
labels, in the port's own registry.

Registered at import time (idempotent by-name resolution, same pattern as
serving/stats.py) so the docs/observability.md catalog — a tested
contract — renders these families in every process that serves traffic,
whether or not a GenerationEngine was ever constructed.  server/http.py
imports this module for exactly that reason.
"""

from __future__ import annotations

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

# generation requests waiting for admission into the running batch; a
# persistently deep queue means max_seqs / pool_pages are undersized for
# the offered load (sheds_total{reason="queue_full"} is the overflow)
QUEUE_DEPTH = _REGISTRY.gauge(
    "nornicdb_genserve_queue_depth",
    "Generation requests queued for admission into the running batch",
)
RUNNING_SEQS = _REGISTRY.gauge(
    "nornicdb_genserve_running_seqs",
    "Sequences currently resident in the continuous decode batch",
)
# allocated / usable physical pages: sustained ~1.0 with evictions rising
# means the pool thrashes — grow pool_pages or lower max_seqs
PAGE_POOL_UTIL = _REGISTRY.gauge(
    "nornicdb_genserve_page_pool_utilization",
    "Fraction of the paged-KV pool's usable pages currently allocated",
)
PREFILL_HIST = _REGISTRY.histogram(
    "nornicdb_genserve_prefill_seconds",
    "Per-chunk prompt prefill latency (one interleaved chunk)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
)
DECODE_HIST = _REGISTRY.histogram(
    "nornicdb_genserve_decode_step_seconds",
    "Batched decode-step latency (one token for every running sequence)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
)
# admission-control + lifecycle sheds by reason: queue_full at submit,
# deadline pre-dispatch/at the caller, pool_exhausted when a lone request
# cannot fit, device when fallback="fail" and the backend is degraded,
# predicted_deadline when the cost model shed the request at submit
SHEDS = _REGISTRY.counter(
    "nornicdb_genserve_sheds_total",
    "Generation requests shed by admission control or deadline",
    labels=("reason",),
)
for _reason in ("queue_full", "deadline", "pool_exhausted", "device",
                "predicted_deadline"):
    SHEDS.labels(_reason)  # eager cells: render at 0
# rate() of this counter is the aggregate tokens/s the engine sustains
TOKENS = _REGISTRY.counter(
    "nornicdb_genserve_generated_tokens_total",
    "Tokens generated across all sequences (rate = aggregate tokens/s)",
)
EVICTIONS = _REGISTRY.counter(
    "nornicdb_genserve_evictions_total",
    "Sequences evicted from the running batch on page-pool pressure "
    "(requeued and re-prefilled)",
)
REQUESTS = _REGISTRY.counter(
    "nornicdb_genserve_requests_total",
    "Generation requests by terminal outcome",
    labels=("outcome",),
)
for _outcome in ("ok", "shed", "error"):
    REQUESTS.labels(_outcome)
# prefill tokens split by pass: "first" is the initial prompt pass,
# "re" is tokens re-prefilled after a youngest-eviction requeue — the
# bench's prefill-throughput number must use "first" only (counting
# re-prefill inflates it with work the pool pressure forced, not work
# the offered load asked for)
PREFILL_TOKENS = _REGISTRY.counter(
    "nornicdb_genserve_prefill_tokens_total",
    "Prompt tokens prefilled, split by pass (first = initial prompt "
    "pass, re = re-prefill after eviction requeue)",
    labels=("pass",),
)
for _pass in ("first", "re"):
    PREFILL_TOKENS.labels(_pass)
# shared-prefix KV cache: a hit means one whole prompt-prefix page was
# adopted from the pool instead of re-prefilled; hits * page_size is the
# prefill work the cache elided (ttft saved is roughly proportional)
PREFIX_HITS = _REGISTRY.counter(
    "nornicdb_genserve_prefix_hits_total",
    "Shared-prefix cache hits (whole KV pages adopted at admission "
    "instead of prefilled)",
)
PREFIX_PAGES = _REGISTRY.gauge(
    "nornicdb_genserve_prefix_pages",
    "KV pages currently indexed by the shared-prefix cache (resident "
    "and adoptable, whether or not any sequence holds them)",
)
