"""Shared serialized-response cache for protocol servers.

One policy, used by both the HTTP search endpoint and the native gRPC
search service (ref: pkg/cache LRU+TTL query cache): entries are dead
the moment the search index generation moves, and expire after a short
TTL so decay/access-count drift stays bounded. The generation must be
snapshotted BEFORE running the search — a mutation racing the search
must make the entry dead on arrival (same rule as the rank cache,
search/service.py gen_before).

The port's copy of ``nornicdb_tpu/server/respcache.py``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Hashable, Optional

log = logging.getLogger(__name__)


class ResponseCache:
    def __init__(self, generation_fn: Callable[[], int],
                 ttl: float = 1.0, max_entries: int = 512):
        self._generation_fn = generation_fn
        self.ttl = ttl
        self.max_entries = max_entries
        self._entries: dict[Hashable, tuple[bytes, int, float]] = {}

    def generation(self) -> int:
        try:
            return self._generation_fn()
        except Exception:
            # sentinel: both get() and put() treat -1 as "cache unusable"
            # (fail open = serve uncached) — a -1 must never match a -1, or
            # a persistently-broken probe would serve stale hits forever
            log.warning("generation probe failed; cache disabled this request",
                        exc_info=True)
            return -1

    def get(self, key: Hashable) -> Optional[bytes]:
        entry = self._entries.get(key)
        if entry is None:
            return None
        payload, gen, expires = entry
        current = self.generation()
        if current == -1 or gen != current or time.time() > expires:
            self._entries.pop(key, None)
            return None
        return payload

    def put(self, key: Hashable, payload: bytes, generation: int) -> None:
        """`generation` must be the value snapshotted before the search
        ran; an entry built from pre-mutation data then mismatches the
        bumped counter and dies on first lookup."""
        if generation == -1:
            return  # probe failed before the search: staleness unknowable
        if len(self._entries) >= self.max_entries:
            self._entries.clear()  # cheap wholesale eviction
        self._entries[key] = (payload, generation, time.time() + self.ttl)
