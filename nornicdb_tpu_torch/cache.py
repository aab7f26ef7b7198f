"""Query-result cache: LRU + TTL with label-based invalidation, a copy of
``nornicdb_tpu/cache.py``. ``DB.query_cache`` builds it and invalidates it
from storage events; its reader, the Cypher executor, is not ported yet.

Behavioral reference: the upstream NornicDB pkg/cache/query_cache.go:54
(QueryCache — keyed by hash(query, params), label invalidation, stats;
global ConfigureGlobalCache wired at cmd/nornicdb/main.go:320).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class _Entry:
    value: Any
    labels: frozenset
    expires: float


class QueryCache:
    """(ref: cache.QueryCache query_cache.go:54)"""

    def __init__(self, capacity: int = 1000, ttl: float = 60.0):
        self.capacity = capacity
        self.ttl = ttl
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self.stats = CacheStats()

    @staticmethod
    def key(query: str, params: Optional[dict] = None) -> str:
        blob = query + "\x00" + json.dumps(params or {}, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def get(self, query: str, params: Optional[dict] = None) -> Optional[Any]:
        k = self.key(query, params)
        with self._lock:
            e = self._entries.get(k)
            if e is None or e.expires < time.time():
                if e is not None:
                    del self._entries[k]
                self.stats.misses += 1
                return None
            self._entries.move_to_end(k)
            self.stats.hits += 1
            return e.value

    def put(
        self,
        query: str,
        params: Optional[dict],
        value: Any,
        labels: Optional[set[str]] = None,
    ) -> None:
        k = self.key(query, params)
        with self._lock:
            self._entries[k] = _Entry(
                value, frozenset(labels or ()), time.time() + self.ttl
            )
            self._entries.move_to_end(k)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def invalidate_labels(self, labels: set[str]) -> int:
        """Drop entries that touched any of these labels; entries with no
        recorded labels (label-agnostic scans) are dropped too
        (ref: label-based invalidation query_cache.go)."""
        dropped = 0
        with self._lock:
            for k in list(self._entries):
                e = self._entries[k]
                if not e.labels or e.labels & labels:
                    del self._entries[k]
                    dropped += 1
            self.stats.invalidations += dropped
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
