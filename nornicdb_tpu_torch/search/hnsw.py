"""HNSW approximate-nearest-neighbor index (host-side): a copy of
``nornicdb_tpu/search/hnsw.py``.

It is the host index that ``SearchConfig.backend = "hnsw"`` selects, not a
fallback: the service's default backend is the device corpus
(``ops.DeviceCorpus``), which keeps exact scores. Seeded with
``random.Random(seed)``, so one seed and one insertion order give the same
graph as the JAX package's.
"""

from __future__ import annotations

import heapq
import math
import random
import threading
from typing import Optional

import numpy as np


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b))  # vectors stored normalized


class HNSWIndex:
    def __init__(
        self,
        dims: int,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 64,
        seed: int = 0,
        rebuild_tombstone_ratio: float = 0.2,
    ):
        self.dims = dims
        self.m = m
        self.m0 = m * 2
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.rebuild_tombstone_ratio = rebuild_tombstone_ratio
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._vecs: dict[str, np.ndarray] = {}
        self._levels: dict[str, int] = {}
        # neighbors[level][node] -> list of ids
        self._neighbors: dict[int, dict[str, list[str]]] = {}
        self._entry: Optional[str] = None
        self._max_level = -1
        self._tombstones: set[str] = set()

    def __len__(self) -> int:
        return len(self._vecs) - len(self._tombstones)

    # -- public ------------------------------------------------------------
    def add(self, id_: str, vector: np.ndarray) -> None:
        v = np.asarray(vector, np.float32)
        n = np.linalg.norm(v)
        if n > 1e-12:
            v = v / n
        with self._lock:
            if id_ in self._vecs:
                self._tombstones.discard(id_)
                self._vecs[id_] = v  # update in place; links stay (approx ok)
                return
            level = self._random_level()
            self._vecs[id_] = v
            self._levels[id_] = level
            for lc in range(level + 1):
                self._neighbors.setdefault(lc, {})[id_] = []
            if self._entry is None:
                self._entry = id_
                self._max_level = level
                return
            self._insert(id_, v, level)
            if level > self._max_level:
                self._max_level = level
                self._entry = id_

    def remove(self, id_: str) -> bool:
        """Tombstone removal (ref: hnsw tombstones + TombstoneRatio :402)."""
        with self._lock:
            if id_ not in self._vecs or id_ in self._tombstones:
                return False
            self._tombstones.add(id_)
            if self.tombstone_ratio() > self.rebuild_tombstone_ratio:
                self._rebuild()
            return True

    def tombstone_ratio(self) -> float:
        with self._lock:
            if not self._vecs:
                return 0.0
            return len(self._tombstones) / len(self._vecs)

    def search(
        self, query: np.ndarray, k: int, ef: Optional[int] = None
    ) -> list[tuple[str, float]]:
        q = np.asarray(query, np.float32)
        n = np.linalg.norm(q)
        if n > 1e-12:
            q = q / n
        with self._lock:
            if self._entry is None or not self._vecs:
                return []
            ef = max(ef or self.ef_search, k)
            curr = self._entry
            # greedy descent through upper layers
            for level in range(self._max_level, 0, -1):
                curr = self._greedy_closest(q, curr, level)
            cands = self._search_layer(q, curr, ef, 0)
            live = [(-d, i) for d, i in cands if i not in self._tombstones]
            live.sort(reverse=True)
            return [(i, s) for s, i in live[:k]]

    # -- internals ----------------------------------------------------------
    def _random_level(self) -> int:
        lvl = 0
        while self._rng.random() < 0.5 and lvl < 32:
            lvl += 1
        return lvl

    def _greedy_closest(self, q: np.ndarray, start: str, level: int) -> str:
        curr = start
        curr_sim = _cosine(q, self._vecs[curr])
        improved = True
        while improved:
            improved = False
            for nb in self._neighbors.get(level, {}).get(curr, []):
                sim = _cosine(q, self._vecs[nb])
                if sim > curr_sim:
                    curr, curr_sim = nb, sim
                    improved = True
        return curr

    def _search_layer(
        self, q: np.ndarray, entry: str, ef: int, level: int
    ) -> list[tuple[float, str]]:
        """Best-first search; returns [(neg_sim, id)] of up to ef candidates."""
        visited = {entry}
        entry_sim = _cosine(q, self._vecs[entry])
        # candidates: max-heap by sim (use neg); results: min-heap by sim
        cand: list[tuple[float, str]] = [(-entry_sim, entry)]
        results: list[tuple[float, str]] = [(entry_sim, entry)]
        while cand:
            neg_sim, c = heapq.heappop(cand)
            if -neg_sim < results[0][0] and len(results) >= ef:
                break
            for nb in self._neighbors.get(level, {}).get(c, []):
                if nb in visited:
                    continue
                visited.add(nb)
                sim = _cosine(q, self._vecs[nb])
                if len(results) < ef or sim > results[0][0]:
                    heapq.heappush(cand, (-sim, nb))
                    heapq.heappush(results, (sim, nb))
                    if len(results) > ef:
                        heapq.heappop(results)
        return [(-s, i) for s, i in results]

    def _select_neighbors(self, q: np.ndarray, cands: list[str], m: int) -> list[str]:
        scored = sorted(cands, key=lambda i: -_cosine(q, self._vecs[i]))
        return scored[:m]

    def _insert(self, id_: str, v: np.ndarray, level: int) -> None:
        curr = self._entry
        for lc in range(self._max_level, level, -1):
            curr = self._greedy_closest(v, curr, lc)
        for lc in range(min(level, self._max_level), -1, -1):
            cands = self._search_layer(v, curr, self.ef_construction, lc)
            cands.sort()  # (neg_sim, id): ascending neg_sim = best first
            ids = [i for _, i in cands]
            m = self.m0 if lc == 0 else self.m
            selected = self._select_neighbors(v, ids, m)
            self._neighbors[lc][id_] = list(selected)
            for nb in selected:
                lst = self._neighbors[lc].setdefault(nb, [])
                lst.append(id_)
                if len(lst) > m:
                    self._neighbors[lc][nb] = self._select_neighbors(
                        self._vecs[nb], lst, m
                    )
            if ids:
                curr = ids[0]

    def _rebuild(self) -> None:
        """Full rebuild dropping tombstones (ref: search.go:1215)."""
        live = {i: v for i, v in self._vecs.items() if i not in self._tombstones}
        self._vecs.clear()
        self._levels.clear()
        self._neighbors.clear()
        self._entry = None
        self._max_level = -1
        self._tombstones.clear()
        for i, v in live.items():
            self.add(i, v)
