"""Named vector-space registry shared across subsystems: a copy of
``nornicdb_tpu/vectorspace.py``. The backend names are the JAX package's
("tpu" names the single-device corpus the port keeps on the card), so a
space's canonical key is the same string in both packages.

Behavioral reference: the upstream NornicDB pkg/vectorspace/registry.go —
VectorSpaceKey :57 (name, dims, distance metric, backend kind, canonical
hash), IndexRegistry :149; used by Cypher vector indexes and Qdrant
collections so every subsystem agrees on a space's geometry.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Optional

from nornicdb_tpu_torch.errors import AlreadyExistsError, NornicError

DISTANCE_COSINE = "cosine"
DISTANCE_DOT = "dot"
DISTANCE_EUCLIDEAN = "euclidean"

BACKEND_TPU = "tpu"
BACKEND_SHARDED = "sharded"
BACKEND_HNSW = "hnsw"


@dataclass(frozen=True)
class VectorSpaceKey:
    """(ref: VectorSpaceKey registry.go:57)"""

    name: str
    dims: int
    distance: str = DISTANCE_COSINE
    backend: str = BACKEND_TPU

    def canonical(self) -> str:
        return f"{self.name.lower()}:{self.dims}:{self.distance}:{self.backend}"

    def hash(self) -> str:
        return hashlib.blake2s(self.canonical().encode()).hexdigest()[:16]


class VectorSpaceRegistry:
    """(ref: IndexRegistry registry.go:149)"""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._spaces: dict[str, VectorSpaceKey] = {}

    def register(self, key: VectorSpaceKey, if_not_exists: bool = True) -> VectorSpaceKey:
        with self._lock:
            existing = self._spaces.get(key.name.lower())
            if existing is not None:
                if existing == key or if_not_exists:
                    if existing.dims != key.dims:
                        raise NornicError(
                            f"vector space {key.name}: dims mismatch "
                            f"({existing.dims} != {key.dims})"
                        )
                    return existing
                raise AlreadyExistsError(f"vector space {key.name} exists")
            self._spaces[key.name.lower()] = key
            return key

    def get(self, name: str) -> Optional[VectorSpaceKey]:
        with self._lock:
            return self._spaces.get(name.lower())

    def drop(self, name: str) -> bool:
        with self._lock:
            return self._spaces.pop(name.lower(), None) is not None

    def list(self) -> list[VectorSpaceKey]:
        with self._lock:
            return sorted(self._spaces.values(), key=lambda k: k.name)
