"""Embedder interfaces and implementations.

Counterpart of ``nornicdb_tpu/embed/base.py``: ``Embedder``,
``HashEmbedder`` and ``CachedEmbedder`` are copies, and ``DeviceEmbedder``
is the port's ``TPUEmbedder``, the bge-m3 forward pass on the card. The
HTTP embedders (``OllamaEmbedder``, ``OpenAIEmbedder``) are not ported
(ROADMAP).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device, tree_to
from nornicdb_tpu_torch.models import bge_m3
from nornicdb_tpu_torch.models.tokenizer import HashTokenizer


class Embedder:
    """Embed/EmbedBatch/Dimensions/Model."""

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        raise NotImplementedError

    def dimensions(self) -> int:
        raise NotImplementedError

    def model(self) -> str:
        raise NotImplementedError


class HashEmbedder(Embedder):
    """Deterministic embedding from token hashes: bag-of-hashed-words vectors,
    L2-normalized. Same text -> same vector across processes; similar word
    sets -> high cosine. Pure numpy: the serving engine's unpacked path and
    its tests use it."""

    def __init__(self, dims: int = 256):
        self._dims = dims

    def _word_vec(self, word: str) -> np.ndarray:
        h = hashlib.blake2s(word.lower().encode()).digest()
        seed = int.from_bytes(h[:8], "little") % (2**32)
        rng = np.random.default_rng(seed)
        return rng.standard_normal(self._dims).astype(np.float32)

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        out = []
        for t in texts:
            words = t.split()
            if not words:
                out.append(np.zeros(self._dims, np.float32))
                continue
            v = np.sum([self._word_vec(w) for w in words], axis=0)
            n = np.linalg.norm(v)
            out.append((v / n if n > 1e-12 else v).astype(np.float32))
        return out

    def dimensions(self) -> int:
        return self._dims

    def model(self) -> str:
        return "hash-embedder"


class DeviceEmbedder(Embedder):
    """bge-m3 architecture encoder on the card: the port's counterpart of
    the JAX package's ``TPUEmbedder``.

    ``params`` is the port's parameter dict (``bge_m3.init_params`` or
    ``convert.bge_params_from_jax``), moved to ``device`` if it lies
    elsewhere; without one, parameters are drawn from ``seed``.
    ``device=None`` means CUDA and raises DeviceUnavailable without a card;
    pass ``device="cpu"`` to embed on the CPU.

    Batching policy of ``embed_batch`` (the padded per-request path): texts
    are tokenized without padding, grouped into power-of-two sequence-length
    buckets, and run in chunks of ``opt_batch`` per bucket, each chunk padded
    to a power-of-two batch class, as the reference does. ``embed_packed``
    runs one token-packed grid of the serving engine in one forward.

    Not ported (ROADMAP): the backend manager gate, the DEGRADED_CPU host
    mirror of the weights and the device-profiler registration. The
    embedder runs where its ``device`` says, and a forward that fails
    raises; so the reference's ``cpu_fallback_batches`` counter has no
    counterpart in ``stats``."""

    _LEN_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(
        self,
        cfg: Optional[bge_m3.BgeConfig] = None,
        params: Optional[dict] = None,
        tokenizer=None,
        max_len: int = 512,
        seed: int = 0,
        opt_batch: int = 32,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else bge_m3.BGE_SMALL
        self.params = (
            tree_to(params, self.device) if params is not None
            else bge_m3.init_params(self.cfg, seed, self.device)
        )
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size)
        self.max_len = max_len
        self.opt_batch = max(1, opt_batch)
        # (R, C, S_cap) shape classes the packed forward ran
        self.packed_shapes: set[tuple[int, int, int]] = set()
        self.stats = {
            "embedded": 0, "batches": 0,
            "packed_dispatches": 0, "packed_tokens": 0,
        }

    def _bucket_len(self, n: int) -> int:
        for b in self._LEN_BUCKETS:
            if n <= b and b <= self.max_len:
                return b
        return self.max_len

    def _batch_class(self, n: int) -> int:
        b = 1
        while b < n and b < self.opt_batch:
            b *= 2
        return b

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.inference_mode()
    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        if not texts:
            return []
        seqs = [
            self.tokenizer.encode(t, max_len=self.max_len) or
            [self.tokenizer.pad_id] for t in texts
        ]
        # group by padded-length bucket, preserving input positions
        buckets: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            buckets.setdefault(self._bucket_len(len(s)), []).append(i)
        out: list[Optional[np.ndarray]] = [None] * len(texts)
        pad_id = self.tokenizer.pad_id
        for blen, positions in sorted(buckets.items()):
            for start in range(0, len(positions), self.opt_batch):
                chunk = positions[start:start + self.opt_batch]
                bcls = self._batch_class(len(chunk))
                ids = np.full((bcls, blen), pad_id, np.int32)
                mask = np.zeros((bcls, blen), np.int32)
                for row, pos in enumerate(chunk):
                    s = seqs[pos]
                    ids[row, : len(s)] = s
                    mask[row, : len(s)] = 1
                emb = bge_m3.forward(self.params, self.cfg, self._tensor(ids),
                                     self._tensor(mask))
                emb = emb.cpu().numpy()
                for row, pos in enumerate(chunk):
                    out[pos] = emb[row]
                self.stats["batches"] += 1
        self.stats["embedded"] += len(texts)
        return out  # type: ignore[return-value]

    @torch.inference_mode()
    def embed_packed(self, packed) -> np.ndarray:
        """Embed one ragged token-packed grid (``serving.PackedBatch``) in a
        single forward: segment-masked attention and per-segment CLS
        pooling, equivalent to the per-request path. Returns (S_cap, dims)
        float32; callers slice the live segments via ``packed.order``."""
        emb = bge_m3.forward_packed(
            self.params, self.cfg,
            self._tensor(packed.ids),
            self._tensor(packed.seg),
            self._tensor(packed.positions),
            self._tensor(packed.cls_rows),
            self._tensor(packed.cls_cols),
        ).cpu().numpy()
        self.packed_shapes.add(packed.shape_class)
        self.stats["packed_dispatches"] += 1
        self.stats["packed_tokens"] += packed.tokens
        self.stats["batches"] += 1
        self.stats["embedded"] += packed.n_segments
        return emb

    def dimensions(self) -> int:
        return self.cfg.dims

    def model(self) -> str:
        return "bge-m3-torch"


class CachedEmbedder(Embedder):
    """LRU cache keyed by content hash."""

    def __init__(self, inner: Embedder, capacity: int = 10000):
        self.inner = inner
        self.capacity = capacity
        self._lock = threading.Lock()
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(text: str) -> str:
        return hashlib.sha256(text.encode()).hexdigest()

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        out: list[Optional[np.ndarray]] = [None] * len(texts)
        miss_idx: list[int] = []
        with self._lock:
            for i, t in enumerate(texts):
                k = self._key(t)
                if k in self._cache:
                    self._cache.move_to_end(k)
                    out[i] = self._cache[k]
                    self.hits += 1
                else:
                    miss_idx.append(i)
                    self.misses += 1
        if miss_idx:
            fresh = self.inner.embed_batch([texts[i] for i in miss_idx])
            with self._lock:
                for i, v in zip(miss_idx, fresh):
                    out[i] = v
                    self._cache[self._key(texts[i])] = v
                    while len(self._cache) > self.capacity:
                        self._cache.popitem(last=False)
        return out  # type: ignore[return-value]

    def dimensions(self) -> int:
        return self.inner.dimensions()

    def model(self) -> str:
        return self.inner.model()
