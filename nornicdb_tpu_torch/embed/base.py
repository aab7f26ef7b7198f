"""Embedder interfaces and implementations.

Counterpart of ``nornicdb_tpu/embed/base.py``: ``Embedder``,
``HashEmbedder`` and ``CachedEmbedder`` are copies, and ``DeviceEmbedder``
is the port's ``TPUEmbedder``, the bge-m3 forward pass on the card. The
HTTP embedders (``OllamaEmbedder``, ``OpenAIEmbedder``) are copies too:
host code over the standard library's urllib.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from nornicdb_tpu_torch._device import (
    DeviceLike,
    map_tree,
    resolve_device,
    tree_to,
)
from nornicdb_tpu_torch.models import bge_m3
from nornicdb_tpu_torch.models.tokenizer import HashTokenizer
from nornicdb_tpu_torch.telemetry import deviceprof as _deviceprof


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

    The parameters' bytes are reported as ``nornicdb_hbm_bytes
    {component="embedder_params"}``.

    The device owner (``nornicdb_tpu_torch.backend``): every forward gates
    through it first (a CUDA embedder through the process default, or an
    injected ``backend``; a CPU embedder with none never creates one). A
    card that is not serving raises DeviceUnavailable; the batch never
    runs on the host instead."""

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
        backend=None,
    ):
        self.device = resolve_device(device)
        self._backend = backend  # injected BackendManager; None: default
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
        # encoder parameter residency (weakref'd; summed per component at
        # /metrics render, telemetry/deviceprof.py)
        _deviceprof.register_hbm(self, DeviceEmbedder._hbm_bytes)

    @staticmethod
    def _hbm_bytes(self) -> dict:
        sizes: list[int] = []
        map_tree(lambda t: sizes.append(t.numel() * t.element_size())
                 if isinstance(t, torch.Tensor) else None, self.params)
        return {"embedder_params": sum(sizes)}

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

    def _gate(self) -> None:
        """The device owner's gate before a forward: raises
        DeviceUnavailable when the card is not serving."""
        from nornicdb_tpu_torch import backend as _backend

        _backend.gate(self.device, self._backend)

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
        self._gate()
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
        self._gate()
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


class OllamaEmbedder(Embedder):
    """Ollama HTTP embedder (ref: OllamaEmbedder pkg/embed/embed.go:215).

    Talks to an Ollama server's /api/embeddings endpoint over the standard
    library's urllib; the tests exercise it against a local stub server.
    In deployments point base_url at a reachable Ollama. A host embedder:
    it runs no device code.
    """

    def __init__(self, base_url: str = "http://127.0.0.1:11434",
                 model: str = "bge-m3", dims: int = 1024, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self._model = model
        self._dims = dims
        self.timeout = timeout

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        import json
        import urllib.request

        out = []
        for text in texts:
            req = urllib.request.Request(
                f"{self.base_url}/api/embeddings",
                data=json.dumps({"model": self._model, "prompt": text}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
            vec = np.asarray(payload["embedding"], np.float32)
            self._dims = vec.shape[0]
            out.append(vec)
        return out

    def dimensions(self) -> int:
        return self._dims

    def model(self) -> str:
        return self._model


class OpenAIEmbedder(Embedder):
    """OpenAI-compatible HTTP embedder (ref: pkg/embed/embed.go:384).

    Works against any /v1/embeddings-compatible server (OpenAI, vLLM, TEI).
    A host embedder: it runs no device code.
    """

    def __init__(self, base_url: str = "https://api.openai.com",
                 model: str = "text-embedding-3-small", api_key: str = "",
                 dims: int = 1536, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self._model = model
        self.api_key = api_key
        self._dims = dims
        self.timeout = timeout

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        import json
        import urllib.request

        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(
            f"{self.base_url}/v1/embeddings",
            data=json.dumps({"model": self._model, "input": list(texts)}).encode(),
            headers=headers,
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = json.loads(resp.read())
        rows = sorted(payload["data"], key=lambda d: d.get("index", 0))
        out = [np.asarray(d["embedding"], np.float32) for d in rows]
        if out:
            self._dims = out[0].shape[0]
        return out

    def dimensions(self) -> int:
        return self._dims

    def model(self) -> str:
        return self._model
