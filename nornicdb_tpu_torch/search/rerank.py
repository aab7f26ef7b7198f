"""Cross-encoder reranking: the port's ``nornicdb_tpu/search/rerank.py``.

A second-stage model scores (query, document) pairs jointly and reorders
the fused head. The bge-m3 encoder (``models/bge_m3.py``) runs over
"query [SEP] doc" pairs batched into ONE forward on the reranker's device;
a linear head over the pooled embedding gives the relevance score. With
random weights this reorders arbitrarily, so the service gates it behind
``SearchConfig.rerank_enabled``, as the reference does; carry trained or
JAX weights in with ``convert.reranker_params_from_jax``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device, tree_to
from nornicdb_tpu_torch.models import bge_m3
from nornicdb_tpu_torch.models.tokenizer import HashTokenizer


class CrossEncoderReranker:
    """``params`` / ``head`` are the port's (``bge_m3.init_params`` and
    ``{"w": (dims,), "b": ()}`` float32), moved to ``device``; without them
    both are drawn from ``seed`` with a ``torch.Generator`` (the head from
    ``seed + 1``, normal * 0.02 and a zero bias, the reference's
    distribution; the numbers differ from ``jax.random``'s).
    ``device=None`` means CUDA and raises DeviceUnavailable without a card."""

    def __init__(self, cfg: Optional[bge_m3.BgeConfig] = None,
                 params: Optional[dict] = None, head: Optional[dict] = None,
                 tokenizer=None, max_len: int = 256, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else bge_m3.BGE_SMALL
        self.params = (
            tree_to(params, self.device) if params is not None
            else bge_m3.init_params(self.cfg, seed, self.device)
        )
        if head is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + 1)
            head = {
                "w": torch.randn((self.cfg.dims,), generator=gen,
                                 device=self.device) * 0.02,
                "b": torch.zeros((), device=self.device),
            }
        self.head = tree_to(head, self.device)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size)
        self.max_len = max_len

    @torch.inference_mode()
    def score_pairs(self, query: str, docs: Sequence[str]) -> np.ndarray:
        """(len(docs),) float32 relevance of each doc to ``query``."""
        if not docs:
            return np.zeros(0, np.float32)
        pairs = [f"{query} [SEP] {d}" for d in docs]
        ids, masks = self.tokenizer.encode_batch(pairs, max_len=self.max_len)
        emb = bge_m3.forward(
            self.params, self.cfg,
            torch.tensor(ids, dtype=torch.int32, device=self.device),
            torch.tensor(masks, dtype=torch.int32, device=self.device),
        )  # (B, dims) float32
        scores = emb @ self.head["w"] + self.head["b"]
        return scores.cpu().numpy().astype(np.float32)

    def rerank(
        self, query: str, candidates: list[tuple[str, str]], limit: int = 0
    ) -> list[tuple[str, float]]:
        """candidates: [(id, text)] -> [(id, score)] best-first."""
        scores = self.score_pairs(query, [t for _, t in candidates])
        order = np.argsort(-scores)
        out = [(candidates[i][0], float(scores[i])) for i in order]
        return out[:limit] if limit else out
