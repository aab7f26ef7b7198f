"""Tokenizers: a verbatim copy of ``nornicdb_tpu/models/tokenizer.py`` (pure
Python), kept here so the port imports nothing of the JAX package.

Two paths, mirroring the reference's split between real GGUF models and test
stubs (pkg/localllm/llama_stub.go):

  - HFTokenizer: loads a HuggingFace tokenizer.json (vocab + merges) when real
    model assets are present on disk (zero-egress environment: nothing is
    downloaded).
  - HashTokenizer: deterministic hash-bucket word tokenizer used for tests and
    random-weight models; stable across processes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Optional

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class HashTokenizer:
    """Deterministic vocabulary-free tokenizer: token = hash(word) % buckets.

    ids 0..3 are reserved: 0=<s>/CLS, 1=<pad>, 2=</s>, 3=<unk>.
    """

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        self.cls_id = 0
        self.pad_id = 1
        self.eos_id = 2
        self.unk_id = 3
        self._reserved = 4

    def _tok(self, word: str) -> int:
        h = int.from_bytes(
            hashlib.blake2s(word.lower().encode()).digest()[:4], "little"
        )
        return self._reserved + h % (self.vocab_size - self._reserved)

    def encode(self, text: str, max_len: int = 0, add_special: bool = True) -> list[int]:
        ids = [self._tok(w) for w in _WORD_RE.findall(text)]
        if add_special:
            ids = [self.cls_id] + ids + [self.eos_id]
        if max_len > 0:
            ids = ids[:max_len]
        return ids

    def encode_batch(
        self, texts: list[str], max_len: int = 0, add_special: bool = True
    ) -> tuple[list[list[int]], list[list[int]]]:
        """Returns (padded ids, attention masks)."""
        seqs = [self.encode(t, max_len, add_special) for t in texts]
        longest = max((len(s) for s in seqs), default=1)
        if max_len > 0:
            longest = min(longest, max_len)
        ids, masks = [], []
        for s in seqs:
            pad = longest - len(s)
            ids.append(s + [self.pad_id] * pad)
            masks.append([1] * len(s) + [0] * pad)
        return ids, masks

    def decode(self, ids: list[int]) -> str:  # hash tokens are lossy
        return " ".join(f"<{i}>" for i in ids)


class HFTokenizer:
    """Minimal HuggingFace tokenizer.json reader (WordPiece/BPE vocab only;
    whitespace pre-tokenization). Used when real model assets are mounted."""

    def __init__(self, path: str):
        with open(path) as f:
            spec = json.load(f)
        model = spec.get("model", {})
        self.vocab: dict[str, int] = model.get("vocab", {})
        if isinstance(self.vocab, list):  # unigram: [[piece, score], ...]
            self.vocab = {p: i for i, (p, _) in enumerate(self.vocab)}
        self.unk_id = self.vocab.get("<unk>", 3)
        self.cls_id = self.vocab.get("<s>", self.vocab.get("[CLS]", 0))
        self.eos_id = self.vocab.get("</s>", self.vocab.get("[SEP]", 2))
        self.pad_id = self.vocab.get("<pad>", self.vocab.get("[PAD]", 1))
        self.vocab_size = max(self.vocab.values()) + 1 if self.vocab else 0

    def encode(self, text: str, max_len: int = 0, add_special: bool = True) -> list[int]:
        ids = []
        for w in _WORD_RE.findall(text):
            ids.append(self.vocab.get("▁" + w, self.vocab.get(w, self.unk_id)))
        if add_special:
            ids = [self.cls_id] + ids + [self.eos_id]
        if max_len > 0:
            ids = ids[:max_len]
        return ids

    def encode_batch(self, texts, max_len: int = 0, add_special: bool = True):
        seqs = [self.encode(t, max_len, add_special) for t in texts]
        longest = max((len(s) for s in seqs), default=1)
        ids, masks = [], []
        for s in seqs:
            pad = longest - len(s)
            ids.append(s + [self.pad_id] * pad)
            masks.append([1] * len(s) + [0] * pad)
        return ids, masks


def load_tokenizer(model_dir: Optional[str], vocab_size: int = 1024):
    """Prefer a real tokenizer.json when present; else hash fallback."""
    if model_dir:
        p = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(p):
            return HFTokenizer(p)
    return HashTokenizer(vocab_size)
