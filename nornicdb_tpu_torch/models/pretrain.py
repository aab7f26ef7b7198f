"""Assistant checkpoints: the serving half of ``nornicdb_tpu/models/
pretrain.py``.

``VocabTokenizer`` is a verbatim copy of the JAX package's (pure Python),
and ``load_generator`` mounts a checkpoint directory as the JAX one does:
``config.json`` (``kind: qwen2``, the ``QwenConfig`` fields and
``trained_seq_len``), ``model.safetensors`` and ``vocab.json``. A directory
the JAX package's ``train_assistant`` wrote loads here unchanged.

The training functions (``train_assistant``, ``train_encoder``,
``distill_encoder``) are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import json
import os
import re
from typing import Sequence

from nornicdb_tpu_torch._device import DeviceLike, resolve_device

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class VocabTokenizer:
    """Word-level tokenizer with a REAL decode (the hash tokenizer is lossy,
    which is fine for embeddings but useless for generation). Vocabulary is
    built from the training corpus, most-frequent-first."""

    def __init__(self, vocab: Sequence[str]):
        self.itos = ["<s>", "<pad>", "</s>", "<unk>"] + list(vocab)
        self.stoi = {w: i for i, w in enumerate(self.itos)}
        self.cls_id, self.pad_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.vocab_size = len(self.itos)

    @classmethod
    def from_corpus(cls, texts: Sequence[str], max_vocab: int = 2048):
        freq: dict[str, int] = {}
        for t in texts:
            for w in _WORD_RE.findall(t.lower()):
                freq[w] = freq.get(w, 0) + 1
        words = sorted(freq, key=lambda w: (-freq[w], w))[: max_vocab - 4]
        return cls(words)

    def encode(self, text: str, max_len: int = 0,
               add_special: bool = True) -> list[int]:
        ids = [
            self.stoi.get(w, self.unk_id)
            for w in _WORD_RE.findall(text.lower())
        ]
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

    def decode(self, ids: Sequence[int]) -> str:
        words = [
            self.itos[i] for i in ids
            if 0 <= i < len(self.itos) and i not in (self.cls_id, self.pad_id)
        ]
        out = []
        for w in words:
            if w == "</s>":
                break
            out.append(w)
        text = " ".join(out)
        return re.sub(r"\s+([.,!?;:])", r"\1", text)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"itos": self.itos}, f)

    @classmethod
    def load(cls, path: str) -> "VocabTokenizer":
        with open(path) as f:
            itos = json.load(f)["itos"]
        tok = cls([])
        tok.itos = itos
        tok.stoi = {w: i for i, w in enumerate(itos)}
        tok.vocab_size = len(itos)
        return tok


def load_generator(model_dir: str, device: DeviceLike = None):
    """Checkpoint dir -> ``heimdall.QwenGenerator`` serving its weights on
    ``device`` (``None`` means CUDA) through the prefill + KV-cache decode
    path. Prompts are trimmed to the checkpoint's ``trained_seq_len``
    (else 256)."""
    from nornicdb_tpu_torch.heimdall.manager import QwenGenerator
    from nornicdb_tpu_torch.models import qwen2, weights

    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    if c.pop("kind") != "qwen2":
        raise ValueError(f"{model_dir} is not an assistant checkpoint")
    trained_seq_len = c.pop("trained_seq_len", 0)
    cfg = qwen2.QwenConfig(**c)
    template = qwen2.init_params(cfg, 0, dev)
    params = weights.load_params(
        os.path.join(model_dir, "model.safetensors"), template, dev)
    del template
    tok = VocabTokenizer.load(os.path.join(model_dir, "vocab.json"))
    return QwenGenerator(cfg=cfg, params=params, tokenizer=tok,
                         max_context=trained_seq_len or 256, device=dev)
