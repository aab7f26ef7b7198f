"""Heimdall's generation backends: the part of ``nornicdb_tpu/heimdall/
manager.py`` that runs the model (``Generator``, ``_trim_prompt_ids``,
``_cap_new_tokens``, ``QwenGenerator``, ``EngineGenerator``).

``QwenGenerator`` is the synchronous path: one prompt at a time through
``qwen2.generate`` (a dense per-request KV cache), and a true incremental
decode for streaming. ``EngineGenerator`` fronts the continuous-batching
``genserve.GenerationEngine``, as the JAX DB wires it when generation is
enabled: chat, streaming and the QC batch become submits into the shared
paged-KV engine.

Not here: ``HeimdallManager`` (chat completions, action parsing, metrics),
the ``Bifrost`` notification bus, ``TemplateGenerator`` and the model
registry. They run no device work; they come with the DB wiring that builds
them (ROADMAP A3).
"""

from __future__ import annotations

from typing import Iterator

import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device, tree_to


class Generator:
    """Abstract generation backend."""

    def generate(self, prompt: str, max_tokens: int = 128) -> str:
        raise NotImplementedError

    def generate_stream(self, prompt: str, max_tokens: int = 128) -> Iterator[str]:
        yield self.generate(prompt, max_tokens)

    def generate_many(self, prompts: list[str],
                      max_tokens: int = 128) -> list[str]:
        """Batch generation. The base fallback is sequential; a backend with
        a serving engine (EngineGenerator) overlaps the whole batch through
        continuous batching, which Heimdall QC rides."""
        return [self.generate(p, max_tokens) for p in prompts]


def _trim_prompt_ids(tokenizer, prompt: str, max_context: int) -> list[int]:
    """Shared weights-backed prompt policy: keep the prompt TAIL within the
    model's trained window (rope positions beyond it were never seen in
    training for an in-image checkpoint)."""
    return tokenizer.encode(prompt, add_special=False)[-max_context:] or [1]


def _cap_new_tokens(max_tokens: int, max_context: int) -> int:
    """Bound decode length to one trained window beyond the prompt: ONE
    implementation for both weights-backed generators, so the window policy
    cannot diverge between the synchronous and engine paths."""
    return max(1, min(max_tokens, max_context))


class QwenGenerator(Generator):
    """The Qwen2 decoder served synchronously on ``device`` (``None`` means
    CUDA). ``params`` default to random weights from ``seed``; given ones
    are moved to ``device``."""

    def __init__(self, cfg=None, params=None, tokenizer=None, seed: int = 0,
                 max_context: int = 256, device: DeviceLike = None):
        from nornicdb_tpu_torch.models import qwen2
        from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else qwen2.QWEN_SMALL
        if params is None:
            params = qwen2.init_params(self.cfg, seed, self.device)
        # the tied logits read a float32 copy of the embedding made once
        self.params = qwen2.with_f32_logit_weights(
            tree_to(params, self.device))
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size)
        self.qwen2 = qwen2
        # prompts are trimmed to the model's trained window
        self.max_context = max_context

    def _cap_new_tokens(self, max_tokens: int) -> int:
        return _cap_new_tokens(max_tokens, self.max_context)

    def generate(self, prompt: str, max_tokens: int = 128) -> str:
        ids = _trim_prompt_ids(self.tokenizer, prompt, self.max_context)
        out = self.qwen2.generate(
            self.params, self.cfg, ids,
            max_new_tokens=self._cap_new_tokens(max_tokens),
            eos_id=getattr(self.tokenizer, "eos_id", -1),
        )
        return self.tokenizer.decode(out)

    def generate_stream(self, prompt: str, max_tokens: int = 128):
        """True incremental decode: prefill once, then one ``decode_step``
        per yielded delta. Deltas are text diffs of the running decode, so
        any tokenizer's spacing and punctuation rules hold. The cache width
        is bucketed to a power of two."""
        ids = _trim_prompt_ids(self.tokenizer, prompt, self.max_context)
        max_tokens = self._cap_new_tokens(max_tokens)
        max_len = self.qwen2.round_up_pow2(len(ids) + max_tokens)
        logits, caches = self.qwen2.prefill(
            self.params, self.cfg,
            torch.tensor([ids], dtype=torch.long, device=self.device), max_len)
        eos = getattr(self.tokenizer, "eos_id", -1)
        # one token id crosses to the host a step: the delta to yield
        tok = int(torch.argmax(logits, dim=-1)[0])
        out: list[int] = []
        prev_text = ""
        pos = len(ids)
        while len(out) < max_tokens and tok != eos:
            out.append(tok)
            text = self.tokenizer.decode(out)
            if text != prev_text:
                yield text[len(prev_text):]
                prev_text = text
            if len(out) >= max_tokens:
                break
            logits, caches = self.qwen2.decode_step(
                self.params, self.cfg,
                torch.tensor([tok], dtype=torch.long, device=self.device),
                caches, pos)
            tok = int(torch.argmax(logits, dim=-1)[0])
            pos += 1


class EngineGenerator(Generator):
    """Generator served by the genserve continuous-batching engine: every
    chat or QC generation is a submit into the shared paged-KV engine, so
    concurrent requests decode in one running batch, and admission control
    and deadline shedding apply (ResourceExhausted). Streaming is native:
    tokens are yielded as the scheduler produces them."""

    def __init__(self, engine, max_context: int = 256):
        self.engine = engine
        self.tokenizer = engine.tokenizer
        # same trained-window recency trim as QwenGenerator
        self.max_context = max_context
        # the backing model, as QwenGenerator exposes it
        self.cfg = engine.cfg
        self.params = engine.params

    def _ids(self, prompt: str) -> list[int]:
        return _trim_prompt_ids(self.tokenizer, prompt, self.max_context)

    def _cap(self, max_tokens: int) -> int:
        return _cap_new_tokens(max_tokens, self.max_context)

    def generate(self, prompt: str, max_tokens: int = 128) -> str:
        return self.tokenizer.decode(self.engine.generate(
            self._ids(prompt), max_new_tokens=self._cap(max_tokens)))

    def generate_stream(self, prompt: str, max_tokens: int = 128):
        handle = self.engine.submit(
            self._ids(prompt), max_new_tokens=self._cap(max_tokens))
        yield from handle.stream_text()

    def generate_many(self, prompts: list[str],
                      max_tokens: int = 128) -> list[str]:
        """Submit the whole batch up front: the engine's scheduler decodes
        every prompt in one continuous batch (the Heimdall QC path)."""
        cap = self._cap(max_tokens)
        handles = [self.engine.submit(self._ids(p), max_new_tokens=cap)
                   for p in prompts]
        return [self.tokenizer.decode(h.result()) for h in handles]
