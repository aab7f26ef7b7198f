"""In-image pretraining in the port: the counterpart of
``nornicdb_tpu/models/pretrain.py``.

Small REAL models trained on a synthetic, deterministic domain corpus (the
assistant decoder with a next-token LM loss, the embedding encoder with
InfoNCE, a shallower student distilled from a trained encoder), saved as
checkpoints and loaded back into the serving paths: ``load_generator``
mounts an assistant checkpoint on Heimdall's ``QwenGenerator``,
``load_embedder`` an encoder checkpoint on ``DeviceEmbedder``.

``VocabTokenizer``, the corpora (``synth_corpus``, ``synth_action_corpus``,
``action_eval_cases`` and their helpers) and ``_augment`` are verbatim
copies of the JAX package's (pure Python and numpy): the same seed gives the
same strings. ``train_assistant``, ``train_encoder`` and ``distill_encoder``
keep the JAX arguments, defaults, numpy batch order and returned dict, and
take a ``device`` (``None`` means CUDA). A checkpoint directory has the JAX
layout, so either package loads what the other wrote: ``config.json``
(``kind``, the config fields, ``trained_seq_len`` or ``distilled_from``),
``model.safetensors`` and ``vocab.json``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

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


# ------------------------------------------------------------- corpus
_CAPITALS = {
    "norway": "oslo", "sweden": "stockholm", "denmark": "copenhagen",
    "iceland": "reykjavik", "finland": "helsinki", "france": "paris",
    "germany": "berlin", "spain": "madrid", "italy": "rome",
    "japan": "tokyo", "canada": "ottawa", "egypt": "cairo",
}

_GRAPH_FACTS = [
    "nornicdb is a graph database that learns from how memories are used.",
    "a node has labels and properties.",
    "an edge connects two nodes and has a relationship type.",
    "cypher is the query language for the graph.",
    "match finds nodes and return sends them back.",
    "create adds new nodes to the graph.",
    "vector search finds the most similar memories.",
    "memory decay lowers the score of unused memories over time.",
    "the embed queue turns text into vectors in the background.",
    "heimdall is the assistant that answers questions about the graph.",
    "a composite database routes queries to its constituents.",
    "the wal makes every write durable before it is acknowledged.",
]

_QA_TEMPLATES = [
    ("user: what is the capital of {c} ? assistant: the capital of {c} is {cap}.",
     "capitals"),
    ("user: where is {cap} ? assistant: {cap} is the capital of {c}.",
     "capitals"),
    ("user: how do i find all {l} nodes ? "
     "assistant: match ( n : {l} ) return n.", "cypher"),
    ("user: how do i count {l} nodes ? "
     "assistant: match ( n : {l} ) return count ( n ).", "cypher"),
    ("user: how do i create a {l} node ? "
     "assistant: create ( n : {l} ) return n.", "cypher"),
]

_LABELS = ["person", "city", "memory", "task", "document", "project",
           "event", "topic"]


def synth_corpus(seed: int = 0, repeats: int = 40) -> list[str]:
    """Deterministic assistant-domain corpus: graph facts, capital facts,
    and user/assistant chat turns with Cypher answers. `repeats` scales the
    token count (~25k words at 40)."""
    rng = np.random.default_rng(seed)
    lines: list[str] = []
    for _ in range(repeats):
        lines.extend(_GRAPH_FACTS)
        for c, cap in _CAPITALS.items():
            lines.append(f"the capital of {c} is {cap}.")
        for tpl, kind in _QA_TEMPLATES:
            if kind == "capitals":
                for c, cap in _CAPITALS.items():
                    lines.append(tpl.format(c=c, cap=cap))
            else:
                for l in _LABELS:
                    lines.append(tpl.format(l=l))
    idx = rng.permutation(len(lines))
    return [lines[i] for i in idx]


# ------------------------------------------------- action-mode corpus
# Chat turns whose assistant side is a JSON action (the reference's ACTION
# MODE, pkg/heimdall/handler.go:516 tryParseAction): the model must LEARN to
# emit machine-parseable {"action": ...} objects for database-operation
# prompts. Phrasing x label combinations are split train/held-out so the
# action-parse rate is measured on prompts never seen in training
# (`action_eval_cases`).
_ACTION_INTENTS = [
    # (intent, phrasing templates, cypher template or None for status)
    ("count", [
        "how many {l} nodes are there ?",
        "count the {l} nodes",
        "what is the number of {l} nodes ?",
        "give me the {l} node count",
    ], "match ( n : {l} ) return count ( n )"),
    ("find_all", [
        "show me all {l} nodes",
        "list the {l} nodes",
        "find every {l} node",
        "fetch all {l} nodes please",
    ], "match ( n : {l} ) return n limit 25"),
    ("named", [
        "find {l} nodes that have a name",
        "which {l} nodes are named ?",
        "show {l} nodes with a name property",
    ], "match ( n : {l} ) where n.name is not null return n"),
    ("neighbors", [
        "what is connected to the {l} nodes ?",
        "show the neighbors of {l} nodes",
        "which nodes link to a {l} node ?",
    ], "match ( n : {l} ) - [ r ] - ( m ) return m limit 25"),
]

_STATUS_PROMPTS = [
    "is the database healthy ?",
    "what is the database status ?",
    "how big is the graph ?",
    "give me a status report",
    "are things running ok ?",
]

# wider label set than _LABELS: label copying (prompt -> cypher) only beats
# label memorization when enough distinct labels share each template
_ACTION_LABELS = _LABELS + [
    "user", "order", "product", "article", "meeting", "note", "team",
    "ticket", "region", "device", "session", "invoice",
]


def _action_json(cypher: Optional[str]) -> str:
    """Action JSON in the word-tokenizer's native spacing, so the training
    text round-trips through encode/decode unchanged."""
    if cypher is None:
        return '{ " action " : " status " , " params " : { } }'
    return ('{ " action " : " query " , " params " : '
            '{ " cypher " : " ' + cypher + ' " } }')


def _action_pairs():
    """Every (prompt, cypher-or-None) pair in the action domain."""
    pairs = []
    for intent, templates, cy in _ACTION_INTENTS:
        for ti, tpl in enumerate(templates):
            for li, label in enumerate(_ACTION_LABELS):
                pairs.append((intent, ti, li, tpl.format(l=label),
                              cy.format(l=label)))
    for i, p in enumerate(_STATUS_PROMPTS):
        pairs.append(("status", i, -1, p, None))
    return pairs


def _is_held_out(intent: str, ti: int, li: int) -> bool:
    # hold out (template, label) combinations — both the phrasing and the
    # label appear in training, their pairing does not (compositional split);
    # for status (no label) one phrasing is held out entirely
    if li < 0:
        return ti == len(_STATUS_PROMPTS) - 1
    return (ti + li) % 5 == 0


# the Cypher primer of Heimdall's served context, a copy of
# ``nornicdb_tpu/heimdall/context.py``'s CYPHER_PRIMER
CYPHER_PRIMER = """CYPHER QUERY REFERENCE:
Patterns: MATCH (n) | MATCH (n:Label) | MATCH (n {prop: v}) | MATCH (n)-[r:TYPE]->(m)
Common: MATCH (n) RETURN count(n) | MATCH (n:L) RETURN n LIMIT 10 | MATCH ()-[r]->() RETURN type(r), count(r)
Filters: WHERE n.p = 'v' | CONTAINS | STARTS WITH | IS NOT NULL | n.p > 10
Aggregates: count, collect, sum, avg, min, max
Paths: MATCH p = (a)-[*1..3]->(b) | shortestPath((a)-[*]->(b))
Writes: CREATE (n:L {p: 'v'}) | SET n.p = 'v' | DETACH DELETE n
Vector: CALL db.index.vector.queryNodes('idx', 50, 'QUERY') YIELD node, score
"""


def _serving_preamble_lines() -> list[str]:
    """The REAL Heimdall serving context (PromptContext._build_full_prompt +
    CYPHER_PRIMER), as corpus lines: training on it keeps the served system
    prompt fully in-vocab (no <unk> floods at chat time) and teaches the
    model the text that precedes every real user turn."""
    lines = [
        "You are Heimdall, the AI assistant for NornicDB - a "
        "high-performance graph database.",
        "Your role is to help users manage the database by executing "
        "actions and running Cypher queries.",
        "AVAILABLE ACTIONS:",
        "- heal: re-embed nodes with missing vectors",
        "- query: run a read-only Cypher query. params: "
        '{"action": "query", "params": {"cypher": "MATCH ..."}}',
        "- status: database health and node/edge counts. params: "
        '{"action": "status", "params": {}}',
        "RESPONSE MODES:",
        "1. ACTION MODE - For database operations, respond with JSON:",
        '{"action": "status", "params": {}}',
        '{"action": "query", "params": {"cypher": "MATCH (n) RETURN '
        'count(n)"}}',
        "2. HELP MODE - For Cypher questions, explain with examples.",
        "IMPORTANT: Always complete your JSON responses with proper "
        "closing braces.",
        "Respond with JSON action command only. No explanations, "
        "no markdown.",
    ] + [ln for ln in CYPHER_PRIMER.splitlines() if ln.strip()]
    return lines


_SERVED_TAIL = ("respond with json action command only . no explanations , "
                "no markdown .")


def synth_action_corpus(seed: int = 0, repeats: int = 6) -> list[str]:
    """Training lines for ACTION MODE: 'user: <prompt> assistant: <json>'.

    Every pair is also emitted in SERVED form — prefixed with the closing
    line of the real system prompt — so the chat path (full context prompt,
    trimmed to the trained window) is in-distribution, not just the bare
    generator path. Held-out combinations are excluded — see
    action_eval_cases."""
    rng = np.random.default_rng(seed + 7)
    lines = []
    for _ in range(repeats):
        lines.extend(_serving_preamble_lines())
        for intent, ti, li, prompt, cypher in _action_pairs():
            if _is_held_out(intent, ti, li):
                continue
            bare = f"user: {prompt} assistant: {_action_json(cypher)}"
            lines.append(bare)
            lines.append(f"{_SERVED_TAIL} user: {prompt} assistant: "
                         f"{_action_json(cypher)}")
    idx = rng.permutation(len(lines))
    return [lines[i] for i in idx]


def action_eval_cases() -> list[dict]:
    """Held-out (never-trained) prompts with their expected action."""
    cases = []
    for intent, ti, li, prompt, cypher in _action_pairs():
        if _is_held_out(intent, ti, li):
            cases.append({"prompt": prompt, "intent": intent,
                          "action": "status" if cypher is None else "query",
                          "cypher": cypher})
    return cases


# ------------------------------------------------------------- LM training
def _write_checkpoint(out_dir: str, params, tok: VocabTokenizer,
                      config: dict) -> None:
    """The JAX package's checkpoint layout: model.safetensors, vocab.json
    and config.json."""
    from nornicdb_tpu_torch.models import weights

    os.makedirs(out_dir, exist_ok=True)
    weights.save_params(os.path.join(out_dir, "model.safetensors"), params)
    tok.save(os.path.join(out_dir, "vocab.json"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f)


def _bge_config_json(cfg) -> dict:
    return {
        "kind": "bge", "vocab_size": cfg.vocab_size,
        "hidden": cfg.hidden, "layers": cfg.layers, "heads": cfg.heads,
        "intermediate": cfg.intermediate,
        "max_positions": cfg.max_positions, "dims": cfg.dims,
        "pad_token_id": cfg.pad_token_id,
    }


def train_assistant(
    out_dir: str,
    steps: int = 300,
    batch: int = 16,
    seq_len: int = 48,
    hidden: int = 96,
    layers: int = 2,
    lr: float = 3e-3,
    seed: int = 0,
    corpus: Optional[list[str]] = None,
    log_every: int = 50,
    device: DeviceLike = None,
) -> dict:
    """Train a tiny Qwen2-architecture decoder on the synthetic corpus on
    ``device`` (``None`` means CUDA) and save a loadable checkpoint.
    Returns {"loss_first", "loss_last", ...}."""
    from nornicdb_tpu_torch.models import qwen2, training

    dev = resolve_device(device)
    texts = corpus if corpus is not None else synth_corpus(seed)
    tok = VocabTokenizer.from_corpus(texts)
    stream: list[int] = []
    for t in texts:
        stream.extend(tok.encode(t, add_special=False) + [tok.eos_id])
    ids = np.asarray(stream, np.int32)

    vocab = ((tok.vocab_size + 63) // 64) * 64  # pad vocab to a lane multiple
    cfg = qwen2.QwenConfig(
        vocab_size=vocab, hidden=hidden, layers=layers,
        heads=4, kv_heads=2, intermediate=hidden * 3,
        max_positions=512, rope_theta=10000.0,
    )
    opt = training.make_optimizer(lr=lr)
    state = training.init_lm_train_state(cfg, opt, seed=seed, device=dev)
    step_fn = training.make_lm_train_step(cfg, opt)

    rng = np.random.default_rng(seed)
    n_windows = len(ids) - seq_len - 1
    losses: list[float] = []
    for s in range(steps):
        starts = rng.integers(0, n_windows, size=batch)
        wins = torch.from_numpy(
            np.stack([ids[st:st + seq_len + 1] for st in starts])).to(dev)
        b = {"ids": wins, "mask": torch.ones_like(wins)}
        state, loss = step_fn(state, b)
        if s % log_every == 0 or s == steps - 1:
            losses.append(float(loss))

    _write_checkpoint(out_dir, state.params, tok, {
        "kind": "qwen2",
        "vocab_size": cfg.vocab_size, "hidden": cfg.hidden,
        "layers": cfg.layers, "heads": cfg.heads,
        "kv_heads": cfg.kv_heads, "intermediate": cfg.intermediate,
        "max_positions": cfg.max_positions,
        "rope_theta": cfg.rope_theta,
        # rope positions beyond the training window are OOD for a
        # from-scratch model: serving trims prompts to this length
        "trained_seq_len": seq_len,
    })
    return {
        "loss_first": losses[0], "loss_last": losses[-1],
        "steps": steps, "vocab": tok.vocab_size, "tokens": len(ids),
    }


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


# --------------------------------------------------------- encoder training
def _augment(text: str, rng: np.random.Generator, drop: float = 0.3) -> str:
    """Word-dropout view of a document (the standard self-supervised
    contrastive augmentation when no labeled pairs exist in-image)."""
    words = _WORD_RE.findall(text.lower())
    kept = [w for w in words if rng.random() > drop]
    if not kept:
        kept = words[:1]
    return " ".join(kept)


def _padded_side(tok: VocabTokenizer, docs, width: int,
                 dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``docs`` tokenized, cut and padded to ``width``: (ids, mask) int32
    on ``dev``."""
    ids, masks = tok.encode_batch(docs, max_len=width)
    ids = [s + [tok.pad_id] * (width - len(s)) for s in ids]
    masks = [m + [0] * (width - len(m)) for m in masks]
    return (torch.tensor(ids, dtype=torch.int32).to(dev),
            torch.tensor(masks, dtype=torch.int32).to(dev))


def train_encoder(
    out_dir: str,
    steps: int = 200,
    batch: int = 32,
    hidden: int = 128,
    layers: int = 2,
    dims: int = 64,
    max_len: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    corpus: Optional[list[str]] = None,
    log_every: int = 50,
    device: DeviceLike = None,
) -> dict:
    """InfoNCE-train a small bge-architecture encoder on (doc, word-dropout
    view) pairs from the synthetic corpus on ``device`` (``None`` means
    CUDA); save a loadable checkpoint."""
    from nornicdb_tpu_torch.models import bge_m3, training

    dev = resolve_device(device)
    texts = corpus if corpus is not None else synth_corpus(seed, repeats=10)
    texts = sorted(set(texts))
    tok = VocabTokenizer.from_corpus(texts)
    vocab = ((tok.vocab_size + 63) // 64) * 64
    cfg = bge_m3.BgeConfig(
        vocab_size=vocab, hidden=hidden, layers=layers, heads=4,
        intermediate=hidden * 2, max_positions=max_len + 8, dims=dims,
        pad_token_id=tok.pad_id,
    )
    opt = training.make_optimizer(lr=lr)
    state = training.init_train_state(cfg, opt, seed=seed, device=dev)
    step_fn = training.make_train_step(cfg, opt)

    rng = np.random.default_rng(seed)
    losses: list[float] = []
    for s in range(steps):
        docs = [texts[i] for i in rng.integers(0, len(texts), size=batch)]
        ids_a, mask_a = _padded_side(tok, docs, max_len, dev)
        ids_b, mask_b = _padded_side(tok, [_augment(d, rng) for d in docs],
                                     max_len, dev)
        b = {"ids_a": ids_a, "mask_a": mask_a,
             "ids_b": ids_b, "mask_b": mask_b}
        state, loss = step_fn(state, b)
        if s % log_every == 0 or s == steps - 1:
            losses.append(float(loss))

    _write_checkpoint(out_dir, state.params, tok, _bge_config_json(cfg))
    return {"loss_first": losses[0], "loss_last": losses[-1], "steps": steps}


def _load_bge(model_dir: str, dev: torch.device):
    """(cfg, params, tokenizer) of an encoder checkpoint on ``dev``."""
    from nornicdb_tpu_torch.models import bge_m3, weights

    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    if c.pop("kind") != "bge":
        raise ValueError(f"{model_dir} is not an encoder checkpoint")
    # provenance metadata, not architecture; chained distillation
    # (24L -> 4L -> 2L) reads a student as a teacher
    c.pop("distilled_from", None)
    flat = weights.load_safetensors(
        os.path.join(model_dir, "model.safetensors"))
    _reconcile_pre_projection_checkpoint(c, flat)
    cfg = bge_m3.BgeConfig(**c)
    template = bge_m3.init_params(cfg, 0, dev)
    params = weights.unflatten_params(flat, template, dev)
    del template, flat
    tok = VocabTokenizer.load(os.path.join(model_dir, "vocab.json"))
    return cfg, params, tok


def distill_encoder(
    teacher_dir: str,
    out_dir: str,
    layers: int = 2,
    hidden: int = 0,
    steps: int = 300,
    batch: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    corpus: Optional[list[str]] = None,
    log_every: int = 50,
    device: DeviceLike = None,
) -> dict:
    """Distill a trained encoder checkpoint into a SHALLOWER student on
    ``device`` (``None`` means CUDA).

    The student shares the teacher's tokenizer and output dims (drop-in for
    serving) and trains to match the teacher's embeddings on the corpus
    (cosine loss — the retrieval-relevant objective: ranking depends only
    on directions). Works for any checkpoint saved by train_encoder. Every
    document is padded to the teacher's ``max_positions - 8`` tokens, as in
    the JAX package. Returns {"loss_first", "loss_last", "agreement"} where
    agreement is the mean student-teacher cosine on held-out corpus docs."""
    from nornicdb_tpu_torch.models import bge_m3, training

    dev = resolve_device(device)
    t_cfg, t_params, tok = _load_bge(teacher_dir, dev)

    s_cfg = bge_m3.BgeConfig(
        vocab_size=t_cfg.vocab_size,
        hidden=hidden or t_cfg.hidden,
        layers=layers,
        heads=t_cfg.heads,
        intermediate=(hidden or t_cfg.hidden) * 2,
        max_positions=t_cfg.max_positions,
        dims=t_cfg.dims,
        pad_token_id=t_cfg.pad_token_id,
    )
    max_len = t_cfg.max_positions - 8
    texts = corpus if corpus is not None else synth_corpus(seed, repeats=10)
    texts = sorted(set(texts))
    # genuinely held out: the agreement metric must measure generalization,
    # so these docs are EXCLUDED from the training pool
    held_out = texts[:: max(len(texts) // 32, 1)][:32]
    held_set = set(held_out)
    texts = [t for t in texts if t not in held_set] or held_out

    @torch.no_grad()
    def teacher_embed(ids, mask):
        return bge_m3.forward(t_params, t_cfg, ids, mask)

    def distill_loss(params, batch_arrs):
        ids, mask, target = batch_arrs
        student = bge_m3.forward(params, s_cfg, ids, mask)
        # both are L2-normalized by forward(): cosine distance
        return torch.mean(1.0 - torch.sum(student * target, dim=-1))

    opt = training.make_optimizer(lr=lr, weight_decay=0.01)
    state = training.TrainState.create(
        bge_m3.init_params(s_cfg, seed, dev), opt)
    step = training.make_step(distill_loss)

    rng = np.random.default_rng(seed)
    losses: list[float] = []
    for s in range(steps):
        docs = [texts[i] for i in rng.integers(0, len(texts), size=batch)]
        ids, mask = _padded_side(tok, docs, max_len, dev)
        target = teacher_embed(ids, mask)
        state, loss = step(state, (ids, mask, target))
        if s % log_every == 0 or s == steps - 1:
            losses.append(float(loss))

    ids, mask = _padded_side(tok, held_out, max_len, dev)
    with torch.no_grad():
        agreement = float(torch.mean(torch.sum(
            bge_m3.forward(state.params, s_cfg, ids, mask)
            * teacher_embed(ids, mask), dim=-1)))

    _write_checkpoint(out_dir, state.params, tok, {
        **_bge_config_json(s_cfg),
        "distilled_from": os.path.basename(os.path.abspath(teacher_dir)),
    })
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "agreement": agreement, "steps": steps,
            "teacher_layers": t_cfg.layers, "student_layers": s_cfg.layers}


def _reconcile_pre_projection_checkpoint(cfg_dict: dict, flat: dict) -> None:
    """Checkpoints saved before the dims-projection head existed carry
    dims != hidden but no proj tensors (forward used to ignore dims and
    output hidden width). Restore their true output width so the template
    matches the file instead of KeyError'ing on proj.*."""
    if cfg_dict.get("dims") != cfg_dict.get("hidden") and not any(
            k.startswith("proj") for k in flat):
        cfg_dict["dims"] = cfg_dict["hidden"]


def load_embedder(model_dir: str, device: DeviceLike = None, **kwargs):
    """Checkpoint dir -> ``embed.DeviceEmbedder`` running the trained
    encoder on ``device`` (``None`` means CUDA); ``max_len`` defaults to
    the checkpoint's ``max_positions - 8``. Other kwargs go to the
    embedder."""
    from nornicdb_tpu_torch.embed.base import DeviceEmbedder

    dev = resolve_device(device)
    cfg, params, tok = _load_bge(model_dir, dev)
    kwargs.setdefault("max_len", cfg.max_positions - 8)
    return DeviceEmbedder(cfg=cfg, params=params, tokenizer=tok, device=dev,
                          **kwargs)
