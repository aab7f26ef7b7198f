"""Qwen2-architecture decoder (Qwen2.5-0.5B-Instruct shape) in PyTorch.

Counterpart of ``nornicdb_tpu/models/qwen2.py``: pre-norm RMSNorm decoder,
RoPE, grouped-query attention, SwiGLU MLP, tied embeddings. Parameters are
the JAX package's pytree as a dict of tensors (dense weights ``(in, out)``),
so ``convert.qwen2_params_from_jax`` carries them over leaf by leaf.

Where the JAX functions donate a KV buffer, these update it in place
(``index_put_`` / slice assignment) and return the same tensor. Where the
reference compiles one decode-step program a cache width, the port
captures the step over one dense cache as a CUDA graph (``DecodeGraph``).

Presets: QWEN25_05B (real shape), QWEN_SMALL (tests).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.models.layers import (
    _rotate,
    apply_rope,
    attention,
    dense,
    repeat_kv,
    rms_norm,
    rope_freqs,
)


@dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 151936
    hidden: int = 896
    layers: int = 24
    heads: int = 14
    kv_heads: int = 2
    intermediate: int = 4864
    max_positions: int = 32768
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"


QWEN25_05B = QwenConfig()
QWEN_SMALL = QwenConfig(
    vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2,
    intermediate=128, max_positions=256, rope_theta=10000.0,
)


def torch_dtype(cfg: QwenConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: QwenConfig, seed: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters with the reference's distributions: normal * 0.02
    embeddings, glorot-uniform dense weights, zero biases, unit norm scales
    (float32, as the reference keeps them). Drawn in float32 from a
    ``torch.Generator`` on the target device, then cast to ``cfg.dtype``.
    The numbers differ from ``jax.random``'s: the tests carry JAX parameters
    over with ``convert.qwen2_params_from_jax`` instead."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    dtype = torch_dtype(cfg)
    head_dim = cfg.hidden // cfg.heads

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def glorot(d_in, d_out, bias=True):
        lim = float(np.sqrt(6.0 / (d_in + d_out)))
        w = torch.rand((d_in, d_out), generator=gen, device=dev)
        p = {"w": (w * (2 * lim) - lim).to(dtype)}
        if bias:
            p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
        return p

    def norm():
        return {"scale": torch.ones((cfg.hidden,), device=dev)}

    params = {"tok_emb": normal((cfg.vocab_size, cfg.hidden)),
              "final_norm": norm(), "blocks": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = glorot(cfg.hidden, cfg.vocab_size, bias=False)
    for _ in range(cfg.layers):
        params["blocks"].append({
            "q": glorot(cfg.hidden, cfg.heads * head_dim),
            "k": glorot(cfg.hidden, cfg.kv_heads * head_dim),
            "v": glorot(cfg.hidden, cfg.kv_heads * head_dim),
            "o": glorot(cfg.heads * head_dim, cfg.hidden, bias=False),
            "attn_norm": norm(),
            "gate": glorot(cfg.hidden, cfg.intermediate, bias=False),
            "up": glorot(cfg.hidden, cfg.intermediate, bias=False),
            "down": glorot(cfg.intermediate, cfg.hidden, bias=False),
            "mlp_norm": norm(),
        })
    return params


def with_f32_logit_weights(params: dict) -> dict:
    """A shallow copy of ``params`` that also holds a float32 copy of the
    tied embedding (``tok_emb_f32``): the tied logits are a float32 product,
    and casting the (V, hidden) table every step would move 136M values at
    the real vocabulary; the copy is made once. A float32 table is used as
    it is."""
    out = dict(params)
    if "tok_emb_f32" not in out:
        emb = params["tok_emb"]
        out["tok_emb_f32"] = emb if emb.dtype == torch.float32 else emb.float()
    return out


@functools.lru_cache(maxsize=32)
def _angles(head_dim: int, max_len: int, theta: float,
            device: torch.device) -> torch.Tensor:
    """rope_freqs on ``device``, made once per shape (a step would otherwise
    copy the table from the host every call)."""
    return rope_freqs(head_dim, max_len, theta, device)


def _block(cfg: QwenConfig, blk: dict, h, angles, mask, kv_cache=None,
           pos: Union[int, torch.Tensor] = 0):
    b, t, _ = h.shape
    head_dim = cfg.hidden // cfg.heads
    n_rep = cfg.heads // cfg.kv_heads
    x = rms_norm(blk["attn_norm"], h, cfg.rms_eps)
    q = dense(blk["q"], x).reshape(b, t, cfg.heads, head_dim)
    k = dense(blk["k"], x).reshape(b, t, cfg.kv_heads, head_dim)
    v = dense(blk["v"], x).reshape(b, t, cfg.kv_heads, head_dim)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    if kv_cache is not None:
        ck, cv = kv_cache  # (B, Tmax, Hkv, Dh), written in place
        if isinstance(pos, torch.Tensor):  # (t,) slots on the device
            ck.index_copy_(1, pos, k)
            cv.index_copy_(1, pos, v)
        else:
            ck[:, pos:pos + t] = k
            cv[:, pos:pos + t] = v
        k, v = ck, cv
    o = attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), mask)
    h = h + dense(blk["o"], o.reshape(b, t, cfg.heads * head_dim))
    return _mlp(cfg, blk, h)


def _mlp(cfg: QwenConfig, blk: dict, h):
    x = rms_norm(blk["mlp_norm"], h, cfg.rms_eps)
    return h + dense(blk["down"],
                     F.silu(dense(blk["gate"], x)) * dense(blk["up"], x))


def _logits(params, cfg: QwenConfig, h):
    if cfg.tie_embeddings:
        emb = params.get("tok_emb_f32")
        if emb is None:
            emb = params["tok_emb"].float()
        return torch.matmul(h.float(), emb.T)
    return dense(params["lm_head"], h).float()


def _causal(q_pos: torch.Tensor, k_len: int) -> torch.Tensor:
    """Additive mask, 0 where key slot <= the query's position, else -1e30;
    q_pos (..., Tq) -> (..., Tq, k_len)."""
    slot = torch.arange(k_len, device=q_pos.device)
    return torch.where(slot <= q_pos[..., None], 0.0, -1e30)


def forward(params: dict, cfg: QwenConfig, input_ids: torch.Tensor
            ) -> torch.Tensor:
    """(B, T) -> (B, T, V) float32 logits, causal, no cache."""
    b, t = input_ids.shape
    dev = input_ids.device
    h = params["tok_emb"][input_ids]
    angles = _angles(cfg.hidden // cfg.heads, t, cfg.rope_theta, dev)
    mask = _causal(torch.arange(t, device=dev), t)[None, None]
    for blk in params["blocks"]:
        h = _block(cfg, blk, h, angles, mask)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)


def init_kv_cache(cfg: QwenConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> list:
    head_dim = cfg.hidden // cfg.heads
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
             torch.zeros(shape, dtype=torch_dtype(cfg), device=dev))
            for _ in range(cfg.layers)]


@torch.no_grad()
def prefill(params, cfg: QwenConfig, input_ids: torch.Tensor, max_len: int):
    """Run the prompt through the model filling a (B, max_len) KV cache.
    Returns (last_logits (B, V), caches)."""
    b, t = input_ids.shape
    dev = input_ids.device
    h = params["tok_emb"][input_ids]
    angles = _angles(cfg.hidden // cfg.heads, max_len, cfg.rope_theta,
                     dev)[:t]
    mask = _causal(torch.arange(t, device=dev), max_len)[None, None]
    caches = init_kv_cache(cfg, b, max_len, dev)
    for blk, cache in zip(params["blocks"], caches):
        h = _block(cfg, blk, h, angles, mask, kv_cache=cache, pos=0)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)[:, -1, :], caches


def _cached_step(params, cfg: QwenConfig, token: torch.Tensor, caches,
                 pos: Union[int, torch.Tensor], full_angles: torch.Tensor):
    """The single-token cached decoder body (the reference's shared
    implementation behind its decode scan and ``decode_step``). ``pos`` is
    a host int or a (1,) device tensor; the latter reads no host value, so
    :class:`DecodeGraph` can capture the step once and replay it at any
    position."""
    max_len = caches[0][0].shape[1]
    h = params["tok_emb"][token[:, None]]
    if isinstance(pos, torch.Tensor):
        angles = full_angles.index_select(0, pos)
    else:
        angles = full_angles[pos:pos + 1]
    slot = torch.arange(max_len, device=token.device)
    mask = torch.where(slot <= pos, 0.0, -1e30)[None, None, None]
    for blk, cache in zip(params["blocks"], caches):
        h = _block(cfg, blk, h, angles, mask, kv_cache=cache, pos=pos)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)[:, 0, :], caches


@torch.no_grad()
def decode_step(params, cfg: QwenConfig, token: torch.Tensor, caches,
                pos: int):
    """ONE cached decode step: (B,) token at position ``pos`` -> ((B, V)
    logits, caches). The caches are updated in place (the reference donates
    them) and returned."""
    max_len = caches[0][0].shape[1]
    full_angles = _angles(cfg.hidden // cfg.heads, max_len, cfg.rope_theta,
                          token.device)
    return _cached_step(params, cfg, token, caches, int(pos), full_angles)


class DecodeGraph:
    """``decode_step`` over ONE dense cache as a CUDA graph, the port's
    counterpart of the reference's compiled step program. A step of the
    eager body is ~70 kernel launches a layer from Python, so at batch 1 the
    host, not the card, sets its time; the graph replays them with one
    launch. The token and the position are device buffers that the graph
    reads, so one capture serves every later position of this cache.

    The first :meth:`step` runs the body eagerly on ``stream`` (its logits
    are that step's result, and the run is the warm-up a capture needs:
    cuBLAS's workspace on that stream), then captures the body there; each
    later step replays it on the current stream. The caches are updated in
    place and must outlive the graph, which holds them."""

    def __init__(self, params, cfg: QwenConfig, caches, stream):
        self._params, self._cfg, self._caches = params, cfg, caches
        self._stream = stream
        dev = caches[0][0].device
        self._angles = _angles(cfg.hidden // cfg.heads, caches[0][0].shape[1],
                               cfg.rope_theta, dev)
        self._tok = torch.zeros((1,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((1,), dtype=torch.long, device=dev)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._logits: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, token: int, pos: int) -> torch.Tensor:
        """(1, V) float32 logits of ``token`` at position ``pos``. The
        tensor is the graph's output buffer: read it before the next
        step."""
        self._tok.fill_(int(token))
        self._pos.fill_(int(pos))
        if self._graph is not None:
            self._graph.replay()
            return self._logits
        cur = torch.cuda.current_stream(self._tok.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            logits, _ = _cached_step(self._params, self._cfg, self._tok,
                                     self._caches, self._pos, self._angles)
            graph = torch.cuda.CUDAGraph()
            # thread_local: other threads may use the card meanwhile
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._logits, _ = _cached_step(
                    self._params, self._cfg, self._tok, self._caches,
                    self._pos, self._angles)
            finally:
                graph.capture_end()
        cur.wait_stream(self._stream)
        logits.record_stream(cur)
        self._graph = graph
        return logits


def round_up_pow2(n: int, floor: int = 64) -> int:
    """Bucket a length to a power of two (at least ``floor``), as the
    reference buckets cache lengths and step shapes."""
    out = floor
    while out < n:
        out *= 2
    return out


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One draw a row from ``softmax(logits / temperature)``: the argmax of
    ``logits / T`` plus Gumbel noise from ``generator`` (the Gumbel-max draw
    ``jax.random.categorical`` also makes; the two packages' random streams
    differ, so one seed draws other tokens). Stays on the logits' device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_(tiny, 1.0)))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


@torch.no_grad()
def decode(params, cfg: QwenConfig, first_token: torch.Tensor, caches,
           start_pos: int, steps: int, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None, eos_id: int = -1
           ) -> torch.Tensor:
    """Greedy (``temperature == 0``) or sampled decode of ``steps`` tokens
    after ``first_token`` (B,) at position ``start_pos`` (the prompt length)
    with the dense KV cache, updated in place. Returns (B, steps) tokens on
    the device; once a row emits ``eos_id`` every later token of it is
    ``eos_id``. Nothing leaves the device: the caller syncs once, for the
    result."""
    b = first_token.shape[0]
    dev = first_token.device
    max_len = caches[0][0].shape[1]
    full_angles = _angles(cfg.hidden // cfg.heads, max_len, cfg.rope_theta,
                          dev)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    toks = torch.empty((b, steps), dtype=torch.long, device=dev)
    tok = first_token.long()
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(steps):
        logits, caches = _cached_step(params, cfg, tok, caches,
                                      int(start_pos) + i, full_angles)
        if temperature > 0:
            nxt = sample_tokens(logits, temperature, generator)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(done, eos_id, nxt)
        done = done | (nxt == eos_id)
        toks[:, i] = nxt
        tok = nxt
    return toks


@torch.no_grad()
def generate(params, cfg: QwenConfig, prompt_ids: list[int],
             max_new_tokens: int = 32, temperature: float = 0.0,
             eos_id: int = -1, seed: int = 0) -> list[int]:
    """Prefill + decode on the parameters' device; the generated ids, cut
    before the first ``eos_id``. The first token is the prefill's argmax;
    at ``temperature > 0`` the rest are drawn with a ``torch.Generator`` on
    that device seeded from ``seed``."""
    dev = params["tok_emb"].device
    ids = torch.tensor([list(prompt_ids)], dtype=torch.long, device=dev)
    max_len = ids.shape[1] + max_new_tokens
    logits, caches = prefill(params, cfg, ids, max_len)
    first = torch.argmax(logits, dim=-1)
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(seed))
    toks = decode(params, cfg, first, caches, ids.shape[1],
                  steps=max_new_tokens - 1, temperature=temperature,
                  generator=generator, eos_id=eos_id)
    out = torch.cat([first[:, None], toks], dim=1)[0].tolist()
    if eos_id >= 0 and eos_id in out:
        out = out[: out.index(eos_id)]
    return out


# -- paged KV cache -----------------------------------------------------------
#
# One pool of fixed-size pages shared by every sequence, plus a per-sequence
# page table mapping logical pages -> physical pool slots (Ragged Paged
# Attention). Physical page 0 is RESERVED as the null/scratch page: padded
# lanes and padded chunk positions route their writes there, so a step never
# corrupts a live page.

NULL_PAGE = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Logical pages needed to hold n_tokens cache slots."""
    return max(1, -(-n_tokens // page_size))


def init_kv_pages(cfg: QwenConfig, num_pages: int, page_size: int,
                  device: DeviceLike = None) -> torch.Tensor:
    """One pooled KV buffer: (layers, 2[k|v], num_pages, page_size,
    kv_heads, head_dim). Page 0 is the null page."""
    head_dim = cfg.hidden // cfg.heads
    return torch.zeros(
        (cfg.layers, 2, num_pages, page_size, cfg.kv_heads, head_dim),
        dtype=torch_dtype(cfg), device=resolve_device(device))


def _apply_rope_rows(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """apply_rope with PER-ROW positions: x (B, T, H, Dh), angles
    (B, T, Dh/2)."""
    return _rotate(x, torch.cos(angles)[:, :, None, :],
                   torch.sin(angles)[:, :, None, :])


def _paged_attention(cfg: QwenConfig, pages, li: int, page_tables, q, mask):
    """Block-gather one layer's K/V pages for every sequence and attend.
    page_tables: (B, P) physical page ids; q: (B, T, H, Dh)."""
    b, p = page_tables.shape
    ps = pages.shape[3]
    n_rep = cfg.heads // cfg.kv_heads
    head_dim = cfg.hidden // cfg.heads
    idx = page_tables.long()
    k_all = pages[li, 0][idx].reshape(b, p * ps, cfg.kv_heads, head_dim)
    v_all = pages[li, 1][idx].reshape(b, p * ps, cfg.kv_heads, head_dim)
    return attention(q, repeat_kv(k_all, n_rep), repeat_kv(v_all, n_rep), mask)


def _layer_qkv(cfg: QwenConfig, blk: dict, h, angles):
    """Norm, QKV projections and per-row rope of one layer for (B, T)
    rows."""
    b, t, _ = h.shape
    head_dim = cfg.hidden // cfg.heads
    x = rms_norm(blk["attn_norm"], h, cfg.rms_eps)
    q = dense(blk["q"], x).reshape(b, t, cfg.heads, head_dim)
    k = dense(blk["k"], x).reshape(b, t, cfg.kv_heads, head_dim)
    v = dense(blk["v"], x).reshape(b, t, cfg.kv_heads, head_dim)
    return _apply_rope_rows(q, angles), _apply_rope_rows(k, angles), v


def _layer_out(cfg: QwenConfig, blk: dict, h, o):
    b, t = o.shape[:2]
    h = h + dense(blk["o"], o.reshape(b, t, cfg.heads * (cfg.hidden // cfg.heads)))
    return _mlp(cfg, blk, h)


@torch.no_grad()
def paged_decode_step(params, cfg: QwenConfig, tokens: torch.Tensor,
                      pages: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor):
    """ONE decode step for a whole running batch over the paged pool.

    tokens: (B,) current token per sequence (position = lengths[b]);
    page_tables: (B, P) physical page per logical page (NULL_PAGE pads);
    lengths: (B,) cache slots already written per sequence. Returns ((B, V)
    logits, pages); the step's K/V are written into ``pages`` in place."""
    b = tokens.shape[0]
    p = page_tables.shape[1]
    ps = pages.shape[3]
    max_len = p * ps
    full_angles = _angles(cfg.hidden // cfg.heads, max_len, cfg.rope_theta,
                          tokens.device)
    lengths = lengths.long()
    angles = full_angles[lengths.clamp(0, max_len - 1)][:, None, :]
    page_idx = torch.clamp(lengths // ps, 0, p - 1)
    phys = torch.gather(page_tables.long(), 1, page_idx[:, None])[:, 0]
    off = lengths % ps
    mask = _causal(lengths, max_len)[:, None, None, :]
    h = params["tok_emb"][tokens.long()[:, None]]
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _layer_qkv(cfg, blk, h, angles)
        pages[li, 0, phys, off] = k[:, 0]
        pages[li, 1, phys, off] = v[:, 0]
        o = _paged_attention(cfg, pages, li, page_tables, q, mask)
        h = _layer_out(cfg, blk, h, o)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    return _logits(params, cfg, h)[:, 0, :], pages


@torch.no_grad()
def paged_prefill_chunk(params, cfg: QwenConfig, chunk_ids: torch.Tensor,
                        pages: torch.Tensor, page_table: torch.Tensor,
                        start: int, n_valid: int):
    """Prefill ONE chunk of one sequence's prompt into its pages.

    chunk_ids: (C,) tokens at positions start..start+C-1 (padded past
    n_valid; padded positions write to the null page); page_table: (P,).
    Returns ((V,) logits at the last valid position, pages), the chunk's K/V
    written into ``pages`` in place."""
    c = chunk_ids.shape[0]
    p = page_table.shape[0]
    ps = pages.shape[3]
    max_len = p * ps
    dev = chunk_ids.device
    full_angles = _angles(cfg.hidden // cfg.heads, max_len, cfg.rope_theta,
                          dev)
    idx = torch.arange(c, device=dev)
    pos = torch.clamp(int(start) + idx, 0, max_len - 1)
    valid = idx < int(n_valid)
    angles = full_angles[pos][None]  # (1, C, Dh/2)
    phys = torch.where(
        valid, page_table.long()[torch.clamp(pos // ps, 0, p - 1)], NULL_PAGE)
    off = pos % ps
    mask = _causal(pos, max_len)[None, None]
    h = params["tok_emb"][chunk_ids.long()][None]  # (1, C, hidden)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _layer_qkv(cfg, blk, h, angles)
        pages[li, 0, phys, off] = k[0]
        pages[li, 1, phys, off] = v[0]
        o = _paged_attention(cfg, pages, li, page_table[None], q, mask)
        h = _layer_out(cfg, blk, h, o)
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    logits = _logits(params, cfg, h)[0]  # (C, V)
    last = min(max(int(n_valid) - 1, 0), c - 1)
    return logits[last], pages


# -- ragged fused step --------------------------------------------------------
#
# ONE step per scheduler iteration serving mixed prefill + decode (the
# reference's module note explains the layout). Row-independent work runs on
# a FLAT (F, 1, hidden) token batch; attention runs on two small padded
# blocks: the decode block (Lmax, 1), single-token lanes scattered by
# lane_id, and the chunk block (1, Tq), the prefill chunk scattered by
# lane_pos. Lane roles are fixed by lane_id: < Lmax-2 decode lanes, Lmax-2
# THE chunk lane, Lmax-1 the dump lane for padding rows. Padding rows write
# their K/V to NULL_PAGE and mask every key slot.


def pack_ragged_meta(lmax: int, w: int, f: int):
    """Allocate the packed int32 metadata array for one fused step and
    return (meta, views): views are writable slices (tokens, lane_id,
    lane_pos, positions, logit_rows, lane_tables) of ``meta``."""
    meta = np.empty((4 * f + lmax + lmax * w,), np.int32)
    tokens = meta[:f]
    lane_id = meta[f:2 * f]
    lane_pos = meta[2 * f:3 * f]
    positions = meta[3 * f:4 * f]
    logit_rows = meta[4 * f:4 * f + lmax]
    lane_tables = meta[4 * f + lmax:].reshape(lmax, w)
    return meta, (tokens, lane_id, lane_pos, positions, logit_rows,
                  lane_tables)


ATTN_IMPLS = ("torch", "cuda")


@torch.no_grad()
def ragged_fused_step(params, cfg: QwenConfig, meta: torch.Tensor,
                      pages: torch.Tensor, *, lmax: int, w: int, tq: int,
                      attn_impl: str = "torch"):
    """One fused prefill+decode step over the paged pool.

    meta: the packed int32 array of :func:`pack_ragged_meta` as a tensor on
    the pool's device; ``tq`` is the query width of the chunk block
    (``tq == 1`` declares a decode-only step); ``attn_impl`` picks "torch"
    (the block-gather path, the reference's "xla") or "cuda" (the ragged
    paged attention kernel; on a CPU tensor its plain version).
    Returns ((Lmax,) greedy token ids, (Lmax, V) float32 logits for
    ``logit_rows``, pages); the step's K/V are written into ``pages`` in
    place.

    Differences from the reference's scatters, by design: JAX's
    ``mode="drop"`` scatter of the chunk rows becomes a scatter into a
    two-row block whose second row takes every non-chunk row and is thrown
    away (torch would raise or fault on an out-of-bounds row), and every
    index is clamped as the reference clamps it (torch would wrap a negative
    one). Duplicate scatter targets hit only the null page and the dump
    lane, whose content is never read unmasked.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    from nornicdb_tpu_torch.ops import kernels

    dev = pages.device
    f = (meta.shape[0] - lmax - lmax * w) // 4
    m = meta.long()
    tokens = m[:f]
    lane_id = m[f:2 * f]
    lane_pos = m[2 * f:3 * f]
    positions = meta[3 * f:4 * f]
    logit_rows = m[4 * f:4 * f + lmax]
    lane_tables = meta[4 * f + lmax:].reshape(lmax, w)
    tables_l = lane_tables.long()
    p = w
    ps = pages.shape[3]
    max_len = p * ps
    head_dim = cfg.hidden // cfg.heads
    full_angles = _angles(head_dim, max_len, cfg.rope_theta, dev)
    valid = positions >= 0
    pos_c = positions.long().clamp(0, max_len - 1)
    angles = full_angles[pos_c][:, None, :]          # (F, 1, Dh/2)
    lane_c = lane_id.clamp(0, lmax - 1)
    slot_c = lane_pos.clamp(0, tq - 1)
    is_chunk = lane_id == lmax - 2
    # non-decode rows scatter to the dump lane; chunk/pad collisions there
    # are harmless (masked, never gathered)
    dec_lane = torch.where(is_chunk, lmax - 1, lane_c)
    phys = torch.where(
        valid, tables_l[lane_c, torch.clamp(pos_c // ps, 0, p - 1)],
        NULL_PAGE)
    off = pos_c % ps
    pos_dec = torch.full((lmax, 1), -1, dtype=torch.int32, device=dev)
    pos_dec[dec_lane, 0] = torch.where(valid & ~is_chunk, positions, -1)
    if attn_impl == "torch":
        mask_dec = _causal(pos_dec, max_len)[:, None]
    if tq > 1:
        # chunk rows scatter into row 0 of a (2, Tq) block, every other row
        # into row 1, which is dropped (the reference's mode="drop")
        chunk_row = torch.where(is_chunk & valid, 0, 1)
        pos_chk = torch.full((2, tq), -1, dtype=torch.int32, device=dev)
        pos_chk[chunk_row, slot_c] = positions
        pos_chk = pos_chk[:1].contiguous()
        if attn_impl == "torch":
            mask_chk = _causal(pos_chk, max_len)[:, None]
        chunk_table = lane_tables[lmax - 2][None].contiguous()
    h = params["tok_emb"][tokens][:, None]           # (F, 1, hidden)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _layer_qkv(cfg, blk, h, angles)
        pages[li, 0, phys, off] = k[:, 0]
        pages[li, 1, phys, off] = v[:, 0]
        q_dec = torch.zeros((lmax, 1, cfg.heads, head_dim), dtype=q.dtype,
                            device=dev)
        q_dec[dec_lane, 0] = q[:, 0]
        if attn_impl == "torch":
            o_dec = _paged_attention(cfg, pages, li, lane_tables, q_dec,
                                     mask_dec)
        else:
            o_dec = kernels.ragged_paged_attention(
                q_dec, pages[li, 0], pages[li, 1], lane_tables, pos_dec)
        o = o_dec[dec_lane, 0]                       # (F, H, Dh)
        if tq > 1:
            q_chk = torch.zeros((2, tq, cfg.heads, head_dim), dtype=q.dtype,
                                device=dev)
            q_chk[chunk_row, slot_c] = q[:, 0]
            q_chk = q_chk[:1]
            if attn_impl == "torch":
                o_chk = _paged_attention(cfg, pages, li, chunk_table, q_chk,
                                         mask_chk)
            else:
                o_chk = kernels.ragged_paged_attention(
                    q_chk, pages[li, 0], pages[li, 1], chunk_table, pos_chk)
            o = torch.where(is_chunk[:, None, None], o_chk[0, slot_c], o)
        h = _layer_out(cfg, blk, h, o[:, None])
    h = rms_norm(params["final_norm"], h, cfg.rms_eps)
    h_sel = h[logit_rows.clamp(0, f - 1)]            # (Lmax, 1, hidden)
    logits = _logits(params, cfg, h_sel)[:, 0, :]
    return torch.argmax(logits, dim=-1), logits, pages
