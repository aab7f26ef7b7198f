"""bge-m3 embedding encoder (XLM-RoBERTa architecture) in PyTorch.

Counterpart of ``nornicdb_tpu/models/bge_m3.py``: post-LN transformer
encoder, CLS pooling, L2-normalized dense vector (bge-m3's dense retrieval
head). Parameters are the JAX package's pytree as a dict of tensors (dense
weights ``(in, out)``), so ``convert.bge_params_from_jax`` carries them over
leaf by leaf. Every product is a plain torch op: the JAX package runs this
model through XLA, with no Pallas kernel.

Config presets:
  BGE_M3      — the real shape (24L, 1024h, 16 heads, vocab 250002, 8192 ctx)
  BGE_DISTILL_6L, BGE_DISTILL_12L_512 — the distillation targets
  BGE_SMALL   — test-sized config, same code path

The tensor-parallel sharding plan of the JAX module (``shardings``) belongs
to the multi-device work and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.models.layers import attention, dense, layer_norm


@dataclass(frozen=True)
class BgeConfig:
    vocab_size: int = 250002
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate: int = 4096
    max_positions: int = 8194
    type_vocab: int = 1
    pad_token_id: int = 1
    # output embedding dims; when != hidden, a learned projection head maps
    # the CLS state to dims so width-shrunk students stay serving drop-ins
    dims: int = 1024
    dtype: str = "bfloat16"


BGE_M3 = BgeConfig()
# serving-scale distillation target: the teacher's hidden and output dims,
# a quarter of its layers
BGE_DISTILL_6L = BgeConfig(layers=6)
# deeper shrink: 12L at half width; the projection head (dims=1024 !=
# hidden=512) keeps the output space identical to the teacher
BGE_DISTILL_12L_512 = BgeConfig(layers=12, hidden=512, heads=8,
                                intermediate=2048)
BGE_SMALL = BgeConfig(
    vocab_size=1024, hidden=128, layers=2, heads=4, intermediate=256,
    max_positions=512, dims=128,
)

# additive attention mask value of the reference (float32): a fully masked
# query row softmaxes to a uniform row, never NaN
_NEG = -1e30


def torch_dtype(cfg: BgeConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: BgeConfig, seed: Union[int, torch.Generator] = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters with the reference's distributions: normal * 0.02
    embeddings, glorot-uniform dense weights with zero biases (all in
    ``cfg.dtype``), float32 layer norms (unit scale, zero bias), and a
    ``proj`` head when ``dims != hidden``. Drawn in float32 from a
    ``torch.Generator`` on the target device, then cast. The numbers differ
    from ``jax.random``'s: the tests carry JAX parameters over with
    ``convert.bge_params_from_jax`` instead."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    dtype = torch_dtype(cfg)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def glorot(d_in, d_out):
        lim = float(np.sqrt(6.0 / (d_in + d_out)))
        w = torch.rand((d_in, d_out), generator=gen, device=dev)
        return {"w": (w * (2 * lim) - lim).to(dtype),
                "b": torch.zeros((d_out,), dtype=dtype, device=dev)}

    def norm():
        return {"scale": torch.ones((cfg.hidden,), device=dev),
                "bias": torch.zeros((cfg.hidden,), device=dev)}

    params = {
        "tok_emb": normal((cfg.vocab_size, cfg.hidden)),
        "pos_emb": normal((cfg.max_positions, cfg.hidden)),
        "type_emb": normal((cfg.type_vocab, cfg.hidden)),
        "emb_ln": norm(),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "q": glorot(cfg.hidden, cfg.hidden),
            "k": glorot(cfg.hidden, cfg.hidden),
            "v": glorot(cfg.hidden, cfg.hidden),
            "o": glorot(cfg.hidden, cfg.hidden),
            "attn_ln": norm(),
            "up": glorot(cfg.hidden, cfg.intermediate),
            "down": glorot(cfg.intermediate, cfg.hidden),
            "mlp_ln": norm(),
        })
    if cfg.dims != cfg.hidden:
        params["proj"] = glorot(cfg.hidden, cfg.dims)
    return params


def _embed(params: dict, ids: torch.Tensor, positions: torch.Tensor
           ) -> torch.Tensor:
    """Token + position + type embeddings in the reference's order, each
    sum rounded to the parameter dtype, then the embedding layer norm."""
    h = params["tok_emb"][ids] + params["pos_emb"][positions]
    h = h + params["type_emb"][torch.zeros_like(ids)]
    return layer_norm(params["emb_ln"], h)


def _encode(params: dict, cfg: BgeConfig, h: torch.Tensor,
            amask: torch.Tensor) -> torch.Tensor:
    """The post-LN blocks over (B, T, hidden) with an additive float32
    mask broadcastable to (B, H, T, T). GELU is the tanh form:
    ``jax.nn.gelu``'s default."""
    b, t, _ = h.shape
    head_dim = cfg.hidden // cfg.heads
    for blk in params["blocks"]:
        q = dense(blk["q"], h).reshape(b, t, cfg.heads, head_dim)
        k = dense(blk["k"], h).reshape(b, t, cfg.heads, head_dim)
        v = dense(blk["v"], h).reshape(b, t, cfg.heads, head_dim)
        o = attention(q, k, v, amask).reshape(b, t, cfg.hidden)
        h = layer_norm(blk["attn_ln"], h + dense(blk["o"], o))  # post-LN
        m = dense(blk["down"], F.gelu(dense(blk["up"], h), approximate="tanh"))
        h = layer_norm(blk["mlp_ln"], h + m)
    return h


def _pool(params: dict, cfg: BgeConfig, cls: torch.Tensor) -> torch.Tensor:
    """CLS states -> float32 L2-normalized embeddings (through ``proj``
    when ``dims != hidden``), the norm floored at 1e-12."""
    if cfg.dims != cfg.hidden:
        cls = dense(params["proj"], cls)  # width-shrunk student -> dims
    cls = cls.float()
    norm = torch.linalg.vector_norm(cls, dim=-1, keepdim=True)
    return cls / torch.clamp(norm, min=1e-12)


def forward(params: dict, cfg: BgeConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) ids + (B, T) mask -> (B, dims) L2-normalized embeddings."""
    # XLM-R position ids start at pad_token_id+1 and skip pads
    positions = (torch.cumsum(attention_mask, dim=1) * attention_mask
                 + cfg.pad_token_id)
    h = _embed(params, input_ids, positions)
    amask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, _NEG)
    h = _encode(params, cfg, h, amask)
    return _pool(params, cfg, h[:, 0, :])  # CLS pooling (bge dense head)


def forward_packed(params: dict, cfg: BgeConfig, input_ids: torch.Tensor,
                   seg_ids: torch.Tensor, positions: torch.Tensor,
                   cls_rows: torch.Tensor, cls_cols: torch.Tensor
                   ) -> torch.Tensor:
    """Ragged token-packed forward: several texts share each row of an
    (R, C) grid, delimited by segment ids (0 = padding, 1..S = texts).

    Equivalent to :func:`forward` per text: attention is block-diagonal
    over segments (a token attends only within its own segment), positions
    restart per segment with the same XLM-R formula (the packer writes
    them), and pooling gathers each segment's first (CLS) token at
    ``cls_rows``/``cls_cols`` (padded slots gather rows the caller drops).
    Returns (S_cap, dims) float32 L2-normalized embeddings."""
    h = _embed(params, input_ids, positions)
    # block-diagonal additive mask (R, 1, C, C): key visible to query iff
    # same nonzero segment. Fully-masked pad queries softmax to a uniform
    # row that nothing gathers (no NaN: the softmax is max-subtracted)
    valid = seg_ids > 0
    allowed = ((seg_ids[:, :, None] == seg_ids[:, None, :])
               & valid[:, :, None] & valid[:, None, :])
    amask = torch.where(allowed[:, None, :, :], 0.0, _NEG)
    h = _encode(params, cfg, h, amask)
    return _pool(params, cfg, h[cls_rows, cls_cols, :])
