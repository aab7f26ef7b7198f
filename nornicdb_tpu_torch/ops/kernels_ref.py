"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in ``ops/csrc`` computes, with
ordinary tensor ops. The wrappers in ``ops/kernels.py`` run these for tensors
on the CPU (the tests), and ``chip_smoke.py`` holds each kernel against its
plain version on the card. Nothing on the serving path calls them for a CUDA
tensor.

Packed-bin scheme of the search kernels (``streaming_topk.cu``): corpus
tile t, column j folds into bin (t % rows, q, j); a score is biased by +3 (valid row) or -3
(masked row), bitcast to int32, its low ``tile_bits`` bits replaced by t,
and merged with an integer max.
"""

from __future__ import annotations

from typing import Callable

import torch

from nornicdb_tpu_torch.models.layers import attention, repeat_kv

INT32_MIN = -(2**31)
# |s8 x s8 dot| <= 127 * 127 * D: below 2**24 every partial sum of the f32
# product is an exact integer, so an f32 matmul gives the exact s32 result
_F32_EXACT_INT = 2**24


def _fold_bins(
    biased_cols: Callable[[int, int], torch.Tensor],
    q: int, n_tiles: int, tile_n: int, rows: int, tile_bits: int,
    device: torch.device,
) -> torch.Tensor:
    """(rows, Q, tile_n) int32 bins from ``biased_cols(a, b)``, the (Q, b-a)
    biased f32 scores of corpus rows a..b. Walks ``rows`` tiles at a time,
    so tile t0 + i of a step lands in bin row i."""
    keep = -(1 << tile_bits)
    bins = torch.full((rows, q, tile_n), INT32_MIN, dtype=torch.int32,
                      device=device)
    for t0 in range(0, n_tiles, rows):
        t1 = min(t0 + rows, n_tiles)
        biased = biased_cols(t0 * tile_n, t1 * tile_n)
        tiles = torch.arange(t0, t1, dtype=torch.int32, device=device)
        packed = (
            biased.reshape(q, t1 - t0, tile_n).view(torch.int32) & keep
        ) | tiles.view(1, -1, 1)
        torch.maximum(bins[: t1 - t0], packed.permute(1, 0, 2),
                      out=bins[: t1 - t0])
    return bins


def fused_cosine_scores(queries: torch.Tensor, corpus: torch.Tensor
                        ) -> torch.Tensor:
    """``fused_cosine_kernel``, step by step as the TPU kernel: the corpus in
    float32, each row scaled by rsqrt(max(sum of squares, 1e-24)), then one
    float32 product with the (pre-normalized) queries."""
    c = corpus.float()
    inv = torch.rsqrt(torch.clamp((c * c).sum(dim=1, keepdim=True), min=1e-24))
    return queries.float() @ (c * inv).T


def streaming_bins_bf16(
    queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
    tile_n: int, rows: int, tile_bits: int,
) -> torch.Tensor:
    """Bins of ``streaming_topk_bf16_kernel``: bf16-rounded operands, f32
    products and sums (an f32 matmul of bf16-rounded values: each product is
    exact in f32), bias added as one f32 add."""
    n = corpus.shape[0]
    qb = queries.to(torch.bfloat16).to(torch.float32)
    bias = torch.where(valid, 3.0, -3.0).to(torch.float32)

    def biased_cols(a: int, b: int) -> torch.Tensor:
        cb = corpus[a:b].to(torch.bfloat16).to(torch.float32)
        return qb @ cb.T + bias[a:b]

    return _fold_bins(biased_cols, queries.shape[0], n // tile_n, tile_n,
                      rows, tile_bits, queries.device)


def streaming_bins_int8(
    q_i8: torch.Tensor, c_i8: torch.Tensor, c_scale: torch.Tensor,
    valid: torch.Tensor, tile_n: int, rows: int, tile_bits: int,
) -> torch.Tensor:
    """Bins of ``streaming_topk_i8_kernel``: exact s32 dot products, then
    ``acc * (1 / c_scale or 0)`` and ``+ bias`` as two separately rounded f32
    operations (bit-identical to the kernel's __fmul_rn / __fadd_rn)."""
    n, d = c_i8.shape
    wide = torch.float32 if 127 * 127 * d < _F32_EXACT_INT else torch.float64
    qf = q_i8.to(wide)
    # true division, as the kernel's __fdiv_rn (``1.0 / t`` would run as a
    # reciprocal)
    scale = torch.where(valid, torch.ones_like(c_scale) / c_scale, 0.0)
    bias = torch.where(valid, 3.0, -3.0).to(torch.float32)

    def biased_cols(a: int, b: int) -> torch.Tensor:
        acc = (qf @ c_i8[a:b].to(wide).T).to(torch.float32)
        return acc * scale[a:b] + bias[a:b]

    return _fold_bins(biased_cols, q_i8.shape[0], n // tile_n, tile_n,
                      rows, tile_bits, q_i8.device)


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """``ragged_attn_kernel``: for each lane, gather its P pages of one
    layer's pool and run ``layers.attention`` over the S = P * ps slots, key
    slot s visible to a query row iff s <= that row's position (what the
    reference's ``_paged_attention`` and its kernel test do). Padding rows
    (position -1) come out as zeros, as the kernel writes them; the
    reference leaves a finite average over masked slots there, which no
    caller reads.

    q (L, Tq, H, Dh); k_pages, v_pages (num_pages, ps, Hkv, Dh); tables
    (L, P) int32; positions (L, Tq) int32. Returns (L, Tq, H, Dh) in
    q.dtype."""
    l, tq, h, dh = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    s_len = tables.shape[1] * ps
    idx = tables.long()
    k = k_pages[idx].reshape(l, s_len, hkv, dh)
    v = v_pages[idx].reshape(l, s_len, hkv, dh)
    slot = torch.arange(s_len, device=q.device)
    mask = torch.where(slot <= positions[..., None], 0.0, -1e30)  # (L, Tq, S)
    out = attention(q, repeat_kv(k, h // hkv), repeat_kv(v, h // hkv),
                    mask[:, None])
    return torch.where((positions >= 0)[..., None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def extract_topk(flat: torch.Tensor, k: int, kpad: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``extract_topk_kernel``: k rounds of argmax over each row of the
    (Q, B) int32 bins, ties to the lowest bin index, masking the chosen bin
    with INT32_MIN. Returns (Q, kpad) values and bin ids; columns k.. hold
    INT32_MIN / 0."""
    q, b = flat.shape
    scores = flat.clone()
    out_v = torch.full((q, kpad), INT32_MIN, dtype=torch.int32,
                       device=flat.device)
    out_i = torch.zeros((q, kpad), dtype=torch.int32, device=flat.device)
    iota = torch.arange(b, dtype=torch.int64, device=flat.device)
    beyond = torch.full_like(scores, b, dtype=torch.int64)
    for j in range(k):
        m = scores.max(dim=1).values
        first = torch.where(scores == m[:, None], iota, beyond).min(dim=1).values
        out_v[:, j] = m
        out_i[:, j] = first.to(torch.int32)
        scores.scatter_(1, first[:, None], INT32_MIN)
    return out_v, out_i
