"""Hand-written Hopper kernels of the search and generation paths, and their
wrappers.

Counterpart of ``nornicdb_tpu/ops/pallas_kernels.py``, one CUDA kernel for
each of its five TPU kernels:

============================  ==============================  =======================
TPU kernel (pallas_kernels)   CUDA kernel (ops/csrc)          wrapper here
============================  ==============================  =======================
_cosine_tile_kernel           fused_cosine_kernel             fused_cosine_scores
_streaming_topk_kernel        streaming_topk_bf16_kernel      streaming_cosine_topk
_streaming_topk_int8_kernel   streaming_topk_i8_kernel        streaming_cosine_topk_int8
_extract_topk_kernel          extract_topk_kernel             _topk_bins("pallas")
_ragged_attn_kernel           ragged_attn_kernel              ragged_paged_attention
============================  ==============================  =======================

Each wrapper checks device, dtype, shape and contiguity. For a CUDA tensor
it launches its kernel (built from ``ops/csrc`` on first use) or raises; for
a CPU tensor it runs the kernel's plain version (``ops/kernels_ref.py``).
Every launch adds one to the kernel's count in ``launch_counts()``.

The bin geometry ``(rows, tile_n, tile_bits)`` is part of the result (it sets
recall and decode) and stays exactly the TPU kernels'; only the CUDA tiling
differs. The epilogues (``_topk_bins`` "sort", ``_decode_packed``) are plain
torch ops, as they were XLA ops in the JAX package. ``epilogue="approx"``
runs the exact sort: there is no approximate top-k in PyTorch, and exact
keeps at least the recall the approximate one promised.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from nornicdb_tpu_torch.ops import _build, kernels_ref

LANE = 128
INT32_MIN = kernels_ref.INT32_MIN
# corpus rows a CTA of the streaming kernels (BM of streaming_topk.cu and
# streaming_topk_bf16.cu): tile_n must be a multiple of it on the card
# (pick_tile_n always gives one)
CUDA_TILE_COLS = 128
# corpus types of the bf16 streaming kernel -> its c_dtype code, and the
# bytes of one value
_CORPUS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_CORPUS_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
# the query block widths (wgmma N) both streaming kernels have instances of
_STREAMING_NQ = (8, 16, 32, 64, 128)
# streaming_topk_bf16.cu: the K chunk, the ring's stages at most, the
# barriers after it and the slack that aligns it to 1,024 bytes (its TMA
# boxes are swizzled)
_BF16_BK = 64
_BF16_MAX_STAGES = 8
_BF16_BARRIER_BYTES = 2 * _BF16_MAX_STAGES * 8
_BF16_ALIGN = 1024
# streaming_topk.cu: the K chunk (bytes, one 128-byte swizzled box row), a
# corpus chunk in the ring, the ring's stages at most and at least beside a
# kept query block, the barriers (full, empty and the queries') and the
# 1,024-byte alignment slack
_I8_BK = 128
_I8_CCHUNK = CUDA_TILE_COLS * _I8_BK
_I8_MAX_STAGES = 8
_I8_MIN_KEPT_STAGES = 3
_I8_BARRIER_BYTES = (2 * _I8_MAX_STAGES + 1) * 8
_I8_ALIGN = 1024
EPILOGUES = ("sort", "approx", "pallas")
# shared memory one CTA may take (H100: 227 KB of the SM's 256 KB)
_SMEM_LIMIT = 232_448
# extract_topk.cu's shared memory: HEAD words (histogram, scan scratch,
# control), then the row's B keys, then, where they fit, the k picks' keys
# and bin ids
_EXTRACT_HEAD_WORDS = 320
_EXTRACT_MAX_BINS = _SMEM_LIMIT // 4 - _EXTRACT_HEAD_WORDS
# fused_cosine.cu copies rows in 16-byte pieces: the width of a row, in
# values, must be a multiple of this for each corpus type (float32 queries
# need 4)
_COSINE_WIDTH_STEP = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}

_count_lock = threading.Lock()
_LAUNCHES = {
    "fused_cosine_scores": 0,
    "streaming_topk_bf16": 0,
    "streaming_topk_int8": 0,
    "extract_topk": 0,
    "ragged_paged_attention": 0,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset (CUDA launches only)."""
    with _count_lock:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        _LAUNCHES[name] += 1


def _check(t: torch.Tensor, name: str, dtype, ndim: int,
           device: torch.device) -> None:
    """``dtype``: one torch dtype, or a collection of the accepted ones."""
    ok = t.dtype in dtype if isinstance(dtype, (tuple, dict)) else t.dtype == dtype
    if not ok:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of ``device``.

    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    first, several microseconds of host time that a kernel of a few
    microseconds waits for (``chip_smoke.py`` phase 1 prints both costs).
    ``torch._C._cuda_getCurrentRawStream`` is private, checked against
    PyTorch 2.11.0; a release without it takes the public call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(device.index)


def _launch(name: str, fn, *args, device: torch.device) -> None:
    """Call a C entry point on the current stream of ``device``; raise on a
    refused launch (a refused launch never runs, and a later synchronize
    would not report it). The device is switched only when it is not the
    current one: a switch costs as much host time as the stream object."""
    stream = _current_stream(device)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        torch.cuda.check_error(err)
    _count(name)


# --------------------------------------------------------- host helpers
def pick_tile_n(n: int, preferred: int = 1024) -> int:
    """Largest power-of-two tile (>=128) that divides n, capped at
    `preferred`. Corpus capacities are LANE (128) multiples, so 128 always
    divides; bigger tiles amortize per-tile overhead."""
    t = preferred
    while t > LANE and n % t != 0:
        t //= 2
    return t


def streaming_rows_for(k: int, tile_n: int, target_bins_per_k: int = 20) -> int:
    """Bin rows so B = rows*tile_n >= target_bins_per_k * k (recall knob)."""
    need = max(2 * tile_n, target_bins_per_k * k)
    return -(-need // tile_n)  # ceil div


def streaming_geometry(n: int, tile_n: int, rows: int) -> tuple[int, int, int]:
    """(n_tiles, rows, tile_bits) of the packed bins, as the TPU kernels
    derive them."""
    if n % tile_n != 0:
        raise ValueError(f"N ({n}) must be a multiple of tile_n ({tile_n})")
    n_tiles = n // tile_n
    rows = min(rows, n_tiles)
    tile_bits = max(1, (n_tiles - 1).bit_length())
    return n_tiles, rows, tile_bits


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: returns (int8 rows, scales) with
    x ~= int8 / scale. Same codes as quantize_rows_np (round half to even)."""
    xf = x.to(torch.float32)
    m = torch.clamp(xf.abs().amax(dim=1), min=1e-9)
    # a true division (``127.0 / m`` would run as reciprocal-then-multiply)
    s = torch.full_like(m, 127.0) / m
    return torch.round(xf * s[:, None]).to(torch.int8), s


# ----------------------------------------------------------- fused cosine
def fused_cosine_scores(queries: torch.Tensor, corpus: torch.Tensor,
                        tile_n: int = 512) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) float32 cosine scores, each corpus row
    L2-normalized inside the kernel (``fused_cosine.cu``; the TPU kernel's
    signature without ``interpret``). queries: L2-normalized float32;
    corpus: float32, bfloat16 or float16 rows, any norm. ``tile_n`` is the
    TPU kernel's divisibility rule only (``min(tile_n, N)`` must divide N);
    the CUDA tile is its own and any Q and D work. Full float32, no TF32."""
    dev = queries.device
    _check(queries, "queries", torch.float32, 2, dev)
    _check(corpus, "corpus", _CORPUS_DTYPES, 2, dev)
    (q, d), n = queries.shape, corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"fused_cosine_scores: queries have D={d}, corpus "
                         f"rows {corpus.shape[1]}")
    tile_n = min(tile_n, n)
    if n % tile_n != 0:
        raise ValueError(
            f"corpus rows ({n}) must be a multiple of tile_n ({tile_n}); "
            "pad with ops.similarity.pad_to_multiple and mask upstream")
    if dev.type != "cuda":
        return kernels_ref.fused_cosine_scores(queries, corpus)
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q == 0:
        return out
    tm, width, copy_q, copy_c = _cosine_plan(
        q, d, corpus.dtype, queries.data_ptr(), corpus.data_ptr())
    if copy_q:
        queries = _zero_padded(queries, width)
    if copy_c:
        corpus = _zero_padded(corpus, width)
    lib = _build.library("fused_cosine")
    _launch("fused_cosine_scores", lib.nornic_fused_cosine_scores,
            queries.data_ptr(), corpus.data_ptr(), out.data_ptr(), q, n, width,
            _CORPUS_DTYPES[corpus.dtype], tm, device=dev)
    return out


def _cosine_plan(q: int, d: int, c_dtype: torch.dtype, q_ptr: int,
                 c_ptr: int) -> tuple[int, int, bool, bool]:
    """How ``fused_cosine.cu`` takes (Q, D) queries and a corpus of
    ``c_dtype`` at these addresses: (tm, the width it reads, whether the
    queries and whether the corpus go through a zero-padded copy first).
    The kernel copies rows in 16-byte pieces, so a width that is no
    multiple of ``_COSINE_WIDTH_STEP`` or a base off a 16-byte boundary (a
    contiguous view such as ``c[1:]``) is copied, padded with zero columns
    (which change no dot product and no norm). ``16 * tm`` query rows a
    CTA: a small batch computes no padding rows."""
    tm = next(t for t in (1, 2, 4, 8) if 16 * t >= min(q, 128))
    step = _COSINE_WIDTH_STEP[c_dtype]
    width = -(-d // step) * step
    return (tm, width, width != d or q_ptr % 16 != 0,
            width != d or c_ptr % 16 != 0)


def _zero_padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """A fresh (aligned) copy of the rows of ``x``, zero columns to
    ``width``."""
    out = x.new_zeros((x.shape[0], width))
    out[:, :x.shape[1]] = x
    return out


def fused_cosine_topk(queries: torch.Tensor, corpus: torch.Tensor,
                      valid: torch.Tensor, k: int, tile_n: int = 512
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-scored cosine top-k: ``fused_cosine_scores``, rows with
    ``valid`` False masked to -inf, then the top k with lax.top_k's
    lowest-index ties. Returns (values (Q, k), indices (Q, k) int64)."""
    scores = fused_cosine_scores(queries, corpus, tile_n=tile_n)
    scores = torch.where(valid[None, :], scores, float("-inf"))
    return topk_lowest_index(scores, k)


# ------------------------------------------------------- streaming bins
def streaming_bins(
    queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
    tile_n: int, rows: int,
) -> torch.Tensor:
    """(rows', Q, tile_n) int32 packed bins of the bf16 streaming top-k
    (rows' = min(rows, n_tiles)). queries (Q, D) and corpus (N, D) are
    L2-normalized float32, bfloat16 or float16 rows (both are rounded to
    bf16 for the product, as the TPU kernel casts them); valid (N,) bool."""
    dev = queries.device
    _check(queries, "queries", _CORPUS_DTYPES, 2, dev)
    _check(corpus, "corpus", _CORPUS_DTYPES, 2, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    (q, d), n = queries.shape, corpus.shape[0]
    if corpus.shape[1] != d or valid.shape[0] != n:
        raise ValueError("queries/corpus/valid shapes disagree")
    n_tiles, rows, tile_bits = streaming_geometry(n, tile_n, rows)
    if dev.type != "cuda":
        return kernels_ref.streaming_bins_bf16(
            queries, corpus, valid, tile_n, rows, tile_bits)
    if tile_n % CUDA_TILE_COLS != 0:
        raise ValueError(f"streaming_bins: the CUDA kernel needs tile_n % "
                         f"{CUDA_TILE_COLS} == 0 (got {tile_n})")
    bins = torch.full((rows, q, tile_n), INT32_MIN, dtype=torch.int32,
                      device=dev)
    if q == 0:
        return bins
    plan = _streaming_plan(
        q, d, corpus.dtype, corpus.data_ptr(), n_tiles, rows, tile_n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.copy_c:
        corpus = _zero_padded(corpus, plan.width)
    # the kernel's rounding pass reads float32 queries (a copy of others)
    qf = queries.float()
    qbuf = torch.empty(plan.qbuf_values, dtype=torch.bfloat16, device=dev)
    _launch("streaming_topk_bf16",
            _build.library("streaming_topk_bf16").nornic_streaming_topk_bf16,
            qf.data_ptr(), corpus.data_ptr(), valid.data_ptr(),
            qbuf.data_ptr(), bins.data_ptr(), q, d, plan.width, tile_n,
            n_tiles, rows, tile_bits, plan.splits, plan.nq, plan.stages,
            plan.cluster, _CORPUS_DTYPES[corpus.dtype], device=dev)
    return bins


@dataclasses.dataclass(frozen=True)
class _StreamingPlan:
    """How ``streaming_topk_bf16.cu`` takes a call: query blocks of ``nq``
    (the wgmma's N) and their count, the split of each bin row's tile loop,
    the query blocks a cluster, the ring's stages and the CTA's shared
    memory, the corpus width it
    reads and whether the corpus goes through a zero-padded copy first, the
    bf16 values of the rounded-query buffer."""
    nq: int
    qblocks: int
    splits: int
    cluster: int
    stages: int
    smem: int
    width: int
    copy_c: bool
    qbuf_values: int


def _query_blocks(q: int, n_tiles: int, rows: int, tile_n: int, sms: int
                  ) -> tuple[int, int, int, int]:
    """The query side of a streaming kernel's grid: (block width, blocks,
    blocks a cluster, split of each bin row's tile loop). The block is the
    smallest of the kernels' widths that holds min(Q, 128) queries, so a
    small batch multiplies only its own rows. The CTAs of one tile's query
    blocks sit side by side in the grid, so the corpus is read from device
    memory once, and pairs of them share each corpus chunk (a cluster of 2,
    TMA multicast) where their number is even. Each bin row's tile loop is
    split over as many CTAs as fill the SMs once (one CTA an SM: the ring
    takes most of its shared memory)."""
    nq = next(w for w in _STREAMING_NQ if w >= min(q, _STREAMING_NQ[-1]))
    qblocks = -(-q // nq)
    cluster = 2 if qblocks % 2 == 0 else 1
    ctas = qblocks * rows * (tile_n // CUDA_TILE_COLS)
    splits = max(1, min(-(-n_tiles // rows), sms // ctas))
    return nq, qblocks, cluster, splits


def _streaming_plan(q: int, d: int, c_dtype: torch.dtype, c_ptr: int,
                    n_tiles: int, rows: int, tile_n: int, sms: int
                    ) -> _StreamingPlan:
    """The launch plan of the bf16 streaming kernel (a pure function of its
    arguments): the grid of ``_query_blocks``, and as many ring stages as
    fit. The corpus's TMA tensor map needs rows on 16-byte boundaries: a
    width that is no multiple of 16 bytes or an unaligned base goes through
    a zero-padded copy, as for ``fused_cosine.cu``."""
    nq, qblocks, cluster, splits = _query_blocks(q, n_tiles, rows, tile_n, sms)
    esize = _CORPUS_ESIZE[c_dtype]
    step = 16 // esize
    width = -(-d // step) * step
    stage = CUDA_TILE_COLS * _BF16_BK * esize + nq * _BF16_BK * 2
    fixed = _BF16_ALIGN + _BF16_BARRIER_BYTES
    stages = min(_BF16_MAX_STAGES, (_SMEM_LIMIT - fixed) // stage)
    kchunks = -(-width // _BF16_BK)
    return _StreamingPlan(
        nq=nq, qblocks=qblocks, splits=splits, cluster=cluster, stages=stages,
        smem=fixed + stages * stage, width=width,
        copy_c=width != d or c_ptr % 16 != 0,
        qbuf_values=qblocks * kchunks * nq * _BF16_BK)


def streaming_bins_int8(
    q_i8: torch.Tensor, c_i8: torch.Tensor, c_scale: torch.Tensor,
    valid: torch.Tensor, tile_n: int, rows: int,
) -> torch.Tensor:
    """Packed bins of the int8 streaming top-k (quantize_rows codes of
    normalized queries / corpus; c_scale (N,) float32)."""
    dev = q_i8.device
    _check(q_i8, "q_i8", torch.int8, 2, dev)
    _check(c_i8, "c_i8", torch.int8, 2, dev)
    _check(c_scale, "c_scale", torch.float32, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    (q, d), n = q_i8.shape, c_i8.shape[0]
    if c_i8.shape[1] != d or valid.shape[0] != n or c_scale.shape[0] != n:
        raise ValueError("q_i8/c_i8/c_scale/valid shapes disagree")
    n_tiles, rows, tile_bits = streaming_geometry(n, tile_n, rows)
    if dev.type != "cuda":
        return kernels_ref.streaming_bins_int8(
            q_i8, c_i8, c_scale, valid, tile_n, rows, tile_bits)
    if tile_n % CUDA_TILE_COLS != 0:
        raise ValueError(f"streaming_bins_int8: the CUDA kernel needs tile_n "
                         f"% {CUDA_TILE_COLS} == 0 (got {tile_n})")
    bins = torch.full((rows, q, tile_n), INT32_MIN, dtype=torch.int32,
                      device=dev)
    if q == 0:
        return bins
    plan = _int8_plan(
        q, d, q_i8.data_ptr(), c_i8.data_ptr(), n_tiles, rows, tile_n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.copy_q:
        q_i8 = _zero_padded(q_i8, plan.width)
    if plan.copy_c:
        c_i8 = _zero_padded(c_i8, plan.width)
    _launch("streaming_topk_int8",
            _build.library("streaming_topk").nornic_streaming_topk_i8,
            q_i8.data_ptr(), c_i8.data_ptr(), c_scale.data_ptr(),
            valid.data_ptr(), bins.data_ptr(), q, plan.width, tile_n, n_tiles,
            rows, tile_bits, plan.splits, plan.nq, plan.stages, plan.cluster,
            int(plan.q_kept), device=dev)
    return bins


@dataclasses.dataclass(frozen=True)
class _Int8Plan:
    """How ``streaming_topk.cu`` takes a call: query blocks of ``nq`` (the
    wgmma's N) and their count, the split of each bin row's tile loop, the
    query blocks a cluster, the ring's stages and the CTA's shared memory,
    whether the query block is kept in shared memory for the whole tile
    loop (else each stage carries its chunk), the padded width the kernel
    reads and whether the queries and whether the corpus go through a
    zero-padded copy first."""
    nq: int
    qblocks: int
    splits: int
    cluster: int
    stages: int
    smem: int
    q_kept: bool
    width: int
    copy_q: bool
    copy_c: bool


def _int8_plan(q: int, d: int, q_ptr: int, c_ptr: int, n_tiles: int,
               rows: int, tile_n: int, sms: int) -> _Int8Plan:
    """The launch plan of the int8 streaming kernel (a pure function of its
    arguments): the grid of ``_query_blocks``. Both operands reach the
    kernel through TMA tensor maps, which need rows on 16-byte boundaries:
    a width that is no multiple of 16 or a base off a 16-byte boundary
    goes through a zero-padded copy (zero codes add nothing to an s32 sum,
    so the bins do not change). The query block (nq x the width rounded up
    to 128-byte chunks) stays in shared memory where it fits beside a ring
    of ``_I8_MIN_KEPT_STAGES`` stages; otherwise each stage carries its
    chunk. The ring takes as many stages as fit, up to ``_I8_MAX_STAGES``."""
    nq, qblocks, cluster, splits = _query_blocks(q, n_tiles, rows, tile_n, sms)
    width = -(-d // 16) * 16
    qchunk = nq * _I8_BK
    kept_bytes = -(-width // _I8_BK) * qchunk
    fixed = _I8_ALIGN + _I8_BARRIER_BYTES
    kept_stages = (_SMEM_LIMIT - fixed - kept_bytes) // _I8_CCHUNK
    q_kept = kept_stages >= _I8_MIN_KEPT_STAGES
    if q_kept:
        stages = min(_I8_MAX_STAGES, kept_stages)
        smem = fixed + kept_bytes + stages * _I8_CCHUNK
    else:
        stage = _I8_CCHUNK + qchunk
        stages = min(_I8_MAX_STAGES, (_SMEM_LIMIT - fixed) // stage)
        smem = fixed + stages * stage
    return _Int8Plan(
        nq=nq, qblocks=qblocks, splits=splits, cluster=cluster, stages=stages,
        smem=smem, q_kept=q_kept, width=width,
        copy_q=width != d or q_ptr % 16 != 0,
        copy_c=width != d or c_ptr % 16 != 0)


# -------------------------------------------------------------- epilogue
def topk_lowest_index(x: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of a float32 or int32 (Q, N) tensor, ties
    broken by the lowest index (lax.top_k's rule; torch.topk promises no
    tie order). Ranks the unique int64 keys (order-preserving int32 view
    << 32) | (2**32 - 1 - index)."""
    if x.dtype == torch.float32:
        bits = x.view(torch.int32)
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # monotone int view
    elif x.dtype == torch.int32:
        ordered = x
    else:
        raise TypeError(f"topk_lowest_index: unsupported dtype {x.dtype}")
    n = x.shape[-1]
    rev = (2**32 - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    key = ordered.to(torch.int64) * (2**32) + rev
    pos = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, pos), pos


def _extract_topk(flat: torch.Tensor, k: int, kpad: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over (Q, B) packed bins (extract_topk.cu, a radix
    select), identical to the TPU kernel's k rounds of argmax."""
    dev = flat.device
    _check(flat, "bins", torch.int32, 2, dev)
    q, b = flat.shape
    if not 1 <= k <= min(b, kpad):
        raise ValueError(f"extract_topk: need 1 <= k <= min(B, kpad), k={k}")
    if dev.type != "cuda":
        return kernels_ref.extract_topk(flat, k, kpad)
    smem, with_picks = _extract_plan(b, k)
    out_v, out_i = flat.new_empty((2, q, kpad)).unbind(0)
    lib = _build.library("extract_topk")
    _launch("extract_topk", lib.nornic_extract_topk,
            flat.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), q, b, k,
            kpad, int(with_picks), smem, device=dev)
    return out_v, out_i


def _extract_plan(b: int, k: int) -> tuple[int, bool]:
    """(shared memory bytes, whether the k picks are ranked among
    themselves) of ``extract_topk.cu`` for a row of ``b`` bins: the row's
    keys always; the picks' keys and bin ids where they fit beside it,
    else each pick is ranked against the whole row (slower, same result)."""
    if b > _EXTRACT_MAX_BINS:
        raise ValueError(
            f"extract_topk: B={b} bins exceed one CTA's shared memory "
            f"(at most {_EXTRACT_MAX_BINS})")
    row = 4 * (_EXTRACT_HEAD_WORDS + b)
    with_picks = row + 8 * k <= _SMEM_LIMIT
    return row + 8 * k * with_picks, with_picks


def _topk_bins(flat: torch.Tensor, k: int, *, epilogue: str
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the (Q, B) packed-bin matrix: "sort" (and "approx", which
    runs the same exact sort here) ranks with lowest-index ties; "pallas"
    runs the extract kernel. Both give identical values and bin ids."""
    b = flat.shape[1]
    k = min(k, b)
    if epilogue in ("sort", "approx"):
        return topk_lowest_index(flat, k)
    if epilogue == "pallas":
        kpad = -(-k // LANE) * LANE  # padded as the TPU kernel pads lanes
        out_v, out_i = _extract_topk(flat, k, kpad)
        return out_v[:, :k], out_i[:, :k].to(torch.int64)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def _decode_packed(bins: torch.Tensor, *, k: int, n: int, rows: int,
                   tile_n: int, tile_bits: int, epilogue: str = "sort"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over packed bins + decode (score, global row)."""
    q = bins.shape[1]
    flat = bins.permute(1, 0, 2).reshape(q, rows * tile_n)
    top_packed, top_bin = _topk_bins(flat, k, epilogue=epilogue)
    low_mask = (1 << tile_bits) - 1
    tile_idx = (top_packed & low_mask).to(torch.int64)
    idx = tile_idx * tile_n + top_bin % tile_n
    # midpoint-reconstruct the truncated mantissa bits, then un-bias
    score_bits = (top_packed & ~low_mask) | (1 << (tile_bits - 1))
    vals = score_bits.view(torch.float32) - 3.0
    vals = torch.where(top_packed > 0, vals, float("-inf"))
    return vals, idx.clamp(0, n - 1)


# ----------------------------------------------------------- entry points
def streaming_cosine_topk(
    queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
    k: int, tile_n: int = 512, rows: int = 4, epilogue: str = "sort",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-pass cosine top-k that never materializes (Q, N).

    queries: (Q, D) L2-normalized float32; corpus: (N, D) L2-normalized
    float32 rows (rows masked by `valid` may hold anything); valid: (N,)
    bool. N must be a multiple of tile_n. Returns (values (Q, k) float32,
    indices (Q, k) int64); values carry bf16-GEMM accuracy truncated to the
    packed bins' resolution; masked rows never appear."""
    n = corpus.shape[0]
    bins = streaming_bins(queries, corpus, valid, tile_n, rows)
    _, rows, tile_bits = streaming_geometry(n, tile_n, rows)
    return _decode_packed(bins, k=k, n=n, rows=rows, tile_n=tile_n,
                          tile_bits=tile_bits, epilogue=epilogue)


def streaming_cosine_topk_int8(
    q_i8: torch.Tensor, q_scale: torch.Tensor, c_i8: torch.Tensor,
    c_scale: torch.Tensor, valid: torch.Tensor, k: int, tile_n: int = 512,
    rows: int = 4, epilogue: str = "sort",
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 single-pass cosine top-k. Inputs are quantize_rows() outputs of
    L2-normalized queries/corpus; valid: (N,) bool. Returns (values (Q, k)
    ~cosine scores, indices (Q, k))."""
    n = c_i8.shape[0]
    bins = streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile_n, rows)
    _, rows, tile_bits = streaming_geometry(n, tile_n, rows)
    vals, idx = _decode_packed(bins, k=k, n=n, rows=rows, tile_n=tile_n,
                               tile_bits=tile_bits, epilogue=epilogue)
    return vals / q_scale[:, None], idx


# ------------------------------------------------- ragged paged attention
# value types of the ragged kernel -> its dtype code
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_MAX_QB = 2        # query rows per cluster, at most
# ragged_paged_attention.cu: slots a K/V tile, slots a CTA takes at least
# before the split grows, the largest (portable) cluster
_ATTN_TILE_SLOTS = 64
_ATTN_MIN_SLOTS = 16
_ATTN_MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class _RaggedPlan:
    """How ``ragged_paged_attention.cu`` takes one shape: ``qb`` query rows
    a cluster of ``cluster`` CTAs, ``smem`` bytes of dynamic shared memory
    a CTA, and the host array of the launch's sizes (``params``, passed by
    address, so a call is one ctypes call of nine arguments)."""
    qb: int
    cluster: int
    smem: int
    scale: float
    params: ctypes.Array
    params_ptr: int


_RAGGED_PLANS: dict[tuple, _RaggedPlan] = {}


def _ragged_cluster(s_len: int) -> int:
    """CTAs a cluster for a table of ``s_len`` slots (``cluster_for``)."""
    return min(_ATTN_MAX_CLUSTER, max(1, -(-s_len // _ATTN_MIN_SLOTS)))


def _ragged_split(max_pos: int, s_len: int) -> int:
    """CTAs of its cluster that take a share of a block's slots, from the
    block's largest position (-1: every row is padding, no CTA): at least
    ``_ATTN_MIN_SLOTS`` slots each, at most the whole cluster. The kernel
    computes the same on the card from the positions it reads."""
    n = min(max_pos + 1, s_len)
    if n <= 0:
        return 0
    return min(_ragged_cluster(s_len), -(-n // _ATTN_MIN_SLOTS))


def _ragged_smem(qb: int, n_rep: int, dh: int, s_len: int,
                 dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the kernel): the
    two-tile K/V ring (rows padded by 16 bytes), the query vectors and
    partial sums in float32, the scores of at most ``span`` slots, the local
    maxima and sums, the rows' positions."""
    esize = 4 if dtype == torch.float32 else 2
    rmax = qb * n_rep
    span = max(_ATTN_MIN_SLOTS, -(-s_len // _ragged_cluster(s_len)))
    return (esize * 2 * _ATTN_TILE_SLOTS * (dh + 16 // esize)
            + 4 * (2 * rmax * dh + rmax * span + 2 * rmax) + 4 * qb)


def _ragged_plan(l: int, tq: int, h: int, hkv: int, dh: int, num_pages: int,
                 ps: int, p: int, dtype: torch.dtype) -> _RaggedPlan:
    """The launch plan of a shape, made once and cached: the most query
    rows a cluster (up to ``_ATTN_MAX_QB``) whose CTA takes at most half a
    CTA's shared memory, or one row; raises where one row does not fit."""
    key = (l, tq, h, hkv, dh, num_pages, ps, p, dtype)
    plan = _RAGGED_PLANS.get(key)
    if plan is not None:
        return plan
    s_len = p * ps

    def smem(qb: int) -> int:
        return _ragged_smem(qb, h // hkv, dh, s_len, dtype)

    qb = min(tq, _ATTN_MAX_QB)
    while qb > 1 and smem(qb) > _SMEM_LIMIT // 2:
        qb //= 2
    if smem(qb) > _SMEM_LIMIT:
        raise ValueError(f"ragged_paged_attention: S={s_len} slots exceed "
                         "one CTA's shared memory")
    params = (ctypes.c_int * 10)(l, tq, h, hkv, dh, num_pages, ps, p, qb,
                                 _ATTN_DTYPES[dtype])
    plan = _RaggedPlan(qb, _ragged_cluster(s_len), smem(qb),
                       float(dh ** -0.5), params, ctypes.addressof(params))
    _RAGGED_PLANS[key] = plan
    return plan


# CUDA calls whose arguments passed every check -> (their plan, the C entry
# point), keyed by what the checks read (shapes, dtypes, devices): a
# repeated shape is then checked by one lookup (contiguity and alignment
# are still checked a call)
_RAGGED_CHECKED: dict[tuple, tuple] = {}


def ragged_paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Mixed prefill+decode GQA attention over one layer of the paged KV
    pool (``ragged_paged_attention.cu``; the TPU kernel's signature without
    ``interpret``).

    q (L, Tq, H, Dh) float32 or bfloat16, rope'd; k_pages, v_pages
    (num_pages, ps, Hkv, Dh) of q's type, one layer's pool view
    (``pages[li, 0]``, which is contiguous); tables (L, P) int32 page ids;
    positions (L, Tq) int32 cache slots, -1 for padding rows. Returns
    (L, Tq, H, Dh) in q.dtype; padding rows are zeros. On the card Dh must
    be a multiple of 8 up to 128 and a CTA's share of one row's scores must
    fit its shared memory; anything else raises."""
    sig = (q.shape, q.dtype, q.device, k_pages.shape, k_pages.dtype,
           k_pages.device, v_pages.shape, v_pages.dtype, v_pages.device,
           tables.shape, tables.dtype, tables.device, positions.shape,
           positions.dtype, positions.device)
    checked = _RAGGED_CHECKED.get(sig)
    if checked is None:
        plan = _ragged_checks(q, k_pages, v_pages, tables, positions)
        if plan is None:  # CPU tensors
            return kernels_ref.ragged_paged_attention(q, k_pages, v_pages,
                                                      tables, positions)
        checked = _RAGGED_CHECKED[sig] = (plan, _build.library(
            "ragged_paged_attention").nornic_ragged_paged_attention)
    plan, fn = checked
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous() and tables.is_contiguous()
            and positions.is_contiguous()):
        raise ValueError("ragged_paged_attention: every input must be "
                         "contiguous")
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16 != 0:
        raise ValueError("ragged_paged_attention: q and the pools must be "
                         "16-byte aligned")
    out = torch.empty_like(q)
    _launch("ragged_paged_attention", fn, *ptrs, tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), plan.params_ptr, plan.scale,
            device=q.device)
    return out


def _ragged_checks(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, tables: torch.Tensor,
                   positions: torch.Tensor) -> _RaggedPlan | None:
    """Every check of a ragged attention call's types, shapes and devices;
    raises on what neither the kernel nor its plain version takes. Returns
    the launch plan, or None for CPU tensors (the plain version's)."""
    dev = q.device
    _check(q, "q", _ATTN_DTYPES, 4, dev)
    _check(k_pages, "k_pages", q.dtype, 4, dev)
    _check(v_pages, "v_pages", q.dtype, 4, dev)
    _check(tables, "tables", torch.int32, 2, dev)
    _check(positions, "positions", torch.int32, 2, dev)
    l, tq, h, dh = q.shape
    num_pages, ps, hkv = k_pages.shape[:3]
    p = tables.shape[1]
    if (k_pages.shape != v_pages.shape or k_pages.shape[3] != dh
            or tables.shape[0] != l or positions.shape != (l, tq)):
        raise ValueError("ragged_paged_attention: q/pages/tables/positions "
                         "shapes disagree")
    if h % hkv != 0:
        raise ValueError(f"ragged_paged_attention: H={h} is no multiple of "
                         f"Hkv={hkv}")
    if dev.type != "cuda":
        return None
    if dh % 8 != 0 or dh > 128:
        raise ValueError(f"ragged_paged_attention: the CUDA kernel takes a "
                         f"head dim that is a multiple of 8 up to 128, got {dh}")
    return _ragged_plan(l, tq, h, hkv, dh, num_pages, ps, p, q.dtype)
