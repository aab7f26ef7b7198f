"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
from ``nornicdb_tpu_torch/ops/csrc`` on first use); without one they skip.
Run them on a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a GPU machine
need not have; these tests use only torch and the port.)

Tolerances: the int8 bins and the extract kernel are integer work and must
be bit-identical; the bf16 kernel sums its products in another order than
the plain version, so decoded values may differ by one packed-bin step
(2**(tile_bits - 21)) and ids only where two scores are that close.
"""

import time

import numpy as np
import pytest
import torch

from nornicdb_tpu_torch.ops import kernels as K
from nornicdb_tpu_torch.ops import kernels_ref as R
from test_torch_kernel_plans import CASES, adversarial_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(card, q=40, n=4096, d=128, seed=0):
    rng = np.random.default_rng(seed)
    qs = torch.from_numpy(_unit(rng, q, d)).to(card)
    c = torch.from_numpy(_unit(rng, n, d)).to(card)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(card)
    return qs, c, valid


@pytest.mark.parametrize("tile_n,rows", [(128, 8), (256, 4), (512, 16)])
def test_int8_bins_bit_identical(card, tile_n, rows):
    qs, c, valid = _inputs(card)
    q_i8, _ = K.quantize_rows(qs)
    c_i8, c_scale = K.quantize_rows(c)
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], tile_n, rows)
    before = K.launch_counts()["streaming_topk_int8"]
    got = K.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile_n, rows)
    want = R.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile_n, rows,
                                 tile_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.launch_counts()["streaming_topk_int8"] == before + 1


@pytest.mark.parametrize("q", [1, 40, 300])
def test_bf16_bins_within_one_step(card, q):
    qs, c, valid = _inputs(card, q=q)
    tile_n, k = 128, 50
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], tile_n, 8)
    got = K.streaming_bins(qs, c, valid, tile_n, rows)
    want = R.streaming_bins_bf16(qs, c, valid, tile_n, rows, tile_bits)
    dec = dict(k=k, n=c.shape[0], rows=rows, tile_n=tile_n, tile_bits=tile_bits)
    vg, ig = K._decode_packed(got, **dec)
    vw, iw = K._decode_packed(want, **dec)
    tol = 2.0 ** (tile_bits - 21) + 1e-5
    assert float((vg - vw).abs().max()) <= tol
    assert bool(valid[ig].all())
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in
                       zip(ig.cpu().tolist(), iw.cpu().tolist())])
    assert overlap >= 0.95


@pytest.mark.parametrize("k", [1, 100, 200])
def test_extract_equals_plain_and_sort(card, k):
    rng = np.random.default_rng(1)
    # few distinct values: many ties, which must break to the lowest bin
    flat = torch.from_numpy(
        rng.integers(0, 50, size=(37, 2048)).astype(np.int32)).to(card)
    kpad = -(-k // K.LANE) * K.LANE
    ev, ei = K._extract_topk(flat, k, kpad)
    pv, pi = R.extract_topk(flat, k, kpad)
    sv, si = K._topk_bins(flat, k, epilogue="sort")
    torch.cuda.synchronize()
    assert torch.equal(ev, pv) and torch.equal(ei, pi)
    assert torch.equal(ev[:, :k], sv) and torch.equal(ei[:, :k].long(), si)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("q,b,k", [
    (16, 2048, 100), (1025, 2048, 100), (1, 2048, 1), (16, 1000, 1000),
    (16, 777, 130), (5, 300, 257), (3, K._EXTRACT_MAX_BINS, 100),
    (2, 40_000, 10_000)])
def test_extract_radix_select_bit_identical(card, case, q, b, k):
    """The radix select against the plain version, bit for bit, values, ids
    and order: the serving shape at Q = 16 and 1025, k = 1, k = B, k no
    multiple of 128, B no multiple of the 256 threads, the largest B (whose
    picks are ranked against the row), and a k whose picks do not fit."""
    rng = np.random.default_rng(q + b + k)
    flat = torch.from_numpy(adversarial_rows(case, q, b, rng)).to(card)
    kpad = -(-k // K.LANE) * K.LANE
    before = K.launch_counts()["extract_topk"]
    ev, ei = K._extract_topk(flat, k, kpad)
    pv, pi = R.extract_topk(flat, k, kpad)
    torch.cuda.synchronize()
    assert K.launch_counts()["extract_topk"] == before + 1
    assert torch.equal(ev, pv) and torch.equal(ei, pi)


def test_extract_radix_select_whole_row_at_the_largest_b(card):
    """k = B = _EXTRACT_MAX_BINS: every bin a pick, ranked on the row."""
    b = K._EXTRACT_MAX_BINS
    flat = torch.from_numpy(adversarial_rows(
        "threshold_duplicates", 1, b, np.random.default_rng(2))).to(card)
    ev, ei = K._extract_topk(flat, b, b)
    order = torch.from_numpy(np.lexsort((np.arange(b), -flat[0].cpu().numpy())))
    torch.cuda.synchronize()
    assert torch.equal(ei[0].cpu().long(), order)
    assert torch.equal(ev[0].cpu(), flat[0].cpu()[order])


@pytest.mark.parametrize("d", [130, 100, 1])
def test_int8_bins_bit_identical_any_width(card, d):
    """Widths that are no multiple of 16 bytes, which a tensor map cannot
    take, go through a zero-padded copy to the same kernel."""
    qs, c, valid = _inputs(card, d=d)
    q_i8, _ = K.quantize_rows(qs)
    c_i8, c_scale = K.quantize_rows(c)
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], 128, 8)
    got = K.streaming_bins_int8(q_i8, c_i8, c_scale, valid, 128, rows)
    want = R.streaming_bins_int8(q_i8, c_i8, c_scale, valid, 128, rows,
                                 tile_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _int8_inputs(card, q, d, n=4096, seed=0):
    qs, c, valid = _inputs(card, q=q, n=n, d=d, seed=seed)
    q_i8, _ = K.quantize_rows(qs)
    c_i8, c_scale = K.quantize_rows(c)
    return q_i8, c_i8, c_scale, valid


def _int8_bins_agree(q_i8, c_i8, c_scale, valid, tile_n=128, rows=8):
    """The kernel's bins equal the plain version's bit for bit, in one
    launch."""
    n_tiles, rows, tile_bits = K.streaming_geometry(c_i8.shape[0], tile_n, rows)
    before = K.launch_counts()["streaming_topk_int8"]
    got = K.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile_n, rows)
    want = R.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile_n, rows,
                                 tile_bits)
    torch.cuda.synchronize()
    assert K.launch_counts()["streaming_topk_int8"] == before + 1
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("d", [1, 100, 130, 1024, 2048])
@pytest.mark.parametrize("q", [1, 16, 40, 200, 300])
def test_int8_bins_every_query_block_and_width(card, q, d):
    """Every query block width the plan picks (8, 16, 64, then 2 blocks of
    128 in a cluster of 2, the second partly empty, and 3 blocks
    unclustered), widths padded to 16 bytes and partial 128-byte chunks,
    the query block kept in shared memory (D <= 1024) or carried by each
    stage (D = 2048 at 128 queries), each bin row's tile loop split: bins
    bit-identical to the plain version's, one launch."""
    _int8_bins_agree(*_int8_inputs(card, q, d, seed=q + d))


@pytest.mark.parametrize("which", ["queries", "corpus", "both"])
def test_int8_bins_unaligned_base(card, which):
    """A contiguous view one byte into its buffer (off every 16-byte
    boundary) goes through the padded copy, bins unchanged."""
    q_i8, c_i8, c_scale, valid = _int8_inputs(card, 40, 128, seed=3)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == 1
        return view

    if which in ("queries", "both"):
        q_i8 = shifted(q_i8)
    if which in ("corpus", "both"):
        c_i8 = shifted(c_i8)
    _int8_bins_agree(q_i8, c_i8, c_scale, valid)


@pytest.mark.parametrize("q", [16, 300])
def test_int8_bins_all_rows_masked(card, q):
    """Every row masked: every score -3 + 0, the bins still the plain
    version's."""
    q_i8, c_i8, c_scale, valid = _int8_inputs(card, q, 256, seed=5)
    _int8_bins_agree(q_i8, c_i8, c_scale, torch.zeros_like(valid))


@pytest.mark.parametrize("q,tile_n,rows", [(16, 512, 4), (256, 256, 16),
                                           (1024, 1024, 2)])
def test_int8_bins_wide_tiles(card, q, tile_n, rows):
    """Tiles of several 128-row blocks (blockIdx.y), an even number of
    query blocks in clusters of 2, few bin rows (long tile loops)."""
    _int8_bins_agree(*_int8_inputs(card, q, 256, n=8192, seed=tile_n),
                     tile_n=tile_n, rows=rows)


def test_int8_plan_shared_memory_is_the_kernels(card):
    from nornicdb_tpu_torch.ops import _build

    lib = _build.library("streaming_topk")
    for d in (1, 100, 1024, 2048, 4096):
        for q in (1, 16, 40, 100, 1024):
            plan = K._int8_plan(q, d, 0, 0, 7813, 16, 128, 132)
            assert lib.nornic_streaming_i8_smem_bytes(
                plan.nq, plan.width, plan.stages,
                int(plan.q_kept)) == plan.smem <= K._SMEM_LIMIT


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 128), (torch.float16, 128), (torch.float32, 130),
    (torch.bfloat16, 130), (torch.float32, 1)])
def test_bf16_bins_any_corpus_type_and_width(card, dtype, d):
    """A 16-bit corpus, and widths that are no multiple of 4, go through the
    same kernel, within one packed-bin step of the plain version."""
    qs, c, valid = _inputs(card, d=d)
    c = c.to(dtype)
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], 128, 8)
    before = K.launch_counts()["streaming_topk_bf16"]
    got = K.streaming_bins(qs, c, valid, 128, rows)
    want = R.streaming_bins_bf16(qs, c, valid, 128, rows, tile_bits)
    dec = dict(k=20, n=c.shape[0], rows=rows, tile_n=128, tile_bits=tile_bits)
    vg, _ = K._decode_packed(got, **dec)
    vw, _ = K._decode_packed(want, **dec)
    assert float((vg - vw).abs().max()) <= 2.0 ** (tile_bits - 21) + 1e-5
    assert K.launch_counts()["streaming_topk_bf16"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("q", [1, 16, 100, 200, 1024])
def test_bf16_bins_every_query_block(card, dtype, q):
    """Every query block width the plan picks (8, 16, 128, then 2 and 8
    blocks of 128 in clusters of 2, the second block of 200 partly empty),
    each corpus type; values within one packed-bin step and ids equal to
    the plain version's but for near-ties; one launch a call."""
    qs, c, valid = _inputs(card, q=q, n=4096, d=256, seed=q)
    c = c.to(dtype)
    tile_n, k = 128, 50
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], tile_n, 8)
    before = K.launch_counts()["streaming_topk_bf16"]
    got = K.streaming_bins(qs, c, valid, tile_n, rows)
    want = R.streaming_bins_bf16(qs, c, valid, tile_n, rows, tile_bits)
    torch.cuda.synchronize()
    assert K.launch_counts()["streaming_topk_bf16"] == before + 1
    dec = dict(k=k, n=c.shape[0], rows=rows, tile_n=tile_n, tile_bits=tile_bits)
    vg, ig = K._decode_packed(got, **dec)
    vw, iw = K._decode_packed(want, **dec)
    assert float((vg - vw).abs().max()) <= 2.0 ** (tile_bits - 21) + 1e-5
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in
                       zip(ig.cpu().tolist(), iw.cpu().tolist())])
    assert overlap >= 0.99


@pytest.mark.parametrize("dtype,d,offset", [
    (torch.float32, 1030, 0), (torch.bfloat16, 100, 0), (torch.float16, 7, 0),
    (torch.float32, 100, 0), (torch.float32, 64, 1), (torch.bfloat16, 128, 3)])
def test_bf16_bins_padded_copy_and_partial_chunks(card, dtype, d, offset):
    """Widths the bulk copies cannot take (no multiple of 16 bytes), a base
    off a 16-byte boundary (the same values ``offset`` values into a fresh
    buffer),
    and widths whose last 64-deep chunk is partial, all through one launch
    of the same kernel."""
    qs, c, valid = _inputs(card, q=40, n=2048, d=d, seed=d + offset)
    c = c.to(dtype)
    if offset:
        buf = torch.zeros(c.numel() + offset, dtype=dtype, device=card)
        buf[offset:] = c.reshape(-1)
        c = buf[offset:].view(c.shape)
        assert c.data_ptr() % 16 != 0
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], 128, 8)
    plan = K._streaming_plan(40, d, dtype, c.data_ptr(), n_tiles, rows, 128, 132)
    assert plan.copy_c == (plan.width != d or offset != 0)
    before = K.launch_counts()["streaming_topk_bf16"]
    got = K.streaming_bins(qs, c, valid, 128, rows)
    want = R.streaming_bins_bf16(qs, c, valid, 128, rows, tile_bits)
    torch.cuda.synchronize()
    assert K.launch_counts()["streaming_topk_bf16"] == before + 1
    dec = dict(k=20, n=c.shape[0], rows=rows, tile_n=128, tile_bits=tile_bits)
    vg, _ = K._decode_packed(got, **dec)
    vw, _ = K._decode_packed(want, **dec)
    assert float((vg - vw).abs().max()) <= 2.0 ** (tile_bits - 21) + 1e-5


@pytest.mark.parametrize("q", [16, 300])
@pytest.mark.parametrize("tile_n,rows", [(256, 4), (512, 16), (1024, 2)])
def test_bf16_bins_wide_tiles(card, q, tile_n, rows):
    """Tiles of several 128-row CTA blocks (the tile_n pick_tile_n gives a
    corpus whose capacity is a multiple of 1,024), bin rows that split
    the tile loop or not."""
    qs, c, valid = _inputs(card, q=q, n=8192, d=192, seed=tile_n + q)
    n_tiles, rows, tile_bits = K.streaming_geometry(c.shape[0], tile_n, rows)
    before = K.launch_counts()["streaming_topk_bf16"]
    got = K.streaming_bins(qs, c, valid, tile_n, rows)
    want = R.streaming_bins_bf16(qs, c, valid, tile_n, rows, tile_bits)
    torch.cuda.synchronize()
    assert K.launch_counts()["streaming_topk_bf16"] == before + 1
    dec = dict(k=50, n=c.shape[0], rows=rows, tile_n=tile_n, tile_bits=tile_bits)
    vg, ig = K._decode_packed(got, **dec)
    vw, iw = K._decode_packed(want, **dec)
    assert float((vg - vw).abs().max()) <= 2.0 ** (tile_bits - 21) + 1e-5
    overlap = np.mean([len(set(a) & set(b)) / 50 for a, b in
                       zip(ig.cpu().tolist(), iw.cpu().tolist())])
    assert overlap >= 0.99


def test_bf16_plan_shared_memory_is_the_kernels(card):
    from nornicdb_tpu_torch.ops import _build

    lib = _build.library("streaming_topk_bf16")
    for dtype, code in K._CORPUS_DTYPES.items():
        for q in (1, 16, 40, 100, 1024):
            plan = K._streaming_plan(q, 1024, dtype, 0, 7813, 16, 128, 132)
            assert lib.nornic_streaming_bf16_smem_bytes(
                plan.nq, plan.stages, code) == plan.smem <= K._SMEM_LIMIT


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    qs, c, valid = _inputs(card)
    with pytest.raises(ValueError):
        K.streaming_bins(qs, c, valid, 64, 4)  # tile_n % 128 != 0
    with pytest.raises(ValueError):
        K.streaming_bins(qs, c.t(), valid, 128, 4)  # not contiguous
    with pytest.raises(TypeError):
        K.streaming_bins(qs.double(), c, valid, 128, 4)


def test_int8_wrapper_refuses_what_the_kernel_does_not_take(card):
    q_i8, c_i8, c_scale, valid = _int8_inputs(card, 16, 128)
    with pytest.raises(ValueError):
        K.streaming_bins_int8(q_i8, c_i8, c_scale, valid, 64, 4)  # tile_n
    with pytest.raises(ValueError):
        K.streaming_bins_int8(q_i8, c_i8.t(), c_scale, valid, 128, 4)
    with pytest.raises(TypeError):
        K.streaming_bins_int8(q_i8.float(), c_i8, c_scale, valid, 128, 4)


# ------------------------------------------------- ragged paged attention
# Tolerances, kernel against its plain version on the card: float32 within
# 1e-5 (both sum in float32, in other orders; expf and torch.exp differ by
# an ulp); bfloat16 within 2**-7 relative and absolute (the probabilities
# are rounded to bf16 before P.V, so a one-ulp float32 difference can move
# one probability by a bf16 ulp, and the output is rounded to bf16).
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _ragged_inputs(card, dtype, h, hkv, dh, tq, lanes, seed=0, ps=16, p=16):
    """Lanes of every kind the engine makes: decode rows at mixed lengths,
    a prefill chunk behind a page it shares with lane 0, a half-filled
    chunk, an all-padding lane; tables padded with the null page 0."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + lanes * p
    k_pages = rng.standard_normal((num_pages, ps, hkv, dh))
    v_pages = rng.standard_normal((num_pages, ps, hkv, dh))
    q = rng.standard_normal((lanes, tq, h, dh))
    tables = np.zeros((lanes, p), np.int32)
    positions = np.full((lanes, tq), -1, np.int32)
    free = list(range(1, num_pages))
    for lane in range(lanes):
        kind = (lane + (tq > 1)) % 5  # a lone chunk-block lane is a chunk
        if kind == 4:
            continue  # all padding, null table
        last = int(rng.integers(0, p * ps))
        if kind == 0:      # decode row at a mixed length
            positions[lane, 0] = last
        elif kind == 1:    # full chunk ending at `last`
            positions[lane] = np.clip(np.arange(last - tq + 1, last + 1), 0, None)
        elif kind == 2:    # chunk, first half valid
            n = max(1, tq // 2)
            positions[lane, :n] = np.arange(last, last + n) % (p * ps)
        else:              # one row at the very last slot
            positions[lane, tq - 1] = p * ps - 1
        used = int(positions[lane].max()) // ps + 1
        tables[lane, :used] = [free.pop() for _ in range(used)]
    if lanes > 1:
        tables[1, 0] = tables[0, 0]  # a page shared by two lanes
    t = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a)).to(card, dt)
    return (t(q), t(k_pages), t(v_pages), t(tables, torch.int32),
            t(positions, torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hkv,dh", [(14, 2, 64), (4, 2, 16)])
@pytest.mark.parametrize("tq,lanes", [(1, 10), (64, 1), (8, 6)])
def test_ragged_attention_matches_plain(card, dtype, h, hkv, dh, tq, lanes):
    args = _ragged_inputs(card, dtype, h, hkv, dh, tq, lanes,
                          seed=h + dh + tq)
    before = K.launch_counts()["ragged_paged_attention"]
    got = K.ragged_paged_attention(*args)
    want = R.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["ragged_paged_attention"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    pad = args[4] < 0
    assert bool((got[pad] == 0).all()), "padding rows must be zeros"
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _ragged_split_inputs(card, dtype, tq, p, unit, seed=0, h=14, hkv=2, dh=64,
                         ps=16):
    """Nine lanes of a table of P pages: lane n < 8 with largest position
    unit * (n + 1) - 1 (at most S - 1), then an all-padding lane."""
    rng = np.random.default_rng(seed)
    s_len = p * ps
    lanes = 9
    num_pages = 1 + 8 * p
    positions = np.full((lanes, tq), -1, np.int32)
    tables = np.zeros((lanes, p), np.int32)
    for lane in range(8):
        last = min(s_len - 1, (lane + 1) * unit - 1)
        positions[lane] = np.clip(np.arange(last - tq + 1, last + 1), -1, None)
        tables[lane] = 1 + lane * p + np.arange(p)
    t = lambda a, dt=dtype: torch.from_numpy(np.ascontiguousarray(a)).to(card, dt)
    return (t(rng.standard_normal((lanes, tq, h, dh))),
            t(rng.standard_normal((num_pages, ps, hkv, dh))),
            t(rng.standard_normal((num_pages, ps, hkv, dh))),
            t(tables, torch.int32), t(positions, torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq", [1, 8])
def test_ragged_attention_every_split(card, dtype, tq):
    """Lanes whose largest positions take 1..8 CTAs of the cluster, and a
    lane whose rows are all padding, in one launch."""
    args = _ragged_split_inputs(card, dtype, tq, p=16, unit=K._ATTN_MIN_SLOTS,
                                seed=tq)
    lane_max = args[4].max(dim=1).values.cpu().tolist()
    assert [K._ragged_split(m, 256) for m in lane_max] == [1, 2, 3, 4, 5, 6, 7, 8, 0]
    before = K.launch_counts()["ragged_paged_attention"]
    got = K.ragged_paged_attention(*args)
    want = R.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["ragged_paged_attention"] == before + 1
    assert bool((got[args[4] < 0] == 0).all()), "padding rows must be zeros"
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_attention_at_the_shared_memory_limit(card, dtype):
    """The widest table whose plan fits a CTA: every CTA of the lanes'
    clusters holds up to S / 8 scores a query vector. One page wider
    raises."""
    from test_torch_kernel_plans import widest_ragged_table

    from nornicdb_tpu_torch.ops import _build

    p = widest_ragged_table(dtype)
    args = _ragged_split_inputs(card, dtype, 1, p=p, unit=p * 16 // 8, seed=p)
    plan = K._ragged_plan(9, 1, 14, 2, 64, args[1].shape[0], 16, p, dtype)
    lib = _build.library("ragged_paged_attention")
    assert lib.nornic_ragged_attn_smem_bytes(
        plan.qb, 7, 64, p * 16, K._ATTN_DTYPES[dtype]) == plan.smem
    assert plan.smem <= K._SMEM_LIMIT
    before = K.launch_counts()["ragged_paged_attention"]
    got = K.ragged_paged_attention(*args)
    want = R.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert K.launch_counts()["ragged_paged_attention"] == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    wider = torch.cat([args[3], args[3][:, :1]], dim=1).contiguous()
    with pytest.raises(ValueError):
        K.ragged_paged_attention(*args[:3], wider, args[4])


def test_ragged_plan_is_the_kernels(card):
    """The plan's shared memory against the kernel's own (which follows the
    cluster size through each CTA's span of scores)."""
    from nornicdb_tpu_torch.ops import _build

    lib = _build.library("ragged_paged_attention")
    for dtype, code in K._ATTN_DTYPES.items():
        for qb, n_rep, dh, s_len in [(4, 7, 64, 256), (1, 7, 64, 4096),
                                     (2, 2, 16, 48), (4, 1, 128, 16),
                                     (1, 8, 128, 20_000), (2, 7, 64, 100),
                                     (1, 7, 64, 17)]:
            assert lib.nornic_ragged_attn_smem_bytes(qb, n_rep, dh, s_len, code) == \
                K._ragged_smem(qb, n_rep, dh, s_len, dtype)


def test_ragged_attention_refuses_what_the_kernel_does_not_take(card):
    q, kp, vp, tables, pos = _ragged_inputs(card, torch.bfloat16, 4, 2, 16, 1, 4)
    with pytest.raises(ValueError):  # head dim no multiple of 8
        K.ragged_paged_attention(q[..., :12].contiguous(), kp[..., :12].contiguous(),
                                 vp[..., :12].contiguous(), tables, pos)
    with pytest.raises(ValueError):  # one row's scores exceed shared memory
        wide = tables.repeat(1, 4096)
        K.ragged_paged_attention(q, kp, vp, wide.contiguous(), pos)
    with pytest.raises(TypeError):
        K.ragged_paged_attention(q.half(), kp.half(), vp.half(), tables, pos)
    with pytest.raises(ValueError):
        K.ragged_paged_attention(q, kp, vp, tables.t(), pos)


# ------------------------------------------------------------ fused cosine
# Kernel against its plain version on the card: within 1e-5 absolute. Both
# compute in float32 (no TF32); the kernel scales each dot product by the
# row's inverse norm after the product where the plain version scales the
# row first, and sums in another order.
COSINE_TOL = 1e-5


def _cosine_inputs(card, q, n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qs = _unit(rng, q, d)
    c = (rng.standard_normal((n, d)) * rng.uniform(0.1, 5.0, (n, 1))).astype(
        np.float32)
    c[3] = 0.0  # the 1e-24 clamp
    return (torch.from_numpy(qs).to(card),
            torch.from_numpy(c).to(card, dtype),
            torch.from_numpy(rng.random(n) > 0.2).to(card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("q", [1, 15, 16, 17, 100, 129, 1024])
@pytest.mark.parametrize("d", [1, 3, 7, 31, 33, 100, 1024, 1030])
def test_fused_cosine_matches_plain(card, dtype, q, d):
    """Every query tile (TM from Q), widths the 16-byte copies take as they
    are and widths the wrapper pads, each corpus type."""
    n = 1000  # no multiple of the kernel's 128-row tile: a ragged edge
    qs, c, _ = _cosine_inputs(card, q, n, d, dtype, seed=q + d)
    before = K.launch_counts()["fused_cosine_scores"]
    got = K.fused_cosine_scores(qs, c, tile_n=n)
    want = R.fused_cosine_scores(qs, c)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_cosine_scores"] == before + 1
    assert got.shape == (q, n) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= COSINE_TOL
    assert bool((got[:, 3] == 0).all())


@pytest.mark.parametrize("n", [1, 127, 129, 4096 + 5])
def test_fused_cosine_corpus_tails(card, n):
    qs, c, _ = _cosine_inputs(card, 40, max(n, 4), 64, torch.float32, seed=n)
    c = c[:n].contiguous()
    got = K.fused_cosine_scores(qs, c, tile_n=n)
    torch.cuda.synchronize()
    assert float((got - R.fused_cosine_scores(qs, c)).abs().max()) <= COSINE_TOL


@pytest.mark.parametrize("dtype,d", [(torch.float32, 3), (torch.float32, 4),
                                     (torch.bfloat16, 8), (torch.float16, 5)])
def test_fused_cosine_unaligned_views(card, dtype, d):
    """Contiguous views that start off a 16-byte boundary (``c[1:]``, and a
    query block one value into its buffer) go through an aligned copy."""
    def off_by_one(x):  # the same values, one value into a fresh buffer
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    qs, c, _ = _cosine_inputs(card, 20, 301, d, dtype, seed=d)
    c = c[1:]
    if c.data_ptr() % 16 == 0:
        c = off_by_one(c)
    q_off = off_by_one(qs)
    assert c.is_contiguous() and q_off.is_contiguous()
    assert c.data_ptr() % 16 != 0 and q_off.data_ptr() % 16 != 0
    before = K.launch_counts()["fused_cosine_scores"]
    got = K.fused_cosine_scores(q_off, c, tile_n=300)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_cosine_scores"] == before + 1
    assert float((got - R.fused_cosine_scores(qs, c)).abs().max()) <= COSINE_TOL


def test_fused_cosine_topk_matches_plain(card):
    qs, c, valid = _cosine_inputs(card, 64, 8192, 256, torch.float32, seed=5)
    vk, ik = K.fused_cosine_topk(qs, c, valid, 100, tile_n=128)
    scores = torch.where(valid[None, :], R.fused_cosine_scores(qs, c),
                         float("-inf"))
    vp, ip = K.topk_lowest_index(scores, 100)
    torch.cuda.synchronize()
    assert float((vk - vp).abs().max()) <= COSINE_TOL
    assert bool(valid[ik].all())
    # an id may differ only where two scores lie within the tolerance
    rr, jj = torch.nonzero(ik != ip, as_tuple=True)
    gap = (scores[rr, ik[rr, jj]] - scores[rr, ip[rr, jj]]).abs()
    assert bool((gap <= COSINE_TOL).all())


def test_fused_cosine_refuses_what_the_kernel_does_not_take(card):
    qs, c, _ = _cosine_inputs(card, 8, 512, 64, torch.float32)
    with pytest.raises(ValueError):
        K.fused_cosine_scores(qs, c[:500].contiguous(), tile_n=128)
    with pytest.raises(TypeError):
        K.fused_cosine_scores(qs.half(), c)
    with pytest.raises(ValueError):
        K.fused_cosine_scores(qs, c.cpu())


# --------------------------------------------------------------------- IVF
def test_ivf_search_on_the_card_gives_the_cpu_ids(card):
    from nornicdb_tpu_torch.ops import ivf

    rng = np.random.default_rng(7)
    centers = _unit(rng, 16, 64)
    assign = rng.integers(0, 16, 3000).astype(np.int32)
    rows = centers[assign] + 0.2 * rng.standard_normal((3000, 64)).astype(
        np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    assign[:1200] = 0  # one oversized cluster: the residual spill
    qs = rows[rng.integers(0, 3000, 40)]
    lay_cpu = ivf.build_ivf_layout(rows, np.arange(3000), assign, centers,
                                   device="cpu")
    lay_gpu = ivf.build_ivf_layout(rows, np.arange(3000), assign, centers,
                                   device=card)
    assert lay_gpu.residual is not None
    assert torch.equal(lay_gpu.blocks.cpu(), lay_cpu.blocks)
    for n_probe, k in ((1, 10), (4, 50)):
        v_c, s_c = ivf.ivf_search(lay_cpu, qs, k=k, n_probe=n_probe)
        v_g, s_g = ivf.ivf_search(lay_gpu, qs, k=k, n_probe=n_probe)
        np.testing.assert_array_equal(s_g, s_c)
        fin = np.isfinite(v_c)
        assert np.max(np.abs(v_g[fin] - v_c[fin])) <= 1e-5
        v_1, s_1 = ivf.ivf_search(lay_gpu, qs, k=k, n_probe=n_probe,
                                  max_bytes=1)  # one cluster a chunk
        np.testing.assert_array_equal(s_1, s_g)


def test_clustered_corpus_on_the_card(card):
    from nornicdb_tpu_torch.ops.similarity import DeviceCorpus

    rng = np.random.default_rng(8)
    centers = _unit(rng, 8, 32)
    rows = centers[rng.integers(0, 8, 2000)] + 0.15 * rng.standard_normal(
        (2000, 32)).astype(np.float32)
    corpus = DeviceCorpus(dims=32, device=card)
    corpus.add_batch([f"n{i}" for i in range(2000)], rows)
    assert corpus.cluster(k=8, iters=5) == 8
    assert corpus._ivf.blocks.is_cuda
    res = corpus.search(rows[:16], k=5, n_probe=3)
    assert [r[0][0] for r in res] == [f"n{i}" for i in range(16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bge_forward_packed_on_the_card_gives_the_cpu_result(card, dtype):
    """The embed slice's packed forward (plain torch ops) on the card
    against the same function on the CPU at BGE_SMALL: float32 within
    1e-5, bf16 within 2**-5 absolute and cosine >= 0.999 (the bound of
    tests/test_torch_bge_m3.py)."""
    import dataclasses

    from nornicdb_tpu_torch._device import tree_to
    from nornicdb_tpu_torch.models import bge_m3 as TB
    from nornicdb_tpu_torch.serving import RaggedPacker

    cfg = dataclasses.replace(TB.BGE_SMALL, dtype=dtype)
    params = TB.init_params(cfg, 0, "cpu")
    on_card = tree_to(params, card)
    rng = np.random.default_rng(0)
    seqs = [[0] + rng.integers(4, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(1, 60, 24)]
    p = RaggedPacker(pad_id=1, pad_token_id=1, max_len=128).pack(seqs)
    args = [torch.from_numpy(a) for a in
            (p.ids, p.seg, p.positions, p.cls_rows, p.cls_cols)]
    want = TB.forward_packed(params, cfg, *args)[:p.n_segments]
    got = TB.forward_packed(on_card, cfg, *[a.to(card) for a in args])
    got = got[:p.n_segments].cpu()
    assert torch.isfinite(got).all()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert float((got - want).abs().max()) <= 2.0 ** -5
        assert float((got * want).sum(-1).min()) >= 0.999


def test_serving_engine_round_trip_on_the_card(card):
    """One ServingEngine round trip over a DeviceEmbedder on the card:
    packed embeddings agree with the padded per-request path (float32
    cosine > 1 - 1e-5) and the engine packed them."""
    import dataclasses

    from nornicdb_tpu_torch.config import ServingConfig
    from nornicdb_tpu_torch.embed import DeviceEmbedder
    from nornicdb_tpu_torch.models import bge_m3 as TB
    from nornicdb_tpu_torch.serving import ServingEngine

    emb = DeviceEmbedder(cfg=dataclasses.replace(TB.BGE_SMALL,
                                                 dtype="float32"))
    assert emb.device.type == "cuda"
    eng = ServingEngine(emb, ServingConfig())
    texts = ["x", "short one", " ".join(f"w{i}" for i in range(60)),
             "a slightly longer sentence with a dozen words in it"]
    try:
        out = eng.embed_batch(texts)
    finally:
        eng.stop()
    ref = emb.embed_batch(texts)
    for a, b in zip(out, ref):
        assert a.shape == (TB.BGE_SMALL.dims,) and np.isfinite(a).all()
        assert float(np.dot(a, b)) > 1.0 - 1e-5
    assert eng.stats.packed_batches >= 1 and emb.stats["packed_dispatches"] >= 1


def test_decode_graph_replays_decode_step(card):
    """qwen2.DecodeGraph on the card against eager decode_step over the
    same prefill at QWEN_SMALL float32: the first (eager) step and every
    replay give decode_step's logits within 1e-5 and its tokens."""
    import dataclasses

    from nornicdb_tpu_torch.models import qwen2 as TQ

    cfg = dataclasses.replace(TQ.QWEN_SMALL, dtype="float32")
    params = TQ.init_params(cfg, 0, card)
    prompt = torch.tensor([[5, 17, 42, 99, 7]], device=card)
    logits, ref = TQ.prefill(params, cfg, prompt, 64)
    _, cur = TQ.prefill(params, cfg, prompt, 64)
    graph = TQ.DecodeGraph(params, cfg, cur, torch.cuda.Stream(card))
    tok = int(torch.argmax(logits[0]))
    for pos in range(5, 25):
        want, ref = TQ.decode_step(
            params, cfg, torch.tensor([tok], device=card), ref, pos)
        got = graph.step(tok, pos)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert int(torch.argmax(got[0])) == int(torch.argmax(want[0]))
        tok = int(torch.argmax(want[0]))
    for (ck, cv), (rk, rv) in zip(cur, ref):
        torch.testing.assert_close(ck, rk, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cv, rv, rtol=1e-5, atol=1e-5)


def test_dense_engine_on_the_card_gives_the_cpu_tokens(card):
    """GenerationEngine(mode="dense") on the card, its decode steps replayed
    from captured graphs, serves QWEN_SMALL float32 requests with the CPU
    engine's tokens, launches no ragged kernel and drops each graph with its
    sequence. Where the two part, the card's token must be a near-tie
    (within 1e-4) of the CPU dense path's largest logit, teacher-forced on
    the card's tokens."""
    import dataclasses

    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.genserve import GenerationEngine
    from nornicdb_tpu_torch.models import qwen2 as TQ

    cfg = dataclasses.replace(TQ.QWEN_SMALL, dtype="float32")
    params = TQ.init_params(cfg, 0, "cpu")
    gcfg = GenServeConfig(mode="dense")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, cfg.vocab_size, int(n)).tolist()
               for n in (3, 20, 41, 70)]
    outs = {}
    for dev in ("cpu", card):
        eng = GenerationEngine(params, cfg, config=gcfg, device=dev)
        before = K.launch_counts()["ragged_paged_attention"]
        try:
            handles = [eng.submit(p, max_new_tokens=12) for p in prompts]
            outs[str(dev)] = [h.result() for h in handles]
        finally:
            eng.stop()
        assert K.launch_counts()["ragged_paged_attention"] == before
        assert eng.stats.decode_steps == 4 * 11
        assert all(s.dense_graph is None for s in eng._running)
    for prompt, got, want in zip(prompts, outs["cuda"], outs["cpu"]):
        if got == want:
            continue
        logits, caches = TQ.prefill(params, cfg, torch.tensor([prompt]),
                                    TQ.round_up_pow2(len(prompt) + 12))
        for j, tok in enumerate(got):
            assert float(logits[0].max() - logits[0, tok]) <= 1e-4, (j, tok)
            logits, caches = TQ.decode_step(params, cfg, torch.tensor([tok]),
                                            caches, len(prompt) + j)


def test_uploader_patches_the_card_without_a_query(card):
    """The write-behind uploader brings the resident buffer on the card up
    to date with no search: dirty blocks drain, the patched rows and the
    validity mask equal the host's, and none of it is query stall."""
    from nornicdb_tpu_torch.ops.similarity import DeviceCorpus

    rng = np.random.default_rng(12)
    vecs = _unit(rng, 2000, 64)
    c = DeviceCorpus(dims=64, device=card)
    c.add_batch([f"u{i}" for i in range(2000)], vecs)
    c.search(vecs[:1], k=1)  # first (full) upload on the query path
    c.start_uploader(interval=0.001)
    try:
        stall = c.sync_stats.query_stall_s
        for i in range(0, 2000, 97):
            c.add(f"u{i}", vecs[(i + 1) % 2000])
        c.remove("u1500")
        deadline = time.monotonic() + 20
        while c._dirty_blocks and time.monotonic() < deadline:
            time.sleep(0.005)
        torch.cuda.synchronize()
        assert not c._dirty_blocks and c.sync_stats.uploader_runs >= 1
        assert c.sync_stats.uploader_errors == 0
        assert c.sync_stats.query_stall_s == stall
        assert torch.equal(c._dev.cpu(), torch.from_numpy(c._host))
        assert torch.equal(c._dev_valid.cpu(), torch.from_numpy(c._valid))
    finally:
        c.stop_uploader()


def test_hybrid_service_on_the_card_ranks_as_on_the_cpu(card):
    """SearchService.search over one small MemoryEngine graph on the card
    and on the CPU: the same ranked ids and fused scores, vector scores
    within the bf16 kernel's tolerance (2**-14 + 1e-5: the score decoding
    step at this size), with the uploader on and a write in between."""
    from nornicdb_tpu_torch.embed import HashEmbedder
    from nornicdb_tpu_torch.search import SearchConfig, SearchService
    from nornicdb_tpu_torch.storage import MemoryEngine, Node

    words = "graph node edge vector search index memory storage".split()
    rng = np.random.default_rng(8)
    hasher = HashEmbedder(48)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(2, 7))))
             + f" uniq{i}" for i in range(300)]
    services = []
    for dev in ("cpu", card):
        eng = MemoryEngine()
        svc = SearchService(eng, HashEmbedder(48),
                            config=SearchConfig(write_behind=True),
                            device=dev)
        svc.attach(eng)
        for i, t in enumerate(texts):
            eng.create_node(Node(id=f"n{i}", properties={"content": t},
                                 embedding=hasher.embed(t)))
        services.append((eng, svc))
    try:
        for step in range(2):
            if step:
                for eng, _ in services:
                    node = eng.get_node("n7")
                    node.properties["content"] = "rewritten uniqR graph"
                    node.embedding = hasher.embed("rewritten uniqR graph")
                    eng.update_node(node)
            for q in texts[:20] + ["graph node", "rewritten uniqR graph"]:
                want, got = (svc.search(q) for _, svc in services)
                assert [r["id"] for r in got] == [r["id"] for r in want], q
                for g, w in zip(got, want):
                    assert g["score"] == w["score"]
                    if w["vector_score"] is not None:
                        assert abs(g["vector_score"] - w["vector_score"]) \
                            <= 2.0 ** -14 + 1e-5
    finally:
        for _, svc in services:
            svc.shutdown()


@pytest.mark.parametrize("kind", ["lm", "infonce"])
def test_train_step_on_the_card_gives_the_cpu_step(card, kind):
    """One train step (forward, backward, fused AdamW) of QWEN_SMALL /
    BGE_SMALL in float32 on the card against the same step on the CPU from
    the same parameters and batch: the loss within 1e-4 relative and every
    updated parameter within 2e-6 + 1e-3 lr of the CPU's (the gradients sum
    in another order; a gradient near zero may flip Adam's near-sign update,
    so at most 0.1% of the elements may sit up to 2 lr apart; bge-m3's key
    biases have an exact gradient of zero, so Adam's step there normalizes
    rounding noise and only the 2 lr bound holds). Every parameter and
    optimizer-state tensor stays on the card."""
    import dataclasses

    from nornicdb_tpu_torch._device import tree_to
    from nornicdb_tpu_torch.models import bge_m3 as TB
    from nornicdb_tpu_torch.models import qwen2 as TQ
    from nornicdb_tpu_torch.models import training as TT
    from nornicdb_tpu_torch.models import weights

    rng = np.random.default_rng(0)
    lr = 1e-3
    if kind == "lm":
        cfg = dataclasses.replace(TQ.QWEN_SMALL, dtype="float32")
        params = TQ.init_params(cfg, 0, "cpu")
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33))
                               .astype(np.int32))
        batch = {"ids": ids, "mask": torch.ones_like(ids)}
        make = TT.make_lm_train_step
    else:
        cfg = dataclasses.replace(TB.BGE_SMALL, dtype="float32")
        params = TB.init_params(cfg, 0, "cpu")
        ids = torch.from_numpy(rng.integers(4, cfg.vocab_size, (2, 8, 24))
                               .astype(np.int32))
        mask = torch.ones_like(ids[0])
        mask[:, 20:] = 0
        batch = {"ids_a": ids[0], "mask_a": mask, "ids_b": ids[1],
                 "mask_b": torch.ones_like(mask)}
        make = TT.make_train_step
    opt = TT.make_optimizer(lr)
    on_card = TT.TrainState.create(tree_to(params, card), opt)
    on_cpu = TT.TrainState.create(params, opt)
    step = make(cfg, opt)
    _, l_card = step(on_card, {k: v.to(card) for k, v in batch.items()})
    _, l_cpu = step(on_cpu, batch)
    assert abs(float(l_card) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu))
    card_leaves = weights.flatten_params(on_card.params)
    cpu_leaves = weights.flatten_params(on_cpu.params)
    for name, got in card_leaves.items():
        assert got.device.type == "cuda"
        d = (got.detach().cpu() - cpu_leaves[name].detach()).abs()
        assert float(d.max()) <= 2 * lr + 1e-5, name
        if kind == "infonce" and name.endswith("k.b"):
            continue  # an exact zero gradient: Adam normalizes noise
        assert float((d > 2e-6 + 1e-3 * lr).float().mean()) <= 1e-3, name
    for slot in on_card.opt_state.state.values():
        assert all(t.device.type == "cuda" for t in slot.values())


# -- graph offloads and the telemetry plane on the card ------------------------

def _kronecker(scale, seed):
    import chip_smoke

    s, d = chip_smoke.kronecker_edges(scale, 16, seed)
    return s.numpy(), d.numpy(), 1 << scale


@pytest.mark.parametrize("scale", [8, 12])
def test_pagerank_on_the_card_gives_the_cpu_ranks(card, scale):
    from nornicdb_tpu_torch.ops import graph_algos as ga

    src, dst, n = _kronecker(scale, seed=scale)
    got = ga.pagerank(src, dst, n)  # device=None: the card
    want = ga.pagerank(src, dst, n, device="cpu")
    # float32 atomics add in no fixed order: a tolerance, not equality
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("scale", [8, 12])
def test_wcc_on_the_card_gives_the_cpu_labels(card, scale):
    from nornicdb_tpu_torch.ops import graph_algos as ga

    src, dst, n = _kronecker(scale, seed=scale + 1)
    got = ga.connected_components(src, dst, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, ga.connected_components(src, dst, n, device="cpu"))


def test_batch_scores_on_the_card_gives_the_cpu_scores(card):
    from nornicdb_tpu_torch.linkpredict import batch_scores, build_graph
    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

    src, dst, n = _kronecker(9, seed=3)
    eng = MemoryEngine()
    for i in range(n):
        eng.create_node(Node(id=f"v{i}"))
    for e, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        eng.create_edge(Edge(id=f"e{e}", start_node=f"v{a}",
                             end_node=f"v{b}"))
    g = build_graph(eng)
    torch.backends.cuda.matmul.allow_tf32 = True  # a library user's setting
    try:
        for method in ("commonNeighbors", "jaccard", "adamicAdar",
                       "preferentialAttachment", "resourceAllocation"):
            got = batch_scores(g, method)
            want = batch_scores(g, method, use_device=False)
            if method in ("commonNeighbors", "preferentialAttachment"):
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        # the scoped precision was restored
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_hbm_gauge_of_a_card_corpus(card):
    from nornicdb_tpu_torch.ops import DeviceCorpus
    from nornicdb_tpu_torch.telemetry import deviceprof

    rng = np.random.default_rng(0)
    c = DeviceCorpus(64, quantize=True)
    c.add_batch([f"r{i}" for i in range(5000)], _unit(rng, 5000, 64))
    c.search(_unit(rng, 2, 64), k=5)
    own = DeviceCorpus._hbm_bytes(c)
    assert own["corpus_f32"] == (c._dev.numel() * c._dev.element_size()
                                 + c._dev_valid.numel()
                                 * c._dev_valid.element_size())
    assert own["corpus_int8"] == sum(t.numel() * t.element_size()
                                     for t in c._dev_i8)
    deviceprof.PROFILER.refresh_hbm()
    hbm = deviceprof.snapshot()["hbm_bytes"]
    assert own["corpus_f32"] <= hbm["corpus_f32"] <= torch.cuda.memory_allocated()


def test_profile_capture_holds_a_cuda_kernel(card):
    import io
    import json
    import tarfile
    import threading

    from nornicdb_tpu_torch.telemetry import deviceprof

    stop = threading.Event()
    x = torch.randn(512, 512, device=card)

    def launch():  # kernels from another thread than the capturing one
        while not stop.is_set():
            torch.mm(x, x)
            torch.cuda.synchronize()

    t = threading.Thread(target=launch)
    t.start()
    try:
        blob = deviceprof.capture_profile(0.5)
    finally:
        stop.set()
        t.join()
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        name = next(n for n in tar.getnames() if n.endswith(".json"))
        events = json.load(tar.extractfile(name))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels


def test_search_over_a_reopened_wal_chain_answers_as_before(card, tmp_path,
                                                           monkeypatch):
    """A SearchService on the card over the durable chain, then over the
    same directory reopened (its close-time snapshot, then a WAL replay of
    a copy made before the close): the same row order and the same ids and
    scores, bit for bit, through the bf16 kernel (forced at this size: the
    service streams from 65,536 rows)."""
    import shutil

    from nornicdb_tpu_torch.ops import similarity
    from nornicdb_tpu_torch.search import SearchConfig, SearchService
    from nornicdb_tpu_torch.storage import Edge, Node, open_storage

    monkeypatch.setattr(similarity, "STREAMING_MIN_ROWS", 1024)

    rng = np.random.default_rng(21)
    embs = _unit(rng, 3000, 96)
    d = str(tmp_path / "db")
    cfg = SearchConfig(write_behind=True, batching_enabled=True)

    def answers(storage):
        svc = SearchService(storage, config=cfg, device=card)
        svc.build_indexes()
        before = K.launch_counts()["streaming_topk_bf16"]
        out = (list(svc.corpus()._ids),
               [svc.vector_candidates(q, k=50) for q in embs[:40]])
        assert K.launch_counts()["streaming_topk_bf16"] > before
        svc.shutdown()
        return out

    st = open_storage(d)
    for i in range(len(embs)):
        st.create_node(Node(id=f"v{i}", properties={"content": f"doc {i}"},
                            embedding=embs[i]))
    for i in range(0, len(embs) - 1, 3):
        st.create_edge(Edge(id=f"e{i}", start_node=f"v{i}",
                            end_node=f"v{i + 1}"))
    for i in range(0, len(embs), 10):
        st.delete_node(f"v{i}")
    node = st.get_node("v1")
    node.embedding = embs[0]
    st.update_node(node)
    st.flush()
    want = answers(st)
    shutil.copytree(d, str(tmp_path / "crash"))
    st.close()
    for path in (d, str(tmp_path / "crash")):
        again = open_storage(path)
        try:
            assert answers(again) == want, path
        finally:
            again.close()


def test_pagerank_on_the_card_over_a_snapshot(card):
    """PageRank and WCC on the card over the adjacency snapshot's
    edge_arrays(), before and after mutations through the async chain,
    against the CPU path over the same arrays."""
    from nornicdb_tpu_torch.ops import graph_algos as ga
    from nornicdb_tpu_torch.storage import (
        Edge,
        Node,
        attach_snapshot,
        open_storage,
    )

    src, dst, n = _kronecker(11, seed=3)
    st = open_storage("")
    try:
        for i in range(n):
            st.create_node(Node(id=f"g{i}"))
        for k, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
            st.create_edge(Edge(id=f"e{k}", start_node=f"g{a}",
                                end_node=f"g{b}"))
        snap = attach_snapshot(st)
        assert snap.ensure()
        for step in range(2):
            if step:
                for k in range(0, len(src), 7):
                    st.delete_edge(f"e{k}")
                for k in range(500):
                    st.create_edge(Edge(id=f"m{k}", start_node=f"g{k}",
                                        end_node=f"g{(7 * k) % n}"))
            view = snap.edge_arrays()
            assert len(view.src) == st.edge_count()
            got = ga.pagerank(view.src, view.dst, len(view.ids))
            want = ga.pagerank(view.src, view.dst, len(view.ids),
                               device="cpu")
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
            np.testing.assert_array_equal(
                ga.connected_components(view.src, view.dst, len(view.ids)),
                ga.connected_components(view.src, view.dst, len(view.ids),
                                        device="cpu"))
    finally:
        st.close()
