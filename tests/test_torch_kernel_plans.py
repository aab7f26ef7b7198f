"""Host-side logic of the port's redesigned kernels, on the CPU.

- ``extract_topk.cu`` (a radix select): a numpy model of its selection
  rule, step by step as the kernel takes it (four 8-bit digit passes to the
  threshold, then ties taken by a prefix count over contiguous per-thread
  runs, then each pick ranked against the others or against the whole
  row; a pick of value INT32_MIN outputs bin 0, since the TPU kernel's
  INT32_MIN mask never removes such a bin), held bit for bit to
  ``kernels_ref.extract_topk`` on adversarial rows; and the shared-memory
  plan from B and k.
- ``fused_cosine.cu``: the tile and copy plan from (Q, D, corpus type,
  pointer alignment).
- ``streaming_topk_bf16.cu``: the launch plan (query block width, split,
  ring stages and shared memory, padded width) and the permuted K order
  of the rounded query buffer, against a numpy model of the wgmma pairing.
- ``ragged_paged_attention.cu``: the split over a cluster from the lanes'
  largest positions, the shared-memory plan and its cache.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from nornicdb_tpu_torch.ops import kernels as K
from nornicdb_tpu_torch.ops import kernels_ref as R

THREADS = 256  # extract_topk.cu THREADS
INT32_MIN = np.int32(-(2**31))


def _radix_select(row: np.ndarray, k: int, kpad: int, with_picks: bool = True
                  ) -> tuple[np.ndarray, np.ndarray]:
    """extract_topk.cu on one row of int32 bins, in numpy."""
    b = row.size
    u = row.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    prefix, kk = 0, k
    for p in range(4):
        shift = 24 - 8 * p
        high = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        match = (u & np.uint32(high)) == prefix
        hist = np.bincount((u[match] >> np.uint32(shift)) & 0xFF, minlength=256)
        higher = hist.sum() - np.cumsum(hist)  # keys in digits above each
        (d,) = np.nonzero((higher < kk) & (kk <= higher + hist))
        assert d.size == 1
        prefix |= int(d[0]) << shift
        kk -= int(higher[d[0]])
    thr, need = np.uint32(prefix), kk
    assert int((u > thr).sum()) == k - need and int((u == thr).sum()) >= need

    # contiguous runs, one a thread; one exclusive scan of the packed counts
    per = -(-b // THREADS)
    runs = [(min(t * per, b), min(t * per + per, b)) for t in range(THREADS)]
    packed = np.array([(int((u[lo:hi] > thr).sum()) << 16)
                       | int((u[lo:hi] == thr).sum()) for lo, hi in runs])
    before = np.concatenate([[0], np.cumsum(packed)[:-1]])
    picks = np.zeros(k, np.uint32)
    pick_idx = np.zeros(k, np.int64)
    out_v = np.full(kpad, INT32_MIN, np.int32)
    out_i = np.zeros(kpad, np.int32)
    for (lo, hi), bf in zip(runs, before):
        eq_seen = int(bf) & 0xFFFF
        slot = (int(bf) >> 16) + min(eq_seen, need)
        for i in range(lo, hi):
            if u[i] == thr:
                take, eq_seen = eq_seen < need, eq_seen + 1
            else:
                take = u[i] > thr
            if not take:
                continue
            if with_picks:
                picks[slot], pick_idx[slot] = u[i], i
                slot += 1
            else:
                rank = int((u[:i] >= u[i]).sum() + (u[i + 1:] > u[i]).sum())
                out_v[rank] = (u[i] ^ np.uint32(0x80000000)).view(np.int32)
                out_i[rank] = i if u[i] else 0
    if with_picks:
        for e in range(k):
            rank = int((picks[:e] >= picks[e]).sum() + (picks[e + 1:] > picks[e]).sum())
            out_v[rank] = (picks[e] ^ np.uint32(0x80000000)).view(np.int32)
            out_i[rank] = pick_idx[e] if picks[e] else 0
    return out_v, out_i


def adversarial_rows(case: str, q: int, b: int, rng) -> np.ndarray:
    """(q, b) int32 rows of one adversarial kind (``CASES``); the card's
    tests of the kernel take them too."""
    if case == "all_equal":
        return np.full((q, b), 0x4000_1234, np.int32)
    if case == "threshold_duplicates":  # many copies of the k-th value
        return rng.choice(np.array([7, 9, 9, 9, 11], np.int32), size=(q, b))
    if case == "few_distinct":
        return rng.integers(0, 50, size=(q, b)).astype(np.int32)
    if case == "masked":  # negative (masked) bins and INT32_MIN
        x = rng.integers(-(2**31), 2**31, size=(q, b), dtype=np.int64)
        x[:, ::3] = -(2**31)
        return x.astype(np.int32)
    if case == "few_valid":  # fewer valid (positive) bins than k
        x = np.full((q, b), -(2**31), np.int64)
        x[:, rng.choice(b, 5, replace=False)] = rng.integers(1, 2**31, 5)
        x[min(1, q - 1), :7] = -5
        return x.astype(np.int32)
    if case == "packed":  # bins as the streaming kernels pack them
        s = (rng.uniform(2.0, 4.0, (q, b)).astype(np.float32).view(np.int32)
             & ~np.int32(0x1FFF)) | rng.integers(0, 8192, (q, b)).astype(np.int32)
        return s
    if case == "sorted":  # the largest keys all in the first runs
        return np.sort(rng.integers(0, 1000, (q, b)), axis=1)[:, ::-1].astype(np.int32)
    raise ValueError(case)


CASES = ("all_equal", "threshold_duplicates", "few_distinct", "masked",
         "few_valid", "packed", "sorted")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,k", [(2048, 100), (1000, 1), (300, 300),
                                 (257, 130), (64, 17)])
def test_radix_select_model_equals_plain_extract(case, b, k):
    rng = np.random.default_rng(b + k)
    rows = adversarial_rows(case, 3, b, rng)
    kpad = -(-k // K.LANE) * K.LANE
    want_v, want_i = R.extract_topk(torch.from_numpy(rows), k, kpad)
    for r, row in enumerate(rows):
        got_v, got_i = _radix_select(row, k, kpad)
        np.testing.assert_array_equal(got_v, want_v[r].numpy())
        np.testing.assert_array_equal(got_i, want_i[r].numpy())


@pytest.mark.parametrize("case", ["threshold_duplicates", "masked", "sorted"])
def test_radix_select_model_ranking_against_the_row(case):
    """The route for picks that do not fit beside the row gives the same."""
    rng = np.random.default_rng(3)
    row = adversarial_rows(case, 3, 700, rng)[0]
    for k in (1, 90, 700):
        want = _radix_select(row, k, 768)
        got = _radix_select(row, k, 768, with_picks=False)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_extract_plan_from_b_and_k():
    # the serving shape: B = 2,048 bins, k = 100, the picks beside the row
    assert K._extract_plan(2048, 100) == (4 * (320 + 2048) + 8 * 100, True)
    assert K._extract_plan(2048, 2048) == (4 * (320 + 2048) + 8 * 2048, True)
    # the largest row fills a CTA's shared memory: picks ranked on the row
    top = K._EXTRACT_MAX_BINS
    assert K._extract_plan(top, 1) == (K._SMEM_LIMIT, False)
    assert K._extract_plan(top, top) == (K._SMEM_LIMIT, False)
    smem, picks = K._extract_plan(40_000, 10_000)
    assert not picks and smem == 4 * (320 + 40_000)
    assert K._extract_plan(40_000, 1_000)[1]
    assert top < 2**16  # the kernel packs two run counts into one word
    with pytest.raises(ValueError):
        K._extract_plan(top + 1, 1)
    for b in (1, 100, 2048, 30_000, top):
        for k in (1, b // 2 or 1, b):
            assert K._extract_plan(b, k)[0] <= K._SMEM_LIMIT


@pytest.mark.parametrize("q,tm", [(1, 1), (15, 1), (16, 1), (17, 2), (32, 2),
                                  (33, 4), (64, 4), (65, 8), (129, 8),
                                  (1024, 8)])
def test_cosine_plan_tile_from_q(q, tm):
    assert K._cosine_plan(q, 1024, torch.float32, 0, 256)[0] == tm


@pytest.mark.parametrize("dtype,d,width", [
    (torch.float32, 1024, 1024), (torch.float32, 100, 100),
    (torch.float32, 1, 4), (torch.float32, 3, 4), (torch.float32, 31, 32),
    (torch.float32, 33, 36), (torch.float32, 1030, 1032),
    (torch.bfloat16, 1024, 1024), (torch.bfloat16, 100, 104),
    (torch.float16, 7, 8), (torch.float16, 1030, 1032)])
def test_cosine_plan_width_from_d_and_type(dtype, d, width):
    tm, got, copy_q, copy_c = K._cosine_plan(16, d, dtype, 512, 1024)
    assert got == width and got % K._COSINE_WIDTH_STEP[dtype] == 0
    assert copy_q == copy_c == (width != d)


def test_cosine_plan_copies_an_unaligned_base():
    # c[1:] of a (N, 3) float32 corpus starts 12 bytes in; D = 4 keeps width
    assert K._cosine_plan(8, 4, torch.float32, 4096, 4096 + 16) == (1, 4, False, False)
    assert K._cosine_plan(8, 4, torch.float32, 4096, 4096 + 8) == (1, 4, False, True)
    assert K._cosine_plan(8, 4, torch.float32, 4100, 4096) == (1, 4, True, False)


def test_zero_padded_copy_keeps_scores():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    qp, cp = K._zero_padded(q, 8), K._zero_padded(c, 8)
    assert qp.shape == (5, 8) and bool((qp[:, 7] == 0).all())
    torch.testing.assert_close(R.fused_cosine_scores(qp, cp),
                               R.fused_cosine_scores(q, c), rtol=0, atol=1e-6)


# ------------------------------------------------ streaming_topk_bf16.cu
SERVING = dict(n_tiles=7813, rows=16, tile_n=128, sms=132)  # 1,000,064 rows


@pytest.mark.parametrize("q,nq,qblocks,cluster", [
    (1, 8, 1, 1), (7, 8, 1, 1), (16, 16, 1, 1), (17, 32, 1, 1),
    (100, 128, 1, 1), (129, 128, 2, 2), (300, 128, 3, 1), (1024, 128, 8, 2)])
def test_streaming_plan_query_block_from_q(q, nq, qblocks, cluster):
    plan = K._streaming_plan(q, 1024, torch.float32, 0, **SERVING)
    assert (plan.nq, plan.qblocks) == (nq, qblocks)
    assert plan.nq in K._STREAMING_NQ and plan.nq * plan.qblocks >= q
    assert 1 <= plan.splits <= -(-SERVING["n_tiles"] // SERVING["rows"])
    # pairs of query blocks share each corpus chunk where their number is even
    assert plan.cluster == cluster and plan.qblocks % plan.cluster == 0
    assert 2 <= plan.stages <= K._BF16_MAX_STAGES
    assert plan.smem <= K._SMEM_LIMIT
    assert plan.qbuf_values == qblocks * 16 * nq * 64


def test_streaming_plan_at_the_serving_shape():
    # Q = 1024: 8 query blocks x 16 bin rows = 128 CTAs, one an SM, no split
    big = K._streaming_plan(1024, 1024, torch.float32, 0, **SERVING)
    assert (big.splits, big.stages, big.cluster) == (1, 4, 2)
    assert big.smem == 1024 + 128 + 4 * (128 * 256 + 128 * 128)
    # Q = 16: 16 bin rows, each tile loop split 8 ways
    small = K._streaming_plan(16, 1024, torch.float32, 0, **SERVING)
    assert (small.splits, small.stages) == (8, 6)
    assert small.smem == 1024 + 128 + 6 * (128 * 256 + 16 * 128)
    assert not big.copy_c and not small.copy_c


@pytest.mark.parametrize("q", [1, 40, 300, 5000])
@pytest.mark.parametrize("n_tiles,rows", [(1, 1), (3, 3), (32, 16), (7813, 16)])
def test_streaming_plan_splits_within_the_tile_loop(q, n_tiles, rows):
    plan = K._streaming_plan(q, 128, torch.float32, 0, n_tiles, rows, 128, 132)
    assert 1 <= plan.splits <= -(-n_tiles // rows)
    ctas = plan.qblocks * rows * plan.splits
    assert plan.splits == 1 or ctas <= 132


@pytest.mark.parametrize("dtype,d,ptr,width,copy", [
    (torch.float32, 1024, 0, 1024, False), (torch.float32, 100, 0, 100, False),
    (torch.float32, 1030, 0, 1032, True), (torch.float32, 1, 0, 4, True),
    (torch.float32, 64, 4, 64, True), (torch.bfloat16, 128, 0, 128, False),
    (torch.bfloat16, 100, 0, 104, True), (torch.bfloat16, 128, 6, 128, True),
    (torch.float16, 7, 0, 8, True), (torch.float16, 1024, 16, 1024, False)])
def test_streaming_plan_padded_width(dtype, d, ptr, width, copy):
    plan = K._streaming_plan(40, d, dtype, 4096 + ptr, 32, 8, 128, 132)
    assert (plan.width, plan.copy_c) == (width, copy)
    assert plan.width * K._CORPUS_ESIZE[dtype] % 16 == 0


# ---------------------------------------------------- streaming_topk.cu
@pytest.mark.parametrize("q,nq,qblocks,cluster", [
    (1, 8, 1, 1), (8, 8, 1, 1), (16, 16, 1, 1), (17, 32, 1, 1),
    (32, 32, 1, 1), (300, 128, 3, 1), (1024, 128, 8, 2)])
def test_int8_plan_query_block_from_q(q, nq, qblocks, cluster):
    plan = K._int8_plan(q, 1024, 0, 0, **SERVING)
    assert (plan.nq, plan.qblocks) == (nq, qblocks)
    assert plan.nq in K._STREAMING_NQ and plan.nq * plan.qblocks >= q
    assert plan.nq < 2 * q or plan.nq == 8  # no wider than Q needs
    # pairs of query blocks share each corpus chunk where their number is even
    assert plan.cluster == cluster and plan.qblocks % plan.cluster == 0
    assert 1 <= plan.splits <= -(-SERVING["n_tiles"] // SERVING["rows"])
    assert plan.smem <= K._SMEM_LIMIT


def test_int8_plan_at_the_serving_shape():
    # Q = 1024: 8 query blocks x 16 bin rows = 128 CTAs, one an SM, no
    # split; each block's 128 x 1024 codes kept beside 6 corpus stages
    big = K._int8_plan(1024, 1024, 0, 0, **SERVING)
    assert (big.splits, big.stages, big.cluster, big.q_kept) == (1, 6, 2, True)
    assert big.smem == 1024 + 136 + 128 * 1024 + 6 * 128 * 128
    # Q = 16: one block of 16, each bin row's tile loop split 8 ways
    small = K._int8_plan(16, 1024, 0, 0, **SERVING)
    assert (small.splits, small.stages, small.q_kept) == (8, 8, True)
    assert small.smem == 1024 + 136 + 16 * 1024 + 8 * 128 * 128
    assert not (big.copy_q or big.copy_c or small.copy_q or small.copy_c)


@pytest.mark.parametrize("d,kept", [(128, True), (1024, True), (1408, True),
                                    (1409, False), (2048, False), (4096, False)])
def test_int8_plan_keeps_the_queries_where_they_fit(d, kept):
    """At 128 queries the block (128 x D bytes, D rounded up to 128-byte
    chunks) stays in shared memory up to D = 1,408 (11 chunks) beside a
    ring of at least 3 stages; wider, each stage carries its chunk of the
    block (and the ring takes at least 2)."""
    plan = K._int8_plan(1024, d, 0, 0, **SERVING)
    assert plan.nq == 128 and plan.q_kept == kept
    kchunks = -(-plan.width // K._I8_BK)
    qarea = (kchunks if kept else plan.stages) * plan.nq * K._I8_BK
    assert plan.smem == (K._I8_ALIGN + K._I8_BARRIER_BYTES
                         + plan.stages * K._I8_CCHUNK + qarea) <= K._SMEM_LIMIT
    assert plan.stages <= K._I8_MAX_STAGES
    assert plan.stages >= (K._I8_MIN_KEPT_STAGES if kept else 2)
    # a kept block that one more chunk would push out of shared memory
    if not kept:
        assert qarea < kchunks * plan.nq * K._I8_BK


@pytest.mark.parametrize("q", [1, 40, 300, 5000])
@pytest.mark.parametrize("n_tiles,rows", [(1, 1), (3, 3), (32, 16), (7813, 16)])
def test_int8_plan_splits_within_the_tile_loop(q, n_tiles, rows):
    plan = K._int8_plan(q, 128, 0, 0, n_tiles, rows, 128, 132)
    assert 1 <= plan.splits <= -(-n_tiles // rows)
    ctas = plan.qblocks * rows * plan.splits
    assert plan.splits == 1 or ctas <= 132
    assert plan.cluster == (2 if plan.qblocks % 2 == 0 else 1)


@pytest.mark.parametrize("d,q_off,c_off,width,copy_q,copy_c", [
    (1, 0, 0, 16, True, True), (100, 0, 0, 112, True, True),
    (130, 0, 0, 144, True, True), (1024, 0, 0, 1024, False, False),
    (1024, 1, 0, 1024, True, False), (1024, 0, 1, 1024, False, True),
    (128, 8, 8, 128, True, True), (128, 16, 32, 128, False, False)])
def test_int8_plan_padded_width(d, q_off, c_off, width, copy_q, copy_c):
    plan = K._int8_plan(40, d, 4096 + q_off, 8192 + c_off, 32, 8, 128, 132)
    assert (plan.width, plan.copy_q, plan.copy_c) == (width, copy_q, copy_c)
    assert plan.width % 16 == 0 and plan.width - d < 16


def test_int8_padded_copy_keeps_the_bins():
    """The zero columns of the padded copy add nothing to an s32 sum: the
    plain version's bins over the copies are the bins of the originals."""
    rng = np.random.default_rng(4)
    q_i8 = torch.from_numpy(rng.integers(-127, 128, (5, 100), dtype=np.int8))
    c_i8 = torch.from_numpy(rng.integers(-127, 128, (256, 100), dtype=np.int8))
    c_scale = torch.from_numpy(rng.uniform(50, 200, 256).astype(np.float32))
    valid = torch.from_numpy(rng.random(256) > 0.2)
    plain = R.streaming_bins_int8(q_i8, c_i8, c_scale, valid, 128, 2, 1)
    padded = R.streaming_bins_int8(K._zero_padded(q_i8, 112),
                                   K._zero_padded(c_i8, 112), c_scale, valid,
                                   128, 2, 1)
    assert torch.equal(plain, padded)


def _physical_k(wide: bool, ks: int, t4: int, i: int) -> int:
    """streaming_topk_bf16.cu physical_k: the value of a 64-deep chunk that
    thread t4's register a_i takes in step ks."""
    if wide:
        return 32 * (ks >> 1) + 4 * (2 * t4 + (ks & 1)) + i
    return 8 * (ks + 4 * (t4 >> 1)) + 4 * (t4 & 1) + i


@pytest.mark.parametrize("wide", [True, False])
def test_streaming_physical_k_is_a_permutation(wide):
    ks = [_physical_k(wide, s, t, i) for s in range(4) for t in range(4)
          for i in range(4)]
    assert sorted(ks) == list(range(64))
    # a quarter warp (float32, 16 bytes a thread) or half warp (16-bit, 8
    # bytes) reads 128 distinct bytes of the 128-byte-swizzled box rows
    for s in range(4):
        slots = set()
        for g in range(2 if wide else 4):
            for t in range(4):
                p = _physical_k(wide, s, t, 0) % (32 if wide else 64)
                piece, half = divmod(p * (4 if wide else 2), 16)
                slots.add(((piece ^ g) << 1 | half // 8) if not wide else piece ^ g)
        assert len(slots) == (8 if wide else 16)


def _rounded_query_layout(qs: np.ndarray, nq: int, wide: bool) -> np.ndarray:
    """round_queries_kernel's buffer in numpy (float32 values, no rounding):
    per (query block, 64-deep chunk), core matrices [k8][n8][8 rows][8],
    the K order of each 16-deep step that of physical_k."""
    q, d = qs.shape
    qblocks, kchunks = -(-q // nq), -(-d // 64)
    out = np.zeros(qblocks * kchunks * nq * 64, np.float32)
    groups = nq // 8
    for o in range(out.size):
        cidx, w = divmod(o, nq * 64)
        e, w = w % 8, w // 8
        nr, w = w % 8, w // 8
        ng, k8 = w % groups, w // groups
        n = (cidx // kchunks) * nq + ng * 8 + nr
        j = (k8 & 1) * 8 + e
        k = (cidx % kchunks) * 64 + _physical_k(
            wide, k8 >> 1, (j & 7) >> 1, 2 * (j >> 3) + (j & 1))
        if n < q and k < d:
            out[o] = qs[n, k]
    return out


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("q,d,nq", [(5, 64, 8), (16, 100, 16), (20, 130, 32)])
def test_streaming_query_layout_pairs_the_same_k(q, d, nq, wide):
    """The tensor cores pair register a_i of thread t4 (the corpus values
    physical_k names) with B's logical k 2*t4, 2*t4+1, 2*t4+8, 2*t4+9:
    summing those pairs over the buffer gives the plain product of every
    query with every corpus row."""
    rng = np.random.default_rng(q + d)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    rows = rng.standard_normal((3, d)).astype(np.float32)
    buf = _rounded_query_layout(qs, nq, wide)
    kchunks = -(-d // 64)
    padded = np.zeros((3, kchunks * 64), np.float32)
    padded[:, :d] = rows
    got = np.zeros((q, 3))
    groups = nq // 8
    logical = lambda t4: np.array([2 * t4, 2 * t4 + 1, 2 * t4 + 8, 2 * t4 + 9])
    for n in range(q):
        blk, nn = divmod(n, nq)
        for kc in range(kchunks):
            chunk = buf[(blk * kchunks + kc) * nq * 64:][:nq * 64]
            for ks in range(4):
                for t4 in range(4):
                    phys = kc * 64 + np.array(
                        [_physical_k(wide, ks, t4, i) for i in range(4)])
                    j = logical(t4)
                    k8 = 2 * ks + j // 8
                    b = chunk[((k8 * groups + nn // 8) * 8 + nn % 8) * 8 + j % 8]
                    got[n] += padded[:, phys] @ b
    np.testing.assert_allclose(got, qs @ rows.T, rtol=1e-5, atol=1e-5)


# --------------------------------------------- ragged_paged_attention.cu
@pytest.mark.parametrize("max_pos,split", [(-1, 0), (0, 1), (15, 1), (16, 2),
                                           (31, 2), (100, 7), (111, 7),
                                           (112, 8), (255, 8), (10_000, 8)])
def test_ragged_split_from_the_largest_position(max_pos, split):
    assert K._ragged_split(max_pos, 256) == split


@pytest.mark.parametrize("s_len,cluster", [(8, 1), (16, 1), (17, 2), (64, 4),
                                           (100, 7), (128, 8), (256, 8),
                                           (60_000, 8)])
def test_ragged_cluster_from_the_table(s_len, cluster):
    assert K._ragged_cluster(s_len) == cluster
    # a split never exceeds the cluster, and all-padding lanes take no CTA
    assert K._ragged_split(s_len - 1, s_len) == cluster
    assert K._ragged_split(-1, s_len) == 0


def _ragged_layout_bytes(qb, n_rep, dh, s_len, esize):
    """ragged_paged_attention.cu's shared memory, region by region."""
    cluster = min(8, max(1, -(-s_len // 16)))
    span = max(16, -(-s_len // cluster))
    rmax = qb * n_rep
    regions = {
        "kv_ring": 2 * 64 * (dh + 16 // esize) * esize,
        "queries": rmax * dh * 4,
        "partial_sums": rmax * dh * 4,
        "scores": rmax * span * 4,
        "maxima": rmax * 4,
        "sums": rmax * 4,
        "positions": qb * 4,
    }
    return sum(regions.values())


@pytest.mark.parametrize("dtype,esize", [(torch.bfloat16, 2), (torch.float32, 4)])
@pytest.mark.parametrize("qb,n_rep,dh,s_len", [(4, 7, 64, 256), (1, 7, 64, 4096),
                                               (2, 2, 16, 48), (4, 1, 128, 16)])
def test_ragged_smem_is_the_kernel_layout(dtype, esize, qb, n_rep, dh, s_len):
    assert K._ragged_smem(qb, n_rep, dh, s_len, dtype) == _ragged_layout_bytes(
        qb, n_rep, dh, s_len, esize)


def widest_ragged_table(dtype, h=14, hkv=2, dh=64, ps=16) -> int:
    """The most pages a lane's table may hold at one query row a cluster
    before a CTA's share of the scores exceeds its shared memory."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if K._ragged_smem(1, h // hkv, dh, mid * ps, dtype) <= K._SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_plan_within_a_cta_and_cached(dtype):
    # the generation path's shapes: decode block and chunk block
    dec = K._ragged_plan(10, 1, 14, 2, 64, 129, 16, 16, dtype)
    chk = K._ragged_plan(1, 64, 14, 2, 64, 129, 16, 16, dtype)
    assert (dec.qb, dec.cluster, chk.qb, chk.cluster) == (1, 8, 2, 8)
    assert dec.smem == _ragged_layout_bytes(1, 7, 64, 256, 4 if dtype == torch.float32 else 2)
    assert K._ragged_plan(10, 1, 14, 2, 64, 129, 16, 16, dtype) is dec
    assert list(dec.params) == [10, 1, 14, 2, 64, 129, 16, 16, 1, K._ATTN_DTYPES[dtype]]
    assert dec.scale == 0.125
    p = widest_ragged_table(dtype)
    top = K._ragged_plan(9, 1, 14, 2, 64, 100, 16, p, dtype)
    assert top.smem <= K._SMEM_LIMIT < K._ragged_smem(1, 7, 64, (p + 1) * 16, dtype)
    with pytest.raises(ValueError):
        K._ragged_plan(9, 1, 14, 2, 64, 100, 16, p + 1, dtype)
    # a wide table halves the rows a cluster before it refuses
    half = K._ragged_plan(1, 64, 14, 2, 64, 100, 16, p // 2, dtype)
    assert half.qb == 1 and K._ragged_smem(2, 7, 64, p // 2 * 16, dtype) > K._SMEM_LIMIT // 2
