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
