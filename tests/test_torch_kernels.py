"""The port's kernel wrappers (plain PyTorch versions on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the same inputs.

Inputs are made with numpy from fixed seeds and handed to both sides.
Tolerances:
- int8 streaming top-k (#3): the same codes and the same decoded ids;
  biased scores within 1 ulp (XLA on the CPU may contract the dequant
  multiply and the bias add into one FMA, the port rounds them
  separately), so decoded values within one packed-bin step of that ulp
  plus the rounding of the division by the query scale.
- bf16 streaming top-k (#2): values within 2**(tile_bits - 21) + 1e-5 (one
  step of the packed bins' truncated mantissa, plus the f32 sum order); an
  id may differ only where the two swapped ids' scores are that close.
- bin extraction (#4), decode, tile/row helpers, merge: identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import pallas_kernels as P
from nornicdb_tpu.ops import similarity as JS
from nornicdb_tpu.ops.host_search import quantize_rows_np
from nornicdb_tpu_torch.ops import kernels as K
from nornicdb_tpu_torch.ops import kernels_ref as R
from nornicdb_tpu_torch.ops import similarity as TS

Q, D = 8, 64


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(n, seed):
    rng = np.random.default_rng(seed)
    qs, c = _unit(rng, Q), _unit(rng, n)
    valid = rng.random(n) > 0.15  # masked rows (tombstones / padding)
    return qs, c, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


GEOMETRIES = [
    (n, tile, rows, k)
    for n in (1024, 4096)
    for tile, rows in ((128, 4), (512, 8))
    for k in (5, 100)
]


class TestStreamingBf16:
    @pytest.mark.parametrize("n,tile,rows,k", GEOMETRIES)
    def test_matches_jax_kernel(self, n, tile, rows, k):
        qs, c, valid = _case(n, seed=n + tile + k)
        vj, ij = P.streaming_cosine_topk(
            jnp.asarray(qs), jnp.asarray(c), jnp.asarray(valid), k,
            tile_n=tile, rows=rows, interpret=True)
        vt, it = K.streaming_cosine_topk(
            _t(qs), _t(c), _t(valid), k, tile_n=tile, rows=rows)
        vj, ij = np.asarray(vj), np.asarray(ij)
        vt, it = vt.numpy(), it.numpy()
        _, _, tile_bits = K.streaming_geometry(n, tile, rows)
        tol = 2.0 ** (tile_bits - 21) + 1e-5
        assert vt.shape == vj.shape == (Q, k)
        assert np.max(np.abs(vt - vj)) <= tol
        assert valid[it].all(), "masked rows leaked"
        scores = np.asarray(JS.dot_scores(jnp.asarray(qs), jnp.asarray(c)))
        rr, jj = np.nonzero(it != ij)
        gap = np.abs(scores[rr, it[rr, jj]] - scores[rr, ij[rr, jj]])
        assert (gap <= tol).all(), gap

    @pytest.mark.parametrize("dtype,d", [
        (torch.bfloat16, D), (torch.float16, D), (torch.float32, 50),
        (torch.bfloat16, 50)])
    def test_any_float_corpus_and_width_matches_jax(self, dtype, d):
        """A 16-bit corpus, or a width that is no multiple of 4, streams
        through the same kernel (tolerance as above). The JAX kernel gets
        the same rounded values as float32: its bf16 cast of them is exact."""
        rng = np.random.default_rng(11)
        n, tile, rows, k = 1024, 128, 4, 10
        qs = _unit(rng, Q, d)
        ct = _t(_unit(rng, n, d)).to(dtype)
        valid = rng.random(n) > 0.15
        vj, ij = P.streaming_cosine_topk(
            jnp.asarray(qs), jnp.asarray(ct.float().numpy()),
            jnp.asarray(valid), k, tile_n=tile, rows=rows, interpret=True)
        vt, it = K.streaming_cosine_topk(_t(qs), ct, _t(valid), k,
                                         tile_n=tile, rows=rows)
        _, _, tile_bits = K.streaming_geometry(n, tile, rows)
        tol = 2.0 ** (tile_bits - 21) + 1e-5
        assert np.max(np.abs(vt.numpy() - np.asarray(vj))) <= tol
        assert valid[it.numpy()].all(), "masked rows leaked"

    def test_exact_when_bins_cover_corpus(self):
        qs, c, valid = _case(1024, seed=7)
        valid[:] = True
        k = 16
        _, it = K.streaming_cosine_topk(_t(qs), _t(c), _t(valid), k,
                                        tile_n=128, rows=8)
        gt = np.argsort(-(qs @ c.T), axis=1)[:, :k]
        assert (np.sort(it.numpy(), axis=1) == np.sort(gt, axis=1)).all()

    def test_bins_match_running_max_of_packed_scores(self):
        """The plain version's fold equals a direct max over the packed
        scores of every tile that maps to a bin row."""
        qs, c, valid = _case(1024, seed=3)
        tile, rows = 128, 3
        n_tiles, rows, tile_bits = K.streaming_geometry(1024, tile, rows)
        bins = K.streaming_bins(_t(qs), _t(c), _t(valid), tile, rows)
        qb = _t(qs).bfloat16().float()
        cb = _t(c).bfloat16().float()
        biased = qb @ cb.T + torch.where(_t(valid), 3.0, -3.0)
        packed = (biased.view(torch.int32) & -(1 << tile_bits)).reshape(
            Q, n_tiles, tile) | torch.arange(n_tiles, dtype=torch.int32)[:, None]
        for r in range(rows):
            want = packed[:, r::rows].max(dim=1).values
            assert torch.equal(bins[r], want)


class TestStreamingInt8:
    @pytest.mark.parametrize("n,tile,rows,k", GEOMETRIES)
    def test_matches_jax_kernel(self, n, tile, rows, k):
        qs, c, valid = _case(n, seed=2 * n + tile + k)
        qj, qsj = P.quantize_rows(jnp.asarray(qs))
        cj, csj = P.quantize_rows(jnp.asarray(c))
        qt, qst = K.quantize_rows(_t(qs))
        ct, cst = K.quantize_rows(_t(c))
        assert np.array_equal(qt.numpy(), np.asarray(qj))
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        vj, ij = P.streaming_cosine_topk_int8(
            qj, qsj, cj, csj, jnp.asarray(valid), k, tile_n=tile, rows=rows,
            interpret=True)
        vt, it = K.streaming_cosine_topk_int8(
            qt, qst, ct, cst, _t(valid), k, tile_n=tile, rows=rows)
        vj, vt = np.asarray(vj), vt.numpy()
        assert np.array_equal(it.numpy(), np.asarray(ij))
        assert valid[it.numpy()].all()
        fin = np.isfinite(vj)
        assert np.array_equal(fin, np.isfinite(vt))
        # a 1-ulp difference in a biased score can move its truncated bin
        # value by one packed step (2**tile_bits ulps of the biased score);
        # the division by the query scale rounds once more
        _, _, tile_bits = K.streaming_geometry(n, tile, rows)
        qsc = np.broadcast_to(qst.numpy()[:, None], vj.shape)[fin]
        biased = np.abs(vj[fin] * qsc).astype(np.float32) + np.float32(3)
        tol = (np.spacing(biased) * 2.0**tile_bits / qsc
               + 2 * np.spacing(np.abs(vj[fin])))
        assert (np.abs(vt[fin] - vj[fin]) <= tol).all()

    def test_quantize_codes_equal_numpy_and_jax(self):
        rng = np.random.default_rng(11)
        x = _unit(rng, 257)
        x[3] = 0.0  # zero row: scale clamps at 1e-9
        x[5, :4] = [0.5, -0.5, 1.5 / 127, -2.5 / 127]  # .5 ties round to even
        codes_np, s_np = quantize_rows_np(x)
        codes_t, s_t = K.quantize_rows(_t(x))
        codes_j, s_j = P.quantize_rows(jnp.asarray(x))
        assert np.array_equal(codes_t.numpy(), codes_np)
        assert np.array_equal(codes_t.numpy(), np.asarray(codes_j))
        assert np.allclose(s_t.numpy(), np.asarray(s_j), rtol=2**-23, atol=0)
        assert np.allclose(s_t.numpy(), s_np, rtol=2**-23, atol=0)


class TestExtractEpilogue:
    @pytest.mark.parametrize("k", [1, 5, 100, 129])
    def test_pallas_equals_sort_and_jax(self, k):
        rng = np.random.default_rng(k)
        # few distinct values: heavy ties, broken by the lowest bin id
        flat = rng.integers(-40, 40, size=(Q, 512)).astype(np.int32)
        flat[0, :] = 7  # a row of nothing but ties
        pv, pi = K._topk_bins(_t(flat), k, epilogue="pallas")
        sv, si = K._topk_bins(_t(flat), k, epilogue="sort")
        av, ai = K._topk_bins(_t(flat), k, epilogue="approx")
        assert torch.equal(pv, sv) and torch.equal(pi, si)
        assert torch.equal(av, sv) and torch.equal(ai, si)
        jv, ji = P._topk_bins(jnp.asarray(flat), k, epilogue="pallas",
                              interpret=True)
        assert np.array_equal(pv.numpy(), np.asarray(jv))
        assert np.array_equal(pi.numpy(), np.asarray(ji))
        jv, ji = P._topk_bins(jnp.asarray(flat), k, epilogue="sort",
                              interpret=True)
        assert np.array_equal(sv.numpy(), np.asarray(jv))
        assert np.array_equal(si.numpy(), np.asarray(ji))

    def test_extract_pads_to_lane(self):
        flat = _t(np.arange(300, dtype=np.int32)[None, :].repeat(2, 0))
        v, i = K._extract_topk(flat, 3, 128)
        assert v.shape == i.shape == (2, 128)
        assert v[0, :3].tolist() == [299, 298, 297]
        assert (v[:, 3:] == K.INT32_MIN).all() and (i[:, 3:] == 0).all()
        with pytest.raises(ValueError):
            K._extract_topk(flat, 129, 128)
        with pytest.raises(TypeError):
            K._extract_topk(flat.float(), 3, 128)
        with pytest.raises(ValueError):
            K._topk_bins(flat, 3, epilogue="radix")

    def test_plain_extract_matches_reference_loop(self):
        rng = np.random.default_rng(5)
        flat = rng.integers(0, 6, size=(3, 64)).astype(np.int32)
        v, i = R.extract_topk(_t(flat), 10, 128)
        for r in range(3):
            row = flat[r].astype(np.int64)
            for j in range(10):
                b = int(np.argmax(row))  # numpy argmax: first occurrence
                assert (v[r, j], i[r, j]) == (flat[r, b], b)
                row[b] = np.iinfo(np.int64).min


class TestDecode:
    @pytest.mark.parametrize("epilogue", ["sort", "pallas"])
    def test_decode_matches_jax(self, epilogue):
        qs, c, valid = _case(4096, seed=9)
        n_tiles, rows, tile_bits = K.streaming_geometry(4096, 256, 4)
        bins = K.streaming_bins(_t(qs), _t(c), _t(valid), 256, rows)
        # a few masked (negative) bins too
        bins[0, 0, :7] = K.INT32_MIN + torch.arange(7, dtype=torch.int32)
        dec = dict(k=40, n=4096, rows=rows, tile_n=256, tile_bits=tile_bits)
        vt, it = K._decode_packed(bins, epilogue=epilogue, **dec)
        vj, ij = P._decode_packed(jnp.asarray(bins.numpy()), epilogue=epilogue,
                                  interpret=True, **dec)
        assert np.array_equal(vt.numpy(), np.asarray(vj))
        assert np.array_equal(it.numpy(), np.asarray(ij))


class TestHelpers:
    @pytest.mark.parametrize("n", [128, 384, 1024, 4096, 1_000_064,
                                   1024 * 1024, 640, 65_536])
    @pytest.mark.parametrize("preferred", [1024, 512])
    def test_pick_tile_n(self, n, preferred):
        assert K.pick_tile_n(n, preferred) == P.pick_tile_n(n, preferred)

    @pytest.mark.parametrize("k", [1, 10, 100, 1000])
    @pytest.mark.parametrize("tile", [128, 512, 1024])
    def test_streaming_rows_for(self, k, tile):
        assert K.streaming_rows_for(k, tile) == P.streaming_rows_for(k, tile)

    def test_serving_geometry(self):
        """The headline corpus: 1M rows ingested by add_batch pad to
        1,000,064 -> tile 128, 16 bin rows, 2048 bins, 13 tile bits."""
        tile = K.pick_tile_n(1_000_064)
        rows = K.streaming_rows_for(100, tile)
        assert (tile, rows) == (128, 16)
        assert K.streaming_geometry(1_000_064, tile, rows) == (7813, 16, 13)
        with pytest.raises(ValueError):
            K.streaming_geometry(1000, 128, 4)

    def test_topk_lowest_index_matches_lax_top_k(self):
        rng = np.random.default_rng(4)
        x = rng.integers(-3, 3, size=(5, 300)).astype(np.float32) / 2
        x[:, ::17] = -np.inf
        x[1, :] = -np.inf
        x[2, 5] = -0.0
        vj, ij = jax.lax.top_k(jnp.asarray(x), 40)
        vt, it = K.topk_lowest_index(_t(x), 40)
        assert np.array_equal(vt.numpy(), np.asarray(vj))
        assert np.array_equal(it.numpy(), np.asarray(ij))


class TestMergeTopk:
    def test_sentinel_and_ties_match_jax(self):
        vals = np.array([
            [[0.9, 0.5, -np.inf], [0.4, 0.4, 0.1]],
            [[0.9, 0.3, 0.2], [0.4, -np.inf, -np.inf]],
            [[-np.inf, -np.inf, -np.inf], [0.4, 0.0, -np.inf]],
        ], np.float32)  # (S=3, Q=2, k=3)
        idx = np.array([
            [[10, 11, 99], [20, 21, 22]],
            [[30, 31, 32], [40, 98, 97]],
            [[96, 95, 94], [50, 51, 93]],
        ], np.int32)
        for k in (3, 5, 9):
            vj, ij = JS.merge_topk(jnp.asarray(vals), jnp.asarray(idx), k)
            vt, it = TS.merge_topk(_t(vals), _t(idx), k)
            assert np.array_equal(vt.numpy(), np.asarray(vj))
            assert np.array_equal(it.numpy(), np.asarray(ij))
        _, it = TS.merge_topk(_t(vals), _t(idx), 9)
        assert (it.numpy()[0, 5:] == -1).all()  # -inf slots -> sentinel
