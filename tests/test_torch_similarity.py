"""The port's similarity ops and device corpus (on the CPU) against the JAX
package's, fed the same inputs and the same sequence of writes.

Inputs are made with numpy from fixed seeds. Tolerances:
- exact search: identical ids in identical order (ties to the lowest slot,
  as lax.top_k), scores within 1e-5 (the f32 sums of the bf16 products run
  in another order in XLA and in PyTorch);
- streaming search: the bf16 streaming kernel's tolerance,
  2**(tile_bits - 21) + 1e-5, and ids may differ only between scores
  closer than that;
- score_subset: 1e-5; dense ops: 1e-5 (f32) / 1e-5 (bf16 products, which
  are exact in f32 on both sides);
- sync accounting: identical counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import similarity as JS
from nornicdb_tpu_torch.convert import corpus_from_jax_state
from nornicdb_tpu_torch.ops import kernels as K
from nornicdb_tpu_torch.ops import similarity as TS

DIMS = 32


def _vecs(rng, n, d=DIMS):
    return rng.standard_normal((n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _pair(**kw):
    return JS.DeviceCorpus(dims=DIMS, **kw), TS.DeviceCorpus(
        dims=DIMS, device="cpu", **kw)


def _same_exact(jc, tc, queries, k):
    rj = jc.search(queries, k=k, exact=True)
    rt = tc.search(queries, k=k, exact=True)
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert [i for i, _ in a] == [i for i, _ in b]
        assert np.allclose([s for _, s in a], [s for _, s in b], atol=1e-5)
    return rt


class TestDenseOps:
    def test_scores_match(self):
        rng = np.random.default_rng(0)
        q, c = _vecs(rng, 5), _vecs(rng, 300)
        for bf16 in (True, False):
            a = np.asarray(JS.dot_scores(jnp.asarray(q), jnp.asarray(c), bf16))
            b = TS.dot_scores(_t(q), _t(c), bf16).numpy()
            assert np.allclose(a, b, atol=1e-5, rtol=1e-5)
            a = np.asarray(JS.cosine_scores(jnp.asarray(q), jnp.asarray(c),
                                            bf16))
            b = TS.cosine_scores(_t(q), _t(c), bf16).numpy()
            assert np.allclose(a, b, atol=1e-5)
        a = np.asarray(JS.euclidean_scores(jnp.asarray(q), jnp.asarray(c)))
        b = TS.euclidean_scores(_t(q), _t(c)).numpy()
        assert np.allclose(a, b, atol=1e-4, rtol=1e-5)
        a = np.asarray(JS.l2_normalize(jnp.asarray(c)))
        assert np.allclose(a, TS.l2_normalize(_t(c)).numpy(), atol=1e-7)

    @pytest.mark.parametrize("k", [1, 10, 64])
    def test_cosine_topk_exact_and_masked(self, k):
        rng = np.random.default_rng(k)
        q = np.asarray(JS.l2_normalize(jnp.asarray(_vecs(rng, 4))))
        c = np.array(JS.l2_normalize(jnp.asarray(_vecs(rng, 256))))
        c[40:50] = c[7]  # duplicate rows: exact score ties
        valid = rng.random(256) > 0.2
        vj, ij = JS.cosine_topk(jnp.asarray(q), jnp.asarray(c),
                                jnp.asarray(valid), k, exact=True)
        vt, it = TS.cosine_topk(_t(q), _t(c), _t(valid), k, exact=True)
        assert np.array_equal(np.asarray(ij), it.numpy())
        assert np.allclose(np.asarray(vj), vt.numpy(), atol=1e-5)
        s, top = TS.masked_dot_topk(_t(q[0]), _t(c), _t(valid), k)
        sj, topj = JS.masked_dot_topk(jnp.asarray(q[0]), jnp.asarray(c),
                                      jnp.asarray(valid), k)
        assert np.allclose(np.asarray(sj), s.numpy(), atol=1e-5)
        assert np.allclose(np.asarray(topj), top.numpy(), atol=1e-5)

    def test_topk_backend_int8_fallback_recall(self):
        """Below the streaming size the int8-resident corpus is scored by a
        bf16 product of the codes (exact top-k here, approx_max_k in JAX):
        both keep the true top-1 and >= 0.9 recall."""
        rng = np.random.default_rng(5)
        c = np.asarray(JS.l2_normalize(jnp.asarray(_vecs(rng, 512))))
        q = c[:6] + 0.01 * _vecs(rng, 6)
        q = np.asarray(JS.l2_normalize(jnp.asarray(q)))
        valid = np.ones(512, bool)
        ci, cs = K.quantize_rows(_t(c))
        vt, it = TS.topk_backend_int8(_t(q), ci, cs, _t(valid), 10)
        gt = np.argsort(-(q @ c.T), axis=1)[:, :10]
        assert (it.numpy()[:, 0] == np.arange(6)).all()
        rec = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(it.numpy(), gt)])
        assert rec >= 0.9
        vs, is_ = TS.topk_backend_int8(_t(q), ci, cs, _t(valid), 10,
                                       streaming=True)
        assert (is_.numpy()[:, 0] == np.arange(6)).all()

    def test_topk_backend_routes(self):
        """On the CPU the default never streams; streaming=True forces the
        plain version of the streaming kernel; exact wins over streaming."""
        rng = np.random.default_rng(2)
        c = np.asarray(JS.l2_normalize(jnp.asarray(_vecs(rng, 1024))))
        q = c[:3]
        valid = _t(np.ones(1024, bool))
        K.reset_launch_counts()
        v1, i1 = TS.topk_backend(_t(q), _t(c), valid, 5)
        v2, i2 = TS.topk_backend(_t(q), _t(c), valid, 5, streaming=True)
        v3, i3 = TS.topk_backend(_t(q), _t(c), valid, 5, streaming=True,
                                 exact=True)
        assert (i1[:, 0] == torch.arange(3)).all()
        assert torch.equal(i1, i3)
        assert (i2[:, 0] == torch.arange(3)).all()
        # the CPU runs plain versions: no kernel launch is counted
        assert K.launch_counts() == {n: 0 for n in K.launch_counts()}

    @pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                         (torch.float32, 50)])
    def test_topk_backend_streams_any_float_corpus(self, dtype, d):
        """Only the JAX package's shape rule keeps a search off the
        streaming kernel: a bf16 corpus, or any width, streams."""
        rng = np.random.default_rng(4)
        c = _t(np.asarray(JS.l2_normalize(jnp.asarray(_vecs(rng, 1024, d))))
               ).to(dtype)
        q, valid = c[:3].float(), _t(np.ones(1024, bool))
        tile = K.pick_tile_n(1024)
        rows = min(K.streaming_rows_for(5, tile), 1024 // tile)
        want = K.streaming_cosine_topk(q, c, valid, 5, tile_n=tile, rows=rows)
        got = TS.topk_backend(q, c, valid, 5, streaming=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (got[1][:, 0] == torch.arange(3)).all()


class TestCorpusParity:
    def test_write_sequence_matches_jax(self):
        rng = np.random.default_rng(1)
        jc, tc = _pair()
        base = _vecs(rng, 100)
        ids = [f"n{i}" for i in range(100)]
        for c in (jc, tc):
            c.add_batch(ids, base)
        queries = base[[3, 50, 99]] + 0.05 * _vecs(rng, 3)
        _same_exact(jc, tc, queries, 10)
        # single adds, overwrite, grow past the 128-row capacity
        extra = _vecs(rng, 60)
        for i in range(60):
            for c in (jc, tc):
                c.add(f"x{i}", extra[i])
        for c in (jc, tc):
            c.add("n3", extra[0])  # overwrite in place
        assert jc.capacity == tc.capacity == 256
        _same_exact(jc, tc, queries, 20)
        # removals, then enough to trigger a deferred compaction
        for i in range(0, 100, 2):
            assert jc.remove(f"n{i}") == tc.remove(f"n{i}") is True
        assert jc.remove("missing") is tc.remove("missing") is False
        res = _same_exact(jc, tc, queries, 30)
        assert not {i for r in res for i, _ in r} & {f"n{i}"
                                                    for i in range(0, 100, 2)}
        assert jc.stats()["tombstones"] == tc.stats()["tombstones"] == 0
        # duplicate-id batch takes the per-row path
        for c in (jc, tc):
            c.add_batch(["n1", "y0", "y0"], _vecs(np.random.default_rng(9), 3))
        _same_exact(jc, tc, queries, 30)
        assert len(jc) == len(tc)
        for key in ("count", "capacity", "tombstones", "epoch"):
            assert jc.stats()[key] == tc.stats()[key], key
        for id_ in ("n1", "y0", "x5", "n2"):
            a, b = jc.get(id_), tc.get(id_)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.allclose(a, b, atol=1e-7)
        # clear resets the slot space
        for c in (jc, tc):
            c.clear()
            assert c.search(queries, k=5) == [[], [], []]
            c.add_batch(["z0", "z1"], _vecs(np.random.default_rng(4), 2))
        _same_exact(jc, tc, queries, 5)

    def test_sync_accounting_matches_jax(self):
        rng = np.random.default_rng(3)
        jc, tc = _pair()
        vecs = _vecs(rng, 1000)
        ids = [f"v{i}" for i in range(1000)]
        q = vecs[:2]
        for c in (jc, tc):
            c.add_batch(ids, vecs)
            c.search(q, k=3)  # first sync: full upload
            c.add("v5", vecs[6])  # block 0
            c.remove("v700")  # block 5
            c.add("v260", vecs[1])  # block 2: merges with block 0 run
            c.search(q, k=3)  # one patch pass
            for i in range(0, 1000, 50):
                c.add(f"v{i}", vecs[i + 1])
            c.search(q, k=3)  # most blocks dirty: full upload
            c.search(q, k=3)  # clean: no sync
        keys = ("patches", "full_uploads", "bytes_uploaded", "patch_bytes",
                "rows_patched", "device_dispatches")
        sj, st = jc.sync_stats.as_dict(), tc.sync_stats.as_dict()
        assert {k: sj[k] for k in keys} == {k: st[k] for k in keys}
        assert st["patches"] == 1 and st["full_uploads"] == 2
        _same_exact(jc, tc, q, 10)

    @pytest.mark.parametrize("blocks,cap", [
        ([0], 8), ([0, 1, 2], 8), ([0, 3, 7], 8), ([1, 5, 9, 30], 32),
        ([6, 7], 8), ([2, 9, 10, 11, 12, 13], 16),
    ])
    def test_coalesce_runs(self, blocks, cap):
        assert TS._coalesce_runs(blocks, cap) == JS._coalesce_runs(blocks, cap)

    def test_patch_while_borrowed_keeps_snapshot(self):
        """A patch that lands while a search borrows the buffer writes a
        new buffer; with no borrower it patches the resident one in place
        (the JAX package's donation)."""
        rng = np.random.default_rng(6)
        # 8 blocks of 128 rows: one dirty block is a patch, not a full upload
        tc = TS.DeviceCorpus(dims=DIMS, device="cpu", capacity=1024)
        tc.add_batch([f"a{i}" for i in range(10)], _vecs(rng, 10))
        with tc._borrow_device() as (dev, _, _, _, _):
            before = dev.clone()
            tc.add("a1", _vecs(rng, 1)[0])
            tc._sync()
            assert torch.equal(dev, before)  # the borrower's snapshot
            assert tc._dev is not dev
        held = tc._dev
        tc.add("a2", _vecs(rng, 1)[0])
        tc._sync()
        assert tc._dev is held  # in place: nobody borrowed it
        assert np.allclose(held[2].numpy(), tc.get("a2"))
        tc.device_arrays()  # leaks a reference: no more in-place patches
        tc.add("a3", _vecs(rng, 1)[0])
        tc._sync()
        assert tc._dev is not held

    def test_quantized_corpus_patches_int8_mirror(self):
        rng = np.random.default_rng(8)
        tc = TS.DeviceCorpus(dims=DIMS, device="cpu", quantize=True)
        vecs = _vecs(rng, 300)
        tc.add_batch([f"q{i}" for i in range(300)], vecs)
        tc.search(vecs[:1], k=3)
        tc.add("q10", vecs[20])
        res = tc.search(vecs[20:21], k=2, streaming=True)
        assert {i for i, _ in res[0]} == {"q10", "q20"}
        i8, s = tc._dev_i8
        full_i8, full_s = K.quantize_rows(tc._dev)
        assert torch.equal(i8, full_i8) and torch.equal(s, full_s)


class TestStreamingSearch:
    def test_streaming_search_matches_jax(self):
        rng = np.random.default_rng(12)
        jc, tc = _pair()
        vecs = _vecs(rng, 2000)
        for c in (jc, tc):
            c.add_batch([f"s{i}" for i in range(2000)], vecs)
            for i in range(0, 2000, 13):
                c.remove(f"s{i}")
        q = vecs[[1, 500, 1999]] + 0.1 * _vecs(rng, 3)
        k = 25
        rj = jc.search(q, k=k, streaming=True)
        rt = tc.search(q, k=k, streaming=True)
        n = tc.capacity
        tile = K.pick_tile_n(n)
        rows = min(K.streaming_rows_for(k, tile), n // tile)
        _, _, tile_bits = K.streaming_geometry(n, tile, rows)
        tol = 2.0 ** (tile_bits - 21) + 1e-5
        exact = [dict(r) for r in tc.search(q, k=n, exact=True)]
        for a, b, ex in zip(rj, rt, exact):
            assert len(a) == len(b) == k
            for (ia, sa), (ib, sb) in zip(a, b):
                assert abs(sa - sb) <= tol
                if ia != ib:
                    assert abs(ex[ia] - ex[ib]) <= tol
            # the top-1 agrees with the exact scan
            assert b[0][0] == max(ex, key=ex.get)
        # no tombstone leaks
        removed = {f"s{i}" for i in range(0, 2000, 13)}
        assert not {i for r in rt for i, _ in r} & removed

    def test_score_subset_matches_jax(self):
        rng = np.random.default_rng(13)
        jc, tc = _pair()
        vecs = _vecs(rng, 50)
        for c in (jc, tc):
            c.add_batch([f"u{i}" for i in range(50)], vecs)
            c.remove("u3")
        want = ["u1", "u3", "nope", "u49", "u0"]
        a = jc.score_subset(vecs[1], want)
        b = tc.score_subset(vecs[1], want)
        assert [i for i, _ in a] == [i for i, _ in b] == ["u1", "u49", "u0"]
        assert np.allclose([s for _, s in a], [s for _, s in b], atol=1e-5)
        assert tc.score_subset(vecs[1], ["nope"]) == []


class TestStateTransfer:
    def test_corpus_from_jax_state_keeps_slot_layout(self):
        rng = np.random.default_rng(14)
        jc = JS.DeviceCorpus(dims=DIMS)
        vecs = _vecs(rng, 150)
        jc.add_batch([f"w{i}" for i in range(150)], vecs)
        for i in (0, 7, 149):
            jc.remove(f"w{i}")
        state = jc.export_host_state()
        tc = corpus_from_jax_state(state, device="cpu")
        back = tc.export_host_state()
        assert back["ids"] == state["ids"]
        assert np.array_equal(back["rows"], state["rows"])
        assert np.array_equal(back["valid"], state["valid"])
        assert len(tc) == len(jc) == 147
        assert tc.stats()["tombstones"] == 3
        q = vecs[[5, 100]]
        _same_exact(jc, tc, q, 10)
        tc.add("w999", vecs[5])  # appends after the carried slots
        assert tc.export_host_state()["ids"][150] == "w999"

    def test_corpus_from_jax_state_rejects_bad_state(self):
        state = {"rows": np.zeros((100, DIMS), np.float32),
                 "valid": np.zeros(100, bool), "ids": [], "dims": DIMS}
        with pytest.raises(ValueError):
            corpus_from_jax_state(state, device="cpu")
        state["rows"] = np.zeros((128, DIMS + 1), np.float32)
        with pytest.raises(ValueError):
            corpus_from_jax_state(state, device="cpu")

    def test_load_jax_checkpoint(self, tmp_path):
        rng = np.random.default_rng(15)
        jc = JS.DeviceCorpus(dims=DIMS)
        vecs = _vecs(rng, 40)
        jc.add_batch([f"c{i}" for i in range(40)], vecs)
        jc.remove("c4")
        path = str(tmp_path / "corpus.npz")
        jc.save(path)
        tc = TS.DeviceCorpus.load(path, device="cpu")
        assert isinstance(tc, TS.DeviceCorpus) and len(tc) == 39
        assert not tc.has("c4")
        _same_exact(JS.DeviceCorpus.load(path), tc, vecs[[0, 10]], 8)
        # and the port's own checkpoint loads back into JAX
        tc.save(str(tmp_path / "port.npz"))
        jc2 = JS.HostCorpus.load(str(tmp_path / "port.npz"))
        assert jc2.export_host_state()["ids"] == tc.export_host_state()["ids"]
        with pytest.raises(ValueError):
            np.savez(str(tmp_path / "bad.npz"), x=np.zeros(1))
            TS.HostCorpus.load(str(tmp_path / "bad.npz"))
