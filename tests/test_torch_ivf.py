"""The port's IVF layout, search and DeviceCorpus pruning (on the CPU) against
the JAX package's ``nornicdb_tpu.ops.ivf`` and ``DeviceCorpus``.

Inputs are made with numpy from fixed seeds. The layout must be identical
(blocks, counts, slotmap, residual, Cmax). ``ivf_search`` must return the
same slots with scores within 1e-6: both score bf16-rounded operands with
float32 products and sums, in another order. The corpus tests mirror
``tests/test_ivf.py::TestDeviceCorpusIntegration``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import ivf as JI
from nornicdb_tpu.ops.similarity import DeviceCorpus as JaxCorpus
from nornicdb_tpu_torch.ops import ivf as TI
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus

TOL = 1e-6


def _random_clustered(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, k, size=n)
    rows = centers[assign] + 0.15 * rng.normal(size=(n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32), assign.astype(np.int32), centers


def _spill_case():
    # one giant cluster forces the Cmax clamp and the residual spill
    rows, _, _ = _random_clustered(256, 16, 4)
    centers = np.zeros((4, 16), np.float32)
    centers[:, 0] = 1.0
    return rows, np.zeros(256, np.int32), centers


def _layout_cases():
    rows, assign, centers = _random_clustered(300, 32, 5)
    yield "plain", rows, np.arange(300), assign, centers
    yield "spill", *(lambda r, a, c: (r, np.arange(256), a, c))(*_spill_case())
    # scattered slots, and rows without a cluster (-1 / out of range)
    rows, assign, centers = _random_clustered(200, 16, 6, seed=3)
    assign = assign.copy()
    assign[::17] = -1
    assign[5] = 9
    slots = np.random.default_rng(4).permutation(1000)[:200]
    yield "holes", rows, slots, assign, centers


def _both(rows, slots, assign, centers):
    lj = JI.build_ivf_layout(rows, slots, assign, centers)
    lt = TI.build_ivf_layout(rows, slots, assign, centers, device="cpu")
    return lj, lt


@pytest.mark.parametrize("case", list(_layout_cases()), ids=lambda c: c[0])
def test_layout_identical_to_jax(case):
    _, rows, slots, assign, centers = case
    lj, lt = _both(rows, slots, assign, centers)
    assert (lt.cmax, lt.k, lt.epoch) == (lj.cmax, lj.k, lj.epoch)
    np.testing.assert_array_equal(lt.blocks.numpy(), np.asarray(lj.blocks))
    np.testing.assert_array_equal(lt.counts.numpy(), np.asarray(lj.counts))
    np.testing.assert_array_equal(lt.centroids.numpy(),
                                  np.asarray(lj.centroids))
    np.testing.assert_array_equal(lt.slotmap, lj.slotmap)
    np.testing.assert_array_equal(lt.residual_slots, lj.residual_slots)
    if lj.residual is None:
        assert lt.residual is None and lt.residual_valid is None
    else:
        np.testing.assert_array_equal(lt.residual.numpy(),
                                      np.asarray(lj.residual))
        np.testing.assert_array_equal(lt.residual_valid.numpy(),
                                      np.asarray(lj.residual_valid))
    assert lt.n_rows == lj.n_rows
    assert lt.device_bytes == sum(
        int(np.asarray(a).nbytes) for a in (lj.blocks, lj.counts, lj.centroids,
                                            lj.residual, lj.residual_valid)
        if a is not None)


def test_layout_in_bf16_is_jax_layout_in_bf16():
    rows, assign, centers = _random_clustered(300, 32, 5, seed=5)
    lj = JI.build_ivf_layout(rows, np.arange(300), assign, centers,
                             dtype=jnp.bfloat16)
    lt = TI.build_ivf_layout(rows, np.arange(300), assign, centers,
                             dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(lt.blocks.float().numpy(),
                                  np.asarray(lj.blocks, np.float32))


SEARCHES = [
    # (name, layout case, queries, k, n_probe)
    ("self", lambda: _random_clustered(500, 64, 8, seed=1), slice(10, 20), 3, 3),
    ("recall", lambda: _random_clustered(2000, 64, 16, seed=2), slice(0, 32), 10, 4),
    ("all-probes", lambda: _random_clustered(400, 32, 6, seed=6), slice(0, 9), 20, 6),
    ("spill", _spill_case, slice(0, 3), 1, 1),
    ("spill-k", _spill_case, slice(0, 5), 40, 2),
    ("min-k-padding", lambda: _random_clustered(20, 16, 4), slice(0, 1), 50, 1),
]


def _search_case(make, qsl):
    rows, assign, centers = make()
    lj, lt = _both(rows, np.arange(rows.shape[0]), assign, centers)
    rng = np.random.default_rng(9)
    qs = rows[qsl] + 0.05 * rng.normal(size=rows[qsl].shape).astype(np.float32)
    return lj, lt, qs


@pytest.mark.parametrize("name,make,qsl,k,n_probe", SEARCHES,
                         ids=[s[0] for s in SEARCHES])
def test_ivf_search_matches_jax(name, make, qsl, k, n_probe):
    lj, lt, qs = _search_case(make, qsl)
    vj, sj = JI.ivf_search(lj, qs, k=k, n_probe=n_probe)
    vt, st = TI.ivf_search(lt, qs, k=k, n_probe=n_probe)
    assert vt.shape == vj.shape == (qs.shape[0], k) and st.shape == sj.shape
    np.testing.assert_array_equal(st, sj)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(np.isfinite(vt), fin)
    assert np.max(np.abs(vt[fin] - vj[fin]), initial=0.0) <= TOL
    if name == "min-k-padding":
        assert (st[0] == -1).any()  # padded beyond the available candidates
    if name == "spill":
        assert (st[:, 0] == np.arange(3)).all()  # spilled rows still found


@pytest.mark.parametrize("max_bytes", [1, 3 << 20])
def test_memory_capped_scoring_equals_one_chunk(max_bytes):
    """One cluster (or a few) a chunk gives what one uncapped chunk gives."""
    lj, lt, qs = _search_case(SEARCHES[1][1], slice(0, 32))
    v1, s1 = TI.ivf_search(lt, qs, k=10, n_probe=5, max_bytes=1 << 40)
    v2, s2 = TI.ivf_search(lt, qs, k=10, n_probe=5, max_bytes=max_bytes)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(v1, v2)


class TestDeviceCorpusIntegration:
    """``tests/test_ivf.py::TestDeviceCorpusIntegration`` on the port."""

    def _corpus(self, n=400, d=32, k=6, seed=0):
        rows, _, _ = _random_clustered(n, d, k, seed)
        c = DeviceCorpus(dims=d, device="cpu")
        c.add_batch([f"n{i}" for i in range(n)], rows)
        return c, rows

    def test_fused_path_used_and_correct(self):
        c, rows = self._corpus()
        assert c.cluster(k=6) > 0
        assert c._ivf is not None
        d0 = c.sync_stats.device_dispatches
        res = c.search(rows[5], k=3, n_probe=3)
        assert res[0][0][0] == "n5"
        assert res[0][0][1] > 0.99
        assert c.sync_stats.device_dispatches == d0 + 1

    def test_matches_full_scan_top1(self):
        c, rows = self._corpus(seed=4)
        c.cluster(k=6)
        full = c.search(rows[:20], k=1)
        pruned = c.search(rows[:20], k=1, n_probe=4)
        agree = sum(1 for f, p in zip(full, pruned)
                    if f and p and f[0][0] == p[0][0])
        assert agree >= 18  # >= 90% top-1 agreement at n_probe=4/6

    def test_overwrite_invalidates_layout_plain_add_does_not(self):
        c, rows = self._corpus()
        c.cluster(k=6)
        layout = c._ivf
        # a NEW id lands in a fresh slot no block covers: the layout stays
        c.add("extra", np.ones(32, np.float32))
        assert c._ivf is layout and layout.epoch == c._layout_epoch
        res_full = c.search(np.ones(32, np.float32), k=1)
        assert res_full[0][0][0] == "extra"
        # overwriting a CLUSTERED row in place would serve the stale copy
        c.add("n5", np.ones(32, np.float32))
        assert layout.epoch != c._layout_epoch
        res = c.search(rows[5], k=1, n_probe=6)  # falls back, no stale serve
        assert res[0][0][0] != "n5"

    def test_recluster_rebuilds_layout(self):
        c, rows = self._corpus()
        c.cluster(k=6)
        c.add("extra", rows[0] * -1.0)
        c.cluster(k=6)
        assert c._ivf is not None and c._ivf.epoch == c._layout_epoch
        res = c.search(rows[0] * -1.0, k=1, n_probe=6)
        assert res[0][0][0] == "extra"

    def test_min_similarity_filter(self):
        c, rows = self._corpus()
        c.cluster(k=6)
        res = c.search(rows[0], k=10, n_probe=3, min_similarity=0.999)
        assert all(s >= 0.999 for _, s in res[0])

    def test_grow_compact_and_clear_drop_the_clusters(self):
        c, rows = self._corpus(n=200)
        for mutate in (lambda: c.add_batch([f"g{i}" for i in range(200)],
                                           rows[::-1]),          # grow
                       lambda: c.clear()):
            c.cluster(k=4)
            epoch = c._layout_epoch
            mutate()
            assert c._ivf is None and c._centroids is None
            assert c._layout_epoch > epoch
        c.add_batch([f"n{i}" for i in range(200)], rows)
        c.cluster(k=4)
        for i in range(100):
            c.remove(f"n{i}")
        c.search(rows[150], k=1)  # the deferred compaction runs on sync
        assert c._ivf is None

    def test_stale_layout_scans_the_assigned_rows(self):
        """With the layout invalidated but the assignments kept, the
        assignment-mask scan serves (JAX ``_pruned_scan``)."""
        c, rows = self._corpus(seed=7)
        c.cluster(k=6)
        c.add("n9", rows[9])  # overwrite of a covered row: layout stale
        res = c.search(rows[10:14], k=3, n_probe=6)
        assert [r[0][0] for r in res] == ["n10", "n11", "n12", "n13"]


@pytest.mark.parametrize("n_probe,k", [(1, 5), (3, 10), (6, 20)])
def test_set_clusters_with_jax_fit_serves_as_jax(n_probe, k):
    """JAX fits and serves; the port installs JAX's fit with set_clusters
    and must serve the same ids, scores within 1e-6."""
    rows, _, _ = _random_clustered(600, 32, 6, seed=11)
    ids = [f"n{i}" for i in range(600)]
    jc = JaxCorpus(dims=32)
    jc.add_batch(ids, rows)
    assert jc.cluster(k=6, iters=5) > 0
    by_id = {ids[s]: int(a) for s, a in enumerate(jc._assignments[:600])}
    tc = DeviceCorpus(dims=32, device="cpu")
    tc.add_batch(ids, rows)
    tc.set_clusters(np.asarray(jc._centroids), by_id)
    assert tc._ivf is not None and tc._ivf.cmax == jc._ivf.cmax
    rng = np.random.default_rng(12)
    qs = rows[rng.integers(0, 600, 16)] + 0.1 * rng.normal(
        size=(16, 32)).astype(np.float32)
    for min_sim in (-1.0, 0.5):
        want = jc.search(qs, k=k, n_probe=n_probe, min_similarity=min_sim)
        got = tc.search(qs, k=k, n_probe=n_probe, min_similarity=min_sim)
        assert [[i for i, _ in r] for r in got] == [[i for i, _ in r]
                                                    for r in want]
        for a, b in zip(got, want):
            assert np.allclose([s for _, s in a], [s for _, s in b],
                               atol=TOL, rtol=0)
