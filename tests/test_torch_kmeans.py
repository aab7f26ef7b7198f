"""The port's k-means (``nornicdb_tpu_torch.ops.kmeans``, on the CPU) against
the JAX package's ``nornicdb_tpu.ops.kmeans`` on the same inputs.

The two packages draw different random numbers from one seed, so Lloyd is
compared from a shared numpy initialisation. Tolerances: squared distances,
centroids and drift within 1e-5 (float32 products and sums in another
order); assignments and probes identical (first index on ties in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import kmeans as JK
from nornicdb_tpu_torch.ops import kmeans as TK

TOL = 1e-5


def _blobs(n, d, centers, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + spread * rng.normal(
        size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def _init(x, k, seed):
    return x[np.random.default_rng(seed).choice(x.shape[0], k, replace=False)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d,k", [(200, 16, 5), (97, 33, 12)])
def test_distances_assignments_and_probes_match_jax(n, d, k):
    x = _blobs(n, d, k, seed=n)
    c = _init(x, k, seed=1) + 0.01
    dj = np.asarray(JK.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c)))
    dt = TK.pairwise_sq_dists(_t(x), _t(c)).numpy()
    assert np.max(np.abs(dt - dj)) <= TOL * max(1.0, float(dj.max()))
    np.testing.assert_array_equal(
        TK.assign_clusters(_t(x), _t(c)).numpy(),
        np.asarray(JK.assign_clusters(jnp.asarray(x), jnp.asarray(c))))
    for row in (0, 5, n - 1):
        np.testing.assert_array_equal(
            TK.nearest_clusters(_t(x[row]), _t(c), 3).numpy(),
            np.asarray(JK.nearest_clusters(jnp.asarray(x[row]),
                                           jnp.asarray(c), 3)))


@pytest.mark.parametrize("iters", [1, 6])
def test_lloyd_from_a_shared_init_matches_jax(iters):
    x = _blobs(300, 16, 6, seed=3)
    init = _init(x, 6, seed=4)
    cj, aj, dj = JK.lloyd(jnp.asarray(x), jnp.asarray(init), 6, iters)
    ct, at, dt = TK.lloyd(_t(x), _t(init), 6, iters)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert np.max(np.abs(ct.numpy() - np.asarray(cj))) <= TOL
    assert dt.shape == (iters,)
    assert np.max(np.abs(dt.numpy() - np.asarray(dj))) <= TOL


def test_empty_cluster_keeps_its_centroid():
    x = _blobs(120, 8, 3, seed=5)
    init = np.concatenate([_init(x, 3, seed=6),
                           np.full((1, 8), 100.0, np.float32)])  # owns no row
    ct, at, _ = TK.lloyd(_t(x), _t(init), 4, 3)
    cj, _, _ = JK.lloyd(jnp.asarray(x), jnp.asarray(init), 4, 3)
    assert not (at.numpy() == 3).any()
    np.testing.assert_array_equal(ct.numpy()[3], init[3])
    assert np.max(np.abs(ct.numpy() - np.asarray(cj))) <= TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_pp_init_picks_k_distinct_rows(seed):
    x = _blobs(150, 12, 5, seed=7)
    gen = torch.Generator().manual_seed(seed)
    cents = TK.kmeans_pp_init(gen, _t(x), 10).numpy()
    rows = {tuple(r) for r in x}
    assert all(tuple(c) in rows for c in cents)
    assert len({tuple(c) for c in cents}) == 10


def test_kmeans_pp_init_with_fewer_distinct_rows_than_k():
    x = np.repeat(_blobs(2, 4, 2, seed=8), 5, axis=0)  # 2 distinct rows
    cents = TK.kmeans_pp_init(torch.Generator().manual_seed(0), _t(x), 4)
    assert cents.shape == (4, 4) and torch.isfinite(cents).all()


def test_sampled_fit_assigns_the_full_set_in_chunks(monkeypatch):
    """The chunked, power-of-two-padded tail assignment equals one
    assign_clusters over the full set."""
    monkeypatch.setattr(TK, "_ASSIGN_CHUNK", 64)
    x = _blobs(300, 16, 8, seed=9)
    res = TK.kmeans_fit(x, k=8, iters=4, seed=1, sample=100, device="cpu")
    full = TK.assign_clusters(_t(x), _t(res.centroids)).numpy()
    np.testing.assert_array_equal(res.assignments, full)
    assert res.assignments.dtype == np.int32 and res.assignments.shape == (300,)
    assert res.centroids.shape == (8, 16) and res.k == 8


def test_fit_is_seeded_and_k_is_capped():
    x = _blobs(200, 8, 5, seed=11)
    a = TK.kmeans_fit(x, k=5, iters=10, seed=3, device="cpu")
    b = TK.kmeans_fit(x, k=5, iters=10, seed=3, device="cpu")
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert a.drift[-1] <= a.drift[0] + 1e-6
    assert TK.kmeans_fit(x[:3], k=10, iters=2, device="cpu").k == 3


@pytest.mark.parametrize("n", [0, 1, 2, 3, 100, 4096, 1_000_000, 10_000_000])
def test_optimal_k_matches_jax(n):
    assert TK.optimal_k(n) == JK.optimal_k(n)
