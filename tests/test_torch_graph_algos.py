"""Graph algorithms of the port (``nornicdb_tpu_torch/ops/graph_algos.py``)
on the CPU, against the JAX package's ``ops/graph_algos.py``.

- every ops-level case of ``tests/test_graph_algos.py``, run against both
  packages;
- parity on seeded graphs: the Graph500 Kronecker generator at SCALE 10
  (``chip_smoke.kronecker_edges``, self-loops and duplicate edges kept) and
  a random graph with isolated trailing nodes, self-loops and duplicates.
  ``pagerank`` is float32 in both packages and sums its incoming
  contributions in another order (``index_add_`` against XLA's
  ``segment_sum``): held within rtol 1e-5 and atol 1e-9 (a rank is at
  least 0.15 / n, so atol never decides). ``connected_components`` and
  every host algorithm are equal exactly;
- the ``n == 0`` and no-edge early returns;
- ``device=None`` without CUDA raises DeviceUnavailable.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch

import chip_smoke
from nornicdb_tpu.ops import graph_algos as jga
from nornicdb_tpu_torch import DeviceUnavailable
from nornicdb_tpu_torch.ops import graph_algos as tga

PR_RTOL, PR_ATOL = 1e-5, 1e-9

# the port with its device functions pinned to the CPU, so one test body
# runs against both packages
_TORCH_CPU = types.SimpleNamespace(**{
    name: getattr(tga, name) for name in dir(tga) if not name.startswith("_")
})
_TORCH_CPU.pagerank = functools.partial(tga.pagerank, device="cpu")
_TORCH_CPU.connected_components = functools.partial(
    tga.connected_components, device="cpu")


@pytest.fixture(params=["jax", "torch"])
def ga(request):
    return jga if request.param == "jax" else _TORCH_CPU


# -- ops level (tests/test_graph_algos.py) -----------------------------------

def _star():
    # hub 0 <- spokes 1..4
    src = np.array([1, 2, 3, 4], dtype=np.int32)
    dst = np.array([0, 0, 0, 0], dtype=np.int32)
    return src, dst, 5


def test_pagerank_hub_dominates(ga):
    src, dst, n = _star()
    r = ga.pagerank(src, dst, n)
    assert r[0] == max(r)
    assert r.sum() == pytest.approx(1.0, abs=1e-3)


def test_pagerank_empty_graph(ga):
    assert list(ga.pagerank(np.array([], dtype=np.int32),
                            np.array([], dtype=np.int32), 3)) == [
        pytest.approx(1 / 3)] * 3


def test_wcc_two_components(ga):
    src = np.array([0, 1, 3], dtype=np.int32)
    dst = np.array([1, 2, 4], dtype=np.int32)
    comp = ga.connected_components(src, dst, 5)
    assert comp[0] == comp[1] == comp[2]
    assert comp[3] == comp[4]
    assert comp[0] != comp[3]


def test_scc_cycle_vs_chain(ga):
    # 0->1->2->0 is one SCC; 3->4 are singletons
    src = np.array([0, 1, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 4], dtype=np.int32)
    comp = ga.strongly_connected_components(src, dst, 5)
    assert comp[0] == comp[1] == comp[2]
    assert len({comp[3], comp[4], comp[0]}) == 3


def test_label_propagation_two_cliques(ga):
    # two triangles joined by one bridge edge
    src = np.array([0, 1, 2, 3, 4, 5, 2], dtype=np.int32)
    dst = np.array([1, 2, 0, 4, 5, 3, 3], dtype=np.int32)
    labels = ga.label_propagation(src, dst, 6, iters=20)
    assert labels[0] == labels[1] == labels[2]
    assert labels[3] == labels[4] == labels[5]


def test_louvain_two_cliques_and_modularity(ga):
    src = np.array([0, 1, 2, 3, 4, 5, 2], dtype=np.int32)
    dst = np.array([1, 2, 0, 4, 5, 3, 3], dtype=np.int32)
    labels = ga.louvain(src, dst, 6)
    assert labels[0] == labels[1] == labels[2]
    assert labels[3] == labels[4] == labels[5]
    assert labels[0] != labels[3]
    q = ga.modularity(src, dst, 6, labels)
    assert q > 0.25  # clearly better than random
    assert ga.modularity(src, dst, 6, np.zeros(6)) == pytest.approx(
        0.0, abs=1e-9)


def test_triangles_and_clustering(ga):
    # triangle 0-1-2 plus pendant 3
    src = np.array([0, 1, 2, 2], dtype=np.int32)
    dst = np.array([1, 2, 0, 3], dtype=np.int32)
    tri = ga.triangle_counts(src, dst, 4)
    assert list(tri) == [1, 1, 1, 0]
    cc = ga.clustering_coefficient(src, dst, 4)
    assert cc[0] == pytest.approx(1.0)
    assert cc[2] == pytest.approx(1 / 3)  # deg 3, one closed pair


def test_degree_closeness_betweenness_path(ga):
    # path 0-1-2-3-4: middle node 2 has max betweenness
    src = np.array([0, 1, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 3, 4], dtype=np.int32)
    deg = ga.degree_centrality(src, dst, 5)
    assert deg[2] == 2.0 and deg[0] == 1.0
    b = ga.betweenness_centrality(src, dst, 5)
    assert b[2] == max(b)
    assert b[0] == 0.0
    c = ga.closeness_centrality(src, dst, 5)
    assert c[2] == max(c)


def test_kcore_peeling(ga):
    # clique of 4 (core 3) with a tail (core 1)
    src = np.array([0, 0, 0, 1, 1, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 3, 2, 3, 3, 4], dtype=np.int32)
    core = ga.k_core(src, dst, 5)
    assert list(core[:4]) == [3, 3, 3, 3]
    assert core[4] == 1


def test_dijkstra_weighted_and_astar_heuristic(ga):
    adj = {0: [(1, 1.0), (2, 5.0)], 1: [(2, 1.0)], 2: []}
    dist, prev = ga.dijkstra(adj, 0, goal=2)
    assert dist[2] == 2.0
    assert ga.reconstruct_path(prev, 0, 2) == [0, 1, 2]
    # admissible zero heuristic == dijkstra
    dist2, _ = ga.dijkstra(adj, 0, goal=2, heuristic=lambda v: 0.0)
    assert dist2[2] == 2.0


def test_density_and_conductance(ga):
    src = np.array([0, 1], dtype=np.int32)
    dst = np.array([1, 2], dtype=np.int32)
    assert ga.density(src, dst, 3) == pytest.approx(2 / 6)
    labels = np.array([0, 0, 1])
    # one cut edge (1-2); vol(S)=3 endpoints, vol(~S)=1
    assert ga.conductance(src, dst, 3, labels, 1) == pytest.approx(1.0)


# -- parity on seeded graphs --------------------------------------------------

def _graph500(scale: int = 10, seed: int = 0):
    s, d = chip_smoke.kronecker_edges(scale, 16, seed)
    return s.numpy(), d.numpy(), 1 << scale


def _random_graph(seed: int = 3):
    """200 nodes of which the last 20 are isolated; 600 random edges among
    the first 180 plus 20 self-loops and 40 duplicated edges."""
    rng = np.random.default_rng(seed)
    n, live = 200, 180
    src = rng.integers(0, live, 600)
    dst = rng.integers(0, live, 600)
    loops = rng.integers(0, live, 20)
    dup = rng.integers(0, 600, 40)
    src = np.concatenate([src, loops, src[dup]]).astype(np.int32)
    dst = np.concatenate([dst, loops, dst[dup]]).astype(np.int32)
    return src, dst, n


GRAPHS = {"graph500_s10": _graph500, "random_isolated": _random_graph}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("damping,iters", [(0.85, 20), (0.5, 7)])
def test_pagerank_parity(graph, damping, iters):
    src, dst, n = GRAPHS[graph]()
    want = jga.pagerank(src, dst, n, damping=damping, iters=iters)
    got = tga.pagerank(src, dst, n, damping=damping, iters=iters,
                       device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=PR_RTOL, atol=PR_ATOL)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_wcc_parity_exact(graph):
    src, dst, n = GRAPHS[graph]()
    want = jga.connected_components(src, dst, n)
    got = tga.connected_components(src, dst, n, device="cpu")
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # each label is its component's smallest member
    assert np.all(got <= np.arange(n)) and np.all(got[got] == got)


def test_wcc_device_rounds_and_labels():
    src, dst, n = _graph500(8, seed=5)
    s = torch.from_numpy(np.concatenate([src, dst]))
    d = torch.from_numpy(np.concatenate([dst, src])).long()
    labels, rounds = tga.wcc_device(s, d, n)
    assert rounds >= 2  # the last round changed nothing
    np.testing.assert_array_equal(labels.numpy(),
                                  jga.connected_components(src, dst, n))


_HOST = [
    ("label_propagation", lambda g, s, d, n: g.label_propagation(s, d, n)),
    ("build_csr", lambda g, s, d, n: g.build_csr(s, d, n)),
    ("build_csr_directed",
     lambda g, s, d, n: g.build_csr(s, d, n, undirected=False)),
    ("bfs_distances_csr",
     lambda g, s, d, n: g.bfs_distances_csr(*g.build_csr(s, d, n), 0, n)),
    ("degree_centrality", lambda g, s, d, n: g.degree_centrality(s, d, n)),
    ("closeness_centrality",
     lambda g, s, d, n: g.closeness_centrality(s, d, n)),
    ("betweenness_centrality",
     lambda g, s, d, n: g.betweenness_centrality(s, d, n)),
    ("triangle_counts", lambda g, s, d, n: g.triangle_counts(s, d, n)),
    ("clustering_coefficient",
     lambda g, s, d, n: g.clustering_coefficient(s, d, n)),
    ("strongly_connected_components",
     lambda g, s, d, n: g.strongly_connected_components(s, d, n)),
    ("k_core", lambda g, s, d, n: g.k_core(s, d, n)),
    ("louvain", lambda g, s, d, n: g.louvain(s, d, n)),
    ("modularity", lambda g, s, d, n: g.modularity(
        s, d, n, g.label_propagation(s, d, n))),
    ("density", lambda g, s, d, n: g.density(s, d, n)),
    ("conductance", lambda g, s, d, n: g.conductance(
        s, d, n, g.label_propagation(s, d, n), 0)),
]
# Brandes betweenness, closeness and Louvain are O(n m) Python: the
# 1,024-node Kronecker graph takes them tens of seconds, so they run on the
# random graph only
_SLOW_ON_GRAPH500 = {"betweenness_centrality", "closeness_centrality",
                     "louvain"}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name,fn", _HOST, ids=[h[0] for h in _HOST])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_host_algorithms_equal_exactly(graph, name, fn):
    if graph == "graph500_s10" and name in _SLOW_ON_GRAPH500:
        src, dst, n = _graph500(7)
    else:
        src, dst, n = GRAPHS[graph]()
    want, got = _as_tuple(fn(jga, src, dst, n)), _as_tuple(fn(tga, src, dst, n))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dijkstra_parity(graph):
    src, dst, n = GRAPHS[graph]()
    rng = np.random.default_rng(11)
    weights = rng.uniform(0.5, 4.0, len(src))
    adj: dict[int, list[tuple[int, float]]] = {}
    for a, b, w in zip(src.tolist(), dst.tolist(), weights.tolist()):
        adj.setdefault(a, []).append((b, w))
    start, goal = int(src[0]), int(dst[-1])
    want = jga.dijkstra(adj, start, goal=goal)
    got = tga.dijkstra(adj, start, goal=goal)
    assert got == want
    assert tga.reconstruct_path(got[1], start, goal) == jga.reconstruct_path(
        want[1], start, goal)


# -- early returns and device policy -----------------------------------------

EMPTY = np.array([], dtype=np.int32)


@pytest.mark.parametrize("fn", ["pagerank", "connected_components"])
def test_zero_nodes(fn):
    want = getattr(jga, fn)(EMPTY, EMPTY, 0)
    got = getattr(tga, fn)(EMPTY, EMPTY, 0, device="cpu")
    assert got.shape == want.shape == (0,) and got.dtype == want.dtype


@pytest.mark.parametrize("fn", ["pagerank", "connected_components"])
def test_no_edges(fn):
    want = getattr(jga, fn)(EMPTY, EMPTY, 7)
    got = getattr(tga, fn)(EMPTY, EMPTY, 7, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["pagerank", "connected_components"])
def test_device_none_without_cuda_raises(fn):
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour without CUDA")
    src, dst, n = _star()
    with pytest.raises(DeviceUnavailable):
        getattr(tga, fn)(src, dst, n)
    # the early returns do not hide the device policy either
    with pytest.raises(DeviceUnavailable):
        getattr(tga, fn)(EMPTY, EMPTY, 0)
