"""Topological link prediction of the port (``nornicdb_tpu_torch/linkpredict``)
on the CPU, against the JAX package's ``linkpredict``.

- the ``TestLinkPredict`` cases of ``tests/test_learning.py``, on the port;
- ``build_graph`` over the port's ``MemoryEngine`` against the JAX one over
  its own, with the same nodes and edges, an ``edge_types`` filter and
  self-loops: equal ``ids``, ``index`` and ``neighbors``;
- ``batch_scores`` for all five methods at n = 40 (numpy in both packages)
  and n = 200 (the port's adjacency GEMMs: ``torch.matmul`` on the CPU),
  and with ``use_device=False``. ``commonNeighbors`` and
  ``preferentialAttachment`` are integers in float32 and equal exactly;
  ``jaccard``, ``adamicAdar`` and ``resourceAllocation`` sum float32
  weights in another order: rtol 1e-6, atol 1e-6;
- ``top_candidates`` and ``hybrid_score`` against JAX.

The JAX package's device branch (``use_device`` and n >= 64) cannot be the
reference: it writes the diagonal of ``np.asarray(jnp.matmul(...))``, a
read-only array, and raises ValueError on every backend (so does its
``top_candidates``, which takes that branch). For n >= 64 the reference
is therefore the JAX package's numpy branch over the same graph, and the
port's products are also held exactly against ``jnp.matmul`` of the same
adjacency.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from nornicdb_tpu import linkpredict as jlp
from nornicdb_tpu.storage import Edge as JEdge
from nornicdb_tpu.storage import MemoryEngine as JMemoryEngine
from nornicdb_tpu.storage import Node as JNode
from nornicdb_tpu_torch import DeviceUnavailable
from nornicdb_tpu_torch.linkpredict import (
    HybridConfig,
    batch_scores,
    build_graph,
    hybrid_score,
    score_pair,
    top_candidates,
)
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

METHODS = ("commonNeighbors", "jaccard", "adamicAdar",
           "preferentialAttachment", "resourceAllocation")
EXACT = {"commonNeighbors", "preferentialAttachment"}
RTOL, ATOL = 1e-6, 1e-6


def _chain_graph():
    """a-b, b-c, a-d, c-d : common neighbors etc."""
    eng = MemoryEngine()
    for i in "abcd":
        eng.create_node(Node(id=i))
    eng.create_edge(Edge(id="e1", start_node="a", end_node="b"))
    eng.create_edge(Edge(id="e2", start_node="b", end_node="c"))
    eng.create_edge(Edge(id="e3", start_node="a", end_node="d"))
    eng.create_edge(Edge(id="e4", start_node="c", end_node="d"))
    return eng


class TestLinkPredict:
    def test_pair_scorers(self):
        g = build_graph(_chain_graph())
        # a and c share neighbors b and d
        assert score_pair(g, "a", "c", "commonNeighbors") == 2.0
        assert score_pair(g, "a", "c", "jaccard") == pytest.approx(1.0)
        assert score_pair(g, "a", "c", "adamicAdar") == pytest.approx(
            2.0 / math.log(2), rel=1e-6
        )
        assert score_pair(g, "a", "c", "preferentialAttachment") == 4.0
        assert score_pair(g, "a", "c", "resourceAllocation") == pytest.approx(
            1.0)

    def test_batch_matches_pairwise(self):
        g = build_graph(_chain_graph())
        for method in METHODS:
            s = batch_scores(g, method, use_device=False)
            for a in "abcd":
                for b in "abcd":
                    if a == b:
                        continue
                    want = score_pair(g, a, b, method)
                    got = s[g.index[a], g.index[b]]
                    assert got == pytest.approx(want, rel=1e-5), (method, a, b)

    def test_top_candidates_excludes_existing(self):
        g = build_graph(_chain_graph())
        cands = top_candidates(g, "commonNeighbors", limit=10)
        pairs = {(a, b) for a, b, _ in cands}
        assert ("a", "b") not in pairs  # existing edge
        assert ("a", "c") in pairs or ("b", "d") in pairs

    def test_hybrid_blend(self):
        g = build_graph(_chain_graph())
        ea = np.array([1.0, 0.0], np.float32)
        ec = np.array([1.0, 0.0], np.float32)
        full = hybrid_score(g, "a", "c", ea, ec)
        topo_only = hybrid_score(g, "a", "c", None, None)
        assert full > topo_only  # perfect semantic agreement lifts the score


# -- against the JAX package -------------------------------------------------

def _engines(n: int, n_edges: int, seed: int = 0):
    """The same nodes and edges in a port and a JAX MemoryEngine: random
    edges of two types, self-loops and a duplicated pair among them."""
    rng = np.random.default_rng(seed)
    port, ref = MemoryEngine(), JMemoryEngine()
    order = rng.permutation(n)  # insertion order differs from id order
    for i in order:
        port.create_node(Node(id=f"n{i:04d}"))
        ref.create_node(JNode(id=f"n{i:04d}"))
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n, n_edges)
    src[:5] = dst[:5]                      # self-loops
    src[5], dst[5] = src[6], dst[6]        # a duplicate pair
    types = np.where(rng.random(n_edges) < 0.7, "KNOWS", "LIKES")
    for e, (a, b, t) in enumerate(zip(src, dst, types)):
        kw = dict(id=f"e{e}", start_node=f"n{a:04d}", end_node=f"n{b:04d}",
                  type=str(t))
        port.create_edge(Edge(**kw))
        ref.create_edge(JEdge(**kw))
    return port, ref


@pytest.mark.parametrize("edge_types", [None, ["KNOWS"], ["NONE"]])
def test_build_graph_parity(edge_types):
    port, ref = _engines(60, 200, seed=1)
    assert sorted(e.id for e in port.all_edges()) == sorted(
        e.id for e in ref.all_edges())
    g = build_graph(port, edge_types)
    w = jlp.build_graph(ref, edge_types)
    assert g.ids == w.ids and g.index == w.index
    assert g.neighbors == w.neighbors
    assert all(i not in nb for i, nb in enumerate(g.neighbors))  # no loops


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("n", [40, 200])
@pytest.mark.parametrize("method", METHODS)
def test_batch_scores_parity(method, n, use_device):
    port, ref = _engines(n, 4 * n, seed=n)
    g, w = build_graph(port), jlp.build_graph(ref)
    got = batch_scores(g, method, use_device=use_device, device="cpu")
    want = jlp.batch_scores(w, method, use_device=use_device and n < 64)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, n)
    if method in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_device_products_match_jnp_matmul():
    import jax.numpy as jnp

    port, _ = _engines(200, 800, seed=5)
    g = build_graph(port)
    a = np.zeros((g.n, g.n), np.float32)
    for i, nbrs in enumerate(g.neighbors):
        a[i, list(nbrs)] = 1.0
    cn = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(a),
                               preferred_element_type=jnp.float32)).copy()
    np.fill_diagonal(cn, 0.0)
    np.testing.assert_array_equal(
        batch_scores(g, "commonNeighbors", device="cpu"), cn)


@pytest.mark.parametrize("n", [40, 200])
@pytest.mark.parametrize("method", METHODS)
def test_top_candidates_parity(method, n, monkeypatch):
    port, ref = _engines(n, 4 * n, seed=7)
    g, w = build_graph(port), jlp.build_graph(ref)
    got = top_candidates(g, method, limit=20, device="cpu")
    if n >= 64:
        # the JAX device branch raises (module docstring): its
        # top_candidates runs over its numpy branch instead
        from nornicdb_tpu.linkpredict import topology as jtopo

        numpy_scores = jtopo.batch_scores
        monkeypatch.setattr(
            jtopo, "batch_scores",
            lambda gr, m: numpy_scores(gr, m, use_device=False))
    want = jlp.top_candidates(w, method, limit=20)
    assert len(got) == len(want)
    for (_, _, gs), (_, _, ws) in zip(got, want):
        assert gs == pytest.approx(ws, rel=RTOL, abs=ATOL)
    # the same pairs, apart from pairs whose scores tie with the last one
    # within the tolerance (either may be cut)
    cut = want[-1][2] + ATOL + RTOL * abs(want[-1][2])
    assert ({p[:2] for p in got if p[2] > cut}
            == {p[:2] for p in want if p[2] > cut})


def test_hybrid_score_parity():
    port, ref = _engines(80, 300, seed=3)
    g, w = build_graph(port), jlp.build_graph(ref)
    rng = np.random.default_rng(3)
    cfg = HybridConfig(topology_weight=0.3, semantic_weight=0.7)
    jcfg = jlp.HybridConfig(topology_weight=0.3, semantic_weight=0.7)
    for _ in range(20):
        a, b = rng.choice(g.ids, 2, replace=False)
        ea, eb = rng.normal(size=(2, 16)).astype(np.float32)
        assert hybrid_score(g, a, b, ea, eb, cfg) == jlp.hybrid_score(
            w, a, b, ea, eb, jcfg)
        assert hybrid_score(g, a, b, None, eb) == jlp.hybrid_score(
            w, a, b, None, eb)


def test_device_branch_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("asserts the behaviour without CUDA")
    port, _ = _engines(70, 200)
    g = build_graph(port)
    with pytest.raises(DeviceUnavailable):
        batch_scores(g, "adamicAdar")
    # below 64 nodes, or with use_device=False, numpy runs: no device asked
    assert batch_scores(g, "adamicAdar", use_device=False).shape == (70, 70)
    assert batch_scores(build_graph(_chain_graph()),
                        "adamicAdar").shape == (4, 4)
