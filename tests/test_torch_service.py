"""The port's vector search service and batcher (on the CPU) against the JAX
package's ``SearchService.vector_candidates``.

Nodes carry explicit embeddings made with numpy from fixed seeds. In exact
mode the ids must be identical, in order; scores agree within 1e-5 (the f32
sums of bf16 products run in another order in XLA and in PyTorch).
"""

import threading
import time

import numpy as np
import pytest

from nornicdb_tpu.search.service import SearchConfig as JaxSearchConfig
from nornicdb_tpu.search.service import SearchService as JaxSearchService
from nornicdb_tpu.storage import MemoryEngine
from nornicdb_tpu.storage.types import Node
from nornicdb_tpu_torch import ResourceExhausted
from nornicdb_tpu_torch.search import QueryBatcher, SearchConfig, SearchService

DIMS = 24


def _nodes(rng, n, prefix="n"):
    vecs = rng.standard_normal((n, DIMS)).astype(np.float32)
    return [Node(id=f"{prefix}{i}", embedding=vecs[i]) for i in range(n)], vecs


def _services(batching):
    jax_svc = JaxSearchService(
        MemoryEngine(), dims=DIMS,
        config=JaxSearchConfig(exact=True, batching_enabled=batching))
    port_svc = SearchService(
        config=SearchConfig(exact=True, batching_enabled=batching),
        device="cpu")
    return jax_svc, port_svc


def _assert_same(a, b):
    assert [i for i, _ in a] == [i for i, _ in b]
    assert np.allclose([s for _, s in a], [s for _, s in b], atol=1e-5)


@pytest.mark.parametrize("batching", [False, True])
def test_vector_candidates_match_jax(batching):
    rng = np.random.default_rng(21)
    nodes, vecs = _nodes(rng, 200)
    jax_svc, port_svc = _services(batching)
    try:
        for node in nodes:
            jax_svc.index_node(node)
            port_svc.index_node(node)
        for nid in ("n3", "n77", "n150"):
            jax_svc.remove_node(nid)
            port_svc.remove_node(nid)
        moved = Node(id="n10", embedding=vecs[11] + 0.01)
        jax_svc.index_node(moved)
        port_svc.index_node(moved)
        queries = vecs[[0, 3, 11, 199]] + 0.05 * rng.standard_normal(
            (4, DIMS)).astype(np.float32)
        for q in queries:
            for k, min_sim in ((10, -1.0), (5, 0.2), (40, -1.0)):
                a = jax_svc.vector_candidates(q, k=k, min_similarity=min_sim)
                b = port_svc.vector_candidates(q, k=k, min_similarity=min_sim)
                _assert_same(a, b)
                assert not {"n3", "n77", "n150"} & {i for i, _ in b}
    finally:
        port_svc.shutdown()


def test_unchanged_reindex_keeps_corpus_clean():
    rng = np.random.default_rng(22)
    nodes, _ = _nodes(rng, 20)
    svc = SearchService(device="cpu")
    for node in nodes:
        svc.index_node(node)
    corpus = svc.corpus()
    corpus.search(nodes[0].embedding, k=1)
    epoch = corpus.stats()["epoch"]
    svc.index_node(nodes[4])  # same embedding: no write
    assert corpus.stats()["epoch"] == epoch
    svc.index_node(Node(id="n4", embedding=None))  # embedding dropped
    assert not corpus.has("n4")
    assert svc.vector_candidates(nodes[0].embedding, k=3)[0][0] == "n0"


def test_bulk_index_vectors():
    rng = np.random.default_rng(23)
    vecs = rng.standard_normal((300, DIMS)).astype(np.float32)
    svc = SearchService(config=SearchConfig(exact=True), device="cpu")
    assert svc.vector_candidates(vecs[0], k=3) == []  # no corpus yet
    svc.index_vectors([f"b{i}" for i in range(300)], vecs)
    assert len(svc.corpus()) == 300 and svc.stats.indexed == 300
    got = svc.vector_candidates(vecs[42], k=2)
    assert got[0][0] == "b42" and abs(got[0][1] - 1.0) < 1e-2


def test_fused_batches_take_fewer_dispatches_than_queries():
    rng = np.random.default_rng(24)
    vecs = rng.standard_normal((256, DIMS)).astype(np.float32)
    svc = SearchService(
        config=SearchConfig(batching_enabled=True, batch_window=0.05),
        device="cpu")
    svc.index_vectors([f"f{i}" for i in range(256)], vecs)
    corpus = svc.corpus()
    corpus.search(vecs[0], k=1)  # first upload outside the counted window
    d0 = corpus.sync_stats.device_dispatches
    n = 24
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait()
        results[i] = svc.vector_candidates(vecs[i], k=3)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        dispatches = corpus.sync_stats.device_dispatches - d0
        stats = svc.ensure_batcher().stats
        assert all(r and r[0][0] == f"f{i}" for i, r in enumerate(results))
        assert dispatches == stats.batches < n
        assert stats.queries == n and stats.max_batch > 1
    finally:
        svc.shutdown()


def test_max_queue_sheds_with_resource_exhausted():
    entered, release = threading.Event(), threading.Event()

    def slow_search(queries, k, min_sim):
        entered.set()
        release.wait(10)
        return [[("x", 1.0)] for _ in range(len(queries))]

    b = QueryBatcher(slow_search, window=0.0, max_queue=2)
    try:
        first = b.submit(np.zeros(4, np.float32), 1)
        assert entered.wait(5)  # the dispatcher holds the first batch
        queued = [b.submit(np.zeros(4, np.float32), 1) for _ in range(2)]
        with pytest.raises(ResourceExhausted) as exc:
            b.submit(np.zeros(4, np.float32), 1)
        assert exc.value.reason == "queue_full"
        assert b.stats.sheds_queue_full == 1
        release.set()
        for p in [first] + queued:
            assert b.wait(p) == [("x", 1.0)]
    finally:
        release.set()
        b.close()


def test_deadline_sheds_stale_queries():
    entered, gate = threading.Event(), threading.Event()

    def search(queries, k, min_sim):
        entered.set()
        gate.wait(10)
        return [[("y", 0.5)] for _ in range(len(queries))]

    b = QueryBatcher(search, window=0.0, deadline=0.05)
    try:
        first = b.submit(np.zeros(4, np.float32), 1)
        assert entered.wait(5)  # the dispatcher holds the first batch
        late = b.submit(np.zeros(4, np.float32), 1)
        time.sleep(0.1)  # `late` expires while `first` holds the device
        gate.set()
        assert b.wait(first) == [("y", 0.5)]
        with pytest.raises(ResourceExhausted) as exc:
            b.wait(late)
        assert exc.value.reason == "deadline"
        assert b.stats.sheds_deadline == 1
    finally:
        gate.set()
        b.close()


def test_batch_failure_reaches_every_caller():
    def broken(queries, k, min_sim):
        raise RuntimeError("device lost")

    b = QueryBatcher(broken, window=0.01)
    try:
        tickets = [b.submit(np.zeros(4, np.float32), 1) for _ in range(3)]
        for p in tickets:
            with pytest.raises(RuntimeError, match="device lost"):
                b.wait(p)
    finally:
        b.close()
