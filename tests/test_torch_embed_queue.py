"""The port's embed worker (``nornicdb_tpu_torch.embed.queue``) against the
JAX package's (``nornicdb_tpu.embed.queue``).

The cases of ``tests/test_embed_queue_depth.py`` run in both packages
(chunk boundaries, retry accounting, terminal failures, the claim set under
concurrent drains, the pre-write re-read); then the same seeded texts go
through both workers and the embeddings, chunk embeddings, statistics and
the ``on_embedded`` order must be equal, and the retry counter and the
debounced cluster trigger behave alike.
"""

import threading
import time

import numpy as np
import pytest

from nornicdb_tpu.embed import base as JB
from nornicdb_tpu.embed import queue as JQ
from nornicdb_tpu.storage import MemoryEngine as JMemoryEngine
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.embed import base as PB
from nornicdb_tpu_torch.embed import queue as PQ
from nornicdb_tpu_torch.storage import MemoryEngine as PMemoryEngine
from nornicdb_tpu_torch.storage.types import Node as PNode

PKGS = {
    "jax": (JQ, JB.HashEmbedder, JMemoryEngine, JNode),
    "torch": (PQ, PB.HashEmbedder, PMemoryEngine, PNode),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)]
    out = []
    for i in range(n):
        k = int(rng.integers(1, 30)) if i % 5 else int(rng.integers(20, 60))
        out.append(" ".join(rng.choice(words, k)) + f" u{i}")
    return out


# ---- cases of tests/test_embed_queue_depth.py, in both packages
class TestChunkBoundaryMath:
    def test_exact_boundary_no_extra_chunk(self, pkg):
        Q = pkg[0]
        words = " ".join(f"w{i}" for i in range(512))
        assert len(Q.chunk_text(words, 512, 50)) == 1

    def test_overlap_windows_exact_starts(self, pkg):
        Q = pkg[0]
        words = " ".join(f"w{i}" for i in range(1000))
        chunks = Q.chunk_text(words, 512, 50)
        assert len(chunks) == 3  # starts at 0, 462, 924
        first_words = chunks[0].split()
        second_words = chunks[1].split()
        assert second_words[0] == "w462"  # step = 512 - 50
        assert first_words[-50:] == second_words[:50]  # exact overlap

    def test_degenerate_overlap_still_advances(self, pkg):
        Q = pkg[0]
        words = " ".join(f"w{i}" for i in range(30))
        chunks = Q.chunk_text(words, 10, 10)  # step clamps to 1
        assert len(chunks) >= 3
        assert chunks[0].split()[0] == "w0"

    def test_zero_vector_average_safe(self, pkg):
        Q = pkg[0]
        z = np.zeros(4, np.float32)
        assert np.all(np.isfinite(Q.average_embeddings([z, z])))


def _flaky(Hash, dims, fail_times):
    class Flaky(Hash):
        def __init__(self):
            super().__init__(dims)
            self.calls = 0

        def embed_batch(self, texts):
            self.calls += 1
            if self.calls <= fail_times:
                raise RuntimeError("transient backend failure")
            return super().embed_batch(texts)

    return Flaky()


class TestWorkerProcessing:
    def _worker(self, pkg, embedder=None, **cfg):
        Q, Hash, Mem, _ = pkg
        eng = Mem()
        w = Q.EmbedWorker(eng, embedder or Hash(16),
                          config=Q.EmbedWorkerConfig(retry_backoff=0.01,
                                                     **cfg))
        return eng, w

    def test_retry_then_success_counts_retries(self, pkg):
        Q, Hash, _, Node = pkg
        eng, w = self._worker(pkg, embedder=_flaky(Hash, 16, 2),
                              max_retries=3)
        eng.create_node(Node(id="n1", properties={"content": "retry me"}))
        eng.mark_pending_embed("n1")
        w.drain()
        assert eng.get_node("n1").embedding is not None
        assert w.stats.retries == 2

    def test_terminal_failure_keeps_pending(self, pkg):
        Q, Hash, _, Node = pkg
        eng, w = self._worker(pkg, embedder=_flaky(Hash, 16, 99),
                              max_retries=2)
        eng.create_node(Node(id="n1", properties={"content": "doomed"}))
        eng.mark_pending_embed("n1")
        w.process_batch()
        assert w.stats.failed == 1
        assert "n1" in eng.pending_embed_ids()  # retried on a later scan
        assert eng.get_node("n1").embedding is None

    def test_concurrent_drains_no_duplicate_processing(self, pkg):
        Node = pkg[3]
        eng, w = self._worker(pkg)
        for i in range(40):
            eng.create_node(Node(id=f"n{i}",
                                 properties={"content": f"doc {i}"}))
            eng.mark_pending_embed(f"n{i}")
        totals = []
        lock = threading.Lock()

        def drain():
            n = w.drain()
            with lock:
                totals.append(n)

        threads = [threading.Thread(target=drain) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(totals) == 40  # every node handled exactly once
        assert w.stats.processed == 40
        assert eng.pending_embed_ids() == []

    def test_concurrent_touch_not_clobbered(self, pkg):
        Node = pkg[3]
        eng, w = self._worker(pkg)
        eng.create_node(Node(id="n1", properties={"content": "hot doc"}))
        eng.mark_pending_embed("n1")
        real_get = eng.get_node
        bumped = {"done": False}

        def racing_get(nid):
            node = real_get(nid)
            if not bumped["done"] and node.embedding is None:
                fresh = real_get(nid)
                fresh.access_count = 7
                eng.update_node(fresh)
                bumped["done"] = True
                return node  # the STALE copy: the re-read must rescue it
            return node

        eng.get_node = racing_get
        try:
            w.drain()
        finally:
            eng.get_node = real_get
        stored = eng.get_node("n1")
        assert stored.embedding is not None
        assert stored.access_count == 7


# ---- both packages on the same inputs
class TestParity:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_chunking_and_text(self, seed):
        for text in _texts(seed, 40):
            for tokens, overlap in ((8, 2), (16, 0), (5, 5), (512, 50)):
                assert PQ.chunk_text(text, tokens, overlap) == \
                    JQ.chunk_text(text, tokens, overlap)
        props = {"title": " T ", "name": "n", "other": "o", "content": ""}
        assert PQ.build_embedding_text(PNode(properties=props)) == \
            JQ.build_embedding_text(JNode(properties=props))
        only = {"b": "bee", "a": "ay", "n": 3}
        assert PQ.build_embedding_text(PNode(properties=only)) == \
            JQ.build_embedding_text(JNode(properties=only))

    @pytest.mark.parametrize("seed", [0, 3])
    def test_average_embeddings(self, seed):
        rng = np.random.default_rng(seed)
        vecs = list(rng.standard_normal((3, 24)).astype(np.float32))
        got, want = PQ.average_embeddings(vecs), JQ.average_embeddings(vecs)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)

    @pytest.mark.parametrize("seed,batch", [(0, 32), (2, 7)])
    def test_same_embeddings_and_stats(self, seed, batch):
        """One drain per package over the same 60 nodes (some of them
        chunked, one textless, one deleted before the drain): embeddings
        and chunk embeddings bit for bit, stats and the on_embedded order
        equal."""
        texts = _texts(seed, 60)
        out = {}
        for name, (Q, Hash, Mem, Node) in PKGS.items():
            eng = Mem()
            for i, t in enumerate(texts):
                eng.create_node(Node(id=f"n{i}", properties={"content": t}))
                eng.mark_pending_embed(f"n{i}")
            eng.create_node(Node(id="empty", properties={"k": 1}))
            eng.mark_pending_embed("empty")
            eng.delete_node("n3")
            seen = []
            w = Q.EmbedWorker(eng, Hash(32), Q.EmbedWorkerConfig(
                chunk_tokens=20, chunk_overlap=4, batch_size=batch),
                on_embedded=lambda n, seen=seen: seen.append(n.id))
            handled = w.drain()
            nodes = {n.id: n for n in eng.all_nodes()}
            out[name] = (handled, vars(w.stats).copy(), seen, nodes,
                         eng.pending_embed_ids())
        (hj, sj, oj, nj, pj), (ht, st, ot, nt, pt) = out["jax"], out["torch"]
        assert (ht, st, ot, pt) == (hj, sj, oj, pj)
        assert st["chunked_nodes"] > 0 and pt == []
        assert sorted(nt) == sorted(nj)
        for nid, n in nt.items():
            want = nj[nid]
            if want.embedding is None:
                assert n.embedding is None
                continue
            assert n.embedding.dtype == np.float32
            assert np.array_equal(n.embedding, want.embedding), nid
            assert len(n.chunk_embeddings or []) == len(
                want.chunk_embeddings or [])
            for a, b in zip(n.chunk_embeddings or [],
                            want.chunk_embeddings or []):
                assert np.array_equal(a, b)

    def test_retries_counted_in_the_registry(self):
        """Every retried attempt increments nornicdb_embed_retries_total
        and the component error counter; the terminal one only the
        latter, as in the JAX package."""
        from nornicdb_tpu_torch.telemetry.metrics import REGISTRY

        def cells():
            retries = REGISTRY._families[
                "nornicdb_embed_retries_total"].labels().value
            errors = REGISTRY._families[
                "nornicdb_component_errors_total"].labels("embed_queue").value
            return retries, errors

        r0, e0 = cells()
        eng = PMemoryEngine()
        eng.create_node(PNode(id="n1", properties={"content": "x"}))
        eng.mark_pending_embed("n1")
        w = PQ.EmbedWorker(eng, _flaky(PB.HashEmbedder, 8, 99),
                           PQ.EmbedWorkerConfig(max_retries=3,
                                                retry_backoff=0.001))
        assert w.process_batch() == 0
        r1, e1 = cells()
        assert (r1 - r0, e1 - e0) == (2, 3)
        assert (w.stats.retries, w.stats.failed) == (3, 1)

    def test_background_worker_and_debounced_cluster(self):
        """The started worker drains on its own; the cluster trigger fires
        once after cluster_min_new embeddings settle for the quiet
        period, and an on_embedded failure is counted, not fatal."""
        fired = []
        eng = PMemoryEngine()
        w = PQ.EmbedWorker(
            eng, PB.HashEmbedder(8),
            PQ.EmbedWorkerConfig(poll_interval=0.01,
                                 cluster_quiet_period=0.05,
                                 cluster_min_new=3),
            on_cluster_trigger=lambda: fired.append(time.monotonic()),
            on_embedded=lambda n: 1 / 0 if n.id == "n1" else None)
        w.start()
        try:
            for i in range(5):
                eng.create_node(PNode(id=f"n{i}",
                                      properties={"content": f"t {i}"}))
                eng.mark_pending_embed(f"n{i}")
            deadline = time.monotonic() + 10
            while (not fired or eng.pending_embed_ids()) and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert w.running
        finally:
            w.stop()
        assert eng.pending_embed_ids() == [] and w.stats.processed == 5
        assert len(fired) == 1
        assert not w.running
