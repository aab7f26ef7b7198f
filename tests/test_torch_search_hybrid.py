"""The port's hybrid search (BM25, RRF fusion, MMR, HNSW, the cross-encoder
rerank, the write-behind uploader and ``SearchService.search``) against the
JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds. Both services index the same
nodes from their own ``MemoryEngine`` through storage events, embed with
``HashEmbedder`` (the same vectors in both packages) and run in exact mode.
Tolerances:
- BM25 scores and fused RRF scores: within 1e-9 (the same float64
  arithmetic in the same order; the ids must be identical, in order);
- vector scores: within 1e-5 (float32 sums of bf16 products, run in another
  order by XLA and by PyTorch);
- fusion, MMR, HNSW: identical (the same Python and numpy code);
- cross-encoder scores (float32 config, carried weights): within 1e-5, and
  the same order.
"""

import dataclasses
import sys
import threading
import time

import jax
import numpy as np
import pytest

from nornicdb_tpu.embed import HashEmbedder as JaxHashEmbedder
from nornicdb_tpu.models import bge_m3 as JB
from nornicdb_tpu.search import bm25 as JBM
from nornicdb_tpu.search import fusion as JF
from nornicdb_tpu.search.hnsw import HNSWIndex as JaxHNSW
from nornicdb_tpu.search.rerank import CrossEncoderReranker as JaxReranker
from nornicdb_tpu.search.service import SearchConfig as JaxSearchConfig
from nornicdb_tpu.search.service import SearchService as JaxSearchService
from nornicdb_tpu.storage import MemoryEngine as JaxEngine
from nornicdb_tpu.storage.types import Node as JaxNode
from nornicdb_tpu_torch.convert import reranker_params_from_jax
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.models import bge_m3 as TB
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.search import bm25 as TBM
from nornicdb_tpu_torch.search import fusion as TF
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
from nornicdb_tpu_torch.search.rerank import CrossEncoderReranker
from nornicdb_tpu_torch.search.service import SearchConfig, SearchService
from nornicdb_tpu_torch.storage import MemoryEngine, Node

DIMS = 32
WORDS = ("graph node edge vector search index memory storage engine query "
         "batch token device shard corpus").split()
FT_TOL = 1e-9
VEC_TOL = 1e-5
RERANK_TOL = 1e-5
# a float32 cross-encoder small enough for the CPU
RERANK_CFG = dict(vocab_size=512, hidden=64, layers=2, heads=4,
                  intermediate=128, max_positions=300, dims=64,
                  dtype="float32")

# -- BM25 -------------------------------------------------------------------
BM25_DOCS = {
    "punct": ["Hello, world! graph-node: edges...", "hello (world) again",
              "no-match here; graph? node!"],
    "unicode": ["Straße café naïve", "café au lait", "日本語 テキスト café",
                "ÉCOLE école Ecole"],
    "repeated": ["graph graph graph node", "graph node node node",
                 "edge edge edge edge edge graph", "graph"],
    "stopwords": ["the graph of the nodes", "a graph and an edge",
                  "is it the one", "graph"],
}
BM25_QUERIES = ["graph node", "café", "hello world", "edge graph edge",
                "the", "école", "nothing matches", "GRAPH, node!"]


@pytest.mark.parametrize("text", [t for docs in BM25_DOCS.values()
                                  for t in docs] + BM25_QUERIES)
def test_tokenize_matches_jax(text):
    assert TBM.tokenize(text) == JBM.tokenize(text)


def _bm25_pair(docs):
    j, t = JBM.BM25Index(), TBM.BM25Index()
    for i, d in enumerate(docs):
        j.index(f"d{i}", d)
        t.index(f"d{i}", d)
    return j, t


def _same_ranked(a, b, tol):
    assert [i for i, _ in a] == [i for i, _ in b]
    assert np.allclose([s for _, s in a], [s for _, s in b], rtol=0, atol=tol)


@pytest.mark.parametrize("name", sorted(BM25_DOCS))
def test_bm25_matches_jax(name):
    """The same ids in the same order and scores within 1e-9, before and
    after removals and re-indexing."""
    j, t = _bm25_pair(BM25_DOCS[name])
    for q in BM25_QUERIES:
        _same_ranked(t.search(q, 10), j.search(q, 10), FT_TOL)
    for idx in (j, t):
        idx.remove("d1")
        idx.remove("missing")
        idx.index("d0", "graph café graph node replaced")  # re-index
        idx.index("d2", "")  # no tokens: the doc leaves the index
    assert len(t) == len(j)
    for q in BM25_QUERIES:
        _same_ranked(t.search(q, 3), j.search(q, 3), FT_TOL)


def test_bm25_ties_order_by_id_and_random_corpus_matches_jax():
    rng = np.random.default_rng(31)
    docs = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 12))))
            for _ in range(300)]
    j, t = _bm25_pair(docs)
    for _ in range(20):
        q = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 5))))
        _same_ranked(t.search(q, 40), j.search(q, 40), FT_TOL)
    same = TBM.BM25Index()
    for i in (3, 1, 2):
        same.index(f"s{i}", "graph node")
    assert [i for i, _ in same.search("graph")] == ["s1", "s2", "s3"]


# -- fusion and MMR ---------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fusion_and_mmr_match_jax(seed):
    rng = np.random.default_rng(seed)
    ids = [f"i{k}" for k in range(30)]
    lists = {"vector": list(rng.permutation(ids)[:20]),
             "fulltext": list(rng.permutation(ids)[:15])}
    n_words = int(rng.integers(1, 12))
    query = " ".join(rng.choice(WORDS, size=n_words))
    assert TF.adaptive_rrf_weights(query) == JF.adaptive_rrf_weights(query)
    w = TF.adaptive_rrf_weights(query)
    for k0 in (60.0, 1.0):
        assert TF.fuse_rrf(lists, w, k0) == JF.fuse_rrf(lists, w, k0)
    fused = TF.fuse_rrf(lists, w)
    order = [i for i, _ in fused]
    rel = dict(fused)
    vecs = rng.standard_normal((30, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    vmap = {i: v for i, v in zip(ids, vecs) if rng.random() > 0.2}
    for limit, lam in ((5, 0.7), (10, 0.3), (40, 0.5)):
        assert TF.apply_mmr(order, rel, vmap, limit, lam) == JF.apply_mmr(
            order, rel, vmap, limit, lam)


# -- HNSW -------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_hnsw_same_neighbours_as_jax(seed):
    """One seed and one insertion order give the same graph: the same
    neighbours and scores, also after tombstones and the rebuild they
    trigger."""
    rng = np.random.default_rng(100 + seed)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    j = JaxHNSW(dims=16, m=8, ef_construction=40, seed=seed)
    t = HNSWIndex(dims=16, m=8, ef_construction=40, seed=seed)
    for i, v in enumerate(vecs):
        j.add(f"h{i}", v)
        t.add(f"h{i}", v)
    qs = rng.standard_normal((10, 16)).astype(np.float32)
    for q in qs:
        assert t.search(q, 10) == j.search(q, 10)
    for i in range(0, 300, 4):  # past the tombstone ratio: a rebuild
        assert t.remove(f"h{i}") == j.remove(f"h{i}")
    assert len(t) == len(j) and t.tombstone_ratio() == j.tombstone_ratio()
    for q in qs:
        assert t.search(q, 10, ef=80) == j.search(q, 10, ef=80)


# -- cross-encoder ----------------------------------------------------------
def _rerankers():
    cfg = JB.BgeConfig(**RERANK_CFG)
    jr = JaxReranker(cfg=cfg, seed=3, max_len=64)
    params, head = reranker_params_from_jax(
        jax.tree.map(np.asarray, jr.params),
        jax.tree.map(np.asarray, jr.head), device="cpu")
    tr = CrossEncoderReranker(cfg=TB.BgeConfig(**RERANK_CFG), params=params,
                              head=head, max_len=64, device="cpu")
    return jr, tr


def test_cross_encoder_matches_jax():
    jr, tr = _rerankers()
    rng = np.random.default_rng(9)
    docs = [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 40))))
            for _ in range(12)]
    query = "graph vector search"
    want = jr.score_pairs(query, docs)
    got = tr.score_pairs(query, docs)
    assert got.dtype == np.float32 and got.shape == (12,)
    assert np.allclose(got, want, rtol=0, atol=RERANK_TOL)
    cands = [(f"c{i}", d) for i, d in enumerate(docs)]
    assert [i for i, _ in tr.rerank(query, cands)] == [
        i for i, _ in jr.rerank(query, cands)]
    assert tr.rerank(query, cands, limit=3) == tr.rerank(query, cands)[:3]
    assert tr.score_pairs(query, []).shape == (0,)


def test_cross_encoder_defaults_draw_from_a_seed():
    a = CrossEncoderReranker(seed=4, device="cpu")
    b = CrossEncoderReranker(seed=4, device="cpu")
    assert np.array_equal(a.score_pairs("q x", ["d one", "d two"]),
                          b.score_pairs("q x", ["d one", "d two"]))
    assert a.head["w"].shape == (a.cfg.dims,) and float(a.head["b"]) == 0.0


# -- SearchService.search ---------------------------------------------------
def _texts(rng, n):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 9))))
            + f" uniq{i}" for i in range(n)]


class _Pair:
    """A JAX and a port service over their own engines, fed the same
    nodes through storage events."""

    def __init__(self, n=60, embed=True, seed=0, **cfg):
        emb_j = JaxHashEmbedder(DIMS) if embed else None
        emb_t = HashEmbedder(DIMS) if embed else None
        self.je, self.te = JaxEngine(), MemoryEngine()
        self.js = JaxSearchService(self.je, emb_j, dims=DIMS,
                                   config=JaxSearchConfig(exact=True, **cfg))
        self.ts = SearchService(self.te, emb_t, dims=DIMS,
                                config=SearchConfig(exact=True, **cfg),
                                device="cpu")
        self.js.attach(self.je)
        self.ts.attach(self.te)
        self.hash = HashEmbedder(DIMS)
        rng = np.random.default_rng(seed)
        self.texts = _texts(rng, n)
        for i, text in enumerate(self.texts):
            self.create(f"n{i}", text)

    def create(self, id_, text, embedded=True):
        emb = self.hash.embed(text) if embedded else None
        self.je.create_node(JaxNode(id=id_, properties={"content": text},
                                    embedding=emb))
        self.te.create_node(Node(id=id_, properties={"content": text},
                                 embedding=emb))

    def update_text(self, id_, text):
        for eng in (self.je, self.te):
            node = eng.get_node(id_)
            node.properties["content"] = text
            node.embedding = self.hash.embed(text)
            eng.update_node(node)

    def delete(self, id_):
        self.je.delete_node(id_)
        self.te.delete_node(id_)

    def check(self, query, **kw):
        want = self.js.search(query, **kw)
        got = self.ts.search(query, **kw)
        _same_results(got, want)
        return got

    def close(self):
        self.js.shutdown()
        self.ts.shutdown()


def _same_results(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= FT_TOL
        for key, tol in (("vector_score", VEC_TOL), ("fulltext_score", FT_TOL)):
            assert (g[key] is None) == (w[key] is None), key
            if g[key] is not None:
                assert abs(g[key] - w[key]) <= tol, key
        assert g["content"] == w["content"] and g["labels"] == w["labels"]
        assert g["node"].id == g["id"]


def _count_ranks(svc):
    calls = []
    inner = svc._rank

    def counted(*a, **kw):
        calls.append(a[0])
        return inner(*a, **kw)

    svc._rank = counted
    return calls


def _case_vector_only(p):
    vec = p.hash.embed(p.texts[3])
    got = p.check("", query_embedding=vec)
    assert got[0]["id"] == "n3" and got[0]["fulltext_score"] is None


def _case_text_only(p):
    got = p.check(p.texts[5])
    assert got[0]["id"] == "n5" and got[0]["vector_score"] is None
    p.check("graph node", limit=5)


def _case_both(p):
    for i in (0, 7, 19):
        got = p.check(p.texts[i])
        assert got[0]["id"] == f"n{i}"
        assert got[0]["vector_score"] is not None
        assert got[0]["fulltext_score"] is not None
    for q in ("graph", "vector search index memory storage engine query "
              "batch token", "uniq11 device"):  # the three weightings
        p.check(q, limit=7)


def _case_min_similarity(p):
    for ms in (0.3, 0.9):
        p.check(p.texts[2], min_similarity=ms)


def _case_cache_hit(p):
    ranks = _count_ranks(p.ts)
    first = p.check(p.texts[4])
    again = p.check(p.texts[4])
    assert ranks == [p.texts[4]]
    assert [(r["id"], r["score"]) for r in again] == [
        (r["id"], r["score"]) for r in first]
    p.check(p.texts[4], limit=3)  # another key: ranked again
    assert len(ranks) == 2


def _case_invalidate_update(p):
    ranks = _count_ranks(p.ts)
    p.check(p.texts[6])
    p.update_text("n6", "completely different words uniqX")
    got = p.check(p.texts[6])
    assert len(ranks) == 2 and "n6" not in [r["id"] for r in got[:1]]
    got = p.check("completely different words uniqX")
    assert got[0]["id"] == "n6"
    # a touch (access count only) keeps the ranking cached
    node = p.te.get_node("n6")
    node.access_count += 1
    gen = p.ts._generation
    p.te.update_node(node)
    assert p.ts._generation == gen
    p.ts.search("completely different words uniqX")
    assert len(ranks) == 3


def _case_invalidate_delete(p):
    ranks = _count_ranks(p.ts)
    got = p.check(p.texts[8])
    assert got[0]["id"] == "n8"
    p.delete("n8")
    got = p.check(p.texts[8])
    assert len(ranks) == 2 and "n8" not in [r["id"] for r in got]
    assert not p.ts.corpus().has("n8")


def _case_attach_detach(p):
    p.js.detach(p.je)
    p.ts.detach(p.te)
    p.create("late", "late arrival uniqLate")
    got = p.check("late arrival uniqLate")
    assert "late" not in [r["id"] for r in got]
    p.js.attach(p.je)
    p.ts.attach(p.te)
    p.update_text("late", "late arrival uniqLate again")
    got = p.check("late arrival uniqLate again")
    assert got[0]["id"] == "late"
    assert p.ts.build_indexes() == p.js.build_indexes() == len(p.texts) + 1


def _case_mmr(p):
    for i in (1, 12):
        p.check(p.texts[i], limit=5)
    p.check("graph node edge", limit=4)


def _case_rerank(p):
    jr, tr = _rerankers()
    p.js.set_reranker(jr)
    p.ts.set_reranker(tr)
    for i in (2, 9):
        p.check(p.texts[i])
    p.delete("n9")  # a missing node keeps its head position
    p.check("graph node edge vector", limit=5)


def _case_hnsw(p):
    assert p.ts.corpus() is None and p.ts._hnsw is not None
    for i in (0, 13):
        p.check(p.texts[i])
    p.delete("n13")
    p.check(p.texts[13])


def _case_write_behind(p):
    corpus = p.ts.corpus()
    assert corpus._uploader is not None
    deadline = time.monotonic() + 10
    while corpus.sync_stats.uploader_runs == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert corpus.sync_stats.uploader_runs > 0
    for i in (3, 30):
        p.check(p.texts[i])
    p.update_text("n30", "rewritten behind uniqWB")
    assert p.check("rewritten behind uniqWB")[0]["id"] == "n30"
    p.close()
    assert corpus._uploader is None


SEARCH_CASES = {
    "vector_only": ({}, {}, _case_vector_only),
    "text_only": ({"embed": False}, {}, _case_text_only),
    "both": ({}, {}, _case_both),
    "min_similarity": ({}, {}, _case_min_similarity),
    "cache_hit": ({}, {}, _case_cache_hit),
    "invalidate_update": ({}, {}, _case_invalidate_update),
    "invalidate_delete": ({}, {}, _case_invalidate_delete),
    "attach_detach": ({}, {}, _case_attach_detach),
    "mmr": ({}, {"mmr_enabled": True, "mmr_lambda": 0.5}, _case_mmr),
    "rerank": ({}, {"rerank_enabled": True, "rerank_candidates": 6},
               _case_rerank),
    "hnsw": ({}, {"backend": "hnsw"}, _case_hnsw),
    "write_behind": ({}, {"write_behind": True}, _case_write_behind),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_matches_jax(case):
    pair_kw, cfg, run = SEARCH_CASES[case]
    p = _Pair(**pair_kw, **cfg)
    try:
        run(p)
    finally:
        p.close()


# -- the port's own contracts ----------------------------------------------
def test_backend_choice():
    with pytest.raises(ValueError, match="ROADMAP A7"):
        SearchService(config=SearchConfig(backend="sharded"), device="cpu")
    with pytest.raises(ValueError, match="unknown search backend"):
        SearchService(config=SearchConfig(backend="gpu"), device="cpu")
    svc = SearchService(config=SearchConfig(backend="tpu"), device="cpu")
    svc.index_vectors(["a"], np.ones((1, 4), np.float32))
    assert isinstance(svc.corpus(), DeviceCorpus)
    with pytest.raises(ValueError, match="storage"):
        svc.search("a")  # no storage: vector_candidates only


def test_config_defaults_match_jax():
    want = {f.name: f.default for f in dataclasses.fields(JaxSearchConfig)}
    for f in dataclasses.fields(SearchConfig):
        assert f.default == want[f.name], f.name


def test_rank_cache_is_bounded_and_expires():
    p = _Pair(n=20)
    try:
        p.ts._rank_cache_max = 4
        for i in range(6):
            p.ts.search(p.texts[i])
        assert list(k[0] for k in p.ts._rank_cache) == p.texts[2:6]
        ranks = _count_ranks(p.ts)
        p.ts._rank_cache_ttl = 0.0  # every entry is past its TTL
        p.ts.search(p.texts[5])
        assert ranks == [p.texts[5]]
    finally:
        p.close()


def test_uploader_patches_without_a_query_and_counts_failures():
    rng = np.random.default_rng(41)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    c = DeviceCorpus(dims=16, device="cpu")
    c.add_batch([f"u{i}" for i in range(600)], vecs)
    c.search(vecs[:1], k=1)  # the first (full) upload on the query path
    c.start_uploader(interval=0.001)
    try:
        stall = c.sync_stats.query_stall_s
        c.add("u5", vecs[7])
        c.remove("u300")
        deadline = time.monotonic() + 10
        while c._dirty_blocks and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not c._dirty_blocks and c.sync_stats.uploader_runs >= 1
        assert c.sync_stats.patches >= 1
        assert c.sync_stats.query_stall_s == stall  # not query time
        dev = c._dev.numpy()
        assert np.array_equal(dev[5], c._host[5])
        assert not c._dev_valid.numpy()[300]
        # a failed pass is logged and counted; the thread lives on and the
        # next query's sync patches what it left
        real = c._apply_patch
        c._apply_patch = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("patch failed"))
        c.add("u6", vecs[8])
        while c.sync_stats.uploader_errors == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert c.sync_stats.uploader_errors == 1
        c._apply_patch = real
        assert c._uploader.is_alive()
        assert c.search(vecs[8], k=1, exact=True)[0][0][0] in ("u6", "u8")
        assert np.array_equal(c._dev.numpy()[6], c._host[6])
    finally:
        c.stop_uploader()
    assert c._uploader is None


def test_concurrent_writes_are_read_back():
    """Writers and searchers on one service with the rank cache and the
    uploader on: every acknowledged write is found by the next search for
    its text, and no search that starts after a delete was acknowledged
    serves the deleted node."""
    eng = MemoryEngine()
    svc = SearchService(eng, HashEmbedder(DIMS), dims=DIMS,
                        config=SearchConfig(write_behind=True), device="cpu")
    svc.attach(eng)
    hasher = HashEmbedder(DIMS)
    rng = np.random.default_rng(5)
    for i, text in enumerate(_texts(rng, 80)):
        eng.create_node(Node(id=f"b{i}", properties={"content": text},
                             embedding=hasher.embed(text)))
    errors = []
    deleted_at = {}  # id -> when its delete_node returned
    stop = threading.Event()

    def writer(w):
        try:
            for j in range(12):
                text = f"writer{w} item{j} fresh"
                nid = f"w{w}_{j}"
                eng.create_node(Node(id=nid, properties={"content": text},
                                     embedding=hasher.embed(text)))
                assert nid in [r["id"] for r in svc.search(text)]
                text2 = text + " changed"
                node = eng.get_node(nid)
                node.properties["content"] = text2
                node.embedding = hasher.embed(text2)
                svc.search(text2)  # cache a ranking from before the update
                eng.update_node(node)
                assert svc.search(text2)[0]["id"] == nid
                if j % 2:
                    eng.delete_node(nid)
                    deleted_at[nid] = time.perf_counter()
                    assert nid not in [r["id"] for r in svc.search(text2)]
        except Exception as e:  # noqa: BLE001 - re-raised on the main thread
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                start = time.perf_counter()
                for r in svc.search("graph node fresh changed"):
                    assert deleted_at.get(r["id"], start) >= start, r["id"]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = ([threading.Thread(target=writer, args=(w,)) for w in range(6)]
               + [threading.Thread(target=reader) for _ in range(3)])
    try:
        for th in threads:
            th.start()
        for th in threads[:6]:
            th.join(timeout=120)
        stop.set()
        for th in threads[6:]:
            th.join(timeout=30)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        svc.shutdown()
    assert not errors, errors[0]
    assert not any(th.is_alive() for th in threads)
    assert len(svc._vectors) == 80 + 6 * 6
