"""The port's GraphRAG service (``nornicdb_tpu_torch.genserve.graphrag``)
against the JAX package's, on the CPU.

One in-memory JAX ``DB`` (HashEmbedder, stored nodes, links) is handed to
both services: ``db`` is duck-typed, so retrieval and graph expansion are
the DB's own and the prompt must come out byte for byte the same. Each
service generates with its own engine over the same float32 QWEN_SMALL
parameters (the port's carried over with ``convert.qwen2_params_from_jax``)
and a hash tokenizer, so the answer text, sources, context counts and token
counts are equal too (timings excluded). Without an engine both answer
extractively, and agree there as well.
"""

import dataclasses

import jax
import numpy as np
import pytest

import nornicdb_tpu
from nornicdb_tpu.backend import BackendManager, FakeHooks
from nornicdb_tpu.config import GenServeConfig as JaxGenServeConfig
from nornicdb_tpu.embed import HashEmbedder
from nornicdb_tpu.genserve import GenerationEngine as JaxEngine
from nornicdb_tpu.genserve import graphrag as JG
from nornicdb_tpu.models import qwen2 as JQ
from nornicdb_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from nornicdb_tpu_torch import NotFoundError
from nornicdb_tpu_torch import genserve
from nornicdb_tpu_torch.config import GenServeConfig
from nornicdb_tpu_torch.convert import qwen2_params_from_jax
from nornicdb_tpu_torch.genserve import GenerationEngine, GraphRAGService
from nornicdb_tpu_torch.genserve import graphrag as TG
from nornicdb_tpu_torch.models import qwen2 as TQ
from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

JCFG = dataclasses.replace(JQ.QWEN_SMALL, dtype="float32")
TCFG = dataclasses.replace(TQ.QWEN_SMALL, dtype="float32")
JPARAMS = JQ.init_params(JCFG, jax.random.PRNGKey(0))
TPARAMS = qwen2_params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
# no deadline: the JAX engine's predictive admission reads a process-wide
# cost model that other test files train. A sequence holds 512 tokens: the
# packed prompts (~200 tokens) fit whole, so none loses its header to the
# engine's tail trim
ENGINE_KW = dict(page_size=16, pool_pages=65, max_seqs=2, max_seq_tokens=512,
                 prefill_chunk=64, deadline_ms=0, rag_max_new_tokens=12)

DOCS = [
    "paged caches share fixed-size pages across sequences",
    "continuous batching interleaves prefill with decode",
    "the graph holds nodes and relationships between them",
    "vector search finds the nearest memories of a query",
    "the prefix cache reuses pages of a shared prompt header",
    "deadline shedding keeps every caller bounded",
    "heimdall answers questions about the graph",
]
LINKS = [(0, 1, "RELATED_TO"), (4, 0, "EXTENDS"), (2, 6, "DESCRIBES"),
         (3, 2, "SEARCHES"), (1, 5, "RELATED_TO"), (0, 4, "SHARES")]
QUESTIONS = ["what is a paged cache?", "how are prompts shared?",
             "who answers questions about the graph?",
             "search the nearest memories"]


@pytest.fixture(scope="module")
def db():
    d = nornicdb_tpu.open_db("")
    d.set_embedder(HashEmbedder(64))
    ids = [d.store(t).id for t in DOCS]
    for a, b, rel in LINKS:
        d.link(ids[a], ids[b], rel)
    d.process_pending_embeddings()
    yield d
    d.close()


@pytest.fixture
def engines():
    """(JAX engine, port engine) per mode, stopped after the test."""
    live = []

    def make(mode: str):
        mgr = BackendManager(hooks=FakeHooks("ok"), acquire_timeout=0.5,
                             probe_interval=0.05, probe_timeout=0.4,
                             degrade_after=1, recover_after=1)
        jeng = JaxEngine(JPARAMS, JCFG, tokenizer=JaxHashTokenizer(512),
                         config=JaxGenServeConfig(mode=mode, **ENGINE_KW),
                         manager=mgr)
        teng = GenerationEngine(TPARAMS, TCFG, tokenizer=HashTokenizer(512),
                                config=GenServeConfig(mode=mode, **ENGINE_KW),
                                device="cpu")
        live.extend([jeng, teng, mgr])
        return jeng, teng

    yield make
    for obj in live:
        obj.stop()


def _strip(answer: dict) -> dict:
    out = dict(answer)
    assert set(out.pop("timings_ms")) == {"retrieve", "total"}
    return out


class _WithEngine:
    """The DB with an engine behind ``genserve_engine()``, as the JAX DB
    exposes the one it built for Heimdall."""

    def __init__(self, db, engine):
        self._db, self._engine = db, engine
        self.storage = db.storage

    def recall(self, question, limit):
        return self._db.recall(question, limit=limit)

    def genserve_engine(self):
        return self._engine


class TestParityWithJax:
    def test_header_is_byte_identical(self):
        assert TG._PROMPT_HEADER.encode() == JG._PROMPT_HEADER.encode()
        # long enough to fill several 16-slot KV pages of any tokenizer
        # that gives a word at least one token
        assert len(TG._PROMPT_HEADER.split()) > 3 * 16

    def test_prompt_string_is_jax_one(self, db):
        jsvc = JG.GraphRAGService(db, config=JaxGenServeConfig(**ENGINE_KW))
        tsvc = GraphRAGService(db, config=GenServeConfig(**ENGINE_KW))
        for q in QUESTIONS:
            for limit, budget in ((5, 100), (3, 40), (7, 400)):
                jh, je = jsvc.retrieve(q, limit)
                th, te = tsvc.retrieve(q, limit)
                assert [h["id"] for h in th] == [h["id"] for h in jh]
                assert [e.id for e in te] == [e.id for e in je]
                prompt = tsvc.build_prompt(q, th, te, budget)
                assert prompt == jsvc.build_prompt(q, jh, je, budget)
                assert prompt.startswith(TG._PROMPT_HEADER)

    @pytest.mark.parametrize("mode", ["paged", "dense"])
    def test_engine_answers_match_jax(self, db, engines, mode):
        jeng, teng = engines(mode)
        jsvc = JG.GraphRAGService(db, engine=jeng,
                                  config=JaxGenServeConfig(**ENGINE_KW))
        tsvc = GraphRAGService(_WithEngine(db, teng),
                               config=GenServeConfig(**ENGINE_KW))
        for q in QUESTIONS:
            want = _strip(jsvc.answer(q))
            got = _strip(tsvc.answer(q))
            assert got == want
            assert got["mode"] == mode
            assert 1 <= got["generated_tokens"] <= ENGINE_KW[
                "rag_max_new_tokens"]
            assert got["sources"] and got["context"]["edges"] > 0
        # limit and token budget given per call
        want = _strip(jsvc.answer(QUESTIONS[0], limit=2, max_new_tokens=3))
        got = _strip(tsvc.answer(QUESTIONS[0], limit=2, max_new_tokens=3))
        assert got == want and got["context"]["nodes"] == 2
        if mode == "paged":
            # every prompt opens with the header: later answers reuse its
            # cached pages
            assert teng.stats.prefix_hits > 0
            assert got["prefix_reused_tokens"] > 0

    def test_extractive_answers_match_jax(self, db):
        jsvc = JG.GraphRAGService(db, config=JaxGenServeConfig(**ENGINE_KW))
        tsvc = GraphRAGService(db, config=GenServeConfig(**ENGINE_KW))
        assert db.genserve_engine() is None
        for q in QUESTIONS + ["zzz qqq"]:
            got = _strip(tsvc.answer(q))
            assert got == _strip(jsvc.answer(q))
            assert got["mode"] == "extractive" and got["answer"]
            assert got["generated_tokens"] == 0


class _Node:
    def __init__(self, props):
        self.properties = props


class _Edge:
    def __init__(self, id_, start, end, type_):
        self.id, self.start_node, self.end_node, self.type = (
            id_, start, end, type_)


class _Storage:
    def __init__(self):
        self.edges = {"a": [_Edge("e1", "a", "b", "R"), _Edge("e2", "a", "c",
                                                              "R")],
                      "b": [_Edge("e1", "a", "b", "R")]}

    def get_outgoing_edges(self, nid):
        if nid == "gone":
            raise NotFoundError(nid)
        if nid == "remote":
            raise NotImplementedError
        return [e for e in self.edges.get(nid, []) if e.start_node == nid]

    def get_incoming_edges(self, nid):
        return [e for e in self.edges.get(nid, []) if e.end_node == nid]


class _StandInDB:
    def __init__(self):
        self.storage = _Storage()

    def recall(self, question, limit):
        hits = [
            {"id": "a", "score": 0.9, "content": "alpha",
             "node": _Node({"content": "alpha node"})},
            {"id": "gone", "score": 0.8, "content": "deleted"},
            {"id": "b", "score": 0.7, "content": "beta",
             "node": _Node({"title": "beta", "rank": 2})},
            {"id": "remote", "score": 0.6, "content": "far away"},
        ]
        return hits[:limit]


class TestRetrievalAndPacking:
    def test_missing_nodes_skipped_and_edges_deduplicated(self):
        svc = GraphRAGService(_StandInDB(), config=GenServeConfig())
        hits, edges = svc.retrieve("q", 4)
        assert [h["id"] for h in hits] == ["a", "gone", "b", "remote"]
        # e1 is a's outgoing and b's incoming edge: listed once
        assert [e.id for e in edges] == ["e1", "e2"]
        prompt = svc.build_prompt("q", hits, edges, 400)
        assert "- [a] alpha node" in prompt  # the node's content
        assert "- [b] title=beta rank=2" in prompt  # its properties
        assert "- [gone] deleted" in prompt  # the hit's own content
        assert "- a -R-> b" in prompt and prompt.endswith("Question: q\nAnswer:")

    def test_budget_cuts_lines(self):
        svc = GraphRAGService(_StandInDB(), config=GenServeConfig())
        hits, edges = svc.retrieve("q", 4)
        header = len(TG._PROMPT_HEADER.split()) + 1
        prompt = svc.build_prompt("q", hits, edges, header + 4)
        assert "- [a] alpha node" in prompt and "[gone]" not in prompt
        # the section opens whenever there are edges, as in the JAX package
        assert "Relationships:" in prompt and "-R->" not in prompt

    def test_extractive_answer_without_engine(self):
        out = GraphRAGService(_StandInDB(), config=GenServeConfig()).answer("q")
        assert out["mode"] == "extractive"
        assert out["answer"].splitlines()[1:] == [
            "- alpha node", "- deleted", "- title=beta rank=2"]
        assert out["context"]["nodes"] == 4 and out["context"]["edges"] == 2

    def test_config_defaults_to_the_process_one(self):
        mine = GenServeConfig(rag_context_nodes=2)
        genserve.configure(mine)
        try:
            svc = GraphRAGService(_StandInDB())
            assert svc.config is mine
            assert svc.answer("q")["context"]["nodes"] == 2
        finally:
            genserve.configure(None)
