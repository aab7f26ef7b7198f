"""Every query of ``tests/data/cypher_corpus.json`` (the reference's own
Cypher test corpus, harvested by ``benchmarks/cypher_corpus_probe.py``)
through both packages on the same fixture, results held equal.

Each chunk of the corpus runs in order against one in-memory DB of each
package built from the probe's fixture. ``uuid.uuid4`` and ``time.time``
are seeded counters and ``random`` is seeded for each package's pass, so
both packages mint the same ids, read the same clock and draw the same
random numbers: entities compare by id, labels (or type) and properties. Queries that read the clock (``timestamp()``,
``datetime()`` and kin) compare their outcome, columns and row count
only; ``nornicdb.decay.info()`` reads both packages' decay managers and
compares in full. Queries that call APOC, GDS or
the Kalman functions run in both packages and compare like every other
query, and so do the procedure and function listings; PageRank's float32
ranks agree within rtol 1e-5 (``index_add_`` against XLA's
``segment_sum`` sums in another order). Also the JAX
suite's own checks of the corpus against the port: no unexplained failure in a sample of passing
queries, and negative queries still error.
"""

import json
import math
import os
import random
import re
import sys
import time
import uuid

import numpy as np
import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.db import Config as JaxConfig
from nornicdb_tpu.embed import HashEmbedder as JaxHashEmbedder
from nornicdb_tpu.errors import NornicError as JaxNornicError
from nornicdb_tpu_torch.db import Config as PortConfig
from nornicdb_tpu_torch.embed import HashEmbedder as PortHashEmbedder
from nornicdb_tpu_torch.errors import NornicError as PortNornicError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.cypher_corpus_probe import _guess_params  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data", "cypher_corpus.json")
with open(DATA) as _f:
    CORPUS = json.load(_f)
QUERIES = [r["query"] for r in CORPUS["queries"]]
CHUNK = 100
CHUNKS = [(i, min(i + CHUNK, len(QUERIES)))
          for i in range(0, len(QUERIES), CHUNK)]

_CLOCK = re.compile(
    r"timestamp\s*\(|datetime|date\s*\(|time\s*\(|duration\.|"
    r"localtime|localdatetime|now\s*\(|\.realtime|\.statement|"
    r"\.transaction|dbms\.|db\.stats|db\.info|apoc\.date",
    re.IGNORECASE)


_PAGERANK = re.compile(r"pagerank", re.IGNORECASE)
PR_RTOL, PR_ATOL = 1e-5, 1e-9


def _close(a, b) -> bool:
    """``a`` and ``b`` (``norm`` forms) equal but for floats, which agree
    within PR_RTOL / PR_ATOL (``norm`` writes a float as its repr)."""
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if a == b:
        return True
    try:
        return math.isclose(float(a), float(b), rel_tol=PR_RTOL,
                            abs_tol=PR_ATOL)
    except (TypeError, ValueError):
        return False


def build_fixture(db, embedder_cls):
    """The probe's standard graph (``cypher_corpus_probe.build_fixture``),
    for either package."""
    db.set_embedder(embedder_cls(32))
    ex = db.executor
    ex.execute("""
        CREATE (a:Person:Employee {name: 'Alice', age: 30, id: 'alice'}),
               (b:Person {name: 'Bob', age: 25, id: 'bob'}),
               (c:Person {name: 'Charlie', age: 35, id: 'charlie'}),
               (co:Company {name: 'Acme', id: 'acme'}),
               (ci:City {name: 'Oslo'}),
               (a)-[:KNOWS {since: 2020}]->(b),
               (b)-[:KNOWS {since: 2021}]->(c),
               (a)-[:WORKS_AT]->(co),
               (co)-[:LOCATED_IN]->(ci)
    """)
    ex.execute("""
        CREATE (f:File:Node {id: 'file1', path: '/a.md', extension: '.md',
                             name: 'a.md', type: 'file'}),
               (ch:FileChunk:Node {id: 'chunk1', chunk_index: 0,
                                   text: 'chunk text'}),
               (f)-[:HAS_CHUNK {index: 0}]->(ch)
    """)
    ex.execute("CREATE (n:Node {id: 'node1', type: 'todo', title: 'T'})")
    ex.execute("CREATE (t:Test {name: 'probe', value: 7})")
    ex.execute("""
        CREATE (a2:Stop {id: 'A', name: 'A'}), (b2:Stop {id: 'B', name: 'B'}),
               (c2:Stop {id: 'C', name: 'C'}), (d2:Stop {id: 'D', name: 'D'}),
               (a2)-[:CONNECTS {weight: 1, distance: 1}]->(b2),
               (b2)-[:CONNECTS {weight: 2, distance: 2}]->(d2),
               (a2)-[:CONNECTS {weight: 5, distance: 5}]->(c2),
               (c2)-[:ROAD {distance: 1}]->(d2),
               (a2)-[:ROAD {distance: 3}]->(c2)
    """)
    mgr = db.database_manager
    for name in ("tenant_a", "tenant_b", "tenant_c", "test_db", "db1",
                 "db2", "test_db_a", "test_db_b"):
        mgr.create_database(name, if_not_exists=True)


def norm(v):
    """A package-neutral form of a result value: entities by id, labels or
    type, endpoints and properties (not timestamps); floats by repr;
    temporal values but durations by kind (``datetime()`` reads the
    wall clock, which the seeded ``time.time`` does not cover)."""
    if hasattr(v, "labels") and hasattr(v, "properties"):
        return ("node", v.id, sorted(v.labels), norm(v.properties))
    if hasattr(v, "start_node") and hasattr(v, "properties"):
        return ("edge", v.id, v.type, v.start_node, v.end_node,
                norm(v.properties))
    if isinstance(v, dict):
        if v.get("__temporal__") not in (None, "duration"):
            return ("temporal", v["__temporal__"])  # read from the clock
        return {str(k): norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.tolist())
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return "nan" if math.isnan(f) else repr(f)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    return (type(v).__name__, str(v))


class _Clock:
    """A seeded stand-in for ``time.time``: 1 ms a call from a fixed
    start, the same readings for each package's pass. JAX's own timing of
    its tracing and compiles (the PageRank and components programs that
    APOC and GDS reach) reads the clock without advancing it, so the JAX
    pass's readings stay those of the port's."""

    def __init__(self):
        self.t = 1.7e9

    def __call__(self):
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if caller.split(".")[0] not in ("jax", "jaxlib"):
            self.t += 0.001
        return self.t


class _Ids:
    """A seeded stand-in for ``uuid.uuid4``: the same sequence of ids for
    each package's pass."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return uuid.UUID(int=(0x1234 << 96) + self.n, version=4)


def run_pass(monkeypatch, pkg, config_cls, embedder_cls, errors, lo, hi):
    """The queries [lo, hi) in order on one fresh fixture DB of ``pkg``:
    one outcome per query."""
    monkeypatch.setattr(uuid, "uuid4", _Ids())
    monkeypatch.setattr(time, "time", _Clock())
    random.seed(1234)
    kwargs = {"device": "cpu"} if pkg is nornicdb_tpu_torch else {}
    db = pkg.open_db("", config_cls(embed_enabled=False), **kwargs)
    try:
        build_fixture(db, embedder_cls)
        out = []
        for q in QUERIES[lo:hi]:
            got = None
            for params in _guess_params(q):
                try:
                    r = db.executor.execute(q, params=params)
                    got = ("ok", list(r.columns), [norm(x) for x in r.rows])
                    break
                except errors as e:
                    got = ("err", type(e).__name__, str(e))
                except Exception as e:  # a crash compares too
                    got = ("crash", type(e).__name__, str(e))
                    break
            out.append(got)
        return out
    finally:
        db.close()


@pytest.mark.parametrize("lo,hi", CHUNKS,
                         ids=[f"{lo}-{hi}" for lo, hi in CHUNKS])
def test_corpus_chunk_same_results(monkeypatch, lo, hi):
    want = run_pass(monkeypatch, nornicdb_tpu, JaxConfig, JaxHashEmbedder,
                    JaxNornicError, lo, hi)
    got = run_pass(monkeypatch, nornicdb_tpu_torch, PortConfig,
                   PortHashEmbedder, PortNornicError, lo, hi)
    diffs = []
    for q, g, w in zip(QUERIES[lo:hi], got, want):
        if _PAGERANK.search(q) and g[0] == w[0] == "ok":
            # float32 ranks summed in another order (index_add_ against
            # XLA's segment_sum): within the PageRank tolerance of
            # tests/test_torch_graph_algos.py
            if not _close(g, w):
                diffs.append((q[:100], g, w))
        elif _CLOCK.search(q) or g[0] == "crash":
            if g[0] != w[0] or (g[0] == "ok" and (
                    g[1] != w[1] or len(g[2]) != len(w[2]))):
                diffs.append((q[:100], g, w))
        elif g != w:
            diffs.append((q[:100], g, w))
    assert not diffs, [(d[0], str(d[1])[:300], str(d[2])[:300]) for d in diffs]


def _fixture_db():
    db = nornicdb_tpu_torch.open_db("", device="cpu")
    build_fixture(db, PortHashEmbedder)
    return db


class TestCorpusDisposition:
    """The cases of ``tests/test_cypher_corpus.py`` against the port."""

    def test_no_unexplained_failures(self):
        fails = [r for r in CORPUS["queries"] if r["status"] == "fail"]
        assert not fails, [f["query"][:80] for f in fails]

    def test_corpus_breadth(self):
        assert len(CORPUS["queries"]) >= 2500
        assert CORPUS["counts"]["pass"] >= 2400

    def test_sampled_pass_queries_still_pass(self):
        rng = random.Random(0xC0FFEE)
        passing = [r for r in CORPUS["queries"] if r["status"] == "pass"]
        sample = rng.sample(passing, 150)
        db = _fixture_db()
        try:
            broken = []
            for r in sample:
                err = None
                for params in _guess_params(r["query"]):
                    try:
                        db.executor.execute(r["query"], params=params)
                        err = None
                        break
                    except PortNornicError as e:
                        err = str(e)[:90]
                if err is not None and not (
                    "already exists" in err
                    or "unique constraint" in err
                    or "limit reached" in err
                ):
                    broken.append((r["query"][:90], err))
            assert not broken, broken
        finally:
            db.close()

    def test_negative_queries_still_error(self):
        negatives = [r for r in CORPUS["queries"]
                     if r["status"] == "negative"]
        assert len(negatives) >= 50
        db = _fixture_db()
        try:
            accepted = []
            for r in negatives:
                try:
                    db.executor.execute(r["query"], params={})
                    accepted.append(r["query"][:90])
                except Exception:
                    pass
            assert len(accepted) <= len(negatives) * 0.15, accepted
        finally:
            db.close()
