"""The port's HTTP embedders and its data-directory commands, on the CPU.

- ``TestHttpEmbedders``: the port's copy of the case of
  ``tests/test_servers.py`` (``OllamaEmbedder`` and ``OpenAIEmbedder``
  against a local stub server that speaks both protocols; no egress), and
  both packages' embedders against the same stub, equal vector for vector.
- ``TestImportExport::test_cli_export_import``: the port's copy of the
  case of ``tests/test_io_rerank.py``, with ``--device cpu``.
- ``init``, ``shell``, ``import`` / ``export``, ``backup`` -> ``restore``
  and ``eval`` of the port against the JAX package's commands on the same
  data: the same printed lines (data paths aside), the same graph, and
  each package opening or restoring what the other wrote. Exactly equal:
  these commands run host code (``eval`` ranks through a 32-wide
  ``HashEmbedder``; its metrics are held equal to JAX's).
"""

from __future__ import annotations

import gzip
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu import embed as jax_embed
from nornicdb_tpu.cli import main as jax_cli
from nornicdb_tpu_torch import embed as port_embed
from nornicdb_tpu_torch.cli import main as port_cli


class _Stub(BaseHTTPRequestHandler):
    """Ollama's /api/embeddings and OpenAI's /v1/embeddings; every vector
    is a function of its text."""

    def log_message(self, *a):
        pass

    @staticmethod
    def _vec(text: str) -> list:
        rng = np.random.default_rng(sum(text.encode()) + len(text))
        return [float(v) for v in rng.standard_normal(5)]

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))
        if self.path == "/api/embeddings":
            out = {"embedding": self._vec(body["prompt"])}
        elif self.path == "/v1/embeddings":
            if self.headers.get("Authorization") != "Bearer sk-test":
                self.send_response(401)
                self.end_headers()
                return
            # answered out of order: the client sorts by index
            out = {"data": [
                {"index": i, "embedding": self._vec(t)}
                for i, t in reversed(list(enumerate(body["input"])))]}
        else:
            self.send_response(404)
            self.end_headers()
            return
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def stub():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


class TestHttpEmbedders:
    def test_ollama_and_openai_against_mock(self):
        """(ref: pkg/embed HTTP providers) — zero-egress image, so the tests
        run a local mock server speaking both protocols."""
        import json as _json

        class Mock(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = _json.loads(self.rfile.read(n))
                if self.path == "/api/embeddings":
                    out = {"embedding": [0.1, 0.2, 0.3]}
                elif self.path == "/v1/embeddings":
                    assert self.headers["Authorization"] == "Bearer sk-test"
                    out = {"data": [
                        {"index": i, "embedding": [float(i), 1.0]}
                        for i in range(len(body["input"]))
                    ]}
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = _json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Mock)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            from nornicdb_tpu_torch.embed import OllamaEmbedder, OpenAIEmbedder

            ollama = OllamaEmbedder(f"http://127.0.0.1:{srv.server_address[1]}")
            v = ollama.embed("hi")
            assert list(v) == pytest.approx([0.1, 0.2, 0.3])
            assert ollama.dimensions() == 3
            openai = OpenAIEmbedder(
                f"http://127.0.0.1:{srv.server_address[1]}", api_key="sk-test"
            )
            vs = openai.embed_batch(["a", "b"])
            assert [list(x) for x in vs] == [[0.0, 1.0], [1.0, 1.0]]
        finally:
            srv.shutdown()

    @pytest.mark.parametrize("kind", ["ollama", "openai"])
    def test_both_packages_embed_alike(self, stub, kind):
        texts = ["graph node", "vector search on the card", "", "é漢"]
        out = {}
        for name, mod in (("jax", jax_embed), ("torch", port_embed)):
            if kind == "ollama":
                e = mod.OllamaEmbedder(stub, model="m", dims=7)
            else:
                e = mod.OpenAIEmbedder(stub, model="m", api_key="sk-test",
                                       dims=7)
            assert e.dimensions() == 7 and e.model() == "m"
            vs = e.embed_batch(texts)
            one = e.embed(texts[1])
            out[name] = ([v.dtype for v in vs], [v.tolist() for v in vs],
                         one.tolist(), e.dimensions())
        assert out["torch"] == out["jax"]
        assert out["torch"][3] == 5  # the served width replaces the guess
        assert out["torch"][0] == [np.float32] * len(texts)

    def test_openai_key_refused_alike(self, stub):
        import urllib.error

        for mod in (jax_embed, port_embed):
            with pytest.raises(urllib.error.HTTPError) as e:
                mod.OpenAIEmbedder(stub, api_key="wrong").embed_batch(["a"])
            assert e.value.code == 401


class TestImportExport:
    def test_cli_export_import(self, tmp_path, capsys):
        d1 = str(tmp_path / "db1")
        db = nornicdb_tpu_torch.open_db(d1, device="cpu")
        db.cypher("CREATE (:T {v: 1})-[:L]->(:T {v: 2})")
        db.flush(); db.close()
        out_file = str(tmp_path / "dump.json")
        port_cli(["--data-dir", d1, "export", out_file, "--device", "cpu"])
        d2 = str(tmp_path / "db2")
        port_cli(["--data-dir", d2, "import", out_file, "--device", "cpu"])
        db2 = nornicdb_tpu_torch.open_db(d2, device="cpu")
        assert db2.cypher("MATCH (t:T) RETURN count(t)").rows == [[2]]
        assert db2.cypher("MATCH ()-[l:L]->() RETURN count(l)").rows == [[1]]
        db2.close()


# ----------------------------------------------- the port's commands vs JAX
_WORDS = ["graph", "vector", "search", "node", "edge", "query", "memory",
          "card", "index", "label", "path", "score", "tensor", "kernel"]
DOCS = [" ".join(np.random.default_rng(i).choice(_WORDS, 4, replace=False))
        + f" note{i}" for i in range(24)]


def _run(cli, argv, capsys, tmp_path) -> tuple:
    """(exit code, printed lines with the test's directory as <tmp>)."""
    rc = cli(argv)
    lines = capsys.readouterr().out.replace(str(tmp_path), "<tmp>")
    return rc, lines.replace("<tmp>/jax", "<tmp>/X").replace(
        "<tmp>/port", "<tmp>/X")


def _fill(open_db, d: str) -> None:
    """The same graph in either package: a Cypher CREATE, and the DOCS
    stored with their 32-wide hash embeddings (no embedding left pending,
    so no background worker orders the index)."""
    db = open_db(d)
    pkg = nornicdb_tpu if open_db is _JAX_OPEN else nornicdb_tpu_torch
    emb = (jax_embed if pkg is nornicdb_tpu else port_embed).HashEmbedder(32)
    try:
        db.cypher("CREATE (:City {name: 'Oslo', pop: 700000})"
                  "-[:IN {since: 1814}]->(:Country {name: 'Norway'})")
        for i, text in enumerate(DOCS):
            db.storage.create_node(pkg.storage.Node(
                id=f"doc{i}", labels=["Doc"],
                properties={"content": text, "i": i},
                embedding=emb.embed(text)))
        db.flush()
    finally:
        db.close()


def _graph(open_db, d: str) -> tuple:
    db = open_db(d)
    try:
        nodes = sorted((n.id, sorted(n.labels),
                        json.dumps(n.properties, sort_keys=True, default=str),
                        None if n.embedding is None
                        else np.asarray(n.embedding).tolist())
                       for n in db.storage.all_nodes())
        edges = sorted((e.id, e.type, e.start_node, e.end_node,
                        json.dumps(e.properties, sort_keys=True))
                       for e in db.storage.all_edges())
        return nodes, edges
    finally:
        db.close()


_JAX_OPEN = nornicdb_tpu.open_db


def _PORT_OPEN(d):
    return nornicdb_tpu_torch.open_db(d, device="cpu")


class TestCommandsAgainstJax:
    def test_init_alike_and_each_opens_the_other(self, tmp_path, capsys):
        dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
        want = _run(jax_cli, ["--data-dir", dj, "init"], capsys, tmp_path)
        got = _run(port_cli, ["--data-dir", dp, "init", "--device", "cpu"],
                   capsys, tmp_path)
        assert got == want == (0, "initialized data directory <tmp>/X\n")
        assert _graph(_JAX_OPEN, dp) == _graph(_PORT_OPEN, dj) == ([], [])

    def test_commands_need_the_card_unless_cpu_is_named(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("the default device is present here")
        for argv in (["init"], ["export", "-"], ["backup"],
                     ["restore", "x.json.gz"], ["eval", "suite.json"],
                     ["shell"], ["import", "x.json"]):
            d = str(tmp_path / argv[0])
            with pytest.raises(SystemExit) as e:
                port_cli(["--data-dir", d] + argv)
            assert "CUDA is not available" in str(e.value)
            assert not (tmp_path / argv[0]).exists()  # nothing opened

    def test_export_import_alike(self, tmp_path, capsys):
        dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
        _fill(_JAX_OPEN, dj)
        _fill(_PORT_OPEN, dp)
        fj, fp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
        want = _run(jax_cli, ["--data-dir", dj, "export", fj], capsys,
                    tmp_path)
        got = _run(port_cli, ["--data-dir", dp, "export", fp, "--device",
                              "cpu"], capsys, tmp_path)
        assert (got[0], got[1].replace("p.json", "j.json")) == want
        dumps = [json.load(open(f)) for f in (fj, fp)]
        # node ids the Cypher CREATE generated differ; the rest is equal
        for dump in dumps:
            for n in dump["nodes"]:
                if not n["id"].startswith("doc"):
                    n["id"] = n["properties"]["name"]
            dump["nodes"].sort(key=lambda n: n["id"])
            for e in dump["relationships"]:
                e["id"] = e["startNode"] = e["endNode"] = "x"
        assert dumps[0] == dumps[1]
        # each package imports the other's export
        ij, ip = str(tmp_path / "jax2"), str(tmp_path / "port2")
        want = _run(jax_cli, ["--data-dir", ij, "import", fp], capsys,
                    tmp_path)
        got = _run(port_cli, ["--data-dir", ip, "import", fj, "--device",
                              "cpu"], capsys, tmp_path)
        assert got == want == (0, f"imported {len(DOCS) + 2} nodes, "
                                  "1 relationships\n")

    def test_backup_restore_alike_across_packages(self, tmp_path, capsys):
        dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
        _fill(_JAX_OPEN, dj)
        _fill(_PORT_OPEN, dp)
        aj, ap = str(tmp_path / "j.json.gz"), str(tmp_path / "p.json.gz")
        want = _run(jax_cli, ["--data-dir", dj, "backup", aj], capsys,
                    tmp_path)
        got = _run(port_cli, ["--data-dir", dp, "backup", ap, "--device",
                              "cpu"], capsys, tmp_path)
        assert want == (0, f"backup written to {aj}\n".replace(
            str(tmp_path), "<tmp>"))
        assert got == (0, f"backup written to {ap}\n".replace(
            str(tmp_path), "<tmp>"))
        with gzip.open(ap, "rt") as f:
            assert len(json.load(f)["nodes"]) >= len(DOCS) + 2
        # each archive restored by both packages: the same lines, and the
        # same graph as the directory it came from
        for archive, source, open_src in ((aj, dj, _JAX_OPEN),
                                          (ap, dp, _PORT_OPEN)):
            rj = str(tmp_path / f"rj-{len(archive)}-{archive[-9]}")
            rp = str(tmp_path / f"rp-{len(archive)}-{archive[-9]}")
            want = _run(jax_cli, ["--data-dir", rj, "restore", archive],
                        capsys, tmp_path)
            got = _run(port_cli, ["--data-dir", rp, "restore", archive,
                                  "--device", "cpu"], capsys, tmp_path)
            assert got == want
            assert got[0] == 0 and got[1].startswith(
                f"restored {len(DOCS) + 2} nodes, 1 edges")
            ref = _graph(open_src, source)
            assert _graph(_PORT_OPEN, rp) == _graph(_JAX_OPEN, rj) == ref

    def test_backup_needs_a_data_dir_alike(self, capsys):
        assert jax_cli(["--data-dir", "", "backup"]) == 2
        assert port_cli(["--data-dir", "", "backup", "--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert err.count("--data-dir (or NORNICDB_DATA_DIR) is required") == 2

    @pytest.mark.parametrize("thresholds", ["", '{"mrr": 0.5}',
                                            '{"mrr": 1.01}'])
    def test_eval_alike(self, tmp_path, capsys, thresholds):
        dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
        _fill(_JAX_OPEN, dj)
        _fill(_PORT_OPEN, dp)
        suite = str(tmp_path / "suite.json")
        with open(suite, "w") as f:
            json.dump([{"query": " ".join(DOCS[i].split()[:3]),
                        "relevant": [f"doc{i}"]}
                       for i in range(0, len(DOCS), 3)]
                      + [{"query": "graph memory", "relevant":
                          [f"doc{i}" for i, t in enumerate(DOCS)
                           if "graph" in t and "memory" in t]}], f)
        extra = ["--k", "5", "--embed-dims", "32"] + (
            ["--thresholds", thresholds] if thresholds else [])
        want = _run(jax_cli, ["--data-dir", dj, "eval", suite] + extra,
                    capsys, tmp_path)
        got = _run(port_cli, ["--data-dir", dp, "eval", suite, "--device",
                              "cpu"] + extra, capsys, tmp_path)
        assert got == want
        report = json.loads(got[1])
        assert report["metrics"]["mrr"] > 0.5
        assert got[0] == (1 if "1.01" in thresholds else 0)

    def test_shell_alike(self, tmp_path, capsys, monkeypatch):
        lines = ["CREATE (:S {v: 1}), (:S {v: 2})",
                 "MATCH (s:S) RETURN s.v ORDER BY s.v", "",
                 "RETURN 1 +", "MATCH (s:S) RETURN count(s) AS n", ":quit",
                 "RETURN 'never'"]
        outs = []
        for cli, d, extra in ((jax_cli, "jax", []),
                              (port_cli, "port", ["--device", "cpu"])):
            feed = iter(lines)
            monkeypatch.setattr("builtins.input", lambda _p: next(feed))
            outs.append(_run(cli, ["--data-dir", str(tmp_path / d), "shell"]
                             + extra, capsys, tmp_path))
        assert outs[1] == outs[0]
        assert outs[0][1].splitlines()[-1] == "1\t2" or "n\n2" in outs[0][1]
        assert "never" not in outs[0][1]
