"""The port's servers against the JAX package's, on the same inputs made
from one numpy seed, on the CPU.

- PackStream: ``pack`` gives the same bytes in both packages and
  ``unpack`` the same values, over a seeded corpus of every type (null,
  booleans, ints at every size boundary, floats with NaN and infinities,
  strings, bytes, lists and maps across their header boundaries, nested
  maps, numpy scalars and arrays, ``Node``, ``Edge``, paths, structures);
  an int past 64 bits is refused alike.
- Bolt: one transcript of HELLO / RUN / PULL / DISCARD / BEGIN / COMMIT /
  ROLLBACK / RESET and a failure, against two equal DBs, is equal byte for
  byte, message by message.
- HTTP: the JSON bodies of ``/db/neo4j/tx/commit``, ``/nornicdb/search``
  (``vector`` and ``query``, with ``HashEmbedder``) and ``/auth/*`` are
  equal. Scores are held within ``SCORE_TOL``: a vector score is a bf16
  product in both packages (the JAX plain version and the port's plain
  version on the CPU), so it is compared within half a bf16 step at 1.0;
  everything else is compared exactly. The auth module's clock and
  ``secrets`` are seeded in both packages, so tokens are equal byte for
  byte; a user's ``created_at`` is the clock at creation and is compared
  as a time within the test's span.
- ``/metrics``: after the same traffic, in a fresh process for each
  package, the family names and types are equal; ``METRICS_EXCEPTIONS``
  lists the differences with their reasons.
"""

from __future__ import annotations

import base64
import json
import math
import os
import socket
import struct
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import nornicdb_tpu
import nornicdb_tpu.auth.auth as jax_auth_mod
import nornicdb_tpu_torch
import nornicdb_tpu_torch.auth.auth as port_auth_mod
from nornicdb_tpu import auth as jax_auth
from nornicdb_tpu import embed as jax_embed
from nornicdb_tpu import server as jax_server
from nornicdb_tpu.server import packstream as jax_ps
from nornicdb_tpu.storage import types as jax_types
from nornicdb_tpu.telemetry.promparse import parse_prometheus_strict
from nornicdb_tpu_torch import auth as port_auth
from nornicdb_tpu_torch import embed as port_embed
from nornicdb_tpu_torch import server as port_server
from nornicdb_tpu_torch.server import packstream as port_ps
from nornicdb_tpu_torch.storage import types as port_types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# half of bf16's step in [0.5, 1] (2**-8 / 2): the two plain versions round
# the same product in another order
SCORE_TOL = 4e-3

PKGS = {
    "jax": types.SimpleNamespace(
        ps=jax_ps, types=jax_types, server=jax_server, auth=jax_auth,
        auth_mod=jax_auth_mod, Hash=jax_embed.HashEmbedder,
        open=lambda: nornicdb_tpu.open_db("")),
    "torch": types.SimpleNamespace(
        ps=port_ps, types=port_types, server=port_server, auth=port_auth,
        auth_mod=port_auth_mod, Hash=port_embed.HashEmbedder,
        open=lambda: nornicdb_tpu_torch.open_db("", device="cpu")),
}


# ------------------------------------------------------------- packstream


def _corpus(pkg, seed: int) -> list:
    """Every PackStream type, from one seed; Node and Edge of ``pkg``."""
    rng = np.random.default_rng(seed)
    Node, Edge = pkg.types.Node, pkg.types.Edge
    out: list = [None, True, False, float("nan"), float("inf"),
                 float("-inf"), -0.0, "", b"", [], {}]
    for lo, hi in ((-16, 128), (-128, 128), (-(2 ** 15), 2 ** 15),
                   (-(2 ** 31), 2 ** 31), (-(2 ** 63), 2 ** 63)):
        out += [lo, hi - 1]
        out += [int(v) for v in rng.integers(lo, hi, 4, dtype=np.int64)]
    # just past each boundary
    out += [-17, 128, -129, 2 ** 15, -(2 ** 15) - 1, 2 ** 31, -(2 ** 31) - 1]
    out += [float(v) for v in rng.standard_normal(4) * 1e6]
    for n in (1, 15, 16, 255, 256, 65535, 65536):
        chars = rng.choice(list("abcxyzé漢"), n)
        out.append("".join(chars))
        out.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    for n in (15, 16, 255, 256):
        out.append([int(v) for v in rng.integers(-1000, 1000, n)])
        out.append({f"k{i}": int(v)
                    for i, v in enumerate(rng.integers(0, 9, n))})
    out.append({"a": {"b": {"c": [1, {"d": None, "e": [2.5, "x"]}]}},
                "list": [[1, [2, [3]]], {"m": True}]})
    out += [np.int64(-5), np.int32(300), np.float32(0.25), np.float64(-1.5),
            rng.standard_normal(3).astype(np.float32),
            rng.integers(0, 9, (2, 2))]
    nodes = []
    for i in range(3):
        nodes.append(Node(
            id=f"n{i}", labels=["L", f"T{i}"],
            properties={"k": int(rng.integers(0, 100)),
                        "s": f"v{i}", "f": float(rng.standard_normal()),
                        "xs": [1, 2, 3]}))
    edges = [Edge(id=f"e{i}", start_node=f"n{i}", end_node=f"n{i + 1}",
                  type="NEXT", properties={"w": float(i) / 3})
             for i in range(2)]
    out += nodes + edges
    out.append({"node": nodes[0], "rels": edges, "mixed": [nodes[1], 7]})
    out.append(pkg.ps.path_struct({"nodes": nodes, "relationships": edges}))
    out.append(pkg.ps.Structure(0x71, [[1, "two", nodes[2]]]))
    return out


def _norm(v):
    """A comparable form: floats by their bytes (NaN equals NaN), a
    Structure as (tag, fields)."""
    if isinstance(v, float):
        return ("f", struct.pack(">d", v))
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if type(v).__name__ == "Structure":
        return ("S", v.tag, _norm(v.fields))
    return v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_same_bytes_and_unpack_same_values(seed):
    jv, tv = _corpus(PKGS["jax"], seed), _corpus(PKGS["torch"], seed)
    assert len(jv) == len(tv)
    for i, (a, b) in enumerate(zip(jv, tv)):
        ja, tb = jax_ps.pack(a), port_ps.pack(b)
        assert ja == tb, (i, type(a).__name__)
        assert _norm(jax_ps.unpack(ja)) == _norm(port_ps.unpack(tb)), i
        # to_wire then pack, as a RECORD row does
        assert (jax_ps.pack(jax_ps.to_wire(a))
                == port_ps.pack(port_ps.to_wire(b))), i


@pytest.mark.parametrize("value", [2 ** 63, -(2 ** 63) - 1, object()])
def test_unpackable_values_refused_alike(value):
    errors = []
    for ps in (jax_ps, port_ps):
        with pytest.raises(Exception) as e:
            ps.pack(value)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


# ------------------------------------------------------------------- bolt


def _fill(db, pkg) -> None:
    Node, Edge = pkg.types.Node, pkg.types.Edge
    rng = np.random.default_rng(5)
    for i in range(6):
        db.storage.create_node(Node(
            id=f"p{i}", labels=["P"],
            properties={"k": i, "name": f"p{i}",
                        "w": float(rng.standard_normal())}))
    for i in range(5):
        db.storage.create_edge(Edge(
            id=f"r{i}", start_node=f"p{i}", end_node=f"p{i + 1}", type="R",
            properties={"since": 2000 + i}))


class _RawBolt:
    """A Bolt 4.4 client that keeps each response's raw chunk bytes."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.sock.sendall(b"\x60\x60\xb0\x17"
                          + struct.pack(">I", (4 << 0) | (4 << 8))
                          + b"\x00" * 12)
        self.version = self._exact(4)

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("closed")
            buf += part
        return buf

    def _message(self) -> tuple[int, bytes]:
        raw, chunks = b"", b""
        while True:
            head = self._exact(2)
            raw += head
            (size,) = struct.unpack(">H", head)
            if size == 0:
                if chunks:
                    return jax_ps.unpack(chunks).tag, raw
                continue
            part = self._exact(size)
            raw += part
            chunks += part

    def exchange(self, tag: int, fields: list) -> bytes:
        """Send one message; the raw bytes of every response up to the
        first SUCCESS, FAILURE or IGNORED."""
        payload = jax_ps.pack(jax_ps.Structure(tag, fields))
        self.sock.sendall(struct.pack(">H", len(payload)) + payload
                          + b"\x00\x00")
        out = b""
        while True:
            rtag, raw = self._message()
            out += raw
            if rtag in (0x70, 0x7E, 0x7F):
                return out

    def close(self) -> None:
        self.sock.close()


_TRANSCRIPT = [
    (0x01, [{"user_agent": "parity/1.0", "scheme": "none"}]),
    (0x10, ["MATCH (n:P) RETURN n, n.k ORDER BY n.k", {}, {}]),
    (0x3F, [{"n": -1}]),
    (0x10, ["MATCH (a:P)-[r:R]->(b) RETURN r, a.k, b.name ORDER BY a.k",
            {}, {}]),
    (0x3F, [{"n": 2}]),
    (0x3F, [{"n": -1}]),
    (0x10, ["MATCH p = (:P {k: 0})-[:R*2]->() RETURN p", {}, {}]),
    (0x3F, [{"n": -1}]),
    (0x11, [{}]),
    (0x10, ["CREATE (n:Q {k: $k, tags: $t}) RETURN n.k, n.tags",
            {"k": 7, "t": ["a", "b"]}, {}]),
    (0x3F, [{"n": -1}]),
    (0x12, []),
    (0x11, [{}]),
    (0x10, ["CREATE (:Q {k: 8})", {}, {}]),
    (0x3F, [{"n": -1}]),
    (0x13, []),
    (0x10, ["MATCH (n:Q) RETURN count(n) AS c, collect(n.k) AS ks", {}, {}]),
    (0x3F, [{"n": -1}]),
    (0x10, ["RETURN $x AS x, [1, 2.5, 'a', null, true] AS l, "
            "{m: {n: -129}} AS m", {"x": -(2 ** 40)}, {}]),
    (0x3F, [{"n": -1}]),
    (0x10, ["UNWIND range(1, 5) AS i RETURN i", {}, {}]),
    (0x2F, [{"n": -1}]),
    (0x10, ["THIS IS NOT CYPHER", {}, {}]),
    (0x3F, [{"n": -1}]),
    (0x0F, []),
    (0x10, ["MATCH (n:P) WHERE n.k > $k RETURN n.name ORDER BY n.k",
            {"k": 3}, {"db": "neo4j"}]),
    (0x3F, [{"n": -1}]),
    (0x66, [{"address": "x"}, [], {}]),
]


def _transcript(pkg) -> list[bytes]:
    db = pkg.open()
    _fill(db, pkg)
    srv = pkg.server.BoltServer(
        lambda q, p, d: (db.executor_for(d) if d else db.executor).execute(
            q, p),
        port=0, session_executor_factory=db.session_executor)
    srv.start()
    try:
        c = _RawBolt(srv.port)
        out = [c.version]
        for tag, fields in _TRANSCRIPT:
            msg = c.exchange(tag, fields)
            if tag == 0x66:
                # the routing table names this server's own port: its
                # decoded value, with the port taken out
                size = struct.unpack(">H", msg[:2])[0]
                table = jax_ps.unpack(msg[2:2 + size]).fields[0]
                for entry in table["rt"]["servers"]:
                    entry["addresses"] = [a.rsplit(":", 1)[0]
                                          for a in entry["addresses"]]
                msg = json.dumps(table, sort_keys=True).encode()
            out.append(msg)
        c.close()
        return out
    finally:
        srv.stop()
        db.close()


def test_bolt_transcript_equal_byte_for_byte():
    want, got = _transcript(PKGS["jax"]), _transcript(PKGS["torch"])
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, _TRANSCRIPT[i - 1][:2] if i else "version")
    # the transcript went through a failure, an IGNORED and every struct
    tags = [jax_ps.unpack(m[2:2 + struct.unpack(">H", m[:2])[0]]).tag
            for m in got[1:-1]]
    assert 0x7F in tags and 0x7E in tags


# ------------------------------------------------------------------- http


def _texts(seed: int, n: int) -> list[str]:
    words = ("graph vector search node edge memory device kernel query "
             "index cache store recall link shard page").split()
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(3, 8)))) + f" d{i}"
            for i in range(n)]


def _request(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _seed_auth(monkeypatch, pkg) -> None:
    """The auth module's clock and randomness, the same in both
    packages: tokens and password hashes are then equal byte for byte."""
    counter = {"n": 0}

    def token_hex(n=32):
        counter["n"] += 1
        return f"{counter['n']:0{2 * n}x}"

    def token_bytes(n=32):
        counter["n"] += 1
        return counter["n"].to_bytes(n, "big")

    monkeypatch.setattr(pkg.auth_mod, "secrets", types.SimpleNamespace(
        token_hex=token_hex, token_bytes=token_bytes))
    monkeypatch.setattr(pkg.auth_mod, "time", types.SimpleNamespace(
        time=lambda: 1_750_000_000.0, monotonic=time.monotonic,
        sleep=time.sleep))


def _http_bodies(pkg, monkeypatch, seed: int) -> list:
    _seed_auth(monkeypatch, pkg)
    db = pkg.open()
    db.set_embedder(pkg.Hash(32))
    _fill(db, pkg)
    for i, t in enumerate(_texts(seed, 40)):
        db.store(t, node_id=f"m{i}", labels=["Doc"])
    db.process_pending_embeddings()
    auth = pkg.auth.Authenticator(
        db.database_manager.get_storage("system"),
        pkg.auth.AuthConfig(secret="parity-secret"))
    auth.create_user("admin", "admin-pw", pkg.auth.ROLE_ADMIN)
    auth.create_user("viewer", "viewer-pw", pkg.auth.ROLE_VIEWER)
    srv = pkg.server.HttpServer(db, port=0, authenticator=auth,
                                auth_required=True)
    srv.start()
    t0 = time.time()
    try:
        port = srv.port
        out = []
        out.append(_request(port, "POST", "/nornicdb/search",
                            {"query": "graph"}))  # 401
        _, tok = _request(port, "POST", "/auth/login",
                          {"username": "admin", "password": "admin-pw"})
        out.append(tok)
        out.append(_request(port, "POST", "/auth/login",
                            {"username": "admin", "password": "wrong"}))
        bearer = {"Authorization": f"Bearer {tok['token']}"}
        basic = {"Authorization": "Basic " + base64.b64encode(
            b"viewer:viewer-pw").decode()}
        out.append(_request(port, "POST", "/auth/token",
                            {"username": "viewer", "password": "viewer-pw"}))
        out.append(_request(port, "GET", "/auth/config"))
        me = _request(port, "GET", "/auth/me", headers=bearer)
        users = _request(port, "GET", "/auth/users", headers=bearer)
        for body in [me[1]] + users[1]:
            assert t0 - 5 <= body.pop("created_at") <= time.time() + 5
        out += [me, users]
        out.append(_request(port, "POST", "/auth/users",
                            {"username": "ed", "password": "ed-pw1",
                             "role": "editor"}, bearer)[0])
        out.append(_request(port, "PUT", "/auth/users/ed",
                            {"role": "viewer", "disabled": True}, bearer))
        out.append(_request(port, "POST", "/auth/api-token",
                            {"subject": "mcp", "expires_in": 60}, bearer))
        out.append(_request(port, "POST", "/db/neo4j/tx/commit", {
            "statements": [{"statement": "CREATE (:X {k: 1})"}]}, basic))
        out.append(_request(port, "DELETE", "/auth/users/ed", None, bearer))
        # the transaction API: reads, a write, a batch rolled back
        for stmts in (
            [{"statement": "MATCH (n:P) RETURN n, n.w ORDER BY n.k"}],
            [{"statement": "MATCH (a:P)-[r:R]->(b) RETURN a.k, r, b "
                           "ORDER BY a.k LIMIT 3"}],
            [{"statement": "CREATE (n:Q {k: $k}) RETURN n.k",
              "parameters": {"k": 3}},
             {"statement": "MATCH (n:Q) RETURN count(n)"}],
            [{"statement": "CREATE (:Q {k: 4})"},
             {"statement": "NOT CYPHER"}],
            [{"statement": "MATCH (n:Q) RETURN collect(n.k) AS ks"}],
        ):
            out.append(_request(port, "POST", "/db/neo4j/tx/commit",
                                {"statements": stmts}, bearer))
        # searches: raw vectors from the seed, then text queries
        rng = np.random.default_rng(seed + 7)
        for _ in range(4):
            vec = rng.standard_normal(32).astype(np.float32).tolist()
            out.append(_request(port, "POST", "/nornicdb/search",
                                {"vector": vec, "limit": 5}, bearer))
        for q in _texts(seed + 1, 4):
            out.append(_request(port, "POST", "/nornicdb/search",
                                {"query": q, "limit": 5}, bearer))
        out.append(_request(port, "POST", "/auth/logout",
                            {"token": tok["token"]}))
        out.append(_request(port, "GET", "/auth/me", headers=bearer))
        return out
    finally:
        srv.stop()
        db.close()


def _close(want, got, path="") -> None:
    """Equal, but floats under a ``score`` key within SCORE_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            if k == "score" and isinstance(want[k], float):
                assert abs(got[k] - want[k]) <= SCORE_TOL, (path, k)
            else:
                _close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            _close(w, g, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("seed", [0, 1])
def test_http_bodies_equal(monkeypatch, seed):
    want = _http_bodies(PKGS["jax"], monkeypatch, seed)
    got = _http_bodies(PKGS["torch"], monkeypatch, seed)
    assert want[0] == (401, {"error": "authentication required"})
    assert want[-1][0] == 401  # the token was revoked by the logout
    _close(want, got)
    # the searches answered (a vacuous equality proves nothing)
    assert all(body[1]["results"] for body in got[-10:-2])


# ---------------------------------------------------------------- metrics

# families whose name or type differs between the two servers' /metrics
# after the same traffic, with the reason
_NO_OWNER_ON_THE_CPU = (
    "JAX's search stats carry its device owner's counters on the CPU too; "
    "the port's CPU corpus never creates an owner (ROADMAP C, PR 14), so "
    "the section renders only on the card")
METRICS_EXCEPTIONS: dict[str, str] = {
    **{f"nornicdb_search_backend_{name}": _NO_OWNER_ON_THE_CPU for name in (
        "acquire_timeout_s", "acquire_timeouts_total", "degrades_total",
        "device_device_count", "fallbacks_total", "lock_violations_total",
        "probe_failures_total", "probe_interval_s", "probe_latency_s",
        "probes_total", "recoveries_total")},
    "nornicdb_search_corpus_sync_uploader_errors":
        "the port's SyncStats also counts the write-behind uploader's "
        "failed runs (ops/similarity.py, PR 9); JAX's has no such field",
}

_METRICS_RUN = r"""
import json, sys, urllib.request
pkg = sys.argv[1]
if pkg == "jax":
    import nornicdb_tpu as P
    db = P.open_db("")
else:
    import nornicdb_tpu_torch as P
    db = P.open_db("", device="cpu")
from importlib import import_module
Hash = import_module(P.__name__ + ".embed").HashEmbedder
Http = import_module(P.__name__ + ".server").HttpServer
import_module(P.__name__ + ".server.bolt")
db.set_embedder(Hash(32))
SearchConfig = import_module(P.__name__ + ".search.service").SearchConfig
db.search.config = SearchConfig(batching_enabled=True)
srv = Http(db, port=0)
srv.start()
def post(path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=30).read()
for i in range(8):
    db.store(f"metrics parity doc {i}", node_id=f"d{i}")
db.process_pending_embeddings()
post("/db/neo4j/tx/commit", {"statements": [
    {"statement": "CREATE (:G {k: 1})-[:R]->(:G {k: 2}) RETURN 1"}]})
post("/db/neo4j/tx/commit", {"statements": [
    {"statement": "MATCH (a:G)-[*1..2]->(b) RETURN count(*)"}]})
post("/nornicdb/search", {"query": "metrics parity", "limit": 3})
post("/nornicdb/search", {"vector": [0.1] * 32, "limit": 3})
db.heimdall.chat([{"role": "user", "content": "hello"}])
urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/admin/stats").read()
text = urllib.request.urlopen(
    f"http://127.0.0.1:{srv.port}/metrics").read().decode()
srv.stop()
db.close()
print("EXPOSITION-START")
print(text)
"""


def _exposition(pkg: str) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _METRICS_RUN, pkg], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split("EXPOSITION-START\n", 1)[1]


def test_metrics_families_and_types_equal():
    jax_types_, _ = parse_prometheus_strict(_exposition("jax"))
    port_types_, samples = parse_prometheus_strict(_exposition("torch"))
    assert samples
    differ = {name for name in set(jax_types_) | set(port_types_)
              if jax_types_.get(name) != port_types_.get(name)}
    assert differ == set(METRICS_EXCEPTIONS), sorted(differ)
    assert len(port_types_) > 100
