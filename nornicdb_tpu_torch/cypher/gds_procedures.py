"""GDS-compatible procedures + Kalman Cypher functions (the port's copy of
``nornicdb_tpu/cypher/gds_procedures.py``).

Device policy: PageRank, weakly connected components and the link
prediction GEMMs of ``gds.linkPrediction.suggest`` run on the executor's
device (``ex.device``), after the device owner's gate
(``backend.gate(ex.device, ex.backend)``): a card that is not serving
raises DeviceUnavailable, and a device error propagates (no host retry).
An executor built with ``device="cpu"`` runs the same torch ops on the
CPU. FastRP and the other algorithms are host numpy, as in JAX.

Behavioral reference: upstream NornicDB pkg/cypher/linkprediction.go
(gds.linkPrediction.* procedures over pkg/linkpredict),
kalman_functions.go:115-195 (kalman.* scalar functions),
fastrp.go:361-652 (gds.fastRP.* node embeddings).
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from nornicdb_tpu_torch.cypher.executor import CypherExecutor, procedure
from nornicdb_tpu_torch.cypher.functions import register
from nornicdb_tpu_torch.errors import (
    AlreadyExistsError,
    CypherSyntaxError,
    CypherTypeError,
    NotFoundError,
)
from nornicdb_tpu_torch.filter.kalman import Kalman, KalmanConfig
from nornicdb_tpu_torch.linkpredict.topology import (
    DEVICE_MIN_NODES,
    SCORERS,
    build_graph,
    score_pair,
    top_candidates,
)
from nornicdb_tpu_torch.storage.types import Node

log = logging.getLogger(__name__)


def _adj_snapshot(ex: CypherExecutor):
    """The engine's shared CSR adjacency snapshot (storage/adjacency.py),
    attached on first GDS/link-prediction call. After its first build the
    topology stays event-maintained — repeated procedures never rescan
    `all_edges()`."""
    snap = getattr(ex, "_adj_snapshot_cache", None)
    if snap is None:
        try:
            from nornicdb_tpu_torch.storage.adjacency import attach_snapshot

            snap = attach_snapshot(ex.storage)
        except Exception:
            log.debug("adjacency snapshot unavailable; GDS uses the "
                      "engine-scan path", exc_info=True)
            snap = False
        ex._adj_snapshot_cache = snap
    return snap or None


def _gated_device(ex: CypherExecutor):
    """The executor's device once its owner serves (``backend.gate``, run
    before any device work); raises DeviceUnavailable when it does not."""
    from nornicdb_tpu_torch import backend

    backend.gate(ex.device, ex.backend)
    return ex.device


def _method_from_name(proc_name: str) -> str:
    # gds.linkprediction.adamicadar -> adamicAdar
    tail = proc_name.rsplit(".", 1)[-1]
    for m in SCORERS:
        if m.lower() == tail:
            return m
    raise CypherSyntaxError(f"unknown link prediction method {tail}")


def _cached_graph(ex: CypherExecutor):
    """Graph projection served from the CSR snapshot when available —
    generation-tagged, so repeated calls on an unchanged graph reuse the
    same projection and any mutation (even one that leaves the counts
    unchanged, e.g. paired CREATE+DELETE) is visible. The count-keyed
    per-executor cache remains as the fallback for engines without a
    snapshot."""
    snap = _adj_snapshot(ex)
    if snap is not None and snap.ensure():
        return snap.graph_view()
    key = (ex.storage.node_count(), ex.storage.edge_count())
    cached = getattr(ex, "_lp_graph_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    g = build_graph(ex.storage)
    ex._lp_graph_cache = (key, g)
    return g


def _lp_pair(ex: CypherExecutor, args: list[Any], method: str):
    if len(args) < 2:
        raise CypherSyntaxError("expected (node1, node2)")
    a, b = args[0], args[1]
    a_id = a.id if isinstance(a, Node) else str(a)
    b_id = b.id if isinstance(b, Node) else str(b)
    g = _cached_graph(ex)
    return ["score"], [[score_pair(g, a_id, b_id, method)]]


for _m in list(SCORERS):
    def _make(meth):
        def fn(ex, args, row):
            return _lp_pair(ex, args, meth)

        return fn

    procedure(f"gds.linkprediction.{_m.lower()}")(_make(_m))


def _source_candidates(
    ex: CypherExecutor, method: str, source: str, top_k: int
) -> list[list[Any]]:
    """Per-source candidate streaming: score `source` against every
    non-adjacent node (ref: the map-config .stream form,
    gds.linkPrediction.X.stream({sourceNode, topK}) linkprediction.go)."""
    g = _cached_graph(ex)
    if source not in g.index:
        return []
    si = g.index[source]
    scored = []
    for j in range(g.n):
        if j == si or j in g.neighbors[si]:
            continue
        v = score_pair(g, source, g.ids[j], method)
        if v > 0:
            scored.append((g.ids[j], v))
    scored.sort(key=lambda t: -t[1])
    rows = []
    for b_id, v in scored[:top_k]:
        na, nb = ex.get_node_or_none(source), ex.get_node_or_none(b_id)
        if na is not None and nb is not None:
            rows.append([na, nb, v])
    return rows


def _stream_config(args: list[Any]) -> tuple[str, int]:
    cfg = args[0] if args and isinstance(args[0], dict) else {}
    source = cfg.get("sourceNode", "")
    # accept a Node object or an id string (same normalization as _lp_pair)
    source = source.id if isinstance(source, Node) else str(source)
    top_k = int(cfg.get("topK", 10))
    return source, top_k


for _m in list(SCORERS):
    def _make_stream(meth):
        def fn(ex, args, row):
            source, top_k = _stream_config(args)
            if not source:
                raise CypherSyntaxError("sourceNode required")
            return (["node1", "node2", "score"],
                    _source_candidates(ex, meth, source, top_k))

        return fn

    procedure(f"gds.linkprediction.{_m.lower()}.stream")(_make_stream(_m))


@procedure("gds.linkprediction.predict.stream")
def proc_lp_predict_stream(ex: CypherExecutor, args, row):
    """Hybrid topology+semantic prediction stream (ref: hybrid.go:61-222,
    gds.linkPrediction.predict.stream)."""
    from nornicdb_tpu_torch.linkpredict.topology import HybridConfig, hybrid_score

    cfg = args[0] if args and isinstance(args[0], dict) else {}
    source = cfg.get("sourceNode", "")
    source = source.id if isinstance(source, Node) else str(source)
    if not source:
        raise CypherSyntaxError("sourceNode required")
    top_k = int(cfg.get("topK", 10))
    method = str(cfg.get("algorithm", "adamic_adar"))
    method = {"adamic_adar": "adamicAdar", "common_neighbors":
              "commonNeighbors", "preferential_attachment":
              "preferentialAttachment", "resource_allocation":
              "resourceAllocation"}.get(method, method)
    hcfg = HybridConfig(
        topology_weight=float(cfg.get("topologyWeight", 0.5)),
        semantic_weight=float(cfg.get("semanticWeight", 0.5)),
    )
    if method in SCORERS:
        hcfg.methods = [method]
    g = _cached_graph(ex)
    if source not in g.index:
        return ["node1", "node2", "score"], []
    src_node = ex.get_node_or_none(source)
    emb_a = src_node.embedding if src_node is not None else None
    si = g.index[source]
    scored = []
    for j in range(g.n):
        if j == si or j in g.neighbors[si]:
            continue
        b_id = g.ids[j]
        nb = ex.get_node_or_none(b_id)
        emb_b = nb.embedding if nb is not None else None
        v = hybrid_score(g, source, b_id, emb_a, emb_b, hcfg)
        if v > 0:
            scored.append((b_id, v))
    scored.sort(key=lambda t: -t[1])
    rows = []
    for b_id, v in scored[:top_k]:
        nb = ex.get_node_or_none(b_id)
        if src_node is not None and nb is not None:
            rows.append([src_node, nb, v])
    return ["node1", "node2", "score"], rows


@procedure("gds.linkprediction.suggest")
def proc_lp_suggest(ex: CypherExecutor, args, row):
    """Top non-adjacent candidate pairs (ref: linkprediction.go suggest)."""
    method = str(args[0]) if args else "adamicAdar"
    limit = int(args[1]) if len(args) > 1 else 20
    g = _cached_graph(ex)  # generation-tagged: always current topology
    # the owner's gate only where the GEMMs run on the device
    device = (_gated_device(ex) if g.n >= DEVICE_MIN_NODES else ex.device)
    rows = []
    for a_id, b_id, score in top_candidates(g, method, limit, device=device):
        na, nb = ex.get_node_or_none(a_id), ex.get_node_or_none(b_id)
        if na is not None and nb is not None:
            rows.append([na, nb, score])
    return ["node1", "node2", "score"], rows


@procedure("gds.fastrp.stats")
def proc_fastrp_stats(ex: CypherExecutor, args, row):
    """gds.fastRP.stats(name, config) — summary counts without streaming
    embeddings (ref: fastrp.go stats mode)."""
    cfg = next((a for a in args if isinstance(a, dict)), {})
    g = _cached_graph(ex)
    return (
        ["nodeCount", "embeddingDimension"],
        [[g.n, int(cfg.get("embeddingDimension", 128))]],
    )


@procedure("gds.fastrp.stream")
def proc_fastrp(ex: CypherExecutor, args, row):
    """FastRP node embeddings (ref: fastrp.go:361-652): iterative neighbor
    averaging over random projections, here computed as adjacency matmuls."""
    cfg = args[0] if args and isinstance(args[0], dict) else {}
    dims = int(cfg.get("embeddingDimension", 128))
    iterations = int(cfg.get("iterationWeights") and len(cfg["iterationWeights"]) or 3)
    weights = cfg.get("iterationWeights") or [0.0, 1.0, 1.0][:iterations]
    g = _cached_graph(ex)
    if g.n == 0:
        return ["nodeId", "embedding"], []
    rng = np.random.default_rng(int(cfg.get("randomSeed", 42)))
    # sparse random projection init (+-1/sqrt(dims))
    emb = rng.choice(
        [-1.0, 0.0, 1.0], size=(g.n, dims), p=[1 / 6, 2 / 3, 1 / 6]
    ).astype(np.float32) * np.sqrt(3.0 / dims)
    a = np.zeros((g.n, g.n), np.float32)
    for i, nbrs in enumerate(g.neighbors):
        for j in nbrs:
            a[i, j] = 1.0
    deg = np.maximum(a.sum(axis=1, keepdims=True), 1.0)
    a = a / deg  # row-normalized
    out = np.zeros_like(emb)
    curr = emb
    for w in weights:
        curr = a @ curr
        norms = np.maximum(np.linalg.norm(curr, axis=1, keepdims=True), 1e-12)
        curr = curr / norms
        out += float(w) * curr
    norms = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    out = out / norms
    return (
        ["nodeId", "embedding"],
        [[g.ids[i], out[i].tolist()] for i in range(g.n)],
    )


# ---------------------------------------------------------------- kalman fns
def _kalman_states(ex: CypherExecutor) -> dict[str, Kalman]:
    """Per-executor state (not module-global) so independent DB instances /
    databases never share or leak filter state."""
    states = getattr(ex, "_kalman_states", None)
    if states is None:
        states = {}
        ex._kalman_states = states
    return states


@register("kalman.init")
def fn_kalman_init(config=None):
    """kalman.init([config]) -> state JSON string stored on a node
    property (ref: kalman_functions.go:254 kalmanInit — Q scales
    processNoise by 0.001, defaults R=88, P=30, varianceScale=10)."""
    import json as _json

    state = {
        "x": 0.0, "p": 30.0, "q": 0.1 * 0.001, "r": 88.0,
        "varianceScale": 10.0, "initialized": False,
    }
    if isinstance(config, dict):
        if config.get("processNoise") is not None:
            state["q"] = float(config["processNoise"]) * 0.001
        if config.get("measurementNoise") is not None:
            state["r"] = float(config["measurementNoise"])
        if config.get("initialCovariance") is not None:
            state["p"] = float(config["initialCovariance"])
        if config.get("varianceScale") is not None:
            state["varianceScale"] = float(config["varianceScale"])
    return _json.dumps(state)


def _kalman_load(state):
    """Parse a state JSON; malformed input is a clean type error, never a
    raw JSONDecodeError up through the query (kalman_functions_test.go
    interpolates real state strings; user queries may not)."""
    import json as _json

    try:
        s = _json.loads(state)
    except (TypeError, ValueError):
        raise CypherTypeError(f"invalid kalman state: {state!r}")
    if not isinstance(s, dict):
        raise CypherTypeError(f"invalid kalman state: {state!r}")
    return s


@register("kalman.process")
def fn_kalman_process(measurement, state):
    """kalman.process(measurement, stateJson) -> {value, state}
    (ref: kalmanProcess — returns the smoothed value plus the updated
    state JSON to store back on the node)."""
    import json as _json

    if measurement is None or state is None:
        return None
    s = _kalman_load(state)
    z = float(measurement)
    if not s.get("initialized"):
        s["x"] = z
        s["initialized"] = True
    else:
        p = s.get("p", 30.0) + s.get("q", 1e-4)
        k = p / (p + s.get("r", 88.0))
        s["x"] = s.get("x", 0.0) + k * (z - s.get("x", 0.0))
        s["p"] = (1 - k) * p
    return {"value": s["x"], "state": _json.dumps(s)}


@register("kalman.state")
def fn_kalman_state(state):
    """kalman.state(stateJson) -> MAP view of the stored filter state."""
    return None if state is None else _kalman_load(state)


# -- velocity model (2-state: position + velocity; ref: kalman_functions_test
# kalman.velocity.* family) ---------------------------------------------------
@register("kalman.velocity.init")
def fn_kalman_velocity_init(config=None):
    import json as _json

    state = {
        "model": "velocity", "x": 0.0, "v": 0.0,
        "p": 30.0, "q": 1e-4, "r": 88.0, "dt": 1.0, "initialized": False,
    }
    if isinstance(config, dict):
        if config.get("processNoise") is not None:
            state["q"] = float(config["processNoise"]) * 0.001
        if config.get("measurementNoise") is not None:
            state["r"] = float(config["measurementNoise"])
        if config.get("dt") is not None:
            state["dt"] = float(config["dt"])
    return _json.dumps(state)


@register("kalman.velocity.process")
def fn_kalman_velocity_process(measurement, state):
    """-> {value, velocity, state}: position smoothed, velocity estimated
    from the innovation (reduced-order alpha-beta form of the 2-state
    filter — same observable behavior, one scalar gain pair)."""
    import json as _json

    if measurement is None or state is None:
        return None
    s = _kalman_load(state)
    z = float(measurement)
    dt = s.get("dt", 1.0)
    if not s.get("initialized"):
        s["x"], s["v"] = z, 0.0
        s["initialized"] = True
    else:
        pred = s.get("x", 0.0) + s.get("v", 0.0) * dt
        p = s.get("p", 30.0) + s.get("q", 1e-4)
        alpha = p / (p + s.get("r", 88.0))
        beta = alpha * alpha / (2 - alpha)
        resid = z - pred
        s["x"] = pred + alpha * resid
        s["v"] = s.get("v", 0.0) + (beta / dt) * resid
        s["p"] = (1 - alpha) * p
    return {"value": s["x"], "velocity": s["v"], "state": _json.dumps(s)}


@register("kalman.velocity.predict")
def fn_kalman_velocity_predict(state, steps=1):
    """Extrapolate position `steps` intervals ahead: x + v*steps*dt."""
    if state is None:
        return None
    s = _kalman_load(state)
    return (s.get("x", 0.0)
            + s.get("v", 0.0) * float(steps) * s.get("dt", 1.0))


# -- adaptive model (hysteresis gates noise adaptation; ref:
# kalman.adaptive.* family) ---------------------------------------------------
@register("kalman.adaptive.init")
def fn_kalman_adaptive_init(config=None):
    import json as _json

    state = {
        "model": "adaptive", "x": 0.0, "p": 30.0, "q": 1e-4, "r": 88.0,
        "hysteresis": 2, "breach": 0, "initialized": False,
    }
    if isinstance(config, dict):
        if config.get("hysteresis") is not None:
            state["hysteresis"] = int(config["hysteresis"])
        if config.get("processNoise") is not None:
            state["q"] = float(config["processNoise"]) * 0.001
        if config.get("measurementNoise") is not None:
            state["r"] = float(config["measurementNoise"])
    return _json.dumps(state)


@register("kalman.adaptive.process")
def fn_kalman_adaptive_process(measurement, state):
    """Standard update; after `hysteresis` consecutive large innovations,
    the filter re-seeds on the measurement (level-shift tracking)."""
    import json as _json

    if measurement is None or state is None:
        return None
    s = _kalman_load(state)
    z = float(measurement)
    if not s.get("initialized"):
        s["x"], s["initialized"] = z, True
    else:
        p = s.get("p", 30.0) + s.get("q", 1e-4)
        r = s.get("r", 88.0)
        resid = z - s.get("x", 0.0)
        if resid * resid > 9 * (p + r):  # > 3 sigma
            s["breach"] = s.get("breach", 0) + 1
        else:
            s["breach"] = 0
        if s["breach"] >= s.get("hysteresis", 2):
            s["x"], s["p"], s["breach"] = z, 30.0, 0  # re-seed on shift
        else:
            k = p / (p + r)
            s["x"] = s.get("x", 0.0) + k * resid
            s["p"] = (1 - k) * p
    return {"value": s["x"], "state": _json.dumps(s)}


@register("kalman.filter")
def fn_kalman_filter(ex, key, measurement, process_noise=1e-3, measurement_noise=1e-1):
    """Stateful named scalar filter (ref: kalman_functions.go:115-195)."""
    if key is None or measurement is None:
        return None
    states = _kalman_states(ex)
    k = states.get(str(key))
    if k is None:
        k = Kalman(KalmanConfig(float(process_noise), float(measurement_noise)))
        states[str(key)] = k
    return k.process(float(measurement))


fn_kalman_filter.needs_executor = True


@register("kalman.predict")
def fn_kalman_predict(ex, key, steps=1):
    """Two forms: kalman.predict(stateJson, steps) extrapolates from a
    serialized state (ref: kalman_functions_test.go:405); kalman.predict(key)
    reads the named in-memory filter from kalman.filter."""
    if isinstance(key, str) and key.lstrip()[:1] == "{":
        s = _kalman_load(key)
        return (s.get("x", 0.0)
                + s.get("v", 0.0) * float(steps) * s.get("dt", 1.0))
    k = _kalman_states(ex).get(str(key))
    return None if k is None else k.predict()


fn_kalman_predict.needs_executor = True


@register("kalman.reset")
def fn_kalman_reset(ex, key):
    _kalman_states(ex).pop(str(key), None)
    return True


fn_kalman_reset.needs_executor = True


@register("kalman.smooth")
def fn_kalman_smooth(values, process_noise=1e-3, measurement_noise=1e-1):
    """Smooth a list of measurements in one call."""
    if values is None:
        return None
    if not isinstance(values, list):
        raise CypherTypeError("kalman.smooth expects a list")
    k = Kalman(KalmanConfig(float(process_noise), float(measurement_noise)))
    return [k.process(float(v)) for v in values]


# ---------------------------------------------------------------- algorithms
# (ref: upstream NornicDB apoc/algo/ + upstream NornicDB apoc/community/ —
# exposed both under gds.* stream procedures and apoc.algo.* aliases)

from nornicdb_tpu_torch.ops import graph_algos as _ga  # noqa: E402


def _edge_arrays(ex: CypherExecutor):
    """Directed (src, dst) index arrays + sorted id list, served from the
    CSR snapshot (generation-tagged: repeated calls on an unchanged graph
    reuse the same arrays, mutations — including count-neutral ones — are
    always visible, and no `all_edges()` rescan ever runs after the first
    snapshot build). Count-keyed executor cache kept as the fallback."""
    snap = _adj_snapshot(ex)
    if snap is not None and snap.ensure():
        view = snap.edge_arrays()
        return view.ids, view.index, view.src, view.dst
    key = (ex.storage.node_count(), ex.storage.edge_count())
    cached = getattr(ex, "_algo_graph_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    ids = sorted(n.id for n in ex.storage.all_nodes())
    index = {id_: i for i, id_ in enumerate(ids)}
    src, dst = [], []
    for e in ex.storage.all_edges():
        a, b = index.get(e.start_node), index.get(e.end_node)
        if a is not None and b is not None:
            src.append(a)
            dst.append(b)
    out = (ids, index,
           np.asarray(src, dtype=np.int32), np.asarray(dst, dtype=np.int32))
    ex._algo_graph_cache = (key, out)
    return out


def _node_rows(ex, ids, values, col):
    rows = []
    for i, v in enumerate(values):
        n = ex.get_node_or_none(ids[i])
        if n is not None:
            rows.append([n, v])
    return ["node", col], rows


@procedure("gds.pagerank.stream")
def proc_pagerank(ex: CypherExecutor, args, row):
    """(ref: apoc/algo PageRank — damped power iteration, ``index_add_``
    on the executor's device)"""
    cfg = args[0] if args and isinstance(args[0], dict) else {}
    ids, _, src, dst = _edge_arrays(ex)
    scores = _ga.pagerank(src, dst, len(ids),
                          damping=float(cfg.get("dampingFactor", 0.85)),
                          iters=int(cfg.get("maxIterations", 20)),
                          device=_gated_device(ex))
    return _node_rows(ex, ids, [float(s) for s in scores], "score")


@procedure("gds.wcc.stream")
def proc_wcc(ex: CypherExecutor, args, row):
    """(ref: community WeaklyConnectedComponents — min-label propagation)"""
    ids, _, src, dst = _edge_arrays(ex)
    comp = _ga.connected_components(src, dst, len(ids),
                                    device=_gated_device(ex))
    return _node_rows(ex, ids, [int(c) for c in comp], "componentId")


@procedure("gds.scc.stream")
def proc_scc(ex: CypherExecutor, args, row):
    """(ref: community StronglyConnectedComponents — Tarjan)"""
    ids, _, src, dst = _edge_arrays(ex)
    comp = _ga.strongly_connected_components(src, dst, len(ids))
    return _node_rows(ex, ids, [int(c) for c in comp], "componentId")


@procedure("gds.labelpropagation.stream")
def proc_label_prop(ex: CypherExecutor, args, row):
    cfg = args[0] if args and isinstance(args[0], dict) else {}
    ids, _, src, dst = _edge_arrays(ex)
    labels = _ga.label_propagation(src, dst, len(ids),
                                   iters=int(cfg.get("maxIterations", 10)))
    return _node_rows(ex, ids, [int(c) for c in labels], "communityId")


@procedure("gds.louvain.stream")
def proc_louvain(ex: CypherExecutor, args, row):
    """(ref: community Louvain — greedy modularity local moves)"""
    ids, _, src, dst = _edge_arrays(ex)
    labels = _ga.louvain(src, dst, len(ids))
    return _node_rows(ex, ids, [int(c) for c in labels], "communityId")


@procedure("gds.trianglecount.stream")
def proc_triangles(ex: CypherExecutor, args, row):
    ids, _, src, dst = _edge_arrays(ex)
    tri = _ga.triangle_counts(src, dst, len(ids))
    return _node_rows(ex, ids, [int(t) for t in tri], "triangleCount")


@procedure("gds.localclusteringcoefficient.stream")
def proc_clustering(ex: CypherExecutor, args, row):
    ids, _, src, dst = _edge_arrays(ex)
    cc = _ga.clustering_coefficient(src, dst, len(ids))
    return _node_rows(ex, ids, [float(c) for c in cc], "localClusteringCoefficient")


_ORIENTATIONS = {
    # GDS-standard names plus the plain aliases
    "natural": "out", "reverse": "in", "undirected": "both",
    "out": "out", "in": "in", "both": "both",
}


@procedure("gds.degree.stream")
def proc_degree(ex: CypherExecutor, args, row):
    cfg = args[0] if args and isinstance(args[0], dict) else {}
    raw = str(cfg.get("orientation", "UNDIRECTED")).lower()
    direction = _ORIENTATIONS.get(raw)
    if direction is None:
        raise CypherSyntaxError(
            f"gds.degree.stream: unknown orientation {raw!r} "
            "(NATURAL, REVERSE, UNDIRECTED)")
    ids, _, src, dst = _edge_arrays(ex)
    deg = _ga.degree_centrality(src, dst, len(ids), direction=direction)
    return _node_rows(ex, ids, [float(d) for d in deg], "score")


@procedure("gds.closeness.stream")
def proc_closeness(ex: CypherExecutor, args, row):
    ids, _, src, dst = _edge_arrays(ex)
    c = _ga.closeness_centrality(src, dst, len(ids))
    return _node_rows(ex, ids, [float(x) for x in c], "score")


@procedure("gds.betweenness.stream")
def proc_betweenness(ex: CypherExecutor, args, row):
    ids, _, src, dst = _edge_arrays(ex)
    b = _ga.betweenness_centrality(src, dst, len(ids))
    return _node_rows(ex, ids, [float(x) for x in b], "score")


@procedure("gds.kcore.stream")
def proc_kcore(ex: CypherExecutor, args, row):
    ids, _, src, dst = _edge_arrays(ex)
    core = _ga.k_core(src, dst, len(ids))
    return _node_rows(ex, ids, [int(c) for c in core], "coreValue")


@procedure("gds.graph.density")
def proc_density(ex: CypherExecutor, args, row):
    ids, _, src, dst = _edge_arrays(ex)
    return ["density"], [[_ga.density(src, dst, len(ids))]]


@procedure("gds.modularity")
def proc_modularity(ex: CypherExecutor, args, row):
    """gds.modularity(communityMap) — {nodeId/elementId: communityId}."""
    if not args or not isinstance(args[0], dict):
        raise CypherSyntaxError("gds.modularity({nodeId: communityId})")
    ids, index, src, dst = _edge_arrays(ex)
    labels = np.arange(len(ids))
    for nid, c in args[0].items():
        i = index.get(str(nid))
        if i is not None:
            labels[i] = int(c)
    return ["modularity"], [[_ga.modularity(src, dst, len(ids), labels)]]


def _weighted_adj(ex, index, weight_prop, orientation: str = "natural"):
    """Directed by default (GDS NATURAL); UNDIRECTED symmetrizes. Self-loops
    contribute one entry either way."""
    undirected = str(orientation).lower() == "undirected"
    adj: dict[int, list[tuple[int, float]]] = {}
    for e in ex.storage.all_edges():
        a, b = index.get(e.start_node), index.get(e.end_node)
        if a is None or b is None:
            continue
        w = 1.0
        if weight_prop:
            try:
                w = float(e.properties.get(weight_prop, 1.0))
            except (TypeError, ValueError):
                w = 1.0
        adj.setdefault(a, []).append((b, w))
        if undirected and b != a:
            adj.setdefault(b, []).append((a, w))
    return adj


def _path_edges(ex, ids, path_idx, weight_prop):
    """Cheapest connecting edge per consecutive node pair, so the returned
    __path__ carries real relationships (length()/apoc.path.* depend on
    them)."""
    rels = []
    for i, j in zip(path_idx, path_idx[1:]):
        best = None
        best_w = None
        # an UNDIRECTED search may traverse an edge against its direction,
        # so check both orientations for the connecting relationship
        candidates = [e for e in ex.storage.get_outgoing_edges(ids[i])
                      if e.end_node == ids[j]]
        candidates += [e for e in ex.storage.get_incoming_edges(ids[i])
                       if e.start_node == ids[j]]
        for e in candidates:
            w = 1.0
            if weight_prop:
                try:
                    w = float(e.properties.get(weight_prop, 1.0))
                except (TypeError, ValueError):
                    w = 1.0
            if best is None or w < best_w:
                best, best_w = e, w
        if best is not None:
            rels.append(best)
    return rels


@procedure("gds.shortestpath.dijkstra.stream")
def proc_dijkstra(ex: CypherExecutor, args, row):
    """gds.shortestPath.dijkstra.stream(source, target, config) —
    config.relationshipWeightProperty selects the cost property."""
    if len(args) < 2:
        raise CypherSyntaxError(
            "gds.shortestPath.dijkstra.stream(source, target, config)")
    src_n = _resolve_node(ex, args[0])
    dst_n = _resolve_node(ex, args[1])
    cfg = args[2] if len(args) > 2 and isinstance(args[2], dict) else {}
    ids, index, _, _ = _edge_arrays(ex)
    s, t = index.get(src_n.id), index.get(dst_n.id)
    if s is None or t is None:
        return ["totalCost", "nodeIds", "path"], []
    weight_prop = cfg.get("relationshipWeightProperty")
    adj = _weighted_adj(ex, index, weight_prop,
                        orientation=cfg.get("orientation", "natural"))
    dist, prev = _ga.dijkstra(adj, s, goal=t)
    if t not in dist:
        return ["totalCost", "nodeIds", "path"], []
    path_idx = _ga.reconstruct_path(prev, s, t)
    nodes = [ex.get_node_or_none(ids[i]) for i in path_idx]
    rels = _path_edges(ex, ids, path_idx, weight_prop)
    return (["totalCost", "nodeIds", "path"],
            [[dist[t], [ids[i] for i in path_idx],
              {"__path__": True, "nodes": nodes, "relationships": rels}]])


@procedure("gds.shortestpath.astar.stream")
def proc_astar(ex: CypherExecutor, args, row):
    """A* with haversine heuristic over config.latitudeProperty/
    longitudeProperty (ref: apoc/algo AStar)."""
    if len(args) < 2:
        raise CypherSyntaxError(
            "gds.shortestPath.astar.stream(source, target, config)")
    src_n = _resolve_node(ex, args[0])
    dst_n = _resolve_node(ex, args[1])
    cfg = args[2] if len(args) > 2 and isinstance(args[2], dict) else {}
    lat_p = cfg.get("latitudeProperty", "latitude")
    lon_p = cfg.get("longitudeProperty", "longitude")
    ids, index, _, _ = _edge_arrays(ex)
    s, t = index.get(src_n.id), index.get(dst_n.id)
    if s is None or t is None:
        return ["totalCost", "nodeIds"], []
    coords = {}
    for nid, i in index.items():
        n = ex.get_node_or_none(nid)
        if n is not None and lat_p in n.properties and lon_p in n.properties:
            coords[i] = (float(n.properties[lat_p]), float(n.properties[lon_p]))
    goal_xy = coords.get(t)

    def heuristic(v):
        xy = coords.get(v)
        if xy is None or goal_xy is None:
            return 0.0
        from nornicdb_tpu_torch.apoc.functions_ext import spatial_distance
        return spatial_distance(
            {"latitude": xy[0], "longitude": xy[1]},
            {"latitude": goal_xy[0], "longitude": goal_xy[1]})

    adj = _weighted_adj(ex, index, cfg.get("relationshipWeightProperty"),
                        orientation=cfg.get("orientation", "natural"))
    dist, prev = _ga.dijkstra(adj, s, goal=t, heuristic=heuristic)
    if t not in dist:
        return ["totalCost", "nodeIds"], []
    path_idx = _ga.reconstruct_path(prev, s, t)
    return ["totalCost", "nodeIds"], [[dist[t], [ids[i] for i in path_idx]]]


# apoc.algo.* aliases (the reference exposes the same algorithms there)
procedure("apoc.algo.pagerank")(proc_pagerank)
procedure("apoc.algo.betweenness")(proc_betweenness)
procedure("apoc.algo.closeness")(proc_closeness)
procedure("apoc.algo.community")(proc_louvain)


def _apoc_community_shape(ex, args, rows_fn):
    """apoc.algo.{louvain,labelPropagation}([labels]) YIELD node, community
    — the apoc flavor filters by label list and names the column
    `community` (apoc_community_test.go), unlike gds.* (communityId)."""
    labels = None
    if args and isinstance(args[0], list):
        labels = {str(l) for l in args[0]}
    cols, rows = rows_fn()
    out = []
    for node, community in rows:
        if labels and not (set(node.labels) & labels):
            continue
        out.append([node, community])
    return ["node", "community"], out


@procedure("apoc.algo.louvain")
def proc_apoc_louvain(ex: CypherExecutor, args, row):
    return _apoc_community_shape(
        ex, args, lambda: proc_louvain(ex, [], row))


@procedure("apoc.algo.labelpropagation")
def proc_apoc_label_prop(ex: CypherExecutor, args, row):
    return _apoc_community_shape(
        ex, args, lambda: proc_label_prop(ex, [], row))


@procedure("apoc.neighbors.byhop")
def proc_neighbors_byhop(ex: CypherExecutor, args, row):
    """apoc.neighbors.byhop(start, relType, hops) YIELD nodes, depth —
    one row per hop level with the nodes first reached at that depth."""
    if not args:
        raise CypherSyntaxError("expected (node, relType, hops)")
    src = _resolve_node(ex, args[0])
    rel_type = str(args[1]) if len(args) > 1 and args[1] is not None else None
    hops = int(args[2]) if len(args) > 2 and args[2] is not None else 1
    ids, index, _, _ = _edge_arrays(ex)
    s = index.get(src.id)
    if s is None:
        return ["nodes", "depth"], []
    adj = _filtered_weighted_adj(ex, index, rel_type, None)
    frontier, seen = {s}, {s}
    out = []
    for depth in range(1, hops + 1):
        frontier = {
            nxt for cur in frontier for nxt, _w in adj.get(cur, [])
        } - seen
        if not frontier:
            break
        seen |= frontier
        level = [n for i in sorted(frontier)
                 if (n := ex.get_node_or_none(ids[i])) is not None]
        out.append([level, depth])
    return ["nodes", "depth"], out
procedure("apoc.algo.wcc")(proc_wcc)


def _resolve_node(ex: CypherExecutor, v):
    """Procedures accept Node objects OR id strings (the reference's
    apoc.algo tests call with ids: apoc_algorithms_test.go:75). A string
    that is not a storage id falls back to the `id` PROPERTY — the
    reference's engine-level fixtures set Node.ID directly, while Cypher
    CREATE here assigns storage ids and keeps {id: ...} as a property."""
    if isinstance(v, Node):
        return v
    n = ex.get_node_or_none(str(v))
    if n is None:
        n = next(
            (c for c in ex.storage.all_nodes()
             if c.properties.get("id") == v),
            None,
        )
    if n is None:
        raise CypherTypeError(f"start node not found: {v!r}")
    return n


def _apoc_algo_args(ex, args):
    """(start, end, relTypesAndDirs, weightProperty) — the apoc.algo
    calling convention (apoc_algorithms_test.go)."""
    if len(args) < 2:
        raise CypherSyntaxError("expected (startNode, endNode, relType, weightProp)")
    src = _resolve_node(ex, args[0])
    dst = _resolve_node(ex, args[1])
    rel_type = str(args[2]) if len(args) > 2 and args[2] is not None else None
    weight = str(args[3]) if len(args) > 3 and args[3] is not None else None
    return src, dst, rel_type, weight


def _filtered_weighted_adj(ex, index, rel_type, weight_prop):
    """Adjacency restricted to a relationship-type spec, undirected (the
    apoc path algorithms traverse both directions like the reference's).
    The spec uses apoc syntax: 'KNOWS', 'KNOWS>', '<KNOWS', 'A|B'."""
    types = None
    if rel_type:
        types = {t.strip("<>") for t in str(rel_type).split("|")
                 if t.strip("<>")}
    adj: dict[int, list[tuple[int, float]]] = {}
    for e in ex.storage.all_edges():
        if types and e.type not in types:
            continue
        s, t = index.get(e.start_node), index.get(e.end_node)
        if s is None or t is None:
            continue
        w = 1.0
        if weight_prop:
            try:
                w = float(e.properties.get(weight_prop, 1.0))
            except (TypeError, ValueError):
                w = 1.0
        adj.setdefault(s, []).append((t, w))
        adj.setdefault(t, []).append((s, w))
    return adj


def _ids_to_path(ex, ids, path_idx, rel_type, weight_prop):
    nodes = [ex.get_node_or_none(ids[i]) for i in path_idx]
    rels = _path_edges(ex, ids, path_idx, weight_prop)
    return {"__path__": True, "nodes": nodes, "relationships": rels}


@procedure("apoc.algo.dijkstra")
def proc_apoc_dijkstra(ex: CypherExecutor, args, row):
    """apoc.algo.dijkstra(start, end, relType, weightProp) YIELD path,
    weight (ref: apoc_algorithms_test.go:75)."""
    src, dst, rel_type, weight_prop = _apoc_algo_args(ex, args)
    ids, index, _, _ = _edge_arrays(ex)
    s, t = index.get(src.id), index.get(dst.id)
    if s is None or t is None:
        return ["path", "weight"], []
    adj = _filtered_weighted_adj(ex, index, rel_type, weight_prop)
    dist, prev = _ga.dijkstra(adj, s, goal=t)
    if t not in dist:
        return ["path", "weight"], []
    path_idx = _ga.reconstruct_path(prev, s, t)
    return (["path", "weight"],
            [[_ids_to_path(ex, ids, path_idx, rel_type, weight_prop),
              dist[t]]])


@procedure("apoc.algo.astar")
def proc_apoc_astar(ex: CypherExecutor, args, row):
    """apoc.algo.aStar — same yield shape as dijkstra (the zero heuristic
    is admissible without coordinates)."""
    return proc_apoc_dijkstra(ex, args, row)


@procedure("apoc.algo.allsimplepaths")
def proc_all_simple_paths(ex: CypherExecutor, args, row):
    """apoc.algo.allSimplePaths(start, end, relType, maxHops) YIELD path."""
    src, dst, rel_type, _ = _apoc_algo_args(ex, args)
    max_hops = int(args[3]) if len(args) > 3 and args[3] is not None else 10
    ids, index, _, _ = _edge_arrays(ex)
    s, t = index.get(src.id), index.get(dst.id)
    if s is None or t is None:
        return ["path"], []
    adj = _filtered_weighted_adj(ex, index, rel_type, None)
    out = []

    def dfs(cur, path):
        if len(path) > max_hops + 1:
            return
        if cur == t:
            out.append([_ids_to_path(ex, ids, path, rel_type, None)])
            return
        for nxt, _w in adj.get(cur, []):
            if nxt not in path:
                dfs(nxt, path + [nxt])

    dfs(s, [s])
    return ["path"], out


# -- gds.graph.* catalog (ref: fastrp_test.go:186-244) ------------------------
def _graph_catalog(ex: CypherExecutor) -> dict:
    cat = getattr(ex, "_gds_graph_catalog", None)
    if cat is None:
        cat = ex._gds_graph_catalog = {}
    return cat


@procedure("gds.graph.project")
def proc_graph_project(ex: CypherExecutor, args, row):
    """gds.graph.project(name, nodeLabel, relType) YIELD graphName,
    nodeCount, relationshipCount. '*' projects everything."""
    if len(args) < 1:
        raise CypherSyntaxError("gds.graph.project(name, nodeLabel, relType)")
    name = str(args[0])
    label = str(args[1]) if len(args) > 1 and args[1] is not None else "*"
    rel_type = str(args[2]) if len(args) > 2 and args[2] is not None else "*"
    cat = _graph_catalog(ex)
    if name in cat:
        raise AlreadyExistsError(f"graph {name} already exists")
    if label == "*":
        n_count = ex.storage.node_count()
    else:
        n_count = sum(1 for _ in ex.storage.get_nodes_by_label(label))
    if rel_type == "*":
        r_count = ex.storage.edge_count()
    else:
        r_count = sum(1 for e in ex.storage.all_edges() if e.type == rel_type)
    cat[name] = {"label": label, "relType": rel_type,
                 "nodeCount": n_count, "relationshipCount": r_count}
    return (["graphName", "nodeCount", "relationshipCount"],
            [[name, n_count, r_count]])


@procedure("gds.graph.drop")
def proc_graph_drop(ex: CypherExecutor, args, row):
    name = str(args[0]) if args else ""
    cat = _graph_catalog(ex)
    if name not in cat:
        raise NotFoundError(f"graph {name} not found")
    del cat[name]
    return ["graphName"], [[name]]


@procedure("gds.graph.list")
def proc_graph_list(ex: CypherExecutor, args, row):
    cat = _graph_catalog(ex)
    if args:  # gds.graph.list(name)
        name = str(args[0])
        items = [(name, cat[name])] if name in cat else []
    else:
        items = sorted(cat.items())
    return (["graphName", "nodeCount", "relationshipCount"],
            [[n, g["nodeCount"], g["relationshipCount"]] for n, g in items])


@procedure("gds.graph.exists")
def proc_graph_exists(ex: CypherExecutor, args, row):
    name = str(args[0]) if args else ""
    return (["graphName", "exists"],
            [[name, name in _graph_catalog(ex)]])
