"""Topological link prediction (Neo4j GDS-compatible scorers), counterpart
of ``nornicdb_tpu/linkpredict/topology.py``.

Behavioral reference: the upstream NornicDB pkg/linkpredict/topology.go:244-621 -
CommonNeighbors, Jaccard (totalNeighbors variant), AdamicAdar,
PreferentialAttachment, ResourceAllocation; graph projection builder
(BuildGraphFromEngine :144, graph_builder.go); hybrid topology+semantic
scorer (hybrid.go:61-222).

Batch all-pairs scoring runs as adjacency matmuls on the card (common-
neighbor counts = A @ A, weighted variants via degree-scaled A), in
float32 at full precision whatever the process's TF32 setting, so
candidate generation over the whole graph is a few GEMMs instead of
per-pair set intersections.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.storage.types import Engine


@dataclass
class Graph:
    """Undirected projection of the stored graph (ref: BuildGraphFromEngine
    topology.go:144)."""

    ids: list[str]
    index: dict[str, int]
    neighbors: list[set[int]]

    @property
    def n(self) -> int:
        return len(self.ids)

    def degree(self, i: int) -> int:
        return len(self.neighbors[i])


def build_graph(storage: Engine, edge_types: Optional[list[str]] = None) -> Graph:
    # A CSR adjacency snapshot attached to this engine (storage/adjacency.py)
    # serves the projection from resident arrays — generation-cached, no
    # `all_edges()` rescan after its first build.
    snap = getattr(storage, "_adjacency_snapshot", None)
    if snap is not None and snap.ensure():
        return snap.graph_view(edge_types)
    ids = sorted(n.id for n in storage.all_nodes())
    index = {id_: i for i, id_ in enumerate(ids)}
    neighbors: list[set[int]] = [set() for _ in ids]
    for e in storage.all_edges():
        if edge_types and e.type not in edge_types:
            continue
        a = index.get(e.start_node)
        b = index.get(e.end_node)
        if a is None or b is None or a == b:
            continue
        neighbors[a].add(b)
        neighbors[b].add(a)
    return Graph(ids, index, neighbors)


# ---------------------------------------------------------------- pair scorers
def common_neighbors(g: Graph, a: int, b: int) -> float:
    """(ref: topology.go:244)"""
    return float(len(g.neighbors[a] & g.neighbors[b]))


def jaccard(g: Graph, a: int, b: int) -> float:
    """(ref: topology.go — intersection/union)"""
    inter = len(g.neighbors[a] & g.neighbors[b])
    union = len(g.neighbors[a] | g.neighbors[b])
    return inter / union if union else 0.0


def adamic_adar(g: Graph, a: int, b: int) -> float:
    """(ref: topology.go — sum 1/log(deg(z)))"""
    score = 0.0
    for z in g.neighbors[a] & g.neighbors[b]:
        d = g.degree(z)
        if d > 1:
            score += 1.0 / math.log(d)
    return score


def preferential_attachment(g: Graph, a: int, b: int) -> float:
    """(ref: topology.go — deg(a)*deg(b))"""
    return float(g.degree(a) * g.degree(b))


def resource_allocation(g: Graph, a: int, b: int) -> float:
    """(ref: topology.go — sum 1/deg(z))"""
    score = 0.0
    for z in g.neighbors[a] & g.neighbors[b]:
        d = g.degree(z)
        if d > 0:
            score += 1.0 / d
    return score


SCORERS = {
    "commonNeighbors": common_neighbors,
    "jaccard": jaccard,
    "adamicAdar": adamic_adar,
    "preferentialAttachment": preferential_attachment,
    "resourceAllocation": resource_allocation,
}


def score_pair(g: Graph, a_id: str, b_id: str, method: str = "adamicAdar") -> float:
    fn = SCORERS.get(method)
    if fn is None:
        raise ValueError(f"unknown link-prediction method {method}")
    a, b = g.index.get(a_id), g.index.get(b_id)
    if a is None or b is None:
        return 0.0
    return fn(g, a, b)


# ---------------------------------------------------------------- batch (device)
def _full_precision_matmul(dev: torch.device):
    """``mm(x, y)`` for host float32 arrays: one float32 ``torch.matmul`` on
    ``dev`` at full precision. The process-wide float32 matmul precision is
    set to "highest" for the product and restored after it (a concurrent
    matmul elsewhere meanwhile only gains precision)."""

    def mm(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            out = torch.matmul(
                torch.from_numpy(np.asarray(x, np.float32)).to(dev),
                torch.from_numpy(np.asarray(y, np.float32)).to(dev))
            return out.cpu().numpy()
        finally:
            torch.set_float32_matmul_precision(prev)

    return mm


def batch_scores(
    g: Graph, method: str = "adamicAdar", use_device: bool = True,
    device: DeviceLike = None,
) -> np.ndarray:
    """All-pairs scores as dense (N, N). Common-neighbor-family scorers are
    adjacency GEMMs: CN = A@A; AA/RA = A@diag(w)@A with w = 1/log(deg) or
    1/deg; PA = deg deg^T; Jaccard from CN and degrees.

    With ``use_device`` and N >= 64 the GEMMs run on ``device`` (None means
    CUDA and raises DeviceUnavailable without a card); smaller graphs and
    ``use_device=False`` take numpy's, the reference's own branch."""
    n = g.n
    if n == 0:
        return np.zeros((0, 0), np.float32)
    a = np.zeros((n, n), np.float32)
    for i, nbrs in enumerate(g.neighbors):
        for j in nbrs:
            a[i, j] = 1.0
    deg = a.sum(axis=1)
    if use_device and n >= 64:
        mm = _full_precision_matmul(resolve_device(device))
    else:
        mm = np.matmul
    if method == "commonNeighbors":
        s = mm(a, a)
    elif method == "adamicAdar":
        w = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2.0)), 0.0)
        s = mm(a * w[None, :], a)
    elif method == "resourceAllocation":
        w = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
        s = mm(a * w[None, :], a)
    elif method == "preferentialAttachment":
        s = np.outer(deg, deg).astype(np.float32)
    elif method == "jaccard":
        cn = mm(a, a)
        union = deg[:, None] + deg[None, :] - cn
        s = np.divide(cn, union, out=np.zeros_like(cn), where=union > 0)
    else:
        raise ValueError(f"unknown link-prediction method {method}")
    np.fill_diagonal(s, 0.0)
    return s


def top_candidates(
    g: Graph,
    method: str = "adamicAdar",
    limit: int = 20,
    exclude_existing: bool = True,
    device: DeviceLike = None,
) -> list[tuple[str, str, float]]:
    """Highest-scoring non-adjacent pairs (ref: gds.linkPrediction procedures,
    pkg/cypher/linkprediction.go)."""
    s = batch_scores(g, method, device=device)
    n = g.n
    if exclude_existing:
        for i, nbrs in enumerate(g.neighbors):
            for j in nbrs:
                s[i, j] = 0.0
    iu = np.triu_indices(n, k=1)
    vals = s[iu]
    order = np.argsort(-vals)[: max(limit, 0)]
    out = []
    for k in order:
        v = float(vals[k])
        if v <= 0:
            break
        i, j = int(iu[0][k]), int(iu[1][k])
        out.append((g.ids[i], g.ids[j], v))
    return out


# ---------------------------------------------------------------- hybrid
@dataclass
class HybridConfig:
    """(ref: hybrid.go:61-222 — blend of topology ensemble + semantic cosine)"""

    topology_weight: float = 0.5
    semantic_weight: float = 0.5
    methods: list[str] = field(
        default_factory=lambda: ["adamicAdar", "jaccard", "commonNeighbors"]
    )


def hybrid_score(
    g: Graph,
    a_id: str,
    b_id: str,
    emb_a: Optional[np.ndarray],
    emb_b: Optional[np.ndarray],
    config: Optional[HybridConfig] = None,
) -> float:
    cfg = config or HybridConfig()
    topo_parts = []
    for m in cfg.methods:
        v = score_pair(g, a_id, b_id, m)
        # squash unbounded scorers to [0, 1)
        topo_parts.append(v / (1.0 + v) if m != "jaccard" else v)
    topo = sum(topo_parts) / len(topo_parts) if topo_parts else 0.0
    sem = 0.0
    if emb_a is not None and emb_b is not None:
        na, nb = np.linalg.norm(emb_a), np.linalg.norm(emb_b)
        if na > 1e-12 and nb > 1e-12:
            sem = float(np.dot(emb_a, emb_b) / (na * nb))
            sem = max(sem, 0.0)
    if emb_a is None or emb_b is None:
        return topo  # no semantic signal: pure topology
    return cfg.topology_weight * topo + cfg.semantic_weight * sem
