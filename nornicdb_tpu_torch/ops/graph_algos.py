"""Graph algorithms: device programs where the math is dense, host loops
where it is combinatorial (counterpart of ``nornicdb_tpu/ops/graph_algos.py``,
same names and signatures: numpy in, numpy out).

PageRank and weakly connected components are edge-array programs on the
card: contributions flow along the edges through ``index_add_`` (the JAX
package's ``segment_sum``) and ``scatter_reduce_(..., "amin")`` (its
``segment_min``). Both take ``device=None``, which means CUDA and raises
DeviceUnavailable without a card; ``device="cpu"`` runs the same torch ops
on the CPU. Everything else (label propagation, BFS, the centralities,
triangles, SCC, k-core, Louvain, modularity, density, conductance,
Dijkstra/A*) is host code over numpy edge arrays, copied from the JAX
package.

Edge-array convention: graphs arrive as (src, dst) int32 arrays of node
indices [0, n). Directed edges; undirected algorithms symmetrize
internally.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# Device path: PageRank (ref: apoc/algo PageRank, damped power iteration)
# ---------------------------------------------------------------------------


def _edges_to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def pagerank_device(s: torch.Tensor, d: torch.Tensor, n: int,
                    damping: float = 0.85, iters: int = 20) -> torch.Tensor:
    """PageRank over edge tensors already on the device: ``iters`` rounds
    with no host sync (the dangling mass stays a tensor). Returns the
    float32 (n,) ranks on the device."""
    ones = torch.ones(s.shape[0], dtype=torch.float32, device=s.device)
    out_deg = torch.zeros(n, dtype=torch.float32,
                          device=s.device).index_add_(0, s, ones)
    del ones
    safe_deg = torch.clamp(out_deg, min=1.0)
    dangling_nodes = out_deg == 0
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=s.device)
    for _ in range(int(iters)):
        # rank[src] / safe_deg[src] as JAX rounds it: the quotient per node
        # is the same float32 division, gathered once per edge
        contrib = torch.index_select(rank / safe_deg, 0, s)
        incoming = torch.zeros(n, dtype=torch.float32,
                               device=s.device).index_add_(0, d, contrib)
        del contrib
        # dangling nodes redistribute uniformly (standard PageRank fix)
        dangling = torch.where(dangling_nodes, rank, 0.0).sum()
        rank = (1.0 - damping) / n + damping * (incoming + dangling / n)
    return rank


def pagerank(src: np.ndarray, dst: np.ndarray, n: int,
             damping: float = 0.85, iters: int = 20,
             device: DeviceLike = None) -> np.ndarray:
    dev = resolve_device(device)
    if n == 0:
        return np.zeros((0,), dtype=np.float32)
    if len(src) == 0:
        return np.full((n,), 1.0 / n, dtype=np.float32)
    rank = pagerank_device(_edges_to(src, dev), _edges_to(dst, dev), n,
                           float(damping), int(iters))
    return rank.cpu().numpy()


# ---------------------------------------------------------------------------
# Device path: connected components via min-label propagation
# (ref: community ConnectedComponents/WeaklyConnectedComponents)
# ---------------------------------------------------------------------------


def wcc_device(s: torch.Tensor, d: torch.Tensor, n: int
               ) -> tuple[torch.Tensor, int]:
    """Min-label propagation over symmetrized edge tensors on the device
    (``s`` int32, ``d`` int64: ``scatter_reduce_`` takes int64 indices)
    until no label changes; one host sync a round. Returns the int32 labels
    on the device and the rounds run (the last one changed nothing)."""
    labels = torch.arange(n, dtype=torch.int32, device=s.device)
    rounds = 0
    while True:
        rounds += 1
        # push the smaller label across every (symmetrized) edge; the
        # clone's own label is segment_min's identity for a node with no
        # in-edge, and makes the result min(labels, upd) already
        new = labels.clone().scatter_reduce_(
            0, d, torch.index_select(labels, 0, s), "amin",
            include_self=True)
        changed = bool(torch.ne(new, labels).any())
        labels = new
        if not changed:
            return labels, rounds


def connected_components(src: np.ndarray, dst: np.ndarray, n: int,
                         device: DeviceLike = None) -> np.ndarray:
    """Weakly connected components; returns a component label per node
    (the smallest member index)."""
    dev = resolve_device(device)
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if len(src) == 0:
        return np.arange(n, dtype=np.int32)
    s = _edges_to(src, dev)
    d = _edges_to(dst, dev)
    labels, _ = wcc_device(torch.cat([s, d]),
                           torch.cat([d, s]).to(torch.int64), n)
    return labels.cpu().numpy()


# ---------------------------------------------------------------------------
# Host path: label propagation (ref: community LabelPropagation) - each
# round a node adopts the label with the highest incident weight.
# ---------------------------------------------------------------------------


def label_propagation(src: np.ndarray, dst: np.ndarray, n: int,
                      iters: int = 10) -> np.ndarray:
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if len(src) == 0:
        return np.arange(n, dtype=np.int32)
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    labels = np.arange(n, dtype=np.int32)
    # host loop with numpy bincount per round: label domains shrink every
    # round, so dense one-hot (n×n) on device would waste HBM; this stays
    # O(E) per round
    for _ in range(int(iters)):
        counts: dict[tuple[int, int], int] = defaultdict(int)
        for a, b in zip(d, labels[s]):
            counts[(int(a), int(b))] += 1
        new = labels.copy()
        best: dict[int, tuple[int, int]] = {}
        for (node, lab), c in counts.items():
            cur = best.get(node)
            # deterministic: higher count wins, ties -> smaller label
            if cur is None or c > cur[0] or (c == cur[0] and lab < cur[1]):
                best[node] = (c, lab)
        for node, (_, lab) in best.items():
            new[node] = lab
        if np.array_equal(new, labels):
            break
        labels = new
    return labels


# ---------------------------------------------------------------------------
# Host path: degree / closeness / betweenness centrality (ref: apoc/algo)
# ---------------------------------------------------------------------------


def _adj(src, dst, n, undirected=True) -> list[list[int]]:
    adj: list[list[int]] = [[] for _ in range(n)]
    for a, b in zip(src, dst):
        adj[int(a)].append(int(b))
        if undirected:
            adj[int(b)].append(int(a))
    return adj


def build_csr(src: np.ndarray, dst: np.ndarray, n: int,
              undirected: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, neighbors) CSR arrays — the frontier-batched BFS input
    shape the adjacency snapshot (storage/adjacency.py) also serves."""
    s = np.asarray(src, np.int64)
    d = np.asarray(dst, np.int64)
    if undirected:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    counts = np.bincount(s, minlength=n) if s.size else np.zeros(n, np.int64)
    offsets = np.zeros(n + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    order = np.argsort(s, kind="stable")
    return offsets, d[order].astype(np.int32)


def _frontier_neighbors(offsets: np.ndarray, neighbors: np.ndarray,
                        frontier: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """One batched gather: (heads, nbrs) for every CSR entry of `frontier`
    — replaces a per-node Python adjacency loop per BFS level."""
    starts = offsets[frontier]
    cnts = offsets[frontier + 1] - starts
    total = int(cnts.sum())
    if total == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty
    shift = np.repeat(np.cumsum(cnts) - cnts, cnts)
    gather = np.repeat(starts, cnts) + np.arange(total) - shift
    return np.repeat(frontier, cnts), neighbors[gather].astype(np.int64)


def bfs_distances_csr(offsets: np.ndarray, neighbors: np.ndarray,
                      source: int, n: int) -> np.ndarray:
    """Unweighted hop distances from `source` (-1 unreached), one numpy
    gather + dedup per level."""
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    frontier = np.asarray([source], np.int64)
    level = 0
    while frontier.size:
        _, nbrs = _frontier_neighbors(offsets, neighbors, frontier)
        if not nbrs.size:
            break
        nbrs = nbrs[dist[nbrs] < 0]
        if not nbrs.size:
            break
        frontier = np.unique(nbrs)
        level += 1
        dist[frontier] = level
    return dist


def degree_centrality(src: np.ndarray, dst: np.ndarray, n: int,
                      direction: str = "both") -> np.ndarray:
    out = np.zeros((n,), dtype=np.float32)
    if direction in ("both", "out"):
        np.add.at(out, src.astype(int), 1.0)
    if direction in ("both", "in"):
        np.add.at(out, dst.astype(int), 1.0)
    return out


def closeness_centrality(src, dst, n) -> np.ndarray:
    """closeness(v) = (reachable-1) / sum(dist) scaled by reachable/n
    (the Wasserman-Faust variant the reference uses). Per-source BFS runs
    over CSR arrays with batched frontier gathers instead of a Python
    adjacency loop per node."""
    out = np.zeros((n,), dtype=np.float32)
    if n == 0:
        return out
    offsets, neighbors = build_csr(src, dst, n)
    for v in range(n):
        dist = bfs_distances_csr(offsets, neighbors, v, n)
        reached = dist > 0
        total = int(dist[reached].sum())
        reach = int(reached.sum())
        if total > 0 and reach > 0:
            out[v] = (reach / total) * (reach / max(n - 1, 1))
    return out


def betweenness_centrality(src, dst, n) -> np.ndarray:
    """Brandes' algorithm (exact, unweighted) over CSR arrays: the forward
    pass is a frontier-batched BFS per source (sigma accumulated with
    scatter-adds over each level's edge batch), the backward pass replays
    the recorded level batches in reverse — no per-edge Python loops."""
    bc = np.zeros((n,), dtype=np.float64)
    if n == 0:
        return bc.astype(np.float32)
    offsets, neighbors = build_csr(src, dst, n)
    for s in range(n):
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = np.full(n, -1, np.int64)
        dist[s] = 0
        frontier = np.asarray([s], np.int64)
        level_edges: list[tuple[np.ndarray, np.ndarray]] = []
        level = 0
        while frontier.size:
            heads, nbrs = _frontier_neighbors(offsets, neighbors, frontier)
            if not nbrs.size:
                break
            newly = nbrs[dist[nbrs] < 0]
            if newly.size:
                newly = np.unique(newly)
                dist[newly] = level + 1
            keep = dist[nbrs] == level + 1
            h, w = heads[keep], nbrs[keep]
            if w.size:
                np.add.at(sigma, w, sigma[h])
                level_edges.append((h, w))
            frontier = newly
            level += 1
        delta = np.zeros(n)
        for h, w in reversed(level_edges):
            np.add.at(delta, h, sigma[h] / sigma[w] * (1.0 + delta[w]))
        visited = dist >= 0
        visited[s] = False
        bc[visited] += delta[visited]
    return (bc / 2.0).astype(np.float32)  # undirected double-count


# ---------------------------------------------------------------------------
# Host path: triangles / clustering (ref: community TriangleCount)
# ---------------------------------------------------------------------------


def triangle_counts(src, dst, n) -> np.ndarray:
    nbrs: list[set[int]] = [set() for _ in range(n)]
    for a, b in zip(src, dst):
        a, b = int(a), int(b)
        if a != b:
            nbrs[a].add(b)
            nbrs[b].add(a)
    out = np.zeros((n,), dtype=np.int64)
    for v in range(n):
        for u in nbrs[v]:
            if u > v:
                common = nbrs[v] & nbrs[u]
                for w in common:
                    if w > u:
                        out[v] += 1
                        out[u] += 1
                        out[w] += 1
    return out


def clustering_coefficient(src, dst, n) -> np.ndarray:
    tri = triangle_counts(src, dst, n)
    nbrs: list[set[int]] = [set() for _ in range(n)]
    for a, b in zip(src, dst):
        a, b = int(a), int(b)
        if a != b:
            nbrs[a].add(b)
            nbrs[b].add(a)
    out = np.zeros((n,), dtype=np.float32)
    for v in range(n):
        k = len(nbrs[v])
        if k >= 2:
            out[v] = 2.0 * tri[v] / (k * (k - 1))
    return out


# ---------------------------------------------------------------------------
# Host path: SCC (Tarjan, iterative), k-core peeling
# ---------------------------------------------------------------------------


def strongly_connected_components(src, dst, n) -> np.ndarray:
    adj = _adj(src, dst, n, undirected=False)
    index = np.full((n,), -1)
    low = np.zeros((n,), dtype=np.int64)
    on_stack = np.zeros((n,), dtype=bool)
    comp = np.full((n,), -1, dtype=np.int32)
    stack: list[int] = []
    counter = 0
    n_comp = 0
    for root in range(n):
        if index[root] >= 0:
            continue
        work: list[tuple[int, int]] = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i]
                if index[w] < 0:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = n_comp
                    if w == v:
                        break
                n_comp += 1
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return comp


def k_core(src, dst, n) -> np.ndarray:
    """Core number per node (peeling)."""
    nbrs: list[set[int]] = [set() for _ in range(n)]
    for a, b in zip(src, dst):
        a, b = int(a), int(b)
        if a != b:
            nbrs[a].add(b)
            nbrs[b].add(a)
    deg = np.array([len(s) for s in nbrs])
    core = np.zeros((n,), dtype=np.int32)
    alive = set(range(n))
    k = 0
    while alive:
        peel = [v for v in alive if deg[v] <= k]
        if not peel:
            k += 1
            continue
        for v in peel:
            core[v] = k
            alive.discard(v)
            for u in nbrs[v]:
                if u in alive:
                    deg[u] -= 1
    return core


# ---------------------------------------------------------------------------
# Host path: Louvain (one-pass greedy + aggregation) and modularity
# (ref: community Louvain/Modularity)
# ---------------------------------------------------------------------------


def modularity(src, dst, n, labels) -> float:
    m = len(src)
    if m == 0:
        return 0.0
    deg = np.zeros((n,))
    np.add.at(deg, src.astype(int), 1.0)
    np.add.at(deg, dst.astype(int), 1.0)
    labels = np.asarray(labels)
    q = 0.0
    for a, b in zip(src, dst):
        if labels[int(a)] == labels[int(b)]:
            q += 1.0
    q /= m
    comm_deg: dict[Any, float] = defaultdict(float)
    for v in range(n):
        comm_deg[labels[v]] += deg[v]
    q -= sum((d / (2.0 * m)) ** 2 for d in comm_deg.values())
    return float(q)


def louvain(src, dst, n, max_passes: int = 5) -> np.ndarray:
    """Greedy modularity optimization, local-move phase repeated until no
    gain (single level — the reference's DefaultLouvainConfig similarly
    bounds passes)."""
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    nbrs: list[dict[int, float]] = [defaultdict(float) for _ in range(n)]
    for a, b in zip(src, dst):
        a, b = int(a), int(b)
        if a != b:
            nbrs[a][b] += 1.0
            nbrs[b][a] += 1.0
    m = max(len(src), 1)
    deg = np.array([sum(d.values()) for d in nbrs])
    labels = np.arange(n, dtype=np.int32)
    comm_deg = deg.astype(np.float64).copy()
    for _ in range(max_passes):
        moved = False
        for v in range(n):
            cur = labels[v]
            comm_deg[cur] -= deg[v]
            weights: dict[int, float] = defaultdict(float)
            for u, w in nbrs[v].items():
                weights[labels[u]] += w
            best_c, best_gain = cur, 0.0
            for c, w_in in weights.items():
                gain = w_in / m - comm_deg[c] * deg[v] / (2.0 * m * m)
                if gain > best_gain + 1e-12:
                    best_c, best_gain = c, gain
            labels[v] = best_c
            comm_deg[best_c] += deg[v]
            if best_c != cur:
                moved = True
        if not moved:
            break
    # compact labels
    _, compact = np.unique(labels, return_inverse=True)
    return compact.astype(np.int32)


def density(src, dst, n) -> float:
    if n < 2:
        return 0.0
    return float(len(src)) / (n * (n - 1))


def conductance(src, dst, n, labels, community) -> float:
    """cut(S, V\\S) / min(vol(S), vol(V\\S))."""
    labels = np.asarray(labels)
    cut = vol_in = vol_out = 0
    for a, b in zip(src, dst):
        a_in = labels[int(a)] == community
        b_in = labels[int(b)] == community
        if a_in != b_in:
            cut += 1
        if a_in:
            vol_in += 1
        else:
            vol_out += 1
        if b_in:
            vol_in += 1
        else:
            vol_out += 1
    denom = min(vol_in, vol_out)
    return float(cut) / denom if denom else 0.0


# ---------------------------------------------------------------------------
# Host path: weighted shortest paths (ref: apoc/algo Dijkstra/AStar)
# ---------------------------------------------------------------------------


def dijkstra(adj: dict[int, list[tuple[int, float]]], start: int,
             goal: Optional[int] = None,
             heuristic: Optional[Callable[[int], float]] = None,
             ) -> tuple[dict[int, float], dict[int, int]]:
    """Returns (dist, prev). With `heuristic` this is A* toward `goal`."""
    dist = {start: 0.0}
    prev: dict[int, int] = {}
    h0 = heuristic(start) if heuristic else 0.0
    pq: list[tuple[float, int]] = [(h0, start)]
    done: set[int] = set()
    while pq:
        _, v = heapq.heappop(pq)
        if v in done:
            continue
        done.add(v)
        if goal is not None and v == goal:
            break
        for w, cost in adj.get(v, []):
            nd = dist[v] + cost
            if nd < dist.get(w, float("inf")):
                dist[w] = nd
                prev[w] = v
                f = nd + (heuristic(w) if heuristic else 0.0)
                heapq.heappush(pq, (f, w))
    return dist, prev


def reconstruct_path(prev: dict[int, int], start: int, goal: int) -> list[int]:
    if goal != start and goal not in prev:
        return []
    path = [goal]
    while path[-1] != start:
        path.append(prev[path[-1]])
    return list(reversed(path))
