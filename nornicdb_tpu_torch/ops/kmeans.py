"""K-means clustering in PyTorch (counterpart of ``nornicdb_tpu/ops/kmeans.py``).

The assign step is one (N, D) x (D, K) float32 product and an argmin, the
update a scatter-add (``index_add_``); Lloyd iterations are a Python loop
on the tensors' device (PyTorch runs eagerly: there is no program to fuse
them into). Ties keep the first index, as ``jnp.argmin`` and ``lax.top_k``
do.

Randomness: ``jax.random`` becomes a ``torch.Generator`` seeded from
``seed`` on the data's device, and ``jax.random.choice(p=...)`` becomes
``torch.multinomial``. The picks differ from JAX's for the same seed; the
tests hold the two packages to each other from a shared initialisation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.kernels import topk_lowest_index


def optimal_k(n: int) -> int:
    """Rule-of-thumb cluster count ~ sqrt(n/2)."""
    if n <= 1:
        return 1
    return max(1, int(math.sqrt(n / 2)))


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared distances, the cross term one
    float32 product."""
    xn = torch.sum(x * x, dim=1, keepdim=True)
    cn = torch.sum(c * c, dim=1)[None, :]
    cross = x.float() @ c.float().T
    return torch.clamp(xn - 2.0 * cross + cn, min=0.0)


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row (first index on ties)."""
    return torch.argmin(pairwise_sq_dists(x, centroids), dim=1)


def _update_centroids(x: torch.Tensor, assign: torch.Tensor, old: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Scatter-add centroid update; an empty cluster keeps its old centroid."""
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, assign, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    counts.index_add_(0, assign, torch.ones(x.shape[0], dtype=x.dtype,
                                            device=x.device))
    fresh = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, fresh, old)


def lloyd(x: torch.Tensor, init_centroids: torch.Tensor, k: int, iters: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-iteration Lloyd refinement. Returns (centroids (K, D),
    assignments (N,), drift (iters,)), drift being the mean centroid
    movement of each iteration."""
    c = init_centroids
    drifts = []
    for _ in range(iters):
        c2 = _update_centroids(x, assign_clusters(x, c), c, k)
        drifts.append(torch.mean(torch.linalg.norm(c2 - c, dim=1)))
        c = c2
    drift = (torch.stack(drifts) if drifts
             else torch.zeros(0, dtype=x.dtype, device=x.device))
    return c, assign_clusters(x, c), drift


def kmeans_pp_init(generator: torch.Generator, x: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """k-means++ seeding: D^2-weighted sampling, one pick at a time.
    ``generator`` lives on x's device. Once every row coincides with a
    pick (fewer distinct rows than k) the draw falls back to uniform, where
    a zero-sum distribution would make ``torch.multinomial`` raise."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first][0]
    best = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        # distance to the most recently added centroid
        best = torch.minimum(best, torch.sum((x - cents[i - 1][None, :]) ** 2,
                                             dim=1))
        total = torch.sum(best)
        probs = torch.where(total > 0, best / torch.clamp(total, min=1e-12),
                            torch.ones_like(best))
        idx = torch.multinomial(probs, 1, generator=generator)
        cents[i] = x[idx][0]
    return cents


@dataclass
class KMeansResult:
    centroids: np.ndarray  # (K, D)
    assignments: np.ndarray  # (N,) int32
    drift: np.ndarray  # (iters,)
    k: int


_ASSIGN_CHUNK = 1 << 18  # rows per chunk of the full-set assignment


def kmeans_fit(
    data: np.ndarray,
    k: int = 0,
    iters: int = 10,
    seed: int = 0,
    sample: int = 0,
    device: DeviceLike = None,
) -> KMeansResult:
    """Full fit: k-means++ init + Lloyd, on ``device`` (None: CUDA).

    ``sample > 0`` caps the Lloyd fit at that many uniformly sampled rows,
    then assigns the FULL set against the fitted centroids in chunks of
    2**18 rows, so the device never holds more than one chunk of the data.
    The tail chunk is padded to a power of two with zero rows (at most
    O(log chunk) sizes, which the caching allocator reuses)."""
    dev = resolve_device(device)
    x_np = np.ascontiguousarray(np.asarray(data, np.float32))
    n = x_np.shape[0]
    if k <= 0:
        k = optimal_k(n)
    k = min(k, n)
    if sample and n > sample and sample >= k:
        rng = np.random.default_rng(seed)
        pick = rng.choice(n, size=sample, replace=False)
        sub = kmeans_fit(x_np[pick], k=k, iters=iters, seed=seed, device=dev)
        cent = torch.from_numpy(sub.centroids).to(dev)
        assignments = np.empty(n, np.int32)
        d = x_np.shape[1]
        for s in range(0, n, _ASSIGN_CHUNK):
            e = min(s + _ASSIGN_CHUNK, n)
            blk = x_np[s:e]
            if e - s < _ASSIGN_CHUNK:
                bucket = 1 << max(0, (e - s - 1).bit_length())
                blk = np.concatenate(
                    [blk, np.zeros((bucket - (e - s), d), np.float32)])
            a = assign_clusters(torch.from_numpy(blk).to(dev), cent)
            assignments[s:e] = a[: e - s].cpu().numpy()
        return KMeansResult(centroids=sub.centroids, assignments=assignments,
                            drift=sub.drift, k=sub.k)
    x = torch.from_numpy(x_np).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = kmeans_pp_init(gen, x, k)
    centroids, assign, drift = lloyd(x, init, k, iters)
    return KMeansResult(
        centroids=centroids.cpu().numpy(),
        assignments=assign.cpu().numpy().astype(np.int32),
        drift=drift.cpu().numpy(),
        k=k,
    )


def nearest_clusters(query: torch.Tensor, centroids: torch.Tensor,
                     n_probe: int) -> torch.Tensor:
    """The n_probe closest centroids of one query (nearest first, lowest
    index on ties)."""
    d = pairwise_sq_dists(query.reshape(1, -1), centroids)
    return topk_lowest_index(-d, n_probe)[1][0]
