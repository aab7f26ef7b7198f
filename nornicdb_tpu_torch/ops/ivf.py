"""IVF-pruned search: a cluster-contiguous layout and one probe -> score ->
top-k pass per batch (counterpart of the single-device part of
``nornicdb_tpu/ops/ivf.py``).

The corpus is re-laid out cluster-contiguous: one (K, Cmax, D) block array,
each cluster's rows contiguous and zero-padded to a shared power-of-two
Cmax. Oversized clusters spill their overflow rows into a residual segment
that every query scans, so a skewed fit costs speed, never recall.

Memory. The JAX program gathers ``blocks[probes]``, a (B, P, Cmax, D) array
that XLA may fuse into the product; eager PyTorch would materialize it (at
N = 1M, D = 1024, K = 707 one (query, probe) pair is 16.8 MB). Here each
distinct probed cluster is scored once against the whole batch, in chunks
whose working set stays under ``max_bytes``, and each query keeps the
scores of its own probes. Scores are bf16 products with float32 sums (the
``dot_scores`` idiom), ties go to the lowest flat index p * Cmax + c, as
``lax.top_k`` breaks them.

The index arithmetic of the layout build is numpy, as in the JAX package;
the rows are scattered into the block array on the device, so the host
never holds the padded block array.

Deferred: ``ShardedIVFLayout`` / ``build_sharded_ivf_layout`` wait for the
sharded corpus (mesh) slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.kernels import topk_lowest_index
from nornicdb_tpu_torch.ops.similarity import LANE, dot_scores, l2_normalize

# working set of one scoring chunk: the chunk's clusters as a bf16-rounded
# float32 copy plus the batch's scores against them
IVF_CHUNK_BYTES = 1 << 30
# rows per host-to-device copy while the layout is built
_UPLOAD_ROWS = 1 << 16


@dataclass
class IVFLayout:
    """Cluster-contiguous device layout built by build_ivf_layout."""

    blocks: torch.Tensor     # (K, Cmax, D) zero-padded cluster blocks
    counts: torch.Tensor     # (K,) int32 live rows per block
    centroids: torch.Tensor  # (K, D)
    slotmap: np.ndarray      # (K, Cmax) int32 -> corpus slot, -1 = pad
    residual: Optional[torch.Tensor]      # (Rp, D) spilled rows (None if none)
    residual_slots: np.ndarray            # (Rp,) int32 -> corpus slot, -1 = pad
    residual_valid: Optional[torch.Tensor]  # (Rp,) device mask
    cmax: int
    k: int
    # corpus LAYOUT epoch at build time: the layout serves while this
    # matches HostCorpus._layout_epoch, which bumps only when a covered row
    # is overwritten in place or the slot space remaps (grow/compact/clear)
    epoch: int

    @property
    def n_rows(self) -> int:
        return int((self.slotmap >= 0).sum() + (self.residual_slots >= 0).sum())

    @property
    def device_bytes(self) -> int:
        """Bytes the layout holds on its device."""
        return sum(t.numel() * t.element_size() for t in (
            self.blocks, self.counts, self.centroids, self.residual,
            self.residual_valid) if t is not None)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _scatter_rows(blocks: torch.Tensor, residual: Optional[torch.Tensor],
                  rows: np.ndarray, dest: np.ndarray) -> None:
    """Copy every row to its place on the device: row r goes to flat block
    row dest[r] (cluster * Cmax + rank) when dest[r] >= 0, to residual row
    -2 - dest[r] when dest[r] < -1, nowhere at -1. The rows travel in
    contiguous runs of _UPLOAD_ROWS (no host-side gather) and are
    scattered on the device."""
    flat = blocks.view(-1, blocks.shape[-1])
    for a in range(0, rows.shape[0], _UPLOAD_ROWS):
        part = torch.from_numpy(
            np.ascontiguousarray(rows[a:a + _UPLOAD_ROWS])).to(
            blocks.device, blocks.dtype)
        d = dest[a:a + _UPLOAD_ROWS]
        for target, sel, at in ((flat, d >= 0, d), (residual, d < -1, -2 - d)):
            src = np.nonzero(sel)[0]
            if src.size:
                target[torch.from_numpy(at[src]).to(blocks.device)] = part[
                    torch.from_numpy(src).to(blocks.device)]


def build_ivf_layout(
    rows: np.ndarray,
    slots: np.ndarray,
    assignments: np.ndarray,
    centroids: np.ndarray,
    dtype: torch.dtype = torch.float32,
    epoch: int = 0,
    max_block_factor: float = 2.0,
    device: DeviceLike = None,
) -> IVFLayout:
    """Build the block layout from live rows, on ``device`` (None: CUDA).

    rows:        (N, D) float32, already L2-normalized (corpus invariant)
    slots:       (N,) original corpus slot per row
    assignments: (N,) cluster id per row
    centroids:   (K, D)
    max_block_factor: Cmax is capped at ~factor x mean cluster size;
        overflow rows spill to the residual segment.
    """
    dev = resolve_device(device)
    n, d = rows.shape
    k = centroids.shape[0]
    mean = max(1, n // max(1, k))
    cmax = _next_pow2(min(max(int(mean * max_block_factor), 8), n))
    # sort by cluster (stable), rank each row within its cluster: rank <
    # Cmax lands in the block array, the rest spills
    keep = np.nonzero((assignments >= 0) & (assignments < k))[0]
    order = keep[np.argsort(assignments[keep], kind="stable")]
    sorted_assign = assignments[order]
    counts_all = np.bincount(sorted_assign, minlength=k)
    starts = np.concatenate(([0], np.cumsum(counts_all)[:-1]))
    rank = np.arange(sorted_assign.size) - starts[sorted_assign]
    in_block = rank < cmax
    c_idx = sorted_assign[in_block].astype(np.int64)
    p_idx = rank[in_block].astype(np.int64)
    src = order[in_block]
    slotmap = np.full((k, cmax), -1, np.int32)
    slotmap[c_idx, p_idx] = slots[src]
    counts = np.minimum(counts_all, cmax).astype(np.int32)
    spill = order[~in_block]
    # each row's place: flat block row, -2 - residual row, or -1 (none)
    dest = np.full(n, -1, np.int64)
    dest[src] = c_idx * cmax + p_idx
    dest[spill] = -2 - np.arange(spill.size)
    blocks = torch.zeros((k, cmax, d), dtype=dtype, device=dev)
    if spill.size:
        rp = ((spill.size + LANE - 1) // LANE) * LANE
        residual = torch.zeros((rp, d), dtype=dtype, device=dev)
        residual_slots = np.full(rp, -1, np.int32)
        residual_slots[: spill.size] = slots[spill]
        residual_valid = torch.from_numpy(residual_slots >= 0).to(dev)
    else:
        residual = None
        residual_slots = np.empty(0, np.int32)
        residual_valid = None
    _scatter_rows(blocks, residual, rows, dest)
    return IVFLayout(
        blocks=blocks,
        counts=torch.from_numpy(counts).to(dev),
        centroids=torch.tensor(np.asarray(centroids, np.float32),
                               dtype=dtype, device=dev),
        slotmap=slotmap,
        residual=residual,
        residual_slots=residual_slots,
        residual_valid=residual_valid,
        cmax=cmax,
        k=k,
        epoch=epoch,
    )


def _ivf_topk_program(
    queries: torch.Tensor,    # (B, D) L2-normalized
    centroids: torch.Tensor,  # (K, D)
    blocks: torch.Tensor,     # (K, Cmax, D)
    counts: torch.Tensor,     # (K,)
    n_probe: int,
    k: int,
    max_bytes: int = IVF_CHUNK_BYTES,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (vals (B, k'), flat candidate idx (B, k'), probes (B, P)),
    k' = min(k, P * Cmax). Flat idx encodes (probe position p, row c) as
    p * Cmax + c. Each distinct probed cluster is scored once against the
    whole batch, ``max_bytes`` of working set at a time."""
    b, d = queries.shape
    cmax = blocks.shape[1]
    _, probes = topk_lowest_index(dot_scores(queries, centroids), n_probe)
    uniq, inv = torch.unique(probes, return_inverse=True)
    qb = queries.to(torch.bfloat16).to(torch.float32)
    scores = torch.empty((b, n_probe, cmax), dtype=torch.float32,
                         device=queries.device)
    per = max(1, max_bytes // (cmax * d * 6 + b * cmax * 4))
    for a in range(0, uniq.numel(), per):
        z = min(a + per, uniq.numel())
        cb = blocks[uniq[a:z]].to(torch.bfloat16).to(torch.float32)
        s = (qb @ cb.reshape(-1, d).T).reshape(b, z - a, cmax)
        bi, pi = ((inv >= a) & (inv < z)).nonzero(as_tuple=True)
        scores[bi, pi] = s[bi, inv[bi, pi] - a]
    live = (torch.arange(cmax, device=queries.device)[None, None, :]
            < counts[probes][:, :, None])
    flat = torch.where(live, scores, float("-inf")).reshape(b, -1)
    vals, idx = topk_lowest_index(flat, min(k, flat.shape[1]))
    return vals, idx, probes


def _residual_topk(queries: torch.Tensor, residual: torch.Tensor,
                   valid: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    scores = dot_scores(queries, residual)
    scores = torch.where(valid[None, :], scores, float("-inf"))
    return topk_lowest_index(scores, min(k, scores.shape[1]))


def ivf_search(
    layout: IVFLayout,
    queries: np.ndarray,
    k: int,
    n_probe: int,
    max_bytes: int = IVF_CHUNK_BYTES,
) -> tuple[np.ndarray, np.ndarray]:
    """IVF top-k. queries (B, D) need not be normalized. Returns (scores
    (B, k), corpus slots (B, k)); slot -1 = no candidate (short clusters).
    Scores of returned rows are the same bf16-product scores as the full
    scan's."""
    q2 = np.atleast_2d(np.asarray(queries, np.float32))
    b = q2.shape[0]
    # the JAX package's candidate width: k rounded up to a power of two
    k_prog = _next_pow2(max(k, 8))
    qn = l2_normalize(torch.from_numpy(q2).to(layout.blocks.device))
    n_probe = max(1, min(n_probe, layout.k))
    vals, idx, probes = _ivf_topk_program(
        qn, layout.centroids, layout.blocks, layout.counts, n_probe, k_prog,
        max_bytes)
    vals = vals.cpu().numpy()[:, :k]
    idx = idx.cpu().numpy()[:, :k]
    probes_np = probes.cpu().numpy()
    # resolve flat (p, c) -> corpus slot through the host slotmap
    cluster_ids = np.take_along_axis(probes_np, idx // layout.cmax, axis=1)
    slots = layout.slotmap[cluster_ids, idx % layout.cmax]
    slots = np.where(np.isfinite(vals), slots, -1)
    if layout.residual is not None:
        rvals, ridx = _residual_topk(qn, layout.residual,
                                     layout.residual_valid, k_prog)
        rvals = rvals.cpu().numpy()
        rslots = layout.residual_slots[ridx.cpu().numpy()]
        rslots = np.where(np.isfinite(rvals), rslots, -1)
        # merge the two k-lists per query (host merge of 2k items)
        merged_scores = np.concatenate([vals, rvals], axis=1)
        merged_slots = np.concatenate([slots, rslots], axis=1)
        order = np.argsort(-merged_scores, axis=1)[:, :k]
        vals = np.take_along_axis(merged_scores, order, axis=1)
        slots = np.take_along_axis(merged_slots, order, axis=1)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
        slots = np.pad(slots, ((0, 0), (0, pad)), constant_values=-1)
    return vals, slots
