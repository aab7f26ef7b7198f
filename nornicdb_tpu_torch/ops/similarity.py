"""Batch vector similarity + top-k in PyTorch, and the device-resident corpus.

Counterpart of ``nornicdb_tpu/ops/similarity.py`` (same names, same
contracts). Cosine scoring is a matmul over L2-normalized rows. Large
corpora on the card go through the hand-written streaming top-k kernels
(``ops/kernels.py``), which never materialize the (Q, N) score matrix.
Elsewhere the scores come from one matmul and an exact top-k, which stands
in for XLA's ``approx_max_k``: the recall is at least what the approximate
one promised.

Tie order: every top-k here breaks value ties by the lowest index, as
``lax.top_k`` does (``kernels.topk_lowest_index``), so exact mode returns
the same ids in the same order as the JAX package.

IVF cluster pruning: ``DeviceCorpus.cluster`` / ``set_clusters`` build a
cluster-contiguous layout (``ops/ivf.py``) and ``search(n_probe=...)``
scores only the probed clusters, while the layout epoch says the layout
still describes the rows.

Write-behind: ``HostCorpus.start_uploader`` runs the reference's uploader
thread, which patches dirty blocks between queries so a query after a write
burst waits for a bounded patch.

Deferred to later slices: the BackendManager lifecycle gate and the
DEGRADED_CPU host serving (with it the stash of a cluster fit delivered
while degraded), and the device-memory accounting of the telemetry plane.
Here the device gate is a plain device check: the port never falls back to
the CPU on its own.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.errors import DeviceUnavailable
from nornicdb_tpu_torch.ops.host_search import format_topk_results
from nornicdb_tpu_torch.ops.kmeans import kmeans_fit, nearest_clusters
from nornicdb_tpu_torch.ops.kernels import (
    pick_tile_n,
    quantize_rows,
    streaming_cosine_topk,
    streaming_cosine_topk_int8,
    streaming_rows_for,
    topk_lowest_index,
)

logger = logging.getLogger(__name__)

LANE = 128  # row alignment of corpus capacities (and the kernels' tile unit)


def pad_to_multiple(n: int, m: int = LANE) -> int:
    return ((n + m - 1) // m) * m


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization, norm taken in float32."""
    norm = torch.sqrt(torch.sum(x.to(torch.float32) ** 2, dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps)).to(x.dtype)


def dot_scores(
    queries: torch.Tensor, corpus: torch.Tensor, use_bf16: bool = True
) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) float32 dot products. With use_bf16 the
    operands are rounded to bf16 and multiplied with float32 products and
    sums (JAX's bf16 dot with preferred_element_type=float32)."""
    dt = torch.bfloat16 if use_bf16 else torch.float32
    return queries.to(dt).to(torch.float32) @ corpus.to(dt).to(torch.float32).T


def cosine_scores(
    queries: torch.Tensor, corpus: torch.Tensor, use_bf16: bool = True
) -> torch.Tensor:
    """Full cosine similarity: normalizes both sides then one matmul."""
    return dot_scores(l2_normalize(queries), l2_normalize(corpus), use_bf16)


def cosine_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    normalized: bool = True,
    use_bf16: bool = True,
    exact: bool = False,
    recall_target: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cosine scoring + top-k over a (Np, D) corpus with a (Np,) bool
    validity mask (False rows score -inf). Returns (values (Q, k), indices
    (Q, k)). The top-k is always exact (PyTorch has no approx_max_k), so
    ``exact`` and ``recall_target`` change nothing: recall is 1.0."""
    del exact, recall_target
    q = queries if normalized else l2_normalize(queries)
    c = corpus if normalized else l2_normalize(corpus)
    scores = dot_scores(q, c, use_bf16)
    scores = torch.where(valid[None, :], scores, float("-inf"))
    return topk_lowest_index(scores, k)


def masked_dot_topk(
    query: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Graph-filtered top-k for the Cypher ``VectorTopK`` operator: one
    (1, D) x (Np, D) float32 product with the surviving rows as a validity
    mask. Returns ``(scores (Np,), top_vals (k,))``."""
    s = dot_scores(query[None, :], corpus, use_bf16=False)[0]
    s = torch.where(valid, s, float("-inf"))
    return s, topk_lowest_index(s[None, :], k)[0][0]


# streaming kernels engage on the card above this corpus size; below it the
# (Q, N) score matrix is small and one matmul + top-k is the cheaper path
STREAMING_MIN_ROWS = 65_536

# bin-reduction strategy of the streaming kernels ("sort" | "approx" |
# "pallas"; kernels._topk_bins). "pallas" selects the hand-written extract
# kernel (the name is kept so the JAX package's setting means the same
# here); "approx" runs the exact sort. Validated at import so a typo fails
# before the first query.
TOPK_EPILOGUE = os.environ.get("NORNICDB_TOPK_EPILOGUE", "sort")
if TOPK_EPILOGUE not in ("sort", "approx", "pallas"):
    raise ValueError(
        f"NORNICDB_TOPK_EPILOGUE={TOPK_EPILOGUE!r}: "
        "must be one of sort|approx|pallas"
    )


def _streaming_plan(n: int, k: int) -> Optional[tuple[int, int]]:
    """(tile_n, rows) of the streaming kernels for this corpus, or None when
    they do not apply (the JAX package's rule): the tile must divide n and
    the bins must hold a full top-k. The kernels take any D and any float
    corpus type, so nothing else sends a search elsewhere."""
    tile = pick_tile_n(n)
    rows = min(streaming_rows_for(k, tile), max(n // tile, 1))
    if n % tile != 0 or rows * tile < k:
        return None
    return tile, rows


def topk_backend(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    exact: bool = False,
    use_bf16: bool = True,
    streaming: Optional[bool] = None,
    quantized: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k dispatch for normalized inputs: the streaming kernel (one
    corpus read, no (Q, N) materialization) on the card for large corpora,
    else one matmul + exact top-k. `streaming=None` auto-selects; tests
    force it on small CPU corpora, where the kernel's plain version runs.
    The kernel scores in bf16, so use_bf16=False keeps the float32 path.
    `quantized=(c_i8, c_scale)` (quantize_rows of the same corpus) engages
    the int8 kernel."""
    n = corpus.shape[0]
    if streaming is None:
        streaming = (
            (not exact) and use_bf16 and corpus.is_cuda
            and n >= STREAMING_MIN_ROWS
        )
    if streaming and not exact:
        plan = _streaming_plan(n, k)
        if plan is not None:
            tile, rows = plan
            if quantized is not None:
                q_i8, q_scale = quantize_rows(queries)
                return streaming_cosine_topk_int8(
                    q_i8, q_scale, quantized[0], quantized[1], valid,
                    min(k, n), tile_n=tile, rows=rows,
                    epilogue=TOPK_EPILOGUE,
                )
            return streaming_cosine_topk(
                queries, corpus, valid, min(k, n), tile_n=tile, rows=rows,
                epilogue=TOPK_EPILOGUE,
            )
    return cosine_topk(
        queries, corpus, valid, k, normalized=True, use_bf16=use_bf16,
        exact=exact,
    )


def cosine_topk_int8_xla(
    queries: torch.Tensor,
    c_i8: torch.Tensor,
    c_scale: torch.Tensor,
    valid: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scoring over an int8-resident corpus where the streaming int8 kernel
    does not apply (small corpora, unsupported shapes): the codes enter a
    bf16-rounded product (int8 values are exact in bf16), the per-row
    dequant divides in the float32 epilogue. Queries stay float32/bf16.
    The top-k is exact here (the JAX package's approx_max_k has no torch
    twin); served scores come from the caller's rescore either way."""
    scores = dot_scores(queries, c_i8, use_bf16=True) / torch.clamp(
        c_scale, min=1e-9)[None, :]
    scores = torch.where(valid[None, :], scores, float("-inf"))
    return topk_lowest_index(scores, k)


def topk_backend_int8(
    queries: torch.Tensor,
    c_i8: torch.Tensor,
    c_scale: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    streaming: Optional[bool] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k dispatch for an int8-RESIDENT corpus (no float copy on the
    device): the streaming int8 kernel on the card at scale, else
    cosine_topk_int8_xla. ``c_scale`` follows the quantize_rows convention
    (x ~= int8 / scale)."""
    n = c_i8.shape[0]
    if streaming is None:
        streaming = c_i8.is_cuda and n >= STREAMING_MIN_ROWS
    if streaming:
        plan = _streaming_plan(n, k)
        if plan is not None:
            tile, rows = plan
            q_i8, q_scale = quantize_rows(queries)
            return streaming_cosine_topk_int8(
                q_i8, q_scale, c_i8, c_scale, valid, min(k, n),
                tile_n=tile, rows=rows, epilogue=TOPK_EPILOGUE,
            )
    return cosine_topk_int8_xla(queries, c_i8, c_scale, valid, min(k, n))


def score_subset(
    query: torch.Tensor, corpus: torch.Tensor, indices: torch.Tensor,
    use_bf16: bool = True,
) -> torch.Tensor:
    """Re-score of candidate rows: gather, then one small product."""
    return dot_scores(query.reshape(1, -1), corpus[indices], use_bf16)[0]


def euclidean_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances via |x|^2 - 2xy + |y|^2 (float32)."""
    qn = torch.sum(queries.to(torch.float32) ** 2, dim=1, keepdim=True)
    cn = torch.sum(corpus.to(torch.float32) ** 2, dim=1)[None, :]
    cross = dot_scores(queries, corpus, use_bf16=False)
    return torch.clamp(qn - 2.0 * cross + cn, min=0.0)


def merge_topk(
    values: torch.Tensor, indices: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard/per-chunk top-k lists into a global top-k.

    values/indices: (S, Q, k) stacked partial results with GLOBAL indices.
    Returns (Q, k). Sentinel contract: a merged entry whose value is not
    finite gets index -1, so a padding slot's index can never surface as a
    candidate. Ties break by the lowest flattened (shard-major) position,
    i.e. lowest shard first, then best per-shard rank."""
    s, q, kk = values.shape
    flat_v = values.permute(1, 0, 2).reshape(q, s * kk)
    flat_i = indices.permute(1, 0, 2).reshape(q, s * kk)
    best_v, pos = topk_lowest_index(flat_v, k)
    best_i = torch.gather(flat_i, 1, pos)
    best_i = torch.where(torch.isfinite(best_v), best_i,
                         torch.full_like(best_i, -1))
    return best_v, best_i


# ------------------------------------------------------------- device sync
# dirty-tracking granularity: one block = one LANE-aligned row group. Writes
# mark only the blocks they touch; sync patches only dirty blocks.
BLOCK_ROWS = LANE

# above this fraction of dirty blocks, one contiguous full transfer beats
# many small patches
FULL_SYNC_DIRTY_FRACTION = 0.5


@dataclass
class SyncStats:
    """Host-to-device sync accounting for one corpus."""

    patches: int = 0          # incremental patch syncs (1 per sync pass)
    full_uploads: int = 0     # whole-corpus transfers (first sync/grow/…)
    bytes_uploaded: int = 0   # total host bytes shipped to the device
    patch_bytes: int = 0      # subset of bytes_uploaded moved by patching
    rows_patched: int = 0
    uploader_runs: int = 0    # write-behind background sync cycles
    uploader_errors: int = 0  # of them, the ones that raised (logged)
    query_stall_s: float = 0.0  # time the query path spent blocked in sync
    # device search programs launched (one per fused batch when queries go
    # through the QueryBatcher): the one-program-per-fused-batch counter
    device_dispatches: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


def _coalesce_runs(
    blocks: Sequence[int], cap_blocks: int
) -> list[tuple[int, int]]:
    """Coalesce sorted dirty block ids into (start_block, n_blocks) upload
    runs. Blocks separated by <= 2 clean blocks merge into one run, and run
    lengths round up to powers of two; the start shifts back when the
    padding would overrun capacity. Padding rows rewrite identical host
    bytes, so overlap between padded runs is harmless."""
    runs: list[tuple[int, int]] = []
    i = 0
    while i < len(blocks):
        j = i
        while j + 1 < len(blocks) and blocks[j + 1] - blocks[j] <= 3:
            j += 1
        start, n = blocks[i], blocks[j] - blocks[i] + 1
        n = min(1 << (n - 1).bit_length(), cap_blocks)
        runs.append((min(start, cap_blocks - n), n))
        i = j + 1
    return runs


# ----------------------------------------------------------------- host API
class HostCorpus:
    """Host-side state machine of the device corpus: id->slot map, padded
    row matrix, tombstone removal, deferred ratio-triggered compaction,
    capacity growth, plus the block-granular dirty tracking and incremental
    host-to-device sync engine (subclasses supply _upload_full/_apply_patch
    for their device layout). The sync runs on the query path, and with
    ``start_uploader`` also on a write-behind thread between queries. `align`
    keeps the row count a multiple of the kernels' tile unit."""

    def __init__(
        self,
        dims: int,
        align: int = LANE,
        capacity: int = 0,
        compact_ratio: float = 0.3,
    ):
        self.dims = dims
        self.align = align
        self.compact_ratio = compact_ratio
        cap = max(capacity, align)
        cap = ((cap + align - 1) // align) * align
        self._ids: list[Optional[str]] = []
        self._slot_of: dict[str, int] = {}
        self._host = np.zeros((cap, dims), np.float32)
        self._valid = np.zeros(cap, bool)
        self._tombstones = 0
        # mutators mark only the BLOCK_ROWS-row blocks they touch;
        # _full_dirty forces a whole-corpus upload (first sync,
        # grow/compact/clear)
        self._dirty_blocks: set[int] = set()
        self._full_dirty = True
        self._compact_pending = False
        # guards host arrays + dirty sets + device-buffer swaps against
        # concurrent writers and searchers
        self._sync_lock = threading.RLock()
        # searches borrowing the device buffer; while > 0 the patcher must
        # not write into the buffer they hold. device_arrays() leaks an
        # unscoped reference and clears _donation_ok for good.
        self._readers = 0
        self._donation_ok = True
        self.sync_stats = SyncStats()
        self._epoch = 0  # bumps on every write
        # layout epoch: bumps ONLY when a mutation invalidates derived
        # layouts (the IVF blocks hold row copies): an in-place overwrite of
        # a covered slot, or any slot-space remap (grow/compact/clear). New
        # ids and removals leave a fitted layout valid: fresh slots are in no
        # block, and removed slots filter out at result time.
        self._layout_epoch = 0
        self._layout_slots: Optional[np.ndarray] = None  # bool per slot
        # write-behind uploader (start_uploader): coalesces dirty blocks in
        # the background so the query path rarely stalls on a sync
        self._uploader: Optional[threading.Thread] = None
        self._uploader_stop = threading.Event()
        self._uploader_wake = threading.Event()
        self._uploader_interval = 0.002

    def __len__(self) -> int:
        return len(self._slot_of)

    @property
    def capacity(self) -> int:
        return self._host.shape[0]

    # -- dirty-block bookkeeping (all called under _sync_lock) -------------
    def _mark_rows_dirty(self, start: int, stop: int) -> None:
        self._dirty_blocks.update(
            range(start // BLOCK_ROWS, (stop - 1) // BLOCK_ROWS + 1)
        )

    def _mark_all_dirty(self) -> None:
        self._full_dirty = True
        self._dirty_blocks.clear()

    def _note_overwrite(self, slot: int) -> None:
        """In-place update of a slot covered by a derived layout: the IVF
        blocks hold a COPY of the row, so the layout would serve the stale
        vector; it must rebuild (layout epoch bump)."""
        ls = self._layout_slots
        if ls is not None and slot < ls.size and ls[slot]:
            self._layout_epoch += 1

    def add(self, id_: str, vector: np.ndarray) -> None:
        v = np.asarray(vector, np.float32)
        norm = float(np.linalg.norm(v))
        if norm > 1e-12:
            v = v / norm
        with self._sync_lock:
            slot = self._slot_of.get(id_)
            if slot is None:
                if len(self._ids) >= self.capacity and self._compact_pending:
                    # reclaim tombstoned slots before paying for a capacity
                    # doubling
                    self._compact()
                slot = len(self._ids)
                if slot >= self.capacity:
                    self._grow()
                self._ids.append(id_)
                self._slot_of[id_] = slot
            else:
                self._note_overwrite(slot)
            self._host[slot] = v
            self._valid[slot] = True
            self._mark_rows_dirty(slot, slot + 1)
            self._epoch += 1
        self._wake_uploader()

    def add_batch(self, ids: list[str], vectors: np.ndarray) -> None:
        if not ids:
            return
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = vectors / np.maximum(norms, 1e-12)
        with self._sync_lock:
            all_new = len(set(ids)) == len(ids) and not any(
                i in self._slot_of for i in ids
            )
            if all_new:
                # bulk-ingest fast path: one slice assignment into the slot
                # tail instead of a Python loop per row
                if (
                    len(self._ids) + len(ids) > self.capacity
                    and self._compact_pending
                ):
                    self._compact()  # reclaim tombstones before growing
                start = len(self._ids)
                end = start + len(ids)
                if end > self.capacity:
                    self._grow(min_capacity=end)
                self._host[start:end] = vectors
                self._valid[start:end] = True
                self._ids.extend(ids)
                self._slot_of.update(
                    (id_, start + i) for i, id_ in enumerate(ids)
                )
                self._mark_rows_dirty(start, end)
            else:
                for i, id_ in enumerate(ids):
                    slot = self._slot_of.get(id_)
                    if slot is None:
                        if (
                            len(self._ids) >= self.capacity
                            and self._compact_pending
                        ):
                            self._compact()
                        slot = len(self._ids)
                        if slot >= self.capacity:
                            self._grow(min_capacity=slot + len(ids) - i)
                        self._ids.append(id_)
                        self._slot_of[id_] = slot
                    else:
                        self._note_overwrite(slot)
                    self._host[slot] = vectors[i]
                    self._valid[slot] = True
                    self._mark_rows_dirty(slot, slot + 1)
            self._epoch += 1
        self._wake_uploader()

    def remove(self, id_: str) -> bool:
        with self._sync_lock:
            slot = self._slot_of.pop(id_, None)
            if slot is None:
                return False
            self._ids[slot] = None
            self._valid[slot] = False
            self._tombstones += 1
            self._mark_rows_dirty(slot, slot + 1)
            self._epoch += 1
            if (
                self._ids
                and self._tombstones / len(self._ids) > self.compact_ratio
            ):
                # deferred: the rewrite + full re-upload runs coalesced on
                # the write-behind uploader (or the next sync), never on the
                # caller's write path
                self._compact_pending = True
        self._wake_uploader()
        return True

    # -- inspection / lifecycle --------------------------------------------
    def has(self, id_: str) -> bool:
        with self._sync_lock:
            return id_ in self._slot_of

    def get(self, id_: str) -> Optional[np.ndarray]:
        """The stored (normalized) vector, or None when absent. Slot lookup
        and row read are one atomic view (a deferred compaction remaps)."""
        with self._sync_lock:
            slot = self._slot_of.get(id_)
            if slot is None:
                return None
            return self._host[slot].copy()

    def clear(self) -> None:
        with self._sync_lock:
            cap = self.capacity
            self._ids = []
            self._slot_of = {}
            self._host = np.zeros((cap, self.dims), np.float32)
            self._valid = np.zeros(cap, bool)
            self._tombstones = 0
            self._compact_pending = False
            self._mark_all_dirty()
            self._epoch += 1
            self._layout_epoch += 1

    def stats(self) -> dict:
        return {
            "count": len(self._slot_of),
            "capacity": self.capacity,
            "dims": self.dims,
            "tombstones": self._tombstones,
            "epoch": self._epoch,
            "layout_epoch": self._layout_epoch,
            "dirty_blocks": len(self._dirty_blocks),
            "memory_bytes": self.memory_usage(),
            "sync": self.sync_stats.as_dict(),
        }

    def memory_usage(self) -> int:
        return int(self._host.nbytes + self._valid.nbytes)

    def export_host_state(self) -> dict:
        """Consistent copies of the host arrays + slot map:
        ``{"rows", "valid", "ids", "epoch", "count", "dims"}``, slot layout
        exported as is (no forced compaction)."""
        with self._sync_lock:
            return {
                "rows": self._host.copy(),
                "valid": self._valid.copy(),
                "ids": list(self._ids),
                "epoch": self._epoch,
                "count": len(self._slot_of),
                "dims": self.dims,
            }

    def save(self, path: str) -> None:
        """Persist live ids + vectors (tombstones are not serialized); the
        same ``.npz`` layout the JAX package writes."""
        with self._sync_lock:
            live = [(i, id_) for i, id_ in enumerate(self._ids)
                    if id_ is not None]
            ids = np.asarray([id_ for _, id_ in live])
            vecs = (self._host[[i for i, _ in live]].copy()
                    if live else np.zeros((0, self.dims), np.float32))
        np.savez_compressed(path, ids=ids, vectors=vecs,
                            dims=np.asarray(self.dims))

    @classmethod
    def load(cls, path: str, **kwargs) -> "HostCorpus":
        """Read a checkpoint written by ``save`` here or by the JAX
        package's ``HostCorpus.save``."""
        with np.load(path, allow_pickle=False) as data:
            if any(k not in data for k in ("vectors", "ids", "dims")):
                raise ValueError(f"{path} is not a corpus checkpoint")
            dims = int(data["dims"])
            out = cls(dims=dims, **kwargs)
            vecs = data["vectors"]
            ids = [str(i) for i in data["ids"]]
            if ids:
                out.add_batch(ids, vecs)
        return out

    def _grow(self, min_capacity: int = 0) -> None:
        need = max(self.capacity * 2, min_capacity, self.align)
        new_cap = ((need + self.align - 1) // self.align) * self.align
        host = np.zeros((new_cap, self.dims), np.float32)
        valid = np.zeros(new_cap, bool)
        host[: self._host.shape[0]] = self._host
        valid[: self._valid.shape[0]] = self._valid
        self._host, self._valid = host, valid
        # shape change: the resident device buffer cannot be patched
        self._mark_all_dirty()
        self._layout_epoch += 1

    def _compact(self) -> None:
        live = [(i, id_) for i, id_ in enumerate(self._ids) if id_ is not None]
        host = np.zeros_like(self._host)
        valid = np.zeros_like(self._valid)
        ids: list[Optional[str]] = []
        slot_of: dict[str, int] = {}
        for new_slot, (old_slot, id_) in enumerate(live):
            host[new_slot] = self._host[old_slot]
            valid[new_slot] = True
            ids.append(id_)
            slot_of[id_] = new_slot
        self._host, self._valid = host, valid
        self._ids, self._slot_of = ids, slot_of
        self._tombstones = 0
        self._compact_pending = False
        self._mark_all_dirty()
        self._epoch += 1
        self._layout_epoch += 1

    # -- device sync engine ------------------------------------------------
    # Subclasses provide the device buffers through three hooks:
    # _device_ready (is there a patchable resident buffer), _upload_full
    # (whole-corpus transfer) and _apply_patch (one contiguous row run).
    # _sync below owns the policy: deferred compaction, patch-vs-full
    # choice, run coalescing, stats.
    def _device_ready(self) -> bool:
        dev = getattr(self, "_dev", None)
        return dev is not None and int(dev.shape[0]) == self.capacity

    def _upload_full(self) -> None:
        raise NotImplementedError

    def _apply_patch(
        self, start_row: int, rows: np.ndarray, valid_rows: np.ndarray,
        in_place: bool,
    ) -> None:
        raise NotImplementedError

    def _sync(self, _record_stall: bool = True) -> None:
        """Bring the resident device buffer up to date with the host.

        Incremental path: dirty blocks coalesce into contiguous runs patched
        into the resident buffer, O(dirty rows) transferred. Full upload
        only on first sync, grow/compact/clear, or when most of the corpus
        is dirty. In-flight searches see either the pre-patch or the
        post-patch buffer, never a half-patched one: while a search borrows
        the buffer the patch writes a new one, and it patches in place only
        when nobody borrows it (the JAX package's buffer donation). The
        uploader's passes (``_record_stall=False``) are not query stall."""
        with self._sync_lock:
            if self._compact_pending:
                self._compact()  # coalesced: one rewrite for the whole burst
            needs_full = self._full_dirty or not self._device_ready()
            if not needs_full and not self._dirty_blocks:
                return
            t0 = time.perf_counter()
            s = self.sync_stats
            cap_blocks = max(1, self.capacity // BLOCK_ROWS)
            if (
                not needs_full
                and len(self._dirty_blocks)
                > cap_blocks * FULL_SYNC_DIRTY_FRACTION
            ):
                needs_full = True
            if needs_full:
                self._upload_full()
                s.full_uploads += 1
                s.bytes_uploaded += int(self._host.nbytes + self._valid.nbytes)
            else:
                in_place = self._readers == 0 and self._donation_ok
                for start_b, n_b in _coalesce_runs(
                    sorted(self._dirty_blocks), cap_blocks
                ):
                    r0 = start_b * BLOCK_ROWS
                    r1 = min((start_b + n_b) * BLOCK_ROWS, self.capacity)
                    rows, vrows = self._host[r0:r1], self._valid[r0:r1]
                    self._apply_patch(r0, rows, vrows, in_place)
                    nbytes = int(rows.nbytes + vrows.nbytes)
                    s.patch_bytes += nbytes
                    s.bytes_uploaded += nbytes
                    s.rows_patched += r1 - r0
                s.patches += 1
            self._full_dirty = False
            self._dirty_blocks.clear()
            if _record_stall:
                s.query_stall_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def _borrow_device(self):
        """Sync, then pin the serving buffer for the duration of a search.
        While any borrower is active the patcher writes a new buffer instead
        of patching in place, so readers keep their snapshot (a double
        buffer).

        Yields (dev, valid, i8, ids, slot_of). ids/slot_of are the host
        mappings captured under the lock: compaction/clear REBIND them, so
        a borrower resolving slots through these references never sees a
        concurrent writer's compaction remap the slot space mid-search."""
        with self._sync_lock:
            self._sync()
            self._readers += 1
            dev, valid = self._dev, self._dev_valid
            i8 = getattr(self, "_dev_i8", None)
            ids, slot_of = self._ids, self._slot_of
        if dev is None:
            with self._sync_lock:
                self._readers -= 1
            raise DeviceUnavailable("no resident device buffer")
        try:
            yield dev, valid, i8, ids, slot_of
        finally:
            with self._sync_lock:
                self._readers -= 1

    # -- write-behind uploader ---------------------------------------------
    def start_uploader(self, interval: float = 0.002) -> None:
        """Start the write-behind host-to-device sync thread: it coalesces
        dirty blocks and patches them between queries, so a query arriving
        after a write burst waits only for what the uploader has not patched
        yet. `interval` is the coalescing window after the first write of a
        burst. The thread shares ``_sync_lock`` with the query path's sync,
        so a search never reads a half-patched buffer."""
        with self._sync_lock:
            if self._uploader is not None:
                return
            self._uploader_interval = interval
            self._uploader_stop = threading.Event()
            self._uploader_wake = threading.Event()
            self._uploader = threading.Thread(
                target=self._uploader_loop, name="nornicdb-uploader",
                daemon=True,
            )
            self._uploader.start()

    def stop_uploader(self) -> None:
        with self._sync_lock:
            t, self._uploader = self._uploader, None
            # capture THIS thread's events under the lock: a concurrent
            # start_uploader() swaps in fresh ones, and signalling those
            # would stop the new thread while the old one runs on
            stop, wake = self._uploader_stop, self._uploader_wake
        if t is None:
            return
        stop.set()
        wake.set()
        t.join(timeout=5.0)

    def _wake_uploader(self) -> None:
        if self._uploader is not None:
            self._uploader_wake.set()

    def _uploader_loop(self) -> None:
        stop, wake = self._uploader_stop, self._uploader_wake
        while not stop.is_set():
            if not wake.wait(timeout=0.25):
                continue
            wake.clear()
            # coalescing window: let the write burst accumulate so one patch
            # covers it, instead of one patch per row
            if stop.wait(self._uploader_interval):
                break
            try:
                self._sync(_record_stall=False)
                self.sync_stats.uploader_runs += 1
            except Exception:  # noqa: BLE001 - the thread must outlive a
                # failed pass; the next query's sync retries on its path
                self.sync_stats.uploader_errors += 1
                logger.exception("write-behind device sync failed")

    def _format_results(
        self,
        vals: np.ndarray,
        idx: np.ndarray,
        n_queries: int,
        k: int,
        min_similarity: float,
        ids: Optional[list[Optional[str]]] = None,
    ) -> list[list[tuple[str, float]]]:
        """Resolve slot indices to ids. `ids` must be the slot map captured
        with the buffer the indices came from (_borrow_device)."""
        ids = self._ids if ids is None else ids
        return format_topk_results(
            vals, idx, n_queries, k, min_similarity, ids
        )


class DeviceCorpus(HostCorpus):
    """Single-device resident, padded, normalized embedding matrix with
    incremental dirty-block host sync. ``device=None`` means CUDA and raises
    DeviceUnavailable without a card; pass ``device="cpu"`` for the CPU.
    ``quantize=True`` keeps an int8 mirror (codes + per-row scales) beside
    the float32 rows and serves large corpora through the int8 kernel.

    IVF cluster pruning: after ``cluster()`` (or ``set_clusters``) a search
    with ``n_probe > 0`` scores only the rows of the n_probe nearest
    clusters. Stale assignments cost recall, never correctness (scores stay
    exact); the service reclusters and re-tunes on drift."""

    def __init__(
        self,
        dims: int,
        capacity: int = LANE,
        dtype: torch.dtype = torch.float32,
        compact_ratio: float = 0.3,
        quantize: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        super().__init__(dims, align=LANE, capacity=capacity,
                         compact_ratio=compact_ratio)
        self.dtype = dtype
        self.quantize = quantize
        self._dev: Optional[torch.Tensor] = None
        self._dev_valid: Optional[torch.Tensor] = None
        self._dev_i8: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        # IVF state: (K, D) centroids + per-slot assignment (-1 = unassigned)
        self._centroids: Optional[torch.Tensor] = None
        self._assignments: Optional[np.ndarray] = None
        # cluster-contiguous layout (ops/ivf.py); serves only while its
        # epoch matches the corpus layout epoch
        self._ivf = None

    def _device_gate(self) -> None:
        """Plain device check: the card must still be there. No fallback."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )

    def _to_device(self, a: np.ndarray, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
        # always a copy: a CPU "device" buffer must not alias the host rows
        # that writers mutate in place
        return torch.from_numpy(a).to(self.device, dtype=dtype, copy=True)

    def _upload_full(self) -> None:
        """Whole-corpus host-to-device transfer (first sync / grow /
        compact / clear)."""
        self._dev = self._to_device(self._host, self.dtype)
        self._dev_valid = self._to_device(self._valid)
        if self.quantize:
            self._dev_i8 = quantize_rows(self._dev)

    def _apply_patch(
        self, start_row: int, rows: np.ndarray, valid_rows: np.ndarray,
        in_place: bool,
    ) -> None:
        """Patch one contiguous dirty run into the resident buffers; the
        int8 mirror requantizes only the patched rows (quantization is
        per row, so that equals requantizing the whole corpus). In place
        when no search borrows the buffer, else into fresh buffers so a
        borrower's snapshot stays whole."""
        stop = start_row + rows.shape[0]
        rows_dev = self._to_device(rows, self.dtype)
        try:
            targets = [(self._dev, rows_dev),
                       (self._dev_valid, self._to_device(valid_rows))]
            if self.quantize and self._dev_i8 is not None:
                i8, s = quantize_rows(rows_dev)
                targets += [(self._dev_i8[0], i8), (self._dev_i8[1], s)]
            out = []
            for buf, patch in targets:
                if not in_place:
                    buf = buf.clone()
                buf[start_row:stop].copy_(patch)
                out.append(buf)
            self._dev, self._dev_valid = out[0], out[1]
            if len(out) > 2:
                self._dev_i8 = (out[2], out[3])
        except Exception:
            # a failed in-place patch may have written part of the buffers:
            # drop them so _device_ready() reports false and the next _sync
            # rebuilds via _upload_full instead of serving a torn buffer
            self._dev = None
            self._dev_valid = None
            self._dev_i8 = None
            raise

    # -- cluster pruning ---------------------------------------------------
    def cluster(self, k: int = 0, iters: int = 10, seed: int = 0,
                sample: int = 0) -> int:
        """Fit k-means over the live rows on this corpus's device and build
        the IVF layout. Returns the cluster count; 0 when nothing was
        installed (too few rows, or the slot space moved under the fit).
        ``sample`` caps the Lloyd fit (ops.kmeans.kmeans_fit).

        The fit runs outside the lock; the install is optimistic: the row
        snapshot pins the layout epoch, and the fit installs only if it is
        unchanged (an overwrite of a snapshot row or a compaction would
        otherwise stamp a layout built from stale slots as current)."""
        self._device_gate()
        with self._sync_lock:
            live = [i for i, id_ in enumerate(self._ids) if id_ is not None]
            if len(live) < 2:
                return 0
            data = self._host[live]  # fancy indexing copies: stable snapshot
            epoch_at_read = self._layout_epoch
            # widen the overwrite guard to the snapshot rows so an in-place
            # update during the fit bumps the epoch and voids the install
            mask = np.zeros(self.capacity, bool)
            mask[live] = True
            if (self._layout_slots is not None
                    and self._layout_slots.size == self.capacity):
                mask |= self._layout_slots
            self._layout_slots = mask
        res = kmeans_fit(data, k=k, iters=iters, seed=seed, sample=sample,
                         device=self.device)
        centroids_dev = torch.from_numpy(res.centroids).to(self.device,
                                                           self.dtype)
        with self._sync_lock:
            if self._layout_epoch != epoch_at_read:
                return 0  # slot space moved mid-fit: caller may recluster
            assignments = np.full(self.capacity, -1, np.int32)
            assignments[live] = res.assignments
            self._centroids = centroids_dev
            self._assignments = assignments
        self._build_ivf_layout(np.asarray(live), res.assignments,
                               res.centroids, expect_epoch=epoch_at_read)
        return res.k

    def _build_ivf_layout(self, live_slots: np.ndarray,
                          live_assignments: np.ndarray,
                          centroids: np.ndarray,
                          expect_epoch: Optional[int] = None) -> None:
        """Cluster-contiguous block layout (ops/ivf.py). The build and its
        transfers run outside the lock; the layout installs only if the
        layout epoch is unchanged (the ``_layout_slots`` mask makes an
        overwrite of a covered row bump it, as in ``cluster()``)."""
        from nornicdb_tpu_torch.ops.ivf import build_ivf_layout  # imports us

        with self._sync_lock:
            if expect_epoch is not None and self._layout_epoch != expect_epoch:
                return  # slot space moved since the caller resolved slots
            epoch_at_read = self._layout_epoch
            rows = self._host[live_slots]  # fancy indexing copies: snapshot
            # slots the layout copies rows from: an in-place overwrite of
            # any of these bumps _layout_epoch (invalidates the layout)
            mask = np.zeros(self.capacity, bool)
            mask[live_slots] = True
            self._layout_slots = mask
        layout = build_ivf_layout(
            rows, live_slots, live_assignments, centroids,
            dtype=self.dtype, epoch=epoch_at_read, device=self.device,
        )
        with self._sync_lock:
            if self._layout_epoch != epoch_at_read:
                return  # mutated mid-build: discard the stale layout
            self._ivf = layout

    def clear_clusters(self) -> None:
        self._centroids = None
        self._assignments = None
        self._ivf = None
        self._layout_slots = None

    def set_clusters(
        self, centroids: np.ndarray, assignments_by_id: dict[str, int]
    ) -> None:
        """Install externally computed clusters (the search service's fit)
        without running k-means again. The id -> slot resolution sees one
        slot space under the lock; the transfer and the layout build run
        outside it, installed only if the layout epoch did not move."""
        self._device_gate()
        centroids_dev = torch.tensor(np.asarray(centroids, np.float32),
                                     dtype=self.dtype, device=self.device)
        with self._sync_lock:
            slot_assignments = np.full(self.capacity, -1, np.int32)
            for id_, c in assignments_by_id.items():
                slot = self._slot_of.get(id_)
                if slot is not None:
                    slot_assignments[slot] = c
            self._centroids = centroids_dev
            self._assignments = slot_assignments
            # the old layout describes the replaced clustering: drop it even
            # when no live row matches (else the epoch guard keeps serving it)
            self._ivf = None
            self._layout_slots = None
            live = np.nonzero((slot_assignments >= 0) & self._valid)[0]
            epoch_at_read = self._layout_epoch
        if live.size:
            self._build_ivf_layout(live, slot_assignments[live],
                                   np.asarray(centroids, np.float32),
                                   expect_epoch=epoch_at_read)

    def _grow(self, min_capacity: int = 0) -> None:
        super()._grow(min_capacity)
        # the slot space changed shape: drop the cluster state until the
        # next recluster
        self.clear_clusters()

    def clear(self) -> None:
        with self._sync_lock:
            super().clear()
            # the slot space was remapped: the assignments index dead rows
            self.clear_clusters()

    def _compact(self) -> None:
        super()._compact()
        # compaction remaps slots: old assignments index the wrong rows
        self.clear_clusters()

    def _pruned_search(
        self, q: np.ndarray, k: int, min_similarity: float, n_probe: int,
    ) -> Optional[list[list[tuple[str, float]]]]:
        """Score only the rows of the n_probe nearest clusters; None when
        no cluster index is fitted (the caller full-scans).

        Buffer, id map, cluster state and the layout-epoch check are
        captured under ONE lock hold, after the sync (and any pending
        compaction), so everything below resolves against that snapshot."""
        with self._sync_lock:
            self._sync()
            self._readers += 1
            corpus = self._dev
            ids, valid_host = self._ids, self._valid
            centroids, assignments = self._centroids, self._assignments
            layout = self._ivf
            layout_ok = (
                layout is not None and layout.epoch == self._layout_epoch
            )
        try:
            if corpus is None or centroids is None or assignments is None:
                return None
            # the layout serves while it matches the LAYOUT epoch: plain
            # adds and removes keep it (new rows are invisible to pruned
            # search until the next recluster; removed rows filter out
            # through the captured id map)
            if layout_ok:
                from nornicdb_tpu_torch.ops.ivf import ivf_search

                vals, slots = ivf_search(layout, q, k, n_probe)
                return format_topk_results(vals, slots, q.shape[0], k,
                                           min_similarity, ids)
            n_probe = min(n_probe, int(centroids.shape[0]))
            return self._pruned_scan(
                q, k, min_similarity, n_probe, corpus, ids, valid_host,
                centroids, assignments,
            )
        finally:
            with self._sync_lock:
                self._readers -= 1

    def _pruned_scan(
        self, q: np.ndarray, k: int, min_similarity: float, n_probe: int,
        corpus: torch.Tensor, ids: list[Optional[str]],
        valid_host: np.ndarray, centroids: torch.Tensor,
        assignments: np.ndarray,
    ) -> list[list[tuple[str, float]]]:
        """Assignment-mask pruning over the synced device corpus, one query
        at a time (the path while the layout is stale or not yet built).
        All host state comes in as the snapshot taken with the buffer."""
        out: list[list[tuple[str, float]]] = []
        for qi in range(q.shape[0]):
            qd = torch.from_numpy(q[qi]).to(self.device, self.dtype)
            probes = nearest_clusters(qd, centroids, n_probe).cpu().numpy()
            slots = np.nonzero(np.isin(assignments, probes) & valid_host)[0]
            if slots.size == 0:
                out.append([])
                continue
            scores = score_subset(
                l2_normalize(qd), corpus,
                torch.from_numpy(slots).to(self.device),
            ).to(torch.float32).cpu().numpy()
            row = []
            for j in np.argsort(-scores)[:k]:
                s = float(scores[j])
                if s < min_similarity:
                    continue
                id_ = ids[slots[j]]
                if id_ is not None:
                    row.append((id_, s))
            out.append(row)
        return out

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Unguarded access to the resident buffers. Callers may hold the
        returned tensors indefinitely, so in-place patching is disabled for
        this corpus from now on. Prefer _borrow_device."""
        self._device_gate()
        with self._sync_lock:
            self._donation_ok = False
            self._sync()
            return self._dev, self._dev_valid

    def search(
        self,
        queries: np.ndarray,
        k: int,
        min_similarity: float = -1.0,
        exact: bool = False,
        n_probe: int = 0,
        streaming: Optional[bool] = None,
    ) -> list[list[tuple[str, float]]]:
        """Cosine top-k. Returns per-query [(id, score)] filtered by
        min_similarity. On the card at scale the candidates come from the
        streaming kernel (packed-bin recall contract, ~0.975 at k=100);
        exact=True gives recall 1.0 with lowest-index ties. With n_probe > 0
        and a fitted cluster index only the n_probe nearest clusters are
        scored (IVF pruning), in one pass for the batch."""
        q = np.array(queries, np.float32, ndmin=2)
        if len(self._slot_of) == 0:
            return [[] for _ in range(q.shape[0])]
        self._device_gate()
        if n_probe > 0:
            pruned = self._pruned_search(q, k, min_similarity, n_probe)
            if pruned is not None:
                self.sync_stats.device_dispatches += 1
                return pruned
        with self._borrow_device() as (corpus, valid, dev_i8, ids, _):
            kk = min(k, self.capacity)
            qt = l2_normalize(torch.from_numpy(q).to(self.device, self.dtype))
            vals, idx = topk_backend(
                qt, corpus, valid, kk, exact=exact, streaming=streaming,
                quantized=dev_i8 if self.quantize else None,
            )
            # materialize INSIDE the borrow: the computation must finish
            # before the patcher may write into the buffer it reads
            vals_np = vals.to(torch.float32).cpu().numpy()
            idx_np = idx.cpu().numpy()
        self.sync_stats.device_dispatches += 1
        return self._format_results(
            vals_np, idx_np, q.shape[0], k, min_similarity, ids=ids,
        )

    def score_subset(
        self, query: np.ndarray, ids: list[str]
    ) -> list[tuple[str, float]]:
        """Re-score of the given ids (bf16 product, as the JAX package);
        unknown/removed ids are omitted."""
        self._device_gate()
        with self._borrow_device() as (corpus, _, _i8, _ids, slot_of):
            present = [(i, slot_of[i]) for i in ids if i in slot_of]
            if not present:
                return []
            q = l2_normalize(
                torch.as_tensor(np.asarray(query, np.float32).reshape(-1),
                                device=self.device).to(self.dtype)
            )
            slots = torch.as_tensor([s for _, s in present],
                                    device=self.device)
            scores = score_subset(q, corpus, slots).to(torch.float32).cpu()
        return [(id_, float(s)) for (id_, _), s in zip(present, scores)]
