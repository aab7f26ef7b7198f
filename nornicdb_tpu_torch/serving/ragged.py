"""Ragged token packing for the continuous batching engine: a verbatim copy
of ``nornicdb_tpu/serving/ragged.py`` (pure numpy), kept here so the port
imports nothing of the JAX package.

Replaces pad-to-bucket embedding batches (``DeviceEmbedder.embed_batch``:
every text padded to a power-of-two length bucket, batches padded to batch
classes) with token-concatenated packed grids: variable-length token
sequences share rows of an (R, C) buffer, delimited by segment ids, and
one segment-masked forward (``models/bge_m3.forward_packed``) embeds them
all; compute scales with real tokens, not padded shapes.

Packs are quantized to a small static shape-class grid: capacity C from
CAPACITY_CLASSES, row count R from ROW_CLASSES chosen from the queued work
(packing fills rows, so R padding never ships empty rows), CLS-gather width
a power of two. In steady state a workload touches a handful of classes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

# row capacities (token columns). The smallest class keeps attention
# width — the packed path's only FLOP overhead vs per-request — tight for
# short-text traffic; the largest is clamped to the embedder's max_len.
CAPACITY_CLASSES = (32, 64, 128, 256, 512)
# packed rows per dispatch: quantized to ROW_CLASSES up to this
# (engine-configurable)
MAX_ROWS = 16
# row-count classes: powers of two plus 1.5x intermediates — remainders
# after a big pack land in a near-fitting class instead of cascading
# through tiny power-of-two tails (compile count stays bounded)
ROW_CLASSES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _rows_at_most(n: int) -> int:
    best = 1
    for r in ROW_CLASSES:
        if r <= n:
            best = r
    return best


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _rows_at_least(n: int) -> int:
    for r in ROW_CLASSES:
        if r >= n:
            return r
    return ROW_CLASSES[-1]


@dataclass
class PackedBatch:
    """One device dispatch worth of token-packed texts.

    Arrays are the forward_packed operands; ``order`` maps segment slot s
    (0-based, segment id s+1) back to the caller's sequence index.
    """

    ids: np.ndarray        # (R, C) int32, pad_id-filled
    seg: np.ndarray        # (R, C) int32, 0 = padding, 1..S = segments
    positions: np.ndarray  # (R, C) int32, XLM-R per-segment positions
    cls_rows: np.ndarray   # (S_cap,) int32 — segment-start rows
    cls_cols: np.ndarray   # (S_cap,) int32 — segment-start cols
    order: list[int] = field(default_factory=list)  # segment -> input index
    tokens: int = 0        # real tokens packed

    @property
    def n_segments(self) -> int:
        return len(self.order)

    @property
    def shape_class(self) -> tuple[int, int, int]:
        return (*self.ids.shape, len(self.cls_rows))

    @property
    def efficiency(self) -> float:
        r, c = self.ids.shape
        return self.tokens / float(r * c) if r * c else 0.0


class RaggedPacker:
    """Greedy first-fit-decreasing packer over static shape classes."""

    def __init__(
        self,
        pad_id: int,
        pad_token_id: int,
        max_len: int = 512,
        max_rows: int = MAX_ROWS,
        max_cells: int = 4096,
    ):
        self.pad_id = pad_id
        # position offset (XLM-R: positions start at pad_token_id + 1)
        self.pad_token_id = pad_token_id
        self.max_len = max_len
        self.max_rows = max(1, _rows_at_most(max_rows))
        # grid-area bound: attention memory/time scales R*C^2, so wide
        # capacities get proportionally fewer rows (a (64,128) grid runs
        # ~2x slower per cell than (32,128) on CPU XLA)
        self.max_cells = max(CAPACITY_CLASSES[0], max_cells)
        # classes <= max_len, PLUS max_len itself when the grid doesn't
        # reach it (trained/student checkpoints use max_len values like
        # max_positions - 8): without the final class, capacity_for()
        # would silently truncate 257..max_len-token texts that the
        # per-request path embeds in full — breaking equivalence
        caps = [c for c in CAPACITY_CLASSES if c <= max_len]
        if not caps or caps[-1] < max_len:
            caps.append(max_len)
        self.capacities = tuple(caps)

    def capacity_for(self, longest: int) -> int:
        for c in self.capacities:
            if longest <= c:
                return c
        return self.capacities[-1]

    def plan(
        self,
        lengths: Sequence[int],
        budget_tokens: int = 0,
        capacity: int = 0,
    ) -> tuple[int, int, int]:
        """(n_seqs_to_take, R, C) for the next pack over a FIFO prefix.

        Capacity defaults to the smallest class covering the prefix's
        longest sequence (callers may pin a wider one so rows tile
        several texts); rows quantize DOWN to a row class so packing
        fills them (leftover sequences wait for the next pack — two
        tight dispatches beat one half-empty grid)."""
        if not lengths:
            return 0, 1, capacity or self.capacities[0]
        c = capacity or self.capacity_for(max(lengths))
        # one-pass FIFO first-fit with a hard row cap: O(n * rows), no
        # re-simulation (an earlier trim-loop variant re-ran first-fit
        # per dropped item and dominated the schedule at depth)
        row_cap = min(self.max_rows, max(1, self.max_cells // c))
        free: list[int] = []
        take = 0
        total = 0
        for n in lengths:
            n = min(n, c)
            for i, f in enumerate(free):
                if f >= n:
                    free[i] -= n
                    break
            else:
                if len(free) >= row_cap:
                    break  # grid full: the rest is the next pack's work
                free.append(c - n)
            take += 1
            total += n
            if budget_tokens > 0 and total >= budget_tokens:
                break
        r = _rows_at_least(len(free))
        return take, r, c

    @staticmethod
    def _rows_needed(lengths: Sequence[int], capacity: int) -> int:
        """First-fit-decreasing row count for the given capacity."""
        free: list[int] = []
        for n in sorted(lengths, reverse=True):
            n = min(n, capacity)
            for i, f in enumerate(free):
                if f >= n:
                    free[i] -= n
                    break
            else:
                free.append(capacity - n)
        return len(free)

    def pack(
        self,
        seqs: Sequence[Sequence[int]],
        rows: int = 0,
        capacity: int = 0,
    ) -> PackedBatch:
        """Pack token sequences into one (R, C) grid.

        Sequences longer than the capacity class are truncated to it
        (callers tokenize with max_len <= the largest class, so this only
        guards foreign input).  Raises ValueError if the planned grid
        can't hold every sequence — plan() prevents that for its own
        prefixes."""
        if not seqs:
            raise ValueError("pack() needs at least one sequence")
        lengths = [len(s) for s in seqs]
        if not capacity:
            # smallest class covering the longest sequence; escalate when
            # the row cap binds (direct callers may pack more than one
            # planned prefix — the engine's plan() never hits this)
            capacity = self.capacity_for(max(lengths))
            while (
                self._rows_needed(lengths, capacity) > self.max_rows
                and capacity < self.capacities[-1]
            ):
                capacity = self.capacities[
                    self.capacities.index(capacity) + 1
                ]
        order = sorted(
            range(len(seqs)), key=lambda i: len(seqs[i]), reverse=True
        )
        r = rows or _rows_at_least(self._rows_needed(lengths, capacity))
        ids = np.full((r, capacity), self.pad_id, np.int32)
        seg = np.zeros((r, capacity), np.int32)
        positions = np.full((r, capacity), self.pad_token_id, np.int32)
        fill = [0] * r  # next free column per row
        cls_rows: list[int] = [0] * len(seqs)
        cls_cols: list[int] = [0] * len(seqs)
        seg_order: list[int] = []
        tokens = 0
        for seg_slot, idx in enumerate(order):
            s = list(seqs[idx])[:capacity]
            n = len(s)
            for row in range(r):
                if capacity - fill[row] >= n:
                    col = fill[row]
                    ids[row, col : col + n] = s
                    seg[row, col : col + n] = seg_slot + 1
                    positions[row, col : col + n] = (
                        np.arange(1, n + 1, dtype=np.int32)
                        + self.pad_token_id
                    )
                    cls_rows[seg_slot] = row
                    cls_cols[seg_slot] = col
                    fill[row] = col + n
                    tokens += n
                    break
            else:
                raise ValueError(
                    f"pack overflow: seq of {n} tokens does not fit "
                    f"{r}x{capacity} grid"
                )
            seg_order.append(idx)
        # CLS-gather width: power of two with a floor of 8 — merging the
        # tiny classes (1/2/4 segments) into one keeps the jit program
        # count down at a gather cost of a few unused rows (NL-JAX03)
        s_cap = max(8, _pow2_at_least(len(seqs)))
        pad = s_cap - len(seqs)
        return PackedBatch(
            ids=ids,
            seg=seg,
            positions=positions,
            cls_rows=np.asarray(cls_rows + [0] * pad, np.int32),
            cls_cols=np.asarray(cls_cols + [0] * pad, np.int32),
            order=seg_order,
            tokens=tokens,
        )


def unpack_results(
    packed: PackedBatch, embeddings: np.ndarray, n_inputs: Optional[int] = None
) -> list[np.ndarray]:
    """Scatter (S_cap, D) forward_packed output back to input order."""
    out: list[Optional[np.ndarray]] = [None] * (
        n_inputs if n_inputs is not None else len(packed.order)
    )
    for seg_slot, idx in enumerate(packed.order):
        out[idx] = np.asarray(embeddings[seg_slot], np.float32)
    return out  # type: ignore[return-value]
