"""Pure-NumPy search helpers: a verbatim copy of
``nornicdb_tpu/ops/host_search.py`` (the port imports nothing of the JAX
package, so it keeps its own copy of these numpy-only routines).

Pure-NumPy search fallbacks for DEGRADED_CPU serving.

When the BackendManager (nornicdb_tpu.backend) reports the accelerator
lost, the corpora in ops/similarity.py answer from their host arrays
through these routines instead of blocking on a device that may never
come back — the reference's device-failure CPU retry
(pkg/embed/local_gguf.go:202-294) and WindVE's host-side takeover
(PAPERS.md) as one module.

Contract parity with the device path: inputs are L2-normalized rows, so
cosine == dot; scores are EXACT and candidate membership is exact too
(a full argpartition — CPU fallback trades throughput, never recall).
Results are (values, indices) in the same shape/ordering contract as
``ops.similarity.topk_backend`` so ``HostCorpus._format_results``
resolves them identically.
"""

from __future__ import annotations

import numpy as np


def host_topk(
    queries: np.ndarray,
    corpus: np.ndarray,
    valid: np.ndarray,
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(Q, D) x (N, D) -> exact top-k (values (Q, k), indices (Q, k)).

    ``valid`` masks padding/tombstone rows to -inf, mirroring the device
    kernels; k is clamped to the corpus size."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    n = corpus.shape[0]
    k = max(1, min(k, n))
    scores = q @ corpus.T  # (Q, N); rows are normalized -> cosine
    scores = np.where(valid[None, :], scores, -np.inf)
    # NaN scores (NaN query components survive normalization's
    # divide-by-norm) break the boundary-widening selection below: every
    # `s >= kth` comparison is False, so fewer than k candidates survive
    # and the fixed-shape write raises.  Map them to -inf — callers
    # already drop non-finite values (_format_results), so a NaN query
    # degrades to "matches nothing" instead of a 500.
    np.copyto(scores, -np.inf, where=np.isnan(scores))
    # ties must keep ascending row order, matching lax.top_k's tie rule
    # on the device path (so degraded serving returns the SAME ids as the
    # device would, not an argpartition-arbitrary tied subset).  A full
    # stable argsort over N rows per query is O(N log N) — too slow for
    # the 10M-row degraded scenario, and it runs under _sync_lock.
    # Instead: O(N) argpartition to the kth score, widen to ALL rows tied
    # at that boundary, and stable-sort only that subset.
    out_v = np.empty((q.shape[0], k), np.float32)
    out_i = np.empty((q.shape[0], k), np.int64)
    for qi in range(q.shape[0]):
        s = scores[qi]
        if k < n:
            kth = s[np.argpartition(-s, k - 1)[k - 1]]
            if kth == -np.inf:
                # fewer than k finite scores: `s >= -inf` holds for EVERY
                # row (-inf >= -inf is True), and the boundary widening
                # would stable-sort the whole corpus — O(N log N) under
                # _sync_lock at a 10M-row capacity with a handful of live
                # rows. Only the finite rows can surface (callers drop
                # non-finite scores); sort those and pad below.
                cand = np.nonzero(np.isfinite(s))[0]
            else:
                cand = np.nonzero(s >= kth)[0]  # ascending row order
        else:
            cand = np.arange(n)
        order = np.argsort(-s[cand], kind="stable")[:k]
        sel = cand[order]
        if sel.size < k:
            # fixed-shape pad with the lowest-index unselected rows; their
            # scores are -inf, which _format_results filters out
            mask = np.ones(n, bool)
            mask[sel] = False
            pad = np.nonzero(mask)[0][: k - sel.size]
            sel = np.concatenate([sel, pad])
        out_i[qi] = sel
        out_v[qi] = s[sel]
    return out_v, out_i


def format_topk_results(
    vals: np.ndarray,
    idx: np.ndarray,
    n_queries: int,
    k: int,
    min_similarity: float,
    ids: list,
) -> list[list[tuple[str, float]]]:
    """Resolve top-k slot indices to (id, score) rows — the one shared
    epilogue for the device path, the DEGRADED_CPU host path, and the
    cross-process shared-memory read plane (server/readplane.py), so every
    serving surface resolves results identically by construction.

    ``ids`` must be the slot map captured with the buffer the indices came
    from — resolving against a live map would misattribute results if a
    background compaction remapped the slot space mid-search."""
    out: list[list[tuple[str, float]]] = []
    for qi in range(n_queries):
        row: list[tuple[str, float]] = []
        for v, i in zip(vals[qi], idx[qi]):
            # i < 0 is the merge_topk/IVF sentinel for "no candidate"
            # (padding rows of a near-empty shard / short cluster);
            # a negative index must never reach ids[i] — Python's
            # negative indexing would attribute the LAST id to it
            if i < 0 or not np.isfinite(v) or v < min_similarity:
                continue
            id_ = ids[i] if i < len(ids) else None
            if id_ is not None:
                row.append((id_, float(v)))
        out.append(row[:k])
    return out


def rescore_rows(rows: np.ndarray, qn: np.ndarray) -> np.ndarray:
    """Deterministic exact f32 dot of each row with a NORMALIZED query.

    This — not a BLAS call — is the canonical f32 rescore: BLAS GEMM/GEMV
    kernels change their summation order with the call's shape (measured:
    the same (row, query) dot differs in the last ulp between M=5 and
    M=512 gemv at D>=64), so two differently-shaped calls cannot
    bit-agree. NumPy's pairwise ``sum`` over a fixed D is shape-
    independent, so every consumer of this function — the int8-residency
    rescore epilogue, score_subset's host twin, the bench's rescore
    invariant — produces bit-identical scores for the same (row, query)
    regardless of candidate-set size."""
    return (np.asarray(rows, np.float32) * qn).sum(
        axis=1, dtype=np.float32
    ).astype(np.float32)


def host_score_rows(
    query: np.ndarray, corpus: np.ndarray, rows: np.ndarray
) -> np.ndarray:
    """Exact re-score of candidate rows (host twin of
    ops.similarity.score_subset); query is normalized first. Scores come
    from the deterministic ``rescore_rows`` kernel, so they bit-match the
    int8-residency rescore path for the same rows."""
    q = np.asarray(query, np.float32).reshape(-1)
    n = float(np.linalg.norm(q))
    if n > 1e-12:
        q = q / n
    return rescore_rows(corpus[rows], q)


def quantize_rows_np(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization on the host: the one definition
    of the int8 mirror contract, shared by the compressed-residency upload
    path (parallel.ShardedCorpus), the shared-memory read plane's
    ``rows_i8``/``scales_i8`` export, and anything else that must agree
    bit-for-bit with the device kernels' quantization.

    Matches ops.pallas_kernels.quantize_rows exactly in the codes
    (np.round and jnp.round are both round-half-to-even) and to within a
    float ulp in the scales: x ~= int8 / scale."""
    r = np.asarray(rows, np.float32)
    scale = (127.0 / np.maximum(np.max(np.abs(r), axis=1), 1e-9)).astype(
        np.float32
    )
    codes = np.round(r * scale[:, None]).astype(np.int8)
    return codes, scale
