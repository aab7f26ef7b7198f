#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nornicdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Builds the port's CUDA kernels from ``nornicdb_tpu_torch/ops/csrc`` (one
``nvcc`` per source, in parallel), then at the headline serving size
(1,000,000 x 1024 vectors, bge-m3's width; top-100):

1. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (Q = 1024 and Q = 16, N = 1,000,064 rows), and
   times kernel, plain version and a one-call library yardstick (for the
   int8 kernel also ``torch._int_mm``, the s8 product alone, logged); then
   the int8 kernel over 10,000,000 x 1024 codes made on the card (bins
   bit-identical to the plain version at Q = 16, a call timed at Q = 16
   and 1024: a kernel time at BASELINE.json's scale, not a latency);
2. drives the serving path: ``SearchService`` with batching, a bulk load,
   concurrent ``vector_candidates`` calls with writes interleaved, recall@100
   against exact float32 ground truth, removed ids never served, the
   streaming kernel's launch count and the fused-dispatch count;
3. the same over an int8-mirrored ``DeviceCorpus(quantize=True)``;
4. the extract-kernel epilogue, identical to the sort epilogue;
5. generation serving at full width: Qwen2.5-0.5B (``QWEN25_05B``, bf16,
   weights from ``--seed``) behind ``GenerationEngine`` with the default
   ``GenServeConfig``. The ragged paged attention kernel is held against
   its plain version on the inputs of a real fused step (decode block
   L = 10, Tq = 1 and chunk block L = 1, Tq = 64) and timed; then 32
   requests of the qc/chat/rag mix of ``scripts/bench_generate.py`` from 8
   client threads: every request completes, the prefix cache hits, the
   kernel ran 24 x (steps + chunk steps) times, and every greedy token is
   the dense plain reference's (``prefill`` + ``decode_step``) or within
   GEN_MARGIN_TOL of it in the reference's logits. 5d: the engine's
   ``mode="dense"`` (a dense KV cache a sequence, torch ops, each
   sequence's decode step replayed from a captured CUDA graph) on 8 of the
   requests from 8 clients: no ragged launch, every token passing the
   dense reference at the cache width the engine chose, tok/s, ttft,
   per-token p50 and the longest request logged beside the paged run's. 5e: Heimdall's synchronous
   ``QwenGenerator`` over the same weights on 4 text prompts: ``generate``
   equal to ``qwen2.generate``'s tokens, which pass the dense reference,
   ``generate_stream``'s deltas joining to the same text, sampling at
   T = 0.8 repeating for a seed and changing for another;
6. the fused cosine kernel through ``ops.fused_cosine_topk`` at Q = 1024
   and Q = 16 on the 1,000,064 x 1024 float32 corpus buffer (tile_n 128,
   k = 100): held against its plain version (max |d| <= COSINE_TOL, top-100
   ids equal but for swaps within it) and timed beside its bound and the
   float32 ``torch.matmul`` yardstick;
7. IVF serving at full width: a ``SearchService`` over the same vectors,
   batcher on, ``SearchConfig`` defaults. ``recluster()`` fits k-means
   (K = 707, 10 iterations, a 262,144-row sample), builds the layout and
   tunes ``n_probe`` against recall@100 >= 0.95; then 32 threads x 8
   queries through ``vector_candidates`` with the tuned plan: recall@100
   against exact float32 ground truth, client p50/p99 and qps beside phase
   2's full scan, fused dispatches, peak device memory, peak host RSS;
8. embed serving at full width: bge-m3 (``BGE_M3``, 24 layers, hidden 1024,
   bf16, weights from ``--seed``, ``HashTokenizer``) in a
   ``DeviceEmbedder`` behind ``ServingEngine`` with the default
   ``ServingConfig``. 65,536 texts of ``scripts/bench_embed.py``'s
   graph-node mix from 16 clients, 64 a call, after one untimed pack of
   each capacity class the mix reaches: embeddings/s, tokens/s, client
   p50/p99, pack p50, packs, pack efficiency, zero sheds, peak memory.
   Every embedding finite with norm 1; 256 of them, stratified over the
   kinds, within cosine 0.99 of the padded per-request path; a probe
   alone and inside a full pack likewise; the gap to float32 weights
   logged. Then a ``SearchService`` over the 65,536 embeddings serves 256
   stored texts embedded again, from 32 clients: recall@100 >= 0.95
   against an exact float32 scan, each text's own id in its top-100
   within 0.02 of the best, the bf16 streaming kernel launched (its count
   on a log line of its own; the ``kernels`` line keeps its five
   entries), fused dispatches. The embed engine stays up for phases 10
   and 9.

10. hybrid search, run after phase 8 and before phase 9: a port
   ``MemoryEngine`` holds phase 8's 65,536 texts as nodes (``content`` and
   the phase-8 embedding) with 2-4 seeded edges a node; a
   ``SearchService(storage, embedder=CachedEmbedder(<phase 8's engine>))``
   (the ``cli serve`` stack) with write-behind and batching on is attached
   and indexed by ``build_indexes``. 32 clients
   x 8 ``search(query, limit=10)`` calls (40 candidates a leg; half stored
   texts, half their last two words) while 4 writers make 256 create /
   update / delete calls through the storage. Checks: each ranking equals
   ``fuse_rrf`` of its BM25 and vector legs; the vector leg's recall@40
   >= 0.95 against an exact float32 scan on the card; every stored text
   finds its node in the top 10 (>= 0.99 asserted); every acknowledged write
   is read back (an update through a cached ranking made before it) and a
   deleted node is never served; 64 repeats are cache hits with 0 launches
   of #2, one text update makes them miss, a recall's touches change
   neither the generation nor the corpus; 32 two-word searches reranked by
   a ``BGE_M3``-width cross-encoder (bf16) whose scores are within
   RERANK_TOL of the same forward in float32 and order the head; 32 with
   MMR equal to the host ``apply_mmr``. Logged: client p50/p99 and qps, the share of a
   search in embed, vector leg, BM25, fusion and enrich (spans taken in
   this script), the rerank forward, the uploader's runs and the query
   stall, #2's launches (a log line of their own), peak device memory.
9. a checkpoint and GraphRAG answers: a ``QWEN25_05B`` checkpoint directory
   (weights from ``--seed``, a ``VocabTokenizer`` over phase 8's texts and
   the prompt header) written to a temporary directory and mounted with
   ``load_generator``, every tensor bit for bit; an ``EngineGenerator``
   over a ``GenerationEngine`` on it (sequences of 1,024 tokens); then
   ``GraphRAGService`` answers 32 stored phase-8 texts from 8 clients over
   phase 10's storage and hybrid service: ``recall`` is ``DB.recall`` (a
   hybrid ``search``, then a touch of each hit's access count through
   ``storage.update_node``, which leaves the index as it was). Every answer
   is paged, retrieves its own node and generates 1-64 tokens; answers
   after the first wave reuse the cached header pages; #2 and #5 both
   launch (their counts on a log line of their own); 4 answers' tokens
   pass the dense reference.

The data is a Gaussian mixture made with numpy from ``--seed``: 10,000
centres with 100 rows each (shuffled), so each query's true top-100 is
separable from the rest. Queries are noisy copies of rows.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it is the ``kernels`` JSON (times, bounds, launches). Every ``ms`` there is
the time of a call from Python between CUDA events (``cuda_ms``). The
extract kernel, the ragged attention kernel and their yardsticks take
microseconds, so the host's launch work can set that time: their entries
also carry the device time of a call from CUDA-graph replays (``graph_ms``)
as ``device_ms`` and ``library_device_ms``. Phases 1 and 6 also print the
int8 and bf16 streaming, extract and fused cosine kernels' ptxas registers,
shared memory and spills, and phases 1, 5 and 6 each redesigned kernel's share of
its bound, its launch plan and its first version's time copied from
PERF.md (not measured here); phase 1 times the sort epilogue
(``topk_lowest_index``) over the same bins; ``--profile`` writes
``chiprun_out/profile_embed.txt`` for phase 8. Any failed check raises and
the script exits non-zero without that line. Without CUDA it exits 2.
Matmul precision is pinned to full float32 (no TF32) for every reference,
and bf16 GEMMs to float32 reductions.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import threading
import time

import numpy as np

H100_BF16_OPS = 989e12   # dense tensor-core bf16, per second
H100_INT8_OPS = 1979e12  # dense tensor-core int8
H100_FP32_OPS = 67e12    # outside the tensor cores
H100_BYTES = 3.35e12     # HBM3 bytes per second

# the main path's size: bench.py's headline search (1M x 1024, top-100)
N, DIMS, K_TOP = 1_000_000, 1024, 100
# kernel #3's timing at BASELINE.json's "p50 top-100 @10M vectors" scale
N_10M = 10_000_000
REPS = 6  # timed calls of each kernel (a third of that for the slow ones)

# phase 5: the generation mix of scripts/bench_generate.py (kind,
# prompt_len, max_new, weight, shared_prefix_len), 32 requests, 8 clients
GEN_MIX = (
    ("qc", 12, 16, 0.25, 0),
    ("chat", 24, 32, 0.30, 16),
    ("rag", 80, 48, 0.45, 48),
)
GEN_REQUESTS, GEN_CLIENTS = 32, 8
# every greedy token of the engine must have a dense-reference logit within
# this of the reference's largest. The engine (ragged kernel, fused F-row
# GEMMs) and the reference (plain attention, 1-row GEMMs) round bf16 at the
# same points but sum in other orders; phase 5a asserts over GEN_PROBES
# prompt sets that a real fused step's logits lie within GEN_MARGIN_TOL / 2
# of the dense path's (0.0261-0.0286 for seeds 0-3 on an H100 80GB HBM3),
# so only a token within GEN_MARGIN_TOL of the best can be chosen in its
# place
GEN_MARGIN_TOL = 0.06
GEN_PROBES = 4
# phase 5d: the engine's dense mode serves the first 8 of phase 5's requests
# from 8 clients; phase 5e: QwenGenerator on 4 text prompts (words of
# EMBED_WORDS) of these lengths, SYNC_NEW tokens each, sampling at
# SYNC_TEMPERATURE
DENSE_REQUESTS = 8
SYNC_PROMPT_WORDS, SYNC_NEW, SYNC_TEMPERATURE = (8, 24, 40, 64), 32, 0.8
# phase 8: scripts/bench_embed.py's graph-node text mix (kind, weight,
# min_words, max_words) over its 38-word list; each text ends with one
# unique word. 65,536 texts from 16 closed-loop clients, 64 a call
EMBED_MIX = (
    ("title", 0.85, 2, 5),
    ("description", 0.12, 10, 18),
    ("paragraph", 0.03, 40, 60),
)
EMBED_WORDS = (
    "graph node edge vector search index memory storage engine query "
    "batch token device shard corpus embed serve latency throughput "
    "append commit probe replica quorum trace metric histogram cache "
    "segment packed ragged schedule deadline admission queue stream"
).split()
EMBED_TEXTS, EMBED_CLIENTS, EMBED_CALL = 65_536, 16, 64
# packed against per-request bf16 embeddings: the JAX package's own bound
# (tests/test_serving.py, bf16 config)
EMBED_COS = 0.99
# 256 stored texts, stratified over the kinds, checked against the padded
# path; 256 more embedded again as search queries
EMBED_CHECK, EMBED_QUERIES = 256, 256
# a query's own text must score within this of its best hit: the same text
# in two packs differs by bf16 rounding only
OWN_SCORE_TOL = 0.02
# phase 9: GraphRAG answers to 32 stored phase-8 texts from 8 clients over a
# checkpoint written and loaded by the run; each node has 2-4 outgoing
# edges. GraphRAG budgets its prompt in whitespace words (max_seq_tokens -
# 72) and the tokenizer splits punctuation, so a packed prompt (the 92-word
# header in 109 tokens, 5 hits of up to 200 characters, up to 8 edges a hit
# at 7 tokens each) outgrows its budget: ~250-300 tokens where the default
# sequence holds 256, up to ~660 in all. The engine keeps a prompt's tail,
# so the shared header would be cut away. Sequences of 1,024 tokens hold
# every such prompt whole; the pool holds 8 of them
RAG_QUESTIONS, RAG_CLIENTS = 32, 8
RAG_EDGES = (2, 4)
RAG_SEQ_TOKENS = 1024
RAG_CHECKED = 4  # answers whose tokens are held against the dense path
# phase 10: hybrid search over phase 8's texts in a MemoryEngine: 32
# clients x 8 searches of limit 10 (40 candidates a leg), half stored texts,
# half their last two words, while 4 writers make 256 create / update /
# delete calls; 64 repeats for the rank cache; 32 two-word searches
# reranked by a BGE_M3-width cross-encoder (20 candidates) and 32 with MMR
HYBRID_CLIENTS, HYBRID_PER_CLIENT, HYBRID_LIMIT = 32, 8, 10
HYBRID_WRITERS, HYBRID_WRITES = 4, 256
HYBRID_REPEATS, HYBRID_RERANK, HYBRID_MMR = 64, 32, 32
# a phase-10 client retries a shed embed (ResourceExhausted) with backoff:
# 32 clients' BM25 holds the interpreter lock, so the embed engine's
# dispatcher can miss ServingConfig's 2 s deadline under this load
BACKOFF_TRIES = 8
# cross-encoder scores with bf16 weights against the same forward with the
# weights in float32, both on the card: the bound of the port's bf16 bge-m3
# against the JAX one (tests/test_torch_bge_m3.py); the head's weights are
# normal * 0.02 over unit embeddings, so a score moves by at most
# 0.02 * sqrt(1024) * |d embedding|. Phase 10 logs the gap it measured.
RERANK_TOL = 0.0035
# fused cosine kernel vs plain version: both float32 (no TF32); the kernel
# scales the dot product by the row's inverse norm where the plain version
# scales the row first, and sums in another order
COSINE_TOL = 1e-5
# ragged kernel vs plain version: float32 1e-5, bfloat16 2**-7 relative and
# absolute (probabilities are rounded to bf16 before P.V, so a one-ulp
# float32 difference moves one probability by a bf16 ulp)
ATTN_TOL_BF16 = 2.0 ** -7
# the first versions of the four redesigned kernels: the time of a call at
# Q = 1024 / 16 (#5: at the decode / chunk block) on an H100 80GB HBM3 at
# 700 W, copied from the "First version ms" column of PERF.md's kernel
# table for the log lines only (not measured by this run, so not in the
# kernels JSON)
FIRST_VERSION_MS = {"extract_topk": {1024: 0.2008, 16: 0.0588},
                    "fused_cosine_scores": {1024: 64.14, 16: 3.181},
                    "streaming_topk_bf16": {1024: 16.358, 16: 3.039},
                    "streaming_topk_int8": {1024: 7.271, 16: 1.342},
                    "ragged_paged_attention": {"decode": 0.03270,
                                               "chunk": 0.03495}}


def log(*a) -> None:
    print(*a, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, calls: int, runs: int = 5) -> float:
    """The median over ``runs`` of ``cuda_ms(fn, calls)``. A call of tens of
    microseconds is set by host work, and one hiccup of the host can move
    the mean of a short run by half."""
    return float(np.median([cuda_ms(fn, calls) for _ in range(runs)]))


def graph_ms(fn, calls: int, replays: int = 6) -> float:
    """Mean device time of one call of ``fn`` in ms: ``calls`` calls
    captured in a CUDA graph, replayed ``replays`` times between CUDA
    events. For a kernel of a few microseconds, back-to-back calls from
    Python (``cuda_ms``) time the host's launch work, not the device."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_us(fn, calls: int = 3000) -> float:
    """Mean host time of one call of ``fn`` in microseconds."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def launch_host_costs(K, device) -> dict:
    """Host microseconds of what ``kernels._launch`` does before each
    launch, beside the public calls it avoids (a kernel of a few
    microseconds waits for them)."""
    import torch

    def switch():
        with torch.cuda.device(device):
            pass

    return {
        "raw_stream": host_us(lambda: K._current_stream(device)),
        "current_stream": host_us(lambda: torch.cuda.current_stream(device).cuda_stream),
        "device_check": host_us(lambda: device.index == torch.cuda.current_device()),
        "device_switch": host_us(switch),
    }


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` report: its registers,
    shared memory and spill bytes."""
    if not report:
        return ["no report: the library was built before this run"]
    out, fn, spill = [], "", ""
    for line in report.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line
        elif line.startswith("ptxas info") and "Used" in line and fn:
            out.append(f"{fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn = ""
    return out


def make_data(rng, n: int, d: int, per: int = 100) -> np.ndarray:
    """(n, d) float32 unit rows: n // per centres, `per` noisy rows each,
    shuffled. Row noise has norm 0.5, so rows of one centre score ~0.8
    with each other and ~0 with the rest."""
    centres = rng.standard_normal((n // per, d), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    assign = rng.permutation(np.repeat(np.arange(n // per), per))
    out = np.empty((n, d), np.float32)
    step = 1 << 16
    for i in range(0, n, step):
        j = min(i + step, n)
        chunk = centres[assign[i:j]]
        chunk += rng.standard_normal((j - i, d), dtype=np.float32) * np.float32(
            0.5 / np.sqrt(d))
        chunk /= np.linalg.norm(chunk, axis=1, keepdims=True)
        out[i:j] = chunk
    return out


def make_queries(rng, data: np.ndarray, rows: np.ndarray) -> np.ndarray:
    q = data[rows] + rng.standard_normal(
        (rows.size, data.shape[1]), dtype=np.float32) * np.float32(
        0.1 / np.sqrt(data.shape[1]))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def ground_truth(qs: np.ndarray, dev, valid, k: int) -> list[set]:
    """Exact float32 top-k row sets over the resident corpus."""
    import torch

    qt = torch.from_numpy(qs).to(dev.device)
    scores = qt @ dev.T
    scores = torch.where(valid[None, :], scores, float("-inf"))
    idx = torch.topk(scores, k, dim=1).indices.cpu().numpy()
    return [set(r.tolist()) for r in idx]


def recall(results, gt_ids) -> float:
    return float(np.mean([
        len({i for i, _ in res} & gt) / len(gt) for res, gt in zip(results, gt_ids)
    ]))


def phase_kernels(K, R, dev, valid, c_i8, c_scale, qs_all, k, reps):
    """Each kernel against its plain version at the serving shapes; times."""
    import torch

    from nornicdb_tpu_torch.ops import _build

    n, d = dev.shape
    tile = K.pick_tile_n(n)
    rows = min(K.streaming_rows_for(k, tile), n // tile)
    n_tiles, rows, tile_bits = K.streaming_geometry(n, tile, rows)
    b = rows * tile
    kpad = -(-k // K.LANE) * K.LANE
    log(f"[kernels] N={n} D={d} tile_n={tile} rows={rows} tile_bits={tile_bits} "
        f"bins={b} k={k}")
    for name in ("streaming_topk", "streaming_topk_bf16", "extract_topk"):
        for line in ptxas_summary(_build.ptxas_reports.get(name, "")):
            log(f"[kernels] {name} ptxas: {line}")
    costs = launch_host_costs(K, dev.device)
    log("[kernels] host us before a launch: " + " ".join(
        f"{a}={v:.3f}" for a, v in costs.items()) + " (kernels._launch takes "
        "raw_stream and device_check in place of current_stream and "
        "device_switch)")
    entries = []
    for q in (min(1024, len(qs_all)), 16):
        qt = torch.from_numpy(qs_all[:q]).to(dev.device)
        q_i8, q_scale = K.quantize_rows(qt)

        # -- #2 bf16 streaming bins
        bins_k = K.streaming_bins(qt, dev, valid, tile, rows)
        bins_p = R.streaming_bins_bf16(qt, dev, valid, tile, rows, tile_bits)
        sync()
        dec = dict(k=k, n=n, rows=rows, tile_n=tile, tile_bits=tile_bits)
        vk, ik = K._decode_packed(bins_k, **dec)
        vp, ip = K._decode_packed(bins_p, **dec)
        err2 = float((vk - vp).abs().max())
        tol2 = 2.0 ** (tile_bits - 21) + 1e-5
        rec2 = float(np.mean([
            len(set(a.tolist()) & set(c.tolist())) / k
            for a, c in zip(ik.cpu().numpy(), ip.cpu().numpy())
        ]))
        log(f"[kernels] bf16 Q={q}: max|dv|={err2:.3g} (tol {tol2:.3g}) "
            f"recall vs plain={rec2:.4f} bins equal={float((bins_k == bins_p).float().mean()):.6f}")
        assert err2 <= tol2, ("bf16 streaming kernel values", err2, tol2)
        assert rec2 >= 0.99, ("bf16 streaming kernel recall vs plain", rec2)

        # -- #3 int8 streaming bins: bit-identical
        bins8_k = K.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile, rows)
        bins8_p = R.streaming_bins_int8(q_i8, c_i8, c_scale, valid, tile, rows,
                                        tile_bits)
        sync()
        assert torch.equal(bins8_k, bins8_p), (
            "int8 bins differ", int((bins8_k != bins8_p).sum()))
        log(f"[kernels] int8 Q={q}: bins bit-identical")

        # -- #4 extract over the kernel's bins == sort epilogue == plain
        flat = bins_k.permute(1, 0, 2).reshape(q, b).contiguous()
        ev, ei = K._extract_topk(flat, k, kpad)
        pv, pi = R.extract_topk(flat, k, kpad)
        sv, si = K._topk_bins(flat, k, epilogue="sort")
        sync()
        assert torch.equal(ev, pv) and torch.equal(ei, pi), "extract vs plain"
        assert torch.equal(ev[:, :k], sv) and torch.equal(
            ei[:, :k].long(), si), "extract vs sort epilogue"
        log(f"[kernels] extract Q={q}: identical to plain and to sort")

        # -- times (device, CUDA events)
        t = {}
        t["bf16"] = cuda_ms(lambda: K.streaming_bins(qt, dev, valid, tile, rows), reps)
        t["bf16_plain"] = cuda_ms(lambda: R.streaming_bins_bf16(
            qt, dev, valid, tile, rows, tile_bits), max(1, reps // 3))
        t["bf16_lib"] = cuda_ms(lambda: torch.topk(
            qt.to(torch.bfloat16) @ dev.to(torch.bfloat16).T, k, dim=1), max(1, reps // 3))
        t["i8"] = cuda_ms(lambda: K.streaming_bins_int8(
            q_i8, c_i8, c_scale, valid, tile, rows), reps)
        t["i8_plain"] = cuda_ms(lambda: R.streaming_bins_int8(
            q_i8, c_i8, c_scale, valid, tile, rows, tile_bits), max(1, reps // 3))
        t["i8_lib"] = cuda_ms(lambda: torch.topk(
            q_i8.to(torch.bfloat16) @ c_i8.to(torch.bfloat16).T, k, dim=1), max(1, reps // 3))
        # the s8 product alone (cuBLASLt, no top-k; a (Q, N) int32 output),
        # which takes more than 16 rows: Q = 16 runs as 32
        q_mm = q_i8 if q > 16 else torch.cat([q_i8, q_i8])
        t["i8_int_mm"] = cuda_ms(lambda: torch._int_mm(q_mm, c_i8.T), max(1, reps // 3))
        # #4 and its yardsticks take microseconds: the time of a call, and
        # beside it the device's time from CUDA graphs
        ex = (lambda: K._extract_topk(flat, k, kpad))
        lib = (lambda: torch.topk(flat, k, dim=1))
        # the sort epilogue every full-scan search runs, over the same bins
        srt = (lambda: K.topk_lowest_index(flat, k))
        t["ex"] = cuda_ms(ex, reps * 20)
        t["ex_device"] = graph_ms(ex, reps * 4)
        t["ex_plain"] = cuda_ms(lambda: R.extract_topk(flat, k, kpad), max(1, reps // 3))
        t["ex_lib"] = cuda_ms(lib, reps * 20)
        t["ex_lib_device"] = graph_ms(lib, reps * 4)
        t["ex_sort"] = cuda_ms(srt, reps * 20)
        t["ex_sort_device"] = graph_ms(srt, reps * 4)
        log(f"[kernels] Q={q} ms: " + " ".join(f"{a}={v:.4f}" for a, v in t.items()))

        out_bytes = rows * q * tile * 4
        b2 = bound_ms(n * d * 4 + q * d * 4 + n + out_bytes, 2 * q * n * d, H100_BF16_OPS)
        b3 = bound_ms(n * d + q * d + n * 4 + n + out_bytes, 2 * q * n * d, H100_INT8_OPS)
        # #4 is a top-k of B values a row: one read of the bins, one write
        # of kpad values and ids, and B compares a row outside the tensor cores
        b4 = bound_ms(q * b * 4 + 2 * q * kpad * 4, q * b, H100_FP32_OPS)
        sms = torch.cuda.get_device_properties(dev.device).multi_processor_count
        plan = K._streaming_plan(
            q, d, dev.dtype, dev.data_ptr(), n_tiles, rows, tile, sms)
        plan8 = K._int8_plan(q, d, q_i8.data_ptr(), c_i8.data_ptr(), n_tiles,
                             rows, tile, sms)
        log(f"[kernels] bf16 Q={q}: a call {t['bf16']:.4f}ms, "
            f"torch.topk(bf16 matmul) {t['bf16_lib']:.4f}ms; bound "
            f"{b2[0]:.4f}ms ({b2[1]}), {b2[0] / t['bf16']:.4f} of it; achieved "
            f"{2 * q * n * d / t['bf16'] / 1e9:.2f} TFLOP/s; plan nq={plan.nq} "
            f"query blocks={plan.qblocks} cluster={plan.cluster} "
            f"splits={plan.splits} stages={plan.stages} smem={plan.smem}; "
            f"first version "
            f"{FIRST_VERSION_MS['streaming_topk_bf16'][q]}ms a call (copied "
            f"from PERF.md, not measured here)")
        log(f"[kernels] int8 Q={q}: a call {t['i8']:.4f}ms, "
            f"torch.topk(bf16 matmul) {t['i8_lib']:.4f}ms, torch._int_mm (the s8 "
            f"product alone, {q_mm.shape[0]} rows) {t['i8_int_mm']:.4f}ms; bound "
            f"{b3[0]:.4f}ms ({b3[1]}), {b3[0] / t['i8']:.4f} of it; achieved "
            f"{2 * q * n * d / t['i8'] / 1e9:.2f} TOP/s; plan nq={plan8.nq} "
            f"query blocks={plan8.qblocks} cluster={plan8.cluster} "
            f"splits={plan8.splits} stages={plan8.stages} smem={plan8.smem} "
            f"queries kept={plan8.q_kept}; first version "
            f"{FIRST_VERSION_MS['streaming_topk_int8'][q]}ms a call (copied "
            f"from PERF.md, not measured here)")
        log(f"[kernels] extract Q={q}: a call {t['ex']:.4f}ms, torch.topk's "
            f"{t['ex_lib']:.4f}ms, the sort epilogue's (topk_lowest_index) "
            f"{t['ex_sort']:.4f}ms; on the device {t['ex_device']:.4f}ms, "
            f"{t['ex_lib_device']:.4f}ms, {t['ex_sort_device']:.4f}ms; bound "
            f"{b4[0]:.6f}ms ({b4[1]}), {b4[0] / t['ex']:.4f} of it a call, "
            f"{b4[0] / t['ex_device']:.4f} on the device; first version "
            f"{FIRST_VERSION_MS['extract_topk'][q]}ms a call (copied from "
            f"PERF.md, not measured here)")
        base = "nornicdb_tpu_torch/ops/csrc/"
        entries += [
            dict(name=f"streaming_topk_bf16[Q={q}]", route="cuda",
                 source=base + "streaming_topk_bf16.cu",
                 replaces="nornicdb_tpu/ops/pallas_kernels.py:140",
                 counter="streaming_topk_bf16", max_abs_err=err2,
                 ms=t["bf16"], plain_ms=t["bf16_plain"], bound_ms=b2[0],
                 bound_by=b2[1], library_ms=t["bf16_lib"]),
            dict(name=f"streaming_topk_int8[Q={q}]", route="cuda",
                 source=base + "streaming_topk.cu",
                 replaces="nornicdb_tpu/ops/pallas_kernels.py:244",
                 counter="streaming_topk_int8", max_abs_err=0.0,
                 ms=t["i8"], plain_ms=t["i8_plain"], bound_ms=b3[0],
                 bound_by=b3[1], library_ms=t["i8_lib"]),
            dict(name=f"extract_topk[Q={q}]", route="cuda",
                 source=base + "extract_topk.cu",
                 replaces="nornicdb_tpu/ops/pallas_kernels.py:275",
                 counter="extract_topk", max_abs_err=0.0,
                 ms=t["ex"], plain_ms=t["ex_plain"], bound_ms=b4[0],
                 bound_by=b4[1], library_ms=t["ex_lib"],
                 device_ms=t["ex_device"], library_device_ms=t["ex_lib_device"]),
        ]
        del bins_k, bins_p, bins8_k, bins8_p, flat
        torch.cuda.empty_cache()
    return entries


def phase_int8_10m(K, R, seed: int, k: int, reps: int) -> None:
    """Kernel #3 at BASELINE.json's headline scale: N_10M x 1024 int8 codes
    made on the card from ``seed`` (10.24 GB; positive scales, 1% of rows
    masked; the bin geometry of pick_tile_n and streaming_rows_for(k, .)).
    The bins are bit-identical to the plain version's at Q = 16; the time
    of a call at Q = 16 and 1024 is logged beside its bounds. A kernel time,
    not a service latency: no load, no batching, no result epilogue."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d = N_10M, DIMS
    t0 = time.perf_counter()
    c_i8 = torch.empty((n, d), dtype=torch.int8, device=dev).random_(
        -127, 128, generator=gen)
    c_scale = torch.rand(n, generator=gen, device=dev) * 1000 + 600
    valid = torch.rand(n, generator=gen, device=dev) >= 0.01
    q_all = torch.empty((1024, d), dtype=torch.int8, device=dev).random_(
        -127, 128, generator=gen)
    sync()
    tile = K.pick_tile_n(n)
    rows = min(K.streaming_rows_for(k, tile), n // tile)
    n_tiles, rows, tile_bits = K.streaming_geometry(n, tile, rows)
    log(f"[int8-10M] N={n} D={d} codes made on the card in "
        f"{time.perf_counter() - t0:.1f}s; tile_n={tile} rows={rows} "
        f"tile_bits={tile_bits} masked rows={int((~valid).sum())}")
    for q in (16, 1024):
        qt = q_all[:q].contiguous()
        if q == 16:
            got = K.streaming_bins_int8(qt, c_i8, c_scale, valid, tile, rows)
            want = R.streaming_bins_int8(qt, c_i8, c_scale, valid, tile, rows,
                                         tile_bits)
            sync()
            assert torch.equal(got, want), (
                "10M int8 bins differ", int((got != want).sum()))
            log(f"[int8-10M] Q={q}: bins bit-identical to the plain version")
            del got, want
        ms = cuda_ms(lambda: K.streaming_bins_int8(
            qt, c_i8, c_scale, valid, tile, rows), reps)
        out_bytes = rows * q * tile * 4
        nbytes = n * d + q * d + n * 4 + n + out_bytes
        b = bound_ms(nbytes, 2 * q * n * d, H100_INT8_OPS)
        log(f"[int8-10M] Q={q}: a call {ms:.4f}ms (a kernel time, not a "
            f"service latency); bytes bound {nbytes / H100_BYTES * 1e3:.4f}ms, "
            f"operations bound {2 * q * n * d / H100_INT8_OPS * 1e3:.4f}ms, "
            f"{b[0] / ms:.4f} of the larger ({b[1]})")
    del c_i8, c_scale, valid, q_all
    torch.cuda.empty_cache()


def drive_service(svc, queries: np.ndarray, k: int, writes) -> dict:
    """32 client threads x (len(queries) / 32) sequential vector_candidates
    calls; `writes()` runs on this thread meanwhile."""
    n_threads = 32
    per = len(queries) // n_threads
    results: list = [None] * len(queries)
    start = np.zeros(len(queries))
    lat = np.zeros(len(queries))
    errors: list = []

    def client(t: int) -> None:
        try:
            for j in range(per):
                i = t * per + j
                start[i] = time.perf_counter()
                results[i] = svc.vector_candidates(queries[i], k=k)
                lat[i] = time.perf_counter() - start[i]
        except Exception as e:  # reported and re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    writes()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "client thread hung"
    return dict(results=results, wall=wall, lat=lat, start=start - t0, t0=t0)


def log_timeline(run: dict, batch_log: list, out_dir: str) -> None:
    """Where the service's slow queries spent their time: each fused
    batch's start, duration and size, the gaps between batches, and the
    slowest queries' submit times, all in ms from the first client start.
    The full timeline goes to ``chiprun_out/phase2_timeline.json``."""
    t0 = run["t0"]
    batches = [((a - t0) * 1e3, (b - a) * 1e3, n) for a, b, n in batch_log]
    gaps = [(batch_log[i + 1][0] - batch_log[i][1]) * 1e3
            for i in range(len(batch_log) - 1)]
    slow = np.argsort(-run["lat"])[:4]
    queries = [(float(run["start"][i] * 1e3), float(run["lat"][i] * 1e3))
               for i in range(len(run["lat"]))]
    with open(os.path.join(out_dir, "phase2_timeline.json"), "w") as f:
        json.dump({"batches_start_ms_dur_ms_size": batches,
                   "queries_start_ms_latency_ms": queries}, f)
    log("[phase2] timeline (ms from first client start): batches "
        + " ".join(f"{s:.1f}+{d:.1f}({n})" for s, d, n in batches)
        + f"; gaps sum {sum(gaps):.1f} max {max(gaps, default=0.0):.1f}"
        + "; slowest queries (start, latency): "
        + " ".join(f"({queries[i][0]:.1f}, {queries[i][1]:.1f})" for i in slow))


def profile_search(corpus, queries: np.ndarray, k: int, batch: int,
                   out_dir: str) -> None:
    """Device busy share of sequential fused batches through
    ``DeviceCorpus.search`` (the batcher's dispatch), from torch.profiler:
    the device time of every kernel over the host wall time of the window.
    The per-op table goes to ``chiprun_out/profile_search.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [queries[i:i + batch] for i in range(0, len(queries), batch)]
    for b in batches[:3]:
        corpus.search(b, k=k)  # warm: lazily loaded kernels, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            corpus.search(b, k=k)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    with open(os.path.join(out_dir, "profile_search.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=25))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=25))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {len(batches)} batches of {batch}: wall {wall * 1e3:.2f}ms "
        f"device {dev_us / 1e3:.2f}ms busy share "
        f"{dev_us / 1e6 / wall:.4f} per batch {wall * 1e3 / len(batches):.3f}ms; top device ops: "
        + "; ".join(f"{e.key[:60]}={e.self_device_time_total / 1e3:.3f}ms"
                    for e in top))


def build_gen_requests(n: int, seed: int, vocab: int) -> list:
    """scripts/bench_generate.py's request set: the first two are rag (one
    registers the shared prefix, the next hits it); one fixed shared prefix
    per kind."""
    rng = np.random.default_rng(seed)
    weights = np.array([m[3] for m in GEN_MIX])
    kinds = rng.choice(len(GEN_MIX), size=n, p=weights / weights.sum())
    kinds[: min(2, n)] = len(GEN_MIX) - 1
    prefixes = {ki: [int(x) for x in rng.integers(4, vocab, m[4])]
                for ki, m in enumerate(GEN_MIX)}
    out = []
    for i in range(n):
        _, plen, max_new, _, pfx = GEN_MIX[kinds[i]]
        suffix = [int(x) for x in rng.integers(4, vocab, plen - pfx)]
        out.append((prefixes[kinds[i]] + suffix, max_new))
    return out


def probe_attention_inputs(Q, K, params, cfg, gcfg, rng):
    """The ragged kernel's inputs in layer 0 of one real fused step: eight
    decode lanes at mixed lengths (prefilled through ``paged_prefill_chunk``),
    a 50-token chunk (Tq = 64, 14 padding rows) behind a page it shares with
    the last decode lane, and 6 padding rows in the flat batch. Also the
    largest difference between the step's decode-row logits and the dense
    path's (``prefill`` + ``decode_step``) for the same tokens
    (``logit_diff``)."""
    import torch

    dev = params["tok_emb"].device
    ps = gcfg.page_size
    w = Q.pages_for(gcfg.max_seq_tokens, ps)
    lmax = gcfg.max_seqs + 2
    pool = Q.init_kv_pages(cfg, gcfg.pool_pages, ps, dev)
    tables = np.zeros((lmax, w), np.int32)
    free = list(range(gcfg.pool_pages - 1, 0, -1))
    lengths = [12, 27, 40, 63, 80, 110, 150, 200]
    prompts, nxt = [], []
    for i, n in enumerate(lengths):
        prompt = [int(x) for x in rng.integers(4, cfg.vocab_size, n)]
        tables[i, :Q.pages_for(n + 1, ps)] = [
            free.pop() for _ in range(Q.pages_for(n + 1, ps))]
        table = torch.from_numpy(tables[i]).to(dev)
        for a in range(0, n, 64):
            piece = prompt[a:a + 64]
            ids = torch.tensor(piece + [0] * (64 - len(piece)), device=dev)
            logits, pool = Q.paged_prefill_chunk(params, cfg, ids, pool, table,
                                                 a, len(piece))
        prompts.append(prompt)
        nxt.append(int(torch.argmax(logits)))
    chunk_lane, n_valid, tq = lmax - 2, 50, 64
    # the chunk sequence shares the last decode lane's first (full) page
    chunk_prompt = prompts[-1][:ps] + [
        int(x) for x in rng.integers(4, cfg.vocab_size, n_valid)]
    tables[chunk_lane, 0] = tables[len(lengths) - 1, 0]
    own = Q.pages_for(len(chunk_prompt) + 1, ps) - 1
    tables[chunk_lane, 1:1 + own] = [free.pop() for _ in range(own)]
    ndec = len(lengths)
    f = Q.round_up_pow2(ndec + n_valid, 8)
    meta, (tokens, lane_id, lane_pos, positions, logit_rows,
           lane_tables) = Q.pack_ragged_meta(lmax, w, f)
    tokens[:], lane_id[:], lane_pos[:], positions[:] = 0, lmax - 1, 0, -1
    logit_rows[:] = 0
    lane_tables[:] = tables
    for i in range(ndec):
        tokens[i], lane_id[i], positions[i], logit_rows[i] = (
            nxt[i], i, lengths[i], i)
    for j in range(n_valid):
        fi = ndec + j
        tokens[fi], lane_id[fi] = chunk_prompt[ps + j], chunk_lane
        lane_pos[fi], positions[fi] = j, ps + j
    logit_rows[ndec] = ndec + n_valid - 1
    captured = {}
    real = K.ragged_paged_attention

    def record(*a):
        key = "decode" if a[0].shape[1] == 1 else "chunk"
        if key not in captured:
            captured[key] = tuple(t.clone() for t in a)
        return real(*a)

    K.ragged_paged_attention = record
    try:
        _, logits, _ = Q.ragged_fused_step(
            params, cfg, torch.from_numpy(meta).to(dev), pool, lmax=lmax,
            w=w, tq=tq, attn_impl="cuda")
    finally:
        K.ragged_paged_attention = real
    # the decode rows' logits beside what the dense path gives each lane
    width = w * ps
    diffs = []
    for i, prompt in enumerate(prompts):
        _, caches = Q.prefill(params, cfg, torch.tensor([prompt], device=dev),
                              width)
        ref, _ = Q.decode_step(params, cfg, torch.tensor([nxt[i]], device=dev),
                               caches, len(prompt))
        diffs.append(float((ref[0] - logits[i]).abs().max()))
    captured["logit_diff"] = max(diffs)
    return captured


def attention_library(q, k_pages, v_pages, tables, positions):
    """One gather of each lane's pages plus PyTorch's fused attention: the
    yardstick of the ragged kernel (timed only)."""
    import torch
    import torch.nn.functional as F

    l, tq, h, dh = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    s = tables.shape[1] * ps
    idx = tables.long()
    k = k_pages[idx].reshape(l, s, hkv, dh).transpose(1, 2)
    v = v_pages[idx].reshape(l, s, hkv, dh).transpose(1, 2)
    visible = torch.arange(s, device=q.device) <= positions[..., None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=visible[:, None], enable_gqa=True)


def phase_attention(K, R, captured, logit_diffs, reps):
    """The ragged kernel against its plain version on a real step's inputs,
    its time, the plain and library times, and its bound: the bytes of the
    valid q rows, the output, the tables and positions, and the K/V pages
    each lane needs (slots up to its largest position), at 3.35 TB/s."""
    import torch

    entries = []
    log(f"[phase5] fused step vs dense path, decode rows, {len(logit_diffs)} "
        f"probes: max|dlogit|=" + " ".join(f"{d:.4g}" for d in logit_diffs)
        + f" (at most {GEN_MARGIN_TOL / 2})")
    assert max(logit_diffs) <= GEN_MARGIN_TOL / 2, (
        "fused step logits vs dense path", logit_diffs)
    for key in ("decode", "chunk"):
        a = captured[key]
        q, k_pages, v_pages, tables, positions = a
        l, tq, h, dh = q.shape
        ps, hkv = k_pages.shape[1], k_pages.shape[2]
        got = K.ragged_paged_attention(*a)
        want = R.ragged_paged_attention(*a)
        sync()
        err = float((got.float() - want.float()).abs().max())
        tol_ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), rtol=ATTN_TOL_BF16, atol=ATTN_TOL_BF16)
        pos = positions.cpu().numpy()
        lane_max = pos.max(axis=1)
        pages = int(sum(-(-(m + 1) // ps) for m in lane_max if m >= 0))
        esize = q.element_size()
        # q of the valid rows only (a padding row's query is never needed),
        # the whole output, tables, positions and the pages the lanes need;
        # both products take operands of q's type, summed in float32
        rows = int((pos >= 0).sum())
        nbytes = ((rows * h * dh + q.numel()) * esize + tables.numel() * 4
                  + pos.size * 4 + 2 * pages * ps * hkv * dh * esize)
        ops = 4 * h * dh * int((pos[pos >= 0] + 1).sum())
        bound = bound_ms(nbytes, ops, H100_BF16_OPS
                         if q.dtype == torch.bfloat16 else H100_FP32_OPS)
        # a call takes tens of microseconds: its time (the median of five
        # runs), and beside it the device's time from CUDA graphs
        kern = (lambda: K.ragged_paged_attention(*a))
        lib = (lambda: attention_library(*a))
        t = {"ms": call_ms(kern, reps * 20),
             "device": graph_ms(kern, reps * 4),
             "plain": call_ms(lambda: R.ragged_paged_attention(*a), reps * 20),
             "lib": call_ms(lib, reps * 20),
             "lib_device": graph_ms(lib, reps * 4)}
        plan = K._ragged_plan(l, tq, h, hkv, dh, k_pages.shape[0], ps,
                              tables.shape[1], q.dtype)
        log(f"[phase5] ragged {key}: L={l} Tq={tq} H={h} Hkv={hkv} Dh={dh} "
            f"P={tables.shape[1]} valid rows={rows} "
            f"pages read={pages} max|d|={err:.3g} (tol {ATTN_TOL_BF16:.3g}) "
            f"ms={t['ms']:.4f} device={t['device']:.4f} plain={t['plain']:.4f} "
            f"lib={t['lib']:.4f} lib device={t['lib_device']:.4f} "
            f"bound={bound[0]:.5f} ({bound[1]}); plan qb={plan.qb} "
            f"cluster={plan.cluster} smem={plan.smem}; CTAs a lane "
            + str([K._ragged_split(int(m), tables.shape[1] * ps) for m in lane_max])
            + f"; first version "
            f"{FIRST_VERSION_MS['ragged_paged_attention'][key]}ms a call "
            f"(copied from PERF.md, not measured here)")
        assert tol_ok, ("ragged kernel vs plain", key, err)
        entries.append(dict(
            name=f"ragged_paged_attention[{key} L={l} Tq={tq}]", route="cuda",
            source="nornicdb_tpu_torch/ops/csrc/ragged_paged_attention.cu",
            replaces="nornicdb_tpu/ops/pallas_kernels.py:446",
            counter="ragged_paged_attention", max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain"], bound_ms=bound[0], bound_by=bound[1],
            library_ms=t["lib"], device_ms=t["device"],
            library_device_ms=t["lib_device"]))
    return entries


def drive_engine(eng, requests: list, n_threads: int) -> dict:
    """n_threads closed-loop clients, request i on thread i % n_threads:
    submit, stream every token (time to first token, gaps between
    tokens, the whole request), next request."""
    n = len(requests)
    outs: list = [None] * n
    ttft = np.zeros(n)
    lat = np.zeros(n)
    gaps: list = []
    errors: list = []
    lock = threading.Lock()

    def client(t: int) -> None:
        try:
            for i in range(t, n, n_threads):
                prompt, max_new = requests[i]
                t0 = time.perf_counter()
                h = eng.submit(prompt, max_new_tokens=max_new)
                last, mine = None, []
                for _ in h.stream_tokens():
                    now = time.perf_counter()
                    if last is None:
                        ttft[i] = now - t0
                    else:
                        mine.append(now - last)
                    last = now
                outs[i] = h.result()
                lat[i] = time.perf_counter() - t0
                with lock:
                    gaps.extend(mine)
        except Exception as e:  # reported and re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "client thread hung"
    return dict(outs=outs, ttft=ttft, gaps=np.asarray(gaps), lat=lat,
                wall=wall)


def dense_agreement(Q, params, cfg, prompt, gen, max_new, eos, max_len):
    """Check every greedy token of ``gen`` against the dense plain
    reference (prefill + decode_step at the engine's cache width, fed the
    engine's own tokens): the token's reference logit must lie within
    GEN_MARGIN_TOL of the reference's largest, so only a near-tie may pick
    another token. Returns (tokens equal to the reference's argmax, the
    largest shortfall of a chosen token's logit)."""
    import torch

    dev = params["tok_emb"].device
    logits, caches = Q.prefill(
        params, cfg, torch.tensor([prompt], device=dev), max_len)
    pos = len(prompt)
    equal, worst = 0, 0.0
    for j, tok in enumerate(gen):
        row = logits[0]
        ref = int(torch.argmax(row))
        short = float(row[ref] - row[tok])
        assert short <= GEN_MARGIN_TOL, (
            "engine's token is no near-tie of the dense reference's",
            j, tok, ref, short)
        equal += tok == ref
        worst = max(worst, short)
        if j + 1 < len(gen):
            logits, caches = Q.decode_step(
                params, cfg, torch.tensor([tok], device=dev), caches, pos)
            pos += 1
    assert gen[-1] == eos or len(gen) == max_new, ("stopped early", len(gen))
    return equal, worst


def profile_generation(eng, requests: list, out_dir: str) -> None:
    """Device busy share of the engine serving ``requests`` (all submitted
    at once), from torch.profiler: the device time of every kernel over the
    host wall time of the window, and kernels launched per fused step. The
    per-op table goes to ``chiprun_out/profile_generate.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = eng.stats.fused_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=m) for p, m in requests]
        for h in handles:
            h.result()
        wall = time.perf_counter() - t0
    steps = eng.stats.fused_steps - steps0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launched = sum(e.count for e in kernels)
    with open(os.path.join(out_dir, "profile_generate.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] generation: {len(requests)} requests, {steps} fused steps "
        f"in {wall * 1e3:.2f}ms ({wall * 1e3 / max(1, steps):.3f}ms a step); "
        f"device {dev_us / 1e3:.2f}ms busy share {dev_us / 1e6 / wall:.4f}; "
        f"{launched / max(1, steps):.1f} device ops a step; top device ops: "
        + "; ".join(f"{e.key[:50]}={e.self_device_time_total / 1e3:.3f}ms"
                    f"/{e.count}" for e in top))


def phase_generation(K, R, seed: int, profile_dir: str = "") -> tuple[list, dict]:
    """Phase 5: the ragged kernel on a real step, then the engine serving
    32 requests at full width, checked against the dense reference. With
    ``profile_dir``, then a torch.profiler window over 8 more requests."""
    import torch

    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.genserve import GenerationEngine
    from nornicdb_tpu_torch.models import qwen2 as Q
    from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

    cfg = Q.QWEN25_05B
    gcfg = GenServeConfig()
    t0 = time.perf_counter()
    params = Q.with_f32_logit_weights(Q.init_params(cfg, seed, "cuda"))
    n_params = sum(t.numel() for t in [params["tok_emb"]] + [
        x for blk in params["blocks"] for p in blk.values() for x in p.values()])
    sync()
    log(f"[phase5] QWEN25_05B bf16: {n_params} parameters in "
        f"{time.perf_counter() - t0:.1f}s")

    # -- 5a: the kernel on a real step's inputs; the fused step's logits
    # against the dense path's over GEN_PROBES prompt sets
    t0 = time.perf_counter()
    probes = [probe_attention_inputs(Q, K, params, cfg, gcfg,
                                     np.random.default_rng(seed + i))
              for i in range(GEN_PROBES)]
    sync()
    entries = phase_attention(K, R, probes[0],
                              [p["logit_diff"] for p in probes], REPS)
    del probes
    log(f"[phase5] kernel vs plain: {time.perf_counter() - t0:.1f}s")

    # -- 5b: the engine
    tok = HashTokenizer(cfg.vocab_size)
    eng = GenerationEngine(params, cfg, tokenizer=tok, config=gcfg)
    t0 = time.perf_counter()
    K.reset_launch_counts()
    eng.warmup()
    sync()
    warm = K.launch_counts()["ragged_paged_attention"]
    classes = eng._ragged_classes()
    log(f"[phase5] warmup {len(classes)} classes in "
        f"{time.perf_counter() - t0:.1f}s, {warm} kernel launches")
    assert warm == cfg.layers * sum(1 + (tq > 1) for _, tq in classes)
    requests = build_gen_requests(GEN_REQUESTS, seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    run = drive_engine(eng, requests, GEN_CLIENTS)
    launches = K.launch_counts()["ragged_paged_attention"]
    st = dataclasses.replace(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    if profile_dir:
        profile_generation(eng, requests[:GEN_CLIENTS], profile_dir)
    eng.stop()
    tokens = sum(len(o) for o in run["outs"])
    paged = serve_summary(run)
    log(f"[phase5] {GEN_REQUESTS} requests from {GEN_CLIENTS} clients: "
        f"{tokens} tokens in {run['wall']:.3f}s tok/s={paged['tok_s']:.1f} "
        f"ttft p50={paged['ttft_p50']:.2f}ms "
        f"p99={np.percentile(run['ttft'], 99) * 1e3:.2f}ms "
        f"per-token p50={paged['gap_p50']:.2f}ms "
        f"fused steps={st.fused_steps} chunk steps={st.prefill_chunks} "
        f"mean decode lanes={st.decode_lane_tokens / max(1, st.decode_steps):.2f} "
        f"prefix hits={st.prefix_hits} reused tokens={st.prefix_reused_tokens} "
        f"launches={launches} max_memory_allocated={peak / 2**30:.3f}GiB "
        f"({held / 2**30:.3f}GiB held before the run) stats={st.as_dict()}")
    assert st.completed == GEN_REQUESTS and all(
        o for o in run["outs"]), ("requests not completed", st.as_dict())
    assert st.prefix_hits > 0, "the prefix cache never hit"
    assert launches > 0 and launches == cfg.layers * (
        st.fused_steps + st.prefill_chunks), (
        "ragged launches", launches, st.fused_steps, st.prefill_chunks)

    # -- 5c: greedy tokens against the dense plain reference
    t0 = time.perf_counter()
    width = Q.pages_for(gcfg.max_seq_tokens, gcfg.page_size) * gcfg.page_size
    equal = full = 0
    worst = 0.0
    for (prompt, max_new), gen in zip(requests, run["outs"]):
        same, short = dense_agreement(Q, params, cfg, prompt, gen, max_new,
                                      tok.eos_id, width)
        equal += same
        full += same == len(gen)
        worst = max(worst, short)
    log(f"[phase5] dense reference: all {tokens} tokens checked, {equal} "
        f"equal to its argmax, {full}/{GEN_REQUESTS} requests equal in full, "
        f"largest shortfall of a chosen token {worst:.4g} (at most "
        f"{GEN_MARGIN_TOL}) in {time.perf_counter() - t0:.1f}s")
    del eng

    t0 = time.perf_counter()
    phase_dense_mode(K, Q, params, cfg, gcfg, tok, requests, paged)
    log(f"[phase5d] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_sync_generation(Q, params, cfg, tok, seed)
    log(f"[phase5e] {time.perf_counter() - t0:.1f}s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return entries, {"ragged_paged_attention": launches}


def serve_summary(run: dict) -> dict:
    """tok/s over the run, ttft p50 and per-token p50 (ms) of a
    ``drive_engine`` run."""
    tokens = sum(len(o) for o in run["outs"])
    return {"tok_s": tokens / run["wall"],
            "ttft_p50": float(np.median(run["ttft"])) * 1e3,
            "gap_p50": float(np.median(run["gaps"])) * 1e3}


def phase_dense_mode(K, Q, params, cfg, gcfg, tok, requests, paged) -> None:
    """Phase 5d: the engine in ``mode="dense"`` (a dense cache a sequence,
    torch ops) serves the first DENSE_REQUESTS of phase 5's requests from
    GEN_CLIENTS clients. No ragged kernel launches; every token passes
    ``dense_agreement`` at the width the engine gave its cache. Its
    tok/s, ttft and per-token p50 are logged beside phase 5's paged run
    (32 requests), to read, not to compare as a claim."""
    import torch

    from nornicdb_tpu_torch.genserve import GenerationEngine

    dcfg = dataclasses.replace(gcfg, mode="dense")
    eng = GenerationEngine(params, cfg, tokenizer=tok, config=dcfg)
    eng.warmup()  # one tiny request
    sub = requests[:DENSE_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    st0 = dataclasses.replace(eng.stats)
    run = drive_engine(eng, sub, GEN_CLIENTS)
    launches = K.launch_counts()["ragged_paged_attention"]
    st = dataclasses.replace(eng.stats)
    programs = sorted(eng.programs)
    peak = torch.cuda.max_memory_allocated()
    eng.stop()
    dense = serve_summary(run)
    tokens = sum(len(o) for o in run["outs"])
    log(f"[phase5d] dense mode, {len(sub)} requests from {GEN_CLIENTS} "
        f"clients: {tokens} tokens in {run['wall']:.3f}s "
        f"tok/s={dense['tok_s']:.1f} ttft p50={dense['ttft_p50']:.2f}ms "
        f"per-token p50={dense['gap_p50']:.2f}ms (phase 5 paged, 32 "
        f"requests: tok/s={paged['tok_s']:.1f} ttft p50="
        f"{paged['ttft_p50']:.2f}ms per-token p50={paged['gap_p50']:.2f}ms); "
        f"prefills={st.prefill_chunks - st0.prefill_chunks} decode steps="
        f"{st.decode_steps - st0.decode_steps} "
        f"ragged launches={launches} longest request "
        f"{run['lat'].max():.3f}s (deadline {dcfg.deadline_ms / 1e3:g}s) "
        f"cache widths "
        f"{sorted({p[-1] for p in programs})} max_memory_allocated="
        f"{peak / 2**30:.3f}GiB")
    assert st.completed - st0.completed == len(sub) and all(run["outs"]), (
        st.as_dict())
    assert launches == 0 and st.fused_steps == 0, ("dense mode ran the "
                                                   "ragged kernel", launches)
    equal = 0
    for (prompt, max_new), gen in zip(sub, run["outs"]):
        width = Q.round_up_pow2(min(len(prompt) + max_new,
                                    dcfg.max_seq_tokens))
        same, _ = dense_agreement(Q, params, cfg, prompt, gen, max_new,
                                  tok.eos_id, width)
        equal += same
    log(f"[phase5d] dense reference: all {tokens} tokens checked, {equal} "
        "equal to its argmax")


def phase_sync_generation(Q, params, cfg, tok, seed: int) -> None:
    """Phase 5e: Heimdall's synchronous ``QwenGenerator`` over phase 5's
    parameters on 4 text prompts. ``generate``'s text is ``qwen2.generate``'s
    tokens, which pass ``dense_agreement``; ``generate_stream``'s deltas
    join to that text; sampling at SYNC_TEMPERATURE repeats for one seed
    and moves for another; every id is below the vocabulary size."""
    from nornicdb_tpu_torch.heimdall import QwenGenerator
    from nornicdb_tpu_torch.heimdall.manager import _trim_prompt_ids

    gen = QwenGenerator(cfg=cfg, params=params, tokenizer=tok)
    rng = np.random.default_rng(seed + 5)
    prompts = [" ".join(rng.choice(EMBED_WORDS, size=n))
               for n in SYNC_PROMPT_WORDS]
    eos = tok.eos_id
    t_gen, t_stream, sampled, equal, n_tokens = [], [], {}, 0, 0
    for text in prompts:
        ids = _trim_prompt_ids(tok, text, gen.max_context)
        t0 = time.perf_counter()
        out = gen.generate(text, SYNC_NEW)
        t_gen.append(time.perf_counter() - t0)
        toks = Q.generate(gen.params, cfg, ids, SYNC_NEW, eos_id=eos)
        assert tok.decode(toks) == out, ("generate's text", text)
        # generate cuts the eos off; the reference check wants it back
        full = toks + ([eos] if len(toks) < SYNC_NEW else [])
        same, _ = dense_agreement(Q, gen.params, cfg, ids, full, SYNC_NEW,
                                  eos, len(ids) + SYNC_NEW)
        equal += same
        n_tokens += len(full)
        t0 = time.perf_counter()
        stream = list(gen.generate_stream(text, SYNC_NEW))
        t_stream.append(time.perf_counter() - t0)
        assert "".join(stream) == out, ("stream deltas", text)
        for s in (seed + 1, seed + 1, seed + 2):
            sampled.setdefault(s, []).append(Q.generate(
                gen.params, cfg, ids, SYNC_NEW, temperature=SYNC_TEMPERATURE,
                eos_id=eos, seed=s))
    one, again = sampled[seed + 1][0::2], sampled[seed + 1][1::2]
    other = sampled[seed + 2]
    changed = sum(a != b for a, b in zip(one, other))
    ids_ok = all(0 <= t < cfg.vocab_size for r in one + other for t in r)
    log(f"[phase5e] QwenGenerator, {len(prompts)} prompts of "
        f"{list(SYNC_PROMPT_WORDS)} words x {SYNC_NEW} tokens: generate "
        f"p50={np.median(t_gen) * 1e3:.1f}ms stream p50="
        f"{np.median(t_stream) * 1e3:.1f}ms ({SYNC_NEW / np.median(t_gen):.1f} "
        f"tok/s a request); dense reference: {n_tokens} tokens checked, "
        f"{equal} equal to its argmax; T={SYNC_TEMPERATURE}: seed {seed + 1} "
        f"twice identical {one == again}, seed {seed + 2} changed {changed}/"
        f"{len(prompts)} outputs")
    assert one == again, "sampling is not deterministic for one seed"
    assert changed >= 1, "another seed changed no output"
    assert ids_ok, "a sampled id is outside the vocabulary"


def phase_fused_cosine(K, R, dev, valid, qs_all, k, reps):
    """Phase 6: kernel #1 on the main path (``ops.fused_cosine_topk`` at
    Q = 1024 and Q = 16, tile_n 128: 1,000,064 rows are no multiple of 512),
    then against its plain version and timed. Returns (entries, launches)."""
    import torch
    import torch.nn.functional as F

    from nornicdb_tpu_torch import ops
    from nornicdb_tpu_torch.ops import _build

    n, d = dev.shape
    log(f"[phase6] device memory allocated at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.3f}GiB (this corpus buffer "
        f"{dev.numel() * dev.element_size() / 2**30:.3f}GiB)")
    for line in ptxas_summary(_build.ptxas_reports.get("fused_cosine", "")):
        log(f"[phase6] fused_cosine ptxas: {line}")
    qts = {q: torch.from_numpy(qs_all[:q]).to(dev.device) for q in (1024, 16)}
    K.reset_launch_counts()
    served = {q: ops.fused_cosine_topk(qt, dev, valid, k, tile_n=128)
              for q, qt in qts.items()}
    sync()
    launches = K.launch_counts()["fused_cosine_scores"]
    assert launches == len(qts), ("fused cosine launches", launches)
    entries = []
    for q, qt in qts.items():
        got = K.fused_cosine_scores(qt, dev, tile_n=128)
        want = R.fused_cosine_scores(qt, dev)
        sync()
        err = float((got - want).abs().max())
        del got
        masked = torch.where(valid[None, :], want, float("-inf"))
        del want
        _, pi = K.topk_lowest_index(masked, k)
        vk, ik = served[q]
        same = float((ik == pi).float().mean())
        # an id may differ only where two scores lie within the tolerance
        rr, jj = torch.nonzero(ik != pi, as_tuple=True)
        gap = float((masked[rr, ik[rr, jj]] - masked[rr, pi[rr, jj]]).abs().max()
                    ) if rr.numel() else 0.0
        del masked
        t = {"ms": cuda_ms(lambda: K.fused_cosine_scores(qt, dev, tile_n=128),
                           reps),
             "plain": cuda_ms(lambda: R.fused_cosine_scores(qt, dev),
                              max(1, reps // 3)),
             "lib": cuda_ms(lambda: torch.matmul(
                 qt, F.normalize(dev, dim=1).T), max(1, reps // 3))}
        ops_n = 2 * q * n * d + 3 * n * d
        b = bound_ms(n * d * 4 + q * d * 4 + q * n * 4, ops_n, H100_FP32_OPS)
        log(f"[phase6] fused cosine Q={q} N={n} D={d}: max|d|={err:.3g} (tol "
            f"{COSINE_TOL}) top-{k} ids equal to plain {same:.6f}, largest "
            f"score gap of a swapped id {gap:.3g}; ms={t['ms']:.4f} "
            f"plain={t['plain']:.4f} lib={t['lib']:.4f} bound={b[0]:.4f} "
            f"({b[1]}), {b[0] / t['ms']:.4f} of it; achieved "
            f"{ops_n / t['ms'] / 1e9:.2f} TFLOP/s; first version "
            f"{FIRST_VERSION_MS['fused_cosine_scores'][q]}ms (copied from "
            f"PERF.md, not measured here)")
        assert err <= COSINE_TOL, ("fused cosine kernel vs plain", q, err)
        assert gap <= COSINE_TOL, ("fused cosine top-k swap", q, gap)
        entries.append(dict(
            name=f"fused_cosine_scores[Q={q}]", route="cuda",
            source="nornicdb_tpu_torch/ops/csrc/fused_cosine.cu",
            replaces="nornicdb_tpu/ops/pallas_kernels.py:36",
            counter="fused_cosine_scores", max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain"], bound_ms=b[0], bound_by=b[1],
            library_ms=t["lib"]))
        torch.cuda.empty_cache()
    del served
    torch.cuda.empty_cache()
    return entries, {"fused_cosine_scores": launches}


def _rss_gib() -> float:
    """This process's resident host memory now, GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("VmRSS not in /proc/self/status")


def phase_ivf(svc, corpus, qs_serve, k, phase2: dict):
    """Phase 7: recluster (fit, layout, tune) and IVF serving through the
    batcher with the tuned plan."""
    import torch

    from nornicdb_tpu_torch.ops import ivf as IV
    from nornicdb_tpu_torch.ops import kernels as K
    from nornicdb_tpu_torch.ops.kmeans import optimal_k
    from nornicdb_tpu_torch.search import service as SV

    # -- 7.1 recluster, its steps timed
    secs: dict = {"upload": 0.0}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        return wrapped

    real = (SV.kmeans_fit, IV.build_ivf_layout, IV._scatter_rows)
    SV.kmeans_fit = timed("fit", SV.kmeans_fit)
    IV.build_ivf_layout = timed("layout", IV.build_ivf_layout)
    IV._scatter_rows = timed("upload", IV._scatter_rows)
    peak_rss = [_rss_gib()]
    rss0 = peak_rss[0]
    stop = threading.Event()

    def sample_rss() -> None:
        while not stop.wait(0.05):
            peak_rss[0] = max(peak_rss[0], _rss_gib())

    sampler = threading.Thread(target=sample_rss)
    sampler.start()
    t0 = time.perf_counter()
    try:
        svc.recluster()
    finally:
        stop.set()
        sampler.join()
        SV.kmeans_fit, IV.build_ivf_layout, IV._scatter_rows = real
    t_recluster = time.perf_counter() - t0
    layout = corpus._ivf
    state = svc._tune_state
    spilled = int((layout.residual_slots >= 0).sum())
    log(f"[phase7] recluster {t_recluster:.1f}s: fit {secs['fit']:.2f}s "
        f"(K={layout.k}, sample {svc.config.cluster_fit_sample}), layout build "
        f"{secs['layout']:.2f}s of which row upload {secs['upload']:.2f}s, "
        f"tune {state.tune_seconds:.2f}s; Cmax={layout.cmax} spilled rows="
        f"{spilled} layout device bytes={layout.device_bytes} "
        f"({layout.device_bytes / 2**30:.3f}GiB); host RSS {rss0:.2f}GiB before, "
        f"peak {peak_rss[0]:.2f}GiB during recluster, process peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}GiB")
    log(f"[phase7] tune: {json.dumps(state.as_dict())}")
    assert layout.k == optimal_k(len(corpus)), ("clusters", layout.k)
    assert state.outcome == "ok", ("tune outcome", state.as_dict())
    assert 0 < state.n_probe < layout.k, ("n_probe", state.n_probe)

    # -- 7.2 fused batches of 16 back to back: IVF beside the full scan, and
    # ivf_search alone (the search less its id resolution and filtering)
    batches = [qs_serve[i:i + 16] for i in range(0, 256, 16)]
    side = {}
    runs = (("full", lambda b: corpus.search(b, k=k)),
            ("ivf", lambda b: corpus.search(b, k=k, n_probe=state.n_probe)),
            ("ivf_search", lambda b: IV.ivf_search(layout, b, k,
                                                   state.n_probe)),
            ("ivf2", lambda b: corpus.search(b, k=k, n_probe=state.n_probe)),
            ("full2", lambda b: corpus.search(b, k=k)))
    for name, fn in runs:
        fn(batches[0])
        t0 = time.perf_counter()
        for b in batches:
            fn(b)
        side[name] = (time.perf_counter() - t0) * 1e3 / len(batches)
    log("[phase7] sequential batches of 16, ms a batch: "
        + " ".join(f"{a}={v:.3f}" for a, v in side.items()))

    # -- 7.3 the service with the tuned plan
    batch_log: list = []
    inner = svc._batched_corpus_search

    def timed_batch(queries, kk, min_sim):
        t = time.perf_counter()
        try:
            return inner(queries, kk, min_sim)
        finally:
            batch_log.append((t, time.perf_counter(), len(queries)))

    svc._batched_corpus_search = timed_batch
    sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    d0 = corpus.sync_stats.device_dispatches
    run = drive_service(svc, qs_serve, k, lambda: None)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    dispatches = corpus.sync_stats.device_dispatches - d0
    with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(qs_serve, dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    rec = recall(run["results"], gt_ids)
    batch_ms = [(b - a) * 1e3 for a, b, _ in batch_log]
    sizes = [n for _, _, n in batch_log]
    log(f"[phase7] IVF n_probe={state.n_probe}: {len(qs_serve)} queries in "
        f"{run['wall']:.3f}s qps={len(qs_serve) / run['wall']:.1f} "
        f"(phase 2 full scan {phase2['qps']:.1f}) client "
        f"p50={np.median(run['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(run['lat'], 99) * 1e3:.2f}ms (phase 2 "
        f"{phase2['p50']:.2f} / {phase2['p99']:.2f}) batch "
        f"p50={np.median(batch_ms):.2f}ms, {len(batch_log)} batches of mean "
        f"{np.mean(sizes):.1f} (max {max(sizes)}), dispatches={dispatches} "
        f"recall@{k}={rec:.4f} launches={counts} peak device memory "
        f"{peak / 2**30:.3f}GiB ({held / 2**30:.3f}GiB held before, a served "
        f"batch at most {(peak - held) / 2**30:.3f}GiB)")
    assert rec >= 0.95, ("IVF serving recall", rec)
    assert dispatches < len(qs_serve), ("no fusion", dispatches)
    # the pruned path served every batch: a full-scan fallback would have
    # launched the streaming kernel
    assert counts["streaming_topk_bf16"] == 0, ("full-scan fallback", counts)


def build_texts(n: int, seed: int) -> tuple[list, np.ndarray]:
    """scripts/bench_embed.py's corpus with a unique last word a text:
    (texts, kind index of each)."""
    rng = np.random.default_rng(seed)
    weights = np.array([m[1] for m in EMBED_MIX])
    kinds = rng.choice(len(EMBED_MIX), size=n, p=weights / weights.sum())
    texts = []
    for i in range(n):
        _, _, lo, hi = EMBED_MIX[kinds[i]]
        words = rng.choice(EMBED_WORDS, size=int(rng.integers(lo, hi + 1)))
        texts.append(" ".join(words) + f" n{i}")
    return texts, kinds


def drive_embed(eng, texts: list, n_threads: int, per_call: int) -> dict:
    """n_threads closed-loop clients, each embedding its contiguous share
    of ``texts`` in calls of ``per_call``, as the EmbedWorker and HTTP
    /nornicdb/embed call ``embed_batch``."""
    share = len(texts) // n_threads
    out: list = [None] * len(texts)
    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(t: int) -> None:
        try:
            for i in range(t * share, (t + 1) * share, per_call):
                t0 = time.perf_counter()
                out[i:i + per_call] = eng.embed_batch(texts[i:i + per_call])
                with lock:
                    lat.append(time.perf_counter() - t0)
        except Exception as e:  # reported and re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "client thread hung"
    return dict(out=out, lat=np.asarray(lat), wall=wall)


def profile_embed(eng, texts: list, out_dir: str) -> None:
    """Device busy share of the engine serving about 32 packs of the timed
    mix (16 clients x 2 calls of 64 texts), from torch.profiler: the device
    time of every kernel over the host wall time, device ops a pack, and
    the GEMM rows' share of device time (every product of the forward is
    float32: ``dense`` casts to float32 beside a bias, attention scores
    and P.V in float32). The per-op table goes to
    ``chiprun_out/profile_embed.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = EMBED_CLIENTS * 2 * EMBED_CALL
    packs0 = eng.stats.packed_batches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = drive_embed(eng, texts[:n], EMBED_CLIENTS, EMBED_CALL)
    packs = eng.stats.packed_batches - packs0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    gemm = [e for e in kernels if "gemm" in e.key.lower()]
    gemm_us = sum(e.self_device_time_total for e in gemm)
    launched = sum(e.count for e in kernels)
    with open(os.path.join(out_dir, "profile_embed.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=30))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] embed: {n} texts in {packs} packs, wall "
        f"{run['wall'] * 1e3:.2f}ms ({run['wall'] * 1e3 / max(1, packs):.3f}ms "
        f"a pack); device {dev_us / 1e3:.2f}ms busy share "
        f"{dev_us / 1e6 / run['wall']:.4f}; {launched / max(1, packs):.1f} "
        f"device ops a pack; GEMM rows (float32) {gemm_us / 1e3:.2f}ms, "
        f"{gemm_us / max(dev_us, 1e-9):.4f} of device time over "
        f"{sum(e.count for e in gemm)} calls; top device ops: "
        + "; ".join(f"{e.key[:50]}={e.self_device_time_total / 1e3:.3f}ms"
                    f"/{e.count}" for e in top))


def phase_embed(K, seed: int, k: int, profile_dir: str = "") -> dict:
    """Phase 8: bge-m3 at full width and depth behind ServingEngine
    (ServingConfig defaults) embeds EMBED_TEXTS texts from EMBED_CLIENTS
    clients, checked against the padded per-request path; then a
    SearchService over the embeddings serves EMBED_QUERIES stored texts
    embedded again. Returns what phases 10 and 9 serve from: the texts,
    their embeddings and the embed engine, still running."""
    import torch

    from nornicdb_tpu_torch._device import map_tree
    from nornicdb_tpu_torch.config import ServingConfig
    from nornicdb_tpu_torch.embed import DeviceEmbedder
    from nornicdb_tpu_torch.models import bge_m3 as B
    from nornicdb_tpu_torch.models.tokenizer import HashTokenizer
    from nornicdb_tpu_torch.ops import similarity as S
    from nornicdb_tpu_torch.search import SearchConfig, SearchService
    from nornicdb_tpu_torch.serving import ServingEngine

    cfg = B.BGE_M3
    t0 = time.perf_counter()
    params = B.init_params(cfg, seed, "cuda")
    leaves: list = []
    map_tree(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    sync()
    log(f"[phase8] BGE_M3 bf16: {n_params} parameters "
        f"({n_params * 2 / 1e9:.3f} GB) in {time.perf_counter() - t0:.1f}s")
    tok = HashTokenizer(cfg.vocab_size)
    emb = DeviceEmbedder(cfg=cfg, params=params, tokenizer=tok, max_len=512,
                         device="cuda")
    eng = ServingEngine(emb, ServingConfig())
    t0 = time.perf_counter()
    texts, kinds = build_texts(EMBED_TEXTS, seed)
    log(f"[phase8] {EMBED_TEXTS} texts in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{m[0]} {int((kinds == i).sum())}"
                    for i, m in enumerate(EMBED_MIX)))

    # every pack of the engine, timed: wall (the forward ends in a copy to
    # the host, so a sync) and device span (CUDA events around it)
    pack_log: list = []
    packed = emb.embed_packed

    def timed_packed(pack):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        ev0.record()
        out = packed(pack)
        ev1.record()
        ev1.synchronize()
        pack_log.append((time.perf_counter() - t, ev0.elapsed_time(ev1),
                         pack.shape_class, pack.n_segments, pack.tokens))
        return out

    emb.embed_packed = timed_packed

    # -- 8.1 warm each capacity class the mix reaches with one untimed full
    # pack (cuBLAS initialisation, allocator growth), outside the engine
    packer = eng._packer
    t0 = time.perf_counter()
    warmed = []
    for cap, kind in ((32, 0), (64, 2)):
        seqs = [tok.encode(texts[i], max_len=packer.max_len)
                for i in np.flatnonzero(kinds == kind)[:512]]
        take, _, _ = packer.plan([len(s) for s in seqs], budget_tokens=8192,
                                 capacity=cap)
        warm = packer.pack(seqs[:take], capacity=cap)  # as the engine packs
        packed(warm)
        warmed.append((*warm.ids.shape, take))
    sync()
    log(f"[phase8] warm packs (R, C, texts) {warmed} in "
        f"{time.perf_counter() - t0:.1f}s")
    assert {c for _, c, _ in warmed} == {32, 64}

    # -- 8.2 the timed window
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    run = drive_embed(eng, texts, EMBED_CLIENTS, EMBED_CALL)
    peak = torch.cuda.max_memory_allocated()
    snap = eng.stats_snapshot()
    st = dataclasses.replace(eng.stats)
    window = list(pack_log)
    embs = np.stack(run["out"])
    wall_ms = np.array([w for w, _, _, _, _ in window]) * 1e3
    span_ms = np.array([d for _, d, _, _, _ in window])
    classes = sorted({s for _, _, s, _, _ in window})
    log(f"[phase8] {EMBED_TEXTS} texts from {EMBED_CLIENTS} clients x "
        f"{EMBED_CALL} a call in {run['wall']:.3f}s: "
        f"embeddings/s={EMBED_TEXTS / run['wall']:.1f} "
        f"tokens/s={st.tokens / run['wall']:.1f} ({st.tokens} real tokens) "
        f"client p50={np.median(run['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(run['lat'], 99) * 1e3:.2f}ms; "
        f"packs={st.packed_batches} texts a pack={st.texts / st.packed_batches:.2f} "
        f"pack p50 wall={np.median(wall_ms):.3f}ms device span "
        f"p50={np.median(span_ms):.3f}ms (p99 {np.percentile(wall_ms, 99):.3f} / "
        f"{np.percentile(span_ms, 99):.3f}ms) device seconds "
        f"{st.device_seconds:.3f} of {run['wall']:.3f}; "
        f"pack_efficiency={snap['pack_efficiency']} staging_overlap_ratio="
        f"{snap['staging_overlap_ratio']} (R, C, S) classes used {classes}; "
        f"sheds queue_full={st.sheds_queue_full} deadline={st.sheds_deadline}; "
        f"peak device memory {peak / 2**30:.3f}GiB ({held / 2**30:.3f}GiB held "
        f"before)")
    assert st.texts == EMBED_TEXTS and st.packed_batches == len(window)
    assert st.sheds_queue_full == 0 and st.sheds_deadline == 0, snap
    assert embs.shape == (EMBED_TEXTS, cfg.dims) and np.isfinite(embs).all()
    norms = np.linalg.norm(embs, axis=1)
    assert np.abs(norms - 1.0).max() <= 1e-3, ("norms", norms.min(), norms.max())
    if profile_dir:
        profile_embed(eng, texts, profile_dir)

    # -- 8.3 packed against the padded per-request path; a probe alone and
    # inside a full pack; the float32 gap (logged only)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 8)
    per = -(-EMBED_CHECK // len(EMBED_MIX))
    check = np.concatenate([
        rng.choice(np.flatnonzero(kinds == i), size=per, replace=False)
        for i in range(len(EMBED_MIX))])[:EMBED_CHECK]
    ref = np.stack(emb.embed_batch([texts[i] for i in check]))
    cos = (embs[check] * ref).sum(-1)
    by_kind = {m[0]: float(cos[kinds[check] == i].min())
               for i, m in enumerate(EMBED_MIX)}
    probe = tok.encode(texts[int(check[0])], max_len=packer.max_len)
    alone = packed(packer.pack([probe]))[0]
    titles = [tok.encode(texts[i], max_len=packer.max_len)
              for i in np.flatnonzero(kinds == 0)[1000:1512]]
    take, _, _ = packer.plan([len(probe)] + [len(s) for s in titles],
                             budget_tokens=8192, capacity=32)
    full = packer.pack([probe] + titles[:take - 1], capacity=32)
    inside = packed(full)[full.order.index(0)]
    probe_cos = float(np.dot(alone, inside))
    params32 = map_tree(lambda t: t.float(), params)
    emb32 = DeviceEmbedder(cfg=dataclasses.replace(cfg, dtype="float32"),
                           params=params32, tokenizer=tok, max_len=512,
                           device="cuda")
    ref32 = np.stack(emb32.embed_batch([texts[i] for i in check]))
    cos32 = (embs[check] * ref32).sum(-1)
    del emb32, params32
    torch.cuda.empty_cache()
    log(f"[phase8] packed vs per-request over {len(check)} texts: min cos "
        f"{cos.min():.6f} mean {cos.mean():.6f} (at least {EMBED_COS}) by kind "
        f"{json.dumps(by_kind)}; probe alone vs inside a {full.ids.shape} pack "
        f"of {full.n_segments} texts: cos {probe_cos:.6f}; float32 weights "
        f"(logged only): min cos {cos32.min():.6f} mean {cos32.mean():.6f}; "
        f"{time.perf_counter() - t0:.1f}s")
    assert cos.min() >= EMBED_COS, ("packed vs per-request", cos.min())
    assert full.n_segments > 1 and probe_cos >= EMBED_COS, (
        "segment leak", probe_cos)

    # -- 8.4 search what was embedded: the same engine embeds stored texts
    # again as queries; the service scans with the bf16 streaming kernel
    t0 = time.perf_counter()
    svc = SearchService(config=SearchConfig(batching_enabled=True),
                        device="cuda")
    svc.index_vectors([f"t{i}" for i in range(EMBED_TEXTS)], embs)
    corpus = svc.corpus()
    plan = S._streaming_plan(corpus.capacity, k)
    assert corpus.capacity >= S.STREAMING_MIN_ROWS and plan is not None, (
        "no streaming plan", corpus.capacity, plan)
    q_rows = rng.choice(EMBED_TEXTS, size=EMBED_QUERIES, replace=False)
    queries = np.stack(eng.embed_batch([texts[i] for i in q_rows]))
    log(f"[phase8] index + {EMBED_QUERIES} query embeddings "
        f"{time.perf_counter() - t0:.1f}s, capacity {corpus.capacity}, "
        f"streaming plan (tile_n, rows) {plan}")
    K.reset_launch_counts()
    d0 = corpus.sync_stats.device_dispatches
    srun = drive_service(svc, queries, k, lambda: None)
    launches = K.launch_counts()["streaming_topk_bf16"]
    dispatches = corpus.sync_stats.device_dispatches - d0
    with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(queries, dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    del dev, valid
    rec = recall(srun["results"], gt_ids)
    own_rank, own_gap = [], []
    for res, row in zip(srun["results"], q_rows):
        ids = [i for i, _ in res]
        own = f"t{row}"
        own_rank.append(ids.index(own) if own in ids else -1)
        own_gap.append(res[0][1] - res[ids.index(own)][1] if own in ids
                       else float("inf"))
    own_rank, own_gap = np.array(own_rank), np.array(own_gap)
    sample = embs[rng.choice(EMBED_TEXTS, size=1024, replace=False)]
    pair = sample @ sample.T
    mean_pair = float((pair.sum() - np.trace(pair)) / (1024 * 1023))
    log(f"[phase8] search: {EMBED_QUERIES} queries from 32 clients in "
        f"{srun['wall']:.3f}s qps={EMBED_QUERIES / srun['wall']:.1f} client "
        f"p50={np.median(srun['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(srun['lat'], 99) * 1e3:.2f}ms dispatches="
        f"{dispatches} recall@{k}={rec:.4f}; own text in its top-{k}: "
        f"{int((own_rank >= 0).sum())}/{EMBED_QUERIES}, rank 1 "
        f"{float((own_rank == 0).mean()):.4f}, largest gap to the best "
        f"{own_gap.max():.5f} (at most {OWN_SCORE_TOL}); mean pairwise cosine "
        f"of 1024 stored embeddings {mean_pair:.4f} (random weights)")
    log(f"[phase8] streaming_topk_bf16 launches in the search step: {launches}")
    assert rec >= 0.95, ("embedded corpus recall", rec)
    assert (own_rank >= 0).all() and own_gap.max() <= OWN_SCORE_TOL, (
        "own text", own_rank.min(), own_gap.max())
    assert launches > 0, "the search missed the bf16 streaming kernel"
    assert dispatches < EMBED_QUERIES, ("no fusion", dispatches)
    svc.shutdown()
    return {"texts": texts, "embs": embs, "engine": eng}


def build_graph(texts: list, embs: np.ndarray, seed: int):
    """Phase 10.1: a port MemoryEngine holding each phase-8 text as node
    ``t<i>`` (property ``content``, its phase-8 embedding) with
    RAG_EDGES[0]..RAG_EDGES[1] outgoing edges to seeded random nodes."""
    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

    storage = MemoryEngine()
    t0 = time.perf_counter()
    for i, text in enumerate(texts):
        storage.create_node(Node(id=f"t{i}", labels=["Doc"],
                                 properties={"content": text},
                                 embedding=embs[i]))
    t_nodes = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 10)
    deg = rng.integers(RAG_EDGES[0], RAG_EDGES[1] + 1, len(texts))
    src = np.repeat(np.arange(len(texts)), deg)
    dst = rng.integers(0, len(texts), src.size)
    t0 = time.perf_counter()
    for k, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        storage.create_edge(Edge(id=f"e{k}", start_node=f"t{a}",
                                 end_node=f"t{b}"))
    log(f"[phase10] storage: {storage.node_count()} nodes in {t_nodes:.1f}s, "
        f"{storage.edge_count()} edges in {time.perf_counter() - t0:.1f}s")
    return storage


class _Spans:
    """perf_counter spans of the search a client thread runs, taken by
    wrapping the service's stages in this script (the package has no
    timers): each wrapped stage adds its seconds, arguments and result to
    the thread's record while one is open."""

    def __init__(self):
        self.local = threading.local()

    def begin(self) -> dict:
        self.local.rec = {}
        return self.local.rec

    def end(self) -> None:
        self.local.rec = None

    def wrap(self, name: str, fn):
        local = self.local

        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            rec = getattr(local, "rec", None)
            if rec is not None:
                rec[name] = rec.get(name, 0.0) + time.perf_counter() - t
                rec[name + "_in"], rec[name + "_out"] = a, out
            return out

        return timed


class _SpanEmbedder:
    """The service's embedder with its ``embed`` timed."""

    def __init__(self, inner, spans: _Spans):
        self.inner = inner
        self.embed = spans.wrap("embed", inner.embed)

    def dimensions(self) -> int:
        return self.inner.dimensions()


class _Backoff:
    """How a client answers the embed engine's load shedding: a
    ResourceExhausted (the 429 of the HTTP edge) is retried after a backoff
    that doubles from 50 ms, at most BACKOFF_TRIES times. Counts the sheds,
    which the phase logs."""

    def __init__(self):
        self.sheds = 0
        self._mu = threading.Lock()

    def __call__(self, fn, *a, **kw):
        from nornicdb_tpu_torch.errors import ResourceExhausted

        delay = 0.05
        for _ in range(BACKOFF_TRIES - 1):
            try:
                return fn(*a, **kw)
            except ResourceExhausted:
                with self._mu:
                    self.sheds += 1
                time.sleep(delay)
                delay = min(2 * delay, 1.0)
        return fn(*a, **kw)


def recorded_search(svc, spans: _Spans, query: str) -> tuple:
    """``search(query)`` and the record of its stages' spans."""
    rec = spans.begin()
    return svc.search(query, limit=HYBRID_LIMIT), rec


def two_words(text: str) -> str:
    """A keyword-like query: the last two words of a stored text (its last
    word is unique to it)."""
    return " ".join(text.split()[-2:])


def _fused_head(rec: dict, query: str, cfg) -> list:
    """The ranking ``_rank`` must give for one search, computed here from
    the legs it recorded: fuse_rrf with the adaptive weights, cut to the
    service's head."""
    from nornicdb_tpu_torch.search.fusion import adaptive_rrf_weights, fuse_rrf

    ranked = {}
    if rec.get("vector_out") is not None:
        ranked["vector"] = [i for i, _ in rec["vector_out"]]
    if rec.get("bm25_out"):
        ranked["fulltext"] = [i for i, _ in rec["bm25_out"]]
    return fuse_rrf(ranked, adaptive_rrf_weights(query), cfg.rrf_k)


def drive_hybrid(svc, spans: _Spans, queries: list, storage, embedder,
                 seed: int, retry: _Backoff) -> dict:
    """Phase 10.3: HYBRID_CLIENTS closed-loop clients run ``search`` over
    ``queries`` while HYBRID_WRITERS threads make HYBRID_WRITES
    create/update/delete calls through the storage. Each acknowledged write
    is read back: after a create or an update a search for the written text
    returns the node (a search for the new text just before the update
    cached a ranking without it, so a stale cache would fail), after a
    delete it never does. Every call goes through ``retry``."""
    from nornicdb_tpu_torch.storage import Node

    n = len(queries)
    results: list = [None] * n
    recs: list = [None] * n
    lat = np.zeros(n)
    errors: list = []
    deleted: set = set()
    acks = {"writes": 0, "rank1": 0, "stale_guarded": 0}
    mu = threading.Lock()

    def client(t: int) -> None:
        try:
            for i in range(t, n, HYBRID_CLIENTS):
                t1 = time.perf_counter()
                results[i], recs[i] = retry(recorded_search, svc, spans,
                                            queries[i])
                lat[i] = time.perf_counter() - t1
                spans.end()
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    def written(w: int, c: int, v: int, wrng) -> str:
        return f"{wrng.choice(EMBED_WORDS)} wr{w}c{c}v{v} note{w}x{c}x{v}"

    def found(text: str) -> list:
        return [r["id"] for r in retry(svc.search, text, limit=HYBRID_LIMIT)]

    def writer(w: int) -> None:
        wrng = np.random.default_rng(seed + 100 + w)
        try:
            for c in range(HYBRID_WRITES // HYBRID_WRITERS // 4):
                nid = f"w{w}_{c}"
                text = written(w, c, 0, wrng)
                storage.create_node(Node(
                    id=nid, labels=["Note"], properties={"content": text},
                    embedding=retry(embedder.embed, text)))
                ids = found(text)
                assert nid in ids, ("created node not served", nid, ids)
                with mu:
                    acks["writes"] += 1
                    acks["rank1"] += ids[0] == nid
                for v in (1, 2):
                    new = written(w, c, v, wrng)
                    before = found(new)  # cached: a ranking without it
                    node = storage.get_node(nid)
                    node.properties["content"] = new
                    node.embedding = retry(embedder.embed, new)
                    storage.update_node(node)
                    ids = found(new)
                    assert nid in ids, ("updated node not served", nid, ids)
                    text = new
                    with mu:
                        acks["writes"] += 1
                        acks["rank1"] += ids[0] == nid
                        acks["stale_guarded"] += nid not in before
                with mu:
                    deleted.add(nid)
                storage.delete_node(nid)
                ids = found(text)
                assert nid not in ids, ("deleted node served", nid)
                with mu:
                    acks["writes"] += 1
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = ([threading.Thread(target=client, args=(t,))
                for t in range(HYBRID_CLIENTS)]
               + [threading.Thread(target=writer, args=(w,))
                  for w in range(HYBRID_WRITERS)])
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads[:HYBRID_CLIENTS]:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    for th in threads[HYBRID_CLIENTS:]:
        th.join(timeout=600)
    wall_writes = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "hybrid thread hung"
    assert acks["writes"] == HYBRID_WRITES, acks
    return dict(results=results, recs=recs, lat=lat, wall=wall,
                wall_writes=wall_writes, deleted=deleted, acks=acks)


def in_threads(fn, items: list, n_threads: int = 16) -> None:
    """``fn`` over ``items`` from ``n_threads`` threads; errors re-raised."""
    errors: list = []

    def worker(t: int) -> None:
        try:
            for item in items[t::n_threads]:
                fn(item)
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads), "thread hung"


def wait_drained(corpus, timeout: float = 30.0) -> None:
    """Until the write-behind uploader has patched every dirty block."""
    deadline = time.perf_counter() + timeout
    while corpus._dirty_blocks or corpus._full_dirty:
        assert time.perf_counter() < deadline, "uploader did not drain"
        time.sleep(0.002)


def phase_hybrid(K, seed: int, served: dict) -> dict:
    """Phase 10: hybrid search over phase 8's corpus in a port MemoryEngine
    (graph of build_graph): a SearchService(storage, embedder=phase 8's
    engine behind a CachedEmbedder, the ``cli serve`` stack) attached and
    indexed by build_indexes, with write-behind and batching on and
    candidates_multiplier 4; the writers embed their texts through the same
    cached embedder, as the EmbedWorker would. Then the traffic of
    drive_hybrid, and the checks of fusion, vector-leg recall, own nodes,
    the rank cache, the cross-encoder rerank and MMR. Returns the storage
    and the service (phase 9 retrieves through them) and #2's launches in
    the traffic."""
    import dataclasses as dc

    import torch

    from nornicdb_tpu_torch._device import map_tree
    from nornicdb_tpu_torch.embed import CachedEmbedder
    from nornicdb_tpu_torch.models import bge_m3 as B
    from nornicdb_tpu_torch.search import SearchConfig, SearchService
    from nornicdb_tpu_torch.search import service as SV
    from nornicdb_tpu_torch.search.fusion import apply_mmr
    from nornicdb_tpu_torch.search.rerank import CrossEncoderReranker
    from nornicdb_tpu_torch.storage import Node

    texts, embs = served["texts"], served["embs"]
    eng = CachedEmbedder(served["engine"])
    torch.cuda.reset_peak_memory_stats()
    storage = build_graph(texts, embs, seed)

    # -- 10.2 the service, attached and indexed from storage
    cfg = SearchConfig(candidates_multiplier=4, write_behind=True,
                       batching_enabled=True)
    svc = SearchService(storage, embedder=eng, config=cfg, device="cuda")
    svc.attach(storage)
    spans = _Spans()
    retry = _Backoff()
    sheds0 = served["engine"].stats.sheds_deadline
    bm25_index = svc._bm25.index
    bm25_s = [0.0]

    def timed_index(doc_id, text):
        t = time.perf_counter()
        bm25_index(doc_id, text)
        bm25_s[0] += time.perf_counter() - t

    svc._bm25.index = timed_index
    t0 = time.perf_counter()
    n_indexed = svc.build_indexes()
    t_build = time.perf_counter() - t0
    corpus = svc.corpus()
    wait_drained(corpus)
    t_drain = time.perf_counter() - t0 - t_build
    svc._bm25.index = bm25_index
    sync0 = corpus.sync_stats.as_dict()
    log(f"[phase10] build_indexes {n_indexed} nodes in {t_build:.2f}s (BM25 "
        f"index {bm25_s[0]:.2f}s, fingerprints + corpus adds + locks "
        f"{t_build - bm25_s[0]:.2f}s), uploader drained {t_drain:.3f}s "
        f"later; BM25 docs {len(svc._bm25)}, corpus rows {len(corpus)} "
        f"capacity {corpus.capacity}; sync {json.dumps(sync0)}")
    assert n_indexed == len(texts) == len(svc._bm25) == len(corpus)
    assert corpus._uploader is not None and sync0["uploader_runs"] > 0

    # -- 10.3 the traffic: half stored texts, half their last two words
    rng = np.random.default_rng(seed + 11)
    n_q = HYBRID_CLIENTS * HYBRID_PER_CLIENT
    rows = rng.choice(len(texts), size=n_q + HYBRID_RERANK + HYBRID_MMR,
                      replace=False)
    q_rows = rows[:n_q]
    queries = [texts[r] if i % 2 == 0 else two_words(texts[r])
               for i, r in enumerate(q_rows)]
    svc.embedder = _SpanEmbedder(eng, spans)
    svc.vector_candidates = spans.wrap("vector", svc.vector_candidates)
    svc._bm25.search = spans.wrap("bm25", svc._bm25.search)
    svc._enrich = spans.wrap("enrich", svc._enrich)
    svc._rank = spans.wrap("rank", svc._rank)
    fuse = SV.fuse_rrf
    SV.fuse_rrf = spans.wrap("fusion", fuse)
    try:
        K.reset_launch_counts()
        s0 = dc.replace(corpus.sync_stats)
        run = drive_hybrid(svc, spans, queries, storage, eng, seed, retry)
        launches = K.launch_counts()["streaming_topk_bf16"]
        s1 = dc.replace(corpus.sync_stats)
        wait_drained(corpus)
        deleted = run["deleted"]

        # fusion: each ranking is fuse_rrf of its two legs
        ranked, hits_in_traffic = 0, 0
        for q, res, rec in zip(queries, run["results"], run["recs"]):
            if "rank" not in rec:
                hits_in_traffic += 1
                continue
            ranked += 1
            head = _fused_head(rec, q, cfg)[:max(HYBRID_LIMIT,
                                                 cfg.rerank_candidates)]
            got_ids = {r["id"] for r in res}
            want = [(i, sc) for i, sc in head
                    if i in got_ids or i not in deleted][:HYBRID_LIMIT]
            assert [(r["id"], r["score"]) for r in res] == want, (
                "fusion", q)
        # the vector leg against an exact float32 scan of the same rows
        legs = [(rec["vector_in"][0], rec["vector_out"])
                for rec in run["recs"] if "rank" in rec]
        qv = np.stack([np.asarray(e, np.float32) for e, _ in legs])
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
        n_cand = HYBRID_LIMIT * cfg.candidates_multiplier
        with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
            gt = ground_truth(qv, dev, valid, n_cand)
            gt_ids = [{slot_ids[s] for s in g} for g in gt]
        del dev, valid
        rec_leg = recall([leg for _, leg in legs], gt_ids)
        writer_hits = sum(1 for _, leg in legs for i, _ in leg
                          if i.startswith("w"))
        # own node: rank 1 and top-10 shares by half
        own = np.array([[r["id"] for r in res].index(f"t{row}")
                        if f"t{row}" in [r["id"] for r in res] else -1
                        for res, row in zip(run["results"], q_rows)])
        top_stored = float((own[0::2] >= 0).mean())
        top_words = float((own[1::2] >= 0).mean())
        # the share of a search in each stage
        span = {k: sum(rec.get(k, 0.0) for rec in run["recs"])
                for k in ("embed", "vector", "bm25", "fusion", "enrich")}
        total = float(run["lat"].sum())
        lat = run["lat"]
        embed_ms = np.array([rec.get("embed", 0.0) for rec in run["recs"]
                             if "rank" in rec]) * 1e3
        log(f"[phase10] {n_q} searches from {HYBRID_CLIENTS} clients in "
            f"{run['wall']:.3f}s qps={n_q / run['wall']:.1f} client "
            f"p50={np.median(lat) * 1e3:.2f}ms "
            f"p99={np.percentile(lat, 99) * 1e3:.2f}ms "
            f"(stored-text half p50 {np.median(lat[0::2]) * 1e3:.2f}ms, "
            f"two-word half {np.median(lat[1::2]) * 1e3:.2f}ms); "
            f"{HYBRID_WRITES} writes from {HYBRID_WRITERS} writers done at "
            f"{run['wall_writes']:.3f}s, {run['acks']['rank1']} of "
            f"{HYBRID_WRITES * 3 // 4} written texts served their node first, "
            f"{run['acks']['stale_guarded']} updates read back through a "
            f"cached ranking made before them; share of search time: "
            + ", ".join(f"{k} {v / total:.4f}" for k, v in span.items())
            + f", other {1 - sum(span.values()) / total:.4f} (of "
            f"{total:.3f}s summed over the searches); the embed span p50 "
            f"{np.median(embed_ms):.2f}ms p99 {np.percentile(embed_ms, 99):.2f}"
            f"ms max {embed_ms.max():.2f}ms (the engine sheds past "
            f"{served['engine'].config.deadline_ms:.0f}ms: "
            f"{served['engine'].stats.sheds_deadline - sheds0} embed sheds, "
            f"{retry.sheds} calls retried)")
        log(f"[phase10] fusion equal to fuse_rrf of the legs on {ranked} "
            f"ranked searches ({hits_in_traffic} cache hits); vector leg "
            f"recall@{n_cand}={rec_leg:.4f} against an exact float32 scan "
            f"({writer_hits} writer nodes in the legs); own node first "
            f"{float((own[0::2] == 0).mean()):.4f} / "
            f"{float((own[1::2] == 0).mean()):.4f}, in the top "
            f"{HYBRID_LIMIT} {top_stored:.4f} / {top_words:.4f} (stored text / "
            f"two words); uploader runs "
            f"{s1.uploader_runs - s0.uploader_runs} patches "
            f"{s1.patches - s0.patches} full uploads "
            f"{s1.full_uploads - s0.full_uploads} errors "
            f"{s1.uploader_errors}, query stall "
            f"{(s1.query_stall_s - s0.query_stall_s) * 1e3:.2f}ms")
        log(f"[phase10] streaming_topk_bf16 launches in the traffic: "
            f"{launches}")
        assert ranked + hits_in_traffic == n_q
        assert rec_leg >= 0.95, ("vector leg recall", rec_leg)
        assert top_stored >= 0.99, ("own node", top_stored)
        assert launches > 0, "the vector leg missed the bf16 kernel"
        assert s1.uploader_errors == 0

        # -- 10.4 the rank cache: repeats hit, a text change misses, a
        # recall's touches change nothing
        t0 = time.perf_counter()
        x_text = "cache probe node uniqx"
        storage.create_node(Node(id="x0", properties={"content": x_text},
                                 embedding=retry(eng.embed, x_text)))
        repeat = queries[1::2][:HYBRID_REPEATS]  # two-word queries
        in_threads(lambda q: retry(svc.search, q, limit=HYBRID_LIMIT), repeat)
        searches0 = svc.stats.searches
        rank_calls: list = []
        rank = svc._rank

        def counted_rank(*a, **kw):
            out = rank(*a, **kw)
            rank_calls.append(a[0])
            return out

        svc._rank = counted_rank
        K.reset_launch_counts()
        hit_lat = []
        for q in repeat:
            t1 = time.perf_counter()
            svc.search(q, limit=HYBRID_LIMIT)
            hit_lat.append(time.perf_counter() - t1)
        hit_launches = K.launch_counts()["streaming_topk_bf16"]
        assert not rank_calls and hit_launches == 0, (
            "repeats not served from the cache", len(rank_calls),
            hit_launches)
        node = storage.get_node("x0")
        node.properties["content"] = x_text + " changed"
        storage.update_node(node)
        in_threads(lambda q: retry(svc.search, q, limit=HYBRID_LIMIT), repeat)
        assert len(rank_calls) == HYBRID_REPEATS, (
            "an update left cached rankings alive", len(rank_calls))
        wait_drained(corpus)
        gen, epoch = svc._generation, corpus.stats()["epoch"]
        touched = retry(svc.search, queries[0], limit=HYBRID_LIMIT)
        for r in touched:  # DB.recall's touch
            node = storage.get_node(r["id"])
            node.access_count += 1
            node.last_accessed = time.time()
            storage.update_node(node)
        n_rank = len(rank_calls)
        svc.search(queries[0], limit=HYBRID_LIMIT)
        assert svc._generation == gen and corpus.stats()["epoch"] == epoch
        assert not corpus._dirty_blocks and len(rank_calls) == n_rank, (
            "a touch dirtied the index")
        log(f"[phase10] rank cache: {HYBRID_REPEATS} repeats all hits "
            f"(0 ranks, 0 launches of #2), hit p50 "
            f"{np.median(hit_lat) * 1e3:.3f}ms; one update_node of a text: "
            f"all {HYBRID_REPEATS} repeats ranked again; {len(touched)} "
            f"touches (access count) left generation {gen}, corpus epoch "
            f"{epoch} and the dirty blocks as they were; "
            f"{svc.stats.searches - searches0} searches, "
            f"{time.perf_counter() - t0:.1f}s")
        svc._rank = rank

        # -- 10.5 the cross-encoder at bge-m3's width, against float32
        t0 = time.perf_counter()
        rr = CrossEncoderReranker(cfg=B.BGE_M3, seed=seed + 10,
                                  device="cuda")
        rr.score_pairs(texts[0], texts[1:1 + cfg.rerank_candidates])  # warm
        sync()
        t_init = time.perf_counter() - t0
        rr_log: list = []
        rerank = rr.rerank

        def recorded_rerank(query, candidates, limit=0):
            t1 = time.perf_counter()
            out = rerank(query, candidates, limit)
            rr_log.append((query, candidates, out,
                           time.perf_counter() - t1))
            return out

        rr.rerank = recorded_rerank
        svc.set_reranker(rr)
        svc.config.rerank_enabled = True
        rr_rows = rows[n_q:n_q + HYBRID_RERANK]
        rr_res = [retry(svc.search, two_words(texts[r]), limit=HYBRID_LIMIT)
                  for r in rr_rows]
        svc.config.rerank_enabled = False
        assert len(rr_log) == HYBRID_RERANK
        params32 = map_tree(lambda t: t.float(), rr.params)
        ref = CrossEncoderReranker(cfg=dc.replace(B.BGE_M3, dtype="float32"),
                                   params=params32, head=rr.head,
                                   tokenizer=rr.tokenizer,
                                   max_len=rr.max_len, device="cuda")
        err = 0.0
        widths = []
        for (q, cands, out, _), res in zip(rr_log, rr_res):
            assert len(cands) == cfg.rerank_candidates
            scores = [sc for _, sc in out]
            assert scores == sorted(scores, reverse=True)
            assert [r["id"] for r in res] == [i for i, _ in out][
                :HYBRID_LIMIT], ("reranked head", q)
            want = ref.score_pairs(q, [t for _, t in cands])
            got = dict(out)
            err = max(err, max(abs(got[c[0]] - float(w))
                               for c, w in zip(cands, want)))
            widths.append(len(rr.tokenizer.encode_batch(
                [f"{q} [SEP] {t}" for _, t in cands],
                max_len=rr.max_len)[0][0]))
        del ref, params32
        torch.cuda.empty_cache()
        rr_ms = np.array([dt for *_, dt in rr_log]) * 1e3
        log(f"[phase10] rerank: BGE_M3 cross-encoder (bf16, seed "
            f"{seed + 10}) built and warmed in {t_init:.2f}s; "
            f"{HYBRID_RERANK} searches with {cfg.rerank_candidates} "
            f"candidates, forward p50 {np.median(rr_ms):.2f}ms p99 "
            f"{np.percentile(rr_ms, 99):.2f}ms at (20, {int(np.min(widths))}"
            f"-{int(np.max(widths))}) tokens; the head ordered by its "
            f"scores; max |bf16 - float32| {err:.6f} (at most {RERANK_TOL})")
        assert err <= RERANK_TOL, ("rerank vs float32", err)

        # -- 10.6 MMR against the host apply_mmr on the same inputs
        svc.config.mmr_enabled = True
        mmr_rows = rows[n_q + HYBRID_RERANK:]
        changed = 0
        for r in mmr_rows:
            q = two_words(texts[r])
            res, rec = retry(recorded_search, svc, spans, q)
            spans.end()
            fused = _fused_head(rec, q, cfg)
            order = [i for i, _ in fused]
            vecs = {}
            for i in order:
                e = np.asarray(storage.get_node(i).embedding, np.float32)
                vecs[i] = e / np.linalg.norm(e)
            want = apply_mmr(order, dict(fused), vecs, HYBRID_LIMIT,
                             cfg.mmr_lambda)
            assert [x["id"] for x in res] == want, ("mmr", r)
            changed += want != order[:HYBRID_LIMIT]
        svc.config.mmr_enabled = False
        log(f"[phase10] MMR (lambda {cfg.mmr_lambda}): {HYBRID_MMR} "
            f"searches equal to the host apply_mmr over storage's vectors, "
            f"{changed} of them reordered against plain fusion; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f}GiB")
    finally:
        SV.fuse_rrf = fuse
        svc.embedder = eng
        for name in ("vector_candidates", "_enrich", "_rank"):
            svc.__dict__.pop(name, None)
        svc._bm25.__dict__.pop("search", None)
        svc.set_reranker(None)
    return {"storage": storage, "service": svc,
            "streaming_topk_bf16": launches}


class _RagDB:
    """The JAX package's ``DB`` as ``GraphRAGService`` reads it, over phase
    10's storage and hybrid service: ``recall`` is ``DB.recall`` (a hybrid
    ``search``, then a touch of each hit: its access count through
    ``storage.update_node``), ``genserve_engine()`` the engine behind the
    generator."""

    def __init__(self, storage, service, gen_engine):
        self.storage, self.service, self._engine = storage, service, gen_engine

    def recall(self, question: str, limit: int = 10) -> list:
        results = self.service.search(question, limit=limit)
        for r in results:
            node = self.storage.get_node(r["id"])
            node.access_count += 1
            node.last_accessed = time.time()
            self.storage.update_node(node)
        return results

    def genserve_engine(self):
        return self._engine


def write_checkpoint(d: str, cfg, params, tok) -> None:
    """An assistant checkpoint directory as the JAX package's
    ``train_assistant`` writes it: config.json, model.safetensors,
    vocab.json."""
    from nornicdb_tpu_torch.models import weights

    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"kind": "qwen2", "vocab_size": cfg.vocab_size,
                   "hidden": cfg.hidden, "layers": cfg.layers,
                   "heads": cfg.heads, "kv_heads": cfg.kv_heads,
                   "intermediate": cfg.intermediate,
                   "max_positions": cfg.max_positions,
                   "rope_theta": cfg.rope_theta, "trained_seq_len": 0}, f)
    weights.save_params(os.path.join(d, "model.safetensors"), params)
    tok.save(os.path.join(d, "vocab.json"))


def mount_checkpoint(seed: int, texts: list):
    """Phase 9.1: a QWEN25_05B checkpoint (weights from ``seed``, a
    VocabTokenizer over ``texts`` and the GraphRAG prompt header) written
    to a temporary directory and mounted with ``load_generator``: every
    tensor bit for bit. Returns the QwenGenerator."""
    import tempfile

    import torch

    from nornicdb_tpu_torch.genserve.graphrag import _PROMPT_HEADER
    from nornicdb_tpu_torch.models import qwen2 as Q
    from nornicdb_tpu_torch.models import weights
    from nornicdb_tpu_torch.models.pretrain import VocabTokenizer, load_generator

    cfg = Q.QWEN25_05B
    params = Q.init_params(cfg, seed, "cuda")
    t0 = time.perf_counter()
    tok = VocabTokenizer.from_corpus(texts + [_PROMPT_HEADER],
                                     max_vocab=cfg.vocab_size)
    t_vocab = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_checkpoint(d, cfg, params, tok)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "model.safetensors"))
        t0 = time.perf_counter()
        gen = load_generator(d)
        sync()
        t_load = time.perf_counter() - t0
    saved, loaded = weights.flatten_params(params), weights.flatten_params(
        gen.params)
    assert list(loaded) == list(saved), "checkpoint names"
    for name, want in saved.items():
        got = loaded[name]
        assert got.dtype == want.dtype and got.is_cuda, name
        if want.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want), ("not bit for bit", name)
    del params, saved, loaded
    log(f"[phase9] checkpoint: vocabulary {tok.vocab_size} words in "
        f"{t_vocab:.1f}s; model.safetensors {size / 1e9:.3f} GB written in "
        f"{t_write:.2f}s (with config.json and vocab.json), load_generator "
        f"{t_load:.2f}s, {len(weights.flatten_params(gen.params))} tensors "
        "bit for bit")
    return gen


def phase_rag(K, seed: int, served: dict, hybrid: dict) -> dict:
    """Phase 9: the checkpoint of ``mount_checkpoint`` served through an
    ``EngineGenerator`` over a ``GenerationEngine``; ``GraphRAGService``
    answers RAG_QUESTIONS stored phase-8 texts from RAG_CLIENTS clients,
    retrieving through phase 10's storage and hybrid service (which embeds
    with phase 8's engine). Returns the launches of #2 and #5 in the
    traffic."""
    import torch

    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.genserve import GenerationEngine, GraphRAGService
    from nornicdb_tpu_torch.heimdall import EngineGenerator
    from nornicdb_tpu_torch.models import qwen2 as Q

    texts = served["texts"]
    gen = mount_checkpoint(seed, texts)
    cfg, tok = gen.cfg, gen.tokenizer
    # -- 9.2 the engine behind Heimdall's generator, and the graph
    gcfg = GenServeConfig(max_seq_tokens=RAG_SEQ_TOKENS,
                          pool_pages=8 * RAG_SEQ_TOKENS // 16 + 1)
    egen = EngineGenerator(GenerationEngine(gen.params, gen.cfg,
                                            tokenizer=gen.tokenizer,
                                            config=gcfg))
    eng = egen.engine
    try:
        t0 = time.perf_counter()
        eng.warmup()
        sync()
        t_warm = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 9)
        storage, svc = hybrid["storage"], hybrid["service"]
        db = _RagDB(storage, svc, eng)
        rag = GraphRAGService(db, config=gcfg)
        log(f"[phase9] engine warmup {t_warm:.1f}s; graph "
            f"{storage.edge_count()} edges over {storage.node_count()} "
            f"nodes (phase 10's storage)")
        # the prompts the service submits, with their handles, for the dense
        # check below
        submitted: list = []
        mu = threading.Lock()
        submit = eng.submit

        def recording_submit(prompt_ids, max_new_tokens=64,
                             deadline_ms=None):
            h = submit(prompt_ids, max_new_tokens, deadline_ms)
            with mu:
                submitted.append((list(prompt_ids), max_new_tokens, h))
            return h

        eng.submit = recording_submit

        # -- 9.3 the traffic
        rows = rng.choice(len(texts), size=RAG_QUESTIONS, replace=False)
        answers: list = [None] * RAG_QUESTIONS
        lat = np.zeros(RAG_QUESTIONS)
        errors: list = []

        def client(t: int) -> None:
            try:
                for i in range(t, RAG_QUESTIONS, RAG_CLIENTS):
                    t1 = time.perf_counter()
                    answers[i] = rag.answer(texts[rows[i]])
                    lat[i] = time.perf_counter() - t1
            except Exception as e:  # re-raised on the main thread
                errors.append(e)

        torch.cuda.reset_peak_memory_stats()
        gen0 = svc._generation
        epoch0 = svc.corpus().stats()["epoch"]
        K.reset_launch_counts()
        st0 = dataclasses.replace(eng.stats)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(RAG_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if errors:
            raise errors[0]
        assert not any(th.is_alive() for th in threads), "client thread hung"
        st = eng.stats
        gen_tokens = sum(a["generated_tokens"] for a in answers)
        reused = [a["prefix_reused_tokens"] for a in answers]
        retrieve = [a["timings_ms"]["retrieve"] for a in answers]
        prompt_len = [len(p) for p, _, _ in submitted]
        log(f"[phase9] {RAG_QUESTIONS} GraphRAG answers from {RAG_CLIENTS} "
            f"clients in {wall:.3f}s: answer p50={np.median(lat) * 1e3:.1f}ms "
            f"p99={np.percentile(lat, 99) * 1e3:.1f}ms retrieve "
            f"p50={np.median(retrieve):.2f}ms; {gen_tokens} tokens "
            f"tok/s={gen_tokens / wall:.1f}; prompt tokens min/p50/max "
            f"{min(prompt_len)}/{int(np.median(prompt_len))}/"
            f"{max(prompt_len)}; "
            f"prefix hits={st.prefix_hits - st0.prefix_hits} reused tokens by "
            f"answer {reused}; fused steps={st.fused_steps - st0.fused_steps} "
            f"evictions={st.evictions - st0.evictions} max_memory_allocated="
            f"{peak / 2**30:.3f}GiB")
        log(f"[phase9] launches in the traffic: streaming_topk_bf16="
            f"{counts['streaming_topk_bf16']} ragged_paged_attention="
            f"{counts['ragged_paged_attention']}; retrieve p99="
            f"{np.percentile(retrieve, 99):.2f}ms; the recalls' touches left "
            f"the search generation ({svc._generation}) and corpus epoch "
            f"as they were")
        assert svc._generation == gen0, "a recall's touch re-indexed"
        assert svc.corpus().stats()["epoch"] == epoch0
        assert len(submitted) == RAG_QUESTIONS
        for i, a in enumerate(answers):
            assert a["mode"] == "paged", a["mode"]
            assert f"t{rows[i]}" in [src["id"] for src in a["sources"]], (
                "own node not retrieved", i)
            assert 1 <= a["generated_tokens"] <= gcfg.rag_max_new_tokens, a
            if i >= RAG_CLIENTS:  # after the first wave: header cached
                assert a["prefix_reused_tokens"] > 0, ("no prefix reuse", i)
        assert counts["streaming_topk_bf16"] > 0, "retrieval missed #2"
        assert counts["ragged_paged_attention"] > 0, "generation missed #5"

        # -- 9.4 tokens of the first answers against the dense path, and a QC
        # batch through the generator
        t0 = time.perf_counter()
        limit = gcfg.max_seq_tokens
        width = Q.pages_for(limit, gcfg.page_size) * gcfg.page_size
        equal = n_tok = 0
        for prompt, max_new, h in submitted[:RAG_CHECKED]:
            prompt = prompt[-(limit - 1):]  # the engine's own bound
            max_new = max(1, min(int(max_new), limit - len(prompt)))
            same, _ = dense_agreement(Q, gen.params, cfg, prompt, h.tokens,
                                      max_new, tok.eos_id, width)
            equal += same
            n_tok += len(h.tokens)
        qc = egen.generate_many([texts[r] for r in rows[:8]], max_tokens=16)
        log(f"[phase9] dense reference: {n_tok} tokens of {RAG_CHECKED} "
            f"answers checked, {equal} equal to its argmax; QC batch of {len(qc)} "
            f"through EngineGenerator; {time.perf_counter() - t0:.1f}s")
        assert len(qc) == 8 and eng.stats.completed == (
            st0.completed + RAG_QUESTIONS + 8), eng.stats.as_dict()
        return {"streaming_topk_bf16": counts["streaming_topk_bf16"],
                "ragged_paged_attention": counts["ragged_paged_attention"]}
    finally:
        eng.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after phase 2, trace 16 batches of 16 queries, "
                    "after phase 5 eight generation requests, and in phase 8 "
                    "about 32 embed packs, with torch.profiler (device busy "
                    "share, per-op tables)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import nornicdb_tpu_torch

        # the port under test is the checkout's, never an installed copy
        if os.path.dirname(os.path.dirname(
                os.path.abspath(nornicdb_tpu_torch.__file__))) != here:
            raise ImportError(f"found {nornicdb_tpu_torch.__file__} instead")
        from nornicdb_tpu_torch.ops import _build
        from nornicdb_tpu_torch.ops import kernels as K
        from nornicdb_tpu_torch.ops import kernels_ref as R
        from nornicdb_tpu_torch.ops import similarity as S
        from nornicdb_tpu_torch.search import SearchConfig, SearchService
        from nornicdb_tpu_torch.storage import Node
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")
    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[card] {smi}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    # -- build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s " + json.dumps(secs))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        for name, rep in _build.ptxas_reports.items():
            f.write(f"== {name}\n{rep}\n")
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas] {name}: {line.strip()}")

    # -- data
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    data = make_data(rng, N, DIMS)
    ids = [f"v{i}" for i in range(N)]
    q_rows = rng.choice(N, size=1024 + 256, replace=False)
    qs_kern = make_queries(rng, data, q_rows[:1024])
    serve_rows = q_rows[1024:]
    qs_serve = make_queries(rng, data, serve_rows)
    log(f"[data] {N}x{DIMS} in {time.perf_counter() - t0:.1f}s")
    k = K_TOP
    sample = np.arange(0, len(qs_serve), 8)  # 32 queries scored for recall

    # -- phase 2 setup: service + bulk load (+ first full upload)
    svc = SearchService(config=SearchConfig(batching_enabled=True), device=device)
    batch_log: list[tuple[float, float, int]] = []  # (start, end, queries)
    inner = svc._batched_corpus_search

    def timed_batch(queries, kk, min_sim):
        t = time.perf_counter()
        try:
            return inner(queries, kk, min_sim)
        finally:
            batch_log.append((t, time.perf_counter(), len(queries)))

    svc._batched_corpus_search = timed_batch
    t0 = time.perf_counter()
    svc.index_vectors(ids, data)
    corpus = svc.corpus()
    with corpus._borrow_device() as (dev, valid, _, _, _):
        sync()
    log(f"[load] add_batch + upload {time.perf_counter() - t0:.1f}s, "
        f"capacity {corpus.capacity}, sync {corpus.sync_stats.as_dict()}")

    # -- phase 1: kernels vs plain versions at the serving shapes
    t0 = time.perf_counter()
    with corpus._borrow_device() as (dev, valid, _, _, _):
        c_i8, c_scale = K.quantize_rows(dev)
        entries = phase_kernels(K, R, dev, valid, c_i8, c_scale, qs_kern, k,
                                REPS)
        del c_i8, c_scale
    log(f"[phase1] kernels vs plain: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_int8_10m(K, R, args.seed, k, REPS)
    log(f"[phase1] int8 kernel at 10M rows: {time.perf_counter() - t0:.1f}s")

    # -- phase 2: the serving path (batched vector_candidates + writes).
    # Removed: the own rows of queries outside the recall sample, each in
    # its query's true top-k, so a leak would show.
    removed = {f"v{r}" for r in serve_rows[1::8]}
    for rid in removed:
        svc.remove_node(rid)

    extra = rng.standard_normal((48, DIMS), dtype=np.float32)

    def writes() -> None:
        # random rows score ~0 against every query: never in a top-k
        for i in range(48):
            svc.index_node(Node(id=f"new{i}", embedding=extra[i]))
            if i % 8 == 7:
                svc.remove_node(f"new{i - 4}")
            time.sleep(0.002)

    K.reset_launch_counts()
    d0 = corpus.sync_stats.device_dispatches
    p0 = corpus.sync_stats.patches
    run = drive_service(svc, qs_serve, k, writes)
    counts2 = K.launch_counts()
    dispatches = corpus.sync_stats.device_dispatches - d0
    patches = corpus.sync_stats.patches - p0
    bstats = svc.ensure_batcher().stats.as_dict()
    served = [r for r in run["results"]]
    leaked = {i for res in served for i, _ in res} & removed
    with corpus._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(qs_serve[sample], dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    rec2 = recall([served[i] for i in sample], gt_ids)
    batch_ms = [(b - a) * 1e3 for a, b, _ in batch_log]
    phase2 = {"qps": len(qs_serve) / run["wall"],
              "p50": np.median(run["lat"]) * 1e3,
              "p99": np.percentile(run["lat"], 99) * 1e3}
    log(f"[phase2] {len(qs_serve)} queries in {run['wall']:.3f}s "
        f"qps={len(qs_serve) / run['wall']:.1f} "
        f"client p50={np.median(run['lat']) * 1e3:.2f}ms "
        f"p99={np.percentile(run['lat'], 99) * 1e3:.2f}ms "
        f"batch p50={np.median(batch_ms):.2f}ms "
        f"dispatches={dispatches} patches={patches} batcher={bstats} "
        f"launches={counts2} recall@{k}={rec2:.4f}")
    log_timeline(run, batch_log, out_dir)
    assert counts2["streaming_topk_bf16"] > 0, (
        "serving path missed the bf16 kernel")
    assert dispatches < len(qs_serve), ("no fusion", dispatches)
    assert patches >= 1, "dirty-block patch sync never ran"
    assert not leaked, ("removed ids served", leaked)
    assert rec2 >= 0.95, ("serving recall", rec2)
    if args.profile:
        profile_search(corpus, qs_serve, k, 16, out_dir)
    svc.shutdown()
    # `inner` is a bound method of the service: while it lives, so do the
    # service and its 3.8 GiB corpus buffer
    del svc, corpus, dev, valid, inner, timed_batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 3: int8-mirrored corpus
    t0 = time.perf_counter()
    qc = S.DeviceCorpus(dims=DIMS, quantize=True, device=device)
    qc.add_batch(ids, data)
    qc.search(qs_serve[:1], k=k)  # first sync: upload + quantize
    log(f"[phase3] int8 corpus load {time.perf_counter() - t0:.1f}s")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res3 = []
    for i in range(0, len(qs_serve), 32):
        res3 += qc.search(qs_serve[i:i + 32], k=k)
    wall3 = time.perf_counter() - t0
    counts3 = K.launch_counts()
    with qc._borrow_device() as (dev, valid, _, slot_ids, _):
        gt = ground_truth(qs_serve[sample], dev, valid, k)
        gt_ids = [{slot_ids[s] for s in g} for g in gt]
    rec3 = recall([res3[i] for i in sample], gt_ids)
    log(f"[phase3] {len(qs_serve)} queries in batches of 32: {wall3:.3f}s "
        f"qps={len(qs_serve) / wall3:.1f} launches={counts3} recall@{k}={rec3:.4f}")
    assert counts3["streaming_topk_int8"] > 0, (
        "int8 path missed the int8 kernel")
    assert rec3 >= 0.95, ("int8 recall", rec3)

    # -- phase 4: extract-kernel epilogue == sort epilogue
    S.TOPK_EPILOGUE = "sort"
    ref4 = qc.search(qs_serve[:32], k=k)
    K.reset_launch_counts()
    S.TOPK_EPILOGUE = "pallas"
    t0 = time.perf_counter()
    got4 = qc.search(qs_serve[:32], k=k)
    wall4 = time.perf_counter() - t0
    counts4 = K.launch_counts()
    S.TOPK_EPILOGUE = "sort"
    log(f"[phase4] extract epilogue batch of 32: {wall4 * 1e3:.2f}ms launches={counts4}")
    assert counts4["extract_topk"] > 0, (
        "extract epilogue never launched")
    assert got4 == ref4, "extract epilogue differs from sort"
    del qc, dev, valid
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 5: generation serving
    t0 = time.perf_counter()
    entries5, counts5 = phase_generation(
        K, R, args.seed, out_dir if args.profile else "")
    entries += entries5
    log(f"[phase5] {time.perf_counter() - t0:.1f}s")

    # -- phases 6 and 7 over a second service on the same vectors
    t0 = time.perf_counter()
    svc = SearchService(config=SearchConfig(batching_enabled=True), device=device)
    svc.index_vectors(ids, data)
    del data
    gc.collect()
    corpus = svc.corpus()
    with corpus._borrow_device() as (dev, valid, _, _, _):
        sync()
    log(f"[phase7] load + upload {time.perf_counter() - t0:.1f}s, capacity "
        f"{corpus.capacity}")
    t0 = time.perf_counter()
    with corpus._borrow_device() as (dev, valid, _, _, _):
        entries6, counts6 = phase_fused_cosine(K, R, dev, valid, qs_kern, k,
                                               REPS)
    del dev, valid
    entries = entries6 + entries
    log(f"[phase6] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_ivf(svc, corpus, qs_serve, k, phase2)
    svc.shutdown()
    del svc, corpus
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase7] {time.perf_counter() - t0:.1f}s")

    # -- phase 8: embed serving at full width, then search over it
    t0 = time.perf_counter()
    served = phase_embed(K, args.seed, k, out_dir if args.profile else "")
    log(f"[phase8] {time.perf_counter() - t0:.1f}s")

    # -- phase 10: hybrid search over phase 8's corpus in a MemoryEngine;
    # phase 9: a checkpoint and GraphRAG answers retrieving through it
    try:
        t0 = time.perf_counter()
        hybrid = phase_hybrid(K, args.seed, served)
        log(f"[phase10] {time.perf_counter() - t0:.1f}s")
        try:
            t0 = time.perf_counter()
            phase_rag(K, args.seed, served, hybrid)
            log(f"[phase9] {time.perf_counter() - t0:.1f}s")
        finally:
            hybrid["service"].shutdown()
    finally:
        served["engine"].stop()
    del served, hybrid
    gc.collect()
    torch.cuda.empty_cache()

    # -- report
    launches = {"streaming_topk_bf16": counts2["streaming_topk_bf16"],
                "streaming_topk_int8": counts3["streaming_topk_int8"],
                "extract_topk": counts4["extract_topk"], **counts5, **counts6}
    for e in entries:
        e["launches"] = launches[e.pop("counter")]
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    log(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
