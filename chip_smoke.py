#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nornicdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Builds the port's CUDA kernels from ``nornicdb_tpu_torch/ops/csrc`` (one
``nvcc`` per source, in parallel), then at the headline serving size
(1,000,000 x 1024 vectors, bge-m3's width; top-100):

1. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (Q = 1024 and Q = 16, N = 1,000,064 rows), and
   times kernel, plain version and a one-call library yardstick;
2. drives the serving path: ``SearchService`` with batching, a bulk load,
   concurrent ``vector_candidates`` calls with writes interleaved, recall@100
   against exact float32 ground truth, removed ids never served, the
   streaming kernel's launch count and the fused-dispatch count;
3. the same over an int8-mirrored ``DeviceCorpus(quantize=True)``;
4. the extract-kernel epilogue, identical to the sort epilogue.

The data is a Gaussian mixture made with numpy from ``--seed``: 10,000
centres with 100 rows each (shuffled), so each query's true top-100 is
separable from the rest. Queries are noisy copies of rows.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it is the ``kernels`` JSON (times, bounds, launches). Any failed check raises
and the script exits non-zero without that line. Without CUDA it exits 2.
Matmul precision is pinned to full float32 (no TF32) for every reference.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
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
REPS = 6  # timed calls of each kernel (a third of that for the slow ones)


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


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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

    n, d = dev.shape
    tile = K.pick_tile_n(n)
    rows = min(K.streaming_rows_for(k, tile), n // tile)
    n_tiles, rows, tile_bits = K.streaming_geometry(n, tile, rows)
    b = rows * tile
    kpad = -(-k // K.LANE) * K.LANE
    log(f"[kernels] N={n} D={d} tile_n={tile} rows={rows} tile_bits={tile_bits} "
        f"bins={b} k={k}")
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
        t["ex"] = cuda_ms(lambda: K._extract_topk(flat, k, kpad), reps)
        t["ex_plain"] = cuda_ms(lambda: R.extract_topk(flat, k, kpad), max(1, reps // 3))
        t["ex_lib"] = cuda_ms(lambda: torch.topk(flat, k, dim=1), reps)
        log(f"[kernels] Q={q} ms: " + " ".join(f"{a}={v:.4f}" for a, v in t.items()))

        out_bytes = rows * q * tile * 4
        b2 = bound_ms(n * d * 4 + q * d * 4 + n + out_bytes, 2 * q * n * d, H100_BF16_OPS)
        b3 = bound_ms(n * d + q * d + n * 4 + n + out_bytes, 2 * q * n * d, H100_INT8_OPS)
        # #4 is a top-k of B values a row: one read of the bins, one write
        # of kpad values and ids, and B compares a row outside the tensor cores
        b4 = bound_ms(q * b * 4 + 2 * q * kpad * 4, q * b, H100_FP32_OPS)
        base = "nornicdb_tpu_torch/ops/csrc/"
        entries += [
            dict(name=f"streaming_topk_bf16[Q={q}]", route="cuda",
                 source=base + "streaming_topk.cu",
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
                 bound_by=b4[1], library_ms=t["ex_lib"]),
        ]
        del bins_k, bins_p, bins8_k, bins8_p, flat
        torch.cuda.empty_cache()
    return entries


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after phase 2, trace 16 batches of 16 queries with "
                    "torch.profiler (device busy share, per-op table)")
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
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    # -- phase 2: the serving path (batched vector_candidates + writes).
    # Removed: the own rows of queries outside the recall sample, each in
    # its query's true top-k, so a leak would show.
    removed = {f"v{r}" for r in serve_rows[1::8]}
    for rid in removed:
        svc.remove_node(rid)

    class _Node:
        def __init__(self, id_, emb):
            self.id, self.embedding = id_, emb

    extra = rng.standard_normal((48, DIMS), dtype=np.float32)

    def writes() -> None:
        # random rows score ~0 against every query: never in a top-k
        for i in range(48):
            svc.index_node(_Node(f"new{i}", extra[i]))
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
    svc.close()
    del svc, corpus, dev, valid
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 3: int8-mirrored corpus
    t0 = time.perf_counter()
    qc = S.DeviceCorpus(dims=DIMS, quantize=True, device=device)
    qc.add_batch(ids, data)
    del data
    gc.collect()
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

    # -- report
    launches = {"streaming_topk_bf16": counts2["streaming_topk_bf16"],
                "streaming_topk_int8": counts3["streaming_topk_int8"],
                "extract_topk": counts4["extract_topk"]}
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
