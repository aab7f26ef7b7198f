#!/usr/bin/env python3
"""Time the port's kernels #2, #3 and #5 in one or more checkouts, on one GPU.

    python3 scripts/port_kernel_times.py [--root DIR ...] [--seed 0]

Each ``--root`` names a checkout of this repository (a ``git archive`` of
another commit unpacked anywhere, or this one: the default). The roots run
in the order given, each in a process of its own that imports that root's
``nornicdb_tpu_torch`` and builds its kernels from its own sources, so two
commits are compared on one card within one call (give them as parent,
change, change, parent). Each run prints one JSON line:

- ``streaming_topk_bf16``: ``kernels.streaming_bins`` at Q = 1024 and 16
  over 1,000,064 x 1024 float32 unit rows (the serving shape: tile_n 128,
  16 bin rows, 64 masked rows), the time of a call (CUDA events around
  back-to-back calls, ``ms``);
- ``streaming_topk_int8``: ``kernels.streaming_bins_int8`` at Q = 1024 and
  16 over the same rows as ``quantize_rows`` codes (the int8 corpus
  mirror's), the queries' codes likewise, the time of a call (``ms``);
- ``ragged_paged_attention``: ``kernels.ragged_paged_attention`` at the
  generation path's two blocks with Qwen2.5-0.5B's heads (14 / 2, head dim
  64, bf16, pages of 16, a 16-page table): the decode block (L = 10,
  Tq = 1: eight lanes at positions 12, 27, 40, 63, 80, 110, 150, 200 and
  two padding lanes) and the chunk block (L = 1, Tq = 64: 50 rows at
  positions 16..65, 14 padding rows), the positions of ``chip_smoke.py``'s
  real fused step, with random K/V; the time of a call (``ms``) and the
  device's time of a call from CUDA-graph replays (``device_ms``). A call
  of tens of microseconds is host work, so its ``ms`` is the median of five
  runs of 200 calls.

Also the card's name and power limit. Without CUDA it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, DIMS, TILE_N, BIN_ROWS = 1_000_064, 1024, 128, 16


def _smoke_timers():
    """``cuda_ms``, ``call_ms`` and ``graph_ms`` of this checkout's
    ``chip_smoke.py`` (loaded from its path: the root under test owns
    ``sys.path``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.cuda_ms, smoke.call_ms, smoke.graph_ms


def attention_inputs(dev, seed: int) -> dict:
    """The two blocks of a real fused step's layer: shapes, tables and
    positions as ``chip_smoke.probe_attention_inputs`` makes them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ps, w, pool_pages, h, hkv, dh = 16, 16, 129, 14, 2, 64
    pool = torch.from_numpy(rng.standard_normal(
        (2, pool_pages, ps, hkv, dh)).astype(np.float32)).to(dev, torch.bfloat16)
    lengths = [12, 27, 40, 63, 80, 110, 150, 200]
    tables = np.zeros((10, w), np.int32)
    free = list(range(pool_pages - 1, 0, -1))
    for i, n in enumerate(lengths):
        need = -(-(n + 1) // ps)
        tables[i, :need] = [free.pop() for _ in range(need)]
    chunk = np.zeros((1, w), np.int32)
    chunk[0, 0] = tables[7, 0]  # shares the last decode lane's first page
    chunk[0, 1:5] = [free.pop() for _ in range(4)]
    pos_dec = np.full((10, 1), -1, np.int32)
    pos_dec[:8, 0] = lengths
    pos_chk = np.full((1, 64), -1, np.int32)
    pos_chk[0, :50] = np.arange(16, 66)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(a).to(dev, dtype)

    q = lambda l, tq: t(rng.standard_normal((l, tq, h, dh)).astype(np.float32),
                        torch.bfloat16)
    return {"decode": (q(10, 1), pool[0], pool[1], t(tables), t(pos_dec)),
            "chunk": (q(1, 64), pool[0], pool[1], t(chunk), t(pos_chk))}


def run_one(root: str, seed: int) -> dict:
    import torch

    sys.path.insert(0, root)
    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.ops import _build
    from nornicdb_tpu_torch.ops import kernels as K

    here = os.path.dirname(os.path.dirname(os.path.abspath(nornicdb_tpu_torch.__file__)))
    assert os.path.samefile(here, root), ("imported", here, "not", root)
    cuda_ms, call_ms, graph_ms = _smoke_timers()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": root, "build_s": _build.build_all()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randn((N_ROWS, DIMS), generator=gen, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    valid = torch.ones(N_ROWS, dtype=torch.bool, device=dev)
    valid[-64:] = False
    queries = corpus[:1024] + 0.01 * torch.randn((1024, DIMS), generator=gen, device=dev)
    queries /= queries.norm(dim=1, keepdim=True)
    out["streaming_topk_bf16"] = {}
    for q in (1024, 16):
        qt = queries[:q].contiguous()
        out["streaming_topk_bf16"][q] = {"ms": cuda_ms(
            lambda: K.streaming_bins(qt, corpus, valid, TILE_N, BIN_ROWS), 6)}
    c_i8, c_scale = K.quantize_rows(corpus)
    del corpus
    q_i8 = K.quantize_rows(queries)[0]
    out["streaming_topk_int8"] = {}
    for q in (1024, 16):
        qt = q_i8[:q].contiguous()
        out["streaming_topk_int8"][q] = {"ms": cuda_ms(
            lambda: K.streaming_bins_int8(qt, c_i8, c_scale, valid, TILE_N,
                                          BIN_ROWS), 6)}
    del c_i8, c_scale, valid, queries, q_i8
    torch.cuda.empty_cache()
    out["ragged_paged_attention"] = {}
    for key, a in attention_inputs(dev, seed).items():
        fn = lambda: K.ragged_paged_attention(*a)
        out["ragged_paged_attention"][key] = {
            "ms": call_ms(fn, 200), "device_ms": graph_ms(fn, 24)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.one), args.seed)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for root in args.root or [HERE]:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(root), "--seed", str(args.seed)],
            timeout=900)
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
