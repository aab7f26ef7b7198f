#!/usr/bin/env python3
"""The device owner's probe latencies while a DB of phase 10's size
closes, on one GPU, alone and with ``chip_smoke.py``'s phase 18(b) child
running beside the close.

    python3 scripts/probe_during_close.py [--hog SECONDS]

Builds the kernels, starts the process-default device owner with a probe
every 0.2 s, and then three times fills the durable chain with
``chip_smoke.build_graph`` (65,536 seeded texts with unit 1,024-wide
embeddings, phase 10's edges), builds its search service and closes it:
``with_child`` (the Qdrant child, its loaders and server, started 12 s
before the close), ``alone``, ``with_child_again``. For each close it
prints one line: the trial's name and a JSON object with the close's
seconds, the probes it saw, their largest, p99 and median latency in ms,
and how many exceeded 100 and 250 ms (phase 13 of ``chip_smoke.py``
holds the run's largest to half the owner's 1 s threshold); for a child,
a second line with its result. The last line holds the three objects.

With ``--hog SECONDS`` it makes no DB: the main thread sorts a list of
4,000,000 floats again and again for that long (``sorted`` holds the
interpreter lock for the whole sort) while the owner's thread probes,
and one JSON line gives
the probes' count and largest reported latency beside the largest span
between their two events (``RealHooks.last_event_s``): what the card
time was, and what a stalled host made it look like.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from nornicdb_tpu_torch import backend  # noqa: E402
from nornicdb_tpu_torch.embed import HashEmbedder  # noqa: E402
from nornicdb_tpu_torch.ops import _build  # noqa: E402

WORDS = ["graph", "vector", "node", "edge", "search", "card", "memory",
         "index", "query", "label", "path", "score"]
ROWS, DIMS = 65_536, 1024


def window(mgr, fn) -> dict:
    """``fn()`` timed, with the owner's probes that fell in it."""
    p0 = mgr.stats()["probes_total"]
    t0 = time.perf_counter()
    fn()
    seconds = time.perf_counter() - t0
    k = mgr.stats()["probes_total"] - p0
    lat = np.asarray(list(mgr._latencies)[-k:]) * 1e3 if k else np.zeros(1)
    return {"seconds": round(seconds, 2), "probes": int(k),
            "max_ms": round(float(lat.max()), 3),
            "p99_ms": round(float(np.percentile(lat, 99)), 3),
            "p50_ms": round(float(np.median(lat)), 3),
            "over_100ms": int((lat > 100).sum()),
            "over_250ms": int((lat > 250).sum())}


def hog(mgr, seconds: float) -> dict:
    """Probes while another thread holds the interpreter lock in sorts."""
    spans: list = []
    hooks = mgr.hooks
    probe = hooks.probe

    def recorded():
        out = probe()
        spans.append((hooks.last_event_s, out))
        return out

    hooks.probe = recorded
    data = np.random.default_rng(1).random(4_000_000).tolist()
    stop = time.perf_counter() + seconds
    sorts = 0
    while time.perf_counter() < stop:
        sorted(data)
        sorts += 1
        time.sleep(0.01)
    hooks.probe = probe
    event = np.asarray([e for e, _ in spans]) * 1e3
    got = np.asarray([r for _, r in spans]) * 1e3
    return {"seconds": seconds, "sorts": sorts, "probes": len(spans),
            "max_reported_ms": round(float(got.max()), 3),
            "p50_reported_ms": round(float(np.median(got)), 3),
            "max_event_span_ms": round(float(event.max()), 3),
            "event_spans_over_100ms": int((event > 100).sum())}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hog", type=float, default=0.0,
                    help="seconds of interpreter-lock holds instead of closes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_during_close: CUDA is not available", file=sys.stderr)
        return 2
    backend.configure(probe_interval=0.2)
    print(json.dumps(_build.build_all()), flush=True)
    C.start_device_owner()
    mgr = C.OWNER["manager"]
    if args.hog:
        print(json.dumps(hog(mgr, args.hog)), flush=True)
        return 0
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(WORDS, 8)) + f" w{i}x" for i in range(ROWS)]
    embs = rng.standard_normal((ROWS, DIMS), dtype=np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    out = {}
    for trial in ("with_child", "alone", "with_child_again"):
        shutil.rmtree(C.CHAIN_DIR, ignore_errors=True)
        os.makedirs(C.CHAIN_DIR)
        db = C.build_graph(texts, embs, 0)
        db.set_embedder(HashEmbedder(DIMS))
        _ = db.search
        child = None
        if trial.startswith("with_child"):
            child = C.QdrantChild(0).start({"texts": texts, "embs": embs})
            time.sleep(12)  # its boot: the close starts beside its load
        out[trial] = window(mgr, db.close)
        print(trial, json.dumps(out[trial]), flush=True)
        if child is not None:
            try:
                out[trial]["child"] = child.collect()
            except AssertionError as e:
                out[trial]["child"] = repr(e)[-600:]
            finally:
                child.close()
            print(trial, "child", json.dumps(out[trial]["child"]), flush=True)
    shutil.rmtree(C.CHAIN_DIR, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
