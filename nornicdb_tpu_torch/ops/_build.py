"""Build the port's CUDA kernels from the sources in ``ops/csrc`` on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds, not minutes. All sources build in parallel (one
``nvcc`` each). Libraries land in ``ops/_build/`` under a name that carries a
digest of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of each source: name -> (argtypes); every one returns an
# int: a launcher the launch's cudaError_t, a size query its size
SIGNATURES: dict[str, dict[str, tuple]] = {
    "ragged_paged_attention": {
        "nornic_ragged_paged_attention": (_P, _P, _P, _P, _P, _P, _P, _F, _P),
        "nornic_ragged_attn_smem_bytes": (_I, _I, _I, _I, _I),
    },
    "streaming_topk": {
        "nornic_streaming_topk_i8": (
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "nornic_streaming_i8_smem_bytes": (_I, _I, _I, _I),
    },
    "streaming_topk_bf16": {
        "nornic_streaming_topk_bf16": (
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "nornic_streaming_bf16_smem_bytes": (_I, _I, _I),
    },
    "extract_topk": {
        "nornic_extract_topk": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "fused_cosine": {
        "nornic_fused_cosine_scores": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds each source took to compile in this process (0.0: found built)
build_seconds: dict[str, float] = {}
# nvcc's -Xptxas -v report per source (registers, shared memory, spills)
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels are "
        "built from ops/csrc at first use on a machine with the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of the source,
    every header in ``csrc`` (which a source may include) and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def build_all(names: Optional[list[str]] = None) -> dict[str, float]:
    """Compile every missing library (all ``nvcc`` processes started
    together), load them, and return the build seconds of each source."""
    names = list(SIGNATURES) if names is None else names
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: build_seconds.get(n, 0.0) for n in names}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            path = _lib_path(n)
            if path.exists():
                build_seconds[n] = 0.0
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, time.perf_counter())
        failures = []
        for n, (proc, tmp, t0) in procs.items():
            out, _ = proc.communicate()
            build_seconds[n] = time.perf_counter() - t0
            ptxas_reports[n] = out
            if proc.returncode != 0:
                failures.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(n))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        for n in todo:
            _libs[n] = _load(n, _lib_path(n))
        return {n: build_seconds[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib
