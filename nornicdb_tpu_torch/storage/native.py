"""Native host libraries of the port's storage: the WAL codec (ctypes
bindings, counterpart of ``nornicdb_tpu/storage/native.py``) and the
``g++`` build shared with the segment store (``storage/segment.py``).

Both C++ sources are the port's own copies, in ``storage/csrc``
(``walcodec.cc``, ``segstore.cc``). ``build_library`` compiles one with
``g++`` at first use into ``storage/_build/`` under a name that carries a
digest of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded; nothing is built at import time and nothing
is written outside the port. ``NORNICDB_NATIVE_DIR`` names a directory of
prebuilt libraries (``libwalcodec.so``, ``libsegstore.so``) instead, as in
the JAX package. A build that fails is logged with the compiler's output
and kept in ``build_errors``.

The WAL codec moves record framing and CRC sweeps to C++. Measured in the
JAX package (50k records, 280 B JSON payloads), the per-record ctypes
marshalling makes it 0.8-1.0x of the pure-Python path, because Python's
zlib.crc32/struct are already C and the payload slices must cross into
Python regardless. It is therefore OPT-IN (``NORNICDB_NATIVE_WAL=1``); both
codecs emit identical bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")

_build_lock = threading.Lock()
# seconds each library took to compile in this process (0.0: found built)
build_seconds: dict[str, float] = {}
# compiler output of each library whose build failed in this process
build_errors: dict[str, str] = {}


def library_path(name: str) -> str:
    """Where ``lib<name>.so`` is loaded from: the prebuilt directory named
    by ``NORNICDB_NATIVE_DIR``, else the port's build directory under a
    digest of ``csrc/<name>.cc`` and the flags."""
    prebuilt = os.environ.get("NORNICDB_NATIVE_DIR")
    if prebuilt:
        return os.path.join(prebuilt, f"lib{name}.so")
    digest = hashlib.sha256(
        (CSRC / f"{name}.cc").read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return str(BUILD_DIR / f"lib{name}-{digest}.so")


def build_library(name: str) -> Optional[str]:
    """Path of ``lib<name>.so``, compiling ``csrc/<name>.cc`` with ``g++``
    (``$CXX``) if it is not built yet; None when it cannot be had.

    The compiler runs under the module's build lock, once per process:
    engines resolve their library when they open (``WAL.__init__``,
    ``SegmentEngine.__init__``), never inside their own append or flush
    critical sections."""
    path = library_path(name)
    with _build_lock:
        if os.path.exists(path):
            build_seconds.setdefault(name, 0.0)
            return path
        if os.environ.get("NORNICDB_NATIVE_DIR"):
            build_errors[name] = f"{path} not found"
            log.warning("native %s library unavailable: %s", name, path)
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", tmp,
               str(CSRC / f"{name}.cc")]
        t0 = time.perf_counter()
        try:
            # deliberate subprocess under the build lock: the build-once
            # gate runs a single time per process, at load time
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            build_errors[name] = f"{' '.join(cmd)}: {e}"
            log.warning("native %s build failed: %s", name, build_errors[name])
            return None
        if out.returncode != 0:
            build_errors[name] = (f"{' '.join(cmd)} exited {out.returncode}:\n"
                                  f"{out.stderr}")
            log.warning("native %s build failed: %s", name, build_errors[name])
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
        build_seconds[name] = time.perf_counter() - t0
        return path


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the codec library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_library("walcodec")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            log.warning("native WAL codec failed to load from %s", path,
                        exc_info=True)
            return None
        lib.wal_encode.restype = ctypes.c_int64
        lib.wal_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.wal_scan.restype = ctypes.c_int64
        lib.wal_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.wal_crc32.restype = ctypes.c_uint32
        lib.wal_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def enabled() -> bool:
    """Native WAL codec is opt-in (see module docstring for the measurement)."""
    return os.environ.get("NORNICDB_NATIVE_WAL", "").lower() in ("1", "true") and available()


def encode(payload: bytes, seq: int) -> Optional[bytes]:
    # hot path: uses the handle cached by a prior load()/enabled() call and
    # never takes the module lock — WAL.append runs this under its own lock,
    # and re-entering load() there would put the (first-call) compiler build
    # inside the WAL critical section
    lib = _lib
    if lib is None:
        return None
    cap = len(payload) + 32
    out = (ctypes.c_uint8 * cap)()
    n = lib.wal_encode(payload, len(payload), seq, out, cap)
    if n < 0:
        return None
    return bytes(out[:n])


_MIN_RECORD = 24  # header(9) + footer(12) padded to 8


def scan(buf: bytes, max_records: int = 0):
    """Returns (records, valid_bytes) where records = [(payload, seq), ...],
    or None when the native library is unavailable."""
    lib = _lib  # cached by a prior load()/enabled(); see encode()
    if lib is None:
        return None
    if max_records <= 0:
        max_records = max(len(buf) // _MIN_RECORD + 1, 1)
    offsets = (ctypes.c_uint64 * max_records)()
    lengths = (ctypes.c_uint64 * max_records)()
    seqs = (ctypes.c_uint64 * max_records)()
    valid = ctypes.c_uint64(0)
    n = lib.wal_scan(
        buf, len(buf), offsets, lengths, seqs, max_records,
        ctypes.byref(valid),
    )
    records = [
        (buf[offsets[i] : offsets[i] + lengths[i]], int(seqs[i]))
        for i in range(n)
    ]
    return records, int(valid.value)
