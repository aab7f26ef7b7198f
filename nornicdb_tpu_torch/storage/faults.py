"""Deterministic storage fault injection at the WAL write/fsync seams.

Counterpart of ``nornicdb_tpu/storage/faults.py`` (the port keeps its own
copy and imports nothing of the JAX package).

The reference proves WAL resilience with chaos suites that corrupt logs
offline (tests/test_storage_chaos.py here); this module makes the same
fault classes injectable into a LIVE WAL so a soak harness can compose
storage faults with replication and backend faults in one run:

* ``fsync_fail``  — the durability fsync raises EIO.  The record already
  hit the page cache but its durability promise is void: the append is
  rolled back (tail truncated to the last good record) and surfaces as a
  typed :class:`~nornicdb_tpu_torch.errors.DurabilityError`; nothing is acked.
* ``torn_tail``   — only a prefix of the framed record reaches the file
  before the write "fails" mid-flight (crash-shaped partial record).
  With repair enabled (the default) the WAL truncates the torn bytes so
  later appends stay recoverable; with ``repairable=False`` the partial
  record is left in place, exactly like a power cut mid-append — replay
  then stops at the last good record (torn-tail recovery).
* ``enospc``      — the write raises ENOSPC before any byte lands
  (transient full disk).  Disarm and the next append succeeds.

Faults are **armed, counted, and scoped**: each plan fires ``count``
times against paths under ``path_prefix`` (empty = any WAL), then goes
inert.  The process-global :data:`INJECTOR` is deliberately inert by
default — production code pays one attribute read per append.
"""

from __future__ import annotations

import errno
import os
import threading
from dataclasses import dataclass

from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as _REGISTRY

KINDS = ("fsync_fail", "torn_tail", "enospc")

_INJECTED = _REGISTRY.counter(
    "nornicdb_storage_faults_injected_total",
    "Storage faults fired by the deterministic injector (soak/chaos runs)",
    labels=("kind",),
)
for _k in KINDS:
    _INJECTED.labels(_k)  # eager cells: render at 0 before the first fault


@dataclass
class FaultPlan:
    kind: str
    remaining: int = 1
    path_prefix: str = ""  # "" matches every WAL path
    repairable: bool = True  # torn_tail only: allow the WAL tail repair
    fired: int = 0


class StorageFaultInjector:
    """Armed fault plans consulted by ``WAL.append`` at its two seams
    (record write, durability fsync).  Thread-safe; plans are consumed
    deterministically in arm order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plans: list[FaultPlan] = []
        self.fired: dict[str, int] = {k: 0 for k in KINDS}
        # lock-free inert flag: WAL.append reads this (one attribute read)
        # before touching the lock, so an unarmed injector adds no
        # cross-WAL contention to the durability hot path.  Updated under
        # the lock by arm/disarm/_take; stale-True just means one extra
        # locked check, stale-False cannot happen (arm sets it last).
        self.armed = False

    # -- arming ------------------------------------------------------------
    def arm(self, kind: str, count: int = 1, path_prefix: str = "",
            repairable: bool = True) -> FaultPlan:
        if kind not in KINDS:
            raise ValueError(f"unknown storage fault kind {kind!r}")
        # normalize: WALs opened via a relative data_dir carry relative
        # paths, and a prefix armed with an absolute path must still
        # match.  The trailing separator makes the match component-wise:
        # a prefix of <data>/wal must not fire against <data>/wal2
        plan = FaultPlan(kind=kind, remaining=int(count),
                         path_prefix=(os.path.abspath(path_prefix) + os.sep
                                      if path_prefix else ""),
                         repairable=repairable)
        with self._lock:
            self._plans.append(plan)
            self.armed = True
        return plan

    def disarm(self, kind: str | None = None) -> None:
        with self._lock:
            if kind is None:
                self._plans.clear()
            else:
                self._plans = [p for p in self._plans if p.kind != kind]
            self.armed = any(p.remaining > 0 for p in self._plans)

    def active(self) -> bool:
        with self._lock:
            return any(p.remaining > 0 for p in self._plans)

    def _take(self, kind: str, path: str) -> FaultPlan | None:
        """Consume one shot of the first matching armed plan, or None."""
        if not self.armed:  # lock-free: the common production path
            return None
        with self._lock:
            abs_path = os.path.abspath(path)
            taken = None
            for p in self._plans:
                if p.kind != kind or p.remaining <= 0:
                    continue
                if p.path_prefix and not (abs_path + os.sep).startswith(
                        p.path_prefix):
                    continue
                p.remaining -= 1
                p.fired += 1
                self.fired[kind] += 1
                _INJECTED.labels(kind).inc()
                taken = p
                break
            self.armed = any(p.remaining > 0 for p in self._plans)
            return taken

    # -- seams (called by WAL.append under its lock; must never block) -----
    def check_write(self, path: str, f, raw: bytes) -> bool:
        """Write seam.  Returns True when the full record may be written;
        raises OSError for an injected write fault.  ``torn_tail`` writes
        the partial prefix itself before raising, so the file looks
        exactly like a crash mid-append."""
        plan = self._take("enospc", path)
        if plan is not None:
            raise OSError(errno.ENOSPC,
                          "injected transient ENOSPC (storage fault)")
        plan = self._take("torn_tail", path)
        if plan is not None:
            f.write(raw[: max(1, len(raw) // 2)])
            f.flush()
            e = OSError(errno.EIO, "injected torn tail write (storage fault)")
            e.nornicdb_repairable = plan.repairable
            raise e
        return True

    def check_fsync(self, path: str) -> None:
        """Fsync seam.  Raises OSError when an ``fsync_fail`` plan is armed;
        the caller then rolls the un-durable record back off the tail."""
        if self._take("fsync_fail", path) is not None:
            raise OSError(errno.EIO, "injected fsync failure (storage fault)")


#: process-global injector, inert unless a chaos/soak driver arms it
INJECTOR = StorageFaultInjector()
