"""Audit logging (SOC2/HIPAA-style event trail).

The port's copy of ``nornicdb_tpu/audit.py``. Behavioral reference: the
upstream NornicDB pkg/audit/audit.go (audit subsystem;
docs/compliance/audit-logging.md) + the auth audit event hook
(pkg/auth/auth.go:376,619). Append-only JSONL with hash chaining so
tampering is detectable.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class AuditEvent:
    timestamp: float
    event: str
    actor: str
    detail: dict[str, Any]
    prev_hash: str
    hash: str = ""

    def compute_hash(self) -> str:
        blob = json.dumps(
            [self.timestamp, self.event, self.actor, self.detail, self.prev_hash],
            sort_keys=True, default=str,
        )
        return hashlib.sha256(blob.encode()).hexdigest()


class AuditLog:
    """Append-only, hash-chained audit trail."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: list[AuditEvent] = []
        self._last_hash = "genesis"
        if path and os.path.exists(path):
            self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                ev = AuditEvent(**d)
                self._events.append(ev)
                self._last_hash = ev.hash

    def record(self, event: str, actor: str = "system",
               detail: Optional[dict] = None) -> AuditEvent:
        with self._lock:
            ev = AuditEvent(
                timestamp=time.time(), event=event, actor=actor,
                detail=detail or {}, prev_hash=self._last_hash,
            )
            ev.hash = ev.compute_hash()
            self._events.append(ev)
            self._last_hash = ev.hash
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(ev.__dict__, default=str) + "\n")
            return ev

    def events(self, event_type: Optional[str] = None,
               actor: Optional[str] = None) -> list[AuditEvent]:
        with self._lock:
            return [
                e for e in self._events
                if (event_type is None or e.event == event_type)
                and (actor is None or e.actor == actor)
            ]

    def verify_chain(self) -> bool:
        """Detect tampering: every hash must chain from the previous."""
        with self._lock:
            prev = "genesis"
            for e in self._events:
                if e.prev_hash != prev or e.compute_hash() != e.hash:
                    return False
                prev = e.hash
            return True

    def auth_hook(self):
        """Adapter for Authenticator(audit_hook=...) (ref: auth.go:619)."""

        def hook(event: str, detail: dict) -> None:
            self.record(event, actor=detail.get("username", "unknown"),
                        detail=detail)

        return hook
