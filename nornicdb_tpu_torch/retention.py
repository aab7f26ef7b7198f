"""GDPR data retention: per-category policies, legal holds, erasure requests.

Behavioral reference: upstream NornicDB pkg/retention/retention.go —
Policy :144, LegalHold :205, ErasureRequest :273 (status workflow),
Manager :350 with delete/archive callbacks; GDPR endpoints
(pkg/server /gdpr/export|delete, SURVEY.md layer 11).

The port's copy of ``nornicdb_tpu/retention.py``.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.errors import NornicError
from nornicdb_tpu_torch.storage.types import Engine, Node

# erasure workflow states (ref: ErasureRequest :273)
ERASURE_PENDING = "pending"
ERASURE_APPROVED = "approved"
ERASURE_COMPLETED = "completed"
ERASURE_REJECTED = "rejected"


@dataclass
class Policy:
    """(ref: Policy retention.go:144)"""

    category: str  # matches node property "category" or a label
    max_age: float  # seconds
    action: str = "delete"  # delete | archive


@dataclass
class LegalHold:
    """(ref: LegalHold retention.go:205)"""

    id: str
    reason: str
    node_ids: set[str] = field(default_factory=set)
    categories: set[str] = field(default_factory=set)
    created_at: float = field(default_factory=time.time)
    released: bool = False


@dataclass
class ErasureRequest:
    id: str
    subject: str  # node id or property match value
    status: str = ERASURE_PENDING
    requested_at: float = field(default_factory=time.time)
    completed_at: Optional[float] = None
    erased_count: int = 0


class RetentionManager:
    """(ref: retention.Manager retention.go:350)"""

    def __init__(
        self,
        storage: Engine,
        on_delete: Optional[Callable[[Node], None]] = None,
        on_archive: Optional[Callable[[Node], None]] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        self.storage = storage
        self.on_delete = on_delete
        self.on_archive = on_archive
        self.now = now_fn
        self._lock = threading.RLock()
        self.policies: dict[str, Policy] = {}
        self.holds: dict[str, LegalHold] = {}
        self.erasures: dict[str, ErasureRequest] = {}

    # -- policies -------------------------------------------------------------
    def set_policy(self, policy: Policy) -> None:
        with self._lock:
            self.policies[policy.category] = policy

    def remove_policy(self, category: str) -> None:
        with self._lock:
            self.policies.pop(category, None)

    def _node_category(self, node: Node) -> Optional[str]:
        cat = node.properties.get("category")
        if isinstance(cat, str):
            return cat
        for label in node.labels:
            if label in self.policies:
                return label
        return None

    def _held(self, node: Node) -> bool:
        cat = self._node_category(node)
        with self._lock:
            for hold in self.holds.values():
                if hold.released:
                    continue
                if node.id in hold.node_ids:
                    return True
                if cat and cat in hold.categories:
                    return True
        return False

    def enforce(self) -> dict[str, int]:
        """Apply policies to expired nodes; legal holds win
        (ref: enforcement loop)."""
        deleted = archived = held = 0
        now = self.now()
        for node in list(self.storage.all_nodes()):
            cat = self._node_category(node)
            if cat is None:
                continue
            policy = self.policies.get(cat)
            if policy is None:
                continue
            if now - node.created_at < policy.max_age:
                continue
            if self._held(node):
                held += 1
                continue
            if policy.action == "archive":
                if "Archived" not in node.labels:
                    node.labels.append("Archived")
                    self.storage.update_node(node)
                    if self.on_archive:
                        self.on_archive(node)
                    archived += 1
            else:
                self.storage.delete_node(node.id)
                if self.on_delete:
                    self.on_delete(node)
                deleted += 1
        return {"deleted": deleted, "archived": archived, "held": held}

    # -- legal holds -----------------------------------------------------------
    def create_hold(self, reason: str, node_ids: Optional[set[str]] = None,
                    categories: Optional[set[str]] = None) -> LegalHold:
        hold = LegalHold(
            id=str(uuid.uuid4()), reason=reason,
            node_ids=set(node_ids or ()), categories=set(categories or ()),
        )
        with self._lock:
            self.holds[hold.id] = hold
        return hold

    def release_hold(self, hold_id: str) -> None:
        with self._lock:
            hold = self.holds.get(hold_id)
            if hold is None:
                raise NornicError(f"hold {hold_id} not found")
            hold.released = True

    # -- erasure workflow (GDPR right to be forgotten) ----------------------------
    def request_erasure(self, subject: str) -> ErasureRequest:
        req = ErasureRequest(id=str(uuid.uuid4()), subject=subject)
        with self._lock:
            self.erasures[req.id] = req
        return req

    def approve_erasure(self, request_id: str) -> ErasureRequest:
        with self._lock:
            req = self.erasures.get(request_id)
            if req is None:
                raise NornicError(f"erasure request {request_id} not found")
            if req.status != ERASURE_PENDING:
                raise NornicError(f"erasure request is {req.status}")
            req.status = ERASURE_APPROVED
            return req

    def reject_erasure(self, request_id: str) -> None:
        with self._lock:
            req = self.erasures.get(request_id)
            if req is not None:
                req.status = ERASURE_REJECTED

    def execute_erasure(self, request_id: str) -> ErasureRequest:
        """Delete all nodes belonging to the subject (by id or by a
        `subject`/`owner` property match), unless legally held."""
        with self._lock:
            req = self.erasures.get(request_id)
            if req is None:
                raise NornicError(f"erasure request {request_id} not found")
            if req.status != ERASURE_APPROVED:
                raise NornicError("erasure must be approved first")
        erased = 0
        for node in list(self.storage.all_nodes()):
            matches = (
                node.id == req.subject
                or node.properties.get("subject") == req.subject
                or node.properties.get("owner") == req.subject
            )
            if not matches or self._held(node):
                continue
            self.storage.delete_node(node.id)
            if self.on_delete:
                self.on_delete(node)
            erased += 1
        with self._lock:
            req.status = ERASURE_COMPLETED
            req.completed_at = self.now()
            req.erased_count = erased
        return req

    def export_subject(self, subject: str) -> list[dict[str, Any]]:
        """GDPR data export (ref: /gdpr/export)."""
        out = []
        for node in self.storage.all_nodes():
            if (
                node.id == subject
                or node.properties.get("subject") == subject
                or node.properties.get("owner") == subject
            ):
                out.append(node.to_dict())
        return out
