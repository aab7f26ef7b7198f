"""apoc.trigger — Cypher statements fired by storage events.

Behavioral reference: upstream NornicDB apoc/trigger (trigger.go) — triggers
registered as (name, cypher, selector {label, event, phase}); statements run
with the affected entities bound ($createdNodes, $deletedNodes,
$createdRelationships, $deletedRelationships, $assignedNodeProperties,
$assignedRelationshipProperties). The registry is database-global (one per
storage engine), shared across sessions.

Known deviations, documented rather than faked:
  - Firing is synchronous per storage event (the reference batches
    post-transaction). Phases "before"/"after"/"afterAsync" all fire at
    the same point; selecting them filters nothing out.
  - $assignedNodeProperties / $assignedRelationshipProperties carry
    {key: [{node|relationship, key, new}]} without `old` values — the
    event stream has no pre-images yet.
Recursive cascades are suppressed (a trigger's own writes don't re-fire
triggers), matching the reference's post-tx semantics in effect.

The port's copy of ``nornicdb_tpu/apoc/triggers.py``.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from nornicdb_tpu_torch.storage.types import Edge, Engine, Node
from nornicdb_tpu_torch.telemetry.metrics import count_error

log = logging.getLogger(__name__)

_EVENT_PARAM = {
    "node_created": "createdNodes",
    "node_deleted": "deletedNodes",
    "node_updated": "assignedNodeProperties",
    "edge_created": "createdRelationships",
    "edge_deleted": "deletedRelationships",
    "edge_updated": "assignedRelationshipProperties",
}

# selector {"event": ...} values accepted per event kind (ref: trigger.go)
_EVENT_NAME = {
    "node_created": "create",
    "node_deleted": "delete",
    "node_updated": "update",
    "edge_created": "create",
    "edge_deleted": "delete",
    "edge_updated": "update",
}

_PHASES = ("before", "after", "afterAsync")


@dataclass
class Trigger:
    name: str
    statement: str
    selector: dict[str, Any] = field(default_factory=dict)
    paused: bool = False
    fired: int = 0
    errors: int = 0


def manager_for(executor) -> "TriggerManager":
    """Database-global registry: ONE manager per storage engine, shared by
    every session executor (ref: APOC's per-database trigger store)."""
    storage = executor.storage
    mgr = getattr(storage, "_apoc_trigger_manager", None)
    if mgr is None:
        mgr = TriggerManager(executor)
        storage._apoc_trigger_manager = mgr
    return mgr


class TriggerManager:
    def __init__(self, executor):
        # dedicated executor so trigger statements never share a session's
        # explicit-transaction state; on the triggering executor's device
        # and behind its device owner
        from nornicdb_tpu_torch.cypher.executor import CypherExecutor

        self.executor = CypherExecutor(
            executor.storage, schema=executor.schema, db=executor.db,
            device=executor.device, backend=executor.backend,
        )
        self._lock = threading.RLock()
        self._triggers: dict[str, Trigger] = {}
        self._firing = threading.local()
        executor.storage.on_event(self._on_event)

    # -- registry -----------------------------------------------------------
    def add(self, name: str, statement: str,
            selector: Optional[dict] = None) -> Trigger:
        with self._lock:
            t = Trigger(name, statement, selector or {})
            self._triggers[name] = t
            return t

    def get(self, name: str) -> Optional[Trigger]:
        with self._lock:
            return self._triggers.get(name)

    def remove(self, name: str) -> bool:
        with self._lock:
            return self._triggers.pop(name, None) is not None

    def remove_all(self) -> int:
        with self._lock:
            n = len(self._triggers)
            self._triggers.clear()
            return n

    def pause(self, name: str, paused: bool = True) -> Optional[Trigger]:
        with self._lock:
            t = self._triggers.get(name)
            if t is not None:
                t.paused = paused
            return t

    def list(self) -> list[Trigger]:
        with self._lock:
            return list(self._triggers.values())

    # -- firing --------------------------------------------------------------
    @staticmethod
    def _matches_selector(t: Trigger, kind: str, entity: Any) -> bool:
        sel = t.selector or {}
        want_event = sel.get("event")
        if want_event and want_event != _EVENT_NAME.get(kind):
            return False
        want_label = sel.get("label")
        if want_label:
            if isinstance(entity, Node):
                if want_label not in entity.labels:
                    return False
            elif isinstance(entity, Edge):
                if want_label != entity.type:
                    return False
        phase = sel.get("phase")
        if phase and phase not in _PHASES:
            return False  # unknown phase: never fire (registration-time typo)
        return True

    @staticmethod
    def _params_for(kind: str, entity: Any) -> dict[str, Any]:
        params: dict[str, Any] = {
            "createdNodes": [], "deletedNodes": [],
            "createdRelationships": [], "deletedRelationships": [],
            "assignedNodeProperties": {}, "assignedRelationshipProperties": {},
        }
        param = _EVENT_PARAM[kind]
        if kind == "node_updated":
            params[param] = {
                k: [{"node": entity, "key": k, "new": v}]
                for k, v in entity.properties.items()
            }
        elif kind == "edge_updated":
            params[param] = {
                k: [{"relationship": entity, "key": k, "new": v}]
                for k, v in entity.properties.items()
            }
        else:
            params[param] = [entity]
        return params

    def _on_event(self, kind: str, entity: Any) -> None:
        if kind not in _EVENT_PARAM:
            return
        if getattr(self._firing, "active", False):
            return  # no recursive cascades
        with self._lock:
            triggers = [
                t for t in self._triggers.values()
                if not t.paused and self._matches_selector(t, kind, entity)
            ]
        if not triggers:
            return
        params = self._params_for(kind, entity)
        self._firing.active = True
        try:
            for t in triggers:
                try:
                    self.executor.execute(t.statement, params)
                    t.fired += 1
                except Exception:
                    # a broken trigger must not break writes — but its
                    # failures must be visible, not just a silent counter
                    log.warning("trigger %s failed", t.name, exc_info=True)
                    count_error("apoc.trigger")
                    t.errors += 1
        finally:
            self._firing.active = False
