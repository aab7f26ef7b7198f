"""Heimdall prompt/context machinery: token budgets, prompt building,
examples, per-request context with notifications and cancellation. A copy
of ``nornicdb_tpu/heimdall/context.py`` (host code, no device work).

Behavioral reference: the upstream NornicDB pkg/heimdall/types.go —
PromptContext (:284, immutable ActionPrompt + plugin-mutable
AdditionalInstructions/Examples/PluginData, notification queue, Cancel),
PromptExample (:429), token budget (:456-511, env-overridable
NORNICDB_HEIMDALL_MAX_{CONTEXT,SYSTEM,USER}_TOKENS, ~4 chars/token
estimate), BuildFinalPrompt full→minimal fallback (:513-648) with the
embedded CypherPrimer, and GenerateParams defaults (:93-111).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

# token budget defaults (ref: types.go:436-448)
DEFAULT_MAX_CONTEXT_TOKENS = 8192
DEFAULT_MAX_SYSTEM_TOKENS = 6000
DEFAULT_MAX_USER_TOKENS = 2000
TOKENS_PER_CHAR = 0.25


@dataclass
class TokenBudget:
    max_context: int = DEFAULT_MAX_CONTEXT_TOKENS
    max_system: int = DEFAULT_MAX_SYSTEM_TOKENS
    max_user: int = DEFAULT_MAX_USER_TOKENS

    @classmethod
    def from_env(cls) -> "TokenBudget":
        def _get(name: str, default: int) -> int:
            try:
                v = int(os.environ.get(name, ""))
                return v if v > 0 else default
            except ValueError:
                return default

        return cls(
            _get("NORNICDB_HEIMDALL_MAX_CONTEXT_TOKENS",
                 DEFAULT_MAX_CONTEXT_TOKENS),
            _get("NORNICDB_HEIMDALL_MAX_SYSTEM_TOKENS",
                 DEFAULT_MAX_SYSTEM_TOKENS),
            _get("NORNICDB_HEIMDALL_MAX_USER_TOKENS",
                 DEFAULT_MAX_USER_TOKENS),
        )


def estimate_tokens(text: str) -> int:
    """~4 chars per token (ref: EstimateTokens types.go:506)."""
    return int(len(text) * TOKENS_PER_CHAR)


@dataclass
class PromptExample:
    """(ref: PromptExample types.go:429)"""

    user_says: str
    action_json: str


@dataclass
class GenerateParams:
    """(ref: GenerateParams types.go:93 + DefaultGenerateParams)"""

    max_tokens: int = 512
    temperature: float = 0.1  # low → deterministic JSON output
    top_p: float = 0.9
    top_k: int = 40
    stop_tokens: tuple = ("<|im_end|>", "<|endoftext|>", "</s>")


# a compact Cypher reference injected into the full prompt
# (ref: CypherPrimer types.go — trimmed to the same sections)
CYPHER_PRIMER = """CYPHER QUERY REFERENCE:
Patterns: MATCH (n) | MATCH (n:Label) | MATCH (n {prop: v}) | MATCH (n)-[r:TYPE]->(m)
Common: MATCH (n) RETURN count(n) | MATCH (n:L) RETURN n LIMIT 10 | MATCH ()-[r]->() RETURN type(r), count(r)
Filters: WHERE n.p = 'v' | CONTAINS | STARTS WITH | IS NOT NULL | n.p > 10
Aggregates: count, collect, sum, avg, min, max
Paths: MATCH p = (a)-[*1..3]->(b) | shortestPath((a)-[*]->(b))
Writes: CREATE (n:L {p: 'v'}) | SET n.p = 'v' | DETACH DELETE n
Vector: CALL db.index.vector.queryNodes('idx', 50, 'QUERY') YIELD node, score
"""


@dataclass
class QueuedNotification:
    """(ref: QueuedNotification types.go:334)"""

    type: str  # info/warning/error/success/progress
    title: str
    message: str


class PromptContext:
    """Per-request context threaded through plugin PrePrompt hooks.

    `action_prompt` is immutable (set from the registered-action catalog
    before hooks run); `additional_instructions`, `examples`, and
    `plugin_data` are plugin-mutable (ref: types.go:284-331).
    """

    def __init__(
        self,
        user_message: str,
        messages: Optional[list[dict[str, str]]] = None,
        action_prompt: str = "",
        budget: Optional[TokenBudget] = None,
    ):
        self.request_id = uuid.uuid4().hex[:16]
        self.request_time = time.time()
        self._action_prompt = action_prompt  # immutable
        self.user_message = user_message
        self.messages = list(messages or [])
        self.additional_instructions = ""
        self.examples: list[PromptExample] = []
        self.plugin_data: dict[str, Any] = {}
        self.budget = budget or TokenBudget.from_env()
        self._notifications: list[QueuedNotification] = []
        self._note_lock = threading.Lock()
        self._cancelled = False
        self._cancel_reason = ""
        self._cancelled_by = ""
        self.bifrost = None  # set by the manager

    @property
    def action_prompt(self) -> str:
        return self._action_prompt

    # -- cancellation (ref: Cancel types.go:343) ---------------------------
    def cancel(self, reason: str, cancelled_by: str = "") -> None:
        self._cancelled = True
        self._cancel_reason = reason
        self._cancelled_by = cancelled_by

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def cancel_reason(self) -> str:
        return self._cancel_reason

    @property
    def cancelled_by(self) -> str:
        return self._cancelled_by

    # -- notifications (ref: Notify/DrainNotifications types.go:372-412) --
    def notify(self, type_: str, title: str, message: str) -> None:
        with self._note_lock:
            self._notifications.append(
                QueuedNotification(type_, title, message)
            )
        if self.bifrost is not None:
            self.bifrost.broadcast(
                "notification",
                {"type": type_, "title": title, "message": message},
            )

    def notify_info(self, title: str, message: str) -> None:
        self.notify("info", title, message)

    def notify_warning(self, title: str, message: str) -> None:
        self.notify("warning", title, message)

    def notify_error(self, title: str, message: str) -> None:
        self.notify("error", title, message)

    def notify_progress(self, title: str, message: str) -> None:
        self.notify("progress", title, message)

    def drain_notifications(self) -> list[QueuedNotification]:
        with self._note_lock:
            out = self._notifications
            self._notifications = []
        return out

    # -- prompt building (ref: BuildFinalPrompt types.go:513) --------------
    def build_final_prompt(self) -> str:
        full = self._build_full_prompt()
        if estimate_tokens(full) <= self.budget.max_system:
            return full
        return self._build_minimal_prompt()

    def _build_full_prompt(self) -> str:
        parts = [
            "You are Heimdall, the AI assistant for NornicDB - a "
            "high-performance graph database.\n"
            "Your role is to help users manage the database by executing "
            "actions and running Cypher queries.\n",
        ]
        if self._action_prompt:
            parts.append("AVAILABLE ACTIONS:\n" + self._action_prompt + "\n")
        parts.append(CYPHER_PRIMER)
        parts.append(
            "RESPONSE MODES:\n"
            "1. ACTION MODE - For database operations, respond with JSON:\n"
            '   {"action": "status", "params": {}}\n'
            '   {"action": "query", "params": {"cypher": "MATCH (n) RETURN '
            'count(n)"}}\n'
            "2. HELP MODE - For Cypher questions, explain with examples.\n"
            "IMPORTANT: Always complete your JSON responses with proper "
            "closing braces.\n"
        )
        if self.additional_instructions:
            parts.append(
                "ADDITIONAL CONTEXT:\n" + self.additional_instructions + "\n"
            )
        if self.examples:
            ex_lines = ["EXAMPLES:"]
            for ex in self.examples:
                ex_lines.append(f'User: "{ex.user_says}"\n-> {ex.action_json}')
            parts.append("\n".join(ex_lines) + "\n")
        parts.append(
            "Respond with JSON action command only. No explanations, "
            "no markdown.\n"
        )
        return "\n".join(parts)

    def _build_minimal_prompt(self) -> str:
        """(ref: buildMinimalPrompt types.go:581 — actions only)"""
        return (
            "You are Heimdall, AI assistant for NornicDB graph database.\n\n"
            "ACTIONS:\n" + self._action_prompt + "\n"
            'For queries: {"action": "query", "params": {"cypher": "..."}}\n'
            "Respond with JSON only.\n"
        )

    # -- budget info (ref: GetBudgetInfo types.go:688) ---------------------
    def estimated_system_tokens(self) -> int:
        return estimate_tokens(self.build_final_prompt())

    def validate_token_budget(self) -> Optional[str]:
        """Returns an error string when over budget, else None."""
        sys_tokens = self.estimated_system_tokens()
        if sys_tokens > self.budget.max_system:
            return (
                f"system prompt {sys_tokens} tokens exceeds budget "
                f"{self.budget.max_system}"
            )
        user_tokens = estimate_tokens(self.user_message)
        if user_tokens > self.budget.max_user:
            return (
                f"user message {user_tokens} tokens exceeds budget "
                f"{self.budget.max_user}"
            )
        return None

    def budget_info(self) -> dict[str, int]:
        return {
            "max_context": self.budget.max_context,
            "max_system": self.budget.max_system,
            "max_user": self.budget.max_user,
            "estimated_system": self.estimated_system_tokens(),
            "estimated_user": estimate_tokens(self.user_message),
        }
