"""Heimdall plugin system: lifecycle hooks, actions, health, DB monitoring.
A copy of ``nornicdb_tpu/heimdall/plugins.py`` (host code).

Behavioral reference: the upstream NornicDB pkg/heimdall/plugin.go (1,488 LoC —
PrePrompt/PreExecute/PostExecute hooks, plugin lifecycle, health, config
schema) and plugins/heimdall/plugin.go:62-424 (the "Watcher" reference
plugin: hello/status/health/config actions); directory loading mirrors
pkg/nornicdb/plugins.go:56 (Python modules instead of Go .so files).
"""

from __future__ import annotations

import importlib.util
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from nornicdb_tpu_torch.telemetry.metrics import count_error as _count_error

log = logging.getLogger(__name__)


@dataclass
class PluginInfo:
    name: str
    version: str = "0.0.1"
    description: str = ""
    healthy: bool = True
    started_at: float = 0.0


class HeimdallPlugin:
    """Base class for plugins (ref: plugin.go lifecycle interface)."""

    name = "plugin"
    version = "0.0.1"
    description = ""

    # lifecycle ------------------------------------------------------------
    def on_start(self, manager) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def health(self) -> bool:
        return True

    # generation hooks (ref: PrePrompt/PreExecute/PostExecute) -------------
    def pre_prompt(self, prompt: str) -> str:
        return prompt

    def pre_prompt_context(self, ctx) -> None:
        """Mutate the per-request PromptContext: add examples, additional
        instructions, plugin_data; call ctx.cancel() to veto the request
        (ref: PrePrompt receiving *PromptContext, types.go:284)."""

    # observability (ref: Summary/RecentEvents in the plugin interface,
    # plugin.go:162-164, SubsystemEvent :485)
    def summary(self) -> str:
        return self.description

    def recent_events(self, limit: int = 10) -> list[dict]:
        return []

    def pre_execute(self, action: dict[str, Any]) -> Optional[dict[str, Any]]:
        """Return modified action, or None to veto execution."""
        return action

    def post_execute(self, action: dict[str, Any], result: Any) -> Any:
        return result

    # actions --------------------------------------------------------------
    def actions(self) -> dict[str, Callable[[dict], Any]]:
        return {}

    # storage event monitoring (ref: DB event monitoring) ------------------
    def on_db_event(self, kind: str, entity: Any) -> None:
        pass


class PluginHost:
    """Plugin lifecycle manager wired into a HeimdallManager + DB."""

    def __init__(self, manager, db=None):
        self.manager = manager
        manager.plugin_host = self  # surfaced in /api/bifrost/status
        self.db = db
        self._lock = threading.Lock()
        self._plugins: dict[str, HeimdallPlugin] = {}
        self._info: dict[str, PluginInfo] = {}
        if db is not None:
            # storage events flow through the manager's async dispatcher
            # (bounded queue + worker thread — ref: plugin.go:1345
            # dbEventDispatcher), never synchronously in the write path
            dispatcher = getattr(manager, "events", None)
            if dispatcher is not None:
                dispatcher.subscribe(self._deliver_db_event)
                dispatcher.start()
                db.storage.on_event(self._emit_storage_event)
            else:
                db.storage.on_event(self._on_db_event)
        self._install_hooks()

    # -- registration -------------------------------------------------------
    def register(self, plugin: HeimdallPlugin) -> PluginInfo:
        with self._lock:
            self._plugins[plugin.name] = plugin
            info = PluginInfo(
                plugin.name, plugin.version, plugin.description,
                started_at=time.time(),
            )
            self._info[plugin.name] = info
        plugin.on_start(self.manager)
        registered = []
        for action, fn in plugin.actions().items():
            # namespaced always; bare name only when it doesn't clobber a
            # built-in or another plugin's action
            namespaced = f"{plugin.name}.{action}"
            self.manager.register_action(namespaced, fn)
            registered.append(namespaced)
            if action not in self.manager._actions:
                self.manager.register_action(action, fn)
                registered.append(action)
        with self._lock:
            self._registered_actions = getattr(self, "_registered_actions", {})
            self._registered_actions[plugin.name] = registered
        return info

    def unregister(self, name: str) -> None:
        with self._lock:
            plugin = self._plugins.pop(name, None)
            self._info.pop(name, None)
            actions = getattr(self, "_registered_actions", {}).pop(name, [])
        for a in actions:
            self.manager._actions.pop(a, None)
        if plugin is not None:
            plugin.on_stop()

    def load_directory(self, path: str) -> list[PluginInfo]:
        """Load every *.py module exposing PLUGIN (ref: LoadPluginsFromDir
        pkg/nornicdb/plugins.go:56 — Python modules instead of .so)."""
        out = []
        if not os.path.isdir(path):
            return out
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            mod_path = os.path.join(path, fname)
            spec = importlib.util.spec_from_file_location(
                f"heimdall_plugin_{fname[:-3]}", mod_path
            )
            try:
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)  # type: ignore[union-attr]
                plugin = getattr(mod, "PLUGIN", None)
                if isinstance(plugin, HeimdallPlugin):
                    out.append(self.register(plugin))
            except Exception:
                # a broken plugin must not break the host — but a plugin
                # that silently never loads is an operator mystery
                log.warning("heimdall plugin %s failed to load", mod_path,
                            exc_info=True)
                _count_error("heimdall.plugin_load")
                continue
        return out

    # -- status ------------------------------------------------------------
    def plugins(self) -> list[PluginInfo]:
        with self._lock:
            infos = list(self._info.values())
        for info in infos:
            plugin = self._plugins.get(info.name)
            if plugin is not None:
                try:
                    info.healthy = bool(plugin.health())
                except Exception:
                    log.warning("heimdall plugin %s health check failed",
                                info.name, exc_info=True)
                    info.healthy = False
        return infos

    # -- hook plumbing ------------------------------------------------------
    def _install_hooks(self) -> None:
        mgr = self.manager
        mgr.action_dispatcher = self.run_action  # chat-path actions get hooks
        original_generate = mgr.generate

        def apply_pre_prompt(prompt: str) -> str:
            with self._lock:
                plugins = list(self._plugins.values())
            for p in plugins:
                try:
                    prompt = p.pre_prompt(prompt)
                except Exception:
                    # a failing guard plugin falls back to the unmodified
                    # prompt; log it — redaction silently not applying is
                    # exactly what an operator needs to know
                    log.warning("heimdall plugin %s pre_prompt failed",
                                p.name, exc_info=True)
                    _count_error("heimdall.plugin_hook")
            return prompt

        def generate_with_hooks(prompt: str, max_tokens: int = 128,
                                **kwargs) -> str:
            return original_generate(apply_pre_prompt(prompt), max_tokens,
                                     **kwargs)

        mgr.generate = generate_with_hooks  # type: ignore[method-assign]
        # the streaming path builds its own prompt and calls the backend's
        # generate_stream — it must apply the SAME guards (redaction, veto)
        # or stream=true would evade them
        mgr.pre_prompt_transform = apply_pre_prompt

        # PromptContext hooks (ref: PrePrompt with *PromptContext):
        # every plugin gets a chance to mutate/cancel the request context
        def context_hook(ctx) -> None:
            with self._lock:
                plugins = list(self._plugins.values())
            for p in plugins:
                try:
                    p.pre_prompt_context(ctx)
                except Exception:
                    log.warning("heimdall plugin %s pre_prompt_context "
                                "failed", p.name, exc_info=True)
                    _count_error("heimdall.plugin_hook")
                if ctx.cancelled:
                    if not ctx.cancelled_by:
                        ctx.cancel(ctx.cancel_reason, p.name)
                    return

        if hasattr(mgr, "context_hooks"):
            mgr.context_hooks.append(context_hook)

    def run_action(self, action: dict[str, Any]) -> Any:
        """Execute an action through pre/post hooks."""
        with self._lock:
            plugins = list(self._plugins.values())
        for p in plugins:
            try:
                modified = p.pre_execute(action)
            except Exception:
                log.warning("heimdall plugin %s pre_execute failed",
                            p.name, exc_info=True)
                _count_error("heimdall.plugin_hook")
                continue
            if modified is None:
                return {"vetoed_by": p.name}
            action = modified
        fn = self.manager._actions.get(str(action.get("action")))
        result = fn(action.get("params") or {}) if fn else None
        for p in plugins:
            try:
                result = p.post_execute(action, result)
            except Exception:
                log.warning("heimdall plugin %s post_execute failed",
                            p.name, exc_info=True)
                _count_error("heimdall.plugin_hook")
        return result

    def _emit_storage_event(self, kind: str, entity: Any) -> None:
        """Storage callback → typed DatabaseEvent on the async queue
        (non-blocking; drop-on-full matches the reference)."""
        dispatcher = self.manager.events
        if hasattr(entity, "type") and hasattr(entity, "start_node"):
            dispatcher.emit_relationship_event(
                kind, getattr(entity, "id", ""), entity.type,
                entity.start_node, entity.end_node,
            )
        else:
            dispatcher.emit_node_event(
                kind, getattr(entity, "id", ""),
                list(getattr(entity, "labels", []) or []),
            )

    def _deliver_db_event(self, event) -> None:
        """Dispatcher worker → plugin on_db_event(kind, event). Existing
        plugins that only inspect `kind` are unaffected; the payload is
        the typed DatabaseEvent rather than the raw Node/Edge (the async
        boundary must not retain live storage objects)."""
        with self._lock:
            plugins = list(self._plugins.values())
        for p in plugins:
            try:
                p.on_db_event(event.type, event)
            except Exception:
                log.warning("heimdall plugin %s on_db_event failed",
                            p.name, exc_info=True)
                _count_error("heimdall.plugin_event")

    def _on_db_event(self, kind: str, entity: Any) -> None:
        with self._lock:
            plugins = list(self._plugins.values())
        for p in plugins:
            try:
                p.on_db_event(kind, entity)
            except Exception:
                log.warning("heimdall plugin %s on_db_event failed",
                            p.name, exc_info=True)
                _count_error("heimdall.plugin_event")


class WatcherPlugin(HeimdallPlugin):
    """Reference plugin (ref: plugins/heimdall/plugin.go:62-424 'Watcher'):
    hello/status/health/config actions + db event counting."""

    name = "watcher"
    version = "1.0.0"
    description = "Counts DB events and answers hello/status/health/config"

    def __init__(self) -> None:
        self.events: dict[str, int] = {}
        self.config: dict[str, Any] = {"verbose": False}
        self._manager = None

    def on_start(self, manager) -> None:
        self._manager = manager

    def actions(self):
        return {
            "hello": lambda p: {"message": f"hello from {self.name}"},
            "status": lambda p: {"events": dict(self.events)},
            "health": lambda p: {"healthy": self.health()},
            "config": lambda p: (
                self.config.update(p or {}) or dict(self.config)
            ),
        }

    def on_db_event(self, kind: str, entity) -> None:
        self.events[kind] = self.events.get(kind, 0) + 1
