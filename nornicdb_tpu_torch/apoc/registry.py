"""APOC function registry.

Behavioral reference: upstream NornicDB apoc/apoc.go:121 (Call),
registry/registry.go:44-120 (central registry), category env gates
(apoc/config.go: NORNICDB_APOC_<CATEGORY>_ENABLED).

The port's copy of ``nornicdb_tpu/apoc/registry.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

_REGISTRY: dict[str, Callable] = {}
_CATEGORIES: dict[str, set[str]] = {}
_lock = threading.Lock()


def register(name: str, category: Optional[str] = None):
    """Register an apoc.* function. Name is the full dotted name."""
    cat = category or name.split(".")[1] if name.count(".") >= 1 else "util"

    def deco(fn):
        with _lock:
            _REGISTRY[name.lower()] = fn
            _CATEGORIES.setdefault(cat, set()).add(name.lower())
        return fn

    return deco


def category_enabled(category: str) -> bool:
    """(ref: apoc/config.go env gates — enabled by default here)"""
    env = os.environ.get(f"NORNICDB_APOC_{category.upper()}_ENABLED")
    if env is None:
        return True
    return env.lower() not in ("0", "false", "no")


def lookup(name: str) -> Optional[Callable]:
    """(ref: apoc.Call apoc.go:121 -> callFunction :1386)"""
    fn = _REGISTRY.get(name.lower())
    if fn is None:
        return None
    parts = name.lower().split(".")
    if len(parts) >= 2 and not category_enabled(parts[1]):
        return None
    return fn


def call(name: str, *args: Any) -> Any:
    fn = lookup(name)
    if fn is None:
        raise KeyError(f"unknown apoc function {name}")
    return fn(*args)


def all_functions() -> list[str]:
    with _lock:
        return sorted(_REGISTRY)


def categories() -> dict[str, int]:
    with _lock:
        return {c: len(fns) for c, fns in sorted(_CATEGORIES.items())}
