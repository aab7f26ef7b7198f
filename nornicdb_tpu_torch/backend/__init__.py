"""nornicdb_tpu_torch.backend: the process's device owner for CUDA.

A port of ``nornicdb_tpu/backend``. Public surface:

* :func:`manager` — the process-default :class:`BackendManager` (created
  lazily; honors ``NORNICDB_FAKE_BACKEND`` fault injection and the
  ``BackendConfig`` applied via :func:`configure`, layered over the
  environment's ``NORNICDB_BACKEND_*`` / ``NORNICDB_DEVICE_*``).
* :func:`configure` — apply a ``config.BackendConfig`` before the default
  manager is first created.
* :func:`devices` — the CUDA devices as ``torch.device``, after a bounded
  wait for the owner to acquire the card, so no caller cold-inits CUDA on
  its own thread.
* :func:`manager_stats` — stats dict or None when nothing started one.

* :func:`gate` — the one gate every CUDA consumer runs before it takes a
  lock.

The port's policy is ``"fail"`` and nothing else: a card that is not
serving raises ``DeviceUnavailable`` within ``acquire_timeout``, and no
request that was meant for the card runs on the host. A caller that wants
the CPU builds its objects with ``device="cpu"``; such a consumer never
creates or consults a manager. ``BackendConfig.fallback`` is parsed for
config-file compatibility with the JAX package, and any value but
``"fail"`` is refused when the default manager is made.
"""

from __future__ import annotations

import threading
from typing import Optional

from nornicdb_tpu_torch.backend.manager import (
    BackendManager,
    DEGRADED_CPU,
    FakeHooks,
    PROBING,
    READY,
    RECOVERING,
    RealHooks,
    STATES,
    hooks_from_env,
)
from nornicdb_tpu_torch.errors import BackendLockHeldError, DeviceUnavailable

__all__ = [
    "BackendManager", "BackendLockHeldError", "DeviceUnavailable",
    "FakeHooks", "RealHooks", "hooks_from_env",
    "PROBING", "READY", "DEGRADED_CPU", "RECOVERING", "STATES",
    "manager", "configure", "devices", "gate", "manager_stats",
    "reset_default",
]

_default: Optional[BackendManager] = None
_default_kwargs: dict = {}
_mu = threading.Lock()

_CFG_FIELDS = (
    "acquire_timeout", "probe_interval", "probe_timeout",
    "probe_latency_threshold", "degrade_after", "recover_after",
)


def _check_policy(fallback) -> None:
    """The port serves a CUDA request from the card or raises: a config
    that names another fallback policy (the JAX package's ``"cpu"``) is
    refused, not silently read as ``"fail"``."""
    if fallback not in (None, "fail"):
        raise ValueError(
            f"backend fallback {fallback!r} is not supported: the port "
            "raises DeviceUnavailable for a card that is not serving; "
            "build with device='cpu' to run on the CPU"
        )


def configure(cfg=None, **overrides) -> None:
    """Set construction kwargs for the process-default manager.  ``cfg``
    is a ``config.BackendConfig`` (or any object with matching attrs);
    keyword overrides win.  Must run before the first :func:`manager`
    call to take effect."""
    global _default_kwargs
    kwargs: dict = {}
    if cfg is not None:
        _check_policy(getattr(cfg, "fallback", None))
        for name in _CFG_FIELDS:
            if hasattr(cfg, name):
                kwargs[name] = getattr(cfg, name)
    kwargs.update(overrides)
    with _mu:
        _default_kwargs = kwargs


def manager() -> BackendManager:
    """The process-default manager (lazily created; publishes metrics).
    Construction kwargs come from :func:`configure` when it ran, layered
    over the env-derived ``BackendConfig`` (NORNICDB_BACKEND_* /
    NORNICDB_DEVICE_* variables), so embedded and test processes that
    never call ``cli serve`` still honor the environment."""
    global _default
    with _mu:
        if _default is None:
            from nornicdb_tpu_torch.config import AppConfig, load_from_env

            base = load_from_env(AppConfig()).backend
            _check_policy(base.fallback)
            kwargs = {name: getattr(base, name) for name in _CFG_FIELDS}
            kwargs.update(_default_kwargs)
            _default = BackendManager(publish=True, **kwargs)
        return _default


def manager_stats() -> Optional[dict]:
    """Stats for the default manager, or None if nothing created one yet
    (observability surfaces must not force backend management to start)."""
    with _mu:
        mgr = _default
    return None if mgr is None else mgr.stats()


def reset_default() -> None:
    """Drop the process-default manager (tests).  The old manager's
    threads are stopped; corpora registered with it re-register on their
    next device gate."""
    global _default
    with _mu:
        mgr, _default = _default, None
    if mgr is not None:
        mgr.stop()


def devices(timeout: Optional[float] = None) -> list:
    """The CUDA devices as ``torch.device("cuda", i)``, after a bounded
    wait for the default manager to acquire the card (on its own thread).
    Raises :class:`DeviceUnavailable` when the card is not serving."""
    mgr = manager()
    if not mgr.await_ready(timeout):
        raise DeviceUnavailable(
            f"backend {mgr.state}: device list unavailable"
        )
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def gate(device, backend: Optional[BackendManager] = None,
         timeout: Optional[float] = None) -> Optional[BackendManager]:
    """The consumers' one gate, run before they take a lock. Returns the
    manager that owns ``device`` (``backend`` when the caller injected
    one, else the process default for a CUDA device) once the card
    serves, and raises :class:`DeviceUnavailable` when it does not
    (bounded by ``timeout``, else the manager's ``acquire_timeout``). A CPU
    consumer with no injected manager returns None at once and never
    creates one."""
    on_cuda = getattr(device, "type", device) == "cuda"
    if on_cuda:
        import torch

        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
    mgr = backend
    if mgr is None:
        if not on_cuda:
            return None
        mgr = manager()
    mgr.require_ready(timeout)
    return mgr
