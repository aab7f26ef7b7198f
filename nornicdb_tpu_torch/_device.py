"""Device resolution: every entry point of the port takes ``device=None``,
which means CUDA. Without a card that raises; the CPU is used only when the
caller names it. Also the walk over parameter trees (nested dicts and lists
of tensors) that moves a model's weights."""

from __future__ import annotations

from typing import Any, Callable, Union

import torch

from nornicdb_tpu_torch.errors import DeviceUnavailable

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise DeviceUnavailable when CUDA is asked for
    and absent. Never picks the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def map_tree(fn: Callable[[Any], Any], tree):
    """``tree`` with ``fn`` applied to every leaf: dicts, lists and tuples
    are walked and kept as they are, anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_to(tree, device: torch.device):
    """The parameter tree with every tensor on ``device`` (no copy for one
    already there)."""
    return map_tree(lambda t: t.to(device), tree)
