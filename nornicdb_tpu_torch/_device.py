"""Device resolution: every entry point of the port takes ``device=None``,
which means CUDA. Without a card that raises; the CPU is used only when the
caller names it."""

from __future__ import annotations

from typing import Union

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
