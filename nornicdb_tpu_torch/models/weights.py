"""Model weight I/O: a minimal safetensors reader and writer (no external
dependencies), the port's copy of ``nornicdb_tpu/models/weights.py``.

safetensors layout: [8-byte LE header length][JSON header][raw tensor bytes].
The header and the encodings are the JAX package's, so a file either package
writes loads on the other bit for bit. bf16 is written as
``(u32 + 0x8000) >> 16`` of the float32 value, as the JAX package writes it
(exact for a value that is already bf16), and read back as ``torch.bfloat16``
from its bits: numpy has no bf16 type, so the bits travel as int16.
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_NUMPY = {
    torch.float64: np.float64, torch.float32: np.float32,
    torch.float16: np.float16, torch.int64: np.int64, torch.int32: np.int32,
    torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.bool: np.bool_,
}

# leaves derived from others at load time (``qwen2.with_f32_logit_weights``
# adds the float32 copy of the tied embedding): never written, never read
_DERIVED = frozenset({"tok_emb_f32"})


def _f32_to_bf16_bytes(arr: np.ndarray) -> bytes:
    u32 = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    return ((u32 + 0x8000) >> 16).astype(np.uint16).tobytes()


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _f32_to_bf16_bytes(t.float().numpy())
    return t.numpy().tobytes()


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the file as a CPU tensor of the file's dtype."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = f.read()
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt, shape = meta["dtype"], meta["shape"]
        start, end = meta["data_offsets"]
        if dt not in _DTYPES:
            raise ValueError(f"unsupported safetensors dtype {dt} ({name})")
        dtype = _DTYPES[dt]
        raw = data[start:end]
        if dtype == torch.bfloat16:
            arr = np.frombuffer(raw, dtype=np.int16).copy()
            t = torch.from_numpy(arr).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.frombuffer(raw, dtype=_NUMPY[dtype]).copy())
        out[name] = t.reshape(shape)
    return out


def save_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    header: dict[str, Any] = {}
    blobs: list[bytes] = []
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(
                f"unsupported dtype for safetensors: {t.dtype} ({name})")
        blob = _tensor_bytes(t)
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


def flatten_params(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """Parameter tree -> flat {"a.b.0.w": tensor} for checkpointing, in the
    tree's order. Derived leaves (``tok_emb_f32``) are left out, so a tree
    that holds them saves the same names as the JAX package's."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k not in _DERIVED:
                    walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            out[path] = node

    walk(params, prefix)
    return out


def unflatten_params(flat: dict[str, torch.Tensor], template,
                     device: torch.device):
    """The flat tensors on the structure, dtypes and shapes of ``template``,
    on ``device`` (derived leaves of the template are left out)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items() if k not in _DERIVED}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        return flat[path].to(device=device, dtype=node.dtype).reshape(
            node.shape)

    return walk(template, "")


def save_params(path: str, params) -> None:
    save_safetensors(path, flatten_params(params))


def load_params(path: str, template, device: DeviceLike = None):
    """The parameters of the file at ``path`` on the structure of
    ``template``, on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return unflatten_params(load_safetensors(path), template, dev)
