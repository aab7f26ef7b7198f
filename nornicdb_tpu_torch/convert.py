"""Carry state from the JAX package into the port: corpus state (search),
Qwen2 parameters (generation), bge-m3 parameters (embedding) and the
cross-encoder's parameters and head (rerank).

For the search tier the state takes the place of a model's weights: the rows,
their validity and the id -> slot layout. Indices must mean the same thing
on both sides, so the slot layout is carried over as it is (no compaction).
Checkpoints written by the JAX ``HostCorpus.save`` load with the port's
``HostCorpus.load`` / ``DeviceCorpus.load`` directly (same ``.npz``
layout).
"""

from __future__ import annotations

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, map_tree, resolve_device
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus


def corpus_from_jax_state(state: dict, device: DeviceLike = None,
                          **kwargs) -> DeviceCorpus:
    """A port DeviceCorpus with the same slot layout as the corpus whose
    ``export_host_state()`` gave ``state`` (numpy ``rows``, ``valid``,
    ``ids`` with None for tombstones, ``dims``). Extra kwargs go to
    DeviceCorpus (``quantize``, ``compact_ratio``)."""
    rows = np.asarray(state["rows"], np.float32)
    valid = np.asarray(state["valid"], bool)
    ids = list(state["ids"])
    dims = int(state["dims"])
    if rows.shape != (valid.shape[0], dims) or len(ids) > rows.shape[0]:
        raise ValueError("inconsistent corpus state")
    out = DeviceCorpus(dims=dims, capacity=rows.shape[0], device=device,
                       **kwargs)
    if out.capacity != rows.shape[0]:
        raise ValueError(
            f"capacity {rows.shape[0]} is not a multiple of {out.align}")
    with out._sync_lock:
        out._host = rows.copy()
        out._valid = valid.copy()
        out._ids = ids
        out._slot_of = {id_: s for s, id_ in enumerate(ids) if id_ is not None}
        out._tombstones = len(ids) - len(out._slot_of)
        out._mark_all_dirty()
        out._epoch += 1
    return out


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # bits over as int16 and reinterpret them (bit-exact)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(arr).to(device)


def _params_from_jax(params, device: DeviceLike) -> dict:
    """The JAX parameter pytree given as numpy arrays
    (``jax.tree.map(np.asarray, params)``) as the port's: the same nested
    dict/list layout, each leaf a tensor of the same dtype and bits (dense
    weights stay ``(in, out)``) on ``device``."""
    dev = resolve_device(device)
    return map_tree(lambda a: _leaf_to_torch(a, dev), params)


def qwen2_params_from_jax(params, device: DeviceLike = None) -> dict:
    """The port's Qwen2 parameters from the JAX ones (``_params_from_jax``)."""
    return _params_from_jax(params, device)


def bge_params_from_jax(params, device: DeviceLike = None) -> dict:
    """The port's bge-m3 parameters from the JAX ones
    (``_params_from_jax``)."""
    return _params_from_jax(params, device)


def reranker_params_from_jax(params, head, device: DeviceLike = None
                             ) -> tuple[dict, dict]:
    """The port's cross-encoder weights from the JAX ``CrossEncoderReranker``'s
    ``params`` and ``head`` given as numpy arrays: ``(params, head)`` for
    ``search.rerank.CrossEncoderReranker(params=..., head=...)``, every leaf
    with the same dtype and bits."""
    return _params_from_jax(params, device), _params_from_jax(head, device)
