"""Carry corpus state from the JAX package into the port.

For this system the state takes the place of a model's weights: the rows,
their validity and the id -> slot layout. Indices must mean the same thing
on both sides, so the slot layout is carried over as it is (no compaction).
Checkpoints written by the JAX ``HostCorpus.save`` load with the port's
``HostCorpus.load`` / ``DeviceCorpus.load`` directly (same ``.npz``
layout).
"""

from __future__ import annotations

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike
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
