"""nornicdb_tpu_torch.serving — continuous ragged batching for the embed path.

Counterpart of ``nornicdb_tpu.serving``:

* :class:`ServingEngine` / :class:`EngineStats` — the continuous batching
  engine, an :class:`~nornicdb_tpu_torch.embed.base.Embedder` wrapper with
  admission control, deadline shedding, ragged token packing and
  double-buffered host staging (engine.py).
* :class:`RaggedPacker` / :class:`PackedBatch` / :func:`unpack_results` —
  token-concatenated variable-length packing over static shape classes
  (ragged.py).

* :func:`gate_student` — the eval-gated distilled-embedder admission
  check, with :func:`evaluate_embedder` and the suites (student_gate.py).

The Prometheus families (``stats.py``) are not ported yet (ROADMAP). Knobs:
:class:`~nornicdb_tpu_torch.config.ServingConfig` (``NORNICDB_SERVING_*``).
"""

from nornicdb_tpu_torch.serving.engine import EngineStats, ServingEngine
from nornicdb_tpu_torch.serving.ragged import (
    CAPACITY_CLASSES,
    PackedBatch,
    RaggedPacker,
    unpack_results,
)
from nornicdb_tpu_torch.serving.student_gate import (
    builtin_eval_suite,
    evaluate_embedder,
    gate_student,
    load_eval_suite,
)

__all__ = [
    "CAPACITY_CLASSES",
    "EngineStats",
    "PackedBatch",
    "RaggedPacker",
    "ServingEngine",
    "builtin_eval_suite",
    "evaluate_embedder",
    "gate_student",
    "load_eval_suite",
    "unpack_results",
]
