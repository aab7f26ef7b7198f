"""Heimdall's generation backends (counterpart of ``nornicdb_tpu.heimdall``):
the synchronous :class:`QwenGenerator` and the engine-served
:class:`EngineGenerator`. The manager, its action parsing, the Bifrost bus,
the template fallback and the registry are not ported yet (see
``manager.py``)."""

from nornicdb_tpu_torch.heimdall.manager import (
    EngineGenerator,
    Generator,
    QwenGenerator,
)

__all__ = ["EngineGenerator", "Generator", "QwenGenerator"]
