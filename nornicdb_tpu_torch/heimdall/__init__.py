"""Heimdall, the assistant (counterpart of ``nornicdb_tpu.heimdall``): the
generators that run the model on the card (``QwenGenerator``,
``EngineGenerator``) or answer without one (``TemplateGenerator``), the
``HeimdallManager`` with its chat completions and actions, the prompt
context, the model and metrics registries and the plugin host
(``heimdall.plugins``). ``DB.heimdall`` builds the manager."""

from nornicdb_tpu_torch.heimdall.context import (
    CYPHER_PRIMER,
    GenerateParams,
    PromptContext,
    PromptExample,
    TokenBudget,
    estimate_tokens,
)
from nornicdb_tpu_torch.heimdall.manager import (
    Bifrost,
    EngineGenerator,
    Generator,
    HeimdallManager,
    HeimdallMetrics,
    QwenGenerator,
    TemplateGenerator,
)
from nornicdb_tpu_torch.heimdall.registry import (
    MODEL_CLASSIFICATION,
    MODEL_EMBEDDING,
    MODEL_REASONING,
    DatabaseEvent,
    EventDispatcher,
    MetricsRegistry,
    ModelInfo,
    ModelRegistry,
)

__all__ = [
    "Bifrost", "EngineGenerator", "Generator", "HeimdallManager",
    "HeimdallMetrics", "QwenGenerator", "TemplateGenerator",
    "PromptContext", "PromptExample", "TokenBudget", "GenerateParams",
    "CYPHER_PRIMER", "estimate_tokens",
    "ModelInfo", "ModelRegistry", "MetricsRegistry",
    "DatabaseEvent", "EventDispatcher",
    "MODEL_EMBEDDING", "MODEL_REASONING", "MODEL_CLASSIFICATION",
]
