"""Models of the port (counterpart of ``nornicdb_tpu.models``): the Qwen2
decoder of the generation slice, its layers and the tokenizers."""

from nornicdb_tpu_torch.models.qwen2 import (
    QWEN25_05B,
    QWEN_SMALL,
    QwenConfig,
    init_params,
)
from nornicdb_tpu_torch.models.tokenizer import (
    HashTokenizer,
    HFTokenizer,
    load_tokenizer,
)

__all__ = [
    "QWEN25_05B",
    "QWEN_SMALL",
    "HFTokenizer",
    "HashTokenizer",
    "QwenConfig",
    "init_params",
    "load_tokenizer",
]
