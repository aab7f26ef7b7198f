"""Models of the port (counterpart of ``nornicdb_tpu.models``): the Qwen2
decoder of the generation slice, the bge-m3 encoder of the embed slice,
their layers and the tokenizers. ``init_params`` is Qwen2's; bge-m3's is
``bge_m3.init_params``."""

from nornicdb_tpu_torch.models.bge_m3 import (
    BGE_DISTILL_6L,
    BGE_DISTILL_12L_512,
    BGE_M3,
    BGE_SMALL,
    BgeConfig,
)
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
    "BGE_DISTILL_12L_512",
    "BGE_DISTILL_6L",
    "BGE_M3",
    "BGE_SMALL",
    "BgeConfig",
    "QWEN25_05B",
    "QWEN_SMALL",
    "HFTokenizer",
    "HashTokenizer",
    "QwenConfig",
    "init_params",
    "load_tokenizer",
]
