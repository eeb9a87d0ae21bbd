"""``ray_tpu_torch.llm`` — LLM serving, port of ``ray_tpu.llm``.

This slice ports the engine and the tokenizer; the continuous-batching
engine, disaggregated serving, the Serve app and batch inference follow.
"""

from .engine import (  # noqa: F401
    EngineConfig,
    EngineStats,
    SamplingParams,
    TorchLLMEngine,
    encode_prompt,
)
from .tokenizer import ByteTokenizer  # noqa: F401
