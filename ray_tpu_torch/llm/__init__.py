"""``ray_tpu_torch.llm`` — LLM serving, port of ``ray_tpu.llm``.

Ported: the slot engine, the tokenizer, the continuous-batching engine
(resident decode loop, per-bucket CUDA graphs, prefix KV cache) and the
in-process half of disaggregated serving.  The Serve app, batch inference
and the load bench wait for the runtime's port (ROADMAP A3).
"""

from .engine import (  # noqa: F401
    EngineConfig,
    EngineStats,
    SamplingParams,
    TorchLLMEngine,
    encode_prompt,
)
from .tokenizer import ByteTokenizer  # noqa: F401
from .disagg import (  # noqa: F401
    DecodeReplica,
    DisaggRouter,
    PrefillEngine,
    PrefillReplica,
)
from .continuous_batching import (  # noqa: F401
    BatchedDecodeReplica,
    ContinuousBatchingConfig,
    ContinuousBatchingEngine,
)
