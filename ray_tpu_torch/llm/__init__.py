"""``ray_tpu_torch.llm`` — LLM serving, port of ``ray_tpu.llm``.

Ported: the slot engine, the tokenizer, the continuous-batching engine
(resident decode loop, per-bucket CUDA graphs, prefix KV cache),
disaggregated prefill and decode over local replicas or GPU-leased actors
(KV pages handed over through the device-object store), and the OpenAI
Serve apps (``build_openai_app``, ``build_disagg_openai_app``), batch
inference over the Data layer's GPU-leased actor pools
(``build_llm_processor``) and the load bench (``bench_llm``).
"""

from .engine import (  # noqa: F401
    EngineConfig,
    EngineStats,
    SamplingParams,
    TorchLLMEngine,
    encode_prompt,
)
from .serve_app import build_disagg_openai_app, build_openai_app  # noqa: F401
from .batch import build_llm_processor  # noqa: F401
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
