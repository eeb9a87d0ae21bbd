"""Batch LLM inference over the Data layer.

Port of ``ray_tpu/llm/batch.py``.  Reference: ray
``python/ray/llm/_internal/batch/`` (the ``Processor`` pipeline applying a
vLLM stage to a Dataset via actor pools).  Here the stage is a stateful UDF
holding a ``TorchLLMEngine``, executed by
``map_batches(compute=ActorPoolStrategy(...))`` so the engine loads once
per actor and blocks stream through.  Each actor leases a card or a share
of one through ``num_gpus``: an actor with no lease sees no card
(``CUDA_VISIBLE_DEVICES`` is empty), so its engine raises unless
``device`` names another device.
"""

from __future__ import annotations

from typing import Optional

from ..device import DeviceLike
from .engine import EngineConfig, SamplingParams, TorchLLMEngine


class _LLMStage:
    """Callable-class UDF: one engine per data-actor."""

    def __init__(self, engine_cfg: Optional[EngineConfig],
                 sampling: Optional[SamplingParams],
                 input_column: str, output_column: str,
                 device: DeviceLike = None):
        self.engine = TorchLLMEngine(engine_cfg or EngineConfig(),
                                     device=device)
        self.sampling = sampling or SamplingParams()
        self.input_column = input_column
        self.output_column = output_column

    def __call__(self, block):
        prompts = [row[self.input_column] for row in block]
        outputs = self.engine.generate(prompts, self.sampling)
        return [
            {**row, self.output_column: out["text"]}
            for row, out in zip(block, outputs)
        ]


def build_llm_processor(
    engine_cfg: Optional[EngineConfig] = None,
    sampling: Optional[SamplingParams] = None,
    *,
    input_column: str = "prompt",
    output_column: str = "generated",
    concurrency: int = 1,
    num_gpus: float = 0,
    device: DeviceLike = None,
):
    """Returns ``fn(Dataset) -> Dataset`` adding ``output_column``.
    ``num_gpus`` leases each of the ``concurrency`` actors a card or a
    share of one; ``device`` is passed to every actor's engine."""
    from ..data import ActorPoolStrategy

    def process(dataset):
        return dataset.map_batches(
            _LLMStage,
            fn_constructor_args=(
                engine_cfg, sampling, input_column, output_column, device
            ),
            compute=ActorPoolStrategy(
                size=concurrency,
                num_gpus=num_gpus,
                num_cpus=1 if not num_gpus else 0,
            ),
        )

    return process
