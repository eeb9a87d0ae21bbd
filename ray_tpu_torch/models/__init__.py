"""Model families of the port, and the registry that makes the LLM engine
model-agnostic — port of ``ray_tpu/models/__init__.py``.  ``param_axes``
is each family's logical sharding tree, for ``parallel.shard_pytree``.
The MLP, ResNet, ViT and the MoE LM are exported beside them and, as in
the JAX package, registered as no ``ModelFamily``: none of them decodes."""

import dataclasses as _dataclasses
from typing import Any as _Any, Callable as _Callable

from .gpt2 import (  # noqa: F401
    GPT2Config,
    gpt2_apply,
    gpt2_hidden,
    gpt2_init,
    gpt2_loss,
    gpt2_param_axes,
)
from .gpt2_decode import (  # noqa: F401
    gpt2_decode_multi,
    gpt2_decode_step,
    gpt2_init_cache,
    gpt2_prefill,
    sample_logits,
)
from .llama import (  # noqa: F401
    LlamaConfig,
    llama_apply,
    llama_init,
    llama_loss,
    llama_param_axes,
)
from .llama_decode import (  # noqa: F401
    llama_decode_step,
    llama_init_cache,
    llama_prefill,
)
from .params import ParamList, ParamTree  # noqa: F401
from .mlp import mlp_apply, mlp_init  # noqa: F401
from .moe import (  # noqa: F401
    MoEConfig,
    moe_apply,
    moe_ffn,
    moe_init,
    moe_loss,
    moe_param_axes,
)
from .resnet import (  # noqa: F401
    ResNetConfig,
    resnet_apply,
    resnet_init,
    resnet_loss,
    resnet_param_axes,
)
from .vit import (  # noqa: F401
    ViTConfig,
    patchify,
    vit_apply,
    vit_init,
    vit_loss,
    vit_param_axes,
)


@_dataclasses.dataclass(frozen=True)
class ModelFamily:
    """Uniform train + serve surface over a model architecture."""

    name: str
    init: _Callable  # (gen, cfg, device=None) -> ParamTree
    apply: _Callable  # (params, tokens, cfg, mesh=None) -> logits
    loss: _Callable  # (params, tokens, cfg, mesh=None, ...) -> scalar
    param_axes: _Callable  # () -> logical sharding tree
    init_cache: _Callable  # (cfg, batch, max_len, device=None) -> cache
    prefill: _Callable  # (params, tokens, lengths, cache, cfg)
    decode_step: _Callable  # (params, tokens, pos, cache, cfg)


_FAMILIES = {}


def register_model_family(config_cls, family: ModelFamily) -> None:
    _FAMILIES[config_cls] = family


def model_family(cfg: _Any) -> ModelFamily:
    """Resolve the ModelFamily for a model config instance."""
    for cls, fam in _FAMILIES.items():
        if isinstance(cfg, cls):
            return fam
    raise TypeError(
        f"no registered model family for config type {type(cfg).__name__}"
    )


register_model_family(
    GPT2Config,
    ModelFamily(
        name="gpt2",
        init=gpt2_init,
        apply=gpt2_apply,
        loss=gpt2_loss,
        param_axes=gpt2_param_axes,
        init_cache=gpt2_init_cache,
        prefill=gpt2_prefill,
        decode_step=gpt2_decode_step,
    ),
)
register_model_family(
    LlamaConfig,
    ModelFamily(
        name="llama",
        init=llama_init,
        apply=llama_apply,
        loss=llama_loss,
        param_axes=llama_param_axes,
        init_cache=llama_init_cache,
        prefill=llama_prefill,
        decode_step=llama_decode_step,
    ),
)
