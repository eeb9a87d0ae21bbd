"""Parameters from the JAX package into the port.

``params_from_jax`` takes a JAX model's parameter tree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
``ParamTree`` holding the same values in the same layout (GPT-2, Llama,
ViT and the MoE LM); ``resnet_params_from_jax`` does the same for ResNet's
``(params, state)``, ``mlp_params_from_jax`` for the MLP's list of layers,
and ``stage_params_from_jax`` for one chunk of a pipelined GPT-2
(``train.pipeline.gpt2_stage_modules``).  bf16 leaves
(numpy's ``bfloat16`` extension dtype, which ``torch.from_numpy`` does not
take) go through a ``uint16`` view, so no bit changes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.gpt2 import GPT2Config, gpt2_param_shapes
from .models.llama import LlamaConfig, llama_param_shapes
from .models.mlp import mlp_param_shapes
from .models.moe import MoEConfig, moe_param_shapes
from .models.params import ParamList, ParamTree, check_shapes, map_tree
from .models.resnet import ResNetConfig, resnet_param_shapes
from .models.vit import ViTConfig, vit_param_shapes


def tensor_from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # own, writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


_SHAPES = ((GPT2Config, gpt2_param_shapes), (LlamaConfig, llama_param_shapes),
           (ViTConfig, vit_param_shapes), (MoEConfig, moe_param_shapes))


def _tensors(tree, device: torch.device):
    return map_tree(lambda a: tensor_from_numpy(a, device), tree)


def params_from_jax(tree: Dict[str, object], cfg,
                    device: DeviceLike = None) -> ParamTree:
    """JAX parameter tree (numpy leaves) → the port's ``ParamTree`` on
    ``device`` (the card unless it says "cpu").  Raises if the tree does
    not hold exactly the leaves and shapes of ``cfg``'s model."""
    shapes = next((fn(cfg) for cls, fn in _SHAPES if isinstance(cfg, cls)),
                  None)
    if shapes is None:
        raise TypeError(f"no conversion for config {type(cfg).__name__}")
    check_shapes(tree, shapes)
    return ParamTree(_tensors(tree, resolve_device(device)))


def resnet_params_from_jax(params: Dict[str, object],
                           state: Dict[str, object], cfg: ResNetConfig,
                           device: DeviceLike = None
                           ) -> Tuple[ParamTree, Dict[str, object]]:
    """JAX ``resnet_init``'s ``(params, state)`` (numpy leaves) → the
    port's ``(ParamTree, state tree of tensors)`` on ``device``.  Raises
    unless both trees hold exactly ``cfg``'s leaves and shapes."""
    shapes, state_shapes = resnet_param_shapes(cfg)
    check_shapes(params, shapes)
    check_shapes(state, state_shapes)
    dev = resolve_device(device)
    return ParamTree(_tensors(params, dev)), _tensors(state, dev)


def mlp_params_from_jax(params: List[Dict[str, object]], sizes: Sequence[int],
                        device: DeviceLike = None) -> ParamList:
    """JAX ``mlp_init(key, sizes)``'s list of layers (numpy leaves) → the
    port's ``ParamList`` on ``device``."""
    check_shapes(params, mlp_param_shapes(sizes))
    return ParamList(_tensors(params, resolve_device(device)))


def stage_params_from_jax(tree: Dict[str, object], cfg: GPT2Config, v: int,
                          total_virtual: int,
                          device: DeviceLike = None) -> Dict[str, object]:
    """A JAX pipeline chunk's parameters (numpy leaves, as
    ``gpt2_stage_modules(cfg, total_virtual)(v, total_virtual).init(key)``
    returns them) → the port chunk's tree of tensors on ``device`` (the
    card unless it says "cpu").  Raises unless the tree holds exactly the
    leaves and shapes chunk ``v`` owns: its layers' slice of every block
    leaf, ``wte`` and ``wpe`` on the first chunk, ``lnf_*`` and the untied
    ``unembed`` on the last."""
    if not isinstance(cfg, GPT2Config):
        raise TypeError(f"no stage conversion for {type(cfg).__name__}")
    if not 0 <= v < total_virtual <= cfg.n_layer:
        raise ValueError(
            f"no chunk {v} of {cfg.n_layer} layers in {total_virtual}")
    lo = cfg.n_layer * v // total_virtual
    hi = cfg.n_layer * (v + 1) // total_virtual
    full = gpt2_param_shapes(cfg)
    shapes: Dict[str, object] = {"blocks": {
        k: (hi - lo,) + tuple(s[1:]) for k, s in full["blocks"].items()}}
    if v == 0:
        shapes.update(wte=full["wte"], wpe=full["wpe"])
    if v == total_virtual - 1:
        shapes.update(lnf_g=full["lnf_g"], lnf_b=full["lnf_b"],
                      unembed=full["wte"])
    check_shapes(tree, shapes)
    dev = resolve_device(device)
    out: Dict[str, object] = {k: tensor_from_numpy(a, dev)
                              for k, a in tree.items() if k != "blocks"}
    out["blocks"] = {k: tensor_from_numpy(a, dev)
                     for k, a in tree["blocks"].items()}
    return out
