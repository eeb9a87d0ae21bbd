"""Parameters from the JAX package into the port.

``params_from_jax`` takes a JAX model's parameter tree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
``ParamTree`` holding the same values in the same layout;
``stage_params_from_jax`` does the same for one chunk of a pipelined GPT-2
(``train.pipeline.gpt2_stage_modules``).  bf16 leaves
(numpy's ``bfloat16`` extension dtype, which ``torch.from_numpy`` does not
take) go through a ``uint16`` view, so no bit changes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.gpt2 import GPT2Config, gpt2_param_shapes
from .models.llama import LlamaConfig, llama_param_shapes
from .models.params import ParamTree, check_shapes


def tensor_from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # own, writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(tree: Dict[str, object], cfg,
                    device: DeviceLike = None) -> ParamTree:
    """JAX parameter tree (numpy leaves) → the port's ``ParamTree`` on
    ``device`` (the card unless it says "cpu").  Raises if the tree does
    not hold exactly the leaves and shapes of ``cfg``'s family."""
    if isinstance(cfg, GPT2Config):
        shapes = gpt2_param_shapes(cfg)
    elif isinstance(cfg, LlamaConfig):
        shapes = llama_param_shapes(cfg)
    else:
        raise TypeError(f"no conversion for config {type(cfg).__name__}")
    check_shapes(tree, shapes)
    dev = resolve_device(device)
    out = {k: tensor_from_numpy(v, dev) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = {k: tensor_from_numpy(v, dev)
                     for k, v in tree["blocks"].items()}
    return ParamTree(out)


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
