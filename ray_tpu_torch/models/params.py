"""Parameter trees in the JAX package's layout, held by an ``nn.Module``.

A JAX model's params are a dict of top-level leaves plus ``"blocks"``, a
dict of layer-stacked leaves (``wq [L, E, H, D]``, ``wo [L, H, D, E]``...).
``ParamTree`` keeps exactly that layout, so converting from JAX is a copy,
never a transpose, and the model code indexes it as the JAX code does:
``params["wte"]``, ``params["blocks"]["wq"][l]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

Shapes = Dict[str, object]  # name -> shape tuple, and "blocks" -> {name: shape}


class ParamTree(nn.Module):
    """Parameters in the JAX tree's layout, frozen (``requires_grad=False``)
    as they are made; a trainer unfreezes them with
    ``params.requires_grad_(True)``."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for name, value in tree.items():
            if name == "blocks":
                self.blocks = nn.ParameterDict({
                    k: nn.Parameter(v, requires_grad=False)
                    for k, v in value.items()
                })
            else:
                setattr(self, name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def layer(self, index: int) -> Dict[str, torch.Tensor]:
        """The ``index``-th slice of every layer-stacked leaf (views)."""
        return {k: v[index] for k, v in self.blocks.items()}


def check_shapes(tree: Dict[str, object], shapes: Shapes) -> None:
    """Raise unless ``tree`` holds exactly the leaves of ``shapes``."""

    def walk(t, s, prefix) -> None:
        if set(t) != set(s):
            raise ValueError(
                f"{prefix or 'params'}: leaves {sorted(t)} != {sorted(s)}"
            )
        for k, want in s.items():
            if isinstance(want, dict):
                walk(t[k], want, f"{prefix}{k}.")
            elif tuple(t[k].shape) != tuple(want):
                raise ValueError(
                    f"{prefix}{k}: shape {tuple(t[k].shape)} != {want}"
                )

    walk(tree, shapes, "")


def normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, scale²) drawn on the generator's device, cast, then moved."""
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(dtype=dtype, device=device)
