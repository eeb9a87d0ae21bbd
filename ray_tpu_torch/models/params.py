"""Parameter trees in the JAX package's layout, held by an ``nn.Module``.

A JAX model's params are a pytree: GPT-2's is a dict of top-level leaves
plus ``"blocks"``, a dict of layer-stacked leaves (``wq [L, E, H, D]``,
``wo [L, H, D, E]``...); ResNet's nests deeper (``{"stem": {"w", "bn":
{"g", "b"}}, "stage0": [block dicts...], "head": {...}}``) and the MLP's
is a list of ``{"w", "b"}``.  ``ParamTree`` keeps exactly that layout —
a dict of leaves only becomes an ``nn.ParameterDict``, a dict with nested
entries a ``ParamTree``, a list a ``ParamList`` — so converting from JAX
is a copy, never a transpose, and the model code indexes it as the JAX
code does: ``params["wte"]``, ``params["blocks"]["wq"][l]``,
``params["stage0"][1]["conv2"]["bn"]["g"]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

Shapes = Dict[str, object]  # name -> shape tuple, dict or list of them


def _node(value):
    """A tree node as a module (or, for a leaf, a frozen parameter)."""
    if isinstance(value, dict):
        if all(isinstance(v, torch.Tensor) for v in value.values()):
            return nn.ParameterDict({
                k: nn.Parameter(v, requires_grad=False)
                for k, v in value.items()})
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return ParamList(value)
    return nn.Parameter(value, requires_grad=False)


class ParamTree(nn.Module):
    """Parameters in the JAX tree's layout, frozen (``requires_grad=False``)
    as they are made; a trainer unfreezes them with
    ``params.requires_grad_(True)``."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        self._keys = list(tree)
        for name, value in tree.items():
            setattr(self, name, _node(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._keys

    def __iter__(self):
        return iter(self._keys)

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def layer(self, index: int) -> Dict[str, torch.Tensor]:
        """The ``index``-th slice of every layer-stacked leaf (views)."""
        return {k: v[index] for k, v in self.blocks.items()}

    def tree(self):
        """The tree as nested dicts and lists of its parameters."""
        return as_tree(self)


class ParamList(nn.ModuleList):
    """A list node of a ``ParamTree`` (ResNet's blocks of a stage, the
    MLP's layers): each entry a ``ParamTree`` or ``nn.ParameterDict``."""

    def __init__(self, items):
        super().__init__([_node(v) for v in items])

    def tree(self):
        return as_tree(self)


def as_tree(node):
    """A ``ParamTree`` node (or a tree of tensors) as nested dicts and
    lists of its tensors."""
    if isinstance(node, (ParamTree, nn.ParameterDict, dict)):
        return {k: as_tree(v) for k, v in node.items()}
    if isinstance(node, (nn.ModuleList, list, tuple)):
        return [as_tree(v) for v in node]
    return node


def map_tree(fn, tree):
    """``fn`` over every leaf of nested dicts and lists (a pytree map)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def check_shapes(tree, shapes: Shapes) -> None:
    """Raise unless ``tree`` holds exactly the leaves of ``shapes``."""

    def walk(t, s, prefix) -> None:
        where = prefix.rstrip(".") or "params"
        if isinstance(s, dict):
            if not isinstance(t, dict) or set(t) != set(s):
                got = sorted(t) if isinstance(t, dict) else type(t).__name__
                raise ValueError(f"{where}: leaves {got} != {sorted(s)}")
            for k, want in s.items():
                walk(t[k], want, f"{prefix}{k}.")
        elif isinstance(s, list):
            if not isinstance(t, (list, tuple)) or len(t) != len(s):
                raise ValueError(f"{where}: not a list of {len(s)}")
            for i, want in enumerate(s):
                walk(t[i], want, f"{prefix}{i}.")
        elif tuple(t.shape) != tuple(s):
            raise ValueError(f"{where}: shape {tuple(t.shape)} != {s}")

    walk(tree, shapes, "")


def normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, scale²) drawn on the generator's device, cast, then moved."""
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(dtype=dtype, device=device)
