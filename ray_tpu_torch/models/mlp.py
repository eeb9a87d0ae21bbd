"""Minimal MLP (the fashion-MNIST / smoke-test model of north-star
config #1) — port of ``ray_tpu/models/mlp.py``.  Its parameters are the
JAX list of ``{"w" [fan_in, fan_out], "b" [fan_out]}`` in f32, held by a
``ParamList``; ReLU between layers."""

from __future__ import annotations

from typing import Sequence

import torch

from ..device import DeviceLike, resolve_device
from .params import ParamList, normal


def mlp_param_shapes(sizes: Sequence[int]):
    return [{"w": (fan_in, fan_out), "b": (fan_out,)}
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:])]


def mlp_init(gen: torch.Generator, sizes: Sequence[int],
             device: DeviceLike = None) -> ParamList:
    """He-normal weights (scale sqrt(2 / fan_in)) drawn from ``gen`` and
    zero biases, on ``device`` (the card unless it says "cpu")."""
    dev = resolve_device(device)
    return ParamList([
        {"w": normal(gen, shape["w"], (2.0 / shape["w"][0]) ** 0.5,
                     torch.float32, dev),
         "b": torch.zeros(shape["b"], dtype=torch.float32, device=dev)}
        for shape in mlp_param_shapes(sizes)])


def mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x
