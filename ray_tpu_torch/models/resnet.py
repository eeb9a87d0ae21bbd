"""ResNet family (ResNet-18/50) — north-star config #2, data-parallel
ResNet-50; port of ``ray_tpu/models/resnet.py``.

As in the JAX package: activations NHWC and filters HWIO (the
convolution is ``F.conv2d`` on channels-last views of them, as JAX's is
``lax.conv_general_dilated`` outside any Pallas kernel), bf16 params and
activations with f32 batch-norm statistics, and a functional batch norm:
``resnet_apply`` returns ``(logits, new_state)``, the running statistics a
separate tree of f32 ``mean``/``var``.  Two details of XLA are kept:
``padding="SAME"`` pads ``total = max((ceil(n/s)-1)*s + k - n, 0)`` split
``lo = total // 2``, ``hi = total - lo`` (asymmetric: the 7x7 stride-2 stem
at 224 pads (2, 3), a stride-2 3x3 on an even input (0, 1)), the max-pool
pads with -inf; batch norm normalises by the population variance and
updates ``new = 0.9 * old + 0.1 * batch`` (``nn.BatchNorm2d``'s momentum is
the other way round, so it is not used).

``mesh=`` splits the batch over the mesh's batch axes, each rank on its
local block (``parallel.spmd``); the batch statistics are the global
batch's, the per-rank sums all-reduced over those axes, so train-mode
``(loss, new_state)`` equal the one-device run's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, dtype_of, resolve_device
from ..parallel.spmd import compute_axes, spmd
from .params import ParamTree, map_tree, normal


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    # (blocks, channels) per stage; bottleneck expands channels x4
    stages: Tuple[Tuple[int, int], ...] = ((3, 64), (4, 128), (6, 256),
                                           (3, 512))
    bottleneck: bool = True
    num_classes: int = 1000
    dtype: str = "bfloat16"

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(**kw)

    @classmethod
    def resnet18(cls, **kw) -> "ResNetConfig":
        kw.setdefault("stages", ((2, 64), (2, 128), (2, 256), (2, 512)))
        kw.setdefault("bottleneck", False)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        kw.setdefault("stages", ((1, 8), (1, 16)))
        kw.setdefault("bottleneck", False)
        kw.setdefault("num_classes", 10)
        return cls(**kw)

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1


def _block_convs(cfg: ResNetConfig, cin: int, ch: int, stride: int):
    """The convolutions of one block, in the JAX init's order:
    ``[(name, kh, kw, cin, cout)]``."""
    cout = ch * cfg.expansion
    if cfg.bottleneck:
        convs = [("conv1", 1, 1, cin, ch), ("conv2", 3, 3, ch, ch),
                 ("conv3", 1, 1, ch, cout)]
    else:
        convs = [("conv1", 3, 3, cin, ch), ("conv2", 3, 3, ch, cout)]
    if stride != 1 or cin != cout:
        convs.append(("proj", 1, 1, cin, cout))
    return convs


def _layout(cfg: ResNetConfig):
    """``[(stage, block, stride, convs)]`` and the head's fan-in."""
    out, cin = [], 64
    for si, (n_blocks, ch) in enumerate(cfg.stages):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            out.append((si, bi, stride, _block_convs(cfg, cin, ch, stride)))
            cin = ch * cfg.expansion
    return out, cin


def resnet_param_shapes(cfg: ResNetConfig):
    """``(params, state)`` shapes in the JAX trees' layout."""
    def conv(kh, kw, cin, cout):
        return {"w": (kh, kw, cin, cout), "bn": {"g": (cout,), "b": (cout,)}}

    def stat(c):
        return {"mean": (c,), "var": (c,)}

    params = {"stem": conv(7, 7, 3, 64)}
    state = {"stem": stat(64)}
    blocks, cin = _layout(cfg)
    for si, bi, _, convs in blocks:
        params.setdefault(f"stage{si}", []).append(
            {n: conv(*dims) for n, *dims in convs})
        state.setdefault(f"stage{si}", []).append(
            {n: stat(dims[-1]) for n, *dims in convs})
    params["head"] = {"w": (cin, cfg.num_classes), "b": (cfg.num_classes,)}
    return params, state


def resnet_init(gen: torch.Generator, cfg: ResNetConfig,
                device: DeviceLike = None):
    """-> ``(params, state)``: He-normal filters (the head at scale
    sqrt(1 / fan_in)) drawn from ``gen`` in the JAX init's order, unit/zero
    batch-norm scales, and the running statistics (f32 zero means, unit
    variances), on ``device`` (the card unless it says "cpu")."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    shapes, state_shapes = resnet_param_shapes(cfg)

    def leaf(name, shape):
        if name == "w":
            fan_in = math.prod(shape[:-1])
            gain = 2.0 if len(shape) == 4 else 1.0
            return normal(gen, shape, (gain / fan_in) ** 0.5, dt, dev)
        fill = torch.ones if name in ("g", "var") else torch.zeros
        return fill(shape, dtype=torch.float32 if name in ("mean", "var")
                    else dt, device=dev)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return leaf(name, tree)

    return ParamTree(walk(shapes)), walk(state_shapes)


def resnet_param_axes(params):
    """Logical axes: conv filters replicate all but their output-channel
    axis, and the classifier head and every filter shard that axis over
    fsdp (ZeRO-3), as ``ray_tpu/models/resnet.py:resnet_param_axes``."""
    def axes(x):
        if x.dim() == 4:
            return (None, None, None, "embed")
        if x.dim() == 2:
            return (None, "embed")
        return (None,) * x.dim()

    tree = params.tree() if hasattr(params, "tree") else params
    return map_tree(axes, tree)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` along one dim: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, k: int, s: int, value: float = 0.0):
    (t, b), (l, r) = (same_pads(n, k, s) for n in x.shape[2:])
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


def _conv(x, w, stride=1):
    """NHWC ``x`` by HWIO ``w``, XLA's SAME padding."""
    xc = _pad_nchw(x.permute(0, 3, 1, 2), w.shape[0], stride)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _max_pool(x):
    """3x3 stride-2 max-pool with SAME padding of -inf, NHWC."""
    xc = _pad_nchw(x.permute(0, 3, 1, 2), 3, 2, value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


def _batchnorm(x, bn, st, train: bool, sp, momentum=0.9, eps=1e-5):
    """Returns (y, new_state).  Statistics in f32 whatever the activation
    dtype, over the global batch under a mesh."""
    if train:
        x32 = x.float()
        if sp.batch_split == 1:
            mean = x32.mean((0, 1, 2))
            var = x32.var((0, 1, 2), correction=0)
        else:
            n = x32.shape[0] * x32.shape[1] * x32.shape[2] * sp.batch_split
            mean = sp.batch_sum(x32.sum((0, 1, 2))) / n
            var = sp.batch_sum(((x32 - mean) ** 2).sum((0, 1, 2))) / n
        new_st = {"mean": (momentum * st["mean"]
                           + (1 - momentum) * mean).detach(),
                  "var": (momentum * st["var"]
                          + (1 - momentum) * var).detach()}
    else:
        mean, var = st["mean"], st["var"]
        new_st = st
    inv = torch.rsqrt(var + eps)
    y = (x.float() - mean) * inv
    y = y * bn["g"].float() + bn["b"].float()
    return y.to(x.dtype), new_st


def _block_apply(x, blk, bst, cfg: ResNetConfig, stride, train, sp):
    out_state = {}
    shortcut = x
    names = ("conv1", "conv2", "conv3") if cfg.bottleneck else ("conv1",
                                                                "conv2")
    y = x
    for i, name in enumerate(names):
        # The bottleneck strides its 3x3 (conv2), the basic block conv1.
        s = stride if (name == "conv2") == cfg.bottleneck else 1
        y = _conv(y, blk[name]["w"], s)
        y, out_state[name] = _batchnorm(y, blk[name]["bn"], bst[name], train,
                                        sp)
        if i < len(names) - 1:
            y = torch.relu(y)
    if "proj" in blk:
        shortcut = _conv(x, blk["proj"]["w"], stride)
        shortcut, out_state["proj"] = _batchnorm(
            shortcut, blk["proj"]["bn"], bst["proj"], train, sp)
    return torch.relu(y + shortcut), out_state


def _local_params(params, sp):
    """Every leaf in its compute layout (gathered over fsdp) under a mesh;
    the tree itself with none."""
    if sp.mesh is None:
        return params
    axes = resnet_param_axes(params)

    def walk(node, ax):
        if isinstance(ax, dict):
            return {k: walk(node[k], ax[k]) for k in ax}
        if isinstance(ax, list):
            return [walk(node[i], a) for i, a in enumerate(ax)]
        return sp.param(node, compute_axes(ax))

    return walk(params, axes)


def _forward(params, state, images, cfg: ResNetConfig, train: bool, sp):
    """This rank's f32 logits and the new state."""
    params = _local_params(params, sp)
    x = images.to(dtype_of(cfg.dtype))
    new_state = {}
    x = _conv(x, params["stem"]["w"], 2)
    x, new_state["stem"] = _batchnorm(x, params["stem"]["bn"],
                                      state["stem"], train, sp)
    x = _max_pool(torch.relu(x))
    blocks, _ = _layout(cfg)
    for si, bi, stride, _ in blocks:
        x, bst = _block_apply(x, params[f"stage{si}"][bi],
                              state[f"stage{si}"][bi], cfg, stride, train, sp)
        new_state.setdefault(f"stage{si}", []).append(bst)
    x = x.float().mean((1, 2))  # global average pool
    logits = x @ params["head"]["w"].float() + params["head"]["b"].float()
    return logits, new_state


def resnet_apply(params, state, images, cfg: ResNetConfig, *, train=False,
                 mesh=None):
    """images: [B, H, W, 3] → (logits [B, classes] f32 — a DTensor laid out
    (batch, None) under a mesh — and new_state)."""
    sp = spmd(mesh)
    logits, new_state = _forward(
        params, state, sp.local(images, ("batch", None, None, None)), cfg,
        train, sp)
    return sp.dist(logits, ("batch", None)), new_state


def resnet_loss(params, state, images, labels, cfg: ResNetConfig, *,
                mesh=None):
    """Softmax cross-entropy in train mode; returns (loss, new_state)."""
    sp = spmd(mesh)
    logits, new_state = _forward(
        params, state, sp.local(images, ("batch", None, None, None)), cfg,
        True, sp)
    logp = F.log_softmax(logits, dim=-1)
    labels = sp.local(labels, ("batch",))
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return sp.total(nll.sum()) / images.shape[0], new_state
