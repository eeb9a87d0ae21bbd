"""ViT (Vision Transformer) — north-star config #5, ViT-B/16 batch
inference on Serve replicas; port of ``ray_tpu/models/vit.py``.

Patchify is one reshape and one matmul (no im2col convolution), the
encoder's parameters are layer-stacked in the JAX tree's layout
(``wqkv [L, E, 3, H, D]``, ``wo [L, H, D, E]``), LayerNorm (eps 1e-6) runs
in f32 and the classifier head in f32.  Attention is ``dense`` (the plain
reference) or ``flash``: the flash kernels on the card, non-causal, whose
forward runs at ViT-B/16's S=197 (no multiple of the kernel's 64-row
tile) and whose backward runs under autograd.  ViT-B/16's heads are 64
wide; a head width the kernels lack raises on the card, as it does for
the language models.  ``mesh=`` runs the encoder per rank on its local
blocks (``parallel.spmd``), parameters placed with ``vit_param_axes()``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import DeviceLike, dtype_of, resolve_device
from ..ops.attention import flash_attention, reference_attention
from ..parallel.spmd import compute_axes, spmd
from .gpt2 import _gelu
from .params import ParamTree, normal


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    mlp_dim: int = 3072
    num_classes: int = 1000
    dtype: str = "bfloat16"
    attention: str = "dense"  # dense | flash

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def b16(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("d_model", 64)
        kw.setdefault("mlp_dim", 128)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


def vit_param_shapes(cfg: ViTConfig):
    e, h, d, L, m = (cfg.d_model, cfg.n_head, cfg.head_dim, cfg.n_layer,
                     cfg.mlp_dim)
    return {
        "patch_w": (cfg.patch_size * cfg.patch_size * 3, e),
        "patch_b": (e,),
        "cls": (1, 1, e),
        "pos": (cfg.n_patches + 1, e),
        "blocks": {
            "ln1_g": (L, e), "ln1_b": (L, e),
            "wqkv": (L, e, 3, h, d), "bqkv": (L, 3, h, d),
            "wo": (L, h, d, e), "bo": (L, e),
            "ln2_g": (L, e), "ln2_b": (L, e),
            "wi": (L, e, m), "bi": (L, m),
            "wo2": (L, m, e), "bo2": (L, e),
        },
        "lnf_g": (e,), "lnf_b": (e,),
        "head_w": (e, cfg.num_classes), "head_b": (cfg.num_classes,),
    }


def vit_init(gen: torch.Generator, cfg: ViTConfig,
             device: DeviceLike = None) -> ParamTree:
    """Random weights with the JAX init's scales, drawn from ``gen`` and
    placed on ``device`` (the card unless it says "cpu")."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    shapes = vit_param_shapes(cfg)
    s = 0.02
    scaled = {"patch_w": (1.0 / shapes["patch_w"][0]) ** 0.5, "pos": s,
              "wqkv": s, "wo": s, "wi": s, "wo2": s,
              "head_w": (1.0 / cfg.d_model) ** 0.5}

    def leaf(name, shape):
        if name in scaled:
            return normal(gen, shape, scaled[name], dt, dev)
        fill = torch.ones if name.endswith("_g") else torch.zeros
        return fill(shape, dtype=dt, device=dev)

    tree = {k: leaf(k, v) for k, v in shapes.items() if k != "blocks"}
    tree["blocks"] = {k: leaf(k, v) for k, v in shapes["blocks"].items()}
    return ParamTree(tree)


def vit_param_axes():
    """Logical sharding axes (leading None = layer-stack axis), as
    ``ray_tpu/models/vit.py:vit_param_axes``."""
    return {
        "patch_w": (None, "embed"),
        "patch_b": ("norm",),
        "cls": (None, None, "norm"),
        "pos": (None, "embed"),
        "blocks": {
            "ln1_g": (None, "norm"),
            "ln1_b": (None, "norm"),
            "wqkv": (None, "embed", None, "heads", "kv"),
            "bqkv": (None, None, "heads", "kv"),
            "wo": (None, "heads", "kv", "embed"),
            "bo": (None, "norm"),
            "ln2_g": (None, "norm"),
            "ln2_b": (None, "norm"),
            "wi": (None, "embed", "mlp"),
            "bi": (None, "mlp"),
            "wo2": (None, "mlp", "embed"),
            "bo2": (None, "norm"),
        },
        "lnf_g": ("norm",),
        "lnf_b": ("norm",),
        "head_w": ("embed", None),
        "head_b": (None,),
    }


def _layernorm(x, g, b, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _attention(q, k, v, cfg: ViTConfig):
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=False)
    if cfg.attention != "dense":
        raise ValueError(f"unknown attention {cfg.attention!r}")
    return reference_attention(q, k, v, causal=False)


def _encoder_block(x, layer, cfg: ViTConfig, sp):
    # Local layouts: x (batch, seq, act_embed), q/k/v (batch, seq, heads,
    # kv), hdn (batch, seq, mlp) — the JAX block's constraints.
    y = sp.enter_tp(_layernorm(x, layer["ln1_g"], layer["ln1_b"]))
    qkv = torch.einsum("bse,ethd->bsthd", y, layer["wqkv"]) + layer["bqkv"]
    o = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], cfg)
    x = x + (sp.exit_tp(torch.einsum("bshd,hde->bse", o, layer["wo"]))
             + layer["bo"]).to(x.dtype)
    y = sp.enter_tp(_layernorm(x, layer["ln2_g"], layer["ln2_b"]))
    hdn = _gelu(torch.einsum("bse,ef->bsf", y, layer["wi"]) + layer["bi"])
    return x + (sp.exit_tp(torch.einsum("bsf,fe->bse", hdn, layer["wo2"]))
                + layer["bo2"]).to(x.dtype)


def patchify(images, cfg: ViTConfig):
    """[B, H, W, 3] → [B, n_patches, patch_dim] by pure reshape/transpose."""
    b, hh, ww, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, hh // p, p, ww // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // p) * (ww // p), p * p * c)


def _logits(params: ParamTree, images, cfg: ViTConfig, sp):
    """This rank's [B_local, num_classes] f32 logits."""
    axes = vit_param_axes()

    def top(name):
        return sp.param(params[name], compute_axes(axes[name]))

    dt = dtype_of(cfg.dtype)
    x = patchify(images.to(dt), cfg) @ top("patch_w") + top("patch_b")
    cls = top("cls").expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + top("pos")[None]
    layer_params = sp.layers(params.blocks, axes["blocks"])
    for l in range(cfg.n_layer):
        x = _encoder_block(x, layer_params(l), cfg, sp)
    x = _layernorm(x[:, 0], top("lnf_g"), top("lnf_b"))
    return x.float() @ top("head_w").float() + top("head_b").float()


def vit_apply(params: ParamTree, images, cfg: ViTConfig, mesh=None):
    """images: [B, H, W, 3] → logits [B, num_classes] (f32; a DTensor laid
    out (batch, None) under a mesh)."""
    sp = spmd(mesh)
    logits = _logits(params, sp.local(images, ("batch", None, None, None)),
                     cfg, sp)
    return sp.dist(logits, ("batch", None))


def vit_loss(params: ParamTree, images, labels, cfg: ViTConfig, mesh=None):
    """Mean softmax cross-entropy over the (global) batch."""
    sp = spmd(mesh)
    logits = _logits(params, sp.local(images, ("batch", None, None, None)),
                     cfg, sp)
    logp = F.log_softmax(logits, dim=-1)
    labels = sp.local(labels, ("batch",))
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return sp.total(nll.sum()) / images.shape[0]
