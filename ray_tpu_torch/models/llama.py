"""Llama-family decoder LM — port of ``ray_tpu/models/llama.py``.

RMSNorm + interleaved RoPE + GQA + SwiGLU, parameters in the JAX tree's
layout (``wq [L, E, H, D]``, ``wk/wv [L, E, Hkv, D]``, ``wo [L, H, D, E]``),
bf16 with f32 norms and softmax.  Attention is ``dense`` (the plain
reference) or ``flash`` (the flash kernels on the card, forward and
backward; k/v are repeated to H heads first, so the backward of
``repeat_interleave`` sums each group's gradient per kv head).  ``remat``
recomputes each block in backward; the sharded variants are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, dtype_of, resolve_device
from ..ops.attention import flash_attention, reference_attention
from .params import ParamTree, normal


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq: int = 2048
    n_layer: int = 22
    n_head: int = 32
    n_kv_head: int = 8  # GQA: query heads per kv head = n_head // n_kv_head
    d_model: int = 2048
    d_ff: int = 5632
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    attention: str = "dense"  # dense | flash
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq", 128)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_kv_head", 2)
        kw.setdefault("d_model", 64)
        kw.setdefault("d_ff", 128)
        return cls(**kw)

    @classmethod
    def tinyllama_1b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)  # defaults above are the 1.1B shape

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        kw.setdefault("n_layer", 32)
        kw.setdefault("n_head", 32)
        kw.setdefault("n_kv_head", 32)
        kw.setdefault("d_model", 4096)
        kw.setdefault("d_ff", 11008)
        kw.setdefault("max_seq", 4096)
        return cls(**kw)


def llama_param_shapes(cfg: LlamaConfig):
    e, hd = cfg.d_model, cfg.head_dim
    L, H, KV, F_ = cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.d_ff
    return {
        "wte": (cfg.vocab_size, e),
        "blocks": {
            "rms1": (L, e),
            "wq": (L, e, H, hd), "wk": (L, e, KV, hd), "wv": (L, e, KV, hd),
            "wo": (L, H, hd, e),
            "rms2": (L, e),
            "w_gate": (L, e, F_), "w_up": (L, e, F_), "w_down": (L, F_, e),
        },
        "rms_f": (e,),
        "lm_head": (cfg.vocab_size, e),
    }


def llama_init(gen: torch.Generator, cfg: LlamaConfig,
               device: DeviceLike = None) -> ParamTree:
    """Random weights with the JAX init's scales, drawn from ``gen`` (on its
    own device) and placed on ``device`` (the card unless it says "cpu")."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    s = 0.02
    so = s / (2 * cfg.n_layer) ** 0.5
    out_proj = ("wo", "w_down")

    def leaf(name, shape):
        if name.startswith("rms"):
            return torch.ones(shape, dtype=dt, device=dev)
        return normal(gen, shape, so if name in out_proj else s, dt, dev)

    shapes = llama_param_shapes(cfg)
    tree = {k: leaf(k, v) for k, v in shapes.items() if k != "blocks"}
    tree["blocks"] = {k: leaf(k, v) for k, v in shapes["blocks"].items()}
    return ParamTree(tree)


def _rmsnorm(x, g, eps: float):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * g.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """Interleaved rotary embedding: rotates ``x[..., 0::2]`` against
    ``x[..., 1::2]`` (not the rotate-half form).  x: [B, S, H, D];
    positions: [B, S] or [S].  Angles in f32."""
    d = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    )
    if positions.dim() == 1:
        positions = positions[None]
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]  # [B, S, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def _attention(q, k, v, cfg: LlamaConfig):
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attention != "dense":
        raise ValueError(f"attention {cfg.attention!r} is not ported yet")
    return reference_attention(q, k, v, causal=True)


def _swiglu(y, layer):
    gate = F.silu(torch.einsum("bse,ef->bsf", y, layer["w_gate"]))
    up = torch.einsum("bse,ef->bsf", y, layer["w_up"])
    return torch.einsum("bsf,fe->bse", gate * up, layer["w_down"])


def _block(x, layer, positions, cfg: LlamaConfig):
    groups = cfg.n_head // cfg.n_kv_head
    y = _rmsnorm(x, layer["rms1"], cfg.rms_eps)
    q = torch.einsum("bse,ehd->bshd", y, layer["wq"])
    k = torch.einsum("bse,ekd->bskd", y, layer["wk"])
    v = torch.einsum("bse,ekd->bskd", y, layer["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # GQA: repeat kv heads across their query-head group.
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    o = _attention(q, k, v, cfg)
    x = x + torch.einsum("bshd,hde->bse", o, layer["wo"]).to(x.dtype)
    y = _rmsnorm(x, layer["rms2"], cfg.rms_eps)
    return x + _swiglu(y, layer).to(x.dtype)


def llama_apply(params: ParamTree, tokens, cfg: LlamaConfig):
    """tokens: [B, S] int → logits [B, S, V]."""
    s = tokens.shape[1]
    x = params["wte"][tokens].to(dtype_of(cfg.dtype))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for l in range(cfg.n_layer):
        if cfg.remat:
            x = checkpoint(_block, x, params.layer(l), positions, cfg,
                           use_reentrant=False)
        else:
            x = _block(x, params.layer(l), positions, cfg)
    x = _rmsnorm(x, params["rms_f"], cfg.rms_eps)
    return torch.einsum("bse,ve->bsv", x, params["lm_head"])


def llama_loss(params: ParamTree, tokens, cfg: LlamaConfig,
               z_loss: float = 0.0):
    """Next-token cross-entropy; tokens [B, S+1].  The logits are upcast
    to f32 before the logsumexp, as in ``ray_tpu/models/llama.py:214-224``."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = llama_apply(params, inputs, cfg).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold).mean()
    if z_loss > 0:
        nll = nll + z_loss * (logz ** 2).mean()
    return nll
