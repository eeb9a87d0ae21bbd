"""Llama-family decoder LM — port of ``ray_tpu/models/llama.py``.

RMSNorm + interleaved RoPE + GQA + SwiGLU, parameters in the JAX tree's
layout (``wq [L, E, H, D]``, ``wk/wv [L, E, Hkv, D]``, ``wo [L, H, D, E]``),
bf16 with f32 norms and softmax.  Attention is ``dense`` (the plain
reference), ``flash`` (the flash kernels on the card, forward and
backward), or, under a mesh, ``ring`` or ``ulysses`` over the ``seq`` axis
(``models.gpt2.seq_parallel_attention``).  k/v are repeated to H heads
first, so every attention sees the KV heads after the GQA repeat, as in
JAX, and the backward of ``repeat_interleave`` sums each group's gradient
per kv head.  ``remat`` recomputes each block in backward.  ``mesh=`` runs
the model per rank on its local blocks as ``models.gpt2`` does
(``parallel.spmd``), parameters placed with ``llama_param_axes()``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, dtype_of, resolve_device
from ..parallel.sharding import with_logical_constraint as wlc
from ..parallel.spmd import spmd
from .gpt2 import _attention as _gpt2_attention
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
    attention: str = "dense"  # dense | flash | ring | ulysses
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


def llama_param_axes():
    """Logical sharding axes (leading None = layer-stack axis), as
    ``ray_tpu/models/llama.py:llama_param_axes``: the embedding table's
    vocab axis unsharded, ``lm_head``'s sharded over vocab."""
    return {
        "wte": (None, "embed"),
        "blocks": {
            "rms1": (None, "norm"),
            "wq": (None, "embed", "heads", "kv"),
            "wk": (None, "embed", "heads", "kv"),
            "wv": (None, "embed", "heads", "kv"),
            "wo": (None, "heads", "kv", "embed"),
            "rms2": (None, "norm"),
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
        },
        "rms_f": ("norm",),
        "lm_head": ("vocab", "embed"),
    }


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


def _swiglu(y, layer, sp=spmd(None)):
    gate = F.silu(torch.einsum("bse,ef->bsf", y, layer["w_gate"]))
    up = torch.einsum("bse,ef->bsf", y, layer["w_up"])
    return sp.exit_tp(torch.einsum("bsf,fe->bse", gate * up,
                                   layer["w_down"]))


def _block(x, layer, positions, cfg: LlamaConfig, sp=spmd(None)):
    # Local layouts as the JAX block's constraints: x (batch, seq,
    # act_embed), q/k/v (batch, seq, heads, kv), gate*up (batch, seq, mlp).
    groups = cfg.n_head // cfg.n_kv_head
    y = sp.enter_tp(_rmsnorm(x, layer["rms1"], cfg.rms_eps))
    q = torch.einsum("bse,ehd->bshd", y, layer["wq"])
    k = torch.einsum("bse,ekd->bskd", y, layer["wk"])
    v = torch.einsum("bse,ekd->bskd", y, layer["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # GQA: repeat kv heads across their query-head group.
    k = torch.repeat_interleave(k, groups, dim=2)
    v = torch.repeat_interleave(v, groups, dim=2)
    o = _gpt2_attention(q, k, v, cfg, sp)
    x = x + sp.exit_tp(torch.einsum("bshd,hde->bse", o,
                                    layer["wo"])).to(x.dtype)
    y = sp.enter_tp(_rmsnorm(x, layer["rms2"], cfg.rms_eps))
    return x + _swiglu(y, layer, sp).to(x.dtype)


def _logits(params: ParamTree, tokens, cfg: LlamaConfig, sp):
    """Local [B, S] token ids → this rank's [B, S, V] logits block (vocab
    whole: every model rank computes it)."""
    s = tokens.shape[1]
    # Gather from a replicated view of the table (P(None, "act_embed")).
    wte = sp.param(params["wte"], (None, "act_embed"))
    x = wte[tokens].to(dtype_of(cfg.dtype))
    start = sp.seq_start(s)
    positions = torch.arange(start, start + s, dtype=torch.int32,
                             device=x.device)
    layer_params = sp.layers(params.blocks, llama_param_axes()["blocks"])
    for l in range(cfg.n_layer):
        layer = layer_params(l)
        if cfg.remat:
            x = checkpoint(_block, x, layer, positions, cfg, sp,
                           use_reentrant=False)
        else:
            x = _block(x, layer, positions, cfg, sp)
    x = _rmsnorm(x, sp.param(params["rms_f"], ("norm",)), cfg.rms_eps)
    return torch.einsum("bse,ve->bsv", x,
                        sp.param(params["lm_head"], (None, "act_embed")))


def llama_apply(params: ParamTree, tokens, cfg: LlamaConfig, mesh=None):
    """tokens: [B, S] int → logits [B, S, V] (a DTensor laid out (batch,
    seq, vocab) under a mesh)."""
    sp = spmd(mesh)
    logits = _logits(params, sp.tokens(tokens), cfg, sp)
    return wlc(sp.dist(logits, ("batch", "seq", "act_embed")),
               ("batch", "seq", "vocab"), mesh)


def llama_loss(params: ParamTree, tokens, cfg: LlamaConfig, mesh=None,
               z_loss: float = 0.0):
    """Next-token cross-entropy; tokens [B, S+1].  The logits are upcast
    to f32 before the logsumexp, as in ``ray_tpu/models/llama.py:214-224``;
    under a mesh the per-rank sums meet in one psum."""
    sp = spmd(mesh)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    n = inputs.numel()
    logits = _logits(params, sp.tokens(inputs), cfg, sp).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, sp.tokens(targets)[..., None])[..., 0]
    if mesh is None:
        mean = torch.mean
    else:
        def mean(x):
            return sp.total(x.sum()) / n
    nll = mean(logz - gold)
    if z_loss > 0:
        nll = nll + z_loss * mean(logz ** 2)
    return nll
