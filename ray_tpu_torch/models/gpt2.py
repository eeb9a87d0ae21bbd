"""GPT-2 family — port of ``ray_tpu/models/gpt2.py``.

Parameters keep the JAX tree's layout (``wqkv [L, E, 3, H, D]``,
``wo [L, H, D, E]``, the unembedding tied to ``wte``), so each einsum below
reads as its JAX counterpart.  bf16 activations and params with f32
layernorm and softmax, as in the JAX package.  Attention is ``dense`` (the
plain reference) or ``flash`` (the flash kernels on the card, forward and
backward).  ``remat`` recomputes each block in backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` does there); the named
remat policies and the ring and Ulysses variants are not ported yet.
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
class GPT2Config:
    vocab_size: int = 50304  # 50257 padded up
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    dtype: str = "bfloat16"
    attention: str = "dense"  # dense | flash
    remat: bool = False
    # "full" (and, as in JAX, any unknown value) recomputes the whole block
    # in backward.  The named policies of the JAX package (dots, dots_all,
    # matmuls, save_mlp) are not ported yet and raise.
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def medium(cls, **kw) -> "GPT2Config":
        return cls(n_layer=24, n_head=16, d_model=1024, **kw)

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        return cls(n_layer=12, n_head=12, d_model=768, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq", 128)
        return cls(n_layer=2, n_head=4, d_model=64, **kw)


def gpt2_param_shapes(cfg: GPT2Config):
    e, h, d, L, v = (cfg.d_model, cfg.n_head, cfg.head_dim, cfg.n_layer,
                     cfg.vocab_size)
    return {
        "wte": (v, e),
        "wpe": (cfg.max_seq, e),
        "blocks": {
            "ln1_g": (L, e), "ln1_b": (L, e),
            "wqkv": (L, e, 3, h, d), "bqkv": (L, 3, h, d),
            "wo": (L, h, d, e), "bo": (L, e),
            "ln2_g": (L, e), "ln2_b": (L, e),
            "wi": (L, e, 4 * e), "bi": (L, 4 * e),
            "wo2": (L, 4 * e, e), "bo2": (L, e),
        },
        "lnf_g": (e,), "lnf_b": (e,),
    }


def gpt2_init(gen: torch.Generator, cfg: GPT2Config,
              device: DeviceLike = None) -> ParamTree:
    """Random weights with the JAX init's scales, drawn from ``gen`` (on its
    own device) and placed on ``device`` (the card unless it says "cpu")."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    s = 0.02
    so = s / (2 * cfg.n_layer) ** 0.5  # gpt-2 residual-out scaling
    shapes = gpt2_param_shapes(cfg)
    scaled = {"wte": s, "wpe": s, "wqkv": s, "wo": so, "wi": s, "wo2": so}

    def leaf(name, shape):
        if name in scaled:
            return normal(gen, shape, scaled[name], dt, dev)
        fill = torch.ones if name.endswith("_g") else torch.zeros
        return fill(shape, dtype=dt, device=dev)

    tree = {k: leaf(k, v) for k, v in shapes.items() if k != "blocks"}
    tree["blocks"] = {k: leaf(k, v) for k, v in shapes["blocks"].items()}
    return ParamTree(tree)


def _layernorm(x, g, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, cfg: GPT2Config):
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attention != "dense":
        raise ValueError(f"attention {cfg.attention!r} is not ported yet")
    return reference_attention(q, k, v, causal=True)


def _block(x, layer, cfg: GPT2Config):
    y = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
    qkv = torch.einsum("bse,ethd->bsthd", y, layer["wqkv"]) + layer["bqkv"]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = _attention(q, k, v, cfg)
    x = x + (torch.einsum("bshd,hde->bse", o, layer["wo"])
             + layer["bo"]).to(x.dtype)
    y = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
    hdn = _gelu(torch.einsum("bse,ef->bsf", y, layer["wi"]) + layer["bi"])
    return x + (torch.einsum("bsf,fe->bse", hdn, layer["wo2"])
                + layer["bo2"]).to(x.dtype)


REMAT_POLICIES_NOT_PORTED = ("dots", "dots_all", "matmuls", "save_mlp")


def gpt2_hidden(params: ParamTree, tokens, cfg: GPT2Config):
    """tokens: [B, S] int → final layernormed hidden states [B, S, E]."""
    if cfg.remat and cfg.remat_policy in REMAT_POLICIES_NOT_PORTED:
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported yet")
    s = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:s][None]
    for l in range(cfg.n_layer):
        if cfg.remat:
            x = checkpoint(_block, x, params.layer(l), cfg,
                           use_reentrant=False)
        else:
            x = _block(x, params.layer(l), cfg)
    return _layernorm(x, params["lnf_g"], params["lnf_b"])


def gpt2_apply(params: ParamTree, tokens, cfg: GPT2Config):
    """tokens: [B, S] int → logits [B, S, V]."""
    x = gpt2_hidden(params, tokens, cfg)
    return torch.einsum("bse,ve->bsv", x, params["wte"])


def _ce_from_logits(logits, targets, z_loss: float):
    """Summed (not mean) next-token NLL: the logsumexp in f32, the gold
    logit gathered from the bf16 logits and upcast after
    (``ray_tpu/models/gpt2.py:264-272``)."""
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold.float()).sum()
    if z_loss > 0:
        nll = nll + z_loss * (logz ** 2).sum()
    return nll


def _chunk_nll(wte, x_c, t_c, z_loss: float):
    logits = torch.einsum("bce,ve->bcv", x_c, wte)
    return _ce_from_logits(logits, t_c, z_loss)


def gpt2_loss(params: ParamTree, tokens, cfg: GPT2Config,
              z_loss: float = 0.0, ce_chunks: int = 0):
    """Next-token cross-entropy.  tokens: [B, S+1] (inputs = [:, :-1]).

    ``ce_chunks > 0`` evaluates the unembedding + CE in that many
    sequence chunks, each recomputed in backward, so peak memory holds one
    [B, S/c, V] logits block instead of [B, S, V].
    """
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = gpt2_hidden(params, inputs, cfg)
    b, s, _ = x.shape
    if ce_chunks > 1 and s % ce_chunks != 0:
        raise ValueError(
            f"ce_chunks={ce_chunks} must divide the sequence length {s} "
            "(silently falling back would materialize the full [B,S,V] "
            "logits the caller asked to avoid)"
        )
    if ce_chunks <= 1:
        return _chunk_nll(params["wte"], x, targets, z_loss) / (b * s)
    c = s // ce_chunks
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(ce_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_nll, params["wte"], x[:, sl],
                                   targets[:, sl], z_loss,
                                   use_reentrant=False)
    return total / (b * s)
