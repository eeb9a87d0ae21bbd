"""GPT-2 family — port of ``ray_tpu/models/gpt2.py``.

Parameters keep the JAX tree's layout (``wqkv [L, E, 3, H, D]``,
``wo [L, H, D, E]``, the unembedding tied to ``wte``), so each einsum below
reads as its JAX counterpart.  bf16 activations and params with f32
layernorm and softmax, as in the JAX package.  Attention is ``dense`` (the
plain reference), ``dense_remat`` (the same, recomputed in backward),
``flash`` (the flash kernels on the card, forward and backward), or, under
a mesh, ``ring`` (context parallel over the ``seq`` axis, each block on the
flash kernels on the card) or ``ulysses`` (all-to-all over ``seq``).
``remat`` recomputes each block in backward (``torch.utils.checkpoint``, as
``jax.checkpoint`` does there); ``remat_policy`` names what a block saves
instead of recomputing, as the JAX policies do, through a selective
checkpoint policy: ``dots`` every matmul with no batch dims (the
projections; ``torch.einsum`` lowers them to a ``bmm`` of batch 1),
``dots_all`` every matmul, ``matmuls`` the tensors tagged ``qkv``,
``attn_out``, ``attn_resid`` and ``mlp_hidden``, ``save_mlp`` only
``mlp_hidden``.  Remat changes no value.

``mesh=`` (a ``DeviceMesh`` of ``parallel.build_mesh``, parameters placed
by ``parallel.shard_pytree`` with ``gpt2_param_axes()``) runs the model
one rank a process, each on its local blocks (``parallel.spmd``), with
the logical layouts of the JAX model's sharding constraints; with no mesh
the path is the unsharded one.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import DeviceLike, dtype_of, resolve_device
from ..ops.attention import flash_attention, reference_attention
from ..parallel.sharding import with_logical_constraint as wlc
from ..parallel.spmd import spmd
from .params import ParamTree, normal


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # 50257 padded up
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    dtype: str = "bfloat16"
    attention: str = "dense"  # dense | flash | ring | ulysses
    remat: bool = False
    # "full" (and, as in JAX, any unknown value) recomputes the whole block
    # in backward; dots, dots_all, matmuls and save_mlp save what the JAX
    # package's policies of those names save (REMAT_POLICIES).
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


def gpt2_param_axes():
    """Logical sharding axes per parameter (leading None = layer-stack
    axis), as ``ray_tpu/models/gpt2.py:gpt2_param_axes``: the embedding
    table's vocab axis is not sharded (the token gather runs along it)."""
    return {
        "wte": (None, "embed"),
        "wpe": (None, "embed"),
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
    }


QKV_AXES = ("batch", "seq", "heads", "kv")


def _layernorm(x, g, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, cfg: GPT2Config, sp=spmd(None)):
    if cfg.attention in ("ring", "ulysses"):
        return seq_parallel_attention(q, k, v, cfg.attention, sp)
    if sp.seq_size > 1:
        # A local attention sees the whole sequence: gather seq around it.
        full = ("batch", None, "heads", "kv")
        o = _attention(*(sp.local(sp.dist(x, QKV_AXES), full)
                         for x in (q, k, v)), cfg, spmd(None))
        return sp.local(sp.dist(o, full), QKV_AXES)
    if cfg.attention == "dense_remat":
        # Dense attention whose [B, H, S, S] probabilities are recomputed
        # in backward instead of stored (``jax.checkpoint`` there).
        return checkpoint(reference_attention, q, k, v, causal=True,
                          use_reentrant=False)
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attention != "dense":
        raise ValueError(f"unknown attention {cfg.attention!r}")
    return reference_attention(q, k, v, causal=True)


def seq_parallel_attention(q, k, v, kind: str, sp):
    """Ring or Ulysses attention on local [B, S, H, D] blocks laid out as
    (batch, seq, heads, kv) over ``sp.mesh``; Ulysses runs the flash
    kernels on CUDA tensors, as the ring does."""
    if sp.mesh is None:
        raise ValueError(f"{kind} attention requires a mesh")
    from ..parallel.ring_attention import ring_attention
    from ..parallel.ulysses import ulysses_attention

    q, k, v = (wlc(sp.dist(x, QKV_AXES), QKV_AXES, sp.mesh, sp.rules)
               for x in (q, k, v))
    if kind == "ring":
        o = ring_attention(q, k, v, sp.mesh, causal=True)
    else:
        attn = (flash_attention if q.device.type == "cuda"
                else reference_attention)
        o = ulysses_attention(q, k, v, sp.mesh, causal=True,
                              attn_fn=lambda a, b, c: attn(a, b, c,
                                                           causal=True))
    return sp.local(o, QKV_AXES)


@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: a copy of ``x`` that a named
    remat policy can save by ``name``."""
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# policy -> (tagged names saved, matmuls saved: None, "no_batch" or "all")
REMAT_POLICIES = {
    "dots": ((), "no_batch"),
    "dots_all": ((), "all"),
    "matmuls": (("qkv", "attn_out", "attn_resid", "mlp_hidden"), None),
    "save_mlp": (("mlp_hidden",), None),
}


def _remat_policy(ctx, func, *args, names=(), dots=None, **kwargs):
    if func is torch.ops.ray_tpu_torch.checkpoint_name.default:
        return (CheckpointPolicy.MUST_SAVE if args[1] in names
                else CheckpointPolicy.PREFER_RECOMPUTE)
    if dots and func in _MATMULS:
        batch = args[-2].shape[0] if func in _MATMULS[2:] else 1
        if dots == "all" or batch == 1:
            return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str):
    names, dots = REMAT_POLICIES[policy]
    return create_selective_checkpoint_contexts(
        functools.partial(_remat_policy, names=names, dots=dots))


def _tag(x, name: str, cfg: GPT2Config):
    """``x`` tagged ``name`` where a named remat policy can save it."""
    if cfg.remat and cfg.remat_policy in ("matmuls", "save_mlp"):
        return _checkpoint_name(x, name)
    return x


def _block(x, layer, cfg: GPT2Config, sp=spmd(None)):
    # Local layouts: x and y (batch, seq, act_embed), q/k/v (batch, seq,
    # heads, kv), hdn (batch, seq, mlp) — the JAX block's constraints.
    y = sp.enter_tp(_layernorm(x, layer["ln1_g"], layer["ln1_b"]))
    qkv = torch.einsum("bse,ethd->bsthd", y, layer["wqkv"]) + layer["bqkv"]
    qkv = _tag(qkv, "qkv", cfg)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = _tag(_attention(q, k, v, cfg, sp), "attn_out", cfg)
    x = x + (sp.exit_tp(torch.einsum("bshd,hde->bse", o, layer["wo"]))
             + layer["bo"]).to(x.dtype)
    x = _tag(x, "attn_resid", cfg)
    y = sp.enter_tp(_layernorm(x, layer["ln2_g"], layer["ln2_b"]))
    hdn = _gelu(torch.einsum("bse,ef->bsf", y, layer["wi"]) + layer["bi"])
    hdn = _tag(hdn, "mlp_hidden", cfg)
    return x + (sp.exit_tp(torch.einsum("bsf,fe->bse", hdn, layer["wo2"]))
                + layer["bo2"]).to(x.dtype)


def _hidden(params: ParamTree, tokens, cfg: GPT2Config, sp):
    """Local [B, S] token ids → (this rank's final hidden block, the
    embedding table in its compute layout, for the unembedding)."""
    s = tokens.shape[1]
    # Gather from a replicated view of the table (the JAX model's
    # P(None, "act_embed")): one all-gather of wte, then a local lookup.
    wte = sp.param(params["wte"], (None, "act_embed"))
    wpe = sp.param(params["wpe"], (None, "act_embed"))
    start = sp.seq_start(s)
    x = wte[tokens] + wpe[start:start + s][None]
    layer_params = sp.layers(params.blocks, gpt2_param_axes()["blocks"])
    for l in range(cfg.n_layer):
        layer = layer_params(l)
        if cfg.remat and cfg.remat_policy in REMAT_POLICIES:
            x = checkpoint(_block, x, layer, cfg, sp, use_reentrant=False,
                           context_fn=functools.partial(
                               _remat_context, cfg.remat_policy))
        elif cfg.remat:
            x = checkpoint(_block, x, layer, cfg, sp, use_reentrant=False)
        else:
            x = _block(x, layer, cfg, sp)
    x = _layernorm(x, sp.param(params["lnf_g"], ("norm",)),
                   sp.param(params["lnf_b"], ("norm",)))
    return x, wte


def gpt2_hidden(params: ParamTree, tokens, cfg: GPT2Config, mesh=None):
    """tokens: [B, S] int → final layernormed hidden states [B, S, E] (a
    DTensor laid out (batch, seq, act_embed) under a mesh)."""
    sp = spmd(mesh)
    x, _ = _hidden(params, sp.tokens(tokens), cfg, sp)
    return sp.dist(x, ("batch", "seq", "act_embed"))


def gpt2_apply(params: ParamTree, tokens, cfg: GPT2Config, mesh=None):
    """tokens: [B, S] int → logits [B, S, V] (a DTensor laid out (batch,
    seq, vocab) under a mesh)."""
    sp = spmd(mesh)
    x, wte = _hidden(params, sp.tokens(tokens), cfg, sp)
    logits = torch.einsum("bse,ve->bsv", x, wte)
    return wlc(sp.dist(logits, ("batch", "seq", "act_embed")),
               ("batch", "seq", "vocab"), mesh)


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


def gpt2_loss(params: ParamTree, tokens, cfg: GPT2Config, mesh=None,
              z_loss: float = 0.0, ce_chunks: int = 0):
    """Next-token cross-entropy.  tokens: [B, S+1] (inputs = [:, :-1]).

    ``ce_chunks > 0`` evaluates the unembedding + CE in that many
    sequence chunks, each recomputed in backward, so peak memory holds one
    [B, S/c, V] logits block instead of [B, S, V].  Under a mesh each rank
    sums the CE of its block and the sums meet in one psum; the result is
    the global mean on every rank.
    """
    sp = spmd(mesh)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    b, s = inputs.shape
    x, wte = _hidden(params, sp.tokens(inputs), cfg, sp)
    targets = sp.tokens(targets)
    s_local = x.shape[1]
    if ce_chunks > 1 and s_local % ce_chunks != 0:
        raise ValueError(
            f"ce_chunks={ce_chunks} must divide the sequence length {s} "
            "(silently falling back would materialize the full [B,S,V] "
            "logits the caller asked to avoid)"
        )
    if ce_chunks <= 1:
        return sp.total(_chunk_nll(wte, x, targets, z_loss)) / (b * s)
    c = s_local // ce_chunks
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(ce_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_nll, wte, x[:, sl],
                                   targets[:, sl], z_loss,
                                   use_reentrant=False)
    return sp.total(total) / (b * s)
