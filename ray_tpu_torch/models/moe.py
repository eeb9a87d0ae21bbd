"""Mixture-of-Experts LM with expert parallelism — port of
``ray_tpu/models/moe.py``.

GShard/Switch-style top-1 or top-2 routing with static shapes, as in the
JAX package: the router in f32, the Switch load-balancing aux loss on the
top-1 assignment, each expert's queue a cumsum over the sequence (each
batch row is a routing group), the second expert's queue starting after
the capacity-masked first-expert counts, tokens past an expert's capacity
dropped (their one-hot rows are zero), the two gates renormalised with a
1e-9 guard.  Dispatched token buffers are ``[experts, batch, capacity,
model]`` and per-expert FFN weights ``wi [L, E, M, 4M]``, ``wo2 [L, E, 4M,
M]``.  Attention is causal: ``dense`` (the plain reference) or ``flash``
(the flash kernels on the card, forward and backward).

``mesh=`` runs the model per rank on its local blocks (``parallel.spmd``),
parameters placed with ``moe_param_axes()``: tokens split over the batch
axes and replicated over ``expert``; each rank runs its own experts'
slice of the dispatched buffers and the combine sums over ``expert``
(a psum, whose inputs enter through ``copy_to`` so the gradients of the
shared tokens and gates are summed over the experts); the aux loss is
averaged over the global batch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, dtype_of, resolve_device
from ..ops.attention import flash_attention, reference_attention
from ..parallel.sharding import with_logical_constraint as wlc
from ..parallel.spmd import spmd
from .gpt2 import _gelu, _layernorm
from .params import ParamTree, normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 50304
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    dtype: str = "bfloat16"
    attention: str = "dense"  # dense | flash
    remat: bool = False

    def __post_init__(self):
        # Routing implements top-1 and top-2 (GShard-style second expert);
        # a silently-ignored larger top_k would still inflate capacity().
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {self.top_k}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    def capacity(self, seq_len: int) -> int:
        c = int(self.top_k * seq_len * self.capacity_factor / self.n_experts)
        return max(c, 4)

    @classmethod
    def tiny(cls, **kw) -> "MoEConfig":
        kw.setdefault("vocab_size", 512)
        kw.setdefault("max_seq", 128)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("d_model", 64)
        kw.setdefault("n_experts", 4)
        return cls(**kw)


def moe_param_shapes(cfg: MoEConfig):
    e, h, d, L, E = (cfg.d_model, cfg.n_head, cfg.head_dim, cfg.n_layer,
                     cfg.n_experts)
    return {
        "wte": (cfg.vocab_size, e),
        "wpe": (cfg.max_seq, e),
        "blocks": {
            "ln1_g": (L, e), "ln1_b": (L, e),
            "wqkv": (L, e, 3, h, d), "bqkv": (L, 3, h, d),
            "wo": (L, h, d, e), "bo": (L, e),
            "ln2_g": (L, e), "ln2_b": (L, e),
            "wg": (L, e, E),
            "wi": (L, E, e, 4 * e),
            "wo2": (L, E, 4 * e, e),
        },
        "lnf_g": (e,), "lnf_b": (e,),
    }


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             device: DeviceLike = None) -> ParamTree:
    """Random weights with the JAX init's scales (the router in f32),
    drawn from ``gen`` and placed on ``device`` (the card unless it says
    "cpu")."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    s = 0.02
    so = s / (2 * cfg.n_layer) ** 0.5
    scaled = {"wte": s, "wpe": s, "wqkv": s, "wo": so, "wg": s, "wi": s,
              "wo2": so}

    def leaf(name, shape):
        if name in scaled:
            return normal(gen, shape, scaled[name],
                          torch.float32 if name == "wg" else dt, dev)
        fill = torch.ones if name.endswith("_g") else torch.zeros
        return fill(shape, dtype=dt, device=dev)

    shapes = moe_param_shapes(cfg)
    tree = {k: leaf(k, v) for k, v in shapes.items() if k != "blocks"}
    tree["blocks"] = {k: leaf(k, v) for k, v in shapes["blocks"].items()}
    return ParamTree(tree)


def moe_param_axes():
    """Logical sharding axes (leading None = layer-stack axis), as
    ``ray_tpu/models/moe.py:moe_param_axes``."""
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
            "wg": (None, "embed", None),
            "wi": (None, "expert", "embed", "expert_mlp"),
            "wo2": (None, "expert", "expert_mlp", "embed"),
        },
        "lnf_g": ("norm",),
        "lnf_b": ("norm",),
    }


def _one_hot(idx, n: int):
    """``jax.nn.one_hot`` in f32: an index outside [0, n) gives a zero row
    (``F.one_hot`` would raise), so a token past capacity stays dropped."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)
            ).float()


def _expert_slice(sp, n_local: int) -> slice:
    """This rank's experts: ``n_local`` of them, at its expert index."""
    if sp.mesh is None or "expert" not in sp.mesh.mesh_dim_names:
        return slice(0, n_local)
    lo = sp.ex.index("expert")[0] * n_local
    return slice(lo, lo + n_local)


def _expert_exchange(sp):
    """``(enter, exit)``: copy_to and psum over the expert axis, or the
    identity when the experts are not split."""
    if (sp.mesh is None or "expert" not in sp.mesh.mesh_dim_names
            or sp.ex.size("expert") == 1):
        return (lambda x: x), (lambda x: x)
    return ((lambda x: sp.ex.copy_to([x], "expert")[0]),
            (lambda x: sp.ex.psum([x], "expert")[0]))


def moe_ffn(x, wg, wi, wo, cfg: MoEConfig, mesh=None, sp=None):
    """Top-2 routed expert FFN.  x: [B, S, M] → (y [B, S, M], aux_loss).

    Under a mesh (``sp``, the model's per-rank view; ``mesh`` alone is
    taken as ``spmd(mesh)``) ``x`` is this rank's batch block, ``wi``/``wo``
    its experts' slice, and ``aux`` the global batch's mean.
    """
    sp = sp if sp is not None else spmd(mesh)
    b, s_len, _ = x.shape
    E, C = cfg.n_experts, cfg.capacity(s_len)

    logits = torch.einsum("bsm,me->bse", x.float(), wg.float())
    gates = torch.softmax(logits, dim=-1)  # [B,S,E] f32

    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, E)
    # Switch aux loss on the top-1 assignment (fraction × mean prob)
    density = mask1.mean(dim=1)  # [B,E] fraction routed to e
    prob_mean = gates.mean(dim=1)  # [B,E]
    aux = E * sp.total(torch.sum(density * prob_mean, dim=-1).sum()) / (
        b * sp.batch_split)

    pos1 = torch.cumsum(mask1, dim=1) - mask1  # [B,S,E] queue position
    mask1 = mask1 * (pos1 < C)

    if cfg.top_k >= 2:
        gates2 = gates * (1.0 - _one_hot(idx1, E))
        idx2 = torch.argmax(gates2, dim=-1)
        mask2 = _one_hot(idx2, E)
        pos2 = (torch.cumsum(mask2, dim=1) - mask2
                + mask1.sum(dim=1, keepdim=True))
        mask2 = mask2 * (pos2 < C)
    else:
        mask2 = torch.zeros_like(mask1)
        pos2 = torch.zeros_like(pos1)

    w1 = torch.sum(gates * mask1, dim=-1)  # [B,S]
    w2 = torch.sum(gates * mask2, dim=-1)
    denom = w1 + w2 + 1e-9
    w1, w2 = w1 / denom, w2 / denom

    onehot_c1 = _one_hot(pos1, C) * mask1[..., None]
    onehot_c2 = _one_hot(pos2, C) * mask2[..., None]
    combine = (w1[..., None, None] * onehot_c1
               + w2[..., None, None] * onehot_c2)  # [B,S,E,C]
    dispatch = (onehot_c1 + onehot_c2).to(x.dtype)

    enter, leave = _expert_exchange(sp)
    mine = _expert_slice(sp, wi.shape[0])
    xe = torch.einsum("bsec,bsm->ebcm", dispatch[:, :, mine], enter(x))
    h = _gelu(torch.einsum("ebcm,emh->ebch", xe, wi))
    ye = torch.einsum("ebch,ehm->ebcm", h, wo)
    y = torch.einsum("bsec,ebcm->bsm",
                     enter(combine)[:, :, mine].to(ye.dtype), ye)
    return leave(y).to(x.dtype), aux


def _attention(q, k, v, cfg: MoEConfig):
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=True)
    if cfg.attention != "dense":
        raise ValueError(f"unknown attention {cfg.attention!r}")
    return reference_attention(q, k, v, causal=True)


def _block(x, layer, cfg: MoEConfig, sp):
    y = sp.enter_tp(_layernorm(x, layer["ln1_g"], layer["ln1_b"]))
    qkv = torch.einsum("bse,ethd->bsthd", y, layer["wqkv"]) + layer["bqkv"]
    o = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], cfg)
    x = x + (sp.exit_tp(torch.einsum("bshd,hde->bse", o, layer["wo"]))
             + layer["bo"]).to(x.dtype)
    y = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
    ffn, aux = moe_ffn(y, layer["wg"], layer["wi"], layer["wo2"], cfg, sp=sp)
    return x + ffn, aux


def _logits(params: ParamTree, tokens, cfg: MoEConfig, sp):
    """This rank's [B_local, S, V] logits (in the model dtype) and the mean
    aux loss over layers."""
    if sp.seq_size > 1:
        raise ValueError("the MoE model routes over the whole sequence: "
                         "its mesh cannot split seq")
    s = tokens.shape[1]
    # Gather from a replicated view of the table (gpt2's rationale).
    wte = sp.param(params["wte"], (None, "act_embed"))
    wpe = sp.param(params["wpe"], (None, "act_embed"))
    x = wte[tokens] + wpe[:s][None]
    layer_params = sp.layers(params.blocks, moe_param_axes()["blocks"])
    auxes = []
    for l in range(cfg.n_layer):
        layer = layer_params(l)
        if cfg.remat:
            x, aux = checkpoint(_block, x, layer, cfg, sp,
                                use_reentrant=False)
        else:
            x, aux = _block(x, layer, cfg, sp)
        auxes.append(aux)
    x = _layernorm(x, sp.param(params["lnf_g"], ("norm",)),
                   sp.param(params["lnf_b"], ("norm",)))
    return torch.einsum("bse,ve->bsv", x, wte), torch.stack(auxes).mean()


def moe_apply(params: ParamTree, tokens, cfg: MoEConfig, mesh=None):
    """tokens: [B, S] int → (logits [B, S, V] — a DTensor laid out (batch,
    seq, vocab) under a mesh — and the aux loss)."""
    sp = spmd(mesh)
    logits, aux = _logits(params, sp.tokens(tokens), cfg, sp)
    return wlc(sp.dist(logits, ("batch", "seq", "act_embed")),
               ("batch", "seq", "vocab"), mesh), aux


def moe_loss(params: ParamTree, tokens, cfg: MoEConfig, mesh=None):
    """Next-token cross-entropy + aux load-balance loss.  tokens: [B, S+1]."""
    sp = spmd(mesh)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    b, s = inputs.shape
    logits, aux = _logits(params, sp.tokens(inputs), cfg, sp)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, sp.tokens(targets)[..., None])[..., 0]
    return sp.total((logz - gold).sum()) / (b * s) + cfg.aux_loss_coef * aux
