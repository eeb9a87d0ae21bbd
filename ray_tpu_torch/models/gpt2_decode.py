"""KV-cache inference path for GPT-2: prefill + single-token decode.

Port of ``ray_tpu/models/gpt2_decode.py``.  The cache is the same pair of
layer-stacked head-major tensors ``[L, B, H, T_max, D]``; the port updates
it in place where JAX returns a new array.  Prefill's causal attention is
the flash-forward kernel on the card, and every decode layer's attention is
the decode kernel, which merges the current token's k/v itself
(deferred-scatter protocol): the 2L cache writes of a step happen once, at
its end, as one batched write.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import DeviceLike, dtype_of, resolve_device
from ..ops.attention import flash_attention
from ..ops.decode_attention import decode_attention, write_token_to_cache
from .gpt2 import GPT2Config, _gelu, _layernorm
from .params import ParamTree


def gpt2_init_cache(cfg: GPT2Config, batch: int, max_len: int,
                    device: DeviceLike = None):
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.head_dim)
    dt = dtype_of(cfg.dtype)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _qkv(x, layer):
    qkv = torch.einsum("bse,ethd->bsthd", x, layer["wqkv"]) + layer["bqkv"]
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@torch.inference_mode()
def gpt2_prefill(
    params: ParamTree, tokens, lengths, cache, cfg: GPT2Config
) -> Tuple[torch.Tensor, dict]:
    """Run the prompt through the model, filling the cache in place.

    tokens: [B, S] right-padded prompts; lengths: [B] true lengths.
    Returns (last_logits [B, V] f32, cache with positions [0, S) written).
    """
    s = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:s][None]
    x = x.to(dtype_of(cfg.dtype))
    for l in range(cfg.n_layer):
        layer = params.layer(l)
        y = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
        q, k, v = _qkv(y, layer)
        o = flash_attention(q, k, v, causal=True)
        x = x + (torch.einsum("bshd,hde->bse", o, layer["wo"])
                 + layer["bo"]).to(x.dtype)
        y = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
        h = _gelu(torch.einsum("bse,ef->bsf", y, layer["wi"]) + layer["bi"])
        x = x + (torch.einsum("bsf,fe->bse", h, layer["wo2"])
                 + layer["bo2"]).to(x.dtype)
        # [B, S, H, D] → head-major rows [0, S) of layer l.
        cache["k"][l, :, :, :s] = k.transpose(1, 2)
        cache["v"][l, :, :, :s] = v.transpose(1, 2)
    x = _layernorm(x, params["lnf_g"], params["lnf_b"])
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, lengths.to(device=x.device, dtype=torch.long) - 1]
    logits = torch.einsum("be,ve->bv", last, params["wte"])
    return logits.float(), cache


@torch.inference_mode()
def gpt2_decode_step(
    params: ParamTree, tokens, pos, cache, cfg: GPT2Config
) -> Tuple[torch.Tensor, dict]:
    """One generation step for a ragged batch.

    tokens: [B] the most recent token per slot; pos: [B] its position.
    Attends each slot to its own ``[0, pos]`` and writes k/v at ``pos``.
    Returns (logits [B, V] f32, the cache, updated in place).
    """
    x = params["wte"][tokens] + params["wpe"][pos]
    x = x.to(dtype_of(cfg.dtype))  # [B, E]
    ck, cv = cache["k"], cache["v"]
    b = tokens.shape[0]
    new_k = torch.empty((cfg.n_layer, b, cfg.n_head, cfg.head_dim),
                        dtype=ck.dtype, device=ck.device)
    new_v = torch.empty_like(new_k)
    for l in range(cfg.n_layer):
        layer = params.layer(l)
        y = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
        qkv = torch.einsum("be,ethd->bthd", y, layer["wqkv"]) + layer["bqkv"]
        q = qkv[:, 0].contiguous()  # [B, H, D]
        new_k[l] = qkv[:, 1]
        new_v[l] = qkv[:, 2]
        # Deferred-scatter protocol: the cache holds [0, pos-1]; the
        # current token's k/v are merged in the kernel and written below.
        o = decode_attention(q, ck, cv, pos, l, k_self=new_k[l],
                             v_self=new_v[l])
        x = x + (torch.einsum("bhd,hde->be", o.to(y.dtype), layer["wo"])
                 + layer["bo"]).to(x.dtype)
        y = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
        h = _gelu(torch.einsum("be,ef->bf", y, layer["wi"]) + layer["bi"])
        x = x + (torch.einsum("bf,fe->be", h, layer["wo2"])
                 + layer["bo2"]).to(x.dtype)
    write_token_to_cache(ck, new_k, pos)
    write_token_to_cache(cv, new_v, pos)
    x = _layernorm(x, params["lnf_g"], params["lnf_b"])
    logits = torch.einsum("be,ve->bv", x, params["wte"])
    return logits.float(), cache


@torch.inference_mode()
def gpt2_decode_multi(
    params: ParamTree, tokens, pos, cache, cfg: GPT2Config, n_steps: int
):
    """Multi-step greedy decode: ``n_steps`` tokens with the argmax on the
    device and no host sync between steps (the JAX version's ``lax.scan``
    written out as a loop).  Returns (tokens_out [n_steps, B] int32,
    next_tokens [B], next_pos [B], the cache, updated in place)."""
    toks, p = tokens, pos
    out = torch.empty((n_steps, tokens.shape[0]), dtype=torch.int32,
                      device=tokens.device)
    for i in range(n_steps):
        logits, cache = gpt2_decode_step(params, toks, p, cache, cfg)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out[i] = toks
        p = p + 1
    return out, toks, p, cache


def sample_logits(logits, gen: Optional[torch.Generator], temperature: float,
                  top_k: int = 0, top_p: float = 1.0):
    """Temperature / top-k / top-p sampling on [B, V] logits (greedy when
    temperature == 0).  Draws from ``gen`` where the JAX version splits a
    ``jax.random`` key, so sampled tokens match JAX only in distribution."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature <= 0.0:
        return greedy
    scaled = filter_logits(logits, temperature, top_k, top_p)
    probs = torch.softmax(scaled.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def filter_logits(logits, temperature: float, top_k: int = 0,
                  top_p: float = 1.0):
    """The tempered logits ``sample_logits`` draws from, with the tokens
    that top-k / top-p exclude set to -1e30 (same rules as the JAX
    ``sample_logits``)."""
    scaled = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, -1e30, scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Smallest set with cumulative prob >= top_p; find the cutoff logit.
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.int8), dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff, -1e30, scaled)
    return scaled
