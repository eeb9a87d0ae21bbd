"""KV-cache inference path for the Llama family: prefill + ragged decode.

Port of ``ray_tpu/models/llama_decode.py``: the same head-major stacked
cache ``[L, B, Hkv, T, D]`` holding only the kv heads (GQA), updated in
place.  Prefill repeats k/v across each query-head group for its causal
attention (the flash-forward kernel on the card) and caches the Hkv heads;
decode attends each group of H/Hkv query heads to its shared kv head in the
decode kernel, with each slot's own rotary position, and writes all
layers' k/v once at the end of the step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike, dtype_of, resolve_device
from ..ops.attention import flash_attention
from ..ops.decode_attention import decode_attention, write_token_to_cache
from .llama import LlamaConfig, _rmsnorm, _swiglu, rope
from .params import ParamTree


def llama_init_cache(cfg: LlamaConfig, batch: int, max_len: int,
                     device: DeviceLike = None):
    shape = (cfg.n_layer, batch, cfg.n_kv_head, max_len, cfg.head_dim)
    dt = dtype_of(cfg.dtype)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.inference_mode()
def llama_prefill(
    params: ParamTree, tokens, lengths, cache, cfg: LlamaConfig
) -> Tuple[torch.Tensor, dict]:
    """tokens: [B, S] right-padded prompts; lengths: [B] true lengths.
    Returns (last_logits [B, V] f32, cache with positions [0, S) written in
    place)."""
    s = tokens.shape[1]
    groups = cfg.n_head // cfg.n_kv_head
    x = params["wte"][tokens].to(dtype_of(cfg.dtype))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for l in range(cfg.n_layer):
        layer = params.layer(l)
        y = _rmsnorm(x, layer["rms1"], cfg.rms_eps)
        q = torch.einsum("bse,ehd->bshd", y, layer["wq"])
        k = torch.einsum("bse,ekd->bskd", y, layer["wk"])
        v = torch.einsum("bse,ekd->bskd", y, layer["wv"])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        kr = torch.repeat_interleave(k, groups, dim=2)
        vr = torch.repeat_interleave(v, groups, dim=2)
        o = flash_attention(q, kr, vr, causal=True)
        x = x + torch.einsum("bshd,hde->bse", o, layer["wo"]).to(x.dtype)
        y = _rmsnorm(x, layer["rms2"], cfg.rms_eps)
        x = x + _swiglu(y, layer).to(x.dtype)
        # [B, S, Hkv, D] → head-major rows [0, S) of layer l.
        cache["k"][l, :, :, :s] = k.transpose(1, 2)
        cache["v"][l, :, :, :s] = v.transpose(1, 2)
    x = _rmsnorm(x, params["rms_f"], cfg.rms_eps)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, lengths.to(device=x.device, dtype=torch.long) - 1]
    logits = torch.einsum("be,ve->bv", last, params["lm_head"])
    return logits.float(), cache


@torch.inference_mode()
def llama_decode_step(
    params: ParamTree, tokens, pos, cache, cfg: LlamaConfig
) -> Tuple[torch.Tensor, dict]:
    """tokens: [B]; pos: [B] position of each token.  Ragged decode with
    per-slot rotary positions.  Returns (logits [B, V] f32, the cache,
    updated in place)."""
    x = params["wte"][tokens].to(dtype_of(cfg.dtype))  # [B, E]
    ck, cv = cache["k"], cache["v"]
    b = tokens.shape[0]
    new_k = torch.empty((cfg.n_layer, b, cfg.n_kv_head, cfg.head_dim),
                        dtype=ck.dtype, device=ck.device)
    new_v = torch.empty_like(new_k)
    for l in range(cfg.n_layer):
        layer = params.layer(l)
        y = _rmsnorm(x, layer["rms1"], cfg.rms_eps)
        q = torch.einsum("be,ehd->bhd", y, layer["wq"])
        k = torch.einsum("be,ekd->bkd", y, layer["wk"])
        v = torch.einsum("be,ekd->bkd", y, layer["wv"])
        # rope expects [B, S, H, D]; per-slot positions ride the batch dim.
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        new_k[l] = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        new_v[l] = v
        # Deferred-scatter protocol (see gpt2_decode.py): the cache holds
        # [0, pos-1]; the current k/v are merged in the kernel.
        o = decode_attention(q, ck, cv, pos, l, k_self=new_k[l],
                             v_self=new_v[l])  # [B, H, D]
        x = x + torch.einsum(
            "bhd,hde->be", o.to(y.dtype), layer["wo"]
        ).to(x.dtype)
        y = _rmsnorm(x, layer["rms2"], cfg.rms_eps)
        x = x + _swiglu(y[:, None], layer)[:, 0].to(x.dtype)
    write_token_to_cache(ck, new_k, pos)
    write_token_to_cache(cv, new_v, pos)
    x = _rmsnorm(x, params["rms_f"], cfg.rms_eps)
    logits = torch.einsum("be,ve->bv", x, params["lm_head"])
    return logits.float(), cache
