"""Single-token decode attention over a KV cache — the serving hot op.

Port of ``ray_tpu/ops/decode_attention.py``.  ``decode_attention`` launches
the CUDA kernel ``csrc/decode_attention.cu`` (which replaces the Pallas
``_decode_kernel``) for CUDA tensors, in both forms and for any cache
length, and runs ``reference_decode_attention``, its plain PyTorch version,
only for CPU tensors.  The JAX ``kernel=``/``block_t`` knobs are gone: they
chose between paths by TPU measurements.

Layouts (head-major, nothing transposes on the hot path):
  q        [B, H, D];  k/v cache [L, B, Hkv, T, D];  k/v self [B, Hkv, D]
  pos      [B]  — index of the current token (attends [0, pos-1] + self)

The plain versions' f32 matmuls assume PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32) when they run
on the card as a yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

# dtype codes shared with csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {
    "decode_attention": [
        _I, _P, _P, _P, _P, _P, _P, _P,  # dtype, q, k, v, pos, k_self, v_self, out
        _I, _I, _I, _I, _I, _I,  # B, H, Hkv, T, D, layer
        ctypes.c_float, _P,  # scale, stream
    ],
}


def reference_decode_attention(q, k_cache, v_cache, pos, layer: int,
                               k_self=None, v_self=None):
    """Ground truth in plain PyTorch.  q [B,H,D]; caches [L,B,Hkv,T,D].

    Without self k/v: attends [0, pos] of the cache (current token assumed
    already written).  With self k/v: attends [0, pos-1] plus the explicit
    current token (the deferred-scatter form the kernel implements)."""
    k = k_cache[layer]  # [B, Hkv, T, D]
    v = v_cache[layer]
    b, hkv, t, d = k.shape
    h = q.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k).float() * scale
    limit = pos.to(k.device)[:, None, None, None]
    idx = torch.arange(t, device=k.device)[None, None, None, :]
    if k_self is None:
        scores = torch.where(idx <= limit, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgt,bktd->bkgd", probs.to(v.dtype), v)
        return out.reshape(b, h, d)
    scores = torch.where(idx < limit, scores, NEG_INF)  # strictly before
    s_self = (
        torch.einsum("bkgd,bkd->bkg", qg, k_self).float() * scale
    )[..., None]
    full = torch.cat([scores, s_self], dim=-1)
    probs = torch.softmax(full, dim=-1)
    out = torch.einsum(
        "bkgt,bktd->bkgd", probs[..., :-1].to(v.dtype), v
    ) + probs[..., -1:].to(v.dtype) * v_self[:, :, None, :]
    return out.reshape(b, h, d)


def write_token_to_cache(cache_arr, new, pos):
    """Write one token's k or v into the stacked cache, in place.

    cache_arr [L,B,Hkv,T,D]; new [L,B,Hkv,D]; pos [B] → cache_arr.  One
    batched index write for all layers and rows (the JAX version is a
    vmapped ``dynamic_update_slice`` returning a new array): advanced
    indices on dims 1 and 3 put the B axis first, hence the transpose."""
    rows = torch.arange(cache_arr.shape[1], device=cache_arr.device)
    cache_arr[:, rows, :, pos.to(torch.long)] = new.transpose(0, 1)
    return cache_arr


def decode_attention(q, k_cache, v_cache, pos, layer: int = 0, *,
                     k_self=None, v_self=None):
    """q [B,H,D], k/v cache [L,B,Hkv,T,D], pos [B] → [B,H,D].

    With ``k_self``/``v_self`` [B,Hkv,D] the current token's k/v are merged
    in the kernel and the cache is treated as holding only [0, pos-1]
    (deferred-scatter protocol); without them the cache row at ``pos`` must
    already be written.  CUDA tensors launch the kernel (counted in
    ``decode_attention.launches``); CPU tensors run the plain version."""
    if (k_self is None) != (v_self is None):
        raise ValueError("pass both k_self and v_self, or neither")
    if q.device.type == "cpu":
        return reference_decode_attention(
            q, k_cache, v_cache, pos, layer, k_self, v_self
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch(q, k_cache, v_cache, pos, layer, k_self, v_self)


decode_attention.launches = 0


def _launch(q, k_cache, v_cache, pos, layer, k_self, v_self):
    if q.dim() != 3 or k_cache.dim() != 5:
        raise ValueError("expected q [B,H,D] and caches [L,B,Hkv,T,D]")
    b, h, d = q.shape
    n_layer, cb, hkv, t, cd = k_cache.shape
    if (cb, cd) != (b, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"cache shape {tuple(k_cache.shape)} / {tuple(v_cache.shape)} "
            f"does not match q {tuple(q.shape)}"
        )
    if h % hkv != 0:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} out of range for {n_layer} layers")
    if pos.shape != (b,):
        raise ValueError(f"pos must be [B]={b}, got {tuple(pos.shape)}")
    tensors = [q, k_cache, v_cache]
    if k_self is not None:
        if k_self.shape != (b, hkv, d) or v_self.shape != (b, hkv, d):
            raise ValueError("k_self/v_self must be [B, Hkv, D]")
        tensors += [k_self, v_self]
    dtype = q.dtype
    if dtype not in DTYPE_CODES:
        raise ValueError(f"decode_attention: unsupported dtype {dtype}")
    for x in tensors:
        if x.device != q.device or x.dtype != dtype:
            raise ValueError("all operands must share q's device and dtype")
        if not x.is_contiguous():
            raise ValueError("decode_attention needs contiguous operands")
    # The kernel streams cache rows in 16-byte copies.
    if (d * q.element_size()) % 16 or k_cache.data_ptr() % 16 \
            or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention needs D * itemsize divisible by "
                         "16 and 16-byte aligned caches")
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("decode_attention", _SIGNATURE)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.decode_attention(
        DTYPE_CODES[dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos32.data_ptr(),
        k_self.data_ptr() if k_self is not None else None,
        v_self.data_ptr() if v_self is not None else None,
        out.data_ptr(), b, h, hkv, t, d, layer, d ** -0.5, stream,
    )
    _build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out
