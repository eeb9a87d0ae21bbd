"""Single-token decode attention over a KV cache — the serving hot op.

Port of ``ray_tpu/ops/decode_attention.py``.  ``decode_attention`` launches
the CUDA kernel ``csrc/decode_attention.cu`` (which replaces the Pallas
``_decode_kernel``) for CUDA tensors, in both forms and for any cache
length, and runs ``reference_decode_attention``, its plain PyTorch version,
only for CPU tensors.  The JAX ``kernel=``/``block_t`` knobs are gone: they
chose between paths by TPU measurements.

The kernel splits each row's cache into ``SPLIT_T``-row splits, one block
each (``split_plan``), and merges the splits' partial softmax states in
split order; ``reference_decode_attention_split`` is the plain version of
that recipe, which ``chip_smoke.py`` and the tests hold against both the
JAX kernel and ``reference_decode_attention``.  Nothing on the main path
calls it.

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
        _P, _P,  # partials scratch, merge counters
        _I, _I, _I, _I, _I, _I,  # B, H, Hkv, T, D, layer
        _I, _I,  # split_t, n_split
        ctypes.c_float, _P,  # scale, stream
    ],
}
# Cache rows per block of the kernel.  Smaller splits merge more partials
# and launch more blocks than the SMs hold at once; larger ones leave SMs
# idle when the rows of a batch are short.
SPLIT_T = 256
# Most query rows per kv head the kernel takes.
MAX_GROUP = 8


def split_plan(t_max: int):
    """The kernel's splits of a cache of ``t_max`` rows: ``(start, stop)``
    row ranges, one block each; the grid's second dim is their number."""
    return [(s, min(s + SPLIT_T, t_max)) for s in range(0, t_max, SPLIT_T)]


def reference_decode_attention_split(q, k_cache, v_cache, pos, layer: int,
                                     k_self=None, v_self=None):
    """Plain version of the split kernel's recipe, in f32: per split of
    ``split_plan``, a partial softmax state (max m, sum l, unnormalized
    acc) over the split's live rows; the live splits merged in split order
    (their max first, then the sums rescaled to it), then the current token
    as a final length-1 block.  A split with no live row is never merged.
    Same function as ``reference_decode_attention``."""
    k = k_cache[layer].float()  # [B, Hkv, T, D]
    v = v_cache[layer].float()
    b, hkv, t, d = k.shape
    h = q.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d).float() * d ** -0.5
    pos = pos.to(k.device).long()
    live = (pos if k_self is not None else pos + 1).clamp(0, t)  # [B]
    parts = []  # per split: (has a live row [B,1,1], m, l, acc)
    for start, stop in split_plan(t):
        idx = torch.arange(start, stop, device=k.device)
        valid = (idx[None, :] < live[:, None])[:, None, None, :]  # [B,1,1,n]
        s = torch.einsum("bkgd,bktd->bkgt", qg, k[:, :, start:stop])
        s = torch.where(valid, s, NEG_INF)
        m_s = s.amax(-1)
        p = torch.where(valid, torch.exp(s - m_s[..., None]), 0.0)
        parts.append(((live > start)[:, None, None], m_s, p.sum(-1),
                      torch.einsum("bkgt,bktd->bkgd", p, v[:, :, start:stop])))
    m = torch.full(qg.shape[:3], NEG_INF, device=k.device)
    for has_live, m_s, _, _ in parts:
        m = torch.where(has_live, torch.maximum(m, m_s), m)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for has_live, m_s, l_s, acc_s in parts:
        w = torch.where(has_live, torch.exp(m_s - m), 0.0)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    if k_self is not None:  # a final length-1 block
        s_self = (qg * k_self.float()[:, :, None, :]).sum(-1)
        m_n = torch.maximum(m, s_self)
        x, y = torch.exp(m - m_n), torch.exp(s_self - m_n)
        l = l * x + y
        acc = acc * x[..., None] + y[..., None] * v_self.float()[:, :, None, :]
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


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
    # The kernel streams cache rows in 16-byte copies, a power-of-two
    # number of lanes a row.
    chunks, rem = divmod(d * q.element_size(), 16)
    if rem or chunks > 32 or chunks & (chunks - 1) or k_cache.data_ptr() % 16 \
            or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention needs D * itemsize = 16 bytes "
                         "times a power of two up to 512 and 16-byte "
                         "aligned caches")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention takes at most {MAX_GROUP} query "
                         f"heads per kv head, got {h // hkv}")
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    n_split = len(split_plan(t))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counter = _scratch(q.device, stream, b * hkv, n_split,
                             (h // hkv) * (d + 2))
    lib = _build.load("decode_attention", _SIGNATURE)
    code = lib.decode_attention(
        DTYPE_CODES[dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos32.data_ptr(),
        k_self.data_ptr() if k_self is not None else None,
        v_self.data_ptr() if v_self is not None else None,
        out.data_ptr(), part.data_ptr(), counter.data_ptr(),
        b, h, hkv, t, d, layer, SPLIT_T, n_split, d ** -0.5, stream,
    )
    _build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    return out


# (device, stream, B*Hkv, n_split, floats a partial) -> (partials,
# counters).  The kernel leaves the counters at 0, so nothing is cleared per
# call.  The buffers are reused by the next call of the same shape on the
# same stream, which runs after it in stream order; calls on two streams
# (two engines in one process, or a CUDA graph captured on its own stream)
# never share them.  A graph bakes in the addresses of the buffers its
# capture used, so its capture stream's entry must be made before the
# capture, by a warm-up call on that stream, and lives until the stream's
# owner drops it with ``release_scratch`` (a continuous-batching engine does
# so when it is collected, graphs and all).
_SCRATCH = {}


def _scratch(device, stream: int, rows: int, n_split: int, floats: int):
    key = (device, stream, rows, n_split, floats)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = (torch.empty((rows, n_split, floats), dtype=torch.float32,
                            device=device),
                torch.zeros(rows, dtype=torch.int32, device=device))
        _SCRATCH[key] = bufs
    return bufs


def release_scratch(stream: int) -> None:
    """Drop the scratch of every shape made for calls on ``stream``.  Only
    for a stream no call or graph will use again."""
    for key in [k for k in _SCRATCH if k[1] == stream]:
        del _SCRATCH[key]
