"""Attention ops: plain PyTorch references + the flash CUDA kernels.

Port of ``ray_tpu/ops/attention.py``:

  - ``reference_attention``: plain einsum softmax (f32 softmax, masked
    scores at ``NEG_INF``), the CPU path and the ground truth;
  - ``_flash_fwd``: the blocked online-softmax kernel ``csrc/flash_fwd.cu``
    (which replaces the Pallas ``_flash_fwd_kernel``) for CUDA tensors of
    any sequence length, and the plain version for CPU tensors.  It also
    returns the per-row f32 ``lse`` as ``[B*H, Sq, 1]``, like the JAX
    function of that name;
  - ``flash_dq`` / ``flash_dkv``: the two backward kernels of
    ``csrc/flash_bwd.cu`` (replacing ``_flash_dq_kernel`` and
    ``_flash_dkv_kernel``), each beside its plain version
    ``reference_flash_dq`` / ``reference_flash_dkv``, which follow the JAX
    kernels' recipe and round where they round;
  - ``_flash_bwd``: ``delta = rowsum(dO * O)`` in plain PyTorch (the JAX
    package computes it outside Pallas too), then both kernels;
  - ``flash_attention``: the ``torch.autograd.Function`` ``_Flash`` whose
    forward is ``_flash_fwd`` and whose backward is ``_flash_bwd``, on the
    CPU as on the card.

Which design runs is fixed by the dtype inside the C entry points: bf16
goes to the tensor-core kernels (wgmma on TMA-fed tiles) for the forward,
dQ and dK/dV, f32 to the FMA kernels (wgmma on f32 would run in TF32).
``tma_ready`` copies a bf16 tensor that TMA cannot read in place before it
reaches a TMA kernel.

The plain versions' f32 matmuls assume PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32) when they run
on the card as a yardstick.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .decode_attention import DTYPE_CODES

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.c_longlong * 3
_STRIDES_P = ctypes.POINTER(ctypes.c_longlong)
_FWD_SIGNATURE = {
    "flash_fwd": [
        _I, _I, _P, _P, _P, _P, _P,  # dtype, D, q, k, v, out, lse
        _I, _I, _I, _I,  # B, H, Sq, Sk
        _STRIDES_P, _STRIDES_P, _STRIDES_P,  # q/k/v strides of B, S, H
        _I, ctypes.c_float, _P,  # causal, scale, stream
    ],
}
_BWD_INPUTS = [
    _I, _I, _P, _P, _P, _P, _P, _P,  # dtype, D, q, k, v, do, lse, delta
]
_BWD_SHAPE = [
    _I, _I, _I, _I,  # B, H, Sq, Sk
    _STRIDES_P, _STRIDES_P, _STRIDES_P, _STRIDES_P,  # q/k/v/do strides
    _I, ctypes.c_float, _P,  # causal, scale, stream
]
_BWD_SIGNATURE = {
    "flash_dq": _BWD_INPUTS + [_P] + _BWD_SHAPE,  # dq
    "flash_dkv": _BWD_INPUTS + [_P, _P] + _BWD_SHAPE,  # dk, dv
}
HEAD_DIMS = (64, 128)


def _causal_mask(sq: int, sk: int, device):
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    return k_pos <= q_pos


def _masked_scores(q, k, causal):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    return scores.float()


def reference_attention(q, k, v, *, causal: bool = True):
    """q: [B, Sq, H, D]; k/v: [B, Sk, H, D] → [B, Sq, H, D].  (The JAX
    version's q/k offsets and scale override serve its ring attention;
    the port's ring has its own block step, ``parallel.ring_attention``.)"""
    scores = _masked_scores(q, k, causal)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def reference_lse(q, k, *, causal: bool = True):
    """Per-row f32 logsumexp of the masked scores, as ``[B*H, Sq, 1]``."""
    b, sq, h, _ = q.shape
    scores = _masked_scores(q, k, causal)
    return torch.logsumexp(scores, dim=-1).reshape(b * h, sq, 1)


def reference_flash_fwd(q, k, v, causal: bool = True):
    """Plain version of the forward kernel: (out, lse)."""
    return (reference_attention(q, k, v, causal=causal),
            reference_lse(q, k, causal=causal))


def flash_delta(o, do):
    """``delta = rowsum(dO * O)`` in f32 as ``[B*H, Sq, 1]``, the layout of
    ``lse`` (``ray_tpu/ops/attention.py:250``)."""
    b, sq, h, _ = o.shape
    delta = (do.float() * o.float()).sum(-1)  # [B, Sq, H]
    return delta.transpose(1, 2).contiguous().view(b * h, sq, 1)


def _bwd_probs(q, k, v, do, lse, delta, causal):
    """The backward kernels' shared recipe in f32, as ``[B, H, Sq, Sk]``:
    P = exp(S·scale, masked, − lse) recomputed from the saved ``lse``, and
    the f32 dS = P·(dO·Vᵀ − delta)."""
    b, sq, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if causal:
        s = torch.where(_causal_mask(sq, k.shape[1], q.device)[None, None],
                        s, NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.reshape(b, h, sq, 1))


def reference_flash_dq(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of ``flash_dq``: dQ = scale·dS·K, with dS rounded to
    the input dtype first, as ``_flash_dq_kernel`` rounds it
    (``ray_tpu/ops/attention.py:173-175``)."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal)
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def reference_flash_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of ``flash_dkv``: dV = Pᵀ·dO and dK = scale·dSᵀ·Q,
    with P and dS rounded to the input dtype first, as
    ``_flash_dkv_kernel`` rounds them (``attention.py:218-222``)."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def reference_flash_bwd(q, k, v, o, lse, do, causal: bool = True):
    """Plain version of both backward kernels: (dq, dk, dv) from the
    forward's inputs, output and ``lse`` and the output's gradient."""
    delta = flash_delta(o, do)
    dq = reference_flash_dq(q, k, v, do, lse, delta, causal)
    return (dq, *reference_flash_dkv(q, k, v, do, lse, delta, causal))


def _flash_fwd(q, k, v, causal: bool = True):
    """(out [B,Sq,H,D], lse [B*H,Sq,1] f32).  CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``); CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return reference_flash_fwd(q, k, v, causal)
    _check_device(q)
    return _launch_fwd(q, k, v, causal)


def flash_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dQ [B,Sq,H,D] of flash attention.  CUDA tensors launch the kernel
    (counted in ``flash_dq.launches``); CPU tensors run
    ``reference_flash_dq``."""
    if q.device.type == "cpu":
        return reference_flash_dq(q, k, v, do, lse, delta, causal)
    _check_device(q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_dq", q, k, v, do, lse, delta, (dq,), causal)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dK, dV), each [B,Sk,H,D], of flash attention.  CUDA tensors launch
    the kernel (counted in ``flash_dkv.launches``); CPU tensors run
    ``reference_flash_dkv``."""
    if q.device.type == "cpu":
        return reference_flash_dkv(q, k, v, do, lse, delta, causal)
    _check_device(q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_dkv", q, k, v, do, lse, delta, (dk, dv), causal)
    flash_dkv.launches += 1
    return dk, dv


flash_dq.launches = 0
flash_dkv.launches = 0


def _flash_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv): ``delta`` in plain PyTorch, then the dQ and the dK/dV
    kernels (their plain versions on CPU tensors)."""
    delta = flash_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_dkv(q, k, v, do, lse, delta, causal))


class _Flash(torch.autograd.Function):
    """``jax.custom_vjp`` of ``ray_tpu/ops/attention.py:314-335``: the
    forward saves ``(q, k, v, out, lse)``, the backward runs both kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, do, ctx.causal), None)


def flash_attention(q, k, v, *, causal: bool = True):
    """Flash attention, q/k/v: [B, S, H, D] → [B, S, H, D], differentiable.
    Any sequence length goes to the kernels on CUDA tensors; D must be 64
    or 128 there."""
    return _Flash.apply(q, k, v, causal)


flash_attention.launches = 0


def _check_device(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _check_qkv(q, k, v, *more):
    """Shapes, head dim, dtype, device and a contiguous last dim: what the
    kernels take.  ``more`` are tensors shaped like q (the backward's
    ``do``)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("expected q [B,Sq,H,D] and k/v [B,Sk,H,D]")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    for x in (q, k, v, *more):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("q, k, v and do must share device and dtype")
        if x.stride(-1) != 1:
            raise ValueError("flash_attention needs the last dim contiguous")
    for x in more:
        if x.shape != q.shape:
            raise ValueError(f"do {tuple(x.shape)} does not match q "
                             f"{tuple(q.shape)}")


def _strides(x):
    return _STRIDES(x.stride(0), x.stride(1), x.stride(2))


def tma_ready(x):
    """``x`` itself when TMA can read it in place, else a contiguous copy.

    A TMA tensor map over [B, S, H, D] needs a 16-byte-aligned base, a
    contiguous last dim, B/S/H strides that are multiples of 16 bytes, and
    each stride covering the dim inside it (GPT-2's slices of the fused
    qkv and contiguous tensors qualify).  Anything else is copied."""
    item = x.element_size()
    size, stride = x.shape, x.stride()
    inner = size[-1] * item  # bytes spanned by the dims inside each stride
    ok = x.data_ptr() % 16 == 0 and stride[-1] == 1
    for dim in (2, 1, 0):
        ok = ok and stride[dim] * item % 16 == 0 and stride[dim] * item >= inner
        inner = stride[dim] * item * size[dim]
    # A fresh allocation: ``contiguous()`` would hand back a tensor that is
    # contiguous already but sits at an unaligned offset.
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _launch_fwd(q, k, v, causal):
    _check_qkv(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd", _FWD_SIGNATURE)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_fwd(
        DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, sq, sk,
        _strides(q), _strides(k), _strides(v), int(causal), d ** -0.5,
        stream,
    )
    _build.check(lib, code, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def _launch_bwd(fn, q, k, v, do, lse, delta, outs, causal):
    """Launch ``fn`` (``flash_dq`` or ``flash_dkv``) of ``csrc/flash_bwd.cu``
    into the contiguous ``outs``.  q/k/v/do are read through their B, S
    and H strides, as the forward reads q/k/v; a ``do`` whose last dim is
    not contiguous (an expanded gradient, say) is copied first."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_qkv(q, k, v, do)
    if q.dtype == torch.bfloat16:
        q, k, v, do = (tma_ready(x) for x in (q, k, v, do))
    b, sq, h, d = q.shape
    for x in (lse, delta):
        if (x.shape != (b * h, sq, 1) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError("lse and delta must be contiguous f32 "
                             f"[B*H, Sq, 1] = {(b * h, sq, 1)} on q's device")
    lib = _build.load("flash_bwd", _BWD_SIGNATURE)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = getattr(lib, fn)(
        DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(x.data_ptr() for x in outs), b, h, sq, k.shape[1],
        _strides(q), _strides(k), _strides(v), _strides(do), int(causal),
        d ** -0.5, stream,
    )
    _build.check(lib, code, fn)
