"""Attention ops: plain PyTorch reference + the flash-forward CUDA kernel.

Port of ``ray_tpu/ops/attention.py``, forward only:

  - ``reference_attention``: plain einsum softmax (f32 softmax, masked
    scores at ``NEG_INF``), the CPU path and the ground truth;
  - ``flash_attention`` / ``_flash_fwd``: the blocked online-softmax kernel
    ``csrc/flash_fwd.cu`` (which replaces the Pallas ``_flash_fwd_kernel``)
    for CUDA tensors of any sequence length, and the plain version for CPU
    tensors.  ``_flash_fwd`` also returns the per-row f32 ``lse`` as
    ``[B*H, Sq, 1]``, like the JAX function of that name.

The backward kernels (``_flash_dq_kernel``, ``_flash_dkv_kernel``) and the
``torch.autograd.Function`` that wires them come with the training slice.
The plain versions' f32 matmuls assume PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32) when they run
on the card as a yardstick.
"""

from __future__ import annotations

import ctypes
import torch

from . import _build
from .decode_attention import DTYPE_CODES

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.c_longlong * 3
_STRIDES_P = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURE = {
    "flash_fwd": [
        _I, _I, _P, _P, _P, _P, _P,  # dtype, D, q, k, v, out, lse
        _I, _I, _I, _I,  # B, H, Sq, Sk
        _STRIDES_P, _STRIDES_P, _STRIDES_P,  # q/k/v strides of B, S, H
        _I, ctypes.c_float, _P,  # causal, scale, stream
    ],
}
HEAD_DIMS = (64, 128)


def _masked_scores(q, k, causal):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where((k_pos <= q_pos)[None, None], scores, NEG_INF)
    return scores.float()


def reference_attention(q, k, v, *, causal: bool = True):
    """q: [B, Sq, H, D]; k/v: [B, Sk, H, D] → [B, Sq, H, D].  (The JAX
    version's q/k offsets and scale override serve ring attention, which
    is not ported yet.)"""
    scores = _masked_scores(q, k, causal)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def reference_lse(q, k, *, causal: bool = True):
    """Per-row f32 logsumexp of the masked scores, as ``[B*H, Sq, 1]``."""
    b, sq, h, _ = q.shape
    scores = _masked_scores(q, k, causal)
    return torch.logsumexp(scores, dim=-1).reshape(b * h, sq, 1)


def _flash_fwd(q, k, v, causal: bool = True):
    """(out [B,Sq,H,D], lse [B*H,Sq,1] f32).  CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``); CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return (reference_attention(q, k, v, causal=causal),
                reference_lse(q, k, causal=causal))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal)


def flash_attention(q, k, v, *, causal: bool = True):
    """Forward flash attention, q/k/v: [B, S, H, D] → [B, S, H, D].  Any
    sequence length goes to the kernel on CUDA tensors; D must be 64 or
    128 there."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal)
    return _flash_fwd(q, k, v, causal)[0]


flash_attention.launches = 0


def _launch(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("expected q [B,Sq,H,D] and k/v [B,Sk,H,D]")
    b, sq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    for x in (q, k, v):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("q, k and v must share device and dtype")
        if x.stride(-1) != 1:
            raise ValueError("flash_attention needs the last dim contiguous")
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd", _SIGNATURE)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_fwd(
        DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, sq, sk,
        _STRIDES(q.stride(0), q.stride(1), q.stride(2)),
        _STRIDES(k.stride(0), k.stride(1), k.stride(2)),
        _STRIDES(v.stride(0), v.stride(1), v.stride(2)),
        int(causal), d ** -0.5, stream,
    )
    _build.check(lib, code, "flash_fwd")
    flash_attention.launches += 1
    return out, lse
