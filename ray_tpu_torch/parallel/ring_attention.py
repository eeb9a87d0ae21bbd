"""Ring attention: blockwise context parallelism over the ``seq`` mesh axis
— port of ``ray_tpu/parallel/ring_attention.py``.

Q/K/V are sequence-sharded over the ``seq`` axis; each rank attends its
local Q block to the K/V block it currently holds and passes K/V on to
the next rank (``ppermute``), so memory per rank is O(S/n · S/n) per step
instead of O(S²).  The body is written against an axis exchange
(``parallel.exchange``): over a ``DeviceMesh`` one process is one rank,
and over a ``LocalGroup`` every rank runs in this process (on one card,
all on ``cuda:0``).

Two routes compute the same function, picked by device as every
attention of the port is:

  ``plain``   (CPU tensors): the JAX body's math — f32 block scores, the
              running (m, l, pv) merged by rescaling, the fully masked
              blocks above the diagonal included (they add 0) — and its
              gradient by autograd, as JAX differentiates the loop.
  ``kernel``  (CUDA tensors): ``_RingFlash``, whose forward runs the flash
              forward kernel on each block (the diagonal block causal,
              blocks below it not, blocks above it skipped: all blocks are
              S/n long, so no position offset is needed) and merges blocks
              by their f32 lse; its backward is a second ring that runs
              the dQ and dK/dV kernels under the global lse, each K/V
              block travelling with its f32 dK/dV accumulator until it is
              home.  On CPU tensors the kernel wrappers run their plain
              versions, so this route is testable off the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..ops import attention as _attn
from .exchange import LocalExchange, MeshExchange, ring_perm

NEG_INF = _attn.NEG_INF


def _block_attn(q, k, v, scale, causal, q_block_idx, kv_block_idx, s_local):
    """One blockwise step: unnormalized (m, l, pv) contributions.
    q/k/v: [B, S_local, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        pos = torch.arange(s_local, device=q.device)
        q_pos = q_block_idx * s_local + pos[:, None]
        k_pos = kv_block_idx * s_local + pos[None, :]
        s = torch.where((k_pos <= q_pos)[None, None], s, NEG_INF)
    m = s.amax(dim=-1)  # [B,H,Q]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)  # [B,H,Q]
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)  # unnormalized
    return m, l, pv


def _ring_plain(q, k, v, comm, axis, causal, scale):
    n = comm.size(axis)
    idx = comm.index(axis)
    b, s_local, h, d = q[0].shape
    f32 = torch.float32
    m_acc = [torch.full((b, h, s_local), NEG_INF, dtype=f32, device=x.device)
             for x in q]
    l_acc = [torch.zeros((b, h, s_local), dtype=f32, device=x.device)
             for x in q]
    o_acc = [torch.zeros((b, s_local, h, d), dtype=f32, device=x.device)
             for x in q]
    k_cur, v_cur = list(k), list(v)
    for i in range(n):
        for r in range(len(q)):
            kv_idx = (idx[r] - i) % n  # block the ring has delivered to us
            m_b, l_b, pv_b = _block_attn(
                q[r].float(), k_cur[r].float(), v_cur[r].float(), scale,
                causal, idx[r], kv_idx, s_local)
            m_new = torch.maximum(m_acc[r], m_b)
            alpha = torch.exp(m_acc[r] - m_new)  # rescale old accumulators
            beta = torch.exp(m_b - m_new)  # rescale this block
            l_acc[r] = l_acc[r] * alpha + l_b * beta
            o_acc[r] = (o_acc[r] * alpha.transpose(1, 2)[..., None]
                        + pv_b * beta.transpose(1, 2)[..., None])
            m_acc[r] = m_new
        if i < n - 1:  # rotate K/V to the next neighbour
            k_cur = comm.ppermute(k_cur, axis, ring_perm(n))
            v_cur = comm.ppermute(v_cur, axis, ring_perm(n))
    # l == 0 cannot happen: the diagonal block always holds k <= q.
    return [(o / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(x.dtype)
            for o, l, x in zip(o_acc, l_acc, q)]


def _causal_flag(n: int, my: int, step: int, causal: bool):
    """The kernel's causal flag for the block the ring delivers at
    ``step`` (block ``(my - step) % n``): True on the diagonal, False
    below it or without a mask, None for a block wholly above it."""
    kv = (my - step) % n
    if not causal or kv < my:
        return False
    return True if kv == my else None


def _rows(x, b, h, s):
    """``[B*H, S, 1]`` lse or delta as ``[B, S, H, 1]``, against out."""
    return x.view(b, h, s).transpose(1, 2)[..., None]


def _ring_flash_fwd(q, k, v, comm, axis, causal):
    n = comm.size(axis)
    idx = comm.index(axis)
    b, s, h, _ = q[0].shape
    out, lse = [None] * len(q), [None] * len(q)
    k_cur, v_cur = list(k), list(v)
    for i in range(n):
        for r in range(len(q)):
            flag = _causal_flag(n, idx[r], i, causal)
            if flag is None:
                continue
            o_b, lse_b = _attn._flash_fwd(q[r], k_cur[r], v_cur[r], flag)
            lse_b = _rows(lse_b, b, h, s)
            if out[r] is None:  # step 0: the diagonal block
                out[r], lse[r] = o_b.float(), lse_b
                continue
            new = torch.logaddexp(lse[r], lse_b)
            out[r] = (out[r] * torch.exp(lse[r] - new)
                      + o_b.float() * torch.exp(lse_b - new))
            lse[r] = new
        if i < n - 1:
            k_cur = comm.ppermute(k_cur, axis, ring_perm(n))
            v_cur = comm.ppermute(v_cur, axis, ring_perm(n))
    out = [o.to(x.dtype) for o, x in zip(out, q)]
    lse = [l[..., 0].transpose(1, 2).contiguous().view(b * h, s, 1)
           for l in lse]
    return out, lse


def _ring_flash_bwd(q, k, v, out, lse, do, comm, axis, causal):
    n = comm.size(axis)
    idx = comm.index(axis)
    held = range(len(q))
    delta = [_attn.flash_delta(out[r], do[r]) for r in held]
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          for x in q]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          for x in k]
    dv = [torch.zeros_like(x) for x in dk]
    k_cur, v_cur = list(k), list(v)
    for i in range(n):
        for r in held:
            flag = _causal_flag(n, idx[r], i, causal)
            if flag is None:
                continue
            args = (q[r], k_cur[r], v_cur[r], do[r], lse[r], delta[r], flag)
            dq[r] += _attn.flash_dq(*args).float()
            dk_b, dv_b = _attn.flash_dkv(*args)
            dk[r] += dk_b.float()
            dv[r] += dv_b.float()
        # Each dK/dV accumulator travels with its K/V block; after n hops
        # it is back on the rank that owns the block.
        dk = comm.ppermute(dk, axis, ring_perm(n))
        dv = comm.ppermute(dv, axis, ring_perm(n))
        if i < n - 1:
            k_cur = comm.ppermute(k_cur, axis, ring_perm(n))
            v_cur = comm.ppermute(v_cur, axis, ring_perm(n))
    return ([g.to(x.dtype) for g, x in zip(dq, q)],
            [g.to(x.dtype) for g, x in zip(dk, k)],
            [g.to(x.dtype) for g, x in zip(dv, v)])


class _RingFlash(torch.autograd.Function):
    """The kernel route over every rank this process holds: inputs and
    outputs are the per-rank tensors, flattened."""

    @staticmethod
    def forward(ctx, comm, axis, causal, *qkv):
        r = len(qkv) // 3
        q, k, v = qkv[:r], qkv[r:2 * r], qkv[2 * r:]
        out, lse = _ring_flash_fwd(q, k, v, comm, axis, causal)
        ctx.save_for_backward(*q, *k, *v, *out, *lse)
        ctx.args = (comm, axis, causal, r)
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *do):
        comm, axis, causal, r = ctx.args
        saved = ctx.saved_tensors
        q, k, v, out, lse = (saved[i * r:(i + 1) * r] for i in range(5))
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, do, comm, axis,
                                     causal)
        return (None, None, None, *dq, *dk, *dv)


def ring_attention_local(q, k, v, *, comm, axis_name: str = "seq",
                         causal: bool = True, route: Optional[str] = None):
    """The shard_map-inner ring attention over ``comm``'s ``axis_name``,
    scores scaled by D**-0.5 as the flash kernels scale them.

    q/k/v: [B, S_local, H, D], this rank's sequence shard, or a list with
    one per rank that ``comm`` holds (the result has the same form).
    ``route``: "kernel" or "plain", by default "kernel" for CUDA tensors.
    """
    single = torch.is_tensor(q)
    q, k, v = ([q], [k], [v]) if single else (list(q), list(k), list(v))
    if route is None:
        route = "kernel" if q[0].device.type == "cuda" else "plain"
    if route == "kernel":
        out = list(_RingFlash.apply(comm, axis_name, causal, *q, *k, *v))
    elif route == "plain":
        out = _ring_plain(q, k, v, comm, axis_name, causal,
                          q[0].shape[-1] ** -0.5)
    else:
        raise ValueError(f"unknown route {route!r}")
    return out[0] if single else out


def over_local_group(body, group, axis_name, xs, seq_dim: int = 1):
    """Run a shard_map-style ``body(list_q, list_k, list_v, comm=...)``
    single-controller over a ``LocalGroup``: split each global tensor of
    ``xs`` along ``seq_dim`` over the group's devices, run, and join the
    per-rank results on the first input's device."""
    comm = LocalExchange(group, axis_name)
    n = comm.size(axis_name)
    parts = [[c.to(comm.devices[r]) for r, c in
              enumerate(x.chunk(n, dim=seq_dim))] for x in xs]
    out = body(*parts, comm=comm)
    return torch.cat([o.to(xs[0].device) for o in out], dim=seq_dim)


def over_mesh(body, mesh, spec, xs):
    """Run ``body(q, k, v, comm=...)`` over a ``DeviceMesh``: reshard each
    input to the mesh-axis ``spec`` (a DTensor, or a plain tensor taken
    as the global value), hand the body the local shards, and wrap its
    output with the same placements.  DTensor in, DTensor out; a plain
    tensor in gives the whole plain tensor back."""
    from torch.distributed.tensor import DTensor, Replicate

    from .sharding import placements_for

    want = placements_for(mesh, spec)
    plain = not isinstance(xs[0], DTensor)
    local = []
    for x in xs:
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        local.append(x.to_local())
    out = body(*local, comm=MeshExchange(mesh))
    out = DTensor.from_local(out, mesh, want, run_check=False)
    return out.full_tensor() if plain else out


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   seq_axis: str = "seq", batch_axes=("data", "fsdp"),
                   head_axis: str = "model", route: Optional[str] = None):
    """Ring attention over ``mesh``'s ``seq_axis``: q/k/v [B, S, H, D]
    global tensors.  ``mesh`` is a ``DeviceMesh`` (one process a rank; B
    shards over ``batch_axes`` and H over ``head_axis`` too), or a
    ``LocalGroup`` whose ranks all run here (its one axis is the ring)."""
    def body(q, k, v, comm):
        return ring_attention_local(q, k, v, comm=comm, axis_name=seq_axis,
                                    causal=causal, route=route)

    if hasattr(mesh, "mesh_dim_names"):
        return over_mesh(body, mesh, (batch_axes, seq_axis, head_axis, None),
                         (q, k, v))
    return over_local_group(body, mesh, seq_axis, (q, k, v))
