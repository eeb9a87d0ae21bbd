"""Axis exchanges: the collectives a shard_map body calls, over a named
mesh axis.

The JAX package writes its parallel bodies (the ring, Ulysses, the GPipe
loop) inside ``shard_map``, where ``jax.lax.ppermute``, ``psum`` and
``all_to_all`` exchange over a named axis and ``jax.grad`` differentiates
through them.  The port writes each body once against an exchange object
with the same four operations, in the pattern of
``collective/algorithms.Comm``: a body holds a list of per-rank tensors,
one entry for each rank that this process runs.

  ``MeshExchange``   one process per rank over a ``DeviceMesh``: every
                     list has one entry, and an axis exchange is a
                     ``torch.distributed`` collective on the process group
                     of that mesh dim (gloo on the CPU, NCCL on cards).
  ``LocalExchange``  every rank in this process (a ``LocalGroup``'s
                     devices, all ``cuda:0`` on one card): an exchange is
                     a device copy, so the ring and Ulysses bodies run
                     single-controller (``ppermute`` and ``all_to_all``).

Each operation is differentiable as its JAX counterpart is under
``shard_map``: ``ppermute``'s gradient is the inverse permutation,
``all_to_all``'s the inverse all-to-all; ``psum``'s output is taken as
replicated, so its gradient passes through, and ``copy_to`` is its
transpose (identity forward, the gradient summed over the axis) — the two
halves of a tensor-parallel matmul.  ``allreduce`` sums per-rank partial
values whose outputs each rank goes on using on its own (a batch norm's
statistics): forward and backward are both a psum.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Perm = Sequence[Tuple[int, int]]


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """Each position sends to the next: ``[(i, (i + 1) % n)]``."""
    return [(i, (i + 1) % n) for i in range(n)]


def _a2a_local(x, n, split_dim, concat_dim, exchange):
    """Split ``x`` in ``n`` along ``split_dim``, send part j to position j,
    concatenate what arrives along ``concat_dim`` in position order."""
    parts = torch.stack([c.contiguous() for c in x.chunk(n, dim=split_dim)])
    got = exchange(parts)
    return torch.cat(list(got.unbind(0)), dim=concat_dim)


class MeshExchange:
    """The exchange of one process over the axes of a ``DeviceMesh``."""

    def __init__(self, mesh):
        self.mesh = mesh

    def size(self, axis: str) -> int:
        from .mesh import axis_size

        return axis_size(self.mesh, axis)

    def index(self, axis: str) -> List[int]:
        return [self.mesh.get_local_rank(axis)]

    def _group(self, axis: str):
        return self.mesh.get_group(axis)

    # Plain (no-autograd) collectives on one tensor.

    def _ppermute(self, x, axis: str, perm: Perm):
        import torch.distributed as dist

        me = self.index(axis)[0]
        dst = next((d for s, d in perm if s == me), None)
        src = next((s for s, d in perm if d == me), None)
        x = x.contiguous()
        if dst == me and src == me:
            return x.clone()
        g = self._group(axis)
        buf = torch.zeros_like(x)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(g, dst), g))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(g, src), g))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return buf

    def _psum(self, x, axis: str):
        import torch.distributed as dist

        out = x.contiguous().clone()
        if self.size(axis) > 1:
            dist.all_reduce(out, group=self._group(axis))
        return out

    def _all_to_all(self, x, axis: str, split_dim: int, concat_dim: int):
        import torch.distributed as dist

        n = self.size(axis)
        if n == 1:
            return x.clone()

        def exchange(parts):
            out = torch.empty_like(parts)
            dist.all_to_all_single(out, parts, group=self._group(axis))
            return out

        return _a2a_local(x, n, split_dim, concat_dim, exchange)

    # The body's operations: lists of one tensor, differentiable.

    def ppermute(self, xs, axis: str, perm: Perm):
        return [_PPermute.apply(xs[0], self, axis, tuple(perm))]

    def psum(self, xs, axis: str):
        return [_PSum.apply(xs[0], self, axis)]

    def copy_to(self, xs, axis: str):
        return [_CopyTo.apply(xs[0], self, axis)]

    def allreduce(self, xs, axis: str):
        return [_AllReduce.apply(xs[0], self, axis)]

    def all_to_all(self, xs, axis: str, split_dim: int, concat_dim: int):
        return [_AllToAll.apply(xs[0], self, axis, split_dim, concat_dim)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axis, perm):
        ctx.ex, ctx.axis = ex, axis
        ctx.inverse = tuple((d, s) for s, d in perm)
        return ex._ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex._ppermute(g, ctx.axis, ctx.inverse), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axis):
        return ex._psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axis):
        ctx.ex, ctx.axis = ex, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex._psum(g, ctx.axis), None, None


class _AllReduce(torch.autograd.Function):
    """A sum over the axis of per-rank partial values (a batch norm's
    statistics over a split batch): each rank's output feeds its own
    partial loss, so the cotangents are summed over the axis as well."""

    @staticmethod
    def forward(ctx, x, ex, axis):
        ctx.ex, ctx.axis = ex, axis
        return ex._psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex._psum(g, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, axis, split_dim, concat_dim):
        ctx.args = (ex, axis, split_dim, concat_dim)
        return ex._all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        ex, axis, split_dim, concat_dim = ctx.args
        return (ex._all_to_all(g, axis, concat_dim, split_dim),
                None, None, None, None)


class LocalExchange:
    """Every rank of one axis in this process, rank i's tensors on
    ``devices[i]``.  ``group`` is a ``collective.LocalGroup`` (its devices
    are taken) or a list of devices.  Exchanges are device copies, which
    autograd differentiates as it is."""

    def __init__(self, group, axis_name: str = "seq"):
        devices = getattr(group, "devices", group)
        self.devices = [torch.device(d) for d in devices]
        self.axis_name = axis_name

    def _check(self, axis: str) -> None:
        if axis != self.axis_name:
            raise ValueError(f"this exchange runs axis {self.axis_name!r}, "
                             f"not {axis!r}")

    def size(self, axis: str) -> int:
        self._check(axis)
        return len(self.devices)

    def index(self, axis: str) -> List[int]:
        self._check(axis)
        return list(range(len(self.devices)))

    def _to(self, x, rank: int):
        return x.to(self.devices[rank], copy=True)

    def ppermute(self, xs, axis: str, perm: Perm):
        self._check(axis)
        out = [None] * len(xs)
        for src, dst in perm:
            out[dst] = self._to(xs[src], dst)
        # Positions no one sends to receive zeros, as in jax.lax.ppermute.
        return [o if o is not None else torch.zeros_like(x)
                for o, x in zip(out, xs)]

    def all_to_all(self, xs, axis: str, split_dim: int, concat_dim: int):
        self._check(axis)
        n = len(xs)
        parts = [x.chunk(n, dim=split_dim) for x in xs]
        return [torch.cat([self._to(parts[i][j], j) for i in range(n)],
                          dim=concat_dim) for j in range(n)]
