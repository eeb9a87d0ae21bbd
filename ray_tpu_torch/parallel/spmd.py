"""How the port's models run under a mesh: shard_map style, per rank.

The JAX models run under ``jit`` on sharded arrays and GSPMD partitions
every op.  PyTorch's counterpart, DTensor sharding propagation, searches
a strategy per op per mesh dim; over the six-axis mesh that search does
not finish for a 5-D einsum.  So under a mesh each rank computes the
layers on its local blocks, with the activation layouts that the JAX
models' ``with_logical_constraint`` calls name, and only the exchanges
GSPMD would insert:

  - parameters stay DTensors (``parallel.shard_pytree``); ``param`` takes
    a leaf's local shard to its compute layout with
    ``DTensor.redistribute`` (the fsdp
    axes all-gathered, ZeRO-3 style, the model axis kept where the layer
    splits heads or mlp) and hands back the local block, its gradient
    declared Partial over the axes that split the batch and sequence, so
    the redistribute's backward reduce-scatters and all-reduces it into
    the parameter's own layout;
  - ``enter_tp``/``exit_tp`` are the two halves of a tensor-parallel
    matmul over the model axis (identity forward with the gradient summed,
    then a psum whose gradient passes through);
  - ``total`` sums a per-rank partial loss over the batch and sequence
    axes; ``batch_sum`` sums per-rank partial statistics over the batch
    axes (a batch norm's, differentiable both ways) and ``batch_split``
    is how many ranks split the batch;
  - ``dist``/``local`` cross between local blocks and DTensors where an
    attention wrapper or a caller takes global tensors.

With no mesh, ``spmd(None)`` is an object whose every method is the
identity, so the unsharded path runs exactly the ops it ran before.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .exchange import MeshExchange
from .sharding import LogicalRules, logical_sharding, with_logical_constraint

# Logical names of the axes a layer splits over the model (TP) axis.
TP_NAMES = ("heads", "mlp")
# Parameter axes kept sharded in the compute layout: the TP names, and the
# expert axis (each rank runs its own experts).
KEPT_NAMES = TP_NAMES + ("expert",)


def _axes_of(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _Unsharded:
    """Every method the identity: the model's path with no mesh."""

    mesh = None
    seq_size = 1

    def tokens(self, t):
        return t

    def seq_start(self, s_local: int) -> int:
        return 0

    def param(self, p, axes):
        return p

    def layers(self, blocks, axes):
        return lambda l: {k: v[l] for k, v in blocks.items()}

    def enter_tp(self, x):
        return x

    def exit_tp(self, x):
        return x

    def total(self, x):
        return x

    batch_split = 1

    def batch_sum(self, x):
        return x

    def dist(self, x, axes):
        return x

    def local(self, x, axes):
        return x


class Spmd:
    """One rank's view of a model run over ``mesh`` with ``rules``."""

    def __init__(self, mesh, rules: Optional[LogicalRules] = None):
        from .multislice import default_rules_for_mesh

        self.mesh = mesh
        self.rules = rules if rules is not None else default_rules_for_mesh(
            mesh)
        self.ex = MeshExchange(mesh)
        names = mesh.mesh_dim_names
        self.seq_axis = self.rules.get("seq")
        self.seq_size = self._size(self.seq_axis)
        self.batch_axes = tuple(a for a in _axes_of(self.rules.get("batch"))
                                if a in names)
        self.batch_split = int(np.prod([self._size(a)
                                        for a in self.batch_axes]))
        self.split_axes = self.batch_axes + tuple(
            a for a in _axes_of(self.seq_axis) if a in names)
        tp = {self.rules.get(n) for n in TP_NAMES}
        if len(tp) != 1:
            raise ValueError(f"heads and mlp map to different axes: {tp}")
        self.tp_axis = tp.pop()

    def _size(self, axis) -> int:
        if axis is None:
            return 1
        return self.ex.size(axis)

    def tokens(self, t):
        """This rank's [B_local, S_local] block of global token ids."""
        return self.local(t, ("batch", "seq"))

    def seq_start(self, s_local: int) -> int:
        """Position of this rank's first token in the sequence."""
        if self.seq_size == 1:
            return 0
        return self.ex.index(self.seq_axis)[0] * s_local

    def param(self, p, axes):
        """The local block of DTensor ``p`` in the compute layout
        ``axes``, differentiable into ``p``'s own layout.  Call it once
        per leaf and step: each call is a gather."""
        return self._gather(_LocalOf.apply(p), p.placements, p.shape,
                            axes)

    def layers(self, blocks, axes):
        """``layer(l)`` → layer ``l``'s parameters in their compute
        layouts (``compute_axes`` of ``axes``, which lead with the layer
        dim).  Each layer-stacked DTensor is taken to its local shard once;
        a layer is a local slice of it, gathered on its own (ZeRO-3's
        per-layer all-gather)."""
        from torch.distributed.tensor import Shard

        stacks = {k: _LocalOf.apply(v) for k, v in blocks.items()}

        def gather(name, l):
            whole = blocks[name]
            placements = tuple(Shard(p.dim - 1) if isinstance(p, Shard)
                               else p for p in whole.placements)
            return self._gather(stacks[name][l], placements, whole.shape[1:],
                                compute_axes(axes[name][1:]))

        return lambda l: {k: gather(k, l) for k in blocks}

    def _gather(self, local, placements, shape, axes):
        """``local`` (a block laid out by ``placements``) redistributed to
        logical ``axes``, as a local block whose gradient is declared
        Partial over the batch and sequence axes."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        want = logical_sharding(self.mesh, axes, self.rules)
        grad = tuple(
            pl if isinstance(pl, Shard) else
            Partial() if name in self.split_axes else Replicate()
            for pl, name in zip(want, self.mesh.mesh_dim_names))
        piece = DTensor.from_local(local, self.mesh, placements,
                                   run_check=False, shape=shape,
                                   stride=_contiguous_strides(shape))
        return piece.redistribute(self.mesh, want).to_local(
            grad_placements=grad)

    def enter_tp(self, x):
        if self._size(self.tp_axis) == 1:
            return x
        return self.ex.copy_to([x], self.tp_axis)[0]

    def exit_tp(self, x):
        if self._size(self.tp_axis) == 1:
            return x
        return self.ex.psum([x], self.tp_axis)[0]

    def total(self, x):
        for axis in self.split_axes:
            if self._size(axis) > 1:
                x = self.ex.psum([x], axis)[0]
        return x

    def batch_sum(self, x):
        for axis in self.batch_axes:
            if self._size(axis) > 1:
                x = self.ex.allreduce([x], axis)[0]
        return x

    def dist(self, x, axes):
        """A DTensor of local block ``x`` laid out as logical ``axes``."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            x, self.mesh, logical_sharding(self.mesh, axes, self.rules),
            run_check=False)

    def local(self, x, axes):
        """The local block of ``x`` (a DTensor, or a plain tensor taken as
        the global value) resharded to logical ``axes``."""
        return with_logical_constraint(x, axes, self.mesh,
                                       self.rules).to_local()


class _LocalOf(torch.autograd.Function):
    """A DTensor leaf's local shard, whose gradient goes back as a DTensor
    with exactly the leaf's placements, shape and strides.  ``to_local``
    derives the gradient's global strides from the local block, which for
    a tensor sharded on two dims are not row-major; AccumulateGrad then
    copies the gradient with a DTensor op whose sharding search over the
    six-axis mesh takes seconds a step."""

    @staticmethod
    def forward(ctx, p):
        ctx.spec = (p.device_mesh, p.placements, p.shape, p.stride())
        local = p.to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, placements, shape, stride = ctx.spec
        g = g.contiguous().view(-1).view(g.shape)  # row-major, size-1 dims too
        return DTensor.from_local(g, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


_UNSHARDED = _Unsharded()


def spmd(mesh, rules: Optional[LogicalRules] = None):
    """The model's view of ``mesh``: identity with no mesh."""
    return _UNSHARDED if mesh is None else Spmd(mesh, rules)


def compute_axes(axes):
    """A parameter's compute layout: the model- and expert-parallel names
    kept, every other (the ZeRO-3 "embed") gathered."""
    return tuple(a if a in KEPT_NAMES else None for a in axes)


class LocalShardOptimizer:
    """An elementwise optimizer (AdamW, as optax's is) stepped on each
    parameter's local shard: the update of a sharded parameter is the
    update of its shards, so no DTensor op runs in ``step``.  Plain
    tensors among ``params`` are stepped as they are."""

    def __init__(self, params, opt_cls=torch.optim.AdamW, **kw):
        self.params = list(params)
        with torch.no_grad():  # the DTensor's own local tensor, a leaf
            self.local = [_local(p) for p in self.params]
        self.opt = opt_cls(self.local, **kw)

    def step(self) -> None:
        for p, loc in zip(self.params, self.local):
            loc.grad = None if p.grad is None else _local(p.grad)
        self.opt.step()

    def zero_grad(self) -> None:
        for p, loc in zip(self.params, self.local):
            p.grad = loc.grad = None


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x
