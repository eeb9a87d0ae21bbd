"""In-graph collectives: allreduce across a set of actors' DAG nodes.

Reference: ray ``python/ray/dag/collective_node.py:23,252`` — binding an
allreduce over per-actor computation nodes so the exchange happens inside
the compiled graph, overlapping with the pipeline.  Here the exchange rides
the same shm channels as every other compiled edge: each participant reads
the other participants' values and reduces locally, on its own card when
its value is on one (tensors inside one process's step should use a
collective group instead — the channel path is for cross-actor
orchestration).
"""

from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np

from .nodes import ClassMethodNode, DAGNode

RESERVED_COLLECTIVE_METHOD = "__rtpu_dag_collective__"

_OPS = ("sum", "mean", "max", "min", "product")


def apply_collective(op: str, tensors: Sequence):
    """Reduce the participants' values in participant order.  Torch tensors
    reduce on the card where one of them is (values that came over a
    channel arrive on the host), so the sums associate as numpy's do;
    anything else takes numpy."""
    torch = sys.modules.get("torch")
    if torch is not None and any(isinstance(t, torch.Tensor)
                                 for t in tensors):
        from ..collective.algorithms import flat_reduce
        from ..collective.types import ReduceOp

        xs = [torch.as_tensor(t) for t in tensors]
        device = next((x.device for x in xs if x.device.type != "cpu"),
                      xs[0].device)
        return flat_reduce([x.to(device) for x in xs], ReduceOp(op))
    arrays = [np.asarray(t) for t in tensors]
    stacked = np.stack(arrays)
    if op == "sum":
        return stacked.sum(axis=0)
    if op == "mean":
        return stacked.mean(axis=0)
    if op == "max":
        return stacked.max(axis=0)
    if op == "min":
        return stacked.min(axis=0)
    if op == "product":
        return stacked.prod(axis=0)
    raise ValueError(f"unknown collective op {op!r} (one of {_OPS})")


class CollectiveOpNode(ClassMethodNode):
    """One participant's view of an in-graph allreduce: consumes every
    participant's upstream value, emits the reduced tensor on this
    participant's actor."""

    def __init__(self, actor_handle, participants: Sequence[DAGNode],
                 op: str, group_name: str = None):
        kwargs = {"_op": op}
        if group_name is not None:
            kwargs["_group"] = group_name
        super().__init__(
            actor_handle,
            RESERVED_COLLECTIVE_METHOD,
            tuple(participants),
            kwargs,
        )

    def _execute_impl(self, cache, input_args, input_kwargs):
        # Classic (uncompiled) path: gather the participant refs and reduce
        # driver-side (the compiled path reduces inside each actor's loop).
        # Sibling outputs of the same allreduce share ONE reduction via the
        # per-execute cache — N outputs must not mean N gathers.
        import ray_tpu_torch

        group_key = (
            "__rtpu_allreduce__",
            tuple(id(a) for a in self._bound_args),
            self._bound_kwargs["_op"],
        )
        if group_key in cache:
            return cache[group_key]
        refs = [
            self._resolve_arg(a, cache, input_args, input_kwargs)
            for a in self._bound_args
        ]
        values = [
            ray_tpu_torch.get(r, timeout=300)
            if isinstance(r, ray_tpu_torch.ObjectRef)
            else r
            for r in refs
        ]
        result = ray_tpu_torch.put(
            apply_collective(self._bound_kwargs["_op"], values)
        )
        cache[group_key] = result
        return result


def allreduce_bind(
    nodes: Sequence[ClassMethodNode], op: str = "sum",
    group_name: str = None,
) -> List[CollectiveOpNode]:
    """Bind an allreduce across per-actor nodes; returns one output node per
    participant (reference: ``ray.experimental.collective.allreduce.bind``).

        with InputNode() as inp:
            partials = [w.compute.bind(inp) for w in workers]
            reduced = allreduce_bind(partials)
            dag = MultiOutputNode(reduced)
    """
    if op not in _OPS:
        raise ValueError(f"unknown collective op {op!r} (one of {_OPS})")
    if len(nodes) < 2:
        raise ValueError("allreduce requires at least 2 participants")
    actor_ids = {n._actor._actor_id for n in nodes}
    if len(actor_ids) != len(nodes):
        raise ValueError("each participant must live on a distinct actor")
    # group_name: participants reduce through the named collective group's
    # device op (psum over the group mesh — ICI on a TPU slice with the
    # xla backend) instead of the host numpy reduction.
    return [CollectiveOpNode(n._actor, nodes, op, group_name) for n in nodes]
