"""Pipeline parallelism over the ``stage`` mesh axis (GPipe schedule) —
port of ``ray_tpu/parallel/pipeline.py``.

One SPMD program: stage parameters are sharded over the ``stage`` axis,
microbatch activations flow stage-to-stage by ``ppermute``, and the
finished microbatches of the last stage are replicated by a ``psum``.
Usage: a stack of structurally identical stage functions (e.g.
transformer layer groups); parameters carry a leading stage dimension.
The body runs over a ``DeviceMesh`` (``parallel.exchange``).  (The
port's actor-per-stage 1F1B trainer is ``train.pipeline``.)
"""

from __future__ import annotations

from typing import Callable

import torch

from .exchange import MeshExchange, ring_perm


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_local(stage_fn: Callable, stage_params, microbatches, *,
                   comm, axis_name: str = "stage"):
    """shard_map-inner GPipe loop over ``comm``'s ``axis_name``.

    stage_fn: (params_for_one_stage, x) -> y with x.shape == y.shape
    stage_params: this rank's stage params, a tensor or a dict of them,
        each with a leading stage dim of 1 (squeezed here)
    microbatches: [M, mb, ...] — full input, replicated across stages.
    Returns [M, mb, ...] outputs of the final stage (replicated).
    """
    n = comm.size(axis_name)
    my_stage = comm.index(axis_name)[0]
    params = _tree_map(lambda p: p[0], stage_params)
    m = microbatches.shape[0]
    ticks = m + n - 1
    carry = torch.zeros_like(microbatches[0])  # inter-stage activations
    outs = [None] * m
    for t in range(ticks):
        mb_idx = t - my_stage  # which microbatch this stage works on
        active = 0 <= mb_idx < m
        # Stage 0 reads fresh input; others read what the ring delivered.
        x_in = microbatches[min(max(mb_idx, 0), m - 1)] if my_stage == 0 \
            else carry
        y = stage_fn(params, x_in) if active else torch.zeros_like(carry)
        if active and my_stage == n - 1:  # the last stage keeps its output
            outs[mb_idx] = y
        # Ship activations to the next stage.
        carry = comm.ppermute([y], axis_name, ring_perm(n))[0]
    # Only the last stage holds real outputs; replicate via psum (every
    # other stage contributes zeros).
    zeros = torch.zeros_like(microbatches[0])
    outs = torch.stack([o if o is not None else zeros for o in outs])
    return comm.psum([outs], axis_name)[0]


def pipelined(stage_fn: Callable, mesh, *, axis_name: str = "stage",
              batch_axes=("data", "fsdp")):
    """Build a pipelined apply over a ``DeviceMesh``:
        fn(stacked_params, microbatches) -> outputs
    stacked_params: leading dim = num stages (sharded over ``axis_name``),
    a tensor or a dict of tensors; microbatches: [M, mb, ...] with the mb
    batch dim sharded over ``batch_axes`` (None: replicated).  Plain
    tensors are taken as the global values and the result comes back as
    a plain tensor; DTensors give a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    from .sharding import placements_for

    def local(x, spec):
        want = placements_for(mesh, spec)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()

    def apply(stacked_params, microbatches):
        x_spec = (None, batch_axes)
        params = _tree_map(lambda p: local(p, (axis_name,)), stacked_params)
        out = pipeline_local(stage_fn, params,
                             local(microbatches, x_spec),
                             comm=MeshExchange(mesh), axis_name=axis_name)
        out = DTensor.from_local(out, mesh, placements_for(mesh, x_spec),
                                 run_check=False)
        return out if isinstance(microbatches, DTensor) else out.full_tensor()

    return apply
