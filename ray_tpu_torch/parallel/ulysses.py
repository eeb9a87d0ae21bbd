"""Ulysses-style sequence parallelism: all-to-all head↔sequence resharding
— port of ``ray_tpu/parallel/ulysses.py``.

Inputs arrive sequence-sharded [B, S/n, H, D]; one all-to-all over the
``seq`` axis turns them head-sharded [B, S, H/n, D]; each rank runs
*full-sequence* attention for its head subset (any local attention: the
plain reference by default, or the port's ``flash_attention``, whose
kernels then see S = the whole sequence); a second all-to-all restores
sequence sharding.  Requires H divisible by the seq-axis size.  The body
runs over a ``DeviceMesh`` or single-controller over a ``LocalGroup``
(``parallel.exchange``), as ring attention does.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..ops.attention import reference_attention
from .ring_attention import over_local_group, over_mesh


def ulysses_attention_local(
    q, k, v, *, comm, axis_name: str = "seq", causal: bool = True,
    attn_fn: Optional[Callable] = None,
):
    """shard_map-inner Ulysses attention over ``comm``'s ``axis_name``.
    q/k/v: [B, S_local, H, D] with H divisible by the axis size, or a
    list with one per rank that ``comm`` holds."""
    n = comm.size(axis_name)
    single = torch.is_tensor(q)
    q, k, v = ([q], [k], [v]) if single else (list(q), list(k), list(v))
    h = q[0].shape[2]
    assert h % n == 0, f"heads ({h}) must divide by seq-axis size ({n})"
    attn = attn_fn or functools.partial(reference_attention, causal=causal)

    def seq_to_heads(xs):
        # [B, S/n, H, D] → [B, S, H/n, D]
        return comm.all_to_all(xs, axis_name, split_dim=2, concat_dim=1)

    def heads_to_seq(xs):
        return comm.all_to_all(xs, axis_name, split_dim=1, concat_dim=2)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = heads_to_seq([attn(a, b, c) for a, b, c in zip(qh, kh, vh)])
    return out[0] if single else out


def ulysses_attention(q, k, v, mesh, *, causal: bool = True,
                      seq_axis: str = "seq", batch_axes=("data", "fsdp"),
                      attn_fn: Optional[Callable] = None):
    """Ulysses attention over ``mesh``'s ``seq_axis``: q/k/v [B, S, H, D]
    global tensors (S sharded over ``seq_axis``; heads unsharded on that
    axis).  ``mesh`` is a ``DeviceMesh`` or a ``LocalGroup``."""
    def body(q, k, v, comm):
        return ulysses_attention_local(q, k, v, comm=comm,
                                       axis_name=seq_axis, causal=causal,
                                       attn_fn=attn_fn)

    if hasattr(mesh, "mesh_dim_names"):
        return over_mesh(body, mesh, (batch_axes, seq_axis, None, None),
                         (q, k, v))
    return over_local_group(body, mesh, seq_axis, (q, k, v))
