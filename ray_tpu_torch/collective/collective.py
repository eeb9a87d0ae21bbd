"""Declarative collective API — the ``ray.util.collective`` equivalent.

Reference surface (ray ``python/ray/util/collective/collective.py``):
``init_collective_group`` (:171), ``create_collective_group`` (:211),
``allreduce/reduce/broadcast/allgather/reducescatter/barrier`` (:328-725),
with a per-process ``GroupManager`` (:71).  Backends (``types.Backend``):
``nccl`` and ``gloo`` groups are one process per rank over
``torch.distributed`` (``dist_group.DistGroup``); ``local`` groups hold
every rank in this process (``local_group.LocalGroup``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .types import Backend, GroupInfo, ReduceOp

logger = logging.getLogger(__name__)


class GroupManager:
    """Per-process registry of named collective groups."""

    def __init__(self):
        self._groups: Dict[str, object] = {}

    def create(self, backend: Backend, group_name: str, world_size: int, rank: int,
               **kwargs):
        if group_name in self._groups:
            raise ValueError(f"collective group {group_name!r} already exists")
        if backend == Backend.LOCAL:
            from .local_group import LocalGroup

            group = LocalGroup(group_name, kwargs.get("devices"),
                               slice_size=kwargs.get("slice_size"))
        else:
            from .dist_group import DistGroup

            group = DistGroup(group_name, world_size, rank, backend,
                              **kwargs)
        # The caller-declared rank identifies THIS member for p2p edges
        # even when the group object itself is rank-less (LOCAL backend is
        # single-controller, so its own rank is always 0).
        group.declared_rank = rank
        self._groups[group_name] = group
        return group

    def get(self, group_name: str):
        group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized; call "
                f"init_collective_group first"
            )
        return group

    def destroy(self, group_name: str):
        group = self._groups.pop(group_name, None)
        if group is not None and hasattr(group, "shutdown"):
            group.shutdown()

    def names(self) -> List[str]:
        return list(self._groups)


_manager = GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "nccl",
    group_name: str = "default",
    **kwargs,
):
    """Initialize a named collective group in this process (each member
    process/actor calls this with its own rank)."""
    b = Backend.normalize(backend)
    return _manager.create(b, group_name, world_size, rank, **kwargs)


def init_local_group(group_name: str = "default", devices=None,
                     slice_size: int = None):
    """Single-controller group over this process's local devices (all ranks
    live here; ops take per-rank tensor lists).  ``slice_size`` declares
    devices-per-ICI-slice for algorithm selection: a multi-slice group
    unlocks the two-level (ICI reduce-scatter / DCN exchange / ICI
    all-gather) decomposition — see docs/collective.md."""
    return _manager.create(Backend.LOCAL, group_name, 0, 0, devices=devices,
                           slice_size=slice_size)


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _manager.get(group_name)
        return True
    except ValueError:
        return False


def destroy_collective_group(group_name: str = "default"):
    _destroy_p2p_edges(group_name)
    _manager.destroy(group_name)


def get_group(group_name: str = "default"):
    return _manager.get(group_name)


def get_rank(group_name: str = "default") -> int:
    g = _manager.get(group_name)
    return getattr(g, "rank", 0)


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


# ---------------------------------------------------------------------- ops
def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM,
              quantized: bool = None):
    """SUM allreduce routes through the topology-aware algorithm
    selection layer (docs/collective.md).  ``quantized=True`` opts this
    call into the EQuARX-style block-quantized exchange (float payloads,
    SUM only; bounded per-block error); ``None`` defers to the
    ``collective_quantized_allreduce`` process default (off)."""
    return _manager.get(group_name).allreduce(tensor, op, quantized=quantized)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def alltoall(tensor, group_name: str = "default"):
    return _manager.get(group_name).alltoall(tensor)


def barrier(group_name: str = "default"):
    return _manager.get(group_name).barrier()


def collective_stats(cluster: bool = False) -> Dict[str, dict]:
    """Collective telemetry from the flight recorder.

    Local view (default): per-op aggregates (ops, bytes, mean warm
    duration) keyed by op name, plus a ``"tuner"`` entry with the
    algorithm-selection table — per (op, size bucket, world size,
    topology): the chosen algorithm, call/exploration counts, and
    per-algorithm attempts/samples/mean achieved bandwidth.

    ``cluster=True``: the per-group merge over all workers via the
    owner-service metrics registry (each worker flushes its registry to
    the control-plane KV; the driver reads them all back) — see
    ``flight_recorder.cluster_collective_stats()``.  Requires a running
    cluster; the tuner decision counters appear under ``"algorithms"``."""
    from ..util import flight_recorder

    if cluster:
        return flight_recorder.cluster_collective_stats()
    from .tuner import get_tuner

    stats: Dict[str, dict] = dict(flight_recorder.local_collective_stats())
    stats["tuner"] = get_tuner().stats()
    # Bytes gloo groups staged through the host, by group and op.
    stats["staged"] = {
        name: dict(g.staged_bytes) for name, g in _manager._groups.items()
        if getattr(g, "staged_bytes", None)
    }
    return stats


def send(tensor, dst_rank: int, group_name: str = "default"):
    """Point-to-point send (reference: ``ray.util.collective.send``,
    NCCL p2p).  The tensor rides the object plane — through a named
    per-edge queue actor, so it works across any pair of group members
    without a matching collective on the others; a torch tensor travels as
    itself (a CUDA tensor lands on the receiver's card).  For the group's
    own exchange, use ``ppermute``/``sendrecv_ring``."""
    import numpy as np
    import torch

    group = _manager.get(group_name)
    src = getattr(group, "declared_rank", get_rank(group_name))
    queue = _p2p_queue(group_name, src, dst_rank)
    queue.put(tensor if isinstance(tensor, torch.Tensor)
              else np.asarray(tensor))


def recv(src_rank: int, group_name: str = "default", timeout: float = 60.0):
    """Blocking receive of the next tensor sent by ``src_rank``."""
    group = _manager.get(group_name)
    dst = getattr(group, "declared_rank", get_rank(group_name))
    queue = _p2p_queue(group_name, src_rank, dst)
    return queue.get(timeout=timeout)


# (group, src, dst) -> Queue; handles are cached so the hot p2p path pays
# the named-actor rendezvous once per edge, not per message.
_p2p_cache: Dict[tuple, object] = {}


def _p2p_queue(group_name: str, src: int, dst: int):
    """Named queue actor for the (group, src→dst) edge, created on first
    use by either end (get_if_exists rendezvous)."""
    from ..util.queue import Queue

    key = (group_name, src, dst)
    queue = _p2p_cache.get(key)
    if queue is None:
        queue = Queue(
            maxsize=64,
            name=f"_rtpu_p2p:{group_name}:{src}->{dst}",
            get_if_exists=True,
        )
        _p2p_cache[key] = queue
    return queue


def _destroy_p2p_edges(group_name: str):
    """Kill ALL p2p queue actors for a group (cluster-wide, by name) — a
    later group reusing the name must not receive stale tensors, including
    on edges only a peer process ever touched.  Peers still holding handles
    see a dead-actor error on their next send/recv (loud, not stale)."""
    import ray_tpu_torch

    # Cached handles die unconditionally (no state-API dependency)...
    for key in [k for k in _p2p_cache if k[0] == group_name]:
        queue = _p2p_cache.pop(key)
        try:
            ray_tpu_torch.kill(queue.actor)
        except Exception:  # raylint: waive[RTL003] teardown kill is best-effort; actor may be gone
            pass
    # ...and a best-effort cluster-wide sweep catches edges only peer
    # processes ever touched.  Edge names end with "src->dst" and contain
    # no further ':' after the group name, so "train" never matches
    # "train:eval" edges.
    import re

    edge_re = re.compile(
        re.escape(f"_rtpu_p2p:{group_name}:") + r"\d+->\d+$"
    )
    try:
        from ..util.state import list_actors

        for row in list_actors():
            name = row.get("name")
            if name and edge_re.fullmatch(name) and row["state"] != "DEAD":
                try:
                    ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
                except Exception:  # raylint: waive[RTL003] teardown kill is best-effort; actor may be gone
                    pass
    except Exception:  # raylint: waive[RTL003] best effort without a driver
        pass
