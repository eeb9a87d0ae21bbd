"""Actor-bound collective groups (the ``ray.experimental.collective``
analog).

Reference: ray ``python/ray/experimental/collective/collective.py:66,88``
— ``create_collective_group(actors, backend)`` declares a communicator
over a set of actor handles; a named ``RemoteCommunicatorManager`` actor
tracks the declarations so any process can look up which group an actor
belongs to (the routing table device-object transfers consult).

Group init runs *inside* each actor via the generic ``execute_on_actor``
hook (no methods required on user classes); the transport is the local
(every rank in one process), gloo or NCCL backend of
``ray_tpu_torch.collective``.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.api_frontend import execute_on_actor


@ray_tpu_torch.remote
class RemoteCommunicatorManager:
    """Cluster-wide registry of actor-bound collective groups."""

    def __init__(self):
        # group_name -> {"actor_ids": [hex...], "backend": str, "world": n}
        self._groups: Dict[str, dict] = {}

    def register(self, group_name: str, actor_ids: List[str],
                 backend: str) -> bool:
        self._groups[group_name] = {
            "actor_ids": list(actor_ids),
            "backend": backend,
            "world": len(actor_ids),
        }
        return True

    def unregister(self, group_name: str) -> bool:
        return self._groups.pop(group_name, None) is not None

    def get(self, group_name: str) -> Optional[dict]:
        return self._groups.get(group_name)

    def group_of_actor(self, actor_id: str) -> Optional[str]:
        for name, info in self._groups.items():
            if actor_id in info["actor_ids"]:
                return name
        return None

    def list_groups(self) -> Dict[str, dict]:
        return dict(self._groups)


_MANAGER_NAME = "_rtpu_communicator_manager"


def _manager():
    try:
        return ray_tpu_torch.get_actor(_MANAGER_NAME)
    except Exception:
        return RemoteCommunicatorManager.options(
            name=_MANAGER_NAME, get_if_exists=True
        ).remote()


def create_collective_group(
    actors: List,
    backend: str = "local",
    group_name: Optional[str] = None,
    device=None,
) -> str:
    """Declare + eagerly initialize a collective group over actor handles.

    Each actor becomes rank i (the order of ``actors``); the group is
    registered with the communicator manager and initialized inside every
    actor process.  ``device`` places a ``"local"`` group's ranks (the
    card unless the caller names another device).  Returns the group
    name."""
    name = group_name or f"actor_group_{uuid.uuid4().hex[:8]}"
    world = len(actors)

    def init_in_actor(_instance, group_name, world_size, rank, backend,
                      device):
        from ray_tpu_torch import collective

        if collective.is_group_initialized(group_name):
            return True
        if backend == "local":
            # The group's logical world is the ACTOR count: size the local
            # group to match so group ops take one tensor per member.
            from ray_tpu_torch.device import resolve_device

            collective.init_local_group(
                group_name, devices=[resolve_device(device)] * world_size
            )
        else:
            collective.init_collective_group(
                world_size, rank, backend=backend, group_name=group_name
            )
        return True

    refs = [
        execute_on_actor(a, init_in_actor, name, world, rank, backend,
                         device)
        for rank, a in enumerate(actors)
    ]
    ray_tpu_torch.get(refs, timeout=120)
    mgr = _manager()
    ray_tpu_torch.get(
        mgr.register.remote(
            name, [a._actor_id.hex() for a in actors], backend
        ),
        timeout=60,
    )
    return name


def destroy_collective_group(group_name: str) -> None:
    mgr = _manager()
    info = ray_tpu_torch.get(mgr.get.remote(group_name), timeout=60)
    ray_tpu_torch.get(mgr.unregister.remote(group_name), timeout=60)
    _ = info


def get_collective_groups(actor) -> List[str]:
    """Groups the given actor handle belongs to."""
    mgr = _manager()
    name = ray_tpu_torch.get(
        mgr.group_of_actor.remote(actor._actor_id.hex()), timeout=60
    )
    return [name] if name else []
