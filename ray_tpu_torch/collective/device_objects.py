"""Device-resident object store — the GPU-objects ("RDT") analog.

Port of ``ray_tpu/collective/device_objects.py``.  Tensors stay on the card
in the owning process, keyed by object id; a consumer in the same process
gets the tensor itself, with no copy; a consumer in another process fetches
it point to point over the owner's worker RPC (``device_fetch``: one host
hop, landing on the consumer's card when the owner kept it on one).  The
handle (``DeviceRef``) carries only metadata and pickles.  Residency is an
owner-side reference count: ``put`` makes one reference, ``retain`` adds
one, ``free`` drops one, and the tensor leaves the store at zero; a
borrower's ``retain``/``refcount``/``free`` go to the owner by RPC.

Integration point: actors made with ``tensor_transport="device"`` return
``DeviceRef``s for the tensors in their results and resolve ``DeviceRef``s
in their arguments (``core/core_worker.py``).

Members of a collective group that holds the ref's group name receive the
tensor by a broadcast from its owner rank instead (``fetch`` on every
member, ``serve_fetch`` on the owner).  A ref that is not resident here,
has no group here and whose owner cannot be asked (made outside a runtime
process, or the owner no longer holds it) raises
``RemoteDeviceObjectError``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional, Tuple

from ..core.ids import ObjectID

if TYPE_CHECKING:
    import torch


@dataclass
class DeviceRef:
    """Metadata handle to a device-resident tensor (picklable; the tensor
    itself never leaves device memory unless explicitly fetched)."""

    object_id: ObjectID
    shape: Tuple[int, ...]
    dtype: str
    owner_rank: int = 0
    group_name: str = "default"
    # RPC address of the owning worker process (set automatically when the
    # owner runs inside a core worker) — enables point-to-point fetch
    # without a collective group.
    owner_address: str = ""


class RemoteDeviceObjectError(KeyError):
    """A ref this process does not hold, whose owner cannot serve it: it
    has no owner address (made outside a runtime process) or its owner no
    longer holds it (freed, or the actor restarted)."""


class DeviceObjectStore:
    """Per-process store of device-resident tensors, reference-counted by
    the owner (the JAX store's semantics)."""

    def __init__(self):
        self._objects: Dict[ObjectID, "torch.Tensor"] = {}
        self._refcounts: Dict[ObjectID, int] = {}
        self._lock = threading.Lock()
        # Instrumentation: how the most recent resolution went — "local" |
        # "collective" | "p2p_rpc" (tests assert the transfer path).
        self.last_transfer_path: Optional[str] = None

    def put(self, tensor: "torch.Tensor", group_name: str = "default",
            rank: int = 0) -> DeviceRef:
        oid = ObjectID.from_random()
        with self._lock:
            self._objects[oid] = tensor
            self._refcounts[oid] = 1
        owner_address = ""
        from ..core.core_worker import try_global_worker

        worker = try_global_worker()
        if worker is not None:
            owner_address = worker.address
        return DeviceRef(
            oid, tuple(tensor.shape), str(tensor.dtype), rank, group_name,
            owner_address,
        )

    def retain(self, ref: DeviceRef) -> int:
        """Add one owner-side reference (local fast path, RPC otherwise)."""
        with self._lock:
            if ref.object_id in self._objects:
                self._refcounts[ref.object_id] += 1
                return self._refcounts[ref.object_id]
        return self._owner_call(ref, "device_retain")

    def refcount(self, ref: DeviceRef) -> int:
        with self._lock:
            if ref.object_id in self._refcounts:
                return self._refcounts[ref.object_id]
        return self._owner_call(ref, "device_refcount")

    def _owner_call(self, ref: DeviceRef, method: str):
        from ..core.core_worker import global_worker

        if not ref.owner_address:
            raise _no_owner(ref)
        worker = global_worker()
        client = worker.worker_clients.get(ref.owner_address)
        return worker._run_sync(
            client.call(method, {"object_id": ref.object_id})
        )

    def get_local(self, ref: DeviceRef) -> "torch.Tensor":
        with self._lock:
            tensor = self._objects.get(ref.object_id)
        if tensor is None:
            raise KeyError(f"device object {ref.object_id} not resident here")
        return tensor

    def contains(self, ref: DeviceRef) -> bool:
        with self._lock:
            return ref.object_id in self._objects

    def fetch(self, ref: DeviceRef) -> "torch.Tensor":
        """Resolve a DeviceRef.  Resolution order:

        1. local hit → the resident tensor, zero movement;
        2. owner_address set → point-to-point RPC to the owning worker
           (one host hop; works anywhere in the cluster);
        3. fall back to a collective broadcast from the owner rank — all
           group members must call fetch() collectively (the reference's
           NCCL-transport shape; pair with ``serve_fetch`` on the owner).
        """
        if self.contains(ref):
            self.last_transfer_path = "local"
            return self.get_local(ref)
        from .collective import is_group_initialized

        if is_group_initialized(ref.group_name):
            # Collective path: the transfer is a broadcast over the group
            # (NCCL between cards), no RPC.  All group members call
            # fetch() collectively; the owner pairs it with serve_fetch().
            from .collective import get_group

            group = get_group(ref.group_name)
            import torch

            device = getattr(group, "device", None) or group.devices[0]
            placeholder = torch.zeros(
                ref.shape, dtype=getattr(torch, ref.dtype.split(".")[-1]),
                device=device,
            )
            out = group.broadcast(placeholder, src_rank=ref.owner_rank)
            self.last_transfer_path = "collective"
            return out
        out = self._fetch_rpc(ref)
        self.last_transfer_path = "p2p_rpc"
        return out

    def _fetch_rpc(self, ref: DeviceRef) -> "torch.Tensor":
        return array_from_fetch_reply(ref, self._owner_call(ref, "device_fetch"))

    def free(self, ref: DeviceRef) -> bool:
        """Drop one reference; the tensor leaves the card at refcount zero.
        Remote-owned refs release at the owner via RPC."""
        with self._lock:
            if ref.object_id in self._objects:
                self._refcounts[ref.object_id] -= 1
                if self._refcounts[ref.object_id] <= 0:
                    del self._objects[ref.object_id]
                    del self._refcounts[ref.object_id]
                    return True
                return False
        if ref.owner_address:
            from ..core.core_worker import try_global_worker

            worker = try_global_worker()
            if worker is not None:
                try:
                    client = worker.worker_clients.get(ref.owner_address)
                    return worker._run_sync(
                        client.call(
                            "device_free", {"object_id": ref.object_id}
                        )
                    )
                except Exception:  # noqa: BLE001 — owner gone = freed
                    return False
        return False

    def serve_fetch(self, ref: DeviceRef):
        """Owner side of a collective fetch."""
        from .collective import get_group

        group = get_group(ref.group_name)
        return group.broadcast(self.get_local(ref), src_rank=ref.owner_rank)

    def __len__(self):
        return len(self._objects)


def _no_owner(ref: DeviceRef) -> RemoteDeviceObjectError:
    return RemoteDeviceObjectError(
        f"device object {ref.object_id} is not resident in this process and "
        "has no owner address to fetch it from (made outside a runtime "
        "process) and no collective group here to receive it by"
    )


def array_from_fetch_reply(ref: DeviceRef, reply: dict) -> "torch.Tensor":
    """Decode a ``device_fetch`` RPC reply into a tensor on this process's
    device of the owner's kind: its card when the owner kept the tensor on
    one, else the host."""
    from ..core.serialization import tensor_from_bytes

    if not reply.get("found"):
        raise RemoteDeviceObjectError(
            f"device object {ref.object_id} no longer resident at "
            f"{ref.owner_address} (freed, or the actor restarted)"
        )
    return tensor_from_bytes(reply["data"], ref.dtype, ref.shape,
                             device=reply["device"])


_store: Optional[DeviceObjectStore] = None
_store_lock = threading.Lock()


def device_object_store() -> DeviceObjectStore:
    """The process's store, made on first use."""
    global _store
    with _store_lock:
        if _store is None:
            _store = DeviceObjectStore()
        return _store
