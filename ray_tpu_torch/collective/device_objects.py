"""Device-resident object store: the local half of
``ray_tpu/collective/device_objects.py``.

Tensors stay on the card in the owning process, keyed by object id; a
consumer in the same process gets the tensor itself, with no copy.  The
handle (``DeviceRef``) carries only metadata and pickles.  Residency is an
owner-side reference count: ``put`` makes one reference, ``retain`` adds
one, ``free`` drops one, and the tensor leaves the store at zero.

What waits for the runtime's port (ROADMAP A3): the remote paths (a fetch,
retain, refcount or free of a ref that another process owns, point to point
over the owner's RPC channel or by a collective broadcast), and the owner's
RPC address, which the JAX store reads from the core worker.  A ref this
process does not hold raises ``RemoteDeviceObjectError``; it never falls
through quietly.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


def new_object_id() -> bytes:
    """A random 20-byte object id (the length of the runtime's ObjectID)."""
    return os.urandom(20)


@dataclass
class DeviceRef:
    """Metadata handle to a device-resident tensor (picklable; the tensor
    itself never leaves device memory unless explicitly fetched)."""

    object_id: bytes
    shape: Tuple[int, ...]
    dtype: str
    owner_rank: int = 0
    group_name: str = "default"
    # RPC address of the owning worker process; empty until the runtime is
    # ported (ROADMAP A3), so every ref is owned by the process that made it.
    owner_address: str = ""


class RemoteDeviceObjectError(KeyError):
    """A ref that this process's store does not hold: fetching it from its
    owner needs the runtime's RPC plane, which the port has not yet."""


def _remote(ref: DeviceRef, what: str) -> RemoteDeviceObjectError:
    return RemoteDeviceObjectError(
        f"device object {ref.object_id.hex()} is not resident in this "
        f"process; {what} from its owner waits for the runtime's port "
        "(ROADMAP A3)"
    )


class DeviceObjectStore:
    """Per-process store of device-resident tensors, reference-counted by
    the owner (the JAX store's semantics)."""

    def __init__(self):
        self._objects: Dict[bytes, torch.Tensor] = {}
        self._refcounts: Dict[bytes, int] = {}
        self._lock = threading.Lock()
        # How the most recent fetch() resolved ("local" is the only path).
        self.last_transfer_path: Optional[str] = None

    def put(self, tensor: torch.Tensor, group_name: str = "default",
            rank: int = 0) -> DeviceRef:
        oid = new_object_id()
        with self._lock:
            self._objects[oid] = tensor
            self._refcounts[oid] = 1
        return DeviceRef(oid, tuple(tensor.shape), str(tensor.dtype), rank,
                         group_name)

    def retain(self, ref: DeviceRef) -> int:
        """Add one owner-side reference."""
        with self._lock:
            if ref.object_id in self._objects:
                self._refcounts[ref.object_id] += 1
                return self._refcounts[ref.object_id]
        raise _remote(ref, "retaining it")

    def refcount(self, ref: DeviceRef) -> int:
        with self._lock:
            if ref.object_id in self._refcounts:
                return self._refcounts[ref.object_id]
        raise _remote(ref, "reading its refcount")

    def get_local(self, ref: DeviceRef) -> torch.Tensor:
        with self._lock:
            tensor = self._objects.get(ref.object_id)
        if tensor is None:
            raise KeyError(
                f"device object {ref.object_id.hex()} not resident here")
        return tensor

    def contains(self, ref: DeviceRef) -> bool:
        with self._lock:
            return ref.object_id in self._objects

    def fetch(self, ref: DeviceRef) -> torch.Tensor:
        """Resolve a ref: a local hit is the resident tensor, zero movement.
        Anything else needs the runtime (ROADMAP A3) and raises."""
        if self.contains(ref):
            self.last_transfer_path = "local"
            return self.get_local(ref)
        raise _remote(ref, "fetching it")

    def free(self, ref: DeviceRef) -> bool:
        """Drop one reference; True when the tensor left the store."""
        with self._lock:
            if ref.object_id in self._objects:
                self._refcounts[ref.object_id] -= 1
                if self._refcounts[ref.object_id] <= 0:
                    del self._objects[ref.object_id]
                    del self._refcounts[ref.object_id]
                    return True
                return False
        raise _remote(ref, "releasing it")

    def __len__(self):
        return len(self._objects)


_store: Optional[DeviceObjectStore] = None
_store_lock = threading.Lock()


def device_object_store() -> DeviceObjectStore:
    """The process's store, made on first use."""
    global _store
    with _store_lock:
        if _store is None:
            _store = DeviceObjectStore()
        return _store
