"""``ray_tpu_torch.collective`` — port of ``ray_tpu.collective``.

This slice ports the local half of the device-object store (the
prefill-to-decode KV handoff rides it); process groups, collectives and the
remote paths of the store follow with the runtime (ROADMAP A3, A4).
"""

from .device_objects import (  # noqa: F401
    DeviceObjectStore,
    DeviceRef,
    RemoteDeviceObjectError,
    device_object_store,
)
