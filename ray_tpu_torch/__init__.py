"""``ray_tpu_torch`` — the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` is the reference; every module here mirrors a
module there, by name and layout, so each function can be held against its
JAX counterpart on the same weights and inputs.  This package imports
``torch`` and never ``jax`` or anything of ``ray_tpu``.

The runtime (tasks, actors, objects, placement groups; ``api.py``,
``core/``, ``util/``) is the JAX package's, copied with its names moved to
``ray_tpu_torch`` and ``RAY_TPU_TORCH_``, so a port cluster and a JAX
cluster never attach to each other.  The GPU is a first-class resource
(``core/gpu_detect.py``; ``num_gpus=`` leases isolate through
``CUDA_VISIBLE_DEVICES``), tensors travel as raw out-of-band buffers, and
actors made with ``tensor_transport="device"`` keep CUDA tensors resident
(``collective/device_objects.py``)::

    import ray_tpu_torch

    ray_tpu_torch.init()

    @ray_tpu_torch.remote(num_gpus=1)
    def f(x):
        return x * 2

    ray_tpu_torch.get(f.remote(2))  # -> 4

The port's kernels are CUDA C++ for Hopper (``csrc/*.cu``), built on first
use by ``ops/_build.py``.  On CPU tensors every op runs its plain PyTorch
version instead, which is what the CPU tests exercise.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no device asked for they raise
(``device.resolve_device``).  Importing this package does not import
``torch``: every worker process imports it, CPU-only ones too.
"""

from ._version import __version__  # noqa: F401

# The public names resolve on first use (PEP 562), each from its module:
# the runtime (``api`` and the ``core`` it loads) is ~20k lines that the
# model and kernel layers never use, and ``resolve_device`` loads torch,
# which a worker's cold start (it imports this package) must not pay for.
_LAZY = {
    **dict.fromkeys((
        "ActorClass", "ActorHandle", "ClientContext", "ObjectRef",
        "ObjectRefGenerator", "PlacementGroup", "RemoteFunction",
        "SlicePlacementGroup", "available_resources", "cancel",
        "cluster_resources", "get", "get_actor", "init", "is_initialized",
        "kill", "nodes", "placement_group", "placement_group_strategy",
        "profile", "put", "remote", "remove_placement_group", "shutdown",
        "state_summary", "timeline", "wait",
    ), ".api"),
    **dict.fromkeys((
        "ActorDiedError", "ActorUnavailableError", "GetTimeoutError",
        "ObjectLostError", "RayTpuError", "TaskCancelledError", "TaskError",
        "WorkerCrashedError",
    ), ".core.exceptions"),
    "Cluster": ".core.node",
    **dict.fromkeys(
        ("NodeAffinityStrategy", "NodeLabelStrategy", "SpreadStrategy"),
        ".core.scheduler"),
    "resolve_device": ".device",
}


def __getattr__(name):
    # `ray_tpu_torch.dag` loads lazily (PEP 562): it pulls numpy at import
    # time, which costs ~0.2s of every WORKER cold start on a 1-core
    # host (any `ray_tpu_torch.core.*` import runs this package __init__).
    # `ray_tpu_torch.api` too: the JAX package imports it eagerly, so code
    # reaches it as an attribute (the job supervisor, in a fresh worker).
    if name in ("api", "dag"):
        import importlib

        module = importlib.import_module("." + name, __name__)
        globals()[name] = module
        return module
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | {"api", "dag"})
