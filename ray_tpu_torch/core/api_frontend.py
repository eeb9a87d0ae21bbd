"""Public API frontends: @remote functions, actor classes, handles.

Equivalent of the reference's ``remote_function.py`` + ``actor.py`` (ray
``python/ray/remote_function.py:41``, ``python/ray/actor.py:1190``): thin
declarative wrappers that translate ``.remote()`` / ``.options()`` calls into
core-worker submissions.  Resource options are TPU-first: ``num_tpus=`` is a
first-class option next to ``num_cpus=``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from .core_worker import global_worker
from .ids import ActorID
from .runtime_env import resolve_runtime_env
from .scheduler import (
    NodeAffinityStrategy,
    NodeLabelStrategy,
    PlacementGroupStrategy,
    SpreadStrategy,
)
from .task_spec import ObjectRef


def _normalize_options(opts: Dict[str, Any]) -> Dict[str, Any]:
    resources = dict(opts.get("resources") or {})
    if "num_cpus" in opts and opts["num_cpus"] is not None:
        resources["CPU"] = float(opts["num_cpus"])
    if "num_tpus" in opts and opts["num_tpus"] is not None:
        resources["TPU"] = float(opts["num_tpus"])
    if "num_gpus" in opts and opts["num_gpus"] is not None:
        resources["GPU"] = float(opts["num_gpus"])
    # Tasks and actors both default to one CPU slot (actors hold it for
    # their lifetime; declare num_cpus=0 for pure-TPU actors).
    resources.setdefault("CPU", 1.0)
    # Any resource kind with a registered accelerator manager validates its
    # requested quantity (reference: per-vendor validate_resource_request_
    # quantity).
    from .accelerators import get_accelerator_manager

    for kind, quantity in resources.items():
        if kind == "CPU" or not quantity:
            continue
        mgr = get_accelerator_manager(kind)
        if mgr is not None:
            ok, reason = mgr.validate_resource_request_quantity(quantity)
            if not ok:
                raise ValueError(reason)
    strategy = opts.get("scheduling_strategy")
    pg_id = None
    bundle_index = -1
    if isinstance(strategy, PlacementGroupStrategy):
        from .ids import PlacementGroupID

        pg_id = PlacementGroupID.from_hex(strategy.pg_id_hex)
        bundle_index = strategy.bundle_index
        strategy = None
    elif strategy == "SPREAD":
        strategy = SpreadStrategy()
    elif strategy == "DEFAULT" or strategy is None:
        strategy = None
    transport = opts.get("tensor_transport", "")
    if transport not in ("", "device"):
        # "nccl" (the reference's value) or typos must not silently no-op.
        raise ValueError(
            f"unknown tensor_transport {transport!r}: the TPU-native "
            f"transport is 'device'"
        )
    if transport and not opts.get("_actor"):
        raise ValueError(
            "tensor_transport is an actor option (device objects live in "
            "the owning actor's HBM)"
        )
    out = {
        "resources": resources,
        "strategy": strategy,
        "placement_group_id": pg_id,
        "bundle_index": bundle_index,
        "env_vars": resolve_runtime_env(opts.get("runtime_env")),
    }
    return out


class RemoteFunction:
    def __init__(self, fn, default_opts: Optional[dict] = None):
        import inspect

        self._fn = fn
        self._opts = default_opts or {}
        # Memoized: the streaming decision is a constant per function and
        # .remote() is the submission hot path.
        self._is_generator = inspect.isgeneratorfunction(
            fn
        ) or inspect.isasyncgenfunction(fn)
        # Export cache keyed by the worker that exported it: a new
        # ray_tpu_torch.init() means a fresh control-plane KV, so the function must
        # be re-exported there.
        self._export_cache = (None, None)  # (worker, function_id)
        # Options are immutable after .options(); normalize (incl. runtime-env
        # packaging, which hashes directory trees) once, not per .remote().
        self._norm_cache: Optional[dict] = None
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(opts)
        rf = RemoteFunction(self._fn, merged)
        rf._export_cache = self._export_cache
        return rf

    def remote(self, *args, **kwargs):
        worker = global_worker()
        cached_worker, function_id = self._export_cache
        if cached_worker is not worker:
            function_id = worker._export_function(self._fn)
            self._export_cache = (worker, function_id)
        if self._norm_cache is None:
            self._norm_cache = _normalize_options(self._opts)
        norm = self._norm_cache
        num_returns = self._opts.get("num_returns", 1)
        if "num_returns" not in self._opts and self._is_generator:
            # Generator tasks stream their yields (reference: streaming
            # generator returns).  An EXPLICIT num_returns=N keeps the old
            # materialize-N-values behavior.
            num_returns = "streaming"
        refs = worker.submit_task(
            self._fn,
            args,
            kwargs,
            name=self._opts.get("name") or self._fn.__name__,
            num_returns=num_returns,
            resources=norm["resources"],
            strategy=norm["strategy"],
            max_retries=self._opts.get(
                "max_retries", 0
            ),
            placement_group_id=norm["placement_group_id"],
            bundle_index=norm["bundle_index"],
            env_vars=norm["env_vars"],
            function_id=function_id,
            pipeline_depth=self._opts.get("pipeline_depth", 0),
        )
        if num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        if self._opts.get("num_returns", 1) == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazily bind this function into a DAG node (ray DAG .bind analog)."""
        from ..dag.nodes import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called directly; "
            f"use {self._fn.__name__}.remote()"
        )


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name, num_returns)

    def remote(self, *args, **kwargs):
        worker = global_worker()
        refs = worker.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
        )
        if self._num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Lazily bind this method into a DAG node (ray DAG .bind analog)."""
        from ..dag.nodes import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs)


def execute_on_actor(handle: "ActorHandle", fn, *args, **kwargs):
    """Run an arbitrary callable inside an actor's process with the actor
    instance as first argument (ray's ``actor.__ray_call__`` analog) —
    the hook out-of-band protocols (collective group init, device-object
    transfers) use to reach inside user actors."""
    from .serialization import dumps_function

    return ActorMethod(handle, "__rtpu_exec__").remote(
        dumps_function(fn), *args, **kwargs
    )


class ActorHandle:
    def __init__(self, actor_id: ActorID):
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        method = ActorMethod(self, name)
        # Cache: repeated `handle.m.remote()` calls skip __getattr__ and the
        # per-call ActorMethod allocation.  __reduce__ ignores the cache.
        self.__dict__[name] = method
        return method

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id,))


class ActorClass:
    def __init__(self, cls, default_opts: Optional[dict] = None):
        self._cls = cls
        self._opts = default_opts or {}
        self._norm_cache: Optional[dict] = None

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = global_worker()
        opts = dict(self._opts)
        opts["_actor"] = True
        if self._norm_cache is None:
            self._norm_cache = _normalize_options(opts)
        norm = self._norm_cache
        actor_id, _spec = worker.create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name"),
            namespace=opts.get("namespace", ""),
            resources=norm["resources"],
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            strategy=norm["strategy"],
            placement_group_id=norm["placement_group_id"],
            bundle_index=norm["bundle_index"],
            env_vars=norm["env_vars"],
            detached=opts.get("lifetime") == "detached",
            get_if_exists=opts.get("get_if_exists", False),
            tensor_transport=opts.get("tensor_transport", ""),
            priority=opts.get("priority"),
        )
        return ActorHandle(actor_id)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()"
        )


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes, with options:
    ``@remote(num_cpus=2, num_tpus=4, max_retries=3, ...)``."""

    def decorate(obj, opts):
        if isinstance(obj, type):
            return ActorClass(obj, opts)
        return RemoteFunction(obj, opts)

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return decorate(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_tpus=1)")

    def wrapper(obj):
        return decorate(obj, dict(kwargs))

    return wrapper
