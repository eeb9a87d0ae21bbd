"""Deployments — the declarative unit of serving.

Reference surface: ray ``python/ray/serve/deployment.py`` +
``serve/api.py`` — ``@serve.deployment`` wraps a class or function with
replica/resource options; ``.bind(*args)`` produces an Application deployed
by ``serve.run``.  TPU-first: ``ray_actor_options={"num_tpus": 1}`` packs
replicas one-per-chip (chip isolation via the lease's TPU_VISIBLE_CHIPS).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class Deployment:
    name: str
    func_or_class: Any
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_ongoing_requests: int = 16
    version: str = "1"
    route_prefix: Optional[str] = None
    # {"min_replicas", "max_replicas", "target_ongoing_requests",
    #  "upscale_delay_s", "downscale_delay_s"} — reference
    # ``serve/autoscaling_policy.py`` defaults.
    autoscaling_config: Optional[Dict[str, Any]] = None

    def options(self, **kwargs) -> "Deployment":
        merged = dataclasses.asdict(self)
        merged.pop("func_or_class", None)
        merged.update(kwargs)
        return Deployment(func_or_class=self.func_or_class, **merged)

    def bind(self, *init_args, **init_kwargs) -> "Application":
        return Application(self, init_args, init_kwargs)


@dataclasses.dataclass
class Application:
    deployment: Deployment
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               max_ongoing_requests: int = 16,
               version: str = "1",
               route_prefix: Optional[str] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None):
    """``@serve.deployment`` decorator."""

    def wrap(obj) -> Deployment:
        return Deployment(
            name=name or getattr(obj, "__name__", "deployment"),
            func_or_class=obj,
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options or {},
            max_ongoing_requests=max_ongoing_requests,
            version=version,
            route_prefix=route_prefix,
            autoscaling_config=autoscaling_config,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
