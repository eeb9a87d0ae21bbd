"""Model multiplexing: many models LRU-cached across a pool of replicas.

Reference: ray ``python/ray/serve/multiplex.py`` — ``@serve.multiplexed``
wraps an async model loader with a per-replica LRU; the request's model id
rides handle metadata (``handle.options(multiplexed_model_id=...)``) and is
readable inside the replica via ``serve.get_multiplexed_model_id()``.  The
router prefers replicas that already hold the model (session affinity in
``DeploymentHandle``).
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import logging
from collections import OrderedDict
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

_model_id_var: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "rtpu_serve_multiplexed_model_id", default=None
)


def get_multiplexed_model_id() -> Optional[str]:
    """Inside a replica: the model id of the current request (or None)."""
    return _model_id_var.get()


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate an async ``get_model(self, model_id)`` loader.  Calls are
    LRU-cached per replica; evicted models get ``__del__``/``unload``
    called if defined."""

    def wrap(fn: Callable):
        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            from ray_tpu_torch.util import flight_recorder

            cache: OrderedDict = getattr(self, "_rtpu_mux_cache", None)
            if cache is None:
                cache = OrderedDict()
                self._rtpu_mux_cache = cache
                self._rtpu_mux_locks = {}
            # Fast path: cache hits never wait on another model's load.
            if model_id in cache:
                cache.move_to_end(model_id)
                flight_recorder.record_mux_cache_event("hit")
                return cache[model_id]
            # Per-model lock: concurrent requests for the SAME new model
            # load once; different models load in parallel.
            lock = self._rtpu_mux_locks.setdefault(model_id, asyncio.Lock())
            async with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    flight_recorder.record_mux_cache_event("hit")
                    return cache[model_id]
                flight_recorder.record_mux_cache_event("miss")
                model = fn(self, model_id)
                if asyncio.iscoroutine(model):
                    model = await model
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    evicted_id, evicted = cache.popitem(last=False)
                    flight_recorder.record_mux_cache_event("eviction")
                    self._rtpu_mux_locks.pop(evicted_id, None)
                    unload = getattr(evicted, "unload", None)
                    if callable(unload):
                        try:
                            result = unload()
                            if asyncio.iscoroutine(result):
                                await result
                        except Exception as e:
                            logger.warning("model unload failed: %s", e)
                return model

        wrapper._is_serve_multiplexed = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
