"""DeploymentHandle + router.

Reference: ray ``python/ray/serve/handle.py:757`` → ``router.py:881`` →
``request_router/pow_2_router.py:52`` — requests route to the replica with
the shorter queue among two random candidates (power of two choices).
"""

from __future__ import annotations

import random
import time
from typing import Any, List, Optional

import ray_tpu_torch

from .controller import CONTROLLER_NAME


class DeploymentResponse:
    """Future-like wrapper over the replica call's ObjectRef."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout: Optional[float] = 60.0):
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call's chunks (reference:
    ``handle.options(stream=True)``); yields VALUES, one per chunk the
    replica's generator produced."""

    def __init__(self, ref_generator, timeout: Optional[float] = 120.0):
        self._gen = ref_generator
        self._timeout = timeout

    def __iter__(self):
        return self

    def __next__(self):
        ref = next(self._gen)
        return ray_tpu_torch.get(ref, timeout=self._timeout)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._invoke(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller=None,
                 multiplexed_model_id: Optional[str] = None,
                 stream: bool = False):
        self.deployment_name = deployment_name
        self._controller = controller
        self._replicas: List = []
        self._refreshed = 0.0
        self._rr = 0
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        # Pluggable routing policy (reference: request_router/); None =
        # the built-in power-of-two-choices in _pick_replica.
        self._router = None
        # model_id -> actor id of the replica that last served it (session
        # affinity — the reference's multiplex-aware router prefers replicas
        # already holding the model).
        self._model_affinity: dict = {}

    _UNSET = object()

    def options(self, *, multiplexed_model_id=_UNSET,
                stream=_UNSET, request_router=_UNSET) -> "DeploymentHandle":
        """Chaining-safe: options not passed keep their current values
        (``h.options(multiplexed_model_id="m").options(stream=True)``
        retains the model id)."""
        clone = DeploymentHandle(
            self.deployment_name,
            self._controller,
            self._multiplexed_model_id
            if multiplexed_model_id is self._UNSET
            else multiplexed_model_id,
            self._stream if stream is self._UNSET else stream,
        )
        clone._replicas = self._replicas
        clone._refreshed = self._refreshed
        clone._model_affinity = self._model_affinity
        clone._router = (
            self._router if request_router is self._UNSET else request_router
        )
        return clone

    def _get_controller(self):
        if self._controller is None:
            self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._controller

    def _refresh(self, force=False):
        """Replica list updates are PUSHED by the controller's long-poll
        host (reference ``LongPollHost``): the process-wide client holds
        one blocking listen; this method just reads its latest snapshot —
        no periodic polling, and a killed replica's removal lands here
        within one RPC latency.  ``force`` (probe-failure recovery) and
        first use bootstrap with a direct RPC."""
        from .long_poll import long_poll_client

        key = ("replicas", self.deployment_name)
        client = long_poll_client()
        client.register(key)
        if not force:
            pushed = client.get(key)
            if pushed is not None:
                self._replicas = pushed
                return
            if self._replicas:
                return  # bootstrap copy still valid until a push lands
        self._replicas = ray_tpu_torch.get(
            self._get_controller().get_replicas.remote(self.deployment_name),
            timeout=30,
        )
        self._refreshed = time.monotonic()

    def _pick_replica(self, args=(), kwargs=None):
        """Route via the configured RequestRouter (default: power-of-two
        choices by queue depth).  On a probe failure the replica list is
        force-refreshed once and the route retried (a cached dead replica
        must not poison routing until the next periodic refresh)."""
        from .request_router import PowerOfTwoChoicesRouter, ReplicaProbeError

        router = self._router
        if router is None:
            router = self.__dict__.setdefault(
                "_default_router", PowerOfTwoChoicesRouter()
            )
        kwargs = kwargs or {}
        for attempt in (0, 1):
            self._refresh(force=attempt > 0)
            if not self._replicas:
                # A pushed EMPTY list can be the stale delete snapshot of
                # a just-redeployed deployment (delete publishes [], the
                # redeploy's push may not have landed) — ask the
                # controller directly before declaring it empty.
                if attempt == 0:
                    continue
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no replicas"
                )
            try:
                return router.choose(self._replicas, args, kwargs)
            except ReplicaProbeError:
                if attempt:
                    self._rr += 1
                    return self._replicas[self._rr % len(self._replicas)]

    def _invoke(self, method: str, args, kwargs) -> DeploymentResponse:
        model_id = self._multiplexed_model_id
        replica = None
        if model_id is not None:
            # Session affinity: route back to the replica that has the model.
            sticky = self._model_affinity.get(model_id)
            self._refresh()
            for r in self._replicas:
                if r._actor_id == sticky:
                    replica = r
                    break
            if replica is not None:
                try:  # liveness probe — the cached list may be stale
                    ray_tpu_torch.get(replica.queue_len.remote(), timeout=3)
                except Exception:  # noqa: BLE001
                    self._model_affinity.pop(model_id, None)
                    self._refresh(force=True)
                    replica = None
        if replica is None:
            replica = self._pick_replica(args, kwargs)
            if model_id is not None:
                self._model_affinity[model_id] = replica._actor_id
        self._rr += 1
        metadata = (
            {"multiplexed_model_id": model_id} if model_id is not None else None
        )
        if self._stream:
            gen = replica.handle_request_streaming.options(
                num_returns="streaming"
            ).remote(method, args, kwargs, metadata)
            return DeploymentResponseGenerator(gen)
        ref = replica.handle_request.remote(method, args, kwargs, metadata)
        return DeploymentResponse(ref)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._invoke("__call__", args, kwargs)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name,))
