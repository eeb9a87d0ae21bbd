"""Local testing mode: run a deployment graph fully in-process.

``serve.run(app, local_testing_mode=True)`` constructs the deployments as
plain objects in this process — no cluster, no controller, no replica
actors — and returns a handle with the same call surface
(``.remote().result()``, method callers, streaming, composition).  An
async loop thread hosts coroutine methods so ``@serve.batch`` handlers
behave exactly as they do inside a replica.

Reference: ray ``python/ray/serve/local_testing_mode.py`` (the
``_LocalDeploymentHandle`` that wraps the user callable directly).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Dict, Optional

from .deployment import Application, Deployment

_registry: Dict[str, "LocalReplica"] = {}
_active = False  # a local-mode session ran; status()/delete() stay local
_loop: Optional[asyncio.AbstractEventLoop] = None
_loop_lock = threading.Lock()


def _ensure_loop() -> asyncio.AbstractEventLoop:
    """One background loop hosts every local deployment's async methods
    (the analog of the replica actor's event loop)."""
    global _loop
    with _loop_lock:
        if _loop is not None and not _loop.is_closed():
            return _loop
        loop = asyncio.new_event_loop()
        threading.Thread(
            target=loop.run_forever, daemon=True, name="serve-local"
        ).start()
        _loop = loop
        return loop


def _submit_thread(fn, *args, **kwargs):
    """Thread-per-call execution for sync methods.  A bounded pool would
    deadlock nested composition (a parent blocking on child.result()
    holds a pool thread the child then needs); local-mode call volume is
    test-sized, so a fresh daemon thread per call is the simple safe
    choice."""
    from concurrent.futures import Future

    fut: Future = Future()

    def run():
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 — delivered to caller
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True, name="serve-local").start()
    return fut


class LocalResponse:
    """Future-like, mirrors DeploymentResponse.  Execution is EAGER (the
    call is in flight the moment .remote() returns) — required for
    @serve.batch semantics, where concurrent in-flight calls form the
    batch."""

    def __init__(self, future):
        self._future = future

    def result(self, timeout: Optional[float] = 60.0):
        return self._future.result(timeout)

    @property
    def ref(self):
        raise RuntimeError("local testing mode has no ObjectRefs")


class LocalResponseGenerator:
    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)


class LocalReplica:
    def __init__(self, deployment: Deployment, init_args, init_kwargs):
        target = deployment.func_or_class
        self.deployment = deployment
        if inspect.isclass(target):
            self.instance = target(*init_args, **init_kwargs)
            self.is_function = False
        else:
            self.instance = target
            self.is_function = True

    def _resolve(self, method: str):
        if self.is_function:
            if method != "__call__":
                raise AttributeError(
                    f"function deployment has no method {method!r}"
                )
            return self.instance
        return getattr(self.instance, method)

    def submit(self, method: str, args, kwargs):
        """Start the call, return a concurrent.futures.Future."""
        fn = self._resolve(method)
        if asyncio.iscoroutinefunction(fn):
            return asyncio.run_coroutine_threadsafe(
                fn(*args, **kwargs), _ensure_loop()
            )
        return _submit_thread(fn, *args, **kwargs)

    def call_sync(self, method: str, args, kwargs):
        """Direct call (streaming path: the generator is the result)."""
        return self._resolve(method)(*args, **kwargs)


class _LocalMethodCaller:
    def __init__(self, handle: "LocalDeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method, args, kwargs)


class LocalDeploymentHandle:
    """Same call surface as DeploymentHandle, no cluster underneath."""

    def __init__(self, replica: LocalReplica, stream: bool = False):
        self._replica = replica
        self._stream = stream
        self.deployment_name = replica.deployment.name

    def options(self, *, stream: bool = False, **_ignored):
        return LocalDeploymentHandle(self._replica, stream=stream)

    def remote(self, *args, **kwargs):
        return self._invoke("__call__", args, kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _LocalMethodCaller(self, name)

    def _invoke(self, method: str, args, kwargs):
        if self._stream:
            gen = self._replica.call_sync(method, args, kwargs)
            if inspect.isasyncgen(gen):
                # Bridge an async-generator method to the sync iterator
                # surface (the cluster path supports async gens too).
                loop = _ensure_loop()

                def agen_iter():
                    while True:
                        try:
                            yield asyncio.run_coroutine_threadsafe(
                                gen.__anext__(), loop
                            ).result()
                        except StopAsyncIteration:
                            return

                return LocalResponseGenerator(agen_iter())
            return LocalResponseGenerator(iter(gen))
        return LocalResponse(self._replica.submit(method, args, kwargs))


def run_local(app) -> LocalDeploymentHandle:
    """Build + run an application graph in-process (children first, their
    handles injected into the parent constructor, like the cluster path)."""
    if isinstance(app, Deployment):
        app = Application(app)
    if not isinstance(app, Application):
        raise TypeError("serve.run expects an Application or Deployment")

    def convert(v):
        if isinstance(v, Deployment):
            v = Application(v)
        if isinstance(v, Application):
            return run_local(v)
        return v

    init_args = tuple(convert(a) for a in app.init_args)
    init_kwargs = {k: convert(v) for k, v in app.init_kwargs.items()}
    global _active
    _active = True
    replica = LocalReplica(app.deployment, init_args, init_kwargs)
    _registry[app.deployment.name] = replica
    return LocalDeploymentHandle(replica)


def get_local_handle(name: str) -> LocalDeploymentHandle:
    return LocalDeploymentHandle(_registry[name])


def local_status() -> Dict[str, Any]:
    return {
        name: {"num_replicas": 1, "status": "RUNNING"}
        for name in _registry
    }


def delete_local(name: str) -> bool:
    return _registry.pop(name, None) is not None


def shutdown_local():
    global _active
    _active = False
    _registry.clear()
