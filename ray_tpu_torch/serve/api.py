"""Serve public API: run/get_handle/status/delete/shutdown + HTTP ingress.

Reference: ray ``python/ray/serve/api.py:686`` (serve.run) and the per-node
proxy (``serve/_private/proxy.py``).  The HTTP proxy here is an aiohttp
server in the driver (or any) process routing ``POST <route_prefix>`` to the
deployment handle — one hop to the replica, controller out of the hot path,
matching the reference's proxy→router→replica design.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function

from .controller import CONTROLLER_NAME, ServeController
from .deployment import Application, Deployment
from .handle import DeploymentHandle

logger = logging.getLogger(__name__)

_http_state: Dict[str, Any] = {}


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return ServeController.options(
            # Long-poll listeners park an actor slot each for up to 30s
            # (one per subscribing process), on top of normal control calls.
            name=CONTROLLER_NAME, get_if_exists=True, max_concurrency=64
        ).remote()


def run(
    app,
    name: str = "",
    route_prefix: Optional[str] = None,
    local_testing_mode: bool = False,
) -> DeploymentHandle:
    """Deploy an Application (or bare Deployment) and return its handle.

    Composition: ``.bind()`` arguments may themselves be bound applications
    (``Pipeline.bind(model=Model.bind())``) — children deploy first and
    arrive in the parent's constructor as ``DeploymentHandle``s (reference:
    the deployment-graph build in ray ``serve/_private/build_app.py``).

    ``local_testing_mode=True`` runs the whole graph in THIS process — no
    cluster, no controller, no replica actors; the same handle surface
    backed by plain objects (reference: serve/local_testing_mode.py).
    """
    if local_testing_mode:
        from .local_mode import run_local

        return run_local(app)
    if isinstance(app, Deployment):
        app = Application(app)
    if not isinstance(app, Application):
        raise TypeError("serve.run expects an Application or Deployment")
    from ray_tpu_torch.core.usage import record_library_usage

    record_library_usage("serve")
    controller = _get_or_create_controller()
    return _deploy_app(app, controller, route_prefix)


def _deploy_app(
    app: Application, controller, route_prefix: Optional[str] = None
) -> DeploymentHandle:
    def convert(v):
        if isinstance(v, Deployment):
            v = Application(v)
        if isinstance(v, Application):
            return _deploy_app(v, controller)
        return v

    init_args = tuple(convert(a) for a in app.init_args)
    init_kwargs = {k: convert(v) for k, v in app.init_kwargs.items()}
    d = app.deployment
    payload = dumps_function(d.func_or_class)
    ray_tpu_torch.get(
        controller.deploy.remote(
            d.name,
            payload,
            init_args,
            init_kwargs,
            d.num_replicas,
            d.ray_actor_options,
            d.version,
            d.max_ongoing_requests,
            route_prefix or d.route_prefix,
            d.autoscaling_config,
        ),
        timeout=120,
    )
    return DeploymentHandle(d.name, controller)


def deploy_config(config: Dict[str, Any]) -> Dict[str, DeploymentHandle]:
    """Declarative multi-application deploy (reference: the REST config
    schema, ray ``serve/schema.py`` / ``serve deploy``).  Schema::

        {"applications": [
            {"import_path": "pkg.mod:app",   # Application or Deployment
             "route_prefix": "/x",           # optional
             "deployment_overrides": {"num_replicas": 2, ...}}  # optional
        ]}
    """
    import importlib

    handles: Dict[str, DeploymentHandle] = {}
    for spec in config.get("applications", []):
        mod_name, _, attr = spec["import_path"].partition(":")
        obj = getattr(importlib.import_module(mod_name), attr)
        if isinstance(obj, Deployment):
            obj = Application(obj)
        if not isinstance(obj, Application):
            raise TypeError(
                f"{spec['import_path']} is not an Application/Deployment"
            )
        overrides = spec.get("deployment_overrides")
        if overrides:
            obj = Application(
                obj.deployment.options(**overrides),
                obj.init_args,
                obj.init_kwargs,
            )
        handle = run(obj, route_prefix=spec.get("route_prefix"))
        handles[obj.deployment.name] = handle
    return handles


def get_handle(name: str) -> DeploymentHandle:
    from . import local_mode

    if name in local_mode._registry:
        return local_mode.get_local_handle(name)
    return DeploymentHandle(name)


def status() -> Dict[str, Any]:
    from . import local_mode

    if local_mode._active:
        return local_mode.local_status()
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def delete(name: str) -> bool:
    from . import local_mode

    if local_mode._active:
        return local_mode.delete_local(name)
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def shutdown():
    from .grpc_ingress import stop_grpc_ingress
    from .long_poll import reset_client
    from .local_mode import shutdown_local

    shutdown_local()
    reset_client()
    stop_http_proxy()
    stop_grpc_ingress()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    for name in ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30):
        ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)
    ray_tpu_torch.kill(controller)


# ------------------------------------------------------------------- HTTP
def start_http_proxy(host: str = "127.0.0.1", port: int = 8000) -> str:
    """Serve deployments over HTTP: POST <route_prefix> with a JSON body
    ``{"args": [...], "kwargs": {...}}`` (or any JSON object passed as the
    single argument)."""
    import asyncio

    from aiohttp import web

    controller = _get_or_create_controller()
    handles: Dict[str, DeploymentHandle] = {}
    # Route table: PUSHED by the controller's long-poll host (reference:
    # routes push to proxies via LongPollHost) — the controller stays out
    # of the request hot path and a deploy/delete is visible here within
    # one RPC latency.  Bootstrap: one direct pull before the first push.
    from .long_poll import long_poll_client

    lp = long_poll_client()
    lp.register(("routes",))
    route_bootstrap: Dict[str, Any] = {}
    route_bootstrap_miss: Dict[str, float] = {}

    async def get_routes_cached():
        pushed = lp.get(("routes",))
        if pushed is not None:
            return pushed
        # Pre-first-push: pull once and memoize even an EMPTY table (the
        # controller must stay out of the hot path for request streams
        # against a routeless proxy).  Off-loop (a blocking get here would
        # stall every in-flight request for up to the controller timeout —
        # raylint RTL005) and memoized as ONE shared task so concurrent
        # requests await the same pull instead of observing a
        # claimed-but-still-empty table and 404ing valid routes.
        fetch = route_bootstrap_miss.get("fetch")
        if fetch is None:

            async def _pull():
                try:
                    route_bootstrap.update(
                        await asyncio.get_running_loop().run_in_executor(
                            None,
                            lambda: ray_tpu_torch.get(
                                controller.get_routes.remote(), timeout=30
                            ),
                        )
                    )
                except Exception as e:  # noqa: BLE001 — 404-repull recovers
                    logger.debug("route bootstrap pull failed: %s", e)

            fetch = asyncio.get_running_loop().create_task(_pull())
            route_bootstrap_miss["fetch"] = fetch
        # shield: one client disconnecting must not cancel the shared pull.
        await asyncio.shield(fetch)
        return route_bootstrap

    def match_route(path: str, routes: Dict[str, str]):
        # Longest-prefix match (reference route_prefix semantics): a
        # deployment at /v1 serves /v1/completions and /v1/chat/completions.
        name = routes.get(path)
        if name is None:
            candidates = [
                (prefix, n)
                for prefix, n in routes.items()
                if path.startswith(prefix.rstrip("/") + "/")
            ]
            if candidates:
                name = max(candidates, key=lambda c: len(c[0]))[1]
        return name

    async def stream_sse(request: "web.Request", handle, body, name=""):
        import asyncio as _asyncio
        import contextvars as _cv

        from ray_tpu_torch.util import tracing

        # One request-scoped span covering the whole stream; the trace id
        # goes out as a response header so clients can fetch the stitched
        # cross-process trace (driver/proxy -> replica -> downstream).
        with tracing.start_span(
            "serve.http.stream", {"route": request.path, "deployment": name}
        ) as span:
            resp = web.StreamResponse(
                headers={
                    "Content-Type": "text/event-stream",
                    "Cache-Control": "no-cache",
                    "x-ray-tpu-trace-id": span.trace_id,
                }
            )
            await resp.prepare(request)
            loop = _asyncio.get_running_loop()
            # Routing does blocking control-plane/replica probes — keep it
            # off the proxy loop (same as the non-stream path).  The copied
            # context carries the span into the executor thread so the
            # replica submission inherits the trace.
            ctx = _cv.copy_context()
            gen = await loop.run_in_executor(
                None,
                lambda: ctx.run(
                    lambda: handle.options(stream=True).remote(body)
                ),
            )
            sentinel = object()
            try:
                while True:
                    chunk = await loop.run_in_executor(
                        None, lambda: next(gen, sentinel)
                    )
                    if chunk is sentinel:
                        break
                    await resp.write(
                        b"data: " + json.dumps(chunk, default=str).encode()
                        + b"\n\n"
                    )
            except Exception as e:  # noqa: BLE001 — surface mid-stream errors
                span.set_attribute("error", str(e))
                await resp.write(
                    b"data: " + json.dumps({"error": str(e)}).encode()
                    + b"\n\n"
                )
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp

    async def handle_request(request: "web.Request"):
        import time as _time

        name = match_route(request.path, await get_routes_cached())
        if name is None:
            # Route misses are usually real 404s (routes are PUSHED, so the
            # table is fresh); the one legit race is a deploy whose first
            # push hasn't landed.  One direct pull, rate-limited to once a
            # second so 404 streams never put the controller in the hot path.
            now = _time.monotonic()
            if now - route_bootstrap_miss.get("ts", 0.0) > 1.0:
                route_bootstrap_miss["ts"] = now
                try:
                    # Off-loop: a blocking get here would stall every
                    # in-flight request behind one controller round trip
                    # (raylint RTL005).
                    fresh = await asyncio.get_running_loop().run_in_executor(
                        None,
                        lambda: ray_tpu_torch.get(
                            controller.get_routes.remote(), timeout=5
                        ),
                    )
                    route_bootstrap.clear()
                    route_bootstrap.update(fresh)
                    name = match_route(request.path, fresh)
                except Exception as e:  # noqa: BLE001 — fall through to 404
                    logger.debug("route bootstrap pull failed: %s", e)
        if name is None:
            return web.json_response(
                {"error": f"no deployment at {request.path}"}, status=404
            )
        handle = handles.setdefault(name, DeploymentHandle(name, controller))
        try:
            body = await request.json()
        except Exception:
            body = None
        if isinstance(body, dict) and body.get("stream") is True:
            # Server-sent events: the deployment's method must be a
            # generator; each chunk goes out as one `data:` frame
            # (reference: serve HTTP response streaming / OpenAI
            # `stream: true`).
            return await stream_sse(request, handle, body, name)
        if isinstance(body, dict) and ("args" in body or "kwargs" in body):
            args = body.get("args", [])
            kwargs = body.get("kwargs", {})
        elif body is None:
            args, kwargs = [], {}
        else:
            args, kwargs = [body], {}
        loop = asyncio.get_running_loop()
        from ray_tpu_torch.util import tracing

        # Request-scoped span: the replica submission below happens
        # inside it, so the whole proxy -> replica -> downstream-task
        # path stitches into one trace (returned in the trace header).
        with tracing.start_span(
            "serve.http", {"route": request.path, "deployment": name}
        ) as span:
            headers = {"x-ray-tpu-trace-id": span.trace_id}
            response = handle.remote(*args, **kwargs)
            try:
                result = await loop.run_in_executor(
                    None, lambda: response.result(timeout=60)
                )
            except Exception as e:  # noqa: BLE001
                span.set_attribute("error", str(e))
                return web.json_response(
                    {"error": str(e)}, status=500, headers=headers
                )
        try:
            return web.json_response({"result": result}, headers=headers)
        except TypeError:
            return web.json_response({"result": repr(result)}, headers=headers)

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handle_request)

    loop = asyncio.new_event_loop()
    started = threading.Event()
    runner_box = {}

    def serve_forever():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, host, port)
        loop.run_until_complete(site.start())
        runner_box["runner"] = runner
        started.set()
        loop.run_forever()

    t = threading.Thread(target=serve_forever, daemon=True, name="serve-http")
    t.start()
    started.wait(timeout=10)
    _http_state.update(loop=loop, thread=t, runner=runner_box.get("runner"))
    return f"http://{host}:{port}"


def stop_http_proxy():
    loop = _http_state.get("loop")
    if loop is not None:
        loop.call_soon_threadsafe(loop.stop)
        _http_state.clear()
