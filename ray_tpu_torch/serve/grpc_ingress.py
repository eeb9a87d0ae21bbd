"""gRPC ingress for serve deployments.

Reference: ray ``python/ray/serve/_private/proxy.py:534`` (``gRPCProxy``) —
a per-node gRPC server routing RPCs to deployment replicas alongside the
HTTP proxy.  Redesign: one generic service (no per-app protoc step),

    /ray_tpu_torch.serve.Ingress/Call

taking a JSON request ``{"deployment": ..., "method": ..., "args": [...],
"kwargs": {...}}`` (deployment may instead be inferred from the
``route_prefix`` field) and returning JSON ``{"result": ...}``; errors map
to standard gRPC status codes.  Routing rides the same pushed route table
and DeploymentHandles (pow-2 / prefix-aware routers) as the HTTP proxy.
"""

from __future__ import annotations

import json
import logging
import threading
from concurrent import futures
from typing import Dict, Optional

logger = logging.getLogger(__name__)

SERVICE_METHOD = "/ray_tpu_torch.serve.Ingress/Call"

_server = None
_server_lock = threading.Lock()


def start_grpc_ingress(host: str = "127.0.0.1", port: int = 9000,
                       max_workers: int = 8) -> str:
    """Start the node's gRPC ingress; returns ``host:port``."""
    global _server
    import grpc

    import ray_tpu_torch

    from .handle import DeploymentHandle
    from .long_poll import long_poll_client

    lp = long_poll_client()
    lp.register(("routes",))
    handles: Dict[str, DeploymentHandle] = {}
    bootstrap: Dict[str, str] = {}
    bootstrap_state: Dict[str, float] = {}

    def routes_table() -> Dict[str, str]:
        pushed = lp.get(("routes",))
        if pushed is not None:
            return pushed
        # Pre-first-push window: one direct pull (mirrors the HTTP proxy's
        # bootstrap) so routes deployed before the ingress started resolve
        # immediately; rate-limited so 404 streams stay off the controller.
        import time as _time

        now = _time.monotonic()
        if now - bootstrap_state.get("ts", -10.0) > 1.0:
            bootstrap_state["ts"] = now
            try:
                import ray_tpu_torch as _rt

                from .controller import CONTROLLER_NAME as _CN

                controller = _rt.get_actor(_CN)
                bootstrap.clear()
                bootstrap.update(
                    _rt.get(controller.get_routes.remote(), timeout=10)
                )
            except Exception:  # raylint: waive[RTL003] controller not up yet
                pass
        return bootstrap

    def resolve_deployment(req: dict) -> Optional[str]:
        name = req.get("deployment")
        if name:
            return name
        prefix = req.get("route_prefix")
        routes = routes_table()
        if prefix and prefix in routes:
            return routes[prefix]
        return None

    def call(request_bytes: bytes, context):
        try:
            req = json.loads(request_bytes or b"{}")
        except ValueError:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "request is not JSON"
            )
        name = resolve_deployment(req)
        if name is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"no deployment for {req.get('deployment') or req.get('route_prefix')!r}",
            )
        handle = handles.setdefault(name, DeploymentHandle(name))
        try:
            result = handle._invoke(
                req.get("method", "__call__"),
                tuple(req.get("args", ())),
                dict(req.get("kwargs", {})),
            ).result(timeout=req.get("timeout_s", 60.0))
        except Exception as e:  # noqa: BLE001 — map to gRPC status
            context.abort(grpc.StatusCode.INTERNAL, repr(e))
        try:
            return json.dumps({"result": result}).encode()
        except TypeError:
            context.abort(
                grpc.StatusCode.INTERNAL,
                f"result of type {type(result).__name__} is not "
                "JSON-serializable",
            )

    class Ingress(grpc.GenericRpcHandler):
        def service(self, details):
            if details.method == SERVICE_METHOD:
                return grpc.unary_unary_rpc_method_handler(
                    call,
                    request_deserializer=None,   # raw bytes
                    response_serializer=None,
                )
            return None

    with _server_lock:
        if _server is not None:
            stop_grpc_ingress()
        server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="grpc-ingress"
            )
        )
        server.add_generic_rpc_handlers((Ingress(),))
        bound = server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            raise OSError(f"could not bind gRPC ingress on {host}:{port}")
        server.start()
        _server = server
        _ = ray_tpu_torch  # handle resolution happens lazily per call
        return f"{host}:{bound}"


def stop_grpc_ingress() -> None:
    global _server
    if _server is not None:
        try:
            _server.stop(grace=1.0)
        except Exception as e:
            logger.debug("grpc server stop failed: %s", e)
        _server = None
