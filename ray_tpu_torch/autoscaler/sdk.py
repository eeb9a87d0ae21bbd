"""Programmatic autoscaling requests (reference: ray
``python/ray/autoscaler/sdk.py`` ``request_resources``)."""

from __future__ import annotations

from typing import Dict, List, Optional


def request_resources(
    bundles: Optional[List[Dict[str, float]]] = None,
    num_cpus: Optional[int] = None,
) -> None:
    """Ask the autoscaler to provision capacity for these bundles
    immediately (a standing request, replaced on each call; pass no args to
    clear).  Requires a connected driver."""
    from ..core.core_worker import global_worker

    out: List[Dict[str, float]] = list(bundles or [])
    if num_cpus:
        out.append({"CPU": float(num_cpus)})
    worker = global_worker()
    worker._run_sync(worker.cp.call("request_resources", {"bundles": out}))
