"""Autoscaling configuration (reference: the node-types section of the
cluster YAML, ray ``python/ray/autoscaler/ray-schema.json``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class NodeTypeConfig:
    """One launchable node shape."""

    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    labels: Dict[str, str] = field(default_factory=dict)
    # Provider-specific knobs (e.g. GKE machine type / TPU topology).
    node_config: Dict[str, object] = field(default_factory=dict)


@dataclass
class AutoscalingConfig:
    node_types: Dict[str, NodeTypeConfig]
    idle_timeout_s: float = 60.0
    max_launch_batch: int = 8
    # Global cap across all worker types (None = sum of per-type maxes).
    max_workers: Optional[int] = None
    # Scale-down path: route idle-timeout terminations through the drain
    # state machine (mark unschedulable -> evict residents via
    # prepare_evict -> terminate) instead of a direct provider terminate.
    drain_before_terminate: bool = True
    # Deadline for a drain to empty (None = GlobalConfig.drain_timeout_s);
    # on expiry the node is terminated anyway.
    drain_timeout_s: Optional[float] = None
    # Per-node-type launch backoff (decorrelated jitter between these
    # bounds) after a provider create failure.
    launch_backoff_base_s: float = 1.0
    launch_backoff_cap_s: float = 30.0
    # How long a provider node may stay unknown to the control plane
    # (still provisioning, or crashed without the provider noticing)
    # before the autoscaler reclaims its record.
    reclaim_grace_s: float = 30.0

    @staticmethod
    def from_dict(d: dict) -> "AutoscalingConfig":
        types = {
            name: NodeTypeConfig(
                name=name,
                resources=dict(t.get("resources", {})),
                min_workers=t.get("min_workers", 0),
                max_workers=t.get("max_workers", 10),
                labels=dict(t.get("labels", {})),
                node_config=dict(t.get("node_config", {})),
            )
            for name, t in d.get("node_types", {}).items()
        }
        return AutoscalingConfig(
            node_types=types,
            idle_timeout_s=d.get("idle_timeout_s", 60.0),
            max_launch_batch=d.get("max_launch_batch", 8),
            max_workers=d.get("max_workers"),
            drain_before_terminate=d.get("drain_before_terminate", True),
            drain_timeout_s=d.get("drain_timeout_s"),
            launch_backoff_base_s=d.get("launch_backoff_base_s", 1.0),
            launch_backoff_cap_s=d.get("launch_backoff_cap_s", 30.0),
            reclaim_grace_s=d.get("reclaim_grace_s", 30.0),
        )
