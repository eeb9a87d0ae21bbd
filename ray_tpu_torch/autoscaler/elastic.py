"""Elastic capacity: the drain state machine and launch backoff that turn
the reconcile loop's decisions into safe node lifecycle transitions.

Scale-down is a protocol, not a call (ISSUE: the old loop did a direct
``provider.terminate_node`` under running workloads):

    idle decision -> drain_node (control plane marks the node
    unschedulable, evicts resident placement groups through the PR-15
    ``prepare_evict`` checkpoint protocol, migrates plain actors)
    -> poll drain_status until the node holds no placement groups, no
    actors, and no busy leases -> provider terminate -> drain_complete
    (the control plane retires the entry immediately instead of waiting
    out the health-check timeout).

Drain flags on the control plane are in-memory: after a failover the
poll sees ``draining=False`` on a live node and simply re-issues the
idempotent mark, so the machine survives leader changes without its own
persistence.

Scale-up failures gate through :class:`LaunchBackoff` — decorrelated
jitter (``core.rpc.next_backoff_delay``) per node type with a
consecutive-failure counter surfaced in the decision, so a broken
provider converges to a slow retry cadence instead of a hot loop
(reference: ray autoscaler v2's per-node-type launch failure tracking).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..core.config import GlobalConfig
from ..core.rpc import next_backoff_delay
from ..util import flight_recorder
from .provider import NodeProvider

logger = logging.getLogger(__name__)


# --------------------------------------------------------- launch backoff
@dataclass
class LaunchBackoff:
    """Per-node-type launch gate: closed for a jittered, growing window
    after each provider create failure; any success resets it."""

    base_s: float = 1.0
    cap_s: float = 30.0
    consecutive_failures: int = 0
    _gate_until: float = 0.0
    _prev_delay: float = 0.0

    def ready(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.monotonic()) >= self._gate_until

    def remaining_s(self, now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        return max(0.0, self._gate_until - now)

    def record_failure(self, now: Optional[float] = None) -> float:
        """Close the gate; returns the chosen delay."""
        now = now if now is not None else time.monotonic()
        self.consecutive_failures += 1
        self._prev_delay = next_backoff_delay(
            self._prev_delay or self.base_s, base=self.base_s, cap=self.cap_s
        )
        self._gate_until = now + self._prev_delay
        return self._prev_delay

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._gate_until = 0.0
        self._prev_delay = 0.0


# ------------------------------------------------------ drain state machine
@dataclass
class DrainingNode:
    provider_id: str
    node_id_hex: Optional[str]
    cause: str
    started: float  # monotonic
    marked: bool = False  # control plane acked the drain mark

    def public_info(self, now: Optional[float] = None) -> dict:
        now = now if now is not None else time.monotonic()
        return {
            "provider_id": self.provider_id,
            "node_id": self.node_id_hex,
            "cause": self.cause,
            "age_s": round(now - self.started, 3),
        }


class NodeDrainer:
    """Owns every in-flight drain; driven once per reconcile round from
    the autoscaler thread.

    ``call`` is a synchronous control-plane RPC, ``(method, payload) ->
    reply`` — the autoscaler's persistent retryable client, so a drain in
    flight survives control-plane failover."""

    def __init__(self, call: Callable[..., dict], provider: NodeProvider,
                 timeout_s: Optional[float] = None):
        self._call = call
        self._provider = provider
        self._timeout_s = timeout_s
        self._active: Dict[str, DrainingNode] = {}
        self.stats = {"drained": 0, "timeout": 0, "cancelled": 0}

    @property
    def timeout_s(self) -> float:
        if self._timeout_s is not None:
            return self._timeout_s
        return GlobalConfig.drain_timeout_s

    def is_draining(self, provider_id: str) -> bool:
        return provider_id in self._active

    def active(self) -> List[dict]:
        now = time.monotonic()
        return [d.public_info(now) for d in self._active.values()]

    def request(self, provider_id: str, node_id_hex: Optional[str],
                cause: str = "idle timeout") -> None:
        """Begin draining one node (idempotent per provider id)."""
        if provider_id in self._active:
            return
        entry = DrainingNode(
            provider_id=provider_id, node_id_hex=node_id_hex,
            cause=cause, started=time.monotonic(),
        )
        self._active[provider_id] = entry
        flight_recorder.record_autoscaler_drain("started")
        logger.info("draining %s (node %s): %s", provider_id,
                    node_id_hex, cause)
        self._mark(entry)

    def _mark(self, entry: DrainingNode) -> None:
        if entry.node_id_hex is None:
            # Never registered with the control plane (crashed during
            # provisioning): nothing to mark, the timeout path terminates.
            return
        try:
            reply = self._call(
                "drain_node",
                {"node_id": entry.node_id_hex, "cause": entry.cause},
            )
            entry.marked = bool(reply.get("ok"))
        except Exception as e:  # noqa: BLE001 — re-marked on next poll
            logger.warning("drain_node mark for %s failed: %s",
                           entry.provider_id, e)

    def cancel(self, provider_id: str) -> None:
        entry = self._active.pop(provider_id, None)
        if entry is None:
            return
        if entry.node_id_hex is not None:
            try:
                self._call(
                    "drain_node",
                    {"node_id": entry.node_id_hex, "cancel": True},
                )
            except Exception as e:  # noqa: BLE001 — node may be gone
                logger.warning("drain cancel for %s failed: %s",
                               provider_id, e)
        self.stats["cancelled"] += 1
        flight_recorder.record_autoscaler_drain("cancelled")

    def poll(self) -> List[str]:
        """Advance every in-flight drain one step; returns the provider
        ids terminated this round."""
        finished: List[str] = []
        now = time.monotonic()
        for pid, entry in list(self._active.items()):
            age = now - entry.started
            status: Optional[dict] = None
            if entry.node_id_hex is not None:
                try:
                    status = self._call(
                        "drain_status", {"node_id": entry.node_id_hex}
                    )
                except Exception as e:  # noqa: BLE001 — CP unreachable; retry next round
                    logger.warning("drain_status for %s failed: %s", pid, e)
            if status is not None:
                if (
                    status.get("known")
                    and status.get("alive")
                    and not status.get("draining")
                    and not status.get("drained")
                ):
                    # The control plane lost the flag (failover / restart):
                    # drain_node is idempotent, re-issue the mark.
                    self._mark(entry)
            drained = bool(status and status.get("drained"))
            if drained or age >= self.timeout_s:
                outcome = "drained" if drained else "timeout"
                self._terminate(entry, outcome)
                finished.append(pid)
        return finished

    def _terminate(self, entry: DrainingNode, outcome: str) -> None:
        try:
            self._provider.terminate_node(entry.provider_id)
            flight_recorder.record_autoscaler_termination(outcome)
            logger.info("terminated %s after drain (%s)",
                        entry.provider_id, outcome)
        except Exception as e:  # noqa: BLE001 — provider flake; record and move on
            logger.warning("terminate of %s failed: %s",
                           entry.provider_id, e)
            flight_recorder.record_autoscaler_termination("error")
        if entry.node_id_hex is not None:
            try:
                # Prompt retirement: without this the control plane waits
                # out the health-check timeout to declare the node dead.
                self._call("drain_complete", {"node_id": entry.node_id_hex})
            except Exception as e:  # noqa: BLE001 — health check retires it anyway
                logger.debug("drain_complete for %s failed: %s",
                             entry.provider_id, e)
        duration = time.monotonic() - entry.started
        flight_recorder.record_autoscaler_drain(outcome, duration)
        self.stats[outcome] = self.stats.get(outcome, 0) + 1
        self._active.pop(entry.provider_id, None)


# ------------------------------------------------------------ status panel
def build_status(decision, per_type: Dict[str, int],
                 backoffs: Dict[str, LaunchBackoff],
                 drainer: NodeDrainer, provider_nodes: int) -> dict:
    """The autoscaler panel blob published to control-plane KV (namespace
    ``autoscaler``) each round — ``cli status`` and ``/api/cluster``
    render it verbatim."""
    now = time.monotonic()
    return {
        "last_decision": {
            "to_launch": dict(decision.to_launch),
            "to_terminate": list(decision.to_terminate),
            "infeasible": len(decision.infeasible),
        },
        "pending_demand": {
            "count": decision.pending_demand,
            "resources": dict(decision.pending_resources),
        },
        "node_types": {
            tname: {
                "count": per_type.get(tname, 0),
                "launch_failures": b.consecutive_failures,
                "backoff_remaining_s": round(b.remaining_s(now), 3),
            }
            for tname, b in backoffs.items()
        },
        "draining": drainer.active(),
        "drain_stats": dict(drainer.stats),
        "provider_nodes": provider_nodes,
    }
