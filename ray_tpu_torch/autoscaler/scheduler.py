"""Bin-packing scaling decisions.

Reference: ray ``python/ray/autoscaler/v2/scheduler.py`` — simulate packing
unmet demand onto (existing + planned) nodes; launch the fewest nodes whose
shapes fit what's left; terminate nodes idle beyond the timeout, respecting
per-type ``min_workers``/``max_workers``.

Gang awareness: a STRICT_PACK placement group's bundles are merged into one
atomic demand (they must land on a single node/slice), and STRICT_SPREAD
bundles are forbidden from sharing a planned node.  Standing
``request_resources`` bundles are checked against node *totals*, not free
capacity — they express "the cluster should have this much", not "this much
must be free right now".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .config import AutoscalingConfig, NodeTypeConfig
from .provider import NODE_TYPE_LABEL, PROVIDER_ID_LABEL


@dataclass
class ScalingDecision:
    to_launch: Dict[str, int] = field(default_factory=dict)  # type -> count
    to_terminate: List[str] = field(default_factory=list)  # provider ids
    infeasible: List[dict] = field(default_factory=list)  # unmet demands
    # Demand summary: how many unmet demands fed this round's packing and
    # their aggregate shape (the cli/dashboard pending-demand panel).
    pending_demand: int = 0
    pending_resources: Dict[str, float] = field(default_factory=dict)
    # Filled by the Autoscaler after acting: per-type consecutive launch
    # failures and the remaining backoff gate (0 = clear to launch).
    launch_failures: Dict[str, int] = field(default_factory=dict)
    backoff_remaining_s: Dict[str, float] = field(default_factory=dict)
    # Provider ids the drain state machine currently holds (informational;
    # never re-listed in to_terminate).
    draining: List[str] = field(default_factory=list)


@dataclass
class _Demand:
    resources: dict
    exclusive: bool = False  # STRICT_SPREAD: must not share a planned node
    against_total: bool = False  # standing request: packs against totals


@dataclass
class _SimNode:
    avail: Dict[str, float]
    total: Dict[str, float]
    provider_id: Optional[str]
    type_name: str
    idle_s: float
    used: bool = False  # absorbed demand this round → not terminable
    planned: bool = False
    exclusive_used: bool = False


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _sub(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


def _merge(bundles: List[dict]) -> dict:
    out: Dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            out[k] = out.get(k, 0.0) + v
    return out


def _collect_demands(load_state: dict) -> List[_Demand]:
    demands: List[_Demand] = []
    for node in load_state["nodes"].values():
        if node["alive"]:
            demands.extend(
                _Demand(dict(d)) for d in node.get("pending_demands", [])
            )
    demands.extend(
        _Demand(dict(d)) for d in load_state.get("pending_actors", [])
    )
    demands.extend(
        _Demand(dict(d)) for d in load_state.get("unplaceable_demands", [])
    )
    # Over-quota task leases queued by admission: no PENDING table holds
    # them, so the control plane exports a recency window (the JobArbiter
    # demand the tentpole wires in — queued work provisions nodes instead
    # of waiting forever).
    demands.extend(
        _Demand(dict(d)) for d in load_state.get("queued_task_demands", [])
    )
    for pg in load_state.get("pending_pgs", []):
        if isinstance(pg, dict):
            strategy, bundles = pg.get("strategy", "PACK"), pg["bundles"]
        else:  # bare bundle list (older snapshot)
            strategy, bundles = "PACK", pg
        if strategy == "STRICT_PACK":
            demands.append(_Demand(_merge(bundles)))
        elif strategy == "STRICT_SPREAD":
            demands.extend(_Demand(dict(b), exclusive=True) for b in bundles)
        else:
            demands.extend(_Demand(dict(b)) for b in bundles)
    demands.extend(
        _Demand(dict(b), against_total=True)
        for b in load_state.get("requested_resources", [])
    )
    demands.sort(key=lambda d: -sum(d.resources.values()))
    return demands


def compute_scaling_decision(
    load_state: dict, config: AutoscalingConfig,
    provider_nodes: Dict[str, str],
) -> ScalingDecision:
    decision = ScalingDecision()
    demands = _collect_demands(load_state)
    decision.pending_demand = len(demands)
    for d in demands:
        for k, v in d.resources.items():
            decision.pending_resources[k] = (
                decision.pending_resources.get(k, 0.0) + v
            )

    sim_nodes: List[_SimNode] = []
    for node in load_state["nodes"].values():
        if not node["alive"]:
            continue
        if node.get("draining"):
            # A draining node is leaving: nothing may pack onto it, and it
            # must not be re-selected for idle termination — the drain
            # state machine already owns its retirement.
            continue
        labels = node.get("labels", {})
        sim_nodes.append(
            _SimNode(
                avail=dict(node["available"]),
                total=dict(node["total"]),
                provider_id=labels.get(PROVIDER_ID_LABEL),
                type_name=labels.get(NODE_TYPE_LABEL, ""),
                idle_s=node.get("idle_s", 0.0),
            )
        )

    # Provider records whose node has not REGISTERED yet (still
    # provisioning — e.g. a slow cloud boot) count as planned capacity,
    # or every round between create_node and the agent's first heartbeat
    # would launch another copy for the same demand.  A record the
    # control plane KNOWS but reports dead is excluded: that node is not
    # coming back on its own (the reclaim grace owns its record), and
    # suppressing a relaunch would strand the demand.
    known_pids = {
        node.get("labels", {}).get(PROVIDER_ID_LABEL)
        for node in load_state["nodes"].values()
    }
    for pid, tname in provider_nodes.items():
        if pid in known_pids:
            continue
        t = config.node_types.get(tname)
        if t is None:
            continue
        sim_nodes.append(
            _SimNode(
                avail=dict(t.resources),
                total=dict(t.resources),
                provider_id=pid,
                type_name=tname,
                idle_s=0.0,
                planned=True,
            )
        )

    per_type: Dict[str, int] = {}
    for tname in provider_nodes.values():
        per_type[tname] = per_type.get(tname, 0) + 1
    total_workers = sum(per_type.values())
    global_cap = (
        config.max_workers
        if config.max_workers is not None
        else sum(t.max_workers for t in config.node_types.values())
    )

    def try_launch(demand: _Demand) -> bool:
        if total_workers + sum(decision.to_launch.values()) >= global_cap:
            return False
        candidates = sorted(
            (
                t
                for t in config.node_types.values()
                if _fits(dict(t.resources), demand.resources)
                and per_type.get(t.name, 0) + decision.to_launch.get(t.name, 0)
                < t.max_workers
            ),
            key=lambda t: sum(t.resources.values()),
        )
        if not candidates:
            return False
        t = candidates[0]
        node = _SimNode(
            avail=dict(t.resources),
            total=dict(t.resources),
            provider_id=None,
            type_name=t.name,
            idle_s=0.0,
            planned=True,
        )
        _sub(node.avail, demand.resources)
        node.used = True
        node.exclusive_used = demand.exclusive
        sim_nodes.append(node)
        decision.to_launch[t.name] = decision.to_launch.get(t.name, 0) + 1
        return True

    for demand in demands:
        placed = False
        for node in sim_nodes:
            # STRICT_SPREAD bundles refuse to share a node with anything
            # placed this round, and nothing joins a node they claimed.
            if demand.exclusive and node.used:
                continue
            if node.exclusive_used:
                continue
            capacity = node.total if demand.against_total else node.avail
            if _fits(capacity, demand.resources):
                if demand.against_total:
                    _sub(node.total, demand.resources)
                else:
                    _sub(node.avail, demand.resources)
                node.used = True
                node.exclusive_used = node.exclusive_used or demand.exclusive
                placed = True
                break
        if not placed and not try_launch(demand):
            decision.infeasible.append(demand.resources)

    # ---- min_workers floor
    for t in config.node_types.values():
        have = per_type.get(t.name, 0) + decision.to_launch.get(t.name, 0)
        if have < t.min_workers:
            decision.to_launch[t.name] = (
                decision.to_launch.get(t.name, 0) + (t.min_workers - have)
            )

    # ---- scale down: idle past the timeout, not absorbed into this round's
    # packing, above the type's min_workers floor
    remaining = dict(per_type)
    for node in sim_nodes:
        if node.planned or node.provider_id is None or node.used:
            continue
        t: Optional[NodeTypeConfig] = config.node_types.get(node.type_name)
        floor = t.min_workers if t else 0
        if (
            node.idle_s >= config.idle_timeout_s
            and remaining.get(node.type_name, 0) > floor
        ):
            decision.to_terminate.append(node.provider_id)
            remaining[node.type_name] = remaining.get(node.type_name, 0) - 1

    # ---- launch batch cap
    launching = sum(decision.to_launch.values())
    if launching > config.max_launch_batch:
        budget = config.max_launch_batch
        trimmed: Dict[str, int] = {}
        for tname, n in decision.to_launch.items():
            take = min(n, budget)
            if take:
                trimmed[tname] = take
            budget -= take
            if budget <= 0:
                break
        decision.to_launch = trimmed
    return decision
