"""Placement groups — Python frontend.

Equivalent of ray ``python/ray/util/placement_group.py``: gang resource
reservation via the control plane's two-phase commit.  The TPU-first addition
is ``SlicePlacementGroup``: reserve an entire TPU slice by topology as one
atomic unit (reference precedent: ray ``python/ray/util/tpu.py:52``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .core_worker import global_worker
from .ids import PlacementGroupID
from .scheduler import PlacementGroupStrategy

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def _no_accelerator_version(accelerator_version: str) -> None:
    """A port node has no ``TPU-<version>`` style resource: the card's
    model is its ``accelerator_type`` label.  A version would become a
    bundle resource no node has, and the group would never place."""
    if accelerator_version:
        raise ValueError(
            f"accelerator_version={accelerator_version!r}: GPU nodes carry "
            "no per-model resource; select the model by the "
            "'accelerator_type' node label instead"
        )


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 created: bool = False):
        self.id = pg_id
        self.bundles = bundles
        # Creation-reply fast path: the control plane's group-commit sweep
        # runs BEFORE the create RPC replies, so in the common case the
        # reply already says CREATED and ready() never needs a poll.
        # Only a positive CREATED is cached — PENDING always re-polls.
        self._created = created

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the group is created (2-phase commit finished)."""
        if self._created:
            return True
        worker = global_worker()
        deadline = None if timeout is None else time.monotonic() + timeout

        while True:
            info = worker._run_sync(
                worker.cp.call("get_placement_group", {"pg_id": self.id})
            )
            if info is None:
                raise ValueError(f"placement group {self.id} unknown")
            if info["state"] == "CREATED":
                self._created = True
                return True
            if info["state"] == "REMOVED":
                raise ValueError(f"placement group {self.id} was removed")
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    def __reduce__(self):
        # The cached CREATED flag deliberately does not travel: a
        # deserialized handle re-verifies against the control plane.
        return (PlacementGroup, (self.id, self.bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    priority: Optional[int] = None,
) -> PlacementGroup:
    """``priority`` overrides the owning job's priority for this group
    only (higher = more important; the default comes from the job's
    registration, falling back to ``sched_default_priority``).  The
    control plane may checkpoint-then-evict lower-priority groups to
    place this one — see ``docs/scheduling.md``."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    worker = global_worker()
    pg_id = PlacementGroupID.from_random()
    info = worker._run_sync(
        worker.cp.call(
            "create_placement_group",
            {"pg_id": pg_id, "bundles": bundles, "strategy": strategy,
             "name": name, "job_id": worker.job_id, "priority": priority},
        )
    )
    created = bool(info) and info.get("state") == "CREATED"
    return PlacementGroup(pg_id, bundles, created=created)


def remove_placement_group(pg: PlacementGroup):
    worker = global_worker()
    worker._run_sync(worker.cp.call("remove_placement_group", {"pg_id": pg.id}))


def placement_group_strategy(
    pg: PlacementGroup, bundle_index: int = -1
) -> PlacementGroupStrategy:
    """Scheduling-strategy object for @remote(scheduling_strategy=…)."""
    return PlacementGroupStrategy(pg.id.hex(), bundle_index)


def pipeline_stage_placement_group(
    num_stages: int,
    resources_per_stage: Optional[Dict[str, float]] = None,
    chips_per_stage: int = 0,
    accelerator_version: str = "",
    name: str = "",
    priority: Optional[int] = None,
) -> PlacementGroup:
    """One bundle per pipeline stage — the MPMD trainer's placement shape.

    Each stage actor pins to its own bundle, SPREAD over nodes.
    ``chips_per_stage`` asks each bundle for that many GPUs.  The strategy
    stays SPREAD with cards too: a card lease is exclusive already, there
    is no host-wide ICI mesh to keep whole, and STRICT_SPREAD would refuse
    two stages on one multi-card host.  On a CPU cluster the bundles
    degrade to per-host/per-process CPU bundles, which is what the tier-1
    tests exercise.
    """
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    _no_accelerator_version(accelerator_version)
    if resources_per_stage:
        bundle = dict(resources_per_stage)
    else:
        bundle = {"CPU": 1.0}
    if chips_per_stage:
        bundle["GPU"] = float(chips_per_stage)
    strategy = "PACK" if num_stages == 1 else "SPREAD"
    return placement_group(
        [dict(bundle) for _ in range(num_stages)],
        strategy=strategy,
        name=name,
        priority=priority,
    )


class PodracerPlacement:
    """Device-role bundles for podracer RL (arxiv 2104.06272).

    One placement group with two runs of bundles: ``num_actor_bundles``
    "actor"-role bundles (Sebulba env-runner actors doing batched
    inference on their local devices; Anakin jobs pin whole trainers
    here to share chips with other workloads) followed by
    ``num_learner_bundles`` "learner"-role bundles (the v-trace
    learner).  Reserving both roles in ONE group keeps the gang atomic —
    a half-placed Sebulba job (runners without a learner) can never hold
    resources.  SPREAD, with or without cards: ``chips_per_actor`` and
    ``chips_per_learner`` ask for GPUs, whose leases are exclusive already.
    """

    def __init__(
        self,
        num_actor_bundles: int,
        num_learner_bundles: int = 1,
        actor_resources: Optional[Dict[str, float]] = None,
        learner_resources: Optional[Dict[str, float]] = None,
        chips_per_actor: int = 0,
        chips_per_learner: int = 0,
        accelerator_version: str = "",
        name: str = "",
        priority: Optional[int] = None,
    ):
        if num_actor_bundles < 1 or num_learner_bundles < 0:
            raise ValueError(
                "need >= 1 actor bundle and >= 0 learner bundles"
            )
        _no_accelerator_version(accelerator_version)
        self.num_actor_bundles = num_actor_bundles
        self.num_learner_bundles = num_learner_bundles

        def _bundle(base, chips):
            b = dict(base) if base else {"CPU": 1.0}
            if chips:
                b["GPU"] = float(chips)
            return b

        actor_bundle = _bundle(actor_resources, chips_per_actor)
        learner_bundle = _bundle(learner_resources, chips_per_learner)
        bundles = [dict(actor_bundle) for _ in range(num_actor_bundles)]
        bundles += [dict(learner_bundle) for _ in range(num_learner_bundles)]
        strategy = "PACK" if len(bundles) == 1 else "SPREAD"
        self.pg = placement_group(
            bundles, strategy=strategy, name=name, priority=priority
        )

    def ready(self, timeout: Optional[float] = None) -> bool:
        return self.pg.ready(timeout)

    def actor_strategy(self, index: int) -> PlacementGroupStrategy:
        """Scheduling strategy pinning into actor-role bundle ``index``."""
        if not 0 <= index < self.num_actor_bundles:
            raise IndexError(f"actor bundle {index} out of range")
        return placement_group_strategy(self.pg, index)

    def learner_strategy(self, index: int = 0) -> PlacementGroupStrategy:
        """Scheduling strategy pinning into learner-role bundle ``index``."""
        if not 0 <= index < self.num_learner_bundles:
            raise IndexError(f"learner bundle {index} out of range")
        return placement_group_strategy(
            self.pg, self.num_actor_bundles + index
        )

    def remove(self):
        remove_placement_group(self.pg)


def podracer_placement_group(
    num_actor_bundles: int,
    num_learner_bundles: int = 1,
    **kwargs,
) -> PodracerPlacement:
    """Reserve actor/learner device-role bundles for a podracer RL job."""
    return PodracerPlacement(
        num_actor_bundles, num_learner_bundles, **kwargs
    )


class SlicePlacementGroup:
    """Reserve whole hosts as one gang unit.

    One bundle per host, each requesting the host's cards
    (``{"GPU": chips_per_host}``); STRICT_SPREAD so each bundle lands on a
    distinct host.  Workers of a trainer's gang schedule into these
    bundles, so each host's cards are owned by one job.
    """

    def __init__(
        self,
        num_hosts: int,
        chips_per_host: int = 4,
        accelerator_version: str = "",
        name: str = "",
        priority: Optional[int] = None,
    ):
        _no_accelerator_version(accelerator_version)
        self.num_hosts = num_hosts
        self.chips_per_host = chips_per_host
        bundles = [
            {"GPU": float(chips_per_host)} for _ in range(num_hosts)
        ]
        strategy = "STRICT_SPREAD" if num_hosts > 1 else "PACK"
        self.pg = placement_group(
            bundles, strategy=strategy, name=name, priority=priority
        )

    def ready(self, timeout: Optional[float] = None) -> bool:
        return self.pg.ready(timeout)

    def strategy_for_host(self, host_index: int) -> PlacementGroupStrategy:
        return placement_group_strategy(self.pg, host_index)

    def remove(self):
        remove_placement_group(self.pg)
