"""Fault-injection harness: composable, scoped, revertible injectors.

Chaos tests for the self-healing loop (``util/remediation.py``) need
faults that are *real enough* to drive the actual detect → act →
recover arc, yet hermetic: every injector is scoped (it targets one
component instance), revertible (``revert()`` restores the world, and
the injectors are context managers so test teardown cannot leak chaos),
and composable (``scoped(...)`` stacks several).

Injectors:

  - ``SlowPipelineStage`` — a slow host under one pipeline stage actor:
    ``compute_delay_s`` slows its forward ops (peers accumulate stall —
    the signature the straggler rule flags), ``recv_delay_s`` slows its
    tensor delivery.  The chaos state lives ON the actor, so the
    remediation respawn-and-replace clears it the way replacing a sick
    process clears its sickness.
  - ``KilledStageActor`` — kills a stage actor outright (one-shot);
    repeated kills drive the restart-storm → quarantine path.
  - ``OverloadedServeReplica`` — a closed-loop client fleet hammering a
    deployment until reverted; the fault is offered load exceeding one
    replica's capacity, and recovery is the remediation scale-up
    absorbing it (no revert needed for the SLO to clean up).
  - ``ThrottledCollectiveLink`` — degrades one fabric member's
    bandwidth for one algorithm (the slow-link model), driving the
    bandwidth-drift rule; the remediation re-probe lets the tuner
    re-commit around the throttled path.
  - ``KilledLeader`` — SIGKILLs the control-plane leader of an HA head;
    recovery is the warm standby taking the lease and clients
    re-anchoring (docs/ha.md), ``revert()`` respawns the standby.
  - ``ProviderCreateErrors`` / ``SlowProvisioning`` / ``NodeChurn`` —
    cloud-provider faults on a ``FakeMultiNodeProvider`` (create calls
    refused, VMs stuck in PROVISIONING, VMs crashing behind the API's
    back); recovery is the autoscaler's backoff, double-launch
    protection, and zombie-reclaim pass (docs/elastic.md).

``CollectiveFabricMember`` is the workload half of the collective
scenario: a simulated fabric (timed memcpy at per-algorithm bandwidths)
driven through the REAL tuner / flight-recorder / SLO pipeline — the
chaos boundary is the fabric model, everything above it is production
code.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class ChaosInjector:
    """Base: ``apply()`` injects, ``revert()`` restores; context-manager
    use makes tests hermetic by construction."""

    def apply(self) -> "ChaosInjector":
        raise NotImplementedError

    def revert(self) -> None:
        raise NotImplementedError

    def __enter__(self) -> "ChaosInjector":
        return self.apply()

    def __exit__(self, *exc) -> None:
        self.revert()


class scoped:
    """Compose several injectors into one scope: applied in order,
    reverted in reverse, every revert attempted even if one fails."""

    def __init__(self, *injectors: ChaosInjector):
        self.injectors = injectors

    def __enter__(self) -> tuple:
        applied = []
        try:
            for inj in self.injectors:
                inj.apply()
                applied.append(inj)
        except BaseException:
            for inj in reversed(applied):
                try:
                    inj.revert()
                except Exception as e:  # noqa: BLE001 — best-effort unwind
                    logger.warning("chaos unwind failed: %s", e)
            raise
        return self.injectors

    def __exit__(self, *exc) -> None:
        for inj in reversed(self.injectors):
            try:
                inj.revert()
            except Exception as e:  # noqa: BLE001 — keep reverting the rest
                logger.warning("chaos revert failed: %s", e)


# ------------------------------------------------------------ pipeline chaos
class SlowPipelineStage(ChaosInjector):
    """Slow one stage of a running ``PipelinedTrainer``.

    ``revert()`` clears the injection on whatever actor currently holds
    the stage slot — after a remediation respawn that is a fresh actor
    which never saw the chaos, so revert degrades to a no-op."""

    def __init__(self, trainer, stage: int,
                 compute_delay_s: Optional[float] = None,
                 recv_delay_s: Optional[float] = None,
                 timeout: float = 30.0):
        self.trainer = trainer
        self.stage = stage
        self.spec: Dict[str, float] = {}
        if compute_delay_s:
            self.spec["compute_delay_s"] = compute_delay_s
        if recv_delay_s:
            self.spec["recv_delay_s"] = recv_delay_s
        self.timeout = timeout

    def _push(self, spec: Optional[Dict[str, float]]) -> None:
        import ray_tpu_torch

        ray_tpu_torch.get(
            self.trainer.stages[self.stage].inject_chaos.remote(spec),
            timeout=self.timeout,
        )

    def apply(self) -> "SlowPipelineStage":
        self._push(self.spec)
        return self

    def revert(self) -> None:
        try:
            self._push(None)
        except Exception as e:  # noqa: BLE001 — slot may hold a fresh (clean) actor
            logger.debug("SlowPipelineStage revert skipped: %s", e)


class KilledStageActor(ChaosInjector):
    """Kill a pipeline stage actor outright (one-shot; recovery is the
    system's job, so ``revert`` is a no-op).  Repeated kills inside one
    window are the restart-storm scenario."""

    def __init__(self, trainer, stage: int):
        self.trainer = trainer
        self.stage = stage

    def apply(self) -> "KilledStageActor":
        import ray_tpu_torch

        ray_tpu_torch.kill(self.trainer.stages[self.stage])
        return self

    def revert(self) -> None:
        return None


# --------------------------------------------------------------- serve chaos
class OverloadedServeReplica(ChaosInjector):
    """Closed-loop load: ``concurrency`` client threads each looping
    ``request_fn()`` until reverted.  Request failures are counted, not
    raised — overload chaos is allowed to shed."""

    def __init__(self, request_fn: Callable[[], Any], concurrency: int = 4,
                 name: str = "chaos-load"):
        self.request_fn = request_fn
        self.concurrency = concurrency
        self.name = name
        self.requests = 0
        self.errors = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._count_lock = threading.Lock()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.request_fn()
                with self._count_lock:
                    self.requests += 1
            except Exception:  # noqa: BLE001 — shed under overload is expected
                with self._count_lock:
                    self.errors += 1
                # Back off a beat so a hard-down target doesn't spin.
                self._stop.wait(0.1)

    def apply(self) -> "OverloadedServeReplica":
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._loop, name=f"{self.name}-{i}",
                             daemon=True)
            for i in range(self.concurrency)
        ]
        for t in self._threads:
            t.start()
        return self

    def revert(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []


# ---------------------------------------------------------- collective chaos
class CollectiveFabricMember:
    """One member of a simulated collective fabric, driven through the
    REAL tuner → flight-recorder → SLO pipeline.

    Each ``run_ops`` call asks the process-wide ``CollectiveTuner`` for
    an algorithm (real selection: heuristic seed → exploration → commit
    → decaying/forced re-probes), then models the transfer: a timed
    memcpy plus a duration computed from the fabric's per-algorithm
    bandwidth table, recorded via ``flight_recorder.record_collective``
    and fed back with ``tuner.observe`` — exactly the feedback loop the
    jax groups use.  A ``ThrottledCollectiveLink`` divides ONE
    algorithm's bandwidth on ONE member, which is what a degraded link
    looks like from that member's accounting.

    Deploy as an actor (``ray_tpu_torch.remote(CollectiveFabricMember)``) so
    each member is its own process with its own tuner and metrics
    payload — the member-granular view the drift rule compares."""

    #: per-rank bandwidths (bytes/s) of the healthy fabric, per algorithm
    DEFAULT_BANDWIDTH = {"flat": 2e8, "ring": 8e8, "tree": 6e8,
                         "two_level": 5e8}

    def __init__(self, op: str = "allreduce", world_size: int = 4,
                 nbytes: int = 1 << 20,
                 algo_bandwidth: Optional[Dict[str, float]] = None):
        self.op = op
        self.world_size = world_size
        self.nbytes = nbytes
        self.algo_bandwidth = dict(
            self.DEFAULT_BANDWIDTH, **(algo_bandwidth or {})
        )
        self.throttle: Dict[str, float] = {}
        self._buf = bytearray(min(nbytes, 1 << 16))

    def set_throttle(self, algo: str, factor: Optional[float]) -> bool:
        if factor is None:
            self.throttle.pop(algo, None)
        else:
            self.throttle[algo] = float(factor)
        return True

    def run_ops(self, n: int = 1) -> str:
        from ray_tpu_torch.collective import algorithms as alg
        from ray_tpu_torch.collective.tuner import get_tuner
        from ray_tpu_torch.util import flight_recorder

        tuner = get_tuner()
        candidates = alg.candidates_for(self.op, self.world_size, None)
        algo = ""
        for _ in range(n):
            decision = tuner.select(
                self.op, self.nbytes, self.world_size, None, candidates
            )
            algo = decision["algo"]
            bandwidth = self.algo_bandwidth.get(algo, 1e8)
            bandwidth /= self.throttle.get(algo, 1.0)
            # The modeled transfer: a real (small) memcpy so the op does
            # work, with the fabric model supplying the duration.
            bytes(self._buf)
            duration = self.nbytes / bandwidth
            flight_recorder.record_collective(
                self.op, "chaos", self.nbytes, self.world_size, duration,
                algo=algo, group="chaos_fabric",
            )
            tuner.observe(self.op, self.nbytes, self.world_size, None,
                          algo, bandwidth=self.nbytes / duration)
        return algo

    def committed(self) -> Optional[str]:
        """The tuner's committed algorithm for this member's bucket."""
        from ray_tpu_torch.collective.tuner import get_tuner

        for row in get_tuner().stats().values():
            if row["op"] == self.op and row["world_size"] == self.world_size:
                return row["chosen"]
        return None

    def flush_metrics(self) -> bool:
        """Push this member's registry to the cluster KV now (tests can
        tighten the beat instead of waiting for the agent pull)."""
        from ray_tpu_torch.util import metrics as _metrics

        _metrics.flush()
        return True


class ThrottledCollectiveLink(ChaosInjector):
    """Degrade one fabric member's bandwidth for one algorithm by
    ``factor`` (an actor handle to a ``CollectiveFabricMember``)."""

    def __init__(self, member, algo: str, factor: float = 50.0,
                 timeout: float = 30.0):
        self.member = member
        self.algo = algo
        self.factor = factor
        self.timeout = timeout

    def apply(self) -> "ThrottledCollectiveLink":
        import ray_tpu_torch

        ray_tpu_torch.get(
            self.member.set_throttle.remote(self.algo, self.factor),
            timeout=self.timeout,
        )
        return self

    def revert(self) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                self.member.set_throttle.remote(self.algo, None),
                timeout=self.timeout,
            )
        except Exception as e:  # noqa: BLE001 — member may already be gone
            logger.debug("ThrottledCollectiveLink revert skipped: %s", e)


# ----------------------------------------------------- control-plane chaos
class KilledLeader(ChaosInjector):
    """``kill -9`` the control-plane leader of an HA head node.

    The fault is the kill itself; recovery is the warm standby winning
    the lease, replaying the journal tail, and publishing the new
    endpoint — clients re-anchor through their resolver-backed retry
    clients without surfacing errors.  ``apply()`` records the epoch
    it deposed (``old_epoch``); tests assert the failover completed via
    ``node.wait_for_failover(old_epoch)``.  ``revert()`` respawns the
    dead candidate so the cluster leaves the scope with a warm standby
    again (repeated apply/revert cycles are the failover soak)."""

    def __init__(self, node):
        self.node = node
        self.old_epoch: int = 0

    def apply(self) -> "KilledLeader":
        self.old_epoch = self.node.kill_leader()
        return self

    def revert(self) -> None:
        try:
            self.node.ensure_standby()
        except Exception as e:  # noqa: BLE001 — node may be tearing down
            logger.debug("KilledLeader revert skipped: %s", e)


# ------------------------------------------------------- arbitration chaos
class PriorityBurst(ChaosInjector):
    """A high-priority placement-group burst landing on a busy cluster.

    ``apply()`` requests ``bundles`` at ``priority`` through the REAL
    create path — on a full cluster the control plane must
    checkpoint-then-evict lower-priority groups to place it (the
    latency-critical-serve-arrives scenario).  ``revert()`` removes the
    group, freeing the capacity so evicted victims auto-resume via the
    pending-PG drain.  ``placed`` records whether the burst actually
    landed within ``ready_timeout``."""

    def __init__(self, bundles: List[Dict[str, float]], priority: int = 1000,
                 strategy: str = "PACK", name: str = "chaos-burst",
                 ready_timeout: float = 30.0):
        self.bundles = [dict(b) for b in bundles]
        self.priority = priority
        self.strategy = strategy
        self.name = name
        self.ready_timeout = ready_timeout
        self.pg = None
        self.placed = False

    def apply(self) -> "PriorityBurst":
        from ray_tpu_torch.core.placement import placement_group

        self.pg = placement_group(
            self.bundles, strategy=self.strategy, name=self.name,
            priority=self.priority,
        )
        self.placed = self.pg.ready(timeout=self.ready_timeout)
        return self

    def revert(self) -> None:
        if self.pg is None:
            return
        from ray_tpu_torch.core.placement import remove_placement_group

        try:
            remove_placement_group(self.pg)
        except Exception as e:  # noqa: BLE001 — cluster may be tearing down
            logger.debug("PriorityBurst revert skipped: %s", e)
        self.pg = None


class QuotaHog(ChaosInjector):
    """A greedy tenant: floods the scheduler with ``count`` identical
    single-bundle placement groups from the calling job.

    With a job quota configured (``ray_tpu_torch.init(job_quota=...)``) the
    over-quota tail queues at admission — never fails, never reserves —
    so the hog is contained to its cap while other tenants keep their
    capacity.  ``states()`` classifies the flood (CREATED vs PENDING);
    ``revert()`` removes every group, draining usage so any queued tail
    admits (and then gets removed too)."""

    def __init__(self, bundle: Dict[str, float], count: int,
                 strategy: str = "PACK", name: str = "chaos-hog",
                 settle_s: float = 1.0):
        self.bundle = dict(bundle)
        self.count = count
        self.strategy = strategy
        self.name = name
        self.settle_s = settle_s
        self.pgs: List[Any] = []

    def apply(self) -> "QuotaHog":
        from ray_tpu_torch.core.placement import placement_group

        self.pgs = [
            placement_group(
                [dict(self.bundle)], strategy=self.strategy,
                name=f"{self.name}-{i}",
            )
            for i in range(self.count)
        ]
        # Let the group-commit sweep classify the flood before the test
        # reads states() — admission decisions are asynchronous.
        time.sleep(self.settle_s)
        return self

    def states(self) -> Dict[str, int]:
        """Current state histogram of the hog's groups."""
        from ray_tpu_torch.core.core_worker import global_worker

        worker = global_worker()
        out: Dict[str, int] = {}
        for pg in self.pgs:
            info = worker._run_sync(
                worker.cp.call("get_placement_group", {"pg_id": pg.id})
            )
            state = info["state"] if info else "UNKNOWN"
            out[state] = out.get(state, 0) + 1
        return out

    def revert(self) -> None:
        from ray_tpu_torch.core.placement import remove_placement_group

        for pg in self.pgs:
            try:
                remove_placement_group(pg)
            except Exception as e:  # noqa: BLE001 — keep removing the rest
                logger.debug("QuotaHog revert skipped: %s", e)
        self.pgs = []


# --------------------------------------------------------- provider chaos
class ProviderCreateErrors(ChaosInjector):
    """The next ``count`` ``create_node`` calls on a
    ``FakeMultiNodeProvider`` raise — the cloud API saying no (stockout,
    quota, rate limit).  Driven through the REAL reconcile loop, the
    autoscaler must converge to a backoff cadence per node type instead
    of a hot retry loop; recovery is the queued failures running out (or
    ``revert()`` clearing them early)."""

    def __init__(self, provider, count: int = 3):
        self.provider = provider
        self.count = count

    def apply(self) -> "ProviderCreateErrors":
        with self.provider._lock:
            self.provider.fault_create_errors += self.count
        return self

    def revert(self) -> None:
        with self.provider._lock:
            self.provider.fault_create_errors = 0


class SlowProvisioning(ChaosInjector):
    """Every ``create_node`` returns its provider id immediately but the
    node's processes start only after ``delay_s`` — a VM stuck in
    PROVISIONING.  The scaling decision must keep counting the pending
    node (it is in ``non_terminated_nodes``) and NOT double-launch while
    it boots."""

    def __init__(self, provider, delay_s: float = 3.0):
        self.provider = provider
        self.delay_s = delay_s

    def apply(self) -> "SlowProvisioning":
        with self.provider._lock:
            self.provider.fault_create_delay_s = self.delay_s
        return self

    def revert(self) -> None:
        with self.provider._lock:
            self.provider.fault_create_delay_s = 0.0


class NodeChurn(ChaosInjector):
    """Crash a launched node's processes while the provider record stays
    (the cloud still reports the VM running) — one-shot, like
    ``KilledStageActor``.  Recovery is two-sided: the control plane's
    health check declares the node dead (restarting its actors
    elsewhere), and the autoscaler's reclaim pass terminates the zombie
    provider record after ``reclaim_grace_s`` so a replacement can
    launch."""

    def __init__(self, provider, provider_id: str):
        self.provider = provider
        self.provider_id = provider_id

    def apply(self) -> "NodeChurn":
        self.provider.kill_node(self.provider_id)
        return self

    def revert(self) -> None:
        pass  # recovery is the system's job
