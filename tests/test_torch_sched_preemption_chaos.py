"""The port's twin of ``tests/test_sched_preemption_chaos.py``, case for
case, with the two name moves (``ray_tpu`` → ``ray_tpu_torch``,
``RAY_TPU_`` → ``RAY_TPU_TORCH_``).

Chaos scenarios for multi-tenant arbitration (docs/scheduling.md).

Each test injects real contention through ``ray_tpu_torch.devtools.chaos`` and
asserts the full arc end-to-end through the REAL scheduler path — no test
hooks into the control plane:

- **PriorityBurst**: a high-priority group lands on a full box, the
  low-priority trainer is checkpoint-then-evicted (its ``prepare_evict``
  blob parked in the cluster KV), the burst places; on revert the victim
  auto-resumes and restores BIT-IDENTICAL to an uninterrupted run.
- **QuotaHog**: a greedy flood is contained to its job quota — the
  over-quota tail queues (never fails), the rest of the box stays usable.
- **Crash-loop containment**: a job that preempts in a loop drains its
  token-bucket burst, gets quarantined, and provably cannot evict more.

Fast subset is tier-1 (``chaos`` marker); the repeated-cycle soak is
additionally ``slow`` like test_chaos_soak.py."""

import pickle
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.devtools import chaos

pytestmark = pytest.mark.chaos

DIM, LR = 32, 0.1


def _reference_params(n_steps):
    params = np.zeros(DIM, dtype=np.float64)
    for s in range(n_steps):
        params = params + LR * np.random.RandomState(s).standard_normal(DIM)
    return params


@ray_tpu_torch.remote
class Trainer:
    """Deterministic trainer: params are a pure function of the step
    counter, so checkpoint-restore divergence is a bug, not noise."""

    def __init__(self):
        self.step_n = 0
        self.params = np.zeros(DIM, dtype=np.float64)

    def step(self):
        rng = np.random.RandomState(self.step_n)
        self.params = self.params + LR * rng.standard_normal(DIM)
        self.step_n += 1
        return self.step_n

    def state(self):
        return pickle.dumps((self.step_n, self.params))

    def load_state(self, blob):
        self.step_n, self.params = pickle.loads(blob)
        return self.step_n

    def prepare_evict(self):
        return self.state()


def _pg_state(w, pg):
    info = w._run_sync(w.cp.call("get_placement_group", {"pg_id": pg.id}))
    return info["state"] if info else "UNKNOWN"


def _step_until_alive(trainer, timeout=60.0):
    """First successful step() on a (re)starting actor."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return ray_tpu_torch.get(trainer.step.remote(), timeout=5)
        except Exception:  # noqa: BLE001 — restarting
            time.sleep(0.25)
    raise AssertionError("trainer never came back")


class TestPriorityBurst:
    def test_burst_preempts_checkpoint_then_resume_bit_identical(self):
        ray_tpu_torch.init(num_cpus=4)
        burst = None
        try:
            from ray_tpu_torch.api import global_worker

            w = global_worker()
            train_pg = ray_tpu_torch.placement_group(
                [{"CPU": 3}], name="victim-train", priority=10
            )
            assert train_pg.ready(timeout=30)
            trainer = Trainer.options(
                scheduling_strategy=ray_tpu_torch.placement_group_strategy(
                    train_pg, 0
                ),
                max_restarts=4,
            ).remote()
            for _ in range(20):
                steps_before = ray_tpu_torch.get(trainer.step.remote(), timeout=30)
            trainer_hex = trainer._actor_id.hex()

            # 1 CPU free, the burst needs 2: the ONLY way it places is by
            # evicting the priority-10 trainer group.
            burst = chaos.PriorityBurst(
                [{"CPU": 2}], priority=1000, ready_timeout=30
            ).apply()
            assert burst.placed, "burst failed to preempt the trainer"
            assert _pg_state(w, train_pg) == "PENDING"

            # The eviction parked the trainer's prepare_evict() blob in
            # the cluster KV before its bundle was reclaimed.
            blob = w._run_sync(w.cp.call(
                "kv_get", {"namespace": "eviction", "key": trainer_hex}
            ))
            assert blob, "no eviction checkpoint parked in the KV"
            ckpt_step, ckpt_params = pickle.loads(blob)
            assert ckpt_step == steps_before
            assert (
                ckpt_params.tobytes()
                == _reference_params(ckpt_step).tobytes()
            )

            # Revert: capacity frees, the victim group auto-resumes.
            burst.revert()
            burst = None
            deadline = time.monotonic() + 30
            while (
                time.monotonic() < deadline
                and _pg_state(w, train_pg) != "CREATED"
            ):
                time.sleep(0.25)
            assert _pg_state(w, train_pg) == "CREATED"

            # The fresh incarnation restores the checkpoint and resumes
            # bit-identical to a run that was never interrupted.
            _step_until_alive(trainer)
            n = ray_tpu_torch.get(trainer.load_state.remote(blob), timeout=30)
            assert n == steps_before
            for _ in range(10):
                final = ray_tpu_torch.get(trainer.step.remote(), timeout=30)
            _, params = pickle.loads(
                ray_tpu_torch.get(trainer.state.remote(), timeout=30)
            )
            assert params.tobytes() == _reference_params(final).tobytes()
        finally:
            if burst is not None:
                burst.revert()
            ray_tpu_torch.shutdown()


class TestQuotaHog:
    def test_hog_contained_by_quota(self):
        ray_tpu_torch.init(num_cpus=8, job_quota={"CPU": 3})
        hog = None
        try:
            from ray_tpu_torch.api import global_worker

            w = global_worker()
            hog = chaos.QuotaHog({"CPU": 1}, count=6, settle_s=2.0).apply()
            states = hog.states()
            # Quota caps the flood at 3 CREATED; the tail QUEUES — no
            # group ever fails.
            assert states.get("CREATED", 0) == 3, states
            assert states.get("PENDING", 0) == 3, states
            sched = w._run_sync(w.cp.call("get_state", {}))["scheduling"]
            job = sched[w.job_id.hex()]
            assert job["usage"].get("CPU") == 3.0
            assert job["queued_total"] >= 3

            # The box is NOT exhausted: 5 CPUs remain for other work —
            # plain task leases are not durable reservations, so they run
            # despite the hog's queued tail.
            @ray_tpu_torch.remote
            def probe():
                return "alive"

            assert ray_tpu_torch.get(probe.remote(), timeout=60) == "alive"

            # Revert drains usage; any still-queued group would admit,
            # then everything is removed.
            hog.revert()
            hog = None
        finally:
            if hog is not None:
                hog.revert()
            ray_tpu_torch.shutdown()


class TestCrashLoopContainment:
    def test_preemption_budget_bounds_repeat_offender(self):
        """A crash-looping high-priority job re-preempting in a tight
        loop is bounded by its token bucket: after the burst is spent it
        is quarantined and its groups queue like anyone else's."""
        # _system_config, not direct GlobalConfig writes: the control
        # plane is a separate process and only sees shipped overrides
        # (shutdown() restores them).
        ray_tpu_torch.init(
            num_cpus=4,
            _system_config={
                "sched_preemption_burst": 2,
                "sched_preemption_cooldown_s": 3600.0,
                "sched_preemption_quarantine_s": 3600.0,
            },
        )
        bursts = []
        try:
            from ray_tpu_torch.api import global_worker

            w = global_worker()
            victims = [
                ray_tpu_torch.placement_group([{"CPU": 1}], priority=1)
                for _ in range(4)
            ]
            for v in victims:
                assert v.ready(timeout=30)

            # First burst: 2 victims, spends the whole budget.
            b1 = chaos.PriorityBurst(
                [{"CPU": 2}], priority=1000, name="loop-1", ready_timeout=30
            ).apply()
            bursts.append(b1)
            assert b1.placed

            # Second burst in the same "crash loop": bucket empty (the
            # cooldown is hours away) -> denied, quarantined, QUEUES.
            b2 = chaos.PriorityBurst(
                [{"CPU": 2}], priority=1000, name="loop-2", ready_timeout=3
            ).apply()
            bursts.append(b2)
            assert not b2.placed
            assert _pg_state(w, b2.pg) == "PENDING"

            sched = w._run_sync(w.cp.call("get_state", {}))["scheduling"]
            job = sched[w.job_id.hex()]
            assert job["quarantined_until"] > 0.0
            # Exactly the burst's worth of victims was evicted, no more.
            evicted = sum(
                1 for v in victims if _pg_state(w, v) == "PENDING"
            )
            assert evicted == 2
        finally:
            for b in bursts:
                b.revert()
            ray_tpu_torch.shutdown()


@pytest.mark.slow
class TestPreemptResumeSoak:
    def test_repeated_preempt_resume_cycles_stay_bit_identical(self):
        """Ten burst/revert cycles against the same trainer: every
        resume restores the latest parked checkpoint and the params
        never diverge from the uninterrupted reference.  The preemption
        budget is raised for the duration — ten back-to-back evictions
        would (correctly) trip the default crash-loop quarantine, which
        TestCrashLoopContainment pins separately."""
        ray_tpu_torch.init(
            num_cpus=4,
            _system_config={"sched_preemption_burst": 100},
        )
        try:
            from ray_tpu_torch.api import global_worker

            w = global_worker()
            train_pg = ray_tpu_torch.placement_group(
                [{"CPU": 3}], name="soak-train", priority=10
            )
            assert train_pg.ready(timeout=30)
            trainer = Trainer.options(
                scheduling_strategy=ray_tpu_torch.placement_group_strategy(
                    train_pg, 0
                ),
                max_restarts=50,
            ).remote()
            trainer_hex = trainer._actor_id.hex()
            last = 0
            for _ in range(5):
                last = ray_tpu_torch.get(trainer.step.remote(), timeout=30)

            for cycle in range(10):
                burst = chaos.PriorityBurst(
                    [{"CPU": 2}], priority=1000,
                    name=f"soak-burst-{cycle}", ready_timeout=30,
                ).apply()
                assert burst.placed, f"cycle {cycle}: burst did not place"
                blob = w._run_sync(w.cp.call(
                    "kv_get",
                    {"namespace": "eviction", "key": trainer_hex},
                ))
                assert blob, f"cycle {cycle}: no checkpoint parked"
                burst.revert()
                n = _step_until_alive(trainer)
                if n <= last:  # fresh incarnation: restore and re-step
                    ray_tpu_torch.get(trainer.load_state.remote(blob), timeout=30)
                    n = ray_tpu_torch.get(trainer.step.remote(), timeout=30)
                assert n > last, f"cycle {cycle}: lost progress"
                last = n
                _, params = pickle.loads(
                    ray_tpu_torch.get(trainer.state.remote(), timeout=30)
                )
                assert (
                    params.tobytes() == _reference_params(last).tobytes()
                ), f"cycle {cycle}: params diverged"
        finally:
            ray_tpu_torch.shutdown()
